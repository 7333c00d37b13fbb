// K9 and K10: the one-vs-all Tanimoto search, two entry points.
//
// Replace pilosa_tpu/ops/similarity.py:25 tanimoto_search (B14):
//   sim_scan   (K9)  <- matrix_filter_counts, popcount_rows, the f32
//                       score with its threshold: one pass over the
//                       matrix writes one 64-bit key per row,
//                       key = float_bits(score) << 32 | (2^32 - 1 - row),
//                       and a histogram of the keys' top 12-bit digit;
//   sim_select (K10) <- jax.lax.top_k: the k largest keys, in descending
//                       order, decoded to (f32 score, int32 row); in its
//                       int mode, the count keys of csrc/mesh_finish.cu's
//                       count_keys decoded to (int64 count, int32 row),
//                       the lax.top_k of int64 counts (mesh.py:647-652,
//                       ops/topn.py:24).
// Scores are non-negative f32 (at most 1.0), so their bits order like
// their values and every key is below 2^62; the keys are distinct, and
// among equal scores the lower row has the larger key. So the k largest
// keys in descending order are exactly top_k's answer: ties to the lower
// index, a zero-score tail in index order. A count key is the count alone
// (count ^ 2^63, any int64): equal counts give equal keys, so the int
// mode selects and sorts (key, row) pairs, a larger key or an equal key
// of a lower row first, the row being the key's index.
//
// The scores round as the reference's f32 program: counts cast to f32
// (round to nearest), union = (|row| + |query|) - inter, one IEEE
// division, the threshold compared in f32. The intrinsics keep nvcc from
// contracting or approximating any of it.
//
// Bound on the H100: bytes. K9 reads the matrix once (the query from L1)
// and writes 8 B of key per row; at W = 64 (2048-bit fingerprints) a row
// is 256 B. Design: a team of T threads per row, T the power of two at
// or above the row's 16 B vectors (at most a warp), so one load of a warp
// reads whole rows, 512 B in a row at W = 64 (a thread's query vector
// then stays in a register); each thread takes four rows a trip and
// issues their loads together, the team's counts reduced with
// shuffles, one key per row from the team's first lane. Two waves of
// persistent blocks, sized from the kernel's occupancy; each block counts
// the query's bits once. The digit histogram lives in shared memory, one
// atomic per group of equal digits in a warp (match_any), merged into the
// global one at the end. A row width that is not a multiple of four words
// (or rows that are not 16 B aligned) takes the same loop over 4 B words.
//
// K10 has three routes (ops/similarity.py select_route). Up to 4,096 keys
// ("small"), one block loads every key into shared memory (48 KB with
// the rows), pads them to a power of two, sorts them with a bitonic
// network and decodes the first k: one launch and no scratch; in the int
// mode it can read the int64 counts and build their keys itself, so a
// top-k of a few counts is one launch where it was K12, ten K10 launches
// and five fills; and on the "small sim" route it reads the mesh search's
// reduced counts (inter, |row|, |query|) and scores them into their keys
// itself (sim_score.cuh, as K12's mesh_sim_keys does), so the search's
// finish is one launch where it was K12's and this one. Above that, a radix select over the keys' six digits
// (12, 12, 12, 12, 12 and 4 bits, most significant first: all 64). K9's
// histogram gives the first digit; each later level is a histogram pass
// over the keys that match the prefix chosen so far, and a one-block pick
// that finds the bin holding the k-th largest key. It stops once a chosen
// bin is taken whole, and then exactly k keys are >= the prefix. In the
// int mode, ties at the k-th count go on through the digits of the row
// order, 2^b - 1 - row for b row bits (12 at a time), among the keys
// equal to that count: (count, row) pairs are distinct, so the select
// always ends, with exactly k pairs at or above the (key, row-order)
// prefix. A compaction gathers them (with their rows in the int mode);
// up to 4,096 ("tile") one block sorts them as the small route does,
// above that ("radix") a stable LSD radix sort orders them, and the
// first k are decoded. Any k from 1 to R. The bound is reading the keys
// once: the small route is a launch, the select's levels are small
// launches, and the radix sort reads and writes the k gathered keys once
// a pass whose byte varies.
#include "common.cuh"
#include "sim_score.cuh"

#define SIM_BITS 12
#define SIM_BINS (1 << SIM_BITS)
#define SIM_FIRST_SHIFT 52
#define SIM_LEVELS 6
#define SIM_TILE 4096  // keys a block sorts in shared memory
#define SIM_SORT_THREADS 1024
#define SIM_ROWS 4  // rows a K9 thread loads together per trip

typedef unsigned long long u64;

struct SimState {
  u64 prefix;     // the digits chosen so far, zeros below
  u64 mask;       // the bits of the chosen digits
  u64 kr;         // keys still to take among those matching the prefix
  u64 done;       // 1 once exactly k keys are >= prefix
  u64 count;      // keys gathered by the compaction
  u64 prefix_lo;  // the int mode's row-order digits chosen so far
  u64 mask_lo;    // their bits
  u64 key_or;     // the OR of the gathered keys
  u64 key_nor;    // the OR of their complements: bits that vary are set in both
  unsigned row_or, row_nor;    // the same of their rows (the int mode)
  unsigned totals[256];        // the radix sort's count of each digit in the current pass
};
// the select's level histograms (5 key digits after the first, up to 3 of
// the row order) and its state, zeroed by the caller: int64 words
#define SIM_HIST_LEVELS 8
#define SIM_STATE_WORDS 160
static_assert(sizeof(SimState) <= SIM_STATE_WORDS * 8, "the state fits its words");

template <int VEC>
struct SimWord;
template <>
struct SimWord<4> {
  typedef uint4 T;
};
template <>
struct SimWord<1> {
  typedef unsigned T;
};

__device__ __forceinline__ unsigned sim_popc(uint4 v) { return pt_popc4(v); }
__device__ __forceinline__ unsigned sim_popc(unsigned v) { return __popc(v); }
__device__ __forceinline__ uint4 sim_and(uint4 a, uint4 b) { return pt_and4(a, b); }
__device__ __forceinline__ unsigned sim_and(unsigned a, unsigned b) { return a & b; }

// Add one to s_hist[d] for every lane with has set, one shared atomic
// per group of equal digits in the warp. Every lane of the warp calls it.
__device__ __forceinline__ void sim_count_digit(unsigned* s_hist, bool has,
                                                unsigned d) {
  if (!__any_sync(0xffffffffu, has)) return;
  const unsigned peers = __match_any_sync(0xffffffffu, has ? d : 0xffffffffu);
  if (has && (threadIdx.x & 31) == __ffs(peers) - 1) {
    atomicAdd(&s_hist[d], (unsigned)__popc(peers));
  }
}

template <int VEC>
__global__ void __launch_bounds__(PT_BLOCK)
    sim_scan_kernel(const unsigned* __restrict__ m, long long n_rows,
                    long long n_words, const unsigned* __restrict__ q,
                    float thr, int team, u64* __restrict__ keys,
                    unsigned* __restrict__ hist) {
  typedef typename SimWord<VEC>::T V;
  __shared__ unsigned s_hist[SIM_BINS];
  __shared__ unsigned s_qpop;
  for (int i = threadIdx.x; i < SIM_BINS; i += PT_BLOCK) s_hist[i] = 0u;
  unsigned long long qp = 0;
  for (long long i = threadIdx.x; i < n_words; i += PT_BLOCK) qp += __popc(__ldg(&q[i]));
  qp = pt_block_sum(qp);
  if (threadIdx.x == 0) s_qpop = (unsigned)qp;
  __syncthreads();
  const float fq = __uint2float_rn(s_qpop);
  const long long n_vec = n_words / VEC;
  const V* qv = reinterpret_cast<const V*>(q);
  const int lane_t = threadIdx.x & (team - 1);
  const long long span = PT_BLOCK / team;  // rows one load of the block covers
  const long long trip = span * SIM_ROWS;  // rows a block takes per trip
  // a row of at most `team` vectors: one vector a thread, whose query
  // vector stays in a register
  const bool single = n_vec <= team;
  const V y1 = single && lane_t < n_vec ? __ldg(&qv[lane_t]) : V{};
  // every lane runs the same trips: the shuffles and match_any need the
  // whole warp
  for (long long base = (long long)blockIdx.x * trip; base < n_rows;
       base += (long long)gridDim.x * trip) {
    unsigned inter[SIM_ROWS], pop[SIM_ROWS];
    const V* r[SIM_ROWS];
    bool live[SIM_ROWS];
#pragma unroll
    for (int g = 0; g < SIM_ROWS; ++g) {
      const long long row = base + g * span + threadIdx.x / team;
      live[g] = row < n_rows;
      r[g] = reinterpret_cast<const V*>(m + (live[g] ? row : 0) * n_words);
      inter[g] = 0u;
      pop[g] = 0u;
    }
    // a row past the end reads row 0 again (cached) and is dropped below,
    // so the loads need no branch and go out together
    if (single) {
      if (lane_t < n_vec) {
        V x[SIM_ROWS];
#pragma unroll
        for (int g = 0; g < SIM_ROWS; ++g) x[g] = r[g][lane_t];
#pragma unroll
        for (int g = 0; g < SIM_ROWS; ++g) {
          inter[g] = sim_popc(sim_and(x[g], y1));
          pop[g] = sim_popc(x[g]);
        }
      }
    } else {
      for (long long v = lane_t; v < n_vec; v += team) {
        V x[SIM_ROWS];
#pragma unroll
        for (int g = 0; g < SIM_ROWS; ++g) x[g] = r[g][v];
        const V y = __ldg(&qv[v]);
#pragma unroll
        for (int g = 0; g < SIM_ROWS; ++g) {
          inter[g] += sim_popc(sim_and(x[g], y));
          pop[g] += sim_popc(x[g]);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < SIM_ROWS; ++g) {
      for (int off = team >> 1; off > 0; off >>= 1) {
        inter[g] += __shfl_xor_sync(0xffffffffu, inter[g], off);
        pop[g] += __shfl_xor_sync(0xffffffffu, pop[g], off);
      }
      const long long row = base + g * span + threadIdx.x / team;
      const bool has = live[g] && lane_t == 0;
      u64 key = 0;
      if (has) {
        const float fi = __uint2float_rn(inter[g]);
        const float uni = __fsub_rn(__fadd_rn(__uint2float_rn(pop[g]), fq), fi);
        float sc = uni > 0.f ? __fdiv_rn(fi, uni) : 0.f;
        if (!(sc >= thr)) sc = 0.f;
        key = ((u64)__float_as_uint(sc) << 32) | (u64)(0xffffffffu - (unsigned)row);
        keys[row] = key;
      }
      sim_count_digit(s_hist, has, (unsigned)(key >> SIM_FIRST_SHIFT));
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < SIM_BINS; i += PT_BLOCK) {
    if (s_hist[i]) atomicAdd(&hist[i], s_hist[i]);
  }
}

static unsigned sim_grid(long long items, long long per_block) {
  long long blocks = (items + per_block - 1) / per_block;
  if (blocks > pt_resident_blocks()) blocks = pt_resident_blocks();
  return (unsigned)(blocks < 1 ? 1 : blocks);
}

// Two waves of the blocks the card holds at once (a register-heavy
// kernel holds fewer than eight a SM, and a partial last wave idles SMs).
template <typename K>
static long long sim_waves(K kernel) {
  int per_sm = 0, dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, PT_BLOCK, 0);
  const long long blocks = 2ll * (per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 132);
  return blocks;
}

// matrix: int32[R, W]; query: int32[W]; vec: rows and query are 16 B
// aligned and W % 4 == 0; keys: int64[R]; hist: zeroed int32[4096].
// Returns cudaGetLastError().
PT_EXPORT int sim_scan(const void* matrix, long long n_rows, long long n_words,
                       const void* query, float thr, int vec, void* keys,
                       void* hist, void* stream) {
  if (n_rows < 0 || n_rows > 0x7fffffffLL || n_words < 1 ||
      n_words > (1ll << 26) || (vec && n_words % 4)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_rows == 0) return (int)cudaGetLastError();
  const long long n_vec = vec ? n_words / 4 : n_words;
  int team = 1;  // a power of two >= the row's vectors, at most a warp
  while (team < 32 && team < n_vec) team <<= 1;
  const long long trip = (long long)(PT_BLOCK / team) * SIM_ROWS;
  long long grid = (n_rows + trip - 1) / trip;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec) {
    static const long long most = sim_waves(sim_scan_kernel<4>);
    if (grid > most) grid = most;
    sim_scan_kernel<4><<<(unsigned)grid, PT_BLOCK, 0, s>>>(
        (const unsigned*)matrix, n_rows, n_words, (const unsigned*)query, thr,
        team, (u64*)keys, (unsigned*)hist);
  } else {
    static const long long most = sim_waves(sim_scan_kernel<1>);
    if (grid > most) grid = most;
    sim_scan_kernel<1><<<(unsigned)grid, PT_BLOCK, 0, s>>>(
        (const unsigned*)matrix, n_rows, n_words, (const unsigned*)query, thr,
        team, (u64*)keys, (unsigned*)hist);
  }
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ K10

// One block: find the bin of this level's histogram that holds the
// kr-th largest key among those matching the prefix (bins scanned from
// the top), and extend the prefix by it (the row-order prefix with
// `rows`). `first` starts the select with kr = k.
__global__ void __launch_bounds__(SIM_SORT_THREADS)
    sim_pick_kernel(const unsigned* __restrict__ hist, int shift, int bits,
                    int rows, int first, u64 k, SimState* st) {
  __shared__ u64 s_sum[SIM_SORT_THREADS];
  if (!first && st->done) return;  // uniform: read before any write below
  const u64 kr = first ? k : st->kr;
  const int per = SIM_BINS / SIM_SORT_THREADS;
  const int nb = 1 << bits;
  const int t = threadIdx.x;
  u64 local = 0;
  for (int j = 0; j < per; ++j) {
    const int p = t * per + j;  // rank from the top
    if (p < nb) local += hist[nb - 1 - p];
  }
  s_sum[t] = local;
  __syncthreads();
  for (int off = 1; off < SIM_SORT_THREADS; off <<= 1) {
    const u64 v = t >= off ? s_sum[t - off] : 0ull;
    __syncthreads();
    s_sum[t] += v;
    __syncthreads();
  }
  u64 cum = t ? s_sum[t - 1] : 0ull;  // keys in the bins above this thread's
  if (!(cum < kr && kr <= s_sum[t])) return;  // one thread goes on
  for (int j = 0; j < per; ++j) {
    const int p = t * per + j;
    if (p >= nb) break;
    const int b = nb - 1 - p;
    const u64 h = hist[b];
    if (kr <= cum + h) {
      const u64 rest = kr - cum;
      if (first) {
        st->prefix = 0;
        st->mask = 0;
      }
      if (rows) {
        st->prefix_lo |= (u64)b << shift;
        st->mask_lo |= (u64)(nb - 1) << shift;
      } else {
        st->prefix |= (u64)b << shift;
        st->mask |= (u64)(nb - 1) << shift;
      }
      st->kr = rest;
      st->done = h == rest ? 1ull : 0ull;
      return;
    }
    cum += h;
  }
}

// Histogram of one digit over the keys that match the prefix so far; with
// `rows`, of one digit of the row order (low - row) over the keys equal
// to the chosen count whose row order matches its prefix so far.
__global__ void __launch_bounds__(PT_BLOCK)
    sim_hist_kernel(const u64* __restrict__ keys, long long n, int shift,
                    unsigned dmask, int rows, u64 low,
                    const SimState* __restrict__ st,
                    unsigned* __restrict__ hist) {
  __shared__ unsigned s_hist[SIM_BINS];
  if (st->done) return;
  const u64 prefix = st->prefix, mask = st->mask;
  const u64 prefix_lo = st->prefix_lo, mask_lo = st->mask_lo;
  for (int i = threadIdx.x; i < SIM_BINS; i += PT_BLOCK) s_hist[i] = 0u;
  __syncthreads();
  for (long long base = (long long)blockIdx.x * PT_BLOCK; base < n;
       base += (long long)gridDim.x * PT_BLOCK) {
    const long long i = base + threadIdx.x;
    const u64 key = i < n ? keys[i] : 0ull;
    const u64 order = low - (u64)i;
    const bool has = i < n && (key & mask) == prefix &&
                     (!rows || (order & mask_lo) == prefix_lo);
    const u64 digit = rows ? order >> shift : key >> shift;
    sim_count_digit(s_hist, has, (unsigned)digit & dmask);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < SIM_BINS; i += PT_BLOCK) {
    if (s_hist[i]) atomicAdd(&hist[i], s_hist[i]);
  }
}

// Gather the keys at or above the final prefix (exactly k of them), in
// any order; in the int mode (out_rows non-null) a key equal to the
// chosen count only where its row order is at or above the row prefix,
// and each key's row beside it. A block takes SIM_COMPACT_ITEMS keys a
// thread a trip, and one atomic reserves the places of its takes. The
// ORs of the taken keys and of their complements (and of the rows) mark
// the bits that vary among them: the radix sort runs only the passes
// whose byte varies.
#define SIM_COMPACT_ITEMS 8
__global__ void __launch_bounds__(PT_BLOCK)
    sim_compact_kernel(const u64* __restrict__ keys, long long n, u64 k,
                       u64 low, SimState* st, u64* __restrict__ out,
                       unsigned* __restrict__ out_rows) {
  __shared__ unsigned s_warp[PT_BLOCK / 32];
  __shared__ u64 s_base;
  __shared__ unsigned s_tot;
  __shared__ u64 s_key[PT_BLOCK * SIM_COMPACT_ITEMS];
  __shared__ unsigned s_row[PT_BLOCK * SIM_COMPACT_ITEMS];
  const u64 lo = st->prefix, lo_rows = st->prefix_lo;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long trip = (long long)PT_BLOCK * SIM_COMPACT_ITEMS;
  u64 key_or = 0ull, key_nor = 0ull;
  unsigned row_or = 0u, row_nor = 0u;
  for (long long base = (long long)blockIdx.x * trip; base < n;
       base += (long long)gridDim.x * trip) {
    u64 key[SIM_COMPACT_ITEMS];
    unsigned take = 0u, cnt = 0u;  // take: a bit per item
#pragma unroll
    for (int j = 0; j < SIM_COMPACT_ITEMS; ++j) {
      const long long i = base + j * PT_BLOCK + threadIdx.x;
      key[j] = i < n ? keys[i] : 0ull;
      const bool t = i < n && (key[j] > lo || (key[j] == lo && (out_rows == nullptr ||
                                                                low - (u64)i >= lo_rows)));
      take |= (unsigned)t << j;
      cnt += t;
    }
    unsigned incl = cnt;  // the block's exclusive scan of the takes
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned tot = 0u;
      for (int w = 0; w < PT_BLOCK / 32; ++w) {
        const unsigned c = s_warp[w];
        s_warp[w] = tot;
        tot += c;
      }
      s_tot = tot;
      s_base = tot ? atomicAdd(&st->count, (u64)tot) : 0ull;
    }
    __syncthreads();
    // stage the takes in shared memory, then write them out with
    // consecutive threads on consecutive places
    unsigned pos = s_warp[warp] + incl - cnt;
#pragma unroll
    for (int j = 0; j < SIM_COMPACT_ITEMS; ++j) {
      if (take >> j & 1u) {
        const unsigned row = (unsigned)(base + j * PT_BLOCK + threadIdx.x);
        s_key[pos] = key[j];
        s_row[pos] = row;
        key_or |= key[j];
        key_nor |= ~key[j];
        row_or |= row;
        row_nor |= ~row;
        ++pos;
      }
    }
    __syncthreads();
    const unsigned tot = s_tot;
    const u64 at = s_base;
    for (unsigned i = threadIdx.x; i < tot; i += PT_BLOCK) {
      if (at + i < k) {
        out[at + i] = s_key[i];
        if (out_rows != nullptr) out_rows[at + i] = s_row[i];
      }
    }
    __syncthreads();  // the shared staging is the next trip's
  }
  for (int off = 16; off > 0; off >>= 1) {
    key_or |= __shfl_xor_sync(0xffffffffu, key_or, off);
    key_nor |= __shfl_xor_sync(0xffffffffu, key_nor, off);
    row_or |= __shfl_xor_sync(0xffffffffu, row_or, off);
    row_nor |= __shfl_xor_sync(0xffffffffu, row_nor, off);
  }
  if (lane == 0) {
    if (key_or) atomicOr(&st->key_or, key_or);
    if (key_nor) atomicOr(&st->key_nor, key_nor);
    if (row_or) atomicOr(&st->row_or, row_or);
    if (row_nor) atomicOr(&st->row_nor, row_nor);
  }
}

// Does (kx, rx) come before (ky, ry) in the output: a larger key, or an
// equal key of a lower row. Score keys (no rows) are distinct.
template <bool PAIR>
__device__ __forceinline__ bool sim_before(u64 kx, unsigned rx, u64 ky,
                                           unsigned ry) {
  return kx > ky || (PAIR && kx == ky && rx < ry);
}

// Compare-exchange for a descending bitonic sort: the pair (lo, hi) of a
// merge of `size` runs descending where lo's size bit is clear.
template <bool PAIR>
__device__ __forceinline__ void sim_cmpx(u64* a, unsigned* r, long long lo,
                                         long long hi, bool desc) {
  const u64 x = a[lo], y = a[hi];
  const unsigned rx = PAIR ? r[lo] : 0u, ry = PAIR ? r[hi] : 0u;
  if (desc ? sim_before<PAIR>(y, ry, x, rx) : sim_before<PAIR>(x, rx, y, ry)) {
    a[lo] = y;
    a[hi] = x;
    if (PAIR) {
      r[lo] = ry;
      r[hi] = rx;
    }
  }
}

// Sort n_pad (a power of two, at most SIM_TILE) entries of one block's
// shared memory descending with a bitonic network: merge sizes 2 to
// n_pad, each from stride size / 2 down to 1.
template <bool PAIR>
__device__ void sim_block_sort(u64* s, unsigned* sr, int n_pad) {
  for (int size = 2; size <= n_pad; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int p = threadIdx.x; p < n_pad / 2; p += blockDim.x) {
        const int lo = ((p & ~(stride - 1)) << 1) | (p & (stride - 1));
        sim_cmpx<PAIR>(s, sr, lo, lo + stride, (lo & size) == 0);
      }
      __syncthreads();
    }
  }
}

// Decode sorted entry i: score keys (no rows) to the f32 score of the
// high half and the row of the low; count keys to the int64 count (key ^
// 2^63) and the row beside the key.
template <bool PAIR>
__device__ __forceinline__ void sim_decode(u64 key, unsigned row, long long i,
                                           void* __restrict__ values, int* __restrict__ ids) {
  if (PAIR) {
    ((long long*)values)[i] = (long long)(key ^ (1ull << 63));
    ids[i] = (int)row;
  } else {
    ((float*)values)[i] = __uint_as_float((unsigned)(key >> 32));
    ids[i] = (int)(0xffffffffu - (unsigned)key);
  }
}

// What the small route's block reads as its entries: the keys; int64
// counts, whose key is count ^ 2^63; or a search's int64 counts inter =
// |row ∩ query| with |row| and |query| beside them, whose key is the
// score's (sim_score_key).
#define SIM_FROM_KEYS 0
#define SIM_FROM_COUNTS 1
#define SIM_FROM_SCORES 2

// One block: load m <= SIM_TILE entries into shared memory, pad them to
// n_pad, sort them and decode the first k. `src` holds what `from` says;
// `rows` the rows beside them (PAIR; null: an entry's row is its index);
// `row_pop`, `q_pop` and `metric` the rest of a score's counts
// (SIM_FROM_SCORES, score keys only). A pad is key 0 and, with rows, row
// 2^32 - 1, so it sorts after every real entry: a score key is above 0
// (its low half is 2^32 - 1 - row), and a count of -2^63 (key 0) has a
// row below 2^31, which wins the tie.
template <bool PAIR>
__global__ void __launch_bounds__(SIM_SORT_THREADS)
    sim_small_kernel(const u64* __restrict__ src, const unsigned* __restrict__ rows, int m,
                     int n_pad, int from, const long long* __restrict__ row_pop,
                     const long long* __restrict__ q_pop, int metric, long long k,
                     void* __restrict__ values, int* __restrict__ ids) {
  __shared__ u64 s[SIM_TILE];
  __shared__ unsigned sr[PAIR ? SIM_TILE : 1];
  const float fq = from == SIM_FROM_SCORES ? __ll2float_rn(*q_pop) : 0.f;
  for (int i = threadIdx.x; i < n_pad; i += blockDim.x) {
    const bool real = i < m;
    u64 key = 0ull;
    if (real) {
      key = src[i];
      if (from == SIM_FROM_COUNTS) {
        key ^= 1ull << 63;
      } else if (from == SIM_FROM_SCORES) {
        key = sim_score_key(sim_metric_score(__ll2float_rn((long long)key),
                                             __ll2float_rn(row_pop[i]), fq, metric),
                            i);
      }
    }
    s[i] = key;
    if (PAIR) sr[i] = real ? (rows != nullptr ? rows[i] : (unsigned)i) : 0xffffffffu;
  }
  __syncthreads();
  sim_block_sort<PAIR>(s, sr, n_pad);
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    sim_decode<PAIR>(s[i], PAIR ? sr[i] : 0u, i, values, ids);
  }
}

// The radix sort of the k gathered entries (k above the tile): a stable
// LSD sort by 8-bit digits, least significant first (in the int mode the
// row's bytes, ascending, then the key's, descending), keys and rows in
// two ping-pong buffers. A pass whose byte is the same in every entry
// (its histogram would have one non-empty bin) is skipped: the
// compaction's ORs show which bytes vary, and the buffer that holds the
// entries before pass p is the parity of the passes run before it. A
// pass is three launches: a histogram per block of RS_TILE entries into
// a [digit][block] table, a scan of each digit's row of the table (one
// block a digit) with the digit's total, and a stable scatter. The
// scatter ranks each entry among the equal digits before it in its warp
// (eight ballots), stages the block's entries in shared memory in digit
// order, and writes each digit's run with consecutive threads.
#define RS_BINS 256
#define RS_ITEMS 8                      // entries a thread holds
#define RS_WARP_ITEMS (32 * RS_ITEMS)   // a warp's run of consecutive entries
#define RS_TILE (PT_BLOCK * RS_ITEMS)   // a block's
#define RS_WARPS (PT_BLOCK / 32)
static_assert(PT_BLOCK == RS_BINS, "one thread per bin");

// Whether pass p (the row's bytes first, then the key's) has a byte that
// varies among the entries.
__device__ __forceinline__ bool rs_live(const SimState* st, int pass, int row_passes) {
  if (pass < row_passes) return ((st->row_or & st->row_nor) >> (8 * pass)) & 255u;
  return ((st->key_or & st->key_nor) >> (8 * (pass - row_passes))) & 255ull;
}

// The buffer that holds the entries before pass p.
__device__ __forceinline__ int rs_cur(const SimState* st, int pass, int row_passes) {
  int cur = 0;
  for (int q = 0; q < pass; ++q) cur ^= (int)rs_live(st, q, row_passes);
  return cur;
}

// A pass's digit: a byte of the row (ascending) or of the key, inverted
// (descending).
__device__ __forceinline__ unsigned rs_digit(u64 key, unsigned row, int pass, int row_passes) {
  return pass < row_passes ? (row >> (8 * pass)) & 255u
                           : 255u - (unsigned)((key >> (8 * (pass - row_passes))) & 255ull);
}

// The lanes of the warp with the same digit (and the same `has`).
__device__ __forceinline__ unsigned rs_peers(unsigned d, bool has) {
  const unsigned h = __ballot_sync(0xffffffffu, has);
  unsigned peers = has ? h : ~h;
#pragma unroll
  for (int bit = 0; bit < 8; ++bit) {
    const unsigned b = __ballot_sync(0xffffffffu, (d >> bit) & 1u);
    peers &= (d >> bit) & 1u ? b : ~b;
  }
  return peers;
}

// An inclusive scan of one value per lane over the warp.
__device__ __forceinline__ unsigned rs_warp_scan(unsigned v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned u = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += u;
  }
  return v;
}

__global__ void __launch_bounds__(PT_BLOCK)
    rs_hist_kernel(const u64* __restrict__ k0, const u64* __restrict__ k1,
                   const unsigned* __restrict__ r0, const unsigned* __restrict__ r1,
                   long long k, int pass, int row_passes, const SimState* __restrict__ st,
                   unsigned* __restrict__ table, long long nblk) {
  __shared__ unsigned s_hist[RS_BINS];
  if (!rs_live(st, pass, row_passes)) return;  // uniform
  const int cur = rs_cur(st, pass, row_passes);
  const u64* keys = cur ? k1 : k0;
  const unsigned* rows = cur ? r1 : r0;
  const bool on_rows = pass < row_passes;
  s_hist[threadIdx.x] = 0u;
  __syncthreads();
  const long long base = (long long)blockIdx.x * RS_TILE + threadIdx.x;
  unsigned d[RS_ITEMS];
#pragma unroll
  for (int i = 0; i < RS_ITEMS; ++i) {
    const long long e = base + i * PT_BLOCK;
    d[i] = e >= k ? RS_BINS : on_rows ? rs_digit(0ull, rows[e], pass, row_passes)
                                      : rs_digit(keys[e], 0u, pass, row_passes);
  }
#pragma unroll
  for (int i = 0; i < RS_ITEMS; ++i) {
    if (d[i] < RS_BINS) atomicAdd(&s_hist[d[i]], 1u);
  }
  __syncthreads();
  table[(long long)threadIdx.x * nblk + blockIdx.x] = s_hist[threadIdx.x];
}

// Block d: the exclusive scan of digit d's row of the table in place (the
// entries of that digit in the blocks before each), and its total.
__global__ void __launch_bounds__(PT_BLOCK)
    rs_scan_kernel(unsigned* __restrict__ table, long long nblk, int pass, int row_passes,
                   SimState* st) {
  __shared__ unsigned s_warp[RS_WARPS];
  if (!rs_live(st, pass, row_passes)) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned* row = table + (long long)blockIdx.x * nblk;
  unsigned carry = 0u;
  for (long long b0 = 0; b0 < nblk; b0 += PT_BLOCK) {
    const long long b = b0 + threadIdx.x;
    const unsigned v = b < nblk ? row[b] : 0u;
    const unsigned incl = rs_warp_scan(v);
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    unsigned before = 0u, tot = 0u;
#pragma unroll
    for (int w = 0; w < RS_WARPS; ++w) {
      const unsigned c = s_warp[w];
      before += w < warp ? c : 0u;
      tot += c;
    }
    if (b < nblk) row[b] = carry + before + incl - v;
    carry += tot;
    __syncthreads();
  }
  if (threadIdx.x == 0) st->totals[blockIdx.x] = carry;
}

// The last pass whose byte varies decodes its entries into the outputs
// in place of writing them to the other buffer. (More than 4,096 distinct
// keys, or (key, row) pairs, always have a byte that varies.)
template <bool PAIR>
__global__ void __launch_bounds__(PT_BLOCK)
    rs_scatter_kernel(u64* k0, u64* k1, unsigned* r0, unsigned* r1, long long k, int pass,
                      int row_passes, int passes, const SimState* __restrict__ st,
                      const unsigned* __restrict__ table, long long nblk,
                      void* __restrict__ values, int* __restrict__ ids) {
  __shared__ unsigned s_cnt[RS_WARPS][RS_BINS];  // per warp and digit: count, then start
  __shared__ unsigned s_lstart[RS_BINS], s_gstart[RS_BINS];
  __shared__ unsigned s_warp[2 * RS_WARPS];
  __shared__ u64 s_key[RS_TILE];
  __shared__ unsigned s_row[PAIR ? RS_TILE : 1];
  if (!rs_live(st, pass, row_passes)) return;  // uniform
  bool last = true;
  for (int q = pass + 1; q < passes; ++q) last = last && !rs_live(st, q, row_passes);
  const int src = rs_cur(st, pass, row_passes);
  const u64* keys = src ? k1 : k0;
  u64* out = src ? k0 : k1;
  const unsigned* rows = src ? r1 : r0;
  unsigned* out_rows = src ? r0 : r1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, t = threadIdx.x;
#pragma unroll
  for (int w = 0; w < RS_WARPS; ++w) s_cnt[w][t] = 0u;
  const long long tile0 = (long long)blockIdx.x * RS_TILE;
  const long long base = tile0 + warp * RS_WARP_ITEMS + lane;
  u64 key[RS_ITEMS];
  unsigned row[RS_ITEMS], pos[RS_ITEMS];  // pos: digit << 16 | rank in the warp's run of it
#pragma unroll
  for (int i = 0; i < RS_ITEMS; ++i) {
    const long long e = base + i * 32;
    key[i] = e < k ? keys[e] : 0ull;
    row[i] = PAIR && e < k ? rows[e] : 0u;
  }
  __syncthreads();
  const unsigned lt = (1u << lane) - 1u;
#pragma unroll
  for (int i = 0; i < RS_ITEMS; ++i) {
    const bool has = base + i * 32 < k;
    const unsigned d = has ? rs_digit(key[i], row[i], pass, row_passes) : 0u;
    const unsigned peers = rs_peers(d, has);
    const int leader = __ffs(peers) - 1;
    unsigned before = 0u;
    if (has && lane == leader) {
      before = s_cnt[warp][d];
      s_cnt[warp][d] = before + __popc(peers);
    }
    before = __shfl_sync(0xffffffffu, before, leader);
    pos[i] = (has ? d : RS_BINS) << 16 | (before + __popc(peers & lt));
    __syncwarp();
  }
  __syncthreads();
  // thread t, digit t: each warp's start among the block's entries of t,
  // the block's start of t in its staged order, and t's first place in
  // the output (the digits below t, then t in the blocks before)
  unsigned run = 0u;
#pragma unroll
  for (int w = 0; w < RS_WARPS; ++w) {
    const unsigned c = s_cnt[w][t];
    s_cnt[w][t] = run;
    run += c;
  }
  const unsigned total = st->totals[t];
  const unsigned incl = rs_warp_scan(run), gincl = rs_warp_scan(total);
  if (lane == 31) {
    s_warp[warp] = incl;
    s_warp[RS_WARPS + warp] = gincl;
  }
  __syncthreads();
  unsigned lbase = 0u, gbase = 0u;
#pragma unroll
  for (int w = 0; w < RS_WARPS; ++w) {
    lbase += w < warp ? s_warp[w] : 0u;
    gbase += w < warp ? s_warp[RS_WARPS + w] : 0u;
  }
  s_lstart[t] = lbase + incl - run;
  s_gstart[t] = gbase + gincl - total + table[(long long)t * nblk + blockIdx.x];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < RS_ITEMS; ++i) {
    const unsigned d = pos[i] >> 16;
    if (d < RS_BINS) {
      const unsigned p = s_lstart[d] + s_cnt[warp][d] + (pos[i] & 0xffffu);
      s_key[p] = key[i];
      if (PAIR) s_row[p] = row[i];
    }
  }
  __syncthreads();
  const int count = (int)min((long long)RS_TILE, k - tile0);
  for (int j = t; j < count; j += PT_BLOCK) {
    const u64 kj = s_key[j];
    const unsigned rj = PAIR ? s_row[j] : 0u;
    const unsigned d = rs_digit(kj, rj, pass, row_passes);
    const unsigned g = s_gstart[d] + (unsigned)j - s_lstart[d];
    if (last) {
      sim_decode<PAIR>(kj, rj, g, values, ids);
    } else {
      out[g] = kj;
      if (PAIR) out_rows[g] = rj;
    }
  }
}

template <bool PAIR>
static void sim_radix_sort(u64* k0, unsigned* r0, long long k, int int_bits, SimState* st,
                           void* values, void* ids, cudaStream_t s) {
  const long long nblk = (k + RS_TILE - 1) / RS_TILE;
  u64* k1 = k0 + k;
  unsigned* table = (unsigned*)(k1 + k);
  unsigned* r1 = PAIR ? r0 + k : nullptr;
  // rows < 2^int_bits: the bytes above are zero
  const int row_passes = PAIR ? (int_bits + 7) / 8 : 0;
  const int passes = row_passes + 8;
  for (int p = 0; p < passes; ++p) {
    rs_hist_kernel<<<(unsigned)nblk, PT_BLOCK, 0, s>>>(k0, k1, r0, r1, k, p, row_passes, st,
                                                      table, nblk);
    rs_scan_kernel<<<RS_BINS, PT_BLOCK, 0, s>>>(table, nblk, p, row_passes, st);
    rs_scatter_kernel<PAIR><<<(unsigned)nblk, PT_BLOCK, 0, s>>>(
        k0, k1, r0, r1, k, p, row_passes, passes, st, table, nblk, values, (int*)ids);
  }
}

// The power of two at or above n (n >= 1).
static long long sim_pow2(long long n) {
  long long p = 1;
  while (p < n) p <<= 1;
  return p;
}

static int sim_sort_threads(long long n_pad) {
  const long long t = n_pad / 2;
  return (int)(t < 32 ? 32 : t > SIM_SORT_THREADS ? SIM_SORT_THREADS : t);
}

// K10's routes (ops/similarity.py select_route):
//   SIM_SMALL:        n <= SIM_TILE keys (score keys, or count keys with
//                     int_bits > 0), one block, one launch;
//   SIM_SMALL_COUNTS: n <= SIM_TILE int64 counts, whose keys the block
//                     builds itself (count ^ 2^63), one launch;
//   SIM_SMALL_SIM:    n <= SIM_TILE counts of a search (keys: inter,
//                     with row_pop, q_pop and metric), whose score keys
//                     the block builds itself, one launch;
//   SIM_TILE_ROUTE:   the radix select, the compaction, and k <= SIM_TILE
//                     gathered keys sorted in one block;
//   SIM_RADIX:        the radix select, the compaction, and k > SIM_TILE
//                     gathered keys ordered by the radix sort.
#define SIM_SMALL 0
#define SIM_SMALL_COUNTS 1
#define SIM_TILE_ROUTE 2
#define SIM_RADIX 3
#define SIM_SMALL_SIM 4

// keys: int64[n] (counts for SIM_SMALL_COUNTS, inter for SIM_SMALL_SIM,
// with row_pop int64[n], q_pop int64[1] and metric 0 Tanimoto or 1
// cosine; null and 0 on the other routes); hist0: the keys' top-digit
// histogram (sim_scan, mesh_sim_keys, count_keys; the select routes);
// zeroed: zeroed int64[SIM_HIST_LEVELS * SIM_BINS / 2 + SIM_STATE_WORDS]
// (16,544), the select's level
// histograms and its state; work: uninitialised bytes, 8k (+ 4k in the int mode) on
// the tile route, 16k + 4 * 256 * ceil(k / 2048) (+ 8k in the int
// mode) on the radix route; int_bits: 0 for score keys, then values is
// f32[k], or the row bits b of count keys (n <= 2^b), then values is
// int64[k]; ids: int32[k]. Returns cudaGetLastError().
PT_EXPORT int sim_select(const void* keys, long long n, const void* hist0, void* zeroed,
                         void* work, long long k, int int_bits, int route,
                         const void* row_pop, const void* q_pop, int metric, void* values,
                         void* ids, void* stream) {
  const bool small = route == SIM_SMALL || route == SIM_SMALL_COUNTS || route == SIM_SMALL_SIM;
  if (n < 1 || n > 0x7fffffffLL || k < 1 || k > n || int_bits < 0 || int_bits > 31 ||
      (int_bits > 0 && n > (1ll << int_bits)) || route < SIM_SMALL || route > SIM_SMALL_SIM ||
      (small && n > SIM_TILE) || (route == SIM_SMALL_COUNTS && int_bits == 0) ||
      (route == SIM_SMALL_SIM &&
       (int_bits != 0 || row_pop == nullptr || q_pop == nullptr ||
        (metric != SIM_METRIC_TANIMOTO && metric != SIM_METRIC_COSINE))) ||
      (route == SIM_TILE_ROUTE && k > SIM_TILE) || (route == SIM_RADIX && k <= SIM_TILE) ||
      (!small && (hist0 == nullptr || zeroed == nullptr || work == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const bool pair = int_bits > 0;
  if (small) {
    const long long pad = sim_pow2(n);
    const int threads = sim_sort_threads(pad);
    if (pair) {
      sim_small_kernel<true><<<1, threads, 0, s>>>(
          (const u64*)keys, nullptr, (int)n, (int)pad,
          route == SIM_SMALL_COUNTS ? SIM_FROM_COUNTS : SIM_FROM_KEYS, nullptr, nullptr, 0, k,
          values, (int*)ids);
    } else {
      sim_small_kernel<false><<<1, threads, 0, s>>>(
          (const u64*)keys, nullptr, (int)n, (int)pad,
          route == SIM_SMALL_SIM ? SIM_FROM_SCORES : SIM_FROM_KEYS, (const long long*)row_pop,
          (const long long*)q_pop, metric, k, values, (int*)ids);
    }
    return (int)cudaGetLastError();
  }
  static const int shifts[SIM_LEVELS] = {SIM_FIRST_SHIFT, 40, 28, 16, 4, 0};
  static const int bits[SIM_LEVELS] = {SIM_BITS, SIM_BITS, SIM_BITS, SIM_BITS, SIM_BITS, 4};
  const u64* kk = (const u64*)keys;
  unsigned* h = (unsigned*)zeroed;
  SimState* st = (SimState*)(h + SIM_HIST_LEVELS * SIM_BINS);
  const unsigned grid = sim_grid(n, PT_BLOCK);
  const u64 low = pair ? (1ull << int_bits) - 1ull : 0ull;
  sim_pick_kernel<<<1, SIM_SORT_THREADS, 0, s>>>((const unsigned*)hist0, shifts[0], bits[0], 0,
                                                 1, (u64)k, st);
  for (int level = 1; level < SIM_LEVELS; ++level, h += SIM_BINS) {
    sim_hist_kernel<<<grid, PT_BLOCK, 0, s>>>(kk, n, shifts[level], (1u << bits[level]) - 1u, 0,
                                              low, st, h);
    sim_pick_kernel<<<1, SIM_SORT_THREADS, 0, s>>>(h, shifts[level], bits[level], 0, 0, (u64)k,
                                                   st);
  }
  // the int mode's ties: the row order's digits, 12 at a time from the top
  for (int top = int_bits; top > 0; h += SIM_BINS) {
    const int w = top < SIM_BITS ? top : SIM_BITS;
    top -= w;
    sim_hist_kernel<<<grid, PT_BLOCK, 0, s>>>(kk, n, top, (1u << w) - 1u, 1, low, st, h);
    sim_pick_kernel<<<1, SIM_SORT_THREADS, 0, s>>>(h, top, w, 1, 0, (u64)k, st);
  }
  u64* a = (u64*)work;
  // work: the gathered keys (twice, and the radix table, on the radix
  // route), then their rows
  const long long words = route == SIM_RADIX ? 2 * k + RS_BINS / 2 * ((k + RS_TILE - 1) / RS_TILE) : k;
  unsigned* ra = pair ? (unsigned*)(a + words) : nullptr;
  sim_compact_kernel<<<sim_grid(n, PT_BLOCK * SIM_COMPACT_ITEMS), PT_BLOCK, 0, s>>>(
      kk, n, (u64)k, low, st, a, ra);
  if (route == SIM_TILE_ROUTE) {
    const long long n_pad = sim_pow2(k);
    const int threads = sim_sort_threads(n_pad);
    if (pair) {
      sim_small_kernel<true><<<1, threads, 0, s>>>(a, ra, (int)k, (int)n_pad, SIM_FROM_KEYS,
                                                   nullptr, nullptr, 0, k, values, (int*)ids);
    } else {
      sim_small_kernel<false><<<1, threads, 0, s>>>(a, nullptr, (int)k, (int)n_pad,
                                                    SIM_FROM_KEYS, nullptr, nullptr, 0, k,
                                                    values, (int*)ids);
    }
  } else if (pair) {
    sim_radix_sort<true>(a, ra, k, int_bits, st, values, ids, s);
  } else {
    sim_radix_sort<false>(a, nullptr, k, 0, st, values, ids, s);
  }
  return (int)cudaGetLastError();
}
