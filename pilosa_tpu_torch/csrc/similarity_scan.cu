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
// K10 is a radix select over the keys' six digits (12, 12, 12, 12, 12
// and 4 bits, most significant first: all 64). K9's histogram gives the
// first digit; each later level is a histogram pass over the keys that
// match the prefix chosen so far, and a one-block pick that finds the bin
// holding the k-th largest key. It stops once a chosen bin is taken
// whole, and then exactly k keys are >= the prefix. In the int mode, ties
// at the k-th count go on through the digits of the row order, 2^b - 1 -
// row for b row bits (12 at a time), among the keys equal to that count:
// (count, row) pairs are distinct, so the select always ends, with exactly
// k pairs at or above the (key, row-order) prefix. A ballot compaction
// gathers them (with their rows in the int mode), a bitonic sort orders
// them (in one block's shared memory up to 4,096, above that with merge
// steps in device memory), and the first k are decoded. Any k from 1 to
// R. Its bound is reading the keys once; each level reads them again, and
// its small launches cost more than the bytes.
#include "common.cuh"

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
};

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
// and each key's row beside it.
__global__ void __launch_bounds__(PT_BLOCK)
    sim_compact_kernel(const u64* __restrict__ keys, long long n, u64 k,
                       u64 low, SimState* st, u64* __restrict__ out,
                       unsigned* __restrict__ out_rows) {
  const u64 lo = st->prefix, lo_rows = st->prefix_lo;
  const int lane = threadIdx.x & 31;
  for (long long base = (long long)blockIdx.x * PT_BLOCK; base < n;
       base += (long long)gridDim.x * PT_BLOCK) {
    const long long i = base + threadIdx.x;
    const u64 key = i < n ? keys[i] : 0ull;
    const bool take = i < n && (key > lo || (key == lo && (out_rows == nullptr ||
                                                          low - (u64)i >= lo_rows)));
    const unsigned ballot = __ballot_sync(0xffffffffu, take);
    if (!ballot) continue;
    u64 pos = 0;
    if (lane == __ffs(ballot) - 1) pos = atomicAdd(&st->count, (u64)__popc(ballot));
    pos = __shfl_sync(0xffffffffu, pos, __ffs(ballot) - 1);
    pos += __popc(ballot & ((1u << lane) - 1u));
    if (take && pos < k) {
      out[pos] = key;
      if (out_rows != nullptr) out_rows[pos] = (unsigned)i;
    }
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

// One tile of the bitonic sort in shared memory: merge sizes size_lo to
// size_hi, each from stride min(size, tile) / 2 down to 1. With PAIR the
// rows move with their keys (48 KB of shared memory at SIM_TILE).
template <bool PAIR>
__global__ void __launch_bounds__(SIM_SORT_THREADS)
    sim_sort_tile_kernel(u64* __restrict__ a, unsigned* __restrict__ ra,
                         long long n, long long size_lo, long long size_hi) {
  __shared__ u64 s[SIM_TILE];
  __shared__ unsigned sr[PAIR ? SIM_TILE : 1];
  const long long tile = n < SIM_TILE ? n : SIM_TILE;
  const long long base = (long long)blockIdx.x * tile;
  for (long long i = threadIdx.x; i < tile; i += SIM_SORT_THREADS) {
    s[i] = a[base + i];
    if (PAIR) sr[i] = ra[base + i];
  }
  __syncthreads();
  for (long long size = size_lo; size <= size_hi; size <<= 1) {
    for (long long stride = (size < tile ? size : tile) >> 1; stride > 0; stride >>= 1) {
      for (long long p = threadIdx.x; p < tile / 2; p += SIM_SORT_THREADS) {
        const long long lo = ((p & ~(stride - 1)) << 1) | (p & (stride - 1));
        sim_cmpx<PAIR>(s, sr, lo, lo + stride, ((base + lo) & size) == 0);
      }
      __syncthreads();
    }
  }
  for (long long i = threadIdx.x; i < tile; i += SIM_SORT_THREADS) {
    a[base + i] = s[i];
    if (PAIR) ra[base + i] = sr[i];
  }
}

// One merge step of the bitonic sort in device memory, stride >= a tile.
template <bool PAIR>
__global__ void __launch_bounds__(PT_BLOCK)
    sim_sort_step_kernel(u64* __restrict__ a, unsigned* __restrict__ ra,
                         long long n, long long size, long long stride) {
  for (long long p = (long long)blockIdx.x * PT_BLOCK + threadIdx.x; p < n / 2;
       p += (long long)gridDim.x * PT_BLOCK) {
    const long long lo = ((p & ~(stride - 1)) << 1) | (p & (stride - 1));
    sim_cmpx<PAIR>(a, ra, lo, lo + stride, (lo & size) == 0);
  }
}

// Decode the first k sorted keys. Score keys (no rows): the f32 score
// from the high half, the row from the low. Count keys
// (csrc/mesh_finish.cu's count_keys): the int64 count key ^ 2^63, the row
// from `rows`.
__global__ void __launch_bounds__(PT_BLOCK)
    sim_emit_kernel(const u64* __restrict__ sorted,
                    const unsigned* __restrict__ rows, long long k,
                    void* __restrict__ values, int* __restrict__ ids) {
  for (long long i = (long long)blockIdx.x * PT_BLOCK + threadIdx.x; i < k;
       i += (long long)gridDim.x * PT_BLOCK) {
    const u64 key = sorted[i];
    if (rows != nullptr) {
      ((long long*)values)[i] = (long long)(key ^ (1ull << 63));
      ids[i] = (int)rows[i];
    } else {
      ((float*)values)[i] = __uint_as_float((unsigned)(key >> 32));
      ids[i] = (int)(0xffffffffu - (unsigned)key);
    }
  }
}

template <bool PAIR>
static void sim_sort(u64* a, unsigned* ra, long long n_sort, cudaStream_t s) {
  if (n_sort < 2) return;
  const long long tile = n_sort < SIM_TILE ? n_sort : SIM_TILE;
  const unsigned tiles = (unsigned)(n_sort / tile);
  sim_sort_tile_kernel<PAIR><<<tiles, SIM_SORT_THREADS, 0, s>>>(a, ra, n_sort, 2, tile);
  const unsigned step_grid = sim_grid(n_sort / 2, PT_BLOCK);
  for (long long size = tile * 2; size <= n_sort; size <<= 1) {
    for (long long stride = size / 2; stride >= tile; stride >>= 1) {
      sim_sort_step_kernel<PAIR><<<step_grid, PT_BLOCK, 0, s>>>(a, ra, n_sort, size, stride);
    }
    sim_sort_tile_kernel<PAIR><<<tiles, SIM_SORT_THREADS, 0, s>>>(a, ra, n_sort, size, size);
  }
}

// keys: int64[n] from sim_scan (or count_keys) and hist0 its histogram;
// hists: zeroed int32[5 + 3, 4096]; state: zeroed int64[8]; work: zeroed
// int64[n_sort], n_sort the power of two >= k; int_bits: 0 for score
// keys, then values is f32[k] and work_rows null, or the row bits b of
// count keys (n <= 2^b), then values is int64[k] and work_rows an
// int32[n_sort] of -1; ids: int32[k]. Returns cudaGetLastError().
PT_EXPORT int sim_select(const void* keys, long long n, const void* hist0,
                         void* hists, void* state, long long k, void* work,
                         void* work_rows, long long n_sort, int int_bits,
                         void* values, void* ids, void* stream) {
  if (n < 1 || n > 0x7fffffffLL || k < 1 || k > n || n_sort < k ||
      (n_sort & (n_sort - 1)) || int_bits < 0 || int_bits > 31 ||
      (int_bits > 0) != (work_rows != nullptr) ||
      (int_bits > 0 && n > (1ll << int_bits))) {
    return (int)cudaErrorInvalidValue;
  }
  static const int shifts[SIM_LEVELS] = {SIM_FIRST_SHIFT, 40, 28, 16, 4, 0};
  static const int bits[SIM_LEVELS] = {SIM_BITS, SIM_BITS, SIM_BITS, SIM_BITS, SIM_BITS, 4};
  cudaStream_t s = (cudaStream_t)stream;
  const u64* kk = (const u64*)keys;
  SimState* st = (SimState*)state;
  const unsigned grid = sim_grid(n, PT_BLOCK);
  const u64 low = int_bits > 0 ? (1ull << int_bits) - 1ull : 0ull;
  unsigned* h = (unsigned*)hists;
  sim_pick_kernel<<<1, SIM_SORT_THREADS, 0, s>>>((const unsigned*)hist0, shifts[0],
                                                 bits[0], 0, 1, (u64)k, st);
  for (int level = 1; level < SIM_LEVELS; ++level, h += SIM_BINS) {
    sim_hist_kernel<<<grid, PT_BLOCK, 0, s>>>(kk, n, shifts[level],
                                              (1u << bits[level]) - 1u, 0, low, st, h);
    sim_pick_kernel<<<1, SIM_SORT_THREADS, 0, s>>>(h, shifts[level], bits[level],
                                                   0, 0, (u64)k, st);
  }
  // the int mode's ties: the row order's digits, 12 at a time from the top
  for (int top = int_bits; top > 0; h += SIM_BINS) {
    const int w = top < SIM_BITS ? top : SIM_BITS;
    top -= w;
    sim_hist_kernel<<<grid, PT_BLOCK, 0, s>>>(kk, n, top, (1u << w) - 1u, 1, low, st, h);
    sim_pick_kernel<<<1, SIM_SORT_THREADS, 0, s>>>(h, top, w, 1, 0, (u64)k, st);
  }
  u64* a = (u64*)work;
  unsigned* ra = (unsigned*)work_rows;
  sim_compact_kernel<<<grid, PT_BLOCK, 0, s>>>(kk, n, (u64)k, low, st, a, ra);
  if (ra != nullptr) {
    sim_sort<true>(a, ra, n_sort, s);
  } else {
    sim_sort<false>(a, nullptr, n_sort, s);
  }
  sim_emit_kernel<<<sim_grid(k, PT_BLOCK), PT_BLOCK, 0, s>>>(a, ra, k, values, (int*)ids);
  return (int)cudaGetLastError();
}
