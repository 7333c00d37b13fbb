// The tensor cores' binary product (sm_80 on; built for sm_90a), shared
// by K11 (pairwise.cu) and by the split-K core below, which K4's grouped
// mode (bsi_sum.cu) and K6's gb_counts (groupby.cu) run.
//
// mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc adds, for a
// 16 x 256-bit A tile (row-major) and a 256 x 8-bit B tile (column-major),
// popcount(A_i AND B_j) to c[i][j], exact in int32. Lane (g, t), with
// g = lane / 4 and t = lane % 4, holds of one 256-bit k-step (8 words):
//   A: a0 = row g word t, a1 = row g + 8 word t, a2 = row g word t + 4,
//      a3 = row g + 8 word t + 4;
//   B: b0 = column g word t, b1 = column g word t + 4;
//   C: c0, c1 = row g, columns 2t and 2t + 1; c2, c3 = row g + 8, the same.
// ldmatrix .m8n8.x4 .b16 reads four 8 x 16 B matrices, matrix i's eight
// rows from the addresses that lanes 8i .. 8i + 7 give, and hands lane
// (g, t) word t of row g of each: a row may lie anywhere in shared memory.
//
// The split-K core, bm_kernel: out[i, j] = sum over every bit of the
// planes of popcount(A_i & B_j), for a few A planes (GroupBy's masks) and
// a few B planes, each a whole [S, W] plane of up to ~10^9 bits: a binary
// product with a tiny output and a huge inner dimension.
//   K6 (PAIRS): A = the G masks, B = the rows the ids pick; out[g, k].
//   K4 (BSI): A = 2 rows per mask, P_g = m_g & e & ~s and N_g = m_g & e
//     & s (e, s the stack's existence and sign planes), formed in
//     registers from the mask words after ldmatrix (an m16 tile is an
//     octet of masks: P in rows 0-7, N in rows 8-15); B = the magnitude
//     planes mag_0 .. mag_{D-1} and one column of ones. Then pos[g, k] =
//     out[P_g, k], neg[g, k] = out[N_g, k], n[g] = out[P_g, D] + out[N_g,
//     D]. This orientation leaves B as raw planes (ldmatrix straight from
//     the ring) and needs 4 ANDs a mask octet a k-step; the other one
//     (masks against 2D + 1 derived columns) would derive a column per
//     magnitude plane for the same count of MMAs.
// Bound on the H100: bytes, every plane of the pass read once (at the
// taxi shapes the product needs a fraction of the b1 rate: K11's inter
// mode runs ~10^15 bit-ANDs a second).
// Design: a warp-specialised persistent kernel, one block an SM, each
// owning a contiguous range of chunks of the planes. One producer warp
// streams every loaded plane's chunk into a position of a ring stage with
// 1-D bulk copies (bulk.cuh), one mbarrier pair a stage. A plane that
// reads as zero (a mask or column past the pass, a magnitude plane at or
// past P, a padding id) is never loaded: it and the ones column map to
// two positions after the loaded ones, filled once at the start. The
// chunk is the longest of 2048 .. 256 words that leaves BM_MIN_STAGES
// stages for the pass's loaded planes: on the card a longer copy raised
// the rate more than more stages did, 1 KB copies in 5-8 stages running
// well below the bound and 2-4 KB copies in 2-3 stages near it. Positions
// are the chunk and 16 B apart, so ldmatrix's eight rows (eight planes,
// one k-step) fall on distinct banks. Eight consumer warps split each
// stage's k-steps between them, ldmatrix the fragments and run the b1
// MMAs into int32 accumulators held in registers (4 x 3 tiles for K4,
// 2 x 8 for K6), then fence the async proxy and free the stage (a refill
// must not land before their reads, the race K1's ring met). Each k-step
// adds at most 256 to an accumulator, so a warp flushes them into the
// block's int64 sums in shared memory every BM_FLUSH_CHUNKS chunks and at
// the end; the block then adds one int64 atomic per non-zero output. The
// last chunk may end half-way through a k-step: the producer zeroes that
// k-step's last 16 B in each loaded position. A pass takes BM_A_PLANES
// masks and BM_BSI_COLS (K4) or BM_PAIR_COLS (K6) columns; more take
// further passes, each a launch that reads its planes again.
#pragma once

#include "bulk.cuh"

#define BM_CH_MIN 256   // words of a plane per ring chunk at least: 32 k-steps of 256 bits
#define BM_CH_MAX 2048  // and at most
#define BM_MIN_STAGES 2  // stages the chunk leaves, where a chunk longer than BM_CH_MIN does
#define BM_CONSUMER_WARPS 8
#define BM_THREADS 288       // the consumer warps and one producer warp
#define BM_A_PLANES 32       // masks per pass
#define BM_BSI_COLS 24       // K4: columns per pass (three n8 tiles)
#define BM_PAIR_COLS 64      // K6: ids per pass (eight n8 tiles)
#define BM_MAX_SLOTS 96      // BM_A_PLANES + BM_PAIR_COLS: the planes of a pass
#define BM_OUT 2048          // BM_A_PLANES * BM_PAIR_COLS int64 sums a block
#define BM_MAX_STAGES 8
#define BM_SMEM_BYTES 229376  // a block's dynamic shared memory
#define BM_HEAD_BYTES 18176   // BmShared, rounded up to 128 B
#define BM_RING_BYTES (BM_SMEM_BYTES - BM_HEAD_BYTES)
#define BM_FLUSH_CHUNKS 131072  // chunks between two flushes of the int32 accumulators

static_assert(BM_THREADS == 32 * (BM_CONSUMER_WARPS + 1), "one producer warp");
static_assert(BM_MAX_SLOTS == BM_A_PLANES + BM_PAIR_COLS && BM_MAX_SLOTS >= BM_A_PLANES + 2 + BM_BSI_COLS,
              "the planes of the largest pass");
static_assert(BM_OUT == BM_A_PLANES * BM_PAIR_COLS && BM_OUT >= BM_A_PLANES * 2 * BM_BSI_COLS,
              "the sums of the largest pass");
// a position is a chunk and 16 B: 4 * BM_CH_MIN % 128 == 0, so eight
// consecutive positions start on distinct 16 B bank groups
static_assert((4 * BM_CH_MIN) % 128 == 0, "positions skew by 16 B");
static_assert(BM_RING_BYTES / ((BM_MAX_SLOTS + 2) * (4 * BM_CH_MIN + 16)) >= 2,
              "two stages of the largest pass fit");
static_assert(BM_SMEM_BYTES <= 232448, "a block's shared memory on the H100");
// every k-step adds at most 256 to an accumulator; a warp takes at most
// BM_CH_MAX / 8 / BM_CONSUMER_WARPS k-steps of a chunk
static_assert((long long)BM_FLUSH_CHUNKS * (BM_CH_MAX / 8 / BM_CONSUMER_WARPS) * 256 < (1ll << 31),
              "the int32 accumulators cannot pass 2^31 between flushes");

__device__ __forceinline__ void pt_ldmatrix4(unsigned addr, unsigned& r0, unsigned& r1,
                                             unsigned& r2, unsigned& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// c += popc(a AND b) over one m16n8k256 tile: a row-major 16 x 256 bits,
// b column-major 256 x 8 bits.
__device__ __forceinline__ void pt_bmma(int* c, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__host__ __device__ constexpr int bm_round(int x, int m) { return (x + m - 1) / m * m; }

// One pass of the core: n_a masks from a0 against n_b columns from b0.
struct BmArgs {
  const uint4* a;            // the pass's first mask; mask i at a + i * n_vec
  const uint4* b;            // K4: the BSI stack [P, S, W]; K6: the rows [R, S, W]
  const int* ids;            // K6: the pass's first row id; K4: null
  unsigned long long* out0;  // K4: pos[G, D]; K6: out[G, K]
  unsigned long long* out1;  // K4: neg[G, D]
  unsigned long long* out2;  // K4: n[G]
  long long n_vec;           // 16 B vectors of a plane
  int n_a, n_b;              // masks and columns of the pass
  int a0, b0;                // the pass's first mask and first column
  int n_groups, n_cols;      // G; K4: D, K6: K
  int b_limit;               // K4: P (a plane at or past it reads zero); K6: R
};

// The head of the dynamic shared memory; the ring follows it.
struct BmShared {
  unsigned long long out[BM_OUT];  // the block's sums
  unsigned long long full[BM_MAX_STAGES];
  unsigned long long empty[BM_MAX_STAGES];
  const uint4* src[BM_MAX_SLOTS];  // plane q's source; null: it reads zero
  int pos[BM_MAX_SLOTS];           // plane q's position in a stage
  int live[BM_MAX_SLOTS];          // the loaded planes, in position order
  int n_live;
};
static_assert(sizeof(BmShared) <= BM_HEAD_BYTES && BM_HEAD_BYTES % 128 == 0, "the ring starts 128 B aligned");

// The chunk (words) and stages for n_live loaded planes and the zero and
// ones positions: the longest chunk that leaves BM_MIN_STAGES stages, else
// the shortest, with as many stages as fit (two at least: the assert above).
__host__ __device__ inline int bm_chunk(int n_live, int* stages) {
  const int n_pos = n_live + 2;
  int ch = BM_CH_MAX;
  for (;; ch /= 2) {
    const int st = BM_RING_BYTES / (n_pos * (4 * ch + 16));
    if (st >= BM_MIN_STAGES || ch == BM_CH_MIN) {
      *stages = st < BM_MAX_STAGES ? st : BM_MAX_STAGES;
      return ch;
    }
  }
}

// A lane's ldmatrix offsets in a stage, and (K4) its e and s words.
struct BmLane {
  unsigned a_off[2];
  unsigned b_off[4];
  unsigned e_off, s_off;
};

// The planes of a pass, q in order: the masks (rounded up to an A tile),
// then (K4) e and s, then the columns (rounded up to an n8 tile).
template <bool BSI>
__device__ __forceinline__ const uint4* bm_plane(const BmArgs& p, int q, int a_pad, int b_base) {
  if (q < a_pad) return q < p.n_a ? p.a + (long long)q * p.n_vec : nullptr;
  if (BSI && q < b_base) {
    const int plane = q - a_pad;  // existence, then sign
    return plane < p.b_limit ? p.b + (long long)plane * p.n_vec : nullptr;
  }
  const int c = q - b_base;
  if (c >= p.n_b) return nullptr;
  if (BSI) {
    const int k = p.b0 + c;  // magnitude bit k is stack plane 2 + k; k == D is the ones
    return k < p.n_cols && 2 + k < p.b_limit ? p.b + (long long)(2 + k) * p.n_vec : nullptr;
  }
  const int r = p.ids[c];
  return r >= 0 && r < p.b_limit ? p.b + (long long)r * p.n_vec : nullptr;
}

// One 256-bit k-step of a stage: B's fragments, A's (K4: derived from a
// mask octet and e, s), then the MMAs of the pass's live tiles.
template <bool BSI, int MT, int NT>
__device__ __forceinline__ void bm_step(const unsigned char* stage, unsigned saddr, int ks,
                                        const BmLane& L, int mt, int nt, int (&acc)[MT][NT][4]) {
  constexpr int NP = (NT + 1) / 2;
  const unsigned k_addr = saddr + (unsigned)ks * 32u;
  unsigned fb[2 * NP][2];
#pragma unroll
  for (int jp = 0; jp < NP; ++jp) {
    if (2 * jp < nt) {
      pt_ldmatrix4(k_addr + L.b_off[jp], fb[2 * jp][0], fb[2 * jp][1], fb[2 * jp + 1][0], fb[2 * jp + 1][1]);
    } else {
      fb[2 * jp][0] = fb[2 * jp][1] = fb[2 * jp + 1][0] = fb[2 * jp + 1][1] = 0u;
    }
  }
  if constexpr (BSI) {
    const unsigned char* kw = stage + ks * 32;
    const unsigned e0 = *reinterpret_cast<const unsigned*>(kw + L.e_off);
    const unsigned e1 = *reinterpret_cast<const unsigned*>(kw + L.e_off + 16);
    const unsigned s0 = *reinterpret_cast<const unsigned*>(kw + L.s_off);
    const unsigned s1 = *reinterpret_cast<const unsigned*>(kw + L.s_off + 16);
    const unsigned pe0 = e0 & ~s0, ne0 = e0 & s0, pe1 = e1 & ~s1, ne1 = e1 & s1;
#pragma unroll
    for (int op = 0; op < MT / 2; ++op) {
      if (2 * op < mt) {
        // words t and t + 4 of mask 8o + g, for octets o = 2op, 2op + 1
        unsigned m[4];
        pt_ldmatrix4(k_addr + L.a_off[op], m[0], m[1], m[2], m[3]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int o = 2 * op + h;
          if (o < mt) {
            const unsigned a[4] = {m[2 * h] & pe0, m[2 * h] & ne0, m[2 * h + 1] & pe1, m[2 * h + 1] & ne1};
#pragma unroll
            for (int j = 0; j < NT; ++j) {
              if (j < nt) pt_bmma(acc[o][j], a, fb[j]);
            }
          }
        }
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (i < mt) {
        unsigned a[4];
        pt_ldmatrix4(k_addr + L.a_off[i], a[0], a[1], a[2], a[3]);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (j < nt) pt_bmma(acc[i][j], a, fb[j]);
        }
      }
    }
  }
}

// The accumulators into the block's int64 sums, then zero. K4's sum
// (mask, P or N, column) sits at (2 mask + N) * BM_BSI_COLS + column,
// K6's (mask, column) at mask * BM_PAIR_COLS + column.
template <bool BSI, int MT, int NT>
__device__ __forceinline__ void bm_flush(BmShared& sh, int mt, int nt, int (&acc)[MT][NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (i < mt && j < nt && acc[i][j][e] != 0) {
          const int col = 8 * j + 2 * t + (e & 1);
          const int idx = BSI ? ((8 * i + g) * 2 + (e >> 1)) * BM_BSI_COLS + col
                              : (16 * i + g + 8 * (e >> 1)) * BM_PAIR_COLS + col;
          atomicAdd(&sh.out[idx], (unsigned long long)(unsigned)acc[i][j][e]);
        }
        acc[i][j][e] = 0;
      }
    }
  }
}

template <bool BSI>
__device__ __forceinline__ void bm_store(const BmArgs& p, int idx, unsigned long long v) {
  if (BSI) {
    const int mask = p.a0 + idx / (2 * BM_BSI_COLS);
    const bool neg = (idx / BM_BSI_COLS) & 1;
    const int col = p.b0 + idx % BM_BSI_COLS;
    if (mask >= p.n_groups) return;
    if (col < p.n_cols) {
      atomicAdd((neg ? p.out1 : p.out0) + (long long)mask * p.n_cols + col, v);
    } else if (col == p.n_cols) {
      atomicAdd(p.out2 + mask, v);  // P_g's and N_g's counts of ones
    }
  } else {
    const int mask = p.a0 + idx / BM_PAIR_COLS;
    const int col = p.b0 + idx % BM_PAIR_COLS;
    if (mask < p.n_groups && col < p.n_cols) atomicAdd(p.out0 + (long long)mask * p.n_cols + col, v);
  }
}

template <bool BSI>
__global__ void __launch_bounds__(BM_THREADS, 1) bm_kernel(const __grid_constant__ BmArgs p) {
  constexpr int MT = BSI ? BM_A_PLANES / 8 : BM_A_PLANES / 16;  // A tiles: mask octets or m16 tiles
  constexpr int NT = (BSI ? BM_BSI_COLS : BM_PAIR_COLS) / 8;
  extern __shared__ __align__(128) unsigned char bm_smem[];
  BmShared& sh = *reinterpret_cast<BmShared*>(bm_smem);
  unsigned char* ring = bm_smem + BM_HEAD_BYTES;
  const int tid = threadIdx.x;
  const int a_pad = bm_round(p.n_a, BSI ? 8 : 16);
  const int b_base = a_pad + (BSI ? 2 : 0);
  const int n_planes = b_base + bm_round(p.n_b, 8);
  const int ones = BSI && p.n_cols - p.b0 < p.n_b ? b_base + p.n_cols - p.b0 : -1;
  for (int q = tid; q < n_planes; q += BM_THREADS) sh.src[q] = bm_plane<BSI>(p, q, a_pad, b_base);
  for (int c = tid; c < BM_OUT; c += BM_THREADS) sh.out[c] = 0ull;
  if (tid == 0) {
    for (int s = 0; s < BM_MAX_STAGES; ++s) {
      pt_mbar_init(&sh.full[s], 1);
      pt_mbar_init(&sh.empty[s], BM_CONSUMER_WARPS);
    }
    pt_mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    // the loaded planes first, then one position of zeros and one of ones
    int n = 0;
    for (int q = 0; q < n_planes; ++q) {
      if (sh.src[q] != nullptr) {
        sh.live[n] = q;
        sh.pos[q] = n++;
      }
    }
    for (int q = 0; q < n_planes; ++q) {
      if (sh.src[q] == nullptr) sh.pos[q] = q == ones ? n + 1 : n;
    }
    sh.n_live = n;
  }
  __syncthreads();
  const int n_live = sh.n_live;
  int stages;
  const int ch = bm_chunk(n_live, &stages);
  const int ld = 4 * ch + 16;  // a position's bytes
  const int stage_bytes = (n_live + 2) * ld;
  // the zero and ones positions of every stage
  const int pos_vecs = ld / 16;
  for (int v = tid; v < stages * 2 * pos_vecs; v += BM_THREADS) {
    const int st = v / (2 * pos_vecs), which = (v / pos_vecs) & 1;
    reinterpret_cast<uint4*>(ring + (size_t)st * stage_bytes + (n_live + which) * ld)[v % pos_vecs] =
        which ? pt_ones4() : pt_zero4();
  }
  __syncthreads();

  const long long n_words = p.n_vec * 4;
  const long long n_chunks = (n_words + ch - 1) / ch;
  const long long per = n_chunks / gridDim.x, rem = n_chunks % gridDim.x;
  const long long first = blockIdx.x * per + ((long long)blockIdx.x < rem ? blockIdx.x : rem);
  const long long last = first + per + ((long long)blockIdx.x < rem ? 1 : 0);
  const int warp = tid >> 5, lane = tid & 31;

  if (warp == BM_CONSUMER_WARPS) {
    // ------------------------------------------------------- producer
    long long j = 0;
    for (long long c = first; c < last; ++c, ++j) {
      const int st = (int)(j % stages);
      pt_mbar_wait(&sh.empty[st], (unsigned)((j / stages) & 1) ^ 1u);
      const long long w0 = c * ch;
      const int valid = (int)(n_words - w0 < ch ? n_words - w0 : ch);
      unsigned char* stage = ring + (size_t)st * stage_bytes;
      if (lane == 0) {
        if (valid % 8) {
          // the plane ends half-way through a k-step: zeros after it
          for (int i = 0; i < n_live; ++i) {
            *reinterpret_cast<uint4*>(stage + i * ld + valid * 4) = pt_zero4();
          }
        }
        pt_mbar_expect_tx(&sh.full[st], (unsigned)(valid * 4 * n_live));
      }
      __syncwarp();
      for (int i = lane; i < n_live; i += 32) {
        pt_bulk_load(stage + i * ld, sh.src[sh.live[i]] + w0 / 4, (unsigned)(valid * 4), &sh.full[st]);
      }
    }
    return;
  }

  // ------------------------------------------------------- consumers
  const int mt = a_pad / (BSI ? 8 : 16);
  const int nt = bm_round(p.n_b, 8) / 8;
  const int r8 = lane & 7, hi = lane >> 4, mid = (lane >> 3) & 1, t = lane & 3;
  const int zero = n_live;
  auto off = [&sh, n_planes, zero, ld](int q, int word) {
    return (unsigned)((q < n_planes ? sh.pos[q] : zero) * ld + word * 4);
  };
  BmLane L;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    // K4: octets 2i, 2i + 1, words 0-3 / 4-7; K6: m16 tile i, rows 0-7 / 8-15
    L.a_off[i] = BSI ? off(16 * i + r8 + 8 * hi, 4 * mid) : off(16 * i + r8 + 8 * mid, 4 * hi);
  }
#pragma unroll
  for (int jp = 0; jp < 4; ++jp) L.b_off[jp] = off(b_base + 16 * jp + r8 + 8 * hi, 4 * mid);
  L.e_off = off(a_pad, t);
  L.s_off = off(a_pad + 1, t);
  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
    }
  }
  const unsigned ring_addr = pt_smem(ring);
  int since = 0;
  long long j = 0;
  for (long long c = first; c < last; ++c, ++j) {
    const int st = (int)(j % stages);
    pt_mbar_wait(&sh.full[st], (unsigned)((j / stages) & 1));
    const long long w0 = c * ch;
    const int valid = (int)(n_words - w0 < ch ? n_words - w0 : ch);
    const unsigned char* stage = ring + (size_t)st * stage_bytes;
    const unsigned saddr = ring_addr + (unsigned)(st * stage_bytes);
    const int n_ks = (valid + 7) / 8;
#pragma unroll 4
    for (int ks = warp; ks < n_ks; ks += BM_CONSUMER_WARPS) {
      bm_step<BSI, MT, NT>(stage, saddr, ks, L, mt, nt, acc);
    }
    // these generic-proxy reads come before the bulk copy that refills the
    // stage (async proxy): without the fence that copy may land first
    pt_fence_async_smem();
    __syncwarp();
    if (lane == 0) pt_mbar_arrive(&sh.empty[st]);
    if (++since == BM_FLUSH_CHUNKS) {
      bm_flush<BSI, MT, NT>(sh, mt, nt, acc);
      since = 0;
    }
  }
  bm_flush<BSI, MT, NT>(sh, mt, nt, acc);
  // the consumers only: the producer warp has left
  asm volatile("bar.sync 1, %0;" ::"n"(BM_CONSUMER_WARPS * 32) : "memory");
  for (int idx = tid; idx < BM_OUT; idx += BM_CONSUMER_WARPS * 32) {
    const unsigned long long v = sh.out[idx];
    if (v != 0ull) bm_store<BSI>(p, idx, v);
  }
}

// One pass on the persistent grid: one block an SM (fewer for a small
// plane), each with the whole of BM_SMEM_BYTES; the kernel sizes its
// ring from the planes it loads. Returns cudaGetLastError(), or a CUDA
// error of the set-up.
template <bool BSI>
static int bm_launch(const BmArgs& a, cudaStream_t stream) {
  const int cap = pt_persistent_blocks(bm_kernel<BSI>, BM_THREADS, BM_SMEM_BYTES);
  if (cap <= 0) return -cap;
  const long long n_chunks = (a.n_vec * 4 + BM_CH_MIN - 1) / BM_CH_MIN;
  const int grid = (int)(n_chunks < cap ? n_chunks : cap);
  bm_kernel<BSI><<<grid, BM_THREADS, BM_SMEM_BYTES, stream>>>(a);
  return (int)cudaGetLastError();
}
