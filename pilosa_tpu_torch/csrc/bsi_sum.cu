// K4: the BSI Sum counts, plain and grouped.
//
// Replaces the Sum programs of pilosa_tpu: ops.bsi.sum_counts
// (pilosa_tpu/ops/bsi.py:113) vmapped over the shards by the executor's
// _sum_fn (pilosa_tpu/executor/executor.py:1073), and its group-vmapped
// form _grouped_sum_program (:1088) that GroupBy's aggregate=Sum runs.
//
// For each mask g (a filter or a group's columns; none means one mask of
// all ones) and each magnitude plane k of a row-major BSI stack
// [P, S, W] (plane 0 existence, 1 sign, 2 + k magnitude bit k):
//   pos[g, k] = popcount(mag_k & exists & ~sign & mask_g)
//   neg[g, k] = popcount(mag_k & exists &  sign & mask_g)
//   n[g]      = popcount(exists & mask_g)
// all summed over the shards into int64 (a per-bit count passes 2^31 at
// 2,048 shards). The exact sum, sum_k 2^k (pos - neg), is taken on the
// host (weigh_sum). A plane at or past P reads as zero.
//
// Bound on the H100: bytes, the 2 + D stack planes and the G masks read
// once.
// One mask (Sum, and the filtered Sum): each thread holds its 16 B vector
// of up to 24 magnitude planes (and exists, sign) in registers and ANDs
// them with its mask vector; every plane's count is reduced across the
// warp at once (REDUX) into per-warp shared counters, and each block adds
// one 64-bit atomic per counter at the end. The work is 2 D + 1
// popcounts a word: three words of a vector go through a carry-save adder first
// (popc(a) + popc(b) + popc(c) = popc(a ^ b ^ c) + 2 popc(maj(a, b, c))),
// which saves a quarter of them. On the card it ran faster than a
// variant keeping per-thread counters over many vectors.
// Grouped mode (G >= BS_MMA_MIN_GROUPS masks, GroupBy's aggregate=Sum):
// on the CUDA cores the same design costs 2 G D ANDs and popcounts a
// word, bound by arithmetic (10.1 ms for 16 masks at the taxi shape
// against 1.5 ms of bytes). There the counts are a binary product, masks
// against the magnitude planes, with a huge inner dimension: the split-K
// core of bmma.cuh on the tensor cores, each mask's P_g = m_g & e & ~s
// and N_g = m_g & e & s formed in registers, the magnitude planes and a
// column of ones as B. A pass takes BM_A_PLANES masks and BM_BSI_COLS
// columns (D + 1 of them): at G <= 32 and D <= 23 one pass reads every
// plane and mask once; more masks, or a deeper field, take further
// passes, ceil(G / 32) * ceil((D + 1) / 24) in all.
//
// bsi_sum_tree: one mask that is a call tree (tree_interp.cuh), the
// filtered Sum's filter, evaluated in the kernel where the reference
// evaluates it inside the Sum's program (executor.py:1019 _filter_plan,
// :1107-1132): the [S, W] filter is never written to device memory, and
// the bound counts the tree's leaf and condition planes in place of the
// mask. Each thread issues the 2 + D plane loads of its vector, then
// evaluates the filter, so the interpreter's leaf loads (each waited for
// through its local-memory stack) overlap the planes' instead of coming
// before them; at one 256-thread block per SM (the planes take ~180
// registers) little else hides their latency. Grouped mode has no tree:
// GroupBy's masks are built planes, as the reference's are
// (executor.py:1606-1616).
#include "bmma.cuh"
#include "tree_interp.cuh"

#define BS_MMA_MIN_GROUPS 2  // masks from which bsi_sum runs the tensor-core product

#define BS_KCH 24  // magnitude planes held in registers per pass
#define BS_NC (2 * BS_KCH + 1)

// popcount of a 16 B vector with three of its words through a full adder
__device__ __forceinline__ unsigned bs_popc4(uint4 v) {
  const unsigned s = v.x ^ v.y ^ v.z;
  const unsigned c = (v.x & v.y) | (v.z & (v.x ^ v.y));
  return __popc(s) + __popc(v.w) + 2u * __popc(c);
}

// One pass over planes k0.. under one mask: with TREE the program `filt`;
// without, the plane `mask`, or all ones where it is null.
template <bool TREE>
__device__ __forceinline__ void bs_pass(const TreeArgs* filt,
                                        const uint4* __restrict__ stack,
                                        long long n_vec, int present,
                                        int depth,
                                        const uint4* __restrict__ mask, int k0,
                                        unsigned long long* __restrict__ pos_out,
                                        unsigned long long* __restrict__ neg_out,
                                        unsigned long long* __restrict__ n_out) {
  __shared__ unsigned s_cnt[PT_BLOCK / 32][BS_NC];
  const int kn = depth - k0 < BS_KCH ? depth - k0 : BS_KCH;
  for (int c = threadIdx.x; c < (PT_BLOCK / 32) * BS_NC; c += PT_BLOCK) {
    (&s_cnt[0][0])[c] = 0u;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long step = (long long)gridDim.x * PT_BLOCK;
  // warp-uniform trip count: every lane takes part in each REDUX
  for (long long b = (long long)blockIdx.x * PT_BLOCK + warp * 32; b < n_vec; b += step) {
    const long long i = b + lane;
    const bool ok = i < n_vec;
    const uint4 ex = ok ? pt_plane(stack, n_vec, present, 0, i) : pt_zero4();
    const uint4 sg = ok ? pt_plane(stack, n_vec, present, 1, i) : pt_zero4();
    uint4 mag[BS_KCH];
#pragma unroll
    for (int j = 0; j < BS_KCH; ++j) {
      mag[j] = ok && j < kn ? pt_plane(stack, n_vec, present, 2 + k0 + j, i) : pt_zero4();
    }
    // the filter after the planes' loads are issued, so its leaf loads
    // wait with theirs rather than before them
    const uint4 f = TREE && ok ? te_eval(*filt, i) : pt_ones4();
    const uint4 m = !ok ? pt_zero4() : TREE ? f : mask != nullptr ? mask[i] : pt_ones4();
    const uint4 e = pt_and4(ex, m);
    const uint4 p = pt_andn4(e, sg);
    const uint4 q = pt_and4(e, sg);
    unsigned* cnt = s_cnt[warp];
#pragma unroll
    for (int j = 0; j < BS_KCH; ++j) {
      if (j < kn) {
        const unsigned a = __reduce_add_sync(0xffffffffu, bs_popc4(pt_and4(mag[j], p)));
        const unsigned z = __reduce_add_sync(0xffffffffu, bs_popc4(pt_and4(mag[j], q)));
        if (lane == 0) {
          cnt[2 * j] += a;
          cnt[2 * j + 1] += z;
        }
      }
    }
    if (k0 == 0) {
      const unsigned c = __reduce_add_sync(0xffffffffu, bs_popc4(e));
      if (lane == 0) cnt[2 * BS_KCH] += c;
    }
  }
  __syncthreads();
  for (int r = threadIdx.x; r < BS_NC; r += PT_BLOCK) {
    if (r >= 2 * kn && r != 2 * BS_KCH) continue;
    if (r == 2 * BS_KCH && k0 != 0) continue;
    unsigned long long t = 0;
#pragma unroll
    for (int w = 0; w < PT_BLOCK / 32; ++w) t += s_cnt[w][r];
    if (t == 0) continue;
    if (r == 2 * BS_KCH) {
      atomicAdd(n_out, t);
    } else {
      const int o = k0 + r / 2;
      atomicAdd((r & 1) ? &neg_out[o] : &pos_out[o], t);
    }
  }
}

__global__ void __launch_bounds__(PT_BLOCK)
    bsi_sum_kernel(const uint4* __restrict__ stack, long long n_vec,
                   int present, int depth, const uint4* __restrict__ mask,
                   int k0, unsigned long long* __restrict__ pos_out,
                   unsigned long long* __restrict__ neg_out,
                   unsigned long long* __restrict__ n_out) {
  bs_pass<false>(nullptr, stack, n_vec, present, depth, mask, k0, pos_out,
                 neg_out, n_out);
}

__global__ void __launch_bounds__(PT_BLOCK)
    bsi_sum_tree_kernel(const __grid_constant__ TreeArgs filt,
                        const uint4* __restrict__ stack, long long n_vec,
                        int present, int depth, int k0,
                        unsigned long long* __restrict__ pos_out,
                        unsigned long long* __restrict__ neg_out,
                        unsigned long long* __restrict__ n_out) {
  bs_pass<true>(&filt, stack, n_vec, present, depth, nullptr, k0, pos_out,
                neg_out, n_out);
}

static_assert(TE_PARAMS_FIT(8), "bsi_sum_tree's parameters pass 4 KB");

// The grid of one pass: resident blocks, fewer for a small stack; 0 where
// a warp's 32-bit shared counters could overflow (they hold at most
// 32 * 128 bits per vector step the warp takes).
static long long bs_grid(long long n_vec) {
  const long long most = (n_vec + PT_BLOCK - 1) / PT_BLOCK;
  const long long grid = pt_resident_blocks() < most ? pt_resident_blocks() : most;
  if ((n_vec + grid * PT_BLOCK - 1) / (grid * PT_BLOCK) > (1ll << 19)) return 0;
  return grid;
}

// Grouped mode: the passes of the split-K product, masks g0.. against
// columns c0.. (magnitude bits, then the ones that count n).
static int bs_grouped(const void* stack, long long n_vec, int present, int depth,
                      const void* masks, int n_groups, void* pos, void* neg, void* n,
                      cudaStream_t s) {
  if (!pt_aligned16(stack) || !pt_aligned16(masks)) return (int)cudaErrorMisalignedAddress;
  for (int g0 = 0; g0 < n_groups; g0 += BM_A_PLANES) {
    for (int c0 = 0; c0 <= depth; c0 += BM_BSI_COLS) {
      BmArgs a = {};
      a.a = (const uint4*)masks + (long long)g0 * n_vec;
      a.b = (const uint4*)stack;
      a.out0 = (unsigned long long*)pos;
      a.out1 = (unsigned long long*)neg;
      a.out2 = (unsigned long long*)n;
      a.n_vec = n_vec;
      a.n_a = n_groups - g0 < BM_A_PLANES ? n_groups - g0 : BM_A_PLANES;
      a.n_b = depth + 1 - c0 < BM_BSI_COLS ? depth + 1 - c0 : BM_BSI_COLS;
      a.a0 = g0;
      a.b0 = c0;
      a.n_groups = n_groups;
      a.n_cols = depth;
      a.b_limit = present;
      const int err = bm_launch<true>(a, s);
      if (err != 0) return err;
    }
  }
  return 0;
}

// stack: int32[present, S, W] with n_vec = S * W / 4; masks: int32[G, S, W]
// or null (then n_groups == 1 and the mask is all ones); pos, neg: zeroed
// int64[G, depth]; n: zeroed int64[G]. G >= BS_MMA_MIN_GROUPS masks run
// the tensor-core product, one mask bsi_sum_kernel. Returns
// cudaGetLastError().
PT_EXPORT int bsi_sum(const void* stack, long long n_vec, int present,
                      int depth, const void* masks, int n_groups, void* pos,
                      void* neg, void* n, void* stream) {
  if (stack == nullptr || n_vec <= 0 || present < 1 || depth < 0 ||
      depth > 63 || n_groups < 1 || (masks == nullptr && n_groups != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (n_groups >= BS_MMA_MIN_GROUPS) {
    return bs_grouped(stack, n_vec, present, depth, masks, n_groups, pos, neg, n, s);
  }
  const long long grid = bs_grid(n_vec);
  if (grid == 0) return (int)cudaErrorInvalidValue;
  int k0 = 0;
  do {
    bsi_sum_kernel<<<(unsigned)grid, PT_BLOCK, 0, s>>>(
        (const uint4*)stack, n_vec, present, depth, (const uint4*)masks, k0,
        (unsigned long long*)pos, (unsigned long long*)neg,
        (unsigned long long*)n);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
    k0 += BS_KCH;
  } while (k0 < depth);
  return 0;
}

// filt: the filter's program over [S, W] planes of n_vec = S * W / 4
// vectors; stack, present, depth as bsi_sum; pos, neg: zeroed int64[1,
// depth]; n: zeroed int64[1]. Returns cudaGetLastError().
PT_EXPORT int bsi_sum_tree(const TreeArgs* filt, const void* stack,
                           long long n_vec, int present, int depth, void* pos,
                           void* neg, void* n, void* stream) {
  if (stack == nullptr || n_vec <= 0 || present < 1 || depth < 0 ||
      depth > 63 || !tree_program_ok(filt, n_vec)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long grid = bs_grid(n_vec);
  if (grid == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int k0 = 0;
  do {
    bsi_sum_tree_kernel<<<(unsigned)grid, PT_BLOCK, 0, s>>>(
        *filt, (const uint4*)stack, n_vec, present, depth, k0,
        (unsigned long long*)pos, (unsigned long long*)neg,
        (unsigned long long*)n);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
    k0 += BS_KCH;
  } while (k0 < depth);
  return 0;
}
