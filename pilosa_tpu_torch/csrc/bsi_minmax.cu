// K5: the BSI Min and Max, one extreme per shard.
//
// Replaces ops.bsi.min_max (pilosa_tpu/ops/bsi.py:152), which the
// executor vmaps over the shards (pilosa_tpu/executor/executor.py:1194):
// for each shard, the largest (or smallest) stored value among the
// existing columns under the filter, and how many columns hold it. The
// host merges the per-shard pairs (executor.py:1217-1227).
//
// The reference is branch-free: it walks both the positive and the
// negative candidates MSB->LSB and then selects one walk with
// has_pos / has_neg (bsi.py:183-194). This kernel decides first and walks
// only the selected set, which gives the same value and count: for Max,
// the positive walk preferring set bits if the shard has a positive
// value, else the negative walk preferring clear bits (value negated);
// for Min, the negative walk preferring set bits if it has a negative
// value, else the positive walk preferring clear bits. Where the
// preferred sign is absent, the other set is simply exists & filter.
// A shard with no value gives count 0 and the value the reference's walk
// gives (all D bits set: -(2^D - 1) for Max, 2^D - 1 for Min).
//
// Bound on the H100: bytes, the 2 + D planes (and the filter) read once.
// Design: one block of 1,024 threads per shard. The shard's W = 32,768
// words are 8,192 vectors, 8 per thread, and its candidate set lives in
// registers for the whole walk. At bit k each thread loads its 8 vectors
// of magnitude plane k (independent loads), ANDs them into the
// candidates, and one __syncthreads_or decides for the whole block
// whether the narrowed set is non-empty; only then does it keep the
// narrowed set, re-reading the plane from L1. So each plane crosses from
// device memory once and a bit costs one barrier, not a popcount
// reduction.
//
// bsi_minmax_tree: the filter is a call tree (tree_interp.cuh) that the
// kernel evaluates itself, as the reference evaluates it inside the
// Min/Max program (executor.py:1019 _filter_plan, :1167-1203), so the
// [S, W] filter is never written to device memory and the bound counts
// the tree's leaf and condition planes. The block first evaluates its
// shard's filter once per vector into shared memory (8,192 vectors, 128
// KB at most), then walks as the plain kernel does with the filter read
// from there: the interpreter's stack and the 8 candidate vectors per
// thread are never live at once (together they passed the 64 registers
// of a 1,024-thread block and spilled).
#include "tree_interp.cuh"

#define MM_THREADS 1024
#define MM_VPT 8  // vectors per thread: a shard holds at most 8,192

__device__ __forceinline__ uint4 mm_step(uint4 cand, uint4 mag, bool prefer_set) {
  return prefer_set ? pt_and4(cand, mag) : pt_andn4(cand, mag);
}

// The shard's filter words of bsi_minmax_tree (dynamic shared memory).
extern __shared__ uint4 mm_filter[];

// One shard's extreme. With TREE the filter is the program `tree`, first
// evaluated into mm_filter; without, the plane `filt` or all ones.
template <bool TREE>
__device__ __forceinline__ void mm_shard(const TreeArgs* tree,
                                         const uint4* __restrict__ stack,
                                         long long n_vec, int vps,
                                         int present, int depth,
                                         const uint4* __restrict__ filt,
                                         int want_max,
                                         long long* __restrict__ value_out,
                                         long long* __restrict__ count_out) {
  __shared__ unsigned warp_sums[MM_THREADS / 32];
  const long long off = (long long)blockIdx.x * vps;
  if (TREE) {
#pragma unroll 1
    for (int v = threadIdx.x; v < vps; v += MM_THREADS) mm_filter[v] = te_eval(*tree, off + v);
    __syncthreads();
  }
  uint4 cand[MM_VPT];
  unsigned any = 0;
  // the preferred set: positives for Max, negatives for Min
#pragma unroll
  for (int j = 0; j < MM_VPT; ++j) {
    const int v = threadIdx.x + j * MM_THREADS;
    cand[j] = pt_zero4();
    if (v < vps) {
      uint4 base = pt_plane(stack, n_vec, present, 0, off + v);
      if (TREE) {
        base = pt_and4(base, mm_filter[v]);
      } else if (filt != nullptr) {
        base = pt_and4(base, filt[off + v]);
      }
      const uint4 sg = pt_plane(stack, n_vec, present, 1, off + v);
      cand[j] = want_max ? pt_andn4(base, sg) : pt_and4(base, sg);
      any |= pt_any4(cand[j]);
    }
  }
  const bool has = __syncthreads_or(any != 0) != 0;
  if (!has) {
    // no column of the preferred sign: every candidate has the other one
#pragma unroll
    for (int j = 0; j < MM_VPT; ++j) {
      const int v = threadIdx.x + j * MM_THREADS;
      if (v < vps) {
        cand[j] = pt_plane(stack, n_vec, present, 0, off + v);
        if (TREE) {
          cand[j] = pt_and4(cand[j], mm_filter[v]);
        } else if (filt != nullptr) {
          cand[j] = pt_and4(cand[j], filt[off + v]);
        }
      }
    }
  }
  const bool prefer_set = has;
  long long val = 0;
  for (int k = depth - 1; k >= 0; --k) {
    const int p = 2 + k;
    unsigned hit = 0;
    if (p < present) {
#pragma unroll
      for (int j = 0; j < MM_VPT; ++j) {
        const int v = threadIdx.x + j * MM_THREADS;
        if (v < vps) {
          hit |= pt_any4(mm_step(cand[j], stack[(long long)p * n_vec + off + v], prefer_set));
        }
      }
    } else if (!prefer_set) {
      // a missing plane is zero: cand & ~0 keeps every candidate
#pragma unroll
      for (int j = 0; j < MM_VPT; ++j) hit |= pt_any4(cand[j]);
    }
    const bool nonempty = __syncthreads_or(hit != 0) != 0;
    if (nonempty && p < present) {
#pragma unroll
      for (int j = 0; j < MM_VPT; ++j) {
        const int v = threadIdx.x + j * MM_THREADS;
        if (v < vps) {
          cand[j] = mm_step(cand[j], stack[(long long)p * n_vec + off + v], prefer_set);
        }
      }
    }
    if (prefer_set == nonempty) val |= 1ll << k;
  }

  unsigned c = 0;
#pragma unroll
  for (int j = 0; j < MM_VPT; ++j) c += pt_popc4(cand[j]);
  c = __reduce_add_sync(0xffffffffu, c);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = c;
  __syncthreads();
  if (warp == 0) {
    c = __reduce_add_sync(0xffffffffu, warp_sums[lane]);
    if (lane == 0) {
      const bool negate = want_max ? !has : has;
      value_out[blockIdx.x] = negate ? -val : val;
      count_out[blockIdx.x] = (long long)c;
    }
  }
}

__global__ void __launch_bounds__(MM_THREADS, 1)
    bsi_minmax_kernel(const uint4* __restrict__ stack, long long n_vec,
                      int vps, int present, int depth,
                      const uint4* __restrict__ filt, int want_max,
                      long long* __restrict__ value_out,
                      long long* __restrict__ count_out) {
  mm_shard<false>(nullptr, stack, n_vec, vps, present, depth, filt, want_max,
                  value_out, count_out);
}

__global__ void __launch_bounds__(MM_THREADS, 1)
    bsi_minmax_tree_kernel(const __grid_constant__ TreeArgs tree,
                           const uint4* __restrict__ stack, long long n_vec,
                           int vps, int present, int depth, int want_max,
                           long long* __restrict__ value_out,
                           long long* __restrict__ count_out) {
  mm_shard<true>(&tree, stack, n_vec, vps, present, depth, nullptr, want_max,
                 value_out, count_out);
}

static_assert(TE_PARAMS_FIT(8), "bsi_minmax_tree's parameters pass 4 KB");

// stack: int32[present, S, W] with vps = W / 4 vectors per shard and
// n_vec = S * vps; filt: int32[S, W] or null (all ones); value, count:
// int64[S]. Returns cudaGetLastError().
PT_EXPORT int bsi_minmax(const void* stack, long long n_shards, int vps,
                         int present, int depth, const void* filt,
                         int want_max, void* value, void* count,
                         void* stream) {
  if (stack == nullptr || n_shards < 1 || n_shards > 0x7fffffffLL ||
      vps < 1 || vps > MM_THREADS * MM_VPT || present < 1 || depth < 0 ||
      depth > 63) {
    return (int)cudaErrorInvalidValue;
  }
  bsi_minmax_kernel<<<(unsigned)n_shards, MM_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint4*)stack, n_shards * vps, vps, present, depth,
      (const uint4*)filt, want_max, (long long*)value, (long long*)count);
  return (int)cudaGetLastError();
}

// filt: the filter's program over [S, W] planes of n_shards * vps
// vectors; the rest as bsi_minmax. Returns cudaGetLastError().
PT_EXPORT int bsi_minmax_tree(const TreeArgs* filt, const void* stack,
                              long long n_shards, int vps, int present,
                              int depth, int want_max, void* value,
                              void* count, void* stream) {
  if (stack == nullptr || n_shards < 1 || n_shards > 0x7fffffffLL ||
      vps < 1 || vps > MM_THREADS * MM_VPT || present < 1 || depth < 0 ||
      depth > 63 || !tree_program_ok(filt, n_shards * vps)) {
    return (int)cudaErrorInvalidValue;
  }
  // the filter's words in dynamic shared memory: past the 48 KB default
  const int most = MM_THREADS * MM_VPT * (int)sizeof(uint4);
  cudaError_t err = cudaFuncSetAttribute(
      bsi_minmax_tree_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  if (err != cudaSuccess) return (int)err;
  bsi_minmax_tree_kernel<<<(unsigned)n_shards, MM_THREADS, (size_t)vps * sizeof(uint4),
                           (cudaStream_t)stream>>>(
      *filt, (const uint4*)stack, n_shards * vps, vps, present, depth,
      want_max, (long long*)value, (long long*)count);
  return (int)cudaGetLastError();
}
