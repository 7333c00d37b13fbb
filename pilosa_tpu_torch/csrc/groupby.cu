// K6: GroupBy's level counts and group masks, two entry points.
//
// Replaces the two GroupBy programs of pilosa_tpu/executor/executor.py:
//   gb_counts  <- _gb_counts (:177): out[g, k] = sum over the shards of
//                 popcount(masks[g] & m[rows[k]]), int64[G, K];
//   gb_masks   <- _gb_masks (:192): out[p] = masks[g_idx[p]] & m[row_sel[p]].
// A row id of -1 (the executor's padding) or >= R reads as a zero row,
// as jnp.take(mode="fill") gives; so does a group index outside [0, G).
//
// Bound on the H100: bytes, the distinct planes read once (the G masks
// and the K rows for gb_counts; the masks and rows named for gb_masks)
// plus the output written once.
// gb_counts design: grid (K, slices of the plane). Block (k, y) streams
// its slice of row k once, 16 B per thread, and ANDs each vector with the
// same vector of up to 8 masks at a time, keeping a 32-bit count per mask
// in registers; more masks take further passes over the slice, which
// come back from L2. Blocks of consecutive k run together over the same
// slice, so the masks' bytes are read from device memory about once and
// served to the other rows by L2 (the effect K2's filtered TopN showed).
// A padding row returns before any load. Each block reduces its counts
// with a warp REDUX and shared atomics, then adds one int64 per mask.
// gb_masks design: grid (P, slices); each block streams its slice of one
// output plane from the two planes it names, or writes zeros.
#include "common.cuh"

#define GB_GCH 8  // masks per pass over a row slice

__global__ void __launch_bounds__(PT_BLOCK)
    gb_counts_kernel(const uint4* __restrict__ masks, long long n_groups,
                     const uint4* __restrict__ m, long long n_rows,
                     long long n_vec, const int* __restrict__ rows,
                     long long n_out, unsigned long long* __restrict__ out) {
  __shared__ unsigned long long s_cnt[GB_GCH];
  const long long k = blockIdx.x;
  const long long r = rows[k];
  if (r < 0 || r >= n_rows) return;  // uniform over the block
  const uint4* row = m + r * n_vec;
  const long long step = (long long)gridDim.y * PT_BLOCK;
  const int lane = threadIdx.x & 31;
  for (long long g0 = 0; g0 < n_groups; g0 += GB_GCH) {
    const int gn = n_groups - g0 < GB_GCH ? (int)(n_groups - g0) : GB_GCH;
    if (threadIdx.x < GB_GCH) s_cnt[threadIdx.x] = 0;
    __syncthreads();
    unsigned c[GB_GCH];
#pragma unroll
    for (int j = 0; j < GB_GCH; ++j) c[j] = 0u;
    for (long long i = (long long)blockIdx.y * PT_BLOCK + threadIdx.x;
         i < n_vec; i += step) {
      const uint4 v = row[i];
#pragma unroll
      for (int j = 0; j < GB_GCH; ++j) {
        if (j < gn) c[j] += pt_popc4(pt_and4(v, masks[(g0 + j) * n_vec + i]));
      }
    }
#pragma unroll
    for (int j = 0; j < GB_GCH; ++j) {
      if (j < gn) {
        const unsigned t = __reduce_add_sync(0xffffffffu, c[j]);
        if (lane == 0 && t) atomicAdd(&s_cnt[j], (unsigned long long)t);
      }
    }
    __syncthreads();
    if (threadIdx.x < gn && s_cnt[threadIdx.x]) {
      atomicAdd(&out[(g0 + threadIdx.x) * n_out + k], s_cnt[threadIdx.x]);
    }
  }
}

__global__ void __launch_bounds__(PT_BLOCK)
    gb_masks_kernel(uint4* __restrict__ out, const uint4* __restrict__ masks,
                    long long n_groups, const uint4* __restrict__ m,
                    long long n_rows, long long n_vec,
                    const int* __restrict__ g_idx,
                    const int* __restrict__ row_sel) {
  const long long p = blockIdx.x;
  const long long g = g_idx[p];
  const long long r = row_sel[p];
  const bool live = g >= 0 && g < n_groups && r >= 0 && r < n_rows;
  const uint4* a = masks + (live ? g : 0) * n_vec;
  const uint4* b = m + (live ? r : 0) * n_vec;
  uint4* o = out + p * n_vec;
  const long long step = (long long)gridDim.y * PT_BLOCK;
  for (long long i = (long long)blockIdx.y * PT_BLOCK + threadIdx.x;
       i < n_vec; i += step) {
    o[i] = live ? pt_and4(a[i], b[i]) : pt_zero4();
  }
}

// Slices per output so that about pt_resident_blocks() blocks run.
static unsigned gb_slices(long long n_out, long long n_vec) {
  long long per = (pt_resident_blocks() + n_out - 1) / n_out;
  const long long most = (n_vec + PT_BLOCK - 1) / PT_BLOCK;
  if (per > most) per = most;
  if (per > 65535) per = 65535;
  if (per < 1) per = 1;
  return (unsigned)per;
}

// masks: int32[G, S, W]; m: int32[R, S, W] with n_vec = S * W / 4;
// rows: int32[K]; out: zeroed int64[G, K]. Returns cudaGetLastError().
PT_EXPORT int gb_counts(const void* masks, long long n_groups, const void* m,
                        long long n_rows, long long n_vec, const void* rows,
                        long long n_out, void* out, void* stream) {
  if (n_vec <= 0 || n_groups < 1 || n_rows < 1 || n_out < 0 ||
      n_out > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_out == 0) return (int)cudaGetLastError();
  const unsigned per = gb_slices(n_out, n_vec);
  // a thread's 32-bit counters hold at most 128 bits per vector it reads
  if ((n_vec + (long long)per * PT_BLOCK - 1) / ((long long)per * PT_BLOCK) > (1ll << 24)) {
    return (int)cudaErrorInvalidValue;
  }
  dim3 grid((unsigned)n_out, per);
  gb_counts_kernel<<<grid, PT_BLOCK, 0, (cudaStream_t)stream>>>(
      (const uint4*)masks, n_groups, (const uint4*)m, n_rows, n_vec,
      (const int*)rows, n_out, (unsigned long long*)out);
  return (int)cudaGetLastError();
}

// out: int32[P, S, W]; masks: int32[G, S, W]; m: int32[R, S, W];
// g_idx, row_sel: int32[P]. Returns cudaGetLastError().
PT_EXPORT int gb_masks(void* out, const void* masks, long long n_groups,
                       const void* m, long long n_rows, long long n_vec,
                       const void* g_idx, const void* row_sel, long long n_out,
                       void* stream) {
  if (n_vec <= 0 || n_groups < 1 || n_rows < 1 || n_out < 0 ||
      n_out > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_out == 0) return (int)cudaGetLastError();
  dim3 grid((unsigned)n_out, gb_slices(n_out, n_vec));
  gb_masks_kernel<<<grid, PT_BLOCK, 0, (cudaStream_t)stream>>>(
      (uint4*)out, (const uint4*)masks, n_groups, (const uint4*)m, n_rows,
      n_vec, (const int*)g_idx, (const int*)row_sel);
  return (int)cudaGetLastError();
}
