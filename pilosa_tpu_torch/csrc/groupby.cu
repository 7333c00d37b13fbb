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
// gb_counts design: the counts are a binary product, G masks against K
// rows, with a tiny output and a huge inner dimension: the split-K core of
// bmma.cuh on the tensor cores (A the masks, B the rows the ids pick). An
// id of -1 or >= R issues no load and reads as a zero row. A pass takes
// BM_A_PLANES masks and BM_PAIR_COLS ids: at G <= 32 and K <= 64 every
// mask and every picked row crosses device memory once; more take
// ceil(G / 32) * ceil(K / 64) passes, each reading its planes again. (The
// first design, a block per (row, slice) re-reading the masks through
// L2, grew its popcounts as G * K.)
// gb_masks design: grid (P, slices); each block streams its slice of one
// output plane from the two planes it names, or writes zeros.
#include "bmma.cuh"

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
  if (n_vec <= 0 || n_groups < 1 || n_groups > 0x7fffffffLL || n_rows < 1 || n_out < 0 ||
      n_out > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_out == 0) return (int)cudaGetLastError();
  if (!pt_aligned16(masks) || !pt_aligned16(m)) return (int)cudaErrorMisalignedAddress;
  // ids are int32: every one is below a larger R
  const int limit = n_rows < 0x7fffffffLL ? (int)n_rows : 0x7fffffff;
  for (long long g0 = 0; g0 < n_groups; g0 += BM_A_PLANES) {
    for (long long k0 = 0; k0 < n_out; k0 += BM_PAIR_COLS) {
      BmArgs a = {};
      a.a = (const uint4*)masks + g0 * n_vec;
      a.b = (const uint4*)m;
      a.ids = (const int*)rows + k0;
      a.out0 = (unsigned long long*)out;
      a.n_vec = n_vec;
      a.n_a = (int)(n_groups - g0 < BM_A_PLANES ? n_groups - g0 : BM_A_PLANES);
      a.n_b = (int)(n_out - k0 < BM_PAIR_COLS ? n_out - k0 : BM_PAIR_COLS);
      a.a0 = (int)g0;
      a.b0 = (int)k0;
      a.n_groups = (int)n_groups;
      a.n_cols = (int)n_out;
      a.b_limit = limit;
      const int err = bm_launch<false>(a, (cudaStream_t)stream);
      if (err != 0) return err;
    }
  }
  return 0;
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
