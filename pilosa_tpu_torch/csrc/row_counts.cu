// K2: per-row masked popcount, summed over shards.
//
// Replaces the TopN programs of pilosa_tpu/executor/executor.py:1366-1390
// (ops.matrix_filter_counts / ops.popcount_rows over the [R, S, W] stack,
// summed over S) and the ids= recount at :1306-1332
// (ops.topn.candidate_counts, pilosa_tpu/ops/topn.py:29).
//
// out[o] = sum over the plane of popcount(m[row_o] & filt), with row_o = o,
// or ids[o] when a candidate list is given; a candidate outside [0, R)
// counts 0. The filter is optional (TopN without a filter reads no filter
// bytes at all).
//
// Bound on the H100: bytes, the stack's rows read once plus the filter
// once. Block (o, y) streams a slice of row o's plane 16 B per thread,
// keeps its popcount in registers and adds one int64 with one atomic. The
// filter slice is re-read for each row; at R rows it comes from L2 when
// the rows' blocks run together, and it is the reason a filtered count
// moves more than the bound's bytes when the plane is larger than L2.
#include "common.cuh"

__global__ void __launch_bounds__(PT_BLOCK)
    row_counts_kernel(const uint4* __restrict__ m, long long n_rows,
                      long long n_vec, const uint4* __restrict__ filt,
                      const int* __restrict__ ids,
                      unsigned long long* __restrict__ out) {
  const long long o = blockIdx.x;
  const long long r = ids != nullptr ? (long long)ids[o] : o;
  if (r < 0 || r >= n_rows) return;  // uniform over the block
  const uint4* plane = m + r * n_vec;
  unsigned long long acc = 0;
  const long long step = (long long)gridDim.y * PT_BLOCK;
  for (long long i = (long long)blockIdx.y * PT_BLOCK + threadIdx.x;
       i < n_vec; i += step) {
    uint4 v = plane[i];
    if (filt != nullptr) {
      const uint4 f = filt[i];
      v.x &= f.x; v.y &= f.y; v.z &= f.z; v.w &= f.w;
    }
    acc += pt_popc4(v);
  }
  acc = pt_block_sum(acc);
  if (threadIdx.x == 0 && acc != 0) atomicAdd(&out[o], acc);
}

// m: int32[n_rows, S, W] with n_vec = S * W / 4; filt: int32[S, W] or
// null; ids: int32[n_out] or null (then n_out == n_rows); out: zeroed
// int64[n_out]. Returns cudaGetLastError().
PT_EXPORT int row_counts(const void* m, long long n_rows, long long n_vec,
                         const void* filt, const void* ids, long long n_out,
                         void* out, void* stream) {
  if (n_vec <= 0 || n_out < 0 || n_out > 0x7fffffffLL ||
      (ids == nullptr && n_out != n_rows)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_out == 0) return (int)cudaGetLastError();
  long long per_row = (pt_resident_blocks() + n_out - 1) / n_out;
  const long long most = (n_vec + PT_BLOCK - 1) / PT_BLOCK;
  if (per_row > most) per_row = most;
  if (per_row > 65535) per_row = 65535;
  if (per_row < 1) per_row = 1;
  dim3 grid((unsigned)n_out, (unsigned)per_row);
  row_counts_kernel<<<grid, PT_BLOCK, 0, (cudaStream_t)stream>>>(
      (const uint4*)m, n_rows, n_vec, (const uint4*)filt, (const int*)ids,
      (unsigned long long*)out);
  return (int)cudaGetLastError();
}
