// K13: the fused ingest step, in place: OR a write delta into the row
// matrix and count every row under a filter, in one pass.
//
// Replaces the flagship step of pilosa_tpu: __graft_entry__.py:65-71
// query_step (m | delta, ops.matrix_filter_counts, the int64 sum) and
// the per-device body of MeshQueryEngine._ingest_prog
// (pilosa_tpu/parallel/mesh.py:852-884), whose matrix is donated:
//   m[r]     |= delta[r]                      over int32[R, S, W]
//   out[r]   += popcount(m_new[r] & filt)     summed over the plane
//   total    += popcount(m_new[r] & filt)     over every row
// The OR is in place, as the donation lets XLA write the new matrix
// into the old one's buffer.
//
// Bound on the H100: bytes. The matrix and the delta are read once and
// the filter once (from L2 for the later rows when their blocks run
// together); the matrix is written back only where the delta is
// non-zero, so the bytes written are this data's: a vector whose delta
// is zero already holds its new value. Design: K2's launch shape
// (csrc/row_counts.cu). Block (r, y) streams a slice of row r's plane
// 16 B per thread: it loads m, delta and filt, ORs, stores the vector
// if the delta has a bit, popcounts the AND in registers, and at the end
// does one block sum and two 64-bit atomics (the row's count and the
// total).
#include "common.cuh"

__global__ void __launch_bounds__(PT_BLOCK)
    ingest_counts_kernel(uint4* __restrict__ m, const uint4* __restrict__ d,
                         long long n_vec, const uint4* __restrict__ filt,
                         unsigned long long* __restrict__ out,
                         unsigned long long* __restrict__ total) {
  const long long r = blockIdx.x;
  uint4* plane = m + r * n_vec;
  const uint4* dplane = d + r * n_vec;
  unsigned long long acc = 0;
  const long long step = (long long)gridDim.y * PT_BLOCK;
  for (long long i = (long long)blockIdx.y * PT_BLOCK + threadIdx.x;
       i < n_vec; i += step) {
    const uint4 dv = dplane[i];
    uint4 v = plane[i];
    if (pt_any4(dv)) {
      v = pt_or4(v, dv);
      plane[i] = v;
    }
    acc += pt_popc4(pt_and4(v, filt[i]));
  }
  acc = pt_block_sum(acc);
  if (threadIdx.x == 0 && acc != 0) {
    atomicAdd(&out[r], acc);
    atomicAdd(total, acc);
  }
}

// m, delta: int32[n_rows, S, W] (m updated in place) with
// n_vec = S * W / 4; filt: int32[S, W]; out: zeroed int64[n_rows];
// total: zeroed int64[1]. Returns cudaGetLastError().
PT_EXPORT int ingest_counts(void* m, const void* delta, long long n_rows,
                            long long n_vec, const void* filt, void* out,
                            void* total, void* stream) {
  if (n_vec <= 0 || n_rows < 0 || n_rows > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_rows == 0) return (int)cudaGetLastError();
  long long per_row = (pt_resident_blocks() + n_rows - 1) / n_rows;
  const long long most = (n_vec + PT_BLOCK - 1) / PT_BLOCK;
  if (per_row > most) per_row = most;
  if (per_row > 65535) per_row = 65535;
  if (per_row < 1) per_row = 1;
  dim3 grid((unsigned)n_rows, (unsigned)per_row);
  ingest_counts_kernel<<<grid, PT_BLOCK, 0, (cudaStream_t)stream>>>(
      (uint4*)m, (const uint4*)delta, n_vec, (const uint4*)filt,
      (unsigned long long*)out, (unsigned long long*)total);
  return (int)cudaGetLastError();
}
