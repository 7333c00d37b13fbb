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
// bytes at all), an [S, W] plane (row_counts), or a call tree that the
// kernel evaluates itself (row_counts_tree, tree_interp.cuh): the
// reference's filtered TopN evaluates the filter's tree inside its own
// program (executor.py:1019 _filter_plan, :1276-1312, :1356-1383), so the
// [S, W] filter is never written to device memory.
//
// Bound on the H100: bytes, the stack's rows read once plus the filter
// (its plane, or the tree's leaf and condition planes) once. row_counts:
// block (o, y) streams a slice of row o's plane 16 B per thread, keeps
// its popcount in registers and adds one int64 with one atomic. The
// filter slice is re-read for each row; at R rows it comes from L2 when
// the rows' blocks run together, and it is the reason a filtered count
// moves more than the bound's bytes when the plane is larger than L2.
// row_counts_tree: block (g, y) owns a group of RC_GROUP rows (or
// candidates) and a grid-stride range of vectors. Each thread evaluates
// the filter once for its vector, into registers, then loads the
// group's rows at that vector (independent loads, all in flight) and
// keeps one 32-bit counter per row; at the end each counter is reduced
// across the warp (REDUX) and the block, and the block adds one int64
// atomic per row. So the leaf planes are read once per group, not once
// per row: once for a TopN of up to RC_GROUP rows.
#include "tree_interp.cuh"

#define RC_GROUP 8  // rows (or candidates) one block counts per filter

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

__global__ void __launch_bounds__(PT_BLOCK)
    row_counts_tree_kernel(const __grid_constant__ TreeArgs filt,
                           const uint4* __restrict__ m, long long n_rows,
                           long long n_vec, const int* __restrict__ ids,
                           long long n_out,
                           unsigned long long* __restrict__ out) {
  __shared__ const uint4* s_plane[RC_GROUP];
  __shared__ unsigned s_cnt[PT_BLOCK / 32][RC_GROUP];
  const long long o0 = (long long)blockIdx.x * RC_GROUP;
  const int rn = n_out - o0 < RC_GROUP ? (int)(n_out - o0) : RC_GROUP;
  if (threadIdx.x < RC_GROUP) {
    // a candidate outside [0, R), or past the group's end, counts 0
    const uint4* p = nullptr;
    if ((int)threadIdx.x < rn) {
      const long long r = ids != nullptr ? (long long)ids[o0 + threadIdx.x]
                                         : o0 + threadIdx.x;
      if (r >= 0 && r < n_rows) p = m + r * n_vec;
    }
    s_plane[threadIdx.x] = p;
  }
  __syncthreads();
  unsigned acc[RC_GROUP];
#pragma unroll
  for (int r = 0; r < RC_GROUP; ++r) acc[r] = 0u;
  const long long step = (long long)gridDim.y * PT_BLOCK;
  for (long long i = (long long)blockIdx.y * PT_BLOCK + threadIdx.x;
       i < n_vec; i += step) {
    const uint4 f = te_eval(filt, i);
#pragma unroll
    for (int r = 0; r < RC_GROUP; ++r) {
      const uint4* p = s_plane[r];
      if (p != nullptr) acc[r] += pt_popc4(pt_and4(p[i], f));
    }
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < RC_GROUP; ++r) {
    const unsigned v = __reduce_add_sync(0xffffffffu, acc[r]);
    if (lane == 0) s_cnt[warp][r] = v;
  }
  __syncthreads();
  if ((int)threadIdx.x < rn) {
    unsigned long long t = 0;
#pragma unroll
    for (int w = 0; w < PT_BLOCK / 32; ++w) t += s_cnt[w][threadIdx.x];
    if (t != 0) atomicAdd(&out[o0 + threadIdx.x], t);
  }
}

static_assert(TE_PARAMS_FIT(6), "row_counts_tree's parameters pass 4 KB");

// filt: the filter's program over [S, W] planes of n_vec = S * W / 4
// vectors; m, ids, n_out, out as row_counts. Returns cudaGetLastError().
PT_EXPORT int row_counts_tree(const TreeArgs* filt, const void* m,
                              long long n_rows, long long n_vec,
                              const void* ids, long long n_out, void* out,
                              void* stream) {
  if (n_vec <= 0 || n_out < 0 || n_out > 0x7fffffffLL ||
      (ids == nullptr && n_out != n_rows) || !tree_program_ok(filt, n_vec)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_out == 0) return (int)cudaGetLastError();
  const long long groups = (n_out + RC_GROUP - 1) / RC_GROUP;
  long long per_group = (pt_resident_blocks() + groups - 1) / groups;
  const long long most = (n_vec + PT_BLOCK - 1) / PT_BLOCK;
  // a warp's 32-bit counters hold at most 32 * 128 bits per vector step
  const long long least = (n_vec + (long long)PT_BLOCK * (1ll << 19) - 1) /
                          ((long long)PT_BLOCK * (1ll << 19));
  if (per_group > most) per_group = most;
  if (per_group < least) per_group = least;
  if (per_group > 65535) return (int)cudaErrorInvalidValue;
  if (per_group < 1) per_group = 1;
  dim3 grid((unsigned)groups, (unsigned)per_group);
  row_counts_tree_kernel<<<grid, PT_BLOCK, 0, (cudaStream_t)stream>>>(
      *filt, (const uint4*)m, n_rows, n_vec, (const int*)ids, n_out,
      (unsigned long long*)out);
  return (int)cudaGetLastError();
}
