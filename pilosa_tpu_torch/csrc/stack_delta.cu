// K3: the point-write delta scatter, copy included.
//
// Replaces _apply_stack_delta (pilosa_tpu/executor/compile.py:194):
// out = a copy of the row-major int32[R, S, W] stack `in` with
// out[idx[k, 0], idx[k, 1], :] = rows[k]; an entry whose row or shard is
// out of range (the _OOB sentinel, 2**30) is dropped, as jax's
// mode="drop" scatter drops it. The output is a new stack because
// readers in flight keep the old one (the reference does not donate it
// either). Where two entries name one (row, shard) plane, the later
// entry wins.
//
// Bound on the H100: bytes. The stack is read once and written once, and
// each written row is read once from `rows`: 2 * R * S * W * 4 + K * W * 4.
// Design: one pass over the output. A first small kernel writes, for
// each (row, shard) plane, the entry that replaces it (slot[p] = k, or -1)
// into a scratch int32[R * S] map; the copy kernel then streams the
// stack plane by plane, one block per plane at a time, reading the
// plane's slot once and copying the plane from the old stack or from its
// delta row. So the scatter costs no second pass over the written
// planes, and the copy is the kernel's own: 16 B per load, four loads in
// flight per thread before the stores.
//
// Row mode (ops/stack.py scatter_rows) runs this same kernel for
// _scatter_rows (pilosa_tpu/executor/compile.py:185), the functional row
// scatter into the tiered residency stores: a store [H, ...] is viewed as
// [H, P, L] stack planes, a dense [H, S, W] store as itself (P = S, so
// the copy keeps one plane per block) and a sparse [H, 2048] or run
// [H, 128, 2] store as [H, 1, L]. A row's K entries become (slot, p) pairs.
#include "common.cuh"

#define PT_DELTA_UNROLL 4

__global__ void __launch_bounds__(PT_BLOCK)
    stack_delta_slots_kernel(int* __restrict__ slot, long long n_rows,
                             long long n_shards,
                             const int* __restrict__ idx, long long k_n) {
  const long long k = (long long)blockIdx.x * PT_BLOCK + threadIdx.x;
  if (k >= k_n) return;
  const long long r = idx[2 * k];
  const long long s = idx[2 * k + 1];
  if (r < 0 || r >= n_rows || s < 0 || s >= n_shards) return;
  atomicMax(slot + r * n_shards + s, (int)k);
}

__global__ void __launch_bounds__(PT_BLOCK)
    stack_delta_copy_kernel(uint4* __restrict__ out,
                            const uint4* __restrict__ in,
                            const int* __restrict__ slot, long long planes,
                            long long w_vec,
                            const uint4* __restrict__ rows) {
  for (long long p = blockIdx.x; p < planes; p += gridDim.x) {
    const int k = slot[p];
    const uint4* src = k >= 0 ? rows + (long long)k * w_vec : in + p * w_vec;
    uint4* dst = out + p * w_vec;
    long long i = threadIdx.x;
    for (; i + (PT_DELTA_UNROLL - 1) * PT_BLOCK < w_vec;
         i += PT_DELTA_UNROLL * PT_BLOCK) {
      uint4 v[PT_DELTA_UNROLL];
#pragma unroll
      for (int u = 0; u < PT_DELTA_UNROLL; ++u) v[u] = src[i + u * PT_BLOCK];
#pragma unroll
      for (int u = 0; u < PT_DELTA_UNROLL; ++u) dst[i + u * PT_BLOCK] = v[u];
    }
    for (; i < w_vec; i += PT_BLOCK) dst[i] = src[i];
  }
}

// out, in: int32[n_rows, n_shards, W], w_vec = W / 4, out a fresh
// buffer; idx: int32[k, 2] (row, shard); rows: int32[k, W]; slot:
// int32[n_rows * n_shards] scratch. Returns cudaGetLastError().
PT_EXPORT int stack_delta(void* out, const void* in, long long n_rows,
                          long long n_shards, long long w_vec,
                          const void* idx, const void* rows, long long k,
                          void* slot, void* stream) {
  if (w_vec <= 0 || n_rows <= 0 || n_shards <= 0 || k < 0 ||
      k > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const long long planes = n_rows * n_shards;
  cudaError_t err = cudaMemsetAsync(slot, 0xff, planes * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  if (k > 0) {
    stack_delta_slots_kernel<<<(unsigned)((k + PT_BLOCK - 1) / PT_BLOCK),
                               PT_BLOCK, 0, st>>>(
        (int*)slot, n_rows, n_shards, (const int*)idx, k);
  }
  long long grid = planes < pt_resident_blocks() ? planes
                                                 : pt_resident_blocks();
  stack_delta_copy_kernel<<<(unsigned)grid, PT_BLOCK, 0, st>>>(
      (uint4*)out, (const uint4*)in, (const int*)slot, planes, w_vec,
      (const uint4*)rows);
  return (int)cudaGetLastError();
}
