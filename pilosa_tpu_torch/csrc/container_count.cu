// K8: the direct count of one compressed row container.
//
// Replaces sparse_count and run_count (pilosa_tpu/ops/containers.py:113,
// :119), which the reference compiles in place of the whole program when
// a Count's tree is one sparse or run container leaf (count_async's
// direct_counts, pilosa_tpu/executor/compile.py:1656-1689): the count
// reads the payload and never builds the [S, W] plane.
//
// - sparse: int32[k] sorted global bit positions, -1 padding; the count
//   is the number of ids >= 0;
// - run: int32[k, 2] [start, end) intervals, (0, 0) padding; the count is
//   the sum of end - start, as the reference sums it.
//
// Bound on the H100: bytes, and so launch latency: the payload is 8 KB
// (sparse, 2,048 ids) or 1 KB (run, 128 intervals). One block of
// PT_BLOCK threads strides over it, sums in a register, reduces through
// shared memory, and thread 0 writes the int64; no atomic, no memset.
#include "common.cuh"

__global__ void __launch_bounds__(PT_BLOCK)
    container_count_kernel(const int* __restrict__ payload, int run, long long k,
                           unsigned long long* __restrict__ out) {
  long long acc = 0;
  if (payload != nullptr) {
    for (long long e = threadIdx.x; e < k; e += PT_BLOCK) {
      if (run) {
        const int2 iv = reinterpret_cast<const int2*>(payload)[e];
        acc += (long long)iv.y - (long long)iv.x;
      } else {
        acc += payload[e] >= 0;
      }
    }
  }
  // two's complement: the unsigned block sum of signed terms is exact
  const unsigned long long total = pt_block_sum((unsigned long long)acc);
  if (threadIdx.x == 0) *out = total;
}

// payload: one slot of a sparse store (int32[k]) or a run store
// (int32[k, 2], run = 1), or null for a row without a slot (count 0);
// out: an int64 scalar. Returns cudaGetLastError().
PT_EXPORT int container_count(const void* payload, int run, long long k,
                              void* out, void* stream) {
  if (k < 0 || out == nullptr || (run != 0 && run != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  container_count_kernel<<<1, PT_BLOCK, 0, (cudaStream_t)stream>>>(
      (const int*)payload, run, k, (unsigned long long*)out);
  return (int)cudaGetLastError();
}
