// Bulk asynchronous copies and shared-memory barriers (sm_90), the PTX
// that K1 (tree_eval.cu) and K3 (stack_delta.cu) build their rings from.
//
// A 1-D bulk copy (cp.async.bulk) moves a run of bytes between device
// memory and shared memory with no tensor map and no per-thread
// registers: one thread issues it and the copy engine computes the
// addresses. A load into shared memory reports its bytes to an mbarrier
// (complete_tx); a store from shared memory joins a bulk group that the
// issuing thread waits on. Addresses are 16 B aligned and sizes a
// multiple of 16 B.
//
// An mbarrier's phase flips when its arrivals and its expected bytes are
// all in; pt_mbar_wait(bar, parity) returns once the phase of that parity
// has completed. A fresh barrier is in phase 0, so waiting on parity 1
// returns at once: a ring's producer starts with every stage free.
#pragma once

#include "common.cuh"

__device__ __forceinline__ unsigned pt_smem(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void pt_mbar_init(unsigned long long* bar,
                                             unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(pt_smem(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy and the block.
__device__ __forceinline__ void pt_mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void pt_mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(pt_smem(bar))
               : "memory");
}

// One arrival, and `bytes` more that the phase waits for.
__device__ __forceinline__ void pt_mbar_expect_tx(unsigned long long* bar,
                                                  unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   pt_smem(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void pt_mbar_wait(unsigned long long* bar,
                                             unsigned parity) {
  const unsigned addr = pt_smem(bar);
  unsigned done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// device memory -> shared memory; the bytes complete on `bar`
__device__ __forceinline__ void pt_bulk_load(void* dst, const void* src,
                                             unsigned bytes,
                                             unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(pt_smem(dst)),
      "l"(src), "r"(bytes), "r"(pt_smem(bar))
      : "memory");
}

// shared memory -> device memory, in the issuing thread's open bulk group
__device__ __forceinline__ void pt_bulk_store(void* dst, const void* src,
                                              unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
                   dst),
               "r"(pt_smem(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void pt_bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Until at most N of this thread's bulk groups still read shared memory.
template <int N>
__device__ __forceinline__ void pt_bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

// Until every bulk group of this thread has completed its writes.
__device__ __forceinline__ void pt_bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// Orders shared memory between the generic and the async proxy.
__device__ __forceinline__ void pt_fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Persistent blocks for a kernel with `smem` bytes of dynamic shared
// memory: as many as fit on every SM at once, after raising the kernel's
// dynamic shared-memory limit and asking for no larger a shared-memory
// carve-out than one block needs, so the rest of the SM's 256 KB stays
// L1 for what the threads read through it (done each call: the
// attributes are per device, and the calls are cheap next to a launch).
// A CUDA error comes back negated.
template <typename K>
static inline int pt_persistent_blocks(K kernel, int threads, int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) {
    // percent of the 228 KB maximum, rounded up; 1 KB a block is reserved
    const int pct = (int)((100LL * (smem + 2048) + 233471) / 233472);
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               pct < 100 ? pct : 100);
  }
  int per_sm = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  }
  if (err != cudaSuccess) return -(int)err;
  if (per_sm <= 0) return -(int)cudaErrorInvalidConfiguration;
  return per_sm * pt_sm_count();
}

static inline bool pt_aligned16(const void* p) {
  return ((unsigned long long)p & 15ull) == 0ull;
}
