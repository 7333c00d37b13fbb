// Shared helpers for the hand-written Hopper kernels.
//
// Words are the reference's uint32 bitmap words; the Python side stores
// them as int32 tensors (the same bytes) and the kernels read them as
// uint32_t, four at a time as one 16-byte uint4 vector per thread.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define PT_EXPORT extern "C" __attribute__((visibility("default")))

#define PT_BLOCK 256

__device__ __forceinline__ unsigned pt_popc4(uint4 v) {
  return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

__device__ __forceinline__ uint4 pt_zero4() { return make_uint4(0u, 0u, 0u, 0u); }

__device__ __forceinline__ uint4 pt_ones4() {
  return make_uint4(~0u, ~0u, ~0u, ~0u);
}

__device__ __forceinline__ uint4 pt_and4(uint4 a, uint4 b) {
  return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
}

__device__ __forceinline__ uint4 pt_or4(uint4 a, uint4 b) {
  return make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
}

// a & ~b
__device__ __forceinline__ uint4 pt_andn4(uint4 a, uint4 b) {
  return make_uint4(a.x & ~b.x, a.y & ~b.y, a.z & ~b.z, a.w & ~b.w);
}

__device__ __forceinline__ unsigned pt_any4(uint4 v) {
  return v.x | v.y | v.z | v.w;
}

// Vector i of plane p of a row-major BSI stack [present, S, W] whose
// planes are `stride` vectors apart; a plane at or past `present` reads
// as zero words (the reference pads the stack with zero planes instead).
__device__ __forceinline__ uint4 pt_plane(const uint4* __restrict__ base,
                                          long long stride, int present,
                                          int p, long long i) {
  return p < present ? base[(long long)p * stride + i] : pt_zero4();
}

// Sum of one value per thread over a PT_BLOCK-thread block; the result is
// valid in thread 0. Integer addition, so the order does not matter.
__device__ __forceinline__ unsigned long long pt_block_sum(
    unsigned long long v) {
  __shared__ unsigned long long warp_sums[PT_BLOCK / 32];
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < PT_BLOCK / 32 ? warp_sums[lane] : 0ull;
    for (int off = 16; off > 0; off >>= 1) {
      v += __shfl_down_sync(0xffffffffu, v, off);
    }
  }
  return v;
}

// The SMs of the current device (132 on an H100 SXM).
static inline int pt_sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

// Blocks to keep in flight for a streaming kernel: eight PT_BLOCK-thread
// blocks per SM fill the SM's 2048 threads.
static inline int pt_resident_blocks() { return pt_sm_count() * 8; }

PT_EXPORT const char* pt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
