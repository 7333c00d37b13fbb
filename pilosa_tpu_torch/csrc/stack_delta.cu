// K3: the point-write delta scatter, copy included, and the row scatter.
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
// Row mode (ops/stack.py scatter_rows) runs the same kernels for
// _scatter_rows (pilosa_tpu/executor/compile.py:185), the functional row
// scatter into the tiered residency stores: a store [H, ...] is H rows of
// P planes of L words (a dense [H, S, W] store P = S, L = W; a sparse
// [H, 2048] or run [H, 128, 2] store P = 1), idx[k] names a row, and the
// kernels take (slot, P, L) as they are: entry k covers the P * L words
// of row idx[k].
//
// Bound on the H100: bytes. The stack is read once and written once, and
// each written row is read once from `rows`: 2 * R * S * W * 4 + K * W * 4.
// Design: the copy is a flat stream that does not depend on planes. One
// persistent block per SM moves the stack in 32 KB chunks through a ring
// of shared-memory stages with 1-D bulk asynchronous copies (bulk.cuh):
// one thread brings chunk j in with an mbarrier, writes chunk j - 1's
// stage out as a bulk store, and refills that stage once the store has
// read it, so five chunks stay in flight per SM with no per-thread
// registers, no slot lookup and no dependent round trip. Then, on the
// same stream, one block maps each kept entry's plane to the last entry
// that names it (slot[plane] = k), and a small kernel writes the winning
// entries' rows over their planes: those K planes are written twice,
// K * W * 4 bytes more than the bound (0.5 MB for the main path's delta).
// With K = 0 the copy is the only launch.
#include "bulk.cuh"

#define SD_CHUNK 32768  // bytes a ring stage holds
#define SD_STAGES 6      // 192 KB, one block an SM
#define SD_RING_BYTES (SD_CHUNK * SD_STAGES)
#define SD_PATCH_VEC 2048  // vectors of a row a patch block writes at a time
#define SD_SLOT_THREADS 1024

static_assert(SD_CHUNK % 16 == 0, "bulk copies move whole 16 B vectors");

__global__ void __launch_bounds__(32)
    stack_copy_kernel(char* __restrict__ out, const char* __restrict__ in,
                      long long n_bytes) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) unsigned long long full[SD_STAGES];
  if (threadIdx.x != 0) return;
  const long long n_chunks = (n_bytes + SD_CHUNK - 1) / SD_CHUNK;
  if (blockIdx.x >= n_chunks) return;
  // this block's chunks are blockIdx.x + j * gridDim.x, j < m
  const long long m = (n_chunks - 1 - blockIdx.x) / gridDim.x + 1;
  for (int s = 0; s < SD_STAGES; ++s) pt_mbar_init(&full[s], 1);
  pt_mbar_init_fence();
  auto offset = [&](long long j) {
    return ((long long)blockIdx.x + j * gridDim.x) * SD_CHUNK;
  };
  auto size = [&](long long j) {
    const long long left = n_bytes - offset(j);
    return (unsigned)(left < SD_CHUNK ? left : SD_CHUNK);
  };
  auto load = [&](long long j) {
    const int s = (int)(j % SD_STAGES);
    pt_mbar_expect_tx(&full[s], size(j));
    pt_bulk_load(ring + s * SD_CHUNK, in + offset(j), size(j), &full[s]);
  };
  for (long long j = 0; j < m && j < SD_STAGES; ++j) load(j);
  for (long long j = 0; j < m; ++j) {
    const int s = (int)(j % SD_STAGES);
    pt_mbar_wait(&full[s], (unsigned)((j / SD_STAGES) & 1));
    pt_fence_async_smem();
    pt_bulk_store(out + offset(j), ring + s * SD_CHUNK, size(j));
    pt_bulk_commit();
    // chunk j - 1's store has read its stage: chunk j - 1 + SD_STAGES
    // takes it
    if (j >= 1 && j - 1 + SD_STAGES < m) {
      pt_bulk_wait_read<1>();
      load(j - 1 + SD_STAGES);
    }
  }
  pt_bulk_wait_all();
}

// Entry k's plane (delta: row * n_shards + shard; rows: the row itself),
// or -1 when it is out of range.
__device__ __forceinline__ long long sd_plane(const int* __restrict__ idx,
                                              int cols, long long k,
                                              long long n_rows,
                                              long long n_shards) {
  const long long r = idx[cols * k];
  if (r < 0 || r >= n_rows) return -1;
  if (cols == 1) return r;
  const long long s = idx[2 * k + 1];
  return s < 0 || s >= n_shards ? -1 : r * n_shards + s;
}

// slot[plane] = the last entry that names it, for the entries' planes
// only: one block, so the clearing pass is done before the max.
__global__ void __launch_bounds__(SD_SLOT_THREADS)
    stack_slots_kernel(int* __restrict__ slot, const int* __restrict__ idx,
                       int cols, long long n_rows, long long n_shards,
                       long long k_n) {
  for (long long k = threadIdx.x; k < k_n; k += SD_SLOT_THREADS) {
    const long long p = sd_plane(idx, cols, k, n_rows, n_shards);
    if (p >= 0) atomicExch(slot + p, -1);
  }
  __syncthreads();
  for (long long k = threadIdx.x; k < k_n; k += SD_SLOT_THREADS) {
    const long long p = sd_plane(idx, cols, k, n_rows, n_shards);
    if (p >= 0) atomicMax(slot + p, (int)k);
  }
}

// The winning entries' rows over their planes, `unit` vectors each, in
// items of SD_PATCH_VEC vectors with eight 16 B loads in flight a thread.
__global__ void __launch_bounds__(PT_BLOCK)
    stack_patch_kernel(uint4* __restrict__ out, const int* __restrict__ slot,
                       const int* __restrict__ idx, int cols,
                       long long n_rows, long long n_shards, long long unit,
                       const uint4* __restrict__ rows, long long k_n) {
  const long long per = (unit + SD_PATCH_VEC - 1) / SD_PATCH_VEC;
  for (long long item = blockIdx.x; item < k_n * per; item += gridDim.x) {
    const long long k = item / per;
    const long long p = sd_plane(idx, cols, k, n_rows, n_shards);
    if (p < 0 || slot[p] != (int)k) continue;
    const long long lo = (item % per) * SD_PATCH_VEC;
    const long long hi = lo + SD_PATCH_VEC < unit ? lo + SD_PATCH_VEC : unit;
    const uint4* src = rows + k * unit;
    uint4* dst = out + p * unit;
    long long i = lo + threadIdx.x;
    for (; i + 7 * PT_BLOCK < hi; i += 8 * PT_BLOCK) {
      uint4 v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = src[i + u * PT_BLOCK];
#pragma unroll
      for (int u = 0; u < 8; ++u) dst[i + u * PT_BLOCK] = v[u];
    }
    for (; i < hi; i += PT_BLOCK) dst[i] = src[i];
  }
}

// out, in: int32[n_rows, n_shards, 4 * w_vec], out a fresh buffer; rows:
// int32[k, ...] of one entry's words each. cols = 2: a delta, idx
// int32[k, 2] (row, shard), one plane of w_vec vectors an entry, slot
// int32[n_rows * n_shards] scratch. cols = 1: a row scatter, idx
// int32[k] of rows of a store [H = n_rows, P = n_shards, L = 4 * w_vec],
// P planes an entry, slot int32[n_rows]. slot may be null when k = 0.
// Returns cudaGetLastError().
PT_EXPORT int stack_delta(void* out, const void* in, long long n_rows,
                          long long n_shards, long long w_vec,
                          const void* idx, int cols, const void* rows,
                          long long k, void* slot, void* stream) {
  if (w_vec <= 0 || n_rows <= 0 || n_shards <= 0 || k < 0 ||
      k > 0x7fffffffLL || (cols != 1 && cols != 2) ||
      (k > 0 && (idx == nullptr || slot == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  if (!pt_aligned16(out) || !pt_aligned16(in) ||
      (k > 0 && !pt_aligned16(rows))) {
    return (int)cudaErrorMisalignedAddress;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const long long n_bytes = n_rows * n_shards * w_vec * 16;
  const int cap = pt_persistent_blocks(stack_copy_kernel, 32, SD_RING_BYTES);
  if (cap <= 0) return -cap;
  const long long n_chunks = (n_bytes + SD_CHUNK - 1) / SD_CHUNK;
  const int grid = (int)(n_chunks < cap ? n_chunks : cap);
  stack_copy_kernel<<<grid, 32, SD_RING_BYTES, st>>>((char*)out,
                                                     (const char*)in, n_bytes);
  if (k > 0) {
    stack_slots_kernel<<<1, SD_SLOT_THREADS, 0, st>>>(
        (int*)slot, (const int*)idx, cols, n_rows, n_shards, k);
    const long long unit = cols == 2 ? w_vec : n_shards * w_vec;
    const long long items = k * ((unit + SD_PATCH_VEC - 1) / SD_PATCH_VEC);
    const long long blocks =
        items < pt_resident_blocks() ? items : pt_resident_blocks();
    stack_patch_kernel<<<(unsigned)blocks, PT_BLOCK, 0, st>>>(
        (uint4*)out, (const int*)slot, (const int*)idx, cols, n_rows,
        n_shards, unit, (const uint4*)rows, k);
  }
  return (int)cudaGetLastError();
}
