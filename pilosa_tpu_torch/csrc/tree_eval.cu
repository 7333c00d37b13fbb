// K1: the fused call-tree kernel.
//
// Replaces the XLA program that pilosa_tpu builds for every bitmap call
// tree: the _Planner.plan closures, _plan_row, _plan_condition and
// _existence (pilosa_tpu/executor/compile.py:1334, :1387, :1444, :1282),
// run by QueryCompiler.count_async (:1656, with ops.popcount_rows) and
// QueryCompiler.bitmap_device (:1640), and the BSI compare/between of
// pilosa_tpu/ops/bsi.py:38-110 that those programs vmap over the shards.
// The planner here compiles the tree to a postfix program once per tree
// shape (row ids are inputs, so one program serves every row id) and
// this kernel interprets it word by word.
//
// The interpreter (the opcodes, BSI conditions and container leaves) is
// tree_interp.cuh, shared with the fused filters of K2, K4 and K5.
//
// Bound on the H100: bytes. Each leaf plane is read once, 16 B per thread
// per load, neighbouring threads on neighbouring addresses, and nothing
// else touches device memory: in count mode the popcount stays in
// registers and each block adds one int64 with one atomic, so the least
// time is leaves * S * W * 4 bytes over 3.35 TB/s, where a condition
// counts its 2 + D planes.
#include "tree_interp.cuh"

template <bool COUNT>
__global__ void __launch_bounds__(PT_BLOCK)
    tree_eval_kernel(const __grid_constant__ TreeArgs a, long long n_vec,
                     uint4* out_words,
                     unsigned long long* out_count) {
  unsigned long long acc = 0;
  const long long step = (long long)gridDim.x * PT_BLOCK;
  for (long long i = (long long)blockIdx.x * PT_BLOCK + threadIdx.x;
       i < n_vec; i += step) {
    const uint4 v = te_eval(a, i);
    if (COUNT) {
      acc += pt_popc4(v);
    } else {
      out_words[i] = v;
    }
  }
  if (COUNT) {
    acc = pt_block_sum(acc);
    if (threadIdx.x == 0 && acc != 0) atomicAdd(out_count, acc);
  }
}

// n_vec = S * W / 4. Exactly one of out_words (int32[S, W]) and out_count
// (a zeroed int64 scalar) is non-null. Returns cudaGetLastError().
PT_EXPORT int tree_eval(const TreeArgs* args, long long n_vec,
                        void* out_words, void* out_count, void* stream) {
  if (n_vec <= 0 || !tree_program_ok(args, n_vec) ||
      (out_words == nullptr) == (out_count == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  long long want = (n_vec + PT_BLOCK - 1) / PT_BLOCK;
  const long long cap = pt_resident_blocks();
  const int grid = (int)(want < cap ? want : cap);
  cudaStream_t s = (cudaStream_t)stream;
  if (out_count != nullptr) {
    tree_eval_kernel<true><<<grid, PT_BLOCK, 0, s>>>(
        *args, n_vec, nullptr, (unsigned long long*)out_count);
  } else {
    tree_eval_kernel<false><<<grid, PT_BLOCK, 0, s>>>(
        *args, n_vec, (uint4*)out_words, nullptr);
  }
  return (int)cudaGetLastError();
}
