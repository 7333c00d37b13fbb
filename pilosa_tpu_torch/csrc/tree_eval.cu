// K1: the fused call-tree kernel.
//
// Replaces the XLA program that pilosa_tpu builds for every bitmap call
// tree: the _Planner.plan closures, _plan_row and _existence
// (pilosa_tpu/executor/compile.py:1334, :1387, :1282), run by
// QueryCompiler.count_async (:1656, with ops.popcount_rows) and
// QueryCompiler.bitmap_device (:1640). The planner here compiles the tree
// to a postfix program once per tree shape (row ids are inputs, so one
// program serves every row id) and this kernel interprets it word by word.
//
// The program and its leaf table are one __grid_constant__ kernel
// parameter (about 3 KB), so a query uploads nothing before its launch and
// the dynamic indexing below reads the constant bank, not a per-thread
// copy. A leaf is the base of one [S, W] plane: row `row` of an
// int32[R, S, W] stack. The wrapper resolves (stack, row, R) to that base
// and passes null for a row < 0 or >= R, which reads as zero words.
//
// Program: LOAD leaf pushes the leaf's plane, ZERO pushes zero words, AND / OR / XOR / ANDNOT pop b and a and push
// a op b (ANDNOT is a & ~b; PQL Not(x) is LOAD existence, x, ANDNOT).
//
// Bound on the H100: bytes. Each leaf plane is read once, 16 B per thread
// per load, neighbouring threads on neighbouring addresses, and nothing
// else touches device memory: in count mode the popcount stays in
// registers and each block adds one int64 with one atomic, so the least
// time is leaves * S * W * 4 bytes over 3.35 TB/s. The operand stack is a
// small per-thread array (at most TE_MAX_STACK vectors); it lives in
// local memory, which L1 absorbs for the shallow trees PQL produces.
#include "common.cuh"

#define TE_MAX_LEAVES 256
#define TE_MAX_OPS 512
#define TE_MAX_STACK 32

enum TreeOp {
  TE_LOAD = 0,
  TE_ZERO = 1,
  TE_AND = 2,
  TE_OR = 3,
  TE_XOR = 4,
  TE_ANDNOT = 5,
};

struct TreeArgs {
  const uint4* leaf[TE_MAX_LEAVES];  // plane base per leaf, null = zeros
  int n_leaves;
  int n_ops;
  unsigned char op[TE_MAX_OPS];
  unsigned char arg[TE_MAX_OPS];  // leaf index of a LOAD
};

template <bool COUNT>
__global__ void __launch_bounds__(PT_BLOCK)
    tree_eval_kernel(const __grid_constant__ TreeArgs a, long long n_vec,
                     uint4* out_words,
                     unsigned long long* out_count) {
  unsigned long long acc = 0;
  const long long step = (long long)gridDim.x * PT_BLOCK;
  for (long long i = (long long)blockIdx.x * PT_BLOCK + threadIdx.x;
       i < n_vec; i += step) {
    uint4 st[TE_MAX_STACK];
    int sp = 0;
    for (int k = 0; k < a.n_ops; ++k) {
      const int op = a.op[k];
      if (op == TE_LOAD) {
        const uint4* plane = a.leaf[a.arg[k]];
        st[sp++] = plane != nullptr ? plane[i] : make_uint4(0u, 0u, 0u, 0u);
      } else if (op == TE_ZERO) {
        st[sp++] = make_uint4(0u, 0u, 0u, 0u);
      } else {
        const uint4 b = st[--sp];
        uint4 x = st[sp - 1];
        if (op == TE_AND) {
          x.x &= b.x; x.y &= b.y; x.z &= b.z; x.w &= b.w;
        } else if (op == TE_OR) {
          x.x |= b.x; x.y |= b.y; x.z |= b.z; x.w |= b.w;
        } else if (op == TE_XOR) {
          x.x ^= b.x; x.y ^= b.y; x.z ^= b.z; x.w ^= b.w;
        } else {
          x.x &= ~b.x; x.y &= ~b.y; x.z &= ~b.z; x.w &= ~b.w;
        }
        st[sp - 1] = x;
      }
    }
    if (COUNT) {
      acc += pt_popc4(st[0]);
    } else {
      out_words[i] = st[0];
    }
  }
  if (COUNT) {
    acc = pt_block_sum(acc);
    if (threadIdx.x == 0 && acc != 0) atomicAdd(out_count, acc);
  }
}

// Checks the program on the host before any launch: every index in
// range, no stack underflow or overflow, exactly one value left.
static bool tree_program_ok(const TreeArgs* a) {
  if (a->n_leaves < 0 || a->n_leaves > TE_MAX_LEAVES) return false;
  if (a->n_ops < 1 || a->n_ops > TE_MAX_OPS) return false;
  int sp = 0;
  for (int k = 0; k < a->n_ops; ++k) {
    const int op = a->op[k];
    if (op == TE_LOAD || op == TE_ZERO) {
      if (op == TE_LOAD && a->arg[k] >= a->n_leaves) return false;
      if (++sp > TE_MAX_STACK) return false;
    } else if (op >= TE_AND && op <= TE_ANDNOT) {
      if (sp < 2) return false;
      --sp;
    } else {
      return false;
    }
  }
  return sp == 1;
}

// n_vec = S * W / 4. Exactly one of out_words (int32[S, W]) and out_count
// (a zeroed int64 scalar) is non-null. Returns cudaGetLastError().
PT_EXPORT int tree_eval(const TreeArgs* args, long long n_vec,
                        void* out_words, void* out_count, void* stream) {
  if (!tree_program_ok(args) || n_vec <= 0 ||
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
