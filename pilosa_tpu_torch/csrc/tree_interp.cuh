// The call-tree interpreter: one postfix program evaluated word by word.
//
// K2, K4 and K5 (row_counts.cu, bsi_sum.cu, bsi_minmax.cu) run it as
// their filter, one vector at a time (te_eval), so a
// filtered TopN, Sum, Min or Max never writes the [S, W] filter to device
// memory: the reference evaluates the filter's call tree inside the
// aggregate's own program (pilosa_tpu/executor/executor.py:1019
// _filter_plan). K1 (tree_eval.cu) runs the same program over a whole
// [S, W] plane tile by tile, its planes fed through a shared-memory ring,
// with the comparison and container decoders below.
//
// The program, its leaf table and its condition table are one TreeArgs,
// passed as a __grid_constant__ kernel parameter (3,608 B, under the 4 KB
// that every toolkit accepts; a fused kernel's own arguments take the
// rest, TE_PARAMS_FIT), so a query uploads nothing before its launch and
// the dynamic indexing below reads the constant bank, not a per-thread
// copy. A leaf is the base of one [S, W] plane: row `row` of an
// int32[R, S, W] stack. The wrapper resolves (stack, row, R) to that base
// and passes null for a row < 0 or >= R, which reads as zero words.
//
// Program: LOAD leaf pushes the leaf's plane, ZERO pushes zero words, AND /
// OR / XOR / ANDNOT pop b and a and push a op b (ANDNOT is a & ~b; PQL
// Not(x) is LOAD existence, x, ANDNOT). CMP cond pushes the columns whose
// BSI value compares true against the condition's constant (a BSI
// condition such as Row(v > 5)): the MSB->LSB eq/lt/gt chain of bsi.py:38
// over the stack's magnitude planes, then the sign select of bsi.py:80-106.
// A plane at or past the stack's height reads as zero, where the reference
// pads the stack with zero planes. between(lo, hi) is CMP(>= lo) CMP(<= hi)
// AND, as bsi.py:110.
//
// LOAD_SPARSE and LOAD_RUN push a row that lives compressed in a tiered
// residency store (compile.py:1185 _tiered_leaf, decoded there by
// ops/containers.py:35 sparse_plane and :53 run_plane): the leaf is the
// base of the row's payload, and the [S, W] plane is never built. Both
// payloads hold GLOBAL bit positions of the flattened plane (shard-major,
// bit-minor), so vector i covers bits [128 i, 128 i + 128).
// - sparse: sparse_cap int32 ids, sorted; the -1 padding is 0xffffffff
//   read as uint32 and sorts after every id, so one lower-bound search
//   finds the first id of the vector and a short walk sets its bits;
// - run: run_cap [start, end) int32 pairs, sorted and disjoint, with
//   (0, 0) padding at the tail. A binary search on end > start finds the
//   valid length, a second one the first run ending past the vector; the
//   walk ORs each run's overlap with each of the 4 words, the partial
//   words at a run's two ends included.
// The payloads are 8 KB and 1 KB, so the searches run out of L1.
//
// Each leaf plane is read once per evaluation of vector i, 16 B per
// thread, neighbouring threads on neighbouring addresses. The operand
// stack is a small per-thread array (at most TE_MAX_STACK vectors); it
// lives in local memory, which L1 absorbs for the shallow trees PQL
// produces. A condition's plane loads are independent of one another, so
// the chain is unrolled by four to keep several of them in flight.
#pragma once

#include "common.cuh"

#define TE_MAX_LEAVES 256
#define TE_MAX_OPS 512
#define TE_MAX_STACK 32
#define TE_MAX_CONDS 16

enum TreeOp {
  TE_LOAD = 0,
  TE_ZERO = 1,
  TE_AND = 2,
  TE_OR = 3,
  TE_XOR = 4,
  TE_ANDNOT = 5,
  TE_CMP = 6,
  TE_LOAD_SPARSE = 7,
  TE_LOAD_RUN = 8,
};

// the six BSI comparisons, in ops/bsi.py's CMP_OPS order
enum CmpOp {
  CMP_EQ = 0,
  CMP_NE = 1,
  CMP_LT = 2,
  CMP_LE = 3,
  CMP_GT = 4,
  CMP_GE = 5,
};

struct TreeCond {
  const uint4* base;         // plane 0 (existence) of the BSI stack
  long long stride;          // vectors from one plane to the next
  unsigned long long c_abs;  // |c|
  int present;               // planes in the stack; the rest read zero
  unsigned char depth;       // D, the magnitude planes compared
  unsigned char op;          // a CmpOp
  unsigned char neg;         // c < 0
  unsigned char big;         // |c| >= 2^D: no stored magnitude reaches it
};

struct TreeArgs {
  const uint4* leaf[TE_MAX_LEAVES];  // plane base per leaf, null = zeros
  TreeCond cond[TE_MAX_CONDS];
  int n_leaves;
  int n_ops;
  int n_conds;
  int sparse_cap;  // ids per sparse payload
  int run_cap;     // intervals per run payload
  unsigned char op[TE_MAX_OPS];
  unsigned char arg[TE_MAX_OPS];  // leaf index of a LOAD*, condition of a CMP
};

static_assert(sizeof(TreeCond) == 32, "TreeCond layout is mirrored in ops/bitwise.py");
static_assert(sizeof(TreeArgs) == 3608, "TreeArgs layout is mirrored in ops/bitwise.py");

// A kernel taking a TreeArgs and `n` further parameters of at most 8 B
// each stays within the 4 KB parameter space.
#define TE_PARAMS_FIT(n) (sizeof(TreeArgs) + 8 * (n) <= 4096)

// The comparison's answer from the existence and sign words and the
// magnitude chain's eq / lt / gt words (bsi.py:80-106's sign select).
__device__ __forceinline__ uint4 te_cmp_select(const TreeCond& c, uint4 ex,
                                               uint4 sg, uint4 eq, uint4 lt,
                                               uint4 gt) {
  const uint4 pos = pt_andn4(ex, sg);
  const uint4 neg = pt_and4(ex, sg);
  uint4 e, l, g;
  if (!c.neg) {
    e = pt_and4(pos, eq);
    l = pt_or4(neg, pt_and4(pos, lt));  // every negative, smaller positives
    g = pt_and4(pos, gt);
  } else {
    e = pt_and4(neg, eq);
    l = pt_and4(neg, gt);  // negatives of larger magnitude
    g = pt_or4(pos, pt_and4(neg, lt));
  }
  switch (c.op) {
    case CMP_EQ: return e;
    case CMP_NE: return pt_andn4(ex, e);
    case CMP_LT: return l;
    case CMP_LE: return pt_or4(l, e);
    case CMP_GT: return g;
    default: return pt_or4(g, e);
  }
}

// One step of the MSB->LSB chain: magnitude bit k of the constant
// against the plane's `bit` words.
__device__ __forceinline__ void te_cmp_step(bool c_bit, uint4 bit, uint4& eq,
                                            uint4& lt, uint4& gt) {
  if (c_bit) {
    lt = pt_or4(lt, pt_andn4(eq, bit));
    eq = pt_and4(eq, bit);
  } else {
    gt = pt_or4(gt, pt_and4(eq, bit));
    eq = pt_andn4(eq, bit);
  }
}

// Columns of vector i whose value compares true against the constant.
__device__ __forceinline__ uint4 te_compare(const TreeCond& c, long long i) {
  const uint4 ex = pt_plane(c.base, c.stride, c.present, 0, i);
  const uint4 sg = pt_plane(c.base, c.stride, c.present, 1, i);
  uint4 eq, lt, gt;
  if (c.big) {
    eq = pt_zero4();
    lt = pt_ones4();
    gt = pt_zero4();
  } else {
    eq = pt_ones4();
    lt = pt_zero4();
    gt = pt_zero4();
#pragma unroll 4
    for (int k = (int)c.depth - 1; k >= 0; --k) {
      const uint4 bit = pt_plane(c.base, c.stride, c.present, 2 + k, i);
      te_cmp_step((c.c_abs >> k) & 1ull, bit, eq, lt, gt);
    }
  }
  return te_cmp_select(c, ex, sg, eq, lt, gt);
}

// First index in [lo, hi) of a sparse payload whose id (as uint32) is at
// or past bit b; hi if none.
__device__ __forceinline__ int te_sparse_find(const int* __restrict__ ids,
                                              int lo, int hi, unsigned b) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((unsigned)__ldg(ids + mid) < b) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The 4 words of vector i of a sparse payload whose ids of the vector
// lie in [lo, hi) (see the header).
__device__ __forceinline__ uint4 te_sparse_in(const int* __restrict__ ids,
                                              int lo, int hi, long long i) {
  const unsigned b0 = (unsigned)(i * 128);
  unsigned w0 = 0u, w1 = 0u, w2 = 0u, w3 = 0u;
  for (int k = te_sparse_find(ids, lo, hi, b0); k < hi; ++k) {
    const unsigned off = (unsigned)__ldg(ids + k) - b0;
    if (off >= 128u) break;  // past the vector, or the -1 padding
    const unsigned bit = 1u << (off & 31u);
    const unsigned q = off >> 5;
    w0 |= q == 0 ? bit : 0u;
    w1 |= q == 1 ? bit : 0u;
    w2 |= q == 2 ? bit : 0u;
    w3 |= q == 3 ? bit : 0u;
  }
  return make_uint4(w0, w1, w2, w3);
}

// The 4 words of vector i of a sparse payload (see the header).
__device__ __forceinline__ uint4 te_sparse(const int* __restrict__ ids, int cap,
                                           long long i) {
  return te_sparse_in(ids, 0, cap, i);
}

// Bits [a, b) of one word, 0 <= a <= b <= 32.
__device__ __forceinline__ unsigned te_span(long long a, long long b) {
  if (b <= a) return 0u;
  const unsigned n = (unsigned)(b - a);
  return (n == 32u ? ~0u : ((1u << n) - 1u)) << (unsigned)a;
}

// The valid runs of a run payload: a prefix, end > start.
__device__ __forceinline__ int te_run_len(const int2* __restrict__ runs,
                                          int cap) {
  int lo = 0, hi = cap;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int2 iv = __ldg(runs + mid);
    if (iv.y > iv.x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// First run in [lo, hi) that ends past bit b; hi if none.
__device__ __forceinline__ int te_run_find(const int2* __restrict__ runs,
                                           int lo, int hi, long long b) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((long long)__ldg(runs + mid).y <= b) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The 4 words of vector i of a run payload whose runs that reach the
// vector lie in [lo, n), n the valid runs (see the header).
__device__ __forceinline__ uint4 te_run_in(const int2* __restrict__ runs,
                                           int lo, int n, long long i) {
  const long long b0 = i * 128;
  unsigned w[4] = {0u, 0u, 0u, 0u};
  for (int k = te_run_find(runs, lo, n, b0); k < n; ++k) {
    const int2 iv = __ldg(runs + k);
    if ((long long)iv.x >= b0 + 128) break;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const long long ws = b0 + 32 * u;
      const long long a = (long long)iv.x > ws ? (long long)iv.x - ws : 0;
      const long long e = (long long)iv.y - ws;
      w[u] |= te_span(a, e < 32 ? (e > 0 ? e : 0) : 32);
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The 4 words of vector i of a run payload (see the header).
__device__ __forceinline__ uint4 te_run(const int2* __restrict__ runs, int cap,
                                        long long i) {
  return te_run_in(runs, 0, te_run_len(runs, cap), i);
}

// The program's value at vector i.
__device__ __forceinline__ uint4 te_eval(const TreeArgs& a, long long i) {
  uint4 st[TE_MAX_STACK];
  int sp = 0;
  for (int k = 0; k < a.n_ops; ++k) {
    const int op = a.op[k];
    if (op == TE_LOAD) {
      const uint4* plane = a.leaf[a.arg[k]];
      st[sp++] = plane != nullptr ? plane[i] : pt_zero4();
    } else if (op == TE_ZERO) {
      st[sp++] = pt_zero4();
    } else if (op == TE_LOAD_SPARSE) {
      const int* ids = (const int*)a.leaf[a.arg[k]];
      st[sp++] = ids != nullptr ? te_sparse(ids, a.sparse_cap, i) : pt_zero4();
    } else if (op == TE_LOAD_RUN) {
      const int2* runs = (const int2*)a.leaf[a.arg[k]];
      st[sp++] = runs != nullptr ? te_run(runs, a.run_cap, i) : pt_zero4();
    } else if (op == TE_CMP) {
      st[sp++] = te_compare(a.cond[a.arg[k]], i);
    } else {
      const uint4 b = st[--sp];
      uint4 x = st[sp - 1];
      if (op == TE_AND) {
        x = pt_and4(x, b);
      } else if (op == TE_OR) {
        x = pt_or4(x, b);
      } else if (op == TE_XOR) {
        x.x ^= b.x; x.y ^= b.y; x.z ^= b.z; x.w ^= b.w;
      } else {
        x = pt_andn4(x, b);
      }
      st[sp - 1] = x;
    }
  }
  return st[0];
}

// Checks the program on the host before any launch: every index in
// range, every condition well formed with the stride of the plane it is
// evaluated over (a mesh block's n_vec is its own), no stack underflow or
// overflow, exactly one value left.
static inline bool tree_program_ok(const TreeArgs* a, long long n_vec) {
  if (a == nullptr) return false;
  if (a->n_leaves < 0 || a->n_leaves > TE_MAX_LEAVES) return false;
  if (a->n_conds < 0 || a->n_conds > TE_MAX_CONDS) return false;
  if (a->n_ops < 1 || a->n_ops > TE_MAX_OPS) return false;
  if (a->sparse_cap < 0 || a->run_cap < 0) return false;
  for (int c = 0; c < a->n_conds; ++c) {
    const TreeCond& t = a->cond[c];
    if (t.base == nullptr || t.stride != n_vec || t.present < 1 ||
        t.depth > 63 || t.op > CMP_GE) {
      return false;
    }
  }
  int sp = 0;
  for (int k = 0; k < a->n_ops; ++k) {
    const int op = a->op[k];
    const bool load = op == TE_LOAD || op == TE_LOAD_SPARSE || op == TE_LOAD_RUN;
    if (load || op == TE_ZERO || op == TE_CMP) {
      if (load && a->arg[k] >= a->n_leaves) return false;
      if (op == TE_LOAD_SPARSE && a->sparse_cap < 1) return false;
      if (op == TE_LOAD_RUN && a->run_cap < 1) return false;
      if (op == TE_CMP && a->arg[k] >= a->n_conds) return false;
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
