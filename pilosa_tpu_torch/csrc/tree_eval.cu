// K1: the fused call-tree kernel.
//
// Replaces the XLA program that pilosa_tpu builds for every bitmap call
// tree: the _Planner.plan closures, _plan_row, _plan_condition and
// _existence (pilosa_tpu/executor/compile.py:1334, :1387, :1444, :1282),
// run by QueryCompiler.count_async (:1656, with ops.popcount_rows) and
// QueryCompiler.bitmap_device (:1640), and the BSI compare/between of
// pilosa_tpu/ops/bsi.py:38-110 that those programs vmap over the shards.
// The planner here compiles the tree to a postfix program once per tree
// shape (row ids are inputs, so one program serves every row id); the
// program format, its opcodes and TreeArgs are tree_interp.cuh's.
//
// Bound on the H100: bytes. Each leaf plane is read once and nothing else
// touches device memory in count mode, so the least time is
// leaves * S * W * 4 bytes over 3.35 TB/s (a condition counts its 2 + D
// planes); words mode adds the [S, W] words written once.
//
// Design: a warp-specialised persistent kernel. The plane is cut into
// tiles of TE_TILE vectors (16 B each); each block walks its tiles in
// turn, one block per SM. Per block, one producer thread streams
// the program's plane operands, tile after tile and in program order
// (every non-null TE_LOAD leaf; each TE_CMP condition's existence, sign
// and magnitude planes below its height, MSB first), into a ring of
// TE_STAGES shared-memory chunks of one plane's tile each, with 1-D bulk
// asynchronous copies and a full / empty mbarrier pair per chunk
// (bulk.cuh). The consumer warps walk the same program over the tile:
// each LOAD or condition plane takes the next chunk of the ring and
// frees it once read, so a program of any size streams through a fixed
// ring (256 leaves, 16 conditions of 65 planes) with many KB in flight
// per SM and no load waiting on the interpreter. Each consumer thread
// holds TE_V vectors of the tile: the top two entries of its operand
// stack stay in registers (a two-leaf Intersect never leaves them), the
// entries below in a local array that no load waits on.
// TE_ZERO and null leaves read as zero words with no copy; sparse and
// run leaves are decoded by the consumers from their L1-resident
// payloads (tree_interp.cuh), a warp-wide search per tile narrowing the
// payload to the tile's ids or runs before each vector's own search. Count mode adds the
// popcounts in registers, reduces them per block and issues one atomic
// per block; words mode stores the vectors from registers, 16 B per
// thread, neighbouring threads on neighbouring addresses.
//
// te_eval (tree_interp.cuh), the one-vector interpreter, stays the fused
// filters' of K2, K4 and K5.
#include "bulk.cuh"
#include "tree_interp.cuh"

#define TE_TILE 1024  // vectors of a tile: a ring chunk is 16 KB
#define TE_STAGES 8    // chunks in the ring: 128 KB, one block an SM
#define TE_CONSUMER_WARPS 8
#define TE_CONSUMERS (TE_CONSUMER_WARPS * 32)
#define TE_THREADS (TE_CONSUMERS + 32)  // and one producer warp
#define TE_V (TE_TILE / TE_CONSUMERS)   // vectors a consumer thread holds
#define TE_RING_BYTES (TE_STAGES * TE_TILE * 16)

static_assert(TE_TILE % TE_CONSUMERS == 0, "a tile splits evenly over the consumers");
static_assert(TE_RING_BYTES <= 232448 - 1024, "the ring fits a block's shared memory");

struct TeRing {
  uint4* buf;                 // [TE_STAGES][TE_TILE]
  unsigned long long* full;   // chunk landed: one arrival and its bytes
  unsigned long long* empty;  // chunk read: one arrival per consumer warp
  unsigned j;                 // chunks put (producer) or taken (consumer)
};

// The planes of condition c in the order both sides walk them: existence,
// sign, then magnitude planes D-1 .. 0 (none when |c| >= 2^D). q-th
// plane's index in the BSI stack; one at or past `present` reads zero.
__device__ __forceinline__ int te_cmp_planes(const TreeCond& c) {
  return c.big ? 2 : 2 + (int)c.depth;
}
__device__ __forceinline__ int te_cmp_plane(const TreeCond& c, int q) {
  return q < 2 ? q : 2 + (int)c.depth - 1 - (q - 2);
}

// ------------------------------------------------------------ producer
__device__ __forceinline__ void te_put(TeRing& r, const uint4* src,
                                       unsigned bytes) {
  const unsigned s = r.j % TE_STAGES;
  pt_mbar_wait(r.empty + s, ((r.j / TE_STAGES) & 1u) ^ 1u);
  pt_mbar_expect_tx(r.full + s, bytes);
  pt_bulk_load(r.buf + (size_t)s * TE_TILE, src, bytes, r.full + s);
  ++r.j;
}

__device__ void te_produce(const TreeArgs& a, TeRing& r, long long n_vec) {
  const long long n_tiles = (n_vec + TE_TILE - 1) / TE_TILE;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long base = t * TE_TILE;
    const long long n = n_vec - base < TE_TILE ? n_vec - base : TE_TILE;
    const unsigned bytes = (unsigned)(n * 16);
    for (int k = 0; k < a.n_ops; ++k) {
      const int op = a.op[k];
      if (op == TE_LOAD) {
        const uint4* plane = a.leaf[a.arg[k]];
        if (plane != nullptr) te_put(r, plane + base, bytes);
      } else if (op == TE_CMP) {
        const TreeCond& c = a.cond[a.arg[k]];
        for (int q = 0; q < te_cmp_planes(c); ++q) {
          const int p = te_cmp_plane(c, q);
          if (p < c.present) te_put(r, c.base + (long long)p * c.stride + base, bytes);
        }
      }
    }
  }
}

// ------------------------------------------------------------ consumers
// The next chunk's TE_V vectors of this thread, then the chunk is freed.
__device__ __forceinline__ void te_take(TeRing& r, uint4 (&v)[TE_V]) {
  const unsigned s = r.j % TE_STAGES;
  pt_mbar_wait(r.full + s, (r.j / TE_STAGES) & 1u);
  const uint4* src = r.buf + (size_t)s * TE_TILE + threadIdx.x;
#pragma unroll
  for (int u = 0; u < TE_V; ++u) v[u] = src[u * TE_CONSUMERS];
  // these generic-proxy reads come before the bulk copy that refills the
  // chunk (async proxy): without the fence that copy may land first
  pt_fence_async_smem();
  __syncwarp();
  if ((threadIdx.x & 31) == 0) pt_mbar_arrive(r.empty + s);
  ++r.j;
}

__device__ __forceinline__ void te_take_or_zero(TeRing& r, bool staged,
                                                uint4 (&v)[TE_V]) {
  if (staged) {
    te_take(r, v);
  } else {
#pragma unroll
    for (int u = 0; u < TE_V; ++u) v[u] = pt_zero4();
  }
}

// te_compare over the tile, its planes taken from the ring.
__device__ __forceinline__ void te_take_compare(const TreeCond& c, TeRing& r,
                                                uint4 (&out)[TE_V]) {
  uint4 ex[TE_V], sg[TE_V], eq[TE_V], lt[TE_V], gt[TE_V], bit[TE_V];
  te_take_or_zero(r, 0 < c.present, ex);
  te_take_or_zero(r, 1 < c.present, sg);
#pragma unroll
  for (int u = 0; u < TE_V; ++u) {
    eq[u] = c.big ? pt_zero4() : pt_ones4();
    lt[u] = c.big ? pt_ones4() : pt_zero4();
    gt[u] = pt_zero4();
  }
  for (int q = 2; q < te_cmp_planes(c); ++q) {
    const int p = te_cmp_plane(c, q);
    te_take_or_zero(r, p < c.present, bit);
    const bool c_bit = (c.c_abs >> (p - 2)) & 1ull;
#pragma unroll
    for (int u = 0; u < TE_V; ++u) te_cmp_step(c_bit, bit[u], eq[u], lt[u], gt[u]);
  }
#pragma unroll
  for (int u = 0; u < TE_V; ++u) out[u] = te_cmp_select(c, ex[u], sg[u], eq[u], lt[u], gt[u]);
}

// First index in [lo, hi) where `pred`, true on a prefix of the range,
// is false (hi if none): the warp's 32 lanes probe 32 points a round, so
// a payload of 2,048 ids takes three dependent loads, not eleven.
template <typename P>
__device__ __forceinline__ int te_warp_find(int lo, int hi, P pred) {
  const int lane = threadIdx.x & 31;
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const int at = lo + lane * step;
    const int c = __popc(__ballot_sync(0xffffffffu, at < hi && pred(at)));
    const int next_hi = lo + c * step < hi ? lo + c * step : hi;
    lo = c == 0 ? lo : lo + (c - 1) * step + 1;
    hi = next_hi;
  }
  const int at = lo + lane;
  return lo + __popc(__ballot_sync(0xffffffffu, at < hi && pred(at)));
}

// A sparse or run leaf over the tile: the warp narrows the payload to the
// ids or runs that reach the tile, then each vector searches that window
// alone (most tiles hold none of a sparse row's ids).
__device__ __forceinline__ void te_container(const TreeArgs& a, int op,
                                             const void* payload,
                                             long long base,
                                             uint4 (&out)[TE_V]) {
  if (payload == nullptr) {
#pragma unroll
    for (int u = 0; u < TE_V; ++u) out[u] = pt_zero4();
    return;
  }
  // plane bits are < 2^31 (ops/bitwise.py), so the tile's end fits 32 bits
  const long long b_lo = base * 128, b_hi = (base + TE_TILE) * 128;
  if (op == TE_LOAD_SPARSE) {
    const int* ids = (const int*)payload;
    const int lo = te_warp_find(0, a.sparse_cap, [&](int k) { return (unsigned)__ldg(ids + k) < (unsigned)b_lo; });
    const int hi = te_warp_find(lo, a.sparse_cap, [&](int k) { return (unsigned)__ldg(ids + k) < (unsigned)b_hi; });
#pragma unroll
    for (int u = 0; u < TE_V; ++u) {
      out[u] = te_sparse_in(ids, lo, hi, base + threadIdx.x + u * TE_CONSUMERS);
    }
  } else {
    const int2* runs = (const int2*)payload;
    const int n = te_warp_find(0, a.run_cap, [&](int k) { const int2 iv = __ldg(runs + k); return iv.y > iv.x; });
    const int lo = te_warp_find(0, n, [&](int k) { return (long long)__ldg(runs + k).y <= b_lo; });
    // runs past the first that ends beyond the tile do not reach it
    const int last = te_warp_find(lo, n, [&](int k) { return (long long)__ldg(runs + k).y <= b_hi; });
    const int hi = last < n ? last + 1 : n;
#pragma unroll
    for (int u = 0; u < TE_V; ++u) {
      out[u] = te_run_in(runs, lo, hi, base + threadIdx.x + u * TE_CONSUMERS);
    }
  }
}

template <bool COUNT>
__device__ void te_consume(const TreeArgs& a, TeRing& r, long long n_vec,
                           uint4* __restrict__ out_words,
                           unsigned long long& acc) {
  // the stack: its top two entries in registers, the rest below them
  uint4 st[TE_MAX_STACK - 2][TE_V];
  const long long n_tiles = (n_vec + TE_TILE - 1) / TE_TILE;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long base = t * TE_TILE;
    uint4 top[TE_V], nxt[TE_V], x[TE_V];
#pragma unroll
    for (int u = 0; u < TE_V; ++u) top[u] = nxt[u] = pt_zero4();
    int sp = 0;  // entries: top is entry sp - 1, nxt entry sp - 2
    for (int k = 0; k < a.n_ops; ++k) {
      const int op = a.op[k];
      if (op == TE_LOAD || op == TE_ZERO || op >= TE_CMP) {
        if (op == TE_LOAD) {
          te_take_or_zero(r, a.leaf[a.arg[k]] != nullptr, x);
        } else if (op == TE_ZERO) {
#pragma unroll
          for (int u = 0; u < TE_V; ++u) x[u] = pt_zero4();
        } else if (op == TE_CMP) {
          te_take_compare(a.cond[a.arg[k]], r, x);
        } else {
          te_container(a, op, a.leaf[a.arg[k]], base, x);
        }
#pragma unroll
        for (int u = 0; u < TE_V; ++u) {
          if (sp >= 2) st[sp - 2][u] = nxt[u];
          nxt[u] = top[u];
          top[u] = x[u];
        }
        ++sp;
      } else {
#pragma unroll
        for (int u = 0; u < TE_V; ++u) {
          const uint4 p = nxt[u];
          const uint4 q = top[u];
          if (op == TE_AND) {
            top[u] = pt_and4(p, q);
          } else if (op == TE_OR) {
            top[u] = pt_or4(p, q);
          } else if (op == TE_XOR) {
            top[u] = make_uint4(p.x ^ q.x, p.y ^ q.y, p.z ^ q.z, p.w ^ q.w);
          } else {
            top[u] = pt_andn4(p, q);
          }
          if (sp >= 3) nxt[u] = st[sp - 3][u];
        }
        --sp;
      }
    }
#pragma unroll
    for (int u = 0; u < TE_V; ++u) {
      const long long i = base + threadIdx.x + u * TE_CONSUMERS;
      if (i < n_vec) {
        if (COUNT) {
          acc += pt_popc4(top[u]);
        } else {
          out_words[i] = top[u];
        }
      }
    }
  }
}

template <bool COUNT>
__global__ void __launch_bounds__(TE_THREADS)
    tree_ring_kernel(const __grid_constant__ TreeArgs a, long long n_vec,
                     uint4* __restrict__ out_words,
                     unsigned long long* __restrict__ out_count) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) unsigned long long full[TE_STAGES];
  __shared__ __align__(8) unsigned long long empty[TE_STAGES];
  __shared__ unsigned long long warp_sum[TE_CONSUMER_WARPS];
  if (threadIdx.x == 0) {
    for (int s = 0; s < TE_STAGES; ++s) {
      pt_mbar_init(&full[s], 1);
      pt_mbar_init(&empty[s], TE_CONSUMER_WARPS);
    }
    pt_mbar_init_fence();
  }
  __syncthreads();
  TeRing r{(uint4*)smem, full, empty, 0u};
  const int warp = threadIdx.x >> 5;
  if (warp == TE_CONSUMER_WARPS) {
    if ((threadIdx.x & 31) == 0) te_produce(a, r, n_vec);
    return;
  }
  unsigned long long acc = 0;
  te_consume<COUNT>(a, r, n_vec, out_words, acc);
  if (COUNT) {
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
    if ((threadIdx.x & 31) == 0) warp_sum[warp] = acc;
    // the consumers only: the producer warp has left
    asm volatile("bar.sync 1, %0;" ::"n"(TE_CONSUMERS) : "memory");
    if (threadIdx.x == 0) {
      unsigned long long sum = 0;
      for (int w = 0; w < TE_CONSUMER_WARPS; ++w) sum += warp_sum[w];
      if (sum != 0) atomicAdd(out_count, sum);
    }
  }
}

// Every plane the ring copies starts on a 16 B boundary.
static bool te_ring_aligned(const TreeArgs* a) {
  for (int k = 0; k < a->n_ops; ++k) {
    if (a->op[k] == TE_LOAD && !pt_aligned16(a->leaf[a->arg[k]])) return false;
  }
  for (int c = 0; c < a->n_conds; ++c) {
    if (!pt_aligned16(a->cond[c].base)) return false;
  }
  return true;
}

// n_vec = S * W / 4. Exactly one of out_words (int32[S, W], 16 B aligned)
// and out_count (a zeroed int64 scalar) is non-null. Returns
// cudaGetLastError().
PT_EXPORT int tree_eval(const TreeArgs* args, long long n_vec,
                        void* out_words, void* out_count, void* stream) {
  if (n_vec <= 0 || !tree_program_ok(args, n_vec) ||
      (out_words == nullptr) == (out_count == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (!te_ring_aligned(args) || !pt_aligned16(out_words)) {
    return (int)cudaErrorMisalignedAddress;
  }
  const bool count = out_count != nullptr;
  const int cap = count ? pt_persistent_blocks(tree_ring_kernel<true>, TE_THREADS, TE_RING_BYTES)
                        : pt_persistent_blocks(tree_ring_kernel<false>, TE_THREADS, TE_RING_BYTES);
  if (cap <= 0) return -cap;
  const long long n_tiles = (n_vec + TE_TILE - 1) / TE_TILE;
  const int grid = (int)(n_tiles < cap ? n_tiles : cap);
  cudaStream_t s = (cudaStream_t)stream;
  if (count) {
    tree_ring_kernel<true><<<grid, TE_THREADS, TE_RING_BYTES, s>>>(
        *args, n_vec, nullptr, (unsigned long long*)out_count);
  } else {
    tree_ring_kernel<false><<<grid, TE_THREADS, TE_RING_BYTES, s>>>(
        *args, n_vec, (uint4*)out_words, nullptr);
  }
  return (int)cudaGetLastError();
}
