// K12: the elementwise finish of the mesh engine's similarity and top-k
// programs, run on the reduced counts.
//
// Replaces the score lines of pilosa_tpu/parallel/mesh.py (B16):
//
// - mesh_sim_keys: the Tanimoto (:684-688) and cosine (:726-733) scores
//   of the one-vs-all search, from the counts the reduction tree summed
//   over the words and then the shards axis: inter = |a ∩ q| and
//   row_pop = |a| as int64[R], q_pop = |q| as one int64. Rounded as the
//   reference's f32 program: each count cast to f32 (round to nearest),
//     tanimoto: (f32(row_pop) + f32(q_pop)) - f32(inter), then the
//               division, 0 where the union is not > 0;
//     cosine:   sqrt(f32(row_pop) * f32(q_pop)), the product rounded to
//               f32 before the root, then the division, 0 where the
//               root is not > 0.
//   Each score becomes K10's sortable key, (score bits) << 32 |
//   (2^32 - 1 - row), as csrc/similarity_scan.cu's K9 writes it, and the
//   first-digit histogram K10 starts from counts key >> 52 (a score's
//   bits are below 2^31, so the digit is below 2^11). K10 then takes the
//   reference's lax.top_k (:690, :735).
// - mesh_pairwise_finish: the all-pairs epilogue (:796-800) on the
//   intersection counts summed over the words axis, inter f32[N, M],
//   with a_pop f32[N] and b_pop f32[M]: Tanimoto or cosine, rounded as
//   K11's fused modes (csrc/pairwise.cu).
//
// - count_keys: the keys of an integer top-k (the lax.top_k of int64 row
//   counts at mesh.py:647-652, and of ops/topn.py:24 top_rows): the count
//   alone with its sign bit flipped, key = count ^ 2^63, which orders as
//   uint64 as the int64 counts do, over their whole range. Equal counts
//   give equal keys: K10's int mode takes their ties in row order (the
//   row is the key's index), as lax.top_k breaks them. The first-digit
//   histogram (key >> 52) is written as mesh_sim_keys writes it.
//
// The scores and keys are sim_score.cuh's, which K10's small sim route
// shares: the search's finish takes that route (one launch, no keys in
// global memory) up to 4,096 rows, and this entry only past them.
// Bound on the H100: bytes. Both passes read their counts once and write
// their output once; the search's histogram is one shared-memory
// atomic per row and one global atomic per non-empty bin and block.
#include "common.cuh"
#include "sim_score.cuh"

#define MF_BINS 4096
#define MF_FIRST_SHIFT 52

typedef unsigned long long u64;

__global__ void __launch_bounds__(PT_BLOCK)
    mesh_sim_keys_kernel(const long long* __restrict__ inter,
                         const long long* __restrict__ row_pop,
                         const long long* __restrict__ q_pop, long long n,
                         int metric, u64* __restrict__ keys,
                         unsigned* __restrict__ hist) {
  __shared__ unsigned s_hist[MF_BINS];
  for (int i = threadIdx.x; i < MF_BINS; i += PT_BLOCK) s_hist[i] = 0u;
  __syncthreads();
  const float fq = __ll2float_rn(*q_pop);
  const long long step = (long long)gridDim.x * PT_BLOCK;
  for (long long row = (long long)blockIdx.x * PT_BLOCK + threadIdx.x;
       row < n; row += step) {
    const u64 key = sim_score_key(
        sim_metric_score(__ll2float_rn(inter[row]),
                         __ll2float_rn(row_pop[row]), fq, metric),
        row);
    keys[row] = key;
    atomicAdd(&s_hist[(unsigned)(key >> MF_FIRST_SHIFT)], 1u);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < MF_BINS; i += PT_BLOCK) {
    if (s_hist[i]) atomicAdd(&hist[i], s_hist[i]);
  }
}

__global__ void __launch_bounds__(PT_BLOCK)
    mesh_pairwise_finish_kernel(const float* __restrict__ inter,
                                const float* __restrict__ a_pop,
                                const float* __restrict__ b_pop, long long n,
                                long long m, int metric,
                                float* __restrict__ out) {
  const long long total = n * m;
  const long long step = (long long)gridDim.x * PT_BLOCK;
  for (long long i = (long long)blockIdx.x * PT_BLOCK + threadIdx.x;
       i < total; i += step) {
    const long long r = i / m, c = i - r * m;
    out[i] = sim_metric_score(inter[i], a_pop[r], b_pop[c], metric);
  }
}

__global__ void __launch_bounds__(PT_BLOCK)
    count_keys_kernel(const long long* __restrict__ counts, long long n,
                      u64* __restrict__ keys, unsigned* __restrict__ hist) {
  __shared__ unsigned s_hist[MF_BINS];
  for (int i = threadIdx.x; i < MF_BINS; i += PT_BLOCK) s_hist[i] = 0u;
  __syncthreads();
  const long long step = (long long)gridDim.x * PT_BLOCK;
  for (long long row = (long long)blockIdx.x * PT_BLOCK + threadIdx.x;
       row < n; row += step) {
    const u64 key = (u64)counts[row] ^ (1ull << 63);
    keys[row] = key;
    atomicAdd(&s_hist[(unsigned)(key >> MF_FIRST_SHIFT)], 1u);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < MF_BINS; i += PT_BLOCK) {
    if (s_hist[i]) atomicAdd(&hist[i], s_hist[i]);
  }
}

static unsigned mf_grid(long long items) {
  long long blocks = (items + PT_BLOCK - 1) / PT_BLOCK;
  if (blocks > pt_resident_blocks()) blocks = pt_resident_blocks();
  return (unsigned)(blocks < 1 ? 1 : blocks);
}

// inter, row_pop: int64[R]; q_pop: int64[1]; metric 0 Tanimoto, 1 cosine;
// keys: int64[R]; hist: zeroed int32[4096]. Returns cudaGetLastError().
PT_EXPORT int mesh_sim_keys(const void* inter, const void* row_pop,
                            const void* q_pop, long long n, int metric,
                            void* keys, void* hist, void* stream) {
  if (n < 0 || n > 0x7fffffffLL ||
      (metric != SIM_METRIC_TANIMOTO && metric != SIM_METRIC_COSINE)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return (int)cudaGetLastError();
  mesh_sim_keys_kernel<<<mf_grid(n), PT_BLOCK, 0, (cudaStream_t)stream>>>(
      (const long long*)inter, (const long long*)row_pop,
      (const long long*)q_pop, n, metric, (u64*)keys, (unsigned*)hist);
  return (int)cudaGetLastError();
}

// inter: f32[N, M]; a_pop: f32[N]; b_pop: f32[M]; metric 0 Tanimoto,
// 1 cosine; out: f32[N, M]. Returns cudaGetLastError().
PT_EXPORT int mesh_pairwise_finish(const void* inter, const void* a_pop,
                                   const void* b_pop, long long n, long long m,
                                   int metric, void* out, void* stream) {
  if (n < 0 || m < 0 ||
      (metric != SIM_METRIC_TANIMOTO && metric != SIM_METRIC_COSINE)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0 || m == 0) return (int)cudaGetLastError();
  mesh_pairwise_finish_kernel<<<mf_grid(n * m), PT_BLOCK, 0,
                                (cudaStream_t)stream>>>(
      (const float*)inter, (const float*)a_pop, (const float*)b_pop, n, m,
      metric, (float*)out);
  return (int)cudaGetLastError();
}

// counts: int64[n]; keys: int64[n]; hist: zeroed int32[4096]. Returns
// cudaGetLastError().
PT_EXPORT int count_keys(const void* counts, long long n, void* keys,
                         void* hist, void* stream) {
  if (n < 0 || n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  count_keys_kernel<<<mf_grid(n), PT_BLOCK, 0, (cudaStream_t)stream>>>(
      (const long long*)counts, n, (u64*)keys, (unsigned*)hist);
  return (int)cudaGetLastError();
}
