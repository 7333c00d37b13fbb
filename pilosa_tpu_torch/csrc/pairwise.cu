// K11: all-pairs intersection counts, Tanimoto or cosine, with the
// epilogue fused.
//
// Replaces pilosa_tpu/ops/similarity.py:51 pairwise_intersections (with
// _unpack_bits_bf16, :44) and the epilogues of tanimoto_matrix (:63) and
// cosine_matrix (:72) (B14): out[i, j] over a uint32[N, W] and b
// uint32[M, W] is, by mode,
//   0 inter:    |a_i ∩ b_j|
//   1 tanimoto: inter / ((|a_i| + |b_j|) - inter), 0 where that is 0
//   2 cosine:   inter / sqrt(|a_i| * |b_j|), 0 where that is 0
// in f32, rounded as the reference's program (counts cast to f32, IEEE
// division and square root; the intrinsics keep nvcc from contracting a
// product into a sum). The reference unpacks the bits to bf16 and takes
// one matrix product; here each count is AND + popcount of the packed
// words, exact in 32 bits, and the [N, M] counts are never written out
// and read back.
//
// Bound on the H100: operations. The unpacked product is 2 * N * M * 32W
// operations, 0.56 ms at the int8 tensor rate for N = M = 16,384 and
// 2048-bit rows, against 0.32 ms to write the f32 output. This design is
// the simple one: a 64 x 64 output tile per 256-thread block, 4 x 4
// outputs per thread, a and b tiles of 32 words in shared memory (rows
// padded to 36 words, so the 16 B reads of 8 threads hit distinct
// banks), and AND + __popc into int32 per thread. It runs on the
// popcount pipe, not the tensor cores; the row counts |a_i|, |b_j| come
// from the same tiles. Any W, any alignment: the tiles load 4 B words.
#include "common.cuh"

#define PW_TILE 64  // output rows and columns per block
#define PW_WK 32    // words per shared tile row
#define PW_LD (PW_WK + 4)
#define PW_INTER 0
#define PW_TANIMOTO 1
#define PW_COSINE 2

__global__ void __launch_bounds__(PT_BLOCK)
    pairwise_kernel(const unsigned* __restrict__ a, long long n,
                    const unsigned* __restrict__ b, long long m,
                    long long n_words, int mode, float* __restrict__ out) {
  __shared__ __align__(16) unsigned sa[PW_TILE * PW_LD];
  __shared__ __align__(16) unsigned sb[PW_TILE * PW_LD];
  __shared__ unsigned s_pop[2 * PW_TILE];  // |a| of the tile's rows, then |b|
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long long row0 = (long long)blockIdx.y * PW_TILE;
  const long long col0 = (long long)blockIdx.x * PW_TILE;
  unsigned acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0u;
  }
  unsigned pop = 0u;  // threads 0-127: the popcount of one tile row
  for (long long w0 = 0; w0 < n_words; w0 += PW_WK) {
#pragma unroll
    for (int i = 0; i < PW_TILE * PW_WK / PT_BLOCK; ++i) {
      const int idx = threadIdx.x + PT_BLOCK * i;
      const int r = idx / PW_WK, c = idx % PW_WK;
      const long long w = w0 + c;
      const bool in_w = w < n_words;
      sa[r * PW_LD + c] = in_w && row0 + r < n ? a[(row0 + r) * n_words + w] : 0u;
      sb[r * PW_LD + c] = in_w && col0 + r < m ? b[(col0 + r) * n_words + w] : 0u;
    }
    __syncthreads();
    if (mode != PW_INTER && threadIdx.x < 2 * PW_TILE) {
      const unsigned* s = threadIdx.x < PW_TILE ? sa + threadIdx.x * PW_LD
                                                : sb + (threadIdx.x - PW_TILE) * PW_LD;
#pragma unroll
      for (int c = 0; c < PW_WK; ++c) pop += __popc(s[c]);
    }
#pragma unroll
    for (int c = 0; c < PW_WK; c += 4) {
      uint4 x[4], y[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x[i] = *reinterpret_cast<const uint4*>(&sa[(ty + 16 * i) * PW_LD + c]);
        y[i] = *reinterpret_cast<const uint4*>(&sb[(tx + 16 * i) * PW_LD + c]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += pt_popc4(pt_and4(x[i], y[j]));
      }
    }
    __syncthreads();
  }
  if (threadIdx.x < 2 * PW_TILE) s_pop[threadIdx.x] = pop;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long r = row0 + ty + 16 * i;
    if (r >= n) continue;
    const float fa = __uint2float_rn(s_pop[ty + 16 * i]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long c = col0 + tx + 16 * j;
      if (c >= m) continue;
      const float fi = __uint2float_rn(acc[i][j]);
      float v = fi;
      if (mode == PW_TANIMOTO) {
        const float fb = __uint2float_rn(s_pop[PW_TILE + tx + 16 * j]);
        const float uni = __fsub_rn(__fadd_rn(fa, fb), fi);
        v = uni > 0.f ? __fdiv_rn(fi, uni) : 0.f;
      } else if (mode == PW_COSINE) {
        const float fb = __uint2float_rn(s_pop[PW_TILE + tx + 16 * j]);
        const float den = __fsqrt_rn(__fmul_rn(fa, fb));
        v = den > 0.f ? __fdiv_rn(fi, den) : 0.f;
      }
      out[r * m + c] = v;
    }
  }
}

// a: int32[n, W]; b: int32[m, W]; out: f32[n, m]; mode 0 inter, 1
// tanimoto, 2 cosine. Returns cudaGetLastError().
PT_EXPORT int pairwise(const void* a, long long n, const void* b, long long m,
                       long long n_words, int mode, void* out, void* stream) {
  const long long tiles_n = (n + PW_TILE - 1) / PW_TILE;
  const long long tiles_m = (m + PW_TILE - 1) / PW_TILE;
  if (n < 1 || m < 1 || n_words < 1 || n_words > (1ll << 19) ||
      tiles_n > 65535 || tiles_m > 0x7fffffffLL || mode < PW_INTER ||
      mode > PW_COSINE) {
    return (int)cudaErrorInvalidValue;
  }
  dim3 grid((unsigned)tiles_m, (unsigned)tiles_n);
  pairwise_kernel<<<grid, PT_BLOCK, 0, (cudaStream_t)stream>>>(
      (const unsigned*)a, n, (const unsigned*)b, m, n_words, mode, (float*)out);
  return (int)cudaGetLastError();
}
