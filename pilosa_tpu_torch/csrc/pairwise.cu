// K11: all-pairs intersection counts, Tanimoto or cosine, with the
// epilogue fused, on the tensor cores.
//
// Replaces pilosa_tpu/ops/similarity.py:51 pairwise_intersections (with
// _unpack_bits_bf16, :44) and the epilogues of tanimoto_matrix (:63) and
// cosine_matrix (:72) (B14, B14-mm): out[i, j] over a uint32[N, W] and b
// uint32[M, W] is, by mode,
//   0 inter:    |a_i ∩ b_j|
//   1 tanimoto: inter / ((|a_i| + |b_j|) - inter), 0 where that is 0
//   2 cosine:   inter / sqrt(|a_i| * |b_j|), 0 where that is 0
// in f32, rounded as the reference's program (counts cast to f32, IEEE
// division and square root; the intrinsics keep nvcc from contracting a
// product into a sum). The reference unpacks the bits to bf16 and takes
// one matrix product on the matrix unit; here the product runs on the
// packed words with the tensor cores' binary MMA,
// mma.m16n8k256.row.col.s32.b1.b1.s32.and.popc (bmma.cuh): AND, then
// popcount, of 256-bit slices, summed into int32 (exact), so nothing is
// unpacked and the [N, M] counts are never written out and read back.
//
// Bound on the H100: the unpacked product is 2 * N * M * 32W operations,
// 0.56 ms at the int8 tensor rate for N = M = 16,384 and 2048-bit rows,
// against 0.32 ms to write the f32 output (NVIDIA publishes no b1 rate).
// Design: a 128 x 128 output tile per 256-thread block, eight warps of
// 64 x 32, each a 4 x 4 grid of m16n8 MMAs per 256-bit k-step. The a and
// b tiles are 16 words deep (two k-steps), double-buffered in shared
// memory and filled with cp.async: 16 B copies when the rows are 16 B
// aligned (W % 4 == 0), 4 B copies otherwise, zero-filled past W, N and M
// (a zero word adds nothing to a count). Rows are padded to 20 words, so
// the ldmatrix reads (eight rows of 16 B, the b16 view of the words) hit
// distinct banks. The row counts |a_i|, |b_j| come from the same tiles.
// The epilogue stages each warp's 16 x 32 slab of f32 through shared
// memory and writes it a 128 B row at a time. The grid is one dimension
// over the tiles, so N takes any int32 row count.
#include "bmma.cuh"

#define PW_BM 128    // output rows per block
#define PW_BN 128    // output columns per block
#define PW_BK 16     // words per shared tile row: two 256-bit k-steps
#define PW_LD 20     // padded row stride of a tile, in words
#define PW_OUT_LD 40  // padded row stride of the epilogue's staging, in floats
#define PW_TILE_WORDS (PW_BM * PW_LD)
#define PW_INTER 0
#define PW_TANIMOTO 1
#define PW_COSINE 2

static_assert(PW_BM == PW_BN, "one loader serves both tiles");
static_assert(8 * 16 * PW_OUT_LD <= 4 * PW_TILE_WORDS, "the epilogue's staging fits the tiles");

// One cp.async of `bytes` (16 or 4); `take` false zero-fills the
// destination and reads nothing.
template <int BYTES>
__device__ __forceinline__ void pw_copy(unsigned dst, const void* src, bool take) {
  const int n = take ? BYTES : 0;
  if (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(n));
  }
}

__device__ __forceinline__ void pw_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void pw_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Fill one stage: the 128 x 16-word slices of a's rows row0.. and b's rows
// col0.. at words w0.., zeros past the ends. VEC 4: 16 B copies (W % 4
// == 0, 16 B aligned rows); VEC 1: 4 B copies.
template <int VEC>
__device__ __forceinline__ void pw_load(unsigned* sa, unsigned* sb, const unsigned* __restrict__ a,
                                        long long n, const unsigned* __restrict__ b, long long m,
                                        long long n_words, long long row0, long long col0,
                                        long long w0) {
  constexpr int PER_ROW = PW_BK / VEC;  // copies per tile row
  constexpr int PER_THREAD = PW_BM * PER_ROW / PT_BLOCK;
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const int idx = threadIdx.x + PT_BLOCK * i;
    const int r = idx / PER_ROW, c = (idx % PER_ROW) * VEC;
    const long long w = w0 + c;
    const bool in_w = w < n_words;
    const bool in_a = in_w && row0 + r < n, in_b = in_w && col0 + r < m;
    const unsigned* pa = a + (in_a ? (row0 + r) * n_words + w : 0);
    const unsigned* pb = b + (in_b ? (col0 + r) * n_words + w : 0);
    pw_copy<VEC * 4>(pt_smem(sa + r * PW_LD + c), pa, in_a);
    pw_copy<VEC * 4>(pt_smem(sb + r * PW_LD + c), pb, in_b);
  }
}

template <int VEC>
__global__ void __launch_bounds__(PT_BLOCK, 2)
    pairwise_kernel(const unsigned* __restrict__ a, long long n,
                    const unsigned* __restrict__ b, long long m,
                    long long n_words, long long tiles_m, int mode,
                    float* __restrict__ out) {
  // [stage][a, b][row * PW_LD + word]
  __shared__ __align__(128) unsigned s_tile[2][2][PW_TILE_WORDS];
  __shared__ float s_pop[PW_BM + PW_BN];  // |a| of the tile's rows, then |b|, in f32
  const long long tile = blockIdx.x;
  const long long row0 = (tile / tiles_m) * PW_BM;
  const long long col0 = (tile % tiles_m) * PW_BN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;  // the warp's 64 x 32 tile
  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
    }
  }
  unsigned pop = 0u;  // |a_i| (threads 0-127) or |b_j| (128-255) of one tile row
  const long long n_chunks = (n_words + PW_BK - 1) / PW_BK;
  pw_load<VEC>(s_tile[0][0], s_tile[0][1], a, n, b, m, n_words, row0, col0, 0);
  pw_commit();
  // ldmatrix rows: a's m16 tile as four 8 x 4-word matrices (rows 0-7 and
  // 8-15, words 0-3 and 4-7 of the k-step: a0-a3 of the fragment); b's two
  // n8 tiles as (rows 0-7, words 0-3 / 4-7), then rows 8-15 (b0, b1 of each)
  const int a_row = wm + (lane & 7) + ((lane >> 3) & 1) * 8, a_word = (lane >> 4) * 4;
  const int b_row = wn + (lane & 7) + (lane >> 4) * 8, b_word = ((lane >> 3) & 1) * 4;
  for (long long ch = 0; ch < n_chunks; ++ch) {
    const int st = (int)(ch & 1);
    if (ch + 1 < n_chunks) {
      pw_load<VEC>(s_tile[st ^ 1][0], s_tile[st ^ 1][1], a, n, b, m, n_words, row0, col0,
                   (ch + 1) * PW_BK);
      pw_commit();
      pw_wait<1>();
    } else {
      pw_wait<0>();
    }
    __syncthreads();
    const unsigned* sa = s_tile[st][0];
    const unsigned* sb = s_tile[st][1];
    if (mode != PW_INTER) {
      const uint4* row = reinterpret_cast<const uint4*>(
          threadIdx.x < PW_BM ? sa + threadIdx.x * PW_LD : sb + (threadIdx.x - PW_BM) * PW_LD);
#pragma unroll
      for (int v = 0; v < PW_BK / 4; ++v) pop += pt_popc4(row[v]);
    }
#pragma unroll
    for (int ks = 0; ks < PW_BK / 8; ++ks) {
      unsigned fa[4][4], fb[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pt_ldmatrix4(pt_smem(sa + (a_row + 16 * i) * PW_LD + ks * 8 + a_word), fa[i][0],
                     fa[i][1], fa[i][2], fa[i][3]);
      }
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        pt_ldmatrix4(pt_smem(sb + (b_row + 8 * j) * PW_LD + ks * 8 + b_word), fb[j][0],
                     fb[j][1], fb[j + 1][0], fb[j + 1][1]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) pt_bmma(acc[i][j], fa[i], fb[j]);
      }
    }
    __syncthreads();  // the next load overwrites this stage
  }
  s_pop[threadIdx.x] = __uint2float_rn(pop);
  __syncthreads();
  // epilogue: a fragment holds rows g and g + 8, columns 2t and 2t + 1 of
  // its m16n8 tile; each warp stages one 16 x 32 slab at a time
  float* stage = reinterpret_cast<float*>(&s_tile[0][0][0]) + warp * 16 * PW_OUT_LD;
  const int g = lane >> 2, t = lane & 3;
  const long long c = col0 + wn + lane;  // the column this lane writes
  const float fb_col = s_pop[PW_BM + wn + lane];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        *reinterpret_cast<float2*>(&stage[(g + 8 * h) * PW_OUT_LD + 8 * j + 2 * t]) =
            make_float2(__int2float_rn(acc[i][j][2 * h]), __int2float_rn(acc[i][j][2 * h + 1]));
      }
    }
    __syncwarp();
    long long r = row0 + wm + 16 * i;
    float* orow = out + r * m + c;
#pragma unroll 4
    for (int rr = 0; rr < 16; ++rr, ++r, orow += m) {
      const float fi = stage[rr * PW_OUT_LD + lane];
      const float fa = s_pop[wm + 16 * i + rr];
      float v = fi;
      if (mode == PW_TANIMOTO) {
        const float uni = __fsub_rn(__fadd_rn(fa, fb_col), fi);
        v = uni > 0.f ? __fdiv_rn(fi, uni) : 0.f;
      } else if (mode == PW_COSINE) {
        const float den = __fsqrt_rn(__fmul_rn(fa, fb_col));
        v = den > 0.f ? __fdiv_rn(fi, den) : 0.f;
      }
      if (r < n && c < m) *orow = v;
    }
    __syncwarp();
  }
}

// a: int32[n, W]; b: int32[m, W]; out: f32[n, m]; mode 0 inter, 1
// tanimoto, 2 cosine; vec: a and b 16 B aligned and W % 4 == 0. Returns
// cudaGetLastError().
PT_EXPORT int pairwise(const void* a, long long n, const void* b, long long m,
                       long long n_words, int mode, int vec, void* out, void* stream) {
  if (n < 1 || m < 1 || n > 0x7fffffffLL || m > 0x7fffffffLL || n_words < 1 ||
      n_words > (1ll << 19) || mode < PW_INTER || mode > PW_COSINE || (vec && n_words % 4)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long tiles_n = (n + PW_BM - 1) / PW_BM;
  const long long tiles_m = (m + PW_BN - 1) / PW_BN;
  if (tiles_n * tiles_m > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)(tiles_n * tiles_m);
  cudaStream_t s = (cudaStream_t)stream;
  if (vec) {
    pairwise_kernel<4><<<grid, PT_BLOCK, 0, s>>>((const unsigned*)a, n, (const unsigned*)b, m,
                                                 n_words, tiles_m, mode, (float*)out);
  } else {
    pairwise_kernel<1><<<grid, PT_BLOCK, 0, s>>>((const unsigned*)a, n, (const unsigned*)b, m,
                                                 n_words, tiles_m, mode, (float*)out);
  }
  return (int)cudaGetLastError();
}
