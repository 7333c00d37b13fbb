// The f32 Tanimoto and cosine of one pair from its counts, rounded as the
// reference's f32 program (pilosa_tpu/parallel/mesh.py:684-688 and
// :726-733): each count cast to f32 (round to nearest), then
//   tanimoto: (f32(|a|) + f32(|b|)) - f32(inter), then the division, 0
//             where the union is not > 0;
//   cosine:   sqrt(f32(|a|) * f32(|b|)), the product rounded to f32 before
//             the root, then the division, 0 where the root is not > 0.
// The intrinsics (__fadd_rn, __fmul_rn, __fsqrt_rn, __fdiv_rn) keep nvcc
// from contracting a product into a sum and give the IEEE results. K12
// (mesh_finish.cu) and K10's small sim route (similarity_scan.cu) share it.
#pragma once

#define SIM_METRIC_TANIMOTO 0
#define SIM_METRIC_COSINE 1

__device__ __forceinline__ float sim_metric_score(float fi, float fa, float fb, int metric) {
  if (metric == SIM_METRIC_TANIMOTO) {
    const float uni = __fsub_rn(__fadd_rn(fa, fb), fi);
    return uni > 0.f ? __fdiv_rn(fi, uni) : 0.f;
  }
  const float den = __fsqrt_rn(__fmul_rn(fa, fb));
  return den > 0.f ? __fdiv_rn(fi, den) : 0.f;
}

// K10's key of a score: its bits above the row order, 2^32 - 1 - row, so
// that equal scores take the lower row first.
__device__ __forceinline__ unsigned long long sim_score_key(float score, long long row) {
  return ((unsigned long long)__float_as_uint(score) << 32) |
         (unsigned long long)(0xffffffffu - (unsigned)row);
}
