// K7: PQL Shift, one shard's word vector at a time.
//
// Replaces shift_words (pilosa_tpu/ops/bitwise.py:112), which the
// reference's Shift closure (pilosa_tpu/executor/compile.py:1375) applies
// inside the fused program: bit p of a shard moves to p + n, as a roll
// of q = n / 32 whole words plus an r = n % 32 bit carry from each word
// into the next. Bits moved past the end of a shard drop and never carry
// into the next shard; every shift is logical (the words are uint32 here,
// int32 views on the Python side). n >= 32 * W leaves zeros.
//
// Bound on the H100: bytes. The plane is read once and written once,
// 2 * S * W * 4 bytes over 3.35 TB/s. Each thread writes one 16-byte
// vector (4 words of one shard, since W is a multiple of 4) and reads the
// 5 source words it needs, words of neighbouring threads on neighbouring
// addresses, so the reads coalesce whatever q is; the overlap of one word
// between neighbours is served by L1.
#include "common.cuh"

__global__ void __launch_bounds__(PT_BLOCK)
    shift_words_kernel(const unsigned* __restrict__ in, uint4* __restrict__ out,
                       long long n_vec, long long w, long long q, int r) {
  const long long step = (long long)gridDim.x * PT_BLOCK;
  for (long long v = (long long)blockIdx.x * PT_BLOCK + threadIdx.x; v < n_vec;
       v += step) {
    const long long flat = v * 4;
    const long long j = flat % w;     // word of the shard the vector starts at
    const long long base = flat - j;  // the shard's word 0
    // src[u] = in word (j - q - 1 + u) of this shard, 0 outside it
    unsigned src[5];
#pragma unroll
    for (int u = 0; u < 5; ++u) {
      const long long s = j - q - 1 + u;
      src[u] = (s >= 0 && s < w) ? __ldg(in + base + s) : 0u;
    }
    unsigned o[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      o[u] = r ? (src[u + 1] << r) | (src[u] >> (32 - r)) : src[u + 1];
    }
    out[v] = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// in, out: int32[n_shards, w], out a fresh buffer; w a multiple of 4;
// n >= 0. Returns cudaGetLastError().
PT_EXPORT int shift_words(const void* in, void* out, long long n_shards,
                          long long w, long long n, void* stream) {
  if (n_shards <= 0 || w <= 0 || w % 4 || n < 0) {
    return (int)cudaErrorInvalidValue;
  }
  long long q = n / 32;
  if (q > w) q = w;  // every source word is past the end: zeros
  const int r = (int)(n % 32);
  const long long n_vec = n_shards * w / 4;
  long long want = (n_vec + PT_BLOCK - 1) / PT_BLOCK;
  const long long cap = pt_resident_blocks();
  const int grid = (int)(want < cap ? want : cap);
  shift_words_kernel<<<grid, PT_BLOCK, 0, (cudaStream_t)stream>>>(
      (const unsigned*)in, (uint4*)out, n_vec, w, q, r);
  return (int)cudaGetLastError();
}
