// MixFP4 row quantizer (Algorithm 1) for sm_90a.
//
// Replaces: src/repro/kernels/mixfp4_quant.py :: mixfp4_quant_rows
//           (_quant_kernel, quant_block_kernel_math, _encode_nibbles,
//           _pack_scale).
//
// Bound: bytes.  Per 16-value block it reads 64 B of f32 and writes 9 B
// (8 payload bytes, 1 scale byte); the arithmetic (two candidate
// quantizations and their MSEs) is a few hundred flops per block, far
// below the card's compute rate.
//
// Design: one thread per 16-value block, all of the block in registers.
// A block is read as four 16-byte vector loads and written as one 8-byte
// payload store plus one scale byte, so a warp covers 32 consecutive blocks
// (two 256-wide KV rows) with coalesced traffic and no shared memory or
// synchronisation.  The output must be byte-exact with the reference, so:
//   * scales apply as reciprocal multiplies, as the reference does
//     (x * (1/s32), absmax * (1/6), absmax * (1/7), y * (1/s));
//   * the library is compiled with -fmad=false and the error terms use
//     explicit round-to-nearest intrinsics, so (q*s - x)^2 never fuses;
//   * rintf rounds half to even (jnp.round), never roundf;
//   * E4M3 rounding clamps to [0, 448] and converts with
//     __nv_cvt_float_to_fp8(.., __NV_SATFINITE, __NV_E4M3) (RNE);
//   * the per-block MSE sums the 16 squares as a fixed pairwise tree
//     (adjacent pairs, 16 -> 8 -> 4 -> 2 -> 1) and scales by 1/16, the
//     same order as the plain version in kernels/mixfp4_quant.py;
//   * a zero-magnitude scale emits byte 0x00, never 0x80.
#include <cuda_runtime.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float e4m3_rne(float x) {
  x = fminf(fmaxf(x, 0.0f), 448.0f);
  __nv_fp8_e4m3 v;
  v.__x = __nv_cvt_float_to_fp8(x, __NV_SATFINITE, __NV_E4M3);
  return static_cast<float>(v);
}

__device__ __forceinline__ uint8_t e4m3_bits(float x) {
  return static_cast<uint8_t>(
      __nv_cvt_float_to_fp8(x, __NV_SATFINITE, __NV_E4M3));
}

__device__ __forceinline__ float guard_scale(float s, float absmax) {
  if (absmax > 0.0f && s <= 0.0f) s = 0x1p-9f;
  return absmax > 0.0f ? s : 1.0f;
}

__device__ __forceinline__ float rne_e2m1(float a) {
  a = fminf(fmaxf(a, 0.0f), 6.0f);
  if (a < 2.0f) return __fmul_rn(rintf(__fmul_rn(a, 2.0f)), 0.5f);
  if (a < 4.0f) return rintf(a);
  return __fmul_rn(rintf(__fmul_rn(a, 0.5f)), 2.0f);
}

__device__ __forceinline__ float rne_int7(float a) {
  return fminf(fmaxf(rintf(a), 0.0f), 7.0f);
}

// sum of 16 values as the fixed adjacent-pairs tree
__device__ __forceinline__ float tree_sum16(float (&v)[16]) {
#pragma unroll
  for (int w = 8; w >= 1; w >>= 1) {
#pragma unroll
    for (int i = 0; i < w; ++i) v[i] = __fadd_rn(v[2 * i], v[2 * i + 1]);
  }
  return v[0];
}

__global__ void __launch_bounds__(256) quant_rows_kernel(
    const float* __restrict__ x, const float* __restrict__ s32,
    int s32_per_row, uint8_t* __restrict__ payload,
    uint8_t* __restrict__ scales, long long m, int k) {
  const int nb = k / 16;
  const long long gid = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  if (gid >= m * nb) return;
  const long long row = gid / nb;
  const int blk = static_cast<int>(gid % nb);
  const float inv = 1.0f / s32[s32_per_row ? row : 0];

  float xs[16];
  const float4* src =
      reinterpret_cast<const float4*>(x + row * k + blk * 16);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 v = src[i];
    xs[4 * i + 0] = __fmul_rn(v.x, inv);
    xs[4 * i + 1] = __fmul_rn(v.y, inv);
    xs[4 * i + 2] = __fmul_rn(v.z, inv);
    xs[4 * i + 3] = __fmul_rn(v.w, inv);
  }
  float absmax = 0.0f;
#pragma unroll
  for (int i = 0; i < 16; ++i) absmax = fmaxf(absmax, fabsf(xs[i]));

  // E2M1 branch (Alg. 1 lines 7-10) and E1M2 branch (lines 12-15)
  const float s2 = guard_scale(
      e4m3_rne(__fmul_rn(absmax, static_cast<float>(1.0 / 6.0))), absmax);
  const float s1 = guard_scale(
      e4m3_rne(__fmul_rn(absmax, static_cast<float>(1.0 / 7.0))), absmax);
  const float r2 = 1.0f / s2;
  const float r1 = 1.0f / s1;
  float q2[16], q1[16], e2[16], e1[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float y2 = __fmul_rn(xs[i], r2);
    const float m2 = rne_e2m1(fabsf(y2));
    q2[i] = y2 < 0.0f ? -m2 : m2;
    const float d2 = __fsub_rn(__fmul_rn(q2[i], s2), xs[i]);
    e2[i] = __fmul_rn(d2, d2);
    const float y1 = __fmul_rn(xs[i], r1);
    const float m1 = rne_int7(fabsf(y1));
    q1[i] = y1 < 0.0f ? -m1 : m1;
    const float d1 = __fsub_rn(__fmul_rn(q1[i], s1), xs[i]);
    e1[i] = __fmul_rn(d1, d1);
  }
  const float err2 = __fmul_rn(tree_sum16(e2), 0.0625f);
  const float err1 = __fmul_rn(tree_sum16(e1), 0.0625f);
  const bool t = err1 < err2;  // ties go to E2M1

  uint8_t nib[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float q = t ? q1[i] : q2[i];
    const float a = fabsf(q);
    const float idx = t ? a : (a < 2.0f ? a * 2.0f : (a < 6.0f ? a + 2.0f
                                                                : 7.0f));
    nib[i] = static_cast<uint8_t>((q < 0.0f ? 8 : 0) |
                                  static_cast<int>(idx));
  }
  uint32_t lo = 0, hi = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    lo |= static_cast<uint32_t>(nib[2 * j] | (nib[2 * j + 1] << 4)) << (8 * j);
    hi |= static_cast<uint32_t>(nib[8 + 2 * j] | (nib[9 + 2 * j] << 4))
          << (8 * j);
  }
  *reinterpret_cast<uint2*>(payload + row * (k / 2) + blk * 8) =
      make_uint2(lo, hi);
  const uint8_t mag = e4m3_bits(t ? s1 : s2) & 0x7F;
  scales[row * nb + blk] = mag == 0 ? 0 : (mag | (t ? 0x80 : 0));
}

}  // namespace

// x (M, K) f32 contiguous, 16-byte aligned, K % 16 == 0; s32 one f32 or M
// f32 (s32_per_row); payload (M, K/2) u8, scales (M, K/16) u8.
extern "C" int mixfp4_quant_rows(const float* x, const float* s32,
                                 int s32_per_row, uint8_t* payload,
                                 uint8_t* scales, long long m, int k,
                                 void* stream) {
  const long long nblocks = m * (k / 16);
  if (nblocks == 0) return 0;
  const int threads = 256;
  const unsigned grid = static_cast<unsigned>((nblocks + threads - 1) /
                                              threads);
  quant_rows_kernel<<<grid, threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      x, s32, s32_per_row, payload, scales, m, k);
  return static_cast<int>(cudaGetLastError());
}
