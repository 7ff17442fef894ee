// Per-block MixFP4 math shared by the row quantizer (mixfp4_quant.cu), the
// W4A4 GEMM's fused prologue (mixfp4_gemm_w4a4.cu) and the grouped RHT
// (fwht_rows.cu), so the standalone and fused quantizers cannot drift.
//
// Counterpart of src/repro/kernels/mixfp4_quant.py ::
// quant_block_kernel_math (Alg. 1: E2M1 and E1M2 candidates per 16-value
// block, the lower MSE wins, a tie goes to E2M1) and of
// src/repro/kernels/fwht.py :: fwht_rows_math.  The reference warns that
// any change in rounding flips the err1 < err2 select at near-ties, so
// every source including this header is built with -fmad=false and the
// error terms use explicit round-to-nearest intrinsics:
//   * scales apply as reciprocal multiplies, as the reference does
//     (absmax * (1/6), absmax * (1/7), y * (1/s));
//   * rintf rounds half to even (jnp.round), never roundf;
//   * E4M3 rounding clamps to [0, 448] and converts with
//     __nv_cvt_float_to_fp8(.., __NV_SATFINITE, __NV_E4M3) (RNE);
//   * the per-block MSE sums the 16 squares as a fixed pairwise tree
//     (adjacent pairs, 16 -> 8 -> 4 -> 2 -> 1) and scales by 1/16, the
//     order of the plain version in kernels/mixfp4_quant.py;
//   * a zero-magnitude scale packs to byte 0x00, never 0x80.
#pragma once

#include <cuda_runtime.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace mixfp4 {

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

// v[i] = v[2i] + v[2i+1] for i < W, then the same for W/2, ..., 1.  The
// widths are template constants so every loop unrolls and v stays in
// registers.
template <int W>
__device__ __forceinline__ void pair_sums(float (&v)[16]) {
  if constexpr (W >= 1) {
#pragma unroll
    for (int i = 0; i < W; ++i) v[i] = __fadd_rn(v[2 * i], v[2 * i + 1]);
    pair_sums<W / 2>(v);
  }
}

// sum of 16 values as the fixed adjacent-pairs tree
__device__ __forceinline__ float tree_sum16(float (&v)[16]) {
  pair_sums<8>(v);
  return v[0];
}

struct BlockChoice {
  float s8;  // the chosen E4M3-valued block scale
  bool t;    // type bit: true = E1M2, false = E2M1
};

// Alg. 1 on one block xs (already times 1/scale32): q receives the signed
// values on the chosen lattice, so q[i] * s8 is the decoded value exactly.
__device__ __forceinline__ BlockChoice quant_block16(const float (&xs)[16],
                                                     float (&q)[16]) {
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
#pragma unroll
  for (int i = 0; i < 16; ++i) q[i] = t ? q1[i] : q2[i];
  return {t ? s1 : s2, t};
}

// nibble [s|p2p1p0] of a lattice value q under type t
__device__ __forceinline__ uint32_t encode_nibble(float q, bool t) {
  const float a = fabsf(q);
  const float idx =
      t ? a : (a < 2.0f ? a * 2.0f : (a < 6.0f ? a + 2.0f : 7.0f));
  return (q < 0.0f ? 8u : 0u) | static_cast<uint32_t>(idx);
}

// scale byte {T | e4m3[6:0]}; a zero-magnitude scale is 0x00
__device__ __forceinline__ uint8_t pack_scale(float s8, bool t) {
  const uint8_t mag = e4m3_bits(s8) & 0x7F;
  return mag == 0 ? 0 : static_cast<uint8_t>(mag | (t ? 0x80 : 0));
}

// Fig. 9 decode of one nibble [s|p2p1p0] under type bit t, as a float.
__device__ __forceinline__ float decode_nibble(uint32_t nib, uint32_t t) {
  const int p = nib & 7;
  // twice the E2M1 magnitude: 0,1,2,3,4,6,8,12
  const int twice = p < 4 ? p : (2 + (p & 1)) << ((p >> 1) - 1);
  const float mag = t ? static_cast<float>(p) : 0.5f * twice;
  return (nib & 8) ? -mag : mag;
}

__device__ __forceinline__ float e4m3_value(uint32_t bits7) {
  __nv_fp8_e4m3 v;
  v.__x = static_cast<__nv_fp8_storage_t>(bits7);
  return static_cast<float>(v);
}

// The grouped Walsh-Hadamard butterfly on G values in place, stage for
// stage as fwht_rows_math: at stride H, lanes (p, p + H) of each 2H-run
// become (a + b, a - b).  The sign flip before it and the G^-1/2 after it
// are the caller's.  H is a template constant so the loops unroll and v
// stays in registers.
template <int G, int H = 1>
__device__ __forceinline__ void wht_butterfly(float (&v)[G]) {
  if constexpr (H < G) {
#pragma unroll
    for (int j = 0; j < G; j += 2 * H) {
#pragma unroll
      for (int p = 0; p < H; ++p) {
        const float a = v[j + p], b = v[j + H + p];
        v[j + p] = __fadd_rn(a, b);
        v[j + H + p] = __fsub_rn(a, b);
      }
    }
    wht_butterfly<G, 2 * H>(v);
  }
}

}  // namespace mixfp4
