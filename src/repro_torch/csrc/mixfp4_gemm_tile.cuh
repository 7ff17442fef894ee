// The part of a MixFP4 GEMM tile that the W4A16 kernel
// (mixfp4_gemm_w4a16.cu) and the W4A4 kernels (mixfp4_gemm_w4a4.cu) share:
// the 64x64 output tile of a 128-thread block, the decode of one 32-deep
// slab of the packed weight into shared memory, the warp MMAs over a slab,
// and the epilogue that scales the f32 accumulator.
//
// Weight slab decode: each thread reads 8 payload bytes (16 values of one
// column pair) and the one scale byte of their 16x16 tile, runs the Fig. 9
// decode (E2M1 or E1M2 by the scale's sign bit) with the block scale fused,
// and stores bf16 pairs in a [n][k] layout, which is the mma.sync B-fragment
// order.  A decoded value times its E4M3 block scale has at most 7
// significant bits, so the bf16 operand is exact.  Each warp then issues
// mma.sync m16n8k16 bf16 -> f32 over its 16 rows and all 64 columns; the
// A tile is [m][k] bf16, filled by the caller.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mixfp4_block_math.cuh"

namespace mixfp4 {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int LDA = BK + 8;  // bf16 per A row: 80 B, 16-byte aligned rows
constexpr int LDB = BK + 2;  // bf16 per B row: 17 words, spreads banks

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Bs <- the weight rows k0 .. k0+BK of columns n0 .. n0+BN, decoded; zero
// past K or the stored width nw.  wp (K/2, nw) payload, ws (K/16, nw/16).
__device__ __forceinline__ void load_weight_slab(
    __nv_bfloat16 (&Bs)[BN][LDB], const uint8_t* __restrict__ wp,
    const uint8_t* __restrict__ ws, int k0, int n0, int k, int nw, int tid) {
  const int pr = tid >> 3;        // payload row of the slab
  const int c8 = (tid & 7) * 8;   // first of 8 columns
  const int gk2 = k0 / 2 + pr;
  const int gn = n0 + c8;
  uint2 raw = make_uint2(0, 0);
  uint32_t sb = 0;
  if (gk2 < k / 2 && gn < nw) {
    raw = *reinterpret_cast<const uint2*>(
        wp + static_cast<size_t>(gk2) * nw + gn);
    sb = ws[static_cast<size_t>(gk2 / 8) * (nw / 16) + gn / 16];
  }
  const float s = e4m3_value(sb & 0x7F);
  const uint32_t t = sb >> 7;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint32_t byte = ((j < 4 ? raw.x : raw.y) >> (8 * (j & 3))) & 0xFF;
    __nv_bfloat162 v;
    v.x = __float2bfloat16_rn(decode_nibble(byte & 0xF, t) * s);
    v.y = __float2bfloat16_rn(decode_nibble(byte >> 4, t) * s);
    *reinterpret_cast<__nv_bfloat162*>(&Bs[c8 + j][2 * pr]) = v;
  }
}

// acc (warp's 16 rows x 64 columns) += As . Bs over one BK slab
__device__ __forceinline__ void mma_slab(
    const __nv_bfloat16 (&As)[BM][LDA], const __nv_bfloat16 (&Bs)[BN][LDB],
    float (&acc)[8][4], int warp, int lane) {
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    const int r = warp * 16 + g;
    uint32_t a[4];
    a[0] = *reinterpret_cast<const uint32_t*>(&As[r][kk + tq * 2]);
    a[1] = *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + tq * 2]);
    a[2] = *reinterpret_cast<const uint32_t*>(&As[r][kk + tq * 2 + 8]);
    a[3] = *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + tq * 2 + 8]);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(
          &Bs[nt * 8 + g][kk + tq * 2]);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(
          &Bs[nt * 8 + g][kk + tq * 2 + 8]);
      mma_bf16(acc[nt], a, b0, b1);
    }
  }
}

// y[row, col] = acc * scale[per_row ? row : 0] inside (m, n); y is (m, n)
__device__ __forceinline__ void store_tile(
    float* __restrict__ y, const float (&acc)[8][4],
    const float* __restrict__ scale, int per_row, int m0, int n0, int m,
    int n, int warp, int lane) {
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + warp * 16 + g + h * 8;
    if (row >= m) continue;
    const float s = scale[per_row ? row : 0];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n0 + nt * 8 + tq * 2 + e;
        if (col < n)
          y[static_cast<size_t>(row) * n + col] = acc[nt][h * 2 + e] * s;
      }
    }
  }
}

__device__ __forceinline__ void zero_acc(float (&acc)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
}

}  // namespace mixfp4
