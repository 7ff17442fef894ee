// W4A4 GEMMs over a packed MixFP4 weight for sm_90a, both GEMM operands on
// the MixFP4 wire format:
//   packed:  y (M, N) f32 = decode(X) (M, K) @ decode(W) (K, N) * s_out
//   fused:   y = decode(quant(RHT?(x) * 1/x_s32)) @ decode(W) * s_out
// where s_out is x_s32 * w_s32, one value or one per row.
//
// Replaces: src/repro/kernels/mixfp4_gemm.py :: mixfp4_gemm_w4a4 (mode
//           "w4a4", _expand_act_tile) and mixfp4_gemm_w4a4_fused (mode
//           "w4a4_fused", _quantize_act_tile, fwht_rows_math in the
//           prologue).
//
// Bound: bytes at decode M (the packed weight, about 4 bits a value, is
// read once; the activation rows are a few MB), the bf16 tensor-core rate
// at prefill M: the H100 has no FP4 MMA, so both operands are decoded to
// bf16 (value x E4M3 block scale has at most 7 significant bits, exact).
//
// Design: one kernel template with two A-operand loaders, on the W4A16
// kernel's tile (mixfp4_gemm_tile.cuh: 64x64 output tile per 128-thread
// block, 32-deep K slabs, the same weight-slab decode, mma.sync m16n8k16
// and epilogue).  Per slab each thread owns one (row, 16-block) of the A
// tile:
//   PACKED      reads 8 payload bytes and one scale byte of X and decodes
//               them (1-D g=16 blocks along K);
//   DENSE_QUANT reads 16 f32 of x, applies the optional sign flip +
//               16-lane Walsh-Hadamard butterfly + 1/4, multiplies by
//               1/x_s32 and runs the row quantizer's own block math
//               (mixfp4_block_math.cuh), writing bf16(q * s8).
// q * s8 is exactly what PACKED decodes from the bytes the quantizer would
// write, so both loaders fill the same shared A tile and the rest of the
// kernel is common: the fused kernel is bitwise the quantizer followed by
// the packed kernel.  Built with -fmad=false (the block math needs it; the
// MMA is unaffected).  The fused kernel quantizes each A block once per
// column tile (N / 64 times); wgmma, TMA, split-K and a shared quantized A
// tile are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mixfp4_block_math.cuh"
#include "mixfp4_gemm_tile.cuh"

namespace {

using namespace mixfp4;

enum AMode { A_PACKED = 0, A_DENSE_QUANT = 1 };

// 16 bf16 values into As[r][c0 .. c0+16) as two 16-byte stores
__device__ __forceinline__ void put16(__nv_bfloat16 (&As)[BM][LDA], int r,
                                      int c0, const float (&v)[16]) {
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    __nv_bfloat162 p;
    p.x = __float2bfloat16_rn(v[2 * i]);
    p.y = __float2bfloat16_rn(v[2 * i + 1]);
    w[i] = *reinterpret_cast<uint32_t*>(&p);
  }
  uint4* dst = reinterpret_cast<uint4*>(&As[r][c0]);
  dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
  dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
}

template <int MODE, bool RHT>
__global__ void __launch_bounds__(128) w4a4_kernel(
    const void* __restrict__ xa, const uint8_t* __restrict__ xsc,
    const float* __restrict__ x_s32, const float* __restrict__ signs,
    const float* __restrict__ out_s32, int per_row,
    const uint8_t* __restrict__ wp, const uint8_t* __restrict__ ws,
    float* __restrict__ y, int m, int k, int nw, int n) {
  __shared__ __align__(16) __nv_bfloat16 As[BM][LDA];
  __shared__ __align__(16) __nv_bfloat16 Bs[BN][LDB];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  // this thread's A block: row ar of the tile, 16-block ab of the slab
  const int ar = tid >> 1, ab = tid & 1;
  const int gm = m0 + ar;
  float inv = 1.0f;
  if (MODE == A_DENSE_QUANT && gm < m) inv = 1.0f / x_s32[per_row ? gm : 0];

  float acc[8][4];
  zero_acc(acc);
  for (int k0 = 0; k0 < k; k0 += BK) {
    const int gk = k0 + ab * 16;
    float v[16];
    if (gm < m && gk < k) {
      if constexpr (MODE == A_PACKED) {
        const uint8_t* xp = static_cast<const uint8_t*>(xa);
        const uint2 raw = *reinterpret_cast<const uint2*>(
            xp + static_cast<size_t>(gm) * (k / 2) + gk / 2);
        const uint32_t sb = xsc[static_cast<size_t>(gm) * (k / 16) + gk / 16];
        const float s = e4m3_value(sb & 0x7F);
        const uint32_t t = sb >> 7;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint32_t byte =
              ((j < 4 ? raw.x : raw.y) >> (8 * (j & 3))) & 0xFF;
          v[2 * j] = decode_nibble(byte & 0xF, t) * s;
          v[2 * j + 1] = decode_nibble(byte >> 4, t) * s;
        }
      } else {
        const float4* src = reinterpret_cast<const float4*>(
            static_cast<const float*>(xa) + static_cast<size_t>(gm) * k + gk);
        float xv[16];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 f = src[i];
          xv[4 * i] = f.x;
          xv[4 * i + 1] = f.y;
          xv[4 * i + 2] = f.z;
          xv[4 * i + 3] = f.w;
        }
        if constexpr (RHT) {
          const float4* sg = reinterpret_cast<const float4*>(signs + gk);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float4 f = sg[i];
            xv[4 * i] = __fmul_rn(xv[4 * i], f.x);
            xv[4 * i + 1] = __fmul_rn(xv[4 * i + 1], f.y);
            xv[4 * i + 2] = __fmul_rn(xv[4 * i + 2], f.z);
            xv[4 * i + 3] = __fmul_rn(xv[4 * i + 3], f.w);
          }
          wht_butterfly<16>(xv);
#pragma unroll
          for (int i = 0; i < 16; ++i) xv[i] = __fmul_rn(xv[i], 0.25f);
        }
#pragma unroll
        for (int i = 0; i < 16; ++i) xv[i] = __fmul_rn(xv[i], inv);
        float q[16];
        const BlockChoice c = quant_block16(xv, q);
#pragma unroll
        for (int i = 0; i < 16; ++i) v[i] = __fmul_rn(q[i], c.s8);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i) v[i] = 0.0f;
    }
    put16(As, ar, ab * 16, v);
    load_weight_slab(Bs, wp, ws, k0, n0, k, nw, tid);
    __syncthreads();
    mma_slab(As, Bs, acc, warp, lane);
    __syncthreads();
  }
  store_tile(y, acc, out_s32, per_row, m0, n0, m, n, warp, lane);
}

template <int MODE, bool RHT>
int launch(const void* xa, const uint8_t* xsc, const float* x_s32,
           const float* signs, const float* out_s32, int per_row,
           const uint8_t* wp, const uint8_t* ws, float* y, int m, int k,
           int nw, int n, void* stream) {
  if (m == 0 || n == 0) return 0;
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  w4a4_kernel<MODE, RHT><<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      xa, xsc, x_s32, signs, out_s32, per_row, wp, ws, y, m, k, nw, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Packed activations: x_payload (M, K/2) u8, x_scales (M, K/16) u8, rows
// 8-byte aligned; weight payload (K/2, NW) u8, scales (K/16, NW/16) u8;
// K % 16 == 0, NW % 16 == 0; out_s32 one f32 or M (per_row) on the device;
// y (M, N) f32 with N <= NW.
extern "C" int mixfp4_gemm_w4a4(const uint8_t* x_payload,
                                const uint8_t* x_scales, const float* out_s32,
                                int per_row, const uint8_t* payload,
                                const uint8_t* scales, float* y, int m, int k,
                                int nw, int n, void* stream) {
  return launch<A_PACKED, false>(x_payload, x_scales, nullptr, nullptr,
                                 out_s32, per_row, payload, scales, y, m, k,
                                 nw, n, stream);
}

// Dense f32 activations x (M, K) contiguous, 16-byte aligned, quantized in
// the prologue under x_s32 (one f32 or M with per_row); signs (K,) f32
// 16-byte aligned, or null for no RHT; the rest as mixfp4_gemm_w4a4.
extern "C" int mixfp4_gemm_w4a4_fused(const float* x, const float* x_s32,
                                      const float* out_s32, int per_row,
                                      const float* signs,
                                      const uint8_t* payload,
                                      const uint8_t* scales, float* y, int m,
                                      int k, int nw, int n, void* stream) {
  if (signs != nullptr)
    return launch<A_DENSE_QUANT, true>(x, nullptr, x_s32, signs, out_s32,
                                       per_row, payload, scales, y, m, k, nw,
                                       n, stream);
  return launch<A_DENSE_QUANT, false>(x, nullptr, x_s32, nullptr, out_s32,
                                      per_row, payload, scales, y, m, k, nw, n,
                                      stream);
}
