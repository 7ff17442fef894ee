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
// Design: the W4A16 kernel's two variants (mixfp4_gemm_tile.cuh: split K,
// the decode variant at M <= 64, the 64x64 prefill tile above), with one
// A-operand loader per mode, a_block(), which yields one (row, 16-block)
// of A as the f32 values whose bf16 rounding is the MMA operand:
//   PACKED      reads 8 payload bytes and one scale byte of X and decodes
//               them (1-D g=16 blocks along K);
//   DENSE_QUANT reads 16 f32 of x, applies the optional sign flip +
//               16-lane Walsh-Hadamard butterfly + 1/4, multiplies by
//               1/x_s32 and runs the row quantizer's own block math
//               (mixfp4_block_math.cuh), giving q * s8.
// q * s8 is exactly what PACKED decodes from the bytes the quantizer would
// write, and both loaders feed one main loop per variant, so the fused
// kernel is bitwise the quantizer followed by the packed kernel.  The
// decode variant fills the CTA's whole A slice (M rows x its K split)
// once, every thread working, while its weight bytes are in flight; the
// prefill tile fills one 32-deep slab at a time.  Built with -fmad=false
// (the block math needs it; the MMA is unaffected).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mixfp4_block_math.cuh"
#include "mixfp4_gemm_tile.cuh"

namespace {

using namespace mixfp4;

enum AMode { A_PACKED = 0, A_DENSE_QUANT = 1 };

// v <- A's 16-block at (row gm, columns gk .. gk+16), zero outside (m, k)
template <int MODE, bool RHT>
__device__ __forceinline__ void a_block(
    float (&v)[16], const void* __restrict__ xa,
    const uint8_t* __restrict__ xsc, const float* __restrict__ x_s32,
    const float* __restrict__ signs, int per_row, int gm, int gk, int m,
    int k) {
  if (gm >= m || gk >= k) {
#pragma unroll
    for (int i = 0; i < 16; ++i) v[i] = 0.0f;
    return;
  }
  if constexpr (MODE == A_PACKED) {
    const uint8_t* xp = static_cast<const uint8_t*>(xa);
    const uint2 raw = *reinterpret_cast<const uint2*>(
        xp + static_cast<size_t>(gm) * (k / 2) + gk / 2);
    const uint32_t sb = xsc[static_cast<size_t>(gm) * (k / 16) + gk / 16];
    const float s = e4m3_value(sb & 0x7F);
    const uint32_t t = sb >> 7;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t byte = ((j < 4 ? raw.x : raw.y) >> (8 * (j & 3))) & 0xFF;
      v[2 * j] = decode_nibble(byte & 0xF, t) * s;
      v[2 * j + 1] = decode_nibble(byte >> 4, t) * s;
    }
  } else {
    const float inv = 1.0f / x_s32[per_row ? gm : 0];
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
}

template <int MODE, bool RHT>
__global__ void __launch_bounds__(128) w4a4_kernel(
    const void* __restrict__ xa, const uint8_t* __restrict__ xsc,
    const float* __restrict__ x_s32, const float* __restrict__ signs,
    const float* __restrict__ out_s32, int per_row,
    const uint8_t* __restrict__ wp, const uint8_t* __restrict__ ws,
    float* __restrict__ y, int m, int k, int nw, int n, int split_k) {
  __shared__ __align__(16) __nv_bfloat16 As[BM][LDA];
  __shared__ __align__(16) __nv_bfloat16 Bs[BN][LDB];
  __shared__ SplitSum sum;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  // this thread's A block: row ar of the tile, 16-block ab of the slab
  const int ar = tid >> 1, ab = tid & 1;

  float part[8][4];
  sum_zero(sum, tid);
  for (int ks0 = 0; ks0 < k; ks0 += split_k) {
    const int kend = split_end(ks0, split_k, k);
    zero_acc(part);
    for (int k0 = ks0; k0 < kend; k0 += BK) {
      float v[16];
      a_block<MODE, RHT>(v, xa, xsc, x_s32, signs, per_row, m0 + ar,
                         k0 + ab * 16, m, k);
      put16(&As[ar][ab * 16], v);
      load_weight_slab(Bs, wp, ws, k0, n0, k, nw, tid);
      __syncthreads();
      mma_slab(As, Bs, part, warp, lane);
      __syncthreads();
    }
    sum_add(sum, part, tid);
  }
  sum_load(part, sum, tid);
  store_tile(y, part, out_s32, per_row, m0, n0, m, n, warp, lane);
}

template <int MODE, bool RHT, int MT>
__global__ void __launch_bounds__(DTHREADS) w4a4_decode_kernel(
    const void* __restrict__ xa, const uint8_t* __restrict__ xsc,
    const float* __restrict__ x_s32, const float* __restrict__ signs,
    const float* __restrict__ out_s32, int per_row,
    const uint8_t* __restrict__ wp, const uint8_t* __restrict__ ws,
    float* __restrict__ y, float* __restrict__ work,
    int* __restrict__ counters, int m, int k, int nw, int n, int np,
    int split_k) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * DBN, split = blockIdx.y;
  const int ks0 = split * split_k;
  const DecodeSmem sm = decode_smem(smem, m, split_k);
  const uint32_t sb =
      issue_weight_split(sm, wp, ws, ks0, split_k, n0, k, nw, tid);
  // the CTA's whole A slice, one (row, 16-block) per thread and turn,
  // while the weight bytes are in flight
  const int blocks = split_k / 16;
  for (int b = tid; b < m * blocks; b += DTHREADS) {
    const int r = b / blocks, kb = b % blocks;
    float v[16];
    a_block<MODE, RHT>(v, xa, xsc, x_s32, signs, per_row, r,
                       ks0 + kb * 16, m, k);
    put16(sm.as + r * sm.lda + kb * 16, v);
  }
  store_scale(sm, sb, split_k, tid);
  cp_async_wait_all();
  __syncthreads();
  float acc[MT][2][4];
  mma_split<MT>(sm, m, (split_end(ks0, split_k, k) - ks0) / 16, acc, tid >> 5,
            tid & 31);
  finish_split(acc, work, counters, out_s32, per_row, y, m, n, np, n0, split,
               gridDim.y, tid);
}

struct Plan {
  int split_k, decode;
  float* work;
  int* counters;
};

template <int MODE, bool RHT>
int launch(const void* xa, const uint8_t* xsc, const float* x_s32,
           const float* signs, const float* out_s32, int per_row,
           const uint8_t* wp, const uint8_t* ws, float* y, int m, int k,
           int nw, int n, const Plan& p, void* stream) {
  if (m == 0 || n == 0) return 0;
  if (const int err = check_plan(m, p.split_k, p.decode)) return err;
  const auto st = static_cast<cudaStream_t>(stream);
  if (p.decode) {
    const int tiles = (n + DBN - 1) / DBN;
    const dim3 grid(tiles, (k + p.split_k - 1) / p.split_k);
    const size_t smem = decode_smem_bytes(m, p.split_k);
    const int mt = decode_mtiles(m);
    auto kernel = mt == 1 ? w4a4_decode_kernel<MODE, RHT, 1>
                          : (mt == 2 ? w4a4_decode_kernel<MODE, RHT, 2>
                                     : w4a4_decode_kernel<MODE, RHT, 4>);
    kernel<<<grid, DTHREADS, smem, st>>>(xa, xsc, x_s32, signs, out_s32,
                                         per_row, wp, ws, y, p.work,
                                         p.counters, m, k, nw, n,
                                         tiles * DBN, p.split_k);
  } else {
    const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
    w4a4_kernel<MODE, RHT><<<grid, 128, 0, st>>>(
        xa, xsc, x_s32, signs, out_s32, per_row, wp, ws, y, m, k, nw, n,
        p.split_k);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Packed activations: x_payload (M, K/2) u8, x_scales (M, K/16) u8, rows
// 8-byte aligned; weight payload (K/2, NW) u8 16-byte aligned, scales
// (K/16, NW/16) u8; K % 16 == 0, NW % 16 == 0; out_s32 one f32 or M
// (per_row) on the device; y (M, N) f32 with N <= NW.  split_k, decode,
// work and counters as mixfp4_gemm_w4a16.
extern "C" int mixfp4_gemm_w4a4(const uint8_t* x_payload,
                                const uint8_t* x_scales, const float* out_s32,
                                int per_row, const uint8_t* payload,
                                const uint8_t* scales, float* y, int m, int k,
                                int nw, int n, int split_k, int decode,
                                float* work, int* counters, void* stream) {
  return launch<A_PACKED, false>(x_payload, x_scales, nullptr, nullptr,
                                 out_s32, per_row, payload, scales, y, m, k,
                                 nw, n, {split_k, decode, work, counters},
                                 stream);
}

// Dense f32 activations x (M, K) contiguous, 16-byte aligned, quantized in
// the prologue under x_s32 (one f32 or M with per_row); signs (K,) f32
// 16-byte aligned, or null for no RHT; the rest as mixfp4_gemm_w4a4.
extern "C" int mixfp4_gemm_w4a4_fused(const float* x, const float* x_s32,
                                      const float* out_s32, int per_row,
                                      const float* signs,
                                      const uint8_t* payload,
                                      const uint8_t* scales, float* y, int m,
                                      int k, int nw, int n, int split_k,
                                      int decode, float* work, int* counters,
                                      void* stream) {
  const Plan p{split_k, decode, work, counters};
  if (signs != nullptr)
    return launch<A_DENSE_QUANT, true>(x, nullptr, x_s32, signs, out_s32,
                                       per_row, payload, scales, y, m, k, nw,
                                       n, p, stream);
  return launch<A_DENSE_QUANT, false>(x, nullptr, x_s32, nullptr, out_s32,
                                      per_row, payload, scales, y, m, k, nw, n,
                                      p, stream);
}
