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
// synchronisation.  The output must be byte-exact with the reference: the
// per-block math (mixfp4_block_math.cuh, shared with the W4A4 GEMM's fused
// prologue) lists the rounding rules; the row scale also applies as a
// reciprocal multiply, x * (1/s32).
#include <cuda_runtime.h>
#include <stdint.h>

#include "mixfp4_block_math.cuh"

namespace {

using namespace mixfp4;

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
  float q[16];
  const BlockChoice c = quant_block16(xs, q);
  uint32_t lo = 0, hi = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    lo |= (encode_nibble(q[2 * j], c.t) |
           (encode_nibble(q[2 * j + 1], c.t) << 4)) << (8 * j);
    hi |= (encode_nibble(q[8 + 2 * j], c.t) |
           (encode_nibble(q[9 + 2 * j], c.t) << 4)) << (8 * j);
  }
  *reinterpret_cast<uint2*>(payload + row * (k / 2) + blk * 8) =
      make_uint2(lo, hi);
  scales[row * nb + blk] = pack_scale(c.s8, c.t);
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
