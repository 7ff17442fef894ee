// W4A16 GEMM over a packed MixFP4 weight for sm_90a:
//   y (M, N) f32 = bf16(x) (M, K) @ decode(W) (K, N) * scale32.
//
// Replaces: src/repro/kernels/mixfp4_gemm.py :: mixfp4_gemm_w4a16
//           (_stream_gemm_body in mode "w4a16", _expand_weight_tile,
//           _decode_nibbles, _decode_scales).
//
// Bound: bytes at decode (M = batch, a few rows: every packed weight byte
// is read once for ~2*M flops per value); operations only at prefill
// (M in the thousands), where the bf16 tensor-core rate is the ceiling.
//
// Design: a 64x64 output tile per 128-thread block; the block walks K in
// 32-deep slabs.  Per slab it stages the activation tile (bf16, 16-byte
// loads) in shared memory and decodes the weight slab straight from the
// packed bytes (mixfp4_gemm_tile.cuh, shared with the W4A4 kernels); each
// warp issues mma.sync m16n8k16 bf16 -> f32 over its 16 rows and all 64
// columns.  The per-tensor scale multiplies the f32 accumulator in the
// epilogue, which masks the ragged M and N edges.  The packed weight is
// never expanded in device memory.  Split-K / GEMV variants for the small
// decode M, TMA and wgmma are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mixfp4_gemm_tile.cuh"

namespace {

using namespace mixfp4;

__global__ void __launch_bounds__(128) w4a16_kernel(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ wp,
    const uint8_t* __restrict__ ws, const float* __restrict__ s32,
    float* __restrict__ y, int m, int k, int nw, int n) {
  __shared__ __align__(16) __nv_bfloat16 As[BM][LDA];
  __shared__ __align__(16) __nv_bfloat16 Bs[BN][LDB];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[8][4];
  zero_acc(acc);
  for (int k0 = 0; k0 < k; k0 += BK) {
    // activation tile: BM x BK bf16 as 16-byte chunks, zero past M / K
#pragma unroll
    for (int c = tid; c < BM * BK / 8; c += 128) {
      const int r = c / (BK / 8), cc = c % (BK / 8);
      const int gm = m0 + r, gk = k0 + cc * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (gm < m && gk < k)
        v = *reinterpret_cast<const uint4*>(x + static_cast<size_t>(gm) * k +
                                            gk);
      *reinterpret_cast<uint4*>(&As[r][cc * 8]) = v;
    }
    load_weight_slab(Bs, wp, ws, k0, n0, k, nw, tid);
    __syncthreads();
    mma_slab(As, Bs, acc, warp, lane);
    __syncthreads();
  }
  store_tile(y, acc, s32, 0, m0, n0, m, n, warp, lane);
}

}  // namespace

// x (M, K) bf16 contiguous, K % 16 == 0; payload (K/2, NW) u8; scales
// (K/16, NW/16) u8; NW % 16 == 0; s32 one f32 on the device; y (M, N) f32
// with N <= NW (columns past N are not written).
extern "C" int mixfp4_gemm_w4a16(const void* x, const uint8_t* payload,
                                 const uint8_t* scales, const float* s32,
                                 float* y, int m, int k, int nw, int n,
                                 void* stream) {
  if (m == 0 || n == 0) return 0;
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  w4a16_kernel<<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), payload, scales, s32, y, m, k,
      nw, n);
  return static_cast<int>(cudaGetLastError());
}
