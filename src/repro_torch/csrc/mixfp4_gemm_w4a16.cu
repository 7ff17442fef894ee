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
// packed bytes: each thread reads 8 payload bytes (16 values of one column
// pair) and the one scale byte of their 16x16 tile, runs the Fig. 9 decode
// (E2M1 or E1M2 by the scale's sign bit) with the block scale fused, and
// stores bf16 pairs in a [n][k] layout.  A decoded value times its E4M3
// block scale has at most 7 significant bits, so the bf16 operand is exact.
// Each warp then issues mma.sync m16n8k16 bf16 -> f32 over its 16 rows and
// all 64 columns.  The per-tensor scale multiplies the f32 accumulator in
// the epilogue, which masks the ragged M and N edges.  The packed weight is
// never expanded in device memory.  Split-K / GEMV variants for the small
// decode M, TMA and wgmma are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int LDA = BK + 8;  // bf16 per A row: 80 B, 16-byte aligned rows
constexpr int LDB = BK + 2;  // bf16 per B row: 17 words, spreads banks

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

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(128) w4a16_kernel(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ wp,
    const uint8_t* __restrict__ ws, const float* __restrict__ s32,
    float* __restrict__ y, int m, int k, int nw, int n) {
  __shared__ __align__(16) __nv_bfloat16 As[BM][LDA];
  __shared__ __align__(16) __nv_bfloat16 Bs[BN][LDB];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k2 = k / 2, nsb = nw / 16;

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  // weight decode assignment: payload row pr of the slab, 8 columns at c8
  const int pr = tid >> 3;
  const int c8 = (tid & 7) * 8;

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
    // weight slab: BK/2 payload rows x BN columns, decoded to bf16 [n][k]
    {
      const int gk2 = k0 / 2 + pr;
      const int gn = n0 + c8;
      uint2 raw = make_uint2(0, 0);
      uint32_t sb = 0;
      if (gk2 < k2 && gn < nw) {
        raw = *reinterpret_cast<const uint2*>(
            wp + static_cast<size_t>(gk2) * nw + gn);
        sb = ws[static_cast<size_t>(gk2 / 8) * nsb + gn / 16];
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
    __syncthreads();
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
    __syncthreads();
  }

  const float scale = *s32;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + warp * 16 + g + h * 8;
      if (row >= m) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n0 + nt * 8 + tq * 2 + e;
        if (col < n)
          y[static_cast<size_t>(row) * n + col] = acc[nt][h * 2 + e] * scale;
      }
    }
  }
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
