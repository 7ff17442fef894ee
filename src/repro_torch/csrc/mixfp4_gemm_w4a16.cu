// W4A16 GEMM over a packed MixFP4 weight for sm_90a:
//   y (M, N) f32 = bf16(x) (M, K) @ decode(W) (K, N) * scale32,
// and over a stack of MoE experts in one launch:
//   y[e] (C, N) = bf16(x[e]) (C, K) @ decode(W[e]) * scale32[e], every e.
//
// Replaces: src/repro/kernels/mixfp4_gemm.py :: mixfp4_gemm_w4a16
//           (_stream_gemm_body in mode "w4a16", _expand_weight_tile,
//           _decode_nibbles, _decode_scales); the expert entry replaces
//           the reference's lax.map of that kernel over the stack
//           (src/repro/models/moe.py :: _expert_ffn).
//
// Bound: bytes at decode (M = batch, a few rows: every packed weight byte
// is read once for ~2*M flops per value); operations only at prefill
// (M in the thousands), where the bf16 tensor-core rate is the ceiling.
//
// Design (mixfp4_gemm_tile.cuh, shared with the W4A4 kernels): at
// M <= 64 the decode variant, one CTA per (64-column tile, K split): the
// CTA issues its split's payload with cp.async and the activation slice
// of the split (bf16, 16-byte cp.async) beside it, decodes the weight
// straight into mma B fragments and reduces the split partials in the
// last-arriving CTA of each column tile.  Above, the prefill variant: a
// 64x64 tile per CTA, 32-deep slabs, the weight slab decoded into shared
// memory, summed split by split in the decode variant's order.  The
// per-tensor scale multiplies the f32 sum in the epilogue.  The packed
// weight is never expanded in device memory.  wgmma and TMA at prefill M
// are later work.
//
// Experts: at C <= 64 rows per expert, a kernel of its own
// (mixfp4_gemm_experts.cuh): one CTA per (expert, column tile) walks every
// K split of its tile through a ring of cp.async slots, adds the partials in
// split order itself, and skips the splits whose activations are all zero
// without reading their weight bytes, so an expert that received no token
// costs its activation reads.
// Above 64 rows, the prefill kernel with the expert as the grid's z axis
// (EXPERTS = true): each CTA moves its operand pointers to its expert's
// slice (contiguous (E, ...) stacks) and runs the 2-D code unchanged.
// Either way every expert's rows are bitwise the 2-D entry's on that
// expert and stay independent of C.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mixfp4_gemm_experts.cuh"
#include "mixfp4_gemm_tile.cuh"

namespace {

using namespace mixfp4;

// the operands of expert e = blockIdx.z of contiguous (E, ...) stacks
#define MIXFP4_EXPERT_SLICES()                  \
  do {                                          \
    const size_t e = blockIdx.z;                \
    x += e * m * k;                             \
    wp += e * (k / 2) * nw;                     \
    ws += e * (k / 16) * (nw / 16);             \
    s32 += e;                                   \
    y += e * m * n;                             \
  } while (0)

template <bool EXPERTS>
__global__ void __launch_bounds__(128) w4a16_kernel(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ wp,
    const uint8_t* __restrict__ ws, const float* __restrict__ s32,
    float* __restrict__ y, int m, int k, int nw, int n, int split_k) {
  if constexpr (EXPERTS) MIXFP4_EXPERT_SLICES();
  __shared__ __align__(16) __nv_bfloat16 As[BM][LDA];
  __shared__ __align__(16) __nv_bfloat16 Bs[BN][LDB];
  __shared__ SplitSum sum;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float part[8][4];
  sum_zero(sum, tid);
  for (int ks0 = 0; ks0 < k; ks0 += split_k) {
    const int kend = split_end(ks0, split_k, k);
    zero_acc(part);
    for (int k0 = ks0; k0 < kend; k0 += BK) {
      // activation tile: BM x BK bf16 as 16-byte chunks, zero past M / K
#pragma unroll
      for (int c = tid; c < BM * BK / 8; c += 128) {
        const int r = c / (BK / 8), cc = c % (BK / 8);
        const int gm = m0 + r, gk = k0 + cc * 8;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (gm < m && gk < k)
          v = *reinterpret_cast<const uint4*>(
              x + static_cast<size_t>(gm) * k + gk);
        *reinterpret_cast<uint4*>(&As[r][cc * 8]) = v;
      }
      load_weight_slab(Bs, wp, ws, k0, n0, k, nw, tid);
      __syncthreads();
      mma_slab(As, Bs, part, warp, lane);
      __syncthreads();
    }
    sum_add(sum, part, tid);
  }
  sum_load(part, sum, tid);
  store_tile(y, part, s32, 0, m0, n0, m, n, warp, lane);
}

template <int MT>
__global__ void __launch_bounds__(DTHREADS) w4a16_decode_kernel(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ wp,
    const uint8_t* __restrict__ ws, const float* __restrict__ s32,
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
  // the split's activation rows, zero past K
  const int chunks = split_k / 8;
  for (int c = tid; c < m * chunks; c += DTHREADS) {
    const int r = c / chunks, cc = c % chunks;
    const int gk = ks0 + cc * 8;
    const bool ok = gk < k;
    cp_async16(sm.as + r * sm.lda + cc * 8,
               ok ? x + static_cast<size_t>(r) * k + gk : x, ok);
  }
  store_scale(sm, sb, split_k, tid);
  cp_async_wait_all();
  __syncthreads();
  float acc[MT][2][4];
  mma_split<MT>(sm, m, (split_end(ks0, split_k, k) - ks0) / 16, acc, tid >> 5,
            tid & 31);
  finish_split(acc, work, counters, s32, 0, y, m, n, np, n0, split,
               gridDim.y, tid);
}

// the expert decode kernel for R 8-row tiles and a 64- or 128-column tile
template <int R>
auto experts_kernel(int tile_n) {
  return tile_n == 64 ? w4a16_experts_decode_kernel<R, 4>
                      : w4a16_experts_decode_kernel<R, 8>;
}

int launch_experts_decode(const __nv_bfloat16* x, const uint8_t* payload,
                          const uint8_t* scales, const float* s32, float* y,
                          int experts, int m, int k, int nw, int n,
                          int split_k, int tile_n, int threads, int stages,
                          cudaStream_t st) {
  if ((tile_n != 64 && tile_n != 128) || threads != 2 * tile_n ||
      stages < EXPERT_MIN_STAGES || stages > EXPERT_MAX_STAGES)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = expert_smem_bytes(m, k, split_k, tile_n / 16, stages);
  if (smem > static_cast<size_t>(EXPERT_SMEM_LIMIT))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rt = m <= 8 ? 0 : (m <= 16 ? 1 : (m <= 32 ? 2 : 3));
  auto kernel = rt == 0 ? experts_kernel<1>(tile_n)
                : rt == 1 ? experts_kernel<2>(tile_n)
                : rt == 2 ? experts_kernel<4>(tile_n)
                          : experts_kernel<8>(tile_n);
  // the largest dynamic shared memory each instantiation has been allowed
  static int allowed[4][2] = {};
  int& cur = allowed[rt][tile_n == 128];
  if (smem > 48 * 1024 && static_cast<int>(smem) > cur) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    cur = static_cast<int>(smem);
  }
  const dim3 grid((n + tile_n - 1) / tile_n, experts);
  kernel<<<grid, threads, smem, st>>>(x, payload, scales, s32, y, m, k, nw,
                                      n, split_k, stages);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M, K) bf16 contiguous, 16-byte aligned, K % 16 == 0; payload (K/2,
// NW) u8, 16-byte aligned; scales (K/16, NW/16) u8; NW % 16 == 0; s32 one
// f32 on the device; y (M, N) f32 with N <= NW (columns past N are not
// written).  split_k: the K split depth (a multiple of 32, at most 256);
// decode: 1 for the decode variant (M <= 64), which needs work (splits, M,
// NP) f32 with NP = 64 * ceil(N / 64) and counters, one int per column
// tile, zero before the first launch (each launch leaves them zero).
extern "C" int mixfp4_gemm_w4a16(const void* x, const uint8_t* payload,
                                 const uint8_t* scales, const float* s32,
                                 float* y, int m, int k, int nw, int n,
                                 int split_k, int decode, float* work,
                                 int* counters, void* stream) {
  if (m == 0 || n == 0) return 0;
  if (const int err = check_plan(m, split_k, decode)) return err;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  if (decode) {
    const int tiles = (n + DBN - 1) / DBN;
    const dim3 grid(tiles, (k + split_k - 1) / split_k);
    const size_t smem = decode_smem_bytes(m, split_k);
    const int mt = decode_mtiles(m);
    auto kernel = mt == 1 ? w4a16_decode_kernel<1>
                          : (mt == 2 ? w4a16_decode_kernel<2>
                                     : w4a16_decode_kernel<4>);
    kernel<<<grid, DTHREADS, smem, st>>>(xb, payload, scales, s32, y, work,
                                         counters, m, k, nw, n, tiles * DBN,
                                         split_k);
  } else {
    const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
    w4a16_kernel<false><<<grid, 128, 0, st>>>(xb, payload, scales, s32, y,
                                              m, k, nw, n, split_k);
  }
  return static_cast<int>(cudaGetLastError());
}

// The same over E = experts stacked operands: x (E, M, K), payload (E,
// K/2, NW), scales (E, K/16, NW/16), s32 (E,), y (E, M, N), all
// contiguous.  The decode variant (M <= 64) takes its plan from
// kernels/tuning.py expert_plan: tile_n columns per CTA (64 or 128),
// threads = 2 * tile_n (a warp per 16-column scale block), stages ring
// slots (2 to 4); it needs no workspace.  The prefill variant ignores the
// three.
extern "C" int mixfp4_gemm_w4a16_experts(const void* x, const uint8_t* payload,
                                         const uint8_t* scales,
                                         const float* s32, float* y,
                                         int experts, int m, int k, int nw,
                                         int n, int split_k, int decode,
                                         int tile_n, int threads, int stages,
                                         void* stream) {
  if (experts == 0 || m == 0 || n == 0) return 0;
  if (const int err = check_plan(m, split_k, decode)) return err;
  if (experts < 0 || experts > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  if (decode)
    return launch_experts_decode(xb, payload, scales, s32, y, experts, m, k,
                                 nw, n, split_k, tile_n, threads, stages, st);
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, experts);
  w4a16_kernel<true><<<grid, 128, 0, st>>>(xb, payload, scales, s32, y, m, k,
                                           nw, n, split_k);
  return static_cast<int>(cudaGetLastError());
}
