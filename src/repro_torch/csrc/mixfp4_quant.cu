// MixFP4 row quantizer (Algorithm 1) for sm_90a, and its KV-cache write.
//
// Replaces: src/repro/kernels/mixfp4_quant.py :: mixfp4_quant_rows
//           (_quant_kernel, quant_block_kernel_math, _encode_nibbles,
//           _pack_scale).  mixfp4_quant_kv replaces its use for the KV
//           write (src/repro/models/base.py :: quantize_kv_rows, then the
//           row scatter of _attn_packed_cached / _attn_paged_cached).
//
// Bound: bytes.  Per 16-value block it reads 64 B of f32 (32 B of bf16 for
// the KV write) and writes 9 B (8 payload bytes, 1 scale byte); the
// arithmetic (two candidate quantizations and their MSEs) is a few hundred
// flops per block, far below the card's compute rate.  At decode the KV
// write is 128 blocks a layer: a launch's latency, not bytes.
//
// Design: one thread per 16-value block, all of the block in registers.
// A block is read as four 16-byte vector loads (two for bf16) and written
// as one 8-byte payload store plus one scale byte, so a warp covers 32
// consecutive blocks (two 256-wide KV rows) with coalesced traffic and no
// shared memory or synchronisation.  The output must be byte-exact with
// the reference: the per-block math (mixfp4_block_math.cuh, shared with
// the W4A4 GEMM's fused prologue) lists the rounding rules; the row scale
// also applies as a reciprocal multiply, x * (1/s32).
//
// mixfp4_quant_kv quantizes a layer's new K and V rows (bf16, exact in
// f32) in one launch (grid y: 0 for K, 1 for V) and stores each block at
// its row's address in the cache, in place: no quantized copy, no index
// tensors and no scatter kernels.  Each thread finds its row's address
// from the write position (the device lengths at decode, a host start at
// prefill) and, for the paged pool, the block table; a position or page
// outside the cache traps, as the indexed write it replaces asserts.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mixfp4_block_math.cuh"

namespace {

using namespace mixfp4;

// Alg. 1 on one block xs (times 1/scale32 already), its 8 payload bytes
// stored at `payload` (8-byte aligned or not) and its scale byte at `scale`
__device__ __forceinline__ void quant_store_block(const float (&xs)[16],
                                                  uint8_t* payload,
                                                  uint8_t* scale) {
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
  if ((reinterpret_cast<uintptr_t>(payload) & 7) == 0) {
    *reinterpret_cast<uint2*>(payload) = make_uint2(lo, hi);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      payload[j] = static_cast<uint8_t>(lo >> (8 * j));
      payload[4 + j] = static_cast<uint8_t>(hi >> (8 * j));
    }
  }
  *scale = pack_scale(c.s8, c.t);
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
  quant_store_block(xs, payload + row * (k / 2) + blk * 8,
                    scales + row * nb + blk);
}

// One layer's new K (grid y 0) or V (grid y 1) rows: src (B, S, Hkv, dh)
// bf16; the cache leaf (D0, D1, Hkv, dh/2) + (D0, D1, Hkv, dh/16) u8 holds
// fixed slots (D0 >= B sequences of D1 rows) or, with block_tables, pool
// pages (D0 pages of D1 = page_len rows).  Row (b, i) goes to logical
// position t = (pos ? pos[b] : start) + i: storage row (b, t), or
// (block_tables[b, t / D1], t % D1).
__global__ void __launch_bounds__(256) quant_kv_kernel(
    const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
    const float* __restrict__ k_s32, const float* __restrict__ v_s32,
    uint8_t* __restrict__ k_payload, uint8_t* __restrict__ k_scales,
    uint8_t* __restrict__ v_payload, uint8_t* __restrict__ v_scales,
    const int* __restrict__ pos, int start,
    const int* __restrict__ block_tables, int max_pages, int b, int s,
    int hkv, int dh, long long d0, int d1) {
  const int nb = dh / 16;
  const long long gid = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  const long long src_rows = static_cast<long long>(b) * s * hkv;
  if (gid >= src_rows * nb) return;
  const long long src_row = gid / nb;        // (bi * s + i) * hkv + h
  const int blk = static_cast<int>(gid % nb);
  const int h = static_cast<int>(src_row % hkv);
  const long long bs = src_row / hkv;
  const int i = static_cast<int>(bs % s);
  const int bi = static_cast<int>(bs / s);
  const long long t = static_cast<long long>(pos ? pos[bi] : start) + i;
  long long r0, r1;
  if (block_tables) {
    if (t < 0 || t / d1 >= max_pages) __trap();
    r0 = block_tables[static_cast<long long>(bi) * max_pages + t / d1];
    r1 = t % d1;
    if (r0 < 0 || r0 >= d0) __trap();
  } else {
    if (t < 0 || t >= d1 || bi >= d0) __trap();
    r0 = bi;
    r1 = t;
  }
  const long long dst_row = (r0 * d1 + r1) * hkv + h;
  const bool is_v = blockIdx.y != 0;
  const float inv = 1.0f / (is_v ? v_s32 : k_s32)[0];
  const uint4* src = reinterpret_cast<const uint4*>(
      (is_v ? v : k) + src_row * dh + blk * 16);
  float xs[16];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const uint4 raw = src[half];
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // bf16 -> f32 is exact: the bf16 bits are the f32's top half
      xs[8 * half + 2 * j] = __fmul_rn(__uint_as_float(w[j] << 16), inv);
      xs[8 * half + 2 * j + 1] =
          __fmul_rn(__uint_as_float(w[j] & 0xffff0000u), inv);
    }
  }
  quant_store_block(xs,
                    (is_v ? v_payload : k_payload) + dst_row * (dh / 2) +
                        blk * 8,
                    (is_v ? v_scales : k_scales) + dst_row * nb + blk);
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

// k, v (B, S, Hkv, dh) bf16 contiguous, 16-byte aligned, dh % 16 == 0;
// k_s32, v_s32 one f32 each; the four cache leaves contiguous
// (D0, D1, Hkv, dh/2) and (D0, D1, Hkv, dh/16) u8; pos (B,) int32 (S == 1)
// or null, then every sequence writes from `start`; block_tables
// (>= B, max_pages) int32 rows or null (fixed slots).
extern "C" int mixfp4_quant_kv(const void* k, const void* v,
                               const float* k_s32, const float* v_s32,
                               uint8_t* k_payload, uint8_t* k_scales,
                               uint8_t* v_payload, uint8_t* v_scales,
                               const int* pos, int start,
                               const int* block_tables, int max_pages, int b,
                               int s, int hkv, int dh, long long d0, int d1,
                               void* stream) {
  if (dh % 16 || d1 <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long nblocks =
      static_cast<long long>(b) * s * hkv * (dh / 16);
  if (nblocks == 0) return 0;
  const int threads = 256;
  const dim3 grid(static_cast<unsigned>((nblocks + threads - 1) / threads),
                  2);
  quant_kv_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), k_s32, v_s32, k_payload,
      k_scales, v_payload, v_scales, pos, start, block_tables, max_pages, b,
      s, hkv, dh, d0, d1);
  return static_cast<int>(cudaGetLastError());
}
