// The expert stack's decode variant of the W4A16 GEMM (C <= DECODE_MAX_M
// rows per expert), included by mixfp4_gemm_w4a16.cu:
//   y[e] (C, N) f32 = bf16(x[e]) (C, K) @ decode(W[e]) (K, N) * scale32[e].
//
// Replaces: the decode launches of the reference's lax.map of
// mixfp4_gemm_w4a16 over an MoE stack (src/repro/models/moe.py ::
// _expert_ffn, src/repro/kernels/mixfp4_gemm.py :: mixfp4_gemm_w4a16).
//
// Bound: bytes.  At decode C (cap + 1 rows, 5 at B = 4) every product is a
// few rows times a weight byte read once, so the least time is the packed
// weight bytes of the experts that hold a row over the memory rate.  What
// holds it back on the H100 (PERF.md §6) is the decode: a k16 step decodes
// 4 payload bytes a lane (about 6 instructions a byte) for one MMA per 8
// rows, so the SMs' issue rate, not the bytes, sets the pace.
//
// Design: one CTA per (expert, column tile of TN = 16 * WARPS columns);
// each warp owns one 16-column scale block, as in the 2-D decode variant.
//   1. Prologue: the CTA reads its expert's activation rows (C x K bf16)
//      once and marks each 256-deep K split that holds a non-zero element
//      ((bits & 0x7FFF) != 0: NaN and Inf count as non-zero).  The
//      non-zero splits, in order, are the CTA's work list.  An expert that
//      received no token has an empty list: its CTA writes 0 * scale32 and
//      exits without requesting a weight byte.
//   2. A ring of `stages` shared-memory slots (2 to 4) holds one listed
//      split each: its payload tile (cp.async, 16 bytes a thread) and its
//      activation slice, one cp.async group per split, issued stages - 1
//      splits ahead of the one being multiplied.  The scale bytes of the
//      listed splits are read once, while the first splits' loads fly,
//      into a table of bf16 scale pairs.
//   3. Each listed split is summed from zero with mma.sync m16n8k16 in the
//      2-D decode variant's k16 order and K fragment positions (mma_split
//      in mixfp4_gemm_tile.cuh), the operands swapped (the decoded weight
//      is the m16 operand, up to 8 activation rows the n8 one), and added
//      in split order to a zero-initialised f32 sum held in registers; the
//      sum times scale32[e] is written to y.
//      No workspace, no counters, no fence: the CTA owns its outputs.
//
// The decode takes the format from the step's scale word without a branch
// (decode_pair_any, bit for bit decode_pair), so the compiler can overlap
// the steps of the unrolled loop; the loop walks pointers and hoists the
// row guards so that little else is issued beside the decode.
//
// Bitwise the 2-D entry on the expert's slice, rows independent of C: the
// same exact bf16 operands at the same K positions of the same MMA shape
// (a product is exact, so swapping the operands changes no sum), the same
// chain per split, the same split-order sum from +0.  A skipped split changes no bit: its operands
// are +-0 activations times finite weights (a decoded MixFP4 weight has at
// most 7 significant bits times an E4M3 scale of at most 448), so every
// product and the split's partial are +-0; the sum, which starts at +0 and
// so is never -0 (round to nearest gives +0 for x + -x), is unchanged by
// adding +-0.  The one input where skipping and computing differ is a scale
// byte whose low 7 bits are 0x7F (E4M3 NaN): 0 * NaN is NaN.  The quantizer
// never writes it (core/formats.py, E4M3_MAX = 448).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mixfp4_gemm_tile.cuh"

namespace mixfp4 {

constexpr int EXPERT_MIN_STAGES = 2;
constexpr int EXPERT_MAX_STAGES = 4;
constexpr int EXPERT_SMEM_LIMIT = 232448;   // dynamic shared memory a CTA
                                            // can use on sm_90

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `pending` (0 to 2) cp.async groups are in flight
__device__ __forceinline__ void cp_async_wait_pending(int pending) {
  if (pending >= 2)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else if (pending == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t bf16x2_fma(uint32_t a, uint32_t b,
                                               uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// decode_pair without a branch on the format: the format-dependent
// constants of a step's scale word w (the type bit in bit 31, the scale
// pair below), selected once for the step's bytes
struct DecodeConsts {
  uint32_t k1, m1, or1, fm, fa, s2;
};

__device__ __forceinline__ DecodeConsts decode_consts(uint32_t w) {
  const bool e1m2 = w >> 31;
  DecodeConsts d;
  d.k1 = e1m2 ? 0x00010010u : 0x00040040u;   // magnitude bits' place
  d.m1 = e1m2 ? 0x00700070u : 0x01C001C0u;
  d.or1 = e1m2 ? 0x41004100u : 0u;           // bf16(8 + p)
  d.fm = e1m2 ? 0x3F803F80u : 0x7E807E80u;   // times 1, or 2^126
  d.fa = e1m2 ? 0xC100C100u : 0x80008000u;   // plus -8, or -0
  d.s2 = w & 0x7FFFFFFFu;
  return d;
}

// Bit for bit decode_pair<E1M2>(b, s2) for the format of dc: the magnitude
// as a bf16 pair (E2M1: 2^-126 times the value, E1M2: 8 + p), one exact
// fma to the value (times 2^126 plus -0 keeps +0; 8 + p - 8 is p, +0 at
// p = 0), the sign bits, the scale pair: every step exact, as there.
__device__ __forceinline__ uint32_t decode_pair_any(uint32_t b,
                                                    const DecodeConsts& dc) {
  uint32_t v = ((b * dc.k1) & dc.m1) | dc.or1;
  v = bf16x2_fma(v, dc.fm, dc.fa) | ((b * 0x01001000u) & 0x80008000u);
  return bf16x2_mul(v, dc.s2);
}

// The CTA's dynamic shared memory:
//   ring  stages x (payload (split_k / 2) x (TN + 16) bytes, then the
//         activation slice m x (split_k + 8) bf16),
//   wsc   splits x (split_k / 16) x WARPS scale pairs (type bit in bit 31),
//   flag  splits ints, list splits + 1 ints (the work list, then its size).
struct ExpertSmem {
  int pay_bytes, stage_bytes, lda;
  uint8_t* ring;
  uint32_t* wsc;
  int* flag;
  int* list;
};

__host__ __device__ inline size_t expert_stage_bytes(int m, int split_k,
                                                     int tn) {
  return static_cast<size_t>(split_k / 2) * (tn + 16) +
         static_cast<size_t>(m) * (split_k + 8) * 2;
}

__host__ __device__ inline size_t expert_smem_bytes(int m, int k,
                                                    int split_k, int warps,
                                                    int stages) {
  const int splits = (k + split_k - 1) / split_k;
  return stages * expert_stage_bytes(m, split_k, 16 * warps) +
         static_cast<size_t>(splits) * (split_k / 16) * warps * 4 +
         (2 * static_cast<size_t>(splits) + 1) * 4;
}

__device__ __forceinline__ ExpertSmem expert_smem(uint8_t* base, int m,
                                                  int k, int split_k,
                                                  int warps, int stages) {
  ExpertSmem s;
  const int splits = (k + split_k - 1) / split_k;
  s.pay_bytes = (split_k / 2) * (16 * warps + 16);
  s.stage_bytes = static_cast<int>(expert_stage_bytes(m, split_k, 16 * warps));
  s.lda = split_k + 8;
  s.ring = base;
  s.wsc = reinterpret_cast<uint32_t*>(base + stages * s.stage_bytes);
  s.flag = reinterpret_cast<int*>(s.wsc + splits * (split_k / 16) * warps);
  s.list = s.flag + splits;
  return s;
}

// Issue the listed split `s` into ring slot `slot`: the payload rows and
// the activation columns up to the split's end rounded to 32 (zero past K
// or the stored width nw).
template <int WARPS>
__device__ __forceinline__ void expert_issue_split(
    const ExpertSmem& sm, int slot, int s, const __nv_bfloat16* __restrict__ x,
    const uint8_t* __restrict__ wp, int m, int k, int nw, int n0, int split_k,
    int tid) {
  constexpr int NT = WARPS * 32, TN = WARPS * 16, LD = TN + 16;
  uint8_t* st = sm.ring + slot * sm.stage_bytes;
  const int ks0 = s * split_k;
  const int depth = split_end(ks0, split_k, k) - ks0;
  for (int c = tid; c < (depth / 2) * (TN / 16); c += NT) {
    const int r = c / (TN / 16), cc = (c % (TN / 16)) * 16;
    const int gk2 = ks0 / 2 + r, gn = n0 + cc;
    const bool ok = gk2 < k / 2 && gn < nw;
    cp_async16(st + r * LD + cc,
               ok ? wp + static_cast<size_t>(gk2) * nw + gn : wp, ok);
  }
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(st + sm.pay_bytes);
  const int chunks = depth / 8;
  for (int c = tid; c < m * chunks; c += NT) {
    const int r = c / chunks, cc = c % chunks;
    const int gk = ks0 + cc * 8;
    const bool ok = gk < k;
    cp_async16(as + r * sm.lda + cc * 8,
               ok ? x + static_cast<size_t>(r) * k + gk : x, ok);
  }
}

__device__ __forceinline__ void zero_acc4(float (&acc)[4]) {
  acc[0] = acc[1] = acc[2] = acc[3] = 0.0f;
}

// acc[r] (rows 8r.. of the expert, the warp's 16 columns) over the k16
// steps of the split in ring slot `slot` (first k16 block kb0 of the scale
// table).  The operands are swapped against mma_split: the decoded weight
// is the m16 operand A (its 16 rows are the warp's columns, row i column
// 2(i % 8) + i / 8, so a lane's two rows are the two adjacent columns of
// one 16-bit payload load) and the activation rows are the n8 operand B,
// so one MMA covers 8 rows where mma_split's m16 row tile takes two for
// the same 16 columns.  The K indices of a step keep mma_split's fragment
// positions (low nibble = even K; 2tq, 2tq + 1, + 8, + 9) and each output
// is the same exact products summed by the same instruction shape: bitwise
// mma_split's result (held on the card against the 2-D entry).  The
// operand pointers advance by a step's stride and the row guards are
// computed once.
template <int R, int WARPS>
__device__ __forceinline__ void expert_mma_split(const ExpertSmem& sm,
                                                 int slot, int kb0, int m,
                                                 int steps,
                                                 float (&acc)[R][4],
                                                 int warp, int lane) {
  constexpr int LD = WARPS * 16 + 16;
  const int g = lane >> 2, tq = lane & 3;
  const uint8_t* st = sm.ring + slot * sm.stage_bytes;
  const uint8_t* p = st + tq * LD + warp * 16 + 2 * g;
  const uint32_t* wsc = sm.wsc + kb0 * WARPS + warp;
  const uint32_t* xr[R];      // row 8r + g of the activation slice
  bool live[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    xr[r] = reinterpret_cast<const uint32_t*>(
        reinterpret_cast<const __nv_bfloat16*>(st + sm.pay_bytes) +
        (r * 8 + g) * sm.lda + 2 * tq);
    live[r] = r * 8 + g < m;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) zero_acc4(acc[r]);
#pragma unroll 4
  for (int j = 0; j < steps; ++j) {
    const uint32_t lo = *reinterpret_cast<const uint16_t*>(p);
    const uint32_t hi = *reinterpret_cast<const uint16_t*>(p + 4 * LD);
    const uint32_t w = *wsc;
    p += 8 * LD;
    wsc += WARPS;
    const DecodeConsts dc = decode_consts(w);
    uint32_t a[4];    // A[i][k]: rows g (column 2g) and g + 8 (column 2g + 1)
    a[0] = decode_pair_any(lo & 0xFF, dc);
    a[1] = decode_pair_any(lo >> 8, dc);
    a[2] = decode_pair_any(hi & 0xFF, dc);
    a[3] = decode_pair_any(hi >> 8, dc);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const uint32_t b0 = live[r] ? xr[r][0] : 0u;
      const uint32_t b1 = live[r] ? xr[r][4] : 0u;
      xr[r] += 8;                         // 16 bf16
      if (r * 8 < m) mma_bf16(acc[r], a, b0, b1);   // warp-uniform
    }
  }
}

template <int R>
__device__ __forceinline__ void add_partial(float (&sum)[R][4],
                                            const float (&acc)[R][4]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) sum[r][q] = sum[r][q] + acc[r][q];
}

// grid (column tiles, experts), WARPS * 32 threads; x (E, m, k), wp (E,
// k/2, nw), ws (E, k/16, nw/16), s32 (E,), y (E, m, n), all contiguous
template <int R, int WARPS>
__global__ void __launch_bounds__(WARPS * 32) w4a16_experts_decode_kernel(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ wp,
    const uint8_t* __restrict__ ws, const float* __restrict__ s32,
    float* __restrict__ y, int m, int k, int nw, int n, int split_k,
    int stages) {
  constexpr int NT = WARPS * 32, TN = WARPS * 16;
  const size_t e = blockIdx.y;
  x += e * m * k;
  wp += e * (k / 2) * nw;
  ws += e * (k / 16) * (nw / 16);
  y += e * m * n;
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * TN;
  const int splits = (k + split_k - 1) / split_k;
  const ExpertSmem sm = expert_smem(smem, m, k, split_k, WARPS, stages);

  // 1. the splits whose activations hold a non-zero element
  for (int s = tid; s < splits; s += NT) sm.flag[s] = 0;
  __syncthreads();
  {
    const int kc = k / 8;                 // 16-byte chunks per row
    const int total = m * kc;
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    for (int c0 = tid; c0 < total; c0 += 8 * NT) {   // 8 loads in flight
      uint4 v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int c = c0 + u * NT;
        v[u] = c < total ? __ldg(xv + c) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int c = c0 + u * NT;
        if ((v[u].x | v[u].y | v[u].z | v[u].w) & 0x7FFF7FFFu)
          sm.flag[(c % kc) * 8 / split_k] = 1;
      }
    }
  }
  __syncthreads();
  if (tid == 0) {
    int cnt = 0;
    for (int s = 0; s < splits; ++s)
      if (sm.flag[s]) sm.list[cnt++] = s;
    sm.list[splits] = cnt;
  }
  __syncthreads();
  const int cnt = sm.list[splits];

  // 2. the ring's first stages - 1 splits, then the listed splits' scales
  for (int i = 0; i < stages - 1; ++i) {
    if (i < cnt)
      expert_issue_split<WARPS>(sm, i, sm.list[i], x, wp, m, k, nw, n0,
                                split_k, tid);
    cp_async_commit();
  }
  {
    const int per = (split_k / 16) * WARPS;   // scale bytes per split
    const int gn16 = n0 / 16 + (tid % WARPS);
    for (int c0 = tid; c0 < cnt * per; c0 += 4 * NT) {
      uint32_t sb[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {       // c % WARPS == tid % WARPS
        const int c = c0 + u * NT;
        const int gk16 = (c < cnt * per)
                             ? sm.list[c / per] * (split_k / 16) +
                                   (c % per) / WARPS
                             : k;
        sb[u] = (gk16 < k / 16 && gn16 < nw / 16)
                    ? __ldg(ws + static_cast<size_t>(gk16) * (nw / 16) + gn16)
                    : 0u;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = c0 + u * NT;
        if (c < cnt * per)
          sm.wsc[(sm.list[c / per] * (split_k / 16) + (c % per) / WARPS) *
                     WARPS + c % WARPS] =
              scale_pair(e4m3_value(sb[u] & 0x7F)) | ((sb[u] >> 7) << 31);
      }
    }
  }

  // 3. each listed split from zero, added in split order
  float sum[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r) zero_acc4(sum[r]);
  for (int i = 0; i < cnt; ++i) {
    cp_async_wait_pending(stages - 2);
    __syncthreads();      // slot i landed for all; slot i - 1 is free
    const int ahead = i + stages - 1;
    if (ahead < cnt)
      expert_issue_split<WARPS>(sm, ahead % stages, sm.list[ahead], x, wp, m,
                                k, nw, n0, split_k, tid);
    cp_async_commit();
    const int ks0 = sm.list[i] * split_k;
    float acc[R][4];
    expert_mma_split<R, WARPS>(sm, i % stages, ks0 / 16, m,
                               (split_end(ks0, split_k, k) - ks0) / 16, acc,
                               warp, lane);
    add_partial(sum, acc);
  }
  cp_async_wait_all();

  // y = sum * scale32[e]: a lane holds rows 8r + 2tq, + 1 of the warp's
  // columns 2g, 2g + 1 (C fragment: D[i][j], i the column, j the row)
  const float scale = s32[e];
  const int g = lane >> 2, tq = lane & 3;
  const int col = n0 + warp * 16 + 2 * g;
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r * 8 + 2 * tq + h;
      if (row >= m) continue;
      const float v0 = sum[r][h] * scale, v1 = sum[r][2 + h] * scale;
      float* dst = y + static_cast<size_t>(row) * n + col;
      if ((n & 1) == 0 && col + 1 < n) {
        *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
      } else {
        if (col < n) dst[0] = v0;
        if (col + 1 < n) dst[1] = v1;
      }
    }
  }
}

}  // namespace mixfp4
