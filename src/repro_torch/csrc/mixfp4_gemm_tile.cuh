// The main loop that the W4A16 kernel (mixfp4_gemm_w4a16.cu) and the W4A4
// kernels (mixfp4_gemm_w4a4.cu) share, in two variants over one K split:
//
//   decode  (M <= DECODE_MAX_M): grid (N / 64 column tiles, K splits); a
//           128-thread CTA owns one column tile and one split.  It issues
//           every weight byte of its split with cp.async at once (8 KB of
//           payload at a 256-deep split), the caller fills the activation
//           rows of the split into shared memory meanwhile, and the four
//           warps split the 64 columns (16 each, one scale block), so at
//           M <= 16 every warp runs useful MMAs.  Each CTA writes its f32
//           partial to a workspace (splits, M, NP); the last CTA of a
//           column tile to arrive (ticket: __threadfence + atomicAdd on a
//           per-tile counter, which it resets) adds the partials in split
//           order, scales and writes y.  One launch, no memset, no second
//           kernel.  Instruction issue and latency bound it at decode M
//           (PERF.md): the decode is exact bit arithmetic (decode_pair),
//           about six instructions per payload byte.
//   prefill (M > DECODE_MAX_M): a 64x64 output tile per 128-thread CTA,
//           32-deep slabs decoded into shared memory, warps split the rows;
//           the split partials are summed in shared memory (SplitSum).
//
// Rows bitwise independent of M: both variants run the same mma.sync
// m16n8k16 bf16 -> f32 on the same exact bf16 operands, start each split's
// accumulator from zero, run its k16 steps in order up to the split's end
// rounded up to 32 (zero operands past K), add the split partials in split
// order to a zero-initialised sum, and only then apply the scale.  The
// split boundaries (multiples of split_k, the last at K) come from K alone
// (kernels/tuning.py), so a row's output does not depend on how many rows
// share its call, and two identical calls are bitwise equal.
//
// Weight decode: two K-adjacent nibbles per payload byte (low = even row)
// give one bf16 pair of the mma B fragment; a decoded value times its E4M3
// block scale has at most 7 significant bits, so the bf16 operand is exact.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mixfp4_block_math.cuh"

namespace mixfp4 {

// prefill tile
constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int LDA = BK + 8;  // bf16 per A row: 80 B, 16-byte aligned rows
constexpr int LDB = BK + 2;  // bf16 per B row: 17 words, spreads banks

// decode variant
constexpr int DECODE_MAX_M = 64;
constexpr int DBN = 64;            // column tile: 4 warps x 16 columns
constexpr int DTHREADS = 128;      // threads of a decode CTA
constexpr int WP_LD = DBN + 16;    // payload bytes per shared row (banks)
constexpr int MAX_SPLIT_K = 256;   // keeps the shared tile under 48 KB and
                                   // the scale bytes at one per thread

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16x2_mul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t bf16x2_sub(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// the block scale s (an E4M3 value, exact in bf16) as a bf16 pair
__device__ __forceinline__ uint32_t scale_pair(float s) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(s, s);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Both nibbles of a payload byte b (< 256) in the format E1M2 (else E2M1),
// times the scale pair s2: the bf16 pair of the mma operand (low nibble =
// even K row in the low half), bit for bit bf16(decode_nibble(nib, t) * s),
// signed zeros included, without a conversion instruction:
//   E2M1: the magnitude bits [e1 e0 m] become the two low exponent bits
//         and the top mantissa bit of a bf16, which is 2^-126 times the
//         E2M1 value (subnormal when e = 0); times 2^126 is exact;
//   E1M2: the magnitude p becomes the mantissa of bf16(8 + p); minus 8.
// Every product is exact (at most 7 significant bits), so bf16 rounding
// never acts; bf16 arithmetic keeps subnormals.  The format is a template
// argument so a caller branches once for many bytes (a branch-free select
// of per-format constants measured slower).
template <bool E1M2>
__device__ __forceinline__ uint32_t decode_pair(uint32_t b, uint32_t s2) {
  const uint32_t sgn = (b * 0x01001000u) & 0x80008000u;    // bits 3, 7
  uint32_t v;
  if constexpr (E1M2) {
    v = ((b * 0x00010010u) & 0x00700070u) | 0x41004100u;   // 8 + p
    v = bf16x2_sub(v, 0x41004100u) | sgn;
  } else {
    v = bf16x2_mul(((b * 0x00040040u) & 0x01C001C0u) | sgn,
                   0x7E807E80u);                            // 2^126
  }
  return bf16x2_mul(v, s2);
}

// 16 values as bf16 into dst (16-byte aligned) with two 16-byte stores
__device__ __forceinline__ void put16(__nv_bfloat16* dst,
                                      const float (&v)[16]) {
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    __nv_bfloat162 p;
    p.x = __float2bfloat16_rn(v[2 * i]);
    p.y = __float2bfloat16_rn(v[2 * i + 1]);
    w[i] = *reinterpret_cast<uint32_t*>(&p);
  }
  uint4* d = reinterpret_cast<uint4*>(dst);
  d[0] = make_uint4(w[0], w[1], w[2], w[3]);
  d[1] = make_uint4(w[4], w[5], w[6], w[7]);
}

// ---------------------------------------------------------------------------
// prefill tile
// ---------------------------------------------------------------------------

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
  const uint32_t s2 = scale_pair(e4m3_value(sb & 0x7F));
  uint32_t v[8];
  if (sb >> 7) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = decode_pair<true>(((j < 4 ? raw.x : raw.y) >> (8 * (j & 3))) &
                               0xFF, s2);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = decode_pair<false>(((j < 4 ? raw.x : raw.y) >> (8 * (j & 3))) &
                                0xFF, s2);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
    *reinterpret_cast<uint32_t*>(&Bs[c8 + j][2 * pr]) = v[j];
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

template <int A, int B>
__device__ __forceinline__ void zero_acc(float (&acc)[A][B]) {
#pragma unroll
  for (int i = 0; i < A; ++i)
#pragma unroll
    for (int j = 0; j < B; ++j) acc[i][j] = 0.0f;
}

// The prefill tile's split-order sum lives in shared memory, one column
// of 32 floats per thread (conflict-free, no barrier: each thread owns its
// column), so the second accumulator costs no registers.
struct SplitSum {
  float v[32][128];
};

__device__ __forceinline__ void sum_zero(SplitSum& s, int tid) {
#pragma unroll
  for (int i = 0; i < 32; ++i) s.v[i][tid] = 0.0f;
}

// sum += part, element by element (the split-order reduction)
__device__ __forceinline__ void sum_add(SplitSum& s, const float (&part)[8][4],
                                        int tid) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      s.v[4 * i + j][tid] = s.v[4 * i + j][tid] + part[i][j];
}

__device__ __forceinline__ void sum_load(float (&acc)[8][4],
                                         const SplitSum& s, int tid) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = s.v[4 * i + j][tid];
}

// the end of the K split that starts at ks0, rounded up to whole slabs:
// both variants run k16 steps up to here, with zero operands past K
__device__ __forceinline__ int split_end(int ks0, int split_k, int k) {
  const int end = min(ks0 + split_k, k);
  return (end + BK - 1) / BK * BK;
}

// ---------------------------------------------------------------------------
// decode variant
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The decode CTA's shared memory, carved from the dynamic allocation:
//   wp  (split_k / 2) x WP_LD payload bytes of the split's column tile,
//   as  m x lda bf16 activation rows of the split (lda = split_k + 8),
//   wsc (split_k / 16) x 4 block scales as bf16 pairs, the type bit in
//       bit 31 (the scale is positive, so its own sign bits are 0).
struct DecodeSmem {
  uint8_t* wp;
  __nv_bfloat16* as;
  uint32_t* wsc;
  int lda;
};

__host__ __device__ inline size_t decode_smem_bytes(int m, int split_k) {
  return static_cast<size_t>(split_k / 2) * WP_LD +
         static_cast<size_t>(m) * (split_k + 8) * 2 + (split_k / 16) * 16;
}

__device__ __forceinline__ DecodeSmem decode_smem(uint8_t* base, int m,
                                                  int split_k) {
  DecodeSmem s;
  s.wp = base;
  s.as = reinterpret_cast<__nv_bfloat16*>(base + (split_k / 2) * WP_LD);
  s.wsc = reinterpret_cast<uint32_t*>(
      base + (split_k / 2) * WP_LD +
      static_cast<size_t>(m) * (split_k + 8) * 2);
  s.lda = split_k + 8;
  return s;
}

// Issue the split's payload tile with cp.async (zero past K or nw) and
// start the load of this thread's scale byte (split_k / 16 x 4 of them,
// at most one per thread), which the caller hands to store_scale once it
// has issued its activation loads too, so the three loads overlap.
__device__ __forceinline__ uint32_t issue_weight_split(
    const DecodeSmem& sm, const uint8_t* __restrict__ wp,
    const uint8_t* __restrict__ ws, int ks0, int split_k, int n0, int k,
    int nw, int tid) {
  const int rows = split_k / 2;
  for (int c = tid; c < rows * (DBN / 16); c += DTHREADS) {
    const int r = c >> 2, cc = (c & 3) * 16;
    const int gk2 = ks0 / 2 + r, gn = n0 + cc;
    const bool ok = gk2 < k / 2 && gn < nw;
    cp_async16(sm.wp + r * WP_LD + cc,
               ok ? wp + static_cast<size_t>(gk2) * nw + gn : wp, ok);
  }
  const int gk16 = ks0 / 16 + (tid >> 2), gn16 = n0 / 16 + (tid & 3);
  return (tid < (split_k / 16) * 4 && gk16 < k / 16 && gn16 < nw / 16)
             ? ws[static_cast<size_t>(gk16) * (nw / 16) + gn16]
             : 0;
}

// the scale table entry of this thread's scale byte sb
__device__ __forceinline__ void store_scale(const DecodeSmem& sm,
                                            uint32_t sb, int split_k,
                                            int tid) {
  if (tid < (split_k / 16) * 4)
    sm.wsc[tid] = scale_pair(e4m3_value(sb & 0x7F)) | ((sb >> 7) << 31);
}

// The decode variant's m16 row tiles: 1 for M <= 16, 2 for M <= 32, else 4
// (the accumulator is sized at compile time, so small M keeps few registers
// and more CTAs fit on an SM).
inline int decode_mtiles(int m) { return m <= 16 ? 1 : (m <= 32 ? 2 : 4); }

// acc[mt][t] (rows mt*16..; the warp's 16 columns, one scale block, as two
// n8 tiles) over the split's k16 steps.  Tile t takes column 2g + t of the
// warp's as its B column g, so a lane's two tiles take one 16-bit load
// per payload row.
template <int MT>
__device__ __forceinline__ void mma_split(const DecodeSmem& sm, int m,
                                          int steps, float (&acc)[MT][2][4],
                                          int warp, int lane) {
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) zero_acc(acc[mt]);
#pragma unroll 2
  for (int j = 0; j < steps; ++j) {
    const uint8_t* p = sm.wp + (j * 8 + tq) * WP_LD + warp * 16 + 2 * g;
    const uint32_t lo = *reinterpret_cast<const uint16_t*>(p);
    const uint32_t hi = *reinterpret_cast<const uint16_t*>(p + 4 * WP_LD);
    const uint32_t w = sm.wsc[j * 4 + warp];
    const uint32_t s2 = w & 0x7FFFFFFFu;
    uint32_t b[2][2];  // [tile][register]
    if (w >> 31) {     // warp-uniform: one branch for the step
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        b[t][0] = decode_pair<true>((lo >> (8 * t)) & 0xFF, s2);
        b[t][1] = decode_pair<true>((hi >> (8 * t)) & 0xFF, s2);
      }
    } else {
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        b[t][0] = decode_pair<false>((lo >> (8 * t)) & 0xFF, s2);
        b[t][1] = decode_pair<false>((hi >> (8 * t)) & 0xFF, s2);
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (mt * 16 >= m) break;
      const int r0 = mt * 16 + g, r1 = r0 + 8;
      const __nv_bfloat16* a0 = sm.as + r0 * sm.lda + j * 16 + 2 * tq;
      const __nv_bfloat16* a1 = sm.as + r1 * sm.lda + j * 16 + 2 * tq;
      uint32_t a[4];
      a[0] = r0 < m ? *reinterpret_cast<const uint32_t*>(a0) : 0u;
      a[1] = r1 < m ? *reinterpret_cast<const uint32_t*>(a1) : 0u;
      a[2] = r0 < m ? *reinterpret_cast<const uint32_t*>(a0 + 8) : 0u;
      a[3] = r1 < m ? *reinterpret_cast<const uint32_t*>(a1 + 8) : 0u;
      mma_bf16(acc[mt][0], a, b[0][0], b[0][1]);
      mma_bf16(acc[mt][1], a, b[1][0], b[1][1]);
    }
  }
}

// Write the CTA's partial to work (splits, m, np); the last CTA of the
// column tile to arrive adds all partials in split order (loads issued 8
// splits at a time), scales, writes y (m, n) and resets the tile's
// counter.
template <int MT>
__device__ __forceinline__ void finish_split(
    const float (&acc)[MT][2][4], float* __restrict__ work,
    int* __restrict__ counters, const float* __restrict__ scale, int per_row,
    float* __restrict__ y, int m, int n, int np, int n0, int split,
    int splits, int tid) {
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  // C column c of tile t is column 2c + t of the warp's: a lane's four
  // values of a row are adjacent
  const int col = n0 + warp * 16 + 4 * tq;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = mt * 16 + g + 8 * h;
      if (row < m)
        *reinterpret_cast<float4*>(
            work + (static_cast<size_t>(split) * m + row) * np + col) =
            make_float4(acc[mt][0][2 * h], acc[mt][1][2 * h],
                        acc[mt][0][2 * h + 1], acc[mt][1][2 * h + 1]);
    }
  }
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&counters[blockIdx.x], 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  constexpr int RB = 8;
  const size_t stride = static_cast<size_t>(m) * np;
  for (int i = tid; i < m * DBN; i += DTHREADS) {
    const int row = i / DBN, c = n0 + i % DBN;
    const float* src = work + static_cast<size_t>(row) * np + c;
    float sum = 0.0f;
    for (int s0 = 0; s0 < splits; s0 += RB) {
      float v[RB];
#pragma unroll
      for (int u = 0; u < RB; ++u)
        v[u] = s0 + u < splits ? __ldcg(src + (s0 + u) * stride) : 0.0f;
#pragma unroll
      for (int u = 0; u < RB; ++u)
        if (s0 + u < splits) sum = sum + v[u];
    }
    if (c < n)
      y[static_cast<size_t>(row) * n + c] = sum * scale[per_row ? row : 0];
  }
  if (tid == 0) counters[blockIdx.x] = 0;
}

// Launch-time checks shared by every entry: 0 or a cudaError_t.
inline int check_plan(int m, int split_k, int decode) {
  if (split_k < BK || split_k % BK || split_k > MAX_SPLIT_K)
    return static_cast<int>(cudaErrorInvalidValue);
  if (decode && m > DECODE_MAX_M)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace mixfp4
