// One-token decode attention over a packed MixFP4 KV cache for sm_90a,
// flash-decoding with the keys split across CTAs and the splits reduced in
// the same launch: the fixed-slot cache and the paged pool, one kernel body
// for both.
//
// Replaces: src/repro/kernels/mixfp4_attn.py :: mixfp4_attn_decode
//           (:174; _attn_decode_kernel, _flash_step, _decode_kv_block) and
//           :: mixfp4_attn_decode_paged (:253; _attn_decode_paged_kernel).
//
// Bound: bytes.  A step reads each valid cache row once (dh/2 payload +
// dh/16 scale bytes for K and again for V) for ~4*g*dh flops per row, far
// below the rate at which the card could compute on it.  The paged entry
// also reads each sequence's block table.  At decode batch sizes the
// bytes are a few MB, so what the design fights is latency: enough CTAs,
// enough bytes in flight in each, and no chain of CTA-wide barriers.
//
// Design: one 256-thread CTA per (sequence, kv head, key split).  Splits
// start at multiples of SPLIT_S in logical key position (kernels/tuning.py
// holds the same constant), so which keys a CTA owns depends on the key
// positions alone, never on B, the cache capacity or the lengths of other
// sequences.  A CTA takes the valid keys of its split, [a, e) = its split
// intersected with the masks kpos < len and, for a window w > 0,
// kpos > len - 1 - w; a split without one exits at once.  Warp w owns the
// 32 keys a + 32w .. a + 32w + 31 (those below e) and works alone:
//   1. lane j translates key j's row once (paged: the warp loads the
//      block-table entry of each of its pages once and shares it by
//      shuffle);
//   2. the warp issues its keys' K rows, then their V rows, with cp.async
//      (16 bytes per copy where the rows allow), two groups, so V arrives
//      while K is scored;
//   3. scores: each lane takes 8 head dims (one 32-bit payload word, one
//      scale byte per key), decodes its nibbles through a 32-entry shared
//      table (Fig. 9: E2M1 and E1M2 values) and dots them with its q slice
//      for all g heads of the kv head; each 4 keys' 4g products are summed
//      over the warp by a reduce-scatter of shuffles; scores scale by
//      dh^-0.5, then the softcap c*tanh(s/c) (expf / tanhf, never the fast
//      intrinsics);
//   4. per head, the softmax over the warp's keys with warp shuffles: m, p
//      = expf(s - m), l;
//   5. p * V into per-lane registers (8 dims of every head).
// After one barrier the CTA merges its 8 warps' states in warp order (m =
// max, weights expf(m_w - m)) and writes (acc[g][dh], m[g], l[g]) to the
// f32 workspace.  A group of more than MAXG = 8 heads (StarCoder2-15B: 48
// heads over 4 kv heads, g = 12) is walked in passes of at most 8 heads
// (the PASSES instantiation): the keys are staged once, and each pass runs
// steps 3-5 and the warp merge for its heads from the staged bytes.  The
// registers of a pass are those of a group of 8; a group of 8 or fewer is
// compiled without the pass loop, the code and arithmetic it always was.
// The last CTA of a (sequence, kv head) to take a ticket
// (__threadfence + atomicAdd on its counter, which it resets) merges the
// splits the same way, in split order, and writes acc / l where l > 0.
// Only splits that hold a valid key take part, so an empty split can
// never change the bits.  A sequence with no valid key gets zeros from its
// split-0 CTA.  One launch, no memset.
//
// Paged pool: the kernel is a template over its row-address policy and
// nothing else.  FixedRows addresses logical row j of sequence b at
// (b*S + j); PagedRows at (bt[b, j / page_len]*page_len + j % page_len).
// Both entries are instantiated from this one source with the same flags,
// and a key's row index is the only place the address enters, so the
// paged output equals the fixed kernel's on the gathered rows bit for bit,
// and a sequence's output is bitwise the same whatever B or S is.  Rows at
// or past a sequence's length are never read, so the pool's trash page 0
// (where unused table entries point) is never read for a live position.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mixfp4_block_math.cuh"

namespace {

using mixfp4::decode_nibble;
using mixfp4::e4m3_value;

constexpr int NT = 256;          // threads per CTA
constexpr int NW = NT / 32;      // warps
constexpr int BS = 32;           // keys per warp
constexpr int SPLIT_S = 256;     // keys per split (kernels/tuning.py)
static_assert(SPLIT_S == NW * BS, "a split is one 32-key block per warp");
constexpr int KG = 4;            // keys per reduce-scatter
constexpr int MAXG = 8;          // most query heads in one pass
constexpr int MAX_DH = 256;
constexpr float NEG_INF = -1e30f;

// Row-address policies: the row of logical key j (this lane's key) of
// sequence b, among the keys j0 .. j0 + BS - 1 of the lane's warp.  Every
// lane of the warp calls it.
struct FixedRows {
  int s_len;
  __device__ __forceinline__ int row(int b, int j, int, int) const {
    return b * s_len + j;
  }
};

struct PagedRows {
  const int* bt;   // (B, max_pages) int32
  int max_pages, page_len;
  __device__ __forceinline__ int row(int b, int j, int j0, int lane) const {
    const int p0 = j0 / page_len;
    const int np = (j0 + BS - 1) / page_len - p0 + 1;  // <= 3 pages
    const int entry = lane < np && p0 + lane < max_pages
                          ? bt[static_cast<size_t>(b) * max_pages + p0 + lane]
                          : 0;
    const int p = j / page_len;
    const int page = __shfl_sync(0xffffffffu, entry, p - p0);
    return page * page_len + (j - p * page_len);
  }
};

// one chunk of w bytes (16, 8 or 4 by cp.async; 1 = a plain byte copy)
__device__ __forceinline__ void copy_chunk(uint8_t* dst, const uint8_t* src,
                                           int w) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  switch (w) {
    case 16:
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                   "l"(src));
      break;
    case 8:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                   "l"(src));
      break;
    case 4:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                   "l"(src));
      break;
    default:
      *dst = *src;
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The warp's n rows (row r at dst + r*rb; lane r's global row index is
// row) of rb bytes each, in chunks of w bytes.  Every lane calls it.
__device__ __forceinline__ void stage(uint8_t* dst,
                                      const uint8_t* __restrict__ src,
                                      int row, int n, int rb, int w,
                                      int lane) {
  const int per_row = rb / w, total = n * per_row;
  for (int i0 = 0; i0 < total; i0 += 32) {
    const int i = i0 + lane, r = min(i, total - 1) / per_row;
    const int grow = __shfl_sync(0xffffffffu, row, r);
    if (i < total) {
      const int c = (i - r * per_row) * w;
      copy_chunk(dst + r * rb + c,
                 src + static_cast<size_t>(grow) * rb + c, w);
    }
  }
}

__host__ __device__ constexpr int ilog2(int x) {
  return x > 1 ? 1 + ilog2(x / 2) : 0;
}

// Sum v[0 .. N) over the warp: lanes exchange halves of their live values
// at xor distances 16, 8, ... (the lanes with that bit set keep the upper
// half), then butterfly the last value over the remaining distances.  On
// return v[0] of lane l is the warp's sum of value l >> (5 - log2 N).  C is
// the number of live values, N a power of two <= 32.
template <int N, int C, int OFF = 16>
__device__ __forceinline__ void reduce_scatter(float (&v)[N], int lane) {
  if constexpr (C > 1) {
    const bool up = lane & OFF;
#pragma unroll
    for (int i = 0; i < C / 2; ++i) {
      const float send = up ? v[i] : v[i + C / 2];
      const float keep = up ? v[i + C / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
    }
    reduce_scatter<N, C / 2, OFF / 2>(v, lane);
  } else if constexpr (OFF > 0) {
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], OFF);
    reduce_scatter<N, 1, OFF / 2>(v, lane);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// a lane's 8 values of one packed row: payload word and scale byte ->
// the table values (the block scale is applied by the caller)
__device__ __forceinline__ void lut8(float (&v)[8], const float* lut,
                                     uint32_t word, uint32_t sbyte) {
  const float* lt = lut + ((sbyte >> 7) << 4);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = lt[(word >> (4 * i)) & 15];
}

// Shared memory: per warp its keys' K payload (BS x dh/2), K scales
// (BS x dh/16), V payload and V scales; the merge of the warps (NW x gp x
// dh acc, then NW x gp x (m, l), gp heads of one pass: g, or MAXG when
// the group takes passes), which reuses the staging when there is one
// pass and follows it when a later pass still reads the staged keys
// (its offset, a multiple of 16, is then merge_offset); then the nibble
// table and per warp its scores (gp x BS, then p).
__host__ __device__ inline size_t warp_stage_bytes(int dh) {
  return static_cast<size_t>(BS) * 2 * (dh / 2 + dh / 16);
}

__host__ __device__ inline size_t merge_offset(int dh) {
  return NW * warp_stage_bytes(dh);
}

template <bool PASSES>
__host__ __device__ inline size_t stage_bytes(int dh, int gp) {
  const size_t stage = NW * warp_stage_bytes(dh);
  const size_t merge = sizeof(float) * NW * gp * (dh + 2);
  if (PASSES) return (stage + merge + 15) / 16 * 16;
  return (stage > merge ? stage : merge + 15) / 16 * 16;
}

template <bool PASSES>
__host__ __device__ inline size_t smem_bytes(int dh, int gp) {
  return stage_bytes<PASSES>(dh, gp) + sizeof(float) * (32 + NW * gp * BS);
}

// One pass's start: q of heads h_first .. h_first + gc - 1 of sequence b
// (this lane's 8 dims; zeros past gc), and the empty softmax state.
template <int G>
__device__ __forceinline__ void load_pass(float (&qr)[G][8],
                                          float (&acc)[G][8],
                                          float (&m_w)[G], float (&l_w)[G],
                                          const float* __restrict__ q, int b,
                                          int h, int h_first, int gc,
                                          int lane, bool act, int dh) {
#pragma unroll
  for (int hh = 0; hh < G; ++hh) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      qr[hh][i] = act && hh < gc
                      ? q[(static_cast<size_t>(b) * h + h_first + hh) * dh +
                          lane * 8 + i]
                      : 0.0f;
      acc[hh][i] = 0.0f;
    }
    m_w[hh] = NEG_INF;
    l_w[hh] = 0.0f;
  }
}

// s_len: logical rows per sequence (S, or max_pages * page_len);
// wp, ws: copy widths of the payload and scale rows.  At dh = 256 the
// shared memory admits two CTAs per SM, so the launch bounds let each
// thread have 128 registers (without them ptxas kept 64 and spilled).
template <int G, bool PASSES, class Rows>
__global__ void __launch_bounds__(NT, 2) attn_decode_kernel(
    const float* __restrict__ q, const uint8_t* __restrict__ kp,
    const uint8_t* __restrict__ ks, const uint8_t* __restrict__ vp,
    const uint8_t* __restrict__ vs, const int* __restrict__ lengths,
    const float* __restrict__ s32, float* __restrict__ out,
    float* __restrict__ work, int* __restrict__ counters, Rows rows,
    int s_len, int h, int hkv, int dh, int window, float scale,
    float softcap, float inv_cap, int wp, int ws) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int last;
  const int g = h / hkv, pb = dh / 2, sb = dh / 16;
  const int bh = blockIdx.x, b = bh / hkv, kh = bh - b * hkv;
  const int sp = blockIdx.y, nsplit = gridDim.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int len = lengths[b];
  const int hi = min(len, s_len);
  const int lo = window > 0 ? max(0, len - window) : 0;
  float* o = out + (static_cast<size_t>(b) * h + kh * g) * dh;
  if (lo >= hi) {                 // no valid key: zeros, from split 0
    if (sp == 0)
      for (int i = tid; i < g * dh; i += NT) o[i] = 0.0f;
    return;
  }
  const int a = max(lo, sp * SPLIT_S), e = min(hi, (sp + 1) * SPLIT_S);
  if (a >= e) return;             // no valid key in this split

  uint8_t* kpay = smem + warp * warp_stage_bytes(dh);
  uint8_t* ksc = kpay + BS * pb;
  uint8_t* vpay = ksc + BS * sb;
  uint8_t* vsc = vpay + BS * pb;
  const int gp = PASSES ? G : g;  // heads of a full pass
  float* lut = reinterpret_cast<float*>(smem + stage_bytes<PASSES>(dh, gp));
  float* sc = lut + 32 + warp * gp * BS;  // this warp's gp x BS scores

  // this warp's keys: j0 .. j0 + nw - 1
  const int j0 = a + warp * BS, nw = max(0, min(BS, e - j0));
  if (nw > 0) {
    const int row =
        rows.row(b, j0 + min(lane, nw - 1), j0, lane) * hkv + kh;
    stage(kpay, kp, row, nw, pb, wp, lane);
    stage(ksc, ks, row, nw, sb, ws, lane);
    cp_async_commit();
    stage(vpay, vp, row, nw, pb, wp, lane);
    stage(vsc, vs, row, nw, sb, ws, lane);
  } else {
    cp_async_commit();
  }
  cp_async_commit();
  if (tid < 32) lut[tid] = decode_nibble(tid & 15, tid >> 4);

  // lane l owns head dims [8l, 8l + 8) of every head of the pass; a pass
  // takes heads h0 .. h0 + gc - 1 of the group (PASSES: passes of G heads;
  // otherwise one pass, gc = g <= G)
  const bool act = lane * 8 < dh;
  float qr[G][8], acc[G][8], m_w[G], l_w[G];
  int h0 = 0, gc = PASSES ? min(G, g) : g;
  load_pass<G>(qr, acc, m_w, l_w, q, b, h, kh * g, gc, lane, act, dh);
  const float s32k = s32[0], s32v = s32[1];
  __syncthreads();                // the nibble table

  while (true) {
    if (nw > 0) {
      cp_async_wait<1>();
      __syncwarp();
      // scores, KG keys at a time: after the reduce-scatter lane l holds
      // the sum of product (l >> (5 - log2 KG*G)) = k * G + hh
      for (int k0 = 0; k0 < nw; k0 += KG) {
        float dot[KG * G];
#pragma unroll
        for (int k = 0; k < KG; ++k) {
          const int t = k0 + k;
#pragma unroll
          for (int hh = 0; hh < G; ++hh) dot[k * G + hh] = 0.0f;
          if (act && t < nw) {
            const uint32_t word =
                *reinterpret_cast<const uint32_t*>(kpay + t * pb + lane * 4);
            const uint32_t sbyte = ksc[t * sb + (lane >> 1)];
            float v[8];
            lut8(v, lut, word, sbyte);
            const float s = e4m3_value(sbyte & 0x7F) * s32k;
#pragma unroll
            for (int hh = 0; hh < G; ++hh) {
              float d = 0.0f;
#pragma unroll
              for (int i = 0; i < 8; ++i) d += qr[hh][i] * v[i];
              dot[k * G + hh] = d * s;
            }
          }
        }
        reduce_scatter<KG * G, KG * G>(dot, lane);
        constexpr int SHIFT = 5 - ilog2(KG * G);
        const int jj = lane >> SHIFT, k = jj / G, hh = jj - k * G;
        if ((lane & ((1 << SHIFT) - 1)) == 0 && hh < gc && k0 + k < nw) {
          float s = dot[0] * scale;
          if (softcap > 0.0f) s = softcap * tanhf(s * inv_cap);
          sc[hh * BS + k0 + k] = s;
        }
      }
      __syncwarp();
#pragma unroll
      for (int hh = 0; hh < G; ++hh) {
        if (hh < gc) {
          const float s = lane < nw ? sc[hh * BS + lane] : NEG_INF;
          m_w[hh] = warp_max(s);
          const float p = lane < nw ? expf(s - m_w[hh]) : 0.0f;
          l_w[hh] = warp_sum(p);
          sc[hh * BS + lane] = p;
        }
      }
      cp_async_wait<0>();
      __syncwarp();
      if (act) {
#pragma unroll 4
        for (int t = 0; t < nw; ++t) {
          const uint32_t word =
              *reinterpret_cast<const uint32_t*>(vpay + t * pb + lane * 4);
          const uint32_t sbyte = vsc[t * sb + (lane >> 1)];
          float v[8];
          lut8(v, lut, word, sbyte);
          const float s = e4m3_value(sbyte & 0x7F) * s32v;
#pragma unroll
          for (int hh = 0; hh < G; ++hh) {
            const float w = hh < gc ? sc[hh * BS + t] * s : 0.0f;
#pragma unroll
            for (int i = 0; i < 8; ++i) acc[hh][i] += w * v[i];
          }
        }
      }
    }

    // merge the warps in warp order into the split's state (one pass: the
    // merge reuses the staging, which this barrier frees; more: it waits
    // for the last pass's merge to have been read)
    __syncthreads();
    float* red = reinterpret_cast<float*>(smem +
                                          (PASSES ? merge_offset(dh) : 0));
    float* wst = red + NW * gp * dh;             // NW x gp x (m, l)
#pragma unroll
    for (int hh = 0; hh < G; ++hh) {
      if (hh < gc) {
        if (act) {
#pragma unroll
          for (int i = 0; i < 8; ++i)
            red[(warp * gp + hh) * dh + lane * 8 + i] = acc[hh][i];
        }
        if (lane == 0) {
          wst[(warp * gp + hh) * 2] = m_w[hh];
          wst[(warp * gp + hh) * 2 + 1] = l_w[hh];
        }
      }
    }
    __syncthreads();
    const size_t pitch = static_cast<size_t>(g) * (dh + 2);
    float* part = work + static_cast<size_t>(bh) * nsplit * pitch +
                  sp * pitch;
    for (int hh = 0; hh < gc; ++hh) {
      float m = NEG_INF;
      for (int w = 0; w < NW; ++w) m = fmaxf(m, wst[(w * gp + hh) * 2]);
      for (int d = tid; d < dh; d += NT) {
        float l = 0.0f, acc_o = 0.0f;
        for (int w = 0; w < NW; ++w) {
          const float f = expf(wst[(w * gp + hh) * 2] - m);
          l += wst[(w * gp + hh) * 2 + 1] * f;
          acc_o += red[(w * gp + hh) * dh + d] * f;
        }
        part[(h0 + hh) * dh + d] = acc_o;
        if (d == 0) {
          part[g * dh + h0 + hh] = m;
          part[g * dh + g + h0 + hh] = l;
        }
      }
    }
    h0 += G;
    if (!PASSES || h0 >= g) break;
    gc = min(G, g - h0);
    load_pass<G>(qr, acc, m_w, l_w, q, b, h, kh * g + h0, gc, lane, act,
                 dh);
  }
  __threadfence();
  __syncthreads();
  const size_t pitch = static_cast<size_t>(g) * (dh + 2);
  const float* base = work + static_cast<size_t>(bh) * nsplit * pitch;
  const int first = lo / SPLIT_S, count = (hi - 1) / SPLIT_S - first + 1;
  if (tid == 0) last = atomicAdd(&counters[bh], 1) == count - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // merge the splits that hold a valid key, in split order: every thread
  // owns output dims of one head and reads the splits' states RB at a time
  // (each thread of a head computes the same m and l the same way)
  constexpr int RB = 8;
  const int end = first + count;
  for (int hh = 0; hh < g; ++hh) {
    const float* ms = base + g * dh + hh;
    const float* ls = ms + g;
    for (int d = tid; d < dh; d += NT) {
      float m = NEG_INF;
      for (int i0 = first; i0 < end; i0 += RB) {
        float mv[RB];
#pragma unroll
        for (int u = 0; u < RB; ++u)
          mv[u] = i0 + u < end ? __ldcg(ms + (i0 + u) * pitch) : NEG_INF;
#pragma unroll
        for (int u = 0; u < RB; ++u) m = fmaxf(m, mv[u]);
      }
      float l = 0.0f, acc_o = 0.0f;
      for (int i0 = first; i0 < end; i0 += RB) {
        float mv[RB], lv[RB], av[RB];
#pragma unroll
        for (int u = 0; u < RB; ++u) {
          const bool in = i0 + u < end;
          const size_t off = (i0 + u) * pitch;
          mv[u] = in ? __ldcg(ms + off) : NEG_INF;
          lv[u] = in ? __ldcg(ls + off) : 0.0f;
          av[u] = in ? __ldcg(base + off + hh * dh + d) : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < RB; ++u) {
          if (i0 + u < end) {
            const float w = expf(mv[u] - m);
            l += lv[u] * w;
            acc_o += av[u] * w;
          }
        }
      }
      o[hh * dh + d] = acc_o / (l > 0.0f ? l : 1.0f);
    }
  }
  if (tid == 0) counters[bh] = 0;
}

// the widest cp.async chunk (16, 8, 4 bytes) that divides a row of
// row_bytes and both base addresses; 1 = plain byte copies
int copy_width(int row_bytes, const void* x, const void* y) {
  const uintptr_t ax = reinterpret_cast<uintptr_t>(x);
  const uintptr_t ay = reinterpret_cast<uintptr_t>(y);
  for (int w = 16; w >= 4; w /= 2)
    if (row_bytes % w == 0 && ax % w == 0 && ay % w == 0) return w;
  return 1;
}

template <int G, bool PASSES, class Rows>
int launch_g(dim3 grid, size_t smem, cudaStream_t stream, const float* q,
             const uint8_t* kp, const uint8_t* ks, const uint8_t* vp,
             const uint8_t* vs, const int* lengths, const float* s32,
             float* out, float* work, int* counters, Rows rows, int s_len,
             int h, int hkv, int dh, int window, float scale, float softcap,
             float inv_cap) {
  auto kern = attn_decode_kernel<G, PASSES, Rows>;
  static size_t allowed[16] = {};   // dynamic smem opted into, per device
  int dev = 0;
  cudaGetDevice(&dev);
  if (smem > 48 * 1024 && (dev >= 16 || allowed[dev] < smem)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 16) allowed[dev] = smem;
  }
  kern<<<grid, NT, smem, stream>>>(
      q, kp, ks, vp, vs, lengths, s32, out, work, counters, rows, s_len, h,
      hkv, dh, window, scale, softcap, inv_cap,
      copy_width(dh / 2, kp, vp), copy_width(dh / 16, ks, vs));
  return static_cast<int>(cudaGetLastError());
}

template <class Rows>
int launch(const float* q, const uint8_t* kp, const uint8_t* ks,
           const uint8_t* vp, const uint8_t* vs, const int* lengths,
           const float* s32, float* out, float* work, int* counters,
           Rows rows, int b, int s_len, int h, int hkv, int dh, int window,
           float scale, float softcap, float inv_cap, int split_s,
           int splits, void* stream) {
  if (b == 0) return 0;
  const int g = hkv > 0 ? h / hkv : 0;
  if (g < 1 || h % hkv || dh > MAX_DH || dh % 16 || dh <= 0 ||
      split_s != SPLIT_S ||
      splits != max(1, (s_len + SPLIT_S - 1) / SPLIT_S))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(b * hkv, splits);
  const bool passes = g > MAXG;
  const size_t smem = passes ? smem_bytes<true>(dh, MAXG)
                             : smem_bytes<false>(dh, g);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ATTN_LAUNCH(GG, P)                                                \
  return launch_g<GG, P>(grid, smem, st, q, kp, ks, vp, vs, lengths, s32, \
                         out, work, counters, rows, s_len, h, hkv, dh,    \
                         window, scale, softcap, inv_cap)
  if (g == 1) ATTN_LAUNCH(1, false);
  if (g == 2) ATTN_LAUNCH(2, false);
  if (g <= 4) ATTN_LAUNCH(4, false);
  if (g <= MAXG) ATTN_LAUNCH(8, false);
  ATTN_LAUNCH(MAXG, true);        // passes of 8 heads
#undef ATTN_LAUNCH
}

}  // namespace

// q (B, H, dh) f32; K/V payload (B, S, Hkv, dh/2) u8 and scales
// (B, S, Hkv, dh/16) u8, all contiguous; lengths (B,) i32; s32 two f32 on
// the device (K, V); out (B, H, dh) f32.  dh <= 256, dh % 16 == 0,
// any H / Hkv.  scale = dh^-0.5; softcap 0 disables the cap.  work: f32,
// B * Hkv * splits * (H/Hkv) * (dh + 2) floats; counters: B * Hkv int32,
// zero (the kernel leaves them zero).  split_s must be SPLIT_S and splits
// ceil(S / SPLIT_S) (at least 1), as kernels/tuning.py :: attn_splits
// gives them.
extern "C" int mixfp4_attn_decode(const float* q, const uint8_t* kp,
                                  const uint8_t* ks, const uint8_t* vp,
                                  const uint8_t* vs, const int* lengths,
                                  const float* s32, float* out, float* work,
                                  int* counters, int b, int s, int h,
                                  int hkv, int dh, int window, int split_s,
                                  int splits, float scale, float softcap,
                                  float inv_cap, void* stream) {
  return launch(q, kp, ks, vp, vs, lengths, s32, out, work, counters,
                FixedRows{s}, b, s, h, hkv, dh, window, scale, softcap,
                inv_cap, split_s, splits, stream);
}

// The paged pool: K/V payload (P, page_len, Hkv, dh/2) u8 and scales
// (P, page_len, Hkv, dh/16) u8; block tables (B, max_pages) i32 whose
// entries are pages < P; lengths (B,) i32 <= max_pages * page_len;
// page_len a multiple of 16.  S = max_pages * page_len sizes the splits.
// The rest as above.
extern "C" int mixfp4_attn_decode_paged(
    const float* q, const uint8_t* kp, const uint8_t* ks, const uint8_t* vp,
    const uint8_t* vs, const int* block_tables, const int* lengths,
    const float* s32, float* out, float* work, int* counters, int b,
    int max_pages, int page_len, int h, int hkv, int dh, int window,
    int split_s, int splits, float scale, float softcap, float inv_cap,
    void* stream) {
  if (page_len < 16 || page_len % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(q, kp, ks, vp, vs, lengths, s32, out, work, counters,
                PagedRows{block_tables, max_pages, page_len}, b,
                max_pages * page_len, h, hkv, dh, window, scale, softcap,
                inv_cap, split_s, splits, stream);
}
