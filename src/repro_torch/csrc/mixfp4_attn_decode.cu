// One-token decode attention over a packed MixFP4 KV cache for sm_90a.
//
// Replaces: src/repro/kernels/mixfp4_attn.py :: mixfp4_attn_decode
//           (_attn_decode_kernel, _flash_step, _decode_kv_block).
//
// Bound: bytes.  A step reads each valid cache row once (dh/2 payload +
// dh/16 scale bytes for K and again for V) for ~4*g*dh flops per row, far
// below the rate at which the card could compute on it.
//
// Design: one 256-thread block per (sequence, kv head).  The g = H/Hkv
// query heads of a kv head share every decoded K/V block, so the packed
// bytes are read and decoded once per step.  The block walks the valid
// keys in blocks of 32 rows: decode K (Fig. 9 decode, block scale and
// per-tensor scale fused) into shared memory as f32, score the g heads
// (one warp per key, lanes split dh, butterfly shuffle reduction), fold
// the scores into the online softmax (running max, sum and rescale factor
// per head in shared memory), decode V into the same buffer and update the
// f32 accumulator (thread d owns output dim d of every head, in registers).
// Only keys the masks keep are visited: kpos < len and, for a window w > 0,
// kpos > len - 1 - w.  A fully masked key block leaves the reference's
// flash state exactly unchanged (its -1e30 scores give alpha = 1 and p = 0),
// so skipping it is exact.  Scores scale by dh^-0.5 before the softcap
// c*tanh(s/c); exponentials use expf / tanhf, never the fast intrinsics.
// The output divides by l where l > 0.  Splitting S across blocks
// (flash-decoding) is later work.
#include <cuda_runtime.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;   // threads per block; also the largest dh
constexpr int BS = 32;    // keys per step
constexpr int MAXG = 8;   // largest query-head group per kv head

__device__ __forceinline__ float decode_nibble(uint32_t nib, uint32_t t) {
  const int p = nib & 7;
  const int twice = p < 4 ? p : (2 + (p & 1)) << ((p >> 1) - 1);
  const float mag = t ? static_cast<float>(p) : 0.5f * twice;
  return (nib & 8) ? -mag : mag;
}

__device__ __forceinline__ float e4m3_value(uint32_t bits7) {
  __nv_fp8_e4m3 v;
  v.__x = static_cast<__nv_fp8_storage_t>(bits7);
  return static_cast<float>(v);
}

// rows j0 .. j0+nk-1 of one kv head -> f32 buf[j][d]
__device__ __forceinline__ void decode_rows(
    const uint8_t* __restrict__ pay, const uint8_t* __restrict__ sc,
    float s32, float* buf, size_t row0, int hkv, int nk, int dh) {
  const int half = dh / 2;
  for (int idx = threadIdx.x; idx < nk * half; idx += NT) {
    const int j = idx / half, c = idx % half;
    const size_t row = row0 + static_cast<size_t>(j) * hkv;
    const uint32_t byte = pay[row * half + c];
    const uint32_t sb = sc[row * (dh / 16) + c / 8];
    const float s = e4m3_value(sb & 0x7F);
    const uint32_t t = sb >> 7;
    buf[j * dh + 2 * c] = decode_nibble(byte & 0xF, t) * s * s32;
    buf[j * dh + 2 * c + 1] = decode_nibble(byte >> 4, t) * s * s32;
  }
}

__global__ void __launch_bounds__(NT) attn_decode_kernel(
    const float* __restrict__ q, const uint8_t* __restrict__ kp,
    const uint8_t* __restrict__ ks, const uint8_t* __restrict__ vp,
    const uint8_t* __restrict__ vs, const int* __restrict__ lengths,
    const float* __restrict__ s32, float* __restrict__ out, int s_len,
    int h, int hkv, int dh, int window, float scale, float softcap,
    float inv_cap) {
  extern __shared__ float smem[];
  const int g = h / hkv;
  float* kv = smem;               // BS * dh
  float* qs = kv + BS * dh;       // g * dh
  float* sc = qs + g * dh;        // g * BS: scores, then p
  float* st_m = sc + g * BS;      // running max per head
  float* st_l = st_m + MAXG;      // running sum per head
  float* st_a = st_l + MAXG;      // this step's rescale factor per head

  const int b = blockIdx.x / hkv, kh = blockIdx.x % hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int len = lengths[b];
  const int lo = window > 0 ? max(0, len - window) : 0;
  const int hi = min(len, s_len);
  const float s32k = s32[0], s32v = s32[1];

  for (int i = tid; i < g * dh; i += NT)
    qs[i] = q[(static_cast<size_t>(b) * h + kh * g) * dh + i];
  if (tid < g) {
    st_m[tid] = -1e30f;
    st_l[tid] = 0.0f;
  }
  float acc[MAXG];
#pragma unroll
  for (int i = 0; i < MAXG; ++i) acc[i] = 0.0f;
  __syncthreads();

  for (int j0 = lo; j0 < hi; j0 += BS) {
    const int nk = min(BS, hi - j0);
    const size_t row0 = (static_cast<size_t>(b) * s_len + j0) * hkv + kh;
    decode_rows(kp, ks, s32k, kv, row0, hkv, nk, dh);
    __syncthreads();
    for (int j = warp; j < nk; j += NT / 32) {
      for (int hh = 0; hh < g; ++hh) {
        float part = 0.0f;
        for (int d = lane; d < dh; d += 32)
          part += qs[hh * dh + d] * kv[j * dh + d];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        if (lane == 0) {
          float s = part * scale;
          if (softcap > 0.0f) s = softcap * tanhf(s * inv_cap);
          sc[hh * BS + j] = s;
        }
      }
    }
    __syncthreads();
    if (tid < g) {
      const float m_prev = st_m[tid];
      float m_new = m_prev;
      for (int j = 0; j < nk; ++j) m_new = fmaxf(m_new, sc[tid * BS + j]);
      const float alpha = expf(m_prev - m_new);
      float sum = 0.0f;
      for (int j = 0; j < nk; ++j) {
        const float p = expf(sc[tid * BS + j] - m_new);
        sc[tid * BS + j] = p;
        sum += p;
      }
      st_l[tid] = st_l[tid] * alpha + sum;
      st_m[tid] = m_new;
      st_a[tid] = alpha;
    }
    decode_rows(vp, vs, s32v, kv, row0, hkv, nk, dh);
    __syncthreads();
    if (tid < dh) {
      for (int hh = 0; hh < g; ++hh) {
        float pv = 0.0f;
        for (int j = 0; j < nk; ++j) pv += sc[hh * BS + j] * kv[j * dh + tid];
        acc[hh] = acc[hh] * st_a[hh] + pv;
      }
    }
    __syncthreads();
  }
  if (tid < dh) {
    for (int hh = 0; hh < g; ++hh) {
      const float l = st_l[hh];
      out[(static_cast<size_t>(b) * h + kh * g + hh) * dh + tid] =
          acc[hh] / (l > 0.0f ? l : 1.0f);
    }
  }
}

}  // namespace

// q (B, H, dh) f32; K/V payload (B, S, Hkv, dh/2) u8 and scales
// (B, S, Hkv, dh/16) u8, all contiguous; lengths (B,) i32; s32 two f32 on
// the device (K, V); out (B, H, dh) f32.  dh <= 256, dh % 16 == 0,
// H / Hkv <= 8.  scale = dh^-0.5; softcap 0 disables the cap.
extern "C" int mixfp4_attn_decode(const float* q, const uint8_t* kp,
                                  const uint8_t* ks, const uint8_t* vp,
                                  const uint8_t* vs, const int* lengths,
                                  const float* s32, float* out, int b, int s,
                                  int h, int hkv, int dh, int window,
                                  float scale, float softcap, float inv_cap,
                                  void* stream) {
  if (b == 0) return 0;
  const int g = h / hkv;
  const size_t smem =
      sizeof(float) * (BS * dh + g * dh + g * BS + 3 * MAXG);
  attn_decode_kernel<<<b * hkv, NT, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      q, kp, ks, vp, vs, lengths, s32, out, s, h, hkv, dh, window, scale,
      softcap, inv_cap);
  return static_cast<int>(cudaGetLastError());
}
