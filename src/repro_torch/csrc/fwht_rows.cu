// Grouped random Hadamard transform of f32 rows for sm_90a, and the W4A4
// per-row scale of the transformed rows:
//   fwht_rows:      out (M, K) = per G-lane group: H_G (signs * x) * G^-1/2;
//   fwht_row_scale: scale (M,) = row_scale(fwht_rows(x, signs, 16)), i.e.
//                   max|v| over the transformed row times f32(1/2688), or 1
//                   where that max is not > 0 (an all-zero or NaN row).
//
// Replaces: src/repro/kernels/fwht.py :: fwht_rows (_fwht_kernel,
//           fwht_rows_math); fwht_row_scale replaces its use for the row
//           scale (src/repro/core/qtensor.py, qmm's per-row branch:
//           _act_scale32_like_quantize_rows(fwht_rows_math(...))), which
//           the reference computes inside its jitted step and XLA fuses.
//
// Bound: bytes.  fwht_rows reads and writes M*K*4 B (the signs, K*4 B,
// stay in L1/L2); log2(G) adds per value are far below the card's compute
// rate.  fwht_row_scale reads M*K*4 B and writes M*4 B; at decode M it is
// a few microseconds of latency, not bytes.
//
// Design (fwht_rows): one thread per G-lane group, all of it in registers:
// G/4 16-byte loads of x and of the signs, the sign multiply, the butterfly
// of mixfp4_block_math.cuh (shared with the W4A4 GEMM's fused prologue),
// the normalising multiply, G/4 16-byte stores.  Neighbouring threads own
// neighbouring groups, so a warp's traffic is contiguous.  Every step is a
// single round-to-nearest f32 multiply, add or subtract, built with
// -fmad=false, so the output is bitwise the plain version's: the W4A4 row
// scale and the dual-format select downstream read these bits.
//
// Design (fwht_row_scale): the same per-group arithmetic, then a max
// instead of a store, so no (M, K) matrix is written and the scale costs
// one launch instead of a transform plus PyTorch's abs/amax/where chain.
// A row is a reduction: its 16-lane groups are cut into `ctas` contiguous
// runs, one per CTA of a thread-block cluster (1 to 8 CTAs, picked by
// kernels/tuning.py from M and K), each thread taking groups of its run at
// a stride of the block.  The max is taken over the uint bits of |v|:
// non-negative floats order as their bits, and a NaN's bits sort above
// Inf's, so the reduction keeps torch.amax's NaN propagation (a NaN row
// gets scale 1, as `NaN > 0` is false) and an Inf row's Inf.  Warps
// reduce with __reduce_max_sync, warps through shared memory, the
// cluster's CTAs through distributed shared memory: each CTA publishes its
// max, the cluster synchronises, rank 0 reads the others' with
// map_shared_rank and writes the scale, and a second cluster barrier keeps
// every CTA resident until rank 0 has read it.  No global ticket and no
// workspace.  Without signs the transform is the identity (qmm's per-row
// scale without the RHT).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mixfp4_block_math.cuh"

namespace {

using namespace mixfp4;

template <int G>
__global__ void __launch_bounds__(256) fwht_rows_kernel(
    const float* __restrict__ x, const float* __restrict__ signs,
    float* __restrict__ out, long long m, int k, float norm) {
  const int ng = k / G;
  const long long gid = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  if (gid >= m * ng) return;
  const long long row = gid / ng;
  const int c0 = static_cast<int>(gid % ng) * G;
  const float4* src = reinterpret_cast<const float4*>(x + row * k + c0);
  const float4* sg = reinterpret_cast<const float4*>(signs + c0);
  float v[G];
#pragma unroll
  for (int i = 0; i < G / 4; ++i) {
    const float4 a = src[i], s = sg[i];
    v[4 * i] = __fmul_rn(a.x, s.x);
    v[4 * i + 1] = __fmul_rn(a.y, s.y);
    v[4 * i + 2] = __fmul_rn(a.z, s.z);
    v[4 * i + 3] = __fmul_rn(a.w, s.w);
  }
  wht_butterfly<G>(v);
  float4* dst = reinterpret_cast<float4*>(out + row * k + c0);
#pragma unroll
  for (int i = 0; i < G / 4; ++i)
    dst[i] = make_float4(__fmul_rn(v[4 * i], norm),
                         __fmul_rn(v[4 * i + 1], norm),
                         __fmul_rn(v[4 * i + 2], norm),
                         __fmul_rn(v[4 * i + 3], norm));
}

template <int G>
int launch(const float* x, const float* signs, float* out, long long m,
           int k, float norm, void* stream) {
  const long long groups = m * (k / G);
  if (groups == 0) return 0;
  const int threads = 256;
  const unsigned grid = static_cast<unsigned>((groups + threads - 1) /
                                              threads);
  fwht_rows_kernel<G><<<grid, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      x, signs, out, m, k, norm);
  return static_cast<int>(cudaGetLastError());
}


constexpr int kRowScaleMaxThreads = 256;
constexpr unsigned kF32InfBits = 0x7f800000u;

// max over the uint bits of |v| of one row's groups [g0, g1), this CTA
template <bool RHT>
__device__ __forceinline__ unsigned group_run_max(
    const float* __restrict__ xr, const float* __restrict__ signs, int g0,
    int g1, float norm) {
  unsigned best = 0;
  for (int g = g0 + static_cast<int>(threadIdx.x); g < g1;
       g += blockDim.x) {
    const float4* src = reinterpret_cast<const float4*>(xr) + 4 * g;
    float v[16];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 a = __ldg(src + i);
      v[4 * i] = a.x;
      v[4 * i + 1] = a.y;
      v[4 * i + 2] = a.z;
      v[4 * i + 3] = a.w;
    }
    if constexpr (RHT) {
      const float4* sg = reinterpret_cast<const float4*>(signs) + 4 * g;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 s = __ldg(sg + i);
        v[4 * i] = __fmul_rn(v[4 * i], s.x);
        v[4 * i + 1] = __fmul_rn(v[4 * i + 1], s.y);
        v[4 * i + 2] = __fmul_rn(v[4 * i + 2], s.z);
        v[4 * i + 3] = __fmul_rn(v[4 * i + 3], s.w);
      }
      wht_butterfly<16>(v);
#pragma unroll
      for (int i = 0; i < 16; ++i) v[i] = __fmul_rn(v[i], norm);
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) best = max(best, __float_as_uint(fabsf(v[i])));
  }
  return best;
}

// grid: ctas * M CTAs, clusters of `ctas` along x; CTA i serves row i / ctas
template <bool RHT>
__global__ void __launch_bounds__(kRowScaleMaxThreads) fwht_row_scale_kernel(
    const float* __restrict__ x, const float* __restrict__ signs,
    float* __restrict__ scale, int k, int ctas, float norm, float recip) {
  __shared__ unsigned warp_max[kRowScaleMaxThreads / 32];
  __shared__ unsigned cta_max;
  const long long row = blockIdx.x / ctas;
  const int rank = static_cast<int>(blockIdx.x % ctas);
  const int ng = k / 16;
  const int g0 = static_cast<int>(static_cast<long long>(ng) * rank / ctas);
  const int g1 =
      static_cast<int>(static_cast<long long>(ng) * (rank + 1) / ctas);
  unsigned best =
      group_run_max<RHT>(x + row * k, signs, g0, g1, norm);
  best = __reduce_max_sync(0xffffffffu, best);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) warp_max[warp] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < static_cast<int>(blockDim.x / 32); ++w)
      best = max(best, warp_max[w]);
    cta_max = best;
  }
  if (ctas > 1) {
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every CTA's cta_max is published
    if (rank == 0 && threadIdx.x == 0) {
      for (int r = 1; r < ctas; ++r)
        best = max(best, *cluster.map_shared_rank(&cta_max, r));
    }
    cluster.sync();  // no CTA leaves before rank 0 has read it
  }
  if (rank == 0 && threadIdx.x == 0) {
    float s;
    if (best > kF32InfBits) {
      s = 1.0f;                                    // NaN: NaN > 0 is false
    } else {
      const float amax = __uint_as_float(best);
      s = amax > 0.0f ? __fmul_rn(amax, recip) : 1.0f;
    }
    scale[row] = s;
  }
}

template <bool RHT>
int launch_row_scale(const float* x, const float* signs, float* scale,
                     long long m, int k, int ctas, int threads, float norm,
                     float recip, void* stream) {
  if (m == 0) return 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(m * ctas));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, fwht_row_scale_kernel<RHT>, x, signs, scale, k, ctas, norm,
      recip);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out (M, K) f32 contiguous, 16-byte aligned; signs (K,) f32 16-byte
// aligned; K % group == 0; group in {4, 8, 16, 32, 64}; norm = f32(group
// ** -0.5).  Returns cudaErrorInvalidValue for any other group.
extern "C" int fwht_rows(const float* x, const float* signs, float* out,
                         long long m, int k, int group, float norm,
                         void* stream) {
  switch (group) {
    case 4: return launch<4>(x, signs, out, m, k, norm, stream);
    case 8: return launch<8>(x, signs, out, m, k, norm, stream);
    case 16: return launch<16>(x, signs, out, m, k, norm, stream);
    case 32: return launch<32>(x, signs, out, m, k, norm, stream);
    case 64: return launch<64>(x, signs, out, m, k, norm, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// x (M, K) f32 contiguous, 16-byte aligned, K % 16 == 0; signs (K,) f32
// 16-byte aligned, or null for the identity transform; scale (M,) f32.
// ctas in 1..8 CTAs per row (one cluster), threads a multiple of 32 up
// to 256; norm = f32(16 ** -0.5), recip = f32(1/2688).  Returns
// cudaErrorInvalidValue for any other ctas or threads.
extern "C" int fwht_row_scale(const float* x, const float* signs,
                              float* scale, long long m, int k, int ctas,
                              int threads, float norm, float recip,
                              void* stream) {
  if (ctas < 1 || ctas > 8 || threads < 32 ||
      threads > kRowScaleMaxThreads || threads % 32 || k % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  return signs ? launch_row_scale<true>(x, signs, scale, m, k, ctas,
                                        threads, norm, recip, stream)
               : launch_row_scale<false>(x, signs, scale, m, k, ctas,
                                         threads, norm, recip, stream);
}
