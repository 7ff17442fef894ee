// Grouped random Hadamard transform of f32 rows for sm_90a:
//   out (M, K) = per G-lane group: H_G (signs * x) * G^-1/2.
//
// Replaces: src/repro/kernels/fwht.py :: fwht_rows (_fwht_kernel,
//           fwht_rows_math).
//
// Bound: bytes.  It reads and writes M*K*4 B (the signs, K*4 B, stay in
// L1/L2); log2(G) adds per value are far below the card's compute rate.
//
// Design: one thread per G-lane group, all of it in registers: G/4 16-byte
// loads of x and of the signs, the sign multiply, the butterfly of
// mixfp4_block_math.cuh (shared with the W4A4 GEMM's fused prologue), the
// normalising multiply, G/4 16-byte stores.  Neighbouring threads own
// neighbouring groups, so a warp's traffic is contiguous.  Every step is a
// single round-to-nearest f32 multiply, add or subtract, built with
// -fmad=false, so the output is bitwise the plain version's: the W4A4 row
// scale and the dual-format select downstream read these bits.
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
