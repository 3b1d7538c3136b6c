// Shared by mlp_block_fwd.cu and mlp_block_bwd.cu: the exact GELU and its
// derivative with erf by Abramowitz-Stegun 7.1.26 (the TPU kernel's
// polynomial, max abs error 1.5e-7; expf, no fast-math, so that a kernel and
// its plain PyTorch version differ by summation order only), and the copy
// of a row tile into shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace mlp {

constexpr int kThreads = 256;
constexpr int kWarps = 8;
// 16-column output fragments a warp may hold for each 16-row fragment: the
// eight warps of a block cover D <= 8 * 6 * 16 = 768
constexpr int kMaxFrags = 6;
constexpr int kMaxD = kWarps * kMaxFrags * 16;

constexpr float kSqrtHalf = 0.70710678118654752440f;
constexpr float kInvSqrt2Pi = 0.39894228040143267794f;

__device__ __forceinline__ float erf_as(float z) {
  const float az = fabsf(z);
  const float t = 1.f / (1.f + 0.3275911f * az);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f +
                t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float e = 1.f - poly * expf(-az * az);
  return z < 0.f ? -e : (z > 0.f ? e : 0.f);
}

__device__ __forceinline__ float gelu(float a) {
  return a * 0.5f * (1.f + erf_as(a * kSqrtHalf));
}

__device__ __forceinline__ float gelu_grad(float a) {
  const float cdf = 0.5f * (1.f + erf_as(a * kSqrtHalf));
  const float pdf = expf(-0.5f * a * a) * kInvSqrt2Pi;
  return cdf + a * pdf;
}

// Rows [row0, row0 + ROWS) of a contiguous [N, D] matrix into a shared tile
// of row pitch `ld` elements, 16 bytes at a time (D * sizeof(T) and
// ld * sizeof(T) are multiples of 16); rows >= N become 0.
template <typename T, int ROWS>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src,
                                          long long row0, long long N,
                                          int D) {
  constexpr int VEC = 16 / sizeof(T);
  const int vpr = D / VEC;
  for (int i = threadIdx.x; i < ROWS * vpr; i += kThreads) {
    const int r = i / vpr;
    const int c = (i % vpr) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < N) {
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * D + c);
    }
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

}  // namespace mlp
