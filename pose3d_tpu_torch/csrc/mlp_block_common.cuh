// Shared by mlp_block_fwd.cu and mlp_block_bwd.cu: the exact GELU and its
// derivative with erf by Abramowitz-Stegun 7.1.26 (the TPU kernel's
// polynomial, max abs error 1.5e-7; expf, no fast-math, so that a kernel and
// its plain PyTorch version differ by summation order only), and the copy
// of a row tile into shared memory; for the wgmma kernels, what the three of
// them share around hopper_mma.cuh: the thread layout, the shared-memory
// budget, and the store of an accumulator's bf16 pairs into a 64-byte-row
// swizzled tile.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace mlp {

constexpr int kThreads = 256;
constexpr int kWarps = 8;
// 16-column output fragments a warp may hold for each 16-row fragment: the
// eight warps of a block cover 8 * 6 * 16 = 768 output columns
constexpr int kMaxFrags = 6;
constexpr int kMaxCols = kWarps * kMaxFrags * 16;
// The widest D the kernels take (ViT-H's 1,280). Above kMaxCols the WMMA
// and scalar kernels split the output columns of out and dx (and the rows
// of dW1, columns of dW2) across blocks on gridDim.y, each block still
// summing x W1 and g W2^T over all of D before the GELU: the first products
// are computed once for each slice.
constexpr int kMaxD = 1280;

// The column split of a width D: n slices of `cols` columns (a multiple of
// 16, at most kMaxCols; the last slice may be narrower).
struct Slices {
  int n, cols;
};
__host__ __device__ inline Slices column_slices(int D) {
  const int n = (D + kMaxCols - 1) / kMaxCols;
  return {n, 16 * ((D + 16 * n - 1) / (16 * n))};
}

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

// ---- the wgmma kernels (bf16, D a multiple of 64) ------------------------
// 384 threads: warpgroups 0 and 1 compute (wgmma, GELU, epilogue), thread 0
// of warpgroup 2 is the producer that keeps TMA loads in flight. Registers
// decide the shape: a [64, 768] fp32 tile over three computing warpgroups is
// 128 registers a thread of the 168 that 384 threads have, and with a
// 16-register chunk accumulator ptxas spills and serializes the wgmmas
// (C7512); over two it is 192, and setmaxnreg moves the producer's registers
// to them: 2 * 128 * 240 + 128 * 24 = 3 * 128 * 168.
constexpr int kWgThreads = 384;
constexpr int kComputeThreads = 256;
constexpr int kWarps2 = kComputeThreads / 32;   // arrivals that release a stage
constexpr int kProducerRegs = 24;
constexpr int kComputeRegs = 240;
constexpr int kComputeBarrier = 1;       // named barrier of the 256
constexpr int kHiddenChunk = 64;         // 32 hidden columns a warpgroup
constexpr int kW1Depth = 192;            // rows of W1 in a stage: 2 x [192, 32]
constexpr int kSlab = 384;               // output columns a warpgroup: 2 x n192
constexpr unsigned kStageBytes = 24576;  // one ring stage
constexpr unsigned kMaxSmem = 232448;    // a block's limit on this card

// Path codes that the *_config entry points report.
constexpr int kPathScalar = 0, kPathWmma = 1, kPathWgmma = 2;

__host__ __device__ inline bool takes_wgmma(int is_bf16, int D) {
  return is_bf16 && D % 64 == 0 && D <= kMaxCols;
}

// Two adjacent accumulator values (row, col), (row, col + 1) of an m64n32
// tile, rounded to bf16, into a tile of 64-byte rows (32 bf16) with the
// 64-byte swizzle: `tile` starts on a multiple of 1024 bytes, col is even.
__device__ __forceinline__ void store_pair_sw64(unsigned char* tile, int row,
                                                int col, float v0, float v1) {
  const unsigned off = (unsigned)row * 64u + (unsigned)col * 2u;
  *reinterpret_cast<__nv_bfloat162*>(tile + (off ^ ((off >> 3) & 0x30u))) =
      __floats2bfloat162_rn(v0, v1);
}

}  // namespace mlp
