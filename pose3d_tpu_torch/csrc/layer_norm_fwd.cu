// Row LayerNorm forward for Hopper (sm_90a).
//
// Replaces pose3d_tpu/ops/pallas/layer_norm.py::_fwd_kernel (launched by
// pl.pallas_call in _fwd_impl). For x [rows, C] (bf16 or fp32, row stride
// `ld` elements, the last axis contiguous) and fp32 scale, bias [C] it
// computes per row, in fp32 and from one read of x,
//   mean = sum(x)/C,  var = max(sum(x^2)/C - mean^2, 0),
//   rstd = rsqrt(var + eps),  y = (x - mean) * rstd * scale + bias,
// and writes y [rows, C] in x's type and mean, rstd as fp32 [rows].
//
// What bounds it on this card. Some ten operations per element against 4
// (bf16) or 8 (fp32) bytes moved: bound by bytes, one read of x and one
// write of y. At the ViT lifter's [8*1025, 768] bf16 that is 25 MB, a few
// microseconds of the card's memory rate, so launch latency shows; the
// training-sized [100*1025, 768] moves 315 MB.
//
// Design (a simple kernel that is right comes first):
//  * the TPU kernel takes 512-row blocks through VMEM. Here one warp takes
//    one row, eight rows to a 256-thread block: lanes lie along C, so
//    neighbouring lanes read neighbouring addresses, 16 bytes each where the
//    wrapper found the addresses aligned and C a multiple of the vector
//    (VEC = 8 bf16 or 4 fp32), else one value (VEC = 1: any C, any address);
//  * for C <= 1024 a lane keeps its share of the row (at most 32 values) in
//    registers between the statistics and the output, so x is read once;
//    wider rows are read a second time (from the caches);
//  * both sums are taken per lane in a fixed order and folded by warp
//    shuffles in a fixed tree: the same result from run to run, no shared
//    memory, no block-wide synchronisation;
//  * ragged edges are bounds, not padding: the last block's spare warps
//    leave, the last vector of a row is inside C or outside it (VEC > 1 only
//    when C % VEC == 0). mean and rstd are [rows] exactly.

#include "layer_norm_common.cuh"

namespace {

using namespace ln;

template <typename T, int VEC, bool CACHED>
__global__ void __launch_bounds__(kThreads)
layer_norm_fwd(const T* __restrict__ x, const float* __restrict__ scale,
               const float* __restrict__ bias, T* __restrict__ y,
               float* __restrict__ mean, float* __restrict__ rstd,
               long long rows, int C, long long ld, float eps) {
  constexpr int NV = kCachedC / (32 * VEC);  // vectors a lane may hold
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * kWarps + warp;
  if (r >= rows) return;
  const T* xr = x + r * ld;
  T* yr = y + r * C;

  float v[NV][VEC];
  float s1 = 0.f, s2 = 0.f;
  if (CACHED) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = (i * 32 + lane) * VEC;
      if (c < C) {
        Vec<T, VEC>::load(xr + c, v[i]);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          s1 += v[i][j];
          s2 = fmaf(v[i][j], v[i][j], s2);
        }
      }
    }
  } else {
    for (int c = lane * VEC; c < C; c += 32 * VEC) {
      float t[VEC];
      Vec<T, VEC>::load(xr + c, t);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        s1 += t[j];
        s2 = fmaf(t[j], t[j], s2);
      }
    }
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  const float inv_c = 1.f / (float)C;
  const float mu = s1 * inv_c;
  const float var = fmaxf(s2 * inv_c - mu * mu, 0.f);
  const float rs = rsqrtf(var + eps);
  if (lane == 0) {
    mean[r] = mu;
    rstd[r] = rs;
  }

  if (CACHED) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = (i * 32 + lane) * VEC;
      if (c < C) {
        float o[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          o[j] = (v[i][j] - mu) * rs * scale[c + j] + bias[c + j];
        }
        Vec<T, VEC>::store(yr + c, o);
      }
    }
  } else {
    for (int c = lane * VEC; c < C; c += 32 * VEC) {
      float t[VEC], o[VEC];
      Vec<T, VEC>::load(xr + c, t);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        o[j] = (t[j] - mu) * rs * scale[c + j] + bias[c + j];
      }
      Vec<T, VEC>::store(yr + c, o);
    }
  }
}

template <typename T, int VEC>
int launch(const void* x, const float* scale, const float* bias, void* y,
           float* mean, float* rstd, long long rows, int C, long long ld,
           float eps, bool cached, cudaStream_t stream) {
  const long long blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  if (cached) {
    layer_norm_fwd<T, VEC, true><<<(unsigned)blocks, kThreads, 0, stream>>>(
        xp, scale, bias, yp, mean, rstd, rows, C, ld, eps);
  } else {
    layer_norm_fwd<T, VEC, false><<<(unsigned)blocks, kThreads, 0, stream>>>(
        xp, scale, bias, yp, mean, rstd, rows, C, ld, eps);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// x: [rows, C] with row stride ld (elements); scale, bias: fp32 [C]; y:
// [rows, C] contiguous, x's type; mean, rstd: fp32 [rows]. is_bf16: 1 for
// bfloat16, 0 for float32. vec: values a lane reads at once, 1 or 16 bytes'
// worth (8 bf16, 4 fp32; then x, y and ld*itemsize must be 16-byte aligned
// and C % vec == 0). cached: 1 keeps the row in registers (C <= 1024 only).
// Arguments the kernel does not take return cudaErrorInvalidValue.
int pose3d_layer_norm_fwd(const void* x, const void* scale, const void* bias,
                          void* y, void* mean, void* rstd, int is_bf16,
                          long long rows, int C, long long ld, float eps,
                          int vec, int cached, void* stream) {
  const int full = is_bf16 ? 8 : 4;
  if (rows < 1 || C < 1 || (vec != 1 && vec != full) ||
      (vec != 1 && C % vec != 0) || (cached && C > kCachedC))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  float* mu = static_cast<float*>(mean);
  float* rs = static_cast<float*>(rstd);
  const bool c = cached != 0;
  if (is_bf16) {
    if (vec == 8)
      return launch<__nv_bfloat16, 8>(x, sc, bi, y, mu, rs, rows, C, ld, eps,
                                      c, st);
    return launch<__nv_bfloat16, 1>(x, sc, bi, y, mu, rs, rows, C, ld, eps, c,
                                    st);
  }
  if (vec == 4)
    return launch<float, 4>(x, sc, bi, y, mu, rs, rows, C, ld, eps, c, st);
  return launch<float, 1>(x, sc, bi, y, mu, rs, rows, C, ld, eps, c, st);
}

const char* pose3d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
