// The register-stream design of the row LayerNorm forward, measured against
// the TMA ring of pose3d_tpu_torch/csrc/layer_norm_fwd.cu and not kept in
// the package (its times are in PERF.md). scripts/row_reduce_card.py
// --variants builds it with the package's flags (-I pose3d_tpu_torch/csrc)
// and loads it in place of the built library, under the same wrapper: it
// has the same C entry point, and takes only the path the two designs
// share, rows of at most 1,024 columns on the 16-byte path (else
// cudaErrorInvalidValue).
//
// Design: a persistent grid of at most two blocks of eight warps an SM (one
// where a lane's registers do not allow two); warp g of the grid's W warps
// takes rows g, g + W, ... (the ring's owners too). A lane keeps its NV
// 16-byte vectors of a row packed in registers as loaded (rr::Packed,
// through the read-only path) and loads its next row before it reduces the
// current one: two rows a warp in flight, 48 KB an SM at C 768 bf16. Scale
// and bias in registers, the same sums in the same order as the ring (so
// the same bits), y by streaming stores.

#include <cstdint>

#include "layer_norm_common.cuh"
#include "row_reduce.cuh"

namespace {

using namespace ln;

constexpr int kSMs = 132;

// two blocks an SM where a lane keeps at most 72 words: two rows of NV
// packed vectors and NV * VEC columns each of scale and bias
__host__ __device__ constexpr int blocks_per_sm(int vec, int nv) {
  return nv * (8 + 2 * vec) <= 72 ? 2 : 1;
}

struct Args {
  const void* x;
  const float* scale;
  const float* bias;
  void* y;
  float* mean;
  float* rstd;
  long long rows, ld;
  int C;
  float eps;
};

template <typename T, int VEC>
__device__ __forceinline__ void store_y(T* p, const float (&o)[VEC]) {
  if constexpr (sizeof(T) == 2) {
    uint4 t;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&t);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(o[2 * i], o[2 * i + 1]);
    __stcs(reinterpret_cast<uint4*>(p), t);
  } else {
    __stcs(reinterpret_cast<float4*>(p), make_float4(o[0], o[1], o[2], o[3]));
  }
}

template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(kThreads, blocks_per_sm(VEC, NV))
layer_norm_fwd_stream(const Args a) {
  using Pk = rr::Packed<T, VEC>;
  using PT = typename Pk::type;
  const T* x = static_cast<const T*>(a.x);
  T* y = static_cast<T*>(a.y);
  const int C = a.C;
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * kWarps;
  long long r = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const float inv_c = 1.f / (float)C;

  float sc[NV][VEC], bi[NV][VEC];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = (i * 32 + lane) * VEC;
#pragma unroll
    for (int j = 0; j < VEC; ++j) sc[i][j] = bi[i][j] = 0.f;
    if (c < C) {
#pragma unroll
      for (int h = 0; h < VEC / 4; ++h) {
        const float4 t = __ldg(reinterpret_cast<const float4*>(a.scale + c) + h);
        const float4 u = __ldg(reinterpret_cast<const float4*>(a.bias + c) + h);
        sc[i][4 * h] = t.x, sc[i][4 * h + 1] = t.y, sc[i][4 * h + 2] = t.z,
        sc[i][4 * h + 3] = t.w;
        bi[i][4 * h] = u.x, bi[i][4 * h + 1] = u.y, bi[i][4 * h + 2] = u.z,
        bi[i][4 * h + 3] = u.w;
      }
    }
  }
  auto load_row = [&](long long row, PT (&xo)[NV]) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = (i * 32 + lane) * VEC;
      xo[i] = Pk::zero();
      if (c < C) xo[i] = Pk::load(x + row * a.ld + c);
    }
  };

  PT xc[NV];
  if (r < a.rows) load_row(r, xc);
  for (; r < a.rows; r += stride) {
    PT xn[NV];
    if (r + stride < a.rows) load_row(r + stride, xn);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = (i * 32 + lane) * VEC;
      if (c < C) {
        float v[VEC];
        Pk::unpack(xc[i], v);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          s1 += v[j];
          s2 = fmaf(v[j], v[j], s2);
        }
      }
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    const float mu = s1 * inv_c;
    const float rs = rsqrtf(fmaxf(s2 * inv_c - mu * mu, 0.f) + a.eps);
    if (lane == 0) {
      a.mean[r] = mu;
      a.rstd[r] = rs;
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = (i * 32 + lane) * VEC;
      if (c < C) {
        float v[VEC], o[VEC];
        Pk::unpack(xc[i], v);
#pragma unroll
        for (int j = 0; j < VEC; ++j) o[j] = (v[j] - mu) * rs * sc[i][j] + bi[i][j];
        store_y<T, VEC>(y + r * C + c, o);
      }
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) xc[i] = xn[i];
  }
}

using Kernel = void (*)(Args);

template <typename T, int VEC, int NV = 1>
Kernel pick_nv(int nv) {
  if constexpr (NV * 32 * VEC > kCachedC) {
    return nullptr;
  } else {
    return nv == NV ? layer_norm_fwd_stream<T, VEC, NV>
                    : pick_nv<T, VEC, NV + 1>(nv);
  }
}

}  // namespace

extern "C" {

int pose3d_layer_norm_fwd(const void* x, const void* scale, const void* bias,
                          void* y, void* mean, void* rstd, int is_bf16,
                          long long rows, int C, long long ld, float eps,
                          void* stream) {
  const int itemsize = is_bf16 ? 2 : 4, vec = 16 / itemsize;
  const bool aligned = (ld * itemsize) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(scale) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(bias) % 16 == 0;
  if (!aligned || rows < 1 || C % vec != 0 || C > kCachedC ||
      (rows > 1 && ld < C))
    return (int)cudaErrorInvalidValue;
  const int nv = (C + 32 * vec - 1) / (32 * vec);
  const Kernel k = is_bf16 ? pick_nv<__nv_bfloat16, 8>(nv) : pick_nv<float, 4>(nv);
  const long long most = (long long)kSMs * blocks_per_sm(vec, nv);
  const long long warp_rows = (rows + kWarps - 1) / kWarps;
  const int blocks = (int)(warp_rows < most ? warp_rows : most);
  Args a;
  a.x = x;
  a.scale = static_cast<const float*>(scale);
  a.bias = static_cast<const float*>(bias);
  a.y = y;
  a.mean = static_cast<float*>(mean);
  a.rstd = static_cast<float*>(rstd);
  a.rows = rows;
  a.ld = ld;
  a.C = C;
  a.eps = eps;
  return rr::launch(false, k, dim3(blocks), dim3(kThreads),
                    static_cast<cudaStream_t>(stream), a);
}

const char* pose3d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
