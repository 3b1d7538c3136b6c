// Per-row affine 1-D resample on Hopper (sm_90a).
//
// Replaces pose3d_tpu/ops/pallas/lane_resample.py::_kernel (launched by
// pl.pallas_call in lane_resample). For a contiguous fp32 or bf16 [N, W]
// array and fp32 a[N], o[N] it computes, for every row n and column j,
//   out[n, j] = row_n sampled at p = a[n] * j + o[n],
// order 1: two-tap linear between floor(p) and floor(p) + 1 with weight
// w = p - floor(p), a tap outside [0, W-1] contributing 0 (so positions in
// (-1, 0) and (W-1, W) keep a partial weight on the edge pixel); order 0:
// the pixel floor(p + 0.5), 0 outside [0, W-1]. These are the semantics of
// map_coordinates(order, mode="constant", cval=0) along one axis. The device
// augmentor's rotation path calls it twice per warp (rows, then columns of
// the transposed intermediate).
//
// What bounds it on this card. Some ten fp32 operations per element against
// 8 bytes moved (each element read about once, written once): far below the
// ~20 operations per byte at which the fp32 rate would be the limit, so the
// work is bound by bytes: 2 * N * W * 4 over the memory rate. The largest
// call of the 500x500 CNN's grouped step is [150000, 500]: 600 MB.
//
// Design (a simple kernel that is right comes first):
//  * the TPU kernel tiles source and output rows into 128-lane blocks and
//    sums masked vector gathers over every (output block, source block) pair,
//    and pads W to 128 and the rows to 256: all of that answers the TPU
//    compiler's gather limits. Here a thread simply loads the one or two
//    source pixels of its output element through the read-only cache;
//    neighbouring threads read neighbouring addresses (|a| is near 1), and a
//    row's 2 KB stay in L1 for its second tap. No padding: the ragged edge is
//    the column bound;
//  * a block is TX x TY threads (TX * TY = 256): TX a power of two along the
//    columns, TY rows deep, chosen by the wrapper from W so that narrow rows
//    do not leave most of a block idle. Rows go on gridDim.x (N reaches
//    153,600, beyond gridDim.y's 65,535);
//  * a and o are read once per thread and row;
//  * every product, sum and difference is a separately rounded fp32
//    operation (__fmul_rn, __fadd_rn, __fsub_rn), never contracted into a
//    fused multiply-add: order 0 takes floor(p + 0.5), so a last-bit
//    difference in p picks another pixel. The plain PyTorch version rounds
//    after every operation too, and the two agree bit for bit;
//  * floor(p) is clipped to [0, W-1] as a float before the cast to int (a
//    huge |p| cast first is undefined); validity is read off the unclipped
//    value;
//  * bf16 x (the TPU kernel takes any float type): the positions p and
//    floor(p) stay fp32, and from the weight w = p - floor(p) on every value
//    is in x's type, as the TPU kernel casts w to it: each fp32 result (w,
//    1 - w, each product, the sum) is rounded to bf16 before it is used, as
//    PyTorch's bf16 operators round each result. A product of two bf16
//    values is exact in fp32, so this is bf16 arithmetic rounded once per
//    operation; the plain version agrees bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// a fp32 result rounded to T and back (the identity for fp32)
__device__ __forceinline__ float in_type(float v, const float*) { return v; }
__device__ __forceinline__ float in_type(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}
__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int ORDER>
__global__ void __launch_bounds__(kThreads)
lane_resample_kernel(const T* __restrict__ x, const float* __restrict__ a,
                     const float* __restrict__ o, T* __restrict__ out,
                     long long n, int w) {
  const long long row = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  if (row >= n) return;
  const float ar = __ldg(a + row);
  const float orow = __ldg(o + row);
  const T* __restrict__ src = x + row * w;
  T* __restrict__ dst = out + row * w;
  const float last = (float)(w - 1);

  for (int j = threadIdx.x; j < w; j += blockDim.x) {
    const float p = __fadd_rn(__fmul_rn(ar, (float)j), orow);
    if (ORDER == 0) {
      const float f = floorf(__fadd_rn(p, 0.5f));
      const int i = (int)fminf(fmaxf(f, 0.f), last);
      const float valid = (f >= 0.f && f <= last) ? 1.f : 0.f;
      store(dst + j, __fmul_rn(load(src + i), valid));
    } else {
      const float f = floorf(p);
      const float wt = in_type(__fsub_rn(p, f), x);
      const float f1 = __fadd_rn(f, 1.f);
      const int i0 = (int)fminf(fmaxf(f, 0.f), last);
      const int i1 = (int)fminf(fmaxf(f1, 0.f), last);
      const float m0 = (f >= 0.f && f <= last) ? 1.f : 0.f;
      const float m1 = (f1 >= 0.f && f1 <= last) ? 1.f : 0.f;
      const float t0 = in_type(
          __fmul_rn(__fmul_rn(load(src + i0), m0), in_type(__fsub_rn(1.f, wt), x)),
          x);
      const float t1 = in_type(__fmul_rn(__fmul_rn(load(src + i1), m1), wt), x);
      store(dst + j, __fadd_rn(t0, t1));
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// x, out: contiguous [n, w] of one type, fp32 or (is_bf16 1) bf16 (out
// must not alias x); a, o: fp32 [n]. order: 0 or 1. tx: threads along the
// columns, a power of two <= 256; a block holds 256 / tx rows. Arguments
// the kernel does not take return cudaErrorInvalidValue.
int pose3d_lane_resample(const void* x, const void* a, const void* o,
                         void* out, long long n, int w, int order, int tx,
                         int is_bf16, void* stream) {
  if (n < 1 || w < 1 || (order != 0 && order != 1) || tx < 1 ||
      tx > kThreads || (tx & (tx - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const int ty = kThreads / tx;
  const long long blocks = (n + ty - 1) / ty;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks), block(tx, ty);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* of = static_cast<const float*>(o);
  if (is_bf16) {
    typedef __nv_bfloat16 bf16;
    const bf16* xb = static_cast<const bf16*>(x);
    bf16* ob = static_cast<bf16*>(out);
    if (order == 0)
      lane_resample_kernel<bf16, 0><<<grid, block, 0, st>>>(xb, af, of, ob, n, w);
    else
      lane_resample_kernel<bf16, 1><<<grid, block, 0, st>>>(xb, af, of, ob, n, w);
  } else {
    const float* xf = static_cast<const float*>(x);
    float* outf = static_cast<float*>(out);
    if (order == 0)
      lane_resample_kernel<float, 0><<<grid, block, 0, st>>>(xf, af, of, outf, n, w);
    else
      lane_resample_kernel<float, 1><<<grid, block, 0, st>>>(xf, af, of, outf, n, w);
  }
  return (int)cudaGetLastError();
}

const char* pose3d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
