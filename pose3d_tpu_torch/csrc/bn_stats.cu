// Per-channel moments for BatchNorm statistics on Hopper (sm_90a).
//
// Replaces pose3d_tpu/ops/pallas/bn_stats.py::_stats_kernel (launched by
// pl.pallas_call in _stats_impl). For a row-major [n, C] view of a conv
// activation (bf16 or fp32, row stride `ld` elements, channels contiguous)
// it computes, with fp32 accumulation and in one read of x,
//   s1[c] = sum_r x[r, c],   s2[c] = sum_r x[r, c]^2     (fp32 [C] each),
// for any n >= 1. The backward is closed-form (dx = g1 + 2 x g2) and has no
// kernel, as on the TPU.
//
// What bounds it on this card. 3 operations per element against 2 (bf16) or
// 4 (fp32) bytes read: far below the ~20 fp32 operations per byte at which
// the card's fp32 rate, not its memory, would be the limit. So the work is
// bound by bytes: n*C*itemsize over the memory rate. The largest layer of
// the 500x500 CNN at microbatch 10 is [625000, 64] bf16 = 80 MB.
//
// Design (a simple kernel that is right comes first):
//  * the TPU kernel walks row tiles in sequence on one core and carries an
//    [8, C] accumulator from one grid step to the next. Blocks here run in
//    parallel and in no order, so the rows are cut into `chunks`; a block
//    reduces one chunk of rows for one tile of channels and writes a partial
//    row into p1/p2 [chunks, C]; a second small kernel adds the partial rows
//    in a fixed order. No atomics: the sums are the same from run to run.
//    When one chunk covers all rows the first kernel writes s1/s2 directly;
//  * threads lie along C, so neighbouring threads read neighbouring
//    addresses of a row. Where the base address, the row stride and C allow
//    it each thread reads 16 bytes (8 bf16 or 4 fp32 channels) per row and
//    keeps both sums of its channels in registers; otherwise one channel per
//    thread (VEC = 1). A block is TX x TY threads (TX*TY = 256): TX
//    channel-vectors wide, TY rows deep, both powers of two chosen by the
//    wrapper from C; the TY row lanes are folded in shared memory by a tree
//    of fixed shape;
//  * the ragged last chunk is handled by the row bound, not by padding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T, int VEC>
struct Loader;

template <>
struct Loader<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  }
};

template <>
struct Loader<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[1]) {
    v[0] = *p;
  }
};

template <>
struct Loader<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&v)[8]) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};

template <>
struct Loader<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&v)[1]) {
    v[0] = __bfloat162float(*p);
  }
};

// grid (chunks, ceil(C / (TX*VEC))), block (TX, TY). Block (i, j) reduces
// rows [i*rows_per_chunk, min(n, (i+1)*rows_per_chunk)) of channels
// [j*TX*VEC, (j+1)*TX*VEC) into p1[i, :], p2[i, :].
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
bn_stats_partial(const T* __restrict__ x, float* __restrict__ p1,
                 float* __restrict__ p2, long long n, int C, long long ld,
                 long long rows_per_chunk) {
  __shared__ float sm1[kThreads * VEC];
  __shared__ float sm2[kThreads * VEC];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int TX = blockDim.x, TY = blockDim.y;
  const int c0 = (blockIdx.y * TX + tx) * VEC;
  const long long r0 = (long long)blockIdx.x * rows_per_chunk;
  const long long r1 = min(r0 + rows_per_chunk, n);

  float s1[VEC], s2[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) s1[i] = s2[i] = 0.f;
  // VEC > 1 only when C % VEC == 0, so a vector is inside C or outside it
  if (c0 < C) {
    const T* base = x + c0;
#pragma unroll 4
    for (long long r = r0 + ty; r < r1; r += TY) {
      float v[VEC];
      Loader<T, VEC>::load(base + r * ld, v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        s1[i] += v[i];
        s2[i] = fmaf(v[i], v[i], s2[i]);
      }
    }
  }

  const int slot = (ty * TX + tx) * VEC;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    sm1[slot + i] = s1[i];
    sm2[slot + i] = s2[i];
  }
  __syncthreads();
  for (int half = TY >> 1; half > 0; half >>= 1) {
    if (ty < half) {
      const int other = ((ty + half) * TX + tx) * VEC;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        sm1[slot + i] += sm1[other + i];
        sm2[slot + i] += sm2[other + i];
      }
    }
    __syncthreads();
  }
  if (ty == 0 && c0 < C) {
    float* o1 = p1 + (long long)blockIdx.x * C + c0;
    float* o2 = p2 + (long long)blockIdx.x * C + c0;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      o1[i] = sm1[slot + i];
      o2[i] = sm2[slot + i];
    }
  }
}

// One thread per channel adds the partial rows 0 .. chunks-1 in that order.
__global__ void __launch_bounds__(kThreads)
bn_stats_finalize(const float* __restrict__ p1, const float* __restrict__ p2,
                  float* __restrict__ s1, float* __restrict__ s2, int chunks,
                  int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float a = 0.f, b = 0.f;
#pragma unroll 8
  for (int k = 0; k < chunks; ++k) {
    a += p1[(long long)k * C + c];
    b += p2[(long long)k * C + c];
  }
  s1[c] = a;
  s2[c] = b;
}

template <typename T, int VEC>
int launch(const void* x, float* s1, float* s2, float* p1, float* p2,
           long long n, int C, long long ld, int chunks, int tx,
           cudaStream_t stream) {
  const int ctiles = (C + tx * VEC - 1) / (tx * VEC);
  const long long rows_per_chunk = (n + chunks - 1) / chunks;
  const dim3 grid(chunks, ctiles), block(tx, kThreads / tx);
  const bool direct = chunks == 1;
  bn_stats_partial<T, VEC><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), direct ? s1 : p1, direct ? s2 : p2, n, C, ld,
      rows_per_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || direct) return (int)err;
  bn_stats_finalize<<<(C + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      p1, p2, s1, s2, chunks, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// x: [n, C] with row stride ld (elements) and contiguous channels; s1, s2:
// fp32 [C]; p1, p2: fp32 [chunks, C] scratch (unused when chunks == 1).
// is_bf16: 1 for bfloat16, 0 for float32. vec: channels per thread, 1 or
// 16 bytes' worth (8 bf16, 4 fp32; then x and ld*itemsize must be 16-byte
// aligned and C % vec == 0). tx: threads along the channel vectors, a power
// of two <= 256. Arguments the kernel does not take return
// cudaErrorInvalidValue.
int pose3d_bn_stats(const void* x, void* s1, void* s2, void* p1, void* p2,
                    int is_bf16, long long n, int C, long long ld, int chunks,
                    int vec, int tx, void* stream) {
  const int full = is_bf16 ? 8 : 4;
  if (n < 1 || C < 1 || chunks < 1 || chunks > n || tx < 1 || tx > kThreads ||
      (tx & (tx - 1)) != 0 || (vec != 1 && vec != full) ||
      (vec != 1 && C % vec != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* f1 = static_cast<float*>(s1);
  float* f2 = static_cast<float*>(s2);
  float* q1 = static_cast<float*>(p1);
  float* q2 = static_cast<float*>(p2);
  if (is_bf16) {
    if (vec == 8)
      return launch<__nv_bfloat16, 8>(x, f1, f2, q1, q2, n, C, ld, chunks, tx,
                                      st);
    return launch<__nv_bfloat16, 1>(x, f1, f2, q1, q2, n, C, ld, chunks, tx,
                                    st);
  }
  if (vec == 4)
    return launch<float, 4>(x, f1, f2, q1, q2, n, C, ld, chunks, tx, st);
  return launch<float, 1>(x, f1, f2, q1, q2, n, C, ld, chunks, tx, st);
}

const char* pose3d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
