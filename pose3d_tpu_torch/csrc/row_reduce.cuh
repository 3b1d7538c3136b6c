// What bn_stats.cu and layer_norm_bwd.cu share: the row stream's unit, and
// column sums across the blocks of one launch, added in a fixed order. Each
// block of such a kernel reduces its own rows to one partial row of W
// floats (W % 4 == 0); the partial rows of all blocks then have to be
// added, and blocks run in parallel and in no order. Here the kernel that
// wrote them also adds them (combine):
//
//  * the launch is cooperative, so every block of the grid is resident at
//    once (the launch is refused, never hangs, when the grid does not fit),
//    and the P blocks of a tile meet at a barrier once their partial rows
//    are written: two counters, arrivals and departures; the last block out
//    sets both back to 0;
//  * then every block adds its own share of the columns over all P rows:
//    float4 column q goes to block q mod P, whose threads take the rows in
//    lanes (row l, l + lanes, ... for lane l) and fold the lanes by a fixed
//    tree (shared memory, then warp shuffles). The shape alone fixes every
//    order of addition, so a shape's sums are bitwise the same from run to
//    run; no atomics in any sum;
//  * the counters must be 0 when the kernel starts, with no launch of their
//    own: the wrapper keeps one zeroed buffer of counters for each device and
//    stream (ops/kernels/_launch.py, stream_counters), and each kernel leaves
//    them at 0. Two calls never share a counter at the same time: calls on
//    one stream run one after the other (the next kernel starts when every
//    block of this one has returned), and calls on other streams have other
//    counters.
//
// The other way measured, with no barrier (the block that arrives last at
// a group of partial rows adds them, a tree of such groups), was 4-10%
// slower at the stem's bn_stats and at the lifter's 8,200 layer_norm rows
// and 2-4% faster at 10,240 x 512 and 102,500 rows (PERF.md, PR 8).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <tuple>

namespace rr {

// The row stream's unit: 16 bytes of a row (8 bf16 or 4 fp32 values) as
// loaded, kept packed while it is in flight, or one value (VEC = 1), and
// its values in fp32.
template <typename T, int VEC>
struct Packed;

template <>
struct Packed<__nv_bfloat16, 8> {
  using type = uint4;
  static __device__ __forceinline__ type load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ type zero() { return make_uint4(0, 0, 0, 0); }
  static __device__ __forceinline__ void unpack(const type& t, float (&v)[8]) {
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
struct Packed<float, 4> {
  using type = float4;
  static __device__ __forceinline__ type load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ type zero() { return make_float4(0, 0, 0, 0); }
  static __device__ __forceinline__ void unpack(const type& t, float (&v)[4]) {
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  }
};

template <>
struct Packed<__nv_bfloat16, 1> {
  using type = float;
  static __device__ __forceinline__ type load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ type zero() { return 0.f; }
  static __device__ __forceinline__ void unpack(const type& t, float (&v)[1]) {
    v[0] = t;
  }
};

template <>
struct Packed<float, 1> {
  using type = float;
  static __device__ __forceinline__ type load(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ type zero() { return 0.f; }
  static __device__ __forceinline__ void unpack(const type& t, float (&v)[1]) {
    v[0] = t;
  }
};

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Called by all NT threads of block idx (0 .. P-1) of a tile once they
// have written its partial row at rows + idx * W. `rows`: the tile's P rows
// (16-byte aligned); `bar`: its two counters; `buf`: NT float4 of shared
// memory. Calls store(q, v) once for every q < W / 4 (each q in one block,
// q mod P) with v the sum of columns 4q .. 4q+3 over all P rows.
template <int NT, class Store>
__device__ __forceinline__ void combine(const float* rows, unsigned* bar,
                                        int P, int W, int idx, float4* buf,
                                        Store store) {
  const int W4 = W >> 2;
  __threadfence();
  __syncthreads();
  if (P > 1 && threadIdx.x == 0) {
    atomicAdd(bar, 1u);
    while (ld_acquire(bar) < (unsigned)P) {
    }
  }
  __syncthreads();
  // this block's columns side by side: `lanes` threads a column, the
  // power of two >= P (at most NT), halved until the block's columns fit
  const int most = (W4 + P - 1) / P;
  int lanes = NT;
  while (lanes > 1 && lanes / 2 >= P) lanes >>= 1;
  while (lanes > 1 && (NT / lanes) < most) lanes >>= 1;
  const int G = NT / lanes;
  const int j = threadIdx.x / lanes, l = threadIdx.x % lanes;
  const int cq = idx < W4 ? (W4 - 1 - idx) / P + 1 : 0;
  const float4* src = reinterpret_cast<const float4*>(rows);
  for (int c0 = 0; c0 < cq; c0 += G) {
    const int cj = c0 + j;
    const int q = idx + cj * P;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (cj < cq) {
      for (int k = l; k < P; k += 4 * lanes) {
        float4 b[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (k + u * lanes < P) b[u] = __ldcg(src + (long long)(k + u * lanes) * W4 + q);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (k + u * lanes < P) add4(v, b[u]);
        }
      }
    }
    if (lanes > 32) {
      buf[threadIdx.x] = v;
      __syncthreads();
      for (int s = lanes >> 1; s >= 32; s >>= 1) {
        if (l < s) add4(buf[threadIdx.x], buf[threadIdx.x + s]);
        __syncthreads();
      }
      v = buf[threadIdx.x];
    }
    for (int off = (lanes < 32 ? lanes : 32) >> 1; off > 0; off >>= 1) {
      v.x += __shfl_xor_sync(0xffffffffu, v.x, off);
      v.y += __shfl_xor_sync(0xffffffffu, v.y, off);
      v.z += __shfl_xor_sync(0xffffffffu, v.z, off);
      v.w += __shfl_xor_sync(0xffffffffu, v.w, off);
    }
    if (l == 0 && cj < cq) store(q, v);
    if (lanes > 32) __syncthreads();
  }
  if (P > 1 && threadIdx.x == 0) {
    if (atomicAdd(bar + 1, 1u) == (unsigned)(P - 1)) {
      bar[0] = 0u;
      bar[1] = 0u;
    }
  }
}

// Launches `kernel` with `args` converted to its parameter types: a
// cooperative launch (every block resident at once, or the launch is
// refused) when `cooperative`, which a grid whose tiles have more than one
// block needs for combine's barrier. Returns the launch's error code.
template <typename... K, typename... A>
int launch(bool cooperative, void (*kernel)(K...), dim3 grid, dim3 block,
           cudaStream_t stream, A... args) {
  std::tuple<K...> vals(args...);
  void* ptrs[sizeof...(K)];
  std::apply(
      [&](auto&... v) {
        int i = 0;
        ((ptrs[i++] = static_cast<void*>(&v)), ...);
      },
      vals);
  const void* fn = reinterpret_cast<const void*>(kernel);
  const cudaError_t err =
      cooperative ? cudaLaunchCooperativeKernel(fn, grid, block, ptrs, 0, stream)
                  : cudaLaunchKernel(fn, grid, block, ptrs, 0, stream);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

}  // namespace rr
