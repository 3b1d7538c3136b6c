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
// write of y. At the ViT lifter's [8*1025, 768] bf16 that is 25.3 MB
// (0.0075 ms at 3.35 TB/s), so the launch and the first round trip to
// memory show; the 100*1025 rows of a grouped 10 x 10 step move 315.7 MB
// (0.094 ms). The rows are independent: no sum crosses a row.
//
// Design (the 16-byte path: x, y, scale, bias on 16 bytes, ld * itemsize a
// multiple of 16, C a multiple of VEC = 8 bf16 or 4 fp32, C <= 1024):
//  * a persistent grid, sized by the shape alone: at most blocks_per_sm
//    blocks on each of the 132 SMs (two where a lane's registers allow),
//    each of eight consumer warps and one producer warp. Block b takes the
//    groups of eight rows g = b, b + blocks, ...; consumer warp w of it row
//    w of each group. So warp b * 8 + w of the grid's W takes rows
//    b * 8 + w, + W, + 2W, ...: every row has one owner, and since no sum
//    crosses a row there is no barrier between blocks;
//  * one thread of the producer warp streams the groups' rows whole into a
//    ring of kStages stages of eight rows in shared memory, by 1-D bulk
//    copies (TMA, no tensor map) that complete on the stage's full
//    mbarrier, kStages groups ahead: at 8,200 rows every block's rows are
//    asked for at its start. A consumer warp takes its row of a stage into
//    registers (16 bytes a lane, rr::Packed's unit), releases the stage
//    (the empty mbarrier counts the eight warps), and reduces and writes;
//  * scale and bias: each lane loads its columns of both once, as float4,
//    and keeps them in registers for the warp's whole life (2 x 24 floats
//    at C 768);
//  * y is written 16 bytes at a time with the streaming hint (st.global.cs:
//    nothing here reads it again); mean and rstd once a row, by lane 0;
//  * both sums are taken per lane in a fixed order and folded by warp
//    shuffles in a fixed tree: the shape alone fixes every order of
//    addition, so a shape's outputs are bitwise the same from run to run.
// Every other shape (C > 1024, C not a multiple of VEC, an unaligned
// address) takes layer_norm_fwd_rows: warp g of the grid's W takes rows g,
// g + W, ...; VEC values a lane at a time (16 bytes where the addresses
// allow, else one value), the row read twice, the second time from the
// caches, scale and bias where they are used.
//
// The other design measured, a register stream (each warp loads its next
// row into registers before it reduces the current one), is
// scripts/layer_norm_fwd_register_stream.cu (its times are in PERF.md).
//
// pose3d_layer_norm_fwd_config reports the plan; ops/kernels/layer_norm.py
// mirrors it in Python (fwd_launch_config) for the checks.

#include <cstdint>

#include "hopper_mma.cuh"
#include "layer_norm_common.cuh"
#include "row_reduce.cuh"

namespace {

using namespace ln;

constexpr int kSMs = 132;
constexpr int kStages = 4;                   // groups in flight a block
constexpr int kRingThreads = kThreads + 32;  // eight consumer warps, a producer

// resident blocks an SM a kernel is built for: the ring (nv > 0) two where a
// lane keeps at most 64 words (its row's NV 16-byte vectors, 4 words each,
// and NV * VEC columns each of scale and bias; 112 registers a thread at
// two blocks of 288 threads), else one; the row loop (nv 0) two
__host__ __device__ constexpr int blocks_per_sm(int vec, int nv) {
  return nv * (4 + 2 * vec) <= 64 ? 2 : 1;
}

struct Plan {
  int vec, cached, nv, per_sm, blocks, threads, stages, smem;
  long long rpw;
};

Plan make_plan(long long rows, int C, int is_bf16, int aligned) {
  Plan p;
  const int full = is_bf16 ? 8 : 4;
  p.vec = aligned && C % full == 0 ? full : 1;
  p.cached = p.vec > 1 && C <= kCachedC;
  p.nv = p.cached ? (C + 32 * p.vec - 1) / (32 * p.vec) : 0;
  p.per_sm = blocks_per_sm(p.vec, p.nv);
  p.threads = p.cached ? kRingThreads : kThreads;
  p.stages = p.cached ? kStages : 0;
  p.smem = p.cached ? kStages * kWarps * C * (is_bf16 ? 2 : 4) : 0;
  const long long most = (long long)kSMs * p.per_sm;
  const long long groups = (rows + kWarps - 1) / kWarps;
  p.blocks = (int)(groups < most ? groups : most);
  const long long warps = (long long)p.blocks * kWarps;
  p.rpw = (rows + warps - 1) / warps;
  return p;
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

// VEC fp32 values from p (16-byte aligned when VEC > 1), read-only path
template <int VEC>
__device__ __forceinline__ void load_f32(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    v[0] = __ldg(p);
  } else {
#pragma unroll
    for (int h = 0; h < VEC / 4; ++h) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p) + h);
      v[4 * h] = t.x, v[4 * h + 1] = t.y, v[4 * h + 2] = t.z, v[4 * h + 3] = t.w;
    }
  }
}

// VEC values of y at p, rounded once to T; the 16-byte stores carry the
// streaming hint (evict first: y is not read again here)
template <typename T, int VEC>
__device__ __forceinline__ void store_y(T* p, const float (&o)[VEC]) {
  if constexpr (VEC == 1) {
    Vec<T, 1>::store(p, o);
  } else if constexpr (sizeof(T) == 2) {
    uint4 t;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&t);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(o[2 * i], o[2 * i + 1]);
    __stcs(reinterpret_cast<uint4*>(p), t);
  } else {
    __stcs(reinterpret_cast<float4*>(p), make_float4(o[0], o[1], o[2], o[3]));
  }
}

// mean and rstd of a row from the lane's two sums
__device__ __forceinline__ void row_stats(float s1, float s2, float inv_c,
                                          float eps, float& mu, float& rs) {
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  mu = s1 * inv_c;
  const float var = fmaxf(s2 * inv_c - mu * mu, 0.f);
  rs = rsqrtf(var + eps);
}

// The 16-byte path: lane l of a consumer warp takes columns
// (i * 32 + l) * VEC .. + VEC - 1 of its row, i < NV. Dynamic shared memory:
// kStages * 8 rows of C values.
template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(kRingThreads, blocks_per_sm(VEC, NV))
layer_norm_fwd_ring(const Args a) {
  using Pk = rr::Packed<T, VEC>;
  using PT = typename Pk::type;
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int C = a.C;
  const uint32_t row_bytes = (uint32_t)C * sizeof(T);
  const long long groups = (a.rows + kWarps - 1) / kWarps;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hmma::mbar_init(hmma::smem_u32(&full[s]), 1);
      hmma::mbar_init(hmma::smem_u32(&empty[s]), kWarps);
    }
    hmma::mbar_fence_init();
  }
  __syncthreads();

  // The ring: group number k of this block (counted from 0) lives in stage
  // k % kStages, in the barriers' phase of parity (k / kStages) & 1.
  if (warp == kWarps) {
    if (lane == 0) {
      const T* x = static_cast<const T*>(a.x);
      int k = 0;
      for (long long g = blockIdx.x; g < groups; g += gridDim.x, ++k) {
        const int s = k % kStages;
        hmma::mbar_wait(hmma::smem_u32(&empty[s]), ((k / kStages) & 1) ^ 1);
        const long long r0 = g * kWarps;
        const int n = (int)min((long long)kWarps, a.rows - r0);
        const uint32_t bar = hmma::smem_u32(&full[s]);
        hmma::mbar_expect_tx(bar, n * row_bytes);
        for (int w = 0; w < n; ++w) {
          hmma::bulk_load_1d(
              hmma::smem_u32(ring + (s * kWarps + w) * row_bytes),
              x + (r0 + w) * a.ld, row_bytes, bar);
        }
      }
    }
    return;
  }

  T* y = static_cast<T*>(a.y);
  const float inv_c = 1.f / (float)C;
  float sc[NV][VEC], bi[NV][VEC];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = (i * 32 + lane) * VEC;
#pragma unroll
    for (int j = 0; j < VEC; ++j) sc[i][j] = bi[i][j] = 0.f;
    if (c < C) {
      load_f32<VEC>(a.scale + c, sc[i]);
      load_f32<VEC>(a.bias + c, bi[i]);
    }
  }
  int k = 0;
  for (long long g = blockIdx.x; g < groups; g += gridDim.x, ++k) {
    const int s = k % kStages;
    hmma::mbar_wait(hmma::smem_u32(&full[s]), (k / kStages) & 1);
    const long long r = g * kWarps + warp;
    const T* xs =
        reinterpret_cast<const T*>(ring + (s * kWarps + warp) * row_bytes);
    PT xc[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = (i * 32 + lane) * VEC;
      xc[i] = Pk::zero();
      if (c < C && r < a.rows) xc[i] = *reinterpret_cast<const PT*>(xs + c);
    }
    __syncwarp();
    if (lane == 0) hmma::mbar_arrive(hmma::smem_u32(&empty[s]));
    if (r >= a.rows) continue;
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
    float mu, rs;
    row_stats(s1, s2, inv_c, a.eps, mu, rs);
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
  }
}

// Every other shape: the row read twice, VEC values a lane at a time.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, blocks_per_sm(VEC, 0))
layer_norm_fwd_rows(const Args a) {
  using Pk = rr::Packed<T, VEC>;
  const T* x = static_cast<const T*>(a.x);
  T* y = static_cast<T*>(a.y);
  const int C = a.C;
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * kWarps;
  const float inv_c = 1.f / (float)C;
  for (long long r = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       r < a.rows; r += stride) {
    const T* xr = x + r * a.ld;
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane * VEC; c < C; c += 32 * VEC) {
      float v[VEC];
      Pk::unpack(Pk::load(xr + c), v);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        s1 += v[j];
        s2 = fmaf(v[j], v[j], s2);
      }
    }
    float mu, rs;
    row_stats(s1, s2, inv_c, a.eps, mu, rs);
    if (lane == 0) {
      a.mean[r] = mu;
      a.rstd[r] = rs;
    }
    for (int c = lane * VEC; c < C; c += 32 * VEC) {
      float v[VEC], o[VEC], s[VEC], b[VEC];
      Pk::unpack(Pk::load(xr + c), v);
      load_f32<VEC>(a.scale + c, s);
      load_f32<VEC>(a.bias + c, b);
#pragma unroll
      for (int j = 0; j < VEC; ++j) o[j] = (v[j] - mu) * rs * s[j] + b[j];
      store_y<T, VEC>(y + r * C + c, o);
    }
  }
}

using Kernel = void (*)(Args);

// the ring: NV = 1 .. kCachedC / (32 * VEC), one kernel each
template <typename T, int VEC, int NV = 1>
Kernel pick_nv(int nv) {
  if constexpr (NV * 32 * VEC > kCachedC) {
    return nullptr;
  } else {
    return nv == NV ? layer_norm_fwd_ring<T, VEC, NV>
                    : pick_nv<T, VEC, NV + 1>(nv);
  }
}

template <typename T, int FULL>
Kernel pick(const Plan& p) {
  if (p.cached) return pick_nv<T, FULL>(p.nv);
  return p.vec == FULL ? layer_norm_fwd_rows<T, FULL>
                       : layer_norm_fwd_rows<T, 1>;
}

// The kernel a plan launches.
Kernel kernel_for(const Plan& p, int is_bf16) {
  return is_bf16 ? pick<__nv_bfloat16, 8>(p) : pick<float, 4>(p);
}

}  // namespace

extern "C" {

// The plan of a launch: cfg[0] vec, [1] cached (the ring: the 16-byte path
// with C <= 1024, each row read once), [2] vectors a lane keeps of a row
// (NV; 0 off the ring), [3] blocks, [4] threads a block, [5] rows a warp at
// most, [6] resident blocks an SM the kernel is built for, [7] the ring's
// stages, [8] its dynamic shared memory in bytes, [9] launches a call (1).
// aligned: x, y, scale and bias start on 16 bytes and ld * itemsize is a
// multiple of 16.
int pose3d_layer_norm_fwd_config(long long rows, int C, int is_bf16,
                                 int aligned, long long* cfg) {
  if (rows < 1 || C < 1) return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(rows, C, is_bf16, aligned);
  cfg[0] = p.vec, cfg[1] = p.cached, cfg[2] = p.nv, cfg[3] = p.blocks;
  cfg[4] = p.threads, cfg[5] = p.rpw, cfg[6] = p.per_sm, cfg[7] = p.stages;
  cfg[8] = p.smem, cfg[9] = 1;
  return (int)cudaSuccess;
}

// Launches one kernel on `stream` and returns its error code (0 on
// success). x: [rows, C] with row stride ld (elements); scale, bias: fp32
// [C]; y: [rows, C] contiguous, x's type; mean, rstd: fp32 [rows]. is_bf16:
// 1 for bfloat16, 0 for float32. The plan is pose3d_layer_norm_fwd_config's
// for the alignment of these addresses; arguments the kernel does not take
// return cudaErrorInvalidValue.
int pose3d_layer_norm_fwd(const void* x, const void* scale, const void* bias,
                          void* y, void* mean, void* rstd, int is_bf16,
                          long long rows, int C, long long ld, float eps,
                          void* stream) {
  if (rows < 1 || C < 1 || (rows > 1 && ld < C))
    return (int)cudaErrorInvalidValue;
  const int itemsize = is_bf16 ? 2 : 4;
  const int aligned = (ld * itemsize) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(scale) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(bias) % 16 == 0;
  const Plan p = make_plan(rows, C, is_bf16, aligned);
  const Kernel k = kernel_for(p, is_bf16);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  const void* fn = reinterpret_cast<const void*>(k);
  cudaError_t err = cudaSuccess;
  if (p.smem > 0) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               p.smem);
    if (err != cudaSuccess) return (int)err;
  }
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
  void* args[] = {&a};
  err = cudaLaunchKernel(fn, dim3(p.blocks), dim3(p.threads), args, p.smem,
                         static_cast<cudaStream_t>(stream));
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

const char* pose3d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
