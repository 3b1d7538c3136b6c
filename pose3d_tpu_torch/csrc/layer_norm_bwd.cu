// Row LayerNorm backward for Hopper (sm_90a).
//
// Replaces pose3d_tpu/ops/pallas/layer_norm.py::_bwd_kernel (launched by
// pl.pallas_call in _bwd_impl). For x, g [rows, C] (bf16 or fp32; x with row
// stride `ld`, g contiguous), fp32 scale [C] and the forward's fp32 mean,
// rstd [rows] it computes, in fp32,
//   xhat = (x - mean) * rstd,   gs = g * scale,
//   dx = rstd * (gs - mean_row(gs) - xhat * mean_row(gs * xhat)),
//   dscale = sum_rows g * xhat,   dbias = sum_rows g        (fp32 [C]),
// with dx [rows, C] written in x's type.
//
// What bounds it on this card. Bytes: x and g read once, dx written once,
// ~14 operations an element against 6 bytes in bf16 (the card's fp32 rate
// would take ~20 a byte). 37.9 MB at the ViT lifter's [8*1025, 768] bf16
// (0.011 ms), 473 MB at the 100*1025 rows of a grouped 10 x 10 step. A row's
// dx needs the whole row first (two row means), so a warp that loads a row
// and then reduces it has nothing else in flight; and dscale, dbias sum over
// rows across blocks that run in no order.
//
// Design:
//  * dx is a matter of one row: one warp a row, lanes along C with 16-byte
//    reads where the wrapper found them possible, the row kept packed in
//    registers (NV vectors a lane, C <= NV*32*VEC), the two row means by warp
//    shuffles. Each warp loads its next row (x, g, mean, rstd) before it
//    reduces the current one, so two rows a warp are in flight: 48 KB an SM
//    at C 768 bf16, with two blocks of eight warps on each SM;
//  * dscale and dbias: every lane adds g*xhat and g of its own columns into
//    registers as its warp goes from row to row (the block walks a
//    contiguous run of rows, its warps taking every eighth), the eight
//    warps are folded through shared memory in a fixed order into the
//    block's partial row [dscale | dbias], and after a barrier of all
//    blocks each adds a share of the columns over all partial rows
//    (row_reduce.cuh: a cooperative launch, a fixed order of addition). One
//    launch a call; no atomics in any sum, so a shape's gradients are the
//    same from run to run. The TPU kernel wrote one partial row per 512-row
//    block and summed them outside;
//  * C > 1024 (on no path of the models) keeps the earlier design for the
//    rows: a lane cannot hold its columns' sums in registers, so each warp
//    owns a partial row in device memory outright, zeroes it and adds to it
//    row by row (a lane only touches its own columns), and reads x and g a
//    second time for dx; the block then adds its eight warp rows, in order,
//    into its partial row, and the same combine follows.
//
// pose3d_layer_norm_bwd_config reports the plan; ops/kernels/layer_norm.py
// mirrors it in Python to size the scratch and counters.

#include <cstdint>

#include "layer_norm_common.cuh"
#include "row_reduce.cuh"

namespace {

using namespace ln;

constexpr int kSMs = 132;

// blocks of kThreads a SM: two where a lane's registers allow (bf16 rows
// of up to 768 columns), else one
__host__ __device__ constexpr int blocks_per_sm(int vec, int nv) {
  return vec == 8 && nv <= 3 ? 2 : 1;
}

struct Plan {
  int vec, cached, nv, P, Cp;
  long long rpb, scratch_floats, counters;
};

Plan make_plan(long long rows, int C, int is_bf16, int aligned) {
  Plan p;
  const int full = is_bf16 ? 8 : 4;
  p.vec = aligned && C % full == 0 ? full : 1;
  p.cached = C <= kCachedC;
  p.nv = !p.cached ? 0 : p.vec == 1 ? kCachedC / 32
                                    : (C + 32 * p.vec - 1) / (32 * p.vec);
  const long long most = (long long)kSMs * blocks_per_sm(p.vec, p.nv);
  const long long warp_rows = (rows + kWarps - 1) / kWarps;
  const long long blocks = warp_rows < most ? warp_rows : most;
  p.rpb = (rows + blocks - 1) / blocks;
  p.P = (int)((rows + p.rpb - 1) / p.rpb);
  p.Cp = (C + 3) / 4 * 4;
  const long long W = 2LL * p.Cp;
  p.scratch_floats = (long long)p.P * W * (p.cached ? 1 : 1 + kWarps);
  p.counters = 2;
  return p;
}

struct Args {
  const void* x;
  const float* scale;
  const float* mean;
  const float* rstd;
  const void* g;
  void* dx;
  float* dscale;
  float* dbias;
  float* scratch;
  unsigned* counters;
  long long rows, ld;
  int C;
};

// VEC values of scale from column c
template <int VEC>
__device__ __forceinline__ void load_scale(const float* p, float (&v)[VEC]) {
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

// The result's store: column col of the final [dscale | dbias] row.
__device__ __forceinline__ void store_grads(const Args& a, int Cp, int q,
                                            const float4& v) {
  const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = 4 * q + j;
    if (col < a.C) {
      a.dscale[col] = e[j];
    } else if (col >= Cp && col - Cp < a.C) {
      a.dbias[col - Cp] = e[j];
    }
  }
}

// grid (P), block kThreads. Block b takes rows [b*rpb, min(rows, (b+1)*rpb)),
// warp w of it the rows b*rpb + w, + 8, ... Its partial row is row b of
// `scratch`; PREFETCH: the next row is loaded before the current one
// is reduced (the 16-byte paths; the one-value path keeps its registers).
template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(kThreads, blocks_per_sm(VEC, NV))
layer_norm_bwd(const Args a, long long rpb, int P, int Cp) {
  using Pk = rr::Packed<T, VEC>;
  using PT = typename Pk::type;
  constexpr bool PREFETCH = VEC > 1;
  __shared__ __align__(16) float sm[kWarps * kCachedC];
  const T* x = static_cast<const T*>(a.x);
  const T* g = static_cast<const T*>(a.g);
  T* dx = static_cast<T*>(a.dx);
  const int C = a.C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r0 = (long long)blockIdx.x * rpb;
  const long long r1 = min(r0 + rpb, a.rows);
  const float inv_c = 1.f / (float)C;

  float ds[NV][VEC], db[NV][VEC];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) ds[i][j] = db[i][j] = 0.f;
  }
  PT xc[NV], gc[NV];
  float mu = 0.f, rs = 0.f;
  auto load_row = [&](long long r, PT (&xo)[NV], PT (&go)[NV], float& m,
                      float& s) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = (i * 32 + lane) * VEC;
      xo[i] = go[i] = Pk::zero();
      if (c < C) {
        xo[i] = Pk::load(x + r * a.ld + c);
        go[i] = Pk::load(g + r * C + c);
      }
    }
    m = __ldg(a.mean + r);
    s = __ldg(a.rstd + r);
  };

  long long r = r0 + warp;
  if (PREFETCH && r < r1) load_row(r, xc, gc, mu, rs);
  for (; r < r1; r += kWarps) {
    if (!PREFETCH) load_row(r, xc, gc, mu, rs);
    PT xn[NV], gn[NV];
    float mun = 0.f, rsn = 0.f;
    if (PREFETCH && r + kWarps < r1) load_row(r + kWarps, xn, gn, mun, rsn);
    float t1 = 0.f, t2 = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = (i * 32 + lane) * VEC;
      if (c < C) {
        float xv[VEC], gv[VEC], sc[VEC];
        Pk::unpack(xc[i], xv);
        Pk::unpack(gc[i], gv);
        load_scale<VEC>(a.scale + c, sc);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float xh = (xv[j] - mu) * rs;
          const float gs = gv[j] * sc[j];
          t1 += gs;
          t2 = fmaf(gs, xh, t2);
          ds[i][j] = fmaf(gv[j], xh, ds[i][j]);
          db[i][j] += gv[j];
        }
      }
    }
    const float m1 = warp_sum(t1) * inv_c;
    const float m2 = warp_sum(t2) * inv_c;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = (i * 32 + lane) * VEC;
      if (c < C) {
        float xv[VEC], gv[VEC], sc[VEC], o[VEC];
        Pk::unpack(xc[i], xv);
        Pk::unpack(gc[i], gv);
        load_scale<VEC>(a.scale + c, sc);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float xh = (xv[j] - mu) * rs;
          o[j] = rs * (gv[j] * sc[j] - m1 - xh * m2);
        }
        Vec<T, VEC>::store(dx + r * C + c, o);
      }
    }
    if (PREFETCH) {
#pragma unroll
      for (int i = 0; i < NV; ++i) xc[i] = xn[i], gc[i] = gn[i];
      mu = mun, rs = rsn;
    }
  }

  // fold the eight warps' sums, warp 0 first, into the block's partial row
  const int W = 2 * Cp;
  float* row = a.scratch + (long long)blockIdx.x * W;
#pragma unroll
  for (int which = 0; which < 2; ++which) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = (i * 32 + lane) * VEC;
      if (c < C) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          sm[warp * kCachedC + c + j] = which == 0 ? ds[i][j] : db[i][j];
        }
      }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < Cp; c += kThreads) {
      float s = 0.f;
      if (c < C) {
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += sm[w * kCachedC + c];
      }
      row[which * Cp + c] = s;
    }
    __syncthreads();
  }
  rr::combine<kThreads>(
      a.scratch, a.counters, P, W, blockIdx.x, reinterpret_cast<float4*>(sm),
      [&](int q, const float4& v) { store_grads(a, Cp, q, v); });
}

// C > kCachedC. Warp w of block b adds into its own row b*8 + w of the warp
// rows that follow the P partial rows in `scratch`.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, 1)
layer_norm_bwd_wide(const Args a, long long rpb, int P, int Cp) {
  const T* x = static_cast<const T*>(a.x);
  const T* g = static_cast<const T*>(a.g);
  T* dx = static_cast<T*>(a.dx);
  const int C = a.C;
  const int W = 2 * Cp;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r0 = (long long)blockIdx.x * rpb;
  const long long r1 = min(r0 + rpb, a.rows);
  const float inv_c = 1.f / (float)C;
  float* wrows = a.scratch + (long long)P * W;
  float* wds = wrows + ((long long)blockIdx.x * kWarps + warp) * W;
  float* wdb = wds + Cp;
  for (int c = lane * VEC; c < C; c += 32 * VEC) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) wds[c + j] = wdb[c + j] = 0.f;
  }

  for (long long r = r0 + warp; r < r1; r += kWarps) {
    const T* xr = x + r * a.ld;
    const T* gr = g + r * C;
    T* dr = dx + r * C;
    const float mu = a.mean[r], rs = a.rstd[r];
    float t1 = 0.f, t2 = 0.f;
    for (int c = lane * VEC; c < C; c += 32 * VEC) {
      float xv[VEC], gv[VEC];
      Vec<T, VEC>::load(xr + c, xv);
      Vec<T, VEC>::load(gr + c, gv);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float xh = (xv[j] - mu) * rs;
        const float gs = gv[j] * a.scale[c + j];
        t1 += gs;
        t2 = fmaf(gs, xh, t2);
        wds[c + j] = fmaf(gv[j], xh, wds[c + j]);
        wdb[c + j] += gv[j];
      }
    }
    const float m1 = warp_sum(t1) * inv_c;
    const float m2 = warp_sum(t2) * inv_c;
    for (int c = lane * VEC; c < C; c += 32 * VEC) {
      float xv[VEC], gv[VEC], o[VEC];
      Vec<T, VEC>::load(xr + c, xv);
      Vec<T, VEC>::load(gr + c, gv);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float xh = (xv[j] - mu) * rs;
        o[j] = rs * (gv[j] * a.scale[c + j] - m1 - xh * m2);
      }
      Vec<T, VEC>::store(dr + c, o);
    }
  }
  __syncthreads();
  // the block's eight warp rows, warp 0 first, into its partial row
  const float* mine = wrows + (long long)blockIdx.x * kWarps * W;
  float* row = a.scratch + (long long)blockIdx.x * W;
  for (int c = threadIdx.x; c < W; c += kThreads) {
    float s = 0.f;
    if (c % Cp < C) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += __ldcg(mine + (long long)w * W + c);
    }
    row[c] = s;
  }
  __shared__ float4 cbuf[kThreads];
  rr::combine<kThreads>(
      a.scratch, a.counters, P, W, blockIdx.x, cbuf,
      [&](int q, const float4& v) { store_grads(a, Cp, q, v); });
}

using Kernel = void (*)(Args, long long, int, int);

// the 16-byte paths: NV = 1 .. kCachedC / (32 * VEC), one kernel each
template <typename T, int VEC, int NV = 1>
Kernel pick_nv(int nv) {
  if constexpr (NV * 32 * VEC > kCachedC) {
    return nullptr;
  } else {
    return nv == NV ? layer_norm_bwd<T, VEC, NV> : pick_nv<T, VEC, NV + 1>(nv);
  }
}

template <typename T, int FULL>
Kernel pick(const Plan& p) {
  if (!p.cached) {
    return p.vec == FULL ? layer_norm_bwd_wide<T, FULL>
                         : layer_norm_bwd_wide<T, 1>;
  }
  if (p.vec == FULL) return pick_nv<T, FULL>(p.nv);
  return layer_norm_bwd<T, 1, kCachedC / 32>;
}

// The kernel a plan launches.
Kernel kernel_for(const Plan& p, int is_bf16) {
  return is_bf16 ? pick<__nv_bfloat16, 8>(p) : pick<float, 4>(p);
}

}  // namespace

extern "C" {

// The plan of a launch: cfg[0] vec, [1] cached (C <= 1024), [2] vectors a
// lane keeps of a row (NV; 0 when not cached), [3] blocks P, [4] rows a
// block, [5] resident blocks an SM the kernel is built for, [6] scratch
// floats, [7] counters, [8] launches a call (1), [9] the kernel's static
// shared memory in bytes, as built. aligned: x, g, dx and scale start on 16
// bytes and ld * itemsize is a multiple of 16.
int pose3d_layer_norm_bwd_config(long long rows, int C, int is_bf16,
                                 int aligned, long long* cfg) {
  if (rows < 1 || C < 1) return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(rows, C, is_bf16, aligned);
  cfg[0] = p.vec, cfg[1] = p.cached, cfg[2] = p.nv, cfg[3] = p.P;
  cfg[4] = p.rpb, cfg[5] = blocks_per_sm(p.vec, p.nv);
  cfg[6] = p.scratch_floats, cfg[7] = p.counters, cfg[8] = 1;
  cudaFuncAttributes fa;
  const cudaError_t err = cudaFuncGetAttributes(
      &fa, reinterpret_cast<const void*>(kernel_for(p, is_bf16)));
  cfg[9] = (long long)fa.sharedSizeBytes;
  return (int)err;
}

// Launches one kernel on `stream` and returns cudaGetLastError() (0 on
// success). x: [rows, C] with row stride ld (elements); g, dx: [rows, C]
// contiguous, x's type; scale: fp32 [C]; mean, rstd: fp32 [rows]; dscale,
// dbias: fp32 [C]; scratch: fp32, scratch_floats of them; counters:
// n_counters unsigned ints, 0 on entry and left 0 (one buffer for each
// stream: see row_reduce.cuh). is_bf16: 1 for bfloat16, 0 for float32. The
// plan is pose3d_layer_norm_bwd_config's; scratch or counters smaller than
// it needs, and arguments the kernel does not take, return
// cudaErrorInvalidValue.
int pose3d_layer_norm_bwd(const void* x, const void* scale, const void* mean,
                          const void* rstd, const void* g, void* dx,
                          void* dscale, void* dbias, void* scratch,
                          long long scratch_floats, void* counters,
                          long long n_counters, int is_bf16, long long rows,
                          int C, long long ld, void* stream) {
  if (rows < 1 || C < 1 || (rows > 1 && ld < C))
    return (int)cudaErrorInvalidValue;
  const int itemsize = is_bf16 ? 2 : 4;
  const int aligned = (ld * itemsize) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(dx) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(scale) % 16 == 0;
  const Plan p = make_plan(rows, C, is_bf16, aligned);
  if (scratch_floats < p.scratch_floats || n_counters < p.counters)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = x;
  a.scale = static_cast<const float*>(scale);
  a.mean = static_cast<const float*>(mean);
  a.rstd = static_cast<const float*>(rstd);
  a.g = g;
  a.dx = dx;
  a.dscale = static_cast<float*>(dscale);
  a.dbias = static_cast<float*>(dbias);
  a.scratch = static_cast<float*>(scratch);
  a.counters = static_cast<unsigned*>(counters);
  a.rows = rows;
  a.ld = ld;
  a.C = C;
  const Kernel k = kernel_for(p, is_bf16);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  return rr::launch(p.P > 1, k, dim3(p.P), dim3(kThreads),
                    static_cast<cudaStream_t>(stream), a, p.rpb, p.P, p.Cp);
}

const char* pose3d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
