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
// What bounds it on this card. Bytes: x and g read once, dx written once
// (37.8 MB at the ViT lifter's [8*1025, 768] bf16, microseconds of the
// card's memory rate, so launch latency shows there).
//
// Design (a simple kernel that is right comes first):
//  * dx is a matter of one row: one warp per row, lanes along C with 16-byte
//    reads where the wrapper found them possible, the two row means by warp
//    shuffles, as in the forward kernel;
//  * dscale and dbias sum over rows, across blocks that run in no order. The
//    TPU kernel wrote one partial row per 512-row block and summed them
//    outside; here each block walks a contiguous run of rows (the wrapper
//    cuts the rows into at most 264 runs, two for each SM), every lane adds
//    g*xhat and g of its own columns into registers as its warp goes from
//    row to row, the block's eight warps are folded through shared memory
//    in a fixed order, and the block writes one partial row. A second small
//    kernel adds the partial rows 0, 1, 2, ... one thread per column. No
//    atomics: a shape's gradients are the same from run to run;
//  * for C > 1024 a lane cannot hold its columns' sums in registers: each
//    warp then owns a partial row in device memory outright, zeroes it and
//    adds to it row by row (a lane only ever touches its own columns, so no
//    synchronisation is needed), and reads x and g a second time for dx.

#include "layer_norm_common.cuh"

namespace {

using namespace ln;

// grid (blocks), block 256. Block b takes rows [b*rpb, min(rows, (b+1)*rpb)),
// warp w of it the rows b*rpb + w, + 8, ... CACHED: p_ds, p_db are
// [blocks, C]; else [blocks * 8, C], one row a warp.
template <typename T, int VEC, bool CACHED>
__global__ void __launch_bounds__(kThreads)
layer_norm_bwd(const T* __restrict__ x, const float* __restrict__ scale,
               const float* __restrict__ mean, const float* __restrict__ rstd,
               const T* __restrict__ g, T* __restrict__ dx,
               float* __restrict__ p_ds, float* __restrict__ p_db,
               long long rows, int C, long long ld, long long rpb) {
  constexpr int NV = kCachedC / (32 * VEC);
  __shared__ float sm[CACHED ? kWarps * kCachedC : 1];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r0 = (long long)blockIdx.x * rpb;
  const long long r1 = min(r0 + rpb, rows);
  const float inv_c = 1.f / (float)C;

  float ds[NV][VEC], db[NV][VEC];
  float* wds = p_ds + ((long long)blockIdx.x * kWarps + warp) * C;
  float* wdb = p_db + ((long long)blockIdx.x * kWarps + warp) * C;
  if (CACHED) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) ds[i][j] = db[i][j] = 0.f;
    }
  } else {
    for (int c = lane * VEC; c < C; c += 32 * VEC) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) wds[c + j] = wdb[c + j] = 0.f;
    }
  }

  for (long long r = r0 + warp; r < r1; r += kWarps) {
    const T* xr = x + r * ld;
    const T* gr = g + r * C;
    T* dr = dx + r * C;
    const float mu = mean[r], rs = rstd[r];
    float t1 = 0.f, t2 = 0.f;
    if (CACHED) {
      float xh[NV][VEC], gv[NV][VEC];
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int c = (i * 32 + lane) * VEC;
        if (c < C) {
          Vec<T, VEC>::load(xr + c, xh[i]);
          Vec<T, VEC>::load(gr + c, gv[i]);
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            xh[i][j] = (xh[i][j] - mu) * rs;
            const float gs = gv[i][j] * scale[c + j];
            t1 += gs;
            t2 = fmaf(gs, xh[i][j], t2);
            ds[i][j] = fmaf(gv[i][j], xh[i][j], ds[i][j]);
            db[i][j] += gv[i][j];
          }
        }
      }
      const float m1 = warp_sum(t1) * inv_c;
      const float m2 = warp_sum(t2) * inv_c;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int c = (i * 32 + lane) * VEC;
        if (c < C) {
          float o[VEC];
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            o[j] = rs * (gv[i][j] * scale[c + j] - m1 - xh[i][j] * m2);
          }
          Vec<T, VEC>::store(dr + c, o);
        }
      }
    } else {
      for (int c = lane * VEC; c < C; c += 32 * VEC) {
        float xv[VEC], gv[VEC];
        Vec<T, VEC>::load(xr + c, xv);
        Vec<T, VEC>::load(gr + c, gv);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float xh = (xv[j] - mu) * rs;
          const float gs = gv[j] * scale[c + j];
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
          o[j] = rs * (gv[j] * scale[c + j] - m1 - xh * m2);
        }
        Vec<T, VEC>::store(dr + c, o);
      }
    }
  }

  if (CACHED) {
    // fold the eight warps' sums, warp 0 first, into the block's partial row
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
      float* out = (which == 0 ? p_ds : p_db) + (long long)blockIdx.x * C;
      for (int c = threadIdx.x; c < C; c += kThreads) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += sm[w * kCachedC + c];
        out[c] = s;
      }
      __syncthreads();
    }
  }
}

// One thread per column adds the partial rows 0 .. parts-1 in that order.
__global__ void __launch_bounds__(kThreads)
layer_norm_bwd_finalize(const float* __restrict__ p_ds,
                        const float* __restrict__ p_db,
                        float* __restrict__ dscale, float* __restrict__ dbias,
                        int parts, int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float a = 0.f, b = 0.f;
#pragma unroll 8
  for (int k = 0; k < parts; ++k) {
    a += p_ds[(long long)k * C + c];
    b += p_db[(long long)k * C + c];
  }
  dscale[c] = a;
  dbias[c] = b;
}

struct Args {
  const void* x;
  const float* scale;
  const float* mean;
  const float* rstd;
  const void* g;
  void* dx;
  float* p_ds;
  float* p_db;
  float* dscale;
  float* dbias;
  long long rows, ld;
  int C, blocks;
};

template <typename T, int VEC, bool CACHED>
int launch2(const Args& a, cudaStream_t stream) {
  const long long rpb = (a.rows + a.blocks - 1) / a.blocks;
  layer_norm_bwd<T, VEC, CACHED><<<a.blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(a.x), a.scale, a.mean, a.rstd,
      static_cast<const T*>(a.g), static_cast<T*>(a.dx), a.p_ds, a.p_db,
      a.rows, a.C, a.ld, rpb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int parts = CACHED ? a.blocks : a.blocks * kWarps;
  layer_norm_bwd_finalize<<<(a.C + kThreads - 1) / kThreads, kThreads, 0,
                            stream>>>(a.p_ds, a.p_db, a.dscale, a.dbias,
                                      parts, a.C);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int launch(const Args& a, bool cached, cudaStream_t stream) {
  if (cached) return launch2<T, VEC, true>(a, stream);
  return launch2<T, VEC, false>(a, stream);
}

}  // namespace

extern "C" {

// Launches both kernels on `stream` and returns cudaGetLastError() (0 on
// success). x: [rows, C] with row stride ld (elements); g, dx: [rows, C]
// contiguous, x's type; scale: fp32 [C]; mean, rstd: fp32 [rows]; p_ds,
// p_db: fp32 scratch, [blocks, C] when cached else [blocks * 8, C]; dscale,
// dbias: fp32 [C]. blocks: the grid, each block a contiguous run of
// ceil(rows / blocks) rows. is_bf16, vec, cached as in layer_norm_fwd.cu
// (x, g, dx and ld*itemsize 16-byte aligned when vec > 1).
int pose3d_layer_norm_bwd(const void* x, const void* scale, const void* mean,
                          const void* rstd, const void* g, void* dx,
                          void* p_ds, void* p_db, void* dscale, void* dbias,
                          int is_bf16, long long rows, int C, long long ld,
                          int blocks, int vec, int cached, void* stream) {
  const int full = is_bf16 ? 8 : 4;
  if (rows < 1 || C < 1 || blocks < 1 || (vec != 1 && vec != full) ||
      (vec != 1 && C % vec != 0) || (cached && C > kCachedC))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = x;
  a.scale = static_cast<const float*>(scale);
  a.mean = static_cast<const float*>(mean);
  a.rstd = static_cast<const float*>(rstd);
  a.g = g;
  a.dx = dx;
  a.p_ds = static_cast<float*>(p_ds);
  a.p_db = static_cast<float*>(p_db);
  a.dscale = static_cast<float*>(dscale);
  a.dbias = static_cast<float*>(dbias);
  a.rows = rows;
  a.ld = ld;
  a.C = C;
  a.blocks = blocks;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool c = cached != 0;
  if (is_bf16) {
    if (vec == 8) return launch<__nv_bfloat16, 8>(a, c, st);
    return launch<__nv_bfloat16, 1>(a, c, st);
  }
  if (vec == 4) return launch<float, 4>(a, c, st);
  return launch<float, 1>(a, c, st);
}

const char* pose3d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
