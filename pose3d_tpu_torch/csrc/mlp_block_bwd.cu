// Fused transformer MLP backward for Hopper (sm_90a).
//
// Replaces pose3d_tpu/ops/pallas/mlp_block.py::_bwd_kernel (launched by
// pl.pallas_call in _bwd_impl). For x, g [N, D], W1 [D, H], W2 [H, D] in one
// type (bf16 or fp32) and fp32 b1 [H] it recomputes the hidden activation
// and computes
//   a   = x W1 + b1,  ga = gelu(a) rounded to x's type,
//   dga = g W2^T                         (fp32),
//   da  = dga * gelu'(a) rounded to x's type,
//   dx  = da W1^T                        in x's type,
//   dW1 = x^T da,  db1 = sum_rows da (of the rounded da),
//   dW2 = ga^T g,  db2 = sum_rows g      (fp32 [D,H], [H], [H,D], [D]),
// every product and sum accumulated in fp32. No [N, H] tensor reaches device
// memory.
//
// What bounds it on this card. Operations: the five products above are
// 10*N*D*H (193.5 GFLOP at N = 8*1025, D = 768, H = 3072) against some 60 MB
// of operands and gradients.
//
// Design. The TPU kernel adds dW1, dW2, db1 and db2 into VMEM blocks that it
// revisits from one step of a sequential grid to the next. Blocks here run
// in parallel and in no order, and nothing carries over between them. One
// launch over (row tile, hidden chunk) with fp32 atomics into dW1, dW2 and dx
// would make the gradients differ from run to run. This source instead
// launches two kernels, and every output element has one owner:
//  * mlp_bwd_dx, parallel over 32-row tiles: the block walks the hidden axis
//    in chunks of 64, recomputes a and dga for the chunk (one warp per
//    16 x 16 fragment of each), forms da in shared memory, and adds da W1^T
//    into its [32, D] dx tile, held in WMMA accumulator fragments in
//    registers as the forward kernel holds its output (hence D <= 768);
//  * mlp_bwd_dw, parallel over chunks of 16 hidden columns: the block walks
//    all rows in tiles of 32, recomputes a, ga, dga and da for its columns
//    (the depth D is split over warps in two halves, added in a fixed
//    order), and adds x^T da into its [D, 16] slice of dW1 and ga^T g into
//    its [16, D] slice of dW2, both in register fragments, db1 and a share
//    of db2's columns in registers; it writes each once at the end.
//  The price is one more recomputation of a and dga (14*N*D*H operations in
//  all), and that the second kernel reads x and g once per chunk (from L2).
//  No atomics: a shape's gradients are the same from run to run.
//  * bf16 runs on the tensor cores through WMMA m16n16k16 with fp32
//    accumulation, B (and transposed A) fragments of the weights straight
//    from L2; fp32 is a scalar-FMA version of the same two kernels, slow and
//    right (fp32 inputs would drop to TF32 on the tensor cores);
//  * ragged rows are zero-filled in shared memory: x = 0 and g = 0 give
//    da = 0 and add nothing anywhere; dx rows >= N are not stored.

#include <mma.h>

#include "mlp_block_common.cuh"

namespace {

using namespace mlp;
using namespace nvcuda;
typedef __nv_bfloat16 bf16;

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> AccFrag;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
    ARow;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>
    ACol;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
    BRow;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
    BCol;

constexpr int BR = 32;        // rows per tile
constexpr int HC = 64;        // hidden columns per chunk in mlp_bwd_dx
constexpr int LDA = HC + 4;   // fp32 chunk pitch
constexpr int LDD = HC + 8;   // bf16 chunk pitch
constexpr int HW = 16;        // hidden columns per block in mlp_bwd_dw
constexpr int LDP = HW + 4;   // fp32 pitch of its partial tiles
constexpr int LDH = HW + 8;   // bf16 pitch of its ga and da tiles

size_t smem_dx_bf16(int D) {
  return (size_t)2 * BR * (D + 8) * 2 + (size_t)2 * BR * LDA * 4 +
         (size_t)BR * LDD * 2;
}

__global__ void __launch_bounds__(kThreads, 1)
mlp_bwd_dx_bf16(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                const float* __restrict__ b1, const bf16* __restrict__ w2,
                const bf16* __restrict__ g, bf16* __restrict__ dx,
                long long N, int D, int H) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int LDX = D + 8;
  bf16* Xs = reinterpret_cast<bf16*>(smem);
  bf16* Gt = Xs + BR * LDX;
  float* As = reinterpret_cast<float*>(Gt + BR * LDX);
  float* DGs = As + BR * LDA;
  bf16* DAs = reinterpret_cast<bf16*>(DGs + BR * LDA);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const long long row0 = (long long)blockIdx.x * BR;
  const int nfrag = D / 16;

  load_rows<bf16, BR>(Xs, LDX, x, row0, N, D);
  load_rows<bf16, BR>(Gt, LDX, g, row0, N, D);
  AccFrag acc[2][kMaxFrags];
#pragma unroll
  for (int i = 0; i < kMaxFrags; ++i) {
    wmma::fill_fragment(acc[0][i], 0.f);
    wmma::fill_fragment(acc[1][i], 0.f);
  }
  __syncthreads();

  const int rf = warp & 1;    // this warp's fragment of a and of dga
  const int cf = warp >> 1;

  for (int h0 = 0; h0 < H; h0 += HC) {
    const int hc = min(HC, H - h0);
    if (cf * 16 < hc) {
      AccFrag pa, pd;
      wmma::fill_fragment(pa, 0.f);
      wmma::fill_fragment(pd, 0.f);
      const bf16* w1p = w1 + h0 + cf * 16;                    // rows k
      const bf16* w2p = w2 + (long long)(h0 + cf * 16) * D;   // columns k
#pragma unroll 4
      for (int k = 0; k < nfrag; ++k) {
        ARow xf, gf;
        BRow w1f;
        BCol w2f;
        wmma::load_matrix_sync(xf, Xs + rf * 16 * LDX + k * 16, LDX);
        wmma::load_matrix_sync(w1f, w1p + (long long)k * 16 * H, H);
        wmma::mma_sync(pa, xf, w1f, pa);
        wmma::load_matrix_sync(gf, Gt + rf * 16 * LDX + k * 16, LDX);
        wmma::load_matrix_sync(w2f, w2p + k * 16, D);
        wmma::mma_sync(pd, gf, w2f, pd);
      }
      wmma::store_matrix_sync(As + rf * 16 * LDA + cf * 16, pa, LDA,
                              wmma::mem_row_major);
      wmma::store_matrix_sync(DGs + rf * 16 * LDA + cf * 16, pd, LDA,
                              wmma::mem_row_major);
    }
    __syncthreads();
    for (int i = tid; i < BR * hc; i += kThreads) {
      const int r = i / hc, c = i % hc;
      const float a = As[r * LDA + c] + b1[h0 + c];
      DAs[r * LDD + c] = __float2bfloat16(DGs[r * LDA + c] * gelu_grad(a));
    }
    __syncthreads();
    // dx += da W1[:, h0 : h0 + hc]^T
    for (int kk = 0; kk < hc / 16; ++kk) {
      ARow d0, d1;
      wmma::load_matrix_sync(d0, DAs + kk * 16, LDD);
      wmma::load_matrix_sync(d1, DAs + 16 * LDD + kk * 16, LDD);
      const bf16* wcol = w1 + h0 + kk * 16;
#pragma unroll
      for (int i = 0; i < kMaxFrags; ++i) {
        const int nf = warp + kWarps * i;
        if (nf < nfrag) {
          BCol wf;
          wmma::load_matrix_sync(wf, wcol + (long long)nf * 16 * H, H);
          wmma::mma_sync(acc[0][i], d0, wf, acc[0][i]);
          wmma::mma_sync(acc[1][i], d1, wf, acc[1][i]);
        }
      }
    }
  }

  // dx rounded to bf16, each fragment through a 16 x 16 fp32 patch of As
  float* patch = As + warp * 256;
  const int pr = lane >> 1, pc = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < kMaxFrags; ++i) {
    const int nf = warp + kWarps * i;
    if (nf < nfrag) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        wmma::store_matrix_sync(patch, acc[h][i], 16, wmma::mem_row_major);
        __syncwarp();
        const long long r = row0 + h * 16 + pr;
        if (r < N) {
          uint4 packed;
          __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            p2[j] = __floats2bfloat162_rn(patch[pr * 16 + pc + 2 * j],
                                          patch[pr * 16 + pc + 2 * j + 1]);
          }
          *reinterpret_cast<uint4*>(dx + r * D + nf * 16 + pc) = packed;
        }
        __syncwarp();
      }
    }
  }
}

size_t smem_dw_bf16(int D) {
  return (size_t)2 * BR * (D + 8) * 2 + (size_t)4 * BR * LDP * 4 +
         (size_t)2 * BR * LDH * 2;
}

// Columns of db2 that block b of `grid` owns: b + q * grid for q = thread,
// thread + 256, thread + 512 (D <= 768 leaves no column without an owner).
constexpr int kDb2PerThread = kMaxD / kThreads;

__global__ void __launch_bounds__(kThreads, 1)
mlp_bwd_dw_bf16(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                const float* __restrict__ b1, const bf16* __restrict__ w2,
                const bf16* __restrict__ g, float* __restrict__ dw1,
                float* __restrict__ db1, float* __restrict__ dw2,
                float* __restrict__ db2, long long N, int D, int H) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int LDX = D + 8;
  bf16* Xs = reinterpret_cast<bf16*>(smem);
  bf16* Gt = Xs + BR * LDX;
  float* Ps = reinterpret_cast<float*>(Gt + BR * LDX);  // [4][BR][LDP]
  bf16* GAs = reinterpret_cast<bf16*>(Ps + 4 * BR * LDP);
  bf16* DAs = GAs + BR * LDH;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int h0 = blockIdx.x * HW;
  const int nfrag = D / 16;

  AccFrag acc1[kMaxFrags], acc2[kMaxFrags];
#pragma unroll
  for (int i = 0; i < kMaxFrags; ++i) {
    wmma::fill_fragment(acc1[i], 0.f);
    wmma::fill_fragment(acc2[i], 0.f);
  }
  float s_b1 = 0.f;
  float s_b2[kDb2PerThread];
#pragma unroll
  for (int j = 0; j < kDb2PerThread; ++j) s_b2[j] = 0.f;

  // x W1 and g W2^T for the 16 columns: warp = (which, row half, depth half)
  const int which = warp >> 2, rf = (warp >> 1) & 1, kh = warp & 1;
  const int k_lo = kh == 0 ? 0 : nfrag / 2;
  const int k_hi = kh == 0 ? nfrag / 2 : nfrag;
  float* Pw = Ps + (which * 2 + kh) * BR * LDP + rf * 16 * LDP;

  for (long long row0 = 0; row0 < N; row0 += BR) {
    __syncthreads();   // the previous tile's products are done with Xs, Gt
    load_rows<bf16, BR>(Xs, LDX, x, row0, N, D);
    load_rows<bf16, BR>(Gt, LDX, g, row0, N, D);
    __syncthreads();
    {
      AccFrag p;
      wmma::fill_fragment(p, 0.f);
      if (which == 0) {
#pragma unroll 4
        for (int k = k_lo; k < k_hi; ++k) {
          ARow xf;
          BRow wf;
          wmma::load_matrix_sync(xf, Xs + rf * 16 * LDX + k * 16, LDX);
          wmma::load_matrix_sync(wf, w1 + (long long)k * 16 * H + h0, H);
          wmma::mma_sync(p, xf, wf, p);
        }
      } else {
#pragma unroll 4
        for (int k = k_lo; k < k_hi; ++k) {
          ARow gf;
          BCol wf;
          wmma::load_matrix_sync(gf, Gt + rf * 16 * LDX + k * 16, LDX);
          wmma::load_matrix_sync(wf, w2 + (long long)h0 * D + k * 16, D);
          wmma::mma_sync(p, gf, wf, p);
        }
      }
      wmma::store_matrix_sync(Pw, p, LDP, wmma::mem_row_major);
    }
    __syncthreads();
    for (int i = tid; i < BR * HW; i += kThreads) {
      const int r = i / HW, c = i % HW;
      const float a = Ps[r * LDP + c] + Ps[BR * LDP + r * LDP + c] + b1[h0 + c];
      const float dga =
          Ps[2 * BR * LDP + r * LDP + c] + Ps[3 * BR * LDP + r * LDP + c];
      GAs[r * LDH + c] = __float2bfloat16(gelu(a));
      DAs[r * LDH + c] = __float2bfloat16(dga * gelu_grad(a));
    }
    __syncthreads();
    if (tid < HW) {
      float s = 0.f;
#pragma unroll 8
      for (int r = 0; r < BR; ++r) s += __bfloat162float(DAs[r * LDH + tid]);
      s_b1 += s;
    }
#pragma unroll
    for (int j = 0; j < kDb2PerThread; ++j) {
      const long long c =
          blockIdx.x + (long long)(tid + kThreads * j) * gridDim.x;
      if (c < D) {
        float s = 0.f;
#pragma unroll 8
        for (int r = 0; r < BR; ++r) s += __bfloat162float(Gt[r * LDX + c]);
        s_b2[j] += s;
      }
    }
    // dW1[:, chunk] += x^T da;  dW2[chunk, :] += ga^T g   (depth: 32 rows)
#pragma unroll
    for (int kk = 0; kk < BR / 16; ++kk) {
      BRow daf;
      ACol gaf;
      wmma::load_matrix_sync(daf, DAs + kk * 16 * LDH, LDH);
      wmma::load_matrix_sync(gaf, GAs + kk * 16 * LDH, LDH);
#pragma unroll
      for (int i = 0; i < kMaxFrags; ++i) {
        const int f = warp + kWarps * i;
        if (f < nfrag) {
          ACol xt;
          BRow gt;
          wmma::load_matrix_sync(xt, Xs + kk * 16 * LDX + f * 16, LDX);
          wmma::mma_sync(acc1[i], xt, daf, acc1[i]);
          wmma::load_matrix_sync(gt, Gt + kk * 16 * LDX + f * 16, LDX);
          wmma::mma_sync(acc2[i], gaf, gt, acc2[i]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kMaxFrags; ++i) {
    const int f = warp + kWarps * i;
    if (f < nfrag) {
      wmma::store_matrix_sync(dw1 + (long long)f * 16 * H + h0, acc1[i], H,
                              wmma::mem_row_major);
      wmma::store_matrix_sync(dw2 + (long long)h0 * D + f * 16, acc2[i], D,
                              wmma::mem_row_major);
    }
  }
  if (tid < HW) db1[h0 + tid] = s_b1;
#pragma unroll
  for (int j = 0; j < kDb2PerThread; ++j) {
    const long long c =
        blockIdx.x + (long long)(tid + kThreads * j) * gridDim.x;
    if (c < D) db2[c] = s_b2[j];
  }
}

// ---- fp32: the same two kernels with scalar FMAs ------------------------

constexpr int FR = 16;   // rows per tile in mlp_bwd_dx_f32
constexpr int FC = 64;   // hidden columns per chunk there

size_t smem_dx_f32(int D) { return (size_t)(3 * FR * D + 2 * FR * FC) * 4; }

__global__ void __launch_bounds__(kThreads)
mlp_bwd_dx_f32(const float* __restrict__ x, const float* __restrict__ w1,
               const float* __restrict__ b1, const float* __restrict__ w2,
               const float* __restrict__ g, float* __restrict__ dx,
               long long N, int D, int H) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* Xs = reinterpret_cast<float*>(smem);
  float* Gt = Xs + FR * D;
  float* Os = Gt + FR * D;
  float* DAs = Os + FR * D;       // [FR][FC]
  const int tid = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * FR;

  load_rows<float, FR>(Xs, D, x, row0, N, D);
  load_rows<float, FR>(Gt, D, g, row0, N, D);
  for (int i = tid; i < FR * D; i += kThreads) Os[i] = 0.f;
  __syncthreads();

  const int h = tid % FC, rg = tid / FC;
  for (int h0 = 0; h0 < H; h0 += FC) {
    const int hc = min(FC, H - h0);
    if (h < hc) {
      float a[4] = {0.f, 0.f, 0.f, 0.f}, dg[4] = {0.f, 0.f, 0.f, 0.f};
      const float* w1p = w1 + h0 + h;
      const float* w2p = w2 + (long long)(h0 + h) * D;
      for (int k = 0; k < D; ++k) {
        const float u = w1p[(long long)k * H];
        const float v = w2p[k];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = fmaf(Xs[(rg * 4 + i) * D + k], u, a[i]);
          dg[i] = fmaf(Gt[(rg * 4 + i) * D + k], v, dg[i]);
        }
      }
      const float b = b1[h0 + h];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        DAs[(rg * 4 + i) * FC + h] = dg[i] * gelu_grad(a[i] + b);
      }
    }
    __syncthreads();
    for (int d = tid; d < D; d += kThreads) {
      float o[FR];
#pragma unroll
      for (int r = 0; r < FR; ++r) o[r] = Os[r * D + d];
      const float* wp = w1 + (long long)d * H + h0;
      for (int j = 0; j < hc; ++j) {
        const float w = wp[j];
#pragma unroll
        for (int r = 0; r < FR; ++r) o[r] = fmaf(DAs[r * FC + j], w, o[r]);
      }
#pragma unroll
      for (int r = 0; r < FR; ++r) Os[r * D + d] = o[r];
    }
    __syncthreads();
  }
  for (int i = tid; i < FR * D; i += kThreads) {
    const int r = i / D, d = i % D;
    if (row0 + r < N) dx[(row0 + r) * D + d] = Os[i];
  }
}

size_t smem_dw_f32(int D) { return (size_t)(2 * BR * D + 2 * BR * HW) * 4; }

__global__ void __launch_bounds__(kThreads, 1)
mlp_bwd_dw_f32(const float* __restrict__ x, const float* __restrict__ w1,
               const float* __restrict__ b1, const float* __restrict__ w2,
               const float* __restrict__ g, float* __restrict__ dw1,
               float* __restrict__ db1, float* __restrict__ dw2,
               float* __restrict__ db2, long long N, int D, int H) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* Xs = reinterpret_cast<float*>(smem);
  float* Gt = Xs + BR * D;
  float* GAs = Gt + BR * D;       // [BR][HW]
  float* DAs = GAs + BR * HW;
  const int tid = threadIdx.x;
  const int h0 = blockIdx.x * HW;

  // this thread's columns d = tid, tid + 256, tid + 512 of dW1[:, chunk]
  // and dW2[chunk, :]
  float acc1[kDb2PerThread][HW], acc2[kDb2PerThread][HW];
#pragma unroll
  for (int j = 0; j < kDb2PerThread; ++j) {
#pragma unroll
    for (int c = 0; c < HW; ++c) acc1[j][c] = acc2[j][c] = 0.f;
  }
  float s_b1 = 0.f;
  float s_b2[kDb2PerThread];
#pragma unroll
  for (int j = 0; j < kDb2PerThread; ++j) s_b2[j] = 0.f;

  const int h = tid % HW, ra = tid / HW;   // rows ra and ra + 16 of a tile
  const float* w1p = w1 + h0 + h;
  const float* w2p = w2 + (long long)(h0 + h) * D;
  const float bias = b1[h0 + h];

  for (long long row0 = 0; row0 < N; row0 += BR) {
    __syncthreads();
    load_rows<float, BR>(Xs, D, x, row0, N, D);
    load_rows<float, BR>(Gt, D, g, row0, N, D);
    __syncthreads();
    {
      float a0 = 0.f, a1 = 0.f, d0 = 0.f, d1 = 0.f;
      for (int k = 0; k < D; ++k) {
        const float u = w1p[(long long)k * H];
        const float v = w2p[k];
        a0 = fmaf(Xs[ra * D + k], u, a0);
        a1 = fmaf(Xs[(ra + 16) * D + k], u, a1);
        d0 = fmaf(Gt[ra * D + k], v, d0);
        d1 = fmaf(Gt[(ra + 16) * D + k], v, d1);
      }
      a0 += bias;
      a1 += bias;
      GAs[ra * HW + h] = gelu(a0);
      GAs[(ra + 16) * HW + h] = gelu(a1);
      DAs[ra * HW + h] = d0 * gelu_grad(a0);
      DAs[(ra + 16) * HW + h] = d1 * gelu_grad(a1);
    }
    __syncthreads();
    if (tid < HW) {
      float s = 0.f;
#pragma unroll 8
      for (int r = 0; r < BR; ++r) s += DAs[r * HW + tid];
      s_b1 += s;
    }
#pragma unroll
    for (int j = 0; j < kDb2PerThread; ++j) {
      const long long c =
          blockIdx.x + (long long)(tid + kThreads * j) * gridDim.x;
      if (c < D) {
        float s = 0.f;
#pragma unroll 8
        for (int r = 0; r < BR; ++r) s += Gt[r * D + c];
        s_b2[j] += s;
      }
    }
#pragma unroll
    for (int j = 0; j < kDb2PerThread; ++j) {
      const int d = tid + kThreads * j;
      if (d < D) {
        for (int r = 0; r < BR; ++r) {
          const float xv = Xs[r * D + d], gv = Gt[r * D + d];
#pragma unroll
          for (int c = 0; c < HW; ++c) {
            acc1[j][c] = fmaf(xv, DAs[r * HW + c], acc1[j][c]);
            acc2[j][c] = fmaf(GAs[r * HW + c], gv, acc2[j][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kDb2PerThread; ++j) {
    const int d = tid + kThreads * j;
    if (d < D) {
#pragma unroll
      for (int c = 0; c < HW; ++c) {
        dw1[(long long)d * H + h0 + c] = acc1[j][c];
        dw2[(long long)(h0 + c) * D + d] = acc2[j][c];
      }
    }
  }
  if (tid < HW) db1[h0 + tid] = s_b1;
#pragma unroll
  for (int j = 0; j < kDb2PerThread; ++j) {
    const long long c =
        blockIdx.x + (long long)(tid + kThreads * j) * gridDim.x;
    if (c < D) db2[c] = s_b2[j];
  }
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, typename KDx, typename KDw>
int launch(KDx kdx, size_t smem_dx, int rows_dx, KDw kdw, size_t smem_dw,
           const void* x, const void* w1, const float* b1, const void* w2,
           const void* g, void* dx, float* dw1, float* db1, float* dw2,
           float* db2, long long N, int D, int H, cudaStream_t st) {
  const long long blocks = (N + rows_dx - 1) / rows_dx;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  int rc = set_smem(kdx, smem_dx);
  if (rc != 0) return rc;
  rc = set_smem(kdw, smem_dw);
  if (rc != 0) return rc;
  const T* xp = static_cast<const T*>(x);
  const T* w1p = static_cast<const T*>(w1);
  const T* w2p = static_cast<const T*>(w2);
  const T* gp = static_cast<const T*>(g);
  kdx<<<(unsigned)blocks, kThreads, smem_dx, st>>>(
      xp, w1p, b1, w2p, gp, static_cast<T*>(dx), N, D, H);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kdw<<<H / HW, kThreads, smem_dw, st>>>(xp, w1p, b1, w2p, gp, dw1, db1, dw2,
                                         db2, N, D, H);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches both kernels on `stream` and returns cudaGetLastError() (0 on
// success). x, g, dx: [N, D]; w1: [D, H]; w2: [H, D], all contiguous, one
// type (is_bf16: 1 bfloat16, 0 float32) and 32-byte aligned; b1 fp32 [H];
// dw1 [D, H], db1 [H], dw2 [H, D], db2 [D] fp32, each written once. D and H
// multiples of 16, D <= 768; otherwise cudaErrorInvalidValue.
int pose3d_mlp_block_bwd(const void* x, const void* w1, const void* b1,
                         const void* w2, const void* g, void* dx, void* dw1,
                         void* db1, void* dw2, void* db2, int is_bf16,
                         long long N, int D, int H, void* stream) {
  if (N < 1 || D < 16 || H < 16 || D % 16 != 0 || H % 16 != 0 || D > kMaxD)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* fb1 = static_cast<const float*>(b1);
  float* f1 = static_cast<float*>(dw1);
  float* f2 = static_cast<float*>(db1);
  float* f3 = static_cast<float*>(dw2);
  float* f4 = static_cast<float*>(db2);
  if (is_bf16) {
    return launch<bf16>(mlp_bwd_dx_bf16, smem_dx_bf16(D), BR, mlp_bwd_dw_bf16,
                        smem_dw_bf16(D), x, w1, fb1, w2, g, dx, f1, f2, f3,
                        f4, N, D, H, st);
  }
  return launch<float>(mlp_bwd_dx_f32, smem_dx_f32(D), FR, mlp_bwd_dw_f32,
                       smem_dw_f32(D), x, w1, fb1, w2, g, dx, f1, f2, f3, f4,
                       N, D, H, st);
}

const char* pose3d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
