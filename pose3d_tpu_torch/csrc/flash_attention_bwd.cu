// Flash-attention backward for Hopper (sm_90a).
//
// Replaces pose3d_tpu/ops/pallas/flash_attention.py::_attn_bwd_kernel
// (launched by pl.pallas_call in _bwd_impl). Given q, k, v, the forward's o
// and fp32 row lse, and the output gradient dO, per (batch, head):
//   delta = rowsum(dO * O)                      (fp32, [Tq])
//   P     = exp(scale * Q K^T - lse)            (columns >= Tk masked)
//   dV    = P^T dO
//   dS    = P * (dO V^T - delta)
//   dQ    = dS K * scale,   dK = dS^T Q * scale
// with scale = 1/sqrt(D). As in the TPU kernel, P is cast to dO's dtype
// before dV and dS to q's dtype before dQ and dK; products accumulate in
// fp32.
//
// What bounds it on this card. Five [Tq, Tk] x D products per (batch, head)
// (S, dP, dV, dK, dQ): 2*5*Tq*Tk*D FLOPs, about 130 GFLOP per image over the
// full-width lifter's 20 attentions, against a few MB of q/k/v/o/dO. So it
// is compute-bound, and the [Tq, Tk] matrices P and dS are what must stay
// out of device memory. The TPU kernel held them whole in VMEM (up to
// 1152^2 fp32 per head, three live); a Hopper block has 227 KB of shared
// memory, so the work is tiled FlashAttention-2 style:
//
//  * prologue: one thread per (b, t, h) row computes delta in fp32 and
//    zeroes that row of the fp32 dQ accumulator;
//  * main: one block per (64-row K/V tile, head, batch), 128 threads =
//    4 warps. The block keeps its K and V tiles in shared memory and its
//    dK and dV sums in registers (WMMA accumulator fragments: each warp owns
//    16 key rows), and walks all Q tiles of 64 rows. Per Q tile each warp
//    recomputes S and dP for 16 query rows, forms P and dS, adds dS K into
//    the dQ accumulator, and after one block barrier adds P^T dO and
//    dS^T Q for its key rows;
//  * dQ crosses K/V tiles, i.e. blocks, so it is summed with fp32 atomicAdd
//    into a [B, Tq, H, D] scratch buffer (for bf16, an epilogue casts it).
//    A second pass over Q tiles would avoid the atomics but recompute S and
//    dP (two of the five products); at Tk = 1025 each dQ element takes 17
//    atomic adds, cheap next to the 2*64*D FLOPs each of them carries.
//    The sum order of the atomics varies from run to run;
//  * bf16: all five products on the tensor cores through WMMA m16n16k16
//    with fp32 accumulation (D = 48 is 3 x 16); P^T and dS^T are read as
//    column-major fragments of the row-major P and dS tiles, no transpose;
//  * fp32: scalar FMA (WMMA would drop fp32 inputs to TF32); each thread
//    pair owns one query row for S/dP/dQ and one key row for dK/dV;
//  * q, k, v, o, dO are read in place from [B, T, H, D] through their
//    strides; ragged Q and K edges are zero-filled in shared memory, and
//    P and dS are forced to 0 outside [Tq, Tk].
//
// Simple first: no wgmma, TMA or pipelining of the tile loads yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

namespace {

constexpr int BQ = 64;   // query rows per inner tile
constexpr int BK = 64;   // key/value rows per block
constexpr int NT = 128;  // threads per block

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* g;      // dO
  const float* lse;   // [B, H, Tq]
  float* delta;       // [B, H, Tq] scratch
  float* dq_acc;      // [B, Tq, H, D] fp32 scratch (the dq output for fp32)
  void* dq;           // [B, Tq, H, D] contiguous, input dtype
  void* dk;           // [B, Tk, H, D] contiguous
  void* dv;           // [B, Tk, H, D] contiguous
  int B, Tq, Tk, H;
  float scale;
  // element strides of batch, token and head (the last dim is contiguous)
  long long qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh;
  long long osb, ost, osh, gsb, gst, gsh;
};

__device__ __forceinline__ void unpack8(const uint4& u, float* f,
                                        const __nv_bfloat16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

__device__ __forceinline__ void unpack8(const uint4& u, float* f,
                                        const float*) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

// delta[b, h, t] = sum_d dO * O in fp32, and dq_acc[b, t, h, :] = 0.
template <typename T, int D>
__global__ void bwd_prologue(Args a) {
  constexpr int VEC = 16 / sizeof(T);
  const long long rows = (long long)a.B * a.Tq * a.H;
  for (long long row = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       row < rows; row += (long long)gridDim.x * blockDim.x) {
    const int h = (int)(row % a.H);
    const long long bt = row / a.H;
    const int t = (int)(bt % a.Tq);
    const int b = (int)(bt / a.Tq);
    const T* o = static_cast<const T*>(a.o) + b * a.osb + t * a.ost + h * a.osh;
    const T* g = static_cast<const T*>(a.g) + b * a.gsb + t * a.gst + h * a.gsh;
    float acc = 0.f;
#pragma unroll
    for (int d = 0; d < D; d += VEC) {
      float fo[8], fg[8];
      unpack8(*reinterpret_cast<const uint4*>(o + d), fo, o);
      unpack8(*reinterpret_cast<const uint4*>(g + d), fg, g);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc = fmaf(fg[i], fo[i], acc);
    }
    a.delta[((long long)b * a.H + h) * a.Tq + t] = acc;
    float4* dq = reinterpret_cast<float4*>(a.dq_acc + row * D);
#pragma unroll
    for (int d = 0; d < D / 4; ++d) dq[d] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

__global__ void cast_to_bf16(const float* src, __nv_bfloat16* dst,
                             long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    dst[i] = __float2bfloat16(src[i]);
  }
}

// Copy rows [row0, row0 + 64) of a [T, D] slice (token stride st) into a
// shared tile with row pitch LD, 16 bytes at a time; rows >= T become 0.
template <typename T, int D, int LD>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long st,
                                          int row0, int nrows) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = D / VEC;
  for (int i = threadIdx.x; i < 64 * VPR; i += NT) {
    const int r = i / VPR;
    const int c = (i % VPR) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    const int t = row0 + r;
    if (t < nrows) {
      val = *reinterpret_cast<const uint4*>(src + (long long)t * st + c);
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// 64 query rows of lse and delta for the tile at q0 (0 past Tq).
__device__ __forceinline__ void load_rows(float* lse_s, float* delta_s,
                                          const float* lse, const float* delta,
                                          int q0, int Tq) {
  if (threadIdx.x < BQ) {
    const int t = q0 + threadIdx.x;
    lse_s[threadIdx.x] = t < Tq ? lse[t] : 0.f;
    delta_s[threadIdx.x] = t < Tq ? delta[t] : 0.f;
  }
}

template <int D>
struct Bf16Layout {
  static constexpr int LDH = D + 8;                  // bf16 tile pitch
  static constexpr int LDS = (D > BK ? D : BK) + 4;  // fp32 S / dP / staging
  static constexpr int LDP = BK + 8;                 // bf16 P / dS pitch
  static constexpr size_t bytes =
      (size_t)4 * 64 * LDH * 2      // K, V, Q, dO tiles
      + (size_t)2 * BQ * LDS * 4    // S (also dQ/dK/dV staging), dP
      + (size_t)2 * BQ * LDP * 2    // P, dS
      + (size_t)2 * BQ * 4;         // lse, delta
};

template <int D>
__global__ void __launch_bounds__(NT) attn_bwd_bf16(Args a) {
  using namespace nvcuda;
  typedef __nv_bfloat16 bf16;
  typedef Bf16Layout<D> L;
  constexpr int LDH = L::LDH;
  constexpr int LDS = L::LDS;
  constexpr int LDP = L::LDP;
  constexpr int KD = D / 16;

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + BK * LDH;
  bf16* Qs = Vs + BK * LDH;
  bf16* Gs = Qs + BQ * LDH;
  float* Ss = reinterpret_cast<float*>(Gs + BQ * LDH);
  float* dPs = Ss + BQ * LDS;
  bf16* Ps = reinterpret_cast<bf16*>(dPs + BQ * LDS);
  bf16* dSs = Ps + BQ * LDP;
  float* lse_s = reinterpret_cast<float*>(dSs + BQ * LDP);
  float* delta_s = lse_s + BQ;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int k0 = blockIdx.x * BK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.qsb + h * a.qsh;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.ksb + h * a.ksh;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.vsb + h * a.vsh;
  const bf16* gb = static_cast<const bf16*>(a.g) + b * a.gsb + h * a.gsh;
  const long long bh = (long long)b * a.H + h;
  const float* lse = a.lse + bh * a.Tq;
  const float* delta = a.delta + bh * a.Tq;
  const long long row_stride = (long long)a.H * D;  // dq/dk/dv token stride
  float* dqb = a.dq_acc + (long long)b * a.Tq * row_stride + h * D;

  load_tile<bf16, D, LDH>(Ks, kb, a.kst, k0, a.Tk);
  load_tile<bf16, D, LDH>(Vs, vb, a.vst, k0, a.Tk);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dk_f[KD], dv_f[KD];
#pragma unroll
  for (int n = 0; n < KD; ++n) {
    wmma::fill_fragment(dk_f[n], 0.f);
    wmma::fill_fragment(dv_f[n], 0.f);
  }

  float* Sw = Ss + warp * 16 * LDS;
  float* dPw = dPs + warp * 16 * LDS;
  bf16* Pw = Ps + warp * 16 * LDP;
  bf16* dSw = dSs + warp * 16 * LDP;
  const int r = lane >> 1;     // row of this warp's 16 owned by the lane pair
  const int half = lane & 1;   // which 32 of the 64 columns this lane owns

  for (int q0 = 0; q0 < a.Tq; q0 += BQ) {
    __syncthreads();  // every warp is done with the previous Q tile
    load_tile<bf16, D, LDH>(Qs, qb, a.qst, q0, a.Tq);
    load_tile<bf16, D, LDH>(Gs, gb, a.gst, q0, a.Tq);
    load_rows(lse_s, delta_s, lse, delta, q0, a.Tq);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this warp's 16 query rows.
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf, pf;
      wmma::fill_fragment(sf, 0.f);
      wmma::fill_fragment(pf, 0.f);
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qf, gf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf, vf;
        wmma::load_matrix_sync(qf, Qs + warp * 16 * LDH + kk * 16, LDH);
        wmma::load_matrix_sync(gf, Gs + warp * 16 * LDH + kk * 16, LDH);
        wmma::load_matrix_sync(kf, Ks + n * 16 * LDH + kk * 16, LDH);
        wmma::load_matrix_sync(vf, Vs + n * 16 * LDH + kk * 16, LDH);
        wmma::mma_sync(sf, qf, kf, sf);
        wmma::mma_sync(pf, gf, vf, pf);
      }
      wmma::store_matrix_sync(Sw + n * 16, sf, LDS, wmma::mem_row_major);
      wmma::store_matrix_sync(dPw + n * 16, pf, LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // P = exp(scale*S - lse) and dS = P (dP - delta), both rounded to bf16;
    // 0 outside [Tq, Tk]. The lane pair (2r, 2r+1) shares row r.
    {
      const int row = warp * 16 + r;
      const bool row_ok = q0 + row < a.Tq;
      const float l = lse_s[row];
      const float dl = delta_s[row];
#pragma unroll 8
      for (int c = 0; c < 32; ++c) {
        const int col = half * 32 + c;
        float p = 0.f;
        float ds = 0.f;
        if (row_ok && k0 + col < a.Tk) {
          p = expf(Sw[r * LDS + col] * a.scale - l);
          ds = p * (dPw[r * LDS + col] - dl);
        }
        Pw[r * LDP + col] = __float2bfloat16(p);
        dSw[r * LDP + col] = __float2bfloat16(ds);
      }
    }
    __syncwarp();

    // dQ for this warp's 16 query rows: dS K, staged in S's rows (free now)
    // and added into the fp32 accumulator with the scale.
#pragma unroll
    for (int n = 0; n < KD; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> qacc;
      wmma::fill_fragment(qacc, 0.f);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> sf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> kf;
        wmma::load_matrix_sync(sf, dSw + kk * 16, LDP);
        wmma::load_matrix_sync(kf, Ks + kk * 16 * LDH + n * 16, LDH);
        wmma::mma_sync(qacc, sf, kf, qacc);
      }
      wmma::store_matrix_sync(Sw + n * 16, qacc, LDS, wmma::mem_row_major);
    }
    __syncwarp();
    for (int i = lane; i < 16 * D; i += 32) {
      const int rr = i / D;
      const int c = i % D;
      const int t = q0 + warp * 16 + rr;
      if (t < a.Tq) {
        atomicAdd(dqb + t * row_stride + c, Sw[rr * LDS + c] * a.scale);
      }
    }
    __syncthreads();  // every warp's rows of P and dS are written

    // dV += P^T dO and dK += dS^T Q for this warp's 16 key rows; P^T and
    // dS^T are the row-major P and dS tiles read column-major.
#pragma unroll
    for (int n = 0; n < KD; ++n) {
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> pt, st;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> gf, qf;
        wmma::load_matrix_sync(pt, Ps + kk * 16 * LDP + warp * 16, LDP);
        wmma::load_matrix_sync(st, dSs + kk * 16 * LDP + warp * 16, LDP);
        wmma::load_matrix_sync(gf, Gs + kk * 16 * LDH + n * 16, LDH);
        wmma::load_matrix_sync(qf, Qs + kk * 16 * LDH + n * 16, LDH);
        wmma::mma_sync(dv_f[n], pt, gf, dv_f[n]);
        wmma::mma_sync(dk_f[n], st, qf, dk_f[n]);
      }
    }
  }

  // Write dV, then dK * scale, for the valid key rows of this warp, staged
  // through the warp's own rows of S.
  bf16* dvb = static_cast<bf16*>(a.dv) + (long long)b * a.Tk * row_stride + h * D;
  bf16* dkb = static_cast<bf16*>(a.dk) + (long long)b * a.Tk * row_stride + h * D;
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    __syncwarp();
#pragma unroll
    for (int n = 0; n < KD; ++n) {
      wmma::store_matrix_sync(Sw + n * 16, pass == 0 ? dv_f[n] : dk_f[n], LDS,
                              wmma::mem_row_major);
    }
    __syncwarp();
    bf16* out = pass == 0 ? dvb : dkb;
    const float mul = pass == 0 ? 1.f : a.scale;
    for (int i = lane; i < 16 * D; i += 32) {
      const int rr = i / D;
      const int c = i % D;
      const int t = k0 + warp * 16 + rr;
      if (t < a.Tk) out[t * row_stride + c] = __float2bfloat16(Sw[rr * LDS + c] * mul);
    }
  }
}

template <int D>
struct F32Layout {
  static constexpr int LDH = D + 4;   // keeps rows 16-byte aligned
  static constexpr int LDP = BK + 1;
  static constexpr size_t bytes =
      (size_t)4 * 64 * LDH * 4      // K, V, Q, dO tiles
      + (size_t)2 * BQ * LDP * 4    // P, dS
      + (size_t)2 * BQ * 4;         // lse, delta
};

template <int D>
__device__ __forceinline__ float dot_row(const float* x, const float* y) {
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    const float4 a = *reinterpret_cast<const float4*>(x + d);
    const float4 b = *reinterpret_cast<const float4*>(y + d);
    acc = fmaf(a.x, b.x, acc);
    acc = fmaf(a.y, b.y, acc);
    acc = fmaf(a.z, b.z, acc);
    acc = fmaf(a.w, b.w, acc);
  }
  return acc;
}

template <int D>
__global__ void __launch_bounds__(NT) attn_bwd_f32(Args a) {
  typedef F32Layout<D> L;
  constexpr int LDH = L::LDH;
  constexpr int LDP = L::LDP;
  constexpr int DH = D / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + BK * LDH;
  float* Qs = Vs + BK * LDH;
  float* Gs = Qs + BQ * LDH;
  float* Ps = Gs + BQ * LDH;
  float* dSs = Ps + BQ * LDP;
  float* lse_s = dSs + BQ * LDP;
  float* delta_s = lse_s + BQ;

  const int tid = threadIdx.x;
  const int r = tid >> 1;      // query row (S, dP, dQ) and key row (dK, dV)
  const int half = tid & 1;    // which half of the columns this thread owns
  const int k0 = blockIdx.x * BK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const float* qb = static_cast<const float*>(a.q) + b * a.qsb + h * a.qsh;
  const float* kb = static_cast<const float*>(a.k) + b * a.ksb + h * a.ksh;
  const float* vb = static_cast<const float*>(a.v) + b * a.vsb + h * a.vsh;
  const float* gb = static_cast<const float*>(a.g) + b * a.gsb + h * a.gsh;
  const long long bh = (long long)b * a.H + h;
  const float* lse = a.lse + bh * a.Tq;
  const float* delta = a.delta + bh * a.Tq;
  const long long row_stride = (long long)a.H * D;
  float* dqb = a.dq_acc + (long long)b * a.Tq * row_stride + h * D + half * DH;

  load_tile<float, D, LDH>(Ks, kb, a.kst, k0, a.Tk);
  load_tile<float, D, LDH>(Vs, vb, a.vst, k0, a.Tk);

  float dk[DH], dv[DH];
#pragma unroll
  for (int i = 0; i < DH; ++i) {
    dk[i] = 0.f;
    dv[i] = 0.f;
  }

  for (int q0 = 0; q0 < a.Tq; q0 += BQ) {
    __syncthreads();
    load_tile<float, D, LDH>(Qs, qb, a.qst, q0, a.Tq);
    load_tile<float, D, LDH>(Gs, gb, a.gst, q0, a.Tq);
    load_rows(lse_s, delta_s, lse, delta, q0, a.Tq);
    __syncthreads();

    // P and dS for query row r; the pair interleaves columns (j = 2c+half).
    {
      const bool row_ok = q0 + r < a.Tq;
      const float l = lse_s[r];
      const float dl = delta_s[r];
      for (int c = 0; c < BK / 2; ++c) {
        const int j = 2 * c + half;
        float p = 0.f;
        float ds = 0.f;
        if (row_ok && k0 + j < a.Tk) {
          const float s = dot_row<D>(Qs + r * LDH, Ks + j * LDH);
          const float dp = dot_row<D>(Gs + r * LDH, Vs + j * LDH);
          p = expf(s * a.scale - l);
          ds = p * (dp - dl);
        }
        Ps[r * LDP + j] = p;
        dSs[r * LDP + j] = ds;
      }
    }
    __syncthreads();

    // dQ row r (this thread's half of the columns) = dS K * scale.
    if (q0 + r < a.Tq) {
      float dq[DH];
#pragma unroll
      for (int i = 0; i < DH; ++i) dq[i] = 0.f;
      for (int j = 0; j < BK; ++j) {
        const float ds = dSs[r * LDP + j];
        const float* kr = Ks + j * LDH + half * DH;
#pragma unroll
        for (int i = 0; i < DH; ++i) dq[i] = fmaf(ds, kr[i], dq[i]);
      }
      float* out = dqb + (long long)(q0 + r) * row_stride;
#pragma unroll
      for (int i = 0; i < DH; ++i) atomicAdd(out + i, dq[i] * a.scale);
    }

    // dV and dK for key row r: sums over the tile's query rows.
    for (int i = 0; i < BQ; ++i) {
      const float p = Ps[i * LDP + r];
      const float ds = dSs[i * LDP + r];
      const float* gr = Gs + i * LDH + half * DH;
      const float* qr = Qs + i * LDH + half * DH;
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        dv[d] = fmaf(p, gr[d], dv[d]);
        dk[d] = fmaf(ds, qr[d], dk[d]);
      }
    }
  }

  const int t = k0 + r;
  if (t < a.Tk) {
    const long long off = ((long long)b * a.Tk + t) * row_stride + h * D + half * DH;
    float* dvo = static_cast<float*>(a.dv) + off;
    float* dko = static_cast<float*>(a.dk) + off;
#pragma unroll
    for (int i = 0; i < DH; ++i) {
      dvo[i] = dv[i];
      dko[i] = dk[i] * a.scale;
    }
  }
}

int grid_1d(long long n, int threads) {
  const long long blocks = (n + threads - 1) / threads;
  return (int)(blocks < 8192 ? (blocks > 0 ? blocks : 1) : 8192);
}

template <typename Kernel>
int launch_main(Kernel kernel, size_t smem, const Args& a, cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((a.Tk + BK - 1) / BK, a.H, a.B);
  kernel<<<grid, NT, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int D>
int dispatch(bool is_bf16, const Args& a, cudaStream_t st) {
  const long long rows = (long long)a.B * a.Tq * a.H;
  if (is_bf16) {
    bwd_prologue<__nv_bfloat16, D><<<grid_1d(rows, 256), 256, 0, st>>>(a);
  } else {
    bwd_prologue<float, D><<<grid_1d(rows, 256), 256, 0, st>>>(a);
  }
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  rc = is_bf16 ? launch_main(attn_bwd_bf16<D>, Bf16Layout<D>::bytes, a, st)
               : launch_main(attn_bwd_f32<D>, F32Layout<D>::bytes, a, st);
  if (rc != 0 || !is_bf16) return rc;
  const long long n = rows * D;
  cast_to_bf16<<<grid_1d(n, 256), 256, 0, st>>>(
      a.dq_acc, static_cast<__nv_bfloat16*>(a.dq), n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches prologue, main kernel and (bf16) the dQ cast on `stream` and
// returns the first non-zero cudaGetLastError() (0 on success). is_bf16:
// 1 for bfloat16, 0 for float32, where dq_acc must be dq itself. Strides
// are in elements.
int pose3d_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* g, const void* lse, void* delta, void* dq_acc, void* dq,
    void* dk, void* dv, int is_bf16, int B, int Tq, int Tk, int H, int D,
    float scale,
    long long qsb, long long qst, long long qsh,
    long long ksb, long long kst, long long ksh,
    long long vsb, long long vst, long long vsh,
    long long osb, long long ost, long long osh,
    long long gsb, long long gst, long long gsh,
    void* stream) {
  Args a;
  a.q = q; a.k = k; a.v = v; a.o = o; a.g = g;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.dq_acc = static_cast<float*>(dq_acc);
  a.dq = dq; a.dk = dk; a.dv = dv;
  a.B = B; a.Tq = Tq; a.Tk = Tk; a.H = H; a.scale = scale;
  a.qsb = qsb; a.qst = qst; a.qsh = qsh;
  a.ksb = ksb; a.kst = kst; a.ksh = ksh;
  a.vsb = vsb; a.vst = vst; a.vsh = vsh;
  a.osb = osb; a.ost = ost; a.osh = osh;
  a.gsb = gsb; a.gst = gst; a.gsh = gsh;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool bf = is_bf16 != 0;
  switch (D) {
    case 32: return dispatch<32>(bf, a, st);
    case 48: return dispatch<48>(bf, a, st);
    case 64: return dispatch<64>(bf, a, st);
    case 128: return dispatch<128>(bf, a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* pose3d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
