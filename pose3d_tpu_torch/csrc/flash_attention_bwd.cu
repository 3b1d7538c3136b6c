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
// fp32. V, O and dO have depth Dv, which may differ from D (the pairs built
// are listed at the entry point).
//
// What bounds it on this card. Five [Tq, Tk] x depth products per (batch,
// head) (S, dP, dV, dK, dQ): 2*Tq*Tk*(3*D + 2*Dv) FLOPs, about 130 GFLOP per
// image over the full-width lifter's 20 attentions, against a few MB of
// q/k/v/o/dO. So it is compute-bound, and the [Tq, Tk] matrices P and dS
// are what must stay out of device memory. The TPU kernel held them whole
// in VMEM (up to 1152^2 fp32 per head, three live); a Hopper block has 227
// KB of shared memory, so the work is tiled FlashAttention-2 style: one
// block per tile of keys walks all query tiles, keeps its dK and dV sums in
// registers, and adds dQ, which crosses key tiles and so blocks, into an
// fp32 [B, Tq, H, D] scratch with atomics (their order varies from run to
// run, so dq repeats are not bitwise equal; dk, dv are). A second pass over
// query tiles would avoid the atomics but recompute S and dP (two of the
// five products); an epilogue casts the scratch to bf16.
//
// Paths, by shape alone (pose3d_flash_attention_bwd_config reports which):
//  * attn_bwd_wgmma (bf16, D = Dv in {48, 64}): 128 keys a block in two
//    consumer warpgroups of 64, their K and V tiles resident (TMA, one
//    load), and a producer warpgroup whose one thread streams query tiles
//    of 64 rows, Q and dO with their lse and delta, through a ring of TMA
//    stages (4-D maps over the strided views, read in place; lse * log2(e)
//    and delta come interleaved from the prologue, rows past Tq as +inf and
//    0, so their P and dS are 0 with no mask). Per query tile a warpgroup
//    takes S^T = K Q^T and dP^T = V dO^T (wgmma m64n64k16, both operands
//    K-major), forms P^T and dS^T on the accumulator's layout in registers,
//    rounds them to bf16 as A fragments and adds dV += P^T dO and
//    dK += dS^T Q (register A, dO and Q MN-major: the same tiles serve both
//    majors); dS^T also goes to shared memory, and after one named barrier
//    of the two warpgroups dQ = dS K over all 128 keys is one MN-major-A
//    product, split by column halves between the warpgroups (m64n32k16),
//    added to the scratch by a TMA reduction (cp.reduce.async.bulk .add:
//    the fp32 atomics as one bulk operation a [64, 32] tile from shared
//    memory, in place of a float2 atomicAdd a pair from registers; see
//    PERF.md for what each costs). D 48 runs at 64 columns with
//    TMA's zero fill (D has its own map dimension) and three k-steps where
//    D is the reduction. A key row past Tk has zero K and V: its P is kept
//    at most 1 (P = exp2(-|x|), below), so its dS is finite and adds nothing
//    to dQ, and its dK, dV are never stored. Two dS^T buffers in
//    turn let one barrier a tile suffice;
//  * attn_bwd_bf16 (bf16, other pairs): 64 keys and 128 threads a block,
//    WMMA m16n16k16 with fp32 accumulation, Q/dO tiles loaded synchronously,
//    S, dP, P, dS through shared memory, dQ by scalar fp32 atomics (simple
//    first);
//  * attn_bwd_f32 (fp32): scalar FMA (WMMA would drop fp32 inputs to TF32);
//    each thread pair owns one query row for S/dP/dQ and one key row for
//    dK/dV.
// D or Dv in (128, 256] take the (256, 256) instance of the two simple
// paths with 32 keys a block (keys_per_block): at 64 keys the tiles would
// need 287,232 (WMMA) or 299,520 (fp32) bytes of the 232,448 a block has,
// and a warp's dK and dV sums 256 registers a lane. At 32 keys the four
// warps (WMMA) or threads of a key row (fp32: four, not two) split the
// sums' columns: 128 registers a lane; S stays [64, D] wide as the dQ and
// dK/dV staging, and dP narrows to the key tile (187,904 bytes for WMMA,
// 217,088 for fp32).
// A prologue computes delta in fp32 and the dQ scratch is zeroed (in the
// prologue, or by a memset on the wgmma path); ragged query
// and key edges are zero-filled and P and dS forced to 0 outside [Tq, Tk].

#include <math.h>
#include <mma.h>

#include "flash_attention_common.cuh"

namespace {

constexpr int BQ = 64;   // query rows per inner tile
constexpr int NT = 128;  // threads per block

// key/value rows a block of the WMMA and fp32 kernels
constexpr int keys_per_block(int D, int DV) {
  return D > 128 || DV > 128 ? 32 : 64;
}
constexpr float LOG2E = 1.4426950408889634f;

// Path codes that pose3d_flash_attention_bwd_config reports.
constexpr int kPathScalar = 0, kPathWmma = 1, kPathWgmma = 2;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* g;      // dO
  const float* lse;   // [B, H, Tq]
  float* delta;       // scratch: [B, H, Tq], or rows (below) for wgmma
  float* dq_acc;      // [B, Tq, H, D] fp32 scratch (the dq output for fp32)
  void* dq;           // [B, Tq, H, D] contiguous, input dtype
  void* dk;           // [B, Tk, H, D] contiguous
  void* dv;           // [B, Tk, H, Dv] contiguous
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

// rowsum(dO * O) in fp32 over a row of depth DV
template <typename T, int DV>
__device__ __forceinline__ float row_delta(const T* o, const T* g) {
  constexpr int VEC = 16 / sizeof(T);
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < DV; d += VEC) {
    float fo[8], fg[8];
    unpack8(*reinterpret_cast<const uint4*>(o + d), fo, o);
    unpack8(*reinterpret_cast<const uint4*>(g + d), fg, g);
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc = fmaf(fg[i], fo[i], acc);
  }
  return acc;
}

// delta[b, h, t] = sum_d dO * O in fp32, and dq_acc[b, t, h, :] = 0.
template <typename T, int D, int DV>
__global__ void bwd_prologue(Args a) {
  const long long rows = (long long)a.B * a.Tq * a.H;
  for (long long row = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       row < rows; row += (long long)gridDim.x * blockDim.x) {
    const int h = (int)(row % a.H);
    const long long bt = row / a.H;
    const int t = (int)(bt % a.Tq);
    const int b = (int)(bt / a.Tq);
    const T* o = static_cast<const T*>(a.o) + b * a.osb + t * a.ost + h * a.osh;
    const T* g = static_cast<const T*>(a.g) + b * a.gsb + t * a.gst + h * a.gsh;
    a.delta[((long long)b * a.H + h) * a.Tq + t] = row_delta<T, DV>(o, g);
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

// Copy rows [row0, row0 + ROWS) of a [T, D] slice (token stride st) into a
// shared tile with row pitch LD, 16 bytes at a time; rows >= T become 0.
template <typename T, int D, int LD, int ROWS = 64>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long st,
                                          int row0, int nrows) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = D / VEC;
  for (int i = threadIdx.x; i < ROWS * VPR; i += NT) {
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

constexpr int imax(int x, int y) { return x > y ? x : y; }

template <int D, int DV, int BK = keys_per_block(D, DV)>
struct Bf16Layout {
  static constexpr int LDH = D + 8;                  // bf16 K, Q pitch
  static constexpr int LDV = DV + 8;                 // bf16 V, dO pitch
  static constexpr int LDS = imax(imax(D, DV), BK) + 4;  // fp32 S / staging
  static constexpr int LDD = BK + 4;                 // fp32 dP pitch
  static constexpr int LDP = BK + 8;                 // bf16 P / dS pitch
  static constexpr size_t bytes =
      (size_t)(BK + BQ) * LDH * 2   // K, Q tiles
      + (size_t)(BK + BQ) * LDV * 2 // V, dO tiles
      + (size_t)BQ * LDS * 4        // S (also dQ/dK/dV staging)
      + (size_t)BQ * LDD * 4        // dP
      + (size_t)2 * BQ * LDP * 2    // P, dS
      + (size_t)2 * BQ * 4;         // lse, delta
};

template <int D, int DV, int BK>
__global__ void __launch_bounds__(NT) attn_bwd_bf16(Args a) {
  using namespace nvcuda;
  typedef __nv_bfloat16 bf16;
  typedef Bf16Layout<D, DV, BK> L;
  constexpr int LDH = L::LDH;
  constexpr int LDV = L::LDV;
  constexpr int LDS = L::LDS;
  constexpr int LDD = L::LDD;
  constexpr int LDP = L::LDP;
  constexpr int KD = D / 16;
  constexpr int KV = DV / 16;
  // dK, dV: a warp owns 16 key rows (row group wr of WR) and the columns of
  // part wc of WC
  constexpr int WR = BK / 16;
  constexpr int WC = 4 / WR;
  static_assert(KD % WC == 0 && KV % WC == 0, "attn_bwd_bf16: column parts");
  constexpr int KDW = KD / WC, KVW = KV / WC;

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + BK * LDH;
  bf16* Qs = Vs + BK * LDV;
  bf16* Gs = Qs + BQ * LDH;
  float* Ss = reinterpret_cast<float*>(Gs + BQ * LDV);
  float* dPs = Ss + BQ * LDS;
  bf16* Ps = reinterpret_cast<bf16*>(dPs + BQ * LDD);
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
  const long long row_stride = (long long)a.H * D;  // dq/dk token stride
  const long long row_stride_v = (long long)a.H * DV;  // dv token stride
  float* dqb = a.dq_acc + (long long)b * a.Tq * row_stride + h * D;

  load_tile<bf16, D, LDH, BK>(Ks, kb, a.kst, k0, a.Tk);
  load_tile<bf16, DV, LDV, BK>(Vs, vb, a.vst, k0, a.Tk);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dk_f[KDW], dv_f[KVW];
#pragma unroll
  for (int n = 0; n < KDW; ++n) wmma::fill_fragment(dk_f[n], 0.f);
#pragma unroll
  for (int n = 0; n < KVW; ++n) wmma::fill_fragment(dv_f[n], 0.f);

  float* Sw = Ss + warp * 16 * LDS;
  float* dPw = dPs + warp * 16 * LDD;
  bf16* Pw = Ps + warp * 16 * LDP;
  bf16* dSw = dSs + warp * 16 * LDP;
  const int r = lane >> 1;     // row of this warp's 16 owned by the lane pair
  const int half = lane & 1;   // which half of the BK columns this lane owns
  const int wr = warp % WR, wc = warp / WR;   // its key rows and columns

  for (int q0 = 0; q0 < a.Tq; q0 += BQ) {
    __syncthreads();  // every warp is done with the previous Q tile
    load_tile<bf16, D, LDH>(Qs, qb, a.qst, q0, a.Tq);
    load_tile<bf16, DV, LDV>(Gs, gb, a.gst, q0, a.Tq);
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
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
        wmma::load_matrix_sync(qf, Qs + warp * 16 * LDH + kk * 16, LDH);
        wmma::load_matrix_sync(kf, Ks + n * 16 * LDH + kk * 16, LDH);
        wmma::mma_sync(sf, qf, kf, sf);
      }
#pragma unroll
      for (int kk = 0; kk < KV; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> gf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> vf;
        wmma::load_matrix_sync(gf, Gs + warp * 16 * LDV + kk * 16, LDV);
        wmma::load_matrix_sync(vf, Vs + n * 16 * LDV + kk * 16, LDV);
        wmma::mma_sync(pf, gf, vf, pf);
      }
      wmma::store_matrix_sync(Sw + n * 16, sf, LDS, wmma::mem_row_major);
      wmma::store_matrix_sync(dPw + n * 16, pf, LDD, wmma::mem_row_major);
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
      for (int c = 0; c < BK / 2; ++c) {
        const int col = half * (BK / 2) + c;
        float p = 0.f;
        float ds = 0.f;
        if (row_ok && k0 + col < a.Tk) {
          p = expf(Sw[r * LDS + col] * a.scale - l);
          ds = p * (dPw[r * LDD + col] - dl);
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

    // dV += P^T dO and dK += dS^T Q for this warp's 16 key rows and its
    // columns; P^T and dS^T are the row-major P and dS tiles read
    // column-major.
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> pt, st;
      wmma::load_matrix_sync(pt, Ps + kk * 16 * LDP + wr * 16, LDP);
      wmma::load_matrix_sync(st, dSs + kk * 16 * LDP + wr * 16, LDP);
#pragma unroll
      for (int n = 0; n < KVW; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> gf;
        wmma::load_matrix_sync(gf, Gs + kk * 16 * LDV + (wc * KVW + n) * 16,
                               LDV);
        wmma::mma_sync(dv_f[n], pt, gf, dv_f[n]);
      }
#pragma unroll
      for (int n = 0; n < KDW; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> qf;
        wmma::load_matrix_sync(qf, Qs + kk * 16 * LDH + (wc * KDW + n) * 16,
                               LDH);
        wmma::mma_sync(dk_f[n], st, qf, dk_f[n]);
      }
    }
  }

  // Write dV, then dK * scale, for the valid key rows and the columns of
  // this warp, staged through the warp's own rows of S.
  constexpr int DVW = DV / WC, DW = D / WC;
  bf16* dvb = static_cast<bf16*>(a.dv) + (long long)b * a.Tk * row_stride_v +
              h * DV + wc * DVW;
  bf16* dkb = static_cast<bf16*>(a.dk) + (long long)b * a.Tk * row_stride +
              h * D + wc * DW;
  __syncwarp();
#pragma unroll
  for (int n = 0; n < KVW; ++n) {
    wmma::store_matrix_sync(Sw + n * 16, dv_f[n], LDS, wmma::mem_row_major);
  }
  __syncwarp();
  for (int i = lane; i < 16 * DVW; i += 32) {
    const int rr = i / DVW;
    const int c = i % DVW;
    const int t = k0 + wr * 16 + rr;
    if (t < a.Tk) dvb[t * row_stride_v + c] = __float2bfloat16(Sw[rr * LDS + c]);
  }
  __syncwarp();
#pragma unroll
  for (int n = 0; n < KDW; ++n) {
    wmma::store_matrix_sync(Sw + n * 16, dk_f[n], LDS, wmma::mem_row_major);
  }
  __syncwarp();
  for (int i = lane; i < 16 * DW; i += 32) {
    const int rr = i / DW;
    const int c = i % DW;
    const int t = k0 + wr * 16 + rr;
    if (t < a.Tk) {
      dkb[t * row_stride + c] = __float2bfloat16(Sw[rr * LDS + c] * a.scale);
    }
  }
}

template <int D, int DV, int BK = keys_per_block(D, DV)>
struct F32Layout {
  static constexpr int LDH = D + 4;    // K, Q pitch (rows 16-byte aligned)
  static constexpr int LDV = DV + 4;   // V, dO pitch
  static constexpr int LDP = BK + 1;
  static constexpr size_t bytes =
      (size_t)(BK + BQ) * LDH * 4   // K, Q tiles
      + (size_t)(BK + BQ) * LDV * 4 // V, dO tiles
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

template <int D, int DV, int BK>
__global__ void __launch_bounds__(NT) attn_bwd_f32(Args a) {
  typedef F32Layout<D, DV, BK> L;
  constexpr int LDH = L::LDH;
  constexpr int LDV = L::LDV;
  constexpr int LDP = L::LDP;
  constexpr int DH = D / 2;
  // dQ's columns go by in chunks of DQC registers
  constexpr int DQC = DH > 64 ? 32 : DH;
  // a key row's dK and dV are split over KP threads, DKP and DVP columns each
  constexpr int KP = NT / BK;
  constexpr int DKP = D / KP;
  constexpr int DVP = DV / KP;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + BK * LDH;
  float* Qs = Vs + BK * LDV;
  float* Gs = Qs + BQ * LDH;
  float* Ps = Gs + BQ * LDV;
  float* dSs = Ps + BQ * LDP;
  float* lse_s = dSs + BQ * LDP;
  float* delta_s = lse_s + BQ;

  const int tid = threadIdx.x;
  const int r = tid >> 1;      // query row (S, dP, dQ)
  const int half = tid & 1;    // which half of its columns this thread owns
  const int kr = tid / KP;     // key row (dK, dV)
  const int part = tid % KP;   // and which of its KP column parts
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

  load_tile<float, D, LDH, BK>(Ks, kb, a.kst, k0, a.Tk);
  load_tile<float, DV, LDV, BK>(Vs, vb, a.vst, k0, a.Tk);

  float dk[DKP], dv[DVP];
#pragma unroll
  for (int i = 0; i < DKP; ++i) dk[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DVP; ++i) dv[i] = 0.f;

  for (int q0 = 0; q0 < a.Tq; q0 += BQ) {
    __syncthreads();
    load_tile<float, D, LDH>(Qs, qb, a.qst, q0, a.Tq);
    load_tile<float, DV, LDV>(Gs, gb, a.gst, q0, a.Tq);
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
          const float dp = dot_row<DV>(Gs + r * LDV, Vs + j * LDV);
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
      float* out = dqb + (long long)(q0 + r) * row_stride;
      for (int c0 = 0; c0 < DH; c0 += DQC) {
        float dq[DQC];
#pragma unroll
        for (int i = 0; i < DQC; ++i) dq[i] = 0.f;
        for (int j = 0; j < BK; ++j) {
          const float ds = dSs[r * LDP + j];
          const float* krow = Ks + j * LDH + half * DH + c0;
#pragma unroll
          for (int i = 0; i < DQC; ++i) dq[i] = fmaf(ds, krow[i], dq[i]);
        }
#pragma unroll
        for (int i = 0; i < DQC; ++i) atomicAdd(out + c0 + i, dq[i] * a.scale);
      }
    }

    // dV and dK for key row kr: sums over the tile's query rows.
    for (int i = 0; i < BQ; ++i) {
      const float p = Ps[i * LDP + kr];
      const float ds = dSs[i * LDP + kr];
      const float* gr = Gs + i * LDV + part * DVP;
      const float* qr = Qs + i * LDH + part * DKP;
#pragma unroll
      for (int d = 0; d < DVP; ++d) dv[d] = fmaf(p, gr[d], dv[d]);
#pragma unroll
      for (int d = 0; d < DKP; ++d) dk[d] = fmaf(ds, qr[d], dk[d]);
    }
  }

  const int t = k0 + kr;
  if (t < a.Tk) {
    float* dvo = static_cast<float*>(a.dv) +
                 ((long long)b * a.Tk + t) * a.H * DV + h * DV + part * DVP;
    float* dko = static_cast<float*>(a.dk) +
                 ((long long)b * a.Tk + t) * row_stride + h * D + part * DKP;
#pragma unroll
    for (int i = 0; i < DVP; ++i) dvo[i] = dv[i];
#pragma unroll
    for (int i = 0; i < DKP; ++i) dko[i] = dk[i] * a.scale;
  }
}

int grid_1d(long long n, int threads) {
  const long long blocks = (n + threads - 1) / threads;
  return (int)(blocks < 8192 ? (blocks > 0 ? blocks : 1) : 8192);
}

// ---- bf16, D = Dv in {48, 64}: wgmma on TMA-fed tiles ---------------------

namespace wg {

using namespace hmma;
typedef __nv_bfloat16 bf16;

constexpr int BKEYS = 128;              // keys a block, 64 a warpgroup
constexpr int BQT = 64;                 // query rows a tile
constexpr int STAGES = 4;
constexpr int kThreads = 384;           // two consumer warpgroups + producer
constexpr int kCompute = 256;
constexpr int kProducerRegs = 24;
constexpr int kComputeRegs = 240;
constexpr int kConsumerBarrier = 1;     // named barrier of the consumers
constexpr uint32_t KV_BYTES = BKEYS * 128;   // a [128, 64] K or V tile
constexpr uint32_t K_OFF = 0, V_OFF = KV_BYTES;
constexpr uint32_t DS_OFF = 2 * KV_BYTES;    // two [128 keys, 64 queries] dS^T
constexpr uint32_t DS_BYTES = BKEYS * 128;
constexpr uint32_t QT_BYTES = BQT * 128;     // a [64, 64] Q or dO tile
constexpr uint32_t ROWS_BYTES = BQT * 8;     // (lse * log2 e, delta) pairs
constexpr uint32_t STAGE_BYTES = 2 * QT_BYTES + 1024;   // 1 KB aligned
constexpr uint32_t RING_OFF = DS_OFF + 2 * DS_BYTES;
// dQ on its way to the scratch: a [64 queries, 32 columns] fp32 tile for
// each column half and each of two tiles in turn (128-byte rows, swizzled)
constexpr uint32_t DQ_OFF = RING_OFF + STAGES * STAGE_BYTES;
constexpr uint32_t DQ_BYTES = BQT * 128;
constexpr uint32_t BAR_OFF = DQ_OFF + 4 * DQ_BYTES;
constexpr size_t SMEM = BAR_OFF + 128 + 1024;   // + alignment slack
static_assert(SMEM <= 232448, "attn_bwd_wgmma: shared memory");

// Query rows a block's loop covers: Tq rounded up to whole tiles; the rows
// buffer holds this many (lse * log2 e, delta) pairs per (batch, head).
__host__ __device__ inline int padded_rows(int Tq) {
  return (Tq + BQT - 1) / BQT * BQT;
}

// rows[b, h, t] = (lse * log2 e, delta) for t < Tq, (+inf, 0) up to the
// padded length. One thread a (b, t, h), the head fastest, so that a warp
// reads neighbouring rows of o and dO.
template <int D>
__global__ void bwd_rows(Args a, float2* __restrict__ rows) {
  const int tqp = padded_rows(a.Tq);
  const long long n = (long long)a.B * tqp * a.H;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int h = (int)(i % a.H);
    const long long bt = i / a.H;
    const int t = (int)(bt % tqp);
    const int b = (int)(bt / tqp);
    const long long bh = (long long)b * a.H + h;
    float2 out = make_float2(INFINITY, 0.f);
    if (t < a.Tq) {
      const bf16* o = static_cast<const bf16*>(a.o) + b * a.osb + t * a.ost + h * a.osh;
      const bf16* g = static_cast<const bf16*>(a.g) + b * a.gsb + t * a.gst + h * a.gsh;
      out = make_float2(a.lse[bh * a.Tq + t] * LOG2E, row_delta<bf16, D>(o, g));
    }
    rows[bh * tqp + t] = out;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_wgmma(const __grid_constant__ CUtensorMap map_q,
               const __grid_constant__ CUtensorMap map_k,
               const __grid_constant__ CUtensorMap map_v,
               const __grid_constant__ CUtensorMap map_g,
               const __grid_constant__ CUtensorMap map_rows,
               const __grid_constant__ CUtensorMap map_dq,
               bf16* __restrict__ dk, bf16* __restrict__ dv, int Tq, int Tk,
               int H, float scale) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t full = base + BAR_OFF;
  const uint32_t empty = full + 8 * STAGES;
  const uint32_t kvbar = empty + 8 * STAGES;
  const uint32_t ring = base + RING_OFF;

  const int wgi = warpgroup_index();
  const int k0 = blockIdx.x * BKEYS;
  const int h = blockIdx.y, b = blockIdx.z;
  const int nq = (Tq + BQT - 1) / BQT;
  // consumer warpgroups with a key below Tk; the other one takes no part
  const int active = Tk - k0 > 64 ? 2 : 1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * active);   // one arrival a warp
    }
    mbar_init(kvbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wgi == 2) {
    // The producer: K and V once, then query tile j (Q, dO, rows) into
    // stage j % STAGES once every consumer warp has released it.
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == kCompute) {
      mbar_expect_tx(kvbar, 2 * KV_BYTES);
      tma_load_4d(base + K_OFF, &map_k, kvbar, 0, h, k0, b);
      tma_load_4d(base + V_OFF, &map_v, kvbar, 0, h, k0, b);
      for (int j = 0; j < nq; ++j) {
        const int stage = j % STAGES;
        mbar_wait(empty + 8 * stage, ((j / STAGES) & 1) ^ 1u);
        const uint32_t dst = ring + stage * STAGE_BYTES;
        const uint32_t bar = full + 8 * stage;
        mbar_expect_tx(bar, 2 * QT_BYTES + ROWS_BYTES);
        tma_load_4d(dst, &map_q, bar, 0, h, j * BQT, b);
        tma_load_4d(dst + QT_BYTES, &map_g, bar, 0, h, j * BQT, b);
        tma_load_2d(dst + 2 * QT_BYTES, &map_rows, bar, 2 * j * BQT, b * H + h);
      }
    }
  } else if (wgi < active) {
    reg_alloc<kComputeRegs>();
    const int t = threadIdx.x & 127;
    const int lane = t & 31;
    const int r_lo = 16 * (t >> 5) + (lane >> 2);   // rows r_lo, r_lo + 8
    const int cq = 2 * (lane & 3);                  // columns 8j + cq, + 1
    const float sl2 = scale * LOG2E;
    // this warpgroup's 64 keys of K and V, K-major A operands
    const uint64_t kdesc = make_desc(base + K_OFF + wgi * 8192, 16, 1024, kSwz128);
    const uint64_t vdesc = make_desc(base + V_OFF + wgi * 8192, 16, 1024, kSwz128);

    float st[32], dpt[32], dka[32], dva[32], dqa[16];
    uint32_t pf[4][4], sf[4][4];
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dpt[i] = dka[i] = dva[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) dqa[i] = 0.f;

    mbar_wait(kvbar, 0);
    for (int j = 0; j < nq; ++j) {
      const int stage = j % STAGES;
      const uint32_t qt = ring + stage * STAGE_BYTES;
      const uint32_t gt = qt + QT_BYTES;
      mbar_wait(full + 8 * stage, (j / STAGES) & 1);
      // S^T = K Q^T and dP^T = V dO^T for this warpgroup's 64 keys
      const uint64_t qk = make_desc(qt, 16, 1024, kSwz128);
      const uint64_t gk = make_desc(gt, 16, 1024, kSwz128);
      fence_regs(st);
      fence_regs(dpt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_m64n64k16<0, 0>(st, kdesc + 2 * kk, qk + 2 * kk, kk);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_m64n64k16<0, 0>(dpt, vdesc + 2 * kk, gk + 2 * kk, kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);

      // P^T = exp2(S^T * scale * log2 e - lse * log2 e), dS^T = P^T (dP^T -
      // delta), on the accumulator's layout (rows keys, columns queries);
      // bf16 pairs of both are the A fragments of dV and dK, and dS^T goes
      // to shared memory (128-byte rows, 128-byte swizzle) for dQ. The
      // exponent x is <= 0 for every key below Tk (lse is the row's
      // log-sum-exp), so P = exp2(-|x|) changes nothing there; a key past Tk
      // (a zero row of K and V, zero score) would have x = -lse * log2 e,
      // which overflows exp2 in a row whose scores are all very negative
      // (lse below about -88, as rows of a trained model reach), and inf
      // times K's zero row would be NaN in dQ. With -|x| its P is at most 1
      // and its dS finite, and K's zero row adds nothing to dQ.
      const float* rws = reinterpret_cast<const float*>(
          smem + (qt - base) + 2 * QT_BYTES);
      unsigned char* dsb = smem + DS_OFF + (j & 1) * DS_BYTES;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float4 rw = *reinterpret_cast<const float4*>(rws + 2 * (8 * jj + cq));
        const float p0 = exp2_approx(-fabsf(fmaf(st[4 * jj], sl2, -rw.x)));
        const float p1 = exp2_approx(-fabsf(fmaf(st[4 * jj + 1], sl2, -rw.z)));
        const float p2 = exp2_approx(-fabsf(fmaf(st[4 * jj + 2], sl2, -rw.x)));
        const float p3 = exp2_approx(-fabsf(fmaf(st[4 * jj + 3], sl2, -rw.z)));
        const uint32_t s01 = pack_bf16x2(p0 * (dpt[4 * jj] - rw.y),
                                         p1 * (dpt[4 * jj + 1] - rw.w));
        const uint32_t s23 = pack_bf16x2(p2 * (dpt[4 * jj + 2] - rw.y),
                                         p3 * (dpt[4 * jj + 3] - rw.w));
        pf[jj >> 1][2 * (jj & 1)] = pack_bf16x2(p0, p1);
        pf[jj >> 1][2 * (jj & 1) + 1] = pack_bf16x2(p2, p3);
        sf[jj >> 1][2 * (jj & 1)] = s01;
        sf[jj >> 1][2 * (jj & 1) + 1] = s23;
        const uint32_t off = (uint32_t)(64 * wgi + r_lo) * 128u +
                             (uint32_t)(8 * jj + cq) * 2u;
        *reinterpret_cast<uint32_t*>(dsb + swz128(off)) = s01;
        *reinterpret_cast<uint32_t*>(dsb + swz128(off + 8u * 128u)) = s23;
      }
      // dV += P^T dO and dK += dS^T Q: four k-steps of 16 queries, dO and Q
      // MN-major (16 rows = 2 KB each)
      const uint64_t gm = make_desc(gt, 16, 1024, kSwz128);
      const uint64_t qm = make_desc(qt, 16, 1024, kSwz128);
      fence_regs(dva);
      fence_regs(dka);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        fence_regs(pf[kk]);
        fence_regs(sf[kk]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n64k16_rs<1>(dva, pf[kk], gm + 128 * kk, 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n64k16_rs<1>(dka, sf[kk], qm + 128 * kk, 1);
      wgmma_commit();
      // both warpgroups' dS^T rows are written
      fence_async_smem();
      named_barrier(kConsumerBarrier, 128 * active);
      // dQ[64 queries, 32-column half hf] = dS K over the block's keys: dS^T
      // is the MN-major A operand (rows keys), K the MN-major B operand
      const uint64_t dsd =
          make_desc(base + DS_OFF + (j & 1) * DS_BYTES, 16, 1024, kSwz128);
      const uint64_t kb = make_desc(base + K_OFF, 16, 1024, kSwz128);
      for (int hf = wgi; hf < 2; hf += active) {
        fence_regs(dqa);
        wgmma_fence();
        for (int kk = 0; kk < 4 * active; ++kk)
          wgmma_m64n32k16<1, 1>(dqa, dsd + 128 * kk, kb + 4 * hf + 128 * kk, kk);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dqa);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          fence_regs(pf[kk]);
          fence_regs(sf[kk]);
        }
        if (hf == wgi && lane == 0) mbar_arrive(empty + 8 * stage);
        // dQ * scale into this half's tile of the tile's parity, then one
        // thread adds it into the scratch with a TMA reduction (rows past Tq
        // and, at D 48, columns past 48 are skipped)
        const uint32_t dqt = DQ_OFF + (2 * hf + (j & 1)) * DQ_BYTES;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const uint32_t off = (uint32_t)r_lo * 128u + (8 * jj + cq) * 4u;
          *reinterpret_cast<float2*>(smem + dqt + swz128(off)) =
              make_float2(dqa[4 * jj] * scale, dqa[4 * jj + 1] * scale);
          *reinterpret_cast<float2*>(smem + dqt + swz128(off + 1024u)) =
              make_float2(dqa[4 * jj + 2] * scale, dqa[4 * jj + 3] * scale);
        }
        fence_async_smem();
        named_barrier(2 + wgi, 128);
        if (t == 0) tma_reduce_add_4d(&map_dq, base + dqt, 32 * hf, h, j * BQT, b);
      }
      // one bulk group a tile; before this warpgroup's next barrier, the
      // group of the tile before has read its tiles, which the next tile
      // rewrites
      if (t == 0) {
        bulk_commit();
        bulk_wait_read<1>();
      }
    }
    if (t == 0) bulk_wait<0>();

    // dV and dK * scale in bf16, the valid key rows
    const int key_lo = k0 + 64 * wgi + r_lo, key_hi = key_lo + 8;
    const long long pitch = (long long)H * D;
    bf16* dvb = dv + (long long)b * Tk * pitch + (long long)h * D;
    bf16* dkb = dk + (long long)b * Tk * pitch + (long long)h * D;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      const int col = 8 * jj + cq;
      if (key_lo < Tk) {
        *reinterpret_cast<__nv_bfloat162*>(dvb + key_lo * pitch + col) =
            __floats2bfloat162_rn(dva[4 * jj], dva[4 * jj + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dkb + key_lo * pitch + col) =
            __floats2bfloat162_rn(dka[4 * jj] * scale, dka[4 * jj + 1] * scale);
      }
      if (key_hi < Tk) {
        *reinterpret_cast<__nv_bfloat162*>(dvb + key_hi * pitch + col) =
            __floats2bfloat162_rn(dva[4 * jj + 2], dva[4 * jj + 3]);
        *reinterpret_cast<__nv_bfloat162*>(dkb + key_hi * pitch + col) =
            __floats2bfloat162_rn(dka[4 * jj + 2] * scale,
                                  dka[4 * jj + 3] * scale);
      }
    }
  }
}

template <int D>
int launch(const Args& a, cudaStream_t st) {
  const int tqp = padded_rows(a.Tq);
  const long long n = (long long)a.B * a.H * tqp;
  float2* rows = reinterpret_cast<float2*>(a.delta);
  int rc = (int)cudaMemsetAsync(
      a.dq_acc, 0, (size_t)a.B * a.Tq * a.H * D * sizeof(float), st);
  if (rc != 0) return rc;
  bwd_rows<D><<<grid_1d(n, 256), 256, 0, st>>>(a, rows);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  CUtensorMap mq, mk, mv, mg, mr, mdq;
  rc = attn::map_bthd(&mq, a.q, a.B, a.Tq, a.H, D, a.qsb, a.qst, a.qsh, BQT);
  if (rc == 0) rc = attn::map_bthd(&mg, a.g, a.B, a.Tq, a.H, D, a.gsb, a.gst, a.gsh, BQT);
  if (rc == 0) rc = attn::map_bthd(&mk, a.k, a.B, a.Tk, a.H, D, a.ksb, a.kst, a.ksh, BKEYS);
  if (rc == 0) rc = attn::map_bthd(&mv, a.v, a.B, a.Tk, a.H, D, a.vsb, a.vst, a.vsh, BKEYS);
  if (rc == 0) {
    // rows as an fp32 matrix [B * H, 2 * tqp], boxes of one tile's 64 pairs
    const uint64_t dims[2] = {2 * (uint64_t)tqp, (uint64_t)a.B * a.H};
    const uint64_t strides[1] = {2 * (uint64_t)tqp * 4};
    const uint32_t box[2] = {2 * BQT, 1};
    rc = tma_map(&mr, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, rows, dims, strides,
                 box, CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  if (rc == 0) {
    // the fp32 dQ scratch [B, Tq, H, D], boxes of [64 queries, 32 columns]
    const uint64_t dims[4] = {(uint64_t)D, (uint64_t)a.H, (uint64_t)a.Tq,
                              (uint64_t)a.B};
    const uint64_t strides[3] = {(uint64_t)D * 4, (uint64_t)a.H * D * 4,
                                 (uint64_t)a.Tq * a.H * D * 4};
    const uint32_t box[4] = {32, 1, BQT, 1};
    rc = tma_map(&mdq, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a.dq_acc, dims,
                 strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (rc != 0) return rc;
  static bool smem_set = false;   // once a process, not every launch
  if (!smem_set) {
    rc = (int)cudaFuncSetAttribute(
        attn_bwd_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
    if (rc != 0) return rc;
    smem_set = true;
  }
  const dim3 grid((a.Tk + BKEYS - 1) / BKEYS, a.H, a.B);
  attn_bwd_wgmma<D><<<grid, kThreads, SMEM, st>>>(
      mq, mk, mv, mg, mr, mdq, static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.Tq, a.Tk, a.H, a.scale);
  return (int)cudaGetLastError();
}

}  // namespace wg

template <typename Kernel>
int launch_main(Kernel kernel, size_t smem, int keys, const Args& a,
                cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((a.Tk + keys - 1) / keys, a.H, a.B);
  kernel<<<grid, NT, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int D, int DV>
int dispatch(bool is_bf16, const Args& a, cudaStream_t st) {
  const long long rows = (long long)a.B * a.Tq * a.H;
  int rc = 0;
  bool wgmma = false;
  if constexpr (attn::wgmma_depth(D, DV)) wgmma = is_bf16;
  if (wgmma) {
    if constexpr (attn::wgmma_depth(D, DV)) rc = wg::launch<D>(a, st);
  } else {
    if (is_bf16) {
      bwd_prologue<__nv_bfloat16, D, DV><<<grid_1d(rows, 256), 256, 0, st>>>(a);
    } else {
      bwd_prologue<float, D, DV><<<grid_1d(rows, 256), 256, 0, st>>>(a);
    }
    rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    constexpr int BK = keys_per_block(D, DV);
    rc = is_bf16 ? launch_main(attn_bwd_bf16<D, DV, BK>,
                               Bf16Layout<D, DV>::bytes, BK, a, st)
                 : launch_main(attn_bwd_f32<D, DV, BK>,
                               F32Layout<D, DV>::bytes, BK, a, st);
  }
  if (rc != 0 || !is_bf16) return rc;
  const long long n = rows * D;
  cast_to_bf16<<<grid_1d(n, 256), 256, 0, st>>>(
      a.dq_acc, static_cast<__nv_bfloat16*>(a.dq), n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the prologue, the main kernel and (bf16) the dQ cast on `stream`
// and returns the first non-zero cudaGetLastError() (0 on success). is_bf16:
// 1 for bfloat16, 0 for float32, where dq_acc must be dq itself. q, k, dq,
// dk: depth D; v, o, dO, dv: depth Dv. `delta` is fp32 scratch of the size
// pose3d_flash_attention_bwd_config reports. Strides are in elements.
int pose3d_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* g, const void* lse, void* delta, void* dq_acc, void* dq,
    void* dk, void* dv, int is_bf16, int B, int Tq, int Tk, int H, int D,
    int Dv, float scale,
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
  switch (attn::pair_index(D, Dv)) {
    case 0: return dispatch<32, 32>(bf, a, st);
    case 1: return dispatch<48, 48>(bf, a, st);
    case 2: return dispatch<64, 64>(bf, a, st);
    case 3: return dispatch<128, 128>(bf, a, st);
    case 4: return dispatch<32, 64>(bf, a, st);
    case 5: return dispatch<16, 16>(bf, a, st);
    case 6: return dispatch<256, 256>(bf, a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// What pose3d_flash_attention_bwd does for a shape, without launching:
// cfg[0] the path (0 scalar fp32, 1 WMMA, 2 wgmma), cfg[1] keys a block,
// cfg[2..4] the main kernel's grid, cfg[5] its dynamic shared memory in
// bytes, cfg[6] its threads a block, cfg[7] the fp32 scratch `delta` needs
// (floats). Returns 0, or cudaErrorInvalidValue for a pair that is not
// built.
int pose3d_flash_attention_bwd_config(int is_bf16, int B, int Tq, int Tk,
                                      int H, int D, int Dv, long long* cfg) {
  const int pair = attn::pair_index(D, Dv);
  if (pair < 0) return (int)cudaErrorInvalidValue;
  const size_t wmma_smem[attn::kPairs] = {
      Bf16Layout<32, 32>::bytes, Bf16Layout<48, 48>::bytes,
      Bf16Layout<64, 64>::bytes, Bf16Layout<128, 128>::bytes,
      Bf16Layout<32, 64>::bytes, Bf16Layout<16, 16>::bytes,
      Bf16Layout<256, 256>::bytes};
  const size_t f32_smem[attn::kPairs] = {
      F32Layout<32, 32>::bytes, F32Layout<48, 48>::bytes,
      F32Layout<64, 64>::bytes, F32Layout<128, 128>::bytes,
      F32Layout<32, 64>::bytes, F32Layout<16, 16>::bytes,
      F32Layout<256, 256>::bytes};
  if (is_bf16 && attn::wgmma_depth(D, Dv)) {
    cfg[0] = kPathWgmma, cfg[1] = wg::BKEYS, cfg[5] = (long long)wg::SMEM;
    cfg[6] = wg::kThreads;
    cfg[7] = 2LL * B * H * wg::padded_rows(Tq);
  } else {
    cfg[0] = is_bf16 ? kPathWmma : kPathScalar;
    cfg[1] = keys_per_block(D, Dv), cfg[6] = NT;
    cfg[5] = (long long)(is_bf16 ? wmma_smem[pair] : f32_smem[pair]);
    cfg[7] = (long long)B * H * Tq;
  }
  cfg[2] = (Tk + cfg[1] - 1) / cfg[1], cfg[3] = H, cfg[4] = B;
  return 0;
}

const char* pose3d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
