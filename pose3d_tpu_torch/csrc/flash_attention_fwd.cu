// Flash-attention forward for Hopper (sm_90a).
//
// Replaces pose3d_tpu/ops/pallas/flash_attention.py::_attn_kernel (launched
// by pl.pallas_call in _fwd_impl). Per (batch, head) it computes
//   o   = softmax(scale * Q K^T) V     (columns >= Tk masked),
//   lse = log sum_j exp(scale * s_j)   (fp32),
// with scale = 1/sqrt(D), the softmax in fp32 and the division deferred to
// the [Tq, D] output, as the TPU kernel does.
//
// What bounds it on this card. The scores cost 2*B*H*Tq*Tk*(D+Dv) FLOPs:
// about 52 GFLOP of attention per image for the full-width lifter (12 ViT
// blocks at 1025 tokens x 12 heads x D 64, 4 final blocks at 1041 tokens x
// 16 heads x D 48, and the 1024<->16 cross attentions), against ~0.5 MB of
// q/k/v per (image, head). So the work is compute-bound, and the [Tq, Tk]
// score matrix (up to 1041^2 fp32 = 4.3 MB per head) is the thing to keep
// out of device memory. The TPU kernel held it whole in VMEM; a Hopper
// block has at most 227 KB of shared memory, so this kernel walks K/V in
// 64-row tiles with an online softmax (FlashAttention-2 style): a running
// row max m, a running row sum l and an fp32 [64, D] accumulator, rescaled
// by exp(scale*(m_old - m_new)) whenever the max grows.
//
// Design (simple first; wgmma/TMA are later work):
//  * grid (ceil(Tq/64), H, B); 128 threads = 4 warps, 16 query rows each;
//  * q/k/v are read in place from [B, T, H, D] through the strides given
//    (no pad-to-128 or transpose copies); ragged Q and K edges are
//    zero-filled in shared memory and masked in the softmax;
//  * bf16: QK^T and PV run on the tensor cores through WMMA m16n16k16 with
//    fp32 accumulation (D = 48 is tiled as 3 x 16); P is rounded to bf16
//    before PV, as the TPU kernel casts e to v's dtype;
//  * fp32: scalar FMA (WMMA would drop fp32 inputs to TF32), two threads
//    per query row, the row's q in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // key/value rows per tile
constexpr int NT = 128;  // threads per block
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;      // [B, Tq, H, D] contiguous
  float* lse;   // [B, H, Tq] contiguous
  int Tq, Tk, H;
  float scale;
  // element strides of batch, token and head (the last dim is contiguous)
  long long qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh;
};

// Copy rows [row0, row0 + 64) of a [T, D] slice (token stride st) into a
// shared tile with row pitch LD, 16 bytes at a time; rows >= T become 0.
template <typename T, int D, int LD>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long st,
                                          int row0, int nrows) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = D / VEC;
  for (int i = threadIdx.x; i < BK * VPR; i += NT) {
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

template <int D>
constexpr size_t smem_bf16() {
  return (size_t)3 * BQ * (D + 8) * 2     // Q, K, V tiles (bf16)
         + (size_t)BQ * (BK + 4) * 4      // scores (fp32)
         + (size_t)BQ * (BK + 8) * 2      // probabilities (bf16)
         + (size_t)BQ * (D + 4) * 4;      // output accumulator (fp32)
}

template <int D>
__global__ void __launch_bounds__(NT) attn_fwd_bf16(Args a) {
  using namespace nvcuda;
  typedef __nv_bfloat16 bf16;
  constexpr int LDH = D + 8;   // bf16 tile pitch (multiple of 8 for WMMA)
  constexpr int LDS = BK + 4;  // fp32 score pitch
  constexpr int LDP = BK + 8;  // bf16 probability pitch
  constexpr int LDO = D + 4;   // fp32 accumulator pitch
  constexpr int KD = D / 16;

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BQ * LDH;
  bf16* Vs = Ks + BK * LDH;
  float* Ss = reinterpret_cast<float*>(Vs + BK * LDH);
  bf16* Ps = reinterpret_cast<bf16*>(Ss + BQ * LDS);
  float* Os = reinterpret_cast<float*>(Ps + BQ * LDP);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.qsb + h * a.qsh;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.ksb + h * a.ksh;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.vsb + h * a.vsh;

  load_tile<bf16, D, LDH>(Qs, qb, a.qst, q0, a.Tq);
  for (int i = tid; i < BQ * LDO; i += NT) Os[i] = 0.f;
  __syncthreads();

  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qf[KD];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    wmma::load_matrix_sync(qf[kk], Qs + warp * 16 * LDH + kk * 16, LDH);
  }

  float* Sw = Ss + warp * 16 * LDS;
  bf16* Pw = Ps + warp * 16 * LDP;
  float* Ow = Os + warp * 16 * LDO;
  const int r = lane >> 1;     // row of this warp's 16 owned by the lane pair
  const int half = lane & 1;   // which half of the columns this lane owns
  const float sl2 = a.scale * LOG2E;
  float m_run = -INFINITY;
  float l_run = 0.f;

  for (int k0 = 0; k0 < a.Tk; k0 += BK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<bf16, D, LDH>(Ks, kb, a.kst, k0, a.Tk);
    load_tile<bf16, D, LDH>(Vs, vb, a.vst, k0, a.Tk);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows: [16, 64] fp32.
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
      wmma::fill_fragment(sf, 0.f);
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, Ks + n * 16 * LDH + kk * 16, LDH);
        wmma::mma_sync(sf, qf[kk], kf, sf);
      }
      wmma::store_matrix_sync(Sw + n * 16, sf, LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // Online softmax: the lane pair (2r, 2r+1) shares row r, 32 columns each.
    float s[32];
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int col = half * 32 + c;
      float x = Sw[r * LDS + col];
      if (k0 + col >= a.Tk) x = -INFINITY;
      s[c] = x;
      mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_run, mx);
    const float alpha = exp2f((m_run - m_new) * sl2);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const float p = exp2f((s[c] - m_new) * sl2);
      Pw[r * LDP + half * 32 + c] = __float2bfloat16(p);
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l_run = l_run * alpha + sum;
    m_run = m_new;
#pragma unroll
    for (int d = 0; d < D / 2; ++d) Ow[r * LDO + half * (D / 2) + d] *= alpha;
    __syncwarp();

    // O += P V: [16, 64] x [64, D].
#pragma unroll
    for (int n = 0; n < KD; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> of;
      wmma::load_matrix_sync(of, Ow + n * 16, LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(pf, Pw + kk * 16, LDP);
        wmma::load_matrix_sync(vf, Vs + kk * 16 * LDH + n * 16, LDH);
        wmma::mma_sync(of, pf, vf, of);
      }
      wmma::store_matrix_sync(Ow + n * 16, of, LDO, wmma::mem_row_major);
    }
    __syncwarp();
  }

  const int t = q0 + warp * 16 + r;
  if (t < a.Tq) {
    const float inv = 1.f / l_run;
    bf16* ob = static_cast<bf16*>(a.o) + (((long long)b * a.Tq + t) * a.H + h) * D;
#pragma unroll
    for (int d = 0; d < D / 2; ++d) {
      const int dd = half * (D / 2) + d;
      ob[dd] = __float2bfloat16(Ow[r * LDO + dd] * inv);
    }
    if (half == 0) {
      a.lse[((long long)b * a.H + h) * a.Tq + t] = m_run * a.scale + logf(l_run);
    }
  }
}

template <int D>
constexpr size_t smem_f32() {
  return (size_t)2 * BK * (D + 4) * 4    // K, V tiles
         + (size_t)BQ * (BK + 1) * 4;    // probabilities
}

template <int D>
__global__ void __launch_bounds__(NT) attn_fwd_f32(Args a) {
  constexpr int LDK = D + 4;   // keeps rows 16-byte aligned for float4
  constexpr int LDP = BK + 1;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + BK * LDK;
  float* Ps = Vs + BK * LDK;

  const int tid = threadIdx.x;
  const int r = tid >> 1;      // query row of the block owned by the pair
  const int half = tid & 1;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int t = q0 + r;

  const float* qb = static_cast<const float*>(a.q) + b * a.qsb + h * a.qsh;
  const float* kb = static_cast<const float*>(a.k) + b * a.ksb + h * a.ksh;
  const float* vb = static_cast<const float*>(a.v) + b * a.vsb + h * a.vsh;

  float q[D];
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t < a.Tq) x = *reinterpret_cast<const float4*>(qb + (long long)t * a.qst + d);
    q[d] = x.x; q[d + 1] = x.y; q[d + 2] = x.z; q[d + 3] = x.w;
  }
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  const float sl2 = a.scale * LOG2E;
  float m_run = -INFINITY;
  float l_run = 0.f;

  for (int k0 = 0; k0 < a.Tk; k0 += BK) {
    __syncthreads();
    load_tile<float, D, LDK>(Ks, kb, a.kst, k0, a.Tk);
    load_tile<float, D, LDK>(Vs, vb, a.vst, k0, a.Tk);
    __syncthreads();

    // The pair interleaves columns (j = 2c + half) so that its two lanes
    // read neighbouring K rows, which sit in different banks.
    float s[32];
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int j = 2 * c + half;
      const float* kr = Ks + j * LDK;
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 kv = *reinterpret_cast<const float4*>(kr + d);
        acc = fmaf(q[d], kv.x, acc);
        acc = fmaf(q[d + 1], kv.y, acc);
        acc = fmaf(q[d + 2], kv.z, acc);
        acc = fmaf(q[d + 3], kv.w, acc);
      }
      if (k0 + j >= a.Tk) acc = -INFINITY;
      s[c] = acc;
      mx = fmaxf(mx, acc);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_run, mx);
    const float alpha = exp2f((m_run - m_new) * sl2);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const float p = exp2f((s[c] - m_new) * sl2);
      Ps[r * LDP + 2 * c + half] = p;
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l_run = l_run * alpha + sum;
    m_run = m_new;
    __syncwarp();

#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha;
    for (int j = 0; j < BK; ++j) {
      const float p = Ps[r * LDP + j];
      const float* vr = Vs + j * LDK + half * (D / 2);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = fmaf(p, vr[i], o[i]);
    }
  }

  if (t < a.Tq) {
    const float inv = 1.f / l_run;
    float* ob = static_cast<float*>(a.o) + (((long long)b * a.Tq + t) * a.H + h) * D
                + half * (D / 2);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) ob[i] = o[i] * inv;
    if (half == 0) {
      a.lse[((long long)b * a.H + h) * a.Tq + t] = m_run * a.scale + logf(l_run);
    }
  }
}

template <typename Kernel>
int launch(Kernel kernel, size_t smem, const Args& a, int B, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((a.Tq + BQ - 1) / BQ, a.H, B);
  kernel<<<grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int D>
int dispatch(bool is_bf16, const Args& a, int B, cudaStream_t stream) {
  if (is_bf16) return launch(attn_fwd_bf16<D>, smem_bf16<D>(), a, B, stream);
  return launch(attn_fwd_f32<D>, smem_f32<D>(), a, B, stream);
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// is_bf16: 1 for bfloat16, 0 for float32. Strides are in elements.
int pose3d_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int is_bf16, int B, int Tq, int Tk, int H, int D, float scale,
    long long qsb, long long qst, long long qsh,
    long long ksb, long long kst, long long ksh,
    long long vsb, long long vst, long long vsh,
    void* stream) {
  Args a;
  a.q = q; a.k = k; a.v = v; a.o = o; a.lse = static_cast<float*>(lse);
  a.Tq = Tq; a.Tk = Tk; a.H = H; a.scale = scale;
  a.qsb = qsb; a.qst = qst; a.qsh = qsh;
  a.ksb = ksb; a.kst = kst; a.ksh = ksh;
  a.vsb = vsb; a.vst = vst; a.vsh = vsh;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return dispatch<32>(is_bf16 != 0, a, B, st);
    case 48: return dispatch<48>(is_bf16 != 0, a, B, st);
    case 64: return dispatch<64>(is_bf16 != 0, a, B, st);
    case 128: return dispatch<128>(is_bf16 != 0, a, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* pose3d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
