// Flash-attention forward for Hopper (sm_90a).
//
// Replaces pose3d_tpu/ops/pallas/flash_attention.py::_attn_kernel (launched
// by pl.pallas_call in _fwd_impl). Per (batch, head) it computes
//   o   = softmax(scale * Q K^T) V     (columns >= Tk masked),
//   lse = log sum_j exp(scale * s_j)   (fp32),
// with scale = 1/sqrt(D), the softmax in fp32 and the division deferred to
// the [Tq, Dv] output, as the TPU kernel does. V's depth Dv may differ from
// the depth D of Q and K, as the TPU kernel allows (YOLO11's PSA attention
// has D = Dv / 2); the (D, Dv) pairs built are listed at the entry point.
//
// What bounds it on this card. The scores cost 2*B*H*Tq*Tk*(D+Dv) FLOPs:
// about 52 GFLOP of attention per image for the full-width lifter (12 ViT
// blocks at 1025 tokens x 12 heads x D 64, 4 final blocks at 1041 tokens x
// 16 heads x D 48, and the 1024<->16 cross attentions), against ~0.5 MB of
// q/k/v per (image, head). So the work is compute-bound, and the [Tq, Tk]
// score matrix (up to 1041^2 fp32 = 4.3 MB per head) is the thing to keep
// out of device memory. The TPU kernel held it whole in VMEM; a Hopper
// block has at most 227 KB of shared memory, so these kernels walk K/V in
// tiles with an online softmax (FlashAttention-2 style): a running row max
// m, a running row sum l and an fp32 accumulator, rescaled by
// exp(scale*(m_old - m_new)) whenever the max grows. Beside the products
// the exp is the other floor: B*H*Tq*Tk exponentials (101 M at the ViT
// shape) on the special-function units, which run at a small fraction of
// the tensor rate.
//
// Paths, by shape alone (pose3d_flash_attention_fwd_config reports which):
//  * attn_fwd_wgmma (bf16, D = Dv in {48, 64}: the lifter's depths): 128
//    query rows a block in two consumer warpgroups of 64, and a producer
//    warpgroup whose one thread streams K and V tiles of 128 keys through a
//    ring of TMA stages (4-D tensor maps over the strided [B, T, H, D]
//    views, read in place: the packed q/k/v of a self-attention need no
//    copy, and a ragged last tile is zero-filled per batch element). Rows a
//    block for each byte streamed is the first design number: at 128 rows
//    each block streams its head's K and V once for twice the rows of the
//    earlier 64-row kernel. S = Q K^T is wgmma m64n128k16 with Q and K
//    K-major from shared memory (128-byte rows, swizzled as TMA writes
//    them); the online softmax runs on the accumulator's layout (a row
//    lives in the four lanes of a quad: two shuffles a row max); P is
//    rounded to bf16 in registers, as the TPU kernel casts e to v's dtype,
//    and is the register A operand of O += P V (m64n64k16, V MN-major). D 48
//    rows are 96 bytes, no swizzle width: the maps give D its own dimension,
//    so a 64-column box reads columns 48-63 as zeros (not the next head's),
//    Q K^T takes three k-steps, and P V runs at n64 with four zero columns
//    a row group that are never stored. The ragged last key tile arrives
//    as zero rows, and its score columns become -inf before the max.
//    O is divided by l in the epilogue. A warpgroup whose 64 rows all lie
//    past Tq takes no part. Each warpgroup runs S, softmax and P V of a tile
//    in turn; the two warpgroups overlap each other. Running a tile's
//    softmax under the previous tile's P V (a second P in registers, two
//    wgmma groups in flight) was tried and was slower: ptxas serialized the
//    wgmmas (C7513, PERF.md). The exponentials are ex2.approx;
//  * attn_fwd_bf16 (bf16, other pairs): 64 query rows and 128 threads a
//    block, WMMA m16n16k16 with fp32 accumulation, K/V tiles of 64 loaded
//    synchronously, S and O through shared memory (simple first);
//  * attn_fwd_f32 (fp32): scalar FMA (WMMA would drop fp32 inputs to TF32),
//    two threads per query row, the row's q in registers; above depth 128,
//    four threads a row and 32 rows a block, the rows' q in shared memory
//    (256 floats of q and 128 of o a thread spilled: 3,252 bytes, and
//    doubled the source's build time).
// D or Dv in (128, 256] take the (256, 256) instance of the two simple
// paths: 194,560 bytes of shared memory for WMMA (64 rows), 174,720 for
// fp32 (32 rows). D or Dv above 256 (the wrapper pads both to multiples of
// 64) take the deep instance of the same two paths (namespace deep below):
// S summed over D in 64-column chunks, o's columns in slices of 128 on
// gridDim.y, 96,256 bytes (WMMA) or 85,248 (fp32) at every depth.

#include <math.h>
#include <mma.h>

#include "flash_attention_common.cuh"

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // key/value rows per tile
constexpr int NT = 128;  // threads per block
constexpr float LOG2E = 1.4426950408889634f;

// Path codes that pose3d_flash_attention_fwd_config reports.
constexpr int kPathScalar = 0, kPathWmma = 1, kPathWgmma = 2;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;      // [B, Tq, H, Dv] contiguous
  float* lse;   // [B, H, Tq] contiguous
  int Tq, Tk, H;
  float scale;
  // element strides of batch, token and head (the last dim is contiguous)
  long long qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh;
};

// The deep instance's arguments: Args (whose layout the other kernels keep)
// and the runtime depths, multiples of attn::kDeepChunk, and column slices.
struct DeepArgs {
  Args a;
  int D, Dv, slices;
};

// Copy rows [row0, row0 + 64) of a [T, D] slice (token stride st) into a
// shared tile with row pitch LD, 16 bytes at a time; rows >= T become 0.
template <typename T, int D, int LD, int ROWS = BK>
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

template <int D, int DV>
constexpr size_t smem_bf16() {
  return (size_t)2 * BQ * (D + 8) * 2     // Q, K tiles (bf16)
         + (size_t)BK * (DV + 8) * 2      // V tile (bf16)
         + (size_t)BQ * (BK + 4) * 4      // scores (fp32)
         + (size_t)BQ * (BK + 8) * 2      // probabilities (bf16)
         + (size_t)BQ * (DV + 4) * 4;     // output accumulator (fp32)
}

template <int D, int DV>
__global__ void __launch_bounds__(NT) attn_fwd_bf16(Args a) {
  using namespace nvcuda;
  typedef __nv_bfloat16 bf16;
  constexpr int LDH = D + 8;   // bf16 Q / K pitch (multiple of 8 for WMMA)
  constexpr int LDV = DV + 8;  // bf16 V pitch
  constexpr int LDS = BK + 4;  // fp32 score pitch
  constexpr int LDP = BK + 8;  // bf16 probability pitch
  constexpr int LDO = DV + 4;  // fp32 accumulator pitch
  constexpr int KD = D / 16;

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BQ * LDH;
  bf16* Vs = Ks + BK * LDH;
  float* Ss = reinterpret_cast<float*>(Vs + BK * LDV);
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
    load_tile<bf16, DV, LDV>(Vs, vb, a.vst, k0, a.Tk);
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
    for (int d = 0; d < DV / 2; ++d) Ow[r * LDO + half * (DV / 2) + d] *= alpha;
    __syncwarp();

    // O += P V: [16, 64] x [64, Dv].
#pragma unroll
    for (int n = 0; n < DV / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> of;
      wmma::load_matrix_sync(of, Ow + n * 16, LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(pf, Pw + kk * 16, LDP);
        wmma::load_matrix_sync(vf, Vs + kk * 16 * LDV + n * 16, LDV);
        wmma::mma_sync(of, pf, vf, of);
      }
      wmma::store_matrix_sync(Ow + n * 16, of, LDO, wmma::mem_row_major);
    }
    __syncwarp();
  }

  const int t = q0 + warp * 16 + r;
  if (t < a.Tq) {
    const float inv = 1.f / l_run;
    bf16* ob = static_cast<bf16*>(a.o) + (((long long)b * a.Tq + t) * a.H + h) * DV;
#pragma unroll
    for (int d = 0; d < DV / 2; ++d) {
      const int dd = half * (DV / 2) + d;
      ob[dd] = __float2bfloat16(Ow[r * LDO + dd] * inv);
    }
    if (half == 0) {
      a.lse[((long long)b * a.H + h) * a.Tq + t] = m_run * a.scale + logf(l_run);
    }
  }
}

// fp32 query rows a block: 64, two threads a row, the row's q in
// registers; above depth 128, 32, four threads a row and the rows' q in
// shared memory, so that a thread's share of the output row (Dv / 4
// accumulators) and of the key tile's scores fit its registers
__host__ __device__ constexpr int f32_rows(int D) { return D > 128 ? 32 : 64; }

template <int D, int DV>
constexpr size_t smem_f32() {
  constexpr int ROWS = f32_rows(D);
  return (size_t)BK * (D + 4) * 4        // K tile
         + (size_t)BK * (DV + 4) * 4     // V tile
         + (size_t)ROWS * (BK + 1) * 4   // probabilities
         + (ROWS < BQ ? (size_t)ROWS * (D + 4) * 4 : 0);   // Q tile
}

template <int D, int DV>
__global__ void __launch_bounds__(NT) attn_fwd_f32(Args a) {
  constexpr int ROWS = f32_rows(D);
  constexpr int TPR = NT / ROWS;  // threads a query row
  constexpr bool QS = TPR > 2;    // the rows' q in shared memory
  constexpr int CPT = BK / TPR;   // key columns a thread
  constexpr int OPT = DV / TPR;   // output columns a thread
  constexpr int LDK = D + 4;   // keeps rows 16-byte aligned for float4
  constexpr int LDV = DV + 4;
  constexpr int LDP = BK + 1;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + BK * LDK;
  float* Ps = Vs + BK * LDV;
  float* Qs = Ps + ROWS * LDP;   // QS: the block's query rows, pitch LDK

  const int tid = threadIdx.x;
  const int r = tid / TPR;     // query row of the block owned by the group
  const int part = tid % TPR;  // this thread's share of the row
  const int q0 = blockIdx.x * ROWS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int t = q0 + r;

  const float* qb = static_cast<const float*>(a.q) + b * a.qsb + h * a.qsh;
  const float* kb = static_cast<const float*>(a.k) + b * a.ksb + h * a.ksh;
  const float* vb = static_cast<const float*>(a.v) + b * a.vsb + h * a.vsh;

  float q[QS ? 4 : D];
  if constexpr (QS) {
    // read after the key loop's first barrier
    load_tile<float, D, LDK, ROWS>(Qs, qb, a.qst, q0, a.Tq);
  } else {
#pragma unroll
    for (int d = 0; d < D; d += 4) {
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t < a.Tq) x = *reinterpret_cast<const float4*>(qb + (long long)t * a.qst + d);
      q[d] = x.x; q[d + 1] = x.y; q[d + 2] = x.z; q[d + 3] = x.w;
    }
  }
  float o[OPT];
#pragma unroll
  for (int i = 0; i < OPT; ++i) o[i] = 0.f;
  const float sl2 = a.scale * LOG2E;
  float m_run = -INFINITY;
  float l_run = 0.f;

  for (int k0 = 0; k0 < a.Tk; k0 += BK) {
    __syncthreads();
    load_tile<float, D, LDK>(Ks, kb, a.kst, k0, a.Tk);
    load_tile<float, DV, LDV>(Vs, vb, a.vst, k0, a.Tk);
    __syncthreads();

    // The group interleaves columns (j = TPR * c + part) so that its lanes
    // read neighbouring K rows, which sit in different banks.
    float s[CPT];
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int j = TPR * c + part;
      const float* kr = Ks + j * LDK;
      float acc = 0.f;
      if constexpr (QS) {
        const float* qr = Qs + r * LDK;
#pragma unroll 4
        for (int d = 0; d < D; d += 4) {
          const float4 kv = *reinterpret_cast<const float4*>(kr + d);
          const float4 qv = *reinterpret_cast<const float4*>(qr + d);
          acc = fmaf(qv.x, kv.x, acc);
          acc = fmaf(qv.y, kv.y, acc);
          acc = fmaf(qv.z, kv.z, acc);
          acc = fmaf(qv.w, kv.w, acc);
        }
      } else {
#pragma unroll
        for (int d = 0; d < D; d += 4) {
          const float4 kv = *reinterpret_cast<const float4*>(kr + d);
          acc = fmaf(q[d], kv.x, acc);
          acc = fmaf(q[d + 1], kv.y, acc);
          acc = fmaf(q[d + 2], kv.z, acc);
          acc = fmaf(q[d + 3], kv.w, acc);
        }
      }
      if (k0 + j >= a.Tk) acc = -INFINITY;
      s[c] = acc;
      mx = fmaxf(mx, acc);
    }
#pragma unroll
    for (int w = 1; w < TPR; w *= 2)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
    const float m_new = fmaxf(m_run, mx);
    const float alpha = exp2f((m_run - m_new) * sl2);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const float p = exp2f((s[c] - m_new) * sl2);
      Ps[r * LDP + TPR * c + part] = p;
      sum += p;
    }
#pragma unroll
    for (int w = 1; w < TPR; w *= 2)
      sum += __shfl_xor_sync(0xffffffffu, sum, w);
    l_run = l_run * alpha + sum;
    m_run = m_new;
    __syncwarp();

#pragma unroll
    for (int i = 0; i < OPT; ++i) o[i] *= alpha;
    for (int j = 0; j < BK; ++j) {
      const float p = Ps[r * LDP + j];
      const float* vr = Vs + j * LDV + part * OPT;
#pragma unroll
      for (int i = 0; i < OPT; ++i) o[i] = fmaf(p, vr[i], o[i]);
    }
  }

  if (t < a.Tq) {
    const float inv = 1.f / l_run;
    float* ob = static_cast<float*>(a.o) + (((long long)b * a.Tq + t) * a.H + h) * DV
                + part * OPT;
#pragma unroll
    for (int i = 0; i < OPT; ++i) ob[i] = o[i] * inv;
    if (part == 0) {
      a.lse[((long long)b * a.H + h) * a.Tq + t] = m_run * a.scale + logf(l_run);
    }
  }
}

// ---- D or Dv above 256: the deep instance ---------------------------------
//
// One instance a dtype, the depths a runtime loop bound (D and Dv multiples
// of attn::kDeepChunk = 64). A block owns 64 query rows and one slice of up
// to attn::kDeepSlice = 128 of o's columns (blockIdx.y = head * slices +
// slice). Per key tile it sums S = Q K^T over D in 64-column chunks of Q and
// K staged through shared memory, in the same order in every slice, so every
// slice computes the same S, the same online-softmax state and the same lse
// (written by slice 0); then it adds P V for its slice's columns of V. The
// shared memory is fixed (no tile spans D or Dv) and S is computed once a
// slice: ceil(Dv / 128) * 2*Tq*Tk*D + 2*Tq*Tk*Dv operations in all.
namespace deep {

constexpr int DC = attn::kDeepChunk;
constexpr int DS = attn::kDeepSlice;

constexpr size_t smem_bf16() {
  return (size_t)2 * BQ * (DC + 8) * 2    // Q, K chunks (bf16)
         + (size_t)BK * (DS + 8) * 2      // V slice (bf16)
         + (size_t)BQ * (BK + 4) * 4      // scores (fp32)
         + (size_t)BQ * (BK + 8) * 2      // probabilities (bf16)
         + (size_t)BQ * (DS + 4) * 4;     // output accumulator (fp32)
}

__global__ void __launch_bounds__(NT) attn_fwd_deep_bf16(DeepArgs args) {
  const Args& a = args.a;
  using namespace nvcuda;
  typedef __nv_bfloat16 bf16;
  constexpr int LDH = DC + 8;
  constexpr int LDV = DS + 8;
  constexpr int LDS = BK + 4;
  constexpr int LDP = BK + 8;
  constexpr int LDO = DS + 4;

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BQ * LDH;
  bf16* Vs = Ks + BK * LDH;
  float* Ss = reinterpret_cast<float*>(Vs + BK * LDV);
  bf16* Ps = reinterpret_cast<bf16*>(Ss + BQ * LDS);
  float* Os = reinterpret_cast<float*>(Ps + BQ * LDP);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y / args.slices;
  const int slice = blockIdx.y % args.slices;
  const int b = blockIdx.z;
  const int c0 = slice * DS;                  // this block's columns of o
  const int ncols = min(DS, args.Dv - c0);       // 64 or 128

  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.qsb + h * a.qsh;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.ksb + h * a.ksh;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.vsb + h * a.vsh + c0;

  for (int i = tid; i < BQ * LDO; i += NT) Os[i] = 0.f;

  float* Sw = Ss + warp * 16 * LDS;
  bf16* Pw = Ps + warp * 16 * LDP;
  float* Ow = Os + warp * 16 * LDO;
  const int r = lane >> 1;
  const int half = lane & 1;
  const float sl2 = a.scale * LOG2E;
  float m_run = -INFINITY;
  float l_run = 0.f;

  for (int k0 = 0; k0 < a.Tk; k0 += BK) {
    __syncthreads();  // every warp is done with the previous V slice
    attn::load_window<bf16, BK, NT>(Vs, LDV, vb, a.vst, k0, a.Tk, ncols);

    // S = Q K^T for this warp's 16 rows, summed over D chunk by chunk in
    // the four accumulators.
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf[BK / 16];
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) wmma::fill_fragment(sf[n], 0.f);
    for (int d0 = 0; d0 < args.D; d0 += DC) {
      if (d0 > 0) __syncthreads();  // every warp is done with the last chunk
      attn::load_window<bf16, BQ, NT>(Qs, LDH, qb + d0, a.qst, q0, a.Tq, DC);
      attn::load_window<bf16, BK, NT>(Ks, LDH, kb + d0, a.kst, k0, a.Tk, DC);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < DC / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qf;
        wmma::load_matrix_sync(qf, Qs + warp * 16 * LDH + kk * 16, LDH);
#pragma unroll
        for (int n = 0; n < BK / 16; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
              kf;
          wmma::load_matrix_sync(kf, Ks + n * 16 * LDH + kk * 16, LDH);
          wmma::mma_sync(sf[n], qf, kf, sf[n]);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < BK / 16; ++n)
      wmma::store_matrix_sync(Sw + n * 16, sf[n], LDS, wmma::mem_row_major);
    __syncwarp();

    // Online softmax, as attn_fwd_bf16: the lane pair shares row r.
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
#pragma unroll 8
    for (int d = 0; d < DS / 2; ++d) Ow[r * LDO + half * (DS / 2) + d] *= alpha;
    __syncwarp();

    // O[:, slice] += P V[:, slice]
    for (int n = 0; n < ncols / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> of;
      wmma::load_matrix_sync(of, Ow + n * 16, LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(pf, Pw + kk * 16, LDP);
        wmma::load_matrix_sync(vf, Vs + kk * 16 * LDV + n * 16, LDV);
        wmma::mma_sync(of, pf, vf, of);
      }
      wmma::store_matrix_sync(Ow + n * 16, of, LDO, wmma::mem_row_major);
    }
    __syncwarp();
  }

  const int t = q0 + warp * 16 + r;
  if (t < a.Tq) {
    const float inv = 1.f / l_run;
    bf16* ob = static_cast<bf16*>(a.o) +
               (((long long)b * a.Tq + t) * a.H + h) * args.Dv + c0;
    for (int d = 0; d < ncols / 2; ++d) {
      const int dd = half * (ncols / 2) + d;
      ob[dd] = __float2bfloat16(Ow[r * LDO + dd] * inv);
    }
    if (half == 0 && slice == 0) {
      a.lse[((long long)b * a.H + h) * a.Tq + t] = m_run * a.scale + logf(l_run);
    }
  }
}

// fp32: 64 query rows a block, two threads a row, each with 32 of a key
// tile's scores and 64 of the slice's output columns in registers.
constexpr size_t smem_f32() {
  return (size_t)BQ * (DC + 4) * 4        // Q chunk
         + (size_t)BK * (DC + 4) * 4      // K chunk
         + (size_t)BK * (DS + 4) * 4      // V slice
         + (size_t)BQ * (BK + 1) * 4;     // probabilities
}

__global__ void __launch_bounds__(NT) attn_fwd_deep_f32(DeepArgs args) {
  const Args& a = args.a;
  constexpr int TPR = NT / BQ;    // threads a query row
  constexpr int CPT = BK / TPR;   // key columns a thread
  constexpr int OPT = DS / TPR;   // output columns a thread
  constexpr int LDC = DC + 4;
  constexpr int LDV = DS + 4;
  constexpr int LDP = BK + 1;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + BQ * LDC;
  float* Vs = Ks + BK * LDC;
  float* Ps = Vs + BK * LDV;

  const int tid = threadIdx.x;
  const int r = tid / TPR;
  const int part = tid % TPR;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y / args.slices;
  const int slice = blockIdx.y % args.slices;
  const int b = blockIdx.z;
  const int t = q0 + r;
  const int c0 = slice * DS;
  const int ncols = min(DS, args.Dv - c0);
  const bool owns = part * OPT < ncols;   // this thread has output columns

  const float* qb = static_cast<const float*>(a.q) + b * a.qsb + h * a.qsh;
  const float* kb = static_cast<const float*>(a.k) + b * a.ksb + h * a.ksh;
  const float* vb = static_cast<const float*>(a.v) + b * a.vsb + h * a.vsh + c0;

  float o[OPT];
#pragma unroll
  for (int i = 0; i < OPT; ++i) o[i] = 0.f;
  const float sl2 = a.scale * LOG2E;
  float m_run = -INFINITY;
  float l_run = 0.f;

  for (int k0 = 0; k0 < a.Tk; k0 += BK) {
    __syncthreads();
    attn::load_window<float, BK, NT>(Vs, LDV, vb, a.vst, k0, a.Tk, ncols);

    float s[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) s[c] = 0.f;
    for (int d0 = 0; d0 < args.D; d0 += DC) {
      if (d0 > 0) __syncthreads();
      attn::load_window<float, BQ, NT>(Qs, LDC, qb + d0, a.qst, q0, a.Tq, DC);
      attn::load_window<float, BK, NT>(Ks, LDC, kb + d0, a.kst, k0, a.Tk, DC);
      __syncthreads();
      const float* qr = Qs + r * LDC;
#pragma unroll 4
      for (int c = 0; c < CPT; ++c) {
        const float* kr = Ks + (TPR * c + part) * LDC;
        float acc = s[c];
#pragma unroll 4
        for (int d = 0; d < DC; d += 4) {
          const float4 kv = *reinterpret_cast<const float4*>(kr + d);
          const float4 qv = *reinterpret_cast<const float4*>(qr + d);
          acc = fmaf(qv.x, kv.x, acc);
          acc = fmaf(qv.y, kv.y, acc);
          acc = fmaf(qv.z, kv.z, acc);
          acc = fmaf(qv.w, kv.w, acc);
        }
        s[c] = acc;
      }
    }
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      if (k0 + TPR * c + part >= a.Tk) s[c] = -INFINITY;
      mx = fmaxf(mx, s[c]);
    }
#pragma unroll
    for (int w = 1; w < TPR; w *= 2)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
    const float m_new = fmaxf(m_run, mx);
    const float alpha = exp2f((m_run - m_new) * sl2);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const float p = exp2f((s[c] - m_new) * sl2);
      Ps[r * LDP + TPR * c + part] = p;
      sum += p;
    }
#pragma unroll
    for (int w = 1; w < TPR; w *= 2)
      sum += __shfl_xor_sync(0xffffffffu, sum, w);
    l_run = l_run * alpha + sum;
    m_run = m_new;
    __syncwarp();

#pragma unroll
    for (int i = 0; i < OPT; ++i) o[i] *= alpha;
    if (owns) {
      for (int j = 0; j < BK; ++j) {
        const float p = Ps[r * LDP + j];
        const float* vr = Vs + j * LDV + part * OPT;
#pragma unroll
        for (int i = 0; i < OPT; ++i) o[i] = fmaf(p, vr[i], o[i]);
      }
    }
  }

  if (t < a.Tq) {
    const float inv = 1.f / l_run;
    if (owns) {
      float* ob = static_cast<float*>(a.o) +
                  (((long long)b * a.Tq + t) * a.H + h) * args.Dv + c0 +
                  part * OPT;
#pragma unroll
      for (int i = 0; i < OPT; ++i) ob[i] = o[i] * inv;
    }
    if (part == 0 && slice == 0) {
      a.lse[((long long)b * a.H + h) * a.Tq + t] = m_run * a.scale + logf(l_run);
    }
  }
}

int launch(bool is_bf16, const DeepArgs& args, int B, cudaStream_t stream) {
  const Args& a = args.a;
  const long long gy = (long long)a.H * args.slices;
  if (gy > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = is_bf16 ? smem_bf16() : smem_f32();
  const dim3 grid((a.Tq + BQ - 1) / BQ, (unsigned)gy, B);
  cudaError_t e;
  if (is_bf16) {
    e = cudaFuncSetAttribute(attn_fwd_deep_bf16,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    attn_fwd_deep_bf16<<<grid, NT, smem, stream>>>(args);
  } else {
    e = cudaFuncSetAttribute(attn_fwd_deep_f32,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    attn_fwd_deep_f32<<<grid, NT, smem, stream>>>(args);
  }
  return (int)cudaGetLastError();
}

}  // namespace deep

// ---- bf16, D = Dv in {48, 64}: wgmma on TMA-fed tiles ---------------------

namespace wg {

using namespace hmma;
typedef __nv_bfloat16 bf16;

constexpr int BM = 128;                 // query rows a block, 64 a warpgroup
constexpr int BN = 128;                 // keys a tile
constexpr int STAGES = 4;
constexpr int kThreads = 384;           // two consumer warpgroups + producer
constexpr int kCompute = 256;
constexpr int kProducerRegs = 24;
constexpr int kComputeRegs = 240;
constexpr uint32_t Q_BYTES = 64 * 128;  // a warpgroup's [64, 64] Q tile
constexpr uint32_t TILE = BN * 128;     // a [128, 64] K or V tile
constexpr uint32_t RING_OFF = 2 * Q_BYTES;
constexpr uint32_t STAGE_BYTES = 2 * TILE;
constexpr uint32_t BAR_OFF = RING_OFF + STAGES * STAGE_BYTES;
constexpr size_t SMEM = BAR_OFF + 128 + 1024;   // + alignment slack
static_assert(SMEM <= 232448, "attn_fwd_wgmma: shared memory");

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
attn_fwd_wgmma(const __grid_constant__ CUtensorMap map_q,
               const __grid_constant__ CUtensorMap map_k,
               const __grid_constant__ CUtensorMap map_v,
               bf16* __restrict__ o, float* __restrict__ lse, int Tq, int Tk,
               int H, float scale) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t full = base + BAR_OFF;
  const uint32_t empty = full + 8 * STAGES;
  const uint32_t qbar = empty + 8 * STAGES;
  const uint32_t ring = base + RING_OFF;

  const int wgi = warpgroup_index();
  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int nk = (Tk + BN - 1) / BN;
  // consumer warpgroups with a row below Tq; the other one takes no part
  const int active = Tq - q0 > 64 ? 2 : 1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * active);   // one arrival a warp
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wgi == 2) {
    // The producer: Q once, then K and V tile i into stage i % STAGES once
    // every consumer warp has released the tile before it there.
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == kCompute) {
      mbar_expect_tx(qbar, active * Q_BYTES);
      for (int w = 0; w < active; ++w)
        tma_load_4d(base + w * Q_BYTES, &map_q, qbar, 0, h, q0 + 64 * w, b);
      for (int i = 0; i < nk; ++i) {
        const int stage = i % STAGES;
        mbar_wait(empty + 8 * stage, ((i / STAGES) & 1) ^ 1u);
        const uint32_t dst = ring + stage * STAGE_BYTES;
        const uint32_t bar = full + 8 * stage;
        mbar_expect_tx(bar, STAGE_BYTES);
        tma_load_4d(dst, &map_k, bar, 0, h, i * BN, b);
        tma_load_4d(dst + TILE, &map_v, bar, 0, h, i * BN, b);
      }
    }
  } else if (wgi < active) {
    reg_alloc<kComputeRegs>();
    const int t = threadIdx.x & 127;
    const int lane = t & 31;
    const int r_lo = 16 * (t >> 5) + (lane >> 2);   // rows r_lo, r_lo + 8
    const int cq = 2 * (lane & 3);                  // columns 8j + cq, + 1
    const float sl2 = scale * 1.4426950408889634f;
    const uint64_t qdesc = make_desc(base + wgi * Q_BYTES, 16, 1024, kSwz128);

    float s[64], acc[32];
    uint32_t p[8][4];
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    // running max of each row (raw scores) and this thread's part of the
    // row sums (the quad's parts are added in the epilogue: every rescale
    // factor is the same across a quad)
    float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;

    mbar_wait(qbar, 0);
    for (int i = 0; i < nk; ++i) {
      const int stage = i % STAGES;
      const uint32_t kt = ring + stage * STAGE_BYTES;
      mbar_wait(full + 8 * stage, (i / STAGES) & 1);
      // S = Q K^T: D / 16 k-steps of 32 bytes along the 128-byte rows
      const uint64_t kdesc = make_desc(kt, 16, 1024, kSwz128);
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_m64n128k16<0, 0>(s, qdesc + 2 * kk, kdesc + 2 * kk, kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      if (i * BN + BN > Tk) {     // the ragged last tile: keys >= Tk
        const int lim = Tk - i * BN;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          if (8 * j + cq >= lim) s[4 * j] = s[4 * j + 2] = -INFINITY;
          if (8 * j + cq + 1 >= lim) s[4 * j + 1] = s[4 * j + 3] = -INFINITY;
        }
      }
      float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        mx_lo = fmaxf(mx_lo, fmaxf(s[4 * j], s[4 * j + 1]));
        mx_hi = fmaxf(mx_hi, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
      const float a_lo = exp2_approx((m_lo - mx_lo) * sl2);
      const float a_hi = exp2_approx((m_hi - mx_hi) * sl2);
      m_lo = mx_lo;
      m_hi = mx_hi;
      const float ms_lo = mx_lo * sl2, ms_hi = mx_hi * sl2;
      float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float e0 = exp2_approx(fmaf(s[4 * j], sl2, -ms_lo));
        const float e1 = exp2_approx(fmaf(s[4 * j + 1], sl2, -ms_lo));
        const float e2 = exp2_approx(fmaf(s[4 * j + 2], sl2, -ms_hi));
        const float e3 = exp2_approx(fmaf(s[4 * j + 3], sl2, -ms_hi));
        sum_lo += e0 + e1;
        sum_hi += e2 + e3;
        // the accumulator's d[8k..8k+7] are k-step k's A fragment
        p[j >> 1][2 * (j & 1)] = pack_bf16x2(e0, e1);
        p[j >> 1][2 * (j & 1) + 1] = pack_bf16x2(e2, e3);
      }
      l_lo = l_lo * a_lo + sum_lo;
      l_hi = l_hi * a_hi + sum_hi;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[4 * j] *= a_lo;
        acc[4 * j + 1] *= a_lo;
        acc[4 * j + 2] *= a_hi;
        acc[4 * j + 3] *= a_hi;
      }
      // O += P V: eight k-steps of 16 keys, V MN-major (16 rows = 2 KB each)
      const uint64_t vdesc = make_desc(kt + TILE, 16, 1024, kSwz128);
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) fence_regs(p[kk]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_m64n64k16_rs<1>(acc, p[kk], vdesc + 128 * kk, 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) fence_regs(p[kk]);
      if (lane == 0) mbar_arrive(empty + 8 * stage);
    }

    // o = acc / l in bf16, lse = m * scale + log l (one lane a row)
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
    const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;
    const int row_lo = q0 + 64 * wgi + r_lo, row_hi = row_lo + 8;
    const long long pitch = (long long)H * D;
    bf16* ob = o + (long long)b * Tq * pitch + (long long)h * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + cq;
      if (row_lo < Tq)
        *reinterpret_cast<__nv_bfloat162*>(ob + row_lo * pitch + col) =
            __floats2bfloat162_rn(acc[4 * j] * inv_lo, acc[4 * j + 1] * inv_lo);
      if (row_hi < Tq)
        *reinterpret_cast<__nv_bfloat162*>(ob + row_hi * pitch + col) =
            __floats2bfloat162_rn(acc[4 * j + 2] * inv_hi,
                                  acc[4 * j + 3] * inv_hi);
    }
    if ((lane & 3) == 0) {
      float* lb = lse + ((long long)b * H + h) * Tq;
      if (row_lo < Tq) lb[row_lo] = m_lo * scale + logf(l_lo);
      if (row_hi < Tq) lb[row_hi] = m_hi * scale + logf(l_hi);
    }
  }
}

template <int D>
int launch(const Args& a, int B, cudaStream_t st) {
  CUtensorMap mq, mk, mv;
  int rc = attn::map_bthd(&mq, a.q, B, a.Tq, a.H, D, a.qsb, a.qst, a.qsh, 64);
  if (rc == 0) rc = attn::map_bthd(&mk, a.k, B, a.Tk, a.H, D, a.ksb, a.kst, a.ksh, BN);
  if (rc == 0) rc = attn::map_bthd(&mv, a.v, B, a.Tk, a.H, D, a.vsb, a.vst, a.vsh, BN);
  if (rc != 0) return rc;
  static bool smem_set = false;   // once a process, not every launch
  if (!smem_set) {
    rc = (int)cudaFuncSetAttribute(
        attn_fwd_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
    if (rc != 0) return rc;
    smem_set = true;
  }
  const dim3 grid((a.Tq + BM - 1) / BM, a.H, B);
  attn_fwd_wgmma<D><<<grid, kThreads, SMEM, st>>>(
      mq, mk, mv, static_cast<bf16*>(a.o), a.lse, a.Tq, a.Tk, a.H, a.scale);
  return (int)cudaGetLastError();
}

}  // namespace wg

template <typename Kernel>
int launch(Kernel kernel, size_t smem, int rows, const Args& a, int B,
           cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((a.Tq + rows - 1) / rows, a.H, B);
  kernel<<<grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int D, int DV>
int dispatch(bool is_bf16, const Args& a, int B, cudaStream_t stream) {
  if constexpr (attn::wgmma_depth(D, DV)) {
    if (is_bf16) return wg::launch<D>(a, B, stream);
  }
  if (is_bf16)
    return launch(attn_fwd_bf16<D, DV>, smem_bf16<D, DV>(), BQ, a, B, stream);
  return launch(attn_fwd_f32<D, DV>, smem_f32<D, DV>(), f32_rows(D), a, B,
                stream);
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// is_bf16: 1 for bfloat16, 0 for float32. q, k: depth D; v and o: depth Dv;
// a built pair (attn::pair_index) or a deep one (attn::deep_pair). Strides
// are in elements.
int pose3d_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int is_bf16, int B, int Tq, int Tk, int H, int D, int Dv, float scale,
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
  const bool bf = is_bf16 != 0;
  if (attn::deep_pair(D, Dv)) {
    const DeepArgs args{a, D, Dv, attn::deep_fwd_slices(Dv)};
    return deep::launch(bf, args, B, st);
  }
  switch (attn::pair_index(D, Dv)) {
    case 0: return dispatch<32, 32>(bf, a, B, st);
    case 1: return dispatch<48, 48>(bf, a, B, st);
    case 2: return dispatch<64, 64>(bf, a, B, st);
    case 3: return dispatch<128, 128>(bf, a, B, st);
    case 4: return dispatch<32, 64>(bf, a, B, st);
    case 5: return dispatch<16, 16>(bf, a, B, st);
    case 6: return dispatch<256, 256>(bf, a, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// What pose3d_flash_attention_fwd does for a shape, without launching:
// cfg[0] the path (0 scalar fp32, 1 WMMA, 2 wgmma), cfg[1] query rows a
// block, cfg[2..4] the grid, cfg[5] dynamic shared memory in bytes, cfg[6]
// threads a block, cfg[7] the depth columns a step of the score sum takes
// (D itself on a built pair, 64 on the deep instance), cfg[8] the slices of
// o's columns (gridDim.y is H times them). Returns 0, or
// cudaErrorInvalidValue for a pair that is neither built nor deep.
int pose3d_flash_attention_fwd_config(int is_bf16, int B, int Tq, int Tk,
                                      int H, int D, int Dv, int* cfg) {
  (void)Tk;
  if (attn::deep_pair(D, Dv)) {
    cfg[0] = is_bf16 ? kPathWmma : kPathScalar, cfg[1] = BQ;
    cfg[5] = (int)(is_bf16 ? deep::smem_bf16() : deep::smem_f32());
    cfg[6] = NT, cfg[7] = attn::kDeepChunk;
    cfg[8] = attn::deep_fwd_slices(Dv);
    cfg[2] = (Tq + BQ - 1) / BQ, cfg[3] = H * cfg[8], cfg[4] = B;
    return 0;
  }
  const int pair = attn::pair_index(D, Dv);
  if (pair < 0) return (int)cudaErrorInvalidValue;
  cfg[7] = D, cfg[8] = 1;
  const size_t wmma_smem[attn::kPairs] = {
      smem_bf16<32, 32>(), smem_bf16<48, 48>(), smem_bf16<64, 64>(),
      smem_bf16<128, 128>(), smem_bf16<32, 64>(), smem_bf16<16, 16>(),
      smem_bf16<256, 256>()};
  const size_t f32_smem[attn::kPairs] = {
      smem_f32<32, 32>(), smem_f32<48, 48>(), smem_f32<64, 64>(),
      smem_f32<128, 128>(), smem_f32<32, 64>(), smem_f32<16, 16>(),
      smem_f32<256, 256>()};
  if (is_bf16 && attn::wgmma_depth(D, Dv)) {
    cfg[0] = kPathWgmma, cfg[1] = wg::BM, cfg[5] = (int)wg::SMEM;
    cfg[6] = wg::kThreads;
  } else {
    cfg[0] = is_bf16 ? kPathWmma : kPathScalar, cfg[6] = NT;
    cfg[1] = is_bf16 ? BQ : f32_rows(D);
    cfg[5] = (int)(is_bf16 ? wmma_smem[pair] : f32_smem[pair]);
  }
  cfg[2] = (Tq + cfg[1] - 1) / cfg[1], cfg[3] = H, cfg[4] = B;
  return 0;
}

const char* pose3d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
