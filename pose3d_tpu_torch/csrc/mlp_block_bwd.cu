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
// 10*N*D*H (193.5 GFLOP at N = 8*1025, D = 768, H = 3072; 0.196 ms at 989
// TFLOP/s) against some 60 MB of operands and gradients. What is executed is
// 14*N*D*H (0.274 ms): see below.
//
// Design. The TPU kernel adds dW1, dW2, db1 and db2 into VMEM blocks that it
// revisits from one step of a sequential grid to the next. Blocks here run
// in parallel and in no order, and nothing carries over between them. With
// one owner per output element, dx (a sum over H) and dW (sums over rows)
// cannot share a launch unless an [N, H] tensor is stored, which the
// contract forbids, and atomics would make the gradients differ from run to
// run. So two launches each recompute a and dga: 6 + 8 = 14*N*D*H executed
// for the 10*N*D*H counted. Every output element is written once, in a
// fixed order of summation: repeats are bitwise equal.
//
// bf16 with D a multiple of 64 (wgmma through hopper_mma.cuh; 384 threads:
// two computing warpgroups and a producer warpgroup whose one thread feeds a
// ring of stages by TMA, registers moved by setmaxnreg, as in
// mlp_block_fwd.cu):
//  * mlp_bwd_dx_wgmma, one block per 64 rows: the forward's structure. x
//    stays resident (96 KB); per chunk of 64 hidden columns a warpgroup
//    computes its 32 columns of a = x W1 (W1's [192, 64] k-slices from the
//    ring), parks gelu'(a + b1) in shared memory (fp32, each thread its own
//    16 values: a second chunk accumulator beside the 192 registers of the
//    dx slab is what spills), then dga = g W2^T into the same 16 registers
//    (g's [64, 64] panels stream through the ring beside W2's [64, 64]
//    tiles: x and g together would fill the SM), rounds da = dga * gelu' to
//    bf16 into its panel of one of two chunk buffers, and after the
//    computing threads' barrier adds da W1^T into its [64, 384] slab (two
//    m64n192; W1's [768, 16] slices, K-major, 32-byte swizzle);
//  * mlp_bwd_dw_wgmma, grid (H / 32, G): a block owns 32 hidden columns and
//    one of G contiguous row groups, W1[:, cols] and W2[cols, :] resident
//    (96 KB). Rows go by in tiles of 128, 64 a warpgroup, as [128, 64] panels
//    through a ring of five 16 KB stages, in three passes a tile: the x
//    panels for a (then ga and gelu' for its rows); the g panels, each
//    serving dga for both warpgroups' rows and, as an MN-major A operand with
//    K = 128 rows, its tile of dW2[cols, :]^T += g^T ga; then da, and the x
//    panels again for dW1[:, cols] += x^T da. The two are [768, 32] products
//    with M = 768: twelve m64n32 tiles each, six of each to a warpgroup (192
//    accumulator registers). db1 is read back from the da buffer. The block
//    writes fp32 partials [G][dW1 | dW2 | db1]. The kernel is bound by what
//    its SMs take in (3 * 96 passes over x or g, 3.6 GB; a fourth pass, g
//    again for dW2, cost a quarter more time); holding a tile's x in shared
//    memory for its second use does not fit beside the weights;
//  * G is chosen so that H/32 * G blocks are about three waves of 132 SMs (4
//    at H = 3,072: 384 blocks; the partials are then 75 MB written and read);
//  * mlp_bwd_db2_partial sums g's columns over up to 256 row blocks, and
//    mlp_bwd_reduce adds the G partials and those row blocks in fixed order.
// bf16 with another D (not a multiple of 64, or above 768) keeps the
// earlier pair (WMMA m16n16k16, below); fp32 is a scalar-FMA version of
// that pair, slow and right (fp32 inputs would drop to TF32 on the tensor
// cores). D and H are multiples of 16 (the wrapper pads other widths with
// zeros), D at most 1,280: above 768 both kernels of the pair split D into
// column_slices(D) on gridDim.y (dx's columns; dW1's rows, dW2's columns,
// db2), and each slice recomputes a and dga over all of D, so da is formed
// from whole sums and rounded once, as the TPU kernel does.
//  * ragged rows are zero in shared memory (TMA fills them): x = 0 and g = 0
//    give da = 0 and add nothing anywhere; dx rows >= N are not stored.
//
// The earlier pair, kept for bf16 with D not a multiple of 64 and (as scalar
// code) for fp32:
//  * mlp_bwd_dx, parallel over 32-row tiles: the block walks the hidden axis
//    in chunks of 64, recomputes a and dga for the chunk (one warp per
//    16 x 16 fragment of each), forms da in shared memory, and adds da W1^T
//    into its [32, D] dx tile, held in WMMA accumulator fragments;
//  * mlp_bwd_dw, parallel over chunks of 16 hidden columns: the block walks
//    all rows in tiles of 32 and adds x^T da into its [D, 16] slice of dW1
//    and ga^T g into its [16, D] slice of dW2, db1 and a share of db2's
//    columns in registers; it writes each once at the end.

#include <mma.h>

#include "hopper_mma.cuh"
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
                long long N, int D, int H, int cols) {
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
  // this block's dx columns [c0, c0 + nout * 16)
  const int c0 = blockIdx.y * cols;
  const int nout = min(cols, D - c0) / 16;

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
    // dx += da W1[c0 : c0 + 16 * nout, h0 : h0 + hc]^T
    for (int kk = 0; kk < hc / 16; ++kk) {
      ARow d0, d1;
      wmma::load_matrix_sync(d0, DAs + kk * 16, LDD);
      wmma::load_matrix_sync(d1, DAs + 16 * LDD + kk * 16, LDD);
      const bf16* wcol = w1 + (long long)c0 * H + h0 + kk * 16;
#pragma unroll
      for (int i = 0; i < kMaxFrags; ++i) {
        const int nf = warp + kWarps * i;
        if (nf < nout) {
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
    if (nf < nout) {
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
          *reinterpret_cast<uint4*>(dx + r * D + c0 + nf * 16 + pc) = packed;
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

// Columns of db2 that block (b, s) of the grid owns: c0 + b + q * gridDim.x
// for q = thread, thread + 256, thread + 512, c0 = s * cols (a slice of at
// most 768 columns leaves no column without an owner).
constexpr int kDb2PerThread = kMaxCols / kThreads;

__global__ void __launch_bounds__(kThreads, 1)
mlp_bwd_dw_bf16(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                const float* __restrict__ b1, const bf16* __restrict__ w2,
                const bf16* __restrict__ g, float* __restrict__ dw1,
                float* __restrict__ db1, float* __restrict__ dw2,
                float* __restrict__ db2, long long N, int D, int H,
                int cols) {
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
  // this block's rows of dW1, columns of dW2 and db2: [c0, c0 + dc)
  const int c0 = blockIdx.y * cols;
  const int dc = min(cols, D - c0);
  const int nout = dc / 16;

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
      if (c < dc) {
        float s = 0.f;
#pragma unroll 8
        for (int r = 0; r < BR; ++r)
          s += __bfloat162float(Gt[r * LDX + c0 + c]);
        s_b2[j] += s;
      }
    }
    // dW1[slice, chunk] += x^T da;  dW2[chunk, slice] += ga^T g   (depth:
    // 32 rows)
#pragma unroll
    for (int kk = 0; kk < BR / 16; ++kk) {
      BRow daf;
      ACol gaf;
      wmma::load_matrix_sync(daf, DAs + kk * 16 * LDH, LDH);
      wmma::load_matrix_sync(gaf, GAs + kk * 16 * LDH, LDH);
#pragma unroll
      for (int i = 0; i < kMaxFrags; ++i) {
        const int f = warp + kWarps * i;
        if (f < nout) {
          ACol xt;
          BRow gt;
          wmma::load_matrix_sync(xt, Xs + kk * 16 * LDX + c0 + f * 16, LDX);
          wmma::mma_sync(acc1[i], xt, daf, acc1[i]);
          wmma::load_matrix_sync(gt, Gt + kk * 16 * LDX + c0 + f * 16, LDX);
          wmma::mma_sync(acc2[i], gaf, gt, acc2[i]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kMaxFrags; ++i) {
    const int f = warp + kWarps * i;
    if (f < nout) {
      wmma::store_matrix_sync(dw1 + (long long)(c0 + f * 16) * H + h0,
                              acc1[i], H, wmma::mem_row_major);
      wmma::store_matrix_sync(dw2 + (long long)h0 * D + c0 + f * 16, acc2[i],
                              D, wmma::mem_row_major);
    }
  }
  if (tid < HW && blockIdx.y == 0) db1[h0 + tid] = s_b1;
#pragma unroll
  for (int j = 0; j < kDb2PerThread; ++j) {
    const long long c =
        blockIdx.x + (long long)(tid + kThreads * j) * gridDim.x;
    if (c < dc) db2[c0 + c] = s_b2[j];
  }
}

// ---- bf16, D % 64 == 0: wgmma on TMA-fed tiles ---------------------------

namespace wg {

using namespace hmma;

constexpr int kSMs = 132;   // the split below is fixed, not read from the card:
                            // a shape's gradients are the same on any card

// mlp_bwd_dx_wgmma
constexpr int STAGES = 4;
constexpr int BM = 64;
constexpr uint32_t X_OFF = 0;                       // 12 panels of 8 KB
constexpr uint32_t DA_OFF = 98304;                  // 2 buffers of 8 KB
constexpr uint32_t BUF_BYTES = 8192;
constexpr uint32_t STASH_OFF = DA_OFF + 2 * BUF_BYTES;      // 256 * 16 fp32
constexpr uint32_t RING_OFF = STASH_OFF + 16384;
constexpr uint32_t BAR_OFF = RING_OFF + STAGES * kStageBytes;
constexpr size_t SMEM_DX = BAR_OFF + 128 + 1024;
static_assert(SMEM_DX <= kMaxSmem, "mlp_bwd_dx_wgmma: shared memory");

__global__ void __launch_bounds__(kWgThreads, 1)
mlp_bwd_dx_wgmma(const __grid_constant__ CUtensorMap map_x,
                 const __grid_constant__ CUtensorMap map_g,
                 const __grid_constant__ CUtensorMap map_w1,
                 const __grid_constant__ CUtensorMap map_w2t,
                 const __grid_constant__ CUtensorMap map_w1t,
                 const float* __restrict__ b1, bf16* __restrict__ dx,
                 long long N, int D, int H) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t full = base + BAR_OFF;
  const uint32_t empty = full + 8 * STAGES;
  const uint32_t xbar = empty + 8 * STAGES;
  const uint32_t ring = base + RING_OFF;

  const int wgi = warpgroup_index();
  const int row0 = blockIdx.x * BM;
  const int npan = D / 64;
  const int nk1 = (D + kW1Depth - 1) / kW1Depth;   // W1 stages a chunk
  const int nbox = (D + 255) / 256;     // 256-row boxes of W1 (its D rows)
  const int nchunks = (H + kHiddenChunk - 1) / kHiddenChunk;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kWarps2);   // one arrival a warp
    }
    mbar_init(xbar, 1);
    mbar_fence_init();
  }
  // every W1 stage is multiplied at its full depth of 192 (three x panels):
  // where D is no multiple of 192, the x panels behind the last one are read
  // too, as zeros
  if (D % kW1Depth != 0) {
    for (int i = threadIdx.x; i < (3 * nk1 - npan) * 512; i += kWgThreads)
      reinterpret_cast<uint4*>(smem + X_OFF + npan * 8192)[i] =
          make_uint4(0u, 0u, 0u, 0u);
    fence_async_smem();
  }
  __syncthreads();

  if (wgi == 2) {
    // The producer (as in mlp_block_fwd.cu): load number i goes to stage
    // i % STAGES once every computing warp has released that stage's previous
    // tile; the position in the sequence follows from the count of loads.
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == kComputeThreads) {
      mbar_expect_tx(xbar, npan * 8192);
      for (int p = 0; p < npan; ++p)
        tma_load_2d(base + X_OFF + p * 8192, &map_x, xbar, p * 64, row0);
      const int per_chunk = nk1 + npan + kHiddenChunk / 16;
      const int total = (nchunks - 1) * per_chunk + nk1 + npan +
                        (H - (nchunks - 1) * kHiddenChunk) / 16;
      for (int issued = 0; issued < total; ++issued) {
        const int ld_c = issued / per_chunk, ld_s = issued % per_chunk;
        const int h0 = ld_c * kHiddenChunk;
        const int hc = min(kHiddenChunk, H - h0);
        const int stage = issued % STAGES;
        mbar_wait(empty + 8 * stage, ((issued / STAGES) & 1) ^ 1u);
        const uint32_t dst = ring + stage * kStageBytes;
        const uint32_t bar = full + 8 * stage;
        if (ld_s < nk1) {               // W1[ld_s*192 : +192, h0 : h0 + hc]
          const int nw = (hc + 31) / 32;
          mbar_expect_tx(bar, nw * 12288);
          for (int w = 0; w < nw; ++w)
            tma_load_2d(dst + w * 12288, &map_w1, bar, h0 + 32 * w,
                        ld_s * kW1Depth);
        } else if (ld_s < nk1 + npan) { // g[:, p*64 : +64], W2[h0 : +64, same]
          const int p = ld_s - nk1;
          mbar_expect_tx(bar, 8192 + 8192);
          tma_load_2d(dst, &map_g, bar, p * 64, row0);
          tma_load_2d(dst + 8192, &map_w2t, bar, p * 64, h0);
        } else {                        // W1[:, h0 + s*16 : +16]
          mbar_expect_tx(bar, nbox * 8192);
          for (int w = 0; w < nbox; ++w)
            tma_load_2d(dst + w * 8192, &map_w1t, bar,
                        h0 + (ld_s - nk1 - npan) * 16, w * 256);
        }
      }
    }
  } else {
    reg_alloc<kComputeRegs>();
    int done = 0;
    const int t = threadIdx.x & 127;
    const int r_lo = 16 * (t >> 5) + ((t & 31) >> 2);
    const int cq = 2 * (t & 3);
    // this warpgroup's dx columns [wgi * 384, + 384), as two n192 halves
    const bool has_lo = wgi * kSlab < D, has_hi = wgi * kSlab + 192 < D;
    float* stash = reinterpret_cast<float*>(smem + STASH_OFF) + threadIdx.x;

    float acc[2][96];
#pragma unroll
    for (int i = 0; i < 96; ++i) acc[0][i] = acc[1][i] = 0.f;
    float pa[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) pa[i] = 0.f;

    const uint64_t xdesc = make_desc(base + X_OFF, 16, 1024, kSwz128);
    mbar_wait(xbar, 0);
    for (int c = 0; c < nchunks; ++c) {
      const int h0 = c * kHiddenChunk;
      const int hc = min(kHiddenChunk, H - h0);
      const bool mine = 32 * wgi < hc;
      // a = x W1[:, this warpgroup's 32 columns]
      for (int s = 0; s < nk1; ++s) {
        const int stage = done % STAGES;
        mbar_wait(full + 8 * stage, (done / STAGES) & 1);
        if (mine) {
          const uint64_t bdesc = make_desc(
              ring + stage * kStageBytes + wgi * 12288, 16, 512, kSwz64);
          fence_regs(pa);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kW1Depth / 16; ++kk) {
            wgmma_m64n32k16<0, 1>(
                pa, xdesc + s * 1536 + (((kk >> 2) * 8192 + (kk & 3) * 32) >> 4),
                bdesc + ((kk * 1024) >> 4), (s | kk) != 0);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(pa);
        }
        if ((t & 31) == 0) mbar_arrive(empty + 8 * stage);
        ++done;
      }
      // gelu'(a + b1), parked in this thread's own 16 slots
      if (mine) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int hcol = h0 + 32 * wgi + 8 * j + cq;
          float2 bv = make_float2(0.f, 0.f);
          if (hcol < H) bv = *reinterpret_cast<const float2*>(b1 + hcol);
          stash[(4 * j) * kComputeThreads] = gelu_grad(pa[4 * j] + bv.x);
          stash[(4 * j + 1) * kComputeThreads] = gelu_grad(pa[4 * j + 1] + bv.y);
          stash[(4 * j + 2) * kComputeThreads] = gelu_grad(pa[4 * j + 2] + bv.x);
          stash[(4 * j + 3) * kComputeThreads] = gelu_grad(pa[4 * j + 3] + bv.y);
        }
      }
      // dga = g W2[these 32 rows, :]^T
      for (int p = 0; p < npan; ++p) {
        const int stage = done % STAGES;
        mbar_wait(full + 8 * stage, (done / STAGES) & 1);
        if (mine) {
          const uint32_t st = ring + stage * kStageBytes;
          const uint64_t adesc = make_desc(st, 16, 1024, kSwz128);
          const uint64_t bdesc =
              make_desc(st + 8192 + wgi * 4096, 16, 1024, kSwz128);
          fence_regs(pa);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            wgmma_m64n32k16<0, 0>(pa, adesc + 2 * kk, bdesc + 2 * kk,
                                  p * 4 + kk > 0);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(pa);
        }
        if ((t & 31) == 0) mbar_arrive(empty + 8 * stage);
        ++done;
      }
      // da = dga * gelu'(a) in bf16, this warpgroup's [64, 32] panel
      if (mine) {
        unsigned char* panel =
            smem + DA_OFF + (c & 1) * BUF_BYTES + wgi * 4096;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = 8 * j + cq;
          store_pair_sw64(panel, r_lo, col,
                          pa[4 * j] * stash[(4 * j) * kComputeThreads],
                          pa[4 * j + 1] * stash[(4 * j + 1) * kComputeThreads]);
          store_pair_sw64(panel, r_lo + 8, col,
                          pa[4 * j + 2] * stash[(4 * j + 2) * kComputeThreads],
                          pa[4 * j + 3] * stash[(4 * j + 3) * kComputeThreads]);
        }
      }
      fence_async_smem();
      named_barrier(kComputeBarrier, kComputeThreads);
      // dx slab += da W1[slab, h0 : h0 + hc]^T
      for (int s = 0; s < hc / 16; ++s) {
        const int stage = done % STAGES;
        mbar_wait(full + 8 * stage, (done / STAGES) & 1);
        if (has_lo) {
          const uint64_t adesc =
              make_desc(base + DA_OFF + (c & 1) * BUF_BYTES + (s >> 1) * 4096 +
                            (s & 1) * 32,
                        16, 512, kSwz64);
          // W1's rows lie 32 bytes apart through the boxes of the stage
          const uint64_t bdesc = make_desc(
              ring + stage * kStageBytes + wgi * kSlab * 32, 16, 256, kSwz32);
          fence_regs(acc[0]);
          fence_regs(acc[1]);
          wgmma_fence();
          wgmma_m64n192k16<0, 0>(acc[0], adesc, bdesc, 1);
          if (has_hi) wgmma_m64n192k16<0, 0>(acc[1], adesc, bdesc + 384, 1);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(acc[0]);
          fence_regs(acc[1]);
        }
        if ((t & 31) == 0) mbar_arrive(empty + 8 * stage);
        ++done;
      }
    }

    const long long ra = row0 + r_lo, rb = ra + 8;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int j = 0; j < 24; ++j) {
        const int col = wgi * kSlab + h * 192 + 8 * j + cq;
        if (col < D) {
          if (ra < N) {
            *reinterpret_cast<__nv_bfloat162*>(dx + ra * D + col) =
                __floats2bfloat162_rn(acc[h][4 * j], acc[h][4 * j + 1]);
          }
          if (rb < N) {
            *reinterpret_cast<__nv_bfloat162*>(dx + rb * D + col) =
                __floats2bfloat162_rn(acc[h][4 * j + 2], acc[h][4 * j + 3]);
          }
        }
      }
    }
  }
}

// mlp_bwd_dw_wgmma
constexpr int WSTAGES = 5;
constexpr uint32_t WSTAGE_BYTES = 16384;            // a [128, 64] panel
constexpr int TR = 128;                             // rows a tile
constexpr int HB = 32;                              // hidden columns a block
constexpr uint32_t W1S_OFF = 0;                     // W1[:, cols]: [768, 32]
constexpr uint32_t W2S_OFF = 49152;                 // W2[cols, :]: 12 x [32, 64]
constexpr uint32_t WRING_OFF = 98304;
constexpr uint32_t WGA_OFF = WRING_OFF + WSTAGES * WSTAGE_BYTES;  // [128, 32]
constexpr uint32_t WDA_OFF = WGA_OFF + BUF_BYTES;
constexpr uint32_t WSTASH_OFF = WDA_OFF + BUF_BYTES;
constexpr uint32_t DB1_OFF = WSTASH_OFF + 16384;    // [8][32] fp32
constexpr uint32_t WBAR_OFF = DB1_OFF + 1024;
constexpr size_t SMEM_DW = WBAR_OFF + 128 + 1024;
static_assert(SMEM_DW <= kMaxSmem, "mlp_bwd_dw_wgmma: shared memory");

// Floats of one row group's partials: dW1 [D, H] | dW2 [H, D] | db1 [H].
__host__ __device__ inline long long group_floats(int D, int H) {
  return 2LL * D * H + H;
}

// Row groups: about three waves of blocks, no group empty.
struct Split {
  int cblocks, tiles, tiles_per_group, groups;
};
inline Split split_rows(long long N, int H) {
  Split s;
  s.cblocks = (H + HB - 1) / HB;
  s.tiles = (int)((N + TR - 1) / TR);
  int g = (3 * kSMs) / s.cblocks;
  g = g < 1 ? 1 : (g > s.tiles ? s.tiles : g);
  s.tiles_per_group = (s.tiles + g - 1) / g;
  s.groups = (s.tiles + s.tiles_per_group - 1) / s.tiles_per_group;
  return s;
}

__global__ void __launch_bounds__(kWgThreads, 1)
mlp_bwd_dw_wgmma(const __grid_constant__ CUtensorMap map_xt,
                 const __grid_constant__ CUtensorMap map_gt,
                 const __grid_constant__ CUtensorMap map_w1s,
                 const __grid_constant__ CUtensorMap map_w2s,
                 const float* __restrict__ b1, float* __restrict__ part,
                 long long N, int D, int H, int tiles, int tiles_per_group) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t full = base + WBAR_OFF;
  const uint32_t empty = full + 8 * WSTAGES;
  const uint32_t wbar = empty + 8 * WSTAGES;
  const uint32_t ring = base + WRING_OFF;

  const int wgi = warpgroup_index();
  const int h0 = blockIdx.x * HB;
  const int tile_lo = blockIdx.y * tiles_per_group;
  const int tile_hi = min(tiles, tile_lo + tiles_per_group);
  const int npan = D / 64;
  const int nslab = (D + 255) / 256;

  if (threadIdx.x == 0) {
    for (int s = 0; s < WSTAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kWarps2);   // one arrival a warp
    }
    mbar_init(wbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wgi == 2) {
    // The producer. Per tile 3 * npan loads: x by k-panel (for a), then g and
    // x again by d-tile in the order the computing warpgroups take them
    // (d-tiles 6q + tt, q the warpgroup that owns them, tt-major; only those
    // below npan): a g panel serves dga and its tile of dW2 in one visit.
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == kComputeThreads) {
      mbar_expect_tx(wbar, nslab * 16384 + npan * 4096);
      for (int w = 0; w < nslab; ++w)
        tma_load_2d(base + W1S_OFF + w * 16384, &map_w1s, wbar, h0, w * 256);
      for (int p = 0; p < npan; ++p)
        tma_load_2d(base + W2S_OFF + p * 4096, &map_w2s, wbar, p * 64, h0);
      const int total = (tile_hi - tile_lo) * 3 * npan;
      for (int issued = 0; issued < total; ++issued) {
        const int in_tile = issued % (3 * npan);
        const int pass = in_tile / npan, i = in_tile % npan;
        int p = i;
        if (pass >= 1) {    // the i-th of the d-tiles 6q + tt < npan, tt-major
          int left = i;
          for (int cand = 0; cand < 12; ++cand) {
            const int dt = 6 * (cand & 1) + (cand >> 1);
            if (dt < npan && left-- == 0) p = dt;
          }
        }
        const int stage = issued % WSTAGES;
        mbar_wait(empty + 8 * stage, ((issued / WSTAGES) & 1) ^ 1u);
        mbar_expect_tx(full + 8 * stage, WSTAGE_BYTES);
        tma_load_2d(ring + stage * WSTAGE_BYTES,
                    pass == 1 ? &map_gt : &map_xt, full + 8 * stage, p * 64,
                    (tile_lo + issued / (3 * npan)) * TR);
      }
    }
  } else {
    reg_alloc<kComputeRegs>();
    int done = 0;
    const int t = threadIdx.x & 127;
    const int r_lo = 16 * (t >> 5) + ((t & 31) >> 2);
    const int cq = 2 * (t & 3);
    float* stash = reinterpret_cast<float*>(smem + WSTASH_OFF) + threadIdx.x;
    unsigned char* ga_buf = smem + WGA_OFF;
    unsigned char* da_buf = smem + WDA_OFF;
    const int bcol = threadIdx.x & 31;     // db1: this thread's column
    const int strip = threadIdx.x >> 5;    // and its 16 rows of a tile

    float acc1[6][16], acc2[6][16];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int j = 0; j < 16; ++j) acc1[i][j] = acc2[i][j] = 0.f;
    }
    float pa[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) pa[i] = 0.f;
    float s_db1 = 0.f;

    mbar_wait(wbar, 0);
    for (int tile = tile_lo; tile < tile_hi; ++tile) {
      // a = x[this warpgroup's 64 rows] W1[:, cols]
      for (int p = 0; p < npan; ++p) {
        const int stage = done % WSTAGES;
        mbar_wait(full + 8 * stage, (done / WSTAGES) & 1);
        const uint64_t adesc = make_desc(
            ring + stage * WSTAGE_BYTES + wgi * 8192, 16, 1024, kSwz128);
        const uint64_t bdesc =
            make_desc(base + W1S_OFF + p * 4096, 16, 512, kSwz64);
        fence_regs(pa);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_m64n32k16<0, 1>(pa, adesc + 2 * kk, bdesc + 64 * kk,
                                p * 4 + kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(pa);
        if ((t & 31) == 0) mbar_arrive(empty + 8 * stage);
        ++done;
      }
      // ga = gelu(a + b1) in bf16 and gelu'(a + b1) parked, this warpgroup's
      // 64 rows. The other warpgroup has finished the previous tile's reads
      // of ga: it passed that tile's second barrier after them.
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = 8 * j + cq;
        // read again every tile (from L1) rather than held in 8 registers
        const float2 bv = h0 + col < H
                              ? *reinterpret_cast<const float2*>(b1 + h0 + col)
                              : make_float2(0.f, 0.f);
        const float a0 = pa[4 * j] + bv.x, a1 = pa[4 * j + 1] + bv.y;
        const float a2 = pa[4 * j + 2] + bv.x, a3 = pa[4 * j + 3] + bv.y;
        store_pair_sw64(ga_buf, wgi * 64 + r_lo, col, gelu(a0), gelu(a1));
        store_pair_sw64(ga_buf, wgi * 64 + r_lo + 8, col, gelu(a2), gelu(a3));
        stash[(4 * j) * kComputeThreads] = gelu_grad(a0);
        stash[(4 * j + 1) * kComputeThreads] = gelu_grad(a1);
        stash[(4 * j + 2) * kComputeThreads] = gelu_grad(a2);
        stash[(4 * j + 3) * kComputeThreads] = gelu_grad(a3);
      }
      fence_async_smem();
      // all 128 rows of ga are written; and every warpgroup is done with the
      // previous tile's da
      named_barrier(kComputeBarrier, kComputeThreads);
      // One visit of each g panel (d-tile): dga += g[these rows, d-tile]
      // W2[cols, d-tile]^T for both warpgroups, and for the warpgroup that
      // owns the d-tile dW2[cols, d-tile]^T += g^T ga with the whole [128, 64]
      // panel as the A operand, MN-major; K is the 128 rows
      {
        const uint64_t gadesc = make_desc(base + WGA_OFF, 16, 512, kSwz64);
#pragma unroll
        for (int tt = 0; tt < 6; ++tt) {
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int dt = 6 * q + tt;
            if (dt >= npan) continue;
            const int stage = done % WSTAGES;
            mbar_wait(full + 8 * stage, (done / WSTAGES) & 1);
            const uint32_t st = ring + stage * WSTAGE_BYTES;
            const uint64_t adesc = make_desc(st + wgi * 8192, 16, 1024, kSwz128);
            const uint64_t bdesc =
                make_desc(base + W2S_OFF + dt * 4096, 16, 1024, kSwz128);
            fence_regs(pa);
            fence_regs(acc2[tt]);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              wgmma_m64n32k16<0, 0>(pa, adesc + 2 * kk, bdesc + 2 * kk,
                                    (tt | q | kk) != 0);
            }
            if (q == wgi) {
              const uint64_t tdesc = make_desc(st, 16, 1024, kSwz128);
#pragma unroll
              for (int kk = 0; kk < TR / 16; ++kk) {
                wgmma_m64n32k16<1, 1>(acc2[tt], tdesc + 128 * kk,
                                      gadesc + 64 * kk, 1);
              }
            }
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(pa);
            fence_regs(acc2[tt]);
            if ((t & 31) == 0) mbar_arrive(empty + 8 * stage);
            ++done;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = 8 * j + cq;
        store_pair_sw64(da_buf, wgi * 64 + r_lo, col,
                        pa[4 * j] * stash[(4 * j) * kComputeThreads],
                        pa[4 * j + 1] * stash[(4 * j + 1) * kComputeThreads]);
        store_pair_sw64(da_buf, wgi * 64 + r_lo + 8, col,
                        pa[4 * j + 2] * stash[(4 * j + 2) * kComputeThreads],
                        pa[4 * j + 3] * stash[(4 * j + 3) * kComputeThreads]);
      }
      fence_async_smem();
      named_barrier(kComputeBarrier, kComputeThreads);
      // db1 += sum over this thread's 16 rows of the rounded da
#pragma unroll 4
      for (int i = 0; i < 16; ++i) {
        const uint32_t off = (uint32_t)(strip * 16 + i) * 64u + bcol * 2u;
        s_db1 += __bfloat162float(
            *reinterpret_cast<const bf16*>(da_buf + swz64(off)));
      }
      // dW1[d-tile, cols] += x^T da: the x panels a second time, each the A
      // operand of the warpgroup that owns its d-tile
      {
        const uint64_t dadesc = make_desc(base + WDA_OFF, 16, 512, kSwz64);
#pragma unroll
        for (int tt = 0; tt < 6; ++tt) {
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            if (6 * q + tt >= npan) continue;
            const int stage = done % WSTAGES;
            mbar_wait(full + 8 * stage, (done / WSTAGES) & 1);
            if (q == wgi) {
              const uint64_t adesc = make_desc(
                  ring + stage * WSTAGE_BYTES, 16, 1024, kSwz128);
              fence_regs(acc1[tt]);
              wgmma_fence();
#pragma unroll
              for (int kk = 0; kk < TR / 16; ++kk) {
                wgmma_m64n32k16<1, 1>(acc1[tt], adesc + 128 * kk,
                                      dadesc + 64 * kk, 1);
              }
              wgmma_commit();
              wgmma_wait<0>();
              fence_regs(acc1[tt]);
            }
            if ((t & 31) == 0) mbar_arrive(empty + 8 * stage);
            ++done;
          }
        }
      }
    }

    // partials of this row group: dW1 | dW2 | db1
    float* grp = part + (long long)blockIdx.y * group_floats(D, H);
    float* p1 = grp;
    float* p2 = grp + (long long)D * H;
#pragma unroll
    for (int tt = 0; tt < 6; ++tt) {
      const int d = (6 * wgi + tt) * 64 + r_lo;     // and d + 8
      if (d < D) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int h = h0 + 8 * j + cq;
          if (h < H) {
            *reinterpret_cast<float2*>(p1 + (long long)d * H + h) =
                make_float2(acc1[tt][4 * j], acc1[tt][4 * j + 1]);
            *reinterpret_cast<float2*>(p1 + (long long)(d + 8) * H + h) =
                make_float2(acc1[tt][4 * j + 2], acc1[tt][4 * j + 3]);
            p2[(long long)h * D + d] = acc2[tt][4 * j];
            p2[(long long)(h + 1) * D + d] = acc2[tt][4 * j + 1];
            p2[(long long)h * D + d + 8] = acc2[tt][4 * j + 2];
            p2[(long long)(h + 1) * D + d + 8] = acc2[tt][4 * j + 3];
          }
        }
      }
    }
    float* sums = reinterpret_cast<float*>(smem + DB1_OFF);
    sums[strip * 32 + bcol] = s_db1;
    named_barrier(kComputeBarrier, kComputeThreads);
    if (threadIdx.x < 32 && h0 + threadIdx.x < H) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < kWarps2; ++i) s += sums[i * 32 + threadIdx.x];
      grp[2LL * D * H + h0 + threadIdx.x] = s;
    }
  }
}

// db2: column sums of g over `rows_per_block` rows, [blocks, D] fp32.
constexpr int kDb2Threads = 384;     // two columns a thread: D <= 768

__global__ void __launch_bounds__(kDb2Threads)
mlp_bwd_db2_partial(const bf16* __restrict__ g, float* __restrict__ part2,
                    long long N, int D, int rows_per_block) {
  const int col = 2 * threadIdx.x;
  if (col >= D) return;
  const long long lo = (long long)blockIdx.x * rows_per_block;
  const long long hi = min(N, lo + rows_per_block);
  float s0 = 0.f, s1 = 0.f;
  for (long long r = lo; r < hi; ++r) {
    const float2 v = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(g + r * D + col));
    s0 += v.x;
    s1 += v.y;
  }
  *reinterpret_cast<float2*>(part2 + (long long)blockIdx.x * D + col) =
      make_float2(s0, s1);
}

// dW1 | dW2 | db1 = the G row groups' partials added in order 0 .. G-1, four
// floats a thread; db2 = the row blocks' column sums added in order.
__global__ void __launch_bounds__(256)
mlp_bwd_reduce(const float* __restrict__ part, int groups, long long n4,
               long long dh4, int D, const float* __restrict__ part2,
               int blocks2, float* __restrict__ dw1, float* __restrict__ dw2,
               float* __restrict__ db1, float* __restrict__ db2) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i < n4) {
    const float4* src = reinterpret_cast<const float4*>(part) + i;
    float4 s = src[0];
    for (int gi = 1; gi < groups; ++gi) {
      const float4 v = src[gi * n4];
      s.x += v.x, s.y += v.y, s.z += v.z, s.w += v.w;
    }
    float4* dst = i < dh4 ? reinterpret_cast<float4*>(dw1) + i
                  : i < 2 * dh4
                      ? reinterpret_cast<float4*>(dw2) + (i - dh4)
                      : reinterpret_cast<float4*>(db1) + (i - 2 * dh4);
    *dst = s;
  } else if (i - n4 < D) {
    const int d = (int)(i - n4);
    float s = 0.f;
    for (int b = 0; b < blocks2; ++b) s += part2[(long long)b * D + d];
    db2[d] = s;
  }
}

// Row blocks of mlp_bwd_db2_partial: at least 64 rows each, at most 256 blocks.
inline int db2_rows_per_block(long long N) {
  const long long r = (N + 255) / 256;
  return (int)(r < 64 ? 64 : r);
}

// Floats of scratch the pair needs: G groups of partials and db2's row blocks.
inline long long scratch_floats(long long N, int D, int H) {
  const Split sp = split_rows(N, H);
  const int rpb = db2_rows_per_block(N);
  return sp.groups * group_floats(D, H) + ((N + rpb - 1) / rpb) * D;
}

int launch(const bf16* x, const bf16* w1, const float* b1, const bf16* w2,
           const bf16* g, bf16* dx, float* dw1, float* db1, float* dw2,
           float* db2, float* scratch, long long scratch_len, long long N,
           int D, int H, cudaStream_t st) {
  if (N > 2147483647LL - 256 || scratch == nullptr ||
      scratch_len < scratch_floats(N, D, H))
    return (int)cudaErrorInvalidValue;
  const Split sp = split_rows(N, H);
  const int rpb = db2_rows_per_block(N);
  const int blocks2 = (int)((N + rpb - 1) / rpb);
  float* part2 = scratch + sp.groups * group_floats(D, H);

  CUtensorMap mx, mg, mw1, mw2t, mw1t, mxt, mgt, mw1s, mw2s;
  const CUtensorMapSwizzle s128 = CU_TENSOR_MAP_SWIZZLE_128B;
  const CUtensorMapSwizzle s64 = CU_TENSOR_MAP_SWIZZLE_64B;
  int rc = tma_map_bf16(&mx, x, N, D, 64, 64, s128);
  if (rc == 0) rc = tma_map_bf16(&mg, g, N, D, 64, 64, s128);
  if (rc == 0) rc = tma_map_bf16(&mw1, w1, D, H, kW1Depth, 32, s64);
  if (rc == 0) rc = tma_map_bf16(&mw2t, w2, H, D, 64, 64, s128);
  if (rc == 0)
    rc = tma_map_bf16(&mw1t, w1, D, H, 256, 16, CU_TENSOR_MAP_SWIZZLE_32B);
  if (rc == 0) rc = tma_map_bf16(&mxt, x, N, D, TR, 64, s128);
  if (rc == 0) rc = tma_map_bf16(&mgt, g, N, D, TR, 64, s128);
  if (rc == 0) rc = tma_map_bf16(&mw1s, w1, D, H, 256, 32, s64);
  if (rc == 0) rc = tma_map_bf16(&mw2s, w2, H, D, 32, 64, s128);
  if (rc != 0) return rc;
  rc = (int)cudaFuncSetAttribute(mlp_bwd_dx_wgmma,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)SMEM_DX);
  if (rc != 0) return rc;
  rc = (int)cudaFuncSetAttribute(mlp_bwd_dw_wgmma,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)SMEM_DW);
  if (rc != 0) return rc;

  mlp_bwd_dx_wgmma<<<(unsigned)((N + BM - 1) / BM), kWgThreads, SMEM_DX, st>>>(
      mx, mg, mw1, mw2t, mw1t, b1, dx, N, D, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mlp_bwd_dw_wgmma<<<dim3(sp.cblocks, sp.groups), kWgThreads, SMEM_DW, st>>>(
      mxt, mgt, mw1s, mw2s, b1, scratch, N, D, H, sp.tiles,
      sp.tiles_per_group);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mlp_bwd_db2_partial<<<blocks2, kDb2Threads, 0, st>>>(g, part2, N, D, rpb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n4 = group_floats(D, H) / 4;
  const long long threads = n4 + D;
  mlp_bwd_reduce<<<(unsigned)((threads + 255) / 256), 256, 0, st>>>(
      scratch, sp.groups, n4, (long long)D * H / 4, D, part2, blocks2, dw1,
      dw2, db1, db2);
  return (int)cudaGetLastError();
}

}  // namespace wg

// ---- fp32: the same two kernels with scalar FMAs ------------------------

constexpr int FR = 16;   // rows per tile in mlp_bwd_dx_f32
constexpr int FC = 64;   // hidden columns per chunk there

// Xs, Gt [FR][D], Os [FR][cols] (the block's dx columns), DAs [FR][FC]
size_t smem_dx_f32(int D) {
  return (size_t)(2 * FR * D + FR * column_slices(D).cols + 2 * FR * FC) * 4;
}

__global__ void __launch_bounds__(kThreads)
mlp_bwd_dx_f32(const float* __restrict__ x, const float* __restrict__ w1,
               const float* __restrict__ b1, const float* __restrict__ w2,
               const float* __restrict__ g, float* __restrict__ dx,
               long long N, int D, int H, int cols) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* Xs = reinterpret_cast<float*>(smem);
  float* Gt = Xs + FR * D;
  float* Os = Gt + FR * D;
  float* DAs = Os + FR * cols;    // [FR][FC]
  const int tid = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * FR;
  const int c0 = blockIdx.y * cols;       // this block's dx columns
  const int dc = min(cols, D - c0);

  load_rows<float, FR>(Xs, D, x, row0, N, D);
  load_rows<float, FR>(Gt, D, g, row0, N, D);
  for (int i = tid; i < FR * dc; i += kThreads) Os[i] = 0.f;
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
    for (int d = tid; d < dc; d += kThreads) {
      float o[FR];
#pragma unroll
      for (int r = 0; r < FR; ++r) o[r] = Os[r * dc + d];
      const float* wp = w1 + (long long)(c0 + d) * H + h0;
      for (int j = 0; j < hc; ++j) {
        const float w = wp[j];
#pragma unroll
        for (int r = 0; r < FR; ++r) o[r] = fmaf(DAs[r * FC + j], w, o[r]);
      }
#pragma unroll
      for (int r = 0; r < FR; ++r) Os[r * dc + d] = o[r];
    }
    __syncthreads();
  }
  for (int i = tid; i < FR * dc; i += kThreads) {
    const int r = i / dc, d = i % dc;
    if (row0 + r < N) dx[(row0 + r) * D + c0 + d] = Os[i];
  }
}

// rows a tile of mlp_bwd_dw_f32: 32, or 16 where two 32-row fp32 tiles of
// x and g would not fit a block's shared memory (D above 880)
inline int dw_f32_rows(int D) {
  return (size_t)(2 * BR * D + 2 * BR * HW) * 4 <= kMaxSmem ? BR : 16;
}
size_t smem_dw_f32(int D) {
  const int rows = dw_f32_rows(D);
  return (size_t)(2 * rows * D + 2 * rows * HW) * 4;
}

// RT rows a tile: a thread computes a and dga for RT / 16 of them
template <int RT>
__global__ void __launch_bounds__(kThreads, 1)
mlp_bwd_dw_f32(const float* __restrict__ x, const float* __restrict__ w1,
               const float* __restrict__ b1, const float* __restrict__ w2,
               const float* __restrict__ g, float* __restrict__ dw1,
               float* __restrict__ db1, float* __restrict__ dw2,
               float* __restrict__ db2, long long N, int D, int H,
               int cols) {
  constexpr int RPT = RT / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Xs = reinterpret_cast<float*>(smem);
  float* Gt = Xs + RT * D;
  float* GAs = Gt + RT * D;       // [RT][HW]
  float* DAs = GAs + RT * HW;
  const int tid = threadIdx.x;
  const int h0 = blockIdx.x * HW;
  const int c0 = blockIdx.y * cols;       // this block's slice of D
  const int dc = min(cols, D - c0);

  // this thread's columns d = c0 + tid, + 256, + 512 of dW1[:, chunk] and
  // dW2[chunk, :]
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

  const int h = tid % HW, ra = tid / HW;   // rows ra (and ra + 16) of a tile
  const float* w1p = w1 + h0 + h;
  const float* w2p = w2 + (long long)(h0 + h) * D;
  const float bias = b1[h0 + h];

  for (long long row0 = 0; row0 < N; row0 += RT) {
    __syncthreads();
    load_rows<float, RT>(Xs, D, x, row0, N, D);
    load_rows<float, RT>(Gt, D, g, row0, N, D);
    __syncthreads();
    {
      float av[RPT], dv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) av[i] = dv[i] = 0.f;
      for (int k = 0; k < D; ++k) {
        const float u = w1p[(long long)k * H];
        const float v = w2p[k];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          av[i] = fmaf(Xs[(ra + 16 * i) * D + k], u, av[i]);
          dv[i] = fmaf(Gt[(ra + 16 * i) * D + k], v, dv[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float a = av[i] + bias;
        GAs[(ra + 16 * i) * HW + h] = gelu(a);
        DAs[(ra + 16 * i) * HW + h] = dv[i] * gelu_grad(a);
      }
    }
    __syncthreads();
    if (tid < HW) {
      float s = 0.f;
#pragma unroll 8
      for (int r = 0; r < RT; ++r) s += DAs[r * HW + tid];
      s_b1 += s;
    }
#pragma unroll
    for (int j = 0; j < kDb2PerThread; ++j) {
      const long long c =
          blockIdx.x + (long long)(tid + kThreads * j) * gridDim.x;
      if (c < dc) {
        float s = 0.f;
#pragma unroll 8
        for (int r = 0; r < RT; ++r) s += Gt[r * D + c0 + c];
        s_b2[j] += s;
      }
    }
#pragma unroll
    for (int j = 0; j < kDb2PerThread; ++j) {
      const int d = c0 + tid + kThreads * j;
      if (d < c0 + dc) {
        for (int r = 0; r < RT; ++r) {
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
    const int d = c0 + tid + kThreads * j;
    if (d < c0 + dc) {
#pragma unroll
      for (int c = 0; c < HW; ++c) {
        dw1[(long long)d * H + h0 + c] = acc1[j][c];
        dw2[(long long)(h0 + c) * D + d] = acc2[j][c];
      }
    }
  }
  if (tid < HW && blockIdx.y == 0) db1[h0 + tid] = s_b1;
#pragma unroll
  for (int j = 0; j < kDb2PerThread; ++j) {
    const long long c =
        blockIdx.x + (long long)(tid + kThreads * j) * gridDim.x;
    if (c < dc) db2[c0 + c] = s_b2[j];
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
  const Slices sl = column_slices(D);
  const T* xp = static_cast<const T*>(x);
  const T* w1p = static_cast<const T*>(w1);
  const T* w2p = static_cast<const T*>(w2);
  const T* gp = static_cast<const T*>(g);
  kdx<<<dim3((unsigned)blocks, sl.n), kThreads, smem_dx, st>>>(
      xp, w1p, b1, w2p, gp, static_cast<T*>(dx), N, D, H, sl.cols);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kdw<<<dim3(H / HW, sl.n), kThreads, smem_dw, st>>>(
      xp, w1p, b1, w2p, gp, dw1, db1, dw2, db2, N, D, H, sl.cols);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches both kernels on `stream` and returns cudaGetLastError() (0 on
// success). x, g, dx: [N, D]; w1: [D, H]; w2: [H, D], all contiguous, one
// type (is_bf16: 1 bfloat16, 0 float32) and 32-byte aligned; b1 fp32 [H];
// dw1 [D, H], db1 [H], dw2 [H, D], db2 [D] fp32, each written once. D and H
// multiples of 16, D <= 1280; otherwise cudaErrorInvalidValue. `scratch` is
// fp32 device memory of `scratch_len` floats, at least what
// pose3d_mlp_block_bwd_config reports in cfg[8] (0: may be null).
int pose3d_mlp_block_bwd(const void* x, const void* w1, const void* b1,
                         const void* w2, const void* g, void* dx, void* dw1,
                         void* db1, void* dw2, void* db2, void* scratch,
                         long long scratch_len, int is_bf16, long long N,
                         int D, int H, void* stream) {
  if (N < 1 || D < 16 || H < 16 || D % 16 != 0 || H % 16 != 0 || D > kMaxD)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* fb1 = static_cast<const float*>(b1);
  float* f1 = static_cast<float*>(dw1);
  float* f2 = static_cast<float*>(db1);
  float* f3 = static_cast<float*>(dw2);
  float* f4 = static_cast<float*>(db2);
  if (takes_wgmma(is_bf16, D)) {
    return wg::launch(static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
                      fb1, static_cast<const bf16*>(w2),
                      static_cast<const bf16*>(g), static_cast<bf16*>(dx), f1,
                      f2, f3, f4, static_cast<float*>(scratch), scratch_len, N,
                      D, H, st);
  }
  if (is_bf16) {
    return launch<bf16>(mlp_bwd_dx_bf16, smem_dx_bf16(D), BR, mlp_bwd_dw_bf16,
                        smem_dw_bf16(D), x, w1, fb1, w2, g, dx, f1, f2, f3,
                        f4, N, D, H, st);
  }
  if (dw_f32_rows(D) == BR) {
    return launch<float>(mlp_bwd_dx_f32, smem_dx_f32(D), FR,
                         mlp_bwd_dw_f32<BR>, smem_dw_f32(D), x, w1, fb1, w2,
                         g, dx, f1, f2, f3, f4, N, D, H, st);
  }
  return launch<float>(mlp_bwd_dx_f32, smem_dx_f32(D), FR, mlp_bwd_dw_f32<16>,
                       smem_dw_f32(D), x, w1, fb1, w2, g, dx, f1, f2, f3, f4,
                       N, D, H, st);
}

// What pose3d_mlp_block_bwd does for a shape, without launching: cfg[0] the
// path (0 scalar fp32, 1 WMMA, 2 wgmma); for the dx kernel cfg[1] rows a
// block, cfg[2] blocks, cfg[3] dynamic shared memory; for the dW kernel
// cfg[4] rows a tile, cfg[5] blocks, cfg[6] row groups G, cfg[7] dynamic
// shared memory; cfg[8] floats of scratch; cfg[9] column slices of D (the
// blocks of both kernels count them). Returns 0.
int pose3d_mlp_block_bwd_config(int is_bf16, long long N, int D, int H,
                                long long* cfg) {
  const Slices sl = column_slices(D);   // one slice when D <= 768
  if (takes_wgmma(is_bf16, D)) {
    const wg::Split sp = wg::split_rows(N, H);
    cfg[0] = kPathWgmma, cfg[1] = wg::BM, cfg[3] = (long long)wg::SMEM_DX;
    cfg[4] = wg::TR, cfg[5] = (long long)sp.cblocks * sp.groups;
    cfg[6] = sp.groups, cfg[7] = (long long)wg::SMEM_DW;
    cfg[8] = wg::scratch_floats(N, D, H);
  } else {
    cfg[0] = is_bf16 ? kPathWmma : kPathScalar;
    cfg[1] = is_bf16 ? BR : FR;
    cfg[3] = (long long)(is_bf16 ? smem_dx_bf16(D) : smem_dx_f32(D));
    cfg[4] = is_bf16 ? BR : dw_f32_rows(D);
    cfg[5] = (long long)(H / HW) * sl.n, cfg[6] = 1;
    cfg[7] = (long long)(is_bf16 ? smem_dw_bf16(D) : smem_dw_f32(D));
    cfg[8] = 0;
  }
  cfg[2] = (N + cfg[1] - 1) / cfg[1] * sl.n;
  cfg[9] = sl.n;
  return 0;
}

const char* pose3d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
