// Fused transformer MLP forward for Hopper (sm_90a).
//
// Replaces pose3d_tpu/ops/pallas/mlp_block.py::_fwd_kernel (launched by
// pl.pallas_call in _fwd_impl). For x [N, D], W1 [D, H], W2 [H, D] in one
// type (bf16 or fp32) and fp32 b1 [H], b2 [D] it computes
//   a   = x W1 + b1                  (fp32 accumulation, a stays fp32),
//   ga  = gelu(a) rounded to x's type (exact GELU, erf by Abramowitz-Stegun),
//   out = ga W2 + b2                 (fp32 accumulation) in x's type,
// and the [N, H] hidden activation (a, ga) never reaches device memory.
//
// What bounds it on this card. 4*N*D*H operations (77.4 GFLOP at the ViT
// lifter's N = 8*1025, D = 768, H = 3072) against 34.6 MB of x, out and
// weights: bound by operations, on the tensor cores in bf16.
//
// The operations as executed equal the operations counted (4*N*D*H); the
// least time is 0.078 ms at the card's 989 TFLOP/s.
//
// Design of the bf16 kernel, mlp_fwd_wgmma (D a multiple of 64):
//  * the TPU kernel keeps both weight matrices resident in VMEM (18.9 MB)
//    under 256-row tiles. Nothing like that fits an SM; the 9.4 MB of bf16
//    weights stay in the 50 MB L2 and every row tile streams them from there;
//  * a block takes 64 rows (wgmma's M; 129 blocks at N = 8,200, one wave of
//    the 132 SMs) and keeps their [64, 768] fp32 output in the registers of
//    two computing warpgroups, 384 columns each as two m64n192 accumulators
//    (192 registers a thread): hence D <= 768. Three warpgroups with an
//    m64n256 slab each (128 registers of the 168 that 384 computing threads
//    leave) were tried first: with the chunk accumulator ptxas spilled and
//    serialized the wgmmas (C7512), 0.61 ms. The alternatives that keep
//    three: two blocks of a cluster with 384 output columns each that
//    exchange gelu(a) through distributed shared memory, or a grid that
//    splits D and recomputes x W1 (6*N*D*H);
//  * the hidden axis goes by in chunks of 64, 32 columns a warpgroup: x W1
//    for the chunk is 48 wgmma m64n32k16 a warpgroup (A: the x tile, resident
//    in shared memory as twelve 128-byte-swizzled [64, 64] panels; B: W1's
//    [192, 64] k-slices from the ring, MN-major), 16 accumulator registers;
//    each warpgroup adds b1, applies GELU, rounds to bf16 and stores its
//    [64, 32] panel of gelu(a) (64-byte swizzle) into one of two chunk
//    buffers; after one named barrier of the 256 computing threads,
//    gelu(a) W2 adds into the slabs, two m64n192k16 a warpgroup for each of
//    W2's [16, 768] k-slices from the ring. With two buffers one barrier a
//    chunk is enough: a warpgroup that runs ahead writes the other buffer
//    and then waits;
//  * loads: a third warpgroup is the producer. It hands its registers to the
//    other two (setmaxnreg: 24 and 240 a thread; the warpgroup's index comes
//    through a shuffle, or ptxas takes the roles for divergent, ignores
//    setmaxnreg and serializes every wgmma: C7520, sixty times slower), and
//    one thread of it issues TMA loads into a ring of four 24 KB stages,
//    full / empty mbarriers per stage, so loads run up to four stages ahead
//    of the wgmmas that read them. The computing warpgroups never issue a
//    load: with thread 0 of them as the producer, every stage waited for
//    that thread's dozen TMA instructions (0.54 ms for 0.28).
//    Out-of-bounds rows and columns arrive as zeros: ragged N, and an H that
//    is no multiple of 64, need no other care than masked stores and bias
//    loads;
//  * a warpgroup waits for each stage's wgmmas before it releases the stage;
//    the two warpgroups' batches overlap each other on the tensor cores.
//    Releasing a stage one group late (wgmma_wait<1>) was tried and changed
//    nothing: the tensor cores are not what the kernel waits for;
//  * what it waits for (scripts/mlp_block_variants.py, PERF.md): with every
//    wgmma and the GELU taken out, the loads, barriers and stores alone take
//    two thirds of the kernel's time. Each block streams all 9.4 MB of
//    weights into its SM for 64 rows, and an SM takes in some 35 bytes a
//    clock. A cluster of two blocks with multicast loads was tried: it halves
//    the reads from L2 and not what each SM takes in, and was no faster. What
//    would help is more rows to a block for the same stream: the two blocks
//    of a cluster with 384 output columns each and gelu(a) exchanged through
//    distributed shared memory (above), with x streamed. The GELU is the
//    next cost (a quarter of the time): it could run under the second
//    product of the chunk before; the epilogue's 4-byte stores could go
//    through shared memory;
//  * bf16 with D not a multiple of 64, or above 768, keeps the earlier
//    kernel (mlp_fwd_bf16: WMMA m16n16k16, 32-row tiles, B fragments
//    straight from L2); D and H must be multiples of 16 (the wrapper pads
//    other widths with zeros). fp32 inputs would drop to TF32 on the tensor
//    cores, so the fp32 path is a scalar-FMA tile of 16 rows: slow and right;
//  * D above 768 (ViT-L's 1,024, ViT-H's 1,280, and wider): the WMMA and
//    fp32 kernels split the output columns into column_slices(D) on
//    gridDim.y, at most 768 a block, and every slice computes a = x W1 + b1
//    over all of D itself (2*N*D*H a slice for x W1, 2*N*D*H in all for
//    the second product). The wgmma kernel keeps
//    D <= 768: its x tile would be 160 KB of the 227 at D 1,280, beside a
//    96 KB ring;
//  * D above 1,280: x's [rows, D] tile no longer fits whole beside the
//    rest, so those two kernels stream it through shared memory in
//    depth_chunks(D) of at most 1,280 columns, once for every hidden chunk,
//    summing x W1 over the chunks in order (fp32) before the GELU: a is
//    rounded once, as in the TPU kernel. Up to 1,280 the one chunk is all
//    of D, loaded once: the plan and the bits of those widths as before;
//  * ragged rows: the x tile's rows >= N are zero and never stored.

#include <mma.h>

#include "hopper_mma.cuh"
#include "mlp_block_common.cuh"

namespace {

using namespace mlp;
using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int BR = 32;    // rows per block (bf16)
constexpr int HC = 128;   // hidden columns per chunk (bf16)
constexpr int LDA = HC + 4;   // fp32 chunk pitch
constexpr int LDG = HC + 8;   // bf16 chunk pitch

size_t smem_bf16(int D) {
  return (size_t)BR * (depth_chunks(D).cols + 8) * 2 + (size_t)BR * LDA * 4 +
         (size_t)BR * LDG * 2;
}

__global__ void __launch_bounds__(kThreads, 1)
mlp_fwd_bf16(const bf16* __restrict__ x, const bf16* __restrict__ w1,
             const float* __restrict__ b1, const bf16* __restrict__ w2,
             const float* __restrict__ b2, bf16* __restrict__ out,
             long long N, int D, int H, int cols) {
  extern __shared__ __align__(128) unsigned char smem[];
  // x's rows in chunks of W columns (one chunk, all of D, up to 1,280)
  const Slices ch = depth_chunks(D);
  const int W = ch.cols;
  const int LDX = W + 8;
  bf16* Xs = reinterpret_cast<bf16*>(smem);
  float* As = reinterpret_cast<float*>(Xs + BR * LDX);
  bf16* Gs = reinterpret_cast<bf16*>(As + BR * LDA);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const long long row0 = (long long)blockIdx.x * BR;
  // this block's output columns [c0, c0 + nout * 16) (all of D when D <= 768)
  const int c0 = blockIdx.y * cols;
  const int nout = min(cols, D - c0) / 16;

  if (ch.n == 1) load_rows<bf16, BR>(Xs, LDX, x, row0, N, D);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][kMaxFrags];
#pragma unroll
  for (int i = 0; i < kMaxFrags; ++i) {
    wmma::fill_fragment(acc[0][i], 0.f);
    wmma::fill_fragment(acc[1][i], 0.f);
  }
  __syncthreads();

  const int rf = warp & 1;        // this warp's 16-row half in x W1
  const int cfa = warp >> 1;      // and its two 16-column stripes of a chunk
  const int cfb = cfa + 4;

  for (int h0 = 0; h0 < H; h0 += HC) {
    const int hc = min(HC, H - h0);
    // a = x W1[:, h0 : h0 + hc] for this warp's two fragments, summed over
    // D's chunks in order
    {
      const bool doa = cfa * 16 < hc, dob = cfb * 16 < hc;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> pa, pb;
      wmma::fill_fragment(pa, 0.f);
      wmma::fill_fragment(pb, 0.f);
      for (int kc = 0; kc < D; kc += W) {
        const int kw = min(W, D - kc);
        if (ch.n > 1) {
          __syncthreads();   // every warp is done with the last chunk
          load_cols<bf16, BR>(Xs, LDX, x, row0, N, D, kc, kw);
          __syncthreads();
        }
        if (!doa) continue;
        const bf16* wa = w1 + (long long)kc * H + h0 + cfa * 16;
        const bf16* wb = w1 + (long long)kc * H + h0 + cfb * 16;
#pragma unroll 4
        for (int k = 0; k < kw / 16; ++k) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> xf;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> wf;
          wmma::load_matrix_sync(xf, Xs + rf * 16 * LDX + k * 16, LDX);
          wmma::load_matrix_sync(wf, wa + (long long)k * 16 * H, H);
          wmma::mma_sync(pa, xf, wf, pa);
          if (dob) {
            wmma::load_matrix_sync(wf, wb + (long long)k * 16 * H, H);
            wmma::mma_sync(pb, xf, wf, pb);
          }
        }
      }
      if (doa) {
        wmma::store_matrix_sync(As + rf * 16 * LDA + cfa * 16, pa, LDA,
                                wmma::mem_row_major);
        if (dob) {
          wmma::store_matrix_sync(As + rf * 16 * LDA + cfb * 16, pb, LDA,
                                  wmma::mem_row_major);
        }
      }
    }
    __syncthreads();
    // ga = gelu(a + b1), rounded to bf16
    for (int i = tid; i < BR * hc; i += kThreads) {
      const int r = i / hc, c = i % hc;
      const float a = As[r * LDA + c] + b1[h0 + c];
      Gs[r * LDG + c] = __float2bfloat16(gelu(a));
    }
    __syncthreads();
    // out += ga W2[h0 : h0 + hc, c0 : c0 + 16 * nout]
    for (int kk = 0; kk < hc / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> g0, g1;
      wmma::load_matrix_sync(g0, Gs + kk * 16, LDG);
      wmma::load_matrix_sync(g1, Gs + 16 * LDG + kk * 16, LDG);
      const bf16* wrow = w2 + (long long)(h0 + kk * 16) * D + c0;
#pragma unroll
      for (int i = 0; i < kMaxFrags; ++i) {
        const int cf = warp + kWarps * i;
        if (cf < nout) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> wf;
          wmma::load_matrix_sync(wf, wrow + cf * 16, D);
          wmma::mma_sync(acc[0][i], g0, wf, acc[0][i]);
          wmma::mma_sync(acc[1][i], g1, wf, acc[1][i]);
        }
      }
    }
    // the next chunk's writes to As and Gs come after its own barriers
  }

  // out = acc + b2, rounded to bf16: each warp passes its fragments through
  // a 16 x 16 fp32 patch of As (free since the last chunk's second barrier)
  float* patch = As + warp * 256;
  const int pr = lane >> 1, pc = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < kMaxFrags; ++i) {
    const int cf = warp + kWarps * i;
    if (cf < nout) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        wmma::store_matrix_sync(patch, acc[h][i], 16, wmma::mem_row_major);
        __syncwarp();
        const long long r = row0 + h * 16 + pr;
        if (r < N) {
          const int col = c0 + cf * 16 + pc;
          uint4 packed;
          __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            p2[j] = __floats2bfloat162_rn(
                patch[pr * 16 + pc + 2 * j] + b2[col + 2 * j],
                patch[pr * 16 + pc + 2 * j + 1] + b2[col + 2 * j + 1]);
          }
          *reinterpret_cast<uint4*>(out + r * D + col) = packed;
        }
        __syncwarp();
      }
    }
  }
}

// ---- bf16, D % 64 == 0: wgmma on TMA-fed tiles ---------------------------

namespace wg {

using namespace hmma;

constexpr int BM = 64;
constexpr int STAGES = 4;
constexpr uint32_t X_OFF = 0;                           // 12 panels of 8 KB
constexpr uint32_t GA_OFF = 98304;                      // 2 buffers of 8 KB
constexpr uint32_t GA_BYTES = 8192;
constexpr uint32_t RING_OFF = GA_OFF + 2 * GA_BYTES;
constexpr uint32_t BAR_OFF = RING_OFF + STAGES * kStageBytes;
constexpr size_t SMEM = BAR_OFF + 128 + 1024;           // + alignment slack
static_assert(SMEM <= kMaxSmem, "mlp_fwd_wgmma: shared memory");

__global__ void __launch_bounds__(kWgThreads, 1)
mlp_fwd_wgmma(const __grid_constant__ CUtensorMap map_x,
              const __grid_constant__ CUtensorMap map_w1,
              const __grid_constant__ CUtensorMap map_w2,
              const float* __restrict__ b1, const float* __restrict__ b2,
              bf16* __restrict__ out, long long N, int D, int H) {
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
  const int npan = D / 64;              // 64-column panels of x, of W2's rows
  const int nk1 = (D + kW1Depth - 1) / kW1Depth;   // W1 stages a chunk
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
    // The producer. Load number i goes to stage i % STAGES once every
    // computing warp has released that stage's previous tile. Every chunk
    // but the last has the same number of loads, so the position follows
    // from the count.
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == kComputeThreads) {
      mbar_expect_tx(xbar, npan * 8192);
      for (int p = 0; p < npan; ++p)
        tma_load_2d(base + X_OFF + p * 8192, &map_x, xbar, p * 64, row0);
      const int per_chunk = nk1 + kHiddenChunk / 16;
      const int total = (nchunks - 1) * per_chunk + nk1 +
                        (H - (nchunks - 1) * kHiddenChunk) / 16;
      for (int issued = 0; issued < total; ++issued) {
        const int ld_c = issued / per_chunk, ld_s = issued % per_chunk;
        const int h0 = ld_c * kHiddenChunk;
        const int hc = min(kHiddenChunk, H - h0);
        const int stage = issued % STAGES;
        mbar_wait(empty + 8 * stage, ((issued / STAGES) & 1) ^ 1u);
        const uint32_t dst = ring + stage * kStageBytes;
        const uint32_t bar = full + 8 * stage;
        if (ld_s < nk1) {             // W1[ld_s*192 : +192, h0 : h0 + hc]
          const int nw = (hc + 31) / 32;    // warpgroups with columns here
          mbar_expect_tx(bar, nw * 12288);
          for (int w = 0; w < nw; ++w)
            tma_load_2d(dst + w * 12288, &map_w1, bar, h0 + 32 * w,
                        ld_s * kW1Depth);
        } else {                      // W2[h0 + s*16 : +16, :]
          mbar_expect_tx(bar, npan * 2048);
          for (int p = 0; p < npan; ++p)
            tma_load_2d(dst + p * 2048, &map_w2, bar, p * 64,
                        h0 + (ld_s - nk1) * 16);
        }
      }
    }
  } else {
    reg_alloc<kComputeRegs>();
    int done = 0;
    const int t = threadIdx.x & 127;
    const int r_lo = 16 * (t >> 5) + ((t & 31) >> 2);   // and r_lo + 8
    const int cq = 2 * (t & 3);
    // this warpgroup's output columns [wgi * 384, + 384), as two n192 halves
    const bool has_lo = wgi * kSlab < D, has_hi = wgi * kSlab + 192 < D;

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
      // a = x W1[:, this warpgroup's 32 columns of the chunk]
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
      // ga = gelu(a + b1) in bf16, this warpgroup's [64, 32] panel
      if (mine) {
        unsigned char* panel =
            smem + GA_OFF + (c & 1) * GA_BYTES + wgi * 4096;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = 8 * j + cq;
          const int hcol = h0 + 32 * wgi + col;
          float2 bv = make_float2(0.f, 0.f);
          if (hcol < H) bv = *reinterpret_cast<const float2*>(b1 + hcol);
          store_pair_sw64(panel, r_lo, col, gelu(pa[4 * j] + bv.x),
                          gelu(pa[4 * j + 1] + bv.y));
          store_pair_sw64(panel, r_lo + 8, col, gelu(pa[4 * j + 2] + bv.x),
                          gelu(pa[4 * j + 3] + bv.y));
        }
      }
      fence_async_smem();
      named_barrier(kComputeBarrier, kComputeThreads);
      // out slab += ga W2[h0 : h0 + hc, slab]
      for (int s = 0; s < hc / 16; ++s) {
        const int stage = done % STAGES;
        mbar_wait(full + 8 * stage, (done / STAGES) & 1);
        if (has_lo) {
          const uint64_t adesc =
              make_desc(base + GA_OFF + (c & 1) * GA_BYTES + (s >> 1) * 4096 +
                            (s & 1) * 32,
                        16, 512, kSwz64);
          const uint64_t bdesc = make_desc(
              ring + stage * kStageBytes + wgi * 12288, 2048, 1024, kSwz128);
          fence_regs(acc[0]);
          fence_regs(acc[1]);
          wgmma_fence();
          wgmma_m64n192k16<0, 1>(acc[0], adesc, bdesc, 1);
          if (has_hi) wgmma_m64n192k16<0, 1>(acc[1], adesc, bdesc + 384, 1);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(acc[0]);
          fence_regs(acc[1]);
        }
        if ((t & 31) == 0) mbar_arrive(empty + 8 * stage);
        ++done;
      }
    }

    // out = acc + b2, rounded to bf16
    const long long ra = row0 + r_lo, rb = ra + 8;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int j = 0; j < 24; ++j) {
        const int col = wgi * kSlab + h * 192 + 8 * j + cq;
        if (col < D) {
          const float2 bv = *reinterpret_cast<const float2*>(b2 + col);
          if (ra < N) {
            *reinterpret_cast<__nv_bfloat162*>(out + ra * D + col) =
                __floats2bfloat162_rn(acc[h][4 * j] + bv.x,
                                      acc[h][4 * j + 1] + bv.y);
          }
          if (rb < N) {
            *reinterpret_cast<__nv_bfloat162*>(out + rb * D + col) =
                __floats2bfloat162_rn(acc[h][4 * j + 2] + bv.x,
                                      acc[h][4 * j + 3] + bv.y);
          }
        }
      }
    }
  }
}

int launch(const bf16* x, const bf16* w1, const float* b1, const bf16* w2,
           const float* b2, bf16* out, long long N, int D, int H,
           cudaStream_t st) {
  const long long blocks = (N + BM - 1) / BM;
  if (N > 2147483647LL - 256) return (int)cudaErrorInvalidValue;
  CUtensorMap mx, mw1, mw2;
  int rc = tma_map_bf16(&mx, x, N, D, 64, 64, CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc == 0)
    rc = tma_map_bf16(&mw1, w1, D, H, kW1Depth, 32, CU_TENSOR_MAP_SWIZZLE_64B);
  if (rc == 0)
    rc = tma_map_bf16(&mw2, w2, H, D, 16, 64, CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc != 0) return rc;
  rc = (int)cudaFuncSetAttribute(
      mlp_fwd_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (rc != 0) return rc;
  mlp_fwd_wgmma<<<(unsigned)blocks, kWgThreads, SMEM, st>>>(
      mx, mw1, mw2, b1, b2, out, N, D, H);
  return (int)cudaGetLastError();
}

}  // namespace wg

// fp32: 16 rows to a block, scalar FMA. Xs is [16][W] (a chunk of D: all of
// it up to 1,280), Os [16][cols] (the block's output columns), As [16][64].
constexpr int FR = 16;
constexpr int FC = 64;

size_t smem_f32(int D) {
  return (size_t)(FR * depth_chunks(D).cols + FR * column_slices(D).cols +
                  FR * FC) * 4;
}

__global__ void __launch_bounds__(kThreads)
mlp_fwd_f32(const float* __restrict__ x, const float* __restrict__ w1,
            const float* __restrict__ b1, const float* __restrict__ w2,
            const float* __restrict__ b2, float* __restrict__ out,
            long long N, int D, int H, int cols) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Slices ch = depth_chunks(D);
  const int W = ch.cols;
  float* Xs = reinterpret_cast<float*>(smem);
  float* Os = Xs + FR * W;
  float* As = Os + FR * cols;
  const int tid = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * FR;
  const int c0 = blockIdx.y * cols;       // this block's output columns
  const int dc = min(cols, D - c0);

  if (ch.n == 1) load_rows<float, FR>(Xs, W, x, row0, N, D);
  for (int i = tid; i < FR * dc; i += kThreads) Os[i] = 0.f;
  __syncthreads();

  const int h = tid % FC;       // this thread's hidden column of a chunk
  const int rg = tid / FC;      // and its four rows
  for (int h0 = 0; h0 < H; h0 += FC) {
    const int hc = min(FC, H - h0);
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    for (int kc = 0; kc < D; kc += W) {
      const int kw = min(W, D - kc);
      if (ch.n > 1) {
        __syncthreads();
        load_cols<float, FR>(Xs, W, x, row0, N, D, kc, kw);
        __syncthreads();
      }
      if (h >= hc) continue;
      const float* wp = w1 + (long long)kc * H + h0 + h;
      for (int k = 0; k < kw; ++k) {
        const float w = wp[(long long)k * H];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = fmaf(Xs[(rg * 4 + i) * W + k], w, a[i]);
        }
      }
    }
    if (h < hc) {
      const float b = b1[h0 + h];
#pragma unroll
      for (int i = 0; i < 4; ++i) As[(rg * 4 + i) * FC + h] = gelu(a[i] + b);
    }
    __syncthreads();
    for (int d = tid; d < dc; d += kThreads) {
      float o[FR];
#pragma unroll
      for (int r = 0; r < FR; ++r) o[r] = Os[r * dc + d];
      const float* wp = w2 + (long long)h0 * D + c0 + d;
      for (int j = 0; j < hc; ++j) {
        const float w = wp[(long long)j * D];
#pragma unroll
        for (int r = 0; r < FR; ++r) o[r] = fmaf(As[r * FC + j], w, o[r]);
      }
#pragma unroll
      for (int r = 0; r < FR; ++r) Os[r * dc + d] = o[r];
    }
    __syncthreads();
  }
  for (int i = tid; i < FR * dc; i += kThreads) {
    const int r = i / dc, d = i % dc;
    if (row0 + r < N) out[(row0 + r) * D + c0 + d] = Os[i] + b2[c0 + d];
  }
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// x, out: [N, D]; w1: [D, H]; w2: [H, D], all contiguous, one type (is_bf16:
// 1 bfloat16, 0 float32) and 32-byte aligned; b1 [H], b2 [D] fp32. D and H
// multiples of 16; otherwise cudaErrorInvalidValue.
int pose3d_mlp_block_fwd(const void* x, const void* w1, const void* b1,
                         const void* w2, const void* b2, void* out,
                         int is_bf16, long long N, int D, int H,
                         void* stream) {
  if (N < 1 || D < 16 || H < 16 || D % 16 != 0 || H % 16 != 0 ||
      column_slices(D).n > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* fb1 = static_cast<const float*>(b1);
  const float* fb2 = static_cast<const float*>(b2);
  if (takes_wgmma(is_bf16, D)) {
    return wg::launch(static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
                      fb1, static_cast<const bf16*>(w2), fb2,
                      static_cast<bf16*>(out), N, D, H, st);
  }
  const Slices sl = column_slices(D);
  if (is_bf16) {
    const long long blocks = (N + BR - 1) / BR;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
    const size_t smem = smem_bf16(D);
    const int rc = set_smem(mlp_fwd_bf16, smem);
    if (rc != 0) return rc;
    mlp_fwd_bf16<<<dim3((unsigned)blocks, sl.n), kThreads, smem, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w1), fb1,
        static_cast<const bf16*>(w2), fb2, static_cast<bf16*>(out), N, D, H,
        sl.cols);
  } else {
    const long long blocks = (N + FR - 1) / FR;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
    const size_t smem = smem_f32(D);
    const int rc = set_smem(mlp_fwd_f32, smem);
    if (rc != 0) return rc;
    mlp_fwd_f32<<<dim3((unsigned)blocks, sl.n), kThreads, smem, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w1), fb1,
        static_cast<const float*>(w2), fb2, static_cast<float*>(out), N, D,
        H, sl.cols);
  }
  return (int)cudaGetLastError();
}

// What pose3d_mlp_block_fwd does for a shape, without launching: cfg[0] the
// path (0 scalar fp32, 1 WMMA, 2 wgmma), cfg[1] rows a block, cfg[2] blocks
// (row blocks times column slices), cfg[3] dynamic shared memory in bytes,
// cfg[4] column slices, cfg[5] columns a slice, cfg[6] the chunks D is
// streamed in, cfg[7] columns a chunk (1 and D on the wgmma path and up to
// 1,280). Returns 0.
int pose3d_mlp_block_fwd_config(int is_bf16, long long N, int D, int H,
                                int* cfg) {
  (void)H;
  const Slices sl = column_slices(D);   // one slice when D <= 768
  const Slices ch = depth_chunks(D);    // one chunk when D <= 1280
  cfg[6] = ch.n, cfg[7] = ch.cols;
  if (takes_wgmma(is_bf16, D)) {
    cfg[0] = kPathWgmma, cfg[1] = wg::BM, cfg[3] = (int)wg::SMEM;
  } else if (is_bf16) {
    cfg[0] = kPathWmma, cfg[1] = BR, cfg[3] = (int)smem_bf16(D);
  } else {
    cfg[0] = kPathScalar, cfg[1] = FR, cfg[3] = (int)smem_f32(D);
  }
  cfg[2] = (int)((N + cfg[1] - 1) / cfg[1]) * sl.n;
  cfg[4] = sl.n, cfg[5] = sl.cols;
  return 0;
}

const char* pose3d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
