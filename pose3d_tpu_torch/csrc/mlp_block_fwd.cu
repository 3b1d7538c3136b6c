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
// Design (a simple kernel that is right comes first; wgmma, TMA and
// pipelined loads are later work):
//  * the TPU kernel keeps both weight matrices resident in VMEM (18.9 MB)
//    under 256-row tiles. Nothing like that fits an SM; the 9.4 MB of bf16
//    weights stay in the 50 MB L2 instead, and every row tile streams them
//    from there;
//  * what decides the tiling is where the [rows, D] fp32 output accumulator
//    lives while the block walks the hidden axis: 64 rows at D = 768 are
//    196 KB, more than the registers of an SM can spare beside anything
//    else. So a block takes 32 rows and keeps their output in WMMA
//    accumulator fragments in registers, spread over its eight warps: each
//    warp owns up to six 16-column stripes for both 16-row halves (96
//    registers a thread at D = 768, hence D <= 768). The alternative, a grid
//    that also splits D, would recompute x W1 once per split;
//  * the hidden axis goes by in chunks of 128: x W1 for the chunk (A from
//    the x tile in shared memory, B fragments of W1 straight from L2) lands
//    in shared memory in fp32, all threads add b1, apply GELU and round to
//    bf16, then ga W2 adds into the register accumulators (B fragments of W2
//    straight from L2). Loading B fragments from global memory needs no
//    staging and no synchronisation beyond the two per chunk; it leaves the
//    load latency to the eight warps, which is the price of simplicity;
//  * bf16 uses WMMA m16n16k16 with fp32 accumulation; D and H must be
//    multiples of 16. fp32 inputs would drop to TF32 on the tensor cores, so
//    the fp32 path is a scalar-FMA tile of 16 rows: slow and right;
//  * ragged rows: the x tile's rows >= N are zero-filled and never stored.

#include <mma.h>

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
  return (size_t)BR * (D + 8) * 2 + (size_t)BR * LDA * 4 +
         (size_t)BR * LDG * 2;
}

__global__ void __launch_bounds__(kThreads, 1)
mlp_fwd_bf16(const bf16* __restrict__ x, const bf16* __restrict__ w1,
             const float* __restrict__ b1, const bf16* __restrict__ w2,
             const float* __restrict__ b2, bf16* __restrict__ out,
             long long N, int D, int H) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int LDX = D + 8;
  bf16* Xs = reinterpret_cast<bf16*>(smem);
  float* As = reinterpret_cast<float*>(Xs + BR * LDX);
  bf16* Gs = reinterpret_cast<bf16*>(As + BR * LDA);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const long long row0 = (long long)blockIdx.x * BR;
  const int nfrag = D / 16;

  load_rows<bf16, BR>(Xs, LDX, x, row0, N, D);

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
    // a = x W1[:, h0 : h0 + hc] for this warp's two fragments
    {
      const bool doa = cfa * 16 < hc, dob = cfb * 16 < hc;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> pa, pb;
      wmma::fill_fragment(pa, 0.f);
      wmma::fill_fragment(pb, 0.f);
      if (doa) {
        const bf16* wa = w1 + h0 + cfa * 16;
        const bf16* wb = w1 + h0 + cfb * 16;
#pragma unroll 4
        for (int k = 0; k < nfrag; ++k) {
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
    // out += ga W2[h0 : h0 + hc, :]
    for (int kk = 0; kk < hc / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> g0, g1;
      wmma::load_matrix_sync(g0, Gs + kk * 16, LDG);
      wmma::load_matrix_sync(g1, Gs + 16 * LDG + kk * 16, LDG);
      const bf16* wrow = w2 + (long long)(h0 + kk * 16) * D;
#pragma unroll
      for (int i = 0; i < kMaxFrags; ++i) {
        const int cf = warp + kWarps * i;
        if (cf < nfrag) {
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
    if (cf < nfrag) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        wmma::store_matrix_sync(patch, acc[h][i], 16, wmma::mem_row_major);
        __syncwarp();
        const long long r = row0 + h * 16 + pr;
        if (r < N) {
          const int col = cf * 16 + pc;
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

// fp32: 16 rows to a block, scalar FMA. Xs and Os are [16][D], As [16][64].
constexpr int FR = 16;
constexpr int FC = 64;

size_t smem_f32(int D) { return (size_t)(2 * FR * D + FR * FC) * 4; }

__global__ void __launch_bounds__(kThreads)
mlp_fwd_f32(const float* __restrict__ x, const float* __restrict__ w1,
            const float* __restrict__ b1, const float* __restrict__ w2,
            const float* __restrict__ b2, float* __restrict__ out,
            long long N, int D, int H) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* Xs = reinterpret_cast<float*>(smem);
  float* Os = Xs + FR * D;
  float* As = Os + FR * D;
  const int tid = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * FR;

  load_rows<float, FR>(Xs, D, x, row0, N, D);
  for (int i = tid; i < FR * D; i += kThreads) Os[i] = 0.f;
  __syncthreads();

  const int h = tid % FC;       // this thread's hidden column of a chunk
  const int rg = tid / FC;      // and its four rows
  for (int h0 = 0; h0 < H; h0 += FC) {
    const int hc = min(FC, H - h0);
    if (h < hc) {
      float a[4] = {0.f, 0.f, 0.f, 0.f};
      const float* wp = w1 + h0 + h;
      for (int k = 0; k < D; ++k) {
        const float w = wp[(long long)k * H];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = fmaf(Xs[(rg * 4 + i) * D + k], w, a[i]);
        }
      }
      const float b = b1[h0 + h];
#pragma unroll
      for (int i = 0; i < 4; ++i) As[(rg * 4 + i) * FC + h] = gelu(a[i] + b);
    }
    __syncthreads();
    for (int d = tid; d < D; d += kThreads) {
      float o[FR];
#pragma unroll
      for (int r = 0; r < FR; ++r) o[r] = Os[r * D + d];
      const float* wp = w2 + (long long)h0 * D + d;
      for (int j = 0; j < hc; ++j) {
        const float w = wp[(long long)j * D];
#pragma unroll
        for (int r = 0; r < FR; ++r) o[r] = fmaf(As[r * FC + j], w, o[r]);
      }
#pragma unroll
      for (int r = 0; r < FR; ++r) Os[r * D + d] = o[r];
    }
    __syncthreads();
  }
  for (int i = tid; i < FR * D; i += kThreads) {
    const int r = i / D, d = i % D;
    if (row0 + r < N) out[(row0 + r) * D + d] = Os[i] + b2[d];
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
// multiples of 16, D <= 768; otherwise cudaErrorInvalidValue.
int pose3d_mlp_block_fwd(const void* x, const void* w1, const void* b1,
                         const void* w2, const void* b2, void* out,
                         int is_bf16, long long N, int D, int H,
                         void* stream) {
  if (N < 1 || D < 16 || H < 16 || D % 16 != 0 || H % 16 != 0 || D > kMaxD)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* fb1 = static_cast<const float*>(b1);
  const float* fb2 = static_cast<const float*>(b2);
  if (is_bf16) {
    const long long blocks = (N + BR - 1) / BR;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
    const size_t smem = smem_bf16(D);
    const int rc = set_smem(mlp_fwd_bf16, smem);
    if (rc != 0) return rc;
    mlp_fwd_bf16<<<(unsigned)blocks, kThreads, smem, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w1), fb1,
        static_cast<const bf16*>(w2), fb2, static_cast<bf16*>(out), N, D, H);
  } else {
    const long long blocks = (N + FR - 1) / FR;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
    const size_t smem = smem_f32(D);
    const int rc = set_smem(mlp_fwd_f32, smem);
    if (rc != 0) return rc;
    mlp_fwd_f32<<<(unsigned)blocks, kThreads, smem, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w1), fb1,
        static_cast<const float*>(w2), fb2, static_cast<float*>(out), N, D,
        H);
  }
  return (int)cudaGetLastError();
}

const char* pose3d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
