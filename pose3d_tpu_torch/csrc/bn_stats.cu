// Per-channel moments for BatchNorm statistics on Hopper (sm_90a).
//
// Replaces pose3d_tpu/ops/pallas/bn_stats.py::_stats_kernel (launched by
// pl.pallas_call in _stats_impl). For a row-major [n, C] view of a conv
// activation (bf16 or fp32, row stride `ld` elements, channels contiguous)
// it computes, with fp32 accumulation and in one read of x,
//   s1[c] = sum_r x[r, c],   s2[c] = sum_r x[r, c]^2     (fp32 [C] each),
// for any n >= 1. The backward is closed-form (dx = g1 + 2 x g2) and has no
// kernel, as on the TPU.
//
// What bounds it on this card. 3 operations per element against 2 (bf16) or
// 4 (fp32) bytes read: far below the ~20 fp32 operations per byte at which
// the card's fp32 rate, not its memory, would be the limit. So the work is
// bound by bytes: n*C*itemsize over the memory rate (the stem's [625000, 64]
// bf16 at microbatch 10: 80 MB, 0.024 ms). To hold that rate the card needs
// a few MB of reads in flight, ~32 KB on each SM; and the CNN's path gives
// it 13 shapes from 1 to 120 MB, half of its calls at 10,240 rows, where a
// launch or a serial tail costs as much as the reads.
//
// Design:
//  * the TPU kernel walks row tiles in sequence on one core and carries an
//    [8, C] accumulator from one grid step to the next. Here the columns are
//    cut into tiles of 8 threads x 16 bytes (64 bf16 / 32 fp32 channels) and
//    the rows into P runs of whole batches; block (tile, k) reduces run k of
//    its tile. The grid (tiles, P) is at most 396 blocks, three resident on
//    each of the 132 SMs, so every block starts at once;
//  * the stream: a block is 32 row lanes x 8 column threads, each thread
//    loads 16 bytes from each of 8 rows before it adds any (kUnroll): 32 KB
//    of reads in flight a block, up to 96 KB an SM, at every shape whose
//    rows fill a batch. Neighbouring threads read neighbouring 16 bytes of a
//    row;
//  * one launch a call: the block folds its row lanes (warp shuffles, then
//    the eight warps through shared memory, in a fixed order), writes one
//    partial row [s1 | s2] of its tile, and after a barrier of the tile's
//    blocks each adds a share of the tile's columns over all its partial
//    rows (row_reduce.cuh: a cooperative launch, a fixed order of addition,
//    no atomics in any sum). A shape's sums are the same from run to run;
//  * where the base address, the row stride or C rule out 16-byte reads, one
//    channel per thread (VEC = 1) on the same plan: correct, not fast.
//
// pose3d_bn_stats_config reports the plan; ops/kernels/bn_stats.py mirrors it
// in Python to size the scratch and counters.

#include <cstdint>

#include "row_reduce.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTx = 8;                   // threads along a tile's channels
constexpr int kTy = kThreads / kTx;      // row lanes
constexpr int kUnroll = 8;               // rows a lane has in flight
constexpr int kBatch = kTy * kUnroll;    // rows a block has in flight
constexpr int kPerSM = 3;                // resident blocks an SM
constexpr int kMaxBlocks = kPerSM * 132;

struct Plan {
  int vec, tiles, P;
  long long rpb;            // rows of a block's run, a multiple of kBatch
  long long scratch_floats, counters;
};

Plan make_plan(long long n, int C, int is_bf16, int aligned) {
  Plan p;
  const int full = is_bf16 ? 8 : 4;
  p.vec = aligned && C % full == 0 ? full : 1;
  const int width = kTx * p.vec;
  p.tiles = (C + width - 1) / width;
  const long long batches = (n + kBatch - 1) / kBatch;
  const long long most = kMaxBlocks / p.tiles > 1 ? kMaxBlocks / p.tiles : 1;
  const long long per_block = (batches + most - 1) / most;
  p.P = (int)((batches + per_block - 1) / per_block);
  p.rpb = per_block * kBatch;
  p.scratch_floats = (long long)p.tiles * p.P * 2 * width;
  p.counters = 2LL * p.tiles;
  return p;
}

// grid (tiles, P), block kThreads. Block (tile, k) reduces rows
// [k*rpb, min(n, (k+1)*rpb)) of channels [tile*8*VEC, (tile+1)*8*VEC) into
// partial row k of its tile: [s1 of the tile's channels | s2 of them].
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, kPerSM)
bn_stats_kernel(const T* __restrict__ x, float* __restrict__ s1,
                float* __restrict__ s2, float* __restrict__ scratch,
                unsigned* __restrict__ counters, long long n, int C,
                long long ld, long long rpb, int P) {
  constexpr int CT = kTx * VEC;   // channels of a tile
  constexpr int W = 2 * CT;       // floats of a partial row
  __shared__ float fold[kThreads / 32][W];
  __shared__ float4 cbuf[kThreads];
  const int tx = threadIdx.x % kTx, ty = threadIdx.x / kTx;
  const int tile = blockIdx.x, k = blockIdx.y;
  const int c0 = tile * CT + tx * VEC;
  const long long r0 = (long long)k * rpb;
  const long long r1 = min(r0 + rpb, n);

  float a1[VEC], a2[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) a1[i] = a2[i] = 0.f;
  // VEC > 1 only when C % VEC == 0, so a vector is inside C or outside it
  if (c0 < C) {
    const T* base = x + c0;
    for (long long r = r0 + ty; r < r1; r += kBatch) {
      typename rr::Packed<T, VEC>::type v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long ru = r + (long long)u * kTy;
        v[u] = ru < r1 ? rr::Packed<T, VEC>::load(base + ru * ld) : rr::Packed<T, VEC>::zero();
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float f[VEC];
        rr::Packed<T, VEC>::unpack(v[u], f);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          a1[i] += f[i];
          a2[i] = fmaf(f[i], f[i], a2[i]);
        }
      }
    }
  }

  // fold the warp's four row lanes (lanes 8 and 16 apart), then the warps
#pragma unroll
  for (int off = kTx; off < 32; off <<= 1) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      a1[i] += __shfl_xor_sync(0xffffffffu, a1[i], off);
      a2[i] += __shfl_xor_sync(0xffffffffu, a2[i], off);
    }
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane < kTx) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      fold[warp][lane * VEC + i] = a1[i];
      fold[warp][CT + lane * VEC + i] = a2[i];
    }
  }
  __syncthreads();
  float* rows = scratch + (long long)tile * P * W;
  if (threadIdx.x < W) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) s += fold[w][threadIdx.x];
    rows[(long long)k * W + threadIdx.x] = s;
  }
  const int cbase = tile * CT;
  auto store = [&](int q, const float4& v) {
    const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = 4 * q + j;
      const int c = cbase + col % CT;
      if (c < C) (col < CT ? s1 : s2)[c] = e[j];
    }
  };
  rr::combine<kThreads>(rows, counters + 2LL * tile, P, W, k, cbuf, store);
}

template <typename T, int VEC>
int launch(const void* x, float* s1, float* s2, float* scratch,
           unsigned* counters, long long n, int C, long long ld,
           const Plan& p, cudaStream_t stream) {
  return rr::launch(p.P > 1, bn_stats_kernel<T, VEC>, dim3(p.tiles, p.P),
                    dim3(kThreads), stream, static_cast<const T*>(x), s1, s2,
                    scratch, counters, n, C, ld, p.rpb, p.P);
}

// The kernel a plan launches, for its attributes.
const void* kernel_for(int is_bf16, int vec) {
  if (is_bf16) {
    return vec == 8 ? (const void*)bn_stats_kernel<__nv_bfloat16, 8>
                    : (const void*)bn_stats_kernel<__nv_bfloat16, 1>;
  }
  return vec == 4 ? (const void*)bn_stats_kernel<float, 4>
                  : (const void*)bn_stats_kernel<float, 1>;
}

}  // namespace

extern "C" {

// The plan of a launch: cfg[0] vec (channels a thread reads at once), [1]
// column tiles, [2] row runs P, [3] rows a run, [4] resident blocks an SM
// the kernel is built for, [5] scratch floats, [6] counters, [7] launches a
// call (1), [8] the kernel's static shared memory in bytes, as built.
// aligned: x's address and ld * itemsize are multiples of 16 bytes.
int pose3d_bn_stats_config(long long n, int C, int is_bf16, int aligned,
                           long long* cfg) {
  if (n < 1 || C < 1) return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(n, C, is_bf16, aligned);
  cfg[0] = p.vec, cfg[1] = p.tiles, cfg[2] = p.P, cfg[3] = p.rpb;
  cfg[4] = kPerSM, cfg[5] = p.scratch_floats, cfg[6] = p.counters;
  cfg[7] = 1;
  cudaFuncAttributes fa;
  const cudaError_t err = cudaFuncGetAttributes(&fa, kernel_for(is_bf16, p.vec));
  cfg[8] = (long long)fa.sharedSizeBytes;
  return (int)err;
}

// Launches one kernel on `stream` and returns cudaGetLastError() (0 on
// success). x: [n, C] with row stride ld (elements) and contiguous
// channels; s1, s2: fp32 [C]; scratch: fp32, scratch_floats of them;
// counters: n_counters unsigned ints, 0 on entry and left 0 (one buffer for
// each stream: see row_reduce.cuh). is_bf16: 1 for bfloat16, 0 for float32.
// The plan is pose3d_bn_stats_config's; scratch or counters smaller than it
// needs, and arguments the kernel does not take, return
// cudaErrorInvalidValue.
int pose3d_bn_stats(const void* x, void* s1, void* s2, void* scratch,
                    long long scratch_floats, void* counters,
                    long long n_counters, int is_bf16, long long n, int C,
                    long long ld, void* stream) {
  if (n < 1 || C < 1 || (n > 1 && ld < C)) return (int)cudaErrorInvalidValue;
  const int itemsize = is_bf16 ? 2 : 4;
  const int aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                      (ld * itemsize) % 16 == 0;
  const Plan p = make_plan(n, C, is_bf16, aligned);
  if (scratch_floats < p.scratch_floats || n_counters < p.counters)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* f1 = static_cast<float*>(s1);
  float* f2 = static_cast<float*>(s2);
  float* sc = static_cast<float*>(scratch);
  unsigned* ct = static_cast<unsigned*>(counters);
  if (is_bf16) {
    if (p.vec == 8)
      return launch<__nv_bfloat16, 8>(x, f1, f2, sc, ct, n, C, ld, p, st);
    return launch<__nv_bfloat16, 1>(x, f1, f2, sc, ct, n, C, ld, p, st);
  }
  if (p.vec == 4) return launch<float, 4>(x, f1, f2, sc, ct, n, C, ld, p, st);
  return launch<float, 1>(x, f1, f2, sc, ct, n, C, ld, p, st);
}

const char* pose3d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
