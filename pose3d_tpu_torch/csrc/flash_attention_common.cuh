// Shared by flash_attention_fwd.cu and flash_attention_bwd.cu: the (D, Dv)
// pairs both sources build, the shapes their wgmma kernels take, and the
// tensor map over a strided [B, T, H, D] bf16 view that those kernels read.
#pragma once

#include "hopper_mma.cuh"

namespace attn {

// The (D, Dv) pairs built: D = Dv at the depths of the lifter and of the
// stage-1 models, YOLO11's PSA attention (key depth half the value depth),
// D = Dv = 16 (a lifter of embed 64 over 4 heads) and D = Dv = 256, the
// widest; the wrappers zero-pad any other pair up to the smallest built pair
// that holds it. Returns the pair's index, or -1.
constexpr int kPairs = 7;
inline int pair_index(int D, int Dv) {
  const int pairs[kPairs][2] = {{32, 32}, {48, 48}, {64, 64}, {128, 128},
                                {32, 64}, {16, 16}, {256, 256}};
  for (int i = 0; i < kPairs; ++i)
    if (pairs[i][0] == D && pairs[i][1] == Dv) return i;
  return -1;
}

// The deep instance of the WMMA and fp32 kernels: D or Dv above 256, both
// multiples of kDeepChunk (the wrappers zero-pad them), with the depths a
// runtime loop bound. Scores are summed over D (and the backward's dP over
// Dv) in chunks of kDeepChunk columns staged through shared memory in a
// fixed order; output columns go to blocks in slices of kDeepSlice on
// gridDim.y (H x slices), each slice recomputing the scores over all of D,
// so that every slice sees the same P.
constexpr int kDeepChunk = 64;
constexpr int kDeepSlice = 128;
inline bool deep_pair(int D, int Dv) {
  return D >= kDeepChunk && Dv >= kDeepChunk && D % kDeepChunk == 0 &&
         Dv % kDeepChunk == 0 && (D > 256 || Dv > 256);
}
// The forward slices Dv (o's columns); the backward slices D and Dv
// together (slice s owns dQ's and dK's columns [s, s + 1) * kDeepSlice of D
// and dV's of Dv, where they exist).
inline int deep_fwd_slices(int Dv) {
  return (Dv + kDeepSlice - 1) / kDeepSlice;
}
inline int deep_bwd_slices(int D, int Dv) {
  return ((D > Dv ? D : Dv) + kDeepSlice - 1) / kDeepSlice;
}

// Rows [row0, row0 + ROWS) of a [T, width] window of a strided [T, ...]
// slice (token stride st; src points at the window's first column) into a
// shared tile of pitch ld, 16 bytes at a time by NT threads; rows >= nrows
// become 0. width * sizeof(T), ld * sizeof(T), st * sizeof(T) and src's
// address are multiples of 16.
template <typename T, int ROWS, int NT>
__device__ __forceinline__ void load_window(T* dst, int ld, const T* src,
                                            long long st, int row0, int nrows,
                                            int width) {
  constexpr int VEC = 16 / sizeof(T);
  const int vpr = width / VEC;
  for (int i = threadIdx.x; i < ROWS * vpr; i += NT) {
    const int r = i / vpr;
    const int c = (i % vpr) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    const int t = row0 + r;
    if (t < nrows) {
      val = *reinterpret_cast<const uint4*>(src + (long long)t * st + c);
    }
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// The wgmma kernels take bf16 at the lifter's depths, D = Dv in {48, 64}.
constexpr bool wgmma_depth(int D, int Dv) {
  return D == Dv && (D == 48 || D == 64);
}

// A 4-D map {D, H, T, B} over a strided [B, T, H, D] bf16 view (element
// strides), boxes of [rows, 64 columns] of one (batch, head): columns past D
// and rows past T arrive as zeros. A stride of a dimension of extent 1 is
// never used; it is given its packed value, which the encoder accepts.
inline int map_bthd(CUtensorMap* map, const void* ptr, int B, int T, int H,
                    int D, long long sb, long long st, long long sh,
                    int rows) {
  if (H == 1) sh = D;
  if (T == 1) st = sh * H;
  if (B == 1) sb = st * T;
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)H, (uint64_t)T,
                            (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)sh * 2, (uint64_t)st * 2,
                               (uint64_t)sb * 2};
  const uint32_t box[4] = {64, 1, (uint32_t)rows, 1};
  return hmma::tma_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, ptr, dims,
                       strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace attn
