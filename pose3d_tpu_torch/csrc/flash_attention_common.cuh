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
