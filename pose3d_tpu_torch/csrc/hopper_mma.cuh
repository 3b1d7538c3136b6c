// Hopper (sm_90a) GEMM building blocks shared by the tensor-core kernels of
// this directory: the shared-memory matrix descriptor and its swizzles,
// wgmma (warpgroup MMA, bf16 x bf16 -> fp32) with its fence / commit / wait,
// with A from shared memory or from registers, mbarriers, TMA tile loads with
// the host-side tensor map (2-D, or a strided 4-D view), 1-D bulk copies (the
// layer_norm forward's row ring), and the convention by which a multi-stage
// ring of tiles is walked. Small inline device functions around inline PTX;
// no framework, no library. It holds the forms its kernels call and no
// others: a kernel that needs another width adds that form here by the
// layouts below.
//
// ACCUMULATOR LAYOUT of an m64nN tile (N a multiple of 8), on which every
// epilogue depends. The 128 threads of a warpgroup hold D[64, N] in N/2
// floats each. With w = warp in the warpgroup (0..3), l = lane (0..31):
//     d[4*j + 0], d[4*j + 1]  ->  row 16*w + l/4,      cols 8*j + 2*(l%4) + {0, 1}
//     d[4*j + 2], d[4*j + 3]  ->  row 16*w + l/4 + 8,  the same two columns
// for j = 0 .. N/8 - 1. A row lives in the four lanes of one quad (l/4 fixed):
// a row reduction (a softmax's max and sum) is a loop over j plus two
// __shfl_xor_sync steps (1 and 2).
//
// A FRAGMENT LAYOUT of an m64k16 A operand taken from registers (the PTX
// form with {a0, a1, a2, a3} in A's place, wgmma_*_rs below; it takes one
// transpose immediate, B's): four 32-bit registers of two bf16 each,
//     a[0] -> row 16*w + l/4,     k = 2*(l%4) + {0, 1}
//     a[1] -> row 16*w + l/4 + 8, the same k
//     a[2], a[3] -> the same rows, k + 8.
// So the accumulator of an m64nN tile, rounded to bf16 pairs, is the A
// operand of a following product over those N columns with no exchange:
// k-step s takes d[8*s + 0..7] packed in that order (pack_bf16x2 of
// d[8s], d[8s+1]; of d[8s+2], d[8s+3]; ...).
//
// SHARED-MEMORY OPERAND LAYOUTS. A tile is stored as dense rows of 128, 64
// or 32 bytes (64, 32 or 16 bf16), 16-byte pieces XOR-swizzled by the row
// (swz64 below and its siblings; the pattern TMA writes with
// CU_TENSOR_MAP_SWIZZLE_128B / 64B / 32B when the tile starts on a multiple
// of 1024 bytes). The same bytes serve two ways:
//  * K-major operand (the rows are M or N, the row's bytes run along K): 8
//    rows form a group, SBO = 8 * row bytes to the next group; one k-step of
//    16 is 32 bytes further along the row (add 2 to the descriptor); a wider
//    K continues in the next tile of rows. LBO is not read.
//  * MN-major operand (the rows are K, the row's bytes run along M or N: the
//    transposed forms, TA / TB = 1): 8 k-rows form a group, SBO = 8 * row
//    bytes; one k-step of 16 is 16 rows further; an M or N wider than one
//    row continues in the next tile of rows, LBO bytes away.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hmma {

// ---- shared-memory addresses, swizzles, descriptors ------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset inside a tile (that starts on a multiple of 1024 bytes) of the
// byte at `off` = row * row_bytes + byte_in_row, for rows of 64 bytes: the
// 16-byte piece index is XORed with the row's low bits. Rows of 128 and of
// 32 bytes take the mask 0x70 and 0x10 in place of 0x30.
__device__ __forceinline__ uint32_t swz64(uint32_t off) {
  return off ^ ((off >> 3) & 0x30u);
}
__device__ __forceinline__ uint32_t swz128(uint32_t off) {
  return off ^ ((off >> 3) & 0x70u);
}

// The descriptor's layout field for each row width.
constexpr int kSwz128 = 1;
constexpr int kSwz64 = 2;
constexpr int kSwz32 = 3;

// 64-bit matrix descriptor: bits 0-13 start address / 16, 16-29 leading byte
// offset / 16, 32-45 stride byte offset / 16, 62-63 swizzle. Advance along a
// tile by adding bytes / 16 to the value.
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr, uint32_t lbo,
                                              uint32_t sbo, int swizzle) {
  return static_cast<uint64_t>((saddr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(swizzle) << 62);
}

// ---- wgmma -----------------------------------------------------------------

// Before the first wgmma of a batch, and after any register or shared-memory
// write that a wgmma will read.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most PENDING committed groups are still running.
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING)
               : "memory");
}
// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous instructions that own it.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// The same for A fragments in registers, which a wgmma reads until its wait.
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(a[i])::"memory");
}
// Two floats rounded to bf16 (round to nearest even) in one register, the
// first in the low half: one register of an A fragment.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// 2^x on the special-function unit (ex2.approx.ftz: about 2 ulp; 2^-inf is
// 0): the exponentials of a softmax, next to its products.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// Writes made with ordinary stores to shared memory become visible to wgmma
// and TMA (the asynchronous proxy) after this fence and a barrier.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// D[64, 32] (+)= A[64, 16] * B[16, 32], A and B through shared-memory
// descriptors; TA / TB: 0 = K-major, 1 = MN-major (transposed) operand.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], uint64_t a_desc,
                                                uint64_t b_desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, "
      "%16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a_desc), "l"(b_desc), "r"(scale_d), "n"(TA), "n"(TB));
}

// D[64, 64] (+)= A[64, 16] * B[16, 64], A and B through shared-memory
// descriptors; TA / TB: 0 = K-major, 1 = MN-major (transposed) operand.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t a_desc,
                                                uint64_t b_desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      " %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      " %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(a_desc), "l"(b_desc), "r"(scale_d), "n"(TA), "n"(TB));
}

// D[64, 128] (+)= A[64, 16] * B[16, 128], A and B through shared-memory
// descriptors; TA / TB as above.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a_desc,
                                                uint64_t b_desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      " %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      " %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40,"
      " %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53,"
      " %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a_desc), "l"(b_desc), "r"(scale_d), "n"(TA), "n"(TB));
}

// D[64, 64] (+)= A[64, 16] * B[16, 64] with A from registers (the fragment
// layout at the top) and B through a descriptor; TB as above.
template <int TB>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t b_desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      " %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      " %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(scale_d),
        "n"(TB));
}

// D[64, 192] (+)= A[64, 16] * B[16, 192], A and B through shared-memory
// descriptors; TA / TB: 0 = K-major, 1 = MN-major (transposed) operand.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n192k16(float (&d)[96], uint64_t a_desc,
                                                uint64_t b_desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      " %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
      " %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"
      " %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85,"
      " %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, p, 1, 1, %99, %100;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]),
        "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]),
        "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(a_desc), "l"(b_desc), "r"(scale_d), "n"(TA), "n"(TB));
}

// The index of this thread's warpgroup, through a shuffle so that the compiler
// knows it is the same in a whole warp: a wgmma under a branch that it cannot
// prove warp-uniform is serialized (ptxas C7520) and runs some sixty times
// slower.
__device__ __forceinline__ int warpgroup_index() {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x >> 7), 0);
}

// ---- barriers ----------------------------------------------------------------

// bar.sync among `threads` threads (a multiple of 32) on hardware barrier
// `id` (1..15; 0 is __syncthreads): a warpgroup, or all consumers, without
// stopping the producer.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(arrivals)
               : "memory");
}
// After the inits, before any thread (or TMA) uses the barriers.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// One arrival that also announces `bytes` of TMA traffic still to land.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
// Returns once the barrier has left the phase of parity `parity` (a barrier
// starts in phase 0; a wait on parity 1 passes at once on a fresh barrier).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// A ring of STAGES tiles needs no state but a count: tile number i (loads
// and uses both count from 0) lives in stage i % STAGES and its barriers are
// in the phase of parity (i / STAGES) & 1. The consumer of tile i waits
// full[stage] on that parity and, done with it, arrives empty[stage]; the
// producer waits empty[stage] on the opposite parity (its first round passes
// at once), announces the bytes on full[stage] and issues the loads.

// ---- loads -------------------------------------------------------------------

// TMA: the box of `map` whose first element is (column c0, row c1) lands at
// shared address `dst` (swizzled as the map says, out-of-bounds elements as
// zeros) and its bytes are counted on mbarrier `bar`. One thread issues it.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// The same for a 4-D map: the box whose first element is (c0, c1, c2, c3),
// innermost first.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// 1-D bulk copy (no tensor map): `bytes` (a multiple of 16) from global `src`
// land at shared address `dst` (both on 16 bytes), counted on mbarrier `bar`.
// One thread issues it.
__device__ __forceinline__ void bulk_load_1d(uint32_t dst, const void* src,
                                             uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// TMA reduction: the fp32 tile at shared address `src` (laid out and
// swizzled as `map` says) is added element by element into the box of `map`
// whose first element is (c0, c1, c2, c3); elements out of bounds are
// skipped. The issuing thread tracks it in its bulk groups: bulk_commit
// closes a group, bulk_wait_read<N> returns once at most N groups still read
// shared memory (a tile may then be rewritten), bulk_wait<0> once every
// group has completed.
__device__ __forceinline__ void tma_reduce_add_4d(const CUtensorMap* map,
                                                  uint32_t src, int c0, int c1,
                                                  int c2, int c3) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.4d.global.shared::cta.add.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// setmaxnreg: a warpgroup gives registers back / takes more (multiples of 8).
template <int REGS>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}
template <int REGS>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// ---- host: tensor maps ---------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so that nothing links libcuda.
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) != cudaSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault) != cudaSuccess)
      p = nullptr;
#endif
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// Tensor map of a strided view of `rank` (<= 5) dimensions at `ptr` (16-byte
// aligned): dims[i] elements along dimension i (innermost first, contiguous),
// strides[i] bytes between neighbours along dimension i + 1 (multiples of 16),
// read in boxes of box[i] elements (box[0] * element bytes <= the swizzle's
// row width, each <= 256; a box may reach past a dimension's end: those
// elements arrive as zeros). Returns 0 or a cudaError_t.
inline int tma_map(CUtensorMap* map, CUtensorMapDataType type, int rank,
                   const void* ptr, const uint64_t* dims,
                   const uint64_t* strides, const uint32_t* box,
                   CUtensorMapSwizzle swizzle) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  cuuint64_t d[5], st[4];
  cuuint32_t b[5], elem[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    elem[i] = 1;
    if (i + 1 < rank) st[i] = strides[i];
  }
  const CUresult rc =
      fn(map, type, static_cast<cuuint32_t>(rank), const_cast<void*>(ptr), d,
         st, b, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Tensor map of a contiguous bf16 matrix [rows, cols] at `ptr` (16-byte
// aligned, cols a multiple of 8) read in boxes of [box_rows, box_cols]
// (box_cols * 2 bytes = the swizzle's row width, box_rows <= 256). Returns 0
// or a cudaError_t.
inline int tma_map_bf16(CUtensorMap* map, const void* ptr, uint64_t rows,
                        uint64_t cols, uint32_t box_rows, uint32_t box_cols,
                        CUtensorMapSwizzle swizzle) {
  const uint64_t dims[2] = {cols, rows};
  const uint64_t strides[1] = {cols * 2};
  const uint32_t box[2] = {box_cols, box_rows};
  return tma_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ptr, dims, strides,
                 box, swizzle);
}

}  // namespace hmma
