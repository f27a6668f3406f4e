// Tensor-core conv stage for int8 operands on Hopper (sm_90a): the wgmma
// of one 64-row M-tile of a SAME 3x3 conv as an implicit GEMM, both
// operands from shared memory (wgmma.mma_async m64n64k32 .s32.s8.s8 with
// an A and a B descriptor), for conv12_fused.cu's conv2 and the int8
// instances that follow it onto the tensor cores.
//
// Per M-tile: 9 taps x CIN / 32 k-steps, each one wgmma m64n64k32 that
// adds 64 rows x 32 input channels x 64 output channels into ONE int32
// accumulator (32 registers a thread, the m64n64 accumulator layout), all
// in one commit group: no partial sums, and the caller chooses when to
// wait (two M-tiles in flight let one's epilogue run under the other's
// products). Layouts, K-major without swizzle, in core matrices of 8
// rows x 16 bytes:
// - A, the input tile in planes: the 16-byte chunk c (channels 16 c ..
//   16 c + 15) of tile pixel p lies at plane c, byte 16 p. An M-tile is
//   an 8 x 8 pixel block; its core matrix i (M rows 8 i .. 8 i + 7) is
//   block row i, 8 consecutive pixels of one plane (128 contiguous
//   bytes), so the descriptor's stride byte offset (along M) is the
//   tile's row pitch, 16 tw, and its leading byte offset (along K) the
//   plane size. A tap (dy, dx) moves the start address by 16 (dy tw + dx)
//   bytes: the 3x3 window and the halo need no copies and no registers.
// - B, one tap's CIN x 64 slab (_build.pack_slabs of int8 weights):
//   leading byte offset 128 (along K), stride byte offset 8 CIN (along N).
// A thread's two accumulator rows (lane / 4 and lane / 4 + 8 of its
// warp's 16) are then block rows 2 warp and 2 warp + 1 at column lane /
// 4: vertical neighbours, and the horizontal ones sit in lane ^ 4.
// A from registers (ldmatrix out of a pixel-major tile) would hold 72
// registers a thread at CIN 64 and spend issue slots on the loads; from
// shared memory the warpgroup issues only the 18 wgmma.
//
// Numerics: int8 products and int32 sums are exact in any order (at CIN
// 64 |acc| <= 576 * 127 * 127 = 9.29e6 < 2^31), so the result equals the
// plain version's integer sums bit for bit.
#pragma once

#include "conv_tc.cuh"

namespace spnerf {
namespace tc {

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving int32 accumulator reads or writes across
// a wgmma fence or wait
template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
  #pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D (64 x 64, int32, the wgmma accumulator layout) = A (64 x 32 int8) *
// B (32 x 64 int8), both from shared memory through the descriptors
// desc_a + OA and desc_b + OB (the offsets added inside the asm, so that
// the compiler holds no precomputed descriptor in registers), + D unless
// SCALE_D is 0
template <int OA, int OB, int SCALE_D>
__device__ __forceinline__ void wgmma_s8_ss(int (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 da, db;\nsetp.ne.b32 p, %36, 0;\n"
      "add.s64 da, %32, %34;\nadd.s64 db, %33, %35;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, da, db, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(desc_a), "l"(desc_b), "n"(OA), "n"(OB), "r"(SCALE_D));
}

// The k-steps s .. 9 CIN / 32 - 1 of s8_conv3x3_issue, one wgmma each
// (a template recursion: the offsets are immediates)
template <int CIN, int TW, int PLANE, int SLAB, int S>
__device__ __forceinline__ void s8_conv3x3_steps(int (&acc)[32], uint64_t da, uint64_t db) {
  if constexpr (S < 9 * CIN / 32) {
    constexpr int KS = CIN / 32, TAP = S / KS, K = S % KS;
    wgmma_s8_ss<(2 * K * PLANE + ((TAP / 3) * TW + TAP % 3) * 16) / 16,
                (TAP * SLAB + K * 256) / 16, S == 0 ? 0 : 1>(acc, da, db);
    s8_conv3x3_steps<CIN, TW, PLANE, SLAB, S + 1>(acc, da, db);
  }
}

// Issue the SAME 3x3 conv of one M-tile, CIN int8 input channels x 64
// output channels, into acc (overwritten), as one commit group; the
// caller waits (wgmma_wait) before it reads acc. a_addr: shared address
// of plane 0 at the tile pixel of the block's top-left output, tap (0,
// 0) (planes PLANE bytes apart, TW pixels a row); b_addr: the slab of tap
// 0, the taps' slabs SLAB bytes apart. Each wgmma's descriptors are the
// first ones plus a constant (the 14-bit start address field, in 16-byte
// units, cannot carry out below 256 KB). Called by all 128 threads of a
// warpgroup.
template <int CIN, int TW, int PLANE, int SLAB>
__device__ __forceinline__ void s8_conv3x3_issue(uint32_t a_addr, uint32_t b_addr,
                                                 int (&acc)[32]) {
  static_assert(PLANE % 16 == 0 && SLAB % 16 == 0, "descriptor offsets in 16-byte units");
  wgmma_fence();
  s8_conv3x3_steps<CIN, TW, PLANE, SLAB, 0>(acc, smem_desc(a_addr, PLANE, TW * 16),
                                            smem_desc(b_addr, 128, CIN * 8));
  wgmma_commit();
}

}  // namespace tc
}  // namespace spnerf
