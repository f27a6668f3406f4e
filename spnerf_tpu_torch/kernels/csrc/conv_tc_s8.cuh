// Tensor-core conv stage for int8 operands on Hopper (sm_90a): the wgmma
// of one 64-row M-tile of a SAME 3x3 conv as an implicit GEMM, both
// operands from shared memory (wgmma.mma_async m64n64k32 .s32.s8.s8 with
// an A and a B descriptor), for conv12_fused.cu's conv2 (all nine taps at
// once, s8_conv3x3_issue) and the int8 instances of double_conv3x3.cu and
// head.cu (one tap at a time, s8_tap_issue, with the M stride of the A
// core matrices a parameter, and slabs streamed through S8Ring).
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
// scale_d is 0
template <int OA, int OB>
__device__ __forceinline__ void wgmma_s8_ss(int (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                            int scale_d) {
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
      : "l"(desc_a), "l"(desc_b), "n"(OA), "n"(OB), "r"(scale_d));
}

// The k-steps s .. 9 CIN / 32 - 1 of s8_conv3x3_issue, one wgmma each
// (a template recursion: the offsets are immediates)
template <int CIN, int TW, int PLANE, int SLAB, int S>
__device__ __forceinline__ void s8_conv3x3_steps(int (&acc)[32], uint64_t da, uint64_t db) {
  if constexpr (S < 9 * CIN / 32) {
    constexpr int KS = CIN / 32, TAP = S / KS, K = S % KS;
    wgmma_s8_ss<(2 * K * PLANE + ((TAP / 3) * TW + TAP % 3) * 16) / 16,
                (TAP * SLAB + K * 256) / 16>(acc, da, db, S == 0 ? 0 : 1);
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


// ---- one tap at a time (double_conv3x3.cu, head.cu) ----

// The same at N 80: the detector head's 65 lanes padded to the narrowest
// int8 wgmma width that holds them (for .s8, N steps by 8 up to 32, then
// by 16). The m64nN accumulator layout: d[4 j + 2 h + e] is row g + 8 h
// of the warp's 16, column 8 j + 2 (lane % 4) + e.
template <int OA, int OB>
__device__ __forceinline__ void wgmma_s8_ss_n80(int (&d)[40], uint64_t desc_a, uint64_t desc_b,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 da, db;\nsetp.ne.b32 p, %44, 0;\n"
      "add.s64 da, %40, %42;\nadd.s64 db, %41, %43;\n"
      "wgmma.mma_async.sync.aligned.m64n80k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, da, db, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39])
      : "l"(desc_a), "l"(desc_b), "n"(OA), "n"(OB), "r"(scale_d));
}

// The same at N 128 and 256: one wgmma reads A once for 128 or 256 output
// channels (an m64n64 step reads 2 KB of A and 2 KB of B for 32 tensor
// clocks, shared memory's whole 128 bytes a clock; n128 needs 94, n256
// 80). The accumulator is the m64n64 layout repeated: d[32 c ..] holds
// channels 64 c .. 64 c + 63.
template <int OA, int OB>
__device__ __forceinline__ void wgmma_s8_ss_n128(int (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 da, db;\nsetp.ne.b32 p, %68, 0;\n"
      "add.s64 da, %64, %66;\nadd.s64 db, %65, %67;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, da, db, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),
        "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),
        "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),
        "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "n"(OA), "n"(OB), "r"(scale_d));
}

template <int OA, int OB>
__device__ __forceinline__ void wgmma_s8_ss_n256(int (&d)[128], uint64_t desc_a, uint64_t desc_b,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 da, db;\nsetp.ne.b32 p, %132, 0;\n"
      "add.s64 da, %128, %130;\nadd.s64 db, %129, %131;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, da, db, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),
        "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),
        "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),
        "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]),
        "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), "+r"(d[72]),
        "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]),
        "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]),
        "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), "+r"(d[96]),
        "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]),
        "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]),
        "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]),
        "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]), "+r"(d[120]),
        "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]),
        "+r"(d[127])
      : "l"(desc_a), "l"(desc_b), "n"(OA), "n"(OB), "r"(scale_d));
}

// one m64nNk32 s8 wgmma (N 64, 128 or 256) with immediate offsets
template <int N, int OA, int OB>
__device__ __forceinline__ void wgmma_s8_n(int (&d)[N / 2], uint64_t da, uint64_t db,
                                           int scale_d) {
  if constexpr (N == 64)
    wgmma_s8_ss<OA, OB>(d, da, db, scale_d);
  else if constexpr (N == 128)
    wgmma_s8_ss_n128<OA, OB>(d, da, db, scale_d);
  else
    wgmma_s8_ss_n256<OA, OB>(d, da, db, scale_d);
}

// The CIN / 32 k-steps K .. of one tap: k-step K reads planes 2 K and
// 2 K + 1 of A and the K-th 32 rows of the slab
template <int CIN, int PLANE, int N, int K = 0>
__device__ __forceinline__ void s8_tap_steps(int (&acc)[N / 2], uint64_t da, uint64_t db,
                                             int scale_first) {
  if constexpr (K < CIN / 32) {
    wgmma_s8_n<N, 2 * K * PLANE / 16, K * 256 / 16>(acc, da, db, K == 0 ? scale_first : 1);
    s8_tap_steps<CIN, PLANE, N, K + 1>(acc, da, db, scale_first);
  }
}

// Issue one tap of a SAME 3x3 conv for one M-tile and N output channels
// (64, 128 or 256) into acc (added unless scale_first is 0), no commit.
// a_addr: plane 0 of A at the M-tile's row 0, the tap's shift applied
// (planes PLANE bytes apart); SBO: the bytes between A's core matrices
// along M (one tile row for an 8 x 8 pixel block, 128 for 64 consecutive
// pixels); b_addr: the tap's slab at its first output channel (a CIN x N
// piece of pack_slabs' layout: leading byte offset 128, stride byte
// offset 8 CIN).
template <int CIN, int PLANE, int SBO, int N = 64>
__device__ __forceinline__ void s8_tap_issue(uint32_t a_addr, uint32_t b_addr,
                                             int (&acc)[N / 2], int scale_first) {
  static_assert(PLANE % 16 == 0 && SBO % 16 == 0, "descriptor offsets in 16-byte units");
  s8_tap_steps<CIN, PLANE, N>(acc, smem_desc(a_addr, PLANE, SBO),
                              smem_desc(b_addr, 128, CIN * 8), scale_first);
}

// Weight slabs streamed through R buffers of shared memory: slab s of a
// kernel's sequence lies in buffer s % R once its mbarrier (one arrival:
// thread 0's expect_tx) completes phase (s / R) & 1.
template <int R>
struct S8Ring {
  int8_t* buf;
  int stride;
  uint64_t* bar;

  // all threads: wait for slab s; its shared address
  __device__ __forceinline__ uint32_t wait(int s) const {
    mbar_wait(bar + s % R, (s / R) & 1);
    return smem_u32(buf + (s % R) * stride);
  }
  // thread 0: start the copy of slab s (bytes long, from src)
  __device__ __forceinline__ void fill(int s, const int8_t* src, int bytes) const {
    uint64_t* b = bar + s % R;
    int8_t* d = buf + (s % R) * stride;
    mbar_expect_tx(b, bytes);
    for (int o = 0; o < bytes; o += kBulkChunk) bulk_copy(d + o, src + o, min(kBulkChunk, bytes - o), b);
  }
  // thread 0: initialise the barriers (the caller synchronises the block
  // before any thread waits)
  __device__ __forceinline__ void init() const {
    for (int i = 0; i < R; ++i) mbar_init(bar + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
};

// Copy a th x tw pixel window (top-left at image (y0, x0)) of one NHWC
// int8 image of C channels into shared planes of 16 channels (chunk c of
// window pixel p at s + c * plane + 16 p: the A layout above), zeros
// outside the image, by cp.async from threads tid of nth; the caller
// waits (cp_async_wait_all), fences the async proxy and synchronises
// before wgmma reads it.
template <int C>
__device__ __forceinline__ void load_planes_async(const int8_t* __restrict__ img, int H, int W,
                                                  int y0, int x0, int th, int tw, uint32_t s,
                                                  int plane, int tid, int nth) {
  constexpr int V = C / 16;
  const int n = th * tw * V;
  for (int i = tid; i < n; i += nth) {
    const int v = i % V, p = i / V;
    const int y = y0 + p / tw, x = x0 + p % tw;
    const bool in = y >= 0 && y < H && x >= 0 && x < W;
    const int8_t* src = in ? img + (static_cast<size_t>(y) * W + x) * C + v * 16 : img;
    cp_async16(s + v * plane + 16 * p, src, in ? 16 : 0);
  }
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// cast_i8 of a float32 value as int8 bits (the low byte): clamp to
// [relu ? 0 : -127, 127], then add 1.5 * 2^23, where the float32 adder
// rounds to nearest even at 1.0 as rintf does; no float-to-integer
// conversion
__device__ __forceinline__ int s8_cast_bits(float y, bool relu) {
  return __float_as_int(__fadd_rn(fminf(fmaxf(y, relu ? 0.f : -127.f), 127.f), 12582912.f));
}

// two int8 values (low bytes of lo and hi) in 16 bits
__device__ __forceinline__ uint16_t s8_pack2(int lo, int hi) {
  return static_cast<uint16_t>(__byte_perm(lo, hi, 0x0040));
}

}  // namespace tc
}  // namespace spnerf
