// Tensor-core conv stage for bf16 operands on Hopper (sm_90a): the shared
// core of the bf16 instances of conv3x3.cu and double_conv3x3.cu.
//
// A SAME 3x3 conv is an implicit GEMM, tap by tap: for each of the 9 taps
// (dy, dx), M = the tile's positions, N = COUT, K = CIN. The block is two
// warpgroups (256 threads); each takes 64-row M-tiles and runs
// wgmma.mma_async m64n64k16 (bf16 operands, float32 sums):
// - A from registers: ldmatrix.x4 reads the rows of the NHWC input tile
//   in shared memory, each lane giving the address of its row shifted by
//   the tap, so the 3x3 window and the halo need no copies. Each pixel's
//   16-byte chunks are swizzled (chunk ^ (pixel & 7)): the 8 rows of an
//   8x8 matrix are 8 consecutive pixels and land in 8 different bank
//   groups, where the plain 128- or 256-byte pitch would hit one 8 times.
// - B from shared memory through a wgmma descriptor: one tap's CIN x COUT
//   slab, K-major without swizzle, in 8 x 8 core matrices of 128
//   contiguous bytes (see pack_slabs in _build.py, which lays the slabs
//   out on the host so that a copy of contiguous bytes lands in layout).
// - The slabs stream through a ring of kRing buffers: thread 0 copies
//   each with cp.async.bulk onto an mbarrier (expected bytes), the
//   warpgroups wait on its phase; a buffer is refilled once every warp
//   has passed the tap's __syncthreads, after wgmma.wait_group 0.
// - The input tile arrives by cp.async 16-byte copies (zero-filled
//   outside the image: SAME padding).
// Per tap, M-tile and 64 input channels a warpgroup loads its A
// fragments, then per 64 output channels fences, issues 4 k-steps of
// wgmma m64n64k16 into a fresh partial, commits, waits and adds the
// partial into its float32 accumulators (see tc_conv3x3): the A and
// partial registers are free again before the next ldmatrix.
//
// Numerics. Every product of two bf16 values is exact; the tensor cores
// add 64 of them (one tap, 64 input channels) in float32, rounding toward
// zero, and the CUDA cores add these partials to nearest, in a fixed
// order (the same bits every launch; no split-K, no atomics). The epilogue
// is the one of conv_common.cuh: the float32 affine with __fmul_rn /
// __fadd_rn, ReLU, the 2x2 max-pool of the float32 values before the
// cast, and rounding to bf16 to nearest even. Against the plain version's
// float64 sums rounded once they differ only where a float32 sum lands
// on the other side of a bf16 rounding boundary.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace spnerf {
namespace tc {

constexpr int kWG = 128;             // threads of a warpgroup
constexpr int kNWG = 2;              // warpgroups of a block
constexpr int kThreads = kWG * kNWG;
constexpr int kRing = 2;             // weight-slab buffers
constexpr int kBulkChunk = 16384;    // bytes per cp.async.bulk

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk c of pixel p in a tile of PB-byte pixels
template <int PB>
__device__ __forceinline__ int swz(int p, int c) {
  return p * PB + ((c ^ (p & 7)) << 4);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// 16 bytes global -> shared; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving accumulator reads or writes across a
// wgmma fence or wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
  #pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma shared-memory descriptor, no swizzle: start address, leading
// byte offset (between core matrices adjacent in K) and stride byte
// offset (between core matrices adjacent in N), all in 16-byte units
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

// D (64 x 64, float32, the wgmma accumulator layout) = A (64 x 16 bf16,
// registers: the mma.m16n8k16 A fragment of each warp's 16 rows) * B
// (16 x 64 bf16, shared memory, K-major), + D unless scale_d is 0
__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// The same at N 72 (the detector head's 65 lanes, padded to the
// narrowest width of 8 that holds them)
__device__ __forceinline__ void wgmma_m64n72(float (&d)[36], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35"
      "}, {%36, %37, %38, %39}, %40, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// D (64 x N float32, the wgmma accumulator layout) = A (64 x 16 bf16) *
// B (16 x N bf16), both from shared memory through descriptors (K-major,
// no swizzle), + D unless scale_d is 0; N 64 or 128
template <int N>
__device__ __forceinline__ void wgmma_bf16_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b,
                                              int scale_d) {
  static_assert(N == 64 || N == 128, "wgmma_bf16_ss: N 64 or 128");
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
}

// Issue the CIN / 16 k-steps of one product of a 64-row M-tile and N
// output channels (64 or 128) into acc (added unless scale_first is 0),
// no commit: A at a_addr in planes of 16-byte channel chunks PLANE bytes
// apart (k-step k reads planes 2 k and 2 k + 1), its core matrices along
// M SBO bytes apart; B a CIN x N slab of pack_slabs' layout at b_addr
// (leading byte offset 128, stride byte offset 16 CIN). The bf16
// counterpart of conv_tc_s8.cuh's s8_tap_issue.
template <int CIN, int PLANE, int SBO, int N>
__device__ __forceinline__ void bf16_tap_issue(uint32_t a_addr, uint32_t b_addr,
                                               float (&acc)[N / 2], int scale_first) {
  #pragma unroll
  for (int k = 0; k < CIN / 16; ++k)
    wgmma_bf16_ss<N>(acc, smem_desc(a_addr + 2 * k * PLANE, PLANE, SBO),
                     smem_desc(b_addr + k * 256, 128, CIN * 16), k == 0 ? scale_first : 1);
}

// Copy a th x tw pixel window (top-left at image (y0, x0)) of one NHWC
// image with PB bytes per pixel into the swizzled shared tile s, zero
// outside the image, by cp.async; returns once the copies have landed
// (the caller synchronises the block).
template <int PB>
__device__ __forceinline__ void load_tile_async(const int8_t* __restrict__ img, int H, int W,
                                                int y0, int x0, int th, int tw, int8_t* s) {
  constexpr int V = PB / 16;
  const uint32_t base = smem_u32(s);
  const int n = th * tw * V;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int v = i % V, p = i / V;
    const int y = y0 + p / tw, x = x0 + p % tw;
    const bool in = y >= 0 && y < H && x >= 0 && x < W;
    const int8_t* src = in ? img + (static_cast<size_t>(y) * W + x) * PB + v * 16 : img;
    cp_async16(base + swz<PB>(p, v), src, in ? 16 : 0);
  }
  cp_async_wait_all();
}

// The weight slabs of a kernel in the order the stages consume them:
// stage 0 (count[0] slabs, passes x 9 taps) then stage 1. Slab i of a
// stage is tap i % 9 of its packed weights, bytes[stage] long.
struct SlabRing {
  int8_t* buf;  // kRing buffers, stride bytes apart
  int stride;
  uint64_t* bar;  // kRing mbarriers, one arrival (thread 0's expect_tx)
  const int8_t* src[2];
  int bytes[2];
  int count[2];
  int seq;  // slabs consumed so far (the same in every thread)

  // thread 0: start the copy of slab s into its buffer
  __device__ __forceinline__ void issue(int s) const {
    if (s >= count[0] + count[1]) return;
    // selects, not indexing: an indexed member array would go to local memory
    const bool st = s >= count[0];
    const int n = st ? bytes[1] : bytes[0];
    const int8_t* g = (st ? src[1] : src[0]) + static_cast<size_t>((st ? s - count[0] : s) % 9) * n;
    int8_t* d = buf + (s % kRing) * stride;
    uint64_t* b = bar + s % kRing;
    mbar_expect_tx(b, n);
    for (int o = 0; o < n; o += kBulkChunk) bulk_copy(d + o, g + o, min(kBulkChunk, n - o), b);
  }
};

// One SAME 3x3 conv on the tensor cores over MTILES M-tiles of 64 rows.
// s_in: swizzled tile of CIN bf16 channels per pixel, tw pixels per row;
// pix(row) gives, for M-row `row`, the tile pixel of its tap (0, 0) (rows
// past the last real one must map to a pixel inside the tile). NSPLIT 1:
// warpgroup g takes M-tiles g, g + kNWG, ... and all N channels; NSPLIT
// 2: every warpgroup takes every M-tile and warpgroup g the channels
// [g N / 2, (g + 1) N / 2), which balances an odd number of M-tiles. In
// passes of MT M-tiles, each pass consuming 9 slabs of the ring, it calls
// epi(tile, n0, acc) for each M-tile, acc holding channels n0 onwards.
//
// Sums in two levels: the tensor cores add the 64 products of one tap and
// 64 input channels into a fresh m64n64 partial (scale_d 0 on its first
// k-step), which the CUDA cores add into the float32 accumulator, rounded
// to nearest. The tensor cores' own float32 additions round toward zero;
// over a whole 3x3 x CIN sum that bias moves values across bf16 rounding
// boundaries in one direction, and through a chain of layers it adds up.
template <int CIN, int N, int MT, int NSPLIT, int MTILES, typename Pix, typename Epi>
__device__ __forceinline__ void tc_conv3x3(const int8_t* s_in, int tw, SlabRing& ring,
                                           Pix pix, Epi epi) {
  constexpr int PB = CIN * 2;
  constexpr int NW = N / NSPLIT, WGM = kNWG / NSPLIT;  // channels, warpgroups along M
  constexpr int PASSES = (MTILES + WGM * MT - 1) / (WGM * MT);
  constexpr uint32_t SBO = CIN * 16;  // one row of 8 x 8 core matrices
  const int wg = threadIdx.x / kWG, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int wgm = wg % WGM, n0 = (wg / WGM) * NW;
  const uint32_t in_base = smem_u32(s_in);
  float part[32] = {};
  #pragma unroll 1
  for (int pass = 0; pass < PASSES; ++pass) {
    float acc[MT][NW / 2];
    int pix0[MT];
    bool live[MT];
    #pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int tile = pass * WGM * MT + wgm + WGM * i;
      live[i] = tile < MTILES;
      pix0[i] = pix(tile * 64 + warp * 16 + lane % 16);
      #pragma unroll
      for (int j = 0; j < NW / 2; ++j) acc[i][j] = 0.f;
    }
    #pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int s = ring.seq;
      mbar_wait(ring.bar + s % kRing, (s / kRing) & 1);
      const uint32_t b_base = smem_u32(ring.buf + (s % kRing) * ring.stride);
      const int toff = (tap / 3) * tw + tap % 3;
      #pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (!live[i]) continue;
        const int p = pix0[i] + toff;
        #pragma unroll
        for (int sub = 0; sub < CIN / 64; ++sub) {
          uint32_t a[4][4];
          #pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            ldmatrix_x4(in_base + swz<PB>(p, sub * 8 + ks * 2 + lane / 16), a[ks]);
          #pragma unroll
          for (int nc = 0; nc < NW / 64; ++nc) {
            wgmma_fence();
            fence_regs(part);
            #pragma unroll
            for (int ks = 0; ks < 4; ++ks)
              wgmma_m64n64(part, a[ks],
                           smem_desc(b_base + (n0 / 8 + nc * 8) * SBO + (sub * 4 + ks) * 256,
                                     128, SBO),
                           ks);
            wgmma_commit();
            wgmma_wait0();
            fence_regs(part);
            #pragma unroll
            for (int j = 0; j < 32; ++j)
              acc[i][nc * 32 + j] = __fadd_rn(acc[i][nc * 32 + j], part[j]);
          }
        }
      }
      __syncthreads();  // every warp is done with this slab's buffer
      if (threadIdx.x == 0) ring.issue(s + kRing);
      ring.seq = s + 1;
    }
    #pragma unroll
    for (int i = 0; i < MT; ++i)
      if (live[i]) epi(pass * WGM * MT + wgm + WGM * i, n0, acc[i]);
  }
}

// Thread 0: set up the ring's barriers and start its first kRing copies;
// the caller synchronises the block before any thread waits on them.
__device__ __forceinline__ void ring_start(SlabRing& ring) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < kRing; ++i) mbar_init(ring.bar + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    for (int i = 0; i < kRing; ++i) ring.issue(i);
  }
}

__device__ __forceinline__ float affine_rn(float acc, float m, float b) {
  return __fadd_rn(__fmul_rn(acc, m), b);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

// Output M order of an out stage: M-tile t, warp w is slice s = 4 t + w
// of 2 rows x 8 columns of the TH x TW output tile (TW / 8 slices per row
// pair); row m of a slice is pixel (m / 8, m % 8) of it. A lane's two
// accumulator rows (lane / 4 and lane / 4 + 8) are then one pixel above
// the other, and its horizontal neighbour sits in lane ^ 4: the 2x2 pool
// is a max in registers and one __shfl_xor.
template <int TW>
__device__ __forceinline__ void out_pixel(int row, int& y, int& x) {
  const int s = row / 16, m = row % 16;
  y = 2 * (s / (TW / 8)) + m / 8;
  x = 8 * (s % (TW / 8)) + m % 8;
}

// Epilogue of an out stage: affine, optional ReLU, optional 2x2 pool of
// the float32 values, bf16 to nearest even, NHWC to out (one image).
template <int N, int NW, int TW, bool POOL>
struct OutEpilogue {
  const float* mult;  // shared, N
  const float* bias;  // shared, N
  bool relu;
  __nv_bfloat16* out;
  int H, W, y0, x0;

  __device__ __forceinline__ void operator()(int tile, int n0, const float (&d)[NW / 2]) const {
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    int ty, tx;
    out_pixel<TW>(tile * 64 + warp * 16 + lane / 4, ty, tx);
    const int y = y0 + ty, x = x0 + tx;
    #pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      const int c = n0 + 8 * j + 2 * (lane % 4);
      const float m0 = mult[c], m1 = mult[c + 1], b0 = bias[c], b1 = bias[c + 1];
      float v00 = affine_rn(d[4 * j], m0, b0), v01 = affine_rn(d[4 * j + 1], m1, b1);
      float v10 = affine_rn(d[4 * j + 2], m0, b0), v11 = affine_rn(d[4 * j + 3], m1, b1);
      if (relu) {
        v00 = fmaxf(v00, 0.f); v01 = fmaxf(v01, 0.f);
        v10 = fmaxf(v10, 0.f); v11 = fmaxf(v11, 0.f);
      }
      if constexpr (POOL) {
        float p0 = fmaxf(v00, v10), p1 = fmaxf(v01, v11);
        p0 = fmaxf(p0, __shfl_xor_sync(0xffffffffu, p0, 4));
        p1 = fmaxf(p1, __shfl_xor_sync(0xffffffffu, p1, 4));
        if ((lane / 4) % 2 == 0 && y / 2 < H / 2 && x / 2 < W / 2)
          *reinterpret_cast<uint32_t*>(
              out + (static_cast<size_t>(y / 2) * (W / 2) + x / 2) * N + c) = pack_bf16x2(p0, p1);
      } else {
        if (x < W && y < H)
          *reinterpret_cast<uint32_t*>(out + (static_cast<size_t>(y) * W + x) * N + c) =
              pack_bf16x2(v00, v01);
        if (x < W && y + 1 < H)
          *reinterpret_cast<uint32_t*>(out + (static_cast<size_t>(y + 1) * W + x) * N + c) =
              pack_bf16x2(v10, v11);
      }
    }
  }
};

// Epilogue of a mid stage: M-row q is mid position (q / mw, q % mw), image
// (y0 - 1 + q / mw, x0 - 1 + q % mw); relu(affine) rounded to bf16 into
// the swizzled shared tile s_mid (N channels), zero outside the image so
// that SAME padding of the next conv reads zeros; rows >= n are padding.
template <int N, int NW>
struct MidEpilogue {
  const float* mult;
  const float* bias;
  int8_t* s_mid;
  int n, mw, H, W, y0, x0;

  __device__ __forceinline__ void operator()(int tile, int n0, const float (&d)[NW / 2]) const {
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    #pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = tile * 64 + warp * 16 + lane / 4 + 8 * h;
      if (q >= n) continue;
      const int gy = y0 - 1 + q / mw, gx = x0 - 1 + q % mw;
      const bool outside = gy < 0 || gy >= H || gx < 0 || gx >= W;
      #pragma unroll
      for (int j = 0; j < NW / 8; ++j) {
        const int c = n0 + 8 * j + 2 * (lane % 4);
        const float v0 = fmaxf(affine_rn(d[4 * j + 2 * h], mult[c], bias[c]), 0.f);
        const float v1 = fmaxf(affine_rn(d[4 * j + 2 * h + 1], mult[c + 1], bias[c + 1]), 0.f);
        *reinterpret_cast<uint32_t*>(s_mid + swz<N * 2>(q, c / 8) + 4 * (lane % 4)) =
            outside ? 0u : pack_bf16x2(v0, v1);
      }
    }
  }
};

}  // namespace tc
}  // namespace spnerf
