// Fused SuperPoint stack entry: float image -> int8 quantize -> conv1
// (1 -> 64, per-channel int8 weights) -> ReLU -> requant -> conv2
// (64 -> 64 int8) -> ReLU -> requant -> optional 2x2 max-pool, both convs
// on Hopper's tensor cores.
//
// Replaces spnerf_tpu/kernels/conv12_fused_pallas.py conv12_fused. Its
// banded-Toeplitz conv1 and W-pair packing are TPU layout and are not
// ported; the contract is: quantize the image as clip(round(x * 127)),
// conv1 in int32, affine + ReLU + requant into int8, conv1 outputs
// outside the image are zero (conv2's SAME padding), conv2 in int32,
// affine + optional ReLU, pool on float32 values, cast to int8.
//
// Bound on an H100 SXM at 480 x 640, batch 64: int8 operations, 11.3
// GMAC per image (conv2 is 98% of it): 0.744 ms at 1,979 TOP/s, against
// 0.39 GB moved per batch (0.12 ms). On the CUDA cores (__dp4a, one a
// 4 multiply-adds) the arithmetic alone takes some 11.7 ms at their issue
// rate: only the tensor cores come near the bound.
//
// Design: one persistent block an SM of three teams, each team two
// warpgroups with its own mid tile, image window and staging areas, that
// walk (image, 16 x 32 output tile) pairs apart and synchronise only
// among themselves (a named barrier a team): 24 warps an SM hide the
// epilogues' latencies under the other teams' tensor-core work, and the
// block copies the packed conv2 weights (9 slabs of 64 x 64 int8, 36,864
// B) and conv1's K-padded slab (16 x 64 f16, 2,048 B) into shared memory
// once for all three, by cp.async.bulk onto an mbarrier. Per tile:
// 1. the 20 x 36 image window (loaded into registers during the previous
//    tile's conv2) is quantized into shared memory as f16 integers, zero
//    outside the image;
// 2. conv1 on the f16 tensor cores (wgmma m64n64k16, float32 sums) over
//    the 18 x 34 mid positions conv2 needs, in row order (10 M-tiles, the
//    last 28 rows padding): each row's A is its 9 image taps zero-padded
//    to K 16, built in registers from the window. Image values (0..127)
//    and weights (+-127) are exact in f16, their products and every
//    partial sum (at most 9 * 127 * 127) exact in float32, so the sums
//    equal the int32 ones while the epilogue needs no integer-to-float
//    conversion (those run at a quarter of the float32 rate, and this
//    epilogue handles 39,168 values a tile). relu(affine) cast to int8
//    goes into the shared mid tile in four planes of 16 channels
//    (conv_tc_s8.cuh's A layout), zero outside the image;
// 3. conv2 on the int8 tensor cores over the 512 outputs through
//    conv_tc_s8.cuh's stage (8 M-tiles of 8 x 8 outputs, 4 a warpgroup:
//    18 wgmma m64n64k32 .s32.s8.s8 into one int32 accumulator a tile, A
//    and B from shared memory). The epilogue pools the int32 sums before
//    the affine: per channel the affine is monotone (non-decreasing for
//    mult >= 0, non-increasing below), and so are the ReLU and the cast,
//    so the max of the four affine values is the affine of the max (or of
//    the min) of the four sums, bit for bit; one conversion and one affine
//    a pooled value. The int8 results go through a per-warp staging area
//    in shared memory and leave as 16-byte stores (a pixel is 64 bytes).
// The casts to int8 round by adding 1.5 * 2^23 to the clamped float32
// value (the float32 adder rounds to nearest even at 1.0 there, as rintf
// does) and take the low byte: no float-to-integer conversion either.
// Shared memory: w2 36,864 + k1 2,048 + affines 1,024 + barrier 128, then
// three teams of mid 39,168 + image 1,536 + staging 8 x 1,280 = 192,896
// B; ptxas: 72 registers, no spills (768 threads allow 80). Only the
// image and the (pooled) output touch HBM. PERF.md says which designs
// were tried on the way (A by ldmatrix, two blocks of one team an SM,
// producer and consumer warpgroups, two M-tiles in flight a warpgroup)
// and why they lost.
//
// Numerics: every sum is exact, so the result equals the plain version's
// bit for bit: the image quantized as cast_i8(__fmul_rn(x, 127.f)); the
// affines with __fmul_rn / __fadd_rn (no FMA contraction), then ReLU,
// then round half to even and the clip to +-127.
#include <cuda_fp16.h>

#include "conv_common.cuh"
#include "conv_tc_s8.cuh"

namespace {

using namespace spnerf;
using tc::smem_u32;

constexpr int TH = 16, TW = 32, C = 64;          // output tile, channels
constexpr int MW = TW + 2, NMID = (TH + 2) * MW;  // mid tile: 18 x 34
constexpr int PLANE = NMID * 16;                  // bytes of a mid plane (16 channels)
constexpr int IW = TW + 4, NIMG = (TH + 4) * IW;  // image window: 20 x 36
constexpr int T1 = (NMID + 63) / 64, T2 = TH * TW / 64;  // conv1 / conv2 M-tiles
constexpr int BX = TW / 8;                        // conv2's 8 x 8 blocks a row
constexpr int NTH = tc::kThreads;                 // 256: a team of two warpgroups
constexpr int PRE = (NIMG + NTH - 1) / NTH;       // window values a thread
constexpr int STAGE_PITCH = 80;                   // bytes a staged pixel
constexpr int W2_BYTES = 9 * C * C, K1_BYTES = 16 * C * 2;
// shared memory: the weights, affines and barrier once a block, then per
// team its mid tile, image window and warps' staging areas
constexpr int OFF_K1 = W2_BYTES, OFF_AFF = OFF_K1 + K1_BYTES;
constexpr int OFF_BAR = OFF_AFF + 4 * C * 4, OFF_TEAM = OFF_BAR + 128;
constexpr int TEAM_MID = 0, TEAM_IMG = NMID * C, TEAM_STAGE = TEAM_IMG + 1536;
constexpr int TEAM_BYTES = TEAM_STAGE + 8 * 16 * STAGE_PITCH;
static_assert(NIMG * 2 <= 1536 && TEAM_BYTES % 128 == 0, "shared memory layout");
constexpr int kTeams = 3;  // teams a block: 24 warps an SM
constexpr int SMEM = OFF_TEAM + kTeams * TEAM_BYTES;
constexpr float kRound = 12582912.f;  // 1.5 * 2^23

struct TileIdx {
  int b, y0, x0;
};

__device__ __forceinline__ TileIdx tile_idx(int tile, int tiles_x, int tiles_y) {
  const int per_img = tiles_x * tiles_y, r = tile % per_img;
  return {tile / per_img, (r / tiles_x) * TH, (r % tiles_x) * TW};
}

// this thread's values of a tile's image window (rows y0 - 2 .., columns
// x0 - 2 ..), 0 outside the image
__device__ __forceinline__ void load_window(const float* __restrict__ img, TileIdx t, int H,
                                            int W, float (&pre)[PRE]) {
  #pragma unroll
  for (int k = 0; k < PRE; ++k) {
    const int i = threadIdx.x % NTH + k * NTH;
    const int y = t.y0 - 2 + i / IW, x = t.x0 - 2 + i % IW;
    pre[k] = i < NIMG && y >= 0 && y < H && x >= 0 && x < W
                 ? __ldg(img + (static_cast<size_t>(t.b) * H + y) * W + x)
                 : 0.f;
  }
}

// D (64 x 64 float32) = A (64 x 16 f16, registers) * B (16 x 64 f16,
// shared memory, K-major): one k-step, D overwritten (scale-d false)
__device__ __forceinline__ void wgmma_f16_m64n64(float (&d)[32], const uint32_t (&a)[4],
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(0));
}

// int8 bits (the low byte) of cast_i8(y) for y already clamped to
// [-127, 127]: y + 1.5 * 2^23 rounds to nearest even at 1.0
__device__ __forceinline__ int round_bits(float y) {
  return __float_as_int(__fadd_rn(y, kRound));
}

// cast_i8(relu ? max(y, 0) : y) as int8 bits
template <bool RELU>
__device__ __forceinline__ int cast_bits(float y) {
  return round_bits(fminf(fmaxf(y, RELU ? 0.f : -127.f), 127.f));
}

// two int8 values (low bytes of lo and hi) in 16 bits
__device__ __forceinline__ uint16_t pack2(int lo, int hi) {
  return static_cast<uint16_t>(__byte_perm(lo, hi, 0x0040));
}

// conv1's A fragment (m64k16 f16) of the rows starting at mid position
// q0: lane (g, tq) gives rows g and g + 8 of its warp at K 2 tq, 2 tq + 1
// (a0, a1) and 8 + 2 tq, 9 + 2 tq (a2, a3); tap k = 3 dy + dx of mid
// position q = (r, c) is window pixel (r + dy, c + dx), K 9-15 zero
__device__ __forceinline__ void conv1_a(const __half* s_img, int q0, int tq,
                                        uint32_t (&a)[4]) {
  #pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = min(q0 + 8 * h, NMID - 1);
    const unsigned short* win =
        reinterpret_cast<const unsigned short*>(s_img) + (q / MW) * IW + q % MW;
    #pragma unroll
    for (int kh = 0; kh < 2; ++kh) {
      uint32_t v = 0;
      #pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = 8 * kh + 2 * tq + e;
        if (k < 9) v |= static_cast<uint32_t>(win[(k / 3) * IW + k % 3]) << (16 * e);
      }
      a[2 * kh + h] = v;
    }
  }
}

template <bool POOL, bool RELU>
__global__ void __launch_bounds__(NTH * kTeams, 1)
conv12_tc_kernel(const float* __restrict__ img, const int8_t* __restrict__ k1,
                 const float* __restrict__ m1, const float* __restrict__ b1,
                 const int8_t* __restrict__ w2, const float* __restrict__ m2,
                 const float* __restrict__ b2, int8_t* __restrict__ out, int H, int W,
                 int tiles_x, int tiles_y, int tiles) {
  extern __shared__ __align__(128) int8_t smem[];
  // per channel pair c = 2 i: {mult[c], mult[c + 1], bias[c], bias[c + 1]},
  // conv1's 32 pairs then conv2's (one 16-byte load a pair)
  float4* s_aff = reinterpret_cast<float4*>(smem + OFF_AFF);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + OFF_BAR);
  const int team = threadIdx.x / NTH, tt = threadIdx.x % NTH;  // thread of the team
  const int wg = tt / tc::kWG, warp = (tt / 32) % 4, lane = tt % 32;
  const int g = lane / 4, tq = lane % 4;
  int8_t* s_mid = smem + OFF_TEAM + team * TEAM_BYTES + TEAM_MID;
  __half* s_img = reinterpret_cast<__half*>(smem + OFF_TEAM + team * TEAM_BYTES + TEAM_IMG);
  int8_t* stage = smem + OFF_TEAM + team * TEAM_BYTES + TEAM_STAGE + (tt / 32) * 16 * STAGE_PITCH;
  const uint32_t w2_base = smem_u32(smem), k1_base = smem_u32(smem + OFF_K1);
  const uint32_t mid_base = smem_u32(s_mid);

  if (threadIdx.x == 0) {
    tc::mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    tc::mbar_expect_tx(bar, W2_BYTES + K1_BYTES);
    for (int o = 0; o < W2_BYTES; o += tc::kBulkChunk)
      tc::bulk_copy(smem + o, w2 + o, min(tc::kBulkChunk, W2_BYTES - o), bar);
    tc::bulk_copy(smem + OFF_K1, k1, K1_BYTES, bar);
  }
  for (int i = threadIdx.x; i < C / 2; i += blockDim.x) {
    s_aff[i] = make_float4(m1[2 * i], m1[2 * i + 1], b1[2 * i], b1[2 * i + 1]);
    s_aff[C / 2 + i] = make_float4(m2[2 * i], m2[2 * i + 1], b2[2 * i], b2[2 * i + 1]);
  }
  __syncthreads();
  tc::mbar_wait(bar, 0);
  // the teams of a block share the weights and walk tiles apart, each
  // synchronising its own 256 threads (named barrier 1 + team)
  auto team_sync = [&]() { asm volatile("bar.sync %0, %1;\n" ::"r"(1 + team), "n"(NTH) : "memory"); };
  const int first = blockIdx.x * kTeams + team, step = gridDim.x * kTeams;
  float pre[PRE];
  if (first < tiles) load_window(img, tile_idx(first, tiles_x, tiles_y), H, W, pre);

  for (int tile = first; tile < tiles; tile += step) {
    const TileIdx t = tile_idx(tile, tiles_x, tiles_y);
    // 1. the quantized window (conv1 of the previous tile is done: the
    // team synchronised after it, and every thread after its conv2)
    #pragma unroll
    for (int k = 0; k < PRE; ++k) {
      const int i = tt + k * NTH;
      if (i < NIMG) s_img[i] = __int2half_rn(cast_i8(__fmul_rn(pre[k], 127.f)));
    }
    team_sync();

    // 2. conv1, M-tiles wg, wg + 2, ...: one wgmma each, then the
    // epilogue writes relu(affine) as int8 into the mid planes (mid
    // position q = (r, c) is image (y0 - 1 + r, x0 - 1 + c); zero outside
    // the image)
    #pragma unroll 1
    for (int mt = wg; mt < T1; mt += tc::kNWG) {
      float acc[32];
      uint32_t a[4];
      conv1_a(s_img, mt * 64 + warp * 16 + g, tq, a);
      tc::wgmma_fence();
      wgmma_f16_m64n64(acc, a, tc::smem_desc(k1_base, 128, 16 * 2 * 8));
      tc::wgmma_commit();
      tc::wgmma_wait<0>();
      tc::fence_regs(acc);
      #pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = mt * 64 + warp * 16 + g + 8 * h;
        if (q >= NMID) continue;
        const int gy = t.y0 - 1 + q / MW, gx = t.x0 - 1 + q % MW;
        const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
        #pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float4 mb = s_aff[4 * j + tq];  // channels 8 j + 2 tq, + 1
          const int v0 = cast_bits<true>(affine(acc[4 * j + 2 * h], mb.x, mb.z));
          const int v1 = cast_bits<true>(affine(acc[4 * j + 2 * h + 1], mb.y, mb.w));
          *reinterpret_cast<uint16_t*>(s_mid + (j / 2) * PLANE + q * 16 + 8 * (j % 2) + 2 * tq) =
              inside ? pack2(v0, v1) : 0;
        }
      }
    }
    // the mid was written by the threads and is read by the tensor cores
    // (the async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    team_sync();
    // the next tile's window is in flight during conv2
    if (tile + step < tiles) load_window(img, tile_idx(tile + step, tiles_x, tiles_y), H, W, pre);

    // 3. conv2: M-tile mt is the 8 x 8 output block (by, bx) = (mt / BX,
    // mt % BX) of the tile; warp w's rows are its block rows 2 w and 2 w +
    // 1, lane (g, tq) column g; output (y, x) of the tile reads mid (y +
    // dy, x + dx) at tap (dy, dx)
    #pragma unroll 1
    for (int mt = wg; mt < T2; mt += tc::kNWG) {
      int acc[32];
      tc::s8_conv3x3_issue<C, MW, PLANE, C * C>(
          mid_base + ((mt / BX) * 8 * MW + (mt % BX) * 8) * 16, w2_base, acc);
      tc::wgmma_wait<0>();
      tc::fence_regs(acc);
      const int sy = t.y0 + (mt / BX) * 8 + 2 * warp, sx = t.x0 + (mt % BX) * 8;
      #pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + 2 * tq;
        const float4 mb = s_aff[C / 2 + 4 * j + tq];
        if constexpr (POOL) {
          // the 2 x 2 window's sums: this lane's two rows, then lane ^ 4
          int hi[2], lo[2];
          #pragma unroll
          for (int e = 0; e < 2; ++e) {
            hi[e] = max(acc[4 * j + e], acc[4 * j + 2 + e]);
            lo[e] = min(acc[4 * j + e], acc[4 * j + 2 + e]);
            hi[e] = max(hi[e], __shfl_xor_sync(0xffffffffu, hi[e], 4));
            lo[e] = min(lo[e], __shfl_xor_sync(0xffffffffu, lo[e], 4));
          }
          const int p0 = mb.x >= 0.f ? hi[0] : lo[0], p1 = mb.y >= 0.f ? hi[1] : lo[1];
          if (g % 2 == 0)
            *reinterpret_cast<uint16_t*>(stage + (g / 2) * STAGE_PITCH + c) =
                pack2(cast_bits<RELU>(affine(p0, mb.x, mb.z)),
                      cast_bits<RELU>(affine(p1, mb.y, mb.w)));
        } else {
          #pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<uint16_t*>(stage + (8 * h + g) * STAGE_PITCH + c) =
                pack2(cast_bits<RELU>(affine(acc[4 * j + 2 * h], mb.x, mb.z)),
                      cast_bits<RELU>(affine(acc[4 * j + 2 * h + 1], mb.y, mb.w)));
        }
      }
      __syncwarp();
      if constexpr (POOL) {
        // 4 pooled pixels of 64 bytes, consecutive along x: 16 lanes, 16 bytes each
        const int oy = sy / 2, ox = sx / 2 + lane / 4;
        if (lane < 16 && oy < H / 2 && ox < W / 2)
          *reinterpret_cast<int4*>(out + ((static_cast<size_t>(t.b) * (H / 2) + oy) * (W / 2) + ox) *
                                             C + (lane % 4) * 16) =
              *reinterpret_cast<const int4*>(stage + (lane / 4) * STAGE_PITCH + (lane % 4) * 16);
      } else {
        #pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int i = lane + 32 * k, px = i / 4;  // pixel (px / 8, px % 8) of the warp's rows
          const int y = sy + px / 8, x = sx + px % 8;
          if (y < H && x < W)
            *reinterpret_cast<int4*>(out + ((static_cast<size_t>(t.b) * H + y) * W + x) * C +
                                     (i % 4) * 16) =
                *reinterpret_cast<const int4*>(stage + px * STAGE_PITCH + (i % 4) * 16);
        }
      }
      __syncwarp();
    }
  }
}

template <bool POOL, bool RELU>
cudaError_t launch(const void* img, const void* k1, const void* m1, const void* b1,
                   const void* w2, const void* m2, const void* b2, void* out, int B, int H,
                   int W, cudaStream_t stream) {
  static int blocks_max = 0;  // blocks the card holds at once
  auto kern = conv12_tc_kernel<POOL, RELU>;
  if (blocks_max == 0) {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return err;
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NTH * kTeams, SMEM);
    blocks_max = max(per_sm, 1) * sms;
  }
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const int tiles = B * tiles_x * tiles_y;
  kern<<<min((tiles + kTeams - 1) / kTeams, blocks_max), NTH * kTeams, SMEM, stream>>>(
      static_cast<const float*>(img), static_cast<const int8_t*>(k1),
      static_cast<const float*>(m1), static_cast<const float*>(b1),
      static_cast<const int8_t*>(w2), static_cast<const float*>(m2),
      static_cast<const float*>(b2), static_cast<int8_t*>(out), H, W, tiles_x, tiles_y, tiles);
  return cudaGetLastError();
}

}  // namespace

// img (B, H, W) float32; k1 the (16, 64) f16 conv1 slab (taps 0-8 x 64
// channels of the int8-quantized kernel, K zero-padded to 16) and w2 the
// (3, 3, 64, 64) int8 conv2 weights, both packed by _build.pack_slabs;
// m1/b1 (64,) float32 (m1 already holds the conv1 weight scale); m2/b2
// (64,); out (B, H/2, W/2, 64) int8 when pool (H, W even), else
// (B, H, W, 64). B, H or W 0 launches nothing.
extern "C" int conv12_fused_launch(const void* img, const void* k1, const void* m1,
                                   const void* b1, const void* w2, const void* m2,
                                   const void* b2, void* out, int B, int H, int W,
                                   int pool, int relu, void* stream) {
  if (B < 0 || H < 0 || W < 0 || (pool && (H % 2 || W % 2)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0 || W == 0) return static_cast<int>(cudaSuccess);
  auto s = static_cast<cudaStream_t>(stream);
  auto kern = pool ? (relu ? launch<true, true> : launch<true, false>)
                   : (relu ? launch<false, true> : launch<false, false>);
  return static_cast<int>(kern(img, k1, m1, b1, w2, m2, b2, out, B, H, W, s));
}
