// One SAME 3x3 conv with the per-channel affine, optional ReLU, optional
// 2x2 max-pool and the cast in its epilogue; int8 operands (int32 sums,
// requantized to int8) or bf16 operands (float32 sums, rounded to bf16).
//
// Replaces spnerf_tpu/kernels/conv_stack_pallas.py conv3x3_pallas (C_in
// 128: block 6 without the fused mid, blocks 7-8, convPa and convDa
// without the fused tail) and packed_conv3x3_pallas (C_in 64: blocks 2-5
// without the fused mid, block 2 in bf16 mode). The W-pair packing of
// the second is TPU layout: both compute the same conv on plain NHWC.
//
// Bound on an H100 SXM: operations. Its largest call on the serving path
// is bf16 block 2 (64 -> 64 at 480 x 640, pooled), 0.725 T multiply-adds
// per batch of 64 against 2.5 GB read and 0.6 GB written: 1.47 ms at the
// bf16 tensor-core rate, 0.93 ms of bytes. The int8 per-layer route at
// batch 8 takes 5.7-22.6 G multiply-adds a call: 0.006-0.023 ms at the
// int8 rate, about as long as its bytes.
//
// int8 instance (conv3x3_launch), on the int8 tensor cores through
// conv_tc_s8.cuh: one stage of double_conv3x3.cu's int8 kernel. Persistent
// blocks of two warpgroups walk (image, 16 x 16 output tile) pairs; the
// input tile with its one-pixel halo lands by 16-byte cp.async in planes
// of 16 channels (zeros outside the image: SAME padding). Each 8 x 8
// output block is a 64-row M-tile (a core matrix one block row, stride
// byte offset one input-tile row, so a tap moves the start address only),
// each wgmma m64nNk32 .s32.s8.s8 reads A and B from shared memory, and a
// work unit is one block and N = min(C_out, 128) channels (one int32
// accumulator); int8 products and int32 sums are exact in any order, so
// the output equals the plain version's bit for bit. The epilogue is
// s8_block_out: the 2x2 pool on the int32 sums (max or min by the
// multiplier's sign), the affine by __fmul_rn / __fadd_rn, the cast by
// adding 1.5 * 2^23, 16-byte stores from a per-warp staging area.
// Weights by pack_slabs (tap slabs, K-major core matrices), prepared once
// (conv_stack.prepare_conv3x3). Instances:
//   C_in 64 (64-64, 64-64 pool, 64-128): all 9 slabs resident (36,864 or
//     73,728 B, copied once a block by cp.async.bulk); a warpgroup runs
//     its two blocks one at a time, all nine taps in one commit group, and
//     no block synchronisation separates them; two blocks an SM share the
//     tensor cores (60-114 KB each).
//   C_in 128 (128-128, 128-128 pool, 128-256): the 16 KB slabs of one tap
//     and 128 channels stream through a ring of four buffers, one tap at a
//     time for both warpgroups (double_conv3x3.cu's conv_b), each
//     warpgroup two blocks at once (128 accumulator registers); C_out 256
//     in two passes of 128 channels; one block an SM (124-126 KB).
//
// bf16 instance (conv3x3_bf16_launch): on the tensor cores through
// conv_tc.cuh (wgmma m64n64k16, A by ldmatrix from the swizzled input
// tile, B from one tap's weight slab, the slabs streamed by
// cp.async.bulk through a ring of two buffers, two-level float32 sums;
// see there). Per block: two warpgroups, one output tile in 2 x 8 slices
// (the pool a max in registers and one shuffle), the same epilogue.
// Instances (output tile; M-tiles per warpgroup; shared memory = ring +
// input tile + affines + barriers):
//   64-64, 64-64 pool  16 x 16; 2; 16,384 + 41,472 + 512 + 16 = 58,384 B
//                      (two blocks per SM)
//   64-128             16 x 16; 2; 32,768 + 41,472 + 1,024 + 16 = 75,280 B
//   128-128, 128-128 pool  8 x 16; 1; 65,536 + 46,080 + 1,024 + 16
//                      = 112,656 B
//   128-256             8 x 16; 1; 131,072 + 46,080 + 2,048 + 16 = 179,216 B
// No M padding: every tile is whole 64-row M-tiles; ragged image edges
// read zeros and store nothing. Registers (ptxas, sm_90a): 124-125 for
// 64-64, 134-212 for the others, no spills.
#include "conv_tc_s8.cuh"

namespace {

using namespace spnerf;

// ---- int8 on the int8 tensor cores ----

constexpr int kS8OH = 16, kS8OW = 16;         // output tile
constexpr int kS8IW = kS8OW + 2;              // input tile width (one-pixel halo)
constexpr int kS8PIN = (kS8OH + 2) * kS8IW * 16;  // bytes of an input plane
constexpr int kS8MT = kS8OH * kS8OW / 64;     // M-tiles (8 x 8 blocks) a tile: 4
constexpr int kS8BX = kS8OW / 8;              // blocks a tile row
constexpr int kS8WGs = 2;                     // warpgroups a block
constexpr int kS8Ring = 4;                    // slab buffers (C_in 128)

template <int CIN, int CO, bool POOL>
struct S8Conv {
  static constexpr int NC = CO < 128 ? CO : 128;  // channels of a unit
  static constexpr int CHUNKS = CO / NC;          // passes of a tile
  static constexpr bool RES = CIN == 64;          // all slabs resident
  static constexpr int SLAB = NC * CIN;           // one tap's slab of one pass
  static constexpr int OFF_IN = RES ? 9 * CIN * CO : kS8Ring * SLAB;
  static constexpr int OFF_STAGE = OFF_IN + CIN / 16 * kS8PIN;
  static constexpr int STAGE_ROWS = POOL ? 4 : 16;
  static constexpr int OFF_AFF = OFF_STAGE + 4 * kS8WGs * STAGE_ROWS * tc::kStagePitch<NC>;
  static constexpr int OFF_BAR = OFF_AFF + CO / 2 * 16;
  static constexpr int SMEM = OFF_BAR + (kS8Ring + 1) * 8;
  static constexpr int MINB = RES ? 2 : 1;  // blocks an SM
  static_assert(SMEM <= 232448 && (MINB == 1 || 2 * (SMEM + 1024) <= 233472), "shared memory");
};

template <int CIN, int CO, bool POOL>
__global__ void __launch_bounds__(kS8WGs * tc::kWG, S8Conv<CIN, CO, POOL>::MINB)
conv3x3_s8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ mult, const float* __restrict__ bias,
                  int8_t* __restrict__ out, int H, int W, int relu_i, int tiles_x, int tiles_y,
                  int tiles) {
  using namespace tc;
  using L = S8Conv<CIN, CO, POOL>;
  extern __shared__ __align__(128) int8_t smem[];
  // per channel pair c = 2 i: {mult[c], mult[c + 1], bias[c], bias[c + 1]}
  float4* s_aff = reinterpret_cast<float4*>(smem + L::OFF_AFF);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::OFF_BAR);  // the ring's, then RES's
  const S8Ring<kS8Ring> ring{smem, L::SLAB, bars};
  const int wg = threadIdx.x / kWG;
  int8_t* stage = smem + L::OFF_STAGE + (threadIdx.x / 32) * L::STAGE_ROWS * kStagePitch<L::NC>;
  const uint32_t w_base = smem_u32(smem), in_base = smem_u32(smem + L::OFF_IN);
  const size_t img_in = static_cast<size_t>(H) * W * CIN;
  const size_t img_out =
      (POOL ? static_cast<size_t>(H / 2) * (W / 2) : static_cast<size_t>(H) * W) * CO;
  const bool relu = relu_i != 0;
  // this block's tiles and, C_in 128, the slabs it streams: a tile's
  // passes in order, each its nine taps
  const int n_mine = blockIdx.x < tiles ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int n_slabs = L::RES ? 0 : 9 * L::CHUNKS * n_mine;
  auto fill = [&](int s) {
    const int k = s % (9 * L::CHUNKS);
    ring.fill(s, w + (k % 9) * CIN * CO + (k / 9) * L::SLAB, L::SLAB);
  };
  if (threadIdx.x == 0) {
    if constexpr (L::RES) mbar_init(bars + kS8Ring, 1);
    ring.init();
    if constexpr (L::RES) {
      mbar_expect_tx(bars + kS8Ring, 9 * CIN * CO);
      for (int o = 0; o < 9 * CIN * CO; o += kBulkChunk)
        bulk_copy(smem + o, w + o, min(kBulkChunk, 9 * CIN * CO - o), bars + kS8Ring);
    }
    for (int s = 0; s < kS8Ring && s < n_slabs; ++s) fill(s);
  }
  for (int i = threadIdx.x; i < CO / 2; i += blockDim.x)
    s_aff[i] = make_float4(mult[2 * i], mult[2 * i + 1], bias[2 * i], bias[2 * i + 1]);
  __syncthreads();  // the barriers are initialised
  if constexpr (L::RES) mbar_wait(bars + kS8Ring, 0);

  int seq = 0;  // slabs consumed
  #pragma unroll 1
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int per_img = tiles_x * tiles_y, r = tile % per_img, b = tile / per_img;
    const int y0 = (r / tiles_x) * kS8OH, x0 = (r % tiles_x) * kS8OW;
    load_planes_async<CIN>(x + b * img_in, H, W, y0 - 1, x0 - 1, kS8OH + 2, kS8IW, in_base,
                           kS8PIN, threadIdx.x, blockDim.x);
    cp_async_wait_all();
    fence_async_smem();
    __syncthreads();
    // M-tile mt: the 8 x 8 block (mt / BX, mt % BX), whose tap (0, 0) is
    // input tile pixel (8 (mt / BX), 8 (mt % BX))
    auto a_block = [&](int mt) {
      return in_base + ((mt / kS8BX) * 8 * kS8IW + (mt % kS8BX) * 8) * 16;
    };
    auto store = [&](const int (&acc)[L::NC / 2], int mt, int pass) {
      s8_block_out<L::NC, POOL>(acc, y0 + (mt / kS8BX) * 8, x0 + (mt % kS8BX) * 8,
                                s_aff + pass * L::NC / 2, relu, stage,
                                out + b * img_out + pass * L::NC, CO, H, W);
    };
    #pragma unroll 1
    for (int pass = 0; pass < L::CHUNKS; ++pass) {
      if constexpr (L::RES) {
        // one block at a time, its nine taps in one commit group
        #pragma unroll 1
        for (int mt = wg; mt < kS8MT; mt += kS8WGs) {
          int acc[L::NC / 2];
          s8_conv_tile<CIN, kS8IW, kS8PIN, kS8IW * 16, CIN * CO, L::NC>(
              a_block(mt), w_base + pass * L::SLAB, acc);
          store(acc, mt, pass);
        }
      } else {
        // both of the warpgroup's blocks at once, a tap a commit group;
        // after each, wait for the previous group, synchronise the block
        // and refill the previous slab's buffer
        int acc[2][L::NC / 2];
        #pragma unroll 1
        for (int tap = 0; tap < 9; ++tap) {
          const uint32_t slab = ring.wait(seq);
          const uint32_t shift = ((tap / 3) * kS8IW + tap % 3) * 16;
          wgmma_fence();
          #pragma unroll
          for (int i = 0; i < 2; ++i)
            s8_tap_issue<CIN, kS8PIN, kS8IW * 16, L::NC>(a_block(wg + kS8WGs * i) + shift, slab,
                                                         acc[i], tap);
          wgmma_commit();
          wgmma_wait<1>();
          __syncthreads();
          if (threadIdx.x == 0 && seq >= 1 && seq - 1 + kS8Ring < n_slabs)
            fill(seq - 1 + kS8Ring);
          ++seq;
        }
        wgmma_wait<0>();
        #pragma unroll
        for (int i = 0; i < 2; ++i) {
          fence_regs(acc[i]);
          store(acc[i], wg + kS8WGs * i, pass);
        }
      }
    }
    __syncthreads();  // every warpgroup is done with the input tile
  }
}

// grid: as many blocks as the card holds at once (counted once per
// instance), at most one a tile
template <int CIN, int CO, bool POOL>
cudaError_t launch_s8(const void* x, const void* w, const void* m, const void* b, void* out,
                      int B, int H, int W, int relu, cudaStream_t stream) {
  using L = S8Conv<CIN, CO, POOL>;
  auto kern = conv3x3_s8_kernel<CIN, CO, POOL>;
  static int blocks_max = 0;
  if (blocks_max == 0) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (err != cudaSuccess) return err;
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kS8WGs * tc::kWG, L::SMEM);
    blocks_max = max(per_sm, 1) * sms;
  }
  const int tiles_x = (W + kS8OW - 1) / kS8OW, tiles_y = (H + kS8OH - 1) / kS8OH;
  const int tiles = B * tiles_x * tiles_y;
  if (tiles == 0) return cudaSuccess;
  kern<<<min(tiles, blocks_max), kS8WGs * tc::kWG, L::SMEM, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), static_cast<const float*>(m),
      static_cast<const float*>(b), static_cast<int8_t*>(out), H, W, relu, tiles_x, tiles_y,
      tiles);
  return cudaGetLastError();
}

int dispatch_s8(const void* x, const void* w, const void* m, const void* b, void* out, int B,
                int H, int W, int cin, int co, int pool, int relu, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (B < 0 || H < 0 || W < 0 || (pool && (H % 2 || W % 2)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (cin == 64 && co == 64 && pool)
    return launch_s8<64, 64, true>(x, w, m, b, out, B, H, W, relu, s);
  if (cin == 64 && co == 64 && !pool)
    return launch_s8<64, 64, false>(x, w, m, b, out, B, H, W, relu, s);
  if (cin == 64 && co == 128 && !pool)
    return launch_s8<64, 128, false>(x, w, m, b, out, B, H, W, relu, s);
  if (cin == 128 && co == 128 && pool)
    return launch_s8<128, 128, true>(x, w, m, b, out, B, H, W, relu, s);
  if (cin == 128 && co == 128 && !pool)
    return launch_s8<128, 128, false>(x, w, m, b, out, B, H, W, relu, s);
  if (cin == 128 && co == 256 && !pool)
    return launch_s8<128, 256, false>(x, w, m, b, out, B, H, W, relu, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// bf16 on the tensor cores: output tile OH x OW, MT M-tiles per
// warpgroup and pass, MINB blocks per SM
template <int CIN, int CO, bool POOL, int OH, int OW, int MT, int MINB>
__global__ void __launch_bounds__(tc::kThreads, MINB)
conv3x3_tc_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ mult, const float* __restrict__ bias,
                  __nv_bfloat16* __restrict__ out, int H, int W, int relu, int tiles_x) {
  using namespace tc;
  constexpr int SLAB = CIN * CO * 2, TW_IN = OW + 2, TILES = OH * OW / 64;
  constexpr int PASSES = (TILES + kNWG * MT - 1) / (kNWG * MT);
  extern __shared__ __align__(128) int8_t smem_tc[];
  int8_t* s_in = smem_tc + kRing * SLAB;  // (OH+2) x (OW+2) x CIN
  float* s_aff = reinterpret_cast<float*>(s_in + (OH + 2) * TW_IN * CIN * 2);  // mult, bias
  uint64_t* bars = reinterpret_cast<uint64_t*>(s_aff + 2 * CO);
  const int b = blockIdx.y;
  const int y0 = (blockIdx.x / tiles_x) * OH, x0 = (blockIdx.x % tiles_x) * OW;
  SlabRing ring{smem_tc, SLAB, bars, {w, w}, {SLAB, SLAB}, {0, PASSES * 9}, 0};
  ring_start(ring);
  for (int i = threadIdx.x; i < CO; i += blockDim.x) {
    s_aff[i] = mult[i];
    s_aff[CO + i] = bias[i];
  }
  load_tile_async<CIN * 2>(
      reinterpret_cast<const int8_t*>(x) + static_cast<size_t>(b) * H * W * CIN * 2, H, W,
      y0 - 1, x0 - 1, OH + 2, TW_IN, s_in);
  __syncthreads();
  const size_t out_img = POOL ? static_cast<size_t>(H / 2) * (W / 2) : static_cast<size_t>(H) * W;
  tc_conv3x3<CIN, CO, MT, 1, TILES>(
      s_in, TW_IN, ring,
      [](int row) {
        int ty, tx;
        out_pixel<OW>(row, ty, tx);
        return ty * TW_IN + tx;
      },
      OutEpilogue<CO, CO, OW, POOL>{s_aff, s_aff + CO, relu != 0, out + b * out_img * CO, H, W, y0,
                                x0});
}

template <int CIN, int CO, bool POOL, int OH, int OW, int MT, int MINB>
cudaError_t launch_tc(const void* x, const void* w, const void* m, const void* b, void* out,
                      int B, int H, int W, int relu, cudaStream_t stream) {
  constexpr int smem = tc::kRing * CIN * CO * 2 + (OH + 2) * (OW + 2) * CIN * 2 + 2 * CO * 4 +
                       tc::kRing * 8;
  auto kern = conv3x3_tc_kernel<CIN, CO, POOL, OH, OW, MT, MINB>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles_x = (W + OW - 1) / OW, tiles_y = (H + OH - 1) / OH;
  kern<<<dim3(tiles_x * tiles_y, B), tc::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(m), static_cast<const float*>(b),
      static_cast<__nv_bfloat16*>(out), H, W, relu, tiles_x);
  return cudaGetLastError();
}

int dispatch_tc(const void* x, const void* w, const void* m, const void* b, void* out, int B,
                int H, int W, int cin, int co, int pool, int relu, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (cin == 64 && co == 64 && pool)
    return launch_tc<64, 64, true, 16, 16, 2, 2>(x, w, m, b, out, B, H, W, relu, s);
  if (cin == 64 && co == 64 && !pool)
    return launch_tc<64, 64, false, 16, 16, 2, 2>(x, w, m, b, out, B, H, W, relu, s);
  if (cin == 64 && co == 128 && !pool)
    return launch_tc<64, 128, false, 16, 16, 2, 1>(x, w, m, b, out, B, H, W, relu, s);
  if (cin == 128 && co == 128 && pool)
    return launch_tc<128, 128, true, 8, 16, 1, 1>(x, w, m, b, out, B, H, W, relu, s);
  if (cin == 128 && co == 128 && !pool)
    return launch_tc<128, 128, false, 8, 16, 1, 1>(x, w, m, b, out, B, H, W, relu, s);
  if (cin == 128 && co == 256 && !pool)
    return launch_tc<128, 256, false, 8, 16, 1, 1>(x, w, m, b, out, B, H, W, relu, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x (B, H, W, cin) int8; w the (3, 3, cin, co) int8 weights packed by
// pack_slabs ([9][co/8][cin/16][8][16]); m/b (co,) float32; out (B, H, W,
// co) int8, or (B, H/2, W/2, co) when pool (H and W even). Supported (cin,
// co, pool): (64, 64, 0 or 1), (64, 128, 0), (128, 128, 0 or 1),
// (128, 256, 0). B, H or W 0 launches nothing.
extern "C" int conv3x3_launch(const void* x, const void* w, const void* m, const void* b,
                              void* out, int B, int H, int W, int cin, int co, int pool,
                              int relu, void* stream) {
  return dispatch_s8(x, w, m, b, out, B, H, W, cin, co, pool, relu, stream);
}

// The same with bf16 x and out, weights packed by pack_slabs
// ([9][co/8][cin/8][8][8] bf16, see conv_tc.cuh).
extern "C" int conv3x3_bf16_launch(const void* x, const void* w, const void* m, const void* b,
                                   void* out, int B, int H, int W, int cin, int co, int pool,
                                   int relu, void* stream) {
  return dispatch_tc(x, w, m, b, out, B, H, W, cin, co, pool, relu, stream);
}
