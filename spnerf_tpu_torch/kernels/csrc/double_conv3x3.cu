// Two chained SAME 3x3 convs in one kernel, the mid activation kept in
// shared memory, with an optional fused 2x2 max-pool; int8 or bf16
// operands.
//
// Replaces spnerf_tpu/kernels/mid_fused_pallas.py
// double_packed_conv3x3_pallas (blocks 3-4 and 5-6, pool on) and
// spnerf_tpu/kernels/tail_fused_pallas.py double_conv3x3_pallas (blocks
// 7-8, pool off): the two TPU kernels compute the same function and
// differ only in their TPU layout (W-pair packing, whole-image blocks).
//
// Bound on an H100 SXM at the main path's shapes (batch 64): operations
// (int8: 1,979 TOP/s dense; bf16: 989 TFLOP/s dense); blocks 3-4 are
// 5.66 GMAC per image, blocks 5-6 4.25, blocks 7-8 1.42, while the bytes
// moved are a few MB per image: bf16 0.7328, 0.5496 and 0.1832 ms a
// batch of 64.
//
// int8 instance (double_conv3x3_launch), on the int8 tensor cores through
// conv_tc_s8.cuh (wgmma m64n64k32 .s32.s8.s8, A and B from shared memory;
// int8 products and int32 sums are exact in any order, so every output
// equals the plain version's bit for bit). Persistent blocks, one an SM,
// walk (image, output tile) pairs:
// - the input tile with a 2-pixel halo lands by 16-byte cp.async in
//   planes of 16 channels (conv_tc_s8.cuh's A layout), zeros outside the
//   image; the next tile's input is copied while conv_b runs;
// - conv_a in row order over the input tile's pitch (IW = OW + 4): M-row
//   p is input pixel p as the tap (0, 0) of mid position (p / IW, p %
//   IW), each core matrix 8 consecutive pixels of a plane (stride byte
//   offset 128), so a tap moves the start address only; the columns past
//   the mid's OW + 2 and the rows past its last are computed and dropped
//   (1.5x the mid's 324 positions at 16 x 16, against 1.27x for the halo
//   alone). Its epilogue writes relu(affine) as int8 into
//   the mid planes, zero outside the image (conv_b's SAME padding);
// - conv_b over 8 x 8 output blocks of the mid planes (stride byte offset
//   one mid row): a thread's two accumulator rows are vertical pool
//   partners and lane ^ 4 holds the horizontal ones, so the 2x2 pool takes
//   the max (multiplier >= 0) or min (below) of four int32 sums before one
//   affine: affine, ReLU and the cast are monotone, so this is the pool of
//   the float32 values bit for bit. Results leave by 16-byte stores from a
//   per-warp staging area.
// Casts to int8 add 1.5 * 2^23 to the clamped float32 value (round half
// to even) and take the low byte; affines by __fmul_rn / __fadd_rn.
// Output tile 16 x 16 (conv_a: 6 M-tiles of 64 rows for the mid's 324
// positions, 1.5x; conv_b: 4 blocks). Instances:
//   64-64-64 pool     both convs' slabs resident (2 x 36,864 B, copied
//   (blocks 3-4)      once a block by cp.async.bulk) and shared by three
//                     teams of two warpgroups, each with its own input,
//                     mid and staging tiles (48,896 B), walking tiles apart
//                     and synchronising only among themselves, as
//                     conv12_fused.cu does: a warpgroup runs one M-tile at
//                     a time (the 9 taps' 18 wgmma in one commit group,
//                     one accumulator), the other five warpgroups of the
//                     SM keep the tensor cores busy during its epilogue;
//                     221,568 B, 768 threads, one block an SM
//   64-128-128 pool,  two warpgroups, 256 threads, one block an SM.
//   128-128-128       conv_b's tap slabs (128 x 128) stream through a
//   (pool or not)     ring of 4 buffers by cp.async.bulk, one tap at a
//                     time for both warpgroups: after a tap's group is
//                     issued, each waits for its group before, the block
//                     synchronises and thread 0 refills that buffer. A
//                     work unit is an M-tile and all 128 channels (wgmma
//                     m64n128k32: A read once for both 64-channel
//                     halves); conv_b runs its 4 in one pass of two a
//                     warpgroup (128 accumulator registers). conv_a: at
//                     CIN 64 its slabs (73,728 B) stay resident beside
//                     the ring (213,032 B in all), and each warpgroup runs
//                     its M-tiles one at a time with no block
//                     synchronisation, one's epilogue under the other's
//                     products (0.85 ms against 1.12 streamed, batch 64
//                     on an H100); at CIN 128 (295 KB of weights) its
//                     slabs stream too, its 6 M-tiles in 3 passes of one
//                     unit a warpgroup. Variants timed on an H100:
//                     64-channel units 12-13% slower; two 128-channel
//                     units in conv_a, or three or four warpgroups,
//                     spilled the accumulators to local memory and ran
//                     2.3-3.6x slower; the ring's depth and a second
//                     commit group in flight changed nothing
//
// bf16 instance (double_conv3x3_bf16_launch): the same chain on the
// tensor cores through conv_tc.cuh (wgmma m64n64k16, A by ldmatrix from
// the swizzled input tile, B from weight slabs streamed by cp.async.bulk
// through a ring of two buffers, two-level float32 sums; see there). Per
// block: two warpgroups, one output tile; conv_a over the mid positions
// in row order (M padded to 64), its epilogue rounding relu(affine) to
// bf16 into the swizzled shared mid, zero outside the image; conv_b over
// the outputs in 2 x 8 slices, pooled in registers. Only the input and
// the (pooled) output touch HBM. Instances (output tile; conv_a's
// M-tiles and how the warpgroups share them; shared memory = ring +
// input + mid + affines + barriers):
//   64-64-64 pool   16 x 16; 6 (384 rows for 324, 16% padding), two
//                   passes of 2 per warpgroup (conv_a's slabs stream
//                   twice); 16,384 + 51,200 + 41,472 + 1,024 + 16
//                   = 110,096 B, two blocks per SM
//   64-128-128 pool  8 x 16; 3 (192 rows for 180, 6%), each warpgroup
//                   all 3 and half the channels (conv_b too);
//                   65,536 + 30,720 + 46,080 + 2,048 + 16 = 144,400 B
//   128-128-128      8 x 16; the same; 65,536 + 61,440 + 46,080 + 2,048
//                   + 16 = 175,120 B
// conv_a recomputes the one-pixel halo of mid positions: 1.27x its work at
// 16 x 16, 1.41x at 8 x 16. Registers (ptxas, sm_90a): 126 for 64-64-64,
// 176-190 for the others, no spills.
#include "conv_common.cuh"
#include "conv_tc_s8.cuh"

namespace {

using namespace spnerf;

// ---- int8 instances on the tensor cores ----

constexpr int kS8OH = 16, kS8OW = 16;           // output tile
constexpr int kS8IW = kS8OW + 4;                // input tile width (2-pixel halo)
constexpr int kS8NIN = (kS8OH + 4) * kS8IW;     // input tile pixels
constexpr int kS8MW = kS8OW + 2;                // mid tile width (1-pixel halo)
constexpr int kS8NMID = (kS8OH + 2) * kS8MW;    // mid tile pixels
constexpr int kS8NA = (kS8OH + 1) * kS8IW + kS8MW;  // conv_a rows in row order
constexpr int kS8MTA = (kS8NA + 63) / 64;       // conv_a M-tiles: 6
constexpr int kS8MTB = kS8OH * kS8OW / 64;      // conv_b M-tiles (8 x 8 blocks): 4
constexpr int kS8BX = kS8OW / 8;                // 8 x 8 blocks a tile row
constexpr int kS8PIN = kS8NIN * 16, kS8PMID = kS8NMID * 16;  // plane bytes

struct Tile {
  int b, y0, x0;
};

__device__ __forceinline__ Tile s8_tile(int tile, int tiles_x, int tiles_y) {
  const int per_img = tiles_x * tiles_y, r = tile % per_img;
  return {tile / per_img, (r / tiles_x) * kS8OH, (r % tiles_x) * kS8OW};
}

// shared address of plane 0 at conv_a M-tile mt's row 0 (input pixel 64
// mt: row order over the input tile's pitch) and at conv_b M-tile mt's
// (the 8 x 8 output block (mt / BX, mt % BX), whose tap (0, 0) is the mid
// pixel of its top-left output)
__device__ __forceinline__ uint32_t a_rows(uint32_t in_base, int mt) {
  return in_base + mt * 64 * 16;
}
__device__ __forceinline__ uint32_t b_block(uint32_t mid_base, int mt) {
  return mid_base + ((mt / kS8BX) * 8 * kS8MW + (mt % kS8BX) * 8) * 16;
}

// conv_a's epilogue for one M-tile and its NW (64 or 128) mid channels:
// M-row p = 64 mt + 16 warp + g (+ 8) is mid position (p / IW,
// p % IW), image (y0 - 1 + p / IW, x0 - 1 + p % IW); relu(affine) as int8
// into the mid planes, zero outside the image; columns past the mid and
// rows past its last dropped. aff: {mult, mult, bias, bias} of channel
// pairs.
template <int NW>
__device__ __forceinline__ void s8_mid_out(const int (&acc)[NW / 2], int mt,
                                           const float4* aff, int8_t* s_mid, Tile t, int H,
                                           int W) {
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  #pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = mt * 64 + warp * 16 + g + 8 * h;
    const int r = p / kS8IW, c = p % kS8IW;
    if (p >= kS8NA || c >= kS8MW) continue;
    const int gy = t.y0 - 1 + r, gx = t.x0 - 1 + c;
    const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
    int8_t* dst = s_mid + (r * kS8MW + c) * 16 + 2 * tq;
    #pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      const float4 m = aff[4 * j + tq];  // channels 8 j + 2 tq, + 1
      const int v0 = tc::s8_cast_bits(affine(acc[4 * j + 2 * h], m.x, m.z), true);
      const int v1 = tc::s8_cast_bits(affine(acc[4 * j + 2 * h + 1], m.y, m.w), true);
      *reinterpret_cast<uint16_t*>(dst + (j / 2) * kS8PMID + 8 * (j % 2)) =
          inside ? tc::s8_pack2(v0, v1) : 0;
    }
  }
}

using tc::kStagePitch;
using tc::s8_conv_tile;

// conv_b's epilogue for one M-tile (8 x 8 output block) and its NW output
// channels (tc::s8_block_out; the 2 x 2 pool on the int32 sums)
template <int NW, bool POOL>
__device__ __forceinline__ void s8_out(const int (&acc)[NW / 2], int mt, const float4* aff,
                                       bool relu, int8_t* stage, int8_t* __restrict__ out,
                                       Tile t, int H, int W) {
  const size_t img = POOL ? static_cast<size_t>(H / 2) * (W / 2) : static_cast<size_t>(H) * W;
  tc::s8_block_out<NW, POOL>(acc, t.y0 + (mt / kS8BX) * 8, t.x0 + (mt % kS8BX) * 8, aff, relu,
                             stage, out + t.b * img * NW, NW, H, W);
}

// -- 64-64-64 pool (blocks 3-4): teams over resident weights --
constexpr int kTeams = 3;                            // teams of two warpgroups a block
constexpr int kTeamThreads = tc::kThreads;           // 256
constexpr int T64_W = 9 * 64 * 64;                   // one conv's slabs
constexpr int T64_OFF_AFF = 2 * T64_W, T64_OFF_BAR = T64_OFF_AFF + 64 * 16;
constexpr int T64_OFF_TEAM = T64_OFF_BAR + 128;
constexpr int T64_MID = 4 * kS8PIN, T64_STAGE = T64_MID + 4 * kS8PMID;
constexpr int T64_TEAM = T64_STAGE + 8 * 4 * kStagePitch<64>;
constexpr int T64_SMEM = T64_OFF_TEAM + kTeams * T64_TEAM;
// conv_a's last rows read up to 2 IW + 2 pixels past its M-tiles: into
// the next plane, and past the last plane into the mid tile
static_assert((kS8MTA * 64 + 2 * kS8IW + 2 - kS8NIN) * 16 <= 4 * kS8PMID, "input slack");
static_assert(T64_TEAM % 128 == 0 && T64_SMEM <= 232448, "shared memory");

__global__ void __launch_bounds__(kTeamThreads * kTeams, 1)
double_conv3x3_s8_team_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wa,
                              const float* __restrict__ ma, const float* __restrict__ ba,
                              const int8_t* __restrict__ wb, const float* __restrict__ mb,
                              const float* __restrict__ bb, int8_t* __restrict__ out, int H,
                              int W, int relu_b, int tiles_x, int tiles_y, int tiles) {
  using namespace tc;
  extern __shared__ __align__(128) int8_t smem[];
  // per channel pair c = 2 i: {mult[c], mult[c + 1], bias[c], bias[c + 1]},
  // conv_a's 32 pairs, then conv_b's
  float4* s_aff = reinterpret_cast<float4*>(smem + T64_OFF_AFF);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + T64_OFF_BAR);
  const int team = threadIdx.x / kTeamThreads, tt = threadIdx.x % kTeamThreads;
  const int wg = tt / kWG;
  int8_t* base = smem + T64_OFF_TEAM + team * T64_TEAM;
  int8_t* s_mid = base + T64_MID;
  int8_t* stage = base + T64_STAGE + (tt / 32) * 4 * kStagePitch<64>;
  const uint32_t w_base = smem_u32(smem), in_base = smem_u32(base), mid_base = smem_u32(s_mid);
  const size_t img_in = static_cast<size_t>(H) * W * 64;
  const bool relu = relu_b != 0;
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    fence_async_smem();
    mbar_expect_tx(bar, 2 * T64_W);
    for (int o = 0; o < T64_W; o += kBulkChunk) {
      bulk_copy(smem + o, wa + o, min(kBulkChunk, T64_W - o), bar);
      bulk_copy(smem + T64_W + o, wb + o, min(kBulkChunk, T64_W - o), bar);
    }
  }
  for (int i = threadIdx.x; i < 32; i += blockDim.x) {
    s_aff[i] = make_float4(ma[2 * i], ma[2 * i + 1], ba[2 * i], ba[2 * i + 1]);
    s_aff[32 + i] = make_float4(mb[2 * i], mb[2 * i + 1], bb[2 * i], bb[2 * i + 1]);
  }
  // the teams share the weights and walk tiles apart, each synchronising
  // its own 256 threads (named barrier 1 + team)
  auto team_sync = [&]() {
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + team), "n"(kTeamThreads) : "memory");
  };
  const int first = blockIdx.x * kTeams + team, step = gridDim.x * kTeams;
  if (first < tiles) {
    const Tile t = s8_tile(first, tiles_x, tiles_y);
    load_planes_async<64>(x + t.b * img_in, H, W, t.y0 - 2, t.x0 - 2, kS8OH + 4, kS8IW, in_base,
                          kS8PIN, tt, kTeamThreads);
  }
  cp_async_wait_all();
  fence_async_smem();
  __syncthreads();
  mbar_wait(bar, 0);

  #pragma unroll 1
  for (int tile = first; tile < tiles; tile += step) {
    const Tile t = s8_tile(tile, tiles_x, tiles_y);
    // conv_a, M-tiles wg, wg + 2, wg + 4: one accumulator at a time; the
    // other teams' warpgroups keep the tensor cores busy meanwhile
    #pragma unroll 1
    for (int mt = wg; mt < kS8MTA; mt += kNWG) {
      int acc[32];
      s8_conv_tile<64, kS8IW, kS8PIN, 128, 64 * 64>(a_rows(in_base, mt), w_base, acc);
      s8_mid_out<64>(acc, mt, s_aff, s_mid, t, H, W);
    }
    // the mid was written by the threads and is read by the tensor cores
    fence_async_smem();
    team_sync();
    // both warpgroups are done with the input tile: copy the next one
    if (tile + step < tiles) {
      const Tile n = s8_tile(tile + step, tiles_x, tiles_y);
      load_planes_async<64>(x + n.b * img_in, H, W, n.y0 - 2, n.x0 - 2, kS8OH + 4, kS8IW,
                            in_base, kS8PIN, tt, kTeamThreads);
    }
    #pragma unroll 1
    for (int mt = wg; mt < kS8MTB; mt += kNWG) {
      int acc[32];
      s8_conv_tile<64, kS8MW, kS8PMID, kS8MW * 16, 64 * 64>(b_block(mid_base, mt),
                                                            w_base + T64_W, acc);
      s8_out<64, true>(acc, mt, s_aff + 32, relu, stage, out, t, H, W);
    }
    // the next input tile has landed; both warpgroups are done with the mid
    cp_async_wait_all();
    fence_async_smem();
    team_sync();
  }
}

// -- 64-128-128 pool, 128-128-128 (pool or not): slabs streamed --
// A work unit is one M-tile and all 128 output channels (one int32
// accumulator, 64 registers a thread). In a pass of a conv, warpgroup w
// takes M-tiles w, w + 2, ... (at most U of them), and each pass streams
// its conv's 9 tap slabs.
constexpr int kS8WGs = 2;                       // warpgroups a block
constexpr int kS8Threads = tc::kWG * kS8WGs;
constexpr int kS8Ring = 4;                      // slab buffers
constexpr int kS8UA = 1, kS8UB = 2;             // units a warpgroup and pass
constexpr int kS8PA = (kS8MTA + kS8WGs * kS8UA - 1) / (kS8WGs * kS8UA);  // conv_a passes: 3
constexpr int kS8PB = (kS8MTB + kS8WGs * kS8UB - 1) / (kS8WGs * kS8UB);  // conv_b passes: 1

template <int CIN, bool POOL>
struct S8Ringed {
  static constexpr int SLAB_A = CIN * 128, SLAB_B = 128 * 128;
  // CIN 64: conv_a's 73,728 B of slabs fit beside the rest, resident
  static constexpr bool RES_A = CIN == 64;
  static constexpr int SLABS = 9 * ((RES_A ? 0 : kS8PA) + kS8PB);  // streamed a tile
  static constexpr int OFF_RING = RES_A ? 9 * SLAB_A : 0;
  static constexpr int OFF_IN = OFF_RING + kS8Ring * SLAB_B;
  static constexpr int OFF_MID = OFF_IN + CIN / 16 * kS8PIN;
  static constexpr int STAGE_ROWS = POOL ? 4 : 16;
  static constexpr int OFF_STAGE = OFF_MID + 8 * kS8PMID;
  static constexpr int OFF_AFF = OFF_STAGE + 4 * kS8WGs * STAGE_ROWS * kStagePitch<128>;
  static constexpr int OFF_BAR = OFF_AFF + 128 * 16;
  static constexpr int SMEM = OFF_BAR + (kS8Ring + 1) * 8;
  static_assert((kS8MTA * 64 + 2 * kS8IW + 2 - kS8NIN) * 16 <= 8 * kS8PMID, "input slack");
  static_assert(SMEM <= 232448, "shared memory");
};

// One pass of a streamed conv: this warpgroup's M-tiles pass * 2 U + wg
// + 2 i (i < U, those below MT) into acc, tap by tap, one commit group a
// tap; after each, wait for the warpgroup's previous group, synchronise
// the block and let done() hand the previous slab's buffer back.
template <int CIN, int MT, int U, int TW, int PLANE, int SBO, typename ATile, typename Slab,
          typename Done>
__device__ __forceinline__ void s8_conv_pass(int (&acc)[U][64], int pass, ATile a_tile,
                                             Slab slab, Done done) {
  const int wg = threadIdx.x / tc::kWG;
  #pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const uint32_t b = slab();
    const uint32_t shift = ((tap / 3) * TW + tap % 3) * 16;
    tc::wgmma_fence();
    #pragma unroll
    for (int i = 0; i < U; ++i) {
      const int mt = pass * kS8WGs * U + wg + kS8WGs * i;
      if (mt < MT)  // the same in every thread of the warpgroup
        tc::s8_tap_issue<CIN, PLANE, SBO, 128>(a_tile(mt) + shift, b, acc[i], tap);
    }
    tc::wgmma_commit();
    tc::wgmma_wait<1>();
    __syncthreads();
    done();
  }
  tc::wgmma_wait<0>();
  #pragma unroll
  for (int i = 0; i < U; ++i) tc::fence_regs(acc[i]);
}

template <int CIN, bool POOL>
__global__ void __launch_bounds__(kS8Threads, 1)
double_conv3x3_s8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wa,
                         const float* __restrict__ ma, const float* __restrict__ ba,
                         const int8_t* __restrict__ wb, const float* __restrict__ mb,
                         const float* __restrict__ bb, int8_t* __restrict__ out, int H, int W,
                         int relu_b, int tiles_x, int tiles_y, int tiles) {
  using namespace tc;
  using L = S8Ringed<CIN, POOL>;
  extern __shared__ __align__(128) int8_t smem[];
  float4* s_aff = reinterpret_cast<float4*>(smem + L::OFF_AFF);  // conv_a's 64 pairs, conv_b's
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::OFF_BAR);  // the ring's, then conv_a's
  const S8Ring<kS8Ring> ring{smem + L::OFF_RING, L::SLAB_B, bars};
  const int wg = threadIdx.x / kWG;
  int8_t* s_mid = smem + L::OFF_MID;
  int8_t* stage = smem + L::OFF_STAGE + (threadIdx.x / 32) * L::STAGE_ROWS * kStagePitch<128>;
  const uint32_t in_base = smem_u32(smem + L::OFF_IN), mid_base = smem_u32(s_mid);
  const uint32_t wa_base = smem_u32(smem);  // conv_a's resident slabs (CIN 64)
  const size_t img_in = static_cast<size_t>(H) * W * CIN;
  const bool relu = relu_b != 0;
  // this block's tiles and the slabs it streams: a tile's conv_a taps
  // kS8PA times (unless resident), then conv_b's kS8PB times
  const int n_mine = blockIdx.x < tiles ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int n_slabs = L::SLABS * n_mine;
  auto fill = [&](int s) {
    const int k = s % L::SLABS;
    if (!L::RES_A && k < 9 * kS8PA)
      ring.fill(s, wa + (k % 9) * L::SLAB_A, L::SLAB_A);
    else
      ring.fill(s, wb + (k % 9) * L::SLAB_B, L::SLAB_B);
  };
  if (threadIdx.x == 0) {
    if constexpr (L::RES_A) mbar_init(bars + kS8Ring, 1);
    ring.init();
    if constexpr (L::RES_A) {
      mbar_expect_tx(bars + kS8Ring, 9 * L::SLAB_A);
      for (int o = 0; o < 9 * L::SLAB_A; o += kBulkChunk)
        bulk_copy(smem + o, wa + o, min(kBulkChunk, 9 * L::SLAB_A - o), bars + kS8Ring);
    }
    for (int s = 0; s < kS8Ring && s < n_slabs; ++s) fill(s);
  }
  for (int i = threadIdx.x; i < 64; i += blockDim.x) {
    s_aff[i] = make_float4(ma[2 * i], ma[2 * i + 1], ba[2 * i], ba[2 * i + 1]);
    s_aff[64 + i] = make_float4(mb[2 * i], mb[2 * i + 1], bb[2 * i], bb[2 * i + 1]);
  }
  if (blockIdx.x < tiles) {
    const Tile t = s8_tile(blockIdx.x, tiles_x, tiles_y);
    load_planes_async<CIN>(x + t.b * img_in, H, W, t.y0 - 2, t.x0 - 2, kS8OH + 4, kS8IW,
                           in_base, kS8PIN, threadIdx.x, blockDim.x);
  }
  cp_async_wait_all();
  fence_async_smem();
  __syncthreads();
  if constexpr (L::RES_A) mbar_wait(bars + kS8Ring, 0);

  int seq = 0;  // slabs consumed
  auto slab = [&]() { return ring.wait(seq); };
  // every warpgroup is done with slab seq - 1: refill its buffer
  auto done = [&]() {
    if (threadIdx.x == 0 && seq >= 1 && seq - 1 + kS8Ring < n_slabs) fill(seq - 1 + kS8Ring);
    ++seq;
  };
  #pragma unroll 1
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const Tile t = s8_tile(tile, tiles_x, tiles_y);
    if constexpr (L::RES_A) {
      // conv_a from its resident slabs, one M-tile at a time a warpgroup,
      // with no block synchronisation: one warpgroup's epilogue runs under
      // the other's products
      #pragma unroll 1
      for (int mt = wg; mt < kS8MTA; mt += kS8WGs) {
        int acc[64];
        s8_conv_tile<CIN, kS8IW, kS8PIN, 128, L::SLAB_A, 128>(a_rows(in_base, mt), wa_base, acc);
        s8_mid_out<128>(acc, mt, s_aff, s_mid, t, H, W);
      }
    } else {
      #pragma unroll 1
      for (int pass = 0; pass < kS8PA; ++pass) {
        int acc[kS8UA][64];
        s8_conv_pass<CIN, kS8MTA, kS8UA, kS8IW, kS8PIN, 128>(
            acc, pass, [&](int mt) { return a_rows(in_base, mt); }, slab, done);
        #pragma unroll
        for (int i = 0; i < kS8UA; ++i) {
          const int mt = pass * kS8WGs * kS8UA + wg + kS8WGs * i;
          if (mt < kS8MTA) s8_mid_out<128>(acc[i], mt, s_aff, s_mid, t, H, W);
        }
      }
    }
    fence_async_smem();
    __syncthreads();
    if (tile + gridDim.x < tiles) {
      const Tile n = s8_tile(tile + gridDim.x, tiles_x, tiles_y);
      load_planes_async<CIN>(x + n.b * img_in, H, W, n.y0 - 2, n.x0 - 2, kS8OH + 4, kS8IW,
                             in_base, kS8PIN, threadIdx.x, blockDim.x);
    }
    #pragma unroll 1
    for (int pass = 0; pass < kS8PB; ++pass) {
      int acc[kS8UB][64];
      s8_conv_pass<128, kS8MTB, kS8UB, kS8MW, kS8PMID, kS8MW * 16>(
          acc, pass, [&](int mt) { return b_block(mid_base, mt); }, slab, done);
      #pragma unroll
      for (int i = 0; i < kS8UB; ++i) {
        const int mt = pass * kS8WGs * kS8UB + wg + kS8WGs * i;
        if (mt < kS8MTB) s8_out<128, POOL>(acc[i], mt, s_aff + 64, relu, stage, out, t, H, W);
      }
    }
    cp_async_wait_all();
    fence_async_smem();
    __syncthreads();
  }
}

// grid: as many blocks as the card holds at once (once per kernel), at
// most one a tile
template <typename K>
cudaError_t persistent_launch(K kern, int threads, int smem, int tiles, int& blocks_max,
                              cudaStream_t stream, const void* x, const void* wa, const void* ma,
                              const void* ba, const void* wb, const void* mb, const void* bb,
                              void* out, int H, int W, int relu_b, int tiles_x, int tiles_y) {
  if (blocks_max == 0) {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem);
    blocks_max = max(per_sm, 1) * sms;
  }
  kern<<<min(tiles, blocks_max), threads, smem, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(wa),
      static_cast<const float*>(ma), static_cast<const float*>(ba),
      static_cast<const int8_t*>(wb), static_cast<const float*>(mb),
      static_cast<const float*>(bb), static_cast<int8_t*>(out), H, W, relu_b, tiles_x, tiles_y,
      tiles);
  return cudaGetLastError();
}

int dispatch_s8(const void* x, const void* wa, const void* ma, const void* ba, const void* wb,
                const void* mb, const void* bb, void* out, int B, int H, int W, int cin, int cm,
                int co, int pool, int relu_b, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (B < 0 || H < 0 || W < 0 || (pool && (H % 2 || W % 2)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_x = (W + kS8OW - 1) / kS8OW, tiles_y = (H + kS8OH - 1) / kS8OH;
  const int tiles = B * tiles_x * tiles_y;
  static int max_team = 0, max_64p = 0, max_128 = 0, max_128p = 0;
  const bool take = cm == 128 && co == 128 && (cin == 64 ? pool : cin == 128);
  if (!(cin == 64 && cm == 64 && co == 64 && pool) && !take)
    return static_cast<int>(cudaErrorInvalidValue);
  if (tiles == 0) return static_cast<int>(cudaSuccess);
  cudaError_t err;
  if (cm == 64)
    err = persistent_launch(double_conv3x3_s8_team_kernel, kTeamThreads * kTeams, T64_SMEM, tiles,
                            max_team, s, x, wa, ma, ba, wb, mb, bb, out, H, W, relu_b, tiles_x,
                            tiles_y);
  else if (cin == 64)
    err = persistent_launch(double_conv3x3_s8_kernel<64, true>, kS8Threads,
                            S8Ringed<64, true>::SMEM, tiles, max_64p, s, x, wa, ma, ba, wb, mb,
                            bb, out, H, W, relu_b, tiles_x, tiles_y);
  else if (pool)
    err = persistent_launch(double_conv3x3_s8_kernel<128, true>, kS8Threads,
                            S8Ringed<128, true>::SMEM, tiles, max_128p, s, x, wa, ma, ba, wb, mb,
                            bb, out, H, W, relu_b, tiles_x, tiles_y);
  else
    err = persistent_launch(double_conv3x3_s8_kernel<128, false>, kS8Threads,
                            S8Ringed<128, false>::SMEM, tiles, max_128, s, x, wa, ma, ba, wb, mb,
                            bb, out, H, W, relu_b, tiles_x, tiles_y);
  return static_cast<int>(err);
}

// bf16 on the tensor cores: output tile OH x OW, MTA / MTB M-tiles per
// warpgroup and pass for conv_a / conv_b, the channels split over the
// warpgroups when NS is 2 (see tc_conv3x3), MINB blocks per SM
template <int CIN, int CM, int CO, bool POOL, int OH, int OW, int MTA, int MTB, int NS,
          int MINB>
__global__ void __launch_bounds__(tc::kThreads, MINB)
double_conv3x3_tc_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ wa,
                         const float* __restrict__ ma, const float* __restrict__ ba,
                         const int8_t* __restrict__ wb, const float* __restrict__ mb,
                         const float* __restrict__ bb, __nv_bfloat16* __restrict__ out, int H,
                         int W, int relu_b, int tiles_x) {
  using namespace tc;
  constexpr int SLAB_A = CIN * CM * 2, SLAB_B = CM * CO * 2;
  constexpr int SLAB = SLAB_A > SLAB_B ? SLAB_A : SLAB_B;
  constexpr int MW = OW + 2, NMID = (OH + 2) * MW;
  constexpr int TILES_A = (NMID + 63) / 64, TILES_B = OH * OW / 64;
  constexpr int PASSES_A = (TILES_A + kNWG / NS * MTA - 1) / (kNWG / NS * MTA);
  constexpr int PASSES_B = (TILES_B + kNWG / NS * MTB - 1) / (kNWG / NS * MTB);
  extern __shared__ __align__(128) int8_t smem_tc[];
  int8_t* s_in = smem_tc + kRing * SLAB;                   // (OH+4) x (OW+4) x CIN
  int8_t* s_mid = s_in + (OH + 4) * (OW + 4) * CIN * 2;  // (OH+2) x (OW+2) x CM
  float* s_aff = reinterpret_cast<float*>(s_mid + NMID * CM * 2);  // ma, ba, mb, bb
  uint64_t* bars = reinterpret_cast<uint64_t*>(s_aff + 2 * CM + 2 * CO);
  const int b = blockIdx.y;
  const int y0 = (blockIdx.x / tiles_x) * OH, x0 = (blockIdx.x % tiles_x) * OW;
  SlabRing ring{smem_tc, SLAB, bars, {wa, wb}, {SLAB_A, SLAB_B}, {PASSES_A * 9, PASSES_B * 9}, 0};
  ring_start(ring);
  for (int i = threadIdx.x; i < CM; i += blockDim.x) {
    s_aff[i] = ma[i];
    s_aff[CM + i] = ba[i];
  }
  for (int i = threadIdx.x; i < CO; i += blockDim.x) {
    s_aff[2 * CM + i] = mb[i];
    s_aff[2 * CM + CO + i] = bb[i];
  }
  load_tile_async<CIN * 2>(
      reinterpret_cast<const int8_t*>(x) + static_cast<size_t>(b) * H * W * CIN * 2, H, W,
      y0 - 2, x0 - 2, OH + 4, OW + 4, s_in);
  __syncthreads();
  // mid position q = (r, c) is image (y0 - 1 + r, x0 - 1 + c); its tap
  // (0, 0) is input tile pixel (r, c)
  tc_conv3x3<CIN, CM, MTA, NS, TILES_A>(
      s_in, OW + 4, ring,
      [](int row) {
        const int q = min(row, NMID - 1);
        return (q / MW) * (OW + 4) + q % MW;
      },
      MidEpilogue<CM, CM / NS>{s_aff, s_aff + CM, s_mid, NMID, MW, H, W, y0, x0});
  __syncthreads();
  const size_t out_img = POOL ? static_cast<size_t>(H / 2) * (W / 2) : static_cast<size_t>(H) * W;
  tc_conv3x3<CM, CO, MTB, NS, TILES_B>(
      s_mid, MW, ring,
      [](int row) {
        int ty, tx;
        out_pixel<OW>(row, ty, tx);
        return ty * MW + tx;
      },
      OutEpilogue<CO, CO / NS, OW, POOL>{s_aff + 2 * CM, s_aff + 2 * CM + CO, relu_b != 0,
                                out + b * out_img * CO, H, W, y0, x0});
}

template <int CIN, int CM, int CO, bool POOL, int OH, int OW, int MTA, int MTB, int NS,
          int MINB>
cudaError_t launch_tc(const void* x, const void* wa, const void* ma, const void* ba,
                      const void* wb, const void* mb, const void* bb, void* out, int B, int H,
                      int W, int relu_b, cudaStream_t stream) {
  constexpr int SLAB = (CIN * CM > CM * CO ? CIN * CM : CM * CO) * 2;
  constexpr int smem = tc::kRing * SLAB + (OH + 4) * (OW + 4) * CIN * 2 +
                       (OH + 2) * (OW + 2) * CM * 2 + (2 * CM + 2 * CO) * 4 +
                       tc::kRing * 8;
  auto kern = double_conv3x3_tc_kernel<CIN, CM, CO, POOL, OH, OW, MTA, MTB, NS, MINB>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles_x = (W + OW - 1) / OW, tiles_y = (H + OH - 1) / OH;
  kern<<<dim3(tiles_x * tiles_y, B), tc::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(wa),
      static_cast<const float*>(ma), static_cast<const float*>(ba),
      static_cast<const int8_t*>(wb), static_cast<const float*>(mb),
      static_cast<const float*>(bb), static_cast<__nv_bfloat16*>(out), H, W, relu_b, tiles_x);
  return cudaGetLastError();
}

int dispatch_tc(const void* x, const void* wa, const void* ma, const void* ba, const void* wb,
                const void* mb, const void* bb, void* out, int B, int H, int W, int cin, int cm,
                int co, int pool, int relu_b, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (cin == 64 && cm == 64 && co == 64 && pool)
    return launch_tc<64, 64, 64, true, 16, 16, 2, 2, 1, 2>(x, wa, ma, ba, wb, mb, bb, out, B, H, W,
                                                        relu_b, s);
  if (cin == 64 && cm == 128 && co == 128 && pool)
    return launch_tc<64, 128, 128, true, 8, 16, 3, 2, 2, 1>(x, wa, ma, ba, wb, mb, bb, out, B, H, W,
                                                         relu_b, s);
  if (cin == 128 && cm == 128 && co == 128 && !pool)
    return launch_tc<128, 128, 128, false, 8, 16, 3, 2, 2, 1>(x, wa, ma, ba, wb, mb, bb, out, B, H,
                                                           W, relu_b, s);
  if (cin == 128 && cm == 128 && co == 128 && pool)
    return launch_tc<128, 128, 128, true, 8, 16, 3, 2, 2, 1>(x, wa, ma, ba, wb, mb, bb, out, B, H,
                                                          W, relu_b, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x (B, H, W, cin) int8; wa/wb the (3, 3, c, c') int8 weights packed by
// pack_slabs ([9][c'/8][c/16][8][16]); ma/ba (cm,), mb/bb (co,) float32;
// out (B, H, W, co) or pooled (B, H/2, W/2, co) int8. Supported (cin,
// cm, co, pool): (64, 64, 64, 1), (64, 128, 128, 1), (128, 128, 128, 0)
// and (128, 128, 128, 1); pool needs even H and W. B, H or W 0 launches
// nothing.
extern "C" int double_conv3x3_launch(const void* x, const void* wa, const void* ma,
                                     const void* ba, const void* wb, const void* mb,
                                     const void* bb, void* out, int B, int H, int W,
                                     int cin, int cm, int co, int pool, int relu_b,
                                     void* stream) {
  return dispatch_s8(x, wa, ma, ba, wb, mb, bb, out, B, H, W, cin, cm, co, pool, relu_b, stream);
}

// The same with bf16 x, mid and out, and weights packed by pack_slabs
// ([9][co/8][ci/8][8][8] bf16, see conv_tc.cuh).
extern "C" int double_conv3x3_bf16_launch(const void* x, const void* wa, const void* ma,
                                          const void* ba, const void* wb, const void* mb,
                                          const void* bb, void* out, int B, int H, int W,
                                          int cin, int cm, int co, int pool, int relu_b,
                                          void* stream) {
  return dispatch_tc(x, wa, ma, ba, wb, mb, bb, out, B, H, W, cin, cm, co, pool, relu_b, stream);
}
