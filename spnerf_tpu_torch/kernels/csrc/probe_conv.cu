// The 9-tap conv probe on the tensor cores: for every row r of an input x
// (R rows of W + 2 pixels, C channels, int8 or bf16) and output pixel j,
//
//   out[r, j, :] = relu(sum_{dy, dx} x[r, j + dx, :] @ w[3 dy + dx])
//
// where dy only picks the weight: all nine taps read the same row, as in
// the TPU kernels this replaces (benchmarks/micro_conv2.py:62
// bench_pallas_conv_rate, its body at :75; benchmarks/micro_conv3.py:30
// bench_pallas_conv, kernel_acc :43 and kernel_concat :52). Those are
// rate probes, not a convolution of the model: the row band (1, Hb, W + 2,
// C) of a grid step only sets the TPU's block size, and rows never mix.
// int8: int32 sums, ReLU, then the cast to int8, which wraps modulo 256
// (the reference's astype; no saturation). bf16: float32 sums, ReLU,
// bf16 to nearest even.
//
// The implicit GEMM is M = R W pixels, N = C, K = 9 C, tap-major, in
// chunks of 128 bytes of K (one tap's KC = 64 bf16 or 128 int8 input
// channels; 64 at int8 C 64) x BN = min(C, 128) output channels, every
// chunk's wgmma (m64nBNk32 .s32.s8.s8 or m64nBNk16 .f32.bf16.bf16, A and
// B from shared memory) adding into one accumulator per
// M-tile. Two tap orders, a template parameter, as the two TPU bodies:
// - acc9 (kernel_acc): nine products, each over a view of the resident
//   input tile shifted by the tap's dx. An M-tile's tile is 66 pixels
//   (the two-column halo) in planes of 16-byte channel chunks (chunk c
//   of pixel p at plane c, byte 16 p: conv_tc_s8.cuh's A layout), so a
//   shift is a descriptor start 16 dx bytes on.
// - concat (kernel_concat): one product over the (64, 9 C) patch, the
//   nine shifted copies of the input, streamed a K chunk at a time: the
//   A operand of chunk (tap, kc) is a copy of the M-tile's 64 pixels at
//   the tap's dx offset, 128 bytes of K a pixel (64 at int8 C 64), as a
//   swizzled K-major tile (TMA's 128B / 64B swizzle, wgmma's layout 1 /
//   2), so that TMA moves whole 128-byte rows.
//
// The design. Persistent blocks, warp-specialised, fed by TMA:
// - A block is two consumer warpgroups (two M-tiles each: an item of
//   four M-tiles, 256 pixels) and a producer whose thread 0 issues every
//   copy (at BN 128 a warpgroup, setmaxnreg giving its registers to the
//   consumers; at BN 64 a warp);
//   about one block an SM walks the items blockIdx / CL, + grid / CL, ...
//   and, inside an item, every block of BN output channels (C 256: two).
//   The launch sizes the grid to the clusters that fit at once.
// - The input comes by a tensor map over x seen as bytes. acc9: (16 of
//   a chunk, W + 2 pixels, C ES / 16 chunks, R rows), a box of 16 x 66 x
//   all chunks landing in the plane layout. concat: (C ES, W + 2, R), a
//   box of 128 x 64 pixels at (kc 128, j0 + dx, r). TMA's zero fill
//   stands for the pixels past W + 2. The weights (pack_probe_weights'
//   chunks) come by bulk copies.
// - Buffers: acc9's input tiles in AST stages of an item each (the next
//   item's tiles arrive while this one computes and stores); a ring of
//   S slots a K chunk each (concat's four A slices, the streamed weight
//   chunk, or both). Each has a full mbarrier (the producer's expected
//   bytes) and an empty one that every consumer warpgroup arrives on,
//   the producer waiting on it before the slot's next copy: no
//   __syncthreads after the start. Consumers keep one wgmma group in
//   flight (wgmma.wait_group 1) and release a chunk's slot when its
//   group is done, by an arrival with the default CTA-scope release
//   (with a cluster-scope one the streamed instances ran 1.7-1.8x
//   slower, about 1.3 us more a chunk).
// - Weights read fewer times: resident (loaded once a block) where the
//   nine taps fit beside the input's buffers (acc9 int8 C 64 and C 128,
//   bf16 C 64; concat int8 C 64, bf16 C 64); elsewhere streamed through
//   the ring to a cluster of CL = 2 blocks, each block fetching half of
//   every chunk from L2 and multicasting it to both: L2 serves a chunk
//   once per 2 x 256 = 512 output pixels. Weight bytes the schedule
//   asks of L2 in a call (counted from it, as
//   probe_conv.weight_l2_bytes_model does; no counter on the card
//   measures them): resident 9 C BN ES a block; streamed ceil(M-tiles /
//   8) x 9 C C ES. At the probe files' shapes (480 bands of 8 x 640 at C 64 and
//   128, of 8 x 320 at C 256; P2 bands of 16 for bf16 C 128 and int8 C
//   256): acc9 bf16 C 128 1.42 GB (2.83 in the first version), bf16 C
//   256 2.83, int8 C 256 1.42; concat int8 C 128 0.71 GB (5.66), bf16 C
//   128 2.83 (22.6), int8 C 256 2.83; the resident instances 5-20 MB.
// - The epilogue: ReLU and the cast in registers, a transpose across
//   each quad of lanes (shuffles) so that a lane holds 16 consecutive
//   bytes of a pixel's channels, then 16-byte stores; the producer is
//   already loading the next item meanwhile. No products overlap it:
//   both consumer warpgroups end an item together. Starting warpgroup 1
//   2-8 chunks behind warpgroup 0 (a named barrier), so that one's
//   products run under the other's epilogue, measured from 3% faster to
//   12% slower, slower in most instances, and leaving the stores out
//   gained about 1% (PERF.md's Findings): the epilogue is not what holds
//   the kernel.
// - A barrier wait that cannot complete traps (tma.cuh's mbar_wait).
//
// Bound on an H100 SXM: operations at C 128 and 256, bytes at C 64.
// int8 at C 128, 480 bands of 8 x 640: 0.725 TOP, 0.366 ms at 1,979
// TOP/s, against 630 MB of input and output, 0.188 ms at 3.35 TB/s; bf16
// at the same shape 0.733 ms. concat also reads the input nine times
// from L2 into shared memory (2.8 GB at int8 C 128, 11.3 GB at P2's bf16
// C 128), which its TMA boxes of 128-byte rows keep under the products'
// time. Measured (kernel_times --match probe_conv, NVIDIA H100 80GB
// HBM3 at 700 W): 49-61% of the bound at C 128 and 256 in both orders,
// 21-43% at C 64 (PERF.md's kernel table, rows P1 and P2).
//
// Numerics: int8 products and int32 sums are exact in any order. bf16
// products are exact in float32; the tensor cores add them in their own
// order, so a sum may differ from the plain version's float32 sums in the
// last bits and, where that straddles a bf16 rounding boundary, the
// output by one bf16 ulp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "conv_tc_s8.cuh"
#include "tma.cuh"

namespace {

using spnerf::tc::bf16_tap_issue;
using spnerf::tc::fence_regs;
using spnerf::tc::kBulkChunk;
using spnerf::tc::kWG;
using spnerf::tc::pack_bf16x2;
using spnerf::tc::s8_tap_issue;
using spnerf::tc::smem_desc;
using spnerf::tc::smem_u32;
using spnerf::tc::wgmma_commit;
using spnerf::tc::wgmma_fence;
using spnerf::tc::wgmma_bf16_ss;
using spnerf::tc::wgmma_s8_n;
using spnerf::tc::wgmma_wait;
namespace tma = spnerf::tma;

constexpr int kTilePix = 66;               // input pixels of an acc9 M-tile: 64 + the halo
constexpr int kPlaneIn = 16 * kTilePix;    // bytes of an acc9 input plane
constexpr int kConsumers = 2;              // consumer warpgroups a block
constexpr int kMT = 2;                     // M-tiles of a consumer warpgroup
constexpr int kMPB = kConsumers * kMT;     // M-tiles of a block's item
constexpr int kSmemMax = 232448;           // shared memory a block can have
constexpr int kBarBytes = 256;             // room for the mbarriers

// S8: int8 operands (else bf16); C input = output channels; CONCAT the
// tap order. kernels/probe_conv.kernel_config mirrors it.
template <bool S8, int C, bool CONCAT>
struct Cfg {
  static constexpr int ES = S8 ? 1 : 2;              // bytes a value
  static constexpr int CH = C * ES / 16;             // 16-byte chunks a pixel
  static constexpr int KC = (C * ES < 128 ? C * ES : 128) / ES;  // K of a chunk
  static constexpr int KCH = C / KC;                 // chunks a tap
  static constexpr int NQ = 9 * KCH;                 // chunks an N-block's product
  static constexpr int KP = KC * ES / 16;            // A planes a chunk
  static constexpr int BN = C < 128 ? C : 128;       // output channels an N-block
  static constexpr int NB = C / BN;                  // N-blocks
  // the producer: a warpgroup whose registers setmaxnreg hands to the
  // consumers where their two 64 x 128 accumulators need them (at 168 a
  // thread they spilled), else one warp (int8 acc9 C 64 then fits two
  // blocks an SM)
  static constexpr bool PWG = BN == 128;
  static constexpr int THREADS = kConsumers * kWG + (PWG ? kWG : 32);
  static constexpr int CHUNK = KC * ES * BN;         // bytes of a weight chunk
  static constexpr int W_BYTES = NQ * CHUNK;         // an N-block's weights
  static constexpr int A_TILE = CH * kPlaneIn;       // acc9: an M-tile's input
  static constexpr int A_STAGE = kMPB * A_TILE;      // acc9: an item's input
  static constexpr int SW = KC * ES;                 // concat: bytes of a slice row (swizzle)
  static constexpr int SLICE = 64 * SW;              // concat: an M-tile's chunk of A
  static constexpr int SLOT_A = CONCAT ? kMPB * SLICE : 0;
  // weights resident where they fit beside two input stages (acc9) or
  // three ring slots of A (concat)
  static constexpr bool RES =
      NB == 1 && W_BYTES + (CONCAT ? 3 * SLOT_A : 2 * A_STAGE) + kBarBytes <= kSmemMax;
  static constexpr int CL = RES ? 1 : 2;             // blocks of a cluster
  static constexpr bool RING = CONCAT || !RES;       // a ring of chunk slots
  static constexpr int SLOT = SLOT_A + (RES ? 0 : CHUNK);
  static constexpr int FREE = kSmemMax - kBarBytes - (RES ? W_BYTES : 0);
  static constexpr int AST_FIT = (FREE - (RES ? 0 : 4 * CHUNK)) / A_STAGE;
  static constexpr int AST = CONCAT ? 0 : (AST_FIT < 4 ? AST_FIT : 4);  // acc9 input stages
  static constexpr int S_FIT = RING ? (FREE - AST * A_STAGE) / SLOT : 0;
  static constexpr int S = S_FIT < 8 ? S_FIT : 8;    // ring slots
  // shared memory: resident weights, input stages, ring, barriers
  static constexpr int OFF_A = RES ? W_BYTES : 0;
  static constexpr int OFF_RING = OFF_A + AST * A_STAGE;
  static constexpr int OFF_BAR = OFF_RING + S * SLOT;
  static constexpr int SMEM = OFF_BAR + kBarBytes;
  using Acc = typename std::conditional<S8, int, float>::type;
  static_assert(CONCAT || AST >= 1, "probe_conv: no room for an input stage");
  static_assert(!RING || S >= 2, "probe_conv: no room for two ring slots");
  static_assert(8 * (1 + 2 * AST + 2 * S) <= kBarBytes, "probe_conv: barriers");
  static_assert(KP * 16 == SW, "probe_conv: a chunk is KP planes or one SW-byte row");
  static_assert(A_TILE % 128 == 0 && SLOT % 1024 == 0 && W_BYTES % 1024 == 0 &&
                    OFF_RING % 1024 == 0 && SLICE % 1024 == 0,
                "probe_conv: TMA destinations 128-byte aligned, swizzled ones 1024");
};

// the mbarriers: resident weights, acc9's stages, the ring's slots
struct Bars {
  uint32_t base;
  int ast, s;
  __device__ uint32_t wfull() const { return base; }
  __device__ uint32_t afull(int i) const { return base + 8 * (1 + i); }
  __device__ uint32_t aempty(int i) const { return base + 8 * (1 + ast + i); }
  __device__ uint32_t full(int i) const { return base + 8 * (1 + 2 * ast + i); }
  __device__ uint32_t empty(int i) const { return base + 8 * (1 + 2 * ast + s + i); }
};

// the item loop both roles walk: items first, first + stride, ...; this
// block's M-tiles of item it are (it CL + rank) kMPB + 0 .. kMPB - 1
struct Sched {
  int first, stride, n_items, rank, n_mtiles, tiles_per_row;
  __device__ int mt0(int it, int cl) const { return (it * cl + rank) * kMPB; }
};

// The k-steps K .. of one concat chunk: A a 64-row tile of SW-byte rows
// (KC values of K) as TMA's swizzle lays it (wgmma layout type 1 for
// 128B, 2 for 64B; stride byte offset 8 SW between 8-row groups; k-step
// K starts 32 K bytes into the row), B the chunk's KC x BN slab of
// pack_probe_weights (leading byte offset 128, stride 8 KC ES; k-step K
// at 256 K). Descriptors advance inside their start-address field.
template <bool S8, int KC, int SW, int BN, int K = 0>
__device__ __forceinline__ void swizzled_steps(
    typename std::conditional<S8, int, float>::type (&acc)[BN / 2], uint64_t da, uint64_t db,
    int scale_first) {
  constexpr int ES = S8 ? 1 : 2;
  if constexpr (K < KC * ES / 32) {
    if constexpr (S8)
      wgmma_s8_n<BN, 2 * K, 16 * K>(acc, da, db, K == 0 ? scale_first : 1);
    else
      wgmma_bf16_ss<BN>(acc, da + 2 * K, db + 16 * K, K == 0 ? scale_first : 1);
    swizzled_steps<S8, KC, SW, BN, K + 1>(acc, da, db, scale_first);
  }
}

template <bool S8, int KC, int SW, int BN>
__device__ __forceinline__ void swizzled_issue(
    uint32_t a, uint32_t b, typename std::conditional<S8, int, float>::type (&acc)[BN / 2],
    int scale_first) {
  static_assert(SW == 128 || SW == 64, "probe_conv: 64B or 128B swizzle");
  constexpr uint64_t kLayout = (SW == 128 ? 1ull : 2ull) << 62;
  swizzled_steps<S8, KC, SW, BN>(acc, smem_desc(a, 16, 8 * SW) | kLayout,
                                 smem_desc(b, 128, KC * 8 * (S8 ? 1 : 2)), scale_first);
}

__device__ __forceinline__ uint32_t sel4(const uint32_t (&v)[4], int k) {
  return k == 0 ? v[0] : k == 1 ? v[1] : k == 2 ? v[2] : v[3];
}

// In: v[i], word i of this lane. Out: v[s], word t of lane s of this
// quad (t = lane % 4): a 4 x 4 transpose across the quad.
__device__ __forceinline__ void quad_transpose(uint32_t (&v)[4], int t) {
  uint32_t o[4] = {v[0], v[1], v[2], v[3]};
  #pragma unroll
  for (int x = 1; x < 4; ++x) {
    // lane t ^ x wants this lane's word t ^ x; this lane gets its word t
    const uint32_t got = __shfl_xor_sync(0xffffffffu, sel4(v, t ^ x), x);
    const int s = t ^ x;
    o[0] = s == 0 ? got : o[0];
    o[1] = s == 1 ? got : o[1];
    o[2] = s == 2 ? got : o[2];
    o[3] = s == 3 ? got : o[3];
  }
  #pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = o[i];
}

// The epilogue of one M-tile (mt) and N-block (nb): accumulator register
// 4 j + 2 h + e of lane 4 g + t of warp w is M-row 16 w + g + 8 h (pixel
// j0 + row), channel 8 j + 2 t + e of the N-block. Per row, words of 4
// bytes (bf16: channels 8 j + 2 t, + 1; int8: 16 k + 2 t, + 1, 16 k + 8 +
// 2 t, + 1), transposed across the quad so that lane t holds 16-byte
// groups t, 4 + t, ... of the row, each one 16-byte store.
template <bool S8, int C, int BN>
__device__ __forceinline__ void store_tile(
    const typename std::conditional<S8, int, float>::type (&acc)[BN / 2],
    int8_t* __restrict__ out, int mt, int nb, int tiles_per_row, int W) {
  constexpr int ES = S8 ? 1 : 2;
  constexpr int NW = S8 ? BN / 16 : BN / 8;  // words (and 16-byte groups) of a row
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r = mt / tiles_per_row, j0 = (mt % tiles_per_row) * 64;
  #pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int px = j0 + 16 * warp + g + 8 * h;
    int8_t* o = out + ((static_cast<size_t>(r) * W + px) * C + nb * BN) * ES;
    #pragma unroll
    for (int m = 0; m < NW / 4; ++m) {
      uint32_t v[4];
      #pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = 4 * m + i;
        if constexpr (S8) {
          // ReLU, then the low byte: the cast wraps modulo 256
          const int a = acc[8 * k + 2 * h], b = acc[8 * k + 2 * h + 1];
          const int c = acc[8 * k + 4 + 2 * h], d = acc[8 * k + 4 + 2 * h + 1];
          v[i] = static_cast<uint32_t>(max(a, 0) & 255) |
                 (static_cast<uint32_t>(max(b, 0) & 255) << 8) |
                 (static_cast<uint32_t>(max(c, 0) & 255) << 16) |
                 (static_cast<uint32_t>(max(d, 0) & 255) << 24);
        } else {
          // ReLU that keeps NaN, as jnp.maximum and torch.clamp_min do
          const float a = acc[4 * k + 2 * h], b = acc[4 * k + 2 * h + 1];
          v[i] = pack_bf16x2(a < 0.f ? 0.f : a, b < 0.f ? 0.f : b);
        }
      }
      quad_transpose(v, t);
      uint4 q;
      if constexpr (S8) {
        q = make_uint4(__byte_perm(v[0], v[1], 0x5410), __byte_perm(v[2], v[3], 0x5410),
                       __byte_perm(v[0], v[1], 0x7632), __byte_perm(v[2], v[3], 0x7632));
      } else {
        q = make_uint4(v[0], v[1], v[2], v[3]);
      }
      if (px < W) *reinterpret_cast<uint4*>(o + (4 * m + t) * 16) = q;
    }
  }
}

// The producer's thread 0: every copy, in the order the consumers use
// them, each after its buffer's empty barrier.
template <bool S8, int C, bool CONCAT>
__device__ __forceinline__ void produce(const CUtensorMap* xmap, const int8_t* __restrict__ wpk,
                                        uint32_t smem, const Bars& bars, const Sched& sc) {
  using G = Cfg<S8, C, CONCAT>;
  if constexpr (G::RES) {
    tma::mbar_expect_tx(bars.wfull(), G::W_BYTES);
    for (int o = 0; o < G::W_BYTES; o += kBulkChunk)
      tma::bulk_load(smem + o, wpk + o, min(kBulkChunk, G::W_BYTES - o), bars.wfull());
  }
  int na = 0, nc = 0;  // input stages and ring slots filled
  for (int it = sc.first; it < sc.n_items; it += sc.stride) {
    const int mt0 = sc.mt0(it, G::CL);
    const int live = max(0, min(kMPB, sc.n_mtiles - mt0));
    if constexpr (!CONCAT) {
      const int s = na % G::AST;
      tma::mbar_wait(bars.aempty(s), ((na / G::AST) & 1) ^ 1);
      tma::mbar_expect_tx(bars.afull(s), live * G::A_TILE);
      for (int i = 0; i < live; ++i) {
        const int mt = mt0 + i;
        tma::load_4d(smem + G::OFF_A + s * G::A_STAGE + i * G::A_TILE, xmap, 0,
                     (mt % sc.tiles_per_row) * 64, 0, mt / sc.tiles_per_row, bars.afull(s));
      }
      ++na;
    }
    if constexpr (G::RING) {
      for (int nb = 0; nb < G::NB; ++nb) {
        for (int q = 0; q < G::NQ; ++q, ++nc) {
          const int k = nc % G::S;
          const uint32_t slot = smem + G::OFF_RING + k * G::SLOT;
          tma::mbar_wait(bars.empty(k), ((nc / G::S) & 1) ^ 1);
          tma::mbar_expect_tx(bars.full(k),
                              (CONCAT ? live * G::SLICE : 0) + (G::RES ? 0 : G::CHUNK));
          if constexpr (CONCAT) {
            const int tap = q / G::KCH, kc = q % G::KCH;
            for (int i = 0; i < live; ++i) {
              const int mt = mt0 + i;
              tma::load_3d(slot + i * G::SLICE, xmap, kc * G::SW,
                           (mt % sc.tiles_per_row) * 64 + tap % 3, mt / sc.tiles_per_row,
                           bars.full(k));
            }
          }
          if constexpr (!G::RES) {
            // this block's share of the chunk, to every block of the cluster
            constexpr int PART = G::CHUNK / G::CL;
            const int8_t* src =
                wpk + (static_cast<size_t>(nb) * G::NQ + q) * G::CHUNK + sc.rank * PART;
            const uint32_t dst = slot + G::SLOT_A + sc.rank * PART;
            if constexpr (G::CL > 1)
              tma::bulk_load_multicast(dst, src, PART, bars.full(k), (1u << G::CL) - 1);
            else
              tma::bulk_load(dst, src, PART, bars.full(k));
          }
        }
      }
    }
  }
}

// a consumer warpgroup's release of a ring slot, once its products from
// the slot are done (a wgmma group completes for the whole warpgroup):
// one arrival (its thread 0) on the slot's empty barrier in every block
// of the cluster
template <int CL>
__device__ __forceinline__ void release(uint32_t bar) {
  if (threadIdx.x % kWG != 0) return;
  if constexpr (CL == 1) {
    tma::mbar_arrive(bar);
  } else {
    #pragma unroll
    for (int c = 0; c < CL; ++c) tma::mbar_arrive_cluster(bar, c);
  }
}

// A consumer warpgroup: its two M-tiles of every item, chunk by chunk.
template <bool S8, int C, bool CONCAT>
__device__ __forceinline__ void consume(int8_t* __restrict__ out, uint32_t smem, const Bars& bars,
                                        const Sched& sc, int W) {
  using G = Cfg<S8, C, CONCAT>;
  const int wg = threadIdx.x / kWG;
  if constexpr (G::RES) tma::mbar_wait(bars.wfull(), 0);
  typename G::Acc acc[kMT][G::BN / 2];
  int na = 0, nc = 0;
  #pragma unroll 1
  for (int it = sc.first; it < sc.n_items; it += sc.stride) {
    const int mt0 = sc.mt0(it, G::CL) + wg * kMT;  // this warpgroup's first M-tile
    bool live[kMT];
    #pragma unroll
    for (int i = 0; i < kMT; ++i) live[i] = mt0 + i < sc.n_mtiles;
    uint32_t a_stage = 0;
    if constexpr (!CONCAT) {
      const int s = na % G::AST;
      a_stage = smem + G::OFF_A + s * G::A_STAGE + wg * kMT * G::A_TILE;
      tma::mbar_wait(bars.afull(s), (na / G::AST) & 1);
    }
    #pragma unroll 1
    for (int nb = 0; nb < G::NB; ++nb) {
      #pragma unroll 1
      for (int q = 0; q < G::NQ; ++q) {
        const int tap = q / G::KCH, kc = q % G::KCH;
        uint32_t b, slot = 0;
        if constexpr (G::RING) {
          const int n = nc + q, k = n % G::S;
          slot = smem + G::OFF_RING + k * G::SLOT;
          tma::mbar_wait(bars.full(k), (n / G::S) & 1);
          b = G::RES ? smem + q * G::CHUNK : slot + G::SLOT_A;
        } else {
          b = smem + q * G::CHUNK;
        }
        wgmma_fence();
        #pragma unroll
        for (int i = 0; i < kMT; ++i) {
          if (!live[i]) continue;
          // chunk 0 overwrites the accumulator; the others add to it
          if constexpr (CONCAT) {
            swizzled_issue<S8, G::KC, G::SW, G::BN>(slot + (wg * kMT + i) * G::SLICE, b, acc[i],
                                                    q);
          } else {
            const uint32_t a = a_stage + i * G::A_TILE + kc * G::KP * kPlaneIn + 16 * (tap % 3);
            if constexpr (S8)
              s8_tap_issue<G::KC, kPlaneIn, 128, G::BN>(a, b, acc[i], q);
            else
              bf16_tap_issue<G::KC, kPlaneIn, 128, G::BN>(a, b, acc[i], q);
          }
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous chunk's products are done
        if constexpr (G::RING)
          if (q > 0) release<G::CL>(bars.empty((nc + q - 1) % G::S));
      }
      wgmma_wait<0>();
      #pragma unroll
      for (int i = 0; i < kMT; ++i) fence_regs(acc[i]);
      if constexpr (G::RING) release<G::CL>(bars.empty((nc + G::NQ - 1) % G::S));
      nc += G::NQ;
      if constexpr (!CONCAT)
        if (nb == G::NB - 1 && threadIdx.x % kWG == 0) tma::mbar_arrive(bars.aempty(na % G::AST));
      #pragma unroll
      for (int i = 0; i < kMT; ++i)
        if (live[i]) store_tile<S8, C, G::BN>(acc[i], out, mt0 + i, nb, sc.tiles_per_row, W);
    }
    if constexpr (!CONCAT) ++na;
  }
}

template <bool S8, int C, bool CONCAT>
__global__ void __launch_bounds__(Cfg<S8, C, CONCAT>::THREADS, 1)
probe_conv_kernel(const __grid_constant__ CUtensorMap xmap, const int8_t* __restrict__ wpk,
                  int8_t* __restrict__ out, int n_mtiles, int tiles_per_row, int W) {
  using G = Cfg<S8, C, CONCAT>;
  extern __shared__ __align__(1024) unsigned char smem_probe[];
  const uint32_t smem = smem_u32(smem_probe);
  if (CONCAT && (smem & 1023) != 0) __trap();  // the swizzle needs 1024-byte tiles
  const Bars bars{smem + G::OFF_BAR, G::AST, G::S};
  const Sched sc{static_cast<int>(blockIdx.x) / G::CL, static_cast<int>(gridDim.x) / G::CL,
                 (n_mtiles + G::CL * kMPB - 1) / (G::CL * kMPB),
                 G::CL > 1 ? static_cast<int>(tma::cluster_rank()) : 0, n_mtiles,
                 tiles_per_row};
  if (threadIdx.x == 0) {
    tma::mbar_init(bars.wfull(), 1);
    for (int i = 0; i < G::AST; ++i) {
      tma::mbar_init(bars.afull(i), 1);
      tma::mbar_init(bars.aempty(i), kConsumers);
    }
    for (int i = 0; i < G::S; ++i) {
      tma::mbar_init(bars.full(i), 1);
      tma::mbar_init(bars.empty(i), G::CL * kConsumers);
    }
    tma::mbar_init_fence();
  }
  if constexpr (G::CL > 1)
    tma::cluster_sync();
  else
    __syncthreads();

  // a producer warpgroup's registers to the consumers: 40 + 2 x 232 a
  // thread of the three warpgroups fit the SM's 64 K
  if (threadIdx.x >= kConsumers * kWG) {
    if constexpr (G::PWG) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == kConsumers * kWG) produce<S8, C, CONCAT>(&xmap, wpk, smem, bars, sc);
  } else {
    if constexpr (G::PWG) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    consume<S8, C, CONCAT>(out, smem, bars, sc, W);
  }
  // no block leaves while another of its cluster may still arrive on its
  // barriers
  if constexpr (G::CL > 1) tma::cluster_sync();
}

// the launch's configuration: THREADS a block, the shared memory, a
// cluster of CL blocks
template <bool S8, int C, bool CONCAT>
struct Launch {
  using G = Cfg<S8, C, CONCAT>;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  explicit Launch(cudaStream_t stream) : cfg{} {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = G::CL;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.blockDim = dim3(G::THREADS);
    cfg.dynamicSmemBytes = G::SMEM;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// The persistent grid in blocks for R rows of W pixels: the clusters
// that fit on the card at once (found at the first call), at most one an
// item.
template <bool S8, int C, bool CONCAT>
cudaError_t grid_blocks(int R, int W, int* grid) {
  using G = Cfg<S8, C, CONCAT>;
  static_assert(G::SMEM <= kSmemMax, "probe_conv: shared memory past 227 KB");
  auto kernel = probe_conv_kernel<S8, C, CONCAT>;
  static int fit = 0;
  if (fit == 0) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
    if (err != cudaSuccess) return err;
    if constexpr (G::CL == 1) {
      int device = 0, sms = 0, per_sm = 0;
      err = cudaGetDevice(&device);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, G::THREADS,
                                                            G::SMEM);
      if (err != cudaSuccess) return err;
      fit = sms * per_sm;
    } else {
      Launch<S8, C, CONCAT> l(nullptr);
      l.cfg.gridDim = dim3(G::CL);
      err = cudaOccupancyMaxActiveClusters(&fit, kernel, &l.cfg);
      if (err != cudaSuccess) return err;
    }
    if (fit <= 0) return cudaErrorInvalidConfiguration;
  }
  const long long n_mtiles = static_cast<long long>(R) * ((W + 63) / 64);
  if (n_mtiles > 0x7fffffffLL - G::CL * kMPB) return cudaErrorInvalidValue;
  const long long n_items = (n_mtiles + G::CL * kMPB - 1) / (G::CL * kMPB);
  const long long clusters = n_items < fit ? n_items : fit;
  *grid = static_cast<int>(clusters * G::CL);
  return cudaSuccess;
}

template <bool S8, int C, bool CONCAT>
cudaError_t launch(const int8_t* x, const int8_t* wpk, int8_t* out, int R, int W,
                   cudaStream_t stream) {
  using G = Cfg<S8, C, CONCAT>;
  int grid = 0;
  const cudaError_t err = grid_blocks<S8, C, CONCAT>(R, W, &grid);
  if (err != cudaSuccess) return err;

  CUtensorMap xmap;
  const cuuint64_t pix = static_cast<cuuint64_t>(C) * G::ES, row = (W + 2) * pix;
  CUresult res;
  if constexpr (CONCAT) {
    // x as bytes (C ES of a pixel, W + 2 pixels, R rows); a box is one K
    // chunk of 64 pixels, swizzled
    const cuuint64_t dims[3] = {pix, static_cast<cuuint64_t>(W + 2), static_cast<cuuint64_t>(R)};
    const cuuint64_t strides[2] = {pix, row};
    const cuuint32_t box[3] = {G::SW, 64, 1};
    res = tma::encode_bytes<3>(
        &xmap, x, dims, strides, box,
        G::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B);
  } else {
    // x as bytes (16 of a chunk, W + 2 pixels, CH chunks, R rows); a box
    // is an M-tile's 66 pixels in planes
    const cuuint64_t dims[4] = {16, static_cast<cuuint64_t>(W + 2),
                                static_cast<cuuint64_t>(G::CH), static_cast<cuuint64_t>(R)};
    const cuuint64_t strides[3] = {pix, 16, row};
    const cuuint32_t box[4] = {16, kTilePix, G::CH, 1};
    res = tma::encode_bytes<4>(&xmap, x, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  if (res != CUDA_SUCCESS) return static_cast<cudaError_t>(10000 + static_cast<int>(res));

  Launch<S8, C, CONCAT> l(stream);
  l.cfg.gridDim = dim3(static_cast<unsigned>(grid));
  const int tiles_per_row = (W + 63) / 64;
  return cudaLaunchKernelEx(&l.cfg, probe_conv_kernel<S8, C, CONCAT>, xmap, wpk, out,
                            R * tiles_per_row, tiles_per_row, W);
}

template <bool S8, bool CONCAT>
cudaError_t by_channels(const int8_t* x, const int8_t* wpk, int8_t* out, int R, int W, int C,
                        cudaStream_t stream) {
  switch (C) {
    case 64: return launch<S8, 64, CONCAT>(x, wpk, out, R, W, stream);
    case 128: return launch<S8, 128, CONCAT>(x, wpk, out, R, W, stream);
    case 256: return launch<S8, 256, CONCAT>(x, wpk, out, R, W, stream);
    default: return cudaErrorInvalidValue;
  }
}

// Cfg as the fields of kernels/probe_conv.kernel_config, in its order
template <bool S8, int C, bool CONCAT>
void config_fields(int* f) {
  using G = Cfg<S8, C, CONCAT>;
  const int v[] = {G::CH,     G::KC,   G::KCH,  G::NQ,    G::KP,   G::BN,     G::NB,
                   G::CHUNK,  G::W_BYTES, G::A_TILE, G::A_STAGE, G::SW, G::SLICE, G::SLOT_A,
                   G::RES,    G::CL,   G::RING, G::SLOT,  G::AST,  G::S,
                   G::OFF_A,  G::OFF_RING, G::SMEM};
  for (int i = 0; i < static_cast<int>(sizeof(v) / sizeof(v[0])); ++i) f[i] = v[i];
}

template <bool S8, bool CONCAT>
cudaError_t config_by_channels(int C, int* fields) {
  switch (C) {
    case 64: config_fields<S8, 64, CONCAT>(fields); return cudaSuccess;
    case 128: config_fields<S8, 128, CONCAT>(fields); return cudaSuccess;
    case 256: config_fields<S8, 256, CONCAT>(fields); return cudaSuccess;
    default: return cudaErrorInvalidValue;
  }
}

template <bool S8, bool CONCAT>
cudaError_t grid_by_channels(int R, int W, int C, int* grid) {
  switch (C) {
    case 64: return grid_blocks<S8, 64, CONCAT>(R, W, grid);
    case 128: return grid_blocks<S8, 128, CONCAT>(R, W, grid);
    case 256: return grid_blocks<S8, 256, CONCAT>(R, W, grid);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (R, W + 2, C) int8 or bf16, wpk the packed weights of
// pack_probe_weights, out (R, W, C) of x's type; C 64, 128 or 256. A
// tensor map cuTensorMapEncodeTiled refuses returns 10000 + its CUresult.
extern "C" int probe_conv_launch(const void* x, const void* wpk, void* out, int R, int W, int C,
                                 int bf16, int concat, cudaStream_t stream) {
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(wpk);
  auto* op = static_cast<int8_t*>(out);
  if (R <= 0 || W <= 0) return cudaSuccess;
  if (bf16)
    return concat ? by_channels<false, true>(xp, wp, op, R, W, C, stream)
                  : by_channels<false, false>(xp, wp, op, R, W, C, stream);
  return concat ? by_channels<true, true>(xp, wp, op, R, W, C, stream)
                : by_channels<true, false>(xp, wp, op, R, W, C, stream);
}

// the grid (blocks) probe_conv_launch takes by itself for these operands
// (the stream is not used)
extern "C" int probe_conv_grid(int R, int W, int C, int bf16, int concat, int* grid,
                               cudaStream_t) {
  *grid = 0;
  if (R <= 0 || W <= 0) return cudaSuccess;
  if (bf16)
    return concat ? grid_by_channels<false, true>(R, W, C, grid)
                  : grid_by_channels<false, false>(R, W, C, grid);
  return concat ? grid_by_channels<true, true>(R, W, C, grid)
                : grid_by_channels<true, false>(R, W, C, grid);
}

// the compiled Cfg of an instance, 23 ints into fields (host memory; the
// stream is not used)
extern "C" int probe_conv_config(int C, int bf16, int concat, int* fields, cudaStream_t) {
  if (bf16)
    return concat ? config_by_channels<false, true>(C, fields)
                  : config_by_channels<false, false>(C, fields);
  return concat ? config_by_channels<true, true>(C, fields)
                : config_by_channels<true, false>(C, fields);
}
