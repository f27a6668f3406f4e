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
// The implicit GEMM is M = R W pixels, N = C, K = 9 C, tap-major. Two tap
// orders, a template parameter, as the two TPU bodies:
// - acc9 (kernel_acc): nine products, each over a view of the resident
//   input tile shifted by the tap's dx. The tile is 66 pixels a 64-row
//   M-tile (the two-column halo; the TPU's whole band does not fit an
//   SM), in planes of 16-byte channel chunks (chunk c of pixel p at plane
//   c, byte 16 p: conv_tc_s8.cuh's A layout), so that a shift is a
//   descriptor start 16 dx bytes on and the 9 taps need no copies. Two
//   warpgroups a block, two M-tiles each, share each weight chunk.
// - concat (kernel_concat): the (64, 9 C) patch tile is built in shared
//   memory (the nine shifted copies of the input, plane tap C / 16 + c),
//   then one product over K = 9 C reads it. The patch is 9x the input
//   tile, so a block holds one M-tile and one warpgroup; bf16 at C 256
//   (288 KB) does not fit and is not built.
// Both stream the weights in chunks of 128 bytes of K (one tap's 64 bf16
// or 128 int8 input channels) x BN output channels (C up to 128; two
// blocks along N at C 256) through a ring of four shared-memory slots,
// one cp.async.bulk each on an mbarrier (conv_tc_s8.cuh's S8Ring), laid
// out on the host by kernels/probe_conv.pack_probe_weights. Every chunk's
// wgmma (m64nBNk32 .s32.s8.s8 or m64nBNk16 .f32.bf16.bf16, A and B from
// shared memory) adds into one accumulator per M-tile; the block waits
// for them before it refills the chunk's slot.
//
// Bound on an H100 SXM: operations. int8 at C 128, 480 bands of 8 x 640:
// 0.725 TOP, 0.366 ms at 1,979 TOP/s, against 630 MB of input and output,
// 0.188 ms at 3.35 TB/s; bf16 at the same shape 0.733 ms. A first
// version: right and on the tensor cores, not tuned (no overlap of one
// chunk's products with the next one's issue, 4-byte and 2-byte stores).
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

namespace {

using spnerf::tc::bf16_tap_issue;
using spnerf::tc::cp_async16;
using spnerf::tc::cp_async_wait_all;
using spnerf::tc::fence_async_smem;
using spnerf::tc::fence_regs;
using spnerf::tc::kWG;
using spnerf::tc::load_planes_async;
using spnerf::tc::pack_bf16x2;
using spnerf::tc::s8_tap_issue;
using spnerf::tc::S8Ring;
using spnerf::tc::smem_u32;
using spnerf::tc::wgmma_commit;
using spnerf::tc::wgmma_fence;
using spnerf::tc::wgmma_wait;

constexpr int kTilePix = 66;               // input pixels of an M-tile: 64 + the halo
constexpr int kPlaneIn = 16 * kTilePix;    // bytes of an acc9 input plane
constexpr int kPlanePatch = 16 * 64;       // bytes of a concat patch plane
constexpr int kSlots = 4;                  // weight-chunk ring slots

// S8: int8 operands (else bf16); C input = output channels; CONCAT the
// tap order
template <bool S8, int C, bool CONCAT>
struct Cfg {
  static constexpr int ES = S8 ? 1 : 2;              // bytes a value
  static constexpr int CH = C * ES / 16;             // 16-byte chunks a pixel
  static constexpr int KC = (C * ES < 128 ? C * ES : 128) / ES;  // K of a weight chunk
  static constexpr int KCH = C / KC;                 // weight chunks a tap
  static constexpr int NQ = 9 * KCH;                 // weight chunks a product
  static constexpr int KP = KC * ES / 16;            // A planes a weight chunk
  static constexpr int BN = C < 128 ? C : 128;       // output channels a block
  static constexpr int CHUNK = KC * ES * BN;         // bytes of a weight chunk
  static constexpr int NWG = CONCAT ? 1 : 2;         // warpgroups a block
  static constexpr int MT = CONCAT ? 1 : 2;          // M-tiles a warpgroup
  static constexpr int MPB = NWG * MT;               // M-tiles a block
  static constexpr int A_BYTES = CONCAT ? 9 * CH * kPlanePatch : MPB * CH * kPlaneIn;
  static constexpr int RING = (A_BYTES + 127) / 128 * 128;
  static constexpr int BAR = RING + kSlots * CHUNK;
  static constexpr int SMEM = BAR + 8 * kSlots;
  using Acc = typename std::conditional<S8, int, float>::type;
};

template <bool S8, int C, bool CONCAT>
__global__ void __launch_bounds__(Cfg<S8, C, CONCAT>::NWG * kWG, 1)
probe_conv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wpk,
                  int8_t* __restrict__ out, int n_mtiles, int tiles_per_row, int W) {
  using G = Cfg<S8, C, CONCAT>;
  constexpr int PIX = C * G::ES;  // bytes a pixel
  extern __shared__ __align__(128) unsigned char smem_probe[];
  const uint32_t a_base = smem_u32(smem_probe);
  const S8Ring<kSlots> ring{reinterpret_cast<int8_t*>(smem_probe + G::RING), G::CHUNK,
                            reinterpret_cast<uint64_t*>(smem_probe + G::BAR)};
  const int8_t* wsrc = wpk + static_cast<size_t>(blockIdx.y) * G::NQ * G::CHUNK;
  if (threadIdx.x == 0) {
    ring.init();
    for (int q = 0; q < kSlots && q < G::NQ; ++q) ring.fill(q, wsrc + q * G::CHUNK, G::CHUNK);
  }

  // the block's input tiles (acc9) or patch (concat), zeros past W + 2
  const int mt0 = blockIdx.x * G::MPB;
  #pragma unroll
  for (int i = 0; i < G::MPB; ++i) {
    const int mt = mt0 + i;
    if (mt >= n_mtiles) break;
    const int r = mt / tiles_per_row, j0 = (mt % tiles_per_row) * 64;
    const int8_t* row = x + static_cast<size_t>(r) * (W + 2) * PIX;
    if constexpr (CONCAT) {
      for (int e = threadIdx.x; e < 9 * G::CH * 64; e += blockDim.x) {
        const int c = e % G::CH, m = (e / G::CH) % 64, tap = e / (G::CH * 64);
        const int px = j0 + m + tap % 3;
        const bool in = px < W + 2;
        cp_async16(a_base + (tap * G::CH + c) * kPlanePatch + 16 * m,
                   in ? row + static_cast<size_t>(px) * PIX + 16 * c : row, in ? 16 : 0);
      }
    } else {
      load_planes_async<PIX>(row, 1, W + 2, 0, j0, 1, kTilePix,
                             a_base + i * G::CH * kPlaneIn, kPlaneIn, threadIdx.x, blockDim.x);
    }
  }
  cp_async_wait_all();
  fence_async_smem();
  __syncthreads();

  const int wg = threadIdx.x / kWG;
  typename G::Acc acc[G::MT][G::BN / 2];
  bool live[G::MT];
  #pragma unroll
  for (int i = 0; i < G::MT; ++i) {
    live[i] = mt0 + wg * G::MT + i < n_mtiles;
    #pragma unroll
    for (int j = 0; j < G::BN / 2; ++j) acc[i][j] = 0;
  }
  #pragma unroll 1
  for (int q = 0; q < G::NQ; ++q) {
    const uint32_t b = ring.wait(q);
    const int tap = q / G::KCH, kc = q % G::KCH;
    wgmma_fence();
    #pragma unroll
    for (int i = 0; i < G::MT; ++i) {
      if (!live[i]) continue;
      // tap 0 overwrites the accumulator; the others add to it
      if constexpr (CONCAT) {
        const uint32_t a = a_base + (tap * G::CH + kc * G::KP) * kPlanePatch;
        if constexpr (S8)
          s8_tap_issue<G::KC, kPlanePatch, 128, G::BN>(a, b, acc[i], q);
        else
          bf16_tap_issue<G::KC, kPlanePatch, 128, G::BN>(a, b, acc[i], q);
      } else {
        const uint32_t a = a_base + ((wg * G::MT + i) * G::CH + kc * G::KP) * kPlaneIn +
                           16 * (tap % 3);
        if constexpr (S8)
          s8_tap_issue<G::KC, kPlaneIn, 128, G::BN>(a, b, acc[i], q);
        else
          bf16_tap_issue<G::KC, kPlaneIn, 128, G::BN>(a, b, acc[i], q);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    #pragma unroll
    for (int i = 0; i < G::MT; ++i) fence_regs(acc[i]);
    __syncthreads();  // every warpgroup is done with the chunk's slot
    if (threadIdx.x == 0 && q + kSlots < G::NQ)
      ring.fill(q + kSlots, wsrc + (q + kSlots) * G::CHUNK, G::CHUNK);
  }

  // epilogue: accumulator register 4 j + 2 h + e is M-row 16 warp + g + 8 h
  // (pixel j0 + row), channel 8 j + 2 t + e of the block's BN
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  #pragma unroll
  for (int i = 0; i < G::MT; ++i) {
    if (!live[i]) continue;
    const int mt = mt0 + wg * G::MT + i;
    const int r = mt / tiles_per_row, j0 = (mt % tiles_per_row) * 64;
    #pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int px = j0 + 16 * warp + g + 8 * h;
      if (px >= W) continue;
      int8_t* o = out + ((static_cast<size_t>(r) * W + px) * C + blockIdx.y * G::BN) * G::ES;
      #pragma unroll
      for (int j = 0; j < G::BN / 8; ++j) {
        const int c = 8 * j + 2 * t;
        const auto v0 = acc[i][4 * j + 2 * h], v1 = acc[i][4 * j + 2 * h + 1];
        if constexpr (S8) {
          // ReLU, then the low byte: the cast wraps modulo 256
          const int b0 = (v0 < 0 ? 0 : v0) & 255, b1 = (v1 < 0 ? 0 : v1) & 255;
          *reinterpret_cast<uint16_t*>(o + c) = static_cast<uint16_t>(b0 | (b1 << 8));
        } else {
          // ReLU that keeps NaN, as jnp.maximum and torch.clamp_min do
          *reinterpret_cast<uint32_t*>(o + 2 * c) =
              pack_bf16x2(v0 < 0.f ? 0.f : v0, v1 < 0.f ? 0.f : v1);
        }
      }
    }
  }
}

template <bool S8, int C, bool CONCAT>
cudaError_t launch(const int8_t* x, const int8_t* wpk, int8_t* out, int R, int W,
                   cudaStream_t stream) {
  using G = Cfg<S8, C, CONCAT>;
  static_assert(G::SMEM <= 232448, "probe_conv: shared memory past 227 KB");
  auto kernel = probe_conv_kernel<S8, C, CONCAT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (err != cudaSuccess) return err;
  const int tiles_per_row = (W + 63) / 64;
  const long long n_mtiles = static_cast<long long>(R) * tiles_per_row;
  if (n_mtiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>((n_mtiles + G::MPB - 1) / G::MPB), C / G::BN);
  kernel<<<grid, G::NWG * kWG, G::SMEM, stream>>>(x, wpk, out, static_cast<int>(n_mtiles),
                                                   tiles_per_row, W);
  return cudaGetLastError();
}

template <bool S8, bool CONCAT>
cudaError_t by_channels(const int8_t* x, const int8_t* wpk, int8_t* out, int R, int W, int C,
                        cudaStream_t stream) {
  switch (C) {
    case 64: return launch<S8, 64, CONCAT>(x, wpk, out, R, W, stream);
    case 128: return launch<S8, 128, CONCAT>(x, wpk, out, R, W, stream);
    case 256:
      if constexpr (S8 || !CONCAT) return launch<S8, 256, CONCAT>(x, wpk, out, R, W, stream);
      return cudaErrorInvalidValue;  // the bf16 patch of C 256 is 288 KB
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (R, W + 2, C) int8 or bf16, wpk the packed weights of
// pack_probe_weights, out (R, W, C) of x's type; C 64, 128 or 256.
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
