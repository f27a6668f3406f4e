// One SuperPoint head in one kernel: 3x3 conv (CIN -> CM) -> ReLU ->
// cast to the operand type (int8 requant, or bf16) -> 1x1 dot
// (CM -> COUT) -> float32 affine (no ReLU) -> optional masked softmax
// over the first n_real lanes with the dustbin dropped -> bf16. int8
// operands with int32 sums, or bf16 operands with float32 sums.
//
// Replaces spnerf_tpu/kernels/tail_fused_pallas.py head_pallas. The
// reference pads the detector's 65 logits to 128 TPU lanes and returns
// them padded; here the padding lives only inside the kernel (the packed
// 1x1 weights are zero-padded to COUTP) and the output holds n_store
// real lanes: 64 cell probabilities, or all logits / descriptor values.
//
// Bound on an H100 SXM at 60 x 80 cells, batch 64: operations (detector
// 1.50 GMAC per image, descriptor 1.73) against ~0.6 MB read (1.2 MB in
// bf16) and <2.5 MB written per image: bf16 0.1935 and 0.2239 ms.
//
// int8 instance (head_launch), on the int8 tensor cores through
// conv_tc_s8.cuh: one block of two warpgroups per (image, 8 x 16 cell
// tile), warpgroup w the 8 x 8 cell block of columns 8 w .. 8 w + 7 as its
// 64-row M-tile (a core matrix is one block row of 8 cells, stride byte
// offset one input-tile row). The input tile with its one-cell halo
// lands by cp.async in planes of 16 channels, zeros outside the image.
// The 3x3 (128 -> 256) is 9 taps x 4 k-steps of wgmma m64n256k32
// .s32.s8.s8 into one int32 accumulator (128 registers a thread: n256
// reads A once for all 256 channels, 80 bytes of shared memory a tensor
// clock against n64's 128); its 32 KB tap slabs (pack_slabs) stream through a ring of
// three buffers by cp.async.bulk, one tap at a time, and the 1x1's
// weights (detector: one 256 x 80 slab; descriptor: two 128 x 256
// K-halves) follow them into the ring during the last taps. The mid,
// relu(affine) cast to int8 (1.5 * 2^23 rounding, half to even), goes to
// shared memory in planes of 16 channels (64 cells x 16 bytes each), and
// the 1x1 reads it there as its A operand: detector wgmma m64n80k32 (N 80,
// the narrowest int8 width above 65 lanes: N steps by 16 above 32),
// descriptor m64n256k32, 8 k-steps each. (The mid cannot
// feed the 1x1 from registers as in the bf16 instance: an s32 m64nN
// accumulator does not have the layout of an s8 m64k32 A fragment.)
// int8 products and int32 sums are exact; the epilogue is the bf16
// instance's: float32 affine (no ReLU), the detector's softmax over lanes
// [0, n_real) with IEEE expf and division (max and sum quad shuffles),
// bf16 to nearest even, only the n_store real lanes and the cells inside
// the image stored. Shared memory: ring 98,304 + input 23,040 + mid
// 32,768 + affines 2,688 or 4,096 + barriers: one block per SM.

// bf16 instance (head_bf16_launch), on the tensor cores: one block of
// two warpgroups per (image, 8 x 16 cell tile), one 64-row M-tile each
// (tile rows 0-3 and 4-7). The 3x3 (128 -> 256) is conv_tc.cuh's
// tc_conv3x3 (wgmma m64n64k16, A by ldmatrix from the swizzled input
// tile, weight slabs streamed by cp.async.bulk through a ring of two
// 64 KB buffers, two-level float32 sums). The mid never leaves the
// registers: relu(affine(acc)) rounded to bf16 is packed in place into
// the A fragments of the 1x1's 16 k-steps (a float32 m64nN accumulator
// holds, per warp, rows g and g + 8 and columns 2t, 2t + 1 of each
// 8-column group: the m64k16 A fragment of two consecutive groups), as
// FlashAttention-3 feeds P to its second product. The 1x1 runs on wgmma
// too, its weights two more ring slabs (detector: one 256 x 72 slab,
// N 72 = the narrowest multiple of 8 that holds 65 lanes; descriptor:
// two 128 x 256 K-halves), prefetched while the 3x3's last taps run, its
// sums two-level per 64 input channels. Epilogue: float32 affine (no
// ReLU); the detector's softmax over lanes [0, n_real) in float32 with
// IEEE expf and division, its max and sum quad shuffles (a row of the
// accumulator lies in the 4 lanes of a quad); bf16 to nearest even; only
// the n_store real lanes and the pixels inside the image are stored.
// Shared memory: ring 131,072 + input tile 46,080 + affines 2,624 or
// 4,096 + barriers 16 bytes: one block per SM. Registers: the 3x3's 128
// float32 sums per thread, then 64 A words + 32 or 36 sums + 32 or 36
// partials for the 1x1; ptxas (sm_90a) gives the detector's instances
// 254 and the descriptor's 192, no spills.
#include "conv_common.cuh"
#include "conv_tc_s8.cuh"

#include <math_constants.h>

namespace {

using namespace spnerf;

constexpr int TH = 8, TW = 16, NP = TH * TW;

// ---- int8 instance on the tensor cores ----

constexpr int kHeadRing = 3;                  // slab buffers
constexpr int HIW = TW + 2, HNIN = (TH + 2) * HIW;
constexpr int HPIN = HNIN * 16;               // bytes of an input plane
constexpr int HPMID = 64 * 16;                // bytes of a mid plane: 64 cells
constexpr int SLAB3 = 128 * 256;              // a tap's 128 x 256 int8 slab

template <int COUTP>
struct S8Head {
  static constexpr int KC = COUTP == 256 ? 2 : 1;  // the 1x1's K-chunks (slabs)
  static constexpr int SLAB1 = 256 / KC * COUTP;
  static constexpr int OFF_IN = kHeadRing * SLAB3;
  static constexpr int OFF_MID = OFF_IN + 8 * HPIN;
  static constexpr int OFF_AFF = OFF_MID + 2 * 16 * HPMID;
  static constexpr int OFF_BAR = OFF_AFF + 128 * 16 + 2 * COUTP * 4;
  static constexpr int SMEM = OFF_BAR + kHeadRing * 8;
  static_assert(SLAB1 <= SLAB3 && SMEM <= 232448, "ring slabs and shared memory");
};

// k-steps K .. 7 of the detector's 1x1 (N 80, one slab): A planes 2 K,
// 2 K + 1 of the mid, B rows 32 K ..
template <int K = 0>
__device__ __forceinline__ void s8_1x1_n80(int (&d)[40], uint64_t da, uint64_t db) {
  if constexpr (K < 8) {
    tc::wgmma_s8_ss_n80<2 * K * HPMID / 16, K * 256 / 16>(d, da, db, K);
    s8_1x1_n80<K + 1>(d, da, db);
  }
}

// k-steps K .. 7 of the descriptor's 1x1 (N 256): k-steps 0-3 in the
// first K-half's slab (db0), 4-7 in the second (db1)
template <int K = 0>
__device__ __forceinline__ void s8_1x1_n256(int (&d)[128], uint64_t da, uint64_t db0,
                                            uint64_t db1) {
  if constexpr (K < 8) {
    tc::wgmma_s8_ss_n256<2 * K * HPMID / 16, (K % 4) * 256 / 16>(d, da, K < 4 ? db0 : db1, K);
    s8_1x1_n256<K + 1>(d, da, db0, db1);
  }
}

// two bf16 values of lanes c, c + 1 of a cell's n_store lanes at p
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, int c, int n_store, float v0,
                                           float v1) {
  if (n_store % 2 == 0 && c + 1 < n_store) {
    *reinterpret_cast<uint32_t*>(p + c) = tc::pack_bf16x2(v0, v1);
  } else {
    if (c < n_store) p[c] = __float2bfloat16_rn(v0);
    if (c + 1 < n_store) p[c + 1] = __float2bfloat16_rn(v1);
  }
}

// The 1x1's epilogue for NCH output channels of a warp's two rows (cells
// (y, x) and (y + 1, x)): float32 affine (no ReLU), the softmax over lanes
// [0, n_real) when SOFTMAX, bf16 stores of lanes < n_store of the cells
// inside the image. d[4 j + 2 h + e]: row h, channel 8 j + 2 (lane % 4) +
// e.
template <int NCH, bool SOFTMAX>
__device__ __forceinline__ void s8_head_out(const int (&d)[NCH / 2], const float* m1,
                                            const float* b1, __nv_bfloat16* out, int H, int W,
                                            int y, int x, int n_real, int n_store) {
  const int t4 = threadIdx.x % 4;
  if constexpr (!SOFTMAX) {
    #pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (y + h >= H || x >= W) continue;
      __nv_bfloat16* p = out + (static_cast<size_t>(y + h) * W + x) * n_store;
      #pragma unroll
      for (int j = 0; j < NCH / 8; ++j) {
        const int c = 8 * j + 2 * t4;
        store_pair(p, c, n_store, affine(d[4 * j + 2 * h], m1[c], b1[c]),
                   affine(d[4 * j + 2 * h + 1], m1[c + 1], b1[c + 1]));
      }
    }
  } else {
    float v[2][NCH / 4];
    #pragma unroll
    for (int j = 0; j < NCH / 8; ++j) {
      #pragma unroll
      for (int h = 0; h < 2; ++h) {
        #pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * t4 + e;
          v[h][2 * j + e] = affine(d[4 * j + 2 * h + e], m1[c], b1[c]);
        }
      }
    }
    #pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -CUDART_INF_F;
      #pragma unroll
      for (int i = 0; i < NCH / 4; ++i)
        if (8 * (i / 2) + 2 * t4 + i % 2 < n_real) mx = fmaxf(mx, v[h][i]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      float sum = 0.f;
      #pragma unroll
      for (int i = 0; i < NCH / 4; ++i) {
        v[h][i] = 8 * (i / 2) + 2 * t4 + i % 2 < n_real ? expf(__fsub_rn(v[h][i], mx)) : 0.f;
        sum = __fadd_rn(sum, v[h][i]);
      }
      sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 1));
      sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 2));
      #pragma unroll
      for (int i = 0; i < NCH / 4; ++i) v[h][i] = __fdiv_rn(v[h][i], sum);
      if (y + h >= H || x >= W) continue;
      __nv_bfloat16* p = out + (static_cast<size_t>(y + h) * W + x) * n_store;
      #pragma unroll
      for (int j = 0; j < NCH / 8; ++j)
        store_pair(p, 8 * j + 2 * t4, n_store, v[h][2 * j], v[h][2 * j + 1]);
    }
  }
}

template <int COUTP, bool SOFTMAX>
__global__ void __launch_bounds__(tc::kThreads, 1)
head_s8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w3,
               const float* __restrict__ m3, const float* __restrict__ b3,
               const int8_t* __restrict__ w1, const float* __restrict__ m1,
               const float* __restrict__ b1, __nv_bfloat16* __restrict__ out, int H, int W,
               int n_real, int n_store, int tiles_x) {
  using namespace tc;
  using L = S8Head<COUTP>;
  extern __shared__ __align__(128) int8_t smem[];
  // m3/b3 per channel pair c = 2 i: {m3[c], m3[c + 1], b3[c], b3[c + 1]}
  float4* s_a3 = reinterpret_cast<float4*>(smem + L::OFF_AFF);
  float* s_m1 = reinterpret_cast<float*>(s_a3 + 128);
  float* s_b1 = s_m1 + COUTP;
  const S8Ring<kHeadRing> ring{smem, SLAB3, reinterpret_cast<uint64_t*>(smem + L::OFF_BAR)};
  const int wg = threadIdx.x / kWG, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int b = blockIdx.y;
  const int y0 = (blockIdx.x / tiles_x) * TH, x0 = (blockIdx.x % tiles_x) * TW;
  const uint32_t in_base = smem_u32(smem + L::OFF_IN);
  int8_t* s_mid = smem + L::OFF_MID + wg * 16 * HPMID;  // this warpgroup's 64 cells
  constexpr int n_slabs = 9 + L::KC;  // the 3x3's taps, then the 1x1's K-chunks
  auto fill = [&](int s) {
    if (s < 9)
      ring.fill(s, w3 + s * SLAB3, SLAB3);
    else
      ring.fill(s, w1 + (s - 9) * L::SLAB1, L::SLAB1);
  };
  if (threadIdx.x == 0) {
    ring.init();
    for (int s = 0; s < kHeadRing; ++s) fill(s);
  }
  for (int i = threadIdx.x; i < 128; i += blockDim.x)
    s_a3[i] = make_float4(m3[2 * i], m3[2 * i + 1], b3[2 * i], b3[2 * i + 1]);
  for (int i = threadIdx.x; i < COUTP; i += blockDim.x) {
    s_m1[i] = m1[i];
    s_b1[i] = b1[i];
  }
  load_planes_async<128>(x + static_cast<size_t>(b) * H * W * 128, H, W, y0 - 1, x0 - 1, TH + 2,
                         HIW, in_base, HPIN, threadIdx.x, blockDim.x);
  cp_async_wait_all();
  fence_async_smem();
  __syncthreads();

  // the 3x3: M-row m = 8 r + c of this warpgroup's block is cell (r, 8 wg
  // + c) of the tile, its tap (dy, dx) input tile pixel (r + dy, 8 wg + c
  // + dx); one wgmma m64n256k32 a k-step
  int acc[128];
  #pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const uint32_t slab = ring.wait(tap);
    const uint32_t a = in_base + ((tap / 3) * HIW + tap % 3 + 8 * wg) * 16;
    wgmma_fence();
    s8_tap_issue<128, HPIN, HIW * 16, 256>(a, slab, acc, tap);
    wgmma_commit();
    // once every warpgroup is done with the previous tap's slab, refill
    // its buffer kHeadRing slabs ahead
    wgmma_wait<1>();
    __syncthreads();
    if (threadIdx.x == 0 && tap >= 1 && tap - 1 + kHeadRing < n_slabs) fill(tap - 1 + kHeadRing);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  // the mid: relu(affine) as int8, channel 8 j + 2 tq (+ 1) of M-row m at
  // plane j / 2, byte 16 m + 8 (j % 2) + 2 tq
  #pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = warp * 16 + g + 8 * h;
    #pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float4 mb = s_a3[4 * j + tq];
      const int v0 = s8_cast_bits(affine(acc[4 * j + 2 * h], mb.x, mb.z), true);
      const int v1 = s8_cast_bits(affine(acc[4 * j + 2 * h + 1], mb.y, mb.w), true);
      *reinterpret_cast<uint16_t*>(s_mid + (j / 2) * HPMID + m * 16 + 8 * (j % 2) + 2 * tq) =
          s8_pack2(v0, v1);
    }
  }
  // the warpgroup's mid was written by its threads and is read by its
  // tensor cores
  fence_async_smem();
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(kWG) : "memory");

  // the 1x1: A the mid planes (leading byte offset one plane, stride byte
  // offset 8 cells), B the ring's 1x1 slabs
  uint32_t b1s[L::KC];
  #pragma unroll
  for (int c = 0; c < L::KC; ++c) b1s[c] = ring.wait(9 + c);
  const uint64_t da = smem_desc(smem_u32(s_mid), HPMID, 128);
  // row g (h 0) and g + 8 (h 1) of warp w: cells (2 w + h, g) of the block
  const int y = y0 + 2 * warp, xc = x0 + 8 * wg + g;
  __nv_bfloat16* o = out + static_cast<size_t>(b) * H * W * n_store;
  int d[COUTP / 2];
  wgmma_fence();
  if constexpr (COUTP == 80)
    s8_1x1_n80(d, da, smem_desc(b1s[0], 128, 256 * 8));
  else
    s8_1x1_n256(d, da, smem_desc(b1s[0], 128, 128 * 8), smem_desc(b1s[1], 128, 128 * 8));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d);
  s8_head_out<COUTP, SOFTMAX>(d, s_m1, s_b1, o, H, W, y, xc, n_real, n_store);
}

template <int COUTP, bool SOFTMAX>
cudaError_t launch_s8(const void* x, const void* w3, const void* m3, const void* b3,
                      const void* w1, const void* m1, const void* b1, void* out, int B, int H,
                      int W, int n_real, int n_store, cudaStream_t stream) {
  auto kern = head_s8_kernel<COUTP, SOFTMAX>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         S8Head<COUTP>::SMEM);
  if (err != cudaSuccess) return err;
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  kern<<<dim3(tiles_x * tiles_y, B), tc::kThreads, S8Head<COUTP>::SMEM, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w3),
      static_cast<const float*>(m3), static_cast<const float*>(b3),
      static_cast<const int8_t*>(w1), static_cast<const float*>(m1),
      static_cast<const float*>(b1), static_cast<__nv_bfloat16*>(out), H, W, n_real, n_store,
      tiles_x);
  return cudaGetLastError();
}

int dispatch_s8(const void* x, const void* w3, const void* m3, const void* b3, const void* w1,
                const void* m1, const void* b1, void* out, int B, int H, int W, int cin, int cm,
                int coutp, int n_real, int n_store, int softmax, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (cin != 128 || cm != 256 || n_store > coutp || n_real > coutp || B < 0 || H < 0 || W < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0 || W == 0) return static_cast<int>(cudaSuccess);
  if (coutp == 80 && softmax)
    return launch_s8<80, true>(x, w3, m3, b3, w1, m1, b1, out, B, H, W, n_real, n_store, s);
  if (coutp == 80 && !softmax)
    return launch_s8<80, false>(x, w3, m3, b3, w1, m1, b1, out, B, H, W, n_real, n_store, s);
  if (coutp == 256 && !softmax)
    return launch_s8<256, false>(x, w3, m3, b3, w1, m1, b1, out, B, H, W, n_real, n_store, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---- bf16 instance on the tensor cores ----

constexpr int kCM = 256;  // the 3x3's output channels: the 1x1's K

// The 1x1 (256 -> COUTP) and the epilogue of the bf16 head, run by each
// warpgroup on its 64-row M-tile once tc_conv3x3 has summed the 3x3: d
// holds the warp's rows g = lane / 4 and g + 8 of the tile for all 256
// mid channels. M-row q of tile t is cell (q / TW, q % TW) of the tile.
template <int COUTP, bool SOFTMAX>
struct HeadTail {
  static constexpr int KC = COUTP == 256 ? 2 : 1;  // 1x1 slabs (K-chunks)
  static constexpr int KS_SLAB = kCM / 16 / KC;     // k-steps per slab
  static constexpr uint32_t SBO = kCM / KC * 16;    // one row of core matrices
  static constexpr int NCH = COUTP == 256 ? 64 : COUTP;  // outputs per wgmma
  const float* m3;  // shared, 256
  const float* b3;
  const float* m1;  // shared, COUTP
  const float* b1;
  const int8_t* ring_buf;  // the SlabRing's buffers, bars and first 1x1 slab
  int ring_stride;
  uint64_t* bar;
  int first_slab;
  __nv_bfloat16* out;  // this image, H x W x n_store
  int H, W, y0, x0, n_real, n_store;

  __device__ __forceinline__ void store(int y, int x, int c, float v0, float v1) const {
    if (y >= H || x >= W) return;
    __nv_bfloat16* p = out + (static_cast<size_t>(y) * W + x) * n_store + c;
    if (n_store % 2 == 0 && c + 1 < n_store) {
      *reinterpret_cast<uint32_t*>(p) = tc::pack_bf16x2(v0, v1);
    } else {
      if (c < n_store) p[0] = __float2bfloat16_rn(v0);
      if (c + 1 < n_store) p[1] = __float2bfloat16_rn(v1);
    }
  }

  __device__ __forceinline__ void operator()(int tile, int, const float (&d)[kCM / 2]) const {
    using namespace tc;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32, t4 = lane % 4;
    // the mid as A fragments: k-step ks covers channels [16 ks, 16 ks + 16),
    // accumulator groups 2 ks and 2 ks + 1; a[ks][h]: h 0 (row g, channels
    // c, c + 1), 1 (row g + 8), 2 (row g, c + 8, c + 9), 3 (row g + 8)
    uint32_t a[16][4];
    #pragma unroll
    for (int ks = 0; ks < 16; ++ks) {
      #pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int c = 16 * ks + 8 * (h / 2) + 2 * t4;
        const float v0 = fmaxf(affine_rn(d[8 * ks + 2 * h], m3[c], b3[c]), 0.f);
        const float v1 = fmaxf(affine_rn(d[8 * ks + 2 * h + 1], m3[c + 1], b3[c + 1]), 0.f);
        a[ks][h] = pack_bf16x2(v0, v1);
      }
    }
    #pragma unroll
    for (int c = 0; c < KC; ++c) {
      const int s = first_slab + c;
      mbar_wait(bar + s % kRing, (s / kRing) & 1);
    }
    const int q = tile * 64 + warp * 16 + lane / 4;  // row g; row g + 8 is 8 cells right
    const int y = y0 + q / TW, x = x0 + q % TW;
    #pragma unroll 1
    for (int nc = 0; nc < COUTP / NCH; ++nc) {
      float acc[NCH / 2] = {}, part[NCH / 2] = {};
      #pragma unroll
      for (int kq = 0; kq < 4; ++kq) {  // 64 input channels: 4 k-steps
        wgmma_fence();
        fence_regs(part);
        #pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int ks = 4 * kq + i, slab = ks / KS_SLAB;
          const uint32_t base = smem_u32(ring_buf + ((first_slab + slab) % kRing) * ring_stride);
          const uint64_t desc =
              smem_desc(base + (nc * NCH / 8) * SBO + (ks % KS_SLAB) * 256, 128, SBO);
          if constexpr (NCH == 72)
            wgmma_m64n72(part, a[ks], desc, i);
          else
            wgmma_m64n64(part, a[ks], desc, i);
        }
        wgmma_commit();
        wgmma_wait0();
        fence_regs(part);
        #pragma unroll
        for (int j = 0; j < NCH / 2; ++j) acc[j] = __fadd_rn(acc[j], part[j]);
      }
      // v[h][2 j + e]: row g + 8 h, channel nc NCH + 8 j + 2 t4 + e
      float v[2][NCH / 4];
      #pragma unroll
      for (int j = 0; j < NCH / 8; ++j) {
        #pragma unroll
        for (int h = 0; h < 2; ++h) {
          #pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = nc * NCH + 8 * j + 2 * t4 + e;
            v[h][2 * j + e] = affine_rn(acc[4 * j + 2 * h + e], m1[c], b1[c]);
          }
        }
      }
      if constexpr (SOFTMAX) {
        #pragma unroll
        for (int h = 0; h < 2; ++h) {
          float mx = -CUDART_INF_F;
          #pragma unroll
          for (int i = 0; i < NCH / 4; ++i)
            if (8 * (i / 2) + 2 * t4 + i % 2 < n_real) mx = fmaxf(mx, v[h][i]);
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          float sum = 0.f;
          #pragma unroll
          for (int i = 0; i < NCH / 4; ++i) {
            v[h][i] = 8 * (i / 2) + 2 * t4 + i % 2 < n_real ? expf(__fsub_rn(v[h][i], mx)) : 0.f;
            sum = __fadd_rn(sum, v[h][i]);
          }
          sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 1));
          sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 2));
          #pragma unroll
          for (int i = 0; i < NCH / 4; ++i) v[h][i] = __fdiv_rn(v[h][i], sum);
        }
      }
      #pragma unroll
      for (int j = 0; j < NCH / 8; ++j) {
        const int c = nc * NCH + 8 * j + 2 * t4;
        store(y, x, c, v[0][2 * j], v[0][2 * j + 1]);
        store(y, x + 8, c, v[1][2 * j], v[1][2 * j + 1]);
      }
    }
  }
};

template <int COUTP, bool SOFTMAX>
__global__ void __launch_bounds__(tc::kThreads, 1)
head_tc_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w3,
               const float* __restrict__ m3, const float* __restrict__ b3,
               const int8_t* __restrict__ w1, const float* __restrict__ m1,
               const float* __restrict__ b1, __nv_bfloat16* __restrict__ out, int H, int W,
               int n_real, int n_store, int tiles_x) {
  using namespace tc;
  using Tail = HeadTail<COUTP, SOFTMAX>;
  constexpr int CIN = 128, SLAB3 = CIN * kCM * 2, SLAB1 = kCM / Tail::KC * COUTP * 2;
  constexpr int SLAB = SLAB3 > SLAB1 ? SLAB3 : SLAB1;
  extern __shared__ __align__(128) int8_t smem_tc[];
  int8_t* s_in = smem_tc + kRing * SLAB;  // (TH+2) x (TW+2) x CIN
  float* s_aff = reinterpret_cast<float*>(s_in + (TH + 2) * (TW + 2) * CIN * 2);  // m3 b3 m1 b1
  uint64_t* bars = reinterpret_cast<uint64_t*>(s_aff + 2 * kCM + 2 * COUTP);
  const int b = blockIdx.y;
  const int y0 = (blockIdx.x / tiles_x) * TH, x0 = (blockIdx.x % tiles_x) * TW;
  // slabs 0-8: the 3x3's taps; 9 (and 10): the 1x1's K-chunks
  SlabRing ring{smem_tc, SLAB, bars, {w3, w1}, {SLAB3, SLAB1}, {9, Tail::KC}, 0};
  ring_start(ring);
  for (int i = threadIdx.x; i < kCM; i += blockDim.x) {
    s_aff[i] = m3[i];
    s_aff[kCM + i] = b3[i];
  }
  for (int i = threadIdx.x; i < COUTP; i += blockDim.x) {
    s_aff[2 * kCM + i] = m1[i];
    s_aff[2 * kCM + COUTP + i] = b1[i];
  }
  load_tile_async<CIN * 2>(
      reinterpret_cast<const int8_t*>(x) + static_cast<size_t>(b) * H * W * CIN * 2, H, W,
      y0 - 1, x0 - 1, TH + 2, TW + 2, s_in);
  __syncthreads();
  // cell (r, c) of the tile has its tap (0, 0) at input tile pixel (r, c)
  tc_conv3x3<CIN, kCM, 1, 1, NP / 64>(
      s_in, TW + 2, ring, [](int row) { return (row / TW) * (TW + 2) + row % TW; },
      Tail{s_aff, s_aff + kCM, s_aff + 2 * kCM, s_aff + 2 * kCM + COUTP, smem_tc, SLAB, bars, 9,
           out + static_cast<size_t>(b) * H * W * n_store, H, W, y0, x0, n_real, n_store});
}

template <int COUTP, bool SOFTMAX>
cudaError_t launch_tc(const void* x, const void* w3, const void* m3, const void* b3,
                      const void* w1, const void* m1, const void* b1, void* out, int B, int H,
                      int W, int n_real, int n_store, cudaStream_t stream) {
  constexpr int KC = HeadTail<COUTP, SOFTMAX>::KC;
  constexpr int SLAB3 = 128 * kCM * 2, SLAB1 = kCM / KC * COUTP * 2;
  constexpr int smem = tc::kRing * (SLAB3 > SLAB1 ? SLAB3 : SLAB1) +
                       (TH + 2) * (TW + 2) * 128 * 2 + (2 * kCM + 2 * COUTP) * 4 + tc::kRing * 8;
  auto kern = head_tc_kernel<COUTP, SOFTMAX>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  kern<<<dim3(tiles_x * tiles_y, B), tc::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w3),
      static_cast<const float*>(m3), static_cast<const float*>(b3),
      static_cast<const int8_t*>(w1), static_cast<const float*>(m1),
      static_cast<const float*>(b1), static_cast<__nv_bfloat16*>(out), H, W, n_real, n_store,
      tiles_x);
  return cudaGetLastError();
}

int dispatch_tc(const void* x, const void* w3, const void* m3, const void* b3, const void* w1,
                const void* m1, const void* b1, void* out, int B, int H, int W, int cin, int cm,
                int coutp, int n_real, int n_store, int softmax, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (cin != 128 || cm != kCM || n_store > coutp || n_real > coutp)
    return static_cast<int>(cudaErrorInvalidValue);
  if (coutp == 72 && softmax)
    return launch_tc<72, true>(x, w3, m3, b3, w1, m1, b1, out, B, H, W, n_real, n_store, s);
  if (coutp == 72 && !softmax)
    return launch_tc<72, false>(x, w3, m3, b3, w1, m1, b1, out, B, H, W, n_real, n_store, s);
  if (coutp == 256 && !softmax)
    return launch_tc<256, false>(x, w3, m3, b3, w1, m1, b1, out, B, H, W, n_real, n_store, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x (B, H, W, 128) int8; w3 the (3, 3, 128, 256) int8 weights packed by
// pack_slabs ([9][256/8][128/16][8][16]); m3/b3 (256,); w1 packed by
// pack_head_1x1 (zero-padded to coutp = 80: one [80/8][256/16][8][16]
// slab; coutp = 256: two K-halves [2][256/8][128/16][8][16]); m1/b1
// (coutp,) float32; out (B, H, W, n_store) bf16. softmax (coutp 80):
// over lanes [0, n_real), storing the first n_store = n_real - 1 lanes.
// B, H or W 0 launches nothing.
extern "C" int head_launch(const void* x, const void* w3, const void* m3, const void* b3,
                           const void* w1, const void* m1, const void* b1, void* out,
                           int B, int H, int W, int cin, int cm, int coutp, int n_real,
                           int n_store, int softmax, void* stream) {
  return dispatch_s8(x, w3, m3, b3, w1, m1, b1, out, B, H, W, cin, cm, coutp, n_real, n_store,
                     softmax, stream);
}

// The same with bf16 x and mid on the tensor cores: w3 packed by
// pack_slabs ([9][256/8][128/8][8][8] bf16), w1 by pack_head_1x1
// ([coutp/8][256/8][8][8] bf16, coutp 72, or two K-halves
// [2][256/8][128/8][8][8] for coutp 256), m1/b1 (coutp,). softmax needs
// coutp 72.
extern "C" int head_bf16_launch(const void* x, const void* w3, const void* m3, const void* b3,
                                const void* w1, const void* m1, const void* b1, void* out,
                                int B, int H, int W, int cin, int cm, int coutp, int n_real,
                                int n_store, int softmax, void* stream) {
  return dispatch_tc(x, w3, m3, b3, w1, m1, b1, out, B, H, W, cin, cm, coutp, n_real, n_store,
                     softmax, stream);
}
