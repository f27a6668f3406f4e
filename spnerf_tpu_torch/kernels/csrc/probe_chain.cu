// The dependent-chain probe on the tensor cores: depth products of an
// (R, 128) activation with the same (128, 128) weight,
//
//   int8: x <- clip(x @ w >> 7, -127, 127)   (int32 sums, an arithmetic shift)
//   bf16: x <- bf16(relu(x @ w))             (float32 sums, nearest even)
//
// Replaces benchmarks/mxu_probe.py:62 pallas_chain (its kernel at :63),
// which runs all 8,192 rows in one program and asks whether int8 has a
// rate advantage over bf16 on such a chain: the shape of the render MLPs
// (render.cu), whose hidden layers chain the same way.
//
// Here the rows are split over blocks of one warpgroup, one 64-row M-tile
// each (128 blocks at R 8,192). A block copies w into shared memory once,
// K-major in core matrices (the B operand of wgmma), and keeps the
// activations in registers for the whole chain: each layer is one commit
// group of wgmma with A from registers (bf16: 2 x 8 m64n64k16; int8: 4
// m64n128k32 .s32.s8.s8), and its epilogue turns the accumulators
// straight into the next layer's A fragments, as render_tc_kernel and
// render_s8_kernel in render.cu chain their hidden layers. A bf16 m64nN
// float32 accumulator has the layout of the m64k16 A fragment, so the
// columns stay in order; an int8 one holds columns 8 j + 2 t + {0, 1},
// which are not the m64k32 fragment's, so A's column k carries unit P(k)
// (P below, render.s8_hidden_order's map) and B's row k holds w's row
// P(k), for the first layer's A (read from x in that order) as for the
// others. Only x, w and the last layer touch device memory.
//
// Bound on an H100 SXM: operations. R 8,192 at depth 32: 8.6 GOP, 8.7 us
// at the bf16 rate and 4.3 us at the int8 one, against 4.2 MB (bf16) of
// x, w and out, 1.3 us at 3.35 TB/s. A dependent chain cannot fill the
// card: 128 warpgroups on 132 SMs, each waiting on its own layer before
// the next; the probe measures what such a chain reaches.
//
// Numerics: int8 products and int32 sums are exact in any order, so the
// chain equals the plain version's bit for bit. bf16 products are exact in
// float32; the tensor cores add them in their own order, so a sum may
// differ in its last bits from the plain version's and, across a bf16
// rounding boundary, a value by one ulp, which the next layers carry.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_tc_s8.cuh"
#include "render_common.cuh"

namespace {

using spnerf::render::bf16x2_relu;
using spnerf::render::pack4;
using spnerf::render::wgmma_bf16;
using spnerf::render::wgmma_s8_rs;
using spnerf::tc::fence_regs;
using spnerf::tc::kWG;
using spnerf::tc::smem_desc;
using spnerf::tc::smem_u32;
using spnerf::tc::wgmma_commit;
using spnerf::tc::wgmma_fence;
using spnerf::tc::wgmma_wait0;

constexpr int kK = 128;  // K = N of the chain

// The unit that A's column k carries in the int8 chain: column 32 s +
// 16 e + 4 t + i of k-step s is byte i of fragment register 2 e + h of lane
// 4 g + t, which holds unit 32 s + 8 (2 e + i / 2) + 2 t + i % 2 of its
// accumulators
__host__ __device__ constexpr int s8_unit(int k) {
  return 32 * (k / 32) + 8 * (2 * ((k % 32) / 16) + (k % 4) / 2) + 2 * ((k % 16) / 4) + k % 2;
}

// clip(a >> 7, -127, 127) as int8 bits (the low byte)
__device__ __forceinline__ int s8_layer(int a) { return min(max(a >> 7, -127), 127) & 255; }

template <bool S8>
__global__ void __launch_bounds__(kWG, 1)
probe_chain_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   int8_t* __restrict__ out, int R, int depth) {
  constexpr int ES = S8 ? 1 : 2;
  __shared__ __align__(128) int8_t sw[kK * kK * ES];
  // B: element (k, n) at core matrix (n / 8, k / e) of 8 x e values, e = 16
  // bytes of K; the int8 rows permuted by s8_unit
  for (int i = threadIdx.x; i < kK * kK; i += kWG) {
    const int k = i / kK, n = i % kK;
    if constexpr (S8) {
      sw[((n / 8) * (kK / 16) + k / 16) * 128 + (n % 8) * 16 + k % 16] = w[s8_unit(k) * kK + n];
    } else {
      reinterpret_cast<uint16_t*>(sw)[((n / 8) * (kK / 8) + k / 8) * 64 + (n % 8) * 8 + k % 8] =
          reinterpret_cast<const uint16_t*>(w)[k * kK + n];
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const uint32_t b = smem_u32(sw);
  // this thread's two rows: M-rows 16 warp + g + 8 h of the block's tile
  int row[2];
  bool in[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = blockIdx.x * 64 + 16 * warp + g + 8 * h;
    in[h] = row[h] < R;
  }

  if constexpr (S8) {
    uint32_t a[4][4];
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t v = 0;
          if (in[h]) {
            const int8_t* xr = x + static_cast<size_t>(row[h]) * kK + 32 * s + 16 * e + 2 * t;
            v = *reinterpret_cast<const uint16_t*>(xr) |
                (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(xr + 8)) << 16);
          }
          a[s][2 * e + h] = v;
        }
    int d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0;
#pragma unroll 1
    for (int layer = 0; layer < depth; ++layer) {
      wgmma_fence();
      fence_regs(d);
#pragma unroll
      for (int s = 0; s < 4; ++s) wgmma_s8_rs<128>(d, a[s], smem_desc(b + s * 256, 128, 1024), s);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(d);
      if (layer + 1 == depth) break;
      // register 4 j + 2 h + i holds unit 8 j + 2 t + i of row g + 8 h
#pragma unroll
      for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int lo = 4 * (4 * s + 2 * e) + 2 * h, hi = lo + 4;
            a[s][2 * e + h] = pack4(s8_layer(d[lo]), s8_layer(d[lo + 1]), s8_layer(d[hi]),
                                    s8_layer(d[hi + 1]));
          }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!in[h]) continue;
      int8_t* o = out + static_cast<size_t>(row[h]) * kK;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        *reinterpret_cast<uint16_t*>(o + 8 * j + 2 * t) = static_cast<uint16_t>(
            s8_layer(d[4 * j + 2 * h]) | (s8_layer(d[4 * j + 2 * h + 1]) << 8));
    }
  } else {
    // register 2 e + h of k-step ks: row g + 8 h, columns 16 ks + 8 e + 2 t + {0, 1}
    uint32_t a[8][4];
#pragma unroll
    for (int ks = 0; ks < 8; ++ks)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          a[ks][2 * e + h] =
              in[h] ? *reinterpret_cast<const uint32_t*>(
                          x + (static_cast<size_t>(row[h]) * kK + 16 * ks + 8 * e + 2 * t) * 2)
                    : 0u;
    float d[2][32];  // columns 0-63 and 64-127
#pragma unroll 1
    for (int layer = 0; layer < depth; ++layer) {
      wgmma_fence();
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        // the second half's core matrices start 8 rows of N on: 8 x 2048 bytes
        const uint32_t bh = b + half * 8 * 2048;
        wgmma_bf16<64, false>(d[half], a[0], smem_desc(bh, 128, 2048));
#pragma unroll
        for (int ks = 1; ks < 8; ++ks)
          wgmma_bf16<64, true>(d[half], a[ks], smem_desc(bh + ks * 256, 128, 2048));
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(d[0]);
      fence_regs(d[1]);
      if (layer + 1 == depth) break;
      // column c = 8 j + 2 t + i of row g + 8 h is d[j / 8][4 (j % 8) + 2 h + i]
#pragma unroll
      for (int ks = 0; ks < 8; ++ks)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int j = 2 * ks + e;
            const float* dh = d[j / 8];
            a[ks][2 * e + h] = bf16x2_relu(dh[4 * (j % 8) + 2 * h], dh[4 * (j % 8) + 2 * h + 1]);
          }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!in[h]) continue;
      int8_t* o = out + static_cast<size_t>(row[h]) * kK * 2;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        *reinterpret_cast<uint32_t*>(o + (8 * j + 2 * t) * 2) =
            bf16x2_relu(d[j / 8][4 * (j % 8) + 2 * h], d[j / 8][4 * (j % 8) + 2 * h + 1]);
    }
  }
}

}  // namespace

// x (R, 128), w (128, 128) and out (R, 128), all int8 or all bf16; depth >= 1
extern "C" int probe_chain_launch(const void* x, const void* w, void* out, int R, int depth,
                                  int bf16, cudaStream_t stream) {
  if (R <= 0) return cudaSuccess;
  if (depth < 1) return cudaErrorInvalidValue;
  const dim3 grid((R + 63) / 64);
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  auto* op = static_cast<int8_t*>(out);
  if (bf16)
    probe_chain_kernel<false><<<grid, kWG, 0, stream>>>(xp, wp, op, R, depth);
  else
    probe_chain_kernel<true><<<grid, kWG, 0, stream>>>(xp, wp, op, R, depth);
  return cudaGetLastError();
}
