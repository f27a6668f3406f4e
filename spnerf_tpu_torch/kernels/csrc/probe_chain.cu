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
// Bound on an H100 SXM: operations. R 8,192 at depth 32: 8.6 GOP, 8.7 us
// at the bf16 rate and 4.3 us at the int8 one, against 4.2 MB (bf16) of
// x, w and out, 1.3 us at 3.35 TB/s. A dependent chain cannot fill the
// card: 128 warpgroups on 132 SMs, each waiting on its own layer before
// the next; the probe measures what such a chain reaches.
//
// The rows are split over blocks of one warpgroup, one 64-row M-tile each
// (128 blocks at R 8,192). A block copies w into shared memory once,
// K-major in core matrices (the B operand of wgmma), and keeps the
// activations in registers for the whole chain: wgmma takes A from
// registers, and each layer's epilogue turns the accumulators straight
// into the next layer's A fragments, as render_tc_kernel and
// render_s8_kernel in render.cu chain their hidden layers. A bf16 m64nN
// float32 accumulator has the layout of the m64k16 A fragment, so the
// columns stay in order; an int8 one holds columns 8 j + 2 t + {0, 1},
// which are not the m64k32 fragment's, so A's column k carries unit P(k)
// (s8_unit below, render.s8_hidden_order's map) and B's row k holds w's
// row P(k), for the first layer's A (read from x in that order) as for the
// others. Only x, w and the last layer touch device memory.
//
// Times here: NVIDIA H100 80GB HBM3 at 700 W, device time by the
// profiler (tools/kernel_times.py --match probe_chain).
//
// The old limit: with one warpgroup an SM and each layer issued, waited
// for whole and only then turned into the next A, the tensor cores idled
// through every epilogue and the epilogue's latencies went unhidden
// (bf16 0.72 us a layer against 0.28 us of products; int8 1.09 against
// 0.14, its epilogue 4-5x the bf16 one); and w was staged a byte or a
// half-word a load, each load a latency (10-18 us of the call). Now half
// of the epilogue runs under the products. A layer's products are split
// by halves of N (columns 0-63 into d[0], 64-127 into d[1]; int8
// m64n64k32 in place of m64n128k32), each half its own commit group; the
// layer waits for half 0 only (wgmma.wait_group 1), runs half 0's
// epilogue (the next x's columns 0-63) while half 1's products run, then
// waits for half 1 and runs its epilogue. A wgmma reads its A registers
// until its group is waited for, so x's columns 0-63 alternate between two
// register sets by the layer's parity (half 0's epilogue writes one while
// half 1's products read the other); columns 64-127 need one set. The
// int8 epilogue is a shift, a max and half a cvt.pack.sat.s8 a value: the
// pack's saturation is the upper clip. Each loop iteration ends with
// nothing in flight: with the next layer's first products issued before
// the previous layer's last epilogue (the groups in flight across the
// loop's back edge), ptxas serialized every wgmma of the kernel (its
// C7514 advisory) and the chain ran slower than with no overlap.
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
using spnerf::render::wgmma_bf16;
using spnerf::render::wgmma_s8_rs;
using spnerf::tc::fence_regs;
using spnerf::tc::kWG;
using spnerf::tc::smem_desc;
using spnerf::tc::smem_u32;
using spnerf::tc::wgmma_commit;
using spnerf::tc::wgmma_fence;
using spnerf::tc::wgmma_wait;

constexpr int kK = 128;  // K = N of the chain

// The unit that A's column k carries in the int8 chain: column 32 s +
// 16 e + 4 t + i of k-step s is byte i of fragment register 2 e + h of lane
// 4 g + t, which holds unit 32 s + 8 (2 e + i / 2) + 2 t + i % 2 of its
// accumulators
__host__ __device__ constexpr int s8_unit(int k) {
  return 32 * (k / 32) + 8 * (2 * ((k % 32) / 16) + (k % 4) / 2) + 2 * ((k % 16) / 4) + k % 2;
}

// clip(lo >> 7, -127, 127) and clip(hi >> 7, ...) as int8 bits in the low
// 16 bits (lo the low byte), c's low 16 bits above them: the lower clip by
// max, the upper by the pack's saturation
__device__ __forceinline__ uint32_t s8_pack2(int lo, int hi, uint32_t c) {
  uint32_t r;
  asm("cvt.pack.sat.s8.s32.b32 %0, %1, %2, %3;\n"
      : "=r"(r)
      : "r"(max(hi >> 7, -127)), "r"(max(lo >> 7, -127)), "r"(c));
  return r;
}

// A-fragment registers as a use and a definition: after an epilogue, so
// that the compiler does not sink its making of fragments past the wait
// or wgmma.fence that follows; after the wait that retires the last
// product reading a set, so that its registers stay that set's until then
// (wgmma reads A registers until its group is waited for)
template <int Q>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[Q][4]) {
#pragma unroll
  for (int q = 0; q < Q; ++q)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[q][i])::"memory");
}

// four layer outputs in one A-fragment register, b0 the low byte
__device__ __forceinline__ uint32_t s8_pack4(int b0, int b1, int b2, int b3) {
  return s8_pack2(b0, b1, s8_pack2(b2, b3, 0u));
}

// One layer's half of N: k-steps [K0, K1) of d (m64n64) against the B
// half at bh. bf16: k-step ks reads A columns 16 ks..+15 (lo[ks] for ks <
// 4, hi[ks - 4] else), B at bh + 256 ks (core matrices 8 x 8, SBO 2048).
template <int K0, int K1>
__device__ __forceinline__ void bf16_steps(float (&d)[32], const uint32_t (&lo)[4][4],
                                           const uint32_t (&hi)[4][4], uint32_t bh) {
  if constexpr (K0 == 0) wgmma_bf16<64, false>(d, lo[0], smem_desc(bh, 128, 2048));
#pragma unroll
  for (int ks = K0 == 0 ? 1 : K0; ks < K1; ++ks)
    wgmma_bf16<64, true>(d, ks < 4 ? lo[ks] : hi[ks - 4], smem_desc(bh + ks * 256, 128, 2048));
}

// int8: k-step s reads A columns 32 s..+31 (lo[s] for s < 2, hi[s - 2]
// else), B at bh + 256 s (core matrices 8 x 16, SBO 1024)
template <int K0, int K1>
__device__ __forceinline__ void s8_steps(int (&d)[32], const uint32_t (&lo)[2][4],
                                         const uint32_t (&hi)[2][4], uint32_t bh) {
#pragma unroll
  for (int s = K0; s < K1; ++s)
    wgmma_s8_rs<64>(d, s < 2 ? lo[s] : hi[s - 2], smem_desc(bh + s * 256, 128, 1024), s != 0);
}

// x's columns 64 c..64 c + 63 as A fragments from the half-c accumulators
// dh (column 8 j + 2 t + i of row g + 8 h at dh[4 j + 2 h + i]): bf16
// k-step 4 c + q, register 2 e + h is j = 2 q + e
__device__ __forceinline__ void bf16_epilogue(const float (&dh)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = 2 * q + e;
        a[q][2 * e + h] = bf16x2_relu(dh[4 * j + 2 * h], dh[4 * j + 2 * h + 1]);
      }
}

// int8 k-step 2 c + q, register 2 e + h: units 8 j + 2 t + {0, 1} and
// 8 (j + 1) + 2 t + {0, 1} of the half, j = 4 q + 2 e
__device__ __forceinline__ void s8_epilogue(const int (&dh)[32], uint32_t (&a)[2][4]) {
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int lo = 4 * (4 * q + 2 * e) + 2 * h, hi = lo + 4;
        a[q][2 * e + h] = s8_pack4(dh[lo], dh[lo + 1], dh[hi], dh[hi + 1]);
      }
}

// Layer l >= 1 (P = l % 2; x_(l-1) in lo[1 - P] and hi): issues both
// halves, waits for half 0 and, unless l is the last layer (then it
// returns true with half 1 in flight), writes x_l's columns 0-63 into
// lo[P] under half 1, waits for it and writes columns 64-127 into hi.
// Returns with nothing in flight.
template <int P>
__device__ __forceinline__ bool bf16_layer(float (&d)[2][32], uint32_t (&lo)[2][4][4],
                                           uint32_t (&hi)[4][4], uint32_t b, int l, int depth) {
  wgmma_fence();
  bf16_steps<0, 8>(d[0], lo[1 - P], hi, b);
  wgmma_commit();
  bf16_steps<0, 8>(d[1], lo[1 - P], hi, b + 8 * 2048);
  wgmma_commit();
  wgmma_wait<1>();
  fence_regs(d[0]);
  if (l == depth) return true;
  bf16_epilogue(d[0], lo[P]);
  fence_frags(lo[P]);
  wgmma_wait<0>();
  fence_regs(d[1]);
  fence_frags(lo[1 - P]);
  fence_frags(hi);
  bf16_epilogue(d[1], hi);
  fence_frags(hi);
  return false;
}

template <int P>
__device__ __forceinline__ bool s8_layer(int (&d)[2][32], uint32_t (&lo)[2][2][4],
                                         uint32_t (&hi)[2][4], uint32_t b, int l, int depth) {
  wgmma_fence();
  s8_steps<0, 4>(d[0], lo[1 - P], hi, b);
  wgmma_commit();
  s8_steps<0, 4>(d[1], lo[1 - P], hi, b + 8 * 1024);
  wgmma_commit();
  wgmma_wait<1>();
  fence_regs(d[0]);
  if (l == depth) return true;
  s8_epilogue(d[0], lo[P]);
  fence_frags(lo[P]);
  wgmma_wait<0>();
  fence_regs(d[1]);
  fence_frags(lo[1 - P]);
  fence_frags(hi);
  s8_epilogue(d[1], hi);
  fence_frags(hi);
  return false;
}

// w (128 x 128, row-major) into shared memory as the B operand: element
// (k, n) at core matrix (n / 8, k / e) of 8 x e values, e = 16 bytes of K,
// the int8 rows permuted by s8_unit. w is first copied as it lies, 16
// bytes a thread and load, all loads in flight at once (a byte a load
// took one latency a value: 10-18 us of a 20-35 us chain); then thread n
// reads column n of that copy (a warp 32 neighbouring bytes or half-words,
// no bank conflict) into whole 16-byte rows of core matrices (K bytes
// 16 c..16 c + 15 of column n) and, after a barrier, writes them over it,
// a quarter-warp 128 contiguous bytes. Then the copy is made visible to
// wgmma (the async proxy).
template <bool S8>
__device__ __forceinline__ void stage_w(const int8_t* __restrict__ w, int8_t* sw) {
  constexpr int kVec = kK * kK * (S8 ? 1 : 2) / 16 / kWG;  // 16-byte vectors a thread
  const int n = threadIdx.x;  // kWG == kK: the thread's column
  {
    uint4 v[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) v[i] = reinterpret_cast<const uint4*>(w)[i * kWG + n];
#pragma unroll
    for (int i = 0; i < kVec; ++i) reinterpret_cast<uint4*>(sw)[i * kWG + n] = v[i];
  }
  __syncthreads();
  uint32_t v[kVec][4];
#pragma unroll
  for (int c = 0; c < kVec; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (S8) {
        const auto* raw = reinterpret_cast<const uint8_t*>(sw);
        const int k = 16 * c + 4 * i;
        v[c][i] = raw[s8_unit(k) * kK + n] | static_cast<uint32_t>(raw[s8_unit(k + 1) * kK + n]) << 8 |
                  static_cast<uint32_t>(raw[s8_unit(k + 2) * kK + n]) << 16 |
                  static_cast<uint32_t>(raw[s8_unit(k + 3) * kK + n]) << 24;
      } else {
        const auto* raw = reinterpret_cast<const uint16_t*>(sw);
        const int k = 8 * c + 2 * i;
        v[c][i] = raw[k * kK + n] | static_cast<uint32_t>(raw[(k + 1) * kK + n]) << 16;
      }
    }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < kVec; ++c)
    *reinterpret_cast<uint4*>(sw + ((n / 8) * kVec + c) * 128 + (n % 8) * 16) =
        make_uint4(v[c][0], v[c][1], v[c][2], v[c][3]);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

template <bool S8>
__global__ void __launch_bounds__(kWG, 1)
probe_chain_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   int8_t* __restrict__ out, int R, int depth) {
  static_assert(kWG == kK, "stage_w: a thread a column of w");
  constexpr int ES = S8 ? 1 : 2;
  __shared__ __align__(128) int8_t sw[kK * kK * ES];
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
    // x_l's k-steps 0-1 in lo[l % 2], 2-3 in hi; register 2 e + h of
    // k-step s: row g + 8 h, columns 32 s + 16 e + 4 t + {0..3}, which x
    // holds in s8_unit's order at 32 s + 16 e + 2 t + {0, 1, 8, 9}
    uint32_t lo[2][2][4], hi[2][4];
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
          (s < 2 ? lo[0][s] : hi[s - 2])[2 * e + h] = v;
        }
    stage_w<true>(w, sw);
    int d[2][32] = {};
#pragma unroll 1
    for (int l = 1;; l += 2) {
      if (s8_layer<1>(d, lo, hi, b, l, depth)) break;
      if (s8_layer<0>(d, lo, hi, b, l + 1, depth)) break;
    }
    // the last layer: half 0 stored while half 1's products finish; unit
    // 8 j + 2 t + i of row g + 8 h is d[j / 8][4 (j % 8) + 2 h + i]
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (c == 1) {
        wgmma_wait<0>();
        fence_regs(d[1]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!in[h]) continue;
        int8_t* o = out + static_cast<size_t>(row[h]) * kK + 64 * c;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<uint16_t*>(o + 8 * j + 2 * t) =
              static_cast<uint16_t>(s8_pack2(d[c][4 * j + 2 * h], d[c][4 * j + 2 * h + 1], 0u));
      }
    }
  } else {
    // x_l's k-steps 0-3 in lo[l % 2], 4-7 in hi; register 2 e + h of
    // k-step ks: row g + 8 h, columns 16 ks + 8 e + 2 t + {0, 1}
    uint32_t lo[2][4][4], hi[4][4];
#pragma unroll
    for (int ks = 0; ks < 8; ++ks)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          (ks < 4 ? lo[0][ks] : hi[ks - 4])[2 * e + h] =
              in[h] ? *reinterpret_cast<const uint32_t*>(
                          x + (static_cast<size_t>(row[h]) * kK + 16 * ks + 8 * e + 2 * t) * 2)
                    : 0u;
    stage_w<false>(w, sw);
    float d[2][32];
#pragma unroll 1
    for (int l = 1;; l += 2) {
      if (bf16_layer<1>(d, lo, hi, b, l, depth)) break;
      if (bf16_layer<0>(d, lo, hi, b, l + 1, depth)) break;
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (c == 1) {
        wgmma_wait<0>();
        fence_regs(d[1]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!in[h]) continue;
        int8_t* o = out + (static_cast<size_t>(row[h]) * kK + 64 * c) * 2;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<uint32_t*>(o + (8 * j + 2 * t) * 2) =
              bf16x2_relu(d[c][4 * j + 2 * h], d[c][4 * j + 2 * h + 1]);
      }
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
