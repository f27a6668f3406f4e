// Bicubic descriptor sampling at keypoints: a (B, Hc, Wc, C) descriptor
// map (bf16 or float32) read at (B, K, 2) (y, x) pixel coordinates ->
// (B, K, C) float32, optionally L2-normalized.
//
// Replaces spnerf_tpu/kernels/desc_sample_pallas.py sample_descriptors_fused.
// The TPU kernel builds a dense (kb, Hc * Wc) interpolation matrix in VMEM
// and contracts it with the whole map on the MXU, because the MXU is its
// fast path and gathers are slow there; only 16 entries of each row are
// non-zero. Here the same function is a 16-tap read per point.
//
// Bound on an H100 SXM: bytes. At batch 64, 60 x 80 x 256 and K 1,024 the
// bf16 map is 157 MB, the float32 output 67 MB: 0.0671 ms at 3.35 TB/s;
// the 0.5 GFLOP of multiply-adds are far below the float32 rate.
//
// Two instances, chosen by shape alone (kernels/desc_sample.py):
//
// Ring (bf16 map, C % 8 == 0, five map rows and the bucket arrays within
// the 227 KB a block may hold: desc_sample_ring_kernel). A gather reads
// each point's 16 taps of 512 B through L2, about 3.4 times the map at
// the path's operands, and a warp waits on them one by one. Here a block
// owns one band of base rows of one image and reads each map row the band
// needs once from HBM. It reads its image's K points and buckets them by
// their clamped base row b in shared memory (a counting sort; the order
// inside a bucket depends on the atomics and changes no bit, since every
// point is computed alone). The bands split the image's rows so that each
// holds about the same work, a row weighing its points plus the cost of
// streaming it (kRowCost points): a request's candidates crowd into part
// of the frame, and with equal bands the fuller one set the pace. A
// point of base row b reads rows b - 1 .. b + 2 (clamped), so the band
// [r0, r1) loads rows r0 - 1 .. r1 + 1 and base row r can be processed
// once rows up to r + 2 are resident. One producer warp streams the rows
// in order, one cp.async.bulk each, into a ring of five row slots (row y
// in slot (y - lo) % 5) onto a "full" mbarrier per slot; a row that no
// point of the band reads arrives without a copy. 24 consumer warps walk
// the base rows in order, waiting on each row's full barrier as it
// becomes needed, take the band's points round-robin (one warp a point,
// as the gather; its taps read from shared memory 4 at a time, which
// keeps a thread within the 80 registers that 25 warps allow), and after
// base row r arrive on the "empty" barrier of row r - 1's slot, which the
// producer waits on before loading row r + 4 there. The band count comes
// from B and the SM count, so that about one block runs on each SM (2
// bands at B 64 on 132 SMs: the map once plus halo rows, ~170 MB, instead
// of ~540 MB of L2 reads). The consumers set the pace more than the rows
// do: more consumer warps ran faster up to 24, and the row stream alone
// (no point sampled) takes little more than half the kernel's time
// (tools/desc_sample_variants.py; PERF.md row 8).
//
// Gather (float32 maps, C % 8 != 0, rows too wide for five slots:
// desc_sample_gather_kernel). One warp per point, 4 points per block of
// 128 threads; the map is read straight from global memory. All 16 tap
// loads are issued at their clamped (always valid) addresses before any
// multiply-add, and merged taps are dropped by a select, not a branch.
//
// Both: lane l holds channels [8 l, 8 l + 8) of each 256-channel chunk,
// read as 16-byte vectors when C % 8 == 0 (two for float32), else one by
// one. The four taps of each axis are clamped to [0, n - 1]; a tap that
// lands on its predecessor's index is merged into the first of its run
// (weights summed in tap order, as the TPU kernel stacks them). The
// combined weight is bf16(float32(wy) * float32(wx)). The map is read as
// bf16, and products (exact in float32) are summed by FMA in float32 over (y tap, x tap) in row-major order,
// skipping merged taps. The sum of squares is a fixed-order xor-butterfly
// over the warp; with C > 256 the chunks are written unnormalized and
// scaled in a second pass over the same lane's own values. Two launches
// give the same bits, and both instances give the same bits.
//
// Numerics follow the plain version (kernels/desc_sample.py) to the bit
// but for the normalization's sum order: the weights are built with
// explicitly rounded intrinsics in its order of operations (nvcc would
// otherwise contract the cubic polynomial into FMAs, and one float32 ulp
// of a weight can flip its bf16 rounding).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "conv_tc.cuh"

namespace {

using spnerf::tc::bulk_copy;
using spnerf::tc::mbar_expect_tx;
using spnerf::tc::mbar_init;
using spnerf::tc::mbar_wait;
using spnerf::tc::smem_u32;

constexpr int kChunk = 256;  // channels per warp pass: 32 lanes x 8
constexpr float kA = -0.75f;

constexpr int kGatherThreads = 128;
constexpr int kSlots = 5;          // ring row slots: four in use, one loading
constexpr int kConsumers = 24;     // consumer warps of a ring block
constexpr int kRingThreads = 32 * (kConsumers + 1);
constexpr int kRowCost = 16;       // a row's streaming cost, in points sampled
constexpr int kRingOffset = 128;   // bytes of barriers and the band before the ring
constexpr int kSmemMax = 232448;   // dynamic shared memory a block may hold

// The ring block's shared memory: barriers and the band's rows, five
// rows of Wc x C bf16, the image's bucket starts and the band's fill
// cursors (Hc + 1 each) and the band's point order (at most K).
struct RingLayout {
  long long row_bytes, ints_off, bytes;
  __host__ __device__ RingLayout(int Hc, int Wc, int C, int K)
      : row_bytes(2LL * Wc * C),
        ints_off(kRingOffset + kSlots * row_bytes),
        bytes(ints_off + 4 * (2 * (Hc + 1LL) + K)) {}
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// the raw coordinate (coord + 0.5) / grid - 0.5
__device__ __forceinline__ float axis_src(float coord, int grid) {
  return __fsub_rn(__fdiv_rn(__fadd_rn(coord, 0.5f), static_cast<float>(grid)), 0.5f);
}

// the floor bounded to [-4, n + 4]: beyond these bounds every tap clamps
// to the same index anyway, and the bound keeps the cast to int defined
// for any finite coordinate
__device__ __forceinline__ int axis_base(float base, int n) {
  return static_cast<int>(fminf(fmaxf(base, -4.f), static_cast<float>(n + 4)));
}

// the base row a point is bucketed by: its taps lie in rows r - 1 .. r + 2
__device__ __forceinline__ int base_row(float coord, int n, int grid) {
  return min(max(axis_base(floorf(axis_src(coord, grid)), n), 0), n - 1);
}

// The four clamped taps of one axis with their merged Keys weights;
// first[j] is false for a tap merged into an earlier one.
__device__ __forceinline__ void axis_taps(float coord, int n, int grid, int idx[4],
                                          float w[4], bool first[4]) {
  const float src = axis_src(coord, grid);
  const float base = floorf(src);
  const float t = __fsub_rn(src, base);
  const float t2 = __fmul_rn(t, t);
  const float t3 = __fmul_rn(t2, t);
  float raw[4];
  raw[0] = __fmul_rn(kA, __fadd_rn(__fsub_rn(t3, __fmul_rn(2.f, t2)), t));
  raw[1] = __fadd_rn(__fsub_rn(__fmul_rn(kA + 2.f, t3), __fmul_rn(kA + 3.f, t2)), 1.f);
  raw[2] = __fsub_rn(__fadd_rn(__fmul_rn(-(kA + 2.f), t3), __fmul_rn(2.f * kA + 3.f, t2)),
                     __fmul_rn(kA, t));
  raw[3] = __fmul_rn(kA, __fadd_rn(-t3, t2));
  const int b = axis_base(base, n);
#pragma unroll
  for (int j = 0; j < 4; ++j) idx[j] = min(max(b + j - 1, 0), n - 1);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    first[j] = j == 0 || idx[j] != idx[j - 1];
    float m = raw[j];
#pragma unroll
    for (int k = j + 1; k < 4; ++k)
      if (idx[k] == idx[j]) m = __fadd_rn(m, raw[k]);
    w[j] = m;
  }
}

// One point's taps: clamped rows and columns, the 16 combined weights and
// whether each axis's tap is the first of its index (tap (i, j) is read
// where both are). Each lane forms them all: a warp issues the same
// instructions whether one lane or 32 do the work, and forming each
// weight on one lane and shuffling it to the warp measured slower.
struct Taps {
  int iy[4], ix[4];
  float w[16];
  bool fy[4], fx[4];
};

__device__ __forceinline__ void point_taps(float y, float x, int Hc, int Wc, int grid, Taps& t) {
  float wy[4], wx[4];
  axis_taps(y, Hc, grid, t.iy, wy, t.fy);
  axis_taps(x, Wc, grid, t.ix, wx, t.fx);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) t.w[4 * i + j] = round_bf16(__fmul_rn(wy[i], wx[j]));
}

__device__ __forceinline__ void unpack_bf16(const uint4& q, float v[8]) {
  const uint32_t words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(words[i] << 16);
    v[2 * i + 1] = __uint_as_float(words[i] & 0xFFFF0000u);
  }
}

// Tap loaders: ``load`` fetches channels [c, c + 8) of tap (i, j) (the
// first ``left`` valid) into a Raw, ``unpack`` makes the bf16 values.

// bf16 map rows resident in the ring (C % 8 == 0)
struct RingTaps {
  static constexpr bool kVec = true;
  static constexpr int kBatch = 4;  // taps loaded before their multiply-adds
  using Raw = uint4;
  const unsigned char* rows[4];  // the slot of each y tap
  int ix[4], C;
  __device__ __forceinline__ void load(Raw& r, int i, int j, int c, int) const {
    r = *reinterpret_cast<const uint4*>(rows[i] + 2 * (static_cast<long long>(ix[j]) * C + c));
  }
  __device__ __forceinline__ static void unpack(const Raw& r, float v[8]) { unpack_bf16(r, v); }
};

template <typename T, bool VEC>
struct GatherRaw;
template <>
struct GatherRaw<__nv_bfloat16, true> {
  uint4 q;
};
template <>
struct GatherRaw<float, true> {
  float4 a, b;
};
template <typename T>
struct GatherRaw<T, false> {
  float v[8];
};

// one image's map in global memory
template <typename T, bool VEC>
struct GlobalTaps {
  static constexpr bool kVec = VEC;
  static constexpr int kBatch = 16;
  using Raw = GatherRaw<T, VEC>;
  const T* map;
  int iy[4], ix[4], Wc, C;
  __device__ __forceinline__ void load(Raw& r, int i, int j, int c, int left) const {
    const T* p = map + (static_cast<size_t>(iy[i]) * Wc + ix[j]) * C + c;
    if constexpr (!VEC) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if constexpr (sizeof(T) == 2)
          r.v[k] = k < left ? __bfloat162float(p[k]) : 0.f;
        else
          r.v[k] = k < left ? __ldg(reinterpret_cast<const float*>(p) + k) : 0.f;
      }
    } else if constexpr (sizeof(T) == 2) {
      r.q = __ldg(reinterpret_cast<const uint4*>(p));
    } else {
      r.a = __ldg(reinterpret_cast<const float4*>(p));
      r.b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    }
  }
  __device__ __forceinline__ static void unpack(const Raw& r, float v[8]) {
    if constexpr (!VEC) {
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = sizeof(T) == 2 ? r.v[k] : round_bf16(r.v[k]);
    } else if constexpr (sizeof(T) == 2) {
      unpack_bf16(r.q, v);
    } else {
      const float f[8] = {r.a.x, r.a.y, r.a.z, r.a.w, r.b.x, r.b.y, r.b.z, r.b.w};
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = round_bf16(f[k]);
    }
  }
};

__device__ __forceinline__ void store8(float* p, int left, bool vec, const float v[8]) {
  if (vec) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (i < left) p[i] = v[i];
  }
}

// One point by one warp: the 16 taps' loads issued together, then the
// multiply-adds in (y tap, x tap) order, merged taps dropped by a select;
// the row ``dst`` of C float32 written, normalized if asked.
template <class L>
__device__ __forceinline__ void sample_point(const L& ld, const Taps& t, float* dst, int C,
                                             int normalize, int lane) {
  const bool one_chunk = C <= kChunk;
  float acc[8];
  float ss = 0.f;
  for (int c0 = 0; c0 < C; c0 += kChunk) {
    const int c = c0 + lane * 8;
    const int left = c < C ? (L::kVec ? 8 : min(8, C - c)) : 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] = 0.f;
    if (left > 0) {
#pragma unroll
      for (int q0 = 0; q0 < 16; q0 += L::kBatch) {
        typename L::Raw raw[L::kBatch];
#pragma unroll
        for (int q = 0; q < L::kBatch; ++q)
          ld.load(raw[q], (q0 + q) >> 2, (q0 + q) & 3, c, left);
#pragma unroll
        for (int q = 0; q < L::kBatch; ++q) {
          float v[8];
          L::unpack(raw[q], v);
          const bool read = t.fy[(q0 + q) >> 2] && t.fx[(q0 + q) & 3];
          // bf16 x bf16 is exact in float32: the FMA rounds once, as the
          // plain version's add does
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const float s = fmaf(t.w[q0 + q], v[k], acc[k]);
            acc[k] = read ? s : acc[k];
          }
        }
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) ss = fmaf(acc[k], acc[k], ss);
      if (!(normalize && one_chunk)) store8(dst + c, left, L::kVec, acc);
    }
  }
  if (!normalize) return;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, off));
  const float den = __fadd_rn(__fsqrt_rn(ss), 1e-12f);
  if (one_chunk) {
    const int c = lane * 8;
    const int left = c < C ? (L::kVec ? 8 : min(8, C - c)) : 0;
    if (left > 0) {
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[k] = __fdiv_rn(acc[k], den);
      store8(dst + c, left, L::kVec, acc);
    }
    return;
  }
  for (int c0 = 0; c0 < C; c0 += kChunk) {
    const int c = c0 + lane * 8;
    const int left = c < C ? min(8, C - c) : 0;
    for (int k = 0; k < left; ++k) dst[c + k] = __fdiv_rn(dst[c + k], den);
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kGatherThreads)
desc_sample_gather_kernel(const T* __restrict__ desc, const float* __restrict__ pts,
                          float* __restrict__ out, int B, int K, int Hc, int Wc, int C, int grid,
                          int normalize) {
  const long long point =
      (static_cast<long long>(blockIdx.x) * kGatherThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (point >= static_cast<long long>(B) * K) return;  // the whole warp
  const int b = static_cast<int>(point / K);
  Taps t;
  point_taps(pts[2 * point], pts[2 * point + 1], Hc, Wc, grid, t);
  GlobalTaps<T, VEC> ld;
  ld.map = desc + static_cast<size_t>(b) * Hc * Wc * C;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ld.iy[i] = t.iy[i];
    ld.ix[i] = t.ix[i];
  }
  ld.Wc = Wc;
  ld.C = C;
  sample_point(ld, t, out + static_cast<size_t>(point) * C, C, normalize, lane);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"r"(kConsumers * 32) : "memory");
}

// The base rows [r0, r1) of band ``band`` of an image whose points per
// base row sum to start[] (start[r]: the points of base rows < r). Each
// row weighs its points plus kRowCost, and boundary b is the first row at
// which the weight before it reaches b / bands of the whole, moved so
// that every band keeps at least one row. Every block of the image
// computes the same boundaries (kernels/desc_sample.py band_rows).
__device__ void band_split(const int* start, int Hc, int bands, int band, int& r0, int& r1) {
  const long long total = start[Hc] + static_cast<long long>(kRowCost) * Hc;
  int r = 0, prev = 0;
  r0 = 0;
  r1 = Hc;
  for (int b = 1; b < bands && b <= band + 1; ++b) {
    while (r < Hc && (start[r] + static_cast<long long>(kRowCost) * r) * bands <
                         static_cast<long long>(b) * total)
      ++r;
    const int x = min(max(r, prev + 1), Hc - bands + b);
    if (b == band) r0 = x;
    if (b == band + 1) r1 = x;
    prev = x;
  }
}

// One block per (image, band of base rows); see the header.
__global__ void __launch_bounds__(kRingThreads, 1)
desc_sample_ring_kernel(const __nv_bfloat16* __restrict__ desc, const float* __restrict__ pts,
                        float* __restrict__ out, int K, int Hc, int Wc, int C, int grid,
                        int normalize, int bands) {
  extern __shared__ __align__(128) unsigned char smem[];
  const RingLayout lay(Hc, Wc, C, K);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kSlots;
  int* rows = reinterpret_cast<int*>(empty + kSlots);  // the band's r0, r1
  unsigned char* ring = smem + kRingOffset;
  int* start = reinterpret_cast<int*>(smem + lay.ints_off);  // Hc + 1 bucket starts
  int* cursor = start + Hc + 1;                               // the band's fill cursors
  int* order = cursor + Hc + 1;                               // the band's points
  const int img = blockIdx.x / bands, band = blockIdx.x - img * bands;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* P = pts + 2LL * img * K;
  const int row_bytes = static_cast<int>(lay.row_bytes);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  for (int i = threadIdx.x; i <= Hc; i += kRingThreads) start[i] = 0;
  __syncthreads();
  // bucket sizes of the whole image at start[1 + r]
  for (int k = threadIdx.x; k < K; k += kRingThreads)
    atomicAdd(start + 1 + base_row(P[2 * k], Hc, grid), 1);
  __syncthreads();
  if (warp == 0) {  // inclusive scan: start[i] = points of base rows < i
    int carry = 0;
    for (int i0 = 1; i0 <= Hc; i0 += 32) {
      const int i = i0 + lane;
      int v = i <= Hc ? start[i] : 0;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += u;
      }
      v += carry;
      if (i <= Hc) start[i] = v;
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
    __syncwarp();
    if (lane == 0) band_split(start, Hc, bands, band, rows[0], rows[1]);
  }
  __syncthreads();
  const int r0 = rows[0], r1 = rows[1];
  const int lo = max(r0 - 1, 0), hi = min(r1 + 1, Hc - 1);  // the rows loaded

  if (warp == kConsumers) {  // the producer
    if (lane == 0) {
      const unsigned char* map = reinterpret_cast<const unsigned char*>(desc) +
                                 static_cast<size_t>(img) * Hc * row_bytes;
      for (int y = lo; y <= hi; ++y) {
        const int u = (y - lo) / kSlots, s = (y - lo) - u * kSlots;
        if (u > 0) mbar_wait(empty + s, (u - 1) & 1);  // row y - 5 is released
        // base rows y - 2 .. y + 1 read row y
        const int a = max(y - 2, r0), z = min(y + 1, r1 - 1);
        if (a <= z && start[z + 1] > start[a]) {
          mbar_expect_tx(full + s, static_cast<uint32_t>(row_bytes));
          bulk_copy(ring + static_cast<size_t>(s) * row_bytes,
                    map + static_cast<size_t>(y) * row_bytes, static_cast<uint32_t>(row_bytes),
                    full + s);
        } else {
          mbar_arrive(full + s);  // no point of the band reads it
        }
      }
    }
    return;
  }

  // the band's points in base-row order, from position 0
  for (int i = threadIdx.x; i < r1 - r0; i += kConsumers * 32)
    cursor[i] = start[r0 + i] - start[r0];
  consumers_sync();
  for (int k = threadIdx.x; k < K; k += kConsumers * 32) {
    const int r = base_row(P[2 * k], Hc, grid);
    if (r >= r0 && r < r1) order[atomicAdd(cursor + r - r0, 1)] = k;
  }
  consumers_sync();

  int next = lo;  // the next row whose full barrier this warp waits on
  int p = warp;   // this warp's next position in the band's order
  for (int r = r0; r < r1; ++r) {
    for (const int need = min(r + 2, hi); next <= need; ++next) {
      const int u = (next - lo) / kSlots;
      mbar_wait(full + (next - lo - u * kSlots), u & 1);
    }
    for (const int end = start[r + 1] - start[r0]; p < end; p += kConsumers) {
      const int k = order[p];
      Taps t;
      point_taps(P[2 * k], P[2 * k + 1], Hc, Wc, grid, t);
      RingTaps ld;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ld.rows[i] = ring + static_cast<size_t>((t.iy[i] - lo) % kSlots) * row_bytes;
        ld.ix[i] = t.ix[i];
      }
      ld.C = C;
      sample_point(ld, t, out + (static_cast<size_t>(img) * K + k) * C, C, normalize, lane);
    }
    if (r - 1 >= lo) {  // row r - 1 is read by no later base row
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + (r - 1 - lo) % kSlots);
    }
  }
}

bool ring_takes(int Hc, int Wc, int C, int K) {
  return C % 8 == 0 && RingLayout(Hc, Wc, C, K).bytes <= kSmemMax;
}

// the ring kernel's shared memory limit, raised once per device
cudaError_t ring_smem_attribute() {
  static bool raised[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(desc_sample_ring_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return err;
    raised[dev] = true;
  }
  return cudaSuccess;
}

}  // namespace

// Shared memory bytes of a ring block, or -1 where the ring cannot take
// the shape (the wrapper's ``ring_bytes`` states the same layout).
extern "C" long long desc_sample_ring_bytes(int Hc, int Wc, int C, int K) {
  if (Hc <= 0 || Wc <= 0 || C <= 0 || K <= 0 || !ring_takes(Hc, Wc, C, K)) return -1;
  return RingLayout(Hc, Wc, C, K).bytes;
}

// desc (B, Hc, Wc, C) bf16 (modes 0 ring, 1 gather) or float32 (mode 2,
// gather); pts (B, K, 2) float32 (y, x) pixels; out (B, K, C) float32;
// bands: the ring's bands per image. Pointers 16-byte aligned.
extern "C" int desc_sample_launch(const void* desc, const void* pts, void* out, int B, int K,
                                  int Hc, int Wc, int C, int grid, int normalize, int mode,
                                  int bands, void* stream) {
  if (B <= 0 || K <= 0 || Hc <= 0 || Wc <= 0 || C <= 0 || grid <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto P = static_cast<const float*>(pts);
  auto O = static_cast<float*>(out);
  const bool vec = C % 8 == 0;
  if (mode == 0) {
    const long long blocks = static_cast<long long>(B) * bands;
    if (!ring_takes(Hc, Wc, C, K) || bands < 1 || bands > Hc || blocks > 0x7FFFFFFFLL)
      return static_cast<int>(cudaErrorInvalidValue);
    const int smem = static_cast<int>(RingLayout(Hc, Wc, C, K).bytes);
    const cudaError_t err = ring_smem_attribute();
    if (err != cudaSuccess) return static_cast<int>(err);
    desc_sample_ring_kernel<<<static_cast<unsigned>(blocks), kRingThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(desc), P, O, K, Hc, Wc, C, grid, normalize, bands);
    return static_cast<int>(cudaGetLastError());
  }
  const long long warps = static_cast<long long>(B) * K;
  const long long blocks = (warps * 32 + kGatherThreads - 1) / kGatherThreads;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned g = static_cast<unsigned>(blocks);
  if (mode == 1) {
    auto D = static_cast<const __nv_bfloat16*>(desc);
    if (vec)
      desc_sample_gather_kernel<__nv_bfloat16, true>
          <<<g, kGatherThreads, 0, s>>>(D, P, O, B, K, Hc, Wc, C, grid, normalize);
    else
      desc_sample_gather_kernel<__nv_bfloat16, false>
          <<<g, kGatherThreads, 0, s>>>(D, P, O, B, K, Hc, Wc, C, grid, normalize);
  } else if (mode == 2) {
    auto D = static_cast<const float*>(desc);
    if (vec)
      desc_sample_gather_kernel<float, true>
          <<<g, kGatherThreads, 0, s>>>(D, P, O, B, K, Hc, Wc, C, grid, normalize);
    else
      desc_sample_gather_kernel<float, false>
          <<<g, kGatherThreads, 0, s>>>(D, P, O, B, K, Hc, Wc, C, grid, normalize);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
