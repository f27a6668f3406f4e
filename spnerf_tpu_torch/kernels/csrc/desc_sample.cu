// Bicubic descriptor sampling at keypoints: a (B, Hc, Wc, C) descriptor
// map (bf16 or float32) read at (B, K, 2) (y, x) pixel coordinates ->
// (B, K, C) float32, optionally L2-normalized.
//
// Replaces spnerf_tpu/kernels/desc_sample_pallas.py sample_descriptors_fused.
// The TPU kernel builds a dense (kb, Hc * Wc) interpolation matrix in VMEM
// and contracts it with the whole map on the MXU, because the MXU is its
// fast path and gathers are slow there; only 16 entries of each row are
// non-zero. Here the same function is a 16-tap gather per point.
//
// Bound on an H100 SXM: bytes. At batch 64, 60 x 80 x 256 and K 1,024 the
// bf16 map is 157 MB, the float32 output 67 MB; the 0.5 GFLOP of
// multiply-adds are far below the float32 rate.
//
// Design: one warp per point, 8 points per block of 256 threads. Lane l
// holds channels [8 l, 8 l + 8) of each 256-channel chunk and reads them
// with 16-byte loads (two for float32) when C % 8 == 0, else one by one.
// The four taps of each axis are clamped to [0, n - 1]; a tap that lands
// on its predecessor's index is merged into the first of its run (weights
// summed in tap order, as the TPU kernel stacks them), so each distinct
// map element is read once. The combined weight is
// bf16(float32(wy) * float32(wx)), the map is read as bf16, and products
// (exact in float32) are summed in float32 over (y tap, x tap) in
// row-major order. The sum of squares is a fixed-order xor-butterfly over
// the warp; with C > 256 the chunks are written unnormalized and scaled in
// a second pass over the same lane's own values.
//
// Numerics follow the plain version (kernels/desc_sample.py) to the bit
// but for the normalization's sum order: the weights are built with
// explicitly rounded intrinsics in its order of operations (nvcc would
// otherwise contract the cubic polynomial into FMAs, and one float32 ulp
// of a weight can flip its bf16 rounding).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 256;  // channels per warp pass: 32 lanes x 8
constexpr float kA = -0.75f;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The four clamped taps of one axis with their merged Keys weights;
// first[j] is false for a tap merged into an earlier one.
__device__ __forceinline__ void axis_taps(float coord, int n, int grid, int idx[4],
                                          float w[4], bool first[4]) {
  const float src =
      __fsub_rn(__fdiv_rn(__fadd_rn(coord, 0.5f), static_cast<float>(grid)), 0.5f);
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
  // beyond these bounds every tap clamps to the same index anyway; the
  // bound keeps the cast to int defined for any finite coordinate
  const int b = static_cast<int>(fminf(fmaxf(base, -4.f), static_cast<float>(n + 4)));
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

// Channels [c, c + 8) of one map element, the first ``left`` of them
// valid; ``vec`` (C % 8 == 0) means all 8 are, 16-byte aligned.
template <typename T>
__device__ __forceinline__ void load8(const T* p, int left, bool vec, float v[8]);

template <>
__device__ __forceinline__ void load8<__nv_bfloat16>(const __nv_bfloat16* p, int left,
                                                     bool vec, float v[8]) {
  if (vec) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(words[i] << 16);
      v[2 * i + 1] = __uint_as_float(words[i] & 0xFFFF0000u);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = i < left ? __bfloat162float(p[i]) : 0.f;
  }
}

template <>
__device__ __forceinline__ void load8<float>(const float* p, int left, bool vec,
                                            float v[8]) {
  if (vec) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = i < left ? __ldg(p + i) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = round_bf16(v[i]);
}

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
desc_sample_kernel(const T* __restrict__ desc, const float* __restrict__ pts,
                   float* __restrict__ out, int B, int K, int Hc, int Wc, int C, int grid,
                   int normalize) {
  const long long point = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (point >= static_cast<long long>(B) * K) return;
  const int b = static_cast<int>(point / K);
  // C % 8 == 0 lets every lane take 16-byte vectors; else element by element
  const bool vec = (C & 7) == 0;

  int iy[4], ix[4];
  float wy[4], wx[4];
  bool fy[4], fx[4];
  axis_taps(pts[2 * point], Hc, grid, iy, wy, fy);
  axis_taps(pts[2 * point + 1], Wc, grid, ix, wx, fx);
  float w2[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) w2[i][j] = round_bf16(__fmul_rn(wy[i], wx[j]));

  const T* map = desc + static_cast<size_t>(b) * Hc * Wc * C;
  float* dst = out + static_cast<size_t>(point) * C;
  const bool one_chunk = C <= kChunk;
  float acc[8];
  float ss = 0.f;
  for (int c0 = 0; c0 < C; c0 += kChunk) {
    const int c = c0 + lane * 8;
    const int left = c < C ? (vec ? 8 : min(8, C - c)) : 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] = 0.f;
    if (left > 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (!fy[i]) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (!fx[j]) continue;
          float v[8];
          load8<T>(map + (static_cast<size_t>(iy[i]) * Wc + ix[j]) * C + c, left, vec, v);
          // bf16 x bf16 is exact in float32: the FMA rounds once, as the
          // plain version's add does
#pragma unroll
          for (int k = 0; k < 8; ++k) acc[k] = fmaf(w2[i][j], v[k], acc[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) ss = fmaf(acc[k], acc[k], ss);
      if (!(normalize && one_chunk)) store8(dst + c, left, vec, acc);
    }
  }
  if (!normalize) return;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, off));
  const float den = __fadd_rn(__fsqrt_rn(ss), 1e-12f);
  if (one_chunk) {
    const int c = lane * 8;
    const int left = c < C ? (vec ? 8 : min(8, C - c)) : 0;
    if (left > 0) {
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[k] = __fdiv_rn(acc[k], den);
      store8(dst + c, left, vec, acc);
    }
    return;
  }
  for (int c0 = 0; c0 < C; c0 += kChunk) {
    const int c = c0 + lane * 8;
    const int left = c < C ? min(8, C - c) : 0;
    for (int k = 0; k < left; ++k) dst[c + k] = __fdiv_rn(dst[c + k], den);
  }
}

}  // namespace

// desc (B, Hc, Wc, C) bf16 (mode 0) or float32 (mode 1); pts (B, K, 2)
// float32 (y, x) pixels; out (B, K, C) float32. Pointers 16-byte aligned.
extern "C" int desc_sample_launch(const void* desc, const void* pts, void* out, int B, int K,
                                  int Hc, int Wc, int C, int grid, int normalize, int mode,
                                  void* stream) {
  if (B <= 0 || K <= 0 || Hc <= 0 || Wc <= 0 || C <= 0 || grid <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long warps = static_cast<long long>(B) * K;
  const long long blocks = (warps * 32 + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto P = static_cast<const float*>(pts);
  auto O = static_cast<float*>(out);
  if (mode == 0)
    desc_sample_kernel<__nv_bfloat16><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(desc), P, O, B, K, Hc, Wc, C, grid, normalize);
  else if (mode == 1)
    desc_sample_kernel<float><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const float*>(desc), P, O, B, K, Hc, Wc, C, grid, normalize);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
