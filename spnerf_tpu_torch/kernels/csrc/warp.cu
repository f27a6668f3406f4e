// Bilinear homography warp of single-channel float32 images, one output
// pixel per thread: dst(x, y) = src(H^-1 (x, y, 1)), zero outside.
//
// Replaces spnerf_tpu/kernels/warp_pallas.py warp_image_fused. The TPU
// kernel builds dense (Wi, Wo) hat-weight matrices in VMEM and multiplies
// them on the MXU (Hi * Wi multiply-adds per output pixel), because the
// MXU is its fast path and gathers are slow there. Only two x taps and two
// y taps of those matrices are non-zero, so here the same function is a
// 4-tap gather per output pixel.
//
// Bound on an H100 SXM: bytes. One homographic-adaptation chunk at
// 240 x 320 warps 80 images: it reads the float32 source (8 images for the
// image warp, 80 probability maps for the unwarp; 2.5 or 24.6 MB) and
// 36 bytes of H^-1 per image, and writes 24.6 MB of float32; some 46
// float operations per pixel are far below the f32 rate.
//
// Design: a block of 256 threads covers 256 consecutive pixels of one
// output image (grid = pixel blocks x images), so stores are coalesced
// along x and the taps' loads hit L1/L2 (a source image is 307 KB). The
// image batch may be shorter than the homography batch: homography n
// reads image n % B, so the chunked adaptation never copies its tiled
// batch. The source is rounded as it is loaded (bf16, or 7-bit int8).
// The kernel takes H^-1, as the reference's does: the caller inverts
// (kernels/warp.py invert_homographies), and homographic adaptation
// reuses the inverses its valid masks already need.
//
// Given the same H^-1, numerics follow the reference's dense form to the
// bit: the taps are 1 - |s - x'| for x' = floor(s) and floor(s) + 1 (not
// t and 1 - t, which round differently); every multiply, add and divide
// is an explicitly rounded intrinsic in the reference's order (nvcc would
// otherwise contract a * b + c into an FMA); in bf16 mode the x products
// are exact in f32 and the two-term sums round once, as the MXU's do. sx
// and sy are range-tested before floorf is cast to int: d = 0 gives inf
// or nan, and both give 0 here (the dense form gives 0 for inf).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kInvQ = static_cast<float>(1.0 / (127.0 * 127.0));

__device__ __forceinline__ float hat(float s, float t) {
  return fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(s, t))));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ int quant7(float v) {
  return static_cast<int>(rintf(__fmul_rn(v, 127.f)));
}

template <bool INT8>
__global__ void __launch_bounds__(kThreads)
warp_kernel(const float* __restrict__ img, const float* __restrict__ hinv,
            float* __restrict__ out, int B, int H, int W) {
  const int n = blockIdx.y;
  const float* h = hinv + 9 * n;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= H * W) return;
  const int y = p / W, x = p - y * W;
  const float xf = static_cast<float>(x), yf = static_cast<float>(y);
  const float d = __fadd_rn(__fadd_rn(__fmul_rn(h[6], xf), __fmul_rn(h[7], yf)), h[8]);
  const float sx =
      __fdiv_rn(__fadd_rn(__fadd_rn(__fmul_rn(h[0], xf), __fmul_rn(h[1], yf)), h[2]), d);
  const float sy =
      __fdiv_rn(__fadd_rn(__fadd_rn(__fmul_rn(h[3], xf), __fmul_rn(h[4], yf)), h[5]), d);
  float result = 0.f;
  // false for nan and +-inf as well
  if (sx > -1.f && sx < static_cast<float>(W) && sy > -1.f && sy < static_cast<float>(H)) {
    const int x0 = static_cast<int>(floorf(sx)), y0 = static_cast<int>(floorf(sy));
    const float* src = img + static_cast<size_t>(n % B) * H * W;
    const float wx0 = hat(sx, static_cast<float>(x0));
    const float wx1 = hat(sx, static_cast<float>(x0 + 1));
    const bool ok0 = x0 >= 0, ok1 = x0 + 1 < W;  // sx < W: x0 <= W - 1
    #pragma unroll
    for (int ky = 0; ky < 2; ++ky) {
      const int yk = y0 + ky;
      if (yk < 0 || yk >= H) continue;
      const float* row = src + static_cast<size_t>(yk) * W;
      float t;
      if constexpr (INT8) {
        int acc = 0;
        if (ok0) acc += quant7(fminf(fmaxf(__ldg(row + x0), 0.f), 1.f)) * quant7(wx0);
        if (ok1) acc += quant7(fminf(fmaxf(__ldg(row + x0 + 1), 0.f), 1.f)) * quant7(wx1);
        t = __fmul_rn(static_cast<float>(acc), kInvQ);
      } else {
        t = 0.f;
        if (ok0) t = __fadd_rn(t, __fmul_rn(round_bf16(__ldg(row + x0)), round_bf16(wx0)));
        if (ok1) t = __fadd_rn(t, __fmul_rn(round_bf16(__ldg(row + x0 + 1)), round_bf16(wx1)));
      }
      result = __fadd_rn(result, __fmul_rn(hat(sy, static_cast<float>(yk)), t));
    }
  }
  out[static_cast<size_t>(n) * H * W + p] = result;
}

}  // namespace

// img (B, H, W) float32; hinv (N, 9) float32 inverse homographies H^-1,
// N a multiple of B (image n % B for homography n); out (N, H, W)
// float32. mode 0: bf16 operands, 1: 7-bit int8 operands.
extern "C" int warp_launch(const void* img, const void* hinv, void* out, int N, int B, int H,
                           int W, int mode, void* stream) {
  if (B <= 0 || N % B != 0 || H <= 0 || W <= 0 || N > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto I = static_cast<const float*>(img);
  auto Hv = static_cast<const float*>(hinv);
  auto O = static_cast<float*>(out);
  const dim3 grid((H * W + kThreads - 1) / kThreads, N);
  if (mode == 0)
    warp_kernel<false><<<grid, kThreads, 0, s>>>(I, Hv, O, B, H, W);
  else if (mode == 1)
    warp_kernel<true><<<grid, kThreads, 0, s>>>(I, Hv, O, B, H, W);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
