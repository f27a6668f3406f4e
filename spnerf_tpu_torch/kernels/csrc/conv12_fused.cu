// Fused SuperPoint stack entry: float image -> int8 quantize -> conv1
// (1 -> 64, per-channel int8 weights) -> ReLU -> requant -> conv2
// (64 -> 64 int8) -> ReLU -> requant -> optional 2x2 max-pool.
//
// Replaces spnerf_tpu/kernels/conv12_fused_pallas.py conv12_fused. Its
// banded-Toeplitz conv1 and W-pair packing are TPU layout and are not
// ported; the contract is: quantize the image as clip(round(x * 127)),
// conv1 in int32, affine + ReLU + requant into int8, conv1 outputs
// outside the image are zero (conv2's SAME padding), conv2 in int32,
// affine + ReLU, pool on float32 values, cast to int8.
//
// Bound on an H100 SXM at 480 x 640, batch 64: int8 operations, 11.3
// GMAC per image (conv2 is 98% of it) against 0.39 GB moved per batch.
//
// Design: one block of 256 threads per (image, 16 x 16 conv2 output
// tile). The block quantizes a 20 x 20 image window into shared memory,
// computes conv1 for the 18 x 18 positions conv2 needs (64 channels,
// each thread one channel with its nine weights in registers),
// requantizes them into a shared int8 tile (zero outside the image),
// then runs conv2 with __dp4a and pools in the epilogue. Neither
// full-resolution activation reaches HBM: only the pooled
// (B, H/2, W/2, 64) int8 tensor is written.
#include "conv_common.cuh"

namespace {

using namespace spnerf;

constexpr int TH = 16, TW = 16, C = 64;

template <bool POOL>
__global__ void __launch_bounds__(kThreads)
conv12_kernel(const float* __restrict__ img, const int8_t* __restrict__ k1,
              const float* __restrict__ m1, const float* __restrict__ b1,
              const int* __restrict__ w2, const float* __restrict__ m2,
              const float* __restrict__ b2, int8_t* __restrict__ out, int H, int W,
              int relu, int tiles_x) {
  constexpr int IW = TW + 4, MW = TW + 2, NM = (TH + 2) * (TW + 2);
  __shared__ int8_t s_img[(TH + 4) * IW];
  __shared__ __align__(16) int8_t s_mid[NM * C];
  const int b = blockIdx.y;
  const int y0 = (blockIdx.x / tiles_x) * TH, x0 = (blockIdx.x % tiles_x) * TW;
  const float* im = img + static_cast<size_t>(b) * H * W;
  // image window rows y0-2.., columns x0-2..; zero outside the image
  for (int i = threadIdx.x; i < (TH + 4) * IW; i += kThreads) {
    const int y = y0 - 2 + i / IW, x = x0 - 2 + i % IW;
    int8_t q = 0;
    if (y >= 0 && y < H && x >= 0 && x < W)
      q = cast_i8(__fmul_rn(__ldg(im + static_cast<size_t>(y) * W + x), 127.f));
    s_img[i] = q;
  }
  // conv1: thread t always computes channel t % 64 (kThreads % 64 == 0)
  const int c = threadIdx.x % C;
  int kw[9];
  #pragma unroll
  for (int t = 0; t < 9; ++t) kw[t] = __ldg(k1 + t * C + c);
  const float mc = __ldg(m1 + c), bc = __ldg(b1 + c);
  __syncthreads();
  for (int m = threadIdx.x / C; m < NM; m += kThreads / C) {
    const int r = m / MW, cc = m % MW;
    const int gy = y0 - 1 + r, gx = x0 - 1 + cc;
    int8_t v = 0;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      int acc = 0;
      #pragma unroll
      for (int t = 0; t < 9; ++t) acc += s_img[(r + t / 3) * IW + cc + t % 3] * kw[t];
      v = cast_i8(fmaxf(affine(acc, mc, bc), 0.f));
    }
    s_mid[m * C + c] = v;
  }
  __syncthreads();
  const size_t out_img = POOL ? static_cast<size_t>(H / 2) * (W / 2) : static_cast<size_t>(H) * W;
  conv3x3_out_stage<int8_t, int8_t, C, C, POOL, TH, TW>(s_mid, w2, m2, b2, relu != 0,
                                                        out + b * out_img * C, H, W, y0, x0);
}

}  // namespace

// img (B, H, W) float32; k1 (9, 64) int8 [tap][channel]; m1/b1 (64,)
// float32 (m1 already holds the conv1 weight scale); w2 packed [9][16][64]
// int32; m2/b2 (64,); out (B, H/2, W/2, 64) int8 when pool, else
// (B, H, W, 64).
extern "C" int conv12_fused_launch(const void* img, const void* k1, const void* m1,
                                   const void* b1, const void* w2, const void* m2,
                                   const void* b2, void* out, int B, int H, int W,
                                   int pool, int relu, void* stream) {
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const dim3 grid(tiles_x * tiles_y, B);
  auto kern = pool ? conv12_kernel<true> : conv12_kernel<false>;
  kern<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const int8_t*>(k1),
      static_cast<const float*>(m1), static_cast<const float*>(b1),
      static_cast<const int*>(w2), static_cast<const float*>(m2),
      static_cast<const float*>(b2), static_cast<int8_t*>(out), H, W, relu, tiles_x);
  return static_cast<int>(cudaGetLastError());
}
