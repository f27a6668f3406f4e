// One SAME 3x3 conv with the per-channel affine, optional ReLU, optional
// 2x2 max-pool and the cast in its epilogue; int8 operands (int32 sums,
// requantized to int8) or bf16 operands (float32 sums, rounded to bf16).
//
// Replaces spnerf_tpu/kernels/conv_stack_pallas.py conv3x3_pallas (C_in
// 128: block 6 without the fused mid, blocks 7-8, convPa and convDa
// without the fused tail) and packed_conv3x3_pallas (C_in 64: blocks 2-5
// without the fused mid, block 2 in bf16 mode). The W-pair packing of
// the second is TPU layout: both compute the same conv on plain NHWC.
//
// Bound on an H100 SXM: operations. Its largest call on the serving path
// is bf16 block 2 (64 -> 64 at 480 x 640, pooled), 0.725 T multiply-adds
// per batch of 64 against 2.5 GB read and 0.6 GB written: 1.47 ms at the
// bf16 tensor-core rate, 0.93 ms of bytes.
//
// Design: one block of 256 threads per (image, 16 x 16 output tile). The
// block stages the input tile with a one-pixel halo (18 x 18 x CIN) in
// shared memory, zero outside the image (SAME padding), then each warp
// computes 2 x (32 / Q / 2) output pixels for all COUT channels, lane l
// holding channels [l Q, l Q + Q): __dp4a or float32 FMAs over taps, then
// channels, in a fixed order; the pool takes the max of the float32
// values before the cast, as the reference does. Weights are read through
// L1/L2. Tensor cores (mma.sync / wgmma) are later work.
#include "conv_common.cuh"

namespace {

using namespace spnerf;

constexpr int TH = 16, TW = 16;

template <typename T, int CIN, int CO, bool POOL>
__global__ void __launch_bounds__(kThreads)
conv3x3_kernel(const T* __restrict__ x, const int* __restrict__ w,
               const float* __restrict__ mult, const float* __restrict__ bias,
               T* __restrict__ out, int H, int W, int relu, int tiles_x) {
  extern __shared__ __align__(16) int8_t smem[];  // (TH+2) x (TW+2) x CIN
  constexpr int S = sizeof(T);
  const int b = blockIdx.y;
  const int y0 = (blockIdx.x / tiles_x) * TH, x0 = (blockIdx.x % tiles_x) * TW;
  load_tile<CIN * S>(reinterpret_cast<const int8_t*>(x) + static_cast<size_t>(b) * H * W * CIN * S,
                     H, W, y0 - 1, x0 - 1, TH + 2, TW + 2, smem);
  __syncthreads();
  const size_t out_img = POOL ? static_cast<size_t>(H / 2) * (W / 2) : static_cast<size_t>(H) * W;
  conv3x3_out_stage<T, T, CIN, CO, POOL, TH, TW>(smem, w, mult, bias, relu != 0,
                                                 out + b * out_img * CO, H, W, y0, x0);
}

template <typename T, int CIN, int CO, bool POOL>
cudaError_t launch(const T* x, const int* w, const float* m, const float* b, T* out, int B,
                   int H, int W, int relu, cudaStream_t stream) {
  const int smem = (TH + 2) * (TW + 2) * CIN * sizeof(T);
  auto kern = conv3x3_kernel<T, CIN, CO, POOL>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  kern<<<dim3(tiles_x * tiles_y, B), kThreads, smem, stream>>>(x, w, m, b, out, H, W, relu,
                                                               tiles_x);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* w, const void* m, const void* b, void* out, int B,
             int H, int W, int cin, int co, int pool, int relu, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto X = static_cast<const T*>(x);
  auto Wt = static_cast<const int*>(w);
  auto M = static_cast<const float*>(m), Bs = static_cast<const float*>(b);
  auto O = static_cast<T*>(out);
  if (cin == 64 && co == 64 && pool)
    return launch<T, 64, 64, true>(X, Wt, M, Bs, O, B, H, W, relu, s);
  if (cin == 64 && co == 64 && !pool)
    return launch<T, 64, 64, false>(X, Wt, M, Bs, O, B, H, W, relu, s);
  if (cin == 64 && co == 128 && !pool)
    return launch<T, 64, 128, false>(X, Wt, M, Bs, O, B, H, W, relu, s);
  if (cin == 128 && co == 128 && pool)
    return launch<T, 128, 128, true>(X, Wt, M, Bs, O, B, H, W, relu, s);
  if (cin == 128 && co == 128 && !pool)
    return launch<T, 128, 128, false>(X, Wt, M, Bs, O, B, H, W, relu, s);
  if (cin == 128 && co == 256 && !pool)
    return launch<T, 128, 256, false>(X, Wt, M, Bs, O, B, H, W, relu, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x (B, H, W, cin) int8; w packed [9][cin/4][co] int32; m/b (co,)
// float32; out (B, H, W, co) int8, or (B, H/2, W/2, co) when pool.
// Supported (cin, co, pool): (64, 64, 0 or 1), (64, 128, 0),
// (128, 128, 0 or 1), (128, 256, 0).
extern "C" int conv3x3_launch(const void* x, const void* w, const void* m, const void* b,
                              void* out, int B, int H, int W, int cin, int co, int pool,
                              int relu, void* stream) {
  return dispatch<int8_t>(x, w, m, b, out, B, H, W, cin, co, pool, relu, stream);
}

// The same with bf16 x and out, weights packed [9][cin/2][co] as pairs of
// bf16 channels per 32-bit word.
extern "C" int conv3x3_bf16_launch(const void* x, const void* w, const void* m, const void* b,
                                   void* out, int B, int H, int W, int cin, int co, int pool,
                                   int relu, void* stream) {
  return dispatch<__nv_bfloat16>(x, w, m, b, out, B, H, W, cin, co, pool, relu, stream);
}
