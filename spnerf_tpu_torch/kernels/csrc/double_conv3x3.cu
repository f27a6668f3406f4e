// Two chained SAME 3x3 convs in one kernel, the mid activation kept in
// shared memory, with an optional fused 2x2 max-pool; int8 or bf16
// operands.
//
// Replaces spnerf_tpu/kernels/mid_fused_pallas.py
// double_packed_conv3x3_pallas (blocks 3-4 and 5-6, pool on) and
// spnerf_tpu/kernels/tail_fused_pallas.py double_conv3x3_pallas (blocks
// 7-8, pool off): the two TPU kernels compute the same function and
// differ only in their TPU layout (W-pair packing, whole-image blocks).
//
// Bound on an H100 SXM at the main path's shapes (batch 64): operations
// (int8: 1,979 TOP/s dense; bf16: 989 TFLOP/s dense); blocks 3-4 are
// 5.66 GMAC per image, blocks 5-6 4.25, blocks 7-8 1.42, while the bytes
// moved are a few MB per image.
//
// Design: one block of 256 threads per (image, 16 x 16 output tile).
// The block stages the input tile with a 2-pixel halo (20 x 20 x CIN)
// in shared memory, computes conv_a on the 18 x 18 mid positions (the
// one-pixel halo of recompute), casts it with ReLU into a shared tile of
// the operand type, zeroing positions outside the image (SAME padding of
// conv_b reads zeros, not relu(bias)), then computes conv_b on the
// 16 x 16 outputs with the affine, ReLU and pool in the epilogue. Only
// the input and the (pooled) output touch HBM. Weights (up to 220 KB for
// blocks 5-6 in int8, twice that in bf16) are read through L1/L2. int8
// dots use __dp4a with int32 sums; bf16 dots float32 FMAs (bf16 tiles of
// blocks 7-8 take 185 KB of shared memory, one block per SM); tensor
// cores (mma.sync / wgmma) are later work.
#include "conv_common.cuh"

namespace {

using namespace spnerf;

constexpr int TH = 16, TW = 16;

template <typename T, int CIN, int CM, int CO, bool POOL>
__global__ void __launch_bounds__(kThreads)
double_conv3x3_kernel(const T* __restrict__ x, const int* __restrict__ wa,
                      const float* __restrict__ ma, const float* __restrict__ ba,
                      const int* __restrict__ wb, const float* __restrict__ mb,
                      const float* __restrict__ bb, T* __restrict__ out, int H,
                      int W, int relu_b, int tiles_x) {
  extern __shared__ __align__(16) int8_t smem[];
  constexpr int S = sizeof(T);
  int8_t* s_in = smem;                                     // (TH+4) x (TW+4) x CIN
  int8_t* s_mid = smem + (TH + 4) * (TW + 4) * CIN * S;    // (TH+2) x (TW+2) x CM
  const int b = blockIdx.y;
  const int y0 = (blockIdx.x / tiles_x) * TH, x0 = (blockIdx.x % tiles_x) * TW;
  load_tile<CIN * S>(reinterpret_cast<const int8_t*>(x) + static_cast<size_t>(b) * H * W * CIN * S,
                     H, W, y0 - 2, x0 - 2, TH + 4, TW + 4, s_in);
  __syncthreads();
  // mid position (r, c) is image (y0 - 1 + r, x0 - 1 + c)
  conv3x3_requant_stage<T, CIN, CM>(
      s_in, TW + 4, TW + 2, (TH + 2) * (TW + 2), wa, ma, ba, reinterpret_cast<T*>(s_mid),
      [=](int r, int c) {
        const int gy = y0 - 1 + r, gx = x0 - 1 + c;
        return gy < 0 || gy >= H || gx < 0 || gx >= W;
      });
  __syncthreads();
  const size_t out_img = POOL ? static_cast<size_t>(H / 2) * (W / 2) : static_cast<size_t>(H) * W;
  conv3x3_out_stage<T, T, CM, CO, POOL, TH, TW>(s_mid, wb, mb, bb, relu_b != 0,
                                                out + b * out_img * CO, H, W, y0, x0);
}

template <typename T, int CIN, int CM, int CO, bool POOL>
cudaError_t launch(const T* x, const int* wa, const float* ma, const float* ba,
                   const int* wb, const float* mb, const float* bb, T* out, int B,
                   int H, int W, int relu_b, cudaStream_t stream) {
  const int smem = ((TH + 4) * (TW + 4) * CIN + (TH + 2) * (TW + 2) * CM) * sizeof(T);
  auto kern = double_conv3x3_kernel<T, CIN, CM, CO, POOL>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  kern<<<dim3(tiles_x * tiles_y, B), kThreads, smem, stream>>>(x, wa, ma, ba, wb, mb, bb,
                                                               out, H, W, relu_b, tiles_x);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* wa, const void* ma, const void* ba, const void* wb,
             const void* mb, const void* bb, void* out, int B, int H, int W, int cin, int cm,
             int co, int pool, int relu_b, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto X = static_cast<const T*>(x);
  auto WA = static_cast<const int*>(wa);
  auto WB = static_cast<const int*>(wb);
  auto MA = static_cast<const float*>(ma), BA = static_cast<const float*>(ba);
  auto MB = static_cast<const float*>(mb), BB = static_cast<const float*>(bb);
  auto O = static_cast<T*>(out);
  if (cin == 64 && cm == 64 && co == 64 && pool)
    return launch<T, 64, 64, 64, true>(X, WA, MA, BA, WB, MB, BB, O, B, H, W, relu_b, s);
  if (cin == 64 && cm == 128 && co == 128 && pool)
    return launch<T, 64, 128, 128, true>(X, WA, MA, BA, WB, MB, BB, O, B, H, W, relu_b, s);
  if (cin == 128 && cm == 128 && co == 128 && !pool)
    return launch<T, 128, 128, 128, false>(X, WA, MA, BA, WB, MB, BB, O, B, H, W, relu_b, s);
  if (cin == 128 && cm == 128 && co == 128 && pool)
    return launch<T, 128, 128, 128, true>(X, WA, MA, BA, WB, MB, BB, O, B, H, W, relu_b, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x (B, H, W, cin) int8; wa/wb packed [9][c/4][c'] int32; ma/ba (cm,),
// mb/bb (co,) float32; out (B, H, W, co) or pooled (B, H/2, W/2, co).
// Supported (cin, cm, co, pool): (64, 64, 64, 1), (64, 128, 128, 1),
// (128, 128, 128, 0) and (128, 128, 128, 1).
extern "C" int double_conv3x3_launch(const void* x, const void* wa, const void* ma,
                                     const void* ba, const void* wb, const void* mb,
                                     const void* bb, void* out, int B, int H, int W,
                                     int cin, int cm, int co, int pool, int relu_b,
                                     void* stream) {
  return dispatch<int8_t>(x, wa, ma, ba, wb, mb, bb, out, B, H, W, cin, cm, co, pool, relu_b,
                          stream);
}

// The same with bf16 x, mid and out, and weights packed [9][c/2][c'] as
// pairs of bf16 channels per 32-bit word.
extern "C" int double_conv3x3_bf16_launch(const void* x, const void* wa, const void* ma,
                                          const void* ba, const void* wb, const void* mb,
                                          const void* bb, void* out, int B, int H, int W,
                                          int cin, int cm, int co, int pool, int relu_b,
                                          void* stream) {
  return dispatch<__nv_bfloat16>(x, wa, ma, ba, wb, mb, bb, out, B, H, W, cin, cm, co, pool,
                                 relu_b, stream);
}
