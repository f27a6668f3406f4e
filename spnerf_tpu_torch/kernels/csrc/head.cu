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
// bf16) and <2.5 MB written per image.
//
// Design: one block of 256 threads per (image, 8 x 16 cell tile). The
// input tile with a one-cell halo sits in shared memory; the 3x3 conv
// runs with __dp4a (int8) or float32 FMAs (bf16), its output (128 x CM
// of the operand type) stays in shared memory; the 1x1 dot then gives
// each warp whole pixels, so the softmax's max and sum are warp shuffles.
// Softmax in float32 with IEEE expf and division; the store rounds to
// bf16 (round to nearest even).
#include "conv_common.cuh"

#include <math_constants.h>

namespace {

using namespace spnerf;

constexpr int TH = 8, TW = 16, NP = TH * TW;

template <typename T, int CIN, int CM, int COUTP, bool SOFTMAX>
__global__ void __launch_bounds__(kThreads)
head_kernel(const T* __restrict__ x, const int* __restrict__ w3,
            const float* __restrict__ m3, const float* __restrict__ b3,
            const int* __restrict__ w1, const float* __restrict__ m1,
            const float* __restrict__ b1, __nv_bfloat16* __restrict__ out, int H, int W,
            int n_real, int n_store, int tiles_x) {
  extern __shared__ __align__(16) int8_t smem[];
  constexpr int S = sizeof(T);
  int8_t* s_in = smem;                                  // (TH+2) x (TW+2) x CIN
  int8_t* s_mid = smem + (TH + 2) * (TW + 2) * CIN * S;  // NP x CM
  const int b = blockIdx.y;
  const int y0 = (blockIdx.x / tiles_x) * TH, x0 = (blockIdx.x % tiles_x) * TW;
  load_tile<CIN * S>(reinterpret_cast<const int8_t*>(x) + static_cast<size_t>(b) * H * W * CIN * S,
                     H, W, y0 - 1, x0 - 1, TH + 2, TW + 2, s_in);
  __syncthreads();
  // the 3x3 output at out-of-image tile positions is never stored, so it
  // needs no zeroing
  conv3x3_requant_stage<T, CIN, CM>(s_in, TW + 2, TW, NP, w3, m3, b3,
                                    reinterpret_cast<T*>(s_mid),
                                    [](int, int) { return false; });
  __syncthreads();

  constexpr int Q = COUTP / 32, P = 32 / Q;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float mq[Q], bq[Q];
  #pragma unroll
  for (int q = 0; q < Q; ++q) {
    mq[q] = __ldg(m1 + lane * Q + q);
    bq[q] = __ldg(b1 + lane * Q + q);
  }
  __nv_bfloat16* o = out + static_cast<size_t>(b) * H * W * n_store;
  for (int p0 = warp * P; p0 < NP; p0 += kWarps * P) {
    int base[P];
    #pragma unroll
    for (int p = 0; p < P; ++p) base[p] = p0 + p;
    typename Op<T>::Acc acc[P][Q] = {};
    conv_acc<T, CM, COUTP, P, 1>(s_mid, TW, base, w1, lane, acc);
    #pragma unroll
    for (int p = 0; p < P; ++p) {
      float v[Q];
      #pragma unroll
      for (int q = 0; q < Q; ++q) v[q] = affine(acc[p][q], mq[q], bq[q]);
      if constexpr (SOFTMAX) {
        float mx = -CUDART_INF_F;
        #pragma unroll
        for (int q = 0; q < Q; ++q)
          if (lane * Q + q < n_real) mx = fmaxf(mx, v[q]);
        #pragma unroll
        for (int d = 16; d > 0; d >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, d));
        float sum = 0.f;
        #pragma unroll
        for (int q = 0; q < Q; ++q) {
          v[q] = lane * Q + q < n_real ? expf(__fsub_rn(v[q], mx)) : 0.f;
          sum = __fadd_rn(sum, v[q]);
        }
        #pragma unroll
        for (int d = 16; d > 0; d >>= 1) sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, d));
        #pragma unroll
        for (int q = 0; q < Q; ++q) v[q] = __fdiv_rn(v[q], sum);
      }
      const int gy = y0 + (p0 + p) / TW, gx = x0 + (p0 + p) % TW;
      if (gy >= H || gx >= W) continue;
      __nv_bfloat16* dst = o + (static_cast<size_t>(gy) * W + gx) * n_store;
      #pragma unroll
      for (int q = 0; q < Q; ++q)
        if (lane * Q + q < n_store) dst[lane * Q + q] = __float2bfloat16(v[q]);
    }
  }
}

template <typename T, int CIN, int CM, int COUTP, bool SOFTMAX>
cudaError_t launch(const T* x, const int* w3, const float* m3, const float* b3,
                   const int* w1, const float* m1, const float* b1, __nv_bfloat16* out,
                   int B, int H, int W, int n_real, int n_store, cudaStream_t stream) {
  const int smem = ((TH + 2) * (TW + 2) * CIN + NP * CM) * sizeof(T);
  auto kern = head_kernel<T, CIN, CM, COUTP, SOFTMAX>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  kern<<<dim3(tiles_x * tiles_y, B), kThreads, smem, stream>>>(
      x, w3, m3, b3, w1, m1, b1, out, H, W, n_real, n_store, tiles_x);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* w3, const void* m3, const void* b3, const void* w1,
             const void* m1, const void* b1, void* out, int B, int H, int W, int cin, int cm,
             int coutp, int n_real, int n_store, int softmax, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto X = static_cast<const T*>(x);
  auto W3 = static_cast<const int*>(w3), W1 = static_cast<const int*>(w1);
  auto M3 = static_cast<const float*>(m3), B3 = static_cast<const float*>(b3);
  auto M1 = static_cast<const float*>(m1), B1 = static_cast<const float*>(b1);
  auto O = static_cast<__nv_bfloat16*>(out);
  if (cin != 128 || cm != 256 || n_store > coutp || n_real > coutp)
    return static_cast<int>(cudaErrorInvalidValue);
  if (coutp == 128 && softmax)
    return launch<T, 128, 256, 128, true>(X, W3, M3, B3, W1, M1, B1, O, B, H, W, n_real,
                                          n_store, s);
  if (coutp == 128 && !softmax)
    return launch<T, 128, 256, 128, false>(X, W3, M3, B3, W1, M1, B1, O, B, H, W, n_real,
                                           n_store, s);
  if (coutp == 256 && !softmax)
    return launch<T, 128, 256, 256, false>(X, W3, M3, B3, W1, M1, B1, O, B, H, W, n_real,
                                           n_store, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x (B, H, W, 128) int8; w3 packed [9][32][256] int32; m3/b3 (256,);
// w1 packed [64][coutp] int32 (zero-padded to coutp = 128 or 256);
// m1/b1 (coutp,) float32; out (B, H, W, n_store) bf16. softmax: over
// lanes [0, n_real), storing the first n_store = n_real - 1 lanes.
extern "C" int head_launch(const void* x, const void* w3, const void* m3, const void* b3,
                           const void* w1, const void* m1, const void* b1, void* out,
                           int B, int H, int W, int cin, int cm, int coutp, int n_real,
                           int n_store, int softmax, void* stream) {
  return dispatch<int8_t>(x, w3, m3, b3, w1, m1, b1, out, B, H, W, cin, cm, coutp, n_real,
                          n_store, softmax, stream);
}

// The same with bf16 x and mid, and weights packed as pairs of bf16
// channels per 32-bit word: w3 [9][64][256], w1 [128][coutp].
extern "C" int head_bf16_launch(const void* x, const void* w3, const void* m3, const void* b3,
                                const void* w1, const void* m1, const void* b1, void* out,
                                int B, int H, int W, int cin, int cm, int coutp, int n_real,
                                int n_store, int softmax, void* stream) {
  return dispatch<__nv_bfloat16>(x, w3, m3, b3, w1, m1, b1, out, B, H, W, cin, cm, coutp,
                                 n_real, n_store, softmax, stream);
}
