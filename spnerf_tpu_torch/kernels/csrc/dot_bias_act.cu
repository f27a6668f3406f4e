// Per-row (M, cin) @ (cin, COUTP) product with the per-channel affine,
// optional ReLU and the cast in its epilogue: int8 operands (__dp4a,
// int32 sums), bf16 operands or float32 operands (float32 FMAs).
//
// Replaces spnerf_tpu/kernels/conv_stack_pallas.py dot_bias_act_pallas:
// the unfused heads' 1x1 convs (convPb: 256 -> 65, padded to 128 inside
// the kernel; convDb: 256 -> 256; int8 or bf16 operands, bf16 out) and
// conv1_packed (:477), the first VGG block as a 9-tap patch product
// (float32 patches, 9 -> 64, bf16 out). The patch width 9 is padded to 12
// in shared memory, not in HBM, and only the n_store real output lanes
// are written.
//
// Bound on an H100 SXM: bytes, at every shape of the serving path: a
// conv1 pixel moves 36 bytes in and 128 out for 576 multiply-adds, a head
// row 256 int8 or bf16 values in and 65 or 256 bf16 out for 65 or 256
// multiply-adds per value read.
//
// Design: one block of 256 threads per 128 rows. The block stages its
// rows (zero-padded to CINP channels, zero past M) in shared memory as
// 32-bit words, then each warp takes 32 / Q rows and all COUTP output
// channels, lane l holding channels [l Q, l Q + Q), and sums over the
// channels in order (the same bits every run). Weights are read through
// L1/L2.
#include "conv_common.cuh"

namespace {

using namespace spnerf;

constexpr int R = 128;  // rows per block

template <typename T, typename O, int CINP, int COUTP>
__global__ void __launch_bounds__(kThreads)
dot_bias_act_kernel(const T* __restrict__ x, const int* __restrict__ w,
                    const float* __restrict__ mult, const float* __restrict__ bias,
                    O* __restrict__ out, int M, int cin, int n_store, int relu) {
  constexpr int KWP = CINP * static_cast<int>(sizeof(T)) / 4;  // words per staged row
  extern __shared__ __align__(16) int s_x[];  // R x KWP words
  const int kw = cin * static_cast<int>(sizeof(T)) / 4;        // words per row in HBM
  const int* xw = reinterpret_cast<const int*>(x);
  const size_t r0 = static_cast<size_t>(blockIdx.x) * R;
  for (int i = threadIdx.x; i < R * KWP; i += kThreads) {
    const int r = i / KWP, k = i % KWP;
    int v = 0;
    if (r0 + r < static_cast<size_t>(M) && k < kw) v = __ldg(xw + (r0 + r) * kw + k);
    s_x[i] = v;
  }
  __syncthreads();

  constexpr int Q = COUTP / 32, P = 32 / Q;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float mq[Q], bq[Q];
  #pragma unroll
  for (int q = 0; q < Q; ++q) {
    mq[q] = __ldg(mult + lane * Q + q);
    bq[q] = __ldg(bias + lane * Q + q);
  }
  for (int p0 = warp * P; p0 < R; p0 += kWarps * P) {
    int base[P];
    #pragma unroll
    for (int p = 0; p < P; ++p) base[p] = p0 + p;
    typename Op<T>::Acc acc[P][Q] = {};
    conv_acc<T, CINP, COUTP, P, 1>(reinterpret_cast<const int8_t*>(s_x), 0, base, w, lane, acc);
    #pragma unroll
    for (int p = 0; p < P; ++p) {
      const size_t row = r0 + p0 + p;
      if (row >= static_cast<size_t>(M)) break;
      O v[Q];
      #pragma unroll
      for (int q = 0; q < Q; ++q) {
        const float y = affine(acc[p][q], mq[q], bq[q]);
        v[q] = cast_out<O>(relu ? fmaxf(y, 0.f) : y);
      }
      O* dst = out + row * n_store;
      if (n_store == COUTP) {
        store_vals<Q>(dst + lane * Q, v);
      } else {
        #pragma unroll
        for (int q = 0; q < Q; ++q)
          if (lane * Q + q < n_store) dst[lane * Q + q] = v[q];
      }
    }
  }
}

template <typename T, typename O, int CINP, int COUTP>
cudaError_t launch(const void* x, const void* w, const void* m, const void* b, void* out,
                   int M, int cin, int n_store, int relu, cudaStream_t stream) {
  if (cin > CINP || cin * static_cast<int>(sizeof(T)) % 4 || n_store > COUTP)
    return cudaErrorInvalidValue;
  const int smem = R * CINP * sizeof(T);
  auto kern = dot_bias_act_kernel<T, O, CINP, COUTP>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (M + R - 1) / R;
  kern<<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int*>(w), static_cast<const float*>(m),
      static_cast<const float*>(b), static_cast<O*>(out), M, cin, n_store, relu);
  return cudaGetLastError();
}

}  // namespace

// x (M, cin) of dtype (0 int8, 1 bf16, 2 float32); w packed
// [cinp / per_word][coutp] 32-bit words, zero-padded to cinp input and
// coutp output channels; m/b (coutp,) float32; out (M, n_store) bf16
// (out_int8 = 0) or int8 (1). Supported (dtype, cinp, coutp): int8 and
// bf16 with (256, 128) and (256, 256); float32 with (12, 64).
extern "C" int dot_bias_act_launch(const void* x, const void* w, const void* m, const void* b,
                                   void* out, int M, int cin, int dtype, int cinp, int coutp,
                                   int n_store, int relu, int out_int8, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  using BF = __nv_bfloat16;
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && cinp == 256 && coutp == 128 && !out_int8)
    err = launch<int8_t, BF, 256, 128>(x, w, m, b, out, M, cin, n_store, relu, s);
  else if (dtype == 0 && cinp == 256 && coutp == 256 && !out_int8)
    err = launch<int8_t, BF, 256, 256>(x, w, m, b, out, M, cin, n_store, relu, s);
  else if (dtype == 1 && cinp == 256 && coutp == 128 && !out_int8)
    err = launch<BF, BF, 256, 128>(x, w, m, b, out, M, cin, n_store, relu, s);
  else if (dtype == 1 && cinp == 256 && coutp == 256 && !out_int8)
    err = launch<BF, BF, 256, 256>(x, w, m, b, out, M, cin, n_store, relu, s);
  else if (dtype == 2 && cinp == 12 && coutp == 64 && !out_int8)
    err = launch<float, BF, 12, 64>(x, w, m, b, out, M, cin, n_store, relu, s);
  else if (dtype == 2 && cinp == 12 && coutp == 64 && out_int8)
    err = launch<float, int8_t, 12, 64>(x, w, m, b, out, M, cin, n_store, relu, s);
  return static_cast<int>(err);
}
