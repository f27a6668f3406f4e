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
// moved are a few MB per image: bf16 0.7328, 0.5496 and 0.1832 ms a
// batch of 64.
//
// int8 instance (double_conv3x3_launch): one block of 256 threads per
// (image, 16 x 16 output tile). The block stages the input tile with a
// 2-pixel halo (20 x 20 x CIN) in shared memory, computes conv_a on the
// 18 x 18 mid positions (the one-pixel halo of recompute) with __dp4a and
// int32 sums, requantizes it with ReLU into a shared int8 tile, zeroing
// positions outside the image (SAME padding of conv_b reads zeros, not
// relu(bias)), then computes conv_b on the 16 x 16 outputs with the
// affine, ReLU and pool in the epilogue. Weights are read through L1/L2.
//
// bf16 instance (double_conv3x3_bf16_launch): the same chain on the
// tensor cores through conv_tc.cuh (wgmma m64n64k16, A by ldmatrix from
// the swizzled input tile, B from weight slabs streamed by cp.async.bulk
// through a ring of two buffers, two-level float32 sums; see there). Per
// block: two warpgroups, one output tile; conv_a over the mid positions
// in row order (M padded to 64), its epilogue rounding relu(affine) to
// bf16 into the swizzled shared mid, zero outside the image; conv_b over
// the outputs in 2 x 8 slices, pooled in registers. Only the input and
// the (pooled) output touch HBM. Instances (output tile; conv_a's
// M-tiles and how the warpgroups share them; shared memory = ring +
// input + mid + affines + barriers):
//   64-64-64 pool   16 x 16; 6 (384 rows for 324, 16% padding), two
//                   passes of 2 per warpgroup (conv_a's slabs stream
//                   twice); 16,384 + 51,200 + 41,472 + 1,024 + 16
//                   = 110,096 B, two blocks per SM
//   64-128-128 pool  8 x 16; 3 (192 rows for 180, 6%), each warpgroup
//                   all 3 and half the channels (conv_b too);
//                   65,536 + 30,720 + 46,080 + 2,048 + 16 = 144,400 B
//   128-128-128      8 x 16; the same; 65,536 + 61,440 + 46,080 + 2,048
//                   + 16 = 175,120 B
// conv_a recomputes the one-pixel halo of mid positions: 1.27x its work at
// 16 x 16, 1.41x at 8 x 16. Registers (ptxas, sm_90a): 126 for 64-64-64,
// 176-190 for the others, no spills.
#include "conv_common.cuh"
#include "conv_tc.cuh"

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

// bf16 on the tensor cores: output tile OH x OW, MTA / MTB M-tiles per
// warpgroup and pass for conv_a / conv_b, the channels split over the
// warpgroups when NS is 2 (see tc_conv3x3), MINB blocks per SM
template <int CIN, int CM, int CO, bool POOL, int OH, int OW, int MTA, int MTB, int NS,
          int MINB>
__global__ void __launch_bounds__(tc::kThreads, MINB)
double_conv3x3_tc_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ wa,
                         const float* __restrict__ ma, const float* __restrict__ ba,
                         const int8_t* __restrict__ wb, const float* __restrict__ mb,
                         const float* __restrict__ bb, __nv_bfloat16* __restrict__ out, int H,
                         int W, int relu_b, int tiles_x) {
  using namespace tc;
  constexpr int SLAB_A = CIN * CM * 2, SLAB_B = CM * CO * 2;
  constexpr int SLAB = SLAB_A > SLAB_B ? SLAB_A : SLAB_B;
  constexpr int MW = OW + 2, NMID = (OH + 2) * MW;
  constexpr int TILES_A = (NMID + 63) / 64, TILES_B = OH * OW / 64;
  constexpr int PASSES_A = (TILES_A + kNWG / NS * MTA - 1) / (kNWG / NS * MTA);
  constexpr int PASSES_B = (TILES_B + kNWG / NS * MTB - 1) / (kNWG / NS * MTB);
  extern __shared__ __align__(128) int8_t smem_tc[];
  int8_t* s_in = smem_tc + kRing * SLAB;                   // (OH+4) x (OW+4) x CIN
  int8_t* s_mid = s_in + (OH + 4) * (OW + 4) * CIN * 2;  // (OH+2) x (OW+2) x CM
  float* s_aff = reinterpret_cast<float*>(s_mid + NMID * CM * 2);  // ma, ba, mb, bb
  uint64_t* bars = reinterpret_cast<uint64_t*>(s_aff + 2 * CM + 2 * CO);
  const int b = blockIdx.y;
  const int y0 = (blockIdx.x / tiles_x) * OH, x0 = (blockIdx.x % tiles_x) * OW;
  SlabRing ring{smem_tc, SLAB, bars, {wa, wb}, {SLAB_A, SLAB_B}, {PASSES_A * 9, PASSES_B * 9}, 0};
  ring_start(ring);
  for (int i = threadIdx.x; i < CM; i += blockDim.x) {
    s_aff[i] = ma[i];
    s_aff[CM + i] = ba[i];
  }
  for (int i = threadIdx.x; i < CO; i += blockDim.x) {
    s_aff[2 * CM + i] = mb[i];
    s_aff[2 * CM + CO + i] = bb[i];
  }
  load_tile_async<CIN * 2>(
      reinterpret_cast<const int8_t*>(x) + static_cast<size_t>(b) * H * W * CIN * 2, H, W,
      y0 - 2, x0 - 2, OH + 4, OW + 4, s_in);
  __syncthreads();
  // mid position q = (r, c) is image (y0 - 1 + r, x0 - 1 + c); its tap
  // (0, 0) is input tile pixel (r, c)
  tc_conv3x3<CIN, CM, MTA, NS, TILES_A>(
      s_in, OW + 4, ring,
      [](int row) {
        const int q = min(row, NMID - 1);
        return (q / MW) * (OW + 4) + q % MW;
      },
      MidEpilogue<CM, CM / NS>{s_aff, s_aff + CM, s_mid, NMID, MW, H, W, y0, x0});
  __syncthreads();
  const size_t out_img = POOL ? static_cast<size_t>(H / 2) * (W / 2) : static_cast<size_t>(H) * W;
  tc_conv3x3<CM, CO, MTB, NS, TILES_B>(
      s_mid, MW, ring,
      [](int row) {
        int ty, tx;
        out_pixel<OW>(row, ty, tx);
        return ty * MW + tx;
      },
      OutEpilogue<CO, CO / NS, OW, POOL>{s_aff + 2 * CM, s_aff + 2 * CM + CO, relu_b != 0,
                                out + b * out_img * CO, H, W, y0, x0});
}

template <int CIN, int CM, int CO, bool POOL, int OH, int OW, int MTA, int MTB, int NS,
          int MINB>
cudaError_t launch_tc(const void* x, const void* wa, const void* ma, const void* ba,
                      const void* wb, const void* mb, const void* bb, void* out, int B, int H,
                      int W, int relu_b, cudaStream_t stream) {
  constexpr int SLAB = (CIN * CM > CM * CO ? CIN * CM : CM * CO) * 2;
  constexpr int smem = tc::kRing * SLAB + (OH + 4) * (OW + 4) * CIN * 2 +
                       (OH + 2) * (OW + 2) * CM * 2 + (2 * CM + 2 * CO) * 4 +
                       tc::kRing * 8;
  auto kern = double_conv3x3_tc_kernel<CIN, CM, CO, POOL, OH, OW, MTA, MTB, NS, MINB>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles_x = (W + OW - 1) / OW, tiles_y = (H + OH - 1) / OH;
  kern<<<dim3(tiles_x * tiles_y, B), tc::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(wa),
      static_cast<const float*>(ma), static_cast<const float*>(ba),
      static_cast<const int8_t*>(wb), static_cast<const float*>(mb),
      static_cast<const float*>(bb), static_cast<__nv_bfloat16*>(out), H, W, relu_b, tiles_x);
  return cudaGetLastError();
}

int dispatch_tc(const void* x, const void* wa, const void* ma, const void* ba, const void* wb,
                const void* mb, const void* bb, void* out, int B, int H, int W, int cin, int cm,
                int co, int pool, int relu_b, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (cin == 64 && cm == 64 && co == 64 && pool)
    return launch_tc<64, 64, 64, true, 16, 16, 2, 2, 1, 2>(x, wa, ma, ba, wb, mb, bb, out, B, H, W,
                                                        relu_b, s);
  if (cin == 64 && cm == 128 && co == 128 && pool)
    return launch_tc<64, 128, 128, true, 8, 16, 3, 2, 2, 1>(x, wa, ma, ba, wb, mb, bb, out, B, H, W,
                                                         relu_b, s);
  if (cin == 128 && cm == 128 && co == 128 && !pool)
    return launch_tc<128, 128, 128, false, 8, 16, 3, 2, 2, 1>(x, wa, ma, ba, wb, mb, bb, out, B, H,
                                                           W, relu_b, s);
  if (cin == 128 && cm == 128 && co == 128 && pool)
    return launch_tc<128, 128, 128, true, 8, 16, 3, 2, 2, 1>(x, wa, ma, ba, wb, mb, bb, out, B, H,
                                                          W, relu_b, s);
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

// The same with bf16 x, mid and out, and weights packed by pack_slabs
// ([9][co/8][ci/8][8][8] bf16, see conv_tc.cuh).
extern "C" int double_conv3x3_bf16_launch(const void* x, const void* wa, const void* ma,
                                          const void* ba, const void* wb, const void* mb,
                                          const void* bb, void* out, int B, int H, int W,
                                          int cin, int cm, int co, int pool, int relu_b,
                                          void* stream) {
  return dispatch_tc(x, wa, ma, ba, wb, mb, bb, out, B, H, W, cin, cm, co, pool, relu_b, stream);
}
