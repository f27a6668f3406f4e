// Shared device code of the SuperPoint serving kernels (sm_90a): the
// __dp4a conv stages of conv3x3.cu's int8 instance, and the epilogue
// helpers (affine, cast_out, store_vals) of every instance. The other
// instances run on the tensor cores through conv_tc.cuh (bf16 3x3 convs,
// head.cu), conv_tc_s8.cuh (int8: conv12_fused.cu, double_conv3x3.cu,
// head.cu) or mma.sync (dot_bias_act.cu); their headers state their
// numerics.
//
// Layout: NHWC int8 activations. Weights are pre-packed by the Python
// wrappers as 32-bit words [tap][cin / 4][cout], each word holding 4
// consecutive input channels of one output channel, the same packing as
// a pixel's channels in memory. One word of a pixel times the matching
// weight word is one __dp4a (int32 sums).
//
// Thread mapping of every conv stage: a warp owns a chunk of P pixels and
// all COUT output channels; lane l holds channels [l*Q, l*Q + Q) with
// Q = COUT / 32 and P * Q = 32 accumulators. Pixel words come from shared
// memory (all lanes read the same address: a broadcast), weight words
// from global memory through L1/L2 (lanes read consecutive words).
//
// Numerics. int8 matches the reference's int8 chain bit for bit: int32
// accumulation, then float32 acc * mult and + bias as two separately
// rounded operations (no FMA contraction), then round half to even and
// clip to +-127.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace spnerf {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Operand traits: accumulator type and the dot of one 32-bit word pair.
template <typename T>
struct Op;

template <>
struct Op<int8_t> {
  using Acc = int;
  static __device__ __forceinline__ int dot(int x, int w, int acc) {
    return __dp4a(x, w, acc);
  }
};

__device__ __forceinline__ float affine(int acc, float m, float b) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), m), b);
}

__device__ __forceinline__ float affine(float acc, float m, float b) {
  return __fadd_rn(__fmul_rn(acc, m), b);
}

__device__ __forceinline__ int8_t cast_i8(float y) {
  float r = fminf(fmaxf(rintf(y), -127.f), 127.f);
  return static_cast<int8_t>(static_cast<int>(r));
}

// float32 -> output type: int8 as cast_i8, bf16 rounded to nearest even.
template <typename O>
__device__ __forceinline__ O cast_out(float y);

template <>
__device__ __forceinline__ int8_t cast_out<int8_t>(float y) {
  return cast_i8(y);
}

template <>
__device__ __forceinline__ __nv_bfloat16 cast_out<__nv_bfloat16>(float y) {
  return __float2bfloat16_rn(y);
}

// Q consecutive int32 words from global memory (Q = 2, 4 or 8).
template <int Q>
__device__ __forceinline__ void load_words(const int* __restrict__ p, int (&w)[Q]) {
  if constexpr (Q == 2) {
    int2 v = __ldg(reinterpret_cast<const int2*>(p));
    w[0] = v.x; w[1] = v.y;
  } else {
    #pragma unroll
    for (int i = 0; i < Q; i += 4) {
      int4 v = __ldg(reinterpret_cast<const int4*>(p + i));
      w[i] = v.x; w[i + 1] = v.y; w[i + 2] = v.z; w[i + 3] = v.w;
    }
  }
}

// Q int8 values to a Q-byte-aligned address (Q = 2, 4 or 8).
template <int Q>
__device__ __forceinline__ void store_vals(int8_t* p, const int8_t (&v)[Q]) {
  if constexpr (Q == 2) {
    *reinterpret_cast<uint16_t*>(p) =
        static_cast<uint8_t>(v[0]) | (static_cast<uint8_t>(v[1]) << 8);
  } else {
    #pragma unroll
    for (int i = 0; i < Q; i += 4) {
      *reinterpret_cast<uint32_t*>(p + i) =
          static_cast<uint32_t>(static_cast<uint8_t>(v[i])) |
          (static_cast<uint32_t>(static_cast<uint8_t>(v[i + 1])) << 8) |
          (static_cast<uint32_t>(static_cast<uint8_t>(v[i + 2])) << 16) |
          (static_cast<uint32_t>(static_cast<uint8_t>(v[i + 3])) << 24);
    }
  }
}

// Q bf16 values to a 2Q-byte-aligned address (Q = 2, 4 or 8).
template <int Q>
__device__ __forceinline__ void store_vals(__nv_bfloat16* p, const __nv_bfloat16 (&v)[Q]) {
  uint32_t w[Q / 2];
  #pragma unroll
  for (int i = 0; i < Q / 2; ++i)
    w[i] = static_cast<uint32_t>(__bfloat16_as_ushort(v[2 * i])) |
           (static_cast<uint32_t>(__bfloat16_as_ushort(v[2 * i + 1])) << 16);
  if constexpr (Q == 2) {
    *reinterpret_cast<uint32_t*>(p) = w[0];
  } else if constexpr (Q == 4) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
    #pragma unroll
    for (int i = 0; i < Q / 2; i += 4)
      *reinterpret_cast<uint4*>(p + 2 * i) = make_uint4(w[i], w[i + 1], w[i + 2], w[i + 3]);
  }
}

// Copy a th x tw pixel window (top-left at image row y0, column x0) of
// one NHWC image with PB bytes per pixel into shared memory, zero outside
// the image. 16-byte vectors; PB must be a multiple of 16.
template <int PB>
__device__ __forceinline__ void load_tile(const int8_t* __restrict__ img, int H, int W,
                                          int y0, int x0, int th, int tw, int8_t* s) {
  constexpr int V = PB / 16;
  const int n = th * tw * V;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int v = i % V, p = i / V;
    const int y = y0 + p / tw, x = x0 + p % tw;
    int4 val = make_int4(0, 0, 0, 0);
    if (y >= 0 && y < H && x >= 0 && x < W)
      val = __ldg(reinterpret_cast<const int4*>(img + (static_cast<size_t>(y) * W + x) * PB) + v);
    reinterpret_cast<int4*>(s)[i] = val;
  }
}

// acc[p][q] += sum over KS x KS taps and CIN channels of
//   s_in[(base[p] + dy * tw + dx) * CIN + ci] * w[dy * KS + dx][ci][lane * Q + q]
// s_in: shared tile of T, tw pixels per row; base[p]: tile index of pixel
// p's top-left tap; w: packed weight words [KS*KS][CIN/per_word][COUT].
template <typename T, int CIN, int COUT, int P, int KS>
__device__ __forceinline__ void conv_acc(const int8_t* s_in, int tw, const int (&base)[P],
                                         const int* __restrict__ w, int lane,
                                         typename Op<T>::Acc (&acc)[P][COUT / 32]) {
  constexpr int Q = COUT / 32;
  constexpr int PB = CIN * static_cast<int>(sizeof(T));  // bytes per pixel
  constexpr int KW = PB / 4;                             // words per pixel
  static_assert(KW % 4 == 0, "a pixel must be whole 16-byte vectors");
  #pragma unroll 1
  for (int tap = 0; tap < KS * KS; ++tap) {
    const int toff = (tap / KS) * tw + tap % KS;
    const int* wt = w + tap * KW * COUT + lane * Q;
    #pragma unroll 2
    for (int k = 0; k < KW; k += 4) {
      int wr[4][Q];
      #pragma unroll
      for (int s = 0; s < 4; ++s) load_words<Q>(wt + (k + s) * COUT, wr[s]);
      #pragma unroll
      for (int p = 0; p < P; ++p) {
        const int4 xv = *reinterpret_cast<const int4*>(s_in + (base[p] + toff) * PB + k * 4);
        #pragma unroll
        for (int q = 0; q < Q; ++q) {
          auto a = acc[p][q];
          a = Op<T>::dot(xv.x, wr[0][q], a);
          a = Op<T>::dot(xv.y, wr[1][q], a);
          a = Op<T>::dot(xv.z, wr[2][q], a);
          a = Op<T>::dot(xv.w, wr[3][q], a);
          acc[p][q] = a;
        }
      }
    }
  }
}

// A 3x3 conv stage over the n positions of a tile laid out mw wide, read
// from s_in (tw pixels per row, position (r, c) having its top-left tap
// at tile pixel (r, c)), with ReLU, cast to T into s_out (COUT values per
// position). Positions for which outside(r, c) holds are stored as zero:
// SAME padding of the next conv must read true zeros.
template <typename T, int CIN, int COUT, typename Outside>
__device__ __forceinline__ void conv3x3_requant_stage(
    const int8_t* s_in, int tw, int mw, int n, const int* __restrict__ w,
    const float* __restrict__ mult, const float* __restrict__ bias, T* s_out,
    Outside outside) {
  constexpr int Q = COUT / 32, P = 32 / Q;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float mq[Q], bq[Q];
  #pragma unroll
  for (int q = 0; q < Q; ++q) {
    mq[q] = __ldg(mult + lane * Q + q);
    bq[q] = __ldg(bias + lane * Q + q);
  }
  for (int c0 = warp * P; c0 < n; c0 += kWarps * P) {
    int base[P];
    #pragma unroll
    for (int p = 0; p < P; ++p) {
      const int m = min(c0 + p, n - 1);
      base[p] = (m / mw) * tw + m % mw;
    }
    typename Op<T>::Acc acc[P][Q] = {};
    conv_acc<T, CIN, COUT, P, 3>(s_in, tw, base, w, lane, acc);
    #pragma unroll
    for (int p = 0; p < P; ++p) {
      const int m = c0 + p;
      if (m >= n) break;
      const bool out = outside(m / mw, m % mw);
      T v[Q];
      #pragma unroll
      for (int q = 0; q < Q; ++q)
        v[q] = out ? cast_out<T>(0.f)
                   : cast_out<T>(fmaxf(affine(acc[p][q], mq[q], bq[q]), 0.f));
      store_vals<Q>(s_out + m * COUT + lane * Q, v);
    }
  }
}

// The 3x3 conv over a TH x TW output tile (top-left at image (y0, x0)),
// read from the shared tile s_mid of T ((TW + 2) positions per row, with
// a one-pixel halo), with optional ReLU and an optional 2x2 max-pool of
// the float32 values before the cast (as the reference orders it: max
// commutes with the monotone cast). Writes NHWC O to out (one image;
// pooled (H/2, W/2) when POOL).
template <typename T, typename O, int CM, int CO, bool POOL, int TH, int TW>
__device__ __forceinline__ void conv3x3_out_stage(
    const int8_t* s_mid, const int* __restrict__ w, const float* __restrict__ mult,
    const float* __restrict__ bias, bool relu, O* __restrict__ out, int H, int W,
    int y0, int x0) {
  constexpr int Q = CO / 32, P = 32 / Q, PC = P / 2;  // chunk = 2 rows x PC columns
  static_assert(TW % PC == 0 && PC % 2 == 0, "chunk must tile the output and pool");
  constexpr int NCH = (TH / 2) * (TW / PC);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float mq[Q], bq[Q];
  #pragma unroll
  for (int q = 0; q < Q; ++q) {
    mq[q] = __ldg(mult + lane * Q + q);
    bq[q] = __ldg(bias + lane * Q + q);
  }
  for (int ch = warp; ch < NCH; ch += kWarps) {
    const int r = (ch / (TW / PC)) * 2, c = (ch % (TW / PC)) * PC;
    int base[P];
    #pragma unroll
    for (int p = 0; p < P; ++p) base[p] = (r + p / PC) * (TW + 2) + c + p % PC;
    typename Op<T>::Acc acc[P][Q] = {};
    conv_acc<T, CM, CO, P, 3>(s_mid, TW + 2, base, w, lane, acc);
    float y[P][Q];
    #pragma unroll
    for (int p = 0; p < P; ++p)
      #pragma unroll
      for (int q = 0; q < Q; ++q) {
        const float v = affine(acc[p][q], mq[q], bq[q]);
        y[p][q] = relu ? fmaxf(v, 0.f) : v;
      }
    if constexpr (POOL) {
      const int oy = (y0 + r) / 2;
      #pragma unroll
      for (int j = 0; j < PC / 2; ++j) {
        const int ox = (x0 + c) / 2 + j;
        if (oy >= H / 2 || ox >= W / 2) continue;
        O v[Q];
        #pragma unroll
        for (int q = 0; q < Q; ++q)
          v[q] = cast_out<O>(fmaxf(fmaxf(y[2 * j][q], y[2 * j + 1][q]),
                                   fmaxf(y[PC + 2 * j][q], y[PC + 2 * j + 1][q])));
        store_vals<Q>(out + (static_cast<size_t>(oy) * (W / 2) + ox) * CO + lane * Q, v);
      }
    } else {
      #pragma unroll
      for (int p = 0; p < P; ++p) {
        const int gy = y0 + r + p / PC, gx = x0 + c + p % PC;
        if (gy >= H || gx >= W) continue;
        O v[Q];
        #pragma unroll
        for (int q = 0; q < Q; ++q) v[q] = cast_out<O>(y[p][q]);
        store_vals<Q>(out + (static_cast<size_t>(gy) * W + gx) * CO + lane * Q, v);
      }
    }
  }
}

}  // namespace spnerf
