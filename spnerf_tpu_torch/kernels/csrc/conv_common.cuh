// Shared epilogue helpers of the SuperPoint serving kernels (sm_90a): the
// float32 affine, the casts to int8 and bf16 and the vector stores. The
// kernels run on the tensor cores through conv_tc.cuh (bf16 3x3 convs,
// head.cu), conv_tc_s8.cuh (int8: conv12_fused.cu, double_conv3x3.cu,
// conv3x3.cu, head.cu) or mma.sync (dot_bias_act.cu); their headers state
// their numerics.
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

}  // namespace spnerf
