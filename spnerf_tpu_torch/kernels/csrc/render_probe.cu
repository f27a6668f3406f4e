// Test-only probes of render.cu's device code, built apart from the
// render library (tests/test_torch_cuda.py loads them as "render_probe"):
// the sine against sinf on every float32 bit pattern, one wgmma m64n8k16,
// the instruction the bf16 render's products are built of, and one wgmma
// m64n8k8 .tf32 on raw float32 words, the float32 render's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "conv_tc.cuh"
#include "render_common.cuh"
#include "tf32_tc.cuh"

namespace {

using spnerf::render::kSineBig;
using spnerf::render::sine;
using spnerf::render::sine_fast;
using spnerf::render::stage_weights;
using spnerf::render::wgmma_bf16;
using spnerf::tc::fence_regs;
using spnerf::tc::smem_desc;
using spnerf::tc::smem_u32;
using spnerf::tc::wgmma_commit;
using spnerf::tc::wgmma_fence;
using spnerf::tc::wgmma_wait0;
using spnerf::tf32::wgmma_tf32;

constexpr int kWG = 128;  // threads of a warpgroup

// every float32 bit pattern: add to *mismatches the number whose sine()
// differs from sinf, and whose sine_fast() does below kSineBig (any NaN
// equals any NaN)
__global__ void sine_check_kernel(unsigned long long* mismatches) {
  unsigned long long bad = 0;
  const unsigned long long step = static_cast<unsigned long long>(gridDim.x) * blockDim.x;
  for (unsigned long long i = blockIdx.x * static_cast<unsigned long long>(blockDim.x) +
                              threadIdx.x;
       i < (1ULL << 32); i += step) {
    const float x = __uint_as_float(static_cast<unsigned>(i));
    const float a = sine(x), b = sinf(x), f = sine_fast(x);
    bad += __float_as_uint(a) != __float_as_uint(b) && !(a != a && b != b);
    bad += !(fabsf(x) >= kSineBig) && __float_as_uint(f) != __float_as_uint(b) &&
           !(f != f && b != b);
  }
  if (bad) atomicAdd(mismatches, bad);
}

// One warpgroup a problem: d (64 x 8) = a (64 x 16 bf16, row-major) * b
// (16 x 8 bf16, row-major) (+ c when scale_c), by one wgmma m64n8k16, the
// instruction the render's products are built of: the plain version's
// model of its sums (kernels/render.py tc_step) is held against it.
__global__ void wgmma_probe_kernel(const __nv_bfloat16* __restrict__ a,
                                   const __nv_bfloat16* __restrict__ b,
                                   const float* __restrict__ c, float* __restrict__ d,
                                   int scale_c) {
  __shared__ __align__(128) __nv_bfloat16 bs[16 * 8];
  const size_t pa = blockIdx.x * 64 * 16, pb = blockIdx.x * 16 * 8, pc = blockIdx.x * 64 * 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  stage_weights<16, 8>(b + pb, 8, bs);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  auto pair = [&](int row, int col) {
    return static_cast<uint32_t>(__bfloat16_as_ushort(a[pa + row * 16 + col])) |
           (static_cast<uint32_t>(__bfloat16_as_ushort(a[pa + row * 16 + col + 1])) << 16);
  };
  const int r0 = 16 * warp + g, r1 = r0 + 8, c0 = 2 * t4;
  const uint32_t frag[4] = {pair(r0, c0), pair(r1, c0), pair(r0, c0 + 8), pair(r1, c0 + 8)};
  float acc[4] = {c[pc + r0 * 8 + c0], c[pc + r0 * 8 + c0 + 1], c[pc + r1 * 8 + c0],
                  c[pc + r1 * 8 + c0 + 1]};
  const uint64_t desc = smem_desc(smem_u32(bs), 128, 256);
  wgmma_fence();
  if (scale_c)
    wgmma_bf16<8, true>(acc, frag, desc);
  else
    wgmma_bf16<8, false>(acc, frag, desc);
  wgmma_commit();
  wgmma_wait0();
  fence_regs(acc);
  d[pc + r0 * 8 + c0] = acc[0];
  d[pc + r0 * 8 + c0 + 1] = acc[1];
  d[pc + r1 * 8 + c0] = acc[2];
  d[pc + r1 * 8 + c0 + 1] = acc[3];
}

// One warpgroup a problem: d (64 x 8) = a (64 x 8) * b (8 x 8) + c, float32
// words as they are (row-major), by one wgmma m64n8k8 .tf32: b K-major in
// 8 x 4 core matrices (element (k, n) at word (k / 4) 32 + n 4 + k % 4),
// a's fragment register i of lane 4 g + t4 row g + 8 (i % 2), column t4 +
// 4 (i / 2).
__global__ void wgmma_tf32_probe_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                        const float* __restrict__ c, float* __restrict__ d) {
  __shared__ __align__(128) float bs[8 * 8];
  const size_t pa = blockIdx.x * 64 * 8, pb = blockIdx.x * 8 * 8, pc = blockIdx.x * 64 * 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  if (threadIdx.x < 64) {
    const int k = threadIdx.x / 8, n = threadIdx.x % 8;
    bs[(k / 4) * 32 + n * 4 + k % 4] = b[pb + k * 8 + n];
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const int r0 = 16 * warp + g, r1 = r0 + 8, c0 = 2 * t4;
  const uint32_t frag[4] = {__float_as_uint(a[pa + r0 * 8 + t4]),
                            __float_as_uint(a[pa + r1 * 8 + t4]),
                            __float_as_uint(a[pa + r0 * 8 + t4 + 4]),
                            __float_as_uint(a[pa + r1 * 8 + t4 + 4])};
  float acc[4] = {c[pc + r0 * 8 + c0], c[pc + r0 * 8 + c0 + 1], c[pc + r1 * 8 + c0],
                  c[pc + r1 * 8 + c0 + 1]};
  wgmma_fence();
  wgmma_tf32<8>(acc, frag, smem_desc(smem_u32(bs), 128, 256), 1);
  wgmma_commit();
  wgmma_wait0();
  fence_regs(acc);
  d[pc + r0 * 8 + c0] = acc[0];
  d[pc + r0 * 8 + c0 + 1] = acc[1];
  d[pc + r1 * 8 + c0] = acc[2];
  d[pc + r1 * 8 + c0 + 1] = acc[3];
}
}  // namespace

// mismatches: one zeroed uint64 on the card, which gets the number of
// float32 bit patterns whose sine() differs from sinf.
extern "C" int render_sine_mismatches(void* mismatches, void* stream) {
  sine_check_kernel<<<1056, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(mismatches));
  return static_cast<int>(cudaGetLastError());
}

// a (count, 64, 16) and b (count, 16, 8) bf16, c and d (count, 64, 8)
// float32: d = a @ b (+ c when scale_c) by one wgmma m64n8k16 each.
extern "C" int render_wgmma_probe(const void* a, const void* b, const void* c, void* d,
                                  int count, int scale_c, void* stream) {
  if (count <= 0) return static_cast<int>(cudaErrorInvalidValue);
  wgmma_probe_kernel<<<count, kWG, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
      static_cast<const float*>(c), static_cast<float*>(d), scale_c);
  return static_cast<int>(cudaGetLastError());
}

// a (count, 64, 8), b (count, 8, 8), c and d (count, 64, 8) float32:
// d = a @ b + c by one wgmma m64n8k8 .tf32 each, on the words as given.
extern "C" int render_tf32_probe(const void* a, const void* b, const void* c, void* d,
                                 int count, void* stream) {
  if (count <= 0) return static_cast<int>(cudaErrorInvalidValue);
  wgmma_tf32_probe_kernel<<<count, kWG, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<const float*>(c),
      static_cast<float*>(d));
  return static_cast<int>(cudaGetLastError());
}
