// TMA, mbarrier and cluster helpers for Hopper (sm_90a): tensor-map
// copies into shared memory, bulk copies multicast to a cluster, barrier
// arrivals on another block of the cluster, and the host's tensor-map
// encoder. Used by probe_conv.cu.
//
// The encoder (cuTensorMapEncodeTiled) lives in libcuda. It is looked up
// through the runtime's entry-point query, so that the library links no
// libcuda: cuda.h is read for its types and enums alone.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace spnerf {
namespace tma {

// ---- device ----

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of every block of the cluster, barrier-arrive then wait:
// what a block wrote to shared memory before it (barriers initialised)
// is seen by the others after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// after the barriers' initialisation, before any other thread (of the
// cluster) or the async proxy uses them
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// wait for the phase of parity to complete; a wait of more than 2^24
// tries (far past any copy's or product's time) traps, so that a barrier
// that can never complete ends the launch with an error instead of
// hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 24)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// one arrival on this block's barrier
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// one arrival on the barrier at the same shared address in block cta of
// the cluster (this block's own included), with the default CTA-scope
// release (.release.cluster cost probe_conv.cu about 1.3 us an arrival)
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 ra;\nmapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n" ::"r"(bar),
      "r"(cta)
      : "memory");
}

// the 4-D box of map at coordinates (c0, c1, c2, c3), innermost first,
// into shared memory at dst (128-byte aligned), its bytes completing on
// bar; elements outside the tensor arrive as zeros and count
__device__ __forceinline__ void load_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                        int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// the same for a 3-D box at (c0, c1, c2)
__device__ __forceinline__ void load_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                        int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// bytes (a multiple of 16) from global src to shared dst, on bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// the same into every block of the cluster in mask, at the same shared
// address dst, each completing on its own barrier at bar's address
__device__ __forceinline__ void bulk_load_multicast(uint32_t dst, const void* src,
                                                    uint32_t bytes, uint32_t bar,
                                                    uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster"
      " [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "h"(mask)
      : "memory");
}

// ---- host ----

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, or null
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A byte tensor map of RANK dims, without interleave: dims and box
// innermost first, strides (bytes, multiples of 16) of dims 1 .. RANK -
// 1; zeros outside; swizzle NONE, or 64B / 128B (the box's inner
// dimension that many bytes: the 16-byte chunk c of row r lands at chunk
// c ^ ((r >> 1) & 3) or c ^ (r & 7) of the row, wgmma's swizzled K-major
// layouts). Returns the encoder's CUresult (CUDA_ERROR_NOT_FOUND without
// it).
template <int RANK>
inline CUresult encode_bytes(CUtensorMap* map, const void* base, const cuuint64_t (&dims)[RANK],
                             const cuuint64_t (&strides)[RANK - 1],
                             const cuuint32_t (&box)[RANK], CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return CUDA_ERROR_NOT_FOUND;
  cuuint32_t elem_strides[RANK];
  for (int i = 0; i < RANK; ++i) elem_strides[i] = 1;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, RANK, const_cast<void*>(base), dims, strides,
                box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

}  // namespace tma
}  // namespace spnerf
