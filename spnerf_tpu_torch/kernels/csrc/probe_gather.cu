// The gather probes: the three forms of benchmarks/mosaic_gather_probe.py
// (its kernels at :47, :60 and :73, launched by _run at :34), float32:
//
//   rows:     out[i, :]  = table[idx[i], :]        table (T, F), idx (N,)
//   columns:  out[i, j]  = table[idx[i, j], j]     take_along_axis, axis 0
//   in-rows:  out[i, j]  = x[i, idx[i, j]]         take_along_axis, axis 1
//
// An index outside the table gives NaN (jnp.take's and take_along_axis'
// default fill), so that no index reads outside its tensor. On the TPU
// only the in-row (lane) gather lowered through Mosaic; the other two
// failed to compile, which ruled out a fused hash-grid kernel there. On
// this card all three are plain loads: one thread a 16-byte vector of a
// row (rows, F % 4 == 0) or one value (the others), each index read once,
// the table through the read-only cache.
//
// Bound on an H100 SXM: bytes. Each call moves its indices, the table
// values it touches and its output once; at the probe file's sizes (tables
// of 256 KB to 2 MB) that is well under a microsecond and a launch is what
// is measured. A 2^18 x 128 table (128 MB, past the 50 MB L2) with 2^20
// row indices moves 4 MB + up to 128 MB + 512 MB, 0.19 ms at 3.35 TB/s.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const float4* __restrict__ table, const int* __restrict__ idx,
                   float4* __restrict__ out, long long n_vec, int T, int F4) {
  const long long v = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (v >= n_vec) return;
  const long long i = v / F4;
  const int c = static_cast<int>(v % F4), r = __ldg(idx + i);
  out[v] = r >= 0 && r < T ? __ldg(table + static_cast<long long>(r) * F4 + c)
                           : make_float4(NAN, NAN, NAN, NAN);
}

__global__ void __launch_bounds__(kThreads)
gather_columns_kernel(const float* __restrict__ table, const int* __restrict__ idx,
                      float* __restrict__ out, long long n, int T, int F) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= n) return;
  const int r = __ldg(idx + e), j = static_cast<int>(e % F);
  out[e] = r >= 0 && r < T ? __ldg(table + static_cast<long long>(r) * F + j) : NAN;
}

__global__ void __launch_bounds__(kThreads)
gather_in_rows_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                      float* __restrict__ out, long long n, int F, int G) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= n) return;
  const int c = __ldg(idx + e);
  out[e] = c >= 0 && c < F ? __ldg(x + (e / G) * F + c) : NAN;
}

unsigned blocks(long long n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }

}  // namespace

// form 0 rows: src the (T, F) table (F % 4 == 0), idx (N,), out (N, F);
// form 1 columns: src (T, F), idx and out (N, F); form 2 in-rows: src
// (N, F), idx and out (N, G). All float32 but the int32 indices.
extern "C" int probe_gather_launch(const void* src, const void* idx, void* out, int form, int T,
                                   int F, int N, int G, cudaStream_t stream) {
  const auto* s = static_cast<const float*>(src);
  const auto* ix = static_cast<const int*>(idx);
  auto* o = static_cast<float*>(out);
  long long n = 0;
  switch (form) {
    case 0:
      if (F % 4 != 0) return cudaErrorInvalidValue;
      n = static_cast<long long>(N) * (F / 4);
      if (n > 0)
        gather_rows_kernel<<<blocks(n), kThreads, 0, stream>>>(
            reinterpret_cast<const float4*>(s), ix, reinterpret_cast<float4*>(o), n, T, F / 4);
      break;
    case 1:
      n = static_cast<long long>(N) * F;
      if (n > 0) gather_columns_kernel<<<blocks(n), kThreads, 0, stream>>>(s, ix, o, n, T, F);
      break;
    case 2:
      n = static_cast<long long>(N) * G;
      if (n > 0) gather_in_rows_kernel<<<blocks(n), kThreads, 0, stream>>>(s, ix, o, n, F, G);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
