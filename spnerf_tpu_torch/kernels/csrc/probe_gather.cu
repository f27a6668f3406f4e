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
// this card all three are plain loads, each index read once, the table
// through the read-only cache: rows and in-rows one thread a 16-byte
// vector of a row (rows, F % 4 == 0) or one value in flat order.
//
// Bound on an H100 SXM: bytes. Each call moves its indices, the table
// values it touches and its output once; at the probe file's sizes (tables
// of 256 KB to 2 MB) that is well under a microsecond and a launch is what
// is measured. A 2^18 x 128 table (128 MB, past the 50 MB L2) with 2^20
// row indices moves 4 MB + up to 128 MB + 512 MB, 0.19 ms at 3.35 TB/s;
// the column gather with 2^18 x 128 indices 128 + 128 + 128 MB, 0.11 ms.
// (Times below: NVIDIA H100 80GB HBM3 at 700 W, device time by the
// profiler, tools/kernel_times.py --match probe_gather.)
//
// The column gather walks the output slab by slab. In flat order a warp
// took one output row's 128 columns, which lie in 32 random table rows,
// and the blocks in flight spanned every column of the table, all 128 MB
// of it past the 50 MB L2: nearly every 4-byte value cost a sector from
// HBM (0.97 ms). Here a slab is kSlab = 16 columns (64 bytes of a table
// row) and the blocks go slab by slab: block b takes rows kColRows (b %
// chunks).. of slab b / chunks, so that all rows of one slab come before
// the next. A warp covers 2 rows x 16 columns, so its index reads and
// output writes are whole 64-byte pieces of rows, and a thread walks
// kColSteps row groups, its index loads issued before its table loads.
// The table lines in use are then one 128-byte line of each row (a line
// holds two slabs), T x 128 bytes: 16 MB at T 2^17, where the kernel runs
// near its floor with the whole table in L2 (0.30-0.34 ms against 0.24 at
// a 2 MB table: 2^25 scattered 4-byte reads, each its own L2 sector), and
// 32 MB at T 2^18 (0.44 ms), past what one 25 MB L2 partition keeps.
// Slabs of 8 columns ran 0.65 ms, of 32 columns 0.45; an L2 evict-last
// hint on the table's loads changed nothing. Indices and outputs are
// streamed (ld.global.cs, st.global.cs: evict first), so that they do not
// push the table's lines out of L2. A ragged last slab (F % 16 != 0) and
// last chunk of rows are masked.

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

constexpr int kSlab = 16;                                   // columns of a slab
constexpr int kColThreads = 256;                            // threads of a block
constexpr int kColSteps = 2;                                // row groups a thread walks
constexpr int kColRows = kColThreads / kSlab * kColSteps;  // rows of a block: 32

__global__ void __launch_bounds__(kColThreads)
gather_columns_kernel(const float* __restrict__ table, const int* __restrict__ idx,
                      float* __restrict__ out, int N, int T, int F, unsigned chunks) {
  const int slab = static_cast<int>(blockIdx.x / chunks);
  const int j = slab * kSlab + static_cast<int>(threadIdx.x % kSlab);
  if (j >= F) return;
  const int i0 = static_cast<int>(blockIdx.x % chunks) * kColRows +
                 static_cast<int>(threadIdx.x / kSlab);
  long long at[kColSteps];
  int r[kColSteps];
#pragma unroll
  for (int k = 0; k < kColSteps; ++k) {
    const int i = i0 + k * (kColThreads / kSlab);
    at[k] = i < N ? static_cast<long long>(i) * F + j : -1;
    r[k] = at[k] >= 0 ? __ldcs(idx + at[k]) : -1;
  }
#pragma unroll
  for (int k = 0; k < kColSteps; ++k) {
    if (at[k] < 0) continue;
    __stcs(out + at[k], r[k] >= 0 && r[k] < T
                            ? __ldg(table + static_cast<long long>(r[k]) * F + j)
                            : NAN);
  }
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
    case 1: {
      // slab-major: the chunks of rows of slab 0, then of slab 1, ...
      const long long chunks = (static_cast<long long>(N) + kColRows - 1) / kColRows;
      const long long grid = chunks * ((F + kSlab - 1) / kSlab);
      if (grid > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
      if (grid > 0)
        gather_columns_kernel<<<static_cast<unsigned>(grid), kColThreads, 0, stream>>>(
            s, ix, o, N, T, F, static_cast<unsigned>(chunks));
      break;
    }
    case 2:
      n = static_cast<long long>(N) * G;
      if (n > 0) gather_in_rows_kernel<<<blocks(n), kThreads, 0, stream>>>(s, ix, o, n, F, G);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
