// Per-row (M, K) @ (K, N) product with the per-channel affine, optional
// ReLU and the cast in its epilogue: int8 operands (int32 sums) or bf16
// operands (float32 sums) on the tensor cores, and conv1's float32 patch
// product on the CUDA cores.
//
// Replaces spnerf_tpu/kernels/conv_stack_pallas.py dot_bias_act_pallas:
// the unfused heads' 1x1 convs (convPb: 256 -> 65, convDb: 256 -> 256;
// int8 or bf16 operands, bf16 out) and conv1_packed (:477), the first
// VGG block as a 9-tap patch product (float32 patches, 9 -> 64, bf16 or
// int8 out). Only the n_store real output lanes reach HBM.
//
// Bound on an H100 SXM: bytes, at every shape of the serving path. A
// head row reads 256 int8 or bf16 values and writes 65 or 256 bf16 for
// 65 or 256 multiply-adds per value read (M 38,400: 0.0044-0.0118 ms); a
// conv1 pixel reads 36 bytes and writes 128 for 576 multiply-adds (M
// 2,457,600: 0.1203 ms).
//
// Tensor-core instances (dot_tc_kernel, K 256, N 72 or 256): persistent
// blocks, as many as fit on the SMs (one at N 256, whose bf16 weights
// take 128 KB of shared memory). A block copies the packed weights into
// shared memory once, then walks over 64-row tiles of x, each copied by
// cp.async into one of two buffers (rows padded by 16 bytes, so that 8
// consecutive rows fall in 8 different bank groups) while the other is
// being multiplied (rows past M read as zeros). Warp w holds rows
// [16 (w % 4), 16 (w % 4) + 16) of the tile; A comes from those rows by
// ldmatrix.
// - N 72 (the detector's 65 lanes, padded to the narrowest multiple of
//   the n8 tile inside the kernel): four warps, each all 72 columns, by
//   mma.sync (int8: m16n8k32 s8 -> s32; bf16: m16n8k16 -> f32), B by
//   ldmatrix from the weights' rows ([N][K], K contiguous).
// - N 256: two warpgroups, each two 64-column chunks, by wgmma m64n64
//   (k16 bf16, k32 s8) with A from registers and B from the weights
//   through a descriptor (pack_slabs' K-major core matrices): B is read
//   once per warpgroup and k-step, where mma.sync made every warp read it
//   for its own 16 rows.
// Outputs go through a per-warp staging area in shared memory and leave
// as 16-byte stores: at N 72 the warp's 16 rows x n_store bf16 are one
// contiguous span of HBM; at N 256 each 64-channel chunk is 16 rows of
// 128 contiguous bytes. Registers (ptxas, sm_90a): bf16 N 72 252, N 256
// 170; int8 174 and 112; the float32 instance 125 (bf16 out) and 124; no
// spills.
//
// Numerics. int8: int32 sums are exact in any order, so the result equals
// dot_bias_act_plain's bit for bit. bf16: every product of two bf16
// values is exact; the tensor cores add those of 64 input channels in
// float32 into a fresh partial (their own additions round toward zero),
// and the CUDA cores add the four partials to nearest in a fixed order,
// as conv_tc.cuh's two-level sums. Epilogue: __fmul_rn / __fadd_rn, ReLU
// if asked, bf16 to nearest even.
//
// float32 instance (dot_f32_kernel, K 9, N 64): the same persistent,
// double-buffered skeleton with tiles of 256 rows; each thread owns 8
// output channels of a row (its channel group is fixed, so its 72
// weights, multipliers and biases sit in registers), sums the 9 taps
// with float32 FMAs in tap order and stores them as one vector: 16 bytes
// of bf16 (a warp writes 512 contiguous bytes) or 8 of int8.
#include "conv_common.cuh"
#include "conv_tc.cuh"

namespace {

using namespace spnerf;
using tc::cp_async16;
using tc::ldmatrix_x4;
using tc::smem_u32;

constexpr int kRows = 64;          // rows of a tensor-core tile
constexpr int kF32Rows = 256;      // rows of a float32 tile
constexpr int kF32Threads = 256;

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t addr, uint32_t (&r)[2]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

// One m16n8 product step over 32 bytes of K per row: the operand traits.
template <typename T>
struct Mma;

template <>
struct Mma<int8_t> {
  using Acc = int;
  static __device__ __forceinline__ void run(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  // wgmma m64n64k32, A (the warp's 16 rows x 32 bytes) from registers
  static __device__ __forceinline__ void wg(int (&d)[32], const uint32_t (&a)[4],
                                            uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  }
  static __device__ __forceinline__ int add(int acc, int part) { return acc + part; }
};

template <>
struct Mma<__nv_bfloat16> {
  using Acc = float;
  static __device__ __forceinline__ void run(float (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ void wg(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t desc_b, int scale_d) {
    tc::wgmma_m64n64(d, a, desc_b, scale_d);
  }
  static __device__ __forceinline__ float add(float acc, float part) {
    return __fadd_rn(acc, part);
  }
};

// keep accumulator reads and writes on their side of a wgmma fence or wait
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
  tc::fence_regs(d);
}

template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
  #pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

template <typename T, int N>
struct DotShape {
  static constexpr bool WG = N == 256;                           // wgmma (else mma.sync)
  static constexpr int WN = WG ? 2 : 1;                          // warps (groups) along N
  static constexpr int THREADS = 128 * WN;                       // 4 x WN warps
  static constexpr int KB = 256 * static_cast<int>(sizeof(T));  // bytes of a row
  static constexpr int PITCH = KB + 16;                          // in shared memory
  static constexpr int KSTEPS = KB / 32;                         // 32 bytes of K per mma
  static constexpr int NT = N / 8;                               // n8 tiles
  static constexpr int NC = WG ? 8 : NT;                         // n8 tiles per chunk
  static constexpr int STAGE = 16 * NC * 8 * 2;                  // a warp's staged bytes
  static constexpr int W_BYTES = WG ? N * KB : N * PITCH;        // the weights
  static constexpr int SMEM = W_BYTES + 2 * kRows * PITCH + 2 * N * 4 + 4 * WN * STAGE;
};

// x (M, 256) of T; w packed: N 72 [N][256] of T (pack_rows), N 256
// wgmma's K-major core matrices (pack_slabs); mult/bias (N,) float32;
// out (M, n_store) bf16 with n_store <= N (N 72) or n_store == N (N 256).
template <typename T, int N>
__global__ void __launch_bounds__(DotShape<T, N>::THREADS, 1)
dot_tc_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
              const float* __restrict__ mult, const float* __restrict__ bias,
              __nv_bfloat16* __restrict__ out, int M, int n_store, int relu) {
  using S = DotShape<T, N>;
  using Acc = typename Mma<T>::Acc;
  constexpr int KB = S::KB, PITCH = S::PITCH, NC = S::NC, V = KB / 16, NTH = S::THREADS;
  extern __shared__ __align__(128) int8_t smem[];
  int8_t* s_w = smem;                        // W_BYTES
  int8_t* s_x = s_w + S::W_BYTES;            // 2 x kRows x PITCH
  float* s_mb = reinterpret_cast<float*>(s_x + 2 * kRows * PITCH);  // mult, bias
  // warp w: rows [16 wm, 16 wm + 16) of a tile, chunks wn, wn + WN, ...
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, wm = warp % 4, wn = warp / 4;
  int8_t* s_o = reinterpret_cast<int8_t*>(s_mb + 2 * N) + warp * S::STAGE;
  const int tiles = (M + kRows - 1) / kRows;

  for (int i = threadIdx.x; i < N * V; i += NTH)
    cp_async16(smem_u32(s_w + (S::WG ? i * 16 : (i / V) * PITCH + (i % V) * 16)),
               w + static_cast<size_t>(i) * 16, 16);
  for (int i = threadIdx.x; i < N; i += NTH) {
    s_mb[i] = mult[i];
    s_mb[N + i] = bias[i];
  }
  // one cp.async group per tile (the first also holds the weights); a
  // tile past the last still commits its empty group, so that
  // wait_group 1 always means "all but the newest"
  auto load = [&](int tile, int buf) {
    if (tile < tiles) {
      for (int i = threadIdx.x; i < kRows * V; i += NTH) {
        const int r = i / V;
        const size_t row = static_cast<size_t>(tile) * kRows + r;
        const bool in = row < static_cast<size_t>(M);
        cp_async16(smem_u32(s_x + (buf * kRows + r) * PITCH + (i % V) * 16),
                   x + (in ? row * KB + (i % V) * 16 : 0), in ? 16 : 0);
      }
    }
    cp_async_commit();
  };
  load(blockIdx.x, 0);
  load(blockIdx.x + gridDim.x, 1);

  int buf = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, buf ^= 1) {
    cp_async_wait<1>();
    __syncthreads();
    // A: lanes 0-15 give rows 0-15 at the k-step's first 16 bytes, lanes
    // 16-31 the same rows at its second (a0-a3 of the fragment); B: lane
    // group i = lane / 8 gives n8 tile j + i / 2 at 16-byte half i % 2
    const uint32_t xa = smem_u32(s_x + buf * kRows * PITCH) +
                        (wm * 16 + lane % 16) * PITCH + (lane / 16) * 16;
    const uint32_t wb = smem_u32(s_w) + (lane % 8) * PITCH + ((lane / 8) % 2) * 16;
    const int row0 = tile * kRows + wm * 16;
    const int rows = min(16, M - row0);  // may be <= 0 in the last tile
    #pragma unroll 1
    for (int ch = wn; ch < S::NT / NC; ch += S::WN) {
      // acc[4 j + e]: n8 tile j of the chunk, the layout of an m16n8
      // accumulator (and of a warp's rows of an m64n64 wgmma one)
      Acc acc[NC * 4] = {};
      #pragma unroll
      for (int kq = 0; kq < S::KSTEPS; kq += 4) {  // bf16: 64 input channels
        if constexpr (S::WG) {
          // B by descriptor: the chunk's 64 columns, K-major core
          // matrices of 8 rows x 16 bytes (LBO 128 along K, SBO KB * 8
          // along N); A from registers by ldmatrix, as for mma.sync
          Acc part[32] = {};
          uint32_t a[4][4];
          #pragma unroll
          for (int i = 0; i < 4; ++i) ldmatrix_x4(xa + (kq + i) * 32, a[i]);
          tc::wgmma_fence();
          fence_acc(part);
          #pragma unroll
          for (int i = 0; i < 4; ++i)
            Mma<T>::wg(part, a[i],
                       tc::smem_desc(smem_u32(s_w) + ch * 8 * (KB * 8) + (kq + i) * 256, 128,
                                     KB * 8),
                       i);
          tc::wgmma_commit();
          tc::wgmma_wait0();
          fence_acc(part);
          #pragma unroll
          for (int j = 0; j < 32; ++j) acc[j] = Mma<T>::add(acc[j], part[j]);
        } else {
          Acc part[NC][4] = {};
          #pragma unroll
          for (int ks = kq; ks < kq + 4; ++ks) {
            uint32_t a[4];
            ldmatrix_x4(xa + ks * 32, a);
            #pragma unroll
            for (int j = 0; j + 1 < NC; j += 2) {
              uint32_t b[4];
              ldmatrix_x4(wb + ((ch * NC + j + lane / 16) * 8) * PITCH + ks * 32, b);
              Mma<T>::run(part[j], a, b[0], b[1]);
              Mma<T>::run(part[j + 1], a, b[2], b[3]);
            }
            if constexpr (NC % 2) {
              uint32_t b[2];
              ldmatrix_x2(wb + ((ch * NC + NC - 1) * 8) * PITCH + ks * 32, b);
              Mma<T>::run(part[NC - 1], a, b[0], b[1]);
            }
          }
          #pragma unroll
          for (int j = 0; j < NC; ++j)
            #pragma unroll
            for (int e = 0; e < 4; ++e) acc[4 * j + e] = Mma<T>::add(acc[4 * j + e], part[j][e]);
        }
      }
      // accumulator e of n8 tile j: row lane / 4 + 8 (e / 2), column
      // 8 j + 2 (lane % 4) + e % 2 of the chunk
      #pragma unroll
      for (int j = 0; j < NC; ++j) {
        #pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = lane / 4 + 8 * h, cl = 8 * j + 2 * (lane % 4), c = ch * NC * 8 + cl;
          float v[2];
          #pragma unroll
          for (int e = 0; e < 2; ++e) {
            v[e] = affine(acc[4 * j + 2 * h + e], s_mb[c + e], s_mb[N + c + e]);
            if (relu) v[e] = fmaxf(v[e], 0.f);
          }
          if constexpr (N == 256) {  // 128-byte rows, 16-byte chunks swizzled by row
            *reinterpret_cast<uint32_t*>(s_o + r * 128 + ((j ^ (r & 7)) << 4) + 4 * (lane % 4)) =
                tc::pack_bf16x2(v[0], v[1]);
          } else {  // the dense image of the warp's rows in HBM
            __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(s_o) + r * n_store + c;
            if (c < n_store) o[0] = __float2bfloat16_rn(v[0]);
            if (c + 1 < n_store) o[1] = __float2bfloat16_rn(v[1]);
          }
        }
      }
      __syncwarp();
      if constexpr (N == 256) {
        for (int i = lane; i < rows * 8; i += 32) {
          const int r = i / 8, v = i % 8;
          *reinterpret_cast<int4*>(out + (static_cast<size_t>(row0) + r) * N + ch * 64 + v * 8) =
              *reinterpret_cast<const int4*>(s_o + r * 128 + ((v ^ (r & 7)) << 4));
        }
      } else if (rows > 0) {
        const int nbytes = rows * n_store * 2;  // row0 * n_store * 2 is a multiple of 32
        int8_t* o = reinterpret_cast<int8_t*>(out + static_cast<size_t>(row0) * n_store);
        for (int i = lane; i < nbytes / 16; i += 32)
          reinterpret_cast<int4*>(o)[i] = reinterpret_cast<const int4*>(s_o)[i];
        for (int i = nbytes / 16 * 8 + lane; i < nbytes / 2; i += 32)
          reinterpret_cast<uint16_t*>(o)[i] = reinterpret_cast<const uint16_t*>(s_o)[i];
      }
      __syncwarp();
    }
    __syncthreads();  // every warp is done with this buffer
    load(tile + 2 * gridDim.x, buf);
  }
  cp_async_wait<0>();
}

// x (M, 9) float32, w (9, 64) float32, mult/bias (64,), out (M, 64) of O.
template <typename O>
__global__ void __launch_bounds__(kF32Threads)
dot_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ mult, const float* __restrict__ bias,
               O* __restrict__ out, int M, int relu) {
  constexpr int K = 9, N = 64, VEC = 8, G = N / VEC;  // a thread: 8 channels of a row
  constexpr int TB = kF32Rows * K * 4;                // bytes of a tile of x
  __shared__ __align__(16) float s_x[2][kF32Rows * K];
  const int tiles = (M + kF32Rows - 1) / kF32Rows;
  auto load = [&](int tile, int buf) {
    if (tile < tiles) {
      const int bytes = min(kF32Rows, M - tile * kF32Rows) * K * 4;
      const int8_t* src = reinterpret_cast<const int8_t*>(x) +
                          static_cast<size_t>(tile) * TB;
      const uint32_t dst = smem_u32(s_x[buf]);
      for (int i = threadIdx.x; i < TB / 16; i += kF32Threads) {
        const int n = min(16, max(0, bytes - 16 * i));
        cp_async16(dst + 16 * i, n ? src + 16 * i : src, n);
      }
    }
    cp_async_commit();
  };
  load(blockIdx.x, 0);
  load(blockIdx.x + gridDim.x, 1);
  // a thread's channel group is fixed (G divides the block): its weights,
  // multipliers and biases live in registers
  const int g = threadIdx.x % G;
  float wr[K][VEC], mr[VEC], br[VEC];
  #pragma unroll
  for (int v = 0; v < VEC; ++v) {
    #pragma unroll
    for (int k = 0; k < K; ++k) wr[k][v] = __ldg(w + k * N + g * VEC + v);
    mr[v] = __ldg(mult + g * VEC + v);
    br[v] = __ldg(bias + g * VEC + v);
  }
  int buf = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, buf ^= 1) {
    cp_async_wait<1>();
    __syncthreads();
    #pragma unroll 2
    for (int r = threadIdx.x / G; r < kF32Rows; r += kF32Threads / G) {
      const size_t row = static_cast<size_t>(tile) * kF32Rows + r;
      if (row >= static_cast<size_t>(M)) break;
      float acc[VEC] = {};
      #pragma unroll
      for (int k = 0; k < K; ++k) {
        const float xv = s_x[buf][r * K + k];
        #pragma unroll
        for (int v = 0; v < VEC; ++v) acc[v] = fmaf(xv, wr[k][v], acc[v]);
      }
      O vals[VEC];
      #pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const float y = affine(acc[v], mr[v], br[v]);
        vals[v] = cast_out<O>(relu ? fmaxf(y, 0.f) : y);
      }
      store_vals<VEC>(out + row * N + g * VEC, vals);
    }
    __syncthreads();
    load(tile + 2 * gridDim.x, buf);
  }
  cp_async_wait<0>();
}

// Persistent grid: as many blocks as fit on the card at once, at most one
// per tile (the SM count and the kernel's occupancy are read once).
template <typename Kern>
int persistent_blocks(Kern kern, int threads, int smem, int tiles, int& per_sm) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (per_sm == 0) cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem);
  return min(tiles, max(per_sm, 1) * sms);
}

template <typename T, int N>
cudaError_t launch_tc(const void* x, const void* w, const void* m, const void* b, void* out,
                      int M, int n_store, int relu, cudaStream_t stream) {
  constexpr int smem = DotShape<T, N>::SMEM, threads = DotShape<T, N>::THREADS;
  static int per_sm = 0;
  auto kern = dot_tc_kernel<T, N>;
  if (per_sm == 0) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const int blocks = persistent_blocks(kern, threads, smem, (M + kRows - 1) / kRows, per_sm);
  kern<<<blocks, threads, smem, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(m), static_cast<const float*>(b),
      static_cast<__nv_bfloat16*>(out), M, n_store, relu);
  return cudaGetLastError();
}

template <typename O>
cudaError_t launch_f32(const void* x, const void* w, const void* m, const void* b, void* out,
                       int M, int relu, cudaStream_t stream) {
  static int per_sm = 0;
  auto kern = dot_f32_kernel<O>;
  const int blocks =
      persistent_blocks(kern, kF32Threads, 0, (M + kF32Rows - 1) / kF32Rows, per_sm);
  kern<<<blocks, kF32Threads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<const float*>(m),
      static_cast<const float*>(b), static_cast<O*>(out), M, relu);
  return cudaGetLastError();
}

}  // namespace

// x (M, cin) of dtype (0 int8, 1 bf16, 2 float32); w packed by the
// wrapper: int8 and bf16 (coutp, 256), the transposed weights zero-padded
// to coutp output channels; float32 (9, 64) as they are. m/b (coutp,)
// float32; out (M, n_store) bf16 (out_int8 = 0) or int8 (1, float32
// only). Supported: int8 and bf16 with cin 256 and coutp 72 (n_store <=
// 72) or 256 (n_store 256); float32 with cin 9, coutp and n_store 64.
// M 0 launches nothing.
extern "C" int dot_bias_act_launch(const void* x, const void* w, const void* m, const void* b,
                                   void* out, int M, int cin, int dtype, int coutp,
                                   int n_store, int relu, int out_int8, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  using BF = __nv_bfloat16;
  const bool tc_ok = (dtype == 0 || dtype == 1) && cin == 256 && !out_int8 &&
                     ((coutp == 72 && n_store <= 72) || (coutp == 256 && n_store == 256));
  const bool f32_ok = dtype == 2 && cin == 9 && coutp == 64 && n_store == 64;
  if (!(tc_ok || f32_ok) || M < 0 || n_store <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return static_cast<int>(cudaSuccess);
  cudaError_t err;
  if (dtype == 0 && coutp == 72)
    err = launch_tc<int8_t, 72>(x, w, m, b, out, M, n_store, relu, s);
  else if (dtype == 0)
    err = launch_tc<int8_t, 256>(x, w, m, b, out, M, n_store, relu, s);
  else if (dtype == 1 && coutp == 72)
    err = launch_tc<BF, 72>(x, w, m, b, out, M, n_store, relu, s);
  else if (dtype == 1)
    err = launch_tc<BF, 256>(x, w, m, b, out, M, n_store, relu, s);
  else if (out_int8)
    err = launch_f32<int8_t>(x, w, m, b, out, M, relu, s);
  else
    err = launch_f32<BF>(x, w, m, b, out, M, relu, s);
  return static_cast<int>(err);
}
