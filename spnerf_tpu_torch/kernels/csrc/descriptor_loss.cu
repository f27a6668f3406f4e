// Blockwise descriptor hinge loss over all raw x warped cell pairs:
// forward sums and the gradients dA, dB.
//
// Replaces spnerf_tpu/kernels/descriptor_loss_pallas.py: _hinge_sums_impl
// (_fwd_kernel) and _hinge_bwd (_bwd_da_kernel, _bwd_db_kernel). For one
// batch item with raw descriptors A (N, C), warped descriptors Bm (M, C),
// warped raw-cell centres (wy, wx), warped-image cell centres (cy, cx)
// and a cell mask over M:
//
//   dot  = A Bm^T                                   (N, M), never stored
//   s    = (cy - wy)^2 + (cx - wx)^2 <= radius^2
//   pos  = lambda_d * s * max(0, pos_margin - dot)
//   neg  = (1 - s) * max(0, dot - neg_margin)
//   S_pair, S_pos, S_neg = sum(mask * (pos + neg)), sum(mask * pos),
//                          sum(mask * neg)
//   ddot = mask * (-lambda_d * s * [dot < pos_margin]
//                  + (1 - s) * [dot > neg_margin])
//   dA   = g * ddot Bm,   dB = g * ddot^T A
//
// Bound on an H100 SXM: operations. At the training shapes (batch 2,
// N = M = 1,200, C = 256) the forward is 1.5 GFLOP of float32 against
// 5 MB of operands; the backward recomputes the dot for dA and again for
// dB and multiplies ddot into a (N, C) product each time, four times the
// forward. Nothing of size N x M reaches device memory.
//
// Design. The TPU kernel walks its (N / 128, M / 128) grid in order and
// adds every tile into one SMEM scalar; a CUDA grid has no order, so:
//  - forward: one block per 64 x 64 tile and batch item (grid M/64 x
//    N/64 x B) computes its dot tile with float32 FMAs over 16-deep
//    shared-memory slices (4 x 4 outputs per thread; the next slice's
//    global loads are in flight in registers meanwhile), applies the hinge,
//    reduces its three sums in a fixed order (shuffle tree, then warp 0
//    adds the 8 warp sums in order) and writes them as one partial. A
//    second kernel adds the partials of a batch item in a fixed order, so
//    two runs give the same bits. No atomics anywhere.
//  - backward: one kernel, run twice with the roles of A and Bm
//    exchanged. A block owns 32 rows of the gradient and all C <= 256
//    columns (8 rows x 4 columns per thread, 32 accumulators in
//    registers) and loops over the other side in tiles of 128 itself: dot
//    tile as above, ddot into shared memory, then acc[i][c] += ddot[i][j]
//    * Y[j][c] with Y read straight from global memory as float4 (just
//    loaded for the dot, so it comes from L1/L2) and ddot as two
//    broadcast float4: 3 loads per 32 FMAs, where one column per thread
//    would take 9.
// Edges are bounds-checked: rows past N or M load zeros and carry weight
// 0 (the TPU version pads with 1e9 coordinates instead).
//
// s is a step function of d2, so d2 is computed with explicitly rounded
// multiplies and adds in the reference's order (nvcc would contract them
// into an FMA and flip pairs that lie on the radius). The dot's
// accumulation order over C differs from XLA's and from cuBLAS's: the
// sums agree to float32 rounding, and a pair whose dot lies within that
// rounding of a margin may take the other side of the step in ddot.
#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr int kKC = 16;       // depth of one shared-memory slice
constexpr int kTile = 64;     // forward tile
constexpr int kOwn = 32;      // gradient rows a backward block owns
constexpr int kStream = 128;  // rows of the other side it streams at a time
constexpr int kPad = 4;       // keeps float4 rows aligned, spreads banks

struct HingeParams {
  float lambda_d, pos_margin, neg_margin, radius2;
};

// One slice of X (n_rows, C): rows [row0, row0 + ROWS) x depth [k0, k0 +
// kKC), held in registers between its global loads (fetch) and its stores
// into shared memory as dst[k][row] (store), so that the loads of the next
// slice are in flight while the current one is multiplied. Zeros past the
// edges; C % 4 == 0.
template <int ROWS>
struct Slice {
  static constexpr int kVec = ROWS * (kKC / 4);  // float4 loads in the slice
  static constexpr int kPer = (kVec + kThreads - 1) / kThreads;
  float4 v[kPer];

  __device__ __forceinline__ void fetch(const float* __restrict__ X, int n_rows, int C, int row0,
                                        int k0) {
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int id = threadIdx.x + q * kThreads;
      const int row = row0 + id / (kKC / 4), k = k0 + 4 * (id % (kKC / 4));
      v[q] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (id < kVec && row < n_rows && k < C)
        v[q] = *reinterpret_cast<const float4*>(X + static_cast<size_t>(row) * C + k);
    }
  }

  __device__ __forceinline__ void store(float (*dst)[ROWS + kPad]) const {
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int id = threadIdx.x + q * kThreads;
      if (id >= kVec) continue;
      const int r = id / (kKC / 4), kq = id % (kKC / 4);
      dst[4 * kq + 0][r] = v[q].x;
      dst[4 * kq + 1][r] = v[q].y;
      dst[4 * kq + 2][r] = v[q].z;
      dst[4 * kq + 3][r] = v[q].w;
    }
  }
};

// (y, x, weight) of rows [row0, row0 + ROWS) into shared memory; weight 0
// past the edge
template <int ROWS>
__device__ __forceinline__ void load_rows(float* sy, float* sx, float* sw,
                                          const float* __restrict__ coords,
                                          const float* __restrict__ weight, int n_rows, int row0) {
  for (int r = threadIdx.x; r < ROWS; r += kThreads) {
    const int row = row0 + r;
    const bool in = row < n_rows;
    sy[r] = in ? coords[2 * row] : 0.f;
    sx[r] = in ? coords[2 * row + 1] : 0.f;
    sw[r] = in ? weight[row] : 0.f;
  }
}

__device__ __forceinline__ bool near_cell(float ay, float ax, float by, float bx, float radius2) {
  const float dy = __fsub_rn(by, ay), dx = __fsub_rn(bx, ax);
  return __fadd_rn(__fmul_rn(dy, dy), __fmul_rn(dx, dx)) <= radius2;
}

// X (B, NX, C) against Y (B, NY, C); cx (B, NX, 2), wx (B, NX), cy
// (B, NY, 2), wy (B, NY); partials (B, gridDim.y * gridDim.x, 3)
__global__ void __launch_bounds__(kThreads)
hinge_fwd_kernel(const float* __restrict__ X, const float* __restrict__ Y,
                 const float* __restrict__ cx, const float* __restrict__ wx,
                 const float* __restrict__ cy, const float* __restrict__ wy,
                 float* __restrict__ partials, int NX, int NY, int C, HingeParams p) {
  __shared__ __align__(16) float Xs[kKC][kTile + kPad];
  __shared__ __align__(16) float Ys[kKC][kTile + kPad];
  __shared__ float xy[kTile], xx[kTile], xw[kTile], yy[kTile], yx[kTile], yw[kTile];
  __shared__ float warp_sums[kThreads / 32][3];

  const int b = blockIdx.z;
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;
  X += static_cast<size_t>(b) * NX * C;
  Y += static_cast<size_t>(b) * NY * C;
  load_rows<kTile>(xy, xx, xw, cx + static_cast<size_t>(b) * NX * 2,
                   wx + static_cast<size_t>(b) * NX, NX, i0);
  load_rows<kTile>(yy, yx, yw, cy + static_cast<size_t>(b) * NY * 2,
                   wy + static_cast<size_t>(b) * NY, NY, j0);

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[4][4] = {};
  Slice<kTile> xs, ys;
  xs.fetch(X, NX, C, i0, 0);
  ys.fetch(Y, NY, C, j0, 0);
  for (int k0 = 0; k0 < C; k0 += kKC) {
    __syncthreads();  // the last slice is read out (and the rows are loaded)
    xs.store(Xs);
    ys.store(Ys);
    __syncthreads();
    if (k0 + kKC < C) {
      xs.fetch(X, NX, C, i0, k0 + kKC);
      ys.fetch(Y, NY, C, j0, k0 + kKC);
    }
#pragma unroll
    for (int k = 0; k < kKC; ++k) {
      const float4 a4 = *reinterpret_cast<const float4*>(&Xs[k][4 * ty]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Ys[k][4 * tx]);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bb[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
  }

  float s_pair = 0.f, s_pos = 0.f, s_neg = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = 4 * tx + j;
      const float dot = acc[i][j];
      const float w = __fmul_rn(xw[r], yw[c]);
      const bool s = near_cell(xy[r], xx[r], yy[c], yx[c], p.radius2);
      const float pos = s ? __fmul_rn(p.lambda_d, fmaxf(0.f, __fsub_rn(p.pos_margin, dot))) : 0.f;
      const float neg = s ? 0.f : fmaxf(0.f, __fsub_rn(dot, p.neg_margin));
      s_pair = __fadd_rn(s_pair, __fmul_rn(w, __fadd_rn(pos, neg)));
      s_pos = __fadd_rn(s_pos, __fmul_rn(w, pos));
      s_neg = __fadd_rn(s_neg, __fmul_rn(w, neg));
    }
  }
  // fixed-order block reduction: shuffle tree, then the warps in order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s_pair += __shfl_xor_sync(0xffffffffu, s_pair, off);
    s_pos += __shfl_xor_sync(0xffffffffu, s_pos, off);
    s_neg += __shfl_xor_sync(0xffffffffu, s_neg, off);
  }
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    warp_sums[warp][0] = s_pair;
    warp_sums[warp][1] = s_pos;
    warp_sums[warp][2] = s_neg;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    float t = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) t += warp_sums[w][threadIdx.x];
    const size_t blk = static_cast<size_t>(b) * gridDim.y * gridDim.x +
                       static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x;
    partials[blk * 3 + threadIdx.x] = t;
  }
}

// partials (B, n, 3) -> sums (B, 3): each thread adds its strided share in
// order, then a shared-memory tree; the order never depends on timing
__global__ void __launch_bounds__(kThreads)
hinge_reduce_kernel(const float* __restrict__ partials, float* __restrict__ sums, int n) {
  __shared__ float tree[kThreads][3];
  const float* src = partials + static_cast<size_t>(blockIdx.x) * n * 3;
  float t[3] = {0.f, 0.f, 0.f};
  for (int i = threadIdx.x; i < n; i += kThreads)
    for (int q = 0; q < 3; ++q) t[q] += src[3 * i + q];
  for (int q = 0; q < 3; ++q) tree[threadIdx.x][q] = t[q];
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half)
      for (int q = 0; q < 3; ++q) tree[threadIdx.x][q] += tree[threadIdx.x + half][q];
    __syncthreads();
  }
  if (threadIdx.x < 3) sums[blockIdx.x * 3 + threadIdx.x] = tree[0][threadIdx.x];
}

// dX (B, NX, C) = g[b] * ddot Y, ddot over the owned rows of X (with their
// coordinates cx and weights wx) against all rows of Y; C <= kThreads
__global__ void __launch_bounds__(kThreads)
hinge_bwd_kernel(const float* __restrict__ g, const float* __restrict__ X,
                 const float* __restrict__ Y, const float* __restrict__ cx,
                 const float* __restrict__ wx, const float* __restrict__ cy,
                 const float* __restrict__ wy, float* __restrict__ dX, int NX, int NY, int C,
                 HingeParams p) {
  __shared__ __align__(16) float Xs[kKC][kOwn + kPad];
  __shared__ __align__(16) float Ys[kKC][kStream + kPad];
  __shared__ __align__(16) float Ds[kStream][kOwn + kPad];  // ddot[j][i]
  __shared__ float xy[kOwn], xx[kOwn], xw[kOwn], yy[kStream], yx[kStream], yw[kStream];

  const int b = blockIdx.y;
  const int i0 = blockIdx.x * kOwn;
  X += static_cast<size_t>(b) * NX * C;
  Y += static_cast<size_t>(b) * NY * C;
  cy += static_cast<size_t>(b) * NY * 2;
  wy += static_cast<size_t>(b) * NY;
  load_rows<kOwn>(xy, xx, xw, cx + static_cast<size_t>(b) * NX * 2,
                  wx + static_cast<size_t>(b) * NX, NX, i0);

  const int ty = threadIdx.x / 32, tx = threadIdx.x % 32;  // 4 x 4 dot outputs
  // gradient outputs of this thread: rows 8 rg .. 8 rg + 7, columns 4 cg ..
  // 4 cg + 3 (a warp shares rg: its ddot reads are broadcasts)
  const int rg = threadIdx.x / 64, cg = threadIdx.x % 64;
  const bool has_cols = 4 * cg < C;
  float grad[8][4] = {};
  Slice<kOwn> xs;
  Slice<kStream> ys;
  for (int j0 = 0; j0 < NY; j0 += kStream) {
    xs.fetch(X, NX, C, i0, 0);
    ys.fetch(Y, NY, C, j0, 0);
    __syncthreads();  // the previous tile's Ds and y rows are read out
    load_rows<kStream>(yy, yx, yw, cy, wy, NY, j0);
    float acc[4][4] = {};
    for (int k0 = 0; k0 < C; k0 += kKC) {
      if (k0 > 0) __syncthreads();  // the last slice is read out
      xs.store(Xs);
      ys.store(Ys);
      __syncthreads();
      if (k0 + kKC < C) {
        xs.fetch(X, NX, C, i0, k0 + kKC);
        ys.fetch(Y, NY, C, j0, k0 + kKC);
      }
#pragma unroll
      for (int k = 0; k < kKC; ++k) {
        const float4 a4 = *reinterpret_cast<const float4*>(&Xs[k][4 * ty]);
        const float4 b4 = *reinterpret_cast<const float4*>(&Ys[k][4 * tx]);
        const float a[4] = {a4.x, a4.y, a4.z, a4.w};
        const float bb[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 4 * tx + j;
        const float dot = acc[i][j];
        const bool s = near_cell(xy[r], xx[r], yy[c], yx[c], p.radius2);
        const float step = s ? (dot < p.pos_margin ? -p.lambda_d : 0.f)
                             : (dot > p.neg_margin ? 1.f : 0.f);
        Ds[c][r] = __fmul_rn(__fmul_rn(xw[r], yw[c]), step);
      }
    }
    __syncthreads();
    if (has_cols) {
      const int jn = min(kStream, NY - j0);
      const float* yp = Y + static_cast<size_t>(j0) * C + 4 * cg;
#pragma unroll 4
      for (int j = 0; j < jn; ++j) {
        const float4 y4 = *reinterpret_cast<const float4*>(yp + static_cast<size_t>(j) * C);
        const float4 d0 = *reinterpret_cast<const float4*>(&Ds[j][8 * rg]);
        const float4 d1 = *reinterpret_cast<const float4*>(&Ds[j][8 * rg + 4]);
        const float d[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
        const float y[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) grad[i][c] = fmaf(d[i], y[c], grad[i][c]);
      }
    }
  }
  if (has_cols) {
    const float gb = g[b];
    dX += static_cast<size_t>(b) * NX * C;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = i0 + 8 * rg + i;
      if (row < NX)
        *reinterpret_cast<float4*>(dX + static_cast<size_t>(row) * C + 4 * cg) =
            make_float4(__fmul_rn(gb, grad[i][0]), __fmul_rn(gb, grad[i][1]),
                        __fmul_rn(gb, grad[i][2]), __fmul_rn(gb, grad[i][3]));
    }
  }
}

bool bad_shape(int B, int NX, int NY, int C) {
  return B <= 0 || B > 65535 || NX <= 0 || NY <= 0 || C <= 0 || C % 4 != 0 ||
         (NX + kTile - 1) / kTile > 65535;
}

float from_bits(int bits) {
  float v;
  memcpy(&v, &bits, sizeof v);
  return v;
}

}  // namespace

// Forward sums. X (B, NX, C), Y (B, NY, C), cx (B, NX, 2), wx (B, NX), cy
// (B, NY, 2), wy (B, NY), all float32; partials: scratch of (B,
// n_partials, 3) floats with n_partials >= ceil(NX / 64) * ceil(NY / 64);
// sums (B, 3). lambda_d, the two margins and radius^2 arrive as float32
// bit patterns (the binding passes pointers and ints only).
extern "C" int desc_loss_fwd_launch(const void* X, const void* Y, const void* cx, const void* wx,
                                    const void* cy, const void* wy, void* partials, void* sums,
                                    int n_partials, int B, int NX, int NY, int C, int lambda_d,
                                    int pos_margin, int neg_margin, int radius2, void* stream) {
  if (bad_shape(B, NX, NY, C)) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const HingeParams p = {from_bits(lambda_d), from_bits(pos_margin), from_bits(neg_margin),
                         from_bits(radius2)};
  const dim3 grid((NY + kTile - 1) / kTile, (NX + kTile - 1) / kTile, B);
  if (static_cast<long long>(grid.x) * grid.y != n_partials)
    return static_cast<int>(cudaErrorInvalidValue);
  hinge_fwd_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(X), static_cast<const float*>(Y), static_cast<const float*>(cx),
      static_cast<const float*>(wx), static_cast<const float*>(cy), static_cast<const float*>(wy),
      static_cast<float*>(partials), NX, NY, C, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  hinge_reduce_kernel<<<B, kThreads, 0, s>>>(static_cast<const float*>(partials),
                                             static_cast<float*>(sums),
                                             static_cast<int>(grid.x * grid.y));
  return static_cast<int>(cudaGetLastError());
}

// Gradient of sum_b g[b] * S_pair[b] with respect to X: dX (B, NX, C). For
// dA pass (A, Bm) with A's coordinates and weights first; for dB pass
// (Bm, A) with Bm's first.
extern "C" int desc_loss_bwd_launch(const void* g, const void* X, const void* Y, const void* cx,
                                    const void* wx, const void* cy, const void* wy, void* dX,
                                    int B, int NX, int NY, int C, int lambda_d, int pos_margin,
                                    int neg_margin, int radius2, void* stream) {
  if (bad_shape(B, NX, NY, C) || C > kThreads) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const HingeParams p = {from_bits(lambda_d), from_bits(pos_margin), from_bits(neg_margin),
                         from_bits(radius2)};
  const dim3 grid((NX + kOwn - 1) / kOwn, B);
  hinge_bwd_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(g), static_cast<const float*>(X), static_cast<const float*>(Y),
      static_cast<const float*>(cx), static_cast<const float*>(wx), static_cast<const float*>(cy),
      static_cast<const float*>(wy), static_cast<float*>(dX), NX, NY, C, p);
  return static_cast<int>(cudaGetLastError());
}
