// Blockwise descriptor hinge loss over all raw x warped cell pairs:
// forward sums and the gradients dA, dB, on Hopper's TF32 tensor cores
// with float32-grade dots.
//
// Replaces spnerf_tpu/kernels/descriptor_loss_pallas.py: _hinge_sums_impl
// (the pallas_call at :180, _fwd_kernel; table row 10 at :172) and
// _hinge_bwd (:210; dA's pallas_call at :223, _bwd_da_kernel, and dB's at
// :247, _bwd_db_kernel). For one batch item with raw descriptors A (N, C),
// warped descriptors Bm (M, C), warped raw-cell centres (wy, wx),
// warped-image cell centres (cy, cx) and a cell mask over M:
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
// Bound on an H100 SXM: operations. At the training shape (batch 2, N = M
// = 1,200, C = 256) the forward's dot is 1.5 GFLOP against 5 MB of
// operands; each gradient recomputes the dot and multiplies ddot into an
// (N, C) product, 3 GFLOP. On the CUDA cores (67 TFLOP/s) that is 0.0226
// and 0.0444 ms. On the TF32 tensor cores (495 TFLOP/s) a float32-grade
// dot takes three passes (below) and a gradient product two: 0.0089 ms for
// the forward, 0.0149 for each gradient. Nothing of size N x M reaches
// device memory.
//
// Split TF32 (split and wgmma_tf32 in tf32_tc.cuh, which render.cu's
// float32 render shares). Each float32 operand x becomes hi =
// cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi) (x - hi is exact; the
// rounding is done with two integer operations, as the conversion
// instruction issues at a fraction of that rate): |lo| <= 2^-11 |x| and
// |x - hi - lo| <= 2^-22 |x|. A dot is
// hi.hi + hi.lo + lo.hi, each a wgmma m64nNk8 .f32.tf32.tf32 pass. The
// tensor cores form each product exactly but add into their float32
// accumulator truncating toward zero: per k8 step each of the 8 products
// and the running sum are cut to a multiple of 2^(e - 25), e the largest
// exponent among them, and the sum is rounded toward zero (the model of
// tests/_hinge_tc.py, which is the bf16 model of tests/_render_tc.py,
// fitted on an H100). So C is taken in chunks of 32 (4 k-steps): each
// chunk's hi.hi, lo.hi and hi.lo in fresh accumulators of their own (the
// small terms are cut at their own scale, not hi.hi's), and the CUDA cores
// add them and then the chunks, rounding to nearest, in chunk order.
//
// The bound delta. With P = sum_c |a_c b_c| <= ||a||_2 ||b||_2:
//   split:     the omitted lo.lo and the two rounding errors of lo,
//              <= 3.01 * 2^-22 P;
//   truncation: <= 13 * 2^-25 of the chunk's P per k-step (9 cut terms of
//              < 2^(e-25) each, and the rounding toward zero of a sum below
//              the chunk's P), 4 k-steps a chunk, the small accumulators'
//              at 2^-11 of that scale each: <= 52.2 * 2^-25 P;
//   adds:      two roundings to nearest forming a chunk, one per chunk
//              added, one where the gradient's halves meet: <= (n + 2) *
//              1.01 * 2^-24 P for n = ceil(C / 32) chunks.
// |dot - exact dot| <= delta = kappa(C) ||a||_2 ||b||_2, kappa(256) =
// 2.88e-6 (0.72e-6 + 1.56e-6 + 0.60e-6): about 48 float32 ulps of P, 4.7e-6
// at the training operands (||a|| ~ 1.28). A zero-padded k-step (C not a
// multiple of 8) adds zeros.
//
// Forward (row 10): the sums are continuous in the dot, and delta lies far
// below their 1e-5 relative tolerance, so they take the tensor cores' dot
// as it is. The step of the gradient is not continuous: a pair whose dot
// lies within the band 2 delta (twice the bound, for the tensor cores'
// model) of its margin (pos_margin where s, else neg_margin) sums its dot
// again over C in float64 (products of float32 values are exact there),
// and takes the step of that dot: the band's decisions are those of the
// exact dot, and outside it the tensor cores' dot is on the exact dot's
// side. The band holds some 1e-6 of the pairs at the training operands;
// the repairs are counted into an integer on the card.
//
// Design. The work is cut into units of (batch item, rows of X, 32 rows of
// Y); a block of two warpgroups takes a contiguous run of ceil(U / grid)
// or floor(U / grid) units, grid = the number of SMs (one block an SM:
// 200-220 KB of shared memory), so the card is full at any shape with as
// many units as SMs (1,444 gradient units for 132 SMs at N 1,200; 22,500
// at 4,800), within one unit of balance. The rows of X stay in shared
// memory while the run stays in their tile; Y's 32 rows arrive split, as
// the K-major B operand ([j][c], 8 x 4 core matrices), the next unit's
// loaded into registers while this unit computes. A operands come from
// registers: a thread's fragment of a k-step is one 16-byte load from X's
// tile kept in the order of the fragments.
//  - Forward (row 10): 128 rows of X a unit, 64 to each warpgroup, kept raw
//    and split per k-step (so each tile of Y is read once per 128 rows).
//    Each warpgroup sums its rows' 64 x 32 dots over all of C (wgmma
//    m64n32k8; hi.hi, lo.hi and hi.lo in three independent accumulators per
//    chunk), then the hinge, the mask and three sums per thread, a
//    fixed-order block reduction (shuffle tree, then the 8 warps in order)
//    into one partial per unit; a second kernel adds a batch item's
//    partials in a fixed order.
//  - Gradient (row 11, one launch per gradient: for dA pass (A, Bm), for dB
//    (Bm, A) with the sides' coordinates and weights exchanged): 64 rows of
//    X a unit, split once per tile. The warpgroups split C: each sums its
//    half of the chunks for all 32 columns as above, and the two halves meet
//    in shared memory. The step: a pair is in the band when (dot -
//    margin)^2 <= (2 kappa)^2 ||x||^2 ||y||^2 (squared norms rounded up, a
//    relative 2^-20 for the roundings). Each warpgroup writes its ddot into
//    shared memory as [i][j], split if any value of the unit's tile is not
//    a TF32 value (the kernel checks; with a 0/1 mask and lambda_d = 250
//    every ddot is exact and the lo pass is skipped). TF32 wgmma takes both
//    operands K-major, and K is j here, so the product runs transposed:
//    dX^T += Y^T ddot^T, A = Y^T from registers (read out of the [j][c]
//    tile: no second copy of Y), B = ddot's [i][j] tile, K-major in j. Each
//    warpgroup takes 128 of the C <= 256 columns of dX as two M-tiles
//    (wgmma m64n64k8), the small passes (Y_hi.ddot_lo, Y_lo.ddot_hi) first
//    into the unit's fresh accumulator, then Y_hi.ddot_hi: the small terms
//    are cut at their own scale, as if apart. The unit's sum is added to the
//    run's total to nearest; where the run leaves the tile of X, the total
//    goes to a partial slot of that tile. A second kernel adds a tile's
//    partials in the order of the blocks and multiplies by g.
// No float atomics anywhere: every sum has an order fixed by the shapes and
// the grid, so two launches give the same bits (on cards with another
// number of SMs the gradient's partials split elsewhere; the forward's do
// not).
//
// Edges: rows past N or M load zeros and carry weight 0 (the TPU version
// pads with 1e9 coordinates instead); C is read up to a multiple of 32 with
// zeros past it. s is a step function of d2, so d2 is computed with
// explicitly rounded multiplies and adds in the reference's order (nvcc
// would contract them into an FMA and flip pairs that lie on the radius).
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <cstring>

#include "conv_tc.cuh"
#include "tf32_tc.cuh"

namespace {

using spnerf::tc::fence_regs;
using spnerf::tc::smem_desc;
using spnerf::tc::smem_u32;
using spnerf::tc::wgmma_commit;
using spnerf::tc::wgmma_fence;
using spnerf::tc::wgmma_wait0;
using spnerf::tf32::split;
using spnerf::tf32::wgmma_tf32;

constexpr int kThreads = 256;  // two warpgroups
constexpr int kTI = 64;        // rows of X a gradient unit (wgmma M)
constexpr int kTIF = 128;      // rows of X a forward unit: 64 per warpgroup
constexpr int kTJ = 32;        // rows of Y a unit
constexpr int kCMax = 256;
constexpr int kChunk = 32;     // depth of one chunk of the dot's sums
constexpr int kSteps = kChunk / 8;
constexpr int kJSteps = kTJ / 8;  // k-steps of the gradient product a unit

// shared memory (bytes): X hi / lo in fragment order; Y hi / lo as [j][c];
// the warpgroups' exchange of their halves of the dot; (gradient only)
// ddot hi / lo as [i][j]; rows
constexpr int kXh = 0;
constexpr int kXl = kXh + kTI * kCMax * 4;
constexpr int kYh = kXl + kTI * kCMax * 4;
constexpr int kYl = kYh + kTJ * kCMax * 4;
constexpr int kXg = kYl + kTJ * kCMax * 4;
constexpr int kDh = kXg + kThreads * 8 * 4;
constexpr int kDl = kDh + kTI * kTJ * 4;
constexpr int kRowsGrad = kDl + kTI * kTJ * 4;
constexpr int kRowsFwd = kDh;  // the forward's raw X (kTIF rows) ends at kYh
// the rows' block: x (y, x, w, squared norm) 4 x 128 floats, y (y, x, w)
// 3 x 32, y's squared norm from each warpgroup 2 x 32, warp sums 8 x 3,
// counts
constexpr int kRowsBytes = (4 * kTIF + 3 * kTJ + 2 * kTJ + 8 * 3 + 4) * 4;
constexpr int smem_bytes(bool grad) { return (grad ? kRowsGrad : kRowsFwd) + kRowsBytes; }

// band2: (2 kappa(C))^2 (1 + 2^-20), the band's half-width squared over
// ||x||^2 ||y||^2
struct HingeParams {
  float lambda_d, pos_margin, neg_margin, radius2, band2;
};

// X (B, NX, C) against Y (B, NY, C); cx (NX, 2) per batch item at stride
// cxs floats (0: shared), wx (B, NX) or null (all 1); likewise cy, cys, wy
struct Operands {
  const float* __restrict__ X;
  const float* __restrict__ Y;
  const float* __restrict__ cx;
  const float* __restrict__ wx;
  const float* __restrict__ cy;
  const float* __restrict__ wy;
  int cxs, cys, B, NX, NY, C;
};

struct Rows {
  float *xy, *xx, *xw, *xsq, *yy, *yx, *yw, *ysq, *wsum;
  int* count;
  __device__ explicit Rows(char* p) {
    float* f = reinterpret_cast<float*>(p);
    xy = f, xx = f + kTIF, xw = f + 2 * kTIF, xsq = f + 3 * kTIF;
    yy = f + 4 * kTIF, yx = yy + kTJ, yw = yx + kTJ, ysq = yw + kTJ;
    wsum = ysq + 2 * kTJ;
    count = reinterpret_cast<int*>(wsum + 8 * 3);
  }
};

__device__ __forceinline__ bool near_cell(float ay, float ax, float by, float bx, float radius2) {
  const float dy = __fsub_rn(by, ay), dx = __fsub_rn(bx, ax);
  return __fadd_rn(__fmul_rn(dy, dy), __fmul_rn(dx, dx)) <= radius2;
}

template <int KS>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[KS][4]) {
#pragma unroll
  for (int k = 0; k < KS; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[k][i])::"memory");
}

// ROWS (64 or 128) rows of X from row0 of batch item b into shared memory
// in the order of the A fragments, each 64-row block as a warpgroup reads
// it: element (r, c) at word (r / 64) * 16384 + ((c / 8 * 4 + r % 64 / 16) *
// 32 + r % 8 * 4 + c % 4) * 4 + (r % 16) / 8 + 2 * (c % 8 / 4), so that a
// thread's fragment of one k-step is one 16-byte load. SPLIT (gradient)
// stores the split once into Xh and Xl; else (forward) the raw values at
// Xh. With the rows' coordinates, weights and (gradient) squared norms
// rounded up. A warp loads 8 whole rows at a time: lane = row % 8 + 8 *
// (float4 % 4), 64 bytes of a row per 4 lanes.
template <int ROWS, bool SPLIT>
__device__ __forceinline__ void load_x(const Operands& o, int b, int row0, char* smem,
                                       Rows& rows) {
  uint32_t* xh = reinterpret_cast<uint32_t*>(smem + kXh);
  uint32_t* xl = reinterpret_cast<uint32_t*>(smem + kXl);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, c4lo = lane / 8;
#pragma unroll 1
  for (int rep = 0; rep < ROWS / 64; ++rep) {
    const int r = 64 * rep + 8 * warp + lane % 8;
    const int row = row0 + r;
    const bool in = row < o.NX;
    const float* src = o.X + (static_cast<size_t>(b) * o.NX + (in ? row : 0)) * o.C;
    const int base = rep * 16384 + ((r % 64) / 16) * 32 * 4 + (r % 8) * 16 + (r % 16) / 8;
    double sq = 0.0;
#pragma unroll 4
    for (int q = 0; q < kCMax / 16; ++q) {
      const int c4 = 4 * q + c4lo;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (in && 4 * c4 < o.C) v = *reinterpret_cast<const float4*>(src + 4 * c4);
      const float e[4] = {v.x, v.y, v.z, v.w};
      const int at = base + (c4 / 2) * 512 + 2 * (c4 % 2);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (SPLIT) {
          sq = __fma_rn(static_cast<double>(e[t]), e[t], sq);
          split(e[t], xh[at + 4 * t], xl[at + 4 * t]);
        } else {
          xh[at + 4 * t] = __float_as_uint(e[t]);
        }
      }
    }
    if (SPLIT) {
      sq += __shfl_xor_sync(0xffffffffu, sq, 8);
      sq += __shfl_xor_sync(0xffffffffu, sq, 16);
      if (c4lo == 0) rows.xsq[r] = __double2float_ru(sq);
    }
  }
  if (threadIdx.x < ROWS) {
    const int t = threadIdx.x, rr = row0 + t;
    const bool ok = rr < o.NX;
    const float* c = o.cx + static_cast<size_t>(b) * o.cxs + 2 * static_cast<size_t>(ok ? rr : 0);
    rows.xy[t] = ok ? c[0] : 0.f;
    rows.xx[t] = ok ? c[1] : 0.f;
    rows.xw[t] = ok ? (o.wx ? o.wx[static_cast<size_t>(b) * o.NX + rr] : 1.f) : 0.f;
  }
}

// Y's 32 rows of one unit: this thread's row j = 8 * (warp % 4) + lane % 8
// and float4 columns 4 * (warpgroup + 2 q) + lane / 8, q < 8: 8 lanes of a
// quarter warp cover 8 rows of one column group (the 16-byte stores into
// the [j][c] core matrices land in 8 bank groups), 4 lanes 64 bytes of a
// row
struct YRows {
  float4 v[8];
};

__device__ __forceinline__ void fetch_y(YRows& p, const Operands& o, int b, int jt) {
  const int j = 8 * ((threadIdx.x / 32) % 4) + threadIdx.x % 8;
  const int c4lo = (threadIdx.x / 8) % 4, wg = threadIdx.x / 128;
  const int row = jt * kTJ + j;
  const bool in = row < o.NY;
  const float* src = o.Y + (static_cast<size_t>(b) * o.NY + (in ? row : 0)) * o.C;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int c = 4 * (4 * (wg + 2 * q) + c4lo);
    p.v[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (in && c < o.C) p.v[q] = *reinterpret_cast<const float4*>(src + c);
  }
}

// split into Yh / Yl as [j][c]: element (j, c) at byte ((c / 4) * 4 + j /
// 8) * 128 + (j % 8) * 16 + (c % 4) * 4 (K-major, LBO 512, SBO 128); the
// rows' coordinates and weights, and (gradient) each warpgroup's share of
// the squared norms
template <bool GRAD>
__device__ __forceinline__ void store_y(const YRows& p, const Operands& o, int b, int jt,
                                        char* smem, Rows& rows) {
  const int j = 8 * ((threadIdx.x / 32) % 4) + threadIdx.x % 8;
  const int c4lo = (threadIdx.x / 8) % 4, wg = threadIdx.x / 128;
  double sq = 0.0;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int c4 = 4 * (wg + 2 * q) + c4lo;
    const float v[4] = {p.v[q].x, p.v[q].y, p.v[q].z, p.v[q].w};
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      split(v[e], hi[e], lo[e]);
      if (GRAD) sq = __fma_rn(static_cast<double>(v[e]), v[e], sq);
    }
    const int off = (c4 * 4 + j / 8) * 128 + (j % 8) * 16;
    *reinterpret_cast<uint4*>(smem + kYh + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(smem + kYl + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
  if (GRAD) {
    sq += __shfl_xor_sync(0xffffffffu, sq, 8);
    sq += __shfl_xor_sync(0xffffffffu, sq, 16);
    if (c4lo == 0) rows.ysq[wg * kTJ + j] = __double2float_ru(sq);
  }
  if (threadIdx.x < kTJ) {
    const int t = threadIdx.x, rr = jt * kTJ + t;
    const bool ok = rr < o.NY;
    const float* c = o.cy + static_cast<size_t>(b) * o.cys + 2 * static_cast<size_t>(ok ? rr : 0);
    rows.yy[t] = ok ? c[0] : 0.f;
    rows.yx[t] = ok ? c[1] : 0.f;
    rows.yw[t] = ok ? (o.wy ? o.wy[static_cast<size_t>(b) * o.NY + rr] : 1.f) : 0.f;
  }
}

// The unit's 64 x 32 dot tile. Warpgroup wg sums its half of C's chunks
// (the first ceil(n / 2), or the rest) for all 32 columns: per chunk of 4
// k-steps, hi.hi, lo.hi and hi.lo each into a fresh accumulator (three
// independent chains), then chunk = big + (lo.hi + hi.lo) and the chunks
// in order, to nearest. The two halves meet in shared memory: each
// warpgroup keeps the 16 columns of its epilogue, 16 wg .. 16 wg + 15, and
// adds the other's half of them (a sum of two, the same either way round).
// Entry e of the thread: row 16 warp + g + 8 (e % 4 / 2), column 16 wg + 8
// (e / 4) + 2 t + e % 2. Ends with a block barrier.
__device__ __forceinline__ void dot_tile(float (&dot)[8], char* smem, int C) {
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const uint32_t* xh = reinterpret_cast<const uint32_t*>(smem + kXh) + (warp * 32 + lane) * 4;
  const uint32_t* xl = reinterpret_cast<const uint32_t*>(smem + kXl) + (warp * 32 + lane) * 4;
  const uint32_t yh = smem_u32(smem + kYh), yl = smem_u32(smem + kYl);
  const int n_chunks = (C + kChunk - 1) / kChunk, half = (n_chunks + 1) / 2;
  const int ch0 = wg * half, ch1 = min(n_chunks, ch0 + half);
  float tot[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) tot[i] = 0.f;
#pragma unroll 1
  for (int ch = ch0; ch < ch1; ++ch) {
    uint32_t hi[kSteps][4], lo[kSteps][4];
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int at = (ch * kSteps + s) * 4 * 32 * 4;
      const uint4 h = *reinterpret_cast<const uint4*>(xh + at);
      const uint4 l = *reinterpret_cast<const uint4*>(xl + at);
      hi[s][0] = h.x, hi[s][1] = h.y, hi[s][2] = h.z, hi[s][3] = h.w;
      lo[s][0] = l.x, lo[s][1] = l.y, lo[s][2] = l.z, lo[s][3] = l.w;
    }
    float big[16], lh[16], hl[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) big[i] = lh[i] = hl[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const uint32_t koff = (ch * kSteps + s) * 1024;
      wgmma_tf32<32>(lh, lo[s], smem_desc(yh + koff, 512, 128), s > 0);
      wgmma_tf32<32>(hl, hi[s], smem_desc(yl + koff, 512, 128), s > 0);
      wgmma_tf32<32>(big, hi[s], smem_desc(yh + koff, 512, 128), s > 0);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(big);
    fence_regs(lh);
    fence_regs(hl);
    fence_frags(hi);
    fence_frags(lo);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float c = __fadd_rn(big[i], __fadd_rn(lh[i], hl[i]));
      tot[i] = ch == ch0 ? c : __fadd_rn(tot[i], c);
    }
  }
  // columns 16 w .. 16 w + 15 are entries 8 w .. 8 w + 7 (selected, not
  // indexed: the accumulators stay in registers)
  float mine[8], give[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    mine[e] = wg == 0 ? tot[e] : tot[8 + e];
    give[e] = wg == 0 ? tot[8 + e] : tot[e];
  }
  float4* xg = reinterpret_cast<float4*>(smem + kXg);
  const int t = threadIdx.x % 128;
  xg[((1 - wg) * 128 + t) * 2] = make_float4(give[0], give[1], give[2], give[3]);
  xg[((1 - wg) * 128 + t) * 2 + 1] = make_float4(give[4], give[5], give[6], give[7]);
  __syncthreads();
  const float4 a = xg[(wg * 128 + t) * 2], b = xg[(wg * 128 + t) * 2 + 1];
  const float theirs[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
  for (int e = 0; e < 8; ++e) dot[e] = __fadd_rn(mine[e], theirs[e]);
}

// The forward's dot: warpgroup wg's own 64 rows of X (64 wg .. 64 wg + 63
// of the unit's 128, raw at Xh) against the unit's 32 rows of Y, over all
// of C, split per k-step: per chunk of 4 k-steps, hi.hi, lo.hi and hi.lo
// each into a fresh accumulator (three independent chains), then chunk =
// big + (lo.hi + hi.lo) and the chunks in order, to nearest. Entry 4 jn + q
// of the thread: row 64 wg + 16 warp + g + 8 (q / 2), column 8 jn + 2 t + q
// % 2.
__device__ __forceinline__ void dot_own(float (&tot)[16], const char* smem, int C) {
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const float* xr =
      reinterpret_cast<const float*>(smem + kXh) + wg * 16384 + (warp * 32 + lane) * 4;
  const uint32_t yh = smem_u32(smem + kYh), yl = smem_u32(smem + kYl);
  const int n_chunks = (C + kChunk - 1) / kChunk;
#pragma unroll 1
  for (int ch = 0; ch < n_chunks; ++ch) {
    uint32_t hi[kSteps][4], lo[kSteps][4];
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const float4 a = *reinterpret_cast<const float4*>(xr + (ch * kSteps + s) * 512);
      split(a.x, hi[s][0], lo[s][0]);
      split(a.y, hi[s][1], lo[s][1]);
      split(a.z, hi[s][2], lo[s][2]);
      split(a.w, hi[s][3], lo[s][3]);
    }
    float big[16], lh[16], hl[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) big[i] = lh[i] = hl[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const uint32_t koff = (ch * kSteps + s) * 1024;
      wgmma_tf32<32>(lh, lo[s], smem_desc(yh + koff, 512, 128), s > 0);
      wgmma_tf32<32>(hl, hi[s], smem_desc(yl + koff, 512, 128), s > 0);
      wgmma_tf32<32>(big, hi[s], smem_desc(yh + koff, 512, 128), s > 0);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(big);
    fence_regs(lh);
    fence_regs(hl);
    fence_frags(hi);
    fence_frags(lo);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float c = __fadd_rn(big[i], __fadd_rn(lh[i], hl[i]));
      tot[i] = ch == 0 ? c : __fadd_rn(tot[i], c);
    }
  }
}

__device__ __forceinline__ void entry_of(int e, int& r, int& j) {
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  r = 16 * warp + lane / 4 + 8 * ((e % 4) / 2);
  j = 16 * wg + 8 * (e / 4) + 2 * (lane % 4) + e % 2;
}

// units: (b, it, jt) in that order, jt fastest; U of them. Block c takes
// [c U / G, (c + 1) U / G); the block holding unit u is ((u + 1) G - 1) / U
__device__ __forceinline__ long long unit_start(long long c, long long U, long long G) {
  return c * U / G;
}
__host__ __device__ __forceinline__ long long block_of(long long u, long long U, long long G) {
  return ((u + 1) * G - 1) / U;
}

// Forward: units of (batch item, 128 rows of X, 32 rows of Y); partials
// (U, 3), one per unit; dots (B, NX, NY) of the tensor cores, or null (the
// tests' probe of delta)
__global__ void __launch_bounds__(kThreads, 1)
hinge_fwd_tc_kernel(Operands o, HingeParams p, float* __restrict__ partials,
                    float* __restrict__ dots) {
  extern __shared__ __align__(128) char smem[];
  Rows rows(smem + kRowsFwd);
  const int n_i = (o.NX + kTIF - 1) / kTIF, n_j = (o.NY + kTJ - 1) / kTJ;
  const long long U = static_cast<long long>(o.B) * n_i * n_j;
  const long long u0 = unit_start(blockIdx.x, U, gridDim.x);
  const long long u1 = unit_start(blockIdx.x + 1, U, gridDim.x);
  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  YRows pre;
  fetch_y(pre, o, static_cast<int>(u0 / n_j / n_i), static_cast<int>(u0 % n_j));
  long long cur = -1;
#pragma unroll 1
  for (long long u = u0; u < u1; ++u) {
    const long long T = u / n_j;
    const int jt = static_cast<int>(u % n_j), b = static_cast<int>(T / n_i);
    const int it = static_cast<int>(T % n_i);
    __syncthreads();  // the last unit is read out
    if (T != cur) {
      load_x<kTIF, false>(o, b, it * kTIF, smem, rows);
      cur = T;
    }
    store_y<false>(pre, o, b, jt, smem, rows);
    if (u + 1 < u1)
      fetch_y(pre, o, static_cast<int>((u + 1) / n_j / n_i), static_cast<int>((u + 1) % n_j));
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    float dot[16];
    dot_own(dot, smem, o.C);
    float s_pair = 0.f, s_pos = 0.f, s_neg = 0.f;
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int r = 64 * wg + 16 * (warp % 4) + lane / 4 + 8 * ((e % 4) / 2);
      const int j = 8 * (e / 4) + 2 * (lane % 4) + e % 2;
      const float w = __fmul_rn(rows.xw[r], rows.yw[j]);
      const bool s = near_cell(rows.xy[r], rows.xx[r], rows.yy[j], rows.yx[j], p.radius2);
      const float pos = s ? __fmul_rn(p.lambda_d, fmaxf(0.f, __fsub_rn(p.pos_margin, dot[e]))) : 0.f;
      const float neg = s ? 0.f : fmaxf(0.f, __fsub_rn(dot[e], p.neg_margin));
      s_pair = __fadd_rn(s_pair, __fmul_rn(w, __fadd_rn(pos, neg)));
      s_pos = __fadd_rn(s_pos, __fmul_rn(w, pos));
      s_neg = __fadd_rn(s_neg, __fmul_rn(w, neg));
      if (dots != nullptr) {
        const int row = it * kTIF + r, col = jt * kTJ + j;
        if (row < o.NX && col < o.NY)
          dots[(static_cast<size_t>(b) * o.NX + row) * o.NY + col] = dot[e];
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s_pair = __fadd_rn(s_pair, __shfl_xor_sync(0xffffffffu, s_pair, off));
      s_pos = __fadd_rn(s_pos, __shfl_xor_sync(0xffffffffu, s_pos, off));
      s_neg = __fadd_rn(s_neg, __shfl_xor_sync(0xffffffffu, s_neg, off));
    }
    if (lane == 0) {
      rows.wsum[3 * warp] = s_pair;
      rows.wsum[3 * warp + 1] = s_pos;
      rows.wsum[3 * warp + 2] = s_neg;
    }
    __syncthreads();
    if (threadIdx.x < 3) {
      float t = 0.f;
      for (int w = 0; w < kThreads / 32; ++w) t = __fadd_rn(t, rows.wsum[3 * w + threadIdx.x]);
      partials[u * 3 + threadIdx.x] = t;
    }
  }
}

// partials (B, n, 3) -> the three sums (B,) each: each thread adds its
// strided share in order, then a shared-memory tree; the order never
// depends on timing
__global__ void __launch_bounds__(kThreads)
hinge_reduce_kernel(const float* __restrict__ partials, float* __restrict__ s_pair,
                    float* __restrict__ s_pos, float* __restrict__ s_neg, long long n) {
  __shared__ float tree[kThreads][3];
  const float* src = partials + static_cast<size_t>(blockIdx.x) * n * 3;
  float t[3] = {0.f, 0.f, 0.f};
  for (long long i = threadIdx.x; i < n; i += kThreads)
    for (int q = 0; q < 3; ++q) t[q] += src[3 * i + q];
  for (int q = 0; q < 3; ++q) tree[threadIdx.x][q] = t[q];
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half)
      for (int q = 0; q < 3; ++q) tree[threadIdx.x][q] += tree[threadIdx.x + half][q];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    s_pair[blockIdx.x] = tree[0][0];
    s_pos[blockIdx.x] = tree[0][1];
    s_neg[blockIdx.x] = tree[0][2];
  }
}

// sum_c x_c y_c in float64 by the warp (lane c, c + 32, ...; a butterfly),
// for the pair of the lane src; every lane returns a sum
__device__ __forceinline__ double dot64(const float* __restrict__ x, const float* __restrict__ y,
                                        int C) {
  double acc = 0.0;
  for (int c = threadIdx.x % 32; c < C; c += 32)
    acc = __fma_rn(static_cast<double>(x[c]), static_cast<double>(y[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return acc;
}

// Gradient of sum_b g[b] S_pair[b] with respect to X: each block's run of
// units leaves one partial (64 x C) per tile of X it touches, at slot T *
// kmax + (block - first block of T)
__global__ void __launch_bounds__(kThreads, 1)
hinge_bwd_tc_kernel(Operands o, HingeParams p, float* __restrict__ partials, int kmax,
                    unsigned long long* __restrict__ repaired) {
  extern __shared__ __align__(128) char smem[];
  Rows rows(smem + kRowsGrad);
  const int n_i = (o.NX + kTI - 1) / kTI, n_j = (o.NY + kTJ - 1) / kTJ;
  const long long U = static_cast<long long>(o.B) * n_i * n_j;
  const long long G = gridDim.x;
  const long long u0 = unit_start(blockIdx.x, U, G), u1 = unit_start(blockIdx.x + 1, U, G);
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) *rows.count = 0;
  int my_repairs = 0;
  YRows pre;
  fetch_y(pre, o, static_cast<int>(u0 / n_j / n_i), static_cast<int>(u0 % n_j));
  float total[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) total[i] = 0.f;
  long long cur = -1;
#pragma unroll 1
  for (long long u = u0; u < u1; ++u) {
    const long long T = u / n_j;
    const int jt = static_cast<int>(u % n_j), b = static_cast<int>(T / n_i);
    const int it = static_cast<int>(T % n_i);
    __syncthreads();  // the last unit is read out
    if (T != cur) {
      load_x<kTI, true>(o, b, it * kTI, smem, rows);
      cur = T;
    }
    store_y<true>(pre, o, b, jt, smem, rows);
    if (u + 1 < u1)
      fetch_y(pre, o, static_cast<int>((u + 1) / n_j / n_i), static_cast<int>((u + 1) % n_j));
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    float dot[8];
    dot_tile(dot, smem, o.C);

    // the step, with the band's pairs summed again in float64
    float w[8], margin[8];
    bool near[8];
    unsigned band = 0u;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      int r, j;
      entry_of(e, r, j);
      w[e] = __fmul_rn(rows.xw[r], rows.yw[j]);
      near[e] = near_cell(rows.xy[r], rows.xx[r], rows.yy[j], rows.yx[j], p.radius2);
      margin[e] = near[e] ? p.pos_margin : p.neg_margin;
      // |dot - margin| <= band ||x|| ||y||, squared: the squared norms are
      // rounded up and band2 holds a relative 2^-20 for these roundings
      const float d = __fsub_rn(dot[e], margin[e]);
      const float ysq = __fadd_ru(rows.ysq[j], rows.ysq[kTJ + j]);
      if (w[e] != 0.f && __fmul_rn(d, d) <= __fmul_ru(__fmul_ru(p.band2, rows.xsq[r]), ysq))
        band |= 1u << e;
    }
    double exact[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) exact[e] = 0.0;
    if (__any_sync(0xffffffffu, band != 0u)) {  // rare: most warps skip it
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        unsigned todo = __ballot_sync(0xffffffffu, (band >> e) & 1u);
        while (todo) {
          const int src = __ffs(todo) - 1;
          todo &= todo - 1;
          const int r = 16 * warp + src / 4 + 8 * ((e % 4) / 2);
          const int j = 16 * wg + 8 * (e / 4) + 2 * (src % 4) + e % 2;
          const float* xr = o.X + (static_cast<size_t>(b) * o.NX + it * kTI + r) * o.C;
          const float* yr = o.Y + (static_cast<size_t>(b) * o.NY + jt * kTJ + j) * o.C;
          const double v = dot64(xr, yr, o.C);
          if (lane == src) exact[e] = v;
        }
      }
    }
    bool frac = false;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      int r, j;
      entry_of(e, r, j);
      const bool rep = (band >> e) & 1u;
      my_repairs += rep;
      const bool below = rep ? exact[e] < static_cast<double>(margin[e]) : dot[e] < margin[e];
      const bool above = rep ? exact[e] > static_cast<double>(margin[e]) : dot[e] > margin[e];
      const float step = near[e] ? (below ? -p.lambda_d : 0.f) : (above ? 1.f : 0.f);
      uint32_t hi, lo;
      split(__fmul_rn(w[e], step), hi, lo);
      frac |= lo != 0u;
      // ddot as the K-major A operand: byte ((j / 4) * 8 + r / 8) * 128 +
      // (r % 8) * 16 + (j % 4) * 4 (LBO 1024, SBO 128)
      const int off = ((j / 4) * 8 + r / 8) * 128 + (r % 8) * 16 + (j % 4) * 4;
      *reinterpret_cast<uint32_t*>(smem + kDh + off) = hi;
      *reinterpret_cast<uint32_t*>(smem + kDl + off) = lo;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const bool split_ddot = __syncthreads_or(frac);

    // dX^T (C x 64) += Y^T ddot^T over the unit's 32 rows of Y: warpgroup
    // wg takes columns 128 wg + 64 mt .. + 63 of dX as the M-tiles mt < 2,
    // A = Y^T from registers (its [j][c] tile read as (c, j)), B = ddot^T
    // (the [i][j] tile is K-major in j), the small passes first into a fresh
    // accumulator
    const uint32_t dh = smem_u32(smem + kDh), dl = smem_u32(smem + kDl);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int c0 = 128 * wg + 64 * mt;
      if (c0 >= o.C) break;
      uint32_t yh[kJSteps][4], yl[kJSteps][4];
#pragma unroll
      for (int s = 0; s < kJSteps; ++s) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int c = c0 + 16 * warp + lane / 4 + 8 * (q % 2), j = 8 * s + lane % 4 + 4 * (q / 2);
          const int off = ((c / 4) * 4 + j / 8) * 128 + (j % 8) * 16 + (c % 4) * 4;
          yh[s][q] = *reinterpret_cast<const uint32_t*>(smem + kYh + off);
          yl[s][q] = *reinterpret_cast<const uint32_t*>(smem + kYl + off);
        }
      }
      float acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      wgmma_fence();
      if (split_ddot) {
#pragma unroll
        for (int s = 0; s < kJSteps; ++s)
          wgmma_tf32<64>(acc, yh[s], smem_desc(dl + 2048 * s, 1024, 128), s > 0);
      }
#pragma unroll
      for (int s = 0; s < kJSteps; ++s)
        wgmma_tf32<64>(acc, yl[s], smem_desc(dh + 2048 * s, 1024, 128), split_ddot || s > 0);
#pragma unroll
      for (int s = 0; s < kJSteps; ++s)
        wgmma_tf32<64>(acc, yh[s], smem_desc(dh + 2048 * s, 1024, 128), 1);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(acc);
      fence_frags(yh);
      fence_frags(yl);
#pragma unroll
      for (int i = 0; i < 32; ++i) total[32 * mt + i] = __fadd_rn(total[32 * mt + i], acc[i]);
    }

    // the run leaves this tile of X: its total to the tile's slot; entry
    // 32 mt + 4 jn + 2 h + e is dX's row 8 jn + 2 t + e, column c0 + 16 warp
    // + g + 8 h
    if (u + 1 == u1 || (u + 1) / n_j != T) {
      const long long first = block_of(T * n_j, U, G);
      float* dst = partials + (static_cast<size_t>(T) * kmax + (blockIdx.x - first)) * kTI * o.C;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = 128 * wg + 64 * mt + 16 * warp + lane / 4 + 8 * h;
          if (c < o.C) {
#pragma unroll
            for (int jn = 0; jn < 8; ++jn)
#pragma unroll
              for (int e = 0; e < 2; ++e)
                dst[static_cast<size_t>(8 * jn + 2 * (lane % 4) + e) * o.C + c] =
                    total[32 * mt + 4 * jn + 2 * h + e];
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) total[i] = 0.f;
    }
  }
  if (repaired != nullptr) {
    if (my_repairs) atomicAdd(rows.count, my_repairs);
    __syncthreads();
    if (threadIdx.x == 0 && *rows.count)
      atomicAdd(repaired, static_cast<unsigned long long>(*rows.count));
  }
}

// dX (B, NX, C) = g[b] * the partials of each tile of X, added in the
// order of the blocks that wrote them
__global__ void __launch_bounds__(kThreads)
hinge_bwd_reduce_kernel(const float* __restrict__ g, const float* __restrict__ partials,
                        float* __restrict__ dX, int NX, int C, int n_i, int n_j, long long U,
                        long long G, int kmax) {
  const long long T = blockIdx.y;
  const int b = static_cast<int>(T / n_i), it = static_cast<int>(T % n_i);
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  const int r = idx / (C / 4), c = 4 * (idx % (C / 4));
  const int row = it * kTI + r;
  if (r >= kTI || row >= NX) return;
  const long long first = block_of(T * n_j, U, G), last = block_of((T + 1) * n_j - 1, U, G);
  const float* src = partials + (static_cast<size_t>(T) * kmax * kTI + r) * C + c;
  float4 sum = *reinterpret_cast<const float4*>(src);
  for (long long k = 1; k <= last - first; ++k) {
    const float4 v = *reinterpret_cast<const float4*>(src + k * kTI * C);
    sum.x = __fadd_rn(sum.x, v.x);
    sum.y = __fadd_rn(sum.y, v.y);
    sum.z = __fadd_rn(sum.z, v.z);
    sum.w = __fadd_rn(sum.w, v.w);
  }
  const float gb = g[b];
  *reinterpret_cast<float4*>(dX + (static_cast<size_t>(b) * NX + row) * C + c) =
      make_float4(__fmul_rn(gb, sum.x), __fmul_rn(gb, sum.y), __fmul_rn(gb, sum.z),
                  __fmul_rn(gb, sum.w));
}

bool bad_shape(int B, int NX, int NY, int C) {
  return B <= 0 || NX <= 0 || NY <= 0 || C <= 0 || C % 4 != 0 || C > kCMax;
}

float from_bits(int bits) {
  float v;
  memcpy(&v, &bits, sizeof v);
  return v;
}

// kappa(C) of the header: |dot - exact| <= kappa ||a|| ||b||
float kappa(int C) {
  const int n_chunks = (C + kChunk - 1) / kChunk;
  return static_cast<float>(3.01 * std::ldexp(1.0, -22) + 52.2 * std::ldexp(1.0, -25) +
                            (n_chunks + 2) * 1.01 * std::ldexp(1.0, -24));
}

HingeParams params(int lambda_d, int pos_margin, int neg_margin, int radius2, int C) {
  const double band = 2.0 * kappa(C);
  return {from_bits(lambda_d), from_bits(pos_margin), from_bits(neg_margin), from_bits(radius2),
          static_cast<float>(band * band * (1.0 + std::ldexp(1.0, -20)))};
}

// SMs of the current device (the grid), and the kernels' shared memory
// limit raised once per device
int sm_count() {
  static int counts[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (counts[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
    if (cudaFuncSetAttribute(hinge_fwd_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes(false)) != cudaSuccess ||
        cudaFuncSetAttribute(hinge_bwd_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes(true)) != cudaSuccess)
      return 0;
    counts[dev] = n;
  }
  return counts[dev];
}

struct Plan {
  int n_i, n_j;
  long long U, G;
  int kmax;  // most blocks that touch one tile of X (gradient)
};

// ROWS: the rows of X a unit (kTIF forward, kTI gradient)
Plan plan(int B, int NX, int NY, int ROWS) {
  Plan pl;
  pl.n_i = (NX + ROWS - 1) / ROWS;
  pl.n_j = (NY + kTJ - 1) / kTJ;
  pl.U = static_cast<long long>(B) * pl.n_i * pl.n_j;
  const int sms = sm_count();
  pl.G = sms < pl.U ? sms : pl.U;
  pl.kmax = 0;
  if (pl.G <= 0) return pl;
  for (long long T = 0; T < static_cast<long long>(B) * pl.n_i; ++T) {
    const long long k = block_of((T + 1) * pl.n_j - 1, pl.U, pl.G) -
                        block_of(T * pl.n_j, pl.U, pl.G) + 1;
    if (k > pl.kmax) pl.kmax = static_cast<int>(k);
  }
  return pl;
}

Operands operands(const void* X, const void* Y, const void* cx, int cxs, const void* wx,
                  const void* cy, int cys, const void* wy, int B, int NX, int NY, int C) {
  return {static_cast<const float*>(X),  static_cast<const float*>(Y),
          static_cast<const float*>(cx), static_cast<const float*>(wx),
          static_cast<const float*>(cy), static_cast<const float*>(wy),
          cxs, cys, B, NX, NY, C};
}

}  // namespace

// Scratch sizes for the launches below, in floats: [0] the forward's
// partials (B * ceil(NX / 128) * ceil(NY / 32) * 3), [1] the gradient's
// (the tiles of X times the most blocks on one tile, times 64 * C). Returns
// a CUDA error code.
extern "C" int desc_loss_scratch(int B, int NX, int NY, int C, long long* floats) {
  if (bad_shape(B, NX, NY, C)) return static_cast<int>(cudaErrorInvalidValue);
  const Plan fwd = plan(B, NX, NY, kTIF), grad = plan(B, NX, NY, kTI);
  if (fwd.G <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  floats[0] = fwd.U * 3;
  floats[1] = static_cast<long long>(B) * grad.n_i * grad.kmax * kTI * C;
  if (floats[0] > INT32_MAX || floats[1] > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

// Forward sums. X (B, NX, C), Y (B, NY, C), float32; cx, cy the rows'
// cell centres ((NX, 2) at batch stride cxs floats; 0 shares them), wx
// (B, NX) and wy (B, NY) the weights or null (all 1); partials: scratch of
// desc_loss_scratch's [0] floats (n_partials); the sums (B,) each; dots:
// null, or (B, NX, NY) for the tensor cores' dots. lambda_d, the two
// margins and radius^2 arrive as float32 bit patterns (the binding passes
// pointers and ints only).
extern "C" int desc_loss_fwd_launch(const void* X, const void* Y, const void* cx, int cxs,
                                    const void* wx, const void* cy, int cys, const void* wy,
                                    void* partials, int n_partials, void* s_pair,
                                    void* s_pos, void* s_neg, void* dots, int B, int NX, int NY,
                                    int C, int lambda_d, int pos_margin, int neg_margin,
                                    int radius2, void* stream) {
  if (bad_shape(B, NX, NY, C)) return static_cast<int>(cudaErrorInvalidValue);
  const Plan pl = plan(B, NX, NY, kTIF);
  if (pl.G <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  if (n_partials < pl.U * 3) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  hinge_fwd_tc_kernel<<<static_cast<int>(pl.G), kThreads, smem_bytes(false), s>>>(
      operands(X, Y, cx, cxs, wx, cy, cys, wy, B, NX, NY, C),
      params(lambda_d, pos_margin, neg_margin, radius2, C), static_cast<float*>(partials),
      static_cast<float*>(dots));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  hinge_reduce_kernel<<<B, kThreads, 0, s>>>(
      static_cast<const float*>(partials), static_cast<float*>(s_pair),
      static_cast<float*>(s_pos), static_cast<float*>(s_neg),
      static_cast<long long>(pl.n_i) * pl.n_j);
  return static_cast<int>(cudaGetLastError());
}

// Gradient of sum_b g[b] * S_pair[b] with respect to X: dX (B, NX, C).
// For dA pass (A, Bm) with A's coordinates and weights first; for dB pass
// (Bm, A) with Bm's first. partials: scratch of desc_loss_scratch's [1]
// floats; repaired: null, or an integer the band's repairs are added to.
extern "C" int desc_loss_bwd_launch(const void* g, const void* X, const void* Y, const void* cx,
                                    int cxs, const void* wx, const void* cy, int cys,
                                    const void* wy, void* dX, void* partials, int n_partials,
                                    void* repaired, int B, int NX, int NY,
                                    int C, int lambda_d, int pos_margin, int neg_margin,
                                    int radius2, void* stream) {
  if (bad_shape(B, NX, NY, C)) return static_cast<int>(cudaErrorInvalidValue);
  const Plan pl = plan(B, NX, NY, kTI);
  if (pl.G <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const long long need = static_cast<long long>(B) * pl.n_i * pl.kmax * kTI * C;
  if (n_partials < need || static_cast<long long>(B) * pl.n_i > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  hinge_bwd_tc_kernel<<<static_cast<int>(pl.G), kThreads, smem_bytes(true), s>>>(
      operands(X, Y, cx, cxs, wx, cy, cys, wy, B, NX, NY, C),
      params(lambda_d, pos_margin, neg_margin, radius2, C), static_cast<float*>(partials),
      pl.kmax, static_cast<unsigned long long*>(repaired));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((kTI * C / 4 + kThreads - 1) / kThreads, B * pl.n_i);
  hinge_bwd_reduce_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(g), static_cast<const float*>(partials), static_cast<float*>(dX),
      NX, C, pl.n_i, pl.n_j, pl.U, pl.G, pl.kmax);
  return static_cast<int>(cudaGetLastError());
}
