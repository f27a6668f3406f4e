// Fused volume render of the tiny NeRF field: per ray, for every sample,
// sin(oe + t_s * de) -> relu(. @ w1) -> relu(. @ w2 + df) -> . @ w3 ->
// alpha compositing of rgb and depth. One launch renders all rays; the
// activations of a ray never leave the SM.
//
// Replaces the three kernels of spnerf_tpu/kernels/render_pallas.py:
// render_fused (float32 or bf16 operands, width 128), _render_fused_int8
// (int8 operands) and render_fused_packed (widths 64 and 32). The TPU
// kernels pad every tensor to 128 lanes, pack narrow fields block-
// diagonally, read sigma with selector matmuls and turn the compositing
// recurrence into triangular matmuls, all for the MXU. Here three kernels
// serve them, all on the tensor cores: render_tc_kernel the bf16 operands
// of every width, render_s8_kernel the int8 one and render_f32_kernel the
// float32 ones (each product as three TF32 passes); the head is the
// (W, 4) product that holds sigma and rgb, and the outputs are (N, 3) and
// (N,).
//
// Bound on an H100 SXM: operations. A render of 131,072 rays x 32 samples
// at width 128 needs 2 * (2 * 128^2 + 4 * 128) multiply-adds per sample,
// 279 GFLOP, against 201 MB of rays in and 2 MB out: 0.28 ms at the bf16
// tensor-core rate against 0.06 ms of memory time. Beside the products
// stand 537 M sines (one per ray, sample and lane), some 25 CUDA-core
// instructions each, which no tensor core takes: they and the repair of
// undecided sums (below), not the products, set the pace of
// render_tc_kernel. The int8 render's products take 0.14 ms at the int8
// rate; its sines and its two requantizing epilogues (some 8 instructions
// a hidden value) set its pace. The float32 render's products are three
// TF32 passes: 837.5 GFLOP at the TF32 rate, 1.69 ms, against 4.17 ms for
// the 279 GFLOP on the float32 CUDA cores; beside them the sines, the
// splits (some 4 instructions a value) and, at width 128, the making of
// lo(w2) per M-tile (below).
//
// render_tc_kernel (bf16). A block of four warpgroups stays on its SM and
// walks tiles of 8192 / W consecutive rays (64, 128 or 256), all four on
// one tile, which votes on each chunk. w1, w2 and w3 sit in shared memory
// for the block's life, packed K-major in 8 x 8 core matrices, as the B
// operands of wgmma (no swizzle); w3's four columns at n = 0, 2, 4, 6 of
// an n8 tile. A warpgroup owns groups of the tile's rays; one M-tile of
// 64 rows is its group at consecutive samples (TcTile: 16 rays x 4
// samples at width 128, 32 x 2 at 64 and 32; at width 32 a warpgroup
// computes its two groups together, so that one repair serves both
// M-tiles). A thread (lane 4 g + t4)
// holds rows g and g + 8, one ray at two samples, so it needs that ray's
// oe and de at its fragment columns 16 ks + 2 t4 + {0, 1, 8, 9} only: the
// block stages the tile's oe and de in shared memory, each row permuted
// so that those are one float4 per k-step, and prefetches the next tile's
// oe, de and df into L2 (in registers instead, they would leave four
// warpgroups no room at width 128); df is read where it is added.
// It writes the sines straight into the m64k16 A fragments and, since an
// m64nN float32 accumulator has the layout of those fragments, turns each
// layer's sums into the next layer's A operand in registers (ReLU and the
// rounding to bf16 in one cvt.rn.relu.bf16x2). The layers run as wgmma
// m64n64k16 (m64n32k16 at width 32) from registers, the head as m64n8k16.
// Each lane of a ray forms one part of its two samples' head (alpha or one
// sigmoid: lane t4 holds head column t4), the lanes trade the parts by
// shuffles and each composites the ray's samples in order. Where a sum
// could round otherwise in the library's order, the warpgroup sums it
// again in that order (the repair, below): the only trips of activations
// through shared memory and the only barriers between the samples.
// 128 registers a thread; 0 bytes of stack at width 64, 16 at 128 and 32
// (at 128 the tile and chunk counters, stored and loaded once a chunk).
//
// render_f32_kernel (float32): the same frame on wgmma m64nNk8 .tf32, see
// "float32 on the TF32 tensor cores" below for its layout, its shared
// memory at width 128 and its numerics.
//
// Skipping. A flag covers `block` consecutive rays and `chunk` samples; a
// ray composites a chunk only if its own flag is set, whatever tile it is
// in. The early stop works on the tile: a chunk is computed only if some
// ray of the tile whose flag is set still has transmittance above eps (for
// the packed variant: optical depth below -log eps); the first chunk always
// is. Rays past N are not written (nor read, but by the float32 kernel,
// which reads the last ray's operands for them).
//
// Numerics follow the reference's order with explicitly rounded float32
// operations (nvcc would contract a * b + c into an FMA, which moves the
// sine's argument by up to one ulp, 8e-3 rad at the top frequency):
// t_s = near + (s + jitter) * dt, the argument oe + t_s * de, and the sine
// of it by `sine` (render_common.cuh), CUDA's sinf to the bit. The encoding and both
// hidden activations are rounded to the operand type before each product;
// the packed variant also rounds the head, and takes its weights from the
// telescoped form exp(-tau) - exp(-(tau + sigma dt)) with tau split into a
// carried part and the chunk's prefix, as the reference's triangular
// matmul does. bf16 products are exact; wgmma sums them in its own
// order, and where that order and the library's float32 FMAs in k order
// could round a hidden activation (or the packed head) to different bf16
// values, the kernel sums that element again by FMAs in k order (see
// "the library's order where it decides a rounding" below); the float32
// kernel rounds nothing and sums each product as split TF32 passes, within
// a few float32 ulps of the library's sums.
// int8: round half to even (rintf's rounding, by adding 1.5 * 2^23), clip
// before the round, acc * m2 + df * ia2 as two rounded products and a
// rounded sum; int32 sums are exact in any order. No --use_fast_math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "conv_tc_s8.cuh"
#include "render_common.cuh"
#include "tf32_tc.cuh"

namespace {

using spnerf::render::bf16x2;
using spnerf::render::bf16x2_relu;
using spnerf::render::kSineBig;
using spnerf::render::pack4;
using spnerf::render::sine;
using spnerf::render::sine_fast;
using spnerf::render::stage_weights;
using spnerf::render::wgmma_bf16;
using spnerf::render::wgmma_s8_rs;
using spnerf::tc::fence_regs;
using spnerf::tc::s8_cast_bits;
using spnerf::tc::smem_desc;
using spnerf::tc::smem_u32;
using spnerf::tc::wgmma_commit;
using spnerf::tc::wgmma_fence;
using spnerf::tc::wgmma_wait0;

constexpr int kTileElems = 8192;  // rays of a tile x width

// ---- shared by the three kernels ----

__device__ __forceinline__ float sample_t(int s, float jitter, float near, float dt) {
  return __fadd_rn(near, __fmul_rn(__fadd_rn(static_cast<float>(s), jitter), dt));
}

// whether ray's flag for chunk ci is set
__device__ __forceinline__ bool flag_set(const int* flags, int ray, int block, int n_chunks,
                                         int ci) {
  return flags == nullptr || flags[(ray / block) * n_chunks + ci] != 0;
}

// Compositing state of one ray. PACKED takes the weights from the
// telescoped exponentials, else from the alpha recurrence.
template <bool PACKED>
struct Composite {
  float rgb[3] = {0.f, 0.f, 0.f};
  float depth = 0.f;
  float trans = 1.f;  // !PACKED
  float tau = 0.f;    // PACKED: optical depth at the chunk's start
  float csum = 0.f;   // PACKED: optical depth within the chunk

  __device__ __forceinline__ bool open(float cut) const {
    return PACKED ? tau < cut : trans > cut;
  }

  // The per-sample transforms of a head, which need no carried state:
  // part k of head value v, k 0 alpha (PACKED: exp(-sigma dt)) from sigma,
  // k 1-3 the sigmoid of an rgb logit. The same instructions for every k
  // (one exp, one division), so that lanes forming different parts do not
  // diverge.
  __device__ __forceinline__ static float part(float v, int k, float dt) {
    const float arg = PACKED ? -sigma_dt(v, dt) : __fmul_rn(-fmaxf(v, 0.f), dt);
    const float e = expf(k == 0 ? arg : -v);
    const float sig = __fdiv_rn(1.f, __fadd_rn(1.f, e));
    return k > 0 ? sig : PACKED ? e : __fsub_rn(1.f, e);
  }
  __device__ __forceinline__ static float sigma_dt(float h0, float dt) {
    return __fmul_rn(fmaxf(h0, 0.f), dt);
  }

  // composite one sample from its parts (p[0] alpha or exp(-sigma dt),
  // p[1..3] the sigmoids) and, PACKED, its sigma dt
  __device__ __forceinline__ void add_parts(const float p[4], float sig, float t_s) {
    float w;
    if constexpr (PACKED) {
      const float e1 = expf(-__fadd_rn(csum, tau));
      w = __fsub_rn(e1, __fmul_rn(e1, p[0]));
      csum = __fadd_rn(csum, sig);
    } else {
      w = __fmul_rn(trans, p[0]);
      trans = __fmul_rn(trans, __fsub_rn(1.f, p[0]));
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) rgb[c] = __fadd_rn(rgb[c], __fmul_rn(w, p[1 + c]));
    depth = __fadd_rn(depth, __fmul_rn(w, t_s));
  }

  __device__ __forceinline__ void add(const float head[4], float t_s, float dt) {
    const float p[4] = {part(head[0], 0, dt), part(head[1], 1, dt), part(head[2], 2, dt),
                        part(head[3], 3, dt)};
    add_parts(p, PACKED ? sigma_dt(head[0], dt) : 0.f, t_s);
  }

  __device__ __forceinline__ void end_chunk() {
    if constexpr (PACKED) {
      tau = __fadd_rn(tau, csum);
      csum = 0.f;
    }
  }

  __device__ __forceinline__ void store(float* rgb_out, float* depth_out, int ray) const {
    rgb_out[static_cast<size_t>(ray) * 3 + 0] = rgb[0];
    rgb_out[static_cast<size_t>(ray) * 3 + 1] = rgb[1];
    rgb_out[static_cast<size_t>(ray) * 3 + 2] = rgb[2];
    depth_out[ray] = depth;
  }
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// ---- bf16 on the tensor cores ----

constexpr int kWG = 128;  // threads of a warpgroup
constexpr int kNWG = 4;   // warpgroups of a block, all on one tile

// An M-tile of 64 rows is RPM rays at SPR consecutive samples: row
// 16 w + r of warp w is ray group_ray(w, r % 8) of the warpgroup's group
// at sample s + row_sample(r % 8, r / 8). Width 128 takes 16 rays x 4
// samples (4 groups a tile, one a warpgroup), widths 64 and 32 take 32
// rays x 2 samples.
template <int W>
struct TcTile {
  static constexpr int TR = kTileElems / W;              // rays of a tile
  static constexpr int SPR = W == 128 ? 4 : 2;           // samples of a ray in an M-tile
  static constexpr int RPM = 64 / SPR;                   // rays of an M-tile (a group)
  static constexpr int G = TR / (RPM * kNWG);            // groups of a warpgroup
  // M-tiles a warpgroup computes together (its two groups at width 32: the
  // repairs of both in one)
  static constexpr int MT = W == 32 ? 2 : 1;
  static constexpr int RS = W + 16;                      // row stride of a staged array
  static constexpr int KS = W / 16;                      // k-steps of a layer
  static constexpr int NP = W < 64 ? W : 64;             // columns of one wgmma
  static constexpr int PIECES = W / NP;
  static constexpr uint32_t SBO = W * 16;                // bytes between N-adjacent core matrices
  static constexpr int WBYTES = (2 * W * W + W * 8) * 2;  // w1, w2 and w3 (8 columns), bf16
  static constexpr int CSN = 2 * W + 8;                  // column bounds of w1, w2, w3
  // + the tile's oe and de and the column bounds (then each warpgroup's
  // repair space, Repair<W>)
  static constexpr int SMEM = WBYTES + (2 * TR * RS + CSN) * 4;

  __device__ static int group_ray(int warp, int g) {
    return SPR == 2 ? 8 * warp + g : 4 * warp + (g & 3);
  }
  // sample offset of row g (h 0) or g + 8 (h 1) of a warp
  __device__ static int row_sample(int g, int h) { return SPR == 2 ? h : 2 * h + (g >> 2); }
};

// the product of KS k-steps from a into d, B's first k-step at b
template <int N, int KS>
__device__ __forceinline__ void wgmma_chain(float (&d)[N / 2], const uint32_t (*a)[4],
                                            uint32_t b, uint32_t sbo) {
  wgmma_bf16<N, false>(d, a[0], smem_desc(b, 128, sbo));
#pragma unroll
  for (int ks = 1; ks < KS; ++ks) wgmma_bf16<N, true>(d, a[ks], smem_desc(b + ks * 256, 128, sbo));
}

// v, as a value the compiler must compute here: keeps loop-invariant
// addresses and indices out of registers that live across the loops
__device__ __forceinline__ int opaque(int v) {
  asm volatile("" : "+r"(v));
  return v;
}

// keep A fragments in place until the wgmma that reads them is done
template <int KS>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[KS][4]) {
#pragma unroll
  for (int k = 0; k < KS; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[k][i])::"memory");
}

// The encoding of a thread's two rows (one ray at t0 and t1) as the A
// fragments of layer 1: ops(ks) gives the ray's oe and de at columns
// 16 ks + 2 t4 + {0, 1, 8, 9}; register 2 e + h of k-step ks is row g + 8 h
// (time t_h) at columns 16 ks + 8 e + 2 t4 + {0, 1}.
template <int KS, typename Ops>
__device__ __forceinline__ void encode(Ops ops, float t0, float t1, uint32_t (&a)[KS][4]) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    float4 o, d;
    asm volatile("" ::: "memory");  // one k-step's operands at a time
    ops(ks, o, d);
    const float ov[4] = {o.x, o.y, o.z, o.w}, dv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 2 * e;
      a[ks][c] = bf16x2(sine(__fadd_rn(ov[c], __fmul_rn(t0, dv[c]))),
                        sine(__fadd_rn(ov[c + 1], __fmul_rn(t0, dv[c + 1]))));
      a[ks][c + 1] = bf16x2(sine(__fadd_rn(ov[c], __fmul_rn(t1, dv[c]))),
                            sine(__fadd_rn(ov[c + 1], __fmul_rn(t1, dv[c + 1]))));
    }
  }
}

// ---- the library's order where it decides a rounding ----
//
// wgmma sums in another order than the float32 FMAs in k order of the
// plain version (torch.matmul: cuBLAS takes that order at these shapes).
// The two sums differ by a few units of 2^-24 * sum_k |a_k b_k|, and where
// that puts them on two sides of a bf16 rounding boundary, one hidden
// activation moves by an ulp, which through the committed fields moves
// rgb by up to 8e-4. So each sum v is tested against a bound
// t = kSlack * max_k |a_k| * sum_k |b_k| (>= 8 such units): if v - t and
// v + t round (with the layer's relu) to different bf16 values, the
// element is undecided and is summed again by FMAs in k order on the CUDA
// cores. Elsewhere both orders round alike. On the committed fields the
// orders lie at most about 3 units apart and a few percent of the elements
// are undecided (tests/test_torch_render_tc.py). The dense head is not
// rounded and needs no repair.
//
// The undecided elements of a warpgroup's M-tile are summed together, one
// a thread (repair): each warp counts its own and takes a range of the
// warpgroup's queue by one shared atomic, writes its 16 rows of the
// product's A operand to shared memory and its entries (row, column) to
// the queue; after a named barrier every thread takes one entry, sums it
// from the stashed row and the staged weights, and leaves the sum in the
// entry; after a second barrier each lane patches its own elements. A
// product of more than kQCap undecided elements takes several rounds. The
// products rotate through three queues, so that a count is reset one
// product later, when every thread has read it.

constexpr float kSlack = 8.f * 5.9604645e-8f;  // 8 * 2^-24
constexpr int kQCap = kWG;                     // entries of a round, one a thread

// render_tc_kernel's shared memory: every address in it is a constant
// offset from this symbol (or from it and the warpgroup), so that none
// holds a register across the loops
extern __shared__ __align__(128) unsigned char smem_tc[];

// One warpgroup's repair space in shared memory (WORDS words): the three
// counts, each warp's queue index, the three queues and the 64 rows of each
// M-tile of the product's A operand (bf16, RSTR words a row: the padding
// puts a warp's stores in 32 banks).
template <int W>
struct Repair {
  static constexpr int RSTR = W / 2 + 4;
  static constexpr int WORDS = 8 + 3 * kQCap + 64 * TcTile<W>::MT * RSTR;
  __device__ static uint32_t* base() {
    return reinterpret_cast<uint32_t*>(smem_tc + TcTile<W>::SMEM) + (threadIdx.x / kWG) * WORDS;
  }
  __device__ static uint32_t* count(int b) { return base() + b; }
  // words 4-7: each warp's queue of this product (here, not in a register)
  __device__ static int* buf() {
    return reinterpret_cast<int*>(base() + 4 + (threadIdx.x / 32) % 4);
  }
  __device__ static uint32_t* queue(int b) { return base() + 8 + b * kQCap; }
  __device__ static uint32_t* rows() { return base() + 8 + 3 * kQCap; }
};

// the bf16 weights of product l (w1, w2, then w3 in 8 columns), K-major
template <int W>
__device__ __forceinline__ const __nv_bfloat16* tc_weights(int l) {
  return reinterpret_cast<const __nv_bfloat16*>(smem_tc) + l * W * W;
}

// kSlack * sum_k |w[k][n]|: w1's columns, w2's, then w3's four
template <int W>
__device__ __forceinline__ float* tc_bounds() {
  return reinterpret_cast<float*>(smem_tc + TcTile<W>::WBYTES) + 2 * TcTile<W>::TR * TcTile<W>::RS;
}

__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(kWG) : "memory");
}

__device__ __forceinline__ uint32_t max_u16x2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("max.u16x2 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// max over k of rows g (m[0]) and g + 8 (m[1]) of A fragments that hold
// no negative value (relu's outputs: their bits order as their values)
template <int KS>
__device__ __forceinline__ void row_max(const uint32_t (&a)[KS][4], float (&m)[2]) {
  uint32_t r[2] = {0u, 0u};
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) r[i % 2] = max_u16x2(r[i % 2], a[ks][i]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    r[h] = max_u16x2(r[h], __shfl_xor_sync(0xffffffffu, r[h], 1));
    r[h] = max_u16x2(r[h], __shfl_xor_sync(0xffffffffu, r[h], 2));
    m[h] = __uint_as_float(max(r[h] & 0xFFFFu, r[h] >> 16) << 16);
  }
}

// nonzero in the half of lo (hi) where relu(v - t) and relu(v + t) round
// to different bf16 values, t = m * c
__device__ __forceinline__ uint32_t undecided(float lo, float hi, float m, float2 c) {
  return bf16x2_relu(__fmaf_rn(-m, c.x, lo), __fmaf_rn(-m, c.y, hi)) ^
         bf16x2_relu(__fmaf_rn(m, c.x, lo), __fmaf_rn(m, c.y, hi));
}

// bits 0 and 1: the halves of undecided()'s word that are set
__device__ __forceinline__ uint32_t halves(uint32_t d) {
  return ((d & 0xFFFFu) != 0u ? 1u : 0u) | ((d >> 16) != 0u ? 2u : 0u);
}

// sum_k row[k] b[k] by FMAs in k order from 0: row a stashed A row (bf16
// pairs), b a column of K-major bf16 (k at b[64 (k / 8) + k % 8])
template <int W>
__device__ __forceinline__ float fma_row(const uint32_t* row, const __nv_bfloat16* b) {
  float acc = 0.f;
#pragma unroll 2
  for (int kk = 0; kk < W / 8; ++kk) {
    const uint4 a4 = *reinterpret_cast<const uint4*>(row + 4 * kk);
    const uint4 b4 = *reinterpret_cast<const uint4*>(b + 64 * kk);
    const uint32_t av[4] = {a4.x, a4.y, a4.z, a4.w}, bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      acc = __fmaf_rn(__uint_as_float(av[t] << 16), __uint_as_float(bv[t] << 16), acc);
      acc = __fmaf_rn(__uint_as_float(av[t] & 0xFFFF0000u),
                      __uint_as_float(bv[t] & 0xFFFF0000u), acc);
    }
  }
  return acc;
}

// The warp's 16 rows of each M-tile of a product's A operand into the
// warpgroup's stash, M-tile m at row 64 m (register 2 e + h of k-step ks
// is row g + 8 h, columns 16 ks + 8 e + 2 t4 + {0, 1}). The stash's last
// readers, the previous product's sums, passed a barrier since.
template <int W, int MT>
__device__ __forceinline__ void stash_rows(const uint32_t (&a)[MT][W / 16][4]) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x / 32) % 4;
  uint32_t* rows = Repair<W>::rows() + (16 * warp + (lane >> 2)) * Repair<W>::RSTR + (lane & 3);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int ks = 0; ks < W / 16; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        rows[(64 * m + (i % 2) * 8) * Repair<W>::RSTR + 8 * ks + 4 * (i / 2)] = a[m][ks][i];
}

// The repair of one product of the warpgroup (see above): a the A
// fragments of its M-tiles, mine this lane's undecided elements;
// post(first, base, q) writes those whose index in the warpgroup (the
// lane's start at first) lies in [base, base + kQCap) into q as
// (row << 8) | column, row 64 m + 0-63 in M-tile m; column(c) gives B's
// column c, and patch(first, base, q) takes the sums of the lane's
// elements (float32 bits) back from q.
template <int W, int MT, typename Column, typename Post, typename Patch>
__device__ __forceinline__ void repair(const uint32_t (&a)[MT][W / 16][4], int mine,
                                       Column column, Post post, Patch patch) {
  const int lane = threadIdx.x & 31, wg = threadIdx.x / kWG, wtid = threadIdx.x % kWG;
  int incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  const int wtotal = __shfl_sync(0xffffffffu, incl, 31);
  const int buf = *Repair<W>::buf();
  if (wtotal > 0) {
    int at = 0;
    if (lane == 31)
      at = static_cast<int>(atomicAdd(Repair<W>::count(buf), static_cast<uint32_t>(wtotal)));
    incl += __shfl_sync(0xffffffffu, at, 31);
    stash_rows<W, MT>(a);
  }
  const int first = incl - mine;
  uint32_t* q = Repair<W>::queue(buf);
  // the first round's entries go in before the barrier (this queue's last
  // readers passed a barrier since)
  if (mine > 0 && first < kQCap) post(first, 0, q);
  wg_sync(wg);
  const int total = static_cast<int>(*static_cast<volatile uint32_t*>(Repair<W>::count(buf)));
  // the last product's count: every thread of the warpgroup read it
  // before this barrier
  if (wtid == 0) *Repair<W>::count(buf == 0 ? 2 : buf - 1) = 0u;
#pragma unroll 1
  for (int base = 0; base < total; base += kQCap) {
    const bool here = mine > 0 && first < base + kQCap && first + mine > base;
    if (base > 0) {
      wg_sync(wg);  // the last round's patches are done
      if (here) post(first, base, q);
      wg_sync(wg);
    }
    if (wtid < total - base) {
      const uint32_t entry = q[wtid];
      q[wtid] = __float_as_uint(
          fma_row<W>(Repair<W>::rows() + (entry >> 8) * Repair<W>::RSTR, column(entry & 255u)));
    }
    wg_sync(wg);
    if (here) patch(first, base, q);
  }
  __syncwarp();
  if (lane == 0) *Repair<W>::buf() = buf == 2 ? 0 : buf + 1;  // the next product's queue
  __syncwarp();
}

// One hidden layer of MT M-tiles: out = bf16(relu(in @ w (+ df))) as the
// next product's A fragments, with the library's order where it decides
// the rounding. Accumulator register 4 j + 2 h + i of a piece is row
// g + 8 h, column p NP + 8 j + 2 t4 + i: the fragment register
// 2 (j % 2) + h of k-step (p NP + 8 j) / 16, and bit 4 j + 2 h + i of the
// piece's undecided mask. Product L (0: w1, 1: w2 and df); df(m, col)
// gives M-tile m's ray's df at columns col + 2 t4 + {0, 1}, added to both
// rows.
template <int W, int L, int MT, typename Df>
__device__ __forceinline__ void tc_layer(uint32_t (&in)[MT][W / 16][4], uint32_t wbase,
                                         uint32_t (&out)[MT][W / 16][4], Df df) {
  using T = TcTile<W>;
  constexpr bool ADD_DF = L == 1;
  const float* cs = tc_bounds<W>() + L * W + 2 * (threadIdx.x & 3);
  uint32_t flag[MT][T::PIECES];
#pragma unroll
  for (int p = 0; p < T::PIECES; ++p) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      float acc[T::NP / 2];
      wgmma_fence();
      wgmma_chain<T::NP, T::KS>(acc, in[m], opaque(wbase + p * (T::NP / 8) * T::SBO), T::SBO);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(acc);
      fence_frags(in[m]);
      // the row bounds: the sines are within 1, relu's outputs within
      // their row's largest (taken here, not held across the products)
      float mx[2] = {1.f, 1.f};
      if constexpr (L == 1) row_max<T::KS>(in[m], mx);
      flag[m][p] = 0u;
#pragma unroll
      for (int j = 0; j < T::NP / 8; ++j) {
        const int col = p * T::NP + 8 * j;
        // df loads in flight for 4 column groups at most (all at once they
        // would take 32 registers at width 128)
        if (j % 4 == 0) asm volatile("" ::: "memory");
        float v0 = acc[4 * j], v1 = acc[4 * j + 1], v2 = acc[4 * j + 2], v3 = acc[4 * j + 3];
        if constexpr (ADD_DF) {
          const float2 f = df(m, col);
          v0 = __fadd_rn(v0, f.x);
          v1 = __fadd_rn(v1, f.y);
          v2 = __fadd_rn(v2, f.x);
          v3 = __fadd_rn(v3, f.y);
        }
        out[m][col / 16][2 * (j % 2)] = bf16x2_relu(v0, v1);
        out[m][col / 16][2 * (j % 2) + 1] = bf16x2_relu(v2, v3);
        const float2 c = *reinterpret_cast<const float2*>(cs + col);
        const uint32_t d0 = undecided(v0, v1, mx[0], c), d1 = undecided(v2, v3, mx[1], c);
        flag[m][p] |= (halves(d0) | halves(d1) << 2) << (4 * j);
      }
    }
  }
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int row0 = 16 * ((threadIdx.x / 32) % 4) + g;  // the lane's rows in an M-tile
  int mine = 0;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int p = 0; p < T::PIECES; ++p) mine += __popc(flag[m][p]);
  auto column = [&](uint32_t c) {
    return tc_weights<W>(L) + (c >> 3) * (W / 8) * 64 + (c & 7) * 8;
  };
  auto post = [&](int first, int base, uint32_t* q) {
    int idx = first;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int p = 0; p < T::PIECES; ++p) {
        for (uint32_t f = flag[m][p]; f != 0u; f &= f - 1u, ++idx) {
          const int e = __ffs(f) - 1;
          if (idx >= base && idx < base + kQCap)
            q[idx - base] =
                static_cast<uint32_t>(((64 * m + row0 + 8 * ((e >> 1) & 1)) << 8) |
                                      (p * T::NP + 8 * (e >> 2) + 2 * t4 + (e & 1)));
        }
      }
  };
  auto patch = [&](int first, int base, const uint32_t* q) {
    int idx = first;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int p = 0; p < T::PIECES; ++p) {
        uint32_t f = flag[m][p];
#pragma unroll
        for (int j = 0; j < T::NP / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t two = f & 3u;
            f >>= 2;
            asm volatile("" : "+r"(f));  // one word's bits at a time
            if (two != 0u) {
              const int col = p * T::NP + 8 * j;
              float2 d = make_float2(0.f, 0.f);
              if constexpr (ADD_DF) d = df(m, col);
              // the new sum where the element is undecided, else its bf16
              // value (which rounds to itself)
              uint32_t& word = out[m][col / 16][2 * (j % 2) + h];
              float lo = __uint_as_float(word << 16), hi = __uint_as_float(word & 0xFFFF0000u);
              if ((two & 1u) && idx >= base && idx < base + kQCap)
                lo = __fadd_rn(__uint_as_float(q[idx - base]), d.x);
              idx += two & 1u;
              if ((two & 2u) && idx >= base && idx < base + kQCap)
                hi = __fadd_rn(__uint_as_float(q[idx - base]), d.y);
              idx += two >> 1;
              word = bf16x2_relu(lo, hi);
            }
          }
      }
  };
  repair<W, MT>(in, mine, column, post, patch);
}

// Stage rays [row0, row0 + TR) of a (N, W) float32 array in shared memory,
// each row permuted so that a thread's fragment columns 16 ks + 2 t4 +
// {0, 1, 8, 9} are the float4 at 16 ks + 4 t4; rows past N are zeros.
template <int W>
__device__ __forceinline__ void stage_rays(const float* __restrict__ src, int row0, int N,
                                           float* s) {
  using T = TcTile<W>;
  for (int i = threadIdx.x; i < T::TR * W / 4; i += blockDim.x) {
    const int r = i / (W / 4), c = 4 * (i % (W / 4)), ray = row0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ray < N) v = __ldg(reinterpret_cast<const float4*>(src + static_cast<size_t>(ray) * W + c));
    // columns c, c + 1 are t4 (c % 8) / 2 at e = 2 ((c % 16) / 8); c + 2, c + 3 the next t4
    float* row = s + r * T::RS + (c / 16) * 16 + 2 * ((c % 16) / 8);
    const int t4 = (c % 8) / 2;
    *reinterpret_cast<float2*>(row + 4 * t4) = make_float2(v.x, v.y);
    *reinterpret_cast<float2*>(row + 4 * (t4 + 1)) = make_float2(v.z, v.w);
  }
}

__device__ __forceinline__ void prefetch_l2(const void* p, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(p), "r"(bytes) : "memory");
}

// bf16 render: W in {128, 64, 32}; PACKED the compositing form of
// render_fused_packed (and the head rounded to bf16).
template <int W, bool PACKED>
__global__ void __launch_bounds__(kNWG * kWG, 1)
render_tc_kernel(const float* __restrict__ oe, const float* __restrict__ de,
                 const float* __restrict__ df, const __nv_bfloat16* __restrict__ w1,
                 const __nv_bfloat16* __restrict__ w2, const __nv_bfloat16* __restrict__ w3,
                 const int* __restrict__ flags, float* __restrict__ rgb_out,
                 float* __restrict__ depth_out, int N, int n_tiles, int n_chunks, int chunk,
                 int block, int early_stop, float jitter, float near, float dt, float cut) {
  // (the loop bounds come as parameters: computed here they would hold
  // registers across the loops)
  using T = TcTile<W>;
  constexpr int KS = T::KS, G = T::G, SPR = T::SPR, MT = T::MT;
  __nv_bfloat16* w1s = reinterpret_cast<__nv_bfloat16*>(smem_tc);
  __nv_bfloat16* w2s = w1s + W * W;
  __nv_bfloat16* w3s = w2s + W * W;
  float* s_oe = reinterpret_cast<float*>(smem_tc + T::WBYTES);  // TR x RS each
  float* s_de = s_oe + T::TR * T::RS;
  float* s_cs = tc_bounds<W>();
  stage_weights<W, W>(w1, W, w1s);
  stage_weights<W, W>(w2, W, w2s);
  // kSlack * sum_k |w[k][n]| for w1's and w2's columns, then w3's four
  for (int n = threadIdx.x; n < 2 * W + 4; n += blockDim.x) {
    const __nv_bfloat16* col = n < W ? w1 + n : n < 2 * W ? w2 + (n - W) : w3 + (n - 2 * W);
    const int stride = n < 2 * W ? W : 4;
    float sum = 0.f;
    for (int k = 0; k < W; ++k) sum = __fadd_rn(sum, fabsf(__bfloat162float(col[k * stride])));
    s_cs[n] = __fmul_rn(kSlack, sum);
  }
  // w3's column c at n = 2 c of the head's 8: lane t4 of a quad then holds
  // head column t4 of its two rows
  for (int i = threadIdx.x; i < W * 8; i += blockDim.x) {
    const int k = i / 8, n = i % 8;
    w3s[(k >> 3) * 64 + n * 8 + (k & 7)] =
        n % 2 == 0 ? w3[k * 4 + n / 2] : __float2bfloat16_rn(0.f);
  }
  // the generic stores above, before wgmma reads them through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const uint32_t sbase = smem_u32(smem_tc);

  const int wg = threadIdx.x / kWG, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  if (threadIdx.x % kWG < 8) *Repair<W>::count(threadIdx.x % kWG) = 0u;  // counts, queue indices

#pragma unroll 1
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = opaque(tile) * T::TR;
    // the thread's ray of group gi (recomputed where used, not held)
    auto ray_of = [&](int gi) {
      return opaque(row0 + (wg * G + gi) * T::RPM + T::group_ray(warp, g));
    };
    __syncthreads();  // every warpgroup is done with the last tile's rows
    stage_rays<W>(oe, row0, N, s_oe);
    stage_rays<W>(de, row0, N, s_de);
    __syncthreads();
    const int next = row0 + gridDim.x * T::TR;
    if (threadIdx.x == 0 && next < N) {
      const uint32_t bytes = static_cast<uint32_t>(min(T::TR, N - next)) * W * 4;
      prefetch_l2(oe + static_cast<size_t>(next) * W, bytes);
      prefetch_l2(de + static_cast<size_t>(next) * W, bytes);
      prefetch_l2(df + static_cast<size_t>(next) * W, bytes);
    }
    Composite<PACKED> comp[G];
#pragma unroll 1
    for (int ci = 0; ci < n_chunks; ++ci) {
      bool mine[G], want = false;
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        const int ray = ray_of(gi);
        mine[gi] = ray < N && flag_set(flags, ray, block, n_chunks, ci);
        want = want || (mine[gi] && (!early_stop || ci == 0 || comp[gi].open(cut)));
      }
      if (!__syncthreads_or(want)) continue;
      const int s_end = (ci + 1) * chunk;
      // MT groups at a time, each an M-tile of the same samples
#pragma unroll
      for (int gi0 = 0; gi0 < G; gi0 += MT) {
        int rl[MT];
        const float *so[MT], *sd[MT];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          rl[m] = ray_of(gi0 + m) - row0;
          so[m] = s_oe + rl[m] * T::RS + 4 * t4;
          sd[m] = s_de + rl[m] * T::RS + 4 * t4;
        }
        auto ops = [&](int m) {
          return [&, m](int ks, float4& o, float4& d) {
            o = *reinterpret_cast<const float4*>(so[m] + 16 * ks);
            d = *reinterpret_cast<const float4*>(sd[m] + 16 * ks);
          };
        };
        // df from global memory (L1 or the L2 prefetch), rays past N
        // reading the last ray's
        auto dfv = [&](int m, int col) {
          const int ray = min(row0 + rl[m], N - 1);
          return __ldg(reinterpret_cast<const float2*>(df + static_cast<size_t>(ray) * W + col +
                                                       2 * t4));
        };
#pragma unroll 1
        for (int s = ci * chunk; s < s_end; s += SPR) {
          const float t0 = sample_t(s + T::row_sample(opaque(g), 0), jitter, near, dt);
          const float t1 = sample_t(s + T::row_sample(opaque(g), 1), jitter, near, dt);
          uint32_t a[MT][KS][4], h[MT][KS][4];
#pragma unroll
          for (int m = 0; m < MT; ++m) encode<KS>(ops(m), t0, t1, a[m]);
          tc_layer<W, 0, MT>(a, sbase, h, dfv);
          tc_layer<W, 1, MT>(h, sbase + W * W * 2, a, dfv);
          float hd[MT][4];
          wgmma_fence();
#pragma unroll
          for (int m = 0; m < MT; ++m)
            wgmma_chain<8, KS>(hd[m], a[m], opaque(sbase + 2 * W * W * 2), T::SBO);
          wgmma_commit();
          wgmma_wait0();
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            fence_regs(hd[m]);
            fence_frags(a[m]);
          }
          if constexpr (PACKED) {
            // the packed head is rounded to bf16: repaired as the layers;
            // bit 2 m + r: row g + 8 r of M-tile m
            const float c3 = tc_bounds<W>()[2 * W + t4];
            uint32_t hf = 0u;
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              float mh[2];
              row_max<KS>(a[m], mh);
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                const float t = __fmul_rn(mh[r], c3);
                hf |= (__float_as_uint(round_bf16(__fsub_rn(hd[m][2 * r], t))) !=
                               __float_as_uint(round_bf16(__fadd_rn(hd[m][2 * r], t)))
                           ? 1u
                           : 0u)
                      << (2 * m + r);
              }
            }
            auto column = [&](uint32_t c) { return tc_weights<W>(2) + 16 * c; };
            const int hrow = 16 * warp + g;  // the lane's rows in an M-tile
            auto post = [&](int first, int base, uint32_t* q) {
              int idx = first;
#pragma unroll
              for (int b = 0; b < 2 * MT; ++b) {
                if (((hf >> b) & 1u) && idx >= base && idx < base + kQCap)
                  q[idx - base] =
                      static_cast<uint32_t>(((64 * (b / 2) + hrow + 8 * (b % 2)) << 8) | t4);
                idx += (hf >> b) & 1u;
              }
            };
            auto patch = [&](int first, int base, const uint32_t* q) {
              int idx = first;
#pragma unroll
              for (int b = 0; b < 2 * MT; ++b) {
                if (((hf >> b) & 1u) && idx >= base && idx < base + kQCap)
                  hd[b / 2][2 * (b % 2)] = __uint_as_float(q[idx - base]);
                idx += (hf >> b) & 1u;
              }
            };
            repair<W, MT>(a, __popc(hf), column, post, patch);
          }
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const int gi = gi0 + m;
            // lane 4 g + t4 holds head column t4 of rows g (hd 0) and g + 8
            // (hd 2), samples s + row_sample(g, h), and forms part t4 of
            // both. The parts of sample s + i of the thread's ray are in
            // lanes src + k, row r: SPR 2, this quad, r = i; SPR 4, quad
            // g % 4 + 4 (i % 2), r = i / 2.
            float own[2], sig[2];
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2) {
              const float v = PACKED ? round_bf16(hd[m][2 * h2]) : hd[m][2 * h2];
              own[h2] = Composite<PACKED>::part(v, t4, dt);
              sig[h2] = Composite<PACKED>::sigma_dt(v, dt);  // read from t4 0 only
            }
#pragma unroll
            for (int i = 0; i < SPR; ++i) {
              const int src = SPR == 2 ? lane & ~3 : 4 * ((g & 3) + 4 * (i % 2));
              const int r = SPR == 2 ? i : i / 2;
              const float mine_part = r == 0 ? own[0] : own[1];
              float p[4];
#pragma unroll
              for (int k = 0; k < 4; ++k) p[k] = __shfl_sync(0xffffffffu, mine_part, src + k);
              float sg = 0.f;
              if constexpr (PACKED) sg = __shfl_sync(0xffffffffu, r == 0 ? sig[0] : sig[1], src);
              if (mine[gi] && s + i < s_end)
                comp[gi].add_parts(p, sg, sample_t(s + i, jitter, near, dt));
            }
          }
        }
#pragma unroll
        for (int m = 0; m < MT; ++m)
          if (mine[gi0 + m]) comp[gi0 + m].end_chunk();
      }
    }
    // one lane of the ray's lanes stores it
    const bool storer = t4 == 0 && (SPR == 2 || g < 4);
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      const int ray = ray_of(gi);
      if (storer && ray < N) comp[gi].store(rgb_out, depth_out, ray);
    }
  }
}

// ---- float32 on the TF32 tensor cores ----
//
// render_f32_kernel: render_tc_kernel's frame with float32 operands, each
// product as three TF32 passes (tf32_tc.cuh). A block of NWG warpgroups
// stays on its SM and walks tiles of 8192 / W rays (the early stop's
// tile), all on one tile, which votes on each chunk; an M-tile is a group
// of RPM rays at SPR consecutive samples (TcTile's group_ray and
// row_sample), a warpgroup's G groups in turn. The B operands sit in
// shared memory as prepare_render_f32 lays them out (kernels/render.py):
// w1, w2 and w3 (its four columns at n = 0, 2, 4, 6 of 8) K-major in
// 8 x 4 core matrices, raw float32 words, whose top 19 bits the tensor
// cores read as hi, and lo = tf32_lo of each, made as they are staged. A
// tf32 m64k8 A fragment holds columns t and t + 4 of rows g and g + 8, an
// m64nN accumulator columns 8 j + 2 t + {0, 1}: so column c of k-step s
// carries hidden unit 8 s + 2 (c % 4) + c / 4 (render.prepare_render_f32),
// the rows of w1, w2 and w3 are permuted by that map on the host, and each
// layer's sums become the next layer's A fragments in the thread's own
// registers (ReLU, + df, and the split off of lo). The encoding reads the
// ray's oe and de at units 8 s + 2 t + {0, 1}, one float2 each a k-step,
// from global memory (L1; the next tile is prefetched into L2), and writes
// the sines straight into the fragments: sine_fast, with no branch, so
// that the 64 sines of a thread interleave (with sine()'s Payne-Hanek
// branch in each the width-128 kernel took twice as long), and sine() again
// only where an argument reaches kSineBig. The head is an n8 product; the
// compositing is render_tc_kernel's, by shuffles; no barrier separates the
// samples.
//
// Shared memory at width 128: w1 and w2 split into hi and lo would take
// 256 KB, past the 227 KB a block may have. So the raw w1 and w2 and
// lo(w1) stay resident (192 KB), and each warpgroup makes lo(w2) itself,
// one k-step (4 KB) at a time, into a ring of kSlots slots of its own
// (fence.proxy.async, then its named barrier), the wgmma of chunk c -
// kSlots waited for first: no warpgroup waits for another, and a chunk's
// lo is made while the tensor cores run the chunks before (216 KB in all).
// Widths 64 and 32 keep lo(w1), lo(w2) resident (64 KB and 16 KB).
// Registers: at width 128 a thread holds an M-tile's A as raw and lo words
// (128) and an m64n128 accumulator (64), so a block runs two warpgroups
// (255 registers, 8 bytes of stack); at 64 and 32 four (128 registers, 16
// bytes of stack at 64). tools/render_variants.py times the alternatives
// (making lo(w1) too; two warpgroups at 64; the sines with their branch)
// and the cost of each phase.
//
// Numerics: per k-step lo(x).w and x.lo(w), then x.w over all of K, into
// one accumulator: the small terms are summed while the running sum is
// small, so that the tensor cores' truncating adds cut them at their own
// scale, and x.w comes on top as one chain. The split drops lo.lo and the
// roundings of lo (at most 2^-19 of |x w| a product); with the truncation
// a product lies within 8 float32 ulps of its sum of |products| of the
// exact one (tests/test_torch_render_f32_tc.py, through the model of
// tests/_render_f32_tc.py), and renders within a tenth of the float32
// tolerances of the library's. The sine and its argument are the other
// kernels'.

using spnerf::tf32::tf32_lo;
using spnerf::tf32::wgmma_tf32;
using spnerf::tf32::wgmma_wait;

constexpr int kCK = 1;      // k-steps of a chunk of lo(w)
constexpr int kSlots = 2;   // ring slots of a warpgroup (width 128)
constexpr int kRes128 = 1;  // layers whose lo(w) is resident at width 128

template <int W>
struct F32Tile {
  static constexpr int NWG = W == 128 ? 2 : 4;          // warpgroups of a block
  static constexpr int TR = kTileElems / W;             // rays of a tile
  static constexpr int SPR = TcTile<W>::SPR;            // samples of a ray in an M-tile
  static constexpr int RPM = 64 / SPR;                  // rays of an M-tile (a group)
  static constexpr int G = TR / (RPM * NWG);            // groups of a warpgroup
  static constexpr int KS = W / 8;                      // k-steps of a layer
  // layers whose lo(w) is resident (made as it is staged); the others'
  // is made per chunk into each warpgroup's ring
  static constexpr int NRES = W == 128 ? kRes128 : 2;
  static constexpr uint32_t SBO = 32 * W;               // bytes between N-adjacent core matrices
  static constexpr int MAT = W * W * 4;                 // bytes of w1's (w2's) B operand
  static constexpr int HEAD = W * 8 * 4;                // bytes of w3's
  static constexpr int SLOT = kCK * 8 * W * 4;          // bytes of a ring slot
  // raw w1, w2, w3; lo(w3); the resident lo(w); each warpgroup's slots
  static constexpr int OFF_LO3 = 2 * MAT + HEAD;
  static constexpr int OFF_LO = OFF_LO3 + HEAD;
  static constexpr int OFF_RING = OFF_LO + NRES * MAT;
  static constexpr int SMEM = OFF_RING + (NRES < 2 ? NWG * kSlots * SLOT : 0);
};

// tf32_lo of four words
__device__ __forceinline__ uint4 tf32_lo4(uint4 v) {
  return make_uint4(tf32_lo(__uint_as_float(v.x)), tf32_lo(__uint_as_float(v.y)),
                    tf32_lo(__uint_as_float(v.z)), tf32_lo(__uint_as_float(v.w)));
}

// Slot of chunk c's lo(w) (k-steps kCK c .. kCK c + kCK - 1 of the raw B at
// raw): element (k, n) of the chunk at word ((n / 8) KG + k / 4) 32 + (n %
// 8) 4 + k % 4, KG = 2 kCK, the layout of the whole matrix cut to the
// chunk's 8 kCK rows (stride byte offset 128 KG). A warpgroup's 128
// threads make its 2 kCK W 16-byte words.
constexpr int kKG = 2 * kCK;  // core matrices of a slot's column group

template <int W>
__device__ __forceinline__ void make_lo_chunk(const uint4* raw, uint4* slot, int c) {
  const int wtid = threadIdx.x % kWG;
#pragma unroll
  for (int i = 0; i < kKG * W / kWG; ++i) {
    const int q = wtid + kWG * i;
    slot[q] = tf32_lo4(raw[((q / (8 * kKG)) * (W / 4) + kKG * c + (q / 8) % kKG) * 8 + q % 8]);
  }
}

// acc = x @ w (K = 8 KS, N columns) for the warpgroup's M-tile: a the raw
// words of x, l their tf32_lo; w's raw B at b (k-step ks at b + 256 ks,
// stride byte offset sbo), lo(w)'s at lo(c, e) for k-step kCK c + e; before(c)
// runs before chunk c is issued. The small passes per chunk, then x.w.
template <int KS, int N, typename Lo, typename Before>
__device__ __forceinline__ void tf32_product(float (&acc)[N / 2], uint32_t (&a)[KS][4],
                                             uint32_t (&l)[KS][4], uint32_t b, uint32_t sbo,
                                             Lo lo, Before before) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int c = 0; c < KS / kCK; ++c) {
    before(c);
    wgmma_fence();
#pragma unroll
    for (int e = 0; e < kCK; ++e)
      wgmma_tf32<N>(acc, l[kCK * c + e], smem_desc(b + (kCK * c + e) * 256, 128, sbo), 1);
#pragma unroll
    for (int e = 0; e < kCK; ++e) wgmma_tf32<N>(acc, a[kCK * c + e], lo(c, e), 1);
    wgmma_commit();
  }
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    wgmma_tf32<N>(acc, a[ks], smem_desc(b + ks * 256, 128, sbo), 1);
  wgmma_commit();
  wgmma_wait0();
  fence_regs(acc);
  fence_frags(a);
  fence_frags(l);
}

// The next product's A from a layer's sums: x = relu(acc + df) (df(j):
// the ray's df at units 8 j + 2 t + {0, 1}, or zeros); accumulator
// register 4 j + 2 h + e (row g + 8 h, unit 8 j + 2 t + e) goes to fragment
// register h + 2 e of k-step j, the slot the permuted rows of w expect.
template <int KS, typename Df>
__device__ __forceinline__ void relu_frags(const float (&acc)[4 * KS], uint32_t (&a)[KS][4],
                                           uint32_t (&l)[KS][4], Df df) {
#pragma unroll
  for (int j = 0; j < KS; ++j) {
    const float2 f = df(j);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float v = fmaxf(__fadd_rn(acc[4 * j + 2 * h + e], e ? f.y : f.x), 0.f);
        a[j][h + 2 * e] = __float_as_uint(v);
        l[j][h + 2 * e] = tf32_lo(v);
      }
  }
}

// float32 render: W in {128, 64, 32}; PACKED the compositing form of
// render_fused_packed (the float32 head is not rounded). b the three raw B
// operands of prepare_render_f32.
template <int W, bool PACKED>
__global__ void __launch_bounds__(F32Tile<W>::NWG * kWG, 1)
render_f32_kernel(const float* __restrict__ oe, const float* __restrict__ de,
                  const float* __restrict__ df, const uint4* __restrict__ b,
                  const int* __restrict__ flags,
                  float* __restrict__ rgb_out, float* __restrict__ depth_out, int N, int n_tiles,
                  int n_chunks, int chunk, int block, int early_stop, float jitter, float near,
                  float dt, float cut) {
  using T = F32Tile<W>;
  constexpr int KS = T::KS, G = T::G, SPR = T::SPR;
  {
    uint4* s = reinterpret_cast<uint4*>(smem_tc);
    for (int i = threadIdx.x; i < T::OFF_LO3 / 16; i += blockDim.x) s[i] = __ldg(b + i);
    for (int i = threadIdx.x; i < T::HEAD / 16; i += blockDim.x)
      s[T::OFF_LO3 / 16 + i] = tf32_lo4(__ldg(b + 2 * T::MAT / 16 + i));
    for (int i = threadIdx.x; i < T::NRES * T::MAT / 16; i += blockDim.x)
      s[T::OFF_LO / 16 + i] = tf32_lo4(__ldg(b + i));
  }
  // the generic stores above, before wgmma reads them through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const uint32_t sbase = smem_u32(smem_tc);

  const int wg = threadIdx.x / kWG, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  // product L's lo(w) for k-step kCK c + e: resident, or the warpgroup's
  // slot of chunk c (made by ring(L) before the chunk is issued)
  auto lo_of = [&](int L) {
    return [&, L](int c, int e) {
      if (L >= T::NRES)
        return smem_desc(sbase + T::OFF_RING + (kSlots * wg + c % kSlots) * T::SLOT + e * 256,
                         128, 128 * kKG);
      return smem_desc(sbase + T::OFF_LO + L * T::MAT + (kCK * c + e) * 256, 128, T::SBO);
    };
  };
  auto ring = [&](int L) {
    return [&, L](int c) {
      if (L >= T::NRES) {
        // the slot's last reader, chunk c - kSlots, is the group kSlots - 1
        // before the last one committed (the previous product's were
        // waited for)
        if (c >= kSlots) wgmma_wait<kSlots - 1>();
        make_lo_chunk<W>(reinterpret_cast<const uint4*>(smem_tc + L * T::MAT),
                         reinterpret_cast<uint4*>(smem_tc + T::OFF_RING +
                                                  (kSlots * wg + c % kSlots) * T::SLOT),
                         c);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        wg_sync(wg);
      }
    };
  };
  auto nothing = [](int) {};

#pragma unroll 1
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = opaque(tile) * T::TR;
    // the thread's ray of group gi (recomputed where used, not held)
    auto ray_of = [&](int gi) {
      return opaque(row0 + (wg * G + gi) * T::RPM + TcTile<W>::group_ray(warp, g));
    };
    const int next = row0 + gridDim.x * T::TR;
    if (threadIdx.x == 0 && next < N) {
      const uint32_t bytes = static_cast<uint32_t>(min(T::TR, N - next)) * W * 4;
      prefetch_l2(oe + static_cast<size_t>(next) * W, bytes);
      prefetch_l2(de + static_cast<size_t>(next) * W, bytes);
      prefetch_l2(df + static_cast<size_t>(next) * W, bytes);
    }
    Composite<PACKED> comp[G];
#pragma unroll 1
    for (int ci = 0; ci < n_chunks; ++ci) {
      bool mine[G], want = false;
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        const int ray = ray_of(gi);
        mine[gi] = ray < N && flag_set(flags, ray, block, n_chunks, ci);
        want = want || (mine[gi] && (!early_stop || ci == 0 || comp[gi].open(cut)));
      }
      if (!__syncthreads_or(want)) continue;
      const int s_end = (ci + 1) * chunk;
      // the groups in a loop that is not unrolled (one copy of the sample
      // step's code), each group's state taken out of the arrays and put
      // back by selects
#pragma unroll 1
      for (int gi = 0; gi < G; ++gi) {
        Composite<PACKED> cg = comp[0];
        bool mg = mine[0];
#pragma unroll
        for (int k = 1; k < G; ++k) {
          if (gi == k) {
            cg = comp[k];
            mg = mine[k];
          }
        }
        // the ray's operands at units 8 s + 2 t4 + {0, 1} of k-step s as
        // float2 4 s; rays past N read the last ray's
        const size_t at = static_cast<size_t>(min(ray_of(gi), N - 1)) * W + 2 * t4;
        const float2* oe2 = reinterpret_cast<const float2*>(oe + at);
        const float2* de2 = reinterpret_cast<const float2*>(de + at);
        const float2* df2 = reinterpret_cast<const float2*>(df + at);
#pragma unroll 1
        for (int s = ci * chunk; s < s_end; s += SPR) {
          const float t[2] = {sample_t(s + TcTile<W>::row_sample(opaque(g), 0), jitter, near, dt),
                              sample_t(s + TcTile<W>::row_sample(opaque(g), 1), jitter, near, dt)};
          // the encoding: register h + 2 e of k-step ks is row g + 8 h
          // (time t[h]) at unit 8 ks + 2 t4 + e. sine_fast, a block with
          // no branch; the rare arguments past kSineBig again by sine()
          uint32_t a[KS][4], l[KS][4];
          bool big = false;
          auto encode = [&](auto put) {
#pragma unroll
            for (int ks = 0; ks < KS; ++ks) {
              asm volatile("" ::: "memory");  // one k-step's operands at a time
              const float2 o = __ldg(oe2 + 4 * ks), d = __ldg(de2 + 4 * ks);
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                put(ks, h, __fadd_rn(o.x, __fmul_rn(t[h], d.x)));
                put(ks, h + 2, __fadd_rn(o.y, __fmul_rn(t[h], d.y)));
              }
            }
          };
          encode([&](int ks, int i, float x) {
            const float y = sine_fast(x);
            big |= fabsf(x) >= kSineBig;
            a[ks][i] = __float_as_uint(y);
            l[ks][i] = tf32_lo(y);
          });
          if (big) {
            encode([&](int ks, int i, float x) {
              if (fabsf(x) >= kSineBig) {
                const float y = sine(x);
                a[ks][i] = __float_as_uint(y);
                l[ks][i] = tf32_lo(y);
              }
            });
          }
          float acc[W / 2];
          tf32_product<KS, W>(acc, a, l, sbase, T::SBO, lo_of(0), ring(0));
          relu_frags<KS>(acc, a, l, [](int) { return make_float2(0.f, 0.f); });
          tf32_product<KS, W>(acc, a, l, sbase + T::MAT, T::SBO, lo_of(1), ring(1));
          relu_frags<KS>(acc, a, l, [&](int j) { return __ldg(df2 + 4 * j); });
          float hd[4];
          tf32_product<KS, 8>(
              hd, a, l, sbase + 2 * T::MAT, T::SBO,
              [&](int c, int e) {
                return smem_desc(sbase + T::OFF_LO3 + (kCK * c + e) * 256, 128, T::SBO);
              },
              nothing);
          // lane 4 g + t4 holds head column t4 of rows g (hd 0) and g + 8
          // (hd 2), samples s + row_sample(g, h), and forms part t4 of
          // both. The parts of sample s + i of the thread's ray are in
          // lanes src + k, row r: SPR 2, this quad, r = i; SPR 4, quad
          // g % 4 + 4 (i % 2), r = i / 2.
          float own[2], sig[2];
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            own[h2] = Composite<PACKED>::part(hd[2 * h2], t4, dt);
            sig[h2] = Composite<PACKED>::sigma_dt(hd[2 * h2], dt);  // read from t4 0 only
          }
#pragma unroll
          for (int i = 0; i < SPR; ++i) {
            const int src = SPR == 2 ? lane & ~3 : 4 * ((g & 3) + 4 * (i % 2));
            const int r = SPR == 2 ? i : i / 2;
            float p[4];
#pragma unroll
            for (int k = 0; k < 4; ++k)
              p[k] = __shfl_sync(0xffffffffu, r == 0 ? own[0] : own[1], src + k);
            float sg = 0.f;
            if constexpr (PACKED) sg = __shfl_sync(0xffffffffu, r == 0 ? sig[0] : sig[1], src);
            if (mg && s + i < s_end) cg.add_parts(p, sg, sample_t(s + i, jitter, near, dt));
          }
        }
        if (mg) cg.end_chunk();
#pragma unroll
        for (int k = 0; k < G; ++k)
          if (gi == k) comp[k] = cg;
      }
    }
    // one lane of the ray's lanes stores it
    const bool storer = t4 == 0 && (SPR == 2 || g < 4);
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      const int ray = ray_of(gi);
      if (storer && ray < N) comp[gi].store(rgb_out, depth_out, ray);
    }
  }
}

// ---- int8 on the int8 tensor cores ----
//
// render_s8_kernel: render_tc_kernel's frame at width 128 with int8
// operands. A block of four warpgroups stays on its SM and walks tiles of
// 64 rays; each M-tile is its warpgroup's 16 rays at 4 consecutive samples
// (TcTile<128>). qw1, qw2 and qw3 sit in shared memory for the block's life
// as the K-major B operands of wgmma m64nNk32 .s32.s8.s8 (N 128 for the
// layers, 8 for the head, qw3's four columns at n = 0, 2, 4, 6), laid out
// on the host (prepare_render_int8 in kernels/render.py). A thread (lane
// 4 g + t4) holds rows g and g + 8, one ray at two samples; its m64k32 A
// fragment is columns 16 e + 4 t4 + {0..3} of those rows (register 2 e +
// h: row g + 8 h), so the encoding reads its oe and de as float4s of the
// staged rays and writes round(127 sin) straight into the fragment.
// An s32 accumulator holds columns 8 j + 2 t4 + {0, 1}, which are not a
// fragment's columns; but A's column k of k-step s may hold any hidden
// unit if B's row k holds the same one. So column 32 s + 16 e + 4 t4 + i
// carries unit 32 s + 8 (2 e + i / 2) + 2 t4 + i % 2, which the thread's
// accumulator holds, and qw2's and qw3's rows are permuted by that map on
// the host (render.s8_hidden_order): int8 products and int32 sums are
// exact in any order, so the layers equal the plain version's to the bit,
// and the hidden activations never leave the registers. Each epilogue is
// the plain version's rounded float32 operations on its own columns (m1,
// m2 and df * ia2 by the unpermuted unit), the cast by adding 1.5 * 2^23
// (round half to even) and taking the low byte. No barrier separates the
// samples; the compositing is render_tc_kernel's.

// bytes of the B operands: qw1 and qw2 (128 x 128), qw3 (128 x 8)
constexpr int kS8Weights = 2 * 128 * 128 + 128 * 8;

struct S8Smem {
  static constexpr int RS = 144;  // floats a staged ray: a quarter-warp's two rays in 32 banks
  static constexpr int OFF_M = kS8Weights;                // m1, m2
  static constexpr int OFF_RAYS = OFF_M + 2 * 128 * 4;     // oe, de, df * ia2
  static constexpr int RAYS = TcTile<128>::TR * RS * 4;    // bytes of one staged array
  static constexpr int SMEM = OFF_RAYS + 3 * RAYS;
};

// the product of the 4 k-steps of a (128 columns) into d, B at b
template <int N>
__device__ __forceinline__ void wgmma_s8_chain(int (&d)[N / 2], const uint32_t (&a)[4][4],
                                               uint32_t b) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) wgmma_s8_rs<N>(d, a[ks], smem_desc(b + ks * 256, 128, 1024), ks);
}

// int8 bits (the low byte) of rint(v) for v within [-127, 127] (as
// s8_cast_bits, which clamps first)
__device__ __forceinline__ int s8_bits(float v) {
  return __float_as_int(__fadd_rn(v, 12582912.f));
}
// One layer's epilogue into the next product's A fragments: accumulator
// register 4 j + 2 h + i (row g + 8 h, unit 8 j + 2 t4 + i) goes to byte
// 2 (j % 2) + i of fragment register 2 ((j / 2) % 2) + h of k-step j / 4,
// the slot the permuted B rows expect there. q(r, n) casts accumulator
// register r of unit pair n (units n, n + 1).
template <typename Q>
__device__ __forceinline__ void s8_epilogue(const int (&acc)[64], uint32_t (&out)[4][4], Q q) {
  const int t4 = threadIdx.x & 3;
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int b = 16 * s + 8 * e, n = 32 * s + 16 * e + 2 * t4;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int2 lo = q(acc, b + 2 * h, n), hi = q(acc, b + 4 + 2 * h, n + 8);
        out[s][2 * e + h] = pack4(lo.x, lo.y, hi.x, hi.y);
      }
    }
}

// Stage rays [row0, row0 + TR) of a (N, 128) float32 array in shared
// memory as they are (row r at r * RS), times scale when SCALE; rows past N
// are zeros.
template <bool SCALE>
__device__ __forceinline__ void stage_rows(const float* __restrict__ src, int row0, int N,
                                           float* s, float scale) {
  constexpr int W = 128;
  for (int i = threadIdx.x; i < TcTile<W>::TR * W / 4; i += blockDim.x) {
    const int r = i / (W / 4), c = 4 * (i % (W / 4)), ray = row0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ray < N) v = __ldg(reinterpret_cast<const float4*>(src + static_cast<size_t>(ray) * W + c));
    if constexpr (SCALE) {
      v.x = __fmul_rn(v.x, scale);
      v.y = __fmul_rn(v.y, scale);
      v.z = __fmul_rn(v.z, scale);
      v.w = __fmul_rn(v.w, scale);
    }
    *reinterpret_cast<float4*>(s + r * S8Smem::RS + c) = v;
  }
}

// int8 render at width 128: w1b, w2b, w3b the B operands of
// prepare_render_int8 (qw1; qw2 and qw3 with permuted rows, qw3 in 8
// columns); m1, m2 (128,) and r3 (4,) float32 rescales.
__global__ void __launch_bounds__(kNWG * kWG, 1)
render_s8_kernel(const float* __restrict__ oe, const float* __restrict__ de,
                 const float* __restrict__ df, const int8_t* __restrict__ w1b,
                 const int8_t* __restrict__ w2b, const int8_t* __restrict__ w3b,
                 const float* __restrict__ m1, const float* __restrict__ m2,
                 const float* __restrict__ r3, const int* __restrict__ flags,
                 float* __restrict__ rgb_out, float* __restrict__ depth_out, int N, int n_tiles,
                 int n_chunks, int chunk, int block, int early_stop, float jitter, float near,
                 float dt, float cut, float ia2) {
  using T = TcTile<128>;  // 16 rays x 4 samples an M-tile, one group a warpgroup
  constexpr int SPR = T::SPR;
  const float* s_m = reinterpret_cast<const float*>(smem_tc + S8Smem::OFF_M);  // m1, m2
  float* s_oe = reinterpret_cast<float*>(smem_tc + S8Smem::OFF_RAYS);
  float* s_de = s_oe + T::TR * S8Smem::RS;
  float* s_df = s_de + T::TR * S8Smem::RS;  // df * ia2
  {
    int4* w = reinterpret_cast<int4*>(smem_tc);
    for (int i = threadIdx.x; i < kS8Weights / 16; i += blockDim.x) {
      const int4* src = i < 1024 ? reinterpret_cast<const int4*>(w1b) + i
                        : i < 2048 ? reinterpret_cast<const int4*>(w2b) + (i - 1024)
                                   : reinterpret_cast<const int4*>(w3b) + (i - 2048);
      w[i] = __ldg(src);
    }
    float* m = reinterpret_cast<float*>(smem_tc + S8Smem::OFF_M);
    for (int i = threadIdx.x; i < 256; i += blockDim.x) m[i] = i < 128 ? m1[i] : m2[i - 128];
  }
  // the generic stores above, before wgmma reads them through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const uint32_t sbase = smem_u32(smem_tc);

  const int wg = threadIdx.x / kWG, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const float r3t = __ldg(r3 + t4);  // lane t4 forms head column t4
  // layer 1: q = rint(clamp(relu(acc) * m1, 0, 127))
  auto q1 = [&](const int (&acc)[64], int r, int n) {
    const float2 m = *reinterpret_cast<const float2*>(s_m + n);
    return make_int2(s8_cast_bits(__fmul_rn(__int2float_rn(max(acc[r], 0)), m.x), true),
                     s8_cast_bits(__fmul_rn(__int2float_rn(max(acc[r + 1], 0)), m.y), true));
  };

#pragma unroll 1
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * T::TR;
    const int rl = wg * T::RPM + T::group_ray(warp, g);  // the thread's ray in the tile
    const int ray = row0 + rl;
    __syncthreads();  // every warpgroup is done with the last tile's rows
    stage_rows<false>(oe, row0, N, s_oe, 0.f);
    stage_rows<false>(de, row0, N, s_de, 0.f);
    stage_rows<true>(df, row0, N, s_df, ia2);
    __syncthreads();
    const int next = row0 + gridDim.x * T::TR;
    if (threadIdx.x == 0 && next < N) {
      const uint32_t bytes = static_cast<uint32_t>(min(T::TR, N - next)) * 128 * 4;
      prefetch_l2(oe + static_cast<size_t>(next) * 128, bytes);
      prefetch_l2(de + static_cast<size_t>(next) * 128, bytes);
      prefetch_l2(df + static_cast<size_t>(next) * 128, bytes);
    }
    const float* so = s_oe + rl * S8Smem::RS + 4 * t4;
    const float* sd = s_de + rl * S8Smem::RS + 4 * t4;
    const float* sf = s_df + rl * S8Smem::RS;
    // layer 2: q = rint(clamp(relu(acc * m2 + df * ia2), 0, 127))
    auto q2 = [&](const int (&acc)[64], int r, int n) {
      const float2 m = *reinterpret_cast<const float2*>(s_m + 128 + n);
      const float2 f = *reinterpret_cast<const float2*>(sf + n);
      const float v0 = __fadd_rn(__fmul_rn(__int2float_rn(acc[r]), m.x), f.x);
      const float v1 = __fadd_rn(__fmul_rn(__int2float_rn(acc[r + 1]), m.y), f.y);
      return make_int2(s8_cast_bits(v0, true), s8_cast_bits(v1, true));
    };
    Composite<false> comp;
#pragma unroll 1
    for (int ci = 0; ci < n_chunks; ++ci) {
      const bool mine = ray < N && flag_set(flags, ray, block, n_chunks, ci);
      const bool want = mine && (!early_stop || ci == 0 || comp.open(cut));
      if (!__syncthreads_or(want)) continue;
      const int s_end = (ci + 1) * chunk;
#pragma unroll 1
      for (int s = ci * chunk; s < s_end; s += SPR) {
        const float t[2] = {sample_t(s + T::row_sample(g, 0), jitter, near, dt),
                            sample_t(s + T::row_sample(g, 1), jitter, near, dt)};
        // the encoding: register 2 e + h of k-step ks is row g + 8 h (time
        // t[h]) at columns 32 ks + 16 e + 4 t4 + {0..3}
        uint32_t a[4][4];
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float4 o = *reinterpret_cast<const float4*>(so + 32 * ks + 16 * e);
            const float4 d = *reinterpret_cast<const float4*>(sd + 32 * ks + 16 * e);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              auto enc = [&](float ov, float dv) {
                return s8_bits(__fmul_rn(sine(__fadd_rn(ov, __fmul_rn(t[h], dv))), 127.f));
              };
              a[ks][2 * e + h] = pack4(enc(o.x, d.x), enc(o.y, d.y), enc(o.z, d.z),
                                       enc(o.w, d.w));
            }
          }
        int acc[64];
        uint32_t hf[4][4];
        wgmma_fence();
        wgmma_s8_chain<128>(acc, a, sbase);
        wgmma_commit();
        wgmma_wait0();
        fence_regs(acc);
        s8_epilogue(acc, hf, q1);
        wgmma_fence();
        wgmma_s8_chain<128>(acc, hf, sbase + 128 * 128);
        wgmma_commit();
        wgmma_wait0();
        fence_regs(acc);
        s8_epilogue(acc, a, q2);
        int hd[4];
        wgmma_fence();
        wgmma_s8_chain<8>(hd, a, sbase + 2 * 128 * 128);
        wgmma_commit();
        wgmma_wait0();
        fence_regs(hd);
        // lane 4 g + t4 holds head column t4 of rows g (hd 0) and g + 8
        // (hd 2), samples s + row_sample(g, h), and forms part t4 of both;
        // the parts of sample s + i of the thread's ray are in lanes
        // 4 (g % 4 + 4 (i % 2)) + k, row i / 2
        float own[2];
#pragma unroll
        for (int h = 0; h < 2; ++h)
          own[h] = Composite<false>::part(__fmul_rn(__int2float_rn(hd[2 * h]), r3t), t4, dt);
#pragma unroll
        for (int i = 0; i < SPR; ++i) {
          const int src = 4 * ((g & 3) + 4 * (i % 2));
          const float part = i / 2 == 0 ? own[0] : own[1];
          float p[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) p[k] = __shfl_sync(0xffffffffu, part, src + k);
          if (mine && s + i < s_end) comp.add_parts(p, 0.f, sample_t(s + i, jitter, near, dt));
        }
      }
    }
    // one lane of the ray's lanes stores it
    if (t4 == 0 && g < 4 && ray < N) comp.store(rgb_out, depth_out, ray);
  }
}

struct RenderArgs {
  const void *oe, *de, *df, *w1, *w2, *w3, *flags;
  void *rgb, *depth;
  int N, n_samples, chunk, block, early_stop;
  float jitter, near, dt, cut;
};

// one block per SM: it stays and walks the tiles
cudaError_t sm_count(int* n) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, dev);
}

template <int W, bool PACKED>
cudaError_t launch_tc(const RenderArgs& a, cudaStream_t s) {
  using T = TcTile<W>;
  auto kernel = render_tc_kernel<W, PACKED>;
  const int smem = T::SMEM + kNWG * Repair<W>::WORDS * 4;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int tiles = (a.N + T::TR - 1) / T::TR;
  kernel<<<tiles < sms ? tiles : sms, kNWG * kWG, smem, s>>>(
      static_cast<const float*>(a.oe), static_cast<const float*>(a.de),
      static_cast<const float*>(a.df), static_cast<const __nv_bfloat16*>(a.w1),
      static_cast<const __nv_bfloat16*>(a.w2), static_cast<const __nv_bfloat16*>(a.w3),
      static_cast<const int*>(a.flags), static_cast<float*>(a.rgb),
      static_cast<float*>(a.depth), a.N, tiles, a.n_samples / a.chunk, a.chunk, a.block,
      a.early_stop, a.jitter, a.near, a.dt, a.cut);
  return cudaGetLastError();
}

template <int W, bool PACKED>
cudaError_t launch_f32(const RenderArgs& a, cudaStream_t s) {
  using T = F32Tile<W>;
  auto kernel = render_f32_kernel<W, PACKED>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int tiles = (a.N + T::TR - 1) / T::TR;
  kernel<<<tiles < sms ? tiles : sms, T::NWG * kWG, T::SMEM, s>>>(
      static_cast<const float*>(a.oe), static_cast<const float*>(a.de),
      static_cast<const float*>(a.df), static_cast<const uint4*>(a.w1),
      static_cast<const int*>(a.flags),
      static_cast<float*>(a.rgb), static_cast<float*>(a.depth), a.N, tiles,
      a.n_samples / a.chunk, a.chunk, a.block, a.early_stop, a.jitter, a.near, a.dt, a.cut);
  return cudaGetLastError();
}

bool bad_sizes(int N, int n_samples, int chunk, int block) {
  return N <= 0 || n_samples <= 0 || chunk <= 0 || n_samples % chunk != 0 || block <= 0;
}

}  // namespace

// oe, de, df (N, W) float32; w1, w2 (W, W) and w3 (W, 4) bf16; flags
// int32 (ceil(N / block), n_samples / chunk) or null; rgb (N, 3), depth
// (N,) float32. W 128 composites by the alpha recurrence (cut = eps); W 64
// or 32 by the packed variant's telescoped form (cut = -log eps).
// early_stop 0 turns the early stop off. render_tc_kernel.
extern "C" int render_launch(const void* oe, const void* de, const void* df, const void* w1,
                             const void* w2, const void* w3, const void* flags, void* rgb,
                             void* depth, int N, int W, int n_samples, int chunk, int block,
                             int early_stop, float jitter, float near, float dt, float cut,
                             void* stream) {
  if (bad_sizes(N, n_samples, chunk, block)) return static_cast<int>(cudaErrorInvalidValue);
  const RenderArgs a{oe, de, df, w1, w2, w3, flags, rgb, depth, N, n_samples, chunk,
                     block, early_stop, jitter, near, dt, cut};
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (W == 128)
    err = launch_tc<128, false>(a, s);
  else if (W == 64)
    err = launch_tc<64, true>(a, s);
  else if (W == 32)
    err = launch_tc<32, true>(a, s);
  return static_cast<int>(err);
}

// The float32 render (render_f32_kernel): the same operands and modes as
// render_launch, the weights as prepare_render_f32 lays them out (w1, w2
// and w3's B operands, raw float32, 2 W^2 + 8 W words).
extern "C" int render_f32_launch(const void* oe, const void* de, const void* df, const void* b,
                                 const void* flags, void* rgb, void* depth, int N, int W,
                                 int n_samples, int chunk, int block, int early_stop,
                                 float jitter, float near, float dt, float cut, void* stream) {
  if (bad_sizes(N, n_samples, chunk, block)) return static_cast<int>(cudaErrorInvalidValue);
  const RenderArgs a{oe, de, df, b, nullptr, nullptr, flags, rgb, depth, N, n_samples, chunk,
                     block, early_stop, jitter, near, dt, cut};
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (W == 128)
    err = launch_f32<128, false>(a, s);
  else if (W == 64)
    err = launch_f32<64, true>(a, s);
  else if (W == 32)
    err = launch_f32<32, true>(a, s);
  return static_cast<int>(err);
}

// The int8 variant at width 128 (render_s8_kernel): w1b, w2b (128 x 128)
// and w3b (128 x 8) int8, the B operands of prepare_render_int8; m1, m2
// (128,), r3 (4,) float32; ia2 the scale of df.
extern "C" int render_int8_launch(const void* oe, const void* de, const void* df,
                                  const void* w1b, const void* w2b, const void* w3b,
                                  const void* m1, const void* m2, const void* r3,
                                  const void* flags, void* rgb, void* depth, int N,
                                  int n_samples, int chunk, int block, int early_stop,
                                  float jitter, float near, float dt, float cut, float ia2,
                                  void* stream) {
  if (bad_sizes(N, n_samples, chunk, block)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(render_s8_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         S8Smem::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (N + TcTile<128>::TR - 1) / TcTile<128>::TR;
  render_s8_kernel<<<tiles < sms ? tiles : sms, kNWG * kWG, S8Smem::SMEM,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(oe), static_cast<const float*>(de),
      static_cast<const float*>(df), static_cast<const int8_t*>(w1b),
      static_cast<const int8_t*>(w2b), static_cast<const int8_t*>(w3b),
      static_cast<const float*>(m1), static_cast<const float*>(m2),
      static_cast<const float*>(r3), static_cast<const int*>(flags),
      static_cast<float*>(rgb), static_cast<float*>(depth), N, tiles, n_samples / chunk, chunk,
      block, early_stop, jitter, near, dt, cut, ia2);
  return static_cast<int>(cudaGetLastError());
}
