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
// serve them: render_tc_kernel the bf16 operands of every width (on the
// tensor cores), render_kernel the float32 ones and render_int8_kernel the
// int8 one (on the CUDA cores); the head is the (W, 4) product that holds
// sigma and rgb, and the outputs are (N, 3) and (N,).
//
// Bound on an H100 SXM: operations. A render of 131,072 rays x 32 samples
// at width 128 needs 2 * (2 * 128^2 + 4 * 128) multiply-adds per sample,
// 279 GFLOP, against 201 MB of rays in and 2 MB out: 0.28 ms at the bf16
// tensor-core rate against 0.06 ms of memory time. Beside the products
// stand 537 M sines (one per ray, sample and lane), some 25 CUDA-core
// instructions each, which no tensor core takes: they and the repair of
// undecided sums (below), not the products, set the pace of
// render_tc_kernel.
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
// render_kernel (float32). A block of 256 threads owns a tile of 8192 / W
// rays and walks their samples in order; both weight matrices sit in
// shared memory, the activations in two k-major buffers ([k][ray], row
// stride rays + 4 words); a thread of the product loop owns 4 rays x 8
// columns and runs float32 FMAs (the tensor cores form no exact float32
// product), three barriers a sample. One thread per ray computes the
// 4-wide head and carries the compositing state. render_int8_kernel is
// the same with __dp4a on words of 4 int8 values.
//
// Skipping. A flag covers `block` consecutive rays and `chunk` samples; a
// ray composites a chunk only if its own flag is set, whatever tile it is
// in. The early stop works on the tile: a chunk is computed only if some
// ray of the tile whose flag is set still has transmittance above eps (for
// the packed variant: optical depth below -log eps); the first chunk always
// is. Rays past N are neither read nor written.
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
// kernel adds by FMAs in k order throughout.
// int8: rintf (half to even), clip before the round, acc * m2 + df * ia2
// as two rounded products and a rounded sum. No --use_fast_math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "conv_tc.cuh"
#include "render_common.cuh"

namespace {

using spnerf::render::sine;
using spnerf::render::stage_weights;
using spnerf::render::wgmma_bf16;
using spnerf::tc::fence_regs;
using spnerf::tc::smem_desc;
using spnerf::tc::smem_u32;
using spnerf::tc::wgmma_commit;
using spnerf::tc::wgmma_fence;
using spnerf::tc::wgmma_wait0;

constexpr int kThreads = 256;
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

// two bf16 to nearest even in one word, lo in the low half (an A-fragment
// register: lo the lower column); relu also clamps negatives to 0
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}
__device__ __forceinline__ uint32_t bf16x2_relu(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
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

// ---- float32 and int8 on the CUDA cores ----

template <int W>
struct Tile {
  static constexpr int TR = kTileElems / W;    // rays of a tile
  static constexpr int TRP = TR + 4;           // row stride of a k-major buffer
  static constexpr int TX = W / 8;             // threads across the columns
  static constexpr int LTX = TX < 8 ? TX : 8;  // of them within a warp
  static constexpr int LTY = 32 / LTX;
  static constexpr int WTX = TX / LTX;
  static constexpr int UNITS = TR * W / 4 / kThreads;  // (ray, 4 k) per thread
};

struct ThreadPos {
  int tx, ty;
};

template <int W>
__device__ __forceinline__ ThreadPos thread_pos() {
  using T = Tile<W>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  return {(warp % T::WTX) * T::LTX + lane % T::LTX,
          (warp / T::WTX) * T::LTY + lane / T::LTX};
}

// The encoding's operands of this thread's (ray, 4 k) units, kept in
// registers for the tile's life: unit u = tid + 256 i is ray u % TR (so a
// warp writes 32 consecutive rays of one k: no bank conflict) and k group
// u / TR. Rays past N read zeros.
template <int W>
__device__ __forceinline__ void load_units(const float* __restrict__ oe,
                                           const float* __restrict__ de, int row0, int N,
                                           float4 (&oe_r)[Tile<W>::UNITS],
                                           float4 (&de_r)[Tile<W>::UNITS]) {
  using T = Tile<W>;
#pragma unroll
  for (int i = 0; i < T::UNITS; ++i) {
    const int u = threadIdx.x + kThreads * i;
    const int ray = row0 + u % T::TR, k4 = u / T::TR;
    oe_r[i] = de_r[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ray < N) {
      const size_t at = static_cast<size_t>(ray) * W + 4 * k4;
      oe_r[i] = __ldg(reinterpret_cast<const float4*>(oe + at));
      de_r[i] = __ldg(reinterpret_cast<const float4*>(de + at));
    }
  }
}

// out[c][ray] = relu(sum_k in[k][ray] * wm[k][c] (+ df[ray][c])) for the
// tile, k in order; in and out are k-major buffers.
template <int W, bool ADD_DF>
__device__ __forceinline__ void float_layer(const float* __restrict__ in,
                                            const float* __restrict__ wm,
                                            float* __restrict__ out,
                                            const float* __restrict__ df, int row0, int N,
                                            ThreadPos p) {
  using T = Tile<W>;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int k = 0; k < W; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(in + k * T::TRP + 4 * p.ty);
    const float4 b0 = *reinterpret_cast<const float4*>(wm + k * W + 4 * p.tx);
    const float4 b1 = *reinterpret_cast<const float4*>(wm + k * W + W / 2 + 4 * p.tx);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int c0 = half * (W / 2) + 4 * p.tx;
    if constexpr (ADD_DF) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ray = row0 + 4 * p.ty + i;
        float4 d = make_float4(0.f, 0.f, 0.f, 0.f);
        if (ray < N) d = __ldg(reinterpret_cast<const float4*>(df + static_cast<size_t>(ray) * W + c0));
        acc[i][half * 4 + 0] = __fadd_rn(acc[i][half * 4 + 0], d.x);
        acc[i][half * 4 + 1] = __fadd_rn(acc[i][half * 4 + 1], d.y);
        acc[i][half * 4 + 2] = __fadd_rn(acc[i][half * 4 + 2], d.z);
        acc[i][half * 4 + 3] = __fadd_rn(acc[i][half * 4 + 3], d.w);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float4 v;
      v.x = fmaxf(acc[0][half * 4 + j], 0.f);
      v.y = fmaxf(acc[1][half * 4 + j], 0.f);
      v.z = fmaxf(acc[2][half * 4 + j], 0.f);
      v.w = fmaxf(acc[3][half * 4 + j], 0.f);
      *reinterpret_cast<float4*>(out + (c0 + j) * T::TRP + 4 * p.ty) = v;
    }
  }
}

// Float32 render: W in {128, 64, 32}, PACKED the compositing form of
// render_fused_packed.
template <int W, bool PACKED>
__global__ void __launch_bounds__(kThreads, 1)
render_kernel(const float* __restrict__ oe, const float* __restrict__ de,
              const float* __restrict__ df, const float* __restrict__ w1,
              const float* __restrict__ w2, const float* __restrict__ w3,
              const int* __restrict__ flags, float* __restrict__ rgb_out,
              float* __restrict__ depth_out, int N, int n_samples, int chunk, int block,
              int early_stop, float jitter, float near, float dt, float cut) {
  using T = Tile<W>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* w1s = reinterpret_cast<float*>(smem_raw);
  float* w2s = w1s + W * W;
  float* w3s = w2s + W * W;  // (W, 4)
  float* buf = w3s + W * 4;  // two k-major buffers of W * TRP

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * T::TR;
  const ThreadPos p = thread_pos<W>();

  for (int i = tid; i < W * W; i += kThreads) {
    w1s[i] = w1[i];
    w2s[i] = w2[i];
  }
  for (int i = tid; i < W * 4; i += kThreads) w3s[i] = w3[i];

  float4 oe_r[T::UNITS], de_r[T::UNITS];
  load_units<W>(oe, de, row0, N, oe_r, de_r);

  const int my_ray = row0 + tid;
  const bool has_ray = tid < T::TR && my_ray < N;
  Composite<PACKED> comp;
  const int n_chunks = n_samples / chunk;
  int cur = 0;
  __syncthreads();

  for (int ci = 0; ci < n_chunks; ++ci) {
    const bool mine = has_ray && flag_set(flags, my_ray, block, n_chunks, ci);
    const bool want = mine && (!early_stop || ci == 0 || comp.open(cut));
    if (!__syncthreads_or(want)) continue;
    for (int s = ci * chunk; s < (ci + 1) * chunk; ++s) {
      const float t_s = sample_t(s, jitter, near, dt);
      float* x = buf + cur * (W * T::TRP);
      float* y = buf + (cur ^ 1) * (W * T::TRP);
#pragma unroll
      for (int i = 0; i < T::UNITS; ++i) {
        const int u = tid + kThreads * i;
        const int r = u % T::TR, k4 = u / T::TR;
        const float o4[4] = {oe_r[i].x, oe_r[i].y, oe_r[i].z, oe_r[i].w};
        const float d4[4] = {de_r[i].x, de_r[i].y, de_r[i].z, de_r[i].w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          x[(4 * k4 + j) * T::TRP + r] = sine(__fadd_rn(o4[j], __fmul_rn(t_s, d4[j])));
      }
      __syncthreads();
      float_layer<W, false>(x, w1s, y, nullptr, row0, N, p);
      __syncthreads();
      float_layer<W, true>(y, w2s, x, df, row0, N, p);
      __syncthreads();
      if (mine) {
        float head[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
        for (int k = 0; k < W; ++k) {
          const float a = x[k * T::TRP + tid];
          const float4 b = *reinterpret_cast<const float4*>(w3s + 4 * k);
          head[0] = fmaf(a, b.x, head[0]);
          head[1] = fmaf(a, b.y, head[1]);
          head[2] = fmaf(a, b.z, head[2]);
          head[3] = fmaf(a, b.w, head[3]);
        }
        comp.add(head, t_s, dt);
      }
      // the next sample encodes into the other buffer, which nothing reads
      // after this sample's second layer
      cur ^= 1;
    }
    if (mine) comp.end_chunk();
  }

  if (has_ray) comp.store(rgb_out, depth_out, my_ray);
}

// four int8 values, the first in the low byte (the order __dp4a reads)
__device__ __forceinline__ int pack4(const int q[4]) {
  const unsigned w = (static_cast<unsigned>(q[0]) & 0xFFu) |
                     ((static_cast<unsigned>(q[1]) & 0xFFu) << 8) |
                     ((static_cast<unsigned>(q[2]) & 0xFFu) << 16) |
                     (static_cast<unsigned>(q[3]) << 24);
  return static_cast<int>(w);
}

__device__ __forceinline__ int quant_act(float v) {
  return static_cast<int>(rintf(fminf(fmaxf(v, 0.f), 127.f)));
}

// int8 layer of the tile: in and out hold words of 4 consecutive k, k-major
// ([k / 4][ray]); wp holds words of 4 consecutive k per column
// ([k / 4][column]). LAYER 1: q = round(clip(relu(acc) * mult, 0, 127));
// LAYER 2: q = round(clip(relu(acc * mult + df * ia2), 0, 127)).
template <int LAYER>
__device__ __forceinline__ void int8_layer(const int* __restrict__ in,
                                           const int* __restrict__ wp, int* __restrict__ out,
                                           const float* __restrict__ mult,
                                           const float* __restrict__ df, float ia2, int row0,
                                           int N, ThreadPos p) {
  constexpr int W = 128;
  using T = Tile<W>;
  int acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0;
#pragma unroll 8
  for (int k4 = 0; k4 < W / 4; ++k4) {
    const int4 a = *reinterpret_cast<const int4*>(in + k4 * T::TRP + 4 * p.ty);
    const int4 b0 = *reinterpret_cast<const int4*>(wp + k4 * W + 4 * p.tx);
    const int4 b1 = *reinterpret_cast<const int4*>(wp + k4 * W + W / 2 + 4 * p.tx);
    const int av[4] = {a.x, a.y, a.z, a.w};
    const int bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int c0 = half * (W / 2) + 4 * p.tx;
    const float4 m4 = __ldg(reinterpret_cast<const float4*>(mult + c0));
    const float m[4] = {m4.x, m4.y, m4.z, m4.w};
    int words[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      if constexpr (LAYER == 2) {
        const int ray = row0 + 4 * p.ty + i;
        if (ray < N) {
          const float4 d4 =
              __ldg(reinterpret_cast<const float4*>(df + static_cast<size_t>(ray) * W + c0));
          d[0] = d4.x; d[1] = d4.y; d[2] = d4.z; d[3] = d4.w;
        }
      }
      int q[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int a = acc[i][half * 4 + j];
        if constexpr (LAYER == 1)
          q[j] = quant_act(__fmul_rn(static_cast<float>(max(a, 0)), m[j]));
        else
          q[j] = quant_act(fmaxf(
              __fadd_rn(__fmul_rn(static_cast<float>(a), m[j]), __fmul_rn(d[j], ia2)), 0.f));
      }
      words[i] = pack4(q);
    }
    *reinterpret_cast<int4*>(out + (c0 / 4) * T::TRP + 4 * p.ty) =
        make_int4(words[0], words[1], words[2], words[3]);
  }
}

// int8 render at width 128: w1p, w2p (32, 128) and w3p (32, 4) words of 4
// consecutive k; m1, m2 (128,) and r3 (4,) float32 rescales.
__global__ void __launch_bounds__(kThreads, 1)
render_int8_kernel(const float* __restrict__ oe, const float* __restrict__ de,
                   const float* __restrict__ df, const int* __restrict__ w1p,
                   const int* __restrict__ w2p, const int* __restrict__ w3p,
                   const float* __restrict__ m1, const float* __restrict__ m2,
                   const float* __restrict__ r3, const int* __restrict__ flags,
                   float* __restrict__ rgb_out, float* __restrict__ depth_out, int N,
                   int n_samples, int chunk, int block, int early_stop, float jitter,
                   float near, float dt, float cut, float ia2) {
  constexpr int W = 128;
  using T = Tile<W>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* w1s = reinterpret_cast<int*>(smem_raw);
  int* w2s = w1s + W / 4 * W;
  int* w3s = w2s + W / 4 * W;  // (W / 4, 4)
  int* buf = w3s + W;  // two k-major buffers of W / 4 * TRP words

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * T::TR;
  const ThreadPos p = thread_pos<W>();

  for (int i = tid; i < W / 4 * W; i += kThreads) {
    w1s[i] = w1p[i];
    w2s[i] = w2p[i];
  }
  for (int i = tid; i < W; i += kThreads) w3s[i] = w3p[i];

  float4 oe_r[T::UNITS], de_r[T::UNITS];
  load_units<W>(oe, de, row0, N, oe_r, de_r);

  const int my_ray = row0 + tid;
  const bool has_ray = tid < T::TR && my_ray < N;
  const float4 r3v = __ldg(reinterpret_cast<const float4*>(r3));
  Composite<false> comp;
  const int n_chunks = n_samples / chunk;
  int cur = 0;
  __syncthreads();

  for (int ci = 0; ci < n_chunks; ++ci) {
    const bool mine = has_ray && flag_set(flags, my_ray, block, n_chunks, ci);
    const bool want = mine && (!early_stop || ci == 0 || comp.open(cut));
    if (!__syncthreads_or(want)) continue;
    for (int s = ci * chunk; s < (ci + 1) * chunk; ++s) {
      const float t_s = sample_t(s, jitter, near, dt);
      int* x = buf + cur * (W / 4 * T::TRP);
      int* y = buf + (cur ^ 1) * (W / 4 * T::TRP);
#pragma unroll
      for (int i = 0; i < T::UNITS; ++i) {
        const int u = tid + kThreads * i;
        const int r = u % T::TR, k4 = u / T::TR;
        const float o4[4] = {oe_r[i].x, oe_r[i].y, oe_r[i].z, oe_r[i].w};
        const float d4[4] = {de_r[i].x, de_r[i].y, de_r[i].z, de_r[i].w};
        int q[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)  // sin in [-1, 1]: times 127 is symmetric int8
          q[j] = static_cast<int>(
              rintf(__fmul_rn(sine(__fadd_rn(o4[j], __fmul_rn(t_s, d4[j]))), 127.f)));
        x[k4 * T::TRP + r] = pack4(q);
      }
      __syncthreads();
      int8_layer<1>(x, w1s, y, m1, nullptr, 0.f, row0, N, p);
      __syncthreads();
      int8_layer<2>(y, w2s, x, m2, df, ia2, row0, N, p);
      __syncthreads();
      if (mine) {
        int acc[4] = {0, 0, 0, 0};
#pragma unroll 8
        for (int k4 = 0; k4 < W / 4; ++k4) {
          const int a = x[k4 * T::TRP + tid];
          const int4 b = *reinterpret_cast<const int4*>(w3s + 4 * k4);
          acc[0] = __dp4a(a, b.x, acc[0]);
          acc[1] = __dp4a(a, b.y, acc[1]);
          acc[2] = __dp4a(a, b.z, acc[2]);
          acc[3] = __dp4a(a, b.w, acc[3]);
        }
        const float head[4] = {__fmul_rn(static_cast<float>(acc[0]), r3v.x),
                               __fmul_rn(static_cast<float>(acc[1]), r3v.y),
                               __fmul_rn(static_cast<float>(acc[2]), r3v.z),
                               __fmul_rn(static_cast<float>(acc[3]), r3v.w)};
        comp.add(head, t_s, dt);
      }
      cur ^= 1;
    }
  }

  if (has_ray) comp.store(rgb_out, depth_out, my_ray);
}

struct RenderArgs {
  const void *oe, *de, *df, *w1, *w2, *w3, *flags;
  void *rgb, *depth;
  int N, n_samples, chunk, block, early_stop;
  float jitter, near, dt, cut;
};

template <int W, bool PACKED>
cudaError_t launch_float(const RenderArgs& a, cudaStream_t s) {
  using T = Tile<W>;
  const size_t smem = sizeof(float) * (2 * W * W + 4 * W + 2 * W * T::TRP);
  auto kernel = render_kernel<W, PACKED>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (a.N + T::TR - 1) / T::TR;
  kernel<<<tiles, kThreads, smem, s>>>(
      static_cast<const float*>(a.oe), static_cast<const float*>(a.de),
      static_cast<const float*>(a.df), static_cast<const float*>(a.w1),
      static_cast<const float*>(a.w2), static_cast<const float*>(a.w3),
      static_cast<const int*>(a.flags), static_cast<float*>(a.rgb),
      static_cast<float*>(a.depth), a.N, a.n_samples, a.chunk, a.block, a.early_stop, a.jitter,
      a.near, a.dt, a.cut);
  return cudaGetLastError();
}

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

bool bad_sizes(int N, int n_samples, int chunk, int block) {
  return N <= 0 || n_samples <= 0 || chunk <= 0 || n_samples % chunk != 0 || block <= 0;
}

}  // namespace

// oe, de, df (N, W) float32; w1, w2 (W, W) and w3 (W, 4) float32 (bf16 = 0)
// or bf16 (bf16 = 1); flags int32 (ceil(N / block), n_samples / chunk) or
// null; rgb (N, 3), depth (N,) float32. W 128 composites by the alpha
// recurrence (cut = eps); W 64 or 32 by the packed variant's telescoped
// form (cut = -log eps). early_stop 0 turns the early stop off. bf16 runs
// on the tensor cores (render_tc_kernel), float32 on the CUDA cores.
extern "C" int render_launch(const void* oe, const void* de, const void* df, const void* w1,
                             const void* w2, const void* w3, const void* flags, void* rgb,
                             void* depth, int N, int W, int bf16, int n_samples, int chunk,
                             int block, int early_stop, float jitter, float near, float dt,
                             float cut, void* stream) {
  if (bad_sizes(N, n_samples, chunk, block)) return static_cast<int>(cudaErrorInvalidValue);
  const RenderArgs a{oe, de, df, w1, w2, w3, flags, rgb, depth, N, n_samples, chunk,
                     block, early_stop, jitter, near, dt, cut};
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (W == 128)
    err = bf16 ? launch_tc<128, false>(a, s) : launch_float<128, false>(a, s);
  else if (W == 64)
    err = bf16 ? launch_tc<64, true>(a, s) : launch_float<64, true>(a, s);
  else if (W == 32)
    err = bf16 ? launch_tc<32, true>(a, s) : launch_float<32, true>(a, s);
  return static_cast<int>(err);
}

// The int8 variant at width 128: w1p, w2p (32, 128) and w3p (32, 4) int32
// words of 4 consecutive input channels; m1, m2 (128,), r3 (4,) float32.
extern "C" int render_int8_launch(const void* oe, const void* de, const void* df,
                                  const void* w1p, const void* w2p, const void* w3p,
                                  const void* m1, const void* m2, const void* r3,
                                  const void* flags, void* rgb, void* depth, int N,
                                  int n_samples, int chunk, int block, int early_stop,
                                  float jitter, float near, float dt, float cut, float ia2,
                                  void* stream) {
  if (bad_sizes(N, n_samples, chunk, block)) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int W = 128;
  using T = Tile<W>;
  const size_t smem = sizeof(int) * (2 * (W / 4) * W + W + 2 * (W / 4) * T::TRP);
  cudaError_t err = cudaFuncSetAttribute(render_int8_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (N + T::TR - 1) / T::TR;
  render_int8_kernel<<<tiles, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(oe), static_cast<const float*>(de),
      static_cast<const float*>(df), static_cast<const int*>(w1p),
      static_cast<const int*>(w2p), static_cast<const int*>(w3p),
      static_cast<const float*>(m1), static_cast<const float*>(m2),
      static_cast<const float*>(r3), static_cast<const int*>(flags),
      static_cast<float*>(rgb), static_cast<float*>(depth), N, n_samples, chunk, block,
      early_stop, jitter, near, dt, cut, ia2);
  return static_cast<int>(cudaGetLastError());
}
