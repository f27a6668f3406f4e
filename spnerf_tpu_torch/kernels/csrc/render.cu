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
// recurrence into triangular matmuls, all for the MXU. Here one kernel
// template serves the three float variants and a second the int8 one; the
// head is the (W, 4) product that holds sigma and rgb, and the outputs are
// (N, 3) and (N,).
//
// Bound on an H100 SXM: operations. A render of 131,072 rays x 32 samples
// at width 128 needs 2 * (2 * 128^2 + 4 * 128) multiply-adds per sample,
// 279 GFLOP, against 201 MB of rays in and 2 MB out: 0.28 ms at the bf16
// tensor-core rate against 0.06 ms of memory time. This first version does
// the products with float32 FMAs (exact for bf16 operands, whose products
// fit float32) and __dp4a, outside the tensor cores.
//
// Design: a block of 256 threads owns a tile of 8192 / W consecutive rays
// (64, 128 or 256) and walks their samples in order. Both weight matrices
// sit in shared memory for the block's life (as float32: a bf16 weight is
// widened once, exactly). Per sample the tile's activations live in two
// shared buffers stored k-major, [k][ray] with a row stride of rays + 4
// words: a thread of the product loop owns 4 rays x 8 columns and reads one
// float4 of activations and two float4 of weights per k for 32 FMAs, all
// three reads and the epilogue's float4 stores free of bank conflicts (a
// warp spans 8 column groups x 4 ray groups). The k loop runs in order, so
// two runs give the same bits. The buffers alternate between samples, which
// leaves three barriers per sample. One thread per ray computes the 4-wide
// head and carries the compositing state in registers for the whole ray.
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
// t_s = near + (s + jitter) * dt, the argument oe + t_s * de, sinf on it
// directly (|argument| stays below sinf's slow path at 105,615). The
// encoding and both hidden activations are rounded to the operand type
// before each product; the packed variant also rounds the head, and takes
// its weights from the telescoped form exp(-tau) - exp(-(tau + sigma dt))
// with tau split into a carried part and the chunk's prefix, as the
// reference's triangular matmul does. int8: rintf (half to even), clip
// before the round, acc * m2 + df * ia2 as two rounded products and a
// rounded sum. No --use_fast_math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kTileElems = 8192;  // rays of a tile x width

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

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <bool BF16>
__device__ __forceinline__ float round_op(float v) {
  if constexpr (BF16) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

__device__ __forceinline__ float sample_t(int s, float jitter, float near, float dt) {
  return __fadd_rn(near, __fmul_rn(__fadd_rn(static_cast<float>(s), jitter), dt));
}

__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x)));
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

  __device__ __forceinline__ void add(const float head[4], float t_s, float dt) {
    float w;
    if constexpr (PACKED) {
      const float sig = __fmul_rn(fmaxf(head[0], 0.f), dt);
      const float e1 = expf(-__fadd_rn(csum, tau));
      w = __fsub_rn(e1, __fmul_rn(e1, expf(-sig)));
      csum = __fadd_rn(csum, sig);
    } else {
      const float alpha = __fsub_rn(1.f, expf(__fmul_rn(-fmaxf(head[0], 0.f), dt)));
      w = __fmul_rn(trans, alpha);
      trans = __fmul_rn(trans, __fsub_rn(1.f, alpha));
    }
#pragma unroll
    for (int c = 0; c < 3; ++c)
      rgb[c] = __fadd_rn(rgb[c], __fmul_rn(w, sigmoid(head[1 + c])));
    depth = __fadd_rn(depth, __fmul_rn(w, t_s));
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

// out[c][ray] = round(relu(sum_k in[k][ray] * wm[k][c] (+ df[ray][c]))) for
// the tile, k in order; in and out are k-major buffers.
template <int W, bool BF16, bool ADD_DF>
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
      v.x = round_op<BF16>(fmaxf(acc[0][half * 4 + j], 0.f));
      v.y = round_op<BF16>(fmaxf(acc[1][half * 4 + j], 0.f));
      v.z = round_op<BF16>(fmaxf(acc[2][half * 4 + j], 0.f));
      v.w = round_op<BF16>(fmaxf(acc[3][half * 4 + j], 0.f));
      *reinterpret_cast<float4*>(out + (c0 + j) * T::TRP + 4 * p.ty) = v;
    }
  }
}

// Float render: W in {128, 64, 32}, WT the weights' type (float or bf16,
// which is also what the activations are rounded to), PACKED the
// compositing form of render_fused_packed.
template <int W, typename WT, bool PACKED>
__global__ void __launch_bounds__(kThreads, 1)
render_kernel(const float* __restrict__ oe, const float* __restrict__ de,
              const float* __restrict__ df, const WT* __restrict__ w1,
              const WT* __restrict__ w2, const WT* __restrict__ w3,
              const int* __restrict__ flags, float* __restrict__ rgb_out,
              float* __restrict__ depth_out, int N, int n_samples, int chunk, int block,
              int early_stop, float jitter, float near, float dt, float cut) {
  using T = Tile<W>;
  constexpr bool BF16 = !std::is_same<WT, float>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* w1s = reinterpret_cast<float*>(smem_raw);
  float* w2s = w1s + W * W;
  float* w3s = w2s + W * W;  // (W, 4)
  float* buf = w3s + W * 4;  // two k-major buffers of W * TRP

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * T::TR;
  const ThreadPos p = thread_pos<W>();

  for (int i = tid; i < W * W; i += kThreads) {
    w1s[i] = widen(w1[i]);
    w2s[i] = widen(w2[i]);
  }
  for (int i = tid; i < W * 4; i += kThreads) w3s[i] = widen(w3[i]);

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
          x[(4 * k4 + j) * T::TRP + r] =
              round_op<BF16>(sinf(__fadd_rn(o4[j], __fmul_rn(t_s, d4[j]))));
      }
      __syncthreads();
      float_layer<W, BF16, false>(x, w1s, y, nullptr, row0, N, p);
      __syncthreads();
      float_layer<W, BF16, true>(y, w2s, x, df, row0, N, p);
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
        if constexpr (PACKED) {
#pragma unroll
          for (int c = 0; c < 4; ++c) head[c] = round_op<BF16>(head[c]);
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
              rintf(__fmul_rn(sinf(__fadd_rn(o4[j], __fmul_rn(t_s, d4[j]))), 127.f)));
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

template <int W, typename WT, bool PACKED>
cudaError_t launch_float(const RenderArgs& a, cudaStream_t s) {
  using T = Tile<W>;
  const size_t smem = sizeof(float) * (2 * W * W + 4 * W + 2 * W * T::TRP);
  auto kernel = render_kernel<W, WT, PACKED>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (a.N + T::TR - 1) / T::TR;
  kernel<<<tiles, kThreads, smem, s>>>(
      static_cast<const float*>(a.oe), static_cast<const float*>(a.de),
      static_cast<const float*>(a.df), static_cast<const WT*>(a.w1),
      static_cast<const WT*>(a.w2), static_cast<const WT*>(a.w3),
      static_cast<const int*>(a.flags), static_cast<float*>(a.rgb),
      static_cast<float*>(a.depth), a.N, a.n_samples, a.chunk, a.block, a.early_stop, a.jitter,
      a.near, a.dt, a.cut);
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
// form (cut = -log eps). early_stop 0 turns the early stop off.
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
    err = bf16 ? launch_float<128, __nv_bfloat16, false>(a, s) : launch_float<128, float, false>(a, s);
  else if (W == 64)
    err = bf16 ? launch_float<64, __nv_bfloat16, true>(a, s) : launch_float<64, float, true>(a, s);
  else if (W == 32)
    err = bf16 ? launch_float<32, __nv_bfloat16, true>(a, s) : launch_float<32, float, true>(a, s);
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
