// Instant-NGP's two width-64 MLPs (models/ngp.py), forward and backward,
// each one kernel that keeps every activation on chip, for Hopper (sm_90a).
//
// Replaces no kernel of the JAX package, which has no NGP; added to take
// the field's five bf16 products and their elementwise glue (casts, cat,
// ReLUs, exp/clamp, sigmoid; each a pass over a [n, 64] activation in
// device memory) off the training step.
//
// The function, a sample at a time (weights [out, in], no biases):
//   density: h1 = relu(feat W0^T) [64], z = h1 W1^T [16], sigma = exp(clamp(z_0, +-15));
//   colour:  h2 = relu([z, sh] W2^T), h3 = relu(h2 W3^T), rgb = sigmoid(h3 W4^T) [3].
// Every product's operands are bf16 and its sums float32, rounded where the
// torch.mm path rounds (each layer's input, [z, sh], the backward's output
// gradients); z_0, the outputs, d_feat and the weight gradients stay float32.
//
// N6 ngp_mlp_fwd_kernel: feat [n, nf] and sh [n, 16] (float32) -> sigma [n],
// rgb [n, 3] (float32); nf = 2 x the hash levels, even, at most 32 (the
// published 16 levels fill it; fewer are padded with zero columns).  N7 ngp_mlp_bwd_kernel: the same inputs and the
// outputs' gradients -> d_feat [n, nf] (float32) and one float32 partial of
// the five weights' gradients a block, which ngp_mlp_reduce_kernel sums in
// a fixed order (no float atomics: two launches give the same bits).  Rows
// at or past n_valid[0] (null: n) read no input, give sigma 0, rgb 0,
// d_feat 0 and add nothing to the weights' gradients.
//
// What bounds them on an H100: bytes.  At 2^18 samples the forward streams
// 50 MB in and 4 MB out, the backward 54 MB in and 33.5 MB out: 145 MB, 43 us
// at 3.35 TB/s, against 19.7 GFLOP (forward, the backward's recompute, the
// inputs' and the weights' gradients), 20 us at 989 TFLOP/s.  The design
// keeps everything else on chip:
// - the five bf16 weight matrices (24 KB padded) are staged once a block
//   into shared memory from the float32 parameters; persistent blocks;
// - a warp carries 16 samples through every layer in registers: each
//   mma.sync m16n8k16 accumulator, rounded to bf16, is the next product's
//   A fragment as it lies (the accumulator's row/column pairs are the A
//   layout); B fragments come from the staged weights by ldmatrix (.trans
//   for the backward's W, so one copy serves both directions);
// - a warp loads its next 16 samples' inputs (and, backward, the outputs'
//   gradients) a tile ahead into registers, by 8-byte streaming loads at
//   the A fragments' places: the forward before it computes the current
//   16, the backward while its block sums the weight gradients;
// - the backward recomputes the forward in registers (a stash of h1, h2,
//   h3 would be ~200 MB a step), then runs the output gradients back
//   through the transposed weights, writing d_feat once;
// - the weight gradients dY^T X sum over samples: each warp writes its 16
//   samples' bf16 X and dY into a 64-sample stage in shared memory, and
//   warp w accumulates the w-th 16 rows of every weight's gradient (dW for
//   W0, W2, W3; dW^T for W1, W4, so that each has 64 rows) over the stage's
//   64 samples in registers (76 floats a thread), reading both operands by
//   ldmatrix.trans; the block writes its partial once at the end.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kFeat = 32, kWidth = 64, kGeo = 16, kSh = 16, kOut = 3;
// the weights in the flat gradient: W0 [64, 32] (its columns past nf 0),
// W1 [16, 64], W2 [64, 32], W3 [64, 64], W4 [3, 64], each row-major
constexpr int kOff0 = 0, kOff1 = 2048, kOff2 = 3072, kOff3 = 5120, kOff4 = 9216;
constexpr int kWTotal = 9408;
// the staged weights, bf16 [rows][cols + 8] (the 8 keep ldmatrix's rows on
// distinct banks); W4 padded to 16 rows of zeros
constexpr int kS32 = kFeat + 8, kS64 = kWidth + 8, kS16 = kGeo + 8;
constexpr int kSw0 = 0, kSw1 = kSw0 + 64 * kS32, kSw2 = kSw1 + 16 * kS64,
              kSw3 = kSw2 + 64 * kS32, kSw4 = kSw3 + 64 * kS64, kSwTotal = kSw4 + 16 * kS64;
// the backward's stage of 64 samples (bf16): inputs X_l and output
// gradients D_l of the five layers
constexpr int kTile = 64;
constexpr int kX1 = 0, kX2 = kX1 + kTile * kS32, kX3 = kX2 + kTile * kS64,
              kX4 = kX3 + kTile * kS32, kX5 = kX4 + kTile * kS64, kD1 = kX5 + kTile * kS64,
              kD2 = kD1 + kTile * kS64, kD3 = kD2 + kTile * kS16, kD4 = kD3 + kTile * kS64,
              kD5 = kD4 + kTile * kS64, kStageTotal = kD5 + kTile * kS16;
constexpr int kFwdThreads = 256, kBwdThreads = 128;   // 16 samples a warp
constexpr int kBwdSmem = (kSwTotal + kStageTotal) * 2;
constexpr float kClamp = 15.0f;

// ------------------------------------------------------------ primitives

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

// d += a b: a 16x16 bf16 (row), b 16x8 bf16 (col), d 16x8 float32
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// the gradient pair (x, y) where the ReLU's bf16 output pair h is positive
__device__ __forceinline__ uint32_t pack_masked(float x, float y, uint32_t h) {
  const float2 f = unpack(h);
  return pack(f.x > 0.0f ? x : 0.0f, f.y > 0.0f ? y : 0.0f);
}

// ------------------------------------------------------------ fragments
//
// A warp's 16 samples: lane = 4 g + t holds rows g and g + 8.  An
// accumulator c[nt] (columns 8 nt ..) holds (g, 8 nt + 2t, +1) in c[0..1]
// and (g + 8, ..) in c[2..3]; an A fragment a[ks] (columns 16 ks ..) holds
// (g, 16 ks + 2t) in a[0], (g + 8, ..) in a[1], (g, 16 ks + 8 + 2t) in a[2]
// and (g + 8, ..) in a[3], each a bf16 pair.

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int i = 0; i < NT; ++i) c[i][0] = c[i][1] = c[i][2] = c[i][3] = 0.0f;
}

// accumulators [16, 8 NT] -> A fragments, rounded to bf16 (after a ReLU)
template <int NT, bool kRelu>
__device__ __forceinline__ void to_a(uint32_t (&a)[NT / 2][4], const float (&c)[NT][4]) {
#pragma unroll
  for (int ks = 0; ks < NT / 2; ++ks) {
    const float* lo = c[2 * ks];
    const float* hi = c[2 * ks + 1];
    if (kRelu) {
      a[ks][0] = pack(fmaxf(lo[0], 0.0f), fmaxf(lo[1], 0.0f));
      a[ks][1] = pack(fmaxf(lo[2], 0.0f), fmaxf(lo[3], 0.0f));
      a[ks][2] = pack(fmaxf(hi[0], 0.0f), fmaxf(hi[1], 0.0f));
      a[ks][3] = pack(fmaxf(hi[2], 0.0f), fmaxf(hi[3], 0.0f));
    } else {
      a[ks][0] = pack(lo[0], lo[1]);
      a[ks][1] = pack(lo[2], lo[3]);
      a[ks][2] = pack(hi[0], hi[1]);
      a[ks][3] = pack(hi[2], hi[3]);
    }
  }
}

// gradients at a ReLU's output -> A fragments of the gradients at its input
template <int NT>
__device__ __forceinline__ void to_a_masked(uint32_t (&a)[NT / 2][4], const float (&c)[NT][4],
                                            const uint32_t (&h)[NT / 2][4]) {
#pragma unroll
  for (int ks = 0; ks < NT / 2; ++ks) {
    a[ks][0] = pack_masked(c[2 * ks][0], c[2 * ks][1], h[ks][0]);
    a[ks][1] = pack_masked(c[2 * ks][2], c[2 * ks][3], h[ks][1]);
    a[ks][2] = pack_masked(c[2 * ks + 1][0], c[2 * ks + 1][1], h[ks][2]);
    a[ks][3] = pack_masked(c[2 * ks + 1][2], c[2 * ks + 1][3], h[ks][3]);
  }
}

// c = a W^T: a [16, 16 KS], W staged [8 NT][16 KS] (rows = outputs)
template <int KS, int NT>
__device__ __forceinline__ void forward(float (&c)[NT][4], const uint32_t (&a)[KS][4],
                                        const bf16* w, int stride, int lane) {
  zero(c);
  const uint32_t base = smem_addr(w);
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int nt = 0; nt + 1 < NT; nt += 2) {
      uint32_t b[4];
      const int row = nt * 8 + (lane & 7) + ((lane >> 4) << 3);
      const int col = ks * 16 + ((lane >> 3) & 1) * 8;
      ldsm_x4(b, base + (row * stride + col) * 2);
      mma(c[nt], a[ks], b[0], b[1]);
      mma(c[nt + 1], a[ks], b[2], b[3]);
    }
    if (NT & 1) {
      uint32_t b[2];
      const int row = (NT - 1) * 8 + (lane & 7);
      const int col = ks * 16 + ((lane >> 3) & 1) * 8;
      ldsm_x2(b, base + (row * stride + col) * 2);
      mma(c[NT - 1], a[ks], b[0], b[1]);
    }
  }
}

// c = a W: a [16, 16 KS] (gradients at W's outputs), W staged [16 KS][8 NT]
template <int KS, int NT>
__device__ __forceinline__ void backward(float (&c)[NT][4], const uint32_t (&a)[KS][4],
                                         const bf16* w, int stride, int lane) {
  static_assert(NT % 2 == 0, "backward products are 32 or 64 wide");
  zero(c);
  const uint32_t base = smem_addr(w);
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
      uint32_t b[4];
      const int row = ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      const int col = (nt + (lane >> 4)) * 8;
      ldsm_x4_t(b, base + (row * stride + col) * 2);
      mma(c[nt], a[ks], b[0], b[1]);
      mma(c[nt + 1], a[ks], b[2], b[3]);
    }
  }
}

// acc [16, 8 NT] += P[:, m0 .. m0 + 16]^T Q over the stage's 64 samples
// (P, Q staged [64][cols], row = sample)
template <int NT>
__device__ __forceinline__ void wgrad(float (&acc)[NT][4], const bf16* p, int sp, const bf16* q,
                                      int sq, int m0, int lane) {
  const uint32_t pb = smem_addr(p), qb = smem_addr(q);
#pragma unroll
  for (int ks = 0; ks < kTile / 16; ++ks) {
    uint32_t a[4];
    {
      const int j = lane >> 3;
      const int row = ks * 16 + (j >> 1) * 8 + (lane & 7);
      const int col = m0 + (j & 1) * 8;
      ldsm_x4_t(a, pb + (row * sp + col) * 2);
    }
#pragma unroll
    for (int nt = 0; nt + 1 < NT; nt += 2) {
      uint32_t b[4];
      const int j = lane >> 3;
      const int row = ks * 16 + (j & 1) * 8 + (lane & 7);
      const int col = (nt + (j >> 1)) * 8;
      ldsm_x4_t(b, qb + (row * sq + col) * 2);
      mma(acc[nt], a, b[0], b[1]);
      mma(acc[nt + 1], a, b[2], b[3]);
    }
    if (NT & 1) {
      uint32_t b[2];
      const int row = ks * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
      ldsm_x2_t(b, qb + (row * sq + (NT - 1) * 8) * 2);
      mma(acc[NT - 1], a, b[0], b[1]);
    }
  }
}

// a warp's A fragments [16, 16 KS] into the stage's rows (row 0 = the warp's first)
template <int KS>
__device__ __forceinline__ void stage_a(bf16* s, int stride, const uint32_t (&a)[KS][4], int g,
                                        int t) {
  uint32_t* r0 = reinterpret_cast<uint32_t*>(s + g * stride);
  uint32_t* r1 = reinterpret_cast<uint32_t*>(s + (g + 8) * stride);
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    r0[8 * ks + t] = a[ks][0];
    r1[8 * ks + t] = a[ks][1];
    r0[8 * ks + 4 + t] = a[ks][2];
    r1[8 * ks + 4 + t] = a[ks][3];
  }
}

// A warp's inputs for 16 samples as they come from device memory, loaded a
// tile ahead of their use: the features' and SH's pairs at the A
// fragments' places (zero at or past valid, and past nf), and the outputs'
// gradients (backward) at the lanes that use them: t = 0 sigma's and rgb
// 0, 1; t = 1 rgb 2.
struct Inputs {
  float2 feat[2][4];
  float2 sh[4];
  float g_sigma[2];
  float g_rgb[2][2];
};

template <bool kGrads>
__device__ __forceinline__ void load_inputs(Inputs& in, const float* __restrict__ feat, int nf,
                                            const float* __restrict__ sh,
                                            const float* __restrict__ g_sigma,
                                            const float* __restrict__ g_rgb, long row0,
                                            int valid, int g, int t) {
  const float2 zero2 = make_float2(0.0f, 0.0f);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long r = row0 + g + 8 * h;
    const bool v = r < valid;
#pragma unroll
    for (int q = 0; q < 4; ++q) {      // columns 8 q + 2t: A fragment (q / 2, 2 (q % 2) + h)
      const int c = 8 * q + 2 * t;
      in.feat[q >> 1][2 * (q & 1) + h] =
          v && c < nf ? __ldcs(reinterpret_cast<const float2*>(feat + r * nf + c)) : zero2;
    }
#pragma unroll
    for (int q = 0; q < 2; ++q)
      in.sh[2 * q + h] = v ? __ldcs(reinterpret_cast<const float2*>(sh + r * kSh + 8 * q + 2 * t))
                           : zero2;
    if (kGrads) {
      in.g_sigma[h] = v && t == 0 ? g_sigma[r] : 0.0f;
      in.g_rgb[h][0] = v && t < 2 ? g_rgb[3 * r + 2 * t] : 0.0f;
      in.g_rgb[h][1] = v && t == 0 ? g_rgb[3 * r + 1] : 0.0f;
    }
  }
}

struct Weights {
  const float* w[5];
};

// one float32 weight [rows, cols] -> bf16 [kRows][kCols + 8] in shared
// memory, zero past rows and cols: every load of a thread issued before
// any store, so that a block waits for the L2 once a matrix
template <int kThreads, int kRows, int kCols>
__device__ __forceinline__ void stage_matrix(bf16* s, const float* __restrict__ w, int rows,
                                             int cols) {
  constexpr int kN = kRows * kCols, kIter = (kN + kThreads - 1) / kThreads;
  float v[kIter];
#pragma unroll
  for (int j = 0; j < kIter; ++j) {
    const int i = threadIdx.x + j * kThreads, r = i / kCols, k = i % kCols;
    v[j] = i < kN && r < rows && k < cols ? __ldg(w + r * cols + k) : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < kIter; ++j) {
    const int i = threadIdx.x + j * kThreads;
    if (i < kN) s[(i / kCols) * (kCols + 8) + i % kCols] = __float2bfloat16_rn(v[j]);
  }
}

// the five weights (W0's columns past nf and W4's rows 3..15 zero)
template <int kThreads>
__device__ __forceinline__ void stage_weights(bf16* sw, const Weights& wt, int nf) {
  stage_matrix<kThreads, 64, kFeat>(sw + kSw0, wt.w[0], 64, nf);
  stage_matrix<kThreads, 16, kWidth>(sw + kSw1, wt.w[1], 16, kWidth);
  stage_matrix<kThreads, 64, kGeo + kSh>(sw + kSw2, wt.w[2], 64, kGeo + kSh);
  stage_matrix<kThreads, 64, kWidth>(sw + kSw3, wt.w[3], 64, kWidth);
  stage_matrix<kThreads, 16, kWidth>(sw + kSw4, wt.w[4], kOut, kWidth);
}

// The forward of a warp's 16 samples; what the backward needs stays in the
// caller's registers.
struct Forward {
  uint32_t x1[2][4];   // feat
  uint32_t h1[4][4];   // relu(feat W0^T)
  uint32_t x3[2][4];   // [z, sh]
  uint32_t h2[4][4];
  uint32_t h3[4][4];
  float z0[2];         // z_0 of rows g, g + 8 (lanes t = 0)
  float o[4];          // h3 W4^T: (g, 2t, 2t + 1), (g + 8, ..)
};

__device__ __forceinline__ void run_forward(Forward& f, const Inputs& in, const bf16* sw,
                                            int lane) {
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) f.x1[ks][i] = pack(in.feat[ks][i].x, in.feat[ks][i].y);
#pragma unroll
  for (int i = 0; i < 4; ++i) f.x3[1][i] = pack(in.sh[i].x, in.sh[i].y);
  {
    float c[8][4];
    forward<2, 8>(c, f.x1, sw + kSw0, kS32, lane);
    to_a<8, true>(f.h1, c);
  }
  {
    float c[2][4];
    forward<4, 2>(c, f.h1, sw + kSw1, kS64, lane);
    f.z0[0] = c[0][0];
    f.z0[1] = c[0][2];
    uint32_t z[1][4];
    to_a<2, false>(z, c);
#pragma unroll
    for (int i = 0; i < 4; ++i) f.x3[0][i] = z[0][i];
  }
  {
    float c[8][4];
    forward<2, 8>(c, f.x3, sw + kSw2, kS32, lane);
    to_a<8, true>(f.h2, c);
    forward<4, 8>(c, f.h2, sw + kSw3, kS64, lane);
    to_a<8, true>(f.h3, c);
  }
  {
    float c[1][4];
    forward<4, 1>(c, f.h3, sw + kSw4, kS64, lane);
#pragma unroll
    for (int i = 0; i < 4; ++i) f.o[i] = c[0][i];
  }
}

__device__ __forceinline__ float sigma_of(float z0) {
  return expf(fminf(fmaxf(z0, -kClamp), kClamp));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// ------------------------------------------------------------ kernels

__global__ void __launch_bounds__(kFwdThreads)
ngp_mlp_fwd_kernel(const float* __restrict__ feat, int nf, const float* __restrict__ sh, int n,
                   const int* __restrict__ n_valid, Weights wt, float* __restrict__ sigma,
                   float* __restrict__ rgb) {
  __shared__ __align__(16) bf16 sw[kSwTotal];
  stage_weights<kFwdThreads>(sw, wt, nf);
  __syncthreads();
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int valid = n_valid ? min(*n_valid, n) : n;
  const long stride = (long)gridDim.x * (kFwdThreads / 32);
  long mt = (long)blockIdx.x * (kFwdThreads / 32) + (threadIdx.x >> 5);
  Inputs next;                          // the warp's next 16 samples, loaded ahead
  if (mt * 16 < valid)
    load_inputs<false>(next, feat, nf, sh, nullptr, nullptr, mt * 16, valid, g, t);
  for (; mt * 16 < n; mt += stride) {
    const long row0 = mt * 16;
    const Inputs in = next;
    if ((mt + stride) * 16 < valid)
      load_inputs<false>(next, feat, nf, sh, nullptr, nullptr, (mt + stride) * 16, valid, g, t);
    float out[2][3] = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};   // sigma, rgb 2t, 2t + 1
    if (row0 < valid) {
      Forward f;
      run_forward(f, in, sw, lane);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool v = row0 + g + 8 * h < valid;
        out[h][0] = v ? sigma_of(f.z0[h]) : 0.0f;
        out[h][1] = v ? sigmoid(f.o[2 * h]) : 0.0f;
        out[h][2] = v ? sigmoid(f.o[2 * h + 1]) : 0.0f;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long r = row0 + g + 8 * h;
      if (r >= n) continue;
      if (t == 0) {
        sigma[r] = out[h][0];
        rgb[3 * r] = out[h][1];
        rgb[3 * r + 1] = out[h][2];
      } else if (t == 1) {
        rgb[3 * r + 2] = out[h][1];
      }
    }
  }
}

__global__ void __launch_bounds__(kBwdThreads, 2)
ngp_mlp_bwd_kernel(const float* __restrict__ feat, int nf, const float* __restrict__ sh,
                   const float* __restrict__ g_sigma, const float* __restrict__ g_rgb, int n,
                   const int* __restrict__ n_valid, Weights wt, float* __restrict__ d_feat,
                   float* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sw = reinterpret_cast<bf16*>(smem_raw);
  bf16* st = sw + kSwTotal;
  stage_weights<kBwdThreads>(sw, wt, nf);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int valid = n_valid ? min(*n_valid, n) : n;
  const int m0 = 16 * warp;             // this warp's rows of every weight gradient
  float a0[4][4], a1[2][4], a2[4][4], a3[8][4], a4[1][4];
  zero(a0);
  zero(a1);
  zero(a2);
  zero(a3);
  zero(a4);
  Inputs in;                            // this warp's 16 samples of the tile, loaded
  if ((long)blockIdx.x * kTile < valid)  // while the tile before sums its weight gradients
    load_inputs<true>(in, feat, nf, sh, g_sigma, g_rgb, (long)blockIdx.x * kTile + 16 * warp,
                      valid, g, t);
  for (long tile = blockIdx.x; tile * kTile < n; tile += gridDim.x) {
    const long row0 = tile * kTile + 16 * warp;
    if (tile * kTile >= valid) {        // the whole tile past n_valid (uniform in the block)
      for (int i = lane; i < 16 * (nf / 2); i += 32) {
        const long r = row0 + i / (nf / 2);
        if (r < n)
          reinterpret_cast<float2*>(d_feat + r * nf)[i % (nf / 2)] = make_float2(0.0f, 0.0f);
      }
      continue;
    }
    const int mr = 16 * warp;           // this warp's first row of the stage
    Forward f;
    run_forward(f, in, sw, lane);
    stage_a<2>(st + kX1 + mr * kS32, kS32, f.x1, g, t);
    stage_a<4>(st + kX2 + mr * kS64, kS64, f.h1, g, t);
    stage_a<2>(st + kX3 + mr * kS32, kS32, f.x3, g, t);
    stage_a<4>(st + kX4 + mr * kS64, kS64, f.h2, g, t);
    stage_a<4>(st + kX5 + mr * kS64, kS64, f.h3, g, t);
    // the output gradients: the sigmoid's, then back through W4
    uint32_t d5[1][4];
    float dsig[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long r = row0 + g + 8 * h;
      const bool v = r < valid;
      float d0 = 0.0f, d1 = 0.0f;
      if (v && t < 2) {
        const float s0 = sigmoid(f.o[2 * h]);
        d0 = in.g_rgb[h][0] * (s0 * (1.0f - s0));
        if (t == 0) {
          const float s1 = sigmoid(f.o[2 * h + 1]);
          d1 = in.g_rgb[h][1] * (s1 * (1.0f - s1));
        }
      }
      d5[0][h] = pack(d0, d1);
      dsig[h] = 0.0f;
      if (v && t == 0) {
        const float z0 = f.z0[h];
        if (z0 >= -kClamp && z0 <= kClamp) dsig[h] = in.g_sigma[h] * sigma_of(z0);
      }
    }
    d5[0][2] = d5[0][3] = 0u;
    {
      uint32_t* r0 = reinterpret_cast<uint32_t*>(st + kD5 + (mr + g) * kS16);
      uint32_t* r1 = reinterpret_cast<uint32_t*>(st + kD5 + (mr + g + 8) * kS16);
      r0[t] = d5[0][0];
      r1[t] = d5[0][1];
    }
    uint32_t dz[1][4];
    {
      uint32_t dh[4][4];
      float c[8][4];
      backward<1, 8>(c, d5, sw + kSw4, kS64, lane);
      to_a_masked<8>(dh, c, f.h3);
      stage_a<4>(st + kD4 + mr * kS64, kS64, dh, g, t);
      backward<4, 8>(c, dh, sw + kSw3, kS64, lane);
      to_a_masked<8>(dh, c, f.h2);
      stage_a<4>(st + kD3 + mr * kS64, kS64, dh, g, t);
      float cx[4][4];
      backward<4, 4>(cx, dh, sw + kSw2, kS32, lane);
      // z's gradient: the colour MLP's (its first 16 inputs) and sigma's
      cx[0][0] += dsig[0];
      cx[0][2] += dsig[1];
      float cz[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        cz[0][i] = cx[0][i];
        cz[1][i] = cx[1][i];
      }
      to_a<2, false>(dz, cz);
    }
    stage_a<1>(st + kD2 + mr * kS16, kS16, dz, g, t);
    {
      uint32_t dh[4][4];
      float c[8][4];
      backward<1, 8>(c, dz, sw + kSw1, kS64, lane);
      to_a_masked<8>(dh, c, f.h1);
      stage_a<4>(st + kD1 + mr * kS64, kS64, dh, g, t);
      float cf[4][4];
      backward<4, 4>(cf, dh, sw + kSw0, kS32, lane);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long r = row0 + g + 8 * h;
        if (r >= n) continue;
        const bool v = r < valid;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          if (8 * nt + 2 * t < nf)
            *reinterpret_cast<float2*>(d_feat + r * nf + 8 * nt + 2 * t) =
                v ? make_float2(cf[nt][2 * h], cf[nt][2 * h + 1]) : make_float2(0.0f, 0.0f);
      }
    }
    __syncthreads();
    const long next = tile + gridDim.x;
    if (next * kTile < valid)
      load_inputs<true>(in, feat, nf, sh, g_sigma, g_rgb, next * kTile + 16 * warp, valid, g, t);
    wgrad<4>(a0, st + kD1, kS64, st + kX1, kS32, m0, lane);   // dW0 = D1^T X1
    wgrad<2>(a1, st + kX2, kS64, st + kD2, kS16, m0, lane);   // dW1^T = X2^T D2
    wgrad<4>(a2, st + kD3, kS64, st + kX3, kS32, m0, lane);   // dW2 = D3^T X3
    wgrad<8>(a3, st + kD4, kS64, st + kX4, kS64, m0, lane);   // dW3 = D4^T X4
    wgrad<1>(a4, st + kX5, kS64, st + kD5, kS16, m0, lane);   // dW4^T = X5^T D5
    __syncthreads();
  }
  // this block's partial, [kWTotal], each weight row-major
  float* part = partial + (long)blockIdx.x * kWTotal;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + g + 8 * h;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * nt + 2 * t + e;
        const int i = 2 * h + e;
        if (nt < 4) part[kOff0 + m * kFeat + c] = a0[nt][i];
        if (nt < 2) part[kOff1 + c * kWidth + m] = a1[nt][i];
        if (nt < 4) part[kOff2 + m * (kGeo + kSh) + c] = a2[nt][i];
        part[kOff3 + m * kWidth + c] = a3[nt][i];
        if (nt < 1 && c < kOut) part[kOff4 + c * kWidth + m] = a4[nt][i];
      }
    }
  }
}

// dw[i] = the sum over blocks of partial[b][i], in the blocks' order: 32
// entries a block, 8 rows of threads each summing every 8th partial, then
// the 8 sums in order.
constexpr int kReduceRows = 8;

__global__ void __launch_bounds__(32 * kReduceRows)
ngp_mlp_reduce_kernel(const float* __restrict__ partial, int n_part, float* __restrict__ dw) {
  __shared__ float s[kReduceRows][32];
  const int i = blockIdx.x * 32 + threadIdx.x;
  float acc = 0.0f;
  if (i < kWTotal)
    for (int b = threadIdx.y; b < n_part; b += kReduceRows) acc += partial[(long)b * kWTotal + i];
  s[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && i < kWTotal) {
    float total = 0.0f;
#pragma unroll
    for (int r = 0; r < kReduceRows; ++r) total += s[r][threadIdx.x];
    dw[i] = total;
  }
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

// persistent grids: the blocks an SM holds (from the occupancy query) x SMs,
// no more than the work's units
int fwd_blocks(int n) {
  static int per_sm = 0;
  if (per_sm == 0 &&
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ngp_mlp_fwd_kernel, kFwdThreads, 0))
    per_sm = 0;
  if (per_sm < 1) return -1;
  const long units = ((long)n + kFwdThreads / 2 - 1) / (kFwdThreads / 2);
  return (int)(units < (long)per_sm * sm_count() ? units : (long)per_sm * sm_count());
}

int bwd_blocks(int n) {
  static int per_sm = 0;
  if (per_sm == 0) {
    if (cudaFuncSetAttribute(ngp_mlp_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kBwdSmem) ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ngp_mlp_bwd_kernel, kBwdThreads,
                                                      kBwdSmem))
      per_sm = 0;
  }
  if (per_sm < 1) return -1;
  const long tiles = ((long)n + kTile - 1) / kTile;
  return (int)(tiles < (long)per_sm * sm_count() ? tiles : (long)per_sm * sm_count());
}

Weights weights_of(const float* w0, const float* w1, const float* w2, const float* w3,
                   const float* w4) {
  Weights wt;
  wt.w[0] = w0;
  wt.w[1] = w1;
  wt.w[2] = w2;
  wt.w[3] = w3;
  wt.w[4] = w4;
  return wt;
}

}  // namespace

// N6: sigma [n], rgb [n, 3]
extern "C" int ngp_mlp_fwd(const float* feat, int nf, const float* sh, int n,
                           const int* n_valid, const float* w0, const float* w1, const float* w2,
                           const float* w3, const float* w4, float* sigma, float* rgb,
                           void* stream) {
  if (nf < 2 || nf > kFeat || nf % 2) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const int blocks = fwd_blocks(n);
  if (blocks < 1) return (int)cudaErrorInvalidConfiguration;
  ngp_mlp_fwd_kernel<<<blocks, kFwdThreads, 0, (cudaStream_t)stream>>>(
      feat, nf, sh, n, n_valid, weights_of(w0, w1, w2, w3, w4), sigma, rgb);
  return (int)cudaGetLastError();
}

// The backward's partials: one a block of its persistent grid (-1: the
// kernel cannot run on this device).
extern "C" int ngp_mlp_bwd_blocks(int n) { return n <= 0 ? 0 : bwd_blocks(n); }

// N7 and its reduce: d_feat [n, nf], dw [9408] (W0 as [64, 32], W1, W2, W3,
// W4, each row-major); partial holds ngp_mlp_bwd_blocks(n) x 9408 floats.
extern "C" int ngp_mlp_bwd(const float* feat, int nf, const float* sh, const float* g_sigma,
                           const float* g_rgb, int n, const int* n_valid, const float* w0,
                           const float* w1, const float* w2, const float* w3, const float* w4,
                           float* d_feat, float* partial, int n_part, float* dw, void* stream) {
  if (nf < 2 || nf > kFeat || nf % 2) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  if (n_part != bwd_blocks(n)) return (int)cudaErrorInvalidValue;
  ngp_mlp_bwd_kernel<<<n_part, kBwdThreads, kBwdSmem, (cudaStream_t)stream>>>(
      feat, nf, sh, g_sigma, g_rgb, n, n_valid, weights_of(w0, w1, w2, w3, w4), d_feat,
      partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ngp_mlp_reduce_kernel<<<(kWTotal + 31) / 32, dim3(32, kReduceRows), 0, (cudaStream_t)stream>>>(
      partial, n_part, dw);
  return (int)cudaGetLastError();
}
