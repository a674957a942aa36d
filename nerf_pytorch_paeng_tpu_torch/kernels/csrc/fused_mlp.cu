// Fused NeRF MLP for Hopper (sm_90a): four kernels.
//
//   nerf_sigma_rays   replaces the JAX package's TPU kernels
//                     kernels/fused_mlp.py::_sigma_rays_kernel (gate null) and
//                     _sigma_rays_kernel_gated (gate given): trunk + density
//                     head along rays -> sigma [S, N].
//   nerf_eval_rays    replaces kernels/fused_mlp.py::_eval_rays_kernel and
//                     _eval_rays_kernel_gated: the full field along rays ->
//                     r, g, b, sigma, each [S, N].
//   nerf_sigma_points replaces kernels/fused_mlp.py::_mlp_sigma_kernel: trunk
//                     + density head at points x [3, P] -> sigma [P] (the
//                     support-bound grids of the culled renderer).
//   nerf_eval_points  replaces kernels/fused_mlp.py::_mlp_kernel: the full
//                     field at points, x and d [3, P] -> [4, P] (r, g, b,
//                     sigma rows; the TPU kernel's [8, P] with rgb in rows
//                     0-2 and sigma in row 3, without its 4 rows of padding):
//                     the plane layout, taken where the ray kernels' shapes
//                     do not apply.
//
// Inputs: od [8, N] float32 (origin rows 0-2, unnormalised direction rows
// 3-5), z [S, N] float32 depths, the packed weights of
// nerf_pytorch_paeng_tpu_torch/kernels/fused_mlp.py (bf16, [in, out] row-major
// per layer) and float32 biases.  The optional gate is int32
// [ceil(N / 128) * (S / 8)], tile-major over (128-ray block, 8-sample row):
// where it is 0 the block skips embedding, trunk and heads for those 8
// samples and stores 0 to every output (the caller certifies that their
// density logits are <= 0, so the compositing weights do not change).
//
// What bounds it on this card: operations.  A sample costs ~0.99 MFLOP
// (sigma) or ~1.19 MFLOP (full field) of bf16 matrix products against 4 B
// of depth in and 2-8 B out, far above the ~295 FLOP/B at which an H100
// stops being limited by device memory.  The weights (~1.2 MB in bf16) do
// not fit in the 227 KB of shared memory a block can use.
//
// What the design does about it:
//  * a block owns 128 rays and walks their samples one at a time, so a step
//    is a [128 x 256] activation tile that never leaves shared memory; the
//    positions x = o + d z and their double-angle embedding are built in
//    the block from od and z (no [3, P] plane in device memory);
//  * every layer is a tensor-core product (wmma bf16 16x16x16, float32
//    accumulate): 8 warps as 4 x 2, each holding a 32 x 128 accumulator
//    tile in registers, so a layer's output can overwrite its input in
//    place after one barrier;
//  * weights stream from device memory (L2-resident after the first
//    blocks) through a double-buffered 32-row ring in shared memory filled
//    with cp.async, the next chunk in flight while the current one is
//    multiplied;
//  * the skip layer is two products into one accumulator; for the full
//    field the direction embedding and its product (plus the view bias) are
//    computed once per ray at block start and seed the view layer's
//    accumulators at every sample; when the rays alone give fewer than two
//    waves of blocks (a training batch), the samples are split over blocks
//    too, each computing its rays' direction term itself;
//  * the 1-wide density and 3-wide colour heads are dot products on the
//    CUDA cores (two threads per point), not padded tensor-core tiles;
//  * gating: the TPU grid's (ray tile, 8-sample row) step becomes a
//    128-ray block's 8 sample iterations; the gate test is the same for the
//    whole block and comes before the step's first barrier, so a gated row
//    costs a few stores.  The work bound counts the active blocks only.
//    The full field skips its per-ray view term where all of a block's
//    rows are gated;
//  * points (the grid kernel): a block takes 128 consecutive points as
//    rays with origin x, direction 0 and depth 0, so the in-block
//    embedding sees x itself, and runs one trunk and the density head;
//  * points with directions (the plane kernel): a block takes 128
//    consecutive points of both planes, so where K1 shares one direction
//    term among a ray's S samples, here every point has its own: the
//    direction embedding (of d as given: the caller's unit vectors, not
//    normalised again) and its product with wvd run once per block, 6,912
//    FLOP a point beside ~1.18 MFLOP (0.6%).  Bound by operations too: a
//    point moves 24 B in and 8-16 B out.  The planes cost ~24 B a point of
//    device memory that K1's layout avoids; a ragged last block is masked.
// First cut: no wgmma/TMA and one block per SM; the rate against the bound
// is in PERF.md.

#include "nerf_mlp_common.cuh"

namespace {

constexpr int HVD_LD = HALF + 4;    // float32 row stride

// shared memory carve-up (bytes); every region is a multiple of 128 B
constexpr int SM_ACT = TILE * ACT_LD * 2;           // 67584
constexpr int SM_EMB = TILE * EMB_LD * 2;           // 18432
constexpr int SM_HVD = TILE * HVD_LD * 4;           // 67584
constexpr int SM_RAYS = TILE * 8 * 4;               // 4096
constexpr int SM_HEADS = 1024 * 4;                  // wdens 256 + wcol 384 (+pad)
constexpr int SMEM_SIGMA = SM_ACT + SM_EMB + SM_WBUF + SM_SCRATCH + SM_RAYS + SM_HEADS;
constexpr int SMEM_EVAL = SMEM_SIGMA + SM_HVD;

struct Smem {
  bf16* act;      // [TILE][ACT_LD] hidden activations (bf16)
  bf16* emb;      // [TILE][EMB_LD] position (or direction) embedding
  bf16* wbuf;     // [2][KCHUNK][W_LD] weight ring
  float* scratch; // [8 warps][256] accumulator staging
  float* rays;    // [TILE][8]: o (0-2), d (3-5)
  float* heads;   // wdens [256], wcol [128*3]
  float* hvd;     // [TILE][HVD_LD] per-ray view term (full field only)
};

__device__ __forceinline__ Smem carve(unsigned char* base, bool with_hvd) {
  Smem s;
  s.act = reinterpret_cast<bf16*>(base);
  base += SM_ACT;
  s.emb = reinterpret_cast<bf16*>(base);
  base += SM_EMB;
  s.wbuf = reinterpret_cast<bf16*>(base);
  base += SM_WBUF;
  s.scratch = reinterpret_cast<float*>(base);
  base += SM_SCRATCH;
  s.rays = reinterpret_cast<float*>(base);
  base += SM_RAYS;
  s.heads = reinterpret_cast<float*>(base);
  base += SM_HEADS;
  s.hvd = with_hvd ? reinterpret_cast<float*>(base) : nullptr;
  return s;
}

template <bool OUT_BF16>
__device__ __forceinline__ void store_out(void* out, long i, float v) {
  if (OUT_BF16)
    reinterpret_cast<bf16*>(out)[i] = __float2bfloat16(v);
  else
    reinterpret_cast<float*>(out)[i] = v;
}

// true where the gate turns this block's sample row of sample k off
__device__ __forceinline__ bool gated_off(const int* __restrict__ gate, int s, int k) {
  return gate != nullptr && gate[blockIdx.x * (s >> 3) + (k >> 3)] == 0;
}

// the density and colour head weights as float
__device__ void load_heads(const Smem& sm, const bf16* __restrict__ w) {
  for (int i = threadIdx.x; i < WIDTH; i += THREADS)
    sm.heads[i] = __bfloat162float(w[OFF_WDENS + i]);
  for (int i = threadIdx.x; i < HALF * 3; i += THREADS)
    sm.heads[WIDTH + i] = __bfloat162float(w[OFF_WCOL + i]);
}

// block start: rays of this tile into shared memory (rays past N are never
// stored), head weights as float
__device__ void load_block_inputs(const Smem& sm, const float* __restrict__ od,
                                  const bf16* __restrict__ w, int n, int ray0) {
  load_rays(sm.rays, od, n, ray0);
  load_heads(sm, w);
}

// the trunk for the current sample: act <- h7 (bf16), emb holds the
// position embedding
__device__ void trunk(Smem& sm, const bf16* __restrict__ w, const float* __restrict__ b) {
  Acc<WIDTH> acc;
  acc.zero();
  gemm<WIDTH>(acc, sm.emb, EMB_LD, EMBX, w + OFF_W0, sm.wbuf);
  epilogue<WIDTH>(acc, b + OFF_B0, true, sm.act, ACT_LD, sm.scratch);
  const long offs[4] = {OFF_W1, OFF_W2, OFF_W3, OFF_W4};
#pragma unroll 1
  for (int i = 0; i < 4; ++i) {
    acc.zero();
    gemm<WIDTH>(acc, sm.act, ACT_LD, WIDTH, w + offs[i], sm.wbuf);
    epilogue<WIDTH>(acc, b + OFF_B0 + WIDTH * (i + 1), true, sm.act, ACT_LD, sm.scratch);
  }
  acc.zero();  // skip: [emb | h] @ [w5e ; w5h]
  gemm<WIDTH>(acc, sm.emb, EMB_LD, EMBX, w + OFF_W5E, sm.wbuf);
  gemm<WIDTH>(acc, sm.act, ACT_LD, WIDTH, w + OFF_W5H, sm.wbuf);
  epilogue<WIDTH>(acc, b + OFF_B0 + WIDTH * 5, true, sm.act, ACT_LD, sm.scratch);
  const long offs2[2] = {OFF_W6, OFF_W7};
#pragma unroll 1
  for (int i = 0; i < 2; ++i) {
    acc.zero();
    gemm<WIDTH>(acc, sm.act, ACT_LD, WIDTH, w + offs2[i], sm.wbuf);
    epilogue<WIDTH>(acc, b + OFF_B0 + WIDTH * (6 + i), true, sm.act, ACT_LD, sm.scratch);
  }
  __syncthreads();  // h7 visible to the heads
}

// density head on the CUDA cores: two threads per point, half the width each
template <bool OUT_BF16>
__device__ void density_head(const Smem& sm, const float* __restrict__ b, void* out,
                             long row_off, int n, int ray0) {
  const int p = threadIdx.x >> 1, half = threadIdx.x & 1;
  const bf16* h = sm.act + p * ACT_LD + half * HALF;
  const float* wd = sm.heads + half * HALF;
  float acc = 0.0f;
#pragma unroll 8
  for (int k = 0; k < HALF; ++k) acc += __bfloat162float(h[k]) * wd[k];
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  if (half == 0 && ray0 + p < n) store_out<OUT_BF16>(out, row_off + ray0 + p, acc + b[OFF_BDENS]);
}

template <bool OUT_BF16>
__global__ void __launch_bounds__(THREADS, 1)
sigma_rays_kernel(const float* __restrict__ od, const float* __restrict__ z,
                  const bf16* __restrict__ w, const float* __restrict__ b,
                  void* sigma, int n, int s, int L_x, const int* __restrict__ gate) {
  extern __shared__ __align__(128) unsigned char smem[];
  Smem sm = carve(smem, false);
  const int ray0 = blockIdx.x * TILE;
  load_block_inputs(sm, od, w, n, ray0);
  float* zrow = sm.scratch;  // staged depths of the current sample
#pragma unroll 1
  for (int k = 0; k < s; ++k) {
    if (gated_off(gate, s, k)) {  // uniform over the block, before any barrier
      if (threadIdx.x < TILE && ray0 + (int)threadIdx.x < n)
        store_out<OUT_BF16>(sigma, (long)k * n + ray0 + threadIdx.x, 0.0f);
      continue;
    }
    __syncthreads();  // previous step's heads are done with act / scratch
    if (threadIdx.x < TILE) {
      const int ray = ray0 + threadIdx.x;
      zrow[threadIdx.x] = ray < n ? z[(long)k * n + ray] : 0.0f;
    }
    __syncthreads();
    build_emb(sm.emb, sm.rays, zrow, L_x, EMBX);
    trunk(sm, w, b);
    density_head<OUT_BF16>(sm, b, sigma, (long)k * n, n, ray0);
  }
}

// the view term of the tile's directions (rays 3-5): hvd = emb(d) @ wvd +
// bv, float32; d scaled to unit length first when unit is set (the ray
// kernels), as given otherwise (the points kernel)
__device__ void view_term(const Smem& sm, const bf16* __restrict__ w,
                          const float* __restrict__ b, int L_d, bool unit) {
  const int warp = threadIdx.x >> 5;
  const int row0 = (warp & 3) * 32, col0 = (warp >> 2) * (HALF / 2);
  build_emb(sm.emb, sm.rays, nullptr, L_d, EMBD, 3, unit);
  Acc<HALF> acc;
  acc.zero();
  gemm<HALF>(acc, sm.emb, EMB_LD, EMBD, w + OFF_WVD, sm.wbuf);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < HALF / 32; ++j)
      wmma::store_matrix_sync(sm.hvd + (row0 + 16 * i) * HVD_LD + col0 + 16 * j,
                              acc.f[i][j], HVD_LD, wmma::mem_row_major);
  __syncthreads();
  for (int idx = threadIdx.x; idx < TILE * HALF; idx += THREADS)
    sm.hvd[(idx / HALF) * HVD_LD + idx % HALF] += b[OFF_BV + idx % HALF];
}

// after the trunk (act holds h7): density, feature, view layer and colour;
// the four logits of the tile's row at out + row_off + ray0 + p, p < n - ray0
template <bool OUT_BF16>
__device__ void field_heads(Smem& sm, const bf16* __restrict__ w, const float* __restrict__ b,
                            void* r_out, void* g_out, void* b_out, void* s_out, long row_off,
                            int n, int ray0) {
  const int warp = threadIdx.x >> 5;
  const int row0 = (warp & 3) * 32, col0 = (warp >> 2) * (HALF / 2);
  density_head<OUT_BF16>(sm, b, s_out, row_off, n, ray0);
  {  // feature head (no activation), in place over h7
    Acc<WIDTH> acc;
    acc.zero();
    gemm<WIDTH>(acc, sm.act, ACT_LD, WIDTH, w + OFF_WFEAT, sm.wbuf);
    epilogue<WIDTH>(acc, b + OFF_BFEAT, false, sm.act, ACT_LD, sm.scratch);
  }
  {  // view layer: relu(feat @ wvf + hvd) -> act[:, :128]
    Acc<HALF> acc;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < HALF / 32; ++j)
        wmma::load_matrix_sync(acc.f[i][j], sm.hvd + (row0 + 16 * i) * HVD_LD + col0 + 16 * j,
                               HVD_LD, wmma::mem_row_major);
    gemm<HALF>(acc, sm.act, ACT_LD, WIDTH, w + OFF_WVF, sm.wbuf);
    epilogue<HALF>(acc, nullptr, true, sm.act, ACT_LD, sm.scratch);
  }
  __syncthreads();
  {  // colour head on the CUDA cores
    const int p = threadIdx.x >> 1, half = threadIdx.x & 1;
    const bf16* h = sm.act + p * ACT_LD + half * (HALF / 2);
    const float* wc = sm.heads + WIDTH + half * (HALF / 2) * 3;
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
#pragma unroll 8
    for (int k = 0; k < HALF / 2; ++k) {
      const float hk = __bfloat162float(h[k]);
      a0 += hk * wc[3 * k];
      a1 += hk * wc[3 * k + 1];
      a2 += hk * wc[3 * k + 2];
    }
    a0 += __shfl_xor_sync(0xffffffffu, a0, 1);
    a1 += __shfl_xor_sync(0xffffffffu, a1, 1);
    a2 += __shfl_xor_sync(0xffffffffu, a2, 1);
    if (half == 0 && ray0 + p < n) {
      store_out<OUT_BF16>(r_out, row_off + ray0 + p, a0 + b[OFF_BCOL]);
      store_out<OUT_BF16>(g_out, row_off + ray0 + p, a1 + b[OFF_BCOL + 1]);
      store_out<OUT_BF16>(b_out, row_off + ray0 + p, a2 + b[OFF_BCOL + 2]);
    }
  }
}

template <bool OUT_BF16>
__global__ void __launch_bounds__(THREADS, 1)
eval_rays_kernel(const float* __restrict__ od, const float* __restrict__ z,
                 const bf16* __restrict__ w, const float* __restrict__ b,
                 void* r_out, void* g_out, void* b_out, void* s_out,
                 int n, int s, int L_x, int L_d, int kchunk, const int* __restrict__ gate) {
  extern __shared__ __align__(128) unsigned char smem[];
  Smem sm = carve(smem, true);
  const int ray0 = blockIdx.x * TILE;
  const int k_begin = blockIdx.y * kchunk;
  const int k_end = min(s, k_begin + kchunk);
  if (gate != nullptr) {  // every row of this block's run gated: zeros, no view term
    bool any = false;
    for (int r = k_begin >> 3; r <= (k_end - 1) >> 3; ++r)
      any |= gate[blockIdx.x * (s >> 3) + r] != 0;
    if (!any) {
      for (int idx = threadIdx.x; idx < (k_end - k_begin) * TILE; idx += THREADS) {
        const int ray = ray0 + idx % TILE;
        if (ray >= n) continue;
        const long at = (long)(k_begin + idx / TILE) * n + ray;
        store_out<OUT_BF16>(r_out, at, 0.0f);
        store_out<OUT_BF16>(g_out, at, 0.0f);
        store_out<OUT_BF16>(b_out, at, 0.0f);
        store_out<OUT_BF16>(s_out, at, 0.0f);
      }
      return;
    }
  }
  load_block_inputs(sm, od, w, n, ray0);
  __syncthreads();
  view_term(sm, w, b, L_d, true);  // once per ray: emb(d / |d|) @ wvd + bv

  float* zrow = sm.scratch;
#pragma unroll 1
  for (int k = k_begin; k < k_end; ++k) {
    if (gated_off(gate, s, k)) {  // uniform over the block, before any barrier
      if (threadIdx.x < TILE && ray0 + (int)threadIdx.x < n) {
        const long at = (long)k * n + ray0 + threadIdx.x;
        store_out<OUT_BF16>(r_out, at, 0.0f);
        store_out<OUT_BF16>(g_out, at, 0.0f);
        store_out<OUT_BF16>(b_out, at, 0.0f);
        store_out<OUT_BF16>(s_out, at, 0.0f);
      }
      continue;
    }
    __syncthreads();
    if (threadIdx.x < TILE) {
      const int ray = ray0 + threadIdx.x;
      zrow[threadIdx.x] = ray < n ? z[(long)k * n + ray] : 0.0f;
    }
    __syncthreads();
    build_emb(sm.emb, sm.rays, zrow, L_x, EMBX);
    trunk(sm, w, b);
    field_heads<OUT_BF16>(sm, w, b, r_out, g_out, b_out, s_out, (long)k * n, n, ray0);
  }
}

// the full field at 128 consecutive points of the planes x, d [3, P]: the
// view term per point (d as given), one trunk, the heads; out [4, P]
template <bool OUT_BF16>
__global__ void __launch_bounds__(THREADS, 1)
eval_points_kernel(const float* __restrict__ x, const float* __restrict__ d,
                   const bf16* __restrict__ w, const float* __restrict__ b, void* r_out,
                   void* g_out, void* b_out, void* s_out, int p, int L_x, int L_d) {
  extern __shared__ __align__(128) unsigned char smem[];
  Smem sm = carve(smem, true);
  const int pt0 = blockIdx.x * TILE;
  load_points(sm.rays, x, d, p, pt0);
  load_heads(sm, w);
  __syncthreads();
  view_term(sm, w, b, L_d, false);
  build_emb(sm.emb, sm.rays, nullptr, L_x, EMBX, 0, false);  // emb is free: the product ended
                                                             // on a barrier
  trunk(sm, w, b);
  field_heads<OUT_BF16>(sm, w, b, r_out, g_out, b_out, s_out, 0, p, pt0);
}

// trunk + density head at 128 consecutive points of x [3, P]
template <bool OUT_BF16>
__global__ void __launch_bounds__(THREADS, 1)
sigma_points_kernel(const float* __restrict__ x, const bf16* __restrict__ w,
                    const float* __restrict__ b, void* sigma, int p, int L_x) {
  extern __shared__ __align__(128) unsigned char smem[];
  Smem sm = carve(smem, false);
  const int pt0 = blockIdx.x * TILE;
  // each point as a ray with origin x, direction 0, at depth 0
  for (int idx = threadIdx.x; idx < TILE * 6; idx += THREADS) {
    const int k = idx / TILE, q = idx % TILE, pt = pt0 + q;
    sm.rays[q * 8 + k] = (k < 3 && pt < p) ? x[(long)k * p + pt] : 0.0f;
  }
  for (int i = threadIdx.x; i < WIDTH; i += THREADS)
    sm.heads[i] = __bfloat162float(w[OFF_WDENS + i]);
  float* zrow = sm.scratch;
  if (threadIdx.x < TILE) zrow[threadIdx.x] = 0.0f;
  __syncthreads();
  build_emb(sm.emb, sm.rays, zrow, L_x, EMBX);
  trunk(sm, w, b);
  density_head<OUT_BF16>(sm, b, sigma, 0, p, pt0);
}

}  // namespace

extern "C" int nerf_sigma_points(const float* x, const void* w, const float* b, void* sigma,
                                 int p, int L_x, int out_bf16, void* stream) {
  const dim3 grid((p + TILE - 1) / TILE);
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bf16* wb = reinterpret_cast<const bf16*>(w);
  int rc;
  if (out_bf16) {
    if ((rc = launch_prep(sigma_points_kernel<true>, SMEM_SIGMA))) return rc;
    sigma_points_kernel<true><<<grid, THREADS, SMEM_SIGMA, st>>>(x, wb, b, sigma, p, L_x);
  } else {
    if ((rc = launch_prep(sigma_points_kernel<false>, SMEM_SIGMA))) return rc;
    sigma_points_kernel<false><<<grid, THREADS, SMEM_SIGMA, st>>>(x, wb, b, sigma, p, L_x);
  }
  return (int)cudaGetLastError();
}

extern "C" int nerf_eval_points(const float* x, const float* d, const void* w, const float* b,
                                void* out, int p, int L_x, int L_d, int out_bf16, void* stream) {
  const dim3 grid((p + TILE - 1) / TILE);
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bf16* wb = reinterpret_cast<const bf16*>(w);
  // out [4, P]: rows r, g, b, sigma
  const long row = (long)p * (out_bf16 ? 2 : 4);
  char* o = reinterpret_cast<char*>(out);
  int rc;
  if (out_bf16) {
    if ((rc = launch_prep(eval_points_kernel<true>, SMEM_EVAL))) return rc;
    eval_points_kernel<true><<<grid, THREADS, SMEM_EVAL, st>>>(x, d, wb, b, o, o + row,
                                                                o + 2 * row, o + 3 * row, p,
                                                                L_x, L_d);
  } else {
    if ((rc = launch_prep(eval_points_kernel<false>, SMEM_EVAL))) return rc;
    eval_points_kernel<false><<<grid, THREADS, SMEM_EVAL, st>>>(x, d, wb, b, o, o + row,
                                                                 o + 2 * row, o + 3 * row, p,
                                                                 L_x, L_d);
  }
  return (int)cudaGetLastError();
}

extern "C" int nerf_sigma_rays(const float* od, const float* z, const void* w, const float* b,
                               void* sigma, int n, int s, int L_x, int out_bf16,
                               const int* gate, void* stream) {
  const dim3 grid((n + TILE - 1) / TILE);
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bf16* wb = reinterpret_cast<const bf16*>(w);
  int rc;
  if (out_bf16) {
    if ((rc = launch_prep(sigma_rays_kernel<true>, SMEM_SIGMA))) return rc;
    sigma_rays_kernel<true><<<grid, THREADS, SMEM_SIGMA, st>>>(od, z, wb, b, sigma, n, s, L_x,
                                                                gate);
  } else {
    if ((rc = launch_prep(sigma_rays_kernel<false>, SMEM_SIGMA))) return rc;
    sigma_rays_kernel<false><<<grid, THREADS, SMEM_SIGMA, st>>>(od, z, wb, b, sigma, n, s, L_x,
                                                                 gate);
  }
  return (int)cudaGetLastError();
}

extern "C" int nerf_eval_rays(const float* od, const float* z, const void* w, const float* b,
                              void* r, void* g, void* bl, void* sigma, int n, int s, int L_x,
                              int L_d, int out_bf16, const int* gate, void* stream) {
  // A block owns 128 rays and a run of their samples.  With fewer than two
  // waves of ray tiles (a 4096-ray training batch has 32) the sample axis
  // is split too, so the card fills; an 800x800 frame's 131072-ray blocks
  // keep one run of all S samples per block.
  const int ray_tiles = (n + TILE - 1) / TILE;
  int splits = 1;
  if (ray_tiles < 2 * sm_count()) splits = min(s, (2 * sm_count() + ray_tiles - 1) / ray_tiles);
  const int kchunk = (s + splits - 1) / splits;
  const dim3 grid(ray_tiles, (s + kchunk - 1) / kchunk);
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bf16* wb = reinterpret_cast<const bf16*>(w);
  int rc;
  if (out_bf16) {
    if ((rc = launch_prep(eval_rays_kernel<true>, SMEM_EVAL))) return rc;
    eval_rays_kernel<true><<<grid, THREADS, SMEM_EVAL, st>>>(od, z, wb, b, r, g, bl, sigma, n, s,
                                                              L_x, L_d, kchunk, gate);
  } else {
    if ((rc = launch_prep(eval_rays_kernel<false>, SMEM_EVAL))) return rc;
    eval_rays_kernel<false><<<grid, THREADS, SMEM_EVAL, st>>>(od, z, wb, b, r, g, bl, sigma, n,
                                                               s, L_x, L_d, kchunk, gate);
  }
  return (int)cudaGetLastError();
}
