// Fused NeRF MLP along rays, for Hopper (sm_90a): two kernels.
//
//   nerf_sigma_rays  replaces the JAX package's TPU kernel
//                    kernels/fused_mlp.py::_sigma_rays_kernel (fused_mlp_sigma_rays,
//                    gate=None): trunk + density head -> sigma [S, N].
//   nerf_eval_rays   replaces kernels/fused_mlp.py::_eval_rays_kernel
//                    (fused_mlp_eval_rays, gate=None): the full field ->
//                    r, g, b, sigma, each [S, N].
//
// Inputs: od [8, N] float32 (origin rows 0-2, unnormalised direction rows
// 3-5), z [S, N] float32 depths, the packed weights of
// nerf_pytorch_paeng_tpu_torch/kernels/fused_mlp.py (bf16, [in, out] row-major
// per layer) and float32 biases.
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
//    accumulators at every sample;
//  * the 1-wide density and 3-wide colour heads are dot products on the
//    CUDA cores (two threads per point), not padded tensor-core tiles.
// First cut: no wgmma/TMA and one block per SM; the rate against the bound
// is in PERF.md.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int WIDTH = 256;
constexpr int HALF = 128;
constexpr int EMBX = 64;
constexpr int EMBD = 32;
constexpr int TILE = 128;      // rays per block = points per step
constexpr int THREADS = 256;   // 8 warps
constexpr int KCHUNK = 32;     // weight rows per ring slot
constexpr int ACT_LD = WIDTH + 8;   // bf16 row strides, padded by 16 bytes
constexpr int EMB_LD = EMBX + 8;
constexpr int W_LD = WIDTH + 8;
constexpr int HVD_LD = HALF + 4;    // float32 row stride

// Packed layout (elements); equal to kernels/fused_mlp.py::W_OFFSETS /
// B_OFFSETS, which tests/test_torch_kernels.py checks against these lines.
constexpr long OFF_W0 = 0;
constexpr long OFF_W1 = 16384;
constexpr long OFF_W2 = 81920;
constexpr long OFF_W3 = 147456;
constexpr long OFF_W4 = 212992;
constexpr long OFF_W5E = 278528;
constexpr long OFF_W5H = 294912;
constexpr long OFF_W6 = 360448;
constexpr long OFF_W7 = 425984;
constexpr long OFF_WFEAT = 491520;
constexpr long OFF_WVF = 557056;
constexpr long OFF_WVD = 589824;
constexpr long OFF_WDENS = 593920;
constexpr long OFF_WCOL = 594176;
constexpr long OFF_B0 = 0;           // b_i at OFF_B0 + 256 i, i = 0..7
constexpr long OFF_BFEAT = 2048;
constexpr long OFF_BV = 2304;
constexpr long OFF_BDENS = 2432;
constexpr long OFF_BCOL = 2440;

// shared memory carve-up (bytes); every region is a multiple of 128 B
constexpr int SM_ACT = TILE * ACT_LD * 2;           // 67584
constexpr int SM_EMB = TILE * EMB_LD * 2;           // 18432
constexpr int SM_WBUF = 2 * KCHUNK * W_LD * 2;      // 33792
constexpr int SM_SCRATCH = (THREADS / 32) * 256 * 4;  // 8192
constexpr int SM_HVD = TILE * HVD_LD * 4;           // 67584
constexpr int SM_RAYS = TILE * 8 * 4;               // 4096
constexpr int SM_HEADS = 1024 * 4;                  // wdens 256 + wcol 384 (+pad)
constexpr int SMEM_SIGMA = SM_ACT + SM_EMB + SM_WBUF + SM_SCRATCH + SM_RAYS + SM_HEADS;
constexpr int SMEM_EVAL = SMEM_SIGMA + SM_HVD;

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> AccFrag;

// the accumulator tile of one warp for an output of width N: rows
// 32 * (warp % 4) .. +32, columns (N / 2) * (warp / 4) .. +N/2
template <int N>
struct Acc {
  AccFrag f[2][N / 32];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < N / 32; ++j) wmma::fill_fragment(f[i][j], 0.0f);
  }
};

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

// one ring slot <- KCHUNK rows x N columns of a [K, N] row-major weight
template <int N>
__device__ __forceinline__ void load_chunk(bf16* dst, const bf16* __restrict__ src) {
  constexpr int VPR = N / 8;  // 16-byte vectors per row
  for (int v = threadIdx.x; v < KCHUNK * VPR; v += THREADS) {
    const int r = v / VPR, c = (v % VPR) * 8;
    __pipeline_memcpy_async(dst + r * W_LD + c, src + (long)r * N + c, 16);
  }
}

// acc += A[TILE x K] (shared, bf16, stride lda) @ W[K x N] (global, bf16).
// Ends with a barrier, so on return every warp is done reading A and the
// caller may overwrite A in place.  Its first barrier also publishes any
// shared-memory writes the block made before the call.
template <int N>
__device__ void gemm(Acc<N>& acc, const bf16* A, int lda, int K,
                     const bf16* __restrict__ W, bf16* wbuf) {
  constexpr int NF = N / 32;
  const int warp = threadIdx.x >> 5;
  const int row0 = (warp & 3) * 32;
  const int col0 = (warp >> 2) * (N / 2);
  const int nch = K / KCHUNK;
  load_chunk<N>(wbuf, W);
  __pipeline_commit();
  for (int c = 0; c < nch; ++c) {
    if (c + 1 < nch) {
      load_chunk<N>(wbuf + ((c + 1) & 1) * KCHUNK * W_LD, W + (long)(c + 1) * KCHUNK * N);
      __pipeline_commit();
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    const bf16* wb = wbuf + (c & 1) * KCHUNK * W_LD;
#pragma unroll
    for (int kk = 0; kk < KCHUNK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a0, a1;
      wmma::load_matrix_sync(a0, A + row0 * lda + c * KCHUNK + kk, lda);
      wmma::load_matrix_sync(a1, A + (row0 + 16) * lda + c * KCHUNK + kk, lda);
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, wb + kk * W_LD + col0 + 16 * j, W_LD);
        wmma::mma_sync(acc.f[0][j], a0, b, acc.f[0][j]);
        wmma::mma_sync(acc.f[1][j], a1, b, acc.f[1][j]);
      }
    }
    __syncthreads();
  }
}

// dst[TILE x N] (bf16, stride ldd) <- round(act(acc + bias)); bias may be null
template <int N>
__device__ void epilogue(Acc<N>& acc, const float* __restrict__ bias, bool relu,
                         bf16* dst, int ldd, float* scratch) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = (warp & 3) * 32;
  const int col0 = (warp >> 2) * (N / 2);
  float* sc = scratch + warp * 256;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < N / 32; ++j) {
      wmma::store_matrix_sync(sc, acc.f[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = e >> 4, col = col0 + 16 * j + (e & 15);
        float v = sc[e] + (bias ? __ldg(bias + col) : 0.0f);
        if (relu) v = fmaxf(v, 0.0f);
        dst[(row0 + 16 * i + r) * ldd + col] = __float2bfloat16(v);
      }
      __syncwarp();
    }
  }
}

// emb[p][:] <- [x, sin 2^j x (j < L), cos 2^j x (j < L), 0 ...] for the
// TILE points x_p = o_p + d_p * z_p (or the unit directions when z is null);
// sin/cos(2^j x) by the double-angle recurrence, as the TPU kernels do.
__device__ void build_emb(bf16* emb, const float* rays, const float* zrow, int L,
                          int cols) {
  for (int idx = threadIdx.x; idx < TILE * 3; idx += THREADS) {
    const int p = idx / 3, c = idx % 3;
    const float* ray = rays + p * 8;
    float x;
    if (zrow) {
      x = ray[c] + ray[3 + c] * zrow[p];
    } else {
      const float dx = ray[3], dy = ray[4], dz = ray[5];
      x = ray[3 + c] * rsqrtf(dx * dx + dy * dy + dz * dz);
    }
    bf16* e = emb + p * EMB_LD;
    e[c] = __float2bfloat16(x);
    float s = sinf(x), co = cosf(x);
    for (int j = 0; j < L; ++j) {
      e[3 + 3 * j + c] = __float2bfloat16(s);
      e[3 + 3 * L + 3 * j + c] = __float2bfloat16(co);
      const float s2 = 2.0f * s * co;
      co = 1.0f - 2.0f * s * s;
      s = s2;
    }
  }
  const int used = 3 + 6 * L, pad = cols - used;
  for (int idx = threadIdx.x; idx < TILE * pad; idx += THREADS)
    emb[(idx / pad) * EMB_LD + used + idx % pad] = __float2bfloat16(0.0f);
}

template <bool OUT_BF16>
__device__ __forceinline__ void store_out(void* out, long i, float v) {
  if (OUT_BF16)
    reinterpret_cast<bf16*>(out)[i] = __float2bfloat16(v);
  else
    reinterpret_cast<float*>(out)[i] = v;
}

// block start: rays of this tile into shared memory (rays past N get a
// harmless unit direction and are never stored), head weights as float
__device__ void load_block_inputs(const Smem& sm, const float* __restrict__ od,
                                  const bf16* __restrict__ w, int n, int ray0) {
  for (int idx = threadIdx.x; idx < TILE * 6; idx += THREADS) {
    const int k = idx / TILE, p = idx % TILE, ray = ray0 + p;
    float v = (k == 3) ? 1.0f : 0.0f;
    if (ray < n) v = od[(long)k * n + ray];
    sm.rays[p * 8 + k] = v;
  }
  for (int i = threadIdx.x; i < WIDTH; i += THREADS)
    sm.heads[i] = __bfloat162float(w[OFF_WDENS + i]);
  for (int i = threadIdx.x; i < HALF * 3; i += THREADS)
    sm.heads[WIDTH + i] = __bfloat162float(w[OFF_WCOL + i]);
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
                  void* sigma, int n, int s, int L_x) {
  extern __shared__ __align__(128) unsigned char smem[];
  Smem sm = carve(smem, false);
  const int ray0 = blockIdx.x * TILE;
  load_block_inputs(sm, od, w, n, ray0);
  float* zrow = sm.scratch;  // staged depths of the current sample
#pragma unroll 1
  for (int k = 0; k < s; ++k) {
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

template <bool OUT_BF16>
__global__ void __launch_bounds__(THREADS, 1)
eval_rays_kernel(const float* __restrict__ od, const float* __restrict__ z,
                 const bf16* __restrict__ w, const float* __restrict__ b,
                 void* r_out, void* g_out, void* b_out, void* s_out,
                 int n, int s, int L_x, int L_d) {
  extern __shared__ __align__(128) unsigned char smem[];
  Smem sm = carve(smem, true);
  const int ray0 = blockIdx.x * TILE;
  const int warp = threadIdx.x >> 5;
  const int row0 = (warp & 3) * 32, col0 = (warp >> 2) * (HALF / 2);
  load_block_inputs(sm, od, w, n, ray0);
  __syncthreads();

  {  // per-ray view term: hvd = emb(d / |d|) @ wvd + bv, float32
    build_emb(sm.emb, sm.rays, nullptr, L_d, EMBD);
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

  float* zrow = sm.scratch;
#pragma unroll 1
  for (int k = 0; k < s; ++k) {
    __syncthreads();
    if (threadIdx.x < TILE) {
      const int ray = ray0 + threadIdx.x;
      zrow[threadIdx.x] = ray < n ? z[(long)k * n + ray] : 0.0f;
    }
    __syncthreads();
    build_emb(sm.emb, sm.rays, zrow, L_x, EMBX);
    trunk(sm, w, b);
    const long row_off = (long)k * n;
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
}

template <typename K>
int launch_prep(K kernel, int smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace

extern "C" int nerf_sigma_rays(const float* od, const float* z, const void* w, const float* b,
                               void* sigma, int n, int s, int L_x, int out_bf16,
                               void* stream) {
  const dim3 grid((n + TILE - 1) / TILE);
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bf16* wb = reinterpret_cast<const bf16*>(w);
  int rc;
  if (out_bf16) {
    if ((rc = launch_prep(sigma_rays_kernel<true>, SMEM_SIGMA))) return rc;
    sigma_rays_kernel<true><<<grid, THREADS, SMEM_SIGMA, st>>>(od, z, wb, b, sigma, n, s, L_x);
  } else {
    if ((rc = launch_prep(sigma_rays_kernel<false>, SMEM_SIGMA))) return rc;
    sigma_rays_kernel<false><<<grid, THREADS, SMEM_SIGMA, st>>>(od, z, wb, b, sigma, n, s, L_x);
  }
  return (int)cudaGetLastError();
}

extern "C" int nerf_eval_rays(const float* od, const float* z, const void* w, const float* b,
                              void* r, void* g, void* bl, void* sigma, int n, int s, int L_x,
                              int L_d, int out_bf16, void* stream) {
  const dim3 grid((n + TILE - 1) / TILE);
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bf16* wb = reinterpret_cast<const bf16*>(w);
  int rc;
  if (out_bf16) {
    if ((rc = launch_prep(eval_rays_kernel<true>, SMEM_EVAL))) return rc;
    eval_rays_kernel<true><<<grid, THREADS, SMEM_EVAL, st>>>(od, z, wb, b, r, g, bl, sigma, n, s,
                                                              L_x, L_d);
  } else {
    if ((rc = launch_prep(eval_rays_kernel<false>, SMEM_EVAL))) return rc;
    eval_rays_kernel<false><<<grid, THREADS, SMEM_EVAL, st>>>(od, z, wb, b, r, g, bl, sigma, n,
                                                               s, L_x, L_d);
  }
  return (int)cudaGetLastError();
}
