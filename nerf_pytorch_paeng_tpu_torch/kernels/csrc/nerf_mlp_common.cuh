// Device code shared by the fused NeRF MLP kernels (fused_mlp.cu, the
// forward kernels, and fused_mlp_vjp.cu, the backward): the packed weight
// layout, the streamed-weight tensor-core product, its epilogue and the
// in-block double-angle embedding.  A block is 256 threads (8 warps) over a
// tile of 128 points; each warp holds a 32-row slab of the accumulators.
#pragma once

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
constexpr int TILE = 128;      // points per step (rays of one sample row)
constexpr int THREADS = 256;   // 8 warps
constexpr int KCHUNK = 32;     // weight rows per ring slot
constexpr int ACT_LD = WIDTH + 8;   // bf16 row strides, padded by 16 bytes
constexpr int EMB_LD = EMBX + 8;
constexpr int W_LD = WIDTH + 8;

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
constexpr long W_TOTAL = 594560;
constexpr long OFF_B0 = 0;           // b_i at OFF_B0 + 256 i, i = 0..7
constexpr long OFF_BFEAT = 2048;
constexpr long OFF_BV = 2304;
constexpr long OFF_BDENS = 2432;
constexpr long OFF_BCOL = 2440;
constexpr long B_TOTAL = 2448;

constexpr int SM_WBUF = 2 * KCHUNK * W_LD * 2;        // 33792
constexpr int SM_SCRATCH = (THREADS / 32) * 256 * 4;  // 8192

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

// dst[TILE x N] (bf16, stride ldd) <- round(act(acc + bias)); bias may be
// null.  With STASH the rounded tile is also stored to gdst (device memory,
// row stride ldg).
template <int N, bool STASH = false>
__device__ void epilogue(Acc<N>& acc, const float* __restrict__ bias, bool relu,
                         bf16* dst, int ldd, float* scratch, bf16* gdst = nullptr,
                         int ldg = 0) {
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
        const int r = row0 + 16 * i + (e >> 4), col = col0 + 16 * j + (e & 15);
        float v = sc[e] + (bias ? __ldg(bias + col) : 0.0f);
        if (relu) v = fmaxf(v, 0.0f);
        const bf16 o = __float2bfloat16(v);
        dst[r * ldd + col] = o;
        if (STASH) gdst[(long)r * ldg + col] = o;
      }
      __syncwarp();
    }
  }
}

// emb[p][:] <- [x, sin 2^j x (j < L), cos 2^j x (j < L), 0 ...] for the
// TILE points x_p = o_p + d_p * z_p (or the unit directions when z is null);
// sin/cos(2^j x) by the double-angle recurrence, as the TPU kernels do.
// rays is [TILE][8]: o in 0-2, d in 3-5.
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

// rays of one tile into shared memory [TILE][8] (rays past N get a
// harmless unit direction and contribute nothing)
__device__ __forceinline__ void load_rays(float* rays, const float* __restrict__ od, int n,
                                          int ray0) {
  for (int idx = threadIdx.x; idx < TILE * 6; idx += THREADS) {
    const int k = idx / TILE, p = idx % TILE, ray = ray0 + p;
    float v = (k == 3) ? 1.0f : 0.0f;
    if (ray < n) v = od[(long)k * n + ray];
    rays[p * 8 + k] = v;
  }
}

template <typename K>
int launch_prep(K kernel, int smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

}  // namespace
