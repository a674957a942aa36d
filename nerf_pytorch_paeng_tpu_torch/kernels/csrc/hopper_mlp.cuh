// The fused NeRF MLP's forward products on Hopper, shared by the forward ray
// kernels (fused_mlp.cu: K1/K5, K3/K4) and the backward's chain launch
// (fused_mlp_vjp.cu: K2/K6/K9, which recomputes the forward of every point):
// the swizzled activation tile, the tensor maps and stage loads that stream
// the packed weights by TMA, the wgmma product over an mbarrier ring, the
// register epilogue, and the per-warpgroup ray loads and embedding.
//
// The layout: a block carries a tile of 128 points; two consumer warpgroups
// each own 64 of them (rows 64 w .. 64 w + 63) through the whole MLP, with a
// 64 x N float32 accumulator in registers.  Activations live in shared
// memory as column blocks of 64 bf16 (128-byte rows, 128-byte swizzle,
// hopper_mma.cuh), the wgmma A operand.  The weights W [in][out] are the
// MN-major B operand, streamed in 64-deep k-chunks into a CH_STAGES-deep
// ring that both warpgroups read; a producer thread keeps it full.
#pragma once

#include "hopper_mma.cuh"
#include "nerf_mlp_common.cuh"

namespace {

constexpr int CH_STAGES = 3;
constexpr int CH_STAGE = 32768;           // a 64-deep k-chunk of a 256-wide weight
constexpr int CB = TILE * 64 * 2;         // 16384: a column block [128 points][64] bf16

// packed offset of W_j, j = 1..7 (j = 5: w5h): two runs of 256 x 256 matrices
static_assert(OFF_W2 == OFF_W1 + WIDTH * WIDTH && OFF_W4 == OFF_W1 + 3 * WIDTH * WIDTH &&
                  OFF_W7 == OFF_W5H + 2 * WIDTH * WIDTH,
              "the trunk weights are not packed back to back");
__host__ __device__ __forceinline__ long trunk_off(int j) {
  return j <= 4 ? OFF_W1 + (long)(j - 1) * WIDTH * WIDTH
                : OFF_W5H + (long)(j - 5) * WIDTH * WIDTH;
}

// byte offset of element (r, c) of a [128 points][K] bf16 operand tile held
// as column blocks of 64, 128-byte swizzled: the layout TMA writes and
// wgmma reads as a K-major operand
__device__ __forceinline__ int sw_off(int r, int c) {
  return (c >> 6) * CB + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4) + ((c & 7) << 1);
}

__device__ __forceinline__ float ld_sw(const unsigned char* t, int r, int c) {
  return __bfloat162float(*reinterpret_cast<const bf16*>(t + sw_off(r, c)));
}

__device__ __forceinline__ void st_sw(unsigned char* t, int r, int c, float v) {
  *reinterpret_cast<bf16*>(t + sw_off(r, c)) = __float2bfloat16(v);
}

// The weight products, in the order the consumers run them.  Each names a
// tensor map over the packed weights and the first row of its matrix there;
// N is the map's width.  Forward products (*F maps) read W [in][out] in
// 64-row k-chunks as an MN-major B (boxes of 64 columns x 64 rows); the
// backward's products g W^T (*B maps, fused_mlp_vjp.cu) read the same W as a
// K-major B (one box of 64 columns (k = out) x 256 rows (n = in)).  No
// transposed copy.  The forward maps come first, so a forward kernel passes
// only those.
enum { CMAP_W256F, CMAP_W128F, CMAP_W256B, CMAP_W128B, N_CMAPS };
constexpr int N_FMAPS = CMAP_W256B;
struct Prod {
  int map, row0, k;
};
constexpr int N_FWD_PRODS = 12;   // the full field: trunk, feature, view
constexpr int N_TRUNK_PRODS = 9;  // the trunk: h0 .. h7

__device__ __forceinline__ Prod fwd_prod(int i) {
  if (i == 0) return {CMAP_W256F, (int)(OFF_W0 / WIDTH), EMBX};            // h0
  if (i <= 4) return {CMAP_W256F, (int)(trunk_off(i) / WIDTH), WIDTH};     // h1..h4
  if (i == 5) return {CMAP_W256F, (int)(OFF_W5E / WIDTH), EMBX};           // h5: skip
  if (i <= 8) return {CMAP_W256F, (int)(trunk_off(i - 1) / WIDTH), WIDTH}; // w5h, w6, w7
  if (i == 9) return {CMAP_W256F, (int)(OFF_WFEAT / WIDTH), WIDTH};        // feat
  if (i == 10) return {CMAP_W128F, (int)((OFF_WVD - OFF_WVF) / HALF), EMBD};  // hv
  return {CMAP_W128F, 0, WIDTH};
}

// the producer's k-chunk c of forward product pr into the ring stage st,
// completing on the mbarrier full: 64 rows of W as 64-column boxes
__device__ __forceinline__ void load_fwd_stage(unsigned char* st, const CUtensorMap* maps,
                                               const Prod& pr, int c, uint64_t* full) {
  const int boxes = pr.map == CMAP_W256F ? 4 : 2;
  hopper::mbar_expect_tx(full, boxes * 8192);
  for (int bx = 0; bx < boxes; ++bx)
    hopper::tma_load_2d(st + bx * 8192, &maps[pr.map], full, 64 * bx, pr.row0 + 64 * c);
}

// the forward tensor maps over the packed weights w: the 256-wide matrices
// w0 .. wfeat as one [2176][256] array, wvf and wvd as one [288][128] array,
// in boxes of 64 columns x 64 rows
int fwd_maps(CUtensorMap* m, const bf16* w) {
  using hopper::encode_bf16_map;
  const long rows256 = OFF_WVF / WIDTH, rows128 = (OFF_WDENS - OFF_WVF) / HALF;
  int rc;
  if ((rc = encode_bf16_map(&m[CMAP_W256F], w, WIDTH, rows256, 1, 0, 64))) return rc;
  return encode_bf16_map(&m[CMAP_W128F], w + OFF_WVF, HALF, rows128, 1, 0, 64);
}

template <int R>
__device__ __forceinline__ void zero_acc(float (&acc)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.0f;
}

// acc (64 x N, this warpgroup's rows) += A (its rows of a swizzled operand
// tile at a, k columns) @ the next product's weights from the ring.  `it`
// counts the ring stages this thread has consumed.
template <int N, bool FWD>
__device__ __forceinline__ void chain_gemm(float (&acc)[N / 2], const unsigned char* a, int k,
                                           const unsigned char* ring, uint64_t* full,
                                           uint64_t* empty, uint32_t& it) {
  for (int c = 0; c * 64 < k; ++c) {
    const int s = it % CH_STAGES;
    hopper::mbar_wait(&full[s], (it / CH_STAGES) & 1);
    const unsigned char* st = ring + s * CH_STAGE;
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (c * 64 + kk * 16 < k) {
        const uint64_t da = hopper::desc_sw128(a + c * CB + kk * 32, 16, 1024);
        const uint64_t db = FWD ? hopper::desc_sw128(st + kk * 2048, 8192, 1024)
                                : hopper::desc_sw128(st + kk * 32, 16, 1024);
        if constexpr (N == 256)
          hopper::wgmma_m64n256k16<0, FWD ? 1 : 0>(acc, da, db);
        else
          hopper::wgmma_m64n128k16<0, FWD ? 1 : 0>(acc, da, db);
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    if ((threadIdx.x & 31) == 0) hopper::mbar_arrive(&empty[s]);
    ++it;
  }
}

// the accumulator element i of this thread: row (in the tile) and column
__device__ __forceinline__ int acc_row(int row0, int i) {
  const int t = threadIdx.x & 127;
  return row0 + 16 * (t >> 5) + ((t & 31) >> 2) + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int i) {
  return 8 * (i >> 2) + 2 * (threadIdx.x & 3) + (i & 1);
}

// out <- round(act(acc + bias)) for the warpgroup's 64 rows, in registers,
// stored as bf16 pairs into the swizzled tile; with `mask` the ReLU bits of
// the rounded values go to mask[word * 256 + thread] (word = element / 32)
template <int N>
__device__ __forceinline__ void chain_epilogue(const float (&acc)[N / 2],
                                               const float* __restrict__ bias, bool relu,
                                               unsigned char* out, int row0, uint32_t* mask) {
  uint32_t bits[N / 64];
#pragma unroll
  for (int w = 0; w < N / 64; ++w) bits[w] = 0u;
#pragma unroll
  for (int i = 0; i < N / 2; i += 2) {
    const int c = acc_col(i);
    float v0 = acc[i] + __ldg(bias + c), v1 = acc[i + 1] + __ldg(bias + c + 1);
    if (relu) {
      v0 = fmaxf(v0, 0.0f);
      v1 = fmaxf(v1, 0.0f);
    }
    const __nv_bfloat162 o = __floats2bfloat162_rn(v0, v1);
    *reinterpret_cast<__nv_bfloat162*>(out + sw_off(acc_row(row0, i), c)) = o;
    bits[i >> 5] |= ((uint32_t)(__low2float(o) > 0.0f) << (i & 31)) |
                    ((uint32_t)(__high2float(o) > 0.0f) << ((i + 1) & 31));
  }
  if (mask) {
#pragma unroll
    for (int w = 0; w < N / 64; ++w) mask[w * 256 + threadIdx.x] = bits[w];
  }
}

// the warpgroup's 64 rays (or points) of a tile into rays [TILE][8], zrow
// and, where gout is given (the backward), the bf16-rounded cotangents gout
// [TILE][4] (rows row0 .. row0 + 63).  Rays past N get a harmless unit
// direction and zero cotangents, points past P zeros, so they contribute
// nothing.
__device__ __forceinline__ void load_wg(float* rays, float* zrow, float* gout,
                                        const float* __restrict__ od,
                                        const float* __restrict__ z,
                                        const float* __restrict__ dplane,
                                        const float* __restrict__ gr,
                                        const float* __restrict__ gg,
                                        const float* __restrict__ gb,
                                        const float* __restrict__ gs, int n, int k, int ray0,
                                        int row0) {
  const int t = threadIdx.x & 127;
  for (int idx = t; idx < 64 * 6; idx += 128) {
    const int kk = idx / 64, p = row0 + idx % 64, ray = ray0 + p;
    float v;
    if (dplane) {
      v = 0.0f;
      if (ray < n) v = kk < 3 ? od[(long)kk * n + ray] : dplane[(long)(kk - 3) * n + ray];
    } else {
      v = (kk == 3) ? 1.0f : 0.0f;
      if (ray < n) v = od[(long)kk * n + ray];
    }
    rays[p * 8 + kk] = v;
  }
  if (t < 64) {
    const int p = row0 + t, ray = ray0 + p;
    const bool ok = ray < n;
    const long at = (long)k * n + ray;
    zrow[p] = ok && !dplane ? z[at] : 0.0f;
    if (gout) {
      gout[p * 4 + 0] = ok ? __bfloat162float(__float2bfloat16(gr[at])) : 0.0f;
      gout[p * 4 + 1] = ok ? __bfloat162float(__float2bfloat16(gg[at])) : 0.0f;
      gout[p * 4 + 2] = ok ? __bfloat162float(__float2bfloat16(gb[at])) : 0.0f;
      gout[p * 4 + 3] = ok ? __bfloat162float(__float2bfloat16(gs[at])) : 0.0f;
    }
  }
}

// The warpgroup's 64 rows of a swizzled embedding tile (cols wide):
// [x, sin 2^j x (j < L), cos 2^j x (j < L), 0 ...] for x = o + d z where
// zrow is given, else the three floats at column col of each row of rays
// (0: a point's position, 3: a direction), normalised with unit, as given
// without; sin and cos of 2^j x by the double-angle recurrence, as the TPU
// kernels build them.
__device__ __forceinline__ void emb_wg(unsigned char* emb, const float* rays, const float* zrow,
                                       int L, int cols, int col, bool unit, int row0) {
  const int t = threadIdx.x & 127;
  for (int idx = t; idx < 64 * 3; idx += 128) {
    const int p = row0 + idx / 3, c = idx % 3;
    const float* ray = rays + p * 8;
    float x;
    if (zrow) {
      x = ray[c] + ray[3 + c] * zrow[p];
    } else if (unit) {
      const float dx = ray[col], dy = ray[col + 1], dz = ray[col + 2];
      x = ray[col + c] * rsqrtf(dx * dx + dy * dy + dz * dz);
    } else {
      x = ray[col + c];
    }
    st_sw(emb, p, c, x);
    float s = sinf(x), co = cosf(x);
    for (int j = 0; j < L; ++j) {
      st_sw(emb, p, 3 + 3 * j + c, s);
      st_sw(emb, p, 3 + 3 * L + 3 * j + c, co);
      const float s2 = 2.0f * s * co;
      co = 1.0f - 2.0f * s * s;
      s = s2;
    }
  }
  const int used = 3 + 6 * L, pad = cols - used;
  for (int idx = t; idx < 64 * pad; idx += 128) st_sw(emb, row0 + idx / pad, used + idx % pad, 0.0f);
}

}  // namespace
