// Backward of the fused NeRF MLP along rays, for Hopper (sm_90a): K2.
//
//   nerf_bwd_rays  replaces the JAX package's TPU kernel
//                  kernels/fused_mlp_vjp.py::_bwd_rays_kernel (_bwd_rays_call,
//                  gate=None): for every sample of every ray, recompute the
//                  forward (nothing is kept from nerf_eval_rays) and chain the
//                  cotangents of (r, g, b, sigma) back to float32 gradients of
//                  all 26 packed weights and biases, summed over all points.
//
// Inputs: od [8, N] and z [S, N] float32 as for nerf_eval_rays, the four
// cotangents [S, N] float32, the packed bf16 weights and float32 biases of
// kernels/fused_mlp.py.  Outputs: dw [W_TOTAL] and db [B_TOTAL] float32 in
// the packed layout.  Rounding follows the TPU kernel: bf16 operands and
// float32 accumulation; the cotangents, every masked delta and dfeat are
// rounded to bf16 before their products; the density and feature paths are
// summed into dh in float32; the ReLU masks come from the recomputed
// activations.
//
// What bounds it on this card: operations.  A sample needs 2.30 MFLOP of
// gradient products (kernels/fused_mlp.py::bwd_flop_per_sample) plus the
// 1.18 MFLOP recompute, against 20 B of inputs.
//
// Why it is not one kernel: the TPU keeps every activation of a 1024-point
// tile and the whole 2.4 MB gradient accumulator in VMEM across its
// sequential grid.  Here a point's activations and deltas are ~10 KB (a
// 128-point tile would need 1.2 MB against 227 KB of shared memory), and a
// block cannot hold a 2.4 MB accumulator: read-modify-writing it after every
// small tile would move ~150 KB per point.  A 32-point tile would fill shared
// memory and run every product on a quarter of the 128-row tile the warp
// layout is built for; recomputing the trunk in two segments would add a
// third of the recompute again; a stash small enough to stay in L2 (50 MB)
// holds ~5000 points, too few to give each weight-gradient block a long run of
// points.  So the work is split where the contraction changes direction:
//  1. bwd_chain_kernel (point-parallel, one 128-ray x 1-sample tile at a
//     time, the forward kernels' tensor-core machinery): recompute the
//     forward, then the chain of input gradients dh = g W^T (products over
//     the weights' output axis, read from a transposed copy of the weights
//     so the same streamed-weight product serves both directions).  Every
//     bf16 activation and masked delta goes to a stash in device memory
//     (4960 values per point, ~10 KB).  Bias and head-weight gradients, cheap
//     CUDA-core sums, accumulate in the block's shared memory over all its
//     tiles and are written once per block.
//  2. wgrad_kernel: every weight gradient dW = H^T G is a product over the
//     points; a block owns a 128 x 128 tile of one dW and a contiguous range
//     of points, keeps the tile in registers over the whole range (cp.async
//     double buffering of 64-point slabs of H and G) and writes it once.
//  3. reduce_kernel: the partials of every block and chunk are added in a
//     fixed order.  No atomics anywhere: two launches on the same inputs
//     give the same bits, which a bit-exact resume relies on.
// Points go through in chunks of at most 1024 tiles (131072 points, a
// 1.3 GB stash), the stash reused from chunk to chunk.  The stash traffic
// (~10 KB written and ~20 KB read per point) is this design's cost beside
// the tensor-core rate; PERF.md has the times.  First cut: wmma, no
// wgmma/TMA.

#include "nerf_mlp_common.cuh"

namespace {

// stash: point-major bf16 arrays of a chunk of pc points; array X starts at
// ST_X * pc, h_i at (ST_H0 + 256 i) * pc, g_i at (ST_G0 + 256 i) * pc
constexpr long ST_EMBX = 0;
constexpr long ST_H0 = 64;
constexpr long ST_FEAT = 2112;
constexpr long ST_HV = 2368;
constexpr long ST_EMBD = 2496;
constexpr long ST_G0 = 2528;
constexpr long ST_DFEAT = 4576;
constexpr long ST_DHV = 4832;
constexpr long ST_PER_POINT = 4960;

// transposed weights [out][in]: W_j^T for trunk layers j = 1..7 (j = 5 is
// w5h) at (j - 1) * 65536, then wfeat^T, then wvf^T [128][256]
constexpr long WT_WFEAT = 7L * WIDTH * WIDTH;
constexpr long WT_WVF = 8L * WIDTH * WIDTH;
constexpr long WT_TOTAL = WT_WVF + (long)HALF * WIDTH;

// per-block partial of the chain kernel: the bias gradients (packed b
// layout), then the head weights' (wdens 256, wcol 128 x 3)
constexpr int PART1 = B_TOTAL + WIDTH + HALF * 3;   // 3088 floats
constexpr long WG_TOTAL = OFF_WDENS;                // the weights wgrad_kernel covers

constexpr int CHUNK_TILES = 1024;

// chain kernel shared memory (bytes); every region is a multiple of 128 B
constexpr int SM_ACT = TILE * ACT_LD * 2;           // 67584: h_i, then feat, then hv
constexpr int SM_DL = TILE * ACT_LD * 2;            // 67584: the current delta
constexpr int SM_EMB = TILE * EMB_LD * 2;           // 18432
constexpr int SM_RAYS = TILE * 8 * 4;               // 4096
constexpr int SM_GOUT = TILE * 4 * 4;               // 2048: cotangents (r, g, b, sigma)
constexpr int SM_HEADS = 1024 * 4;                  // wdens 256 + wcol 384 (+pad)
constexpr int SM_PART = 12416;                      // PART1 floats, rounded up
constexpr int SMEM_CHAIN = SM_ACT + SM_DL + SM_EMB + SM_WBUF + SM_SCRATCH + SM_RAYS +
                           SM_GOUT + SM_HEADS + SM_PART;

// weight-gradient kernel: 128 x 128 output tiles, 64-point slabs
constexpr int TM = 128, TN = 128, PK = 64;
constexpr int AS_LD = TM + 8, GS_LD = TN + 8;
constexpr int SM_STAGE = PK * (AS_LD + GS_LD) * 2;  // 34816
constexpr int SMEM_WGRAD = 2 * SM_STAGE;

__device__ __forceinline__ long trunk_off(int j) {  // packed offset of W_j, j = 1..7
  const long offs[7] = {OFF_W1, OFF_W2, OFF_W3, OFF_W4, OFF_W5H, OFF_W6, OFF_W7};
  return offs[j - 1];
}

__global__ void transpose_kernel(const bf16* __restrict__ w, bf16* __restrict__ wt) {
  const long i = blockIdx.x * (long)blockDim.x + threadIdx.x;
  if (i >= WT_TOTAL) return;
  long src, j;
  int rows = WIDTH, cols = WIDTH;   // the source is [rows = in][cols = out]
  if (i < WT_WFEAT) {
    src = trunk_off(1 + (int)(i / (WIDTH * WIDTH)));
    j = i % (WIDTH * WIDTH);
  } else if (i < WT_WVF) {
    src = OFF_WFEAT;
    j = i - WT_WFEAT;
  } else {
    src = OFF_WVF;
    j = i - WT_WVF;
    cols = HALF;
  }
  const long o = j / rows, r = j % rows;
  wt[i] = w[src + r * cols + o];
}

// smem tile [TILE][lds] -> device rows [TILE][cols], 16-byte vectors
__device__ __forceinline__ void stash_tile(bf16* g, int cols, const bf16* s, int lds) {
  const int vpr = cols / 8;
  for (int v = threadIdx.x; v < TILE * vpr; v += THREADS) {
    const int r = v / vpr, c = (v % vpr) * 8;
    *reinterpret_cast<uint4*>(g + (long)r * cols + c) =
        *reinterpret_cast<const uint4*>(s + r * lds + c);
  }
}

// dst[c] += sum over the tile's points of t[p][c] (fixed order)
__device__ __forceinline__ void colsum_add(const bf16* t, int width, float* dst) {
  for (int c = threadIdx.x; c < width; c += THREADS) {
    float s = 0.0f;
    for (int p = 0; p < TILE; ++p) s += __bfloat162float(t[p * ACT_LD + c]);
    dst[c] += s;
  }
}

// delta epilogue: v = acc (+ g_sigma[p] * wdens[c] when gout is given),
// zeroed where the stashed activation mask[p][c] is not > 0 (no mask: kept),
// rounded to bf16 into dst (shared) and the stash row gdst[p].  mask and
// gdst are this block's own stash rows, written earlier in the same tile, so
// they are read with plain (coherent) loads.
__device__ void epilogue_delta(Acc<WIDTH>& acc, const bf16* mask, const float* gout,
                               const float* wdens, bf16* dst, bf16* gdst, float* scratch) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = (warp & 3) * 32;
  const int col0 = (warp >> 2) * (WIDTH / 2);
  float* sc = scratch + warp * 256;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < WIDTH / 32; ++j) {
      wmma::store_matrix_sync(sc, acc.f[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = row0 + 16 * i + (e >> 4), col = col0 + 16 * j + (e & 15);
        float v = sc[e];
        if (gout) v += gout[r * 4 + 3] * wdens[col];
        if (mask && !(__bfloat162float(mask[(long)r * WIDTH + col]) > 0.0f)) v = 0.0f;
        const bf16 o = __float2bfloat16(v);
        dst[r * ACT_LD + col] = o;
        gdst[(long)r * WIDTH + col] = o;
      }
      __syncwarp();
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
bwd_chain_kernel(const float* __restrict__ od, const float* __restrict__ z,
                 const float* __restrict__ gr, const float* __restrict__ gg,
                 const float* __restrict__ gb, const float* __restrict__ gs,
                 const bf16* __restrict__ w, const float* __restrict__ b,
                 const bf16* __restrict__ wt, bf16* stash, float* part1, int n,
                 int L_x, int L_d, long tile0, int ntiles, long pc) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* base = smem;
  bf16* act = reinterpret_cast<bf16*>(base);
  base += SM_ACT;
  bf16* dl = reinterpret_cast<bf16*>(base);
  base += SM_DL;
  bf16* emb = reinterpret_cast<bf16*>(base);
  base += SM_EMB;
  bf16* wbuf = reinterpret_cast<bf16*>(base);
  base += SM_WBUF;
  float* scratch = reinterpret_cast<float*>(base);
  base += SM_SCRATCH;
  float* rays = reinterpret_cast<float*>(base);
  base += SM_RAYS;
  float* gout = reinterpret_cast<float*>(base);
  base += SM_GOUT;
  float* heads = reinterpret_cast<float*>(base);   // wdens [256], wcol [128][3]
  base += SM_HEADS;
  float* part = reinterpret_cast<float*>(base);
  const int tid = threadIdx.x;

  for (int i = tid; i < PART1; i += THREADS) part[i] = 0.0f;
  for (int i = tid; i < WIDTH; i += THREADS) heads[i] = __bfloat162float(w[OFF_WDENS + i]);
  for (int i = tid; i < HALF * 3; i += THREADS)
    heads[WIDTH + i] = __bfloat162float(w[OFF_WCOL + i]);

  bf16* const s_embx = stash + ST_EMBX * pc;
  bf16* const s_feat = stash + ST_FEAT * pc;
  bf16* const s_hv = stash + ST_HV * pc;
  bf16* const s_embd = stash + ST_EMBD * pc;
  bf16* const s_dfeat = stash + ST_DFEAT * pc;
  bf16* const s_dhv = stash + ST_DHV * pc;
  auto s_h = [&](int i) { return stash + (ST_H0 + (long)WIDTH * i) * pc; };
  auto s_g = [&](int i) { return stash + (ST_G0 + (long)WIDTH * i) * pc; };

  const int ray_tiles = (n + TILE - 1) / TILE;
  const int t_begin = (int)((long)blockIdx.x * ntiles / gridDim.x);
  const int t_end = (int)((long)(blockIdx.x + 1) * ntiles / gridDim.x);
  float* zrow = scratch;
#pragma unroll 1
  for (int t = t_begin; t < t_end; ++t) {
    const long tg = tile0 + t;
    const int k = (int)(tg / ray_tiles), ray0 = (int)(tg % ray_tiles) * TILE;
    const long q0 = (long)t * TILE;   // first stash row of this tile
    __syncthreads();                  // the previous tile is done with smem
    load_rays(rays, od, n, ray0);
    if (tid < TILE) {
      const int ray = ray0 + tid;
      const bool ok = ray < n;
      const long at = (long)k * n + ray;
      zrow[tid] = ok ? z[at] : 0.0f;
      // cotangents rounded to bf16; rays past N get zero cotangents, so
      // every delta and gradient contribution of theirs is zero
      gout[tid * 4 + 0] = ok ? __bfloat162float(__float2bfloat16(gr[at])) : 0.0f;
      gout[tid * 4 + 1] = ok ? __bfloat162float(__float2bfloat16(gg[at])) : 0.0f;
      gout[tid * 4 + 2] = ok ? __bfloat162float(__float2bfloat16(gb[at])) : 0.0f;
      gout[tid * 4 + 3] = ok ? __bfloat162float(__float2bfloat16(gs[at])) : 0.0f;
    }
    __syncthreads();
    build_emb(emb, rays, zrow, L_x, EMBX);
    __syncthreads();
    stash_tile(s_embx + q0 * EMBX, EMBX, emb, EMB_LD);

    // ---- forward recompute, every activation to the stash -------------
    {
      Acc<WIDTH> acc;
      acc.zero();
      gemm<WIDTH>(acc, emb, EMB_LD, EMBX, w + OFF_W0, wbuf);
      epilogue<WIDTH, true>(acc, b + OFF_B0, true, act, ACT_LD, scratch, s_h(0) + q0 * WIDTH,
                            WIDTH);
#pragma unroll 1
      for (int i = 1; i <= 7; ++i) {
        acc.zero();
        if (i == 5) gemm<WIDTH>(acc, emb, EMB_LD, EMBX, w + OFF_W5E, wbuf);  // skip
        gemm<WIDTH>(acc, act, ACT_LD, WIDTH, w + trunk_off(i), wbuf);
        epilogue<WIDTH, true>(acc, b + OFF_B0 + WIDTH * i, true, act, ACT_LD, scratch,
                              s_h(i) + q0 * WIDTH, WIDTH);
      }
    }
    __syncthreads();  // h7 visible
    {                 // density head: dwdens[c] += sum_p h7[p][c] g_sigma[p]
      float s = 0.0f;
      for (int p = 0; p < TILE; ++p) s += __bfloat162float(act[p * ACT_LD + tid]) * gout[p * 4 + 3];
      part[B_TOTAL + tid] += s;
    }
    build_emb(emb, rays, nullptr, L_d, EMBD);  // the embedding is free after the skip layer
    {                                          // feature layer (no activation), in place
      Acc<WIDTH> acc;
      acc.zero();
      gemm<WIDTH>(acc, act, ACT_LD, WIDTH, w + OFF_WFEAT, wbuf);
      epilogue<WIDTH, true>(acc, b + OFF_BFEAT, false, act, ACT_LD, scratch, s_feat + q0 * WIDTH,
                            WIDTH);
    }
    stash_tile(s_embd + q0 * EMBD, EMBD, emb, EMB_LD);
    {  // view layer: relu(embd @ wvd + feat @ wvf + bv) -> act[:, :128]
      Acc<HALF> acc;
      acc.zero();
      gemm<HALF>(acc, emb, EMB_LD, EMBD, w + OFF_WVD, wbuf);
      gemm<HALF>(acc, act, ACT_LD, WIDTH, w + OFF_WVF, wbuf);
      epilogue<HALF, true>(acc, b + OFF_BV, true, act, ACT_LD, scratch, s_hv + q0 * HALF, HALF);
    }
    __syncthreads();  // hv visible

    // ---- backward -------------------------------------------------------
    for (int idx = tid; idx < HALF * 3; idx += THREADS) {  // dwcol[k][c]
      const int kk = idx / 3, c = idx % 3;
      float s = 0.0f;
      for (int p = 0; p < TILE; ++p) s += __bfloat162float(act[p * ACT_LD + kk]) * gout[p * 4 + c];
      part[B_TOTAL + WIDTH + idx] += s;
    }
    if (tid < 4) {  // dbcol, dbdens
      float s = 0.0f;
      for (int p = 0; p < TILE; ++p) s += gout[p * 4 + tid];
      part[tid < 3 ? OFF_BCOL + tid : OFF_BDENS] += s;
    }
    // dhv = mask(hv > 0, g_rgb @ wcol^T), bf16 -> dl[:, :128]
    for (int idx = tid; idx < TILE * HALF; idx += THREADS) {
      const int p = idx / HALF, kk = idx % HALF;
      float v = 0.0f;
      if (__bfloat162float(act[p * ACT_LD + kk]) > 0.0f) {
        const float* wc = heads + WIDTH + kk * 3;
        v = wc[0] * gout[p * 4] + wc[1] * gout[p * 4 + 1] + wc[2] * gout[p * 4 + 2];
      }
      const bf16 o = __float2bfloat16(v);
      dl[p * ACT_LD + kk] = o;
      s_dhv[(q0 + p) * HALF + kk] = o;
    }
    __syncthreads();
    colsum_add(dl, HALF, part + OFF_BV);
    Acc<WIDTH> acc;
    acc.zero();  // dfeat = dhv @ wvf^T, bf16
    gemm<WIDTH>(acc, dl, ACT_LD, HALF, wt + WT_WVF, wbuf);
    epilogue_delta(acc, nullptr, nullptr, heads, dl, s_dfeat + q0 * WIDTH, scratch);
    __syncthreads();
    colsum_add(dl, WIDTH, part + OFF_BFEAT);
    acc.zero();  // g7 = mask(h7, dfeat @ wfeat^T + g_sigma wdens)
    gemm<WIDTH>(acc, dl, ACT_LD, WIDTH, wt + WT_WFEAT, wbuf);
    epilogue_delta(acc, s_h(7) + q0 * WIDTH, gout, heads, dl, s_g(7) + q0 * WIDTH, scratch);
#pragma unroll 1
    for (int j = 7; j >= 1; --j) {  // g_{j-1} = mask(h_{j-1}, g_j @ W_j^T)
      __syncthreads();
      colsum_add(dl, WIDTH, part + OFF_B0 + WIDTH * j);
      acc.zero();
      gemm<WIDTH>(acc, dl, ACT_LD, WIDTH, wt + (long)(j - 1) * WIDTH * WIDTH, wbuf);
      epilogue_delta(acc, s_h(j - 1) + q0 * WIDTH, nullptr, heads, dl, s_g(j - 1) + q0 * WIDTH,
                     scratch);
    }
    __syncthreads();
    colsum_add(dl, WIDTH, part + OFF_B0);
  }
  __syncthreads();
  for (int i = tid; i < PART1; i += THREADS) part1[(long)blockIdx.x * PART1 + i] = part[i];
}

// the weight gradients dW = A^T G of wgrad_kernel, A and G stash arrays
struct WJob {
  long a, g, out;   // stash array units (x pc), packed offset
  int kin, nout;
};

__device__ WJob wjob(int j) {
  if (j == 0) return {ST_EMBX, ST_G0, OFF_W0, EMBX, WIDTH};
  if (j <= 4) return {ST_H0 + WIDTH * (j - 1), ST_G0 + WIDTH * j, trunk_off(j), WIDTH, WIDTH};
  if (j == 5) return {ST_EMBX, ST_G0 + WIDTH * 5, OFF_W5E, EMBX, WIDTH};
  if (j <= 8) return {ST_H0 + WIDTH * (j - 2), ST_G0 + WIDTH * (j - 1), trunk_off(j - 1), WIDTH,
                      WIDTH};  // w5h, w6, w7
  if (j == 9) return {ST_H0 + WIDTH * 7, ST_DFEAT, OFF_WFEAT, WIDTH, WIDTH};
  if (j == 10) return {ST_FEAT, ST_DHV, OFF_WVF, WIDTH, HALF};
  return {ST_EMBD, ST_DHV, OFF_WVD, EMBD, HALF};
}
constexpr int N_WJOBS = 12;
constexpr int N_WTILES = 39;   // sum over the jobs of ceil(kin/TM) * ceil(nout/TN)

__global__ void __launch_bounds__(THREADS, 1)
wgrad_kernel(const bf16* __restrict__ stash, long pc, int npts, float* __restrict__ part2) {
  extern __shared__ __align__(128) unsigned char smem[];
  int tile = blockIdx.x, j = 0, tm = 0, tn = 0;
  WJob job = wjob(0);
  for (; j < N_WJOBS; ++j) {
    job = wjob(j);
    const int mt = (job.kin + TM - 1) / TM, nt = (job.nout + TN - 1) / TN;
    if (tile < mt * nt) {
      tm = tile / nt;
      tn = tile % nt;
      break;
    }
    tile -= mt * nt;
  }
  const int m0 = tm * TM, n0 = tn * TN;
  const int mrows = min(TM, job.kin - m0), ncols = min(TN, job.nout - n0);
  const bf16* A = stash + job.a * pc + m0;   // row p at A + p * kin
  const bf16* G = stash + job.g * pc + n0;   // row p at G + p * nout
  const int nsteps = npts / PK;
  const int st0 = (int)((long)blockIdx.y * nsteps / gridDim.y);
  const int st1 = (int)((long)(blockIdx.y + 1) * nsteps / gridDim.y);

  const int warp = threadIdx.x >> 5;
  const int wm = (warp & 3) * 32, wn = (warp >> 2) * 64;
  AccFrag acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) wmma::fill_fragment(acc[i][jj], 0.0f);

  auto load = [&](int st, int buf) {
    bf16* as = reinterpret_cast<bf16*>(smem + buf * SM_STAGE);
    bf16* gs = as + PK * AS_LD;
    const long p0 = (long)st * PK;
    const int va = mrows / 8, vg = ncols / 8;
    for (int v = threadIdx.x; v < PK * va; v += THREADS) {
      const int r = v / va, c = (v % va) * 8;
      __pipeline_memcpy_async(as + r * AS_LD + c, A + (p0 + r) * job.kin + c, 16);
    }
    for (int v = threadIdx.x; v < PK * vg; v += THREADS) {
      const int r = v / vg, c = (v % vg) * 8;
      __pipeline_memcpy_async(gs + r * GS_LD + c, G + (p0 + r) * job.nout + c, 16);
    }
  };

  if (st0 < st1) {
    load(st0, 0);
    __pipeline_commit();
  }
  for (int st = st0; st < st1; ++st) {
    const int buf = (st - st0) & 1;
    if (st + 1 < st1) {
      load(st + 1, buf ^ 1);
      __pipeline_commit();
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    const bf16* as = reinterpret_cast<const bf16*>(smem + buf * SM_STAGE);
    const bf16* gs = as + PK * AS_LD;
#pragma unroll
    for (int kk = 0; kk < PK; kk += 16) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (wm + 16 * i >= mrows) continue;
        // A^T [m x points] is the stashed [points x m] slab read column-major
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
        wmma::load_matrix_sync(a, as + kk * AS_LD + wm + 16 * i, AS_LD);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          if (wn + 16 * jj >= ncols) continue;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
          wmma::load_matrix_sync(bfr, gs + kk * GS_LD + wn + 16 * jj, GS_LD);
          wmma::mma_sync(acc[i][jj], a, bfr, acc[i][jj]);
        }
      }
    }
    __syncthreads();
  }
  float* out = part2 + (long)blockIdx.y * WG_TOTAL + job.out + (long)m0 * job.nout + n0;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      if (wm + 16 * i < mrows && wn + 16 * jj < ncols)
        wmma::store_matrix_sync(out + (long)(wm + 16 * i) * job.nout + wn + 16 * jj, acc[i][jj],
                                job.nout, wmma::mem_row_major);
}

// dw, db <- the partials, added in a fixed order
__global__ void reduce_kernel(const float* __restrict__ part2, int n2,
                              const float* __restrict__ part1, int n1, float* __restrict__ dw,
                              float* __restrict__ db) {
  const long i = blockIdx.x * (long)blockDim.x + threadIdx.x;
  float s = 0.0f;
  if (i < WG_TOTAL) {
    for (int j = 0; j < n2; ++j) s += part2[(long)j * WG_TOTAL + i];
    dw[i] = s;
  } else if (i < W_TOTAL) {
    for (int j = 0; j < n1; ++j) s += part1[(long)j * PART1 + B_TOTAL + (i - WG_TOTAL)];
    dw[i] = s;
  } else if (i < W_TOTAL + B_TOTAL) {
    for (int j = 0; j < n1; ++j) s += part1[(long)j * PART1 + (i - W_TOTAL)];
    db[i - W_TOTAL] = s;
  }
}

struct Plan {
  long tiles;     // S x ray tiles
  int chunk;      // tiles per chunk (the stash holds chunk x 128 points)
  int nchunks, g1, nsplit;
};

Plan make_plan(int n, int s) {
  Plan p;
  p.tiles = (long)s * ((n + TILE - 1) / TILE);
  p.chunk = (int)(p.tiles < CHUNK_TILES ? p.tiles : CHUNK_TILES);
  p.nchunks = (int)((p.tiles + p.chunk - 1) / p.chunk);
  const int nsm = sm_count();
  p.g1 = p.chunk < nsm ? p.chunk : nsm;
  // about two waves of weight-gradient blocks, at least one slab each
  p.nsplit = (2 * nsm + N_WTILES - 1) / N_WTILES;
  const int slabs = p.chunk * TILE / PK;
  if (p.nsplit > slabs) p.nsplit = slabs;
  return p;
}

}  // namespace

// Workspace the caller allocates for nerf_bwd_rays at (n, s), in elements:
// sizes[0] transposed weights (bf16), [1] stash (bf16), [2] chain partials
// (float32), [3] weight-gradient partials (float32).
extern "C" void nerf_bwd_rays_workspace(int n, int s, long* sizes) {
  const Plan p = make_plan(n, s);
  sizes[0] = WT_TOTAL;
  sizes[1] = (long)p.chunk * TILE * ST_PER_POINT;
  sizes[2] = (long)p.nchunks * p.g1 * PART1;
  sizes[3] = (long)p.nchunks * p.nsplit * WG_TOTAL;
}

extern "C" int nerf_bwd_rays(const float* od, const float* z, const float* gr, const float* gg,
                             const float* gb, const float* gs, const void* w, const float* b,
                             void* wt, void* stash, float* part1, float* part2, float* dw,
                             float* db, int n, int s, int L_x, int L_d, void* stream) {
  const Plan p = make_plan(n, s);
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bf16* wb = reinterpret_cast<const bf16*>(w);
  bf16* wtb = reinterpret_cast<bf16*>(wt);
  bf16* sb = reinterpret_cast<bf16*>(stash);
  const long pc = (long)p.chunk * TILE;
  int rc;
  if ((rc = launch_prep(bwd_chain_kernel, SMEM_CHAIN))) return rc;
  if ((rc = launch_prep(wgrad_kernel, SMEM_WGRAD))) return rc;
  transpose_kernel<<<(int)((WT_TOTAL + 255) / 256), 256, 0, st>>>(wb, wtb);
  if ((rc = (int)cudaGetLastError())) return rc;
  for (int c = 0; c < p.nchunks; ++c) {
    const long t0 = (long)c * p.chunk;
    const int ntc = (int)(p.tiles - t0 < p.chunk ? p.tiles - t0 : p.chunk);
    bwd_chain_kernel<<<p.g1, THREADS, SMEM_CHAIN, st>>>(od, z, gr, gg, gb, gs, wb, b, wtb, sb,
                                                        part1 + (long)c * p.g1 * PART1, n, L_x,
                                                        L_d, t0, ntc, pc);
    if ((rc = (int)cudaGetLastError())) return rc;
    wgrad_kernel<<<dim3(N_WTILES, p.nsplit), THREADS, SMEM_WGRAD, st>>>(
        sb, pc, ntc * TILE, part2 + (long)c * p.nsplit * WG_TOTAL);
    if ((rc = (int)cudaGetLastError())) return rc;
  }
  reduce_kernel<<<(int)((W_TOTAL + B_TOTAL + 255) / 256), 256, 0, st>>>(
      part2, p.nchunks * p.nsplit, part1, p.nchunks * p.g1, dw, db);
  return (int)cudaGetLastError();
}
