// Backward of the fused NeRF MLP, for Hopper (sm_90a): K2, K6 and K9.
//
//   nerf_bwd_rays    replaces the JAX package's TPU kernels
//                    kernels/fused_mlp_vjp.py::_bwd_rays_kernel (_bwd_rays_call,
//                    gate=None; K2) and _bwd_rays_kernel_gated (gate given; K6):
//                    for every sample of every ray, recompute the forward
//                    (nothing is kept from nerf_eval_rays) and chain the
//                    cotangents of (r, g, b, sigma) back to float32 gradients
//                    of all 26 packed weights and biases, summed over all
//                    points.  With a gate, the samples of every gated-off
//                    block add nothing and are not computed.
//   nerf_bwd_points  replaces kernels/fused_mlp_vjp.py::_bwd_kernel (K9, via
//                    _bwd_call): the same at the points of the planes x and d
//                    [3, P] (the backward of nerf_eval_points), cotangents
//                    [4, P].  It is K2's three launches with S = 1 and a chain
//                    tile of 128 consecutive points; each point embeds its
//                    own direction, as given, so wvd and bv get per-point
//                    deltas (K2 stashes the direction embedding per point
//                    already).  FLOP: K2's count per point (bwd_flop_per_sample,
//                    which counts wvd's gradient per sample) plus the direction
//                    product that K2 takes once per ray and K9 once per point
//                    (kernels/fused_mlp.py::bwd_flop_per_point); bound by
//                    operations.
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
//     time): recompute the forward, then the chain of input gradients
//     dh = g W^T, every product on wgmma (hopper_mma.cuh; the forward
//     products' code, hopper_mlp.cuh, is shared with the ray kernels of
//     fused_mlp.cu).  Two consumer warpgroups each carry 64 of the tile's
//     points through the whole MLP;
//     a producer warpgroup streams the weights by TMA into a 3-stage
//     mbarrier ring that both read, and hands its registers to them
//     (setmaxnreg: 232 a consumer thread).  Forward products read
//     W [in][out] as an MN-major operand, backward ones the same W as a
//     K-major operand, so no transposed copy of the weights is made.  Bias,
//     ReLU, the bf16 rounding and the density cotangent term are applied to
//     the accumulator in registers; each trunk layer's ReLU bits stay in
//     shared memory (4 KB a layer for 128 points) for the backward.  Every
//     bf16 activation and masked delta that a weight gradient needs goes to
//     a stash in device memory (4832 values per point, ~9.7 KB) by TMA
//     store: once an epilogue's tile is in shared memory (fenced to the
//     async proxy, behind the warpgroup's barrier), one thread of each
//     warpgroup stores its 64 rows through the stash's own tensor maps (the
//     weight-gradient launch's, 64 x 64 boxes in the tile's swizzle) and the
//     warpgroup goes straight on to the next product, which only reads the
//     same tile.  That thread waits for its stores to have read the tile
//     (wait_group.read) only before the barrier that precedes the next
//     write of the tile (an epilogue in place, the next embedding, the next
//     tile), one product later, by when they have long been read; the block
//     waits for the writes themselves before it exits, so the
//     weight-gradient launch sees a complete stash.  The stores mark their
//     L2 lines evict-first: a chunk's 1.27 GB stash only passes through L2,
//     and as ordinary lines it pushed out the weights that every tile
//     streams from L2 twice (~2.4 MB a tile) and stalled the products on
//     them (the chain launch took a third longer).  So the stash costs the
//     launch about a tenth of its time; the rest is the products and,
//     between them, the epilogues and column sums that both warpgroups run
//     in lockstep while the tensor cores idle (PERF.md has the split).
//     Bias and head-weight gradients, cheap CUDA-core sums, accumulate in
//     each warpgroup's partial in device memory over all its tiles.
//  2. wgrad_kernel: every weight gradient dW = H^T G is a product over the
//     points; a block owns a 128 x 128 tile of one dW and a contiguous range
//     of points, keeps the tile in registers over the whole range and writes
//     it once.  Hopper's machinery (hopper_mma.cuh): a producer warp streams
//     64-point slabs of H and G by TMA into a 4-stage mbarrier ring, two
//     consumer warpgroups run wgmma (bf16 -> f32) on them, both operands read
//     MN-major from the point-major stash, so H^T is never copied.  What
//     bounds it: bytes.  Its products are 1.19 MFLOP a point (1.2 us of
//     tensor-core time per 1000 points) against the 9.7 KB of stash a point
//     it must read, all of the stash (2.9 us per 1000 points at 3.35 TB/s).
//  3. reduce_kernel: the partials of every block and chunk are added in a
//     fixed order.  No atomics anywhere: two launches on the same inputs
//     give the same bits, which a bit-exact resume relies on.
// Points go through in chunks of at most 1024 tiles (131072 points, a
// 1.27 GB stash), the stash reused from chunk to chunk.
//
// The gate (K6): int32 [ceil(N / 128) * (S / 8)], tile-major over (128-ray
// block, 8-sample row), as the forward kernels read it.  The TPU kernel skips
// a grid step; here skipping a chain tile alone would leave the weight-gradient
// kernel contracting over stash rows that hold another chunk's points.  So
// compact_tiles_kernel (one block, a prefix sum over the gate, no atomics)
// first writes the list of active (sample, ray-tile) chain tiles in K2's order
// and its length to device memory.  The chain kernel walks that list instead
// of the tile range and stashes compactly; its per-block bias and head partials
// see active tiles only; the weight-gradient kernel contracts over the active
// points of its chunk.  The chunks are K2's (the launch count is set by all
// S x ray tiles, so the host never reads the active count): a chunk past the
// list's end runs blocks that write zero partials and exit.  An all-on gate
// gives the identity list, hence K2's tile order, chunking and reduction, and
// K2's bits.  The stash traffic (~9.7 KB a point, written by the chain
// launch behind its products and read back by the weight-gradient launch)
// is this design's cost beside the tensor-core rate; PERF.md has the times.

#include "hopper_mlp.cuh"

namespace {

// stash: point-major bf16 arrays of a chunk of pc points; array X starts at
// ST_X * pc, h_i at (ST_H0 + 256 i) * pc, g_i at (ST_G0 + 256 i) * pc.
// Every array is read by the weight-gradient launch (hv, which no product
// needs, is not stashed).
constexpr long ST_EMBX = 0;
constexpr long ST_H0 = 64;
constexpr long ST_FEAT = 2112;
constexpr long ST_EMBD = 2368;
constexpr long ST_G0 = 2400;
constexpr long ST_DFEAT = 4448;
constexpr long ST_DHV = 4704;
constexpr long ST_PER_POINT = 4832;

// per-warpgroup partial of the chain kernel, in device memory and added to in
// place over the block's tiles: the bias gradients (packed b layout), then
// the head weights' (wdens 256, wcol 128 x 3)
constexpr int PART1 = B_TOTAL + WIDTH + HALF * 3;   // 3088 floats
constexpr long WG_TOTAL = OFF_WDENS;                // the weights wgrad_kernel covers

constexpr int CHUNK_TILES = 1024;

// chain kernel: two consumer warpgroups, each 64 of the tile's 128 points
// through the whole MLP, and a producer warpgroup (one thread streams the
// weights) that gives its registers to the consumers: 40 against 232 a
// thread, for the 64 x 256 float32 accumulator (128 a thread)
constexpr int CH_THREADS = 384;
constexpr int CH_PRODUCER_REGS = 40, CH_CONSUMER_REGS = 232;
// shared memory (bytes): operand tiles are column blocks of 64, each row 128
// bytes with the 128-byte swizzle (hopper_mma.cuh), 1024-byte aligned
constexpr int SM_ACT = 4 * CB;           // h_i, feat, hv, then the deltas, in place
constexpr int SM_EMB = CB;               // embx, then embd in columns 0-31
constexpr int SM_RING = CH_STAGES * CH_STAGE;
constexpr int SM_MASK = 8 * 4 * 256 * 4; // ReLU bits of h0..h7: 4 words a thread a layer
constexpr int SM_RAYS = TILE * 8 * 4;
constexpr int SM_GOUT = TILE * 4 * 4;    // cotangents (r, g, b, sigma)
constexpr int SM_HEADS = (WIDTH + HALF * 3) * 4;   // wdens 256, wcol 128 x 3
constexpr int SM_ZROW = TILE * 4;
constexpr int SMEM_CHAIN = 1024 + SM_ACT + SM_EMB + SM_RING + SM_MASK + SM_RAYS + SM_GOUT +
                           SM_HEADS + SM_ZROW + 2 * CH_STAGES * 8;

// weight-gradient kernel: 128 x 128 output tiles, 64-point slabs in a ring
// of WG_STAGES stages, each two A and two G boxes of 64 columns x 64 points
constexpr int TM = 128, TN = 128, PK = 64;
constexpr int WGRAD_THREADS = 384;                  // 2 consumer warpgroups + 1 producer
constexpr int WG_STAGES = 4;
constexpr int WG_BOX = 64 * PK * 2;                 // 8192 bytes
constexpr int WG_STAGE_BYTES = 4 * WG_BOX;
constexpr int SMEM_WGRAD = 1024 + WG_STAGES * WG_STAGE_BYTES + 2 * WG_STAGES * 8;

// The chain kernel's tensor maps: the forward ones (hopper_mlp.cuh) and the
// backward ones, K-major views of the same weights
struct CMaps {
  CUtensorMap m[N_CMAPS];
};
constexpr int N_PRODS = 21;

// The stash's tensor maps (wgrad_maps), in boxes of 64 columns x 64 points
// with the 128-byte swizzle: the chain launch stores through them, the
// weight-gradient launch loads.  h0..h7 and feat are 9 consecutive
// [pc][256] arrays (WMAP_H), g0..g7 and dfeat another 9 (WMAP_G).
enum { WMAP_H, WMAP_G, WMAP_EMBX, WMAP_EMBD, WMAP_DHV, N_WMAPS };
struct WMaps {
  CUtensorMap m[N_WMAPS];
};
static_assert(ST_FEAT == ST_H0 + 8 * WIDTH && ST_DFEAT == ST_G0 + 8 * WIDTH,
              "the stash's 256-wide arrays are not evenly spaced");

__device__ __forceinline__ Prod prod(int i) {
  if (i < N_FWD_PRODS) return fwd_prod(i);                                 // h0 .. hv
  if (i == 12) return {CMAP_W128B, 0, HALF};                               // dfeat
  if (i == 13) return {CMAP_W256B, (int)(OFF_WFEAT / WIDTH), WIDTH};       // g7
  return {CMAP_W256B, (int)(trunk_off(7 - (i - 14)) / WIDTH), WIDTH};      // g6..g0
}

// delta epilogue: out <- round(v) with v = acc (+ g_sigma[p] wdens[c] when
// gout is given), zeroed where the ReLU bit of the activation (mask, as
// chain_epilogue stored it) is clear; no mask: kept
__device__ __forceinline__ void chain_epilogue_delta(const float (&acc)[128],
                                                     const uint32_t* mask, const float* gout,
                                                     const float* wdens, unsigned char* out,
                                                     int row0) {
  uint32_t bits[4] = {~0u, ~0u, ~0u, ~0u};
  if (mask) {
#pragma unroll
    for (int w = 0; w < 4; ++w) bits[w] = mask[w * 256 + threadIdx.x];
  }
#pragma unroll
  for (int i = 0; i < 128; i += 2) {
    const int r = acc_row(row0, i), c = acc_col(i);
    float v0 = acc[i], v1 = acc[i + 1];
    if (gout) {
      const float g = gout[r * 4 + 3];
      v0 += g * wdens[c];
      v1 += g * wdens[c + 1];
    }
    if (!((bits[i >> 5] >> (i & 31)) & 1u)) v0 = 0.0f;
    if (!((bits[i >> 5] >> ((i + 1) & 31)) & 1u)) v1 = 0.0f;
    *reinterpret_cast<__nv_bfloat162*>(out + sw_off(r, c)) = __floats2bfloat162_rn(v0, v1);
  }
}

// The warpgroup's 64 rows of `boxes` column blocks of a swizzled tile (t:
// its rows of the first block, as TMA lays a 64 x 64 box out) -> stash
// array `arr` of map `id`, rows q .. q + 63: one TMA store a block, issued
// by the warpgroup's first thread and committed as one bulk group, its
// lines first out of L2 (read back only by the weight-gradient launch,
// after the chunk's 1.27 GB has passed through).  The tile must be visible
// to the async proxy (fence_proxy_async, then the warpgroup's barrier), and
// stays read until stash_drain.
__device__ __forceinline__ void stash_wg(const WMaps& maps, int id, int arr,
                                         const unsigned char* t, int boxes, int q) {
  if ((threadIdx.x & 127) != 0) return;
  const uint64_t policy = hopper::l2_evict_first();
  for (int bx = 0; bx < boxes; ++bx) {
    if (id <= WMAP_G)
      hopper::tma_store_3d(&maps.m[id], t + bx * CB, 64 * bx, q, arr, policy);
    else
      hopper::tma_store_2d(&maps.m[id], t + bx * CB, 64 * bx, q, policy);
  }
  hopper::bulk_commit();
}

// before the warpgroup's barrier that precedes an overwrite of a tile that
// stash_wg may still read: its first thread waits until every store it
// issued has read its source (after a product, long since the case), so no
// thread passes the barrier before then
__device__ __forceinline__ void stash_drain() {
  if ((threadIdx.x & 127) == 0) hopper::bulk_wait_read<0>();
}

// dst[c] += sum over the warpgroup's 64 rows of t[r][c] (fixed order); dst is
// this warpgroup's own partial, each entry always added to by one thread
__device__ __forceinline__ void colsum_wg(const unsigned char* t, int row0, int width,
                                          float* dst) {
  for (int c = threadIdx.x & 127; c < width; c += 128) {
    float s = 0.0f;
    for (int r = row0; r < row0 + 64; ++r) s += ld_sw(t, r, c);
    dst[c] += s;
  }
}

// K6: list[0 .. *count) <- the chain tiles (k * ray_tiles + ray tile, K2's
// order) whose gate entry is on.  One block: each thread counts a contiguous
// run of tiles, a prefix sum over the block places each run.
constexpr int COMPACT_THREADS = 1024;

__global__ void __launch_bounds__(COMPACT_THREADS)
compact_tiles_kernel(const int* __restrict__ gate, int ray_tiles, int s, int* list,
                     int* count) {
  __shared__ int scan[COMPACT_THREADS];
  const int tid = threadIdx.x;
  const long total = (long)s * ray_tiles;
  const long per = (total + COMPACT_THREADS - 1) / COMPACT_THREADS;
  const long t0 = tid * per, t1 = t0 + per < total ? t0 + per : total;
  const int rows = s >> 3;
  auto on = [&](long t) {
    const int k = (int)(t / ray_tiles), rt = (int)(t % ray_tiles);
    return gate[(long)rt * rows + (k >> 3)] != 0;
  };
  int c = 0;
  for (long t = t0; t < t1; ++t) c += on(t);
  scan[tid] = c;
  __syncthreads();
  for (int off = 1; off < COMPACT_THREADS; off <<= 1) {  // inclusive prefix sum
    const int v = tid >= off ? scan[tid - off] : 0;
    __syncthreads();
    scan[tid] += v;
    __syncthreads();
  }
  int at = scan[tid] - c;
  for (long t = t0; t < t1; ++t)
    if (on(t)) list[at++] = (int)t;
  if (tid == COMPACT_THREADS - 1) *count = scan[tid];
}

// the chain tiles of the chunk starting at tile0 (list position with a gate):
// ntiles, cut to the active count where it is given
__device__ __forceinline__ int chunk_tiles(const int* count, long tile0, int ntiles) {
  if (count == nullptr) return ntiles;
  const long left = (long)*count - tile0;
  return left <= 0 ? 0 : (left < ntiles ? (int)left : ntiles);
}

// dplane null: rays, od [8, N] and z [S, N].  dplane given (K9): points, od
// the position plane [3, N] and dplane the direction plane [3, N] (S = 1,
// z unused); the directions are embedded as given.
//
// Warpgroup w (threads 128 w .. 128 w + 127) owns rows 64 w .. 64 w + 63 of
// every tile: it loads them, builds their embedding, runs every product on
// them with wgmma (A: its rows of the swizzled activation tile in shared
// memory; B: the weights from the ring, read by both warpgroups), applies
// bias, ReLU, rounding and the density cotangent term to the accumulator
// in registers, keeps each trunk layer's ReLU bits in shared memory for the
// backward, and stashes every activation and delta by TMA store (stash_wg)
// while its next product runs on the same tile.  The two warpgroups meet
// only at the ring's barriers.  Warpgroup 2
// produces: its first thread walks the same tiles and products and keeps
// the ring full by TMA.  The bias and head-weight gradients of each warpgroup add up in
// its own partial in device memory.
__global__ void __launch_bounds__(CH_THREADS, 1)
bwd_chain_kernel(__grid_constant__ const CMaps maps, __grid_constant__ const WMaps smaps,
                 const float* __restrict__ od, const float* __restrict__ z,
                 const float* __restrict__ dplane, const float* __restrict__ gr,
                 const float* __restrict__ gg, const float* __restrict__ gb,
                 const float* __restrict__ gs, const bf16* __restrict__ w,
                 const float* __restrict__ b, float* part1, int n, int L_x, int L_d, long tile0,
                 int ntiles, const int* __restrict__ list, const int* __restrict__ count) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* const act = hopper::align1024(smem_raw);
  unsigned char* const emb = act + SM_ACT;
  unsigned char* const ring = emb + SM_EMB;
  uint32_t* const maskbuf = reinterpret_cast<uint32_t*>(ring + SM_RING);
  float* const rays = reinterpret_cast<float*>(ring + SM_RING + SM_MASK);
  float* const gout = rays + TILE * 8;
  float* const heads = gout + TILE * 4;   // wdens [256], wcol [128][3]
  float* const zrow = heads + WIDTH + HALF * 3;
  uint64_t* const full = reinterpret_cast<uint64_t*>(zrow + TILE);
  uint64_t* const empty = full + CH_STAGES;
  const int tid = threadIdx.x;

  const int ray_tiles = (n + TILE - 1) / TILE;
  ntiles = chunk_tiles(count, tile0, ntiles);
  const int t_begin = (int)((long)blockIdx.x * ntiles / gridDim.x);
  const int t_end = (int)((long)(blockIdx.x + 1) * ntiles / gridDim.x);

  if (tid == 0) {
    for (int s = 0; s < CH_STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);   // the 8 consumer warps
    }
    hopper::fence_barrier_init();
  }
  for (int i = tid; i < WIDTH; i += CH_THREADS) heads[i] = __bfloat162float(w[OFF_WDENS + i]);
  for (int i = tid; i < HALF * 3; i += CH_THREADS)
    heads[WIDTH + i] = __bfloat162float(w[OFF_WCOL + i]);
  __syncthreads();

  if (tid >= 256) {   // producer warpgroup
    hopper::setmaxnreg_dec<CH_PRODUCER_REGS>();
    if (tid == 256) {
      uint32_t it = 0;
      for (int t = t_begin; t < t_end; ++t) {
        for (int pi = 0; pi < N_PRODS; ++pi) {
          const Prod pr = prod(pi);
          const bool fwd = pr.map == CMAP_W256F || pr.map == CMAP_W128F;
          for (int c = 0; c * 64 < pr.k; ++c, ++it) {
            const int s = it % CH_STAGES;
            if (it >= CH_STAGES) hopper::mbar_wait(&empty[s], ((it / CH_STAGES) - 1) & 1);
            unsigned char* st = ring + s * CH_STAGE;
            if (fwd) {
              load_fwd_stage(st, maps.m, pr, c, &full[s]);
            } else {
              hopper::mbar_expect_tx(&full[s], CH_STAGE);
              hopper::tma_load_2d(st, &maps.m[pr.map], &full[s], 64 * c, pr.row0);
            }
          }
        }
      }
    }
    return;
  }

  hopper::setmaxnreg_inc<CH_CONSUMER_REGS>();
  const int wg = tid >> 7, row0 = 64 * wg, bar = 1 + wg;
  const unsigned char* const a_act = act + wg * 8192;   // its rows of each column block
  const unsigned char* const a_emb = emb + wg * 8192;
  float* const pw = part1 + ((long)blockIdx.x * 2 + wg) * PART1;
  for (int i = tid & 127; i < PART1; i += 128) pw[i] = 0.0f;

  uint32_t it = 0;
  float acc[128];
#pragma unroll 1
  for (int t = t_begin; t < t_end; ++t) {
    const long tg = list ? (long)list[tile0 + t] : tile0 + t;
    const int k = (int)(tg / ray_tiles), ray0 = (int)(tg % ray_tiles) * TILE;
    const int q = t * TILE + row0;    // the stash row of our first row
    stash_drain();                    // the previous tile's last stores
    hopper::named_barrier(bar, 128);  // the previous tile is done with our rows
    load_wg(rays, zrow, gout, od, z, dplane, gr, gg, gb, gs, n, k, ray0, row0);
    hopper::named_barrier(bar, 128);
    if (dplane)
      emb_wg(emb, rays, nullptr, L_x, EMBX, 0, false, row0);
    else
      emb_wg(emb, rays, zrow, L_x, EMBX, 0, true, row0);
    hopper::fence_proxy_async();
    hopper::named_barrier(bar, 128);
    stash_wg(smaps, WMAP_EMBX, 0, a_emb, 1, q);

    // ---- forward recompute, every activation to the stash -------------
    zero_acc(acc);
    chain_gemm<WIDTH, true>(acc, a_emb, EMBX, ring, full, empty, it);
    chain_epilogue<WIDTH>(acc, b + OFF_B0, true, act, row0, maskbuf);
    hopper::fence_proxy_async();
    hopper::named_barrier(bar, 128);
    stash_wg(smaps, WMAP_H, 0, a_act, 4, q);
#pragma unroll 1
    for (int i = 1; i <= 7; ++i) {
      zero_acc(acc);
      if (i == 5) chain_gemm<WIDTH, true>(acc, a_emb, EMBX, ring, full, empty, it);  // skip
      chain_gemm<WIDTH, true>(acc, a_act, WIDTH, ring, full, empty, it);
      stash_drain();  // h_{i-1}'s store; at i = 1 embx's too, before embd below
      hopper::named_barrier(bar, 128);   // every warp is done reading h_{i-1}
      chain_epilogue<WIDTH>(acc, b + OFF_B0 + WIDTH * i, true, act, row0, maskbuf + i * 1024);
      hopper::fence_proxy_async();
      hopper::named_barrier(bar, 128);
      stash_wg(smaps, WMAP_H, i, a_act, 4, q);
    }
    {  // density head: dwdens[c] += sum_p h7[p][c] g_sigma[p]
      for (int c = tid & 127; c < WIDTH; c += 128) {
        float s = 0.0f;
        for (int r = row0; r < row0 + 64; ++r) s += ld_sw(act, r, c) * gout[r * 4 + 3];
        pw[B_TOTAL + c] += s;
      }
    }
    // the embedding is free after the skip layer; K9's directions as given
    emb_wg(emb, rays, nullptr, L_d, EMBD, 3, dplane == nullptr, row0);
    hopper::fence_proxy_async();
    zero_acc(acc);  // feature layer (no activation), in place
    chain_gemm<WIDTH, true>(acc, a_act, WIDTH, ring, full, empty, it);
    stash_drain();  // h7's store
    hopper::named_barrier(bar, 128);
    chain_epilogue<WIDTH>(acc, b + OFF_BFEAT, false, act, row0, nullptr);
    hopper::fence_proxy_async();
    hopper::named_barrier(bar, 128);
    stash_wg(smaps, WMAP_H, 8, a_act, 4, q);  // feat
    stash_wg(smaps, WMAP_EMBD, 0, a_emb, 1, q);
    {  // view layer: relu(embd @ wvd + feat @ wvf + bv) -> columns 0-127
      float acc2[64];
      zero_acc(acc2);
      chain_gemm<HALF, true>(acc2, a_emb, EMBD, ring, full, empty, it);
      chain_gemm<HALF, true>(acc2, a_act, WIDTH, ring, full, empty, it);
      stash_drain();  // feat's and embd's stores
      hopper::named_barrier(bar, 128);
      chain_epilogue<HALF>(acc2, b + OFF_BV, true, act, row0, nullptr);
    }
    hopper::named_barrier(bar, 128);  // hv visible (no store is pending)

    // ---- backward -------------------------------------------------------
    for (int idx = tid & 127; idx < HALF * 3; idx += 128) {  // dwcol[k][c]
      const int kk = idx / 3, c = idx % 3;
      float s = 0.0f;
      for (int r = row0; r < row0 + 64; ++r) s += ld_sw(act, r, kk) * gout[r * 4 + c];
      pw[B_TOTAL + WIDTH + idx] += s;
    }
    if ((tid & 127) < 4) {  // dbcol, dbdens
      const int c = tid & 127;
      float s = 0.0f;
      for (int r = row0; r < row0 + 64; ++r) s += gout[r * 4 + c];
      pw[c < 3 ? OFF_BCOL + c : OFF_BDENS] += s;
    }
    hopper::named_barrier(bar, 128);  // every read of hv is done
    // dhv = mask(hv > 0, g_rgb @ wcol^T), bf16, in place
    for (int idx = tid & 127; idx < 64 * HALF; idx += 128) {
      const int r = row0 + idx / HALF, kk = idx % HALF;
      float v = 0.0f;
      if (ld_sw(act, r, kk) > 0.0f) {
        const float* wc = heads + WIDTH + kk * 3;
        v = wc[0] * gout[r * 4] + wc[1] * gout[r * 4 + 1] + wc[2] * gout[r * 4 + 2];
      }
      st_sw(act, r, kk, v);
    }
    hopper::fence_proxy_async();
    hopper::named_barrier(bar, 128);
    stash_wg(smaps, WMAP_DHV, 0, a_act, 2, q);
    colsum_wg(act, row0, HALF, pw + OFF_BV);
    zero_acc(acc);  // dfeat = dhv @ wvf^T, bf16
    chain_gemm<WIDTH, false>(acc, a_act, HALF, ring, full, empty, it);
    stash_drain();
    hopper::named_barrier(bar, 128);
    chain_epilogue_delta(acc, nullptr, nullptr, heads, act, row0);
    hopper::fence_proxy_async();
    hopper::named_barrier(bar, 128);
    stash_wg(smaps, WMAP_G, 8, a_act, 4, q);  // dfeat
    colsum_wg(act, row0, WIDTH, pw + OFF_BFEAT);
    zero_acc(acc);  // g7 = mask(h7, dfeat @ wfeat^T + g_sigma wdens)
    chain_gemm<WIDTH, false>(acc, a_act, WIDTH, ring, full, empty, it);
    stash_drain();
    hopper::named_barrier(bar, 128);
    chain_epilogue_delta(acc, maskbuf + 7 * 1024, gout, heads, act, row0);
    hopper::fence_proxy_async();
    hopper::named_barrier(bar, 128);
    stash_wg(smaps, WMAP_G, 7, a_act, 4, q);
    colsum_wg(act, row0, WIDTH, pw + OFF_B0 + WIDTH * 7);
#pragma unroll 1
    for (int j = 7; j >= 1; --j) {  // g_{j-1} = mask(h_{j-1}, g_j @ W_j^T)
      zero_acc(acc);
      chain_gemm<WIDTH, false>(acc, a_act, WIDTH, ring, full, empty, it);
      stash_drain();
      hopper::named_barrier(bar, 128);
      chain_epilogue_delta(acc, maskbuf + (j - 1) * 1024, nullptr, heads, act, row0);
      hopper::fence_proxy_async();
      hopper::named_barrier(bar, 128);
      stash_wg(smaps, WMAP_G, j - 1, a_act, 4, q);
      colsum_wg(act, row0, WIDTH, pw + OFF_B0 + WIDTH * (j - 1));
    }
  }
  // the stash is complete before the block exits (the weight-gradient
  // launch that follows reads it)
  if ((tid & 127) == 0) hopper::bulk_wait<0>();
}

// the weight gradients dW = A^T G of wgrad_kernel: A and G are stash arrays,
// each named by a tensor map (WMAP_*) and an array index within it
struct WJob {
  int amap, aarr, gmap, garr;
  long out;   // packed offset of dW
  int kin, nout;
};

__host__ __device__ WJob wjob(int j) {
  if (j == 0) return {WMAP_EMBX, 0, WMAP_G, 0, OFF_W0, EMBX, WIDTH};
  if (j <= 4) return {WMAP_H, j - 1, WMAP_G, j, trunk_off(j), WIDTH, WIDTH};
  if (j == 5) return {WMAP_EMBX, 0, WMAP_G, 5, OFF_W5E, EMBX, WIDTH};
  if (j <= 8) return {WMAP_H, j - 2, WMAP_G, j - 1, trunk_off(j - 1), WIDTH, WIDTH};  // w5h, w6, w7
  if (j == 9) return {WMAP_H, 7, WMAP_G, 8, OFF_WFEAT, WIDTH, WIDTH};
  if (j == 10) return {WMAP_H, 8, WMAP_DHV, 0, OFF_WVF, WIDTH, HALF};
  return {WMAP_EMBD, 0, WMAP_DHV, 0, OFF_WVD, EMBD, HALF};
}
constexpr int N_WJOBS = 12;
constexpr int N_WTILES = 39;   // sum over the jobs of ceil(kin/TM) * ceil(nout/TN)

// one 64-column x PK-point box of map `id` (array arr) into dst
__device__ __forceinline__ void wload(const WMaps& maps, int id, int arr, void* dst, uint64_t* bar,
                                      int col, int p0) {
  if (id <= WMAP_G)
    hopper::tma_load_3d(dst, &maps.m[id], bar, col, p0, arr);
  else
    hopper::tma_load_2d(dst, &maps.m[id], bar, col, p0);
}

// Block (tile, split): the TM x TN tile `tile` of the jobs' dW over the
// split's range of 64-point slabs.  Warpgroups 0 and 1 consume: each owns
// 64 rows of the tile (warpgroup 1 idles where the job has <= 64 rows:
// embx, embd) and keeps its 64 x 128 float32 accumulator in registers over
// the whole range.  Warp 8 produces: its first lane streams the slabs by
// TMA into a WG_STAGES-deep ring (per stage the A boxes of the active
// warpgroups and two G boxes, 64 columns x 64 points each, 128-byte
// swizzle), signalled by mbarriers.  Both wgmma operands are MN-major
// views of the point-major stash: A^T needs no copy.
__global__ void __launch_bounds__(WGRAD_THREADS, 1)
wgrad_kernel(__grid_constant__ const WMaps maps, int ntiles, float* __restrict__ part2,
             const int* __restrict__ count, long tile0) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* ring = hopper::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + WG_STAGES * WG_STAGE_BYTES);
  uint64_t* empty = full + WG_STAGES;

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
  const int mrows = min(TM, job.kin - m0);
  const int n_a = mrows > 64 ? 2 : 1;   // A boxes = active consumer warpgroups
  const int nsteps = chunk_tiles(count, tile0, ntiles) * TILE / PK;
  const int st0 = (int)((long)blockIdx.y * nsteps / gridDim.y);
  const int nst = (int)((long)(blockIdx.y + 1) * nsteps / gridDim.y) - st0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);   // the 8 consumer warps
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == 2) {   // producer
    if (threadIdx.x == 256) {
      for (int i = 0; i < nst; ++i) {
        const int s = i % WG_STAGES;
        if (i >= WG_STAGES) hopper::mbar_wait(&empty[s], ((i / WG_STAGES) - 1) & 1);
        unsigned char* buf = ring + s * WG_STAGE_BYTES;
        const int p0 = (st0 + i) * PK;
        hopper::mbar_expect_tx(&full[s], (n_a + 2) * WG_BOX);
        for (int a = 0; a < n_a; ++a)
          wload(maps, job.amap, job.aarr, buf + a * WG_BOX, &full[s], m0 + 64 * a, p0);
        for (int g = 0; g < 2; ++g)
          wload(maps, job.gmap, job.garr, buf + (2 + g) * WG_BOX, &full[s], n0 + 64 * g, p0);
      }
    }
    return;
  }

  // consumers
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  const bool active = wg < n_a;
  for (int i = 0; i < nst; ++i) {
    const int s = i % WG_STAGES;
    hopper::mbar_wait(&full[s], (i / WG_STAGES) & 1);
    if (active) {
      const unsigned char* buf = ring + s * WG_STAGE_BYTES;
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < PK / 16; ++kk) {
        const uint64_t da = hopper::desc_sw128(buf + wg * WG_BOX + kk * 2048, WG_BOX, 1024);
        const uint64_t db = hopper::desc_sw128(buf + 2 * WG_BOX + kk * 2048, WG_BOX, 1024);
        hopper::wgmma_m64n128k16<1, 1>(acc, da, db);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
    }
    if ((threadIdx.x & 31) == 0) hopper::mbar_arrive(&empty[s]);
  }
  if (!active) return;
  const int t = threadIdx.x & 127;
  const int rows = min(64, mrows - 64 * wg);
  const int r0 = 16 * (t >> 5) + ((t & 31) >> 2), c0 = 2 * (t & 3);
  float* out = part2 + (long)blockIdx.y * WG_TOTAL + job.out + (long)(m0 + 64 * wg) * job.nout + n0;
#pragma unroll
  for (int q = 0; q < 16; ++q) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      if (r < rows)
        *reinterpret_cast<float2*>(out + (long)r * job.nout + 8 * q + c0) =
            make_float2(acc[4 * q + 2 * h], acc[4 * q + 2 * h + 1]);
    }
  }
}

// the tensor maps of the stash of a chunk of pc points (base sb): the chain
// launch stores through them, the weight-gradient launch loads
int wgrad_maps(WMaps* maps, const bf16* sb, long pc) {
  using hopper::encode_bf16_map;
  const long span = (long)WIDTH * pc;
  int rc;
  if ((rc = encode_bf16_map(&maps->m[WMAP_H], sb + ST_H0 * pc, WIDTH, pc, 9, span, PK))) return rc;
  if ((rc = encode_bf16_map(&maps->m[WMAP_G], sb + ST_G0 * pc, WIDTH, pc, 9, span, PK))) return rc;
  if ((rc = encode_bf16_map(&maps->m[WMAP_EMBX], sb + ST_EMBX * pc, EMBX, pc, 1, 0, PK)))
    return rc;
  if ((rc = encode_bf16_map(&maps->m[WMAP_EMBD], sb + ST_EMBD * pc, EMBD, pc, 1, 0, PK)))
    return rc;
  return encode_bf16_map(&maps->m[WMAP_DHV], sb + ST_DHV * pc, HALF, pc, 1, 0, PK);
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
  // just under three waves of weight-gradient blocks (one block per SM),
  // at least one slab each
  p.nsplit = 3 * nsm / N_WTILES > 0 ? 3 * nsm / N_WTILES : 1;
  const int slabs = p.chunk * TILE / PK;
  if (p.nsplit > slabs) p.nsplit = slabs;
  return p;
}

// the chain kernel's tensor maps over the packed weights w: the forward maps
// (fwd_maps) and the backward ones, the same two arrays in 64 x 256 boxes
int chain_maps(CMaps* maps, const bf16* w) {
  using hopper::encode_bf16_map;
  const long rows256 = OFF_WVF / WIDTH, rows128 = (OFF_WDENS - OFF_WVF) / HALF;
  int rc;
  if ((rc = fwd_maps(maps->m, w))) return rc;
  if ((rc = encode_bf16_map(&maps->m[CMAP_W256B], w, WIDTH, rows256, 1, 0, 256))) return rc;
  return encode_bf16_map(&maps->m[CMAP_W128B], w + OFF_WVF, HALF, rows128, 1, 0, 256);
}

// the three launches of K2, K6 (gate given) or K9 (dplane given, S = 1)
int bwd_run(const float* od, const float* z, const float* dplane, const float* gr,
            const float* gg, const float* gb, const float* gs, const void* w, const float* b,
            void* stash, float* part1, float* part2, float* dw, float* db, const int* gate,
            int* tiles, int n, int s, int L_x, int L_d, void* stream) {
  const Plan p = make_plan(n, s);
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bf16* wb = reinterpret_cast<const bf16*>(w);
  bf16* sb = reinterpret_cast<bf16*>(stash);
  const long pc = (long)p.chunk * TILE;
  const int* list = gate ? tiles : nullptr;
  const int* count = gate ? tiles + p.tiles : nullptr;
  int rc;
  if ((rc = launch_prep(bwd_chain_kernel, SMEM_CHAIN))) return rc;
  if ((rc = launch_prep(wgrad_kernel, SMEM_WGRAD))) return rc;
  if (gate) {
    if (s % 8 != 0 || tiles == nullptr) return (int)cudaErrorInvalidValue;
    compact_tiles_kernel<<<1, COMPACT_THREADS, 0, st>>>(gate, (n + TILE - 1) / TILE, s, tiles,
                                                        tiles + p.tiles);
    if ((rc = (int)cudaGetLastError())) return rc;
  }
  CMaps cmaps;
  WMaps wmaps;
  if ((rc = chain_maps(&cmaps, wb))) return rc;
  if ((rc = wgrad_maps(&wmaps, sb, pc))) return rc;
  for (int c = 0; c < p.nchunks; ++c) {
    const long t0 = (long)c * p.chunk;
    const int ntc = (int)(p.tiles - t0 < p.chunk ? p.tiles - t0 : p.chunk);
    bwd_chain_kernel<<<p.g1, CH_THREADS, SMEM_CHAIN, st>>>(
        cmaps, wmaps, od, z, dplane, gr, gg, gb, gs, wb, b, part1 + (long)c * p.g1 * 2 * PART1,
        n, L_x, L_d, t0, ntc, list, count);
    if ((rc = (int)cudaGetLastError())) return rc;
    wgrad_kernel<<<dim3(N_WTILES, p.nsplit), WGRAD_THREADS, SMEM_WGRAD, st>>>(
        wmaps, ntc, part2 + (long)c * p.nsplit * WG_TOTAL, count, t0);
    if ((rc = (int)cudaGetLastError())) return rc;
  }
  reduce_kernel<<<(int)((W_TOTAL + B_TOTAL + 255) / 256), 256, 0, st>>>(
      part2, p.nchunks * p.nsplit, part1, p.nchunks * p.g1 * 2, dw, db);
  return (int)cudaGetLastError();
}

}  // namespace

// Workspace the caller allocates for nerf_bwd_rays at (n, s), in elements:
// sizes[0] stash (bf16), [1] chain partials (float32, one per warpgroup of
// every chain block and chunk), [2] weight-gradient partials (float32), [3]
// with a gate: the active tile list and its length (int32).
// nerf_bwd_points at P points takes the workspace of (P, 1).
extern "C" void nerf_bwd_rays_workspace(int n, int s, long* sizes) {
  const Plan p = make_plan(n, s);
  sizes[0] = (long)p.chunk * TILE * ST_PER_POINT;
  sizes[1] = (long)p.nchunks * p.g1 * 2 * PART1;
  sizes[2] = (long)p.nchunks * p.nsplit * WG_TOTAL;
  sizes[3] = p.tiles + 1;
}

// The plan and stash layout of nerf_bwd_rays at (n, s), for a caller that
// accounts for each launch's work: out[0] chunks, [1] points a chunk, [2]
// weight-gradient splits a chunk, [3] chain blocks a chunk, [4] bf16 values
// the chain launch stashes a point, [5] of them the values the
// weight-gradient launch reads a point (all of them), [6] its products' count
// J, then J pairs (rows, columns) of dW = A^T G in launch order.  Writes
// nothing unless cap holds them all; returns how many there are.
extern "C" int nerf_bwd_plan(int n, int s, long* out, int cap) {
  const int len = 7 + 2 * N_WJOBS;
  if (cap < len) return len;
  const Plan p = make_plan(n, s);
  out[0] = p.nchunks;
  out[1] = (long)p.chunk * TILE;
  out[2] = p.nsplit;
  out[3] = p.g1;
  out[4] = ST_PER_POINT;
  out[5] = ST_PER_POINT;
  out[6] = N_WJOBS;
  for (int j = 0; j < N_WJOBS; ++j) {
    const WJob job = wjob(j);
    out[7 + 2 * j] = job.kin;
    out[8 + 2 * j] = job.nout;
  }
  return len;
}

// gate null: K2; gate given (S % 8 == 0): K6, with tiles the sizes[3] ints
extern "C" int nerf_bwd_rays(const float* od, const float* z, const float* gr, const float* gg,
                             const float* gb, const float* gs, const void* w, const float* b,
                             void* stash, float* part1, float* part2, float* dw, float* db,
                             const int* gate, int* tiles, int n, int s, int L_x, int L_d,
                             void* stream) {
  return bwd_run(od, z, nullptr, gr, gg, gb, gs, w, b, stash, part1, part2, dw, db, gate, tiles,
                 n, s, L_x, L_d, stream);
}

// K9: x, d [3, P] (d as given), g [4, P] the cotangents of (r, g, b, sigma)
extern "C" int nerf_bwd_points(const float* x, const float* d, const float* g, const void* w,
                               const float* b, void* stash, float* part1, float* part2,
                               float* dw, float* db, int p, int L_x, int L_d, void* stream) {
  const long row = (long)p;
  return bwd_run(x, nullptr, d, g, g + row, g + 2 * row, g + 3 * row, w, b, stash, part1, part2,
                 dw, db, nullptr, nullptr, p, 1, L_x, L_d, stream);
}
