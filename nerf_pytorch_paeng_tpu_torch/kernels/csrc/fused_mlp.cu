// Fused NeRF MLP for Hopper (sm_90a): the forward kernels.
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
// 3-5) and z [S, N] float32 depths, or the planes x and d [3, P] float32,
// the packed weights of
// nerf_pytorch_paeng_tpu_torch/kernels/fused_mlp.py (bf16, [in, out] row-major
// per layer) and float32 biases.  The optional gate is int32
// [ceil(N / 128) * (S / 8)], tile-major over (128-ray block, 8-sample row):
// where it is 0 no work is done for those 8 samples of those rays and 0 is
// stored to every output (the caller certifies that their density logits
// are <= 0, so the compositing weights do not change).  Rounding follows the
// TPU kernels: bf16 operands, float32 accumulation, every hidden activation
// rounded to bf16, the feature layer without activation, the heads summed
// in float32 over the bf16 activations.
//
// What bounds them on this card: operations.  A sample costs ~0.99 MFLOP
// (sigma) or ~1.19 MFLOP (full field) of bf16 matrix products against 4 B
// of depth (a point: 12-24 B of planes) in and 2-16 B out, far above the
// ~295 FLOP/B at which an H100 stops being limited by device memory.  The
// weights (~1.2 MB in bf16) do not fit in the 227 KB of shared memory a
// block can use, so every 128-point tile streams them from L2 (127 FLOP a
// byte of L2 traffic).
//
// All four are one design (the walk is rays_walk below; its machinery is
// hopper_mlp.cuh, shared with the backward's chain launch):
//  * warp specialisation: a producer warpgroup (one thread issues, 40
//    registers by setmaxnreg) streams every product's weights by TMA, in
//    64-deep k-chunks of 32 KB (128-byte swizzle), into a 3-stage mbarrier
//    ring; two consumer warpgroups (232 registers) each carry 64 of a
//    tile's 128 points through the whole MLP with wgmma m64n256k16
//    (m64n128k16 for the view layer), bf16 -> f32, the activation tile
//    swizzled in shared memory as A and W [in][out] as the MN-major B;
//  * a register epilogue: bias, ReLU and the bf16 rounding on the
//    accumulator, stored as bf16 pairs into the tile; the 1-wide density
//    and 3-wide colour heads are float32 sums of the same rounded registers
//    across the 4 threads of a quad, so nothing makes a round trip through
//    shared memory but the activations themselves;
//  * the ray kernels build the positions x = o + d z and their double-angle
//    embedding in the block from od and z (no [3, P] plane in device
//    memory); the points kernels load x (and d) from their planes; the view
//    layer is embd @ wvd + feat @ wvf + bv in one accumulator, embd
//    embedding d / |d| at every sample of a ray, as the backward recomputes
//    it (6,912 FLOP a sample beside ~1.19 MFLOP, 0.6%), or a point's d as
//    given; no per-ray state, so any unit can go to any block;
//  * a persistent walk: about one block per SM walks units of 128 rays at
//    one sample (or 128 consecutive points), an equal share of them
//    whatever N, S or the gate (rays_walk); gated rows are taken out of the
//    walk by a fixed-order prefix sum over the gate, and their zeros are
//    stored by the producer warpgroup's idle warps;
//  * outputs: each warpgroup stores its 64 rays' (points') logits as
//    contiguous runs of a row of [S, N] (or [4, P]), float32 (training) or
//    bf16 (frames).
// With one trunk and head code, the four kernels' sigma agree bit for bit
// where their positions do (a point x is a ray with origin x at depth 0).
// Times against the bound are in PERF.md.

#include <chrono>

#include "hopper_mlp.cuh"

namespace {

template <bool OUT_BF16>
__device__ __forceinline__ void store_out(void* out, long i, float v) {
  if (OUT_BF16)
    reinterpret_cast<bf16*>(out)[i] = __float2bfloat16(v);
  else
    reinterpret_cast<float*>(out)[i] = v;
}

// ---- the walk: K1/K5 and K3/K4 along rays, K8 and K7 at points ------------

constexpr int FW_THREADS = 384;   // 2 consumer warpgroups + 1 producer warpgroup
constexpr int FW_PRODUCER_REGS = 40, FW_CONSUMER_REGS = 232;
constexpr int FW_LIST = 1024;     // gate entries one block's share can span
// shared memory (bytes), from a 1024-byte boundary: the activation tile (4
// column blocks), the embedding tile, the weight ring; then float32 rays
// [TILE][8], depths [TILE], head weights (wdens 256, wcol 128 x 3) and the
// unit's staged outputs [4][TILE]; the gate's prefix sum and the block's
// entry list; the ring's mbarriers
constexpr int FW_ACT = 4 * CB;
constexpr int FW_EMB = CB;
constexpr int FW_RING = CH_STAGES * CH_STAGE;
constexpr int FW_FLOATS = TILE * 8 + TILE + WIDTH + HALF * 3 + 4 * TILE;
constexpr int SMEM_FWD = 1024 + FW_ACT + FW_EMB + FW_RING + FW_FLOATS * 4 +
                         (FW_THREADS + FW_LIST) * 4 + 2 * CH_STAGES * 8;

struct FMaps {
  CUtensorMap m[N_FMAPS];
};

// The heads from the accumulator of a layer's output (64 x N, this
// warpgroup's rows): out[h][m] = sum over the columns c of
// round(relu(acc + bias))[c] * wv[c * M + m] for this thread's two rows
// (h = 0: acc_row(., 0); h = 1: 8 rows below), the activations rounded to
// bf16 as chain_epilogue stores them and summed in float32, first over the
// thread's own columns, then over the 4 threads of its quad, which hold the
// rest of those rows.
template <int N, int M>
__device__ __forceinline__ void head_dots(const float (&acc)[N / 2],
                                          const float* __restrict__ bias, const float* wv,
                                          float (&out)[2][M]) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int m = 0; m < M; ++m) out[h][m] = 0.0f;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int c = acc_col(i);
    const float v = __bfloat162float(__float2bfloat16(fmaxf(acc[i] + __ldg(bias + c), 0.0f)));
#pragma unroll
    for (int m = 0; m < M; ++m) out[(i >> 1) & 1][m] += v * wv[c * M + m];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int m = 0; m < M; ++m) {
      out[h][m] += __shfl_xor_sync(0xffffffffu, out[h][m], 1);
      out[h][m] += __shfl_xor_sync(0xffffffffu, out[h][m], 2);
    }
}

// The walk.  A unit is one 128-ray tile at one sample.  Ungated, the S x
// ray_tiles units in the backward's chain order (unit u: sample
// u / ray_tiles, ray tile u % ray_tiles); in points mode (dplane given, as
// in the chain launch: od the position plane [3, P], dplane the direction
// plane, n = P, s = 1, no gate) a unit is 128 consecutive points; gated,
// the 8 samples of every active (ray tile, 8-sample row) gate entry, in
// entry order, so gated rows are not in the walk at all.  Block b of G takes units [b U / G,
// (b + 1) U / G) of the U there are: the blocks' shares differ by one unit
// at most, however the gate falls.  Gated, every block first takes the
// prefix sum of the gate's active entries in a fixed order (each thread
// counts a contiguous run, as compact_tiles_kernel in fused_mlp_vjp.cu) and
// lists the entries its units span; the producer warpgroup's idle warps
// store the zeros of the gated-off entries e = b, b + G, ...
//
// Per unit, each consumer warpgroup loads its 64 rays' origin, direction
// and depth (points: position and direction), embeds x = o + d z (points:
// x), runs the trunk (h0 .. h7, the skip layer as two products into one
// accumulator) and, for the full field, the feature layer (no activation)
// and the view layer relu(embd @ wvd + feat @ wvf + bv) in one accumulator,
// where embd embeds d / |d| (points: d as given; the backward's recompute,
// in its order).  Bias, ReLU and the bf16 rounding are applied
// to the accumulator in registers; the density and colour heads come from
// the same registers (head_dots).  The unit's outputs are staged in shared
// memory and stored as 64-wide runs of a row of [S, N] ([4, P]: k = 0).
template <bool FULL, bool OUT_BF16>
__device__ __forceinline__ void rays_walk(const CUtensorMap* maps, const float* __restrict__ od,
                                          const float* __restrict__ z,
                                          const float* __restrict__ dplane,
                                          const bf16* __restrict__ w,
                                          const float* __restrict__ b, void* r_out,
                                          void* g_out, void* b_out, void* s_out, int n, int s,
                                          int L_x, int L_d, const int* __restrict__ gate) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* const act = hopper::align1024(smem_raw);
  unsigned char* const emb = act + FW_ACT;
  unsigned char* const ring = emb + FW_EMB;
  float* const rays = reinterpret_cast<float*>(ring + FW_RING);
  float* const zrow = rays + TILE * 8;
  float* const heads = zrow + TILE;
  float* const outs = heads + WIDTH + HALF * 3;   // rows r, g, b, sigma
  int* const scan = reinterpret_cast<int*>(outs + 4 * TILE);
  int* const list = scan + FW_THREADS;
  uint64_t* const full = reinterpret_cast<uint64_t*>(list + FW_LIST);
  uint64_t* const empty = full + CH_STAGES;
  const int tid = threadIdx.x;
  const int ray_tiles = (n + TILE - 1) / TILE, rows = s >> 3;

  if (tid == 0) {
    for (int i = 0; i < CH_STAGES; ++i) {
      hopper::mbar_init(&full[i], 1);
      hopper::mbar_init(&empty[i], 8);   // the 8 consumer warps
    }
    hopper::fence_barrier_init();
  }
  for (int i = tid; i < WIDTH; i += FW_THREADS) heads[i] = __bfloat162float(w[OFF_WDENS + i]);
  if (FULL)
    for (int i = tid; i < HALF * 3; i += FW_THREADS)
      heads[WIDTH + i] = __bfloat162float(w[OFF_WCOL + i]);

  long lo, hi;      // this block's units
  int e_lo = 0;     // gated: the active index of list[0]
  if (gate == nullptr) {
    const long units = (long)s * ray_tiles;
    lo = (long)blockIdx.x * units / gridDim.x;
    hi = (long)(blockIdx.x + 1) * units / gridDim.x;
  } else {
    const int entries = ray_tiles * rows;
    const int per = (entries + FW_THREADS - 1) / FW_THREADS;
    const int t0 = min(entries, tid * per), t1 = min(entries, t0 + per);
    int c = 0;
    for (int e = t0; e < t1; ++e) c += gate[e] != 0;
    scan[tid] = c;
    __syncthreads();
    for (int off = 1; off < FW_THREADS; off <<= 1) {  // inclusive prefix sum
      const int v = tid >= off ? scan[tid - off] : 0;
      __syncthreads();
      scan[tid] += v;
      __syncthreads();
    }
    const long units = 8L * scan[FW_THREADS - 1];
    lo = (long)blockIdx.x * units / gridDim.x;
    hi = (long)(blockIdx.x + 1) * units / gridDim.x;
    e_lo = (int)(lo >> 3);
    const int e_hi = (int)((hi + 7) >> 3);
    int at = scan[tid] - c;
    for (int e = t0; e < t1 && at < e_hi; ++e)
      if (gate[e] != 0) {
        if (at >= e_lo) list[at - e_lo] = e;
        ++at;
      }
  }
  __syncthreads();

  if (tid >= 256) {   // producer warpgroup
    hopper::setmaxnreg_dec<FW_PRODUCER_REGS>();
    if (tid == 256) {
      constexpr int nprods = FULL ? N_FWD_PRODS : N_TRUNK_PRODS;
      uint32_t it = 0;
      for (long v = lo; v < hi; ++v)
        for (int pi = 0; pi < nprods; ++pi) {
          const Prod pr = fwd_prod(pi);
          for (int c = 0; c * 64 < pr.k; ++c, ++it) {
            const int st = it % CH_STAGES;
            if (it >= CH_STAGES) hopper::mbar_wait(&empty[st], ((it / CH_STAGES) - 1) & 1);
            load_fwd_stage(ring + st * CH_STAGE, maps, pr, c, &full[st]);
          }
        }
    } else if (gate != nullptr && tid >= 288) {   // warps 9-11: the gated-off zeros
      const int entries = ray_tiles * rows;
      for (int e = blockIdx.x; e < entries; e += gridDim.x) {
        if (gate[e] != 0) continue;
        const int k0 = 8 * (e % rows), ray0 = (e / rows) * TILE;
        for (int idx = tid - 288; idx < 8 * TILE; idx += 96) {
          const int ray = ray0 + idx % TILE;
          if (ray >= n) continue;
          const long at = (long)(k0 + idx / TILE) * n + ray;
          store_out<OUT_BF16>(s_out, at, 0.0f);
          if (FULL) {
            store_out<OUT_BF16>(r_out, at, 0.0f);
            store_out<OUT_BF16>(g_out, at, 0.0f);
            store_out<OUT_BF16>(b_out, at, 0.0f);
          }
        }
      }
    }
    return;
  }

  hopper::setmaxnreg_inc<FW_CONSUMER_REGS>();
  const int wg = tid >> 7, row0 = 64 * wg, bar = 1 + wg, t = tid & 127;
  const unsigned char* const a_act = act + wg * 8192;   // its rows of each column block
  const unsigned char* const a_emb = emb + wg * 8192;
  const int r_lo = acc_row(row0, 0), r_hi = acc_row(row0, 2);   // this thread's rows
  uint32_t it = 0;
  float acc[128];
#pragma unroll 1
  for (long v = lo; v < hi; ++v) {
    int k, ray0;
    if (gate == nullptr) {
      k = (int)(v / ray_tiles);
      ray0 = (int)(v % ray_tiles) * TILE;
    } else {
      const int e = list[(int)(v >> 3) - e_lo];
      k = 8 * (e % rows) + (int)(v & 7);
      ray0 = (e / rows) * TILE;
    }
    hopper::named_barrier(bar, 128);  // the previous unit is done with our rows
    load_wg(rays, zrow, nullptr, od, z, dplane, nullptr, nullptr, nullptr, nullptr, n, k, ray0,
            row0);
    hopper::named_barrier(bar, 128);
    emb_wg(emb, rays, dplane ? nullptr : zrow, L_x, EMBX, 0, false, row0);
    hopper::fence_proxy_async();
    hopper::named_barrier(bar, 128);

    zero_acc(acc);   // h0
    chain_gemm<WIDTH, true>(acc, a_emb, EMBX, ring, full, empty, it);
    chain_epilogue<WIDTH>(acc, b + OFF_B0, true, act, row0, nullptr);
    hopper::fence_proxy_async();
    hopper::named_barrier(bar, 128);
#pragma unroll 1
    for (int i = 1; i <= 7; ++i) {
      zero_acc(acc);
      if (i == 5) chain_gemm<WIDTH, true>(acc, a_emb, EMBX, ring, full, empty, it);  // skip
      chain_gemm<WIDTH, true>(acc, a_act, WIDTH, ring, full, empty, it);
      if (!FULL && i == 7) break;        // h7 feeds the density head alone
      hopper::named_barrier(bar, 128);   // every warp is done reading h_{i-1}
      chain_epilogue<WIDTH>(acc, b + OFF_B0 + WIDTH * i, true, act, row0, nullptr);
      hopper::fence_proxy_async();
      hopper::named_barrier(bar, 128);
    }
    {  // density: round(relu(h7)) . wdens + bdens
      float d[2][1];
      head_dots<WIDTH, 1>(acc, b + OFF_B0 + WIDTH * 7, heads, d);
      if ((t & 3) == 0) {
        outs[3 * TILE + r_lo] = d[0][0] + b[OFF_BDENS];
        outs[3 * TILE + r_hi] = d[1][0] + b[OFF_BDENS];
      }
    }
    if (FULL) {
      // the skip layer is done with emb; points: d as given
      emb_wg(emb, rays, nullptr, L_d, EMBD, 3, dplane == nullptr, row0);
      hopper::fence_proxy_async();
      zero_acc(acc);   // feature layer (no activation), in place
      chain_gemm<WIDTH, true>(acc, a_act, WIDTH, ring, full, empty, it);
      hopper::named_barrier(bar, 128);
      chain_epilogue<WIDTH>(acc, b + OFF_BFEAT, false, act, row0, nullptr);
      hopper::fence_proxy_async();
      hopper::named_barrier(bar, 128);
      float acc2[64];  // view layer, then the colour head: round(relu(hv)) . wcol + bcol
      zero_acc(acc2);
      chain_gemm<HALF, true>(acc2, a_emb, EMBD, ring, full, empty, it);
      chain_gemm<HALF, true>(acc2, a_act, WIDTH, ring, full, empty, it);
      float c3[2][3];
      head_dots<HALF, 3>(acc2, b + OFF_BV, heads + WIDTH, c3);
      if ((t & 3) == 0) {
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          outs[m * TILE + r_lo] = c3[0][m] + b[OFF_BCOL + m];
          outs[m * TILE + r_hi] = c3[1][m] + b[OFF_BCOL + m];
        }
      }
    }
    hopper::named_barrier(bar, 128);  // the unit's outputs are staged
    for (int idx = t; idx < (FULL ? 4 : 1) * 64; idx += 128) {
      const int o = FULL ? idx >> 6 : 3, p = row0 + (idx & 63), ray = ray0 + p;
      if (ray < n)
        store_out<OUT_BF16>(o == 0 ? r_out : o == 1 ? g_out : o == 2 ? b_out : s_out,
                            (long)k * n + ray, outs[o * TILE + p]);
    }
  }
}

template <bool OUT_BF16>
__global__ void __launch_bounds__(FW_THREADS, 1)
eval_rays_wgmma_kernel(__grid_constant__ const FMaps maps, const float* __restrict__ od,
                       const float* __restrict__ z, const bf16* __restrict__ w,
                       const float* __restrict__ b, void* r_out, void* g_out, void* b_out,
                       void* s_out, int n, int s, int L_x, int L_d,
                       const int* __restrict__ gate) {
  rays_walk<true, OUT_BF16>(maps.m, od, z, nullptr, w, b, r_out, g_out, b_out, s_out, n, s, L_x,
                            L_d, gate);
}

template <bool OUT_BF16>
__global__ void __launch_bounds__(FW_THREADS, 1)
sigma_rays_wgmma_kernel(__grid_constant__ const FMaps maps, const float* __restrict__ od,
                        const float* __restrict__ z, const bf16* __restrict__ w,
                        const float* __restrict__ b, void* sigma, int n, int s, int L_x,
                        const int* __restrict__ gate) {
  rays_walk<false, OUT_BF16>(maps.m, od, z, nullptr, w, b, nullptr, nullptr, nullptr, sigma, n,
                             s, L_x, 1, gate);
}

// the full field at the planes x and d [3, P] (d as given) -> r, g, b, sigma
// rows of [4, P].  The assumption that d is given lets the compiler drop the
// ray mode's branches of the loads and the embedding (236 bytes of spills
// without it, none with it).
template <bool OUT_BF16>
__global__ void __launch_bounds__(FW_THREADS, 1)
eval_points_wgmma_kernel(__grid_constant__ const FMaps maps, const float* __restrict__ x,
                         const float* __restrict__ d, const bf16* __restrict__ w,
                         const float* __restrict__ b, void* r_out, void* g_out, void* b_out,
                         void* s_out, int p, int L_x, int L_d) {
  __builtin_assume(d != nullptr);
  rays_walk<true, OUT_BF16>(maps.m, x, nullptr, d, w, b, r_out, g_out, b_out, s_out, p, 1, L_x,
                            L_d, nullptr);
}

// trunk + density at the plane x [3, P] -> sigma [P]; x stands in for the
// direction plane the points mode loads (its rows are read and never used),
// and is assumed given, as d is in eval_points_wgmma_kernel
template <bool OUT_BF16>
__global__ void __launch_bounds__(FW_THREADS, 1)
sigma_points_wgmma_kernel(__grid_constant__ const FMaps maps, const float* __restrict__ x,
                          const bf16* __restrict__ w, const float* __restrict__ b, void* sigma,
                          int p, int L_x) {
  __builtin_assume(x != nullptr);
  rays_walk<false, OUT_BF16>(maps.m, x, nullptr, x, w, b, nullptr, nullptr, nullptr, sigma, p, 1,
                             L_x, 1, nullptr);
}

// blocks of a walk: one per SM, or one per unit where there are fewer
// units; gated, also at least enough that no block's share spans more gate
// entries than its list holds
int walk_blocks(int n, int s, bool gated) {
  const long tiles = (n + TILE - 1) / TILE, units = (long)s * tiles;
  long g = sm_count();
  if (g > units) g = units;
  if (gated) {
    const long entries = tiles * (s / 8), need = (entries + FW_LIST - 5) / (FW_LIST - 4);
    if (g < need) g = need;
  }
  return (int)g;
}

// one launch of a walk kernel at (n, s), after encoding the forward tensor
// maps over the packed weights w (the kernel's first argument)
template <typename Kernel, typename... Args>
int walk_launch(Kernel kernel, int n, int s, bool gated, const bf16* w, void* stream,
                Args... args) {
  FMaps maps;
  int rc;
  if ((rc = fwd_maps(maps.m, w))) return rc;
  if ((rc = launch_prep(kernel, SMEM_FWD))) return rc;
  kernel<<<walk_blocks(n, s, gated), FW_THREADS, SMEM_FWD,
           reinterpret_cast<cudaStream_t>(stream)>>>(maps, args...);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int nerf_sigma_points(const float* x, const void* w, const float* b, void* sigma,
                                 int p, int L_x, int out_bf16, void* stream) {
  const bf16* wb = reinterpret_cast<const bf16*>(w);
  return out_bf16 ? walk_launch(sigma_points_wgmma_kernel<true>, p, 1, false, wb, stream, x, wb,
                                b, sigma, p, L_x)
                  : walk_launch(sigma_points_wgmma_kernel<false>, p, 1, false, wb, stream, x, wb,
                                b, sigma, p, L_x);
}

extern "C" int nerf_eval_points(const float* x, const float* d, const void* w, const float* b,
                                void* out, int p, int L_x, int L_d, int out_bf16, void* stream) {
  const bf16* wb = reinterpret_cast<const bf16*>(w);
  // out [4, P]: rows r, g, b, sigma
  const long row = (long)p * (out_bf16 ? 2 : 4);
  char* o = reinterpret_cast<char*>(out);
  return out_bf16 ? walk_launch(eval_points_wgmma_kernel<true>, p, 1, false, wb, stream, x, d, wb,
                                b, o, o + row, o + 2 * row, o + 3 * row, p, L_x, L_d)
                  : walk_launch(eval_points_wgmma_kernel<false>, p, 1, false, wb, stream, x, d,
                                wb, b, o, o + row, o + 2 * row, o + 3 * row, p, L_x, L_d);
}

extern "C" int nerf_sigma_rays(const float* od, const float* z, const void* w, const float* b,
                               void* sigma, int n, int s, int L_x, int out_bf16,
                               const int* gate, void* stream) {
  if (gate != nullptr && s % 8 != 0) return (int)cudaErrorInvalidValue;
  const bf16* wb = reinterpret_cast<const bf16*>(w);
  const bool gated = gate != nullptr;
  return out_bf16 ? walk_launch(sigma_rays_wgmma_kernel<true>, n, s, gated, wb, stream, od, z, wb,
                                b, sigma, n, s, L_x, gate)
                  : walk_launch(sigma_rays_wgmma_kernel<false>, n, s, gated, wb, stream, od, z,
                                wb, b, sigma, n, s, L_x, gate);
}

extern "C" int nerf_eval_rays(const float* od, const float* z, const void* w, const float* b,
                              void* r, void* g, void* bl, void* sigma, int n, int s, int L_x,
                              int L_d, int out_bf16, const int* gate, void* stream) {
  if (gate != nullptr && s % 8 != 0) return (int)cudaErrorInvalidValue;
  const bf16* wb = reinterpret_cast<const bf16*>(w);
  const bool gated = gate != nullptr;
  return out_bf16 ? walk_launch(eval_rays_wgmma_kernel<true>, n, s, gated, wb, stream, od, z, wb,
                                b, r, g, bl, sigma, n, s, L_x, L_d, gate)
                  : walk_launch(eval_rays_wgmma_kernel<false>, n, s, gated, wb, stream, od, z, wb,
                                b, r, g, bl, sigma, n, s, L_x, L_d, gate);
}

// Host microseconds a ray launch spends encoding its tensor maps: the mean
// of reps encodings of the maps over the packed weights w (-1 on failure).
extern "C" double nerf_fwd_maps_us(const void* w, int reps) {
  FMaps maps;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < reps; ++i)
    if (fwd_maps(maps.m, reinterpret_cast<const bf16*>(w))) return -1.0;
  const std::chrono::duration<double, std::micro> dt = std::chrono::steady_clock::now() - t0;
  return dt.count() / (reps > 0 ? reps : 1);
}

// The ray kernels' launch at (n, s), gated or not, into out[5]: [0] blocks,
// [1] dynamic shared memory a block (bytes), [2] the weight ring's stages,
// [3] the units (128-ray tiles at one sample) of an ungated launch, [4]
// blocks an SM holds (-1 if the query failed).
extern "C" void nerf_rays_plan(int n, int s, int gated, long* out) {
  int per_sm = 0;
  if (launch_prep(eval_rays_wgmma_kernel<true>, SMEM_FWD) ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, eval_rays_wgmma_kernel<true>,
                                                    FW_THREADS, SMEM_FWD))
    per_sm = -1;
  out[0] = walk_blocks(n, s, gated != 0);
  out[1] = SMEM_FWD;
  out[2] = CH_STAGES;
  out[3] = (long)s * ((n + TILE - 1) / TILE);
  out[4] = per_sm;
}
