// Instant-NGP's multiresolution hash encoding (Mueller et al., SIGGRAPH
// 2022), forward and backward, for Hopper (sm_90a).
//
// Replaces no kernel of the JAX package: the JAX package runs NeRF's MLP
// only.  Added for the port's second architecture (models/ngp.py).
//
// Forward: for each point x in [0,1]^3 and level l of resolution N_l, the
// 8 corners floor(x N_l) + {0,1}^3 (floor clamped to N_l - 1, so that x = 1
// takes the upper corner with weight 1), each corner's index in the level's
// table (dense c_x + c_y (N_l+1) + c_z (N_l+1)^2 where the level holds
// (N_l+1)^3 entries, else (c_x ^ c_y 2654435761 ^ c_z 805459861) mod T in
// uint32) and the trilinear interpolation of the corners' 2 features.
// out [n, L, 2] float32.  Points at or past ``n_valid[0]`` (the marcher's
// count of kept samples; null: every point) get zero features.
//
// Backward: the same corners, each adding weight x feature gradient to its
// table entry by float32 atomics (red.global.add), into one flat gradient
// [sum of the levels' entries, 2]; at the coarse levels a warp first sums
// its runs of lanes that share an entry (``add_run``).  The order of the
// additions changes from run to run, so the table gradients are not
// bit-reproducible.
//
// What bounds it on an H100: 128 random 8-byte gathers a point (16 levels x
// 8 corners) from 48.8 MB of tables, about the size of the 50 MB L2, and in
// the backward as many atomics into the same footprint; the streamed bytes
// (positions in, 128 feature bytes out) are small beside them.  The design:
// one thread a (point, level), the level on blockIdx.y so that a block
// reads one table and its parameters are uniform; the level's corners are
// gathered as float2; nothing is staged in shared memory, since the
// gathers have no reuse a block could keep.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 16;
constexpr int kThreads = 256;

}  // namespace

// The levels, passed by value (the layout ctypes mirrors in hash_grid.py).
struct HashLevels {
  const float* table[kMaxLevels];  // [size_l, 2] each
  float* grad;                     // backward: flat [sum size_l, 2]
  int offset[kMaxLevels];          // each level's first entry in grad
  int res[kMaxLevels];             // N_l
  int size[kMaxLevels];            // entries: (N_l+1)^3 dense, else T
  int dense[kMaxLevels];           // 1: the dense index
  int n_levels;
};

namespace {

__device__ __forceinline__ uint32_t corner_index(uint32_t cx, uint32_t cy, uint32_t cz,
                                                 int res, int size, int dense) {
  if (dense) {
    const uint32_t s = (uint32_t)res + 1u;
    return cx + cy * s + cz * s * s;
  }
  return (cx ^ (cy * 2654435761u) ^ (cz * 805459861u)) & (uint32_t)(size - 1);
}

// The point's voxel at one level: lower corner and fractions.
__device__ __forceinline__ void voxel(const float* __restrict__ x, long i, int res,
                                      uint32_t c0[3], float fr[3]) {
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float p = fminf(fmaxf(x[3 * i + d], 0.0f), 1.0f);
    const float s = __fmul_rn(p, (float)res);
    int fl = (int)floorf(s);
    fl = min(fl, res - 1);
    fr[d] = __fsub_rn(s, (float)fl);
    c0[d] = (uint32_t)fl;
  }
}

__device__ __forceinline__ float corner_weight(int corner, const float fr[3]) {
  const float wx = (corner & 1) ? fr[0] : 1.0f - fr[0];
  const float wy = (corner & 2) ? fr[1] : 1.0f - fr[1];
  const float wz = (corner & 4) ? fr[2] : 1.0f - fr[2];
  return __fmul_rn(__fmul_rn(wx, wy), wz);
}

__global__ void __launch_bounds__(kThreads)
hash_encode_fwd_kernel(const float* __restrict__ x, int n, const int* __restrict__ n_valid,
                       HashLevels lv, float2* __restrict__ out) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const int l = blockIdx.y;
  if (i >= n) return;
  const int valid = n_valid ? *n_valid : n;
  float2 acc = make_float2(0.0f, 0.0f);
  if (i < valid) {
    const int res = lv.res[l], size = lv.size[l], dense = lv.dense[l];
    const float2* __restrict__ tab = reinterpret_cast<const float2*>(lv.table[l]);
    uint32_t c0[3];
    float fr[3];
    voxel(x, i, res, c0, fr);
#pragma unroll
    for (int corner = 0; corner < 8; ++corner) {
      const uint32_t idx = corner_index(c0[0] + (corner & 1), c0[1] + ((corner >> 1) & 1),
                                        c0[2] + ((corner >> 2) & 1), res, size, dense);
      const float w = corner_weight(corner, fr);
      const float2 v = __ldg(tab + idx);
      acc.x = fmaf(w, v.x, acc.x);
      acc.y = fmaf(w, v.y, acc.y);
    }
  }
  out[i * lv.n_levels + l] = acc;
}

// The backward at a coarse level: the lanes of a warp hold consecutive
// samples, mostly along one ray, so runs of neighbouring lanes share a
// corner's entry; each run's sum (a segmented scan over the warp) is added
// once, by its last lane.  A level this coarse or coarser (its cell at least
// about 4.5 sample steps of sqrt(3)/1024) aggregates; finer levels, whose
// lanes rarely share an entry, add every contribution.
constexpr int kAggregateRes = 128;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void add_run(float* __restrict__ grad, uint32_t idx, bool active,
                                        float vx, float vy, int lane) {
  const uint32_t up = __shfl_up_sync(kFull, idx, 1);
  const uint32_t down = __shfl_down_sync(kFull, idx, 1);
  int start = (lane == 0 || up != idx) ? lane : 0;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int s = __shfl_up_sync(kFull, start, off);
    if (lane >= off) start = max(start, s);
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float tx = __shfl_up_sync(kFull, vx, off);
    const float ty = __shfl_up_sync(kFull, vy, off);
    if (lane - off >= start) {
      vx += tx;
      vy += ty;
    }
  }
  if (active && (lane == 31 || down != idx)) {
    atomicAdd(grad + 2L * idx, vx);
    atomicAdd(grad + 2L * idx + 1, vy);
  }
}

__global__ void __launch_bounds__(kThreads)
hash_encode_bwd_kernel(const float* __restrict__ x, int n, const int* __restrict__ n_valid,
                       HashLevels lv, const float2* __restrict__ dout) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const int l = blockIdx.y;
  const int valid = n_valid ? *n_valid : n;
  float2 g = make_float2(0.0f, 0.0f);
  if (i < n && i < valid) g = dout[i * lv.n_levels + l];
  const bool active = g.x != 0.0f || g.y != 0.0f;
  const int res = lv.res[l], size = lv.size[l], dense = lv.dense[l];
  float* __restrict__ grad = lv.grad + 2L * lv.offset[l];
  uint32_t c0[3] = {0u, 0u, 0u};
  float fr[3] = {0.0f, 0.0f, 0.0f};
  if (active) voxel(x, i, res, c0, fr);
  if (res > kAggregateRes) {          // uniform over the block: one level
    if (!active) return;
#pragma unroll
    for (int corner = 0; corner < 8; ++corner) {
      const uint32_t idx = corner_index(c0[0] + (corner & 1), c0[1] + ((corner >> 1) & 1),
                                        c0[2] + ((corner >> 2) & 1), res, size, dense);
      const float w = corner_weight(corner, fr);
      atomicAdd(grad + 2L * idx, w * g.x);
      atomicAdd(grad + 2L * idx + 1, w * g.y);
    }
    return;
  }
  const int lane = threadIdx.x & 31;   // every lane of the warp takes part
#pragma unroll
  for (int corner = 0; corner < 8; ++corner) {
    const uint32_t idx =
        active ? corner_index(c0[0] + (corner & 1), c0[1] + ((corner >> 1) & 1),
                              c0[2] + ((corner >> 2) & 1), res, size, dense)
               : 0xffffffffu;
    const float w = active ? corner_weight(corner, fr) : 0.0f;
    add_run(grad, idx, active, w * g.x, w * g.y, lane);
  }
}

dim3 grid_of(int n, int levels) {
  return dim3((unsigned)((n + kThreads - 1) / kThreads), (unsigned)levels);
}

}  // namespace

extern "C" int ngp_hash_encode_fwd(const float* x, int n, const int* n_valid, HashLevels lv,
                                   float* out, void* stream) {
  if (lv.n_levels < 1 || lv.n_levels > kMaxLevels) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  hash_encode_fwd_kernel<<<grid_of(n, lv.n_levels), kThreads, 0, (cudaStream_t)stream>>>(
      x, n, n_valid, lv, reinterpret_cast<float2*>(out));
  return (int)cudaGetLastError();
}

extern "C" int ngp_hash_encode_bwd(const float* x, int n, const int* n_valid, HashLevels lv,
                                   const float* dout, void* stream) {
  if (lv.n_levels < 1 || lv.n_levels > kMaxLevels) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  hash_encode_bwd_kernel<<<grid_of(n, lv.n_levels), kThreads, 0, (cudaStream_t)stream>>>(
      x, n, n_valid, lv, reinterpret_cast<const float2*>(dout));
  return (int)cudaGetLastError();
}

extern "C" int ngp_hash_levels_bytes() { return (int)sizeof(HashLevels); }
