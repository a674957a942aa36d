// Instant-NGP's ray marcher with an in-order sample budget, and the
// compositing of the marched samples, forward and backward, for Hopper
// (sm_90a).
//
// Replaces no kernel of the JAX package, whose NeRF samples a fixed count
// per ray; added for the port's second architecture (models/ngp.py).
//
// March.  A world ray (o, d) maps to the unit cube as o' = scale o +
// offset, d' = d / |d|; [t_in, t_out] is its chord of [0,1]^3 (t_in >= 0).
// Candidates t_k = t_in + (u + k) dt, k < max_steps, t_k < t_out; a
// candidate is kept where the occupancy grid's cell of x_k = o' + t_k d'
// is set.  Three launches:
//   count:   one warp a ray, 32 candidates at a time -> counts[r];
//   scan:    one block: offsets = exclusive prefix sum of the counts, in
//            ray order; ray r is kept iff offsets[r] + counts[r] <= budget
//            (so the kept rays are a prefix); stats = (kept rays, their
//            samples);
//   compact: one warp a kept ray writes its samples in order (ballot and
//            popc) at offsets[r]: positions [budget, 3], t [budget], ray
//            index [budget] and the ray's direction in the 16 real
//            spherical harmonics of degrees 0-3 [budget, 16] (the colour
//            MLP's input, tiny-cuda-nn's constants; written here, where
//            the ray's unit direction is at hand, so that no gather by
//            ray follows).  Slots past stats[1] are left as they are.
// The arithmetic is rounded op by op (__fmul_rn, __fadd_rn: no
// contraction), as the plain version's, so both keep the same candidates.
//
// Composite.  Ray r's samples j in [offsets[r], offsets[r] + counts[r]):
// e_j = exp(-sigma_j dt), w_j = T_j (1 - e_j), T_{j+1} = T_j e_j, C =
// sum w_j c_j + T_end bg; one thread a ray.  A dropped ray gives 0.
// Backward: dc_j = g w_j, dsigma_j = dt g . (T_{j+1} c_j - (C - P_j)),
// P_j = sum_{i <= j} w_i c_i; samples of no kept ray get 0.
//
// What bounds it on an H100: latency.  The count and compact launches
// read a 2 MB bitfield (L2-resident) once a candidate, up to 1024 a ray;
// a warp a ray keeps 32 lookups in flight.  The compositing streams 16
// bytes a sample in and out, serially within a ray.
#include <cuda_runtime.h>
#include <stdint.h>

struct MarchParams {
  float scale, offset, dt;
  int max_steps;
  int grid_res;
  int budget;
};

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kScanThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

struct Ray {
  float o[3], d[3], t_in, t_out;
};

__device__ __forceinline__ Ray make_ray(const float* __restrict__ rays_o,
                                        const float* __restrict__ rays_d, long r,
                                        const MarchParams& p) {
  Ray ray;
  const float dx = rays_d[3 * r], dy = rays_d[3 * r + 1], dz = rays_d[3 * r + 2];
  const float norm = sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                     __fmul_rn(dz, dz)));
  ray.d[0] = __fdiv_rn(dx, norm);
  ray.d[1] = __fdiv_rn(dy, norm);
  ray.d[2] = __fdiv_rn(dz, norm);
  float t_lo = 0.0f, t_hi = 3.0e38f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    ray.o[a] = __fadd_rn(__fmul_rn(p.scale, rays_o[3 * r + a]), p.offset);
    const float inv = __fdiv_rn(1.0f, ray.d[a]);
    const float t0 = __fmul_rn(__fsub_rn(0.0f, ray.o[a]), inv);
    const float t1 = __fmul_rn(__fsub_rn(1.0f, ray.o[a]), inv);
    t_lo = fmaxf(t_lo, fminf(t0, t1));
    t_hi = fminf(t_hi, fmaxf(t0, t1));
  }
  ray.t_in = t_lo;
  ray.t_out = t_hi;
  return ray;
}

// Candidate k of a ray: inside the chord? its position and occupancy.
__device__ __forceinline__ bool candidate(const Ray& ray, float u, int k, const MarchParams& p,
                                          const uint8_t* __restrict__ bits, float x[3],
                                          float* t, bool* occ) {
  *t = __fadd_rn(ray.t_in, __fmul_rn(__fadd_rn(u, (float)k), p.dt));
  const bool in = k < p.max_steps && *t < ray.t_out;
  *occ = false;
  if (in) {
    int cell[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      x[a] = __fadd_rn(ray.o[a], __fmul_rn(*t, ray.d[a]));
      const float c = fminf(fmaxf(x[a], 0.0f), 1.0f);
      cell[a] = min((int)floorf(__fmul_rn(c, (float)p.grid_res)), p.grid_res - 1);
    }
    const long g = p.grid_res;
    *occ = bits[cell[0] + g * (cell[1] + g * (long)cell[2])] != 0;
  }
  return in;
}

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
march_count_kernel(const float* __restrict__ rays_o, const float* __restrict__ rays_d,
                   const float* __restrict__ u, int R, const uint8_t* __restrict__ bits,
                   MarchParams p, int* __restrict__ counts) {
  const long r = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= R) return;
  const Ray ray = make_ray(rays_o, rays_d, r, p);
  const float ur = u[r];
  int c = 0;
  if (ray.t_out > ray.t_in) {
    for (int k0 = 0; k0 < p.max_steps; k0 += 32) {
      float x[3], t;
      bool occ;
      const bool in = candidate(ray, ur, k0 + lane, p, bits, x, &t, &occ);
      c += (in && occ) ? 1 : 0;
      if (!__any_sync(kFull, in)) break;   // t grows with k: the chord ended
    }
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) c += __shfl_xor_sync(kFull, c, s);
  if (lane == 0) counts[r] = c;
}

__global__ void __launch_bounds__(kScanThreads)
march_scan_kernel(const int* __restrict__ counts, int R, int budget, int* __restrict__ offsets,
                  int* __restrict__ stats) {
  __shared__ long sums[kScanThreads];
  __shared__ int kept_rays;
  __shared__ unsigned long long kept_samples;
  const int tid = threadIdx.x;
  const int per = (R + kScanThreads - 1) / kScanThreads;
  const int a = min(tid * per, R), b = min(a + per, R);
  long s = 0;
  for (int i = a; i < b; ++i) s += counts[i];
  sums[tid] = s;
  if (tid == 0) {
    kept_rays = 0;
    kept_samples = 0;
  }
  __syncthreads();
  for (int off = 1; off < kScanThreads; off <<= 1) {
    const long v = tid >= off ? sums[tid - off] : 0;
    __syncthreads();
    sums[tid] += v;
    __syncthreads();
  }
  long run = tid ? sums[tid - 1] : 0;
  int my_rays = 0;
  long my_samples = 0;
  for (int i = a; i < b; ++i) {
    const int c = counts[i];
    offsets[i] = (int)min(run, (long)0x7fffffff);
    if (run + c <= budget) {
      ++my_rays;
      my_samples += c;
    }
    run += c;
  }
  if (my_rays) {
    atomicAdd(&kept_rays, my_rays);
    atomicAdd(&kept_samples, (unsigned long long)my_samples);
  }
  __syncthreads();
  if (tid == 0) {
    stats[0] = kept_rays;
    stats[1] = (int)kept_samples;
  }
}

// The 16 real spherical harmonics of degrees 0-3 of a unit direction,
// rounded op by op as kernels/ngp_march.py's sh_encode.
__device__ __forceinline__ void sh16(const float d[3], float o[16]) {
  const float x = d[0], y = d[1], z = d[2];
  const float xx = __fmul_rn(x, x), yy = __fmul_rn(y, y), zz = __fmul_rn(z, z);
  const float c1 = 0.48860251190291987f, c4 = 1.0925484305920792f;
  const float c9 = 0.59004358992664352f, c11 = 0.45704579946446572f;
  o[0] = 0.28209479177387814f;
  o[1] = __fmul_rn(-c1, y);
  o[2] = __fmul_rn(c1, z);
  o[3] = __fmul_rn(-c1, x);
  o[4] = __fmul_rn(__fmul_rn(c4, x), y);
  o[5] = __fmul_rn(__fmul_rn(-c4, y), z);
  o[6] = __fsub_rn(__fmul_rn(0.94617469575755997f, zz), 0.31539156525251999f);
  o[7] = __fmul_rn(__fmul_rn(-c4, x), z);
  o[8] = __fmul_rn(0.54627421529603959f, __fsub_rn(xx, yy));
  o[9] = __fmul_rn(__fmul_rn(c9, y), __fadd_rn(__fmul_rn(-3.0f, xx), yy));
  o[10] = __fmul_rn(__fmul_rn(__fmul_rn(2.8906114426405538f, x), y), z);
  o[11] = __fmul_rn(__fmul_rn(c11, y), __fsub_rn(1.0f, __fmul_rn(5.0f, zz)));
  o[12] = __fmul_rn(__fmul_rn(0.3731763325901154f, z), __fsub_rn(__fmul_rn(5.0f, zz), 3.0f));
  o[13] = __fmul_rn(__fmul_rn(c11, x), __fsub_rn(1.0f, __fmul_rn(5.0f, zz)));
  o[14] = __fmul_rn(__fmul_rn(1.4453057213202769f, z), __fsub_rn(xx, yy));
  o[15] = __fmul_rn(__fmul_rn(c9, x), __fadd_rn(-xx, __fmul_rn(3.0f, yy)));
}

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
march_compact_kernel(const float* __restrict__ rays_o, const float* __restrict__ rays_d,
                     const float* __restrict__ u, int R, const uint8_t* __restrict__ bits,
                     MarchParams p, const int* __restrict__ counts,
                     const int* __restrict__ offsets, float* __restrict__ pos,
                     float* __restrict__ ts, int* __restrict__ ray_idx,
                     float4* __restrict__ sh) {
  const long r = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= R) return;
  const int cnt = counts[r];
  long base = offsets[r];
  if (cnt == 0 || base + cnt > p.budget) return;
  const Ray ray = make_ray(rays_o, rays_d, r, p);
  const float ur = u[r];
  float h[16];
  sh16(ray.d, h);
  for (int k0 = 0; k0 < p.max_steps; k0 += 32) {
    float x[3], t;
    bool occ;
    const bool in = candidate(ray, ur, k0 + lane, p, bits, x, &t, &occ);
    const unsigned mask = __ballot_sync(kFull, in && occ);
    if (in && occ) {
      const long j = base + __popc(mask & ((1u << lane) - 1u));
      pos[3 * j] = x[0];
      pos[3 * j + 1] = x[1];
      pos[3 * j + 2] = x[2];
      ts[j] = t;
      ray_idx[j] = (int)r;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        sh[4 * j + q] = make_float4(h[4 * q], h[4 * q + 1], h[4 * q + 2], h[4 * q + 3]);
    }
    base += __popc(mask);
    if (!__any_sync(kFull, in)) break;
  }
}

__global__ void composite_fwd_kernel(const float* __restrict__ sigma,
                                     const float* __restrict__ rgb,
                                     const float* __restrict__ ts,
                                     const int* __restrict__ counts,
                                     const int* __restrict__ offsets, int R, int budget,
                                     float dt, float bg, float* __restrict__ out,
                                     float* __restrict__ depth, float* __restrict__ acc) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const int cnt = counts[r];
  const long off = offsets[r];
  float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, T = 1.0f, dep = 0.0f;
  const bool kept = off + cnt <= budget;
  if (kept) {
    for (long j = off; j < off + cnt; ++j) {
      const float e = expf(-(sigma[j] * dt));
      const float w = T * (1.0f - e);
      c0 += w * rgb[3 * j];
      c1 += w * rgb[3 * j + 1];
      c2 += w * rgb[3 * j + 2];
      if (depth) dep += w * ts[j];
      T *= e;
    }
  }
  out[3 * r] = kept ? c0 + T * bg : 0.0f;
  out[3 * r + 1] = kept ? c1 + T * bg : 0.0f;
  out[3 * r + 2] = kept ? c2 + T * bg : 0.0f;
  if (depth) depth[r] = kept ? dep : 0.0f;
  if (acc) acc[r] = kept ? 1.0f - T : 0.0f;
}

__global__ void composite_bwd_kernel(const float* __restrict__ sigma,
                                     const float* __restrict__ rgb,
                                     const int* __restrict__ counts,
                                     const int* __restrict__ offsets, int R, int budget,
                                     float dt, const float* __restrict__ out,
                                     const float* __restrict__ g_out,
                                     float* __restrict__ g_sigma, float* __restrict__ g_rgb) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const int cnt = counts[r];
  const long off = offsets[r];
  if (off + cnt > budget) return;
  const float g0 = g_out[3 * r], g1 = g_out[3 * r + 1], g2 = g_out[3 * r + 2];
  const float C0 = out[3 * r], C1 = out[3 * r + 1], C2 = out[3 * r + 2];
  float T = 1.0f, P0 = 0.0f, P1 = 0.0f, P2 = 0.0f;
  for (long j = off; j < off + cnt; ++j) {
    const float e = expf(-(sigma[j] * dt));
    const float w = T * (1.0f - e);
    const float r0 = rgb[3 * j], r1 = rgb[3 * j + 1], r2 = rgb[3 * j + 2];
    P0 += w * r0;
    P1 += w * r1;
    P2 += w * r2;
    T *= e;
    g_rgb[3 * j] = g0 * w;
    g_rgb[3 * j + 1] = g1 * w;
    g_rgb[3 * j + 2] = g2 * w;
    g_sigma[j] = dt * (g0 * (T * r0 - (C0 - P0)) + g1 * (T * r1 - (C1 - P1)) +
                       g2 * (T * r2 - (C2 - P2)));
  }
}

unsigned warp_blocks(int R) {
  return (unsigned)(((long)R + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

}  // namespace

extern "C" int ngp_march(const float* rays_o, const float* rays_d, const float* u, int R,
                         const uint8_t* bits, MarchParams p, int* counts, int* offsets,
                         int* stats, float* pos, float* ts, int* ray_idx, float* sh,
                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (R <= 0) return (int)cudaErrorInvalidValue;
  march_count_kernel<<<warp_blocks(R), 32 * kWarpsPerBlock, 0, s>>>(rays_o, rays_d, u, R, bits,
                                                                   p, counts);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  march_scan_kernel<<<1, kScanThreads, 0, s>>>(counts, R, p.budget, offsets, stats);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  march_compact_kernel<<<warp_blocks(R), 32 * kWarpsPerBlock, 0, s>>>(
      rays_o, rays_d, u, R, bits, p, counts, offsets, pos, ts, ray_idx,
      reinterpret_cast<float4*>(sh));
  return (int)cudaGetLastError();
}

extern "C" int ngp_composite_fwd(const float* sigma, const float* rgb, const float* ts,
                                 const int* counts, const int* offsets, int R, int budget,
                                 float dt, float bg, float* out, float* depth, float* acc,
                                 void* stream) {
  if (R <= 0) return (int)cudaErrorInvalidValue;
  composite_fwd_kernel<<<(R + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      sigma, rgb, ts, counts, offsets, R, budget, dt, bg, out, depth, acc);
  return (int)cudaGetLastError();
}

extern "C" int ngp_composite_bwd(const float* sigma, const float* rgb, const int* counts,
                                 const int* offsets, int R, int budget, float dt,
                                 const float* out, const float* g_out, float* g_sigma,
                                 float* g_rgb, void* stream) {
  if (R <= 0) return (int)cudaErrorInvalidValue;
  composite_bwd_kernel<<<(R + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      sigma, rgb, counts, offsets, R, budget, dt, out, g_out, g_sigma, g_rgb);
  return (int)cudaGetLastError();
}

extern "C" int ngp_march_params_bytes() { return (int)sizeof(MarchParams); }
