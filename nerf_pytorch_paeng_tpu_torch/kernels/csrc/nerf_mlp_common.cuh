// Constants shared by the fused NeRF MLP kernels (fused_mlp.cu,
// fused_mlp_vjp.cu, through hopper_mlp.cuh): the MLP's widths, the
// embedding widths, the 128-point tile, the packed weight layout that every
// kernel reads, and two host helpers.  The device machinery (wgmma, TMA,
// mbarriers) is in hopper_mma.cuh, the products' code in hopper_mlp.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int WIDTH = 256;
constexpr int HALF = 128;
constexpr int EMBX = 64;
constexpr int EMBD = 32;
constexpr int TILE = 128;      // points per step (rays of one sample row)

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
