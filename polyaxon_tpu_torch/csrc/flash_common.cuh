// Shared pieces of the flash-attention and paged-decode kernels (flash_fwd.cu,
// flash_bwd.cu, paged_decode.cu): the causal walk bounds, the mask value,
// and the helpers that set a kernel's shared-memory limit and read what it
// holds on the card. The tiles, barriers and products are in hopper.cuh.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>
#include <cstdint>

namespace flash {

constexpr float kMaskValue = -1e30f;  // the TPU kernels' DEFAULT_MASK_VALUE
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;  // the bf16 kernels' softmax runs in base 2
constexpr float kLn2 = 0.6931471805599453f;

// Number of tiles of `tile` rows that cover `n` rows.
__host__ __device__ constexpr int tiles_of(int n, int tile) { return (n + tile - 1) / tile; }

// Set the kernel's dynamic shared-memory limit once per instantiation.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// What a kernel holds on the card, into out[5]: registers per thread at
// launch, shared memory per CTA (static + dynamic), CTAs per SM, threads per
// CTA, local (spilled) bytes per thread. Returns 0 or a cudaError_t code.
template <typename Kernel>
int resources(Kernel kernel, int threads, size_t dyn_smem, int* out) {
  cudaError_t e = allow_smem(kernel, dyn_smem);
  cudaFuncAttributes a;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, kernel);
  int ctas = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel, threads, dyn_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.sharedSizeBytes + dyn_smem);
  out[2] = ctas;
  out[3] = threads;
  out[4] = static_cast<int>(a.localSizeBytes);
  return 0;
}

// a / b rounded toward minus infinity (b > 0), as Python's //
__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// One past the last kv tile (of nk, block_k keys each) that a q tile of
// block_q rows starting at row q0 walks: every tile without the causal mask,
// else up to the last one its last row can see (the TPU kernels'
// _kv_clamp); `walk_cut` tiles fewer (0 in use, 1 to plant the fault of a
// walk that stops before the diagonal).
__device__ __forceinline__ int kv_tiles_end(int q0, int block_q, int block_k, int nk,
                                            int q_offset, int k_offset, int causal,
                                            int walk_cut) {
  int end = nk;
  if (causal) {
    const int num = q_offset + q0 + block_q - 1 - k_offset;
    end = num < 0 ? 0 : min(nk, num / block_k + 1);
  }
  return max(end - walk_cut, 0);
}

// The first q tile (of block_q rows) whose last row can see the key at k0
// (the TPU kernels' _q_clamp), `walk_cut` tiles later (0 in use, 1 to plant
// the fault of a walk that starts one q tile late).
__device__ __forceinline__ int q_tiles_begin(int k0, int block_q, int q_offset, int k_offset,
                                             int causal, int walk_cut) {
  return (causal ? max(floor_div(k_offset + k0 - q_offset, block_q), 0) : 0) + walk_cut;
}

}  // namespace flash
