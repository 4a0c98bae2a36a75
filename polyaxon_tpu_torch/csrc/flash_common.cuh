// Shared pieces of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// the causal walk bounds, and for the f32 dQ kernel, which stages tiles by
// hand (the others are built from hopper.cuh), its tile size, a tile copy
// from device memory to shared memory, and its one matrix-product primitive.
//
// Every product in the f32 dQ kernel has one shape: a warp owns 16 rows and
// computes C[16 x N] (+)= A[16 x K] * B', all three in shared memory, where
// B' is B ([K x N], row-major) or B transposed (B stored [N x K], row-major),
// as a plain loop on the CUDA cores, so it stays f32 throughout.
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

// the f32 dQ kernel's tiles: 32 rows, 2 warps per CTA
constexpr int kTileF32 = 32;

// leading dimension (elements) of a tile of D-wide rows in shared memory:
// padded by 8 so that rows start on other banks
template <int D>
__host__ __device__ constexpr int ld_of() {
  return D + 8;
}
// leading dimension of an f32 scratch of N-wide rows
template <int N>
__host__ __device__ constexpr int ldf_of() {
  return N + 4;
}

// byte size rounded up to 128 (each buffer carved from dynamic shared memory
// starts 128-byte aligned)
__host__ __device__ constexpr size_t pad128(size_t bytes) { return (bytes + 127) / 128 * 128; }

// Copy `rows` contiguous rows of D floats (a tile of a contiguous [S, D]
// array) into shared memory with leading dimension ld_of<D>(), 16 bytes a
// thread at a time, by all `nthreads` threads of the CTA. Rows from `valid`
// on lie past the end of the sequence (the last tile of a length that is no
// multiple of the tile) and are filled with zeros.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int rows,
                                          int valid, int tid, int nthreads) {
  constexpr int kVec = 4;
  constexpr int kPerRow = D / kVec;
  const int n = rows * kPerRow;
  for (int i = tid; i < n; i += nthreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) val = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * ld_of<D>() + c) = val;
  }
}

// Number of tiles of `tile` rows that cover `n` rows.
__host__ __device__ constexpr int tiles_of(int n, int tile) { return (n + tile - 1) / tile; }

// C[16 x N] (+)= A[16 x K] * B' for one warp. kBT: B is stored [N x K] and
// used transposed; otherwise B is [K x N]. All row-major in shared memory.
template <bool kBT, int N, int K>
__device__ __forceinline__ void warp_mma(float* C, int ldc, const float* A, int lda,
                                         const float* B, int ldb, bool accumulate) {
  const int lane = threadIdx.x & 31;
  for (int e = lane; e < 16 * N; e += 32) {
    const int r = e / N;
    const int n = e % N;
    float acc = accumulate ? C[r * ldc + n] : 0.f;
#pragma unroll 8
    for (int k = 0; k < K; ++k)
      acc = fmaf(A[r * lda + k], kBT ? B[n * ldb + k] : B[k * ldb + n], acc);
    C[r * ldc + n] = acc;
  }
}

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
