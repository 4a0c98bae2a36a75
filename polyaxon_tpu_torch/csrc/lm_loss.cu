// The LM head's cross entropy over a chunk of logit rows, with the gradient
// formed in the same launch, for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces no TPU kernel: the JAX package's loss
// (polyaxon_tpu/models/transformer.py::lm_loss_from_hidden) is plain jnp,
// which XLA fuses on the TPU. Eager PyTorch ran the same reduction as about a
// dozen f32 passes over the logits (the upcast, logsumexp, the gather, and in
// the backward the exp, the scatter, the add and the cast back) and ran each
// chunk twice (a recompute in the backward). ops/lm_loss.py projects a chunk
// to its logits with torch.matmul, launches this kernel once on them, and
// forms dx and dW from the gradient it leaves in their place.
//
// For each row r of logits [rows, vp] (bf16 or f32; vp a multiple of 128,
// the first `vocab` columns real, the rest pad that is never read):
//   loss[r] = w_r (log sum_{j < vocab} exp z_rj - z_r,label_r),
//   w_r = mask[r] (1 without a mask); and with `grad` the row is overwritten
//   in place by (softmax_j - [j == label_r]) w_r scale for j < vocab, 0 in
//   the pad, where scale = *scale_ptr (1 / the batch's token count: it stays
//   on the device, so the host never waits for it).
// A row with w_r = 0 is not read: its loss is 0 and, with `grad`, its row
// zeros. A label outside [0, vocab) gives a NaN loss, which the trainer's
// finite check sees.
//
// Bound on the H100: bytes. Each row is read once and, with `grad`, written
// once, rows x vp x (2 + 2) B in bf16: 824 MB for a 4,096-row chunk of
// GPT-2's 50,304 columns, 0.246 ms at 3.35 TB/s (BERT's 30,592: 0.150 ms).
// About ten flops an element are far below the card's rate.
//
// Design: one CTA of 512 threads a row. Pass 1 reads the row in 16-byte
// vectors, four in flight a thread, and keeps an online max and sum of
// exponentials per thread in f32 (base 2), merged across the CTA by
// shuffles and one round through shared memory. With `grad` each vector also
// goes into shared memory as it arrives (the row's vp x 2 B: 100.6 KB at
// 50,304 columns, 61.2 KB at 30,592; at 56 registers a thread two CTAs an
// SM at either width), so pass 2 reads the row from shared memory, not
// from the device: the device sees one read and one write of the row, the
// bound's bytes. A thread takes the same vectors in both passes, so the
// cache needs no barrier of its own. A row too wide for shared memory (bf16
// past ~115,000 columns, f32 past ~57,000) is read again from the device in
// pass 2, where L2 holds part of it. The gradient is rounded to the logits'
// dtype to nearest, as the cast of the f32 gradient it replaces was.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "flash_common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;         // 16-byte loads in flight a thread
constexpr int kVocabAlign = 128;   // vp is a multiple of this many columns
// The dynamic shared memory a CTA may take for the row (the opt-in limit
// less room for the static reduction scratch).
constexpr size_t kMaxRowBytes = 232448 - 1024;

struct Args {
  void* logits;
  const int64_t* labels;
  const float* mask;   // nullptr: every row counts with weight 1
  const float* scale;  // one f32 on the device
  float* loss;
  int vocab, vp, grad, cached;
};

// 16 bytes of logits as floats, and back.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static void unpack(const uint4& v, float (&x)[kN]) {
    x[0] = __uint_as_float(v.x);
    x[1] = __uint_as_float(v.y);
    x[2] = __uint_as_float(v.z);
    x[3] = __uint_as_float(v.w);
  }
  __device__ static uint4 pack(const float (&x)[kN]) {
    return make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]), __float_as_uint(x[2]),
                      __float_as_uint(x[3]));
  }
  __device__ static float at(const void* row, int col) {
    return static_cast<const float*>(row)[col];
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void unpack(const uint4& v, float (&x)[kN]) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static uint4 pack(const float (&x)[kN]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(x[2 * i]))) |
             (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(x[2 * i + 1])))
              << 16);
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
  __device__ static float at(const void* row, int col) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(row)[col]);
  }
};

// Merge the running (max, sum of 2^((z - max) log2 e)) pair (m2, s2) into
// (m, s). An empty pair has m = -inf and s = 0.
__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  const float mn = fmaxf(m, m2);
  if (mn == -INFINITY) return;
  s = s * exp2f((m - mn) * flash::kLog2e) + s2 * exp2f((m2 - mn) * flash::kLog2e);
  m = mn;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) lm_loss_rows_kernel(const Args a) {
  using V = Vec<T>;
  constexpr int kN = V::kN;
  extern __shared__ uint4 cache[];
  __shared__ float warp_m[kWarps], warp_s[kWarps], gold;

  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int nvec = a.vp / kN;                  // vectors of the row, pad included
  const int nreal = (a.vocab + kN - 1) / kN;   // those that hold a real column
  T* row = static_cast<T*>(a.logits) + static_cast<int64_t>(r) * a.vp;
  uint4* vrow = reinterpret_cast<uint4*>(row);

  const float w = a.mask ? a.mask[r] : 1.f;
  if (w == 0.f) {
    if (tid == 0) a.loss[r] = 0.f;
    if (a.grad)
      for (int v = tid; v < nvec; v += kThreads) vrow[v] = make_uint4(0u, 0u, 0u, 0u);
    return;
  }
  const int64_t label = a.labels[r];
  if (tid == 0)
    gold = (label >= 0 && label < a.vocab) ? V::at(row, static_cast<int>(label)) : NAN;

  // pass 1: the row's max and sum of exponentials
  float m = -INFINITY, s = 0.f;
  for (int base = tid; base < nreal; base += kThreads * kUnroll) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int v = base + u * kThreads;
      if (v < nreal) raw[u] = vrow[v];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int v = base + u * kThreads;
      if (v >= nreal) break;
      if (a.cached) cache[v] = raw[u];
      float x[kN];
      V::unpack(raw[u], x);
      float vm = -INFINITY;
#pragma unroll
      for (int i = 0; i < kN; ++i)
        if (v * kN + i < a.vocab) vm = fmaxf(vm, x[i]);
      const float mn = fmaxf(m, vm);
      if (mn == -INFINITY) continue;
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kN; ++i)
        if (v * kN + i < a.vocab) sum += exp2f((x[i] - mn) * flash::kLog2e);
      s = s * exp2f((m - mn) * flash::kLog2e) + sum;
      m = mn;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(flash::kFull, m, off);
    const float s2 = __shfl_xor_sync(flash::kFull, s, off);
    merge(m, s, m2, s2);
  }
  if ((tid & 31) == 0) {
    warp_m[tid >> 5] = m;
    warp_s[tid >> 5] = s;
  }
  __syncthreads();
  // every thread merges the warps' pairs in the same order: one barrier
  m = warp_m[0];
  s = warp_s[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) merge(m, s, warp_m[i], warp_s[i]);
  if (tid == 0) a.loss[r] = w * (m + logf(s) - gold);
  if (!a.grad) return;

  // pass 2: the gradient in place, zeros in the pad
  const float coef = w * *a.scale;
  const float inv = coef / s;
  for (int base = tid; base < nvec; base += kThreads * kUnroll) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int v = base + u * kThreads;
      if (v < nreal) raw[u] = a.cached ? cache[v] : vrow[v];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int v = base + u * kThreads;
      if (v >= nvec) break;
      float x[kN];
      if (v < nreal) V::unpack(raw[u], x);
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        const int col = v * kN + i;
        float g = col < a.vocab ? exp2f((x[i] - m) * flash::kLog2e) * inv : 0.f;
        if (col == label) g -= coef;
        x[i] = g;
      }
      vrow[v] = V::pack(x);
    }
  }
}

template <typename T>
int launch(const Args& a, int rows, cudaStream_t stream) {
  const size_t smem = a.cached ? static_cast<size_t>(a.vp) * sizeof(T) : 0;
  // the same limit for every width, so concurrent launches cannot race on it
  cudaError_t e = flash::allow_smem(lm_loss_rows_kernel<T>, kMaxRowBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  lm_loss_rows_kernel<T><<<rows, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

bool row_fits(int vp, int dtype) {
  return static_cast<size_t>(vp) * (dtype == 1 ? 2 : 4) <= kMaxRowBytes;
}

}  // namespace

extern "C" {

// logits [rows, vp] (dtype 0 = float32, 1 = bfloat16), contiguous, 16-byte
// aligned, vp a multiple of 128 and vocab <= vp; labels [rows] int64; mask
// [rows] f32 or null; scale one f32; loss [rows] f32 out. With `grad` the
// logits are overwritten by the gradient. Returns cudaGetLastError() after
// the launch (0 on success), or cudaErrorInvalidValue for a shape or dtype
// the kernel does not take. Launches on `stream`, does not synchronise.
int lm_loss_rows(void* logits, const void* labels, const void* mask, const void* scale,
                 void* loss, int rows, int vocab, int vp, int grad, int dtype, void* stream) {
  if (rows <= 0 || vocab <= 0 || vp < vocab || vp % kVocabAlign || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // start from a clean error state
  const int cached = grad && row_fits(vp, dtype);
  const Args a{logits, static_cast<const int64_t*>(labels), static_cast<const float*>(mask),
               static_cast<const float*>(scale), static_cast<float*>(loss), vocab, vp,
               grad ? 1 : 0, cached};
  const auto st = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch<__nv_bfloat16>(a, rows, st) : launch<float>(a, rows, st);
}

// What the kernel holds on the card for rows of vp columns with the
// gradient, into out[5]: registers per thread, shared memory per CTA, CTAs
// per SM, threads per CTA, spilled bytes per thread. Returns 0 or a CUDA
// error.
int lm_loss_resources(int vp, int dtype, int* out) {
  if (vp <= 0 || vp % kVocabAlign || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = row_fits(vp, dtype) ? static_cast<size_t>(vp) * (dtype == 1 ? 2 : 4) : 0;
  return dtype == 1 ? flash::resources(lm_loss_rows_kernel<__nv_bfloat16>, kThreads, smem, out)
                    : flash::resources(lm_loss_rows_kernel<float>, kThreads, smem, out);
}

const char* lm_loss_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
