// Paged decode attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel polyaxon_tpu/ops/paged_attention.py::_decode_kernel
// (launched by _paged_flash). It computes the same function: for every
// (sequence b, KV head h), one query token per query head of the group
// (G heads share a KV head) attends over the sequence's first lengths[b]
// cached tokens, which live in a paged pool and are found through the
// sequence's block table. Scores, the running max m, the running sum l and
// the accumulator are f32; p is rounded to the value dtype before p.V, as
// the TPU kernel does; keys at or past the length are masked with -1e30 and
// then p = 0; a length of 0 gives zeros. Tables may alias blocks (prefix
// sharing): the kernel only reads the pool.
//
//   q       [B, KVH, G, D]       bf16 or f32
//   k, v    [N, bs, KVH, D]      same dtype as q (one layer of the pool)
//   tables  [B, T] int32         pool block ids
//   lengths [B] int32
//   out     [B, KVH, G, D]       q's dtype
//
// Design. The TPU walked the table on a sequential grid axis; here one CTA
// per (b, h) walks it, reading its own length and table entries, and only
// up to the last live token, so dead blocks are never loaded (what
// _pool_clamp achieves on the TPU). The CTA's kWarps warps split the walk:
// warp w takes the 32-token tiles w, w + kWarps, ... and keeps its own f32
// online softmax (m, l and the G x D accumulator in registers), so the
// walk needs no block-wide barrier. In a tile each lane owns one token: it
// looks up the token's pool row once, reads its K row in 16-byte vectors
// and computes its G scores against q in shared memory; the softmax update
// is a pair of warp reductions per query row; for p.V each lane owns D/32
// output dims and the tile's V rows are read (coalesced, a batch of tokens
// in flight at once) with the rows' pool offsets passed by shuffles. At the
// end the warps' partial results are merged through shared memory
// (45.6 KB at D = 128 in f32, under the 48 KB static limit; a whole
// 128-token pool block of K and V staged at once would need 64 KB in bf16,
// 128 KB in f32).
//
// Bound on the H100. The work is two small products per token (G rows by D)
// against one read of K and V, so it is memory-bound: the least time is the
// live K/V bytes (each distinct pool row read once) over 3.35 TB/s. This
// simple design does not reach it: one CTA per (b, h) gives the llama-1b
// decode batch (B = 8, KVH = 4) 32 CTAs for 132 SMs, and a long sequence
// is walked by the 8 warps of one CTA, a tile at a time each, so the
// longest sequence sets the time through the latency of its chain of
// tiles. What it does about the bound: the warps of a CTA walk
// concurrently, every load is independent of the scores (pool rows are
// looked up before the loads, the next tile's rows while this tile
// computes) and V is read in batches. Splitting a long sequence over
// several CTAs (split-K with a merge pass) and cp.async/TMA double
// buffering are the later steps toward the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;  // tokens per warp iteration: one per lane
constexpr int kMaxG = 8;   // query heads per KV head
constexpr float kMaskValue = -1e30f;  // the TPU kernel's DEFAULT_MASK_VALUE
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Conv;

template <>
struct Conv<float> {
  static __device__ __forceinline__ float to_f32(float x) { return x; }
  static __device__ __forceinline__ float from_f32(float x) { return x; }
};

template <>
struct Conv<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
  // round to nearest even, as XLA's astype(bfloat16)
  static __device__ __forceinline__ __nv_bfloat16 from_f32(float x) {
    return __float2bfloat16_rn(x);
  }
};

// N consecutive elements read as one vector load (N * sizeof(T) <= 16)
template <typename T, int N>
struct alignas(sizeof(T) * N) Chunk {
  T v[N];
};

template <typename T, int N>
__device__ __forceinline__ Chunk<T, N> load_chunk(const T* p) {
  return *reinterpret_cast<const Chunk<T, N>*>(p);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool, const int* __restrict__ tables,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int kv_heads, int groups, int num_blocks, int block_size,
                    int max_blocks, float sm_scale) {
  constexpr int kVec = 16 / sizeof(T);     // K elements per 16-byte load
  constexpr int kDims = D / 32;            // output dims per lane
  // V rows in flight per batch: 32 at D = 64; 16 at D = 128, where a lane's
  // slice of a row is twice as wide (32 rows there spill registers)
  constexpr int kVBatch = D <= 64 ? 32 : 16;
  static_assert(D % 32 == 0 && D % kVec == 0, "head_dim must be a multiple of 32");

  __shared__ float q_s[kMaxG][D];
  __shared__ float p_s[kWarps][kMaxG][kTile];
  __shared__ float acc_s[kWarps][kMaxG][D];
  __shared__ float m_s[kWarps][kMaxG];
  __shared__ float l_s[kWarps][kMaxG];

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gd = groups * D;

  // a table holds max_blocks * block_size slots: longer lengths attend over
  // those only, as the TPU kernel's clamped walk does
  const int len = max(0, min(lengths[b], max_blocks * block_size));
  const int* table = tables + static_cast<size_t>(b) * max_blocks;
  const size_t q_off = (static_cast<size_t>(b) * kv_heads + h) * gd;
  const size_t head_off = static_cast<size_t>(h) * D;
  const size_t row_stride = static_cast<size_t>(kv_heads) * D;

  // pool row (block * bs + slot) of token `tok`, or 0 past the length
  auto pool_row = [&](int tok) -> int {
    if (tok >= len) return 0;
    int blk = table[tok / block_size];
    blk = min(max(blk, 0), num_blocks - 1);
    return blk * block_size + tok % block_size;
  };

  for (int i = tid; i < gd; i += kThreads) q_s[i / D][i % D] = Conv<T>::to_f32(q[q_off + i]);

  float acc[kMaxG][kDims];
  float m_row[kMaxG];
  float l_row[kMaxG];
#pragma unroll
  for (int r = 0; r < kMaxG; ++r) {
    m_row[r] = -CUDART_INF_F;
    l_row[r] = 0.f;
#pragma unroll
    for (int j = 0; j < kDims; ++j) acc[r][j] = 0.f;
  }
  __syncthreads();

  const int stride = kWarps * kTile;
  int start = warp * kTile;
  int row = pool_row(start + lane);
  for (; start < len; start += stride) {
    const int tok = start + lane;
    const bool live = tok < len;
    const int n_live = min(kTile, len - start);
    const int next_row = pool_row(start + stride + lane);  // used next tile

    // scores of this lane's token against the G query rows
    float s[kMaxG];
#pragma unroll
    for (int r = 0; r < kMaxG; ++r) s[r] = 0.f;
    if (live) {
      const T* krow = k_pool + static_cast<size_t>(row) * row_stride + head_off;
#pragma unroll
      for (int c = 0; c < D; c += kVec) {
        const Chunk<T, kVec> kc = load_chunk<T, kVec>(krow + c);
#pragma unroll
        for (int r = 0; r < kMaxG; ++r) {
          if (r < groups) {
#pragma unroll
            for (int e = 0; e < kVec; ++e) s[r] += q_s[r][c + e] * Conv<T>::to_f32(kc.v[e]);
          }
        }
      }
    }

    // online softmax, one query row at a time; every tile holds at least
    // one live token, so m_new is a real score
#pragma unroll
    for (int r = 0; r < kMaxG; ++r) {
      if (r < groups) {
        const float sr = live ? s[r] * sm_scale : kMaskValue;
        const float m_new = fmaxf(m_row[r], warp_max(sr));
        const float alpha = expf(m_row[r] - m_new);  // 0 on the first tile
        const float p = live ? expf(sr - m_new) : 0.f;
        l_row[r] = alpha * l_row[r] + warp_sum(p);
        m_row[r] = m_new;
        p_s[warp][r][lane] = Conv<T>::to_f32(Conv<T>::from_f32(p));  // p in V's dtype
#pragma unroll
        for (int j = 0; j < kDims; ++j) acc[r][j] *= alpha;
      }
    }
    __syncwarp();

    // acc[r][lane's dims] += sum over the tile's live tokens of p[r][t] v[t]
#pragma unroll
    for (int t0 = 0; t0 < kTile; t0 += kVBatch) {
      Chunk<T, kDims> vc[kVBatch];
#pragma unroll
      for (int i = 0; i < kVBatch; ++i) {
        const int row_t = __shfl_sync(kFull, row, t0 + i);
        if (t0 + i < n_live)
          vc[i] = load_chunk<T, kDims>(v_pool + static_cast<size_t>(row_t) * row_stride +
                                       head_off + lane * kDims);
      }
#pragma unroll
      for (int i = 0; i < kVBatch; ++i) {
        if (t0 + i < n_live) {
#pragma unroll
          for (int r = 0; r < kMaxG; ++r) {
            if (r < groups) {
              const float p = p_s[warp][r][t0 + i];
#pragma unroll
              for (int j = 0; j < kDims; ++j) acc[r][j] += p * Conv<T>::to_f32(vc[i].v[j]);
            }
          }
        }
      }
    }
    __syncwarp();  // the next tile overwrites this warp's p_s
    row = next_row;
  }

  // merge the warps' partial softmaxes (a warp that walked no tile holds
  // m = -inf, l = 0, acc = 0 and weighs nothing)
#pragma unroll
  for (int r = 0; r < kMaxG; ++r) {
    if (r < groups) {
      if (lane == 0) {
        m_s[warp][r] = m_row[r];
        l_s[warp][r] = l_row[r];
      }
#pragma unroll
      for (int j = 0; j < kDims; ++j) acc_s[warp][r][lane * kDims + j] = acc[r][j];
    }
  }
  __syncthreads();
  for (int o = tid; o < gd; o += kThreads) {
    const int r = o / D;
    const int d = o % D;
    float m = -CUDART_INF_F;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, m_s[w][r]);
    float l = 0.f, a = 0.f;
    if (m != -CUDART_INF_F) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float f = expf(m_s[w][r] - m);
        l += f * l_s[w][r];
        a += f * acc_s[w][r][d];
      }
    }
    out[q_off + o] = Conv<T>::from_f32(l == 0.f ? 0.f : a / l);
  }
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, const int* tables, const int* lengths,
            void* out, int batch, int kv_heads, int groups, int num_blocks, int block_size,
            int max_blocks, float sm_scale, cudaStream_t stream) {
  const dim3 grid(batch, kv_heads);
  paged_decode_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), tables,
      lengths, static_cast<T*>(out), kv_heads, groups, num_blocks, block_size, max_blocks,
      sm_scale);
}

template <typename T>
int dispatch_head_dim(const void* q, const void* k, const void* v, const int* tables,
                      const int* lengths, void* out, int batch, int kv_heads, int groups,
                      int head_dim, int num_blocks, int block_size, int max_blocks,
                      float sm_scale, cudaStream_t stream) {
  switch (head_dim) {
    case 64:
      launch<T, 64>(q, k, v, tables, lengths, out, batch, kv_heads, groups, num_blocks,
                    block_size, max_blocks, sm_scale, stream);
      return 0;
    case 128:
      launch<T, 128>(q, k, v, tables, lengths, out, batch, kv_heads, groups, num_blocks,
                     block_size, max_blocks, sm_scale, stream);
      return 0;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 on success), or cudaErrorInvalidValue for a shape or dtype the
// kernel does not take. Launches on `stream`, does not synchronise.
int paged_decode(const void* q, const void* k_pool, const void* v_pool, const void* tables,
                 const void* lengths, void* out, int batch, int kv_heads, int groups,
                 int head_dim, int num_blocks, int block_size, int max_blocks, float sm_scale,
                 int dtype, void* stream) {
  if (batch <= 0 || kv_heads <= 0 || groups <= 0 || groups > kMaxG || num_blocks <= 0 ||
      block_size <= 0 || max_blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // start from a clean error state
  const int* tbl = static_cast<const int*>(tables);
  const int* len = static_cast<const int*>(lengths);
  auto s = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == 0)
    rc = dispatch_head_dim<float>(q, k_pool, v_pool, tbl, len, out, batch, kv_heads, groups,
                                  head_dim, num_blocks, block_size, max_blocks, sm_scale, s);
  else if (dtype == 1)
    rc = dispatch_head_dim<__nv_bfloat16>(q, k_pool, v_pool, tbl, len, out, batch, kv_heads,
                                          groups, head_dim, num_blocks, block_size, max_blocks,
                                          sm_scale, s);
  else
    rc = static_cast<int>(cudaErrorInvalidValue);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

const char* paged_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
