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
// then p = 0; a length of 0 gives zeros; a length past the table's
// capacity attends over the capacity. Tables may alias blocks (prefix
// sharing): the kernels only read the pool.
//
//   q       [B, KVH, G, D]       bf16 or f32
//   k, v    [N, bs, KVH, D]      same dtype as q (one layer of the pool)
//   tables  [B, T] int32         pool block ids
//   lengths [B] int32
//   out     [B, KVH, G, D]       q's dtype
//
// Bound on the H100. The work is two small products per token (G rows by D)
// against one read of K and V, so it is memory-bound: the least time is the
// live K/V bytes (each distinct pool row read once) over 3.35 TB/s, about a
// microsecond at the llama-1b decode batch, so the latency of one walk, not
// the bandwidth, is what a kernel has to beat.
//
// bf16 (paged_decode_split_kernel, then paged_decode_combine_kernel): the
// walk is split over the sequence (flash-decoding). The TPU walked the table
// on a sequential grid axis; here the grid is (splits, KVH, B) and CTA s of
// (b, h) takes tokens 256 s .. 256 s + 255, so the llama-1b decode batch
// (B 8, KVH 4, lengths up to 2048) runs 76 live CTAs at once instead of
// walking each row in one CTA; the host sizes `splits` from the table's
// capacity, and a CTA whose run starts at or past its length returns at
// once (dead blocks are never loaded, as _pool_clamp achieves on the TPU).
// A CTA looks up each token's pool row and stages its 256 K rows, then its
// V rows, into shared memory with cp.async (16 bytes a lane, rows past the
// length zero-filled, rows padded by 16 bytes so that ldmatrix reads them
// without bank conflicts), as two groups, so S is computed while V lands.
// Each of its 8 warps takes 32 tokens on the tensor cores (mma.sync
// m16n8k16, the G query rows padded to 16): S = Q K^T with K through
// ldmatrix, the softmax of its 32 scores in registers (row max and sum over
// the quad that holds a row), then P V with S's accumulator fragments, p
// rounded to bf16, as the A operand (the FlashAttention-2 register reuse)
// and V through ldmatrix.trans. The warps' partial results (m, l and the
// G x D accumulator, f32) are merged through shared memory into the split's
// partial, written to a workspace the wrapper allocates; the combine kernel,
// one CTA per (b, h), merges the partials of the live splits into the
// output. Shared memory: 90.6 KB at D = 64, 172.5 KB at D = 128.
//
// f32 (paged_decode_kernel): one CTA per (b, h) walks the whole table. Its
// 8 warps split the walk: warp w takes the 32-token tiles w, w + 8, ... and
// keeps its own online softmax (m, l and the G x D accumulator in
// registers); in a tile each lane owns one token and computes its G scores
// on the CUDA cores (tensor cores would round to tf32) against q in shared
// memory, and for p.V each lane owns D/32 output dims (at D = 16 the first
// 16 lanes own one each), the tile's V rows read in batches with their pool
// offsets passed by shuffles; the warps' partial results are merged through
// shared memory (45.6 KB at D = 128, under the 48 KB static limit). f32 is
// llama-tiny's dtype (D = 16), which serve_bench's speculative fixture
// decodes on the card; the f32 kernel takes D = 16, 32, 64 and 128, the
// bf16 walk 64 and 128.

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;
using bf16 = __nv_bfloat16;

constexpr int kMaxG = 8;  // query heads per KV head

// ---- bf16: the walk split over CTAs, tensor cores -------------------------------

// tokens per split: on the card 256 ran 1.7-2x faster than 128 and 128
// 2x faster than 64 (fewer partials to write and merge)
constexpr int kChunk = 256;
constexpr int kSplitWarps = kChunk / 32;  // 32 tokens each
constexpr int kSplitThreads = kSplitWarps * 32;

template <int D>
struct SplitSmem {
  static constexpr int kLd = D + 8;  // elements per staged row: 16 bytes of padding
  static constexpr size_t kv = sizeof(bf16) * kChunk * kLd;                // one of K, V
  static constexpr size_t acc = sizeof(float) * kSplitWarps * kMaxG * D;   // warps' acc
  static constexpr size_t ml = sizeof(float) * 2 * kSplitWarps * kMaxG;    // warps' m, l
  static constexpr size_t total = 2 * kv + acc + ml;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  // bytes < 16 zero-fill the rest (0: no read at all)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(hopper::smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 bf16 matrices; lanes 8i .. 8i + 7 give the row addresses of
// matrix i, and each lane gets (row lane / 4, columns 2 (lane % 4), + 1) of
// each, or with .trans (rows 2 (lane % 4), + 1, column lane / 4)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(hopper::smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(hopper::smem_addr(p)));
}

// C[16 x 8] += A[16 x 16] B[16 x 8] for one warp, bf16 in, f32 sums. Only
// rows 0..7 of A are live (the G <= 8 query rows): a0 holds (row lane / 4,
// columns 2 (lane % 4), + 1), a2 the same 8 columns on; rows 8..15 are 0.
// b0, b1: (rows 2 (lane % 4), + 1 and the same + 8, column lane / 4). C's
// c[0], c[1] are (row lane / 4, columns 2 (lane % 4), + 1).
__device__ __forceinline__ void mma_16816(float (&c)[4], uint32_t a0, uint32_t a2, uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

// One split of (b, h): its partial m, l (f32 [.., G, 2]) and unnormalised
// accumulator (f32 [.., G, D]) at part_*[b, h, split].
template <int D>
__global__ void __launch_bounds__(kSplitThreads)
paged_decode_split_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k_pool,
                          const bf16* __restrict__ v_pool, const int* __restrict__ tables,
                          const int* __restrict__ lengths, float* __restrict__ part_acc,
                          float* __restrict__ part_ml, int kv_heads, int groups, int num_blocks,
                          int block_size, int max_blocks, float sm_scale) {
  using L = SplitSmem<D>;
  constexpr int kLd = L::kLd;
  constexpr int kPieces = D / 8;  // 16-byte pieces per row
  const int split = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  // a table holds max_blocks * block_size slots: longer lengths attend over
  // those only, as the TPU kernel's clamped walk does
  const int len = max(0, min(lengths[b], max_blocks * block_size));
  const int t0 = split * kChunk;
  if (t0 >= len) return;  // past the length: the combine reads no partial of it
  const int n_live = min(kChunk, len - t0);

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);
  bf16* v_s = reinterpret_cast<bf16*>(smem + L::kv);
  float* acc_s = reinterpret_cast<float*>(smem + 2 * L::kv);  // [warp][row][D]
  float* m_s = reinterpret_cast<float*>(smem + 2 * L::kv + L::acc);  // [warp][row]
  float* l_s = m_s + kSplitWarps * kMaxG;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;  // this thread's query row of C
  const int t = lane % 4;
  const int* table = tables + static_cast<size_t>(b) * max_blocks;
  const size_t row_stride = static_cast<size_t>(kv_heads) * D;
  const size_t head_off = static_cast<size_t>(h) * D;

  // stage the run's rows of one pool, 16 bytes a thread at a time
  auto stage = [&](bf16* dst, const bf16* pool) {
    for (int i = tid; i < kChunk * kPieces; i += kSplitThreads) {
      const int r = i / kPieces;
      const int c = (i % kPieces) * 8;
      const bf16* src = pool;
      int bytes = 0;
      if (r < n_live) {
        const int tok = t0 + r;
        const int blk = min(max(table[tok / block_size], 0), num_blocks - 1);
        src = pool + (static_cast<size_t>(blk) * block_size + tok % block_size) * row_stride +
              head_off + c;
        bytes = 16;
      }
      cp_async16(dst + r * kLd + c, src, bytes);
    }
    cp_async_commit();
  };
  stage(k_s, k_pool);
  stage(v_s, v_pool);

  // q's row g as the A operand of each k16 step (0 for rows past G)
  uint32_t qa[D / 16][2];
  const bf16* q_row = q + ((static_cast<size_t>(b) * kv_heads + h) * groups + g) * D;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    qa[kk][0] = g < groups ? *reinterpret_cast<const uint32_t*>(q_row + kk * 16 + 2 * t) : 0u;
    qa[kk][1] = g < groups ? *reinterpret_cast<const uint32_t*>(q_row + kk * 16 + 8 + 2 * t) : 0u;
  }

  cp_async_wait<1>();  // K has landed
  __syncthreads();

  // S = Q K^T over this warp's 32 tokens: 4 tiles of 8 keys
  float s[4][4];
  const bf16* k_w = k_s + warp * 32 * kLd;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; kk += 2) {
      uint32_t kb[4];  // b0, b1 of k16 steps kk and kk + 1
      ldmatrix_x4(kb, k_w + (nt * 8 + lane % 8) * kLd + kk * 16 + 8 * (lane / 8));
      mma_16816(s[nt], qa[kk][0], qa[kk][1], kb[0], kb[1]);
      mma_16816(s[nt], qa[kk + 1][0], qa[kk + 1][1], kb[2], kb[3]);
    }
  }

  // softmax of row g's 32 scores: this thread holds keys 8 nt + 2 t + e
  float mx = -CUDART_INF_F;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool live = warp * 32 + nt * 8 + 2 * t + e < n_live;
      s[nt][e] = live ? s[nt][e] * sm_scale : kMaskValue;
      mx = fmaxf(mx, s[nt][e]);
    }
  mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
  float l = 0.f;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool live = warp * 32 + nt * 8 + 2 * t + e < n_live;
      const float p = live ? expf(s[nt][e] - mx) : 0.f;
      l += p;
      s[nt][e] = p;
    }
  l += __shfl_xor_sync(kFull, l, 1);
  l += __shfl_xor_sync(kFull, l, 2);

  // P (p in V's dtype) as the A operand of the two k16 steps over the
  // warp's keys: keys 16 j + 2 t, + 1 are tile 2 j's, + 8 tile 2 j + 1's
  uint32_t pa[2][2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    pa[j][0] = hopper::pack_bf16(s[2 * j][0], s[2 * j][1]);
    pa[j][1] = hopper::pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
  }

  cp_async_wait<0>();  // V has landed
  __syncthreads();

  // O = P V: D / 8 tiles of 8 dims, V's rows read transposed
  float o[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[nt][i] = 0.f;
  const bf16* v_w = v_s + warp * 32 * kLd;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int dt = 0; dt < D / 16; ++dt) {
      uint32_t vb[4];  // b0, b1 of dim tiles 2 dt and 2 dt + 1
      ldmatrix_x4_trans(vb, v_w + (16 * j + lane % 8 + 8 * ((lane / 8) % 2)) * kLd + 16 * dt +
                                8 * (lane / 16));
      mma_16816(o[2 * dt], pa[j][0], pa[j][1], vb[0], vb[1]);
      mma_16816(o[2 * dt + 1], pa[j][0], pa[j][1], vb[2], vb[3]);
    }

  // merge the warps' partial softmaxes into the split's (a warp whose keys
  // all lie past the length holds m = -1e30, l = 0, o = 0 and weighs
  // nothing; warp 0 always holds a live key)
  if (t == 0) {
    m_s[warp * kMaxG + g] = mx;
    l_s[warp * kMaxG + g] = l;
  }
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
    *reinterpret_cast<float2*>(acc_s + (warp * kMaxG + g) * D + nt * 8 + 2 * t) =
        make_float2(o[nt][0], o[nt][1]);
  __syncthreads();
  const size_t part = ((static_cast<size_t>(b) * kv_heads + h) * gridDim.x + split) * groups;
  for (int i = tid; i < groups * D; i += kSplitThreads) {
    const int r = i / D;
    const int d = i % D;
    float m = -CUDART_INF_F;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) m = fmaxf(m, m_s[w * kMaxG + r]);
    float a = 0.f, lsum = 0.f;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) {
      const float f = expf(m_s[w * kMaxG + r] - m);
      a += f * acc_s[(w * kMaxG + r) * D + d];
      lsum += f * l_s[w * kMaxG + r];
    }
    part_acc[(part + r) * D + d] = a;
    if (d == 0) {
      part_ml[(part + r) * 2] = m;
      part_ml[(part + r) * 2 + 1] = lsum;
    }
  }
}

// out[b, h] from the partials of (b, h)'s live splits; a length of 0 has
// none and gives zeros
template <int D>
__global__ void __launch_bounds__(kSplitThreads)
paged_decode_combine_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                            const int* __restrict__ lengths, bf16* __restrict__ out,
                            int kv_heads, int groups, int splits, int capacity) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int len = max(0, min(lengths[b], capacity));
  const int live = (len + kChunk - 1) / kChunk;
  const size_t bh = static_cast<size_t>(b) * kv_heads + h;
  for (int i = threadIdx.x; i < groups * D; i += kSplitThreads) {
    const int r = i / D;
    const int d = i % D;
    float m = -CUDART_INF_F;
    for (int s = 0; s < live; ++s) m = fmaxf(m, part_ml[((bh * splits + s) * groups + r) * 2]);
    float a = 0.f, l = 0.f;
    for (int s = 0; s < live; ++s) {
      const size_t at = (bh * splits + s) * groups + r;
      const float f = expf(part_ml[at * 2] - m);
      l += f * part_ml[at * 2 + 1];
      a += f * part_acc[at * D + d];
    }
    out[bh * groups * D + i] = __float2bfloat16_rn(l == 0.f ? 0.f : a / l);
  }
}

// ---- f32: one CTA per (b, h), CUDA cores -----------------------------------------

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;  // tokens per warp iteration: one per lane

// N consecutive floats read as one vector load (N <= 4)
template <int N>
struct alignas(sizeof(float) * N) Chunk {
  float v[N];
};

template <int N>
__device__ __forceinline__ Chunk<N> load_chunk(const float* p) {
  return *reinterpret_cast<const Chunk<N>*>(p);
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

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
paged_decode_kernel(const float* __restrict__ q, const float* __restrict__ k_pool,
                    const float* __restrict__ v_pool, const int* __restrict__ tables,
                    const int* __restrict__ lengths, float* __restrict__ out,
                    int kv_heads, int groups, int num_blocks, int block_size,
                    int max_blocks, float sm_scale) {
  constexpr int kVec = 4;                  // K elements per 16-byte load
  // output dims per lane, and the lanes that own them: D / 32 on every lane
  // from D = 32 on, one on each of the first D lanes below
  constexpr int kDims = D >= 32 ? D / 32 : 1;
  constexpr int kLanes = D / kDims;
  // V rows in flight per batch: 32 at D = 64; 16 at D = 128, where a lane's
  // slice of a row is twice as wide (32 rows there spill registers)
  constexpr int kVBatch = D <= 64 ? 32 : 16;
  static_assert(D == 16 || D % 32 == 0, "head_dim must be 16 or a multiple of 32");

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
  const bool owns_dims = kLanes == 32 || lane < kLanes;

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

  for (int i = tid; i < gd; i += kThreads) q_s[i / D][i % D] = q[q_off + i];

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
      const float* krow = k_pool + static_cast<size_t>(row) * row_stride + head_off;
#pragma unroll
      for (int c = 0; c < D; c += kVec) {
        const Chunk<kVec> kc = load_chunk<kVec>(krow + c);
#pragma unroll
        for (int r = 0; r < kMaxG; ++r) {
          if (r < groups) {
#pragma unroll
            for (int e = 0; e < kVec; ++e) s[r] += q_s[r][c + e] * kc.v[e];
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
        p_s[warp][r][lane] = p;
#pragma unroll
        for (int j = 0; j < kDims; ++j) acc[r][j] *= alpha;
      }
    }
    __syncwarp();

    // acc[r][lane's dims] += sum over the tile's live tokens of p[r][t] v[t]
#pragma unroll
    for (int t0 = 0; t0 < kTile; t0 += kVBatch) {
      Chunk<kDims> vc[kVBatch];
#pragma unroll
      for (int i = 0; i < kVBatch; ++i) {
        const int row_t = __shfl_sync(kFull, row, t0 + i);
        if (t0 + i < n_live && owns_dims)
          vc[i] = load_chunk<kDims>(v_pool + static_cast<size_t>(row_t) * row_stride +
                                    head_off + lane * kDims);
      }
#pragma unroll
      for (int i = 0; i < kVBatch; ++i) {
        if (t0 + i < n_live && owns_dims) {
#pragma unroll
          for (int r = 0; r < kMaxG; ++r) {
            if (r < groups) {
              const float p = p_s[warp][r][t0 + i];
#pragma unroll
              for (int j = 0; j < kDims; ++j) acc[r][j] += p * vc[i].v[j];
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
      if (owns_dims) {
#pragma unroll
        for (int j = 0; j < kDims; ++j) acc_s[warp][r][lane * kDims + j] = acc[r][j];
      }
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
    out[q_off + o] = l == 0.f ? 0.f : a / l;
  }
}

struct Args {
  const void *q, *k, *v;
  const int *tables, *lengths;
  void *out, *part_acc, *part_ml;
  int batch, kv_heads, groups, num_blocks, block_size, max_blocks, splits;
  float sm_scale;
  cudaStream_t stream;
};

template <int D>
int launch_split(const Args& a) {
  using L = SplitSmem<D>;
  static const cudaError_t attr = allow_smem(paged_decode_split_kernel<D>, L::total);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (a.splits <= 0 || static_cast<long long>(a.splits) * kChunk <
                           static_cast<long long>(a.max_blocks) * a.block_size)
    return static_cast<int>(cudaErrorInvalidValue);  // the splits must cover the table
  paged_decode_split_kernel<D><<<dim3(a.splits, a.kv_heads, a.batch), kSplitThreads, L::total,
                                 a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      a.tables, a.lengths, static_cast<float*>(a.part_acc), static_cast<float*>(a.part_ml),
      a.kv_heads, a.groups, a.num_blocks, a.block_size, a.max_blocks, a.sm_scale);
  paged_decode_combine_kernel<D><<<dim3(a.kv_heads, a.batch), kSplitThreads, 0, a.stream>>>(
      static_cast<const float*>(a.part_acc), static_cast<const float*>(a.part_ml), a.lengths,
      static_cast<bf16*>(a.out), a.kv_heads, a.groups, a.splits, a.max_blocks * a.block_size);
  return 0;
}

template <int D>
int launch_f32(const Args& a) {
  paged_decode_kernel<D><<<dim3(a.batch, a.kv_heads), kThreads, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.tables, a.lengths, static_cast<float*>(a.out),
      a.kv_heads, a.groups, a.num_blocks, a.block_size, a.max_blocks, a.sm_scale);
  return 0;
}

// dtype 0 = f32 runs the CUDA-core kernel, 1 = bf16 the split walk
template <int D>
int launch(int dtype, const Args& a) {
  if (dtype == 0) return launch_f32<D>(a);
  if (dtype == 1) return launch_split<D>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int D>
int resources_of(int dtype, int* out) {
  if (dtype == 0) return resources(paged_decode_kernel<D>, kThreads, 0, out);
  if (dtype == 1)
    return resources(paged_decode_split_kernel<D>, kSplitThreads, SplitSmem<D>::total, out);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. part_acc [B, KVH, splits, G, D] and
// part_ml [B, KVH, splits, G, 2] (f32) are the bf16 walk's workspace, with
// splits * paged_decode_split_tokens() >= max_blocks * block_size; f32 reads
// neither. Returns
// cudaGetLastError() after the launches (0 on success), or
// cudaErrorInvalidValue for a shape or dtype the kernels do not take.
// Launches on `stream`, does not synchronise.
int paged_decode(const void* q, const void* k_pool, const void* v_pool, const void* tables,
                 const void* lengths, void* out, void* part_acc, void* part_ml, int batch,
                 int kv_heads, int groups, int head_dim, int num_blocks, int block_size,
                 int max_blocks, int splits, float sm_scale, int dtype, void* stream) {
  if (batch <= 0 || kv_heads <= 0 || groups <= 0 || groups > kMaxG || num_blocks <= 0 ||
      block_size <= 0 || max_blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // start from a clean error state
  const Args a{q, k_pool, v_pool, static_cast<const int*>(tables),
               static_cast<const int*>(lengths), out, part_acc, part_ml, batch, kv_heads,
               groups, num_blocks, block_size, max_blocks, splits, sm_scale,
               static_cast<cudaStream_t>(stream)};
  int rc;
  if (head_dim == 64)
    rc = launch<64>(dtype, a);
  else if (head_dim == 128)
    rc = launch<128>(dtype, a);
  else if (head_dim == 16 && dtype == 0)
    rc = launch_f32<16>(a);
  else if (head_dim == 32 && dtype == 0)
    rc = launch_f32<32>(a);
  else
    rc = static_cast<int>(cudaErrorInvalidValue);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// What the kernel for (head_dim, dtype) holds on the card (bf16: the split
// kernel), into out[5]: registers per thread at launch, shared memory per
// CTA, CTAs per SM, threads per CTA, spilled bytes per thread. Returns 0 or
// a CUDA error.
int paged_decode_resources(int head_dim, int dtype, int* out) {
  if (head_dim == 64) return resources_of<64>(dtype, out);
  if (head_dim == 128) return resources_of<128>(dtype, out);
  if (head_dim == 16 && dtype == 0) return resources(paged_decode_kernel<16>, kThreads, 0, out);
  if (head_dim == 32 && dtype == 0) return resources(paged_decode_kernel<32>, kThreads, 0, out);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Tokens per CTA of the bf16 split walk, from which the host sizes `splits`.
int paged_decode_split_tokens() { return kChunk; }

const char* paged_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
