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
// f32 (paged_decode_f32_kernel): the walk is split over the sequence as in
// bf16, and the splits of one (b, h) are merged inside the one launch. The
// grid is (splits, KVH, B) and the CTAs of one (b, h) form a thread-block
// cluster (the host's rule, paged_decode_f32_split_tokens and _max_splits:
// splits of at least 256 tokens, at most 8 of them, a cluster the portable
// size at most; a table past 2048 tokens gives each split more). CTA s
// takes tokens s * split_tokens .. on; a CTA whose run starts at or past its
// length loads nothing. Its warps (8 at D = 16, else 4) each take every 8th
// or 4th tile of its run and keep their own online softmax (m, l and the
// G x D accumulator in registers). A tile is 32 tokens at D = 16 and 32, 16
// at D = 64, 8 at D = 128 (one lane a token, or 2 or 4 lanes a token, each
// taking every 2nd or 4th 16-byte chunk of its row), so that a warp's ring
// of stages (2 at D = 16, else 3) stays under 27 KiB: each stage is loaded
// with cp.async, 16 bytes a lane, the pool rows looked up a tile ahead,
// rows past the run zero-filled, and the loads of the next tiles are in
// flight while the warp computes on this one. Scores are taken on the CUDA
// cores in f32 FMA against q in shared memory (K rows padded by 16 bytes,
// so that the lanes of a quarter-warp read distinct banks): tf32 tensor
// cores would break the f32 contract, and at G <= 8 decode does about G / 2
// flop a byte of K and V, against the card's ~20 f32 flop a byte of
// bandwidth. For P V each lane owns D / 32 output dims (at D = 16 the first
// 16 lanes own one each), V read from the stage and p from shared memory.
// Then each CTA merges its warps' partials through shared memory into its
// split's (m, l, acc), the cluster synchronises, and every CTA of it merges
// an equal share of the G x D outputs over the live splits, reading their
// partials through distributed shared memory, and writes out; a second
// cluster barrier keeps each CTA's shared memory alive until the others
// have read it. There is no workspace and no second launch: llama-tiny's
// decode (D = 16, 160 tokens of capacity) takes one split, whose 5 tiles
// go to 5 warps, and at the llama-1b serving shape the 2048-token row takes
// 8 CTAs instead of one. On the card the walk's arithmetic, not its loads,
// sets the time at that shape: the q and p reads from shared memory, not
// the FMAs or HBM, are the limit (the kernel with its loads cut ran nearly
// as long as the whole). f32 is llama-tiny's dtype (D = 16), which
// serve_bench's speculative fixture decodes on the card; the f32 kernel
// takes D = 16, 32, 64 and 128, the bf16 walk 64 and 128.

#include <cooperative_groups.h>

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

// ---- f32: the walk split over a cluster of CTAs, CUDA cores ----------------------

constexpr int kF32Tokens = 256;   // tokens per split at least (the host's rule)
constexpr int kF32MaxSplits = 8;  // splits at most: one cluster of the portable size

// N consecutive floats read as one vector load (N <= 4)
template <int N>
struct alignas(sizeof(float) * N) Chunk {
  float v[N];
};

template <int N>
__device__ __forceinline__ Chunk<N> load_chunk(const float* p) {
  return *reinterpret_cast<const Chunk<N>*>(p);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

template <int D>
struct F32Tiles {
  static_assert(D == 16 || D % 32 == 0, "head_dim must be 16 or a multiple of 32");
  // warps of a CTA, and tiles of a warp in flight (this one included): at
  // D = 16 eight warps of two, so that llama-tiny's 160-token table takes
  // one tile a warp; else four of three
  static constexpr int kWarps = D == 16 ? 8 : 4;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kStages = D == 16 ? 2 : 3;
  // tokens of a warp's tile and lanes per token: 32 x 1 at D <= 32, 16 x 2
  // at D = 64, 8 x 4 at D = 128
  static constexpr int kTok = D <= 32 ? 32 : 1024 / D;
  static constexpr int kParts = 32 / kTok;
  static constexpr int kChunks = D / 4;  // 16-byte chunks of a row
  static constexpr int kLdK = D + 4;     // a staged K row, padded by 16 bytes
  // in floats: a stage (K tile, then V tile) and a warp's ring of them,
  // which after the walk holds the warp's partial: acc [G][D], m [G], l [G]
  static constexpr int k_tile = kTok * kLdK;
  static constexpr int stage = k_tile + kTok * D;
  static constexpr int ring = kStages * stage;
  static_assert(ring >= kMaxG * D + 2 * kMaxG, "the ring holds the warp's partial");
  // then q [G][D], each warp's p [G][kTok], and the CTA's partial (acc, m, l)
  static constexpr int q = kWarps * ring;
  static constexpr int p = q + kMaxG * D;
  static constexpr int part = p + kWarps * kMaxG * kTok;
  static constexpr size_t total = sizeof(float) * (part + kMaxG * D + 2 * kMaxG);
};

// One (b, h)'s split `blockIdx.x` of split_tokens tokens; the cluster over
// blockIdx.x holds all of (b, h)'s splits and writes out[b, h].
template <int D>
__global__ void __launch_bounds__(F32Tiles<D>::kThreads)
paged_decode_f32_kernel(const float* __restrict__ q, const float* __restrict__ k_pool,
                        const float* __restrict__ v_pool, const int* __restrict__ tables,
                        const int* __restrict__ lengths, float* __restrict__ out, int kv_heads,
                        int groups, int num_blocks, int block_size, int max_blocks,
                        int split_tokens, float sm_scale) {
  using L = F32Tiles<D>;
  constexpr int kWarps = L::kWarps;
  constexpr int kThreads = L::kThreads;
  constexpr int kStages = L::kStages;
  constexpr int kTok = L::kTok;
  constexpr int kParts = L::kParts;
  constexpr int kChunks = L::kChunks;
  // output dims per lane in P V, and the lanes that own them: D / 32 on
  // every lane from D = 32 on, one on each of the first D lanes below
  constexpr int kDims = D >= 32 ? D / 32 : 1;
  constexpr int kLanes = D / kDims;

  extern __shared__ __align__(16) float smem_f32[];
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int split = blockIdx.x;  // the cluster spans the splits: its rank
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int gd = groups * D;
  const size_t q_off = (static_cast<size_t>(b) * kv_heads + h) * gd;
  // a table holds max_blocks * block_size slots: longer lengths attend over
  // those only, as the TPU kernel's clamped walk does
  const int len = max(0, min(lengths[b], max_blocks * block_size));
  const int t0 = split * split_tokens;
  const int t1 = min(len, t0 + split_tokens);  // this CTA's run is [t0, t1)
  const int n_tiles = t1 > t0 ? tiles_of(t1 - t0, kTok) : 0;
  float* part = smem_f32 + L::part;  // the split's acc [G][D], m [G], l [G]

  if (n_tiles > 0) {
    float* ring = smem_f32 + warp * L::ring;
    float* q_s = smem_f32 + L::q;
    float* p_s = smem_f32 + L::p + warp * kMaxG * kTok;
    const int* table = tables + static_cast<size_t>(b) * max_blocks;
    const size_t row_stride = static_cast<size_t>(kv_heads) * D;
    const size_t head_off = static_cast<size_t>(h) * D;
    const int my_tiles = n_tiles > warp ? (n_tiles - 1 - warp) / kWarps + 1 : 0;
    const int tok_lane = lane % kTok;   // this lane's token of a tile
    const int part_lane = lane / kTok;  // and its share of the token's chunks
    auto tile_start = [&](int i) { return t0 + (warp + i * kWarps) * kTok; };

    // the pool row of this lane's token of the warp's i-th tile (-1 past the
    // run), looked up a tile ahead of its loads, so that the table's
    // latency is not paid on the way to each wait
    auto lookup = [&](int i) {
      const int tok = tile_start(i) + tok_lane;
      if (i >= my_tiles || tok >= t1) return -1;
      const int blk = min(max(table[tok / block_size], 0), num_blocks - 1);
      return blk * block_size + tok % block_size;
    };
    // the warp's i-th tile into ring slot i % kStages, one commit group a
    // tile (empty past the warp's tiles, so that the count stays even)
    auto load = [&](int i, int row) {
      if (i < my_tiles) {
        float* k_dst = ring + (i % kStages) * L::stage;
        float* v_dst = k_dst + L::k_tile;
#pragma unroll
        for (int j = 0; j < kTok * kChunks / 32; ++j) {
          const int piece = lane + 32 * j;
          const int t = piece / kChunks;
          const int c = piece % kChunks;
          const int r = __shfl_sync(kFull, row, t);
          const size_t src = r < 0 ? 0 : static_cast<size_t>(r) * row_stride + head_off + 4 * c;
          cp_async16(k_dst + t * L::kLdK + 4 * c, k_pool + src, r < 0 ? 0 : 16);
          cp_async16(v_dst + t * D + 4 * c, v_pool + src, r < 0 ? 0 : 16);
        }
      }
      cp_async_commit();
    };
    int rows[kStages - 1];
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) rows[i] = lookup(i);
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) load(i, rows[i]);
    int row_next = lookup(kStages - 1);
    for (int i = tid; i < gd; i += kThreads) q_s[i] = q[q_off + i];

    float acc[kMaxG][kDims];
    float m_row[kMaxG];
    float l_row[kMaxG];  // this lane's part of each row's sum
#pragma unroll
    for (int r = 0; r < kMaxG; ++r) {
      m_row[r] = -CUDART_INF_F;
      l_row[r] = 0.f;
#pragma unroll
      for (int j = 0; j < kDims; ++j) acc[r][j] = 0.f;
    }
    __syncthreads();  // q_s

    for (int i = 0; i < my_tiles; ++i) {
      load(i + kStages - 1, row_next);  // into the slot tile i - 1 left
      row_next = lookup(i + kStages);
      cp_async_wait<kStages - 1>();
      __syncwarp();  // tile i has landed, every lane's share of it
      const float* k_s = ring + (i % kStages) * L::stage;
      const float* v_s = k_s + L::k_tile;
      const bool live = tile_start(i) + tok_lane < t1;

      // scores of this lane's token: its chunks, then the sum over the
      // token's lanes
      float s[kMaxG];
#pragma unroll
      for (int r = 0; r < kMaxG; ++r) s[r] = 0.f;
      const float* k_row = k_s + tok_lane * L::kLdK;
#pragma unroll
      for (int j = 0; j < kChunks / kParts; ++j) {
        const int c = j * kParts + part_lane;
        const float4 kc = *reinterpret_cast<const float4*>(k_row + 4 * c);
#pragma unroll
        for (int r = 0; r < kMaxG; ++r) {
          if (r < groups) {
            const float4 qc = *reinterpret_cast<const float4*>(q_s + r * D + 4 * c);
            s[r] = fmaf(qc.x, kc.x, s[r]);
            s[r] = fmaf(qc.y, kc.y, s[r]);
            s[r] = fmaf(qc.z, kc.z, s[r]);
            s[r] = fmaf(qc.w, kc.w, s[r]);
          }
        }
      }

      // online softmax, one query row at a time; every tile holds at least
      // one live token, so m_new is a real score
#pragma unroll
      for (int r = 0; r < kMaxG; ++r) {
        if (r < groups) {
#pragma unroll
          for (int o = kTok; o < 32; o <<= 1) s[r] += __shfl_xor_sync(kFull, s[r], o);
          const float sr = live ? s[r] * sm_scale : kMaskValue;
          float mx = sr;
#pragma unroll
          for (int o = 1; o < kTok; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
          const float m_new = fmaxf(m_row[r], mx);
          const float alpha = expf(m_row[r] - m_new);  // 0 on the warp's first tile
          const float p = live ? expf(sr - m_new) : 0.f;
          l_row[r] = alpha * l_row[r] + (part_lane == 0 ? p : 0.f);
          m_row[r] = m_new;
          if (part_lane == 0) p_s[r * kTok + tok_lane] = p;
#pragma unroll
          for (int j = 0; j < kDims; ++j) acc[r][j] *= alpha;
        }
      }
      __syncwarp();

      // acc[r][lane's dims] += sum over the tile's tokens of p[r][t] v[t]
      // (rows past the run were zero-filled and have p = 0)
      if (kLanes == 32 || lane < kLanes) {
#pragma unroll
        for (int t = 0; t < kTok; t += 4) {
          Chunk<kDims> vc[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) vc[e] = load_chunk<kDims>(v_s + (t + e) * D + lane * kDims);
#pragma unroll
          for (int r = 0; r < kMaxG; ++r) {
            if (r < groups) {
              const float4 p4 = *reinterpret_cast<const float4*>(p_s + r * kTok + t);
#pragma unroll
              for (int j = 0; j < kDims; ++j) {
                acc[r][j] = fmaf(p4.x, vc[0].v[j], acc[r][j]);
                acc[r][j] = fmaf(p4.y, vc[1].v[j], acc[r][j]);
                acc[r][j] = fmaf(p4.z, vc[2].v[j], acc[r][j]);
                acc[r][j] = fmaf(p4.w, vc[3].v[j], acc[r][j]);
              }
            }
          }
        }
      }
      __syncwarp();  // the next tile's loads overwrite this slot, and p_s
    }

    // the warp's partial into its own ring (a warp that walked no tile holds
    // m = -inf, l = 0, acc = 0 and weighs nothing)
    cp_async_wait<0>();
    __syncwarp();
#pragma unroll
    for (int r = 0; r < kMaxG; ++r) {
      if (r < groups) {
        const float l_sum = warp_sum(l_row[r]);
        if (lane == 0) {
          ring[kMaxG * D + r] = m_row[r];
          ring[kMaxG * D + kMaxG + r] = l_sum;
        }
        if (kLanes == 32 || lane < kLanes) {
#pragma unroll
          for (int j = 0; j < kDims; ++j) ring[r * D + lane * kDims + j] = acc[r][j];
        }
      }
    }
    __syncthreads();
    // the split's partial: the warps' merged (warp 0 holds a live token)
    for (int o = tid; o < gd; o += kThreads) {
      const int r = o / D;
      float m = -CUDART_INF_F;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) m = fmaxf(m, smem_f32[w * L::ring + kMaxG * D + r]);
      float a = 0.f, l = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float* wp = smem_f32 + w * L::ring;
        const float f = expf(wp[kMaxG * D + r] - m);
        a += f * wp[o];
        l += f * wp[kMaxG * D + kMaxG + r];
      }
      part[o] = a;
      if (o % D == 0) {
        part[kMaxG * D + r] = m;
        part[kMaxG * D + kMaxG + r] = l;
      }
    }
  }

  // every split's partial is written; each CTA of the cluster merges its
  // share of the outputs over the live splits (a length of 0 has none and
  // gives zeros)
  cluster.sync();
  const int live_splits = tiles_of(len, split_tokens);
  for (int o = split * kThreads + tid; o < gd; o += gridDim.x * kThreads) {
    const int r = o / D;
    float ms[kF32MaxSplits], ls[kF32MaxSplits], as[kF32MaxSplits];
    float m = -CUDART_INF_F;
#pragma unroll
    for (int s = 0; s < kF32MaxSplits; ++s) {
      if (s < live_splits) {
        const float* sp = cluster.map_shared_rank(part, s);
        ms[s] = sp[kMaxG * D + r];
        ls[s] = sp[kMaxG * D + kMaxG + r];
        as[s] = sp[o];
        m = fmaxf(m, ms[s]);
      }
    }
    float a = 0.f, l = 0.f;
#pragma unroll
    for (int s = 0; s < kF32MaxSplits; ++s) {
      if (s < live_splits) {
        const float f = expf(ms[s] - m);
        a += f * as[s];
        l += f * ls[s];
      }
    }
    out[q_off + o] = l == 0.f ? 0.f : a / l;
  }
  cluster.sync();  // no CTA leaves while another reads its shared memory
}

struct Args {
  const void *q, *k, *v;
  const int *tables, *lengths;
  void *out, *part_acc, *part_ml;
  int batch, kv_heads, groups, num_blocks, block_size, max_blocks, splits, split_tokens;
  float sm_scale;
  cudaStream_t stream;
};

template <int D>
int launch_split(const Args& a) {
  using L = SplitSmem<D>;
  static const cudaError_t attr = allow_smem(paged_decode_split_kernel<D>, L::total);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (a.split_tokens != kChunk || a.splits <= 0 ||
      static_cast<long long>(a.splits) * kChunk <
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

// one launch: grid (splits, KVH, B), a cluster over each (b, h)'s splits
template <int D>
int launch_f32(const Args& a) {
  using L = F32Tiles<D>;
  static const cudaError_t attr = allow_smem(paged_decode_f32_kernel<D>, L::total);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (a.splits <= 0 || a.splits > kF32MaxSplits || a.split_tokens <= 0 ||
      static_cast<long long>(a.splits) * a.split_tokens <
          static_cast<long long>(a.max_blocks) * a.block_size)
    return static_cast<int>(cudaErrorInvalidValue);  // the splits must cover the table
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = a.splits;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.splits, a.kv_heads, a.batch);
  cfg.blockDim = dim3(L::kThreads);
  cfg.dynamicSmemBytes = L::total;
  cfg.stream = a.stream;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, paged_decode_f32_kernel<D>, static_cast<const float*>(a.q),
      static_cast<const float*>(a.k), static_cast<const float*>(a.v), a.tables, a.lengths,
      static_cast<float*>(a.out), a.kv_heads, a.groups, a.num_blocks, a.block_size,
      a.max_blocks, a.split_tokens, a.sm_scale));
}

// dtype 0 = f32 runs the cluster walk, 1 = bf16 the split walk and its combine
template <int D>
int launch(int dtype, const Args& a) {
  if (dtype == 0) return launch_f32<D>(a);
  if (dtype == 1) return launch_split<D>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int D>
int resources_f32(int* out) {
  return resources(paged_decode_f32_kernel<D>, F32Tiles<D>::kThreads, F32Tiles<D>::total, out);
}

template <int D>
int resources_of(int dtype, int* out) {
  if (dtype == 0) return resources_f32<D>(out);
  if (dtype == 1)
    return resources(paged_decode_split_kernel<D>, kSplitThreads, SplitSmem<D>::total, out);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. splits x split_tokens must cover the
// table (max_blocks * block_size tokens): in bf16 split_tokens is
// paged_decode_split_tokens(), and part_acc [B, KVH, splits, G, D] and
// part_ml [B, KVH, splits, G, 2] (f32) are the walk's workspace; in f32
// the host's rule (paged_decode_f32_split_tokens, _max_splits) sizes them,
// splits is the cluster's size and no workspace is read. Returns
// cudaGetLastError() after the launches (0 on success), or
// cudaErrorInvalidValue for a shape or dtype the kernels do not take.
// Launches on `stream`, does not synchronise.
int paged_decode(const void* q, const void* k_pool, const void* v_pool, const void* tables,
                 const void* lengths, void* out, void* part_acc, void* part_ml, int batch,
                 int kv_heads, int groups, int head_dim, int num_blocks, int block_size,
                 int max_blocks, int splits, int split_tokens, float sm_scale, int dtype,
                 void* stream) {
  if (batch <= 0 || kv_heads <= 0 || groups <= 0 || groups > kMaxG || num_blocks <= 0 ||
      block_size <= 0 || max_blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // start from a clean error state
  const Args a{q, k_pool, v_pool, static_cast<const int*>(tables),
               static_cast<const int*>(lengths), out, part_acc, part_ml, batch, kv_heads,
               groups, num_blocks, block_size, max_blocks, splits, split_tokens, sm_scale,
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
  if (head_dim == 16 && dtype == 0) return resources_f32<16>(out);
  if (head_dim == 32 && dtype == 0) return resources_f32<32>(out);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Tokens per CTA of the bf16 split walk, from which the host sizes `splits`.
int paged_decode_split_tokens() { return kChunk; }

// The f32 walk's host rule: splits of at least this many tokens ...
int paged_decode_f32_split_tokens() { return kF32Tokens; }

// ... and at most this many splits (one cluster) to a (b, h).
int paged_decode_f32_max_splits() { return kF32MaxSplits; }

const char* paged_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
