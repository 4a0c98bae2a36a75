// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel polyaxon_tpu/ops/flash_attention.py::_fwd_kernel
// (launched by _flash_fwd). It computes the same function: for each row i of
// q and each (batch*head) bh,
//   O[i] = sum_j softmax_j(q_i . k_j * scale) v_j,   LSE[i] = log sum_j exp(...)
// with the causal mask on global positions q_offset + i >= k_offset + j.
// Scores, the running max m, the running sum l and the accumulator are f32;
// hidden scores are set to -1e30 and their p to 0; p is rounded to V's dtype
// before p.V; O is written in the input dtype, LSE as f32 [BH, Sq]; a row
// that sees no key gets O = 0 and LSE = -inf. These are the TPU kernel's
// rules, line for line.
//
//   q [BH, Sq, D], k/v [BH, Sk, D] (K/V already expanded to every head),
//   o [BH, Sq, D], lse [BH, Sq] f32; D = 64 or 128; bf16 or f32; any Sq, Sk.
//
// The TPU carried the online-softmax state across a sequential grid axis;
// here one CTA per (bh, q tile) walks the kv tiles in a loop, and the loop
// stops at the last causally visible tile (what _kv_clamp does with the
// DMA): tiles above the diagonal are neither loaded nor computed. The CTAs
// of the last q tiles have the most kv tiles to walk, so they are launched
// first. A length that is no multiple of the tile ends in a partial tile:
// its missing rows are loaded as zeros, its missing keys are hidden like
// masked ones, and its missing rows are not written.
//
// Bound on the H100. Two products of 2 * Sq * Sk * D FLOP (half of it under
// the causal mask) against one read of q, k, v and one write of o: at the
// llama-1b shape (BH 64, S 2048, D 64, bf16) 3.4e10 FLOP over 989 TFLOP/s is
// 34.7 us, while the 67 MB of traffic take 20 us, so the tensor cores bound
// it.
//
// bf16 (flash_fwd_wgmma_kernel): built for that bound from Hopper's pieces
// (hopper.cuh). A CTA holds consumer warpgroups of 64 q rows each (one at
// D = 64, two CTAs to an SM; two at D = 128, one CTA to an SM) and a
// producer warp that loads the Q tile once and streams 128-key K/V tiles
// by TMA into a ring of two stages, guarded by mbarriers (a "full" barrier
// per stage that TMA completes, an "empty" one that the consumers' warps
// release). The producer gives its registers to the consumers
// (setmaxnreg). Each consumer warpgroup computes its scores S = Q K^T by
// wgmma from shared memory into registers; runs the online softmax there,
// each row spread over the four threads of a quad (two shuffles reduce its
// max; its sum stays per thread until the end), in base 2 with
// scale * log2(e) folded into one FFMA per score (the row's reference is
// taken over its raw scores: their max, or their min in the instantiation
// for scale < 0, since a negative scale turns the one into the other);
// rescales its O
// accumulator, which also stays in registers, by alpha; and adds P V by
// wgmma with P, rounded to bf16, as the register A operand. Shared memory
// holds only the Q, K and V tiles: 73 KB at D = 64, 161 KB at D = 128.
// Masking runs only on the tiles that cross the diagonal or the end of the
// keys. At D = 64 the softmax's instructions and each CTA's prologue and
// epilogue, not the products or the loads, set the pace: on the card the
// FFMA form of the softmax and the second CTA per SM each made the kernel
// faster, while a third stage, a third consumer warpgroup or an
// in-warpgroup pipelined loop did not help.
//
// f32 (flash_fwd_kernel): 32-row tiles, 2 warps per CTA, products on the
// CUDA cores (tensor cores would round to tf32), scores, p and the
// accumulator in shared memory. f32 is llama-tiny's dtype, never on the
// card's main path.

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;

// ---- f32: CUDA cores, scores and accumulator in shared memory ----------------

template <int D>
struct FwdSmem {
  static constexpr int kTile = kTileF32;
  static constexpr int kWarps = kTile / 16;
  static constexpr size_t q = pad128(sizeof(float) * kTile * ld_of<D>());
  static constexpr size_t kv = q;  // each of K and V
  static constexpr size_t s = pad128(sizeof(float) * kWarps * 16 * ldf_of<kTile>());
  static constexpr size_t p = pad128(sizeof(float) * kWarps * 16 * ld_of<kTile>());
  static constexpr size_t o = pad128(sizeof(float) * kWarps * 16 * ldf_of<D>());
  static constexpr size_t total = q + 2 * kv + s + p + o;
};

template <int D>
__global__ void __launch_bounds__(FwdSmem<D>::kWarps * 32)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                 int sq, int sk, int q_offset, int k_offset, int causal, int walk_cut,
                 float scale) {
  using L = FwdSmem<D>;
  constexpr int kTile = L::kTile;
  constexpr int kThreads = L::kWarps * 32;
  constexpr int LD = ld_of<D>();
  constexpr int LDS = ldf_of<kTile>();
  constexpr int LDP = ld_of<kTile>();
  constexpr int LDO = ldf_of<D>();
  constexpr int kHalfS = kTile / 2;
  constexpr int kHalfD = D / 2;

  extern __shared__ __align__(128) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  float* k_s = reinterpret_cast<float*>(smem + L::q);
  float* v_s = reinterpret_cast<float*>(smem + L::q + L::kv);
  float* s_all = reinterpret_cast<float*>(smem + L::q + 2 * L::kv);
  float* p_all = reinterpret_cast<float*>(smem + L::q + 2 * L::kv + L::s);
  float* o_all = reinterpret_cast<float*>(smem + L::q + 2 * L::kv + L::s + L::p);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int r = lane >> 1;     // this lane's row of the warp's 16
  const int half = lane & 1;   // and which half of the row's columns
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;  // heaviest tiles first
  float* s_w = s_all + warp * 16 * LDS;
  float* p_w = p_all + warp * 16 * LDP;
  float* o_w = o_all + warp * 16 * LDO;
  const float* q_w = q_s + warp * 16 * LD;

  load_tile<D>(q_s, q + (static_cast<size_t>(bh) * sq + q0) * D, kTile, sq - q0, tid, kThreads);
  for (int c = half * kHalfD; c < (half + 1) * kHalfD; ++c) o_w[r * LDO + c] = 0.f;

  const int kend = kv_tiles_end(q0, kTile, kTile, tiles_of(sk, kTile), q_offset, k_offset,
                                causal, walk_cut);
  const int row = warp * 16 + r;  // this lane's row of the q tile
  const int qid = q_offset + q0 + row;
  float m = -CUDART_INF_F;
  float l = 0.f;

  for (int t = 0; t < kend; ++t) {
    const int k0 = t * kTile;
    __syncthreads();  // the previous tile's K/V are no longer read
    const size_t key0 = static_cast<size_t>(bh) * sk + k0;
    load_tile<D>(k_s, k + key0 * D, kTile, sk - k0, tid, kThreads);
    load_tile<D>(v_s, v + key0 * D, kTile, sk - k0, tid, kThreads);
    __syncthreads();
    // key c of the tile is hidden: past the end, or past the row's position
    auto hidden = [&](int c) { return k0 + c >= sk || (causal && qid < k_offset + k0 + c); };

    warp_mma<true, kTile, D>(s_w, LDS, q_w, LD, k_s, LD, false);  // S = Q K^T
    __syncwarp();

    // online softmax over this lane's half row
    float mx = -CUDART_INF_F;
    for (int c = half * kHalfS; c < (half + 1) * kHalfS; ++c) {
      float sc = s_w[r * LDS + c] * scale;
      if (hidden(c)) sc = kMaskValue;
      s_w[r * LDS + c] = sc;
      mx = fmaxf(mx, sc);
    }
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float safe_m = m_new == -CUDART_INF_F ? 0.f : m_new;
    const float alpha = m == -CUDART_INF_F ? 0.f : expf(m - safe_m);
    float sum = 0.f;
    for (int c = half * kHalfS; c < (half + 1) * kHalfS; ++c) {
      float p = expf(s_w[r * LDS + c] - safe_m);
      if (hidden(c)) p = 0.f;
      sum += p;
      p_w[r * LDP + c] = p;
    }
    sum += __shfl_xor_sync(kFull, sum, 1);
    l = alpha * l + sum;
    m = m_new;
    for (int c = half * kHalfD; c < (half + 1) * kHalfD; ++c) o_w[r * LDO + c] *= alpha;
    __syncwarp();

    warp_mma<false, D, kTile>(o_w, LDO, p_w, LDP, v_s, LD, true);  // O += P V
    __syncwarp();
  }

  if (q0 + row >= sq) return;  // a row past the end of a partial tile
  const float l_safe = l == 0.f ? 1.f : l;
  float* o_row = o + (static_cast<size_t>(bh) * sq + q0 + row) * D;
  for (int c = half * kHalfD; c < (half + 1) * kHalfD; ++c) o_row[c] = o_w[r * LDO + c] / l_safe;
  if (half == 0)
    lse[static_cast<size_t>(bh) * sq + q0 + row] = l == 0.f ? -CUDART_INF_F : m + logf(l_safe);
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, float* lse, int bh, int sq,
               int sk, int q_offset, int k_offset, int causal, int walk_cut, float scale,
               cudaStream_t stream) {
  using L = FwdSmem<D>;
  static const cudaError_t attr = allow_smem(flash_fwd_kernel<D>, L::total);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(tiles_of(sq, L::kTile), bh);
  flash_fwd_kernel<D><<<grid, L::kWarps * 32, L::total, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, sq, sk, q_offset, k_offset, causal, walk_cut, scale);
  return 0;
}

// ---- bf16: wgmma, TMA, accumulators in registers ------------------------------

constexpr int kBlockK = 128;  // keys per kv tile
constexpr int kStages = 2;    // K/V tiles in flight

template <int D>
struct FwdTiles {
  // consumer warpgroups of 64 q rows per CTA: one at D = 64, where two CTAs
  // then share an SM and hide each other's prologue and epilogue; two at
  // D = 128, where one CTA's tiles take most of the shared memory
  static constexpr int kConsumers = D == 64 ? 1 : 2;
  static constexpr int kBlockQ = 64 * kConsumers;
  static constexpr int kThreads = (kConsumers + 1) * 128;
  static constexpr int kCtasPerSm = 3 - kConsumers;
  // a consumer thread's registers once the producer has given up its own
  static constexpr int kRegs = kConsumers == 1 ? 232 : 240;
  static constexpr uint32_t q = hopper::tile_bytes<D, kBlockQ>();
  static constexpr uint32_t kv = hopper::tile_bytes<D, kBlockK>();  // one of K, V
  static constexpr uint32_t stage = 2 * kv;
  // tiles, then the barriers (Q, full and empty per stage), plus the room
  // to align the start to 1024 bytes
  static constexpr size_t total = q + kStages * stage + 8 * (1 + 2 * kStages) + 1024;
};

template <int D, bool kNegScale>
__global__ void __launch_bounds__(FwdTiles<D>::kThreads, FwdTiles<D>::kCtasPerSm)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, int sq, int sk, int q_offset, int k_offset,
                       int causal, int walk_cut, float scale) {
  using namespace hopper;
  using L = FwdTiles<D>;
  using bf16 = __nv_bfloat16;
  constexpr int kConsumers = L::kConsumers;
  constexpr int kBlockQ = L::kBlockQ;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  unsigned char* ring = smem + L::q;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + kStages * L::stage);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;  // heaviest tiles first
  const int kend = kv_tiles_end(q0, kBlockQ, kBlockK, tiles_of(sk, kBlockK), q_offset, k_offset,
                                causal, walk_cut);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    bar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], kConsumers * 4);  // one arrival per consumer warp
    }
    fence_bar_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // producer: one thread issues every load
    regs_dec<24>();
    if (threadIdx.x == kConsumers * 128) {
      bar_arrive_expect_tx(q_full, L::q);
      tma_tile<D, kBlockQ>(q_s, &q_map, q_full, q0, bh);
      for (int t = 0; t < kend; ++t) {
        const int s = t % kStages;
        bar_wait(&empty[s], ((t / kStages) & 1) ^ 1);  // the first round finds it free
        bar_arrive_expect_tx(&full[s], L::stage);
        bf16* k_s = reinterpret_cast<bf16*>(ring + s * L::stage);
        tma_tile<D, kBlockK>(k_s, &k_map, &full[s], t * kBlockK, bh);
        tma_tile<D, kBlockK>(k_s + kBlockK * D, &v_map, &full[s], t * kBlockK, bh);
      }
    }
    return;
  }

  // consumer warpgroup wg: q rows wg * 64 .. + 63 of the tile
  regs_inc<L::kRegs>();
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int row0 = wg * 64 + (tid / 32) * 16 + lane / 4;  // this thread's rows: row0, row0 + 8
  const int col0 = 2 * (lane % 4);                         // and columns col0, col0 + 1 of each 8
  const int qid0 = q_offset + q0 + row0;
  const float scale_log2 = scale * kLog2e;
  // a row's largest scaled score is its largest raw one times the scale, or
  // its smallest when scale < 0; a hidden score is set to the raw value
  // whose scaled value has the mask value's sign
  constexpr float raw_mask = kNegScale ? -kMaskValue : kMaskValue;
  auto top = [](float a, float b) { return kNegScale ? fminf(a, b) : fmaxf(a, b); };
  const bf16* q_wg = q_s + wg * 64 * 64;  // this warpgroup's rows of each panel

  float acc[D / 2];
  float s_acc[kBlockK / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kBlockK / 2; ++i) s_acc[i] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};  // running max of each row, base 2
  float l[2] = {0.f, 0.f};                      // this thread's part of each row's sum
  uint32_t p_op[kBlockK / 16][4];

  bar_wait(q_full, 0);
  for (int t = 0; t < kend; ++t) {
    const int s = t % kStages;
    const int k0 = t * kBlockK;
    bar_wait(&full[s], (t / kStages) & 1);
    const bf16* k_s = reinterpret_cast<const bf16*>(ring + s * L::stage);
    const bf16* v_s = k_s + kBlockK * D;

    // S = Q K^T: k16 steps along D, 64 columns to a panel
    hold(s_acc);
    mma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss<kBlockK>(s_acc, desc_k(q_wg + (kk / 4) * kBlockQ * 64 + (kk % 4) * 16),
                      desc_k(k_s + (kk / 4) * kBlockK * 64 + (kk % 4) * 16), kk > 0);
    mma_commit();
    mma_wait<0>();
    hold(s_acc);

    // online softmax in registers, in base 2: each row's reference is taken
    // over its raw scores and scaled once, and each p costs one FFMA and one
    // exp2; a tile crossing the diagonal or the end of the keys is masked
    const bool masked = k0 + kBlockK > sk ||
                        (causal && q_offset + q0 < k_offset + k0 + kBlockK - 1);
    auto hidden = [&](int i) {
      const int key = k0 + (i / 4) * 8 + col0 + (i & 1);
      return key >= sk || (causal && qid0 + 8 * ((i >> 1) & 1) < k_offset + key);
    };
    if (masked) {
#pragma unroll
      for (int i = 0; i < kBlockK / 2; ++i)
        if (hidden(i)) s_acc[i] = raw_mask;
    }
    float mx[2] = {s_acc[0], s_acc[2]};
#pragma unroll
    for (int i = 0; i < kBlockK / 2; ++i) mx[(i >> 1) & 1] = top(mx[(i >> 1) & 1], s_acc[i]);
    float ref[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = top(mx[h], __shfl_xor_sync(kFull, mx[h], 1));
      mx[h] = top(mx[h], __shfl_xor_sync(kFull, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h] * scale_log2);
      ref[h] = m_new == -CUDART_INF_F ? 0.f : m_new;
      const float alpha = m[h] == -CUDART_INF_F ? 0.f : exp2_fast(m[h] - ref[h]);
      m[h] = m_new;
      l[h] *= alpha;
#pragma unroll
      for (int i = 0; i < D / 2; ++i)
        if (((i >> 1) & 1) == h) acc[i] *= alpha;
    }
#pragma unroll
    for (int i = 0; i < kBlockK / 2; ++i) {
      float p = exp2_fast(fmaf(s_acc[i], scale_log2, -ref[(i >> 1) & 1]));
      if (masked && hidden(i)) p = 0.f;
      l[(i >> 1) & 1] += p;
      s_acc[i] = p;
    }
    to_a_operand<kBlockK>(s_acc, p_op);  // p in V's dtype

    // O += P V: k16 steps of 16 keys (2048 bytes); the next 64 columns of D
    // are the next panel
    hold(acc);
    hold(p_op);
    mma_fence();
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk)
      mma_rs<D>(acc, p_op[kk], desc_mn(v_s + kk * 16 * 64, kBlockK * 128));
    mma_commit();
    mma_wait<0>();
    hold(acc);
    hold(p_op);
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[s]);  // this warp is done with the stage
  }

  // epilogue: O / l and the LSE of each row inside Sq
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(kFull, l[h], 1);
    l[h] += __shfl_xor_sync(kFull, l[h], 2);
    const int row = q0 + row0 + 8 * h;
    if (row >= sq) continue;
    const float inv = l[h] == 0.f ? 1.f : 1.f / l[h];
    uint32_t* out = reinterpret_cast<uint32_t*>(o + (static_cast<size_t>(bh) * sq + row) * D);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      out[(8 * j + col0) / 2] = pack_bf16(acc[4 * j + 2 * h] * inv, acc[4 * j + 2 * h + 1] * inv);
    if (lane % 4 == 0)
      lse[static_cast<size_t>(bh) * sq + row] =
          l[h] == 0.f ? -CUDART_INF_F : m[h] * kLn2 + logf(l[h]);
  }
}

template <int D, bool kNegScale>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse, int bh, int sq,
                 int sk, int q_offset, int k_offset, int causal, int walk_cut, float scale,
                 cudaStream_t stream) {
  using L = FwdTiles<D>;
  static const cudaError_t attr = allow_smem(flash_fwd_wgmma_kernel<D, kNegScale>, L::total);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap maps[3];
  int rc = hopper::make_map(&maps[0], q, bh, sq, D, L::kBlockQ);
  if (rc == 0) rc = hopper::make_map(&maps[1], k, bh, sk, D, kBlockK);
  if (rc == 0) rc = hopper::make_map(&maps[2], v, bh, sk, D, kBlockK);
  if (rc != 0) return rc;
  const dim3 grid(tiles_of(sq, L::kBlockQ), bh);
  flash_fwd_wgmma_kernel<D, kNegScale><<<grid, L::kThreads, L::total, stream>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(o), lse, sq, sk, q_offset, k_offset,
      causal, walk_cut, scale);
  return 0;
}

// f32 (dtype 0) runs the CUDA-core kernel, bf16 (dtype 1) the wgmma one
template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, void* o, float* lse, int bh,
           int sq, int sk, int q_offset, int k_offset, int causal, int walk_cut, float scale,
           cudaStream_t stream) {
  if (dtype == 0)
    return launch_f32<D>(q, k, v, o, lse, bh, sq, sk, q_offset, k_offset, causal, walk_cut,
                         scale, stream);
  if (dtype == 1 && scale < 0.f)
    return launch_wgmma<D, true>(q, k, v, o, lse, bh, sq, sk, q_offset, k_offset, causal,
                                 walk_cut, scale, stream);
  if (dtype == 1)
    return launch_wgmma<D, false>(q, k, v, o, lse, bh, sq, sk, q_offset, k_offset, causal,
                                  walk_cut, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int D>
int resources_of(int dtype, int* out) {
  using F = FwdSmem<D>;
  if (dtype == 0) return resources(flash_fwd_kernel<D>, F::kWarps * 32, F::total, out);
  if (dtype == 1)
    return resources(flash_fwd_wgmma_kernel<D, false>, FwdTiles<D>::kThreads, FwdTiles<D>::total,
                     out);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. walk_cut: kv tiles cut from the end of
// each walk, 0 in use (1 plants a fault that a check must see). Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a shape or dtype the kernel does not take.
// Launches on `stream`, does not synchronise.
int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int sq,
              int sk, int head_dim, int q_offset, int k_offset, int causal, int walk_cut,
              float scale, int dtype, void* stream) {
  if (bh <= 0 || sq <= 0 || sk <= 0 || walk_cut < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // start from a clean error state
  auto s = static_cast<cudaStream_t>(stream);
  auto* lse_f = static_cast<float*>(lse);
  int rc;
  if (head_dim == 64)
    rc = launch<64>(dtype, q, k, v, o, lse_f, bh, sq, sk, q_offset, k_offset, causal, walk_cut,
                    scale, s);
  else if (head_dim == 128)
    rc = launch<128>(dtype, q, k, v, o, lse_f, bh, sq, sk, q_offset, k_offset, causal, walk_cut,
                     scale, s);
  else
    rc = static_cast<int>(cudaErrorInvalidValue);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// What the kernel for (head_dim, dtype) holds on the card, into out[5]:
// registers per thread at launch, shared memory per CTA, CTAs per SM,
// threads per CTA, spilled bytes per thread. Returns 0 or a CUDA error.
int flash_fwd_resources(int head_dim, int dtype, int* out) {
  if (head_dim == 64) return resources_of<64>(dtype, out);
  if (head_dim == 128) return resources_of<128>(dtype, out);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
