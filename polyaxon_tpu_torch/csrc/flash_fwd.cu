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
// f32 (flash_fwd_tf32_kernel): the same structure with split-TF32 products
// (hopper.cuh): each product runs as three tf32 wgmma products, A_hi B_lo +
// A_lo B_hi + A_hi B_hi, which keeps it within ~2^-22 of f32. At 3 x 2 Sq Sk
// D FLOP over 495 TFLOP/s its bound is 0.208 ms at the llama-1b shape in
// f32 (0.417 ms at D = 128). A split pass first writes Q in three parts
// (hi, lo and the rest, x - hi - lo), K as hi and lo and V as V^T hi and lo
// into a workspace (tf32 wgmma reads shared memory only K-major, and P V
// reduces over V's rows), with each group of 8 keys of V^T in the order in
// which P's accumulator feeds the register A operand (key_of), so that P
// needs no shuffle. The scores take Q in three parts, as the backward's do
// (a fourth product, Q_rest K_hi), and keep Q_hi K_hi in an accumulator of
// their own, added once: hi + lo misses q by up to a place of q, and where
// far keys take scores in the hundreds and tie, that miss moves P's split
// between them past f32's rounding. A CTA holds two consumer warpgroups of
// 64 q rows at D = 64 (one at D = 128) and streams 64-key tiles (32 at
// D = 128) of K hi, K lo, V^T hi and V^T lo, 64 KB a stage, through two
// stages, beside the three Q parts: 225 KiB of shared memory, one CTA to an
// SM. P is split into hi and lo in registers. Every other rule (the base-2
// softmax, the masks, the walk, the scale's sign) is the bf16 kernel's.

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;

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

// ---- f32: split-TF32 wgmma, TMA, accumulators in registers --------------------

template <int D>
struct FwdTilesF32 {
  // consumer warpgroups of 64 q rows per CTA: two at D = 64, one at D = 128;
  // keys per kv tile: 64 at D = 64, 32 at D = 128 (a stage is 64 KB either
  // way, and the CTA takes one SM)
  static constexpr int kConsumers = D == 64 ? 2 : 1;
  static constexpr int kBlockQ = 64 * kConsumers;
  static constexpr int kBlockK = 4096 / D;
  static constexpr int kThreads = (kConsumers + 1) * 128;
  static constexpr uint32_t q = kBlockQ * D * 4;   // one of Q hi, Q lo, Q rest
  static constexpr uint32_t kv = kBlockK * D * 4;  // one of K hi, K lo, V^T hi, V^T lo
  static constexpr uint32_t stage = 4 * kv;
  // tiles, then the barriers (Q, full and empty per stage), plus the room
  // to align the start to 1024 bytes
  static constexpr size_t total = 3 * q + kStages * stage + 8 * (1 + 2 * kStages) + 1024;
};

// the workspace of the split pass, in floats: Q [3, bh, sq, D] (hi, lo, the
// rest), K [2, bh, sk, D] (hi, then lo) and V^T [2, bh, D, sk rounded up to 8]
inline size_t f32_workspace_floats(int bh, int sq, int sk, int d) {
  return static_cast<size_t>(bh) * d * (3 * static_cast<size_t>(sq) + 2 * sk + 2 * ((sk + 7) / 8 * 8));
}

template <int D, bool kNegScale>
__global__ void __launch_bounds__(FwdTilesF32<D>::kThreads, 1)
flash_fwd_tf32_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap vt_map, float* __restrict__ o,
                      float* __restrict__ lse, int sq, int sk, int q_offset, int k_offset,
                      int causal, int walk_cut, float scale) {
  using namespace hopper;
  using L = FwdTilesF32<D>;
  constexpr int kConsumers = L::kConsumers;
  constexpr int kBlockQ = L::kBlockQ;
  constexpr int kBlockK = L::kBlockK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  float* q_hi = reinterpret_cast<float*>(smem);
  float* q_lo = q_hi + kBlockQ * D;
  float* q_rest = q_lo + kBlockQ * D;
  unsigned char* ring = smem + 3 * L::q;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + kStages * L::stage);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;
  // stage s: K hi, K lo, V^T hi, V^T lo
  auto tile_of = [&](int s, int i) {
    return reinterpret_cast<float*>(ring + s * L::stage + i * L::kv);
  };

  const int bh = blockIdx.y;
  const int nbh = gridDim.y;  // part i of head bh is head bh + i nbh of each map
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
      bar_arrive_expect_tx(q_full, 3 * L::q);
      tma_panels<D / 32, kBlockQ>(q_hi, &q_map, q_full, 0, q0, bh);
      tma_panels<D / 32, kBlockQ>(q_lo, &q_map, q_full, 0, q0, bh + nbh);
      tma_panels<D / 32, kBlockQ>(q_rest, &q_map, q_full, 0, q0, bh + 2 * nbh);
      for (int t = 0; t < kend; ++t) {
        const int s = t % kStages;
        const int k0 = t * kBlockK;
        bar_wait(&empty[s], ((t / kStages) & 1) ^ 1);  // the first round finds it free
        bar_arrive_expect_tx(&full[s], L::stage);
        tma_panels<D / 32, kBlockK>(tile_of(s, 0), &k_map, &full[s], 0, k0, bh);
        tma_panels<D / 32, kBlockK>(tile_of(s, 1), &k_map, &full[s], 0, k0, bh + nbh);
        tma_panels<kBlockK / 32, D>(tile_of(s, 2), &vt_map, &full[s], k0, 0, bh);
        tma_panels<kBlockK / 32, D>(tile_of(s, 3), &vt_map, &full[s], k0, 0, bh + nbh);
      }
    }
    return;
  }

  // consumer warpgroup wg: q rows wg * 64 .. + 63 of the tile
  regs_inc<240>();
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int row0 = wg * 64 + (tid / 32) * 16 + lane / 4;  // this thread's rows: row0, row0 + 8
  const int col0 = 2 * (lane % 4);                         // and columns col0, col0 + 1 of each 8
  const int qid0 = q_offset + q0 + row0;
  const float scale_log2 = scale * kLog2e;
  // as in the bf16 kernel: a row's reference is its largest raw score times
  // the scale, or its smallest when scale < 0
  constexpr float raw_mask = kNegScale ? -kMaskValue : kMaskValue;
  auto top = [](float a, float b) { return kNegScale ? fminf(a, b) : fmaxf(a, b); };
  const float* qh = q_hi + wg * 64 * 32;  // this warpgroup's rows of each panel
  const float* ql = q_lo + wg * 64 * 32;
  const float* qr = q_rest + wg * 64 * 32;

  float acc[D / 2];
  float s_acc[kBlockK / 2], s_rest[kBlockK / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kBlockK / 2; ++i) s_acc[i] = s_rest[i] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};  // running max of each row, base 2
  float l[2] = {0.f, 0.f};                      // this thread's part of each row's sum
  uint32_t p_hi[kBlockK / 8][4], p_lo[kBlockK / 8][4];

  bar_wait(q_full, 0);
  for (int t = 0; t < kend; ++t) {
    const int s = t % kStages;
    const int k0 = t * kBlockK;
    bar_wait(&full[s], (t / kStages) & 1);
    const float* kh = tile_of(s, 0);
    const float* kl = tile_of(s, 1);
    const float* vh = tile_of(s, 2);
    const float* vl = tile_of(s, 3);

    // S = Q K^T in four products per k8 step along D (32 columns to a
    // panel): Q_hi K_hi^T into s_acc, Q_rest K_hi^T + Q_lo K_hi^T + Q_hi
    // K_lo^T into s_rest, added once
    hold(s_acc);
    hold(s_rest);
    mma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const int a = (kk / 4) * kBlockQ * 32 + (kk % 4) * 8;
      const int b = (kk / 4) * kBlockK * 32 + (kk % 4) * 8;
      mma_ss_tf32<kBlockK>(s_rest, desc_k(qr + a), desc_k(kh + b), kk > 0);
      mma_ss_tf32<kBlockK>(s_rest, desc_k(ql + a), desc_k(kh + b), 1);
      mma_ss_tf32<kBlockK>(s_rest, desc_k(qh + a), desc_k(kl + b), 1);
      mma_ss_tf32<kBlockK>(s_acc, desc_k(qh + a), desc_k(kh + b), kk > 0);
    }
    mma_commit();
    mma_wait<0>();
    hold(s_acc);
    hold(s_rest);
#pragma unroll
    for (int i = 0; i < kBlockK / 2; ++i) s_acc[i] += s_rest[i];

    // the online softmax in registers, in base 2, as in the bf16 kernel
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
    to_a_tf32<kBlockK>(s_acc, p_hi, p_lo);

    // O += P V: three products per k8 step of 8 keys, V^T read K-major (its
    // keys stored in key_of order by the split pass)
    hold(acc);
    hold(p_hi);
    hold(p_lo);
    mma_fence();
#pragma unroll
    for (int kk = 0; kk < kBlockK / 8; ++kk) {
      const int b = (kk / 4) * D * 32 + (kk % 4) * 8;
      mma_rs_tf32<D>(acc, p_lo[kk], desc_k(vh + b));
      mma_rs_tf32<D>(acc, p_hi[kk], desc_k(vl + b));
      mma_rs_tf32<D>(acc, p_hi[kk], desc_k(vh + b));
    }
    mma_commit();
    mma_wait<0>();
    hold(acc);
    hold(p_hi);
    hold(p_lo);
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
    float2* out = reinterpret_cast<float2*>(o + (static_cast<size_t>(bh) * sq + row) * D);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      out[(8 * j + col0) / 2] = make_float2(acc[4 * j + 2 * h] * inv, acc[4 * j + 2 * h + 1] * inv);
    if (lane % 4 == 0)
      lse[static_cast<size_t>(bh) * sq + row] =
          l[h] == 0.f ? -CUDART_INF_F : m[h] * kLn2 + logf(l[h]);
  }
}

// The split pass (Q into hi, lo and the rest, K into hi and lo, V into V^T
// hi and lo), then the kernel over its output.
template <int D, bool kNegScale>
int launch_tf32(const void* q, const void* k, const void* v, void* o, float* lse, float* ws,
                int bh, int sq, int sk, int q_offset, int k_offset, int causal, int walk_cut,
                float scale, cudaStream_t stream) {
  using L = FwdTilesF32<D>;
  static const cudaError_t attr = allow_smem(flash_fwd_tf32_kernel<D, kNegScale>, L::total);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int sk8 = (sk + 7) / 8 * 8;
  float* q_s = ws;
  float* k_s = q_s + 3 * static_cast<size_t>(bh) * sq * D;
  float* vt_s = k_s + 2 * static_cast<size_t>(bh) * sk * D;
  hopper::split_tf32_launch(q, q_s, static_cast<size_t>(bh) * sq * D, 3, stream);
  hopper::split_tf32_launch(k, k_s, static_cast<size_t>(bh) * sk * D, 2, stream);
  hopper::split_tf32_t_kernel<<<dim3(tiles_of(sk8, 32), D / 32, bh), dim3(32, 8), 0, stream>>>(
      static_cast<const float*>(v), vt_s, vt_s + static_cast<size_t>(bh) * D * sk8, sk, sk8, D);
  CUtensorMap maps[3];
  int rc = hopper::make_map_f32(&maps[0], q_s, 3 * bh, sq, D, L::kBlockQ);
  if (rc == 0) rc = hopper::make_map_f32(&maps[1], k_s, 2 * bh, sk, D, L::kBlockK);
  if (rc == 0) rc = hopper::make_map_f32(&maps[2], vt_s, 2 * bh, D, sk8, D);
  if (rc != 0) return rc;
  const dim3 grid(tiles_of(sq, L::kBlockQ), bh);
  flash_fwd_tf32_kernel<D, kNegScale><<<grid, L::kThreads, L::total, stream>>>(
      maps[0], maps[1], maps[2], static_cast<float*>(o), lse, sq, sk, q_offset, k_offset, causal,
      walk_cut, scale);
  return 0;
}

// f32 (dtype 0) runs the split-TF32 kernel, bf16 (dtype 1) the bf16 one, each
// instantiated for the sign of the scale
template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, void* o, float* lse, float* ws,
           int bh, int sq, int sk, int q_offset, int k_offset, int causal, int walk_cut,
           float scale, cudaStream_t stream) {
  if (dtype == 0 && scale < 0.f)
    return launch_tf32<D, true>(q, k, v, o, lse, ws, bh, sq, sk, q_offset, k_offset, causal,
                                walk_cut, scale, stream);
  if (dtype == 0)
    return launch_tf32<D, false>(q, k, v, o, lse, ws, bh, sq, sk, q_offset, k_offset, causal,
                                 walk_cut, scale, stream);
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
  if (dtype == 0)
    return resources(flash_fwd_tf32_kernel<D, false>, FwdTilesF32<D>::kThreads,
                     FwdTilesF32<D>::total, out);
  if (dtype == 1)
    return resources(flash_fwd_wgmma_kernel<D, false>, FwdTiles<D>::kThreads, FwdTiles<D>::total,
                     out);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. workspace: flash_fwd_workspace() bytes
// for the split pass (f32), 16-byte aligned, or null where that is 0.
// walk_cut: kv tiles cut from the end of each walk, 0 in use (1 plants a
// fault that a check must see). Returns cudaGetLastError() after the launch
// (0 on success), or cudaErrorInvalidValue for a shape or dtype the kernel
// does not take. Launches on `stream`, does not synchronise.
int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, void* workspace,
              int bh, int sq, int sk, int head_dim, int q_offset, int k_offset, int causal,
              int walk_cut, float scale, int dtype, void* stream) {
  if (bh <= 0 || sq <= 0 || sk <= 0 || walk_cut < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // start from a clean error state
  auto s = static_cast<cudaStream_t>(stream);
  auto* lse_f = static_cast<float*>(lse);
  auto* ws = static_cast<float*>(workspace);
  int rc;
  if (head_dim == 64)
    rc = launch<64>(dtype, q, k, v, o, lse_f, ws, bh, sq, sk, q_offset, k_offset, causal,
                    walk_cut, scale, s);
  else if (head_dim == 128)
    rc = launch<128>(dtype, q, k, v, o, lse_f, ws, bh, sq, sk, q_offset, k_offset, causal,
                     walk_cut, scale, s);
  else
    rc = static_cast<int>(cudaErrorInvalidValue);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// Bytes of workspace flash_fwd needs for these shapes (0 in bf16).
size_t flash_fwd_workspace(int bh, int sq, int sk, int head_dim, int dtype) {
  if (dtype != 0 || bh <= 0 || sq <= 0 || sk <= 0) return 0;
  return f32_workspace_floats(bh, sq, sk, head_dim) * sizeof(float);
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
