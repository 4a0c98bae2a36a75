// Flash-attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Two kernels, replacing the TPU kernels of polyaxon_tpu/ops/flash_attention.py
// launched by _flash_bwd:
//
// - dQ   <- _bwd_dq_kernel:  dQ = sum_j dS K
//   (bf16: flash_bwd_dq_wgmma_kernel; f32: flash_bwd_dq_tf32_kernel)
// - dK/dV <- _bwd_dkv_kernel: dV = sum_i P^T dO, dK = sum_i dS^T Q
//   (bf16: flash_bwd_dkv_wgmma_kernel; f32: flash_bwd_dkv_tf32_kernel)
//
// with, for each visible (i, j),
//   P  = exp(q_i . k_j * scale - LSE_i)   (0 where LSE_i = -inf or hidden)
//   dS = P * (dO_i . v_j - delta_i) * scale
// where delta = rowsum(dO * O) comes in precomputed (bwd_row_stats). Scores,
// P and dS are f32; dS is rounded to K's dtype before dS K and to Q's before
// dS^T Q, P to dO's dtype before P^T dO; the sums are f32 and the outputs are
// written in the input dtype. These are the TPU kernels' rules.
//
//   q, do [BH, Sq, D]; k, v [BH, Sk, D]; lse, delta [BH, Sq] f32;
//   dq [BH, Sq, D]; dk, dv [BH, Sk, D]; D = 64 or 128; bf16 or f32; any Sq, Sk.
//
// As in the forward, a loop inside the CTA replaces the TPU's sequential
// grid axis, and its bounds are the causal clamps: the dQ CTA of a q tile
// walks kv tiles up to the last visible one (_kv_clamp); the dK/dV CTA of a
// kv tile walks q tiles from the first that can see it (_q_clamp) to the
// end, and the heaviest CTAs launch first. A length that is no multiple of
// the tile ends in a partial tile: its missing q/dO/K/V rows are loaded as
// zeros, missing keys are hidden like masked ones, missing query rows get
// LSE = -inf (so P = 0 there), and missing rows are not written.
//
// Bound on the H100. dQ does 3 products (S, dO V^T, dS K) and dK/dV 4 (S,
// dO V^T, P^T dO, dS^T Q), each 2 * Sq * Sk * D FLOP before the causal half:
// at the llama-1b shape (BH 64, S 2048, D 64, bf16) 52.1 us and 69.5 us at
// 989 TFLOP/s, above their byte bounds, so the tensor cores bound both.
//
// Both bf16 kernels are built for that bound from Hopper's pieces
// (hopper.cuh): a producer warp streams tiles by TMA into a ring of two
// stages guarded by mbarriers and gives its registers to the consumer
// warpgroups (setmaxnreg); each consumer warpgroup computes its two score
// products by wgmma from shared memory into registers, forms P and dS there
// in the layout of wgmma's register A operand, and adds its last products by
// wgmma with A in registers, into accumulators that stay in registers for
// the whole walk.
//
// dQ in bf16 (flash_bwd_dq_wgmma_kernel) is the forward's structure with one
// more product and no online softmax. A CTA takes 64 q rows: one consumer
// warpgroup, whose Q and dO rows are loaded once by TMA and stay in shared
// memory, and whose rows' LSE (in base 2) and delta are read once into
// registers; two CTAs share an SM. The producer streams K/V tiles (128 keys
// at D = 64, 64 at D = 128, which keeps the S, dP and dQ accumulators within
// the registers) by TMA. Per tile, S = Q K^T and dP = dO V^T by wgmma (both
// operands K-major, committed as two groups, so that P = exp2(S scale
// log2(e) - LSE), with the causal / past-the-end mask, is computed while dP
// is still in flight), dS in registers, rounded to bf16, and dQ += dS K by
// wgmma with K read MN-major. Shared memory: 83 KB at D = 64, 99 KB at
// D = 128.
//
// dK/dV in bf16 (flash_bwd_dkv_wgmma_kernel): a CTA takes 128 keys, two
// consumer warpgroups of 64 keys each, whose K and V rows stay in shared
// memory for the whole walk, while the producer streams 64-row Q and dO
// tiles, with their LSE (in base 2) and delta, through the ring. Each
// consumer computes S^T = K Q^T and dP^T = V dO^T with keys as rows, so that
// P^T and dS^T come out in the layout of the register A operand (LSE and
// delta read per column from the stage); dV += P^T dO and dK += dS^T Q read
// dO and Q MN-major from the stage. Shared memory: 67 KB at D = 64, 131 KB
// at D = 128.
//
// The f32 kernels (flash_bwd_dkv_tf32_kernel, flash_bwd_dq_tf32_kernel) keep
// the bf16 kernels' rules and the shape of their walks, with split-TF32
// products (hopper.cuh:
// A_hi B_lo + A_lo B_hi + A_hi B_hi, within ~2^-22 of f32), bound at 3
// passes per product over 495 TFLOP/s: dK/dV (4 products) 0.417 ms at the
// llama-1b shape in f32 and 0.833 ms at D = 128, dQ (3 products) 0.3125 and
// 0.625 ms. Each launch first runs the same split pass, which writes Q in
// three parts (hi, lo and the rest, x - hi - lo), dO, K and V in two (hi
// and lo) into a workspace the wrapper allocates. Scores take Q in three
// parts (a fourth product, Q_rest K_hi) and keep Q_hi K_hi in an
// accumulator of their own, added once: P = exp(s scale - LSE) with an LSE
// from outside turns a score's error times |s scale| (hundreds) into P's
// relative error, and s scale - LSE is taken in natural units, as the plain
// version takes it. The products that reduce over the streamed dimension
// (dV = P^T dO and dK = dS^T Q over q rows, dQ = dS K over keys) would need
// their B operand stored transposed for tf32 wgmma, which reads shared
// memory only K-major; a transposed copy beside the tiles does not fit in
// shared memory at D = 128, so they run on mma.sync m16n8k8, each warp its
// 16 rows of the output, with A (P, dS) from the accumulators through
// to_a_tf32 and the B elements loaded from the swizzled tiles. Each tile's
// products are summed apart before they join the running sums: the tensor
// cores' sums truncate, and over a whole walk into one accumulator that
// bias grows with the number of products.
//
// dK/dV in f32: a CTA takes 64 keys, whose K and V hi and lo stay in shared
// memory for the whole walk (64 KB at D = 64, 128 KB at D = 128), while the
// producer streams the Q and dO parts, with their LSE and delta, through a
// ring of 32-row stages (16 rows at D = 128; four stages at D = 64, two at
// D = 128): 226 KiB of shared memory at D = 64, 209 KiB at D = 128, one CTA
// to an SM. Two consumer warpgroups take the q tiles in turn, each summing
// dK and dV for all 64 keys over its half of the walk; at the end one adds
// its sums into the other's through shared memory. S^T = K Q^T and dP^T =
// V dO^T are tf32 wgmma products (K-major on both sides); P^T and dS^T stay
// in registers.
//
// dQ in f32 mirrors it: a CTA takes 64 q rows, whose Q parts and dO hi and
// lo stay in shared memory for the whole walk (80 KB at D = 64, 160 KB at
// D = 128), and the rows' LSE and delta are read once into registers, while
// the producer streams K and V hi and lo through a ring of 32-key stages
// (16 keys at D = 128; four stages at D = 64, two at D = 128): 209 KiB of
// shared memory at D = 64, 225 KiB at D = 128, one CTA to an SM. Two
// consumer warpgroups take the kv tiles in turn, each summing dQ for all 64
// rows over its half of the walk, and one adds its sums into the other's at
// the end. S = Q K^T and dP = dO V^T are tf32 wgmma products, committed as
// two groups so that P is formed while dP is in flight; dQ += dS K runs on
// mma.sync, reading K hi and lo from the stage. dP's dO_hi V_hi^T runs in
// four chains, each from zero into an accumulator of its own, added to
// nearest: dS = P (dP - delta) scale cancels where P is near 1, and along
// one accumulator the wgmma sums' truncation would leave dP less accurate
// than an f32 sum.

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;

// ---- dK/dV in bf16: wgmma, TMA, accumulators in registers ---------------------

constexpr int kKeys = 128;      // keys per CTA: 64 per consumer warpgroup
constexpr int kRowsQ = 64;      // q rows per streamed tile
constexpr int kStages = 2;      // tiles in flight (q tiles here, kv tiles in dQ)
constexpr int kConsumers = 2;   // warpgroups
constexpr int kThreadsWG = (kConsumers + 1) * 128;

template <int D>
struct DkvTiles {
  static constexpr uint32_t kv = hopper::tile_bytes<D, kKeys>();   // one of K, V
  static constexpr uint32_t q = hopper::tile_bytes<D, kRowsQ>();   // one of Q, dO
  static constexpr uint32_t stats = 2 * kRowsQ * sizeof(float);     // LSE, delta
  static constexpr uint32_t stage = (2 * q + stats + 1023) / 1024 * 1024;
  // tiles, then the barriers (K/V, full and empty per stage), plus the
  // room to align the start to 1024 bytes
  static constexpr size_t total = 2 * kv + kStages * stage + 8 * (1 + 2 * kStages) + 1024;
};

template <int D>
__global__ void __launch_bounds__(kThreadsWG, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           const __grid_constant__ CUtensorMap do_map,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                           int sq, int sk, int q_offset, int k_offset, int causal, int walk_cut,
                           float scale) {
  using namespace hopper;
  using L = DkvTiles<D>;
  using bf16 = __nv_bfloat16;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  bf16* k_s = reinterpret_cast<bf16*>(smem);
  bf16* v_s = reinterpret_cast<bf16*>(smem + L::kv);
  unsigned char* ring = smem + 2 * L::kv;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(ring + kStages * L::stage);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;
  // stage s: Q, dO, then LSE * log2(e) and delta of its rows
  auto q_of = [&](int s) { return reinterpret_cast<bf16*>(ring + s * L::stage); };
  auto do_of = [&](int s) { return reinterpret_cast<bf16*>(ring + s * L::stage + L::q); };
  auto lse_of = [&](int s) { return reinterpret_cast<float*>(ring + s * L::stage + 2 * L::q); };
  auto delta_of = [&](int s) { return lse_of(s) + kRowsQ; };

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kKeys;  // the first kv tiles see the most q tiles
  const int first = q_tiles_begin(k0, kRowsQ, q_offset, k_offset, causal, walk_cut);
  const int nq = tiles_of(sq, kRowsQ);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    bar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      bar_init(&full[s], 32);               // every producer lane writes LSE/delta
      bar_init(&empty[s], kConsumers * 4);  // one arrival per consumer warp
    }
    fence_bar_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // producer: the first warp; lane 0 issues the TMA loads, every lane
    // writes two rows' LSE and delta
    regs_dec<24>();
    const int lane = threadIdx.x % 32;
    if (threadIdx.x - kConsumers * 128 < 32) {
      if (lane == 0) {
        bar_arrive_expect_tx(kv_full, 2 * L::kv);
        tma_tile<D, kKeys>(k_s, &k_map, kv_full, k0, bh);
        tma_tile<D, kKeys>(v_s, &v_map, kv_full, k0, bh);
      }
      for (int t = first; t < nq; ++t) {
        const int i = t - first;
        const int s = i % kStages;
        bar_wait(&empty[s], ((i / kStages) & 1) ^ 1);  // the first round finds it free
        const int q0 = t * kRowsQ;
        if (lane == 0) {
          bar_expect_tx(&full[s], 2 * L::q);
          tma_tile<D, kRowsQ>(q_of(s), &q_map, &full[s], q0, bh);
          tma_tile<D, kRowsQ>(do_of(s), &do_map, &full[s], q0, bh);
        }
        for (int r = lane; r < kRowsQ; r += 32) {
          const bool in = q0 + r < sq;
          const size_t at = static_cast<size_t>(bh) * sq + q0 + r;
          // a row that sees no key (LSE = -inf) or lies past the end gets
          // +inf, so that its P = exp2(s - inf) is 0 with no test per score
          const float x = in ? lse[at] : -CUDART_INF_F;
          lse_of(s)[r] = x == -CUDART_INF_F ? CUDART_INF_F : x * kLog2e;
          delta_of(s)[r] = in ? delta[at] : 0.f;
        }
        bar_arrive(&full[s]);
      }
    }
    return;
  }

  // consumer warpgroup wg: keys wg * 64 .. + 63 of the tile
  regs_inc<240>();
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int row0 = wg * 64 + (tid / 32) * 16 + lane / 4;  // this thread's keys: row0, row0 + 8
  const int col0 = 2 * (lane % 4);                         // and q columns col0, col0 + 1 of each 8
  const int kid0 = k_offset + k0 + row0;
  const float scale_log2 = scale * kLog2e;
  const bf16* k_wg = k_s + wg * 64 * 64;  // this warpgroup's rows of each panel
  const bf16* v_wg = v_s + wg * 64 * 64;

  float dk_acc[D / 2], dv_acc[D / 2];
  float st[kRowsQ / 2], dpt[kRowsQ / 2];  // S^T, dP^T; then P^T, dS^T
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kRowsQ / 2; ++i) st[i] = dpt[i] = 0.f;
  uint32_t p_op[kRowsQ / 16][4], ds_op[kRowsQ / 16][4];

  bar_wait(kv_full, 0);
  for (int t = first; t < nq; ++t) {
    const int i = t - first;
    const int s = i % kStages;
    const int q0 = t * kRowsQ;
    bar_wait(&full[s], (i / kStages) & 1);
    const bf16* q_st = q_of(s);
    const bf16* do_st = do_of(s);
    const float* lse_st = lse_of(s);
    const float* delta_st = delta_of(s);

    // S^T = K Q^T and dP^T = V dO^T: k16 steps along D, 64 columns to a panel
    hold(st);
    hold(dpt);
    mma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int a = (kk / 4) * kKeys * 64 + (kk % 4) * 16;
      const int b = (kk / 4) * kRowsQ * 64 + (kk % 4) * 16;
      mma_ss<kRowsQ>(st, desc_k(k_wg + a), desc_k(q_st + b), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int a = (kk / 4) * kKeys * 64 + (kk % 4) * 16;
      const int b = (kk / 4) * kRowsQ * 64 + (kk % 4) * 16;
      mma_ss<kRowsQ>(dpt, desc_k(v_wg + a), desc_k(do_st + b), kk > 0);
    }
    mma_commit();
    mma_wait<0>();
    hold(st);
    hold(dpt);

    // P^T and dS^T: column c is q row q0 + c; a tile whose first row lies
    // before this CTA's last key is masked
    const bool masked = causal && q_offset + q0 < k_offset + k0 + kKeys - 1;
#pragma unroll
    for (int j = 0; j < kRowsQ / 8; ++j) {
      const int c = 8 * j + col0;
      const float2 lse2 = *reinterpret_cast<const float2*>(lse_st + c);
      const float2 dl = *reinterpret_cast<const float2*>(delta_st + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int idx = 4 * j + e;
        const float lse_c = (e & 1) ? lse2.y : lse2.x;
        const float delta_c = (e & 1) ? dl.y : dl.x;
        float p = exp2_fast(fmaf(st[idx], scale_log2, -lse_c));
        if (masked && q_offset + q0 + c + (e & 1) < kid0 + 8 * (e >> 1)) p = 0.f;
        st[idx] = p;
        dpt[idx] = p * (dpt[idx] - delta_c) * scale;
      }
    }
    to_a_operand<kRowsQ>(st, p_op);    // P^T in dO's dtype
    to_a_operand<kRowsQ>(dpt, ds_op);  // dS^T in Q's dtype

    // dV += P^T dO, dK += dS^T Q: k16 steps of 16 q rows (2048 bytes); the
    // next 64 columns of D are the next panel
    hold(dv_acc);
    hold(dk_acc);
    hold(p_op);
    hold(ds_op);
    mma_fence();
#pragma unroll
    for (int kk = 0; kk < kRowsQ / 16; ++kk)
      mma_rs<D>(dv_acc, p_op[kk], desc_mn(do_st + kk * 16 * 64, kRowsQ * 128));
#pragma unroll
    for (int kk = 0; kk < kRowsQ / 16; ++kk)
      mma_rs<D>(dk_acc, ds_op[kk], desc_mn(q_st + kk * 16 * 64, kRowsQ * 128));
    mma_commit();
    mma_wait<0>();
    hold(dv_acc);
    hold(dk_acc);
    hold(p_op);
    hold(ds_op);
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[s]);  // this warp is done with the stage
  }

  // epilogue: the rows of keys inside Sk
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + row0 + 8 * h;
    if (key >= sk) continue;
    const size_t at = (static_cast<size_t>(bh) * sk + key) * D;
    uint32_t* dk_row = reinterpret_cast<uint32_t*>(dk + at);
    uint32_t* dv_row = reinterpret_cast<uint32_t*>(dv + at);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      dk_row[4 * j + lane % 4] = pack_bf16(dk_acc[4 * j + 2 * h], dk_acc[4 * j + 2 * h + 1]);
      dv_row[4 * j + lane % 4] = pack_bf16(dv_acc[4 * j + 2 * h], dv_acc[4 * j + 2 * h + 1]);
    }
  }
}

// ---- dK/dV in f32: split-TF32 wgmma and mma.sync, TMA, registers ---------------

template <int D>
struct DkvTilesF32 {
  static constexpr int kKeys = 64;          // both consumer warpgroups' keys
  static constexpr int kThreads = 3 * 128;  // two consumer warpgroups and the producer
  static constexpr int kRows = 2048 / D;    // q rows per streamed tile: 32, or 16 at D = 128
  static constexpr int kStages = D == 64 ? 4 : 2;
  static constexpr uint32_t kv = kKeys * D * 4;  // one of K hi, K lo, V hi, V lo
  static constexpr uint32_t q = kRows * D * 4;   // one of Q hi, lo, rest; dO hi, lo
  static constexpr uint32_t stage = 5 * q;
  static constexpr uint32_t stats = 2 * kRows * sizeof(float);  // LSE, delta of a stage
  // K/V, the stages, their LSE and delta, the barriers (K/V, full and empty
  // per stage), plus the room to align the start to 1024 bytes
  static constexpr size_t total =
      4 * kv + kStages * (stage + stats) + 8 * (1 + 2 * kStages) + 1024;
};

// both consumer warpgroups (256 threads) meet here (named barrier 1)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// the workspace of the split pass of both f32 kernels, in floats: Q [3, bh,
// sq, D] (hi, lo, rest), dO [2, bh, sq, D] and K, V [2, bh, sk, D] (hi, lo)
inline size_t bwd_workspace_floats(int bh, int sq, int sk, int d) {
  return static_cast<size_t>(bh) * d * (5 * static_cast<size_t>(sq) + 4 * sk);
}

template <int D>
__global__ void __launch_bounds__(DkvTilesF32<D>::kThreads, 1)
flash_bwd_dkv_tf32_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap do_map,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv, int sq, int sk,
                          int q_offset, int k_offset, int causal, int walk_cut, float scale) {
  using namespace hopper;
  using L = DkvTilesF32<D>;
  constexpr int kKeys = L::kKeys;
  constexpr int kRows = L::kRows;
  constexpr int kStages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  // K hi, K lo, V hi, V lo, for the whole walk
  auto kv_of = [&](int i) { return reinterpret_cast<float*>(smem + i * L::kv); };
  unsigned char* ring = smem + 4 * L::kv;
  // stage s: Q hi, Q lo, Q rest, dO hi, dO lo; then each stage's LSE and
  // delta, and the barriers
  auto tile_of = [&](int s, int i) {
    return reinterpret_cast<float*>(ring + s * L::stage + i * L::q);
  };
  float* stats = reinterpret_cast<float*>(ring + kStages * L::stage);
  auto lse_of = [&](int s) { return stats + s * 2 * kRows; };
  auto delta_of = [&](int s) { return stats + s * 2 * kRows + kRows; };
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(stats + kStages * 2 * kRows);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  const int bh = blockIdx.y;
  const int nbh = gridDim.y;  // part i of head bh is head bh + i nbh of each map
  const int k0 = blockIdx.x * kKeys;  // the first kv tiles see the most q tiles
  const int first = q_tiles_begin(k0, kRows, q_offset, k_offset, causal, walk_cut);
  const int nq = tiles_of(sq, kRows);

  if (threadIdx.x == 0) {
    bar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      bar_init(&full[s], 32);  // every producer lane writes LSE/delta
      bar_init(&empty[s], 4);  // one arrival per warp of the warpgroup that takes it
    }
    fence_bar_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // producer: the first warp; lane 0 issues the TMA loads, the lanes
    // write the rows' LSE and delta
    regs_dec<24>();
    const int lane = threadIdx.x % 32;
    if (threadIdx.x < 288) {
      if (lane == 0) {
        bar_arrive_expect_tx(kv_full, 4 * L::kv);
        for (int i = 0; i < 2; ++i) {
          tma_panels<D / 32, kKeys>(kv_of(i), &k_map, kv_full, 0, k0, bh + i * nbh);
          tma_panels<D / 32, kKeys>(kv_of(2 + i), &v_map, kv_full, 0, k0, bh + i * nbh);
        }
      }
      for (int t = first; t < nq; ++t) {
        const int i = t - first;
        const int s = i % kStages;
        bar_wait(&empty[s], ((i / kStages) & 1) ^ 1);  // the first round finds it free
        const int q0 = t * kRows;
        if (lane == 0) {
          bar_expect_tx(&full[s], L::stage);
          for (int part = 0; part < 3; ++part)
            tma_panels<D / 32, kRows>(tile_of(s, part), &q_map, &full[s], 0, q0,
                                      bh + part * nbh);
          for (int part = 0; part < 2; ++part)
            tma_panels<D / 32, kRows>(tile_of(s, 3 + part), &do_map, &full[s], 0, q0,
                                      bh + part * nbh);
        }
        for (int r = lane; r < kRows; r += 32) {
          const bool in = q0 + r < sq;
          const size_t at = static_cast<size_t>(bh) * sq + q0 + r;
          // +inf where the row sees no key or lies past the end, so that
          // its P = exp2(-inf) is 0 with no test per score
          const float x = in ? lse[at] : -CUDART_INF_F;
          lse_of(s)[r] = x == -CUDART_INF_F ? CUDART_INF_F : x;
          delta_of(s)[r] = in ? delta[at] : 0.f;
        }
        bar_arrive(&full[s]);
      }
    }
    return;
  }

  // consumer warpgroup wg: keys k0 .. k0 + 63 (warp w keys 16w .. 16w + 15)
  // over the q tiles first + wg, first + wg + 2, ...: the two take turns, so
  // that one's products overlap the other's elementwise work and loads
  regs_inc<240>();
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int row0 = (tid / 32) * 16 + g;  // this thread's keys: row0, row0 + 8
  const int col0 = 2 * (lane % 4);        // and q columns col0, col0 + 1 of each 8
  const int kid0 = k_offset + k0 + row0;
  const float* k_hi = kv_of(0);
  const float* k_lo = kv_of(1);
  const float* v_hi = kv_of(2);
  const float* v_lo = kv_of(3);

  float dk_acc[D / 2], dv_acc[D / 2];
  // S^T's largest part (K_hi Q_hi^T) and the rest apart, and dP^T; then
  // P^T in st, dS^T in dpt
  float st[kRows / 2], st_rest[kRows / 2], dpt[kRows / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kRows / 2; ++i) st[i] = st_rest[i] = dpt[i] = 0.f;

  bar_wait(kv_full, 0);
  for (int t = first + wg; t < nq; t += 2) {
    const int i = t - first;
    const int s = i % kStages;
    const int q0 = t * kRows;
    bar_wait(&full[s], (i / kStages) & 1);
    const float* q_hi = tile_of(s, 0);
    const float* q_lo = tile_of(s, 1);
    const float* q_rest = tile_of(s, 2);
    const float* do_hi = tile_of(s, 3);
    const float* do_lo = tile_of(s, 4);
    const float* lse_st = lse_of(s);
    const float* delta_st = delta_of(s);

    // S^T = K Q^T and dP^T = V dO^T by wgmma along D (k8 steps, 32 columns
    // to a panel). S^T sums K_hi Q_hi^T into st and K_hi Q_rest^T + K_lo
    // Q_hi^T + K_hi Q_lo^T into st_rest, added once at the end: Q is split
    // into three parts, so that a score is exact to f32 where K is exact in
    // tf32, and the large part is not truncated against the small ones in
    // the tensor cores' sums. P = exp(s scale - LSE) turns a score's error
    // into P's relative error times |s scale|, which reaches hundreds.
    hold(st);
    hold(st_rest);
    hold(dpt);
    mma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const int a = (kk / 4) * kKeys * 32 + (kk % 4) * 8;
      const int b = (kk / 4) * kRows * 32 + (kk % 4) * 8;
      mma_ss_tf32<kRows>(st_rest, desc_k(k_hi + a), desc_k(q_rest + b), kk > 0);
      mma_ss_tf32<kRows>(st_rest, desc_k(k_lo + a), desc_k(q_hi + b), 1);
      mma_ss_tf32<kRows>(st_rest, desc_k(k_hi + a), desc_k(q_lo + b), 1);
      mma_ss_tf32<kRows>(st, desc_k(k_hi + a), desc_k(q_hi + b), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const int a = (kk / 4) * kKeys * 32 + (kk % 4) * 8;
      const int b = (kk / 4) * kRows * 32 + (kk % 4) * 8;
      mma_ss_tf32<kRows>(dpt, desc_k(v_lo + a), desc_k(do_hi + b), kk > 0);
      mma_ss_tf32<kRows>(dpt, desc_k(v_hi + a), desc_k(do_lo + b), 1);
      mma_ss_tf32<kRows>(dpt, desc_k(v_hi + a), desc_k(do_hi + b), 1);
    }
    mma_commit();
    mma_wait<0>();
    hold(st);
    hold(st_rest);
    hold(dpt);

    // P^T and dS^T, as in the bf16 kernel: column c is q row q0 + c; a tile
    // whose first row lies before this CTA's last key is masked. P =
    // exp2((s scale - LSE) log2(e)): the difference is taken in natural
    // units, as the plain version takes it, since LSE and s scale rounded
    // to base 2 apart would each miss by up to half a place of ~|s scale|
    const bool masked = causal && q_offset + q0 < k_offset + k0 + kKeys - 1;
#pragma unroll
    for (int j = 0; j < kRows / 8; ++j) {
      const int c = 8 * j + col0;
      const float2 lse2 = *reinterpret_cast<const float2*>(lse_st + c);
      const float2 dl = *reinterpret_cast<const float2*>(delta_st + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int idx = 4 * j + e;
        const float lse_c = (e & 1) ? lse2.y : lse2.x;
        const float delta_c = (e & 1) ? dl.y : dl.x;
        float p = exp2_fast(fmaf(st[idx] + st_rest[idx], scale, -lse_c) * kLog2e);
        if (masked && q_offset + q0 + c + (e & 1) < kid0 + 8 * (e >> 1)) p = 0.f;
        st[idx] = p;
        dpt[idx] = p * (dpt[idx] - delta_c) * scale;
      }
    }

    // dV += P^T dO and dK += dS^T Q by mma.sync: wgmma would need dO and Q
    // stored transposed (K-major in q), more tiles a stage than shared
    // memory has room for. Each warp takes its 16 keys; P^T and dS^T feed
    // the A operand from the accumulators (to_a_tf32's key_of order), and
    // each thread loads its B elements (q rows 8ks + key_of(t%4) and
    // 8ks + key_of(t%4 + 4), column 8nt + t/4) from the swizzled tiles,
    // split already. Each 8-column group of dV and dK sums this tile's
    // products apart and is added to the running sum once: the tensor
    // cores' sums truncate, and over a whole walk into one accumulator that
    // bias grows with the number of products.
    uint32_t p_hi[kRows / 8][4], p_lo[kRows / 8][4], ds_hi[kRows / 8][4], ds_lo[kRows / 8][4];
    to_a_tf32<kRows>(st, p_hi, p_lo);
    to_a_tf32<kRows>(dpt, ds_hi, ds_lo);
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      float dv_t[4] = {0.f, 0.f, 0.f, 0.f}, dk_t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < kRows / 8; ++ks) {
        const int r = 8 * ks + key_of(lane % 4);  // b0's q row; b1's is r + 1
        const int at0 = swizzled_f32<kRows>(r, 8 * nt + g);
        const int at1 = swizzled_f32<kRows>(r + 1, 8 * nt + g);
        const uint32_t doh0 = __float_as_uint(do_hi[at0]), doh1 = __float_as_uint(do_hi[at1]);
        const uint32_t dol0 = __float_as_uint(do_lo[at0]), dol1 = __float_as_uint(do_lo[at1]);
        const uint32_t qh0 = __float_as_uint(q_hi[at0]), qh1 = __float_as_uint(q_hi[at1]);
        const uint32_t ql0 = __float_as_uint(q_lo[at0]), ql1 = __float_as_uint(q_lo[at1]);
        mma_sync_tf32(dv_t, p_lo[ks], doh0, doh1);
        mma_sync_tf32(dv_t, p_hi[ks], dol0, dol1);
        mma_sync_tf32(dv_t, p_hi[ks], doh0, doh1);
        mma_sync_tf32(dk_t, ds_lo[ks], qh0, qh1);
        mma_sync_tf32(dk_t, ds_hi[ks], ql0, ql1);
        mma_sync_tf32(dk_t, ds_hi[ks], qh0, qh1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dv_acc[4 * nt + e] += dv_t[e];
        dk_acc[4 * nt + e] += dk_t[e];
      }
    }
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[s]);  // this warp is done with the stage
  }

  // the two warpgroups' sums over their halves of the walk: once both
  // have passed every tile the ring is free, warpgroup 1 leaves its sums
  // there, and warpgroup 0 adds them and writes
  float* part = reinterpret_cast<float*>(ring);
  consumers_sync();
  if (wg == 1) {
#pragma unroll
    for (int j = 0; j < D / 2; ++j) {
      part[j * 128 + tid] = dk_acc[j];
      part[(D / 2 + j) * 128 + tid] = dv_acc[j];
    }
  }
  consumers_sync();
  if (wg == 1) return;
#pragma unroll
  for (int j = 0; j < D / 2; ++j) {
    dk_acc[j] += part[j * 128 + tid];
    dv_acc[j] += part[(D / 2 + j) * 128 + tid];
  }

  // epilogue: the rows of keys inside Sk
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + row0 + 8 * h;
    if (key >= sk) continue;
    const size_t at = (static_cast<size_t>(bh) * sk + key) * D;
    float2* dk_row = reinterpret_cast<float2*>(dk + at);
    float2* dv_row = reinterpret_cast<float2*>(dv + at);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      dk_row[4 * j + lane % 4] = make_float2(dk_acc[4 * j + 2 * h], dk_acc[4 * j + 2 * h + 1]);
      dv_row[4 * j + lane % 4] = make_float2(dv_acc[4 * j + 2 * h], dv_acc[4 * j + 2 * h + 1]);
    }
  }
}

// ---- dQ in f32: split-TF32 wgmma and mma.sync, TMA, registers ------------------

template <int D>
struct DqTilesF32 {
  static constexpr int kRows = 64;          // q rows per CTA, both consumer warpgroups'
  static constexpr int kThreads = 3 * 128;  // two consumer warpgroups and the producer
  static constexpr int kKeys = 2048 / D;    // keys per streamed tile: 32, or 16 at D = 128
  static constexpr int kStages = D == 64 ? 4 : 2;
  static constexpr uint32_t q = kRows * D * 4;   // one of Q hi, lo, rest; dO hi, lo
  static constexpr uint32_t kv = kKeys * D * 4;  // one of K hi, K lo, V hi, V lo
  static constexpr uint32_t stage = 4 * kv;
  // Q/dO, the stages, the barriers (Q/dO, full and empty per stage), plus
  // the room to align the start to 1024 bytes
  static constexpr size_t total = 5 * q + kStages * stage + 8 * (1 + 2 * kStages) + 1024;
};

template <int D>
__global__ void __launch_bounds__(DqTilesF32<D>::kThreads, 1)
flash_bwd_dq_tf32_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         const __grid_constant__ CUtensorMap do_map,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dq, int sq, int sk, int q_offset, int k_offset,
                         int causal, int walk_cut, float scale) {
  using namespace hopper;
  using L = DqTilesF32<D>;
  constexpr int kRows = L::kRows;
  constexpr int kKeys = L::kKeys;
  constexpr int kStages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  // Q hi, Q lo, Q rest, dO hi, dO lo, for the whole walk
  auto qdo_of = [&](int i) { return reinterpret_cast<float*>(smem + i * L::q); };
  unsigned char* ring = smem + 5 * L::q;
  // stage s: K hi, K lo, V hi, V lo; then the barriers
  auto tile_of = [&](int s, int i) {
    return reinterpret_cast<float*>(ring + s * L::stage + i * L::kv);
  };
  uint64_t* qdo_full = reinterpret_cast<uint64_t*>(ring + kStages * L::stage);
  uint64_t* full = qdo_full + 1;
  uint64_t* empty = full + kStages;

  const int bh = blockIdx.y;
  const int nbh = gridDim.y;  // part i of head bh is head bh + i nbh of each map
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // heaviest tiles first
  const int kend = kv_tiles_end(q0, kRows, kKeys, tiles_of(sk, kKeys), q_offset, k_offset,
                                causal, walk_cut);

  if (threadIdx.x == 0) {
    bar_init(qdo_full, 1);
    for (int s = 0; s < kStages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 4);  // one arrival per warp of the warpgroup that takes it
    }
    fence_bar_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // producer: one thread issues every load
    regs_dec<24>();
    if (threadIdx.x == 256) {
      bar_arrive_expect_tx(qdo_full, 5 * L::q);
      for (int part = 0; part < 3; ++part)
        tma_panels<D / 32, kRows>(qdo_of(part), &q_map, qdo_full, 0, q0, bh + part * nbh);
      for (int part = 0; part < 2; ++part)
        tma_panels<D / 32, kRows>(qdo_of(3 + part), &do_map, qdo_full, 0, q0, bh + part * nbh);
      for (int t = 0; t < kend; ++t) {
        const int s = t % kStages;
        const int k0 = t * kKeys;
        bar_wait(&empty[s], ((t / kStages) & 1) ^ 1);  // the first round finds it free
        bar_arrive_expect_tx(&full[s], L::stage);
        for (int part = 0; part < 2; ++part) {
          tma_panels<D / 32, kKeys>(tile_of(s, part), &k_map, &full[s], 0, k0, bh + part * nbh);
          tma_panels<D / 32, kKeys>(tile_of(s, 2 + part), &v_map, &full[s], 0, k0,
                                    bh + part * nbh);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: q rows q0 .. q0 + 63 (warp w rows 16w .. 16w +
  // 15) over the kv tiles wg, wg + 2, ...: the two take turns, so that one's
  // products overlap the other's elementwise work and loads
  regs_inc<240>();
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int row0 = (tid / 32) * 16 + g;  // this thread's rows: row0, row0 + 8
  const int col0 = 2 * (lane % 4);        // and keys col0, col0 + 1 of each 8
  const int qid0 = q_offset + q0 + row0;
  const float* q_hi = qdo_of(0);
  const float* q_lo = qdo_of(1);
  const float* q_rest = qdo_of(2);
  const float* do_hi = qdo_of(3);
  const float* do_lo = qdo_of(4);

  // the rows' LSE and delta, read once: a row that sees no key (LSE =
  // -inf) or lies past the end gets +inf, so that its P = exp2(-inf) is 0
  // with no test per score
  float lse_r[2], dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + row0 + 8 * h;
    const bool in = row < sq;
    const size_t at = static_cast<size_t>(bh) * sq + row;
    const float x = in ? lse[at] : -CUDART_INF_F;
    lse_r[h] = x == -CUDART_INF_F ? CUDART_INF_F : x;
    dlt[h] = in ? delta[at] : 0.f;
  }

  float dq_acc[D / 2];
  // S's largest part (Q_hi K_hi^T) and its rest apart; dP's largest part
  // (dO_hi V_hi^T) in kDpChains chains of kChainSteps k8 steps, each an
  // accumulator of its own, and its rest apart; then P in s_acc, dS in
  // dp_acc[0]
  constexpr int kDpChains = 4;
  constexpr int kChainSteps = D / 8 / kDpChains;
  float s_acc[kKeys / 2], s_rest[kKeys / 2], dp_acc[kDpChains][kKeys / 2], dp_rest[kKeys / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kKeys / 2; ++i) {
    s_acc[i] = s_rest[i] = dp_rest[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kDpChains; ++c) dp_acc[c][i] = 0.f;
  }

  bar_wait(qdo_full, 0);
  for (int t = wg; t < kend; t += 2) {
    const int s = t % kStages;
    const int k0 = t * kKeys;
    bar_wait(&full[s], (t / kStages) & 1);
    const float* k_hi = tile_of(s, 0);
    const float* k_lo = tile_of(s, 1);
    const float* v_hi = tile_of(s, 2);
    const float* v_lo = tile_of(s, 3);

    // S = Q K^T and dP = dO V^T by wgmma along D (k8 steps, 32 columns to a
    // panel), committed as two groups. S sums Q_hi K_hi^T into s_acc and
    // Q_rest K_hi^T + Q_lo K_hi^T + Q_hi K_lo^T into s_rest, as dK/dV's S^T.
    // dS = P (dP - delta) scale cancels where P is near 1, so dP's error
    // reaches dQ as it is, times |K scale|; and each wgmma truncates its
    // sum toward zero, which along one accumulator of D / 8 steps adds a
    // bias of up to a place a step, past an f32 sum's rounding to nearest.
    // So dO_hi V_hi^T runs in short chains, each from zero into its own
    // accumulator, and the chains and dP's rest (dO_lo V_hi^T + dO_hi
    // V_lo^T) are added to nearest in registers
    hold(s_acc);
    hold(s_rest);
#pragma unroll
    for (int c = 0; c < kDpChains; ++c) hold(dp_acc[c]);
    hold(dp_rest);
    mma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const int a = (kk / 4) * kRows * 32 + (kk % 4) * 8;
      const int b = (kk / 4) * kKeys * 32 + (kk % 4) * 8;
      mma_ss_tf32<kKeys>(s_rest, desc_k(q_rest + a), desc_k(k_hi + b), kk > 0);
      mma_ss_tf32<kKeys>(s_rest, desc_k(q_lo + a), desc_k(k_hi + b), 1);
      mma_ss_tf32<kKeys>(s_rest, desc_k(q_hi + a), desc_k(k_lo + b), 1);
      mma_ss_tf32<kKeys>(s_acc, desc_k(q_hi + a), desc_k(k_hi + b), kk > 0);
    }
    mma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const int a = (kk / 4) * kRows * 32 + (kk % 4) * 8;
      const int b = (kk / 4) * kKeys * 32 + (kk % 4) * 8;
      mma_ss_tf32<kKeys>(dp_rest, desc_k(do_lo + a), desc_k(v_hi + b), kk > 0);
      mma_ss_tf32<kKeys>(dp_rest, desc_k(do_hi + a), desc_k(v_lo + b), 1);
      mma_ss_tf32<kKeys>(dp_acc[kk / kChainSteps], desc_k(do_hi + a), desc_k(v_hi + b),
                         kk % kChainSteps > 0);
    }
    mma_commit();

    // P while dP is still in flight, in natural units as dK/dV takes it; a
    // tile crossing the diagonal or the end of the keys is masked
    mma_wait<1>();
    hold(s_acc);
    hold(s_rest);
    const bool masked = k0 + kKeys > sk ||
                        (causal && q_offset + q0 < k_offset + k0 + kKeys - 1);
#pragma unroll
    for (int i = 0; i < kKeys / 2; ++i) {
      const int h = (i >> 1) & 1;
      float p = exp2_fast(fmaf(s_acc[i] + s_rest[i], scale, -lse_r[h]) * kLog2e);
      if (masked) {
        const int key = k0 + (i / 4) * 8 + col0 + (i & 1);
        if (key >= sk || (causal && qid0 + 8 * h < k_offset + key)) p = 0.f;
      }
      s_acc[i] = p;
    }
    // then dS
    mma_wait<0>();
#pragma unroll
    for (int c = 0; c < kDpChains; ++c) hold(dp_acc[c]);
    hold(dp_rest);
#pragma unroll
    for (int i = 0; i < kKeys / 2; ++i) {
      float dp = dp_acc[0][i];
#pragma unroll
      for (int c = 1; c < kDpChains; ++c) dp += dp_acc[c][i];
      dp_acc[0][i] = s_acc[i] * (dp + dp_rest[i] - dlt[(i >> 1) & 1]) * scale;
    }

    // dQ += dS K by mma.sync, as dK/dV's dK += dS^T Q: each warp takes its
    // 16 rows; dS feeds the A operand from the accumulator (to_a_tf32's
    // key_of order), and each thread loads its B elements (keys 8ks +
    // key_of(t%4) and 8ks + key_of(t%4 + 4), column 8nt + t/4) from the
    // swizzled K tiles, split already. Each 8-column group of dQ sums this
    // tile's products apart and is added to the running sum once.
    uint32_t ds_hi[kKeys / 8][4], ds_lo[kKeys / 8][4];
    to_a_tf32<kKeys>(dp_acc[0], ds_hi, ds_lo);
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      float dq_t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < kKeys / 8; ++ks) {
        const int r = 8 * ks + key_of(lane % 4);  // b0's key; b1's is r + 1
        const int at0 = swizzled_f32<kKeys>(r, 8 * nt + g);
        const int at1 = swizzled_f32<kKeys>(r + 1, 8 * nt + g);
        const uint32_t kh0 = __float_as_uint(k_hi[at0]), kh1 = __float_as_uint(k_hi[at1]);
        const uint32_t kl0 = __float_as_uint(k_lo[at0]), kl1 = __float_as_uint(k_lo[at1]);
        mma_sync_tf32(dq_t, ds_lo[ks], kh0, kh1);
        mma_sync_tf32(dq_t, ds_hi[ks], kl0, kl1);
        mma_sync_tf32(dq_t, ds_hi[ks], kh0, kh1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) dq_acc[4 * nt + e] += dq_t[e];
    }
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[s]);  // this warp is done with the stage
  }

  // the two warpgroups' sums over their halves of the walk: once both
  // have passed every tile the ring is free, warpgroup 1 leaves its sums
  // there, and warpgroup 0 adds them and writes
  float* part = reinterpret_cast<float*>(ring);
  consumers_sync();
  if (wg == 1) {
#pragma unroll
    for (int j = 0; j < D / 2; ++j) part[j * 128 + tid] = dq_acc[j];
  }
  consumers_sync();
  if (wg == 1) return;
#pragma unroll
  for (int j = 0; j < D / 2; ++j) dq_acc[j] += part[j * 128 + tid];

  // epilogue: the rows inside Sq
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + row0 + 8 * h;
    if (row >= sq) continue;
    float2* out = reinterpret_cast<float2*>(dq + (static_cast<size_t>(bh) * sq + row) * D);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      out[4 * j + lane % 4] = make_float2(dq_acc[4 * j + 2 * h], dq_acc[4 * j + 2 * h + 1]);
  }
}

// ---- dQ in bf16: wgmma, TMA, accumulators in registers ------------------------

// one consumer warpgroup of 64 q rows and a producer warpgroup per CTA, two
// CTAs to an SM (on the card, two consumer warpgroups to a CTA and one CTA
// to an SM ran 12-20% slower)
constexpr int kDqRows = 64;
constexpr int kDqThreads = 2 * 128;
constexpr int kDqCtasPerSm = 2;

template <int D>
struct DqTiles {
  // keys per streamed tile: at D = 128 the dQ accumulator takes 64
  // registers a thread, so 64-key tiles keep S and dP to 32 each
  static constexpr int kBlockK = D == 64 ? 128 : 64;
  static constexpr uint32_t q = hopper::tile_bytes<D, kDqRows>();   // one of Q, dO
  static constexpr uint32_t kv = hopper::tile_bytes<D, kBlockK>();  // one of K, V
  static constexpr uint32_t stage = 2 * kv;
  // tiles, then the barriers (Q/dO, full and empty per stage), plus the
  // room to align the start to 1024 bytes
  static constexpr size_t total = 2 * q + kStages * stage + 8 * (1 + 2 * kStages) + 1024;
};

template <int D>
__global__ void __launch_bounds__(kDqThreads, kDqCtasPerSm)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap do_map,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dq, int sq, int sk, int q_offset,
                          int k_offset, int causal, int walk_cut, float scale) {
  using namespace hopper;
  using L = DqTiles<D>;
  using bf16 = __nv_bfloat16;
  constexpr int kBlockK = L::kBlockK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* do_s = reinterpret_cast<bf16*>(smem + L::q);
  unsigned char* ring = smem + 2 * L::q;
  uint64_t* qdo_full = reinterpret_cast<uint64_t*>(ring + kStages * L::stage);
  uint64_t* full = qdo_full + 1;
  uint64_t* empty = full + kStages;

  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kDqRows;  // heaviest tiles first
  const int kend = kv_tiles_end(q0, kDqRows, kBlockK, tiles_of(sk, kBlockK), q_offset, k_offset,
                                causal, walk_cut);

  if (threadIdx.x == 0) {
    bar_init(qdo_full, 1);
    for (int s = 0; s < kStages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 4);  // one arrival per consumer warp
    }
    fence_bar_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // producer: one thread issues every load
    regs_dec<24>();
    if (threadIdx.x == 128) {
      bar_arrive_expect_tx(qdo_full, 2 * L::q);
      tma_tile<D, kDqRows>(q_s, &q_map, qdo_full, q0, bh);
      tma_tile<D, kDqRows>(do_s, &do_map, qdo_full, q0, bh);
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

  // the consumer warpgroup: a consumer thread's registers once the
  // producer has given up its own
  regs_inc<232>();
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int row0 = (tid / 32) * 16 + lane / 4;  // this thread's rows: row0, row0 + 8
  const int col0 = 2 * (lane % 4);               // and columns col0, col0 + 1 of each 8
  const int qid0 = q_offset + q0 + row0;
  const float scale_log2 = scale * kLog2e;

  // the rows' LSE in base 2 and delta, read once: a row that sees no key
  // (LSE = -inf) or lies past the end gets +inf, so that its P = exp2(s -
  // inf) is 0 with no test per score
  float lse2[2], dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + row0 + 8 * h;
    const bool in = row < sq;
    const size_t at = static_cast<size_t>(bh) * sq + row;
    const float x = in ? lse[at] : -CUDART_INF_F;
    lse2[h] = x == -CUDART_INF_F ? CUDART_INF_F : x * kLog2e;
    dlt[h] = in ? delta[at] : 0.f;
  }

  float dq_acc[D / 2];
  float s_acc[kBlockK / 2], dp_acc[kBlockK / 2];  // S, dP; then dS in dp_acc
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kBlockK / 2; ++i) s_acc[i] = dp_acc[i] = 0.f;
  uint32_t ds_op[kBlockK / 16][4];

  bar_wait(qdo_full, 0);
  for (int t = 0; t < kend; ++t) {
    const int s = t % kStages;
    const int k0 = t * kBlockK;
    bar_wait(&full[s], (t / kStages) & 1);
    const bf16* k_s = reinterpret_cast<const bf16*>(ring + s * L::stage);
    const bf16* v_s = k_s + kBlockK * D;

    // S = Q K^T and dP = dO V^T: k16 steps along D, 64 columns to a panel
    hold(s_acc);
    hold(dp_acc);
    mma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int a = (kk / 4) * kDqRows * 64 + (kk % 4) * 16;
      const int b = (kk / 4) * kBlockK * 64 + (kk % 4) * 16;
      mma_ss<kBlockK>(s_acc, desc_k(q_s + a), desc_k(k_s + b), kk > 0);
    }
    mma_commit();  // S, then dP: two groups
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int a = (kk / 4) * kDqRows * 64 + (kk % 4) * 16;
      const int b = (kk / 4) * kBlockK * 64 + (kk % 4) * 16;
      mma_ss<kBlockK>(dp_acc, desc_k(do_s + a), desc_k(v_s + b), kk > 0);
    }
    mma_commit();

    // P while dP is still in flight; a tile crossing the diagonal or the
    // end of the keys is masked
    mma_wait<1>();
    hold(s_acc);
    const bool masked = k0 + kBlockK > sk ||
                        (causal && q_offset + q0 < k_offset + k0 + kBlockK - 1);
#pragma unroll
    for (int i = 0; i < kBlockK / 2; ++i) {
      float p = exp2_fast(fmaf(s_acc[i], scale_log2, -lse2[(i >> 1) & 1]));
      if (masked) {
        const int key = k0 + (i / 4) * 8 + col0 + (i & 1);
        if (key >= sk || (causal && qid0 + 8 * ((i >> 1) & 1) < k_offset + key)) p = 0.f;
      }
      s_acc[i] = p;
    }
    // then dS
    mma_wait<0>();
    hold(dp_acc);
#pragma unroll
    for (int i = 0; i < kBlockK / 2; ++i)
      dp_acc[i] = s_acc[i] * (dp_acc[i] - dlt[(i >> 1) & 1]) * scale;
    to_a_operand<kBlockK>(dp_acc, ds_op);  // dS in K's dtype

    // dQ += dS K: k16 steps of 16 keys (2048 bytes), K read MN-major; the
    // next 64 columns of D are the next panel
    hold(dq_acc);
    hold(ds_op);
    mma_fence();
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk)
      mma_rs<D>(dq_acc, ds_op[kk], desc_mn(k_s + kk * 16 * 64, kBlockK * 128));
    mma_commit();
    mma_wait<0>();
    hold(dq_acc);
    hold(ds_op);
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[s]);  // this warp is done with the stage
  }

  // epilogue: the rows inside Sq
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + row0 + 8 * h;
    if (row >= sq) continue;
    uint32_t* out = reinterpret_cast<uint32_t*>(dq + (static_cast<size_t>(bh) * sq + row) * D);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      out[(8 * j + col0) / 2] = pack_bf16(dq_acc[4 * j + 2 * h], dq_acc[4 * j + 2 * h + 1]);
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  float* ws;  // the split pass's workspace (f32)
  int bh, sq, sk, q_offset, k_offset, causal, walk_cut;
  float scale;
  cudaStream_t stream;
};

// the split pass's outputs in the workspace (bwd_workspace_floats)
struct Parts {
  float *q, *dout, *k, *v;
};

// The split pass that both f32 kernels run first: Q into hi, lo and rest;
// dO, K and V into hi and lo.
inline Parts split_pass(const Args& a, int d) {
  const size_t rows = static_cast<size_t>(a.bh) * a.sq * d;
  const size_t keys = static_cast<size_t>(a.bh) * a.sk * d;
  const Parts w{a.ws, a.ws + 3 * rows, a.ws + 5 * rows, a.ws + 5 * rows + 2 * keys};
  hopper::split_tf32_launch(a.q, w.q, rows, 3, a.stream);
  hopper::split_tf32_launch(a.dout, w.dout, rows, 2, a.stream);
  hopper::split_tf32_launch(a.k, w.k, keys, 2, a.stream);
  hopper::split_tf32_launch(a.v, w.v, keys, 2, a.stream);
  return w;
}

// The split pass, then the maps of its output (Q, K, V, dO) for an f32
// kernel whose tiles L load L::kRows q rows and L::kKeys keys a box.
template <typename L, int D>
int split_and_map(const Args& a, CUtensorMap (&maps)[4]) {
  if (a.ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Parts w = split_pass(a, D);
  int rc = hopper::make_map_f32(&maps[0], w.q, 3 * a.bh, a.sq, D, L::kRows);
  if (rc == 0) rc = hopper::make_map_f32(&maps[1], w.k, 2 * a.bh, a.sk, D, L::kKeys);
  if (rc == 0) rc = hopper::make_map_f32(&maps[2], w.v, 2 * a.bh, a.sk, D, L::kKeys);
  if (rc == 0) rc = hopper::make_map_f32(&maps[3], w.dout, 2 * a.bh, a.sq, D, L::kRows);
  return rc;
}

template <int D>
int launch_dq_tf32(const Args& a) {
  using L = DqTilesF32<D>;
  static const cudaError_t attr = allow_smem(flash_bwd_dq_tf32_kernel<D>, L::total);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap maps[4];
  const int rc = split_and_map<L, D>(a, maps);
  if (rc != 0) return rc;
  flash_bwd_dq_tf32_kernel<D><<<dim3(tiles_of(a.sq, L::kRows), a.bh), L::kThreads, L::total,
                                a.stream>>>(
      maps[0], maps[1], maps[2], maps[3], a.lse, a.delta, static_cast<float*>(a.dq), a.sq, a.sk,
      a.q_offset, a.k_offset, a.causal, a.walk_cut, a.scale);
  return 0;
}

template <int D>
int launch_dq_wgmma(const Args& a) {
  using L = DqTiles<D>;
  static const cudaError_t attr = allow_smem(flash_bwd_dq_wgmma_kernel<D>, L::total);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap maps[4];
  int rc = hopper::make_map(&maps[0], a.q, a.bh, a.sq, D, kDqRows);
  if (rc == 0) rc = hopper::make_map(&maps[1], a.k, a.bh, a.sk, D, L::kBlockK);
  if (rc == 0) rc = hopper::make_map(&maps[2], a.v, a.bh, a.sk, D, L::kBlockK);
  if (rc == 0) rc = hopper::make_map(&maps[3], a.dout, a.bh, a.sq, D, kDqRows);
  if (rc != 0) return rc;
  flash_bwd_dq_wgmma_kernel<D><<<dim3(tiles_of(a.sq, kDqRows), a.bh), kDqThreads, L::total,
                                 a.stream>>>(
      maps[0], maps[1], maps[2], maps[3], a.lse, a.delta, static_cast<__nv_bfloat16*>(a.dq),
      a.sq, a.sk, a.q_offset, a.k_offset, a.causal, a.walk_cut, a.scale);
  return 0;
}

template <int D>
int launch_dkv_tf32(const Args& a) {
  using L = DkvTilesF32<D>;
  static const cudaError_t attr = allow_smem(flash_bwd_dkv_tf32_kernel<D>, L::total);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap maps[4];
  const int rc = split_and_map<L, D>(a, maps);
  if (rc != 0) return rc;
  flash_bwd_dkv_tf32_kernel<D><<<dim3(tiles_of(a.sk, L::kKeys), a.bh), L::kThreads, L::total,
                                 a.stream>>>(
      maps[0], maps[1], maps[2], maps[3], a.lse, a.delta, static_cast<float*>(a.dk),
      static_cast<float*>(a.dv), a.sq, a.sk, a.q_offset, a.k_offset, a.causal, a.walk_cut,
      a.scale);
  return 0;
}

template <int D>
int launch_dkv_wgmma(const Args& a) {
  using L = DkvTiles<D>;
  static const cudaError_t attr = allow_smem(flash_bwd_dkv_wgmma_kernel<D>, L::total);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap maps[4];
  int rc = hopper::make_map(&maps[0], a.q, a.bh, a.sq, D, kRowsQ);
  if (rc == 0) rc = hopper::make_map(&maps[1], a.k, a.bh, a.sk, D, kKeys);
  if (rc == 0) rc = hopper::make_map(&maps[2], a.v, a.bh, a.sk, D, kKeys);
  if (rc == 0) rc = hopper::make_map(&maps[3], a.dout, a.bh, a.sq, D, kRowsQ);
  if (rc != 0) return rc;
  flash_bwd_dkv_wgmma_kernel<D><<<dim3(tiles_of(a.sk, kKeys), a.bh), kThreadsWG, L::total,
                                  a.stream>>>(
      maps[0], maps[1], maps[2], maps[3], a.lse, a.delta, static_cast<__nv_bfloat16*>(a.dk),
      static_cast<__nv_bfloat16*>(a.dv), a.sq, a.sk, a.q_offset, a.k_offset, a.causal,
      a.walk_cut, a.scale);
  return 0;
}

// dtype 0 = f32 runs the split-TF32 kernels, 1 = bf16 the bf16 ones
template <bool kDq, int D>
int launch(int dtype, const Args& a) {
  if (dtype == 0) return kDq ? launch_dq_tf32<D>(a) : launch_dkv_tf32<D>(a);
  if (dtype == 1) return kDq ? launch_dq_wgmma<D>(a) : launch_dkv_wgmma<D>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool kDq>
int run(int head_dim, int dtype, const Args& a) {
  if (a.bh <= 0 || a.sq <= 0 || a.sk <= 0 || a.walk_cut < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // start from a clean error state
  int rc;
  if (head_dim == 64)
    rc = launch<kDq, 64>(dtype, a);
  else if (head_dim == 128)
    rc = launch<kDq, 128>(dtype, a);
  else
    rc = static_cast<int>(cudaErrorInvalidValue);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int resources_of(int kernel, int dtype, int* out) {
  if (kernel == 0 && dtype == 0)
    return resources(flash_bwd_dq_tf32_kernel<D>, DqTilesF32<D>::kThreads,
                     DqTilesF32<D>::total, out);
  if (kernel == 0 && dtype == 1)
    return resources(flash_bwd_dq_wgmma_kernel<D>, kDqThreads, DqTiles<D>::total, out);
  if (kernel == 1 && dtype == 0)
    return resources(flash_bwd_dkv_tf32_kernel<D>, DkvTilesF32<D>::kThreads,
                     DkvTilesF32<D>::total, out);
  if (kernel == 1 && dtype == 1)
    return resources(flash_bwd_dkv_wgmma_kernel<D>, kThreadsWG, DkvTiles<D>::total, out);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. workspace: flash_bwd_workspace() bytes
// for the split pass (f32), 16-byte aligned, or null where that is 0.
// walk_cut: tiles cut from each walk, 0 in use (1 plants a fault that a
// check must see: dQ stops before the diagonal kv tile, dK/dV starts one q
// tile late). Each returns cudaGetLastError() after its launches (0 on
// success), or cudaErrorInvalidValue for a shape or dtype the kernel does
// not take. Launches on `stream`, does not synchronise.
int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                 const void* delta, void* dq, void* workspace, int bh, int sq, int sk,
                 int head_dim, int q_offset, int k_offset, int causal, int walk_cut, float scale,
                 int dtype, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
               dq, nullptr, nullptr, static_cast<float*>(workspace), bh, sq, sk, q_offset,
               k_offset, causal, walk_cut, scale, static_cast<cudaStream_t>(stream)};
  return run<true>(head_dim, dtype, a);
}

int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                  const void* lse, const void* delta, void* dk, void* dv, void* workspace,
                  int bh, int sq, int sk, int head_dim, int q_offset, int k_offset, int causal,
                  int walk_cut, float scale, int dtype, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
               nullptr, dk, dv, static_cast<float*>(workspace), bh, sq, sk, q_offset, k_offset,
               causal, walk_cut, scale, static_cast<cudaStream_t>(stream)};
  return run<false>(head_dim, dtype, a);
}

// Bytes of workspace the kernel (0 = dQ, 1 = dK/dV) needs for these shapes:
// the split pass's in f32, 0 in bf16.
size_t flash_bwd_workspace(int kernel, int bh, int sq, int sk, int head_dim, int dtype) {
  if ((kernel != 0 && kernel != 1) || dtype != 0 || bh <= 0 || sq <= 0 || sk <= 0) return 0;
  return bwd_workspace_floats(bh, sq, sk, head_dim) * sizeof(float);
}

// What the kernel (0 = dQ, 1 = dK/dV) for (head_dim, dtype) holds on the
// card, into out[5]: registers per thread at launch, shared memory per CTA,
// CTAs per SM, threads per CTA, spilled bytes per thread. Returns 0 or a
// CUDA error.
int flash_bwd_resources(int kernel, int head_dim, int dtype, int* out) {
  if (head_dim == 64) return resources_of<64>(kernel, dtype, out);
  if (head_dim == 128) return resources_of<128>(kernel, dtype, out);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
