// Flash-attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Two kernels, replacing the TPU kernels of polyaxon_tpu/ops/flash_attention.py
// launched by _flash_bwd:
//
// - dQ   <- _bwd_dq_kernel:  dQ = sum_j dS K
//   (bf16: flash_bwd_dq_wgmma_kernel; f32: flash_bwd_dq_kernel)
// - dK/dV <- _bwd_dkv_kernel: dV = sum_i P^T dO, dK = sum_i dS^T Q
//   (bf16: flash_bwd_dkv_wgmma_kernel; f32: flash_bwd_dkv_kernel)
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
// f32 (flash_bwd_dq_kernel, flash_bwd_dkv_kernel): 32-row tiles, 2 warps,
// staged in shared memory by the whole CTA; each warp computes its 16-row
// blocks of S and dO V^T (or S^T = K Q^T and V dO^T) on the CUDA cores
// (tensor cores would round to tf32), the elementwise P and dS (two lanes
// per row), and adds its products into f32 accumulators in shared memory.
// Loads do not overlap the products. f32 is llama-tiny's dtype, never on the
// card's main path.

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;

// ---- f32: CUDA cores, products and accumulators in shared memory -------------

template <int D>
struct BwdSmem {
  static constexpr int kTile = kTileF32;
  static constexpr int kWarps = kTile / 16;
  static constexpr size_t tile = pad128(sizeof(float) * kTile * ld_of<D>());  // one of q/do/k/v
  static constexpr size_t rows = pad128(sizeof(float) * kTile);               // one of lse/delta
  static constexpr size_t s = pad128(sizeof(float) * kWarps * 16 * ldf_of<kTile>());
  static constexpr size_t p = pad128(sizeof(float) * kWarps * 16 * ld_of<kTile>());
  static constexpr size_t acc = pad128(sizeof(float) * kWarps * 16 * ldf_of<D>());
  // dQ: q, do, k, v; lse, delta; S, dP; dS; dQ
  static constexpr size_t dq_total = 4 * tile + 2 * rows + 2 * s + p + acc;
  // dK/dV: dQ's buffers plus P and a second accumulator
  static constexpr size_t dkv_total = dq_total + p + acc;
};

// The tile's elementwise step for one lane's half row: P and dS from the f32
// products S (= q.k) and dP (= dO.v); `hidden(c)` says whether the pair at
// column c is masked (causally, or its key lies past the end), and the
// callers' maps give each column's LSE and delta. Writes dS (and P when
// p_out is set).
template <int N, typename Hidden, typename LseOf, typename DeltaOf>
__device__ __forceinline__ void probs_and_ds(const float* s_row, const float* dp_row,
                                             float* p_out, float* ds_out, int half, float scale,
                                             Hidden hidden, LseOf lse_of, DeltaOf delta_of) {
  for (int c = half * (N / 2); c < (half + 1) * (N / 2); ++c) {
    const float lse = lse_of(c);
    float p = 0.f;
    if (lse != -CUDART_INF_F && !hidden(c)) p = expf(s_row[c] * scale - lse);
    if (p_out != nullptr) p_out[c] = p;
    ds_out[c] = p * (dp_row[c] - delta_of(c)) * scale;
  }
}

template <int D>
__global__ void __launch_bounds__(BwdSmem<D>::kWarps * 32)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int sq, int sk, int q_offset, int k_offset,
                    int causal, int walk_cut, float scale) {
  using L = BwdSmem<D>;
  constexpr int kTile = L::kTile;
  constexpr int kThreads = L::kWarps * 32;
  constexpr int LD = ld_of<D>();
  constexpr int LDS = ldf_of<kTile>();
  constexpr int LDP = ld_of<kTile>();
  constexpr int LDA = ldf_of<D>();

  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* at = smem;
  float* q_s = reinterpret_cast<float*>(at);
  float* do_s = reinterpret_cast<float*>(at += L::tile);
  float* k_s = reinterpret_cast<float*>(at += L::tile);
  float* v_s = reinterpret_cast<float*>(at += L::tile);
  float* lse_s = reinterpret_cast<float*>(at += L::tile);
  float* delta_s = reinterpret_cast<float*>(at += L::rows);
  float* s_all = reinterpret_cast<float*>(at += L::rows);
  float* dp_all = reinterpret_cast<float*>(at += L::s);
  float* ds_all = reinterpret_cast<float*>(at += L::s);
  float* acc_all = reinterpret_cast<float*>(at += L::p);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int r = lane >> 1;
  const int half = lane & 1;
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;  // heaviest tiles first
  float* s_w = s_all + warp * 16 * LDS;
  float* dp_w = dp_all + warp * 16 * LDS;
  float* ds_w = ds_all + warp * 16 * LDP;
  float* acc_w = acc_all + warp * 16 * LDA;

  const size_t row0 = static_cast<size_t>(bh) * sq + q0;
  load_tile<D>(q_s, q + row0 * D, kTile, sq - q0, tid, kThreads);
  load_tile<D>(do_s, dout + row0 * D, kTile, sq - q0, tid, kThreads);
  for (int i = tid; i < kTile; i += kThreads) {
    const bool in = q0 + i < sq;
    lse_s[i] = in ? lse[row0 + i] : -CUDART_INF_F;
    delta_s[i] = in ? delta[row0 + i] : 0.f;
  }
  for (int c = half * (D / 2); c < (half + 1) * (D / 2); ++c) acc_w[r * LDA + c] = 0.f;

  const int kend = kv_tiles_end(q0, kTile, kTile, tiles_of(sk, kTile), q_offset, k_offset,
                                causal, walk_cut);
  const int row = warp * 16 + r;
  const int qid = q_offset + q0 + row;

  for (int t = 0; t < kend; ++t) {
    const int k0 = t * kTile;
    __syncthreads();
    const size_t key0 = static_cast<size_t>(bh) * sk + k0;
    load_tile<D>(k_s, k + key0 * D, kTile, sk - k0, tid, kThreads);
    load_tile<D>(v_s, v + key0 * D, kTile, sk - k0, tid, kThreads);
    __syncthreads();

    warp_mma<true, kTile, D>(s_w, LDS, q_s + warp * 16 * LD, LD, k_s, LD, false);    // q k^T
    warp_mma<true, kTile, D>(dp_w, LDS, do_s + warp * 16 * LD, LD, v_s, LD, false);  // dO v^T
    __syncwarp();
    probs_and_ds<kTile>(
        s_w + r * LDS, dp_w + r * LDS, nullptr, ds_w + r * LDP, half, scale,
        [&](int c) { return k0 + c >= sk || (causal && qid < k_offset + k0 + c); },
        [&](int) { return lse_s[row]; }, [&](int) { return delta_s[row]; });
    __syncwarp();
    warp_mma<false, D, kTile>(acc_w, LDA, ds_w, LDP, k_s, LD, true);  // dQ += dS K
    __syncwarp();
  }

  if (q0 + row >= sq) return;  // a row past the end of a partial tile
  float* dq_row = dq + (row0 + row) * D;
  for (int c = half * (D / 2); c < (half + 1) * (D / 2); ++c) dq_row[c] = acc_w[r * LDA + c];
}

// ---- dK/dV in f32: CUDA cores, products and accumulators in shared memory ----

template <int D>
__global__ void __launch_bounds__(BwdSmem<D>::kWarps * 32)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, int sq, int sk,
                     int q_offset, int k_offset, int causal, int walk_cut, float scale) {
  using L = BwdSmem<D>;
  constexpr int kTile = L::kTile;
  constexpr int kThreads = L::kWarps * 32;
  constexpr int LD = ld_of<D>();
  constexpr int LDS = ldf_of<kTile>();
  constexpr int LDP = ld_of<kTile>();
  constexpr int LDA = ldf_of<D>();

  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* at = smem;
  float* k_s = reinterpret_cast<float*>(at);
  float* v_s = reinterpret_cast<float*>(at += L::tile);
  float* q_s = reinterpret_cast<float*>(at += L::tile);
  float* do_s = reinterpret_cast<float*>(at += L::tile);
  float* lse_s = reinterpret_cast<float*>(at += L::tile);
  float* delta_s = reinterpret_cast<float*>(at += L::rows);
  float* st_all = reinterpret_cast<float*>(at += L::rows);
  float* dpt_all = reinterpret_cast<float*>(at += L::s);
  float* pt_all = reinterpret_cast<float*>(at += L::s);
  float* dst_all = reinterpret_cast<float*>(at += L::p);
  float* dk_all = reinterpret_cast<float*>(at += L::p);
  float* dv_all = reinterpret_cast<float*>(at += L::acc);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int r = lane >> 1;
  const int half = lane & 1;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kTile;
  float* st_w = st_all + warp * 16 * LDS;
  float* dpt_w = dpt_all + warp * 16 * LDS;
  float* pt_w = pt_all + warp * 16 * LDP;
  float* dst_w = dst_all + warp * 16 * LDP;
  float* dk_w = dk_all + warp * 16 * LDA;
  float* dv_w = dv_all + warp * 16 * LDA;

  const size_t key0 = static_cast<size_t>(bh) * sk + k0;
  load_tile<D>(k_s, k + key0 * D, kTile, sk - k0, tid, kThreads);
  load_tile<D>(v_s, v + key0 * D, kTile, sk - k0, tid, kThreads);
  for (int c = half * (D / 2); c < (half + 1) * (D / 2); ++c) {
    dk_w[r * LDA + c] = 0.f;
    dv_w[r * LDA + c] = 0.f;
  }

  const int nq = tiles_of(sq, kTile);
  const int first = q_tiles_begin(k0, kTile, q_offset, k_offset, causal, walk_cut);
  const int row = warp * 16 + r;  // this lane's key within the tile
  const int kid = k_offset + k0 + row;

  for (int t = first; t < nq; ++t) {
    const int q0 = t * kTile;
    const size_t qrow0 = static_cast<size_t>(bh) * sq + q0;
    __syncthreads();
    load_tile<D>(q_s, q + qrow0 * D, kTile, sq - q0, tid, kThreads);
    load_tile<D>(do_s, dout + qrow0 * D, kTile, sq - q0, tid, kThreads);
    for (int i = tid; i < kTile; i += kThreads) {
      const bool in = q0 + i < sq;
      lse_s[i] = in ? lse[qrow0 + i] : -CUDART_INF_F;
      delta_s[i] = in ? delta[qrow0 + i] : 0.f;
    }
    __syncthreads();

    warp_mma<true, kTile, D>(st_w, LDS, k_s + warp * 16 * LD, LD, q_s, LD, false);   // k q^T
    warp_mma<true, kTile, D>(dpt_w, LDS, v_s + warp * 16 * LD, LD, do_s, LD, false); // v dO^T
    __syncwarp();
    // a key past the end is never written, so only the causal mask hides
    // pairs here; a query past the end has LSE = -inf
    probs_and_ds<kTile>(
        st_w + r * LDS, dpt_w + r * LDS, pt_w + r * LDP, dst_w + r * LDP, half, scale,
        [&](int c) { return causal && q_offset + q0 + c < kid; },
        [&](int c) { return lse_s[c]; }, [&](int c) { return delta_s[c]; });
    __syncwarp();
    warp_mma<false, D, kTile>(dv_w, LDA, pt_w, LDP, do_s, LD, true);   // dV += P^T dO
    warp_mma<false, D, kTile>(dk_w, LDA, dst_w, LDP, q_s, LD, true);   // dK += dS^T Q
    __syncwarp();
  }

  if (k0 + row >= sk) return;  // a key past the end of a partial tile
  const size_t out = (key0 + row) * D;
  for (int c = half * (D / 2); c < (half + 1) * (D / 2); ++c) {
    dk[out + c] = dk_w[r * LDA + c];
    dv[out + c] = dv_w[r * LDA + c];
  }
}

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
  int bh, sq, sk, q_offset, k_offset, causal, walk_cut;
  float scale;
  cudaStream_t stream;
};

template <int D>
int launch_dq_f32(const Args& a) {
  using L = BwdSmem<D>;
  static const cudaError_t attr = allow_smem(flash_bwd_dq_kernel<D>, L::dq_total);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  flash_bwd_dq_kernel<D><<<dim3(tiles_of(a.sq, L::kTile), a.bh), L::kWarps * 32, L::dq_total,
                           a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
      static_cast<float*>(a.dq), a.sq, a.sk, a.q_offset, a.k_offset, a.causal, a.walk_cut,
      a.scale);
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
int launch_dkv_f32(const Args& a) {
  using L = BwdSmem<D>;
  static const cudaError_t attr = allow_smem(flash_bwd_dkv_kernel<D>, L::dkv_total);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  flash_bwd_dkv_kernel<D><<<dim3(tiles_of(a.sk, L::kTile), a.bh), L::kWarps * 32, L::dkv_total,
                            a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
      static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.sq, a.sk, a.q_offset, a.k_offset,
      a.causal, a.walk_cut, a.scale);
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

// dtype 0 = f32 runs the CUDA-core kernels, 1 = bf16 the wgmma ones
template <bool kDq, int D>
int launch(int dtype, const Args& a) {
  if (dtype == 0) return kDq ? launch_dq_f32<D>(a) : launch_dkv_f32<D>(a);
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
  using B = BwdSmem<D>;
  if (kernel == 0 && dtype == 0)
    return resources(flash_bwd_dq_kernel<D>, B::kWarps * 32, B::dq_total, out);
  if (kernel == 0 && dtype == 1)
    return resources(flash_bwd_dq_wgmma_kernel<D>, kDqThreads, DqTiles<D>::total, out);
  if (kernel == 1 && dtype == 0)
    return resources(flash_bwd_dkv_kernel<D>, B::kWarps * 32, B::dkv_total, out);
  if (kernel == 1 && dtype == 1)
    return resources(flash_bwd_dkv_wgmma_kernel<D>, kThreadsWG, DkvTiles<D>::total, out);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. walk_cut: tiles cut from each walk, 0
// in use (1 plants a fault that a check must see: dQ stops before the
// diagonal kv tile, dK/dV starts one q tile late). Each returns
// cudaGetLastError() after its launch (0 on success), or
// cudaErrorInvalidValue for a shape or dtype the kernel does not take.
// Launches on `stream`, does not synchronise.
int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                 const void* delta, void* dq, int bh, int sq, int sk, int head_dim,
                 int q_offset, int k_offset, int causal, int walk_cut, float scale, int dtype,
                 void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
               dq, nullptr, nullptr, bh, sq, sk, q_offset, k_offset, causal, walk_cut, scale,
               static_cast<cudaStream_t>(stream)};
  return run<true>(head_dim, dtype, a);
}

int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                  const void* lse, const void* delta, void* dk, void* dv, int bh, int sq,
                  int sk, int head_dim, int q_offset, int k_offset, int causal, int walk_cut,
                  float scale, int dtype, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
               nullptr, dk, dv, bh, sq, sk, q_offset, k_offset, causal, walk_cut, scale,
               static_cast<cudaStream_t>(stream)};
  return run<false>(head_dim, dtype, a);
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
