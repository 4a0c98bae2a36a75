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
// Design. The TPU carried the online-softmax state across a sequential grid
// axis; here one CTA per (bh, q tile) walks the kv tiles in a loop, and the
// loop stops at the last causally visible tile (what _kv_clamp does with the
// DMA): tiles above the diagonal are neither loaded nor computed. Tiles are
// 64 rows in bf16 (4 warps of 16 q rows), 32 in f32 (2 warps). Each kv tile
// of K and V is staged in shared memory by the whole CTA; each warp then
// computes its 16 x 64 scores S = Q K^T with tensor-core mma (bf16 in, f32
// out), runs the online softmax on them (two lanes per row, each half the
// columns), writes p rounded to bf16, rescales its f32 accumulator by alpha
// and adds P V with mma. The accumulator lives in shared memory because a
// row rescale needs to know which row each value belongs to, which an mma
// fragment does not say. The CTAs of the last q tiles have the most kv tiles
// to walk, so they are launched first. A length that is no multiple of the
// tile ends in a partial tile: its missing rows are loaded as zeros, its
// missing keys are hidden like masked ones, and its missing rows are not
// written.
//
// Shared memory per CTA (dynamic, so above the 48 KB static limit where
// needed): q, K and V tiles, the f32 scores, p and the f32 accumulator; 110 KB
// at D = 128 in bf16.
//
// Bound on the H100. Two products of 2 * Sq * Sk * D FLOP (half of it under
// the causal mask) against one read of q, k, v and one write of o: at the
// llama-1b shape (BH 64, S 2048, D 64, bf16) 3.4e10 FLOP over 989 TFLOP/s is
// 34.7 us, while the 67 MB of traffic take 20 us, so the tensor cores bound
// it. This simple design is far from that: 4 warps per CTA, K/V loaded
// without overlap with the products, the accumulator and scores round-tripped
// through shared memory. wgmma, TMA loads with a ring of stages and keeping
// the accumulator in registers are the later steps.

#include "flash_common.cuh"

namespace {

using namespace flash;

template <typename T, int D>
struct FwdSmem {
  static constexpr int kTile = Traits<T>::kTile;
  static constexpr int kWarps = kTile / 16;
  static constexpr size_t q = pad128(sizeof(T) * kTile * ld_of<D>());
  static constexpr size_t kv = q;  // each of K and V
  static constexpr size_t s = pad128(sizeof(float) * kWarps * 16 * ldf_of<kTile>());
  static constexpr size_t p = pad128(sizeof(T) * kWarps * 16 * ld_of<kTile>());
  static constexpr size_t o = pad128(sizeof(float) * kWarps * 16 * ldf_of<D>());
  static constexpr size_t total = q + 2 * kv + s + p + o;
};

template <typename T, int D>
__global__ void __launch_bounds__(Traits<T>::kTile * 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int sq, int sk, int q_offset,
                 int k_offset, int causal, int walk_cut, float scale) {
  using L = FwdSmem<T, D>;
  constexpr int kTile = L::kTile;
  constexpr int kThreads = L::kWarps * 32;
  constexpr int LD = ld_of<D>();
  constexpr int LDS = ldf_of<kTile>();
  constexpr int LDP = ld_of<kTile>();
  constexpr int LDO = ldf_of<D>();
  constexpr int kHalfS = kTile / 2;
  constexpr int kHalfD = D / 2;

  extern __shared__ __align__(128) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* k_s = reinterpret_cast<T*>(smem + L::q);
  T* v_s = reinterpret_cast<T*>(smem + L::q + L::kv);
  float* s_all = reinterpret_cast<float*>(smem + L::q + 2 * L::kv);
  T* p_all = reinterpret_cast<T*>(smem + L::q + 2 * L::kv + L::s);
  float* o_all = reinterpret_cast<float*>(smem + L::q + 2 * L::kv + L::s + L::p);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int r = lane >> 1;     // this lane's row of the warp's 16
  const int half = lane & 1;   // and which half of the row's columns
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;  // heaviest tiles first
  float* s_w = s_all + warp * 16 * LDS;
  T* p_w = p_all + warp * 16 * LDP;
  float* o_w = o_all + warp * 16 * LDO;
  const T* q_w = q_s + warp * 16 * LD;

  load_tile<T, D>(q_s, q + (static_cast<size_t>(bh) * sq + q0) * D, kTile, sq - q0, tid,
                  kThreads);
  for (int c = half * kHalfD; c < (half + 1) * kHalfD; ++c) o_w[r * LDO + c] = 0.f;

  const int kend = kv_tiles_end(q0, kTile, tiles_of(sk, kTile), q_offset, k_offset, causal,
                                walk_cut);
  const int row = warp * 16 + r;  // this lane's row of the q tile
  const int qid = q_offset + q0 + row;
  float m = -CUDART_INF_F;
  float l = 0.f;

  for (int t = 0; t < kend; ++t) {
    const int k0 = t * kTile;
    __syncthreads();  // the previous tile's K/V are no longer read
    load_tile<T, D>(k_s, k + (static_cast<size_t>(bh) * sk + k0) * D, kTile, sk - k0, tid,
                    kThreads);
    load_tile<T, D>(v_s, v + (static_cast<size_t>(bh) * sk + k0) * D, kTile, sk - k0, tid,
                    kThreads);
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
      p_w[r * LDP + c] = Traits<T>::from_f32(p);  // p in V's dtype
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
  T* o_row = o + (static_cast<size_t>(bh) * sq + q0 + row) * D;
  for (int c = half * kHalfD; c < (half + 1) * kHalfD; ++c)
    o_row[c] = Traits<T>::from_f32(o_w[r * LDO + c] / l_safe);
  if (half == 0)
    lse[static_cast<size_t>(bh) * sq + q0 + row] = l == 0.f ? -CUDART_INF_F : m + logf(l_safe);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int bh, int sq,
           int sk, int q_offset, int k_offset, int causal, int walk_cut, float scale,
           cudaStream_t stream) {
  using L = FwdSmem<T, D>;
  static const cudaError_t attr = allow_smem(flash_fwd_kernel<T, D>, L::total);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(tiles_of(sq, L::kTile), bh);
  flash_fwd_kernel<T, D><<<grid, L::kWarps * 32, L::total, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, sq, sk, q_offset, k_offset, causal, walk_cut, scale);
  return 0;
}

template <typename T>
int dispatch(int head_dim, const void* q, const void* k, const void* v, void* o, float* lse,
             int bh, int sq, int sk, int q_offset, int k_offset, int causal, int walk_cut,
             float scale, cudaStream_t stream) {
  switch (head_dim) {
    case 64:
      return launch<T, 64>(q, k, v, o, lse, bh, sq, sk, q_offset, k_offset, causal, walk_cut,
                           scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, bh, sq, sk, q_offset, k_offset, causal, walk_cut,
                            scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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
  if (dtype == 0)
    rc = dispatch<float>(head_dim, q, k, v, o, lse_f, bh, sq, sk, q_offset, k_offset, causal,
                         walk_cut, scale, s);
  else if (dtype == 1)
    rc = dispatch<__nv_bfloat16>(head_dim, q, k, v, o, lse_f, bh, sq, sk, q_offset, k_offset,
                                 causal, walk_cut, scale, s);
  else
    rc = static_cast<int>(cudaErrorInvalidValue);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
