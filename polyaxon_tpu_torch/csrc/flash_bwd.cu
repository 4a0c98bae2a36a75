// Flash-attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Two kernels, replacing the TPU kernels of polyaxon_tpu/ops/flash_attention.py
// launched by _flash_bwd:
//
// - flash_bwd_dq_kernel  <- _bwd_dq_kernel:  dQ = sum_j dS K
// - flash_bwd_dkv_kernel <- _bwd_dkv_kernel: dV = sum_i P^T dO, dK = sum_i dS^T Q
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
// Design. As in the forward, a loop inside the CTA replaces the TPU's
// sequential grid axis, and its bounds are the causal clamps: the dQ CTA of a
// q tile walks kv tiles up to the last visible one (_kv_clamp); the dK/dV CTA
// of a kv tile walks q tiles from the first that can see it (_q_clamp) to the
// end. Tiles are 64 rows in bf16 (4 warps of 16 rows), 32 in f32 (2 warps).
// The tiles streamed by the loop are staged in shared memory by the whole
// CTA; each warp computes its 16-row blocks of S and dO V^T (or, in dK/dV, of
// S^T = K Q^T and V dO^T, so that its rows are keys) with tensor-core mma, the
// elementwise P and dS on the CUDA cores (two lanes per row), and adds its
// products into f32 accumulators in shared memory. The dK/dV kernel needs
// 186 KB of shared memory at D = 128 in bf16, above the 48 KB static limit,
// so both kernels opt in to dynamic shared memory. A length that is no
// multiple of the tile ends in a partial tile: its missing q/dO/K/V rows are
// loaded as zeros, missing keys are hidden like masked ones, missing query
// rows get LSE = -inf (so P = 0 there), and missing rows are not written.
//
// Bound on the H100. dQ does 3 products (S, dO V^T, dS K) and dK/dV 4 (S,
// dO V^T, P^T dO, dS^T Q), each 2 * Sq * Sk * D FLOP before the causal half:
// at the llama-1b shape (BH 64, S 2048, D 64, bf16) 52.1 us and 69.5 us at
// 989 TFLOP/s, above their byte bounds, so the tensor cores bound both. The
// simple design is far from that for the reasons the forward gives (no
// overlap of loads and products, shared-memory round trips, 4 warps per CTA).

#include "flash_common.cuh"

namespace {

using namespace flash;

template <typename T, int D>
struct BwdSmem {
  static constexpr int kTile = Traits<T>::kTile;
  static constexpr int kWarps = kTile / 16;
  static constexpr size_t tile = pad128(sizeof(T) * kTile * ld_of<D>());  // one of q/do/k/v
  static constexpr size_t rows = pad128(sizeof(float) * kTile);           // one of lse/delta
  static constexpr size_t s = pad128(sizeof(float) * kWarps * 16 * ldf_of<kTile>());
  static constexpr size_t p = pad128(sizeof(T) * kWarps * 16 * ld_of<kTile>());
  static constexpr size_t acc = pad128(sizeof(float) * kWarps * 16 * ldf_of<D>());
  // dQ: q, do, k, v; lse, delta; S, dP; dS; dQ
  static constexpr size_t dq_total = 4 * tile + 2 * rows + 2 * s + p + acc;
  // dK/dV: the same plus P (in T) and a second accumulator
  static constexpr size_t dkv_total = 4 * tile + 2 * rows + 2 * s + 2 * p + 2 * acc;
};

// The tile's elementwise step for one lane's half row: P and dS from the f32
// products S (= q.k) and dP (= dO.v); `hidden(c)` says whether the pair at
// column c is masked (causally, or its key lies past the end), and the
// callers' maps give each column's LSE and delta. Writes dS (and P when
// p_out is set) in T.
template <typename T, int N, typename Hidden, typename LseOf, typename DeltaOf>
__device__ __forceinline__ void probs_and_ds(const float* s_row, const float* dp_row,
                                             T* p_out, T* ds_out, int half, float scale,
                                             Hidden hidden, LseOf lse_of, DeltaOf delta_of) {
  for (int c = half * (N / 2); c < (half + 1) * (N / 2); ++c) {
    const float lse = lse_of(c);
    float p = 0.f;
    if (lse != -CUDART_INF_F && !hidden(c)) p = expf(s_row[c] * scale - lse);
    if (p_out != nullptr) p_out[c] = Traits<T>::from_f32(p);  // p in dO's dtype
    ds_out[c] = Traits<T>::from_f32(p * (dp_row[c] - delta_of(c)) * scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(Traits<T>::kTile * 2)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int sq, int sk,
                    int q_offset, int k_offset, int causal, int walk_cut, float scale) {
  using L = BwdSmem<T, D>;
  constexpr int kTile = L::kTile;
  constexpr int kThreads = L::kWarps * 32;
  constexpr int LD = ld_of<D>();
  constexpr int LDS = ldf_of<kTile>();
  constexpr int LDP = ld_of<kTile>();
  constexpr int LDA = ldf_of<D>();

  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* at = smem;
  T* q_s = reinterpret_cast<T*>(at);
  T* do_s = reinterpret_cast<T*>(at += L::tile);
  T* k_s = reinterpret_cast<T*>(at += L::tile);
  T* v_s = reinterpret_cast<T*>(at += L::tile);
  float* lse_s = reinterpret_cast<float*>(at += L::tile);
  float* delta_s = reinterpret_cast<float*>(at += L::rows);
  float* s_all = reinterpret_cast<float*>(at += L::rows);
  float* dp_all = reinterpret_cast<float*>(at += L::s);
  T* ds_all = reinterpret_cast<T*>(at += L::s);
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
  T* ds_w = ds_all + warp * 16 * LDP;
  float* acc_w = acc_all + warp * 16 * LDA;

  const size_t row0 = static_cast<size_t>(bh) * sq + q0;
  load_tile<T, D>(q_s, q + row0 * D, kTile, sq - q0, tid, kThreads);
  load_tile<T, D>(do_s, dout + row0 * D, kTile, sq - q0, tid, kThreads);
  for (int i = tid; i < kTile; i += kThreads) {
    const bool in = q0 + i < sq;
    lse_s[i] = in ? lse[row0 + i] : -CUDART_INF_F;
    delta_s[i] = in ? delta[row0 + i] : 0.f;
  }
  for (int c = half * (D / 2); c < (half + 1) * (D / 2); ++c) acc_w[r * LDA + c] = 0.f;

  const int kend = kv_tiles_end(q0, kTile, tiles_of(sk, kTile), q_offset, k_offset, causal,
                                walk_cut);
  const int row = warp * 16 + r;
  const int qid = q_offset + q0 + row;

  for (int t = 0; t < kend; ++t) {
    const int k0 = t * kTile;
    __syncthreads();
    load_tile<T, D>(k_s, k + (static_cast<size_t>(bh) * sk + k0) * D, kTile, sk - k0, tid,
                    kThreads);
    load_tile<T, D>(v_s, v + (static_cast<size_t>(bh) * sk + k0) * D, kTile, sk - k0, tid,
                    kThreads);
    __syncthreads();

    warp_mma<true, kTile, D>(s_w, LDS, q_s + warp * 16 * LD, LD, k_s, LD, false);    // q k^T
    warp_mma<true, kTile, D>(dp_w, LDS, do_s + warp * 16 * LD, LD, v_s, LD, false);  // dO v^T
    __syncwarp();
    probs_and_ds<T, kTile>(
        s_w + r * LDS, dp_w + r * LDS, static_cast<T*>(nullptr), ds_w + r * LDP, half, scale,
        [&](int c) { return k0 + c >= sk || (causal && qid < k_offset + k0 + c); },
        [&](int) { return lse_s[row]; }, [&](int) { return delta_s[row]; });
    __syncwarp();
    warp_mma<false, D, kTile>(acc_w, LDA, ds_w, LDP, k_s, LD, true);  // dQ += dS K
    __syncwarp();
  }

  if (q0 + row >= sq) return;  // a row past the end of a partial tile
  T* dq_row = dq + (row0 + row) * D;
  for (int c = half * (D / 2); c < (half + 1) * (D / 2); ++c)
    dq_row[c] = Traits<T>::from_f32(acc_w[r * LDA + c]);
}

template <typename T, int D>
__global__ void __launch_bounds__(Traits<T>::kTile * 2)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int sq, int sk, int q_offset,
                     int k_offset, int causal, int walk_cut, float scale) {
  using L = BwdSmem<T, D>;
  constexpr int kTile = L::kTile;
  constexpr int kThreads = L::kWarps * 32;
  constexpr int LD = ld_of<D>();
  constexpr int LDS = ldf_of<kTile>();
  constexpr int LDP = ld_of<kTile>();
  constexpr int LDA = ldf_of<D>();

  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* at = smem;
  T* k_s = reinterpret_cast<T*>(at);
  T* v_s = reinterpret_cast<T*>(at += L::tile);
  T* q_s = reinterpret_cast<T*>(at += L::tile);
  T* do_s = reinterpret_cast<T*>(at += L::tile);
  float* lse_s = reinterpret_cast<float*>(at += L::tile);
  float* delta_s = reinterpret_cast<float*>(at += L::rows);
  float* st_all = reinterpret_cast<float*>(at += L::rows);
  float* dpt_all = reinterpret_cast<float*>(at += L::s);
  T* pt_all = reinterpret_cast<T*>(at += L::s);
  T* dst_all = reinterpret_cast<T*>(at += L::p);
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
  T* pt_w = pt_all + warp * 16 * LDP;
  T* dst_w = dst_all + warp * 16 * LDP;
  float* dk_w = dk_all + warp * 16 * LDA;
  float* dv_w = dv_all + warp * 16 * LDA;

  const size_t key0 = static_cast<size_t>(bh) * sk + k0;
  load_tile<T, D>(k_s, k + key0 * D, kTile, sk - k0, tid, kThreads);
  load_tile<T, D>(v_s, v + key0 * D, kTile, sk - k0, tid, kThreads);
  for (int c = half * (D / 2); c < (half + 1) * (D / 2); ++c) {
    dk_w[r * LDA + c] = 0.f;
    dv_w[r * LDA + c] = 0.f;
  }

  // first q tile whose last row can see this kv tile's first key
  // (_q_clamp), `walk_cut` tiles later (0 in use, 1 to plant the fault of a
  // walk that starts one q tile late)
  const int nq = tiles_of(sq, kTile);
  const int first =
      (causal ? max(floor_div(k_offset + k0 - q_offset, kTile), 0) : 0) + walk_cut;
  const int row = warp * 16 + r;  // this lane's key within the tile
  const int kid = k_offset + k0 + row;

  for (int t = first; t < nq; ++t) {
    const int q0 = t * kTile;
    const size_t qrow0 = static_cast<size_t>(bh) * sq + q0;
    __syncthreads();
    load_tile<T, D>(q_s, q + qrow0 * D, kTile, sq - q0, tid, kThreads);
    load_tile<T, D>(do_s, dout + qrow0 * D, kTile, sq - q0, tid, kThreads);
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
    probs_and_ds<T, kTile>(
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
    dk[out + c] = Traits<T>::from_f32(dk_w[r * LDA + c]);
    dv[out + c] = Traits<T>::from_f32(dv_w[r * LDA + c]);
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

template <typename T, int D>
int launch_dq(const Args& a) {
  using L = BwdSmem<T, D>;
  static const cudaError_t attr = allow_smem(flash_bwd_dq_kernel<T, D>, L::dq_total);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  flash_bwd_dq_kernel<T, D><<<dim3(tiles_of(a.sq, L::kTile), a.bh), L::kWarps * 32,
                              L::dq_total, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(a.dq), a.sq, a.sk,
      a.q_offset, a.k_offset, a.causal, a.walk_cut, a.scale);
  return 0;
}

template <typename T, int D>
int launch_dkv(const Args& a) {
  using L = BwdSmem<T, D>;
  static const cudaError_t attr = allow_smem(flash_bwd_dkv_kernel<T, D>, L::dkv_total);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  flash_bwd_dkv_kernel<T, D><<<dim3(tiles_of(a.sk, L::kTile), a.bh), L::kWarps * 32,
                               L::dkv_total, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.sq, a.sk, a.q_offset, a.k_offset, a.causal, a.walk_cut,
      a.scale);
  return 0;
}

template <bool kDq, typename T>
int dispatch(int head_dim, const Args& a) {
  switch (head_dim) {
    case 64:
      return kDq ? launch_dq<T, 64>(a) : launch_dkv<T, 64>(a);
    case 128:
      return kDq ? launch_dq<T, 128>(a) : launch_dkv<T, 128>(a);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool kDq>
int run(int head_dim, int dtype, const Args& a) {
  if (a.bh <= 0 || a.sq <= 0 || a.sk <= 0 || a.walk_cut < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // start from a clean error state
  int rc;
  if (dtype == 0)
    rc = dispatch<kDq, float>(head_dim, a);
  else if (dtype == 1)
    rc = dispatch<kDq, __nv_bfloat16>(head_dim, a);
  else
    rc = static_cast<int>(cudaErrorInvalidValue);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
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

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
