// Hopper (sm_90a) pieces of the flash kernels (flash_fwd.cu, flash_bwd.cu):
// TMA tile loads from 3-D tensor maps, mbarriers guarding a ring of
// shared-memory stages, register reallocation between warpgroups, and wgmma
// products with f32 accumulators in registers; for bf16, and for f32 as
// split-TF32 products (the last section).
//
// Tiles. A bf16 tensor [BH, S, D] is loaded by TMA as boxes of rows x 64
// columns (128 bytes, the width of the 128-byte swizzle), one bh at a time:
// the map is 3-D, so a box that runs past S is filled with zeros instead of
// reading the next head's rows. A tile of `rows` x D lands in shared memory
// as D / 64 panels of rows x 128 bytes, each swizzled as TMA writes it
// (16-byte chunk c of row r at chunk c ^ (r % 8)) and 1024-byte aligned.
//
// Products. wgmma.mma_async m64nNk16, bf16 in, f32 out, computes for one
// warpgroup D[64 x N] (+)= A[64 x 16] B[16 x N] per instruction. Its
// accumulator gives thread t of warp w rows 16w + t/4 and 16w + t/4 + 8 and,
// in each 8-column group j, columns 8j + 2(t%4) and the one after it:
// d[4j + 0, 1] on the first row, d[4j + 2, 3] on the second. That is the
// layout of an A operand held in registers (k16 step s takes d[8s .. 8s + 7]
// packed in pairs), so a product's accumulator, rounded to bf16, feeds the
// next product directly. A and B come from shared memory through 64-bit
// descriptors of a panel:
// - K-major (the reduced dimension runs along the 128-byte rows: Q and K in
//   Q K^T): 8-row groups 1024 bytes apart; a k16 step moves 32 bytes along
//   the row, and the next 64 columns are the next panel;
// - MN-major (the reduced dimension runs down the rows: V in P V, dO and Q
//   in P^T dO and dS^T Q): 8-row groups 1024 bytes apart, a k16 step moves
//   16 rows (2048 bytes), and the next 64 output columns are the next panel
//   (the leading byte offset).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: the encoder is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <cstdint>

namespace hopper {

// ---- host: tensor maps --------------------------------------------------------

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// cuTensorMapEncodeTiled, looked up in libcuda.so.1, which the CUDA runtime
// has already loaded (so that nothing links against libcuda at build time).
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_LAZY | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_LAZY);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// A map of the contiguous tensor [bh, rows, cols] of `esize`-byte elements
// for boxes of box_rows x 128 bytes with the 128-byte swizzle. Returns 0, or
// a cudaError_t code.
inline int encode_map(CUtensorMap* map, CUtensorMapDataType type, int esize, const void* base,
                      int bh, int rows, int cols, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSharedObjectSymbolNotFound);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(bh)};
  // bytes between rows and between heads (the innermost stride is implicit)
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * esize,
                                 static_cast<cuuint64_t>(rows) * cols * esize};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(128 / esize),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode(map, type, 3, const_cast<void*>(base), dims, strides, box, step,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);  // zeros past the end
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// A map of the contiguous bf16 tensor [bh, rows, d] for boxes of box_rows x
// 64 columns (128 bytes).
inline int make_map(CUtensorMap* map, const void* base, int bh, int rows, int d, int box_rows) {
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, bh, rows, d, box_rows);
}

// A map of the contiguous f32 tensor [bh, rows, cols] for boxes of box_rows
// x 32 columns (128 bytes).
inline int make_map_f32(CUtensorMap* map, const void* base, int bh, int rows, int cols,
                        int box_rows) {
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, base, bh, rows, cols, box_rows);
}

// ---- device: addresses, barriers, TMA ----------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the dynamic shared memory rounded up to 1024 bytes (the swizzle atom)
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_addr(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// make the initialised barriers visible to the async proxy (TMA) and to
// every thread; then __syncthreads()
__device__ __forceinline__ void fence_bar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// this phase also waits for `bytes` from TMA
__device__ __forceinline__ void bar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

// arrive, and wait for `bytes` from TMA in this phase
__device__ __forceinline__ void bar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// one box (box_rows x 64 columns at column c0, row r0 of head bh) into
// shared memory, completing on `bar`
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                        int r0, int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(r0), "r"(bh)
      : "memory");
}

// a kRows x D tile (rows r0.., head bh) as D / 64 panels of kRows x 64
template <int D, int kRows>
__device__ __forceinline__ void tma_tile(__nv_bfloat16* dst, const CUtensorMap* map,
                                         uint64_t* bar, int r0, int bh) {
#pragma unroll
  for (int p = 0; p < D / 64; ++p) tma_box(dst + p * kRows * 64, map, bar, p * 64, r0, bh);
}

template <int D, int kRows>
constexpr uint32_t tile_bytes() {
  return kRows * D * 2;
}

// ---- device: warpgroups -------------------------------------------------------

// registers per thread of this warpgroup (all four warps execute it)
template <int kRegs>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// ---- device: wgmma ------------------------------------------------------------

__device__ __forceinline__ uint64_t descriptor(const void* p, uint32_t lbo_bytes) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFFu) >> 4) |
         static_cast<uint64_t>(lbo_bytes >> 4) << 16 |
         static_cast<uint64_t>(1024u >> 4) << 32 |  // 8-row groups 1024 bytes apart
         1ull << 62;                                // 128-byte swizzle
}

// a K-major operand starting at p (the leading offset is unused)
__device__ __forceinline__ uint64_t desc_k(const void* p) { return descriptor(p, 16); }

// an MN-major operand starting at p whose next 64 MN columns lie
// panel_bytes further
__device__ __forceinline__ uint64_t desc_mn(const void* p, uint32_t panel_bytes) {
  return descriptor(p, panel_bytes);
}

__device__ __forceinline__ void mma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void mma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void mma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from touching registers that an async wgmma reads or
// writes across this point (an accumulator before its wait, an A fragment)
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void hold(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// 2^x in one MUFU instruction (relative error ~2^-22; results below f32's
// normal range flush to 0)
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two f32 values rounded to bf16 (round to nearest even), packed low first
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The accumulator d[N/2] of a 64 x N product, rounded to bf16, as the A
// operand of N/16 k16 steps.
template <int N>
__device__ __forceinline__ void to_a_operand(const float (&d)[N / 2], uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int s = 0; s < N / 16; ++s)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[s][j] = pack_bf16(d[8 * s + 2 * j], d[8 * s + 2 * j + 1]);
}

// D[64 x 64] (+)= A * B, A and B K-major in shared memory
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t a, uint64_t b,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D[64 x 128] (+)= A * B, A and B K-major in shared memory
__device__ __forceinline__ void mma_ss_n128(float (&d)[64], uint64_t a, uint64_t b,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D[64 x 64] += A * B, A in registers, B MN-major in shared memory
__device__ __forceinline__ void mma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D[64 x 128] += A * B, A in registers, B MN-major in shared memory
__device__ __forceinline__ void mma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


// D[64 x N] (+)= A B with A and B K-major in shared memory
template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int accumulate) {
  if constexpr (N == 64)
    mma_ss_n64(d, a, b, accumulate);
  else
    mma_ss_n128(d, a, b, accumulate);
}

// D[64 x N] += A B with A in registers and B MN-major in shared memory
template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 64)
    mma_rs_n64(d, a, b);
  else
    mma_rs_n128(d, a, b);
}

// ---- split-TF32: f32 products on the tensor cores ----------------------------
//
// TF32 keeps 10 of f32's 23 mantissa bits, so one TF32 product misses f32 by
// ~2^-11 relative. Each f32 operand x is written as hi + lo, hi = tf32(x)
// and lo = tf32(x - hi) (cvt.rna: round to nearest, ties away from zero, on
// the 13 dropped bits), and a product A B as A_hi B_lo + A_lo B_hi + A_hi
// B_hi into one f32 accumulator: three tensor-core products, the small ones
// first. What is left out, A_lo B_lo and lo's own rounding, is ~2^-22 of
// |A||B| per term. hi and lo are exact tf32 values, so no product depends on
// how the tensor cores treat the 13 bits that tf32 drops.
//
// Tiles. An f32 tile is loaded by TMA as boxes of rows x 32 columns (128
// bytes, make_map_f32), so a tile of `rows` x C lands as C / 32 panels of
// rows x 128 bytes with the 128-byte swizzle, as a bf16 tile of 64 columns
// does. A k8 step of a tf32 wgmma moves 32 bytes along the row, as a k16
// step of a bf16 one does, so desc_k describes both. tf32 wgmma takes shared
// memory operands only K-major (it has no transpose bit): a product whose
// reduced dimension runs down the rows (P V) needs its B stored transposed.
//
// Register operands. A tf32 A fragment of a k8 step gives thread t of warp w
// rows 16w + t/4 and 16w + t/4 + 8 at k indices t%4 and t%4 + 4 (a0: row,
// t%4; a1: row + 8, t%4; a2: row, t%4 + 4; a3: row + 8, t%4 + 4), for wgmma
// and for mma.sync m16n8k8 alike. An accumulator holds columns 2(t%4) and
// 2(t%4) + 1 of each 8 instead, so to_a_tf32 reads column 8s + 2j as k index
// j and 8s + 2j + 1 as j + 4 of step s, and B's k rows must follow that
// order: k index kk of a step is column key_of(kk) of its 8. The reduced
// dimension's order is free, so the kernels store (or load) B so.

// the column of an 8-column group that k index kk (0..7) of a k8 step reads
__host__ __device__ constexpr int key_of(int kk) { return 2 * (kk & 3) + (kk >> 2); }

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, each an exact tf32 value in a .b32 register
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// The accumulator d[N/2] of a 64 x N product (or of a warp's 16 x N share),
// split into hi and lo, as the A operand of N/8 k8 steps in key_of order.
template <int N>
__device__ __forceinline__ void to_a_tf32(const float (&d)[N / 2], uint32_t (&hi)[N / 8][4],
                                          uint32_t (&lo)[N / 8][4]) {
#pragma unroll
  for (int s = 0; s < N / 8; ++s) {
    split_tf32(d[4 * s + 0], hi[s][0], lo[s][0]);  // row,     column 2(t%4)
    split_tf32(d[4 * s + 2], hi[s][1], lo[s][1]);  // row + 8, column 2(t%4)
    split_tf32(d[4 * s + 1], hi[s][2], lo[s][2]);  // row,     column 2(t%4) + 1
    split_tf32(d[4 * s + 3], hi[s][3], lo[s][3]);  // row + 8, column 2(t%4) + 1
  }
}

// kPanels boxes of kRows x 32 f32 columns, from column c0 and row r0 of head
// bh, as consecutive panels at dst
template <int kPanels, int kRows>
__device__ __forceinline__ void tma_panels(float* dst, const CUtensorMap* map, uint64_t* bar,
                                           int c0, int r0, int bh) {
#pragma unroll
  for (int p = 0; p < kPanels; ++p) tma_box(dst + p * kRows * 32, map, bar, c0 + p * 32, r0, bh);
}

// the offset (in floats) of element (r, c) of a tile of kRows rows laid out
// as TMA writes it: panel c / 32, 16-byte chunk k of row r at chunk k ^ (r % 8)
template <int kRows>
__device__ __forceinline__ int swizzled_f32(int r, int c) {
  return (c / 32) * kRows * 32 + r * 32 + ((((c % 32) >> 2) ^ (r & 7)) << 2) + (c & 3);
}

// D[64 x 16] (+)= A * B, tf32 A and B K-major in shared memory
__device__ __forceinline__ void mma_ss_tf32_n16(float (&d)[8], uint64_t a, uint64_t b,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D[64 x 32] (+)= A * B, tf32 A and B K-major in shared memory
__device__ __forceinline__ void mma_ss_tf32_n32(float (&d)[16], uint64_t a, uint64_t b,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D[64 x 64] (+)= A * B, tf32 A and B K-major in shared memory
__device__ __forceinline__ void mma_ss_tf32_n64(float (&d)[32], uint64_t a, uint64_t b,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D[64 x 64] += A * B, tf32 A in registers, B K-major in shared memory
__device__ __forceinline__ void mma_rs_tf32_n64(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D[64 x 128] += A * B, tf32 A in registers, B K-major in shared memory
__device__ __forceinline__ void mma_rs_tf32_n128(float (&d)[64], const uint32_t (&a)[4],
                                               uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D[64 x N] (+)= A B, tf32 A and B K-major in shared memory
template <int N>
__device__ __forceinline__ void mma_ss_tf32(float (&d)[N / 2], uint64_t a, uint64_t b,
                                            int accumulate) {
  static_assert(N == 16 || N == 32 || N == 64, "no tf32 wgmma of this width here");
  if constexpr (N == 16)
    mma_ss_tf32_n16(d, a, b, accumulate);
  else if constexpr (N == 32)
    mma_ss_tf32_n32(d, a, b, accumulate);
  else
    mma_ss_tf32_n64(d, a, b, accumulate);
}

// D[64 x N] += A B, tf32 A in registers, B K-major in shared memory
template <int N>
__device__ __forceinline__ void mma_rs_tf32(float (&d)[N / 2], const uint32_t (&a)[4],
                                            uint64_t b) {
  static_assert(N == 64 || N == 128, "no tf32 wgmma of this width here");
  if constexpr (N == 64)
    mma_rs_tf32_n64(d, a, b);
  else
    mma_rs_tf32_n128(d, a, b);
}

// c[16 x 8] += a[16 x 8] b[8 x 8] for one warp (mma.sync, tf32 in, f32 out);
// b0 is row t%4, b1 row t%4 + 4 of b, both at column t/4; c as an
// accumulator's 8-column group: c[0, 1] on row t/4, c[2, 3] on row t/4 + 8
__device__ __forceinline__ void mma_sync_tf32(float* c, const uint32_t (&a)[4], uint32_t b0,
                                              uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The split pass before an f32 kernel: x [n] (n a multiple of 4) into hi
// [n], lo [n] and, with parts = 3, the rest [n], x - hi - lo, which is 0 or
// one place of x: hi + lo misses x by up to that place, since x - hi needs
// up to 12 significant bits and tf32 keeps 11.
__global__ void split_tf32_kernel(const float4* __restrict__ x, float4* __restrict__ out,
                                  size_t n4, int parts) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n4;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const float4 x4 = x[i];
    const float v[4] = {x4.x, x4.y, x4.z, x4.w};
    float h[4], l[4], r[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t hb, lb;
      split_tf32(v[e], hb, lb);
      h[e] = __uint_as_float(hb);
      l[e] = __uint_as_float(lb);
      r[e] = (v[e] - h[e]) - l[e];  // exact
    }
    out[i] = make_float4(h[0], h[1], h[2], h[3]);
    out[n4 + i] = make_float4(l[0], l[1], l[2], l[3]);
    if (parts == 3) out[2 * n4 + i] = make_float4(r[0], r[1], r[2], r[3]);
  }
}

// The same, transposed: x [bh, s, d] (d a multiple of 32) into hi and lo
// [bh, d, s8] (s8 = s rounded up to 8), each group of 8 columns in key_of
// order, zeros past s. Blocks of 32 x 8 threads move 32 x 32 tiles.
__global__ void split_tf32_t_kernel(const float* __restrict__ x, float* __restrict__ hi,
                                    float* __restrict__ lo, int s, int s8, int d) {
  __shared__ float tile[32][33];
  const int r0 = blockIdx.x * 32;  // rows of x, columns of hi and lo
  const int c0 = blockIdx.y * 32;
  const size_t b = blockIdx.z;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int r = r0 + i;
    tile[i][threadIdx.x] = r < s ? x[(b * s + r) * d + c0 + threadIdx.x] : 0.f;
  }
  __syncthreads();
  const int col = r0 + threadIdx.x;
  if (col >= s8) return;
  const int src = (threadIdx.x & ~7) + key_of(threadIdx.x & 7);
  for (int i = threadIdx.y; i < 32; i += 8) {
    uint32_t h, l;
    split_tf32(tile[src][i], h, l);
    const size_t at = (b * d + c0 + i) * s8 + col;
    hi[at] = __uint_as_float(h);
    lo[at] = __uint_as_float(l);
  }
}

// Launch the split pass of x [n] into hi = out, lo = out + n and, with
// parts = 3, the rest = out + 2n.
inline void split_tf32_launch(const void* x, float* out, size_t n, int parts,
                              cudaStream_t stream) {
  const size_t n4 = n / 4;
  const int blocks = static_cast<int>(n4 < 132u * 16 * 256 ? (n4 + 255) / 256 : 132u * 16);
  split_tf32_kernel<<<blocks, 256, 0, stream>>>(static_cast<const float4*>(x),
                                                reinterpret_cast<float4*>(out), n4, parts);
}

}  // namespace hopper
