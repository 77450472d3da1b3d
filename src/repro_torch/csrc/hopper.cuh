// Hopper (sm_90a) building blocks shared by the port's tensor-core kernels:
// cp.async, ldmatrix and mma.sync (m16n8k16, bf16 operands, f32
// accumulators), bf16 hi + lo splits of f32 values, mbarriers, TMA tile
// loads (with the host's tensor-map encoder) and wgmma (m64n64k16) with
// shared-memory descriptors.
//
// Fragment layouts of mma.sync.m16n8k16 (g = lane / 4, t = lane % 4; each
// register holds two bf16 of consecutive k, or two f32 of consecutive n):
//   A (16 x 16, row-major): a0 (g, 2t), a1 (g + 8, 2t), a2 (g, 2t + 8),
//                           a3 (g + 8, 2t + 8)
//   B (16 x 8):             b0 (k 2t, n g), b1 (k 2t + 8, n g)
//   C (16 x 8, f32):        c0, c1 (g, 2t, 2t + 1), c2, c3 (g + 8, ...)
// wgmma.m64nNk16 gives each warp w of the warpgroup rows 16w..16w+15 in the
// C layout above, one n8 block after the other, and takes A from registers
// in the A layout above.
#pragma once
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- cp.async ---------------------------------------------------------------

// 16 bytes global -> shared, bypassing L1.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// Wait until at most one committed group is still in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// --- ldmatrix ---------------------------------------------------------------

// Four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8, and register i receives matrix i in the A/B/C element order above.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
// The same, each matrix transposed.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// A fragment (rows m0.., cols k0..) of a row-major bf16 tile a[m][k] with a
// row stride of `ld` elements.
__device__ __forceinline__ void load_a(uint32_t (&r)[4], const __nv_bfloat16* a,
                                       int ld, int m0, int k0, int lane) {
  const int j = lane >> 3, i = lane & 7;
  ldmatrix_x4(r, a + (size_t)(m0 + i + 8 * (j & 1)) * ld + k0 + 8 * (j >> 1));
}
// A fragment of the tile whose transpose is stored: at[k][m].
__device__ __forceinline__ void load_a_t(uint32_t (&r)[4], const __nv_bfloat16* at,
                                         int ld, int m0, int k0, int lane) {
  const int j = lane >> 3, i = lane & 7;
  ldmatrix_x4_trans(r, at + (size_t)(k0 + i + 8 * (j >> 1)) * ld + m0 + 8 * (j & 1));
}
// B fragments of two n8 tiles (cols n0.., n0 + 8..) from bt[n][k] (k
// contiguous): r[0], r[1] for the first tile, r[2], r[3] for the second.
__device__ __forceinline__ void load_b2(uint32_t (&r)[4], const __nv_bfloat16* bt,
                                        int ld, int n0, int k0, int lane) {
  const int j = lane >> 3, i = lane & 7;
  ldmatrix_x4(r, bt + (size_t)(n0 + i + 8 * (j >> 1)) * ld + k0 + 8 * (j & 1));
}
// The same from b[k][n] (n contiguous).
__device__ __forceinline__ void load_b2_t(uint32_t (&r)[4], const __nv_bfloat16* b,
                                          int ld, int n0, int k0, int lane) {
  const int j = lane >> 3, i = lane & 7;
  ldmatrix_x4_trans(r, b + (size_t)(k0 + i + 8 * (j & 1)) * ld + n0 + 8 * (j >> 1));
}

// --- mma.sync ---------------------------------------------------------------

// c += a . b on bf16 operands, f32 accumulators (m16n8k16).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(  // a pure register operation: the compiler may schedule it freely
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// --- bf16 ------------------------------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16(float lo_k, float hi_k) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo_k, hi_k);   // .x = lo_k
  return *reinterpret_cast<uint32_t*>(&v);
}

// x = hi + lo + O(2^-16 |x|): hi = bf16(x), lo = bf16(x - hi).
__device__ __forceinline__ void split_bf16(float x, __nv_bfloat16& hi,
                                           __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(x);
  lo = __float2bfloat16_rn(x - __bfloat162float(hi));
}
// Two consecutive-k values split into packed hi and lo registers.
__device__ __forceinline__ void split_pack(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = *reinterpret_cast<uint32_t*>(&l);
}

// --- mbarrier ----------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}
// Wait until the barrier's phase with parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra LAB_WAIT;\n"
      "}\n" ::"r"(a),
      "r"(parity)
      : "memory");
}

// --- TMA -------------------------------------------------------------------

// cuTensorMapEncodeTiled, fetched through the CUDA runtime so that a library
// needs no link against libcuda. Host code; nullptr if it cannot be found.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// One 3-d box of `map` at coordinates (c0 innermost .. c2) into shared
// memory; completion counts `box bytes` on `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// One 4-d box of `map` at coordinates (c0 innermost .. c3) into shared
// memory; completion counts `box bytes` on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// --- wgmma -----------------------------------------------------------------

// Shared-memory matrix descriptor for a tile written by TMA with 128-byte
// swizzle (rows of 128 bytes, 8-row atoms of 1,024 bytes, the tile base
// 1,024-byte aligned). K-major operands step k by +32 bytes inside the row;
// the stride between 8-row groups (SBO) is 1,024 bytes. MN-major operands
// (trans = 1) take one 128-byte row per k and the same SBO between groups of
// 8 k; the leading offset (LBO) would step to the next 64 columns, which a
// 64-wide instruction never does.
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  const uint64_t a = smem_addr(p);
  return ((a & 0x3FFFF) >> 4) | (uint64_t(1) << 16) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma that owns them.
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define HOPPER_ACC32(d)                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),      \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),             \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),         \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),         \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),         \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),         \
      "+f"(d[31])
#define HOPPER_REGS32                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "    \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "     \
  "%30, %31}"

// d (64 x 64, f32) = a . b (+ d when accumulate): A and B K-major in shared
// memory (descriptors), bf16.
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t da,
                                                   uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : HOPPER_ACC32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += a . b: A from registers (the A layout, one warp's 16 rows), B
// MN-major in shared memory (descriptor), bf16.
__device__ __forceinline__ void wgmma_rs_m64n64k16_tb(float (&d)[32],
                                                      const uint32_t (&a)[4],
                                                      uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : HOPPER_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

}  // namespace hopper
