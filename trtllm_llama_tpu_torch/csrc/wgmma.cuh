// Hopper tensor-core building blocks shared by the port's hand-written
// kernels: cp.async into shared memory, the 128-byte-swizzle wgmma
// descriptor, the wgmma fences, and the wgmma shapes the kernels issue
// (bf16 / fp16 in, f32 accumulators, sm_90a only):
//   - m64n128k16, A and B from shared memory, B N-major (the GEMMs of
//     woq_gemm.cuh and w8a8_gemm.cu);
//   - wgmma_kk: m64nNk16 (N = 32, 64), A and B from shared memory, both
//     K-major (flash_attention.cuh: S = Q K^T with K stored [keys, D]);
//   - wgmma_rs: m64nNk16 (N = 64, 128), A from registers (four 32-bit
//     pairs a thread, the m16n8k16 A layout per warp), B N-major from
//     shared memory (flash_attention.cuh: O += P V with V stored [keys, D]);
//   - wgmma_rk: m64n64k16, A from registers as wgmma_rs, B K-major from
//     shared memory (flash_attention_ws.cuh: S = Q K^T with Q held in
//     registers).
// The accumulator of m64nNk16: thread t of the warpgroup holds rows
// 16 (t / 32) + (t % 32) / 4 (+ 8) and columns 8 j + 2 (t % 4) (+ 1) in
// d[4 j .. 4 j + 3] (row, row, row + 8, row + 8).
#pragma once

#include "common.cuh"

namespace tllm {
namespace gemm {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  // src-size 0 zero-fills the 16 bytes (rows past M, columns past N)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Generic-proxy writes (st.shared, cp.async) made visible to wgmma.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Shared memory matrix descriptor, 128-byte swizzle. lbo / sbo in bytes.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

template <int N>
__device__ __forceinline__ void fence_fragment(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_operand(d[i]);
}

#define TLLM_D8(i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define TLLM_WGMMA_M64N128K16(TY)                                          \
  asm volatile(                                                            \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                         \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "         \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "  \
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "  \
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "                \
      "%64, %65, p, 1, 1, 0, 1;\n}\n"                                      \
      : TLLM_D8(0), TLLM_D8(8), TLLM_D8(16), TLLM_D8(24), TLLM_D8(32),     \
        TLLM_D8(40), TLLM_D8(48), TLLM_D8(56)                              \
      : "l"(da), "l"(db), "r"(scale_d))

// d += A (K-major, smem) x B (N-major, smem: transpose bit set), 64 x 128 x 16.
template <typename T>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db, int scale_d);
template <>
__device__ __forceinline__ void wgmma_m64n128k16<__nv_bfloat16>(
    float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  TLLM_WGMMA_M64N128K16("bf16");
}
template <>
__device__ __forceinline__ void wgmma_m64n128k16<__half>(float (&d)[64],
                                                         uint64_t da,
                                                         uint64_t db,
                                                         int scale_d) {
  TLLM_WGMMA_M64N128K16("f16");
}
#undef TLLM_WGMMA_M64N128K16

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Two exact floats -> one 32-bit pair of T (low half = a).
template <typename T>
__device__ __forceinline__ uint32_t pack2(float a, float b);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float a, float b) {
  const __half2 v = __floats2half2_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d (+)= A (K-major, smem) x B (K-major, smem), 64 x N x 16; scale_d = 0
// overwrites d.
template <typename T, int N>
__device__ __forceinline__ void wgmma_kk(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d);
// d (+)= A (registers) x B (N-major, smem: transpose bit set), 64 x N x 16.
template <typename T, int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d);

#define TLLM_WGMMA_KK_N64(TY)                                               \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "           \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                                   \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                              \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                            \
      "%24, %25, %26, %27, %28, %29, %30, %31}, "                           \
      "%32, %33, p, 1, 1, 0, 0;\n}\n"                                       \
      : TLLM_D8(0), TLLM_D8(8), TLLM_D8(16), TLLM_D8(24)                    \
      : "l"(da), "l"(db), "r"(scale_d))
#define TLLM_WGMMA_KK_N32(TY)                                               \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " "           \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                                   \
      "%8, %9, %10, %11, %12, %13, %14, %15}, "                             \
      "%16, %17, p, 1, 1, 0, 0;\n}\n"                                       \
      : TLLM_D8(0), TLLM_D8(8)                                              \
      : "l"(da), "l"(db), "r"(scale_d))
// TB: B's transpose bit, "1" for N-major B (wgmma_rs), "0" for K-major
#define TLLM_WGMMA_RS_N64(TY, TB)                                           \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "           \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                                   \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                              \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                            \
      "%24, %25, %26, %27, %28, %29, %30, %31}, "                           \
      "{%32, %33, %34, %35}, "                                              \
      "%36, p, 1, 1, " TB ";\n}\n"                                           \
      : TLLM_D8(0), TLLM_D8(8), TLLM_D8(16), TLLM_D8(24)                    \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))
#define TLLM_WGMMA_RS_N128(TY)                                              \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "          \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                                   \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                              \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                            \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                            \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                            \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                            \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                            \
      "%56, %57, %58, %59, %60, %61, %62, %63}, "                           \
      "{%64, %65, %66, %67}, "                                              \
      "%68, p, 1, 1, 1;\n}\n"                                               \
      : TLLM_D8(0), TLLM_D8(8), TLLM_D8(16), TLLM_D8(24),                   \
        TLLM_D8(32), TLLM_D8(40), TLLM_D8(48), TLLM_D8(56)                  \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))

template <>
__device__ __forceinline__ void wgmma_kk<__nv_bfloat16, 64>(
    float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  TLLM_WGMMA_KK_N64("bf16");
}
template <>
__device__ __forceinline__ void wgmma_kk<__half, 64>(
    float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  TLLM_WGMMA_KK_N64("f16");
}
template <>
__device__ __forceinline__ void wgmma_kk<__nv_bfloat16, 32>(
    float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
  TLLM_WGMMA_KK_N32("bf16");
}
template <>
__device__ __forceinline__ void wgmma_kk<__half, 32>(
    float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
  TLLM_WGMMA_KK_N32("f16");
}
template <>
__device__ __forceinline__ void wgmma_rs<__nv_bfloat16, 64>(
    float (&d)[32], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  TLLM_WGMMA_RS_N64("bf16", "1");
}
template <>
__device__ __forceinline__ void wgmma_rs<__half, 64>(
    float (&d)[32], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  TLLM_WGMMA_RS_N64("f16", "1");
}
// d (+)= A (registers) x B (K-major, smem), 64 x 64 x 16.
template <typename T>
__device__ __forceinline__ void wgmma_rk(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d);
template <>
__device__ __forceinline__ void wgmma_rk<__nv_bfloat16>(
    float (&d)[32], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  TLLM_WGMMA_RS_N64("bf16", "0");
}
template <>
__device__ __forceinline__ void wgmma_rk<__half>(
    float (&d)[32], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  TLLM_WGMMA_RS_N64("f16", "0");
}
template <>
__device__ __forceinline__ void wgmma_rs<__nv_bfloat16, 128>(
    float (&d)[64], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  TLLM_WGMMA_RS_N128("bf16");
}
template <>
__device__ __forceinline__ void wgmma_rs<__half, 128>(
    float (&d)[64], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  TLLM_WGMMA_RS_N128("f16");
}
#undef TLLM_WGMMA_KK_N64
#undef TLLM_WGMMA_KK_N32
#undef TLLM_WGMMA_RS_N64
#undef TLLM_WGMMA_RS_N128
#undef TLLM_D8

// Keep a register A operand live and unmoved until the wgmma reading it
// has completed (its registers are read asynchronously).
__device__ __forceinline__ void fence_regs(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

}  // namespace gemm
}  // namespace tllm
