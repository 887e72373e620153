// W8A8 (int8 activation x int8 weight) matmul at prefill rows, on the int8
// tensor cores, with exact int32 sums and the dequantizing epilogue.
//
// Replaces trtllm_llama_tpu/ops/pallas/w8a8_matmul.py::w8a8_matmul_stacked_2d
// (:113; entry w8a8_matmul_stacked :181) and, on a unit layer axis,
// w8a8_matmul_2d (:58; entry w8a8_matmul :103) at the row counts of a
// prefill: calls of at least W8A8_GEMM_MIN_ROWS rows
// (ops/kernels/w8a8_matmul.py, w8a8_gemm_route); the dp4a kernel of
// w8a8_matmul.cu keeps the rows below.
//
// Computes, for one layer of the stacked weight q[L, K, N] int8:
//   acc[m, n] = sum_k int32(xq[m, k]) * int32(q[k, n])   exact in int32, as
//               the TPU kernel's preferred_element_type=int32 (|acc| <=
//               128 * 128 * K < 2^31; f32 sums would round past 2^24)
//   y[m, n]   = (f32(acc) * s_x[m * sx_step]) * s_w[n * sw_step]
// and returns y as f32 [M, N]: bit for bit the plain version's.
//
// What bounds it on the H100: int8 operations. The product does 2 M
// operations per weight byte, and the tensor cores (1979 TOP/s) outrun HBM
// (3.35 TB/s) above ~590 operations per byte: from ~300 rows on the
// operations bound it (at 1024 rows 0.0521 ms for the fused qkv). The
// design, for the operations:
//   - wgmma (sm_90a) m64n128k32 .s32.s8.s8: int32 accumulators in registers,
//     64 a thread per 64-row fragment; K tiles of 128 (one 128-byte swizzle
//     row of int8), 4 MMAs a fragment and tile. Block tiles of 128 x 128
//     (two warpgroups of one fragment, a 4-stage ring) or, where that takes
//     fewer waves of blocks (the wrapper decides from the shape: M = 1024
//     on every LLaMA-7B projection), 256 x 128 (two fragments a warpgroup,
//     a 3-stage ring): each transposed weight tile then feeds twice the
//     rows, 1.3x faster at 1024 and 8192 rows. The skeleton is
//     woq_gemm.cuh's: its cp.async helpers, descriptors, wgmma fences,
//     M raster and split-K rule;
//   - the layout: for .s8, wgmma reads both operands from shared memory
//     K-major only (the transpose bits exist for f16 / bf16 alone, and
//     ldmatrix's .trans moves 16-bit elements). x [M, K] is K-major as
//     stored; the weight [K, N] is N-contiguous and is read as it is (the
//     dp4a kernel reads the same bytes at decode; a K-major copy would
//     double the 6.5 GB of LLaMA-7B's weights). Of the two ways round,
//     swapping the operands (Y^T = W^T x^T with the weight as a register A
//     operand, gathered by byte transposes) and transposing each raw tile
//     in shared memory, this takes the second: both operands stay on
//     wgmma's descriptor path, the epilogue keeps x's row order, and the
//     byte permutes are the same. It sits where woq_gemm.cuh decodes:
//       * cp.async brings each K tile's x tile (128B-swizzled) and raw
//         weight tile [128 K][128 N] into the ring;
//       * the block's 256 threads turn the next raw tile into a K-major,
//         128B-swizzled [128 N][128 K] tile while the tensor cores run the
//         current tile's MMAs: a thread takes 16 K rows x 4 columns (16
//         4-byte loads, 4x4 byte transposes with __byte_perm, one 16-byte
//         store a column), the rows' bytes rotated first so that the 8
//         lanes of a store phase write 8 distinct bank groups;
//   - split-K only while the grid has fewer output tiles than SMs (M <= 128
//     at N = 4096), over whole K tiles; the int32 partials add exactly, in
//     a fixed order, in a second launch that also scales (w8a8.cuh).
// Ragged M is zero-filled on load and masked on store; N % 16 == 0 and K
// in whole 128-column tiles (the wrapper refuses other shapes before
// launch; LLaMA-7B's K of 4096 and 11008 are 32 and 86 tiles).
#include "w8a8.cuh"
#include "woq_gemm.cuh"

using namespace tllm;
using gemm::cp_async16;
using gemm::cp_async_commit;
using gemm::cp_async_wait;
using gemm::fence_async_smem;
using gemm::make_desc;
using gemm::smem_addr;

namespace {

constexpr int kBN = 128;      // output columns per block
constexpr int kBK = 128;      // K per tile: one 128-byte swizzle row
constexpr int kThreads = 256;
constexpr int kTile = kBN * kBK;  // 16 KB: a raw or a transposed weight tile

// The block tile: MF 64-row fragments a warpgroup (rows per block 128 MF)
// and a ring of STAGES x and raw weight tiles. MF = 2 feeds each
// transposed weight tile to twice the rows (half the transposes and weight
// loads per output) for twice the accumulators; the wrapper takes it
// where it needs fewer waves of blocks.
template <int MF>
struct Cfg {
  static constexpr int kBM = 128 * MF;
  static constexpr int kStages = MF == 1 ? 4 : 3;
  static constexpr int kXTile = kBM * kBK;
  static constexpr int kOffX = 0;
  static constexpr int kOffW = kOffX + kStages * kXTile;
  static constexpr int kOffB = kOffW + kStages * kTile;
  // + 1024: the base is rounded up to the 1024-byte swizzle period
  static constexpr int kSmemBytes = kOffB + 2 * kTile + 1024;
};

__device__ __forceinline__ void fence_fragment(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define TLLM_D8(i)                                                        \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),             \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

// d += A (K-major, smem) x B (K-major, smem), 64 x 128 x 32, int8 in,
// int32 accumulators.
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], uint64_t da,
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : TLLM_D8(0), TLLM_D8(8), TLLM_D8(16), TLLM_D8(24), TLLM_D8(32),
        TLLM_D8(40), TLLM_D8(48), TLLM_D8(56)
      : "l"(da), "l"(db), "r"(1));
}
#undef TLLM_D8

// The raw tile w [128 K rows][128 N bytes] -> b, K-major [128 N rows][128 K
// bytes], 16-byte chunks XORed with the row's index in its 8-row period
// (the 128-byte swizzle). Thread: K rows 16 kc .. 16 kc + 15 (kc = its
// warp), columns 4 lane .. 4 lane + 3. Each row word is rotated right by
// rot = (lane / 2) % 4 bytes first, so output word j holds column
// (j + rot) % 4: over the 8 lanes of a 16-byte store phase, (lane % 2,
// rot) takes all 8 values, and so does the written row's index mod 8.
__device__ __forceinline__ void transpose_tile(const uint8_t* w, uint8_t* b,
                                               int tid) {
  const int lane = tid & 31;
  const int kc = tid >> 5;
  const int rot = (lane >> 1) & 3;
  uint32_t col[4][4];           // [K quad][output word]
#pragma unroll
  for (int q4 = 0; q4 < 4; ++q4) {
    uint32_t r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t v = *reinterpret_cast<const uint32_t*>(
          w + (kc * 16 + q4 * 4 + i) * kBN + lane * 4);
      r[i] = __funnelshift_r(v, v, 8 * rot);
    }
    w8a8::transpose4x4(r[0], r[1], r[2], r[3], col[q4]);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = lane * 4 + ((j + rot) & 3);
    *reinterpret_cast<uint4*>(b + n * kBK + ((kc ^ (n & 7)) << 4)) =
        make_uint4(col[0][j], col[1][j], col[2][j], col[3][j]);
  }
}

// x [M, K] int8; q [K, ldw] int8 of ONE layer, from the first of the N
// columns computed; sx / sw with their steps (0:
// one value). Block (., s) sums K tiles [s * kt_per, (s + 1) * kt_per):
// into part + s * M * N (int32, unscaled) when part is set, else dequantized
// into out.
template <int MF>
__global__ void __launch_bounds__(kThreads, 1)
    w8a8_gemm_kernel(const int8_t* __restrict__ x,
                     const int8_t* __restrict__ q,
                     const float* __restrict__ sx, int sx_step,
                     const float* __restrict__ sw, int sw_step,
                     float* __restrict__ out, int* __restrict__ part, int M,
                     int K, int N, int ldw, int kt_per) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const uint32_t sbase = smem_addr(smem);

  using C = Cfg<MF>;
  constexpr int kBM = C::kBM;
  constexpr int kStages = C::kStages;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;              // warpgroup: fragments MF wg + f
  const int warp = (tid >> 5) & 3;      // warp in the warpgroup
  const int lane = tid & 31;

  int m0, n0;
  gemm::raster(blockIdx.x, M, N, kBM, kBN, m0, n0);
  const int kt0 = blockIdx.y * kt_per;
  const int nk = min(K / kBK - kt0, kt_per);   // this block's K tiles

  auto load_tile = [&](int kt, int slot) {
    const int k0 = (kt0 + kt) * kBK;
    const uint32_t xs = sbase + C::kOffX + slot * C::kXTile;
#pragma unroll
    for (int it = 0; it < kBM * 8 / kThreads; ++it) {   // 16-byte chunks
      const int i = tid + it * kThreads;
      const int r = i >> 3;
      const int c = i & 7;
      const bool ok = m0 + r < M;
      const int8_t* src =
          x + static_cast<size_t>(ok ? m0 + r : 0) * K + k0 + c * 16;
      cp_async16(xs + r * 128 + ((c ^ (r & 7)) << 4), src, ok);
    }
    const uint32_t ws = sbase + C::kOffW + slot * kTile;
#pragma unroll
    for (int it = 0; it < kBK * 8 / kThreads; ++it) {
      const int i = tid + it * kThreads;
      const int s = i >> 3;
      const int c = i & 7;
      const bool ok = n0 + c * 16 < N;
      const int8_t* src =
          q + static_cast<size_t>(k0 + s) * ldw + (ok ? n0 + c * 16 : 0);
      cp_async16(ws + s * kBN + c * 16, src, ok);
    }
  };

  int acc[MF][64];
#pragma unroll
  for (int f = 0; f < MF; ++f)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[f][i] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_tile(s, s);
    cp_async_commit();
  }
  cp_async_wait<kStages - 2>();
  __syncthreads();
  transpose_tile(smem + C::kOffW, smem + C::kOffB, tid);
  fence_async_smem();
  __syncthreads();

  for (int kt = 0; kt < nk; ++kt) {
    const int slot = kt % kStages;
    const uint32_t b = sbase + C::kOffB + (kt & 1) * kTile;
    gemm::wgmma_fence();
#pragma unroll
    for (int f = 0; f < MF; ++f) fence_fragment(acc[f]);
#pragma unroll
    for (int f = 0; f < MF; ++f) {
      const uint32_t a =
          sbase + C::kOffX + slot * C::kXTile + (wg * MF + f) * 64 * 128;
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk)
        wgmma_m64n128k32_s8(acc[f], make_desc(a + kk * 32, 16, 1024),
                            make_desc(b + kk * 32, 16, 1024));
    }
    gemm::wgmma_commit();

    // while the tensor cores run: prefetch tile kt + 3, transpose kt + 1
    if (kt + kStages - 1 < nk)
      load_tile(kt + kStages - 1, (kt + kStages - 1) % kStages);
    cp_async_commit();
    if (kt + 1 < nk) {
      cp_async_wait<kStages - 2>();
      __syncthreads();
      transpose_tile(smem + C::kOffW + ((kt + 1) % kStages) * kTile,
                     smem + C::kOffB + ((kt + 1) & 1) * kTile, tid);
    }
    gemm::wgmma_wait_all();
#pragma unroll
    for (int f = 0; f < MF; ++f) fence_fragment(acc[f]);
    fence_async_smem();
    __syncthreads();
  }
  cp_async_wait<0>();

  // fragment f of warpgroup wg: rows 64 (MF wg + f) + warp * 16 + lane / 4
  // (+ 8), columns 8 j + 2 (lane % 4) (+ 1)
  if (part != nullptr) part += static_cast<size_t>(blockIdx.y) * M * N;
#pragma unroll
  for (int f = 0; f < MF; ++f) {
    const int row = m0 + (wg * MF + f) * 64 + warp * 16 + (lane >> 2);
    const float sx0 = part == nullptr && row < M ? sx[row * sx_step] : 0.f;
    const float sx1 =
        part == nullptr && row + 8 < M ? sx[(row + 8) * sx_step] : 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n0 + j * 8 + (lane & 3) * 2;
      if (col >= N) continue;
      const int* a = acc[f] + 4 * j;
#pragma unroll
      for (int h = 0; h < 2; ++h) {           // rows row, row + 8
        const int r = row + 8 * h;
        if (r >= M) continue;
        const size_t at = static_cast<size_t>(r) * N + col;
        if (part != nullptr) {
          *reinterpret_cast<int2*>(part + at) = make_int2(a[2 * h],
                                                          a[2 * h + 1]);
        } else {
          const float s = h ? sx1 : sx0;
          *reinterpret_cast<float2*>(out + at) =
              make_float2(w8a8::dequant(a[2 * h], s, sw[col * sw_step]),
                          w8a8::dequant(a[2 * h + 1], s,
                                        sw[(col + 1) * sw_step]));
        }
      }
    }
  }
}

template <int MF>
cudaError_t launch(const void* x, const void* q, const void* sx, int sx_step,
                   const void* sw, int sw_step, void* out, void* part, int M,
                   int K, int N, int ldw, int ksplit, int kt_per,
                   cudaStream_t s) {
  constexpr int kBM = Cfg<MF>::kBM;
  cudaError_t err = allow_smem(w8a8_gemm_kernel<MF>, Cfg<MF>::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN), ksplit);
  w8a8_gemm_kernel<MF><<<grid, kThreads, Cfg<MF>::kSmemBytes, s>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(sx), sx_step, static_cast<const float*>(sw),
      sw_step, static_cast<float*>(out), static_cast<int*>(part), M, K, N,
      ldw, kt_per);
  err = cudaGetLastError();
  if (err != cudaSuccess || ksplit == 1) return err;
  return w8a8::launch_reduce(part, sx, sx_step, sw, sw_step, out, M, N,
                             ksplit, s);
}

}  // namespace

// x [M, K] int8 (16-byte aligned), q [K, ldw] int8 of ONE layer and sw its
// scales (the wrapper offsets the stacked arrays, and for a window [start,
// start + N) of the ldw columns q and a per-channel sw by start, a multiple
// of 128; ldw == N for the whole); sx [M] (sx_step 1) or
// [1] (sx_step 0), sw [N] (sw_step 1) or [1] (sw_step 0); out [M, N] f32;
// part [ksplit, M, N] int32 scratch (null when ksplit == 1); kt_per: K
// tiles of 128 per split; rows_tile: rows per block tile, 128 or 256
// (ksplit 1). K % 128 == 0, N % 16 == 0.
extern "C" int tllm_w8a8_gemm(const void* x, const void* q, const void* sx,
                              int sx_step, const void* sw, int sw_step,
                              void* out, void* part, int M, int K, int N,
                              int ldw, int ksplit, int kt_per, int rows_tile,
                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (M <= 0 || K <= 0 || K % kBK || N <= 0 || N % 16 || ldw < N ||
      ksplit < 1 ||
      kt_per < 1 || (ksplit - 1) * kt_per >= K / kBK ||
      (ksplit > 1) != (part != nullptr) ||
      (rows_tile != 128 && (rows_tile != 256 || ksplit != 1)))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return rows_tile == 256
             ? launch<2>(x, q, sx, sx_step, sw, sw_step, out, part, M, K, N,
                         ldw, ksplit, kt_per, s)
             : launch<1>(x, q, sx, sx_step, sw, sw_step, out, part, M, K, N,
                         ldw, ksplit, kt_per, s);
}
