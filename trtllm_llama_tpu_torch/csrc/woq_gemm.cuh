// Weight-only stacked matmul at prefill rows, on the tensor cores: one body
// for every weight format (int8, packed int4 and e4m3 codes), instantiated
// by woq_gemm.cu (int8, int4) and fp8_gemm.cu (fp8).
//
// Replaces trtllm_llama_tpu/ops/pallas/woq_matmul.py::woq_matmul_stacked_2d
// (:461; entries woq_matmul_stacked :617 and fp8_matmul_stacked :654, and
// on a unit layer axis woq_matmul :416 and fp8_matmul :646) at the row
// counts of a prefill: the TPU kernel tiles M up to 256 rows and feeds the
// MXU with a dot of the decoded block; the GEMV of woq_gemv.cuh keeps the
// decode rows.
//
// Computes, for one layer of the stacked weight (no prologue, no epilogue:
// the paths compose those as plain ops above 16 rows):
//   acc = sum_k f32(x[m, k]) * f32(code[k, n])     f32 accumulators
//   y   = acc * scale[n]                           per-channel, after the sum
//   y   = sum_g scale[g, n] * (sum_{k in g} ...)   grouped, g = 128 K rows
// and returns y as f32 [M, N]. int8 and int4 codes and e4m3 values are
// exact in bf16 and fp16, so the tensor cores form the same products as
// the plain version; only the order of the f32 sum differs.
//
// What bounds it on the H100: operations above ~300 rows (a [M, K] x [K, N]
// product does 2*M flops per weight byte; the bf16 tensor cores need ~295
// per HBM byte), the weight bytes below. The design, for the operations:
//   - wgmma (sm_90a) m64n128k16, bf16 or fp16 in, f32 accumulators in
//     registers; a block tile of 128 x 128 with two warpgroups of 64 rows;
//   - wgmma reads B only from shared memory, so the codes are the operand
//     to dequantize there (the route taken; CUTLASS's mixed-input route,
//     Y^T = W^T x^T with the decoded weight as a register A operand, needs
//     the decoded tile in the register fragment's order and gains nothing
//     once the decode is overlapped with the MMAs as below):
//       * cp.async brings the x tile (bf16 / fp16, 128B-swizzled, K-major)
//         and the raw code tile (1 or 0.5 bytes an element) of each K tile
//         into a 3-stage ring (TMA would need a tensor map encoded for
//         each call's layer and activation through the driver API);
//       * the block's 256 threads decode the next K tile's codes into a
//         second bf16 / fp16 B buffer (N-major, 128B-swizzled, the stored
//         [K, N] read through wgmma's transpose bit) while the tensor cores
//         run the current tile's MMAs (issued asynchronously before);
//       * the decode runs once per M tile: one conversion per 128 MACs;
//   - K tiles are 128 logical rows: whole int4 pack blocks, fp8 interleave
//     blocks and scale groups. The stored orders are read as they are (no
//     repack at load): each stored slot's logical row comes from a
//     128-entry map that the wrapper builds (ops/kernels/woq_matmul.py,
//     tile_rows), so the decoded tile lands in logical row order and x's
//     tile loads untouched;
//   - grouped scales (one group per K tile): the tile's MMAs run into a
//     zeroed group accumulator, then acc += gacc * scale[g, n] in registers
//     (two 64-float fragments a thread);
//   - no split-K at prefill sizes (M = 1024 gives >= 256 tiles); only a
//     grid of fewer tiles than SMs (M <= 128 on N = 4096) splits K over
//     whole tiles, reduced in a fixed order by a second launch. The tiles
//     are ordered in groups of 8 M tiles so that the blocks resident at
//     once share weight columns (read from HBM about once) and x rows.
// Ragged M is zero-filled on load and masked on store; N % 16 == 0. K is
// whole 16-row mma steps: a K that is not whole tiles (GPT-2 XL's 1600, 12.5
// tiles) runs a last tile whose x columns and code rows past K are
// zero-filled on load, so their products add exact zeros and the call
// equals the same call on operands zero-padded to whole tiles bit for bit;
// grouped scales need whole tiles (the wrapper refuses other shapes before
// launch).
// Measured (PERF.md, gemm_breakdown.py): 34-38% of the operations bound at
// 1024-8192 rows. The loads into shared memory (x is re-read for every
// 128 output columns) and the decode's shared-memory traffic bound it,
// not the tensor cores; a 64-row K tile with a deeper ring was slower.
#pragma once

#include "wgmma.cuh"
#include "woq_gemv.cuh"

namespace tllm {
namespace gemm {

constexpr int kBM = 128;        // rows per block: two warpgroups of 64
constexpr int kBN = 128;        // output columns per block
constexpr int kBK = 128;        // logical K rows per tile
constexpr int kStages = 3;      // cp.async ring of x and code tiles
constexpr int kThreads = 256;
constexpr int kGroupM = 8;      // M tiles per raster group

constexpr int kATile = kBM * kBK * 2;     // x tile: two 64-column K atoms
constexpr int kBTile = kBK * kBN * 2;     // decoded tile: two 64-column N atoms
constexpr int kCodeTile = kBK * kBN;      // raw codes (int4 uses half)
constexpr int kScaleTile = kBN * 4;       // one group's scales
constexpr int kOffA = 0;
constexpr int kOffB = kOffA + kStages * kATile;
constexpr int kOffCode = kOffB + 2 * kBTile;
constexpr int kOffScale = kOffCode + kStages * kCodeTile;
constexpr int kOffMap = kOffScale + kStages * kScaleTile;
// + 1024: the base is rounded up to the 1024-byte swizzle period
constexpr int kSmemBytes = kOffMap + kBK + 1024;

// The output tile of block `b`: groups of kGroupM M tiles of bm rows, M
// fastest inside a group, so the blocks resident at once share weight
// columns and x rows. Sets the tile's first row m0 and column n0.
__device__ __forceinline__ void raster(int b, int M, int N, int bm, int bn,
                                       int& m0, int& n0) {
  const int n_mt = (M + bm - 1) / bm;
  const int n_nt = (N + bn - 1) / bn;
  const int per_group = kGroupM * n_nt;
  const int group = b / per_group;
  const int first_mt = group * kGroupM;
  const int g_rows = min(n_mt - first_mt, kGroupM);
  const int in_group = b - group * per_group;
  m0 = (first_mt + in_group % g_rows) * bm;
  n0 = (in_group / g_rows) * bn;
}

// Columns 16c .. 16c + 15 of logical row r of the decoded tile (p: 8 pairs).
// The tile is two N atoms of [kBK rows][128 bytes], 16-byte chunks XORed
// with the row's index in its 8-row period (the 128-byte swizzle). A
// thread in atom 1 writes its second chunk first, so the 8 threads of a
// store phase (one row, c = 0..7) hit 8 distinct bank groups.
__device__ __forceinline__ void store_row(uint8_t* b, int r, int c,
                                          const uint32_t (&p)[8]) {
  const int na = c >> 2;
  const int q0 = (c & 3) * 2;
  uint8_t* row = b + na * (kBK * 128) + r * 128;
  const uint4 v0 = make_uint4(p[0], p[1], p[2], p[3]);
  const uint4 v1 = make_uint4(p[4], p[5], p[6], p[7]);
  const int qa = q0 + na;
  const int qb = q0 + 1 - na;
  *reinterpret_cast<uint4*>(row + ((qa ^ (r & 7)) << 4)) = na ? v1 : v0;
  *reinterpret_cast<uint4*>(row + ((qb ^ (r & 7)) << 4)) = na ? v0 : v1;
}

// Decode one K tile's raw codes into the B buffer in logical row order.
// map[slot]: logical row (in the tile) of stored slot `slot` (stored row;
// int4: 2 * stored row + nibble).
template <typename T, int FMT>
__device__ __forceinline__ void decode_tile(const uint8_t* codes, uint8_t* b,
                                            const uint8_t* map, int tid) {
  constexpr int kRows = FMT == gemv::kInt4 ? kBK / 2 : kBK;  // stored rows
#pragma unroll
  for (int it = 0; it < kRows * 8 / kThreads; ++it) {
    const int i = tid + it * kThreads;
    const int s = i >> 3;
    const int c = i & 7;
    const uint4 w = *reinterpret_cast<const uint4*>(codes + s * kBN + c * 16);
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
    if constexpr (FMT == gemv::kInt4) {
      uint32_t lo[8], hi[8];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        float l0, h0, l1, h1;
        gemv::int4_codes(words[v], 0, l0, h0);
        gemv::int4_codes(words[v], 1, l1, h1);
        lo[2 * v] = pack2<T>(l0, l1);
        hi[2 * v] = pack2<T>(h0, h1);
        gemv::int4_codes(words[v], 2, l0, h0);
        gemv::int4_codes(words[v], 3, l1, h1);
        lo[2 * v + 1] = pack2<T>(l0, l1);
        hi[2 * v + 1] = pack2<T>(h0, h1);
      }
      store_row(b, map[2 * s], c, lo);
      store_row(b, map[2 * s + 1], c, hi);
    } else {
      uint32_t p[8];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        float f0, f1, f2, f3;
        if constexpr (FMT == gemv::kFp8) {
          gemv::fp8x2(words[v], f0, f1);
          gemv::fp8x2(words[v] >> 16, f2, f3);
        } else {
          f0 = gemv::int8_code(words[v], 0);
          f1 = gemv::int8_code(words[v], 1);
          f2 = gemv::int8_code(words[v], 2);
          f3 = gemv::int8_code(words[v], 3);
        }
        p[2 * v] = pack2<T>(f0, f1);
        p[2 * v + 1] = pack2<T>(f2, f3);
      }
      store_row(b, map[s], c, p);
    }
  }
}

// q: stored codes of ONE layer (int8 / e4m3 [K, ldw], int4 [K/2, ldw]);
// scale f32 [N] or, GROUPED, [K/128, ldw]; both from the first of the N
// columns computed (a window of the ldw: the wrapper offsets them); map: 128
// bytes (tile_rows). Block
// (., s) sums K tiles [s * kt_per, (s + 1) * kt_per) into out + s * M * N,
// times col_scale[n] (null: grouped, or the split-K reduce scales).
// K % 16 == 0 (whole tiles when GROUPED), N % 16 == 0, x 16-byte aligned
// (wrapper).
template <typename T, int FMT, bool GROUPED>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_kernel(const T* __restrict__ x, const uint8_t* __restrict__ q,
                const float* __restrict__ scale,
                const float* __restrict__ col_scale,
                const uint8_t* __restrict__ map_g, float* __restrict__ out,
                int M, int K, int N, int ldw, int kt_per) {
  constexpr int kR = FMT == gemv::kInt4 ? 2 : 1;   // logical rows a stored row
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const uint32_t sbase = smem_addr(smem);

  const int tid = threadIdx.x;
  const int wg = tid >> 7;              // warpgroup: rows 64 wg .. 64 wg + 63
  const int warp = (tid >> 5) & 3;      // warp in the warpgroup
  const int lane = tid & 31;

  int m0, n0;
  raster(blockIdx.x, M, N, kBM, kBN, m0, n0);
  const int kt0 = blockIdx.y * kt_per;
  // this block's K tiles (the last one of the call may be ragged)
  const int nk = min((K + kBK - 1) / kBK - kt0, kt_per);

  uint8_t* map = smem + kOffMap;
  if (tid < kBK) map[tid] = map_g[tid];

  auto load_tile = [&](int kt, int slot) {
    const int k0 = (kt0 + kt) * kBK;
    const uint32_t a = sbase + kOffA + slot * kATile;
#pragma unroll
    for (int it = 0; it < kBM * 16 / kThreads; ++it) {   // 16-byte chunks
      const int i = tid + it * kThreads;
      const int r = i >> 4;
      const int c = i & 15;
      const bool in_m = m0 + r < M;
      const bool ok = in_m && k0 + c * 8 < K;     // K % 8 == 0: whole chunks
      const T* src = x + static_cast<size_t>(in_m ? m0 + r : 0) * K +
                     (ok ? k0 + c * 8 : 0);
      cp_async16(a + (c >> 3) * (kBM * 128) + r * 128 +
                     (((c & 7) ^ (r & 7)) << 4),
                 src, ok);
    }
    const uint32_t cd = sbase + kOffCode + slot * kCodeTile;
    constexpr int kRows = kBK / kR;
#pragma unroll
    for (int it = 0; it < kRows * 8 / kThreads; ++it) {
      const int i = tid + it * kThreads;
      const int s = i >> 3;
      const int c = i & 7;
      const int srow = k0 / kR + s;                // stored row
      const bool ok = n0 + c * 16 < N && srow < K / kR;
      const uint8_t* src =
          q + static_cast<size_t>(ok ? srow : 0) * ldw + (ok ? n0 + c * 16 : 0);
      cp_async16(cd + s * kBN + c * 16, src, ok);
    }
    if constexpr (GROUPED) {
      if (tid < kBN / 4) {
        const bool ok = n0 + tid * 4 < N;
        const float* src =
            scale + static_cast<size_t>(kt0 + kt) * ldw +
            (ok ? n0 + tid * 4 : 0);
        cp_async16(sbase + kOffScale + slot * kScaleTile + tid * 16, src, ok);
      }
    }
  };

  float acc[64];
  float gacc[GROUPED ? 64 : 1];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_tile(s, s);
    cp_async_commit();
  }
  cp_async_wait<kStages - 2>();
  __syncthreads();
  decode_tile<T, FMT>(smem + kOffCode, smem + kOffB, map, tid);
  fence_async_smem();
  __syncthreads();

  for (int kt = 0; kt < nk; ++kt) {
    const int slot = kt % kStages;
    const uint32_t a = sbase + kOffA + slot * kATile + wg * 64 * 128;
    const uint32_t b = sbase + kOffB + (kt & 1) * kBTile;
    wgmma_fence();
    if constexpr (GROUPED) {
      fence_fragment(gacc);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_m64n128k16<T>(
            gacc,
            make_desc(a + (kk >> 2) * (kBM * 128) + (kk & 3) * 32, 16, 1024),
            make_desc(b + kk * 16 * 128, kBK * 128, 1024), kk > 0);
    } else {
      fence_fragment(acc);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_m64n128k16<T>(
            acc,
            make_desc(a + (kk >> 2) * (kBM * 128) + (kk & 3) * 32, 16, 1024),
            make_desc(b + kk * 16 * 128, kBK * 128, 1024), 1);
    }
    wgmma_commit();

    // while the tensor cores run: prefetch tile kt + 2, decode tile kt + 1
    if (kt + kStages - 1 < nk)
      load_tile(kt + kStages - 1, (kt + kStages - 1) % kStages);
    cp_async_commit();
    if (kt + 1 < nk) {
      cp_async_wait<kStages - 2>();
      __syncthreads();
      decode_tile<T, FMT>(smem + kOffCode + ((kt + 1) % kStages) * kCodeTile,
                          smem + kOffB + ((kt + 1) & 1) * kBTile, map, tid);
    }
    wgmma_wait_all();
    if constexpr (GROUPED) {
      fence_fragment(gacc);
      const float* sc = reinterpret_cast<const float*>(
          smem + kOffScale + slot * kScaleTile);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float2 s2 =
            *reinterpret_cast<const float2*>(sc + j * 8 + (lane & 3) * 2);
        acc[4 * j] = fmaf(gacc[4 * j], s2.x, acc[4 * j]);
        acc[4 * j + 1] = fmaf(gacc[4 * j + 1], s2.y, acc[4 * j + 1]);
        acc[4 * j + 2] = fmaf(gacc[4 * j + 2], s2.x, acc[4 * j + 2]);
        acc[4 * j + 3] = fmaf(gacc[4 * j + 3], s2.y, acc[4 * j + 3]);
      }
    } else {
      fence_fragment(acc);
    }
    fence_async_smem();
    __syncthreads();
  }
  cp_async_wait<0>();

  // the m64n128 fragment: rows warp * 16 + lane / 4 (+ 8), columns
  // 8 j + 2 (lane % 4) (+ 1)
  const int row = m0 + wg * 64 + warp * 16 + (lane >> 2);
  out += static_cast<size_t>(blockIdx.y) * M * N;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = n0 + j * 8 + (lane & 3) * 2;
    if (col >= N) continue;
    float2 s2 = make_float2(1.f, 1.f);
    if (col_scale != nullptr)
      s2 = __ldg(reinterpret_cast<const float2*>(col_scale + col));
    if (row < M)
      *reinterpret_cast<float2*>(out + static_cast<size_t>(row) * N + col) =
          make_float2(acc[4 * j] * s2.x, acc[4 * j + 1] * s2.y);
    if (row + 8 < M)
      *reinterpret_cast<float2*>(out + static_cast<size_t>(row + 8) * N +
                                 col) =
          make_float2(acc[4 * j + 2] * s2.x, acc[4 * j + 3] * s2.y);
  }
}

struct Args {
  const void* x;      // [M, K] bf16 / fp16
  const void* q;      // stored codes of the layer
  const void* scale;  // f32 [N] or [K/128, ldw]
  const void* map;    // 128 bytes: logical row of each stored slot of a tile
  void* out;          // f32 [M, N]
  void* part;         // f32 [ksplit, M, N] scratch (unused when ksplit == 1)
  int M, K, N;        // N: the columns computed (a window of ldw)
  int ldw;            // row stride of q and of grouped scales
  int ksplit, kt_per;
};

// ksplit == 1: one launch writes out (scaled). Otherwise (few output
// tiles: decode-sized M on a narrow N) the K tiles are split over
// blockIdx.y into part, and the GEMV's reduce sums the splits in a fixed
// order and applies the per-channel scale.
template <typename T, int FMT, bool GROUPED>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto kernel = gemm_kernel<T, FMT, GROUPED>;
  cudaError_t err = allow_smem(kernel, kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(((a.M + kBM - 1) / kBM) * ((a.N + kBN - 1) / kBN),
                  a.ksplit);
  const float* scale = static_cast<const float*>(a.scale);
  const bool split = a.ksplit > 1;
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(a.x), static_cast<const uint8_t*>(a.q), scale,
      GROUPED || split ? nullptr : scale, static_cast<const uint8_t*>(a.map),
      static_cast<float*>(split ? a.part : a.out), a.M, a.K, a.N, a.ldw,
      a.kt_per);
  err = cudaGetLastError();
  if (err != cudaSuccess || !split) return err;
  const size_t total = static_cast<size_t>(a.M) * a.N;
  const int threads = 256;
  gemv::reduce_kernel<T><<<static_cast<unsigned>((total + threads - 1) /
                                                 threads),
                           threads, 0, stream>>>(
      static_cast<const float*>(a.part), GROUPED ? nullptr : scale, nullptr,
      static_cast<float*>(a.out), a.M, a.N, a.ksplit);
  return cudaGetLastError();
}

template <int FMT, bool GROUPED>
cudaError_t dispatch(int dtype, const Args& a, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int k_tiles = (a.K + kBK - 1) / kBK;
  if (a.M <= 0 || a.K <= 0 || a.K % 16 || (GROUPED && a.K % kBK) ||
      a.N % 16 || a.ldw < a.N || a.ksplit < 1 ||
      (a.ksplit - 1) * a.kt_per >= k_tiles)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) return launch<__nv_bfloat16, FMT, GROUPED>(a, s);
  if (dtype == kF16) return launch<__half, FMT, GROUPED>(a, s);
  return cudaErrorInvalidValue;
}

}  // namespace gemm
}  // namespace tllm
