// Weight-only stacked matmul of one row (decode), and of the few-row calls
// no other body takes, one body for every weight format: int8, packed int4
// and e4m3 (fp8) codes.
//
// Replaces the body of trtllm_llama_tpu/ops/pallas/woq_matmul.py
// (_kernel_int8 with its fp8 branch, _kernel_int4, the _fuse_prologue norm
// and SwiGLU modes and the _fuse_epilogue residual add) for the calls that
// ops/kernels/woq_matmul.py routes here: one row, f32 activations, and the
// layouts the tensor-core bodies do not tile. Instantiated by woq_matmul.cu
// (int8, int4) and fp8_matmul.cu (fp8), two libraries that nvcc builds in
// parallel; decode_probes.cu calls its decode functions, woq_gemv_tc.cuh
// and woq_gemm.cuh its decodes, slot_of and reduce_kernel.
//
// Computes, for one layer of the stacked weight:
//   h   = T(x * rsqrt(mean(x^2) + eps) * norm_w)   (optional norm prologue)
//   h   = T(T(silu(g)) * u), [g | u] = x [M, 2K]   (or the SwiGLU prologue:
//         silu(g) = g / (1 + exp(-g)) in f32, the product in T)
//   acc = sum_k f32(h[m, k]) * f32(w[k, n])        (f32 accumulation)
//   y   = acc * scale[n]                           per-channel, after the sum
//   y   = sum_g scale[g, n] * (sum_{k in g} ...)   grouped: per group of K rows
//   y   = T(resid + T(y))                          (optional epilogue)
// and returns y as f32 [M, N].
//
// What bounds it on the H100: the weight bytes. One row does 2 flops per
// int8 / e4m3 byte (4 per int4 byte), far below the ~295 flop/byte at which
// the tensor cores, not HBM (3.35 TB/s), become the limit. So the design
// keeps the weight streaming from the first cycle to the last, in ONE
// launch (gemv_stream.cuh: the tile, the ring's loads, the one-pass block
// sum, the K splits merged by the last block of a column tile):
//   - each thread reads 16 contiguous bytes of a stored row (16 int8 / e4m3
//     codes, or 32 int4 codes of 16 columns); the block's first kD loads a
//     thread (a register ring: 32 KB a block at one row) are issued before
//     anything else, so the norm's sum of squares, the x staging and the
//     group scales' copy run while they are in flight; each later load is
//     issued kD rows ahead of its use;
//   - the grid is one wave of column tiles x K splits (gemv_plan), each K
//     split whole pack, interleave and scale-group blocks;
//   - decode without I2F: int8 codes are planted under the exponent of
//     2^23 with byte_perm and one FADD removes the bias; int4 codes two an
//     instruction (int4_word: nibbles planted as f16 pairs, the bias taken
//     off by one packed subtract or FMA, each half then to f32; at one row
//     4% faster at int4 g128 qkv than a plant and an FADD a code, within
//     2% at wo, gemv_breakdown.py); fp8
//     through Hopper's cvt.rn.f16x2.e4m3x2, exact for every code. One FFMA
//     a code and row. The bf16 one-row loop's SASS (cuobjdump, sm_90a), in
//     instructions a code: int8 4.6 (PRMT, FADD, FFMA 1 each, LOP3 0.25,
//     ~1.4 of ring, addressing and loop), int4 4.3 (LOP3 1, HADD2 1.25,
//     HFMA2 0.25, FFMA 1, the rest 0.8), e4m3 4.1 (F2FP 0.5, HADD2 1, FFMA
//     1); grouped int8 / int4 8.3 / 6.3 (a group's scaling and zeroing);
//   - no repack: int4 and interleaved fp8 store a block-local permutation of
//     K rows. x is staged in shared memory as f32 in STORED order (slot_of
//     below), so the inner loop reads x at the stored row it decodes. A
//     prologue runs where x is staged: each logical row kk is computed from
//     x (the norm, with rstd from a block-wide sum of squares; or SwiGLU
//     from x[m, kk] and x[m, K + kk], rows of stride 2K) and lands at the
//     slot of the stored row that holds it;
//   - grouped scales vary along K, so they cannot wait for the merge: each
//     group's partial sum is scaled (from the split's scales, copied to
//     shared memory in the prologue) before it joins the accumulator.
// M larger than the row tile (1, 2 or 4 rows; 2 when grouped) loops over
// row tiles inside the block, re-reading the block's weight tile.
#pragma once

#include <cuda_fp8.h>

#include <type_traits>

#include "common.cuh"
#include "gemv_stream.cuh"

namespace tllm {
namespace gemv {

enum WFmt : int { kInt8 = 0, kInt4 = 1, kFp8 = 2 };

using stream::kThreads;
using stream::kVec;                  // bytes a thread loads: 16 columns

__device__ __forceinline__ float plant(uint32_t bytes, int j) {
  // byte j of `bytes` under the exponent of 2^23: the float 2^23 + byte
  return __uint_as_float(__byte_perm(bytes, 0x4B000000u, 0x7440u + j));
}

// The int8 code in byte j of `word` as an exact float.
__device__ __forceinline__ float int8_code(uint32_t word, int j) {
  // byte ^ 0x80 = q + 128 in [0, 255]
  return plant(word ^ 0x80808080u, j) - 8388736.0f;
}

// The two int4 codes of byte j of `word` (low nibble, high nibble; stored
// biased by INT4_BIAS = 8) as exact floats, one plant and one FADD a code:
// the tensor-core GEMM's decode (woq_gemm.cuh); the one-row body takes
// int4_word below, and the decode probe holds the two to each other.
__device__ __forceinline__ void int4_codes(uint32_t word, int j, float& lo,
                                           float& hi) {
  lo = plant(word & 0x0F0F0F0Fu, j) - 8388616.0f;  // 2^23 + INT4_BIAS
  hi = plant((word >> 4) & 0x0F0F0F0Fu, j) - 8388616.0f;
}

// The 8 int4 codes of `word` (byte j: the code of column j's low and high
// nibble, each stored biased by INT4_BIAS = 8) as exact floats, two codes
// an instruction: the nibbles planted as f16 pairs under the exponent of
// 1024 (low nibbles at bits 0-3 of each half, high ones at bits 4-7, read
// as 1024 + 16 u), the bias taken off in one packed subtract (high: one
// packed (1024 + 16 u) / 16 - 72), then each half to f32.
__device__ __forceinline__ void int4_word(uint32_t word, float (&lo)[4],
                                          float (&hi)[4]) {
  const uint32_t w8 = word >> 8;
  const uint32_t p[4] = {(word & 0x000F000Fu) | 0x64006400u,   // lo 0, 2
                         (w8 & 0x000F000Fu) | 0x64006400u,     // lo 1, 3
                         (word & 0x00F000F0u) | 0x64006400u,   // hi 0, 2
                         (w8 & 0x00F000F0u) | 0x64006400u};    // hi 1, 3
  float2 f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t h;
    if (i < 2)      // minus 1032 = 1024 + 8
      asm("sub.f16x2 %0, %1, %2;" : "=r"(h) : "r"(p[i]), "r"(0x64086408u));
    else            // times 1/16, minus 72
      asm("fma.rn.f16x2 %0, %1, %2, %3;"
          : "=r"(h)
          : "r"(p[i]), "r"(0x2C002C00u), "r"(0xD480D480u));
    f[i] = __half22float2(*reinterpret_cast<const __half2*>(&h));
  }
  lo[0] = f[0].x; lo[2] = f[0].y; lo[1] = f[1].x; lo[3] = f[1].y;
  hi[0] = f[2].x; hi[2] = f[2].y; hi[1] = f[3].x; hi[3] = f[3].y;
}

// silu(g) = g / (1 + exp(-g)) in f32 (expf, not the approximate __expf).
__device__ __forceinline__ float silu_f32(float g) {
  return g / (1.0f + expf(-g));
}

using ::tllm::fp8x2;  // e4m3 pairs (common.cuh)

// The 16 bytes of T values at p (16-byte aligned) as floats.
template <typename T>
__device__ __forceinline__ void load16_as_f(const T* p,
                                            float (&f)[16 / sizeof(T)]) {
  const int4 v = __ldg(reinterpret_cast<const int4*>(p));
  const uint32_t w[4] = {static_cast<uint32_t>(v.x), static_cast<uint32_t>(v.y),
                         static_cast<uint32_t>(v.z), static_cast<uint32_t>(v.w)};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (std::is_same<T, float>::value) {
      f[i] = __uint_as_float(w[i]);
    } else {
      const unsigned short lo = static_cast<unsigned short>(w[i] & 0xFFFFu);
      const unsigned short hi = static_cast<unsigned short>(w[i] >> 16);
      if constexpr (std::is_same<T, __half>::value) {
        f[2 * i] = __half2float(__ushort_as_half(lo));
        f[2 * i + 1] = __half2float(__ushort_as_half(hi));
      } else {
        f[2 * i] = __bfloat162float(__ushort_as_bfloat16(lo));
        f[2 * i + 1] = __bfloat162float(__ushort_as_bfloat16(hi));
      }
    }
  }
}

// Slot in the staged x tile of logical row kk (relative to a block-aligned
// tile start). int4: stored row sp holds two logical rows, at slots 2sp
// (low nibble) and 2sp + 1 (high nibble); fp8 and int8: slot = stored row.
template <int FMT>
__device__ __forceinline__ int slot_of(int kk, int blk) {
  if constexpr (FMT == kInt4) {
    const int b = kk / blk;
    const int j = kk - b * blk;
    const int q4 = blk >> 2;
    const int quarter = j / q4;       // A, B, C, D
    const int m = j - quarter * q4;
    const int sp = b * (blk >> 1) + 2 * m + (quarter & 1);
    return 2 * sp + (quarter >> 1);
  } else if constexpr (FMT == kFp8) {
    if (blk == 0) return kk;
    const int b = kk / blk;
    const int j = kk - b * blk;
    const int h = blk >> 1;
    const int half = j >= h ? 1 : 0;
    return b * blk + 2 * (j - half * h) + half;
  } else {
    return kk;
  }
}

// One stored row's 16 columns times the row tile's x values (rows of the
// staged x ld floats apart), into a.
template <int FMT, int MR>
__device__ __forceinline__ void fma_row(const int4 wv, const float* xs_row,
                                        int ld, int slot,
                                        float (&a)[MR][kVec]) {
  const uint32_t words[4] = {static_cast<uint32_t>(wv.x),
                             static_cast<uint32_t>(wv.y),
                             static_cast<uint32_t>(wv.z),
                             static_cast<uint32_t>(wv.w)};
  if constexpr (FMT == kInt4) {
    float xl[MR], xh[MR];
#pragma unroll
    for (int r = 0; r < MR; ++r) {
      const float2 v = *reinterpret_cast<const float2*>(xs_row + r * ld + slot);
      xl[r] = v.x;
      xh[r] = v.y;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float lo[4], hi[4];
      int4_word(words[i], lo, hi);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < MR; ++r) {
          a[r][4 * i + j] = fmaf(xl[r], lo[j], a[r][4 * i + j]);
          a[r][4 * i + j] = fmaf(xh[r], hi[j], a[r][4 * i + j]);
        }
    }
  } else {
    float xv[MR];
#pragma unroll
    for (int r = 0; r < MR; ++r) xv[r] = xs_row[r * ld + slot];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float f[4];
      if constexpr (FMT == kFp8) {
        fp8x2(words[i], f[0], f[1]);
        fp8x2(words[i] >> 16, f[2], f[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) f[j] = int8_code(words[i], j);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < MR; ++r)
          a[r][4 * i + j] = fmaf(xv[r], f[j], a[r][4 * i + j]);
    }
  }
}

// The arguments of one launch (pointers of ONE layer: the wrapper offsets
// the stacked arrays).
struct Params {
  const void* x;       // [M, K] activation (T), [M, 2K] with swiglu
  const uint8_t* q;    // stored codes [K or K/2, ldw], from column 0 of N
  const float* scale;  // [N] per-channel or [K/group, ldw] grouped
  const void* norm_w;  // [K] (T) or null
  const void* resid;   // [M, N] (T) or null
  float* out;          // [M, N]
  float* part;         // [ksplit, M, N] workspace (ksplit > 1)
  int* counters;       // [column tiles] workspace, 0 between launches
  int M, K, N;         // N: the columns computed (a window of ldw)
  int ldw;             // row stride of q and of grouped scales
  int kc;              // logical K rows of a split (whole blk and group)
  int ksplit;          // splits of a column tile (gridDim.y)
  int lanes;           // threads along N (gemv_stream.cuh Tile)
  int blk;             // int4 pack block / fp8 interleave block (0: none)
  int group;           // logical K rows of a scale group (GROUPED)
  float eps;
  int swiglu;          // x is [M, 2K] = [gate | up]: the SwiGLU prologue
};

// Loads a thread keeps in flight: 8 (32 KB a block) at one row; fewer at
// 2 and 4 rows, whose accumulators take the registers.
template <int MR>
__host__ __device__ constexpr int ring_depth() {
  return MR == 1 ? 8 : MR == 2 ? 4 : 2;
}

// Dynamic shared memory of a launch: x [MR][kc] in stored order, the
// split's group scales [kc / group][bn], the block sum [kWarps][MR][bn].
template <int MR, bool GROUPED>
size_t smem_bytes(const Params& p) {
  const size_t bn = static_cast<size_t>(kVec) * p.lanes;
  return 4 * (static_cast<size_t>(MR) * p.kc +
              (GROUPED ? p.kc / p.group * bn : 0) + stream::kWarps * MR * bn);
}

// The outputs' epilogue: the per-channel scale (not grouped: those scale
// each group), then the residual in T.
template <typename T, bool GROUPED>
struct Epilogue {
  const float* scale;
  const T* resid;
  float* out;
  int N;
  __device__ __forceinline__ float2 load(int m, int n) const {
    return make_float2(
        GROUPED ? 1.f : __ldg(scale + n),
        resid != nullptr ? to_f(resid[static_cast<size_t>(m) * N + n]) : 0.f);
  }
  __device__ __forceinline__ void store(float v, int m, int n,
                                        float2 in) const {
    if constexpr (!GROUPED) v *= in.x;
    if (resid != nullptr) v = round_to<T>(in.y + round_to<T>(v));
    out[static_cast<size_t>(m) * N + n] = v;
  }
};

template <typename T, int MR, int FMT, bool GROUPED>
__global__ void __launch_bounds__(kThreads, 2) gemv_kernel(const Params p) {
  constexpr int kR = FMT == kInt4 ? 2 : 1;    // logical rows per stored row
  constexpr int kD = ring_depth<MR>();         // rows a thread has in flight
  extern __shared__ __align__(16) float smem[];
  __shared__ float sq[MR][stream::kWarps];     // the norm's sums of squares

  const stream::Tile t = stream::tile_of(p.lanes);
  const int tid = threadIdx.x;
  const int split = blockIdx.y;
  const int k_begin = split * p.kc;
  const int klen = min(p.K, k_begin + p.kc) - k_begin;
  const int n_tile = blockIdx.x * t.bn;
  const int n0 = n_tile + t.ln * kVec;
  const int rows = klen / kR;                  // stored rows of the split
  // this thread's stored rows: t.slot + j * t.rows, j < mine
  const int mine = n0 < p.N && rows > t.slot
                       ? (rows - t.slot + t.rows - 1) / t.rows : 0;
  const uint8_t* wp = p.q + (static_cast<size_t>(k_begin / kR) + t.slot) * p.ldw + n0;
  const size_t step = static_cast<size_t>(t.rows) * p.ldw;
  const T* x = static_cast<const T*>(p.x);
  const T* norm_w = static_cast<const T*>(p.norm_w);

  float* xs = smem;                                          // [MR][kc]
  float* ss = xs + MR * p.kc;                                // [groups][bn]
  float* red = ss + (GROUPED ? p.kc / p.group * t.bn : 0);   // block sum
  const stream::Splits<float> sp{p.M, p.N, n_tile, split, p.ksplit, p.part,
                                 p.counters};
  const Epilogue<T, GROUPED> epi{p.scale, static_cast<const T*>(p.resid),
                                 p.out, p.N};

  for (int m0 = 0; m0 < p.M; m0 += MR) {
    // the weight's first rows go out before the prologue
    int4 ring[kD];
#pragma unroll
    for (int i = 0; i < kD; ++i)
      if (i < mine) ring[i] = stream::load16(wp + i * step);

    // 16-byte vectors of x (and norm_w) where their rows allow them
    constexpr int kPer = 16 / sizeof(T);
    const bool vec =
        p.K % kPer == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
        reinterpret_cast<uintptr_t>(norm_w) % 16 == 0;
    float rstd[MR];
    if (norm_w != nullptr) {
#pragma unroll
      for (int r = 0; r < MR; ++r) {
        float s = 0.f;
        if (m0 + r < p.M) {
          const T* xr = x + static_cast<size_t>(m0 + r) * p.K;
          if (vec) {
            for (int c = tid; c < p.K / kPer; c += kThreads) {
              float v[kPer];
              load16_as_f(xr + c * kPer, v);
#pragma unroll
              for (int u = 0; u < kPer; ++u) s = fmaf(v[u], v[u], s);
            }
          } else {
            for (int k = tid; k < p.K; k += kThreads) {
              const float v = to_f(xr[k]);
              s = fmaf(v, v, s);
            }
          }
        }
        s = warp_sum(s);
        if ((tid & 31) == 0) sq[r][tid >> 5] = s;
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < MR; ++r) {
        float s = sq[r][0];
#pragma unroll
        for (int w = 1; w < stream::kWarps; ++w) s += sq[r][w];
        rstd[r] = rsqrtf(s / static_cast<float>(p.K) + p.eps);
      }
    }
#pragma unroll
    for (int r = 0; r < MR; ++r) {
      const int m = m0 + r;
      // x's split of this row through its prologue, to the stored slots
      if (vec) {
        for (int c = tid; c < klen / kPer; c += kThreads) {
          const int kk = c * kPer;
          float v[kPer];
#pragma unroll
          for (int u = 0; u < kPer; ++u) v[u] = 0.f;
          if (m < p.M && p.swiglu) {
            const T* xr = x + static_cast<size_t>(m) * 2 * p.K + k_begin + kk;
            float g[kPer];
            load16_as_f(xr, g);
            load16_as_f(xr + p.K, v);
#pragma unroll
            for (int u = 0; u < kPer; ++u)
              v[u] = round_to<T>(round_to<T>(silu_f32(g[u])) * v[u]);
          } else if (m < p.M) {
            load16_as_f(x + static_cast<size_t>(m) * p.K + k_begin + kk, v);
            if (norm_w != nullptr) {
              float w[kPer];
              load16_as_f(norm_w + k_begin + kk, w);
#pragma unroll
              for (int u = 0; u < kPer; ++u)
                v[u] = round_to<T>(v[u] * rstd[r] * w[u]);
            }
          }
#pragma unroll
          for (int u = 0; u < kPer; ++u)
            xs[r * p.kc + slot_of<FMT>(kk + u, p.blk)] = v[u];
        }
        continue;
      }
      for (int kk = tid; kk < klen; kk += kThreads) {
        float v = 0.f;
        if (m < p.M && p.swiglu) {
          const T* xr = x + static_cast<size_t>(m) * 2 * p.K + k_begin + kk;
          v = round_to<T>(round_to<T>(silu_f32(to_f(xr[0]))) * to_f(xr[p.K]));
        } else if (m < p.M) {
          v = to_f(x[static_cast<size_t>(m) * p.K + k_begin + kk]);
          if (norm_w != nullptr)
            v = round_to<T>(v * rstd[r] * to_f(norm_w[k_begin + kk]));
        }
        xs[r * p.kc + slot_of<FMT>(kk, p.blk)] = v;
      }
    }
    if constexpr (GROUPED) {
      if (m0 == 0) {
        const int quads = t.bn / 4;
        const int g0 = k_begin / p.group;
        for (int i = tid; i < klen / p.group * quads; i += kThreads) {
          const int g = i / quads, c = 4 * (i - g * quads);
          if (n_tile + c < p.N)
            *reinterpret_cast<float4*>(ss + g * t.bn + c) = __ldg(
                reinterpret_cast<const float4*>(
                    p.scale + static_cast<size_t>(g0 + g) * p.ldw + n_tile + c));
        }
      }
    }
    __syncthreads();

    float acc[MR][kVec];
#pragma unroll
    for (int r = 0; r < MR; ++r)
#pragma unroll
      for (int j = 0; j < kVec; ++j) acc[r][j] = 0.f;
    float gacc[GROUPED ? MR : 1][kVec];
    // grouped: this thread's rows a group (its rows are t.rows apart;
    // gemv_plan makes one of t.rows and group / kR divide the other)
    const int per_group = GROUPED ? max(1, p.group / kR / t.rows) : 0;
    int left = per_group;
    if constexpr (GROUPED) {
#pragma unroll
      for (int r = 0; r < MR; ++r)
#pragma unroll
        for (int j = 0; j < kVec; ++j) gacc[r][j] = 0.f;
    }
    for (int j0 = 0; j0 < mine; j0 += kD) {
#pragma unroll
      for (int i = 0; i < kD; ++i) {
        const int j = j0 + i;
        const int4 wv = stream::swap_load(ring[i], wp + (j + kD) * step,
                                          j + kD < mine);
        if (j >= mine) continue;
        const int s_row = t.slot + j * t.rows;      // stored row of the split
        if constexpr (GROUPED) {
          fma_row<FMT, MR>(wv, xs, p.kc, kR * s_row, gacc);
          if (--left == 0) {                         // the group's last row
            left = per_group;
            const float* sg = ss + (kR * s_row / p.group) * t.bn + t.ln * kVec;
#pragma unroll
            for (int v = 0; v < kVec; v += 4) {
              const float4 s4 = *reinterpret_cast<const float4*>(sg + v);
              const float s[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
              for (int r = 0; r < MR; ++r)
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                  acc[r][v + u] = fmaf(gacc[r][v + u], s[u], acc[r][v + u]);
                  gacc[r][v + u] = 0.f;
                }
            }
          }
        } else {
          fma_row<FMT, MR>(wv, xs, p.kc, kR * s_row, acc);
        }
      }
    }

    stream::block_sum<float, MR>(acc, t, red);
    stream::tile_out<float, MR>(red, t, sp, m0, epi);
    __syncthreads();  // xs and red are restaged by the next row tile
  }
  stream::merge_splits<float>(t, sp, epi);
}

// out[m, n] = epilogue(sum_s part[s, m, n] [* scale[n]]); scale is null for
// grouped weights (scaled per group). The second launch of the tensor-core
// bodies (woq_gemv_tc.cuh, woq_gemm.cuh) that sums their K splits.
template <typename T>
__global__ void reduce_kernel(const float* part, const float* __restrict__ scale,
                              const T* __restrict__ resid, float* out, int M,
                              int N, int ksplit) {
  const size_t total = static_cast<size_t>(M) * N;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float acc = 0.f;
  for (int s = 0; s < ksplit; ++s) acc += part[static_cast<size_t>(s) * total + i];
  if (scale != nullptr) acc *= scale[i % N];
  if (resid != nullptr) acc = round_to<T>(to_f(resid[i]) + round_to<T>(acc));
  out[i] = acc;
}

// One launch: grid (column tiles, ksplit). The wrapper's plan (gemv_plan)
// keeps lanes in {8, 16, 32} with MR * lanes <= 32, kc whole blk and
// group blocks, and a group a whole number of a thread's rows (or the
// other way round).
template <typename T, int MR, int FMT, bool GROUPED>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  if ((p.lanes != 8 && p.lanes != 16 && p.lanes != 32) || MR * p.lanes > 32 ||
      (p.ksplit > 1 && (p.part == nullptr || p.counters == nullptr)))
    return cudaErrorInvalidValue;
  const dim3 grid((p.N + kVec * p.lanes - 1) / (kVec * p.lanes), p.ksplit);
  return tllm::stream::launch<gemv_kernel<T, MR, FMT, GROUPED>>(
      grid, smem_bytes<MR, GROUPED>(p), stream, p);
}

// mr in {1, 2, 4} rows per register tile; grouped weights keep a second
// accumulator per row, so they take at most 2.
template <typename T, int FMT, bool GROUPED>
cudaError_t launch_mr(int mr, const Params& p, cudaStream_t stream) {
  switch (mr) {
    case 1: return launch<T, 1, FMT, GROUPED>(p, stream);
    case 2: return launch<T, 2, FMT, GROUPED>(p, stream);
    case 4:
      if constexpr (!GROUPED) return launch<T, 4, FMT, GROUPED>(p, stream);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

template <int FMT, bool GROUPED>
cudaError_t dispatch(int dtype, int mr, const Params& p, int device,
                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) return launch_mr<__nv_bfloat16, FMT, GROUPED>(mr, p, s);
  if (dtype == kF16) return launch_mr<__half, FMT, GROUPED>(mr, p, s);
  if (dtype == kF32) return launch_mr<float, FMT, GROUPED>(mr, p, s);
  return cudaErrorInvalidValue;
}
}  // namespace gemv
}  // namespace tllm
