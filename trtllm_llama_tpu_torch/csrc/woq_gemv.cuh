// Weight-only stacked matmul for few rows (decode / short prefill), one
// body for every weight format: int8, packed int4 and e4m3 (fp8) codes.
//
// Replaces the body of trtllm_llama_tpu/ops/pallas/woq_matmul.py
// (_kernel_int8 with its fp8 branch, _kernel_int4, the _fuse_prologue norm
// and SwiGLU modes and the _fuse_epilogue residual add). Instantiated by
// woq_matmul.cu (int8, int4) and fp8_matmul.cu (fp8), two libraries that
// nvcc builds in parallel; decode_probes.cu calls its decode functions.
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
// What bounds it on the H100: the weight bytes. At M <= 16 a matmul does
// 2*M flops per weight byte (4*M for int4), far below the ~295 flop/byte at
// which the tensor cores, not HBM (3.35 TB/s), become the limit. So the
// design streams the weight once:
//   - each thread reads 16 contiguous columns of one stored row in one
//     16-byte load (a warp covers 512 contiguous bytes of a row);
//   - decode without I2F: int8 and int4 codes are planted under the exponent
//     of 2^23 with byte_perm and one FADD removes the bias (int4: two
//     nibbles per byte, taken from the unsigned byte, so no sign shifts);
//     fp8 uses Hopper's cvt.rn.f16x2.e4m3x2, exact for every code;
//   - no repack: int4 and interleaved fp8 store a block-local permutation of
//     K rows. The x panel is staged in shared memory as f32 in STORED order
//     (slot_of below), so the inner loop reads x at the stored row it
//     decodes. The split-K range and the staged tile start on whole pack
//     (or interleave, or scale-group) blocks, so no block straddles two.
//     A prologue runs where the tile is staged: each logical row kk is
//     computed from x (the norm; or SwiGLU from x[m, kk] and x[m, K + kk],
//     rows of stride 2K) and lands at the slot of the stored row that holds
//     it, so the stored order needs nothing more;
//   - grouped scales vary along K, so they cannot wait for the split-K
//     reduce: each group's partial sum is scaled before it joins the
//     accumulator (kept beside it in registers, hence at most 4 rows a tile);
//   - K is split across blocks so that even N = 4096 launches ~2 blocks per
//     SM; a second launch sums the K-splits in a fixed order (deterministic),
//     applies the per-channel scale and the residual.
// M larger than the row tile loops over row tiles inside the block,
// re-reading the block's weight tile from L2.
#pragma once

#include <cuda_fp8.h>

#include "common.cuh"

namespace tllm {
namespace gemv {

enum WFmt : int { kInt8 = 0, kInt4 = 1, kFp8 = 2 };

constexpr int kTN = 32;              // threads along N: one warp
constexpr int kTK = 8;               // warps along K (stored rows)
constexpr int kVec = 16;             // columns per thread (16 bytes)
constexpr int kBN = kTN * kVec;      // 512 output columns per block
constexpr int kThreads = kTN * kTK;  // 256
constexpr int kKT = 512;             // logical K rows of x staged per pass

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
// biased by INT4_BIAS = 8) as exact floats.
__device__ __forceinline__ void int4_codes(uint32_t word, int j, float& lo,
                                           float& hi) {
  lo = plant(word & 0x0F0F0F0Fu, j) - 8388616.0f;  // 2^23 + INT4_BIAS
  hi = plant((word >> 4) & 0x0F0F0F0Fu, j) - 8388616.0f;
}

// silu(g) = g / (1 + exp(-g)) in f32 (expf, not the approximate __expf).
__device__ __forceinline__ float silu_f32(float g) {
  return g / (1.0f + expf(-g));
}

// e4m3 codes in the two bytes of `pair` -> two exact floats (low byte first).
__device__ __forceinline__ void fp8x2(uint32_t pair, float& lo, float& hi) {
  uint32_t h2;
  const unsigned short p = static_cast<unsigned short>(pair & 0xFFFFu);
  asm("cvt.rn.f16x2.e4m3x2 %0, %1;" : "=r"(h2) : "h"(p));
  const unsigned short h_lo = static_cast<unsigned short>(h2 & 0xFFFFu);
  const unsigned short h_hi = static_cast<unsigned short>(h2 >> 16);
  asm("cvt.f32.f16 %0, %1;" : "=f"(lo) : "h"(h_lo));
  asm("cvt.f32.f16 %0, %1;" : "=f"(hi) : "h"(h_hi));
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

// One stored row's 16 columns times the row tile's x values, into a.
template <int FMT, int MR>
__device__ __forceinline__ void fma_row(const int4 wv, const float* xs_row,
                                        int slot, float (&a)[MR][kVec]) {
  const uint32_t words[4] = {static_cast<uint32_t>(wv.x),
                             static_cast<uint32_t>(wv.y),
                             static_cast<uint32_t>(wv.z),
                             static_cast<uint32_t>(wv.w)};
  if constexpr (FMT == kInt4) {
    float xl[MR], xh[MR];
#pragma unroll
    for (int r = 0; r < MR; ++r) {
      const float2 v = *reinterpret_cast<const float2*>(xs_row + r * kKT + slot);
      xl[r] = v.x;
      xh[r] = v.y;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float wl, wh;
        int4_codes(words[i], j, wl, wh);
#pragma unroll
        for (int r = 0; r < MR; ++r) {
          a[r][4 * i + j] = fmaf(xl[r], wl, a[r][4 * i + j]);
          a[r][4 * i + j] = fmaf(xh[r], wh, a[r][4 * i + j]);
        }
      }
    }
  } else {
    float xv[MR];
#pragma unroll
    for (int r = 0; r < MR; ++r) xv[r] = xs_row[r * kKT + slot];
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

// blk: int4 pack block or fp8 interleave block (0: identity order);
// group: logical K rows per scale group (GROUPED), scale then [K/group, N].
// kc and every tile start are multiples of blk and group (wrapper).
// swiglu: x is [M, 2K] = [gate | up] and the prologue stages silu(g) * u
// (norm_w is then null: one prologue per matmul, checked by the wrapper).
template <typename T, int MR, int FMT, bool GROUPED>
__global__ void __launch_bounds__(kThreads)
    partial_kernel(const T* __restrict__ x, const uint8_t* __restrict__ q,
                   const float* __restrict__ scale, const T* __restrict__ norm_w,
                   float* __restrict__ part, int M, int K, int N, int kc,
                   int blk, int group, float eps, int swiglu) {
  constexpr int kR = FMT == kInt4 ? 2 : 1;    // logical rows per stored row
  __shared__ __align__(16) float xs[MR][kKT];  // staged rows, stored order
  __shared__ float red[MR * kVec * kTN];       // cross-warp reduction
  __shared__ float rstd[MR];                   // norm prologue factors

  const int tn = threadIdx.x;
  const int tk = threadIdx.y;
  const int tid = tk * kTN + tn;
  const int n0 = blockIdx.x * kBN + tn * kVec;
  const bool n_ok = n0 < N;                    // N % 16 == 0 (wrapper)
  const int ks = blockIdx.y;
  const int k_begin = ks * kc;
  const int k_end = min(K, k_begin + kc);

  for (int m0 = 0; m0 < M; m0 += MR) {
    if (norm_w != nullptr) {
      for (int r = tk; r < MR; r += kTK) {
        const int m = m0 + r;
        float ss = 0.f;
        if (m < M) {
          for (int k = tn; k < K; k += kTN) {
            const float v = to_f(x[static_cast<size_t>(m) * K + k]);
            ss = fmaf(v, v, ss);
          }
        }
        ss = warp_sum(ss);
        if (tn == 0) rstd[r] = rsqrtf(ss / static_cast<float>(K) + eps);
      }
      __syncthreads();
    }

    float acc[MR][kVec];
#pragma unroll
    for (int r = 0; r < MR; ++r)
#pragma unroll
      for (int j = 0; j < kVec; ++j) acc[r][j] = 0.f;

    for (int kt = k_begin; kt < k_end; kt += kKT) {
      const int klen = min(kKT, k_end - kt);
      for (int i = tid; i < MR * klen; i += kThreads) {
        const int r = i / klen;
        const int kk = i - r * klen;
        const int m = m0 + r;
        float v = 0.f;
        if (m < M && swiglu) {
          const T* xr = x + static_cast<size_t>(m) * 2 * K + kt + kk;
          v = round_to<T>(round_to<T>(silu_f32(to_f(xr[0]))) * to_f(xr[K]));
        } else if (m < M) {
          v = to_f(x[static_cast<size_t>(m) * K + kt + kk]);
          if (norm_w != nullptr)
            v = round_to<T>(v * rstd[r] * to_f(norm_w[kt + kk]));
        }
        xs[r][slot_of<FMT>(kk, blk)] = v;
      }
      __syncthreads();
      if (n_ok) {
        const uint8_t* qt = q + static_cast<size_t>(kt / kR) * N + n0;
        const int glen = GROUPED ? group : klen;   // logical rows per group
        for (int g0 = 0; g0 < klen; g0 += glen) {
          float gacc[GROUPED ? MR : 1][kVec];
          if constexpr (GROUPED) {
#pragma unroll
            for (int r = 0; r < MR; ++r)
#pragma unroll
              for (int j = 0; j < kVec; ++j) gacc[r][j] = 0.f;
          }
          const int s_end = (g0 + glen) / kR;
#pragma unroll 4
          for (int sp = g0 / kR + tk; sp < s_end; sp += kTK) {
            const int4 wv = __ldg(reinterpret_cast<const int4*>(
                qt + static_cast<size_t>(sp) * N));
            if constexpr (GROUPED)
              fma_row<FMT, MR>(wv, &xs[0][0], kR * sp, gacc);
            else
              fma_row<FMT, MR>(wv, &xs[0][0], kR * sp, acc);
          }
          if constexpr (GROUPED) {
            const float* sg = scale + static_cast<size_t>((kt + g0) / group) * N + n0;
            float s[kVec];
#pragma unroll
            for (int v = 0; v < kVec / 4; ++v) {
              const float4 s4 = __ldg(reinterpret_cast<const float4*>(sg) + v);
              s[4 * v] = s4.x;
              s[4 * v + 1] = s4.y;
              s[4 * v + 2] = s4.z;
              s[4 * v + 3] = s4.w;
            }
#pragma unroll
            for (int r = 0; r < MR; ++r)
#pragma unroll
              for (int j = 0; j < kVec; ++j)
                acc[r][j] = fmaf(gacc[r][j], s[j], acc[r][j]);
          }
        }
      }
      __syncthreads();  // xs is restaged by the next pass
    }

    // Sum the kTK warps' accumulators in a fixed order.
    for (int w = 0; w < kTK; ++w) {
      if (tk == w) {
#pragma unroll
        for (int r = 0; r < MR; ++r)
#pragma unroll
          for (int j = 0; j < kVec; ++j) {
            float* p = &red[(r * kVec + j) * kTN + tn];
            *p = (w == 0 ? 0.f : *p) + acc[r][j];
          }
      }
      __syncthreads();
    }
    for (int i = tid; i < MR * kBN; i += kThreads) {
      const int r = i / kBN;
      const int c = i - r * kBN;
      const int m = m0 + r;
      const int n = blockIdx.x * kBN + c;
      if (m < M && n < N)
        part[(static_cast<size_t>(ks) * M + m) * N + n] =
            red[(r * kVec + (c % kVec)) * kTN + c / kVec];
    }
    __syncthreads();  // red and rstd are reused by the next row tile
  }
}

// out[m, n] = epilogue(sum_s part[s, m, n] [* scale[n]]); scale is null for
// grouped weights (scaled in the partial pass). With ksplit == 1 the
// wrapper may pass part == out: each thread reads its element before
// writing it.
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

// The arguments every entry point takes (pointers of ONE layer: the
// wrapper offsets the stacked arrays).
struct Args {
  const void* x;       // [M, K] activation (dtype), [M, 2K] with swiglu
  const void* q;       // stored weight codes of the layer
  const void* scale;   // f32 [N] per-channel or [K/group, N] grouped
  const void* norm_w;  // [K] (dtype) or null
  const void* resid;   // [M, N] (dtype) or null
  void* out;           // f32 [M, N]
  void* part;          // f32 [ksplit, M, N] scratch (== out if ksplit == 1)
  int M, K, N, ksplit, kc, blk, group;
  float eps;
  int swiglu;          // x is [M, 2K] = [gate | up]: the SwiGLU prologue
};

template <typename T, int MR, int FMT, bool GROUPED>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.N + kBN - 1) / kBN, a.ksplit);
  const dim3 block(kTN, kTK);
  partial_kernel<T, MR, FMT, GROUPED><<<grid, block, 0, stream>>>(
      static_cast<const T*>(a.x), static_cast<const uint8_t*>(a.q),
      static_cast<const float*>(a.scale), static_cast<const T*>(a.norm_w),
      static_cast<float*>(a.part), a.M, a.K, a.N, a.kc, a.blk, a.group, a.eps,
      a.swiglu);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t total = static_cast<size_t>(a.M) * a.N;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  reduce_kernel<T><<<blocks, threads, 0, stream>>>(
      static_cast<const float*>(a.part),
      GROUPED ? nullptr : static_cast<const float*>(a.scale),
      static_cast<const T*>(a.resid), static_cast<float*>(a.out), a.M, a.N,
      a.ksplit);
  return cudaGetLastError();
}

// mr in {1, 2, 4, 8} rows per register tile; grouped weights keep a second
// accumulator per row, so they take at most 4.
template <typename T, int FMT, bool GROUPED>
cudaError_t launch_mr(int mr, const Args& a, cudaStream_t stream) {
  switch (mr) {
    case 1: return launch<T, 1, FMT, GROUPED>(a, stream);
    case 2: return launch<T, 2, FMT, GROUPED>(a, stream);
    case 4: return launch<T, 4, FMT, GROUPED>(a, stream);
    case 8:
      if constexpr (!GROUPED) return launch<T, 8, FMT, GROUPED>(a, stream);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

template <int FMT, bool GROUPED>
cudaError_t dispatch(int dtype, int mr, const Args& a, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) return launch_mr<__nv_bfloat16, FMT, GROUPED>(mr, a, s);
  if (dtype == kF16) return launch_mr<__half, FMT, GROUPED>(mr, a, s);
  if (dtype == kF32) return launch_mr<float, FMT, GROUPED>(mr, a, s);
  return cudaErrorInvalidValue;
}

}  // namespace gemv
}  // namespace tllm
