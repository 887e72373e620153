// Weight-only stacked matmul for 1-16 rows on the tensor cores: the
// contract of woq_gemv.cuh (the same prologues, f32 sums of exact products,
// the scale after the sum or per group, the residual epilogue), one body
// for int8, packed int4 (per-channel or grouped) and e4m3 codes, bf16 or
// fp16 activations.
//
// Replaces the same TPU kernels as woq_gemv.cuh
// (trtllm_llama_tpu/ops/pallas/woq_matmul.py: woq_matmul_stacked and
// fp8_matmul_stacked, _kernel_int8 with its fp8 branch, _kernel_int4,
// _fuse_prologue, _fuse_epilogue) for the bf16 / fp16 calls of
// TC_MIN_ROWS..16 rows on the layouts it tiles (K in whole 16-row steps,
// groups of whole steps); woq_gemv.cuh keeps f32 and the rest. Instantiated
// by woq_gemv_tc.cu (int8, int4) and fp8_matmul.cu (e4m3).
//
// What bounds it on the H100: the weight bytes (3.35 TB/s). The CUDA-core
// body issues one FFMA per weight and row, so from ~4 rows up it is bound
// by instruction issue, and it reads the weight once per 8-row tile. Here:
//   - products on the tensor cores: mma.sync.m16n8k16 (f32 accumulators)
//     with the weight as the A operand (16 output columns x 16 K) and x^T
//     as B (16 K x 8 rows): M <= 8 takes one mma per 16 columns and k16
//     step, 9-16 rows two, and every weight byte is decoded once per call;
//   - no repack: K runs in STORED order (the x panel is staged at
//     slot_of<FMT> as in woq_gemv.cuh, in T: every prologue rounds to T),
//     so a k-pair of an A fragment is two stored rows of int8 / e4m3 codes
//     or the two nibbles of one int4 byte;
//   - the output columns are permuted inside a warp so that one load of NT
//     contiguous bytes of a stored row feeds the same A slot of NT tiles:
//     A row r (0..15) of tile j is column n0 + NT * r + j, a warp covers
//     16 * NT columns, and thread (g, t) reads columns n0 + NT * g and
//     n0 + NT * (g + 8) of stored rows 2t, 2t+1, 2t+8, 2t+9 of the step
//     (int4: rows t, t+4) straight into registers, a ring of kD steps ahead
//     (no shared-memory copy: the codes go from the load to the decode);
//   - exact decodes into 16-bit pairs with byte permutes and one packed
//     subtract: int4 nibbles and fp16 int8 codes planted under a fixed
//     exponent; bf16 int8 codes as 128 + (b & 127) plus -128 (1 + b7)
//     (the sign bit lands on the exponent's last bit); e4m3 through
//     cvt.rn.f16x2.e4m3x2 (bf16: through f32);
//   - grouped scales: at up to 8 rows each group's sums in fragments of
//     their own, scaled into the accumulator at the group's last step; at
//     9-16 rows (twice the accumulators) each step's products scaled into
//     it as they come (the FMA pipe has room: the decode is ALU work);
//   - occupancy over depth: small blocks (four warps splitting the block's
//     K range, summed in shared memory in a fixed order), three resident
//     an SM at up to 8 rows, two at 16 (the registers bound it), so that
//     each SM has 8-12 warps to hide the decode's latencies;
//   - split-K: the blocks of a column tile split K; with more than one
//     split each leaves its sum in a per-stream workspace that the wrapper
//     keeps between calls, and woq_gemv.cuh's reduce_kernel sums the splits
//     in a fixed order and applies the per-channel scale and the residual
//     (a launch after the body, fully parallel: a last-arrival merge inside
//     the body left one block per column tile reading every split);
//   - the prologues run where each block stages its K range of x (the
//     norm's rstd from all of x in every block: a launch before the body
//     that stages h once cost as much as it saved, measured).
#pragma once

#include <type_traits>

#include "woq_gemv.cuh"

namespace tllm {
namespace gemv_tc {

using gemv::kFp8;
using gemv::kInt4;
using gemv::kInt8;

constexpr int kWarps = 4;               // warps of a block, along K
constexpr int kThreads = 32 * kWarps;
constexpr int kStep = 16;               // K slots of one mma step

// Tiles (of 16 columns) a warp covers: 16 (256 columns, 16-byte loads),
// or 8 for grouped int8 (its 16-byte words beside group fragments would
// not fit the registers).
template <int FMT, bool GROUPED>
__host__ __device__ constexpr int tile_nt() {
  return GROUPED && FMT == kInt8 ? 8 : 16;
}

// ---------------------------------------------------------------------------
// exact pair decoders: the codes of two consecutive K slots of one column
// as a 32-bit pair of T (the lower slot in the low half), j the byte
// (column) within the words; j is a compile-time constant at every call
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t sub_f16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.f16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t fma_bf16x2(uint32_t a, uint32_t b,
                                               uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

__device__ __forceinline__ uint32_t sel(int lo, int hi) {
  return lo | (lo << 4) | (hi << 8) | (hi << 12);
}

// The planting constants, read from constant memory at run time so that
// the compiler keeps each in a register: a LOP3 takes one immediate, and
// (p & mask) | c with both folded in costs two.
struct Plants {
  uint32_t f16_int8;   // 0x64 | (q ^ 0x80): the half 1024 + q + 128
  uint32_t bf16_lo;    // 0x4300 | (b & 127): 128 + (b & 127)
  uint32_t bf16_hi;    // 0xC300 | (b & 128): -128 (1 + b7)
  uint32_t f16_int4;   // 0x6400 | u: 1024 + u
};
__constant__ Plants kPlants = {0x64806480u, 0x43004300u, 0xC300C300u,
                               0x64006400u};

// int8: byte j of wa (lower slot) and of wb.
template <typename T>
__device__ __forceinline__ uint32_t int8_pair(uint32_t wa, uint32_t wb, int j,
                                              const Plants& c) {
  const uint32_t p = __byte_perm(wa, wb, sel(j, 4 + j));
  if constexpr (std::is_same<T, __half>::value) {
    // (q ^ 0x80) under 0x64: 1024 + q + 128; minus 1152 is q
    return sub_f16x2((p & 0x00FF00FFu) ^ c.f16_int8, 0x64806480u);
  } else {
    // q = (b & 127) - 128 b7: 0x4300 | (b & 127) is 128 + (b & 127) and
    // 0xC300 | (b & 128) is -128 (1 + b7) (b7 lands on the exponent's last
    // bit); their sum is exact in bf16
    return fma_bf16x2((p & 0x007F007Fu) | c.bf16_lo, 0x3F803F80u,
                      (p & 0x00800080u) | c.bf16_hi);
  }
}

// int4: the low nibble (lower slot) and high nibble of byte j of w, each
// stored biased by 8.
template <typename T>
__device__ __forceinline__ uint32_t int4_pair(uint32_t w, int j,
                                              const Plants& c) {
  const uint32_t p = __byte_perm(w, w >> 4, sel(j, 4 + j));
  if constexpr (std::is_same<T, __half>::value)
    return sub_f16x2((p & 0x000F000Fu) | c.f16_int4, 0x64086408u);  // 1024 + u - 1032
  else
    return fma_bf16x2((p & 0x000F000Fu) | c.bf16_lo, 0x3F803F80u,
                      0xC308C308u);                               // 128 + u - 136
}

// e4m3: byte j of wa (lower slot) and of wb.
template <typename T>
__device__ __forceinline__ uint32_t fp8_pair(uint32_t wa, uint32_t wb, int j) {
  const unsigned short p =
      static_cast<unsigned short>(__byte_perm(wa, wb, j | ((4 + j) << 4)));
  uint32_t h2;
  asm("cvt.rn.f16x2.e4m3x2 %0, %1;" : "=r"(h2) : "h"(p));
  if constexpr (std::is_same<T, __half>::value) {
    return h2;
  } else {
    float lo, hi;
    asm("cvt.f32.f16 %0, %1;" : "=f"(lo)
        : "h"(static_cast<unsigned short>(h2 & 0xFFFFu)));
    asm("cvt.f32.f16 %0, %1;" : "=f"(hi)
        : "h"(static_cast<unsigned short>(h2 >> 16)));
    uint32_t d;
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
    return d;
  }
}

// The A fragment of tile j from a thread's words of one step (chunk c of
// stored row r at words (2 r + c) kW): int8 / e4m3 rows 2t, 2t+1 (a0:
// chunk 0, a1: chunk 1) and 2t+8, 2t+9 (a2, a3); int4 rows t (a0, a1) and
// t+4 (a2, a3), each byte one k-pair.
template <typename T, int FMT, int kW>
__device__ __forceinline__ void decode_a(const uint32_t* w, int j,
                                         const Plants& c, uint32_t (&a)[4]) {
  const int i = j >> 2, jb = j & 3;
  if constexpr (FMT == kInt4) {
    a[0] = int4_pair<T>(w[0 * kW + i], jb, c);
    a[1] = int4_pair<T>(w[1 * kW + i], jb, c);
    a[2] = int4_pair<T>(w[2 * kW + i], jb, c);
    a[3] = int4_pair<T>(w[3 * kW + i], jb, c);
  } else if constexpr (FMT == kFp8) {
    a[0] = fp8_pair<T>(w[0 * kW + i], w[2 * kW + i], jb);
    a[1] = fp8_pair<T>(w[1 * kW + i], w[3 * kW + i], jb);
    a[2] = fp8_pair<T>(w[4 * kW + i], w[6 * kW + i], jb);
    a[3] = fp8_pair<T>(w[5 * kW + i], w[7 * kW + i], jb);
  } else {
    a[0] = int8_pair<T>(w[0 * kW + i], w[2 * kW + i], jb, c);
    a[1] = int8_pair<T>(w[1 * kW + i], w[3 * kW + i], jb, c);
    a[2] = int8_pair<T>(w[4 * kW + i], w[6 * kW + i], jb, c);
    a[3] = int8_pair<T>(w[5 * kW + i], w[7 * kW + i], jb, c);
  }
}

// ---------------------------------------------------------------------------
// tensor-core and shared-memory helpers
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __half>::value)
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// NT bytes of codes at p (16- or 8-byte aligned) into w.
template <int NT>
__device__ __forceinline__ void load_codes(uint32_t* w, const uint8_t* p) {
  if constexpr (NT == 16) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = v.x; w[1] = v.y;
  }
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

struct Params {
  const void* x;        // [M, K] (T), [M, 2K] with swiglu
  const uint8_t* q;     // stored codes of the layer
  const float* scale;   // [N] or [K/group, ldw]
  const void* resid;    // [M, N] (T) or null
  float* out;           // [M, N] (ksplit == 1) or the split sums
                        // [ksplit, M, N] (ksplit > 1)
  int M, K, N;          // N: the columns computed (a window of ldw)
  int ldw;              // row stride of q and of grouped scales
  int ksplit, sps, blk, group;
  const void* norm_w;   // [K] (T) or null
  float eps;
  int swiglu;   // x is [M, 2K] = [gate | up]: stage T(T(silu(g)) * u)
};

// Dynamic shared memory: the x panel [MT][sps * 16 + 8] (T; the pad keeps
// ldmatrix's eight rows on distinct banks), reused after the main loop for
// the warps' sums [kWarps][M][16 * NT + 4] (f32).
template <typename T, int MT, int NT>
inline int smem_bytes(int M, int sps) {
  const int panel = MT * (sps * kStep + 8) * static_cast<int>(sizeof(T));
  const int red = kWarps * M * (16 * NT + 4) * 4;
  return panel > red ? panel : red;
}

template <typename T, int FMT, bool GROUPED, int MT>
__global__ void __launch_bounds__(kThreads)
    gemv_tc_kernel(const Params p) {
  constexpr int NT = tile_nt<FMT, GROUPED>();
  constexpr int kCols = 16 * NT;              // output columns of a block
  constexpr int kH = MT / 8;                  // mmas per tile and step
  constexpr int kRows = FMT == kInt4 ? 2 : 4; // stored rows a thread reads
  constexpr int kW = NT / 4;                  // words of one chunk
  constexpr int kStage = kRows * 2 * kW;      // words of one step
  // grouped at 9-16 rows: each step's products scaled as they come
  constexpr bool kStepScale = GROUPED && MT == 16;
  // steps in flight: 256 bytes a thread (128 grouped, beside its group
  // fragments), at least two
  constexpr int kBudget = GROUPED ? 32 : 64;
  constexpr int kD = kBudget / kStage > 2 ? kBudget / kStage : 2;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float rstd[MT];

  T* xs = reinterpret_cast<T*>(smem);
  const Plants plants = kPlants;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int M = p.M, K = p.K, N = p.N;
  const int n0 = blockIdx.x * kCols;
  const int sb = blockIdx.y * p.sps;                  // the split's steps
  const int se = min(K / kStep, sb + p.sps);
  const int len = (se - sb) * kStep;                  // its K slots
  const int ps = p.sps * kStep + 8;                   // panel row stride

  // this warp's steps: whole groups (grouped) or steps, split evenly
  const int wu = GROUPED ? p.group / kStep : 1;
  const int units = (se - sb) / wu;
  const int per = units / kWarps, rem = units % kWarps;
  const int ws = sb + wu * (warp * per + min(warp, rem));
  const int we = ws + wu * (per + (warp < rem ? 1 : 0));

  // columns of this thread's two chunks
  const int c0 = n0 + NT * g;
  const int c1 = c0 + 8 * NT;
  const bool ok0 = c0 < N, ok1 = c1 < N;    // N % 16 == 0: whole chunks

  uint32_t ring[kD][kStage];
  auto load = [&](uint32_t(&w)[kStage], int st) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = FMT == kInt4 ? 8 * st + t + 4 * r
                                   : kStep * st + 2 * t + (r & 1) + 8 * (r >> 1);
      const uint8_t* base = p.q + static_cast<size_t>(row) * p.ldw;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        uint32_t* dst = &w[(r * 2 + c) * kW];
        if (c ? ok1 : ok0) {
          load_codes<NT>(dst, base + (c ? c1 : c0));
        } else {          // past N (a ragged last tile): zeros, never stored
#pragma unroll
          for (int i = 0; i < kW; ++i) dst[i] = 0u;
        }
      }
    }
  };

  // the first steps' codes are in flight while x is staged
#pragma unroll
  for (int i = 0; i < kD; ++i)
    if (ws + i < we) load(ring[i], ws + i);

  // norm prologue: each row's rstd over all of K (every block needs every
  // row's), kThreads / MT threads a row, 16-byte loads
  if (p.norm_w != nullptr) {
    constexpr int kPer = kThreads / MT;       // threads of a row
    const int m = threadIdx.x / kPer;
    const int i0 = threadIdx.x - m * kPer;
    float ss = 0.f;
    if (m < M) {
      const uint4* xr = reinterpret_cast<const uint4*>(
          static_cast<const T*>(p.x) + static_cast<size_t>(m) * K);
#pragma unroll 16
      for (int v = i0; v < K / 8; v += kPer) {
        const uint4 u = __ldg(xr + v);
        const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
        for (int k = 0; k < 8; ++k) ss = fmaf(to_f(e[k]), to_f(e[k]), ss);
      }
    }
    // kPer (8 or 16) consecutive lanes of one row: a fixed-order butterfly
#pragma unroll
    for (int o = kPer / 2; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if (i0 == 0 && m < M) rstd[m] = rsqrtf(ss / static_cast<float>(K) + p.eps);
    __syncthreads();
  }

  // stage the split's x slots in stored order, the prologue applied, as T
  {
    const T* x = static_cast<const T*>(p.x);
    const T* nw = static_cast<const T*>(p.norm_w);
    const int k0 = sb * kStep;
    const int xstride = p.swiglu ? 2 * K : K;
    const int vecs = len / 8;
#pragma unroll 4
    for (int i = threadIdx.x; i < M * vecs; i += kThreads) {
      const int m = i / vecs;
      const int kk = (i - m * vecs) * 8;
      const T* xr = x + static_cast<size_t>(m) * xstride + k0 + kk;
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(xr));
      const T* e = reinterpret_cast<const T*>(&u);
      T o[8];
      if (p.swiglu) {
        const uint4 uu = __ldg(reinterpret_cast<const uint4*>(xr + K));
        const T* up = reinterpret_cast<const T*>(&uu);
#pragma unroll
        for (int k = 0; k < 8; ++k)
          o[k] = from_f<T>(round_to<T>(gemv::silu_f32(to_f(e[k]))) *
                           to_f(up[k]));
      } else if (nw != nullptr) {
        const uint4 un = __ldg(reinterpret_cast<const uint4*>(nw + k0 + kk));
        const T* w = reinterpret_cast<const T*>(&un);
#pragma unroll
        for (int k = 0; k < 8; ++k)
          o[k] = from_f<T>(to_f(e[k]) * rstd[m] * to_f(w[k]));
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) o[k] = e[k];
      }
      T* row = xs + m * ps;
      if constexpr (FMT == kInt8) {
        *reinterpret_cast<uint4*>(row + kk) = *reinterpret_cast<const uint4*>(o);
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) row[gemv::slot_of<FMT>(kk + k, p.blk)] = o[k];
      }
    }
  }
  __syncthreads();

  // ldmatrix: lane l gives row (l & 7) (+8 for matrices 2, 3 at MT = 16)
  // at K offset 8 * ((l >> 3) & 1) of the step
  const int lm_row = (lane & 7) + (MT == 16 ? 8 * (lane >> 4) : 0);
  const uint32_t lm_base = static_cast<uint32_t>(__cvta_generic_to_shared(
      xs + lm_row * ps + 8 * ((lane >> 3) & 1)));

  float acc[kH][NT][4];
  constexpr bool kFrags = GROUPED && !kStepScale;  // group fragments
  float gacc[kFrags ? kH : 1][kFrags ? NT : 1][4];
  float sc[2][NT];        // the current group's scales of both chunks
#pragma unroll
  for (int h = 0; h < kH; ++h)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[h][j][e] = 0.f;
  if constexpr (kFrags) {
#pragma unroll
    for (int h = 0; h < kH; ++h)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) gacc[h][j][e] = 0.f;
  }

  auto compute = [&](const uint32_t(&w)[kStage], int st) {
    if constexpr (GROUPED) {
      if (st % wu == 0) {     // a group starts: its scales
        const float* s = p.scale + static_cast<size_t>(st * kStep / p.group) * p.ldw;
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int i = 0; i < NT / 4; ++i) {
            const float4 v =
                (c ? ok1 : ok0)
                    ? __ldg(reinterpret_cast<const float4*>(s + (c ? c1 : c0)) + i)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
            sc[c][4 * i] = v.x;
            sc[c][4 * i + 1] = v.y;
            sc[c][4 * i + 2] = v.z;
            sc[c][4 * i + 3] = v.w;
          }
      }
    }
    uint32_t b[4];
    const uint32_t addr = lm_base + (st - sb) * kStep * sizeof(T);
    if constexpr (MT == 16) ldsm_x4(b, addr);
    else ldsm_x2(b, addr);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t a[4];
      decode_a<T, FMT, kW>(w, j, plants, a);
      if constexpr (kStepScale) {
        float c[kH][4] = {};
        mma<T>(c[0], a, b[0], b[1]);
        mma<T>(c[1], a, b[2], b[3]);
#pragma unroll
        for (int h = 0; h < kH; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[h][j][e] = fmaf(c[h][e], sc[e >> 1][j], acc[h][j][e]);
      } else if constexpr (GROUPED) {
        mma<T>(gacc[0][j], a, b[0], b[1]);
      } else {
        mma<T>(acc[0][j], a, b[0], b[1]);
        if constexpr (MT == 16) mma<T>(acc[1][j], a, b[2], b[3]);
      }
    }
    if constexpr (kFrags) {
      if ((st + 1) % wu == 0) {     // the group ends: scale it in
#pragma unroll
        for (int h = 0; h < kH; ++h)
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc[h][j][e] = fmaf(gacc[h][j][e], sc[e >> 1][j], acc[h][j][e]);
              gacc[h][j][e] = 0.f;
            }
      }
    }
  };

  for (int s = ws; s < we; s += kD) {
#pragma unroll
    for (int i = 0; i < kD; ++i) {
      if (s + i < we) {
        compute(ring[i], s + i);
        if (s + i + kD < we) load(ring[i], s + i + kD);
      }
    }
  }

  // the warps' sums: red[warp][m][col], C element (h, j, e) is row
  // 8h + 2t + (e & 1) and column NT * (g + 8 * (e >> 1)) + j of the tile
  __syncthreads();                         // the panel is no longer read
  constexpr int kRS = kCols + 4;
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int h = 0; h < kH; ++h)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = 8 * h + 2 * t + (e & 1);
      if (m < M) {
        float* dst = red + (warp * M + m) * kRS + NT * (g + 8 * (e >> 1));
#pragma unroll
        for (int j = 0; j < NT; j += 4)
          *reinterpret_cast<float4*>(dst + j) =
              make_float4(acc[h][j][e], acc[h][j + 1][e], acc[h][j + 2][e],
                          acc[h][j + 3][e]);
      }
    }
  __syncthreads();

  // the block's sum in warp order; at one split the scale and the residual
  // follow here, else reduce_kernel applies them after summing the splits
  constexpr int c4s = kCols / 4;
  float* out = p.out + static_cast<size_t>(blockIdx.y) * M * N;
  for (int i = threadIdx.x; i < M * c4s; i += kThreads) {
    const int m = i / c4s;
    const int c = (i - m * c4s) * 4;
    const int n = n0 + c;
    if (n >= N) continue;
    float4 v = *reinterpret_cast<const float4*>(red + m * kRS + c);
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      const float4 o = *reinterpret_cast<const float4*>(red + (w * M + m) * kRS + c);
      v.x += o.x; v.y += o.y; v.z += o.z; v.w += o.w;
    }
    if (p.ksplit == 1) {
      float* vv = reinterpret_cast<float*>(&v);
      if constexpr (!GROUPED) {
        const float4 s = __ldg(reinterpret_cast<const float4*>(p.scale + n));
        v.x *= s.x; v.y *= s.y; v.z *= s.z; v.w *= s.w;
      }
      if (p.resid != nullptr) {
        const T* r = static_cast<const T*>(p.resid) + static_cast<size_t>(m) * N + n;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          vv[k] = round_to<T>(to_f(r[k]) + round_to<T>(vv[k]));
      }
    }
    *reinterpret_cast<float4*>(out + static_cast<size_t>(m) * N + n) = v;
  }
}

// The arguments of every entry point (pointers of ONE layer).
struct Args {
  const void* x;
  const void* q;
  const void* scale;
  const void* norm_w;   // [K] or null
  const void* resid;
  void* out;    // f32 [M, N]
  void* part;   // f32 [ksplit, M, N] workspace (ksplit > 1)
  int M, K, N, ldw, ksplit, sps, mt, nt, blk, group;
  float eps;
  int swiglu;
};

// The body, then (ksplit > 1) woq_gemv.cuh's reduce_kernel.
template <typename T, int FMT, bool GROUPED, int MT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int NT = tile_nt<FMT, GROUPED>();
  if (a.nt != NT) return cudaErrorInvalidValue;
  const bool split = a.ksplit > 1;
  const Params p{a.x, static_cast<const uint8_t*>(a.q),
                 static_cast<const float*>(a.scale), a.resid,
                 static_cast<float*>(split ? a.part : a.out), a.M, a.K, a.N,
                 a.ldw, a.ksplit, a.sps, a.blk, a.group, a.norm_w, a.eps,
                 a.swiglu};
  auto kernel = gemv_tc_kernel<T, FMT, GROUPED, MT>;
  const int smem = smem_bytes<T, MT, NT>(a.M, a.sps);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + 16 * NT - 1) / (16 * NT), a.ksplit);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || !split) return err;
  const size_t total = static_cast<size_t>(a.M) * a.N;
  gemv::reduce_kernel<T><<<static_cast<unsigned>((total + 255) / 256), 256, 0,
                           stream>>>(
      static_cast<const float*>(a.part),
      GROUPED ? nullptr : static_cast<const float*>(a.scale),
      static_cast<const T*>(a.resid), static_cast<float*>(a.out), a.M, a.N,
      a.ksplit);
  return cudaGetLastError();
}

// dtype bf16 or fp16; mt 8 (M <= 8) or 16; nt the tile_nt of the format.
// The split must cover K's steps with none empty, ksplit > 1 needs the
// workspace, and a grouped split holds whole groups.
template <int FMT, bool GROUPED>
cudaError_t dispatch(int dtype, const Args& a, int device, void* stream) {
  const int steps = a.K / kStep;
  if (a.M < 1 || a.M > a.mt || a.K % kStep || a.N % 16 || a.ldw < a.N ||
      a.sps < 1 ||
      a.ksplit < 1 || a.ksplit * a.sps < steps ||
      (a.ksplit - 1) * a.sps >= steps ||
      (GROUPED && (a.group % kStep || a.sps % (a.group / kStep))) ||
      (a.ksplit > 1 && a.part == nullptr) ||
      (a.norm_w != nullptr && a.swiglu))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    if (a.mt == 8) return launch<__nv_bfloat16, FMT, GROUPED, 8>(a, s);
    if (a.mt == 16) return launch<__nv_bfloat16, FMT, GROUPED, 16>(a, s);
  } else if (dtype == kF16) {
    if (a.mt == 8) return launch<__half, FMT, GROUPED, 8>(a, s);
    if (a.mt == 16) return launch<__half, FMT, GROUPED, 16>(a, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace gemv_tc
}  // namespace tllm
