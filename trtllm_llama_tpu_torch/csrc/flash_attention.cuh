// The bf16 / fp16 body of rows 10 and 13 (prefill_attention.cu,
// packed_prefill_attention.cu): a GQA flash-attention tile on the Hopper
// tensor cores (wgmma, sm_90a), causal, or bidirectional for row 10's
// non-causal branch (the encoder and prefix-LM prefill).
//
// Contract (both rows), per (b, h, row): scores = (q . k) * sm_scale
// [+ slopes[h] * col] in f32, each product and the sum rounded on their own
// (__fmul_rn / __fadd_rn, as the JAX package rounds them); masked to
// col <= row and col < len (row 10; col < len alone when `causal` is 0)
// or seg[col] == seg[row] (row 13) with the reference's finite NEG_INF,
// never NEG_INF + bias; columns at or past S score -inf (a length of 0
// averages V over exactly S columns); an f32 online softmax;
// out = (sum_j p_j v_j) / (sum_j p_j) in q's dtype. The K/V head is
// h / (Hq / Hkv). P keeps f32's precision through P V (the
// plain version's): the products take it as the sum of p_terms<T>() terms
// of q's dtype (three for bf16, two for fp16), so the tile differs from
// the plain version in the order of the f32 sums only. One bf16 term (P
// rounded, as row 12 and the JAX package's XLA path round it) moved path
// 7's 7B prefill logits by 31-35% of their largest magnitude against the
// plain path, two terms by 12%, three by 0 (attention_precision.py, H100
// 80GB HBM3, 700 W): static per-tensor SmoothQuant turns a one-ulp change
// of an attention output into a flipped int8 code, and 32 layers amplify
// it.
//
// Design, one block of one warpgroup (128 threads) per (64-row query tile,
// q head, b):
//   - the query tiles that see the most keys launch first (blockIdx.z
//     counts tiles from the last one);
//   - Q is loaded once into a 128B-swizzled K-major tile; K and V go
//     through a 2-stage cp.async ring of kBK-key tiles (64 keys, 32 at
//     D = 256), kept in q's dtype: tile t + 1 lands while tile t's
//     products run. Rows past S (past the block's sequence: b + 1's rows
//     follow in [B, S, H, D]) are zero-filled by cp.async (src-size 0);
//   - S = Q K^T: wgmma m64n{kBK}k16, both operands from shared memory, K
//     stored [keys, D] being K-major already;
//   - the scale, bias and mask are applied where each accumulator element's
//     (row, col) is known, so the running max sees the biased, masked
//     score; the mask only on tiles that cross the diagonal (causal), a
//     length or a segment edge (c_begin / c_end and clean below); without
//     the causal mask every query tile streams the same key tiles, through
//     the last valid column;
//   - each thread keeps its two rows' running max and (partial) sum in
//     registers; P's terms are packed from the S accumulator into wgmma's
//     register A fragments (the accumulator's (row, 8 j + 2 tig) pairs are
//     the A layout's);
//   - O += P V: one wgmma m64n{64,128}k16 per term, A from registers, B = V
//     through the transpose bit (V [keys, D] is N-major), O in f32
//     registers (D = 256: two 128-column halves).
// Head dims 32, 64, 96, 128, 256; shared memory holds D padded to whole
// 64-column atoms (32 -> 64, 96 -> 128): the Q K^T steps read only the D
// real columns, and P V's padded output columns are never stored.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace tllm {
namespace flash {

constexpr int kBQ = 64;          // query rows per block: one warpgroup
constexpr int kThreads = 128;
constexpr int kStages = 2;       // K/V ring

template <int D>
struct Tile {
  static constexpr int kDP = (D + 63) / 64 * 64;       // D in whole atoms
  static constexpr int kBK = D > 128 ? 32 : 64;        // keys per K/V tile
  static constexpr int kNO = kDP > 128 ? 128 : kDP;    // columns per P V wgmma
  static constexpr int kHalves = kDP / kNO;
  static constexpr int kQTile = kBQ * kDP * 2;
  static constexpr int kKVTile = kBK * kDP * 2;
  static constexpr int kOffK = kQTile;
  static constexpr int kOffV = kOffK + kStages * kKVTile;
  // + 1024: the base is rounded up to the 1024-byte swizzle period
  static constexpr int kSmemBytes = kOffV + kStages * kKVTile + 1024;
};

// Byte offset of 16-byte chunk c of row r in a tile of ROWS rows: 64-column
// atoms of [ROWS][128 bytes], the chunk index XORed with the row's index in
// its 8-row period (the 128-byte swizzle wgmma's descriptor reads).
template <int ROWS>
__device__ __forceinline__ uint32_t swizzle_offset(int r, int c) {
  return (c >> 3) * (ROWS * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// Rows [0, n_valid) of a [ROWS, D] tile whose row r is at src + r * stride,
// into the swizzled tile at dst; rows from n_valid on are zero-filled.
template <int D, int ROWS, typename T>
__device__ __forceinline__ void load_tile(uint32_t dst, const T* src,
                                          size_t stride, int n_valid,
                                          int tid) {
  constexpr int kC = D / 8;  // 16-byte chunks per row
  static_assert(ROWS * kC % kThreads == 0, "whole chunks per thread");
#pragma unroll
  for (int it = 0; it < ROWS * kC / kThreads; ++it) {
    const int i = tid + it * kThreads;
    const int r = i / kC;
    const int c = i - r * kC;
    const bool ok = r < n_valid;
    gemm::cp_async16(dst + swizzle_offset<ROWS>(r, c),
                     src + static_cast<size_t>(ok ? r : 0) * stride + c * 8,
                     ok);
  }
}

// First row of the run of equal ids that holds row r (seg[j] == seg[r] for
// every j in [start, r]), found by the block scanning back kThreads * 8 ids
// at a time. Every thread returns the same value.
__device__ __forceinline__ int run_start(const int* __restrict__ seg, int r,
                                         int* red) {
  const int id = __ldg(seg + r);
  const int tid = threadIdx.x;
  for (int hi = r - 1; hi >= 0; hi -= kThreads * 8) {
    int found = -1;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int j = hi - i * kThreads - tid;
      if (j >= 0 && __ldg(seg + j) != id) found = max(found, j);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      found = max(found, __shfl_xor_sync(0xffffffffu, found, o));
    if ((tid & 31) == 0) red[tid >> 5] = found;
    __syncthreads();
    found = max(max(red[0], red[1]), max(red[2], red[3]));
    __syncthreads();
    if (found >= 0) return found + 1;
  }
  return 0;
}

// The two halves of a pair packed by gemm::pack2<T>, back in f32.
template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t v);
template <>
__device__ __forceinline__ float2 unpack2<__nv_bfloat16>(uint32_t v) {
  return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));
}
template <>
__device__ __forceinline__ float2 unpack2<__half>(uint32_t v) {
  return make_float2(__half2float(__ushort_as_half(v & 0xffffu)),
                     __half2float(__ushort_as_half(v >> 16)));
}

// Terms of T that carry P (<= 1) through P V to within 2^-24: bf16 keeps 8
// bits a term, fp16 11; each term rounds what the ones before it left
// (a - round(a) is exact in f32), as split_p in
// ops/kernels/prefill_attention.py splits it.
template <typename T>
__host__ __device__ constexpr int p_terms() {
  return std::is_same<T, __half>::value ? 2 : 3;
}

// q [B, S, Hq, D], k/v [B, S, Hkv, D], out like q (row 13: B = 1, S = T).
// lens: [B] valid lengths (row 10) or seg: [S] segment ids (row 13, PACKED);
// slopes [Hq] when ALIBI; causal 0 drops col <= row (row 10 only: row 13
// passes 1). Grid (Hq, B, ceil(S / kBQ)).
template <typename T, int D, bool PACKED, bool ALIBI>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ lens_or_seg,
                 const float* __restrict__ slopes, T* __restrict__ out, int S,
                 int Hq, int Hkv, float sm_scale, int causal) {
  using C = Tile<D>;
  constexpr int kBK = C::kBK;
  extern __shared__ uint8_t flash_smem[];
  const uint32_t raw = gemm::smem_addr(flash_smem);
  const uint32_t sq = (raw + 1023) & ~1023u;
  const uint32_t sk = sq + C::kOffK;
  const uint32_t sv = sq + C::kOffV;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int row0 = (gridDim.z - 1 - blockIdx.z) * kBQ;
  const int last_row = min(row0 + kBQ, S) - 1;
  const int hk = h / (Hq / Hkv);

  // The columns to stream, [c_begin, c_end), and the clean-tile rule: a
  // tile of columns [c0, c0 + kBK) needs no mask iff c0 + kBK - 1 <= row0
  // (below the diagonal for every row; any tile when not causal),
  // c0 + kBK <= lim (inside the length) and c0 >= lo (inside the run of
  // the block's last row, hence of every row of the block).
  int c_begin, c_end, lim, lo, len = S;
  if constexpr (PACKED) {
    __shared__ int red[kThreads / 32];
    lo = run_start(lens_or_seg, last_row, red);
    const int start0 = lo <= row0 ? lo : run_start(lens_or_seg, row0, red);
    c_begin = start0 / kBK * kBK;
    c_end = last_row + 1;
    lim = S;
  } else {
    len = lens_or_seg[b];
    c_begin = 0;
    // a length of 0 masks every column: the row averages V over all S;
    // without the causal mask every row sees the columns below the length
    c_end = (len > 0 ? min(causal ? last_row : S - 1, len - 1) : S - 1) + 1;
    lim = len;
    lo = 0;
  }
  const int n_tiles = (c_end - c_begin + kBK - 1) / kBK;

  const size_t q_rs = static_cast<size_t>(Hq) * D;
  const size_t kv_rs = static_cast<size_t>(Hkv) * D;
  const T* qb = q + (static_cast<size_t>(b) * S + row0) * q_rs +
                static_cast<size_t>(h) * D;
  const T* kb = k + static_cast<size_t>(b) * S * kv_rs +
                static_cast<size_t>(hk) * D;
  const T* vb = v + static_cast<size_t>(b) * S * kv_rs +
                static_cast<size_t>(hk) * D;
  auto load_kv = [&](int t) {
    const int c0 = c_begin + t * kBK;
    const int stage = t % kStages;
    load_tile<D, kBK>(sk + stage * C::kKVTile, kb + c0 * kv_rs, kv_rs,
                      S - c0, tid);
    load_tile<D, kBK>(sv + stage * C::kKVTile, vb + c0 * kv_rs, kv_rs,
                      S - c0, tid);
  };

  load_tile<D, kBQ>(sq, qb, q_rs, S - row0, tid);
  load_kv(0);
  gemm::cp_async_commit();
  if (n_tiles > 1) load_kv(1);
  gemm::cp_async_commit();

  // this thread's rows of the tile: ra and ra + 8
  const int ra = row0 + warp * 16 + (lane >> 2);
  const int tig = lane & 3;
  int seg_a = 0, seg_b = 0;
  if constexpr (PACKED) {
    seg_a = ra < S ? __ldg(lens_or_seg + ra) : -2;
    seg_b = ra + 8 < S ? __ldg(lens_or_seg + ra + 8) : -2;
  }
  const float slope = ALIBI ? slopes[h] : 0.f;

  float m_a = kLowest, m_b = kLowest;   // running max
  float l_a = 0.f, l_b = 0.f;           // this thread's share of the sum
  float o[C::kHalves][C::kNO / 2];
#pragma unroll
  for (int hf = 0; hf < C::kHalves; ++hf)
#pragma unroll
    for (int i = 0; i < C::kNO / 2; ++i) o[hf][i] = 0.f;
  float s[kBK / 2];
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) s[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t % kStages;
    gemm::cp_async_wait<1>();     // tile t (and Q) landed; t + 1 may fly
    gemm::fence_async_smem();
    __syncthreads();

    // S = Q K^T over the D real columns
    const uint32_t kt = sk + stage * C::kKVTile;
    gemm::wgmma_fence();
    gemm::fence_fragment(s);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      gemm::wgmma_kk<T, kBK>(
          s,
          gemm::make_desc(sq + (kk >> 2) * (kBQ * 128) + (kk & 3) * 32, 16,
                          1024),
          gemm::make_desc(kt + (kk >> 2) * (kBK * 128) + (kk & 3) * 32, 16,
                          1024),
          kk > 0);
    gemm::wgmma_commit();
    gemm::wgmma_wait_all();
    gemm::fence_fragment(s);

    // scale, bias, mask; s[4 j + e] is (ra + 8 (e / 2), c0 + 8 j + 2 tig +
    // e % 2)
    const int c0 = c_begin + t * kBK;
    const bool clean = (!causal || c0 + kBK - 1 <= row0) && c0 + kBK <= lim &&
                       c0 >= lo;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c0 + 8 * j + 2 * tig + (e & 1);
        float x = __fmul_rn(s[4 * j + e], sm_scale);
        if constexpr (ALIBI)
          x = __fadd_rn(x, __fmul_rn(slope, static_cast<float>(col)));
        if (!clean) {
          const int row = ra + 8 * (e >> 1);
          bool keep = !causal || col <= row;
          if constexpr (PACKED) {
            keep = keep && col < S && __ldg(lens_or_seg + col) ==
                                          (e >> 1 ? seg_b : seg_a);
          } else {
            keep = keep && col < len;
          }
          x = col >= S ? neg_infinity() : keep ? x : kNegInf;
        }
        s[4 * j + e] = x;
      }
    }

    // online softmax: the rows' max over the quad that shares them
    float mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      mx_a = fmaxf(mx_a, fmaxf(s[4 * j], s[4 * j + 1]));
      mx_b = fmaxf(mx_b, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float alpha_a = expf(m_a - mx_a);
    const float alpha_b = expf(m_b - mx_b);
    m_a = mx_a;
    m_b = mx_b;
    l_a *= alpha_a;
    l_b *= alpha_b;
    constexpr int kTerms = p_terms<T>();
    uint32_t pt[kTerms][kBK / 16][4];   // P = the sum of its terms
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      // expf(s - m), as the plain version: NEG_INF - NEG_INF is exactly 0
      const float p0 = expf(s[4 * j] - mx_a);
      const float p1 = expf(s[4 * j + 1] - mx_a);
      const float p2 = expf(s[4 * j + 2] - mx_b);
      const float p3 = expf(s[4 * j + 3] - mx_b);
      l_a += p0 + p1;
      l_b += p2 + p3;
      // n8 block j is half j % 2 of k16 step j / 2: a[0] / a[1] rows
      // ra / ra + 8 at columns 2 tig, a[2] / a[3] the same at 8 + 2 tig
      float r[4] = {p0, p1, p2, p3};
#pragma unroll
      for (int i = 0; i < kTerms; ++i) {
        const uint32_t a0 = gemm::pack2<T>(r[0], r[1]);
        const uint32_t a1 = gemm::pack2<T>(r[2], r[3]);
        pt[i][j >> 1][2 * (j & 1)] = a0;
        pt[i][j >> 1][2 * (j & 1) + 1] = a1;
        const float2 h0 = unpack2<T>(a0);
        const float2 h1 = unpack2<T>(a1);
        r[0] -= h0.x;
        r[1] -= h0.y;
        r[2] -= h1.x;
        r[3] -= h1.y;
      }
    }
#pragma unroll
    for (int hf = 0; hf < C::kHalves; ++hf)
#pragma unroll
      for (int j = 0; j < C::kNO / 8; ++j) {
        o[hf][4 * j] *= alpha_a;
        o[hf][4 * j + 1] *= alpha_a;
        o[hf][4 * j + 2] *= alpha_b;
        o[hf][4 * j + 3] *= alpha_b;
      }

    // O += P V
    const uint32_t vt = sv + stage * C::kKVTile;
    gemm::wgmma_fence();
#pragma unroll
    for (int hf = 0; hf < C::kHalves; ++hf) gemm::fence_fragment(o[hf]);
#pragma unroll
    for (int i = 0; i < kTerms; ++i)
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) gemm::fence_regs(pt[i][kk]);
#pragma unroll
    for (int hf = 0; hf < C::kHalves; ++hf)
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t dv = gemm::make_desc(
            vt + hf * 2 * (kBK * 128) + kk * 16 * 128, kBK * 128, 1024);
#pragma unroll
        for (int i = 0; i < kTerms; ++i)
          gemm::wgmma_rs<T, C::kNO>(o[hf], pt[i][kk], dv, 1);
      }
    gemm::wgmma_commit();
    gemm::wgmma_wait_all();
#pragma unroll
    for (int hf = 0; hf < C::kHalves; ++hf) gemm::fence_fragment(o[hf]);
#pragma unroll
    for (int i = 0; i < kTerms; ++i)
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) gemm::fence_regs(pt[i][kk]);

    __syncthreads();              // every warp is done with this stage
    if (t + kStages < n_tiles) load_kv(t + kStages);
    gemm::cp_async_commit();      // (an empty group keeps the count)
  }
  gemm::cp_async_wait<0>();

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  T* ob = out + static_cast<size_t>(b) * S * q_rs + static_cast<size_t>(h) * D;
#pragma unroll
  for (int hf = 0; hf < C::kHalves; ++hf)
#pragma unroll
    for (int j = 0; j < C::kNO / 8; ++j) {
      const int d = hf * C::kNO + 8 * j + 2 * tig;
      if (d >= D) continue;
      if (ra < S)
        *reinterpret_cast<uint32_t*>(ob + ra * q_rs + d) =
            gemm::pack2<T>(o[hf][4 * j] / l_a, o[hf][4 * j + 1] / l_a);
      if (ra + 8 < S)
        *reinterpret_cast<uint32_t*>(ob + (ra + 8) * q_rs + d) =
            gemm::pack2<T>(o[hf][4 * j + 2] / l_b, o[hf][4 * j + 3] / l_b);
    }
}

// Launch the tile for q's dtype T (bf16 or fp16) at head dim D; causal 0
// (row 10 only) drops the causal mask.
template <typename T, int D, bool PACKED>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* lens_or_seg, const void* slopes, void* out,
                   int B, int S, int Hq, int Hkv, float sm_scale, int causal,
                   cudaStream_t stream) {
  auto kernel = flash_kernel<T, D, PACKED, false>;
  if constexpr (!PACKED) {   // row 13 has no ALiBi branch
    if (slopes != nullptr) kernel = flash_kernel<T, D, false, true>;
  }
  constexpr int smem = Tile<D>::kSmemBytes;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(Hq, B, (S + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(lens_or_seg),
      static_cast<const float*>(slopes), static_cast<T*>(out), S, Hq, Hkv,
      sm_scale, PACKED ? 1 : causal);
  return cudaGetLastError();
}

}  // namespace flash
}  // namespace tllm
