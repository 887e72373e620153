// The bf16 / fp16 body of row 12 (streaming_prefill_attention.cu) at head
// dims 64, 96 and 128: a GQA flash-attention tile for long prompts, causal or
// (`causal` 0) bidirectional, warp-specialized for Hopper (TMA, mbarriers,
// wgmma, setmaxnreg; sm_90a).
//
// Contract, per (b, h, row): scores = (q . k) * sm_scale [+ slopes[h] * col]
// in f32, the product and the sum rounded on their own (__fmul_rn /
// __fadd_rn, as the JAX package rounds them); masked to col <= row (when
// causal) and col < lens[b] with the reference's finite NEG_INF, never
// NEG_INF + bias;
// columns at or past S score -inf (a length of 0 averages V over exactly S
// columns); an f32 online softmax; out = (sum_j p_j v_j) / (sum_j p_j) in
// q's dtype. The K/V head is h / (Hq / Hkv). P keeps f32's precision
// through P V, as the Pallas kernel this replaces keeps it: the products
// take P as the sum of flash::p_terms<T>() terms of q's dtype (three bf16,
// two fp16), so the tile differs from the plain version in the order of
// the f32 sums only (one bf16 term moved path 7's prefill logits by a
// third of their largest magnitude, attention_precision.py).
//
// What bounds it on the H100: operations. At path 5's 8192 rows and 32
// heads of 128 the causal Q K^T and P V are 550 GFLOP (0.56 ms at 989
// TFLOP/s bf16); carrying P in three terms makes P V three products, ~1.1
// TFLOP of tensor work (1.1 ms). Its q/k/v/out bytes (268 MB) take 0.08 ms.
// The CUDA-core work of every score (the scale, the exact expf, the terms'
// split, O's rescale) comes close to the tensor time, so the design's aim
// is to run the two side by side. One block of three warpgroups per
// (128-row query tile, q head, b), the tiles that see the most keys
// launched first (blockIdx.z counts from the last tile):
//   - two consumer warpgroups of 64 query rows each share every K/V tile
//     that lands in shared memory, which halves the K/V traffic into shared
//     memory against row 10's one-warpgroup tile (~4.3 GB instead of ~8.6
//     at 8192 rows and 32 heads); each holds its Q rows in registers, in
//     wgmma's A layout, for the whole block;
//   - the producer warpgroup keeps a kStages-deep ring of 64-key K/V tiles
//     full: one thread issues TMA loads (cp.async.bulk.tensor, 128B-swizzled
//     64-column boxes of the [B, S, H, D] tensors, completion on the
//     stage's full mbarrier); the consumers release a stage through its
//     empty mbarrier once their P V of it is done. Rows past S are the
//     boxes' out-of-bounds rows, zero-filled by the TMA unit, and so are
//     the columns past D (D = 96 in a 128-column tile). The producer
//     drops to 24 registers (setmaxnreg) and the consumers take 240;
//   - the consumers take turns on the tensor cores through two named
//     barriers (ping-pong): a turn issues S = Q K^T of tile t and O += P V
//     of tile t - 1, then hands the tensor cores to the other warpgroup
//     and runs tile t's scale, mask and online softmax while the other's
//     products run (ptxas schedules the exps after the wait for the turn's
//     own P V, so that P V overlaps the scale and mask only);
//   - S = Q K^T: wgmma m64n64k16, A (Q) from registers, B = K K-major from
//     shared memory; the scale, bias and mask where each accumulator
//     element's (row, col) is known, the mask only on tiles that cross the
//     diagonal or the length; P's terms packed from the S accumulator into
//     wgmma's register A fragments (bf16: truncated remainders, packed by
//     byte permutes); O += P V: one wgmma m64n{64,128}k16 per term, A from
//     registers, B = V through the transpose bit, O in f32 registers.
// Every wgmma operand is settled before a turn's wgmma.fence, and no wgmma
// sits in a branch or after a spin loop the compiler sees: ptxas serializes
// the wgmmas otherwise (its C7513 / C7520 notes).
// Both warpgroups stream the block's key tiles, through its last row (causal)
// or through the last valid column (not causal: every block streams the
// same tiles): the first warpgroup's last causal tile lies above its
// diagonal and scores NEG_INF there (p = 0), which keeps the two in step on
// the ring and the barriers.
// Head dims 32 and 256 stay on row 10's tile (flash_attention.cuh; the
// entry dispatches by shape before launch).
#pragma once

#include <cuda.h>   // CUtensorMap and its enums; the encoder is found at run time

#include <type_traits>

#include "common.cuh"
#include "flash_attention.cuh"
#include "wgmma.cuh"

namespace tllm {
namespace flash_ws {

constexpr int kBQ = 64;                  // query rows of a consumer
constexpr int kConsumers = 2;
constexpr int kRows = kBQ * kConsumers;  // query rows of a block
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kStages = 4;               // the K/V ring
constexpr int kBK = 64;                  // keys of a K/V tile (a TMA box)
constexpr int kBarTurn = 1;              // named barriers 1, 2: the turns

template <int D>
struct Tile {
  static constexpr int kDP = (D + 63) / 64 * 64;   // D in whole 64-column atoms
  static constexpr int kAtoms = kDP / 64;
  static constexpr int kKVTile = kBK * kDP * 2;
  static constexpr int kOffV = kStages * kKVTile;
  // + 1024: the base is rounded up to the 1024-byte swizzle period
  static constexpr int kSmemBytes = 2 * kStages * kKVTile + 1024;
  static_assert(kDP <= 128, "one P V wgmma covers the head dim");
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// One arrival that also tells the barrier to expect `bytes` of TMA data.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` has completed. The spin stays
// inside the asm: a loop the compiler sees would make the wgmma path after
// it look divergent, and ptxas would serialize the wgmmas.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// The box of `map` at coordinates (c0 innermost .. c3) into shared memory at
// dst, completing on the mbarrier at bar.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// q [B, S, Hq, D]; k/v [B, S, Hkv, D] through the tensor maps; lens [B];
// slopes [Hq] when ALIBI; out like q; causal 0 drops col <= row. Grid
// (Hq, B, ceil(S / kRows)).
template <typename T, int D, bool ALIBI>
__global__ void __launch_bounds__(kThreads, 1)
    flash_ws_kernel(const T* __restrict__ q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const int* __restrict__ lens,
                    const float* __restrict__ slopes, T* __restrict__ out,
                    int S, int Hq, int Hkv, float sm_scale, int causal) {
  using C = Tile<D>;
  extern __shared__ uint8_t ws_smem[];
  __shared__ __align__(8) uint64_t bars[2 * kStages];  // full[s], empty[s]
  const uint32_t sk = (gemm::smem_addr(ws_smem) + 1023) & ~1023u;
  const uint32_t sv = sk + C::kOffV;
  const uint32_t full0 = gemm::smem_addr(&bars[0]);
  const uint32_t empty0 = full0 + 8 * kStages;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int row0 = (gridDim.z - 1 - blockIdx.z) * kRows;
  const int len = lens[b];
  // the columns to stream: through the block's last causal row (all S when
  // not causal) and the last valid column; all S when the length is 0
  // (every column then scores NEG_INF and the row averages V)
  const int last = causal ? min(row0 + kRows, S) - 1 : S - 1;
  const int c_end = (len > 0 ? min(last, len - 1) : S - 1) + 1;
  const int n_tiles = (c_end + kBK - 1) / kBK;
  // the warpgroup's role, warp-uniform as the compiler sees it
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      const int hk = h / (Hq / Hkv);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages;
        // the stage's previous tile released (passes at once in round 0)
        mbar_wait(empty0 + 8 * st, ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(full0 + 8 * st, 2 * C::kKVTile);
        for (int a = 0; a < C::kAtoms; ++a) {
          tma_load_4d(sk + st * C::kKVTile + a * (kBK * 128), &tm_k,
                      full0 + 8 * st, a * 64, hk, t * kBK, b);
          tma_load_4d(sv + st * C::kKVTile + a * (kBK * 128), &tm_v,
                      full0 + 8 * st, a * 64, hk, t * kBK, b);
        }
      }
    }
    return;
  }

  // consumer c: rows [row0 + 64 c, row0 + 64 c + 64)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int c = wg - 1;
  const int tid = threadIdx.x - 128 * wg;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int tig = lane & 3;
  const int rw0 = row0 + c * kBQ;
  const int ra = rw0 + warp * 16 + (lane >> 2);   // rows ra and ra + 8
  const float slope = ALIBI ? slopes[h] : 0.f;
  constexpr int kTerms = flash::p_terms<T>();
  constexpr int kNO = C::kDP;   // columns of the P V wgmma

  float m_a = kLowest, m_b = kLowest;   // running max
  float l_a = 0.f, l_b = 0.f;           // this thread's share of the sum
  float o[kNO / 2];
#pragma unroll
  for (int i = 0; i < kNO / 2; ++i) o[i] = 0.f;
  uint32_t pt[kTerms][kBK / 16][4];    // P's terms of the tile whose P V is next
  // Q of rows ra and ra + 8 in wgmma's register A layout, k16 step kk: the
  // pairs at columns 16 kk + 2 tig and 16 kk + 8 + 2 tig (rows past S: 0)
  uint32_t qa[D / 16][4];
  {
    const size_t q_rs = static_cast<size_t>(Hq) * D;
    const T* qb = q + static_cast<size_t>(b) * S * q_rs +
                  static_cast<size_t>(h) * D + 2 * tig;
    auto ld = [&](int r, int col) -> uint32_t {
      return r < S ? __ldg(reinterpret_cast<const unsigned int*>(
                         qb + r * q_rs + col))
                   : 0u;
    };
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qa[kk][0] = ld(ra, 16 * kk);
      qa[kk][1] = ld(ra + 8, 16 * kk);
      qa[kk][2] = ld(ra, 16 * kk + 8);
      qa[kk][3] = ld(ra + 8, 16 * kk + 8);
    }
  }

  // A fresh S fragment each turn, zeroed and settled with O and P's terms
  // before the turn's first wgmma.fence: a register write the compiler sank
  // past it (the rescale of O, the zeroing) would make ptxas serialize the
  // wgmmas.
  using Frag = float[kBK / 2];
  auto fence_operands = [&](Frag& sf) {
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) sf[i] = 0.f;
    gemm::fence_fragment(sf);
    gemm::fence_fragment(o);
#pragma unroll
    for (int i = 0; i < kTerms; ++i)
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) gemm::fence_regs(pt[i][kk]);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) gemm::fence_regs(qa[kk]);
  };
  // S = Q K^T of tile t into sf (the stage holding it has landed)
  auto issue_qk = [&](int t, Frag& sf) {
    const uint32_t kt = sk + (t % kStages) * C::kKVTile;
    gemm::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      gemm::wgmma_rk<T>(
          sf, qa[kk],
          gemm::make_desc(kt + (kk >> 2) * (kBK * 128) + (kk & 3) * 32, 16,
                          1024),
          kk > 0);
    gemm::wgmma_commit();
  };
  // O += P V of tile t, P's terms in pt
  auto issue_pv = [&](int t) {
    const uint32_t vt = sv + (t % kStages) * C::kKVTile;
    gemm::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t dv = gemm::make_desc(vt + kk * 16 * 128, kBK * 128, 1024);
#pragma unroll
      for (int i = 0; i < kTerms; ++i)
        gemm::wgmma_rs<T, kNO>(o, pt[i][kk], dv, 1);
    }
    gemm::wgmma_commit();
  };
  // P V of tile t done: O and P's registers are free, the stage released
  auto finish_pv = [&](int t) {
    gemm::fence_fragment(o);
#pragma unroll
    for (int i = 0; i < kTerms; ++i)
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) gemm::fence_regs(pt[i][kk]);
    mbar_arrive(empty0 + 8 * (t % kStages));
  };
  // tile t's scale, bias, mask and online softmax, in place: sf becomes P
  // (relative to the new running max), alpha_a / alpha_b the rescale of
  // what came before
  auto softmax = [&](int t, Frag& sf, float& alpha_a, float& alpha_b) {
    gemm::fence_fragment(sf);
    // sf[4 j + e] is (ra + 8 (e / 2), c0 + 8 j + 2 tig + e % 2); a tile
    // needs the mask unless it lies below the diagonal of every row of this
    // warpgroup (or the call is not causal) and inside the length
    const int c0 = t * kBK;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = __fmul_rn(sf[4 * j + e], sm_scale);
        if constexpr (ALIBI)
          x = __fadd_rn(x, __fmul_rn(slope, static_cast<float>(
                                                c0 + 8 * j + 2 * tig + (e & 1))));
        sf[4 * j + e] = x;
      }
    }
    if (!((!causal || c0 + kBK - 1 <= rw0) && c0 + kBK <= len)) {
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + 8 * j + 2 * tig + (e & 1);
          const int row = ra + 8 * (e >> 1);
          const bool keep = (!causal || col <= row) && col < len;
          sf[4 * j + e] = col >= S ? neg_infinity() : keep ? sf[4 * j + e]
                                                           : kNegInf;
        }
      }
    }
    float mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      mx_a = fmaxf(mx_a, fmaxf(sf[4 * j], sf[4 * j + 1]));
      mx_b = fmaxf(mx_b, fmaxf(sf[4 * j + 2], sf[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    alpha_a = expf(m_a - mx_a);
    alpha_b = expf(m_b - mx_b);
    m_a = mx_a;
    m_b = mx_b;
    l_a *= alpha_a;
    l_b *= alpha_b;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      // expf(s - m), as the plain version: NEG_INF - NEG_INF is exactly 0
      sf[4 * j] = expf(sf[4 * j] - mx_a);
      sf[4 * j + 1] = expf(sf[4 * j + 1] - mx_a);
      sf[4 * j + 2] = expf(sf[4 * j + 2] - mx_b);
      sf[4 * j + 3] = expf(sf[4 * j + 3] - mx_b);
      l_a += sf[4 * j] + sf[4 * j + 1];
      l_b += sf[4 * j + 2] + sf[4 * j + 3];
    }
  };
  // P (sf) into pt as the sum of its terms; n8 block j of sf is half j % 2
  // of k16 step j / 2 of wgmma's register A layout. bf16: each term is the
  // remainder truncated to its top 16 bits (p >= 0, so the remainder
  // p - term is exact and has 8 fewer significant bits: three terms carry
  // all 24), packed by a byte permute, with no float conversion; fp16 rounds
  // its two terms as flash::p_terms describes.
  auto to_terms = [&](const Frag& sf) {
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      float r[4] = {sf[4 * j], sf[4 * j + 1], sf[4 * j + 2], sf[4 * j + 3]};
#pragma unroll
      for (int i = 0; i < kTerms; ++i) {
        uint32_t a0, a1;
        if constexpr (std::is_same<T, __nv_bfloat16>::value) {
          uint32_t u[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) u[e] = __float_as_uint(r[e]);
          a0 = __byte_perm(u[0], u[1], 0x7632);
          a1 = __byte_perm(u[2], u[3], 0x7632);
          if (i + 1 < kTerms) {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              r[e] -= __uint_as_float(u[e] & 0xffff0000u);
          }
        } else {
          a0 = gemm::pack2<T>(r[0], r[1]);
          a1 = gemm::pack2<T>(r[2], r[3]);
          const float2 h0 = flash::unpack2<T>(a0);
          const float2 h1 = flash::unpack2<T>(a1);
          r[0] -= h0.x;
          r[1] -= h0.y;
          r[2] -= h1.x;
          r[3] -= h1.y;
        }
        pt[i][j >> 1][2 * (j & 1)] = a0;
        pt[i][j >> 1][2 * (j & 1) + 1] = a1;
      }
    }
  };

  // Turns on the tensor cores alternate between the consumers: consumer c
  // waits on named barrier kBarTurn + c and hands over on the other's.
  // Consumer 0 takes the first turn; consumer 1 skips its last hand-over,
  // so every arrival on either barrier meets a wait.
  if (c == 1) bar_arrive(kBarTurn, 2 * 128);
  float alpha_a, alpha_b;
  {  // turn 0: S of tile 0
    float sf[kBK / 2];
    mbar_wait(full0, 0);
    bar_sync(kBarTurn + c, 2 * 128);
    fence_operands(sf);
    issue_qk(0, sf);
    bar_arrive(kBarTurn + 1 - c, 2 * 128);
    gemm::wgmma_wait<0>();
    softmax(0, sf, alpha_a, alpha_b);
    to_terms(sf);
  }
  // turn t: S of tile t and P V of tile t - 1; tile t's softmax runs while
  // the other consumer's products do
  for (int t = 1; t < n_tiles; ++t) {
    float sf[kBK / 2];
    mbar_wait(full0 + 8 * (t % kStages), (t / kStages) & 1);
    bar_sync(kBarTurn + c, 2 * 128);
    fence_operands(sf);
    issue_qk(t, sf);
    issue_pv(t - 1);
    bar_arrive(kBarTurn + 1 - c, 2 * 128);
    gemm::wgmma_wait<1>();
    softmax(t, sf, alpha_a, alpha_b);
    gemm::wgmma_wait<0>();
    finish_pv(t - 1);
#pragma unroll
    for (int j = 0; j < kNO / 8; ++j) {
      o[4 * j] *= alpha_a;
      o[4 * j + 1] *= alpha_a;
      o[4 * j + 2] *= alpha_b;
      o[4 * j + 3] *= alpha_b;
    }
    to_terms(sf);
  }
  {  // the last turn: P V of the last tile (sf only settles the operands)
    float sf[kBK / 2];
    bar_sync(kBarTurn + c, 2 * 128);
    fence_operands(sf);
    issue_pv(n_tiles - 1);
    if (c == 0) bar_arrive(kBarTurn + 1, 2 * 128);
    gemm::wgmma_wait<0>();
    finish_pv(n_tiles - 1);
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const size_t q_rs = static_cast<size_t>(Hq) * D;
  T* ob = out + static_cast<size_t>(b) * S * q_rs + static_cast<size_t>(h) * D;
#pragma unroll
  for (int j = 0; j < kNO / 8; ++j) {
    const int d = 8 * j + 2 * tig;
    if (d >= D) continue;
    if (ra < S)
      *reinterpret_cast<uint32_t*>(ob + ra * q_rs + d) =
          gemm::pack2<T>(o[4 * j] / l_a, o[4 * j + 1] / l_a);
    if (ra + 8 < S)
      *reinterpret_cast<uint32_t*>(ob + (ra + 8) * q_rs + d) =
          gemm::pack2<T>(o[4 * j + 2] / l_b, o[4 * j + 3] / l_b);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime loaded, so the library
// links no libcuda; null where the driver has none.
inline EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The map of a [B, S, H, D] tensor of T read in boxes of 64 columns (128
// bytes, swizzled as wgmma's descriptor reads them) x 64 rows of one head
// of one sequence; out-of-bounds rows and columns read as zeros.
template <typename T>
cudaError_t make_map(CUtensorMap* map, const void* base, int B, int S, int H,
                     int D) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t e = sizeof(T);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {D * e, static_cast<cuuint64_t>(H) * D * e,
                                 static_cast<cuuint64_t>(S) * H * D * e};
  const cuuint32_t box[4] = {64, 1, kBK, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map,
      std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, const_cast<void*>(base), dims, strides, box, step,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Launch the tile for q's dtype T (bf16 or fp16) at head dim D (64, 96,
// 128); slopes null for no ALiBi; causal 0 drops the causal mask.
template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* lens, const void* slopes, void* out, int B,
                   int S, int Hq, int Hkv, float sm_scale, int causal,
                   cudaStream_t stream) {
  CUtensorMap mk, mv;
  cudaError_t err = make_map<T>(&mk, k, B, S, Hkv, D);
  if (err == cudaSuccess) err = make_map<T>(&mv, v, B, S, Hkv, D);
  if (err != cudaSuccess) return err;
  const auto kernel = slopes != nullptr ? flash_ws_kernel<T, D, true>
                                        : flash_ws_kernel<T, D, false>;
  constexpr int smem = Tile<D>::kSmemBytes;
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(Hq, B, (S + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), mk, mv, static_cast<const int*>(lens),
      static_cast<const float*>(slopes), static_cast<T*>(out), S, Hq, Hkv,
      sm_scale, causal);
  return cudaGetLastError();
}

}  // namespace flash_ws
}  // namespace tllm
