// Row 12: causal GQA prefill attention for long prompts, K/V streamed through
// shared memory in tiles with an online softmax.
//
// Replaces: trtllm_llama_tpu/ops/pallas/attention.py::
// streaming_prefill_attention_kernel, its ALiBi branch included.
//
// Computes, per (b, h, row): scores = (q . k) * sm_scale + slopes[h] * col in
// f32 (ALiBi's key-position form, as the JAX package adds it; the bias term
// is absent when slopes is null), masked to
// cols <= row and cols < seq_lens[b] with the finite NEG_INF of the
// reference (a length of 0 masks every column, and the row then averages V
// over all S columns, as the reference's softmax does), an f32 online
// softmax, and out = (sum_j p_j v_j) / (sum_j p_j) in q's dtype. The K/V head
// is h / (Hq / Hkv) (GQA).
//
// What bounds it on the H100: operations. The causal part is
// 2 * B * Hq * S^2 * D flops (Q K^T and P V): 550 GFLOP per layer at
// S = 8192 with 32 heads of 128, 0.56 ms at 989 TFLOP/s bf16, where its
// q/k/v/out bytes (268 MB) take 0.08 ms. Design: one block per (64-row q
// tile, q head, b), four warps of 16 query rows; the last tiles, which see
// the most keys, launch first. Key tiles past the block's last causal row
// or the sequence length are skipped (all S columns are streamed when the
// length is 0); columns at or past S score -inf, so they never count.
// The bias of a score is added where its column is known: in a bf16 / fp16
// accumulator fragment, lane 4 * gid + tig holds the columns c0 + 8n + 2tig
// and +1 of tile n, the same column the mask reads, so the running max sees
// the biased score; a masked score is exactly NEG_INF, never NEG_INF + bias.
//   - bf16 and fp16: the tensor cores. A warp keeps its Q fragments in
//     registers; each 64-key K/V tile (32 keys at D = 256) is staged in
//     shared memory (rows padded by 16 bytes, so ldmatrix is free of bank
//     conflicts); S = Q K^T and O += P V run as mma.sync.m16n8k16
//     (bf16 or fp16 in, f32 accumulate) with K and V fragments loaded by
//     ldmatrix (V transposed). A thread holds two query rows' running max
//     and sum in f32 registers. P is rounded to q's dtype for P V, as the
//     JAX XLA path rounds the probabilities; the running sum takes P in f32.
//   - f32: the same block and warp tiling on the CUDA cores (32-key tiles,
//     one key per lane, f32 FMAs), so f32 stays exact.
// wgmma, TMA, a cp.async pipeline and warp specialisation are later work.
#include "common.cuh"

using namespace tllm;

namespace {

constexpr int kBQ = 64;              // query rows per block
constexpr int kWarps = 4;            // 16 query rows each
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kBQ / kWarps;
constexpr int kBK = 64;              // keys per staged tile, bf16 / fp16
constexpr int kBKF = 32;             // keys per staged tile, f32 (one per lane)

// The mask of the reference: -inf past S (never counted), NEG_INF outside
// the causal / length mask, the scaled score inside it.
__device__ __forceinline__ float masked(float s, int row, int col, int len,
                                       int S) {
  if (col >= S) return neg_infinity();
  return (col > row || col >= len) ? kNegInf : s;
}

// The scaled, biased and masked score of (row, col).
__device__ __forceinline__ float biased(float s, float sm_scale, float slope,
                                        int row, int col, int len, int S) {
  // no contraction into an fma: the JAX package rounds the product first
  const float v = __fadd_rn(__fmul_rn(s, sm_scale),
                            __fmul_rn(slope, static_cast<float>(col)));
  return masked(v, row, col, len, S);
}

// Keys per staged tile of the mma kernel: kBK, or 32 at D = 256, where a
// thread's O fragments alone take 128 registers.
template <int D>
__host__ __device__ constexpr int mma_keys() {
  return D > 128 ? 32 : kBK;
}

// Two f32 values rounded to T (bf16 or fp16) and packed in one register.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// c += a (16x16, row-major) * b (16x8, column-major); T in, f32 out.
template <typename T>
__device__ __forceinline__ void mma16(float (&c)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1);
template <>
__device__ __forceinline__ void mma16<__nv_bfloat16>(float (&c)[4],
                                                     const uint32_t (&a)[4],
                                                     uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma16<__half>(float (&c)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices; lane t gives the row address of matrix t / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// Columns a block with rows [row0, row0 + kBQ) streams: through its last
// causal row and the last valid column, or all S when the length is 0.
__device__ __forceinline__ int block_cols(int row0, int len, int S) {
  const int last_row = min(row0 + kBQ, S) - 1;
  return (len > 0 ? min(last_row, len - 1) : S - 1) + 1;
}

// ---------------------------------------------------------------------------
// bf16 / fp16: tensor cores. mma.m16n8k16 fragment layouts
// (lane = 4 * gid + tig):
//   A (16x16): a0 = (gid, 2tig..+1), a1 = (gid+8, 2tig..), a2 = (gid, 2tig+8..),
//              a3 = (gid+8, 2tig+8..)
//   B (16x8):  b0 = (k 2tig..+1, n gid), b1 = (k 2tig+8..+9, n gid)
//   C (16x8):  c0,c1 = (gid, 2tig..+1), c2,c3 = (gid+8, 2tig..+1)
// so a score tile's C fragments are P's A fragments for P V.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    streaming_prefill_mma_kernel(const T* __restrict__ q,
                                 const T* __restrict__ k,
                                 const T* __restrict__ v,
                                 const int* __restrict__ seq_lens,
                                 const float* __restrict__ slopes,
                                 T* __restrict__ out, int S, int Hq, int Hkv,
                                 float sm_scale) {
  constexpr int BK = mma_keys<D>();
  constexpr int KS = D / 16;   // k-steps of Q K^T over the head dims
  constexpr int NS = BK / 8;   // score tiles of 8 keys
  constexpr int NO = D / 8;    // output tiles of 8 head dims
  constexpr int LD = D + 8;    // shared row stride in elements (16-byte pad)
  constexpr int CH = D / 8;    // 16-byte chunks per K/V row
  __shared__ __align__(16) T ks[BK * LD];  // 34 KB at D = 128, 33 at 256
  __shared__ __align__(16) T vs[BK * LD];

  const int row0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int len = seq_lens[b];
  const float slope = slopes != nullptr ? slopes[h] : 0.f;
  const size_t q_stride = static_cast<size_t>(Hq) * D;
  const size_t kv_stride = static_cast<size_t>(Hkv) * D;
  const int r_lo = row0 + warp * kRowsPerWarp + gid;  // this thread's rows
  const int r_hi = r_lo + 8;

  uint32_t qf[KS][4];  // A fragments of the warp's 16 rows (rows >= S: 0)
  {
    const T* qb =
        q + static_cast<size_t>(b) * S * q_stride + static_cast<size_t>(h) * D;
    auto ld = [&](int r, int c) -> uint32_t {
      return r < S ? *reinterpret_cast<const uint32_t*>(qb + r * q_stride + c)
                   : 0u;
    };
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int c = kk * 16 + tig * 2;
      qf[kk][0] = ld(r_lo, c);
      qf[kk][1] = ld(r_hi, c);
      qf[kk][2] = ld(r_lo, c + 8);
      qf[kk][3] = ld(r_hi, c + 8);
    }
  }

  float m[2] = {kLowest, kLowest};  // running max of rows r_lo, r_hi
  float l[2] = {0.f, 0.f};          // running sum
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  const int mi = lane >> 3;  // the ldmatrix matrix this lane addresses
  const int n_cols = block_cols(row0, len, S);
  for (int c0 = 0; c0 < n_cols; c0 += BK) {
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < BK * CH; i += kThreads) {
      const int j = i / CH, c = (i - j * CH) * 8, s = c0 + j;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (s < S) {
        const size_t off = (static_cast<size_t>(b) * S + s) * kv_stride +
                           static_cast<size_t>(hk) * D + c;
        kv = *reinterpret_cast<const uint4*>(k + off);
        vv = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(ks + j * LD + c) = kv;
      *reinterpret_cast<uint4*>(vs + j * LD + c) = vv;
    }
    __syncthreads();

    float sc[NS][4];  // S = Q K^T, 16 rows x BK keys
#pragma unroll
    for (int n = 0; n < NS; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int n = 0; n < NS; n += 2) {
        // matrices 0-3: keys of tile n, dims kk*16 / +8; tile n+1, the same
        uint32_t r[4];
        ldmatrix_x4(r, ks + ((n + (mi >> 1)) * 8 + (lane & 7)) * LD + kk * 16 +
                           (mi & 1) * 8);
        mma16<T>(sc[n], qf[kk], r[0], r[1]);
        mma16<T>(sc[n + 1], qf[kk], r[2], r[3]);
      }
    }

    float mx[2] = {kLowest, kLowest};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c0 + n * 8 + tig * 2 + (e & 1);
        sc[n][e] = biased(sc[n][e], sm_scale, slope, e < 2 ? r_lo : r_hi, col,
                          len, S);
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
      }
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // a row's BK columns lie in one lane quad
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[n][e] = expf(sc[n][e] - m[e >> 1]);
        rs[e >> 1] += sc[n][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = l[r] * alpha[r] + rs[r];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V: P's A fragments are the score tiles 2kk and 2kk+1
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack2<T>(sc[2 * kk][0], sc[2 * kk][1]),
                             pack2<T>(sc[2 * kk][2], sc[2 * kk][3]),
                             pack2<T>(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                             pack2<T>(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        // matrices 0-3 (transposed): keys kk*16 / +8 at dims of tile n; the
        // same at tile n+1
        uint32_t r[4];
        ldmatrix_x4_trans(r, vs + (kk * 16 + (mi & 1) * 8 + (lane & 7)) * LD +
                                 (n + (mi >> 1)) * 8);
        mma16<T>(o[n], a, r[0], r[1]);
        mma16<T>(o[n + 1], a, r[2], r[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r == 0 ? r_lo : r_hi;
    if (row >= S) continue;
    const float inv = 1.f / l[r];
    T* ob = out + (static_cast<size_t>(b) * S + row) * q_stride +
            static_cast<size_t>(h) * D + tig * 2;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(ob + n * 8) =
          pack2<T>(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores, the same 64-row blocks of four 16-row warps; dynamic
// shared memory holds the block's queries and one 32-key K/V tile.
// ---------------------------------------------------------------------------
template <int D>
constexpr int f32_smem_bytes() {
  return (kBQ * D + kBKF * (D + 1) + kBKF * D) * 4;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    streaming_prefill_f32_kernel(const float* __restrict__ q,
                                 const float* __restrict__ k,
                                 const float* __restrict__ v,
                                 const int* __restrict__ seq_lens,
                                 const float* __restrict__ slopes,
                                 float* __restrict__ out, int S, int Hq,
                                 int Hkv, float sm_scale) {
  constexpr int DL = D / 32;  // head dims per lane
  extern __shared__ float smem[];
  float* qs = smem;                  // [kBQ][D]
  float* ks = qs + kBQ * D;          // [kBKF][D + 1] (padded: lane-per-key dots)
  float* vs = ks + kBKF * (D + 1);   // [kBKF][D]

  const int row0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int len = seq_lens[b];
  const float slope = slopes != nullptr ? slopes[h] : 0.f;
  const size_t q_stride = static_cast<size_t>(Hq) * D;
  const size_t kv_stride = static_cast<size_t>(Hkv) * D;

  for (int i = threadIdx.x; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i - r * D, s = row0 + r;
    qs[i] = s < S ? q[(static_cast<size_t>(b) * S + s) * q_stride +
                      static_cast<size_t>(h) * D + d]
                  : 0.f;
  }
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DL];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = kLowest;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < DL; ++i) acc[rr][i] = 0.f;
  }

  const int n_cols = block_cols(row0, len, S);
  for (int c0 = 0; c0 < n_cols; c0 += kBKF) {
    __syncthreads();  // previous tile consumed (first pass: qs written)
    for (int i = threadIdx.x; i < kBKF * D; i += kThreads) {
      const int j = i / D, d = i - j * D, s = c0 + j;
      float kv = 0.f, vv = 0.f;
      if (s < S) {
        const size_t off = (static_cast<size_t>(b) * S + s) * kv_stride +
                           static_cast<size_t>(hk) * D + d;
        kv = k[off];
        vv = v[off];
      }
      ks[j * (D + 1) + d] = kv;
      vs[j * D + d] = vv;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      const float* qr = qs + r * D;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], ks[lane * (D + 1) + d], s);
      s = biased(s, sm_scale, slope, row0 + r, c0 + lane, len, S);
      const float m_new = fmaxf(m[rr], warp_max(s));
      const float p = expf(s - m_new);
      const float alpha = expf(m[rr] - m_new);
      l[rr] = l[rr] * alpha + warp_sum(p);
#pragma unroll
      for (int i = 0; i < DL; ++i) acc[rr][i] *= alpha;
#pragma unroll 4
      for (int j = 0; j < kBKF; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int i = 0; i < DL; ++i)
          acc[rr][i] = fmaf(pj, vs[j * D + lane + 32 * i], acc[rr][i]);
      }
      m[rr] = m_new;
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = row0 + warp * kRowsPerWarp + rr;
    if (row >= S) continue;
    float* o = out + (static_cast<size_t>(b) * S + row) * q_stride +
               static_cast<size_t>(h) * D;
#pragma unroll
    for (int i = 0; i < DL; ++i) o[lane + 32 * i] = acc[rr][i] / l[rr];
  }
}

template <typename T, int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const void* seq_lens, const void* slopes, void* out,
                       int B, int S, int Hq, int Hkv, float sm_scale,
                       cudaStream_t stream) {
  const dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  streaming_prefill_mma_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(seq_lens),
      static_cast<const float*>(slopes), static_cast<T*>(out), S, Hq, Hkv,
      sm_scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v,
                   const void* seq_lens, const void* slopes, void* out, int B,
                   int S, int Hq, int Hkv, float sm_scale,
                   cudaStream_t stream) {
  if (dtype == kBF16)
    return launch_mma<__nv_bfloat16, D>(q, k, v, seq_lens, slopes, out, B, S,
                                        Hq, Hkv, sm_scale, stream);
  if (dtype == kF16)
    return launch_mma<__half, D>(q, k, v, seq_lens, slopes, out, B, S, Hq,
                                 Hkv, sm_scale, stream);
  if (dtype != kF32) return cudaErrorInvalidValue;
  const dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  constexpr int smem = f32_smem_bytes<D>();
  const cudaError_t err = allow_smem(streaming_prefill_f32_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  streaming_prefill_f32_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(seq_lens),
      static_cast<const float*>(slopes), static_cast<float*>(out), S, Hq, Hkv,
      sm_scale);
  return cudaGetLastError();
}

}  // namespace

// q [B, S, Hq, D], k/v [B, S, Hkv, D] (dtype; 16-byte aligned), seq_lens [B]
// int32, slopes [Hq] f32 ALiBi slopes or null, out [B, S, Hq, D] (dtype).
// D in {32, 64, 96, 128, 256}; Hq % Hkv == 0.
extern "C" int tllm_streaming_prefill_attention(
    const void* q, const void* k, const void* v, const void* seq_lens,
    const void* slopes, void* out, int dtype, int B, int S, int Hq, int Hkv,
    int D, float sm_scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch<32>(dtype, q, k, v, seq_lens, slopes, out, B, S, Hq, Hkv,
                        sm_scale, s);
    case 64:
      return launch<64>(dtype, q, k, v, seq_lens, slopes, out, B, S, Hq, Hkv,
                        sm_scale, s);
    case 96:
      return launch<96>(dtype, q, k, v, seq_lens, slopes, out, B, S, Hq, Hkv,
                        sm_scale, s);
    case 128:
      return launch<128>(dtype, q, k, v, seq_lens, slopes, out, B, S, Hq, Hkv,
                         sm_scale, s);
    case 256:
      return launch<256>(dtype, q, k, v, seq_lens, slopes, out, B, S, Hq, Hkv,
                         sm_scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
