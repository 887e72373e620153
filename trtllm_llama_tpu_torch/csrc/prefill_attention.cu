// Row 10: GQA prefill (context-phase) attention, causal, or bidirectional
// (`causal` 0: the encoder's and the prefix-LM context's mask, col < len
// alone, as the JAX package's prefill_attention(causal=False)).
//
// Replaces: trtllm_llama_tpu/ops/pallas/attention.py::prefill_attention_kernel
// (its ALiBi branch included), for prompts of up to prefill_streaming_min_s
// (2048) rows; longer ones take row 12 (streaming_prefill_attention.cu).
//
// Computes, per (b, h, row): scores = (q . k) * sm_scale + slopes[h] * col in
// f32 (ALiBi's key-position form, as the JAX package adds it; no bias when
// slopes is null), masked to cols <= row (when causal) and cols <
// seq_lens[b] with the
// finite NEG_INF of the reference (never NEG_INF + bias; a length of 0 masks
// every column, and the row averages V over exactly the S columns: columns
// at or past S score -inf), an f32 softmax, and (p @ v) / sum(p) cast to
// q's dtype. The K/V head is h / (Hq / Hkv) (GQA).
//
// What bounds it on the H100: the bytes the contract reads and writes
// (q and out of every row, K and V of each sequence's min(len, S) valid
// rows) and launch latency at the main path's S = 16; at Task A's 1024
// rows (923 valid) still the bytes, 0.0095 ms, with the causal
// 4 * Hq * D * pairs flops close behind, which only the tensor cores
// serve at rate.
//   - bf16 and fp16: the wgmma flash-attention tile of flash_attention.cuh
//     (one warpgroup per 64-row query tile, a 2-stage cp.async K/V ring,
//     S = Q K^T and O += P V on wgmma, the online softmax in registers, P
//     carried through P V as three bf16 (two fp16) terms so that it keeps
//     f32's precision, the mask only on edge tiles). On an H100 80GB HBM3
//     at 700 W, Task A's B=1 S=1024 len 923 with 32 heads of 128 takes
//     0.0490 ms (0.72x SDPA with the same mask, 19% of the byte bound),
//     where the CUDA-core loop below took 1.2989 ms in bf16 (chip_smoke.py;
//     PERF.md).
//   - f32 (the smoke's f32 reference runs): the exact CUDA-core body
//     below: one block per (b, h, 16-row q tile), four warps of four rows;
//     32-key K/V tiles staged in shared memory as f32 (K padded to D+1
//     columns so the lane-per-key dot product is free of bank conflicts),
//     tiles past the block's last causal (when causal) or valid column
//     skipped, each
//     row's running max, denominator and D/32 accumulators per lane in
//     registers.
#include <type_traits>

#include "common.cuh"
#include "flash_attention.cuh"

using namespace tllm;

namespace {

// the f32 body
constexpr int kBQ = 16;      // query rows per block
constexpr int kBK = 32;      // key rows per staged tile (one per lane)
constexpr int kWarps = 4;
constexpr int kRows = kBQ / kWarps;  // query rows per warp

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
    prefill_attention_f32(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const int* __restrict__ seq_lens,
                          const float* __restrict__ slopes,
                          T* __restrict__ out, int S, int Hq, int Hkv,
                          float sm_scale, int causal) {
  constexpr int DL = D / 32;  // head dims per lane
  extern __shared__ float prefill_smem[];
  auto qs = reinterpret_cast<float (*)[D]>(prefill_smem);
  auto ks = reinterpret_cast<float (*)[D + 1]>(prefill_smem + kBQ * D);
  auto vs = reinterpret_cast<float (*)[D]>(prefill_smem + kBQ * D +
                                           kBK * (D + 1));

  const int row0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int len = seq_lens[b];
  const float slope = slopes != nullptr ? slopes[h] : 0.f;

  for (int i = threadIdx.x; i < kBQ * D; i += blockDim.x) {
    const int r = i / D, d = i - (i / D) * D, s = row0 + r;
    qs[r][d] = s < S ? to_f(q[((static_cast<size_t>(b) * S + s) * Hq + h) * D + d])
                     : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][DL];
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    m[rr] = kLowest;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < DL; ++i) acc[rr][i] = 0.f;
  }

  // Columns that can be unmasked for some row of this block (every valid
  // one when not causal). A sequence of length 0 masks everything; the
  // reference then averages over all S columns, so stream them all.
  const int last_row = causal ? min(row0 + kBQ, S) - 1 : S - 1;
  const int n_cols = (len > 0 ? min(last_row, len - 1) : S - 1) + 1;

  for (int c0 = 0; c0 < n_cols; c0 += kBK) {
    __syncthreads();  // previous tile consumed (first pass: qs written)
    for (int i = threadIdx.x; i < kBK * D; i += blockDim.x) {
      const int j = i / D, d = i - (i / D) * D, s = c0 + j;
      float kv = 0.f, vv = 0.f;
      if (s < S) {
        const size_t off = ((static_cast<size_t>(b) * S + s) * Hkv + hk) * D + d;
        kv = to_f(k[off]);
        vv = to_f(v[off]);
      }
      ks[j][d] = kv;
      vs[j][d] = vv;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      const int r = warp * kRows + rr;
      const int row = row0 + r;
      const int col = c0 + lane;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s = fmaf(qs[r][d], ks[lane][d], s);
      // no contraction into an fma: the JAX package rounds the product first
      s = __fadd_rn(__fmul_rn(s, sm_scale), __fmul_rn(slope, static_cast<float>(col)));
      if (col >= S) {
        s = neg_infinity();  // padding of the last tile: never counted
      } else if (!((!causal || col <= row) && col < len)) {
        s = kNegInf;
      }
      const float m_new = fmaxf(m[rr], warp_max(s));
      const float p = expf(s - m_new);
      const float alpha = expf(m[rr] - m_new);
      l[rr] = l[rr] * alpha + warp_sum(p);
#pragma unroll
      for (int i = 0; i < DL; ++i) acc[rr][i] *= alpha;
#pragma unroll 4
      for (int j = 0; j < kBK; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int i = 0; i < DL; ++i) acc[rr][i] = fmaf(pj, vs[j][lane + 32 * i], acc[rr][i]);
      }
      m[rr] = m_new;
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    const int row = row0 + warp * kRows + rr;
    if (row >= S) continue;
    T* o = out + ((static_cast<size_t>(b) * S + row) * Hq + h) * D;
#pragma unroll
    for (int i = 0; i < DL; ++i) o[lane + 32 * i] = from_f<T>(acc[rr][i] / l[rr]);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* seq_lens, const void* slopes, void* out, int B,
                   int S, int Hq, int Hkv, float sm_scale, int causal,
                   cudaStream_t stream) {
  if constexpr (!std::is_same<T, float>::value) {
    return flash::launch<T, D, false>(q, k, v, seq_lens, slopes, out, B, S,
                                      Hq, Hkv, sm_scale, causal, stream);
  } else {
    const dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
    constexpr int smem = (kBQ * D + kBK * (D + 1) + kBK * D) * 4;
    const cudaError_t err = allow_smem(prefill_attention_f32<T, D>, smem);
    if (err != cudaSuccess) return err;
    prefill_attention_f32<T, D><<<grid, kWarps * 32, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const int*>(seq_lens),
        static_cast<const float*>(slopes), static_cast<T*>(out), S, Hq, Hkv,
        sm_scale, causal);
    return cudaGetLastError();
  }
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     const void* seq_lens, const void* slopes, void* out, int B,
                     int S, int Hq, int Hkv, float sm_scale, int causal,
                     cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, seq_lens, slopes, out, B, S, Hq, Hkv, sm_scale, causal, stream);
    case 64: return launch<T, 64>(q, k, v, seq_lens, slopes, out, B, S, Hq, Hkv, sm_scale, causal, stream);
    case 96: return launch<T, 96>(q, k, v, seq_lens, slopes, out, B, S, Hq, Hkv, sm_scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, seq_lens, slopes, out, B, S, Hq, Hkv, sm_scale, causal, stream);
    case 256: return launch<T, 256>(q, k, v, seq_lens, slopes, out, B, S, Hq, Hkv, sm_scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, S, Hq, D], k/v [B, S, Hkv, D] (dtype), seq_lens [B] int32, slopes
// [Hq] f32 ALiBi slopes or null, out [B, S, Hq, D] (dtype). D in
// {32, 64, 96, 128, 256}; Hq % Hkv == 0; causal 0 drops col <= row.
extern "C" int tllm_prefill_attention(const void* q, const void* k,
                                      const void* v, const void* seq_lens,
                                      const void* slopes, void* out, int dtype,
                                      int B, int S, int Hq, int Hkv, int D,
                                      int causal, float sm_scale, int device,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch_d<__nv_bfloat16>(D, q, k, v, seq_lens, slopes, out, B, S, Hq, Hkv, sm_scale, causal, s);
  if (dtype == kF16)
    return launch_d<__half>(D, q, k, v, seq_lens, slopes, out, B, S, Hq, Hkv, sm_scale, causal, s);
  if (dtype == kF32)
    return launch_d<float>(D, q, k, v, seq_lens, slopes, out, B, S, Hq, Hkv, sm_scale, causal, s);
  return cudaErrorInvalidValue;
}
