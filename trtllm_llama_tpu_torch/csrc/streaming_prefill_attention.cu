// Row 12: GQA prefill attention for long prompts (every prompt longer than
// KERNELS['prefill_streaming_min_s'], 2048 rows), causal, or bidirectional
// (`causal` 0: col < len alone, the JAX package's causal=False).
//
// Replaces: trtllm_llama_tpu/ops/pallas/attention.py::
// streaming_prefill_attention_kernel, its ALiBi branch included.
//
// Computes, per (b, h, row): scores = (q . k) * sm_scale + slopes[h] * col in
// f32 (ALiBi's key-position form, as the JAX package adds it; the bias term
// is absent when slopes is null), masked to cols <= row (when causal) and
// cols < seq_lens[b] with the finite NEG_INF of the reference (a length of 0 masks
// every column, and the row then averages V over all S columns, as the
// reference's softmax does; columns at or past S score -inf and never
// count), an f32 online softmax, and out = (sum_j p_j v_j) / (sum_j p_j) in
// q's dtype, with p kept at f32's precision through P V as the Pallas
// kernel keeps it. The K/V head is h / (Hq / Hkv) (GQA).
//
// What bounds it on the H100: operations, 2 * B * Hq * S^2 * D causal flops
// (550 GFLOP per layer at S = 8192 with 32 heads of 128, 0.56 ms at 989
// TFLOP/s bf16; its q/k/v/out bytes, 268 MB, take 0.08 ms). Three bodies,
// chosen by shape before launch:
//   - bf16 / fp16 at head dims 64, 96 and 128 (every model the port runs
//     but GPT-J): the warp-specialized tile of flash_attention_ws.cuh (a TMA
//     producer, two consumer warpgroups sharing each K/V tile, ping-pong on
//     the tensor cores, P in three bf16 / two fp16 terms; its note has the
//     design);
//   - bf16 / fp16 at head dims 32 and 256: row 10's tile
//     (flash_attention.cuh, the same contract): at 256 the second consumer's
//     registers would not fit;
//   - f32: a CUDA-core loop, one block per (64-row q tile, q head, b), four
//     warps of 16 query rows, 32-key tiles staged in shared memory, one key
//     per lane, f32 FMAs, so f32 stays exact; the last tiles, which see the
//     most keys, launch first, and key tiles past the block's last causal
//     row (when causal) or the length are skipped (all S columns are
//     streamed when the length is 0).
#include "flash_attention.cuh"
#include "flash_attention_ws.cuh"

using namespace tllm;

namespace {

constexpr int kBQ = 64;              // query rows per block (f32)
constexpr int kWarps = 4;            // 16 query rows each
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kBQ / kWarps;
constexpr int kBKF = 32;             // keys per staged tile (one per lane)

// The mask of the reference: -inf past S (never counted), NEG_INF outside
// the causal (when causal) / length mask, the scaled score inside it.
__device__ __forceinline__ float masked(float s, int row, int col, int len,
                                       int S, int causal) {
  if (col >= S) return neg_infinity();
  return ((causal && col > row) || col >= len) ? kNegInf : s;
}

// The scaled, biased and masked score of (row, col).
__device__ __forceinline__ float biased(float s, float sm_scale, float slope,
                                        int row, int col, int len, int S,
                                        int causal) {
  // no contraction into an fma: the JAX package rounds the product first
  const float v = __fadd_rn(__fmul_rn(s, sm_scale),
                            __fmul_rn(slope, static_cast<float>(col)));
  return masked(v, row, col, len, S, causal);
}

// Columns a block with rows [row0, row0 + kBQ) streams: through its last
// causal row (all S when not causal) and the last valid column, or all S
// when the length is 0.
__device__ __forceinline__ int block_cols(int row0, int len, int S,
                                          int causal) {
  const int last_row = causal ? min(row0 + kBQ, S) - 1 : S - 1;
  return (len > 0 ? min(last_row, len - 1) : S - 1) + 1;
}

// f32: CUDA cores, 64-row blocks of four 16-row warps; dynamic shared
// memory holds the block's queries and one 32-key K/V tile.
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
                                 int Hkv, float sm_scale, int causal) {
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

  const int n_cols = block_cols(row0, len, S, causal);
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
      s = biased(s, sm_scale, slope, row0 + r, c0 + lane, len, S, causal);
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

// bf16 / fp16 (T): the warp-specialized tile at D = 64 / 96 / 128, row 10's
// tile at D = 32 / 256.
template <typename T, int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const void* seq_lens, const void* slopes, void* out,
                      int B, int S, int Hq, int Hkv, float sm_scale,
                      int causal, cudaStream_t stream) {
  if constexpr (D == 32 || D == 256)
    return flash::launch<T, D, false>(q, k, v, seq_lens, slopes, out, B, S,
                                      Hq, Hkv, sm_scale, causal, stream);
  else
    return flash_ws::launch<T, D>(q, k, v, seq_lens, slopes, out, B, S, Hq,
                                  Hkv, sm_scale, causal, stream);
}

template <int D>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v,
                   const void* seq_lens, const void* slopes, void* out, int B,
                   int S, int Hq, int Hkv, float sm_scale, int causal,
                   cudaStream_t stream) {
  if (dtype == kBF16)
    return launch_tc<__nv_bfloat16, D>(q, k, v, seq_lens, slopes, out, B, S,
                                       Hq, Hkv, sm_scale, causal, stream);
  if (dtype == kF16)
    return launch_tc<__half, D>(q, k, v, seq_lens, slopes, out, B, S, Hq,
                                Hkv, sm_scale, causal, stream);
  if (dtype != kF32) return cudaErrorInvalidValue;
  const dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  constexpr int smem = f32_smem_bytes<D>();
  const cudaError_t err = allow_smem(streaming_prefill_f32_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  streaming_prefill_f32_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(seq_lens),
      static_cast<const float*>(slopes), static_cast<float*>(out), S, Hq, Hkv,
      sm_scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q [B, S, Hq, D], k/v [B, S, Hkv, D] (dtype; 16-byte aligned), seq_lens [B]
// int32, slopes [Hq] f32 ALiBi slopes or null, out [B, S, Hq, D] (dtype).
// D in {32, 64, 96, 128, 256}; Hq % Hkv == 0; causal 0 drops col <= row.
extern "C" int tllm_streaming_prefill_attention(
    const void* q, const void* k, const void* v, const void* seq_lens,
    const void* slopes, void* out, int dtype, int B, int S, int Hq, int Hkv,
    int D, int causal, float sm_scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch<32>(dtype, q, k, v, seq_lens, slopes, out, B, S, Hq, Hkv,
                        sm_scale, causal, s);
    case 64:
      return launch<64>(dtype, q, k, v, seq_lens, slopes, out, B, S, Hq, Hkv,
                        sm_scale, causal, s);
    case 96:
      return launch<96>(dtype, q, k, v, seq_lens, slopes, out, B, S, Hq, Hkv,
                        sm_scale, causal, s);
    case 128:
      return launch<128>(dtype, q, k, v, seq_lens, slopes, out, B, S, Hq, Hkv,
                         sm_scale, causal, s);
    case 256:
      return launch<256>(dtype, q, k, v, seq_lens, slopes, out, B, S, Hq, Hkv,
                         sm_scale, causal, s);
    default:
      return cudaErrorInvalidValue;
  }
}
