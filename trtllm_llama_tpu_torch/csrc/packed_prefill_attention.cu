// Row 13: causal GQA attention over one packed (remove-padding) token
// stream.
//
// Replaces: trtllm_llama_tpu/ops/pallas/attention.py::
// packed_prefill_attention_kernel.
//
// Computes, per (row i, head h) of the stream q [T, Hq, D], k/v [T, Hkv, D]
// with segment ids seg [T] (pad rows -1): scores = (q_i . k_j) * sm_scale in
// f32 over the keys j <= i with seg[j] == seg[i], masked elsewhere with the
// finite NEG_INF of the reference, an f32 softmax and (p @ v) / sum(p) cast
// to q's dtype. The K/V head is h / (Hq / Hkv). Sequences are contiguous
// runs of one id, so row i needs only the keys in [start(i), i], start(i)
// being the first row of its run. Pad rows attend the pad rows before them
// in their run: finite, and undefined by the contract.
//
// What bounds it on the H100: the q/k/v/out bytes of the segments' rows
// (a pad row's output is undefined), or the
// 4 * Hq * D * sum(len * (len + 1) / 2) flops of the segments, which only
// the tensor cores serve at rate.
//   - bf16 and fp16: row 10's wgmma flash-attention tile
//     (flash_attention.cuh) with the segment mask in place of the length
//     mask: one warpgroup per 64-row query tile and head. The block finds
//     the run starts of its first and last rows (the block scans the ids
//     back 1024 at a time); its K/V loop starts at the tile holding
//     start(row0) and ends at its last row, so the work is O(sum len^2)
//     rather than O(T^2); a key tile inside the last row's run and below
//     the diagonal takes no mask. On an H100 80GB HBM3 at 700 W the T=1024
//     packed serving wave (709 rows in 8 segments, 32 heads of 128) takes
//     0.0422 ms, 0.62x SDPA with the block-diagonal mask and 16% of the
//     byte bound, where the
//     CUDA-core loop below took 0.3772-0.4876 ms in bf16 (chip_smoke.py;
//     PERF.md).
//   - f32: the exact CUDA-core body below: one block per (16-row q tile,
//     head), four warps of four rows; 32-row K/V tiles staged in shared
//     memory as f32 (K padded to D+1 columns), an online softmax with each
//     row's max, denominator and D/32 accumulators per lane in registers;
//     the K/V loop starts at the tile holding start(row0), found by one
//     warp scanning the ids back 32 at a time.
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
    packed_prefill_f32(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ seg,
                       T* __restrict__ out, int Tn, int Hq, int Hkv,
                       float sm_scale) {
  constexpr int DL = D / 32;  // head dims per lane
  extern __shared__ float packed_smem[];
  auto qs = reinterpret_cast<float (*)[D]>(packed_smem);
  auto ks = reinterpret_cast<float (*)[D + 1]>(packed_smem + kBQ * D);
  auto vs = reinterpret_cast<float (*)[D]>(packed_smem + kBQ * D +
                                           kBK * (D + 1));
  __shared__ int run_start;

  const int row0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int hk = h / (Hq / Hkv);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  if (warp == 0) {  // first row of the run holding row0
    const int s0 = seg[row0];
    int start = 0;
    for (int base = row0 - 1; base >= 0; base -= 32) {
      const int j = base - lane;
      const unsigned m = __ballot_sync(0xffffffffu, j < 0 || seg[j] != s0);
      if (m) {
        start = base - (__ffs(m) - 1) + 1;
        break;
      }
    }
    if (lane == 0) run_start = start;
  }
  for (int i = threadIdx.x; i < kBQ * D; i += blockDim.x) {
    const int r = i / D, d = i - (i / D) * D, s = row0 + r;
    qs[r][d] = s < Tn ? to_f(q[(static_cast<size_t>(s) * Hq + h) * D + d]) : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][DL];
  int rseg[kRows];
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    const int row = row0 + warp * kRows + rr;
    rseg[rr] = row < Tn ? seg[row] : 0;
    m[rr] = kLowest;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < DL; ++i) acc[rr][i] = 0.f;
  }
  __syncthreads();  // run_start and qs written

  const int n_cols = min(row0 + kBQ, Tn);
  for (int c0 = (run_start / kBK) * kBK; c0 < n_cols; c0 += kBK) {
    __syncthreads();  // previous tile consumed
    for (int i = threadIdx.x; i < kBK * D; i += blockDim.x) {
      const int j = i / D, d = i - (i / D) * D, s = c0 + j;
      float kv = 0.f, vv = 0.f;
      if (s < Tn) {
        const size_t off = (static_cast<size_t>(s) * Hkv + hk) * D + d;
        kv = to_f(k[off]);
        vv = to_f(v[off]);
      }
      ks[j][d] = kv;
      vs[j][d] = vv;
    }
    __syncthreads();
    const int col = c0 + lane;
    const int cseg = col < Tn ? seg[col] : 0;
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      const int r = warp * kRows + rr;
      const int row = row0 + r;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s = fmaf(qs[r][d], ks[lane][d], s);
      s *= sm_scale;
      if (!(col <= row && col < Tn && cseg == rseg[rr])) s = kNegInf;
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
    if (row >= Tn) continue;
    T* o = out + (static_cast<size_t>(row) * Hq + h) * D;
#pragma unroll
    for (int i = 0; i < DL; ++i) o[lane + 32 * i] = from_f<T>(acc[rr][i] / l[rr]);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* seg, void* out, int Tn, int Hq, int Hkv,
                   float sm_scale, cudaStream_t stream) {
  if constexpr (!std::is_same<T, float>::value) {
    return flash::launch<T, D, true>(q, k, v, seg, nullptr, out, 1, Tn, Hq,
                                     Hkv, sm_scale, 1, stream);
  } else {
    const dim3 grid((Tn + kBQ - 1) / kBQ, Hq);
    constexpr int smem = (kBQ * D + kBK * (D + 1) + kBK * D) * 4;
    const cudaError_t err = allow_smem(packed_prefill_f32<T, D>, smem);
    if (err != cudaSuccess) return err;
    packed_prefill_f32<T, D><<<grid, kWarps * 32, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const int*>(seg),
        static_cast<T*>(out), Tn, Hq, Hkv, sm_scale);
    return cudaGetLastError();
  }
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     const void* seg, void* out, int Tn, int Hq, int Hkv,
                     float sm_scale, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, seg, out, Tn, Hq, Hkv, sm_scale, stream);
    case 64: return launch<T, 64>(q, k, v, seg, out, Tn, Hq, Hkv, sm_scale, stream);
    case 96: return launch<T, 96>(q, k, v, seg, out, Tn, Hq, Hkv, sm_scale, stream);
    case 128: return launch<T, 128>(q, k, v, seg, out, Tn, Hq, Hkv, sm_scale, stream);
    case 256: return launch<T, 256>(q, k, v, seg, out, Tn, Hq, Hkv, sm_scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [T, Hq, D], k/v [T, Hkv, D] (dtype), seg [T] int32, out [T, Hq, D]
// (dtype). D in {32, 64, 96, 128, 256}; Hq % Hkv == 0; T >= 1.
extern "C" int tllm_packed_prefill_attention(const void* q, const void* k,
                                             const void* v, const void* seg,
                                             void* out, int dtype, int Tn,
                                             int Hq, int Hkv, int D,
                                             float sm_scale, int device,
                                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch_d<__nv_bfloat16>(D, q, k, v, seg, out, Tn, Hq, Hkv, sm_scale, s);
  if (dtype == kF16)
    return launch_d<__half>(D, q, k, v, seg, out, Tn, Hq, Hkv, sm_scale, s);
  if (dtype == kF32)
    return launch_d<float>(D, q, k, v, seg, out, Tn, Hq, Hkv, sm_scale, s);
  return cudaErrorInvalidValue;
}
