// Weight-only INT8 stacked matmul for few rows (decode / short prefill).
//
// Replaces: trtllm_llama_tpu/ops/pallas/woq_matmul.py::woq_matmul_stacked
// (the int8 branch _kernel_int8 with the _fuse_prologue norm and the
// _fuse_epilogue residual add).
//
// Computes, for one layer of the stacked weight q[L, K, N] int8:
//   h   = T(x * rsqrt(mean(x^2) + eps) * norm_w)   (optional prologue, f32)
//   acc = sum_k f32(h[m, k]) * f32(q[k, n])        (f32 accumulation)
//   y   = acc * scale[n]
//   y   = T(resid + T(y))                          (optional epilogue)
// and returns y as f32 [M, N].
//
// What bounds it on the H100: the weight bytes. At M <= 16 a matmul does
// 2*M flops per int8 weight byte, far below the ~295 flop/byte at which the
// tensor cores, not HBM (3.35 TB/s), become the limit. So the design only
// has to stream q once at full bandwidth:
//   - each thread reads 16 contiguous int8 columns per row in one 16-byte
//     load (a warp covers 512 contiguous bytes of a row);
//   - the int8 -> f32 convert is a byte_perm + one FADD (no I2F, which runs
//     at quarter rate and would make the SMs, not HBM, the limit);
//   - the x panel (with the norm prologue applied once per block) sits in
//     shared memory as f32, and every thread keeps MR x 16 accumulators in
//     registers;
//   - K is split across blocks (split-K) so that even N = 4096 launches
//     ~2 blocks per SM; a second launch sums the K-splits in a fixed order
//     (deterministic), applies the per-channel scale and the residual.
// M larger than MR loops over row tiles inside the block, re-reading the
// block's weight tile from L2; that serves prefill rows correctly, though a
// tensor-core (wgmma) tile is what large M wants.
#include "common.cuh"

using namespace tllm;

namespace {

constexpr int kTN = 32;              // threads along N: one warp
constexpr int kTK = 8;               // warps along K
constexpr int kVec = 16;             // int8 columns per thread (16 bytes)
constexpr int kBN = kTN * kVec;      // 512 output columns per block
constexpr int kThreads = kTN * kTK;  // 256
constexpr int kKT = 512;             // K rows of x staged per pass

// 16 int8 weights (one 16-byte load) -> 16 exact floats.
// byte ^ 0x80 = q + 128 in [0, 255]; planting it under the exponent of 2^23
// gives the float 2^23 + q + 128, and one subtraction leaves q.
__device__ __forceinline__ void decode16(const int4 w, float (&f)[kVec]) {
  const uint32_t words[4] = {static_cast<uint32_t>(w.x),
                             static_cast<uint32_t>(w.y),
                             static_cast<uint32_t>(w.z),
                             static_cast<uint32_t>(w.w)};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t biased = words[i] ^ 0x80808080u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t bits = __byte_perm(biased, 0x4B000000u, 0x7440u + j);
      f[4 * i + j] = __uint_as_float(bits) - 8388736.0f;  // 2^23 + 128
    }
  }
}

template <typename T, int MR>
__global__ void __launch_bounds__(kThreads)
    woq_partial_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                       const T* __restrict__ norm_w, float* __restrict__ part,
                       int M, int K, int N, int kc, float eps) {
  __shared__ float xs[MR][kKT];               // staged input rows
  __shared__ float red[MR * kVec * kTN];      // cross-warp reduction
  __shared__ float rstd[MR];                  // norm prologue factors

  const int tn = threadIdx.x;
  const int tk = threadIdx.y;
  const int tid = tk * kTN + tn;
  const int n0 = blockIdx.x * kBN + tn * kVec;
  const bool n_ok = n0 < N;                   // N % 16 == 0 (wrapper)
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
        if (m < M) {
          v = to_f(x[static_cast<size_t>(m) * K + kt + kk]);
          if (norm_w != nullptr)
            v = round_to<T>(v * rstd[r] * to_f(norm_w[kt + kk]));
        }
        xs[r][kk] = v;
      }
      __syncthreads();
      if (n_ok) {
        const int8_t* qp = q + static_cast<size_t>(kt) * N + n0;
#pragma unroll 4
        for (int kk = tk; kk < klen; kk += kTK) {
          const int4 wv = __ldg(
              reinterpret_cast<const int4*>(qp + static_cast<size_t>(kk) * N));
          float wf[kVec];
          decode16(wv, wf);
#pragma unroll
          for (int r = 0; r < MR; ++r) {
            const float xv = xs[r][kk];
#pragma unroll
            for (int j = 0; j < kVec; ++j) acc[r][j] = fmaf(xv, wf[j], acc[r][j]);
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

// out[m, n] = epilogue(sum_s part[s, m, n] * scale[n]). With ksplit == 1
// the wrapper may pass part == out: each thread reads its element before
// writing it.
template <typename T>
__global__ void woq_reduce_kernel(const float* part, const float* __restrict__ scale,
                                  const T* __restrict__ resid, float* out, int M,
                                  int N, int ksplit) {
  const size_t total = static_cast<size_t>(M) * N;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float acc = 0.f;
  for (int s = 0; s < ksplit; ++s) acc += part[static_cast<size_t>(s) * total + i];
  acc *= scale[i % N];
  if (resid != nullptr) acc = round_to<T>(to_f(resid[i]) + round_to<T>(acc));
  out[i] = acc;
}

template <typename T, int MR>
cudaError_t launch(const void* x, const void* q, const void* scale,
                   const void* norm_w, const void* resid, void* out, void* part,
                   int M, int K, int N, int ksplit, int kc, float eps,
                   cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, ksplit);
  const dim3 block(kTN, kTK);
  woq_partial_kernel<T, MR><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(q),
      static_cast<const T*>(norm_w), static_cast<float*>(part), M, K, N, kc,
      eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t total = static_cast<size_t>(M) * N;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  woq_reduce_kernel<T><<<blocks, threads, 0, stream>>>(
      static_cast<const float*>(part), static_cast<const float*>(scale),
      static_cast<const T*>(resid), static_cast<float*>(out), M, N, ksplit);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_mr(int mr, const void* x, const void* q, const void* scale,
                      const void* norm_w, const void* resid, void* out,
                      void* part, int M, int K, int N, int ksplit, int kc,
                      float eps, cudaStream_t stream) {
  switch (mr) {
    case 1:
      return launch<T, 1>(x, q, scale, norm_w, resid, out, part, M, K, N, ksplit, kc, eps, stream);
    case 2:
      return launch<T, 2>(x, q, scale, norm_w, resid, out, part, M, K, N, ksplit, kc, eps, stream);
    case 4:
      return launch<T, 4>(x, q, scale, norm_w, resid, out, part, M, K, N, ksplit, kc, eps, stream);
    case 8:
      return launch<T, 8>(x, q, scale, norm_w, resid, out, part, M, K, N, ksplit, kc, eps, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x [M, K] (dtype), q [K, N] int8 and scale [N] f32 of ONE layer (the
// wrapper offsets the stacked arrays), norm_w [K] or null, resid [M, N] or
// null, out [M, N] f32, part [ksplit, M, N] f32 scratch (== out allowed when
// ksplit == 1). mr in {1, 2, 4, 8}: rows per register tile.
extern "C" int tllm_woq_matmul_stacked(const void* x, const void* q,
                                       const void* scale, const void* norm_w,
                                       const void* resid, void* out, void* part,
                                       int dtype, int M, int K, int N,
                                       int ksplit, int kc, int mr, float eps,
                                       int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch_mr<__nv_bfloat16>(mr, x, q, scale, norm_w, resid, out, part,
                                    M, K, N, ksplit, kc, eps, s);
  if (dtype == kF32)
    return launch_mr<float>(mr, x, q, scale, norm_w, resid, out, part, M, K,
                            N, ksplit, kc, eps, s);
  return cudaErrorInvalidValue;
}
