// Fused RMSNorm -> per-row dynamic int8 quantization (the front half of the
// SmoothQuant data path).
//
// Replaces: trtllm_llama_tpu/ops/pallas/rmsnorm_quant.py::
// rmsnorm_quant_kernel.
//
// Computes, for each row m of x [M, D]:
//   y     = f32(x) * (1 / sqrt(mean(f32(x)^2) + eps)) * f32(w)   (not rounded
//           to the activation dtype: y goes straight to int8)
//   scale = max(max|y|, 1e-8) / 127
//   q     = clamp(rint(y / scale), -127, 127)          (round half to even)
// and writes q int8 [M, D] and scale f32 [M].
//
// What bounds it on the H100: 3 bytes per element (read x in bf16, write q)
// plus the weight, about 4 ns at M = 1, D = 4096: far below the few
// microseconds of one launch, so the decode path is launch-bound and the
// design is the simplest correct one: one block per row, three passes over
// the row (sum of squares, amax, quantize) that re-read x from L1/L2, and
// block reductions through shared memory in a fixed order (deterministic).
// The divisions are true IEEE divisions (no reciprocal, no fast math), so a
// code moves only where y itself differs.
#include "common.cuh"

using namespace tllm;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Every thread gets op over all threads' v, combined in a fixed order.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  v = kMax ? warp_max(v) : warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = kMax ? fmaxf(r, red[w]) : r + red[w];
  __syncthreads();  // red is reused by the next reduction
  return r;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_quant_kernel(const T* __restrict__ x, const T* __restrict__ w,
                         int8_t* __restrict__ q, float* __restrict__ scale,
                         int D, float eps) {
  __shared__ float red[kWarps];
  const size_t base = static_cast<size_t>(blockIdx.x) * D;
  const T* xr = x + base;

  float ss = 0.f;
  for (int i = threadIdx.x; i < D; i += kThreads) {
    const float v = to_f(xr[i]);
    ss = fmaf(v, v, ss);
  }
  ss = block_reduce<false>(ss, red);
  const float rstd = 1.0f / sqrtf(ss / static_cast<float>(D) + eps);

  float amax = 0.f;
  for (int i = threadIdx.x; i < D; i += kThreads)
    amax = fmaxf(amax, fabsf(to_f(xr[i]) * rstd * to_f(w[i])));
  amax = block_reduce<true>(amax, red);
  const float s = fmaxf(amax, 1e-8f) / 127.0f;

  for (int i = threadIdx.x; i < D; i += kThreads) {
    const float y = to_f(xr[i]) * rstd * to_f(w[i]);
    const float c = fminf(fmaxf(rintf(__fdiv_rn(y, s)), -127.f), 127.f);
    q[base + i] = static_cast<int8_t>(c);
  }
  if (threadIdx.x == 0) scale[blockIdx.x] = s;
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* q, void* scale, int M,
                   int D, float eps, cudaStream_t stream) {
  rmsnorm_quant_kernel<T><<<M, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<int8_t*>(q), static_cast<float*>(scale), D, eps);
  return cudaGetLastError();
}

}  // namespace

// x [M, D] (dtype), w [D] (dtype), q [M, D] int8, scale [M] f32.
extern "C" int tllm_rmsnorm_quant(const void* x, const void* w, void* q,
                                  void* scale, int dtype, int M, int D,
                                  float eps, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) return launch<__nv_bfloat16>(x, w, q, scale, M, D, eps, s);
  if (dtype == kF16) return launch<__half>(x, w, q, scale, M, D, eps, s);
  if (dtype == kF32) return launch<float>(x, w, q, scale, M, D, eps, s);
  return cudaErrorInvalidValue;
}
