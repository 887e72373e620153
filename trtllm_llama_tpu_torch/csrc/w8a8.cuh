// Pieces shared by the two W8A8 kernels: the dp4a GEMV of few rows
// (w8a8_matmul.cu) and the int8 tensor-core GEMM of prefill rows
// (w8a8_gemm.cu).
#pragma once

#include "common.cuh"

namespace tllm {
namespace w8a8 {

// Rows a, b, c, d hold 4 columns each (byte j = column j). Returns, for
// each column j, the word [a_j, b_j, c_j, d_j]: 4 consecutive K-values.
__device__ __forceinline__ void transpose4x4(uint32_t a, uint32_t b,
                                             uint32_t c, uint32_t d,
                                             uint32_t* col) {
  const uint32_t ab01 = __byte_perm(a, b, 0x5140);  // a0 b0 a1 b1
  const uint32_t cd01 = __byte_perm(c, d, 0x5140);  // c0 d0 c1 d1
  const uint32_t ab23 = __byte_perm(a, b, 0x7362);  // a2 b2 a3 b3
  const uint32_t cd23 = __byte_perm(c, d, 0x7362);  // c2 d2 c3 d3
  col[0] = __byte_perm(ab01, cd01, 0x5410);
  col[1] = __byte_perm(ab01, cd01, 0x7632);
  col[2] = __byte_perm(ab23, cd23, 0x5410);
  col[3] = __byte_perm(ab23, cd23, 0x7632);
}

// The dequantizing epilogue: (f32(acc) * s_x[m * sx_step]) * s_w[n * sw_step],
// in that order (the TPU kernel's acc.astype(f32) * s_x * s_w).
__device__ __forceinline__ float dequant(int acc, float sx, float sw) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), sx), sw);
}

// out[m, n] = dequant(sum_s part[s, m, n]): the GEMM's split-K partials
// (int32, exact in any order) summed in a fixed order, converted and
// scaled, by a second launch (the dp4a GEMV merges its splits in-kernel).
__global__ void reduce_kernel(const int* __restrict__ part,
                              const float* __restrict__ sx, int sx_step,
                              const float* __restrict__ sw, int sw_step,
                              float* __restrict__ out, int M, int N,
                              int ksplit) {
  const size_t total = static_cast<size_t>(M) * N;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  int acc = 0;
  for (int s = 0; s < ksplit; ++s) acc += part[static_cast<size_t>(s) * total + i];
  const int m = static_cast<int>(i / N);
  const int n = static_cast<int>(i - static_cast<size_t>(m) * N);
  out[i] = dequant(acc, sx[m * sx_step], sw[n * sw_step]);
}

inline cudaError_t launch_reduce(const void* part, const void* sx,
                                 int sx_step, const void* sw, int sw_step,
                                 void* out, int M, int N, int ksplit,
                                 cudaStream_t stream) {
  const size_t total = static_cast<size_t>(M) * N;
  const int threads = 256;
  reduce_kernel<<<static_cast<unsigned>((total + threads - 1) / threads),
                  threads, 0, stream>>>(
      static_cast<const int*>(part), static_cast<const float*>(sx), sx_step,
      static_cast<const float*>(sw), sw_step, static_cast<float*>(out), M, N,
      ksplit);
  return cudaGetLastError();
}

}  // namespace w8a8
}  // namespace tllm
