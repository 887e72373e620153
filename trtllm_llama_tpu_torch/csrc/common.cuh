// Shared helpers of the port's hand-written Hopper kernels.
//
// Every kernel library exposes plain C entry points (loaded with ctypes):
// each takes raw device pointers, the device index and the CUDA stream as
// void*, launches on that stream and returns cudaGetLastError() so the
// Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tllm {

// Activation dtype codes shared with the Python wrappers (_build.DTYPE_CODES).
enum DType : int { kF32 = 0, kBF16 = 1, kF16 = 2 };

// Mask value of the reference attention (ops/attention.py NEG_INF): finite,
// so a fully masked row still softmaxes to finite numbers.
constexpr float kNegInf = -1e9f;
// Lowest finite float: the starting running max of an online softmax
// (exp(kLowest - m) is 0 for any real m).
constexpr float kLowest = -3.402823466e+38f;

// -inf: the score of a padding column past S, which no softmax counts
// (unlike NEG_INF, which an all-masked row averages over).
__device__ __forceinline__ float neg_infinity() {
  return __int_as_float(0xff800000);
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as a dtype cast
}
template <>
__device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}

// Round a float through T (identity for float).
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// Let `kernel` take `bytes` of dynamic shared memory (above the default
// 48 KB a launch needs the opt-in).
template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return bytes > 48 * 1024
             ? cudaFuncSetAttribute(
                   kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)
             : cudaSuccess;
}

// e4m3 codes in the two bytes of `pair` -> two exact floats (low byte
// first): one cvt.rn.f16x2.e4m3x2 (every e4m3 value is an f16), then each
// half widened. The two NaN codes give NaN.
__device__ __forceinline__ void fp8x2(uint32_t pair, float& lo, float& hi) {
  uint32_t h2;
  const unsigned short p = static_cast<unsigned short>(pair & 0xFFFFu);
  asm("cvt.rn.f16x2.e4m3x2 %0, %1;" : "=r"(h2) : "h"(p));
  const unsigned short h_lo = static_cast<unsigned short>(h2 & 0xFFFFu);
  const unsigned short h_hi = static_cast<unsigned short>(h2 >> 16);
  asm("cvt.f32.f16 %0, %1;" : "=f"(lo) : "h"(h_lo));
  asm("cvt.f32.f16 %0, %1;" : "=f"(hi) : "h"(h_hi));
}

// KV-cache element codec of the decode kernels: enc stores an f32 value, dec
// reads one back as f32 (`scale` is the layer's dequant scale, used by int8
// and e4m3 caches only). int8: enc(x) = clamp(rint(x / scale), +-127) by
// true division, as the JAX package's _quant_kv; dec(c) = c * scale.
template <typename TC>
struct KVCodec {
  __device__ static TC enc(float v, float) { return from_f<TC>(v); }
  __device__ static float dec(TC c, float) { return to_f(c); }
};
template <>
struct KVCodec<int8_t> {
  __device__ static int8_t enc(float v, float scale) {
    return static_cast<int8_t>(
        fminf(fmaxf(rintf(__fdiv_rn(v, scale)), -127.f), 127.f));
  }
  __device__ static float dec(int8_t c, float scale) {
    return static_cast<float>(c) * scale;
  }
};
// An fp8 cache holds e4m3fn codes (the torch uint8 storage of the JAX
// package's ops/fp8.py bit codes) as __nv_fp8_e4m3, a type of its own, so no
// template takes them for int8 codes. enc(x) = the e4m3 code of x / scale
// (true division), rounded to nearest even and saturated at +-448, never a
// NaN code (cvt.rn.satfinite: fp8_encode bit for bit on every finite x, -0,
// subnormals and ties included); dec(c) = the code's exact value * scale.
template <>
struct KVCodec<__nv_fp8_e4m3> {
  __device__ static __nv_fp8_e4m3 enc(float v, float scale) {
    unsigned short pair;  // b (x) in the low byte, a (0) in the high one
    asm("cvt.rn.satfinite.e4m3x2.f32 %0, %1, %2;"
        : "=h"(pair)
        : "f"(0.f), "f"(__fdiv_rn(v, scale)));
    __nv_fp8_e4m3 c;
    c.__x = static_cast<__nv_fp8_storage_t>(pair & 0xFFu);
    return c;
  }
  __device__ static float dec(__nv_fp8_e4m3 c, float scale) {
    float v, unused;
    fp8x2(c.__x, v, unused);
    return v * scale;
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

}  // namespace tllm
