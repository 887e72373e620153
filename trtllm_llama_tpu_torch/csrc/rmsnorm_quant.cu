// Row 7: fused RMSNorm -> per-row dynamic int8 quantization (the front half
// of the SmoothQuant data path).
//
// Replaces: trtllm_llama_tpu/ops/pallas/rmsnorm_quant.py:31
// (rmsnorm_quant_kernel, pallas_call at :47).
//
// Computes, for each row m of x [M, D]:
//   y     = f32(x) * (1 / sqrt(mean(f32(x)^2) + eps)) * f32(w)   (not rounded
//           to the activation dtype: y goes straight to int8)
//   scale = max(max|y|, 1e-8) / 127
//   q     = clamp(rint(y / scale), -127, 127)          (round half to even)
// and writes q int8 [M, D] and scale f32 [M].
//
// What bounds it on the H100: the bytes, read x and w once and write q and
// the scales (LLaMA-7B's bf16 rows: 3 bytes an element; 0.0038 ms at
// M = 1024, D = 4096, a few nanoseconds at M = 1, where the launch and one
// row's chain of dependent steps are the time); at M = 1024 the ~17
// instructions an element (an IEEE division among them) come next.
// Design: x is read from device memory once. A row is shared by `tpr`
// threads (a multiple of 32), each loading its part of x and w as 16-byte
// vectors (t, t + tpr, ...) into registers; the sum of squares, the amax
// (keeping y in registers) and the quantize all work on those registers,
// and the codes go out as 4- or 8-byte vectors, rounded by an add instead
// of the conversion pipe. The host sizes tpr by M: one vector a thread
// below kManyRows rows (512 threads at D = 4096 bf16: the shortest chain),
// two from there on (256 threads, a block a row); a short row takes a
// warp, several rows a block. Tried and slower at M = 1024 (H100,
// chip_smoke.py's check_rmsnorm_quant, each beside this design in one
// call): eight vectors a thread at 2-4 warps a row (164 registers, one
// block an SM: 0.0123 ms, and 0.0065 at M = 64, against the old three-pass
// kernel's 0.0097 / 0.0041); a grid of one wave walking rows with w kept
// and the next row's x in flight (0.0098 against 0.0087); y recomputed
// under a 32-register cap for 2048 threads an SM (spills: 0.0158 against
// 0.0086). Reductions run by shuffles within a warp, then across
// the row's warps through shared memory in a fixed order (deterministic).
// A D that is not a whole number of vectors, or pointers not aligned to
// them, take the same kernel one element a load; a row of more than kTile
// loads (16384 bf16, 8192 f32 elements) takes its strided branch, which
// reads x and w again in each pass. The divisions are true IEEE divisions
// (no reciprocal, no fast math), so a code moves only where y itself
// differs.
#include <algorithm>

#include "common.cuh"

using namespace tllm;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kTile = 2048;      // loads of a row the registers hold
constexpr int kManyRows = 32;    // from here on, two loads a thread
constexpr int kBlockThreads = 256;

template <typename E, int N>
struct alignas(sizeof(E) * N) Vec {
  E v[N];
};

// f(j) for this thread's loads j < n: unrolled over the kVec registers, or
// a loop (the strided branch, kVec 0).
template <int kVec, typename F>
__device__ __forceinline__ void each(int n, F f) {
  if constexpr (kVec > 0) {
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      if (j < n) f(j);
  } else {
    for (int j = 0; j < n; ++j) f(j);
  }
}

// Every thread of a row of `tpr` threads gets op over the row's values, in
// a fixed order: xor shuffles in the warp, then the row's warps in order.
// `red` holds one value per warp of the block.
template <bool kMax>
__device__ __forceinline__ float row_reduce(float v, float* red, int tpr) {
  v = kMax ? warp_max(v) : warp_sum(v);
  if (tpr == 32) return v;  // block-uniform
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  const int w0 = (threadIdx.x / tpr) * (tpr / 32);
  float r = red[w0];
  for (int w = 1; w < tpr / 32; ++w)
    r = kMax ? fmaxf(r, red[w0 + w]) : r + red[w0 + w];
  return r;
}

// clamp(rint(v), +-127) as an int8 code, without the conversion pipe: the
// clamp first (+-127 are integers, so it commutes with rint), then adding
// 1.5 * 2^23 rounds to the nearest integer, ties to even, into the low
// mantissa bits.
__device__ __forceinline__ int8_t code_of(float v) {
  const float t = fminf(fmaxf(v, -127.f), 127.f) + 12582912.f;
  return static_cast<int8_t>(__float_as_int(t) - 0x4B400000);
}

// kE: elements a load (16 bytes, or 1); kVec: loads a thread holds in
// registers, with their y (0: the strided branch, which loads again in
// each pass). Thread t of a row takes the loads t + j * tpr.
template <typename T, int kE, int kVec>
__global__ void __launch_bounds__(kMaxThreads)
    rmsnorm_quant_kernel(const T* __restrict__ x, const T* __restrict__ w,
                         int8_t* __restrict__ q, float* __restrict__ scale,
                         int M, int D, int tpr, float eps) {
  using V = Vec<T, kE>;
  using C = Vec<int8_t, kE>;
  constexpr int kR = kVec > 0 ? kVec : 1;
  __shared__ float red_ss[kMaxThreads / 32], red_max[kMaxThreads / 32];
  const int t = threadIdx.x % tpr;
  const int m = blockIdx.x * (blockDim.x / tpr) + threadIdx.x / tpr;
  const int nv = D / kE;
  const int n = m < M && t < nv ? (nv - t + tpr - 1) / tpr : 0;
  const V* xr = reinterpret_cast<const V*>(x + static_cast<size_t>(m) * D);
  const V* wr = reinterpret_cast<const V*>(w);
  C* qr = reinterpret_cast<C*>(q + static_cast<size_t>(m) * D);
  V xs[kR], ws[kR];
  float ys[kR * kE];
  if constexpr (kVec > 0) {
    each<kVec>(n, [&](int j) {
      xs[j] = xr[t + j * tpr];
      ws[j] = wr[t + j * tpr];
    });
  }
  auto x_at = [&](int j) -> V {
    if constexpr (kVec > 0) return xs[j];
    else return xr[t + j * tpr];
  };

  float ss = 0.f;
  each<kVec>(n, [&](int j) {
    const V xv = x_at(j);
#pragma unroll
    for (int i = 0; i < kE; ++i) {
      const float f = to_f(xv.v[i]);
      ss = fmaf(f, f, ss);
    }
  });
  ss = row_reduce<false>(ss, red_ss, tpr);
  const float rstd = 1.0f / sqrtf(ss / static_cast<float>(D) + eps);

  // y of load j, element i: kept from the amax pass where resident
  auto y_of = [&](int j, int i) -> float {
    if constexpr (kVec > 0) {
      return ys[j * kE + i];
    } else {
      return to_f(x_at(j).v[i]) * rstd * to_f(wr[t + j * tpr].v[i]);
    }
  };
  float amax = 0.f;
  each<kVec>(n, [&](int j) {
#pragma unroll
    for (int i = 0; i < kE; ++i) {
      if constexpr (kVec > 0)
        ys[j * kE + i] = to_f(xs[j].v[i]) * rstd * to_f(ws[j].v[i]);
      amax = fmaxf(amax, fabsf(y_of(j, i)));
    }
  });
  amax = row_reduce<true>(amax, red_max, tpr);
  const float s = fmaxf(amax, 1e-8f) / 127.0f;

  each<kVec>(n, [&](int j) {
    C c;
#pragma unroll
    for (int i = 0; i < kE; ++i) c.v[i] = code_of(__fdiv_rn(y_of(j, i), s));
    qr[t + j * tpr] = c;
  });
  if (t == 0 && m < M) scale[m] = s;
}

template <typename T, int kE, int kVec>
cudaError_t launch_k(const void* x, const void* w, void* q, void* scale,
                     int M, int D, int tpr, float eps, cudaStream_t stream) {
  const int rows = std::max(1, std::min(kBlockThreads / tpr, M));
  rmsnorm_quant_kernel<T, kE, kVec>
      <<<(M + rows - 1) / rows, rows * tpr, 0, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(w),
          static_cast<int8_t*>(q), static_cast<float*>(scale), M, D, tpr,
          eps);
  return cudaGetLastError();
}

// The plan, from M and the row's nv loads: a row's threads (up to 1024)
// hold one load each below kManyRows rows (the shortest chain), two from
// there on (more bytes in flight per thread); a row of fewer loads than a
// warp's takes a warp, several rows a block. A row of more than kTile
// loads takes the strided branch at 1024 threads.
template <typename T, int kE>
cudaError_t launch_e(const void* x, const void* w, void* q, void* scale,
                     int M, int D, float eps, cudaStream_t stream) {
  const int nv = D / kE;
  if (nv > kTile)
    return launch_k<T, kE, 0>(x, w, q, scale, M, D, kMaxThreads, eps, stream);
  const int per = M < kManyRows ? 1 : 2;
  int tpr = 32;
  while (tpr < kMaxThreads && per * tpr < nv) tpr *= 2;
  if (nv <= tpr)
    return launch_k<T, kE, 1>(x, w, q, scale, M, D, tpr, eps, stream);
  return launch_k<T, kE, 2>(x, w, q, scale, M, D, tpr, eps, stream);
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* q, void* scale, int M,
                   int D, float eps, cudaStream_t stream) {
  constexpr int kE = 16 / sizeof(T);
  const bool vec = D % kE == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % kE == 0;
  return vec ? launch_e<T, kE>(x, w, q, scale, M, D, eps, stream)
             : launch_e<T, 1>(x, w, q, scale, M, D, eps, stream);
}

}  // namespace

// x [M, D] (dtype), w [D] (dtype), q [M, D] int8, scale [M] f32. One launch.
extern "C" int tllm_rmsnorm_quant(const void* x, const void* w, void* q,
                                  void* scale, int dtype, int M, int D,
                                  float eps, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (M < 1 || D < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) return launch<__nv_bfloat16>(x, w, q, scale, M, D, eps, s);
  if (dtype == kF16) return launch<__half>(x, w, q, scale, M, D, eps, s);
  if (dtype == kF32) return launch<float>(x, w, q, scale, M, D, eps, s);
  return cudaErrorInvalidValue;
}
