// One-token decode attention fused with the in-place KV-cache write.
//
// Replaces: trtllm_llama_tpu/ops/pallas/dma_decode_attention.py::
// dma_decode_attention (bf16 / f32 KV, and the int8-KV branch with one
// static dequant scale per layer). Unlike the reference, which switches to
// this kernel only at S_max >= 4096 (a crossover measured on a TPU), the
// port uses it at every cache length.
//
// Computes, for each sequence b with write position pos = positions[b]:
//   cache_k[layer, b, :, pos] = enc(k_new[b]); likewise v
//   out[b, h] = softmax_f32((q[b, h] . dec(K[j])) * sm_scale, j <= pos) @ dec(V)
// where a float cache stores the value as is (enc/dec are the dtype cast),
// and an int8 cache stores enc(x) = clamp(rint(x / scale), +-127) (a true
// division, as the JAX package's _quant_kv; its Pallas kernel multiplies by
// 1/scale, which may move a code by one) and reads dec(c) = c * scale in
// f32, scale = kv_scale[layer] read from device memory. Rows other than pos
// are left unchanged.
//
// What bounds it on the H100: the K/V bytes of the live rows,
// 2 * B * Hkv * (pos + 1) * D * sizeof(cache element), at 3.35 TB/s (int8
// halves the bf16 bytes). Design (flash-decoding split-K over only the live
// chunks):
//   - launch 1: one block per (32-row chunk, kv head, b); blocks whose chunk
//     starts past pos exit at once, so the work is O(pos), not O(S_max).
//     The block stages its chunk of K/V in shared memory as f32 (K padded to
//     D+1 columns), then one warp per query head of the GQA group computes
//     the chunk's scores (one key per lane), max, exp-sum and p @ V, and
//     writes (max, sum, acc[D]) as a partial.
//   - the write race: the row-pos write would race with blocks reading its
//     chunk. Only the block that owns pos's chunk touches row pos: it
//     encodes that row from k_new / v_new, stores it, and attends dec(stored)
//     -- the token exactly as the cache now holds it -- so it is the only
//     writer, and no other block reads row pos.
//   - launch 2: one block per (b, h) rescales the live partials by
//     exp(m_c - max) and divides by the summed denominators.
#include "common.cuh"

using namespace tllm;

namespace {

constexpr int kChunk = 32;   // cache rows per block (one per lane)
constexpr int kWarps = 4;

// Cache element codec: enc stores an f32 value, dec reads one back as f32
// (`scale` is the layer's dequant scale, used by int8 caches only).
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

template <typename T, typename TC, int D>
__global__ void __launch_bounds__(kWarps * 32)
    decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                          const T* __restrict__ v_new, TC* __restrict__ kc,
                          TC* __restrict__ vc, const float* __restrict__ kv_scale,
                          const int* __restrict__ positions,
                          float* __restrict__ part_m, float* __restrict__ part_l,
                          float* __restrict__ part_acc, int Hq, int Hkv, int S,
                          int n_chunks, float sm_scale) {
  using Codec = KVCodec<TC>;
  constexpr int DL = D / 32;
  __shared__ float ks[kChunk][D + 1];
  __shared__ float vs[kChunk][D];

  const int c = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int pos = positions[b];
  if (c > pos / kChunk) return;  // chunk not live yet (whole block exits)

  const int group = Hq / Hkv;
  const int row0 = c * kChunk;
  const size_t head_base = (static_cast<size_t>(b) * Hkv + hk) * S;  // row index
  const size_t new_base = (static_cast<size_t>(b) * Hkv + hk) * D;
  const float kvs = kv_scale != nullptr ? *kv_scale : 1.f;

  for (int i = threadIdx.x; i < kChunk * D; i += blockDim.x) {
    const int j = i / D, d = i - (i / D) * D, row = row0 + j;
    float kv = 0.f, vv = 0.f;
    if (row < pos) {
      const size_t off = (head_base + row) * D + d;
      kv = Codec::dec(kc[off], kvs);
      vv = Codec::dec(vc[off], kvs);
    } else if (row == pos) {  // only the owning block sees row == pos
      const TC kt = Codec::enc(to_f(k_new[new_base + d]), kvs);
      const TC vt = Codec::enc(to_f(v_new[new_base + d]), kvs);
      const size_t off = (head_base + row) * D + d;
      kc[off] = kt;
      vc[off] = vt;
      kv = Codec::dec(kt, kvs);
      vv = Codec::dec(vt, kvs);
    }
    ks[j][d] = kv;
    vs[j][d] = vv;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int g = warp; g < group; g += kWarps) {
    const int h = hk * group + g;
    const T* qh = q + (static_cast<size_t>(b) * Hq + h) * D;
    float s = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) s = fmaf(to_f(qh[d]), ks[lane][d], s);
    s = (row0 + lane <= pos) ? s * sm_scale : kNegInf;
    const float mx = warp_max(s);
    const float p = expf(s - mx);
    const float l = warp_sum(p);
    float acc[DL];
#pragma unroll
    for (int i = 0; i < DL; ++i) acc[i] = 0.f;
#pragma unroll 4
    for (int j = 0; j < kChunk; ++j) {
      const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
      for (int i = 0; i < DL; ++i) acc[i] = fmaf(pj, vs[j][lane + 32 * i], acc[i]);
    }
    const size_t o = (static_cast<size_t>(b) * Hq + h) * n_chunks + c;
    if (lane == 0) {
      part_m[o] = mx;
      part_l[o] = l;
    }
#pragma unroll
    for (int i = 0; i < DL; ++i) part_acc[o * D + lane + 32 * i] = acc[i];
  }
}

// One block of D threads per (h, b).
template <typename T, int D>
__global__ void decode_combine_kernel(const float* __restrict__ part_m,
                                      const float* __restrict__ part_l,
                                      const float* __restrict__ part_acc,
                                      const int* __restrict__ positions,
                                      T* __restrict__ out, int Hq, int n_chunks) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int d = threadIdx.x;
  const int live = min(positions[b] / kChunk + 1, n_chunks);
  const size_t base = (static_cast<size_t>(b) * Hq + h) * n_chunks;
  float mx = kLowest;
  for (int c = 0; c < live; ++c) mx = fmaxf(mx, part_m[base + c]);
  float l = 0.f, acc = 0.f;
  for (int c = 0; c < live; ++c) {
    const float w = expf(part_m[base + c] - mx);
    l = fmaf(w, part_l[base + c], l);
    acc = fmaf(w, part_acc[(base + c) * D + d], acc);
  }
  out[(static_cast<size_t>(b) * Hq + h) * D + d] = from_f<T>(acc / l);
}

template <typename T, typename TC, int D>
cudaError_t launch(const void* q, const void* k_new, const void* v_new,
                   void* kc, void* vc, const void* kv_scale,
                   const void* positions, void* out, void* part_m,
                   void* part_l, void* part_acc, int B, int Hq, int Hkv, int S,
                   float sm_scale, cudaStream_t stream) {
  const int n_chunks = S / kChunk;
  decode_partial_kernel<T, TC, D><<<dim3(n_chunks, Hkv, B), kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_new),
      static_cast<const T*>(v_new), static_cast<TC*>(kc), static_cast<TC*>(vc),
      static_cast<const float*>(kv_scale), static_cast<const int*>(positions),
      static_cast<float*>(part_m), static_cast<float*>(part_l),
      static_cast<float*>(part_acc), Hq, Hkv, S, n_chunks, sm_scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T, D><<<dim3(Hq, B), D, 0, stream>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_acc), static_cast<const int*>(positions),
      static_cast<T*>(out), Hq, n_chunks);
  return cudaGetLastError();
}

#define TLLM_DECODE_ARGS                                                     \
  q, k_new, v_new, kc, vc, kv_scale, positions, out, part_m, part_l,        \
      part_acc, B, Hq, Hkv, S, sm_scale, stream

template <typename T, typename TC>
cudaError_t launch_d(int D, const void* q, const void* k_new,
                     const void* v_new, void* kc, void* vc,
                     const void* kv_scale, const void* positions, void* out,
                     void* part_m, void* part_l, void* part_acc, int B,
                     int Hq, int Hkv, int S, float sm_scale,
                     cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, TC, 32>(TLLM_DECODE_ARGS);
    case 64:
      return launch<T, TC, 64>(TLLM_DECODE_ARGS);
    case 128:
      return launch<T, TC, 128>(TLLM_DECODE_ARGS);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_kv(bool kv_int8, int D, const void* q, const void* k_new,
                      const void* v_new, void* kc, void* vc,
                      const void* kv_scale, const void* positions, void* out,
                      void* part_m, void* part_l, void* part_acc, int B,
                      int Hq, int Hkv, int S, float sm_scale,
                      cudaStream_t stream) {
  if (kv_int8) return launch_d<T, int8_t>(D, TLLM_DECODE_ARGS);
  return launch_d<T, T>(D, TLLM_DECODE_ARGS);
}

#undef TLLM_DECODE_ARGS

}  // namespace

// q [B, Hq, D], k_new/v_new [B, Hkv, D] (dtype), kc/vc: layer `layer` of the
// stacked cache, i.e. [B, Hkv, S, D] in dtype or, with kv_int8, int8 (the
// wrapper offsets the pointers), kv_scale: that layer's f32 dequant scale
// (int8 only, else null), positions [B] int32, out [B, Hq, D]; part_m/part_l
// [B, Hq, S/32] and part_acc [B, Hq, S/32, D] f32 scratch. S % 32 == 0,
// D in {32, 64, 128}.
extern "C" int tllm_decode_attention(const void* q, const void* k_new,
                                     const void* v_new, void* kc, void* vc,
                                     const void* kv_scale,
                                     const void* positions, void* out,
                                     void* part_m, void* part_l,
                                     void* part_acc, int dtype, int kv_int8,
                                     int B, int Hq, int Hkv, int S, int D,
                                     float sm_scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch_kv<__nv_bfloat16>(kv_int8 != 0, D, q, k_new, v_new, kc, vc,
                                    kv_scale, positions, out, part_m, part_l,
                                    part_acc, B, Hq, Hkv, S, sm_scale, s);
  if (dtype == kF32)
    return launch_kv<float>(kv_int8 != 0, D, q, k_new, v_new, kc, vc, kv_scale,
                            positions, out, part_m, part_l, part_acc, B, Hq,
                            Hkv, S, sm_scale, s);
  return cudaErrorInvalidValue;
}
