// Kernel 3: one-token decode attention fused with the in-place KV-cache
// write, over one layer of the stacked cache [B, Hkv, S, D]; and row 8, the
// same attention read-only, over rows < cache_lens[b].
//
// Kernel 3 replaces: trtllm_llama_tpu/ops/pallas/dma_decode_attention.py:156
// (dma_decode_attention, bf16 / f32 KV, and the int8-KV branch with one
// static dequant scale per layer). Unlike the reference, which switches to
// this kernel only at S_max >= 4096 (a crossover measured on a TPU), the
// port uses it at every cache length. Its body, shared with row 9, is the
// split-cache one-launch kernel of flash_decode.cuh (the bound, the live
// K/V bytes, and the design are there). A write position pos >= S is
// dropped, as the JAX package's scatter drops it, and the attention then
// covers all S rows.
//
// Row 8 replaces trtllm_llama_tpu/ops/pallas/attention.py::
// decode_attention_kernel (the 'split' decode mode and decode_attention_at):
// the read-only policy of decode_attention.cuh (two launches, partials in
// device memory); here a sequence's rows are contiguous, so row r of
// (b, hk) is at ((b * Hkv + hk) * S + r) * D. A length past S attends all S
// rows and a length <= 0 averages V over them (the reference's all-masked
// softmax).
#include "decode_attention.cuh"
#include "flash_decode.cuh"

using namespace tllm;

namespace {

// Row 8: the stacked cache's rows, no write; positions[] are the cache
// lengths.
struct ReadRows {
  static constexpr bool kWrite = false;
  int cap;  // S
  int hkv;
  int d;

  __device__ long long offset(int b, int hk, int row) const {
    return ((static_cast<long long>(b) * hkv + hk) * cap + row) * d;
  }
  __device__ long long write_offset(int, int, int) const { return -1; }
};

}  // namespace

// q [B, Hq, D], k_new/v_new [B, Hkv, D] (dtype), kc/vc: layer `layer` of the
// stacked cache, i.e. [B, Hkv, S, D] in dtype or, with kv_int8, int8 (the
// wrapper offsets the pointers; 16-byte aligned), kv_scale: that layer's f32
// dequant scale (int8 only, else null), positions [B] int32, out [B, Hq, D];
// splits / tps: the host's split of the S rows (decode_split); part /
// counters: the workspace, f32 [B * Hq * splits * (D + 2)] and int32
// [B * Hq] zeroed once (null at one split). S % 32 == 0,
// D in {32, 64, 96, 128, 256}. One launch.
extern "C" int tllm_decode_attention(const void* q, const void* k_new,
                                     const void* v_new, void* kc, void* vc,
                                     const void* kv_scale,
                                     const void* positions, void* out,
                                     void* part, void* counters, int dtype,
                                     int kv_int8, int B, int Hq,
                                     int Hkv, int S, int D, float sm_scale,
                                     int splits, int tps, int device,
                                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const flash_decode::Args a{q,   k_new,    v_new, kc,  vc, kv_scale,
                             positions,   out,   part, counters, B,
                             Hq,  Hkv,      S,     splits,   tps, sm_scale,
                             static_cast<cudaStream_t>(stream)};
  return flash_decode::dispatch(dtype, kv_int8 != 0, D, a);
}

// Row 8. q [B, Hq, D] (dtype), kc/vc: layer `layer` of the stacked cache
// [B, Hkv, S, D] in dtype or, with kv_int8, int8 (read only), kv_scale: that
// layer's f32 dequant scale (int8 only, else null), cache_lens [B] int32,
// out [B, Hq, D]; part_m/part_l [B, Hq, S/32] and part_acc
// [B, Hq, S/32, D] f32 scratch. S % 32 == 0,
// D in {32, 64, 96, 128, 256}.
extern "C" int tllm_decode_attention_read(const void* q, const void* kc,
                                          const void* vc, const void* kv_scale,
                                          const void* cache_lens, void* out,
                                          void* part_m, void* part_l,
                                          void* part_acc, int dtype,
                                          int kv_int8, int B, int Hq, int Hkv,
                                          int S, int D, float sm_scale,
                                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const decode::Args a{q, nullptr, nullptr, const_cast<void*>(kc),
                       const_cast<void*>(vc), kv_scale, cache_lens, out,
                       part_m, part_l, part_acc, B, Hq, Hkv, sm_scale,
                       static_cast<cudaStream_t>(stream)};
  ReadRows rows;
  rows.cap = S;
  rows.hkv = Hkv;
  rows.d = D;
  return decode::dispatch(dtype, kv_int8 != 0, D, a, rows);
}
