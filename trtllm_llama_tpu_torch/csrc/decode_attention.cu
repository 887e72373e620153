// Kernel 3, row 9 and row 8: one-token decode attention over one layer of
// the stacked cache [B, Hkv, S, D], one library for all three. Kernel 3
// and row 9 write the new token's row in place and attend
// (`tllm_decode_attention`); row 8 attends read-only over rows <
// cache_lens[b] (`tllm_decode_attention_read`).
//
// Kernel 3 replaces: trtllm_llama_tpu/ops/pallas/dma_decode_attention.py:156
// (dma_decode_attention, bf16 / f32 KV, and the int8-KV branch with one
// static dequant scale per layer; the port also takes e4m3 (fp8) caches,
// which the JAX package sends to its XLA path, ops/attention.py:256).
// Unlike the reference, which switches to this kernel only at S_max >= 4096
// (a crossover measured on a TPU), the port uses it at every cache length.
// Row 9 replaces trtllm_llama_tpu/ops/pallas/attention.py:185
// (fused_decode_attention, the 'fused' mode): the same function, so the
// same entry; its wrapper keeps its own launch count. Row 8 replaces
// attention.py:72 (decode_attention_kernel, the 'split' mode and
// decode_attention_at).
//
// All three run the split-cache one-launch body of flash_decode.cuh (the
// bound, the live K/V bytes, and the design are there). A write position
// pos >= S is dropped, as the JAX package's scatter drops it, and the
// attention then covers all S rows; a length past S reads all S rows and a
// length <= 0 averages V over them (the reference's all-masked softmax).
#include "flash_decode.cuh"

using namespace tllm;

// q [B, Hq, D], k_new/v_new [B, Hkv, D] (dtype), kc/vc: layer `layer` of the
// stacked cache, i.e. [B, Hkv, S, D] in dtype or, by kv_kind (CacheKind of
// flash_decode.cuh), int8 or e4m3 codes (the wrapper offsets the pointers;
// 16-byte aligned), kv_scale: that layer's f32 dequant scale (int8 and e4m3
// only, else null), positions [B] int32, out [B, Hq, D];
// splits / tps: the host's split of the S rows (decode_split); part /
// counters: the workspace, f32 [B * Hq * splits * (D + 2)] and int32
// [B * Hq] zeroed once (null at one split). S % 32 == 0,
// D in {32, 64, 96, 128, 256}, any GQA group. One launch.
extern "C" int tllm_decode_attention(const void* q, const void* k_new,
                                     const void* v_new, void* kc, void* vc,
                                     const void* kv_scale,
                                     const void* positions, void* out,
                                     void* part, void* counters, int dtype,
                                     int kv_kind, int B, int Hq,
                                     int Hkv, int S, int D, float sm_scale,
                                     int splits, int tps, int device,
                                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const flash_decode::Args a{q,   k_new,    v_new, kc,  vc, kv_scale,
                             positions,   out,   part, counters, B,
                             Hq,  Hkv,      S,     splits,   tps, sm_scale,
                             static_cast<cudaStream_t>(stream), false};
  return flash_decode::dispatch<false>(dtype, kv_kind, D, a);
}

// Row 8: as tllm_decode_attention with no new K/V and nothing written;
// cache_lens [B] int32 are the rows each sequence attends (kc / vc read
// only, 16-byte aligned). The same split, workspace and limits. One launch.
extern "C" int tllm_decode_attention_read(const void* q, const void* kc,
                                          const void* vc, const void* kv_scale,
                                          const void* cache_lens, void* out,
                                          void* part, void* counters,
                                          int dtype, int kv_kind, int B,
                                          int Hq, int Hkv, int S, int D,
                                          float sm_scale, int splits, int tps,
                                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const flash_decode::Args a{q,       nullptr,  nullptr,
                             const_cast<void*>(kc), const_cast<void*>(vc),
                             kv_scale, cache_lens, out, part, counters, B,
                             Hq,      Hkv,      S,     splits,   tps, sm_scale,
                             static_cast<cudaStream_t>(stream), true};
  return flash_decode::dispatch<false>(dtype, kv_kind, D, a);
}
