// Row 9: one-token decode attention fused with the in-place KV-cache write,
// in one launch, over one layer of the stacked cache [B, Hkv, S, D].
//
// Replaces: trtllm_llama_tpu/ops/pallas/attention.py:185
// (fused_decode_attention, pallas_call at :240; the 'fused' decode mode).
//
// Row 9 computes kernel 3's function, so it runs kernel 3's body: the
// split-cache one-launch kernel of flash_decode.cuh (its bound, the live K/V
// bytes, and its design are there), built into a library of its own so that
// the 'fused' mode keeps its own entry and launch count.
#include "flash_decode.cuh"

using namespace tllm;

// q [B, Hq, D], k_new/v_new [B, Hkv, D] (dtype), kc/vc: layer `layer` of the
// stacked cache, i.e. [B, Hkv, S, D] in dtype or, with kv_int8, int8 (the
// wrapper offsets the pointers; 16-byte aligned), kv_scale: that layer's f32
// dequant scale (int8 only, else null), positions [B] int32, out [B, Hq, D];
// splits / tps: the host's split of the S rows (decode_split); part /
// counters: the workspace, f32 [B * Hq * splits * (D + 2)] and int32
// [B * Hq] zeroed once (null at one split). S % 32 == 0,
// D in {32, 64, 96, 128, 256}, any GQA group.
extern "C" int tllm_fused_decode_attention(
    const void* q, const void* k_new, const void* v_new, void* kc, void* vc,
    const void* kv_scale, const void* positions, void* out, void* part,
    void* counters, int dtype, int kv_int8, int B, int Hq, int Hkv, int S,
    int D, float sm_scale,
    int splits, int tps, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const flash_decode::Args a{q,   k_new,    v_new, kc,  vc, kv_scale,
                             positions,   out,   part, counters, B,
                             Hq,  Hkv,      S,     splits,   tps, sm_scale,
                             static_cast<cudaStream_t>(stream)};
  return flash_decode::dispatch(dtype, kv_int8 != 0, D, a);
}
