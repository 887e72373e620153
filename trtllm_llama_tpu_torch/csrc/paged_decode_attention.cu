// Row 14: one-token decode attention fused with the in-place KV write,
// over one layer of the paged block pool [NB, Hkv, BS, D].
//
// Replaces: trtllm_llama_tpu/ops/pallas/paged_decode_attention.py:157
// (paged_decode_attention, pallas_call at :218; bf16 / f32 pools, and int8
// pools with one static dequant scale per layer; the port also takes e4m3
// (fp8) pools, which the JAX package serves on its XLA path).
//
// Sequence b's row r lives in pool block tables[b, r / BS] at row r % BS;
// its first MB * BS rows are attendable (MB = the table's width). Table
// entries -1 stand for the trash block NB - 1, as the JAX package's caller
// maps them (ops/paged_attention.py:138). A write position pos with
// pos / BS >= MB goes to row pos % BS of the trash block, and the attention
// covers the MB * BS table rows (the rule of the JAX XLA path,
// ops/paged_attention.py:105-114); the Pallas kernel reads the table there
// unguarded, which a finished serving slot at max_seq_len reaches.
//
// The body is kernel 3's one-launch split-cache decode (flash_decode.cuh,
// its paged policy): the MB * BS rows split over the card in 64-row tiles
// by the host's decode_split, each block's rows found through its slice of
// the block table in shared memory, the last split to finish merging from
// the per-stream workspace. Bound: the live K/V bytes, 2 * Hkv * D * elt *
// sum_b min(pos_b + 1, MB * BS), at 3.35 TB/s. The TPU kernel's
// whole-block double-buffered DMA, its VMEM window read-modify-write and
// its row patching exist for the TPU's DMA granularity and have no
// counterpart here: the block owning row pos stores it and attends it as
// stored, which leaves every other row of the pool untouched.
#include "flash_decode.cuh"

using namespace tllm;

// q [B, Hq, D], k_new/v_new [B, Hkv, D] (dtype), pk/pv: layer `layer` of the
// pools, i.e. [NB, Hkv, BS, D] in dtype or, by kv_kind (CacheKind of
// flash_decode.cuh), int8 or e4m3 codes (the wrapper offsets the pointers;
// 16-byte aligned), kv_scale: that layer's f32 dequant scale (int8 and e4m3
// only, else null), tables [B, MB] int32, positions [B]
// int32, out [B, Hq, D]; splits / tps: decode_split of the MB * BS rows;
// slice: the table entries a block holds (table_slice); part / counters:
// the workspace (null at one split). BS % 8 == 0, D in {32, 64, 96, 128,
// 256}, any GQA group. One launch.
extern "C" int tllm_paged_decode_attention(
    const void* q, const void* k_new, const void* v_new, void* pk, void* pv,
    const void* kv_scale, const void* tables, const void* positions,
    void* out, void* part, void* counters, int dtype, int kv_kind, int B,
    int Hq, int Hkv, int NB, int BS, int MB, int D, float sm_scale,
    int splits, int tps, int slice, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const flash_decode::Args a{q,     k_new, v_new,    pk,       pv,
                             kv_scale, positions, out, part, counters,
                             B,     Hq,    Hkv,      MB * BS,  splits,
                             tps,   sm_scale, static_cast<cudaStream_t>(stream),
                             false, tables, MB,       BS,       NB - 1,
                             slice};
  return flash_decode::dispatch<true>(dtype, kv_kind, D, a);
}
