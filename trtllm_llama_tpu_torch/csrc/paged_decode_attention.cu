// Kernel 14: one-token decode attention fused with the in-place KV write,
// over one layer of the paged block pool [NB, Hkv, BS, D].
//
// Replaces: trtllm_llama_tpu/ops/pallas/paged_decode_attention.py::
// paged_decode_attention (bf16 / f32 pools, and int8 pools with one static
// dequant scale per layer).
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
// The body, its bound (the live K/V bytes, 2 * B * Hkv * (pos + 1) * D *
// elt) and its design are in decode_attention.cuh: flash-decoding
// over live 32-row chunks, a chunk's rows looked up through the table once
// per block. The TPU kernel's whole-block double-buffered DMA, its VMEM
// window read-modify-write and its row patching exist for the TPU's DMA
// granularity and have no counterpart here: the block owning pos's chunk
// stores row pos and attends it as stored, which leaves every other row of
// the pool, in the write block and elsewhere, untouched.
#include "decode_attention.cuh"

using namespace tllm;

namespace {

struct PagedRows {
  int cap;  // MB * BS
  const int* tables;  // [B, MB]
  int mb, bs, hkv, d, trash;

  __device__ int block(int b, int i) const {
    const int blk = tables[static_cast<size_t>(b) * mb + i];
    return blk < 0 ? trash : blk;
  }
  __device__ long long at(int blk, int hk, int r) const {
    return ((static_cast<long long>(blk) * hkv + hk) * bs + r) * d;
  }
  __device__ long long offset(int b, int hk, int row) const {
    return at(block(b, row / bs), hk, row % bs);
  }
  __device__ long long write_offset(int b, int hk, int pos) const {
    return at(pos / bs < mb ? block(b, pos / bs) : trash, hk, pos % bs);
  }
};

}  // namespace

// q [B, Hq, D], k_new/v_new [B, Hkv, D] (dtype), pk/pv: layer `layer` of the
// pools, i.e. [NB, Hkv, BS, D] in dtype or, with kv_int8, int8 (the wrapper
// offsets the pointers), kv_scale: that layer's f32 dequant scale (int8
// only, else null), tables [B, MB] int32, positions [B] int32, out
// [B, Hq, D]; part_m/part_l [B, Hq, C] and part_acc [B, Hq, C, D] f32
// scratch with C = ceil(MB * BS / 32). BS % 8 == 0,
// D in {32, 64, 96, 128, 256}.
extern "C" int tllm_paged_decode_attention(
    const void* q, const void* k_new, const void* v_new, void* pk, void* pv,
    const void* kv_scale, const void* tables, const void* positions,
    void* out, void* part_m, void* part_l, void* part_acc, int dtype,
    int kv_int8, int B, int Hq, int Hkv, int NB, int BS, int MB, int D,
    float sm_scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const decode::Args a{q, k_new, v_new, pk, pv, kv_scale, positions, out,
                       part_m, part_l, part_acc, B, Hq, Hkv, sm_scale,
                       static_cast<cudaStream_t>(stream)};
  const PagedRows rows{MB * BS, static_cast<const int*>(tables), MB, BS,
                       Hkv, D, NB - 1};
  return decode::dispatch(dtype, kv_int8 != 0, D, a, rows);
}
