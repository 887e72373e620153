// Weight-only INT8 / INT4 stacked matmul at prefill rows, on the tensor
// cores: the int8 and int4 instantiations of woq_gemm.cuh.
//
// Replaces: trtllm_llama_tpu/ops/pallas/woq_matmul.py::woq_matmul_stacked
// (through woq_matmul_stacked_2d, :461) and, on a unit layer axis, its 2-D
// form woq_matmul, at the row counts of a prefill (the int8 branch of
// _kernel_int8 and _kernel_int4, per-channel or g128 scales). The design
// and what bounds it on the H100: see woq_gemm.cuh.
#include "woq_gemm.cuh"

using namespace tllm;

// x [M, K] (bf16 / fp16), q of ONE layer: int8 [K, ldw] (w_bits 8) or
// packed int4 [K/2, ldw] (w_bits 4), scale f32 [N] (grouped 0) or
// [K/128, ldw] (grouped 1), from the first of the N columns computed (a
// window [start, start + N) of the ldw: the wrapper offsets q and scale by
// start, a multiple of 128; ldw == N for the whole), map: the 128-byte tile_rows of the layout, out f32 [M, N],
// part f32 [ksplit, M, N] scratch (unused when ksplit == 1), kt_per: K
// tiles of 128 rows per split.
extern "C" int tllm_woq_gemm(const void* x, const void* q, const void* scale,
                             const void* map, void* out, void* part,
                             int dtype, int M, int K, int N, int ldw,
                             int ksplit, int kt_per, int w_bits, int grouped,
                             int device, void* stream) {
  const gemm::Args a{x, q, scale, map, out, part, M, K, N, ldw, ksplit,
                     kt_per};
  if (w_bits == 8)
    return grouped ? gemm::dispatch<gemv::kInt8, true>(dtype, a, device, stream)
                   : gemm::dispatch<gemv::kInt8, false>(dtype, a, device, stream);
  if (w_bits == 4)
    return grouped ? gemm::dispatch<gemv::kInt4, true>(dtype, a, device, stream)
                   : gemm::dispatch<gemv::kInt4, false>(dtype, a, device, stream);
  return cudaErrorInvalidValue;
}
