// FP8 (e4m3) weight stacked matmul at prefill rows, on the tensor cores:
// the fp8 instantiation of woq_gemm.cuh.
//
// Replaces: trtllm_llama_tpu/ops/pallas/woq_matmul.py::fp8_matmul_stacked
// (:654, through woq_matmul_stacked_2d, :461) and, on a unit layer axis,
// fp8_matmul (:646), at the row counts of a prefill (_decode_fp8_planes on
// rows interleaved by interleave_fp8_rows, the per-channel scale after the
// sum). A library of its own so that nvcc builds it beside the int8 /
// int4 one. The design and what bounds it on the H100: see woq_gemm.cuh.
#include "woq_gemm.cuh"

using namespace tllm;

// x [M, K] (bf16 / fp16), q uint8 e4m3 codes [K, ldw] of ONE layer (rows
// interleaved within 128-row blocks, or in logical order), scale f32 [N],
// from the first of the N columns computed (as tllm_woq_gemm),
// map: the 128-byte tile_rows of the layout, out f32 [M, N], part f32
// [ksplit, M, N] scratch (unused when ksplit == 1), kt_per: K tiles of 128
// rows per split.
extern "C" int tllm_fp8_gemm(const void* x, const void* q, const void* scale,
                             const void* map, void* out, void* part,
                             int dtype, int M, int K, int N, int ldw,
                             int ksplit, int kt_per, int device,
                             void* stream) {
  const gemm::Args a{x, q, scale, map, out, part, M, K, N, ldw, ksplit,
                     kt_per};
  return gemm::dispatch<gemv::kFp8, false>(dtype, a, device, stream);
}
