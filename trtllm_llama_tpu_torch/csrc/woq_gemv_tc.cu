// Weight-only INT8 / INT4 stacked matmul at TC_MIN_ROWS..16 rows on the
// tensor cores: the int8 and int4 instantiations of woq_gemv_tc.cuh, a
// library of its own so that nvcc builds it beside woq_matmul.cu (the
// CUDA-core body).
//
// Replaces: trtllm_llama_tpu/ops/pallas/woq_matmul.py::woq_matmul_stacked
// and, on a unit layer axis, its 2-D form woq_matmul (_kernel_int8's int8
// branch and _kernel_int4, per-channel or grouped scales, the
// _fuse_prologue norm and SwiGLU modes and the _fuse_epilogue residual
// add), for bf16 / fp16 activations. The design and what bounds it on the
// H100: see woq_gemv_tc.cuh.
#include "woq_gemv_tc.cuh"

using namespace tllm;

// x [M, K] (bf16 / fp16; [M, 2K] = [gate | up] with swiglu), q of ONE
// layer: int8 [K, ldw] (w_bits 8) or packed int4 [K/2, ldw] (w_bits 4,
// pack block blk), scale f32 [N] (group 0) or [K/group, ldw], from the
// first column computed (a window [start, start + N) of the ldw columns:
// the wrapper offsets q and scale by start; ldw == N for the whole; a
// window starts on a column tile of 16 nt), norm_w [K] or null,
// resid [M, N] or null, out [M, N] f32; part [ksplit, M, N] f32 when
// ksplit > 1 (the per-stream workspace; a launch after the body sums the
// splits into out); ksplit splits of sps 16-slot steps, mt 8 (M <= 8) or
// 16, nt the body's tile width (woq_matmul.py::tc_plan).
extern "C" int tllm_woq_gemv_tc(const void* x, const void* q, const void* scale,
                                const void* norm_w, const void* resid,
                                void* out, void* part, int dtype, int M,
                                int K, int N, int ldw, int ksplit, int sps,
                                int mt, int nt, int w_bits, int blk,
                                int group, float eps, int swiglu, int device,
                                void* stream) {
  const gemv_tc::Args a{x, q, scale, norm_w, resid, out, part, M, K, N, ldw,
                        ksplit, sps, mt, nt, blk, group, eps, swiglu};
  if (w_bits == 8)
    return group ? gemv_tc::dispatch<gemv::kInt8, true>(dtype, a, device, stream)
                 : gemv_tc::dispatch<gemv::kInt8, false>(dtype, a, device, stream);
  if (w_bits == 4)
    return group ? gemv_tc::dispatch<gemv::kInt4, true>(dtype, a, device, stream)
                 : gemv_tc::dispatch<gemv::kInt4, false>(dtype, a, device, stream);
  return cudaErrorInvalidValue;
}
