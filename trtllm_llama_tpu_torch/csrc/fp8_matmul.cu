// FP8 (e4m3) weight stacked matmul for few rows (decode / short prefill):
// the fp8 instantiations of woq_gemv.cuh (one row, f32 and the rest) and
// woq_gemv_tc.cuh (tensor cores: bf16 / fp16 at TC_MIN_ROWS..16 rows).
//
// Replaces: trtllm_llama_tpu/ops/pallas/woq_matmul.py::fp8_matmul_stacked
// and, on a unit layer axis, fp8_matmul (the fp8 branch of _kernel_int8,
// _decode_fp8_planes on rows interleaved by interleave_fp8_rows, the
// per-channel scale after the sum, the _fuse_prologue norm and SwiGLU
// modes and the _fuse_epilogue residual add). A library of its own so that nvcc builds it
// beside the int8 / int4 one. The designs and what bounds them on the
// H100: see the two headers.
#include "woq_gemv_tc.cuh"

using namespace tllm;

// x [M, K] (dtype; [M, 2K] = [gate | up] with swiglu), q uint8 e4m3 codes
// [K, ldw] of ONE layer, rows interleaved by blk (0: logical order), scale
// f32 [N], from the first column computed (N columns of the ldw, as
// tllm_woq_matmul_stacked), norm_w [K] or null, resid [M, N] or null, out [M, N] f32; part
// and counters of the stream's workspace, ksplit, kc, mr (1, 2 or 4) and
// lanes as tllm_woq_matmul_stacked. One launch.
extern "C" int tllm_fp8_matmul_stacked(const void* x, const void* q,
                                       const void* scale, const void* norm_w,
                                       const void* resid, void* out, void* part,
                                       void* counters, int dtype, int M, int K,
                                       int N, int ldw, int ksplit, int kc,
                                       int mr, int lanes, int blk, float eps,
                                       int swiglu, int device, void* stream) {
  const gemv::Params p{x, static_cast<const uint8_t*>(q),
                       static_cast<const float*>(scale), norm_w, resid,
                       static_cast<float*>(out), static_cast<float*>(part),
                       static_cast<int*>(counters), M, K, N, ldw, kc,
                       ksplit, lanes, blk, 0, eps, swiglu};
  return gemv::dispatch<gemv::kFp8, false>(dtype, mr, p, device, stream);
}

// The tensor-core body (woq_gemv_tc.cuh) for bf16 / fp16 x of 1-16 rows:
// as tllm_woq_gemv_tc (e4m3 codes, rows interleaved by blk, per-channel
// scales, N columns of the ldw).
extern "C" int tllm_fp8_gemv_tc(const void* x, const void* q, const void* scale,
                                const void* norm_w, const void* resid,
                                void* out, void* part, int dtype,
                                int M, int K, int N, int ldw, int ksplit,
                                int sps, int mt, int nt, int blk, float eps,
                                int swiglu, int device, void* stream) {
  const gemv_tc::Args a{x, q, scale, norm_w, resid, out, part, M, K, N, ldw,
                        ksplit, sps, mt, nt, blk, 0, eps, swiglu};
  return gemv_tc::dispatch<gemv::kFp8, false>(dtype, a, device, stream);
}
