// Weight-only INT8 / INT4 stacked matmul for few rows (decode / short
// prefill): the int8 and int4 instantiations of woq_gemv.cuh, the
// one-launch body of one row (and of f32 activations and the layouts only
// it tiles;
// woq_gemv_tc.cu holds the tensor-core body's, a library of its own so
// that nvcc builds the two in parallel).
//
// Replaces: trtllm_llama_tpu/ops/pallas/woq_matmul.py::woq_matmul_stacked
// and, on a unit layer axis, its 2-D form woq_matmul (_kernel_int8's int8
// branch and _kernel_int4 with _unpack_block_planes, per-channel or grouped
// scales, the _fuse_prologue norm and SwiGLU modes and the _fuse_epilogue
// residual add).
// The design and what bounds it on the H100: see woq_gemv.cuh.
#include "woq_gemv.cuh"

using namespace tllm;

// x [M, K] (dtype; [M, 2K] = [gate | up] with swiglu), q of ONE layer:
// int8 [K, ldw] (w_bits 8) or packed int4 [K/2, ldw] (w_bits 4, pack
// block blk), scale f32 [N] (group 0) or [K/group, ldw], from the first
// column computed (a window [start, start + N) of the ldw columns: the
// wrapper offsets q and scale by start; ldw == N for the whole), norm_w
// [K] or null, resid
// [M, N] or null, out [M, N] f32; part [ksplit, M, N] f32 and counters
// [column tiles] int32 of the stream's workspace (null at ksplit 1). K is
// split into ksplit ranges of kc logical rows; lanes threads along N;
// mr in {1, 2, 4} (at most 2 when grouped): rows per register tile (the
// wrapper's gemv_plan). swiglu: stage silu(gate) * up as the matmul's
// input (norm_w null). One launch.
extern "C" int tllm_woq_matmul_stacked(const void* x, const void* q,
                                       const void* scale, const void* norm_w,
                                       const void* resid, void* out, void* part,
                                       void* counters, int dtype, int M, int K,
                                       int N, int ldw, int ksplit, int kc,
                                       int mr, int lanes, int w_bits, int blk,
                                       int group, float eps, int swiglu,
                                       int device, void* stream) {
  const gemv::Params p{x, static_cast<const uint8_t*>(q),
                       static_cast<const float*>(scale), norm_w, resid,
                       static_cast<float*>(out), static_cast<float*>(part),
                       static_cast<int*>(counters), M, K, N, ldw, kc,
                       ksplit, lanes, blk, group, eps, swiglu};
  if (w_bits == 8)
    return group ? gemv::dispatch<gemv::kInt8, true>(dtype, mr, p, device, stream)
                 : gemv::dispatch<gemv::kInt8, false>(dtype, mr, p, device, stream);
  if (w_bits == 4)
    return group ? gemv::dispatch<gemv::kInt4, true>(dtype, mr, p, device, stream)
                 : gemv::dispatch<gemv::kInt4, false>(dtype, mr, p, device, stream);
  return cudaErrorInvalidValue;
}
