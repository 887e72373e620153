"""Kernel 6: FP8 (e4m3) weight matmul: the GEMV (csrc/fp8_matmul.cu, body
in csrc/woq_gemv.cuh) at decode rows and the tensor-core GEMM
(csrc/fp8_gemm.cu, body in csrc/woq_gemm.cuh) at prefill rows.

Replaces `trtllm_llama_tpu/ops/pallas/woq_matmul.py::fp8_matmul_stacked`
(the fp8 branch of `_kernel_int8`: e4m3 codes in rows interleaved by
`interleave_fp8_rows`, per-channel scale after the sum, the norm and
SwiGLU prologues, the residual epilogue) and its 2-D form `fp8_matmul`.
Bound on the H100: the weight bytes (one per weight) at decode rows; the
GEMV is kernel 1's with Hopper's exact e4m3x2 -> f16x2 convert as the
decode and x staged in the interleaved row order. Above ~300 rows the
operations: the GEMM decodes the codes into shared memory in logical row
order and runs wgmma on them. kernel 1's `gemm_route` picks the kernel.

`fp8_matmul_stacked` and `fp8_matmul` take the plain version for CPU
tensors and launch a kernel for CUDA tensors; each counts its launches
in `.launches`, the GEMM's share in `.gemm_launches`
(`fp8_matmul_stacked.swiglu_launches` counts the GEMV launches with the
SwiGLU prologue).
"""

from __future__ import annotations

import ctypes

import torch

from ...quantization.tensors import FP8Weight
from ..fp8 import fp8_decode
from .woq_matmul import (_device_kind, gemm_route, launch_gemm, launch_gemv,
                         prologue, resid_epilogue, unit_layer)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"tllm_fp8_matmul_stacked":
               [_P] * 7 + [_I] * 8 + [_F, _I, _I, _P]}
_GEMM_SIGNATURES = {"tllm_fp8_gemm": [_P] * 6 + [_I] * 7 + [_P]}


def fp8_matmul_stacked_plain(x, w: FP8Weight, layer: int, norm_w=None,
                             eps: float = 1e-6, resid=None,
                             swiglu: bool = False):
    """Plain PyTorch version. x [..., K] ([..., 2K] with swiglu) -> f32
    [..., N]: f32 products of the compute-dtype input and the decoded e4m3
    values (logical row order), f32 sum, then the per-channel scale."""
    h = prologue(x, norm_w, layer, eps, swiglu).float()
    acc = torch.matmul(h, fp8_decode(w.codes(layer))) * w.scale[layer]
    return resid_epilogue(acc, x, resid)


def _launch(what, x, w: FP8Weight, layer, norm_w, eps, resid, swiglu=False):
    """(f32 [..., N], whether the GEMM ran) for one CUDA call."""
    n_layers, k, n = w.qweight.shape
    if w.qweight.dtype != torch.uint8 or w.scale.shape != (n_layers, n):
        raise ValueError(f"{what}: qweight must be uint8 codes and scale "
                         f"[L, N], got {tuple(w.scale.shape)}")
    ib = w.interleave_block
    if gemm_route(x.numel() // x.shape[-1], x.dtype,
                  norm_w is not None or swiglu, resid is not None, k, ib):
        return launch_gemm(what, "fp8_gemm", "tllm_fp8_gemm",
                           _GEMM_SIGNATURES, x, w.qweight, w.scale, layer, k,
                           "fp8", ib, 0), True
    return launch_gemv(what, "fp8_matmul", "tllm_fp8_matmul_stacked",
                       _SIGNATURES, x, w.qweight, w.scale, layer, k, (ib,),
                       ib or 8, 8, norm_w, eps, resid, swiglu), False


def fp8_matmul_stacked(x, w: FP8Weight, layer: int, norm_w=None,
                       eps: float = 1e-6, resid=None, swiglu: bool = False):
    """y = [resid +] (norm(x) | silu(g) * u | x) @ dequant(w.qweight[layer]).

    x: [..., K] f32, bf16 or fp16 ([..., 2K] = [g | u] with swiglu); w:
    stacked FP8Weight, codes [L, K, N], scale [L, N]; norm_w: optional
    stacked [L, K] RMSNorm weight (prologue; not with swiglu); resid:
    optional [..., N] in x's dtype (epilogue). Returns f32 [..., N].

    On the card (gemm_route): bf16 / fp16 calls of at least GEMM_MIN_ROWS
    rows with no prologue and no residual run the GEMM; f32 calls, calls
    with a prologue or a residual, and layouts the GEMM does not tile run
    the GEMV at every row count (correct, and no path makes such a call
    above 16 rows)."""
    if _device_kind(x, "fp8_matmul_stacked") == "cpu":
        return fp8_matmul_stacked_plain(x, w, layer, norm_w, eps, resid,
                                        swiglu)
    out, gemm = _launch("fp8_matmul_stacked", x, w, layer, norm_w, eps,
                        resid, swiglu)
    fp8_matmul_stacked.launches += 1
    fp8_matmul_stacked.gemm_launches += int(gemm)
    fp8_matmul_stacked.swiglu_launches += int(swiglu)
    return out


fp8_matmul_stacked.launches = 0
fp8_matmul_stacked.gemm_launches = 0
fp8_matmul_stacked.swiglu_launches = 0


def fp8_matmul_plain(x, w: FP8Weight):
    """Plain version of the 2-D entry."""
    return fp8_matmul_stacked_plain(x, unit_layer(w), 0)


def fp8_matmul(x, w: FP8Weight):
    """2-D entry: x [..., K] @ dequant(w), codes [K, N], scale [N]; the
    stacked kernels on a unit layer axis (the GEMM or the GEMV as
    gemm_route decides), counted in its own `fp8_matmul.launches` and
    `.gemm_launches`. Returns f32 [..., N]."""
    if _device_kind(x, "fp8_matmul") == "cpu":
        return fp8_matmul_plain(x, w)
    out, gemm = _launch("fp8_matmul", x, unit_layer(w), 0, None, 1e-6, None)
    fp8_matmul.launches += 1
    fp8_matmul.gemm_launches += int(gemm)
    return out


fp8_matmul.launches = 0
fp8_matmul.gemm_launches = 0
