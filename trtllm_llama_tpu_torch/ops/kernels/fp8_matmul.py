"""Kernel 6: FP8 (e4m3) weight matmul: kernel 1's three bodies on e4m3
codes, picked by kernel 1's rules (`tc_route`, `gemm_route`).

Replaces `trtllm_llama_tpu/ops/pallas/woq_matmul.py::fp8_matmul_stacked`
(the fp8 branch of `_kernel_int8`: e4m3 codes in rows interleaved by
`interleave_fp8_rows`, per-channel scale after the sum, the norm and
SwiGLU prologues, the residual epilogue) and its 2-D form `fp8_matmul`.
Bound on the H100: the weight bytes (one per weight) at decode rows; the
operations above ~300 rows. The tensor-core GEMV (csrc/fp8_matmul.cu,
body in csrc/woq_gemv_tc.cuh) takes bf16 / fp16 calls of TC_MIN_ROWS..16
rows, decoding pairs of codes with Hopper's exact e4m3x2 -> f16x2 convert
into mma.sync's A operand, x staged in the interleaved row order; the
one-row GEMV (csrc/fp8_matmul.cu, body in csrc/woq_gemv.cuh, one launch)
one-row calls, f32 and the rest; the GEMM (csrc/fp8_gemm.cu, body in csrc/woq_gemm.cuh) decodes
the codes into shared memory in logical row order and runs wgmma on them.

`fp8_matmul_stacked` and `fp8_matmul` take the plain version for CPU
tensors and launch a kernel for CUDA tensors; each counts its launches
in `.launches`, the GEMM's share in `.gemm_launches`, the tensor-core
GEMV's in `.tc_launches` (`fp8_matmul_stacked.swiglu_launches` counts the
GEMV launches with the SwiGLU prologue). `fp8_matmul_stacked` takes kernel
1's `n_window` (only the output columns [start, start + length), from the
weight in place, planned as the full N; counted in `.window_launches`).
"""

from __future__ import annotations

import ctypes

import torch

from ...quantization.tensors import FP8Weight
from ..fp8 import fp8_decode
from .woq_matmul import (_device_kind, check_window, gemm_route, launch_gemm,
                         launch_gemv, launch_tc, prologue, resid_epilogue,
                         tc_route, unit_layer, window_cols)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"tllm_fp8_matmul_stacked":
               [_P] * 8 + [_I] * 10 + [_F, _I, _I, _P],
               "tllm_fp8_gemv_tc": [_P] * 7 + [_I] * 10 + [_F, _I, _I, _P]}
_GEMM_SIGNATURES = {"tllm_fp8_gemm": [_P] * 6 + [_I] * 8 + [_P]}


def fp8_matmul_stacked_plain(x, w: FP8Weight, layer: int, norm_w=None,
                             eps: float = 1e-6, resid=None,
                             swiglu: bool = False, n_window=None):
    """Plain PyTorch version. x [..., K] ([..., 2K] with swiglu) -> f32
    [..., N] ([..., length] with n_window): f32 products of the
    compute-dtype input and the decoded e4m3 values (logical row order),
    f32 sum, then the per-channel scale."""
    window = check_window("fp8_matmul_stacked", n_window, w.qweight.shape[-1],
                          norm_w is not None or swiglu, resid is not None)
    h = prologue(x, norm_w, layer, eps, swiglu).float()
    acc = torch.matmul(h, fp8_decode(w.codes(layer))) * w.scale[layer]
    return resid_epilogue(window_cols(acc, window), x, resid)


def _launch(what, x, w: FP8Weight, layer, norm_w, eps, resid, swiglu=False,
            window=None):
    """(f32 [..., N], the route: "gemm", "tc" or "gemv") for one CUDA
    call."""
    n_layers, k, n = w.qweight.shape
    if w.qweight.dtype != torch.uint8 or w.scale.shape != (n_layers, n):
        raise ValueError(f"{what}: qweight must be uint8 codes and scale "
                         f"[L, N], got {tuple(w.scale.shape)}")
    ib = w.interleave_block
    if gemm_route(x.numel() // x.shape[-1], x.dtype,
                  norm_w is not None or swiglu, resid is not None, k, ib):
        return launch_gemm(what, "fp8_gemm", "tllm_fp8_gemm",
                           _GEMM_SIGNATURES, x, w.qweight, w.scale, layer, k,
                           "fp8", ib, 0, window=window), "gemm"
    if tc_route(x.numel() // x.shape[-1], x.dtype, k, ib):
        return launch_tc(what, "fp8_matmul", "tllm_fp8_gemv_tc", _SIGNATURES,
                         x, w.qweight, w.scale, layer, k, (ib,), 8, ib, 0,
                         norm_w, eps, resid, swiglu, window), "tc"
    return launch_gemv(what, "fp8_matmul", "tllm_fp8_matmul_stacked",
                       _SIGNATURES, x, w.qweight, w.scale, layer, k, (ib,),
                       ib or 8, norm_w=norm_w, eps=eps, resid=resid,
                       swiglu=swiglu, window=window), "gemv"


def fp8_matmul_stacked(x, w: FP8Weight, layer: int, norm_w=None,
                       eps: float = 1e-6, resid=None, swiglu: bool = False,
                       n_window=None):
    """y = [resid +] (norm(x) | silu(g) * u | x) @ dequant(w.qweight[layer]).

    x: [..., K] f32, bf16 or fp16 ([..., 2K] = [g | u] with swiglu); w:
    stacked FP8Weight, codes [L, K, N], scale [L, N]; norm_w: optional
    stacked [L, K] RMSNorm weight (prologue; not with swiglu); resid:
    optional [..., N] in x's dtype (epilogue); n_window: (start, length),
    only the output columns [start, start + length) (not with a prologue or
    resid). Returns f32 [..., N] ([..., length] with n_window).

    On the card, kernel 1's routes: the GEMM for bf16 / fp16 calls of at
    least GEMM_MIN_ROWS rows with no prologue and no residual, the
    tensor-core GEMV for bf16 / fp16 calls of TC_MIN_ROWS..16 rows, the
    one-row GEMV for one row, f32 and the layouts neither tiles."""
    if _device_kind(x, "fp8_matmul_stacked") == "cpu":
        return fp8_matmul_stacked_plain(x, w, layer, norm_w, eps, resid,
                                        swiglu, n_window)
    window = check_window("fp8_matmul_stacked", n_window, w.qweight.shape[-1],
                          norm_w is not None or swiglu, resid is not None)
    out, route = _launch("fp8_matmul_stacked", x, w, layer, norm_w, eps,
                         resid, swiglu, window)
    fp8_matmul_stacked.launches += 1
    fp8_matmul_stacked.gemm_launches += int(route == "gemm")
    fp8_matmul_stacked.tc_launches += int(route == "tc")
    fp8_matmul_stacked.swiglu_launches += int(swiglu)
    fp8_matmul_stacked.window_launches += int(window is not None)
    return out


fp8_matmul_stacked.launches = 0
fp8_matmul_stacked.gemm_launches = 0
fp8_matmul_stacked.tc_launches = 0
fp8_matmul_stacked.swiglu_launches = 0
fp8_matmul_stacked.window_launches = 0


def fp8_matmul_plain(x, w: FP8Weight):
    """Plain version of the 2-D entry."""
    return fp8_matmul_stacked_plain(x, unit_layer(w), 0)


def fp8_matmul(x, w: FP8Weight):
    """2-D entry: x [..., K] @ dequant(w), codes [K, N], scale [N]; the
    stacked kernels on a unit layer axis (routed as fp8_matmul_stacked),
    counted in its own `fp8_matmul.launches`, `.gemm_launches` and
    `.tc_launches`. Returns f32 [..., N]."""
    if _device_kind(x, "fp8_matmul") == "cpu":
        return fp8_matmul_plain(x, w)
    out, route = _launch("fp8_matmul", x, unit_layer(w), 0, None, 1e-6,
                         None)
    fp8_matmul.launches += 1
    fp8_matmul.gemm_launches += int(route == "gemm")
    fp8_matmul.tc_launches += int(route == "tc")
    return out


fp8_matmul.launches = 0
fp8_matmul.gemm_launches = 0
fp8_matmul.tc_launches = 0
