"""Kernel 6: FP8 (e4m3) weight matmul (csrc/fp8_matmul.cu, body in
csrc/woq_gemv.cuh).

Replaces `trtllm_llama_tpu/ops/pallas/woq_matmul.py::fp8_matmul_stacked`
(the fp8 branch of `_kernel_int8`: e4m3 codes in rows interleaved by
`interleave_fp8_rows`, per-channel scale after the sum, the norm and
SwiGLU prologues, the residual epilogue) and its 2-D form `fp8_matmul`. Bound on the H100: the
weight bytes (one per weight), read once; the kernel is kernel 1's with
Hopper's exact e4m3x2 -> f16x2 convert as the decode and x staged in the
interleaved row order.

`fp8_matmul_stacked` and `fp8_matmul` take the plain version for CPU
tensors and launch the kernel for CUDA tensors; each counts its launches
in `.launches` (`fp8_matmul_stacked.swiglu_launches` counts those of them
with the SwiGLU prologue).
"""

from __future__ import annotations

import ctypes

import torch

from ...quantization.tensors import FP8Weight
from ..fp8 import fp8_decode
from .woq_matmul import (_device_kind, launch_gemv, prologue, resid_epilogue,
                         unit_layer)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"tllm_fp8_matmul_stacked":
               [_P] * 7 + [_I] * 8 + [_F, _I, _I, _P]}


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
    n_layers, k, n = w.qweight.shape
    if w.qweight.dtype != torch.uint8 or w.scale.shape != (n_layers, n):
        raise ValueError(f"{what}: qweight must be uint8 codes and scale "
                         f"[L, N], got {tuple(w.scale.shape)}")
    ib = w.interleave_block
    return launch_gemv(what, "fp8_matmul", "tllm_fp8_matmul_stacked",
                       _SIGNATURES, x, w.qweight, w.scale, layer, k, (ib,),
                       ib or 8, 8, norm_w, eps, resid, swiglu)


def fp8_matmul_stacked(x, w: FP8Weight, layer: int, norm_w=None,
                       eps: float = 1e-6, resid=None, swiglu: bool = False):
    """y = [resid +] (norm(x) | silu(g) * u | x) @ dequant(w.qweight[layer]).

    x: [..., K] f32, bf16 or fp16 ([..., 2K] = [g | u] with swiglu); w:
    stacked FP8Weight, codes [L, K, N], scale [L, N]; norm_w: optional
    stacked [L, K] RMSNorm weight (prologue; not with swiglu); resid:
    optional [..., N] in x's dtype (epilogue). Returns f32 [..., N]."""
    if _device_kind(x, "fp8_matmul_stacked") == "cpu":
        return fp8_matmul_stacked_plain(x, w, layer, norm_w, eps, resid,
                                        swiglu)
    out = _launch("fp8_matmul_stacked", x, w, layer, norm_w, eps, resid,
                  swiglu)
    fp8_matmul_stacked.launches += 1
    fp8_matmul_stacked.swiglu_launches += int(swiglu)
    return out


fp8_matmul_stacked.launches = 0
fp8_matmul_stacked.swiglu_launches = 0


def fp8_matmul_plain(x, w: FP8Weight):
    """Plain version of the 2-D entry."""
    return fp8_matmul_stacked_plain(x, unit_layer(w), 0)


def fp8_matmul(x, w: FP8Weight):
    """2-D entry: x [..., K] @ dequant(w), codes [K, N], scale [N]; the
    stacked kernel on a unit layer axis, counted in its own
    `fp8_matmul.launches`. Returns f32 [..., N]."""
    if _device_kind(x, "fp8_matmul") == "cpu":
        return fp8_matmul_plain(x, w)
    out = _launch("fp8_matmul", x, unit_layer(w), 0, None, 1e-6, None)
    fp8_matmul.launches += 1
    return out


fp8_matmul.launches = 0
