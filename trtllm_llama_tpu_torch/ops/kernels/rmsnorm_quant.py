"""Kernel 4: fused RMSNorm -> per-row dynamic int8 quantization
(csrc/rmsnorm_quant.cu).

Replaces `trtllm_llama_tpu/ops/pallas/rmsnorm_quant.py::rmsnorm_quant_kernel`.
Bound on the H100: 3 bytes per element, nanoseconds at decode shapes, so
the call is launch-bound; the design is one block per row with fixed-order
block reductions (see the source's header note).

`rmsnorm_quant` takes the plain version for CPU tensors and launches the
kernel for CUDA tensors; `rmsnorm_quant.launches` counts launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"tllm_rmsnorm_quant": [_P] * 4 + [_I] * 3 + [_F, _I, _P]}


def rmsnorm_quant_plain(x, weight, eps: float = 1e-6):
    """Plain PyTorch version: y = f32(x) * rsqrt(mean(x^2) + eps) * f32(w)
    (not rounded to x's dtype), scale = max(amax(y), 1e-8) / 127 per row,
    q = clamp(round(y / scale), +-127). Returns (q int8 [..., D],
    scale f32 [..., 1])."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * weight.float()
    scale = y.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / 127.0
    q = torch.round(y / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def rmsnorm_quant(x, weight, eps: float = 1e-6):
    """x: [..., D] f32, bf16 or fp16; weight: [D] in x's dtype. Returns
    (q int8 [..., D], scale f32 [..., 1]) with per-row dynamic scales."""
    if x.device.type == "cpu":
        return rmsnorm_quant_plain(x, weight, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm_quant: unsupported device {x.device}")
    d = x.shape[-1]
    if x.dtype not in _build.DTYPE_CODES or weight.dtype != x.dtype:
        raise TypeError(f"rmsnorm_quant: unsupported dtypes {x.dtype}/"
                        f"{weight.dtype} (x and weight share f32, bf16 or "
                        "fp16)")
    if (weight.shape != (d,) or weight.device != x.device
            or not x.is_contiguous() or not weight.is_contiguous()):
        raise ValueError(f"rmsnorm_quant: x {tuple(x.shape)} and weight "
                         f"{tuple(weight.shape)} must be contiguous, [..., D] "
                         "and [D], on one device")
    m = x.numel() // d
    q = torch.empty(x.shape, device=x.device, dtype=torch.int8)
    scale = torch.empty((*x.shape[:-1], 1), device=x.device,
                        dtype=torch.float32)
    lib = _build.load("rmsnorm_quant", _SIGNATURES)
    err = lib.tllm_rmsnorm_quant(
        _build.ptr(x), _build.ptr(weight), _build.ptr(q), _build.ptr(scale),
        _build.DTYPE_CODES[x.dtype], m, d, eps, x.device.index or 0,
        _build.stream_of(x))
    _build.check(err, "rmsnorm_quant")
    rmsnorm_quant.launches += 1
    return q, scale


rmsnorm_quant.launches = 0
