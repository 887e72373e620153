"""RMSNorm, LayerNorm and the fused int8-quantizing RMSNorm (the port's
`ops/norm.py`)."""

from __future__ import annotations

import torch

from ..quantization.tensors import quantize_per_token
from .kernels import rmsnorm_quant as _rnq


def rms_norm(x, weight, eps: float = 1e-6):
    """RMSNorm with f32 moments, the weight applied in f32, cast back to
    x's dtype (the JAX package's operation order)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    """LayerNorm (the GPT-style families) with f32 mean and variance, the
    weight and bias applied in f32, cast back to x's dtype (the JAX
    package's operation order; it has no kernel for it, nor does the
    port)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def rms_norm_quant(x, weight, eps: float = 1e-6, smoother=None):
    """RMSNorm fused with dynamic per-token int8 quantization: returns
    (x_q int8 [..., K], scale f32 [..., 1]) for the W8A8 projections that
    follow. Without `smoother` it is row 7 (`rmsnorm_quant`, which takes
    its plain version for CPU tensors). `smoother` [K] is SmoothQuant's
    per-channel activation divisor, applied to the f32 normed row before
    its absmax, as the JAX package does on XLA for that case
    (`ops/norm.py:47-56` there: no kernel has it); the converter
    usually folds it into the norm weight instead."""
    if smoother is None:
        return _rnq.rmsnorm_quant(x, weight, eps)
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * weight.float() / smoother.float()
    return quantize_per_token(y)
