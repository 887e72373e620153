"""RMSNorm, LayerNorm and the fused int8-quantizing RMSNorm (the port's
`ops/norm.py`)."""

from __future__ import annotations

import torch

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


def rms_norm_quant(x, weight, eps: float = 1e-6):
    """RMSNorm fused with dynamic per-token int8 quantization (kernel 4,
    which takes its plain version for CPU tensors): returns (x_q int8
    [..., K], scale f32 [..., 1]) for the W8A8 projections that follow.
    It only forwards to the kernel wrapper; it stays so that the model
    calls norms by the JAX package's names. The JAX package's optional
    SmoothQuant `smoother` divisor is not ported (the converter folds it
    into the norm weight)."""
    return _rnq.rmsnorm_quant(x, weight, eps)
