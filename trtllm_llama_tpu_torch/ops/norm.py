"""RMSNorm (the port's `ops/norm.py`)."""

from __future__ import annotations

import torch


def rms_norm(x, weight, eps: float = 1e-6):
    """RMSNorm with f32 moments, the weight applied in f32, cast back to
    x's dtype (the JAX package's operation order)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)
