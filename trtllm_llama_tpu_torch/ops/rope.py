"""Rotary position embeddings, HF LLaMA "rotate_half" convention
(the port's `ops/rope.py`)."""

from __future__ import annotations

import torch


def rope_table(max_len: int, head_dim: int, theta: float = 10000.0,
               dtype=torch.float32, scaling_type: str = "",
               scaling_factor: float = 1.0, device="cpu"):
    """Returns (cos, sin), each [max_len, head_dim].

    'linear' scaling divides positions by `scaling_factor`; 'ntk' stretches
    the base: theta *= factor ** (d / (d - 2))."""
    if scaling_type == "ntk" and scaling_factor != 1.0:
        theta = theta * scaling_factor ** (head_dim / (head_dim - 2))
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                             device=device) / head_dim))
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    if scaling_type == "linear" and scaling_factor != 1.0:
        t = t / scaling_factor
    freqs = torch.outer(t, inv_freq)                        # [S, d/2]
    emb = torch.cat([freqs, freqs], dim=-1)                 # [S, d]
    return emb.cos().to(dtype), emb.sin().to(dtype)


def rope_tables_for(cfg, dtype=torch.float32, device="cpu"):
    """(cos, sin) tables sized and scaled per a ModelConfig."""
    return rope_table(cfg.max_position_embeddings, cfg.head_dim,
                      cfg.rope_theta, dtype,
                      scaling_type=cfg.rope_scaling_type,
                      scaling_factor=cfg.rope_scaling_factor, device=device)


def _rotate_half(x):
    d = x.shape[-1] // 2
    return torch.cat([-x[..., d:], x[..., :d]], dim=-1)


def apply_rope(x, cos, sin):
    """x: [..., S, H, d] or [..., H, d]; cos/sin broadcastable
    [..., S, 1, d]. The product is taken in the promoted dtype (f32 tables)
    and cast back to x's dtype."""
    return (x * cos + _rotate_half(x) * sin).to(x.dtype)


def take_rope(cos, sin, positions):
    """Gather per-position cos/sin: positions [..., S] -> [..., S, 1, d]."""
    return cos[positions][..., None, :], sin[positions][..., None, :]
