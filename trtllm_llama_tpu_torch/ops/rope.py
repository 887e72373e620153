"""Rotary position embeddings (the port's `ops/rope.py`): the HF LLaMA
"rotate_half" convention (also GPT-NeoX's and Falcon's, on the first
`rotary_dim` dims), and GPT-J's interleaved "rotate every two" one."""

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


def rope_table_interleaved(max_len: int, rotary_dim: int,
                           theta: float = 10000.0, dtype=torch.float32,
                           device="cpu"):
    """GPT-J convention: each frequency repeated twice (interleaved pairs).
    Returns (cos, sin), each [max_len, rotary_dim]."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, rotary_dim, 2,
                                             dtype=torch.float32,
                                             device=device) / rotary_dim))
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)                        # [S, d/2]
    return (freqs.cos().repeat_interleave(2, dim=-1).to(dtype),
            freqs.sin().repeat_interleave(2, dim=-1).to(dtype))


def apply_rope_interleaved(x, cos, sin, rotary_dim: int = 0):
    """Rotate every two on the first `rotary_dim` dims (0: all of them).
    x: [..., H, d]; cos/sin broadcastable [..., 1, rotary_dim]. The product
    is taken in the promoted dtype and cast back to x's dtype."""
    d = x.shape[-1]
    rot_d = rotary_dim or d
    xr = x[..., :rot_d]
    rotated = torch.stack([-xr[..., 1::2], xr[..., ::2]], dim=-1
                          ).reshape(xr.shape)
    out = (xr * cos + rotated * sin).to(x.dtype)
    return out if rot_d == d else torch.cat([out, x[..., rot_d:]], dim=-1)


def take_rope(cos, sin, positions):
    """Gather per-position cos/sin: positions [..., S] -> [..., S, 1, d]. A
    position past the table reads its last row (the serving engine parks
    inactive rows at max_seq_len, which may equal the table's length)."""
    positions = positions.clamp(max=cos.shape[0] - 1)
    return cos[positions][..., None, :], sin[positions][..., None, :]
