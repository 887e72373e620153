"""SmoothQuant alpha migration on a HF state dict (the port's copy of the
JAX package's `quantization/smoothquant.py`).

Per input channel j, s_j = x_max_j^alpha / w_max_j^(1 - alpha): weight
column j is multiplied by s_j and the operation producing the input divides
by s_j, so the product is unchanged while activation outliers shrink before
quantization. q/k/v read the input_layernorm output (one shared s, folded
into that norm's weight); gate/up read the post_attention_layernorm output
(likewise); wo and w_down stay unsmoothed, as in the reference.

The JAX copy converts the whole state dict to f32 numpy on the host; this
one computes the same values on torch tensors on their own device: the
smoothed weights and norms become f32 tensors there and every other entry
stays as given, so a 7B checkpoint on the card never visits the host.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def smooth_scale(x_absmax, w_absmax, alpha: float = 0.5, eps: float = 1e-8,
                 device="cpu"):
    """Per-input-channel migration scale s = x^a / w^(1-a) (float64, then
    f32), clipped to [1e-5, 1e5] (channels that never fired)."""
    x = torch.as_tensor(np.asarray(x_absmax, np.float64), device=device)
    w = torch.as_tensor(np.asarray(w_absmax, np.float64), device=device)
    s = x.clamp_min(eps) ** alpha / w.clamp_min(eps) ** (1.0 - alpha)
    return s.clamp(1e-5, 1e5).float()


def smooth_hf_state_dict(sd: Dict, ranges: Dict, num_layers: int,
                         alpha: float = 0.5) -> "tuple[Dict, Dict]":
    """Migrate {name: tensor} (HF layout) with the calibrated ranges.
    Returns (a new state dict, the x_absmax ranges divided by s): the
    q/k/v and gate/up weights ([out, in], column j times s_j) and the two
    norms (divided by s) as f32 tensors on their device, every other
    entry the caller's tensor. The caller's dict is not changed."""
    sd = dict(sd)
    x_absmax = {k: np.array(v, copy=True) for k, v in ranges["x_absmax"].items()}
    w_absmax = ranges["w_absmax"]
    groups = ((("wq", "wk", "wv"), "input_layernorm",
               ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj")),
              (("w_gate", "w_up"), "post_attention_layernorm",
               ("mlp.gate_proj", "mlp.up_proj")))
    for li in range(num_layers):
        pfx = f"model.layers.{li}."
        for keys, norm, projs in groups:
            x_m = np.maximum.reduce([x_absmax[k][li] for k in keys])
            w_m = np.maximum.reduce([np.asarray(w_absmax[k][li])
                                     for k in keys])
            norm_key = pfx + norm + ".weight"
            s = smooth_scale(x_m, w_m, alpha, device=sd[norm_key].device)
            for proj in projs:
                key = pfx + proj + ".weight"
                sd[key] = sd[key].float() * s[None, :]
            sd[norm_key] = sd[norm_key].float() / s
            s_np = s.cpu().numpy()
            for k in keys:
                x_absmax[k][li] = x_absmax[k][li] / s_np
    return sd, x_absmax
