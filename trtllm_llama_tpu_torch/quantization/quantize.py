"""Model-level quantization (the port's `quantization/quantize.py`).

`init_random_quantized_params` draws the projection weights directly as
int8 on the target device, so a 7B int8 model initialises on one card
without ever holding its floating-point weights. `quantize_params`
rewrites a float parameter dict into SmoothQuant containers, as the JAX
package's function does (its weight-only branch is not ported: the
weight-only path is born quantized or carried across by the bridge).
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from .mode import QuantMode
from .tensors import SQWeight, WOQWeight, quantize_smoothquant_weight

PROJECTIONS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _check_ported(quant_mode: QuantMode) -> None:
    int8_woq = (quant_mode.is_weight_only()
                and not quant_mode.has_int4_weights()
                and not quant_mode.has_per_group_scaling())
    if not (int8_woq or quant_mode.has_act_and_weight_quant()):
        raise NotImplementedError(
            f"quant mode {quant_mode!r}: only int8 per-channel weight-only "
            "and SmoothQuant W8A8 are ported")


def init_random_quantized_params(cfg, seed: int = 0,
                                 quant_mode: QuantMode = None,
                                 device="cuda"):
    """Random LLaMA params on `device`, drawn from a torch.Generator seeded
    with `seed` on that device: int8 projections (q uniform in
    [-127, 127]) with weight scales fan_in**-0.5 / 127 -- per-channel
    `WOQWeight`s, or `SQWeight`s (per-channel or per-tensor, static act
    scale 0.02, unit output scale) for SmoothQuant -- `cfg.dtype` embedding
    and lm_head (normal * fan_in**-0.5), unit norms. Same layout and scales
    as the JAX package's function (the random streams differ)."""
    quant_mode = quant_mode if quant_mode is not None else cfg.quant_mode
    _check_ported(quant_mode)
    device = resolve_device(device)
    generator = torch.Generator(device=device).manual_seed(seed)
    dtype = cfg.torch_dtype
    d, f, n_layers = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    nq, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    shapes = {
        "wq": (n_layers, d, nq * hd), "wk": (n_layers, d, nkv * hd),
        "wv": (n_layers, d, nkv * hd), "wo": (n_layers, nq * hd, d),
        "w_gate": (n_layers, d, f), "w_up": (n_layers, d, f),
        "w_down": (n_layers, f, d),
    }

    def normal(shape, fan_in):
        w = torch.randn(shape, generator=generator, device=device, dtype=dtype)
        return w * (fan_in ** -0.5)

    def make_weight(shape):
        fan_in = shape[-2]
        q = torch.randint(-127, 128, shape, generator=generator,
                          device=device, dtype=torch.int8)
        w_scale = (fan_in ** -0.5) / 127.0
        if quant_mode.is_weight_only():
            return WOQWeight(q, torch.full(shape[:-2] + shape[-1:], w_scale,
                                           device=device))
        per_channel = quant_mode.has_per_channel_scaling()
        sshape = shape[:-2] + ((shape[-1],) if per_channel else (1,))
        return SQWeight(
            q, torch.full(sshape, w_scale, device=device),
            torch.full(shape[:-2], 0.02, device=device),
            torch.ones(shape[:-2], device=device), per_channel=per_channel,
            per_token=quant_mode.has_per_token_dynamic_scaling())

    layers = {"attn_norm": torch.ones((n_layers, d), device=device, dtype=dtype),
              "mlp_norm": torch.ones((n_layers, d), device=device, dtype=dtype)}
    for name in PROJECTIONS:
        layers[name] = make_weight(shapes[name])
    return {
        "embed": normal((cfg.vocab_size, d), d),
        "layers": layers,
        "final_norm": torch.ones((d,), device=device, dtype=dtype),
        "lm_head": normal((d, cfg.vocab_size), d),
    }


def quantize_params(params, quant_mode: QuantMode, act_ranges=None):
    """New params with every stacked float projection ([L, in, out], named
    w*) replaced by its `SQWeight`; embedding, norms and lm_head stay
    float. act_ranges: {name: calibrated max |activation| feeding it, [L]
    or a scalar}. A mode without weight quantization (e.g. KV cache only)
    returns params unchanged."""
    if not (quant_mode.is_weight_only() or quant_mode.has_fp8_qdq()
            or quant_mode.has_act_and_weight_quant()):
        return params
    if not quant_mode.has_act_and_weight_quant():
        raise NotImplementedError(
            f"quantize_params: quant mode {quant_mode!r}: only SmoothQuant "
            "is ported")
    if act_ranges is None:
        raise ValueError("SmoothQuant needs calibrated act_ranges")
    layers = dict(params["layers"])
    for name, w in params["layers"].items():
        if name.startswith("w") and isinstance(w, torch.Tensor) and w.dim() == 3:
            layers[name] = quantize_smoothquant_weight(
                w, act_ranges[name],
                per_channel=quant_mode.has_per_channel_scaling(),
                per_token=quant_mode.has_per_token_dynamic_scaling())
    return {**params, "layers": layers}
