"""Random parameters born quantized (the port's `quantization/quantize.py`).

`init_random_quantized_params` draws the projection weights directly as
int8 on the target device, so a 7B int8 model initialises on one card
without ever holding its floating-point weights.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from .mode import QuantMode
from .tensors import WOQWeight

PROJECTIONS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def init_random_quantized_params(cfg, seed: int = 0,
                                 quant_mode: QuantMode = None,
                                 device="cuda"):
    """Random LLaMA params on `device`, drawn from a torch.Generator seeded
    with `seed` on that device: int8 per-channel weight-only projections
    (q uniform in [-127, 127], scale fan_in**-0.5 / 127), `cfg.dtype`
    embedding and lm_head (normal * fan_in**-0.5), unit norms. Same layout
    and scales as the JAX package's function (the random streams differ).
    Other quant modes are not ported yet."""
    quant_mode = quant_mode if quant_mode is not None else cfg.quant_mode
    if (not quant_mode.is_weight_only() or quant_mode.has_int4_weights()
            or quant_mode.has_per_group_scaling()):
        raise NotImplementedError(
            f"quant mode {quant_mode!r}: only int8 per-channel weight-only "
            "is ported")
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
        scale = torch.full(shape[:-2] + shape[-1:], (fan_in ** -0.5) / 127.0,
                           device=device, dtype=torch.float32)
        return WOQWeight(q, scale)

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
