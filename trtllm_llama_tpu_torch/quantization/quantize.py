"""Model-level quantization (the port's `quantization/quantize.py`).

`init_random_quantized_params` draws the projection weights directly as
quantized codes on the target device (int8 or int4 weight-only, fp8, or
SmoothQuant int8), so a 7B model initialises on one card without ever
holding its floating-point weights; with no weight quantization (the mode
0 or an int8 / fp8 KV cache alone) it draws them in the compute dtype. `quantize_params` rewrites the float
projections (and, on request, the lm_head) of a parameter dict into
quantized containers, as the JAX package's function does; containers that
are already quantized are left as they are.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from .mode import QuantMode
from .tensors import (FP8_INTERLEAVE_BLOCK, FP8Weight, SQWeight, WOQWeight,
                      default_pack_block, quantize_fp8_weight,
                      quantize_smoothquant_weight, quantize_weight_only)

PROJECTIONS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _quantizes_weights(quant_mode: QuantMode) -> bool:
    return (quant_mode.has_fp8_qdq() or quant_mode.is_weight_only()
            or quant_mode.has_act_and_weight_quant())


def random_fp8_codes(shape, generator, device):
    """Uniform e4m3 codes inside the encodable set, as the JAX init draws
    them: the NaN codes move to their finite neighbour, subnormal codes
    (e == 0, m > 0) to exponent 1; +-0 stays."""
    codes = torch.randint(0, 256, shape, generator=generator, device=device,
                          dtype=torch.uint8)
    codes = torch.where((codes & 0x7F) == 0x7F, codes - 1, codes)
    sub = ((codes & 0x78) == 0) & ((codes & 7) != 0)
    return torch.where(sub, codes | 8, codes)


def init_random_quantized_params(cfg, seed: int = 0,
                                 quant_mode: QuantMode = None,
                                 device="cuda", group_size: int = None):
    """Random LLaMA params on `device`, drawn from a torch.Generator seeded
    with `seed` on that device. Projections as the JAX package's function
    lays them out: normal * fan_in**-0.5 in `cfg.dtype` when the mode
    quantizes no weights (0, or a KV-cache flag alone: the KV flags leave
    the weights as they are); fp8 (`FP8Weight`, uniform encodable codes, scale
    fan_in**-0.5 / 448, rows declared interleaved by 128 when K allows);
    weight-only int8 or int4 (`WOQWeight`, uniform int8 bytes, which for
    int4 are two packed nibbles; scale fan_in**-0.5 / 127 per channel, or
    per group of `group_size` K rows, default `cfg.group_size`, under
    PER_GROUP); or SmoothQuant (`SQWeight`, per-channel or per-tensor, static
    act scale 0.02, unit output scale). `cfg.dtype` embedding and lm_head
    (normal * fan_in**-0.5), unit norms. The random streams differ from
    JAX's."""
    quant_mode = quant_mode if quant_mode is not None else cfg.quant_mode
    group_size = cfg.group_size if group_size is None else group_size
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

    def rand_int8(shape):
        return torch.randint(-127, 128, shape, generator=generator,
                             device=device, dtype=torch.int8)

    def make_weight(shape):
        fan_in, n = shape[-2], shape[-1]
        if not _quantizes_weights(quant_mode):
            return normal(shape, fan_in)
        if quant_mode.has_fp8_qdq():
            ib = FP8_INTERLEAVE_BLOCK if fan_in % FP8_INTERLEAVE_BLOCK == 0 else 0
            return FP8Weight(random_fp8_codes(shape, generator, device),
                             torch.full(shape[:-2] + (n,),
                                        (fan_in ** -0.5) / 448.0,
                                        device=device), ib)
        w_scale = (fan_in ** -0.5) / 127.0
        if quant_mode.is_weight_only():
            w_bits = 4 if quant_mode.has_int4_weights() else 8
            gs = group_size if quant_mode.has_per_group_scaling() else 0
            qshape = shape[:-2] + (fan_in // 2 if w_bits == 4 else fan_in, n)
            sshape = shape[:-2] + ((fan_in // gs, n) if gs else (n,))
            pb = default_pack_block(fan_in, gs) if w_bits == 4 else 0
            return WOQWeight(rand_int8(qshape),
                             torch.full(sshape, w_scale, device=device),
                             w_bits, gs, pb)
        per_channel = quant_mode.has_per_channel_scaling()
        sshape = shape[:-2] + ((n,) if per_channel else (1,))
        return SQWeight(
            rand_int8(shape), torch.full(sshape, w_scale, device=device),
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


def _matmul_keys(layers):
    """Names of the stacked float projections of any family's layout (the
    llama w_gate / w_up / w_down, the decoder families' w_fc / w_proj):
    every [L, in, out] tensor named w*; biases, norms and already-quantized
    containers are skipped."""
    return [k for k, v in layers.items() if k.startswith("w")
            and isinstance(v, torch.Tensor) and v.dim() == 3]


def quantize_params(params, quant_mode: QuantMode, group_size: int = 0,
                    act_ranges=None, quantize_lm_head: bool = False):
    """New params with every stacked float projection replaced by its
    quantized container: `SQWeight` (SmoothQuant; act_ranges: {name:
    calibrated max |activation| feeding it, [L] or a scalar}), `FP8Weight`
    (FP8_QDQ), or `WOQWeight` (weight-only int8 / int4, grouped by
    `group_size` under PER_GROUP). quantize_lm_head: also quantize a float
    lm_head per channel in the model's weight format (int8 for SmoothQuant).
    Embedding and norms stay float; a mode without weight quantization
    (e.g. KV cache only) returns params unchanged."""
    if not _quantizes_weights(quant_mode):
        return params
    layers = dict(params["layers"])
    names = _matmul_keys(params["layers"])
    if quant_mode.has_act_and_weight_quant():
        if act_ranges is None:
            raise ValueError("SmoothQuant needs calibrated act_ranges")
        for name in names:
            layers[name] = quantize_smoothquant_weight(
                params["layers"][name], act_ranges[name],
                per_channel=quant_mode.has_per_channel_scaling(),
                per_token=quant_mode.has_per_token_dynamic_scaling())
    elif quant_mode.has_fp8_qdq():
        for name in names:
            layers[name] = quantize_fp8_weight(params["layers"][name])
    else:
        w_bits = 4 if quant_mode.has_int4_weights() else 8
        gs = group_size if quant_mode.has_per_group_scaling() else 0
        for name in names:
            layers[name] = quantize_weight_only(params["layers"][name],
                                                w_bits, gs)
    out = {**params, "layers": layers}
    head = params.get("lm_head")
    if quantize_lm_head and isinstance(head, torch.Tensor):
        if quant_mode.has_fp8_qdq():
            out["lm_head"] = quantize_fp8_weight(head)
        else:
            w_bits = 4 if quant_mode.has_int4_weights() else 8
            out["lm_head"] = quantize_weight_only(head, w_bits, 0)
    return out
