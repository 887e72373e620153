"""Activation-range calibration on a HF torch model (the port's copy of the
JAX package's `quantization/calibrate.py`).

`capture_activation_ranges` runs calibration forwards with forward hooks
on every projection of a `LlamaForCausalLM` and records, per layer, the
per-channel max |input|, the max |output|, the per-channel max |weight|
(over the output dim) and the K/V bound of the int8 KV cache: max |k_out|
widened by sqrt(2) (the cache holds K after RoPE, where a rotated pair can
reach sqrt(2) times the amax seen here) and max |v_out|. q/k/v read one
tensor, so they share their input range. It takes the model and tokenizer
it is given and imports nothing of transformers. The results are numpy
dicts keyed by the engine's layer weight names, stacked over layers, as
the JAX package's are; `kv_scales_from_ranges` and
`act_ranges_for_smoothquant` turn them into the converter's scales.
"""

from __future__ import annotations

from typing import Dict, Iterable

import numpy as np
import torch

# engine key -> HF module path inside a LlamaDecoderLayer
PROJ_MAP = {
    "wq": "self_attn.q_proj",
    "wk": "self_attn.k_proj",
    "wv": "self_attn.v_proj",
    "wo": "self_attn.o_proj",
    "w_gate": "mlp.gate_proj",
    "w_up": "mlp.up_proj",
    "w_down": "mlp.down_proj",
}
_SQRT2 = 1.41421356


def _get_submodule(layer, path):
    mod = layer
    for p in path.split("."):
        mod = getattr(mod, p)
    return mod


def weight_absmax(sd, num_layers: int) -> Dict[str, np.ndarray]:
    """{key: [L, K]} per-input-channel max |weight| over the output dim of
    each projection of an HF state dict ([out, in] weights)."""
    return {key: np.stack([
        sd[f"model.layers.{i}.{path}.weight"].detach().abs().amax(dim=0)
        .float().cpu().numpy() for i in range(num_layers)])
        for key, path in PROJ_MAP.items()}


def capture_activation_ranges(hf_model, tokenizer, texts: Iterable[str],
                              max_seq_len: int = 512,
                              num_samples: int | None = None) -> Dict:
    """Run calibration forwards with hooks; returns
    {'x_absmax': {key: [L, K]}, 'y_absmax': {key: [L]},
     'w_absmax': {key: [L, K]}, 'kv_absmax': [L]}. Raises if no text ran."""
    layers = hf_model.model.layers
    n_layers = len(layers)
    x_absmax = {k: [np.zeros(0)] * n_layers for k in PROJ_MAP}
    y_absmax = {k: np.zeros(n_layers) for k in PROJ_MAP}
    kv_absmax = np.zeros(n_layers)

    def make_hook(key, li):
        def hook(mod, inputs, output):
            x = inputs[0].detach()
            xa = x.abs().reshape(-1, x.shape[-1]).max(dim=0).values
            xa = xa.float().cpu().numpy()
            if x_absmax[key][li].size == 0:
                x_absmax[key][li] = xa
            else:
                x_absmax[key][li] = np.maximum(x_absmax[key][li], xa)
            ya = float(output.detach().abs().max())
            y_absmax[key][li] = max(y_absmax[key][li], ya)
            if key in ("wk", "wv"):
                if key == "wk":
                    ya *= _SQRT2
                kv_absmax[li] = max(kv_absmax[li], ya)
        return hook

    hooks = [_get_submodule(layer, path).register_forward_hook(
        make_hook(key, li))
        for li, layer in enumerate(layers) for key, path in PROJ_MAP.items()]
    try:
        hf_model.eval()
        device = next(hf_model.parameters()).device
        n_run = 0
        with torch.no_grad():
            for i, text in enumerate(texts):
                if num_samples is not None and i >= num_samples:
                    break
                ids = tokenizer(text, return_tensors="pt", truncation=True,
                                max_length=max_seq_len)
                hf_model(ids["input_ids"].to(device))
                n_run += 1
    finally:
        for h in hooks:
            h.remove()
    if n_run == 0:
        raise ValueError(
            "calibration corpus is empty — no forwards ran; scales would "
            "be garbage (check --calib_file contents)")
    return {
        "x_absmax": {k: np.stack(v) for k, v in x_absmax.items()},
        "y_absmax": y_absmax,
        "w_absmax": weight_absmax(hf_model.state_dict(), n_layers),
        "kv_absmax": kv_absmax,
    }


def kv_scales_from_ranges(ranges, qmax: float = 127.0) -> np.ndarray:
    """Per-layer quantized-KV-cache scales: amax / qmax (127 for int8 KV,
    448 for fp8)."""
    return (np.maximum(ranges["kv_absmax"], 1e-8) / qmax).astype(np.float32)


def act_ranges_for_smoothquant(ranges) -> Dict[str, np.ndarray]:
    """Per-projection per-layer max |x| ([L] f32 arrays keyed like the
    engine's layer weights): the SQWeight static activation scales."""
    return {k: v.max(axis=-1).astype(np.float32)
            for k, v in ranges["x_absmax"].items()}
