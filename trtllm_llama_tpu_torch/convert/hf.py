"""HF LLaMA checkpoint -> the port's params (the port's `convert/hf.py`).

Maps a transformers `LlamaForCausalLM` state dict (torch linear weights
[out, in]) onto the stacked parameter dict of `models/llama.py` (matmul-
ready [in, out], stacked over layers), as the JAX package's function does.
It works on torch tensors on their own device: each stacked projection is
allocated once in the target dtype and filled layer by layer, so a 7B
conversion holds no second copy of a stack. Quantization comes after, by
`quantization.quantize.quantize_params` (or `convert/convert.py`).
"""

from __future__ import annotations

import torch

from ..config import ModelConfig, str_dtype_to_torch

# engine layer key -> (HF key under model.layers.{i}., transposed)
_LAYER_KEYS = {
    "attn_norm": ("input_layernorm.weight", False),
    "wq": ("self_attn.q_proj.weight", True),
    "wk": ("self_attn.k_proj.weight", True),
    "wv": ("self_attn.v_proj.weight", True),
    "wo": ("self_attn.o_proj.weight", True),
    "mlp_norm": ("post_attention_layernorm.weight", False),
    "w_gate": ("mlp.gate_proj.weight", True),
    "w_up": ("mlp.up_proj.weight", True),
    "w_down": ("mlp.down_proj.weight", True),
}


def _dtype(dtype, cfg: ModelConfig) -> torch.dtype:
    if dtype is None:
        return cfg.torch_dtype
    return str_dtype_to_torch(dtype) if isinstance(dtype, str) else dtype


def params_from_hf_model(hf_model, cfg: ModelConfig, dtype=None):
    """The port's params of a loaded transformers LlamaForCausalLM."""
    return params_from_hf_state_dict(hf_model.state_dict(), cfg, dtype)


def params_from_hf_state_dict(sd, cfg: ModelConfig, dtype=None):
    """sd: {HF name: tensor}; dtype: a dtype or its name (default
    cfg.dtype). Tensors land on the device of the state dict's tensors.
    A tied or missing lm_head becomes the embedding's transpose."""
    dtype = _dtype(dtype, cfg)
    n_layers = cfg.num_layers

    def stack(key, transpose):
        ts = [sd[f"model.layers.{i}.{key}"] for i in range(n_layers)]
        first = ts[0].t() if transpose else ts[0]
        out = torch.empty((n_layers, *first.shape), dtype=dtype,
                          device=first.device)
        for i, t in enumerate(ts):
            out[i].copy_(t.t() if transpose else t)
        return out

    layers = {name: stack(key, transpose)
              for name, (key, transpose) in _LAYER_KEYS.items()}
    embed = sd["model.embed_tokens.weight"].to(dtype)
    if cfg.tie_word_embeddings or "lm_head.weight" not in sd:
        lm_head = embed.t().contiguous()
    else:
        lm_head = sd["lm_head.weight"].t().to(dtype).contiguous()
    return {"embed": embed, "layers": layers,
            "final_norm": sd["model.norm.weight"].to(dtype),
            "lm_head": lm_head}
