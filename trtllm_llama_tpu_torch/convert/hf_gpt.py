"""HF GPT-2 checkpoint -> the port's params (`models/gpt.py` layout; the
port's `convert/hf_gpt.py`).

HF GPT-2 keeps its projections in Conv1D modules whose weights are already
[in, out] (no transpose, unlike nn.Linear), and a fused c_attn [D, 3D]
that is split here into wq / wk / wv. The lm_head is tied: the
embedding's transpose. The stacks are built on the state dict's device.
"""

from __future__ import annotations

import torch

from ..config import ModelConfig
from .hf import _dtype


def config_from_hf_gpt2(hf_cfg, **over) -> ModelConfig:
    """As the JAX package's: the MLP is 4 x n_embd, every head its own KV
    head, the lm_head tied; the architecture tag stays the default, so a
    session takes `model=gpt` (or pass architecture="gpt2")."""
    d = dict(
        vocab_size=hf_cfg.vocab_size,
        hidden_size=hf_cfg.n_embd,
        intermediate_size=4 * hf_cfg.n_embd,
        num_layers=hf_cfg.n_layer,
        num_heads=hf_cfg.n_head,
        num_kv_heads=hf_cfg.n_head,
        head_dim=hf_cfg.n_embd // hf_cfg.n_head,
        max_position_embeddings=hf_cfg.n_positions,
        tie_word_embeddings=True,
    )
    d.update(over)
    return ModelConfig(**d)


def params_from_hf_gpt2(hf_model, cfg: ModelConfig, dtype=None):
    """The port's GPT params of a transformers GPT2LMHeadModel (or GPT2Model
    under `transformer.`), in `dtype` (default cfg.dtype)."""
    dtype = _dtype(dtype, cfg)
    sd = hf_model.state_dict()
    n_l = cfg.num_layers
    # Conv1D keeps [in, out]; a model whose projections are nn.Linear
    # ([out, in]) is transposed to the same layout
    linear = isinstance(hf_model.transformer.h[0].attn.c_attn,
                        torch.nn.Linear)

    def stack(fmt):
        ts = [sd[fmt.format(i)] for i in range(n_l)]
        if linear and ts[0].dim() == 2:
            ts = [t.t() for t in ts]
        return torch.stack(ts)

    c_attn_w = stack("transformer.h.{}.attn.c_attn.weight")    # [L, D, 3D]
    c_attn_b = stack("transformer.h.{}.attn.c_attn.bias")      # [L, 3D]
    wq, wk, wv = c_attn_w.chunk(3, dim=-1)
    bq, bk, bv = c_attn_b.chunk(3, dim=-1)
    layers = {
        "ln1_w": stack("transformer.h.{}.ln_1.weight"),
        "ln1_b": stack("transformer.h.{}.ln_1.bias"),
        "wq": wq, "bq": bq, "wk": wk, "bk": bk, "wv": wv, "bv": bv,
        "wo": stack("transformer.h.{}.attn.c_proj.weight"),
        "bo": stack("transformer.h.{}.attn.c_proj.bias"),
        "ln2_w": stack("transformer.h.{}.ln_2.weight"),
        "ln2_b": stack("transformer.h.{}.ln_2.bias"),
        "w_fc": stack("transformer.h.{}.mlp.c_fc.weight"),
        "b_fc": stack("transformer.h.{}.mlp.c_fc.bias"),
        "w_proj": stack("transformer.h.{}.mlp.c_proj.weight"),
        "b_proj": stack("transformer.h.{}.mlp.c_proj.bias"),
    }
    embed = sd["transformer.wte.weight"]
    return {
        "embed": embed.to(dtype),
        "pos_embed": sd["transformer.wpe.weight"].to(dtype),
        "layers": {k: v.to(dtype).contiguous() for k, v in layers.items()},
        "final_ln_w": sd["transformer.ln_f.weight"].to(dtype),
        "final_ln_b": sd["transformer.ln_f.bias"].to(dtype),
        "lm_head": embed.t().to(dtype).contiguous(),
    }
