"""ChatGLM-6B state dict -> the port's params (`models/chatglm.py` layout;
the port's `convert/hf_chatglm.py`).

transformers has no ChatGLM class (THUDM/chatglm-6b is trust_remote_code),
so, as the JAX package's, this converter reads the raw state dict with
THUDM's key names (the layout the reference's example reads through its
vendored modeling_chatglm.py): `transformer.layers.N.attention.
query_key_value` is head-interleaved [head, (q, k, v), head_dim] on the
output axis and is split here into the stacked wq / wk / wv
(`hf_families._split_fused_qkv`); every nn.Linear weight [out, in] is
transposed to [in, out]. The stacks are built on the state dict's
device.
"""

from __future__ import annotations

from ..config import ModelConfig
from .hf import _dtype
from .hf_families import _as, _split_fused_qkv, _stack


def config_from_chatglm(num_layers=28, hidden_size=4096, num_heads=32,
                        vocab_size=130528, max_positions=2048,
                        layernorm_eps=1e-5, **over) -> ModelConfig:
    """ChatGLM-6B's fields by default (THUDM/chatglm-6b's config.json): 28
    layers, 4096 wide, 32 heads of 128, an FFN of 4 x 4096, 130528 tokens,
    2048 positions, LayerNorm eps 1e-5. As the JAX package's, the
    architecture tag stays the default: pass `model=chatglm` (or
    architecture="chatglm")."""
    d = dict(
        vocab_size=vocab_size, hidden_size=hidden_size,
        intermediate_size=4 * hidden_size, num_layers=num_layers,
        num_heads=num_heads, num_kv_heads=num_heads,
        head_dim=hidden_size // num_heads,
        max_position_embeddings=max_positions, rms_norm_eps=layernorm_eps)
    d.update(over)
    return ModelConfig(**d)


def params_from_chatglm_state_dict(sd, cfg: ModelConfig, dtype=None):
    """sd: {THUDM name: tensor}; dtype: a dtype or its name (default
    cfg.dtype), every leaf's."""
    dtype = _dtype(dtype, cfg)
    n_l = cfg.num_layers
    pre = "transformer.layers.{}."
    (wq, wk, wv), (bq, bk, bv) = _split_fused_qkv(
        _stack(sd, pre + "attention.query_key_value.weight", n_l),
        _stack(sd, pre + "attention.query_key_value.bias", n_l),
        cfg.num_heads, cfg.head_dim)
    layers = {
        "wq": wq, "bq": bq, "wk": wk, "bk": bk, "wv": wv, "bv": bv,
        "wo": _stack(sd, pre + "attention.dense.weight", n_l, True),
        "bo": _stack(sd, pre + "attention.dense.bias", n_l),
        "ln1_w": _stack(sd, pre + "input_layernorm.weight", n_l),
        "ln1_b": _stack(sd, pre + "input_layernorm.bias", n_l),
        "ln2_w": _stack(sd, pre + "post_attention_layernorm.weight", n_l),
        "ln2_b": _stack(sd, pre + "post_attention_layernorm.bias", n_l),
        "w_fc": _stack(sd, pre + "mlp.dense_h_to_4h.weight", n_l, True),
        "b_fc": _stack(sd, pre + "mlp.dense_h_to_4h.bias", n_l),
        "w_proj": _stack(sd, pre + "mlp.dense_4h_to_h.weight", n_l, True),
        "b_proj": _stack(sd, pre + "mlp.dense_4h_to_h.bias", n_l),
    }
    return {
        "embedding": sd["transformer.word_embeddings.weight"].to(dtype),
        "layers": _as(layers, dtype),
        "final_norm_w": sd["transformer.final_layernorm.weight"].to(dtype),
        "final_norm_b": sd["transformer.final_layernorm.bias"].to(dtype),
        "lm_head": sd["lm_head.weight"].t().to(dtype).contiguous(),
    }
