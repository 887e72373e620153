"""HF checkpoints -> the port's params for the decoder families of
`models/decoder.py`: GPT-J, GPT-NeoX, Bloom, OPT and Falcon (the port's
`convert/hf_families.py`).

The load-time half of the reference's per-family weight pipelines
(examples/{gptj,gptneox,bloom,opt}/weight.py), as the JAX package's
functions map them: the same parameter keys and shapes, stacked over
layers. Torch nn.Linear weights are [out, in] and the port's are [in, out],
so projections transpose once here. The fused query_key_value matrices of
NeoX and Bloom (and Falcon without multi-query) are stored
head-interleaved ([head, (q, k, v), head_dim] on the output axis); they are
split into wq / wk / wv so that every family's projections take the same
stacked layout and quantized containers.

The functions read the HF `state_dict()` as torch tensors and build the
stacks on those tensors' device (the card's, for a model built there):
there is no numpy round trip. `dtype` (a torch dtype or its name, default
cfg.dtype) is every leaf's dtype but GPT-J's `lm_head_b`, which stays f32.
"""

from __future__ import annotations

import torch

from ..config import ModelConfig
from .hf import _dtype


def _stack(sd, fmt, n, transpose=False):
    """[n, ...] stack of sd[fmt.format(i)] (each transposed to [in, out]
    where `transpose`)."""
    return torch.stack([sd[fmt.format(i)].t() if transpose
                        else sd[fmt.format(i)] for i in range(n)])


def _split_fused_qkv(w_qkv, b_qkv, n_heads, head_dim):
    """Split [L, 3 * D, D_in] / [L, 3 * D] with the [head, 3, head_dim]
    output layout into ((wq, wk, wv) [L, D_in, D] matmul-ready,
    (bq, bk, bv) [L, D])."""
    n_l, d_in = w_qkv.shape[0], w_qkv.shape[-1]
    w = w_qkv.reshape(n_l, n_heads, 3, head_dim, d_in)
    ws = [w[:, :, i].permute(0, 3, 1, 2).reshape(n_l, d_in, -1)
          for i in range(3)]
    b = b_qkv.reshape(n_l, n_heads, 3, head_dim)
    bs = [b[:, :, i].reshape(n_l, -1) for i in range(3)]
    return ws, bs


def _as(tree, dtype):
    return {k: v.to(dtype).contiguous() for k, v in tree.items()}


def _hf_field(hf_cfg, names, default=None):
    """The first of `names` that the config sets, as an attribute or in
    its `rope_parameters` (where newer transformers keep rope fields)."""
    for name in names:
        if getattr(hf_cfg, name, None) is not None:
            return getattr(hf_cfg, name)
    rope = getattr(hf_cfg, "rope_parameters", None) or {}
    for name in names:
        if rope.get(name) is not None:
            return rope[name]
    return default


# ---------------------------------------------------------------- GPT-J --
def config_from_hf_gptj(hf_cfg, **over) -> ModelConfig:
    d = dict(
        vocab_size=hf_cfg.vocab_size, hidden_size=hf_cfg.n_embd,
        intermediate_size=getattr(hf_cfg, "n_inner", None) or 4 * hf_cfg.n_embd,
        num_layers=hf_cfg.n_layer, num_heads=hf_cfg.n_head,
        num_kv_heads=hf_cfg.n_head,
        head_dim=hf_cfg.n_embd // hf_cfg.n_head,
        max_position_embeddings=hf_cfg.n_positions,
        rotary_dim=hf_cfg.rotary_dim or 0,
        rms_norm_eps=hf_cfg.layer_norm_epsilon,
    )
    d.update(over)
    return ModelConfig(**d)


def params_from_hf_gptj(hf_model, cfg: ModelConfig, dtype=None):
    dtype = _dtype(dtype, cfg)
    sd = hf_model.state_dict()
    n_l = cfg.num_layers
    h = "transformer.h.{}."
    layers = {
        "ln1_w": _stack(sd, h + "ln_1.weight", n_l),
        "ln1_b": _stack(sd, h + "ln_1.bias", n_l),
        "wq": _stack(sd, h + "attn.q_proj.weight", n_l, True),
        "wk": _stack(sd, h + "attn.k_proj.weight", n_l, True),
        "wv": _stack(sd, h + "attn.v_proj.weight", n_l, True),
        "wo": _stack(sd, h + "attn.out_proj.weight", n_l, True),
        "w_fc": _stack(sd, h + "mlp.fc_in.weight", n_l, True),
        "b_fc": _stack(sd, h + "mlp.fc_in.bias", n_l),
        "w_proj": _stack(sd, h + "mlp.fc_out.weight", n_l, True),
        "b_proj": _stack(sd, h + "mlp.fc_out.bias", n_l),
    }
    return {
        "embed": sd["transformer.wte.weight"].to(dtype),
        "layers": _as(layers, dtype),
        "final_ln_w": sd["transformer.ln_f.weight"].to(dtype),
        "final_ln_b": sd["transformer.ln_f.bias"].to(dtype),
        "lm_head": sd["lm_head.weight"].t().to(dtype).contiguous(),
        "lm_head_b": sd["lm_head.bias"].to(torch.float32),
    }


# ------------------------------------------------------------- GPT-NeoX --
def config_from_hf_gptneox(hf_cfg, **over) -> ModelConfig:
    hd = hf_cfg.hidden_size // hf_cfg.num_attention_heads
    d = dict(
        vocab_size=hf_cfg.vocab_size, hidden_size=hf_cfg.hidden_size,
        intermediate_size=hf_cfg.intermediate_size,
        num_layers=hf_cfg.num_hidden_layers,
        num_heads=hf_cfg.num_attention_heads,
        num_kv_heads=hf_cfg.num_attention_heads, head_dim=hd,
        max_position_embeddings=hf_cfg.max_position_embeddings,
        rotary_dim=int(hd * _hf_field(hf_cfg, ("rotary_pct",
                                               "partial_rotary_factor"))),
        rope_theta=_hf_field(hf_cfg, ("rotary_emb_base", "rope_theta"),
                             10000.0),
        rms_norm_eps=hf_cfg.layer_norm_eps,
    )
    d.update(over)
    if not getattr(hf_cfg, "use_parallel_residual", True):
        raise NotImplementedError(
            "GPT-NeoX with use_parallel_residual=False (sequential residual) "
            "is the Bloom/OPT wiring; use a custom ArchSpec")
    return ModelConfig(**d)


def params_from_hf_gptneox(hf_model, cfg: ModelConfig, dtype=None):
    dtype = _dtype(dtype, cfg)
    sd = hf_model.state_dict()
    n_l = cfg.num_layers
    h = "gpt_neox.layers.{}."
    (wq, wk, wv), (bq, bk, bv) = _split_fused_qkv(
        _stack(sd, h + "attention.query_key_value.weight", n_l),
        _stack(sd, h + "attention.query_key_value.bias", n_l),
        cfg.num_heads, cfg.head_dim)
    layers = {
        "ln1_w": _stack(sd, h + "input_layernorm.weight", n_l),
        "ln1_b": _stack(sd, h + "input_layernorm.bias", n_l),
        "ln2_w": _stack(sd, h + "post_attention_layernorm.weight", n_l),
        "ln2_b": _stack(sd, h + "post_attention_layernorm.bias", n_l),
        "wq": wq, "bq": bq, "wk": wk, "bk": bk, "wv": wv, "bv": bv,
        "wo": _stack(sd, h + "attention.dense.weight", n_l, True),
        "bo": _stack(sd, h + "attention.dense.bias", n_l),
        "w_fc": _stack(sd, h + "mlp.dense_h_to_4h.weight", n_l, True),
        "b_fc": _stack(sd, h + "mlp.dense_h_to_4h.bias", n_l),
        "w_proj": _stack(sd, h + "mlp.dense_4h_to_h.weight", n_l, True),
        "b_proj": _stack(sd, h + "mlp.dense_4h_to_h.bias", n_l),
    }
    return {
        "embed": sd["gpt_neox.embed_in.weight"].to(dtype),
        "layers": _as(layers, dtype),
        "final_ln_w": sd["gpt_neox.final_layer_norm.weight"].to(dtype),
        "final_ln_b": sd["gpt_neox.final_layer_norm.bias"].to(dtype),
        "lm_head": sd["embed_out.weight"].t().to(dtype).contiguous(),
    }


# ----------------------------------------------------------------- Bloom --
def config_from_hf_bloom(hf_cfg, **over) -> ModelConfig:
    d = dict(
        vocab_size=hf_cfg.vocab_size, hidden_size=hf_cfg.hidden_size,
        intermediate_size=4 * hf_cfg.hidden_size,
        num_layers=hf_cfg.n_layer, num_heads=hf_cfg.n_head,
        num_kv_heads=hf_cfg.n_head,
        head_dim=hf_cfg.hidden_size // hf_cfg.n_head,
        max_position_embeddings=2048,        # ALiBi: no position table
        rms_norm_eps=hf_cfg.layer_norm_epsilon,
        tie_word_embeddings=True,
    )
    d.update(over)
    return ModelConfig(**d)


def params_from_hf_bloom(hf_model, cfg: ModelConfig, dtype=None):
    dtype = _dtype(dtype, cfg)
    sd = hf_model.state_dict()
    n_l = cfg.num_layers
    h = "transformer.h.{}."
    (wq, wk, wv), (bq, bk, bv) = _split_fused_qkv(
        _stack(sd, h + "self_attention.query_key_value.weight", n_l),
        _stack(sd, h + "self_attention.query_key_value.bias", n_l),
        cfg.num_heads, cfg.head_dim)
    layers = {
        "ln1_w": _stack(sd, h + "input_layernorm.weight", n_l),
        "ln1_b": _stack(sd, h + "input_layernorm.bias", n_l),
        "ln2_w": _stack(sd, h + "post_attention_layernorm.weight", n_l),
        "ln2_b": _stack(sd, h + "post_attention_layernorm.bias", n_l),
        "wq": wq, "bq": bq, "wk": wk, "bk": bk, "wv": wv, "bv": bv,
        "wo": _stack(sd, h + "self_attention.dense.weight", n_l, True),
        "bo": _stack(sd, h + "self_attention.dense.bias", n_l),
        "w_fc": _stack(sd, h + "mlp.dense_h_to_4h.weight", n_l, True),
        "b_fc": _stack(sd, h + "mlp.dense_h_to_4h.bias", n_l),
        "w_proj": _stack(sd, h + "mlp.dense_4h_to_h.weight", n_l, True),
        "b_proj": _stack(sd, h + "mlp.dense_4h_to_h.bias", n_l),
    }
    embed = sd["transformer.word_embeddings.weight"]
    return {
        "embed": embed.to(dtype),
        "emb_ln_w": sd["transformer.word_embeddings_layernorm.weight"].to(
            dtype),
        "emb_ln_b": sd["transformer.word_embeddings_layernorm.bias"].to(
            dtype),
        "layers": _as(layers, dtype),
        "final_ln_w": sd["transformer.ln_f.weight"].to(dtype),
        "final_ln_b": sd["transformer.ln_f.bias"].to(dtype),
        "lm_head": embed.t().to(dtype).contiguous(),
    }


# ------------------------------------------------------------------- OPT --
def config_from_hf_opt(hf_cfg, **over) -> ModelConfig:
    if hf_cfg.word_embed_proj_dim != hf_cfg.hidden_size:
        raise NotImplementedError("OPT word_embed_proj_dim != hidden_size")
    if not hf_cfg.do_layer_norm_before:
        raise NotImplementedError("OPT-350m post-norm variant unsupported")
    d = dict(
        vocab_size=hf_cfg.vocab_size, hidden_size=hf_cfg.hidden_size,
        intermediate_size=hf_cfg.ffn_dim,
        num_layers=hf_cfg.num_hidden_layers,
        num_heads=hf_cfg.num_attention_heads,
        num_kv_heads=hf_cfg.num_attention_heads,
        head_dim=hf_cfg.hidden_size // hf_cfg.num_attention_heads,
        max_position_embeddings=hf_cfg.max_position_embeddings,
        rms_norm_eps=1e-5,
        tie_word_embeddings=True,
    )
    d.update(over)
    return ModelConfig(**d)


def params_from_hf_opt(hf_model, cfg: ModelConfig, dtype=None):
    dtype = _dtype(dtype, cfg)
    sd = hf_model.state_dict()
    n_l = cfg.num_layers
    h = "model.decoder.layers.{}."
    layers = {
        "ln1_w": _stack(sd, h + "self_attn_layer_norm.weight", n_l),
        "ln1_b": _stack(sd, h + "self_attn_layer_norm.bias", n_l),
        "wq": _stack(sd, h + "self_attn.q_proj.weight", n_l, True),
        "bq": _stack(sd, h + "self_attn.q_proj.bias", n_l),
        "wk": _stack(sd, h + "self_attn.k_proj.weight", n_l, True),
        "bk": _stack(sd, h + "self_attn.k_proj.bias", n_l),
        "wv": _stack(sd, h + "self_attn.v_proj.weight", n_l, True),
        "bv": _stack(sd, h + "self_attn.v_proj.bias", n_l),
        "wo": _stack(sd, h + "self_attn.out_proj.weight", n_l, True),
        "bo": _stack(sd, h + "self_attn.out_proj.bias", n_l),
        "ln2_w": _stack(sd, h + "final_layer_norm.weight", n_l),
        "ln2_b": _stack(sd, h + "final_layer_norm.bias", n_l),
        "w_fc": _stack(sd, h + "fc1.weight", n_l, True),
        "b_fc": _stack(sd, h + "fc1.bias", n_l),
        "w_proj": _stack(sd, h + "fc2.weight", n_l, True),
        "b_proj": _stack(sd, h + "fc2.bias", n_l),
    }
    embed = sd["model.decoder.embed_tokens.weight"]
    return {
        "embed": embed.to(dtype),
        "pos_embed": sd["model.decoder.embed_positions.weight"].to(dtype),
        "layers": _as(layers, dtype),
        "final_ln_w": sd["model.decoder.final_layer_norm.weight"].to(dtype),
        "final_ln_b": sd["model.decoder.final_layer_norm.bias"].to(dtype),
        "lm_head": embed.t().to(dtype).contiguous(),
    }


# --------------------------------------------------------------- Falcon --
def config_from_hf_falcon(hf_cfg, **over) -> ModelConfig:
    """Falcon-7B's wiring: rotary, parallel attention, one input LayerNorm,
    projections without bias, multi-query (num_kv_heads 1) or MHA. The 40B
    `new_decoder_architecture` and the ALiBi / bias RW variants raise."""
    if getattr(hf_cfg, "new_decoder_architecture", False):
        raise NotImplementedError(
            "Falcon new_decoder_architecture (40B wiring: grouped KV + two "
            "LNs per block) is not mapped; 7B wiring only")
    if getattr(hf_cfg, "alibi", False) or getattr(hf_cfg, "bias", False):
        raise NotImplementedError(
            "Falcon RW variants (alibi=True / bias=True) are not mapped")
    if not getattr(hf_cfg, "parallel_attn", True):
        raise NotImplementedError("Falcon with parallel_attn=False is the "
                                  "sequential-residual (Bloom/OPT) wiring")
    hd = hf_cfg.hidden_size // hf_cfg.num_attention_heads
    d = dict(
        vocab_size=hf_cfg.vocab_size, hidden_size=hf_cfg.hidden_size,
        intermediate_size=getattr(hf_cfg, "ffn_hidden_size",
                                  4 * hf_cfg.hidden_size),
        num_layers=hf_cfg.num_hidden_layers,
        num_heads=hf_cfg.num_attention_heads,
        num_kv_heads=1 if hf_cfg.multi_query else hf_cfg.num_attention_heads,
        head_dim=hd,
        max_position_embeddings=hf_cfg.max_position_embeddings,
        rotary_dim=hd,                       # full-dim neox rotary
        rope_theta=_hf_field(hf_cfg, ("rope_theta",), 10000.0),
        rms_norm_eps=hf_cfg.layer_norm_epsilon,
        architecture="falcon",
    )
    d.update(over)
    return ModelConfig(**d)


def params_from_hf_falcon(hf_model, cfg: ModelConfig, dtype=None):
    dtype = _dtype(dtype, cfg)
    sd = hf_model.state_dict()
    n_l, nq, hd = cfg.num_layers, cfg.num_heads, cfg.head_dim
    h = "transformer.h.{}."
    w_qkv = _stack(sd, h + "self_attention.query_key_value.weight", n_l)
    if cfg.num_kv_heads == 1:
        # multi-query layout: nq query heads, then one k head, then one v
        # head (FalconAttention._split_heads, multi_query branch)
        wq = w_qkv[:, :nq * hd].transpose(1, 2)
        wk = w_qkv[:, nq * hd:(nq + 1) * hd].transpose(1, 2)
        wv = w_qkv[:, (nq + 1) * hd:].transpose(1, 2)
    else:
        # the MHA layout is [head, 3, head_dim]-interleaved like GPT-NeoX's
        (wq, wk, wv), _ = _split_fused_qkv(
            w_qkv, w_qkv.new_zeros(w_qkv.shape[:2]), nq, hd)
    zeros = w_qkv.new_zeros
    layers = {
        "ln1_w": _stack(sd, h + "input_layernorm.weight", n_l),
        "ln1_b": _stack(sd, h + "input_layernorm.bias", n_l),
        "wq": wq, "wk": wk, "wv": wv,
        "wo": _stack(sd, h + "self_attention.dense.weight", n_l, True),
        "w_fc": _stack(sd, h + "mlp.dense_h_to_4h.weight", n_l, True),
        "b_fc": zeros((n_l, cfg.intermediate_size)),
        "w_proj": _stack(sd, h + "mlp.dense_4h_to_h.weight", n_l, True),
        "b_proj": zeros((n_l, cfg.hidden_size)),
    }
    return {
        "embed": sd["transformer.word_embeddings.weight"].to(dtype),
        "layers": _as(layers, dtype),
        "final_ln_w": sd["transformer.ln_f.weight"].to(dtype),
        "final_ln_b": sd["transformer.ln_f.bias"].to(dtype),
        "lm_head": sd["lm_head.weight"].t().to(dtype).contiguous(),
    }
