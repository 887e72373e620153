"""BERT encoder family (the port's `models/bert.py`).

The reference's BertModel and BertForQuestionAnswering (models/bert/
model.py, its bertAttentionPlugin for the bidirectional attention), as
the JAX package has them: word + position + token-type embeddings and an
embedding LayerNorm, then post-LN blocks (attention with q / k / v / o
biases through `prefill_attention(causal=False)`, the length mask alone:
row 10's non-causal branch, or row 12's past `prefill_streaming_min_s`;
an exact-erf GELU MLP in f32), HF BertModel's semantics. `forward_qa`
adds the 2-output span head.

Params are a plain dict with the JAX package's keys and shapes (stacked
[L, ...] layers: wq/bq, wk/bk, wv/bv, wo/bo, ln1_w/ln1_b, w_fc/b_fc,
w_proj/b_proj, ln2_w/ln2_b; word_emb, pos_emb, type_emb, emb_ln_w /
emb_ln_b; qa_w / qa_b with the QA head). No KV cache and no generation:
an encoder runs once per input, directly or through
`runtime.single_shot.InferenceSession`.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import str_dtype_to_torch
from ..device import resolve_device
from ..ops.attention import prefill_attention
from ..ops.linear import dense, embedding_lookup
from ..ops.norm import layer_norm


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    dtype: str = "float32"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return str_dtype_to_torch(self.dtype)

    @classmethod
    def from_hf_config(cls, hf_cfg, **over) -> "BertConfig":
        return cls(
            vocab_size=hf_cfg.vocab_size, hidden_size=hf_cfg.hidden_size,
            num_layers=hf_cfg.num_hidden_layers,
            num_heads=hf_cfg.num_attention_heads,
            intermediate_size=hf_cfg.intermediate_size,
            max_position_embeddings=hf_cfg.max_position_embeddings,
            type_vocab_size=hf_cfg.type_vocab_size,
            layer_norm_eps=hf_cfg.layer_norm_eps, **over)


def init_params(cfg: BertConfig, seed: int = 0, device="cuda",
                qa_head: bool = False):
    """Random params in the stacked-layer layout on `device`, drawn from a
    torch.Generator seeded with `seed` there (normal * fan_in**-0.5 in
    cfg.dtype, unit LayerNorm weights, zero biases; the random streams
    differ from JAX's)."""
    device = resolve_device(device)
    dt = cfg.torch_dtype
    gen = torch.Generator(device=device).manual_seed(seed)
    d, f, n_l = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers

    def w(shape, fan_in):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=dt).mul_(fan_in ** -0.5)

    def const(shape, value):
        return torch.full(shape, value, device=device, dtype=dt)

    params = {
        "word_emb": w((cfg.vocab_size, d), d),
        "pos_emb": w((cfg.max_position_embeddings, d), d),
        "type_emb": w((cfg.type_vocab_size, d), d),
        "emb_ln_w": const((d,), 1.0), "emb_ln_b": const((d,), 0.0),
        "layers": {
            "wq": w((n_l, d, d), d), "bq": const((n_l, d), 0.0),
            "wk": w((n_l, d, d), d), "bk": const((n_l, d), 0.0),
            "wv": w((n_l, d, d), d), "bv": const((n_l, d), 0.0),
            "wo": w((n_l, d, d), d), "bo": const((n_l, d), 0.0),
            "ln1_w": const((n_l, d), 1.0), "ln1_b": const((n_l, d), 0.0),
            "w_fc": w((n_l, d, f), d), "b_fc": const((n_l, f), 0.0),
            "w_proj": w((n_l, f, d), f), "b_proj": const((n_l, d), 0.0),
            "ln2_w": const((n_l, d), 1.0), "ln2_b": const((n_l, d), 0.0),
        },
    }
    if qa_head:
        params["qa_w"] = w((d, 2), d)
        params["qa_b"] = const((2,), 0.0)
    return params


def _block(cfg: BertConfig, lw, layer: int, x, seq_lens):
    b, s, d = x.shape
    h, hd = cfg.num_heads, cfg.head_dim

    def proj(wname, bname):
        y = dense(x, lw[wname], layer=layer, part="col") + lw[bname][layer]
        return y.reshape(b, s, h, hd).contiguous()

    q, k, v = proj("wq", "bq"), proj("wk", "bk"), proj("wv", "bv")
    attn = prefill_attention(q, k, v, seq_lens, causal=False).reshape(b, s, d)
    attn = dense(attn, lw["wo"], layer=layer, part="row") + lw["bo"][layer]
    x = layer_norm(x + attn, lw["ln1_w"][layer], lw["ln1_b"][layer],
                   cfg.layer_norm_eps)
    mid = dense(x, lw["w_fc"], layer=layer, part="col") + lw["b_fc"][layer]
    mid = torch.nn.functional.gelu(mid.float()).to(x.dtype)
    mlp = dense(mid, lw["w_proj"], layer=layer, part="row") + lw["b_proj"][
        layer]
    return layer_norm(x + mlp, lw["ln2_w"][layer], lw["ln2_b"][layer],
                      cfg.layer_norm_eps)


def forward(params, cfg: BertConfig, input_ids, seq_lens=None,
            token_type_ids=None):
    """Encoder forward. input_ids [B, S]; seq_lens: optional [B] true
    lengths (pad keys masked; pad rows are computed too); token_type_ids:
    optional [B, S]. Returns the final hidden states [B, S, D]."""
    b, s = input_ids.shape
    x = embedding_lookup(params["word_emb"], input_ids)
    x = x + params["pos_emb"][:s][None]
    types = (token_type_ids if token_type_ids is not None
             else torch.zeros_like(input_ids))
    x = x + embedding_lookup(params["type_emb"], types)
    x = layer_norm(x, params["emb_ln_w"], params["emb_ln_b"],
                   cfg.layer_norm_eps)
    if seq_lens is None:
        seq_lens = torch.full((b,), s, dtype=torch.int32,
                              device=input_ids.device)
    for layer in range(cfg.num_layers):
        x = _block(cfg, params["layers"], layer, x, seq_lens)
    return x


def forward_qa(params, cfg: BertConfig, input_ids, seq_lens=None,
               token_type_ids=None):
    """BertForQuestionAnswering: the encoder and a 2-output span head.
    Returns (start_logits, end_logits), each [B, S]."""
    x = forward(params, cfg, input_ids, seq_lens, token_type_ids)
    logits = dense(x, params["qa_w"]) + params["qa_b"]
    return logits[..., 0], logits[..., 1]
