"""ChatGLM-6B family (the port's `models/chatglm.py`).

The reference's ChatGLM-6B (models/chatglm6b/model.py and its vendored
modeling_chatglm.py), as the JAX package has it:

- 2D rotary: the head dim is split into two halves, each rotated NeoX-style
  (half-split) by its own position channel. Channel 0 is the token's
  position in the context, frozen at `mask_pos` for generated tokens;
  channel 1 is 0 for context tokens and counts 1, 2, ... for generated
  ones. `rope_tables` gives the half-width (cos, sin) table both channels
  read.
- Prefix-LM masking: context tokens attend the whole context both ways
  (`prefill_attention(causal=False)`: row 10's or row 12's non-causal
  branch); a generated token attends everything before it (kernel 3, or
  the `decode_attn_mode` kernel, in decode; the stock slab attention in
  `forward_extend`, whose rows all sit past the context, so causal masking
  over absolute positions keeps the prefix-LM contract).
- Post-LN residuals scaled by alpha = sqrt(2 * num_layers): out =
  ln(x) * alpha + sublayer(ln(x)); separate q / k / v projections with
  biases; an exact-erf GELU MLP (4x) in f32; a final LayerNorm and an
  untied lm_head.

Params are a plain dict with the JAX package's keys and shapes: `embedding`
[V, D]; `layers` (stacked [L, ...]): wq/bq, wk/bk, wv/bv, wo/bo,
ln1_w/ln1_b, ln2_w/ln2_b, w_fc/b_fc, w_proj/b_proj; final_norm_w /
final_norm_b; `lm_head` [D, V]. The projections may be tensors or the
containers `ops.linear.dense` dispatches on (`quantize_params` with int8
weight-only puts all six on row 2). The cache is a `ChatGLMCache`: llama's
stacked `KVCache` plus each sequence's context length and frozen
`mask_pos`, set by the prefill, so the session's decode loop (which passes
only positions) drives the 2D positions unchanged.

The module follows the model contract of `models/__init__.py`
(`GenerationSession(..., model=chatglm)` or `cfg.architecture`
"chatglm"); like the JAX package's, `forward_prefill` takes no `slots=`,
so `ServingEngine` cannot serve it (it raises), and there is no paged
cache.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..config import ModelConfig
from ..device import resolve_device
from ..ops.attention import (KVCache, extend_attention_at,
                             fused_decode_attention_at, prefill_attention,
                             write_kv_extend_at, write_kv_prefill_at)
from ..ops.linear import dense, embedding_lookup
from ..ops.norm import layer_norm
from ..ops.rope import apply_rope, rope_table, take_rope
from . import llama


class ChatGLMCache(NamedTuple):
    """kv: the stacked KVCache; ctx_lens / mask_pos: [B] int32 set by the
    prefill (each context's length and its frozen channel-0 position)."""

    kv: KVCache
    ctx_lens: torch.Tensor
    mask_pos: torch.Tensor


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda", dtype=None):
    """Random params with the JAX package's keys and shapes on `device`,
    drawn from a torch.Generator seeded with `seed` there: projections,
    embedding and lm_head normal * fan_in**-0.5 in the compute dtype, unit
    LayerNorm weights, zero biases. The random streams differ from
    JAX's."""
    device = resolve_device(device)
    dt = dtype or cfg.torch_dtype
    gen = torch.Generator(device=device).manual_seed(seed)
    d, f, n_l, v = (cfg.hidden_size, cfg.intermediate_size, cfg.num_layers,
                    cfg.vocab_size)
    hd = cfg.num_heads * cfg.head_dim

    def w(shape, fan_in):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=dt).mul_(fan_in ** -0.5)

    def const(shape, value):
        return torch.full(shape, value, device=device, dtype=dt)

    return {
        "embedding": w((v, d), d),
        "layers": {
            "wq": w((n_l, d, hd), d), "bq": const((n_l, hd), 0.0),
            "wk": w((n_l, d, hd), d), "bk": const((n_l, hd), 0.0),
            "wv": w((n_l, d, hd), d), "bv": const((n_l, hd), 0.0),
            "wo": w((n_l, hd, d), hd), "bo": const((n_l, d), 0.0),
            "ln1_w": const((n_l, d), 1.0), "ln1_b": const((n_l, d), 0.0),
            "ln2_w": const((n_l, d), 1.0), "ln2_b": const((n_l, d), 0.0),
            "w_fc": w((n_l, d, f), d), "b_fc": const((n_l, f), 0.0),
            "w_proj": w((n_l, f, d), f), "b_proj": const((n_l, d), 0.0),
        },
        "final_norm_w": const((d,), 1.0),
        "final_norm_b": const((d,), 0.0),
        "lm_head": w((d, v), d),
    }


def init_caches(cfg: ModelConfig, batch: int, max_len: int, device,
                kv_scales=None) -> ChatGLMCache:
    """llama's zeroed stacked cache, with zero context lengths and
    mask_pos."""
    zeros = torch.zeros(batch, dtype=torch.int32, device=device)
    return ChatGLMCache(llama.init_caches(cfg, batch, max_len, device,
                                          kv_scales), zeros, zeros.clone())


def rope_tables(cfg: ModelConfig, device="cpu"):
    """(cos, sin) [max_position_embeddings, head_dim / 2] f32: the table
    each half of the head dim reads with its own position channel."""
    return rope_table(cfg.max_position_embeddings, cfg.head_dim // 2,
                      cfg.rope_theta, device=device)


def _alpha(cfg: ModelConfig) -> float:
    return math.sqrt(2.0 * cfg.num_layers)


def _rope_2d(x, tables, pos0, pos1):
    """GLM's 2D rotary. x: [B, S, H, D] with pos0 / pos1 [B, S], or
    [B, H, D] (decode) with pos0 / pos1 [B]."""
    half = x.shape[-1] // 2
    y0 = apply_rope(x[..., :half], *take_rope(*tables, pos0))
    y1 = apply_rope(x[..., half:], *take_rope(*tables, pos1))
    return torch.cat([y0, y1], dim=-1)


def _block(cfg: ModelConfig, lw, layer: int, x, tables, pos0, pos1,
           caches: ChatGLMCache, seq_lens, decode: bool, extend=None):
    alpha = _alpha(cfg)
    h, hd = cfg.num_heads, cfg.head_dim

    def proj(y, wname, bname):
        y = dense(y, lw[wname], layer=layer, part="col") + lw[bname][layer]
        return y.reshape(*y.shape[:-1], h, hd)

    a_in = layer_norm(x, lw["ln1_w"][layer], lw["ln1_b"][layer],
                      cfg.rms_norm_eps)
    q = _rope_2d(proj(a_in, "wq", "bq"), tables, pos0, pos1).contiguous()
    k = _rope_2d(proj(a_in, "wk", "bk"), tables, pos0, pos1).contiguous()
    v = proj(a_in, "wv", "bv").contiguous()
    kv = caches.kv
    if extend is not None:
        # a generation slab: its rows sit past the context, so causal
        # masking over absolute positions keeps the prefix-LM contract
        attn = extend_attention_at(q, kv, layer, extend, k, v)
        kv = write_kv_extend_at(kv, layer, k, v, extend)
    elif decode:
        attn, kv = fused_decode_attention_at(q, k, v, kv, layer, seq_lens)
    else:
        kv = write_kv_prefill_at(kv, layer, k, v)
        # prefix-LM: the whole context is visible both ways
        attn = prefill_attention(q, k, v, seq_lens, causal=False)
    caches = caches._replace(kv=kv)
    attn = attn.reshape(*attn.shape[:-2], h * hd)
    attn = dense(attn, lw["wo"], layer=layer, part="row") + lw["bo"][layer]
    x = a_in * alpha + attn

    m_in = layer_norm(x, lw["ln2_w"][layer], lw["ln2_b"][layer],
                      cfg.rms_norm_eps)
    mid = dense(m_in, lw["w_fc"], layer=layer, part="col") + lw["b_fc"][layer]
    mid = torch.nn.functional.gelu(mid.float()).to(x.dtype)
    mlp = dense(mid, lw["w_proj"], layer=layer, part="row") + lw["b_proj"][
        layer]
    return m_in * alpha + mlp, caches


def _run_layers(cfg, params, x, tables, pos0, pos1, caches, seq_lens,
                decode, extend=None):
    for layer in range(cfg.num_layers):
        x, caches = _block(cfg, params["layers"], layer, x, tables, pos0,
                           pos1, caches, seq_lens, decode, extend)
    return x, caches


def _head(params, cfg: ModelConfig, x):
    x = layer_norm(x, params["final_norm_w"], params["final_norm_b"],
                   cfg.rms_norm_eps)
    return dense(x, params["lm_head"], torch.float32)


def _tables(cfg, rope, device):
    return rope if rope is not None else rope_tables(cfg, device)


def forward_prefill(params, cfg: ModelConfig, input_ids, seq_lens,
                    caches: ChatGLMCache, return_all_logits: bool = False,
                    mask_pos: Optional[torch.Tensor] = None, rope=None):
    """Context phase. input_ids [B, S] left-aligned, seq_lens [B].
    Positions: channel 0 counts 0..S-1, channel 1 is 0. mask_pos [B]
    defaults to seq_lens - 2 (the [gMASK] slot of the `... [gMASK] <sop>`
    prompt layout) and is frozen into the cache with the context lengths
    for generation. Returns (f32 logits [B, V] at each sequence's last
    position, or [B, S, V] with return_all_logits, caches)."""
    b, s = input_ids.shape
    dev = input_ids.device
    x = embedding_lookup(params["embedding"], input_ids, cfg.torch_dtype)
    pos0 = torch.arange(s, device=dev)[None].expand(b, s)
    pos1 = torch.zeros((b, s), dtype=torch.long, device=dev)
    x, caches = _run_layers(cfg, params, x, _tables(cfg, rope, dev), pos0,
                            pos1, caches, seq_lens, False)
    if mask_pos is None:
        mask_pos = (seq_lens - 2).clamp_min(0)
    caches = caches._replace(ctx_lens=seq_lens.to(torch.int32),
                             mask_pos=mask_pos.to(torch.int32))
    if return_all_logits:
        return _head(params, cfg, x), caches
    last = (seq_lens.long() - 1).clamp(0, s - 1)
    return _head(params, cfg, x[torch.arange(b, device=dev), last]), caches


def forward_extend(params, cfg: ModelConfig, tokens, start,
                   caches: ChatGLMCache, rope=None):
    """Multi-token generation slab (llama.forward_extend's contract):
    tokens [B, T] at absolute positions start[b] + i, all past the
    context. 2D channels: channel 0 the frozen mask_pos, channel 1 the
    block position abs - ctx_len + 1. Returns (f32 logits [B, T, V],
    caches)."""
    b, t = tokens.shape
    dev = tokens.device
    x = embedding_lookup(params["embedding"], tokens, cfg.torch_dtype)
    pos_abs = start.long()[:, None] + torch.arange(t, device=dev)[None]
    pos0 = caches.mask_pos.long()[:, None].expand(b, t)
    pos1 = (pos_abs - caches.ctx_lens.long()[:, None] + 1).clamp_min(0)
    x, caches = _run_layers(cfg, params, x, _tables(cfg, rope, dev), pos0,
                            pos1, caches, None, False, extend=start)
    return _head(params, cfg, x), caches


def forward_decode(params, cfg: ModelConfig, tokens, positions,
                   caches: ChatGLMCache, rope=None):
    """Generation phase, one token per sequence. positions [B]: the cache
    write index (the running length); channel 0 the frozen mask_pos,
    channel 1 positions - ctx_len + 1 (block positions 1, 2, ...).
    Returns (f32 logits [B, V], caches)."""
    dev = tokens.device
    x = embedding_lookup(params["embedding"], tokens, cfg.torch_dtype)
    pos0 = caches.mask_pos.long()
    pos1 = (positions.long() - caches.ctx_lens.long() + 1).clamp_min(0)
    x, caches = _run_layers(cfg, params, x, _tables(cfg, rope, dev), pos0,
                            pos1, caches, positions, True)
    return _head(params, cfg, x), caches
