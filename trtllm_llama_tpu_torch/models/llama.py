"""LLaMA model, PyTorch (the port's `models/llama.py`).

Params are a plain dict mirroring the JAX package's pytree: `embed` [V, D],
`layers` (each entry stacked [L, ...]: attn_norm, wq/wk/wv or the fused
wqkv, wo, mlp_norm, w_gate and w_up or the fused w_gate_up, w_down;
projections are tensors, weight-only `WOQWeight`s (int8 or int4,
per-channel or grouped scales), `FP8Weight`s or SmoothQuant `SQWeight`s),
`final_norm` [D], `lm_head`
[D, V] (a tensor, or a 2-D `WOQWeight` / `FP8Weight` when quantized). The
layer loop is a Python loop over the stacked weights; kernels read the
layer slice in place; `ops.linear.dense` dispatches on the container. The KV cache is the stacked
[L, B, H_kv, S_max, D] `KVCache` (compute dtype, or int8 or fp8 e4m3
codes with per-layer scales) or the paged `PagedKVCache` (block pools [L, NB, H_kv, BS, D] with
a block table), updated in place; `forward_prefill` and `forward_decode`
dispatch on its type, and `forward_prefill_packed` prefills one packed
token stream into the dense cache; `forward_extend` runs a T-token slab a
sequence at per-row offsets (chunked prefill, speculative verification).

Under tensor parallelism (a tp group published in `ops.registry.KERNELS`
by the session) params are this rank's shards (`parallel/sharding.py`)
and cfg its `local_config` (its heads): every projection names its role
(`part=`: q/k/v and gate/up "col", wo and w_down "row", as the JAX
package's), the KV cache holds the local heads, and each forward gathers
the lm_head's vocabulary shards into the full f32 logits on every rank.
"""

from __future__ import annotations

import torch

from ..config import ModelConfig, str_dtype_to_torch
from ..ops.attention import (KVCache, PackedMeta, extend_attention_at,
                             fused_decode_attention_at,
                             packed_prefill_attention, prefill_attention,
                             write_kv_extend_at, write_kv_packed_at,
                             write_kv_prefill_at)
from ..ops.linear import (dense, dense_fused, dense_prequant,
                          embedding_lookup, tp_group)
from ..ops.norm import rms_norm, rms_norm_quant
from ..ops.paged_attention import (PagedKVCache,
                                   paged_fused_decode_attention_at,
                                   paged_write_prefill_at)
from ..ops.rope import apply_rope, rope_tables_for, take_rope
from ..parallel.comm import gather_columns
from ..quantization.tensors import SQWeight, concat_columns


# serving may give this model a paged KV pool (runtime/serving.py)
PAGED_CACHE = True


def init_caches(cfg: ModelConfig, batch: int, max_len: int, device,
                kv_scales=None) -> KVCache:
    """Zeroed stacked cache [L, B, H_kv, S_max, D] in `cfg.kv_dtype` (the
    compute dtype, int8 with INT8_KV_CACHE, or e4m3 codes in uint8 with
    FP8_KV_CACHE), with S_max rounded up to a multiple of 128 rows as in
    the JAX package. kv_scales: optional [L] dequant scales (default
    1.0)."""
    kv_dtype = str_dtype_to_torch(cfg.kv_dtype)
    max_len = -(-max_len // 128) * 128
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len, cfg.head_dim)
    if kv_scales is None:
        scale = torch.ones(cfg.num_layers, dtype=torch.float32, device=device)
    else:
        scale = torch.as_tensor(kv_scales, dtype=torch.float32, device=device)
    return KVCache(torch.zeros(shape, dtype=kv_dtype, device=device),
                   torch.zeros(shape, dtype=kv_dtype, device=device), scale)


def rope_tables(cfg: ModelConfig, device="cpu"):
    """(cos, sin) tables sized and scaled per cfg (the model protocol's
    hook, shared with the decoder families)."""
    return rope_tables_for(cfg, device=device)


def fuse_qkv_params(params):
    """Fuse wq/wk/wv into one stacked wqkv projection (exact rewrite).
    Returns new params; no-op when already fused or not fusable."""
    lw = params["layers"]
    if "wqkv" in lw or not all(k in lw for k in ("wq", "wk", "wv")):
        return params
    fused = concat_columns([lw["wq"], lw["wk"], lw["wv"]])
    if fused is None:
        return params
    new_lw = {k: v for k, v in lw.items() if k not in ("wq", "wk", "wv")}
    new_lw["wqkv"] = fused
    return {**params, "layers": new_lw}


def fuse_gate_up_params(params):
    """Fuse w_gate/w_up into one stacked w_gate_up projection (exact, as
    fuse_qkv_params; the session applies it under TLLM_FUSE_GU, as the
    JAX package's does). Returns new params; no-op when already fused or
    not fusable."""
    lw = params["layers"]
    if "w_gate_up" in lw or not all(k in lw for k in ("w_gate", "w_up")):
        return params
    fused = concat_columns([lw["w_gate"], lw["w_up"]])
    if fused is None:
        return params
    new_lw = {k: v for k, v in lw.items() if k not in ("w_gate", "w_up")}
    new_lw["w_gate_up"] = fused
    return {**params, "layers": new_lw}


def _split_heads(x, n_heads, head_dim):
    return x.reshape(*x.shape[:-1], n_heads, head_dim)


def _sq_per_token(w) -> bool:
    return isinstance(w, SQWeight) and w.per_token


def _attn_block(cfg: ModelConfig, lw, layer: int, x, cos, sin, caches,
                seq_lens, decode: bool, packed: PackedMeta = None,
                slots=None, extend=None):
    """x: [B, S, D] (prefill or extend), [B, D] (decode) or [T, D]
    (packed prefill). `caches` is the dense `KVCache` or a `PagedKVCache`;
    `slots` [B] are the dense cache rows a prefill or an extend writes
    (default 0..B-1); `extend` [B] the slab's start positions."""
    nq_d = cfg.num_heads * cfg.head_dim
    nkv_d = cfg.num_kv_heads * cfg.head_dim
    fused = "wqkv" in lw
    if _sq_per_token(lw["wqkv"] if fused else lw["wq"]):
        # RMSNorm -> int8 with per-token scales once (kernel 4), fanned out
        # to the q/k/v projections (kernel 5)
        h_q, h_s = rms_norm_quant(x, lw["attn_norm"][layer], cfg.rms_norm_eps)

        def proj(w):
            return dense_prequant(h_q, h_s, w, cfg.torch_dtype, layer,
                                  part="col")
    elif fused:
        # the norm runs inside kernel 1 at decode shapes (dense_fused)
        def proj(w):
            return dense_fused(x, w, layer=layer, norm_w=lw["attn_norm"],
                               eps=cfg.rms_norm_eps, part="col")
    else:
        h = rms_norm(x, lw["attn_norm"][layer], cfg.rms_norm_eps)

        def proj(w):
            return dense(h, w, layer=layer, part="col")
    if fused:
        qkv = proj(lw["wqkv"])
        q = qkv[..., :nq_d]
        k = qkv[..., nq_d:nq_d + nkv_d]
        v = qkv[..., nq_d + nkv_d:]
    else:
        q, k, v = proj(lw["wq"]), proj(lw["wk"]), proj(lw["wv"])
    q = apply_rope(_split_heads(q, cfg.num_heads, cfg.head_dim), cos, sin)
    k = apply_rope(_split_heads(k, cfg.num_kv_heads, cfg.head_dim), cos, sin)
    v = _split_heads(v, cfg.num_kv_heads, cfg.head_dim).contiguous()
    paged = isinstance(caches, PagedKVCache)
    if extend is not None:
        # the slab attends the cache as it was and itself, then is written
        attn = extend_attention_at(q, caches, layer, extend, k, v,
                                   slots=slots)
        caches = write_kv_extend_at(caches, layer, k, v, extend, slots)
    elif packed is not None:
        # packed prefill: q/k/v [T, H, D], one row per stream token
        caches = write_kv_packed_at(caches, layer, k, v, packed.slot_tok,
                                    packed.pos_tok)
        attn = packed_prefill_attention(q, k, v, packed.seg_ids)
    elif decode:
        decode_at = (paged_fused_decode_attention_at if paged
                     else fused_decode_attention_at)
        attn, caches = decode_at(q, k, v, caches, layer, seq_lens)
    else:
        caches = (paged_write_prefill_at(caches, layer, k, v) if paged
                  else write_kv_prefill_at(caches, layer, k, v, slots))
        attn = prefill_attention(q, k, v, seq_lens)
    attn = attn.reshape(*attn.shape[:-2], nq_d)
    out = dense_fused(attn, lw["wo"], layer=layer, resid=x, out_dtype=x.dtype,
                      part="row")
    return out, caches


def _mlp_block(cfg: ModelConfig, lw, layer: int, x):
    fused = "w_gate_up" in lw
    f = cfg.intermediate_size
    if _sq_per_token(lw["w_gate_up"] if fused else lw["w_gate"]):
        h_q, h_s = rms_norm_quant(x, lw["mlp_norm"][layer], cfg.rms_norm_eps)
        if fused:
            gu = dense_prequant(h_q, h_s, lw["w_gate_up"], cfg.torch_dtype,
                                layer, part="col")
            g, u = gu[..., :f], gu[..., f:]
        else:
            g = dense_prequant(h_q, h_s, lw["w_gate"], cfg.torch_dtype, layer,
                               part="col")
            u = dense_prequant(h_q, h_s, lw["w_up"], cfg.torch_dtype, layer,
                               part="col")
    elif fused:
        # the norm runs inside the gate/up kernel, silu(g) * u inside the
        # down kernel, at decode shapes (dense_fused; composed otherwise)
        gu = dense_fused(x, lw["w_gate_up"], layer=layer,
                         norm_w=lw["mlp_norm"], eps=cfg.rms_norm_eps,
                         part="col")
        return dense_fused(gu, lw["w_down"], layer=layer, swiglu=True,
                           resid=x, out_dtype=x.dtype, part="row")
    else:
        h = rms_norm(x, lw["mlp_norm"][layer], cfg.rms_norm_eps)
        g = dense(h, lw["w_gate"], layer=layer, part="col")
        u = dense(h, lw["w_up"], layer=layer, part="col")
    act = torch.nn.functional.silu(g.float()).to(u.dtype) * u
    return dense_fused(act, lw["w_down"], layer=layer, resid=x,
                       out_dtype=x.dtype, part="row")


def _run_layers(cfg: ModelConfig, params, x, cos, sin, caches, seq_lens,
                decode: bool, packed: PackedMeta = None, slots=None,
                extend=None):
    lw = params["layers"]
    for layer in range(cfg.num_layers):
        x, caches = _attn_block(cfg, lw, layer, x, cos, sin, caches,
                                seq_lens, decode, packed, slots, extend)
        x = _mlp_block(cfg, lw, layer, x)
    return x, caches


def _logits(x, params):
    """f32 logits of the final hidden states: the lm_head (this rank's
    vocabulary shard under tensor parallelism, gathered to the full V)."""
    return gather_columns(dense(x, params["lm_head"], torch.float32),
                          tp_group())


def _rope(cfg, rope, device):
    return rope if rope is not None else rope_tables_for(cfg, device=device)


def forward_prefill(params, cfg: ModelConfig, input_ids, seq_lens,
                    caches: KVCache, return_all_logits: bool = False,
                    rope=None, slots=None):
    """Context phase. input_ids: [B, S] left-aligned (padded right),
    seq_lens [B]. Returns (logits, caches): f32 logits [B, V] at each
    sequence's last position, or [B, S, V] with return_all_logits.
    `rope`: optional precomputed (cos, sin) tables (rope_tables_for).
    `slots`: optional [B] rows of a dense cache that take the K/V (the
    serving engine's slots); default rows 0..B-1."""
    b, s = input_ids.shape
    x = embedding_lookup(params["embed"], input_ids, cfg.torch_dtype)
    cos_t, sin_t = _rope(cfg, rope, x.device)
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    cos, sin = take_rope(cos_t, sin_t, positions)           # [B, S, 1, d]
    x, caches = _run_layers(cfg, params, x, cos, sin, caches, seq_lens, False,
                            slots=slots)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    if return_all_logits:
        return _logits(x, params), caches
    last = x[torch.arange(b, device=x.device), seq_lens.long() - 1]
    return _logits(last, params), caches


def forward_prefill_packed(params, cfg: ModelConfig, token_ids,
                           packed: PackedMeta, last_idx, caches: KVCache,
                           rope=None):
    """Packed (remove-padding) context phase. token_ids: [T] flattened
    mixed-length prompts (pads where seg_ids is -1); packed: PackedMeta;
    last_idx: [nb] index of each sequence's last token in the stream.
    Returns (f32 logits [nb, V], caches): each token's K/V lands at cache
    row slot_tok, position pos_tok."""
    x = embedding_lookup(params["embed"], token_ids, cfg.torch_dtype)  # [T, D]
    cos_t, sin_t = _rope(cfg, rope, x.device)
    cos, sin = take_rope(cos_t, sin_t, packed.pos_tok.long())          # [T,1,d]
    x, caches = _run_layers(cfg, params, x, cos, sin, caches, None, False,
                            packed)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return _logits(x[last_idx.long()], params), caches


def forward_extend(params, cfg: ModelConfig, tokens, start, caches: KVCache,
                   rope=None, slots=None):
    """Multi-token generation slab. tokens: [B, T]; token (b, i) sits at
    position start[b] + i of cache row b (or slots[b]): its K/V is written
    there and it attends causally to everything at or before itself.
    Returns (f32 logits [B, T, V], caches); row i predicts position
    start[b] + i + 1. Dense caches only, as in the JAX package."""
    b, t = tokens.shape
    x = embedding_lookup(params["embed"], tokens, cfg.torch_dtype)  # [B, T, D]
    cos_t, sin_t = _rope(cfg, rope, x.device)
    positions = start.long()[:, None] + torch.arange(t, device=x.device)[None]
    cos, sin = take_rope(cos_t, sin_t, positions)                  # [B,T,1,d]
    x, caches = _run_layers(cfg, params, x, cos, sin, caches, None, False,
                            slots=slots, extend=start)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return _logits(x, params), caches


def forward_decode(params, cfg: ModelConfig, tokens, positions,
                   caches: KVCache, rope=None):
    """Generation phase, one token per sequence. tokens: [B]; positions:
    [B] write positions (== current lengths). Returns (f32 logits [B, V],
    caches)."""
    x = embedding_lookup(params["embed"], tokens, cfg.torch_dtype)   # [B, D]
    cos_t, sin_t = _rope(cfg, rope, x.device)
    cos, sin = take_rope(cos_t, sin_t, positions.long())             # [B,1,d]
    x, caches = _run_layers(cfg, params, x, cos, sin, caches, positions, True)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return _logits(x, params), caches
