"""Decoder-only model families: GPT-J, GPT-NeoX, Bloom, OPT and Falcon
(the port's `models/decoder.py`); `models/gpt.py` runs GPT-2 on the same
block.

One block, wired by a static `ArchSpec`, covers the five families, as in
the JAX package: the spec picks the rotary convention (none, GPT-J's
interleaved pairs or NeoX's half-split, on `cfg.rotary_dim` dims), ALiBi
(Bloom), a learned position table (OPT, rows offset by 2), one LayerNorm
feeding both branches (GPT-J, Falcon), a parallel residual, an embedding
LayerNorm (Bloom), the MLP activation, which biases exist and a fixed
LayerNorm eps (GPT-2's 1e-5; else cfg.rms_norm_eps). Falcon's
multi-query attention is `cfg.num_kv_heads = 1` through the shared GQA
attention ops.

Params are a plain dict with the JAX package's keys and shapes: `embed`
[V, D]; `layers` (stacked [L, ...]): ln1_w/ln1_b, [ln2_w/ln2_b], wq/wk/wv,
wo, [bq/bk/bv], [bo], w_fc/b_fc, w_proj/b_proj; final_ln_w/final_ln_b;
`lm_head` [D, V]; [pos_embed]; [emb_ln_w/emb_ln_b]; [lm_head_b, f32]. The
projections may be tensors or the quantized containers `ops.linear.dense`
dispatches on (`quantization.quantize.quantize_params` rewrites w_fc and
w_proj as it does llama's). The KV cache is llama's stacked `KVCache`;
the layer loop is a Python loop over the stacked weights. Prefill
attention goes to kernel 2 or row 12 (with the ALiBi slopes for Bloom);
decode attention to `decode_attn_mode`'s kernel, or for Bloom the JAX
package's own plain ALiBi branch (`ops.attention.fused_decode_attention_at`);
`forward_extend`'s slab attention is stock torch (`extend_attention_at`),
as the JAX package's is stock XLA.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import ModelConfig
from ..device import resolve_device
from ..ops.attention import (KVCache, alibi_slopes, extend_attention_at,
                             fused_decode_attention_at, prefill_attention,
                             write_kv_extend_at, write_kv_prefill_at)
from ..ops.linear import dense, embedding_lookup, prompt_tuning_lookup
from ..ops.norm import layer_norm
from ..ops.rope import (apply_rope, apply_rope_interleaved, rope_table,
                        rope_table_interleaved, take_rope)
from . import llama


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    """Static block-wiring description of a decoder family."""

    name: str
    rope: str = "none"             # none | neox (half-split) | interleaved
    alibi: bool = False
    learned_pos: bool = False      # learned absolute position table
    pos_offset: int = 0            # OPT: table row = position + 2
    parallel_residual: bool = False  # x + attn(ln(x)) + mlp(...)
    shared_ln: bool = False        # GPT-J, Falcon: MLP input is ln1's output
    embed_ln: bool = False         # Bloom: LayerNorm after word embedding
    act: str = "gelu_tanh"         # gelu_tanh | gelu | relu
    qkv_bias: bool = True
    attn_out_bias: bool = True
    lm_head_bias: bool = False
    ln_eps: float = 0.0            # LayerNorm eps; 0: cfg.rms_norm_eps


GPTJ_SPEC = ArchSpec("gptj", rope="interleaved", parallel_residual=True,
                     shared_ln=True, qkv_bias=False, attn_out_bias=False,
                     lm_head_bias=True)
GPTNEOX_SPEC = ArchSpec("gptneox", rope="neox", parallel_residual=True,
                        act="gelu")
BLOOM_SPEC = ArchSpec("bloom", alibi=True, embed_ln=True)
OPT_SPEC = ArchSpec("opt", learned_pos=True, pos_offset=2, act="relu")
FALCON_SPEC = ArchSpec("falcon", rope="neox", parallel_residual=True,
                       shared_ln=True, act="gelu", qkv_bias=False,
                       attn_out_bias=False)


def _act(spec: ArchSpec, x):
    """The MLP activation in f32, cast back to x's dtype."""
    xf = x.float()
    if spec.act == "relu":
        y = torch.relu(xf)
    elif spec.act == "gelu":
        y = torch.nn.functional.gelu(xf)
    else:
        y = torch.nn.functional.gelu(xf, approximate="tanh")
    return y.to(x.dtype)


def _rotary_dim(cfg: ModelConfig) -> int:
    return cfg.rotary_dim or cfg.head_dim


def _apply_rope(spec: ArchSpec, cfg: ModelConfig, x, cos, sin):
    rd = _rotary_dim(cfg)
    if spec.rope == "interleaved":
        return apply_rope_interleaved(x, cos, sin, rd)
    if rd == x.shape[-1]:
        return apply_rope(x, cos, sin)
    return torch.cat([apply_rope(x[..., :rd], cos, sin), x[..., rd:]], dim=-1)


class DecoderFamily:
    """Model-protocol object (init_params / init_caches / rope_tables /
    forward_prefill / forward_extend / forward_decode) for one ArchSpec;
    `runtime.session.GenerationSession` and `runtime.serving.ServingEngine`
    take it as `model=` (dense caches only: no paged pool, no packed
    prefill)."""

    def __init__(self, spec: ArchSpec):
        self.spec = spec
        self.__name__ = f"decoder.{spec.name}"

    # -- parameters ----------------------------------------------------
    def init_params(self, cfg: ModelConfig, seed: int = 0, device="cuda",
                    dtype=None):
        """Random params with the JAX package's keys and shapes on `device`,
        drawn from a torch.Generator seeded with `seed` there: projections,
        embedding, lm_head and position table normal * fan_in**-0.5 in the
        compute dtype, unit LayerNorm weights, zero biases. The random
        streams differ from JAX's."""
        spec = self.spec
        device = resolve_device(device)
        dtype = dtype or cfg.torch_dtype
        gen = torch.Generator(device=device).manual_seed(seed)
        d, n_l, f = cfg.hidden_size, cfg.num_layers, cfg.intermediate_size
        nq, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

        def w(shape, fan_in):
            return torch.randn(shape, generator=gen, device=device,
                               dtype=dtype).mul_(fan_in ** -0.5)

        def const(shape, value, dt=dtype):
            return torch.full(shape, value, device=device, dtype=dt)

        layers = {
            "ln1_w": const((n_l, d), 1.0), "ln1_b": const((n_l, d), 0.0),
            "wq": w((n_l, d, nq * hd), d),
            "wk": w((n_l, d, nkv * hd), d),
            "wv": w((n_l, d, nkv * hd), d),
            "wo": w((n_l, nq * hd, d), d),
            "w_fc": w((n_l, d, f), d), "b_fc": const((n_l, f), 0.0),
            "w_proj": w((n_l, f, d), f), "b_proj": const((n_l, d), 0.0),
        }
        if not spec.shared_ln:
            layers["ln2_w"] = const((n_l, d), 1.0)
            layers["ln2_b"] = const((n_l, d), 0.0)
        if spec.qkv_bias:
            layers["bq"] = const((n_l, nq * hd), 0.0)
            layers["bk"] = const((n_l, nkv * hd), 0.0)
            layers["bv"] = const((n_l, nkv * hd), 0.0)
        if spec.attn_out_bias:
            layers["bo"] = const((n_l, d), 0.0)
        params = {
            "embed": w((cfg.vocab_size, d), d),
            "layers": layers,
            "final_ln_w": const((d,), 1.0),
            "final_ln_b": const((d,), 0.0),
            "lm_head": w((d, cfg.vocab_size), d),
        }
        if spec.learned_pos:
            params["pos_embed"] = w(
                (cfg.max_position_embeddings + spec.pos_offset, d), d)
        if spec.embed_ln:
            params["emb_ln_w"] = const((d,), 1.0)
            params["emb_ln_b"] = const((d,), 0.0)
        if spec.lm_head_bias:
            params["lm_head_b"] = const((cfg.vocab_size,), 0.0, torch.float32)
        return params

    def init_caches(self, cfg: ModelConfig, batch: int, max_len: int, device,
                    kv_scales=None) -> KVCache:
        return llama.init_caches(cfg, batch, max_len, device, kv_scales)

    def rope_tables(self, cfg: ModelConfig, device="cpu"):
        """(cos, sin) [max_position_embeddings, rotary_dim] f32 tables of
        the spec's convention, or None for a family without rotary."""
        rd = _rotary_dim(cfg)
        if self.spec.rope == "interleaved":
            return rope_table_interleaved(cfg.max_position_embeddings, rd,
                                          cfg.rope_theta, device=device)
        if self.spec.rope == "neox":
            return rope_table(cfg.max_position_embeddings, rd, cfg.rope_theta,
                              device=device)
        return None

    # -- blocks --------------------------------------------------------
    def _block(self, cfg, lw, layer, x, cos, sin, alibi, caches, seq_lens,
               decode, slots=None, extend=None):
        spec = self.spec
        eps = spec.ln_eps or cfg.rms_norm_eps

        def proj(h, wname, bname, n_heads):
            y = dense(h, lw[wname], layer=layer)
            if bname in lw:
                y = y + lw[bname][layer]
            return y.reshape(*y.shape[:-1], n_heads, cfg.head_dim)

        h1 = layer_norm(x, lw["ln1_w"][layer], lw["ln1_b"][layer], eps)
        q = proj(h1, "wq", "bq", cfg.num_heads)
        k = proj(h1, "wk", "bk", cfg.num_kv_heads)
        v = proj(h1, "wv", "bv", cfg.num_kv_heads).contiguous()
        if spec.rope != "none":
            q = _apply_rope(spec, cfg, q, cos, sin)
            k = _apply_rope(spec, cfg, k, cos, sin)
        q, k = q.contiguous(), k.contiguous()
        if extend is not None:
            # a slab at per-row offsets (chunked prefill, speculative
            # verification): llama.forward_extend's semantics
            attn = extend_attention_at(q, caches, layer, extend, k, v,
                                       alibi=alibi, slots=slots)
            caches = write_kv_extend_at(caches, layer, k, v, extend, slots)
        elif decode:
            attn, caches = fused_decode_attention_at(q, k, v, caches, layer,
                                                     seq_lens, alibi=alibi)
        else:
            caches = write_kv_prefill_at(caches, layer, k, v, slots)
            attn = prefill_attention(q, k, v, seq_lens, alibi=alibi)
        attn = attn.reshape(*attn.shape[:-2], cfg.num_heads * cfg.head_dim)
        attn = dense(attn, lw["wo"], layer=layer)
        if "bo" in lw:
            attn = attn + lw["bo"][layer]

        def mlp(h):
            h = dense(h, lw["w_fc"], layer=layer) + lw["b_fc"][layer]
            h = _act(spec, h)
            return dense(h, lw["w_proj"], layer=layer) + lw["b_proj"][layer]

        if spec.parallel_residual:
            mlp_in = h1 if spec.shared_ln else layer_norm(
                x, lw["ln2_w"][layer], lw["ln2_b"][layer], eps)
            return x + attn + mlp(mlp_in), caches
        x = x + attn
        h2 = layer_norm(x, lw["ln2_w"][layer], lw["ln2_b"][layer], eps)
        return x + mlp(h2), caches

    def _run(self, params, cfg, ids, positions, seq_lens, caches, decode,
             rope, slots=None, extend=None, prompt=None):
        """Embedding (through the prompt table for a prompt-tuning
        `prompt`), the layers and the final LayerNorm: [..., D]. A learned
        position past the table reads its last row, as take_rope does."""
        spec = self.spec
        eps = spec.ln_eps or cfg.rms_norm_eps
        if prompt is None:
            x = embedding_lookup(params["embed"], ids, cfg.torch_dtype)
        else:
            x = prompt_tuning_lookup(params["embed"], prompt.table, ids,
                                     prompt.tasks, prompt.task_vocab_size,
                                     cfg.vocab_size, cfg.torch_dtype)
        if spec.learned_pos:
            table = params["pos_embed"]
            x = x + embedding_lookup(
                table, (positions + spec.pos_offset).clamp(
                    max=table.shape[0] - 1), cfg.torch_dtype)
        if spec.embed_ln:
            x = layer_norm(x, params["emb_ln_w"], params["emb_ln_b"], eps)
        cos = sin = None
        if spec.rope != "none":
            tables = rope if rope is not None else self.rope_tables(
                cfg, x.device)
            cos, sin = take_rope(*tables, positions)
        alibi = (alibi_slopes(cfg.num_heads, device=x.device) if spec.alibi
                 else None)
        for layer in range(cfg.num_layers):
            x, caches = self._block(cfg, params["layers"], layer, x, cos, sin,
                                    alibi, caches, seq_lens, decode, slots,
                                    extend)
        x = layer_norm(x, params["final_ln_w"], params["final_ln_b"], eps)
        return x, caches

    def _head(self, params, x):
        logits = dense(x, params["lm_head"], torch.float32)
        if "lm_head_b" in params:
            logits = logits + params["lm_head_b"]
        return logits

    # -- forward -------------------------------------------------------
    def forward_prefill(self, params, cfg: ModelConfig, input_ids, seq_lens,
                        caches: KVCache, return_all_logits: bool = False,
                        rope=None, slots=None, prompt=None):
        """Context phase. input_ids: [B, S] left-aligned (padded right),
        seq_lens [B]. Returns (f32 logits [B, V] at each sequence's last
        position, or [B, S, V] with return_all_logits, caches). `rope`:
        optional precomputed tables (`rope_tables`); `slots`: optional [B]
        cache rows that take the K/V (the serving engine's), default
        0..B-1; `prompt`: a `models.gpt.PromptTuning` for virtual ids
        (>= vocab_size) in input_ids (the reference gives it to GPT)."""
        b, s = input_ids.shape
        pos = torch.arange(s, device=input_ids.device)[None].expand(b, s)
        x, caches = self._run(params, cfg, input_ids, pos, seq_lens, caches,
                              False, rope, slots, prompt=prompt)
        if return_all_logits:
            return self._head(params, x), caches
        last = x[torch.arange(b, device=x.device), seq_lens.long() - 1]
        return self._head(params, last), caches

    def forward_extend(self, params, cfg: ModelConfig, tokens, start,
                       caches: KVCache, rope=None, slots=None):
        """Multi-token generation slab: tokens [B, T], row (b, i) at position
        start[b] + i of cache row b (or slots[b]), llama.forward_extend's
        contract. Returns (f32 logits [B, T, V], caches)."""
        t = tokens.shape[1]
        pos = (start.long()[:, None]
               + torch.arange(t, device=tokens.device)[None])
        x, caches = self._run(params, cfg, tokens, pos, None, caches, False,
                              rope, slots, start)
        return self._head(params, x), caches

    def forward_decode(self, params, cfg: ModelConfig, tokens, positions,
                       caches: KVCache, rope=None):
        """Generation phase, one token per sequence. tokens: [B]; positions:
        [B] write positions. Returns (f32 logits [B, V], caches)."""
        x, caches = self._run(params, cfg, tokens, positions.long(),
                              positions, caches, True, rope)
        return self._head(params, x), caches


GPTJ = DecoderFamily(GPTJ_SPEC)
GPTNEOX = DecoderFamily(GPTNEOX_SPEC)
BLOOM = DecoderFamily(BLOOM_SPEC)
OPT = DecoderFamily(OPT_SPEC)
FALCON = DecoderFamily(FALCON_SPEC)
