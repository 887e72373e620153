"""Attention ops: prefill (context) and decode (generation) phases, and the
stacked KV cache (the port's `ops/attention.py`).

KV cache layout: [L, B, H_kv, S_max, D] per k and v, as in the JAX package.
The port updates the cache IN PLACE (the JAX functions return a new cache;
here the returned `KVCache` is the same tensors, written). An int8 cache
stores clamp(round(x / scale[layer]), +-127) with one static scale per
layer and reads code * scale; an fp8 cache (uint8 storage) stores the e4m3
code of x / scale[layer] (`ops/fp8.py`, round to nearest even, saturated
at +-448) and reads the code's value * scale, as the JAX package's
_quant_kv / _dequant_kv.

Which kernel runs is chosen by the knobs of `ops/registry.KERNELS`, as in
the JAX package; whether it is the CUDA kernel or its plain version, by the
tensor's device inside the kernel wrapper. `prefill_attention` goes to the
streaming kernel (row 12) for prompts longer than
`prefill_streaming_min_s`, else to kernel 2, causal or not (`causal=False`:
each kernel's non-causal branch, where the JAX package sends every
non-causal call to XLA); `packed_prefill_attention` to
kernel 13; `fused_decode_attention_at` by `decode_attn_mode`: kernel 3 for
'auto', 'dma' and 'xla' at every cache length (the JAX package's switch
to its DMA kernel at S_max >= 4096 is a TPU crossover the port does not
copy, and its XLA path is not ported), the plain write and the read-only
kernel (row 8) for 'split', the one-launch kernel (row 9) for 'fused';
`decode_attention_at` to row 8 in every mode; `extend_attention_at` and
`write_kv_extend_at` (a T-token slab a sequence at per-row offsets:
chunked prefill, speculative verification) are stock torch, as the JAX
package's are stock XLA. Float, int8 and fp8 caches
alike: the JAX package sends an fp8 cache to its XLA path in every mode,
the port to the same kernels. `decode_attention` is the
plain read-only reference of one layer. The paged cache is in
`ops/paged_attention.py`.

Every attention kernel is instantiated for the head dims 32, 64, 96, 128
and 256 (every model the port runs) and f32, bf16 and fp16; on the card a
call outside them raises.

ALiBi (`alibi`: [H_q] slopes from `alibi_slopes`) adds slope * key position
to the scaled scores: the prefill kernels (2 and 12) take the slopes; a
decode step with slopes takes the JAX package's own branch, the plain
write and the plain `decode_attention` over positions + 1 in every
decode_attn_mode (its decode kernels carry no bias, and neither do the
port's), counted in `fused_decode_attention_at.alibi_calls`.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .kernels import decode_attention as _decode
from .kernels import packed_prefill_attention as _packed
from .kernels import prefill_attention as _prefill
from .kernels import streaming_prefill_attention as _streaming
from .registry import KERNELS

NEG_INF = -1e9


class KVCache(NamedTuple):
    """Stacked cache: k, v [L, B, H_kv, S_max, D]; scale [L] f32 (the int8
    or fp8 dequant scale, 1.0 for float caches)."""

    k: torch.Tensor
    v: torch.Tensor
    scale: torch.Tensor


# x as a cache of `cache_dtype` stores it, `scale` the layer's dequant scale
# (int8 and fp8 only; true division in f32): the kernels' codec
_quant_kv = _decode.kv_encode


def _dequant_kv(x, scale, dtype):
    """Stored cache rows x back as `dtype` (int8: x * scale, fp8: the e4m3
    value * scale, in f32, then rounded to `dtype`)."""
    return _decode.kv_decode(x, scale).to(dtype)


def write_kv_prefill_at(cache: KVCache, layer: int, k, v,
                        slots=None) -> KVCache:
    """Write [B, S, H_kv, D] k/v into layer `layer` at rows [0, S) of
    cache rows 0..B-1, or of cache rows `slots` [B] when given."""
    s = k.shape[1]
    rows = slice(None) if slots is None else slots.long()
    for src, dst in ((k, cache.k), (v, cache.v)):
        dst[layer, rows, :, :s] = _quant_kv(src.transpose(1, 2), dst.dtype,
                                            cache.scale[layer])
    return cache


def write_kv_decode_at(cache: KVCache, layer: int, k, v, positions) -> KVCache:
    """Write one token per sequence: k/v [B, H_kv, D] at positions [B]; a
    position >= S_max writes nothing (the JAX package's scatter drops it)."""
    for src, dst in ((k, cache.k), (v, cache.v)):
        _decode.write_rows(dst[layer], positions.long(),
                           _quant_kv(src, dst.dtype, cache.scale[layer]))
    return cache


def write_kv_extend_at(cache: KVCache, layer: int, k, v, start,
                       slots=None) -> KVCache:
    """Write a T-token slab per sequence: k/v [B, T, H_kv, D], row (b, i)
    at position start[b] + i of cache row b, or of cache row slots[b] when
    given. A position >= S_max writes nothing (the JAX package's scatter
    drops it); no host sync: a dropped row rewrites position start[b] - 1,
    which the slab does not write, with its own value."""
    b, t = k.shape[:2]
    s = cache.k.shape[3]
    if t > s:
        raise ValueError(f"a slab of {t} tokens exceeds the cache's {s} rows")
    pos = start.long()[:, None] + torch.arange(t, device=k.device)[None]
    keep = pos < s                                            # [B, T]
    at = torch.where(keep, pos, start.long()[:, None] - 1)
    rows = (torch.arange(b, device=k.device) if slots is None
            else slots.long())[:, None].expand(b, t)
    for src, dst in ((k, cache.k), (v, cache.v)):
        new = _quant_kv(src, dst.dtype, cache.scale[layer])    # [B, T, H, D]
        dst[layer, rows, :, at] = torch.where(
            keep[..., None, None], new, dst[layer, rows, :, at])
    return cache


def extend_attention_at(q, cache: KVCache, layer: int, start, k_new=None,
                        v_new=None, scale: Optional[float] = None,
                        alibi=None, slots=None):
    """Causal attention of a T-token slab against layer `layer`: q
    [B, T, H_q, D]; row (b, i) sits at position start[b] + i of cache row b
    (or slots[b]) and attends positions <= start[b] + i. alibi: optional
    [H_q] slopes (slope * key position added to the scaled scores).
    Returns [B, T, H_q, D].

    With k_new / v_new ([B, T, H_kv, D], rope applied) the cache is read
    before the slab is written: rows strictly below start[b] come from the
    cache, and the T in-flight rows attend each other causally after a
    round trip through the cache codec (encode, then decode), so the
    logits match a decode that later reads the same rows; the caller
    writes the slab (write_kv_extend_at) after this call. Without them the
    slab must already be written.

    Stock ops, as the JAX package's XLA path (no Pallas kernel): K/V read
    in q's dtype, scores, softmax and P V in f32. The JAX package rounds P
    to q's dtype before P V; at f32 the two are the same."""
    b, t, hq, d = q.shape
    rows = slice(None) if slots is None else slots.long()
    kc, vc = cache.k[layer, rows], cache.v[layer, rows]      # [B, Hkv, S, D]
    hkv, s_max = kc.shape[1], kc.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    kv_scale = cache.scale[layer]

    def deq(x):                                  # [B, Hkv, S, D] -> f32
        return _dequant_kv(x, kv_scale, q.dtype).float()

    qg = q.float().reshape(b, t, hkv, g, d)
    logits = torch.einsum("btkgd,bksd->bkgts", qg, deq(kc)).reshape(
        b, hq, t, s_max) * scale
    rows_pos = start.long()[:, None] + torch.arange(t, device=q.device)[None]
    cols = torch.arange(s_max, device=q.device)
    if alibi is not None:
        logits = logits + alibi.float().reshape(1, hq, 1, 1) * cols.float()
    if k_new is None:
        mask = cols[None, None] <= rows_pos[:, :, None]             # [B, T, S]
        logits = torch.where(mask[:, None], logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1).reshape(b, hkv, g, t, s_max)
        out = torch.einsum("bkgts,bksd->btkgd", probs, deq(vc))
        return out.reshape(b, t, hq, d).to(q.dtype)
    mask_old = cols[None, None, None] < start.long()[:, None, None, None]
    logits = torch.where(mask_old, logits, NEG_INF)

    def round_trip(x):                           # [B, T, Hkv, D] -> f32
        x = x.transpose(1, 2)
        return deq(_quant_kv(x, kc.dtype, kv_scale))

    kn, vn = round_trip(k_new), round_trip(v_new)            # [B, Hkv, T, D]
    logits_n = torch.einsum("btkgd,bkud->bkgtu", qg, kn).reshape(
        b, hq, t, t) * scale
    if alibi is not None:
        # in-flight token u sits at key position start[b] + u
        logits_n = logits_n + (alibi.float().reshape(1, hq, 1, 1)
                               * rows_pos.float()[:, None, None, :])
    causal = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    logits_n = torch.where(causal, logits_n, NEG_INF)
    probs = torch.softmax(torch.cat([logits, logits_n], dim=-1), dim=-1)
    p_old = probs[..., :s_max].reshape(b, hkv, g, t, s_max)
    p_new = probs[..., s_max:].reshape(b, hkv, g, t, t)
    out = (torch.einsum("bkgts,bksd->btkgd", p_old, deq(vc))
           + torch.einsum("bkgtu,bkud->btkgd", p_new, vn))
    return out.reshape(b, t, hq, d).to(q.dtype)


class PackedMeta(NamedTuple):
    """Remove-padding prefill metadata. All [T]: seg_ids (-1 pad), slot_tok
    (cache row per token; pads -> the trash slot), pos_tok (position within
    its own sequence)."""

    seg_ids: torch.Tensor
    slot_tok: torch.Tensor
    pos_tok: torch.Tensor


def write_kv_packed_at(cache: KVCache, layer: int, k, v, slot_tok,
                       pos_tok) -> KVCache:
    """Scatter packed rows: k/v [T, H_kv, D]; token t goes to
    (layer, slot_tok[t], :, pos_tok[t]). Pad tokens must point at a trash
    slot row."""
    slot, pos = slot_tok.long(), pos_tok.long()
    for src, dst in ((k, cache.k), (v, cache.v)):
        dst[layer, slot, :, pos] = _quant_kv(src, dst.dtype, cache.scale[layer])
    return cache


def alibi_slopes(n_heads: int, device="cpu") -> torch.Tensor:
    """Per-head ALiBi slopes (Press et al.), as the JAX package computes
    them: m_i = 2^(-8(i+1)/n) for a power-of-two head count, else the
    closest power of two's slopes followed by every other slope of twice
    that count. Returns [n_heads] f32."""
    def pow2_slopes(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start ** i) for i in range(n)]

    if math.log2(n_heads).is_integer():
        out = pow2_slopes(n_heads)
    else:
        base = 2 ** math.floor(math.log2(n_heads))
        out = pow2_slopes(base) + pow2_slopes(2 * base)[0::2][:n_heads - base]
    return torch.tensor(out, dtype=torch.float32, device=device)


def prefill_attention(q, k, v, seq_lens=None, scale: Optional[float] = None,
                      alibi=None, causal: bool = True):
    """Self-attention over a prompt, causal, or with `causal=False`
    bidirectional (the encoder's and ChatGLM's prefix-LM context: the
    length mask alone, every row computed, pad rows included; a length of
    0 averages V over all S, as the JAX package's XLA path). q: [B, S,
    H_q, D]; k, v: [B, S, H_kv, D]; seq_lens: optional [B] valid lengths
    (keys at positions >= len are masked); alibi: optional [H_q] slopes
    (slope * key position added to the scaled scores). Prompts of more rows
    than KERNELS['prefill_streaming_min_s'] (None: 2048; 0 sends every
    prompt) go to the streaming kernel, shorter ones to kernel 2, whatever
    `causal`. Returns [B, S, H_q, D]."""
    min_s = KERNELS["prefill_streaming_min_s"]
    kernel = (_streaming.streaming_prefill_attention_kernel
              if q.shape[1] > (2048 if min_s is None else min_s)
              else _prefill.prefill_attention_kernel)
    kw = {} if alibi is None else {"alibi": alibi}
    if not causal:
        kw["causal"] = False
    return kernel(q, k, v, seq_lens, scale, **kw)


def packed_prefill_attention(q, k, v, seg_ids, scale: Optional[float] = None):
    """Packed (remove-padding) causal attention over concatenated sequences
    (kernel 13): position i attends j iff both share a segment id and
    j <= i. q: [T, H_q, D]; k, v: [T, H_kv, D]; seg_ids: [T] int32 (pad rows
    -1). Returns [T, H_q, D] (pad rows undefined)."""
    return _packed.packed_prefill_attention_kernel(q, k, v, seg_ids, scale)


def fused_decode_attention_at(q, k_new, v_new, cache: KVCache, layer: int,
                              positions, scale: Optional[float] = None,
                              alibi=None):
    """Decode step for layer `layer`: write k/v_new [B, H_kv, D] at
    `positions` [B] and attend q [B, H_q, D] over rows <= positions.
    Returns (attn_out [B, H_q, D], cache). The kernel follows
    KERNELS['decode_attn_mode'] (see the module note; an unknown mode
    raises ValueError). With an int8 or fp8 cache every mode keeps the
    dequantized K/V in f32 (as the JAX package's Pallas kernels keep int8
    ones); its XLA path, where it runs every fp8 cache, rounds them to q's
    dtype first, which is the same at f32. With `alibi` ([H_q] slopes) every
    mode takes the JAX package's ALiBi branch: the plain write, then the
    plain `decode_attention` with the bias."""
    mode = KERNELS["decode_attn_mode"]
    if mode not in ("auto", "dma", "xla", "split", "fused"):
        raise ValueError(f"unknown decode_attn_mode {mode!r}: expected "
                         "'auto', 'dma', 'xla', 'split' or 'fused'")
    if alibi is not None:
        fused_decode_attention_at.alibi_calls += 1
        cache = write_kv_decode_at(cache, layer, k_new, v_new, positions)
        out = decode_attention(q, cache.k[layer], cache.v[layer],
                               positions + 1, scale, cache.scale[layer],
                               alibi)
        return out, cache
    args = (q, k_new, v_new, cache.k, cache.v, layer, positions, scale)
    if mode in ("auto", "dma", "xla"):
        out = _decode.dma_decode_attention(*args, kv_scale=cache.scale)
    elif mode == "fused":
        out = _decode.fused_decode_attention(*args, kv_scale=cache.scale)
    else:
        cache = write_kv_decode_at(cache, layer, k_new, v_new, positions)
        out = decode_attention_at(q, cache, layer, positions + 1, scale)
    return out, cache


fused_decode_attention_at.alibi_calls = 0


def decode_attention_at(q, cache: KVCache, layer: int, cache_lens,
                        scale: Optional[float] = None):
    """Read-only decode attention of q [B, H_q, D] against layer `layer` of
    the stacked cache, rows < cache_lens [B] (row 8, in every
    decode_attn_mode and for every cache kind; the JAX package runs its
    kernel only in the Pallas modes for non-fp8 caches, and XLA otherwise).
    Returns [B, H_q, D]."""
    return _decode.decode_attention_kernel(q, cache.k, cache.v, layer,
                                           cache_lens, scale,
                                           kv_scale=cache.scale)


def decode_attention(q, k_cache, v_cache, cache_lens,
                     scale: Optional[float] = None, kv_scale=None,
                     alibi=None):
    """Single-token attention against ONE layer's cache [B, H_kv, S, D]
    (already written): keys at positions < cache_lens[b]; an int8 or fp8
    cache is dequantized with that layer's `kv_scale` and rounded to q's
    dtype;
    alibi: optional [H_q] slopes (f32 slope * key position added to the
    scaled scores before the mask). The probabilities are cast to q's dtype
    before p @ v, as in the JAX package's XLA path. Returns [B, H_q, D]."""
    b, hq, d = q.shape
    hkv, s = k_cache.shape[1], k_cache.shape[2]
    scale = scale if scale is not None else d ** -0.5
    kt = _dequant_kv(k_cache, kv_scale, q.dtype).repeat_interleave(hq // hkv,
                                                                   dim=1)
    vt = _dequant_kv(v_cache, kv_scale, q.dtype).repeat_interleave(hq // hkv,
                                                                   dim=1)
    logits = torch.einsum("bhd,bhsd->bhs", q.float(), kt.float()) * scale
    cols = torch.arange(s, device=q.device)
    if alibi is not None:
        logits = logits + alibi.float().reshape(1, hq, 1) * cols.float()
    mask = cols[None, :] < cache_lens[:, None]
    logits = torch.where(mask[:, None], logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhs,bhsd->bhd", probs.float(), vt.float())
    return out.to(q.dtype)
