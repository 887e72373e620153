"""Paged KV cache on the device: block pool + block-table addressed
attention (the port's `ops/paged_attention.py`).

    pool_k/pool_v: [L, n_blocks, H_kv, block_size, D]

Each sequence owns a row of a block-index table [B, max_blocks] (emitted by
`runtime.kv_cache_manager.KVCacheManager.block_table()`). The pool's last
block is a trash block by convention: invalid table entries (-1) and
positions past a table redirect there, never into a live block. The port
updates the pools IN PLACE (the JAX functions return new pools; here the
returned `PagedKVCache` holds the same tensors, written). An int8 pool
stores clamp(round(x / scale[layer]), +-127), an fp8 pool (uint8 storage)
the e4m3 code of x / scale[layer], as the dense cache does.

`paged_fused_decode_attention_at` goes to kernel 14 (CUDA tensors) or its
plain version (CPU tensors); `paged_write_decode_at` and
`paged_decode_attention_at` are the plain write and read-only path of the
JAX package's XLA fallback, which no path of the port runs: the tests hold
them against the JAX package's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import str_dtype_to_torch
from .attention import _dequant_kv, _quant_kv
from .kernels import paged_decode_attention as _paged

NEG_INF = -1e9


class PagedKVCache(NamedTuple):
    """pool_k/pool_v: [L, NB, H, BS, D]; tables: [B, MB] int32 block indices
    (-1 pad); scale: [L] f32 (int8 / fp8 KV dequant scales, ones
    otherwise)."""

    pool_k: torch.Tensor
    pool_v: torch.Tensor
    tables: torch.Tensor
    scale: torch.Tensor


def init_paged_caches(cfg, n_blocks: int, block_size: int, batch: int,
                      max_blocks_per_seq: int, device,
                      kv_scales=None) -> PagedKVCache:
    """Zeroed pools in `cfg.kv_dtype` (the compute dtype, int8 with
    INT8_KV_CACHE, or e4m3 codes in uint8 with FP8_KV_CACHE) and an all -1
    table; kv_scales: optional [L] dequant scales (default 1.0)."""
    kv_dtype = str_dtype_to_torch(cfg.kv_dtype)
    shape = (cfg.num_layers, n_blocks, cfg.num_kv_heads, block_size,
             cfg.head_dim)
    if kv_scales is None:
        scale = torch.ones(cfg.num_layers, dtype=torch.float32, device=device)
    else:
        scale = torch.as_tensor(kv_scales, dtype=torch.float32, device=device)
    return PagedKVCache(
        torch.zeros(shape, dtype=kv_dtype, device=device),
        torch.zeros(shape, dtype=kv_dtype, device=device),
        torch.full((batch, max_blocks_per_seq), -1, dtype=torch.int32,
                   device=device),
        scale)


def _quant(x, cache: PagedKVCache, layer: int):
    """x as the pools store it (int8, fp8: true division by the layer's
    scale)."""
    return _quant_kv(x, cache.pool_k.dtype, cache.scale[layer])


def paged_write_prefill_at(cache: PagedKVCache, layer: int, k,
                           v) -> PagedKVCache:
    """Scatter a prompt's K/V ([B, S, H, D], S <= MB*BS) into each
    sequence's blocks, whole blocks at a time (the tail block's rows past S
    get zeros, as the JAX package pads). Invalid table entries (-1) go to
    the pool's last block, the trash block."""
    nb, h, bs, d = cache.pool_k.shape[1:]
    b, s = k.shape[:2]
    n_full = -(-s // bs)
    pad_s = n_full * bs - s
    tables = cache.tables[:, :n_full]
    flat_idx = torch.where(tables >= 0, tables, nb - 1).reshape(-1).long()
    for src, dst in ((k, cache.pool_k), (v, cache.pool_v)):
        if pad_s:
            src = torch.nn.functional.pad(src, (0, 0, 0, 0, 0, pad_s))
        # [B, n_full, BS, H, D] -> [B * n_full, H, BS, D]
        blocks = src.reshape(b, n_full, bs, h, d).transpose(2, 3)
        dst[layer, flat_idx] = _quant(blocks.reshape(b * n_full, h, bs, d),
                                      cache, layer)
    return cache


def paged_write_decode_at(cache: PagedKVCache, layer: int, k, v,
                          positions) -> PagedKVCache:
    """Write one token per sequence: k/v [B, H, D] at positions [B].
    Positions past the table, and -1 table entries, go to the trash
    block (`kernels.paged_decode_attention.write_rows`, the rule kernel 14
    and its plain version follow). No path of the port calls it: the
    engine's decode writes inside kernel 14."""
    for src, dst in ((k, cache.pool_k), (v, cache.pool_v)):
        _paged.write_rows(dst, layer, cache.tables, positions,
                          _quant(src, cache, layer))
    return cache


def paged_fused_decode_attention_at(q, k_new, v_new, cache: PagedKVCache,
                                    layer: int, positions,
                                    scale: Optional[float] = None):
    """Decode step over the paged cache: write k/v_new [B, H_kv, D] at
    `positions` and attend over positions+1 tokens (kernel 14; float, int8
    and fp8 pools). Returns (out, cache)."""
    out = _paged.paged_decode_attention(
        q, k_new, v_new, cache.pool_k, cache.pool_v, layer, cache.tables,
        positions, scale, kv_scale=cache.scale)
    return out, cache


def paged_decode_attention_at(q, cache: PagedKVCache, layer: int, cache_lens,
                              scale: Optional[float] = None):
    """Single-token attention over paged KV (plain, read-only): the JAX
    package's XLA path, kept as the reference the tests hold the paged
    layout to. No path of the port calls it (the engine's decode reads and
    writes in kernel 14). q: [B, H_q, D]; cache_lens: [B] valid positions.
    -1 table entries read block 0, as in the JAX package. K/V are
    dequantized to q's dtype and the probabilities cast to it before
    p @ v. Returns [B, H_q, D]."""
    _, nb, hkv, bs, d = cache.pool_k.shape
    b, hq, _ = q.shape
    mb = cache.tables.shape[1]
    sm = scale if scale is not None else d ** -0.5
    tables = cache.tables.clamp(min=0).long()                    # [B, MB]

    def gather(pool):             # [B, Hq, MB*BS, D] in q's dtype
        x = pool[layer][tables].permute(0, 2, 1, 3, 4)
        x = _dequant_kv(x.reshape(b, hkv, mb * bs, d), cache.scale[layer],
                        q.dtype)
        return x.repeat_interleave(hq // hkv, dim=1)
    logits = torch.einsum("bhd,bhkd->bhk", q.float(),
                          gather(cache.pool_k).float()) * sm
    mask = torch.arange(mb * bs, device=q.device)[None, :] < cache_lens[:, None]
    logits = torch.where(mask[:, None], logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhk,bhkd->bhd", probs.float(),
                       gather(cache.pool_v).float())
    return out.to(q.dtype)
