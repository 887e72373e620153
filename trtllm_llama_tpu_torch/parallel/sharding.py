"""Tensor-parallel parameter shards: the JAX package's
`parallel/sharding.py` layout, held per rank.

The JAX package gives every parameter leaf a PartitionSpec (`_leaf_spec`)
and GSPMD materialises the shards. `shard_params(params, mapping, rank)`
cuts the same shards for one rank, leaf for leaf:

  wq/wk/wv, w_gate/w_up (column-parallel): qweight and the per-channel or
      grouped scale split on their last axis (N);
  wo, w_down (row-parallel): qweight split on its K axis (the packed K/2
      axis of int4), a grouped scale [L, K/g, N] on K/g, a per-channel
      scale replicated;
  SmoothQuant scale_x / scale_y: replicated (a per-tensor scale_w [L, 1]
      too: it holds no column);
  lm_head: split over the vocabulary (its last axis, every leaf);
  embed and the norms: replicated.

Two layouts are block-local along K, so a row shard that cuts a block is
re-laid: an int4 shard is repacked with a pack block dividing its K (the
grouped case keeps its group; its K must be whole groups), an fp8 shard
re-interleaved with the largest block of 128 / 64 / 32 / 16 / 8 dividing
its K (0, logical order, if none). Whole blocks, as at every real shape
(K >= 4096, blocks of 128), slice as they are. The fused `wqkv` /
`w_gate_up` are never sharded: under tp > 1 the sessions do not fuse.

`local_config(cfg, tp)` is the config a rank's model code runs: its heads
(`num_heads / tp`, `num_kv_heads / tp`; `head_dim` stays), so the attention
splits and the KV cache hold the local heads.
"""

from __future__ import annotations

import dataclasses

from ..config import ModelConfig
from ..quantization.tensors import (FP8Weight, SQWeight, WOQWeight,
                                    deinterleave_fp8_rows, interleave_fp8_rows,
                                    pack_int4, unpack_int4)

COL_KEYS = ("wq", "wk", "wv", "w_gate", "w_up")
ROW_KEYS = ("wo", "w_down")
FUSED_KEYS = ("wqkv", "w_gate_up")
_BLOCKS = (128, 64, 32, 16, 8)


def local_config(cfg: ModelConfig, tp: int) -> ModelConfig:
    """cfg with this rank's heads. Raises when the heads or the vocabulary
    do not divide by tp."""
    if tp == 1:
        return cfg
    if cfg.num_heads % tp or cfg.num_kv_heads % tp or cfg.vocab_size % tp:
        raise ValueError(
            f"tp={tp} must divide num_heads ({cfg.num_heads}), num_kv_heads "
            f"({cfg.num_kv_heads}) and vocab_size ({cfg.vocab_size})")
    return dataclasses.replace(cfg, num_heads=cfg.num_heads // tp,
                               num_kv_heads=cfg.num_kv_heads // tp)


def _split(t, axis: int, tp: int, rank: int):
    """Shard `rank` of tp equal parts of t along axis, contiguous."""
    n = t.shape[axis]
    if n % tp:
        raise ValueError(f"cannot split axis {axis} of {tuple(t.shape)} "
                         f"into {tp} shards")
    step = n // tp
    return t.narrow(axis, rank * step, step).contiguous()


def _largest_block(k: int) -> int:
    return next((b for b in _BLOCKS if k % b == 0), 0)


def _row_int4(w: WOQWeight, tp: int, rank: int) -> WOQWeight:
    k_local = w.k_dim // tp
    if w.group_size:
        if k_local % w.group_size:
            raise ValueError(f"int4 row shard: K/tp = {k_local} is not whole "
                             f"groups of {w.group_size}")
        block = w.group_size
    else:
        block = (w.pack_block if k_local % w.pack_block == 0
                 else _largest_block(k_local))
        if not block:
            raise ValueError(f"int4 row shard: K/tp = {k_local} is not a "
                             "multiple of 8")
    if block == w.pack_block:
        q = _split(w.qweight, -2, tp, rank)
    else:       # a shard that cuts a pack block: repack its logical rows
        q = pack_int4(_split(unpack_int4(w.qweight, w.pack_block), -2, tp,
                             rank), block).contiguous()
    scale = _split(w.scale, -2, tp, rank) if w.group_size else w.scale
    return WOQWeight(q, scale, w.w_bits, w.group_size, block)


def _row_fp8(w: FP8Weight, tp: int, rank: int) -> FP8Weight:
    ib = w.interleave_block
    k_local = w.k_dim // tp
    if not ib or k_local % ib == 0:
        return FP8Weight(_split(w.qweight, -2, tp, rank), w.scale, ib)
    # a shard that cuts an interleave block: re-interleave its logical rows
    q = _split(deinterleave_fp8_rows(w.qweight, ib), -2, tp, rank)
    block = _largest_block(k_local)
    if block:
        q = interleave_fp8_rows(q, block).contiguous()
    return FP8Weight(q, w.scale, block)


def _shard_col(w, tp: int, rank: int):
    if isinstance(w, (WOQWeight, FP8Weight)):
        return dataclasses.replace(w, qweight=_split(w.qweight, -1, tp, rank),
                                   scale=_split(w.scale, -1, tp, rank))
    if isinstance(w, SQWeight):
        sw = (_split(w.scale_w, -1, tp, rank) if w.scale_w.shape[-1] > 1
              else w.scale_w)
        return dataclasses.replace(w, qweight=_split(w.qweight, -1, tp, rank),
                                   scale_w=sw)
    return _split(w, -1, tp, rank)


def _shard_row(w, tp: int, rank: int):
    if isinstance(w, WOQWeight):
        if w.w_bits == 4:
            return _row_int4(w, tp, rank)
        scale = _split(w.scale, -2, tp, rank) if w.group_size else w.scale
        if w.group_size and (w.k_dim // tp) % w.group_size:
            raise ValueError(f"row shard: K/tp = {w.k_dim // tp} is not "
                             f"whole groups of {w.group_size}")
        return dataclasses.replace(w, qweight=_split(w.qweight, -2, tp, rank),
                                   scale=scale)
    if isinstance(w, FP8Weight):
        return _row_fp8(w, tp, rank)
    if isinstance(w, SQWeight):
        return dataclasses.replace(w, qweight=_split(w.qweight, -2, tp, rank))
    return _split(w, -2, tp, rank)


def shard_params(params, mapping, rank: int):
    """This rank's shards of the full params (a new dict; leaves that stay
    replicated are the same tensors)."""
    tp = mapping.tp
    if tp == 1:
        return params
    if not 0 <= rank < tp:
        raise ValueError(f"rank {rank} outside tp={tp}")
    out = {}
    for key, leaf in params.items():
        if key == "layers":
            layers = {}
            for name, w in leaf.items():
                if name in FUSED_KEYS:
                    raise ValueError(f"{name}: fused projections are not "
                                     "sharded; shard the unfused params")
                layers[name] = (_shard_col(w, tp, rank) if name in COL_KEYS
                                else _shard_row(w, tp, rank)
                                if name in ROW_KEYS else w)
            out[key] = layers
        elif key == "lm_head":
            out[key] = _shard_col(leaf, tp, rank)
        else:
            out[key] = leaf
    return out

