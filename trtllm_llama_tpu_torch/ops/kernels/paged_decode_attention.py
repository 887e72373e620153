"""Row 14: paged decode attention with the in-place KV write
(csrc/paged_decode_attention.cu on the split-cache body of
csrc/flash_decode.cuh, kernel 3's, with its paged row addressing).

Replaces `trtllm_llama_tpu/ops/pallas/paged_decode_attention.py::
paged_decode_attention`, for bf16/f32 pools and int8 pools with one static
dequant scale per layer, and takes e4m3 (fp8, uint8 storage) pools with one
too, which the JAX package serves on its XLA path. Bound on the H100: the
live K/V bytes, 2*Hkv*D*(2 for bf16, 1 for int8 and e4m3)*sum_b min(pos_b
+ 1, MB*BS). Design:
kernel 3's one launch, the MB * BS table rows split over the card by
`decode_split` (64-row tiles), a block per (split, kv head and chunk of up
to 8 query heads, b) finding its rows through its slice of the block table
(`tables[b, row // BS]`, row `row % BS`; `table_slice` entries in shared
memory), the last split to finish merging from the per-stream workspace:
no allocation but the output, no host sync. `split_rows` is the addressing
as a model: what each split reads and which one writes.

Rules (both versions): table entries -1 stand for the trash block (the
pool's last); a position with pos // BS >= MB writes to the trash block and
attends the MB * BS table rows; every other row of the pool stays as it
was. BS must be a multiple of 8.

`paged_decode_attention` takes the plain version for CPU tensors and
launches the kernel for CUDA tensors (head dims 32, 64, 96, 128 and 256;
any other raises); `.launches` counts launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .decode_attention import (CACHE_KINDS, TILE, cache_kind, check_scales,
                               decode_split, kv_decode, kv_encode,
                               layer_scale, sm_count, workspace_size)

NEG_INF = -1e9

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"tllm_paged_decode_attention":
               [_P] * 11 + [_I] * 9 + [_F] + [_I] * 4 + [_P]}


def table_slice(bs: int, tps: int) -> int:
    """Table entries a block holds in shared memory: as many as `tps`
    64-row tiles starting at any row span at block size `bs`."""
    return -(-tps * TILE // bs) + 1


def split_rows(table, pos: int, n_blocks: int, bs: int, splits: int,
               tps: int):
    """The kernel's addressing for one sequence and kv head, as a model:
    for each split s, (the (logical row, pool block, row in it) it attends,
    the (block, row) it stores the new token at or None). Split s attends
    the rows [s * tps * TILE, (s + 1) * tps * TILE) below n_live = min(pos +
    1, MB * BS), each through its slice of the table (at most
    `table_slice` entries, -1 as the trash block n_blocks - 1); the owner
    of row pos stores it, and at pos >= MB * BS the last split stores row
    pos % BS of the trash block."""
    mb, trash = len(table), n_blocks - 1
    cap = mb * bs
    n_live = min(pos + 1, cap)
    out = []
    for s in range(splits):
        begin = s * tps * TILE
        end = min(begin + tps * TILE, n_live)
        e0 = begin // bs
        entries = [trash if t < 0 else int(t)
                   for t in table[e0:max(end - 1, begin) // bs + 1]]
        rows = [(r, entries[r // bs - e0], r % bs) for r in range(begin, end)]
        write = next(((blk, off) for r, blk, off in rows if r == pos), None)
        if pos >= cap and s == splits - 1:
            write = (trash, pos % bs)
        out.append((rows, write))
    return out


def _write_blocks(tables, positions, n_blocks: int, bs: int):
    """(block tables with -1 as the trash block, the block each position
    writes to, the row in it)."""
    trash = n_blocks - 1
    tbl = torch.where(tables < 0, trash, tables).long()
    pos = positions.long()
    blk_i = pos // bs
    mb = tbl.shape[1]
    w_blk = tbl.gather(1, blk_i.clamp(max=mb - 1)[:, None])[:, 0]
    w_blk = torch.where(blk_i < mb, w_blk, trash)
    return tbl, w_blk, pos % bs


def write_rows(pool, layer: int, tables, positions, rows):
    """The one paged decode write rule: rows [B, Hkv, D] (in the pool's
    dtype) go to row pos % BS of block tables[b, pos // BS] of layer `layer`
    of pool [L, NB, Hkv, BS, D], in place; -1 entries and positions past the
    table write the trash block (the pool's last)."""
    _, blk, off = _write_blocks(tables, positions, pool.shape[1],
                                pool.shape[3])
    pool[layer, blk, :, off] = rows


def paged_decode_attention_plain(q, k_new, v_new, pool_k, pool_v, layer: int,
                                 tables, positions, sm_scale=None,
                                 kv_scale=None):
    """Plain PyTorch version. Writes k_new/v_new [B, Hkv, D] at row
    pos % BS of block tables[b, pos // BS] of layer `layer` of the pools
    [L, NB, Hkv, BS, D] (in place; an int8 or e4m3 pool stores kv_encode(x,
    its dtype, kv_scale[layer])), then attends q [B, Hq, D] over the rows <
    min(pos + 1, MB * BS) of the table's blocks with an f32 softmax and f32
    p @ v (quantized rows read as kv_decode: their values * kv_scale[layer]
    in f32). Returns [B, Hq, D] in q's dtype."""
    b, hq, d = q.shape
    nb, hkv, bs = pool_k.shape[1], pool_k.shape[2], pool_k.shape[3]
    scale = sm_scale if sm_scale is not None else d ** -0.5
    kvs = layer_scale(pool_k, kv_scale, layer)
    write_rows(pool_k, layer, tables, positions,
               kv_encode(k_new, pool_k.dtype, kvs))
    write_rows(pool_v, layer, tables, positions,
               kv_encode(v_new, pool_v.dtype, kvs))
    tbl = torch.where(tables < 0, nb - 1, tables).long()
    mb = tbl.shape[1]
    rep = hq // hkv

    def gather(pool):              # [B, Hq, MB*BS, D] f32
        x = kv_decode(pool[layer][tbl], kvs).permute(0, 2, 1, 3, 4)
        return x.reshape(b, hkv, mb * bs, d).repeat_interleave(rep, dim=1)
    scores = torch.einsum("bhd,bhsd->bhs", q.float(), gather(pool_k)) * scale
    mask = (torch.arange(mb * bs, device=q.device)[None, :]
            <= positions.long()[:, None])
    scores = torch.where(mask[:, None], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhs,bhsd->bhd", probs, gather(pool_v)).to(q.dtype)


def paged_decode_attention(q, k_new, v_new, pool_k, pool_v, layer: int,
                           tables, positions, sm_scale=None, kv_scale=None):
    """Decode step of layer `layer` over the paged pools: write the new
    token's K/V at `positions` [B] (int32) through `tables` [B, MB] (int32)
    into the pools IN PLACE and attend. q: [B, Hq, D]; k_new, v_new:
    [B, Hkv, D] in q's dtype; pools [L, NB, Hkv, BS, D] in q's dtype, int8
    or uint8 (e4m3 codes), the last block the trash block; kv_scale: f32
    [L] dequant scales (int8 and e4m3 pools; ignored for float ones).
    Returns out [B, Hq, D] in q's dtype."""
    bs = pool_k.shape[3]
    if bs % 8:
        raise ValueError(f"paged_decode_attention: block size {bs} is not "
                         "a multiple of 8")
    check_scales("paged_decode_attention", pool_k, kv_scale)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_new, v_new, pool_k, pool_v,
                                            layer, tables, positions,
                                            sm_scale, kv_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device "
                         f"{q.device}")
    b, hq, d = q.shape
    n_layers, nb, hkv, _, _ = pool_k.shape
    mb = tables.shape[1]
    kind = cache_kind(pool_k.dtype)
    if (q.dtype not in _build.DTYPE_CODES
            or {k_new.dtype, v_new.dtype} != {q.dtype}
            or {pool_k.dtype, pool_v.dtype} not in (
                {q.dtype}, *({c} for c in CACHE_KINDS))):
        raise TypeError("paged_decode_attention: unsupported dtypes (q, new "
                        "K/V share one of f32/bf16/fp16; the pools that one, "
                        "int8 or uint8 e4m3 codes)")
    if (d not in _build.HEAD_DIMS or hq % hkv or pool_k.shape[4] != d
            or v_new.shape != k_new.shape or k_new.shape != (b, hkv, d)
            or pool_v.shape != pool_k.shape or tables.shape != (b, mb)
            or mb < 1 or not 0 <= layer < n_layers):
        raise ValueError(f"paged_decode_attention: shapes q {tuple(q.shape)} "
                         f"new {tuple(k_new.shape)} pool {tuple(pool_k.shape)}"
                         f" tables {tuple(tables.shape)} layer {layer}")
    positions = positions.to(torch.int32)
    tables = tables.to(torch.int32)
    tensors = [q, k_new, v_new, pool_k, pool_v, tables, positions]
    if kind:
        tensors.append(kv_scale)
    if (any(t.device != q.device or not t.is_contiguous() for t in tensors)
            or positions.shape != (b,)):
        raise ValueError("paged_decode_attention: tensors must be contiguous "
                         "and on one device, positions [B]")
    if pool_k.data_ptr() % 16 or pool_v.data_ptr() % 16:
        raise ValueError("paged_decode_attention: pools must be 16-byte "
                         "aligned")
    scale = sm_scale if sm_scale is not None else d ** -0.5
    splits, tps = decode_split(b, hkv, mb * bs, hq // hkv, sm_count(q.device))
    part = counters = None
    if splits > 1:
        part, counters = _build.workspace(
            q.device, *workspace_size(b, hq, d, splits))
    lib = _build.load("paged_decode_attention", _SIGNATURES)
    out = torch.empty_like(q)
    layer_bytes = nb * hkv * bs * d * pool_k.element_size()
    kvs_ptr = (_P(kv_scale.data_ptr() + layer * 4) if kind else _P(None))
    err = lib.tllm_paged_decode_attention(
        _build.ptr(q), _build.ptr(k_new), _build.ptr(v_new),
        _P(pool_k.data_ptr() + layer * layer_bytes),
        _P(pool_v.data_ptr() + layer * layer_bytes), kvs_ptr,
        _build.ptr(tables), _build.ptr(positions), _build.ptr(out),
        _build.ptr(part), _build.ptr(counters),
        _build.DTYPE_CODES[q.dtype], kind, b, hq, hkv, nb, bs, mb, d,
        float(scale), splits, tps, table_slice(bs, tps),
        q.device.index or 0, _build.stream_of(q))
    _build.check(err, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
