"""Decode attention over one layer of the stacked KV cache: kernel 3
(the write plus attention, csrc/decode_attention.cu, its body in
csrc/decode_attention.cuh, shared with kernel 14), row 8 (the same
attention read-only, csrc/decode_attention.cu) and row 9 (the write plus
attention in one launch with no split over the cache,
csrc/fused_decode_attention.cu).

Kernel 3 replaces `trtllm_llama_tpu/ops/pallas/dma_decode_attention.py::
dma_decode_attention`, for bf16/f32 caches and int8 caches with one static
dequant scale per layer. Bound on the H100: the live K/V bytes,
2*B*Hkv*(pos+1)*D*(2 for bf16, 1 for int8). Design: flash-decoding split-K
over only the live 32-row chunks, one block per (chunk, kv head, b)
covering the GQA group, then a combine launch; the block owning pos's chunk
is the only writer of row pos and attends it as stored (int8: encoded then
decoded), so the write never races a reader (see the source's note). A
position >= S_max writes nothing (the JAX scatter drops it) and attends
all S_max rows.

Row 8 (`decode_attention_kernel`) replaces `trtllm_llama_tpu/ops/pallas/
attention.py::decode_attention_kernel`: kernel 3's body with a read-only
addressing policy over the rows < cache_lens[b] (a length <= 0 averages V
over all S rows, as the reference's all-masked softmax does). Row 9
(`fused_decode_attention`) replaces `attention.py::fused_decode_attention`:
kernel 3's function in one launch: blocks of up to 8 query heads per
(kv head, b) (one for a GQA group of 1; Falcon-7B's 71 heads at D=64 in
9) walk the live rows with an online softmax, with no partials and no
combine launch; block 0 writes row pos and every block attends its own
decoded copy of it, so no block reads the row being written.

Each wrapper takes its plain version for CPU tensors and launches its
kernel for CUDA tensors (head dims 32, 64, 96, 128 and 256, as kernel 14;
any other raises); `<wrapper>.launches` counts launches.
"""

from __future__ import annotations

import ctypes

import torch

from ...quantization.tensors import quantize_int8
from . import _build

NEG_INF = -1e9
CHUNK = 32      # cache rows per block (kChunk in the source)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"tllm_decode_attention": [_P] * 11 + [_I] * 7 + [_F, _I, _P],
               "tllm_decode_attention_read": [_P] * 9 + [_I] * 7
               + [_F, _I, _P]}
_FUSED_SIGNATURES = {"tllm_fused_decode_attention":
                     [_P] * 8 + [_I] * 7 + [_F, _I, _P]}


def write_rows(cache, positions, rows):
    """cache[b, :, positions[b]] = rows[b] for cache [B, H, S, D], rows
    [B, H, D] of its dtype, in place; a position >= S writes nothing (the
    JAX package's scatter drops it). No host sync: a dropped row rewrites
    the cache's own last row."""
    s = cache.shape[2]
    bidx = torch.arange(cache.shape[0], device=cache.device)
    at = positions.clamp(max=s - 1)
    keep = (positions < s)[:, None, None]
    cache[bidx, :, at] = torch.where(keep, rows, cache[bidx, :, at])


def dma_decode_attention_plain(q, k_new, v_new, k_cache, v_cache, layer: int,
                               positions, sm_scale=None, kv_scale=None):
    """Plain PyTorch version. Writes k_new/v_new [B, Hkv, D] at row
    positions[b] of layer `layer` of the caches [L, B, Hkv, S, D] (in
    place; an int8 cache stores clamp(round(x / kv_scale[layer]), +-127);
    a position >= S writes nothing, as the JAX package's scatter drops it),
    then attends q [B, Hq, D] over rows <= positions[b] with an f32 softmax
    and f32 p @ v (int8 rows read as code * kv_scale[layer] in f32).
    Returns [B, Hq, D] in q's dtype."""
    b, hq, d = q.shape
    hkv, s = k_cache.shape[2], k_cache.shape[3]
    scale = sm_scale if sm_scale is not None else d ** -0.5
    pos = positions.long()
    int8 = k_cache.dtype == torch.int8
    enc = ((lambda x: quantize_int8(x, kv_scale[layer])) if int8
           else (lambda x: x.to(k_cache.dtype)))
    write_rows(k_cache[layer], pos, enc(k_new))
    write_rows(v_cache[layer], pos, enc(v_new))
    rep = hq // hkv
    kf, vf = k_cache[layer].float(), v_cache[layer].float()
    if int8:
        kf, vf = kf * kv_scale[layer], vf * kv_scale[layer]
    kf = kf.repeat_interleave(rep, dim=1)                         # [B,Hq,S,D]
    vf = vf.repeat_interleave(rep, dim=1)
    scores = torch.einsum("bhd,bhsd->bhs", q.float(), kf) * scale
    mask = torch.arange(s, device=q.device)[None, :] <= pos[:, None]
    scores = torch.where(mask[:, None], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhs,bhsd->bhd", probs, vf).to(q.dtype)


def decode_attention_kernel_plain(q, k_cache, v_cache, layer: int,
                                  cache_lens, sm_scale=None, kv_scale=None):
    """Plain PyTorch version of row 8: q [B, Hq, D] attends layer `layer`
    of the caches [L, B, Hkv, S, D] over rows < cache_lens[b] (no write)
    with an f32 softmax and f32 p @ v (int8 rows read as code *
    kv_scale[layer] in f32); masked rows score NEG_INF, so a length <= 0
    averages V over all S rows. Returns [B, Hq, D] in q's dtype."""
    b, hq, d = q.shape
    hkv, s = k_cache.shape[2], k_cache.shape[3]
    scale = sm_scale if sm_scale is not None else d ** -0.5
    rep = hq // hkv
    kf, vf = k_cache[layer].float(), v_cache[layer].float()
    if k_cache.dtype == torch.int8:
        kf, vf = kf * kv_scale[layer], vf * kv_scale[layer]
    kf = kf.repeat_interleave(rep, dim=1)                         # [B,Hq,S,D]
    vf = vf.repeat_interleave(rep, dim=1)
    scores = torch.einsum("bhd,bhsd->bhs", q.float(), kf) * scale
    mask = torch.arange(s, device=q.device)[None, :] < cache_lens[:, None]
    scores = torch.where(mask[:, None], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhs,bhsd->bhd", probs, vf).to(q.dtype)


# Row 9 computes kernel 3's function; its plain version is kernel 3's.
fused_decode_attention_plain = dma_decode_attention_plain


def _check(name, q, k_cache, v_cache, layer, lens, kv_scale, new=()):
    """Validate one call of kernel 3, row 8 or row 9 (new = (k_new, v_new)
    for the writing ones). Returns lens as int32."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    b, hq, d = q.shape
    n_layers, _, hkv, s, _ = k_cache.shape
    if (q.dtype not in _build.DTYPE_CODES
            or any(t.dtype != q.dtype for t in new)
            or {k_cache.dtype, v_cache.dtype} not in ({q.dtype}, {torch.int8})):
        raise TypeError(f"{name}: unsupported dtypes (q and new K/V share one"
                        " of f32/bf16/fp16; the caches that one or int8)")
    if (d not in _build.HEAD_DIMS or hq % hkv or s % CHUNK
            or k_cache.shape != (n_layers, b, hkv, s, d)
            or v_cache.shape != k_cache.shape
            or any(t.shape != (b, hkv, d) for t in new)
            or not 0 <= layer < n_layers):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} cache "
                         f"{tuple(k_cache.shape)} layer {layer}")
    lens = lens.to(torch.int32)
    tensors = [q, k_cache, v_cache, lens, *new]
    if k_cache.dtype == torch.int8:
        if (kv_scale is None or kv_scale.dtype != torch.float32
                or kv_scale.shape != (n_layers,)):
            raise ValueError(f"{name}: an int8 cache needs kv_scale, f32 [L]")
        tensors.append(kv_scale)
    if (any(t.device != q.device or not t.is_contiguous() for t in tensors)
            or lens.shape != (b,)):
        raise ValueError(f"{name}: tensors must be contiguous and on one "
                         "device, positions / lengths [B]")
    return lens


def _layer_ptrs(k_cache, v_cache, kv_scale, layer):
    """Device pointers of layer `layer` of the caches and of its int8
    scale (NULL for a float cache)."""
    layer_bytes = k_cache[0].numel() * k_cache.element_size()
    kvs = (_P(kv_scale.data_ptr() + layer * 4)
           if k_cache.dtype == torch.int8 else _P(None))
    return (_P(k_cache.data_ptr() + layer * layer_bytes),
            _P(v_cache.data_ptr() + layer * layer_bytes), kvs)


def decode_attention_kernel(q, k_cache, v_cache, layer: int, cache_lens,
                            sm_scale=None, kv_scale=None):
    """Row 8: read-only decode attention of q [B, Hq, D] over layer `layer`
    of the caches [L, B, Hkv, S, D] (q's dtype or int8 with kv_scale f32
    [L]), rows < cache_lens[b] (int32 [B]). Returns [B, Hq, D] in q's
    dtype."""
    if q.device.type == "cpu":
        return decode_attention_kernel_plain(q, k_cache, v_cache, layer,
                                             cache_lens, sm_scale, kv_scale)
    lens = _check("decode_attention_kernel", q, k_cache, v_cache, layer,
                  cache_lens, kv_scale)
    b, hq, d = q.shape
    hkv, s = k_cache.shape[2], k_cache.shape[3]
    scale = sm_scale if sm_scale is not None else d ** -0.5
    lib = _build.load("decode_attention", _SIGNATURES)
    n_chunks = s // CHUNK
    out = torch.empty_like(q)
    part_ml = torch.empty((2, b, hq, n_chunks), device=q.device,
                          dtype=torch.float32)
    part_acc = torch.empty((b, hq, n_chunks, d), device=q.device,
                           dtype=torch.float32)
    kc, vc, kvs = _layer_ptrs(k_cache, v_cache, kv_scale, layer)
    err = lib.tllm_decode_attention_read(
        _build.ptr(q), kc, vc, kvs, _build.ptr(lens), _build.ptr(out),
        _build.ptr(part_ml[0]), _build.ptr(part_ml[1]), _build.ptr(part_acc),
        _build.DTYPE_CODES[q.dtype], int(k_cache.dtype == torch.int8), b, hq,
        hkv, s, d, float(scale), q.device.index or 0, _build.stream_of(q))
    _build.check(err, "decode_attention_kernel")
    decode_attention_kernel.launches += 1
    return out


decode_attention_kernel.launches = 0


def fused_decode_attention(q, k_new, v_new, k_cache, v_cache, layer: int,
                           positions, sm_scale=None, kv_scale=None):
    """Row 9: kernel 3's call (see `dma_decode_attention`) in one launch
    with no split over the cache. The caches must be 16-byte aligned."""
    if q.device.type == "cpu":
        return fused_decode_attention_plain(q, k_new, v_new, k_cache, v_cache,
                                            layer, positions, sm_scale,
                                            kv_scale)
    positions = _check("fused_decode_attention", q, k_cache, v_cache, layer,
                       positions, kv_scale, (k_new, v_new))
    b, hq, d = q.shape
    hkv, s = k_cache.shape[2], k_cache.shape[3]
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("fused_decode_attention: caches must be 16-byte "
                         "aligned")
    scale = sm_scale if sm_scale is not None else d ** -0.5
    lib = _build.load("fused_decode_attention", _FUSED_SIGNATURES)
    out = torch.empty_like(q)
    kc, vc, kvs = _layer_ptrs(k_cache, v_cache, kv_scale, layer)
    err = lib.tllm_fused_decode_attention(
        _build.ptr(q), _build.ptr(k_new), _build.ptr(v_new), kc, vc, kvs,
        _build.ptr(positions), _build.ptr(out), _build.DTYPE_CODES[q.dtype],
        int(k_cache.dtype == torch.int8), b, hq, hkv, s, d, float(scale),
        q.device.index or 0, _build.stream_of(q))
    _build.check(err, "fused_decode_attention")
    fused_decode_attention.launches += 1
    return out


fused_decode_attention.launches = 0


def dma_decode_attention(q, k_new, v_new, k_cache, v_cache, layer: int,
                         positions, sm_scale=None, kv_scale=None):
    """Decode step of layer `layer`: write the new token's K/V at
    `positions` [B] (int32) into the stacked caches IN PLACE and attend.
    q: [B, Hq, D]; k_new, v_new: [B, Hkv, D] in q's dtype; caches
    [L, B, Hkv, S, D] in q's dtype or int8; kv_scale: f32 [L] dequant
    scales (int8 caches; ignored for float ones). Returns out [B, Hq, D]
    in q's dtype."""
    if q.device.type == "cpu":
        return dma_decode_attention_plain(q, k_new, v_new, k_cache, v_cache,
                                          layer, positions, sm_scale, kv_scale)
    positions = _check("dma_decode_attention", q, k_cache, v_cache, layer,
                       positions, kv_scale, (k_new, v_new))
    b, hq, d = q.shape
    hkv, s = k_cache.shape[2], k_cache.shape[3]
    scale = sm_scale if sm_scale is not None else d ** -0.5
    lib = _build.load("decode_attention", _SIGNATURES)
    n_chunks = s // CHUNK
    out = torch.empty_like(q)
    part_ml = torch.empty((2, b, hq, n_chunks), device=q.device,
                          dtype=torch.float32)
    part_acc = torch.empty((b, hq, n_chunks, d), device=q.device,
                           dtype=torch.float32)
    kc, vc, kvs = _layer_ptrs(k_cache, v_cache, kv_scale, layer)
    err = lib.tllm_decode_attention(
        _build.ptr(q), _build.ptr(k_new), _build.ptr(v_new), kc, vc, kvs,
        _build.ptr(positions), _build.ptr(out), _build.ptr(part_ml[0]),
        _build.ptr(part_ml[1]), _build.ptr(part_acc),
        _build.DTYPE_CODES[q.dtype], int(k_cache.dtype == torch.int8), b,
        hq, hkv, s, d, float(scale), q.device.index or 0,
        _build.stream_of(q))
    _build.check(err, "dma_decode_attention")
    dma_decode_attention.launches += 1
    return out


dma_decode_attention.launches = 0
