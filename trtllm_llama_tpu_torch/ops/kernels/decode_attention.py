"""Kernel 3: decode attention with the in-place KV write
(csrc/decode_attention.cu, its body in csrc/decode_attention.cuh, shared
with kernel 14).

Replaces `trtllm_llama_tpu/ops/pallas/dma_decode_attention.py::
dma_decode_attention`, for bf16/f32 caches and int8 caches with one static
dequant scale per layer. Bound on the H100: the live K/V bytes,
2*B*Hkv*(pos+1)*D*(2 for bf16, 1 for int8). Design: flash-decoding split-K
over only the live 32-row chunks, one block per (chunk, kv head, b)
covering the GQA group, then a combine launch; the block owning pos's chunk
is the only writer of row pos and attends it as stored (int8: encoded then
decoded), so the write never races a reader (see the source's note). A
position >= S_max writes nothing (the JAX scatter drops it) and attends
all S_max rows.

`dma_decode_attention` takes the plain version for CPU tensors and
launches the kernel for CUDA tensors; `.launches` counts launches.
"""

from __future__ import annotations

import ctypes

import torch

from ...quantization.tensors import quantize_int8
from . import _build

NEG_INF = -1e9
CHUNK = 32      # cache rows per block (kChunk in the source)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"tllm_decode_attention": [_P] * 11 + [_I] * 7 + [_F, _I, _P]}
_HEAD_DIMS = (32, 64, 128)


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
    if q.device.type != "cuda":
        raise ValueError(f"dma_decode_attention: unsupported device {q.device}")
    b, hq, d = q.shape
    n_layers, _, hkv, s, _ = k_cache.shape
    kv_int8 = k_cache.dtype == torch.int8
    if (q.dtype not in _build.DTYPE_CODES
            or {k_new.dtype, v_new.dtype} != {q.dtype}
            or {k_cache.dtype, v_cache.dtype} not in ({q.dtype}, {torch.int8})):
        raise TypeError("dma_decode_attention: unsupported dtypes (q, new K/V "
                        "share one of f32/bf16; the caches that one or int8)")
    if (d not in _HEAD_DIMS or hq % hkv or s % CHUNK
            or k_cache.shape != (n_layers, b, hkv, s, d)
            or v_cache.shape != k_cache.shape
            or k_new.shape != (b, hkv, d) or v_new.shape != k_new.shape
            or not 0 <= layer < n_layers):
        raise ValueError(f"dma_decode_attention: shapes q {tuple(q.shape)} "
                         f"new {tuple(k_new.shape)} cache {tuple(k_cache.shape)}"
                         f" layer {layer}")
    positions = positions.to(torch.int32)
    tensors = [q, k_new, v_new, k_cache, v_cache, positions]
    if kv_int8:
        if (kv_scale is None or kv_scale.dtype != torch.float32
                or kv_scale.shape != (n_layers,)):
            raise ValueError("dma_decode_attention: an int8 cache needs "
                             "kv_scale, f32 [L]")
        tensors.append(kv_scale)
    if (any(t.device != q.device or not t.is_contiguous() for t in tensors)
            or positions.shape != (b,)):
        raise ValueError("dma_decode_attention: tensors must be contiguous "
                         "and on one device, positions [B]")
    scale = sm_scale if sm_scale is not None else d ** -0.5
    lib = _build.load("decode_attention", _SIGNATURES)
    n_chunks = s // CHUNK
    out = torch.empty_like(q)
    part_ml = torch.empty((2, b, hq, n_chunks), device=q.device,
                          dtype=torch.float32)
    part_acc = torch.empty((b, hq, n_chunks, d), device=q.device,
                           dtype=torch.float32)
    layer_bytes = b * hkv * s * d * k_cache.element_size()
    kvs_ptr = (_P(kv_scale.data_ptr() + layer * 4) if kv_int8 else _P(None))
    err = lib.tllm_decode_attention(
        _build.ptr(q), _build.ptr(k_new), _build.ptr(v_new),
        _P(k_cache.data_ptr() + layer * layer_bytes),
        _P(v_cache.data_ptr() + layer * layer_bytes), kvs_ptr,
        _build.ptr(positions), _build.ptr(out), _build.ptr(part_ml[0]),
        _build.ptr(part_ml[1]), _build.ptr(part_acc),
        _build.DTYPE_CODES[q.dtype], int(kv_int8), b, hq, hkv, s, d,
        float(scale), q.device.index or 0, _build.stream_of(q))
    _build.check(err, "dma_decode_attention")
    dma_decode_attention.launches += 1
    return out


dma_decode_attention.launches = 0
