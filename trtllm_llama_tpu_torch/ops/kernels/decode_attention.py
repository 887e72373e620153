"""Decode attention over one layer of the stacked KV cache: kernel 3
(the write plus attention), row 9 (the same function) and row 8 (the
attention read-only), one source, csrc/decode_attention.cu.

Kernel 3 replaces `trtllm_llama_tpu/ops/pallas/dma_decode_attention.py::
dma_decode_attention` (:156), for bf16/f32 caches and int8 caches with one
static dequant scale per layer, and takes e4m3 (fp8) caches with one too
(uint8 storage of `ops/fp8.py`'s codes), which the JAX package sends to its
XLA path (`ops/attention.py:256`); row 9 replaces `trtllm_llama_tpu/ops/
pallas/attention.py::fused_decode_attention` (:185), the 'fused' mode;
row 8 replaces `attention.py::decode_attention_kernel` (:72), the 'split'
mode and `decode_attention_at`. All three run one body, the split-cache
kernel of csrc/flash_decode.cuh (entries `tllm_decode_attention` and
`tllm_decode_attention_read`), each wrapper with its own counter. Bound
on the H100: the live K/V bytes, 2*B*Hkv*n_live*D*(2 for bf16, 1 for
int8 and e4m3), at 3.35 TB/s. Design: one launch; the S_max rows split into
`decode_split`'s ranges of whole 64-row tiles, one block per (split, kv
head, b) serving up to HEAD_CHUNK of the GQA group's query heads (a larger
group in chunks); the last of a (kv head, chunk, b)'s splits to finish
merges their softmax states from a small workspace that the wrapper keeps
for each stream (no combine launch, no allocation per call); K/V streamed
as stored through a cp.async ring and read in registers. The writers:
the block whose range holds pos is the only writer of row pos and attends
it as stored (int8, e4m3: encoded then decoded); a position >= S_max writes
nothing (the JAX scatter drops it) and attends all S_max rows. Row 8
attends rows < cache_lens[b] (all S_max rows past S_max; a length <= 0
averages V over all S_max rows, as the reference's all-masked softmax
does).

Each wrapper takes its plain version for CPU tensors and launches the
kernel for CUDA tensors (head dims 32, 64, 96, 128 and 256, S_max % 32 ==
0, caches 16-byte aligned; anything else raises before launch);
`<wrapper>.launches` counts launches.
"""

from __future__ import annotations

import ctypes

import torch

from ...quantization.tensors import quantize_int8
from ..fp8 import fp8_decode, fp8_encode
from . import _build

NEG_INF = -1e9
CHUNK = 32      # S_max must be a whole number of these
TILE = 64       # cache rows of a split's unit (kTile in flash_decode.cuh)
MAX_SPLITS = 32     # splits of one (kv head, b) (kMaxSplits)
HEAD_CHUNK = 8      # query heads a block serves (kChunk)
SHORT_TILES = 4     # a cache of fewer tiles than this stays one split
BLOCKS_PER_SM = 2   # the kernel's launch bound
# what a cache holds, as csrc/flash_decode.cuh's CacheKind: the activation
# type (0), int8 codes, or e4m3 codes in uint8 storage; both of the latter
# come with a dequant scale per layer
CACHE_KINDS = {torch.int8: 1, torch.uint8: 2}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"tllm_decode_attention": [_P] * 10 + [_I] * 7 + [_F]
               + [_I] * 3 + [_P],
               "tllm_decode_attention_read": [_P] * 8 + [_I] * 7 + [_F]
               + [_I] * 3 + [_P]}


def sm_count(device) -> int:
    """Streaming multiprocessors of the CUDA `device` (132 on an H100
    SXM)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def decode_split(b: int, hkv: int, s: int, group: int, sms: int
                 ) -> tuple[int, int]:
    """(splits, tiles per split) of the split-cache launch (kernel 3,
    rows 8 and 9) over
    [b, hkv, s] caches with `group` query heads a kv head on a card of
    `sms` SMs: split i covers the 64-row tiles [i * tps, (i + 1) * tps) of
    the s rows (the last one clipped to s), none empty, at most
    MAX_SPLITS. As many splits as fit one wave of BLOCKS_PER_SM blocks on
    each SM, a block per (split, chunk of up to HEAD_CHUNK heads, kv head,
    b); a cache of fewer than SHORT_TILES tiles stays one split. From the
    shapes alone: no position, no host sync."""
    tiles = -(-s // TILE)
    if tiles < SHORT_TILES:
        return 1, tiles
    chunks = -(-group // HEAD_CHUNK)
    want = max(1, BLOCKS_PER_SM * sms // (b * hkv * chunks))
    n = min(want, MAX_SPLITS, tiles)
    tps = -(-tiles // n)
    return -(-tiles // tps), tps


def cache_kind(cache_dtype) -> int:
    """The kernel's code of a cache of `cache_dtype` (0: the activation
    type)."""
    return CACHE_KINDS.get(cache_dtype, 0)


def kv_encode(x, cache_dtype, scale=None):
    """x as a cache of `cache_dtype` stores it: int8 clamp(round(x /
    scale), +-127), uint8 the e4m3 code of x / scale (`ops/fp8.py`), both by
    true division in f32 (the JAX package's _quant_kv); a float cache the
    value cast."""
    if cache_dtype == torch.int8:
        return quantize_int8(x, scale)
    if cache_dtype == torch.uint8:
        return fp8_encode(x.float() / scale)
    return x.to(cache_dtype)


def kv_decode(c, scale=None):
    """Stored cache elements as f32 values: an int8 code times `scale`, an
    e4m3 code's exact value times `scale`, a float element as it is."""
    if c.dtype == torch.int8:
        return c.float() * scale
    if c.dtype == torch.uint8:
        return fp8_decode(c) * scale
    return c.float()


def layer_scale(cache, kv_scale, layer):
    """The layer's dequant scale of a quantized cache, else None."""
    return kv_scale[layer] if cache_kind(cache.dtype) else None


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
    place; an int8 or e4m3 cache stores kv_encode(x, its dtype,
    kv_scale[layer]); a position >= S writes nothing, as the JAX package's
    scatter drops it), then attends q [B, Hq, D] over rows <= positions[b]
    with an f32 softmax and f32 p @ v (quantized rows read as kv_decode:
    their values * kv_scale[layer] in f32). Returns [B, Hq, D] in q's
    dtype."""
    b, hq, d = q.shape
    hkv, s = k_cache.shape[2], k_cache.shape[3]
    scale = sm_scale if sm_scale is not None else d ** -0.5
    pos = positions.long()
    kvs = layer_scale(k_cache, kv_scale, layer)
    write_rows(k_cache[layer], pos, kv_encode(k_new, k_cache.dtype, kvs))
    write_rows(v_cache[layer], pos, kv_encode(v_new, v_cache.dtype, kvs))
    rep = hq // hkv
    kf, vf = kv_decode(k_cache[layer], kvs), kv_decode(v_cache[layer], kvs)
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
    with an f32 softmax and f32 p @ v (int8 and e4m3 rows read as
    kv_decode: their values * kv_scale[layer] in f32); masked rows score
    NEG_INF, so a length <= 0 averages V over all S rows. Returns
    [B, Hq, D] in q's dtype."""
    b, hq, d = q.shape
    hkv, s = k_cache.shape[2], k_cache.shape[3]
    scale = sm_scale if sm_scale is not None else d ** -0.5
    rep = hq // hkv
    kvs = layer_scale(k_cache, kv_scale, layer)
    kf, vf = kv_decode(k_cache[layer], kvs), kv_decode(v_cache[layer], kvs)
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
            or {k_cache.dtype, v_cache.dtype} not in (
                {q.dtype}, *({c} for c in CACHE_KINDS))):
        raise TypeError(f"{name}: unsupported dtypes (q and new K/V share one"
                        " of f32/bf16/fp16; the caches that one, int8 or "
                        "uint8 e4m3 codes)")
    if (d not in _build.HEAD_DIMS or hq % hkv or s % CHUNK
            or k_cache.shape != (n_layers, b, hkv, s, d)
            or v_cache.shape != k_cache.shape
            or any(t.shape != (b, hkv, d) for t in new)
            or not 0 <= layer < n_layers):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} cache "
                         f"{tuple(k_cache.shape)} layer {layer}")
    lens = lens.to(torch.int32)
    tensors = [q, k_cache, v_cache, lens, *new]
    if cache_kind(k_cache.dtype):
        tensors.append(kv_scale)
    if (any(t.device != q.device or not t.is_contiguous() for t in tensors)
            or lens.shape != (b,)):
        raise ValueError(f"{name}: tensors must be contiguous and on one "
                         "device, positions / lengths [B]")
    return lens


def check_scales(name, cache, kv_scale):
    """An int8 or e4m3 cache [L, ...] must come with its dequant scales,
    f32 [L], on either device: raises ValueError otherwise."""
    if cache_kind(cache.dtype) and (
            not isinstance(kv_scale, torch.Tensor)
            or kv_scale.dtype != torch.float32
            or kv_scale.shape != cache.shape[:1]):
        what = "an int8" if cache.dtype == torch.int8 else "an e4m3 (uint8)"
        raise ValueError(f"{name}: {what} cache needs kv_scale, f32 [L]")


def _layer_ptrs(k_cache, v_cache, kv_scale, layer):
    """Device pointers of layer `layer` of the caches and of its dequant
    scale (NULL for a float cache)."""
    layer_bytes = k_cache[0].numel() * k_cache.element_size()
    kvs = (_P(kv_scale.data_ptr() + layer * 4)
           if cache_kind(k_cache.dtype) else _P(None))
    return (_P(k_cache.data_ptr() + layer * layer_bytes),
            _P(v_cache.data_ptr() + layer * layer_bytes), kvs)


def decode_attention_kernel(q, k_cache, v_cache, layer: int, cache_lens,
                            sm_scale=None, kv_scale=None):
    """Row 8: read-only decode attention of q [B, Hq, D] over layer `layer`
    of the caches [L, B, Hkv, S, D] (q's dtype, or int8 or uint8 e4m3
    codes with kv_scale f32 [L]; 16-byte aligned), rows < cache_lens[b]
    (int32 [B]). Returns [B, Hq, D] in q's dtype. One launch."""
    check_scales("decode_attention_kernel", k_cache, kv_scale)
    if q.device.type == "cpu":
        return decode_attention_kernel_plain(q, k_cache, v_cache, layer,
                                             cache_lens, sm_scale, kv_scale)
    out = _launch("decode_attention_kernel", q, k_cache, v_cache, layer,
                  cache_lens, sm_scale, kv_scale)
    decode_attention_kernel.launches += 1
    return out


decode_attention_kernel.launches = 0


_workspace = _build.workspace     # the split-cache body's, per stream


def workspace_size(b: int, hq: int, d: int, splits: int) -> tuple[int, int]:
    """(f32 elements, int32 counters) of the workspace that one split-cache
    launch over `splits` splits needs: each split's max, sum and acc[d] per
    query head, and an arrival counter per (b, query head); (0, 0) at one
    split, which needs none."""
    return (b * hq * splits * (d + 2), b * hq) if splits > 1 else (0, 0)


def _launch(name, q, k_cache, v_cache, layer, lens, sm_scale, kv_scale,
            new=()):
    """Launch the split-cache body (csrc/flash_decode.cuh) once: kernel 3's
    and row 9's write and attention with new = (k_new, v_new) and
    positions `lens`, row 8's read-only attention over rows < `lens`
    without."""
    lens = _check(name, q, k_cache, v_cache, layer, lens, kv_scale, new)
    b, hq, d = q.shape
    hkv, s = k_cache.shape[2], k_cache.shape[3]
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError(f"{name}: caches must be 16-byte aligned")
    scale = sm_scale if sm_scale is not None else d ** -0.5
    splits, tps = decode_split(b, hkv, s, hq // hkv, sm_count(q.device))
    part = counters = None
    if splits > 1:
        part, counters = _workspace(q.device,
                                    *workspace_size(b, hq, d, splits))
    lib = _build.load("decode_attention", _SIGNATURES)
    out = torch.empty_like(q)
    kc, vc, kvs = _layer_ptrs(k_cache, v_cache, kv_scale, layer)
    tail = (_build.ptr(out), _build.ptr(part), _build.ptr(counters),
            _build.DTYPE_CODES[q.dtype], cache_kind(k_cache.dtype), b,
            hq, hkv, s, d, float(scale), splits, tps, q.device.index or 0,
            _build.stream_of(q))
    if new:
        err = lib.tllm_decode_attention(
            _build.ptr(q), _build.ptr(new[0]), _build.ptr(new[1]), kc, vc,
            kvs, _build.ptr(lens), *tail)
    else:
        err = lib.tllm_decode_attention_read(_build.ptr(q), kc, vc, kvs,
                                             _build.ptr(lens), *tail)
    _build.check(err, name)
    return out


def fused_decode_attention(q, k_new, v_new, k_cache, v_cache, layer: int,
                           positions, sm_scale=None, kv_scale=None):
    """Row 9: kernel 3's call (see `dma_decode_attention`) with its own
    counter. The caches must be 16-byte aligned."""
    check_scales("fused_decode_attention", k_cache, kv_scale)
    if q.device.type == "cpu":
        return fused_decode_attention_plain(q, k_new, v_new, k_cache, v_cache,
                                            layer, positions, sm_scale,
                                            kv_scale)
    out = _launch("fused_decode_attention", q, k_cache, v_cache, layer,
                  positions, sm_scale, kv_scale, (k_new, v_new))
    fused_decode_attention.launches += 1
    return out


fused_decode_attention.launches = 0


def dma_decode_attention(q, k_new, v_new, k_cache, v_cache, layer: int,
                         positions, sm_scale=None, kv_scale=None):
    """Decode step of layer `layer`: write the new token's K/V at
    `positions` [B] (int32) into the stacked caches IN PLACE and attend.
    q: [B, Hq, D]; k_new, v_new: [B, Hkv, D] in q's dtype; caches
    [L, B, Hkv, S, D] in q's dtype, int8 or uint8 (e4m3 codes), 16-byte
    aligned; kv_scale: f32 [L] dequant scales (int8 and e4m3 caches;
    ignored for float ones). Returns
    out [B, Hq, D] in q's dtype. One launch."""
    check_scales("dma_decode_attention", k_cache, kv_scale)
    if q.device.type == "cpu":
        return dma_decode_attention_plain(q, k_new, v_new, k_cache, v_cache,
                                          layer, positions, sm_scale, kv_scale)
    out = _launch("dma_decode_attention", q, k_cache, v_cache, layer,
                  positions, sm_scale, kv_scale, (k_new, v_new))
    dma_decode_attention.launches += 1
    return out


dma_decode_attention.launches = 0
