"""Kernel 13: causal GQA attention over one packed token stream
(csrc/packed_prefill_attention.cu).

Replaces `trtllm_llama_tpu/ops/pallas/attention.py::
packed_prefill_attention_kernel`. Row i attends row j iff j <= i and
seg_ids[j] == seg_ids[i]; pad rows carry seg -1 and their output is
undefined (finite). Bound on the H100: the q/k/v/out bytes of the
segments' rows (pad rows need none), or the 4*Hq*D*sum(len*(len+1)/2)
flops of the segments. bf16 / fp16 run row 10's wgmma flash-attention
tile (`csrc/flash_attention.cuh`) with the segment mask in place of the
length mask: one warpgroup per 64-row query tile and head; a block finds
the first rows of its first and last rows' runs and streams keys from
the tile holding the first through its last row (sequences are
contiguous), so the work is O(sum len^2), not O(T^2); the mask runs only
on tiles that cross the diagonal or a segment edge. On an H100 80GB HBM3
at 700 W the T=1024 packed serving wave (709 rows in 8 segments, 32
heads of 128) takes 0.0422 ms (16% of its 0.0069 ms byte bound),
against 0.0678 for SDPA with the block-diagonal mask and 0.3772-0.4876
for the CUDA-core loop that f32 keeps (chip_smoke.py; PERF.md).

`packed_prefill_attention_kernel` takes the plain version for CPU tensors
and launches the kernel for CUDA tensors (head dims 32, 64, 96, 128 and
256; any other raises); `.launches` counts launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

NEG_INF = -1e9

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"tllm_packed_prefill_attention": [_P] * 5 + [_I] * 5
               + [_F, _I, _P]}


def packed_prefill_attention_kernel_plain(q, k, v, seg_ids, sm_scale=None):
    """Plain PyTorch version: f32 scores * sm_scale, mask cols <= rows with
    equal segment ids, f32 softmax, f32 p @ v, cast to q's dtype."""
    t, hq, d = q.shape
    rep = hq // k.shape[1]
    scale = sm_scale if sm_scale is not None else d ** -0.5
    qf = q.float().transpose(0, 1)                                # [Hq,T,D]
    kf = k.float().transpose(0, 1).repeat_interleave(rep, dim=0)
    vf = v.float().transpose(0, 1).repeat_interleave(rep, dim=0)
    scores = torch.matmul(qf, kf.transpose(-1, -2)) * scale       # [Hq,T,T]
    rows = torch.arange(t, device=q.device)
    seg = seg_ids.long()
    mask = (rows[None, :] <= rows[:, None]) & (seg[:, None] == seg[None, :])
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    return torch.matmul(probs, vf).to(q.dtype).transpose(0, 1)


def packed_prefill_attention_kernel(q, k, v, seg_ids, sm_scale=None):
    """q: [T, Hq, D]; k, v: [T, Hkv, D]; seg_ids: [T] int32 (-1 pad).
    Returns [T, Hq, D] in q's dtype (pad rows undefined)."""
    if q.device.type == "cpu":
        return packed_prefill_attention_kernel_plain(q, k, v, seg_ids,
                                                     sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"packed_prefill_attention_kernel: unsupported "
                         f"device {q.device}")
    t, hq, d = q.shape
    hkv = k.shape[1]
    if (q.dtype not in _build.DTYPE_CODES or k.dtype != q.dtype
            or v.dtype != q.dtype):
        raise TypeError(f"packed_prefill_attention_kernel: unsupported dtypes"
                        f" {q.dtype}/{k.dtype}/{v.dtype}")
    if (d not in _build.HEAD_DIMS or t < 1 or hq % hkv or k.shape != (t, hkv, d)
            or v.shape != k.shape):
        raise ValueError(f"packed_prefill_attention_kernel: shapes q "
                         f"{tuple(q.shape)} k {tuple(k.shape)} v "
                         f"{tuple(v.shape)}")
    seg_ids = seg_ids.to(torch.int32)
    if (any(x.device != q.device or not x.is_contiguous()
            for x in (q, k, v, seg_ids)) or seg_ids.shape != (t,)):
        raise ValueError("packed_prefill_attention_kernel: tensors must be "
                         "contiguous and on one device, seg_ids [T]")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("packed_prefill_attention_kernel: q, k and v must "
                         "be 16-byte aligned (the tile loads 16-byte "
                         "chunks)")
    scale = sm_scale if sm_scale is not None else d ** -0.5
    lib = _build.load("packed_prefill_attention", _SIGNATURES)
    out = torch.empty_like(q)
    err = lib.tllm_packed_prefill_attention(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(seg_ids),
        _build.ptr(out), _build.DTYPE_CODES[q.dtype], t, hq, hkv, d,
        float(scale), q.device.index or 0, _build.stream_of(q))
    _build.check(err, "packed_prefill_attention_kernel")
    packed_prefill_attention_kernel.launches += 1
    return out


packed_prefill_attention_kernel.launches = 0
