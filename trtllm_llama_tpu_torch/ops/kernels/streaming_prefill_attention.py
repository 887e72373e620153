"""Row 12: GQA prefill attention for long prompts, causal or bidirectional
(csrc/streaming_prefill_attention.cu).

Replaces `trtllm_llama_tpu/ops/pallas/attention.py::
streaming_prefill_attention_kernel`, its ALiBi branch included (`alibi`:
[Hq] slopes, slope * key column added to the scaled scores before the
mask). Bound on the H100: operations, the causal 2*B*Hq*S^2*D flops
(0.56 ms per LLaMA-7B layer at S=8192 in bf16; P carried in three bf16
terms makes the tensor work ~1.1 ms). Design: bf16 / fp16 at head dims 64,
96 and 128 run a warp-specialized flash tile (csrc/flash_attention_ws.cuh:
a producer warpgroup keeps a ring of 64-key K/V tiles full by TMA, two
consumer warpgroups of 64 query rows share each tile and take turns on
the tensor cores, wgmma for Q K^T and P V, P kept at f32's precision as
three bf16 / two fp16 terms, an f32 online softmax in registers); head
dims 32 and 256 run row 10's tile (csrc/flash_attention.cuh, the same
contract), chosen by shape before launch; f32 inputs take a CUDA-core
loop. Key tiles past the block's rows or the sequence length are skipped
(see the sources' notes).

`causal=False` drops the col <= row mask (the length mask stays, as in
row 10's non-causal branch): every row block streams the key tiles
through the last valid column, and the warp-specialized tile's two
consumers see the same tiles with no diagonal; the bound doubles to the
full rectangle's flops.

`streaming_prefill_attention_kernel` takes the plain version for CPU tensors
and launches the kernel for CUDA tensors (head dims 32, 64, 96, 128 and
256; any other raises); `.launches` counts launches, `.noncausal_launches`
the non-causal ones among them.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .prefill_attention import alibi_bias

NEG_INF = -1e9
Q_BLOCK = 512   # query rows per step of the plain version

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"tllm_streaming_prefill_attention":
               [_P] * 6 + [_I] * 7 + [_F, _I, _P]}


def streaming_prefill_attention_kernel_plain(q, k, v, seq_lens=None,
                                             sm_scale=None, alibi=None,
                                             causal=True):
    """Plain PyTorch version, Q_BLOCK query rows at a time (f32 scores
    [B, Hq, Q_BLOCK, S], so memory grows with S, not S^2): f32 scores *
    sm_scale [+ alibi[h] * col], mask cols <= rows (when causal) and cols
    < seq_lens[b] with NEG_INF (a
    length of 0 averages V over all S columns), f32 softmax, f32 p @ v,
    cast to q's dtype."""
    b, s, hq, d = q.shape
    rep = hq // k.shape[2]
    scale = sm_scale if sm_scale is not None else d ** -0.5
    kf = k.float().transpose(1, 2).repeat_interleave(rep, dim=1)  # [B,Hq,S,D]
    vf = v.float().transpose(1, 2).repeat_interleave(rep, dim=1)
    cols = torch.arange(s, device=q.device)
    lens = (torch.full((b,), s, device=q.device) if seq_lens is None
            else seq_lens.to(q.device))
    bias = alibi_bias(alibi, cols)
    out = torch.empty_like(q)
    for r0 in range(0, s, Q_BLOCK):
        rows = cols[r0:r0 + Q_BLOCK]
        qf = q[:, r0:r0 + Q_BLOCK].float().transpose(1, 2)       # [B,Hq,R,D]
        scores = (torch.matmul(qf, kf.transpose(-1, -2)) * scale
                  + bias)                                        # [B,Hq,R,S]
        mask = cols[None, None, :] < lens[:, None, None]         # [B,1,S]
        if causal:
            mask = mask & (cols[None, :] <= rows[:, None])[None]  # [B,R,S]
        scores = torch.where(mask[:, None], scores,
                             torch.full_like(scores, NEG_INF))
        probs = torch.softmax(scores, dim=-1)
        out[:, r0:r0 + Q_BLOCK] = torch.matmul(probs, vf).to(
            q.dtype).transpose(1, 2)
    return out


def streaming_prefill_attention_kernel(q, k, v, seq_lens=None, sm_scale=None,
                                       alibi=None, causal=True):
    """q: [B, S, Hq, D]; k, v: [B, S, Hkv, D]; seq_lens: optional [B] int32
    valid lengths; alibi: optional [Hq] slopes; causal=False: the length
    mask alone. Returns [B, S, Hq, D] in q's dtype."""
    if q.device.type == "cpu":
        return streaming_prefill_attention_kernel_plain(
            q, k, v, seq_lens, sm_scale, alibi, causal=causal)
    if q.device.type != "cuda":
        raise ValueError("streaming_prefill_attention_kernel: unsupported "
                         f"device {q.device}")
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    if (q.dtype not in _build.DTYPE_CODES or k.dtype != q.dtype
            or v.dtype != q.dtype):
        raise TypeError("streaming_prefill_attention_kernel: unsupported "
                        f"dtypes {q.dtype}/{k.dtype}/{v.dtype}")
    if (d not in _build.HEAD_DIMS or hq % hkv or k.shape != (b, s, hkv, d)
            or v.shape != k.shape):
        raise ValueError("streaming_prefill_attention_kernel: shapes q "
                         f"{tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if seq_lens is None:
        seq_lens = torch.full((b,), s, dtype=torch.int32, device=q.device)
    seq_lens = seq_lens.to(torch.int32)
    if alibi is not None:
        alibi = alibi.to(device=q.device, dtype=torch.float32).contiguous()
    if (any(t.device != q.device or not t.is_contiguous()
            for t in (q, k, v, seq_lens)) or seq_lens.shape != (b,)
            or any(t.data_ptr() % 16 for t in (q, k, v))
            or (alibi is not None and alibi.shape != (hq,))):
        raise ValueError("streaming_prefill_attention_kernel: tensors must be"
                         " contiguous, 16-byte aligned and on one device, "
                         "seq_lens [B], alibi [Hq]")
    scale = sm_scale if sm_scale is not None else d ** -0.5
    lib = _build.load("streaming_prefill_attention", _SIGNATURES)
    out = torch.empty_like(q)
    err = lib.tllm_streaming_prefill_attention(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(seq_lens),
        _build.ptr(alibi), _build.ptr(out), _build.DTYPE_CODES[q.dtype], b,
        s, hq, hkv, d, int(bool(causal)),
        float(scale), q.device.index or 0, _build.stream_of(q))
    _build.check(err, "streaming_prefill_attention_kernel")
    streaming_prefill_attention_kernel.launches += 1
    if not causal:
        streaming_prefill_attention_kernel.noncausal_launches += 1
    return out


streaming_prefill_attention_kernel.launches = 0
streaming_prefill_attention_kernel.noncausal_launches = 0
