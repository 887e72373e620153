"""Kernel 2 (row 10): GQA prefill attention, causal or bidirectional
(csrc/prefill_attention.cu).

Replaces
`trtllm_llama_tpu/ops/pallas/attention.py::prefill_attention_kernel`, its
ALiBi branch included (`alibi`: [Hq] slopes, adding slope * key column to
the scaled scores before the mask, as the JAX kernel does). Bound on the
H100: the bytes of q and out and of each sequence's min(len, S) valid K/V
rows up to Task A's 1024 rows, the causal 4*Hq*D*pairs flops at longer
ones. bf16 / fp16 run the wgmma flash-attention tile of
`csrc/flash_attention.cuh`: one warpgroup per 64-row query tile and head, a
2-stage cp.async ring of K/V tiles, S = Q K^T and O += P V on the tensor
cores, the online softmax in registers with P carried through P V as three
bf16 (two fp16) terms (`split_p`), so that it keeps f32's precision as the
plain version does (rounded P moved path 7's logits by a third:
`attention_precision.py`), the mask only on tiles that cross the diagonal
or the length. On an H100 80GB HBM3 at 700 W, B=1 S=1024 len 923 with 32
heads of 128 (Task A's prefill) takes 0.0490 ms (19% of its 0.0095 ms byte
bound), against 0.0680 for SDPA with the same mask and 1.2989 for the
CUDA-core loop that f32 keeps (chip_smoke.py; PERF.md).

`causal=False` (the encoder's and ChatGLM's prefix-LM context) drops the
col <= row mask and keeps the length mask: every row, pad rows included,
attends the columns below its sequence's length, and a length of 0
averages V over all S columns, as the JAX package's XLA path does. The
tile streams each query tile's key tiles through the last valid column
and tests the length edge only; its bound doubles to the 4*Hq*D*S*len
flops of the full rectangle.

`prefill_attention_kernel` takes the plain version for CPU tensors and
launches the kernel for CUDA tensors (head dims 32, 64, 96, 128 and 256;
any other raises); `.launches` counts launches, `.noncausal_launches`
the non-causal ones among them.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

NEG_INF = -1e9

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"tllm_prefill_attention": [_P] * 6 + [_I] * 7 + [_F, _I, _P]}


def alibi_bias(alibi, cols):
    """f32 slope * key column, [Hq, 1, S] (0-d when alibi is None)."""
    if alibi is None:
        return torch.zeros((), device=cols.device)
    return alibi.float().reshape(-1, 1, 1) * cols.float()


def split_p(p, dtype, n):
    """p (f32) as n tensors of dtype, each the rounding of what the ones
    before it left (p - round(p) is exact in f32); returned in f32. Their
    sum is P as the card's tile carries it through P V (n = 3 for bf16, 2
    for fp16: p_terms<T>() in csrc/flash_attention.cuh). n = 1 is P
    rounded to dtype."""
    terms = []
    for _ in range(n):
        t = p.to(dtype).float()
        terms.append(t)
        p = p - t
    return terms


def prefill_attention_kernel_plain(q, k, v, seq_lens=None, sm_scale=None,
                                   alibi=None, p_terms=None, causal=True):
    """Plain PyTorch version: f32 scores * sm_scale [+ alibi[h] * col],
    mask cols <= rows (when causal) and cols < seq_lens[b] with NEG_INF
    (a length of 0 averages V over all S columns), f32 softmax,
    f32 p @ v, cast to q's dtype. p_terms = n carries the unnormalised P
    through P V as split_p(P, q's dtype, n) (the sum of P stays f32): a
    measure of how precisely P must be carried, not the contract."""
    b, s, hq, d = q.shape
    rep = hq // k.shape[2]
    scale = sm_scale if sm_scale is not None else d ** -0.5
    qf = q.float().transpose(1, 2)                                # [B,Hq,S,D]
    kf = k.float().transpose(1, 2).repeat_interleave(rep, dim=1)
    vf = v.float().transpose(1, 2).repeat_interleave(rep, dim=1)
    cols = torch.arange(s, device=q.device)
    scores = (torch.matmul(qf, kf.transpose(-1, -2)) * scale     # [B,Hq,S,S]
              + alibi_bias(alibi, cols))
    mask = (cols[None, :] <= cols[:, None] if causal
            else torch.ones((s, s), dtype=torch.bool, device=q.device))
    if seq_lens is not None:
        mask = mask & (cols[None, None, :] < seq_lens[:, None, None])
        mask = mask[:, None]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    if p_terms is None:
        out = torch.matmul(torch.softmax(scores, dim=-1), vf)
    else:
        p = torch.exp(scores - scores.amax(-1, keepdim=True))
        out = (torch.matmul(sum(split_p(p, q.dtype, p_terms)), vf)
               / p.sum(-1, keepdim=True))
    return out.to(q.dtype).transpose(1, 2)


def prefill_attention_kernel(q, k, v, seq_lens=None, sm_scale=None,
                             alibi=None, causal=True):
    """q: [B, S, Hq, D]; k, v: [B, S, Hkv, D]; seq_lens: optional [B] int32
    valid lengths; alibi: optional [Hq] slopes; causal=False: the length
    mask alone. Returns [B, S, Hq, D] in q's dtype."""
    if q.device.type == "cpu":
        return prefill_attention_kernel_plain(q, k, v, seq_lens, sm_scale,
                                              alibi, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"prefill_attention_kernel: unsupported device {q.device}")
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    if (q.dtype not in _build.DTYPE_CODES or k.dtype != q.dtype
            or v.dtype != q.dtype):
        raise TypeError(f"prefill_attention_kernel: unsupported dtypes "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if (d not in _build.HEAD_DIMS or hq % hkv or k.shape != (b, s, hkv, d)
            or v.shape != k.shape):
        raise ValueError(f"prefill_attention_kernel: shapes q {tuple(q.shape)}"
                         f" k {tuple(k.shape)} v {tuple(v.shape)}")
    if seq_lens is None:
        seq_lens = torch.full((b,), s, dtype=torch.int32, device=q.device)
    seq_lens = seq_lens.to(torch.int32)
    if alibi is not None:
        alibi = alibi.to(device=q.device, dtype=torch.float32).contiguous()
    if (any(t.device != q.device or not t.is_contiguous()
            for t in (q, k, v, seq_lens)) or seq_lens.shape != (b,)
            or (alibi is not None and alibi.shape != (hq,))):
        raise ValueError("prefill_attention_kernel: tensors must be "
                         "contiguous and on one device, seq_lens [B], "
                         "alibi [Hq]")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("prefill_attention_kernel: q, k and v must be "
                         "16-byte aligned (the tile loads 16-byte chunks)")
    scale = sm_scale if sm_scale is not None else d ** -0.5
    lib = _build.load("prefill_attention", _SIGNATURES)
    out = torch.empty_like(q)
    err = lib.tllm_prefill_attention(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(seq_lens),
        _build.ptr(alibi), _build.ptr(out), _build.DTYPE_CODES[q.dtype], b,
        s, hq, hkv, d, int(bool(causal)),
        float(scale), q.device.index or 0, _build.stream_of(q))
    _build.check(err, "prefill_attention_kernel")
    prefill_attention_kernel.launches += 1
    if not causal:
        prefill_attention_kernel.noncausal_launches += 1
    return out


prefill_attention_kernel.launches = 0
prefill_attention_kernel.noncausal_launches = 0
