"""Kernel 1: weight-only INT8 stacked matmul (csrc/woq_matmul.cu).

Replaces `trtllm_llama_tpu/ops/pallas/woq_matmul.py::woq_matmul_stacked`
(int8 branch, norm prologue, residual epilogue). Bound on the H100: the
int8 weight bytes, read once (a GEMV at M <= 16 does 2*M flops per byte);
the design streams them in 16-byte vectors over split-K blocks that fill
all SMs (see the source's header note).

`woq_matmul_stacked` takes the plain version for CPU tensors and launches
the kernel for CUDA tensors; `woq_matmul_stacked.launches` counts launches.
"""

from __future__ import annotations

import ctypes

import torch

from ...quantization.tensors import WOQWeight
from . import _build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"tllm_woq_matmul_stacked":
               [_P] * 7 + [_I] * 7 + [_F, _I, _P]}

_BN = 512          # output columns per block (kBN in the source)
_KC_MIN = 64       # fewest K rows a split-K block gets
_PART_BYTES = 32 << 20   # cap on the split-K partial buffer


_SM_COUNT: dict = {}


def _sm_count(device) -> int:
    n = _SM_COUNT.get(device.index)
    if n is None:
        n = torch.cuda.get_device_properties(device).multi_processor_count
        _SM_COUNT[device.index] = n
    return n


def _rows_per_tile(m: int) -> int:
    return 1 if m == 1 else 2 if m == 2 else 4 if m <= 4 else 8


def _split_k(m: int, k: int, n: int, n_sm: int):
    """(ksplit, kc): enough blocks for ~2 per SM, each with >= _KC_MIN rows
    of K, and the f32 partials within _PART_BYTES."""
    col_blocks = -(-n // _BN)
    ksplit = max(1, -(-2 * n_sm // col_blocks))
    ksplit = min(ksplit, max(1, k // _KC_MIN),
                 max(1, _PART_BYTES // (m * n * 4)))
    kc = -(-k // ksplit)
    kc = -(-kc // 8) * 8
    return -(-k // kc), kc


def woq_matmul_stacked_plain(x, w: WOQWeight, layer: int, norm_w=None,
                             eps: float = 1e-6, resid=None):
    """Plain PyTorch version. x [..., K] -> f32 [..., N] (the kernel's
    arithmetic: f32 products of the compute-dtype input and int8 weight,
    f32 sum, per-channel scale after the sum)."""
    w.check_supported()
    k = x.shape[-1]
    h = x.reshape(-1, k)
    if norm_w is not None:
        hf = h.float()
        var = (hf * hf).mean(dim=-1, keepdim=True)
        h = (hf * torch.rsqrt(var + eps) * norm_w[layer].float()).to(x.dtype)
    acc = torch.matmul(h.float(), w.qweight[layer].float()) * w.scale[layer]
    if resid is not None:
        r = resid.reshape(acc.shape)
        acc = (r + acc.to(r.dtype)).float()
    return acc.reshape(*x.shape[:-1], acc.shape[-1])


def woq_matmul_stacked(x, w: WOQWeight, layer: int, norm_w=None,
                       eps: float = 1e-6, resid=None):
    """y = [resid +] (norm(x) | x) @ (w.qweight[layer] * w.scale[layer]).

    x: [..., K] f32 or bf16; w: stacked int8 WOQWeight [L, K, N];
    norm_w: optional stacked [L, K] RMSNorm weight (prologue);
    resid: optional [..., N] in x's dtype (epilogue). Returns f32 [..., N].
    """
    if x.device.type == "cpu":
        return woq_matmul_stacked_plain(x, w, layer, norm_w, eps, resid)
    if x.device.type != "cuda":
        raise ValueError(f"woq_matmul_stacked: unsupported device {x.device}")
    w.check_supported()
    q, scale = w.qweight, w.scale
    n_layers, k, n = q.shape
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"woq_matmul_stacked: unsupported dtype {x.dtype}")
    if x.shape[-1] != k or not 0 <= layer < n_layers:
        raise ValueError(f"woq_matmul_stacked: x {tuple(x.shape)}, "
                         f"weight {tuple(q.shape)}, layer {layer}")
    if (n % 16 or q.data_ptr() % 16 or q.dtype != torch.int8
            or scale.dtype != torch.float32):
        raise ValueError("woq_matmul_stacked: weight must be 16-byte "
                         "aligned int8 with N % 16 == 0 and f32 scales")
    tensors = [x, q, scale] + [t for t in (norm_w, resid) if t is not None]
    if any(t.device != x.device or not t.is_contiguous() for t in tensors):
        raise ValueError("woq_matmul_stacked: tensors must be contiguous "
                         "and on one device")
    if norm_w is not None and (norm_w.dtype != x.dtype
                               or norm_w.shape != (n_layers, k)):
        raise ValueError("woq_matmul_stacked: norm_w must be [L, K] in x's dtype")
    m = x.numel() // k
    if resid is not None and (resid.dtype != x.dtype or resid.numel() != m * n):
        raise ValueError("woq_matmul_stacked: resid must be [..., N] in x's dtype")

    lib = _build.load("woq_matmul", _SIGNATURES)
    ksplit, kc = _split_k(m, k, n, _sm_count(x.device))
    out = torch.empty((m, n), device=x.device, dtype=torch.float32)
    part = out if ksplit == 1 else torch.empty(
        (ksplit, m, n), device=x.device, dtype=torch.float32)
    el = x.element_size()
    nw_ptr = (_P(norm_w.data_ptr() + layer * k * el)
              if norm_w is not None else _P(None))
    err = lib.tllm_woq_matmul_stacked(
        _build.ptr(x), _P(q.data_ptr() + layer * k * n),
        _P(scale.data_ptr() + layer * n * 4), nw_ptr, _build.ptr(resid),
        _build.ptr(out), _build.ptr(part), _build.DTYPE_CODES[x.dtype],
        m, k, n, ksplit, kc, _rows_per_tile(m), eps, x.device.index or 0,
        _build.stream_of(x))
    _build.check(err, "woq_matmul_stacked")
    woq_matmul_stacked.launches += 1
    return out.reshape(*x.shape[:-1], n)


woq_matmul_stacked.launches = 0
