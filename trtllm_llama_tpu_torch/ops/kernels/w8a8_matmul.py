"""Kernel 5: W8A8 (int8 x int8 -> int32) matmul with the dequantizing
epilogue (csrc/w8a8_matmul.cu).

Replaces `trtllm_llama_tpu/ops/pallas/w8a8_matmul.py::w8a8_matmul_stacked`
(row 6) and, through a unit layer axis, its 2-D form `w8a8_matmul` (row
5: static SmoothQuant, a per-token weight without a layer). Bound on the
H100: the int8 weight bytes, read once; the design transposes 4x4 byte
blocks of the N-contiguous weight and accumulates with dp4a over split-K
blocks that fill all SMs (see the source's header note).

`w8a8_matmul_stacked` and `w8a8_matmul` take the plain version for CPU
tensors and launch the kernel for CUDA tensors; each counts its launches
in its own `.launches`.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .woq_matmul import _rows_per_tile, _sm_count, _split_k

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"tllm_w8a8_matmul_stacked":
               [_P, _P, _P, _I, _P, _I, _P, _P] + [_I] * 7 + [_P]}


def w8a8_matmul_stacked_plain(x_q, w_q, s_x, s_w, layer: int):
    """Plain PyTorch version: the int8 products summed exactly (in float64:
    every partial sum is an integer below 2**53; the card's torch.matmul
    has no int8 or int32 product), converted to f32, then
    (acc * s_x) * s_w[layer] in f32. Returns f32 [..., N]."""
    k = x_q.shape[-1]
    acc = torch.matmul(x_q.reshape(-1, k).double(), w_q[layer].double())
    y = (acc.float() * s_x.float().reshape(-1, 1)
         * s_w[layer].float().reshape(1, -1))
    return y.reshape(*x_q.shape[:-1], y.shape[-1])


def _launch(what, x_q, w_q, s_x, s_w, layer: int):
    """Check the operands of the kernel and launch it on layer `layer` of
    the stacked w_q. Returns f32 [..., N]."""
    if x_q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x_q.device}")
    n_layers, k, n = w_q.shape
    m = x_q.numel() // k if x_q.shape[-1] == k else -1
    if (x_q.dtype != torch.int8 or w_q.dtype != torch.int8
            or s_x.dtype != torch.float32 or s_w.dtype != torch.float32):
        raise TypeError(f"{what}: x_q and w_q must be int8, s_x and s_w f32")
    if (m < 0 or not 0 <= layer < n_layers or s_x.numel() not in (1, m)
            or s_w.shape not in ((n_layers, n), (n_layers, 1))):
        raise ValueError(f"{what}: x_q {tuple(x_q.shape)}, "
                         f"w_q {tuple(w_q.shape)}, s_x {tuple(s_x.shape)}, "
                         f"s_w {tuple(s_w.shape)}, layer {layer}")
    if n % 16 or k % 4 or w_q.data_ptr() % 16 or x_q.data_ptr() % 4:
        raise ValueError(f"{what}: needs N % 16 == 0, K % 4 == 0, a 16-byte "
                         "aligned weight and a 4-byte aligned x_q")
    if any(t.device != x_q.device or not t.is_contiguous()
           for t in (x_q, w_q, s_x, s_w)):
        raise ValueError(f"{what}: tensors must be contiguous and on one "
                         "device")

    lib = _build.load("w8a8_matmul", _SIGNATURES)
    ksplit, kc = _split_k(m, k, n, _sm_count(x_q.device))
    out = torch.empty((m, n), device=x_q.device, dtype=torch.float32)
    part = torch.empty((ksplit, m, n), device=x_q.device, dtype=torch.int32)
    sw_cols = s_w.shape[1]
    err = lib.tllm_w8a8_matmul_stacked(
        _build.ptr(x_q), _P(w_q.data_ptr() + layer * k * n), _build.ptr(s_x),
        int(s_x.numel() != 1), _P(s_w.data_ptr() + layer * sw_cols * 4),
        int(sw_cols != 1), _build.ptr(out), _build.ptr(part), m, k, n, ksplit,
        kc, _rows_per_tile(m), x_q.device.index or 0, _build.stream_of(x_q))
    _build.check(err, what)
    return out.reshape(*x_q.shape[:-1], n)


def w8a8_matmul_stacked(x_q, w_q, s_x, s_w, layer: int):
    """y = (f32(x_q @ w_q[layer]) * s_x) * s_w[layer].

    x_q: int8 [..., K]; w_q: stacked int8 [L, K, N]; s_x: f32 per-row
    [..., 1] or one static value (numel 1); s_w: f32 [L, N] per-channel or
    [L, 1] per-tensor. Returns f32 [..., N]."""
    if x_q.device.type == "cpu":
        return w8a8_matmul_stacked_plain(x_q, w_q, s_x, s_w, layer)
    out = _launch("w8a8_matmul_stacked", x_q, w_q, s_x, s_w, layer)
    w8a8_matmul_stacked.launches += 1
    return out


w8a8_matmul_stacked.launches = 0


def w8a8_matmul_plain(x_q, w_q, s_x, s_w):
    """Plain version of the 2-D entry."""
    return w8a8_matmul_stacked_plain(x_q, w_q[None], s_x,
                                     s_w.reshape(1, -1), 0)


def w8a8_matmul(x_q, w_q, s_x, s_w):
    """2-D entry: y = (f32(x_q @ w_q) * s_x) * s_w. w_q int8 [K, N]; s_x
    f32 per-row [..., 1] or one static value; s_w f32 [N] per-channel or
    [1] per-tensor. The stacked kernel on a unit layer axis (views, no
    copy). Returns f32 [..., N]."""
    if x_q.device.type == "cpu":
        return w8a8_matmul_plain(x_q, w_q, s_x, s_w)
    out = _launch("w8a8_matmul", x_q, w_q[None], s_x, s_w.reshape(1, -1), 0)
    w8a8_matmul.launches += 1
    return out


w8a8_matmul.launches = 0
