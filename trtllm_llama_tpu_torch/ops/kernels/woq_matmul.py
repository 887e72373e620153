"""Kernel 1: weight-only INT8 / INT4 matmul (csrc/woq_matmul.cu, body in
csrc/woq_gemv.cuh).

Replaces `trtllm_llama_tpu/ops/pallas/woq_matmul.py::woq_matmul_stacked`
(int8 and int4 branches, per-channel or grouped scales, the norm and
SwiGLU prologues, the residual epilogue) and its 2-D form `woq_matmul`. Bound on the H100: the
weight bytes, read once (a GEMV at M <= 16 does 2*M flops per int8 byte,
4*M per int4 byte); the design streams them in 16-byte vectors over
split-K blocks that fill all SMs, with int4 unpacked in registers and x
staged in the pack layout's row order (see the header's note).

`woq_matmul_stacked` and `woq_matmul` take the plain version for CPU
tensors and launch the kernel for CUDA tensors; each counts its launches
in `.launches` (`woq_matmul_stacked.swiglu_launches` counts those of them
with the SwiGLU prologue). `launch_gemv` is shared with the fp8 wrapper.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ...quantization.tensors import WOQWeight
from . import _build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"tllm_woq_matmul_stacked":
               [_P] * 7 + [_I] * 10 + [_F, _I, _I, _P]}

_BN = 512          # output columns per block (kBN in the source)
_KT = 512          # logical K rows staged per pass (kKT in the source)
_KC_MIN = 64       # fewest K rows a split-K block gets
_PART_BYTES = 32 << 20   # cap on the split-K partial buffer


_SM_COUNT: dict = {}


def _sm_count(device) -> int:
    n = _SM_COUNT.get(device.index)
    if n is None:
        n = torch.cuda.get_device_properties(device).multi_processor_count
        _SM_COUNT[device.index] = n
    return n


def _rows_per_tile(m: int, max_rows: int = 8) -> int:
    r = 1 if m == 1 else 2 if m == 2 else 4 if m <= 4 else 8
    return min(r, max_rows)


def _split_k(m: int, k: int, n: int, n_sm: int, unit: int = 8):
    """(ksplit, kc): enough blocks for ~2 per SM, each with >= _KC_MIN rows
    of K, the f32 partials within _PART_BYTES, and kc a multiple of `unit`
    (a pack, interleave or scale-group block never straddles two splits)."""
    col_blocks = -(-n // _BN)
    ksplit = max(1, -(-2 * n_sm // col_blocks))
    ksplit = min(ksplit, max(1, k // _KC_MIN),
                 max(1, _PART_BYTES // (m * n * 4)))
    kc = -(-k // ksplit)
    kc = -(-kc // unit) * unit
    return -(-k // kc), kc


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def prologue(x, norm_w, layer: int, eps: float, swiglu: bool = False):
    """x [..., K] -> h [M, K] in x's dtype (the kernel's prologues): x;
    RMSNorm(x) * norm_w[layer] in f32, cast to x's dtype; or, with swiglu,
    x [..., 2K] = [g | u] -> silu(g) in f32, cast to x's dtype, times u."""
    h = x.reshape(-1, x.shape[-1])
    if swiglu:
        if norm_w is not None:
            raise ValueError("norm_w and swiglu are mutually exclusive")
        k = h.shape[-1] // 2
        return torch.nn.functional.silu(h[:, :k].float()).to(x.dtype) * h[:, k:]
    if norm_w is None:
        return h
    hf = h.float()
    var = (hf * hf).mean(dim=-1, keepdim=True)
    return (hf * torch.rsqrt(var + eps) * norm_w[layer].float()).to(x.dtype)


def resid_epilogue(acc, x, resid):
    """f32 acc [M, N] -> f32 [..., N]: [resid + acc cast to resid's dtype,
    in that dtype] (the unfused rounding order)."""
    if resid is not None:
        r = resid.reshape(acc.shape)
        acc = (r + acc.to(r.dtype)).float()
    return acc.reshape(*x.shape[:-1], acc.shape[-1])


def woq_matmul_stacked_plain(x, w: WOQWeight, layer: int, norm_w=None,
                             eps: float = 1e-6, resid=None,
                             swiglu: bool = False):
    """Plain PyTorch version. x [..., K] ([..., 2K] with swiglu) -> f32
    [..., N]: f32 products of the compute-dtype input and the int8 (or
    unpacked int4) codes, f32 sum, then the per-channel scale; grouped:
    each group's sum times its scale, summed over the groups."""
    w.check_supported()
    k = w.k_dim
    h = prologue(x, norm_w, layer, eps, swiglu).float()
    q = w.codes(layer).float()
    if w.group_size:
        g = w.group_size
        yg = torch.einsum("mgk,gkn->mgn", h.reshape(-1, k // g, g),
                          q.reshape(k // g, g, -1))
        acc = (yg * w.scale[layer]).sum(dim=1)
    else:
        acc = torch.matmul(h, q) * w.scale[layer]
    return resid_epilogue(acc, x, resid)


# ---------------------------------------------------------------------------
# kernel launch
# ---------------------------------------------------------------------------

def launch_gemv(what, lib_name, entry, signatures, x, q, scale, layer, k,
                fmt_args, unit, max_rows, norm_w=None, eps=1e-6, resid=None,
                swiglu=False):
    """Check the operands of one stacked GEMV kernel and launch it.

    q: stacked stored codes [L, K or K/2, N] (1 byte per element); scale:
    f32 [L, N] or grouped [L, K/g, N]; fmt_args: the entry's format ints
    (after the rows-per-tile argument); unit: the block that kc and every
    staged tile must be whole multiples of; max_rows: the largest row tile
    the format's kernel has (4 or 8); swiglu: x is [..., 2K] = [gate | up].
    Returns f32 [..., N]."""
    n_layers, n = q.shape[0], q.shape[-1]
    k_x = 2 * k if swiglu else k
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{what}: unsupported dtype {x.dtype}")
    if swiglu and norm_w is not None:
        raise ValueError(f"{what}: norm_w and swiglu are mutually exclusive")
    if x.shape[-1] != k_x or not 0 <= layer < n_layers:
        raise ValueError(f"{what}: x {tuple(x.shape)}, weight "
                         f"{tuple(q.shape)} (K={k}), layer {layer}")
    if (n % 16 or q.data_ptr() % 16 or scale.data_ptr() % 16
            or scale.dtype != torch.float32):
        raise ValueError(f"{what}: weight and scales must be 16-byte "
                         "aligned with N % 16 == 0 and f32 scales")
    # unit 8 only aligns kc; a larger unit is a block K must be whole of
    if _KT % unit or k % unit and unit > 8:
        raise ValueError(f"{what}: K={k} must be whole blocks of {unit}, "
                         f"a divisor of {_KT}")
    tensors = [x, q, scale] + [t for t in (norm_w, resid) if t is not None]
    if any(t.device != x.device or not t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: tensors must be contiguous and on one "
                         "device")
    if norm_w is not None and (norm_w.dtype != x.dtype
                               or norm_w.shape != (n_layers, k)):
        raise ValueError(f"{what}: norm_w must be [L, K] in x's dtype")
    m = x.numel() // k_x
    if resid is not None and (resid.dtype != x.dtype or resid.numel() != m * n):
        raise ValueError(f"{what}: resid must be [..., N] in x's dtype")

    lib = _build.load(lib_name, signatures)
    ksplit, kc = _split_k(m, k, n, _sm_count(x.device), unit)
    out = torch.empty((m, n), device=x.device, dtype=torch.float32)
    part = out if ksplit == 1 else torch.empty(
        (ksplit, m, n), device=x.device, dtype=torch.float32)
    nw_ptr = (_P(norm_w.data_ptr() + layer * k * x.element_size())
              if norm_w is not None else _P(None))
    err = getattr(lib, entry)(
        _build.ptr(x), _P(q.data_ptr() + layer * q.stride(0)),
        _P(scale.data_ptr() + layer * scale.stride(0) * 4), nw_ptr,
        _build.ptr(resid), _build.ptr(out), _build.ptr(part),
        _build.DTYPE_CODES[x.dtype], m, k, n, ksplit, kc,
        _rows_per_tile(m, max_rows), *fmt_args, eps, int(swiglu),
        x.device.index or 0, _build.stream_of(x))
    _build.check(err, what)
    return out.reshape(*x.shape[:-1], n)


def _launch(what, x, w: WOQWeight, layer, norm_w, eps, resid, swiglu=False):
    w.check_supported()
    n_layers, n = w.qweight.shape[0], w.qweight.shape[-1]
    grouped = bool(w.group_size)
    sshape = ((n_layers, w.k_dim // w.group_size, n) if grouped
              else (n_layers, n))
    if w.qweight.dtype != torch.int8 or w.scale.shape != sshape:
        raise ValueError(f"{what}: qweight must be int8 and scale "
                         f"{sshape}, got {tuple(w.scale.shape)}")
    unit = w.pack_block or w.group_size or 8
    max_rows = 4 if grouped else 8         # grouped: a second accumulator
    return launch_gemv(what, "woq_matmul", "tllm_woq_matmul_stacked",
                       _SIGNATURES, x, w.qweight, w.scale, layer, w.k_dim,
                       (w.w_bits, w.pack_block, w.group_size), unit, max_rows,
                       norm_w, eps, resid, swiglu)


def _device_kind(x, what):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")
    return x.device.type


def woq_matmul_stacked(x, w: WOQWeight, layer: int, norm_w=None,
                       eps: float = 1e-6, resid=None, swiglu: bool = False):
    """y = [resid +] (norm(x) | silu(g) * u | x) @ dequant(w.qweight[layer]).

    x: [..., K] f32, bf16 or fp16 ([..., 2K] = [g | u] with swiglu); w:
    stacked WOQWeight, int8 [L, K, N] or packed int4 [L, K/2, N], scale
    [L, N] or grouped [L, K/g, N]; norm_w: optional stacked [L, K] RMSNorm
    weight (prologue; not with swiglu); resid: optional [..., N] in x's
    dtype (epilogue). Returns f32 [..., N]."""
    if _device_kind(x, "woq_matmul_stacked") == "cpu":
        return woq_matmul_stacked_plain(x, w, layer, norm_w, eps, resid,
                                        swiglu)
    out = _launch("woq_matmul_stacked", x, w, layer, norm_w, eps, resid,
                  swiglu)
    woq_matmul_stacked.launches += 1
    woq_matmul_stacked.swiglu_launches += int(swiglu)
    return out


woq_matmul_stacked.launches = 0
woq_matmul_stacked.swiglu_launches = 0


def unit_layer(w):
    """A 2-D weight container (WOQWeight or FP8Weight) as a stack of one
    layer (views, no copy)."""
    return dataclasses.replace(w, qweight=w.qweight[None], scale=w.scale[None])


def woq_matmul_plain(x, w: WOQWeight):
    """Plain version of the 2-D entry."""
    return woq_matmul_stacked_plain(x, unit_layer(w), 0)


def woq_matmul(x, w: WOQWeight):
    """2-D entry: x [..., K] @ dequant(w), w int8 [K, N] or packed int4
    [K/2, N] with scale [N] or [K/g, N]; the stacked kernel on a unit layer
    axis, counted in its own `woq_matmul.launches`. Returns f32 [..., N]."""
    if _device_kind(x, "woq_matmul") == "cpu":
        return woq_matmul_plain(x, w)
    out = _launch("woq_matmul", x, unit_layer(w), 0, None, 1e-6, None)
    woq_matmul.launches += 1
    return out


woq_matmul.launches = 0
