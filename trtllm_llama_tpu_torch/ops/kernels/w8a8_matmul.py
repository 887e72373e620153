"""Kernel 5: W8A8 (int8 x int8 -> int32) matmul with the dequantizing
epilogue: the dp4a kernel (csrc/w8a8_matmul.cu) at decode rows and the
int8 tensor-core GEMM (csrc/w8a8_gemm.cu) at prefill rows.

Replaces `trtllm_llama_tpu/ops/pallas/w8a8_matmul.py::w8a8_matmul_stacked`
(row 6) and, through a unit layer axis, its 2-D form `w8a8_matmul` (row
5: static SmoothQuant, a per-token weight without a layer). Both kernels
sum exactly in int32 and scale (f32(acc) * s_x) * s_w in f32, so either
gives the plain version's output bit for bit. Bound on the H100: the int8
weight bytes at decode rows, which the dp4a kernel streams once in one
launch over a grid of column tiles x K splits that fills all SMs
(woq_matmul.gemv_plan); the int8 operations from ~300 rows on,
which the GEMM runs on `wgmma` s8 tiles (see each source's header note).

Which kernel runs is decided from the call's shape before launch
(`w8a8_gemm_route`): the GEMM for calls of at least W8A8_GEMM_MIN_ROWS
rows on a K in whole 128-column tiles, the dp4a kernel otherwise.

`w8a8_matmul_stacked` and `w8a8_matmul` take the plain version for CPU
tensors and launch a kernel for CUDA tensors; each counts its launches
in its own `.launches`, the GEMM's share of them in `.gemm_launches`.
`w8a8_matmul_stacked` takes the JAX kernel's `n_window=(start, length)`
(tensor parallelism's row-parallel overlap): only the output columns
[start, start + length), read from the weight in place with the full N
as the row stride, on whole 128 columns (`woq_matmul.check_window`),
counted in `.window_launches`; the sums are exact, so a window is the
full call's columns bit for bit on either kernel.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from . import woq_matmul
from .woq_matmul import (_GEMM_BN, GEMM_TILE_K, _gemm_split, _sm_count,
                         check_window)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"tllm_w8a8_matmul_stacked":
               [_P, _P, _P, _I, _P, _I, _P, _P, _P] + [_I] * 9 + [_P]}
_GEMM_SIGNATURES = {"tllm_w8a8_gemm":
                    [_P, _P, _P, _I, _P, _I, _P, _P] + [_I] * 8 + [_P]}

# The GEMM takes calls of at least this many rows: the measured crossover
# (chip_smoke.py times both kernels at 1-1024 rows on LLaMA-7B's shapes;
# PERF.md rows 5 and 6). Below it the dp4a kernel, whose time grows with
# its row tile, streams the weight faster than the GEMM's fixed 128-row
# tile loop; from it on the GEMM is the faster at every shape.
W8A8_GEMM_MIN_ROWS = 5


def w8a8_gemm_route(rows: int, k: int, n: int) -> bool:
    """True where a CUDA call goes to the int8 tensor-core GEMM, False
    where it goes to the dp4a kernel: the GEMM takes calls of at least
    W8A8_GEMM_MIN_ROWS rows on a layout it tiles (K in whole 128-column
    tiles, N a multiple of 16)."""
    return (rows >= W8A8_GEMM_MIN_ROWS and k > 0 and k % GEMM_TILE_K == 0
            and n > 0 and n % 16 == 0)


def w8a8_matmul_stacked_plain(x_q, w_q, s_x, s_w, layer: int,
                              n_window=None):
    """Plain PyTorch version: the int8 products summed exactly (in float64:
    every partial sum is an integer below 2**53; the card's torch.matmul
    has no int8 or int32 product), converted to f32, then
    (acc * s_x) * s_w[layer] in f32. Returns f32 [..., N], or with
    n_window=(start, length) the columns [start, start + length) alone."""
    k = x_q.shape[-1]
    wl, sw = w_q[layer], s_w[layer]
    window = check_window("w8a8_matmul_stacked", n_window, w_q.shape[-1])
    if window is not None:
        cols = slice(window[0], sum(window))
        wl, sw = wl[:, cols], (sw[cols] if sw.numel() > 1 else sw)
    acc = torch.matmul(x_q.reshape(-1, k).double(), wl.double())
    y = (acc.float() * s_x.float().reshape(-1, 1)
         * sw.float().reshape(1, -1))
    return y.reshape(*x_q.shape[:-1], y.shape[-1])


def gemm_tiling(m: int, k: int, n: int, n_sm: int):
    """(rows per block tile, ksplit, kt_per) of the GEMM. A 256-row tile
    takes ~1.5x a 128-row tile's time for twice the rows (measured at 1024
    and 8192 rows on every LLaMA-7B projection), so it is taken where it
    needs fewer than 2/3 of the 128-row grid's waves of blocks over the
    SMs; the 128-row grid splits K over whole tiles while it has fewer
    tiles than SMs (_gemm_split)."""
    def waves(rows):
        return -(-(-(-m // rows) * -(-n // _GEMM_BN)) // n_sm)
    if 3 * waves(256) < 2 * waves(128):
        return 256, 1, k // GEMM_TILE_K
    return (128, *_gemm_split(m, k, n, n_sm))


def _check_operands(what, x_q, w_q, s_x, s_w, layer: int):
    """The checks both kernels make. Returns (M, K, N)."""
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
    return m, k, n


def _scale_args(w_q, s_x, s_w, layer: int, start: int = 0):
    """The layer's weight and scale pointers from column `start` (a
    window's first) with their steps (0: one value), as both C entries take
    them."""
    k, n = w_q.shape[1:]
    sw_cols = s_w.shape[1]
    sw_at = layer * sw_cols + (start if sw_cols != 1 else 0)
    return (_P(w_q.data_ptr() + layer * k * n + start), _build.ptr(s_x),
            int(s_x.numel() != 1), _P(s_w.data_ptr() + sw_at * 4),
            int(sw_cols != 1))


def launch_gemm(what, x_q, w_q, s_x, s_w, layer: int, window=None):
    """Check the operands of the int8 tensor-core GEMM and launch it on
    layer `layer` of the stacked w_q (window: (start, length) of the
    columns computed, tiled as the full N). Raises before launch for a K
    that is not whole 128-column tiles. Returns f32 [..., N or length]."""
    m, k, ldw = _check_operands(what, x_q, w_q, s_x, s_w, layer)
    start, n = window if window is not None else (0, ldw)
    if k % GEMM_TILE_K:
        raise ValueError(f"{what}: the GEMM takes K in whole {GEMM_TILE_K}-"
                         f"column tiles, got K={k}")
    x2 = x_q.reshape(m, k)
    if x2.data_ptr() % 16:            # cp.async reads x in 16-byte chunks
        x2 = x2.clone()
    lib = _build.load("w8a8_gemm", _GEMM_SIGNATURES)
    rows_tile, ksplit, kt_per = gemm_tiling(m, k, ldw, _sm_count(x_q.device))
    out = torch.empty((m, n), device=x_q.device, dtype=torch.float32)
    part = None if ksplit == 1 else torch.empty(
        (ksplit, m, n), device=x_q.device, dtype=torch.int32)
    err = lib.tllm_w8a8_gemm(
        _build.ptr(x2), *_scale_args(w_q, s_x, s_w, layer, start),
        _build.ptr(out), _build.ptr(part), m, k, n, ldw, ksplit, kt_per,
        rows_tile,
        x_q.device.index or 0, _build.stream_of(x_q))
    _build.check(err, what)
    return out.reshape(*x_q.shape[:-1], n)


def launch_dp4a(what, x_q, w_q, s_x, s_w, layer: int, window=None):
    """Check the operands of the dp4a kernel and launch it on layer
    `layer` of the stacked w_q: one launch on the grid of
    woq_matmul.gemv_plan (K splits of whole 16-row blocks: 4-row steps,
    a 16-byte aligned shared-memory layout), its splits
    merged in the stream's workspace (window: (start, length) of the
    columns computed, planned as the full N). Returns f32 [..., N or
    length]."""
    m, k, ldw = _check_operands(what, x_q, w_q, s_x, s_w, layer)
    start, n = window if window is not None else (0, ldw)
    lib = _build.load("w8a8_matmul", _SIGNATURES)
    plan = woq_matmul.gemv_plan(m, k, ldw, _sm_count(x_q.device), unit=16,
                                x_bytes=1)
    part, counters = _build.workspace(
        x_q.device, plan.ksplit * m * n if plan.ksplit > 1 else 0,
        -(-n // (16 * plan.lanes)))
    out = torch.empty((m, n), device=x_q.device, dtype=torch.float32)
    err = lib.tllm_w8a8_matmul_stacked(
        _build.ptr(x_q), *_scale_args(w_q, s_x, s_w, layer, start),
        _build.ptr(out), _build.ptr(part), _build.ptr(counters), m, k, n,
        ldw, plan.ksplit,
        plan.kc, plan.mr, plan.lanes, x_q.device.index or 0,
        _build.stream_of(x_q))
    _build.check(err, what)
    return out.reshape(*x_q.shape[:-1], n)


def _launch(what, x_q, w_q, s_x, s_w, layer: int, window=None):
    """(f32 [..., N or the window's length], whether the GEMM ran) for one
    CUDA call: the kernel w8a8_gemm_route picks from the call's shape."""
    k, n = w_q.shape[1:]
    gemm = w8a8_gemm_route(x_q.numel() // max(k, 1), k, n)
    launch = launch_gemm if gemm else launch_dp4a
    return launch(what, x_q, w_q, s_x, s_w, layer, window), gemm


def w8a8_matmul_stacked(x_q, w_q, s_x, s_w, layer: int, n_window=None):
    """y = (f32(x_q @ w_q[layer]) * s_x) * s_w[layer].

    x_q: int8 [..., K]; w_q: stacked int8 [L, K, N]; s_x: f32 per-row
    [..., 1] or one static value (numel 1); s_w: f32 [L, N] per-channel or
    [L, 1] per-tensor; n_window: (start, length), only the output columns
    [start, start + length). Returns f32 [..., N] ([..., length] with
    n_window). On the card the GEMM or the dp4a kernel runs, as
    w8a8_gemm_route decides from the shape."""
    if x_q.device.type == "cpu":
        return w8a8_matmul_stacked_plain(x_q, w_q, s_x, s_w, layer, n_window)
    window = check_window("w8a8_matmul_stacked", n_window, w_q.shape[-1])
    out, gemm = _launch("w8a8_matmul_stacked", x_q, w_q, s_x, s_w, layer,
                        window)
    w8a8_matmul_stacked.launches += 1
    w8a8_matmul_stacked.gemm_launches += int(gemm)
    w8a8_matmul_stacked.window_launches += int(window is not None)
    return out


w8a8_matmul_stacked.launches = 0
w8a8_matmul_stacked.gemm_launches = 0
w8a8_matmul_stacked.window_launches = 0


def w8a8_matmul_plain(x_q, w_q, s_x, s_w):
    """Plain version of the 2-D entry."""
    return w8a8_matmul_stacked_plain(x_q, w_q[None], s_x,
                                     s_w.reshape(1, -1), 0)


def w8a8_matmul(x_q, w_q, s_x, s_w):
    """2-D entry: y = (f32(x_q @ w_q) * s_x) * s_w. w_q int8 [K, N]; s_x
    f32 per-row [..., 1] or one static value; s_w f32 [N] per-channel or
    [1] per-tensor. The stacked kernels on a unit layer axis (views, no
    copy), counted in its own `.launches` and `.gemm_launches`. Returns
    f32 [..., N]."""
    if x_q.device.type == "cpu":
        return w8a8_matmul_plain(x_q, w_q, s_x, s_w)
    out, gemm = _launch("w8a8_matmul", x_q, w_q[None], s_x,
                        s_w.reshape(1, -1), 0)
    w8a8_matmul.launches += 1
    w8a8_matmul.gemm_launches += int(gemm)
    return out


w8a8_matmul.launches = 0
w8a8_matmul.gemm_launches = 0
