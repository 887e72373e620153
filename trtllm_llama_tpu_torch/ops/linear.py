"""Linear ops with quantized-weight dispatch (the port's `ops/linear.py`).

`dense` dispatches on the weight container, as the JAX package's `dense`
does (`ops/linear.py:100-117`). A plain tensor goes to a stock product (as
the JAX package leaves it to XLA; on the card a bf16 / fp16 GEMM with f32
accumulation that never copies the weight to f32). A `WOQWeight` (int8 or
int4, per-channel or grouped) goes to `ops/kernels/woq_matmul.py` and an
`FP8Weight` to `ops/kernels/fp8_matmul.py`: with `layer` to the stacked
entry (PERF.md rows 2 and 4), without (the lm_head) to the 2-D one (rows 1
and 3). An `SQWeight` takes the activation quantized by plain torch ops
(as the JAX package quantizes outside its kernel): a per-token one with
`layer` goes to `w8a8_matmul_stacked` (row 6); a static one (one
per-tensor activation scale) with `layer` is indexed to that layer's
views and, like any SQWeight without `layer`, goes to the 2-D
`w8a8_matmul` (row 5), as the JAX package's `_index_layer` and
`_dense_sq` do.
`dense_prequant` feeds row 6 (or row 5 without `layer`) an activation
already quantized by `rms_norm_quant`. `dense_fused` runs the norm or
SwiGLU prologue and the residual epilogue inside rows 2 and 4 at decode
shapes. Each kernel wrapper takes its plain version for CPU tensors and
raises on the card for a weight its kernel does not tile (N not a
multiple of 16; for W8A8 also K % 4).
"""

from __future__ import annotations

import torch

from ..quantization.tensors import (FP8Weight, SQWeight, WOQWeight,
                                    quantize_per_token, quantize_static)
from .kernels import fp8_matmul as _fp8
from .kernels import w8a8_matmul as _w8a8
from .kernels import woq_matmul as _woq
from .norm import rms_norm

# Row count up to which dense_fused runs the norm prologue / residual
# epilogue inside kernel 1 or 6 (the JAX registry's fuse_decode_max_rows).
FUSE_MAX_ROWS = 16


def dense(x, w, out_dtype=None, layer=None):
    """y = x @ w. x: [..., K]; w: [K, N] tensor, WOQWeight or FP8Weight, or
    stacked [L, ...] with `layer` selecting the slice (the kernel reads the
    stacked weight in place). Returns [..., N] in out_dtype (default x's
    dtype)."""
    out_dtype = out_dtype or x.dtype
    if isinstance(w, WOQWeight):
        y = (_woq.woq_matmul(x, w) if layer is None
             else _woq.woq_matmul_stacked(x, w, layer))
        return y.to(out_dtype)
    if isinstance(w, FP8Weight):
        y = (_fp8.fp8_matmul(x, w) if layer is None
             else _fp8.fp8_matmul_stacked(x, w, layer))
        return y.to(out_dtype)
    if isinstance(w, SQWeight):
        return _dense_sq(x, w, out_dtype, layer)
    if layer is not None:
        w = w[layer]
    w = w.to(x.dtype)
    if x.device.type == "cuda" and x.dtype != torch.float32:
        # a compute-dtype GEMM with an f32 output (torch.mm's out_dtype):
        # cuBLAS sums in f32 whatever torch's reduced-precision reduction
        # flags say, the result rounds once, and the weight is never
        # copied to f32
        y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], w.shape[-1]).to(out_dtype)
    # f32 products of the compute-dtype operands, f32 sum, one final cast:
    # the JAX package's dot(..., preferred_element_type=f32).astype(out)
    y = torch.matmul(x.float(), w.float())
    return y.to(out_dtype)


def _index_layer(w: SQWeight, layer: int) -> SQWeight:
    """The SQWeight of one stacked layer (views, no copy)."""
    return SQWeight(w.qweight[layer], w.scale_w[layer], w.scale_x[layer],
                    w.scale_y[layer], w.per_channel, w.per_token)


def _sq_matmul(x_q, s_x, w: SQWeight, out_dtype, layer):
    if layer is None:
        y = _w8a8.w8a8_matmul(x_q, w.qweight, s_x, w.scale_w)
    else:
        y = _w8a8.w8a8_matmul_stacked(x_q, w.qweight, s_x, w.scale_w, layer)
    return y.to(out_dtype)


def _dense_sq(x, w: SQWeight, out_dtype=None, layer=None):
    """SmoothQuant dense: int8 x (dynamic per-token scales, or the static
    per-tensor scale_x) times the int8 weight, dequantized in f32. Only a
    per-token weight keeps its layer axis (the stacked kernel)."""
    if layer is not None and not w.per_token:
        w, layer = _index_layer(w, layer), None
    if w.per_token:
        x_q, s_x = quantize_per_token(x)
    else:
        s_x = w.scale_x
        x_q = quantize_static(x, s_x)
    return _sq_matmul(x_q, s_x, w, out_dtype or x.dtype, layer)


def dense_prequant(x_q, s_x, w: SQWeight, out_dtype=torch.bfloat16,
                   layer=None):
    """y = dequant(x_q) @ w for an activation already quantized per token
    (the rms_norm_quant -> W8A8 path: quantize once, fan out to the q/k/v
    or gate/up projections). Only for per-token SQWeights: with `layer`
    the stacked kernel (row 6), without it the 2-D one (row 5)."""
    if not (isinstance(w, SQWeight) and w.per_token):
        raise ValueError("dense_prequant needs a per-token SQWeight")
    return _sq_matmul(x_q, s_x, w, out_dtype, layer)


def dense_fused(x, w, layer=None, out_dtype=None, *, norm_w=None,
                eps: float = 1e-6, swiglu: bool = False, resid=None):
    """out = [resid +] dense(h, w) with h = rms_norm(x, norm_w[layer]), or
    silu(g) * u of x [..., 2K] = [g | u] (swiglu), or x.

    At up to FUSE_MAX_ROWS rows with a stacked WOQ or FP8 weight the
    prologue and the residual epilogue run inside the kernel (PERF.md rows
    2 and 4); otherwise (and for every SQWeight) the plain ops are composed
    in the same rounding order (the norm, or silu in f32, cast to x's dtype
    before the matmul; the matmul cast before the residual add). norm_w
    with swiglu raises (one input prologue per matmul)."""
    rows = x.numel() // x.shape[-1]
    fusible = (layer is not None and rows <= FUSE_MAX_ROWS
               and (norm_w is not None or swiglu or resid is not None))
    kernel = (_woq.woq_matmul_stacked if isinstance(w, WOQWeight)
              else _fp8.fp8_matmul_stacked if isinstance(w, FP8Weight)
              else None)
    if fusible and kernel is not None:
        y = kernel(x, w, layer, norm_w=norm_w, eps=eps, resid=resid,
                   swiglu=swiglu)
        return y.to(out_dtype or x.dtype)
    if swiglu:      # the kernels' plain prologue; raises with norm_w
        h = _woq.prologue(x, norm_w, layer, eps, swiglu=True)
        h = h.reshape(*x.shape[:-1], h.shape[-1])
    elif norm_w is not None:
        nw = norm_w[layer] if layer is not None and norm_w.dim() > 1 else norm_w
        h = rms_norm(x, nw, eps)
    else:
        h = x
    y = dense(h, w, out_dtype, layer)
    return (resid + y).to(y.dtype) if resid is not None else y


def embedding_lookup(table, ids, out_dtype=None):
    """Embedding gather."""
    out = table[ids.long()]
    return out.to(out_dtype) if out_dtype else out
