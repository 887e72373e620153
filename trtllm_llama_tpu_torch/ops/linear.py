"""Linear ops with quantized-weight dispatch (the port's `ops/linear.py`).

`dense` dispatches on the weight container: a plain tensor goes to a
stock product (as the JAX package leaves it to XLA; on the card a bf16 /
fp16 GEMM with f32 accumulation that never copies the weight to f32), a
`WOQWeight` (int8 or int4, per-channel or grouped) to kernel 1
(`ops/kernels/woq_matmul.py`), an `FP8Weight` to kernel 6
(`ops/kernels/fp8_matmul.py`), an `SQWeight` to kernel 5
(`ops/kernels/w8a8_matmul.py`) after quantizing the input per token (plain
torch ops, as the JAX package quantizes outside its kernel) or with the
static scale. A stacked weight with `layer` goes to a kernel's stacked
entry, a 2-D one (the lm_head) to its 2-D entry. `dense_prequant` feeds
kernel 5 an activation already quantized by `rms_norm_quant`. Each kernel
wrapper takes its plain version for CPU tensors and raises on the card for
a weight its kernel does not tile (N not a multiple of 16; for W8A8 also
K % 4).
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


def _sq_matmul(x_q, s_x, w: SQWeight, out_dtype, layer):
    if layer is None:
        y = _w8a8.w8a8_matmul(x_q, w.qweight, s_x, w.scale_w)
    else:
        y = _w8a8.w8a8_matmul_stacked(x_q, w.qweight, s_x, w.scale_w, layer)
    return y.to(out_dtype)


def _dense_sq(x, w: SQWeight, out_dtype=None, layer=None):
    """SmoothQuant dense: int8 x (dynamic per-token scales, or the static
    per-tensor scale_x) times the int8 weight, dequantized in f32."""
    if w.per_token:
        x_q, s_x = quantize_per_token(x)
    else:
        s_x = w.scale_x if layer is None else w.scale_x[layer]
        x_q = quantize_static(x, s_x)
    return _sq_matmul(x_q, s_x, w, out_dtype or x.dtype, layer)


def dense_prequant(x_q, s_x, w: SQWeight, out_dtype=torch.bfloat16,
                   layer=None):
    """y = dequant(x_q) @ w for an activation already quantized per token
    (the rms_norm_quant -> W8A8 path: quantize once, fan out to the q/k/v
    or gate/up projections). Only for per-token SQWeights."""
    if not (isinstance(w, SQWeight) and w.per_token):
        raise ValueError("dense_prequant needs a per-token SQWeight")
    return _sq_matmul(x_q, s_x, w, out_dtype, layer)


def dense_fused(x, w, layer=None, out_dtype=None, *, norm_w=None,
                eps: float = 1e-6, resid=None):
    """out = [resid +] dense(rms_norm(x, norm_w[layer]) | x, w).

    At up to FUSE_MAX_ROWS rows with a stacked WOQ or FP8 weight the norm
    prologue and residual epilogue run inside kernel 1 or 6; otherwise (and
    for every SQWeight) the plain ops are composed in the same rounding
    order (norm cast to x's dtype before the matmul, matmul cast before the
    residual add)."""
    rows = x.numel() // x.shape[-1]
    fusible = (layer is not None and rows <= FUSE_MAX_ROWS
               and (norm_w is not None or resid is not None))
    kernel = (_woq.woq_matmul_stacked if isinstance(w, WOQWeight)
              else _fp8.fp8_matmul_stacked if isinstance(w, FP8Weight)
              else None)
    if fusible and kernel is not None:
        y = kernel(x, w, layer, norm_w=norm_w, eps=eps, resid=resid)
        return y.to(out_dtype or x.dtype)
    if norm_w is not None:
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
