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

Tensor parallelism (`part=`, the JAX package's ColumnLinear / RowLinear
roles, `ops/linear.py:68-100` there) acts on the tp group that the
running session publishes in `registry.KERNELS["tp_group"]`, where the
JAX package publishes its mesh. With no group (or one rank) `part` is
ignored. Each rank holds its shard (`parallel/sharding.py`):
- "col": the local kernel on the rank's output columns; no collective;
- "row": the local kernel on the rank's K shard, then a sum over the
  ranks (`parallel/comm.py`). `_row_overlap` splits it as the JAX one
  does: at least `overlap_min_rows` rows and an N of `overlap_chunks`
  windows of whole 128 columns take one windowed launch (`n_window`) per
  window, each followed by its asynchronous all-reduce, waited on in
  order; otherwise one launch and one all-reduce. A per-token SmoothQuant
  input is quantized with the all-ranks maximum of each row's absmax, as
  the JAX package quantizes the full row before sharding it; a static one
  quantizes locally with its static scale (row 5, one all-reduce).
- `dense_fused` runs no prologue or residual inside a kernel while a tp
  group is active (the JAX package's `_kern` is None under a mesh): it
  composes the plain ops, and adds the residual once, after the sum.
"""

from __future__ import annotations

import contextlib

import torch

from ..parallel import comm
from ..quantization.tensors import (FP8Weight, SQWeight, WOQWeight,
                                    quantize_int8, quantize_per_token,
                                    quantize_static)
from .kernels import fp8_matmul as _fp8
from .kernels import w8a8_matmul as _w8a8
from .kernels import woq_matmul as _woq
from .norm import rms_norm
from .registry import KERNELS

# Row count up to which dense_fused runs the norm prologue / residual
# epilogue inside kernel 1 or 6 (the JAX registry's fuse_decode_max_rows).
FUSE_MAX_ROWS = 16


def tp_group():
    """The published tp group, or None for one rank."""
    group = KERNELS["tp_group"]
    return group if comm.group_size(group) > 1 else None


@contextlib.contextmanager
def tp_scope(group):
    """Publish `group` (None: one device) as the tp group of the calls
    inside, and restore the one before on the way out."""
    prev, KERNELS["tp_group"] = KERNELS["tp_group"], group
    try:
        yield
    finally:
        KERNELS["tp_group"] = prev


def dense(x, w, out_dtype=None, layer=None, part=None):
    """y = x @ w. x: [..., K]; w: [K, N] tensor, WOQWeight or FP8Weight, or
    stacked [L, ...] with `layer` selecting the slice (the kernel reads the
    stacked weight in place). Returns [..., N] in out_dtype (default x's
    dtype). part: "col" / "row" under tensor parallelism (module note)."""
    out_dtype = out_dtype or x.dtype
    group = tp_group() if part == "row" else None
    if group is not None:
        return _dense_row(x, w, out_dtype, layer, group)
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
                   layer=None, part=None):
    """y = dequant(x_q) @ w for an activation already quantized per token
    (the rms_norm_quant -> W8A8 path: quantize once, fan out to the q/k/v
    or gate/up projections). Only for per-token SQWeights: with `layer`
    the stacked kernel (row 6), without it the 2-D one (row 5). part="row"
    under a tp group: x_q is this rank's K shard, quantized with the
    all-ranks scales s_x, and the outputs are summed over the ranks."""
    if not (isinstance(w, SQWeight) and w.per_token):
        raise ValueError("dense_prequant needs a per-token SQWeight")
    group = tp_group() if part == "row" else None
    if group is None:
        return _sq_matmul(x_q, s_x, w, out_dtype, layer)
    if layer is None:
        y = _sq_matmul(x_q, s_x, w, torch.float32, layer)
        return comm.all_reduce_sum(y, group).to(out_dtype)
    return _row_overlap(
        lambda win: _w8a8.w8a8_matmul_stacked(
            x_q, w.qweight, s_x, w.scale_w, layer, n_window=win),
        x_q, w.qweight.shape[-1], out_dtype, group)


def _row_overlap(mm, x, n: int, out_dtype, group):
    """The row-parallel matmul mm(n_window) summed over the ranks, split
    into overlap_chunks column windows where the rows and N allow it (the
    JAX package's `_row_overlap`): each window's launch is followed by its
    asynchronous all-reduce, so the next window's matmul runs while it is
    in flight; the windows are waited on in order. Column windows
    reassociate no K sum: bit-identical to one launch and one all-reduce."""
    chunks = int(KERNELS.get("overlap_chunks") or 0)
    min_rows = int(KERNELS.get("overlap_min_rows", 64))
    rows = x.numel() // x.shape[-1]
    if (chunks > 1 and rows >= min_rows and n % chunks == 0
            and (n // chunks) % 128 == 0):
        nc = n // chunks
        pending = [comm.all_reduce_sum(mm((c * nc, nc)), group,
                                       async_op=True)
                   for c in range(chunks)]
        for _, work in pending:
            work.wait()
        return torch.cat([y for y, _ in pending], dim=-1).to(out_dtype)
    return comm.all_reduce_sum(mm(None), group).to(out_dtype)


def _dense_row(x, w, out_dtype, layer, group):
    """Row-parallel dense on this rank's K shard x, summed over the ranks
    (module note)."""
    n = w.qweight.shape[-1] if hasattr(w, "qweight") else w.shape[-1]
    if layer is not None and isinstance(w, WOQWeight):
        return _row_overlap(lambda win: _woq.woq_matmul_stacked(
            x, w, layer, n_window=win), x, n, out_dtype, group)
    if layer is not None and isinstance(w, FP8Weight):
        return _row_overlap(lambda win: _fp8.fp8_matmul_stacked(
            x, w, layer, n_window=win), x, n, out_dtype, group)
    if isinstance(w, SQWeight) and w.per_token:
        # the full row's per-token absmax: each rank holds a K shard of it
        amax = comm.all_reduce_max(x.float().abs().amax(dim=-1, keepdim=True),
                                   group)
        s_x = amax.clamp_min(1e-8) / 127.0
        return dense_prequant(quantize_int8(x, s_x), s_x, w, out_dtype, layer,
                              part="row")
    # static SmoothQuant (row 5), the 2-D containers and plain weights: the
    # local product, one all-reduce
    y = dense(x, w, torch.float32, layer)
    return comm.all_reduce_sum(y, group).to(out_dtype)


def dense_fused(x, w, layer=None, out_dtype=None, *, norm_w=None,
                eps: float = 1e-6, swiglu: bool = False, resid=None,
                part=None):
    """out = [resid +] dense(h, w) with h = rms_norm(x, norm_w[layer]), or
    silu(g) * u of x [..., 2K] = [g | u] (swiglu), or x.

    At up to FUSE_MAX_ROWS rows with a stacked WOQ or FP8 weight the
    prologue and the residual epilogue run inside the kernel (PERF.md rows
    2 and 4); otherwise (and for every SQWeight) the plain ops are composed
    in the same rounding order (the norm, or silu in f32, cast to x's dtype
    before the matmul; the matmul cast before the residual add). norm_w
    with swiglu raises (one input prologue per matmul). part: as dense's;
    under a tp group nothing is fused and the residual is added once,
    after the ranks' sum."""
    rows = x.numel() // x.shape[-1]
    fusible = (layer is not None and rows <= FUSE_MAX_ROWS
               and (part is None or tp_group() is None)
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
    y = dense(h, w, out_dtype, layer, part)
    return (resid + y).to(y.dtype) if resid is not None else y


def embedding_lookup(table, ids, out_dtype=None):
    """Embedding gather."""
    out = table[ids.long()]
    return out.to(out_dtype) if out_dtype else out


def prompt_tuning_lookup(table, prompt_table, ids, tasks, task_vocab_size,
                         vocab_size, out_dtype=None):
    """Prompt-tuning embedding (the JAX package's, after the reference's
    PromptTuningEmbedding.forward, layers/embedding.py:38-81): ids below
    vocab_size gather from the normal table; ids >= vocab_size are virtual
    tokens that index the task's block of the concatenated prompt table.

    table: [V, D]; prompt_table: [num_tasks * task_vocab_size, D]; ids:
    [B, S], virtual ids in [V, V + task_vocab_size); tasks: [B] task index
    of each sequence. Each gather reads an index in its table's range (a
    virtual position reads normal row 0 and a real one the task's first
    prompt row, as JAX's jnp.where does; a virtual index past the table is
    clamped to its last row), since an out-of-range gather on the card is
    a device-side assert where JAX fills."""
    is_prompt = ids >= vocab_size
    normal = embedding_lookup(table, torch.where(is_prompt, 0, ids),
                              out_dtype)
    vids = (torch.where(is_prompt, ids - vocab_size, 0)
            + (tasks.long() * task_vocab_size)[:, None])
    virtual = embedding_lookup(prompt_table,
                               vids.clamp(0, prompt_table.shape[0] - 1),
                               out_dtype)
    return torch.where(is_prompt[..., None], virtual, normal)
