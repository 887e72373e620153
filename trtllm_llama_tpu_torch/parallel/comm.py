"""The collectives of tensor parallelism: the port's counterpart of what
`shard_map` and GSPMD insert in the JAX package (the psum after a
row-parallel matmul, the gather of the vocabulary shards of the logits).

Every function is built from `all_reduce` alone, the collective that both
NCCL and gloo carry for CUDA tensors (gloo has no `all_gather` for them):
- `all_reduce_sum`, in place, with `async_op=True` returning the work
  handle as well (the row-parallel overlap waits on it later);
- `all_reduce_max` (the global per-token absmax of SmoothQuant's
  row-parallel input);
- `gather_columns`, the vocabulary shards of the lm_head assembled into the
  full logits on every rank: an all-reduce of a zero-filled full-width
  buffer that holds this rank's columns, exact because adding zeros is.

`group` None, or a group of one rank, returns the input untouched. No
function moves a tensor to the host: gloo stages CUDA tensors through the
host itself, which is its documented behaviour.
"""

from __future__ import annotations

import torch


def group_size(group) -> int:
    """Ranks in `group` (1 for None: no tensor parallelism)."""
    if group is None:
        return 1
    import torch.distributed as dist
    return dist.get_world_size(group)


def group_rank(group) -> int:
    """This process's rank in `group` (0 for None)."""
    if group is None:
        return 0
    import torch.distributed as dist
    return dist.get_rank(group)


def _check_contiguous(x):
    if not x.is_contiguous():
        raise ValueError("the collectives reduce contiguous tensors only, "
                         f"got a view of strides {x.stride()}")


def all_reduce_sum(x, group, async_op: bool = False):
    """x summed over the ranks of `group`, in place. Returns x, or (x,
    work) with async_op (wait on work before reading x; work is None for a
    world of one)."""
    if group_size(group) == 1:
        return (x, None) if async_op else x
    import torch.distributed as dist
    _check_contiguous(x)
    work = dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group,
                           async_op=async_op)
    return (x, work) if async_op else x


def all_reduce_max(x, group):
    """x's elementwise maximum over the ranks of `group`, in place."""
    if group_size(group) == 1:
        return x
    import torch.distributed as dist
    _check_contiguous(x)
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


def gather_columns(y, group):
    """y [..., n] holding this rank's columns [r n, (r + 1) n) -> the full
    [..., tp n] on every rank."""
    tp = group_size(group)
    if tp == 1:
        return y
    n = y.shape[-1]
    r = group_rank(group)
    full = torch.zeros(*y.shape[:-1], tp * n, dtype=y.dtype, device=y.device)
    full[..., r * n:(r + 1) * n] = y
    return all_reduce_sum(full, group)
