"""Carry a parameter tree from the JAX package across as numpy.

`params_from_numpy` takes the JAX package's LLaMA parameter pytree with
every leaf already a numpy array (for example
`jax.tree_util.tree_map(np.asarray, params)`, or arrays read from an engine
dir) and returns the port's parameter dict on `device`. Quantized weight
containers are recognised by their fields -- `WOQWeight` by `w_bits`
(with `qweight`, `scale`, `group_size`, `pack_block`; int8 or packed
int4, per-channel or grouped), `SQWeight` by `scale_w` (with `qweight`,
`scale_x`, `scale_y`, `per_channel`, `per_token`), `FP8Weight` by
`interleave_block` (with uint8 `qweight` codes and `scale`) -- so the JAX
classes are never imported.
bfloat16 arrives either as an `ml_dtypes.bfloat16` array or as its uint16
bit pattern (the engine dir's storage form).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..quantization.tensors import FP8Weight, SQWeight, WOQWeight


def tensor_from_numpy(a, device="cuda") -> torch.Tensor:
    """numpy array -> torch tensor on `device`, bf16 (ml_dtypes or uint16
    bits) included."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:       # e.g. a view of a JAX buffer: own a copy
        a = a.copy()
    if a.dtype.name == "bfloat16" or a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree, device="cuda"):
    """The port's params from a numpy-leaved JAX parameter tree."""
    return _convert(tree, resolve_device(device))


def _convert(tree, device):
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    if hasattr(tree, "qweight") and hasattr(tree, "w_bits"):
        w = WOQWeight(tensor_from_numpy(tree.qweight, device),
                      tensor_from_numpy(tree.scale, device).float(),
                      int(tree.w_bits), int(tree.group_size),
                      int(tree.pack_block))
        w.check_supported()
        return w
    if hasattr(tree, "qweight") and hasattr(tree, "scale_w"):
        f32 = lambda a: tensor_from_numpy(a, device).float()
        return SQWeight(tensor_from_numpy(tree.qweight, device),
                        f32(tree.scale_w), f32(tree.scale_x), f32(tree.scale_y),
                        bool(tree.per_channel), bool(tree.per_token))
    if hasattr(tree, "qweight") and hasattr(tree, "interleave_block"):
        return FP8Weight(tensor_from_numpy(tree.qweight, device),
                         tensor_from_numpy(tree.scale, device).float(),
                         int(tree.interleave_block))
    if hasattr(tree, "qweight"):
        raise NotImplementedError(
            f"{type(tree).__name__} weights are not ported yet")
    return tensor_from_numpy(tree, device)
