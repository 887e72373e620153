"""Engine directory, format v2 (the port's `convert/serialize.py`).

The JAX package's engine artifact, read and written unchanged, so a
directory converted by either package loads in the other:

  <dir>/config.json      {"model_config": ModelConfig, "kv_scales": [L]?}
  <dir>/manifest.json    {"format_version": 2, "leaves": {name: {shape,
                         dtype}}, "containers": {prefix: {type, meta}}}
  <dir>/arrays/<name>.npy

Leaf names are the '.'-joined dict keys, then the container's data field
(`layers.wq.qweight`), in the JAX package's flattening order (dict keys
sorted, container fields in declaration order). bfloat16 leaves are stored
as their uint16 bit patterns; int4 weights in their packed int8 form, fp8
as uint8 codes in the interleaved row order. A directory of another
format_version raises.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import ModelConfig
from ..device import resolve_device
from ..quantization.tensors import FP8Weight, SQWeight, WOQWeight
from .bridge import tensor_from_numpy

_FORMAT_VERSION = 2

# container type -> (data fields in the JAX package's order, meta fields)
_CONTAINERS = {
    WOQWeight: (("qweight", "scale"), ("w_bits", "group_size", "pack_block")),
    SQWeight: (("qweight", "scale_w", "scale_x", "scale_y"),
               ("per_channel", "per_token")),
    FP8Weight: (("qweight", "scale"), ("interleave_block",)),
}


def flatten(tree, prefix="", containers=None):
    """(name, tensor) of every leaf, in the JAX package's flattening order
    (dict keys sorted, container fields in declaration order). With a
    `containers` dict, also records each quantized container's manifest
    entry ({type, meta fields}) under its prefix."""
    if type(tree) in _CONTAINERS:
        fields, meta = _CONTAINERS[type(tree)]
        if containers is not None:
            containers[prefix] = {"type": type(tree).__name__,
                                  **{m: getattr(tree, m) for m in meta}}
        return [(f"{prefix}.{f}", getattr(tree, f)) for f in fields]
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            if not isinstance(k, str) or "." in k:
                raise ValueError(f"engine dir cannot encode dict key {k!r} "
                                 f"under {prefix!r} (string keys without "
                                 "'.' only)")
            out += flatten(tree[k], f"{prefix}.{k}" if prefix else k,
                           containers)
        return out
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    raise ValueError(f"engine dir cannot encode a {type(tree).__name__} "
                     f"node under {prefix!r} (dicts of tensors and weight "
                     "containers only)")


def _save_array(arrays_dir, name, t: torch.Tensor):
    arr = t.detach().contiguous().cpu()
    meta = {"shape": list(arr.shape)}
    if arr.dtype == torch.bfloat16:
        meta["dtype"] = "bfloat16"
        arr = arr.view(torch.int16).numpy().view(np.uint16)
    else:
        arr = arr.numpy()
        meta["dtype"] = str(arr.dtype)
    np.save(os.path.join(arrays_dir, name + ".npy"), arr)
    return meta


def save_engine(out_dir: str, cfg: ModelConfig, params,
                kv_scales: Optional[np.ndarray] = None):
    """Write params (a dict of tensors and weight containers, on any
    device) and cfg, with optional [L] int8-KV scales, as an engine dir."""
    manifest = {"format_version": _FORMAT_VERSION, "leaves": {},
                "containers": {}}
    leaves = flatten(params, containers=manifest["containers"])
    arrays_dir = os.path.join(out_dir, "arrays")
    os.makedirs(arrays_dir, exist_ok=True)
    for name, t in leaves:
        manifest["leaves"][name] = _save_array(arrays_dir, name, t)
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    engine_meta = {"model_config": json.loads(cfg.to_json())}
    if kv_scales is not None:
        if isinstance(kv_scales, torch.Tensor):
            kv_scales = kv_scales.cpu().numpy()
        engine_meta["kv_scales"] = np.asarray(kv_scales).tolist()
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(engine_meta, f, indent=1)


def _load_array(arrays_dir, name, meta, device):
    arr = np.load(os.path.join(arrays_dir, name + ".npy"))
    if meta["dtype"] == "bfloat16":
        return tensor_from_numpy(arr, device)     # uint16 bits -> bf16
    return torch.from_numpy(arr).to(device)


def load_engine(engine_dir: str, device="cuda"
                ) -> Tuple[ModelConfig, dict, Optional[np.ndarray]]:
    """(cfg, params with every leaf on `device`, f32 [L] kv_scales or
    None) of an engine dir written by either package."""
    device = resolve_device(device)
    with open(os.path.join(engine_dir, "manifest.json")) as f:
        manifest = json.load(f)
    version = manifest.get("format_version")
    if version != _FORMAT_VERSION:
        raise ValueError(f"engine dir format_version {version} != supported "
                         f"{_FORMAT_VERSION}: convert the checkpoint again")
    with open(os.path.join(engine_dir, "config.json")) as f:
        engine_meta = json.load(f)
    cfg = ModelConfig.from_json(json.dumps(engine_meta["model_config"]))
    kv_scales = (np.asarray(engine_meta["kv_scales"], np.float32)
                 if "kv_scales" in engine_meta else None)
    arrays_dir = os.path.join(engine_dir, "arrays")

    root: dict = {}
    for name, meta in manifest["leaves"].items():
        *parents, last = name.split(".")
        node = root
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = _load_array(arrays_dir, name, meta, device)

    types = {t.__name__: t for t in _CONTAINERS}

    def wrap(node, prefix=""):
        if not isinstance(node, dict):
            return node
        cmeta = manifest["containers"].get(prefix)
        if cmeta is not None:
            cls = types[cmeta["type"]]
            fields, meta = _CONTAINERS[cls]
            return cls(*(node[f] for f in fields),
                       *(cmeta.get(m, 0) for m in meta))
        return {k: wrap(v, f"{prefix}.{k}" if prefix else k)
                for k, v in node.items()}

    return cfg, wrap(root), kv_scales
