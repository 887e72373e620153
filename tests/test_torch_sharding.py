"""The port's tensor-parallel shards (`parallel/sharding.py`) against the JAX
package's layout, in one process.

For tiny configs of every weight container (int8, int4 per-channel and
g32, fp8 with interleave_block, SmoothQuant per-token and static, bf16):
each rank's `shard_params` leaf equals the numpy slice that the JAX
package's `param_specs` names for that leaf (exact), and the ranks' shards
concatenate back to the whole. Where a row shard cuts an int4 pack block
or an fp8 interleave block (the tiny wo's K of 128 halved), the shard is
re-laid: its logical codes equal the logical slice, and its layout is the
one its own block gives. `local_config` and the refusals are covered too.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from trtllm_llama_tpu.config import ModelConfig as JaxConfig
from trtllm_llama_tpu.models import llama as jax_llama
from trtllm_llama_tpu.parallel.sharding import param_specs
from trtllm_llama_tpu.quantization.mode import QuantMode as JaxQuantMode
from trtllm_llama_tpu.quantization.quantize import quantize_params
from trtllm_llama_tpu_torch.config import ModelConfig
from trtllm_llama_tpu_torch.convert.bridge import params_from_numpy
from trtllm_llama_tpu_torch.parallel import Mapping
from trtllm_llama_tpu_torch.parallel.sharding import (local_config,
                                                      shard_params)
from trtllm_llama_tpu_torch.quantization.tensors import (FP8Weight,
                                                         WOQWeight,
                                                         deinterleave_fp8_rows,
                                                         interleave_fp8_rows,
                                                         pack_int4,
                                                         unpack_int4)

TP = 2
PROJ = ("wq", "wk", "wv", "w_gate", "w_up", "wo", "w_down")

MODES = {
    "int8": (JaxQuantMode.use_weight_only(False), 0, "float32"),
    "int4": (JaxQuantMode.use_weight_only(True), 0, "float32"),
    "int4_g32": (JaxQuantMode.use_weight_only(True, per_group=True), 32,
                 "float32"),
    "fp8": (JaxQuantMode.FP8_QDQ, 0, "float32"),
    "sq_per_token": (JaxQuantMode.use_smooth_quant(per_token=True,
                                                   per_channel=True), 0,
                     "float32"),
    "sq_static": (JaxQuantMode.use_smooth_quant(per_token=False,
                                                per_channel=True), 0,
                  "float32"),
    "bf16": (JaxQuantMode(0), 0, "bfloat16"),
}


def _jax_params(mode):
    qm, group, dtype = MODES[mode]
    cfg = JaxConfig.tiny(quant_mode=qm, group_size=group, dtype=dtype)
    params = jax_llama.init_params(cfg, jax.random.PRNGKey(0))
    if int(qm):
        ranges = None
        if qm.has_act_and_weight_quant():
            ranges = {k: np.full((cfg.num_layers,), 3.0, np.float32)
                      for k in PROJ}
        params = quantize_params(params, qm, group, act_ranges=ranges)
    return params


@pytest.fixture(scope="module", params=list(MODES))
def case(request):
    jp = _jax_params(request.param)
    tp_params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                  device="cpu")
    shards = [shard_params(tp_params, Mapping(tp=TP), r) for r in range(TP)]
    return request.param, jp, tp_params, shards


def _np(t):
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _walk(tree, path):
    for k in path:
        tree = (tree[k.key] if isinstance(k, jax.tree_util.DictKey)
                else getattr(tree, k.name))
    return tree


def _container(tree, path):
    """The port container holding the leaf at path (None for a tensor)."""
    if isinstance(path[-1], jax.tree_util.GetAttrKey):
        return _walk(tree, path[:-1])
    return None


def _relaid(full, shard):
    """Whether the shard's block-local layout differs from the whole's."""
    if isinstance(full, WOQWeight):
        return shard.pack_block != full.pack_block
    if isinstance(full, FP8Weight):
        return shard.interleave_block != full.interleave_block
    return False


def _spec_slice(a, spec, rank):
    for axis, name in enumerate(spec):
        if name == "tp":
            n = a.shape[axis] // TP
            a = np.take(a, np.arange(rank * n, (rank + 1) * n), axis=axis)
    return a


def _specs(jp):
    return jax.tree_util.tree_flatten_with_path(
        param_specs(jp), is_leaf=lambda x: isinstance(x, P))[0]


def test_shards_match_param_specs(case):
    """Every leaf of every rank's shard is the numpy slice that the JAX
    package's PartitionSpec names (for re-laid int4 / fp8 row shards, in
    logical row order)."""
    mode, jp, full, shards = case
    for path, spec in _specs(jp):
        want_full = np.asarray(_walk(jp, path))
        if want_full.dtype.name == "bfloat16":
            want_full = want_full.astype(np.float32)
        for rank, shard in enumerate(shards):
            got_c = _container(shard, path)
            full_c = _container(full, path)
            if (got_c is not None and path[-1].name == "qweight"
                    and _relaid(full_c, got_c)):
                continue        # test_relaid_row_shards_hold_the_slice
            want = _spec_slice(want_full, spec, rank)
            got = _np(_walk(shard, path))
            np.testing.assert_array_equal(got, want, err_msg=f"{mode} {path}")


def test_relaid_row_shards_hold_the_slice(case):
    """A row shard that cuts a pack / interleave block holds the logical
    rows of its slice, laid out by its own block (and every shard that
    does not is laid out as the whole)."""
    mode, _, full, shards = case
    for name in ("wo", "w_down"):
        w = full["layers"][name]
        if not isinstance(w, (WOQWeight, FP8Weight)):
            continue
        logical = _np(w.codes())
        k = logical.shape[-2]
        for rank, shard in enumerate(shards):
            s = shard["layers"][name]
            want = logical[:, rank * k // TP:(rank + 1) * k // TP]
            np.testing.assert_array_equal(_np(s.codes()), want,
                                          err_msg=f"{mode} {name}")
            if isinstance(s, WOQWeight) and s.w_bits == 4:
                assert (k // TP) % s.pack_block == 0
                np.testing.assert_array_equal(
                    _np(s.qweight),
                    _np(pack_int4(torch.from_numpy(want), s.pack_block)))
            if isinstance(s, FP8Weight) and s.interleave_block:
                assert (k // TP) % s.interleave_block == 0
                np.testing.assert_array_equal(
                    _np(s.qweight), _np(interleave_fp8_rows(
                        torch.from_numpy(want), s.interleave_block)))


def test_shards_concatenate_back(case):
    """The ranks' shards of each projection and of the lm_head concatenate
    back to the whole (logical codes and the sharded scales; replicated
    leaves are the same tensors on every rank)."""
    mode, _, full, shards = case
    cat = lambda ts, axis: np.concatenate([_np(t) for t in ts], axis=axis)
    for name in PROJ:
        w = full["layers"][name]
        parts = [s["layers"][name] for s in shards]
        col = name not in ("wo", "w_down")
        axis = -1 if col else -2
        if isinstance(w, torch.Tensor):
            np.testing.assert_array_equal(cat(parts, axis), _np(w))
            continue
        codes = w.codes() if hasattr(w, "codes") else w.qweight
        np.testing.assert_array_equal(
            cat([p.codes() if hasattr(p, "codes") else p.qweight
                 for p in parts], axis), _np(codes), err_msg=f"{mode} {name}")
        sname = "scale_w" if hasattr(w, "scale_w") else "scale"
        sfull = getattr(w, sname)
        grouped = isinstance(w, WOQWeight) and w.group_size
        if col:
            np.testing.assert_array_equal(
                cat([getattr(p, sname) for p in parts], -1), _np(sfull))
        elif grouped:
            np.testing.assert_array_equal(
                cat([getattr(p, sname) for p in parts], -2), _np(sfull))
        else:
            assert all(getattr(p, sname) is sfull for p in parts)
    np.testing.assert_array_equal(
        cat([s["lm_head"] for s in shards], -1), _np(full["lm_head"]))
    for key in ("embed", "final_norm"):
        assert all(s[key] is full[key] for s in shards)


def test_unaligned_fp8_row_shard_is_reinterleaved():
    """K = 384 over tp = 2: each row shard of 192 rows cuts the
    128-row interleave blocks, so it is re-interleaved with a 64-row block
    (the largest dividing 192) and decodes to its logical slice."""
    g = torch.Generator().manual_seed(0)
    codes = torch.randint(0, 255, (2, 384, 32), generator=g,
                          dtype=torch.uint8)
    w = FP8Weight(interleave_fp8_rows(codes, 128).contiguous(),
                  torch.rand((2, 32), generator=g), 128)
    for rank in range(TP):
        s = shard_params({"layers": {"wo": w}}, Mapping(tp=TP),
                         rank)["layers"]["wo"]
        assert s.interleave_block == 64
        want = codes[:, rank * 192:(rank + 1) * 192]
        assert torch.equal(deinterleave_fp8_rows(s.qweight, 64), want)
        assert s.scale is w.scale


def test_unaligned_int4_row_shard_is_repacked_or_raises():
    """Per-channel int4 with a 128-row pack block at K = 128: each 64-row
    row shard is repacked with a 64-row block; grouped int4 whose shard is
    not whole groups raises with the shapes."""
    g = torch.Generator().manual_seed(1)
    codes = torch.randint(-8, 8, (1, 128, 16), generator=g, dtype=torch.int8)
    w = WOQWeight(pack_int4(codes, 128), torch.rand((1, 16), generator=g), 4,
                  0, 128)
    s = shard_params({"layers": {"wo": w}}, Mapping(tp=TP), 1)["layers"]["wo"]
    assert s.pack_block == 64
    assert torch.equal(unpack_int4(s.qweight, 64), codes[:, 64:])
    wg = WOQWeight(pack_int4(codes, 128), torch.rand((1, 1, 16)), 4, 128, 128)
    with pytest.raises(ValueError, match="whole groups of 128"):
        shard_params({"layers": {"wo": wg}}, Mapping(tp=TP), 0)


def test_local_config_and_refusals():
    """local_config halves the heads (head_dim stays); heads or a vocabulary
    that tp does not divide, fused projections, a rank outside tp and the
    unported axes raise."""
    cfg = ModelConfig.tiny(dtype="float32")
    local = local_config(cfg, 2)
    assert (local.num_heads, local.num_kv_heads, local.head_dim) == (
        cfg.num_heads // 2, cfg.num_kv_heads // 2, cfg.head_dim)
    assert local_config(cfg, 1) is cfg
    with pytest.raises(ValueError, match="must divide"):
        local_config(dataclasses.replace(cfg, num_kv_heads=1), 2)
    with pytest.raises(ValueError, match="fused"):
        shard_params({"layers": {"wqkv": torch.zeros(1, 4, 4)}},
                     Mapping(tp=2), 0)
    with pytest.raises(ValueError, match="outside"):
        shard_params({}, Mapping(tp=2), 2)
    for axis in ("dp", "sp", "pp", "ep"):
        with pytest.raises(NotImplementedError, match="ROADMAP A 5"):
            Mapping(**{axis: 2}).check_ported()
    assert Mapping(tp=2, dp=2).world_size == 4
