"""The SwiGLU prologue of rows 2 and 4 and the gate/up fusion of the PyTorch
port against the JAX package: the plain `woq_matmul_stacked` /
`fp8_matmul_stacked` with swiglu=True against the Pallas kernels in
interpret mode, `dense_fused(..., swiglu=True)` against the JAX unfused
composition, `fuse_gate_up_params` against the JAX tree, and greedy
generation under TLLM_FUSE_GU (the JAX package's opt-in) against the
unfused port and the JAX session.

Tolerances, as the kernels' own parity tests: f32 int8 within rtol / atol
1e-5 (summation order); f32 int4 and fp8 within 1e-4 of the largest
|output| (the JAX kernels fold their planted decode bias out after the
dot); bf16 within 2**-7 of the largest |output| (silu rounded to bf16
before the product may land one step apart); tokens identical at tiny
f32, and fused against unfused in bf16.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from trtllm_llama_tpu.config import EngineConfig as JaxEngineConfig
from trtllm_llama_tpu.config import ModelConfig as JaxConfig
from trtllm_llama_tpu.models import llama as jax_llama
from trtllm_llama_tpu.ops import linear as jax_linear
from trtllm_llama_tpu.ops.pallas.woq_matmul import (
    fp8_matmul_stacked as jax_fp8_matmul_stacked,
    woq_matmul_stacked as jax_woq_matmul_stacked,
)
from trtllm_llama_tpu.quantization import tensors as jax_tensors
from trtllm_llama_tpu.quantization.mode import QuantMode as JaxQuantMode
from trtllm_llama_tpu.quantization.quantize import (
    quantize_params as jax_quantize_params,
)
from trtllm_llama_tpu.runtime.sampling import SamplingConfig as JaxSampling
from trtllm_llama_tpu.runtime.session import GenerationSession as JaxSession
from trtllm_llama_tpu_torch.config import EngineConfig, ModelConfig
from trtllm_llama_tpu_torch.convert.bridge import params_from_numpy
from trtllm_llama_tpu_torch.convert.serialize import flatten
from trtllm_llama_tpu_torch.models import llama
from trtllm_llama_tpu_torch.ops import linear
from trtllm_llama_tpu_torch.ops.kernels import fp8_matmul as f8k
from trtllm_llama_tpu_torch.ops.kernels import woq_matmul as woq
from trtllm_llama_tpu_torch.quantization.mode import QuantMode
from trtllm_llama_tpu_torch.quantization.quantize import quantize_params
from trtllm_llama_tpu_torch.runtime.sampling import SamplingConfig
from trtllm_llama_tpu_torch.runtime.session import GenerationSession

torch.set_num_threads(1)

L, K, N, LAYER = 2, 256, 128, 1
FORMATS = ["int8", "int4 g128", "fp8"]


def _weights(fmt, seed):
    rng = np.random.default_rng(seed)
    w = jnp.asarray((rng.standard_normal((L, K, N)) * 0.05).astype(np.float32))
    if fmt == "fp8":
        jw = jax_tensors.quantize_fp8_weight(w)
    else:
        jw = jax_tensors.quantize_weight_only(
            w, 8 if fmt == "int8" else 4, 128 if fmt == "int4 g128" else 0)
    tw = params_from_numpy({"w": jax.tree_util.tree_map(np.asarray, jw)},
                           "cpu")["w"]
    return jw, tw


def _assert_close(got, want, fmt, dtype):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    if dtype == "bfloat16":
        assert err <= 2.0 ** -7 * scale, (err, scale)
    elif fmt == "int8":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert err <= 1e-4 * scale, (err, scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("resid", [False, True])
@pytest.mark.parametrize("m", [1, 5, 16])
@pytest.mark.parametrize("fmt", FORMATS)
def test_swiglu_plain_matches_jax_kernel(fmt, m, resid, dtype):
    jw, tw = _weights(fmt, seed=m)
    rng = np.random.default_rng(m + 50)
    x = (2 * rng.standard_normal((m, 2 * K))).astype(np.float32)
    r = rng.standard_normal((m, N)).astype(np.float32)
    jx, tx = jnp.asarray(x, dtype), torch.from_numpy(x).to(getattr(torch,
                                                                   dtype))
    jkw = {"resid": jnp.asarray(r, dtype)} if resid else {}
    tkw = {"resid": torch.from_numpy(r).to(tx.dtype)} if resid else {}
    jfn, tfn = ((jax_fp8_matmul_stacked, f8k.fp8_matmul_stacked)
                if fmt == "fp8" else
                (jax_woq_matmul_stacked, woq.woq_matmul_stacked))
    want = jfn(jx, jw, LAYER, interpret=True, swiglu=True, **jkw)
    got = tfn(tx, tw, LAYER, swiglu=True, **tkw)
    assert got.dtype == torch.float32 and got.shape == (m, N)
    _assert_close(got.numpy(), want, fmt, dtype)


@pytest.mark.parametrize("m", [1, 16, 20])
@pytest.mark.parametrize("fmt", FORMATS + ["float"])
def test_dense_fused_swiglu_matches_jax_composition(fmt, m):
    """The port's dense_fused with swiglu (the kernel's plain prologue at
    m <= 16, the composition above) against the JAX dense_fused's unfused
    composition (no kernels on the CPU)."""
    jw, tw = _weights("int8" if fmt == "float" else fmt, seed=m + 3)
    if fmt == "float":
        jw = jw.dequantize()
        tw = torch.from_numpy(np.array(jw))
    rng = np.random.default_rng(m)
    x = (2 * rng.standard_normal((m, 2 * K))).astype(np.float32)
    r = rng.standard_normal((m, N)).astype(np.float32)
    want = jax_linear.dense_fused(jnp.asarray(x), jw, layer=LAYER,
                                  swiglu=True, resid=jnp.asarray(r))
    got = linear.dense_fused(torch.from_numpy(x), tw, layer=LAYER,
                             swiglu=True, resid=torch.from_numpy(r))
    _assert_close(got.numpy(), want, "int8" if fmt == "float" else fmt,
                  "float32")
    with pytest.raises(ValueError, match="mutually exclusive"):
        linear.dense_fused(torch.from_numpy(x), tw, layer=LAYER, swiglu=True,
                           norm_w=torch.ones(L, 2 * K))


# mode name -> (QuantMode int, group size)
MODES = {
    "fp": (0, 0),
    "int8wo": (int(QuantMode.use_weight_only()), 0),
    "int4 g128": (int(QuantMode.use_weight_only(True, per_group=True)), 128),
    "fp8": (int(QuantMode.FP8_QDQ), 0),
    "sq-ptpc": (int(QuantMode.use_smooth_quant(per_token=True,
                                               per_channel=True)), 0),
    "sq-static": (int(QuantMode.use_smooth_quant()), 0),
}


def _jax_model(mode_name, dtype="float32"):
    qm, gs = MODES[mode_name]
    cfg = JaxConfig.tiny(dtype=dtype, quant_mode=JaxQuantMode(qm),
                         group_size=gs)
    params = jax_llama.init_params(cfg, jax.random.PRNGKey(0))
    act = {k: np.full((cfg.num_layers,), 3.0, np.float32)
           for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")}
    return cfg, jax_quantize_params(params, cfg.quant_mode, gs,
                                    act_ranges=act)


@pytest.mark.parametrize("mode_name", list(MODES))
def test_fuse_gate_up_params_matches_jax(mode_name):
    _, jparams = _jax_model(mode_name)
    want = params_from_numpy(jax.tree_util.tree_map(
        np.asarray, jax_llama.fuse_gate_up_params(jparams)), "cpu")
    got = llama.fuse_gate_up_params(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu"))
    assert "w_gate_up" in got["layers"] and "w_gate" not in got["layers"]
    assert type(got["layers"]["w_gate_up"]) is type(want["layers"]["w_gate_up"])
    got_l, want_l = flatten(got), flatten(want)
    assert [n for n, _ in got_l] == [n for n, _ in want_l]
    for (name, a), (_, b) in zip(got_l, want_l):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert llama.fuse_gate_up_params(got) is got     # already fused: no-op


def _port_tokens(cfg, params, ids, fused, monkeypatch):
    if fused:
        monkeypatch.setenv("TLLM_FUSE_GU", "1")
    else:
        monkeypatch.delenv("TLLM_FUSE_GU", raising=False)
    sess = GenerationSession(cfg, params, EngineConfig(max_input_len=32,
                                                       max_seq_len=64),
                             device="cpu")
    assert ("w_gate_up" in sess.params["layers"]) == fused
    return sess.generate(ids, max_new_tokens=8,
                         sampling=SamplingConfig(end_id=-1)).output_ids


@pytest.mark.parametrize("mode_name", list(MODES))
def test_fused_gate_up_generation_matches_unfused_and_jax(mode_name,
                                                          monkeypatch):
    jcfg, jparams = _jax_model(mode_name)
    cfg = ModelConfig.from_json(jcfg.to_json())
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               "cpu")
    ids = np.random.default_rng(0).integers(3, 250, (2, 10))
    fused = _port_tokens(cfg, params, ids, True, monkeypatch)
    np.testing.assert_array_equal(
        fused, _port_tokens(cfg, params, ids, False, monkeypatch))
    monkeypatch.setenv("TLLM_FUSE_GU", "1")
    jsess = JaxSession(jcfg, jparams, JaxEngineConfig(max_input_len=32,
                                                      max_seq_len=64))
    assert "w_gate_up" in jsess.params["layers"]
    want = jsess.generate(ids, max_new_tokens=8,
                          sampling=JaxSampling(end_id=-1)).output_ids
    np.testing.assert_array_equal(fused, np.asarray(want))


@pytest.mark.parametrize("mode_name", ["fp", "int8wo"])
def test_fused_gate_up_bf16_matches_unfused(mode_name, monkeypatch):
    """In bf16 the fused params give the unfused tokens (the JAX package's
    own check, tests/test_fuse_gate_up.py)."""
    qm, _ = MODES[mode_name]
    cfg = ModelConfig.tiny(dtype="bfloat16", quant_mode=QuantMode(qm))
    jparams = jax_llama.init_params(JaxConfig.tiny(dtype="bfloat16"),
                                    jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               "cpu")
    params = quantize_params(params, cfg.quant_mode)
    ids = np.random.default_rng(0).integers(3, 250, (2, 10))
    np.testing.assert_array_equal(
        _port_tokens(cfg, params, ids, True, monkeypatch),
        _port_tokens(cfg, params, ids, False, monkeypatch))
