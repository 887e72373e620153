"""SmoothQuant pieces of the PyTorch port against the JAX package: the int8
helpers and SQWeight containers, kernel 4's plain rms_norm_quant, kernel
5's plain W8A8 matmul (against the Pallas kernels in interpret mode), the
SQ dense paths and the numpy bridge.

Tolerances: int8 codes and int32 sums are exact, so W8A8 outputs agree to
rtol 1e-6 (the same f32 epilogue in the same order); rms_norm_quant scales
to rtol 1e-5 and codes within one step (the JAX kernel uses rsqrt, its
fallback (var + eps) ** -0.5, so a y at a rounding boundary may move);
f32 dense outputs to rtol/atol 1e-5.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from trtllm_llama_tpu.ops import linear as jax_linear
from trtllm_llama_tpu.ops import norm as jax_norm
from trtllm_llama_tpu.ops.pallas.rmsnorm_quant import (
    rmsnorm_quant_kernel as jax_rmsnorm_quant_kernel,
)
from trtllm_llama_tpu.ops.pallas.w8a8_matmul import (
    w8a8_matmul as jax_w8a8_matmul,
    w8a8_matmul_stacked as jax_w8a8_matmul_stacked,
)
from trtllm_llama_tpu.quantization import tensors as jax_tensors
from trtllm_llama_tpu.quantization.mode import QuantMode as JaxQuantMode
from trtllm_llama_tpu.quantization.quantize import (
    quantize_params as jax_quantize_params,
)
from trtllm_llama_tpu_torch.convert.bridge import params_from_numpy
from trtllm_llama_tpu_torch.ops import linear, norm
from trtllm_llama_tpu_torch.ops.kernels.w8a8_matmul import (
    w8a8_matmul, w8a8_matmul_stacked,
)
from trtllm_llama_tpu_torch.quantization import tensors
from trtllm_llama_tpu_torch.quantization.mode import QuantMode
from trtllm_llama_tpu_torch.quantization.quantize import (
    init_random_quantized_params, quantize_params,
)

torch.set_num_threads(1)

W8A8 = dict(rtol=1e-6, atol=0)
F32 = dict(rtol=1e-5, atol=1e-5)
L, K, N = 3, 256, 128


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_codes_close(got, want, max_step=1):
    diff = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert diff.max() <= max_step, diff.max()


@pytest.mark.parametrize("shape", [(1, 256), (16, 256), (3, 5, 128)])
def test_rms_norm_quant_matches_jax_fallback_and_kernel(shape):
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * 2).astype(np.float32)
    w = (1 + 0.3 * rng.standard_normal(shape[-1])).astype(np.float32)
    q, s = norm.rms_norm_quant(_t(x), _t(w), 1e-6)
    assert q.dtype == torch.int8 and q.shape == shape
    assert s.dtype == torch.float32 and s.shape == (*shape[:-1], 1)
    want_fallback = jax_norm.rms_norm_quant(jnp.asarray(x), jnp.asarray(w))
    want_kernel = jax_rmsnorm_quant_kernel(jnp.asarray(x), jnp.asarray(w),
                                           interpret=True)
    for wq, ws in (want_fallback, want_kernel):
        np.testing.assert_allclose(s.numpy(), np.asarray(ws), rtol=1e-5, atol=0)
        _assert_codes_close(q.numpy(), wq)


def test_rms_norm_quant_bf16_input_is_not_rounded_before_quantizing():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 128)).astype(np.float32)
    w = (1 + 0.3 * rng.standard_normal(128)).astype(np.float32)
    xb, wb = _t(x).bfloat16(), _t(w).bfloat16()
    q, s = norm.rms_norm_quant(xb, wb)
    q32, s32 = norm.rms_norm_quant(xb.float(), wb.float())
    assert torch.equal(q, q32) and torch.equal(s, s32)


def _w8a8_inputs(m, per_channel, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, K)).astype(np.float32)
    wq = rng.integers(-127, 128, (L, K, N)).astype(np.int8)
    s_w = (np.abs(rng.standard_normal((L, N if per_channel else 1)))
           .astype(np.float32) * 0.01 + 1e-4)
    x_q, s_x = jax_tensors.quantize_per_token(jnp.asarray(x))
    return x, np.asarray(x_q), np.asarray(s_x), wq, s_w


@pytest.mark.parametrize("per_channel", [True, False])
@pytest.mark.parametrize("m", [1, 16, 64])
def test_w8a8_matches_jax_kernels(m, per_channel):
    _, x_q, s_x, wq, s_w = _w8a8_inputs(m, per_channel)
    for layer in range(L):
        want = jax_w8a8_matmul_stacked(jnp.asarray(x_q), jnp.asarray(wq),
                                       jnp.asarray(s_x), jnp.asarray(s_w),
                                       layer, interpret=True)
        got = w8a8_matmul_stacked(_t(x_q), _t(wq), _t(s_x), _t(s_w), layer)
        assert got.dtype == torch.float32 and got.shape == (m, N)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **W8A8)
    want2d = jax_w8a8_matmul(jnp.asarray(x_q), jnp.asarray(wq[1]),
                             jnp.asarray(s_x), jnp.asarray(s_w[1]),
                             interpret=True)
    got2d = w8a8_matmul(_t(x_q), _t(wq[1]), _t(s_x), _t(s_w[1]))
    np.testing.assert_allclose(got2d.numpy(), np.asarray(want2d), **W8A8)


def test_w8a8_sum_is_exact_at_full_magnitude():
    """|sum| up to 127*127*K: exact (f32 accumulation would not be)."""
    k, n = 11008, 16
    x_q = torch.full((1, k), 127, dtype=torch.int8)
    w_q = torch.full((1, k, n), -127, dtype=torch.int8)
    w_q[0, 0, 0] = 126
    y = w8a8_matmul_stacked(x_q, w_q, torch.ones(1), torch.ones(1, 1), 0)
    want = float(np.float32(-127 * 127 * (k - 1) + 127 * 126))
    assert y[0, 0].item() == want


def test_quantize_per_token_and_static_match_jax():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((2, 3, 64)) * 4).astype(np.float32)
    x[0, 1] = 0.0                                 # all-zero row: eps floor
    want_q, want_s = jax_tensors.quantize_per_token(jnp.asarray(x))
    got_q, got_s = tensors.quantize_per_token(_t(x))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-7)
    sx = np.float32(0.02)
    np.testing.assert_array_equal(
        tensors.quantize_static(_t(x), torch.tensor(sx)).numpy(),
        np.asarray(jax_tensors.quantize_static(jnp.asarray(x), sx)))


@pytest.mark.parametrize("per_channel", [True, False])
def test_quantize_smoothquant_weight_matches_jax(per_channel):
    rng = np.random.default_rng(6)
    w = (rng.standard_normal((2, 64, 48)) * 0.05).astype(np.float32)
    amax = np.asarray([3.0, 2.5], np.float32)
    want = jax_tensors.quantize_smoothquant_weight(
        jnp.asarray(w), jnp.asarray(amax), per_channel=per_channel)
    got = tensors.quantize_smoothquant_weight(_t(w), _t(amax),
                                              per_channel=per_channel)
    np.testing.assert_array_equal(got.qweight.numpy(), np.asarray(want.qweight))
    for name in ("scale_w", "scale_x", "scale_y"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), rtol=1e-7)
    np.testing.assert_allclose(got.dequantize().numpy(),
                               np.asarray(want.dequantize()), **F32)


@pytest.mark.parametrize("per_token", [True, False])
def test_concat_columns_sq_matches_jax(per_token):
    rng = np.random.default_rng(7)
    ws = [(rng.standard_normal((2, 32, n)) * 0.1).astype(np.float32)
          for n in (16, 8, 8)]
    amax = np.asarray([3.0, 2.0], np.float32)
    kw = [dict(per_channel=pc, per_token=per_token) for pc in (True, False, True)]
    jq = [jax_tensors.quantize_smoothquant_weight(jnp.asarray(w), amax, **a)
          for w, a in zip(ws, kw)]
    tq = [tensors.quantize_smoothquant_weight(_t(w), _t(amax), **a)
          for w, a in zip(ws, kw)]
    want = jax_tensors.concat_columns(jq)
    got = tensors.concat_columns(tq)
    assert got.per_channel and got.per_token == per_token
    np.testing.assert_array_equal(got.qweight.numpy(), np.asarray(want.qweight))
    np.testing.assert_array_equal(got.scale_w.numpy(), np.asarray(want.scale_w))
    np.testing.assert_array_equal(got.scale_x.numpy(), np.asarray(want.scale_x))
    if not per_token:                 # differing static act scales: no fusion
        other = tensors.quantize_smoothquant_weight(
            _t(ws[1]), _t(amax * 2), per_token=False)
        assert tensors.concat_columns([tq[0], other]) is None
    mixed = tensors.quantize_smoothquant_weight(_t(ws[1]), _t(amax),
                                                per_token=not per_token)
    assert tensors.concat_columns([tq[0], mixed]) is None


def _jax_sq_layers(per_token, seed=8):
    rng = np.random.default_rng(seed)
    layers = {"wq": (rng.standard_normal((2, 64, 32)) * 0.1).astype(np.float32),
              "attn_norm": np.ones((2, 64), np.float32)}
    mode = JaxQuantMode.use_smooth_quant(per_token=per_token, per_channel=True)
    act = {"wq": np.asarray([3.0, 2.0], np.float32)}
    return layers, mode, act


@pytest.mark.parametrize("per_token", [True, False])
def test_quantize_params_and_bridge_match_jax(per_token):
    layers, mode, act = _jax_sq_layers(per_token)
    want = jax_quantize_params({"layers": {k: jnp.asarray(v) for k, v in
                                           layers.items()}}, mode,
                               act_ranges=act)
    got = quantize_params({"layers": {k: _t(v) for k, v in layers.items()}},
                          QuantMode(int(mode)), act_ranges=act)
    bridged = params_from_numpy(jax.tree_util.tree_map(np.asarray, want), "cpu")
    assert torch.equal(got["layers"]["attn_norm"], bridged["layers"]["attn_norm"])
    for w in (got["layers"]["wq"], bridged["layers"]["wq"]):
        assert isinstance(w, tensors.SQWeight) and w.per_token == per_token
        np.testing.assert_array_equal(w.qweight.numpy(),
                                      np.asarray(want["layers"]["wq"].qweight))
        np.testing.assert_allclose(w.scale_w.numpy(),
                                   np.asarray(want["layers"]["wq"].scale_w),
                                   rtol=1e-7)
        np.testing.assert_allclose(w.scale_x.numpy(),
                                   np.asarray(want["layers"]["wq"].scale_x),
                                   rtol=1e-7)
    with pytest.raises(ValueError):
        quantize_params({"layers": {"wq": _t(layers["wq"])}}, QuantMode(int(mode)))


def test_quantize_params_weight_only_and_kv_only():
    """KV-cache-only modes pass params through, as JAX's does; weight-only
    modes (int8, int4, grouped) give JAX's containers."""
    rng = np.random.default_rng(9)
    w = (rng.standard_normal((2, 64, 32)) * 0.1).astype(np.float32)
    kv_only = {"layers": {"wq": _t(w)}}
    assert quantize_params(kv_only, QuantMode.INT8_KV_CACHE) is kv_only
    jkv = jax_quantize_params({"layers": {"wq": jnp.asarray(w)}},
                              JaxQuantMode.INT8_KV_CACHE)
    np.testing.assert_array_equal(np.asarray(jkv["layers"]["wq"]), w)
    for int4, group in ((False, False), (True, False), (True, True)):
        want = jax_quantize_params(
            {"layers": {"wq": jnp.asarray(w)}},
            JaxQuantMode.use_weight_only(int4, per_group=group),
            group_size=32)["layers"]["wq"]
        got = quantize_params(kv_only, QuantMode.use_weight_only(
            int4, per_group=group), group_size=32)["layers"]["wq"]
        assert isinstance(got, tensors.WOQWeight)
        assert (got.w_bits, got.group_size, got.pack_block) == (
            want.w_bits, want.group_size, want.pack_block)
        np.testing.assert_array_equal(got.qweight.numpy(),
                                      np.asarray(want.qweight))
        np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))


@pytest.mark.parametrize("per_token", [True, False])
def test_dense_sq_matches_jax(per_token):
    layers, mode, act = _jax_sq_layers(per_token)
    jw = jax_quantize_params({"layers": {"wq": jnp.asarray(layers["wq"])}},
                             mode, act_ranges=act)["layers"]["wq"]
    tw = params_from_numpy({"wq": jax.tree_util.tree_map(np.asarray, jw)},
                           "cpu")["wq"]
    x = np.random.default_rng(10).standard_normal((2, 3, 64)).astype(np.float32)
    for layer in (0, 1):
        want = jax_linear.dense(jnp.asarray(x), jw, layer=layer)
        got = linear.dense(_t(x), tw, layer=layer)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **W8A8)
        # the fused entry composes norm + dense for SQ weights
        nw = np.ones((2, 64), np.float32)
        want_f = jax_linear.dense_fused(jnp.asarray(x), jw, layer=layer,
                                        norm_w=jnp.asarray(nw),
                                        resid=jnp.zeros((2, 3, 32)))
        got_f = linear.dense_fused(_t(x), tw, layer=layer, norm_w=_t(nw),
                                   resid=torch.zeros(2, 3, 32))
        np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), **W8A8)
    one = tensors.SQWeight(tw.qweight[1], tw.scale_w[1], tw.scale_x[1],
                           tw.scale_y[1], tw.per_channel, tw.per_token)
    want1 = jax_linear.dense(jnp.asarray(x), jax_linear._index_layer(jw, 1))
    np.testing.assert_allclose(linear.dense(_t(x), one).numpy(),
                               np.asarray(want1), **W8A8)


def test_dense_prequant_matches_jax():
    layers, mode, act = _jax_sq_layers(True)
    jw = jax_quantize_params({"layers": {"wq": jnp.asarray(layers["wq"])}},
                             mode, act_ranges=act)["layers"]["wq"]
    tw = params_from_numpy({"wq": jax.tree_util.tree_map(np.asarray, jw)},
                           "cpu")["wq"]
    x = np.random.default_rng(11).standard_normal((5, 64)).astype(np.float32)
    jq, js = jax_norm.rms_norm_quant(jnp.asarray(x), jnp.ones(64))
    want = jax_linear.dense_prequant(jq, js, jw, jnp.float32, layer=1)
    got = linear.dense_prequant(_t(jq), _t(js), tw, torch.float32, layer=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **W8A8)
    static = tensors.SQWeight(tw.qweight, tw.scale_w, tw.scale_x, tw.scale_y,
                              per_token=False)
    with pytest.raises(ValueError):
        linear.dense_prequant(_t(jq), _t(js), static, layer=1)


@pytest.mark.parametrize("per_channel", [True, False])
def test_init_random_sq_params_layout(per_channel):
    from trtllm_llama_tpu_torch.config import ModelConfig
    mode = QuantMode.use_smooth_quant(per_token=True, per_channel=per_channel)
    cfg = ModelConfig.tiny(quant_mode=mode)
    params = init_random_quantized_params(cfg, seed=0, device="cpu")
    w = params["layers"]["w_down"]
    assert isinstance(w, tensors.SQWeight) and w.per_token
    assert w.qweight.shape == (2, 256, 128) and w.qweight.dtype == torch.int8
    assert w.scale_w.shape == ((2, 128) if per_channel else (2, 1))
    assert torch.allclose(w.scale_w, torch.tensor(256 ** -0.5 / 127.0))
    assert torch.equal(w.scale_x, torch.full((2,), 0.02))
    again = init_random_quantized_params(cfg, seed=0, device="cpu")
    assert torch.equal(again["layers"]["wq"].qweight, params["layers"]["wq"].qweight)
