"""INT4 weight-only pieces of the PyTorch port against the JAX package: the
pack layout, the quantizer, kernel 1's plain int4 (and grouped) versions
against the Pallas kernels in interpret mode, the dense dispatch, and a
tiny int4 g128 model (with and without an int4 per-channel lm_head)
carried across by params_from_numpy.

Tolerances: codes, packed bytes and scales are exact. Matmuls are in f32
and agree within 1e-4 of the largest |output|: the JAX int4 kernel plants
each nibble as 128 + u and folds 136 * rowsum(x) out after the dot, which
costs f32 digits the plain product does not lose. Model logits agree
within 1e-4 of the largest logit (f32 summation order through two
layers); greedy tokens are identical.
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
    woq_matmul as jax_woq_matmul,
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
from trtllm_llama_tpu_torch.models import llama
from trtllm_llama_tpu_torch.ops import linear
from trtllm_llama_tpu_torch.ops.kernels import woq_matmul as woq
from trtllm_llama_tpu_torch.quantization import tensors
from trtllm_llama_tpu_torch.quantization.mode import QuantMode
from trtllm_llama_tpu_torch.quantization.quantize import (
    init_random_quantized_params, quantize_params,
)
from trtllm_llama_tpu_torch.runtime.sampling import SamplingConfig
from trtllm_llama_tpu_torch.runtime.session import GenerationSession

torch.set_num_threads(1)

REL = 1e-4        # matmuls and logits, relative to the largest |output|
L, K, N, LAYER = 2, 256, 128, 1


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_rel(got, want, rel=REL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _bridge(jw):
    return params_from_numpy({"w": jax.tree_util.tree_map(np.asarray, jw)},
                             "cpu")["w"]


@pytest.mark.parametrize("pb", [8, 32, 128])
def test_pack_unpack_match_jax_and_round_trip(pb):
    rng = np.random.default_rng(pb)
    q = rng.integers(-8, 8, (2, 256, 48)).astype(np.int8)
    want = np.asarray(jax_tensors.pack_int4(jnp.asarray(q), pb))
    got = tensors.pack_int4(torch.from_numpy(q), pb)
    assert got.dtype == torch.int8 and got.shape == (2, 128, 48)
    np.testing.assert_array_equal(got.numpy(), want)
    back = tensors.unpack_int4(got, pb)
    np.testing.assert_array_equal(back.numpy(), q)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jax_tensors.unpack_int4(jnp.asarray(want), pb)))
    assert tensors.default_pack_block(256) == jax_tensors.default_pack_block(256)
    assert tensors.default_pack_block(40, 0) == 8


@pytest.mark.parametrize("group_size", [0, 32, 128])
def test_quantize_weight_only_int4_matches_jax(group_size):
    rng = np.random.default_rng(group_size + 1)
    w = (rng.standard_normal((2, 256, 48)) * 0.05).astype(np.float32)
    w[0, :, 5] = 0.0                          # all-zero column: eps floor
    want = jax_tensors.quantize_weight_only(jnp.asarray(w), 4, group_size)
    got = tensors.quantize_weight_only(torch.from_numpy(w), 4, group_size)
    assert (got.w_bits, got.group_size, got.pack_block) == (
        want.w_bits, want.group_size, want.pack_block)
    np.testing.assert_array_equal(got.qweight.numpy(), np.asarray(want.qweight))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_allclose(got.dequantize().numpy(),
                               np.asarray(want.dequantize()), rtol=1e-6,
                               atol=1e-7)
    assert got.k_dim == 256


def _weights(w_bits, group_size, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((L, K, N)) * 0.05).astype(np.float32)
    jw = jax_tensors.quantize_weight_only(jnp.asarray(w), w_bits, group_size)
    return jw, _bridge(jw)


FORMATS = [(4, 0), (4, 128), (8, 32)]      # int4 per-channel / g128, int8 g32


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("m", [1, 5, 16])
def test_woq_matmul_2d_plain_matches_jax_kernel(m, fmt):
    jw, tw = _weights(*fmt)
    x = np.random.default_rng(m).standard_normal((m, K)).astype(np.float32)
    j2 = jax_linear._index_layer(jw, LAYER)
    t2 = tensors.WOQWeight(tw.qweight[LAYER], tw.scale[LAYER], tw.w_bits,
                           tw.group_size, tw.pack_block)
    want = jax_woq_matmul(jnp.asarray(x), j2, interpret=True)
    got = woq.woq_matmul(torch.from_numpy(x), t2)
    assert got.dtype == torch.float32 and got.shape == (m, N)
    _assert_rel(got.numpy(), want)
    _assert_rel(linear.dense(torch.from_numpy(x), t2).numpy(),
                jax_linear.dense(jnp.asarray(x), j2))


@pytest.mark.parametrize("opt", ["plain", "norm", "resid"])
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("m", [1, 5, 16])
def test_woq_stacked_plain_matches_jax_kernel(m, fmt, opt):
    jw, tw = _weights(*fmt, seed=m)
    rng = np.random.default_rng(m + 100)
    x = rng.standard_normal((m, K)).astype(np.float32)
    nw = (1.0 + 0.1 * rng.standard_normal((L, K))).astype(np.float32)
    resid = rng.standard_normal((m, N)).astype(np.float32)
    kw = {"plain": {}, "norm": {"norm_w": nw}, "resid": {"resid": resid}}[opt]
    want = jax_woq_matmul_stacked(jnp.asarray(x), jw, LAYER, interpret=True,
                                  **{k: jnp.asarray(v) for k, v in kw.items()})
    got = woq.woq_matmul_stacked(torch.from_numpy(x), tw, LAYER,
                                 **{k: _t(v) for k, v in kw.items()})
    _assert_rel(got.numpy(), want)
    # dense_fused: inside the kernel at m <= 16 against JAX's composition
    want_f = jax_linear.dense_fused(jnp.asarray(x), jw, layer=LAYER,
                                    **{k: jnp.asarray(v) for k, v in kw.items()})
    got_f = linear.dense_fused(torch.from_numpy(x), tw, layer=LAYER,
                               **{k: _t(v) for k, v in kw.items()})
    _assert_rel(got_f.numpy(), want_f)


def test_concat_columns_int4_grouped_matches_jax():
    rng = np.random.default_rng(4)
    ws = [(rng.standard_normal((2, 128, n)) * 0.1).astype(np.float32)
          for n in (32, 16, 16)]
    jq = [jax_tensors.quantize_weight_only(jnp.asarray(w), 4, 64) for w in ws]
    tq = [tensors.quantize_weight_only(torch.from_numpy(w), 4, 64) for w in ws]
    want = jax_tensors.concat_columns(jq)
    got = tensors.concat_columns(tq)
    np.testing.assert_array_equal(got.qweight.numpy(), np.asarray(want.qweight))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    assert (got.w_bits, got.group_size, got.pack_block) == (4, 64, 64)
    mixed = tensors.quantize_weight_only(torch.from_numpy(ws[1]), 4, 0)
    assert tensors.concat_columns([tq[0], mixed]) is None


def test_init_random_int4_params_layout():
    mode = QuantMode.use_weight_only(True, per_group=True)
    cfg = ModelConfig.tiny(quant_mode=mode, group_size=64)
    params = init_random_quantized_params(cfg, seed=0, device="cpu")
    w = params["layers"]["w_down"]
    assert isinstance(w, tensors.WOQWeight)
    assert (w.w_bits, w.group_size, w.pack_block) == (4, 64, 64)
    assert w.qweight.shape == (2, 128, 128) and w.qweight.dtype == torch.int8
    assert w.scale.shape == (2, 4, 128) and w.k_dim == 256
    assert torch.allclose(w.scale, torch.tensor(256 ** -0.5 / 127.0))
    pc = init_random_quantized_params(cfg, seed=0, device="cpu", group_size=0)
    assert pc["layers"]["wq"].scale.shape == (2, 128)
    assert pc["layers"]["wq"].pack_block == 128
    again = init_random_quantized_params(cfg, seed=0, device="cpu")
    assert torch.equal(again["layers"]["wq"].qweight, params["layers"]["wq"].qweight)


G128 = JaxQuantMode.use_weight_only(True, per_group=True)


def _tiny_int4(lm_head, seed=0):
    jcfg = JaxConfig.tiny(dtype="float32", group_size=128,
                          quant_mode=G128)
    floats = jax_llama.init_params(jcfg, jax.random.PRNGKey(seed))
    jparams = jax_quantize_params(floats, G128, group_size=128,
                                  quantize_lm_head=lm_head)
    cfg = ModelConfig.tiny(dtype="float32", group_size=128,
                           quant_mode=QuantMode(int(G128)))
    return jcfg, jparams, cfg, floats


@pytest.mark.parametrize("lm_head", [False, True])
def test_tiny_int4_model_logits_and_tokens_match_jax(lm_head):
    jcfg, jparams, cfg, _ = _tiny_int4(lm_head)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               "cpu")
    assert params["layers"]["w_up"].group_size == 128
    head = params["lm_head"]
    assert isinstance(head, tensors.WOQWeight) == lm_head
    if lm_head:
        assert (head.w_bits, head.group_size, head.pack_block) == (4, 0, 128)

    rng = np.random.default_rng(0)
    b, s = 2, 16
    ids = rng.integers(3, cfg.vocab_size, (b, s)).astype(np.int32)
    lens = np.asarray([16, 9], np.int32)
    jlogits, jcaches = jax_llama.forward_prefill(
        jparams, jcfg, jnp.asarray(ids), jnp.asarray(lens),
        jax_llama.init_caches(jcfg, b, 32))
    logits, caches = llama.forward_prefill(
        params, cfg, torch.from_numpy(ids), torch.from_numpy(lens),
        llama.init_caches(cfg, b, 32, "cpu"))
    _assert_rel(logits.numpy(), jlogits)
    tokens = np.asarray([7, 11], np.int32)
    jlogits, _ = jax_llama.forward_decode(
        jparams, jcfg, jnp.asarray(tokens), jnp.asarray(lens), jcaches)
    logits, _ = llama.forward_decode(
        params, cfg, torch.from_numpy(tokens), torch.from_numpy(lens), caches)
    _assert_rel(logits.numpy(), jlogits)

    ecfg = dict(max_batch_size=2, max_input_len=32, max_seq_len=64)
    prompts = [[5, 17, 99, 3, 250, 8, 41, 77, 12, 9, 31], [200, 4, 66, 18, 7]]
    want = JaxSession(jcfg, jparams, JaxEngineConfig(**ecfg)).generate(
        prompts, sampling=JaxSampling(end_id=-1), max_new_tokens=10)
    got = GenerationSession(cfg, params, EngineConfig(**ecfg),
                            device="cpu").generate(
        prompts, sampling=SamplingConfig(end_id=-1), max_new_tokens=10)
    np.testing.assert_array_equal(got.output_ids, np.asarray(want.output_ids))


def test_quantize_params_int4_matches_jax_and_skips_quantized():
    """The port's quantize_params on the same float params gives JAX's
    containers; on born-quantized params it quantizes only the lm_head."""
    jcfg, jparams, cfg, floats = _tiny_int4(True, seed=2)
    tfloats = params_from_numpy(jax.tree_util.tree_map(np.asarray, floats),
                                "cpu")
    got = quantize_params(tfloats, QuantMode(int(G128)), group_size=128,
                          quantize_lm_head=True)
    for name in ("wq", "w_down", "lm_head"):
        g = got[name] if name == "lm_head" else got["layers"][name]
        j = jparams[name] if name == "lm_head" else jparams["layers"][name]
        np.testing.assert_array_equal(g.qweight.numpy(), np.asarray(j.qweight))
        np.testing.assert_array_equal(g.scale.numpy(), np.asarray(j.scale))
        assert (g.w_bits, g.group_size, g.pack_block) == (
            j.w_bits, j.group_size, j.pack_block)
    born = init_random_quantized_params(cfg, seed=0, device="cpu")
    again = quantize_params(born, cfg.quant_mode, group_size=128,
                            quantize_lm_head=True)
    assert again["layers"]["wq"] is born["layers"]["wq"]
    assert isinstance(again["lm_head"], tensors.WOQWeight)
    assert again["lm_head"].group_size == 0 and again["lm_head"].w_bits == 4
