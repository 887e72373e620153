"""FP8 (e4m3) weight pieces of the PyTorch port against the JAX package:
the codec (every code, and an encode sweep with ties, subnormals and
saturation), the quantizer and its interleaved row order, kernel 6's plain
versions against the Pallas kernels in interpret mode, the dense dispatch,
and a tiny fp8 model (with and without an fp8 lm_head) carried across by
params_from_numpy.

Tolerances: codes and scales are exact (bit for bit). Matmuls are in f32
and agree within 1e-5 of the largest |output| (both decode every
encodable code exactly; only the summation order differs). Model logits
agree within 1e-4 of the largest logit (f32 summation order through two
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
from trtllm_llama_tpu.ops import fp8 as jax_fp8
from trtllm_llama_tpu.ops import linear as jax_linear
from trtllm_llama_tpu.ops.pallas.woq_matmul import (
    fp8_matmul as jax_fp8_matmul,
    fp8_matmul_stacked as jax_fp8_matmul_stacked,
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
from trtllm_llama_tpu_torch.ops import fp8, linear
from trtllm_llama_tpu_torch.ops.kernels import fp8_matmul as f8k
from trtllm_llama_tpu_torch.quantization import tensors
from trtllm_llama_tpu_torch.quantization.mode import QuantMode
from trtllm_llama_tpu_torch.quantization.quantize import (
    init_random_quantized_params, quantize_params,
)
from trtllm_llama_tpu_torch.runtime.sampling import SamplingConfig
from trtllm_llama_tpu_torch.runtime.session import GenerationSession

torch.set_num_threads(1)

MATMUL_REL = 1e-5
LOGITS_REL = 1e-4
L, N, LAYER = 2, 128, 1


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_rel(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def test_fp8_decode_every_code_bit_identical():
    codes = np.arange(256, dtype=np.uint8)
    want = np.asarray(jax_fp8.fp8_decode(jnp.asarray(codes)))
    got = fp8.fp8_decode(torch.from_numpy(codes)).numpy()
    nan = np.isnan(want)
    assert nan.sum() == 2 and (np.isnan(got) == nan).all()
    np.testing.assert_array_equal(_bits(got[~nan]), _bits(want[~nan]))
    assert got[0x80] == 0 and np.signbit(got[0x80])       # -0 keeps its sign
    assert got[0x7E] == 448.0 and got[0x01] == 2.0 ** -9  # max, subnormal
    bf16 = fp8.fp8_decode(torch.from_numpy(codes), torch.bfloat16).float()
    np.testing.assert_array_equal(bf16.numpy()[~nan], got[~nan])


def test_fp8_encode_sweep_bit_identical():
    finite = np.asarray(jax_fp8.fp8_decode(jnp.arange(256, dtype=jnp.uint8)))
    grid = np.unique(finite[np.isfinite(finite)])
    ties = (grid[:-1] + grid[1:]) / 2                     # halfway points
    rng = np.random.default_rng(0)
    x = np.concatenate([
        grid, ties, np.nextafter(ties, np.inf), np.nextafter(ties, -np.inf),
        np.linspace(-2.0 ** -6, 2.0 ** -6, 301),          # subnormal range
        [448.0, 449.0, 464.0, 480.0, 500.0, -500.0, 1e30, -1e30,
         np.inf, -np.inf, 0.0, -0.0],
        rng.standard_normal(2000) * 50,
    ]).astype(np.float32)
    want = np.asarray(jax_fp8.fp8_encode(jnp.asarray(x)))
    got = fp8.fp8_encode(torch.from_numpy(x)).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert ((got & 0x7F) != 0x7F).all()                   # never a NaN code
    assert got[x == 500.0][0] == 0x7E and got[x == -500.0][0] == 0xFE


@pytest.mark.parametrize("k", [256, 96])        # interleaved / logical order
def test_quantize_fp8_weight_matches_jax(k):
    rng = np.random.default_rng(k)
    w = (rng.standard_normal((2, k, 48)) * 0.05).astype(np.float32)
    w[0, :, 2] = 0.0
    w[1, :4, 7] = [1e-6, -1e-6, 3.0, -2e-7]     # subnormal after scaling
    want = jax_tensors.quantize_fp8_weight(jnp.asarray(w))
    got = tensors.quantize_fp8_weight(torch.from_numpy(w))
    assert got.interleave_block == want.interleave_block == (128 if k == 256
                                                            else 0)
    np.testing.assert_array_equal(got.qweight.numpy(), np.asarray(want.qweight))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    codes = got.qweight.numpy()
    e, m = (codes >> 3) & 15, codes & 7
    assert not ((e == 0) & (m != 0)).any()      # no subnormal code
    assert ((codes & 0x7F) != 0x7F).all()       # no NaN code
    np.testing.assert_array_equal(got.dequantize().numpy(),
                                  np.asarray(want.dequantize()))


def test_interleave_fp8_rows_is_a_bijection():
    k, n, blk = 256, 8, 128
    rows = np.broadcast_to(np.arange(k, dtype=np.int32)[:, None], (k, n)).copy()
    got = tensors.interleave_fp8_rows(torch.from_numpy(rows), blk).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax_tensors.interleave_fp8_rows(jnp.asarray(rows), blk)))
    assert sorted(got[:, 0].tolist()) == list(range(k))   # a permutation
    assert got[1, 0] == blk // 2 and got[2 * 5, 0] == 5   # 2m+1 <- blk/2 + m
    back = tensors.deinterleave_fp8_rows(torch.from_numpy(got), blk).numpy()
    np.testing.assert_array_equal(back, rows)


def _weights(k, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((L, k, N)) * 0.05).astype(np.float32)
    jw = jax_tensors.quantize_fp8_weight(jnp.asarray(w))
    tw = params_from_numpy({"w": jax.tree_util.tree_map(np.asarray, jw)},
                           "cpu")["w"]
    assert isinstance(tw, tensors.FP8Weight) and tw.qweight.dtype == torch.uint8
    return jw, tw


@pytest.mark.parametrize("k", [256, 96])
@pytest.mark.parametrize("m", [1, 5, 16])
def test_fp8_matmul_2d_plain_matches_jax_kernel(m, k):
    jw, tw = _weights(k, seed=m)
    x = np.random.default_rng(m).standard_normal((m, k)).astype(np.float32)
    j2 = jax_linear._index_layer(jw, LAYER)
    t2 = tensors.FP8Weight(tw.qweight[LAYER], tw.scale[LAYER],
                           tw.interleave_block)
    want = jax_fp8_matmul(jnp.asarray(x), j2, interpret=True)
    got = f8k.fp8_matmul(torch.from_numpy(x), t2)
    assert got.dtype == torch.float32 and got.shape == (m, N)
    _assert_rel(got.numpy(), want, MATMUL_REL)
    _assert_rel(linear.dense(torch.from_numpy(x), t2).numpy(),
                jax_linear.dense(jnp.asarray(x), j2), MATMUL_REL)


@pytest.mark.parametrize("opt", ["plain", "norm", "resid"])
@pytest.mark.parametrize("m", [1, 5, 16])
def test_fp8_stacked_plain_matches_jax_kernel(m, opt):
    k = 256
    jw, tw = _weights(k, seed=m + 10)
    rng = np.random.default_rng(m + 100)
    x = rng.standard_normal((m, k)).astype(np.float32)
    nw = (1.0 + 0.1 * rng.standard_normal((L, k))).astype(np.float32)
    resid = rng.standard_normal((m, N)).astype(np.float32)
    kw = {"plain": {}, "norm": {"norm_w": nw}, "resid": {"resid": resid}}[opt]
    want = jax_fp8_matmul_stacked(jnp.asarray(x), jw, LAYER, interpret=True,
                                  **{n: jnp.asarray(v) for n, v in kw.items()})
    got = f8k.fp8_matmul_stacked(torch.from_numpy(x), tw, LAYER,
                                 **{n: _t(v) for n, v in kw.items()})
    _assert_rel(got.numpy(), want, MATMUL_REL)
    want_f = jax_linear.dense_fused(jnp.asarray(x), jw, layer=LAYER,
                                    **{n: jnp.asarray(v) for n, v in kw.items()})
    got_f = linear.dense_fused(torch.from_numpy(x), tw, layer=LAYER,
                               **{n: _t(v) for n, v in kw.items()})
    _assert_rel(got_f.numpy(), want_f, MATMUL_REL)
    want_d = jax_linear.dense(jnp.asarray(x), jw, layer=LAYER)
    got_d = linear.dense(torch.from_numpy(x), tw, layer=LAYER)
    _assert_rel(got_d.numpy(), want_d, MATMUL_REL)


def test_concat_columns_fp8_matches_jax():
    rng = np.random.default_rng(6)
    ws = [(rng.standard_normal((2, 128, n)) * 0.1).astype(np.float32)
          for n in (32, 16, 16)]
    jq = [jax_tensors.quantize_fp8_weight(jnp.asarray(w)) for w in ws]
    tq = [tensors.quantize_fp8_weight(torch.from_numpy(w)) for w in ws]
    want = jax_tensors.concat_columns(jq)
    got = tensors.concat_columns(tq)
    assert got.interleave_block == want.interleave_block == 128
    np.testing.assert_array_equal(got.qweight.numpy(), np.asarray(want.qweight))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    plain_order = tensors.FP8Weight(tq[1].qweight, tq[1].scale, 0)
    assert tensors.concat_columns([tq[0], plain_order]) is None


def test_init_random_fp8_params_stay_encodable():
    cfg = ModelConfig.tiny(quant_mode=QuantMode.FP8_QDQ)
    params = init_random_quantized_params(cfg, seed=0, device="cpu")
    w = params["layers"]["w_down"]
    assert isinstance(w, tensors.FP8Weight) and w.interleave_block == 128
    assert w.qweight.shape == (2, 256, 128) and w.qweight.dtype == torch.uint8
    assert torch.allclose(w.scale, torch.tensor(256 ** -0.5 / 448.0))
    codes = torch.cat([params["layers"][n].qweight.flatten()
                       for n in ("wq", "wo", "w_gate", "w_down")])
    e, m = (codes >> 3) & 15, codes & 7
    assert not ((e == 0) & (m != 0)).any() and ((codes & 0x7F) != 0x7F).all()
    assert len(torch.unique(codes)) == 256 - 2 - 14        # the encodable set
    assert torch.isfinite(w.dequantize()).all()


FP8 = JaxQuantMode.FP8_QDQ


def _tiny_fp8(lm_head, seed=0):
    jcfg = JaxConfig.tiny(dtype="float32", quant_mode=FP8)
    floats = jax_llama.init_params(jcfg, jax.random.PRNGKey(seed))
    jparams = jax_quantize_params(floats, FP8, quantize_lm_head=lm_head)
    cfg = ModelConfig.tiny(dtype="float32", quant_mode=QuantMode(int(FP8)))
    return jcfg, jparams, cfg, floats


@pytest.mark.parametrize("lm_head", [False, True])
def test_tiny_fp8_model_logits_and_tokens_match_jax(lm_head):
    jcfg, jparams, cfg, _ = _tiny_fp8(lm_head, seed=3)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               "cpu")
    assert isinstance(params["layers"]["wq"], tensors.FP8Weight)
    assert isinstance(params["lm_head"], tensors.FP8Weight) == lm_head

    rng = np.random.default_rng(1)
    b, s = 2, 16
    ids = rng.integers(3, cfg.vocab_size, (b, s)).astype(np.int32)
    lens = np.asarray([16, 9], np.int32)
    jlogits, jcaches = jax_llama.forward_prefill(
        jparams, jcfg, jnp.asarray(ids), jnp.asarray(lens),
        jax_llama.init_caches(jcfg, b, 32))
    logits, caches = llama.forward_prefill(
        params, cfg, torch.from_numpy(ids), torch.from_numpy(lens),
        llama.init_caches(cfg, b, 32, "cpu"))
    _assert_rel(logits.numpy(), jlogits, LOGITS_REL)
    tokens = np.asarray([7, 11], np.int32)
    jlogits, _ = jax_llama.forward_decode(
        jparams, jcfg, jnp.asarray(tokens), jnp.asarray(lens), jcaches)
    logits, _ = llama.forward_decode(
        params, cfg, torch.from_numpy(tokens), torch.from_numpy(lens), caches)
    _assert_rel(logits.numpy(), jlogits, LOGITS_REL)

    ecfg = dict(max_batch_size=2, max_input_len=32, max_seq_len=64)
    prompts = [[5, 17, 99, 3, 250, 8, 41, 77, 12, 9, 31], [200, 4, 66, 18, 7]]
    want = JaxSession(jcfg, jparams, JaxEngineConfig(**ecfg)).generate(
        prompts, sampling=JaxSampling(end_id=-1), max_new_tokens=10)
    got = GenerationSession(cfg, params, EngineConfig(**ecfg),
                            device="cpu").generate(
        prompts, sampling=SamplingConfig(end_id=-1), max_new_tokens=10)
    np.testing.assert_array_equal(got.output_ids, np.asarray(want.output_ids))


def test_quantize_params_fp8_matches_jax_and_skips_quantized():
    _, jparams, cfg, floats = _tiny_fp8(True, seed=4)
    tfloats = params_from_numpy(jax.tree_util.tree_map(np.asarray, floats),
                                "cpu")
    got = quantize_params(tfloats, cfg.quant_mode, quantize_lm_head=True)
    for g, j in ((got["layers"]["wv"], jparams["layers"]["wv"]),
                 (got["lm_head"], jparams["lm_head"])):
        assert g.interleave_block == j.interleave_block
        np.testing.assert_array_equal(g.qweight.numpy(), np.asarray(j.qweight))
        np.testing.assert_array_equal(g.scale.numpy(), np.asarray(j.scale))
    born = init_random_quantized_params(cfg, seed=0, device="cpu")
    again = quantize_params(born, cfg.quant_mode, quantize_lm_head=True)
    assert again["layers"]["w_up"] is born["layers"]["w_up"]
    assert isinstance(again["lm_head"], tensors.FP8Weight)
