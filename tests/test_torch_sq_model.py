"""The port's second path -- LLaMA with SmoothQuant W8A8 weights and an
int8 KV cache -- against the JAX package, end to end at tiny f32 widths.

The same float weights are quantized by each package's own
quantize_params (calibrated activation ranges 3.0); the port's side is
carried across as float by params_from_numpy first. The KV scales are
0.05 per layer. Prefill and decode logits agree to 1e-5 of the
largest logit (the int8 products are exact on both sides; f32 RoPE,
softmax and norms differ in summation order only), the int8 caches are
bit-identical, and greedy tokens are identical.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from trtllm_llama_tpu.config import EngineConfig as JaxEngineConfig
from trtllm_llama_tpu.config import ModelConfig as JaxConfig
from trtllm_llama_tpu.models import llama as jax_llama
from trtllm_llama_tpu.quantization.mode import QuantMode as JaxQuantMode
from trtllm_llama_tpu.quantization.quantize import (
    quantize_params as jax_quantize_params,
)
from trtllm_llama_tpu.runtime.sampling import SamplingConfig as JaxSampling
from trtllm_llama_tpu.runtime.session import GenerationSession as JaxSession
from trtllm_llama_tpu_torch.config import EngineConfig, ModelConfig
from trtllm_llama_tpu_torch.convert.bridge import params_from_numpy
from trtllm_llama_tpu_torch.models import llama
from trtllm_llama_tpu_torch.quantization.mode import QuantMode
from trtllm_llama_tpu_torch.quantization.quantize import quantize_params
from trtllm_llama_tpu_torch.quantization.tensors import SQWeight
from trtllm_llama_tpu_torch.runtime.sampling import SamplingConfig
from trtllm_llama_tpu_torch.runtime.session import GenerationSession

torch.set_num_threads(1)

LOGITS_RTOL = 1e-5          # relative to max |logit|, see the module note
KV_SCALES = np.full((2,), 0.05, np.float32)
PROJ = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _configs(per_token=True):
    jmode = (JaxQuantMode.use_smooth_quant(per_token=per_token, per_channel=True)
             | JaxQuantMode.INT8_KV_CACHE)
    return (JaxConfig.tiny(dtype="float32", quant_mode=jmode),
            ModelConfig.tiny(dtype="float32", quant_mode=QuantMode(int(jmode))))


def _params(jcfg, cfg, fused_qkv=False, seed=0):
    floats = jax_llama.init_params(jcfg, jax.random.PRNGKey(seed))
    act = {k: np.full((jcfg.num_layers,), 3.0, np.float32) for k in PROJ}
    jparams = jax_quantize_params(floats, jcfg.quant_mode, act_ranges=act)
    params = quantize_params(
        params_from_numpy(jax.tree_util.tree_map(np.asarray, floats), "cpu"),
        cfg.quant_mode, act_ranges=act)
    if fused_qkv:
        jparams = jax_llama.fuse_qkv_params(jparams)
        params = llama.fuse_qkv_params(params)
    return jparams, params


def _assert_logits_close(got, want):
    want = np.asarray(want)
    assert got.dtype == torch.float32 and got.shape == want.shape
    err = np.abs(got.numpy() - want).max()
    assert err <= LOGITS_RTOL * np.abs(want).max(), err


@pytest.mark.parametrize("per_token,fused_qkv",
                         [(True, False), (True, True), (False, True)])
def test_prefill_and_decode_match_jax(per_token, fused_qkv):
    jcfg, cfg = _configs(per_token)
    jparams, params = _params(jcfg, cfg, fused_qkv)
    key = "wqkv" if fused_qkv else "wq"
    assert isinstance(params["layers"][key], SQWeight)
    assert params["layers"][key].per_token == per_token

    rng = np.random.default_rng(0)
    b, s = 2, 16
    ids = rng.integers(3, cfg.vocab_size, (b, s)).astype(np.int32)
    lens = np.asarray([16, 9], np.int32)
    jcaches = jax_llama.init_caches(jcfg, b, 32, KV_SCALES)
    caches = llama.init_caches(cfg, b, 32, "cpu", KV_SCALES)
    assert caches.k.dtype == torch.int8
    jlogits, jcaches = jax_llama.forward_prefill(
        jparams, jcfg, jnp.asarray(ids), jnp.asarray(lens), jcaches)
    logits, caches = llama.forward_prefill(
        params, cfg, torch.from_numpy(ids), torch.from_numpy(lens), caches)
    _assert_logits_close(logits, jlogits)
    np.testing.assert_array_equal(caches.k.numpy(), np.asarray(jcaches.k))

    positions = lens.copy()
    for step, tokens in enumerate(([7, 11], [250, 3])):
        tokens = np.asarray(tokens, np.int32)
        jlogits, jcaches = jax_llama.forward_decode(
            jparams, jcfg, jnp.asarray(tokens), jnp.asarray(positions), jcaches)
        logits, caches = llama.forward_decode(
            params, cfg, torch.from_numpy(tokens), torch.from_numpy(positions),
            caches)
        _assert_logits_close(logits, jlogits)
        positions = positions + 1
    np.testing.assert_array_equal(caches.k.numpy(), np.asarray(jcaches.k))
    np.testing.assert_array_equal(caches.v.numpy(), np.asarray(jcaches.v))


def test_greedy_tokens_match_jax_session():
    jcfg, cfg = _configs()
    jparams, params = _params(jcfg, cfg, seed=1)
    ecfg = dict(max_batch_size=4, max_input_len=16, max_seq_len=64)
    prompts = [[5, 17, 99, 3, 250, 8, 41, 77], [200, 4, 66, 18, 7],
               [9, 31, 12, 140, 33, 21, 90, 8, 6, 2, 77, 15], [101, 55, 3]]
    new = 12
    sess = GenerationSession(cfg, params, EngineConfig(**ecfg),
                             kv_scales=KV_SCALES, device="cpu")
    assert isinstance(sess.params["layers"]["wqkv"], SQWeight)   # fused
    free = sess.generate(prompts, sampling=SamplingConfig(end_id=-1),
                         max_new_tokens=new)
    end_id = int(free.output_ids[0, 4])     # stops sequence 0 at step <= 4
    want = JaxSession(jcfg, jparams, JaxEngineConfig(**ecfg),
                      kv_scales=KV_SCALES).generate(
        prompts, sampling=JaxSampling(end_id=end_id), max_new_tokens=new)
    got = sess.generate(prompts, sampling=SamplingConfig(end_id=end_id),
                        max_new_tokens=new)
    np.testing.assert_array_equal(got.output_ids, np.asarray(want.output_ids))
    np.testing.assert_array_equal(got.lengths, np.asarray(want.lengths))
    assert got.lengths[0] <= 5 < new


def test_init_caches_int8_and_unported_fp8():
    _, cfg = _configs()
    caches = llama.init_caches(cfg, 2, 130, "cpu", KV_SCALES)
    assert caches.k.shape == (2, 2, 4, 256, 32) and caches.v.dtype == torch.int8
    np.testing.assert_array_equal(caches.scale.numpy(), KV_SCALES)
    assert torch.equal(llama.init_caches(cfg, 1, 8, "cpu").scale, torch.ones(2))
    # an fp8 KV cache: e4m3 codes in uint8, with the given scales
    fp8 = ModelConfig.tiny(quant_mode=QuantMode.FP8_KV_CACHE)
    caches = llama.init_caches(fp8, 2, 130, "cpu", KV_SCALES)
    assert caches.k.shape == (2, 2, 4, 256, 32) and caches.v.dtype == torch.uint8
    np.testing.assert_array_equal(caches.scale.numpy(), KV_SCALES)
