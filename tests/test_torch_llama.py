"""The PyTorch port's LLaMA forward against the JAX package's, with the
same int8 weight-only parameters carried across by params_from_numpy.

ModelConfig.tiny in f32: prefill and decode logits agree to 1e-4 (f32
summation order through two layers), the KV caches to 1e-5.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from trtllm_llama_tpu.config import ModelConfig as JaxConfig
from trtllm_llama_tpu.models import llama as jax_llama
from trtllm_llama_tpu.quantization.mode import QuantMode as JaxQuantMode
from trtllm_llama_tpu.quantization.quantize import quantize_params
from trtllm_llama_tpu_torch.config import ModelConfig
from trtllm_llama_tpu_torch.convert.bridge import params_from_numpy
from trtllm_llama_tpu_torch.models import llama
from trtllm_llama_tpu_torch.quantization.mode import QuantMode
from trtllm_llama_tpu_torch.quantization.tensors import WOQWeight

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)


def jax_int8_params(cfg, seed=0):
    params = jax_llama.init_params(cfg, jax.random.PRNGKey(seed))
    return quantize_params(params, JaxQuantMode.use_weight_only(False))


@pytest.mark.parametrize("fused_qkv", [False, True])
def test_prefill_and_decode_logits_match_jax(fused_qkv):
    jcfg = JaxConfig.tiny(dtype="float32")
    cfg = ModelConfig.tiny(dtype="float32")
    jparams = jax_int8_params(jcfg)
    if fused_qkv:
        jparams = jax_llama.fuse_qkv_params(jparams)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               "cpu")
    key = "wqkv" if fused_qkv else "wq"
    assert isinstance(params["layers"][key], WOQWeight)

    rng = np.random.default_rng(0)
    b, s = 2, 16
    ids = rng.integers(3, cfg.vocab_size, (b, s)).astype(np.int32)
    lens = np.asarray([16, 9], np.int32)
    jcaches = jax_llama.init_caches(jcfg, b, 32)
    jlogits, jcaches = jax_llama.forward_prefill(
        jparams, jcfg, jnp.asarray(ids), jnp.asarray(lens), jcaches)
    caches = llama.init_caches(cfg, b, 32, "cpu")
    logits, caches = llama.forward_prefill(
        params, cfg, torch.from_numpy(ids), torch.from_numpy(lens), caches)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)

    tokens = np.asarray([7, 11], np.int32)
    jlogits, jcaches = jax_llama.forward_decode(
        jparams, jcfg, jnp.asarray(tokens), jnp.asarray(lens), jcaches)
    logits, caches = llama.forward_decode(
        params, cfg, torch.from_numpy(tokens), torch.from_numpy(lens), caches)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(caches.k.numpy(), np.asarray(jcaches.k),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(caches.v.numpy(), np.asarray(jcaches.v),
                               rtol=1e-5, atol=1e-5)


def test_all_logits_and_fuse_qkv_is_exact():
    jcfg = JaxConfig.tiny(dtype="float32", num_layers=1)
    cfg = ModelConfig.tiny(dtype="float32", num_layers=1)
    params = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jax_int8_params(jcfg, seed=1)),
        "cpu")
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        3, 250, (1, 16)).astype(np.int32))
    lens = torch.tensor([16], dtype=torch.int32)
    outs = []
    for p in (params, llama.fuse_qkv_params(params)):
        caches = llama.init_caches(cfg, 1, 16, "cpu")
        outs.append(llama.forward_prefill(p, cfg, ids, lens, caches,
                                          return_all_logits=True)[0])
    assert outs[0].shape == (1, 16, cfg.vocab_size)
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-6, atol=1e-6)


def test_config_json_round_trips_between_packages():
    cfg = ModelConfig.llama_7b(quant_mode=QuantMode.use_weight_only())
    jcfg = JaxConfig.from_json(cfg.to_json())
    assert jcfg == JaxConfig.llama_7b(
        quant_mode=JaxQuantMode.use_weight_only(False))
    assert ModelConfig.from_json(jcfg.to_json()) == cfg
    assert cfg.kv_dtype == "bfloat16"
    assert llama.init_caches(ModelConfig.tiny(), 1, 130, "cpu").k.shape[3] == 256
