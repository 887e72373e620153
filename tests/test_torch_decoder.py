"""The PyTorch port's decoder families (GPT-J, GPT-NeoX, Bloom, OPT and
Falcon) against the JAX package's `models/decoder.py`, with the same
parameters carried across by params_from_numpy.

Each family at ModelConfig.tiny widths, 2 layers. The random tree of the
JAX `init_params` gets random biases and LayerNorm weights (numpy, seeded)
so that every parameter the spec wires is exercised. Tolerances: f32
prefill and decode logits within 1e-5 absolute and relative (summation
order through two layers), the KV caches too; greedy tokens of
`GenerationSession(model=...)` identical to the JAX session's over 16
tokens; bf16 prefill logits within 3% of the largest (bf16 rounds at other
places in the two frameworks, as in the port's llama bf16 test); int8
weight-only tokens (both packages' `quantize_params`) identical at f32.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from trtllm_llama_tpu.config import EngineConfig as JaxEngineConfig
from trtllm_llama_tpu.config import ModelConfig as JaxConfig
from trtllm_llama_tpu.models import decoder as jax_decoder
from trtllm_llama_tpu.quantization.mode import QuantMode as JaxQuantMode
from trtllm_llama_tpu.quantization.quantize import (
    quantize_params as jax_quantize_params,
)
from trtllm_llama_tpu.runtime.sampling import SamplingConfig as JaxSampling
from trtllm_llama_tpu.runtime.session import GenerationSession as JaxSession
from trtllm_llama_tpu_torch.config import EngineConfig, ModelConfig
from trtllm_llama_tpu_torch.convert.bridge import params_from_numpy
from trtllm_llama_tpu_torch.models import by_architecture, decoder, llama
from trtllm_llama_tpu_torch.ops.registry import KERNELS
from trtllm_llama_tpu_torch.quantization.mode import QuantMode
from trtllm_llama_tpu_torch.quantization.quantize import quantize_params
from trtllm_llama_tpu_torch.quantization.tensors import WOQWeight
from trtllm_llama_tpu_torch.runtime.sampling import SamplingConfig
from trtllm_llama_tpu_torch.runtime.session import GenerationSession

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_LOGITS_TOL = 3e-2      # relative to max |logit|
FAMILIES = {  # architecture tag -> tiny config overrides (head_dim 32)
    "gptj": dict(rotary_dim=16),
    "gptneox": dict(rotary_dim=8),
    "bloom": {},
    "opt": {},
    "falcon": dict(num_kv_heads=1),
}
ECFG = dict(max_batch_size=2, max_input_len=32, max_seq_len=64)
PROMPTS = [[5, 17, 99, 3, 250, 8, 41, 77, 12, 9, 31], [200, 4, 66, 18, 7]]


def _cfgs(arch, dtype="float32"):
    over = dict(dtype=dtype, architecture=arch, rms_norm_eps=1e-5,
                **FAMILIES[arch])
    return JaxConfig.tiny(**over), ModelConfig.tiny(**over)


def _jax_family(arch):
    return {"gptj": jax_decoder.GPTJ, "gptneox": jax_decoder.GPTNEOX,
            "bloom": jax_decoder.BLOOM, "opt": jax_decoder.OPT,
            "falcon": jax_decoder.FALCON}[arch]


def _params(arch, dtype="float32", seed=0):
    """(jax cfg, port cfg, jax params, port params): the JAX init with
    random biases and norm weights, the same numbers in both trees."""
    jcfg, cfg = _cfgs(arch, dtype)
    tree = jax.tree_util.tree_map(
        np.asarray, _jax_family(arch).init_params(jcfg,
                                                  jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 100)

    def perturb(d):
        for key, a in d.items():
            if isinstance(a, dict):
                perturb(a)
            elif key.startswith("b") or key.endswith(("_b", "_w")):
                noise = rng.standard_normal(a.shape).astype(np.float32)
                base = 1.0 if key.endswith("_w") else 0.0
                d[key] = (base + 0.1 * noise).astype(a.dtype)
    perturb(tree)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return jcfg, cfg, jparams, params_from_numpy(tree, "cpu")


def _ids(cfg, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, cfg.vocab_size, (2, 16)).astype(np.int32)
    return ids, np.asarray([16, 9], np.int32)


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_prefill_and_decode_logits_match_jax(arch):
    jcfg, cfg, jparams, params = _params(arch)
    fam, jfam = by_architecture(arch), _jax_family(arch)
    assert fam is getattr(decoder, {"gptj": "GPTJ", "gptneox": "GPTNEOX",
                                    "bloom": "BLOOM", "opt": "OPT",
                                    "falcon": "FALCON"}[arch])
    ids, lens = _ids(cfg)
    jlogits, jcaches = jfam.forward_prefill(
        jparams, jcfg, jnp.asarray(ids), jnp.asarray(lens),
        jfam.init_caches(jcfg, 2, 32))
    caches = fam.init_caches(cfg, 2, 32, "cpu")
    logits, caches = fam.forward_prefill(
        params, cfg, torch.from_numpy(ids), torch.from_numpy(lens), caches)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)

    tokens = np.asarray([7, 11], np.int32)
    jlogits, jcaches = jfam.forward_decode(
        jparams, jcfg, jnp.asarray(tokens), jnp.asarray(lens), jcaches)
    logits, caches = fam.forward_decode(
        params, cfg, torch.from_numpy(tokens), torch.from_numpy(lens), caches)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    for got, want in ((caches.k, jcaches.k), (caches.v, jcaches.v)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_all_logits_match_jax(arch):
    jcfg, cfg, jparams, params = _params(arch, seed=1)
    fam, jfam = by_architecture(arch), _jax_family(arch)
    ids, lens = _ids(cfg, seed=1)
    want, _ = jfam.forward_prefill(jparams, jcfg, jnp.asarray(ids),
                                   jnp.asarray(lens),
                                   jfam.init_caches(jcfg, 2, 32),
                                   return_all_logits=True)
    got, _ = fam.forward_prefill(params, cfg, torch.from_numpy(ids),
                                 torch.from_numpy(lens),
                                 fam.init_caches(cfg, 2, 32, "cpu"),
                                 return_all_logits=True)
    assert got.shape == (2, 16, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_session_greedy_tokens_match_jax(arch):
    jcfg, cfg, jparams, params = _params(arch, seed=2)
    want = JaxSession(jcfg, jparams, JaxEngineConfig(**ECFG),
                      model=_jax_family(arch)).generate(
        PROMPTS, sampling=JaxSampling(end_id=-1), max_new_tokens=16)
    got = GenerationSession(cfg, params, EngineConfig(**ECFG), device="cpu",
                            model=by_architecture(arch)).generate(
        PROMPTS, sampling=SamplingConfig(end_id=-1), max_new_tokens=16)
    np.testing.assert_array_equal(got.output_ids, np.asarray(want.output_ids))
    np.testing.assert_array_equal(got.lengths, np.asarray(want.lengths))


@pytest.mark.parametrize("mode", ["auto", "split", "fused"])
@pytest.mark.parametrize("arch", ["bloom", "falcon"])
def test_decode_modes_give_the_jax_tokens(monkeypatch, arch, mode):
    """Falcon's multi-query group and Bloom's ALiBi decode branch in every
    decode_attn_mode; the session picks the model from cfg.architecture."""
    jcfg, cfg, jparams, params = _params(arch, seed=3)
    want = JaxSession(jcfg, jparams, JaxEngineConfig(**ECFG)).generate(
        PROMPTS, sampling=JaxSampling(end_id=-1), max_new_tokens=16)
    monkeypatch.setitem(KERNELS, "decode_attn_mode", mode)
    sess = GenerationSession(cfg, params, EngineConfig(**ECFG), device="cpu")
    assert sess.model is by_architecture(arch)
    got = sess.generate(PROMPTS, sampling=SamplingConfig(end_id=-1),
                        max_new_tokens=16)
    np.testing.assert_array_equal(got.output_ids, np.asarray(want.output_ids))


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_bf16_prefill_logits_match_jax(arch):
    jcfg, cfg, jparams, params = _params(arch, dtype="bfloat16", seed=4)
    fam, jfam = by_architecture(arch), _jax_family(arch)
    ids, lens = _ids(cfg, seed=4)
    want, _ = jfam.forward_prefill(jparams, jcfg, jnp.asarray(ids),
                                   jnp.asarray(lens),
                                   jfam.init_caches(jcfg, 2, 32))
    got, _ = fam.forward_prefill(params, cfg, torch.from_numpy(ids),
                                 torch.from_numpy(lens),
                                 fam.init_caches(cfg, 2, 32, "cpu"))
    assert got.dtype == torch.float32
    want = np.asarray(want, np.float32)
    err = np.abs(got.numpy() - want).max()
    assert err <= BF16_LOGITS_TOL * np.abs(want).max(), err


@pytest.mark.parametrize("arch", ["bloom", "falcon"])
def test_int8_weight_only_tokens_match_jax(arch):
    jcfg, cfg, jparams, params = _params(arch, seed=5)
    jq = jax_quantize_params(jparams, JaxQuantMode.use_weight_only(False))
    q = quantize_params(params, QuantMode.use_weight_only(False))
    for name in ("wq", "wo", "w_fc", "w_proj"):
        assert isinstance(q["layers"][name], WOQWeight), name
        np.testing.assert_array_equal(q["layers"][name].qweight.numpy(),
                                      np.asarray(jq["layers"][name].qweight))
    assert isinstance(q["layers"]["b_fc"], torch.Tensor)
    want = JaxSession(jcfg, jq, JaxEngineConfig(**ECFG),
                      model=_jax_family(arch)).generate(
        PROMPTS, sampling=JaxSampling(end_id=-1), max_new_tokens=16)
    got = GenerationSession(cfg, q, EngineConfig(**ECFG), device="cpu",
                            model=by_architecture(arch)).generate(
        PROMPTS, sampling=SamplingConfig(end_id=-1), max_new_tokens=16)
    np.testing.assert_array_equal(got.output_ids, np.asarray(want.output_ids))


def test_init_params_keys_shapes_and_dtypes_match_jax():
    for arch in FAMILIES:
        jcfg, cfg = _cfgs(arch, "bfloat16")
        want = _jax_family(arch).init_params(jcfg, jax.random.PRNGKey(0))
        got = by_architecture(arch).init_params(cfg, seed=0, device="cpu")
        flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
        assert sorted(got) == sorted(want), arch
        assert sorted(got["layers"]) == sorted(want["layers"]), arch
        for path, leaf in flat_w:
            keys = [p.key for p in path]
            t = got[keys[0]] if len(keys) == 1 else got[keys[0]][keys[1]]
            assert tuple(t.shape) == leaf.shape, (arch, keys)
            assert str(t.dtype).split(".")[-1] == str(leaf.dtype), (arch, keys)
        again = by_architecture(arch).init_params(cfg, seed=0, device="cpu")
        assert torch.equal(got["layers"]["wq"], again["layers"]["wq"])


def test_by_architecture_and_unported_entries():
    assert by_architecture("llama") is llama
    assert by_architecture(None) is llama
    for tag, fam in (("gpt-j", decoder.GPTJ), ("gpt-neox", decoder.GPTNEOX),
                     ("BLOOM", decoder.BLOOM), ("opt", decoder.OPT),
                     ("falcon", decoder.FALCON)):
        assert by_architecture(tag) is fam
    from trtllm_llama_tpu_torch.models import gpt
    assert by_architecture("gpt") is gpt and by_architecture("gpt2") is gpt
    for tag, module in (("chatglm", "chatglm.py"), ("mixtral", "moe.py")):
        with pytest.raises(NotImplementedError, match=module):
            by_architecture(tag)
    with pytest.raises(ValueError):
        by_architecture("t5")
    # forward_extend is ported (tests/test_torch_extend.py holds it
    # against JAX's): a 2-token slab at start 3 gives [1, 2, V] logits
    _, cfg = _cfgs("bloom")
    params = decoder.BLOOM.init_params(cfg, device="cpu")
    caches = decoder.BLOOM.init_caches(cfg, 1, 16, "cpu")
    logits, _ = decoder.BLOOM.forward_extend(
        params, cfg, torch.tensor([[5, 6]]), torch.tensor([3]), caches)
    assert logits.shape == (1, 2, cfg.vocab_size)
