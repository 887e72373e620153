"""The port's ChatGLM-6B family (`models/chatglm.py`, `convert/
hf_chatglm.py`) against the JAX package's, on the CPU.

Tiny f32 configs (4 heads of 32, 2 layers); the JAX package's params,
drawn from its PRNG, reach the port through the numpy bridge. The prefix-LM
context runs `prefill_attention(causal=False)` (row 10's plain version
here; row 12's with prefill_streaming_min_s 0), the 2D rotary reads the
half-width table with its two position channels. Tolerances: logits
within 1e-5 of the largest (the order of the f32 sums) for prefill,
decode, extend and int8 weight-only (both packages' quantize_params, the
same codes); caches within 1e-5 (ctx_lens / mask_pos exact); converted
params equal leaf for leaf; greedy, sampled (JAX's noise), beam and
self-draft speculative tokens identical. Where the JAX package fails
(serving: its chatglm.forward_prefill has no slots=; paged beams: no paged
cache), the port raises NotImplementedError naming the reason.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from trtllm_llama_tpu.config import EngineConfig as JaxEngineConfig
from trtllm_llama_tpu.config import ModelConfig as JaxModelConfig
from trtllm_llama_tpu.convert.hf_chatglm import (
    config_from_chatglm as jax_config_from_chatglm,
    params_from_chatglm_state_dict as jax_params_from_sd,
)
from trtllm_llama_tpu.models import chatglm as jax_chatglm
from trtllm_llama_tpu.quantization.mode import QuantMode as JaxQuantMode
from trtllm_llama_tpu.quantization.quantize import (
    quantize_params as jax_quantize_params,
)
from trtllm_llama_tpu.runtime.sampling import SamplingConfig as JaxSampling
from trtllm_llama_tpu.runtime.serving import ServingEngine as JaxServing
from trtllm_llama_tpu.runtime.session import GenerationSession as JaxSession
from trtllm_llama_tpu.runtime.speculative import (
    SpeculativeSession as JaxSpeculative,
)
from trtllm_llama_tpu_torch.config import EngineConfig, ModelConfig
from trtllm_llama_tpu_torch.convert.bridge import params_from_numpy
from trtllm_llama_tpu_torch.convert.hf_chatglm import (
    config_from_chatglm, params_from_chatglm_state_dict,
)
from trtllm_llama_tpu_torch.models import by_architecture, chatglm
from trtllm_llama_tpu_torch.ops.registry import KERNELS
from trtllm_llama_tpu_torch.quantization.mode import QuantMode
from trtllm_llama_tpu_torch.quantization.quantize import quantize_params
from trtllm_llama_tpu_torch.quantization.tensors import WOQWeight
from trtllm_llama_tpu_torch.runtime.sampling import SamplingConfig
from trtllm_llama_tpu_torch.runtime.serving import ServingEngine
from trtllm_llama_tpu_torch.runtime.session import GenerationSession
from trtllm_llama_tpu_torch.runtime.speculative import SpeculativeSession

torch.set_num_threads(1)

LOGITS_REL = 1e-5        # relative to max |logit|
CACHE_TOL = dict(rtol=1e-5, atol=1e-5)
CFG_KW = dict(num_heads=4, num_kv_heads=4, head_dim=32, hidden_size=128,
              dtype="float32")
ECFG = dict(max_batch_size=2, max_input_len=16, max_seq_len=48)


@pytest.fixture(scope="module")
def glm():
    jcfg = JaxModelConfig.tiny(**CFG_KW)
    jparams = jax_chatglm.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               device="cpu")
    return ModelConfig.tiny(**CFG_KW), params, jcfg, jparams


def _close(got, want, rel=LOGITS_REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), err


def _same_cache(got, want):
    np.testing.assert_allclose(got.kv.k.numpy(), np.asarray(want.kv.k),
                               **CACHE_TOL)
    np.testing.assert_allclose(got.kv.v.numpy(), np.asarray(want.kv.v),
                               **CACHE_TOL)
    np.testing.assert_array_equal(got.ctx_lens.numpy(),
                                  np.asarray(want.ctx_lens))
    np.testing.assert_array_equal(got.mask_pos.numpy(),
                                  np.asarray(want.mask_pos))


def _prefill_both(glm, ids, lens, max_len=32, **kw):
    cfg, params, jcfg, jparams = glm
    b = ids.shape[0]
    got = chatglm.forward_prefill(
        params, cfg, torch.as_tensor(ids), torch.as_tensor(lens),
        chatglm.init_caches(cfg, b, max_len, "cpu"), **kw)
    jkw = {k: jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor) else v
           for k, v in kw.items()}
    want = jax_chatglm.forward_prefill(
        jparams, jcfg, jnp.asarray(ids), jnp.asarray(lens),
        jax_chatglm.init_caches(jcfg, b, max_len), **jkw)
    return got, want


@pytest.mark.parametrize("min_s", [2048, 0], ids=["row10", "row12"])
@pytest.mark.parametrize("all_logits", [True, False], ids=["all", "last"])
def test_prefill_matches_jax(monkeypatch, glm, min_s, all_logits):
    """Ragged lengths (the pad rows attend the context too, as JAX's); the
    cache, context lengths and default mask_pos (len - 2) equal."""
    monkeypatch.setitem(KERNELS, "prefill_streaming_min_s", min_s)
    ids = np.random.default_rng(0).integers(3, 250, (2, 10)).astype(np.int32)
    lens = np.array([10, 6], np.int32)
    (got, gc), (want, wc) = _prefill_both(glm, ids, lens,
                                          return_all_logits=all_logits)
    _close(got, want)
    _same_cache(gc, wc)
    assert gc.mask_pos.tolist() == [8, 4]


def test_prefill_explicit_mask_pos(glm):
    ids = np.random.default_rng(1).integers(3, 250, (2, 9)).astype(np.int32)
    lens = np.array([9, 9], np.int32)
    mp = torch.tensor([3, 7], dtype=torch.int32)
    (_, gc), (_, wc) = _prefill_both(glm, ids, lens, mask_pos=mp)
    assert gc.mask_pos.tolist() == [3, 7]
    _same_cache(gc, wc)


def test_decode_steps_match_jax(glm):
    """Prefill, then three decode steps at the running lengths: the 2D
    positions (channel 0 frozen at mask_pos, channel 1 counting) on both
    sides; logits and caches after each step."""
    cfg, params, jcfg, jparams = glm
    rng = np.random.default_rng(2)
    ids = rng.integers(3, 250, (2, 8)).astype(np.int32)
    lens = np.array([8, 5], np.int32)
    toks = rng.integers(3, 250, (2, 3)).astype(np.int32)
    (_, gc), (_, wc) = _prefill_both(glm, ids, lens)
    pos = lens.copy()
    for t in range(3):
        got, gc = chatglm.forward_decode(params, cfg,
                                         torch.as_tensor(toks[:, t]),
                                         torch.as_tensor(pos), gc)
        want, wc = jax_chatglm.forward_decode(
            jparams, jcfg, jnp.asarray(toks[:, t]), jnp.asarray(pos), wc)
        _close(got, want)
        _same_cache(gc, wc)
        pos = pos + 1


def test_extend_matches_jax_and_sequential_decode(glm):
    cfg, params, jcfg, jparams = glm
    rng = np.random.default_rng(3)
    ids = rng.integers(3, 250, (2, 7)).astype(np.int32)
    lens = np.array([7, 5], np.int32)
    toks = rng.integers(3, 250, (2, 3)).astype(np.int32)
    (_, gc), (_, wc) = _prefill_both(glm, ids, lens)
    got, gc = chatglm.forward_extend(params, cfg, torch.as_tensor(toks),
                                     torch.as_tensor(lens), gc)
    want, wc = jax_chatglm.forward_extend(jparams, jcfg, jnp.asarray(toks),
                                          jnp.asarray(lens), wc)
    _close(got, want)
    _same_cache(gc, wc)
    (_, sc), _ = _prefill_both(glm, ids, lens)
    pos = torch.as_tensor(lens)
    for t in range(3):
        step, sc = chatglm.forward_decode(params, cfg,
                                          torch.as_tensor(toks[:, t]), pos,
                                          sc)
        _close(got[:, t], step.numpy(), 1e-4)
        pos = pos + 1
    torch.testing.assert_close(gc.kv.k, sc.kv.k, rtol=0, atol=1e-5)


def test_int8_weight_only_logits_match_jax(glm):
    """int8 weight-only on wq / wk / wv / wo / w_fc / w_proj (both
    packages' quantize_params): prefill and decode logits within 1e-5."""
    cfg, params, jcfg, jparams = glm
    mode = QuantMode.use_weight_only(False)
    qp = quantize_params(params, mode)
    assert sorted(k for k, v in qp["layers"].items()
                  if isinstance(v, WOQWeight)) == sorted(
        ["wq", "wk", "wv", "wo", "w_fc", "w_proj"])
    jqp = jax_quantize_params(jparams, JaxQuantMode(int(mode)))
    ids = np.random.default_rng(4).integers(3, 250, (2, 9)).astype(np.int32)
    lens = np.array([9, 4], np.int32)
    got, gc = chatglm.forward_prefill(
        qp, cfg, torch.as_tensor(ids), torch.as_tensor(lens),
        chatglm.init_caches(cfg, 2, 32, "cpu"), return_all_logits=True)
    want, wc = jax_chatglm.forward_prefill(
        jqp, jcfg, jnp.asarray(ids), jnp.asarray(lens),
        jax_chatglm.init_caches(jcfg, 2, 32), return_all_logits=True)
    _close(got, want)
    tok = np.array([11, 12], np.int32)
    got, _ = chatglm.forward_decode(qp, cfg, torch.as_tensor(tok),
                                    torch.as_tensor(lens), gc)
    want, _ = jax_chatglm.forward_decode(jqp, jcfg, jnp.asarray(tok),
                                         jnp.asarray(lens), wc)
    _close(got, want)


PROMPTS = [[5, 17, 99, 3, 250, 8, 41, 77, 12], [200, 4, 66, 18, 7]]


def test_session_greedy_matches_jax(glm):
    cfg, params, jcfg, jparams = glm
    got = GenerationSession(cfg, params, EngineConfig(**ECFG), device="cpu",
                            model=chatglm).generate(
        PROMPTS, sampling=SamplingConfig(end_id=-1), max_new_tokens=10)
    want = JaxSession(jcfg, jparams, JaxEngineConfig(**ECFG),
                      model=jax_chatglm).generate(
        PROMPTS, sampling=JaxSampling(end_id=-1), max_new_tokens=10)
    np.testing.assert_array_equal(got.output_ids, np.asarray(want.output_ids))
    # the architecture tag picks the same model
    tagged = GenerationSession(ModelConfig.tiny(architecture="chatglm",
                                                **CFG_KW), params,
                               EngineConfig(**ECFG), device="cpu")
    assert tagged.model is chatglm is by_architecture("chatglm")
    again = tagged.generate(PROMPTS, sampling=SamplingConfig(end_id=-1),
                            max_new_tokens=10)
    np.testing.assert_array_equal(again.output_ids, got.output_ids)


def test_session_sampled_matches_jax_with_its_noise(monkeypatch, glm):
    """The JAX session's key chain as the port's noise: identical tokens,
    logprobs within 1e-5."""
    from trtllm_llama_tpu_torch.runtime import sampling
    state = {"key": jax.random.PRNGKey(5)}

    def noise(shape, generator):
        state["key"], sub = jax.random.split(state["key"])
        return torch.from_numpy(np.array(jax.random.gumbel(sub, tuple(shape))))
    monkeypatch.setattr(sampling, "gumbel_noise", noise)
    cfg, params, jcfg, jparams = glm
    kw = dict(temperature=0.8, top_k=40, top_p=0.95, repetition_penalty=1.1,
              end_id=-1)
    got = GenerationSession(cfg, params, EngineConfig(**ECFG), device="cpu",
                            model=chatglm).generate(
        PROMPTS, sampling=SamplingConfig(**kw), max_new_tokens=8, seed=5,
        return_logprobs=True)
    want = JaxSession(jcfg, jparams, JaxEngineConfig(**ECFG),
                      model=jax_chatglm).generate(
        PROMPTS, sampling=JaxSampling(**kw), max_new_tokens=8, seed=5,
        return_logprobs=True)
    np.testing.assert_array_equal(got.output_ids, np.asarray(want.output_ids))
    np.testing.assert_allclose(got.logprobs, np.asarray(want.logprobs),
                               rtol=0, atol=1e-5)


def test_beams_match_jax_and_paged_raises(glm):
    """Dense beams: the wrapped cache's window moves with the parents,
    beam for beam as JAX's. Paged beams: JAX's fail (no paged cache for
    ChatGLM); the port raises NotImplementedError."""
    cfg, params, jcfg, jparams = glm
    ids = np.asarray([PROMPTS[0]], np.int32)
    scfg = dict(end_id=-1, beam_width=3)
    got = GenerationSession(cfg, params, EngineConfig(**ECFG), device="cpu",
                            model=chatglm).generate(
        ids, sampling=SamplingConfig(**scfg), max_new_tokens=5)
    want = JaxSession(jcfg, jparams, JaxEngineConfig(**ECFG),
                      model=jax_chatglm).generate(
        ids, sampling=JaxSampling(**scfg), max_new_tokens=5)
    np.testing.assert_array_equal(got.beam_ids, np.asarray(want.beam_ids))
    np.testing.assert_allclose(got.beam_scores, np.asarray(want.beam_scores),
                               rtol=0, atol=1e-4)
    with pytest.raises(AttributeError):
        JaxSession(jcfg, jparams, JaxEngineConfig(**ECFG), model=jax_chatglm,
                   beam_paged_block=8).generate(
            ids, sampling=JaxSampling(**scfg), max_new_tokens=5)
    with pytest.raises(NotImplementedError, match="paged"):
        GenerationSession(cfg, params, EngineConfig(**ECFG), device="cpu",
                          model=chatglm, beam_paged_block=8).generate(
            ids, sampling=SamplingConfig(**scfg), max_new_tokens=5)


def test_self_draft_speculation_equals_greedy_and_jax(glm):
    cfg, params, jcfg, jparams = glm
    plain = GenerationSession(cfg, params, EngineConfig(**ECFG), device="cpu",
                              model=chatglm).generate(
        PROMPTS, sampling=SamplingConfig(end_id=-1), max_new_tokens=10)
    spec = SpeculativeSession(cfg, params, cfg, params, EngineConfig(**ECFG),
                              gamma=3, model=chatglm, draft_model=chatglm,
                              device="cpu")
    got = spec.generate(PROMPTS, sampling=SamplingConfig(end_id=-1),
                        max_new_tokens=10)
    np.testing.assert_array_equal(got.output_ids, plain.output_ids)
    want = JaxSpeculative(jcfg, jparams, jcfg, jparams,
                          JaxEngineConfig(**ECFG), gamma=3,
                          model=jax_chatglm,
                          draft_model=jax_chatglm).generate(
        PROMPTS, sampling=JaxSampling(end_id=-1), max_new_tokens=10)
    np.testing.assert_array_equal(got.output_ids, np.asarray(want.output_ids))


def test_serving_raises_where_jax_fails(glm):
    """JAX's engine fails at its first admission (its forward_prefill takes
    no slots=); the port's refuses the model when it is built."""
    cfg, params, jcfg, jparams = glm
    jeng = JaxServing(jcfg, jparams, JaxEngineConfig(**ECFG),
                      sampling=JaxSampling(end_id=-1), decode_chunk=3,
                      model=jax_chatglm)
    jeng.submit(PROMPTS[1], 3)
    with pytest.raises(AttributeError):
        jeng.run_to_completion()
    with pytest.raises(NotImplementedError, match="slots="):
        ServingEngine(cfg, params, EngineConfig(**ECFG),
                      sampling=SamplingConfig(end_id=-1), decode_chunk=3,
                      model=chatglm, device="cpu")


def _thudm_state_dict(jparams, cfg):
    """A THUDM-layout state dict of the JAX params: the fused
    query_key_value head-interleaved [head, (q, k, v), head_dim]."""
    lw = {k: np.asarray(v) for k, v in jparams["layers"].items()}
    h, hd, d = cfg.num_heads, cfg.head_dim, cfg.hidden_size
    t = lambda a: torch.from_numpy(np.array(a))
    sd = {
        "transformer.word_embeddings.weight": t(jparams["embedding"]),
        "transformer.final_layernorm.weight": t(jparams["final_norm_w"]),
        "transformer.final_layernorm.bias": t(jparams["final_norm_b"]),
        "lm_head.weight": t(np.asarray(jparams["lm_head"]).T),
    }
    for i in range(cfg.num_layers):
        p = f"transformer.layers.{i}."
        rows = lambda key: lw[key][i].T.reshape(h, hd, d)
        sd[p + "attention.query_key_value.weight"] = t(np.stack(
            [rows("wq"), rows("wk"), rows("wv")], axis=1).reshape(-1, d))
        sd[p + "attention.query_key_value.bias"] = t(np.stack(
            [lw[k][i].reshape(h, hd) for k in ("bq", "bk", "bv")],
            axis=1).reshape(-1))
        for name, key in (("attention.dense", "o"),
                          ("mlp.dense_h_to_4h", "_fc"),
                          ("mlp.dense_4h_to_h", "_proj")):
            sd[p + name + ".weight"] = t(lw["w" + key][i].T)
            sd[p + name + ".bias"] = t(lw["b" + key][i])
        for name, key in (("input_layernorm", "ln1"),
                          ("post_attention_layernorm", "ln2")):
            sd[p + name + ".weight"] = t(lw[key + "_w"][i])
            sd[p + name + ".bias"] = t(lw[key + "_b"][i])
    return sd


def test_state_dict_converter_equals_jax(glm):
    """Both converters on one THUDM-layout state dict: every leaf equal,
    and the round trip gives the original params back; the default config
    is ChatGLM-6B's and equals JAX's field for field."""
    import dataclasses
    cfg, params, jcfg, jparams = glm
    sd = _thudm_state_dict(jparams, cfg)
    got = params_from_chatglm_state_dict(sd, cfg)
    want = jax_params_from_sd(sd, jcfg)
    flat = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(np.asarray, want))[0]
    assert len(flat) == 4 + len(got["layers"]) == 20
    for path, leaf in flat:
        node, orig = got, params
        for key in path:
            node, orig = node[key.key], orig[key.key]
        assert node.is_contiguous() and node.dtype == torch.float32
        np.testing.assert_array_equal(node.numpy(), leaf, err_msg=str(path))
        np.testing.assert_array_equal(node.numpy(), orig.numpy())
    big, jbig = config_from_chatglm(), jax_config_from_chatglm()
    for f in dataclasses.fields(big):
        a, b = getattr(big, f.name), getattr(jbig, f.name)
        assert (int(a) == int(b) if f.name == "quant_mode" else a == b), f.name
    assert (big.num_layers, big.hidden_size, big.num_heads, big.head_dim,
            big.intermediate_size, big.vocab_size,
            big.max_position_embeddings, big.rms_norm_eps) == (
        28, 4096, 32, 128, 16384, 130528, 2048, 1e-5)
    half = chatglm.rope_tables(cfg)
    assert half[0].shape == (cfg.max_position_embeddings, cfg.head_dim // 2)
