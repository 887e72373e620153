"""The PyTorch port's GenerationSession against the JAX package's.

ModelConfig.tiny in f32 with int8 weight-only parameters shared through
params_from_numpy: greedy tokens and lengths are identical, with a ragged
batch and an end_id that stops one sequence early; so are sampled tokens
when the port's `gumbel_noise` returns the noise of the JAX session's own
key chain (logprobs within 1e-5), and greedy runs with stop words, bad
words, penalties and min_length. In bf16 the prefill
logits agree within 3% of the largest logit: the two packages round to
bf16 at the same points but sum in different orders, and one-ulp
differences (2**-8 relative) compound over two layers.
"""

import numpy as np
import pytest
import torch
import jax

from trtllm_llama_tpu.config import EngineConfig as JaxEngineConfig
from trtllm_llama_tpu.config import ModelConfig as JaxConfig
from trtllm_llama_tpu.models import llama as jax_llama
from trtllm_llama_tpu.quantization.mode import QuantMode as JaxQuantMode
from trtllm_llama_tpu.quantization.quantize import quantize_params
from trtllm_llama_tpu.runtime.sampling import SamplingConfig as JaxSampling
from trtllm_llama_tpu.runtime.session import GenerationSession as JaxSession
from trtllm_llama_tpu_torch.config import EngineConfig, ModelConfig
from trtllm_llama_tpu_torch.convert.bridge import params_from_numpy
from trtllm_llama_tpu_torch.models import llama
from trtllm_llama_tpu_torch.quantization.mode import QuantMode
from trtllm_llama_tpu_torch.quantization.quantize import (
    init_random_quantized_params,
)
from trtllm_llama_tpu_torch.runtime.sampling import SamplingConfig
from trtllm_llama_tpu_torch.runtime.session import GenerationSession

torch.set_num_threads(1)

BF16_LOGITS_TOL = 3e-2      # relative to max |logit|, see the module note


def _params(dtype):
    jcfg = JaxConfig.tiny(dtype=dtype)
    jparams = quantize_params(jax_llama.init_params(jcfg, jax.random.PRNGKey(0)),
                              JaxQuantMode.use_weight_only(False))
    return jcfg, jparams, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu")


def test_greedy_tokens_match_jax_with_end_id():
    jcfg, jparams, params = _params("float32")
    cfg = ModelConfig.tiny(dtype="float32")
    ecfg = dict(max_batch_size=2, max_input_len=32, max_seq_len=64)
    prompts = [[5, 17, 99, 3, 250, 8, 41, 77, 12, 9, 31], [200, 4, 66, 18, 7]]
    new = 12
    sess = GenerationSession(cfg, params, EngineConfig(**ecfg), device="cpu")
    free = sess.generate(prompts, sampling=SamplingConfig(end_id=-1),
                         max_new_tokens=new)
    end_id = int(free.output_ids[0, 4])     # stops sequence 0 at step <= 4
    want = JaxSession(jcfg, jparams, JaxEngineConfig(**ecfg)).generate(
        prompts, sampling=JaxSampling(end_id=end_id), max_new_tokens=new)
    got = sess.generate(prompts, sampling=SamplingConfig(end_id=end_id),
                        max_new_tokens=new)
    np.testing.assert_array_equal(got.output_ids, np.asarray(want.output_ids))
    np.testing.assert_array_equal(got.lengths, np.asarray(want.lengths))
    assert got.lengths[0] <= 5 < new          # end_id was hit
    assert (got.output_ids[0, got.lengths[0]:] == 0).all()   # pad_id after


def test_bf16_prefill_logits_match_jax():
    jcfg, jparams, params = _params("bfloat16")
    cfg = ModelConfig.tiny(dtype="bfloat16")
    rng = np.random.default_rng(3)
    ids = rng.integers(3, cfg.vocab_size, (2, 16)).astype(np.int32)
    lens = np.asarray([16, 10], np.int32)
    want, _ = jax_llama.forward_prefill(
        jparams, jcfg, jax.numpy.asarray(ids), jax.numpy.asarray(lens),
        jax_llama.init_caches(jcfg, 2, 32))
    got, _ = llama.forward_prefill(
        params, cfg, torch.from_numpy(ids), torch.from_numpy(lens),
        llama.init_caches(cfg, 2, 32, "cpu"))
    want = np.asarray(want, np.float32)
    assert got.dtype == torch.float32
    err = np.abs(got.numpy() - want).max()
    assert err <= BF16_LOGITS_TOL * np.abs(want).max(), err


def _int8_tiny():
    return ModelConfig.tiny(dtype="float32",
                            quant_mode=QuantMode.use_weight_only())


def test_entry_points_need_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    cfg = _int8_tiny()
    params = init_random_quantized_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GenerationSession(cfg, params, EngineConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_random_quantized_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy({"final_norm": np.ones(4, np.float32)})


def test_prompt_overflow_raises_like_jax():
    jcfg, jparams, params = _params("float32")
    ecfg = dict(max_input_len=32, max_seq_len=24)
    ids = np.full((1, 20), 5, np.int32)
    with pytest.raises(ValueError) as jax_err:
        JaxSession(jcfg, jparams, JaxEngineConfig(**ecfg)).generate(
            ids, max_new_tokens=8)
    with pytest.raises(ValueError) as err:
        GenerationSession(ModelConfig.tiny(dtype="float32"), params,
                          EngineConfig(**ecfg), device="cpu").generate(
            ids, max_new_tokens=8)
    assert str(err.value) == str(jax_err.value)


def _noise_chain(seed):
    """A gumbel_noise stand-in that walks the JAX session's key chain:
    each call splits the key once, as the session does before the prefill's
    draw and each decode step's (JAX runtime/session.py:221, :252), and
    returns jax.random.gumbel of the subkey."""
    state = {"key": jax.random.PRNGKey(seed)}

    def noise(shape, generator):
        state["key"], sub = jax.random.split(state["key"])
        return torch.from_numpy(np.array(jax.random.gumbel(sub, tuple(shape))))
    return noise


ECFG = dict(max_batch_size=2, max_input_len=32, max_seq_len=64)
PROMPTS = [[5, 17, 99, 3, 250, 8, 41, 77, 12, 9, 31], [200, 4, 66, 18, 7]]


def _both(cfg_kw, **gen):
    """Port and JAX sessions on the same int8 weight-only tiny f32 params,
    and a call of each: (port output, JAX output)."""
    jcfg, jparams, params = _params("float32")
    port = GenerationSession(ModelConfig.tiny(dtype="float32"), params,
                             EngineConfig(**ECFG), device="cpu")
    ref = JaxSession(jcfg, jparams, JaxEngineConfig(**ECFG))

    def run(sess, scfg):
        return sess.generate(PROMPTS, sampling=scfg, **gen)
    return (run(port, SamplingConfig(**cfg_kw)),
            run(ref, JaxSampling(**cfg_kw)))


def _same(got, want, logprobs=False):
    np.testing.assert_array_equal(got.output_ids, np.asarray(want.output_ids))
    np.testing.assert_array_equal(got.lengths, np.asarray(want.lengths))
    if logprobs:
        np.testing.assert_allclose(got.logprobs, np.asarray(want.logprobs),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(got.cum_logprobs, want.cum_logprobs,
                                   rtol=0, atol=1e-4)


STOCHASTIC = [
    dict(temperature=0.8, top_k=40, top_p=0.95, repetition_penalty=1.1),
    dict(top_p=0.9),
    dict(temperature=1.3, top_k=5, presence_penalty=0.4,
         frequency_penalty=0.2),
    dict(top_k=1, top_p=0.9),
]


@pytest.mark.parametrize("kw", STOCHASTIC,
                         ids=["t0.8-k40-p0.95-rep", "p0.9", "t1.3-k5-pen",
                              "k1-p0.9"])
def test_sampled_tokens_match_jax_with_its_noise(monkeypatch, kw):
    """The same key chain's noise in both: identical tokens, logprobs
    within 1e-5."""
    from trtllm_llama_tpu_torch.runtime import sampling
    monkeypatch.setattr(sampling, "gumbel_noise", _noise_chain(7))
    got, want = _both(dict(kw, end_id=-1), max_new_tokens=12, seed=7,
                      return_logprobs=True)
    _same(got, want, logprobs=True)
    assert got.logprobs.shape == (2, 12) and (got.logprobs < 0).all()


def _free_tokens():
    jcfg, jparams, params = _params("float32")
    sess = GenerationSession(ModelConfig.tiny(dtype="float32"), params,
                             EngineConfig(**ECFG), device="cpu")
    return sess.generate(PROMPTS, sampling=SamplingConfig(end_id=-1),
                         max_new_tokens=12).output_ids


def test_deterministic_options_match_jax():
    """Greedy with stop words, single- and multi-token bad words,
    penalties, and min_length holding off an end id: identical tokens and
    lengths, logprobs within 1e-5 (0.0 past the end)."""
    free = _free_tokens()
    a = [int(t) for t in free[0]]
    cases = [
        dict(stop_words=((a[4], a[5]),)),
        dict(stop_words=((a[2],), (int(free[1][3]),))),
        dict(bad_words=((a[1],),)),
        dict(bad_words=((a[3], a[4]), (int(free[1][0]), int(free[1][1])))),
        dict(repetition_penalty=1.5, presence_penalty=0.3,
             frequency_penalty=0.2),
        dict(min_length=5),
        dict(min_length=5, repetition_penalty=0.8, stop_words=((a[7],),)),
    ]
    for kw in cases:
        end = a[2] if "min_length" in kw else -1
        got, want = _both(dict(kw, end_id=end), max_new_tokens=12,
                          return_logprobs=True)
        _same(got, want, logprobs=True)
        if "stop_words" in kw and "min_length" not in kw:
            assert got.lengths[0] < 12                    # a stop word hit
        if "bad_words" in kw:
            assert not np.array_equal(got.output_ids, free)
        if kw == dict(min_length=5):
            assert got.lengths[0] > 3                     # end held off
        assert (got.logprobs[0, got.lengths[0]:] == 0).all()


def test_sampled_generate_is_seeded():
    cfg = _int8_tiny()
    sess = GenerationSession(cfg, init_random_quantized_params(cfg, device="cpu"),
                             EngineConfig(max_input_len=16, max_seq_len=32),
                             device="cpu")
    scfg = SamplingConfig(temperature=1.5, top_p=0.95, end_id=-1)

    def run(seed):
        return sess.generate([[1, 2, 3], [4, 5]], sampling=scfg,
                             max_new_tokens=8, seed=seed,
                             return_logprobs=True)
    a, b, c = run(3), run(3), run(4)
    np.testing.assert_array_equal(a.output_ids, b.output_ids)
    np.testing.assert_array_equal(a.logprobs, b.logprobs)
    assert not np.array_equal(a.output_ids, c.output_ids)


def test_unported_options_raise():
    """Every SamplingConfig option runs now (these four against JAX, with
    its noise); prompt tuning (GPT only) still raises, naming its module;
    beam search refuses return_logprobs as JAX's does."""
    cfg = _int8_tiny()
    sess = GenerationSession(cfg, init_random_quantized_params(cfg, device="cpu"),
                             EngineConfig(max_input_len=16, max_seq_len=32),
                             device="cpu")
    from trtllm_llama_tpu_torch.runtime import sampling
    for i, kw in enumerate((dict(top_k=5), dict(top_p=0.9),
                            dict(repetition_penalty=1.2),
                            dict(stop_words=((3,),)))):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(sampling, "gumbel_noise", _noise_chain(i))
            got, want = _both(dict(kw, end_id=-1), max_new_tokens=6, seed=i)
        _same(got, want)
    with pytest.raises(NotImplementedError, match="models/gpt.py"):
        sess.generate([[1, 2, 3]], max_new_tokens=2, prompt=object())
    with pytest.raises(NotImplementedError, match="return_logprobs"):
        sess.generate([[1, 2, 3]], max_new_tokens=2, return_logprobs=True,
                      sampling=SamplingConfig(beam_width=2))
