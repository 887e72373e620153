"""The PyTorch port's GenerationSession against the JAX package's.

ModelConfig.tiny in f32 with int8 weight-only parameters shared through
params_from_numpy: greedy tokens and lengths are identical, with a ragged
batch and an end_id that stops one sequence early. In bf16 the prefill
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


def test_unported_options_raise():
    cfg = _int8_tiny()
    sess = GenerationSession(cfg, init_random_quantized_params(cfg, device="cpu"),
                             EngineConfig(max_input_len=16, max_seq_len=32),
                             device="cpu")
    for scfg in (SamplingConfig(top_k=5), SamplingConfig(top_p=0.9),
                 SamplingConfig(repetition_penalty=1.2),
                 SamplingConfig(stop_words=((3,),))):
        with pytest.raises(NotImplementedError):
            sess.generate([[1, 2, 3]], sampling=scfg, max_new_tokens=2)
