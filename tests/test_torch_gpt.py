"""The port's GPT-2 (`models/gpt.py`, `convert/hf_gpt.py`, prompt tuning
through `GenerationSession(prompt=)`) against the JAX package's and HF
transformers', on the CPU (`tests/test_gpt_model.py`'s cases).

A tiny HF GPT2LMHeadModel (vocab 256, n_embd 128, 2 layers, 4 heads) built
in the process from seed 0; both packages convert it. Tolerances: params
and config equal to JAX's exactly; f32 prefill logits within 1e-4 of HF's
and 2e-5 of JAX's, decode against prefill within 1e-4; greedy tokens
identical to HF's and JAX's (f32); prompt-tuning tokens identical to the
real-token run.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from trtllm_llama_tpu.config import EngineConfig as JaxEngineConfig
from trtllm_llama_tpu.convert.hf_gpt import (
    config_from_hf_gpt2 as jax_config_from_hf_gpt2,
    params_from_hf_gpt2 as jax_params_from_hf_gpt2,
)
from trtllm_llama_tpu.models import gpt as jax_gpt
from trtllm_llama_tpu.quantization.mode import QuantMode as JaxQuantMode
from trtllm_llama_tpu.quantization.quantize import (
    quantize_params as jax_quantize_params,
)
from trtllm_llama_tpu.runtime.sampling import SamplingConfig as JaxSampling
from trtllm_llama_tpu.runtime.session import GenerationSession as JaxSession
from trtllm_llama_tpu_torch.config import EngineConfig
from trtllm_llama_tpu_torch.convert.hf_gpt import (config_from_hf_gpt2,
                                                   params_from_hf_gpt2)
from trtllm_llama_tpu_torch.models import by_architecture, gpt
from trtllm_llama_tpu_torch.quantization.mode import QuantMode
from trtllm_llama_tpu_torch.quantization.quantize import quantize_params
from trtllm_llama_tpu_torch.quantization.tensors import WOQWeight
from trtllm_llama_tpu_torch.runtime.sampling import SamplingConfig
from trtllm_llama_tpu_torch.runtime.session import GenerationSession

torch.set_num_threads(1)

ECFG = dict(max_input_len=16, max_seq_len=64)


@pytest.fixture(scope="module")
def hf_gpt():
    from transformers import GPT2Config, GPT2LMHeadModel

    torch.manual_seed(0)
    hf_cfg = GPT2Config(vocab_size=256, n_embd=128, n_layer=2, n_head=4,
                        n_positions=128)
    model = GPT2LMHeadModel(hf_cfg).eval()
    cfg = config_from_hf_gpt2(hf_cfg, dtype="float32")
    jcfg = jax_config_from_hf_gpt2(hf_cfg, dtype="float32")
    return (model, cfg, params_from_hf_gpt2(model, cfg), jcfg,
            jax_params_from_hf_gpt2(model, jcfg))


def _prefill(params, cfg, ids, lens=None, **kw):
    b, s = ids.shape
    lens = torch.full((b,), s, dtype=torch.int32) if lens is None else lens
    return gpt.forward_prefill(params, cfg, torch.as_tensor(ids), lens,
                               gpt.init_caches(cfg, b, 32, "cpu"), **kw)


def test_gpt_params_and_config_equal_jax(hf_gpt):
    _, cfg, params, jcfg, jparams = hf_gpt
    for f in dataclasses.fields(cfg):
        got, want = getattr(cfg, f.name), getattr(jcfg, f.name)
        assert (int(got) == int(want) if f.name == "quant_mode"
                else got == want), f.name
    flat = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(np.asarray, jparams))[0]
    assert len(flat) == 5 + len(params["layers"]) == 21
    for path, leaf in flat:
        node = params
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), leaf, err_msg=str(path))
    assert params["lm_head"].is_contiguous()
    assert by_architecture("gpt") is gpt and by_architecture("GPT2") is gpt
    assert gpt.rope_tables(cfg) is None


def test_gpt_prefill_logits_match_hf_and_jax(hf_gpt):
    hf, cfg, params, jcfg, jparams = hf_gpt
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 11))
    with torch.no_grad():
        ref = hf(torch.tensor(ids)).logits.numpy()
    logits, _ = _prefill(params, cfg, ids, return_all_logits=True)
    np.testing.assert_allclose(logits.numpy(), ref, atol=1e-4, rtol=0)
    jl, _ = jax_gpt.forward_prefill(
        jparams, jcfg, jnp.asarray(ids), jnp.full((2,), 11, jnp.int32),
        jax_gpt.init_caches(jcfg, 2, 32), return_all_logits=True)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=2e-5,
                               rtol=0)


def test_gpt_decode_and_extend_match_prefill(hf_gpt):
    _, cfg, params, _, _ = hf_gpt
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 9))
    full, _ = _prefill(params, cfg, ids, return_all_logits=True)
    _, caches = _prefill(params, cfg, ids[:, :-1])
    dec, _ = gpt.forward_decode(params, cfg, torch.as_tensor(ids[:, -1]),
                                torch.full((2,), 8, dtype=torch.int32), caches)
    np.testing.assert_allclose(dec.numpy(), full[:, -1].numpy(), atol=1e-4,
                               rtol=0)
    _, caches = _prefill(params, cfg, ids[:, :5])
    ext, _ = gpt.forward_extend(params, cfg, torch.as_tensor(ids[:, 5:]),
                                torch.full((2,), 5, dtype=torch.int32), caches)
    np.testing.assert_allclose(ext.numpy(), full[:, 5:].numpy(), atol=1e-4,
                               rtol=0)


def test_gpt_session_generate_matches_hf_and_jax(hf_gpt):
    hf, cfg, params, jcfg, jparams = hf_gpt
    ids = np.random.default_rng(2).integers(0, cfg.vocab_size, (1, 8))
    new = 10
    with torch.no_grad():
        ref = hf.generate(torch.tensor(ids), max_new_tokens=new,
                          do_sample=False, pad_token_id=0)
    out = GenerationSession(cfg, params, EngineConfig(**ECFG), device="cpu",
                            model=gpt).generate(
        ids, max_new_tokens=new, sampling=SamplingConfig(end_id=-1))
    np.testing.assert_array_equal(out.output_ids, ref[:, 8:].numpy())
    jout = JaxSession(jcfg, jparams, JaxEngineConfig(**ECFG),
                      model=jax_gpt).generate(
        ids, max_new_tokens=new, sampling=JaxSampling(end_id=-1))
    np.testing.assert_array_equal(out.output_ids, jout.output_ids)
    # architecture="gpt2" picks the module without model=
    tagged = dataclasses.replace(cfg, architecture="gpt2")
    again = GenerationSession(tagged, params, EngineConfig(**ECFG),
                              device="cpu").generate(
        ids, max_new_tokens=new, sampling=SamplingConfig(end_id=-1))
    np.testing.assert_array_equal(again.output_ids, out.output_ids)


def test_gpt_beam_and_quantized(hf_gpt):
    """Beams run through GPT; int8 weight-only on all six projections a
    layer (both packages' quantize_params) gives JAX's tokens at f32."""
    _, cfg, params, jcfg, jparams = hf_gpt
    ids = np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 6))
    ecfg = dict(max_input_len=16, max_seq_len=48)
    sess = GenerationSession(cfg, params, EngineConfig(**ecfg), device="cpu",
                             model=gpt)
    beam = sess.generate(ids, max_new_tokens=5,
                         sampling=SamplingConfig(end_id=-1, beam_width=3))
    jbeam = JaxSession(jcfg, jparams, JaxEngineConfig(**ecfg),
                       model=jax_gpt).generate(
        ids, max_new_tokens=5, sampling=JaxSampling(end_id=-1, beam_width=3))
    assert beam.beam_ids.shape == (1, 3, 5)
    np.testing.assert_array_equal(beam.beam_ids, jbeam.beam_ids)

    mode = QuantMode.use_weight_only(False)
    qp = quantize_params(params, mode)
    assert all(isinstance(qp["layers"][k], WOQWeight)
               for k in ("wq", "wk", "wv", "wo", "w_fc", "w_proj"))
    qout = GenerationSession(cfg, qp, EngineConfig(**ecfg), device="cpu",
                             model=gpt).generate(
        ids, max_new_tokens=8, sampling=SamplingConfig(end_id=-1))
    jqp = jax_quantize_params(jparams, JaxQuantMode(int(mode)))
    jq = JaxSession(jcfg, jqp, JaxEngineConfig(**ecfg),
                    model=jax_gpt).generate(
        ids, max_new_tokens=8, sampling=JaxSampling(end_id=-1))
    np.testing.assert_array_equal(qout.output_ids, jq.output_ids)


def _virtual(cfg, params, rng, tvs=4):
    """Two prompts of 8 real ids, and the same with their first tvs ids
    made virtual over a table holding those ids' embeddings."""
    real = rng.integers(3, cfg.vocab_size, (2, 8)).astype(np.int32)
    table = np.concatenate([params["embed"].numpy()[real[t, :tvs]]
                            for t in range(2)], axis=0)
    virt = real.copy()
    virt[:, :tvs] = cfg.vocab_size + np.arange(tvs)
    return real, virt, table


def test_prompt_tuning_matches_real_token_run(hf_gpt):
    """Virtual ids whose prompt-table rows are real embeddings generate
    bit-identically to the real-token prompt (the reference's
    PromptTuningEmbedding contract, layers/embedding.py:38-81); so does
    JAX's session on the same inputs."""
    _, cfg, params, jcfg, jparams = hf_gpt
    real, virt, table = _virtual(cfg, params, np.random.default_rng(4))
    sess = GenerationSession(cfg, params, EngineConfig(max_input_len=16,
                             max_seq_len=48), device="cpu", model=gpt)
    scfg = SamplingConfig(end_id=-1)
    out_real = sess.generate(real, max_new_tokens=6, sampling=scfg)
    pt = gpt.PromptTuning(table, np.array([0, 1], np.int32), 4)
    out_virt = sess.generate(virt, max_new_tokens=6, sampling=scfg, prompt=pt)
    np.testing.assert_array_equal(out_real.output_ids, out_virt.output_ids)
    jpt = jax_gpt.PromptTuning(jnp.asarray(table),
                               jnp.asarray([0, 1], jnp.int32), jnp.int32(4))
    jout = JaxSession(jcfg, jparams, JaxEngineConfig(max_input_len=16,
                      max_seq_len=48), model=jax_gpt).generate(
        virt, max_new_tokens=6, sampling=JaxSampling(end_id=-1), prompt=jpt)
    np.testing.assert_array_equal(out_virt.output_ids, jout.output_ids)
    with pytest.raises(NotImplementedError, match="prompt tuning"):
        sess.generate(virt, max_new_tokens=2, prompt=pt,
                      sampling=SamplingConfig(end_id=-1, beam_width=2))


def test_prompt_tuning_table_changes_output(hf_gpt):
    """A different prompt table steers the model (the virtual path does
    not read the normal table)."""
    _, cfg, params, _, _ = hf_gpt
    rng = np.random.default_rng(5)
    ids = rng.integers(3, cfg.vocab_size, (1, 8)).astype(np.int32)
    ids[:, :4] = cfg.vocab_size + np.arange(4)

    def run(scale):
        pt = gpt.PromptTuning(
            torch.from_numpy(rng.standard_normal((4, cfg.hidden_size))
                             .astype(np.float32) * scale),
            torch.zeros(1, dtype=torch.int32), torch.tensor(4))
        logits, _ = _prefill(params, cfg, ids, prompt=pt)
        return logits.numpy()

    assert np.abs(run(0.02) - run(1.0)).max() > 1e-3


def test_prompt_tuning_with_penalties_stays_in_vocab(hf_gpt):
    """A virtual-id prompt under a repetition and a presence penalty: the
    token counts take only real ids (JAX's scatter drops the virtual ones;
    a torch scatter past the row would raise), so the run equals JAX's and
    counts nothing past the vocabulary."""
    from trtllm_llama_tpu_torch.runtime.sampling import init_token_counts

    _, cfg, params, jcfg, jparams = hf_gpt
    _, virt, table = _virtual(cfg, params, np.random.default_rng(6))
    counts = init_token_counts(torch.as_tensor(virt),
                               torch.tensor([8, 6], dtype=torch.int32),
                               cfg.vocab_size)
    assert counts.shape == (2, cfg.vocab_size)
    assert counts.sum(1).tolist() == [4, 2]          # the real ids only
    kw = dict(repetition_penalty=1.3, presence_penalty=0.2, end_id=-1)
    pt = gpt.PromptTuning(table, np.array([0, 1], np.int32), 4)
    out = GenerationSession(cfg, params, EngineConfig(max_input_len=16,
                            max_seq_len=48), device="cpu", model=gpt).generate(
        virt, max_new_tokens=8, sampling=SamplingConfig(**kw), prompt=pt)
    jpt = jax_gpt.PromptTuning(jnp.asarray(table),
                               jnp.asarray([0, 1], jnp.int32), jnp.int32(4))
    jout = JaxSession(jcfg, jparams, JaxEngineConfig(max_input_len=16,
                      max_seq_len=48), model=jax_gpt).generate(
        virt, max_new_tokens=8, sampling=JaxSampling(**kw), prompt=jpt)
    np.testing.assert_array_equal(out.output_ids, jout.output_ids)
    assert (out.output_ids < cfg.vocab_size).all()
