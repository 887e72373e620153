"""The port's HF loaders of the decoder families (`convert/hf_families.py`)
against the JAX package's and HF transformers', on the CPU.

The five tiny HF models of `tests/test_families.py:21-100` (GPT-J, GPT-NeoX
with a quarter rotary, Bloom, OPT, multi-query Falcon; vocab 256, hidden
128, 2 layers, 4 heads), built in the process from the same seeds; both
packages convert each. Tolerances: the port's config equals JAX's field by
field, its params JAX's leaf for leaf (shape, dtype, bits); f32 prefill
logits within 1e-4 of HF's, decode against prefill within 1e-4, greedy
tokens identical to HF's generate.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax

from trtllm_llama_tpu.convert import hf_families as jax_hf
from trtllm_llama_tpu_torch.config import EngineConfig
from trtllm_llama_tpu_torch.convert import hf_families
from trtllm_llama_tpu_torch.models import decoder
from trtllm_llama_tpu_torch.runtime.sampling import SamplingConfig
from trtllm_llama_tpu_torch.runtime.session import GenerationSession

torch.set_num_threads(1)


def _hf(name):
    """(the HF model, the name of the loaders' family suffix, the port's
    model), as tests/test_families.py builds them."""
    import transformers as tr

    if name == "gptj":
        torch.manual_seed(0)
        cfg = tr.GPTJConfig(vocab_size=256, n_embd=128, n_layer=2, n_head=4,
                            n_positions=128, rotary_dim=16)
        return tr.GPTJForCausalLM(cfg).eval(), decoder.GPTJ
    if name == "gptneox":
        torch.manual_seed(1)
        cfg = tr.GPTNeoXConfig(vocab_size=256, hidden_size=128,
                               num_hidden_layers=2, num_attention_heads=4,
                               intermediate_size=256, rotary_pct=0.25,
                               max_position_embeddings=128)
        return tr.GPTNeoXForCausalLM(cfg).eval(), decoder.GPTNEOX
    if name == "bloom":
        torch.manual_seed(2)
        cfg = tr.BloomConfig(vocab_size=256, hidden_size=128, n_layer=2,
                             n_head=4)
        return tr.BloomForCausalLM(cfg).eval(), decoder.BLOOM
    if name == "opt":
        torch.manual_seed(3)
        cfg = tr.OPTConfig(vocab_size=256, hidden_size=128,
                           num_hidden_layers=2, num_attention_heads=4,
                           ffn_dim=512, max_position_embeddings=128,
                           word_embed_proj_dim=128)
        return tr.OPTForCausalLM(cfg).eval(), decoder.OPT
    torch.manual_seed(4)
    cfg = tr.FalconConfig(vocab_size=256, hidden_size=128,
                          num_hidden_layers=2, num_attention_heads=4,
                          multi_query=True, parallel_attn=True, bias=False,
                          new_decoder_architecture=False, alibi=False,
                          max_position_embeddings=128)
    return tr.FalconForCausalLM(cfg).eval(), decoder.FALCON


NAMES = ["gptj", "gptneox", "bloom", "opt", "falcon"]
_CACHE = {}


@pytest.fixture(params=NAMES, ids=NAMES)
def family(request):
    name = request.param
    if name not in _CACHE:
        hf, model = _hf(name)
        cfg = getattr(hf_families, f"config_from_hf_{name}")(
            hf.config, dtype="float32")
        params = getattr(hf_families, f"params_from_hf_{name}")(hf, cfg)
        _CACHE[name] = (name, hf, cfg, params, model)
    return _CACHE[name]


def test_config_and_params_equal_jax(family):
    name, hf, cfg, params, _ = family
    jcfg = getattr(jax_hf, f"config_from_hf_{name}")(hf.config,
                                                    dtype="float32")
    for f in dataclasses.fields(cfg):
        got, want = getattr(cfg, f.name), getattr(jcfg, f.name)
        assert (int(got) == int(want) if f.name == "quant_mode"
                else got == want), (name, f.name)
    jparams = getattr(jax_hf, f"params_from_hf_{name}")(hf, jcfg)
    flat = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(np.asarray, jparams))[0]
    n_leaves = sum(len(v) if isinstance(v, dict) else 1
                   for v in params.values())
    assert len(flat) == n_leaves, name
    for path, leaf in flat:
        node = params
        for key in path:
            node = node[key.key]
        got = node.numpy()
        assert got.dtype == leaf.dtype and got.shape == leaf.shape, path
        np.testing.assert_array_equal(got, leaf, err_msg=f"{name} {path}")


def test_prefill_logits_match_hf(family):
    name, hf, cfg, params, model = family
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 11))
    with torch.no_grad():
        ref = hf(torch.tensor(ids)).logits.float().numpy()
    logits, _ = model.forward_prefill(
        params, cfg, torch.as_tensor(ids), torch.full((2,), 11,
                                                      dtype=torch.int32),
        model.init_caches(cfg, 2, 32, "cpu"), return_all_logits=True)
    np.testing.assert_allclose(logits.numpy(), ref, atol=1e-4, rtol=0,
                               err_msg=name)


def test_decode_matches_prefill(family):
    name, _, cfg, params, model = family
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 9))
    lens = torch.full((2,), 9, dtype=torch.int32)
    full, _ = model.forward_prefill(params, cfg, torch.as_tensor(ids), lens,
                                    model.init_caches(cfg, 2, 32, "cpu"))
    _, caches = model.forward_prefill(params, cfg, torch.as_tensor(ids[:, :-1]),
                                      lens - 1,
                                      model.init_caches(cfg, 2, 32, "cpu"))
    dec, _ = model.forward_decode(params, cfg, torch.as_tensor(ids[:, -1]),
                                  lens - 1, caches)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), atol=1e-4, rtol=0,
                               err_msg=name)


def test_session_generate_matches_hf(family):
    name, hf, cfg, params, model = family
    ids = np.random.default_rng(2).integers(3, cfg.vocab_size, (1, 8))
    with torch.no_grad():
        ref = hf.generate(torch.tensor(ids), max_new_tokens=10,
                          do_sample=False, pad_token_id=0)
    out = GenerationSession(cfg, params, EngineConfig(max_input_len=16,
                            max_seq_len=64), device="cpu",
                            model=model).generate(
        ids, max_new_tokens=10, sampling=SamplingConfig(end_id=-1))
    np.testing.assert_array_equal(out.output_ids, ref[:, 8:].numpy(),
                                  err_msg=name)


@pytest.mark.parametrize("dtype", ["bfloat16", torch.float16])
def test_loader_dtype_and_device(dtype):
    """The dtype argument (a name or a torch dtype) sets every leaf but
    GPT-J's f32 lm_head bias; the stacks stay on the state dict's device."""
    hf, _ = _hf("gptj")
    cfg = hf_families.config_from_hf_gptj(hf.config)
    params = hf_families.params_from_hf_gptj(hf, cfg, dtype=dtype)
    want = torch.bfloat16 if dtype == "bfloat16" else torch.float16
    leaves = [params[k] for k in params if k != "layers"]
    leaves += list(params["layers"].values())
    assert params["lm_head_b"].dtype == torch.float32
    assert all(t.dtype == want for t in leaves if t is not params["lm_head_b"])
    assert all(t.device.type == "cpu" and t.is_contiguous() for t in leaves)
