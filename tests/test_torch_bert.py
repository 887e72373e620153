"""The port's BERT encoder (`models/bert.py`, `convert/hf_bert.py`) against
the JAX package's and HF transformers' BertModel /
BertForQuestionAnswering, on the CPU.

Tiny HF models (vocab 256, hidden 128, 3 layers, 4 heads of 32) built in
the process from seed 0; both packages convert them. Every forward runs
`prefill_attention(causal=False)`: row 10's plain version, and row 12's
with prefill_streaming_min_s 0. Tolerances: params equal to JAX's leaf for
leaf; f32 hidden states and QA logits within 1e-5 of the largest against
JAX's and HF's (pad rows included: HF's attention mask masks keys only,
as the length mask does); bf16 within 3% of the largest against JAX's
(which rounds P to bf16 before P V).
"""

import dataclasses

import ml_dtypes
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from trtllm_llama_tpu.convert.hf_bert import (
    params_from_hf_bert as jax_params_from_hf_bert,
)
from trtllm_llama_tpu.models import bert as jax_bert
from trtllm_llama_tpu_torch.convert.bridge import params_from_numpy
from trtllm_llama_tpu_torch.convert.hf_bert import params_from_hf_bert
from trtllm_llama_tpu_torch.models import bert
from trtllm_llama_tpu_torch.ops.kernels import prefill_attention as _prefill
from trtllm_llama_tpu_torch.ops.kernels import (
    streaming_prefill_attention as _streaming,
)
from trtllm_llama_tpu_torch.ops.registry import KERNELS

torch.set_num_threads(1)

REL = 1e-5             # relative to the largest |value|
BF16_REL = 3e-2
HF_KW = dict(vocab_size=256, hidden_size=128, num_hidden_layers=3,
             num_attention_heads=4, intermediate_size=256,
             max_position_embeddings=64, type_vocab_size=2)


@pytest.fixture(scope="module")
def hf_bert():
    from transformers import BertConfig as HFBertConfig
    from transformers import BertForQuestionAnswering, BertModel

    torch.manual_seed(0)
    hf_cfg = HFBertConfig(**HF_KW)
    enc = BertModel(hf_cfg, add_pooling_layer=False).eval()
    qa = BertForQuestionAnswering(hf_cfg).eval()
    cfg = bert.BertConfig.from_hf_config(hf_cfg)
    jcfg = jax_bert.BertConfig.from_hf_config(hf_cfg)
    return hf_cfg, enc, qa, cfg, jcfg


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), err


def _inputs(seed, b=3, s=12, lens=(12, 7, 1)):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, HF_KW["vocab_size"], (b, s)).astype(np.int32)
    types = rng.integers(0, 2, (b, s)).astype(np.int32)
    return ids, types, np.asarray(lens, np.int32)


def _hf_mask(lens, s):
    return torch.as_tensor((np.arange(s)[None] < lens[:, None]).astype(
        np.int64))


@pytest.mark.parametrize("headed", [False, True], ids=["BertModel", "QA"])
def test_params_and_config_equal_jax(hf_bert, headed):
    hf_cfg, enc, qa, cfg, jcfg = hf_bert
    model = qa if headed else enc
    got = params_from_hf_bert(model, cfg)
    want = jax_params_from_hf_bert(model, jcfg)
    flat = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(np.asarray, want))[0]
    assert len(flat) == 5 + 16 + 2 * headed
    assert ("qa_w" in got) == headed
    for path, leaf in flat:
        node = got
        for key in path:
            node = node[key.key]
        assert node.is_contiguous() and node.dtype == torch.float32
        np.testing.assert_array_equal(node.numpy(), leaf, err_msg=str(path))
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.head_dim == 32 and cfg.torch_dtype == torch.float32


@pytest.mark.parametrize("min_s", [2048, 0], ids=["row10", "row12"])
def test_forward_matches_jax_and_hf(monkeypatch, hf_bert, min_s):
    """Ragged lengths (a length of 1 among them) with token types: every
    row against JAX's, and against HF's BertModel with the padding mask."""
    monkeypatch.setitem(KERNELS, "prefill_streaming_min_s", min_s)
    _, enc, _, cfg, jcfg = hf_bert
    params = params_from_hf_bert(enc, cfg)
    jparams = jax_params_from_hf_bert(enc, jcfg)
    ids, types, lens = _inputs(0)
    got = bert.forward(params, cfg, torch.as_tensor(ids),
                       torch.as_tensor(lens), torch.as_tensor(types))
    want = jax_bert.forward(jparams, jcfg, jnp.asarray(ids),
                            jnp.asarray(lens), jnp.asarray(types))
    _close(got, want)
    with torch.no_grad():
        ref = enc(torch.as_tensor(ids).long(),
                  attention_mask=_hf_mask(lens, ids.shape[1]),
                  token_type_ids=torch.as_tensor(types).long()
                  ).last_hidden_state
    _close(got, ref)
    # no lengths: every column valid, as HF without a mask
    full = bert.forward(params, cfg, torch.as_tensor(ids))
    with torch.no_grad():
        ref = enc(torch.as_tensor(ids).long()).last_hidden_state
    _close(full, ref)


def test_forward_qa_matches_jax_and_hf(hf_bert):
    _, _, qa, cfg, jcfg = hf_bert
    params = params_from_hf_bert(qa, cfg)
    jparams = jax_params_from_hf_bert(qa, jcfg)
    ids, types, lens = _inputs(1, b=2, s=10, lens=(10, 6))
    start, end = bert.forward_qa(params, cfg, torch.as_tensor(ids),
                                 torch.as_tensor(lens),
                                 torch.as_tensor(types))
    jstart, jend = jax_bert.forward_qa(jparams, jcfg, jnp.asarray(ids),
                                       jnp.asarray(lens), jnp.asarray(types))
    _close(start, jstart)
    _close(end, jend)
    with torch.no_grad():
        ref = qa(torch.as_tensor(ids).long(),
                 attention_mask=_hf_mask(lens, ids.shape[1]),
                 token_type_ids=torch.as_tensor(types).long())
    _close(start, ref.start_logits)
    _close(end, ref.end_logits)


def test_bf16_forward_matches_jax(hf_bert):
    _, enc, _, _, _ = hf_bert
    cfg = bert.BertConfig.from_hf_config(enc.config, dtype="bfloat16")
    jcfg = jax_bert.BertConfig.from_hf_config(enc.config, dtype="bfloat16")
    jparams = jax_params_from_hf_bert(enc, jcfg)
    params = params_from_numpy(jax.tree_util.tree_map(
        lambda a: np.asarray(a).astype(ml_dtypes.bfloat16), jparams),
        device="cpu")
    assert params["layers"]["wq"].dtype == torch.bfloat16
    ids, types, lens = _inputs(2)
    got = bert.forward(params, cfg, torch.as_tensor(ids),
                       torch.as_tensor(lens), torch.as_tensor(types))
    want = jax_bert.forward(jparams, jcfg, jnp.asarray(ids),
                            jnp.asarray(lens), jnp.asarray(types))
    assert got.dtype == torch.bfloat16
    _close(got.float(), np.asarray(want.astype(jnp.float32)), BF16_REL)


def test_random_init_and_launch_free_cpu_run():
    """init_params' keys and shapes are JAX's; a CPU forward counts no
    kernel launch."""
    cfg = bert.BertConfig(vocab_size=64, hidden_size=64, num_layers=2,
                          num_heads=2, intermediate_size=128,
                          max_position_embeddings=16)
    params = bert.init_params(cfg, seed=0, device="cpu", qa_head=True)
    jparams = jax_bert.init_params(jax_bert.BertConfig(**dataclasses.asdict(
        cfg)), jax.random.PRNGKey(0), qa_head=True)
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(flat) == 5 + 16 + 2
    for path, leaf in flat:
        node = params
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape, path
    before = (_prefill.prefill_attention_kernel.launches,
              _streaming.streaming_prefill_attention_kernel.launches)
    ids = torch.as_tensor(np.random.default_rng(0).integers(0, 64, (1, 8)))
    s, e = bert.forward_qa(params, cfg, ids)
    assert s.shape == e.shape == (1, 8) and torch.isfinite(s).all()
    assert before == (_prefill.prefill_attention_kernel.launches,
                      _streaming.streaming_prefill_attention_kernel.launches)
