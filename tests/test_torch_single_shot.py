"""The port's InferenceSession (`runtime/single_shot.py`) over its BERT
encoder, against the direct forward and the JAX package's session, on the
CPU (`tests/test_single_shot.py`'s cases).

Tiny BERT (vocab 128, hidden 64, 2 heads of 32); JAX's params through the
numpy bridge. Tolerances: the session equals the direct forward exactly
(the same calls); against JAX's session within 1e-5 of the largest; bucket
padding leaves the unpadded rows within 1e-5.
"""

import numpy as np
import pytest
import torch
import jax

from trtllm_llama_tpu.models import bert as jax_bert
from trtllm_llama_tpu.runtime.single_shot import (
    InferenceSession as JaxInferenceSession,
)
from trtllm_llama_tpu_torch.convert.bridge import params_from_numpy
from trtllm_llama_tpu_torch.models import bert
from trtllm_llama_tpu_torch.runtime.single_shot import InferenceSession

torch.set_num_threads(1)

REL = 1e-5
KW = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=2,
          intermediate_size=128, max_position_embeddings=64)


def _tiny(layers=2, qa_head=False, seed=0):
    jcfg = jax_bert.BertConfig(**dict(KW, num_layers=layers))
    jparams = jax_bert.init_params(jcfg, jax.random.PRNGKey(seed),
                                   qa_head=qa_head)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               device="cpu")
    return bert.BertConfig(**dict(KW, num_layers=layers)), params, jcfg, \
        jparams


def _close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


def test_run_matches_direct_forward_and_jax():
    cfg, params, jcfg, jparams = _tiny()
    sess = InferenceSession(bert.forward, cfg, params, device="cpu")
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 128, (2, 9)).astype(np.int32)
    lens = np.array([9, 5], np.int32)
    out = sess.run(ids, lens)
    ref = bert.forward(params, cfg, torch.as_tensor(ids),
                       torch.as_tensor(lens))
    assert torch.equal(out, ref)
    want = JaxInferenceSession(jax_bert.forward, jcfg, jparams).run(ids, lens)
    _close(out, want)
    # tensors and lists go to the session's device as numpy arrays do
    assert torch.equal(sess.run(torch.as_tensor(ids), lens.tolist()), ref)
    assert torch.equal(sess.warmup(ids, lens), ref)


def test_bucket_padding_is_length_masked():
    """Padding the token axis to a bucket leaves the unpadded rows as the
    unpadded call gives them; lengths inside one bucket share its shape."""
    cfg, params, jcfg, jparams = _tiny()
    sess = InferenceSession(bert.forward, cfg, params, pad_axis=1,
                            buckets=(32, 16), device="cpu")
    assert sess.buckets == (16, 32)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 128, (1, 11)).astype(np.int32)
    lens = np.array([11], np.int32)
    out = sess.run(ids, lens)
    assert out.shape == (1, 16, cfg.hidden_size)
    ref = bert.forward(params, cfg, torch.as_tensor(ids),
                       torch.as_tensor(lens))
    _close(out[:, :11], ref)
    want = JaxInferenceSession(jax_bert.forward, jcfg, jparams, pad_axis=1,
                               buckets=(16, 32)).run(ids, lens)
    _close(out, want)
    ids2 = rng.integers(0, 128, (1, 13)).astype(np.int32)
    assert sess.run(ids2, np.array([13], np.int32)).shape == out.shape
    long = rng.integers(0, 128, (1, 40)).astype(np.int32)  # past every bucket
    assert sess.run(long, np.array([40], np.int32)).shape[1] == 40


def test_pad_value_fills_the_padding():
    cfg, params, _, _ = _tiny(layers=1)
    seen = []

    def record(p, c, ids, lens):
        seen.append(ids.clone())
        return bert.forward(p, c, ids, lens)
    sess = InferenceSession(record, cfg, params, pad_axis=1, buckets=(8,),
                            pad_value=3, device="cpu")
    sess.run(np.array([[5, 6, 7]], np.int32), np.array([3], np.int32))
    assert seen[0].tolist() == [[5, 6, 7, 3, 3, 3, 3, 3]]


def test_qa_head_tuple_output():
    cfg, params, jcfg, jparams = _tiny(layers=1, qa_head=True, seed=1)
    sess = InferenceSession(bert.forward_qa, cfg, params, device="cpu")
    ids = np.random.default_rng(2).integers(0, 128, (2, 7)).astype(np.int32)
    lens = np.array([7, 4], np.int32)
    start, end = sess.run(ids, lens)
    assert start.shape == (2, 7) and end.shape == (2, 7)
    jstart, jend = JaxInferenceSession(jax_bert.forward_qa, jcfg,
                                       jparams).run(ids, lens)
    _close(start, jstart)
    _close(end, jend)


def test_device_is_explicit():
    """The session holds its params on its device: "cpu" when asked, and
    without a card the default "cuda" raises rather than falling back."""
    cfg, params, _, _ = _tiny(layers=1)
    sess = InferenceSession(bert.forward, cfg, params, device="cpu")
    assert sess.device == torch.device("cpu")
    assert all(t.device.type == "cpu"
               for t in sess.params["layers"].values())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            InferenceSession(bert.forward, cfg, params)
