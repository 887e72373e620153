"""The port's beam search (`runtime/beam.py`) against the JAX package's, on
the CPU.

Tiny f32 LLaMA parameters shared through params_from_numpy; a ragged
batch of two prompts through `GenerationSession.generate` with beam_width
2 and 4, length_penalty 0 and 1, an end id that some beams emit (so beams
finish and freeze), on the dense cache and with `beam_paged_block` 8: the
beams' ids and lengths identical to the JAX session's, the scores within
1e-5 relative (they are sums of ten or so log-probs: a few f32 ulps), and
the dense and paged runs identical to each other. The cache reorders
(`_gather_cache_window`, `_reorder_paged`) equal JAX's bit for bit on
random caches (float and int8 codes), and a paged row never writes a
block another row's table shares.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trtllm_llama_tpu.config import EngineConfig as JaxEngineConfig
from trtllm_llama_tpu.config import ModelConfig as JaxConfig
from trtllm_llama_tpu.models import llama as jax_llama
from trtllm_llama_tpu.ops.paged_attention import PagedKVCache as JaxPaged
from trtllm_llama_tpu.runtime import beam as jb
from trtllm_llama_tpu.runtime.sampling import SamplingConfig as JaxSampling
from trtllm_llama_tpu.runtime.session import GenerationSession as JaxSession
from trtllm_llama_tpu_torch.config import EngineConfig, ModelConfig
from trtllm_llama_tpu_torch.convert.bridge import params_from_numpy
from trtllm_llama_tpu_torch.runtime import beam as tb
from trtllm_llama_tpu_torch.runtime.sampling import SamplingConfig
from trtllm_llama_tpu_torch.runtime.session import GenerationSession

torch.set_num_threads(1)

ECFG = dict(max_batch_size=8, max_input_len=16, max_seq_len=64)
PROMPTS = [[5, 17, 99, 3, 250, 8], [200, 4, 66]]
NEW = 10


@pytest.fixture(scope="module")
def tiny():
    jcfg = JaxConfig.tiny(dtype="float32")
    jparams = jax_llama.init_params(jcfg, jax.random.PRNGKey(5))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               "cpu")
    return jcfg, jparams, params


def _port(tiny, block):
    return GenerationSession(ModelConfig.tiny(dtype="float32"), tiny[2],
                             EngineConfig(**ECFG), device="cpu",
                             beam_paged_block=block)


@pytest.fixture(scope="module")
def end_id(tiny):
    """A token that beams of the first prompt emit in the third step."""
    out = _port(tiny, 0).generate(PROMPTS, sampling=SamplingConfig(
        beam_width=4, end_id=-1), max_new_tokens=NEW)
    return int(out.beam_ids[0, 1, 2])


@pytest.mark.parametrize("block", [0, 8], ids=["dense", "paged8"])
@pytest.mark.parametrize("width,alpha", [(2, 0.0), (2, 1.0), (4, 0.0),
                                         (4, 1.0)])
def test_beams_match_jax(tiny, end_id, block, width, alpha):
    jcfg, jparams, _ = tiny
    kw = dict(beam_width=width, length_penalty=alpha, end_id=end_id)
    want = JaxSession(jcfg, jparams, JaxEngineConfig(**ECFG),
                      beam_paged_block=block).generate(
        PROMPTS, sampling=JaxSampling(**kw), max_new_tokens=NEW)
    got = _port(tiny, block).generate(PROMPTS, sampling=SamplingConfig(**kw),
                                      max_new_tokens=NEW)
    np.testing.assert_array_equal(got.beam_ids, np.asarray(want.beam_ids))
    np.testing.assert_array_equal(got.beam_lengths,
                                  np.asarray(want.beam_lengths))
    np.testing.assert_allclose(got.beam_scores, np.asarray(want.beam_scores),
                               rtol=1e-5, atol=0)
    np.testing.assert_array_equal(got.output_ids, got.beam_ids[:, 0])
    assert got.beam_ids.shape == (2, width, NEW)
    if width == 4:
        assert (got.beam_lengths < NEW).any()         # some beams finished
    if block:
        dense = _port(tiny, 0).generate(
            PROMPTS, sampling=SamplingConfig(**kw), max_new_tokens=NEW)
        np.testing.assert_array_equal(got.beam_ids, dense.beam_ids)
        np.testing.assert_array_equal(got.beam_scores, dense.beam_scores)


@pytest.mark.parametrize("dtype", [np.float32, np.int8])
def test_gather_cache_window_matches_jax(dtype):
    rng = np.random.default_rng(0)
    a = rng.integers(-100, 100, (2, 6, 3, 128, 4)).astype(dtype)
    gidx = np.array([1, 1, 0, 5, 3, 3], np.int32)
    base = np.array([7, 7, 7, 120, 120, 120], np.int32)   # 120 + 10 clips
    want = np.asarray(jb._gather_cache_window(jnp.asarray(a),
                                              jnp.asarray(gidx),
                                              jnp.asarray(base), 10))
    got = tb._gather_cache_window(torch.from_numpy(a.copy()),
                                  torch.from_numpy(gidx),
                                  torch.from_numpy(base), 10)
    np.testing.assert_array_equal(got.numpy(), want)


def test_reorder_paged_matches_jax_and_never_writes_a_shared_block():
    from trtllm_llama_tpu_torch.ops.paged_attention import PagedKVCache
    rng = np.random.default_rng(1)
    bw, nbr, bs = 4, 5, 4
    pool = rng.standard_normal((2, bw * nbr, 2, bs, 3)).astype(np.float32)
    own = (np.arange(bw)[:, None] * nbr + np.arange(nbr)).astype(np.int32)
    tables, positions = own.copy(), np.array([9, 9, 9, 9], np.int32)
    pk, pv = torch.from_numpy(pool.copy()), torch.from_numpy(-pool)
    cache = PagedKVCache(pk, pv, torch.from_numpy(tables), torch.ones(2))
    jcache = JaxPaged(jnp.asarray(pool), jnp.asarray(-pool),
                      jnp.asarray(tables), jnp.ones(2))
    for step, gidx in enumerate(([0, 0, 2, 2], [3, 1, 1, 0], [2, 2, 2, 2])):
        gidx = np.asarray(gidx, np.int32)
        before = cache.pool_k.clone()
        cache = tb._reorder_paged(cache, torch.from_numpy(gidx),
                                  torch.from_numpy(positions), bs, nbr)
        jcache = jb._reorder_paged(jcache, jnp.asarray(gidx),
                                   jnp.asarray(positions), bs, nbr)
        for got, want in ((cache.pool_k, jcache.pool_k),
                          (cache.pool_v, jcache.pool_v),
                          (cache.tables, jcache.tables)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        # blocks shared by two rows' tables were not written this step
        t = cache.tables.numpy()
        shared = [blk for blk in np.unique(t) if (t == blk).any(1).sum() > 1]
        assert torch.equal(cache.pool_k[:, shared], before[:, shared])
        positions = positions[gidx] + 3
