"""Kernels 2 and 3 of the PyTorch port (plain versions) and the port's
attention ops, against the JAX package: the Pallas prefill and DMA decode
kernels in interpret mode, and the XLA paths.

f32 throughout: rtol/atol 1e-5 (summation order only); cache writes are
compared for equality.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from trtllm_llama_tpu.ops import attention as jax_attn
from trtllm_llama_tpu.ops.pallas.attention import (
    prefill_attention_kernel as jax_prefill_kernel,
)
from trtllm_llama_tpu.ops.pallas.dma_decode_attention import (
    dma_decode_attention as jax_dma_decode,
)
from trtllm_llama_tpu_torch.ops import attention
from trtllm_llama_tpu_torch.ops.kernels.decode_attention import (
    dma_decode_attention,
)
from trtllm_llama_tpu_torch.ops.kernels.prefill_attention import (
    prefill_attention_kernel,
)

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
HEADS = [(4, 4), (8, 2)]       # MHA and a GQA group of 4


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("hq,hkv", HEADS)
def test_prefill_matches_jax_kernel_and_xla(hq, hkv):
    rng = np.random.default_rng(1)
    b, s, d = 2, 24, 32
    q = (rng.standard_normal((b, s, hq, d)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((b, s, hkv, d)) * 0.5).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    lens = np.asarray([s, 13], np.int32)
    got = prefill_attention_kernel(_t(q), _t(k), _t(v), _t(lens)).numpy()
    want_kernel = jax_prefill_kernel(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(lens),
                                     interpret=True)
    want_xla = jax_attn.prefill_attention(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), jnp.asarray(lens))
    np.testing.assert_allclose(got, np.asarray(want_kernel), **TOL)
    np.testing.assert_allclose(got, np.asarray(want_xla), **TOL)
    via_op = attention.prefill_attention(_t(q), _t(k), _t(v), _t(lens))
    np.testing.assert_allclose(via_op.numpy(), got, rtol=0, atol=0)


def _decode_inputs(hq, hkv, s, seed=6):
    rng = np.random.default_rng(seed)
    n_layers, b, d = 2, 2, 32
    kc = rng.standard_normal((n_layers, b, hkv, s, d)).astype(np.float32)
    vc = rng.standard_normal((n_layers, b, hkv, s, d)).astype(np.float32)
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    kn = rng.standard_normal((b, hkv, d)).astype(np.float32)
    vn = rng.standard_normal((b, hkv, d)).astype(np.float32)
    pos = np.asarray([5, s - 1], np.int32)       # incl. the last row
    return q, kn, vn, kc, vc, pos


@pytest.mark.parametrize("s", [64, 96])
@pytest.mark.parametrize("hq,hkv", HEADS)
def test_decode_matches_jax_dma_kernel(hq, hkv, s):
    q, kn, vn, kc, vc, pos = _decode_inputs(hq, hkv, s)
    layer = 1
    want, want_k, want_v = jax_dma_decode(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(kc),
        jnp.asarray(vc), jnp.ones((2,), jnp.float32), layer,
        jnp.asarray(pos), interpret=True)
    tk, tv = _t(kc), _t(vc)
    got = dma_decode_attention(_t(q), _t(kn), _t(vn), tk, tv, layer, _t(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("hq,hkv", HEADS)
def test_decode_matches_jax_xla_path(hq, hkv):
    """fused_decode_attention_at: the port (kernel 3's plain version)
    against the JAX scatter + einsum path it takes below S_max 4096."""
    q, kn, vn, kc, vc, pos = _decode_inputs(hq, hkv, 64, seed=7)
    layer = 0
    jcache = jax_attn.KVCache(jnp.asarray(kc), jnp.asarray(vc),
                              jnp.ones((2,), jnp.float32))
    want, jcache = jax_attn.fused_decode_attention_at(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jcache, layer,
        jnp.asarray(pos))
    cache = attention.KVCache(_t(kc), _t(vc), torch.ones(2))
    got, cache = attention.fused_decode_attention_at(
        _t(q), _t(kn), _t(vn), cache, layer, _t(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(cache.k.numpy(), np.asarray(jcache.k))
    np.testing.assert_array_equal(cache.v.numpy(), np.asarray(jcache.v))
    # the plain read-only decode attention over the written layer
    lens = np.asarray(pos) + 1
    want_ro = jax_attn.decode_attention(
        jnp.asarray(q), jax_attn._layer_cache(jcache, layer),
        jnp.asarray(lens))
    got_ro = attention.decode_attention(_t(q), cache.k[layer], cache.v[layer],
                                        _t(lens))
    np.testing.assert_allclose(got_ro.numpy(), np.asarray(want_ro), **TOL)


def test_cache_writes_match_jax():
    rng = np.random.default_rng(8)
    n_layers, b, hkv, s, d = 2, 2, 2, 16, 8
    kc = rng.standard_normal((n_layers, b, hkv, s, d)).astype(np.float32)
    k = rng.standard_normal((b, 5, hkv, d)).astype(np.float32)
    kn = rng.standard_normal((b, hkv, d)).astype(np.float32)
    pos = np.asarray([7, 11], np.int32)
    jcache = jax_attn.KVCache(jnp.asarray(kc), jnp.asarray(kc),
                              jnp.ones((2,), jnp.float32))
    jcache = jax_attn.write_kv_prefill_at(jcache, 1, jnp.asarray(k),
                                          jnp.asarray(k))
    jcache = jax_attn.write_kv_decode_at(jcache, 0, jnp.asarray(kn),
                                         jnp.asarray(kn), jnp.asarray(pos))
    cache = attention.KVCache(_t(kc), _t(kc), torch.ones(2))
    cache = attention.write_kv_prefill_at(cache, 1, _t(k), _t(k))
    cache = attention.write_kv_decode_at(cache, 0, _t(kn), _t(kn), _t(pos))
    np.testing.assert_array_equal(cache.k.numpy(), np.asarray(jcache.k))
    np.testing.assert_array_equal(cache.v.numpy(), np.asarray(jcache.v))
