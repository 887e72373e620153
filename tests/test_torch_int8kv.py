"""The PyTorch port's int8 KV cache against the JAX package: the codec
(_quant_kv / _dequant_kv), the prefill and decode writes, and decode
attention with an int8 cache (kernel 3's plain version through
fused_decode_attention_at, and the read-only decode_attention).

Tolerances: cache codes are bit-identical to the JAX package's division
codec; attention agrees with the JAX XLA path to rtol/atol 1e-5 in f32
(where its dequantized K/V, rounded to q's dtype, equal the f32 ones).
The JAX Pallas DMA kernel encodes with a multiply by 1/scale instead of the
division, so against it codes may differ by one and outputs by 1e-3.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from trtllm_llama_tpu.ops import attention as jax_attn
from trtllm_llama_tpu.ops.pallas.dma_decode_attention import (
    dma_decode_attention as jax_dma_decode,
)
from trtllm_llama_tpu_torch.ops import attention

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
HEADS = [(4, 4), (8, 2)]       # MHA and a GQA group of 4
SCALES = np.asarray([0.05, 0.021], np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _int8_cache_inputs(hq, hkv, s, seed):
    rng = np.random.default_rng(seed)
    n_layers, b, d = 2, 2, 32
    kc = rng.integers(-127, 128, (n_layers, b, hkv, s, d)).astype(np.int8)
    vc = rng.integers(-127, 128, (n_layers, b, hkv, s, d)).astype(np.int8)
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    # new K/V up to 4x the int8 range, so the clamp is exercised
    kn = (rng.standard_normal((b, hkv, d)) * 4).astype(np.float32)
    vn = (rng.standard_normal((b, hkv, d)) * 4).astype(np.float32)
    pos = np.asarray([5, s - 1], np.int32)
    return q, kn, vn, kc, vc, pos


def test_kv_codec_matches_jax():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 3, 7, 32)) * 4).astype(np.float32)
    x[0, 0, 0, :3] = [0.025, -0.075, 0.125]        # halfway codes at 0.05
    for scale in SCALES:
        jcache = jax_attn.make_kv_cache(1, 1, 1, 1, jnp.int8, scale)
        want = jax_attn._quant_kv(jnp.asarray(x), jcache)
        got = attention._quant_kv(_t(x), torch.int8, torch.tensor(scale))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for dtype, jdtype in ((torch.float32, jnp.float32),
                              (torch.bfloat16, jnp.bfloat16)):
            back = attention._dequant_kv(got, torch.tensor(scale), dtype)
            want_back = jax_attn._dequant_kv(want, jcache, jdtype)
            np.testing.assert_array_equal(back.float().numpy(),
                                          np.asarray(want_back, np.float32))
    # an fp8 cache (uint8) takes the JAX package's e4m3 codec at scale 1.0
    fp8 = jax_attn.make_kv_cache(1, 1, 1, 1, jnp.uint8, 1.0)
    np.testing.assert_array_equal(
        attention._quant_kv(_t(x), torch.uint8, torch.tensor(1.0)).numpy(),
        np.asarray(jax_attn._quant_kv(jnp.asarray(x), fp8)))


def test_int8_cache_writes_match_jax():
    rng = np.random.default_rng(2)
    n_layers, b, hkv, s, d = 2, 2, 2, 16, 8
    kc = rng.integers(-127, 128, (n_layers, b, hkv, s, d)).astype(np.int8)
    k = (rng.standard_normal((b, 5, hkv, d)) * 4).astype(np.float32)
    v = (rng.standard_normal((b, 5, hkv, d)) * 4).astype(np.float32)
    kn = (rng.standard_normal((b, hkv, d)) * 4).astype(np.float32)
    pos = np.asarray([7, 11], np.int32)
    jcache = jax_attn.KVCache(jnp.asarray(kc), jnp.asarray(kc),
                              jnp.asarray(SCALES))
    jcache = jax_attn.write_kv_prefill_at(jcache, 1, jnp.asarray(k),
                                          jnp.asarray(v))
    jcache = jax_attn.write_kv_decode_at(jcache, 0, jnp.asarray(kn),
                                         jnp.asarray(-kn), jnp.asarray(pos))
    cache = attention.KVCache(_t(kc), _t(kc), _t(SCALES))
    cache = attention.write_kv_prefill_at(cache, 1, _t(k), _t(v))
    cache = attention.write_kv_decode_at(cache, 0, _t(kn), _t(-kn), _t(pos))
    assert cache.k.dtype == torch.int8
    np.testing.assert_array_equal(cache.k.numpy(), np.asarray(jcache.k))
    np.testing.assert_array_equal(cache.v.numpy(), np.asarray(jcache.v))


@pytest.mark.parametrize("hq,hkv", HEADS)
def test_int8_decode_matches_jax_xla_path(hq, hkv):
    """fused_decode_attention_at with an int8 cache: the port (kernel 3's
    plain version) against the JAX scatter + einsum path, in f32."""
    q, kn, vn, kc, vc, pos = _int8_cache_inputs(hq, hkv, 64, seed=3)
    for layer in (0, 1):
        jcache = jax_attn.KVCache(jnp.asarray(kc), jnp.asarray(vc),
                                  jnp.asarray(SCALES))
        want, jcache = jax_attn.fused_decode_attention_at(
            jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jcache, layer,
            jnp.asarray(pos))
        cache = attention.KVCache(_t(kc), _t(vc), _t(SCALES))
        got, cache = attention.fused_decode_attention_at(
            _t(q), _t(kn), _t(vn), cache, layer, _t(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_array_equal(cache.k.numpy(), np.asarray(jcache.k))
        np.testing.assert_array_equal(cache.v.numpy(), np.asarray(jcache.v))
        lens = pos + 1
        want_ro = jax_attn.decode_attention(
            jnp.asarray(q), jax_attn._layer_cache(jcache, layer),
            jnp.asarray(lens))
        got_ro = attention.decode_attention(
            _t(q), cache.k[layer], cache.v[layer], _t(lens),
            kv_scale=cache.scale[layer])
        np.testing.assert_allclose(got_ro.numpy(), np.asarray(want_ro), **TOL)


@pytest.mark.parametrize("s", [64, 96])
@pytest.mark.parametrize("hq,hkv", HEADS)
def test_int8_decode_matches_jax_dma_kernel(hq, hkv, s):
    q, kn, vn, kc, vc, pos = _int8_cache_inputs(hq, hkv, s, seed=4)
    layer = 1
    want, want_k, want_v = jax_dma_decode(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(kc),
        jnp.asarray(vc), jnp.asarray(SCALES), layer, jnp.asarray(pos),
        interpret=True)
    cache = attention.KVCache(_t(kc), _t(vc), _t(SCALES))
    got, cache = attention.fused_decode_attention_at(
        _t(q), _t(kn), _t(vn), cache, layer, _t(pos))
    for mine, theirs in ((cache.k, want_k), (cache.v, want_v)):
        diff = np.abs(mine.numpy().astype(np.int32)
                      - np.asarray(theirs).astype(np.int32))
        assert diff.max() <= 1
        rows = np.zeros(diff.shape, bool)
        rows[layer, np.arange(2), :, pos] = True
        assert not diff[~rows].any()                 # only row pos written
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                               atol=1e-3)

