"""ALiBi in the PyTorch port against the JAX package: the slopes, the
prefill (kernel 2's and row 12's plain versions, through
`ops.attention.prefill_attention` on either side of
`prefill_streaming_min_s`) and the decode step's JAX-package branch in
every decode_attn_mode.

Inputs are seeded numpy arrays handed to both packages; the JAX package
runs its XLA path on the CPU, and its two Pallas prefill kernels with slopes
in interpret mode. Tolerances: slopes exact; f32 outputs within 1e-5
(summation order only) of the XLA path and 2e-3 of the Pallas streaming
kernel (blocked online softmax, as the port's own streaming test states);
bf16 outputs within 2e-2 of the largest (the JAX path rounds the
probabilities to bf16 before p @ v, the port's plain versions keep them in
f32); decode caches bit-identical.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from trtllm_llama_tpu.ops import attention as jax_attn
from trtllm_llama_tpu.ops.pallas.attention import (
    prefill_attention_kernel as jax_prefill_kernel,
)
from trtllm_llama_tpu.ops.pallas.attention import (
    streaming_prefill_attention_kernel as jax_streaming,
)
from trtllm_llama_tpu.ops.registry import KERNELS as JAX_KERNELS
from trtllm_llama_tpu_torch.ops import attention
from trtllm_llama_tpu_torch.ops.kernels import prefill_attention as _prefill
from trtllm_llama_tpu_torch.ops.kernels import (
    streaming_prefill_attention as _streaming,
)
from trtllm_llama_tpu_torch.ops.registry import KERNELS

torch.set_num_threads(1)

F32_TOL = dict(rtol=1e-5, atol=1e-5)
STREAM_TOL = dict(rtol=2e-3, atol=2e-3)
BF16_TOL = 2e-2      # relative to max |out|


def _t(a):
    return torch.from_numpy(np.array(a))


def _qkv(b, s, hq, hkv, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, hq, d)).astype(np.float32) * 0.3
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32) * 0.3
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("n", [1, 8, 12, 32, 71])
def test_alibi_slopes_exact(n):
    got = attention.alibi_slopes(n)
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_attn.alibi_slopes(n)))


@pytest.mark.parametrize("min_s", [2048, 0, 64])
@pytest.mark.parametrize("b,s,hq,hkv,lens", [
    (2, 48, 4, 4, (48, 17)),
    (2, 100, 8, 2, (100, 0)),        # GQA, a length of 0
    (1, 130, 6, 3, (77,)),           # interpolated slopes (6 heads)
])
def test_alibi_prefill_matches_jax_xla(monkeypatch, min_s, b, s, hq, hkv,
                                       lens):
    """min_s 0 and 64 send these prompts to the streaming plain version,
    2048 to kernel 2's."""
    monkeypatch.setitem(KERNELS, "prefill_streaming_min_s", min_s)
    q, k, v = _qkv(b, s, hq, hkv, 32, seed=s)
    sl = np.asarray(lens, np.int32)
    slopes = attention.alibi_slopes(hq)
    want = jax_attn.prefill_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), jnp.asarray(sl),
                                      alibi=jax_attn.alibi_slopes(hq))
    got = attention.prefill_attention(_t(q), _t(k), _t(v), _t(sl),
                                      alibi=slopes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    plain = attention.prefill_attention(_t(q), _t(k), _t(v), _t(sl))
    assert not np.allclose(got.numpy(), plain.numpy())    # the bias counts


def test_alibi_prefill_bf16_matches_jax():
    q, k, v = _qkv(2, 64, 8, 2, 64, seed=3)
    sl = np.asarray([64, 40], np.int32)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want = np.asarray(jax_attn.prefill_attention(
        *jb, jnp.asarray(sl), alibi=jax_attn.alibi_slopes(8)), np.float32)
    tb = [_t(a).to(torch.bfloat16) for a in (q, k, v)]
    for min_s in (2048, 0):
        KERNELS["prefill_streaming_min_s"] = min_s
        try:
            got = attention.prefill_attention(*tb, _t(sl),
                                              alibi=attention.alibi_slopes(8))
        finally:
            KERNELS["prefill_streaming_min_s"] = 2048
        assert got.dtype == torch.bfloat16
        err = np.abs(got.float().numpy() - want).max()
        assert err <= BF16_TOL * np.abs(want).max(), (min_s, err)


@pytest.mark.parametrize("hq,hkv,s,lens", [
    (4, 2, 600, (600, 300)),         # several query and key blocks, GQA
    (2, 2, 1100, (1100, 64)),        # S not a multiple of any block
])
def test_alibi_streaming_plain_matches_jax_kernel(hq, hkv, s, lens):
    q, k, v = _qkv(2, s, hq, hkv, 128, seed=11)
    sl = np.asarray(lens, np.int32)
    want = np.asarray(jax_streaming(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(sl),
        interpret=True, alibi=jax_attn.alibi_slopes(hq)))
    got = _streaming.streaming_prefill_attention_kernel(
        _t(q), _t(k), _t(v), _t(sl), alibi=attention.alibi_slopes(hq))
    np.testing.assert_allclose(got.numpy(), want, **STREAM_TOL)


def test_alibi_kernel2_plain_matches_jax_kernel():
    q, k, v = _qkv(2, 40, 4, 2, 128, seed=12)
    sl = np.asarray([40, 23], np.int32)
    want = np.asarray(jax_prefill_kernel(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(sl),
        interpret=True, alibi=jax_attn.alibi_slopes(4)))
    got = _prefill.prefill_attention_kernel(
        _t(q), _t(k), _t(v), _t(sl), alibi=attention.alibi_slopes(4))
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


def test_alibi_length_zero_averages_v_in_both_plain_versions():
    """Every column of a length-0 row is exactly NEG_INF (never NEG_INF +
    bias), so both plain versions average V over all S columns."""
    q, k, v = _qkv(1, 70, 4, 4, 32, seed=13)
    sl, slopes = _t(np.asarray([0], np.int32)), attention.alibi_slopes(4)
    mean_v = v[0].mean(0)                                      # [H, D]
    for fn in (_prefill.prefill_attention_kernel_plain,
               _streaming.streaming_prefill_attention_kernel_plain):
        got = fn(_t(q), _t(k), _t(v), sl, alibi=slopes).numpy()[0]
        np.testing.assert_allclose(got, np.broadcast_to(mean_v, got.shape),
                                   **F32_TOL)


def _decode_case(kv_int8, seed):
    rng = np.random.default_rng(seed)
    n_l, b, hq, hkv, s, d = 2, 2, 8, 2, 64, 32
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    kn = rng.standard_normal((b, hkv, d)).astype(np.float32)
    vn = rng.standard_normal((b, hkv, d)).astype(np.float32)
    if kv_int8:
        kc = rng.integers(-127, 128, (n_l, b, hkv, s, d)).astype(np.int8)
        vc = rng.integers(-127, 128, (n_l, b, hkv, s, d)).astype(np.int8)
        scale = np.asarray([0.02, 0.05], np.float32)
    else:
        kc = rng.standard_normal((n_l, b, hkv, s, d)).astype(np.float32)
        vc = rng.standard_normal((n_l, b, hkv, s, d)).astype(np.float32)
        scale = np.ones(n_l, np.float32)
    return q, kn, vn, kc, vc, scale, np.asarray([13, 63], np.int32)


@pytest.mark.parametrize("kv_int8", [False, True])
@pytest.mark.parametrize("mode", ["auto", "dma", "xla", "split", "fused"])
def test_alibi_decode_matches_jax_in_every_mode(monkeypatch, mode, kv_int8):
    q, kn, vn, kc, vc, scale, pos = _decode_case(kv_int8, seed=20)
    monkeypatch.setitem(KERNELS, "decode_attn_mode", mode)
    JAX_KERNELS_OLD = dict(JAX_KERNELS)
    JAX_KERNELS["decode_attn_mode"] = mode
    try:
        jcache = jax_attn.KVCache(jnp.asarray(kc), jnp.asarray(vc),
                                  jnp.asarray(scale))
        want, jcache = jax_attn.fused_decode_attention_at(
            jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jcache, 1,
            jnp.asarray(pos), alibi=jax_attn.alibi_slopes(8))
    finally:
        JAX_KERNELS.clear()
        JAX_KERNELS.update(JAX_KERNELS_OLD)
    cache = attention.KVCache(_t(kc), _t(vc), _t(scale))
    before = attention.fused_decode_attention_at.alibi_calls
    got, cache = attention.fused_decode_attention_at(
        _t(q), _t(kn), _t(vn), cache, 1, _t(pos),
        alibi=attention.alibi_slopes(8))
    assert attention.fused_decode_attention_at.alibi_calls == before + 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    np.testing.assert_array_equal(cache.k.numpy(), np.asarray(jcache.k))
    np.testing.assert_array_equal(cache.v.numpy(), np.asarray(jcache.v))


def test_alibi_decode_bf16_matches_jax():
    q, kn, vn, kc, vc, scale, pos = _decode_case(False, seed=21)
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)
    tb = lambda a: _t(a).to(torch.bfloat16)
    jcache = jax_attn.KVCache(jb(kc), jb(vc), jnp.asarray(scale))
    want, jcache = jax_attn.fused_decode_attention_at(
        jb(q), jb(kn), jb(vn), jcache, 0, jnp.asarray(pos),
        alibi=jax_attn.alibi_slopes(8))
    cache = attention.KVCache(tb(kc), tb(vc), _t(scale))
    got, cache = attention.fused_decode_attention_at(
        tb(q), tb(kn), tb(vn), cache, 0, _t(pos),
        alibi=attention.alibi_slopes(8))
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= BF16_TOL * np.abs(want).max(), err
    np.testing.assert_array_equal(cache.k.float().numpy(),
                                  np.asarray(jcache.k, np.float32))
