"""Head dims and dtypes beyond LLaMA's, large GQA groups and unquantized
projections in the PyTorch port, against the JAX package.

On the CPU every kernel wrapper runs its plain version (the card launches
the kernel, or raises for a shape it has no instantiation for); each test
checks that `ops` reached the right wrapper's plain version.

- Head dims 80, 96 and 256 (GPT-J-6B has 256, GPT-NeoX-20B 96): the
  results match the JAX package's XLA path.
- float16 matches the JAX package's float16 path.
- A weight-only weight whose N is not a multiple of 16 goes through the
  plain GEMV.
- Row 9's plain version at Falcon-7B's group of 71 query heads per KV head
  matches the JAX 'fused' decode mode.
- `init_random_quantized_params` builds unquantized projections (mode 0, or
  the int8 KV cache alone) in the compute dtype.

Tolerances: f32 within 1e-5 (summation order only); f16 within 1e-2 of
the largest magnitude (the JAX XLA path rounds its probabilities to f16
before p @ v, the port's plain versions keep them in f32); caches and pools
bit-identical.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from trtllm_llama_tpu.ops import attention as jax_attn
from trtllm_llama_tpu.ops import paged_attention as jax_paged
from trtllm_llama_tpu.ops.registry import KERNELS as JAX_KERNELS
from trtllm_llama_tpu_torch.config import ModelConfig
from trtllm_llama_tpu_torch.ops import attention, linear
from trtllm_llama_tpu_torch.ops import paged_attention as paged
from trtllm_llama_tpu_torch.ops.kernels import decode_attention as _decode
from trtllm_llama_tpu_torch.ops.kernels import paged_decode_attention as _paged
from trtllm_llama_tpu_torch.ops.kernels import prefill_attention as _prefill
from trtllm_llama_tpu_torch.ops.kernels import (
    streaming_prefill_attention as _streaming,
)
from trtllm_llama_tpu_torch.ops.kernels import woq_matmul as _woq
from trtllm_llama_tpu_torch.ops.registry import KERNELS
from trtllm_llama_tpu_torch.quantization.mode import QuantMode
from trtllm_llama_tpu_torch.quantization.quantize import (
    init_random_quantized_params,
)
from trtllm_llama_tpu_torch.quantization.tensors import quantize_weight_only

torch.set_num_threads(1)

F32_TOL = dict(rtol=1e-5, atol=1e-5)
F16_TOL = 1e-2       # relative to max |out|


def _t(a):
    return torch.from_numpy(np.array(a))


def _close_f16(got, want):
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= F16_TOL * np.abs(want).max(), err


@pytest.fixture
def plain_calls(monkeypatch):
    """spy(module, name) counts the calls of module.<name>_plain; the
    wrappers look their plain versions up by that name."""
    def spy(module, name):
        plain = getattr(module, name + "_plain")
        calls = []

        def counted(*args, **kwargs):
            calls.append(1)
            return plain(*args, **kwargs)
        monkeypatch.setattr(module, name + "_plain", counted)
        return calls
    return spy


def _qkv(b, s, hq, hkv, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32) * 0.3
            for h in (hq, hkv, hkv)]


@pytest.mark.parametrize("d", [80, 96, 256])
@pytest.mark.parametrize("min_s", [2048, 0])
def test_prefill_head_dims_route_to_plain(monkeypatch, plain_calls, d,
                                          min_s):
    monkeypatch.setitem(KERNELS, "prefill_streaming_min_s", min_s)
    q, k, v = _qkv(2, 24, 4, 2, d, seed=d)
    sl = np.asarray([24, 11], np.int32)
    calls = (plain_calls(_streaming, "streaming_prefill_attention_kernel")
             if min_s == 0
             else plain_calls(_prefill, "prefill_attention_kernel"))
    got = attention.prefill_attention(_t(q), _t(k), _t(v), _t(sl))
    assert len(calls) == 1
    want = jax_attn.prefill_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), jnp.asarray(sl))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_packed_prefill_head_dim_routes_to_plain(plain_calls):
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((12, h, 96)).astype(np.float32)
               for h in (4, 2, 2))
    seg = np.asarray([0] * 5 + [1] * 6 + [-1], np.int32)
    calls = plain_calls(attention._packed, "packed_prefill_attention_kernel")
    got = attention.packed_prefill_attention(_t(q), _t(k), _t(v), _t(seg))
    assert len(calls) == 1
    want = jax_attn.packed_prefill_attention(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v), jnp.asarray(seg))
    np.testing.assert_allclose(got.numpy()[:11], np.asarray(want)[:11],
                               **F32_TOL)


def _decode_inputs(d, hq, hkv, seed, s=64):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, hq, d)).astype(np.float32)
    kn = rng.standard_normal((2, hkv, d)).astype(np.float32)
    vn = rng.standard_normal((2, hkv, d)).astype(np.float32)
    kc = rng.standard_normal((2, 2, hkv, s, d)).astype(np.float32)
    vc = rng.standard_normal((2, 2, hkv, s, d)).astype(np.float32)
    return q, kn, vn, kc, vc, np.asarray([9, s - 1], np.int32)


def _jax_decode(mode, q, kn, vn, kc, vc, pos, dtype=jnp.float32):
    old = dict(JAX_KERNELS)
    JAX_KERNELS["decode_attn_mode"] = mode
    try:
        jcache = jax_attn.KVCache(jnp.asarray(kc, dtype),
                                  jnp.asarray(vc, dtype), jnp.ones(2))
        return jax_attn.fused_decode_attention_at(
            jnp.asarray(q, dtype), jnp.asarray(kn, dtype),
            jnp.asarray(vn, dtype), jcache, 1, jnp.asarray(pos))
    finally:
        JAX_KERNELS.clear()
        JAX_KERNELS.update(old)


@pytest.mark.parametrize("d", [80, 96, 256])
@pytest.mark.parametrize("mode,wrapper", [
    ("auto", "dma_decode_attention"),
    ("fused", "fused_decode_attention"),
    ("split", "decode_attention_kernel"),
])
def test_decode_head_dims_route_to_plain(monkeypatch, plain_calls, d, mode,
                                         wrapper):
    monkeypatch.setitem(KERNELS, "decode_attn_mode", mode)
    q, kn, vn, kc, vc, pos = _decode_inputs(d, 4, 2, seed=d)
    cache = attention.KVCache(_t(kc), _t(vc), torch.ones(2))
    calls = plain_calls(_decode, wrapper)
    got, cache = attention.fused_decode_attention_at(
        _t(q), _t(kn), _t(vn), cache, 1, _t(pos))
    assert len(calls) == 1
    want, jcache = _jax_decode(mode, q, kn, vn, kc, vc, pos)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    np.testing.assert_array_equal(cache.k.numpy(), np.asarray(jcache.k))
    np.testing.assert_array_equal(cache.v.numpy(), np.asarray(jcache.v))


@pytest.mark.parametrize("d", [80, 96, 256])
def test_paged_decode_head_dims_route_to_plain(plain_calls, d):
    rng = np.random.default_rng(30 + d)
    n_l, nb, hkv, bs = 2, 9, 2, 8
    pk = rng.standard_normal((n_l, nb, hkv, bs, d)).astype(np.float32)
    pv = rng.standard_normal((n_l, nb, hkv, bs, d)).astype(np.float32)
    tables = np.asarray([[3, 0, 5], [7, 1, 2]], np.int32)
    positions = np.asarray([13, 20], np.int32)
    q = rng.standard_normal((2, 4, d)).astype(np.float32)
    k = rng.standard_normal((2, hkv, d)).astype(np.float32)
    v = rng.standard_normal((2, hkv, d)).astype(np.float32)
    cache = paged.PagedKVCache(_t(pk), _t(pv), _t(tables), torch.ones(n_l))
    jcache = jax_paged.PagedKVCache(jnp.asarray(pk), jnp.asarray(pv),
                                    jnp.asarray(tables), jnp.ones(n_l))
    calls = plain_calls(_paged, "paged_decode_attention")
    got, cache = paged.paged_fused_decode_attention_at(
        _t(q), _t(k), _t(v), cache, 1, _t(positions))
    assert len(calls) == 1
    want, jcache = jax_paged.paged_fused_decode_attention_at(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jcache, 1,
        jnp.asarray(positions))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    np.testing.assert_array_equal(cache.pool_k.numpy()[:, :-1],
                                  np.asarray(jcache.pool_k)[:, :-1])


def test_float16_lies_inside_every_envelope_and_matches_jax(monkeypatch):
    q, k, v = _qkv(2, 32, 4, 2, 64, seed=40)
    sl = np.asarray([32, 19], np.int32)
    th = [_t(a).half() for a in (q, k, v)]
    want = jax_attn.prefill_attention(
        *[jnp.asarray(a, jnp.float16) for a in (q, k, v)], jnp.asarray(sl))
    for min_s in (2048, 0):
        monkeypatch.setitem(KERNELS, "prefill_streaming_min_s", min_s)
        got = attention.prefill_attention(*th, _t(sl))
        assert got.dtype == torch.float16
        _close_f16(got, want)

    dq, kn, vn, kc, vc, pos = _decode_inputs(64, 8, 2, seed=41)
    for mode in ("auto", "fused"):
        monkeypatch.setitem(KERNELS, "decode_attn_mode", mode)
        cache = attention.KVCache(_t(kc).half(), _t(vc).half(), torch.ones(2))
        got, cache = attention.fused_decode_attention_at(
            _t(dq).half(), _t(kn).half(), _t(vn).half(), cache, 1, _t(pos))
        want_d, jcache = _jax_decode(mode, dq, kn, vn, kc, vc, pos,
                                     jnp.float16)
        _close_f16(got, want_d)
        np.testing.assert_array_equal(cache.k.float().numpy(),
                                      np.asarray(jcache.k, np.float32))

    rng = np.random.default_rng(42)
    x = rng.standard_normal((3, 64)).astype(np.float32)
    w = rng.standard_normal((2, 64, 48)).astype(np.float32) * 0.1
    wq = quantize_weight_only(_t(w), 8, 0)
    got = linear.dense(_t(x).half(), wq, layer=1)
    want_w = _t(x).float() @ wq.dequantize()[1]
    assert got.dtype == torch.float16
    _close_f16(got, want_w.numpy())
    got = linear.dense(_t(x).half(), _t(w).half(), torch.float32, layer=0)
    want_p = jnp.dot(jnp.asarray(x, jnp.float16), jnp.asarray(w[0],
                     jnp.float16), preferred_element_type=jnp.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want_p), rtol=1e-5,
                               atol=1e-5)


def test_woq_dense_with_ragged_n_routes_to_plain(plain_calls):
    rng = np.random.default_rng(50)
    x = _t(rng.standard_normal((2, 64)).astype(np.float32))
    w = _t(rng.standard_normal((3, 64, 40)).astype(np.float32) * 0.1)
    wq = quantize_weight_only(w, 8, 0)
    calls = plain_calls(_woq, "woq_matmul_stacked")
    got = linear.dense(x, wq, layer=2)
    assert len(calls) == 1
    np.testing.assert_allclose(got.numpy(), (x @ wq.dequantize()[2]).numpy(),
                               **F32_TOL)
    calls_2d = plain_calls(_woq, "woq_matmul")
    head = quantize_weight_only(w[0], 8, 0)
    got = linear.dense(x, head, torch.float32)
    assert len(calls_2d) == 1
    np.testing.assert_allclose(got.numpy(), (x @ head.dequantize()).numpy(),
                               **F32_TOL)


@pytest.mark.parametrize("kv_int8", [False, True])
def test_fused_plain_at_group_71_matches_jax_fused_mode(kv_int8):
    """Falcon-7B's multi-query attention: 71 query heads on one KV head at
    D=64 (the shape row 9 now splits over 9 blocks of up to 8 heads)."""
    rng = np.random.default_rng(60 + kv_int8)
    hq, hkv, d, s = 71, 1, 64, 128
    q = rng.standard_normal((1, hq, d)).astype(np.float32)
    kn = rng.standard_normal((1, hkv, d)).astype(np.float32)
    vn = rng.standard_normal((1, hkv, d)).astype(np.float32)
    if kv_int8:
        kc = rng.integers(-127, 128, (2, 1, hkv, s, d)).astype(np.int8)
        vc = rng.integers(-127, 128, (2, 1, hkv, s, d)).astype(np.int8)
        scale = np.asarray([0.05, 0.02], np.float32)
    else:
        kc = rng.standard_normal((2, 1, hkv, s, d)).astype(np.float32)
        vc = rng.standard_normal((2, 1, hkv, s, d)).astype(np.float32)
        scale = np.ones(2, np.float32)
    pos = np.asarray([100], np.int32)
    tk, tv = _t(kc), _t(vc)
    got = _decode.fused_decode_attention(
        _t(q), _t(kn), _t(vn), tk, tv, 1, _t(pos), kv_scale=_t(scale))
    old = dict(JAX_KERNELS)
    JAX_KERNELS["decode_attn_mode"] = "fused"
    try:
        want, jcache = jax_attn.fused_decode_attention_at(
            jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
            jax_attn.KVCache(jnp.asarray(kc), jnp.asarray(vc),
                             jnp.asarray(scale)), 1, jnp.asarray(pos))
    finally:
        JAX_KERNELS.clear()
        JAX_KERNELS.update(old)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jcache.k))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jcache.v))


@pytest.mark.parametrize("mode", [QuantMode(0), QuantMode.INT8_KV_CACHE])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_unquantized_random_params_build(mode, dtype):
    cfg = ModelConfig.tiny(dtype=dtype, quant_mode=mode)
    params = init_random_quantized_params(cfg, seed=0, device="cpu")
    lw = params["layers"]
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        w = lw[name]
        assert isinstance(w, torch.Tensor) and w.dtype == cfg.torch_dtype
        std = w.float().std().item() * w.shape[-2] ** 0.5
        assert 0.9 < std < 1.1, (name, std)     # normal * fan_in ** -0.5
    again = init_random_quantized_params(cfg, seed=0, device="cpu")
    assert torch.equal(again["layers"]["wq"], lw["wq"])
