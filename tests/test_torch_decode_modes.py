"""Rows 8 and 9 of the PyTorch port (the read-only and the one-launch fused
decode kernels, plain versions) and the `decode_attn_mode` dispatch of
`ops.attention`, against the JAX package: its Pallas `decode_attention_kernel`
and `fused_decode_attention` in interpret mode, and its GenerationSession.

Tolerances: f32 caches agree to rtol/atol 1e-5 (summation order only), and
so do int8 caches read-only (both sides dequantize code * scale in f32).
Writing into an int8 cache, the port encodes with a true division (as the
JAX package's _quant_kv) and the Pallas fused kernel multiplies by 1/scale:
a code may differ by one, and the output then by 1e-3, as in
tests/test_torch_int8kv.py. Float caches are written bit for bit. Greedy
tokens are identical in every mode.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from trtllm_llama_tpu.config import EngineConfig as JaxEngineConfig
from trtllm_llama_tpu.config import ModelConfig as JaxConfig
from trtllm_llama_tpu.models import llama as jax_llama
from trtllm_llama_tpu.ops.pallas.attention import (
    decode_attention_kernel as jax_decode_kernel,
)
from trtllm_llama_tpu.ops.pallas.attention import (
    fused_decode_attention as jax_fused_decode,
)
from trtllm_llama_tpu.quantization.mode import QuantMode as JaxQuantMode
from trtllm_llama_tpu.quantization.quantize import quantize_params
from trtllm_llama_tpu.runtime.sampling import SamplingConfig as JaxSampling
from trtllm_llama_tpu.runtime.session import GenerationSession as JaxSession
from trtllm_llama_tpu_torch.config import EngineConfig, ModelConfig
from trtllm_llama_tpu_torch.convert.bridge import params_from_numpy
from trtllm_llama_tpu_torch.ops import attention
from trtllm_llama_tpu_torch.ops.kernels import decode_attention as _decode
from trtllm_llama_tpu_torch.ops.registry import KERNELS
from trtllm_llama_tpu_torch.quantization.mode import QuantMode
from trtllm_llama_tpu_torch.runtime.sampling import SamplingConfig
from trtllm_llama_tpu_torch.runtime.session import GenerationSession

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
INT8_WRITE_TOL = dict(rtol=1e-3, atol=1e-3)
HEADS = [(4, 4), (8, 2)]       # MHA and a GQA group of 4
SCALES = np.asarray([0.05, 0.021], np.float32)
MODES = ("auto", "dma", "xla", "split", "fused")


def _t(a):
    return torch.from_numpy(np.array(a))


def _cache_inputs(hq, hkv, s, kv_int8, seed):
    rng = np.random.default_rng(seed)
    n_layers, b, d = 2, 2, 128
    if kv_int8:
        kc = rng.integers(-127, 128, (n_layers, b, hkv, s, d)).astype(np.int8)
        vc = rng.integers(-127, 128, (n_layers, b, hkv, s, d)).astype(np.int8)
        scale = SCALES
    else:
        kc = rng.standard_normal((n_layers, b, hkv, s, d)).astype(np.float32)
        vc = rng.standard_normal((n_layers, b, hkv, s, d)).astype(np.float32)
        scale = np.ones((n_layers,), np.float32)
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    # new K/V up to 4x the int8 range, so the clamp is exercised
    kn = (rng.standard_normal((b, hkv, d)) * 4).astype(np.float32)
    vn = (rng.standard_normal((b, hkv, d)) * 4).astype(np.float32)
    return q, kn, vn, kc, vc, scale


@pytest.mark.parametrize("lens", [(10, 37), (0, 64), (64, 1), (100, 3),
                                  (-3, 65), (-1, 200)])
@pytest.mark.parametrize("kv_int8", [False, True])
@pytest.mark.parametrize("hq,hkv", HEADS)
def test_read_only_decode_matches_jax_kernel(hq, hkv, kv_int8, lens):
    """Row 8: rows < cache_lens; a length of 0 or below averages V over all
    rows, a length of S or past it attends them all."""
    q, _, _, kc, vc, scale = _cache_inputs(hq, hkv, 64, kv_int8, seed=1)
    sl = np.asarray(lens, np.int32)
    for layer in (0, 1):
        want = jax_decode_kernel(jnp.asarray(q), jnp.asarray(kc),
                                 jnp.asarray(vc), jnp.asarray(scale), layer,
                                 jnp.asarray(sl), interpret=True)
        got = _decode.decode_attention_kernel(_t(q), _t(kc), _t(vc), layer,
                                              _t(sl), kv_scale=_t(scale))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        via_op = attention.decode_attention_at(
            _t(q), attention.KVCache(_t(kc), _t(vc), _t(scale)), layer,
            _t(sl))
        np.testing.assert_array_equal(via_op.numpy(), got.numpy())
    if lens[0] <= 0:
        dec = vc[1, 0].astype(np.float32) * (scale[1] if kv_int8 else 1.0)
        mean_v = np.repeat(dec.mean(1), hq // hkv, axis=0)      # [Hq, D]
        np.testing.assert_allclose(got.numpy()[0], mean_v, **TOL)


@pytest.mark.parametrize("s", [64, 96])
@pytest.mark.parametrize("kv_int8", [False, True])
@pytest.mark.parametrize("hq,hkv", HEADS)
def test_fused_decode_matches_jax_kernel(hq, hkv, kv_int8, s):
    """Row 9: the write at pos (0 and the last row) and the attention over
    rows <= pos; only row pos of the layer moves."""
    q, kn, vn, kc, vc, scale = _cache_inputs(hq, hkv, s, kv_int8, seed=2)
    layer, pos = 1, np.asarray([0, s - 1], np.int32)
    want, want_k, want_v = jax_fused_decode(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(kc),
        jnp.asarray(vc), jnp.asarray(scale), layer, jnp.asarray(pos),
        interpret=True)
    tk, tv = _t(kc), _t(vc)
    got = _decode.fused_decode_attention(_t(q), _t(kn), _t(vn), tk, tv, layer,
                                         _t(pos), kv_scale=_t(scale))
    rows = np.zeros(kc.shape[:2] + kc.shape[3:4], bool)    # [L, B, S]
    rows[layer, np.arange(2), pos] = True
    for mine, theirs, before in ((tk, want_k, kc), (tv, want_v, vc)):
        mine, theirs = mine.numpy(), np.asarray(theirs)
        moved = (mine != before).any(-1).any(2)
        assert not (moved & ~rows).any()                  # only row pos
        if kv_int8:
            diff = np.abs(mine.astype(np.int32) - theirs.astype(np.int32))
            assert diff.max() <= 1
        else:
            np.testing.assert_array_equal(mine, theirs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **(INT8_WRITE_TOL if kv_int8 else TOL))


@pytest.mark.parametrize("kv_int8", [False, True])
def test_fused_decode_drops_a_write_past_the_cache(kv_int8):
    """pos >= S writes nothing and attends all S rows (kernel 3's rule):
    the same output as the read-only kernel over S rows."""
    q, kn, vn, kc, vc, scale = _cache_inputs(8, 2, 64, kv_int8, seed=3)
    pos = np.asarray([64, 70], np.int32)
    tk, tv = _t(kc), _t(vc)
    got = _decode.fused_decode_attention(_t(q), _t(kn), _t(vn), tk, tv, 0,
                                         _t(pos), kv_scale=_t(scale))
    np.testing.assert_array_equal(tk.numpy(), kc)
    np.testing.assert_array_equal(tv.numpy(), vc)
    want = _decode.decode_attention_kernel(_t(q), tk, tv, 0, _t(pos),
                                           kv_scale=_t(scale))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def _recording(monkeypatch):
    calls = []

    def write_attend(name):
        def fn(q, k_new, v_new, k_cache, v_cache, layer, positions,
               sm_scale=None, kv_scale=None):
            calls.append((name, positions.tolist()))
            return torch.zeros_like(q)
        return fn

    def read_only(q, k_cache, v_cache, layer, cache_lens, sm_scale=None,
                  kv_scale=None):
        # the plain write came first: row pos holds the new token
        calls.append(("read_only", cache_lens.tolist(),
                      float(k_cache[layer, 0, 0, cache_lens[0] - 1, 0])))
        return torch.zeros_like(q)
    monkeypatch.setattr(_decode, "dma_decode_attention",
                        write_attend("kernel3"))
    monkeypatch.setattr(_decode, "fused_decode_attention",
                        write_attend("fused"))
    monkeypatch.setattr(_decode, "decode_attention_kernel", read_only)
    return calls


@pytest.mark.parametrize("mode,want", [
    ("auto", "kernel3"), ("dma", "kernel3"), ("xla", "kernel3"),
    ("fused", "fused"), ("split", "read_only"),
])
def test_decode_dispatch_by_mode(monkeypatch, mode, want):
    calls = _recording(monkeypatch)
    monkeypatch.setitem(KERNELS, "decode_attn_mode", mode)
    cache = attention.KVCache(torch.zeros((2, 1, 2, 32, 32)),
                              torch.zeros((2, 1, 2, 32, 32)), torch.ones(2))
    q, new = torch.ones((1, 4, 32)), torch.full((1, 2, 32), 7.0)
    pos = torch.tensor([5], dtype=torch.int32)
    _, out_cache = attention.fused_decode_attention_at(q, new, new, cache, 1,
                                                       pos)
    assert out_cache is cache or out_cache.k is cache.k
    if want == "read_only":
        assert calls == [("read_only", [6], 7.0)]
    else:
        assert calls == [(want, [5])]
        assert not cache.k.any()                # the kernel writes, not the op


def test_unknown_decode_mode_raises(monkeypatch):
    monkeypatch.setitem(KERNELS, "decode_attn_mode", "paged")
    cache = attention.KVCache(torch.zeros((1, 1, 2, 32, 32)),
                              torch.zeros((1, 1, 2, 32, 32)), torch.ones(1))
    q, new = torch.ones((1, 4, 32)), torch.ones((1, 2, 32))
    with pytest.raises(ValueError):
        attention.fused_decode_attention_at(
            q, new, new, cache, 0, torch.tensor([3], dtype=torch.int32))


def test_read_only_entry_goes_to_row_8_in_every_mode(monkeypatch):
    calls = _recording(monkeypatch)
    cache = attention.KVCache(torch.ones((1, 1, 2, 32, 32)),
                              torch.ones((1, 1, 2, 32, 32)), torch.ones(1))
    for mode in MODES:
        monkeypatch.setitem(KERNELS, "decode_attn_mode", mode)
        attention.decode_attention_at(torch.ones((1, 4, 32)), cache, 0,
                                      torch.tensor([9], dtype=torch.int32))
    assert calls == [("read_only", [9], 1.0)] * len(MODES)


@pytest.mark.parametrize("kv_int8", [False, True])
def test_greedy_tokens_identical_in_every_mode_and_match_jax(monkeypatch,
                                                             kv_int8):
    """Tiny f32 LLaMA with int8 weight-only projections, a ragged batch:
    the port's GenerationSession gives the same greedy tokens in every
    decode_attn_mode, equal to the JAX session's in its default mode."""
    jmode = JaxQuantMode.use_weight_only(False)
    if kv_int8:
        jmode = jmode | JaxQuantMode.INT8_KV_CACHE
    jcfg = JaxConfig.tiny(dtype="float32", quant_mode=jmode)
    cfg = ModelConfig.tiny(dtype="float32", quant_mode=QuantMode(int(jmode)))
    jparams = quantize_params(jax_llama.init_params(jcfg,
                                                    jax.random.PRNGKey(0)),
                              JaxQuantMode.use_weight_only(False))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               "cpu")
    scales = np.full((cfg.num_layers,), 0.05, np.float32) if kv_int8 else None
    ecfg = dict(max_batch_size=2, max_input_len=32, max_seq_len=64)
    prompts = [[5, 17, 99, 3, 250, 8, 41, 77, 12, 9, 31], [200, 4, 66, 18, 7]]
    new = 12
    want = JaxSession(jcfg, jparams, JaxEngineConfig(**ecfg),
                      kv_scales=scales).generate(
        prompts, sampling=JaxSampling(end_id=-1), max_new_tokens=new)
    sess = GenerationSession(cfg, params, EngineConfig(**ecfg),
                             kv_scales=scales, device="cpu")
    for mode in MODES:
        monkeypatch.setitem(KERNELS, "decode_attn_mode", mode)
        got = sess.generate(prompts, sampling=SamplingConfig(end_id=-1),
                            max_new_tokens=new)
        np.testing.assert_array_equal(got.output_ids,
                                      np.asarray(want.output_ids), mode)
