"""The PyTorch port's fp8 (e4m3) KV cache -- bench.py's `fp8kv`, fp8
projections and lm_head with an e4m3 cache at scale 0.05 -- against the
JAX package on the CPU: the codec (_quant_kv / _dequant_kv, and the sweep
that the card's codec probe is held to), the dense prefill, decode and
packed writes, the paged pool's writes and reads, decode attention in
every decode_attn_mode (the kernels' plain versions), the tiny model
through GenerationSession and ServingEngine, one decoder family (Bloom:
the plain ALiBi branch), random fp8kv weights, and the wrappers' refusal of
a quantized cache without its scales.

Tolerances: cache codes are bit-identical to the JAX package's (the same
true division in f32, the same round-to-nearest-even e4m3 codec), and so
are the dequantized values in f32 and bf16. Attention agrees with the JAX
XLA path (where the JAX package runs every fp8 cache) to 1e-5 in f32, where
its K/V rounded to q's dtype equal the port's f32 ones. Codes the two
packages compute from values of another summation order (a model's later
layers) may differ by one e4m3 step (1/8 of the value: the tiny f32
model's prefill flips one V code of 2048 in its second layer). So the tiny
f32 model's prefill logits agree within 1e-4 of the largest logit (f32
summation order through two layers; the cache is written, not read), its
decode logits within 2e-3 (such a flip moved them by 4.9e-4), and its
greedy tokens are identical; in bf16 the logits agree within 3% of the
largest (bf16 roundings in other places).
"""

import re

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from hypothesis import given, settings, strategies as st

from trtllm_llama_tpu.config import EngineConfig as JaxEngineConfig
from trtllm_llama_tpu.config import ModelConfig as JaxConfig
from trtllm_llama_tpu.models import decoder as jax_decoder
from trtllm_llama_tpu.models import llama as jax_llama
from trtllm_llama_tpu.ops import attention as jax_attn
from trtllm_llama_tpu.ops import fp8 as jax_fp8
from trtllm_llama_tpu.ops import paged_attention as jax_paged
from trtllm_llama_tpu.quantization.mode import QuantMode as JaxQuantMode
from trtllm_llama_tpu.quantization.quantize import (
    quantize_params as jax_quantize_params,
)
from trtllm_llama_tpu.runtime.sampling import SamplingConfig as JaxSampling
from trtllm_llama_tpu.runtime.serving import ServingEngine as JaxEngine
from trtllm_llama_tpu.runtime.session import GenerationSession as JaxSession
from trtllm_llama_tpu_torch.config import EngineConfig, ModelConfig
from trtllm_llama_tpu_torch.convert.bridge import params_from_numpy
from trtllm_llama_tpu_torch.models import decoder, llama
from trtllm_llama_tpu_torch.ops import attention, paged_attention as paged
from trtllm_llama_tpu_torch.ops.fp8 import fp8_decode
from trtllm_llama_tpu_torch.ops.kernels import decode_attention as da
from trtllm_llama_tpu_torch.ops.kernels import paged_decode_attention as pda
from trtllm_llama_tpu_torch.ops.kernels import probes as pr
from trtllm_llama_tpu_torch.ops.registry import KERNELS
from trtllm_llama_tpu_torch.quantization.mode import QuantMode
from trtllm_llama_tpu_torch.quantization.quantize import (
    init_random_quantized_params,
)
from trtllm_llama_tpu_torch.quantization.tensors import FP8Weight
from trtllm_llama_tpu_torch.runtime.sampling import SamplingConfig
from trtllm_llama_tpu_torch.runtime.serving import ServingEngine
from trtllm_llama_tpu_torch.runtime.session import GenerationSession

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
LOGITS_REL = 1e-4
F32_DECODE_REL = 2e-3        # decode over codes one step apart: see above
BF16_LOGITS_REL = 3e-2
SCALES = np.asarray([0.05, 0.021], np.float32)
KV_SCALE = 0.05                  # bench.py's fp8kv scale, every layer
FP8KV = JaxQuantMode.FP8_QDQ | JaxQuantMode.FP8_KV_CACHE
MODES = ("auto", "dma", "xla", "split", "fused")
ECFG = dict(max_batch_size=2, max_input_len=32, max_seq_len=64)
PROMPTS = [[5, 17, 99, 3, 250, 8, 41, 77, 12, 9, 31], [200, 4, 66, 18, 7]]


def _t(a):
    return torch.from_numpy(np.array(a))


def _codes(rng, shape):
    """Random e4m3 codes, the NaN codes moved to their finite neighbour."""
    c = rng.integers(0, 256, shape).astype(np.uint8)
    return np.where((c & 0x7F) == 0x7F, c - 1, c).astype(np.uint8)


def _values(rng, shape, amp=30.0):
    """New K/V rows: normal draws up to ~4 x 448 x 0.05, so encodes at the
    scales 0.05 / 0.021 saturate, and halfway cases planted."""
    x = (rng.standard_normal(shape) * amp).astype(np.float32)
    flat = x.reshape(-1)
    flat[:4] = [0.05 * 1.0625, -0.05 * 0.0029296875, 448 * 0.05 * 1.01, 0.0]
    return x


def _assert_codes_near(got, want):
    """Codes one e4m3 step apart at most (their values within 1/8 of the
    larger, or both below the smallest normal)."""
    a = fp8_decode(torch.from_numpy(np.array(got))).numpy()
    b = fp8_decode(torch.from_numpy(np.array(want))).numpy()
    assert (np.abs(a - b) <= 0.125 * np.maximum(np.abs(a), np.abs(b))
            + 2.0 ** -6).all()


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,jdtype", [(torch.float32, jnp.float32),
                                          (torch.bfloat16, jnp.bfloat16)])
def test_kv_codec_matches_jax(dtype, jdtype):
    x = _values(np.random.default_rng(1), (2, 3, 7, 32))
    xj = jnp.asarray(x).astype(jdtype)
    xt = _t(np.asarray(xj.astype(jnp.float32))).to(dtype)
    for scale in SCALES:
        jcache = jax_attn.make_kv_cache(1, 1, 1, 1, jnp.uint8, scale)
        want = jax_attn._quant_kv(xj, jcache)
        got = attention._quant_kv(xt, torch.uint8, torch.tensor(scale))
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        back = attention._dequant_kv(got, torch.tensor(scale), dtype)
        want_back = jax_attn._dequant_kv(want, jcache, jdtype)
        np.testing.assert_array_equal(back.float().numpy(),
                                      np.asarray(want_back, np.float32))


@pytest.mark.parametrize("scale", [1.0, 0.05])
def test_kv_codec_probe_plain_matches_jax_codec(scale):
    """The codec probe's sweep (every e4m3 value and midpoint with their
    f32 neighbours, +-448 and past it, subnormals, f32 denormals, +-0):
    its plain version, which the card's probe is held to bit for bit, is
    the JAX package's fp8_encode(x / scale) and fp8_decode."""
    x = pr.kv_codec_inputs()
    s = torch.tensor([scale])
    codes, dec, raw = pr.probe_kv_codec(x, s)          # CPU: the plain one
    want = jax_fp8.fp8_encode(jnp.asarray(x.numpy()) / jnp.float32(scale))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want))
    values = np.asarray(jax_fp8.fp8_decode(jnp.arange(256, dtype=jnp.uint8)))
    np.testing.assert_array_equal(dec.numpy(), values * np.float32(scale))
    np.testing.assert_array_equal(raw.numpy(), np.stack([values, values]))
    assert (x == 0).any() and (torch.signbit(x) & (x == 0)).any()   # -0


# ---------------------------------------------------------------------------
# the dense cache: writes and decode attention
# ---------------------------------------------------------------------------

def test_fp8_cache_writes_match_jax():
    """The prefill write, the decode write (a position past S_max drops, as
    the JAX scatter does) and the packed write, bit for bit."""
    rng = np.random.default_rng(2)
    n_layers, b, hkv, s, d = 2, 2, 2, 16, 8
    kc = _codes(rng, (n_layers, b, hkv, s, d))
    k, v = _values(rng, (b, 5, hkv, d)), _values(rng, (b, 5, hkv, d))
    kn = _values(rng, (b, hkv, d))
    pos = np.asarray([7, s], np.int32)
    jcache = jax_attn.KVCache(jnp.asarray(kc), jnp.asarray(kc),
                              jnp.asarray(SCALES))
    jcache = jax_attn.write_kv_prefill_at(jcache, 1, jnp.asarray(k),
                                          jnp.asarray(v))
    jcache = jax_attn.write_kv_decode_at(jcache, 0, jnp.asarray(kn),
                                         jnp.asarray(-kn), jnp.asarray(pos))
    cache = attention.KVCache(_t(kc), _t(kc), _t(SCALES))
    cache = attention.write_kv_prefill_at(cache, 1, _t(k), _t(v))
    cache = attention.write_kv_decode_at(cache, 0, _t(kn), _t(-kn), _t(pos))
    assert cache.k.dtype == torch.uint8
    np.testing.assert_array_equal(cache.k.numpy(), np.asarray(jcache.k))
    np.testing.assert_array_equal(cache.v.numpy(), np.asarray(jcache.v))

    t, lens, slots, trash = 24, [5, 1, 9], [2, 0, 1], 3
    kc = np.zeros((n_layers, 4, hkv, 32, d), np.uint8)
    slot_tok = np.full((t,), trash, np.int32)
    pos_tok = np.zeros((t,), np.int32)
    off = 0
    for n, slot in zip(lens, slots):
        slot_tok[off:off + n] = slot
        pos_tok[off:off + n] = np.arange(n)
        off += n
    k, v = _values(rng, (t, hkv, d)), _values(rng, (t, hkv, d))
    cache = attention.KVCache(_t(kc), _t(kc), _t(SCALES))
    attention.write_kv_packed_at(cache, 1, _t(k), _t(v), _t(slot_tok),
                                 _t(pos_tok))
    jcache = jax_attn.write_kv_packed_at(
        jax_attn.KVCache(jnp.asarray(kc), jnp.asarray(kc),
                         jnp.asarray(SCALES)), 1, jnp.asarray(k),
        jnp.asarray(v), jnp.asarray(slot_tok), jnp.asarray(pos_tok))
    for got, want in ((cache.k, jcache.k), (cache.v, jcache.v)):
        np.testing.assert_array_equal(got.numpy()[:, :trash],
                                      np.asarray(want)[:, :trash])


def _decode_inputs(hq, hkv, s, seed):
    rng = np.random.default_rng(seed)
    n_layers, b, d = 2, 2, 32
    kc = _codes(rng, (n_layers, b, hkv, s, d))
    vc = _codes(rng, (n_layers, b, hkv, s, d))
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    kn, vn = _values(rng, (b, hkv, d)), _values(rng, (b, hkv, d))
    return q, kn, vn, kc, vc, np.asarray([5, s - 1], np.int32)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
def test_fp8_decode_matches_jax_in_every_mode(monkeypatch, mode, hq, hkv):
    """fused_decode_attention_at over an fp8 cache in each decode_attn_mode
    (kernel 3's, row 9's or the plain write and row 8's plain versions)
    against the JAX package, which runs every fp8 cache on its XLA path;
    then the read-only entries (decode_attention_at: row 8; the plain
    decode_attention) over the written cache."""
    monkeypatch.setitem(KERNELS, "decode_attn_mode", mode)
    q, kn, vn, kc, vc, pos = _decode_inputs(hq, hkv, 64, seed=3)
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
        lens = jnp.asarray(pos + 1)
        want_ro = jax_attn.decode_attention_at(jnp.asarray(q), jcache, layer,
                                               lens)
        got_ro = attention.decode_attention_at(_t(q), cache, layer,
                                               _t(pos + 1))
        np.testing.assert_allclose(got_ro.numpy(), np.asarray(want_ro), **TOL)
        got_plain = attention.decode_attention(
            _t(q), cache.k[layer], cache.v[layer], _t(pos + 1),
            kv_scale=cache.scale[layer])
        np.testing.assert_allclose(got_plain.numpy(), np.asarray(want_ro),
                                   **TOL)


# ---------------------------------------------------------------------------
# the paged pool
# ---------------------------------------------------------------------------

def _pools(rng, nb=9, hkv=2, bs=8, d=32):
    shape = (2, nb, hkv, bs, d)
    return _codes(rng, shape), _codes(rng, shape)


def _caches(pk, pv, tables):
    return (paged.PagedKVCache(_t(pk), _t(pv), _t(tables), _t(SCALES)),
            jax_paged.PagedKVCache(jnp.asarray(pk), jnp.asarray(pv),
                                   jnp.asarray(tables), jnp.asarray(SCALES)))


def _assert_pools_equal(cache, jcache, skip_trash=True):
    n = cache.pool_k.shape[1] - (1 if skip_trash else 0)
    for got, want in ((cache.pool_k, jcache.pool_k),
                      (cache.pool_v, jcache.pool_v)):
        np.testing.assert_array_equal(got.numpy()[:, :n],
                                      np.asarray(want)[:, :n])


def test_fp8_paged_writes_match_jax():
    """The prefill write (-1 entries and the tail go to the trash block,
    which several writes share) and the decode write (mid-block, into a -1
    entry, past the table, the table's last row: the trash block takes the
    two redirected rows, nothing else moves), bit for bit."""
    rng = np.random.default_rng(4)
    pk, pv = _pools(rng)
    tables = np.asarray([[3, 0, 5], [7, 1, -1], [-1, -1, -1]], np.int32)
    k, v = _values(rng, (3, 19, 2, 32)), _values(rng, (3, 19, 2, 32))
    cache, jcache = _caches(pk, pv, tables)
    cache = paged.paged_write_prefill_at(cache, 1, _t(k), _t(v))
    jcache = jax_paged.paged_write_prefill_at(jcache, 1, jnp.asarray(k),
                                              jnp.asarray(v))
    _assert_pools_equal(cache, jcache)

    mb, bs = 3, 8
    tables = np.asarray([[3, 0, 5], [7, 1, -1], [2, 4, 6], [6, 2, 4]],
                        np.int32)
    positions = np.asarray([10, 17, mb * bs, mb * bs - 1], np.int32)
    k, v = _values(rng, (4, 2, 32)), _values(rng, (4, 2, 32))
    cache, jcache = _caches(pk, pv, tables)
    cache = paged.paged_write_decode_at(cache, 0, _t(k), _t(v), _t(positions))
    jcache = jax_paged.paged_write_decode_at(jcache, 0, jnp.asarray(k),
                                             jnp.asarray(v),
                                             jnp.asarray(positions))
    _assert_pools_equal(cache, jcache)
    trash = cache.pool_k.shape[1] - 1
    moved = (cache.pool_k.numpy() != pk).any(axis=(2, 4))     # [L, NB, BS]
    assert moved[0, trash, [17 % bs, 0]].all()
    assert moved.sum() <= 4 and not moved[1].any()


@pytest.mark.parametrize("bs", [8, 24])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
def test_fp8_paged_reads_match_jax(bs, hq, hkv):
    """The plain read-only paged attention, and kernel 14's plain version
    (write, then attend positions + 1 rows; a position at MB * BS writes
    the trash block) against the JAX XLA path, in f32, with the pools
    bit for bit after the write. No -1 entries among the attended blocks:
    the XLA read maps them to block 0, kernel 14 to the trash block."""
    rng = np.random.default_rng(10 + hq + bs)
    pk, pv = _pools(rng, hkv=hkv, bs=bs)
    mb = 3
    tables = np.asarray([[3, 0, 5], [7, 1, -1], [2, 4, 6]], np.int32)
    q = rng.standard_normal((3, hq, 32)).astype(np.float32)
    lens = np.asarray([2 * bs + 1, 9, 3 * bs], np.int32)
    cache, jcache = _caches(pk, pv, tables)
    got = paged.paged_decode_attention_at(_t(q), cache, 1, _t(lens))
    want = jax_paged.paged_decode_attention_at(jnp.asarray(q), jcache, 1,
                                               jnp.asarray(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    positions = np.asarray([13, 4, mb * bs], np.int32)
    k, v = _values(rng, (3, hkv, 32)), _values(rng, (3, hkv, 32))
    got, cache = paged.paged_fused_decode_attention_at(
        _t(q), _t(k), _t(v), cache, 1, _t(positions))
    want, jcache = jax_paged.paged_fused_decode_attention_at(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jcache, 1,
        jnp.asarray(positions))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _assert_pools_equal(cache, jcache, skip_trash=False)


def test_init_caches_fp8_with_scales():
    cfg = ModelConfig.tiny(quant_mode=QuantMode.FP8_KV_CACHE)
    jcfg = JaxConfig.tiny(quant_mode=JaxQuantMode.FP8_KV_CACHE)
    pools = paged.init_paged_caches(cfg, 4, 8, 2, 2, "cpu", SCALES)
    jpools = jax_paged.init_paged_caches(jcfg, 4, 8, 2, 2, SCALES)
    for got, want in zip(pools, jpools):
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert pools.pool_k.dtype == torch.uint8
    dense = llama.init_caches(cfg, 2, 130, "cpu", SCALES)
    jdense = jax_llama.init_caches(jcfg, 2, 130, SCALES)
    assert dense.k.dtype == torch.uint8 and dense.k.shape == jdense.k.shape
    np.testing.assert_array_equal(dense.scale.numpy(), SCALES)


# ---------------------------------------------------------------------------
# the tiny model: bench.py's fp8kv through the session, serving, a family
# ---------------------------------------------------------------------------

def _tiny_fp8kv(dtype="float32", seed=3):
    jcfg = JaxConfig.tiny(dtype=dtype, quant_mode=FP8KV)
    floats = jax_llama.init_params(jcfg, jax.random.PRNGKey(seed))
    jparams = jax_quantize_params(floats, FP8KV, quantize_lm_head=True)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               "cpu")
    cfg = ModelConfig.tiny(dtype=dtype, quant_mode=QuantMode(int(FP8KV)))
    assert isinstance(params["layers"]["wq"], FP8Weight)
    assert isinstance(params["lm_head"], FP8Weight)
    return jcfg, jparams, cfg, params


def _rel_err(got, want):
    want = np.asarray(want, np.float32)
    return np.abs(got.float().numpy() - want).max() / np.abs(want).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiny_fp8kv_model_matches_jax(dtype):
    """Prefill and two decode steps: logits within 1e-4 / 2e-3 (f32
    prefill / decode) or 3% (bf16) of the largest; the first layer's codes
    bit for bit, in f32 every code within one step (in bf16 the second
    layer's inputs already differ by bf16 roundings); in f32 the sessions'
    greedy tokens are identical."""
    jcfg, jparams, cfg, params = _tiny_fp8kv(dtype)
    f32 = dtype == "float32"
    rel = LOGITS_REL if f32 else BF16_LOGITS_REL
    scales = np.full((cfg.num_layers,), KV_SCALE, np.float32)
    rng = np.random.default_rng(1)
    b = 2
    ids = rng.integers(3, cfg.vocab_size, (b, 16)).astype(np.int32)
    lens = np.asarray([16, 9], np.int32)
    jlogits, jcaches = jax_llama.forward_prefill(
        jparams, jcfg, jnp.asarray(ids), jnp.asarray(lens),
        jax_llama.init_caches(jcfg, b, 32, scales))
    logits, caches = llama.forward_prefill(
        params, cfg, _t(ids), _t(lens),
        llama.init_caches(cfg, b, 32, "cpu", scales))
    assert caches.k.dtype == torch.uint8
    assert _rel_err(logits, jlogits) <= rel
    for got, want in ((caches.k, jcaches.k), (caches.v, jcaches.v)):
        np.testing.assert_array_equal(got.numpy()[0], np.asarray(want)[0])
        if f32:
            _assert_codes_near(got.numpy(), want)
    rel = F32_DECODE_REL if f32 else rel
    pos = lens.copy()
    for tokens in ([7, 11], [250, 3]):
        tokens = np.asarray(tokens, np.int32)
        jlogits, jcaches = jax_llama.forward_decode(
            jparams, jcfg, jnp.asarray(tokens), jnp.asarray(pos), jcaches)
        logits, caches = llama.forward_decode(
            params, cfg, _t(tokens), _t(pos), caches)
        assert _rel_err(logits, jlogits) <= rel
        pos += 1
    if not f32:
        return
    want = JaxSession(jcfg, jparams, JaxEngineConfig(**ECFG),
                      kv_scales=scales).generate(
        PROMPTS, sampling=JaxSampling(end_id=-1), max_new_tokens=12)
    got = GenerationSession(cfg, params, EngineConfig(**ECFG),
                            kv_scales=scales, device="cpu").generate(
        PROMPTS, sampling=SamplingConfig(end_id=-1), max_new_tokens=12)
    np.testing.assert_array_equal(got.output_ids, np.asarray(want.output_ids))


@pytest.mark.parametrize("options", [{}, dict(paged=True, block_size=8)],
                         ids=["dense", "paged"])
def test_serving_fp8kv_matches_jax(options):
    """ServingEngine with fp8 weights and an e4m3 cache (scale 0.05):
    requests of ragged lengths admitted in two waves, then one more on
    the freed slots; every request's tokens equal the JAX engine's."""
    jcfg, jparams, cfg, params = _tiny_fp8kv()
    ecfg = dict(max_batch_size=3, max_input_len=16, max_seq_len=64)
    scales = np.full((cfg.num_layers,), KV_SCALE, np.float32)
    port = ServingEngine(cfg, params, EngineConfig(**ecfg),
                         sampling=SamplingConfig(end_id=-1), kv_scales=scales,
                         decode_chunk=4, device="cpu", **options)
    ref = JaxEngine(jcfg, jparams, JaxEngineConfig(**ecfg),
                    sampling=JaxSampling(end_id=-1), kv_scales=scales,
                    decode_chunk=4, **options)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, 250, (n,)).tolist() for n in (5, 9, 3, 12, 7)]
    outs = []
    for eng in (port, ref):
        rids = [eng.submit(p, n) for p, n in zip(prompts[:4], (6, 20, 9, 5))]
        done = eng.run_to_completion()
        rids.append(eng.submit(prompts[4], 8))
        done.update(eng.run_to_completion())
        outs.append([list(done[r].output_ids) for r in rids])
    assert outs[0] == outs[1]
    assert port.caches[0].dtype == torch.uint8


def test_bloom_fp8kv_tokens_match_jax():
    """Bloom with an e4m3 cache: the ALiBi decode takes the plain branch
    (the plain write, decode_attention dequantizing to q's dtype); greedy
    tokens equal the JAX session's."""
    over = dict(dtype="float32", architecture="bloom", rms_norm_eps=1e-5)
    jcfg = JaxConfig.tiny(quant_mode=JaxQuantMode.FP8_KV_CACHE, **over)
    cfg = ModelConfig.tiny(quant_mode=QuantMode.FP8_KV_CACHE, **over)
    tree = jax.tree_util.tree_map(
        np.asarray, jax_decoder.BLOOM.init_params(jcfg,
                                                  jax.random.PRNGKey(2)))
    scales = np.full((cfg.num_layers,), KV_SCALE, np.float32)
    want = JaxSession(jcfg, jax.tree_util.tree_map(jnp.asarray, tree),
                      JaxEngineConfig(**ECFG), kv_scales=scales,
                      model=jax_decoder.BLOOM).generate(
        PROMPTS, sampling=JaxSampling(end_id=-1), max_new_tokens=10)
    before = attention.fused_decode_attention_at.alibi_calls
    got = GenerationSession(cfg, params_from_numpy(tree, "cpu"),
                            EngineConfig(**ECFG), kv_scales=scales,
                            device="cpu", model=decoder.BLOOM).generate(
        PROMPTS, sampling=SamplingConfig(end_id=-1), max_new_tokens=10)
    np.testing.assert_array_equal(got.output_ids, np.asarray(want.output_ids))
    assert (attention.fused_decode_attention_at.alibi_calls - before
            == cfg.num_layers * 9)


def test_random_fp8kv_params_are_fp8_weights():
    """The KV flag leaves the weights as the rest of the mode makes them,
    as in the JAX package: fp8 under FP8_QDQ | FP8_KV_CACHE, the compute
    dtype under FP8_KV_CACHE alone."""
    fp8kv = QuantMode.FP8_QDQ | QuantMode.FP8_KV_CACHE
    params = init_random_quantized_params(
        ModelConfig.tiny(quant_mode=fp8kv), device="cpu")
    assert all(isinstance(params["layers"][k], FP8Weight)
               for k in ("wq", "wo", "w_down"))
    params = init_random_quantized_params(
        ModelConfig.tiny(dtype="float32",
                         quant_mode=QuantMode.FP8_KV_CACHE), device="cpu")
    assert params["layers"]["wq"].dtype == torch.float32


# ---------------------------------------------------------------------------
# the wrappers' scales and libraries
# ---------------------------------------------------------------------------

def test_cache_kind_codes_match_the_kernel_enum():
    """The wrappers' cache kind codes are csrc/flash_decode.cuh's CacheKind:
    the activation type 0, int8 1, uint8 (e4m3 codes) 2."""
    from trtllm_llama_tpu_torch.ops.kernels import _build
    src = (_build.CSRC / "flash_decode.cuh").read_text()
    enum = dict(re.findall(r"(kCache\w+) = (\d)", src))
    assert {k: int(v) for k, v in enum.items()} == {
        "kCacheFloat": 0, "kCacheInt8": 1, "kCacheE4M3": 2}
    assert da.cache_kind(torch.int8) == 1
    assert da.cache_kind(torch.uint8) == 2
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        assert da.cache_kind(dtype) == 0


def _bad_scales(n_layers):
    """Scales that a quantized cache of n_layers layers must refuse."""
    return st.one_of(
        st.none(),
        st.just([KV_SCALE] * n_layers),
        st.sampled_from([torch.float64, torch.float16, torch.bfloat16,
                         torch.int32]).map(
            lambda dt: torch.full((n_layers,), KV_SCALE).to(dt)),
        st.sampled_from([(n_layers + 1,), (n_layers, 1), (), (1, n_layers)])
        .map(lambda shape: torch.full(shape, KV_SCALE)))


@settings(max_examples=40, deadline=None)
@given(n_layers=st.integers(2, 3), data=st.data(),
       cache_dtype=st.sampled_from([torch.uint8, torch.int8]),
       wrapper=st.sampled_from(["dma", "fused", "read-only", "paged"]))
def test_wrappers_refuse_a_quantized_cache_without_f32_scales(
        n_layers, data, cache_dtype, wrapper):
    """Every decode wrapper refuses an e4m3 (uint8) or int8 cache whose
    kv_scale is not f32 [L], on the CPU too (before its plain version)."""
    kv_scale = data.draw(_bad_scales(n_layers))
    b, hq, hkv, s, d = 1, 4, 2, 32, 32
    cache = torch.zeros((n_layers, b, hkv, s, d), dtype=cache_dtype)
    q = torch.zeros((b, hq, d))
    new = torch.zeros((b, hkv, d))
    pos = torch.tensor([3], dtype=torch.int32)
    calls = {
        "dma": lambda: da.dma_decode_attention(
            q, new, new, cache, cache.clone(), 0, pos, kv_scale=kv_scale),
        "fused": lambda: da.fused_decode_attention(
            q, new, new, cache, cache.clone(), 0, pos, kv_scale=kv_scale),
        "read-only": lambda: da.decode_attention_kernel(
            q, cache, cache.clone(), 0, pos, kv_scale=kv_scale),
        "paged": lambda: pda.paged_decode_attention(
            q, new, new, cache.reshape(n_layers, 4, hkv, 8, d),
            cache.reshape(n_layers, 4, hkv, 8, d).clone(), 0,
            torch.tensor([[0, 1, 2]], dtype=torch.int32), pos,
            kv_scale=kv_scale)}
    with pytest.raises(ValueError, match="kv_scale, f32"):
        calls[wrapper]()
    kv_scale = torch.full((n_layers,), KV_SCALE)      # the calls read it
    assert torch.isfinite(calls[wrapper]()).all()
