"""The port's forward_extend (a T-token slab a sequence at per-row starts)
against the JAX package's, on the CPU.

LLaMA at ModelConfig.tiny in f32 with int8 weight-only parameters carried
across by params_from_numpy, a float, an int8 (scale 0.05) and an e4m3
(scale 0.05) KV cache, MHA and a GQA group of 2: a prefill at ragged
lengths, then forward_extend of 4 tokens at the per-row lengths. The port
writes into cache rows `slots` (the serving engine's); JAX into rows
0..B-1 of its own cache. Logits within 1e-4 relative, the cache within
1e-5 (float) or one code (int8 / e4m3: the K/V the two frameworks compute
differ in f32's last bits, so a code at a rounding boundary may move).
The ops alone, on the same inputs: the slab's write is bit-identical to
JAX's write_kv_extend_at (a position past S_max dropped), and both forms
of extend_attention_at (the slab read after its write, and the cache read
before it with the in-flight rows round-tripped through the codec) agree
with JAX's within 1e-5, ALiBi slopes too. Each of the five decoder
families' forward_extend matches JAX's (1e-5, as the families' prefill and
decode tests), and the port's extend equals T sequential forward_decode
steps (1e-4).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from trtllm_llama_tpu.config import ModelConfig as JaxConfig
from trtllm_llama_tpu.models import decoder as jax_decoder
from trtllm_llama_tpu.models import llama as jax_llama
from trtllm_llama_tpu.ops import attention as jax_attn
from trtllm_llama_tpu.quantization.mode import QuantMode as JaxQuantMode
from trtllm_llama_tpu.quantization.quantize import quantize_params
from trtllm_llama_tpu_torch.config import ModelConfig
from trtllm_llama_tpu_torch.convert.bridge import params_from_numpy
from trtllm_llama_tpu_torch.models import decoder, llama
from trtllm_llama_tpu_torch.ops import attention
from trtllm_llama_tpu_torch.ops.fp8 import fp8_decode
from trtllm_llama_tpu_torch.quantization.mode import QuantMode

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
OP_TOL = dict(rtol=1e-5, atol=1e-5)
KV_SCALE = 0.05
KV_KINDS = {"float": (QuantMode(0), JaxQuantMode(0)),
            "int8": (QuantMode.INT8_KV_CACHE, JaxQuantMode.INT8_KV_CACHE),
            "fp8": (QuantMode.FP8_KV_CACHE, JaxQuantMode.FP8_KV_CACHE)}
HEADS = [(4, 4), (4, 2)]           # MHA and a GQA group of 2
LENS = np.asarray([9, 5], np.int32)
SLOTS = [2, 0]                     # the port's cache rows for the 2 sequences
T = 4


def _t(a):
    return torch.from_numpy(np.array(a))


def _llama(kv, hq, hkv):
    mode, jmode = KV_KINDS[kv]
    over = dict(dtype="float32", num_heads=hq, num_kv_heads=hkv)
    jcfg = JaxConfig.tiny(quant_mode=jmode, **over)
    cfg = ModelConfig.tiny(quant_mode=mode, **over)
    jparams = quantize_params(jax_llama.init_params(jcfg,
                                                    jax.random.PRNGKey(3)),
                              JaxQuantMode.use_weight_only(False))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               "cpu")
    return jcfg, cfg, jparams, params


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, cfg.vocab_size, (2, 16)).astype(np.int32)
    toks = rng.integers(3, cfg.vocab_size, (2, T)).astype(np.int32)
    return ids, toks


def _scales(cfg, kv):
    return None if kv == "float" else np.full((cfg.num_layers,), KV_SCALE,
                                              np.float32)


def _values(x, kv):
    """Cache elements as the values they stand for, in code steps: a code
    step is 1 for int8, the e4m3 value for fp8."""
    x = _t(x)
    if kv == "fp8":
        return fp8_decode(x).numpy()
    return x.numpy().astype(np.float32)


def _assert_cache_close(got, want, kv):
    got, want = _values(got, kv), _values(want, kv)
    if kv == "float":
        np.testing.assert_allclose(got, want, **OP_TOL)
        return
    # one code of difference at most: int8 steps of 1, e4m3 steps of 1/8
    # of the value's binade
    step = 1.0 if kv == "int8" else np.maximum(np.abs(want) / 8, 2.0 ** -9)
    assert np.all(np.abs(got - want) <= step + 1e-6)
    assert np.mean(got != want) < 1e-2


@pytest.mark.parametrize("hq,hkv", HEADS, ids=["mha", "gqa"])
@pytest.mark.parametrize("kv", list(KV_KINDS))
def test_forward_extend_matches_jax(kv, hq, hkv):
    """Prefill at lengths 9 / 5, then a 4-token slab at those starts:
    logits and the whole cache against JAX's, the port's cache rows being
    the serving slots 2 and 0 of a 3-row cache."""
    jcfg, cfg, jparams, params = _llama(kv, hq, hkv)
    ids, toks = _inputs(cfg)
    scales = _scales(cfg, kv)
    jc = jax_llama.init_caches(jcfg, 2, 64, scales)
    _, jc = jax_llama.forward_prefill(jparams, jcfg, jnp.asarray(ids),
                                      jnp.asarray(LENS), jc)
    jlogits, jc = jax_llama.forward_extend(jparams, jcfg, jnp.asarray(toks),
                                           jnp.asarray(LENS), jc)
    slots = torch.tensor(SLOTS)
    c = llama.init_caches(cfg, 3, 64, "cpu", scales)
    _, c = llama.forward_prefill(params, cfg, _t(ids), _t(LENS), c,
                                 slots=slots)
    logits, c = llama.forward_extend(params, cfg, _t(toks), _t(LENS), c,
                                     slots=slots)
    assert logits.shape == (2, T, cfg.vocab_size)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    for got, want in ((c.k, jc.k), (c.v, jc.v)):
        _assert_cache_close(got[:, SLOTS].numpy(), np.asarray(want), kv)
    assert not c.k[:, 1].any() and not c.v[:, 1].any()      # row 1 unused


def _op_inputs(kv, hq, hkv, seed=1):
    """A cache [1, 2, hkv, 32, 16] of kind `kv` with random rows, and a
    slab's q [2, T, hq, 16], k / v [2, T, hkv, 16] at starts 5 and 30
    (the second slab runs past S_max = 32)."""
    rng = np.random.default_rng(seed)
    s, d = 32, 16
    x = (rng.standard_normal((2, 2, hkv, s, d)) * 2).astype(np.float32)
    dtype = {"float": torch.float32, "int8": torch.int8,
             "fp8": torch.uint8}[kv]
    scale = torch.tensor([KV_SCALE if kv != "float" else 1.0])
    k = attention._quant_kv(_t(x[0])[None], dtype, scale[0])
    v = attention._quant_kv(_t(x[1])[None], dtype, scale[0])
    q = rng.standard_normal((2, T, hq, d)).astype(np.float32)
    kn = (rng.standard_normal((2, T, hkv, d)) * 2).astype(np.float32)
    vn = (rng.standard_normal((2, T, hkv, d)) * 2).astype(np.float32)
    start = np.asarray([5, 30], np.int32)
    return attention.KVCache(k, v, scale), q, kn, vn, start


def _jax_cache(c):
    return jax_attn.KVCache(jnp.asarray(c.k.numpy()), jnp.asarray(c.v.numpy()),
                            jnp.asarray(c.scale.numpy()))


@pytest.mark.parametrize("hq,hkv", HEADS, ids=["mha", "gqa"])
@pytest.mark.parametrize("kv", list(KV_KINDS))
def test_extend_ops_match_jax(kv, hq, hkv):
    """write_kv_extend_at bit for bit (a row past S_max dropped, the rows
    before the slab untouched); extend_attention_at in both forms, with
    and without ALiBi slopes, within 1e-5 of JAX's."""
    c, q, kn, vn, start = _op_inputs(kv, hq, hkv)
    jc = _jax_cache(c)
    slopes = np.asarray(attention.alibi_slopes(hq))
    for alibi in (None, slopes):
        ja = None if alibi is None else jnp.asarray(alibi)
        ta = None if alibi is None else _t(alibi)
        want = jax_attn.extend_attention_at(
            jnp.asarray(q), jc, 0, jnp.asarray(start), jnp.asarray(kn),
            jnp.asarray(vn), alibi=ja)
        got = attention.extend_attention_at(_t(q), c, 0, _t(start), _t(kn),
                                            _t(vn), alibi=ta)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP_TOL)
    before = c.k.clone()
    jw = jax_attn.write_kv_extend_at(jc, 0, jnp.asarray(kn), jnp.asarray(vn),
                                     jnp.asarray(start))
    c = attention.write_kv_extend_at(c, 0, _t(kn), _t(vn), _t(start))
    np.testing.assert_array_equal(c.k.numpy(), np.asarray(jw.k))
    np.testing.assert_array_equal(c.v.numpy(), np.asarray(jw.v))
    assert torch.equal(c.k[0, 1, :, :30], before[0, 1, :, :30])
    for alibi in (None, slopes):
        ja = None if alibi is None else jnp.asarray(alibi)
        ta = None if alibi is None else _t(alibi)
        want = jax_attn.extend_attention_at(jnp.asarray(q), jw, 0,
                                            jnp.asarray(start), alibi=ja)
        got = attention.extend_attention_at(_t(q), c, 0, _t(start), alibi=ta)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP_TOL)


def test_extend_writes_and_reads_slot_rows():
    """With slots, the slab goes to those cache rows and attends them: the
    same as an extend on a cache that holds only those rows."""
    c, q, kn, vn, start = _op_inputs("int8", 4, 2)
    big = attention.KVCache(torch.zeros((1, 4) + c.k.shape[2:], dtype=c.k.dtype),
                            torch.zeros((1, 4) + c.v.shape[2:], dtype=c.v.dtype),
                            c.scale)
    slots = torch.tensor([3, 1])
    big.k[:, slots], big.v[:, slots] = c.k, c.v
    want = attention.extend_attention_at(_t(q), c, 0, _t(start), _t(kn),
                                         _t(vn))
    got = attention.extend_attention_at(_t(q), big, 0, _t(start), _t(kn),
                                        _t(vn), slots=slots)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    attention.write_kv_extend_at(c, 0, _t(kn), _t(vn), _t(start))
    attention.write_kv_extend_at(big, 0, _t(kn), _t(vn), _t(start), slots)
    assert torch.equal(big.k[:, slots], c.k)
    assert torch.equal(big.v[:, slots], c.v)
    assert not big.k[:, [0, 2]].any()


FAMILIES = {  # architecture -> tiny config overrides, as the families' tests
    "gptj": dict(rotary_dim=16),
    "gptneox": dict(rotary_dim=8),
    "bloom": {},
    "opt": {},
    "falcon": dict(num_kv_heads=1),
}


def _family(arch):
    """(jax cfg, port cfg, jax family, port family, jax params, port
    params): JAX's init with random biases and norm weights."""
    over = dict(dtype="float32", architecture=arch, rms_norm_eps=1e-5,
                **FAMILIES[arch])
    jcfg, cfg = JaxConfig.tiny(**over), ModelConfig.tiny(**over)
    name = {"gptj": "GPTJ", "gptneox": "GPTNEOX", "bloom": "BLOOM",
            "opt": "OPT", "falcon": "FALCON"}[arch]
    jfam, fam = getattr(jax_decoder, name), getattr(decoder, name)
    tree = jax.tree_util.tree_map(
        np.asarray, jfam.init_params(jcfg, jax.random.PRNGKey(4)))
    rng = np.random.default_rng(104)

    def perturb(d):
        for key, a in d.items():
            if isinstance(a, dict):
                perturb(a)
            elif key.startswith("b") or key.endswith(("_b", "_w")):
                base = 1.0 if key.endswith("_w") else 0.0
                d[key] = (base + 0.1 * rng.standard_normal(a.shape)).astype(
                    a.dtype)
    perturb(tree)
    return (jcfg, cfg, jfam, fam, jax.tree_util.tree_map(jnp.asarray, tree),
            params_from_numpy(tree, "cpu"))


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_family_forward_extend_matches_jax(arch):
    """Each family's extend (GPT-J's partial interleaved rotary, NeoX's
    partial rotary, Bloom's ALiBi, OPT's learned positions at +2, Falcon's
    one KV head) at per-row starts, into slot rows: logits and caches
    within 1e-5 of JAX's."""
    jcfg, cfg, jfam, fam, jparams, params = _family(arch)
    ids, toks = _inputs(cfg, seed=2)
    jc = jfam.init_caches(jcfg, 2, 64)
    _, jc = jfam.forward_prefill(jparams, jcfg, jnp.asarray(ids),
                                 jnp.asarray(LENS), jc)
    jlogits, jc = jfam.forward_extend(jparams, jcfg, jnp.asarray(toks),
                                      jnp.asarray(LENS), jc)
    slots = torch.tensor(SLOTS)
    c = fam.init_caches(cfg, 3, 64, "cpu")
    _, c = fam.forward_prefill(params, cfg, _t(ids), _t(LENS), c, slots=slots)
    logits, c = fam.forward_extend(params, cfg, _t(toks), _t(LENS), c,
                                   rope=fam.rope_tables(cfg), slots=slots)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **OP_TOL)
    for got, want in ((c.k, jc.k), (c.v, jc.v)):
        np.testing.assert_allclose(got[:, SLOTS].numpy(), np.asarray(want),
                                   **OP_TOL)


@pytest.mark.parametrize("model", ["llama", "bloom", "opt"])
def test_extend_equals_sequential_decode(model):
    """The port's slab of T tokens equals T forward_decode steps: logits
    within 1e-4, the written cache rows within 1e-5."""
    if model == "llama":
        _, cfg, _, params = _llama("float", 4, 2)
        fam = llama
    else:
        _, cfg, _, fam, _, params = _family(model)
    ids, toks = _inputs(cfg, seed=3)
    caches = []
    for _ in range(2):
        c = fam.init_caches(cfg, 2, 64, "cpu")
        _, c = fam.forward_prefill(params, cfg, _t(ids), _t(LENS), c)
        caches.append(c)
    slab, c1 = fam.forward_extend(params, cfg, _t(toks), _t(LENS), caches[0])
    c2, steps, pos = caches[1], [], _t(LENS)
    for i in range(T):
        lg, c2 = fam.forward_decode(params, cfg, _t(toks[:, i]), pos, c2)
        steps.append(lg)
        pos = pos + 1
    torch.testing.assert_close(slab, torch.stack(steps, 1), **TOL)
    torch.testing.assert_close(c1.k, c2.k, **OP_TOL)
    torch.testing.assert_close(c1.v, c2.v, **OP_TOL)
