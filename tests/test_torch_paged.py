"""The port's serving building blocks against the JAX package: the request
scheduler and the paged block manager (host-side, copied), the paged KV
ops (`ops/paged_attention.py`, kernel 14's plain version), the packed
prefill ops (kernel 13's plain version and the packed cache write), the
dropped out-of-range decode write of the dense cache, and the tiny model's
packed and paged forward passes.

Tolerances: the host-side managers give identical state after the same
seeded operations; cache writes are bit-identical (f32 copies, int8 codes
by the same division), outside the trash block / slot that several writes
may hit in an undefined order; attention agrees with the JAX XLA paths to
1e-5 in f32. Against the interpret-mode Pallas kernels the outputs agree
to 2e-2 (as `tests/test_paged_kernel.py` holds the Pallas kernel to the
XLA path) and an int8 code may differ by one (the Pallas kernel encodes by
a multiply with 1/scale, the port by a true division). The tiny f32 model's
packed prefill logits are within 1e-4 of JAX's, and its paged decode gives
the same greedy tokens.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from trtllm_llama_tpu.config import ModelConfig as JaxConfig
from trtllm_llama_tpu.models import llama as jax_llama
from trtllm_llama_tpu.ops import attention as jax_attn
from trtllm_llama_tpu.ops import paged_attention as jax_paged
from trtllm_llama_tpu.ops.pallas.attention import (
    packed_prefill_attention_kernel as pallas_packed,
)
from trtllm_llama_tpu.ops.pallas.paged_decode_attention import (
    paged_decode_attention as pallas_paged,
)
from trtllm_llama_tpu.runtime import kv_cache_manager as jax_kvm
from trtllm_llama_tpu.runtime import scheduler as jax_sched
from trtllm_llama_tpu_torch.config import ModelConfig
from trtllm_llama_tpu_torch.convert.bridge import params_from_numpy
from trtllm_llama_tpu_torch.models import llama
from trtllm_llama_tpu_torch.ops import attention, paged_attention as paged
from trtllm_llama_tpu_torch.quantization.mode import QuantMode
from trtllm_llama_tpu_torch.runtime import kv_cache_manager as kvm
from trtllm_llama_tpu_torch.runtime import scheduler as sched

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
PALLAS_TOL = dict(rtol=2e-2, atol=2e-2)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# host-side managers: the same seeded operations on both copies
# ---------------------------------------------------------------------------

def _twin(ops_a, ops_b, name, *args):
    """Apply one operation to both objects; both must return the same
    value or raise the same exception type."""
    out = []
    for obj in (ops_a, ops_b):
        try:
            out.append(("ok", getattr(obj, name)(*args)))
        except Exception as e:                      # noqa: BLE001
            out.append(("raise", type(e).__name__))
    return out


def _requests(reqs):
    return [(r.request_id, r.slot, r.state.name, r.output_ids,
             r.finished_reason) for r in reqs]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scheduler_matches_jax(seed):
    rng = np.random.default_rng(seed)
    a = sched.Scheduler(3, 40, kv_token_capacity=90)
    b = jax_sched.Scheduler(3, 40, kv_token_capacity=90)
    for _ in range(200):
        op = rng.choice(["submit", "admit", "record", "cancel"],
                        p=[0.3, 0.2, 0.4, 0.1])
        if op == "submit":
            args = (rng.integers(0, 9, rng.integers(1, 30)).tolist(),
                    int(rng.integers(1, 20)))
            got = _twin(a, b, "submit", *args)
        elif op == "admit":
            got = _twin(a, b, "admit")
            got = [(k, _requests(v) if k == "ok" else v) for k, v in got]
        elif op == "record" and a.num_active:
            rid = a.active_requests()[rng.integers(a.num_active)].request_id
            got = _twin(a, b, "record_token", rid, int(rng.integers(0, 9)), 7)
        else:
            got = _twin(a, b, "cancel", int(rng.integers(0, 40)))
        assert got[0] == got[1], (op, got)
        assert _requests(a.active_requests()) == _requests(b.active_requests())
        assert (a.num_queued, a.has_work) == (b.num_queued, b.has_work)
        assert a._reserved_tokens == b._reserved_tokens


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kv_cache_manager_matches_jax(seed):
    rng = np.random.default_rng(seed)
    a = kvm.KVCacheManager(12, 4, 5)
    b = jax_kvm.KVCacheManager(12, 4, 5)
    for _ in range(300):
        op = rng.choice(["add", "append", "fork", "remove"],
                        p=[0.25, 0.45, 0.1, 0.2])
        sid = int(rng.integers(0, 6))
        if op == "add":
            got = _twin(a, b, "add_sequence", sid, int(rng.integers(1, 22)))
        elif op == "append":
            got = _twin(a, b, "append_token", sid)
        elif op == "fork":
            got = _twin(a, b, "fork_sequence", sid, int(rng.integers(0, 6)))
        else:
            got = _twin(a, b, "remove_sequence", sid)
        assert got[0] == got[1], (op, got)
        np.testing.assert_array_equal(a.block_table(), b.block_table())
        assert a.pop_pending_copies() == b.pop_pending_copies()
        assert a.blocks.free_blocks == b.blocks.free_blocks
        assert a.cow_sources() == b.cow_sources()


# ---------------------------------------------------------------------------
# paged KV ops
# ---------------------------------------------------------------------------

def _pools(rng, kv_int8, n_layers=2, nb=9, hkv=2, bs=8, d=32):
    shape = (n_layers, nb, hkv, bs, d)
    if kv_int8:
        pk = rng.integers(-127, 128, shape).astype(np.int8)
        pv = rng.integers(-127, 128, shape).astype(np.int8)
        scale = np.asarray([0.05, 0.021], np.float32)[:n_layers]
    else:
        pk = rng.standard_normal(shape).astype(np.float32)
        pv = rng.standard_normal(shape).astype(np.float32)
        scale = np.ones((n_layers,), np.float32)
    return pk, pv, scale


def _caches(pk, pv, tables, scale):
    """(the port's PagedKVCache, JAX's) over copies of the same arrays."""
    return (paged.PagedKVCache(_t(pk), _t(pv), _t(tables), _t(scale)),
            jax_paged.PagedKVCache(jnp.asarray(pk), jnp.asarray(pv),
                                   jnp.asarray(tables), jnp.asarray(scale)))


def _assert_pools_equal(cache, jcache, skip_trash=True):
    """Pools bit-identical, outside the trash block (the pool's last) when
    several writes may land there."""
    n = cache.pool_k.shape[1] - (1 if skip_trash else 0)
    for got, want in ((cache.pool_k, jcache.pool_k),
                      (cache.pool_v, jcache.pool_v)):
        np.testing.assert_array_equal(got.numpy()[:, :n],
                                      np.asarray(want)[:, :n])


@pytest.mark.parametrize("kv_int8", [False, True])
@pytest.mark.parametrize("s", [5, 16, 19])
def test_paged_write_prefill_matches_jax(kv_int8, s):
    rng = np.random.default_rng(s)
    pk, pv, scale = _pools(rng, kv_int8)
    # row 1's third block and row 2's whole table are unallocated (-1):
    # their writes go to the trash block
    tables = np.asarray([[3, 0, 5], [7, 1, -1], [-1, -1, -1]], np.int32)
    k = (rng.standard_normal((3, s, 2, 32)) * 4).astype(np.float32)
    v = (rng.standard_normal((3, s, 2, 32)) * 4).astype(np.float32)
    cache, jcache = _caches(pk, pv, tables, scale)
    cache = paged.paged_write_prefill_at(cache, 1, _t(k), _t(v))
    jcache = jax_paged.paged_write_prefill_at(jcache, 1, jnp.asarray(k),
                                              jnp.asarray(v))
    _assert_pools_equal(cache, jcache)


@pytest.mark.parametrize("kv_int8", [False, True])
def test_paged_write_decode_matches_jax(kv_int8):
    rng = np.random.default_rng(3)
    pk, pv, scale = _pools(rng, kv_int8)
    mb, bs = 3, 8
    tables = np.asarray([[3, 0, 5], [7, 1, -1], [2, 4, 6], [6, 2, 4]],
                        np.int32)
    # mid-block, into a -1 entry (trash), past the table (pos = MB * BS:
    # trash), the last row of the table
    positions = np.asarray([10, 17, mb * bs, mb * bs - 1], np.int32)
    k = (rng.standard_normal((4, 2, 32)) * 4).astype(np.float32)
    v = (rng.standard_normal((4, 2, 32)) * 4).astype(np.float32)
    cache, jcache = _caches(pk, pv, tables, scale)
    cache = paged.paged_write_decode_at(cache, 0, _t(k), _t(v),
                                        _t(positions))
    jcache = jax_paged.paged_write_decode_at(jcache, 0, jnp.asarray(k),
                                             jnp.asarray(v),
                                             jnp.asarray(positions))
    _assert_pools_equal(cache, jcache)
    # the trash block took the two redirected writes; nothing else moved
    trash = cache.pool_k.shape[1] - 1
    moved = (cache.pool_k.numpy() != pk).any(axis=(2, 4))     # [L, NB, BS]
    assert moved[0, trash, [17 % bs, 0]].all()
    assert moved.sum() == 4 and not moved[1].any()


@pytest.mark.parametrize("kv_int8", [False, True])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
def test_paged_decode_attention_matches_jax(kv_int8, hq, hkv):
    rng = np.random.default_rng(hq + kv_int8)
    pk, pv, scale = _pools(rng, kv_int8, hkv=hkv)
    tables = np.asarray([[3, 0, 5], [7, 1, -1], [2, 4, 6]], np.int32)
    q = rng.standard_normal((3, hq, 32)).astype(np.float32)
    lens = np.asarray([17, 9, 24], np.int32)
    cache, jcache = _caches(pk, pv, tables, scale)
    got = paged.paged_decode_attention_at(_t(q), cache, 1, _t(lens))
    want = jax_paged.paged_decode_attention_at(jnp.asarray(q), jcache, 1,
                                               jnp.asarray(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kv_int8,bs", [(False, 8), (True, 8), (False, 24),
                                        (True, 24)],
                         ids=["False", "True", "False-bs24", "True-bs24"])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
def test_paged_fused_decode_matches_jax_xla(kv_int8, bs, hq, hkv):
    """Kernel 14's plain version against the JAX XLA path (write, then
    attend positions + 1 rows), including a position at MB * BS (past the
    table: the trash block takes the write), at block sizes 8 and 24 (24
    does not divide the kernel's 64-row tile)."""
    rng = np.random.default_rng(10 + hq + kv_int8)
    pk, pv, scale = _pools(rng, kv_int8, hkv=hkv, bs=bs)
    mb = 3
    # no -1 entries in attended blocks: the XLA read maps them to block 0,
    # the fused paths (the kernel, and the JAX caller of the Pallas kernel)
    # to the trash block; serving uploads tables without -1
    tables = np.asarray([[3, 0, 5], [7, 1, -1], [2, 4, 6]], np.int32)
    positions = np.asarray([13, 4, mb * bs], np.int32)
    q = rng.standard_normal((3, hq, 32)).astype(np.float32)
    k = (rng.standard_normal((3, hkv, 32)) * 4).astype(np.float32)
    v = (rng.standard_normal((3, hkv, 32)) * 4).astype(np.float32)
    cache, jcache = _caches(pk, pv, tables, scale)
    got, cache = paged.paged_fused_decode_attention_at(
        _t(q), _t(k), _t(v), cache, 1, _t(positions))
    want, jcache = jax_paged.paged_fused_decode_attention_at(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jcache, 1,
        jnp.asarray(positions))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _assert_pools_equal(cache, jcache, skip_trash=False)


@pytest.mark.parametrize("kv_int8,bs", [(False, 32), (True, 32), (False, 24)],
                         ids=["False", "True", "False-bs24"])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
def test_paged_fused_decode_matches_pallas_interpret(kv_int8, bs, hq, hkv):
    """Against the interpret-mode Pallas kernel, at BS 32 and 24 (the
    Pallas kernel takes int8 pools only at multiples of 32)."""
    rng = np.random.default_rng(20 + hq + kv_int8)
    nb, d = 11, 128
    pk, pv, scale = _pools(rng, kv_int8, nb=nb, hkv=hkv, bs=bs, d=d)
    if not kv_int8:
        pk, pv = pk * 0.3, pv * 0.3
    tables = np.asarray([[7, 2, 5], [0, 9, 3]], np.int32)
    positions = np.asarray([17, bs * 2 + 4], np.int32)
    q = (rng.standard_normal((2, hq, d)) * 0.3).astype(np.float32)
    k = (rng.standard_normal((2, hkv, d)) * 4).astype(np.float32)
    v = (rng.standard_normal((2, hkv, d)) * 4).astype(np.float32)
    cache, _ = _caches(pk, pv, tables, scale)
    got, cache = paged.paged_fused_decode_attention_at(
        _t(q), _t(k), _t(v), cache, 1, _t(positions))
    want, wk, wv = pallas_paged(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pk),
        jnp.asarray(pv), jnp.asarray(scale), jnp.asarray(tables), 1,
        jnp.asarray(positions), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PALLAS_TOL)
    for got_pool, want_pool in ((cache.pool_k, wk), (cache.pool_v, wv)):
        diff = np.abs(got_pool.numpy().astype(np.float64)
                      - np.asarray(want_pool).astype(np.float64))
        assert diff.max() <= (1 if kv_int8 else 1e-6), diff.max()


def test_paged_block_size_must_be_a_multiple_of_8():
    from trtllm_llama_tpu_torch.ops.kernels import paged_decode_attention as k14
    pool = torch.zeros((1, 3, 2, 12, 32))
    x = torch.zeros((1, 2, 32))
    with pytest.raises(ValueError, match="multiple of 8"):
        k14.paged_decode_attention(x, x, x, pool, pool.clone(), 0,
                                   torch.zeros((1, 1), dtype=torch.int32),
                                   torch.zeros(1, dtype=torch.int32))


# ---------------------------------------------------------------------------
# dense cache: a decode write past S_max is dropped (the JAX scatter's rule)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_int8", [False, True])
def test_dense_decode_write_past_cache_is_dropped(kv_int8):
    rng = np.random.default_rng(4)
    n_layers, b, hkv, hq, s, d = 2, 3, 2, 4, 32, 32
    if kv_int8:
        kc = rng.integers(-127, 128, (n_layers, b, hkv, s, d)).astype(np.int8)
        vc = rng.integers(-127, 128, kc.shape).astype(np.int8)
        scale = np.asarray([0.05, 0.021], np.float32)
    else:
        kc = rng.standard_normal((n_layers, b, hkv, s, d)).astype(np.float32)
        vc = rng.standard_normal(kc.shape).astype(np.float32)
        scale = np.ones((n_layers,), np.float32)
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    k = (rng.standard_normal((b, hkv, d)) * 4).astype(np.float32)
    v = (rng.standard_normal((b, hkv, d)) * 4).astype(np.float32)
    positions = np.asarray([s, 7, s + 5], np.int32)    # rows 0, 2 past S_max

    cache = attention.KVCache(_t(kc), _t(vc), _t(scale))
    jcache = jax_attn.KVCache(jnp.asarray(kc), jnp.asarray(vc),
                              jnp.asarray(scale))
    attention.write_kv_decode_at(cache, 1, _t(k), _t(v), _t(positions))
    jcache = jax_attn.write_kv_decode_at(jcache, 1, jnp.asarray(k),
                                         jnp.asarray(v),
                                         jnp.asarray(positions))
    np.testing.assert_array_equal(cache.k.numpy(), np.asarray(jcache.k))
    np.testing.assert_array_equal(cache.v.numpy(), np.asarray(jcache.v))
    moved = (cache.k.numpy() != kc).any(axis=(2, 4))
    assert moved.sum() == 1 and moved[1, 1, 7]

    cache = attention.KVCache(_t(kc), _t(vc), _t(scale))
    jcache = jax_attn.KVCache(jnp.asarray(kc), jnp.asarray(vc),
                              jnp.asarray(scale))
    got, cache = attention.fused_decode_attention_at(
        _t(q), _t(k), _t(v), cache, 1, _t(positions))
    want, jcache = jax_attn.fused_decode_attention_at(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jcache, 1,
        jnp.asarray(positions))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(cache.k.numpy(), np.asarray(jcache.k))
    np.testing.assert_array_equal(cache.v.numpy(), np.asarray(jcache.v))


# ---------------------------------------------------------------------------
# packed prefill ops
# ---------------------------------------------------------------------------

# (T, segment lengths): pads after the segments, a length-1 segment, a
# segment that crosses a 32-row tile, pads only, no pads
SEGMENTS = [(24, [5, 1, 9]), (64, [20, 30, 1]), (48, [48]), (40, [3, 33])]


def _seg_ids(t, lens):
    seg = np.full((t,), -1, np.int32)
    off = 0
    for i, n in enumerate(lens):
        seg[off:off + n] = i
        off += n
    return seg


@pytest.mark.parametrize("t,lens", SEGMENTS)
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
def test_packed_prefill_attention_matches_jax(t, lens, hq, hkv):
    rng = np.random.default_rng(t + hq)
    d = 128
    q = (rng.standard_normal((t, hq, d)) * 0.3).astype(np.float32)
    k = rng.standard_normal((t, hkv, d)).astype(np.float32)
    v = rng.standard_normal((t, hkv, d)).astype(np.float32)
    seg = _seg_ids(t, lens)
    real = seg >= 0
    got = attention.packed_prefill_attention(_t(q), _t(k), _t(v), _t(seg))
    assert torch.isfinite(got).all()
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(seg))
    want = jax_attn.packed_prefill_attention(*args)
    np.testing.assert_allclose(got.numpy()[real], np.asarray(want)[real],
                               **TOL)
    want_pallas = pallas_packed(*args, interpret=True)
    np.testing.assert_allclose(got.numpy()[real],
                               np.asarray(want_pallas)[real], **PALLAS_TOL)


@pytest.mark.parametrize("kv_int8", [False, True])
def test_write_kv_packed_matches_jax(kv_int8):
    rng = np.random.default_rng(5)
    n_layers, rows, hkv, s, d = 2, 4, 2, 32, 32
    t, lens, slots = 24, [5, 1, 9], [2, 0, 1]
    if kv_int8:
        kc = np.zeros((n_layers, rows, hkv, s, d), np.int8)
        scale = np.asarray([0.05, 0.021], np.float32)
    else:
        kc = np.zeros((n_layers, rows, hkv, s, d), np.float32)
        scale = np.ones((n_layers,), np.float32)
    trash = rows - 1
    slot_tok = np.full((t,), trash, np.int32)
    pos_tok = np.zeros((t,), np.int32)
    off = 0
    for n, slot in zip(lens, slots):
        slot_tok[off:off + n] = slot
        pos_tok[off:off + n] = np.arange(n)
        off += n
    k = (rng.standard_normal((t, hkv, d)) * 4).astype(np.float32)
    v = (rng.standard_normal((t, hkv, d)) * 4).astype(np.float32)
    cache = attention.KVCache(_t(kc), _t(kc), _t(scale))
    jcache = jax_attn.KVCache(jnp.asarray(kc), jnp.asarray(kc),
                              jnp.asarray(scale))
    attention.write_kv_packed_at(cache, 1, _t(k), _t(v), _t(slot_tok),
                                 _t(pos_tok))
    jcache = jax_attn.write_kv_packed_at(jcache, 1, jnp.asarray(k),
                                         jnp.asarray(v),
                                         jnp.asarray(slot_tok),
                                         jnp.asarray(pos_tok))
    for got, want in ((cache.k, jcache.k), (cache.v, jcache.v)):
        np.testing.assert_array_equal(got.numpy()[:, :trash],
                                      np.asarray(want)[:, :trash])


# ---------------------------------------------------------------------------
# the tiny model: packed prefill, and paged prefill + decode
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    jcfg = JaxConfig.tiny(dtype="float32")
    jparams = jax_llama.init_params(jcfg, jax.random.PRNGKey(5))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               "cpu")
    return jcfg, jparams, ModelConfig.tiny(dtype="float32"), params


def test_forward_prefill_packed_matches_jax(tiny):
    jcfg, jparams, cfg, params = tiny
    rng = np.random.default_rng(6)
    t, lens, slots = 32, [7, 1, 13], [1, 0, 2]
    trash = 3
    tokens = rng.integers(3, cfg.vocab_size, (t,)).astype(np.int32)
    seg = _seg_ids(t, lens)
    slot_tok = np.full((t,), trash, np.int32)
    pos_tok = np.zeros((t,), np.int32)
    last_idx = np.full((3,), t - 1, np.int32)
    off = 0
    for i, (n, slot) in enumerate(zip(lens, slots)):
        slot_tok[off:off + n] = slot
        pos_tok[off:off + n] = np.arange(n)
        last_idx[i] = off + n - 1
        off += n
    got, caches = llama.forward_prefill_packed(
        params, cfg, _t(tokens), attention.PackedMeta(
            _t(seg), _t(slot_tok), _t(pos_tok)), _t(last_idx),
        llama.init_caches(cfg, 4, 32, "cpu"))
    want, jcaches = jax_llama.forward_prefill_packed(
        jparams, jcfg, jnp.asarray(tokens), jax_attn.PackedMeta(
            jnp.asarray(seg), jnp.asarray(slot_tok), jnp.asarray(pos_tok)),
        jnp.asarray(last_idx), jax_llama.init_caches(jcfg, 4, 32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(caches.k.numpy()[:, :trash],
                               np.asarray(jcaches.k)[:, :trash], **TOL)


def test_forward_prefill_into_slots_matches_jax(tiny):
    """The serving engine's dense admission: a batched prefill whose K/V go
    straight to cache rows `slots` (JAX prefills rows 0..B-1 of a scratch
    cache and copies them); the other rows stay as they were."""
    jcfg, jparams, cfg, params = tiny
    rng = np.random.default_rng(8)
    ids = rng.integers(3, cfg.vocab_size, (2, 16)).astype(np.int32)
    lens = np.asarray([11, 4], np.int32)
    slots = [2, 0]
    caches = llama.init_caches(cfg, 4, 32, "cpu")
    caches.k.fill_(7.0)
    caches.v.fill_(7.0)
    got, caches = llama.forward_prefill(params, cfg, _t(ids), _t(lens), caches,
                                        slots=torch.tensor(slots))
    want, jcaches = jax_llama.forward_prefill(
        jparams, jcfg, jnp.asarray(ids), jnp.asarray(lens),
        jax_llama.init_caches(jcfg, 2, 32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    for got_c, want_c in ((caches.k, jcaches.k), (caches.v, jcaches.v)):
        got_c, want_c = got_c.numpy(), np.asarray(want_c)
        for i, slot in enumerate(slots):
            np.testing.assert_allclose(got_c[:, slot, :, :16],
                                       want_c[:, i, :, :16], **TOL)
            assert (got_c[:, slot, :, 16:] == 7.0).all()
        assert (got_c[:, [1, 3]] == 7.0).all()


@pytest.mark.parametrize("kv_int8", [False, True])
def test_paged_prefill_and_decode_match_jax(tiny, kv_int8):
    jcfg, jparams, cfg, params = tiny
    if kv_int8:
        from trtllm_llama_tpu.quantization.mode import QuantMode as JaxQM
        jcfg = JaxConfig.tiny(dtype="float32", quant_mode=JaxQM.INT8_KV_CACHE)
        cfg = ModelConfig.tiny(dtype="float32",
                               quant_mode=QuantMode.INT8_KV_CACHE)
    scales = np.full((cfg.num_layers,), 0.05, np.float32)
    rng = np.random.default_rng(7)
    b, s, nb, bs, mb = 2, 11, 7, 8, 3
    ids = rng.integers(3, cfg.vocab_size, (b, 16)).astype(np.int32)
    lens = np.asarray([s, 6], np.int32)
    tables = np.asarray([[0, 1, 4], [2, 3, 5]], np.int32)
    caches = paged.init_paged_caches(cfg, nb, bs, b, mb, "cpu", scales)
    caches = caches._replace(tables=_t(tables))
    jcaches = jax_paged.init_paged_caches(jcfg, nb, bs, b, mb, scales)
    jcaches = jcaches._replace(tables=jnp.asarray(tables))
    logits, caches = llama.forward_prefill(params, cfg, _t(ids), _t(lens),
                                           caches)
    jlogits, jcaches = jax_llama.forward_prefill(
        jparams, jcfg, jnp.asarray(ids), jnp.asarray(lens), jcaches)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)
    tok, jtok = logits.argmax(-1).int(), jnp.argmax(jlogits, -1)
    pos = lens.copy()
    for _ in range(3):
        logits, caches = llama.forward_decode(params, cfg, tok, _t(pos),
                                              caches)
        jlogits, jcaches = jax_llama.forward_decode(
            jparams, jcfg, jtok, jnp.asarray(pos), jcaches)
        tok, jtok = logits.argmax(-1).int(), jnp.argmax(jlogits, -1)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        pos += 1
    trash = nb - 1
    for got, want in ((caches.pool_k, jcaches.pool_k),
                      (caches.pool_v, jcaches.pool_v)):
        got, want = got.numpy()[:, :trash], np.asarray(want)[:, :trash]
        if kv_int8:      # codes of values computed in another order
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
        else:
            np.testing.assert_allclose(got, want, **TOL)

