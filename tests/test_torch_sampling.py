"""The port's sampling functions against the JAX package's, on the CPU.

Every function of `runtime/sampling.py` gets the same inputs (numpy,
seeded) as its JAX counterpart, called eagerly. Penalized, min-length,
banned and filtered logits must be bit-equal, with logits that tie at the
k-th value and at the top-p threshold (ties are kept: thresholds compare
by value); the one exception is an entry whose top-p decision lies within
float rounding of the cut (`_near_top_p_cut`), where the two packages'
exp and cumulative sums round differently. The draws: with `gumbel_noise` replaced by JAX's own
`jax.random.gumbel(key, shape)` noise, `sample_step` and
`sample_step_slots` must pick JAX's `jax.random.categorical` tokens
exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trtllm_llama_tpu.runtime import sampling as js
from trtllm_llama_tpu_torch.runtime import sampling as ts

torch.set_num_threads(1)

V = 96


def _logits(seed, b=4, v=V, ties=True):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, v)) * 3).astype(np.float32)
    if ties:
        # a run of equal values through the middle of each row: ties at
        # the k-th value for k in 5..12 and around the top-p threshold
        order = np.argsort(-x, axis=1)
        for r in range(b):
            x[r, order[r, 4:12]] = x[r, order[r, 4]]
        x[0, :] = np.float32(0.5)          # a row of one value
        x[0, 3] = np.float32(2.0)
    return x


def _counts(seed, b=4, v=V):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 3, (b, v)).astype(np.int32)
    c[rng.random((b, v)) < 0.6] = 0
    return c


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(want))


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("rep,pres,freq", [
    (1.0, 0.0, 0.0), (1.3, 0.0, 0.0), (0.7, 0.0, 0.0), (1.0, 0.5, 0.0),
    (1.0, 0.0, 0.25), (1.15, 0.4, 0.3)])
def test_repetition_penalty_bit_equal(rep, pres, freq):
    x, c = _logits(1), _counts(2)
    _eq(ts.apply_repetition_penalty(_t(x), _t(c), rep, pres, freq),
        js.apply_repetition_penalty(jnp.asarray(x), jnp.asarray(c), rep,
                                    pres, freq))


@pytest.mark.parametrize("end_id", [2, -1, V - 1])
def test_min_length_bit_equal(end_id):
    x = _logits(3)
    lens = np.array([0, 3, 5, 9], np.int32)
    _eq(ts.apply_min_length(_t(x), _t(lens), 5, end_id),
        js.apply_min_length(jnp.asarray(x), jnp.asarray(lens), 5, end_id))


@pytest.mark.parametrize("k", [0, 1, 3, 5, 8, 12, V])
def test_top_k_bit_equal_with_ties(k):
    x = _logits(4)
    got = ts.apply_top_k(_t(x), k)
    _eq(got, js.apply_top_k(jnp.asarray(x), k))
    if 5 <= k <= 12:       # the whole run of ties at the k-th value stays
        assert ((got > ts.NEG_INF / 2).sum(1) >= 12).all()


@pytest.mark.parametrize("p", [0.0, 0.05, 0.3, 0.5, 0.9, 0.95, 0.999, 1.0])
def test_top_p_bit_equal_with_ties(p):
    x = _logits(5)
    _eq(ts.apply_top_p(_t(x), p), js.apply_top_p(jnp.asarray(x), p))


def test_top_p_keeps_the_threshold_ties():
    """Four equal logits at the cut: the mass before the first is < p, so
    it is the threshold and all four stay."""
    x = np.array([[3.0, 1.0, 1.0, 1.0, 1.0, -2.0, -3.0]], np.float32)
    got = ts.apply_top_p(_t(x), 0.8)
    _eq(got, js.apply_top_p(jnp.asarray(x), 0.8))
    assert (got[0, :5] == _t(x)[0, :5]).all()
    assert (got[0, 5:] == ts.NEG_INF).all()


def _noise_from(keys):
    """A gumbel_noise stand-in drawing JAX's noise for the keys in turn."""
    it = iter(keys)

    def noise(shape, generator):
        return _t(jax.random.gumbel(next(it), tuple(shape)))
    return noise


SAMPLE_CONFIGS = [
    dict(),                                              # greedy
    dict(top_k=1, top_p=0.9),
    dict(temperature=0.7, top_k=8),
    dict(temperature=1.3, top_p=0.9),
    dict(temperature=0.8, top_k=40, top_p=0.95, repetition_penalty=1.1),
    dict(top_k=5, presence_penalty=0.5, frequency_penalty=0.2,
         min_length=4, end_id=3),
    dict(top_p=0.5, min_length=2, end_id=-1),
]


@pytest.mark.parametrize("kw", SAMPLE_CONFIGS,
                         ids=[str(i) for i in range(len(SAMPLE_CONFIGS))])
def test_sample_step_tokens_equal_jax_with_its_noise(monkeypatch, kw):
    cfg, jcfg = ts.SamplingConfig(**kw), js.SamplingConfig(**kw)
    x, c = _logits(6, b=8, ties=False), _counts(7, b=8)
    lens = np.arange(8, dtype=np.int32)
    keys = jax.random.split(jax.random.PRNGKey(11), 5)
    monkeypatch.setattr(ts, "gumbel_noise", _noise_from(keys))
    gen = torch.Generator().manual_seed(0)
    for key in keys:
        want = js.sample_step(jnp.asarray(x), jcfg, key, jnp.asarray(c),
                              jnp.asarray(lens))
        got = ts.sample_step(_t(x), cfg, gen, _t(c), _t(lens))
        _eq(got, want)
        assert got.dtype == torch.int32


def test_stochastic_sample_step_needs_a_generator():
    with pytest.raises(ValueError, match="Generator"):
        ts.sample_step(_t(_logits(0)), ts.SamplingConfig(top_k=3))


def test_gumbel_noise_is_jax_gumbel_in_law_and_seeded():
    gen = torch.Generator().manual_seed(3)
    g = ts.gumbel_noise((64, 4096), gen)
    assert g.dtype == torch.float32 and g.shape == (64, 4096)
    assert torch.isfinite(g).all()
    again = ts.gumbel_noise((64, 4096), torch.Generator().manual_seed(3))
    assert torch.equal(g, again)
    u = torch.rand((64, 4096), generator=torch.Generator().manual_seed(3))
    assert torch.equal(g, -torch.log(-torch.log(u.clamp_min(ts._TINY))))
    # Gumbel(0, 1): mean Euler's gamma, variance pi^2 / 6, as JAX's
    j = np.asarray(jax.random.gumbel(jax.random.PRNGKey(0), (64, 4096)))
    for sample in (g.numpy(), j):
        assert abs(sample.mean() - 0.5772) < 0.02
        assert abs(sample.var() - np.pi ** 2 / 6) < 0.05


def test_sampling_config_properties_match_jax():
    for kw in SAMPLE_CONFIGS + [dict(bad_words=((4,), (5, 6, 7))),
                                dict(stop_words=((1, 2),)),
                                dict(bad_words=((9,),), stop_words=((3,),))]:
        a, b = ts.SamplingConfig(**kw), js.SamplingConfig(**kw)
        assert (a.tail_len, a.is_greedy) == (b.tail_len, b.is_greedy)
    assert not hasattr(ts.SamplingConfig, "check_supported")


def _slot_cfgs():
    return [
        ts.SamplingConfig(),
        ts.SamplingConfig(temperature=0.7, top_k=5),
        ts.SamplingConfig(top_p=0.9, repetition_penalty=1.2),
        ts.SamplingConfig(top_k=1, top_p=0.5, presence_penalty=0.3,
                          frequency_penalty=0.1, min_length=3,
                          bad_words=((7,), (5, 9))),
        ts.SamplingConfig(temperature=0.0, top_k=12, min_length=6,
                          bad_words=((1, 2, 3),)),
    ]


def _slot_params(n=6, w=3, l=3):
    p = ts.SlotSamplingParams.neutral(n, w, l)
    jp = js.SlotSamplingParams.neutral(n, w, l)
    for slot, cfg in enumerate(_slot_cfgs()):
        jcfg = js.SamplingConfig(**{f.name: getattr(cfg, f.name) for f in
                                    __import__("dataclasses").fields(cfg)})
        p, jp = p.set_slot(slot, cfg), jp.set_slot(slot, jcfg)
    return p, jp


def test_slot_params_equal_jax():
    p, jp = _slot_params()
    for got, want in zip(p, jp):
        _eq(got, want)
    for got, want in zip(ts.SlotSamplingParams.neutral(4),
                         js.SlotSamplingParams.neutral(4)):
        if want is None:
            assert got is None
        else:
            _eq(got, want)
    before = p.temperature.clone()
    p.set_slot(5, ts.SamplingConfig(temperature=0.5))
    assert torch.equal(p.temperature, before)       # a new tensor, not this


@pytest.mark.parametrize("bad", [((1, 2, 3, 4),), ((),), ((1,),) * 4])
def test_slot_params_refuse_what_jax_refuses(bad):
    for mod in (ts, js):
        with pytest.raises(ValueError, match="capacity"):
            mod.SlotSamplingParams.neutral(2, 3, 3).set_slot(
                0, mod.SamplingConfig(bad_words=bad))
        with pytest.raises(ValueError, match="max_bad_words"):
            mod.SlotSamplingParams.neutral(2).set_slot(
                0, mod.SamplingConfig(bad_words=((1,),)))


def _tails():
    # slot 3's history ends (5,) so its (5, 9) word bans 9; slot 4's ends
    # (1, 2) so (1, 2, 3) bans 3; -2 marks positions before generation
    return np.array([[-2, -2], [4, 4], [8, 5], [-2, 5], [1, 2], [0, 0]],
                    np.int32)


@pytest.mark.parametrize("with_tail", [False, True])
def test_ban_bad_words_slots_bit_equal(with_tail):
    p, jp = _slot_params()
    x = _logits(8, b=6, v=16, ties=False)
    tail = _tails() if with_tail else None
    got = ts.ban_bad_words_slots(_t(x), p, None if tail is None else _t(tail))
    want = js.ban_bad_words_slots(jnp.asarray(x), jp,
                                  None if tail is None else jnp.asarray(tail))
    _eq(got, want)
    assert got[3, 7] == x[3, 7] + np.float32(ts.NEG_INF)
    if with_tail:
        assert got[3, 9] < -1e8 and got[4, 3] < -1e8


def _near_top_p_cut(x, t, top_p, eps=2.0 ** -20):
    """[S, V] bool: entries whose top-p decision lies within float rounding
    of the cut: the f64 mass of the logits before them (x / t sorted
    descending) within eps of p (1.0 for a slot without top-p). There the
    two packages' exp and cumulative sums, which round differently, decide
    (XLA's f32 exp differs from torch's in the last bit for ~9% of values);
    everywhere else the filtered logits are bit-equal."""
    z = x.astype(np.float64) / np.where(t > 0, t, 1.0)[:, None]
    p_eff = np.where((top_p > 0) & (top_p < 1), top_p, 1.0)[:, None]
    order = np.argsort(-z, axis=1, kind="stable")
    zs = np.take_along_axis(z, order, 1)
    e = np.exp(zs - zs[:, :1])
    before = np.cumsum(e / e.sum(1, keepdims=True), 1) - e / e.sum(
        1, keepdims=True)
    near = np.zeros(x.shape, bool)
    np.put_along_axis(near, order, np.abs(before - p_eff) < eps, 1)
    return near


def test_transform_slots_bit_equal_with_ties():
    p, jp = _slot_params()
    x = _logits(9, b=6)
    got = ts.transform_slots(_t(x), p).numpy()
    want = np.asarray(js.transform_slots(jnp.asarray(x), jp))
    near = _near_top_p_cut(x, p.temperature.numpy(), p.top_p.numpy())
    np.testing.assert_array_equal(got[~near], want[~near])


@pytest.mark.parametrize("with_tail", [False, True])
def test_sample_step_slots_tokens_equal_jax_with_its_noise(monkeypatch,
                                                           with_tail):
    p, jp = _slot_params()
    x, c = _logits(10, b=6, v=16, ties=False), _counts(11, b=6, v=16)
    gen_lens = np.array([0, 1, 2, 2, 5, 7], np.int32)
    tail = _tails() if with_tail else None
    keys = jax.random.split(jax.random.PRNGKey(4), 4)
    monkeypatch.setattr(ts, "gumbel_noise", _noise_from(keys))
    gen = torch.Generator().manual_seed(0)
    for key in keys:
        want = js.sample_step_slots(
            jnp.asarray(x), jp, key, jnp.asarray(c), jnp.asarray(gen_lens),
            3, None if tail is None else jnp.asarray(tail))
        got = ts.sample_step_slots(
            _t(x), p, gen, _t(c), _t(gen_lens), 3,
            None if tail is None else _t(tail))
        _eq(got, want)


def test_tail_bad_and_stop_words_bit_equal():
    tail = np.array([[3, 4, 5], [4, 5, 6], [0, 0, 5], [9, 4, 5]], np.int32)
    toks = np.array([6, 7, 8, 9], np.int32)
    _eq(ts.update_tail(_t(tail), _t(toks)),
        js.update_tail(jnp.asarray(tail), jnp.asarray(toks)))
    for seq in ((), (5,), (4, 5), (3, 4, 5), (2, 3, 4, 5), (6,)):
        _eq(ts._tail_matches(_t(tail), seq),
            js._tail_matches(jnp.asarray(tail), seq))
    x = _logits(12, b=4, v=16, ties=False)
    words = ((7,), (4, 5, 11), (5, 3), (9, 4, 5, 6))
    _eq(ts.apply_bad_words(_t(x), _t(tail), words),
        js.apply_bad_words(jnp.asarray(x), jnp.asarray(tail), words))
    for stops in ((), ((5,),), ((4, 5), (6,)), ((9, 4, 5),)):
        _eq(ts.stop_words_matched(_t(tail), stops),
            js.stop_words_matched(jnp.asarray(tail), stops))


def test_token_counts_bit_equal():
    rng = np.random.default_rng(13)
    ids = rng.integers(0, 20, (3, 9)).astype(np.int32)
    lens = np.array([9, 4, 1], np.int32)
    want = js.init_token_counts(jnp.asarray(ids), jnp.asarray(lens), 20)
    got = ts.init_token_counts(_t(ids), _t(lens), 20)
    _eq(got, want)
    toks = np.array([3, 3, 19], np.int32)
    _eq(ts.update_token_counts(got, _t(toks)),
        js.update_token_counts(want, jnp.asarray(toks)))
