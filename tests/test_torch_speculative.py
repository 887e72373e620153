"""The port's speculative sessions against the JAX package's, on the CPU.

Both packages get the same seeded tiny f32 parameters (bridged from the JAX
tree as numpy) and the same prompts. Every case of tests/test_speculative.py
is held against JAX's SpeculativeSession / PromptLookupSession and against
the port's own GenerationSession: greedy tokens and lengths identical
(gamma 1 / 2 / 4 / 6, random and self drafts, EOS inside the slab, ragged
prompts, an int8 weight-only target with and without an int8 KV cache,
prompt lookup at three gamma / n-gram pairs, a periodic continuation it
accelerates, with iteration counts equal to JAX's), and stochastic runs
within JAX's total-variation bound of both (a random draft, and a self
draft that accepts everything). Rejected configurations raise as JAX's do.

Focused cases: the spare-column writes that stand in for JAX's dropped
scatter, at the last output column and the last history column, where a
clipped write would share a column with a valid one; the draft's catch-up
after rejections (its decode inputs and positions against JAX's over three
iterations); make_copy_params on int8, int4 g128, fp8 and bf16 params
(greedy emits the cycle, as JAX's does on the same params).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from trtllm_llama_tpu.config import EngineConfig as JaxEngineConfig
from trtllm_llama_tpu.config import ModelConfig as JaxConfig
from trtllm_llama_tpu.models import llama as jax_llama
from trtllm_llama_tpu.quantization.evaluate import (
    make_copy_params as jax_make_copy_params,
)
from trtllm_llama_tpu.quantization.mode import QuantMode as JaxQuantMode
from trtllm_llama_tpu.quantization.quantize import (
    quantize_params as jax_quantize_params,
)
from trtllm_llama_tpu.runtime.sampling import SamplingConfig as JaxSampling
from trtllm_llama_tpu.runtime.session import (
    GenerationSession as JaxGenerationSession,
)
from trtllm_llama_tpu.runtime.speculative import (
    PromptLookupSession as JaxPromptLookupSession,
)
from trtllm_llama_tpu.runtime.speculative import (
    SpeculativeSession as JaxSpeculativeSession,
)
from trtllm_llama_tpu_torch.config import EngineConfig, ModelConfig
from trtllm_llama_tpu_torch.convert.bridge import params_from_numpy
from trtllm_llama_tpu_torch.models import llama
from trtllm_llama_tpu_torch.quantization.evaluate import make_copy_params
from trtllm_llama_tpu_torch.quantization.mode import QuantMode
from trtllm_llama_tpu_torch.runtime.sampling import SamplingConfig
from trtllm_llama_tpu_torch.runtime.session import GenerationSession
from trtllm_llama_tpu_torch.runtime.speculative import (
    PromptLookupSession, SpeculativeSession, scatter_committed,
)

torch.set_num_threads(1)

TINY = dict(dtype="float32")
DRAFT = dict(dtype="float32", num_layers=1, hidden_size=64,
             intermediate_size=128, num_heads=2, num_kv_heads=2, head_dim=32)
ENGINE = dict(max_batch_size=2, max_input_len=16, max_seq_len=64)
CFG, JCFG = ModelConfig.tiny(**TINY), JaxConfig.tiny(**TINY)
DCFG, JDCFG = ModelConfig.tiny(**DRAFT), JaxConfig.tiny(**DRAFT)
ECFG, JECFG = EngineConfig(**ENGINE), JaxEngineConfig(**ENGINE)


def _port(jparams):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                             "cpu")


def _jax_sampling(scfg):
    return JaxSampling(**{f: getattr(scfg, f) for f in (
        "temperature", "top_k", "top_p", "repetition_penalty",
        "presence_penalty", "frequency_penalty", "min_length", "end_id",
        "pad_id", "beam_width", "length_penalty", "bad_words",
        "stop_words")})


@pytest.fixture(scope="module")
def setup():
    jparams = jax_llama.init_params(JCFG, jax.random.PRNGKey(0))
    jdparams = jax_llama.init_params(JDCFG, jax.random.PRNGKey(1))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, 250, (9,)).tolist(),
               rng.integers(3, 250, (5,)).tolist()]
    return dict(jparams=jparams, jdparams=jdparams, params=_port(jparams),
                dparams=_port(jdparams), prompts=prompts,
                base=GenerationSession(CFG, _port(jparams), ECFG,
                                       device="cpu"))


def _spec(setup, gamma, draft, **kw):
    """The port's and JAX's SpeculativeSession on the same parameters;
    draft: "random" (the 1-layer draft) or "self"."""
    s = setup
    if draft == "self":
        port = SpeculativeSession(CFG, s["params"], CFG, s["params"], ECFG,
                                  gamma=gamma, device="cpu", **kw)
        ref = JaxSpeculativeSession(JCFG, s["jparams"], JCFG, s["jparams"],
                                    JECFG, gamma=gamma, **kw)
    else:
        port = SpeculativeSession(CFG, s["params"], DCFG, s["dparams"], ECFG,
                                  gamma=gamma, device="cpu", **kw)
        ref = JaxSpeculativeSession(JCFG, s["jparams"], JDCFG, s["jdparams"],
                                    JECFG, gamma=gamma, **kw)
    return port, ref


def _same(got, *wants):
    for want in wants:
        np.testing.assert_array_equal(got.output_ids,
                                      np.asarray(want.output_ids))
        np.testing.assert_array_equal(got.lengths, np.asarray(want.lengths))


def _generate_both(port, ref, prompts, scfg, new, **kw):
    return (port.generate(prompts, sampling=scfg, max_new_tokens=new, **kw),
            ref.generate(prompts, sampling=_jax_sampling(scfg),
                         max_new_tokens=new, **kw))


@pytest.mark.parametrize("gamma", [1, 2, 4, 6])
@pytest.mark.parametrize("draft", ["random", "self"])
def test_matches_greedy(setup, gamma, draft):
    """A random draft proposes garbage (near-zero acceptance), a self draft
    is always accepted (gamma + 1 tokens an iteration); either way the
    tokens are the target's greedy decode, as JAX's session's."""
    scfg = SamplingConfig(end_id=-1)
    port, ref = _spec(setup, gamma, draft)
    got, want = _generate_both(port, ref, setup["prompts"], scfg, 24)
    plain = setup["base"].generate(setup["prompts"], sampling=scfg,
                                   max_new_tokens=24)
    _same(got, want, plain)
    # target weight reads: the prefill and one verify an iteration
    full = 1 + -(-23 // (gamma + 1))
    if draft == "self":
        assert port.last_iters == full
    else:
        assert full < port.last_iters <= 24


@pytest.mark.parametrize("end_id", [7, 62, None])
def test_eos_truncation(setup, end_id):
    """EOS inside an accepted slab (or as the bonus) truncates where plain
    decoding stops: JAX's two end ids, and (None) the fifth token of the
    first row's free run, so that a row surely ends early."""
    if end_id is None:
        end_id = int(setup["base"].generate(
            setup["prompts"], sampling=SamplingConfig(end_id=-1),
            max_new_tokens=5).output_ids[0, 4])
    scfg = SamplingConfig(end_id=end_id)
    port, ref = _spec(setup, 3, "random")
    got, want = _generate_both(port, ref, setup["prompts"], scfg, 24)
    plain = setup["base"].generate(setup["prompts"], sampling=scfg,
                                   max_new_tokens=24)
    _same(got, want, plain)
    assert end_id != 62 or (got.lengths < 24).any()


@pytest.mark.parametrize("scfg", [
    SamplingConfig(repetition_penalty=1.3),
    SamplingConfig(presence_penalty=0.5),
    SamplingConfig(bad_words=((5,),)),
    SamplingConfig(stop_words=((5, 6),)),
], ids=["repetition", "presence", "bad_words", "stop_words"])
def test_penalties_and_words_rejected(setup, scfg):
    port, ref = _spec(setup, 4, "random")
    for sess, cfg in ((port, scfg), (ref, _jax_sampling(scfg))):
        with pytest.raises(ValueError, match="not supported"):
            sess.generate(setup["prompts"], sampling=cfg, max_new_tokens=4)


def _tv(h1, h2):
    """Total-variation distance between two empirical histograms."""
    p = h1 / h1.sum()
    q = h2 / h2.sum()
    return 0.5 * np.abs(p - q).sum()


def _tv_noise(h1, h2):
    """JAX's bound (tests/test_speculative.py): 2.5 x the expected TV
    between two size-B empirical draws of one distribution."""
    b = h1.sum()
    p = (h1 + h2) / (h1.sum() + h2.sum())
    return 2.5 * 0.5 * np.sqrt(4 / (np.pi * b)) * np.sqrt(p).sum()


def _assert_same_distribution(got, *refs):
    for ref in refs:
        ref = np.asarray(ref)
        for step in range(got.shape[1]):
            h_got = np.bincount(got[:, step], minlength=256)
            h_ref = np.bincount(ref[:, step], minlength=256)
            thr = max(0.05, _tv_noise(h_got, h_ref))
            assert _tv(h_got, h_ref) < thr, (step, _tv(h_got, h_ref), thr)


def test_stochastic_matches_target_distribution(setup):
    """Rejection sampling emits tokens distributed as plain sampling from
    the target: B iid rows of one prompt, per-step marginals against the
    port's GenerationSession and JAX's speculative session. The draft is a
    mismatched random model, so rejections and residual draws occur."""
    scfg = SamplingConfig(end_id=-1, top_k=8, temperature=0.8)
    b = 4096
    prompt = np.tile(np.array([[7, 23, 101, 55, 200]], np.int32), (b, 1))
    port, ref = _spec(setup, 3, "random")
    got, want = _generate_both(port, ref, prompt, scfg, 3, seed=5)
    plain = setup["base"].generate(prompt, sampling=scfg, max_new_tokens=3,
                                   seed=11)
    assert (got.lengths == 3).all()
    _assert_same_distribution(got.output_ids, want.output_ids,
                              plain.output_ids)


def test_stochastic_self_draft_all_accept(setup):
    """draft == target: p == q, so every proposal is accepted and one
    iteration commits the whole budget; the marginals stay the target's."""
    scfg = SamplingConfig(end_id=-1, top_k=8, temperature=0.9)
    b = 2048
    prompt = np.tile(np.array([[9, 41, 3, 77]], np.int32), (b, 1))
    port, ref = _spec(setup, 4, "self")
    got, want = _generate_both(port, ref, prompt, scfg, 4, seed=3)
    plain = setup["base"].generate(prompt, sampling=scfg, max_new_tokens=4,
                                   seed=7)
    assert (got.lengths == 4).all() and port.last_iters == 2
    _assert_same_distribution(got.output_ids, want.output_ids,
                              plain.output_ids)


def test_vocab_mismatch_and_family_rejected(setup):
    bad = ModelConfig.tiny(vocab_size=128)
    with pytest.raises(ValueError, match="vocabulary"):
        SpeculativeSession(CFG, setup["params"], bad, setup["dparams"], ECFG,
                           device="cpu")
    with pytest.raises(ValueError, match="vocabulary"):
        JaxSpeculativeSession(JCFG, setup["jparams"],
                              JaxConfig.tiny(vocab_size=128),
                              setup["jdparams"], JECFG)

    class NoExtend:             # a family without forward_extend
        init_caches = staticmethod(llama.init_caches)
        forward_decode = staticmethod(llama.forward_decode)
    with pytest.raises(ValueError, match="forward_extend"):
        SpeculativeSession(CFG, setup["params"], DCFG, setup["dparams"],
                           ECFG, model=NoExtend, device="cpu")
    with pytest.raises(ValueError, match="forward_extend"):
        PromptLookupSession(CFG, setup["params"], ECFG, model=NoExtend,
                            device="cpu")


@pytest.mark.parametrize("with_kv", [False, True])
def test_quantized_target(setup, with_kv):
    """int8 weight-only targets, with and without an int8 KV cache: the
    verify slab writes and reads K/V through the codec as decode does."""
    qm = JaxQuantMode.use_weight_only(False)
    pm = QuantMode.use_weight_only(False)
    if with_kv:
        qm, pm = qm | JaxQuantMode.INT8_KV_CACHE, pm | QuantMode.INT8_KV_CACHE
    jcfg = JaxConfig.tiny(dtype="float32", quant_mode=qm)
    cfg = ModelConfig.tiny(dtype="float32", quant_mode=pm)
    jparams = jax_quantize_params(setup["jparams"], qm)
    params = _port(jparams)
    kvs = np.full((cfg.num_layers,), 0.05, np.float32) if with_kv else None
    scfg = SamplingConfig(end_id=-1)
    port = SpeculativeSession(cfg, params, DCFG, setup["dparams"], ECFG,
                              gamma=3, kv_scales=kvs, device="cpu")
    ref = JaxSpeculativeSession(jcfg, jparams, JDCFG, setup["jdparams"],
                                JECFG, gamma=3, kv_scales=kvs)
    got, want = _generate_both(port, ref, setup["prompts"], scfg, 16)
    plain = GenerationSession(cfg, params, ECFG, kv_scales=kvs,
                              device="cpu").generate(
        setup["prompts"], sampling=scfg, max_new_tokens=16)
    _same(got, want, plain)


# ---------------------------------------------------------------------------
# prompt lookup
# ---------------------------------------------------------------------------

def _lookup(setup, gamma, ngram, params=None, jparams=None):
    port = PromptLookupSession(CFG, params or setup["params"], ECFG,
                               gamma=gamma, ngram=ngram, device="cpu")
    ref = JaxPromptLookupSession(JCFG, jparams or setup["jparams"], JECFG,
                                 gamma=gamma, ngram=ngram)
    return port, ref


@pytest.mark.parametrize("gamma,ngram", [(4, 3), (2, 2), (6, 1)])
def test_prompt_lookup_matches_greedy(setup, gamma, ngram):
    """Whatever the lookup proposes, the tokens are the greedy decode's;
    the target weight reads equal JAX's."""
    scfg = SamplingConfig(end_id=-1)
    port, ref = _lookup(setup, gamma, ngram)
    got, want = _generate_both(port, ref, setup["prompts"], scfg, 24)
    plain = setup["base"].generate(setup["prompts"], sampling=scfg,
                                   max_new_tokens=24)
    _same(got, want, plain)
    assert port.last_iters == ref.last_iters <= 24


def test_prompt_lookup_accelerates_periodic_output(setup):
    """Seed 5's prompt drives this tiny model's greedy decode into a cycle
    (JAX's test probes it); the lookup then commits several tokens a
    target read, as many as JAX's."""
    scfg = SamplingConfig(end_id=-1)
    prompt = np.random.default_rng(5).integers(3, 250, (9,)).tolist()
    ref_plain = setup["base"].generate([prompt], sampling=scfg,
                                       max_new_tokens=24)
    out = ref_plain.output_ids[0].tolist()
    assert any(out[-2 * p:-p] == out[-p:] for p in range(1, 9)), (
        "premise broken: greedy output not periodic")
    port, ref = _lookup(setup, 4, 2)
    got, want = _generate_both(port, ref, [prompt], scfg, 24)
    _same(got, want, ref_plain)
    assert port.last_iters == ref.last_iters < 24


def test_prompt_lookup_eos_and_ragged(setup):
    scfg = SamplingConfig(end_id=7)
    port, ref = _lookup(setup, 3, 3)
    got, want = _generate_both(port, ref, setup["prompts"], scfg, 20)
    plain = setup["base"].generate(setup["prompts"], sampling=scfg,
                                   max_new_tokens=20)
    _same(got, want, plain)


def test_prompt_lookup_rejects_stochastic(setup):
    port, ref = _lookup(setup, 4, 3)
    scfg = SamplingConfig(end_id=-1, temperature=0.8, top_k=4)
    for sess, cfg in ((port, scfg), (ref, _jax_sampling(scfg))):
        with pytest.raises(ValueError, match="greedy-only"):
            sess.generate(setup["prompts"], sampling=cfg, max_new_tokens=8)


# ---------------------------------------------------------------------------
# focused cases
# ---------------------------------------------------------------------------

def test_spare_column_matches_dropped_scatter():
    """scatter_committed against JAX's `.at[].set(mode="drop")`: row 0
    commits two slots ending at the last real column, row 1 one slot; a
    clip of the uncommitted slots' columns would land on row 0's last
    column beside its valid write."""
    first = np.array([2, 0], np.int32)
    valid = np.array([[True, True, False], [True, False, False]])
    vals = np.array([[5, 6, 7], [8, 9, 10]], np.int32)
    width = 4
    col = np.where(valid, first[:, None] + np.arange(3)[None], width)
    clipped = np.minimum(col, width - 1)
    assert (clipped[0] == width - 1).sum() == 2      # the race a clip makes
    want = jnp.full((2, width), -1, jnp.int32).at[
        jnp.arange(2)[:, None], col].set(vals, mode="drop")
    buf = torch.full((2, width + 1), -1, dtype=torch.int32)
    scatter_committed(buf, torch.from_numpy(first), torch.from_numpy(valid),
                      torch.from_numpy(vals))
    np.testing.assert_array_equal(buf[:, :width].numpy(), np.asarray(want))


CYCLE = [11, 23, 5, 42, 17, 99, 3, 64]


@pytest.fixture(scope="module")
def copy_params(setup):
    jparams = jax_make_copy_params(JCFG, setup["jparams"], CYCLE)
    return jparams, make_copy_params(CFG, setup["params"], CYCLE)


def test_writes_at_the_last_columns(setup, copy_params):
    """A 16-token prompt (its bucket) and full acceptance on the copy
    model: the last iteration's budget-capped slab ends at the last output
    column and at the last history column (prompt + max_new), its
    uncommitted slots going to the spare column; tokens equal JAX's and
    the cycle's successors, for prompt lookup and a self draft."""
    jparams, params = copy_params
    prompt = CYCLE * 2                   # 16 tokens: the bucket, no padding
    scfg = SamplingConfig(end_id=-1)
    new = 9                              # 1 + 5 + 3: the last slab is cut
    succ = [CYCLE[(i + 1) % len(CYCLE)] for i in range(len(CYCLE))]
    want_ids = [succ[(len(prompt) - 1 + i) % len(CYCLE)] for i in range(new)]
    for port, ref in (_lookup(setup, 4, 3, params, jparams),
                      (SpeculativeSession(CFG, params, CFG, params, ECFG,
                                          gamma=4, device="cpu"),
                       JaxSpeculativeSession(JCFG, jparams, JCFG, jparams,
                                             JECFG, gamma=4))):
        got, want = _generate_both(port, ref, [prompt], scfg, new)
        _same(got, want)
        assert got.output_ids[0].tolist() == want_ids
        assert port.last_iters == 1 + 2     # the prefill and two verifies


class _Recorder:
    """A model that forwards to `model` and records each forward_decode's
    tokens and positions as numpy (JAX's under jax.disable_jit)."""

    def __init__(self, model):
        self._model = model
        self.steps = []

    def __getattr__(self, name):
        return getattr(self._model, name)

    def forward_decode(self, params, cfg, tokens, positions, caches, **kw):
        self.steps.append((np.asarray(tokens).copy(),
                           np.asarray(positions).copy()))
        return self._model.forward_decode(params, cfg, tokens, positions,
                                          caches, **kw)


def test_draft_catch_up_matches_jax(setup):
    """A draft that agrees with the target only in part (its weights
    perturbed): over three iterations the draft's decode inputs (committed
    tokens where it lags, its own picks after) and positions (draft_pos +
    j) equal JAX's, through accepted and rejected proposals."""
    noise = np.random.default_rng(3)
    jd = jax.tree_util.tree_map(
        lambda a: a + 0.1 * np.std(np.asarray(a))
        * noise.standard_normal(np.shape(a)).astype(np.float32)
        if np.ndim(a) >= 2 else a, setup["jparams"])
    gamma, new = 4, 4
    port_rec, jax_rec = _Recorder(llama), _Recorder(jax_llama)
    port = SpeculativeSession(CFG, setup["params"], CFG, _port(jd), ECFG,
                              gamma=gamma, draft_model=port_rec, device="cpu")
    ref = JaxSpeculativeSession(JCFG, setup["jparams"], JCFG, jd, JECFG,
                                gamma=gamma, draft_model=jax_rec)
    scfg = SamplingConfig(end_id=-1)
    got = port.generate(setup["prompts"], sampling=scfg, max_new_tokens=10)
    with jax.disable_jit():
        want = ref.generate(setup["prompts"], sampling=_jax_sampling(scfg),
                            max_new_tokens=10)
    _same(got, want)
    steps = 3 * (gamma + 1)
    assert len(port_rec.steps) >= steps and len(jax_rec.steps) >= steps
    for (pt, pp), (jt, jp) in zip(port_rec.steps[:steps],
                                  jax_rec.steps[:steps]):
        np.testing.assert_array_equal(pt, jt)
        np.testing.assert_array_equal(pp, jp)
    # draft_pos at the start of each iteration is the first step's position;
    # a draft behind the committed prefix (a rejection) catches up
    starts = [port_rec.steps[i * (gamma + 1)][1] for i in range(3)]
    lens = np.array([len(p) for p in setup["prompts"]])
    assert (starts[0] == lens).all()
    advanced = np.diff(np.stack(starts), axis=0)     # n + 1 a row
    assert (advanced == 1).any(), advanced              # all rejected
    assert ((advanced > 1) & (advanced < gamma + 1)).any(), advanced


@pytest.mark.parametrize("fmt", ["int8", "int4 g128", "fp8", "bf16"])
def test_make_copy_params_emits_the_cycle(fmt):
    """make_copy_params on each weight container: the port's lm_head is
    JAX's, and greedy decoding of a prompt that repeats the cycle emits the
    cycle's successors in both packages."""
    modes = {"int8": (JaxQuantMode.use_weight_only(False),
                      QuantMode.use_weight_only(False), 0),
             "int4 g128": (JaxQuantMode.use_weight_only(True, per_group=True),
                           QuantMode.use_weight_only(True, per_group=True),
                           128),
             "fp8": (JaxQuantMode.FP8_QDQ, QuantMode.FP8_QDQ, 0),
             "bf16": (JaxQuantMode(0), QuantMode(0), 0)}
    jqm, qm, g = modes[fmt]
    dtype = "bfloat16" if fmt == "bf16" else "float32"
    jcfg = JaxConfig.tiny(dtype=dtype, quant_mode=jqm, group_size=g)
    cfg = ModelConfig.tiny(dtype=dtype, quant_mode=qm, group_size=g)
    jparams = jax_llama.init_params(jcfg, jax.random.PRNGKey(4))
    if fmt != "bf16":
        jparams = jax_quantize_params(jparams, jqm, group_size=g)
    jcopy = jax_make_copy_params(jcfg, jparams, CYCLE)
    copy = make_copy_params(cfg, _port(jparams), CYCLE)
    np.testing.assert_array_equal(
        copy["lm_head"].float().numpy(),
        np.asarray(jcopy["lm_head"]).astype(np.float32))
    prompt = [CYCLE * 2]
    want = [CYCLE[(len(CYCLE) - 1 + 1 + i) % len(CYCLE)] for i in range(12)]
    scfg = SamplingConfig(end_id=-1)
    got = GenerationSession(cfg, copy, ECFG, device="cpu").generate(
        prompt, sampling=scfg, max_new_tokens=12)
    ref = JaxGenerationSession(jcfg, jcopy, JECFG).generate(
        prompt, sampling=_jax_sampling(scfg), max_new_tokens=12)
    assert got.output_ids[0].tolist() == want
    assert np.asarray(ref.output_ids)[0].tolist() == want
