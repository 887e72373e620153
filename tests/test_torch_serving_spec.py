"""The port's speculative serving engines against the JAX package's, on the
CPU.

Both packages get the same seeded tiny f32 parameters (bridged as numpy)
and the same script of submissions and steps. Every case of
tests/test_serving_spec.py is held against JAX's SpeculativeServingEngine /
PromptLookupServingEngine and against the port's plain ServingEngine:
every request's tokens and finish reason identical (random and self
drafts, gamma 1 and 3, a request arriving mid-flight, EOS with logprobs
within 1e-5 of JAX's engine and of the port's session, an int8
weight-only target with an int8 KV cache, greedy requests beside
stochastic ones, prompt lookup at mid-flight arrivals, on the copy model,
at zero acceptance and with stop words), the verify iterations and the
committed tokens equal JAX's, stochastic requests within JAX's
total-variation bound of the port's plain engine and of JAX's speculative
engine, and the configurations JAX's engines refuse refused. The capacity
estimate counts the draft's cache and, but for a self draft, its weights.
"""

import numpy as np
import pytest
import torch
import jax

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
from trtllm_llama_tpu.runtime.serving_spec import (
    PromptLookupServingEngine as JaxPromptLookupEngine,
)
from trtllm_llama_tpu.runtime.serving_spec import (
    SpeculativeServingEngine as JaxSpecEngine,
)
from trtllm_llama_tpu_torch.config import EngineConfig, ModelConfig
from trtllm_llama_tpu_torch.convert.bridge import params_from_numpy
from trtllm_llama_tpu_torch.quantization.evaluate import make_copy_params
from trtllm_llama_tpu_torch.quantization.mode import QuantMode
from trtllm_llama_tpu_torch.runtime.sampling import SamplingConfig
from trtllm_llama_tpu_torch.runtime.serving import ServingEngine
from trtllm_llama_tpu_torch.runtime.serving_spec import (
    PromptLookupServingEngine, SpeculativeServingEngine,
)
from trtllm_llama_tpu_torch.runtime.session import GenerationSession

torch.set_num_threads(1)

TINY = dict(dtype="float32")
DRAFT = dict(dtype="float32", num_layers=1, hidden_size=64,
             intermediate_size=128, num_heads=2, num_kv_heads=2, head_dim=32)
ENGINE = dict(max_batch_size=3, max_input_len=16, max_seq_len=48)
CFG, JCFG = ModelConfig.tiny(**TINY), JaxConfig.tiny(**TINY)
DCFG, JDCFG = ModelConfig.tiny(**DRAFT), JaxConfig.tiny(**DRAFT)
ECFG, JECFG = EngineConfig(**ENGINE), JaxEngineConfig(**ENGINE)
SCFG = SamplingConfig(end_id=-1)


def _port(jparams):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                             "cpu")


def _jax_sampling(scfg):
    if scfg is None:
        return None
    return JaxSampling(**{f: getattr(scfg, f) for f in (
        "temperature", "top_k", "top_p", "repetition_penalty",
        "presence_penalty", "frequency_penalty", "min_length", "end_id",
        "pad_id", "beam_width", "length_penalty", "bad_words",
        "stop_words")})


@pytest.fixture(scope="module")
def setup():
    jparams = jax_llama.init_params(JCFG, jax.random.PRNGKey(5))
    jdparams = jax_llama.init_params(JDCFG, jax.random.PRNGKey(1))
    return dict(jparams=jparams, jdparams=jdparams, params=_port(jparams),
                dparams=_port(jdparams))


def _plain(params, prompts, new_tokens, scfg=SCFG, cfg=CFG, **kw):
    eng = ServingEngine(cfg, params, ECFG, sampling=scfg, decode_chunk=3,
                        device="cpu", **kw)
    rids = [eng.submit(p, n) for p, n in zip(prompts, new_tokens)]
    done = eng.run_to_completion()
    return [done[r] for r in rids]


def _spec(setup, gamma, draft, scfg=SCFG, **kw):
    """The port's and JAX's SpeculativeServingEngine; draft: "random" (the
    1-layer draft) or "self"."""
    s = setup
    if draft == "self":
        pd, jd, dcfg, jdcfg = s["params"], s["jparams"], CFG, JCFG
    else:
        pd, jd, dcfg, jdcfg = s["dparams"], s["jdparams"], DCFG, JDCFG
    port = SpeculativeServingEngine(CFG, s["params"], dcfg, pd, ECFG,
                                    gamma=gamma, sampling=scfg, device="cpu",
                                    **kw)
    ref = JaxSpecEngine(JCFG, s["jparams"], jdcfg, jd, JECFG, gamma=gamma,
                        sampling=_jax_sampling(scfg), **kw)
    return port, ref


def _serve(eng, prompts, new_tokens, cfgs=None, jax_side=False):
    cfgs = cfgs or [None] * len(prompts)
    conv = _jax_sampling if jax_side else (lambda c: c)
    rids = [eng.submit(p, n, sampling=conv(c))
            for p, n, c in zip(prompts, new_tokens, cfgs)]
    done = eng.run_to_completion()
    return [done[r] for r in rids]


def _same_requests(got, *wants):
    for want in wants:
        assert [(f.output_ids, f.finished_reason) for f in got] == [
            (f.output_ids, f.finished_reason) for f in want]


def _same_counts(port, ref):
    assert (port.spec_iters, port.spec_committed) == (ref.spec_iters,
                                                      ref.spec_committed)


@pytest.mark.parametrize("gamma", [1, 3])
@pytest.mark.parametrize("draft", ["random", "self"])
def test_spec_serving_matches_plain(setup, gamma, draft):
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, 250, (n,)).tolist() for n in (5, 9, 3, 7, 11)]
    new_tokens = [6, 4, 8, 5, 7]
    port, ref = _spec(setup, gamma, draft, decode_chunk=4)
    got = _serve(port, prompts, new_tokens)
    _same_requests(got, _serve(ref, prompts, new_tokens, jax_side=True),
                   _plain(setup["params"], prompts, new_tokens))
    _same_counts(port, ref)
    if draft == "self":
        assert port.spec_committed > port.spec_iters


def test_spec_serving_self_draft_and_streaming_arrivals(setup):
    """Self draft (every proposal accepted) and a request arriving
    mid-flight."""
    rng = np.random.default_rng(2)
    p1 = rng.integers(3, 250, (6,)).tolist()
    p2 = rng.integers(3, 250, (9,)).tolist()
    want = _plain(setup["params"], [p1, p2], [8, 6])
    runs = []
    for eng in _spec(setup, 4, "self", decode_chunk=5):
        r1 = eng.submit(p1, 8)
        done = {fr.request_id: fr for fr in eng.step()}
        r2 = eng.submit(p2, 6)
        done.update(eng.run_to_completion())
        runs.append([done[r1], done[r2]])
    _same_requests(runs[0], runs[1], want)


def test_spec_serving_eos_and_logprobs(setup):
    rng = np.random.default_rng(3)
    prompt = rng.integers(3, 250, (6,)).tolist()
    free = _plain(setup["params"], [prompt], [6])[0]
    scfg = SamplingConfig(end_id=free.output_ids[2])
    want = _plain(setup["params"], [prompt], [6], scfg)[0]
    port, ref = _spec(setup, 3, "random", scfg=scfg, decode_chunk=4,
                      return_logprobs=True)
    got = _serve(port, [prompt], [6])[0]
    jgot = _serve(ref, [prompt], [6], jax_side=True)[0]
    assert got.finished_reason == "eos"
    _same_requests([got], [jgot], [want])
    sess = GenerationSession(CFG, setup["params"], EngineConfig(**ENGINE),
                             device="cpu").generate(
        [prompt], sampling=scfg, max_new_tokens=6, return_logprobs=True)
    n = len(got.output_ids)
    np.testing.assert_allclose(got.logprobs, sess.logprobs[0][:n], atol=1e-5)
    np.testing.assert_allclose(got.logprobs, jgot.logprobs, atol=1e-5)


def test_spec_serving_validation(setup):
    s = setup
    for cls, params, dparams, cfg, dcfg, ecfg, kw in (
            (SpeculativeServingEngine, s["params"], s["dparams"], CFG,
             ModelConfig.tiny(vocab_size=128), ECFG, dict(device="cpu")),
            (JaxSpecEngine, s["jparams"], s["jdparams"], JCFG,
             JaxConfig.tiny(vocab_size=128), JECFG, {})):
        conv = _jax_sampling if cls is JaxSpecEngine else (lambda c: c)
        with pytest.raises(ValueError, match="per_request_sampling"):
            cls(cfg, params, dcfg, dparams, ecfg,
                sampling=conv(SamplingConfig(top_k=4)), **kw)
        with pytest.raises(ValueError, match="vocabulary"):
            cls(cfg, params, dcfg, dparams, ecfg, **kw)


def test_spec_serving_quantized_target(setup):
    """An int8 weight-only target with an int8 KV cache: outputs equal the
    plain engine's and JAX's speculative engine's."""
    qm = JaxQuantMode.use_weight_only(False) | JaxQuantMode.INT8_KV_CACHE
    pm = QuantMode.use_weight_only(False) | QuantMode.INT8_KV_CACHE
    jcfg = JaxConfig.tiny(dtype="float32", quant_mode=qm)
    cfg = ModelConfig.tiny(dtype="float32", quant_mode=pm)
    jparams = jax_quantize_params(setup["jparams"], qm)
    params = _port(jparams)
    kvs = np.full((cfg.num_layers,), 0.05, np.float32)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(3, 250, (n,)).tolist() for n in (5, 8)]
    want = _plain(params, prompts, [6, 6], cfg=cfg, kv_scales=kvs)
    port = SpeculativeServingEngine(cfg, params, DCFG, setup["dparams"],
                                    ECFG, gamma=3, sampling=SCFG,
                                    decode_chunk=4, kv_scales=kvs,
                                    device="cpu")
    ref = JaxSpecEngine(jcfg, jparams, JDCFG, setup["jdparams"], JECFG,
                        gamma=3, sampling=_jax_sampling(SCFG),
                        decode_chunk=4, kv_scales=kvs)
    _same_requests(_serve(port, prompts, [6, 6]), want,
                   _serve(ref, prompts, [6, 6], jax_side=True))
    _same_counts(port, ref)


def _tv(h1, h2):
    p = h1 / h1.sum()
    q = h2 / h2.sum()
    return 0.5 * np.abs(p - q).sum()


def _tv_noise(h1, h2):
    """JAX's bound (tests/test_serving_spec.py)."""
    b = h1.sum()
    p = (h1 + h2) / (h1.sum() + h2.sum())
    return 2.5 * 0.5 * np.sqrt(4 / (np.pi * b)) * np.sqrt(p).sum()


def test_spec_serving_stochastic_matches_plain_distribution(setup):
    """Rejection sampling under continuous batching: B iid requests of one
    prompt through a wide slot pool, per-step marginals against the port's
    plain per-request engine and JAX's speculative engine."""
    b = 768
    ecfg = dict(max_batch_size=b, max_input_len=16, max_seq_len=24)
    prompt = [7, 23, 101, 55, 200]
    scfg = SamplingConfig(end_id=-1, top_k=8, temperature=0.8)
    plain = ServingEngine(CFG, setup["params"], EngineConfig(**ecfg),
                          sampling=SCFG, decode_chunk=3,
                          per_request_sampling=True, device="cpu")
    port = SpeculativeServingEngine(CFG, setup["params"], DCFG,
                                    setup["dparams"], EngineConfig(**ecfg),
                                    gamma=3, sampling=SCFG, decode_chunk=4,
                                    per_request_sampling=True, device="cpu")
    ref = JaxSpecEngine(JCFG, setup["jparams"], JDCFG, setup["jdparams"],
                        JaxEngineConfig(**ecfg), gamma=3,
                        sampling=_jax_sampling(SCFG), decode_chunk=4,
                        per_request_sampling=True)
    outs = [np.array([f.output_ids for f in _serve(
        eng, [prompt] * b, [3] * b, [scfg] * b, jax_side=eng is ref)])
        for eng in (port, plain, ref)]
    assert all(o.shape == (b, 3) for o in outs)
    got = outs[0]
    for other in outs[1:]:
        for step in range(3):
            h_got = np.bincount(got[:, step], minlength=256)
            h_ref = np.bincount(other[:, step], minlength=256)
            thr = max(0.05, _tv_noise(h_got, h_ref))
            assert _tv(h_got, h_ref) < thr, (step, _tv(h_got, h_ref), thr)


def test_spec_serving_mixed_greedy_stochastic_exactness(setup):
    """Greedy requests beside a stochastic one keep the argmax-prefix
    acceptance: their tokens equal the plain greedy engine's and JAX's."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(3, 250, (n,)).tolist() for n in (5, 9, 7)]
    new_tokens = [6, 5, 7]
    want = _plain(setup["params"], prompts, new_tokens)
    stoch = SamplingConfig(end_id=-1, top_k=4, temperature=1.2)
    cfgs = [None, stoch, None]
    port, ref = _spec(setup, 2, "random", decode_chunk=4,
                      per_request_sampling=True)
    got = _serve(port, prompts, new_tokens, cfgs)
    jgot = _serve(ref, prompts, new_tokens, cfgs, jax_side=True)
    for i in (0, 2):
        _same_requests([got[i]], [want[i]], [jgot[i]])
    assert len(got[1].output_ids) == new_tokens[1]


def test_spec_serving_stochastic_needs_per_request(setup):
    with pytest.raises(ValueError, match="per_request_sampling"):
        SpeculativeServingEngine(CFG, setup["params"], DCFG,
                                 setup["dparams"], ECFG,
                                 sampling=SamplingConfig(end_id=-1, top_k=4),
                                 device="cpu")


@pytest.mark.parametrize("bad", [
    SamplingConfig(end_id=-1, repetition_penalty=1.3),
    SamplingConfig(end_id=-1, frequency_penalty=0.5),
    SamplingConfig(end_id=-1, min_length=3),
    SamplingConfig(end_id=-1, bad_words=((5,),)),
    SamplingConfig(end_id=-1, beam_width=2),
], ids=["repetition", "frequency", "min_length", "bad_words", "beams"])
def test_spec_serving_rejects_unsupported_features(setup, bad):
    port, ref = _spec(setup, 4, "random", per_request_sampling=True)
    for eng, cfg in ((port, bad), (ref, _jax_sampling(bad))):
        with pytest.raises(ValueError, match="penalties"):
            eng.submit([5, 6, 7], 4, sampling=cfg)
    with pytest.raises(ValueError, match="penalties"):
        SpeculativeServingEngine(CFG, setup["params"], DCFG,
                                 setup["dparams"], ECFG, sampling=bad,
                                 per_request_sampling=True, device="cpu")


def test_capacity_estimate_counts_the_draft(setup, monkeypatch):
    """The estimate adds the draft cache (max_seq_len + gamma + 1 rows,
    rounded to 128, on every slot and the trash row) and the draft's
    weights, none for a self draft; a budget between the plain and the
    speculative need admits the plain engine and refuses the speculative
    one."""
    gamma = 3
    plain = ServingEngine(CFG, setup["params"], ECFG,
                          cache_headroom=gamma + 1, device="cpu")
    base = plain._capacity_estimate(setup["params"], 64, None)
    port, _ = _spec(setup, gamma, "random")
    est = port._capacity_estimate(setup["params"], 64, None)
    rows = -(-(ENGINE["max_seq_len"] + gamma + 1) // 128) * 128
    draft_kv = (2 * DCFG.num_layers * DCFG.num_kv_heads * DCFG.head_dim
                * (ENGINE["max_batch_size"] + 1) * rows * 4)
    draft_w = sum(t.numel() * 4 for t in (
        setup["dparams"]["embed"], setup["dparams"]["lm_head"],
        setup["dparams"]["final_norm"], *setup["dparams"]["layers"].values()))
    assert est["draft_kv"] == draft_kv and est["draft_weights"] == draft_w
    assert est["need"] == base["need"] + draft_kv + draft_w
    selfd = SpeculativeServingEngine(CFG, setup["params"], CFG,
                                     setup["params"], ECFG, gamma=gamma,
                                     device="cpu")
    est_self = selfd._capacity_estimate(setup["params"], 64, None)
    assert est_self["draft_weights"] == 0
    assert est_self["need"] == base["need"] + est_self["draft_kv"]
    monkeypatch.setenv("TLLM_HBM_BYTES", str(base["need"]))
    ServingEngine(CFG, setup["params"], ECFG, cache_headroom=gamma + 1,
                  device="cpu")
    with pytest.raises(ValueError, match="budget"):
        SpeculativeServingEngine(CFG, setup["params"], DCFG,
                                 setup["dparams"], ECFG, gamma=gamma,
                                 device="cpu")


# ---------------------------------------------------------------------------
# PromptLookupServingEngine
# ---------------------------------------------------------------------------

def _lookup(setup, params=None, jparams=None, scfg=SCFG, **kw):
    port = PromptLookupServingEngine(CFG, params or setup["params"], ECFG,
                                     sampling=scfg, device="cpu", **kw)
    ref = JaxPromptLookupEngine(JCFG, jparams or setup["jparams"], JECFG,
                                sampling=_jax_sampling(scfg), **kw)
    return port, ref


def test_prompt_lookup_serving_matches_plain(setup):
    """Mixed lengths and mid-flight arrivals: the plain engine's tokens."""
    rng = np.random.default_rng(7)
    prompts = [rng.integers(3, 250, (n,)).tolist() for n in (5, 9, 3, 7)]
    new_tokens = [6, 4, 8, 7]
    want = _plain(setup["params"], prompts, new_tokens)
    runs = []
    for eng in _lookup(setup, gamma=3, ngram=2, decode_chunk=4):
        rids = [eng.submit(p, n) for p, n in zip(prompts[:2],
                                                 new_tokens[:2])]
        done = {fr.request_id: fr for fr in eng.step()}
        rids += [eng.submit(p, n) for p, n in zip(prompts[2:],
                                                  new_tokens[2:])]
        done.update(eng.run_to_completion())
        runs.append([done[r] for r in rids])
    _same_requests(runs[0], runs[1], want)


def test_prompt_lookup_serving_accepts_on_repetition(setup):
    """On the copy model the lookup proposes the cycle and the engine
    commits more tokens than it runs verify iterations (as many as JAX's),
    the tokens the plain engine's and the cycle's."""
    cycle = [11, 23, 5, 42]
    jcp = jax_make_copy_params(JCFG, setup["jparams"], cycle)
    cp = make_copy_params(CFG, setup["params"], cycle)
    prompt = cycle * 3
    want = _plain(cp, [prompt], [10])
    assert want[0].output_ids == [cycle[i % 4] for i in range(10)]
    port, ref = _lookup(setup, cp, jcp, gamma=4, ngram=2, decode_chunk=10)
    _same_requests(_serve(port, [prompt], [10]), want,
                   _serve(ref, [prompt], [10], jax_side=True))
    _same_counts(port, ref)
    assert port.spec_committed > port.spec_iters


def test_prompt_lookup_zero_acceptance_budget(setup):
    """Weight-read budgeting on a model that never copies: a chunk still
    commits at least one token an iteration, and the stream stays the
    plain engine's."""
    rng = np.random.default_rng(3)
    prompt = rng.integers(3, 250, (7,)).tolist()
    want = _plain(setup["params"], [prompt], [9])
    port, ref = _lookup(setup, gamma=4, ngram=2, decode_chunk=9)
    _same_requests(_serve(port, [prompt], [9]), want,
                   _serve(ref, [prompt], [9], jax_side=True))
    _same_counts(port, ref)
    assert 0 < port.spec_iters <= port.spec_committed


def test_prompt_lookup_serving_rejects_stochastic(setup):
    scfg = SamplingConfig(end_id=-1, top_k=5, temperature=0.7)
    with pytest.raises(ValueError, match="greedy"):
        PromptLookupServingEngine(CFG, setup["params"], ECFG, sampling=scfg,
                                  device="cpu")
    with pytest.raises(ValueError, match="greedy"):
        JaxPromptLookupEngine(JCFG, setup["jparams"], JECFG,
                              sampling=_jax_sampling(scfg))


def test_prompt_lookup_serving_stop_words(setup):
    """Host-side stop words on the speculative slab: the request ends where
    its stop token is first committed."""
    rng = np.random.default_rng(9)
    prompt = rng.integers(3, 250, (6,)).tolist()
    free = _plain(setup["params"], [prompt], [8])[0]
    scfg = SamplingConfig(end_id=-1, stop_words=((free.output_ids[3],),))
    want = _plain(setup["params"], [prompt], [8], scfg)
    port, ref = _lookup(setup, scfg=scfg, gamma=3, decode_chunk=4)
    got = _serve(port, [prompt], [8])
    _same_requests(got, want, _serve(ref, [prompt], [8], jax_side=True))
    assert got[0].output_ids == free.output_ids[:4]
    assert got[0].finished_reason == "stop_words"
