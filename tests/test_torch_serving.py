"""The port's ServingEngine against the JAX package's, on the CPU.

Both engines get the same bridged tiny f32 parameters and the same script
of submissions, steps and cancels: four requests for three slots at once,
a queued request cancelled before any step, an in-flight cancel, a request
arriving between steps, one that fills max_seq_len (128, a multiple of the
cache's 128-row rounding) exactly, and a request after the queue drained
(block reuse). The end id is a token that one request emits early, so EOS
is hit. Every request must finish with identical output_ids and
finished_reason, in the dense, paged (block 8 and 16) and packed
configurations, with a float cache and with an int8 KV cache (scale 0.05).
Per-request sampling with logprobs and bad words (max_bad_words) serves
requests that draw nothing (greedy, penalties, min length, bad and stop
words, slot reuse) as JAX's engine does: identical ids and finish reasons,
logprobs within 1e-5. Unported options raise NotImplementedError; the
capacity check counts one KV pool.
"""

import numpy as np
import pytest
import torch
import jax

from trtllm_llama_tpu.config import EngineConfig as JaxEngineConfig
from trtllm_llama_tpu.config import ModelConfig as JaxConfig
from trtllm_llama_tpu.models import llama as jax_llama
from trtllm_llama_tpu.quantization.mode import QuantMode as JaxQuantMode
from trtllm_llama_tpu.runtime.sampling import SamplingConfig as JaxSampling
from trtllm_llama_tpu.runtime.serving import ServingEngine as JaxEngine
from trtllm_llama_tpu_torch.config import EngineConfig, ModelConfig
from trtllm_llama_tpu_torch.convert.bridge import params_from_numpy
from trtllm_llama_tpu_torch.quantization.mode import QuantMode
from trtllm_llama_tpu_torch.runtime.sampling import SamplingConfig
from trtllm_llama_tpu_torch.runtime.serving import ServingEngine

torch.set_num_threads(1)

ENGINE = dict(max_batch_size=3, max_input_len=16, max_seq_len=128)
KV_SCALE = 0.05

# (name, engine options, int8 KV cache)
CONFIGS = [
    ("dense", {}, False),
    ("paged block 8", dict(paged=True, block_size=8), False),
    ("paged block 16", dict(paged=True, block_size=16), False),
    ("packed", dict(packed_prefill=True), False),
    ("dense int8 KV", {}, True),
    ("paged block 8 int8 KV", dict(paged=True, block_size=8), True),
]


@pytest.fixture(scope="module")
def tiny():
    jcfg = JaxConfig.tiny(dtype="float32")
    jparams = jax_llama.init_params(jcfg, jax.random.PRNGKey(5))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               "cpu")
    return jparams, params


def _prompts():
    rng = np.random.default_rng(0)
    return {name: rng.integers(3, 250, (n,)).tolist()
            for name, n in (("a", 5), ("b", 9), ("c", 3), ("d", 12),
                            ("queued", 4), ("late", 7), ("fill", 16),
                            ("after", 6))}


def _drive(engine, prompts):
    """The script; returns ({name: (output_ids, finished_reason)}, polls
    after the first step, the names in the order they were submitted)."""
    rid, done = {}, {}

    def collect(finished):
        for fr in finished:
            done[fr.request_id] = (list(fr.output_ids), fr.finished_reason)

    for name, n in (("a", 6), ("b", 20), ("c", 30), ("d", 5)):
        rid[name] = engine.submit(prompts[name], n)
    rid["queued"] = engine.submit(prompts["queued"], 4)
    engine.cancel(rid["queued"])                 # cancelled while queued
    collect(engine.step())
    polls = {n: engine.poll(rid[n]) for n in ("b", "c", "d")
             if engine.scheduler.get(rid[n]) is not None}
    engine.cancel(rid["b"])                      # cancelled in flight
    rid["late"] = engine.submit(prompts["late"], 5)     # staggered arrival
    collect(engine.step())
    rid["fill"] = engine.submit(prompts["fill"], 128 - 16)
    collect(engine.run_to_completion().values())
    rid["after"] = engine.submit(prompts["after"], 4)   # reuses slots/blocks
    collect(engine.run_to_completion().values())
    return {n: done.get(r) for n, r in rid.items()}, polls


def _engines(tiny, options, int8_kv, end_id):
    jparams, params = tiny
    mode = QuantMode.INT8_KV_CACHE if int8_kv else QuantMode(0)
    jmode = JaxQuantMode.INT8_KV_CACHE if int8_kv else JaxQuantMode(0)
    cfg = ModelConfig.tiny(dtype="float32", quant_mode=mode)
    jcfg = JaxConfig.tiny(dtype="float32", quant_mode=jmode)
    scales = np.full((cfg.num_layers,), KV_SCALE, np.float32) if int8_kv else None
    port = ServingEngine(cfg, params, EngineConfig(**ENGINE),
                         sampling=SamplingConfig(end_id=end_id),
                         kv_scales=scales, decode_chunk=8, device="cpu",
                         **options)
    ref = JaxEngine(jcfg, jparams, JaxEngineConfig(**ENGINE),
                    sampling=JaxSampling(end_id=end_id), kv_scales=scales,
                    decode_chunk=8, **options)
    return port, ref


@pytest.mark.parametrize("name,options,int8_kv", CONFIGS,
                         ids=[c[0] for c in CONFIGS])
def test_serving_matches_jax(tiny, name, options, int8_kv):
    prompts = _prompts()
    free, free_polls = _drive(_engines(tiny, options, int8_kv, -1)[0], prompts)
    # an end id that request "a" emits early, and that neither the request
    # cancelled in flight nor the filling request ever emits
    end_id = next(t for t in free["a"][0][1:4]
                  if t not in free["fill"][0] + free_polls["b"])
    port, ref = _engines(tiny, options, int8_kv, end_id)
    got, got_polls = _drive(port, prompts)
    want, want_polls = _drive(ref, prompts)
    assert got == want, name
    assert got_polls == want_polls
    assert got["queued"] is None and got["b"] is None     # cancelled
    assert len(got_polls["b"]) == 9                       # 1 + one chunk
    assert got["a"][1] == "eos"
    assert got["fill"] == (free["fill"][0], "length")
    assert len(got["fill"][0]) == 128 - 16
    if port.paged:
        assert port.kv_mgr.blocks.free_blocks == port.num_blocks
    assert port.calls["packed_prefills" if port.packed else "prefills"] > 0
    assert not port.scheduler.has_work


def _sampling_prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(3, 250, (n,)).tolist()
            for n in (6, 9, 4, 11, 7, 5, 8)]


def _sampling_script(prompts, free, end):
    """Per-request configs that draw nothing, from a free greedy run's
    tokens `free`: greedy, penalized, a min_length holding off the end id,
    bad words of one and two tokens, a stop word pair, a stop word on the
    first token. Returns [(name, prompt, max_new, config or None)]."""
    def cfg(**kw):
        return SamplingConfig(end_id=end, **kw)
    return [
        ("greedy", prompts[0], 10, None),
        ("penalized", prompts[1], 12, cfg(repetition_penalty=1.3,
                                          presence_penalty=0.2,
                                          frequency_penalty=0.1)),
        ("min_length", prompts[2], 10, cfg(min_length=6)),
        ("bad words", prompts[3], 12, cfg(bad_words=(
            (free[3][1],), (free[3][3], free[3][4])))),
        ("stop pair", prompts[4], 12, cfg(stop_words=(
            (free[4][2], free[4][3]),))),
        ("late greedy", prompts[5], 9, None),
        ("stop first", prompts[6], 8, cfg(stop_words=((free[6][0],),))),
    ]


def _drive_sampling(engine, script):
    """Five requests for three slots, a step, two more, then to the end;
    returns {name: (output_ids, finished_reason, logprobs)} and the
    logprobs polled after the first step."""
    rid, done = {}, {}
    for name, prompt, n, scfg in script[:5]:
        rid[name] = engine.submit(prompt, n, sampling=scfg)
    for fr in engine.step():
        done[fr.request_id] = fr
    polled = ({n: engine.poll_logprobs(rid[n]) for n in ("greedy",
                                                          "penalized")}
              if engine.return_logprobs else {})
    for name, prompt, n, scfg in script[5:]:
        rid[name] = engine.submit(prompt, n, sampling=scfg)
    done.update(engine.run_to_completion())
    return {n: (list(done[r].output_ids), done[r].finished_reason,
                done[r].logprobs) for n, r in rid.items()}, polled


def _jax_cfg(scfg):
    import dataclasses
    return None if scfg is None else JaxSampling(**dataclasses.asdict(scfg))


SAMPLING_CONFIGS = [("dense", {}), ("paged block 8",
                                    dict(paged=True, block_size=8)),
                    ("packed", dict(packed_prefill=True))]


def _sampling_engines(tiny, options, end, **extra):
    jparams, params = tiny
    kw = dict(per_request_sampling=True, return_logprobs=True,
              max_bad_words=2, max_bad_word_len=3, decode_chunk=4, **options)
    kw.update(extra)
    port = ServingEngine(ModelConfig.tiny(dtype="float32"), params,
                         EngineConfig(**ENGINE),
                         sampling=SamplingConfig(end_id=end), device="cpu",
                         **kw)
    ref = JaxEngine(JaxConfig.tiny(dtype="float32"), jparams,
                    JaxEngineConfig(**ENGINE),
                    sampling=JaxSampling(end_id=end), **kw)
    return port, ref


def _free_run(tiny, prompts):
    port, _ = _sampling_engines(tiny, {}, -1)
    rids = [port.submit(p, 12) for p in prompts]
    done = port.run_to_completion()
    return [done[r].output_ids for r in rids]


def _same_runs(got, want):
    assert {n: g[:2] for n, g in got.items()} == {
        n: w[:2] for n, w in want.items()}
    for n in got:
        if want[n][2] is None:
            assert got[n][2] is None
            continue
        assert len(got[n][2]) == len(got[n][0])       # a logprob a token
        np.testing.assert_allclose(got[n][2], want[n][2], rtol=0, atol=1e-5)


@pytest.mark.parametrize("name,options", SAMPLING_CONFIGS,
                         ids=[c[0] for c in SAMPLING_CONFIGS])
def test_per_request_sampling_matches_jax(tiny, name, options):
    """Drawless per-request configs (greedy, penalties, min length, bad and
    stop words) with slot reuse: identical ids and finish reasons,
    logprobs within 1e-5, in the dense, paged and packed engines."""
    prompts = _sampling_prompts()
    free = _free_run(tiny, prompts)
    end = free[2][2]             # min_length=6 holds this end id off
    script = _sampling_script(prompts, free, end)
    port, ref = _sampling_engines(tiny, options, end)
    got, got_polled = _drive_sampling(port, script)
    want, want_polled = _drive_sampling(ref, [
        (n, p, k, _jax_cfg(c)) for n, p, k, c in script])
    _same_runs(got, want)
    for n in got_polled:
        np.testing.assert_allclose(got_polled[n], want_polled[n], atol=1e-5)
    assert got["stop pair"][1] == "stop_words"
    assert got["stop pair"][0] == free[4][:4]        # the stop word kept
    assert got["stop first"] == (free[6][:1], "stop_words",
                                 got["stop first"][2])
    assert got["min_length"][0][:6].count(end) == 0
    banned = (free[3][3], free[3][4])
    bad = got["bad words"][0]
    assert free[3][1] not in bad and banned not in zip(bad, bad[1:])
    assert bad != free[3][:len(bad)]
    if port.paged:
        assert port.kv_mgr.blocks.free_blocks == port.num_blocks


@pytest.mark.parametrize("option,value", [
    ("per_request_sampling", True), ("prefill_chunk", 16),
    ("return_logprobs", True), ("max_bad_words", 2), ("mixed_step", True),
    ("pipelined", True), ("mapping", object()), ("mesh", object()),
    ("model", object())])
def test_unported_options_raise(tiny, option, value):
    """The options still unported raise, naming themselves; the ones this
    port runs (per_request_sampling, return_logprobs, max_bad_words, the
    last with per-request sampling as the JAX engine requires) serve the
    drawless script as the JAX engine does."""
    if option not in ("per_request_sampling", "return_logprobs",
                      "max_bad_words"):
        with pytest.raises(NotImplementedError, match=option):
            ServingEngine(ModelConfig.tiny(dtype="float32"), tiny[1],
                          EngineConfig(**ENGINE), device="cpu",
                          **{option: value})
        return
    prompts = _sampling_prompts()
    free = _free_run(tiny, prompts)
    script = _sampling_script(prompts, free, -1)
    if option == "return_logprobs":     # engine-default sampling only
        script = [(n, p, k, None) for n, p, k, _ in script]
    opts = dict(per_request_sampling=option != "return_logprobs",
                return_logprobs=option != "max_bad_words",
                max_bad_words=value if option == "max_bad_words" else 0)
    port, ref = _sampling_engines(tiny, {}, -1, **opts)
    if not opts["return_logprobs"]:
        with pytest.raises(ValueError, match="return_logprobs"):
            port.poll_logprobs(0)
    if not opts["max_bad_words"]:
        script = [(n, p, k, None if c is None or c.bad_words else c)
                  for n, p, k, c in script]
    got, _ = _drive_sampling(port, script)
    want, _ = _drive_sampling(ref, [(n, p, k, _jax_cfg(c))
                                    for n, p, k, c in script])
    _same_runs(got, want)


def test_unported_sampling_and_engines_raise(tiny):
    """Engine-default top-k sampling runs, seeded (two engines, the same
    tokens; each request its tokens), and so do engine-default stop words
    (as JAX's); engine-default bad words without max_bad_words, and
    per-request configs without per_request_sampling, raise ValueError as
    JAX's engine does; the speculative engines are not ported."""
    cfg = ModelConfig.tiny(dtype="float32")
    prompts = _sampling_prompts()

    def serve(scfg):
        eng = ServingEngine(cfg, tiny[1], EngineConfig(**ENGINE),
                            sampling=scfg, decode_chunk=4, device="cpu")
        rids = [eng.submit(p, 8) for p in prompts[:4]]
        done = eng.run_to_completion()
        return [(done[r].output_ids, done[r].finished_reason) for r in rids]
    a = serve(SamplingConfig(top_k=5, temperature=1.2, end_id=-1))
    assert a == serve(SamplingConfig(top_k=5, temperature=1.2, end_id=-1))
    assert all(len(ids) == 8 and r == "length" for ids, r in a)
    free = serve(SamplingConfig(end_id=-1))
    stop = (free[1][0][2], free[1][0][3])
    got = serve(SamplingConfig(end_id=-1, stop_words=(stop,)))
    jeng = JaxEngine(JaxConfig.tiny(dtype="float32"), tiny[0],
                     JaxEngineConfig(**ENGINE), decode_chunk=4,
                     sampling=JaxSampling(end_id=-1, stop_words=(stop,)))
    rids = [jeng.submit(p, 8) for p in prompts[:4]]
    done = jeng.run_to_completion()
    assert got == [(done[r].output_ids, done[r].finished_reason)
                   for r in rids]
    assert got[1] == (free[1][0][:4], "stop_words")
    with pytest.raises(ValueError, match="max_bad_words"):
        ServingEngine(cfg, tiny[1], EngineConfig(**ENGINE),
                      sampling=SamplingConfig(bad_words=((4,),)),
                      device="cpu")
    engine = ServingEngine(cfg, tiny[1], EngineConfig(**ENGINE),
                           device="cpu")
    with pytest.raises(ValueError, match="per_request_sampling"):
        engine.submit([5, 6], 2, sampling=SamplingConfig(end_id=-1))
    for name in ("SpeculativeServingEngine", "PromptLookupServingEngine"):
        with pytest.raises(NotImplementedError, match="speculative"):
            exec(f"from trtllm_llama_tpu_torch.runtime.serving import {name}")


@pytest.mark.parametrize("paged", [False, True])
def test_capacity_check_counts_one_kv_pool(tiny, monkeypatch, paged):
    """The port's estimate is the JAX engine's with the KV pool counted
    once (no loop-carry copy) and no scratch cache (a prefill writes into
    the slots), its prefill activations at every slot: a budget between the
    two admits the port's engine and refuses JAX's; a budget below the
    port's need refuses it with the same remedies."""
    jparams, params = tiny
    cfg, jcfg = ModelConfig.tiny(dtype="float32"), JaxConfig.tiny(
        dtype="float32")
    opts = dict(paged=paged, block_size=8)
    port = ServingEngine(cfg, params, EngineConfig(**ENGINE), device="cpu",
                         **opts)
    ref = JaxEngine(jcfg, jparams, JaxEngineConfig(**ENGINE), **opts)
    est = port._capacity_estimate(params, 8, None)
    jest = ref._capacity_estimate(jcfg, ref.engine_cfg, 0, paged, 8, None)
    assert est["kv"] == jest["kv"] > 0
    assert "scratch" not in est and jest["scratch"] > 0
    # JAX's largest prefill group is a power of two (2 of the 3 slots)
    assert est["act"] == jest["act"] * 3 // 2
    assert est["need"] == (jest["need"] - jest["kv"] - jest["scratch"]
                           + est["act"] - jest["act"])
    monkeypatch.setenv("TLLM_HBM_BYTES", str(est["need"]))
    ServingEngine(cfg, params, EngineConfig(**ENGINE), device="cpu", **opts)
    with pytest.raises(ValueError, match="budget"):
        JaxEngine(jcfg, jparams, JaxEngineConfig(**ENGINE), **opts)
    monkeypatch.setenv("TLLM_HBM_BYTES", str(est["need"] - 1))
    with pytest.raises(ValueError, match="INT8_KV_CACHE.*paged=True"):
        ServingEngine(cfg, params, EngineConfig(**ENGINE), device="cpu",
                      **opts)
