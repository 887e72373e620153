"""The port's ServingEngine against the JAX package's, on the CPU.

Both engines get the same bridged tiny f32 parameters and the same script
of submissions, steps and cancels: four requests for three slots at once,
a queued request cancelled before any step, an in-flight cancel, a request
arriving between steps, one that fills max_seq_len (128, a multiple of the
cache's 128-row rounding) exactly, and a request after the queue drained
(block reuse). The end id is a token that one request emits early, so EOS
is hit. Every request must finish with identical output_ids and
finished_reason, in the dense, paged (block 8 and 16) and packed
configurations, with a float cache and with an int8 KV cache (scale 0.05),
and in the chunked-prefill (prefill_chunk 16, prompts of 33-40 tokens in
the script, also with an int8 KV cache), mixed-step and pipelined (dense,
paged block 8, packed) engines. Per-request sampling with logprobs and bad
words (max_bad_words) serves requests that draw nothing (greedy,
penalties, min length, bad and stop words, slot reuse) as JAX's engine
does: identical ids and finish reasons, logprobs within 1e-5, also under
chunked prefill (prompts of up to 40 tokens) and mixed steps. The decoder
families OPT and Bloom serve through model= with and without chunking as
JAX's engine does. The options still unported (a mapping's sp / ep axes,
mesh) raise NotImplementedError; the capacity check counts one KV pool, and
cache_headroom's rows as JAX's engine does.

JAX's pipelined paged engine over-appends KV blocks (its host budgets lag
a chunk, ADVICE.md; JAX runtime/serving.py:1397) and raises "sequence
exceeds max_blocks_per_seq" for a request with input + max_new_tokens ==
max_seq_len: against it the script's filling request stops a chunk short,
the port serves the full one alone, and JAX's side of that case is an
expected failure.
"""

import numpy as np
import pytest
import torch
import jax

from trtllm_llama_tpu.config import EngineConfig as JaxEngineConfig
from trtllm_llama_tpu.config import ModelConfig as JaxConfig
from trtllm_llama_tpu.models import decoder as jax_decoder
from trtllm_llama_tpu.models import llama as jax_llama
from trtllm_llama_tpu.quantization.mode import QuantMode as JaxQuantMode
from trtllm_llama_tpu.runtime.sampling import SamplingConfig as JaxSampling
from trtllm_llama_tpu.runtime.serving import ServingEngine as JaxEngine
from trtllm_llama_tpu_torch.config import EngineConfig, ModelConfig
from trtllm_llama_tpu_torch.convert.bridge import params_from_numpy
from trtllm_llama_tpu_torch.models import decoder, llama
from trtllm_llama_tpu_torch.parallel.mapping import Mapping
from trtllm_llama_tpu_torch.quantization.mode import QuantMode
from trtllm_llama_tpu_torch.runtime.sampling import SamplingConfig
from trtllm_llama_tpu_torch.runtime.serving import ServingEngine

torch.set_num_threads(1)

ENGINE = dict(max_batch_size=3, max_input_len=16, max_seq_len=128)
# chunked prefill: prompts of up to 40 tokens, in chunks of 16 (JAX's
# test_serving_chunked_prefill_matches_offline admits 48)
LONG_ENGINE = dict(max_batch_size=3, max_input_len=48, max_seq_len=128)
CHUNK = dict(prefill_chunk=16)
KV_SCALE = 0.05
# the port's models -> the JAX package's
JAX_MODEL = {llama: jax_llama, decoder.OPT: jax_decoder.OPT,
             decoder.BLOOM: jax_decoder.BLOOM}

# (name, engine options, int8 KV cache)
CONFIGS = [
    ("dense", {}, False),
    ("paged block 8", dict(paged=True, block_size=8), False),
    ("paged block 16", dict(paged=True, block_size=16), False),
    ("packed", dict(packed_prefill=True), False),
    ("dense int8 KV", {}, True),
    ("paged block 8 int8 KV", dict(paged=True, block_size=8), True),
    ("chunked", CHUNK, False),
    ("chunked int8 KV", CHUNK, True),
    ("mixed", dict(mixed_step=True), False),
    ("pipelined", dict(pipelined=True), False),
    ("pipelined paged block 8", dict(pipelined=True, paged=True,
                                     block_size=8), False),
    ("pipelined packed", dict(pipelined=True, packed_prefill=True), False),
]


@pytest.fixture(scope="module")
def tiny():
    jcfg = JaxConfig.tiny(dtype="float32")
    jparams = jax_llama.init_params(jcfg, jax.random.PRNGKey(5))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               "cpu")
    return jparams, params


def _prompts(long=False):
    """The script's prompts; `long`: requests b, d and fill get 40, 33 and
    40 tokens (chunked in 3, 3 and 3 calls of 16)."""
    rng = np.random.default_rng(0)
    sizes = dict(a=5, b=9, c=3, d=12, queued=4, late=7, fill=16, after=6)
    if long:
        sizes.update(b=40, d=33, fill=40)
    return {name: rng.integers(3, 250, (n,)).tolist()
            for name, n in sizes.items()}


def _drive(engine, prompts, fill_new=None):
    """The script; returns ({name: (output_ids, finished_reason)}, polls
    after the first step). The filling request asks for `fill_new` tokens,
    by default max_seq_len less its prompt."""
    if fill_new is None:
        fill_new = engine.engine_cfg.max_seq_len - len(prompts["fill"])
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
    rid["fill"] = engine.submit(prompts["fill"], fill_new)
    collect(engine.run_to_completion().values())
    rid["after"] = engine.submit(prompts["after"], 4)   # reuses slots/blocks
    collect(engine.run_to_completion().values())
    return {n: done.get(r) for n, r in rid.items()}, polls


def _engines(tiny, options, int8_kv, end_id, engine=ENGINE):
    jparams, params = tiny
    mode = QuantMode.INT8_KV_CACHE if int8_kv else QuantMode(0)
    jmode = JaxQuantMode.INT8_KV_CACHE if int8_kv else JaxQuantMode(0)
    cfg = ModelConfig.tiny(dtype="float32", quant_mode=mode)
    jcfg = JaxConfig.tiny(dtype="float32", quant_mode=jmode)
    scales = np.full((cfg.num_layers,), KV_SCALE, np.float32) if int8_kv else None
    port = ServingEngine(cfg, params, EngineConfig(**engine),
                         sampling=SamplingConfig(end_id=end_id),
                         kv_scales=scales, decode_chunk=8, device="cpu",
                         **options)
    ref = JaxEngine(jcfg, jparams, JaxEngineConfig(**engine),
                    sampling=JaxSampling(end_id=end_id), kv_scales=scales,
                    decode_chunk=8, **options)
    return port, ref


@pytest.mark.parametrize("name,options,int8_kv", CONFIGS,
                         ids=[c[0] for c in CONFIGS])
def test_serving_matches_jax(tiny, name, options, int8_kv):
    chunked = "prefill_chunk" in options
    engine = LONG_ENGINE if chunked else ENGINE
    prompts = _prompts(long=chunked)
    fill_new = engine["max_seq_len"] - len(prompts["fill"])
    if options.get("pipelined") and options.get("paged"):
        fill_new -= 8      # one chunk short of JAX's over-append (module doc)
    free, free_polls = _drive(_engines(tiny, options, int8_kv, -1, engine)[0],
                              prompts, fill_new)
    # an end id that request "a" emits early, and that neither the request
    # cancelled in flight nor the filling request ever emits
    end_id = next(t for t in free["a"][0][1:4]
                  if t not in free["fill"][0] + free_polls["b"])
    port, ref = _engines(tiny, options, int8_kv, end_id, engine)
    got, got_polls = _drive(port, prompts, fill_new)
    want, want_polls = _drive(ref, prompts, fill_new)
    assert got == want, name
    assert got_polls == want_polls
    assert got["queued"] is None and got["b"] is None     # cancelled
    # b's tokens when cancelled: 1 + one chunk; none while it prefills in
    # chunks; its first token alone while the pipelined chunk is in flight
    n_b = 0 if chunked else 1 if options.get("pipelined") else 9
    assert len(got_polls["b"]) == n_b
    assert got["a"][1] == "eos"
    assert got["fill"] == (free["fill"][0], "length")
    assert len(got["fill"][0]) == fill_new
    if port.paged:
        assert port.kv_mgr.blocks.free_blocks == port.num_blocks
    assert port.calls["packed_prefills" if port.packed else "prefills"] > 0
    # one chunk call a step while prompts are partial, 16 rows a prompt
    assert port.calls["chunk_prefills"] == len(port.chunk_rows)
    assert (port.calls["chunk_prefills"] > 0) == chunked
    assert set(port.chunk_rows) <= {16, 32, 48}
    assert not port.scheduler.has_work
    assert port._pending_chunk is None


def _sampling_prompts(long=False):
    """The sampled script's prompts; `long`: the penalized request's, the
    bad-word request's and the stop request's get 40, 33 and 20 tokens
    (chunked prefill)."""
    rng = np.random.default_rng(7)
    sizes = (6, 40, 4, 33, 20, 5, 8) if long else (6, 9, 4, 11, 7, 5, 8)
    return [rng.integers(3, 250, (n,)).tolist() for n in sizes]


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
                    ("packed", dict(packed_prefill=True)),
                    ("chunked", CHUNK), ("mixed", dict(mixed_step=True))]


def _sampling_engines(tiny, options, end, engine=ENGINE, **extra):
    """The port's engine and JAX's with the same options (a `model` the
    JAX engine gets as its own counterpart, JAX_MODEL)."""
    jparams, params = tiny
    kw = dict(per_request_sampling=True, return_logprobs=True,
              max_bad_words=2, max_bad_word_len=3, decode_chunk=4, **options)
    kw.update(extra)
    jkw = dict(kw)
    if "model" in kw:
        jkw["model"] = JAX_MODEL[kw["model"]]
    port = ServingEngine(ModelConfig.tiny(dtype="float32"), params,
                         EngineConfig(**engine),
                         sampling=SamplingConfig(end_id=end), device="cpu",
                         **kw)
    ref = JaxEngine(JaxConfig.tiny(dtype="float32"), jparams,
                    JaxEngineConfig(**engine),
                    sampling=JaxSampling(end_id=end), **jkw)
    return port, ref


def _free_run(tiny, prompts, engine=ENGINE):
    port, _ = _sampling_engines(tiny, {}, -1, engine)
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
    logprobs within 1e-5, in the dense, paged and packed engines, and
    under chunked prefill (three prompts chunked, the penalized one's
    counts seeded from its whole prompt at its final chunk) and mixed
    steps."""
    chunked = "prefill_chunk" in options
    engine = LONG_ENGINE if chunked else ENGINE
    prompts = _sampling_prompts(long=chunked)
    free = _free_run(tiny, prompts, engine)
    end = free[2][2]             # min_length=6 holds this end id off
    script = _sampling_script(prompts, free, end)
    port, ref = _sampling_engines(tiny, options, end, engine)
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
    ("pipelined", True), ("mapping", Mapping(sp=2)), ("mesh", object()),
    pytest.param("model", llama, id="model-value8"),
    ("cache_headroom", 8)])
def test_unported_options_raise(tiny, option, value):
    """The options still unported (a mapping's sp / ep axes, mesh)
    raise, naming themselves; the ones this port runs serve the drawless script as the
    JAX engine does: per_request_sampling, return_logprobs and
    max_bad_words (the last with per-request sampling, as the JAX engine
    requires), and with both and max_bad_words, prefill_chunk, mixed_step,
    pipelined, model (the llama module, the JAX engine given its own) and
    cache_headroom (its dense cache as long as JAX's, its estimate grown
    by the same KV bytes, the pool still counted once)."""
    if option in ("mapping", "mesh"):
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
    if option not in opts:
        opts["max_bad_words"] = 2
        opts[option] = value
    port, ref = _sampling_engines(tiny, {}, -1, **opts)
    if option == "model":
        assert port.model is llama and ref.model is jax_llama
    if option == "cache_headroom":
        plain = _sampling_engines(tiny, {}, -1, **{**opts,
                                                   "cache_headroom": 0})
        assert port.caches.k.shape == ref.caches.k.shape
        assert port.caches.k.shape[3] == 256 > plain[0].caches.k.shape[3]
        est = port._capacity_estimate(tiny[1], 64, None)
        jest = ref._capacity_estimate(ref.cfg, ref.engine_cfg, value, False,
                                      64, None)
        est0 = plain[0]._capacity_estimate(tiny[1], 64, None)
        jest0 = plain[1]._capacity_estimate(ref.cfg, ref.engine_cfg, 0,
                                            False, 64, None)
        assert est["kv"] - est0["kv"] == jest["kv"] - jest0["kv"] > 0
        assert est["need"] - est0["need"] == est["kv"] - est0["kv"]
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
    JAX's engine does; the speculative engines are ServingEngines of
    runtime/serving_spec.py, not names of runtime/serving.py."""
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
        mod = __import__("trtllm_llama_tpu_torch.runtime.serving_spec",
                         fromlist=[name])
        assert issubclass(getattr(mod, name), ServingEngine)
        with pytest.raises(ImportError):
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


def _fill_script(engine):
    """Three requests, one filling max_seq_len exactly (16 + 112 = 128);
    returns [(output_ids, finished_reason)]."""
    rng = np.random.default_rng(3)
    reqs = [(rng.integers(3, 250, (16,)).tolist(), 112),
            (rng.integers(3, 250, (9,)).tolist(), 20),
            (rng.integers(3, 250, (5,)).tolist(), 40)]
    rids = [engine.submit(p, n) for p, n in reqs]
    done = engine.run_to_completion()
    return [(done[r].output_ids, done[r].finished_reason) for r in rids]


def test_pipelined_paged_serves_max_seq_len(tiny):
    """The port's pipelined paged engine serves a request with input +
    max_new_tokens == max_seq_len to its end: its block appends count the
    steps still in flight, so they stop at the allocator's own length. The
    tokens equal the plain paged engine's; every block comes back."""
    opts = dict(paged=True, block_size=8)
    got = _fill_script(_engines(tiny, dict(pipelined=True, **opts), False,
                                -1)[0])
    plain = _engines(tiny, opts, False, -1)[0]
    assert got == _fill_script(plain)
    assert got[0][1] == "length" and len(got[0][0]) == 112
    port = _engines(tiny, dict(pipelined=True, **opts), False, -1)[0]
    _fill_script(port)
    assert port.kv_mgr.blocks.free_blocks == port.num_blocks


@pytest.mark.xfail(strict=True, raises=RuntimeError, reason=(
    "JAX's pipelined paged engine over-appends KV blocks: its host budgets "
    "lag a chunk (ADVICE.md; JAX runtime/serving.py:1397), so append_token "
    "raises 'sequence exceeds max_blocks_per_seq' at input + max_new_tokens "
    "== max_seq_len"))
def test_pipelined_paged_serves_max_seq_len_jax(tiny):
    """JAX's side of test_pipelined_paged_serves_max_seq_len."""
    ref = _engines(tiny, dict(pipelined=True, paged=True, block_size=8),
                   False, -1)[1]
    _fill_script(ref)


def test_chunked_prefill_guards_partial_rows(tiny):
    """While a 40-token prompt prefills in chunks beside a decoding
    request, the decode steps leave its slot's rows alone (inactive rows
    write at max_seq_len): after its final chunk the slot holds the K/V of
    a monolithic prefill of the prompt, and its tokens are the plain
    engine's."""
    rng = np.random.default_rng(8)
    short = rng.integers(3, 250, (6,)).tolist()
    long = rng.integers(3, 250, (40,)).tolist()
    outs = []
    for opts in (CHUNK, {}):
        port = ServingEngine(ModelConfig.tiny(dtype="float32"), tiny[1],
                             EngineConfig(**LONG_ENGINE),
                             sampling=SamplingConfig(end_id=-1),
                             decode_chunk=2, device="cpu", **opts)
        r_short = port.submit(short, 12)
        port.step()                                 # short decodes
        r_long = port.submit(long, 4)
        if opts:
            port.step()                             # long's first chunk
            slot = port.scheduler.get(r_long).slot
            port.step()
            assert port.poll(r_long) == []          # still prefilling
            port.step()                             # its final chunk
            assert len(port.poll(r_long)) >= 1      # its first token
            assert len(port.poll(r_short)) == 9     # 1 + four chunks of 2
            assert port.calls["chunk_prefills"] == 3
            cfg = port.cfg
            ref = llama.init_caches(cfg, 1, 128, "cpu")
            llama.forward_prefill(port.params, cfg, torch.tensor([long]),
                                  torch.tensor([40]), ref)
            for got, want in ((port.caches.k, ref.k), (port.caches.v, ref.v)):
                torch.testing.assert_close(got[:, slot, :, :40],
                                           want[:, 0, :, :40],
                                           rtol=1e-5, atol=1e-5)
        done = port.run_to_completion()
        outs.append([done[r].output_ids for r in (r_short, r_long)])
    assert outs[0] == outs[1]


@pytest.mark.parametrize("chunk", [None, 16], ids=["monolithic", "chunked"])
@pytest.mark.parametrize("family", ["opt", "bloom"])
def test_family_serving_matches_jax(family, chunk):
    """OPT (learned positions at +2) and Bloom (ALiBi) served through
    model= with and without chunked prefill: identical ids and reasons to
    JAX's engine with the same options, staggered arrivals, prompts of
    40 / 10 / 33 / 5 tokens."""
    over = dict(dtype="float32", architecture=family)
    jcfg, cfg = JaxConfig.tiny(**over), ModelConfig.tiny(**over)
    fam = {"opt": decoder.OPT, "bloom": decoder.BLOOM}[family]
    jparams = JAX_MODEL[fam].init_params(jcfg, jax.random.PRNGKey(2))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               "cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(3, 250, (n,)).tolist() for n in (40, 10, 33, 5)]
    runs = []
    for eng in (ServingEngine(cfg, params, EngineConfig(**LONG_ENGINE),
                              sampling=SamplingConfig(end_id=-1),
                              decode_chunk=3, model=fam,
                              prefill_chunk=chunk, device="cpu"),
                JaxEngine(jcfg, jparams, JaxEngineConfig(**LONG_ENGINE),
                          sampling=JaxSampling(end_id=-1), decode_chunk=3,
                          model=JAX_MODEL[fam], prefill_chunk=chunk)):
        rids = [eng.submit(p, 6) for p in prompts[:3]]
        done = {fr.request_id: fr for fr in eng.step()}
        rids.append(eng.submit(prompts[3], 5))
        done.update(eng.run_to_completion())
        runs.append([(done[r].output_ids, done[r].finished_reason)
                     for r in rids])
    assert runs[0] == runs[1]
    assert all(len(ids) == n for (ids, _), n in zip(runs[0], (6, 6, 6, 5)))


def test_option_checks_match_jax(tiny):
    """The options raise where JAX's engine raises: prefill_chunk below 16;
    mixed_step with paged, packed or chunked prefill; pipelined with
    mixed_step; packed prefill for a family without it. prefill_chunk is
    ignored under paged or packed, as in JAX. A family served on a paged
    pool raises at once, naming the family (JAX's fails deep in the
    prefill)."""
    jparams, params = tiny
    cfg, jcfg = ModelConfig.tiny(dtype="float32"), JaxConfig.tiny(
        dtype="float32")
    cases = [(dict(prefill_chunk=8), "prefill_chunk must be >= 16"),
             (dict(mixed_step=True, paged=True), "mixed_step"),
             (dict(mixed_step=True, packed_prefill=True), "mixed_step"),
             (dict(mixed_step=True, prefill_chunk=16), "mixed_step"),
             (dict(pipelined=True, mixed_step=True), "pipelined")]
    for opts, match in cases:
        with pytest.raises(ValueError, match=match):
            ServingEngine(cfg, params, EngineConfig(**ENGINE), device="cpu",
                          **opts)
        with pytest.raises(ValueError, match=match):
            JaxEngine(jcfg, jparams, JaxEngineConfig(**ENGINE), **opts)
    for opts in (dict(prefill_chunk=16, paged=True),
                 dict(prefill_chunk=16, packed_prefill=True)):
        port = ServingEngine(cfg, params, EngineConfig(**ENGINE),
                             device="cpu", **opts)
        ref = JaxEngine(jcfg, jparams, JaxEngineConfig(**ENGINE), **opts)
        assert port.prefill_chunk is None and ref.prefill_chunk is None
    ocfg = ModelConfig.tiny(dtype="float32", architecture="opt")
    oparams = decoder.OPT.init_params(ocfg, device="cpu")
    with pytest.raises(ValueError, match="'opt' has no packed-prefill"):
        ServingEngine(ocfg, oparams, EngineConfig(**ENGINE), device="cpu",
                      packed_prefill=True)
    with pytest.raises(ValueError, match="'opt' has no paged KV cache"):
        ServingEngine(ocfg, oparams, EngineConfig(**ENGINE), device="cpu",
                      paged=True)
    assert ServingEngine(ocfg, oparams, EngineConfig(**ENGINE),
                         device="cpu").model is decoder.OPT
