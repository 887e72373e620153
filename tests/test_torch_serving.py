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
Unported options raise NotImplementedError; the capacity check counts one
KV pool.
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


@pytest.mark.parametrize("option,value", [
    ("per_request_sampling", True), ("prefill_chunk", 16),
    ("return_logprobs", True), ("max_bad_words", 2), ("mixed_step", True),
    ("pipelined", True), ("mapping", object()), ("mesh", object()),
    ("model", object())])
def test_unported_options_raise(tiny, option, value):
    with pytest.raises(NotImplementedError, match=option):
        ServingEngine(ModelConfig.tiny(dtype="float32"), tiny[1],
                      EngineConfig(**ENGINE), device="cpu", **{option: value})


def test_unported_sampling_and_engines_raise(tiny):
    cfg = ModelConfig.tiny(dtype="float32")
    for scfg in (SamplingConfig(top_k=5), SamplingConfig(stop_words=((3,),)),
                 SamplingConfig(bad_words=((4,),))):
        with pytest.raises(NotImplementedError):
            ServingEngine(cfg, tiny[1], EngineConfig(**ENGINE),
                          sampling=scfg, device="cpu")
    engine = ServingEngine(cfg, tiny[1], EngineConfig(**ENGINE),
                           device="cpu")
    with pytest.raises(NotImplementedError, match="per_request_sampling"):
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
