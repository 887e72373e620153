"""Tensor parallelism of the port (tp = 2) on the CPU against the JAX
package's tp = 2 on its virtual mesh.

One module-scoped launch of 2 gloo ranks (`parallel/launch.py`, a 60 s
collective timeout and a 90 s join timeout, the ranks' PIDs killed on a
failure) runs every scenario of `tests/torch_tp_worker.py` with JAX made
unimportable in the ranks; the results come back as numpy files. The JAX
side runs here, with `Mapping(tp=2)` and `make_mesh` on 2 of the 8 virtual
CPU devices. f32 tiny configs throughout.

Tolerances: the row-parallel sums add two f32 partial sums where one
device adds the whole K in one order, so logits and row outputs agree
with a single device within 1e-4 of the largest value (1e-5 for the
matmuls at K = 256); greedy tokens are identical. overlap_chunks 4
against 0 is bit for bit, as the JAX package's own test asserts.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from trtllm_llama_tpu.config import EngineConfig as JaxEngineConfig
from trtllm_llama_tpu.config import ModelConfig as JaxConfig
from trtllm_llama_tpu.models import llama as jax_llama
from trtllm_llama_tpu.parallel.mapping import Mapping as JaxMapping
from trtllm_llama_tpu.quantization.mode import QuantMode as JaxQuantMode
from trtllm_llama_tpu.quantization.quantize import quantize_params
from trtllm_llama_tpu.runtime.sampling import SamplingConfig as JaxSampling
from trtllm_llama_tpu.runtime.serving import ServingEngine as JaxEngine
from trtllm_llama_tpu.runtime.session import GenerationSession as JaxSession
from trtllm_llama_tpu_torch.config import EngineConfig, ModelConfig
from trtllm_llama_tpu_torch.convert.bridge import params_from_numpy
from trtllm_llama_tpu_torch.ops import linear
from trtllm_llama_tpu_torch.parallel import Mapping, launch
from trtllm_llama_tpu_torch.quantization.mode import QuantMode
from trtllm_llama_tpu_torch.quantization.tensors import quantize_per_token
from trtllm_llama_tpu_torch.runtime.sampling import SamplingConfig
from trtllm_llama_tpu_torch.runtime.serving import ServingEngine
from trtllm_llama_tpu_torch.runtime.session import GenerationSession

import torch_tp_worker as worker

TESTS = os.path.dirname(os.path.abspath(__file__))
TP = 2
JOIN_TIMEOUT = 90.0
COLLECTIVE_TIMEOUT = 60.0
LOGITS_REL = 1e-4
MATMUL_REL = 1e-5
PROJ = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
# the session cases: (JAX quant mode, group size), as
# tests/test_sharded_kernels.py builds them
CASES = {
    "int8": (JaxQuantMode.use_weight_only(False), 0),
    "int4_g32": (JaxQuantMode.use_weight_only(True, per_group=True), 32),
    "fp8": (JaxQuantMode.FP8_QDQ, 0),
    "sq": (JaxQuantMode.use_smooth_quant(per_token=True, per_channel=True),
           0),
}

torch.set_num_threads(1)


def _jax_case(case):
    """(cfg, params) of a session case, or of the f32 serving one."""
    if case == "f32":      # tests/test_serving.py's tiny_setup
        cfg = JaxConfig.tiny(dtype="float32")
        return cfg, jax_llama.init_params(cfg, jax.random.PRNGKey(5))
    qm, group = CASES[case]
    cfg = JaxConfig.tiny(quant_mode=qm, group_size=group, dtype="float32")
    params = jax_llama.init_params(cfg, jax.random.PRNGKey(0))
    ranges = None
    if qm.has_act_and_weight_quant():
        ranges = {k: np.full((cfg.num_layers,), 3.0, np.float32)
                  for k in PROJ}
    return cfg, quantize_params(params, qm, group, act_ranges=ranges)


def _port(case):
    jcfg, jparams = _jax_case(case)
    cfg = ModelConfig.tiny(dtype="float32",
                           quant_mode=QuantMode(int(jcfg.quant_mode)),
                           group_size=jcfg.group_size)
    return cfg, params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                  device="cpu")


def _stub_jax(root):
    """A directory whose `jax` and `trtllm_llama_tpu` fail to import, put
    first on the ranks' sys.path."""
    for name in ("jax", "trtllm_llama_tpu"):
        os.makedirs(os.path.join(root, name), exist_ok=True)
        with open(os.path.join(root, name, "__init__.py"), "w") as f:
            f.write(f"raise ImportError('{name} is unimportable in a rank')\n")
    return root


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results ({name: array} each), from one launch."""
    data = tmp_path_factory.mktemp("tp")
    cases = {}
    for case in (*CASES, "f32"):
        cfg, params = _port(case)
        torch.save(params, data / f"params_{case}.pt")
        cases[case] = {"quant_mode": int(cfg.quant_mode),
                       "group_size": cfg.group_size}
    (data / "cases.json").write_text(json.dumps(cases))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    results = launch.launch(
        "torch_tp_worker:run", TP, args=[str(data)], backend="gloo",
        collective_timeout=COLLECTIVE_TIMEOUT, join_timeout=JOIN_TIMEOUT,
        env=env, sys_path=[_stub_jax(str(data / "stub")), TESTS])
    launch.check(results)
    return [dict(np.load(data / f"rank{r}.npz")) for r in range(TP)]


@pytest.mark.parametrize("kind", ["woq", "fp8", "sq"])
def test_row_overlap_chunks_bit_identical(ranks, kind):
    """Row-parallel dense at 96 rows: overlap_chunks 4 (four 128-column
    windows, one launch and one async all-reduce each) equals
    overlap_chunks 0 (one launch, one all-reduce) bit for bit on both
    ranks, both equal across ranks, and both agree with the single-device
    dense of the whole weight."""
    for r in ranks:
        np.testing.assert_array_equal(r[f"overlap_{kind}_4"],
                                      r[f"overlap_{kind}_0"])
        np.testing.assert_array_equal(r[f"windows_{kind}_4"],
                                      [[c * 128, 128] for c in range(4)])
        np.testing.assert_array_equal(r[f"windows_{kind}_0"], [[-1, -1]])
    np.testing.assert_array_equal(ranks[0][f"overlap_{kind}_4"],
                                  ranks[1][f"overlap_{kind}_4"])
    x, w = worker.overlap_inputs()
    full = linear.dense(torch.from_numpy(x), worker.overlap_weight(kind, w),
                        torch.float32, worker.OVERLAP_LAYER).numpy()
    got = ranks[0][f"overlap_{kind}_4"]
    assert np.abs(got - full).max() <= MATMUL_REL * np.abs(full).max()


def test_sq_row_scales_are_the_full_rows(ranks):
    """The SmoothQuant row path quantizes each rank's K shard with the
    per-token scale of the FULL row (an all-reduce of the local absmax),
    as the JAX package quantizes before sharding: the scales equal the full
    row's bit for bit and each rank's codes are its slice of the full
    row's codes."""
    x, _ = worker.overlap_inputs()
    x_q, s_x = quantize_per_token(torch.from_numpy(x))
    k = x.shape[1] // TP
    for rank, r in enumerate(ranks):
        np.testing.assert_array_equal(r["sq_scale"], s_x.numpy())
        np.testing.assert_array_equal(
            r["sq_codes"], x_q.numpy()[:, rank * k:(rank + 1) * k])


def _mesh():
    return JaxMapping(tp=TP).make_mesh(np.array(jax.devices()[:TP]))


@pytest.mark.parametrize("case", list(CASES))
def test_session_tp_matches_jax_and_single_device(ranks, case):
    """GenerationSession at tp = 2: both ranks' greedy tokens equal the JAX
    package's GenerationSession at Mapping(tp=2) on its mesh and the port's
    single-device session; the prefill logits agree with the single
    device's within LOGITS_REL of the largest."""
    if jax.device_count() < TP:
        pytest.skip("needs the virtual CPU mesh")
    jcfg, jparams = _jax_case(case)
    ids = worker.session_ids()
    ecfg = worker.SESSION_ECFG
    want = JaxSession(jcfg, jparams, JaxEngineConfig(**ecfg),
                      mapping=JaxMapping(tp=TP), mesh=_mesh()).generate(
        ids, max_new_tokens=8, sampling=JaxSampling(end_id=-1))
    cfg, params = _port(case)
    single = GenerationSession(cfg, params, EngineConfig(**ecfg),
                               device="cpu")
    ref = single.generate(ids, max_new_tokens=8,
                          sampling=SamplingConfig(end_id=-1))
    np.testing.assert_array_equal(ref.output_ids, want.output_ids)
    with torch.inference_mode():
        caches = single.model.init_caches(cfg, ids.shape[0], 64, "cpu")
        logits, _ = single.model.forward_prefill(
            single.params, cfg, torch.from_numpy(ids),
            torch.full((ids.shape[0],), ids.shape[1], dtype=torch.int32),
            caches)
    for r in ranks:
        np.testing.assert_array_equal(r[f"tokens_{case}"], want.output_ids)
        got = r[f"logits_{case}"]
        assert got.shape == logits.shape
        err = np.abs(got - logits.numpy()).max()
        assert err <= LOGITS_REL * np.abs(logits.numpy()).max(), err


@pytest.mark.parametrize("paged", [False, True])
def test_serving_tp_matches_jax(ranks, paged):
    """ServingEngine at tp = 2 (dense, and paged with 8-row blocks), as
    tests/test_serving.py serves the JAX engine at tp = 2: every request's
    tokens equal the JAX tp engine's and the single-device engine's."""
    if jax.device_count() < TP:
        pytest.skip("needs the virtual CPU mesh")
    jcfg, jparams = _jax_case("f32")
    prompts = worker.serve_prompts()
    eng = JaxEngine(jcfg, jparams, JaxEngineConfig(**worker.SERVE_ECFG),
                    sampling=JaxSampling(end_id=-1), decode_chunk=3,
                    paged=paged, block_size=8, mapping=JaxMapping(tp=TP),
                    mesh=_mesh())
    ids = [eng.submit(p, 5) for p in prompts]
    done = eng.run_to_completion()
    want = [done[i].output_ids for i in ids]
    cfg, params = _port("f32")
    single = ServingEngine(cfg, params, EngineConfig(**worker.SERVE_ECFG),
                           sampling=SamplingConfig(end_id=-1), decode_chunk=3,
                           device="cpu", paged=paged, block_size=8)
    sids = [single.submit(p, 5) for p in prompts]
    sdone = single.run_to_completion()
    assert [sdone[i].output_ids for i in sids] == want
    for r in ranks:
        assert r["serve_" + ("paged" if paged else "dense")].tolist() == want


def test_batch_axes_rejected_as_in_jax():
    """Mapping(dp=2, tp=2) is refused by serving, as the JAX engine refuses
    it ("slot pool"); an unported axis raises NotImplementedError in the
    session, and the serving options not ported under TP raise too."""
    cfg, params = _port("int8")
    ecfg = EngineConfig(**worker.SERVE_ECFG)
    with pytest.raises(ValueError, match="slot pool"):
        ServingEngine(cfg, params, ecfg, device="cpu",
                      mapping=Mapping(dp=2, tp=2))
    if jax.device_count() >= 4:
        jcfg, jparams = _jax_case("int8")
        mapping = JaxMapping(dp=2, tp=2)
        with pytest.raises(ValueError, match="slot pool"):
            JaxEngine(jcfg, jparams, JaxEngineConfig(**worker.SERVE_ECFG),
                      mapping=mapping,
                      mesh=mapping.make_mesh(np.array(jax.devices()[:4])))
    with pytest.raises(NotImplementedError, match="ROADMAP A 5"):
        GenerationSession(cfg, params, ecfg, device="cpu",
                          mapping=Mapping(sp=2))
    with pytest.raises(NotImplementedError, match="pipelined"):
        ServingEngine(cfg, params, ecfg, device="cpu", pipelined=True,
                      mapping=Mapping(tp=2))


def test_tp_needs_an_initialised_group_and_llama():
    """Without torch.distributed a tp session cannot make its group; a
    decoder family under tp raises NotImplementedError naming ROADMAP."""
    from trtllm_llama_tpu_torch.models import decoder
    cfg, params = _port("int8")
    ecfg = EngineConfig(**worker.SESSION_ECFG)
    with pytest.raises(RuntimeError, match="initialised"):
        GenerationSession(cfg, params, ecfg, device="cpu",
                          mapping=Mapping(tp=2))
    with pytest.raises(NotImplementedError, match="ROADMAP A 5"):
        GenerationSession(cfg, params, ecfg, device="cpu",
                          mapping=Mapping(tp=2), model=decoder.BLOOM)


def test_launcher_kills_the_peers_of_a_failed_rank():
    """A rank that dies fails the launch at once: its peer, blocked in a
    collective, is killed (exactly the PID the launcher started) long
    before the collective timeout, and both codes are reported."""
    import time
    t0 = time.monotonic()
    results = launch.launch("torch_tp_worker:fail_one", TP, backend="gloo",
                            collective_timeout=COLLECTIVE_TIMEOUT,
                            join_timeout=JOIN_TIMEOUT, sys_path=[TESTS],
                            env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert time.monotonic() - t0 < COLLECTIVE_TIMEOUT
    assert results[1].returncode == 1
    assert "fails on purpose" in results[1].output
    assert results[0].returncode != 0
    with pytest.raises(RuntimeError, match="rank 1 exited 1"):
        launch.check(results)
