"""The port's accuracy harness (`quantization/evaluate.py`,
`utils/accuracy.py`) and `rms_norm_quant(smoother=)` against the JAX
package's, on the CPU.

The golden model is the JAX accuracy gates' own (hidden 128, 2 layers,
vocab 256; `tests/test_accuracy_gates.py`): the JAX `build_golden_setup`
builds it, and its params, act ranges and KV scales are carried across, so
that the calibration ids (seeded differently by the two packages) cannot
differ. Tolerances: the metrics functions within 1e-12 (both float64
numpy); greedy tokens identical; teacher-forced f32 logits within 2e-5
absolute; each mode's row: ppl ratio within 2e-4, KL within 2% of the
larger + 1e-7, max |err| within 5e-4, top-1 shares at most one position
apart (both run f32; quantized activations may round one code apart).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from trtllm_llama_tpu.ops.norm import rms_norm_quant as jax_rms_norm_quant
from trtllm_llama_tpu.quantization import evaluate as jax_eval
from trtllm_llama_tpu.quantization.mode import QuantMode as JaxQuantMode
from trtllm_llama_tpu.utils import accuracy as jax_acc
from trtllm_llama_tpu_torch.config import ModelConfig
from trtllm_llama_tpu_torch.convert.bridge import params_from_numpy
from trtllm_llama_tpu_torch.ops.norm import rms_norm_quant
from trtllm_llama_tpu_torch.quantization import evaluate
from trtllm_llama_tpu_torch.quantization.mode import QuantMode
from trtllm_llama_tpu_torch.utils import accuracy

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = dict(hidden=128, layers=2, intermediate=256, vocab=256)
CONT = 10
# tests/test_accuracy_gates.py:34-52: (name, mode bits, group size)
MODES = [
    ("int8-wo", QuantMode.use_weight_only(False), 0),
    ("int4-wo", QuantMode.use_weight_only(True), 0),
    ("int4-wo-g", QuantMode.use_weight_only(True, per_group=True), 64),
    ("sq-static", QuantMode.use_smooth_quant(), 0),
    ("sq-ptpc", QuantMode.use_smooth_quant(per_token=True, per_channel=True),
     0),
    ("int8-kv", QuantMode.INT8_KV_CACHE, 0),
    ("int8-wo+kv", QuantMode.use_weight_only(False) | QuantMode.INT8_KV_CACHE,
     0),
    ("fp8", QuantMode.FP8_QDQ, 0),
    ("fp8-kv", QuantMode.FP8_KV_CACHE, 0),
    ("fp8+kv", QuantMode.FP8_QDQ | QuantMode.FP8_KV_CACHE, 0),
]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def golden():
    """The JAX golden model, its carried-across port params, the prompts,
    and both packages' reference runs."""
    cfg_j, params_j, act_ranges, kv_scales, _ = jax_eval.build_golden_setup(
        **GOLDEN)
    cfg_t = ModelConfig(**{f: getattr(cfg_j, f)
                           for f in ModelConfig.__dataclass_fields__
                           if f != "quant_mode"})
    params_t = params_from_numpy(_np_tree(params_j), device="cpu")
    prompts = np.random.default_rng(0).integers(3, 256, (2, 16))
    ref_j = jax_eval.reference_run(cfg_j, params_j, prompts, CONT)
    ref_t = evaluate.reference_run(cfg_t, params_t, prompts, CONT,
                                   device="cpu")
    return dict(cfg_j=cfg_j, params_j=params_j, cfg_t=cfg_t,
                params_t=params_t, act_ranges=act_ranges,
                kv_scales=kv_scales, prompts=prompts, ref_j=ref_j,
                ref_t=ref_t, rows={})


def test_metrics_match_jax():
    rng = np.random.default_rng(7)
    ref = rng.standard_normal((3, 5, 64)) * 4
    test = ref + rng.standard_normal(ref.shape) * 0.3
    tgt = rng.integers(0, 64, (3, 5))
    got, want = accuracy.logit_metrics(ref, test), jax_acc.logit_metrics(
        ref, test)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12, abs=1e-12), k
    assert accuracy.nll(test, tgt) == pytest.approx(jax_acc.nll(test, tgt),
                                                    rel=1e-12)
    assert accuracy.ppl_ratio(ref, test, tgt) == pytest.approx(
        jax_acc.ppl_ratio(ref, test, tgt), rel=1e-12)
    np.testing.assert_allclose(accuracy._log_softmax(test),
                               jax_acc._log_softmax(test), rtol=1e-12)
    same = accuracy.logit_metrics(ref, ref)
    assert same["kl"] == 0.0 and same["top1_agree"] == 1.0


def test_greedy_and_teacher_forced_match_jax(golden):
    """hidden 128 / 2 layers, f32: the continuation token for token, the
    teacher-forced prefill and decode logits within 2e-5."""
    cont_j, pre_j, dec_j = golden["ref_j"]
    cont_t, pre_t, dec_t = golden["ref_t"]
    np.testing.assert_array_equal(cont_t, cont_j)
    assert pre_t.shape == (2, 16, 256) and dec_t.shape == (2, CONT, 256)
    np.testing.assert_allclose(pre_t, pre_j, atol=2e-5, rtol=0)
    np.testing.assert_allclose(dec_t, dec_j, atol=2e-5, rtol=0)


@pytest.mark.parametrize("name,mode,gs", MODES, ids=[m[0] for m in MODES])
def test_quant_mode_row_matches_jax(golden, name, mode, gs):
    g = golden
    kw = dict(act_ranges=g["act_ranges"], kv_scales=g["kv_scales"],
              group_size=gs, cont_len=CONT)
    want = jax_eval.evaluate_quant_mode(
        g["cfg_j"], g["params_j"], name, JaxQuantMode(int(mode)),
        g["prompts"], ref_run=g["ref_j"], **kw)
    got = evaluate.evaluate_quant_mode(
        g["cfg_t"], g["params_t"], name, mode, g["prompts"],
        ref_run=g["ref_t"], device="cpu", **kw)
    g["rows"][name] = got
    assert got.keys() == want.keys() and got["mode"] == name
    positions = {"prefill_top1": 2 * 16, "decode_top1": 2 * CONT}
    for k, n in positions.items():
        assert abs(got[k] - want[k]) <= 1.0 / n + 1e-12, (k, got, want)
    for k in ("prefill_kl", "decode_kl"):
        assert abs(got[k] - want[k]) <= 2e-2 * max(got[k], want[k]) + 1e-7, (
            k, got, want)
    assert got["ppl_ratio"] == pytest.approx(want["ppl_ratio"], abs=2e-4)
    assert got["max_abs_err"] == pytest.approx(want["max_abs_err"], abs=5e-4)
    assert np.isfinite([got[k] for k in got if k != "mode"]).all()


def test_gate_orderings_hold(golden):
    """The JAX gates' ordering checks (tests/test_accuracy_gates.py:78-98)
    on the port's rows."""
    rows = golden["rows"]
    g = golden
    for name, mode, gs in MODES:     # rows not yet made by the parity test
        if name not in rows:
            rows[name] = evaluate.evaluate_quant_mode(
                g["cfg_t"], g["params_t"], name, mode, g["prompts"],
                act_ranges=g["act_ranges"], kv_scales=g["kv_scales"],
                group_size=gs, cont_len=CONT, ref_run=g["ref_t"],
                device="cpu")
    assert rows["int8-wo"]["decode_kl"] < rows["int4-wo"]["decode_kl"]
    assert rows["int8-wo"]["ppl_ratio"] < rows["int4-wo"]["ppl_ratio"]
    assert rows["sq-ptpc"]["decode_kl"] < rows["sq-static"]["decode_kl"]
    assert rows["int8-kv"]["prefill_kl"] == 0.0
    assert rows["int8-kv"]["decode_kl"] > 0.0


def test_build_golden_setup_params_match_jax():
    """The port builds the same HF model (same seed, on the CPU) and takes
    the same params from it; its ranges come from its own calibration ids
    but have the same keys and shapes."""
    kw = dict(hidden=64, layers=2, heads=4, intermediate=128, vocab=128)
    cfg_j, params_j, ranges_j, kv_j, _ = jax_eval.build_golden_setup(**kw)
    cfg_t, params_t, ranges_t, kv_t, hf = evaluate.build_golden_setup(
        **kw, device="cpu")
    assert cfg_t.hidden_size == 64 and cfg_t.dtype == "float32"
    flat_j = jax.tree_util.tree_flatten_with_path(_np_tree(params_j))[0]
    for path, leaf in flat_j:
        node = params_t
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), leaf, err_msg=str(path))
    assert ranges_t.keys() == ranges_j.keys()
    for k in ranges_j:
        assert ranges_t[k].shape == ranges_j[k].shape
        assert (ranges_t[k] > 0).all()
    assert kv_t.shape == kv_j.shape and (kv_t > 0).all()
    assert next(hf.parameters()).device.type == "cpu"


def test_build_golden_setup_independent_of_hash_seed():
    """JAX seeds its calibration ids with abs(hash(text)) % 2**32
    (quantization/evaluate.py:67 there), so its act ranges and KV scales
    change with PYTHONHASHSEED; the port's (zlib.crc32) do not."""
    code = ("import sys, numpy as np\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['trtllm_llama_tpu'] = None\n"
            "import torch\n"
            "torch.set_num_threads(1)\n"
            "from trtllm_llama_tpu_torch.quantization.evaluate import "
            "build_golden_setup\n"
            "_, _, r, kv, _ = build_golden_setup(hidden=64, layers=2, "
            "heads=4, intermediate=128, vocab=128, device='cpu')\n"
            "np.savez(sys.argv[1], kv=kv, **r)\n")
    outs = []
    for i, seed in enumerate(("1", "2")):
        path = Path(os.environ.get("TMPDIR", "/tmp")) / (
            f"golden_{os.getpid()}_{i}.npz")
        env = {**os.environ, "PYTHONHASHSEED": seed}
        res = subprocess.run([sys.executable, "-c", code, str(path)],
                             cwd=ROOT, env=env, capture_output=True,
                             text=True, timeout=240)
        assert res.returncode == 0, res.stderr
        with np.load(path) as z:
            outs.append({k: z[k] for k in z.files})
        path.unlink()
    assert outs[0].keys() == outs[1].keys() and "kv" in outs[0]
    for k in outs[0]:
        np.testing.assert_array_equal(outs[0][k], outs[1][k], err_msg=k)


def _jax_draws(params_j, rank=32, channel_sigma=0.5, outlier_frac=0.005,
               outlier_gain=6.0, seed=0):
    """The draws of the JAX structure_weights (quantization/evaluate.py:
    206-218 there), made with its own key splits, as torch tensors."""
    key = jax.random.PRNGKey(seed)
    draws = {}
    for name, w in params_j["layers"].items():
        if w.ndim != 3:
            continue
        l, k, n = w.shape
        key, k_u, k_v, k_c, k_m = jax.random.split(key, 5)
        u = jax.random.normal(k_u, (l, k, rank), jnp.float32)
        v = jax.random.normal(k_v, (l, rank, n), jnp.float32)
        c = jnp.exp(channel_sigma * jax.random.normal(k_c, (l, 1, n),
                                                      jnp.float32))
        mask = jax.random.uniform(k_m, (l, 1, n)) < outlier_frac
        c = jnp.where(mask, c * outlier_gain, c)
        draws[name] = tuple(torch.from_numpy(np.array(a)) for a in (u, v, c))
    return draws


def test_structure_weights_transform_matches_jax(golden):
    """The port's transform on JAX's own draws equals JAX's output within
    f32 rounding (1e-5 of the weight's largest); only the random streams
    of the two packages differ."""
    params_j, params_t = golden["params_j"], golden["params_t"]
    want = _np_tree(jax_eval.structure_weights(params_j))
    got = evaluate.structure_weights(params_t, draws=_jax_draws(params_j))
    for name, w in want["layers"].items():
        g = got["layers"][name].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, name
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)
        if w.ndim == 3:       # norms kept, projections renormalised
            np.testing.assert_allclose(
                np.linalg.norm(g, axis=(-2, -1)),
                np.linalg.norm(params_t["layers"][name].numpy(),
                               axis=(-2, -1)), rtol=1e-5)
    assert got["embed"] is params_t["embed"]


def test_structure_draws_shapes_and_seed(golden):
    params_t = golden["params_t"]
    a = evaluate.structure_draws(params_t, seed=3)
    b = evaluate.structure_draws(params_t, seed=3)
    names = [k for k, v in params_t["layers"].items() if v.dim() == 3]
    assert list(a) == names
    for name in names:
        l, k, n = params_t["layers"][name].shape
        u, v, c = a[name]
        assert u.shape == (l, k, 32) and v.shape == (l, 32, n)
        assert c.shape == (l, 1, n) and (c > 0).all()
        for x, y in zip(a[name], b[name]):
            assert torch.equal(x, y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rms_norm_quant_smoother_matches_jax(dtype):
    """The smoother divides the f32 normed row before the absmax, as the
    JAX plain path does: scales within 1e-6 relative, codes at most one
    apart (rsqrt against (var + eps) ** -0.5), nearly all equal."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 256)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(256)).astype(np.float32)
    sm = np.exp(rng.standard_normal(256) * 0.5).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    xt = torch.from_numpy(x).to(dtype)
    wt = torch.from_numpy(w).to(dtype)
    q_j, s_j = jax_rms_norm_quant(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                                  smoother=jnp.asarray(sm))
    q_t, s_t = rms_norm_quant(xt, wt, smoother=torch.from_numpy(sm))
    assert q_t.dtype == torch.int8 and s_t.shape == (2, 5, 1)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-6)
    diff = np.abs(q_t.numpy().astype(int) - np.asarray(q_j).astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() > 0.99
    q0, _ = rms_norm_quant(xt, wt)
    assert not torch.equal(q0, q_t)     # the smoother changes the codes
