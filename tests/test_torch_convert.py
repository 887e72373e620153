"""The port's offline build against the JAX package's: from_hf_config, the
HF state-dict mapping, calibration, the SmoothQuant migration, the engine
dir (format v2) in both directions, convert_hf_model, and static
SmoothQuant through the 2-D W8A8 entry (row 5).

Tolerances: the config, the HF mapping, the captured ranges and the engine
dir leaves are exact (the same torch model and the same bytes); the
migration within rtol 1e-6 (float64 powers, then f32); converted int8 codes
equal on >= 99.9% of entries and never more than one step apart (rounding
order), scales within rtol 1e-6; greedy tokens identical at tiny f32; f32
dense outputs rtol / atol 1e-5, W8A8 outputs rtol 1e-6.
"""

import dataclasses
import json
import types

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from trtllm_llama_tpu import EngineConfig as JaxEngineConfig
from trtllm_llama_tpu.config import ModelConfig as JaxModelConfig
from trtllm_llama_tpu.convert import convert as jax_convert
from trtllm_llama_tpu.convert import hf as jax_hf
from trtllm_llama_tpu.convert import serialize as jax_serialize
from trtllm_llama_tpu.models import llama as jax_llama
from trtllm_llama_tpu.ops import linear as jax_linear
from trtllm_llama_tpu.quantization import calibrate as jax_calibrate
from trtllm_llama_tpu.quantization import smoothquant as jax_smoothquant
from trtllm_llama_tpu.quantization import tensors as jax_tensors
from trtllm_llama_tpu.quantization.mode import QuantMode as JaxQuantMode
from trtllm_llama_tpu.quantization.quantize import (
    quantize_params as jax_quantize_params,
)
from trtllm_llama_tpu.runtime.sampling import SamplingConfig as JaxSampling
from trtllm_llama_tpu.runtime.session import (
    GenerationSession as JaxGenerationSession,
)
from trtllm_llama_tpu_torch import EngineConfig, ModelConfig, QuantMode
from trtllm_llama_tpu_torch.convert import convert, hf, serialize
from trtllm_llama_tpu_torch.convert.bridge import params_from_numpy
from trtllm_llama_tpu_torch.models import llama
from trtllm_llama_tpu_torch.ops import linear
from trtllm_llama_tpu_torch.ops.kernels import w8a8_matmul as w8a8
from trtllm_llama_tpu_torch.quantization import calibrate, smoothquant
from trtllm_llama_tpu_torch.quantization.tensors import WOQWeight
from trtllm_llama_tpu_torch.runtime.sampling import SamplingConfig
from trtllm_llama_tpu_torch.runtime.session import GenerationSession

torch.set_num_threads(1)

CALIB = ["the quick brown fox jumps over the lazy dog"] * 4
# mode name -> (QuantMode int, group size)
MODES = {
    "fp": (0, 0),
    "int8wo": (int(QuantMode.use_weight_only()), 0),
    "int4wo": (int(QuantMode.use_weight_only(True, per_group=True)), 16),
    "fp8": (int(QuantMode.FP8_QDQ), 0),
    "sq": (int(QuantMode.use_smooth_quant(per_token=True, per_channel=True)),
           0),
    "sq-static": (int(QuantMode.use_smooth_quant()
                      | QuantMode.INT8_KV_CACHE), 0),
    "int8kv": (int(QuantMode.INT8_KV_CACHE), 0),
    "fp8kv": (int(QuantMode.FP8_QDQ | QuantMode.FP8_KV_CACHE), 0),
}


@pytest.fixture(scope="module")
def hf_tiny():
    from transformers import LlamaConfig, LlamaForCausalLM

    torch.manual_seed(0)
    hf_cfg = LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
        max_position_embeddings=128)
    model = LlamaForCausalLM(hf_cfg).eval()

    class DummyTok:
        def __call__(self, text, **kw):
            ids = [(3 + (ord(c) % 100)) for c in text[:32]]
            return {"input_ids": torch.tensor([ids])}

    return model, DummyTok()


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)


def _hf_ns(**over):
    d = dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
             num_hidden_layers=32, num_attention_heads=32, rms_norm_eps=1e-6,
             max_position_embeddings=2048)
    d.update(over)
    return types.SimpleNamespace(**d)


@pytest.mark.parametrize("over", [
    {}, dict(num_key_value_heads=8, rope_theta=5e5, tie_word_embeddings=True),
    dict(rope_scaling={"type": "linear", "factor": 4.0},
         max_position_embeddings=8192),
    dict(rope_scaling={"rope_type": "dynamic", "factor": 2.0}),
    dict(rope_scaling={"type": "ntk", "factor": 8.0}, head_dim=64),
    dict(rope_scaling={"rope_type": "default"})])
def test_from_hf_config_matches_jax(over):
    got = ModelConfig.from_hf_config(_hf_ns(**over), dtype="float32")
    want = JaxModelConfig.from_hf_config(_hf_ns(**over), dtype="float32")
    assert json.loads(got.to_json()) == json.loads(want.to_json())
    assert ModelConfig.from_hf_config(_hf_ns()) == ModelConfig.llama_7b()


def test_from_hf_config_rejects_unsupported_rope_scaling():
    ns = _hf_ns(rope_scaling={"rope_type": "llama3", "factor": 8.0})
    with pytest.raises(ValueError):
        JaxModelConfig.from_hf_config(ns)
    with pytest.raises(ValueError, match="llama3"):
        ModelConfig.from_hf_config(ns)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tied", [False, True])
def test_params_from_hf_state_dict_matches_jax(hf_tiny, dtype, tied):
    model, _ = hf_tiny
    sd = model.state_dict()
    if tied:
        sd = {k: v for k, v in sd.items() if k != "lm_head.weight"}
    cfg = ModelConfig.from_hf_config(model.config, dtype=dtype)
    jcfg = JaxModelConfig.from_hf_config(model.config, dtype=dtype)
    got = hf.params_from_hf_state_dict(sd, cfg)
    want = params_from_numpy(jax.tree_util.tree_map(
        np.asarray, jax_hf.params_from_hf_state_dict(sd, jcfg)), "cpu")
    got_l, want_l = serialize.flatten(got), serialize.flatten(want)
    assert [n for n, _ in got_l] == [n for n, _ in want_l]
    for (name, a), (_, b) in zip(got_l, want_l):
        assert a.dtype == b.dtype and torch.equal(a, b), name
        assert a.is_contiguous(), name
    if tied:
        assert torch.equal(got["lm_head"], got["embed"].t())


def test_capture_activation_ranges_match_jax(hf_tiny):
    model, tok = hf_tiny
    got = calibrate.capture_activation_ranges(model, tok, CALIB[:2])
    want = jax_calibrate.capture_activation_ranges(model, tok, CALIB[:2])
    for part in ("x_absmax", "y_absmax", "w_absmax"):
        assert got[part].keys() == want[part].keys()
        for k in got[part]:
            np.testing.assert_array_equal(got[part][k], want[part][k])
    np.testing.assert_array_equal(got["kv_absmax"], want["kv_absmax"])
    for qmax in (127.0, 448.0):
        np.testing.assert_array_equal(
            calibrate.kv_scales_from_ranges(got, qmax),
            jax_calibrate.kv_scales_from_ranges(want, qmax))
    a, b = (calibrate.act_ranges_for_smoothquant(got),
            jax_calibrate.act_ranges_for_smoothquant(want))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == np.float32
        np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(ValueError, match="empty"):
        calibrate.capture_activation_ranges(model, tok, [])
    assert not any(m._forward_hooks for m in model.modules())


def test_weight_absmax_matches_the_capture(hf_tiny):
    model, tok = hf_tiny
    ranges = calibrate.capture_activation_ranges(model, tok, CALIB[:1])
    got = calibrate.weight_absmax(model.state_dict(), 2)
    for k, v in got.items():
        np.testing.assert_array_equal(v, ranges["w_absmax"][k])


def test_smooth_hf_state_dict_matches_jax_and_preserves_the_product(hf_tiny):
    model, tok = hf_tiny
    ranges = jax_calibrate.capture_activation_ranges(model, tok, CALIB[:2])
    sd = model.state_dict()
    before = {k: v.clone() for k, v in sd.items()}
    got_sd, got_x = smoothquant.smooth_hf_state_dict(sd, ranges, 2, alpha=0.5)
    want_sd, want_x = jax_smoothquant.smooth_hf_state_dict(sd, ranges, 2,
                                                           alpha=0.5)
    assert got_sd.keys() == want_sd.keys()
    for k in want_sd:
        np.testing.assert_allclose(_np(got_sd[k].float()), want_sd[k],
                                   rtol=1e-6, atol=0, err_msg=k)
    for k in want_x:
        np.testing.assert_allclose(got_x[k], want_x[k], rtol=1e-6)
    assert all(torch.equal(before[k], sd[k]) for k in sd)   # caller's intact
    s = smoothquant.smooth_scale(ranges["x_absmax"]["wq"][0],
                                 ranges["w_absmax"]["wq"][0])
    np.testing.assert_allclose(_np(s), jax_smoothquant.smooth_scale(
        ranges["x_absmax"]["wq"][0], ranges["w_absmax"]["wq"][0]), rtol=1e-6)

    # the migration leaves x . W^T unchanged: f32 logits of the port's model
    cfg = ModelConfig.from_hf_config(model.config, dtype="float32")
    ids = torch.as_tensor(np.random.default_rng(1).integers(3, 120, (1, 8)))
    lens = torch.tensor([8], dtype=torch.int32)
    logits = []
    for state in (sd, got_sd):
        caches = llama.init_caches(cfg, 1, 16, "cpu")
        logits.append(llama.forward_prefill(
            hf.params_from_hf_state_dict(state, cfg), cfg, ids, lens, caches,
            return_all_logits=True)[0])
    np.testing.assert_allclose(_np(logits[0]), _np(logits[1]), atol=2e-3,
                               rtol=1e-3)


def _jax_params(mode_name):
    qm, gs = MODES[mode_name]
    cfg = JaxModelConfig.tiny(dtype="float32", quant_mode=JaxQuantMode(qm),
                              group_size=gs)
    params = jax_llama.init_params(cfg, jax.random.PRNGKey(0))
    n_l = cfg.num_layers
    act = {k: np.full((n_l,), 2.5, np.float32) for k in
           ("wq", "wk", "wv", "w_gate", "w_up")}
    act.update(wo=np.asarray([1.5, 3.0], np.float32),
               w_down=np.asarray([4.0, 2.0], np.float32))
    params = jax_quantize_params(params, cfg.quant_mode, gs, act_ranges=act)
    kv = (np.asarray([0.05, 0.07], np.float32)
          if (cfg.quant_mode.has_int8_kv_cache()
              or cfg.quant_mode.has_fp8_kv_cache()) else None)
    return cfg, params, kv


def _containers_equal(a, b):
    assert type(a) is type(b)
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _containers_equal(a[k], b[k])
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.reshape(-1).view(torch.uint8),
                           b.reshape(-1).view(torch.uint8))
    elif dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _containers_equal(getattr(a, f.name), getattr(b, f.name))
    else:                                         # container metadata
        assert a == b


def _files(d):
    return {p.relative_to(d).as_posix(): p.read_bytes()
            for p in sorted(d.rglob("*.npy"))}


@pytest.mark.parametrize("mode_name", list(MODES))
def test_engine_dir_crosses_packages(tmp_path, mode_name):
    cfg, params, kv = _jax_params(mode_name)
    jax_serialize.save_engine(str(tmp_path / "jax"), cfg, params, kv)
    cfg_t, got, kv_t = serialize.load_engine(str(tmp_path / "jax"),
                                             device="cpu")
    assert json.loads(cfg_t.to_json()) == json.loads(cfg.to_json())
    assert (kv_t is None) == (kv is None)
    if kv is not None:
        np.testing.assert_array_equal(kv_t, kv)
    want = params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")
    _containers_equal(got, want)

    serialize.save_engine(str(tmp_path / "port"), cfg_t, got, kv_t)
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    for name in ("manifest.json", "config.json"):
        assert (json.loads((tmp_path / "port" / name).read_text())
                == json.loads((tmp_path / "jax" / name).read_text()))
    cfg_j, back, kv_j = jax_serialize.load_engine(str(tmp_path / "port"))
    assert cfg_j == cfg
    if kv is not None:
        np.testing.assert_array_equal(kv_j, kv)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(params))


def test_engine_dir_bf16_leaves_and_wrong_version(tmp_path):
    cfg = ModelConfig.tiny(dtype="bfloat16")
    params = {"embed": torch.randn(4, 8).to(torch.bfloat16),
              "layers": {"w": WOQWeight(torch.ones((2, 8, 16), dtype=torch.int8),
                                        torch.ones(2, 16))}}
    serialize.save_engine(str(tmp_path / "e"), cfg, params)
    meta = json.loads((tmp_path / "e" / "manifest.json").read_text())
    assert meta["leaves"]["embed"]["dtype"] == "bfloat16"
    assert np.load(tmp_path / "e" / "arrays" / "embed.npy").dtype == np.uint16
    _, j_params, _ = jax_serialize.load_engine(str(tmp_path / "e"))
    np.testing.assert_array_equal(
        np.asarray(j_params["embed"], np.float32),
        params["embed"].float().numpy())
    meta["format_version"] = 1
    (tmp_path / "e" / "manifest.json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="format_version"):
        serialize.load_engine(str(tmp_path / "e"), device="cpu")
    with pytest.raises(ValueError):
        jax_serialize.load_engine(str(tmp_path / "e"))
    with pytest.raises(ValueError):               # list nodes do not encode
        serialize.save_engine(str(tmp_path / "f"), cfg, {"a": [torch.ones(1)]})


def _codes_close(got, want):
    got, want = np.asarray(got, np.int32), np.asarray(want, np.int32)
    assert np.mean(got == want) >= 0.999
    assert np.abs(got - want).max() <= 1


def _generate_port(engine_dir, ids):
    cfg, params, kv = serialize.load_engine(engine_dir, device="cpu")
    sess = GenerationSession(cfg, params, EngineConfig(max_input_len=16,
                                                       max_seq_len=64),
                             kv_scales=kv, device="cpu")
    return sess.generate(ids, max_new_tokens=6,
                         sampling=SamplingConfig(end_id=-1)).output_ids


def _generate_jax(engine_dir, ids):
    cfg, params, kv = jax_serialize.load_engine(engine_dir)
    sess = JaxGenerationSession(cfg, params, JaxEngineConfig(
        max_input_len=16, max_seq_len=64), kv_scales=kv)
    return np.asarray(sess.generate(ids, max_new_tokens=6,
                                    sampling=JaxSampling(end_id=-1)).output_ids)


@pytest.mark.parametrize("mode_name", list(MODES))
def test_convert_hf_model_matches_jax(hf_tiny, tmp_path, mode_name):
    model, tok = hf_tiny
    qm, gs = MODES[mode_name]
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    cfg = convert.convert_hf_model(model, tok, port_dir,
                                   quant_mode=QuantMode(qm), group_size=gs,
                                   dtype="float32", calib_texts=CALIB)
    jcfg = jax_convert.convert_hf_model(model, tok, jax_dir,
                                        quant_mode=JaxQuantMode(qm),
                                        group_size=gs, dtype="float32",
                                        calib_texts=CALIB)
    assert json.loads(cfg.to_json()) == json.loads(jcfg.to_json())
    _, got, kv_got = serialize.load_engine(port_dir, device="cpu")
    _, want, kv_want = serialize.load_engine(jax_dir, device="cpu")
    if kv_want is not None:
        np.testing.assert_allclose(kv_got, kv_want, rtol=1e-6)
    got_l, want_l = serialize.flatten(got), serialize.flatten(want)
    assert [n for n, _ in got_l] == [n for n, _ in want_l]
    for (name, a), (_, b) in zip(got_l, want_l):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.dtype in (torch.int8, torch.uint8):
            _codes_close(a.numpy(), b.numpy())
        else:
            np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                       rtol=1e-6, atol=0, err_msg=name)
    ids = np.random.default_rng(0).integers(3, 120, (2, 8))
    np.testing.assert_array_equal(_generate_port(port_dir, ids),
                                  _generate_jax(jax_dir, ids))


def test_convert_hf_model_fp8kv_engine_dir_equals_jax(hf_tiny, tmp_path):
    """bench.py's fp8kv (fp8 projections, an e4m3 KV cache) built by both
    converters from one HF model: the engine dirs are equal byte for byte,
    the KV scales are the calibrated K/V ranges over 448 (e4m3's largest
    value), and either package's loader gives the same greedy tokens."""
    model, tok = hf_tiny
    mode = QuantMode.FP8_QDQ | QuantMode.FP8_KV_CACHE
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    convert.convert_hf_model(model, tok, str(port_dir), quant_mode=mode,
                             dtype="float32", calib_texts=CALIB)
    jax_convert.convert_hf_model(model, tok, str(jax_dir),
                                 quant_mode=JaxQuantMode(int(mode)),
                                 dtype="float32", calib_texts=CALIB)
    assert _files(port_dir) == _files(jax_dir) and _files(port_dir)
    for name in ("manifest.json", "config.json"):
        assert (json.loads((port_dir / name).read_text())
                == json.loads((jax_dir / name).read_text()))
    cfg, params, kv = serialize.load_engine(str(port_dir), device="cpu")
    assert cfg.kv_dtype == "fp8" and params["layers"]["wq"].qweight.dtype \
        == torch.uint8
    ranges = calibrate.capture_activation_ranges(model, tok, CALIB)
    np.testing.assert_array_equal(
        kv, calibrate.kv_scales_from_ranges(ranges, qmax=448.0))
    ids = np.random.default_rng(0).integers(3, 120, (2, 8))
    np.testing.assert_array_equal(_generate_port(str(port_dir), ids),
                                  _generate_jax(str(jax_dir), ids))


def test_convert_hf_model_needs_calibration_texts(hf_tiny, tmp_path):
    model, tok = hf_tiny
    with pytest.raises(ValueError, match="calib_texts"):
        convert.convert_hf_model(model, tok, str(tmp_path / "e"),
                                 quant_mode=QuantMode.INT8_KV_CACHE)


def test_convert_hf_checkpoint_rejects_mixtral(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps({
        "model_type": "mixtral", "architectures": ["MixtralForCausalLM"]}))
    with pytest.raises(NotImplementedError, match="hf_moe"):
        convert.convert_hf_checkpoint(str(tmp_path), str(tmp_path / "out"))


@pytest.mark.parametrize("device", [None, "cpu"])
def test_convert_hf_checkpoint_converts_on_the_device(hf_tiny, tmp_path,
                                                      monkeypatch, device):
    """The checkpoint is loaded, moved to `device` (the card when none is
    given) and converted there. On the CPU its engine dir equals the one
    convert_hf_model writes from the model in memory, byte for byte."""
    import transformers

    model, tok = hf_tiny
    model.save_pretrained(str(tmp_path / "hf"))
    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                        lambda *a, **kw: tok)
    moved = []
    if device is None:      # no card here: record the move, stay on the CPU
        monkeypatch.setattr(transformers.LlamaForCausalLM, "to",
                            lambda self, dev: moved.append(dev) or self)
    else:
        to = transformers.LlamaForCausalLM.to
        monkeypatch.setattr(transformers.LlamaForCausalLM, "to",
                            lambda self, dev: moved.append(dev) or to(self, dev))
    qm, gs = MODES["sq-static"]
    kw = dict(quant_mode=QuantMode(qm), group_size=gs, dtype="float32",
              calib_texts=CALIB)
    dev = {} if device is None else dict(device=device)
    cfg = convert.convert_hf_checkpoint(str(tmp_path / "hf"),
                                        str(tmp_path / "ckpt"), **dev, **kw)
    assert moved == [device or "cuda"]
    want_cfg = convert.convert_hf_model(model, tok, str(tmp_path / "mem"),
                                        **kw)
    assert cfg == want_cfg
    _, got, kv_got = serialize.load_engine(str(tmp_path / "ckpt"),
                                           device="cpu")
    _, want, kv_want = serialize.load_engine(str(tmp_path / "mem"),
                                             device="cpu")
    np.testing.assert_array_equal(kv_got, kv_want)
    got_l, want_l = serialize.flatten(got), serialize.flatten(want)
    assert [n for n, _ in got_l] == [n for n, _ in want_l]
    for (name, a), (_, b) in zip(got_l, want_l):
        assert a.dtype == b.dtype and torch.equal(a, b), name


@pytest.mark.parametrize("per_channel", [False, True])
def test_static_sq_dense_takes_the_2d_entry(per_channel, monkeypatch):
    """A stacked static SQWeight with a layer is indexed (views) and runs
    the 2-D w8a8_matmul (row 5), as the JAX dense does; a per-token one
    keeps the stacked entry (row 6)."""
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((3, 128, 64)) * 0.05).astype(np.float32)
    x = rng.standard_normal((2, 5, 128)).astype(np.float32)
    amax = np.asarray([3.0, 2.5, 4.0], np.float32)
    calls = []
    for name in ("w8a8_matmul", "w8a8_matmul_stacked"):
        real = getattr(w8a8, name)

        def spy(*a, _real=real, _name=name):
            calls.append((_name, a[1].data_ptr(), tuple(a[1].shape)))
            return _real(*a)
        monkeypatch.setattr(w8a8, name, spy)
    for per_token in (False, True):
        jw = jax_tensors.quantize_smoothquant_weight(
            jnp.asarray(w), jnp.asarray(amax), per_channel=per_channel,
            per_token=per_token)
        tw = params_from_numpy({"w": jax.tree_util.tree_map(np.asarray, jw)},
                               "cpu")["w"]
        calls.clear()
        got = linear.dense(torch.from_numpy(x), tw, layer=2)
        want = jax_linear.dense(jnp.asarray(x), jw, layer=2)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
        if per_token:
            assert [c[0] for c in calls] == ["w8a8_matmul_stacked"]
        else:
            # the layer's view of the stacked weight, no copy
            assert calls == [("w8a8_matmul", tw.qweight[2].data_ptr(),
                              (128, 64))]
