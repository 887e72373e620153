"""The PyTorch port stands alone: no module of trtllm_llama_tpu_torch, nor
chip_smoke.py, gemm_breakdown.py, gemv_breakdown.py,
attention_precision.py, decode_breakdown.py or streaming_breakdown.py,
imports JAX or
the JAX package, and the port imports and
generates on the CPU (int8 weight-only, SmoothQuant with an int8 KV cache,
int4 g64 and fp8 with a quantized lm_head; every prompt through the
streaming prefill and the 'split' and 'fused' decode modes; the five
decoder families of models/decoder.py, picked by models.by_architecture,
Bloom's ALiBi included; the offline build from an HF-layout state dict
through SmoothQuant, static W8A8 + int8 KV, the engine dir and the loader,
generating under TLLM_FUSE_GU; the decode probes; a sampled generate with
penalties, bad and stop words and logprobs; beam search, dense and paged;
GPT-2 with a prompt-tuning table under a repetition penalty; the accuracy
harness on an in-process HF golden model with structured weights;
ChatGLM through the non-causal prefill, its converter and a self-draft
speculative run; BERT's QA head through InferenceSession with bucket
padding)
and serves (a paged and a packed ServingEngine, one with per-request
sampling, logprobs and bad words, chunked prefill, mixed and pipelined
steps, dense and paged, and OPT through model= with chunking; the
speculative sessions and engines, random draft and prompt lookup on
make_copy_params' weights, greedy and sampled) with both made
unimportable. The tensor-parallel modules (parallel/mapping, sharding,
comm, launch) and the ranks' worker of tests/test_torch_tp.py import
neither; that test runs its ranks with both unimportable."""

import ast
import subprocess
import sys
from pathlib import Path

import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "trtllm_llama_tpu")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(name):
    top = name.split(".")[0]
    return top in FORBIDDEN


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "trtllm_llama_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "gemm_breakdown.py",
              ROOT / "gemv_breakdown.py",
              ROOT / "attention_precision.py", ROOT / "decode_breakdown.py",
              ROOT / "streaming_breakdown.py",
              ROOT / "tests" / "torch_tp_worker.py"]
    assert len(files) > 15
    names = {f.relative_to(ROOT).as_posix() for f in files}
    assert {"trtllm_llama_tpu_torch/models/decoder.py",
            "trtllm_llama_tpu_torch/models/__init__.py",
            "trtllm_llama_tpu_torch/convert/serialize.py",
            "trtllm_llama_tpu_torch/convert/hf.py",
            "trtllm_llama_tpu_torch/convert/convert.py",
            "trtllm_llama_tpu_torch/quantization/calibrate.py",
            "trtllm_llama_tpu_torch/quantization/smoothquant.py",
            "trtllm_llama_tpu_torch/ops/kernels/probes.py",
            "trtllm_llama_tpu_torch/runtime/beam.py",
            "trtllm_llama_tpu_torch/runtime/sampling.py",
            "trtllm_llama_tpu_torch/runtime/speculative.py",
            "trtllm_llama_tpu_torch/runtime/serving_spec.py",
            "trtllm_llama_tpu_torch/quantization/evaluate.py",
            "trtllm_llama_tpu_torch/parallel/mapping.py",
            "trtllm_llama_tpu_torch/parallel/sharding.py",
            "trtllm_llama_tpu_torch/parallel/comm.py",
            "trtllm_llama_tpu_torch/parallel/launch.py",
            "trtllm_llama_tpu_torch/utils/accuracy.py",
            "trtllm_llama_tpu_torch/models/gpt.py",
            "trtllm_llama_tpu_torch/convert/hf_gpt.py",
            "trtllm_llama_tpu_torch/convert/hf_families.py",
            "trtllm_llama_tpu_torch/models/chatglm.py",
            "trtllm_llama_tpu_torch/convert/hf_chatglm.py",
            "trtllm_llama_tpu_torch/models/bert.py",
            "trtllm_llama_tpu_torch/convert/hf_bert.py",
            "trtllm_llama_tpu_torch/runtime/single_shot.py",
            "tests/torch_tp_worker.py"} <= names
    bad = [(f.relative_to(ROOT), m) for f in files
           for m in _imported_modules(f) if _forbidden(m)]
    assert not bad, bad


def test_port_generates_with_jax_unimportable():
    code = """
import sys
sys.modules["jax"] = None
sys.modules["trtllm_llama_tpu"] = None
import torch
torch.set_num_threads(1)
from trtllm_llama_tpu_torch import EngineConfig, ModelConfig, QuantMode
from trtllm_llama_tpu_torch.quantization.quantize import init_random_quantized_params
from trtllm_llama_tpu_torch.runtime.sampling import SamplingConfig
from trtllm_llama_tpu_torch.runtime.session import GenerationSession
import chip_smoke
cfg = ModelConfig.tiny(dtype="float32", quant_mode=QuantMode.use_weight_only())
sess = GenerationSession(cfg, init_random_quantized_params(cfg, device="cpu"),
                         EngineConfig(max_input_len=16, max_seq_len=32),
                         device="cpu")
out = sess.generate([[5, 6, 7], [8, 9]], sampling=SamplingConfig(end_id=-1),
                    max_new_tokens=4)
assert out.output_ids.shape == (2, 4), out.output_ids.shape
out = sess.generate([[5, 6, 7], [8, 9]], max_new_tokens=4, seed=1,
                    return_logprobs=True, sampling=SamplingConfig(
                        temperature=0.8, top_k=40, top_p=0.95,
                        repetition_penalty=1.1, bad_words=((3, 4),),
                        stop_words=((7, 7),), end_id=-1))
assert out.logprobs.shape == (2, 4), out.logprobs.shape
for block in (0, 8):
    beam = GenerationSession(cfg, sess.params, EngineConfig(
        max_batch_size=4, max_input_len=16, max_seq_len=32), device="cpu",
        beam_paged_block=block).generate(
        [[5, 6, 7], [8, 9]], max_new_tokens=4,
        sampling=SamplingConfig(beam_width=2, end_id=-1))
    assert beam.beam_ids.shape == (2, 2, 4), beam.beam_ids.shape
sq = ModelConfig.tiny(dtype="float32", quant_mode=QuantMode.use_smooth_quant(
    per_token=True, per_channel=True) | QuantMode.INT8_KV_CACHE)
sess = GenerationSession(sq, init_random_quantized_params(sq, device="cpu"),
                         EngineConfig(max_input_len=16, max_seq_len=32),
                         kv_scales=[0.05, 0.05], device="cpu")
out = sess.generate([[5, 6, 7], [8, 9]], sampling=SamplingConfig(end_id=-1),
                    max_new_tokens=4)
assert out.output_ids.shape == (2, 4), out.output_ids.shape
from trtllm_llama_tpu_torch.ops.registry import KERNELS
KERNELS["prefill_streaming_min_s"] = 0
for mode in ("split", "fused"):
    KERNELS["decode_attn_mode"] = mode
    assert (sess.generate([[5, 6, 7], [8, 9]], sampling=SamplingConfig(
        end_id=-1), max_new_tokens=4).output_ids == out.output_ids).all()
KERNELS.update(prefill_streaming_min_s=2048, decode_attn_mode="auto")
from trtllm_llama_tpu_torch.quantization.quantize import quantize_params
for mode in (QuantMode.use_weight_only(True, per_group=True),
             QuantMode.FP8_QDQ):
    cfg = ModelConfig.tiny(dtype="float32", quant_mode=mode, group_size=64)
    params = quantize_params(init_random_quantized_params(cfg, device="cpu"),
                             mode, quantize_lm_head=True)
    sess = GenerationSession(cfg, params, EngineConfig(max_input_len=16,
                             max_seq_len=32), device="cpu")
    out = sess.generate([[5, 6, 7], [8, 9]],
                        sampling=SamplingConfig(end_id=-1), max_new_tokens=4)
    assert out.output_ids.shape == (2, 4), out.output_ids.shape
from trtllm_llama_tpu_torch.models import by_architecture
for arch, over in (("gptj", dict(rotary_dim=16)), ("gptneox", {}),
                   ("bloom", {}), ("opt", {}), ("falcon", dict(num_kv_heads=1))):
    cfg = ModelConfig.tiny(dtype="float32", architecture=arch, **over)
    params = by_architecture(arch).init_params(cfg, device="cpu")
    sess = GenerationSession(cfg, params, EngineConfig(max_input_len=16,
                             max_seq_len=32), device="cpu")
    out = sess.generate([[5, 6, 7], [8, 9]],
                        sampling=SamplingConfig(end_id=-1), max_new_tokens=4)
    assert out.output_ids.shape == (2, 4), (arch, out.output_ids.shape)
from trtllm_llama_tpu_torch.runtime.serving import ServingEngine
cfg = ModelConfig.tiny(dtype="float32", quant_mode=QuantMode.use_weight_only())
params = init_random_quantized_params(cfg, device="cpu")
for opts in (dict(paged=True, block_size=8), dict(packed_prefill=True)):
    eng = ServingEngine(cfg, params, EngineConfig(max_batch_size=2,
                        max_input_len=16, max_seq_len=32),
                        sampling=SamplingConfig(end_id=-1), decode_chunk=4,
                        device="cpu", **opts)
    rids = [eng.submit(p, 5) for p in ([5, 6, 7], [8, 9], [10, 11, 12, 13])]
    done = eng.run_to_completion()
    assert sorted(done) == rids and all(
        len(done[r].output_ids) == 5 for r in rids), done
eng = ServingEngine(cfg, params, EngineConfig(max_batch_size=2,
                    max_input_len=16, max_seq_len=32),
                    sampling=SamplingConfig(end_id=-1), decode_chunk=4,
                    device="cpu", per_request_sampling=True,
                    return_logprobs=True, max_bad_words=2)
rids = [eng.submit([5, 6, 7], 5, sampling=SamplingConfig(
            temperature=0.7, top_p=0.9, end_id=-1, bad_words=((9,),))),
        eng.submit([8, 9], 5)]
done = eng.run_to_completion()
assert all(len(done[r].logprobs) == len(done[r].output_ids) for r in rids)
from trtllm_llama_tpu_torch.models import decoder
ocfg = ModelConfig.tiny(dtype="float32", architecture="opt")
for c, p, opts in ((cfg, params, dict(prefill_chunk=16)),
                   (cfg, params, dict(mixed_step=True)),
                   (cfg, params, dict(pipelined=True)),
                   (cfg, params, dict(pipelined=True, paged=True,
                                      block_size=8)),
                   (ocfg, decoder.OPT.init_params(ocfg, device="cpu"),
                    dict(model=decoder.OPT, prefill_chunk=16))):
    eng = ServingEngine(c, p, EngineConfig(max_batch_size=2,
                        max_input_len=40, max_seq_len=64),
                        sampling=SamplingConfig(end_id=-1), decode_chunk=4,
                        device="cpu", **opts)
    rids = [eng.submit(list(range(3, 3 + n)), 5) for n in (3, 35, 20)]
    done = eng.run_to_completion()
    assert sorted(done) == rids and all(
        len(done[r].output_ids) == 5 for r in rids), (opts, done)
from trtllm_llama_tpu_torch.quantization.evaluate import make_copy_params
from trtllm_llama_tpu_torch.runtime.serving_spec import (
    PromptLookupServingEngine, SpeculativeServingEngine)
from trtllm_llama_tpu_torch.runtime.speculative import (
    PromptLookupSession, SpeculativeSession)
dcfg = ModelConfig.tiny(dtype="float32", num_layers=1)
dparams = init_random_quantized_params(dcfg, seed=1, device="cpu")
ecfg = EngineConfig(max_batch_size=2, max_input_len=16, max_seq_len=32)
cparams = make_copy_params(cfg, params, [11, 23, 5, 42])
for sess in (SpeculativeSession(cfg, params, dcfg, dparams, ecfg, gamma=2,
                                device="cpu"),
             PromptLookupSession(cfg, cparams, ecfg, gamma=2, ngram=2,
                                 device="cpu")):
    out = sess.generate([[11, 23, 5, 42] * 2, [8, 9]], max_new_tokens=6,
                        sampling=SamplingConfig(end_id=-1))
    assert out.output_ids.shape == (2, 6) and sess.last_iters <= 6
out = SpeculativeSession(cfg, params, dcfg, dparams, ecfg, device="cpu").generate(
    [[5, 6, 7]], max_new_tokens=4, seed=2, sampling=SamplingConfig(
        temperature=0.8, top_k=8, end_id=-1))
assert out.lengths.tolist() == [4], out.lengths
for eng in (SpeculativeServingEngine(cfg, params, dcfg, dparams, ecfg,
                                     sampling=SamplingConfig(end_id=-1),
                                     decode_chunk=4, device="cpu",
                                     per_request_sampling=True,
                                     return_logprobs=True),
            PromptLookupServingEngine(cfg, cparams, ecfg,
                                      sampling=SamplingConfig(end_id=-1),
                                      decode_chunk=4, device="cpu")):
    rids = [eng.submit(list(range(3, 3 + n)), 5) for n in (3, 9, 6)]
    done = eng.run_to_completion()
    assert sorted(done) == rids and all(
        len(done[r].output_ids) == 5 for r in rids), done
import os, shutil, tempfile, types
import numpy as np
from trtllm_llama_tpu_torch.convert.convert import cast_fp_leaves
from trtllm_llama_tpu_torch.convert.hf import params_from_hf_state_dict
from trtllm_llama_tpu_torch.convert.serialize import load_engine, save_engine
from trtllm_llama_tpu_torch.quantization.calibrate import (
    act_ranges_for_smoothquant, kv_scales_from_ranges, weight_absmax)
from trtllm_llama_tpu_torch.quantization.smoothquant import smooth_hf_state_dict
hf = types.SimpleNamespace(vocab_size=64, hidden_size=32, intermediate_size=64,
                           num_hidden_layers=2, num_attention_heads=2,
                           rms_norm_eps=1e-6, max_position_embeddings=64)
mode = QuantMode.use_smooth_quant() | QuantMode.INT8_KV_CACHE
cfg = ModelConfig.from_hf_config(hf, dtype="float32", quant_mode=mode)
g = torch.Generator().manual_seed(0)
shapes = {"self_attn.q_proj": (32, 32), "self_attn.k_proj": (32, 32),
          "self_attn.v_proj": (32, 32), "self_attn.o_proj": (32, 32),
          "mlp.gate_proj": (64, 32), "mlp.up_proj": (64, 32),
          "mlp.down_proj": (32, 64)}
sd = {f"model.layers.{i}.{k}.weight": torch.randn(s, generator=g) * 0.2
      for i in range(2) for k, s in shapes.items()}
sd.update({f"model.layers.{i}.{n}.weight": torch.ones(32) for i in range(2)
           for n in ("input_layernorm", "post_attention_layernorm")})
sd.update({"model.embed_tokens.weight": torch.randn(64, 32, generator=g),
           "lm_head.weight": torch.randn(64, 32, generator=g) * 0.2,
           "model.norm.weight": torch.ones(32)})
x = {k: np.abs(np.random.default_rng(0).standard_normal((2, 64 if k == "w_down"
     else 32))) for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")}
for k in ("wk", "wv"):
    x[k] = x["wq"].copy()
x["w_up"] = x["w_gate"].copy()
ranges = {"x_absmax": x, "w_absmax": weight_absmax(sd, 2),
          "kv_absmax": np.full(2, 6.35)}
sd, x_sm = smooth_hf_state_dict(sd, ranges, 2)
params = quantize_params(params_from_hf_state_dict(sd, cfg, "float32"), mode,
                         act_ranges=act_ranges_for_smoothquant({"x_absmax": x_sm}))
engine_dir = tempfile.mkdtemp()
save_engine(engine_dir, cfg, cast_fp_leaves(params, torch.float32),
            kv_scales_from_ranges(ranges))
cfg2, loaded, kv2 = load_engine(engine_dir, device="cpu")
shutil.rmtree(engine_dir)
os.environ["TLLM_FUSE_GU"] = "1"
sess = GenerationSession(cfg2, loaded, EngineConfig(max_input_len=16,
                         max_seq_len=32), kv_scales=kv2, device="cpu")
assert "w_gate_up" in sess.params["layers"]
out = sess.generate([[5, 6, 7], [8, 9]], sampling=SamplingConfig(end_id=-1),
                    max_new_tokens=4)
assert out.output_ids.shape == (2, 4), out.output_ids.shape
from trtllm_llama_tpu_torch.parallel import Mapping, comm, launch
from trtllm_llama_tpu_torch.parallel.sharding import shard_params
sys.path.insert(0, "tests")
import torch_tp_worker
x = torch.ones(3)
assert comm.all_reduce_sum(x, None) is x and comm.gather_columns(x, None) is x
assert shard_params(loaded, Mapping(), 0) is loaded
assert launch.free_port() > 0 and torch_tp_worker.serve_prompts()
from trtllm_llama_tpu_torch.models import gpt
from trtllm_llama_tpu_torch.quantization import evaluate
gcfg = ModelConfig.tiny(dtype="float32", architecture="gpt2")
gparams = gpt.init_params(gcfg, device="cpu")
pt = gpt.PromptTuning(gparams["embed"][[5, 6, 7, 8]], torch.tensor([0]), 4)
out = GenerationSession(gcfg, gparams, EngineConfig(max_input_len=16,
                        max_seq_len=32), device="cpu").generate(
    [[256, 257, 9, 10]], max_new_tokens=4, prompt=pt,
    sampling=SamplingConfig(repetition_penalty=1.2, end_id=-1))
assert out.output_ids.shape == (1, 4), out.output_ids.shape
ecfg_, eparams, ranges, kv, _ = evaluate.build_golden_setup(
    hidden=64, layers=1, heads=2, intermediate=128, vocab=128, device="cpu")
prompts = np.random.default_rng(0).integers(3, 128, (1, 8))
row = evaluate.evaluate_quant_mode(
    ecfg_, evaluate.structure_weights(eparams), "int8-wo+kv",
    QuantMode.use_weight_only() | QuantMode.INT8_KV_CACHE, prompts,
    kv_scales=kv, cont_len=4, device="cpu")
assert np.isfinite(row["ppl_ratio"]), row
from trtllm_llama_tpu_torch.convert.hf_chatglm import (
    config_from_chatglm, params_from_chatglm_state_dict)
from trtllm_llama_tpu_torch.models import bert, chatglm
from trtllm_llama_tpu_torch.runtime.single_shot import InferenceSession
ccfg = config_from_chatglm(num_layers=1, hidden_size=64, num_heads=2,
                           vocab_size=128, max_positions=64, dtype="float32")
cp = chatglm.init_params(ccfg, device="cpu")
assert set(params_from_chatglm_state_dict({
    "transformer.word_embeddings.weight": cp["embedding"],
    "transformer.final_layernorm.weight": cp["final_norm_w"],
    "transformer.final_layernorm.bias": cp["final_norm_b"],
    "lm_head.weight": cp["lm_head"].t(),
    **{f"transformer.layers.0.{n}": t for n, t in (
        ("attention.query_key_value.weight", torch.zeros(192, 64)),
        ("attention.query_key_value.bias", torch.zeros(192)),
        ("attention.dense.weight", torch.zeros(64, 64)),
        ("attention.dense.bias", torch.zeros(64)),
        ("input_layernorm.weight", torch.ones(64)),
        ("input_layernorm.bias", torch.zeros(64)),
        ("post_attention_layernorm.weight", torch.ones(64)),
        ("post_attention_layernorm.bias", torch.zeros(64)),
        ("mlp.dense_h_to_4h.weight", torch.zeros(256, 64)),
        ("mlp.dense_h_to_4h.bias", torch.zeros(256)),
        ("mlp.dense_4h_to_h.weight", torch.zeros(64, 256)),
        ("mlp.dense_4h_to_h.bias", torch.zeros(64)))}}, ccfg)["layers"]) == set(
    cp["layers"])
ecfg = EngineConfig(max_batch_size=2, max_input_len=16, max_seq_len=32)
plain = GenerationSession(ccfg, cp, ecfg, device="cpu", model=chatglm).generate(
    [[5, 6, 7, 8], [9, 10]], max_new_tokens=4, sampling=SamplingConfig(end_id=-1))
spec = SpeculativeSession(ccfg, cp, ccfg, cp, ecfg, gamma=2, model=chatglm,
                          draft_model=chatglm, device="cpu").generate(
    [[5, 6, 7, 8], [9, 10]], max_new_tokens=4, sampling=SamplingConfig(end_id=-1))
assert (plain.output_ids == spec.output_ids).all(), (plain, spec)
bcfg = bert.BertConfig(vocab_size=64, hidden_size=64, num_layers=1, num_heads=2,
                       intermediate_size=128, max_position_embeddings=32)
start, end = InferenceSession(bert.forward_qa, bcfg, bert.init_params(
    bcfg, device="cpu", qa_head=True), pad_axis=1, buckets=(8, 16),
    device="cpu").run(np.array([[5, 6, 7]], np.int32), np.array([3], np.int32))
assert start.shape == end.shape == (1, 8), start.shape
from trtllm_llama_tpu_torch.ops.kernels import probes
assert probes.probe_u32_bf16_construct(probes.construct_inputs()).float()[
    0:2, 89].tolist() == [200.0, 168.0]
assert not any(m == "jax" or m.startswith(("jax.", "trtllm_llama_tpu."))
               for m in sys.modules if sys.modules[m] is not None)
print("ok", out.output_ids.tolist())
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")
