"""The PyTorch port stands alone: no module of trtllm_llama_tpu_torch, nor
chip_smoke.py, imports JAX or the JAX package, and the port imports and
generates on the CPU (int8 weight-only, SmoothQuant with an int8 KV cache,
int4 g64 and fp8 with a quantized lm_head; every prompt through the
streaming prefill and the 'split' and 'fused' decode modes; the five
decoder families of models/decoder.py, picked by models.by_architecture,
Bloom's ALiBi included) and serves (a paged and a packed ServingEngine)
with both made unimportable."""

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
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    names = {f.relative_to(ROOT).as_posix() for f in files}
    assert {"trtllm_llama_tpu_torch/models/decoder.py",
            "trtllm_llama_tpu_torch/models/__init__.py"} <= names
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
assert not any(m == "jax" or m.startswith(("jax.", "trtllm_llama_tpu."))
               for m in sys.modules if sys.modules[m] is not None)
print("ok", out.output_ids.tolist())
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")
