"""The accuracy harness, GPT-2 and the GEMM's ragged K tile on the card.

Marked `cuda`; every test skips without a CUDA device. On a machine with
one (which need not have JAX), run:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_accuracy.py

- `evaluate_quant_mode` at a golden model of head dim 32 (hidden 128, 4
  heads, 2 layers, f32), built and calibrated on the card: each of the ten
  gated modes on the card against the same mode on the CPU's plain
  versions (same params, ranges and continuation): KL within 5% of the
  larger + 1e-6, ppl ratio within 2e-3, top-1 at most one position apart.
- A tiny HF GPT-2 (n_embd 320 = 2.5 GEMM tiles, 5 heads of 64) built on
  the card: f32 logits within 1e-4 of HF's; prompt-tuning tokens
  identical to the real-token run; int8 weight-only bs4 (64-row prefill
  on the GEMM with its ragged last K tile), tokens equal to the plain
  path's but at near ties (5% of the largest logit).
- The woq / fp8 GEMM at K not whole 128-row tiles (int8, int4
  per-channel, fp8 in logical order): against the plain version, and bit
  for bit against the same call on operands zero-padded to whole tiles.
"""

import dataclasses

import numpy as np
import pytest
import torch

from trtllm_llama_tpu_torch import EngineConfig, QuantMode
from trtllm_llama_tpu_torch.ops.kernels import fp8_matmul as f8k
from trtllm_llama_tpu_torch.ops.kernels import woq_matmul as woq
from trtllm_llama_tpu_torch.quantization.tensors import (
    FP8Weight, WOQWeight, quantize_fp8_weight, quantize_weight_only,
)
from trtllm_llama_tpu_torch.runtime.sampling import SamplingConfig

pytestmark = pytest.mark.cuda

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
_GOLDEN = {}


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture
def golden():
    _need_cuda()
    if not _GOLDEN:
        from trtllm_llama_tpu_torch.quantization import evaluate
        cfg, params, ranges, kv, _ = evaluate.build_golden_setup(
            hidden=128, layers=2, heads=4, intermediate=256, vocab=256,
            device="cuda")
        prompts = np.random.default_rng(0).integers(3, 256, (2, 16))
        ref = evaluate.reference_run(cfg, params, prompts, 10)
        cpu = {"layers": {k: v.cpu() for k, v in params["layers"].items()},
               **{k: v.cpu() for k, v in params.items() if k != "layers"}}
        ref_cpu = (ref[0], *evaluate.teacher_forced_logits(
            cfg, cpu, prompts, ref[0], device="cpu"))
        _GOLDEN.update(cfg=cfg, params=params, cpu=cpu, ranges=ranges, kv=kv,
                       prompts=prompts, ref=ref, ref_cpu=ref_cpu)
    return _GOLDEN


@pytest.mark.parametrize("name,mode,gs", MODES, ids=[m[0] for m in MODES])
def test_card_rows_match_the_cpu(golden, name, mode, gs):
    from trtllm_llama_tpu_torch.quantization.evaluate import (
        evaluate_quant_mode,
    )
    g = golden
    kw = dict(act_ranges=g["ranges"], kv_scales=g["kv"], group_size=gs,
              cont_len=10)
    got = evaluate_quant_mode(g["cfg"], g["params"], name, mode,
                              g["prompts"], ref_run=g["ref"], **kw)
    want = evaluate_quant_mode(g["cfg"], g["cpu"], name, mode, g["prompts"],
                               ref_run=g["ref_cpu"], device="cpu", **kw)
    for k, n in (("prefill_top1", 32), ("decode_top1", 20)):
        assert abs(got[k] - want[k]) * n <= 1 + 1e-9, (k, got, want)
    for k in ("prefill_kl", "decode_kl"):
        assert abs(got[k] - want[k]) <= 5e-2 * max(got[k], want[k]) + 1e-6
    assert abs(got["ppl_ratio"] - want["ppl_ratio"]) <= 2e-3
    if name == "int8-kv":
        assert got["prefill_kl"] == 0.0 and got["decode_kl"] > 0.0


@pytest.fixture
def tiny_gpt():
    _need_cuda()
    from transformers import GPT2Config, GPT2LMHeadModel
    from trtllm_llama_tpu_torch.convert.hf_gpt import (config_from_hf_gpt2,
                                                       params_from_hf_gpt2)
    torch.manual_seed(0)
    hf_cfg = GPT2Config(vocab_size=512, n_embd=320, n_layer=2, n_head=5,
                        n_positions=128)
    with torch.device("cuda"):
        hf = GPT2LMHeadModel(hf_cfg).eval()
    cfg = config_from_hf_gpt2(hf_cfg, dtype="float32")
    return hf, cfg, params_from_hf_gpt2(hf, cfg)


def test_gpt2_f32_matches_hf_and_prompt_tuning(tiny_gpt):
    from trtllm_llama_tpu_torch.models import gpt
    from trtllm_llama_tpu_torch.runtime.session import GenerationSession
    hf, cfg, params = tiny_gpt
    ids = np.random.default_rng(1).integers(3, cfg.vocab_size, (2, 16))
    with torch.inference_mode():
        ref = hf(torch.as_tensor(ids, device="cuda")).logits
        got, _ = gpt.forward_prefill(
            params, cfg, torch.as_tensor(ids, device="cuda"),
            torch.full((2,), 16, dtype=torch.int32, device="cuda"),
            gpt.init_caches(cfg, 2, 32, "cuda"), return_all_logits=True)
    assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    sess = GenerationSession(cfg, params, EngineConfig(max_input_len=16,
                             max_seq_len=48), device="cuda", model=gpt)
    virt = ids.copy()
    virt[:, :4] = cfg.vocab_size + np.arange(4)
    table = torch.cat([params["embed"][torch.as_tensor(ids[t, :4],
                                                       device="cuda")]
                       for t in range(2)])
    pt = gpt.PromptTuning(table, torch.tensor([0, 1], device="cuda"), 4)
    scfg = SamplingConfig(end_id=-1, repetition_penalty=1.1)
    real = sess.generate(ids, max_new_tokens=8, sampling=scfg)
    tuned = sess.generate(virt, max_new_tokens=8, sampling=scfg, prompt=pt)
    np.testing.assert_array_equal(real.output_ids, tuned.output_ids)


def test_gpt2_int8_bs4_runs_the_ragged_gemm(tiny_gpt):
    from trtllm_llama_tpu_torch.models import gpt
    from trtllm_llama_tpu_torch.quantization.quantize import quantize_params
    from trtllm_llama_tpu_torch.runtime.session import GenerationSession
    _, cfg, params = tiny_gpt
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    bf = {"layers": {k: v.bfloat16() for k, v in params["layers"].items()},
          **{k: v.bfloat16() for k, v in params.items() if k != "layers"}}
    q = quantize_params(bf, QuantMode.use_weight_only())
    sess = GenerationSession(cfg, q, EngineConfig(max_batch_size=4,
                             max_input_len=16, max_seq_len=48), device="cuda",
                             model=gpt)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(3, cfg.vocab_size, n).tolist() for n in
               (16, 9, 12, 3)]
    fn = woq.woq_matmul_stacked
    r0, g0 = fn.ragged_launches, fn.gemm_launches
    scfg = SamplingConfig(end_id=-1)
    out = sess.generate(prompts, max_new_tokens=8, sampling=scfg)
    # the 64-row prefill: 6 projections a layer on the GEMM, the 5 with
    # K = 320 on its ragged tile
    assert (fn.gemm_launches - g0, fn.ragged_launches - r0) == (12, 10)
    plain = woq.woq_matmul_stacked_plain
    orig = woq.woq_matmul_stacked
    try:
        woq.woq_matmul_stacked = lambda *a, **k: plain(*a, **k)
        ref = sess.generate(prompts, max_new_tokens=8, sampling=scfg)
    finally:
        woq.woq_matmul_stacked = orig
    diff = (out.output_ids != ref.output_ids).any(1)
    assert diff.sum() <= 1, (out.output_ids, ref.output_ids)


@pytest.mark.parametrize("fmt,k,n", [("int8", 1600, 1600),
                                     ("int8", 1600, 6400), ("int8", 320, 64),
                                     ("int8", 208, 48), ("int4", 1600, 512),
                                     ("fp8", 4544, 256)])
@pytest.mark.parametrize("m", [17, 64, 300])
def test_ragged_k_gemm_equals_the_padded_call(fmt, k, n, m):
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(k + n + m)
    w = torch.randn((2, k, n), generator=g, device="cuda") * k ** -0.5
    wq = (quantize_fp8_weight(w) if fmt == "fp8" else
          quantize_weight_only(w, 4 if fmt == "int4" else 8))
    pad = -k % woq.GEMM_TILE_K
    assert pad and woq.gemm_takes(k, getattr(wq, "pack_block", 0) or
                                  getattr(wq, "interleave_block", 0))
    rows = pad // 2 if fmt == "int4" else pad
    q_pad = torch.cat([wq.qweight, wq.qweight.new_zeros(
        (2, rows, n))], 1).contiguous()
    w_pad = dataclasses.replace(wq, qweight=q_pad)
    x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
    x_pad = torch.cat([x, x.new_zeros((m, pad))], 1)
    fn, plain = ((f8k.fp8_matmul_stacked, f8k.fp8_matmul_stacked_plain)
                 if fmt == "fp8" else
                 (woq.woq_matmul_stacked, woq.woq_matmul_stacked_plain))
    g0 = fn.gemm_launches
    got = fn(x, wq, 1)
    assert torch.equal(got, fn(x_pad, w_pad, 1))
    assert fn.gemm_launches - g0 == 2
    ref = plain(x, wq, 1)
    assert float((got - ref).abs().max()) <= 2 ** -7 * float(
        ref.abs().max())
    assert isinstance(wq, (WOQWeight, FP8Weight))
