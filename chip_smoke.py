#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (trtllm_llama_tpu_torch) on one GPU.

    python3 chip_smoke.py [--layers N]

1. prints the card's name and power limit (nvidia-smi);
2. builds every kernel of the main path from csrc/ (one nvcc per source,
   in parallel) and prints the build time and nvcc's register, shared
   memory and spill report;
3. holds each kernel against its plain PyTorch version on the card at the
   main path's shapes and prints the max abs / rel error against the
   stated tolerance, the kernel's time, its bound, the plain version's
   time and one PyTorch library call's time (a yardstick only: the port
   never calls it);
4. drives the main path -- LLaMA-7B, int8 weight-only, random weights born
   quantized -- through GenerationSession.generate: bs1 with an 8-token
   prompt and 50 greedy tokens, bs1 with another prompt, bs4 with ragged
   prompts; prints prefill ms, decode ms/token and tokens/s, checks every
   kernel was launched, checks the 7B prefill logits against the
   plain-version path on the card, and profiles one bs1 request (device
   time by kernel, the device's busy share);
5. prints a `kernels` JSON line, then as the last line
   {"ok": true, "device": {...}}.
Any failed phase exits non-zero without that line. The script imports
nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, dense bf16 flop/s.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
# Two bf16 ulps at the largest output magnitude: the kernels and their
# plain versions sum in f32 in different orders, so a bf16 rounding
# (norm prologue, residual epilogue, attention output) may land one ulp
# apart.
BF16_TOL = 2.0 ** -7
LOGITS_TOL = 5e-2     # 7B prefill logits, relative to max |logit|
N_WEIGHT_LAYERS = 4   # stacked layers cycled when timing kernel 1 (> L2)
NEW_TOKENS = 50       # the main path: 8-token prompt, 50 new tokens

REPLACES = {
    "woq_matmul_stacked": "trtllm_llama_tpu/ops/pallas/woq_matmul.py:617",
    "prefill_attention_kernel": "trtllm_llama_tpu/ops/pallas/attention.py:504",
    "dma_decode_attention":
        "trtllm_llama_tpu/ops/pallas/dma_decode_attention.py:156",
}
SOURCES = {
    "woq_matmul_stacked": "trtllm_llama_tpu_torch/csrc/woq_matmul.cu",
    "prefill_attention_kernel":
        "trtllm_llama_tpu_torch/csrc/prefill_attention.cu",
    "dma_decode_attention": "trtllm_llama_tpu_torch/csrc/decode_attention.cu",
}


def time_ms(fn, iters=20, warmup=3, reps=3):
    """Device time per fn(i) call: `iters` calls captured in one CUDA graph,
    replayed `reps` times between CUDA events. Replay keeps the host out of
    the measurement (an eager call adds its Python and launch overhead,
    which the end-to-end numbers carry)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(warmup):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def bound_ms(n_bytes, flops):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def compare(name, got, ref, errors, tol=BF16_TOL):
    """Max abs / rel error of got vs ref; records a failure past tol."""
    import torch
    got, ref = got.float(), ref.float()
    if not bool(torch.isfinite(got).all()):
        errors.append(f"{name}: non-finite output")
        return float("inf")
    scale = ref.abs().max().item()
    err = (got - ref).abs().max().item()
    rel = err / max(scale, 1e-30)
    ok = rel <= tol
    print(f"  {name}: max_abs_err {err:.3e} max_rel_err {rel:.3e} "
          f"(tol {tol:.2e} x max|ref|) {'ok' if ok else 'FAIL'}")
    if not ok:
        errors.append(f"{name}: rel err {rel:.3e} > {tol:.2e}")
    return err


def ptxas_summary(log):
    """One line from nvcc -Xptxas -v: kernels, registers, smem, spills."""
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    smem = [int(r) for r in re.findall(r"(\d+) bytes smem", log)] or [0]
    spills = sum(int(r) for r in re.findall(r"(\d+) bytes spill stores", log))
    return (f"{len(regs)} kernels, {min(regs)}-{max(regs)} registers, "
            f"up to {max(smem)} bytes static smem, {spills} bytes spilled")


@contextlib.contextmanager
def patched(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


# ---------------------------------------------------------------------------
# kernel 1
# ---------------------------------------------------------------------------

def check_woq(errors, results):
    import torch
    from trtllm_llama_tpu_torch.config import ModelConfig
    from trtllm_llama_tpu_torch.ops.kernels import woq_matmul as woq
    from trtllm_llama_tpu_torch.quantization.tensors import WOQWeight

    print("kernel woq_matmul_stacked (int8 weight-only, bf16 x, f32 out):")
    cfg = ModelConfig.llama_7b()
    d, f = cfg.hidden_size, cfg.intermediate_size
    qkv = cfg.num_heads * cfg.head_dim + 2 * cfg.num_kv_heads * cfg.head_dim
    # (name, K, N, option the main path uses)
    shapes = [("qkv", d, qkv, "norm"), ("wo", d, d, "resid"),
              ("gate/up", d, f, "none"), ("down", f, d, "resid")]
    g = torch.Generator(device="cuda").manual_seed(1)
    n_l = N_WEIGHT_LAYERS
    max_err = 0.0
    for pname, k, n, path_opt in shapes:
        q = torch.randint(-127, 128, (n_l, k, n), generator=g, device="cuda",
                          dtype=torch.int8)
        scale = torch.full((n_l, n), k ** -0.5 / 127.0, device="cuda")
        w = WOQWeight(q, scale)
        deq = (q.float() * scale[:, None, :]).to(torch.bfloat16)  # yardstick
        nw = (1 + 0.1 * torch.randn((n_l, k), generator=g, device="cuda")
              ).to(torch.bfloat16)
        for m in (1, 16):
            x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
            resid = torch.randn((m, n), generator=g, device="cuda").to(torch.bfloat16)
            for opt in ("none", "norm", "resid"):
                kw = {"norm": {"norm_w": nw}, "resid": {"resid": resid},
                      "none": {}}[opt]
                got = woq.woq_matmul_stacked(x, w, 1, **kw)
                ref = woq.woq_matmul_stacked_plain(x, w, 1, **kw)
                torch.cuda.synchronize()
                max_err = max(max_err, compare(
                    f"{pname} K={k} N={n} M={m} {opt}", got, ref, errors))
            kw = {"norm": {"norm_w": nw}, "resid": {"resid": resid},
                  "none": {}}[path_opt]
            t_k = time_ms(lambda i: woq.woq_matmul_stacked(x, w, i % n_l, **kw))
            t_p = time_ms(lambda i: woq.woq_matmul_stacked_plain(
                x, w, i % n_l, **kw), iters=8)
            t_l = time_ms(lambda i: torch.matmul(x, deq[i % n_l]))
            n_bytes = (k * n + n * 4 + m * k * 2 + m * n * 4
                       + (k * 2 if path_opt == "norm" else 0)
                       + (m * n * 2 if path_opt == "resid" else 0))
            b_ms, b_by = bound_ms(n_bytes, 2 * m * k * n)
            print(f"  time {pname} M={m} {path_opt}: kernel {t_k:.4f} ms, "
                  f"plain {t_p:.4f} ms, library(matmul bf16 dequantized) "
                  f"{t_l:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
                  f"{n_bytes / t_k / 1e6:.1f} GB/s")
            if pname == "qkv" and m == 1:
                results["woq_matmul_stacked"] = dict(
                    ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=b_ms,
                    bound_by=b_by,
                    shape=f"M=1 K={k} N={n} int8, norm prologue (decode qkv)")
        del q, deq
    results["woq_matmul_stacked"]["max_abs_err"] = max_err


# ---------------------------------------------------------------------------
# kernel 2
# ---------------------------------------------------------------------------

def check_prefill(errors, results):
    import torch
    import torch.nn.functional as F
    from trtllm_llama_tpu_torch.ops.kernels import prefill_attention as pa

    print("kernel prefill_attention_kernel (causal GQA, bf16):")
    g = torch.Generator(device="cuda").manual_seed(2)
    d = 128
    cases = [  # (B, S, Hq, Hkv, lens)
        (1, 16, 32, 32, [8]),            # main path bs1: bucket 16, prompt 8
        (4, 16, 32, 32, [8, 5, 12, 3]),  # main path bs4 ragged
        (2, 512, 32, 32, [512, 300]),    # long ragged
        (2, 64, 32, 8, [64, 17]),        # GQA group of 4
    ]
    max_err = 0.0
    for b, s, hq, hkv, lens in cases:
        q = torch.randn((b, s, hq, d), generator=g, device="cuda").to(torch.bfloat16)
        k = torch.randn((b, s, hkv, d), generator=g, device="cuda").to(torch.bfloat16)
        v = torch.randn((b, s, hkv, d), generator=g, device="cuda").to(torch.bfloat16)
        sl = torch.tensor(lens, dtype=torch.int32, device="cuda")
        got = pa.prefill_attention_kernel(q, k, v, sl)
        ref = pa.prefill_attention_kernel_plain(q, k, v, sl)
        torch.cuda.synchronize()
        name = f"B={b} S={s} Hq={hq} Hkv={hkv} lens={lens}"
        max_err = max(max_err, compare(name, got, ref, errors))
        if hq != hkv:
            continue
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        cols = torch.arange(s, device="cuda")
        mask = ((cols[None, :] <= cols[:, None])[None]
                & (cols[None, None, :] < sl[:, None, None]))[:, None]
        t_k = time_ms(lambda i: pa.prefill_attention_kernel(q, k, v, sl))
        t_p = time_ms(lambda i: pa.prefill_attention_kernel_plain(q, k, v, sl))
        t_l = time_ms(lambda i: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask))
        pairs = sum(sum(min(r + 1, n) if n > 0 else 0 for r in range(s))
                    for n in lens)
        n_bytes = b * s * d * 2 * (2 * hq + 2 * hkv) + b * 4
        b_ms, b_by = bound_ms(n_bytes, 4 * hq * d * pairs)
        print(f"  time {name}: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
              f"library(sdpa) {t_l:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
        if b == 1 and s == 16:
            results["prefill_attention_kernel"] = dict(
                ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=b_ms,
                bound_by=b_by, shape="B=1 S=16 len=8 Hq=Hkv=32 D=128 bf16")
    results["prefill_attention_kernel"]["max_abs_err"] = max_err


# ---------------------------------------------------------------------------
# kernel 3
# ---------------------------------------------------------------------------

def check_decode(errors, results):
    import torch
    import torch.nn.functional as F
    from trtllm_llama_tpu_torch.ops.kernels import decode_attention as da

    print("kernel dma_decode_attention (KV write + attention, bf16 cache):")
    g = torch.Generator(device="cuda").manual_seed(3)
    d, n_l, layer = 128, 2, 1
    cases = [  # (B, Hq, Hkv, S_max, positions)
        (1, 32, 32, 128, [0]), (1, 32, 32, 128, [45]), (1, 32, 32, 128, [127]),
        (1, 32, 32, 2048, [0]), (1, 32, 32, 2048, [1037]),
        (1, 32, 32, 2048, [2047]),
        (4, 32, 32, 128, [8, 5, 12, 3]),    # bs4 ragged
        (2, 32, 8, 128, [31, 100]),         # GQA group of 4
    ]
    max_err = 0.0
    for b, hq, hkv, s, pos in cases:
        shape = (n_l, b, hkv, s, d)
        kc = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
        vc = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
        q = torch.randn((b, hq, d), generator=g, device="cuda").to(torch.bfloat16)
        kn = torch.randn((b, hkv, d), generator=g, device="cuda").to(torch.bfloat16)
        vn = torch.randn((b, hkv, d), generator=g, device="cuda").to(torch.bfloat16)
        pt = torch.tensor(pos, dtype=torch.int32, device="cuda")
        kc2, vc2 = kc.clone(), vc.clone()
        got = da.dma_decode_attention(q, kn, vn, kc, vc, layer, pt)
        ref = da.dma_decode_attention_plain(q, kn, vn, kc2, vc2, layer, pt)
        torch.cuda.synchronize()
        name = f"B={b} Hq={hq} Hkv={hkv} S_max={s} pos={pos}"
        max_err = max(max_err, compare(name, got, ref, errors))
        same = torch.equal(kc, kc2) and torch.equal(vc, vc2)
        print(f"  {name}: cache equals the plain write bit for bit: {same}")
        if not same:
            errors.append(f"decode {name}: cache differs from the plain write")
        if b != 1 or hq != hkv:
            continue
        p = pos[0]
        t_k = time_ms(lambda i: da.dma_decode_attention(q, kn, vn, kc, vc,
                                                        layer, pt))
        t_p = time_ms(lambda i: da.dma_decode_attention_plain(
            q, kn, vn, kc2, vc2, layer, pt))
        ql = q[:, :, None]
        kl, vl = kc[layer, :, :, :p + 1], vc[layer, :, :, :p + 1]
        t_l = time_ms(lambda i: F.scaled_dot_product_attention(ql, kl, vl))
        n_bytes = (2 * b * hkv * (p + 1) * d * 2 + 2 * b * hq * d * 2
                   + 2 * b * hkv * d * 2 + b * 4)
        b_ms, b_by = bound_ms(n_bytes, 4 * b * hq * (p + 1) * d)
        print(f"  time {name}: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
              f"library(sdpa, no write) {t_l:.4f} ms, bound {b_ms:.5f} ms "
              f"({b_by})")
        if s == 128 and p == 45:
            results["dma_decode_attention"] = dict(
                ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=b_ms,
                bound_by=b_by,
                shape="B=1 Hq=Hkv=32 S_max=128 pos=45 D=128 bf16")
    results["dma_decode_attention"]["max_abs_err"] = max_err


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------

def run_main_path(args, errors, results):
    import numpy as np
    import torch
    from trtllm_llama_tpu_torch import EngineConfig, ModelConfig, QuantMode
    from trtllm_llama_tpu_torch.models import llama
    from trtllm_llama_tpu_torch.ops.kernels import decode_attention as da
    from trtllm_llama_tpu_torch.ops.kernels import prefill_attention as pa
    from trtllm_llama_tpu_torch.ops.kernels import woq_matmul as woq
    from trtllm_llama_tpu_torch.quantization.quantize import (
        init_random_quantized_params,
    )
    from trtllm_llama_tpu_torch.runtime.sampling import SamplingConfig
    from trtllm_llama_tpu_torch.runtime.session import GenerationSession

    wrappers = {"woq_matmul_stacked": woq.woq_matmul_stacked,
                "prefill_attention_kernel": pa.prefill_attention_kernel,
                "dma_decode_attention": da.dma_decode_attention}
    cfg = ModelConfig.llama_7b(quant_mode=QuantMode.use_weight_only(),
                               num_layers=args.layers)
    print(f"main path: LLaMA-7B widths, {cfg.num_layers} layers, int8 "
          "weight-only per-channel, random weights born quantized (seed 0)")
    t0 = time.perf_counter()
    params = init_random_quantized_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"  weights init: {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    sess = GenerationSession(cfg, params, EngineConfig(
        max_batch_size=4, max_input_len=1024, max_seq_len=128), device="cuda")
    del params
    scfg = SamplingConfig(end_id=-1)     # no early stop: all tokens generated
    rng = np.random.default_rng(0)
    new = NEW_TOKENS
    p1 = rng.integers(3, cfg.vocab_size, (1, 8))
    p2 = rng.integers(3, cfg.vocab_size, (1, 8))
    lens4 = [8, 5, 12, 3]
    p4 = [rng.integers(3, cfg.vocab_size, n).tolist() for n in lens4]

    def generate(ids, n_new):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = sess.generate(ids, sampling=scfg, max_new_tokens=n_new)
        return out, (time.perf_counter() - t) * 1e3

    generate(p1, 4)                      # warm-up (cuBLAS, allocator, libs)
    for fn in wrappers.values():
        fn.launches = 0
    _, pre_ms = generate(p1, 1)
    out1, ms1 = generate(p1, new)
    out1b, _ = generate(p1, new)
    out2, ms2 = generate(p2, new)
    out4, ms4 = generate(p4, new)
    launches = {k: fn.launches for k, fn in wrappers.items()}

    dec_ms = (ms1 - pre_ms) / (new - 1)
    print(f"  bs1 in8 out{new}: prefill {pre_ms:.2f} ms, decode "
          f"{dec_ms:.3f} ms/token, {1e3 / dec_ms:.1f} decode tokens/s, "
          f"{new / ms1 * 1e3:.1f} tokens/s end to end ({ms1:.1f} ms)")
    print(f"  bs1 second prompt: {ms2:.1f} ms; bs4 ragged {lens4}: {ms4:.1f} "
          f"ms, {4 * new / ms4 * 1e3:.1f} tokens/s")
    print(f"  launches in the main path's run: {launches}")
    for name, n in launches.items():
        if n <= 0:
            errors.append(f"main path: kernel {name} was never launched")
        results[name]["launches"] = n
    for tag, out, b in (("bs1", out1, 1), ("bs1 second", out2, 1),
                        ("bs4", out4, 4)):
        ids = out.output_ids
        ok = (ids.shape == (b, new) and (ids >= 0).all()
              and (ids < cfg.vocab_size).all()
              and (out.lengths == new).all())
        print(f"  {tag} tokens {ids.shape}: {ids[0, :12].tolist()}... "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            errors.append(f"main path {tag}: bad output {ids.shape}")
    if not np.array_equal(out1.output_ids, out1b.output_ids):
        errors.append("main path: the same bs1 request gave different tokens")
    print(f"  bs1 repeat gives identical tokens: "
          f"{np.array_equal(out1.output_ids, out1b.output_ids)}")
    results["_e2e"] = dict(prefill_ms=pre_ms, decode_ms_per_token=dec_ms,
                           decode_tokens_per_s=1e3 / dec_ms,
                           e2e_tokens_per_s=new / ms1 * 1e3)

    # 7B prefill logits: kernels vs the plain versions on the card
    with torch.inference_mode():
        ids = torch.zeros((1, 16), dtype=torch.int32, device="cuda")
        ids[0, :8] = torch.as_tensor(p1[0], device="cuda")
        lens = torch.tensor([8], dtype=torch.int32, device="cuda")

        def prefill():
            caches = llama.init_caches(cfg, 1, 66, "cuda")
            return llama.forward_prefill(sess.params, cfg, ids, lens, caches,
                                         rope=sess.rope)[0]
        got = prefill()
        with patched(woq, "woq_matmul_stacked", woq.woq_matmul_stacked_plain), \
                patched(pa, "prefill_attention_kernel",
                        pa.prefill_attention_kernel_plain):
            ref = prefill()
    print("  7B prefill logits, kernels vs plain versions on the card:")
    compare("logits", got, ref, errors, tol=LOGITS_TOL)
    print(f"  argmax kernels {int(got.argmax())} plain {int(ref.argmax())}")
    profile_generate(sess, p1, scfg, new, ms1)


def profile_generate(sess, ids, scfg, new, wall_ms):
    """torch.profiler over one bs1 generate: device time by kernel, and the
    device's busy share of the same request's unprofiled wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        sess.generate(ids, sampling=scfg, max_new_tokens=new)
    events = prof.key_averages()
    dev_ms = sum(e.self_device_time_total for e in events
                 if e.device_type == DeviceType.CUDA) / 1e3
    print(f"  profile bs1 out{new}: device busy {dev_ms:.1f} ms "
          f"({dev_ms / new:.3f} ms/token) of {wall_ms:.1f} ms unprofiled "
          f"wall: {100 * dev_ms / wall_ms:.1f}% busy, "
          f"{100 - 100 * dev_ms / wall_ms:.1f}% idle")
    print(events.table(sort_by="self_device_time_total", row_limit=24,
                       max_name_column_width=60))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=32,
                    help="model depth (widths stay LLaMA-7B's)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs on a GPU only",
              file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    if not (root / "trtllm_llama_tpu_torch" / "__init__.py").is_file():
        print(f"chip_smoke: trtllm_llama_tpu_torch not found beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(root))
    from trtllm_llama_tpu_torch.ops.kernels import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    reports = _build.build()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"({len(reports)} libraries compiled, one nvcc each, in parallel; "
          f"sm_90a)")
    for name, log in reports.items():
        print(f"  {name}: {ptxas_summary(log)}")

    errors, results = [], {}
    for phase in (check_woq, check_prefill, check_decode):
        phase(errors, results)
    run_main_path(args, errors, results)
    if errors:
        print("chip_smoke FAILED:\n  " + "\n  ".join(errors), file=sys.stderr)
        return 1

    kernels = [dict(name=name, route="cuda", source=SOURCES[name],
                    replaces=REPLACES[name], **results[name])
               for name in REPLACES]
    print(json.dumps({"end_to_end": results["_e2e"],
                      "card": smi.stdout.strip().splitlines()[0]}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
