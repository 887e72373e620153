#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (trtllm_llama_tpu_torch) on one GPU.

    python3 chip_smoke.py [--layers N]

1. prints the card's name and power limit (nvidia-smi);
2. builds every kernel of the four paths from csrc/ (one nvcc per source,
   in parallel) and prints the build time and nvcc's register, shared
   memory and spill report;
3. holds each kernel against its plain PyTorch version on the card at the
   paths' shapes and prints the max error against the stated tolerance,
   the kernel's time, its bound, the plain version's time and one PyTorch
   library call's time where one computes the same function (a yardstick
   only: the port never calls it). The weight-only GEMVs are checked in
   every format: int8, int4 with g128 and with per-channel scales, and fp8
   (e4m3), stacked at the four projection shapes with the norm and
   residual options, and the 2-D entries (woq_matmul, fp8_matmul) also at
   the lm_head's shape;
4. drives each path through GenerationSession.generate with random weights
   born quantized (seed 0), at LLaMA-7B's widths:
   path 1, int8 weight-only per-channel; path 2, SmoothQuant W8A8
   (per-token activation, per-channel weight scales) with an int8 KV cache
   (scale 0.05 per layer); path 3, int4 weight-only with g128 scales and
   an int4 per-channel lm_head; path 4, fp8 projections and an fp8
   lm_head (both lm_heads made by quantize_params from the random bf16
   one). Each: bs1 with an 8-token prompt and 50 greedy
   tokens, bs1 with another prompt, bs4 with ragged prompts; prints
   prefill ms, decode ms/token and tokens/s, checks that every kernel of
   the path was launched in the path's run (counts zeroed just before it),
   checks the 7B prefill logits against the plain-version path on the
   card, and profiles one bs1 request (device time by kernel, the device's
   busy share). Each path's session is freed before the next starts;
5. prints a `kernels` JSON line, then as the last line
   {"ok": true, "device": {...}}.
Any failed phase exits non-zero without that line. The script imports
nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import re
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, dense bf16 flop/s,
# dense int8 op/s.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12
F32_FLOPS = 67e12     # float32 outside the tensor cores
# Two bf16 ulps at the largest output magnitude: the kernels and their
# plain versions sum in f32 in different orders, so a bf16 rounding
# (norm prologue, residual epilogue, attention output) may land one ulp
# apart.
BF16_TOL = 2.0 ** -7
LOGITS_TOL = 5e-2     # 7B prefill logits, relative to max |logit|
N_WEIGHT_LAYERS = 4   # stacked layers cycled when timing a matmul (> L2)
NEW_TOKENS = 50       # each path: 8-token prompt, 50 new tokens
KV_SCALE = 0.05       # path 2's int8-KV scale, every layer
INT8_DECODE = "dma_decode_attention (int8 KV)"
INT4_STACKED = "woq_matmul_stacked (int4 g128)"
INT4_2D = "woq_matmul (int4 per-channel)"
_WOQ_PY = "trtllm_llama_tpu/ops/pallas/woq_matmul.py"
# Rows the paths give a matmul or norm: decode bs1 and bs4, prefill bs1 and
# bs4 (prompts padded to the 16-token bucket). Each kernel is checked
# against its plain version at all of them.
PATH_ROWS = (1, 4, 16, 64)

# JSON name -> (wrapper attribute, TPU kernel it replaces, source)
KERNELS = {
    "woq_matmul_stacked": (
        "woq_matmul_stacked", f"{_WOQ_PY}:617",
        "trtllm_llama_tpu_torch/csrc/woq_matmul.cu"),
    INT4_STACKED: (
        "woq_matmul_stacked", f"{_WOQ_PY}:617",
        "trtllm_llama_tpu_torch/csrc/woq_matmul.cu"),
    INT4_2D: (
        "woq_matmul", f"{_WOQ_PY}:416",
        "trtllm_llama_tpu_torch/csrc/woq_matmul.cu"),
    "fp8_matmul_stacked": (
        "fp8_matmul_stacked", f"{_WOQ_PY}:654",
        "trtllm_llama_tpu_torch/csrc/fp8_matmul.cu"),
    "fp8_matmul": (
        "fp8_matmul", f"{_WOQ_PY}:646",
        "trtllm_llama_tpu_torch/csrc/fp8_matmul.cu"),
    "prefill_attention_kernel": (
        "prefill_attention_kernel",
        "trtllm_llama_tpu/ops/pallas/attention.py:504",
        "trtllm_llama_tpu_torch/csrc/prefill_attention.cu"),
    "dma_decode_attention": (
        "dma_decode_attention",
        "trtllm_llama_tpu/ops/pallas/dma_decode_attention.py:156",
        "trtllm_llama_tpu_torch/csrc/decode_attention.cu"),
    "rmsnorm_quant": (
        "rmsnorm_quant", "trtllm_llama_tpu/ops/pallas/rmsnorm_quant.py:31",
        "trtllm_llama_tpu_torch/csrc/rmsnorm_quant.cu"),
    "w8a8_matmul_stacked": (
        "w8a8_matmul_stacked", "trtllm_llama_tpu/ops/pallas/w8a8_matmul.py:181",
        "trtllm_llama_tpu_torch/csrc/w8a8_matmul.cu"),
    INT8_DECODE: (
        "dma_decode_attention",
        "trtllm_llama_tpu/ops/pallas/dma_decode_attention.py:156",
        "trtllm_llama_tpu_torch/csrc/decode_attention.cu"),
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


def bound_ms(n_bytes, flops, peak=BF16_FLOPS):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / peak
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
    """One line from nvcc -Xptxas -v: kernels, registers, smem, spills, and
    the (mangled) names of the kernels that spill."""
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    smem = [int(r) for r in re.findall(r"(\d+) bytes smem", log)] or [0]
    spills = sum(int(r) for r in re.findall(r"(\d+) bytes spill stores", log))
    spilling = [chunk.split("'")[0]
                for chunk in log.split("Compiling entry function '")[1:]
                if any(int(s) for s in re.findall(r"(\d+) bytes spill stores",
                                                  chunk))]
    return (f"{len(regs)} kernels, {min(regs)}-{max(regs)} registers, "
            f"up to {max(smem)} bytes static smem, {spills} bytes spilled"
            + (f" (in {', '.join(spilling)})" if spilling else ""))


@contextlib.contextmanager
def patched(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


# ---------------------------------------------------------------------------
# kernels 1 (int8, int4) and 6 (fp8): the weight-only GEMVs
# ---------------------------------------------------------------------------

# weight format -> (stacked JSON key or None, 2-D JSON key or None, seed)
GEMV_FORMATS = {
    "int8": ("woq_matmul_stacked", None, 1),
    "int4 g128": (INT4_STACKED, None, 7),
    "int4 per-channel": (None, INT4_2D, 8),
    "fp8": ("fp8_matmul_stacked", "fp8_matmul", 9),
}


def make_gemv_weight(fmt, n_l, k, n, g):
    """Random stacked weight [n_l, K, N] of `fmt` with random positive
    scales (grouped scales vary along K)."""
    import torch
    from trtllm_llama_tpu_torch.quantization.quantize import random_fp8_codes
    from trtllm_llama_tpu_torch.quantization.tensors import FP8Weight, WOQWeight

    def scale(shape, qmax):
        return (0.5 + torch.rand(shape, generator=g, device="cuda")) * (
            k ** -0.5 / qmax)
    if fmt == "fp8":
        return FP8Weight(random_fp8_codes((n_l, k, n), g, "cuda"),
                         scale((n_l, n), 448.0), 128)
    w_bits = 8 if fmt == "int8" else 4
    gs = 128 if fmt == "int4 g128" else 0
    q = torch.randint(-127, 128, (n_l, k // 2 if w_bits == 4 else k, n),
                      generator=g, device="cuda", dtype=torch.int8)
    sshape = (n_l, k // gs, n) if gs else (n_l, n)
    return WOQWeight(q, scale(sshape, 127.0), w_bits, gs,
                     128 if w_bits == 4 else 0)


def _one_layer(w, layer):
    import dataclasses
    return dataclasses.replace(w, qweight=w.qweight[layer],
                               scale=w.scale[layer])


def check_gemv(fmt, errors, results):
    """The stacked kernel at the four projection shapes and every PATH_ROWS
    row count with each option, and (for formats whose 2-D entry a path
    launches) the 2-D entry at the same shapes and at the lm_head's."""
    import torch
    from trtllm_llama_tpu_torch.config import ModelConfig
    from trtllm_llama_tpu_torch.ops.kernels import fp8_matmul as f8k
    from trtllm_llama_tpu_torch.ops.kernels import woq_matmul as woq

    key_3d, key_2d, seed = GEMV_FORMATS[fmt]
    if fmt == "fp8":
        stacked, stacked_plain = f8k.fp8_matmul_stacked, f8k.fp8_matmul_stacked_plain
        two_d, two_d_plain = f8k.fp8_matmul, f8k.fp8_matmul_plain
    else:
        stacked, stacked_plain = woq.woq_matmul_stacked, woq.woq_matmul_stacked_plain
        two_d, two_d_plain = woq.woq_matmul, woq.woq_matmul_plain
    print(f"kernel {stacked.__name__} / {two_d.__name__} ({fmt} weights, bf16 "
          "x, f32 out):")
    cfg = ModelConfig.llama_7b()
    d, f, vocab = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    qkv = cfg.num_heads * cfg.head_dim + 2 * cfg.num_kv_heads * cfg.head_dim
    # (name, K, N, option the main path uses)
    shapes = [("qkv", d, qkv, "norm"), ("wo", d, d, "resid"),
              ("gate/up", d, f, "none"), ("down", f, d, "resid")]
    g = torch.Generator(device="cuda").manual_seed(seed)
    n_l = N_WEIGHT_LAYERS
    err_3d = err_2d = 0.0

    def record(key, t_k, t_p, t_l, n_bytes, m, k, n, what):
        b_ms, b_by = bound_ms(n_bytes, 2 * m * k * n)
        print(f"  time {what}: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
              f"library(matmul bf16 dequantized) {t_l:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}), {n_bytes / t_k / 1e6:.1f} GB/s")
        if key is not None:
            results[key] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l,
                                bound_ms=b_ms, bound_by=b_by,
                                shape=f"M={m} K={k} N={n} {fmt}, {what}")

    for pname, k, n, path_opt in shapes:
        w = make_gemv_weight(fmt, n_l, k, n, g)
        deq = w.dequantize(torch.bfloat16)             # yardstick only
        w_bytes = w.qweight[0].numel() + w.scale[0].numel() * 4
        nw = (1 + 0.1 * torch.randn((n_l, k), generator=g, device="cuda")
              ).to(torch.bfloat16)
        for m in PATH_ROWS:
            x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
            resid = torch.randn((m, n), generator=g, device="cuda").to(torch.bfloat16)
            for opt in ("none", "norm", "resid"):
                kw = {"norm": {"norm_w": nw}, "resid": {"resid": resid},
                      "none": {}}[opt]
                got = stacked(x, w, 1, **kw)
                ref = stacked_plain(x, w, 1, **kw)
                torch.cuda.synchronize()
                err_3d = max(err_3d, compare(
                    f"{pname} K={k} N={n} M={m} {opt}", got, ref, errors))
            if key_2d is not None:
                w1 = _one_layer(w, 1)
                got = two_d(x, w1)
                ref = two_d_plain(x, w1)
                torch.cuda.synchronize()
                err_2d = max(err_2d, compare(
                    f"2-D {pname} K={k} N={n} M={m}", got, ref, errors))
            if m not in (1, 16):
                continue
            kw = {"norm": {"norm_w": nw}, "resid": {"resid": resid},
                  "none": {}}[path_opt]
            t_k = time_ms(lambda i: stacked(x, w, i % n_l, **kw))
            t_p = time_ms(lambda i: stacked_plain(x, w, i % n_l, **kw), iters=8)
            t_l = time_ms(lambda i: torch.matmul(x, deq[i % n_l]))
            n_bytes = (w_bytes + m * k * 2 + m * n * 4
                       + (k * 2 if path_opt == "norm" else 0)
                       + (m * n * 2 if path_opt == "resid" else 0))
            record(key_3d if pname == "qkv" and m == 1 else None, t_k, t_p,
                   t_l, n_bytes, m, k, n, f"{pname} M={m} {path_opt}")
        del w, deq
    if key_3d is not None:
        results[key_3d]["max_abs_err"] = err_3d
    if key_2d is None:
        return
    # the lm_head: one [4096, 32000] weight, per-channel (bigger than L2)
    w = _one_layer(make_gemv_weight(fmt, 1, d, vocab, g), 0)
    deq = w.dequantize(torch.bfloat16)
    for m in (1, 4):                       # bs1 and bs4 decode / last rows
        x = torch.randn((m, d), generator=g, device="cuda").to(torch.bfloat16)
        got = two_d(x, w)
        ref = two_d_plain(x, w)
        torch.cuda.synchronize()
        err_2d = max(err_2d, compare(f"2-D lm_head K={d} N={vocab} M={m}",
                                     got, ref, errors))
        if m == 1:
            t_k = time_ms(lambda i: two_d(x, w))
            t_p = time_ms(lambda i: two_d_plain(x, w), iters=8)
            t_l = time_ms(lambda i: torch.matmul(x, deq))
            n_bytes = (w.qweight.numel() + w.scale.numel() * 4 + d * 2
                       + vocab * 4)
            record(key_2d, t_k, t_p, t_l, n_bytes, m, d, vocab,
                   "lm_head M=1 (decode)")
    results[key_2d]["max_abs_err"] = err_2d


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
# kernel 3 (bf16 cache, path 1; int8 cache, path 2)
# ---------------------------------------------------------------------------

def check_decode(errors, results, kv_int8=False):
    import torch
    import torch.nn.functional as F
    from trtllm_llama_tpu_torch.ops.kernels import decode_attention as da

    kind = (f"int8 cache, scale {KV_SCALE} per layer" if kv_int8
            else "bf16 cache")
    print(f"kernel dma_decode_attention (KV write + attention, {kind}):")
    g = torch.Generator(device="cuda").manual_seed(4 if kv_int8 else 3)
    d, n_l, layer = 128, 2, 1
    cases = [  # (B, Hq, Hkv, S_max, positions)
        (1, 32, 32, 128, [45]), (1, 32, 32, 2048, [1037]),
        (1, 32, 32, 2048, [2047]),
        (4, 32, 32, 128, [8, 5, 12, 3]),    # bs4 ragged
        (2, 32, 8, 128, [31, 100]),         # GQA group of 4
    ]
    if not kv_int8:
        cases += [(1, 32, 32, 128, [0]), (1, 32, 32, 128, [127]),
                  (1, 32, 32, 2048, [0])]
    kv_scale = (torch.full((n_l,), KV_SCALE, device="cuda") if kv_int8
                else None)
    elem = 1 if kv_int8 else 2
    key = INT8_DECODE if kv_int8 else "dma_decode_attention"
    max_err = 0.0
    for b, hq, hkv, s, pos in cases:
        shape = (n_l, b, hkv, s, d)
        if kv_int8:
            kc = torch.randint(-127, 128, shape, generator=g, device="cuda",
                               dtype=torch.int8)
            vc = torch.randint(-127, 128, shape, generator=g, device="cuda",
                               dtype=torch.int8)
        else:
            kc = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
            vc = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
        q = torch.randn((b, hq, d), generator=g, device="cuda").to(torch.bfloat16)
        # int8: new K/V up to ~8 = 160 codes, so the clamp at 127 is hit
        amp = 2.0 if kv_int8 else 1.0
        kn = (amp * torch.randn((b, hkv, d), generator=g, device="cuda")
              ).to(torch.bfloat16)
        vn = (amp * torch.randn((b, hkv, d), generator=g, device="cuda")
              ).to(torch.bfloat16)
        pt = torch.tensor(pos, dtype=torch.int32, device="cuda")
        kc2, vc2 = kc.clone(), vc.clone()
        got = da.dma_decode_attention(q, kn, vn, kc, vc, layer, pt,
                                      kv_scale=kv_scale)
        ref = da.dma_decode_attention_plain(q, kn, vn, kc2, vc2, layer, pt,
                                            kv_scale=kv_scale)
        torch.cuda.synchronize()
        name = f"B={b} Hq={hq} Hkv={hkv} S_max={s} pos={pos}"
        max_err = max(max_err, compare(name, got, ref, errors))
        same = torch.equal(kc, kc2) and torch.equal(vc, vc2)
        print(f"  {name}: cache equals the plain write bit for bit: {same}")
        if not same:
            errors.append(f"decode {kind} {name}: cache differs from the "
                          "plain write")
        if b != 1 or hq != hkv:
            continue
        p = pos[0]
        t_k = time_ms(lambda i: da.dma_decode_attention(
            q, kn, vn, kc, vc, layer, pt, kv_scale=kv_scale))
        t_p = time_ms(lambda i: da.dma_decode_attention_plain(
            q, kn, vn, kc2, vc2, layer, pt, kv_scale=kv_scale))
        ql = q[:, :, None]
        kl, vl = kc[layer, :, :, :p + 1], vc[layer, :, :, :p + 1]
        if kv_int8:     # the yardstick reads bf16 K/V dequantized beforehand
            kl = (kl.float() * KV_SCALE).to(torch.bfloat16)
            vl = (vl.float() * KV_SCALE).to(torch.bfloat16)
        t_l = time_ms(lambda i: F.scaled_dot_product_attention(ql, kl, vl))
        n_bytes = (2 * b * hkv * (p + 1) * d * elem + 2 * b * hq * d * 2
                   + 2 * b * hkv * d * 2 + b * 4 + (4 if kv_int8 else 0))
        b_ms, b_by = bound_ms(n_bytes, 4 * b * hq * (p + 1) * d)
        lib = ("sdpa on bf16-dequantized K/V, no write" if kv_int8
               else "sdpa, no write")
        print(f"  time {name}: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
              f"library({lib}) {t_l:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
        if s == 128 and p == 45:
            results[key] = dict(
                ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=b_ms,
                bound_by=b_by, shape=f"B=1 Hq=Hkv=32 S_max=128 pos=45 D=128 "
                f"bf16 q, {'int8' if kv_int8 else 'bf16'} cache")
    results[key]["max_abs_err"] = max_err


# ---------------------------------------------------------------------------
# kernel 4
# ---------------------------------------------------------------------------

def check_rmsnorm_quant(errors, results):
    import torch
    from trtllm_llama_tpu_torch.ops.kernels import rmsnorm_quant as rnq

    print("kernel rmsnorm_quant (RMSNorm -> per-row int8 + scale, bf16 x):")
    g = torch.Generator(device="cuda").manual_seed(5)
    d = 4096
    w = (1 + 0.1 * torch.randn((d,), generator=g, device="cuda")
         ).to(torch.bfloat16)
    max_err = 0.0
    for m in PATH_ROWS:
        x = (3 * torch.randn((m, d), generator=g, device="cuda")
             ).to(torch.bfloat16)
        q, s = rnq.rmsnorm_quant(x, w)
        q_ref, s_ref = rnq.rmsnorm_quant_plain(x, w)
        torch.cuda.synchronize()
        step = (q.int() - q_ref.int()).abs().max().item()
        moved = int((q != q_ref).sum())
        s_rel = ((s - s_ref).abs() / s_ref).max().item()
        err = (q.float() * s - q_ref.float() * s_ref).abs().max().item()
        max_err = max(max_err, err)
        ok = step <= 1 and s_rel <= 1e-6
        print(f"  M={m} D={d}: codes within {step} (tol 1; {moved} of "
              f"{m * d} moved), scale max rel err {s_rel:.2e} (tol 1e-6), "
              f"dequantized max_abs_err {err:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            errors.append(f"rmsnorm_quant M={m}: codes {step}, scale {s_rel:.2e}")
        t_k = time_ms(lambda i: rnq.rmsnorm_quant(x, w))
        t_p = time_ms(lambda i: rnq.rmsnorm_quant_plain(x, w))
        n_bytes = m * d * 2 + d * 2 + m * d + m * 4
        b_ms, b_by = bound_ms(n_bytes, 10 * m * d, F32_FLOPS)
        print(f"  time M={m}: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
              f"library — (no single PyTorch call), bound {b_ms:.6f} ms "
              f"({b_by})")
        if m == 1:
            results["rmsnorm_quant"] = dict(
                ms=t_k, plain_ms=t_p, library_ms=None, bound_ms=b_ms,
                bound_by=b_by, shape="M=1 D=4096 bf16 (decode norm)")
    results["rmsnorm_quant"]["max_abs_err"] = max_err


# ---------------------------------------------------------------------------
# kernel 5
# ---------------------------------------------------------------------------

def check_w8a8(errors, results):
    import torch
    from trtllm_llama_tpu_torch.config import ModelConfig
    from trtllm_llama_tpu_torch.ops.kernels import w8a8_matmul as w8a8

    print("kernel w8a8_matmul_stacked (int8 x int8 -> exact int32, f32 out):")
    cfg = ModelConfig.llama_7b()
    d, f = cfg.hidden_size, cfg.intermediate_size
    qkv = cfg.num_heads * cfg.head_dim + 2 * cfg.num_kv_heads * cfg.head_dim
    shapes = [("qkv", d, qkv), ("wo", d, d), ("gate/up", d, f), ("down", f, d)]
    g = torch.Generator(device="cuda").manual_seed(6)
    n_l = N_WEIGHT_LAYERS
    max_err = 0.0
    for pname, k, n in shapes:
        w_q = torch.randint(-127, 128, (n_l, k, n), generator=g, device="cuda",
                            dtype=torch.int8)
        s_w = torch.full((n_l, n), k ** -0.5 / 127.0, device="cuda")
        deq = (w_q.float() * s_w[:, None, :]).to(torch.bfloat16)  # yardstick
        for m in PATH_ROWS:
            x_q = torch.randint(-127, 128, (m, k), generator=g, device="cuda",
                                dtype=torch.int8)
            s_x = torch.rand((m, 1), generator=g, device="cuda") * 0.05 + 1e-3
            got = w8a8.w8a8_matmul_stacked(x_q, w_q, s_x, s_w, 1)
            ref = w8a8.w8a8_matmul_stacked_plain(x_q, w_q, s_x, s_w, 1)
            torch.cuda.synchronize()
            max_err = max(max_err, compare(
                f"{pname} K={k} N={n} M={m}", got, ref, errors, tol=1e-6))
            t_k = time_ms(lambda i: w8a8.w8a8_matmul_stacked(
                x_q, w_q, s_x, s_w, i % n_l))
            t_p = time_ms(lambda i: w8a8.w8a8_matmul_stacked_plain(
                x_q, w_q, s_x, s_w, i % n_l), iters=8)
            xd = (x_q.float() * s_x).to(torch.bfloat16)
            t_l = time_ms(lambda i: torch.matmul(xd, deq[i % n_l]))
            n_bytes = k * n + n * 4 + m * k + m * 4 + m * n * 4
            b_ms, b_by = bound_ms(n_bytes, 2 * m * k * n, INT8_OPS)
            print(f"  time {pname} M={m}: kernel {t_k:.4f} ms, plain "
                  f"{t_p:.4f} ms, library(matmul bf16, dequantized operands)"
                  f" {t_l:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
                  f"{n_bytes / t_k / 1e6:.1f} GB/s")
            if pname == "qkv" and m == 1:
                results["w8a8_matmul_stacked"] = dict(
                    ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=b_ms,
                    bound_by=b_by, shape=f"M=1 K={k} N={n} (decode qkv)")
        del w_q, deq
    # the 2-D entry (w8a8_matmul): one weight, per-tensor s_w, static s_x
    w2 = torch.randint(-127, 128, (d, d), generator=g, device="cuda",
                       dtype=torch.int8)
    sw2 = torch.full((1,), d ** -0.5 / 127.0, device="cuda")
    x_q = torch.randint(-127, 128, (1, d), generator=g, device="cuda",
                        dtype=torch.int8)
    sx2 = torch.tensor(0.02, device="cuda")
    got = w8a8.w8a8_matmul(x_q, w2, sx2, sw2)
    ref = w8a8.w8a8_matmul_stacked_plain(x_q, w2[None], sx2, sw2[None], 0)
    torch.cuda.synchronize()
    max_err = max(max_err, compare(f"2-D w8a8_matmul K={d} N={d} M=1 "
                                   "static/per-tensor", got, ref, errors,
                                   tol=1e-6))
    t_k = time_ms(lambda i: w8a8.w8a8_matmul(x_q, w2, sx2, sw2))
    t_p = time_ms(lambda i: w8a8.w8a8_matmul_stacked_plain(
        x_q, w2[None], sx2, sw2[None], 0), iters=8)
    xd = (x_q.float() * sx2).to(torch.bfloat16)
    deq2 = (w2.float() * sw2).to(torch.bfloat16)
    t_l = time_ms(lambda i: torch.matmul(xd, deq2))
    b_ms, b_by = bound_ms(d * d + 4 + d + 4 + d * 4, 2 * d * d, INT8_OPS)
    print(f"  time 2-D M=1 {d}x{d}: kernel {t_k:.4f} ms (one weight, so "
          f"L2-warm), plain {t_p:.4f} ms, library(matmul bf16, dequantized) "
          f"{t_l:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    results["w8a8_matmul_stacked"]["max_abs_err"] = max_err


# ---------------------------------------------------------------------------
# the two paths
# ---------------------------------------------------------------------------

def make_paths():
    """Each path: its config, its int8-KV scales, its kernels (JSON name ->
    (module, wrapper attribute)), and the wrappers replaced by their plain
    versions for the prefill-logits check."""
    from trtllm_llama_tpu_torch import ModelConfig, QuantMode
    from trtllm_llama_tpu_torch.ops.kernels import decode_attention as da
    from trtllm_llama_tpu_torch.ops.kernels import fp8_matmul as f8k
    from trtllm_llama_tpu_torch.ops.kernels import prefill_attention as pa
    from trtllm_llama_tpu_torch.ops.kernels import rmsnorm_quant as rnq
    from trtllm_llama_tpu_torch.ops.kernels import w8a8_matmul as w8a8
    from trtllm_llama_tpu_torch.ops.kernels import woq_matmul as woq

    attn = {"prefill_attention_kernel": pa, "dma_decode_attention": da}
    return [
        dict(tag="path 1", title="int8 weight-only per-channel, bf16 KV",
             mode=QuantMode.use_weight_only(), kv_scales=None,
             kernels={"woq_matmul_stacked": woq, **attn},
             plain=[(woq, "woq_matmul_stacked"),
                    (pa, "prefill_attention_kernel")]),
        dict(tag="path 2", title="SmoothQuant W8A8 (per-token activation, "
             f"per-channel weight scales), int8 KV (scale {KV_SCALE})",
             mode=(QuantMode.use_smooth_quant(per_token=True, per_channel=True)
                   | QuantMode.INT8_KV_CACHE),
             kv_scales=[KV_SCALE] * ModelConfig.llama_7b().num_layers,
             kernels={"rmsnorm_quant": rnq, "w8a8_matmul_stacked": w8a8,
                      "prefill_attention_kernel": pa, INT8_DECODE: da},
             plain=[(rnq, "rmsnorm_quant"), (w8a8, "w8a8_matmul_stacked"),
                    (pa, "prefill_attention_kernel")]),
        dict(tag="path 3", title="int4 weight-only, g128 projections, int4 "
             "per-channel lm_head (quantize_params), bf16 KV",
             mode=QuantMode.use_weight_only(True, per_group=True),
             group_size=128, lm_head=True, kv_scales=None,
             kernels={INT4_STACKED: woq, INT4_2D: woq, **attn},
             plain=[(woq, "woq_matmul_stacked"), (woq, "woq_matmul"),
                    (pa, "prefill_attention_kernel")]),
        dict(tag="path 4", title="fp8 (e4m3) per-channel projections, fp8 "
             "lm_head (quantize_params), bf16 KV",
             mode=QuantMode.FP8_QDQ, lm_head=True, kv_scales=None,
             kernels={"fp8_matmul_stacked": f8k, "fp8_matmul": f8k, **attn},
             plain=[(f8k, "fp8_matmul_stacked"), (f8k, "fp8_matmul"),
                    (pa, "prefill_attention_kernel")]),
    ]


def run_path(path, args, errors, results):
    import numpy as np
    import torch
    from trtllm_llama_tpu_torch import EngineConfig, ModelConfig
    from trtllm_llama_tpu_torch.models import llama
    from trtllm_llama_tpu_torch.quantization.quantize import (
        init_random_quantized_params, quantize_params,
    )
    from trtllm_llama_tpu_torch.runtime.sampling import SamplingConfig
    from trtllm_llama_tpu_torch.runtime.session import GenerationSession

    tag = path["tag"]
    cfg = ModelConfig.llama_7b(quant_mode=path["mode"], num_layers=args.layers,
                               group_size=path.get("group_size", 0))
    kv_scales = (None if path["kv_scales"] is None
                 else path["kv_scales"][:cfg.num_layers])
    print(f"{tag}: LLaMA-7B widths, {cfg.num_layers} layers, "
          f"{path['title']}, random weights born quantized (seed 0)")
    t0 = time.perf_counter()
    params = init_random_quantized_params(cfg, seed=0, device="cuda")
    if path.get("lm_head"):
        params = quantize_params(params, cfg.quant_mode, quantize_lm_head=True)
        head = params["lm_head"]
        print(f"  lm_head quantized: {type(head).__name__} "
              f"{tuple(head.qweight.shape)} {head.qweight.dtype}")
    torch.cuda.synchronize()
    print(f"  weights init: {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    sess = GenerationSession(cfg, params, EngineConfig(
        max_batch_size=4, max_input_len=1024, max_seq_len=128),
        kv_scales=kv_scales, device="cuda")
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
    wrappers = {name: getattr(mod, KERNELS[name][0])
                for name, mod in path["kernels"].items()}
    for fn in wrappers.values():
        fn.launches = 0
    _, pre_ms = generate(p1, 1)
    out1, ms1 = generate(p1, new)
    out1b, _ = generate(p1, new)
    out2, ms2 = generate(p2, new)
    out4, ms4 = generate(p4, new)
    launches = {name: fn.launches for name, fn in wrappers.items()}

    dec_ms = (ms1 - pre_ms) / (new - 1)
    print(f"  bs1 in8 out{new}: prefill {pre_ms:.2f} ms, decode "
          f"{dec_ms:.3f} ms/token, {1e3 / dec_ms:.1f} decode tokens/s, "
          f"{new / ms1 * 1e3:.1f} tokens/s end to end ({ms1:.1f} ms)")
    print(f"  bs1 second prompt: {ms2:.1f} ms; bs4 ragged {lens4}: {ms4:.1f} "
          f"ms, {4 * new / ms4 * 1e3:.1f} tokens/s")
    print(f"  launches in {tag}'s run: {launches}")
    for name, n in launches.items():
        if n <= 0:
            errors.append(f"{tag}: kernel {name} was never launched")
        results[name]["launches"] = results[name].get("launches", 0) + n
    for what, out, b in (("bs1", out1, 1), ("bs1 second", out2, 1),
                         ("bs4", out4, 4)):
        ids = out.output_ids
        ok = (ids.shape == (b, new) and (ids >= 0).all()
              and (ids < cfg.vocab_size).all()
              and (out.lengths == new).all())
        print(f"  {what} tokens {ids.shape}: {ids[0, :12].tolist()}... "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            errors.append(f"{tag} {what}: bad output {ids.shape}")
    same = np.array_equal(out1.output_ids, out1b.output_ids)
    print(f"  bs1 repeat gives identical tokens: {same}")
    if not same:
        errors.append(f"{tag}: the same bs1 request gave different tokens")
    results["_e2e"][tag] = dict(
        layers=cfg.num_layers, prefill_ms=pre_ms, decode_ms_per_token=dec_ms,
        decode_tokens_per_s=1e3 / dec_ms, e2e_tokens_per_s=new / ms1 * 1e3,
        bs4_tokens_per_s=4 * new / ms4 * 1e3)

    # 7B prefill logits, bs1 and bs4: kernels vs the plain versions on the card
    print("  7B prefill logits, kernels vs plain versions on the card:")
    for what, prompts in (("bs1", [p1[0].tolist()]), ("bs4", p4)):
        b = len(prompts)
        with torch.inference_mode():
            ids = torch.zeros((b, 16), dtype=torch.int32, device="cuda")
            for row, prompt in enumerate(prompts):
                ids[row, :len(prompt)] = torch.as_tensor(prompt, device="cuda")
            lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                                device="cuda")

            def prefill():
                caches = llama.init_caches(cfg, b, 66, "cuda", sess.kv_scales)
                return llama.forward_prefill(sess.params, cfg, ids, lens,
                                             caches, rope=sess.rope)[0]
            got = prefill()
            with contextlib.ExitStack() as stack:
                for mod, attr in path["plain"]:
                    stack.enter_context(patched(
                        mod, attr, getattr(mod, attr + "_plain")))
                ref = prefill()
        compare(f"{what} logits", got, ref, errors, tol=LOGITS_TOL)
        print(f"  {what} argmax kernels {got.argmax(-1).tolist()} plain "
              f"{ref.argmax(-1).tolist()}")
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
                    help="model depth of every path (widths stay LLaMA-7B's)")
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
    card = smi.stdout.strip().splitlines()[0]
    print(card)
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

    errors, results = [], {"_e2e": {}}
    check_gemv("int8", errors, results)
    check_prefill(errors, results)
    check_decode(errors, results)
    check_rmsnorm_quant(errors, results)
    check_w8a8(errors, results)
    check_decode(errors, results, kv_int8=True)
    for fmt in ("int4 g128", "int4 per-channel", "fp8"):
        check_gemv(fmt, errors, results)
    for path in make_paths():
        run_path(path, args, errors, results)
        gc.collect()                 # free this path's session and weights
        torch.cuda.empty_cache()
    if errors:
        print("chip_smoke FAILED:\n  " + "\n  ".join(errors), file=sys.stderr)
        return 1

    kernels = [dict(name=name, route="cuda", source=source, replaces=replaces,
                    **results[name])
               for name, (_, replaces, source) in KERNELS.items()]
    print(json.dumps({"end_to_end": results["_e2e"], "card": card}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
