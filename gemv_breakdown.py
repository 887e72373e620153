#!/usr/bin/env python3
"""Where the time of kernels 1 and 6's tensor-core GEMV goes, on one GPU.

    python3 gemv_breakdown.py

Builds csrc/woq_gemv_tc.cu and csrc/fp8_matmul.cu as they are and in
variants of csrc/woq_gemv_tc.cuh with one part switched off (the decode of
the codes into A fragments, the mma products, the loads of the codes after
the register ring's first fill, the norm prologue and the x panel, the
second launch that sums the K splits, or everything: an empty kernel), into
build/gemv_breakdown/, and times each through the wrappers (CUDA-graph
replay over four stacked layers, L2-cold) at LLaMA-7B's fused qkv shape
with the norm prologue and the wo shape with the residual, at the paths'
row counts (1, 4, 9, 16), bf16 and fp16 activations, int8, int4 g128 and
e4m3 codes, beside the CUDA-core GEMV. The variants compute wrong
results: they only show which part the time follows. Prints the card
(nvidia-smi) and one JSON line of ms per case and variant. Imports
nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
LAYERS = 4                  # stacked layers cycled (> L2)
# (format, dtype, projection, K, N, option, rows)
CASES = [("int8", "bf16", "qkv", 4096, 12288, "norm", 1),
         ("int8", "bf16", "qkv", 4096, 12288, "norm", 4),
         ("int8", "bf16", "qkv", 4096, 12288, "norm", 9),
         ("int8", "bf16", "qkv", 4096, 12288, "norm", 16),
         ("int8", "fp16", "qkv", 4096, 12288, "norm", 9),
         ("int8", "bf16", "wo", 4096, 4096, "resid", 9),
         ("int4 g128", "bf16", "qkv", 4096, 12288, "norm", 4),
         ("fp8", "bf16", "qkv", 4096, 12288, "norm", 4)]


def variants(base: str) -> dict:
    """Source text of woq_gemv_tc.cuh per variant."""
    decode = "decode_a<T, FMT, kW>(w, j, plants, a);"
    mma = "mma<T>("
    loads = "if (s + i + kD < we) load("
    norm = "if (p.norm_w != nullptr) {\n    constexpr int kPer"
    panel = "for (int i = threadIdx.x; i < M * vecs; i += kThreads) {"
    merge = "if (err != cudaSuccess || !split) return err;"
    start = "  T* xs = reinterpret_cast<T*>(smem);"
    for anchor, count in ((decode, 1), (mma, 5), (loads, 1), (norm, 1),
                          (panel, 1), (merge, 1), (start, 1)):
        if base.count(anchor) != count:
            raise RuntimeError(f"woq_gemv_tc.cuh changed: {anchor!r}")
    raw = ("a[0] = w[j >> 2]; a[1] = w[kW + (j >> 2)]; "
           "a[2] = w[2 * kW + (j >> 2)]; a[3] = w[3 * kW + (j >> 2)];")
    no_decode = base.replace(decode, raw)
    return {
        "kernel": base,
        "no decode": no_decode,
        "no products": base.replace(mma, "if (false) " + mma),
        "loads only": no_decode.replace(mma, "if (false) " + mma),
        "no code loads": base.replace(loads, "if (false) load("),
        "no prologue": base.replace(norm, norm.replace(
            "p.norm_w != nullptr", "false")).replace(
                panel, panel.replace("i < M * vecs", "i < 0")),
        "no merge": base.replace(merge, "return err;"),
        "empty": base.replace(start, "  if (p.M > 0) return;\n" + start),
    }


def time_ms(fn, iters=20, reps=3):
    """Device ms per fn(i): iters calls in one CUDA graph (after a warm-up
    on the capture stream), replayed reps times between CUDA events."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
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


def weight(fmt, k, n, g):
    """A random stacked weight of `fmt` (LAYERS layers)."""
    import torch
    from trtllm_llama_tpu_torch.quantization.quantize import random_fp8_codes
    from trtllm_llama_tpu_torch.quantization.tensors import (FP8Weight,
                                                             WOQWeight)
    if fmt == "fp8":
        return FP8Weight(random_fp8_codes((LAYERS, k, n), g, "cuda"),
                         torch.rand((LAYERS, n), generator=g,
                                    device="cuda") * 1e-3, 128)
    bits, gs = (4, 128) if fmt == "int4 g128" else (8, 0)
    q = torch.randint(-127, 128, (LAYERS, k // 2 if bits == 4 else k, n),
                      generator=g, device="cuda", dtype=torch.int8)
    s = torch.rand((LAYERS, k // gs, n) if gs else (LAYERS, n), generator=g,
                   device="cuda") * 1e-3
    return WOQWeight(q, s, bits, gs, 128 if bits == 4 else 0)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("gemv_breakdown: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from trtllm_llama_tpu_torch.ops.kernels import _build
    from trtllm_llama_tpu_torch.ops.kernels import fp8_matmul as f8k
    from trtllm_llama_tpu_torch.ops.kernels import woq_matmul as woq

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    csrc = _build.CSRC
    out = ROOT / "build" / "gemv_breakdown"
    procs = {}
    for name, text in variants((csrc / "woq_gemv_tc.cuh").read_text()).items():
        d = out / name.replace(" ", "_")
        d.mkdir(parents=True, exist_ok=True)
        for f in csrc.iterdir():
            shutil.copy(f, d)
        (d / "woq_gemv_tc.cuh").write_text(text)
        for lib in ("woq_gemv_tc", "fp8_matmul"):
            procs[(name, lib)] = (d, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(d), "-o",
                 str(d / f"lib{lib}.so"), str(d / f"{lib}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for (name, lib), (d, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"{name} {lib}: nvcc failed\n{log}", file=sys.stderr)
            return 1
        handle = ctypes.CDLL(str(d / f"lib{lib}.so"))
        sigs = woq._TC_SIGNATURES if lib == "woq_gemv_tc" else f8k._SIGNATURES
        for fn, argtypes in sigs.items():
            getattr(handle, fn).argtypes = argtypes
            getattr(handle, fn).restype = ctypes.c_int
        libs.setdefault(name, {})[lib] = handle

    g = torch.Generator(device="cuda").manual_seed(0)
    table = {}
    for fmt, dt, proj, k, n, opt, m in CASES:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float16
        w = weight(fmt, k, n, g)
        fn = f8k.fp8_matmul_stacked if fmt == "fp8" else woq.woq_matmul_stacked
        x = torch.randn((m, k), generator=g, device="cuda").to(dtype)
        kw = ({"norm_w": (1 + 0.1 * torch.randn(
            (LAYERS, k), generator=g, device="cuda")).to(dtype)}
              if opt == "norm" else
              {"resid": torch.randn((m, n), generator=g, device="cuda").to(
                  dtype)})
        case = f"{fmt} {dt} {proj} M={m} {opt}"
        row = {}
        saved, old = dict(_build._LIBS), woq.TC_MIN_ROWS
        woq.TC_MIN_ROWS = 1          # the tensor-core body at every row count
        try:
            for name, handles in libs.items():
                _build._LIBS.update(handles)
                row[name] = time_ms(lambda i: fn(x, w, i % LAYERS, **kw))
        finally:
            _build._LIBS.clear()
            _build._LIBS.update(saved)
            woq.TC_MIN_ROWS = old
        old = woq.TC_MIN_ROWS
        woq.TC_MIN_ROWS = 1 << 30
        try:
            row["CUDA-core GEMV"] = time_ms(
                lambda i: fn(x, w, i % LAYERS, **kw))
        finally:
            woq.TC_MIN_ROWS = old
        table[case] = row
        print(f"{case}: " + ", ".join(f"{v} {t:.4f}" for v, t in row.items()))
        sys.stdout.flush()
        del w
    print(json.dumps({"gemv_breakdown_ms": table,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
