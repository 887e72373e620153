#!/usr/bin/env python3
"""Where the time of row 12's warp-specialized tile goes, on one GPU.

    python3 streaming_breakdown.py

Builds csrc/streaming_prefill_attention.cu (whose bf16 body at head dims
64 / 96 / 128 is csrc/flash_attention_ws.cuh) as it is and in variants with
one part of the tile switched off or changed (the softmax of a turn, the
P V products, P's three bf16 terms cut to one, the two consumers' turns on
the tensor cores, the exact expf replaced by __expf), into
build/streaming_breakdown/, and times each with CUDA events at path 5's
shape (B=1, S=8192, 32 heads of 128, bf16, full length) and at S=4096,
beside row 10's tile on the same inputs. The variants take turns, seven
rounds, and each reports its median and minimum: the card's clock falls
under sustained load, so one pass after another is not a fair comparison.
All but the kernel compute wrong results: they only show which part the
time follows; the kernel is held to the plain version first. Prints the
card (nvidia-smi), each variant's count of ptxas notes that it serialized
the wgmmas, and one JSON line of ms per variant and shape. Imports nothing
of JAX.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SHAPES = (8192, 4096)   # S at B=1, Hq = Hkv = 32, D = 128, bf16
ROUNDS = 7


def variants(base: str) -> dict:
    """Source text of flash_attention_ws.cuh per variant."""
    def edit(t, anchor, repl, count=1):
        if base.count(anchor) != count:
            raise RuntimeError(f"flash_attention_ws.cuh changed: {anchor!r}")
        return t.replace(anchor, repl)

    softmax = ("    softmax(t, sf, alpha_a, alpha_b);\n"
               "    gemm::wgmma_wait<0>();")
    sync = ('  asm volatile("bar.sync %0, %1;\\n" ::"r"(id), "r"(threads) : '
            '"memory");')
    arrive = ('  asm volatile("bar.arrive %0, %1;\\n" ::"r"(id), "r"(threads)'
              ' : "memory");')
    out = {
        "kernel": base,
        "no softmax": edit(base, softmax, "    alpha_a = alpha_b = 1.f;\n"
                           "    gemm::wgmma_wait<0>();"),
        "no P V": edit(base, "    issue_pv(t - 1);\n",
                       "    gemm::wgmma_commit();\n"),
        "one term": edit(base, "  constexpr int kTerms = flash::p_terms<T>();",
                         "  constexpr int kTerms = 1;"),
        "no ping-pong": edit(edit(base, sync, ""), arrive, ""),
        "fast exp": edit(base, "= expf(sf[", "= __expf(sf[", count=4),
    }
    for name, text in out.items():
        if name != "kernel" and text == base:
            raise RuntimeError(f"variant {name!r} equals the kernel")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("streaming_breakdown: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from chip_smoke import compare, time_ms
    from trtllm_llama_tpu_torch.ops.kernels import _build
    from trtllm_llama_tpu_torch.ops.kernels import prefill_attention as pa
    from trtllm_llama_tpu_torch.ops.kernels import (
        streaming_prefill_attention as spa,
    )

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    csrc = _build.CSRC
    out = ROOT / "build" / "streaming_breakdown"
    procs = {}
    for name, text in variants(
            (csrc / "flash_attention_ws.cuh").read_text()).items():
        d = out / name.replace(" ", "_")
        d.mkdir(parents=True, exist_ok=True)
        for f in csrc.iterdir():
            shutil.copy(f, d)
        (d / "flash_attention_ws.cuh").write_text(text)
        procs[name] = (d, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(d), "-o",
             str(d / "lib.so"), str(d / "streaming_prefill_attention.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, serialized = {}, {}
    for name, (d, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"{name}: nvcc failed\n{log}", file=sys.stderr)
            return 1
        serialized[name] = sum("serialized" in line
                               for line in log.splitlines())
        lib = ctypes.CDLL(str(d / "lib.so"))
        fn = lib.tllm_streaming_prefill_attention
        fn.argtypes = spa._SIGNATURES["tllm_streaming_prefill_attention"]
        fn.restype = ctypes.c_int
        libs[name] = fn
    print(f"ptxas notes of serialized wgmmas: {serialized}")

    g = torch.Generator(device="cuda").manual_seed(0)
    table = {}
    for s in SHAPES:
        q, k, v = (torch.randn((1, s, 32, 128), generator=g, device="cuda"
                               ).to(torch.bfloat16) for _ in range(3))
        lens = torch.tensor([s], dtype=torch.int32, device="cuda")
        o = torch.empty_like(q)

        def call(fn):
            # the stream current at the call: time_ms captures on its own
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     lens.data_ptr(), None, o.data_ptr(),
                     _build.DTYPE_CODES[torch.bfloat16], 1, s, 32, 32, 128,
                     1, 128 ** -0.5, 0, _build.stream_of(q))
            if err:
                raise RuntimeError(f"launch failed ({err})")
        o.zero_()
        call(libs["kernel"])        # the kernel as built: the plain output
        errors = []
        ref = spa.streaming_prefill_attention_kernel_plain(q, k, v, lens)
        compare(f"kernel S={s}", o, ref, errors)
        del ref
        if errors:
            print("\n".join(errors), file=sys.stderr)
            return 1
        runs = {name: [] for name in [*libs, "row 10's tile"]}
        for _ in range(ROUNDS):
            for name, fn in libs.items():
                runs[name].append(time_ms(lambda i, fn=fn: call(fn), iters=5,
                                          warmup=1, reps=1))
            runs["row 10's tile"].append(time_ms(
                lambda i: pa.prefill_attention_kernel(q, k, v, lens),
                iters=5, warmup=1, reps=1))
        for name, t in runs.items():
            table.setdefault(name, {})[f"S={s}"] = dict(
                median_ms=statistics.median(t), min_ms=min(t))
        print(f"S={s}: " + ", ".join(
            f"{name} {statistics.median(t):.4f} (min {min(t):.4f})"
            for name, t in runs.items()))
    print(json.dumps({"streaming_breakdown_ms": table,
                      "serialized_notes": serialized,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
