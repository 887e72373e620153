#!/usr/bin/env python3
"""Where the time of kernels 1 and 6's prefill GEMM goes, on one GPU.

    python3 gemm_breakdown.py

Builds csrc/woq_gemm.cu as it is and in variants with one part of its
main loop switched off (the decode of the codes into the bf16 tile, the
wgmma products, the cp.async loads of x or of the codes, or all but the
loads), into build/gemm_breakdown/, and times each with CUDA events at
LLaMA-7B's fused qkv shape (int8 codes, bf16 x, K 4096, N 12288) at
M = 64, 1024 and 8192. The variants compute wrong results: they only
show which part the time follows. Prints the card (nvidia-smi) and one
JSON line of ms per variant and M. Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ROWS = (64, 1024, 8192)
K, N = 4096, 12288


def variants(base: str) -> dict:
    """Source text of woq_gemm.cuh per variant."""
    a_loop = ("for (int it = 0; it < kBM * 16 / kThreads; ++it) {"
              "   // 16-byte chunks")
    c_loop = "      const bool ok = n0 + c * 16 < N;\n      const uint8_t* src ="
    decode = "decode_tile<T, FMT>(smem"
    mma = "wgmma_m64n128k16<T>("
    for anchor, count in ((a_loop, 1), (c_loop, 1), (decode, 2), (mma, 2)):
        if base.count(anchor) != count:
            raise RuntimeError(f"woq_gemm.cuh changed: {anchor!r}")
    off = "if (false) "
    return {
        "kernel": base,
        "no decode": base.replace(decode, off + decode),
        "no products": base.replace(mma, off + mma),
        "no x loads": base.replace(a_loop, a_loop.replace(
            "it < kBM * 16 / kThreads",
            "it < (kt < 2 ? kBM * 16 / kThreads : 0)")),
        "no code loads": base.replace(c_loop, c_loop.replace(
            "const bool ok = n0 + c * 16 < N;",
            "const bool ok = n0 + c * 16 < N && kt < 2;")),
        "loads only": base.replace(mma, off + mma).replace(decode,
                                                           off + decode),
    }


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("gemm_breakdown: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from trtllm_llama_tpu_torch.ops.kernels import _build
    from trtllm_llama_tpu_torch.ops.kernels import woq_matmul as woq

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    csrc = _build.CSRC
    out = ROOT / "build" / "gemm_breakdown"
    procs = {}
    for name, text in variants((csrc / "woq_gemm.cuh").read_text()).items():
        d = out / name.replace(" ", "_")
        d.mkdir(parents=True, exist_ok=True)
        for f in csrc.iterdir():
            shutil.copy(f, d)
        (d / "woq_gemm.cuh").write_text(text)
        procs[name] = (d, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(d), "-o",
             str(d / "lib.so"), str(d / "woq_gemm.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (d, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"{name}: nvcc failed\n{log}", file=sys.stderr)
            return 1
        lib = ctypes.CDLL(str(d / "lib.so"))
        lib.tllm_woq_gemm.argtypes = woq._GEMM_SIGNATURES["tllm_woq_gemm"]
        lib.tllm_woq_gemm.restype = ctypes.c_int
        libs[name] = lib

    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randint(-127, 128, (K, N), generator=g, device="cuda",
                      dtype=torch.int8)
    scale = torch.rand((N,), generator=g, device="cuda")
    tile_map = woq._tile_map("int8", 0, q.device)
    table = {}
    for m in ROWS:
        x = torch.randn((m, K), generator=g, device="cuda").to(torch.bfloat16)
        y = torch.empty((m, N), device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        for name, lib in libs.items():
            def call():
                err = lib.tllm_woq_gemm(
                    x.data_ptr(), q.data_ptr(), scale.data_ptr(),
                    tile_map.data_ptr(), y.data_ptr(), None,
                    _build.DTYPE_CODES[torch.bfloat16], m, K, N, N, 1,
                    K // woq.GEMM_TILE_K, 8, 0, 0, stream)
                if err:
                    raise RuntimeError(f"{name}: launch failed ({err})")
            for _ in range(3):
                call()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(10):
                call()
            end.record()
            end.synchronize()
            table.setdefault(name, {})[m] = start.elapsed_time(end) / 10
        print(f"M={m}: " + ", ".join(f"{k} {v[m]:.4f} ms"
                                     for k, v in table.items()))
    print(json.dumps({"gemm_breakdown_ms": table, "k": K, "n": N,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
