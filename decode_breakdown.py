#!/usr/bin/env python3
"""Where the time of the split-cache decode (kernel 3, rows 8 and 9) goes,
on one GPU.

    python3 decode_breakdown.py

Builds csrc/decode_attention.cu (the entries over csrc/flash_decode.cuh;
kernel 3's is timed) as it is and in variants with one part of the
kernel switched off (the scores and softmax, the p @ V pass, the cp.async
loads past the first stages, the merge of the splits, or all but the
loads), and one that reads e4m3 codes through a 256-entry table in shared
memory instead of cvt.rn.f16x2.e4m3x2 (the same values: the other way an
fp8 cache could decode), into build/decode_breakdown/, and times each with
CUDA events at the shapes that matter: LLaMA-7B's bs1 cache at 8320 rows
(pos 8200, int8, e4m3 and bf16, the host's split and one split), at
Task A's 1152 rows and at 128 (pos 45) in e4m3, and one KV head for a
group of 32 (D=128) or 71 (D=64, Falcon-7B) at 2048 rows (pos 1037; 32
also in e4m3), and two of them at pos 0 (one live row: the fixed cost).
The switched-off variants compute wrong results: they only show which part
the time follows.
Prints the card (nvidia-smi) and one JSON line of ms per variant and
shape. Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# (tag, Hq, Hkv, D, S_max, pos, cache kind (None: bf16), splits or None
# for the rule's)
SHAPES = [
    ("llama 8k int8", 32, 32, 128, 8320, 8200, "int8", None),
    ("llama 8k e4m3", 32, 32, 128, 8320, 8200, "e4m3", None),
    ("llama 8k int8, 1 split", 32, 32, 128, 8320, 8200, "int8", 1),
    ("llama 8k e4m3, 1 split", 32, 32, 128, 8320, 8200, "e4m3", 1),
    ("llama 8k bf16", 32, 32, 128, 8320, 8200, None, None),
    ("llama 1152 e4m3", 32, 32, 128, 1152, 923, "e4m3", None),
    ("llama 128 e4m3", 32, 32, 128, 128, 45, "e4m3", None),
    ("group 32 2k bf16", 32, 1, 128, 2048, 1037, None, None),
    ("group 32 2k e4m3", 32, 1, 128, 2048, 1037, "e4m3", None),
    ("group 71 2k bf16", 71, 1, 64, 2048, 1037, None, None),
    ("llama 8k int8, pos 0", 32, 32, 128, 8320, 0, "int8", None),
    ("group 71 2k bf16, pos 0", 71, 1, 64, 2048, 0, None, None),
]


def variants(base: str) -> dict:
    """Source text of flash_decode.cuh per variant."""
    scores_w = "if (h < k.heads) {  // warp-uniform"
    pv_w = "for (int rr = 0; rr < kRw; ++rr) {"
    loads = ("if (i + kStages - 1 < k.n_st)\n"
             "      load_stage<T, TC, D, kPaged>(p, k, tbl, ring, "
             "i + kStages - 1);")
    merge = ("  if (n == 1) {\n    for (int i",
             "  if (true) {\n    for (int i")
    # e4m3 codes through a table in shared memory, filled by each block
    # before its first stage (the loop's first barrier orders the reads)
    lut_fn = ("// Four e4m3 codes (byte j of w is code j) as their exact "
              "values.\n",
              "__shared__ float e4m3_lut[256];\n"
              "__device__ __forceinline__ void e4m3x4_lut(uint32_t w, "
              "float* x) {\n"
              "#pragma unroll\n"
              "  for (int j = 0; j < 4; ++j) x[j] = e4m3_lut[(w >> (8 * j)) "
              "& 0xFFu];\n}\n\n"
              "// Four e4m3 codes (byte j of w is code j) as their exact "
              "values.\n")
    lut_use = ("for (int w = 0; w < N / 4; ++w) e4m3x4(pw.v[w], x + 4 * w);",
               "for (int w = 0; w < N / 4; ++w) e4m3x4_lut(pw.v[w], "
               "x + 4 * w);")
    lut_fill = ("  const Block k = block_of<TC, D, kPaged>(p);\n",
                "  const Block k = block_of<TC, D, kPaged>(p);\n"
                "  for (int c = threadIdx.x; c < 256; c += kThreads) {\n"
                "    float lo, hi;\n    fp8x2(c, lo, hi);\n"
                "    e4m3_lut[c] = lo;\n  }\n")

    def edit(t, *pairs):
        for anchor, repl in pairs:
            if base.count(anchor) != 1:
                raise RuntimeError(f"flash_decode.cuh changed: {anchor!r}")
            t = t.replace(anchor, repl)
        return t

    no_scores = (scores_w, "if (false) {")
    no_pv = (pv_w, pv_w.replace("rr < kRw", "rr < 0"))
    out = {
        "kernel": base,
        "no scores": edit(base, no_scores),
        "no p @ V": edit(base, no_pv),
        "no loads": edit(base, (loads, "if (false) " + loads)),
        "loads only": edit(base, no_scores, no_pv),
        "no merge": edit(base, merge),
        "e4m3 by table": edit(base, lut_fn, lut_use, lut_fill),
    }
    for name, text in out.items():
        if name != "kernel" and text == base:
            raise RuntimeError(f"variant {name!r} equals the kernel")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("decode_breakdown: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from trtllm_llama_tpu_torch.ops.kernels import _build
    from trtllm_llama_tpu_torch.ops.kernels import decode_attention as da
    from trtllm_llama_tpu_torch.quantization.quantize import random_fp8_codes

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    csrc = _build.CSRC
    out = ROOT / "build" / "decode_breakdown"
    procs = {}
    for name, text in variants((csrc / "flash_decode.cuh").read_text()).items():
        d = out / name.replace(" ", "_").replace("@", "at")
        d.mkdir(parents=True, exist_ok=True)
        for f in csrc.iterdir():
            shutil.copy(f, d)
        (d / "flash_decode.cuh").write_text(text)
        procs[name] = (d, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(d), "-o",
             str(d / "lib.so"), str(d / "decode_attention.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (d, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"{name}: nvcc failed\n{log}", file=sys.stderr)
            return 1
        lib = ctypes.CDLL(str(d / "lib.so"))
        fn = lib.tllm_decode_attention
        fn.argtypes = da._SIGNATURES["tllm_decode_attention"]
        fn.restype = ctypes.c_int
        libs[name] = fn

    g = torch.Generator(device="cuda").manual_seed(0)
    table = {}
    for tag, hq, hkv, d, s, pos, kv, splits in SHAPES:
        shape = (1, 1, hkv, s, d)
        if kv:
            dt = torch.int8 if kv == "int8" else torch.uint8
            kc, vc = (random_fp8_codes(shape, g, "cuda") if kv == "e4m3"
                      else torch.randint(-127, 128, shape, generator=g,
                                         device="cuda", dtype=dt)
                      for _ in range(2))
            kvs = torch.full((1,), 0.05, device="cuda")
        else:
            kc, vc = (torch.randn(shape, generator=g, device="cuda").to(
                torch.bfloat16) for _ in range(2))
            kvs = None
        q = torch.randn((1, hq, d), generator=g, device="cuda").to(
            torch.bfloat16)
        kn, vn = (torch.randn((1, hkv, d), generator=g, device="cuda").to(
            torch.bfloat16) for _ in range(2))
        pt = torch.tensor([pos], dtype=torch.int32, device="cuda")
        o = torch.empty_like(q)
        n, tps = da.decode_split(1, hkv, s, hq // hkv, da.sm_count(0))
        if splits is not None:
            tiles = -(-s // da.TILE)
            tps = -(-tiles // splits)
            n = -(-tiles // tps)
        part, counters = da._workspace(q.device,
                                       *da.workspace_size(1, hq, d, n))
        stream = torch.cuda.current_stream().cuda_stream
        for name, fn in libs.items():
            def call():
                err = fn(q.data_ptr(), kn.data_ptr(), vn.data_ptr(),
                         kc.data_ptr(), vc.data_ptr(),
                         None if kvs is None else kvs.data_ptr(),
                         pt.data_ptr(), o.data_ptr(), part.data_ptr(),
                         counters.data_ptr(),
                         _build.DTYPE_CODES[torch.bfloat16],
                         da.cache_kind(kc.dtype), 1,
                         hq, hkv, s, d, d ** -0.5, n, tps, 0, stream)
                if err:
                    raise RuntimeError(f"{name}: launch failed ({err})")
            for _ in range(3):
                call()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(50):
                call()
            end.record()
            end.synchronize()
            table.setdefault(name, {})[tag] = start.elapsed_time(end) / 50
        print(f"{tag} ({n} splits): " + ", ".join(
            f"{k} {v[tag]:.4f} ms" for k, v in table.items()))
    print(json.dumps({"decode_breakdown_ms": table,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
