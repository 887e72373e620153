#!/usr/bin/env python3
"""Where the time of kernels 1 and 6's GEMVs (and rows 5-6's dp4a GEMV)
goes, on one GPU.

    python3 gemv_breakdown.py [--body tc|one-row|both]

tc (the tensor-core GEMV of 2-16 rows): builds csrc/woq_gemv_tc.cu and
csrc/fp8_matmul.cu as they are and in variants of csrc/woq_gemv_tc.cuh
with one part switched off (the decode of the codes into A fragments, the
mma products, the loads of the codes after the register ring's first fill,
the norm prologue and the x panel, the second launch that sums the K
splits, or everything: an empty kernel), into build/gemv_breakdown/, and
times each through the wrappers (CUDA-graph replay over four stacked
layers, L2-cold) at LLaMA-7B's fused qkv shape with the norm prologue and
the wo shape with the residual, at the paths' row counts (1, 4, 9, 16),
bf16 and fp16 activations, int8, int4 g128 and e4m3 codes, beside the
one-row GEMV.

one-row (the one-launch GEMV of one row, csrc/woq_gemv.cuh on
csrc/gemv_stream.cuh, and the dp4a GEMV, csrc/w8a8_matmul.cu): builds
csrc/woq_matmul.cu, csrc/fp8_matmul.cu and csrc/w8a8_matmul.cu as they
are and in variants with one part switched off (the prologue: the norm's
sum of squares and the x staging; the in-kernel merge of the K splits;
the decode of the codes; the loads after the ring's first fill; or
everything: an empty kernel), with the splits merged by a thread-block
cluster through distributed shared memory instead of the last block (at
most 8 splits; the cluster code lives only here, as a patch of
gemv_stream.cuh), with int4 codes decoded one an instruction (int4_codes)
instead of two, and with the column tile forced to 8, 16 or 32 lanes
(GEMV_LANES) or the K splits to at most 4 or 8 (a plan with fewer, longer
splits), and times each at one bf16 row on
LLaMA-7B's four projection shapes with the option the decode step gives
them (int8, int4 g128, e4m3; dp4a at qkv and wo), beside the tensor-core
GEMV forced to one row.

The variants compute wrong results: they only show which part the time
follows. Prints the card (nvidia-smi) and one JSON line of ms per case
and variant. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
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
    """Source text of woq_gemv_tc.cuh per variant (the tc body)."""
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


# the one-row section: (format, projection, K, N, option)
ONE_ROW_CASES = [("int8", "qkv", 4096, 12288, "norm"),
                 ("int8", "wo", 4096, 4096, "resid"),
                 ("int8", "gate/up", 4096, 11008, "none"),
                 ("int8", "down", 11008, 4096, "resid"),
                 ("int4 g128", "qkv", 4096, 12288, "norm"),
                 ("int4 g128", "wo", 4096, 4096, "resid"),
                 ("fp8", "qkv", 4096, 12288, "norm"),
                 ("fp8", "wo", 4096, 4096, "resid"),
                 ("dp4a", "qkv", 4096, 12288, "none"),
                 ("dp4a", "wo", 4096, 4096, "none")]
ONE_ROW_LIBS = ("woq_matmul", "fp8_matmul", "w8a8_matmul")


# the "cluster merge" variant: a column tile's splits launched as one
# thread-block cluster, summed through distributed shared memory
CLUSTER_TILE_OUT = """\
  {
    namespace cg = cooperative_groups;
    cg::cluster_group cl = cg::this_cluster();
    cl.sync();                       // every split's sums are in its red
    for (int e = threadIdx.x + s.split * kThreads; e < n_sums;
         e += kThreads * s.ksplit) {
      V v = 0;
      for (int j = 0; j < s.ksplit; ++j) v += cl.map_shared_rank(red, j)[e];
      const int m = m0 + e / t.bn, n = s.n_tile + e % t.bn;
      if (m < s.M && n < s.N) epi.store(v, m, n, epi.load(m, n));
    }
    cl.sync();                       // no block leaves while read
    return;
  }
"""
CLUSTER_LAUNCH = """\
  if (grid.y > 8) return cudaErrorInvalidValue;   // the portable cluster
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = grid.y;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return err;
"""
CLUSTER_SPLITS = 8


def one_row_variants(src: dict) -> dict:
    """{file: source text} per variant of the one-row bodies, from src =
    {file: text} of woq_gemv.cuh, gemv_stream.cuh and w8a8_matmul.cu."""
    start = "  const stream::Tile t = stream::tile_of(p.lanes);\n  const int tid"
    transposes = "".join(
        f"        w8a8::transpose4x4(rows[0].{c}, rows[1].{c}, rows[2].{c}, "
        f"rows[3].{c}, cols + {4 * i});\n" for i, c in enumerate("xyzw"))
    raw = "__uint_as_float(words[i])"
    edits = {   # variant -> [(file, anchor, replacement)]
        "no prologue": [
            ("woq_gemv.cuh",
             "    float rstd[MR];\n    if (norm_w != nullptr) {",
             "    float rstd[MR];\n    if (false) {"),
            ("woq_gemv.cuh", "for (int kk = tid; kk < klen; kk += kThreads) {",
             "for (int kk = tid; kk < 0; kk += kThreads) {"),
            ("woq_gemv.cuh",
             "for (int c = tid; c < klen / kPer; c += kThreads) {",
             "for (int c = tid; c < 0; c += kThreads) {"),
            ("w8a8_matmul.cu", "for (int j = tid; j < nq; j += kThreads)",
             "for (int j = tid; j < 0; j += kThreads)")],
        "no merge": [
            ("gemv_stream.cuh", "  if (s.ksplit == 1) return;",
             "  return;")],
        "no decode": [
            ("woq_gemv.cuh",
             "for (int j = 0; j < 4; ++j) f[j] = int8_code(words[i], j);",
             f"for (int j = 0; j < 4; ++j) f[j] = {raw};"),
            ("woq_gemv.cuh",
             "fp8x2(words[i], f[0], f[1]);\n        fp8x2(words[i] >> 16, "
             "f[2], f[3]);", f"f[0] = f[1] = f[2] = f[3] = {raw};"),
            ("woq_gemv.cuh", "int4_word(words[i], lo, hi);",
             f"for (int j = 0; j < 4; ++j) lo[j] = hi[j] = {raw};"),
            ("w8a8_matmul.cu", transposes,
             "".join(f"        cols[{4 * i + j}] = rows[{i}].{c};\n"
                     for i in range(4) for j, c in enumerate("xyzw")))],
        "no loads after the first fill": [
            ("woq_gemv.cuh", "j + kD < mine);", "false);"),
            ("w8a8_matmul.cu", "j + kDQ < mine);", "false);")],
        "cluster merge": [
            ("gemv_stream.cuh", "#include <type_traits>\n",
             "#include <cooperative_groups.h>\n#include <type_traits>\n"),
            ("gemv_stream.cuh",
             "    return;\n  }\n  for (int e = threadIdx.x; e < n_sums;",
             "    return;\n  }\n" + CLUSTER_TILE_OUT
             + "  for (int e = threadIdx.x; e < n_sums;"),
            ("gemv_stream.cuh", "  if (s.ksplit == 1) return;",
             "  return;"),
            ("gemv_stream.cuh",
             "  kernel<<<grid, kThreads, smem, stream>>>(p);\n",
             CLUSTER_LAUNCH)],
        "int4 one code an instruction": [
            ("woq_gemv.cuh", "int4_word(words[i], lo, hi);",
             "for (int j = 0; j < 4; ++j) "
             "int4_codes(words[i], j, lo[j], hi[j]);")],
        "empty": [
            ("woq_gemv.cuh", start, "  if (p.M > 0) return;\n" + start),
            ("w8a8_matmul.cu", start, "  if (p.M > 0) return;\n" + start)],
    }
    out = {"kernel": dict(src)}
    for name, changes in edits.items():
        text = dict(src)
        for f, anchor, repl in changes:
            if text[f].count(anchor) != 1:
                raise RuntimeError(f"one-row sources changed: {f} {anchor!r}")
            text[f] = text[f].replace(anchor, repl)
        out[name] = text
    return out


def at_most_splits(plan, cap):
    """gemv_plan with its K splits capped at `cap` (longer splits, whole
    blocks of the layout's unit)."""
    def plan_at_most(m, k, n, sms, unit=8, group=0, kr=1, x_bytes=4):
        p = plan(m, k, n, sms, unit, group, kr, x_bytes)
        if p.ksplit <= cap:
            return p
        kc = -(-k // cap)
        kc = -(-kc // unit) * unit
        return p._replace(ksplit=-(-k // kc), kc=kc)
    return plan_at_most


def one_row_weight(fmt, k, n, g):
    """A random stacked weight of `fmt` (LAYERS layers); dp4a: (w_q, s_w)."""
    import torch
    if fmt == "dp4a":
        return (torch.randint(-128, 128, (LAYERS, k, n), generator=g,
                              device="cuda", dtype=torch.int8),
                torch.rand((LAYERS, n), generator=g, device="cuda") * 1e-3)
    return weight(fmt, k, n, g)


def one_row_section(csrc, out, woq, f8k, w8a8, _build):
    """The one-row bodies' variants, column tiles and merges at one row."""
    import torch
    src = {f: (csrc / f).read_text()
           for f in ("woq_gemv.cuh", "gemv_stream.cuh", "w8a8_matmul.cu")}
    procs = {}
    for name, texts in one_row_variants(src).items():
        d = out / ("one_row_" + name.replace(" ", "_"))
        d.mkdir(parents=True, exist_ok=True)
        for f in csrc.iterdir():
            shutil.copy(f, d)
        for f, text in texts.items():
            (d / f).write_text(text)
        for lib in ONE_ROW_LIBS:
            procs[(name, lib)] = (d, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(d), "-o",
                 str(d / f"lib{lib}.so"), str(d / f"{lib}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    sigs = {"woq_matmul": woq._SIGNATURES, "fp8_matmul": f8k._SIGNATURES,
            "w8a8_matmul": w8a8._SIGNATURES}
    libs = {}
    for (name, lib), (d, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name} {lib}: nvcc failed\n{log}")
        handle = ctypes.CDLL(str(d / f"lib{lib}.so"))
        for fn, argtypes in sigs[lib].items():
            getattr(handle, fn).argtypes = argtypes
            getattr(handle, fn).restype = ctypes.c_int
        libs.setdefault(name, {})[lib] = handle

    g = torch.Generator(device="cuda").manual_seed(1)
    plan, lanes_order = woq.gemv_plan, (woq.GEMV_LANES, woq.GEMV_LANES_GROUPED)
    table = {}
    for fmt, proj, k, n, opt in ONE_ROW_CASES:
        w = one_row_weight(fmt, k, n, g)
        x = torch.randn((1, k), generator=g, device="cuda").to(torch.bfloat16)
        if fmt == "dp4a":
            x_q = torch.randint(-128, 128, (1, k), generator=g,
                                device="cuda", dtype=torch.int8)
            s_x = torch.rand((1, 1), generator=g, device="cuda") * 0.05

            def call(i, w=w, x_q=x_q, s_x=s_x):
                w8a8.w8a8_matmul_stacked(x_q, w[0], s_x, w[1], i % LAYERS)
        else:
            fn = (f8k.fp8_matmul_stacked if fmt == "fp8"
                  else woq.woq_matmul_stacked)
            kw = ({"norm_w": (1 + 0.1 * torch.randn(
                (LAYERS, k), generator=g, device="cuda")).to(torch.bfloat16)}
                  if opt == "norm" else
                  {"resid": torch.randn((1, n), generator=g,
                                        device="cuda").to(torch.bfloat16)}
                  if opt == "resid" else {})

            def call(i, fn=fn, w=w, x=x, kw=kw):
                fn(x, w, i % LAYERS, **kw)
        case = f"{fmt} bf16 {proj} M=1 {opt}"
        row = {}
        saved = dict(_build._LIBS)
        try:
            for name, handles in libs.items():
                _build._LIBS.update(handles)
                woq.gemv_plan = (at_most_splits(plan, CLUSTER_SPLITS)
                                 if name == "cluster merge" else plan)
                try:
                    row[name] = time_ms(call)
                except RuntimeError as err:     # a variant the card refuses
                    print(f"  {case} {name}: {err}")
                    row[name] = None
            _build._LIBS.update(libs["kernel"])
            woq.gemv_plan = plan
            for lanes in (8, 16, 32):
                woq.GEMV_LANES = woq.GEMV_LANES_GROUPED = (lanes,)
                row[f"kernel, {lanes} lanes"] = time_ms(call)
            woq.GEMV_LANES, woq.GEMV_LANES_GROUPED = lanes_order
            for cap in (4, 8):
                woq.gemv_plan = at_most_splits(plan, cap)
                row[f"kernel, at most {cap} splits"] = time_ms(call)
        finally:
            woq.gemv_plan = plan
            woq.GEMV_LANES, woq.GEMV_LANES_GROUPED = lanes_order
            _build._LIBS.clear()
            _build._LIBS.update(saved)
        if fmt != "dp4a":
            old = woq.TC_MIN_ROWS
            woq.TC_MIN_ROWS = 1
            try:
                row["tensor-core GEMV"] = time_ms(call)
            finally:
                woq.TC_MIN_ROWS = old
        table[case] = row
        print(f"{case}: " + ", ".join(
            f"{v} {'refused' if t is None else f'{t:.4f}'}"
            for v, t in row.items()))
        sys.stdout.flush()
        del w
    return table


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


def tc_section(csrc, out, woq, f8k, _build):
    """The tensor-core GEMV's variants at 1-16 rows."""
    import torch
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
            raise RuntimeError(f"{name} {lib}: nvcc failed\n{log}")
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
            row["one-row GEMV"] = time_ms(
                lambda i: fn(x, w, i % LAYERS, **kw))
        finally:
            woq.TC_MIN_ROWS = old
        table[case] = row
        print(f"{case}: " + ", ".join(f"{v} {t:.4f}" for v, t in row.items()))
        sys.stdout.flush()
        del w
    return table


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--body", choices=("tc", "one-row", "both"),
                    default="both")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("gemv_breakdown: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from trtllm_llama_tpu_torch.ops.kernels import _build
    from trtllm_llama_tpu_torch.ops.kernels import fp8_matmul as f8k
    from trtllm_llama_tpu_torch.ops.kernels import w8a8_matmul as w8a8
    from trtllm_llama_tpu_torch.ops.kernels import woq_matmul as woq

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    out = ROOT / "build" / "gemv_breakdown"
    result = {"device": torch.cuda.get_device_name(0)}
    if args.body in ("one-row", "both"):
        result["one_row_ms"] = one_row_section(_build.CSRC, out, woq, f8k,
                                               w8a8, _build)
    if args.body in ("tc", "both"):
        result["gemv_breakdown_ms"] = tc_section(_build.CSRC, out, woq, f8k,
                                                 _build)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
