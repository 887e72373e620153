"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` for Hopper (`sm_90a`) into its
own shared library with a plain C interface, at first use, into the
git-ignored `build/kernels/` beside the package, and loaded with ctypes.
A library's file name carries a hash of its sources and flags, so an
edited kernel is rebuilt and a stale one never loaded.

`build()` compiles several sources at once, one `nvcc` process each, all
started together. Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = CSRC.parents[1] / "build" / "kernels"
SOURCES = ("woq_gemm", "fp8_gemm", "w8a8_gemm", "woq_matmul", "woq_gemv_tc",
           "fp8_matmul", "prefill_attention",
           "decode_attention", "rmsnorm_quant", "w8a8_matmul",
           "paged_decode_attention", "packed_prefill_attention",
           "streaming_prefill_attention", "decode_probes")
# The split-cache decode's sources instantiate every head dim, activation
# type and cache kind, the build's longest compiles: nvcc optimises their
# kernels in parallel (-split-compile=0, one thread per core).
SOURCE_FLAGS = {"decode_attention": ("-split-compile=0",),
                "paged_decode_attention": ("-split-compile=0",)}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# activation dtype codes of csrc/common.cuh (tllm::DType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# head dims every attention kernel is instantiated for: those of every model
# the port runs (LLaMA, Bloom, OPT 128; Falcon 64; GPT-NeoX 96; GPT-J 256)
HEAD_DIMS = (32, 64, 96, 128, 256)

_LIBS: dict = {}
_WORKSPACE: dict = {}
_RETIRED: list = []     # outgrown workspaces: a launch may still use one
WORKSPACE_MIN = (1 << 20, 1 << 14)  # floats, counters: 4 MB covers the paths


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            "/usr/local/cuda/bin/nvcc"]:
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS + SOURCE_FLAGS.get(name, ())).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict:
    """Compile the named kernel libraries that are not built yet, in
    parallel. Returns {name: ptxas report} for the ones compiled now."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = _lib_path(name)
        if target.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, *SOURCE_FLAGS.get(name, ()), "-I",
               str(CSRC), "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    reports, failed = {}, []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}.cu:\n{log}")
            continue
        os.replace(tmp, target)    # atomic: a concurrent build never reads half a file
        reports[name] = log
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return reports


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library `name`, built first if needed. `signatures` maps
    each C entry point to its ctypes argtypes; every entry returns int
    (a cudaError_t)."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build((name,))
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    """Device pointer of a tensor (NULL for None)."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def workspace(device, n_part, n_counters=0):
    """Scratch that a kernel keeps between calls, for launches on the current
    CUDA stream of `device`: (f32 [>= n_part], int32 counters [>=
    n_counters], zeroed here once; each launch leaves them at 0). The
    split-cache decode (kernel 3, rows 8 and 9) keeps its splits' softmax
    states and arrival counters there, the tensor-core GEMV of kernels 1
    and 6 its K splits' sums: launches on one stream run in order, so they
    share it, and launches in flight on two streams never do. Allocated at
    first use, at least WORKSPACE_MIN, grown only when a call needs more
    (the old one is kept alive), so no call allocates. It cannot be made
    while the stream is being captured (the zeroing would run only at
    replay): make one eager call on a stream before capturing it. A CUDA
    graph keeps the workspace of the stream it was captured on, so graphs
    captured on one stream must not be replayed at the same time."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    ws = _WORKSPACE.get(key)
    if ws is None or ws[0].numel() < n_part or ws[1].numel() < n_counters:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "kernel workspace: none of this size for the stream being "
                "captured; make one eager call on it first")
        if ws is not None:
            _RETIRED.append(ws)
        n_part = max(n_part, WORKSPACE_MIN[0], ws[0].numel() if ws else 0)
        n_counters = max(n_counters, WORKSPACE_MIN[1],
                         ws[1].numel() if ws else 0)
        ws = (torch.empty(n_part, device=device, dtype=torch.float32),
              torch.zeros(n_counters, device=device, dtype=torch.int32))
        _WORKSPACE[key] = ws
    return ws
