"""Rows 15-19: the decode probes (csrc/decode_probes.cu).

Replaces the JAX package's TPU probes, which pinned the Mosaic layout facts
its int4 / fp8 decodes rely on:
`scripts/probe_int4_kernel.py::probe_bitcast_u32_bf16` (15),
`::probe_u16_ops` (16), `::probe_u32_bf16_construct` (17), and the kernels
of `tests/test_tpu_kernels.py::test_fp8_decode_exact_on_chip` (18) and
`::test_fp8_planes_decode_exact_on_chip` (19). On Hopper each probes the
same fact in registers, and rows 18-19 run every code through the decode
functions of `csrc/woq_gemv.cuh` that the CUDA-core GEMV uses; row 18's
second probe (`probe_tc_pairs`) runs them through the pair decoders of
`csrc/woq_gemv_tc.cuh` that the tensor-core GEMV feeds mma.sync with, into
bf16 and fp16. `probe_kv_codec` replaces no TPU kernel (the JAX package
runs fp8 KV caches on XLA): it holds the fp8 KV cache's e4m3 codec of the
split-cache decode (csrc/common.cuh KVCodec, csrc/flash_decode.cuh
load_raw) to `ops/fp8.py`. A few bytes each, so the launch bounds them.

uint32 words travel as int32 tensors (the same bits). Each wrapper takes
its plain version for CPU tensors and launches its kernel for CUDA tensors,
counting launches in `.launches`; the plain versions are bit
reinterpretations (`.view`) and integer ops on int32 tensors, and
`ops/fp8.py`'s `fp8_decode`. The `*_inputs` functions make each probe's
exhaustive input.
"""

from __future__ import annotations

import ctypes

import torch

from ...quantization.tensors import (INT4_BIAS, deinterleave_fp8_rows,
                                     interleave_fp8_rows)
from ..fp8 import FP8_MAX, fp8_decode, fp8_encode
from . import _build
from .woq_matmul import _device_kind

_P, _I = ctypes.c_void_p, ctypes.c_int
_SWAR = [_P, _P, _I, _I, _I, _P]
_SIGNATURES = {"tllm_probe_bitcast_u32_bf16": _SWAR,
               "tllm_probe_u16_ops": _SWAR,
               "tllm_probe_u32_bf16_construct": _SWAR,
               "tllm_probe_gemv_decodes": [_P] * 4 + [_I, _I, _P],
               "tllm_probe_tc_pairs": [_P, _P, _I, _I, _P],
               "tllm_probe_fp8_planes": [_P, _P, _I, _I, _I, _I, _P],
               "tllm_probe_kv_codec": [_P] * 5 + [_I, _I, _P]}
FP8_BLOCK = 128      # the interleave block of row 19's input


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def bitcast_inputs(device="cpu"):
    """The TPU probe's words [8, 128]: low half 0x4000 | idx, high half
    0x3F80 | idx, idx = row * 16 + lane % 16."""
    idx = (torch.arange(8)[:, None] * 16 + torch.arange(128)[None] % 16)
    return (((0x3F80 + idx) << 16) | (0x4000 + idx)).to(torch.int32).to(device)


def u16_inputs(device="cpu"):
    """All 65536 16-bit values, two per word: [256, 128]."""
    v = torch.arange(65536, dtype=torch.int64)
    return (v[0::2] | (v[1::2] << 16)).to(torch.int32).reshape(256, 128).to(
        device)


def construct_inputs(device="cpu"):
    """All 256 nibble pairs: word i holds nibble i % 16 at bits 0-3 and
    i // 16 at bits 16-19. [2, 128]."""
    i = torch.arange(256, dtype=torch.int64)
    return ((i % 16) | ((i // 16) << 16)).to(torch.int32).reshape(2, 128).to(
        device)


def code_inputs(device="cpu"):
    """All 256 byte codes, four per word (byte j of word i is 4 i + j)."""
    return torch.arange(256, dtype=torch.int32).to(torch.uint8).view(
        torch.int32).to(device)


def planes_inputs(device="cpu"):
    """The TPU test's block: logical row r holds codes (2r, 2r + 1)
    repeated over 128 columns, stored interleaved by FP8_BLOCK."""
    codes = torch.arange(256, dtype=torch.int32).to(torch.uint8).reshape(
        128, 2)
    codes = codes[:, :, None].expand(128, 2, 64).reshape(128, 128)
    return interleave_fp8_rows(codes, FP8_BLOCK).contiguous().to(device)


def kv_codec_inputs(device="cpu"):
    """f32 values that reach every rounding case of an e4m3 encode: each
    finite e4m3 value, each midpoint between two neighbours (ties, to even)
    and the f32 values just beside it, +-448 and its f32 neighbours, values
    past 448 up to the f32 maximum, subnormals, f32 denormals, +-0, and
    4096 normal draws at 30 magnitudes (seed 0); both signs."""
    vals = fp8_decode(torch.arange(128, dtype=torch.uint8))[:127]  # >= 0
    mids = (vals[1:] + vals[:-1]) / 2                     # exact in f32
    big = torch.tensor([FP8_MAX, 460.0, 464.0, 480.0, 1e4, 3.4e38])
    tiny = torch.tensor([2.0 ** -9, 2.0 ** -10, 3 * 2.0 ** -10,
                         2.0 ** -6, 2.0 ** -7 + 2.0 ** -10, 1e-45, 1e-40])
    g = torch.Generator().manual_seed(0)
    draws = (torch.randn(4096, generator=g)[:, None]
             * torch.logspace(-12, 17, 30, base=2.0)[None]).reshape(-1)
    x = torch.cat([vals, mids, big, tiny, draws])
    up = torch.nextafter(x, torch.full_like(x, float("inf")))
    down = torch.nextafter(x, torch.zeros_like(x))
    x = torch.cat([x, up, down])
    x = x[torch.isfinite(x)]
    return torch.cat([x, -x]).to(device)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _bf16_rows(lo, hi):
    """int32 16-bit halves [R, C] -> bf16 [2R, C], low halves on even rows."""
    both = torch.stack([lo, hi], dim=1).reshape(2 * lo.shape[0], lo.shape[1])
    return torch.where(both >= 32768, both - 65536, both).to(
        torch.int16).view(torch.bfloat16)


def probe_bitcast_u32_bf16_plain(words):
    r, c = words.shape
    return words.view(torch.bfloat16).reshape(r, c, 2).permute(
        0, 2, 1).reshape(2 * r, c)


def probe_u16_ops_plain(words):
    """((v >> 2) & 0x78) | 0x4300 on each 16-bit half."""
    halves = [words & 0xFFFF, (words >> 16) & 0xFFFF]
    lo, hi = [((v >> 2) & 0x78) | 0x4300 for v in halves]
    return _bf16_rows(lo, hi)


def probe_u32_bf16_construct_plain(words):
    """((w << 3) & 0x00780078) | 0x43004300, one half at a time."""
    halves = [words & 0xFFFF, (words >> 16) & 0xFFFF]
    lo, hi = [((v << 3) & 0x78) | 0x4300 for v in halves]
    return _bf16_rows(lo, hi)


def probe_gemv_decodes_plain(words):
    """(e4m3 values [4n], int8 values [4n], int4 (low, high nibble) values
    [4n, 2]) of the words' bytes, f32."""
    codes = words.view(torch.uint8)
    u = codes.to(torch.int32)
    int4 = torch.stack([(u & 15) - INT4_BIAS, (u >> 4) - INT4_BIAS], dim=-1)
    return (fp8_decode(codes), codes.view(torch.int8).float(), int4.float())


def probe_tc_pairs_plain(words):
    """The pair decoders' output for words [n] (int32): for bf16 then fp16,
    (int8, int4, e4m3) pairs [4n, 2] of that dtype; pair 4 i + j holds
    byte j of word i low and byte j of word (i + n / 2) % n high (int4:
    the byte's low and high nibble, each biased by 8)."""
    codes = words.view(torch.uint8)
    n = words.numel()
    partner = torch.roll(codes.reshape(n, 4), -(n // 2), dims=0).reshape(-1)
    u = codes.to(torch.int32)
    int8 = torch.stack([codes.view(torch.int8), partner.view(torch.int8)],
                       dim=-1).float()
    int4 = torch.stack([(u & 15) - INT4_BIAS, (u >> 4) - INT4_BIAS],
                       dim=-1).float()
    fp8 = torch.stack([fp8_decode(codes), fp8_decode(partner)], dim=-1)
    return tuple(v.to(dt) for dt in (torch.bfloat16, torch.float16)
                 for v in (int8, int4, fp8))


def probe_fp8_planes_plain(q):
    return fp8_decode(deinterleave_fp8_rows(q, FP8_BLOCK))


def probe_kv_codec_plain(values, scale):
    """(the e4m3 codes of values / scale [n] uint8, the 256 codes' values
    * scale [256] f32, the 256 codes' values twice [2, 256] f32: the
    kernel's two load_raw reads). `scale`: f32 [1]."""
    codes = torch.arange(256, device=values.device).to(torch.uint8)
    raw = fp8_decode(codes)
    return (fp8_encode(values.float() / scale), raw * scale,
            torch.stack([raw, raw]))


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check(what, t, dtype):
    if t.device.type != "cuda" or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{what}: needs a contiguous {dtype} CUDA tensor, "
                         f"got {t.dtype} on {t.device}")


def _swar(what, entry, words):
    _check(what, words, torch.int32)
    if words.dim() != 2:
        raise ValueError(f"{what}: words must be [rows, cols]")
    r, c = words.shape
    out = torch.empty((2 * r, c), device=words.device, dtype=torch.bfloat16)
    lib = _build.load("decode_probes", _SIGNATURES)
    _build.check(getattr(lib, entry)(
        _build.ptr(words), _build.ptr(out), r, c, words.device.index or 0,
        _build.stream_of(words)), what)
    return out


def probe_bitcast_u32_bf16(words):
    """Row 15: uint32 words [R, C] (int32) read as bf16 pairs -> [2R, C],
    the low half of row r on row 2r, the high half on 2r + 1."""
    if _device_kind(words, "probe_bitcast_u32_bf16") == "cpu":
        return probe_bitcast_u32_bf16_plain(words)
    out = _swar("probe_bitcast_u32_bf16", "tllm_probe_bitcast_u32_bf16", words)
    probe_bitcast_u32_bf16.launches += 1
    return out


def probe_u16_ops(words):
    """Row 16: the 16-bit lane formula on packed pairs -> bf16 [2R, C]."""
    if _device_kind(words, "probe_u16_ops") == "cpu":
        return probe_u16_ops_plain(words)
    out = _swar("probe_u16_ops", "tllm_probe_u16_ops", words)
    probe_u16_ops.launches += 1
    return out


def probe_u32_bf16_construct(words):
    """Row 17: two nibbles per word planted as bf16 128 + 8 n -> [2R, C]."""
    if _device_kind(words, "probe_u32_bf16_construct") == "cpu":
        return probe_u32_bf16_construct_plain(words)
    out = _swar("probe_u32_bf16_construct", "tllm_probe_u32_bf16_construct",
                words)
    probe_u32_bf16_construct.launches += 1
    return out


def probe_gemv_decodes(words):
    """Row 18: every byte of the words [n] (int32) decoded by the GEMV's
    functions as e4m3, as int8 and as an int4 nibble pair. Returns (fp8
    [4n], int8 [4n], int4 [4n, 2]) f32."""
    if _device_kind(words, "probe_gemv_decodes") == "cpu":
        return probe_gemv_decodes_plain(words)
    _check("probe_gemv_decodes", words, torch.int32)
    n = words.numel()
    dev = words.device
    fp8 = torch.empty(4 * n, device=dev, dtype=torch.float32)
    int8 = torch.empty(4 * n, device=dev, dtype=torch.float32)
    int4 = torch.empty((4 * n, 2), device=dev, dtype=torch.float32)
    lib = _build.load("decode_probes", _SIGNATURES)
    _build.check(lib.tllm_probe_gemv_decodes(
        _build.ptr(words), _build.ptr(fp8), _build.ptr(int8), _build.ptr(int4),
        n, dev.index or 0, _build.stream_of(words)), "probe_gemv_decodes")
    probe_gemv_decodes.launches += 1
    return fp8, int8, int4


def probe_tc_pairs(words):
    """Row 18, the tensor-core body's decoders: every byte of the words [n]
    (int32, n even) as a bf16 and an fp16 pair of int8 codes, of int4
    nibbles and of e4m3 codes. Returns (int8, int4, fp8) bf16 [4n, 2], then
    the same in fp16."""
    if _device_kind(words, "probe_tc_pairs") == "cpu":
        return probe_tc_pairs_plain(words)
    _check("probe_tc_pairs", words, torch.int32)
    n = words.numel()
    if n % 2:
        raise ValueError("probe_tc_pairs: needs an even number of words")
    out = torch.empty((2, 3, 4 * n), device=words.device, dtype=torch.int32)
    lib = _build.load("decode_probes", _SIGNATURES)
    _build.check(lib.tllm_probe_tc_pairs(
        _build.ptr(words), _build.ptr(out), n, words.device.index or 0,
        _build.stream_of(words)), "probe_tc_pairs")
    probe_tc_pairs.launches += 1
    return tuple(out[d, f].view(dt).reshape(4 * n, 2)
                 for d, dt in enumerate((torch.bfloat16, torch.float16))
                 for f in range(3))


def probe_fp8_planes(q):
    """Row 19: e4m3 codes [K, N] stored interleaved by FP8_BLOCK -> f32
    [K, N] in logical row order."""
    if _device_kind(q, "probe_fp8_planes") == "cpu":
        return probe_fp8_planes_plain(q)
    _check("probe_fp8_planes", q, torch.uint8)
    k, n = q.shape
    if k % FP8_BLOCK or n % 4:
        raise ValueError(f"probe_fp8_planes: K={k} must be whole blocks of "
                         f"{FP8_BLOCK} and N={n} a multiple of 4")
    out = torch.empty((k, n), device=q.device, dtype=torch.float32)
    lib = _build.load("decode_probes", _SIGNATURES)
    _build.check(lib.tllm_probe_fp8_planes(
        _build.ptr(q), _build.ptr(out), k, n, FP8_BLOCK, q.device.index or 0,
        _build.stream_of(q)), "probe_fp8_planes")
    probe_fp8_planes.launches += 1
    return out


def probe_kv_codec(values, scale):
    """The fp8 KV cache's codec on the card: values f32 [n] through
    KVCodec<__nv_fp8_e4m3>::enc at `scale` (f32 [1]); the 256 codes through
    its dec and through the split-cache decode's load_raw, four a word and
    one at a time. Returns (codes uint8 [n], dec f32 [256], raw f32
    [2, 256])."""
    if _device_kind(values, "probe_kv_codec") == "cpu":
        return probe_kv_codec_plain(values, scale)
    _check("probe_kv_codec", values, torch.float32)
    _check("probe_kv_codec", scale, torch.float32)
    if values.dim() != 1 or scale.shape != (1,):
        raise ValueError("probe_kv_codec: values [n] and scale [1]")
    n, dev = values.numel(), values.device
    codes = torch.empty(n, device=dev, dtype=torch.uint8)
    dec = torch.empty(256, device=dev, dtype=torch.float32)
    raw = torch.empty((2, 256), device=dev, dtype=torch.float32)
    lib = _build.load("decode_probes", _SIGNATURES)
    _build.check(lib.tllm_probe_kv_codec(
        _build.ptr(values), _build.ptr(scale), _build.ptr(codes),
        _build.ptr(dec), _build.ptr(raw), n, dev.index or 0,
        _build.stream_of(values)), "probe_kv_codec")
    probe_kv_codec.launches += 1
    return codes, dec, raw


for _fn in (probe_bitcast_u32_bf16, probe_u16_ops, probe_u32_bf16_construct,
            probe_gemv_decodes, probe_tc_pairs, probe_fp8_planes,
            probe_kv_codec):
    _fn.launches = 0
del _fn
