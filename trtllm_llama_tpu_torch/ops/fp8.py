"""FP8 (e4m3fn) codec in integer and float bit arithmetic (torch).

The port's copy of the JAX package's `ops/fp8.py`: fp8 values travel as
uint8 bit codes, and encode / decode are int32 / f32 tensor ops, so the
results are bit-identical to the JAX codec on every device.

e4m3fn: 1 sign / 4 exponent (bias 7) / 3 mantissa bits; no infinities;
codes 0x7F / 0xFF are NaN; the largest finite value is 448; subnormals are
m/8 * 2^-6.
"""

from __future__ import annotations

import torch

FP8_MAX = 448.0


def _exp2i(e):
    """2^e (f32) for int32 e in [-126, 127], via the exponent field."""
    return ((e + 127) << 23).to(torch.int32).view(torch.float32)


def fp8_decode(code, dtype=torch.float32):
    """uint8 e4m3fn codes -> float. Exact for every code (subnormals and
    +-0 included); the two NaN codes decode to NaN."""
    u = code.to(torch.int32)
    sign = (u >> 7) & 1
    e = (u >> 3) & 15
    m = u & 7
    # normal: (8 + m) * 2^(e - 10); subnormal (e == 0): m * 2^(1 - 10)
    mant = torch.where(e == 0, m, m + 8).to(torch.float32)
    val = mant * _exp2i(torch.clamp(e, min=1) - 10)
    val = torch.where(sign == 1, -val, val)
    val = torch.where((u & 0x7F) == 0x7F, torch.full_like(val, float("nan")),
                      val)
    return val.to(dtype)


def fp8_encode(x):
    """float -> uint8 e4m3fn codes, round to nearest even, saturating at
    +-448 (never the NaN codes). Values are clipped before any cast, so
    nothing out of range turns into NaN."""
    xf = torch.clamp(x.to(torch.float32), -FP8_MAX, FP8_MAX)
    i = xf.view(torch.int32)
    sign = (i >> 31) & 1
    mag = i & 0x7FFFFFFF
    # normal: round the f32 pattern to a 3-bit mantissa (drop 20 bits; a
    # carry into the exponent is the right result)
    rounded = mag + 0x7FFFF + ((mag >> 20) & 1)
    e4 = (rounded >> 23) - 120                   # f32 bias 127 -> e4m3 bias 7
    m3 = (rounded >> 20) & 7
    normal_code = (e4 << 3) | m3
    # subnormal (|x| < 2^-6): code m = round(|x| * 512), half to even
    sub_code = torch.round(xf.abs() * 512.0).to(torch.int32)
    code = torch.where(xf.abs() < 2.0 ** -6, sub_code, normal_code)
    code = torch.clamp(code, 0, 0x7E)
    return ((sign << 7) | code).to(torch.uint8)
