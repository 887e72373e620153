"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`; every test skips without a CUDA device. On a machine with
one (which need not have JAX), run:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_kernels.py

Tolerances: f32 outputs differ from the plain versions only in summation
order (rtol/atol 1e-5); bf16 and fp16 outputs by at most a rounding step
at the final cast (2**-7 relative to the largest magnitude); int4 (per-channel
or grouped) and fp8 codes decode exactly, so those kernels are held to the
same bounds. The W8A8 kernel is
exact against its plain version (int32 sums, the same f32 epilogue);
rmsnorm_quant's scales agree to 1e-6 relative and its codes within one
step (the row's sum of squares is taken in another order); int8 and e4m3
(fp8) KV caches and paged pools are bit-identical to the plain write (the
e4m3 codes of x / scale by the same true division and nearest-even
rounding), and their outputs are held to the float caches' bounds (the
codes decode exactly; the scale multiplies the f32 sums instead of each
value, a rounding step). Rows 10, 12 and 13
carry the probabilities through P V as three bf16 (two fp16) terms, and
they, every f32 instantiation and the read-only and fused decode kernels
differ from their plain versions in summation order only (bf16 / fp16
outputs by a rounding step).
Rows 2 and 4 at prefill rows (the tensor-core GEMM) and at TC_MIN_ROWS-16
rows (the tensor-core GEMV) form the same exact products (int8 / int4
codes and e4m3 values are exact in bf16 and fp16) and differ from the
plain versions in the order of the f32 sums only: the 2**-7 bound holds;
so does the one-row GEMV (one launch, its K splits merged in split order:
two calls give the same bits), and the one-launch dp4a GEMV is exact. The SwiGLU prologue (silu in f32, the product in the compute dtype) is
held to the same per-dtype bounds, and the decode probes are exact (bit
for bit; the two e4m3 NaN codes decode to NaN on both sides).
"""

import dataclasses

import numpy as np
import pytest
import torch

from trtllm_llama_tpu_torch.ops.kernels import decode_attention as da
from trtllm_llama_tpu_torch.ops.kernels import fp8_matmul as f8k
from trtllm_llama_tpu_torch.ops.kernels import packed_prefill_attention as ppa
from trtllm_llama_tpu_torch.ops.kernels import paged_decode_attention as pda
from trtllm_llama_tpu_torch.ops.kernels import prefill_attention as pa
from trtllm_llama_tpu_torch.ops.kernels import rmsnorm_quant as rnq
from trtllm_llama_tpu_torch.ops.kernels import streaming_prefill_attention as spa
from trtllm_llama_tpu_torch.ops.kernels import w8a8_matmul as w8a8
from trtllm_llama_tpu_torch.ops.kernels import woq_matmul as woq
from trtllm_llama_tpu_torch.quantization.quantize import random_fp8_codes
from trtllm_llama_tpu_torch.quantization.tensors import FP8Weight, WOQWeight

pytestmark = pytest.mark.cuda

DTYPES = [torch.float32, torch.bfloat16, torch.float16]
HEAD_DIMS = [32, 64, 96, 128, 256]     # every attention kernel's


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _assert_close(got, ref, dtype):
    got, ref = got.float(), ref.float()
    assert torch.isfinite(got).all()
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    if dtype == torch.float32:
        assert err <= 1e-5 * (1 + scale), (err, scale)
    else:
        assert err <= 2.0 ** -7 * scale, (err, scale)


@pytest.mark.parametrize("opt", ["none", "norm", "resid"])
@pytest.mark.parametrize("m", [1, 3, 16, 40])
@pytest.mark.parametrize("dtype", DTYPES)
def test_woq_kernel_matches_plain(dev, dtype, m, opt):
    g = torch.Generator(device=dev).manual_seed(m)
    n_layers, k, n = 3, 1000, 784      # ragged K tile and column block
    w = WOQWeight(torch.randint(-127, 128, (n_layers, k, n), generator=g,
                                device=dev, dtype=torch.int8),
                  torch.rand((n_layers, n), generator=g, device=dev) * 1e-2)
    x = torch.randn((m, k), generator=g, device=dev).to(dtype)
    kw = {"none": {},
          "norm": {"norm_w": (1 + 0.1 * torch.randn(
              (n_layers, k), generator=g, device=dev)).to(dtype)},
          "resid": {"resid": torch.randn((m, n), generator=g,
                                         device=dev).to(dtype)}}[opt]
    before = woq.woq_matmul_stacked.launches
    got = woq.woq_matmul_stacked(x, w, 2, **kw)
    assert woq.woq_matmul_stacked.launches == before + 1
    _assert_close(got, woq.woq_matmul_stacked_plain(x, w, 2, **kw), dtype)


# (w_bits, group_size, pack_block, K): int4 per-channel and grouped (two
# pack blocks), int8 grouped, with K ragged against the K splits
WOQ_FORMATS = [(4, 0, 128, 1152), (4, 128, 128, 1152), (4, 32, 32, 800),
               (4, 96, 96, 1152), (8, 64, 0, 1216)]


@pytest.mark.parametrize("opt", ["none", "norm", "resid"])
@pytest.mark.parametrize("m", [1, 3, 16, 40])
@pytest.mark.parametrize("fmt", WOQ_FORMATS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_woq_int4_and_grouped_kernel_matches_plain(dev, dtype, fmt, m, opt):
    w_bits, gs, pb, k = fmt
    g = torch.Generator(device=dev).manual_seed(m + k)
    n_layers, n = 3, 784
    q = torch.randint(-127, 128, (n_layers, k // 2 if w_bits == 4 else k, n),
                      generator=g, device=dev, dtype=torch.int8)
    s = torch.rand((n_layers, k // gs, n) if gs else (n_layers, n),
                   generator=g, device=dev) * 1e-2
    w = WOQWeight(q, s, w_bits, gs, pb)
    x = torch.randn((m, k), generator=g, device=dev).to(dtype)
    kw = {"none": {},
          "norm": {"norm_w": (1 + 0.1 * torch.randn(
              (n_layers, k), generator=g, device=dev)).to(dtype)},
          "resid": {"resid": torch.randn((m, n), generator=g,
                                         device=dev).to(dtype)}}[opt]
    before = woq.woq_matmul_stacked.launches
    got = woq.woq_matmul_stacked(x, w, 2, **kw)
    assert woq.woq_matmul_stacked.launches == before + 1
    _assert_close(got, woq.woq_matmul_stacked_plain(x, w, 2, **kw), dtype)
    w2 = WOQWeight(q[1], s[1], w_bits, gs, pb)
    before = woq.woq_matmul.launches
    got2 = woq.woq_matmul(x, w2)
    assert woq.woq_matmul.launches == before + 1
    _assert_close(got2, woq.woq_matmul_plain(x, w2), dtype)


@pytest.mark.parametrize("opt", ["none", "norm", "resid"])
@pytest.mark.parametrize("m", [1, 3, 16, 40])
@pytest.mark.parametrize("k", [1152, 1000])    # interleaved / logical order
@pytest.mark.parametrize("dtype", DTYPES)
def test_fp8_kernel_matches_plain(dev, dtype, k, m, opt):
    g = torch.Generator(device=dev).manual_seed(m + k)
    n_layers, n = 3, 784
    w = FP8Weight(random_fp8_codes((n_layers, k, n), g, dev),
                  torch.rand((n_layers, n), generator=g, device=dev) * 1e-2,
                  128 if k % 128 == 0 else 0)
    x = torch.randn((m, k), generator=g, device=dev).to(dtype)
    kw = {"none": {},
          "norm": {"norm_w": (1 + 0.1 * torch.randn(
              (n_layers, k), generator=g, device=dev)).to(dtype)},
          "resid": {"resid": torch.randn((m, n), generator=g,
                                         device=dev).to(dtype)}}[opt]
    before = f8k.fp8_matmul_stacked.launches
    got = f8k.fp8_matmul_stacked(x, w, 2, **kw)
    assert f8k.fp8_matmul_stacked.launches == before + 1
    _assert_close(got, f8k.fp8_matmul_stacked_plain(x, w, 2, **kw), dtype)
    w2 = FP8Weight(w.qweight[1], w.scale[1], w.interleave_block)
    before = f8k.fp8_matmul.launches
    got2 = f8k.fp8_matmul(x, w2)
    assert f8k.fp8_matmul.launches == before + 1
    _assert_close(got2, f8k.fp8_matmul_plain(x, w2), dtype)


@pytest.mark.parametrize("s,lens", [
    (40, [40, 17, 1]), (1, [1]), (63, [63, 0]), (64, [64, 1]),
    (65, [65, 64, 0]), (1024, [1024, 923]), (2048, [2048])])
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2), (71, 1)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_kernel_matches_plain(dev, dtype, hq, hkv, d, s, lens):
    """The flash tile's edges (bf16 / fp16; f32 keeps the CUDA-core body):
    S on and off the 64-row query tile and the 64-key (32 at D = 256) K/V
    tile, lengths 0, 1 and S, B > 1 (rows of b + 1 follow b's last row in
    memory), GQA 4 and Falcon's 71:1, one launch per call."""
    g = torch.Generator(device=dev).manual_seed(d + s)
    b = len(lens)
    q, k, v = (torch.randn((b, s, h, d), generator=g, device=dev).to(dtype)
               for h in (hq, hkv, hkv))
    lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    launches = pa.prefill_attention_kernel.launches
    got = pa.prefill_attention_kernel(q, k, v, lens)
    assert pa.prefill_attention_kernel.launches == launches + 1
    _assert_close(got, pa.prefill_attention_kernel_plain(q, k, v, lens), dtype)


# Kernel 3 / row 9 calls (B, S_max, write positions): S_max 128 is one
# split; at B = 5 and Hkv <= 4, 1024 rows split into 8-16 splits of 64 or
# 128 rows (decode_split), so 127 / 128 are the last / first row of a
# split, 1023 the last row and 1030 past it (no write, all rows).
DECODE_CASES = [(4, 128, [0, 31, 32, 127]), (5, 1024, [0, 127, 128, 1023, 1030])]
# GQA groups 1, 4, 8 and 8 on one KV head
DECODE_GROUPS = [(4, 4), (8, 2), (32, 4), (8, 1)]
# cache kinds of the decode tests: a float cache (False), int8 codes (True)
# and e4m3 (fp8) codes
KV_KINDS = [False, True, "e4m3"]


def _write_case(fn, plain, q, kn, vn, kc, vc, pos, kv_scale, dtype):
    """One call of kernel 3 or row 9 against its plain version: the output
    within the dtype's bound, the caches equal to the plain write bit for
    bit, no row but positions[b] moved, one launch."""
    kc2, vc2, before = kc.clone(), vc.clone(), (kc.clone(), vc.clone())
    launches = fn.launches
    got = fn(q, kn, vn, kc, vc, 1, pos, kv_scale=kv_scale)
    assert fn.launches == launches + 1
    ref = plain(q, kn, vn, kc2, vc2, 1, pos, kv_scale=kv_scale)
    torch.cuda.synchronize()
    _assert_close(got, ref, dtype)
    assert torch.equal(kc, kc2) and torch.equal(vc, vc2)
    moved = ((kc != before[0]).any(-1) | (vc != before[1]).any(-1))  # [L,B,H,S]
    allowed = torch.zeros_like(moved)
    s = kc.shape[3]
    for i, p_ in enumerate(pos.tolist()):
        if p_ < s:
            allowed[1, i, :, p_] = True
    assert not (moved & ~allowed).any()


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("hq,hkv", DECODE_GROUPS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_kernel_matches_plain(dev, dtype, hq, hkv, d):
    """Kernel 3 over a float cache: positions 0, S - 1, past S and on both
    sides of a split boundary; with one KV head also B = 4 at ragged
    positions 0-8200 of an 8320-row cache (26 splits: splits holding one
    live row, splits holding all of theirs, empty ones)."""
    cases = DECODE_CASES + ([(4, 8320, [0, 959, 4000, 8200])]
                            if hkv == 1 and d == 128 else [])
    for b, s, pos in cases:
        splits, tps = da.decode_split(b, hkv, s, hq // hkv,
                                      da.sm_count(dev))
        assert s == 128 or splits > 1
        q, kn, vn, kc, vc, _ = _decode_cache(dev, dtype, False, hq, hkv, b, s,
                                             d, d + s)
        pos = torch.tensor(pos, dtype=torch.int32, device=dev)
        _write_case(da.dma_decode_attention, da.dma_decode_attention_plain,
                    q, kn, vn, kc, vc, pos, None, dtype)


@pytest.mark.parametrize("d", [128, 1000, 1001, 4096, 5120, 8192, 20000])
@pytest.mark.parametrize("m", [1, 3, 64, 1024])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_quant_kernel_matches_plain(dev, dtype, m, d):
    """Row 7 in every branch of its plan: a block a row (M 1, 3) and
    several rows a block (M 64, 1024), 16-byte loads and one element a load
    (D 1001), the register tile and the strided branch past it (D 20000)."""
    g = torch.Generator(device=dev).manual_seed(m + d)
    x = (3 * torch.randn((m, d), generator=g, device=dev)).to(dtype)
    w = (1 + 0.3 * torch.randn((d,), generator=g, device=dev)).to(dtype)
    before = rnq.rmsnorm_quant.launches
    q, s = rnq.rmsnorm_quant(x, w)
    assert rnq.rmsnorm_quant.launches == before + 1
    q_ref, s_ref = rnq.rmsnorm_quant_plain(x, w)
    assert q.dtype == torch.int8 and s.shape == (m, 1)
    torch.testing.assert_close(s, s_ref, rtol=1e-6, atol=0)
    assert (q.int() - q_ref.int()).abs().max().item() <= 1


@pytest.mark.parametrize("scales", ["token/channel", "token/tensor",
                                    "static/channel"])
@pytest.mark.parametrize("m", [1, 3, 16, 40])
def test_w8a8_kernel_matches_plain(dev, m, scales):
    g = torch.Generator(device=dev).manual_seed(m)
    n_layers, k, n = 3, 1000, 784      # ragged K tile and column block
    x_q = torch.randint(-127, 128, (m, k), generator=g, device=dev,
                        dtype=torch.int8)
    w_q = torch.randint(-127, 128, (n_layers, k, n), generator=g, device=dev,
                        dtype=torch.int8)
    s_x = (torch.rand((m, 1), generator=g, device=dev) * 0.05
           if scales.startswith("token") else torch.tensor(0.02, device=dev))
    s_w = torch.rand((n_layers, n if scales.endswith("channel") else 1),
                     generator=g, device=dev) * 1e-3
    before = w8a8.w8a8_matmul_stacked.launches
    got = w8a8.w8a8_matmul_stacked(x_q, w_q, s_x, s_w, 2)
    assert w8a8.w8a8_matmul_stacked.launches == before + 1
    ref = w8a8.w8a8_matmul_stacked_plain(x_q, w_q, s_x, s_w, 2)
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=0)
    got2d = w8a8.w8a8_matmul(x_q, w_q[1], s_x, s_w[1])
    ref2d = w8a8.w8a8_matmul_stacked_plain(x_q, w_q, s_x, s_w, 1)
    torch.testing.assert_close(got2d, ref2d, rtol=1e-6, atol=0)


@pytest.mark.parametrize("kv", [True, "e4m3"])
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("hq,hkv", DECODE_GROUPS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_int8_decode_kernel_matches_plain(dev, dtype, hq, hkv, d, kv):
    """Kernel 3 over an int8 and an e4m3 cache (the layer's scale 0.021),
    the cases of test_decode_kernel_matches_plain."""
    cases = DECODE_CASES + ([(4, 8320, [0, 959, 4000, 8200])]
                            if hkv == 1 and d == 128 else [])
    for b, s, pos in cases:
        q, kn, vn, kc, vc, kv_scale = _decode_cache(dev, dtype, kv, hq, hkv,
                                                    b, s, d, d + hq + s)
        pos = torch.tensor(pos, dtype=torch.int32, device=dev)
        _write_case(da.dma_decode_attention, da.dma_decode_attention_plain,
                    q, kn, vn, kc, vc, pos, kv_scale, dtype)


@pytest.mark.parametrize("s", [64, 1024])
@pytest.mark.parametrize("kv_int8", KV_KINDS)
def test_decode_kernel_drops_a_write_past_the_cache(dev, kv_int8, s):
    """pos == S_max (and past it) writes nothing and attends all S_max rows,
    as the plain version (and the JAX scatter) does; with one split and
    with sixteen (every split holds live rows)."""
    g = torch.Generator(device=dev).manual_seed(11)
    n_layers, b, hq, hkv, d = 2, 3, 8, 2, 128
    if kv_int8:
        kc, _, kv_scale = _quant_cache((n_layers, b, hkv, s, d), kv_int8, g,
                                       dev)
    else:
        kc = torch.randn((n_layers, b, hkv, s, d), generator=g, device=dev)
        kv_scale = None
    vc = kc.flip(-1).contiguous()
    q = torch.randn((b, hq, d), generator=g, device=dev)
    kn, vn = (torch.randn((b, hkv, d), generator=g, device=dev)
              for _ in range(2))
    pos = torch.tensor([s, 9, s + 3], dtype=torch.int32, device=dev)
    kc2, vc2, before = kc.clone(), vc.clone(), kc.clone()
    launches = da.dma_decode_attention.launches
    got = da.dma_decode_attention(q, kn, vn, kc, vc, 1, pos, kv_scale=kv_scale)
    assert da.dma_decode_attention.launches == launches + 1
    ref = da.dma_decode_attention_plain(q, kn, vn, kc2, vc2, 1, pos,
                                        kv_scale=kv_scale)
    torch.cuda.synchronize()
    _assert_close(got, ref, torch.float32)
    assert torch.equal(kc, kc2) and torch.equal(vc, vc2)
    moved = (kc != before).any(-1).any(2)                  # [L, B, S]
    assert moved.sum().item() <= 1 and not moved[:, [0, 2]].any()


@pytest.mark.parametrize("alibi", [False, True])
@pytest.mark.parametrize("s,lens", [(40, [40, 17, 1]), (200, [200, 130, 0]),
                                    (64, [64, 63, 64]), (2049, [2049, 2048, 0]),
                                    (2100, [2100, 1500, 1]),
                                    (4097, [4097, 4096, 65])])
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_streaming_prefill_kernel_matches_plain(dev, dtype, hq, hkv, d, s,
                                                lens, alibi):
    """Ragged lengths, a length of 0 (the row averages V over all S
    columns), S off the 64-row and the 128-row query tiles and exactly on
    them (2049, 2100 and 4097 are prompts the length dispatch sends here),
    GQA, ALiBi slopes, every head dim: D = 64 / 96 / 128 on the
    warp-specialized tile, 32 / 256 on row 10's, in bf16 and fp16; f32 on
    the CUDA-core loop."""
    from trtllm_llama_tpu_torch.ops.attention import alibi_slopes
    g = torch.Generator(device=dev).manual_seed(s + d)
    q, k, v = (torch.randn((3, s, h, d), generator=g, device=dev).to(dtype)
               for h in (hq, hkv, hkv))
    sl = torch.tensor(lens, dtype=torch.int32, device=dev)
    kw = {"alibi": alibi_slopes(hq, device=dev)} if alibi else {}
    launches = spa.streaming_prefill_attention_kernel.launches
    got = spa.streaming_prefill_attention_kernel(q, k, v, sl, **kw)
    assert spa.streaming_prefill_attention_kernel.launches == launches + 1
    ref = spa.streaming_prefill_attention_kernel_plain(q, k, v, sl, **kw)
    torch.cuda.synchronize()
    _assert_close(got, ref, dtype)


def _quant_cache(shape, kv, g, dev):
    """Random K and V codes of kind kv (True: int8; "e4m3": encodable
    e4m3 codes in uint8) and two layers' dequant scales."""
    if kv == "e4m3":
        k, v = (random_fp8_codes(shape, g, dev) for _ in range(2))
    else:
        k, v = (torch.randint(-127, 128, shape, generator=g, device=dev,
                              dtype=torch.int8) for _ in range(2))
    return k, v, torch.tensor([0.05, 0.021], device=dev)[:shape[0]]


def _decode_cache(dev, dtype, kv, hq, hkv, b, s, d, seed):
    """Kernel 3 / rows 8 and 9 inputs: q, new K/V (4 x N(0, 1): past an
    int8 or e4m3 code's range at the scale 0.021, so encodes clamp or
    saturate) and a 2-layer cache of kind kv (see KV_KINDS)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (2, b, hkv, s, d)
    if kv:
        kc, vc, kv_scale = _quant_cache(shape, kv, g, dev)
    else:
        kc = torch.randn(shape, generator=g, device=dev).to(dtype)
        vc = torch.randn(shape, generator=g, device=dev).to(dtype)
        kv_scale = None
    q = torch.randn((b, hq, d), generator=g, device=dev).to(dtype)
    kn = (4 * torch.randn((b, hkv, d), generator=g, device=dev)).to(dtype)
    vn = (4 * torch.randn((b, hkv, d), generator=g, device=dev)).to(dtype)
    return q, kn, vn, kc, vc, kv_scale


# GQA groups 1, 4, 8, 32 and 71 (the last three on one KV head)
READ_GROUPS = [(4, 4), (8, 2), (8, 1), (32, 1), (71, 1)]


@pytest.mark.parametrize("kv_int8", KV_KINDS)
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("hq,hkv", READ_GROUPS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_read_only_decode_kernel_matches_plain(dev, dtype, hq, hkv, d,
                                               kv_int8):
    """Row 8 on the split-cache body: lengths 0 (the mean of V over all S
    rows), 1, a tile edge, S and past S in a 128-row cache (one split);
    lengths 0, 1, the last row of a split and the first of the next, S
    and past S in a 1024-row cache split over the card; at D = 128 also
    B = 4 ragged lengths up to 8201 in an 8320-row cache. The caches are
    not written; one launch a call."""
    b, s = 6, 1024
    splits, tps = da.decode_split(b, hkv, s, hq // hkv, da.sm_count(dev))
    assert splits > 1
    edge = tps * da.TILE           # the first row of split 1
    cases = [(5, 128, [0, 1, 33, 128, 200]),
             (b, s, [0, 1, edge, edge + 1, s, s + 76])]
    if d == 128:
        cases.append((4, 8320, [8201, 1, 4000, 0]))
    for b, s, lens in cases:
        q, _, _, kc, vc, kv_scale = _decode_cache(dev, dtype, kv_int8, hq,
                                                  hkv, b, s, d, d + hq + s)
        lens = torch.tensor(lens, dtype=torch.int32, device=dev)
        before = kc.clone(), vc.clone()
        launches = da.decode_attention_kernel.launches
        got = da.decode_attention_kernel(q, kc, vc, 1, lens,
                                         kv_scale=kv_scale)
        assert da.decode_attention_kernel.launches == launches + 1
        ref = da.decode_attention_kernel_plain(q, kc, vc, 1, lens,
                                               kv_scale=kv_scale)
        torch.cuda.synchronize()
        _assert_close(got, ref, dtype)
        assert torch.equal(kc, before[0]) and torch.equal(vc, before[1])


@pytest.mark.parametrize("kv_int8", KV_KINDS)
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2), (32, 4)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_decode_kernel_matches_plain(dev, dtype, hq, hkv, d, kv_int8):
    """Write positions 0, a tile edge, the last row and past S (no write,
    all S rows), then on both sides of a split boundary of a 1024-row
    cache; the caches equal the plain write bit for bit, no other row
    moves, one launch a call."""
    q, kn, vn, kc, vc, kv_scale = _decode_cache(dev, dtype, kv_int8, hq, hkv,
                                                6, 128, d, d + hkv)
    pos = torch.tensor([0, 31, 32, 100, 127, 300], dtype=torch.int32,
                       device=dev)
    _write_case(da.fused_decode_attention, da.fused_decode_attention_plain,
                q, kn, vn, kc, vc, pos, kv_scale, dtype)
    b, s, pos = DECODE_CASES[1]
    q, kn, vn, kc, vc, kv_scale = _decode_cache(dev, dtype, kv_int8, hq, hkv,
                                                b, s, d, d + hq + 1)
    pos = torch.tensor(pos, dtype=torch.int32, device=dev)
    _write_case(da.fused_decode_attention, da.fused_decode_attention_plain,
                q, kn, vn, kc, vc, pos, kv_scale, dtype)


def test_decode_modes_generate_on_cuda_match_cpu(dev):
    """A tiny int8 weight-only model with an int8 KV cache gives the CPU's
    greedy tokens on the card in the 'split' and 'fused' decode modes, and
    with every prompt through the streaming prefill kernel."""
    from trtllm_llama_tpu_torch import EngineConfig, ModelConfig, QuantMode
    from trtllm_llama_tpu_torch.ops.registry import KERNELS
    from trtllm_llama_tpu_torch.quantization.quantize import (
        init_random_quantized_params,
    )
    from trtllm_llama_tpu_torch.runtime.sampling import SamplingConfig
    from trtllm_llama_tpu_torch.runtime.session import GenerationSession

    cfg = ModelConfig.tiny(dtype="float32", quant_mode=(
        QuantMode.use_weight_only() | QuantMode.INT8_KV_CACHE))
    params = init_random_quantized_params(cfg, seed=0, device="cpu")
    prompts = [[5, 17, 99, 3, 250, 8], [200, 4, 66]]
    old = dict(KERNELS)
    KERNELS["prefill_streaming_min_s"] = 0
    try:
        for mode in ("split", "fused"):
            KERNELS["decode_attn_mode"] = mode
            outs = []
            for device in ("cpu", "cuda"):
                sess = GenerationSession(cfg, params, EngineConfig(
                    max_input_len=16, max_seq_len=48), kv_scales=[0.05, 0.05],
                    device=device)
                outs.append(sess.generate(
                    prompts, sampling=SamplingConfig(end_id=-1),
                    max_new_tokens=10).output_ids)
            np.testing.assert_array_equal(outs[0], outs[1])
    finally:
        KERNELS.update(old)


# Five sequences on a 3-block table: mid-block; a table ending in -1;
# past the table (writes trash row 5, attends all MB * BS rows); the
# table's last row; a -1 write block (writes trash row 2, reads trash rows
# 0-1). No two sequences touch one trash row, so the result is defined.
PAGED_TABLES = [[3, 0, 5], [7, 1, -1], [2, 4, 6], [8, 9, 10], [12, -1, -1]]
# (pool kind, BS): bf16 / f16 / f32 pools at 8-64 (24 crosses the 64-row
# tile), int8 at 32-96 (96 too), e4m3 at 8, 64 and 96
PAGED_BLOCKS = [(False, 8), (False, 16), (False, 24), (False, 64),
                (True, 32), (True, 64), (True, 96),
                ("e4m3", 8), ("e4m3", 64), ("e4m3", 96)]
PAGED_GROUPS = [(32, 32), (32, 8), (32, 4), (32, 1)]     # groups 1-32


def _pools(dev, dtype, kv_int8, n_layers, nb, hkv, bs, d, g):
    shape = (n_layers, nb, hkv, bs, d)
    if kv_int8:
        return _quant_cache(shape, kv_int8, g, dev)
    return (torch.randn(shape, generator=g, device=dev).to(dtype),
            torch.randn(shape, generator=g, device=dev).to(dtype), None)


def _paged_case(dev, dtype, kv_int8, hq, hkv, bs, seed, d=128):
    g = torch.Generator(device=dev).manual_seed(seed)
    nb, mb = 14, 3
    pk, pv, kv_scale = _pools(dev, dtype, kv_int8, 2, nb, hkv, bs, d, g)
    b = len(PAGED_TABLES)
    tables = torch.tensor(PAGED_TABLES, dtype=torch.int32, device=dev)
    pos = torch.tensor([bs + 3, 5, mb * bs + 5, mb * bs - 1, bs + 2],
                       dtype=torch.int32, device=dev)
    q = torch.randn((b, hq, d), generator=g, device=dev).to(dtype)
    kn = (4 * torch.randn((b, hkv, d), generator=g, device=dev)).to(dtype)
    vn = (4 * torch.randn((b, hkv, d), generator=g, device=dev)).to(dtype)
    return q, kn, vn, pk, pv, tables, pos, kv_scale


def _paged_write_case(q, kn, vn, pk, pv, tables, pos, kv_scale, dtype):
    """One row 14 call against its plain version: the output within the
    dtype's bound, the pools equal to the plain write bit for bit, no row
    but the write rows (`_write_blocks`) of layer 1 moved, one launch."""
    pk2, pv2, before = pk.clone(), pv.clone(), (pk.clone(), pv.clone())
    launches = pda.paged_decode_attention.launches
    got = pda.paged_decode_attention(q, kn, vn, pk, pv, 1, tables, pos,
                                     kv_scale=kv_scale)
    assert pda.paged_decode_attention.launches == launches + 1
    ref = pda.paged_decode_attention_plain(q, kn, vn, pk2, pv2, 1, tables,
                                           pos, kv_scale=kv_scale)
    torch.cuda.synchronize()
    _assert_close(got, ref, dtype)
    assert torch.equal(pk, pk2) and torch.equal(pv, pv2)
    moved = ((pk != before[0]).any(-1) | (pv != before[1]).any(-1)).any(2)
    allowed = torch.zeros_like(moved)                      # [L, NB, BS]
    _, w_blk, w_row = pda._write_blocks(tables, pos, pk.shape[1], pk.shape[3])
    allowed[1, w_blk, w_row] = True
    assert not (moved & ~allowed).any()


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("kv_int8,bs", PAGED_BLOCKS)
@pytest.mark.parametrize("hq,hkv", PAGED_GROUPS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_decode_kernel_matches_plain(dev, dtype, hq, hkv, kv_int8, bs,
                                           d):
    _paged_write_case(*_paged_case(dev, dtype, kv_int8, hq, hkv, bs,
                                   bs + hkv + d, d), dtype)


@pytest.mark.parametrize("kv_int8,bs", [(False, 64), (False, 24),
                                        (True, 64), (True, 96),
                                        ("e4m3", 64), ("e4m3", 24)])
@pytest.mark.parametrize("hq,hkv", [(32, 32), (32, 4)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_decode_kernel_long_cache(dev, dtype, hq, hkv, kv_int8, bs):
    """Row 14 over path 5's length through shuffled tables, split over the
    card: bs1 at 8201 live rows; then bs4 at ragged positions 0, a split's
    first row, the table's last row and MB * BS, which writes trash row 0
    and, through -1 entries among its live rows, reads the trash block: its
    aliases of the write row attend the new token, as the plain write-then-
    gather does."""
    d, cap = 128, 8320
    mb = -(-cap // bs)
    g = torch.Generator(device=dev).manual_seed(bs + hkv)
    for b in (1, 4):
        splits, tps = da.decode_split(b, hkv, mb * bs, hq // hkv,
                                      da.sm_count(dev))
        assert splits > 1
        nb = b * mb + 1
        pk, pv, kv_scale = _pools(dev, dtype, kv_int8, 2, nb, hkv, bs, d, g)
        tables = torch.randperm(nb - 1, generator=g, device=dev).reshape(
            b, mb).to(torch.int32)
        if b == 1:
            pos = [8200]
        else:
            pos = [0, tps * da.TILE, mb * bs - 1, mb * bs]
            tables[3, 3:7] = -1
        pos = torch.tensor(pos, dtype=torch.int32, device=dev)
        q = torch.randn((b, hq, d), generator=g, device=dev).to(dtype)
        kn = (4 * torch.randn((b, hkv, d), generator=g, device=dev)).to(dtype)
        vn = (4 * torch.randn((b, hkv, d), generator=g, device=dev)).to(dtype)
        _paged_write_case(q, kn, vn, pk, pv, tables, pos, kv_scale, dtype)


def test_paged_decode_kernel_allocates_only_its_output(dev):
    """A second call of row 14 at a shape split over the card allocates
    nothing but its output (the workspace is the stream's, made at the
    first call)."""
    hq, hkv, d, bs, mb = 32, 4, 128, 64, 32
    g = torch.Generator(device=dev).manual_seed(3)
    assert da.decode_split(2, hkv, mb * bs, hq // hkv, da.sm_count(dev))[0] > 1
    pk, pv, _ = _pools(dev, torch.bfloat16, False, 2, 2 * mb + 1, hkv, bs, d,
                       g)
    tables = torch.arange(2 * mb, dtype=torch.int32, device=dev).reshape(2, mb)
    pos = torch.tensor([1500, 2047], dtype=torch.int32, device=dev)
    q = torch.randn((2, hq, d), generator=g, device=dev).to(torch.bfloat16)
    kn = torch.randn((2, hkv, d), generator=g, device=dev).to(torch.bfloat16)
    pda.paged_decode_attention(q, kn, kn, pk, pv, 1, tables, pos)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    out = pda.paged_decode_attention(q, kn, kn, pk, pv, 1, tables, pos)
    torch.cuda.synchronize()
    out_bytes = -(-out.numel() * out.element_size() // 512) * 512
    assert torch.cuda.memory_allocated(dev) - before <= out_bytes


@pytest.mark.parametrize("t,lens", [(24, [5, 1, 9]), (64, [20, 30, 1]),
                                    (100, [37, 1, 50]), (48, [48]),
                                    (1024, [128, 77, 3, 128, 100, 1, 128]),
                                    (1, [1]), (200, [64, 1, 63, 65]),
                                    (2048, [700, 1, 1000, 300])])
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("hq,hkv", [(32, 32), (32, 8), (71, 1)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_packed_prefill_kernel_matches_plain(dev, dtype, hq, hkv, d, t, lens):
    """Segment layouts with pad rows, a length-1 segment (also on a 64-row
    tile edge), segments that cross tiles and long ones, T off the tile,
    GQA 4 and 71:1; pad rows must come out finite; one launch per call."""
    g = torch.Generator(device=dev).manual_seed(t + hkv)
    q, k, v = (torch.randn((t, h, d), generator=g, device=dev).to(dtype)
               for h in (hq, hkv, hkv))
    seg = torch.full((t,), -1, dtype=torch.int32, device=dev)
    off = 0
    for i, n in enumerate(lens):
        seg[off:off + n] = i
        off += n
    launches = ppa.packed_prefill_attention_kernel.launches
    got = ppa.packed_prefill_attention_kernel(q, k, v, seg)
    assert ppa.packed_prefill_attention_kernel.launches == launches + 1
    ref = ppa.packed_prefill_attention_kernel_plain(q, k, v, seg)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    real = seg >= 0
    _assert_close(got[real], ref[real], dtype)


def test_tiny_sq_int8kv_generate_on_cuda_matches_cpu(dev):
    from trtllm_llama_tpu_torch import EngineConfig, ModelConfig, QuantMode
    from trtllm_llama_tpu_torch.quantization.quantize import (
        init_random_quantized_params,
    )
    from trtllm_llama_tpu_torch.runtime.sampling import SamplingConfig
    from trtllm_llama_tpu_torch.runtime.session import GenerationSession

    mode = (QuantMode.use_smooth_quant(per_token=True, per_channel=True)
            | QuantMode.INT8_KV_CACHE)
    cfg = ModelConfig.tiny(dtype="float32", quant_mode=mode)
    params = init_random_quantized_params(cfg, seed=0, device="cpu")
    prompts = [[5, 17, 99, 3, 250, 8], [200, 4, 66]]
    outs = []
    for device in ("cpu", "cuda"):
        sess = GenerationSession(cfg, params, EngineConfig(
            max_input_len=16, max_seq_len=48), kv_scales=[0.05, 0.05],
            device=device)
        outs.append(sess.generate(prompts, sampling=SamplingConfig(end_id=-1),
                                  max_new_tokens=10).output_ids)
    np.testing.assert_array_equal(outs[0], outs[1])


def test_tiny_generate_on_cuda_matches_cpu(dev):
    from trtllm_llama_tpu_torch import EngineConfig, ModelConfig, QuantMode
    from trtllm_llama_tpu_torch.quantization.quantize import (
        init_random_quantized_params,
    )
    from trtllm_llama_tpu_torch.runtime.sampling import SamplingConfig
    from trtllm_llama_tpu_torch.runtime.session import GenerationSession

    cfg = ModelConfig.tiny(dtype="float32",
                           quant_mode=QuantMode.use_weight_only())
    params = init_random_quantized_params(cfg, seed=0, device="cpu")
    prompts = [[5, 17, 99, 3, 250, 8], [200, 4, 66]]
    outs = []
    for device in ("cpu", "cuda"):
        sess = GenerationSession(cfg, params, EngineConfig(
            max_input_len=16, max_seq_len=48), device=device)
        outs.append(sess.generate(prompts, sampling=SamplingConfig(end_id=-1),
                                  max_new_tokens=10).output_ids)
    np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.parametrize("kind", ["int4 g64", "fp8"])
def test_tiny_int4_and_fp8_generate_on_cuda_match_cpu(dev, kind):
    """Tiny models with a quantized lm_head (the 2-D entries) give the same
    greedy tokens on the card as on the CPU."""
    from trtllm_llama_tpu_torch import EngineConfig, ModelConfig, QuantMode
    from trtllm_llama_tpu_torch.quantization.quantize import (
        init_random_quantized_params, quantize_params,
    )
    from trtllm_llama_tpu_torch.runtime.sampling import SamplingConfig
    from trtllm_llama_tpu_torch.runtime.session import GenerationSession

    mode = (QuantMode.FP8_QDQ if kind == "fp8"
            else QuantMode.use_weight_only(True, per_group=True))
    cfg = ModelConfig.tiny(dtype="float32", quant_mode=mode, group_size=64)
    params = quantize_params(
        init_random_quantized_params(cfg, seed=0, device="cpu"), mode,
        quantize_lm_head=True)
    prompts = [[5, 17, 99, 3, 250, 8], [200, 4, 66]]
    outs = []
    for device in ("cpu", "cuda"):
        sess = GenerationSession(cfg, params, EngineConfig(
            max_input_len=16, max_seq_len=48), device=device)
        before = (f8k.fp8_matmul if kind == "fp8" else woq.woq_matmul).launches
        outs.append(sess.generate(prompts, sampling=SamplingConfig(end_id=-1),
                                  max_new_tokens=10).output_ids)
        after = (f8k.fp8_matmul if kind == "fp8" else woq.woq_matmul).launches
        assert (after > before) == (device == "cuda")
    np.testing.assert_array_equal(outs[0], outs[1])


def test_wrappers_reject_bad_inputs(dev):
    w = WOQWeight(torch.zeros((1, 64, 24), dtype=torch.int8, device=dev),
                  torch.ones((1, 24), device=dev))
    with pytest.raises(ValueError):               # N % 16 != 0
        woq.woq_matmul_stacked(torch.ones((1, 64), device=dev), w, 0)
    w4 = WOQWeight(torch.zeros((1, 48, 32), dtype=torch.int8, device=dev),
                   torch.ones((1, 32), device=dev), 4, 0, 64)
    with pytest.raises(ValueError):               # K 96 !% pack block 64
        woq.woq_matmul_stacked(torch.ones((1, 96), device=dev), w4, 0)
    f8 = FP8Weight(torch.zeros((1, 64, 32), dtype=torch.int8, device=dev),
                   torch.ones((1, 32), device=dev))
    with pytest.raises(ValueError):               # codes must be uint8
        f8k.fp8_matmul_stacked(torch.ones((1, 64), device=dev), f8, 0)
    q = torch.ones((1, 8, 2, 48), device=dev)     # head dim 48
    with pytest.raises(ValueError):
        pa.prefill_attention_kernel(q, q, q)
    x_q = torch.zeros((1, 64), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError):               # N % 16 != 0
        w8a8.w8a8_matmul(x_q, w.qweight[0], torch.ones(1, device=dev),
                         torch.ones(24, device=dev))
    with pytest.raises(TypeError):                # weight dtype != x dtype
        rnq.rmsnorm_quant(torch.ones((1, 64), device=dev),
                          torch.ones(64, device=dev, dtype=torch.bfloat16))
    cache = torch.zeros((1, 1, 2, 32, 32), dtype=torch.int8, device=dev)
    new = torch.ones((1, 2, 32), device=dev)
    with pytest.raises(ValueError):               # int8 cache, no kv_scale
        da.dma_decode_attention(new, new, new, cache, cache.clone(), 0,
                                torch.zeros(1, dtype=torch.int32, device=dev))
    pool = torch.zeros((1, 3, 2, 12, 32), device=dev)
    with pytest.raises(ValueError):               # block size 12
        pda.paged_decode_attention(new, new, new, pool, pool.clone(), 0,
                                   torch.zeros((1, 1), dtype=torch.int32,
                                               device=dev),
                                   torch.zeros(1, dtype=torch.int32,
                                               device=dev))
    with pytest.raises(ValueError):               # head dim 48
        ppa.packed_prefill_attention_kernel(
            q[0], q[0], q[0], torch.zeros(8, dtype=torch.int32, device=dev))


def test_decode_and_streaming_wrappers_reject_bad_inputs(dev):
    q = torch.ones((1, 8, 2, 48), device=dev)     # head dim 48
    with pytest.raises(ValueError):
        spa.streaming_prefill_attention_kernel(q, q, q)
    with pytest.raises(ValueError):               # ALiBi slopes not [Hq]
        spa.streaming_prefill_attention_kernel(q[..., :32].contiguous(),
                                               q[..., :32].contiguous(),
                                               q[..., :32].contiguous(),
                                               alibi=torch.ones(3))
    cache = torch.zeros((1, 1, 2, 32, 32), dtype=torch.int8, device=dev)
    new = torch.ones((1, 2, 32), device=dev)
    lens = torch.ones(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):               # int8 cache, no kv_scale
        da.decode_attention_kernel(new, cache, cache.clone(), 0, lens)
    with pytest.raises(ValueError):               # int8 cache, no kv_scale
        da.fused_decode_attention(new, new, new, cache, cache.clone(), 0, lens)
    # a GQA group of 512 heads is not refused: row 9 cuts a group whose
    # state outgrows shared memory into head chunks
    big = torch.randn((1, 1, 1, 32, 128), device=dev)
    q = torch.randn((1, 512, 128), device=dev)
    got = da.fused_decode_attention(q, big[0, :, :, 0], big[0, :, :, 0], big,
                                    big.clone(), 0, lens)
    ref = da.fused_decode_attention_plain(q, big[0, :, :, 0], big[0, :, :, 0],
                                          big.clone(), big.clone(), 0, lens)
    _assert_close(got, ref, torch.float32)


@pytest.mark.parametrize("s,lens", [(150, [150, 77, 0]), (65, [1, 65]),
                                    (1024, [1024, 923, 64])])
@pytest.mark.parametrize("kernel", ["prefill", "streaming"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_alibi_prefill_kernels_match_plain(dev, dtype, kernel, s, lens):
    """ALiBi: distinct slopes per head (interpolated for 12 heads), a length
    mask with lengths of 0, 1 and S, S off the 64-row tile, GQA, every head
    dim."""
    from trtllm_llama_tpu_torch.ops.attention import alibi_slopes
    fn, plain = ((pa.prefill_attention_kernel,
                  pa.prefill_attention_kernel_plain) if kernel == "prefill"
                 else (spa.streaming_prefill_attention_kernel,
                       spa.streaming_prefill_attention_kernel_plain))
    g = torch.Generator(device=dev).manual_seed(70 + s)
    b, hq, hkv = len(lens), 12, 4
    for d in HEAD_DIMS:
        q, k, v = (torch.randn((b, s, h, d), generator=g,
                               device=dev).to(dtype) for h in (hq, hkv, hkv))
        sl = torch.tensor(lens, dtype=torch.int32, device=dev)
        slopes = alibi_slopes(hq, device=dev)
        launches = fn.launches
        got = fn(q, k, v, sl, alibi=slopes)
        assert fn.launches == launches + 1
        ref = plain(q, k, v, sl, alibi=slopes)
        torch.cuda.synchronize()
        _assert_close(got, ref, dtype)
        assert not torch.allclose(got.float(), plain(q, k, v, sl).float(),
                                  atol=1e-2)


@pytest.mark.parametrize("kv_int8", KV_KINDS)
@pytest.mark.parametrize("hq,d", [(26, 128), (32, 128), (71, 64)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_decode_kernel_large_groups(dev, dtype, hq, d, kv_int8):
    """Row 9 with one KV head for the whole group (Falcon-7B: 71 heads of
    64), served in chunks of up to 8 heads: a 256-row cache, then a
    2048-row one split over the card at positions 1037, the first row of
    the second split, the last row and past it."""
    q, kn, vn, kc, vc, kv_scale = _decode_cache(dev, dtype, kv_int8, hq, 1,
                                                2, 256, d, hq)
    pos = torch.tensor([5, 200], dtype=torch.int32, device=dev)
    _write_case(da.fused_decode_attention, da.fused_decode_attention_plain,
                q, kn, vn, kc, vc, pos, kv_scale, dtype)
    b, s = 4, 2048
    splits, tps = da.decode_split(b, 1, s, hq, da.sm_count(dev))
    assert splits > 1
    q, kn, vn, kc, vc, kv_scale = _decode_cache(dev, dtype, kv_int8, hq, 1, b,
                                                s, d, hq + d)
    pos = torch.tensor([1037, tps * da.TILE, 2047, 2048], dtype=torch.int32,
                       device=dev)
    _write_case(da.fused_decode_attention, da.fused_decode_attention_plain,
                q, kn, vn, kc, vc, pos, kv_scale, dtype)



@pytest.mark.parametrize("fn", [da.dma_decode_attention,
                                da.fused_decode_attention],
                         ids=["kernel3", "row9"])
def test_decode_kernel_on_two_streams(dev, fn):
    """Kernel 3 / row 9 launched on two streams at once at a shape split
    over the card (one KV head, a group of 8, 2048 rows: 32 splits, a
    grid small enough for both launches to run side by side), a bf16 and
    an int8 cache, each call followed on its stream by row 8 over the rows
    just written and by row 14 on the same rows held in a paged pool (a
    shuffled table): each stream merges its splits in a workspace of its
    own, which its row 8, row 14 and kernel 3 / row 9 calls share in turn,
    so every output equals the plain version, the caches and pools equal
    the plain write and each call adds one launch."""
    hq, d, s, bs, n_calls = 8, 128, 2048, 64, 20
    assert da.decode_split(1, 1, s, hq, da.sm_count(dev))[0] > 1
    cases, refs = [], []
    for kv_int8, p_, seed in ((False, 1037, 1), (True, s - 1, 2)):
        q, kn, vn, kc, vc, kvs = _decode_cache(dev, torch.bfloat16, kv_int8,
                                               hq, 1, 1, s, d, seed)
        pos = torch.tensor([p_], dtype=torch.int32, device=dev)
        # the same rows, paged: block order shuffled, one trash block
        order = torch.randperm(s // bs, generator=torch.Generator(
            device=dev).manual_seed(seed), device=dev)
        tables = order.to(torch.int32)[None]
        pk, pv = (torch.zeros((2, s // bs + 1, 1, bs, d), device=dev,
                              dtype=c.dtype) for c in (kc, vc))
        pk[:, order.long()] = kc[:, 0].reshape(2, 1, s // bs, bs, d
                                               ).transpose(1, 2)
        pv[:, order.long()] = vc[:, 0].reshape(2, 1, s // bs, bs, d
                                               ).transpose(1, 2)
        kc2, vc2, pk2, pv2 = kc.clone(), vc.clone(), pk.clone(), pv.clone()
        ref = da.dma_decode_attention_plain(q, kn, vn, kc2, vc2, 1, pos,
                                            kv_scale=kvs)
        ref_read = da.decode_attention_kernel_plain(q, kc2, vc2, 1, pos + 1,
                                                    kv_scale=kvs)
        ref_paged = pda.paged_decode_attention_plain(q, kn, vn, pk2, pv2, 1,
                                                     tables, pos, kv_scale=kvs)
        refs.append((ref, ref_read, ref_paged, kc2, vc2, pk2, pv2))
        cases.append((q, kn, vn, kc, vc, pos, kvs, pk, pv, tables))
    streams = [torch.cuda.Stream(dev) for _ in cases]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream(dev))
    launches = (fn.launches, da.decode_attention_kernel.launches,
                pda.paged_decode_attention.launches)
    outs = [[] for _ in cases]
    for _ in range(n_calls):
        for st, case, got in zip(streams, cases, outs):
            q, kn, vn, kc, vc, pos, kvs, pk, pv, tables = case
            with torch.cuda.stream(st):
                got.append((fn(q, kn, vn, kc, vc, 1, pos, kv_scale=kvs),
                            da.decode_attention_kernel(q, kc, vc, 1, pos + 1,
                                                       kv_scale=kvs),
                            pda.paged_decode_attention(q, kn, vn, pk, pv, 1,
                                                       tables, pos,
                                                       kv_scale=kvs)))
    torch.cuda.synchronize()
    calls = n_calls * len(cases)
    assert (fn.launches, da.decode_attention_kernel.launches,
            pda.paged_decode_attention.launches) == tuple(
                n + calls for n in launches)
    for case, ref_case, got in zip(cases, refs, outs):
        ref, ref_read, ref_paged = ref_case[:3]
        for have, want in zip(case[3:5] + case[7:9], ref_case[3:]):
            assert torch.equal(have, want)
        for out, out_read, out_paged in got:
            _assert_close(out, ref, torch.bfloat16)
            _assert_close(out_read, ref_read, torch.bfloat16)
            _assert_close(out_paged, ref_paged, torch.bfloat16)


def test_head_dim_without_a_kernel_raises_on_card(dev):
    """Head dim 80 has no instantiation: every attention op raises on the
    card before any launch (the plain versions run on the CPU only)."""
    from unittest import mock

    from trtllm_llama_tpu_torch import ModelConfig
    from trtllm_llama_tpu_torch.ops import attention, paged_attention
    from trtllm_llama_tpu_torch.ops.registry import KERNELS
    d = 80
    q, k, v = (torch.ones((2, 20, h, d), device=dev, dtype=torch.bfloat16)
               for h in (4, 2, 2))
    lens = torch.tensor([20, 9], dtype=torch.int32, device=dev)
    wrappers = (pa.prefill_attention_kernel,
                spa.streaming_prefill_attention_kernel,
                ppa.packed_prefill_attention_kernel, da.dma_decode_attention,
                da.fused_decode_attention, da.decode_attention_kernel,
                pda.paged_decode_attention)
    launches = [w.launches for w in wrappers]
    with pytest.raises(ValueError):
        attention.prefill_attention(q, k, v, lens)
    with pytest.raises(ValueError):
        spa.streaming_prefill_attention_kernel(q, k, v, lens)
    seg = torch.zeros(20, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        attention.packed_prefill_attention(q[0], k[0], v[0], seg)
    cache = attention.KVCache(
        torch.zeros((1, 2, 2, 128, d), device=dev, dtype=torch.bfloat16),
        torch.zeros((1, 2, 2, 128, d), device=dev, dtype=torch.bfloat16),
        torch.ones(1, device=dev))
    for mode in ("auto", "fused", "split"):
        with mock.patch.dict(KERNELS, decode_attn_mode=mode):
            with pytest.raises(ValueError):
                attention.fused_decode_attention_at(q[:, 0], k[:, 0],
                                                    v[:, 0], cache, 0, lens)
    pools = paged_attention.init_paged_caches(
        ModelConfig.tiny(dtype="bfloat16", num_layers=1, head_dim=d,
                         num_heads=4, num_kv_heads=2), 4, 8, 2, 2, dev)
    with pytest.raises(ValueError):
        paged_attention.paged_fused_decode_attention_at(
            q[:, 0], k[:, 0], v[:, 0], pools, 0, lens)
    assert [w.launches for w in wrappers] == launches


def test_dense_unquantized_makes_no_f32_weight_copy(dev, monkeypatch):
    """The bf16 GEMM with an f32 output (torch.mm's out_dtype) allocates
    far less than an f32 copy of the weight and agrees with the f32
    product, under torch's default reduced-precision reduction flag."""
    from trtllm_llama_tpu_torch.ops.linear import dense
    monkeypatch.setattr(torch.backends.cuda.matmul,
                        "allow_bf16_reduced_precision_reduction", True)
    g = torch.Generator(device=dev).manual_seed(80)
    k, n = 4096, 16384
    w = (torch.randn((2, k, n), generator=g, device=dev) * k ** -0.5).to(
        torch.bfloat16)
    x = torch.randn((3, k), generator=g, device=dev).to(torch.bfloat16)
    ref = x.float() @ w[1].float()
    for out_dtype in (None, torch.float32):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        y = dense(x, w, out_dtype, layer=1)
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated(dev) - base
        assert extra < k * n, extra              # an f32 copy is 4 * k * n
        assert y.dtype == (out_dtype or torch.bfloat16)
        _assert_close(y, ref, y.dtype)


# the SwiGLU prologue of rows 2 and 4: x [M, 2K] = [gate | up] at the down
# projection's shape (K = 11008 -> N = 4096)
SWIGLU_FORMATS = ["int8", "int4 g128", "int4 per-channel", "fp8"]


def _swiglu_weight(fmt, g, dev, n_layers=2, k=11008, n=4096):
    if fmt == "fp8":
        return FP8Weight(random_fp8_codes((n_layers, k, n), g, dev),
                         torch.rand((n_layers, n), generator=g,
                                    device=dev) * 1e-3, 128 if k % 128 == 0
                         else 0)
    w_bits = 8 if fmt == "int8" else 4
    gs = 128 if fmt == "int4 g128" else 0
    q = torch.randint(-127, 128, (n_layers, k // 2 if w_bits == 4 else k, n),
                      generator=g, device=dev, dtype=torch.int8)
    s = torch.rand((n_layers, k // gs, n) if gs else (n_layers, n),
                   generator=g, device=dev) * 1e-3
    return WOQWeight(q, s, w_bits, gs, 128 if w_bits == 4 else 0)


@pytest.mark.parametrize("resid", [False, True])
@pytest.mark.parametrize("m", [1, 9, 16])
@pytest.mark.parametrize("fmt", SWIGLU_FORMATS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_swiglu_prologue_matches_plain(dev, dtype, fmt, m, resid):
    g = torch.Generator(device=dev).manual_seed(m + 7)
    w = _swiglu_weight(fmt, g, dev)
    k, n = w.k_dim, w.qweight.shape[-1]
    x = (2 * torch.randn((m, 2 * k), generator=g, device=dev)).to(dtype)
    kw = ({"resid": torch.randn((m, n), generator=g, device=dev).to(dtype)}
          if resid else {})
    mod, fn = ((f8k, f8k.fp8_matmul_stacked) if fmt == "fp8"
               else (woq, woq.woq_matmul_stacked))
    before = (fn.launches, fn.swiglu_launches)
    got = fn(x, w, 1, swiglu=True, **kw)
    assert (fn.launches, fn.swiglu_launches) == (before[0] + 1, before[1] + 1)
    plain = getattr(mod, fn.__name__ + "_plain")
    _assert_close(got, plain(x, w, 1, swiglu=True, **kw), dtype)
    with pytest.raises(ValueError):               # one prologue per matmul
        fn(x, w, 1, swiglu=True, norm_w=torch.ones(
            (2, k), device=dev, dtype=dtype))
    with pytest.raises(ValueError):               # x must be [M, 2K]
        fn(x[:, :k].contiguous(), w, 1, swiglu=True)


# row 5 (the 2-D w8a8_matmul) at the static-SmoothQuant path's shapes:
# fused qkv, wo, gate or up, fused gate/up, down
W8A8_PATH7 = [(4096, 12288), (4096, 4096), (4096, 11008), (4096, 22016),
              (11008, 4096)]


@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("kn", W8A8_PATH7)
@pytest.mark.parametrize("m", [1, 8])
def test_w8a8_2d_entry_at_static_sq_shapes(dev, m, kn, per_channel):
    k, n = kn
    g = torch.Generator(device=dev).manual_seed(m + k + n)
    x_q = torch.randint(-127, 128, (m, k), generator=g, device=dev,
                        dtype=torch.int8)
    w_q = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                        dtype=torch.int8)
    s_x = torch.tensor(0.02, device=dev)
    s_w = torch.rand((n if per_channel else 1,), generator=g,
                     device=dev) * 1e-3
    before = (w8a8.w8a8_matmul.launches, w8a8.w8a8_matmul_stacked.launches)
    got = w8a8.w8a8_matmul(x_q, w_q, s_x, s_w)
    assert (w8a8.w8a8_matmul.launches,
            w8a8.w8a8_matmul_stacked.launches) == (before[0] + 1, before[1])
    torch.testing.assert_close(got, w8a8.w8a8_matmul_plain(x_q, w_q, s_x, s_w),
                               rtol=1e-6, atol=0)


def test_static_sq_dense_takes_the_2d_entry_on_card(dev):
    """A stacked static SQWeight with a layer runs row 5 on that layer's
    views; a per-token one row 6."""
    from trtllm_llama_tpu_torch.ops import linear
    from trtllm_llama_tpu_torch.quantization.tensors import (
        quantize_smoothquant_weight,
    )
    g = torch.Generator(device=dev).manual_seed(5)
    w = torch.randn((3, 256, 512), generator=g, device=dev) * 0.05
    x = torch.randn((4, 256), generator=g, device=dev).to(torch.bfloat16)
    for per_token, entry in ((False, w8a8.w8a8_matmul),
                             (True, w8a8.w8a8_matmul_stacked)):
        sq = quantize_smoothquant_weight(w, torch.full((3,), 3.0),
                                         per_channel=True,
                                         per_token=per_token)
        before = entry.launches
        got = linear.dense(x, sq, layer=2)
        assert entry.launches == before + 1
        ref = linear.dense(x.cpu(), sq.to("cpu"), layer=2)
        _assert_close(got, ref.to(dev), torch.bfloat16)


PROBES = ["bitcast", "u16", "construct", "gemv_decodes", "tc_pairs",
          "fp8_planes"]


def _same_bits(got, ref):
    """Exact: equal values, or both NaN (the two e4m3 NaN codes)."""
    got, ref = got.cpu(), ref.cpu()
    both_nan = torch.isnan(got.float()) & torch.isnan(ref.float())
    assert (both_nan | (got == ref)).all()


@pytest.mark.parametrize("probe", PROBES)
def test_decode_probes_exact(dev, probe):
    from trtllm_llama_tpu_torch.ops.kernels import probes as pr
    fn, make = {"bitcast": (pr.probe_bitcast_u32_bf16, pr.bitcast_inputs),
                "u16": (pr.probe_u16_ops, pr.u16_inputs),
                "construct": (pr.probe_u32_bf16_construct,
                              pr.construct_inputs),
                "gemv_decodes": (pr.probe_gemv_decodes, pr.code_inputs),
                "tc_pairs": (pr.probe_tc_pairs, pr.code_inputs),
                "fp8_planes": (pr.probe_fp8_planes, pr.planes_inputs)}[probe]
    before = fn.launches
    got = fn(make(dev))
    assert fn.launches == before + 1
    ref = getattr(pr, fn.__name__ + "_plain")(make("cpu"))
    for a, b in (zip(got, ref) if isinstance(got, tuple) else [(got, ref)]):
        assert a.shape == b.shape and a.dtype == b.dtype
        _same_bits(a, b)


@pytest.mark.parametrize("scale", [1.0, 0.05, 0.021])
def test_kv_codec_probe_exact(dev, scale):
    """The fp8 KV cache's codec in the decode kernels: the encode sweep
    (ties, +-448 and past it, subnormals, -0) bit for bit against
    fp8_encode(x / scale), all 256 codes through dec and both load_raw reads
    against fp8_decode (NaN codes NaN on both sides)."""
    from trtllm_llama_tpu_torch.ops.kernels import probes as pr
    x = pr.kv_codec_inputs()
    s = torch.tensor([scale])
    before = pr.probe_kv_codec.launches
    got = pr.probe_kv_codec(x.to(dev), s.to(dev))
    assert pr.probe_kv_codec.launches == before + 1
    for a, b in zip(got, pr.probe_kv_codec_plain(x, s)):
        assert a.shape == b.shape and a.dtype == b.dtype
        _same_bits(a, b)


@pytest.mark.parametrize("fn", [da.dma_decode_attention,
                                da.fused_decode_attention,
                                da.decode_attention_kernel,
                                pda.paged_decode_attention],
                         ids=["kernel3", "row9", "row8", "row14"])
def test_e4m3_decode_is_bitwise_repeatable(dev, fn):
    """Two calls on copies of one e4m3 cache split over the card (bf16 q,
    8320 rows, GQA group 4) give the same output and cache bits: the
    splits merge in split order, whichever finishes last."""
    b, hq, hkv, s, d = 2, 32, 8, 8320, 128
    q, kn, vn, kc, vc, kv_scale = _decode_cache(dev, torch.bfloat16, "e4m3",
                                                hq, hkv, b, s, d, 17)
    pos = torch.tensor([8200, 4000], dtype=torch.int32, device=dev)
    if fn is pda.paged_decode_attention:   # the same rows through a table
        bs = 64
        pk = kc.reshape(2, b, hkv, s // bs, bs, d).permute(0, 1, 3, 2, 4, 5)
        pk = pk.reshape(2, b * s // bs, hkv, bs, d)
        kc = torch.cat([pk, pk[:, :1]], dim=1).contiguous()
        vc = kc.flip(-1).contiguous()
        tables = torch.arange(b * s // bs, dtype=torch.int32,
                              device=dev).reshape(b, s // bs)

        def call(k, v):
            return fn(q, kn, vn, k, v, 1, tables, pos, kv_scale=kv_scale)
    elif fn is da.decode_attention_kernel:
        def call(k, v):
            return fn(q, k, v, 1, pos + 1, kv_scale=kv_scale)
    else:
        def call(k, v):
            return fn(q, kn, vn, k, v, 1, pos, kv_scale=kv_scale)
    outs = []
    for _ in range(2):
        k, v = kc.clone(), vc.clone()
        outs.append((call(k, v), k, v))
    torch.cuda.synchronize()
    for a, b_ in zip(*outs):
        assert torch.equal(a, b_)


def test_tiny_fp8kv_generate_on_cuda_matches_cpu(dev):
    """bench.py's fp8kv (fp8 projections and lm_head, an e4m3 KV cache at
    scale 0.05) on a tiny f32 model, dense and paged: the card's greedy
    tokens equal the CPU's, and the card ran kernel 3 / row 14."""
    from trtllm_llama_tpu_torch import EngineConfig, ModelConfig, QuantMode
    from trtllm_llama_tpu_torch.quantization.quantize import (
        init_random_quantized_params, quantize_params,
    )
    from trtllm_llama_tpu_torch.runtime.sampling import SamplingConfig
    from trtllm_llama_tpu_torch.runtime.serving import ServingEngine
    from trtllm_llama_tpu_torch.runtime.session import GenerationSession

    mode = QuantMode.FP8_QDQ | QuantMode.FP8_KV_CACHE
    cfg = ModelConfig.tiny(dtype="float32", quant_mode=mode)
    params = quantize_params(
        init_random_quantized_params(cfg, seed=0, device="cpu"), mode,
        quantize_lm_head=True)
    prompts = [[5, 17, 99, 3, 250, 8], [200, 4, 66]]
    scales = [0.05] * cfg.num_layers
    outs, served = [], []
    for device in ("cpu", "cuda"):
        sess = GenerationSession(cfg, params, EngineConfig(
            max_input_len=16, max_seq_len=48), kv_scales=scales,
            device=device)
        before = da.dma_decode_attention.launches
        outs.append(sess.generate(prompts, sampling=SamplingConfig(end_id=-1),
                                  max_new_tokens=10).output_ids)
        assert ((da.dma_decode_attention.launches > before)
                == (device == "cuda"))
        eng = ServingEngine(cfg, params, EngineConfig(
            max_batch_size=2, max_input_len=16, max_seq_len=48),
            sampling=SamplingConfig(end_id=-1), kv_scales=scales,
            decode_chunk=4, device=device, paged=True, block_size=8)
        rids = [eng.submit(p_, 10) for p_ in prompts]
        before = pda.paged_decode_attention.launches
        done = eng.run_to_completion()
        assert ((pda.paged_decode_attention.launches > before)
                == (device == "cuda"))
        served.append([list(done[r].output_ids) for r in rids])
    np.testing.assert_array_equal(outs[0], outs[1])
    assert served[0] == served[1]


@pytest.mark.parametrize("kind", ["int8wo", "int4 g128", "fp8", "sq-static"])
def test_fuse_gate_up_generate_on_cuda_matches_cpu(dev, kind, monkeypatch):
    """Under TLLM_FUSE_GU the card's tokens equal the CPU's, and the SwiGLU
    prologue runs in the kernel at decode shapes (WOQ / fp8) or row 5 runs
    every projection (static SQ)."""
    from trtllm_llama_tpu_torch import EngineConfig, ModelConfig, QuantMode
    from trtllm_llama_tpu_torch.quantization.quantize import (
        init_random_quantized_params,
    )
    from trtllm_llama_tpu_torch.runtime.sampling import SamplingConfig
    from trtllm_llama_tpu_torch.runtime.session import GenerationSession

    mode = {"int8wo": QuantMode.use_weight_only(),
            "int4 g128": QuantMode.use_weight_only(True, per_group=True),
            "fp8": QuantMode.FP8_QDQ,
            "sq-static": QuantMode.use_smooth_quant()}[kind]
    cfg = ModelConfig.tiny(dtype="float32", quant_mode=mode, group_size=128)
    params = init_random_quantized_params(cfg, seed=0, device="cpu")
    monkeypatch.setenv("TLLM_FUSE_GU", "1")
    prompts = [[5, 17, 99, 3, 250, 8], [200, 4, 66]]
    counter = {"fp8": f8k.fp8_matmul_stacked,
               "sq-static": w8a8.w8a8_matmul}.get(kind, woq.woq_matmul_stacked)
    outs = []
    for device in ("cpu", "cuda"):
        sess = GenerationSession(cfg, params, EngineConfig(
            max_input_len=16, max_seq_len=48), device=device)
        assert "w_gate_up" in sess.params["layers"]
        before = (counter.launches, getattr(counter, "swiglu_launches", 0))
        outs.append(sess.generate(prompts, sampling=SamplingConfig(end_id=-1),
                                  max_new_tokens=10).output_ids)
        after = (counter.launches, getattr(counter, "swiglu_launches", 0))
        if device == "cuda":
            # qkv, wo, gate/up, down in each of 10 forwards
            assert after[0] - before[0] == 4 * cfg.num_layers * 10
            if kind != "sq-static":     # 2 x 16 prefill rows compose plainly
                assert after[1] - before[1] == cfg.num_layers * 9
    np.testing.assert_array_equal(outs[0], outs[1])


# rows 2 and 4 at prefill rows: the tensor-core GEMM (csrc/woq_gemm.cuh), at
# LLaMA-7B's projection shapes (fused qkv, wo, gate or up, down) through the
# stacked entry and at the lm_head's N = 32000 through the 2-D one
GEMM_FORMATS = ["int8", "int4 per-channel", "int4 g128", "fp8"]
GEMM_SHAPES = [(4096, 12288), (4096, 4096), (4096, 11008), (11008, 4096),
               (4096, 32000)]


@pytest.mark.parametrize("kn", GEMM_SHAPES)
@pytest.mark.parametrize("m", [17, 64, 257, 1024])
@pytest.mark.parametrize("fmt", GEMM_FORMATS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_gemm_matches_plain(dev, dtype, fmt, m, kn):
    k, n = kn
    g = torch.Generator(device=dev).manual_seed(m + k + n)
    w = _swiglu_weight(fmt, g, dev, k=k, n=n)
    x = torch.randn((m, k), generator=g, device=dev).to(dtype)
    mod, fn = ((f8k, f8k.fp8_matmul_stacked) if fmt == "fp8"
               else (woq, woq.woq_matmul_stacked))
    if n == 32000:                               # the 2-D entry (lm_head)
        fn = f8k.fp8_matmul if fmt == "fp8" else woq.woq_matmul
        args = (x, dataclasses.replace(w, qweight=w.qweight[1],
                                       scale=w.scale[1]))
    else:
        args = (x, w, 1)
    before = (fn.launches, fn.gemm_launches)
    got = fn(*args)
    torch.cuda.synchronize()
    assert (fn.launches, fn.gemm_launches) == (before[0] + 1, before[1] + 1)
    plain = getattr(mod, fn.__name__ + "_plain")
    _assert_close(got, plain(*args), dtype)


def test_gemm_route_keeps_f32_and_options_on_the_gemv(dev):
    g = torch.Generator(device=dev).manual_seed(3)
    w = _swiglu_weight("int8", g, dev, k=4096, n=4096)
    m = 64
    x = torch.randn((m, 4096), generator=g, device=dev)
    cases = [({}, x, torch.float32),                        # f32
             ({"norm_w": torch.ones((2, 4096), device=dev,
                                    dtype=torch.bfloat16)},
              x.to(torch.bfloat16), torch.bfloat16),        # a prologue
             ({"resid": torch.randn((m, 4096), generator=g, device=dev).to(
                 torch.bfloat16)}, x.to(torch.bfloat16), torch.bfloat16)]
    for kw, xx, dtype in cases:
        fn = woq.woq_matmul_stacked
        before = (fn.launches, fn.gemm_launches)
        got = fn(xx, w, 1, **kw)
        torch.cuda.synchronize()
        assert (fn.launches, fn.gemm_launches) == (before[0] + 1, before[1])
        _assert_close(got, woq.woq_matmul_stacked_plain(xx, w, 1, **kw),
                      dtype)


def test_gemm_refuses_a_k_it_cannot_take_before_launch(dev):
    q = torch.zeros((1, 1000, 128), dtype=torch.int8, device=dev)
    s = torch.ones((1, 128), device=dev)
    x = torch.ones((64, 1000), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="whole 16-row steps"):
        woq.launch_gemm("woq_matmul_stacked", "woq_gemm", "tllm_woq_gemm",
                        woq._GEMM_SIGNATURES, x, q, s, 0, 1000, "int8", 0, 0,
                        (8, 0))
    # the wrapper routes such a K to the GEMV, which takes it
    w = WOQWeight(q, s)
    before = woq.woq_matmul_stacked.gemm_launches
    woq.woq_matmul_stacked(x, w, 0)
    torch.cuda.synchronize()
    assert woq.woq_matmul_stacked.gemm_launches == before


# rows 5 and 6 at prefill rows: the int8 tensor-core GEMM (csrc/w8a8_gemm.cu)
# at LLaMA-7B's projection shapes (fused qkv, wo, gate or up, down), exact
# against the plain version (int32 sums, the same f32 epilogue)
W8A8_GEMM_SHAPES = [(4096, 12288), (4096, 4096), (4096, 11008), (11008, 4096)]
W8A8_SCALES = ["token/channel", "token/tensor", "static/channel",
               "static/tensor"]


def _w8a8_operands(dev, g, m, k, n, n_layers, scales):
    x_q = torch.randint(-128, 128, (m, k), generator=g, device=dev,
                        dtype=torch.int8)
    w_q = torch.randint(-128, 128, (n_layers, k, n), generator=g, device=dev,
                        dtype=torch.int8)
    s_x = (torch.rand((m, 1), generator=g, device=dev) * 0.05 + 1e-3
           if scales.startswith("token") else torch.tensor(0.02, device=dev))
    s_w = torch.rand((n_layers, n if scales.endswith("channel") else 1),
                     generator=g, device=dev) * 1e-3 + 1e-4
    return x_q, w_q, s_x, s_w


@pytest.mark.parametrize("scales", W8A8_SCALES)
@pytest.mark.parametrize("kn", W8A8_GEMM_SHAPES)
@pytest.mark.parametrize("m", [17, 64, 923, 1024])
def test_w8a8_gemm_matches_plain_exactly(dev, m, kn, scales):
    k, n = kn
    g = torch.Generator(device=dev).manual_seed(m + k + n)
    x_q, w_q, s_x, s_w = _w8a8_operands(dev, g, m, k, n, 3, scales)
    fn = w8a8.w8a8_matmul_stacked
    for layer in (0, 2):
        before = (fn.launches, fn.gemm_launches)
        got = fn(x_q, w_q, s_x, s_w, layer)
        torch.cuda.synchronize()
        assert (fn.launches, fn.gemm_launches) == (before[0] + 1,
                                                   before[1] + 1)
        ref = w8a8.w8a8_matmul_stacked_plain(x_q, w_q, s_x, s_w, layer)
        assert torch.equal(got, ref), (got - ref).abs().max().item()


@pytest.mark.parametrize("scales", ["token/channel", "static/tensor"])
@pytest.mark.parametrize("kn", W8A8_GEMM_SHAPES + [(4096, 22016)])
@pytest.mark.parametrize("m", [17, 923])
def test_w8a8_gemm_2d_entry_matches_plain_exactly(dev, m, kn, scales):
    k, n = kn
    g = torch.Generator(device=dev).manual_seed(m * 3 + k + n)
    x_q, w_q, s_x, s_w = _w8a8_operands(dev, g, m, k, n, 1, scales)
    fn = w8a8.w8a8_matmul
    before = (fn.launches, fn.gemm_launches,
              w8a8.w8a8_matmul_stacked.launches)
    got = fn(x_q, w_q[0], s_x, s_w[0])
    torch.cuda.synchronize()
    assert (fn.launches, fn.gemm_launches,
            w8a8.w8a8_matmul_stacked.launches) == (before[0] + 1,
                                                   before[1] + 1, before[2])
    assert torch.equal(got, w8a8.w8a8_matmul_plain(x_q, w_q[0], s_x, s_w[0]))


@pytest.mark.parametrize("m,n", [(17, 4096), (64, 4096), (128, 4096),
                                 (64, 12288)])
def test_w8a8_gemm_split_k_is_exact(dev, m, n):
    """Few output tiles (M <= 128 at N = 4096) split K over whole tiles;
    the int32 partials add exactly."""
    k = 11008
    rows, ksplit, _ = w8a8.gemm_tiling(m, k, n,
                                       woq._sm_count(torch.device(dev)))
    if n == 4096:
        assert (rows, ksplit > 1) == (128, True)
    g = torch.Generator(device=dev).manual_seed(m + n)
    x_q, w_q, s_x, s_w = _w8a8_operands(dev, g, m, k, n, 2, "token/channel")
    got = w8a8.w8a8_matmul_stacked(x_q, w_q, s_x, s_w, 1)
    assert torch.equal(got, w8a8.w8a8_matmul_stacked_plain(x_q, w_q, s_x,
                                                           s_w, 1))


@pytest.mark.parametrize("value", [-128, -127])
@pytest.mark.parametrize("m", [17, 300])
def test_w8a8_gemm_sums_exactly_at_full_magnitude(dev, m, value):
    """|acc| = value^2 * 11008 ~ 1.8e8 > 2^24 in every output: int32 sums,
    converted once (-127: odd products, which an f32 sum would round)."""
    k, n = 11008, 256
    x_q = torch.full((m, k), value, dtype=torch.int8, device=dev)
    w_q = torch.full((1, k, n), value, dtype=torch.int8, device=dev)
    w_q[0, 0, 1] = 1                    # one column off the uniform sum
    got = w8a8.w8a8_matmul_stacked(x_q, w_q, torch.ones(1, device=dev),
                                   torch.ones((1, 1), device=dev), 0)
    want = torch.full((n,), float(np.float32(value * value * k)))
    want[1] = float(np.float32(value * value * (k - 1) + value))
    assert torch.equal(got.cpu(), want.expand(m, n))


def test_w8a8_route_keeps_decode_rows_on_dp4a(dev):
    g = torch.Generator(device=dev).manual_seed(7)
    floor = w8a8.W8A8_GEMM_MIN_ROWS
    x_q, w_q, s_x, s_w = _w8a8_operands(dev, g, floor, 4096, 4096, 1,
                                        "token/channel")
    fn = w8a8.w8a8_matmul_stacked
    for rows, gemm in ((1, 0), (floor - 1, 0), (floor, 1)):
        before = (fn.launches, fn.gemm_launches)
        got = fn(x_q[:rows], w_q, s_x[:rows], s_w, 0)
        torch.cuda.synchronize()
        assert (fn.launches, fn.gemm_launches) == (before[0] + 1,
                                                   before[1] + gemm)
        assert torch.equal(got, w8a8.w8a8_matmul_stacked_plain(
            x_q[:rows], w_q, s_x[:rows], s_w, 0))


def test_w8a8_gemm_refuses_a_k_it_cannot_take_before_launch(dev):
    x_q = torch.ones((64, 1000), dtype=torch.int8, device=dev)
    w_q = torch.ones((1, 1000, 128), dtype=torch.int8, device=dev)
    s_x, s_w = torch.ones((64, 1), device=dev), torch.ones((1, 128),
                                                           device=dev)
    with pytest.raises(ValueError, match="whole 128-column tiles"):
        w8a8.launch_gemm("w8a8_matmul_stacked", x_q, w_q, s_x, s_w, 0)
    # the wrapper routes such a K to the dp4a kernel, which takes it
    before = w8a8.w8a8_matmul_stacked.gemm_launches
    got = w8a8.w8a8_matmul_stacked(x_q, w_q, s_x, s_w, 0)
    torch.cuda.synchronize()
    assert w8a8.w8a8_matmul_stacked.gemm_launches == before
    assert torch.equal(got, torch.full((64, 128), 1000.0, device=dev))


# rows 2 and 4 at TC_MIN_ROWS-16 rows: the tensor-core GEMV
# (csrc/woq_gemv_tc.cuh), every format and option, bf16 and fp16; the
# products are exact as in the GEMM and the sums differ in order only, so
# the 2**-7 bound holds (fp16 too)
TC_FORMATS = ["int8", "int4 per-channel", "int4 g128", "fp8"]


def _tc_call(fmt, w, x, opt, g, dev):
    """(wrapper, plain version, kwargs) of one stacked call with `opt`."""
    k, n = w.k_dim, w.qweight.shape[-1]
    mod, fn = ((f8k, f8k.fp8_matmul_stacked) if fmt == "fp8"
               else (woq, woq.woq_matmul_stacked))
    m = x.numel() // x.shape[-1]
    kw = {"none": {}, "swiglu": {"swiglu": True},
          "norm": {"norm_w": (1 + 0.1 * torch.randn(
              (w.qweight.shape[0], k), generator=g, device=dev)).to(x.dtype)},
          "resid": {"resid": torch.randn((m, n), generator=g,
                                         device=dev).to(x.dtype)}}[opt]
    return fn, getattr(mod, fn.__name__ + "_plain"), kw


@pytest.mark.parametrize("opt", ["none", "norm", "resid", "swiglu"])
@pytest.mark.parametrize("m", list(range(2, 17)))
@pytest.mark.parametrize("fmt", TC_FORMATS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_tc_gemv_matches_plain(dev, dtype, fmt, m, opt):
    """Every row count the body takes, a ragged last column tile (N = 784)
    and K split over blocks and warps."""
    g = torch.Generator(device=dev).manual_seed(m + 31 * len(opt))
    w = _swiglu_weight(fmt, g, dev, n_layers=3, k=1152, n=784)
    k = w.k_dim
    x = torch.randn((m, 2 * k if opt == "swiglu" else k), generator=g,
                    device=dev).to(dtype)
    fn, plain, kw = _tc_call(fmt, w, x, opt, g, dev)
    before = (fn.launches, fn.tc_launches, fn.gemm_launches)
    got = fn(x, w, 2, **kw)
    torch.cuda.synchronize()
    tc = m >= woq.TC_MIN_ROWS
    assert (fn.launches, fn.tc_launches, fn.gemm_launches) == (
        before[0] + 1, before[1] + int(tc), before[2])
    _assert_close(got, plain(x, w, 2, **kw), dtype)


@pytest.mark.parametrize("fmt", ["int8", "int4 per-channel", "fp8"])
def test_tc_gemv_2d_lm_head_at_bs4(dev, fmt):
    """The 2-D entry at the lm_head's shape (4096 -> 32000) at bs4's 4 rows
    runs the body (its own counter), as paths 3 and 4 do."""
    g = torch.Generator(device=dev).manual_seed(41)
    w = _swiglu_weight(fmt, g, dev, n_layers=1, k=4096, n=32000)
    w2 = dataclasses.replace(w, qweight=w.qweight[0], scale=w.scale[0])
    x = torch.randn((4, 4096), generator=g, device=dev).to(torch.bfloat16)
    fn = f8k.fp8_matmul if fmt == "fp8" else woq.woq_matmul
    plain = f8k.fp8_matmul_plain if fmt == "fp8" else woq.woq_matmul_plain
    before = (fn.launches, fn.tc_launches)
    got = fn(x, w2)
    torch.cuda.synchronize()
    assert (fn.launches, fn.tc_launches) == (before[0] + 1, before[1] + 1)
    _assert_close(got, plain(x, w2), torch.bfloat16)


@pytest.mark.parametrize("m", [4, 9, 16])
@pytest.mark.parametrize("kn,fmt,block", [
    ((4544, 4672), "int8", 0),            # Falcon-7B's qkv: 284 steps
    ((4544, 4544), "int4 per-channel", 64),
    ((4544, 18176), "fp8", 0),            # logical order (4544 % 128)
    ((6144, 18432), "int8", 0),           # GPT-NeoX-20B's qkv
    ((6144, 6144), "int4 g128", 128),
    ((6144, 24576), "fp8", 128)])
def test_tc_gemv_at_the_families_widths(dev, m, kn, fmt, block):
    k, n = kn
    g = torch.Generator(device=dev).manual_seed(m + k + n)
    if fmt == "fp8":
        w = FP8Weight(random_fp8_codes((2, k, n), g, dev),
                      torch.rand((2, n), generator=g, device=dev) * 1e-3,
                      block)
    else:
        bits, gs = (8, 0) if fmt == "int8" else (4, 128 if "g128" in fmt
                                                  else 0)
        w = WOQWeight(torch.randint(-127, 128, (2, k // 2 if bits == 4 else k,
                                                n), generator=g, device=dev,
                                    dtype=torch.int8),
                      torch.rand((2, k // gs, n) if gs else (2, n),
                                 generator=g, device=dev) * 1e-3,
                      bits, gs, block)
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    for opt in ("norm", "resid"):
        fn, plain, kw = _tc_call(fmt, w, x, opt, g, dev)
        before = fn.tc_launches
        got = fn(x, w, 1, **kw)
        torch.cuda.synchronize()
        assert fn.tc_launches == before + 1
        _assert_close(got, plain(x, w, 1, **kw), torch.bfloat16)


def test_tc_gemv_route_keeps_f32_one_row_and_odd_k_off_it(dev):
    """f32 at any row count, a K of half steps and the rows below
    TC_MIN_ROWS go to the CUDA-core body, 17 rows to the GEMM: the counters
    say which ran, and every result equals the plain version."""
    g = torch.Generator(device=dev).manual_seed(43)
    w = _swiglu_weight("int8", g, dev, n_layers=2, k=1152, n=784)
    odd = WOQWeight(torch.randint(-127, 128, (2, 1000, 784), generator=g,
                                  device=dev, dtype=torch.int8),
                    torch.rand((2, 784), generator=g, device=dev) * 1e-3)
    fn = woq.woq_matmul_stacked
    cases = [(w, 9, torch.float32, (0, 0)), (odd, 9, torch.bfloat16, (0, 0)),
             (w, 17, torch.bfloat16, (0, 1)),
             (w, woq.TC_MIN_ROWS, torch.bfloat16, (1, 0))]
    if woq.TC_MIN_ROWS > 1:
        cases.append((w, woq.TC_MIN_ROWS - 1, torch.bfloat16, (0, 0)))
    for ww, m, dtype, (tc, gemm) in cases:
        x = torch.randn((m, ww.k_dim), generator=g, device=dev).to(dtype)
        before = (fn.tc_launches, fn.gemm_launches)
        got = fn(x, ww, 1)
        torch.cuda.synchronize()
        assert (fn.tc_launches - before[0], fn.gemm_launches - before[1]) == (
            tc, gemm), (m, dtype)
        _assert_close(got, woq.woq_matmul_stacked_plain(x, ww, 1), dtype)


def test_tc_gemv_on_two_streams(dev):
    """The body split over K (LLaMA-7B's wo and down shapes at 9 rows) on
    two streams at once: each stream sums its splits in a workspace of its
    own, so every output equals the plain version and each call adds one
    tensor-core launch."""
    g = torch.Generator(device=dev).manual_seed(47)
    cases = []
    for k, n in ((4096, 4096), (11008, 4096)):
        w = _swiglu_weight("int8", g, dev, n_layers=2, k=k, n=n)
        assert woq.tc_plan(9, k, n, da.sm_count(dev))[0] > 1
        x = torch.randn((9, k), generator=g, device=dev).to(torch.bfloat16)
        r = torch.randn((9, n), generator=g, device=dev).to(torch.bfloat16)
        cases.append((w, x, r, woq.woq_matmul_stacked_plain(x, w, 1,
                                                            resid=r)))
    streams = [torch.cuda.Stream(dev) for _ in cases]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream(dev))
    n_calls, before = 20, woq.woq_matmul_stacked.tc_launches
    outs = [[] for _ in cases]
    for _ in range(n_calls):
        for st, (w, x, r, _), got in zip(streams, cases, outs):
            with torch.cuda.stream(st):
                got.append(woq.woq_matmul_stacked(x, w, 1, resid=r))
    torch.cuda.synchronize()
    assert woq.woq_matmul_stacked.tc_launches == before + n_calls * len(cases)
    for (_, _, _, ref), got in zip(cases, outs):
        for out in got:
            _assert_close(out, ref, torch.bfloat16)


# rows 1-4 at one row (and f32 / the layouts the tensor-core bodies do not
# tile at every row count): the one-launch GEMV (csrc/woq_gemv.cuh on
# csrc/gemv_stream.cuh); rows 5-6 below W8A8_GEMM_MIN_ROWS: the one-launch
# dp4a GEMV (csrc/w8a8_matmul.cu). The same exact products as the plain
# versions, summed in another order (the dp4a sums are exact int32)
ONE_ROW_FORMATS = ["int8", "int4 per-channel", "int4 g128", "fp8"]
ONE_ROW_OPTIONS = ["none", "norm", "resid", "swiglu"]


def _one_row_counts(fn):
    return (fn.launches, fn.tc_launches, fn.gemm_launches)


@pytest.mark.parametrize("opt", ONE_ROW_OPTIONS)
@pytest.mark.parametrize("fmt", ONE_ROW_FORMATS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_one_row_gemv_matches_plain(dev, dtype, fmt, opt):
    """M = 1 in every format, option and dtype, a ragged last column tile
    (N = 784), K split over blocks: one launch of the one-row body."""
    g = torch.Generator(device=dev).manual_seed(len(fmt) + 7 * len(opt))
    w = _swiglu_weight(fmt, g, dev, n_layers=3, k=1152, n=784)
    k = w.k_dim
    x = torch.randn((1, 2 * k if opt == "swiglu" else k), generator=g,
                    device=dev).to(dtype)
    fn, plain, kw = _tc_call(fmt, w, x, opt, g, dev)
    before = _one_row_counts(fn)
    got = fn(x, w, 2, **kw)
    torch.cuda.synchronize()
    assert _one_row_counts(fn) == (before[0] + 1, before[1], before[2])
    _assert_close(got, plain(x, w, 2, **kw), dtype)


@pytest.mark.parametrize("m", list(range(1, 17)))
@pytest.mark.parametrize("case", ["f32 int8", "f32 int4 g128", "f32 fp8",
                                  "f32 int4 g96 b96", "bf16 int8 K=1000",
                                  "fp16 fp8 K=1000"])
def test_one_row_gemv_at_every_row_count_it_takes(dev, case, m):
    """The calls the route leaves to the body above one row: f32 in every
    format (int4 also with pack blocks and groups of 96 rows, which do
    not divide the 512-row passes of the body before this one), and K of
    half mma steps (K = 1000) in bf16 / fp16, at 1-16 rows (row tiles of
    1, 2 or 4), with the norm and the residual."""
    dt, fmt = case.split()[:2]
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16,
             "fp16": torch.float16}[dt]
    k = 1000 if "K=1000" in case else 1152
    g = torch.Generator(device=dev).manual_seed(m + k)
    if "b96" in case:
        q = torch.randint(-127, 128, (2, k // 2, 784), generator=g,
                          device=dev, dtype=torch.int8)
        s = torch.rand((2, k // 96, 784), generator=g, device=dev) * 1e-3
        w = WOQWeight(q, s, 4, 96, 96)
    else:
        w = _swiglu_weight("int4 g128" if fmt == "int4" else fmt, g, dev,
                           n_layers=2, k=k, n=784)
    x = torch.randn((m, k), generator=g, device=dev).to(dtype)
    for opt in ("norm", "resid"):
        fn, plain, kw = _tc_call(fmt, w, x, opt, g, dev)
        before = _one_row_counts(fn)
        got = fn(x, w, 1, **kw)
        torch.cuda.synchronize()
        assert _one_row_counts(fn) == (before[0] + 1, before[1], before[2])
        _assert_close(got, plain(x, w, 1, **kw), dtype)


# LLaMA-7B's four projections, the lm_head (2-D entry), the fused gate/up,
# Falcon-7B's qkv, GPT-NeoX-20B's qkv and Bloom's MLP
ONE_ROW_SHAPES = [(4096, 12288), (4096, 4096), (4096, 11008), (11008, 4096),
                  (4096, 22016), (4544, 4672), (6144, 18432), (4096, 16384)]


@pytest.mark.parametrize("fmt,kn", [
    (fmt, kn) for fmt in ONE_ROW_FORMATS for kn in ONE_ROW_SHAPES
    if not (fmt.startswith("int4") and kn[0] % 128)])  # 128-row pack blocks
def test_one_row_gemv_at_the_paths_shapes(dev, fmt, kn):
    """bf16 at one row with each option the paths use there, at the
    paths' and the families' widths."""
    k, n = kn
    g = torch.Generator(device=dev).manual_seed(k + n)
    w = _swiglu_weight(fmt, g, dev, n_layers=2, k=k, n=n)
    x = torch.randn((1, k), generator=g, device=dev).to(torch.bfloat16)
    for opt in ("none", "norm", "resid"):
        fn, plain, kw = _tc_call(fmt, w, x, opt, g, dev)
        before = _one_row_counts(fn)
        got = fn(x, w, 1, **kw)
        torch.cuda.synchronize()
        assert _one_row_counts(fn) == (before[0] + 1, before[1], before[2])
        _assert_close(got, plain(x, w, 1, **kw), torch.bfloat16)


@pytest.mark.parametrize("fmt", ["int8", "int4 per-channel", "fp8"])
def test_one_row_gemv_2d_lm_head(dev, fmt):
    """The 2-D entry at the lm_head's shape (4096 -> 32000) at one row, as
    paths 3 and 4 run it every decode step: its own counter."""
    g = torch.Generator(device=dev).manual_seed(53)
    w = _swiglu_weight(fmt, g, dev, n_layers=1, k=4096, n=32000)
    w2 = dataclasses.replace(w, qweight=w.qweight[0], scale=w.scale[0])
    x = torch.randn((1, 4096), generator=g, device=dev).to(torch.bfloat16)
    fn = f8k.fp8_matmul if fmt == "fp8" else woq.woq_matmul
    plain = f8k.fp8_matmul_plain if fmt == "fp8" else woq.woq_matmul_plain
    before = _one_row_counts(fn)
    got = fn(x, w2)
    torch.cuda.synchronize()
    assert _one_row_counts(fn) == (before[0] + 1, before[1], before[2])
    _assert_close(got, plain(x, w2), torch.bfloat16)


@pytest.mark.parametrize("fmt", ONE_ROW_FORMATS)
def test_one_row_gemv_is_bitwise_repeatable_on_two_streams(dev, fmt):
    """LLaMA-7B's wo (with the residual) and down shapes at one row, whose
    K is split over blocks: every call on either of two streams at once
    gives the first call's output bit for bit (the splits merge in split
    order, whatever order they finish in)."""
    g = torch.Generator(device=dev).manual_seed(59)
    cases = []
    for k, n in ((4096, 4096), (11008, 4096)):
        w = _swiglu_weight(fmt, g, dev, n_layers=2, k=k, n=n)
        x = torch.randn((1, k), generator=g, device=dev).to(torch.bfloat16)
        r = torch.randn((1, n), generator=g, device=dev).to(torch.bfloat16)
        fn, plain, _ = _tc_call(fmt, w, x, "none", g, dev)
        first = fn(x, w, 1, resid=r)
        torch.cuda.synchronize()
        _assert_close(first, plain(x, w, 1, resid=r), torch.bfloat16)
        cases.append((fn, w, x, r, first))
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream(dev))
    outs = []
    for _ in range(10):
        for st in streams:
            with torch.cuda.stream(st):
                for fn, w, x, r, _ in cases:
                    outs.append((fn(x, w, 1, resid=r), len(outs) % 2))
    torch.cuda.synchronize()
    for i, (out, _) in enumerate(outs):
        assert torch.equal(out, cases[i % len(cases)][4])


@pytest.mark.parametrize("fmt", ONE_ROW_FORMATS)
def test_one_row_gemv_allocates_only_its_output(dev, fmt):
    """A second call at a shape split over the card allocates nothing but
    its output (the splits meet in the stream's workspace, made at the
    first call)."""
    g = torch.Generator(device=dev).manual_seed(61)
    w = _swiglu_weight(fmt, g, dev, n_layers=2, k=4096, n=4096)
    x = torch.randn((1, 4096), generator=g, device=dev).to(torch.bfloat16)
    r = torch.randn((1, 4096), generator=g, device=dev).to(torch.bfloat16)
    unit = w.pack_block or 8 if fmt != "fp8" else w.interleave_block or 8
    assert woq.gemv_plan(1, 4096, 4096, da.sm_count(dev), unit).ksplit > 1
    fn = f8k.fp8_matmul_stacked if fmt == "fp8" else woq.woq_matmul_stacked
    fn(x, w, 1, resid=r)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    out = fn(x, w, 1, resid=r)
    torch.cuda.synchronize()
    out_bytes = -(-out.numel() * out.element_size() // 512) * 512
    assert torch.cuda.memory_allocated(dev) - before <= out_bytes


@pytest.mark.parametrize("scales", W8A8_SCALES)
@pytest.mark.parametrize("kn", W8A8_GEMM_SHAPES + [(4096, 22016)])
@pytest.mark.parametrize("m", [1, 2, 3, 4])
def test_dp4a_gemv_matches_plain_exactly(dev, m, kn, scales):
    """The dp4a GEMV at every row count it takes, LLaMA-7B's shapes, every
    scale kind: bit for bit, stacked and 2-D, one launch each, twice the
    same bits."""
    k, n = kn
    g = torch.Generator(device=dev).manual_seed(m + k + n)
    x_q, w_q, s_x, s_w = _w8a8_operands(dev, g, m, k, n, 2, scales)
    fn = w8a8.w8a8_matmul_stacked
    before = (fn.launches, fn.gemm_launches)
    got = fn(x_q, w_q, s_x, s_w, 1)
    again = fn(x_q, w_q, s_x, s_w, 1)
    torch.cuda.synchronize()
    assert (fn.launches, fn.gemm_launches) == (before[0] + 2, before[1])
    ref = w8a8.w8a8_matmul_stacked_plain(x_q, w_q, s_x, s_w, 1)
    assert torch.equal(got, ref) and torch.equal(again, ref)
    got2d = w8a8.w8a8_matmul(x_q, w_q[1], s_x, s_w[1])
    assert torch.equal(got2d, ref)


@pytest.mark.parametrize("value", [-128, -127])
@pytest.mark.parametrize("m", [1, 4])
def test_dp4a_gemv_sums_exactly_at_full_magnitude(dev, m, value):
    """|sum| up to 128 * 128 * K, K split over blocks: the int32 merge of
    the splits is exact (f32 would not be)."""
    k, n = 11008, 4096
    x_q = torch.full((m, k), value, dtype=torch.int8, device=dev)
    w_q = torch.full((1, k, n), value, dtype=torch.int8, device=dev)
    w_q[0, 0, 0] = 1
    ones = torch.ones((m, 1), device=dev)
    got = w8a8.w8a8_matmul_stacked(x_q, w_q, ones, torch.ones((1, n),
                                                                device=dev), 0)
    torch.cuda.synchronize()
    assert torch.equal(got, w8a8.w8a8_matmul_stacked_plain(
        x_q, w_q, ones, torch.ones((1, n), device=dev), 0))
