"""The tensor-core GEMV of kernels 1 and 6 (csrc/woq_gemv_tc.cuh), on the
CPU: its routing rule, its split of K, its output-column map, its
launcher's refusals, and a numpy model of its arithmetic against the JAX
package's Pallas kernels in interpret mode.

The body itself runs only on the card (tests/test_torch_cuda_kernels.py).
Here the model takes the kernel's steps: x staged in the weight's STORED
K order (int4: slot 2 sp + nibble of stored row sp; fp8: the interleaved
rows), 16-slot mma steps of exact products summed in f32, each warp's
contiguous share of its split's steps (whole groups when grouped), a
group's sums scaled at its last step (at 9-16 rows each step's products
as they come), the four warps summed in order, the
splits summed in split order, then the per-channel scale and the residual
in the compute dtype, each output at the column `tc_column_map` gives it.
Both sides form exact products (bf16 activations times exact codes) and
differ only in the order of the f32 sums: 1e-5 of the largest |output|.
Where a bf16 rounding follows the sums or the prologue, the inputs keep
it unambiguous: the residual case sums integers times powers of two
(exact in any order); the norm case takes x = +-1 (its rsqrt rounds
away within half a bf16 step); the SwiGLU case gates by g in [16, 64)
(silu(g) rounds to g) and takes up = +-2^j (g * up is exact in bf16:
interpret mode leaves that product, like the residual add, in f32).
"""

import math

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from trtllm_llama_tpu.ops.pallas.woq_matmul import (
    fp8_matmul_stacked as jax_fp8_matmul_stacked,
    woq_matmul_stacked as jax_woq_matmul_stacked,
)
from trtllm_llama_tpu.quantization import tensors as jax_tensors
from trtllm_llama_tpu_torch.ops.fp8 import fp8_decode
from trtllm_llama_tpu_torch.ops.kernels import fp8_matmul as f8k
from trtllm_llama_tpu_torch.ops.kernels import woq_matmul as woq
from trtllm_llama_tpu_torch.ops.linear import FUSE_MAX_ROWS
from trtllm_llama_tpu_torch.quantization.tensors import FP8Weight, WOQWeight

torch.set_num_threads(1)

MATMUL_REL = 1e-5
BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32
SMS = 132                  # the H100's SMs: the split the card would take
LAYER = 1

# (w_bits, group, pack / interleave block, K) of each format's model case:
# K gives every format a split of K over blocks (a group a warp when
# grouped), N = 400 a ragged last column tile
FORMATS = {"int8": (8, 0, 0, 512), "int4 per-channel": (4, 0, 128, 512),
           "int4 g128": (4, 128, 128, 1024), "fp8": (8, 0, 128, 512)}
N = 400


# ---------------------------------------------------------------------------
# the routing rule
# ---------------------------------------------------------------------------

def test_tc_takes_the_rows_the_paths_fuse():
    assert woq.TC_MAX_ROWS == FUSE_MAX_ROWS == woq.GEMM_MIN_ROWS - 1
    assert 1 <= woq.TC_MIN_ROWS <= 16


@pytest.mark.parametrize("rows", [1, 2, 4, 8, 9, 16, 17, 64])
@pytest.mark.parametrize("dtype", [BF16, F16, F32])
def test_tc_route_rows_dtype(rows, dtype):
    """bf16 / fp16 from TC_MIN_ROWS to 16 rows, never f32, never 17 rows
    (which go to the GEMM without options)."""
    want = dtype != F32 and woq.TC_MIN_ROWS <= rows <= 16
    assert woq.tc_route(rows, dtype, 4096) is want
    if rows >= woq.GEMM_MIN_ROWS and dtype != F32:
        assert woq.gemm_route(rows, dtype, False, False, 4096)


@pytest.mark.parametrize("prologue,residual", [(False, False), (True, False),
                                               (False, True), (True, True)])
@pytest.mark.parametrize("rows", [1, 4, 9, 16])
def test_tc_takes_every_option_below_the_gemm(rows, prologue, residual):
    """No call of at most 16 rows reaches the GEMM, whatever its options;
    the tensor-core GEMV takes it by dtype and layout alone."""
    assert not woq.gemm_route(rows, BF16, prologue, residual, 4096)
    assert woq.tc_route(rows, BF16, 4096) is (rows >= woq.TC_MIN_ROWS)


@pytest.mark.parametrize("k,block,group,want", [
    (4096, 0, 0, True),            # LLaMA-7B int8 / fp8 (logical order)
    (11008, 0, 0, True),           # LLaMA-7B down
    (4096, 128, 128, True),        # int4 g128
    (4096, 128, 0, True),          # int4 per-channel, fp8 interleaved
    (4544, 64, 0, True),           # Falcon-7B: int4 pack block 64
    (4544, 0, 0, True),            # Falcon-7B int8
    (6144, 0, 0, True),            # GPT-NeoX-20B
    (800, 32, 32, True),           # int4 g32: two steps a group
    (1216, 0, 64, True),           # int8 g64
    (1000, 0, 0, False),           # K not whole steps: the CUDA cores
    (1000, 8, 8, False),           # groups of half a step
    (4096, 0, 8, False),
])
def test_tc_route_layouts(k, block, group, want):
    assert woq.tc_takes(k, block, group) is want
    assert woq.tc_route(4, BF16, k, block, group) is (
        want and woq.TC_MIN_ROWS <= 4)


# ---------------------------------------------------------------------------
# the split of K and the output-column map
# ---------------------------------------------------------------------------

# (M, K, N, w_bits, block, group): the paths' projections at 1-16 rows
# (LLaMA-7B's four and gate_up fused, the lm_heads, Falcon-7B, GPT-NeoX)
PLAN_SHAPES = [(1, 4096, 12288, 8, 0, 0), (4, 4096, 4096, 8, 0, 0),
               (9, 4096, 11008, 8, 0, 0), (9, 11008, 4096, 8, 0, 0),
               (16, 4096, 22016, 8, 0, 0), (4, 4096, 32000, 4, 128, 0),
               (4, 4096, 32000, 8, 128, 0), (4, 4096, 12288, 4, 128, 128),
               (16, 11008, 4096, 4, 128, 128), (1, 11008, 4096, 8, 128, 0),
               (4, 4544, 4672, 4, 64, 0), (16, 6144, 18432, 8, 0, 0),
               (2, 1216, 784, 8, 0, 64), (5, 800, 784, 4, 32, 32)]


@pytest.mark.parametrize("m,k,n,w_bits,block,group", PLAN_SHAPES)
def test_tc_plan_splits_k_in_whole_blocks(m, k, n, w_bits, block, group):
    """Every split but the last holds sps steps, none is empty, each is
    whole pack / interleave blocks and groups, each warp of a full split
    has a step (a group when grouped) where K allows, the x panel fits
    shared memory, and nt / mt follow the row count and the layout."""
    ksplit, sps, mt, nt = woq.tc_plan(m, k, n, SMS, w_bits, block, group)
    steps = k // woq.TC_STEP
    assert mt == (8 if m <= 8 else 16)
    assert nt == (8 if group and w_bits == 8 else 16)
    assert ksplit >= 1 and ksplit * sps >= steps > (ksplit - 1) * sps
    unit = math.lcm(16, block or 16, group or 16) // 16
    assert sps % unit == 0
    warp_unit = group // 16 if group else 1
    if steps >= woq.TC_WARPS * warp_unit:
        assert sps >= woq.TC_WARPS * warp_unit
    # the panel (plus 64 KB of codes in flight) leaves room for two blocks
    assert mt * (sps * 16 + 8) * 2 <= woq.TC_PANEL_BYTES + unit * 16 * mt * 2
    # one wave: no more blocks than reside (unless the panel forces splits)
    tiles = -(-n // (16 * nt))
    assert tiles * ksplit <= max(
        tiles, woq.TC_BLOCKS_PER_SM[mt, bool(group)] * SMS) or (
        ksplit == -(-steps * 16 * mt * 2 // woq.TC_PANEL_BYTES))


@pytest.mark.parametrize("nt", [8, 16])
@pytest.mark.parametrize("n", [12288, 4096, 11008, 22016, 32000, 4672, 4544,
                               18176, 18432, 6144, 24576, 16384, 400, 784])
def test_tc_column_map_is_a_bijection(n, nt):
    """Every output column of the paths' N (LLaMA-7B, the lm_head, Falcon,
    GPT-NeoX, Bloom) is written by exactly one (tile, j, r), and thread g's
    two chunks are nt contiguous columns (slot j of tile j)."""
    cmap = woq.tc_column_map(n, nt)
    cols = [c for tile in cmap for row in tile for c in row if c is not None]
    assert sorted(cols) == list(range(n))
    for t, tile in enumerate(cmap):
        for r in range(16):
            chunk = [tile[j][r] for j in range(nt)]
            base = 16 * nt * t + nt * r
            assert chunk == [c if c < n else None
                             for c in range(base, base + nt)]


# ---------------------------------------------------------------------------
# the launcher and the counters
# ---------------------------------------------------------------------------

def test_launch_tc_refuses_before_launch():
    """The launcher raises for what the body does not take before it
    builds or touches anything (so here, without nvcc or a card)."""
    q = torch.zeros((1, 1000, 32), dtype=torch.int8)
    s = torch.ones((1, 32))
    with pytest.raises(ValueError, match="whole 16-row steps"):
        woq.launch_tc("t", "woq_matmul", "tllm_woq_gemv_tc", {},
                      torch.ones((4, 1000), dtype=BF16), q, s, 0, 1000,
                      (8, 0, 0), 8, 0, 0)
    q = torch.zeros((1, 1024, 32), dtype=torch.int8)
    with pytest.raises(TypeError, match="bf16 or fp16"):
        woq.launch_tc("t", "woq_matmul", "tllm_woq_gemv_tc", {},
                      torch.ones((4, 1024)), q, s, 0, 1024, (8, 0, 0), 8, 0,
                      0)
    with pytest.raises(ValueError, match="1-16 rows"):
        woq.launch_tc("t", "woq_matmul", "tllm_woq_gemv_tc", {},
                      torch.ones((17, 1024), dtype=BF16), q, s, 0, 1024,
                      (8, 0, 0), 8, 0, 0)
    with pytest.raises(ValueError, match="mutually exclusive"):
        woq.launch_tc("t", "woq_matmul", "tllm_woq_gemv_tc", {},
                      torch.ones((4, 2048), dtype=BF16), q, s, 0, 1024,
                      (8, 0, 0), 8, 0, 0,
                      norm_w=torch.ones((1, 1024), dtype=BF16), swiglu=True)


@pytest.mark.parametrize("entry", ["woq_matmul_stacked", "woq_matmul",
                                   "fp8_matmul_stacked", "fp8_matmul"])
def test_cpu_calls_count_no_tc_launch(entry):
    k, n = 256, 32
    if entry.startswith("fp8"):
        w = FP8Weight(torch.zeros((1, k, n), dtype=torch.uint8),
                      torch.ones((1, n)))
        fn = getattr(f8k, entry)
    else:
        w = WOQWeight(torch.zeros((1, k, n), dtype=torch.int8),
                      torch.ones((1, n)))
        fn = getattr(woq, entry)
    args = ((w, 0) if entry.endswith("stacked")
            else (type(w)(w.qweight[0], w.scale[0]),))
    before = (fn.launches, fn.tc_launches, fn.gemm_launches)
    out = fn(torch.ones((4, k), dtype=BF16), *args)
    assert out.shape == (4, n)
    assert (fn.launches, fn.tc_launches, fn.gemm_launches) == before


# ---------------------------------------------------------------------------
# the arithmetic order, against the Pallas kernels
# ---------------------------------------------------------------------------

def slot_rows(fmt, k, block):
    """The logical K row of each stored slot (the inverse of the kernel's
    slot_of): int4 slot 2 sp + nibble of stored row sp in pack_int4's
    quartered layout; fp8 the rows of interleave_fp8_rows; int8 and fp8
    in logical order: the identity."""
    rows = []
    for s in range(k):
        if fmt.startswith("int4"):
            sp, nibble = divmod(s, 2)
            b, sl = divmod(sp, block // 2)
            rows.append(b * block + (2 * nibble + (sl & 1)) * (block // 4)
                        + (sl >> 1))
        elif fmt == "fp8" and block:
            b, j = divmod(s, block)
            rows.append(b * block + (j & 1) * (block // 2) + (j >> 1))
        else:
            rows.append(s)
    return rows


def slot_codes(fmt, stored):
    """The stored codes of one layer decoded in slot order, f32 [K, N]."""
    if fmt.startswith("int4"):
        u = stored.view(np.uint8)
        out = np.empty((2 * u.shape[0], u.shape[1]), np.float32)
        out[0::2] = (u & 0xF).astype(np.float32) - 8
        out[1::2] = (u >> 4).astype(np.float32) - 8
        return out
    if fmt == "fp8":
        return fp8_decode(torch.from_numpy(np.array(stored))).numpy()
    return stored.astype(np.float32)


def tc_model(h, stored, scale, fmt, w_bits, block, group, resid=None):
    """The tensor-core GEMV's arithmetic in numpy: h f32 [M, K] (the
    prologue's output, bf16 values, logical order), the stored codes and
    scale [N] or [K/g, N] of one layer, resid bf16 [M, N] or None.
    Returns f32 [M, N]."""
    m, k = h.shape
    n = stored.shape[-1]
    ksplit, sps, mt, nt = woq.tc_plan(m, k, n, SMS, w_bits, block, group)
    xs = h[:, slot_rows(fmt, k, block)]             # x in stored order
    wq = slot_codes(fmt, stored)
    steps, wu = k // 16, (group // 16 if group else 1)
    total = None
    for split in range(ksplit):
        sb, se = split * sps, min(steps, (split + 1) * sps)
        per, rem = divmod((se - sb) // wu, woq.TC_WARPS)
        block_sum = None
        for w in range(woq.TC_WARPS):
            ws = sb + wu * (w * per + min(w, rem))
            we = ws + wu * (per + (w < rem))
            acc = np.zeros((m, n), np.float32)
            gacc = np.zeros((m, n), np.float32)
            for st in range(ws, we):
                part = xs[:, 16 * st:16 * st + 16] @ wq[16 * st:16 * st + 16]
                if group and mt == 16:     # each step's products scaled
                    acc = acc + part * scale[st * 16 // group]
                elif group:
                    gacc = gacc + part
                    if (st + 1) % wu == 0:
                        acc = acc + gacc * scale[st * 16 // group]
                        gacc = np.zeros_like(gacc)
                else:
                    acc = acc + part
            block_sum = acc if block_sum is None else block_sum + acc
        total = block_sum if total is None else total + block_sum
    if not group:
        total = total * scale
    # each output lands at the column the map gives its (tile, j, r)
    out = np.full((m, n), np.nan, np.float32)
    for t, tile in enumerate(woq.tc_column_map(n, nt)):
        for j in range(nt):
            for r in range(16):
                c = tile[j][r]
                if c is not None:
                    out[:, c] = total[:, c]
    if resid is not None:
        acc_t = torch.from_numpy(out).to(BF16)
        out = (resid + acc_t).float().numpy()
    return out


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF16)


def _weight(fmt, rng, exact):
    """A stacked 2-layer weight of `fmt` from raw codes, for the JAX and
    the port's containers alike. exact: integer-valued codes (e4m3: values
    1-15 in steps of 1/8) and power-of-two scales, so that any order of
    the f32 sums is exact."""
    w_bits, group, block, k = FORMATS[fmt]
    if exact:
        scale = 2.0 ** -rng.integers(6, 11, (2, k // group if group else 1,
                                             N)).astype(np.float32)
        scale = scale if group else scale[:, 0]
    else:
        scale = (0.5 + rng.random((2, k // group, N) if group else (2, N))
                 ).astype(np.float32) / 64
    if fmt == "fp8":
        if exact:
            e = rng.integers(7, 11, (2, k, N))
        else:
            e = rng.integers(1, 15, (2, k, N))
        codes = ((rng.integers(0, 2, (2, k, N)) << 7) | (e << 3)
                 | rng.integers(0, 8, (2, k, N))).astype(np.uint8)
        codes = np.asarray(jax_tensors.interleave_fp8_rows(
            jnp.asarray(codes), block))
        jw = jax_tensors.FP8Weight(jnp.asarray(codes), jnp.asarray(scale),
                                   block)
        tw = FP8Weight(torch.from_numpy(codes.copy()),
                       torch.from_numpy(scale.copy()), block)
        return jw, tw, codes[LAYER], scale[LAYER]
    lim = 8 if w_bits == 4 else 128
    q = rng.integers(-lim, lim, (2, k, N)).astype(np.int8)
    if w_bits == 4:
        q = np.asarray(jax_tensors.pack_int4(jnp.asarray(q), block))
    jw = jax_tensors.WOQWeight(jnp.asarray(q), jnp.asarray(scale), w_bits,
                               group, block)
    tw = WOQWeight(torch.from_numpy(q.copy()), torch.from_numpy(scale.copy()),
                   w_bits, group, block)
    return jw, tw, q[LAYER], scale[LAYER]


@pytest.mark.parametrize("opt", ["none", "norm", "resid", "swiglu"])
@pytest.mark.parametrize("m", [2, 5, 9, 16])
@pytest.mark.parametrize("fmt", list(FORMATS))
def test_tc_model_matches_jax_kernels(fmt, m, opt):
    w_bits, group, block, k = FORMATS[fmt]
    rng = np.random.default_rng(1000 * m + len(fmt) + len(opt))
    jw, tw, stored, scale = _weight(fmt, rng, exact=opt == "resid")
    if opt == "norm":
        x = np.where(rng.random((m, k)) < 0.5, -1.0, 1.0).astype(np.float32)
    elif opt == "swiglu":
        g = _bf16(16 + 48 * rng.random((m, k))).float().numpy()
        u = (np.where(rng.random((m, k)) < 0.5, -1.0, 1.0)
             * 2.0 ** rng.integers(-3, 4, (m, k))).astype(np.float32)
        x = np.concatenate([g, u], axis=1)
    elif opt == "resid":
        x = rng.integers(-4, 5, (m, k)).astype(np.float32)
    else:
        x = _bf16(rng.standard_normal((m, k))).float().numpy()
    nw = _bf16(1 + 0.1 * rng.standard_normal((2, k)))
    resid = _bf16(rng.standard_normal((m, N)))
    kw_t = {"none": {}, "norm": {"norm_w": nw}, "resid": {"resid": resid},
            "swiglu": {"swiglu": True}}[opt]
    kw_j = {key: (jnp.asarray(v.float().numpy(), jnp.bfloat16)
                  if isinstance(v, torch.Tensor) else v)
            for key, v in kw_t.items()}
    xb = jnp.asarray(x, jnp.bfloat16)
    jax_fn = jax_fp8_matmul_stacked if fmt == "fp8" else jax_woq_matmul_stacked
    want = np.asarray(jax_fn(xb, jw, LAYER, interpret=True, **kw_j),
                      np.float32)
    if opt == "resid":
        # interpret mode leaves resid + T(acc) in f32; the contract (and
        # the unfused bf16 add) rounds it to T
        want = _bf16(want).float().numpy()
    # the model's input: the prologue's bf16 output (ops/kernels' own)
    h = woq.prologue(_bf16(x), kw_t.get("norm_w"), LAYER, 1e-6,
                     opt == "swiglu").float().numpy()
    got = tc_model(h, stored, scale, fmt, w_bits, block, group,
                   resid if opt == "resid" else None)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= MATMUL_REL * np.abs(want).max(), (err, np.abs(want).max())
    if opt == "resid":          # integer sums: exact in any order
        np.testing.assert_array_equal(got, want)
