"""The prefill-row GEMM of kernels 1 and 6 (csrc/woq_gemm.cuh), on the CPU:
its routing rule, the logical-row maps its decode writes the tile by, and a
numpy model of its arithmetic order against the JAX package's Pallas
kernels in interpret mode.

The GEMM itself runs only on the card (tests/test_torch_cuda_kernels.py).
Here the model takes the kernel's steps: 128-row K tiles of stored codes,
each decoded into logical row order through `tile_rows`, an f32 sum of the
tile's products (bf16-exact activations times exact codes), a grouped
tile's partial times its scale before it joins the accumulator, the
per-channel scale after the sum. Both sides form exact products and
differ only in the order of the f32 sums: 1e-5 of the largest |output|.
The maps are checked exactly (a bijection that decodes the JAX package's
stored layouts to its own unpacked rows).
"""

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
T = woq.GEMM_TILE_K
BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32


# ---------------------------------------------------------------------------
# the routing rule
# ---------------------------------------------------------------------------

def test_gemm_takes_every_row_count_above_the_fused_ones():
    assert woq.GEMM_MIN_ROWS >= FUSE_MAX_ROWS + 1


@pytest.mark.parametrize("rows,dtype,prologue,residual,want", [
    (1, BF16, False, False, False),        # decode
    (16, BF16, False, False, False),       # bs1 prefill bucket
    (16, F16, True, True, False),          # fused decode shapes
    (17, BF16, False, False, True),
    (17, F16, False, False, True),
    (64, BF16, False, False, True),        # bs4 prefill
    (8192, BF16, False, False, True),      # the 8k prompt
    (64, F32, False, False, False),        # no exact f32 tensor-core product
    (8192, F32, False, False, False),
    (64, BF16, True, False, False),        # a prologue stays on the GEMV
    (64, BF16, False, True, False),        # and so does a residual
    (1024, F16, True, True, False),
])
def test_gemm_route_rows_dtype_options(rows, dtype, prologue, residual, want):
    assert woq.gemm_route(rows, dtype, prologue, residual, 4096) is want


@pytest.mark.parametrize("fmt,k,block,group,want", [
    ("int8", 4096, 0, 0, True),
    ("int8", 11008, 0, 0, True),           # LLaMA-7B down: 86 tiles
    ("int8", 4096, 0, 128, True),          # int8 g128
    ("int8", 1216, 0, 64, False),          # K ragged, group 64
    ("int8", 1000, 0, 0, False),           # not whole 16-row steps
    ("int8", 1600, 0, 0, True),            # GPT-2 XL: 12.5 tiles, ragged last
    ("int4 per-channel", 1600, 64, 0, True),
    ("int8", 1600, 0, 128, False),         # groups need whole tiles
    ("int4 per-channel", 4096, 128, 0, True),
    ("int4 per-channel", 4096, 64, 0, True),
    ("int4 g128", 4096, 128, 128, True),
    ("int4 g64", 4096, 64, 64, False),     # two groups a tile
    ("int4 g256", 4096, 256, 256, False),  # a block wider than a tile
    ("fp8", 4096, 128, 0, True),
    ("fp8 logical order", 4096, 0, 0, True),
    ("fp8", 4544, 0, 0, True),             # Falcon-7B's width: 35.5 tiles
])
def test_gemm_route_layouts(fmt, k, block, group, want):
    assert woq.gemm_takes(k, block, group) is want
    assert woq.gemm_route(1024, BF16, False, False, k, block, group) is want


def test_launch_gemm_refuses_before_launch():
    """The GEMM's launcher raises for what it does not take before it
    builds or touches anything (so here, without nvcc or a card)."""
    w = WOQWeight(torch.zeros((1, 1000, 32), dtype=torch.int8),
                  torch.ones((1, 32)))
    x = torch.ones((32, 1000), dtype=BF16)
    with pytest.raises(ValueError, match="whole 16-row steps"):
        woq.launch_gemm("t", "woq_gemm", "tllm_woq_gemm", {}, x, w.qweight,
                        w.scale, 0, 1000, "int8", 0, 0, (8, 0))
    with pytest.raises(TypeError):
        woq.launch_gemm("t", "woq_gemm", "tllm_woq_gemm", {},
                        x.float(), w.qweight, w.scale, 0, 1000, "int8", 0, 0,
                        (8, 0))


def test_cpu_calls_count_no_launch():
    w = WOQWeight(torch.zeros((1, 256, 32), dtype=torch.int8),
                  torch.ones((1, 32)))
    before = (woq.woq_matmul_stacked.launches,
              woq.woq_matmul_stacked.gemm_launches)
    woq.woq_matmul_stacked(torch.ones((64, 256), dtype=BF16), w, 0)
    assert (woq.woq_matmul_stacked.launches,
            woq.woq_matmul_stacked.gemm_launches) == before


# ---------------------------------------------------------------------------
# the logical-row maps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pb", [32, 64, 128])
def test_int4_tile_map_decodes_jax_packing(pb):
    rng = np.random.default_rng(pb)
    q = rng.integers(-8, 8, (2 * T, 48)).astype(np.int8)
    packed = np.asarray(jax_tensors.pack_int4(jnp.asarray(q), pb)).view(np.uint8)
    want = np.asarray(jax_tensors.unpack_int4(jnp.asarray(packed.view(np.int8)),
                                              pb))
    np.testing.assert_array_equal(want, q)
    rows = woq.tile_rows("int4", pb)
    assert sorted(rows) == list(range(T))              # a bijection
    for t in range(2):
        tile = packed[t * T // 2:(t + 1) * T // 2]
        slots = np.empty((T, 48), np.int8)
        slots[0::2] = (tile & 0xF).astype(np.int8) - 8
        slots[1::2] = (tile >> 4).astype(np.int8) - 8
        dec = np.empty_like(slots)
        dec[rows] = slots
        np.testing.assert_array_equal(dec, want[t * T:(t + 1) * T])


@pytest.mark.parametrize("ib", [0, 32, 64, 128])
def test_fp8_tile_map_decodes_jax_interleave(ib):
    rng = np.random.default_rng(ib)
    q = rng.integers(0, 256, (2 * T, 40)).astype(np.uint8)
    stored = (np.asarray(jax_tensors.interleave_fp8_rows(jnp.asarray(q), ib))
              if ib else q)
    if ib:
        np.testing.assert_array_equal(
            np.asarray(jax_tensors.deinterleave_fp8_rows(
                jnp.asarray(stored), ib)), q)
    rows = woq.tile_rows("fp8", ib)
    assert sorted(rows) == list(range(T))
    for t in range(2):
        dec = np.empty((T, 40), np.uint8)
        dec[rows] = stored[t * T:(t + 1) * T]
        np.testing.assert_array_equal(dec, q[t * T:(t + 1) * T])


def test_int8_tile_map_is_identity_and_unknown_format_raises():
    assert woq.tile_rows("int8") == list(range(T))
    with pytest.raises(ValueError):
        woq.tile_rows("int5")


# ---------------------------------------------------------------------------
# the arithmetic order, against the Pallas kernels
# ---------------------------------------------------------------------------

def gemm_model(x, stored, scale, fmt, block, group):
    """The GEMM's arithmetic in numpy: x f32 [M, K] (bf16 values), stored
    codes as the weight keeps them (int8 / uint8 e4m3 [K, N], packed int4
    [K/2, N]), scale [N] or [K/128, N]. Returns f32 [M, N]."""
    m, k = x.shape
    n = stored.shape[-1]
    rows = woq.tile_rows(fmt, block)
    acc = np.zeros((m, n), np.float32)
    if k % T:            # a ragged last tile: zero-filled past K on load
        pad = T - k % T
        x = np.pad(x, ((0, 0), (0, pad)))
        stored = np.pad(stored, ((0, pad // 2 if fmt == "int4" else pad),
                                 (0, 0)))
    for t in range(x.shape[1] // T):
        if fmt == "int4":
            tile = stored[t * T // 2:(t + 1) * T // 2].view(np.uint8)
            slots = np.empty((T, n), np.float32)
            slots[0::2] = (tile & 0xF).astype(np.float32) - 8
            slots[1::2] = (tile >> 4).astype(np.float32) - 8
        elif fmt == "fp8":
            slots = fp8_decode(torch.from_numpy(
                np.array(stored[t * T:(t + 1) * T]))).numpy()
        else:
            slots = stored[t * T:(t + 1) * T].astype(np.float32)
        b = np.empty((T, n), np.float32)
        b[rows] = slots                       # the decoded tile, logical order
        part = x[:, t * T:(t + 1) * T] @ b    # f32 sums of one tile
        acc = acc + part * scale[t] if group else acc + part
    return acc if group else acc * scale


def _bf16_x(rng, m, k):
    x = rng.standard_normal((m, k)).astype(np.float32)
    return torch.from_numpy(x).to(BF16).float().numpy()


def _assert_rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= MATMUL_REL * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("m", [17, 40])
@pytest.mark.parametrize("fmt", ["int8", "int4 per-channel", "int4 g128"])
def test_gemm_model_matches_jax_woq_kernel(fmt, m):
    rng = np.random.default_rng(m)
    k, n, layer = 2 * T, 128, 1
    w = (rng.standard_normal((2, k, n)) * 0.05).astype(np.float32)
    bits, group = (8, 0) if fmt == "int8" else (4, 128 if "g128" in fmt else 0)
    jw = jax_tensors.quantize_weight_only(jnp.asarray(w), bits, group)
    assert woq.gemm_takes(k, jw.pack_block, jw.group_size)
    x = _bf16_x(rng, m, k)
    want = jax_woq_matmul_stacked(jnp.asarray(x), jw, layer, interpret=True)
    got = gemm_model(x, np.asarray(jw.qweight)[layer],
                     np.asarray(jw.scale)[layer],
                     "int4" if bits == 4 else "int8", jw.pack_block, group)
    _assert_rel(got, want)
    # and the port's plain version, which the card holds the GEMM against
    tw = WOQWeight(torch.from_numpy(np.array(jw.qweight)),
                   torch.from_numpy(np.array(jw.scale)), bits, group,
                   jw.pack_block)
    _assert_rel(woq.woq_matmul_stacked_plain(torch.from_numpy(x), tw,
                                             layer).numpy(), want)


@pytest.mark.parametrize("fmt,bits", [("int8", 8), ("int4", 4)])
def test_gemm_model_ragged_k_matches_plain(fmt, bits):
    """K = 1.5 tiles (GPT-2 XL's 1600 is 12.5): the last tile zero-filled
    past K gives the plain version's product, and the same sums as on
    operands zero-padded to whole tiles."""
    from trtllm_llama_tpu_torch.quantization.tensors import (
        quantize_weight_only,
    )
    rng = np.random.default_rng(bits)
    k, n, m = T + T // 2, 64, 24
    assert woq.gemm_takes(k) and not woq.gemm_takes(k + 8)
    tw = quantize_weight_only(torch.from_numpy(
        (rng.standard_normal((1, k, n)) * 0.05).astype(np.float32)), bits)
    x = _bf16_x(rng, m, k)
    q, sc = tw.qweight[0].numpy(), tw.scale[0].numpy()
    got = gemm_model(x, q, sc, fmt, tw.pack_block, 0)
    _assert_rel(got, woq.woq_matmul_stacked_plain(torch.from_numpy(x), tw,
                                                  0).numpy())
    pad = T // 2
    padded = gemm_model(np.pad(x, ((0, 0), (0, pad))),
                        np.pad(q, ((0, pad // (2 if bits == 4 else 1)),
                                   (0, 0))), sc, fmt, tw.pack_block, 0)
    np.testing.assert_array_equal(got, padded)


@pytest.mark.parametrize("m", [17, 40])
def test_gemm_model_matches_jax_fp8_kernel(m):
    rng = np.random.default_rng(100 + m)
    k, n, layer = 2 * T, 128, 1
    w = rng.standard_normal((2, k, n)).astype(np.float32)
    jw = jax_tensors.quantize_fp8_weight(jnp.asarray(w))
    assert jw.interleave_block == 128
    x = _bf16_x(rng, m, k)
    want = jax_fp8_matmul_stacked(jnp.asarray(x), jw, layer, interpret=True)
    got = gemm_model(x, np.asarray(jw.qweight)[layer],
                     np.asarray(jw.scale)[layer], "fp8", jw.interleave_block,
                     0)
    _assert_rel(got, want)
    tw = FP8Weight(torch.from_numpy(np.array(jw.qweight)),
                   torch.from_numpy(np.array(jw.scale)), jw.interleave_block)
    _assert_rel(f8k.fp8_matmul_stacked_plain(torch.from_numpy(x), tw,
                                             layer).numpy(), want)
