"""Rows 5 and 6 at prefill rows (the int8 tensor-core GEMM of
csrc/w8a8_gemm.cu), on the CPU: the port's plain W8A8 versions against the
JAX package's Pallas kernels in interpret mode at prefill row counts, the
sums at full int8 magnitude, the routing rule, and the index map by which
the GEMM turns a raw [K, N] weight tile into its K-major swizzled tile.

The GEMM itself runs only on the card (tests/test_torch_cuda_kernels.py,
where it is held to its plain version bit for bit). Tolerance here: bit-
equal. Both sides sum the int8 products exactly in integers (int32 in the
Pallas kernel, float64 below 2**53 in the plain version), convert once to
f32 and scale (acc * s_x) * s_w in f32 in that order.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from trtllm_llama_tpu.ops.pallas.w8a8_matmul import (
    w8a8_matmul as jax_w8a8_matmul,
    w8a8_matmul_stacked as jax_w8a8_matmul_stacked,
)
from trtllm_llama_tpu_torch.ops.kernels import w8a8_matmul as w8a8

torch.set_num_threads(1)

N = 384
SCALES = ["token/channel", "token/tensor", "static/channel", "static/tensor"]
# prefill row counts (ragged against every tile) with their K
ROWS_K = [(17, 256), (33, 384), (130, 256), (923, 384)]


def _inputs(m, k, scales, n_layers=2, seed=0):
    rng = np.random.default_rng(seed + m + k)
    x_q = rng.integers(-128, 128, (m, k)).astype(np.int8)
    w_q = rng.integers(-128, 128, (n_layers, k, N)).astype(np.int8)
    s_x = ((rng.random((m, 1)) * 0.05 + 1e-3).astype(np.float32)
           if scales.startswith("token") else np.array([0.02], np.float32))
    s_w = (rng.random((n_layers, N if scales.endswith("channel") else 1))
           .astype(np.float32) * 1e-3 + 1e-4)
    return x_q, w_q, s_x, s_w


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("scales", SCALES)
@pytest.mark.parametrize("m,k", ROWS_K)
def test_stacked_plain_equals_pallas_kernel_at_prefill_rows(m, k, scales):
    x_q, w_q, s_x, s_w = _inputs(m, k, scales)
    want = jax_w8a8_matmul_stacked(jnp.asarray(x_q), jnp.asarray(w_q),
                                   jnp.asarray(s_x), jnp.asarray(s_w), 1,
                                   interpret=True)
    got = w8a8.w8a8_matmul_stacked(_t(x_q), _t(w_q), _t(s_x), _t(s_w), 1)
    assert got.dtype == torch.float32 and got.shape == (m, N)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("scales", SCALES)
@pytest.mark.parametrize("m,k", ROWS_K)
def test_2d_plain_equals_pallas_kernel_at_prefill_rows(m, k, scales):
    x_q, w_q, s_x, s_w = _inputs(m, k, scales, n_layers=1)
    want = jax_w8a8_matmul(jnp.asarray(x_q), jnp.asarray(w_q[0]),
                           jnp.asarray(s_x), jnp.asarray(s_w[0]),
                           interpret=True)
    got = w8a8.w8a8_matmul(_t(x_q), _t(w_q[0]), _t(s_x), _t(s_w[0]))
    assert got.dtype == torch.float32 and got.shape == (m, N)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), w8a8.w8a8_matmul_plain(_t(x_q), _t(w_q[0]), _t(s_x),
                                            _t(s_w[0])).numpy())


@pytest.mark.parametrize("value", [-128, -127])
def test_sums_are_exact_at_full_magnitude(value):
    """K = 11008 (LLaMA-7B's down projection), every code at `value`:
    |acc| = value^2 * K ~ 1.8e8 > 2^24. Column 1 has one code changed to 1,
    so its sum is value^2 (K - 1) + value. With -127 every product is odd,
    and an f32 running sum rounds (shown below), so only an exact integer
    sum converted once gives these outputs."""
    k, n, m = 11008, 128, 17
    x_q = np.full((m, k), value, np.int8)
    w_q = np.full((1, k, n), value, np.int8)
    w_q[0, 0, 1] = 1
    ones_x, ones_w = np.ones((1,), np.float32), np.ones((1, 1), np.float32)
    want = np.full((m, n), np.float32(value * value * k))
    want[:, 1] = np.float32(value * value * (k - 1) + value)
    got = w8a8.w8a8_matmul_stacked(_t(x_q), _t(w_q), _t(ones_x), _t(ones_w),
                                   0)
    np.testing.assert_array_equal(got.numpy(), want)
    jax_got = jax_w8a8_matmul_stacked(jnp.asarray(x_q), jnp.asarray(w_q),
                                      jnp.asarray(ones_x), jnp.asarray(ones_w),
                                      0, interpret=True)
    np.testing.assert_array_equal(np.asarray(jax_got), want)
    if value == -127:
        f32_running = np.add.accumulate(
            np.full(k, value * value, np.float32), dtype=np.float32)[-1]
        assert f32_running != want[0, 0]


@pytest.mark.parametrize("rows,k,n,want", [
    (1, 4096, 12288, False),          # bs1 decode
    (w8a8.W8A8_GEMM_MIN_ROWS - 1, 4096, 4096, False),
    (w8a8.W8A8_GEMM_MIN_ROWS, 4096, 4096, True),
    (16, 4096, 12288, True),          # a bs1 prefill's bucket
    (17, 4096, 12288, True),
    (1024, 11008, 4096, True),        # Task A's bucket, down (86 tiles)
    (1024, 4096, 22016, True),        # the fused gate/up
    (1024, 1000, 4096, False),        # K not in whole 128-column tiles
    (1024, 4096 + 64, 4096, False),
    (1024, 4096, 4104, False),        # N not a multiple of 16
])
def test_gemm_route(rows, k, n, want):
    assert w8a8.w8a8_gemm_route(rows, k, n) is want


@pytest.mark.parametrize("m", [923, 1024, 8192])
@pytest.mark.parametrize("k,n", [(4096, 12288), (4096, 4096), (4096, 11008),
                                 (4096, 22016), (11008, 4096)])
def test_prefill_rows_take_the_256_row_tile(m, k, n):
    """Task A's prompt and longer: fewer waves of 256-row blocks over an
    H100's 132 SMs, one K pass."""
    assert w8a8.gemm_tiling(m, k, n, 132) == (256, 1, k // 128)


@pytest.mark.parametrize("m", [5, 16, 64, 128])
def test_few_rows_take_the_128_row_tile_and_split_k(m):
    rows, ksplit, kt_per = w8a8.gemm_tiling(m, 11008, 4096, 132)
    assert rows == 128 and ksplit > 1
    assert (ksplit - 1) * kt_per < 86 <= ksplit * kt_per    # whole K tiles
    assert w8a8.gemm_tiling(m, 4096, 12288, 132) == (128, 1, 32)


def test_decode_rows_stay_on_dp4a():
    """bs1 and bs4 decode (1 and 4 rows) stay below the GEMM's floor."""
    assert w8a8.W8A8_GEMM_MIN_ROWS > 4


@pytest.mark.parametrize("entry", ["stacked", "2d"])
def test_cpu_tensors_take_the_plain_version(entry):
    """On CPU tensors neither kernel runs and no count moves, at any row
    count (the route applies to CUDA tensors only)."""
    x_q, w_q, s_x, s_w = _inputs(64, 256, "token/channel")
    fn = (w8a8.w8a8_matmul_stacked if entry == "stacked"
          else w8a8.w8a8_matmul)
    args = ((_t(x_q), _t(w_q), _t(s_x), _t(s_w), 1) if entry == "stacked"
            else (_t(x_q), _t(w_q[1]), _t(s_x), _t(s_w[1])))
    before = (fn.launches, fn.gemm_launches)
    got = fn(*args)
    assert (fn.launches, fn.gemm_launches) == before
    ref = w8a8.w8a8_matmul_stacked_plain(_t(x_q), _t(w_q), _t(s_x), _t(s_w),
                                         1)
    assert torch.equal(got, ref)


def test_transposed_tile_map_is_a_bijection_without_bank_conflicts():
    """The GEMM's transpose_tile, index for index: thread (warp kc, lane)
    reads K rows 16 kc .. 16 kc + 15 at columns 4 lane .. 4 lane + 3,
    rotates each row word right by rot = (lane / 2) % 4 bytes, and stores
    output word j (column 4 lane + (j + rot) % 4, K bytes 16 kc ..
    16 kc + 15) at row n, chunk kc ^ (n % 8) of the K-major [128 N][128 K]
    tile. Every (n, k) byte lands once, where wgmma's 128-byte swizzle
    reads it, and the 8 lanes of each 16-byte store phase hit 8 distinct
    bank groups."""
    t = 128
    raw = np.arange(t * t, dtype=np.int64).reshape(t, t)     # [k, n] ids
    out = np.full(t * t, -1, np.int64)
    for kc in range(8):
        for lane in range(32):
            rot = (lane >> 1) & 3
            for j in range(4):
                # word j holds byte j of each rotated row word: column
                # 4 lane + (j + rot) % 4, stored as that column's row n
                n = 4 * lane + ((j + rot) & 3)
                base = n * t + ((kc ^ (n & 7)) << 4)
                for b in range(16):
                    assert out[base + b] == -1
                    out[base + b] = raw[16 * kc + b,
                                        4 * lane + (j + rot) % 4]
    assert (out >= 0).all()
    # wgmma's view: byte k of row n sits at n*128 + ((k/16 ^ n%8) * 16) + k%16
    n_idx, k_idx = np.meshgrid(np.arange(t), np.arange(t), indexing="ij")
    addr = n_idx * t + (((k_idx >> 4) ^ (n_idx & 7)) << 4) + (k_idx & 15)
    np.testing.assert_array_equal(out[addr], raw.T)
    for kc in range(8):
        for j in range(4):
            for phase in range(4):
                banks = set()
                for lane in range(8 * phase, 8 * phase + 8):
                    n = 4 * lane + ((j + ((lane >> 1) & 3)) & 3)
                    banks.add((kc ^ (n & 7)))     # 16-byte bank group
                assert len(banks) == 8
