"""The `n_window` branch of rows 2, 4 and 6 (PERF.md) on the CPU: the plain
versions of `woq_matmul_stacked` (int8, int4 g128), `fp8_matmul_stacked`
and `w8a8_matmul_stacked` with a column window, against the JAX package's
Pallas kernels given the same window (interpret mode, as
`tests/test_sharded_kernels.py` runs them), and against the full call's
columns.

Tolerances: the weight-only and fp8 windows differ from Pallas only in
f32 summation order (products of f32 inputs and int8 / e4m3 weights are
exact): 1e-5 of the largest output, 1e-4 for grouped int4, whose group
sums are scaled and added in another order (as tests/test_torch_int4.py
allows). W8A8 sums exactly, so its window
equals the Pallas kernel's bit for bit. A window equals the full call's
columns bit for bit on every route.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trtllm_llama_tpu.ops.pallas.w8a8_matmul import (
    w8a8_matmul_stacked as jax_w8a8_matmul_stacked,
)
from trtllm_llama_tpu.ops.pallas.woq_matmul import (
    fp8_matmul_stacked as jax_fp8_matmul_stacked,
    woq_matmul_stacked as jax_woq_matmul_stacked,
)
from trtllm_llama_tpu.quantization import tensors as jax_tensors
from trtllm_llama_tpu_torch.convert.bridge import params_from_numpy
from trtllm_llama_tpu_torch.ops.kernels import fp8_matmul as f8k
from trtllm_llama_tpu_torch.ops.kernels import w8a8_matmul as w8a8
from trtllm_llama_tpu_torch.ops.kernels import woq_matmul as woq

torch.set_num_threads(1)

L, K, N, LAYER = 2, 256, 512, 1
REL = {"int8": 1e-5, "int4_g128": 1e-4, "fp8": 1e-5}
WINDOWS = [(0, 128), (128, 128), (256, 256), (384, 128), (0, 512)]


def _assert_rel(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _weight(fmt, seed=0):
    rng = np.random.default_rng(seed)
    w = jnp.asarray((rng.standard_normal((L, K, N)) * 0.05).astype(np.float32))
    jw = {"int8": lambda: jax_tensors.quantize_weight_only(w, 8, 0),
          "int4_g128": lambda: jax_tensors.quantize_weight_only(w, 4, 128),
          "fp8": lambda: jax_tensors.quantize_fp8_weight(w)}[fmt]()
    tw = params_from_numpy({"w": jax.tree_util.tree_map(np.asarray, jw)},
                           "cpu")["w"]
    return jw, tw


def _x(m, seed=1):
    return np.random.default_rng(seed + m).standard_normal((m, K)).astype(
        np.float32)


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("m", [3, 96])
@pytest.mark.parametrize("fmt", ["int8", "int4_g128", "fp8"])
def test_weight_only_window_matches_pallas_and_full_call(fmt, m, window):
    jw, tw = _weight(fmt)
    x = _x(m)
    jfn, tfn = ((jax_fp8_matmul_stacked, f8k.fp8_matmul_stacked)
                if fmt == "fp8" else
                (jax_woq_matmul_stacked, woq.woq_matmul_stacked))
    want = jfn(jnp.asarray(x), jw, LAYER, interpret=True, n_window=window)
    got = tfn(torch.from_numpy(x), tw, LAYER, n_window=window)
    assert got.dtype == torch.float32 and got.shape == (m, window[1])
    _assert_rel(got.numpy(), want, REL[fmt])
    full = tfn(torch.from_numpy(x), tw, LAYER)
    s, n = window
    assert torch.equal(got, full[:, s:s + n])


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("scales", ["channel", "tensor"])
@pytest.mark.parametrize("m", [3, 96])
def test_w8a8_window_equals_pallas_and_full_call(m, scales, window):
    rng = np.random.default_rng(m)
    x_q = rng.integers(-128, 128, (m, K)).astype(np.int8)
    w_q = rng.integers(-128, 128, (L, K, N)).astype(np.int8)
    s_x = (rng.random((m, 1)) * 0.05 + 1e-3).astype(np.float32)
    s_w = (rng.random((L, N if scales == "channel" else 1)).astype(np.float32)
           * 1e-3 + 1e-4)
    want = jax_w8a8_matmul_stacked(jnp.asarray(x_q), jnp.asarray(w_q),
                                   jnp.asarray(s_x), jnp.asarray(s_w), LAYER,
                                   interpret=True, n_window=window)
    t = [torch.from_numpy(a) for a in (x_q, w_q, s_x, s_w)]
    got = w8a8.w8a8_matmul_stacked(*t, LAYER, n_window=window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    full = w8a8.w8a8_matmul_stacked(*t, LAYER)
    s, n = window
    assert torch.equal(got, full[:, s:s + n])


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_window_refusals(fmt):
    """A window excludes the prologues and the residual, stays inside N and
    is whole 128 columns (JAX's caller makes no other)."""
    _, tw = _weight(fmt)
    fn = f8k.fp8_matmul_stacked if fmt == "fp8" else woq.woq_matmul_stacked
    x = torch.from_numpy(_x(2))
    nw = torch.ones((L, K))
    with pytest.raises(ValueError, match="prologue"):
        fn(x, tw, LAYER, norm_w=nw, n_window=(0, 128))
    with pytest.raises(ValueError, match="prologue"):
        fn(x, tw, LAYER, resid=torch.zeros((2, N)), n_window=(0, 128))
    with pytest.raises(ValueError, match="prologue"):
        fn(torch.cat([x, x], -1), tw, LAYER, swiglu=True, n_window=(0, 128))
    with pytest.raises(ValueError, match="outside"):
        fn(x, tw, LAYER, n_window=(384, 256))
    with pytest.raises(ValueError, match="outside"):
        fn(x, tw, LAYER, n_window=(-128, 128))
    with pytest.raises(ValueError, match="whole 128"):
        fn(x, tw, LAYER, n_window=(64, 128))
    w_q = torch.zeros((L, K, N), dtype=torch.int8)
    with pytest.raises(ValueError, match="outside"):
        w8a8.w8a8_matmul_stacked(torch.zeros((2, K), dtype=torch.int8), w_q,
                                 torch.ones((2, 1)), torch.ones((L, N)),
                                 LAYER, n_window=(512, 128))


def test_windows_count_nothing_on_the_cpu():
    """The plain versions run for CPU tensors; the window launch counters
    move only where a kernel launches."""
    _, tw = _weight("int8")
    before = woq.woq_matmul_stacked.window_launches
    woq.woq_matmul_stacked(torch.from_numpy(_x(2)), tw, LAYER,
                           n_window=(0, 128))
    assert woq.woq_matmul_stacked.window_launches == before
    assert f8k.fp8_matmul_stacked.window_launches >= 0
    assert w8a8.w8a8_matmul_stacked.window_launches >= 0
