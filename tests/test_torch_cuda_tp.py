"""Tensor parallelism's kernel branch and ranks on the card.

Marked `cuda`; every test skips without a CUDA device. On a machine with
one (which need not have JAX), run:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_tp.py

- `n_window` on every route of rows 2, 4 and 6 (the one-row GEMV at 1
  row, the tensor-core GEMV at 8, the `wgmma` GEMM at 96; W8A8's dp4a
  kernel at 2 and its GEMM at 96): each window equals the full call's
  columns bit for bit, and the plain version's window within two bf16
  ulps of the largest output (the kernels and the plain versions sum in
  f32 in different orders; W8A8 is exact); a window off the route's column
  tiles raises before launch.
- two gloo ranks on the one card (`parallel/launch.py`): gloo's CUDA
  all-reduce (SUM, async, and MAX), a tiny bf16 int8 model's tp = 2
  prefill logits within 3% of the single device's largest (bf16 sums
  split over two ranks round apart) and both ranks' tokens identical.
"""

import os

import numpy as np
import pytest
import torch

from trtllm_llama_tpu_torch.ops.kernels import fp8_matmul as f8k
from trtllm_llama_tpu_torch.ops.kernels import w8a8_matmul as w8a8
from trtllm_llama_tpu_torch.ops.kernels import woq_matmul as woq
from trtllm_llama_tpu_torch.parallel import launch
from trtllm_llama_tpu_torch.quantization.quantize import random_fp8_codes
from trtllm_llama_tpu_torch.quantization.tensors import FP8Weight, WOQWeight

pytestmark = pytest.mark.cuda

K, N = 512, 1024
WINDOWS = [(0, 256), (256, 256), (512, 512), (768, 256), (0, 1024)]
ROUTES = {"gemv": 1, "tc": 8, "gemm": 96}
BF16_TOL = 2.0 ** -7
TESTS = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _weight(fmt, g):
    def scale(shape, qmax):
        return (0.5 + torch.rand(shape, generator=g, device="cuda")) * (
            K ** -0.5 / qmax)
    if fmt == "fp8":
        return FP8Weight(random_fp8_codes((2, K, N), g, "cuda"),
                         scale((2, N), 448.0), 128)
    bits = 8 if fmt == "int8" else 4
    gs = 128 if fmt == "int4_g128" else 0
    q = torch.randint(-127, 128, (2, K // 2 if bits == 4 else K, N),
                      generator=g, device="cuda", dtype=torch.int8)
    return WOQWeight(q, scale((2, K // gs, N) if gs else (2, N), 127.0),
                     bits, gs, 128 if bits == 4 else 0)


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("fmt", ["int8", "int4_g128", "fp8"])
def test_windows_equal_the_full_call(dev, fmt, route):
    g = torch.Generator(device="cuda").manual_seed(3)
    w = _weight(fmt, g)
    fn, plain = ((f8k.fp8_matmul_stacked, f8k.fp8_matmul_stacked_plain)
                 if fmt == "fp8" else
                 (woq.woq_matmul_stacked, woq.woq_matmul_stacked_plain))
    m = ROUTES[route]
    x = torch.randn((m, K), generator=g, device="cuda").to(torch.bfloat16)
    full = fn(x, w, 1)
    counter = {"gemm": "gemm_launches", "tc": "tc_launches"}.get(route)
    before = (fn.window_launches, getattr(fn, counter) if counter else 0)
    for s, n in WINDOWS:
        got = fn(x, w, 1, n_window=(s, n))
        torch.cuda.synchronize()
        assert got.shape == (m, n)
        assert torch.equal(got, full[:, s:s + n]), (s, n)
        ref = plain(x, w, 1, n_window=(s, n))
        err = (got - ref).abs().max().item()
        assert err <= BF16_TOL * ref.abs().max().item(), (s, n, err)
    assert fn.window_launches - before[0] == len(WINDOWS)
    if counter:
        assert getattr(fn, counter) - before[1] == len(WINDOWS)


@pytest.mark.parametrize("m", [2, 96])
def test_w8a8_windows_are_exact(dev, m):
    g = torch.Generator(device="cuda").manual_seed(4)
    x_q = torch.randint(-127, 128, (m, K), generator=g, device="cuda",
                        dtype=torch.int8)
    w_q = torch.randint(-127, 128, (2, K, N), generator=g, device="cuda",
                        dtype=torch.int8)
    s_x = torch.rand((m, 1), generator=g, device="cuda") * 1e-2 + 1e-3
    for s_w in (torch.rand((2, N), generator=g, device="cuda") * 1e-3,
                torch.full((2, 1), 2e-4, device="cuda")):
        full = w8a8.w8a8_matmul_stacked(x_q, w_q, s_x, s_w, 1)
        for s, n in WINDOWS:
            got = w8a8.w8a8_matmul_stacked(x_q, w_q, s_x, s_w, 1,
                                           n_window=(s, n))
            assert torch.equal(got, full[:, s:s + n])
            assert torch.equal(got, w8a8.w8a8_matmul_stacked_plain(
                x_q, w_q, s_x, s_w, 1, n_window=(s, n)))


def test_tc_window_off_its_tiles_raises(dev):
    g = torch.Generator(device="cuda").manual_seed(5)
    w = _weight("int8", g)
    x = torch.randn((8, K), generator=g, device="cuda").to(torch.bfloat16)
    with pytest.raises(ValueError, match="column tiles of 256"):
        woq.woq_matmul_stacked(x, w, 1, n_window=(128, 256))


def test_two_gloo_ranks_on_one_card(dev, tmp_path):
    results = launch.launch(
        "torch_tp_worker:cuda_rank", 2, args=[str(tmp_path)],
        backend="gloo", collective_timeout=120, join_timeout=300,
        sys_path=[TESTS])
    launch.check(results)
    outs = [np.load(tmp_path / f"cuda_rank{r}.npz") for r in range(2)]
    assert all(bool(o["gloo_ok"]) for o in outs)
    np.testing.assert_array_equal(outs[0]["tokens"], outs[1]["tokens"])
    np.testing.assert_array_equal(outs[0]["logits"], outs[1]["logits"])
    ref, got = outs[0]["ref_logits"], outs[0]["logits"]
    assert np.abs(got - ref).max() <= 3e-2 * np.abs(ref).max()
