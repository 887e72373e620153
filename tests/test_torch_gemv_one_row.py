"""The one-launch GEMVs of one row (csrc/woq_gemv.cuh on csrc/gemv_stream.cuh,
kernels 1 and 6) and of 1-4 rows (the dp4a GEMV of csrc/w8a8_matmul.cu,
rows 5 and 6), on the CPU: the plan that sizes their grid (gemv_plan) and
the plain versions they are held to, against the JAX package's Pallas
kernels in interpret mode at the rows these bodies take.

The bodies themselves run only on the card (tests/test_torch_cuda_kernels.py).
Tolerances: the weight-only plain versions take f32 activations here, so
both sides form exact products and differ in summation order only (1e-5);
the W8A8 plain versions are bit-equal to the Pallas kernels (both sum the
int8 products exactly and scale (f32(acc) * s_x) * s_w in f32).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from hypothesis import given, settings
from hypothesis import strategies as st

from trtllm_llama_tpu.ops.pallas.w8a8_matmul import (
    w8a8_matmul as jax_w8a8_matmul,
    w8a8_matmul_stacked as jax_w8a8_matmul_stacked,
)
from trtllm_llama_tpu.ops.pallas.woq_matmul import woq_matmul as jax_woq_matmul
from trtllm_llama_tpu.quantization.tensors import (
    quantize_weight_only as jax_quantize_weight_only,
)
from trtllm_llama_tpu_torch.ops.kernels import _build
from trtllm_llama_tpu_torch.ops.kernels import w8a8_matmul as w8a8
from trtllm_llama_tpu_torch.ops.kernels import woq_matmul as woq
from trtllm_llama_tpu_torch.quantization.tensors import WOQWeight

torch.set_num_threads(1)

CSRC = Path(woq.__file__).resolve().parents[2] / "csrc"
H100_SMS = 132     # the SMs of the card the plan is tuned for

# (name, unit, group, kr, x_bytes) of each layout the bodies take, as
# launch_gemv and launch_dp4a pass them
LAYOUTS = {
    "int8": (8, 0, 1, 4),
    "int4 per-channel": (128, 0, 2, 4),
    "int4 g128": (128, 128, 2, 4),
    "int4 g32": (32, 32, 2, 4),
    "int4 b96": (96, 0, 2, 4),       # a pack block that does not divide 512
    "int4 g96": (96, 96, 2, 4),
    "int8 g64": (64, 64, 1, 4),
    "fp8 interleaved": (128, 0, 1, 4),
    "dp4a": (16, 0, 1, 1),
}


def _plan(m, k, n, layout, sms=H100_SMS):
    unit, group, kr, x_bytes = LAYOUTS[layout]
    return woq.gemv_plan(m, k, n, sms, unit, group, kr, x_bytes)


def test_plan_constants_match_the_sources():
    """The plan's block, blocks an SM and row tiles are the sources'."""
    stream = (CSRC / "gemv_stream.cuh").read_text()
    assert re.search(rf"constexpr int kThreads = {woq.GEMV_THREADS};", stream)
    for src in ("woq_gemv.cuh", "w8a8_matmul.cu"):
        text = (CSRC / src).read_text()
        assert re.search(rf"__launch_bounds__\(kThreads, "
                         rf"{woq.GEMV_BLOCKS_PER_SM}\)", text), src
    assert [woq.gemv_rows_per_tile(m) for m in range(1, 6)] == [1, 2, 4, 4, 4]
    assert [woq.gemv_rows_per_tile(m, True) for m in (1, 2, 3)] == [1, 2, 2]


@settings(max_examples=400, deadline=None)
@given(m=st.integers(1, 16), k_units=st.integers(1, 200),
       n16=st.integers(1, 2500),
       layout=st.sampled_from(sorted(LAYOUTS)),
       sms=st.sampled_from([H100_SMS, 114, 78]))     # SXM, PCIe, a cut card
def test_plan_splits_k_and_tiles_n_once(m, k_units, n16, layout, sms):
    """Every K split starts on whole pack / interleave / group blocks and
    the splits cover K once; the column tiles cover N once; a grouped
    split is whole groups and a thread's rows end a group on a fixed
    count; the splits' sums and the tiles' counters fit the per-stream
    workspace and the grid is one wave where the column tiles and a
    block's shared memory allow; that memory fits its budget."""
    unit, group, kr, x_bytes = LAYOUTS[layout]
    k, n = unit * k_units, 16 * n16
    plan = _plan(m, k, n, layout, sms)
    assert plan.mr == woq.gemv_rows_per_tile(m, bool(group))
    assert plan.lanes in woq.GEMV_LANES and plan.mr * plan.lanes <= 32
    # K: splits [s kc, min(K, (s + 1) kc)), none empty, whole blocks
    assert plan.kc % unit == 0 and plan.ksplit >= 1
    starts = [s * plan.kc for s in range(plan.ksplit)]
    ends = [min(k, s + plan.kc) for s in starts]
    assert all(e > s for s, e in zip(starts, ends))
    assert starts[0] == 0 and ends[-1] == k
    assert all(e == s for e, s in zip(ends, starts[1:]))
    if group:
        rows = woq.GEMV_THREADS // plan.lanes
        assert plan.kc % group == 0
        assert (group // kr) % rows == 0 or rows % (group // kr) == 0
    # N: column tiles of 16 lanes columns, the last one ragged
    bn = 16 * plan.lanes
    tiles = -(-n // bn)
    cols = [c for t in range(tiles) for c in range(t * bn, min(n, t * bn + bn))]
    assert cols == list(range(n))
    # shared memory; the splits shared memory forces (x staged at up to 4
    # rows of a long K) may outgrow the workspace's first size and the one
    # wave, no other
    assert woq.gemv_smem(plan, x_bytes, group) <= woq.GEMV_SMEM_BYTES
    per_row = plan.mr * x_bytes + (bn * 4 / group if group else 0)
    kc_max = int((woq.GEMV_SMEM_BYTES - woq.GEMV_WARPS * plan.mr * bn * 4)
                 // per_row) // unit * unit
    forced = plan.ksplit == -(-k // kc_max)
    assert tiles <= _build.WORKSPACE_MIN[1]
    assert (plan.ksplit == 1 or forced
            or plan.ksplit * m * n <= _build.WORKSPACE_MIN[0])
    assert (tiles * plan.ksplit <= max(tiles, woq.GEMV_BLOCKS_PER_SM * sms)
            or forced)


# LLaMA-7B's one-row calls: the four projections, the fused gate/up of
# TLLM_FUSE_GU, the quantized lm_head of paths 3 and 4
LLAMA_ONE_ROW = [(4096, 12288), (4096, 4096), (4096, 11008), (11008, 4096),
                 (4096, 22016), (4096, 32000)]


@pytest.mark.parametrize("layout", ["int8", "int4 per-channel", "int4 g128",
                                    "fp8 interleaved", "dp4a"])
@pytest.mark.parametrize("kn", LLAMA_ONE_ROW)
def test_plan_fills_the_card_at_llama_one_row_shapes(kn, layout):
    """Each one-row LLaMA-7B call gets a grid of at least one block on
    each of the H100's 132 SMs and no more than one wave of two, in at
    most GEMV_GROUPED_SPLITS K splits."""
    k, n = kn
    plan = _plan(1, k, n, layout)
    blocks = -(-n // (16 * plan.lanes)) * plan.ksplit
    assert H100_SMS <= blocks <= woq.GEMV_BLOCKS_PER_SM * H100_SMS, plan
    assert plan.ksplit <= woq.GEMV_GROUPED_SPLITS, plan


def test_plan_refuses_a_group_no_column_tile_fits():
    """Groups of 12 stored rows: no block's rows at a time (8, 16 or 32)
    divide them or are divided by them, so no thread ends its groups on
    a fixed count."""
    with pytest.raises(ValueError, match="no column tile"):
        woq.gemv_plan(1, 1200, 4096, H100_SMS, unit=12, group=12)
    assert woq.gemv_plan(1, 1152, 4096, H100_SMS, unit=24, group=24).lanes


# ---------------------------------------------------------------------------
# the plain versions against the Pallas kernels at the bodies' rows
# ---------------------------------------------------------------------------

SCALES = ["token/channel", "token/tensor", "static/channel", "static/tensor"]
K8, N8 = 384, 384


def _w8a8_inputs(m, scales, n_layers=2):
    rng = np.random.default_rng(m + 7 * len(scales))
    x_q = rng.integers(-128, 128, (m, K8)).astype(np.int8)
    w_q = rng.integers(-128, 128, (n_layers, K8, N8)).astype(np.int8)
    s_x = ((rng.random((m, 1)) * 0.05 + 1e-3).astype(np.float32)
           if scales.startswith("token") else np.array([0.02], np.float32))
    s_w = (rng.random((n_layers, N8 if scales.endswith("channel") else 1))
           .astype(np.float32) * 1e-3 + 1e-4)
    return x_q, w_q, s_x, s_w


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("scales", SCALES)
@pytest.mark.parametrize("m", [1, 2, 3, 4])
def test_w8a8_plain_equals_pallas_kernels_at_dp4a_rows(m, scales):
    """Rows 5 and 6 at the 1-4 rows the dp4a GEMV takes, every scale kind,
    stacked and 2-D: bit-equal."""
    x_q, w_q, s_x, s_w = _w8a8_inputs(m, scales)
    want = jax_w8a8_matmul_stacked(jnp.asarray(x_q), jnp.asarray(w_q),
                                   jnp.asarray(s_x), jnp.asarray(s_w), 1,
                                   interpret=True)
    got = w8a8.w8a8_matmul_stacked(_t(x_q), _t(w_q), _t(s_x), _t(s_w), 1)
    assert got.dtype == torch.float32 and got.shape == (m, N8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want2d = jax_w8a8_matmul(jnp.asarray(x_q), jnp.asarray(w_q[0]),
                             jnp.asarray(s_x), jnp.asarray(s_w[0]),
                             interpret=True)
    got2d = w8a8.w8a8_matmul(_t(x_q), _t(w_q[0]), _t(s_x), _t(s_w[0]))
    np.testing.assert_array_equal(got2d.numpy(), np.asarray(want2d))


@pytest.mark.parametrize("m", [1, 4])
def test_woq_2d_int8_plain_matches_pallas_kernel(m):
    """The 2-D int8 entry (row 1) at one row and at bs4: f32, summation
    order only (1e-5)."""
    rng = np.random.default_rng(11 + m)
    k, n = 256, 384
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    jw = jax_quantize_weight_only(jnp.asarray(w), 8, 0)
    tw = WOQWeight(_t(jw.qweight), _t(jw.scale))
    want = jax_woq_matmul(jnp.asarray(x), jw, interpret=True)
    got = woq.woq_matmul(torch.from_numpy(x), tw)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
