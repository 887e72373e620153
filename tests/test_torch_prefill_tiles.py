"""Host-side pieces of rows 10 and 13's tensor-core tile
(`csrc/flash_attention.cuh`), on the CPU.

- P through P V: the tile carries P as three bf16 (two fp16) terms, each
  the rounding of what the ones before it left. `split_p` (row 10's plain
  version takes it as `p_terms`, which `attention_precision.py` runs on
  the full model) holds P to within 2**-24 with that many terms; one term,
  P rounded, does not. With the terms, the plain version's bf16 / fp16
  output is its f32-P output but for a few one-ulp roundings of
  summation order; with P rounded, a third of the outputs move.
- The work behind the bounds `chip_smoke.py` prints for rows 10 and 13
  (`prefill_attention_work`, `packed_attention_work`): bytes and
  operations against a count from the contract's own mask, over random
  shapes (hypothesis) and at the shapes the smoke times.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from trtllm_llama_tpu_torch.ops.attention import alibi_slopes
from trtllm_llama_tpu_torch.ops.kernels.prefill_attention import (
    prefill_attention_kernel_plain, split_p,
)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

torch.set_num_threads(1)

# p_terms<T>() in csrc/flash_attention.cuh
P_TERMS = [(torch.bfloat16, 3), (torch.float16, 2)]


@pytest.mark.parametrize("dtype,n", P_TERMS)
def test_p_terms_carry_p_to_f32_precision(dtype, n):
    """The tile's P terms sum to P within 2**-24 (P <= 1: the row's largest
    term is exp(0)); one term, P rounded to q's dtype, does not."""
    rng = np.random.default_rng(5)
    p = torch.from_numpy(np.concatenate([
        rng.random(100_000) ** 8, [1.0, 0.5, 2.0 ** -30, 0.0,
                                   np.exp(-20.0), 1 - 2.0 ** -20]]
    ).astype(np.float32))
    err = (sum(split_p(p, dtype, n)) - p).abs().max().item()
    assert err <= 2.0 ** -24, err
    assert (split_p(p, dtype, 1)[0] - p).abs().max().item() > 2.0 ** -14


@pytest.mark.parametrize("alibi", [False, True])
@pytest.mark.parametrize("dtype,n", P_TERMS)
def test_plain_with_p_terms_keeps_the_f32_softmax(dtype, n, alibi):
    """Row 10's plain version with P in the tile's terms against itself with
    f32 P, on the same bf16 / fp16 inputs (GQA 2, a ragged batch): at most
    0.2% of the outputs move (an f32 sum landing on the other side of a
    rounding), by at most one ulp of the largest; with P rounded to one
    term, 100x as many move."""
    rng = np.random.default_rng(11)
    b, s, hq, hkv, d = 2, 160, 4, 2, 64
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (b, s, h, d)).astype(np.float32)).to(dtype) for h in (hq, hkv, hkv))
    lens = torch.tensor([160, 97], dtype=torch.int32)
    slopes = alibi_slopes(hq) if alibi else None
    ref = prefill_attention_kernel_plain(q, k, v, lens, alibi=slopes).float()

    def err(terms):
        return (prefill_attention_kernel_plain(
            q, k, v, lens, alibi=slopes, p_terms=terms).float() - ref).abs()

    err_terms, err_one = err(n), err(1)
    assert err_terms.max() <= torch.finfo(dtype).eps * ref.abs().max()
    moved = (err_terms > 0).float().mean().item()
    assert moved <= 2e-3, moved
    assert (err_one > 0).float().mean().item() >= 100 * moved


def _dense_work_by_mask(lens, s, hq, hkv, d):
    """Row 10's (bytes, operations) from the contract's mask: the pairs it
    keeps, the q rows and key columns they touch; a length of 0 reads V's
    S rows and adds each value once."""
    rows = torch.arange(s)
    n_bytes, ops = len(lens) * 4 + s * hq * d * 2 * len(lens), 0
    for n in lens:
        if n == 0:
            n_bytes += s * hkv * d * 2
            ops += s * hkv * d
            continue
        keep = (rows[None, :] <= rows[:, None]) & (rows[None, :] < n)
        n_q = int(keep.any(1).sum())
        n_kv = int(keep.any(0).sum())
        n_bytes += (n_q * hq + 2 * n_kv * hkv) * d * 2
        ops += 4 * hq * d * int(keep.sum())
    return n_bytes, ops


def _packed_work_by_mask(seg, hq, hkv, d):
    """Row 13's (bytes, operations) from the contract's mask over segment
    ids `seg` (-1 for pad rows, whose output is undefined)."""
    seg = torch.tensor(seg)
    rows = torch.arange(len(seg))
    real = seg >= 0
    keep = ((rows[None, :] <= rows[:, None]) & (seg[None, :] == seg[:, None])
            & real[:, None])
    n_rows = int(real.sum())
    return (n_rows * (2 * hq + 2 * hkv) * d * 2 + len(seg) * 4,
            4 * hq * d * int(keep.sum()))


def _stream(seg_lens, pad):
    return [i for i, n in enumerate(seg_lens) for _ in range(n)] + [-1] * pad


@settings(max_examples=100, deadline=None)
@given(st.integers(1, 300), st.data(), st.sampled_from([(4, 4), (8, 2)]),
       st.sampled_from([32, 64, 96, 128, 256]))
def test_dense_work_matches_the_mask(s, data, heads, d):
    lens = data.draw(st.lists(st.integers(0, s + 5), min_size=1, max_size=4),
                     label="lens")
    hq, hkv = heads
    assert (cs.prefill_attention_work(lens, s, hq, hkv, d)
            == _dense_work_by_mask(lens, s, hq, hkv, d))


@settings(max_examples=100, deadline=None)
@given(st.lists(st.integers(1, 150), min_size=1, max_size=8),
       st.integers(0, 70), st.sampled_from([(4, 4), (8, 2)]))
def test_packed_work_matches_the_mask(seg_lens, pad, heads):
    seg = _stream(seg_lens, pad)
    hq, hkv = heads
    assert (cs.packed_attention_work(seg_lens, len(seg), hq, hkv, 128)
            == _packed_work_by_mask(seg, hq, hkv, 128))


# the shapes chip_smoke.py checks row 10 at (32 heads of 128 but where
# named): the main path's bs1 and bs4, a long ragged batch, GQA 4, a length
# of 0 off the tile, Task A, GPT-J's and GPT-NeoX's heads
@pytest.mark.parametrize("s,lens,hq,hkv,d", [
    (16, [8], 32, 32, 128),
    (16, [8, 5, 12, 3], 32, 32, 128),
    (512, [512, 300], 32, 32, 128),
    (64, [64, 17], 32, 8, 128),
    (150, [150, 77, 0], 32, 32, 128),
    (1024, [cs.TASK_A_PROMPT], 32, 32, 128),
    (16, [8], 16, 16, 256),
    (16, [8], 64, 64, 96),
])
def test_dense_work_at_the_smokes_shapes(s, lens, hq, hkv, d):
    assert (cs.prefill_attention_work(lens, s, hq, hkv, d)
            == _dense_work_by_mask(lens, s, hq, hkv, d))


@pytest.mark.parametrize("t,seg_lens,hkv", [
    (64, [20, 30, 1], 32),
    (256, [100, 1, 77], 8),
    (200, [64, 1, 63, 65], 8),
])
def test_packed_work_at_the_smokes_shapes(t, seg_lens, hkv):
    seg = _stream(seg_lens, t - sum(seg_lens))
    assert (cs.packed_attention_work(seg_lens, t, 32, hkv, 128)
            == _packed_work_by_mask(seg, 32, hkv, 128))


@pytest.mark.parametrize("work,ms,by", [
    # row 10, B=1 S=16 len 8: q / out 16 rows, K / V 8
    (lambda: cs.prefill_attention_work([8], 16, 32, 32, 128), 1.1738e-4,
     "bytes"),
    # row 10 at Task A's shape: K / V 923 rows of 1024
    (lambda: cs.prefill_attention_work([cs.TASK_A_PROMPT], 1024, 32, 32,
                                       128), 9.5223e-3, "bytes"),
    # row 13, 709 segment rows in a 1024-row stream
    (lambda: cs.packed_attention_work([709], 1024, 32, 32, 128), 6.9363e-3,
     "bytes"),
])
def test_bounds_count_only_the_rows_the_contract_reads(work, ms, by):
    b_ms, b_by = cs.bound_ms(*work())
    assert b_by == by
    assert b_ms == pytest.approx(ms, rel=1e-4)
