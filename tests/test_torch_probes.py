"""Rows 15-19, the decode probes: their plain versions give what the JAX
package's TPU probes expect (`scripts/probe_int4_kernel.py` and the two
fp8 kernels of `tests/test_tpu_kernels.py`; row 18 also through the
tensor-core GEMV's pair decoders), exhaustively and exactly; on CPU
tensors the wrappers run them and launch nothing."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from trtllm_llama_tpu.ops.fp8 import fp8_decode as jax_fp8_decode
from trtllm_llama_tpu.quantization import tensors as jax_tensors
from trtllm_llama_tpu_torch.ops.kernels import probes as pr

torch.set_num_threads(1)


def _u16(bf16):
    return bf16.view(torch.int16).numpy().view(np.uint16)


def test_bitcast_puts_the_low_half_on_the_even_row():
    words = pr.bitcast_inputs()
    out = _u16(pr.probe_bitcast_u32_bf16(words))
    assert out.shape == (16, 128)
    w = words.numpy().view(np.uint32)
    # the TPU probe's finding: lo16 -> bf16 row 2s, hi16 -> row 2s + 1
    np.testing.assert_array_equal(out[0::2], w & 0xFFFF)
    np.testing.assert_array_equal(out[1::2], w >> 16)
    assert (out[0, 0], out[1, 0], out[2, 0]) == (0x4000, 0x3F80, 0x4010)


def test_u16_formula_on_every_value():
    out = _u16(pr.probe_u16_ops(pr.u16_inputs()))
    v = np.arange(65536, dtype=np.uint32)
    want = ((v >> 2) & 0x78) | 0x4300
    # word i of the input holds values 2i (low) and 2i + 1 (high)
    got = np.stack([out[0::2].reshape(-1), out[1::2].reshape(-1)], axis=1)
    np.testing.assert_array_equal(got.reshape(-1), want)


def test_nibble_construct_gives_128_plus_8n():
    out = pr.probe_u32_bf16_construct(pr.construct_inputs()).float().numpy()
    i = np.arange(256)
    lo = out[0::2].reshape(-1)          # rows 0, 2: low halves of the words
    hi = out[1::2].reshape(-1)
    np.testing.assert_array_equal(lo, 128 + 8 * (i % 16))
    np.testing.assert_array_equal(hi, 128 + 8 * (i // 16))
    k = 9 + 16 * 5                      # the TPU probe's word (5 << 16) | 9
    assert (lo[k], hi[k]) == (200.0, 168.0)


def test_gemv_decodes_match_the_codecs():
    fp8, int8, int4 = pr.probe_gemv_decodes(pr.code_inputs())
    codes = np.arange(256, dtype=np.uint8)
    want = np.asarray(jax_fp8_decode(jnp.asarray(codes), jnp.float32))
    nan = np.isnan(want)
    assert nan.sum() == 2 and np.isnan(fp8.numpy()[nan]).all()
    np.testing.assert_array_equal(fp8.numpy()[~nan], want[~nan])
    np.testing.assert_array_equal(int8.numpy(), codes.view(np.int8))
    # a byte is one int4 pair, low nibble first, each biased by 8
    np.testing.assert_array_equal(int4.numpy()[:, 0], (codes & 15) - 8.0)
    np.testing.assert_array_equal(int4.numpy()[:, 1], (codes >> 4) - 8.0)


@pytest.mark.parametrize("dtype", ["bf16", "fp16"])
def test_tc_pairs_match_the_codecs(dtype):
    """Row 18 through the tensor-core GEMV's pair decoders: every int8 and
    e4m3 code in the low half beside the code of the word n / 2 on (high
    half), every int4 byte as (low, high) nibble, each the exact value in
    bf16 / fp16 (the JAX codec's e4m3 values; the two NaN codes NaN)."""
    words = pr.code_inputs()
    out = pr.probe_tc_pairs(words)
    int8, int4, fp8 = out[:3] if dtype == "bf16" else out[3:]
    want_dt = torch.bfloat16 if dtype == "bf16" else torch.float16
    codes = np.arange(256, dtype=np.uint8)
    partner = np.roll(codes.reshape(64, 4), -32, axis=0).reshape(-1)
    assert all(t.dtype == want_dt and t.shape == (256, 2)
               for t in (int8, int4, fp8))
    np.testing.assert_array_equal(int8.float().numpy()[:, 0],
                                  codes.view(np.int8))
    np.testing.assert_array_equal(int8.float().numpy()[:, 1],
                                  partner.view(np.int8))
    np.testing.assert_array_equal(int4.float().numpy()[:, 0],
                                  (codes & 15) - 8.0)
    np.testing.assert_array_equal(int4.float().numpy()[:, 1],
                                  (codes >> 4) - 8.0)
    for half, c in ((0, codes), (1, partner)):
        want = np.asarray(jax_fp8_decode(jnp.asarray(c), jnp.float32))
        got = fp8.float().numpy()[:, half]
        nan = np.isnan(want)
        assert nan.sum() == 2 and np.isnan(got[nan]).all()
        # every e4m3 value is exact in bf16 and fp16
        np.testing.assert_array_equal(got[~nan], want[~nan])


def test_fp8_planes_read_back_the_logical_rows():
    q = pr.planes_inputs()
    codes = np.broadcast_to(np.arange(256, dtype=np.uint8).reshape(128, 2)[
        :, :, None], (128, 2, 64)).reshape(128, 128)
    np.testing.assert_array_equal(q.numpy(), np.asarray(
        jax_tensors.interleave_fp8_rows(jnp.asarray(codes), 128)))
    got = pr.probe_fp8_planes(q).numpy()
    want = np.asarray(jax_fp8_decode(jnp.asarray(codes), jnp.float32))
    nan = np.isnan(want)
    assert np.isnan(got[nan]).all()
    np.testing.assert_array_equal(got[~nan], want[~nan])


@pytest.mark.parametrize("name", ["probe_bitcast_u32_bf16", "probe_u16_ops",
                                  "probe_u32_bf16_construct",
                                  "probe_gemv_decodes", "probe_tc_pairs",
                                  "probe_fp8_planes"])
def test_cpu_tensors_take_the_plain_version(name):
    inputs = {"probe_bitcast_u32_bf16": pr.bitcast_inputs,
              "probe_u16_ops": pr.u16_inputs,
              "probe_u32_bf16_construct": pr.construct_inputs,
              "probe_gemv_decodes": pr.code_inputs,
              "probe_tc_pairs": pr.code_inputs,
              "probe_fp8_planes": pr.planes_inputs}[name]()
    fn = getattr(pr, name)
    before = fn.launches
    got, want = fn(inputs), getattr(pr, name + "_plain")(inputs)
    assert fn.launches == before
    for a, b in zip(got if isinstance(got, tuple) else [got],
                    want if isinstance(want, tuple) else [want]):
        assert torch.equal(a.nan_to_num(), b.nan_to_num())
