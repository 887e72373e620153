"""Elementwise ops and weight containers of the PyTorch port against the
JAX package: rms_norm, RoPE tables (incl. linear / NTK scaling),
apply_rope, take_rope, concat_columns, quantize_weight_only, and the numpy
bridge's dtype handling.

f32 results agree to rtol/atol 1e-6 (transcendentals may differ by an
ulp); bf16 results to one bf16 ulp (2**-7 relative), since the last cast
rounds values that differ in the f32 ulp; int8 codes exactly.
"""

import ml_dtypes
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from trtllm_llama_tpu.ops import norm as jax_norm
from trtllm_llama_tpu.ops import rope as jax_rope
from trtllm_llama_tpu.quantization import tensors as jax_tensors
from trtllm_llama_tpu_torch.convert.bridge import tensor_from_numpy
from trtllm_llama_tpu_torch.ops import norm, rope
from trtllm_llama_tpu_torch.quantization import tensors

torch.set_num_threads(1)

F32 = dict(rtol=1e-6, atol=1e-6)
BF16 = dict(rtol=2.0 ** -7, atol=2.0 ** -7)


def _np(x):
    return np.asarray(x, dtype=np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3
    w = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    jx, jw = jnp.asarray(x, dtype), jnp.asarray(w, dtype)
    want = jax_norm.rms_norm(jx, jw, 1e-6)
    got = norm.rms_norm(tensor_from_numpy(np.asarray(jx), "cpu"),
                        tensor_from_numpy(np.asarray(jw), "cpu"), 1e-6)
    assert got.dtype == (torch.float32 if dtype == "float32" else torch.bfloat16)
    np.testing.assert_allclose(_np(got.float()), _np(want),
                               **(F32 if dtype == "float32" else BF16))


@pytest.mark.parametrize("scaling", [("", 1.0), ("linear", 4.0), ("ntk", 4.0)])
def test_rope_table(scaling):
    kind, factor = scaling
    jc, js = jax_rope.rope_table(512, 64, 10000.0, scaling_type=kind,
                                 scaling_factor=factor)
    tc, ts = rope.rope_table(512, 64, 10000.0, scaling_type=kind,
                             scaling_factor=factor)
    np.testing.assert_allclose(tc.numpy(), _np(jc), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), _np(js), rtol=1e-5, atol=1e-5)


def test_rope_tables_for_config():
    from trtllm_llama_tpu.config import ModelConfig as JaxConfig
    from trtllm_llama_tpu_torch.config import ModelConfig
    over = dict(rope_scaling_type="linear", rope_scaling_factor=2.0,
                max_position_embeddings=256)
    jc, _ = jax_rope.rope_tables_for(JaxConfig.tiny(**over))
    tc, _ = rope.rope_tables_for(ModelConfig.tiny(**over))
    np.testing.assert_allclose(tc.numpy(), _np(jc), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_and_take_rope(dtype):
    rng = np.random.default_rng(1)
    b, s, h, d = 2, 6, 3, 32
    x = rng.standard_normal((b, s, h, d)).astype(np.float32)
    pos = rng.integers(0, 100, (b, s)).astype(np.int32)
    jc, js = jax_rope.rope_table(128, d)
    tc, ts = rope.rope_table(128, d)
    jcos, jsin = jax_rope.take_rope(jc, js, jnp.asarray(pos))
    tcos, tsin = rope.take_rope(tc, ts, torch.from_numpy(pos).long())
    assert tuple(tcos.shape) == jcos.shape == (b, s, 1, d)
    np.testing.assert_allclose(tcos.numpy(), _np(jcos), **F32)
    jx = jnp.asarray(x, dtype)
    want = jax_rope.apply_rope(jx, jcos, jsin)
    got = rope.apply_rope(tensor_from_numpy(np.asarray(jx), "cpu"), tcos, tsin)
    np.testing.assert_allclose(_np(got.float()), _np(want),
                               **(F32 if dtype == "float32" else BF16))


def test_quantize_weight_only_matches_jax():
    rng = np.random.default_rng(2)
    w = (rng.standard_normal((2, 64, 48)) * 0.05).astype(np.float32)
    w[0, :, 3] = 0.0                          # all-zero column: eps floor
    want = jax_tensors.quantize_weight_only(jnp.asarray(w), 8, 0)
    got = tensors.quantize_weight_only(torch.from_numpy(w))
    np.testing.assert_array_equal(got.qweight.numpy(), np.asarray(want.qweight))
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale),
                               rtol=1e-7, atol=0)
    np.testing.assert_allclose(got.dequantize().numpy(),
                               np.asarray(want.dequantize()), **F32)
    want4 = jax_tensors.quantize_weight_only(jnp.asarray(w), 4, 0)
    got4 = tensors.quantize_weight_only(torch.from_numpy(w), w_bits=4)
    assert got4.pack_block == want4.pack_block == 64
    np.testing.assert_array_equal(got4.qweight.numpy(), np.asarray(want4.qweight))
    np.testing.assert_array_equal(got4.scale.numpy(), np.asarray(want4.scale))
    with pytest.raises(ValueError):
        tensors.quantize_weight_only(torch.from_numpy(w), w_bits=3)


def test_concat_columns_matches_jax():
    rng = np.random.default_rng(3)
    ws = [(rng.standard_normal((2, 32, n)) * 0.1).astype(np.float32)
          for n in (16, 8, 8)]
    jq = [jax_tensors.quantize_weight_only(jnp.asarray(w)) for w in ws]
    tq = [tensors.quantize_weight_only(torch.from_numpy(w)) for w in ws]
    want = jax_tensors.concat_columns(jq)
    got = tensors.concat_columns(tq)
    np.testing.assert_array_equal(got.qweight.numpy(), np.asarray(want.qweight))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    plain = tensors.concat_columns([torch.from_numpy(w) for w in ws])
    np.testing.assert_array_equal(
        plain.numpy(), np.asarray(jax_tensors.concat_columns(
            [jnp.asarray(w) for w in ws])))
    assert tensors.concat_columns([tq[0], torch.from_numpy(ws[1])]) is None


def test_bridge_bf16_forms():
    x = np.linspace(-3, 3, 24, dtype=np.float32).reshape(4, 6)
    as_bf16 = x.astype(ml_dtypes.bfloat16)
    from_ml = tensor_from_numpy(as_bf16, "cpu")
    from_bits = tensor_from_numpy(as_bf16.view(np.uint16), "cpu")
    assert from_ml.dtype == from_bits.dtype == torch.bfloat16
    np.testing.assert_array_equal(from_ml.float().numpy(),
                                  as_bf16.astype(np.float32))
    assert torch.equal(from_ml, from_bits)
