"""Kernel 1 of the PyTorch port: the plain woq_matmul_stacked against the
JAX package's Pallas kernel (interpret mode) and its unfused composition.

f32 throughout, so both sides form exact products of f32 inputs and int8
weights and differ only in summation order: rtol/atol 1e-5.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from trtllm_llama_tpu.ops import linear as jax_linear
from trtllm_llama_tpu.ops.pallas.woq_matmul import (
    woq_matmul_stacked as jax_woq_matmul_stacked,
)
from trtllm_llama_tpu.quantization.tensors import (
    quantize_weight_only as jax_quantize_weight_only,
)
from trtllm_llama_tpu_torch.ops import linear
from trtllm_llama_tpu_torch.ops.kernels.woq_matmul import woq_matmul_stacked
from trtllm_llama_tpu_torch.quantization.tensors import WOQWeight

torch.set_num_threads(1)

L, K, N, LAYER = 2, 128, 256, 1
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(m):
    rng = np.random.default_rng(m)
    w = (rng.standard_normal((L, K, N)) * 0.05).astype(np.float32)
    x = rng.standard_normal((m, K)).astype(np.float32)
    nw = (1.0 + 0.1 * rng.standard_normal((L, K))).astype(np.float32)
    resid = rng.standard_normal((m, N)).astype(np.float32)
    jw = jax_quantize_weight_only(jnp.asarray(w), 8, 0)
    tw = WOQWeight(torch.from_numpy(np.array(jw.qweight)),
                   torch.from_numpy(np.array(jw.scale)))
    return x, nw, resid, jw, tw


def _opts(opt, nw, resid, to):
    return {"plain": {}, "norm": {"norm_w": to(nw)},
            "resid": {"resid": to(resid)}}[opt]


@pytest.mark.parametrize("opt", ["plain", "norm", "resid"])
@pytest.mark.parametrize("m", [1, 5, 16])
def test_plain_matches_jax_kernel(m, opt):
    x, nw, resid, jw, tw = _inputs(m)
    want = jax_woq_matmul_stacked(jnp.asarray(x), jw, LAYER, interpret=True,
                                  **_opts(opt, nw, resid, jnp.asarray))
    got = woq_matmul_stacked(torch.from_numpy(x), tw, LAYER,
                             **_opts(opt, nw, resid, torch.from_numpy))
    assert got.dtype == torch.float32 and got.shape == (m, N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("opt", ["norm", "resid"])
@pytest.mark.parametrize("m", [1, 16, 20])
def test_dense_fused_matches_unfused_composition(m, opt):
    """The port's dense_fused (inside kernel 1 at m <= 16, composed above)
    against the JAX dense_fused's unfused composition (no kernels on CPU)."""
    x, nw, resid, jw, tw = _inputs(m)
    want = jax_linear.dense_fused(jnp.asarray(x), jw, layer=LAYER,
                                  **_opts(opt, nw, resid, jnp.asarray))
    got = linear.dense_fused(torch.from_numpy(x), tw, layer=LAYER,
                             **_opts(opt, nw, resid, torch.from_numpy))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_dense_unstacked_and_batched():
    x, _, _, jw, tw = _inputs(6)
    x3 = x.reshape(2, 3, K)
    want = jax_linear.dense(jnp.asarray(x3), jw, layer=LAYER)
    got = linear.dense(torch.from_numpy(x3), tw, layer=LAYER)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    w0 = WOQWeight(tw.qweight[0], tw.scale[0])
    want0 = jax_linear.dense(jnp.asarray(x), jw.dequantize()[0])
    np.testing.assert_allclose(linear.dense(torch.from_numpy(x), w0).numpy(),
                               np.asarray(want0), **TOL)


def test_wrapper_rejects_unported_weights():
    """int4 now runs (packed K/2 rows, pack block 32); a grouped int4 layout
    whose group is not its pack block, which the JAX kernel refuses too,
    and an unknown bit width still raise."""
    x, _, _, _, tw = _inputs(1)
    w4 = WOQWeight(tw.qweight[:, :K // 2], tw.scale, w_bits=4, pack_block=32)
    got = woq_matmul_stacked(torch.from_numpy(x), w4, 0)
    want = torch.from_numpy(x) @ w4.dequantize()[0]
    torch.testing.assert_close(got, want, **TOL)
    scale_g = tw.scale[:, None, :].expand(L, K // 64, N).contiguous()
    for bad in (WOQWeight(w4.qweight, scale_g, 4, 64, 32),
                WOQWeight(tw.qweight, tw.scale, w_bits=3)):
        with pytest.raises(NotImplementedError):
            woq_matmul_stacked(torch.from_numpy(x), bad, 0)
