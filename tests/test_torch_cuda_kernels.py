"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`; every test skips without a CUDA device. On a machine with
one (which need not have JAX), run:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_kernels.py

Tolerances: f32 outputs differ from the plain versions only in summation
order (rtol/atol 1e-5); bf16 outputs by at most a rounding step at the
final cast (2**-7 relative to the largest magnitude).
"""

import numpy as np
import pytest
import torch

from trtllm_llama_tpu_torch.ops.kernels import decode_attention as da
from trtllm_llama_tpu_torch.ops.kernels import prefill_attention as pa
from trtllm_llama_tpu_torch.ops.kernels import woq_matmul as woq
from trtllm_llama_tpu_torch.quantization.tensors import WOQWeight

pytestmark = pytest.mark.cuda

DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _assert_close(got, ref, dtype):
    got, ref = got.float(), ref.float()
    assert torch.isfinite(got).all()
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    if dtype == torch.float32:
        assert err <= 1e-5 * (1 + scale), (err, scale)
    else:
        assert err <= 2.0 ** -7 * scale, (err, scale)


@pytest.mark.parametrize("opt", ["none", "norm", "resid"])
@pytest.mark.parametrize("m", [1, 3, 16, 40])
@pytest.mark.parametrize("dtype", DTYPES)
def test_woq_kernel_matches_plain(dev, dtype, m, opt):
    g = torch.Generator(device=dev).manual_seed(m)
    n_layers, k, n = 3, 1000, 784      # ragged K tile and column block
    w = WOQWeight(torch.randint(-127, 128, (n_layers, k, n), generator=g,
                                device=dev, dtype=torch.int8),
                  torch.rand((n_layers, n), generator=g, device=dev) * 1e-2)
    x = torch.randn((m, k), generator=g, device=dev).to(dtype)
    kw = {"none": {},
          "norm": {"norm_w": (1 + 0.1 * torch.randn(
              (n_layers, k), generator=g, device=dev)).to(dtype)},
          "resid": {"resid": torch.randn((m, n), generator=g,
                                         device=dev).to(dtype)}}[opt]
    before = woq.woq_matmul_stacked.launches
    got = woq.woq_matmul_stacked(x, w, 2, **kw)
    assert woq.woq_matmul_stacked.launches == before + 1
    _assert_close(got, woq.woq_matmul_stacked_plain(x, w, 2, **kw), dtype)


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_kernel_matches_plain(dev, dtype, hq, hkv, d):
    g = torch.Generator(device=dev).manual_seed(d)
    b, s = 3, 40
    q, k, v = (torch.randn((b, s, h, d), generator=g, device=dev).to(dtype)
               for h in (hq, hkv, hkv))
    lens = torch.tensor([40, 17, 1], dtype=torch.int32, device=dev)
    got = pa.prefill_attention_kernel(q, k, v, lens)
    _assert_close(got, pa.prefill_attention_kernel_plain(q, k, v, lens), dtype)


@pytest.mark.parametrize("d", [32, 128])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_kernel_matches_plain(dev, dtype, hq, hkv, d):
    g = torch.Generator(device=dev).manual_seed(d)
    n_layers, b, s = 2, 4, 128
    kc = torch.randn((n_layers, b, hkv, s, d), generator=g, device=dev).to(dtype)
    vc = torch.randn_like(kc)
    q = torch.randn((b, hq, d), generator=g, device=dev).to(dtype)
    kn = torch.randn((b, hkv, d), generator=g, device=dev).to(dtype)
    vn = torch.randn_like(kn)
    pos = torch.tensor([0, 31, 32, 127], dtype=torch.int32, device=dev)
    kc2, vc2 = kc.clone(), vc.clone()
    got = da.dma_decode_attention(q, kn, vn, kc, vc, 1, pos)
    ref = da.dma_decode_attention_plain(q, kn, vn, kc2, vc2, 1, pos)
    _assert_close(got, ref, dtype)
    assert torch.equal(kc, kc2) and torch.equal(vc, vc2)


def test_tiny_generate_on_cuda_matches_cpu(dev):
    from trtllm_llama_tpu_torch import EngineConfig, ModelConfig, QuantMode
    from trtllm_llama_tpu_torch.quantization.quantize import (
        init_random_quantized_params,
    )
    from trtllm_llama_tpu_torch.runtime.sampling import SamplingConfig
    from trtllm_llama_tpu_torch.runtime.session import GenerationSession

    cfg = ModelConfig.tiny(dtype="float32",
                           quant_mode=QuantMode.use_weight_only())
    params = init_random_quantized_params(cfg, seed=0, device="cpu")
    prompts = [[5, 17, 99, 3, 250, 8], [200, 4, 66]]
    outs = []
    for device in ("cpu", "cuda"):
        sess = GenerationSession(cfg, params, EngineConfig(
            max_input_len=16, max_seq_len=48), device=device)
        outs.append(sess.generate(prompts, sampling=SamplingConfig(end_id=-1),
                                  max_new_tokens=10).output_ids)
    np.testing.assert_array_equal(outs[0], outs[1])


def test_wrappers_reject_bad_inputs(dev):
    w = WOQWeight(torch.zeros((1, 64, 24), dtype=torch.int8, device=dev),
                  torch.ones((1, 24), device=dev))
    with pytest.raises(ValueError):               # N % 16 != 0
        woq.woq_matmul_stacked(torch.ones((1, 64), device=dev), w, 0)
    q = torch.ones((1, 8, 2, 48), device=dev)     # head dim 48
    with pytest.raises(ValueError):
        pa.prefill_attention_kernel(q, q, q)
