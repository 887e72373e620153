"""Speculative decoding on the card.

Marked `cuda`; every test skips without a CUDA device. On a machine with
one (which need not have JAX), run:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_speculative.py

A tiny bf16 model with int8 weight-only projections: a bs1 verify step
(gamma 4: 5 rows) runs every projection on the tensor-core GEMV (5 a
layer: the fused qkv, wo, gate, up, down), each draft step of a self draft
on the one-row GEMV; speculative greedy tokens equal GenerationSession's
up to a near tie (the verify's GEMV splits K otherwise than the decode
step's: where the tokens first differ, the two picks are within 5% of the
largest logit on a replay of the plain session), and prompt lookup on
make_copy_params' weights commits gamma + 1 tokens a verify.
"""

import numpy as np
import pytest
import torch

from trtllm_llama_tpu_torch import EngineConfig, ModelConfig, QuantMode
from trtllm_llama_tpu_torch.models import llama
from trtllm_llama_tpu_torch.ops.kernels import woq_matmul as woq
from trtllm_llama_tpu_torch.quantization.evaluate import make_copy_params
from trtllm_llama_tpu_torch.quantization.quantize import (
    init_random_quantized_params,
)
from trtllm_llama_tpu_torch.runtime.sampling import SamplingConfig
from trtllm_llama_tpu_torch.runtime.session import GenerationSession
from trtllm_llama_tpu_torch.runtime.speculative import (
    PromptLookupSession, SpeculativeSession,
)

pytestmark = pytest.mark.cuda

TIE = 5e-2          # a near tie: the lead within 5% of the largest |logit|
GAMMA = 4


@pytest.fixture
def tiny():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = ModelConfig.tiny(dtype="bfloat16", num_layers=4,
                           quant_mode=QuantMode.use_weight_only())
    params = init_random_quantized_params(cfg, seed=0, device="cuda")
    return cfg, params, EngineConfig(max_batch_size=1, max_input_len=16,
                                     max_seq_len=64)


def _counts():
    f = woq.woq_matmul_stacked
    return f.launches, f.tc_launches, f.gemm_launches


def _zero():
    f = woq.woq_matmul_stacked
    f.launches = f.tc_launches = f.gemm_launches = 0


def test_self_draft_verifies_on_the_tensor_core_gemv(tiny):
    cfg, params, ecfg = tiny
    plain = GenerationSession(cfg, params, ecfg, device="cuda")
    spec = SpeculativeSession(cfg, plain.params, cfg, plain.params, ecfg,
                              gamma=GAMMA, device="cuda")
    ids = np.random.default_rng(0).integers(3, cfg.vocab_size, (1, 8))
    scfg = SamplingConfig(end_id=-1)
    new = 24
    want = plain.generate(ids, sampling=scfg, max_new_tokens=new)
    _zero()
    got = spec.generate(ids, sampling=scfg, max_new_tokens=new)
    iters = spec.last_iters - 1                      # verify steps
    n_l = cfg.num_layers
    launches, tc, gemm = _counts()
    # the 16-row prefills (target, self draft) and the 5-row verifies on the
    # tensor-core GEMV; the draft's decode steps on the one-row GEMV
    assert gemm == 0
    assert tc == 5 * n_l * (2 + iters)
    assert launches - tc == 5 * n_l * (GAMMA + 1) * iters
    assert iters < new - 1
    a, b = got.output_ids[0], want.output_ids[0]
    diff = np.flatnonzero(a != b)
    if diff.size:
        k = int(diff[0])
        with torch.inference_mode():
            caches = llama.init_caches(cfg, 1, 64, "cuda")
            t = torch.as_tensor(np.pad(ids, ((0, 0), (0, 8))), device="cuda",
                                dtype=torch.int32)
            lens = torch.tensor([8], dtype=torch.int32, device="cuda")
            logits, caches = llama.forward_prefill(plain.params, cfg, t, lens,
                                                   caches, rope=plain.rope)
            for j in range(k):
                logits, caches = llama.forward_decode(
                    plain.params, cfg, torch.tensor([int(b[j])],
                                                    dtype=torch.int32,
                                                    device="cuda"),
                    lens + j, caches, rope=plain.rope)
        row = logits[0].float()
        lead = float(row[int(b[k])] - row[int(a[k])])
        assert lead <= TIE * float(row.abs().max()), (k, lead)


def test_prompt_lookup_on_the_copy_model(tiny):
    cfg, params, ecfg = tiny
    cycle = [11, 23, 5, 42, 17, 99, 3, 64]
    copy = make_copy_params(cfg, params, cycle)
    sess = PromptLookupSession(cfg, copy, ecfg, gamma=GAMMA, ngram=3,
                               device="cuda")
    new = 21                                         # 1 + 4 x 5
    out = sess.generate([cycle * 2], sampling=SamplingConfig(end_id=-1),
                        max_new_tokens=new)
    assert out.output_ids[0].tolist() == [cycle[i % 8] for i in range(new)]
    assert sess.last_iters == 1 + (new - 1) // (GAMMA + 1)
