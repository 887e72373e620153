"""The port's forward_extend and serving steps on the card.

Marked `cuda`; every test skips without a CUDA device. On a machine with
one (which need not have JAX), run:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_serving.py

- forward_extend on the card (the projections on the weight-only kernels,
  the slab attention stock torch) against the same call on the CPU with
  the plain versions, after a prefill, into serving slot rows: logits and
  the written cache rows within 1e-3 of the largest value (f32, int8
  weights), and within 3e-2 in bf16.
- The pipelined step's readback waits on its chunk's event alone: with a
  long device sleep queued on the stream after chunk N-1 was dispatched,
  `_decode_process` returns while the sleep still runs; a decode dispatch
  (the pinned uploads, the paged table included) makes no host sync; and
  the pipelined engine's tokens equal the plain engine's on the card.
"""

import time

import pytest
import torch

from trtllm_llama_tpu_torch import EngineConfig, ModelConfig, QuantMode
from trtllm_llama_tpu_torch.models import llama
from trtllm_llama_tpu_torch.quantization.quantize import (
    init_random_quantized_params,
)
from trtllm_llama_tpu_torch.runtime.sampling import SamplingConfig
from trtllm_llama_tpu_torch.runtime.serving import ServingEngine

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-3), ("bfloat16", 3e-2)])
def test_forward_extend_on_card_matches_cpu(dev, dtype, tol):
    cfg = ModelConfig.tiny(dtype=dtype, num_kv_heads=2,
                           quant_mode=QuantMode.use_weight_only())
    params = llama.fuse_qkv_params(init_random_quantized_params(
        cfg, seed=0, device="cpu"))
    g = torch.Generator().manual_seed(1)
    ids = torch.randint(3, cfg.vocab_size, (2, 16), generator=g,
                        dtype=torch.int32)
    lens = torch.tensor([11, 6], dtype=torch.int32)
    toks = torch.randint(3, cfg.vocab_size, (2, 16), generator=g,
                         dtype=torch.int32)
    slots = torch.tensor([2, 0])
    out = {}
    for device in ("cpu", dev):
        p = _to(params, device)
        c = llama.init_caches(cfg, 3, 64, device)
        llama.forward_prefill(p, cfg, ids.to(device), lens.to(device), c,
                              slots=slots.to(device))
        logits, c = llama.forward_extend(p, cfg, toks.to(device),
                                         lens.to(device), c,
                                         slots=slots.to(device))
        out[str(device)] = (logits.float().cpu(), c.k.float().cpu(),
                            c.v.float().cpu())
    for got, want in zip(out[str(dev)], out["cpu"]):
        err = (got - want).abs().max() / want.abs().max()
        assert err <= tol, err


def _engine(dev, **opts):
    cfg = ModelConfig.tiny(dtype="bfloat16",
                           quant_mode=QuantMode.use_weight_only())
    return ServingEngine(cfg, init_random_quantized_params(cfg, seed=0,
                                                           device="cpu"),
                         EngineConfig(max_batch_size=3, max_input_len=16,
                                      max_seq_len=128),
                         sampling=SamplingConfig(end_id=-1), decode_chunk=8,
                         device=dev, **opts)


PROMPTS = [[5, 6, 7, 8], [9, 10, 11], [12, 13, 14, 15, 16, 17]]


@pytest.mark.parametrize("paged", [False, True])
def test_pipelined_readback_waits_on_its_chunk_alone(dev, paged):
    opts = dict(paged=True, block_size=16) if paged else {}
    eng = _engine(dev, pipelined=True, **opts)
    rids = [eng.submit(p, 60) for p in PROMPTS]
    eng.step()                    # admits: no chunk yet
    eng.step()                    # dispatches chunk 1, nothing to record
    pending = eng._pending_chunk
    assert pending is not None
    stream = torch.cuda.current_stream()
    torch.cuda._sleep(int(2e9))   # ~1 s of device time after chunk 1
    t0 = time.perf_counter()
    eng._decode_process(pending)
    waited = time.perf_counter() - t0
    busy = not stream.query()
    eng._pending_chunk = None
    torch.cuda.synchronize()
    assert busy, "the readback waited for work queued after its chunk"
    assert waited < 0.5, waited
    assert all(len(eng.poll(r)) == 9 for r in rids)
    # a dispatch uploads its state and tables without a host sync
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng._pending_chunk = eng._decode_dispatch()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    done = eng.run_to_completion()
    plain = _engine(dev, **opts)
    prids = [plain.submit(p, 60) for p in PROMPTS]
    want = plain.run_to_completion()
    assert [done[r].output_ids for r in rids] == [
        want[r].output_ids for r in prids]
    if paged:
        assert eng.kv_mgr.blocks.free_blocks == eng.num_blocks
