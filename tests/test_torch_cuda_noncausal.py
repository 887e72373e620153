"""The non-causal branch of rows 10 and 12 on the card, and the models that
run it: ChatGLM's prefix-LM prefill and the BERT encoder.

Marked `cuda`; every test skips without a CUDA device. On a machine with
one (which need not have JAX), run:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_noncausal.py

- Rows 10 and 12 with `causal=False` against their plain versions on the
  same card tensors: f32, bf16 and fp16; head dims 32, 64, 128 and 256
  (row 12: 64 / 128 on its warp-specialized tile, 32 / 256 on row 10's);
  GQA groups 1 and 4; B = 3 with lengths S, ragged and 0; S off the 64-row
  tile; with and without ALiBi slopes. Tolerance: 1e-5 (f32), 2^-7 (bf16),
  2^-10 (fp16) of the largest |out|: the order of the f32 sums and one
  rounding of the output. One launch a call, counted in `.launches` and
  `.noncausal_launches`; a causal call moves only `.launches`.
- A tiny ChatGLM (4 heads of 128, 2 layers) and a tiny BERT (4 heads
  of 64, 2 layers), f32 and bf16, on the card against the same forward
  through the plain versions on the CPU: prefill logits / hidden states
  within 1e-4 (f32) and 3e-2 (bf16) of the largest; ChatGLM's greedy tokens
  equal to the CPU's (f32); the launches of the path counted exactly.
"""

import pytest
import torch

from trtllm_llama_tpu_torch.ops.kernels import prefill_attention as pa
from trtllm_llama_tpu_torch.ops.kernels import (
    streaming_prefill_attention as spa,
)

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7,
       torch.float16: 2.0 ** -10}


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _rel(got, ref):
    got, ref = got.float().cpu(), ref.float().cpu()
    assert torch.isfinite(got).all()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


KERNELS = {"row10": (pa, "prefill_attention_kernel"),
           "row12": (spa, "streaming_prefill_attention_kernel")}


@pytest.mark.parametrize("alibi", [False, True], ids=["plain", "alibi"])
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=str)
@pytest.mark.parametrize("row", ["row10", "row12"])
def test_noncausal_kernel_matches_plain(row, dtype, d, group, alibi):
    _need_cuda()
    from trtllm_llama_tpu_torch.ops.attention import alibi_slopes
    mod, attr = KERNELS[row]
    fn, plain = getattr(mod, attr), getattr(mod, attr + "_plain")
    g = torch.Generator(device="cuda").manual_seed(d + group)
    b, s, hkv = 3, 200, 2
    hq = hkv * group
    q = torch.randn((b, s, hq, d), generator=g, device="cuda").to(dtype)
    k, v = (torch.randn((b, s, hkv, d), generator=g, device="cuda").to(dtype)
            for _ in range(2))
    lens = torch.tensor([s, 77, 0], dtype=torch.int32, device="cuda")
    slopes = alibi_slopes(hq, device="cuda") if alibi else None
    launches, noncausal = fn.launches, fn.noncausal_launches
    got = fn(q, k, v, lens, alibi=slopes, causal=False)
    torch.cuda.synchronize()
    assert (fn.launches, fn.noncausal_launches) == (launches + 1,
                                                    noncausal + 1)
    ref = plain(q, k, v, lens, alibi=slopes, causal=False)
    assert _rel(got, ref) <= TOL[dtype]
    # the length-0 row averages V over all S
    mean = v[2].float().mean(0).repeat_interleave(group, 0)
    assert _rel(got[2, 0], mean) <= max(TOL[dtype], 1e-5) * 4
    fn(q, k, v, lens, alibi=slopes)
    assert (fn.launches, fn.noncausal_launches) == (launches + 2,
                                                    noncausal + 1)


@pytest.mark.parametrize("s", [64, 130, 2049])
@pytest.mark.parametrize("row", ["row10", "row12"])
def test_noncausal_full_length_shapes(row, s):
    """B=1, all rows valid (no seq_lens), 32 heads of 128 bf16: the
    ChatGLM context's shape at S on and off the tile."""
    _need_cuda()
    mod, attr = KERNELS[row]
    g = torch.Generator(device="cuda").manual_seed(s)
    q, k, v = (torch.randn((1, s, 32, 128), generator=g, device="cuda"
                           ).to(torch.bfloat16) for _ in range(3))
    got = getattr(mod, attr)(q, k, v, causal=False)
    ref = getattr(mod, attr + "_plain")(q, k, v, causal=False)
    assert _rel(got, ref) <= TOL[torch.bfloat16]


def _glm(dtype):
    from trtllm_llama_tpu_torch.convert.hf_chatglm import config_from_chatglm
    from trtllm_llama_tpu_torch.models import chatglm
    cfg = config_from_chatglm(num_layers=2, hidden_size=512, num_heads=4,
                              vocab_size=512, max_positions=256, dtype=dtype)
    return cfg, chatglm.init_params(cfg, seed=0, device="cpu")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chatglm_on_the_card_matches_the_cpu(dtype):
    _need_cuda()
    from trtllm_llama_tpu_torch.config import EngineConfig
    from trtllm_llama_tpu_torch.models import chatglm
    from trtllm_llama_tpu_torch.runtime.sampling import SamplingConfig
    from trtllm_llama_tpu_torch.runtime.session import GenerationSession
    cfg, params = _glm(dtype)
    ids = torch.randint(3, 500, (2, 70), generator=torch.Generator()
                        .manual_seed(1), dtype=torch.int32)
    lens = torch.tensor([70, 33], dtype=torch.int32)
    logits = {}
    for dev in ("cpu", "cuda"):
        p = _to(params, dev)
        before = pa.prefill_attention_kernel.noncausal_launches
        out, _ = chatglm.forward_prefill(
            p, cfg, ids.to(dev), lens.to(dev),
            chatglm.init_caches(cfg, 2, 128, dev), return_all_logits=True)
        logits[dev] = out.float().cpu()
        assert pa.prefill_attention_kernel.noncausal_launches - before == (
            cfg.num_layers if dev == "cuda" else 0)
    assert _rel(logits["cuda"], logits["cpu"]) <= (
        1e-4 if dtype == "float32" else 3e-2)
    if dtype == "float32":
        prompts = [ids[0, :70].tolist(), ids[1, :33].tolist()]
        ecfg = EngineConfig(max_batch_size=2, max_input_len=128,
                            max_seq_len=160)
        toks = [GenerationSession(cfg, params, ecfg, device=dev,
                                  model=chatglm).generate(
            prompts, sampling=SamplingConfig(end_id=-1),
            max_new_tokens=8).output_ids for dev in ("cpu", "cuda")]
        assert (toks[0] == toks[1]).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bert_on_the_card_matches_the_cpu(dtype):
    _need_cuda()
    from trtllm_llama_tpu_torch.models import bert
    from trtllm_llama_tpu_torch.runtime.single_shot import InferenceSession
    cfg = bert.BertConfig(vocab_size=512, hidden_size=256, num_layers=2,
                          num_heads=4, intermediate_size=1024,
                          max_position_embeddings=128, dtype=dtype)
    params = bert.init_params(cfg, seed=0, device="cpu", qa_head=True)
    gen = torch.Generator().manual_seed(2)
    ids = torch.randint(0, 512, (4, 100), generator=gen, dtype=torch.int32)
    # the token types of the bucket's 128 rows (the session pads ids only)
    types = torch.randint(0, 2, (4, 128), generator=gen, dtype=torch.int32)
    lens = torch.tensor([100, 64, 7, 1], dtype=torch.int32)
    outs = {}
    for dev in ("cpu", "cuda"):
        sess = InferenceSession(bert.forward_qa, cfg, params, pad_axis=1,
                                buckets=(128,), device=dev)
        before = pa.prefill_attention_kernel.noncausal_launches
        start, end = sess.warmup(ids, lens, types)
        outs[dev] = torch.stack([start, end]).float().cpu()
        assert pa.prefill_attention_kernel.noncausal_launches - before == (
            cfg.num_layers if dev == "cuda" else 0)
    assert _rel(outs["cuda"], outs["cpu"]) <= (
        1e-4 if dtype == "float32" else 3e-2)
