"""The port's sampling and beam search on the card.

Marked `cuda`; every test skips without a CUDA device. On a machine with
one (which need not have JAX), run:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_sampling.py

- The sampler on the card against the same functions on the CPU with the
  same noise (`gumbel_noise` fed one CPU-drawn tensor): identical tokens
  for `sample_step` and `sample_step_slots` at LLaMA's vocabulary; the
  filtered logits equal bit for bit except where a top-p decision lies
  within float rounding of the cut (exp and the cumulative sum round
  differently on the two devices).
- Seeded determinism: a device generator's noise and a sampled generate
  repeat under the same seed.
- No host sync: a sampled step (penalties, min length, bad words over a
  tail, stop words, counts, the draw, logprobs; the per-slot sampler too)
  runs under `torch.cuda.set_sync_debug_mode("error")`.
- A tiny beam search on the card, dense against `beam_paged_block`.
"""

import numpy as np
import pytest
import torch

from trtllm_llama_tpu_torch.runtime import sampling as ts

pytestmark = pytest.mark.cuda

V = 32000


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _logits(b, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((b, V), generator=g) * 4


def _counts(b, seed):
    g = torch.Generator().manual_seed(seed)
    c = torch.randint(0, 3, (b, V), generator=g, dtype=torch.int32)
    return torch.where(torch.rand((b, V), generator=g) < 0.99, 0, c)


@pytest.fixture
def fixed_noise(monkeypatch):
    """gumbel_noise returning one CPU-drawn tensor, moved to the
    generator's device."""
    noise, draw = {}, ts.gumbel_noise

    def fake(shape, generator):
        if shape not in noise:
            noise[shape] = draw(shape,
                                torch.Generator().manual_seed(len(noise)))
        return noise[shape].to(generator.device)
    monkeypatch.setattr(ts, "gumbel_noise", fake)


CONFIGS = [dict(temperature=0.8, top_k=40, top_p=0.95,
                repetition_penalty=1.1, end_id=-1),
           dict(top_p=0.9, min_length=3, presence_penalty=0.5, end_id=7),
           dict(temperature=1.3, top_k=5, frequency_penalty=0.2)]


@pytest.mark.parametrize("kw", CONFIGS, ids=["t0.8-k40-p0.95", "p0.9",
                                             "t1.3-k5"])
def test_sample_step_on_card_equals_cpu(dev, fixed_noise, kw):
    cfg = ts.SamplingConfig(**kw)
    x, c = _logits(8, 0), _counts(8, 1)
    lens = torch.arange(8, dtype=torch.int32)
    want = ts.sample_step(x, cfg, torch.Generator(), c, lens)
    got = ts.sample_step(x.to(dev), cfg, torch.Generator(device=dev),
                         c.to(dev), lens.to(dev))
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), want)


def _slot_params(device):
    p = ts.SlotSamplingParams.neutral(6, 2, 3, device)
    for slot, cfg in enumerate([
            ts.SamplingConfig(temperature=0.7, top_k=50),
            ts.SamplingConfig(top_p=0.9, repetition_penalty=1.2),
            ts.SamplingConfig(top_k=1, top_p=0.5, min_length=3,
                              bad_words=((7,), (5, 9))),
            ts.SamplingConfig(temperature=0.0, top_k=12,
                              bad_words=((1, 2, 3),)),
            ts.SamplingConfig(presence_penalty=0.3)]):
        p = p.set_slot(slot, cfg)
    return p


def test_sample_step_slots_on_card_equals_cpu(dev, fixed_noise):
    x, c = _logits(6, 2), _counts(6, 3)
    gen = torch.tensor([0, 1, 2, 2, 5, 7], dtype=torch.int32)
    tail = torch.tensor([[-2, -2], [4, 4], [8, 5], [1, 2], [0, 0], [3, 3]],
                        dtype=torch.int32)
    want = ts.sample_step_slots(x, _slot_params("cpu"), torch.Generator(), c,
                                gen, 3, tail)
    got = ts.sample_step_slots(x.to(dev), _slot_params(dev),
                               torch.Generator(device=dev), c.to(dev),
                               gen.to(dev), 3, tail.to(dev))
    assert torch.equal(got.cpu(), want)
    # the filtered logits: bit-equal away from the top-p cut
    p = _slot_params("cpu")
    f_cpu = ts.transform_slots(x, p)
    f_dev = ts.transform_slots(x.to(dev), _slot_params(dev)).cpu()
    differ = f_cpu != f_dev
    assert not (differ & ~_near_top_p_cut(x, p)).any()


def _near_top_p_cut(x, p):
    """[S, V] bool: entries whose top-p decision is within float rounding
    of the cut: the f64 mass of the logits before them (x / t, sorted
    descending) within V x 2**-24 (a bound on an f32 sum's error over V
    terms of total 1) of p (1.0 for a slot without top-p)."""
    t = torch.where(p.temperature > 0, p.temperature, 1.0).double()
    z = x.double() / t[:, None]
    p_eff = torch.where((p.top_p > 0) & (p.top_p < 1), p.top_p,
                        1.0).double()[:, None]
    zs, order = torch.sort(z, dim=-1, descending=True, stable=True)
    probs = torch.softmax(zs, -1)
    before = torch.cumsum(probs, -1) - probs
    near_sorted = (before - p_eff).abs() < z.shape[-1] * 2.0 ** -24
    return torch.zeros_like(near_sorted).scatter(1, order, near_sorted)


def test_seeded_noise_and_generate_repeat_on_card(dev):
    a = ts.gumbel_noise((4, V), torch.Generator(device=dev).manual_seed(5))
    b = ts.gumbel_noise((4, V), torch.Generator(device=dev).manual_seed(5))
    assert a.device.type == "cuda" and torch.equal(a, b)
    assert torch.isfinite(a).all()
    sess = _tiny_session(dev)
    scfg = ts.SamplingConfig(temperature=0.9, top_k=20, top_p=0.9,
                             repetition_penalty=1.1, end_id=-1)

    def run(seed):
        return sess.generate([[5, 6, 7, 8], [9, 10]], sampling=scfg,
                             max_new_tokens=12, seed=seed,
                             return_logprobs=True)
    x, y, z = run(1), run(1), run(2)
    np.testing.assert_array_equal(x.output_ids, y.output_ids)
    np.testing.assert_array_equal(x.logprobs, y.logprobs)
    assert not np.array_equal(x.output_ids, z.output_ids)


def test_sampled_step_makes_no_host_sync(dev):
    x, c = _logits(4, 4).to(dev), _counts(4, 5).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    cfg = ts.SamplingConfig(temperature=0.8, top_k=40, top_p=0.95,
                            repetition_penalty=1.1, presence_penalty=0.2,
                            frequency_penalty=0.1, min_length=4, end_id=2,
                            bad_words=((3, 4), (9,)), stop_words=((5, 6),))
    tail = torch.tensor([[1, 3], [3, 4], [5, 6], [0, 3]], dtype=torch.int32,
                        device=dev)
    lens = torch.full((4,), 2, dtype=torch.int32, device=dev)
    p = _slot_params(dev)
    x6, c6 = _logits(6, 6).to(dev), _counts(6, 7).to(dev)
    lens6 = torch.arange(6, dtype=torch.int32, device=dev)
    tail6 = torch.randint(0, 10, (6, 2), dtype=torch.int32, device=dev)
    ids = torch.randint(0, V, (4, 9), dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        banned = ts.apply_bad_words(x, tail, cfg.bad_words)
        tok = ts.sample_step(banned, cfg, gen, c, lens)
        lp = torch.log_softmax(x, -1).gather(1, tok.long()[:, None])
        ts.update_token_counts(c, tok)
        tail = ts.update_tail(tail, tok)
        done = ts.stop_words_matched(tail, cfg.stop_words) | (tok == 2)
        slots = ts.sample_step_slots(x6, p, gen, c6, lens6, 2, tail6)
        ts.init_token_counts(ids, lens, V)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert tok.shape == (4,) and lp.shape == (4, 1) and done.shape == (4,)
    assert slots.shape == (6,)


def _tiny_session(dev, block=0):
    from trtllm_llama_tpu_torch import EngineConfig, ModelConfig
    from trtllm_llama_tpu_torch.quantization.quantize import (
        init_random_quantized_params,
    )
    from trtllm_llama_tpu_torch.runtime.session import GenerationSession
    cfg = ModelConfig.tiny(dtype="bfloat16")
    return GenerationSession(
        cfg, init_random_quantized_params(cfg, seed=0, device=dev),
        EngineConfig(max_batch_size=8, max_input_len=16, max_seq_len=64),
        device=dev, beam_paged_block=block)


@pytest.mark.parametrize("width", [2, 4])
def test_tiny_beam_dense_equals_paged_on_card(dev, width):
    scfg = ts.SamplingConfig(beam_width=width, length_penalty=1.0, end_id=-1)
    prompts = [[5, 17, 99, 3, 250, 8], [200, 4, 66]]
    dense = _tiny_session(dev).generate(prompts, sampling=scfg,
                                        max_new_tokens=10)
    paged = _tiny_session(dev, 8).generate(prompts, sampling=scfg,
                                           max_new_tokens=10)
    assert dense.beam_ids.shape == (2, width, 10)
    np.testing.assert_array_equal(dense.beam_ids, paged.beam_ids)
    np.testing.assert_array_equal(dense.beam_lengths, paged.beam_lengths)
    np.testing.assert_allclose(dense.beam_scores, paged.beam_scores,
                               rtol=1e-5)
