"""Accuracy of each QuantMode against the f32 golden model, and workloads
for speculation (the port's `quantization/evaluate.py`).

The reference validates every quantized engine with a real-weights ROUGE
run (examples/llama/summarize.py; the README.md:894-918 table). With no
LLaMA checkpoint at hand, this module measures the same contract one level
down: how far a quantized engine's distribution moves from its own f32
params, at golden-model scale, on the engine's own code paths:

  * prefill: all-position logits through `models.llama.forward_prefill`
    (the quantized matmuls, the KV cache *write*);
  * decode: teacher-forced `forward_decode` steps over a continuation the
    f32 model generated greedily (decode attention and the quantized KV
    cache *read*, where KV quantization error lands).

Every function runs on `device` (default the card): the params live
there, the ids are uploaded there, and the logits come back as numpy.
The metrics are `utils/accuracy.py`'s.

`build_golden_setup` builds a random-weight HF `LlamaForCausalLM` in the
process and calibrates it. Its calibration "tokenizer" seeds each text's
ids from `zlib.crc32` of the text: the JAX package seeds them from
Python's `hash`, which differs between processes unless PYTHONHASHSEED is
set, so its ranges and KV scales change from run to run.

`structure_weights` gives random-init projections trained-like statistics
(so the loosest formats can be gated at depth), in two parts: the draws
(`structure_draws`, from a torch.Generator) and the transform
(`structure_transform`). `make_copy_params` makes a copy workload on which
speculative decoding accepts every proposal.
"""

from __future__ import annotations

import dataclasses
import math
import zlib

import numpy as np
import torch

from ..config import ModelConfig
from ..device import resolve_device
from ..models import llama
from ..utils.accuracy import logit_metrics, ppl_ratio
from .mode import QuantMode
from .quantize import quantize_params
from .tensors import FP8Weight, SQWeight, WOQWeight


def build_golden_setup(hidden: int = 256, layers: int = 4, heads: int = 8,
                       intermediate: int = 512, vocab: int = 512,
                       init_range: float = 0.06, seed: int = 0,
                       calib_samples: int = 6, device="cuda"):
    """A random-weight golden-scale LLaMA and its calibration, on `device`.

    The HF model is built in the process (torch.manual_seed(seed), then the
    transformers LlamaForCausalLM of these sizes under `device`), its f32
    params taken by `convert/hf.py`, and its activation ranges and int8 KV
    scales by `quantization/calibrate.py` over `calib_samples` synthetic
    texts of 48 ids each. init_range is above HF's 0.02 default so that
    the logits spread as at real depth and top-1 agreement means something.

    Returns (cfg_fp32, params_fp32, act_ranges, kv_scales, hf_model)."""
    from transformers import LlamaConfig, LlamaForCausalLM

    from ..convert.hf import params_from_hf_model
    from .calibrate import (act_ranges_for_smoothquant,
                            capture_activation_ranges, kv_scales_from_ranges)

    device = resolve_device(device)
    torch.manual_seed(seed)
    hf_cfg = LlamaConfig(
        vocab_size=vocab, hidden_size=hidden, intermediate_size=intermediate,
        num_hidden_layers=layers, num_attention_heads=heads,
        num_key_value_heads=heads, max_position_embeddings=256,
        initializer_range=init_range, tie_word_embeddings=False)
    with torch.device(device):
        hf_model = LlamaForCausalLM(hf_cfg).eval()
    cfg = ModelConfig.from_hf_config(hf_cfg, dtype="float32")
    params = params_from_hf_model(hf_model, cfg)

    class _IdTok:
        """Calibration 'tokenizer' over a synthetic corpus: the text seeds
        its ids (by a digest that every process computes alike)."""

        def __call__(self, text, **kw):
            rng = np.random.default_rng(zlib.crc32(text.encode()))
            ids = rng.integers(3, vocab, (1, 48))
            return {"input_ids": torch.tensor(ids)}

    texts = [f"calib-{i}" for i in range(calib_samples)]
    ranges = capture_activation_ranges(hf_model, _IdTok(), texts)
    act_ranges = act_ranges_for_smoothquant(ranges)
    kv_scales = kv_scales_from_ranges(ranges)
    return cfg, params, act_ranges, kv_scales, hf_model


def _prefill(cfg, params, prompt_ids, max_len, kv_scales, device,
             return_all_logits=False):
    b, s = prompt_ids.shape
    caches = llama.init_caches(cfg, b, max_len, device, kv_scales)
    lens = torch.full((b,), s, dtype=torch.int32, device=device)
    ids = torch.as_tensor(np.asarray(prompt_ids), dtype=torch.int32,
                          device=device)
    logits, caches = llama.forward_prefill(
        params, cfg, ids, lens, caches, return_all_logits=return_all_logits)
    return logits, caches, lens


def greedy_continuation(cfg: ModelConfig, params, prompt_ids: np.ndarray,
                        cont_len: int, kv_scales=None,
                        device="cuda") -> np.ndarray:
    """Greedy-decode cont_len tokens with the given params (on `device`)
    after prompt_ids [B, S]; returns int [B, cont_len]."""
    device = resolve_device(device)
    s = prompt_ids.shape[1]
    with torch.inference_mode():
        logits, caches, lens = _prefill(cfg, params, prompt_ids,
                                        s + cont_len + 1, kv_scales, device)
        tok = logits.argmax(-1).to(torch.int32)
        out = []
        for i in range(cont_len):
            out.append(tok)
            logits, caches = llama.forward_decode(params, cfg, tok, lens + i,
                                                  caches)
            tok = logits.argmax(-1).to(torch.int32)
        return torch.stack(out, dim=1).cpu().numpy()


def teacher_forced_logits(cfg: ModelConfig, params, prompt_ids: np.ndarray,
                          cont_ids: np.ndarray, kv_scales=None,
                          device="cuda"):
    """Prefill the prompt, then decode cont_ids teacher-forced.

    Returns numpy f32 (prefill_logits [B, S, V], decode_logits [B, C, V]):
    decode_logits[:, i] is the distribution after consuming cont_ids[:, i]
    (predicting cont_ids[:, i + 1])."""
    device = resolve_device(device)
    s, c = prompt_ids.shape[1], cont_ids.shape[1]
    with torch.inference_mode():
        pre, caches, lens = _prefill(cfg, params, prompt_ids, s + c + 1,
                                     kv_scales, device, return_all_logits=True)
        cont = torch.as_tensor(np.asarray(cont_ids), dtype=torch.int32,
                               device=device)
        dec = []
        for i in range(c):
            logits, caches = llama.forward_decode(params, cfg, cont[:, i],
                                                  lens + i, caches)
            dec.append(logits)
        return pre.cpu().numpy(), torch.stack(dec, dim=1).cpu().numpy()


def reference_run(cfg_fp: ModelConfig, params_fp, prompt_ids: np.ndarray,
                  cont_len: int, device="cuda"):
    """The f32 greedy continuation and its teacher-forced logits: the
    reference side shared by every quant mode's evaluation."""
    cont = greedy_continuation(cfg_fp, params_fp, prompt_ids, cont_len,
                               device=device)
    ref_pre, ref_dec = teacher_forced_logits(cfg_fp, params_fp, prompt_ids,
                                             cont, device=device)
    return cont, ref_pre, ref_dec


def evaluate_quant_mode(cfg_fp: ModelConfig, params_fp, mode_name: str,
                        quant_mode: QuantMode, prompt_ids: np.ndarray,
                        act_ranges=None, kv_scales=None,
                        group_size: int = 0, cont_len: int = 12,
                        ref_run=None, device="cuda") -> dict:
    """Quantize params_fp under quant_mode and measure the logit and
    perplexity shift against the f32 model: the JAX package's metrics row
    {mode, prefill_top1, prefill_kl, decode_top1, decode_kl, ppl_ratio,
    max_abs_err}.

    kv_scales: the calibrated int8 KV scales (amax / 127); an fp8 KV cache
    takes them rescaled to amax / 448. ref_run: an earlier
    reference_run(...) to share between modes of one model."""
    if ref_run is None:
        ref_run = reference_run(cfg_fp, params_fp, prompt_ids, cont_len,
                                device)
    cont, ref_pre, ref_dec = ref_run
    qparams = quantize_params(params_fp, quant_mode, group_size=group_size,
                              act_ranges=act_ranges)
    cfg_q = dataclasses.replace(cfg_fp, quant_mode=quant_mode)
    q_kv = kv_scales if quant_mode.has_int8_kv_cache() else None
    if quant_mode.has_fp8_kv_cache() and kv_scales is not None:
        q_kv = np.asarray(kv_scales) * (127.0 / 448.0)
    test_pre, test_dec = teacher_forced_logits(
        cfg_q, qparams, prompt_ids, cont, kv_scales=q_kv, device=device)
    pre = logit_metrics(ref_pre, test_pre)
    dec = logit_metrics(ref_dec, test_dec)
    # the decode phase's ppl on the f32 model's own continuation: positions
    # 0..c-2 predict cont[1..c-1]
    ratio = ppl_ratio(ref_dec[:, :-1], test_dec[:, :-1], cont[:, 1:])
    return {
        "mode": mode_name,
        "prefill_top1": pre["top1_agree"], "prefill_kl": pre["kl"],
        "decode_top1": dec["top1_agree"], "decode_kl": dec["kl"],
        "ppl_ratio": ratio,
        "max_abs_err": max(pre["max_abs_err"], dec["max_abs_err"]),
    }


def structure_draws(params, rank: int = 32, channel_sigma: float = 0.5,
                    outlier_frac: float = 0.005, outlier_gain: float = 6.0,
                    seed: int = 0):
    """The random part of `structure_weights`: for each stacked projection
    ([L, K, N] tensor of params["layers"], in the dict's order) a tuple
    (u [L, K, rank], v [L, rank, N], c [L, 1, N]) of f32 tensors on the
    weight's device: u and v standard normal, c = exp(channel_sigma * n)
    with n standard normal, times outlier_gain on the channels where a
    uniform draw falls below outlier_frac. One torch.Generator seeded with
    `seed` on the first projection's device draws them all (the JAX
    package draws from split jax.random keys: the streams differ)."""
    gen = None
    draws = {}
    for name, w in params["layers"].items():
        if not (isinstance(w, torch.Tensor) and w.dim() == 3):
            continue
        if gen is None:
            gen = torch.Generator(device=w.device).manual_seed(seed)
        n_l, k, n = w.shape

        def normal(shape):
            return torch.randn(shape, generator=gen, device=w.device)

        u, v = normal((n_l, k, rank)), normal((n_l, rank, n))
        c = torch.exp(channel_sigma * normal((n_l, 1, n)))
        mask = torch.rand((n_l, 1, n), generator=gen,
                          device=w.device) < outlier_frac
        draws[name] = (u, v, torch.where(mask, c * outlier_gain, c))
    return draws


def structure_transform(w, u, v, c, rho: float = 0.6):
    """The pure part of `structure_weights` for one [L, K, N] weight:

        W' = normalize(sqrt(1 - rho) W + sqrt(rho) U V / sqrt(r) * std(W)) * c

    renormalised per layer to ||W||_F, in w's dtype (f32 inside)."""
    w_f = w.float()
    std = w_f.std(dim=(-2, -1), keepdim=True, unbiased=False)
    low = torch.einsum("lkr,lrn->lkn", u, v) / math.sqrt(u.shape[-1])
    mixed = (math.sqrt(1.0 - rho) * w_f + math.sqrt(rho) * low * std) * c
    norm0 = w_f.square().sum(dim=(-2, -1), keepdim=True).sqrt()
    norm1 = mixed.square().sum(dim=(-2, -1), keepdim=True).sqrt()
    return (mixed * norm0 / norm1.clamp_min(1e-9)).to(w.dtype)


def structure_weights(params, rank: int = 32, rho: float = 0.6,
                      channel_sigma: float = 0.5,
                      outlier_frac: float = 0.005, outlier_gain: float = 6.0,
                      seed: int = 0, draws=None):
    """Trained-like statistics on random-init projections, so that int4 and
    fp8 can be gated at depth (the JAX package's `structure_weights`).

    Trained weights concentrate their energy in a low-dimensional subspace
    and spread their per-channel scales over about an order of magnitude,
    with sparse outlier channels; iid random weights have neither, so int4
    rounding noise collapses a random model at depth and a gate on it
    asserts nothing. Each projection keeps its shape and Frobenius norm
    while mixing in a rank-`rank` component (a share rho of the energy)
    and log-normal channel scales with outliers (`structure_transform` on
    `structure_draws`, or on the `draws` given). Other leaves are shared."""
    if draws is None:
        draws = structure_draws(params, rank, channel_sigma, outlier_frac,
                                outlier_gain, seed)
    layers = {name: (structure_transform(w, *draws[name], rho=rho)
                     if name in draws else w)
              for name, w in params["layers"].items()}
    return {**params, "layers": layers}


def _zero_out(w):
    """The weight with a zero output: zero dequant scales for quantized
    containers (the codes are still read), zeros for a tensor."""
    if isinstance(w, (WOQWeight, FP8Weight)):
        return dataclasses.replace(w, scale=torch.zeros_like(w.scale))
    if isinstance(w, SQWeight):
        return dataclasses.replace(w, scale_w=torch.zeros_like(w.scale_w))
    return torch.zeros_like(w)


def make_copy_params(cfg: ModelConfig, params, cycle, gain: float = 4.0):
    """The params of a teacher-forced copy model, as the JAX package's
    `make_copy_params`. Random weights never copy: their greedy
    continuation of a periodic prompt is not periodic, so prompt lookup
    accepts nothing. Here the output side of every residual block (wo and
    w_down) writes zero, so the residual stream is the token's embedding;
    the lm_head is rebuilt, in the embedding's dtype, so that greedy
    decoding emits each token's successor in `cycle`:

        lm_head[:, cycle[i + 1 mod len]] = embed[cycle[i]] * gain

    With near-orthogonal random embedding rows the successor leads by
    about sqrt(hidden_size) times the gain. A prompt that repeats the cycle
    then continues it, and prompt lookup proposes exactly that. The model
    keeps its full weight traffic and compute. Works for compute-dtype
    weights and every quantized container; the other leaves are shared
    with `params`."""
    layers = dict(params["layers"])
    for name in ("wo", "w_down"):
        layers[name] = _zero_out(layers[name])
    embed = params["embed"]
    lm = torch.zeros((cfg.hidden_size, cfg.vocab_size), dtype=torch.float32,
                     device=embed.device)
    for i, t in enumerate(cycle):     # in order: a repeated token's last wins
        lm[:, cycle[(i + 1) % len(cycle)]] = embed[t].float() * gain
    return {**params, "layers": layers, "lm_head": lm.to(embed.dtype)}
