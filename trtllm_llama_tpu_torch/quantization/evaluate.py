"""A copy workload for speculative decoding (the port's
`quantization/evaluate.py`, `make_copy_params` alone so far).

Random weights never copy: their greedy continuation of a periodic prompt
is not periodic, so prompt lookup accepts nothing and a random draft
almost nothing. `make_copy_params` keeps the model's full weight traffic
and compute but makes greedy decoding emit a fixed cycle of tokens, so
speculation can accept every proposal on a model of real size.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import ModelConfig
from .tensors import FP8Weight, SQWeight, WOQWeight


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
    `make_copy_params`. The output side of every residual block (wo and
    w_down) writes zero, so the residual stream is the token's embedding;
    the lm_head is rebuilt, in the embedding's dtype, so that greedy
    decoding emits each token's successor in `cycle`:

        lm_head[:, cycle[i + 1 mod len]] = embed[cycle[i]] * gain

    With near-orthogonal random embedding rows the successor leads by
    about sqrt(hidden_size) times the gain. A prompt that repeats the cycle
    then continues it, and prompt lookup proposes exactly that. Works for
    compute-dtype weights and every quantized container; the other leaves
    are shared with `params`."""
    layers = dict(params["layers"])
    for name in ("wo", "w_down"):
        layers[name] = _zero_out(layers[name])
    embed = params["embed"]
    lm = torch.zeros((cfg.hidden_size, cfg.vocab_size), dtype=torch.float32,
                     device=embed.device)
    for i, t in enumerate(cycle):     # in order: a repeated token's last wins
        lm[:, cycle[(i + 1) % len(cycle)]] = embed[t].float() * gain
    return {**params, "layers": layers, "lm_head": lm.to(embed.dtype)}
