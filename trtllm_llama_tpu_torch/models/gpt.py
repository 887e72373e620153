"""GPT-2 family (the port's `models/gpt.py`).

The reference's GPTLMHeadModel (models/gpt/model.py), as the JAX package
has it: pre-norm LayerNorm blocks with biases (eps 1e-5), multi-head
attention with learned absolute positions, a GELU MLP (the tanh
approximation, in f32) and an lm_head tied to the embedding (stored as its
transpose). It is one `models/decoder.py` block: the `ArchSpec` GPT_SPEC,
so the attention runs rows 10 / 12 (prefill) and kernel 3 or the
`decode_attn_mode` kernel (decode), the projections `ops.linear.dense`
with any container `quantize_params` makes, and the KV cache is llama's
stacked `KVCache`.

Prompt tuning (the reference's use_prompt_tuning, models/gpt/model.py:
39-67): `forward_prefill(..., prompt=PromptTuning(table, tasks,
task_vocab_size))` reads virtual ids (>= vocab_size) from the task's
block of the prompt table (`ops.linear.prompt_tuning_lookup`). Only the
context phase sees virtual ids (sampled tokens are real vocabulary), so
decode needs no plumbing.

The module-level functions follow the model contract of
`models/__init__.py` (`GenerationSession(..., model=gpt)`, or
`cfg.architecture` "gpt" / "gpt2").
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .decoder import ArchSpec, DecoderFamily


class PromptTuning(NamedTuple):
    """Prompt-tuning inputs: table [num_tasks * task_vocab_size, D], tasks
    [B] (each sequence's task), task_vocab_size (an int or a 0-d
    tensor)."""

    table: torch.Tensor
    tasks: torch.Tensor
    task_vocab_size: torch.Tensor


GPT_SPEC = ArchSpec("gpt", learned_pos=True, act="gelu_tanh", ln_eps=1e-5)
GPT = DecoderFamily(GPT_SPEC)

init_params = GPT.init_params
init_caches = GPT.init_caches
rope_tables = GPT.rope_tables          # None: learned positions, no rotary
forward_prefill = GPT.forward_prefill
forward_extend = GPT.forward_extend
forward_decode = GPT.forward_decode

__all__ = ["GPT", "GPT_SPEC", "PromptTuning", "init_params", "init_caches",
           "rope_tables", "forward_prefill", "forward_extend",
           "forward_decode"]
