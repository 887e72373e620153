"""Sampling (the port's `runtime/sampling.py`): greedy with min_length.

Stochastic sampling, penalties, bad words and stop words are not ported
yet; `check_supported` raises for them so no request quietly takes a
different path than it asked for.
"""

from __future__ import annotations

import dataclasses

import torch

NEG_INF = -1e9


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """Same fields and defaults as the JAX package's SamplingConfig."""

    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 0.0
    repetition_penalty: float = 1.0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    min_length: int = 0
    end_id: int = 2                  # LLaMA </s>
    pad_id: int = 0
    beam_width: int = 1
    length_penalty: float = 0.0
    bad_words: tuple = ()
    stop_words: tuple = ()

    @property
    def is_greedy(self) -> bool:
        return (self.top_k in (0, 1)) and self.top_p == 0.0

    def check_supported(self) -> None:
        unported = {
            "stochastic sampling": not self.is_greedy,
            "penalties": (self.repetition_penalty != 1.0
                          or self.presence_penalty != 0.0
                          or self.frequency_penalty != 0.0),
            "bad/stop words": bool(self.bad_words or self.stop_words),
            "beam search": self.beam_width > 1,
        }
        missing = [k for k, v in unported.items() if v]
        if missing:
            raise NotImplementedError(
                f"not ported yet: {', '.join(missing)} (greedy only)")


def apply_min_length(logits, cur_lens, min_length: int, end_id: int):
    """Ban end_id until min_length tokens were generated."""
    ban = torch.where(cur_lens < min_length, NEG_INF, 0.0).to(logits.dtype)
    logits = logits.clone()
    logits[:, end_id] += ban
    return logits


def sample_step(logits, cfg: SamplingConfig, cur_lens=None):
    """One greedy step. logits [B, V] -> tokens [B] int32."""
    cfg.check_supported()
    logits = logits.float()
    if cfg.min_length > 0 and cur_lens is not None:
        logits = apply_min_length(logits, cur_lens, cfg.min_length, cfg.end_id)
    return torch.argmax(logits, dim=-1).to(torch.int32)
