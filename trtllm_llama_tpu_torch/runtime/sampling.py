"""Sampling (the port's `runtime/sampling.py`): penalties, min length, bad
words, temperature / top-k / top-p, the draw, stop words.

The JAX package's decode post-processing stack, operation for operation:
penalties, then min length, then (bad words,) temperature, top-k, top-p,
then the draw. Thresholds compare by value (`logits < kth`, `logits <
thresh`), so ties with the k-th or the top-p logit are kept; masked
entries are NEG_INF (-1e9), not -inf; divisions are true divisions.

The draw is the Gumbel-max trick as `jax.random.categorical` draws:
argmax(logits + g), g = -log(-log(u)), u uniform in [finfo(f32).tiny, 1).
The noise comes from `gumbel_noise` alone, once per sampled step, on the
caller's device generator. Every function here is stock torch ops on the
logits' device (the JAX package samples on stock XLA too): no host sync,
no copy to the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

NEG_INF = -1e9
_TINY = float(torch.finfo(torch.float32).tiny)


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """Same fields and defaults as the JAX package's SamplingConfig."""

    temperature: float = 1.0
    top_k: int = 0                   # 0 => disabled (greedy if top_p also 0)
    top_p: float = 0.0               # 0 => disabled
    repetition_penalty: float = 1.0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    min_length: int = 0
    end_id: int = 2                  # LLaMA </s>
    pad_id: int = 0
    beam_width: int = 1              # > 1 => beam search (runtime/beam.py)
    length_penalty: float = 0.0      # beam-search length normalization alpha
    bad_words: tuple = ()            # token-id tuples, e.g. ((12,), (7, 9))
    stop_words: tuple = ()

    @property
    def tail_len(self) -> int:
        """History window needed for bad / stop word matching."""
        return max((len(w) for w in self.bad_words + self.stop_words),
                   default=0)

    @property
    def is_greedy(self) -> bool:
        return (self.top_k in (0, 1)) and self.top_p == 0.0

    @property
    def has_penalties(self) -> bool:
        return (self.repetition_penalty != 1.0 or self.presence_penalty != 0.0
                or self.frequency_penalty != 0.0)


def gumbel_noise(shape, generator: torch.Generator) -> torch.Tensor:
    """f32 Gumbel noise of `shape` on the generator's device: -log(-log(u)),
    u uniform in [tiny, 1) (JAX's `random.gumbel`, mode "low")."""
    u = torch.rand(shape, generator=generator, device=generator.device,
                   dtype=torch.float32)
    return -torch.log(-torch.log(u.clamp_min(_TINY)))


def _div(logits, value: float):
    """logits / value by true division on every device (CUDA divides by a
    host scalar through its reciprocal)."""
    return logits / logits.new_full((), value)


def _softmax(x):
    """jax.nn.softmax over the last axis: exp(x - max) / sum."""
    e = torch.exp(x - x.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def apply_repetition_penalty(logits, token_counts, repetition_penalty,
                             presence_penalty=0.0, frequency_penalty=0.0):
    """CTRL-style repetition penalty (seen tokens' logits divided if > 0,
    multiplied if < 0), presence (a constant for seen tokens) and frequency
    (count-proportional) penalties. token_counts: [B, V] int32."""
    seen = token_counts > 0
    if repetition_penalty != 1.0:
        penalized = torch.where(logits > 0, _div(logits, repetition_penalty),
                                logits * repetition_penalty)
        logits = torch.where(seen, penalized, logits)
    if presence_penalty != 0.0:
        logits = logits - presence_penalty * seen.to(logits.dtype)
    if frequency_penalty != 0.0:
        logits = logits - frequency_penalty * token_counts.to(logits.dtype)
    return logits


def _add_to_column(logits, col: int, add):
    """logits with `add` ([B]) added to column `col` (JAX's
    `.at[:, col].add`; a negative col counts from the end)."""
    logits = logits.clone()
    logits[:, col] += add.to(logits.dtype)
    return logits


def apply_min_length(logits, cur_lens, min_length: int, end_id: int):
    """Ban end_id (add NEG_INF) until min_length tokens were generated."""
    return _add_to_column(logits, end_id, torch.where(
        cur_lens < min_length, NEG_INF, 0.0))


def apply_top_k(logits, k: int):
    """Mask everything below the k-th largest logit."""
    if k <= 0:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, NEG_INF, logits)


def apply_top_p(logits, p: float):
    """Nucleus filtering: keep the smallest prefix of the sorted
    distribution whose mass reaches p (the mass of the tokens before each
    kept one is < p)."""
    if p <= 0.0 or p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = _softmax(sorted_logits)
    keep_sorted = (torch.cumsum(probs, dim=-1) - probs) < p
    thresh = torch.where(keep_sorted, sorted_logits, torch.inf).amin(
        -1, keepdim=True)
    return torch.where(logits < thresh, NEG_INF, logits)


def _draw(logits, generator):
    noise = gumbel_noise(tuple(logits.shape), generator)
    return torch.argmax(logits + noise, dim=-1).to(torch.int32)


def sample_step(logits, cfg: SamplingConfig, generator=None,
                token_counts=None, cur_lens=None):
    """One sampling step. logits [B, V] -> tokens [B] int32. The config's
    branches are resolved on the host, so a greedy config runs only the
    argmax (after the penalties and min length it asks for)."""
    logits = logits.float()
    if token_counts is not None and cfg.has_penalties:
        logits = apply_repetition_penalty(
            logits, token_counts, cfg.repetition_penalty,
            cfg.presence_penalty, cfg.frequency_penalty)
    if cfg.min_length > 0 and cur_lens is not None:
        logits = apply_min_length(logits, cur_lens, cfg.min_length,
                                  cfg.end_id)
    if cfg.is_greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if cfg.temperature != 1.0:
        logits = _div(logits, cfg.temperature)
    if cfg.top_k >= 1:
        # k == 1 with top_p set still filters: the caller asked for the
        # single best token
        logits = apply_top_k(logits, cfg.top_k)
    if cfg.top_p > 0.0:
        logits = apply_top_p(logits, cfg.top_p)
    if generator is None:
        raise ValueError("stochastic sampling needs a torch.Generator")
    return _draw(logits, generator)


class SlotSamplingParams(NamedTuple):
    """Per-slot sampling parameters of the serving engine, all [S] on the
    device (the JAX package's SlotSamplingParams): neutral values are
    no-ops, so one step serves any mix of greedy / top-k / top-p /
    penalized slots. bad_words [S, W, L] int32 (-1 padded) and bad_lens
    [S, W] (0 = unused) are None when the engine has no bad-word room."""

    temperature: torch.Tensor    # f32 (<= 0 read as 1.0)
    top_k: torch.Tensor          # i32 (0 => disabled)
    top_p: torch.Tensor          # f32 (0 or >= 1 => disabled)
    rep_pen: torch.Tensor        # f32 (1.0 => disabled)
    pres_pen: torch.Tensor       # f32
    freq_pen: torch.Tensor       # f32
    min_len: torch.Tensor        # i32
    greedy: torch.Tensor         # bool
    bad_words: Optional[torch.Tensor] = None
    bad_lens: Optional[torch.Tensor] = None

    @classmethod
    def neutral(cls, n: int, max_bad_words: int = 0,
                max_bad_word_len: int = 0, device="cpu"
                ) -> "SlotSamplingParams":
        def full(value, dtype, shape=(n,)):
            return torch.full(shape, value, dtype=dtype, device=device)
        bw = bl = None
        if max_bad_words > 0:
            bw = full(-1, torch.int32, (n, max_bad_words,
                                        max(max_bad_word_len, 1)))
            bl = full(0, torch.int32, (n, max_bad_words))
        return cls(full(1.0, torch.float32), full(0, torch.int32),
                   full(0.0, torch.float32), full(1.0, torch.float32),
                   full(0.0, torch.float32), full(0.0, torch.float32),
                   full(0, torch.int32), full(True, torch.bool), bw, bl)

    def set_slot(self, slot: int, cfg: SamplingConfig
                 ) -> "SlotSamplingParams":
        """One request's config written into its slot's row (new tensors,
        as the JAX package's functional update)."""
        values = dict(temperature=cfg.temperature, top_k=cfg.top_k,
                      top_p=cfg.top_p, rep_pen=cfg.repetition_penalty,
                      pres_pen=cfg.presence_penalty,
                      freq_pen=cfg.frequency_penalty,
                      min_len=cfg.min_length, greedy=cfg.is_greedy)
        new = {}
        for name, value in values.items():
            t = getattr(self, name).clone()
            t[slot] = value
            new[name] = t
        out = self._replace(**new)
        if self.bad_words is not None:
            w_cap, l_cap = self.bad_words.shape[1], self.bad_words.shape[2]
            if len(cfg.bad_words) > w_cap or any(
                    len(w) > l_cap or not w for w in cfg.bad_words):
                raise ValueError(
                    f"bad_words exceed engine capacity (max {w_cap} words "
                    f"of length <= {l_cap}; empty words not allowed)")
            words = np.full((w_cap, l_cap), -1, np.int32)
            lens = np.zeros((w_cap,), np.int32)
            for i, w in enumerate(cfg.bad_words):
                words[i, :len(w)] = w
                lens[i] = len(w)
            bw, bl = self.bad_words.clone(), self.bad_lens.clone()
            bw[slot] = torch.from_numpy(words).to(bw.device)
            bl[slot] = torch.from_numpy(lens).to(bl.device)
            out = out._replace(bad_words=bw, bad_lens=bl)
        elif cfg.bad_words:
            raise ValueError(
                "per-request bad_words need the engine built with "
                "max_bad_words > 0")
        return out

    def rows(self, idx) -> "SlotSamplingParams":
        """The rows `idx` (a device index tensor) of every field."""
        return SlotSamplingParams(*(None if t is None else t[idx]
                                    for t in self))


def ban_bad_words_slots(logits, p: SlotSamplingParams, tail):
    """Per-slot multi-token bad-word ban: for each slot's word w of length
    l, if the slot's last l - 1 generated tokens equal w[:-1], w[-1] gets
    NEG_INF added this step. tail [S, >= L - 1] holds the generated history
    (-2 before generation starts, which never equals a token); tail=None
    means the first generated token, where only single-token words
    match."""
    if p.bad_words is None:
        return logits
    s = logits.shape[0]
    words, wlens = p.bad_words, p.bad_lens                   # [S,W,L], [S,W]
    w_cap, l_cap = words.shape[1], words.shape[2]
    last = torch.gather(words, 2, (wlens - 1).clamp_min(0)[:, :, None].long()
                        )[:, :, 0]
    if tail is None:
        matched = wlens == 1
    else:
        t = tail.shape[1]
        n_pref = max(l_cap - 1, 1)
        j = torch.arange(n_pref, device=logits.device)
        # prefix element j of a length-l word aligns with tail[t-(l-1)+j]
        idx = (t - (wlens[:, :, None] - 1) + j).clamp(0, t - 1)
        tl = torch.gather(tail[:, None, :].expand(s, w_cap, t), 2, idx.long())
        pref = words[:, :, :n_pref]
        is_pref = j[None, None, :] < (wlens[:, :, None] - 1)
        matched = (wlens >= 1) & ((tl == pref) | ~is_pref).all(2)
    bad = torch.where(matched, last, 0).long()              # pads -> 0
    add = torch.where(matched, NEG_INF, 0.0).to(logits.dtype)
    return logits.scatter_add(1, bad, add)


def transform_slots(logits, p: SlotSamplingParams):
    """Per-slot temperature / top-k / top-p ([S, V] -> [S, V]): one
    descending sort serves the k-th value and the top-p mass (of the
    unfiltered logits, as the JAX package's); greedy slots pass through
    shaped too."""
    v = logits.shape[-1]
    logits = logits.float()
    t = torch.where(p.temperature > 0, p.temperature, 1.0)[:, None]
    logits = logits / t
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    k = p.top_k.clamp(0, v)
    kth = torch.gather(sorted_desc, -1, (k - 1).clamp_min(0)[:, None].long())
    kth = torch.where((k > 0)[:, None], kth, NEG_INF)
    probs = _softmax(sorted_desc)
    cum = torch.cumsum(probs, dim=-1)
    p_eff = torch.where((p.top_p > 0) & (p.top_p < 1), p.top_p, 1.0)[:, None]
    keep_sorted = (cum - probs) < p_eff
    p_thresh = torch.where(keep_sorted, sorted_desc, torch.inf).amin(
        -1, keepdim=True)
    return torch.where(logits < torch.maximum(kth, p_thresh), NEG_INF, logits)


def sample_step_slots(logits, p: SlotSamplingParams, generator, token_counts,
                      gen_lens, end_id: int, tail=None):
    """Per-slot sampling, logits [S, V] -> tokens [S] int32: every feature
    applied with per-slot parameters whose neutral values are no-ops;
    greedy slots take the argmax of the penalized, banned logits."""
    logits = logits.float()
    seen = token_counts > 0
    r = p.rep_pen[:, None]
    penalized = torch.where(logits > 0, logits / r, logits * r)
    logits = torch.where(seen & (r != 1.0), penalized, logits)
    logits = logits - p.pres_pen[:, None] * seen.float()
    logits = logits - p.freq_pen[:, None] * token_counts.float()
    logits = _add_to_column(logits, end_id, torch.where(
        gen_lens < p.min_len, NEG_INF, 0.0))
    logits = ban_bad_words_slots(logits, p, tail)
    greedy_tok = torch.argmax(logits, dim=-1).to(torch.int32)
    sampled = _draw(transform_slots(logits, p), generator)
    return torch.where(p.greedy, greedy_tok, sampled)


def update_tail(tail, tokens):
    """Roll the last-tokens window: tail [B, T] <- append tokens [B]."""
    return torch.cat([tail[:, 1:], tokens[:, None].to(tail.dtype)], dim=1)


def _tail_matches(tail, seq):
    """[B] bool: does the history window end with `seq` (a tuple)?"""
    t = len(seq)
    if t == 0:
        return torch.ones(tail.shape[0], dtype=torch.bool, device=tail.device)
    if t > tail.shape[1]:
        return torch.zeros(tail.shape[0], dtype=torch.bool,
                           device=tail.device)
    end = tail[:, tail.shape[1] - t:]
    return torch.stack([end[:, i] == int(w) for i, w in enumerate(seq)],
                       dim=1).all(1)


def apply_bad_words(logits, tail, bad_words):
    """Add NEG_INF to the completing token of every bad word whose prefix
    ends the tail; single-token words are always banned."""
    for word in bad_words:
        hit = _tail_matches(tail, tuple(word[:-1]))
        logits = _add_to_column(logits, int(word[-1]),
                                torch.where(hit, NEG_INF, 0.0))
    return logits


def stop_words_matched(tail, stop_words):
    """[B] bool: any stop sequence fully matched at the end of the tail."""
    out = torch.zeros(tail.shape[0], dtype=torch.bool, device=tail.device)
    for w in stop_words:
        out = out | _tail_matches(tail, tuple(w))
    return out


def update_token_counts(token_counts, tokens):
    """Add one occurrence of each row's token to its counts ([B, V] int32,
    in place; returned)."""
    return token_counts.scatter_add_(
        1, tokens.long()[:, None],
        torch.ones_like(tokens, dtype=token_counts.dtype)[:, None])


def init_token_counts(input_ids, seq_lens, vocab_size: int):
    """Counts [B, V] int32 of each row's prompt tokens, padding excluded.
    Ids >= vocab_size (prompt tuning's virtual tokens) count nowhere, as
    JAX's scatter drops them; they are sent to column 0 with a zero count,
    since a scatter past the row on the card is a device-side assert."""
    b, s = input_ids.shape
    real = input_ids < vocab_size
    valid = ((torch.arange(s, device=input_ids.device)[None, :]
              < seq_lens[:, None]) & real).to(torch.int32)
    counts = torch.zeros((b, vocab_size), dtype=torch.int32,
                         device=input_ids.device)
    return counts.scatter_add_(1, torch.where(real, input_ids, 0).long(),
                               valid)
