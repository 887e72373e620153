"""GenerationSession: generation (the port's `runtime/session.py`).

The JAX session jit-compiles prefill plus an on-device `lax.while_loop`;
here the same steps run eagerly as a Python loop over device tensors:
bucket the prompt, prefill, then decode one token per step with the
`done` / `lengths` / `positions` bookkeeping of the reference, until
`max_new_tokens` or every sequence hit `end_id` or a stop word. Each step
samples as the JAX session does (`runtime/sampling.py`: penalties over
token counts, min length, bad words over a tail of the history,
temperature / top-k / top-p and a draw from one device generator seeded
by `seed`), and optionally records the model's logprob of each token;
`beam_width > 1` runs beam search (`runtime/beam.py`, a dense or, with
`beam_paged_block`, a paged cache). The parameters may hold
any container the port runs (int8 / int4 weight-only, fp8, SmoothQuant,
a quantized lm_head): the model code dispatches on them. The model is
`model=` (llama, or a decoder family such as `models.decoder.BLOOM`) or
the one `models.by_architecture(cfg.architecture)` names.

Tensor parallelism (`mapping=Mapping(tp=N)`, LLaMA only): each of the N
ranks builds the session from the same full params and keeps its shards
(`parallel/sharding.py`: column / row projections, the lm_head over the
vocabulary, the KV cache over the heads), unfused as the JAX session
under a mesh; every rank runs `generate` on the same inputs and returns
the same tokens, the logits being gathered whole on every rank before
sampling. The tp group is the caller's (`group=`) or
`mapping.make_group()`'s, and is published in `ops.registry.KERNELS`
before every call, as the JAX session publishes its mesh.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from ..config import EngineConfig, ModelConfig
from ..device import resolve_device
from ..models import by_architecture
from ..ops.linear import tp_scope
from ..parallel import comm
from ..parallel.mapping import Mapping
from ..parallel.sharding import local_config, shard_params
from .sampling import (SamplingConfig, apply_bad_words, init_token_counts,
                       sample_step, stop_words_matched, update_tail,
                       update_token_counts)


@dataclasses.dataclass
class GenerationOutput:
    """output_ids: [B, max_new] (pad_id after a sequence ends); lengths: [B].

    With beam_width > 1, beam_ids / beam_lengths / beam_scores hold every
    beam ([B, W, T] / [B, W] / [B, W], best first) and output_ids / lengths
    the best beam. logprobs (generate(return_logprobs=True)): [B, max_new]
    f32, the model's log-softmax of each emitted token before any penalty
    or ban, 0.0 past the end."""

    output_ids: np.ndarray
    lengths: np.ndarray
    beam_ids: np.ndarray = None
    beam_lengths: np.ndarray = None
    beam_scores: np.ndarray = None
    logprobs: np.ndarray = None

    @property
    def cum_logprobs(self):
        return None if self.logprobs is None else self.logprobs.sum(axis=-1)


def tp_setup(cfg, params, model, mapping, group, device, what: str):
    """(params, the model's cfg, the tp group) of this rank: the full
    params and cfg unchanged for one rank; under tp > 1 (LLaMA only) its
    shards, its local_config and its group (the given one, or
    mapping.make_group()'s)."""
    mapping = mapping or Mapping()
    mapping.check_ported()
    if mapping.tp == 1:
        return params, cfg, None
    from ..models import llama
    if model is not llama:
        raise NotImplementedError(
            f"{what}: tensor parallelism runs LLaMA only; the decoder "
            "families under TP are ROADMAP A 5")
    if group is None:
        group, rank = mapping.make_group(device=device.type)
    else:
        rank = comm.group_rank(group)
    if comm.group_size(group) != mapping.tp:
        raise ValueError(f"{what}: the tp group has "
                         f"{comm.group_size(group)} ranks, Mapping.tp is "
                         f"{mapping.tp}")
    return (shard_params(params, mapping, rank),
            local_config(cfg, mapping.tp), group)


def _params_to(tree, device):
    if isinstance(tree, dict):
        return {k: _params_to(v, device) for k, v in tree.items()}
    return tree.to(device)


class GenerationSession:
    def __init__(self, cfg: ModelConfig, params, engine_cfg: EngineConfig,
                 kv_scales=None, device="cuda", model=None,
                 beam_paged_block: int = 0, mapping: Optional[Mapping] = None,
                 group=None):
        """kv_scales: optional [L] int8-KV dequant scales (calibrated by the
        converter; 1.0 when omitted, as in the JAX package). model: the
        model object (default `by_architecture(cfg.architecture)`).
        beam_paged_block > 0: beam search keeps its cache in a paged pool
        of blocks of that many rows and reorders beams through the block
        tables (`runtime/beam.py::_reorder_paged`) instead of copying the
        generated window of the dense cache each step. mapping / group:
        tensor parallelism (module note); group defaults to
        mapping.make_group()'s."""
        self.device = resolve_device(device)
        self.beam_paged_block = int(beam_paged_block)
        self.cfg = cfg
        self.engine_cfg = engine_cfg
        self.model = model or by_architecture(cfg.architecture)
        self.kv_scales = (None if kv_scales is None else torch.as_tensor(
            np.asarray(kv_scales, np.float32), device=self.device))
        params, self.model_cfg, self.group = tp_setup(
            cfg, params, self.model, mapping, group, self.device,
            "GenerationSession")
        self.params = _params_to(params, self.device)
        # one device: fuse q/k/v into one matmul where the model has the
        # rewrite, as the JAX session does; gate/up fusion is opt-in there,
        # by the environment variable TLLM_FUSE_GU, and here the same.
        # Under tp the column shards stay separate, as in the JAX session.
        fuse = getattr(self.model, "fuse_qkv_params", None)
        if fuse is not None and self.group is None:
            self.params = fuse(self.params)
        fuse_gu = getattr(self.model, "fuse_gate_up_params", None)
        if (fuse_gu is not None and self.group is None
                and os.environ.get("TLLM_FUSE_GU")):
            self.params = fuse_gu(self.params)
        self.rope = self.model.rope_tables(cfg, device=self.device)

    def generate(self, input_ids, seq_lens=None,
                 sampling: Optional[SamplingConfig] = None,
                 max_new_tokens: int = 32, seed: int = 0, prompt=None,
                 return_logprobs: bool = False) -> GenerationOutput:
        """input_ids: [B, S] numpy (right-padded with pad_id) or a list of
        token lists. seed: the draws' generator (one a call, on the
        session's device, drawn once for the prefill's token and once a
        decode step). return_logprobs: GenerationOutput.logprobs."""
        with tp_scope(self.group):
            return self._generate(input_ids, seq_lens, sampling,
                                  max_new_tokens, seed, prompt,
                                  return_logprobs)

    def _generate(self, input_ids, seq_lens, sampling, max_new_tokens, seed,
                  prompt, return_logprobs) -> GenerationOutput:
        scfg = sampling or SamplingConfig()
        if prompt is not None:
            raise NotImplementedError(
                "prompt tuning (prompt=) belongs to the GPT family "
                "(models/gpt.py), which is not ported yet")
        if isinstance(input_ids, (list, tuple)):
            if seq_lens is None:
                seq_lens = np.array([len(x) for x in input_ids], np.int32)
            s = int(max(len(x) for x in input_ids))
            arr = np.full((len(input_ids), s), scfg.pad_id, np.int32)
            for i, x in enumerate(input_ids):
                arr[i, :len(x)] = x
            input_ids = arr
        input_ids = np.asarray(input_ids)
        b, s = input_ids.shape
        if seq_lens is None:
            seq_lens = np.full((b,), s, np.int32)
        if int(np.max(seq_lens)) + max_new_tokens > self.engine_cfg.max_seq_len:
            raise ValueError(
                f"prompt ({int(np.max(seq_lens))}) + max_new_tokens "
                f"({max_new_tokens}) exceeds max_seq_len "
                f"{self.engine_cfg.max_seq_len}")
        bucket = self.engine_cfg.bucket_for(s)
        padded = np.full((b, bucket), scfg.pad_id, np.int32)
        padded[:, :s] = input_ids
        max_len = min(self.engine_cfg.max_seq_len, bucket + max_new_tokens)
        if scfg.beam_width > 1:
            if self.group is not None:
                raise NotImplementedError(
                    "beam search under tensor parallelism is ROADMAP A 5")
            if return_logprobs:
                raise NotImplementedError(
                    "beam search does not support prompt tuning or "
                    "return_logprobs (beam scores are returned instead)")
            return self._generate_beam(padded, seq_lens, scfg,
                                       max_new_tokens, max_len)

        dev, cfg, mcfg = self.device, self.cfg, self.model_cfg
        pad, end = scfg.pad_id, scfg.end_id
        tail_len = scfg.tail_len
        with torch.inference_mode():
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
            model = self.model
            caches = model.init_caches(mcfg, b, max_len, dev, self.kv_scales)
            ids = torch.as_tensor(padded, device=dev)
            lens = torch.as_tensor(np.asarray(seq_lens, np.int32), device=dev)
            logits, caches = model.forward_prefill(self.params, mcfg, ids,
                                                   lens, caches,
                                                   rope=self.rope)
            counts = (init_token_counts(ids, lens, cfg.vocab_size)
                      if scfg.has_penalties else None)
            tail = _init_tail(ids, lens, tail_len, pad) if tail_len else None
            lp = (torch.zeros((b, max_new_tokens), dtype=torch.float32,
                              device=dev) if return_logprobs else None)

            def sample(logits, done, step):
                """The step's tokens (pad where done) and the bookkeeping
                of counts, tail and logprobs."""
                nonlocal counts, tail
                raw = logits
                if scfg.bad_words:
                    logits = apply_bad_words(logits, tail, scfg.bad_words)
                gen_lens = torch.full((b,), step, dtype=torch.int32,
                                      device=dev)
                nxt = sample_step(logits, scfg, gen, counts, gen_lens)
                if done is not None:
                    nxt = torch.where(done, pad, nxt)
                if lp is not None:
                    lsm = torch.log_softmax(raw.float(), dim=-1)
                    got = lsm.gather(1, nxt.clamp_min(0).long()[:, None])[:, 0]
                    lp[:, step] = (got if done is None
                                   else torch.where(done, 0.0, got))
                if counts is not None:
                    counts = update_token_counts(
                        counts, nxt if done is None
                        else torch.where(done, 0, nxt))
                if tail_len:
                    tail = update_tail(tail, nxt)
                return nxt

            tokens = sample(logits, None, 0)
            out = torch.full((b, max_new_tokens), pad, dtype=torch.int32,
                             device=dev)
            out[:, 0] = tokens
            done = tokens == end
            if scfg.stop_words:
                done = done | stop_words_matched(tail, scfg.stop_words)
            lengths = torch.ones(b, dtype=torch.int32, device=dev)
            positions = lens.clone()
            step = 1
            while step < max_new_tokens and not bool(done.all()):
                logits, caches = model.forward_decode(
                    self.params, mcfg, tokens, positions, caches,
                    rope=self.rope)
                nxt = sample(logits, done, step)
                out[:, step] = nxt
                live = (~done).to(torch.int32)
                lengths += live
                positions += live
                new_done = done | (nxt == end)
                if scfg.stop_words:
                    new_done = new_done | (
                        ~done & stop_words_matched(tail, scfg.stop_words))
                done = new_done
                tokens = nxt
                step += 1
        return GenerationOutput(
            out.cpu().numpy(), lengths.cpu().numpy(),
            logprobs=None if lp is None else lp.cpu().numpy())

    def _generate_beam(self, padded, seq_lens, scfg: SamplingConfig,
                       max_new: int, max_len: int) -> GenerationOutput:
        from .beam import beam_search_decode

        dev, cfg = self.device, self.cfg
        b, w = padded.shape[0], scfg.beam_width
        with torch.inference_mode():
            caches = (None if self.beam_paged_block else
                      self.model.init_caches(cfg, b * w, max_len, dev,
                                             self.kv_scales))
            out, lens, scores = beam_search_decode(
                self.params, cfg, torch.as_tensor(padded, device=dev),
                torch.as_tensor(np.asarray(seq_lens, np.int32), device=dev),
                caches, model=self.model, beam_width=w,
                max_new_tokens=max_new, end_id=scfg.end_id,
                pad_id=scfg.pad_id, length_penalty=scfg.length_penalty,
                paged_block=self.beam_paged_block, kv_scales=self.kv_scales,
                rope=self.rope)
        out, lens, scores = (t.cpu().numpy() for t in (out, lens, scores))
        return GenerationOutput(out[:, 0], lens[:, 0], out, lens, scores)


def _init_tail(ids, lens, tail_len: int, pad_id: int):
    """The last tail_len prompt tokens of each row (ids left-aligned);
    positions before the prompt read as pad_id."""
    idx = lens.long()[:, None] - tail_len + torch.arange(
        tail_len, device=ids.device)[None]
    gathered = torch.gather(ids, 1, idx.clamp(0, ids.shape[1] - 1))
    return torch.where(idx >= 0, gathered, pad_id).to(torch.int32)
