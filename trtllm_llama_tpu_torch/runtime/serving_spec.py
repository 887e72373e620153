"""Speculative decoding inside the continuous-batching engine (the port's
`runtime/serving_spec.py`).

Every decode chunk runs speculative iterations (runtime/speculative.py)
for all rows of the slot pool at once: the draft's gamma + 1 decode steps
(or a prompt lookup), then ONE target `forward_extend` over [last
committed, proposals] of every row, then the commit, EOS and budget
truncation on the device. A chunk is budgeted by target weight reads:
n_iters = min(decode_chunk, the largest budget left) iterations, each
committing at least one token a live slot, and it stops once every slot
is done (the host reads `active.any()` between iterations, one small
readback an iteration); acceptance shortens the chunk instead of
lengthening it. Nothing is keyed on the chunk's value (the JAX engines
compile one graph per value).

Dense cache only (no paged, packed, chunked, mixed or pipelined step).
The target cache has gamma + 1 rows of headroom (`cache_headroom`), as
has the draft's. Admission prefills both models' caches straight into the
slots (the port's dense admission; JAX prefills a scratch cache and
copies). Sampling: greedy by default; with per_request_sampling each
request may carry its own temperature / top-k / top-p: stochastic slots
run rejection sampling on `transform_slots` (the per-slot shaping the
plain engine draws from), greedy slots keep the argmax-prefix acceptance,
so their tokens equal the plain engine's. Logprobs and stop words work as
in the base engine; penalties, min_length, bad words and beams raise.

Per-slot state beyond the base engine:
  slot_draft_pos [R]          the first position the draft's cache lacks
  slot_spec_tail [R, gamma+2] the last gamma + 2 committed tokens (a draft
                              that lags after rejections catches up from
                              them)
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from ..config import EngineConfig, ModelConfig, str_dtype_to_torch
from ..models import by_architecture
from .sampling import SamplingConfig, _draw, transform_slots
from .serving import FinishedRequest, ServingEngine, _tree_bytes
from .session import _params_to
from .speculative import (commit_slab, draft_steps, greedy_accept,
                          lookup_proposals, rejection_sample,
                          scatter_committed)


class _SpecEngine(ServingEngine):
    """The chunk loop and its readback, shared by both engines; a subclass
    gives `_iteration`."""

    def _decode_phase(self) -> List[FinishedRequest]:
        t0 = time.perf_counter()
        decoding = list(self.scheduler.active_requests())
        budgets = [r.max_new_tokens - len(r.output_ids) for r in decoding]
        n_iters = min(self.decode_chunk, max(budgets) if budgets else 0)
        if n_iters <= 0:
            return []
        slot_of = {r.slot: r for r in decoding}
        dev, rows, pad = self.device, self.n_rows, self.scfg.pad_id
        t_cols = n_iters * (self.gamma + 1)
        st = dict(lens=self.slot_lens, active=self.slot_active,
                  gen=self.slot_gen, budget=self.slot_budget,
                  written=torch.zeros(rows, dtype=torch.int32, device=dev),
                  out=torch.full((rows, t_cols + 1), pad, dtype=torch.int32,
                                 device=dev),
                  out_lp=(torch.zeros((rows, t_cols + 1), dtype=torch.float32,
                                      device=dev)
                          if self.return_logprobs else None))
        self._chunk_start(st, slot_of)
        it = 0
        # the first iteration needs no check: every decoding slot is active
        while it < n_iters and (it == 0 or bool(st["active"].any())):
            self._iteration(st)
            it += 1
        self._chunk_end(st)
        self.slot_lens, self.slot_active = st["lens"], st["active"]
        self.slot_gen = st["gen"]
        out_lp = st["out_lp"]
        staged = self._stage(st["out"][:, :t_cols], None if out_lp is None
                             else out_lp[:, :t_cols], st["written"])
        t1 = time.perf_counter()
        self.phase_times["dispatch"] += t1 - t0
        out, out_lp, k_tot = self._collect(staged)
        t2 = time.perf_counter()
        self.phase_times["readback"] += t2 - t1
        self.spec_iters += it
        self.spec_committed += int(k_tot.sum())
        finished = self._record_chunk(slot_of, out, out_lp, n_tokens=k_tot)
        self.phase_times["host"] += time.perf_counter() - t2
        return finished

    def _commit(self, st, props, n, bonus, lg):
        """Commit an iteration's slab for every row: the tokens (and their
        logprobs) into the chunk's buffers; lengths, generated counts and
        the active mask advanced. Returns (slab, valid, k)."""
        slab, valid, k, eos = commit_slab(
            props, n, bonus, st["budget"] - st["gen"], st["active"],
            self.scfg.end_id, self.scfg.pad_id)
        scatter_committed(st["out"], st["written"], valid, slab)
        if st["out_lp"] is not None:
            lsm = torch.log_softmax(lg.float(), dim=-1)
            lp = lsm.gather(-1, slab.clamp_min(0).long()[..., None])[..., 0]
            scatter_committed(st["out_lp"], st["written"], valid, lp)
        st["written"] = st["written"] + k
        st["gen"] = st["gen"] + k
        st["lens"] = st["lens"] + k
        st["active"] = st["active"] & ~eos & (st["gen"] < st["budget"])
        return slab, valid, k

    def _verify(self, props, last, lens):
        """The target's forward_extend over [last, props] of every row and
        its argmax: (logits [R, gamma + 1, V], argmax [R, gamma + 1])."""
        smax = self.caches.k.shape[3]
        start = lens.clamp_max(smax - self.gamma - 1)   # p_new - 1
        lg, self.caches = self.model.forward_extend(
            self.params, self.cfg, torch.cat([last, props], 1), start,
            self.caches, rope=self.rope)
        return lg, torch.argmax(lg, dim=-1).to(torch.int32)


class SpeculativeServingEngine(_SpecEngine):
    """ServingEngine whose decode chunks are draft-propose / target-verify
    iterations (the JAX package's SpeculativeServingEngine). A self draft
    (draft_params is params) shares the target's weights."""

    @torch.inference_mode()
    def __init__(self, cfg: ModelConfig, params, draft_cfg: ModelConfig,
                 draft_params, engine_cfg: EngineConfig, gamma: int = 4,
                 sampling: Optional[SamplingConfig] = None,
                 kv_scales=None, draft_kv_scales=None,
                 decode_chunk: int = 8, model=None, draft_model=None,
                 return_logprobs: bool = False,
                 per_request_sampling: bool = False, device="cuda"):
        scfg = sampling or SamplingConfig()
        if not per_request_sampling and not scfg.is_greedy:
            raise ValueError(
                "speculative serving with a stochastic SamplingConfig needs "
                "per_request_sampling=True (the rejection-sampling "
                "acceptance is vectorized over slots)")
        self._check_spec_sampling(scfg)
        if cfg.vocab_size != draft_cfg.vocab_size:
            raise ValueError("draft and target must share a vocabulary")
        self.gamma = int(gamma)
        self.draft_cfg = draft_cfg
        self.draft_model = draft_model or by_architecture(
            draft_cfg.architecture)
        self_draft = draft_params is params
        # the draft's weight bytes (all, and those already on the card) for
        # the capacity estimate; a self draft adds none
        self._draft_bytes = ((0, 0) if self_draft else (
            _tree_bytes(draft_params), _tree_bytes(draft_params, "cuda")))
        super().__init__(cfg, params, engine_cfg, sampling=scfg,
                         kv_scales=kv_scales, decode_chunk=decode_chunk,
                         model=model, return_logprobs=return_logprobs,
                         per_request_sampling=per_request_sampling,
                         cache_headroom=self.gamma + 1, device=device)
        if not hasattr(self.model, "forward_extend"):
            raise ValueError("target family lacks forward_extend")
        dev = self.device
        if self_draft:
            # the target's fused weights: a second copy would double a 7B
            # model's weight memory
            self.draft_params = self.params
        else:
            self.draft_params = _params_to(draft_params, dev)
            fuse = getattr(self.draft_model, "fuse_qkv_params", None)
            if fuse is not None:
                self.draft_params = fuse(self.draft_params)
        self.draft_rope = self.draft_model.rope_tables(draft_cfg, device=dev)
        self.draft_kv_scales = (None if draft_kv_scales is None else
                                torch.as_tensor(np.asarray(
                                    draft_kv_scales, np.float32), device=dev))
        self.draft_caches = self.draft_model.init_caches(
            draft_cfg, self.n_rows, engine_cfg.max_seq_len + self.gamma + 1,
            dev, self.draft_kv_scales)
        self.slot_draft_pos = torch.zeros(self.n_rows, dtype=torch.int32,
                                          device=dev)
        self.slot_spec_tail = torch.full((self.n_rows, self.gamma + 2),
                                         scfg.pad_id, dtype=torch.int32,
                                         device=dev)
        # acceptance: committed tokens against verify iterations run
        # (committed > iterations <=> some iteration committed > 1 token)
        self.spec_iters = 0
        self.spec_committed = 0

    @staticmethod
    def _check_spec_sampling(scfg: SamplingConfig):
        """The vectorized rejection test covers temperature / top-k /
        top-p; history-dependent features would change p and q inside the
        slab (the offline session's scope)."""
        if (scfg.repetition_penalty != 1.0 or scfg.presence_penalty != 0.0
                or scfg.frequency_penalty != 0.0 or scfg.min_length > 0
                or scfg.bad_words or scfg.beam_width > 1):
            raise ValueError(
                "speculative serving supports temperature/top_k/top_p "
                "(+host-side stop_words); penalties, min_length, bad_words "
                "and beam search are not implemented for it")

    def submit(self, input_ids, max_new_tokens,
               sampling: Optional[SamplingConfig] = None) -> int:
        if sampling is not None:
            self._check_spec_sampling(sampling)
        return super().submit(input_ids, max_new_tokens, sampling)

    def _capacity_estimate(self, params, block_size, num_blocks) -> dict:
        """The base estimate plus the draft's cache (max_seq_len + gamma +
        1 rows, rounded to 128, every slot and the trash row) and, unless
        it is a self draft, the draft's weights."""
        est = super()._capacity_estimate(params, block_size, num_blocks)
        dcfg = self.draft_cfg
        rows = -(-(self.engine_cfg.max_seq_len + self.gamma + 1) // 128) * 128
        item = torch.empty((), dtype=str_dtype_to_torch(
            dcfg.kv_dtype)).element_size()
        kv = (2 * dcfg.num_layers * dcfg.num_kv_heads * dcfg.head_dim
              * self.n_rows * rows * item)
        weights, resident = self._draft_bytes
        est.update(draft_kv=kv, draft_weights=weights,
                   resident=est["resident"] + resident,
                   need=est["need"] + kv + weights)
        return est

    def _prefill_draft(self, ids, lengths, slots):
        """The draft's prefill of an admitted group into its slots' rows;
        the draft then lacks position len(prompt) first, and its tail holds
        the first token once sampled (_admit_group)."""
        self.draft_model.forward_prefill(
            self.draft_params, self.draft_cfg, ids, lengths,
            self.draft_caches, rope=self.draft_rope, slots=slots)

    def _admit_group(self, group, bucket) -> List[FinishedRequest]:
        slots, lengths, tokens, lps = self._prefill_group(group, bucket)
        self.slot_draft_pos[slots] = lengths
        tail = torch.full((len(group), self.gamma + 2), self.scfg.pad_id,
                          dtype=torch.int32, device=self.device)
        tail[:, -1] = tokens
        self.slot_spec_tail[slots] = tail
        return self._register_prefilled(group, *self._read(tokens, lps))

    def _chunk_start(self, st, slot_of):
        st["tail"], st["draft_pos"] = self.slot_spec_tail, self.slot_draft_pos

    def _chunk_end(self, st):
        self.slot_spec_tail, self.slot_draft_pos = st["tail"], st["draft_pos"]
        self.slot_tokens = st["tail"][:, -1]

    def _iteration(self, st):
        gamma, per_request = self.gamma, self.per_request
        tail, lens = st["tail"], st["lens"]
        p_new = lens + 1                   # the position after the last token
        sp = self.slot_params if per_request else None

        def committed_at(q):
            back = p_new - 1 - q           # 0: the last committed token
            idx = ((gamma + 1) - back).clamp(0, gamma + 1).long()
            return tail.gather(1, idx[:, None])[:, 0]

        def pick(lgd, j):
            samp = torch.argmax(lgd, dim=-1).to(torch.int32)
            if not per_request:
                return samp, None
            # stochastic slots propose from their own shaped distribution
            tl = transform_slots(lgd, sp)
            return (torch.where(sp.greedy, samp, _draw(tl, self._gen)),
                    torch.softmax(tl, dim=-1))

        props, qprobs, self.draft_caches = draft_steps(
            self.draft_model, self.draft_params, self.draft_cfg,
            self.draft_caches, self.draft_rope, st["draft_pos"], p_new,
            committed_at, gamma, self.draft_caches.k.shape[3] - 1,
            self.scfg.pad_id, pick)
        lg, g = self._verify(props, tail[:, -1:], lens)
        n, bonus = greedy_accept(props, g)
        if per_request:
            # rejection sampling on stochastic slots; greedy slots keep the
            # argmax-prefix acceptance
            r, g1, v = lg.shape
            idx = torch.arange(r, device=lg.device).repeat_interleave(g1)
            pprobs = torch.softmax(transform_slots(
                lg.reshape(r * g1, v), sp.rows(idx)), dim=-1).view(r, g1, v)
            n_s, repl = rejection_sample(pprobs, qprobs, props, self._gen)
            n = torch.where(sp.greedy, n, n_s)
            bonus = torch.where(sp.greedy, g.gather(1, n[:, None])[:, 0],
                                repl)
        # draft-cache validity from the accepted count before truncation
        st["draft_pos"] = torch.where(
            st["active"], torch.minimum(p_new + n, st["draft_pos"] + gamma
                                        + 1).to(torch.int32), st["draft_pos"])
        slab, _, k = self._commit(st, props, n, bonus, lg)
        full = torch.cat([tail, slab], 1)
        at = torch.arange(gamma + 2, device=tail.device)[None] + k[:, None]
        st["tail"] = full.gather(1, at.long())


class PromptLookupServingEngine(_SpecEngine):
    """Speculative serving with no draft model: per-slot prompt-lookup
    proposals (runtime/speculative.py::PromptLookupSession) verified by
    one target forward_extend over the slot pool. Greedy only; the tokens
    equal the plain engine's. The history (each slot's prompt and output,
    -1 beyond) is built on the host from the scheduler's record at each
    chunk, uploaded through pinned memory, and updated on the device
    within the chunk."""

    @torch.inference_mode()
    def __init__(self, cfg: ModelConfig, params, engine_cfg: EngineConfig,
                 gamma: int = 4, ngram: int = 3,
                 sampling: Optional[SamplingConfig] = None,
                 kv_scales=None, decode_chunk: int = 8, model=None,
                 return_logprobs: bool = False, device="cuda"):
        scfg = sampling or SamplingConfig()
        if not scfg.is_greedy:
            raise ValueError("prompt-lookup serving is greedy-only "
                             "(an n-gram proposal has no q distribution)")
        self.gamma = int(gamma)
        super().__init__(cfg, params, engine_cfg, sampling=scfg,
                         kv_scales=kv_scales, decode_chunk=decode_chunk,
                         model=model, return_logprobs=return_logprobs,
                         cache_headroom=self.gamma + 1, device=device)
        if not hasattr(self.model, "forward_extend"):
            raise ValueError("prompt-lookup serving needs the model "
                             "family to provide forward_extend")
        self.ngram = int(ngram)
        self.t_hist = int(engine_cfg.max_seq_len)
        self.spec_iters = 0
        self.spec_committed = 0

    def _chunk_start(self, st, slot_of):
        # one spare column takes the dropped writes
        hist = np.full((self.n_rows, self.t_hist + 1), -1, np.int32)
        for slot, req in slot_of.items():
            toks = list(req.input_ids) + list(req.output_ids)
            hist[slot, :len(toks)] = toks[:self.t_hist]
        st["hist"] = self._dev(hist)

    def _chunk_end(self, st):
        last = st["lens"].clamp(0, self.t_hist - 1).long()
        self.slot_tokens = st["hist"].gather(1, last[:, None])[:, 0]

    def _iteration(self, st):
        hist, lens = st["hist"], st["lens"]
        p_new = lens + 1                   # history length
        props, last = lookup_proposals(hist[:, :self.t_hist], p_new,
                                       self.ngram, self.gamma)
        lg, g = self._verify(props, last, lens)
        n, bonus = greedy_accept(props, g)
        slab, valid, _ = self._commit(st, props, n, bonus, lg)
        scatter_committed(hist, p_new, valid, slab)
