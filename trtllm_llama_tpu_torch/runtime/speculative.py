"""Speculative decoding (the port's `runtime/speculative.py`): a draft
proposes, the target verifies.

Each iteration, as in the JAX package's sessions:
  1. the draft model runs gamma + 1 decode steps from `draft_pos`, the
     first position its cache lacks. A step at a position that is already
     committed is fed the committed token (that is how the draft catches up
     on the bonus token it never processed and on rejected proposals); the
     others are fed the draft's previous pick. The steps that predict
     positions p_new .. p_new + gamma - 1 give the gamma proposals
     (p_new: the position after the last committed token);
  2. the target runs one `forward_extend` over [last committed token,
     proposals] at positions p_new - 1 .., so its weights are read once
     for gamma + 1 positions;
  3. greedy: the longest prefix of proposals equal to the target's argmax
     is accepted and the target's own argmax at the first mismatch is
     committed after it (the bonus: gamma + 1 tokens on full acceptance);
     stochastic (temperature / top-k / top-p): rejection sampling
     (Leviathan et al. 2023, Alg. 1): proposal x_i is accepted when
     u * max(q_i(x_i), 1e-20) < p_i(x_i), the first rejected slot draws
     from norm(max(p_n - q_n, 0)) (p_n itself where that is all zero),
     and full acceptance draws the bonus from p_{gamma+1} by the same
     formula with q = 0. p and q are the shaped distributions the sampler
     draws from. EOS and the budget truncate what an iteration commits.

The JAX sessions run the whole loop on the device (`lax.while_loop`);
here an iteration is eager torch ops on device tensors whose shapes do not
depend on acceptance, and the host reads one tensor an iteration, the
`done` check, as GenerationSession does a step. torch has no dropped
scatter (JAX's `.at[].set(mode="drop")`): every buffer that commits write
into has one spare last column, which takes the writes of uncommitted
slots and is sliced off (clipping them onto the last real column instead
would race the valid write there). Draws come from one device generator
seeded by `seed`, through `sampling.gumbel_noise` and `torch.rand`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import EngineConfig, ModelConfig
from ..device import resolve_device
from ..models import by_architecture
from .sampling import SamplingConfig, _div, _draw, apply_top_k, apply_top_p
from .session import GenerationOutput, _params_to


def _transform(logits, scfg: SamplingConfig):
    """The shaping the sampler applies (temperature, top-k, top-p): p and q
    of the rejection test are the distributions actually drawn from, not
    the raw softmaxes."""
    logits = logits.float()
    if scfg.temperature != 1.0:
        logits = _div(logits, scfg.temperature)
    if scfg.top_k > 1:
        logits = apply_top_k(logits, scfg.top_k)
    if scfg.top_p > 0.0:
        logits = apply_top_p(logits, scfg.top_p)
    return logits


def draft_steps(dmodel, params, cfg, caches, rope, draft_pos, p_new,
                committed_at, gamma: int, last_row: int, pad_id: int, pick):
    """The draft's gamma + 1 decode steps from draft_pos [B].

    committed_at(q) -> the committed tokens [B] at positions q (read where
    q < p_new); last_row: the cache's last row (rows past it write there);
    pick(logits, j) -> (tokens [B] int32, probs [B, V] f32 or None).
    Returns (props [B, gamma] int32, pad_id where no step proposed; qprobs
    [B, gamma, V] or None; caches)."""
    b = draft_pos.shape[0]
    dev = draft_pos.device
    rows = torch.arange(b, device=dev)
    props = torch.full((b, gamma), pad_id, dtype=torch.int32, device=dev)
    qprobs = None
    prev = torch.zeros(b, dtype=torch.int32, device=dev)
    for j in range(gamma + 1):
        q = draft_pos + j
        inp = torch.where(q < p_new, committed_at(q), prev)
        logits, caches = dmodel.forward_decode(
            params, cfg, inp, q.clamp_max(last_row), caches, rope=rope)
        samp, qp = pick(logits, j)
        i = q + 1 - p_new              # the proposal slot this step fills
        ok = (i >= 0) & (i < gamma)
        ic = i.clamp(0, gamma - 1).long()
        props[rows, ic] = torch.where(ok, samp, props[rows, ic])
        if qp is not None:
            if qprobs is None:
                qprobs = qp.new_zeros((b, gamma, qp.shape[-1]))
            qprobs[rows, ic] = torch.where(ok[:, None], qp, qprobs[rows, ic])
        prev = samp
    return props, qprobs, caches


def greedy_accept(props, g):
    """n [B]: the length of the longest prefix of props [B, gamma] equal to
    the target's argmax g [B, gamma + 1]; and g at slot n [B]."""
    n = torch.cumprod((props == g[:, :-1]).to(torch.int32), 1).sum(1)
    return n, g.gather(1, n[:, None])[:, 0]


def rejection_sample(pprobs, qprobs, props, generator):
    """Leviathan et al. 2023, Alg. 1 over a slab. pprobs [B, gamma + 1, V],
    qprobs [B, gamma, V], props [B, gamma]. Returns n [B], the accepted
    proposals, and the token drawn at slot n [B]: from norm(max(p_n - q_n,
    0)), q = 0 at the bonus slot, p_n itself where the residual is all
    zero."""
    b, g1, v = pprobs.shape
    x = props.long()[..., None]
    p_x = pprobs[:, :g1 - 1].gather(-1, x)[..., 0]
    q_x = qprobs.gather(-1, x)[..., 0]
    u = torch.rand((b, g1 - 1), generator=generator, device=generator.device)
    accept = u * q_x.clamp_min(1e-20) < p_x
    n = torch.cumprod(accept.to(torch.int32), 1).sum(1)
    at = n[:, None, None].expand(b, 1, v)
    p_n = pprobs.gather(1, at)[:, 0]
    q_ext = torch.cat([qprobs, qprobs.new_zeros((b, 1, v))], 1)
    q_n = q_ext.gather(1, at)[:, 0]
    resid = (p_n - q_n).clamp_min(0.0)
    resid = torch.where(resid.sum(-1, keepdim=True) > 1e-12, resid, p_n)
    logits = torch.where(resid > 0, torch.log(resid), -1e30)
    return n, _draw(logits, generator)


def commit_slab(props, n, bonus, room, live, end_id: int, pad_id: int):
    """What one iteration commits. slab [B, gamma + 1]: the n accepted
    proposals, the bonus at slot n, pad_id after; valid [B, gamma + 1]:
    slots <= n, inside the room [B] left in the budget, on live [B] rows,
    up to and including the first end_id; k [B] = valid slots; eos [B]: an
    end_id was committed."""
    b, gamma = props.shape
    i_idx = torch.arange(gamma + 1, device=props.device)[None]
    n = n[:, None]
    props_ext = torch.cat([props, props.new_zeros((b, 1))], 1)
    slab = torch.where(i_idx < n, props_ext,
                       torch.where(i_idx == n, bonus[:, None].to(props.dtype),
                                   pad_id))
    valid = (i_idx <= n) & (i_idx < room[:, None]) & live[:, None]
    is_eos = ((slab == end_id) & valid).to(torch.int32)
    valid = valid & (torch.cumsum(is_eos, 1) - is_eos == 0)
    k = valid.sum(1).to(torch.int32)
    return slab, valid, k, (is_eos.bool() & valid).any(1)


def scatter_committed(buf, first, valid, values):
    """buf[b, first[b] + i] = values[b, i] where valid[b, i]. buf's last
    column is the spare one: invalid slots write there (torch's stand-in
    for JAX's dropped writes), so no valid write shares a column with
    another write."""
    i_idx = torch.arange(valid.shape[1], device=valid.device)[None]
    col = torch.where(valid, first[:, None] + i_idx, buf.shape[1] - 1)
    buf.scatter_(1, col.long(), values.to(buf.dtype))


def lookup_proposals(hist, p_new, ngram: int, gamma: int):
    """Prompt lookup: the gamma tokens after the most recent earlier
    occurrence of each row's last `ngram` committed tokens in hist [B, T]
    (prompt, then committed tokens, -1 beyond; p_new [B] tokens committed).
    Only windows starting before p_new - ngram count (an overlap with the
    current gram is fine: periodic text), so a window is fully committed;
    without a match the last token is proposed gamma times. Returns
    (props [B, gamma], the last committed token [B, 1])."""
    b, t = hist.shape
    dev = hist.device
    n_win = t - ngram + 1
    w_pos = torch.arange(n_win, device=dev)[None]
    gram_idx = p_new[:, None] - ngram + torch.arange(ngram, device=dev)[None]
    gram = hist.gather(1, gram_idx.clamp(0, t - 1).long())
    match = torch.ones((b, n_win), dtype=torch.bool, device=dev)
    for j in range(ngram):
        match &= hist[:, j:n_win + j] == gram[:, j:j + 1]
    match &= w_pos < (p_new - ngram)[:, None]
    t_star = torch.where(match, w_pos, -1).amax(1)
    src = (t_star + ngram)[:, None] + torch.arange(gamma, device=dev)[None]
    props = hist.gather(1, src.clamp(0, t - 1).long())
    last = hist.gather(1, (p_new - 1).clamp(0, t - 1).long()[:, None])
    return torch.where((t_star >= 0)[:, None], props,
                       last.expand(b, gamma)), last


def _greedy_pick(logits, j):
    return torch.argmax(logits, dim=-1).to(torch.int32), None


class SpeculativeSession:
    """Two-model speculative generation. cfg / params: the target;
    draft_cfg / draft_params: the (small) draft, same vocabulary; gamma:
    proposals an iteration. A self draft (draft_params is params) shares
    the target's weights. The target family needs forward_extend."""

    def __init__(self, cfg: ModelConfig, params, draft_cfg: ModelConfig,
                 draft_params, engine_cfg: EngineConfig, gamma: int = 4,
                 kv_scales=None, draft_kv_scales=None, model=None,
                 draft_model=None, device="cuda"):
        if cfg.vocab_size != draft_cfg.vocab_size:
            raise ValueError("draft and target must share a vocabulary")
        self.model = model or by_architecture(cfg.architecture)
        if not hasattr(self.model, "forward_extend"):
            raise ValueError(
                "speculative verification needs the target model family to "
                "provide forward_extend (llama, gptj, gptneox, bloom, opt and "
                "falcon do; this one does not)")
        self.draft_model = draft_model or by_architecture(
            draft_cfg.architecture)
        self._setup(cfg, params, engine_cfg, gamma, kv_scales, device)
        self.draft_cfg = draft_cfg
        self.draft_kv_scales = self._scales(draft_kv_scales)
        if draft_params is params:
            # a self draft shares the target's (fused) weights: a second
            # fused copy would double a 7B model's weight memory
            self.draft_params = self.params
        else:
            self.draft_params = self._fused(self.draft_model, draft_params)
        self.draft_rope = self.draft_model.rope_tables(draft_cfg,
                                                       device=self.device)

    def _setup(self, cfg, params, engine_cfg, gamma, kv_scales, device):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.engine_cfg = engine_cfg
        self.gamma = int(gamma)
        self.kv_scales = self._scales(kv_scales)
        self.params = self._fused(self.model, params)
        self.rope = self.model.rope_tables(cfg, device=self.device)
        self.last_iters = None

    def _scales(self, kv_scales):
        return (None if kv_scales is None else torch.as_tensor(
            np.asarray(kv_scales, np.float32), device=self.device))

    def _fused(self, model, params):
        """params on the session's device, q/k/v fused where the model has
        the rewrite (as GenerationSession)."""
        params = _params_to(params, self.device)
        fuse = getattr(model, "fuse_qkv_params", None)
        return fuse(params) if fuse is not None else params

    def generate(self, input_ids, seq_lens=None,
                 sampling: Optional[SamplingConfig] = None,
                 max_new_tokens: int = 32, seed: int = 0) -> GenerationOutput:
        """GenerationSession.generate's contract (a list of token lists or
        a right-padded [B, S] array). Greedy tokens equal plain greedy
        decoding's (up to argmax ties); stochastic configs emit tokens
        distributed as plain sampling from the target. Sets last_iters:
        target weight reads, the prefill included."""
        scfg = sampling or SamplingConfig()
        # p and q are kept per position: history-dependent features would
        # change them inside the slab
        if scfg.bad_words or scfg.stop_words or scfg.has_penalties:
            raise ValueError("penalties/word constraints are not supported "
                             "in the speculative path yet")
        if isinstance(input_ids, (list, tuple)):
            seq_lens = np.array([len(x) for x in input_ids], np.int32)
            arr = np.full((len(input_ids), int(seq_lens.max())), scfg.pad_id,
                          np.int32)
            for i, x in enumerate(input_ids):
                arr[i, :len(x)] = x
            input_ids = arr
        input_ids = np.asarray(input_ids)
        b, s = input_ids.shape
        if seq_lens is None:
            seq_lens = np.full((b,), s, np.int32)
        bucket = self.engine_cfg.bucket_for(s)
        padded = np.full((b, bucket), scfg.pad_id, np.int32)
        padded[:, :s] = input_ids
        with torch.inference_mode():
            ids = torch.as_tensor(padded, device=self.device)
            lens = torch.as_tensor(np.asarray(seq_lens, np.int32),
                                   device=self.device)
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            out, lengths, iters = self._run(ids, lens, bucket,
                                            max_new_tokens, scfg, gen)
        self.last_iters = iters
        return GenerationOutput(out.cpu().numpy(), lengths.cpu().numpy())

    def _run(self, ids, lens, bucket, max_new, scfg, gen):
        cfg, dcfg = self.cfg, self.draft_cfg
        model, dmodel = self.model, self.draft_model
        gamma, dev = self.gamma, self.device
        end, pad = scfg.end_id, scfg.pad_id
        stochastic = not scfg.is_greedy
        # the verify slab reaches position (prompt + generated - 1) + gamma
        max_len = bucket + max_new + gamma + 1
        b = ids.shape[0]
        caches_t = model.init_caches(cfg, b, max_len, dev, self.kv_scales)
        caches_d = dmodel.init_caches(dcfg, b, max_len, dev,
                                      self.draft_kv_scales)
        logits, caches_t = model.forward_prefill(self.params, cfg, ids, lens,
                                                 caches_t, rope=self.rope)
        _, caches_d = dmodel.forward_prefill(self.draft_params, dcfg, ids,
                                             lens, caches_d,
                                             rope=self.draft_rope)
        g1 = (_draw(_transform(logits, scfg), gen) if stochastic
              else torch.argmax(logits, dim=-1).to(torch.int32))
        out = torch.full((b, max_new + 1), pad, dtype=torch.int32, device=dev)
        out[:, 0] = g1
        lengths = torch.ones(b, dtype=torch.int32, device=dev)
        done = (g1 == end) | (max_new <= 1)
        draft_pos = lens.clone()          # the first position the draft lacks

        def committed_at(q):
            """The token at absolute position q (q >= the prompt's length:
            prompt positions never re-enter the loop)."""
            col = (q - lens).clamp(0, max_new - 1).long()
            return out.gather(1, col[:, None])[:, 0]

        def pick(lgd, j):
            if not stochastic:
                return _greedy_pick(lgd, j)
            tl = _transform(lgd, scfg)
            return _draw(tl, gen), torch.softmax(tl, dim=-1)

        it = 1
        while it < max_new and not bool(done.all()):
            p_new = lens + lengths
            props, qprobs, caches_d = draft_steps(
                dmodel, self.draft_params, dcfg, caches_d, self.draft_rope,
                draft_pos, p_new, committed_at, gamma, max_len - 1, pad, pick)
            last = committed_at(p_new - 1)
            ver = torch.cat([last[:, None], props], 1)
            start = (p_new - 1).clamp_max(max_len - gamma - 1)
            lg, caches_t = model.forward_extend(self.params, cfg, ver, start,
                                                caches_t, rope=self.rope)
            if stochastic:
                n, bonus = rejection_sample(
                    torch.softmax(_transform(lg, scfg), dim=-1), qprobs,
                    props, gen)
            else:
                n, bonus = greedy_accept(
                    props, torch.argmax(lg, dim=-1).to(torch.int32))
            slab, valid, k, eos = commit_slab(props, n, bonus,
                                              max_new - lengths, ~done, end,
                                              pad)
            scatter_committed(out, lengths, valid, slab)
            # the draft cache is valid through p_new + n - 1, capped by
            # what its gamma + 1 steps wrote
            reach = torch.minimum(p_new + n, draft_pos + gamma + 1)
            draft_pos = torch.where(done, draft_pos, reach.to(torch.int32))
            lengths = lengths + k
            done = done | eos | (lengths >= max_new)
            it += 1
        return out[:, :max_new], lengths, it


class PromptLookupSession(SpeculativeSession):
    """Speculation without a draft model: the proposals come from prompt
    lookup (n-gram matching over the request's own prompt and output,
    Saxena 2023), verified as SpeculativeSession verifies. Greedy only (a
    lookup has no q distribution); the tokens equal plain greedy
    decoding's. Without a match the verify commits the bonus token alone,
    so an iteration never commits fewer tokens than a decode step."""

    def __init__(self, cfg: ModelConfig, params, engine_cfg: EngineConfig,
                 gamma: int = 4, ngram: int = 3, kv_scales=None, model=None,
                 device="cuda"):
        self.model = model or by_architecture(cfg.architecture)
        if not hasattr(self.model, "forward_extend"):
            raise ValueError("prompt-lookup speculation needs the model "
                             "family to provide forward_extend")
        self._setup(cfg, params, engine_cfg, gamma, kv_scales, device)
        self.ngram = int(ngram)

    def _run(self, ids, lens, bucket, max_new, scfg, gen):
        if not scfg.is_greedy:
            raise ValueError("prompt-lookup speculation is greedy-only "
                             "(an n-gram proposal has no q distribution)")
        cfg, model, gamma, dev = self.cfg, self.model, self.gamma, self.device
        end, pad = scfg.end_id, scfg.pad_id
        max_len = bucket + max_new + gamma + 1
        t_hist = bucket + max_new          # the history's width
        b = ids.shape[0]
        caches = model.init_caches(cfg, b, max_len, dev, self.kv_scales)
        logits, caches = model.forward_prefill(self.params, cfg, ids, lens,
                                               caches, rope=self.rope)
        g1 = torch.argmax(logits, dim=-1).to(torch.int32)
        out = torch.full((b, max_new + 1), pad, dtype=torch.int32, device=dev)
        out[:, 0] = g1
        # hist: the prompt, then the committed tokens, -1 beyond (never a
        # token, so unwritten positions cannot fake a match); one spare
        # column
        hist = torch.full((b, t_hist + 1), -1, dtype=torch.int32, device=dev)
        cols = torch.arange(bucket, device=dev)[None]
        hist[:, :bucket] = torch.where(cols < lens[:, None], ids, -1)
        hist[torch.arange(b, device=dev), lens.long()] = g1
        lengths = torch.ones(b, dtype=torch.int32, device=dev)
        done = (g1 == end) | (max_new <= 1)
        it = 1
        while it < max_new and not bool(done.all()):
            p_new = lens + lengths
            props, last = lookup_proposals(hist[:, :t_hist], p_new,
                                           self.ngram, gamma)
            ver = torch.cat([last, props], 1)
            start = (p_new - 1).clamp_max(max_len - gamma - 1)
            lg, caches = model.forward_extend(self.params, cfg, ver, start,
                                              caches, rope=self.rope)
            n, bonus = greedy_accept(props,
                                     torch.argmax(lg, dim=-1).to(torch.int32))
            slab, valid, k, eos = commit_slab(props, n, bonus,
                                              max_new - lengths, ~done, end,
                                              pad)
            scatter_committed(out, lengths, valid, slab)
            scatter_committed(hist, p_new, valid, slab)
            lengths = lengths + k
            done = done | eos | (lengths >= max_new)
            it += 1
        return out[:, :max_new], lengths, it
