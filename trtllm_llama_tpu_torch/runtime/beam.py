"""Beam search (the port's `runtime/beam.py`).

Beams are extra batch rows ([B * W]). Every beam of a batch runs the same
tiled prefill, so the prompt's cache rows are identical across its beams
and never move; each step reorders only what a beam inherits from its
parent, in one of two ways with identical outputs:

- dense cache [L, B * W, H_kv, S_max, D]: the generated window
  [prefill length, + max_new) of each row is copied from its parent's row
  (`_gather_cache_window`; the parents' rows are read into a copy before
  any row is written);
- `paged_block > 0`: a paged pool whose block tables carry the reorder
  (`_reorder_paged`, the reference's cache indirection): a child adopts
  its parent's table entries for the completed blocks and gets a copy of
  the parent's partial block in its own block, so no row ever writes a
  shared block; per-step traffic is one block a row.

A model whose cache wraps the dense one (chatglm's `ChatGLMCache`, in its
`kv`) moves that cache's window; its per-row context lengths and mask
positions are the same for every beam of a batch row and stay. The paged
pool is llama's (`PAGED_CACHE`): another model raises.

Token histories move with their parents, so the history is the path (no
final backtrack). Scores are cumulative log-probs; finished beams stay as
frozen pad continuations at their score; the final ranking divides by
((5 + length) / 6) ** length_penalty. Ties in the top-W choice go to the
lower index, as `jax.lax.top_k` breaks them. Caches are updated in place;
int8 and e4m3 caches move their codes, the per-layer scales stay.
"""

from __future__ import annotations

import torch

from ..ops.paged_attention import init_paged_caches

NEG_INF = -1e9


def _tile_beams(x, w: int):
    """[B, ...] -> [B * W, ...], each row repeated W times."""
    return torch.repeat_interleave(x, w, dim=0)


def _top_k(x, k: int):
    """(values, indices) of the k largest along the last axis, ties to
    the lower index (a stable descending sort)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _own_blocks(bw: int, nbr: int, device):
    """[BW, nbr] int32 identity tables: row r owns blocks r * nbr + i."""
    return (torch.arange(bw, device=device)[:, None] * nbr
            + torch.arange(nbr, device=device)[None, :]).to(torch.int32)


def _init_beam_paged(cfg, bw: int, max_len: int, bs: int, device,
                     kv_scales=None):
    """A pool of bw * nbr blocks of bs rows (nbr = ceil(max_len / bs)),
    row r owning blocks [r * nbr, (r + 1) * nbr) through identity tables
    (no -1 entry). Returns (cache, nbr)."""
    nbr = -(-max_len // bs)
    cache = init_paged_caches(cfg, bw * nbr, bs, bw, nbr, device, kv_scales)
    return cache._replace(tables=_own_blocks(bw, nbr, device)), nbr


def _reorder_paged(cache, gidx, positions, bs: int, nbr: int):
    """Each row adopts its parent gidx[row]: the parent's table entries
    below the parent's current block, its own blocks from there on, and a
    copy of the parent's current (partial) block into its own. A row's
    entries at or past its current block always name its own blocks, so
    the parent's current block is the parent's own and a completed, shared
    block is never written."""
    bw = cache.tables.shape[0]
    cur = (positions[gidx].long() // bs)[:, None]             # [BW, 1]
    par_tables = cache.tables[gidx]
    own = _own_blocks(bw, nbr, cache.tables.device)
    i_idx = torch.arange(nbr, device=cur.device)[None, :]
    tables = torch.where(i_idx < cur, par_tables, own)
    src = torch.gather(par_tables, 1, cur)[:, 0].long()
    dst = torch.gather(own, 1, cur)[:, 0].long()
    for pool in (cache.pool_k, cache.pool_v):
        pool[:, dst] = pool[:, src]          # the source blocks copied first
    return cache._replace(tables=tables)


def _gather_cache_window(a, gidx, base, tnew: int):
    """Row r of a stacked cache [L, BW, H, S, D] takes its parent gidx[r]'s
    rows over the generated window [base[r], base[r] + tnew), clipped to
    S - 1 (a row and its parent share base: one batch's prefill length)."""
    bw, s = a.shape[1], a.shape[3]
    win = (base.long()[:, None] + torch.arange(tnew, device=a.device)
           ).clamp(max=s - 1)                                 # [BW, T]
    rows = torch.arange(bw, device=a.device)[:, None]
    # advanced indices at axes 1 and 3 -> [BW, T, L, H, D], a copy
    seg = a[:, gidx.long()[:, None], :, win, :]
    a[:, rows, :, win, :] = seg
    return a


def beam_search_decode(params, cfg, input_ids, seq_lens, caches, *,
                       beam_width: int, max_new_tokens: int,
                       end_id: int = 2, pad_id: int = 0,
                       length_penalty: float = 0.0, model=None,
                       paged_block: int = 0, kv_scales=None, rope=None):
    """Prefill, then beam search. input_ids [B, S], seq_lens [B] (device
    tensors); caches: a stacked KVCache for B * W rows (ignored and built
    as a paged pool when paged_block > 0). Returns (output_ids [B, W, T],
    lengths [B, W], normalized scores [B, W]), best first per batch row."""
    if model is None:
        from ..models import llama as model

    b, s = input_ids.shape
    w, dev = beam_width, input_ids.device
    bw = b * w
    nbr = 0
    if paged_block and not getattr(model, "PAGED_CACHE", False):
        raise NotImplementedError(
            f"paged beam search needs a model with a paged KV cache path "
            f"(PAGED_CACHE, llama's); {getattr(model, '__name__', model)} "
            "has none, as in the JAX package: use beam_paged_block=0")
    if paged_block:
        caches, nbr = _init_beam_paged(cfg, bw, s + max_new_tokens,
                                       paged_block, dev, kv_scales)

    ids_t, lens_t = _tile_beams(input_ids, w), _tile_beams(seq_lens, w)
    logits, caches = model.forward_prefill(params, cfg, ids_t, lens_t,
                                           caches, rope=rope)
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    v = logprobs.shape[-1]

    # the first expansion: beam 0's top W distinct tokens
    scores, top_tok = _top_k(logprobs.reshape(b, w, v)[:, 0], w)   # [B, W]
    tokens = top_tok.reshape(bw).to(torch.int32)
    out = torch.full((b, w, max_new_tokens), pad_id, dtype=torch.int32,
                     device=dev)
    out[:, :, 0] = top_tok.to(torch.int32)
    finished = top_tok == end_id
    out_lens = torch.ones((b, w), dtype=torch.int32, device=dev)
    positions = lens_t.clone()
    batch_base = torch.arange(b, device=dev)[:, None] * w

    for step in range(1, max_new_tokens):
        logits, caches = model.forward_decode(params, cfg, tokens, positions,
                                              caches, rope=rope)
        lp = torch.log_softmax(logits.float(), dim=-1).reshape(b, w, v)
        # finished beams may only continue with pad, at an unchanged score
        cont = scores[:, :, None] + lp
        frozen = torch.full((b, w, v), NEG_INF, device=dev)
        frozen[:, :, pad_id] = scores
        cand = torch.where(finished[:, :, None], frozen, cont)
        top_s, top_i = _top_k(cand.reshape(b, w * v), w)          # [B, W]
        parent, tok = top_i // v, (top_i % v).to(torch.int32)
        gidx = (batch_base + parent).reshape(bw)
        if paged_block:
            caches = _reorder_paged(caches, gidx, positions, paged_block,
                                    nbr)
        else:
            kv = getattr(caches, "kv", caches)
            for a in (kv.k, kv.v):
                _gather_cache_window(a, gidx, lens_t, max_new_tokens)
        out = torch.gather(out, 1, parent[:, :, None].expand_as(out))
        out_lens = torch.gather(out_lens, 1, parent)
        was_finished = torch.gather(finished, 1, parent)
        positions = positions[gidx]

        out[:, :, step] = torch.where(was_finished, pad_id, tok)
        finished = was_finished | (tok == end_id)
        live = (~was_finished).to(torch.int32)
        out_lens = out_lens + live
        scores = top_s
        positions = positions + live.reshape(bw)
        tokens = torch.where(was_finished.reshape(bw), pad_id,
                             tok.reshape(bw))

    # final rank by length-normalized score, best first
    if length_penalty == 0.0:
        norm = scores
    else:
        norm = scores / ((5.0 + out_lens.float()) / 6.0) ** length_penalty
    order = torch.sort(-norm, dim=1, stable=True).indices
    out = torch.gather(out, 1, order[:, :, None].expand_as(out))
    return (out, torch.gather(out_lens, 1, order),
            torch.gather(norm, 1, order))
