"""ServingEngine: continuous batching over a fixed slot pool (the port's
`runtime/serving.py`).

Requests stream in; each is prefilled into a free slot of a shared KV cache,
and every engine step advances ALL active slots by up to `decode_chunk`
tokens. The JAX engine runs the chunk as one jitted `fori_loop`; here it is
a Python loop of `forward_decode` steps over all `max_slots + 1` rows whose
per-slot state (tokens, lengths, active mask, generated counts, budgets)
stays on the device: a slot that hits EOS or its own budget freezes by
masking, the host does not sync inside the chunk, and it reads the chunk's
tokens back once at its end. Host values go to the card through pinned
memory without a stream sync (`_dev`), and a chunk's tokens come back
through pinned memory behind an event (`_stage` / `_collect`).

`model=` serves any model of `models/` (default
`by_architecture(cfg.architecture)`): the engine calls its init_caches,
rope_tables, forward_prefill, forward_extend and forward_decode, and
checks for what only llama has (a paged pool, packed prefill).

Three cache configurations, as in the JAX engine:
- dense (default): one cache [L, max_slots + 1, H_kv, S_max, D] (S_max:
  max_seq_len + cache_headroom, rounded up to 128 rows); slot i owns row i
  and row max_slots is the trash slot (never decoded as a request, always
  inactive). A step's admissions are grouped by prompt bucket
  (`EngineConfig.prefill_buckets`, which bounds each prompt's padding) and
  each group prefills in one batched call that writes its K/V straight into
  its slots' rows. The JAX engine also splits a group into powers of two
  and prefills into a scratch cache before copying the rows into their
  slots, to bound its compiles and because its caches are functional; the
  port needs neither, and the tokens are the same.
- `paged=True`: block pools [L, num_blocks + 1, H_kv, block_size, D] whose
  last block is the trash block, host-side block allocation
  (`KVCacheManager`) and a host mirror of the block tables that is uploaded
  before every decode chunk (the device never writes tables, so nothing is
  read back). Decode goes to kernel 14.
- `packed_prefill=True` (dense cache): all admits of a step prefill as ONE
  packed token stream (kernel 13), pad tokens writing to the trash slot.

Steps, as the JAX engine's:
- `prefill_chunk=C` (dense, not packed; ignored under paged or packed, as
  in JAX): a prompt longer than C prefills C tokens an engine step through
  the model's `forward_extend` at per-row starts, interleaved with the
  decode chunks of the other slots; the final chunk overlaps backward so
  that every call is exactly C tokens. All partial prompts advance in one
  call a step. A partial request neither sizes the decode chunk nor
  records tokens, and its slot stays inactive: the decode steps then write
  inactive rows at position max_seq_len, which no request reaches (or past
  the cache, which drops the write), instead of at their frozen lengths
  inside the partial prompt.
- `mixed_step=True` (dense, not packed, not chunked): a step's admission
  prefill and its decode chunk run with no readback between them; the
  fresh slots are activated on the device (the EOS / budget freeze too)
  and the prefill's tokens come back with the chunk's. JAX folds only an
  admission that is one same-bucket group of a power-of-two size (its
  compiles); the port folds any one-bucket admission.
- `pipelined=True` (not with mixed_step): each step dispatches chunk N,
  then records chunk N-1 (waiting on its event only) and admits; requests
  admitted in a step join the next chunk, and rows of requests that
  finished while a chunk was in flight are skipped. The decode chunk's
  length and a paged slot's block appends count the steps still in flight,
  so the host lagging one chunk never dispatches past a request's budget
  (JAX's engine over-appends blocks there, `runtime/serving.py:1397` of the
  JAX package, and raises when input + max_new_tokens == max_seq_len).

Sampling, as the JAX engine's: every admission and decode step samples
through one helper (`_sample`). By default it runs the engine's
SamplingConfig (`sampling.sample_step`, without token counts or generated
lengths, as the JAX engine passes none) with the engine's device
generator, seeded 0. `per_request_sampling=True`: per-slot parameters on
the device (`SlotSamplingParams`, one row a slot, the trash row neutral),
set at admission from `submit(sampling=)` or the engine default, and
`sample_step_slots` over them with per-slot token counts (seeded from each
full prompt at admission or at a chunked prompt's final chunk, updated by
active rows) and generated lengths (for `min_length`); `max_bad_words` /
`max_bad_word_len` add per-slot bad words over a tail of each slot's
generated tokens. Stop words are matched on the host at chunk boundaries,
on the recorded ids ("stop_words"; the stop sequence stays in the output).
`return_logprobs`: the model's logprob of each token, read back with the
chunk's tokens in its one readback. Sharded or multi-host serving is not
ported yet and raises NotImplementedError. The speculative engines
subclass this one (`runtime/serving_spec.py`).

The port updates every cache in place (JAX returns new ones), so an
admission writes into its slots or blocks while other slots hold live K/V:
a dense group writes only its own slots' rows, a paged prefill writes whole
bucket-padded blocks through the group's own table rows (pad rows land in
the request's tail block or the trash block), and inactive rows decode into
their own frozen row (dense) or the trash block (paged).
"""

from __future__ import annotations

import dataclasses
import inspect
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import EngineConfig, ModelConfig, str_dtype_to_torch
from ..device import resolve_device
from ..models import by_architecture
from ..ops.attention import PackedMeta
from ..ops.linear import tp_scope
from ..ops.paged_attention import init_paged_caches
from .kv_cache_manager import KVCacheManager
from .sampling import (SamplingConfig, SlotSamplingParams,
                       init_token_counts, sample_step, sample_step_slots,
                       update_tail, update_token_counts)
from .scheduler import Request, Scheduler
from .session import _params_to, tp_setup


@dataclasses.dataclass
class FinishedRequest:
    request_id: int
    output_ids: List[int]
    finished_reason: str
    logprobs: Optional[List[float]] = None   # set when return_logprobs


def pack_prompts(prompts, slots, t_bucket: int, trash_slot: int,
                 n_last: int):
    """One packed stream of `prompts` (token id lists) for cache rows
    `slots`, padded to t_bucket tokens. Returns int32 numpy arrays:
    token_ids [T]; meta [3, T] (PackedMeta's seg_ids, -1 on pads; slot_tok,
    pads on trash_slot; pos_tok); last_idx [n_last], each prompt's last
    token in the stream (unused entries on the stream's last row)."""
    token_ids = np.zeros((t_bucket,), np.int32)
    seg_ids = np.full((t_bucket,), -1, np.int32)
    slot_tok = np.full((t_bucket,), trash_slot, np.int32)
    pos_tok = np.zeros((t_bucket,), np.int32)
    last_idx = np.full((n_last,), t_bucket - 1, np.int32)
    off = 0
    for i, (ids, slot) in enumerate(zip(prompts, slots)):
        n = len(ids)
        token_ids[off:off + n] = ids
        seg_ids[off:off + n] = i
        slot_tok[off:off + n] = slot
        pos_tok[off:off + n] = np.arange(n)
        last_idx[i] = off + n - 1
        off += n
    return token_ids, np.stack([seg_ids, slot_tok, pos_tok]), last_idx


def _tree_bytes(tree, device_type=None) -> int:
    """Bytes of the tensors in a params tree (dicts and the quantized
    weight dataclasses), only those on `device_type` when it is given."""
    if isinstance(tree, torch.Tensor):
        if device_type is not None and tree.device.type != device_type:
            return 0
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_tree_bytes(v, device_type) for v in tree.values())
    if dataclasses.is_dataclass(tree):
        return sum(_tree_bytes(getattr(tree, f.name), device_type)
                   for f in dataclasses.fields(tree))
    return 0


class ServingEngine:
    @torch.inference_mode()
    def __init__(self, cfg: ModelConfig, params, engine_cfg: EngineConfig,
                 sampling: Optional[SamplingConfig] = None,
                 kv_scales=None, decode_chunk: int = 8, model=None,
                 paged: bool = False, block_size: int = 64,
                 num_blocks: Optional[int] = None,
                 per_request_sampling: bool = False,
                 packed_prefill: bool = False,
                 prefill_chunk: Optional[int] = None,
                 return_logprobs: bool = False,
                 cache_headroom: int = 0,
                 max_bad_words: int = 0,
                 max_bad_word_len: int = 4,
                 mixed_step: bool = False,
                 pipelined: bool = False,
                 mapping=None, mesh=None, device="cuda", group=None):
        if mesh is not None:
            raise NotImplementedError(
                "ServingEngine: the port has no JAX mesh; tensor "
                "parallelism takes mapping=Mapping(tp=N) (and group=)")
        if mapping is not None and (mapping.dp * mapping.pp != 1
                                    or mapping.shard_kv_seq):
            raise ValueError(
                "sharded serving supports tp (and ep) axes, plus sp for "
                "prefill compute — the slot pool is the batch, so dp/pp "
                "(and sp-sharded KV) are rejected")
        tp_options = [k for k, v in (
            ("packed_prefill", packed_prefill),
            ("prefill_chunk", prefill_chunk), ("mixed_step", mixed_step),
            ("pipelined", pipelined)) if v]
        if mapping is not None and mapping.tp > 1 and tp_options:
            raise NotImplementedError(
                "ServingEngine under tensor parallelism serves the dense "
                f"and paged caches; {', '.join(tp_options)} under TP are "
                "ROADMAP A 5")
        self.model = (model if model is not None
                      else by_architecture(cfg.architecture))
        arch = cfg.architecture or "llama"
        # capability checks against the resolved model, as the JAX engine
        if "slots" not in inspect.signature(
                self.model.forward_prefill).parameters:
            raise NotImplementedError(
                f"model {getattr(self.model, '__name__', arch)!r}: its "
                "forward_prefill takes no slots= (it writes cache rows "
                "0..B-1, as the JAX package's, whose engine fails on it), so "
                "the slot pool cannot serve it; use GenerationSession")
        if paged and not getattr(self.model, "PAGED_CACHE", False):
            raise ValueError(
                f"model family {arch!r} has no paged KV cache path: serve "
                "it with the dense cache (paged=False)")
        self.packed = (packed_prefill and not paged
                       and hasattr(self.model, "forward_prefill_packed"))
        if packed_prefill and not self.packed and not paged:
            raise ValueError(
                f"model family {arch!r} has no packed-prefill path")
        self.prefill_chunk = (int(prefill_chunk) if prefill_chunk
                              and not paged and not self.packed else None)
        if self.prefill_chunk is not None and self.prefill_chunk < 16:
            raise ValueError("prefill_chunk must be >= 16")
        if (self.prefill_chunk is not None
                and not hasattr(self.model, "forward_extend")):
            raise ValueError(
                f"model family {arch!r} has no forward_extend: chunked "
                "prefill unavailable")
        self.mixed = (bool(mixed_step) and not paged and not self.packed
                      and prefill_chunk is None)
        if mixed_step and not self.mixed:
            raise ValueError("mixed_step needs the dense non-packed, "
                             "non-chunked-prefill configuration")
        self.pipelined = bool(pipelined)
        if self.pipelined and mixed_step:
            raise ValueError("pipelined serving needs the non-mixed, "
                             "single-host configuration")
        self.scfg = sampling or SamplingConfig()
        self.per_request = per_request_sampling
        self.return_logprobs = return_logprobs
        self.max_bad_words = max_bad_words
        self.max_bad_word_len = max_bad_word_len if max_bad_words else 0
        if max_bad_words and not per_request_sampling:
            raise ValueError("max_bad_words needs per_request_sampling=True")
        if self.scfg.bad_words and not max_bad_words:
            raise ValueError(
                "engine-default bad_words need max_bad_words > 0 (and "
                "per_request_sampling=True)")
        self._check_bad_word_ids(self.scfg.bad_words, cfg.vocab_size)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.engine_cfg = engine_cfg
        self.decode_chunk = decode_chunk
        self.cache_headroom = cache_headroom
        self.max_slots = engine_cfg.max_batch_size
        self.n_rows = self.max_slots + 1      # +1 = prefill-padding trash slot
        self.trash_slot = self.max_slots
        self.paged = paged
        dev = self.device
        self.kv_scales = (None if kv_scales is None else torch.as_tensor(
            np.asarray(kv_scales, np.float32), device=dev))

        # tensor parallelism: this rank's shards, heads and group (every
        # rank runs the same host bookkeeping on the same requests)
        params, self.model_cfg, self.group = tp_setup(
            cfg, params, self.model, mapping, group, dev, "ServingEngine")
        self._capacity_precheck(params, block_size, num_blocks)
        self.params = _params_to(params, dev)
        # one device: q/k/v fused into one matmul where the model has the
        # rewrite, as the JAX engine does (not under tp, as there)
        fuse = getattr(self.model, "fuse_qkv_params", None)
        if fuse is not None and self.group is None:
            self.params = fuse(self.params)
        self.rope = self.model.rope_tables(cfg, device=dev)

        if paged:
            self.block_size = block_size
            self.max_blocks = -(-engine_cfg.max_seq_len // block_size)
            self.num_blocks = (num_blocks if num_blocks is not None
                               else self.max_slots * self.max_blocks)
            self.kv_mgr = KVCacheManager(self.num_blocks, block_size,
                                         self.max_blocks)
            self.scheduler = Scheduler(
                self.max_slots, engine_cfg.max_seq_len,
                kv_token_capacity=self.num_blocks * block_size)
            # the pool's extra last block is the trash block: inactive rows'
            # writes land there instead of in live blocks
            self.trash_block = self.num_blocks
            self.caches = init_paged_caches(
                self.model_cfg, self.num_blocks + 1, block_size, self.n_rows,
                self.max_blocks, dev, self.kv_scales)
            # host mirror of the block tables, uploaded before every decode
            # chunk (allocation is host-side; the device only reads tables)
            self._tables_np = np.full((self.n_rows, self.max_blocks),
                                      self.trash_block, np.int32)
        else:
            self.scheduler = Scheduler(self.max_slots, engine_cfg.max_seq_len)
            # cache_headroom: positions past max_seq_len (a speculative
            # verify slab writes up to gamma past the budget)
            self.caches = self.model.init_caches(
                self.model_cfg, self.n_rows, engine_cfg.max_seq_len + cache_headroom,
                dev, self.kv_scales)
        # per-slot device state ([n_rows]; the trash row is never active)
        self.slot_lens = self._dev(np.zeros((self.n_rows,), np.int32))
        self.slot_tokens = self._dev(np.zeros((self.n_rows,), np.int32))
        self.slot_active = self._dev(np.zeros((self.n_rows,), bool))
        self.slot_budget = self._dev(np.zeros((self.n_rows,), np.int32))
        self.slot_gen = self._dev(np.zeros((self.n_rows,), np.int32))
        # the draws' generator, seeded 0 as the JAX engine's PRNGKey(0)
        self._gen = torch.Generator(device=dev)
        self._gen.manual_seed(0)
        if self.per_request:
            self.slot_params = SlotSamplingParams.neutral(
                self.n_rows, max_bad_words, self.max_bad_word_len, dev)
            self.slot_counts = torch.zeros((self.n_rows, cfg.vocab_size),
                                           dtype=torch.int32, device=dev)
        if max_bad_words:
            # each slot's last L - 1 generated tokens; -2 before generation
            # (never a token, so a word longer than the history cannot
            # match)
            self.slot_tail = torch.full(
                (self.n_rows, max(self.max_bad_word_len - 1, 1)), -2,
                dtype=torch.int32, device=dev)
        self._req_sampling: Dict[int, SamplingConfig] = {}
        self._req_logprobs: Dict[int, List[float]] = {}
        # chunked prefill: request id -> start of its next chunk
        self._partial: Dict[int, int] = {}
        # pipelined: the dispatched chunk whose tokens are not recorded yet
        self._pending_chunk = None
        # wall time per phase: admission (prefills and their token
        # readback), decode dispatch (the host enqueueing the chunk's
        # steps; a mixed step's prefill too), readback (waits for the
        # device to finish the chunk, then copies its tokens) and host
        # bookkeeping
        self.phase_times = {"admit": 0.0, "dispatch": 0.0,
                            "readback": 0.0, "host": 0.0, "steps": 0}
        # device calls made: forward_decode steps, batched prefills
        # (forward_prefill; a mixed step's included), packed prefills
        # (forward_prefill_packed) and chunked-prefill calls
        # (forward_extend, whose rows chunk_rows lists, one entry a call)
        self.calls = {"decode_steps": 0, "prefills": 0, "packed_prefills": 0,
                      "chunk_prefills": 0}
        self.chunk_rows: List[int] = []
        # rid -> [t_submit, t_first_token, t_done, n_tokens_recorded]
        self._req_times: Dict[int, list] = {}

    # ------------------------------------------------------------------
    def _capacity_precheck(self, params, block_size, num_blocks):
        """Fail fast, with remedies, when the serving configuration cannot
        fit on the card. Needs: weights + ONE KV pool (the port updates the
        cache in place; the JAX engine counts two for XLA's loop-carry copy)
        + the admission transients. Budget: the card's free memory
        (`torch.cuda.mem_get_info`) plus the weights already on it, or the
        `TLLM_HBM_BYTES` environment variable when set; CPU engines are
        unchecked unless that is set. `TLLM_SKIP_CAPACITY_CHECK=1` skips."""
        if os.environ.get("TLLM_SKIP_CAPACITY_CHECK"):
            return
        budget = os.environ.get("TLLM_HBM_BYTES")
        if budget is None and self.device.type != "cuda":
            return
        est = self._capacity_estimate(params, block_size, num_blocks)
        if budget is None:
            free, _ = torch.cuda.mem_get_info(self.device)
            budget = free + est["resident"]
        budget = int(budget)
        if est["need"] > budget:
            gib = 1024 ** 3
            raise ValueError(
                f"serving configuration needs ~{est['need'] / gib:.1f} GiB "
                f"(weights {est['weights'] / gib:.1f} + KV pool "
                f"{est['kv'] / gib:.1f} + transients "
                f"{(est['act'] + est['logits']) / gib:.1f})"
                f" but the device budget is {budget / gib:.1f} GiB. "
                "Remedies: int8 KV (QuantMode.INT8_KV_CACHE) halves the KV "
                "pool; paged=True sizes the pool by blocks instead of "
                "max_batch_size*max_seq_len; or lower max_batch_size/"
                "max_seq_len. Override: TLLM_HBM_BYTES / "
                "TLLM_SKIP_CAPACITY_CHECK=1.")

    def _capacity_estimate(self, params, block_size, num_blocks) -> dict:
        """Byte estimate behind _capacity_precheck: weights + one KV pool
        (dense: cache_headroom rows past max_seq_len, as the JAX engine
        counts them) + admission transients (the JAX engine's model with
        its KV pool once and without its scratch cache: a prefill writes
        into the slots). "resident": the counted weights already on the
        card, which the budget adds to its free memory."""
        cfg, engine_cfg = self.model_cfg, self.engine_cfg
        smax = engine_cfg.max_seq_len + self.cache_headroom
        if self.paged:
            nb = (num_blocks if num_blocks is not None
                  else self.max_slots * (-(-engine_cfg.max_seq_len
                                           // block_size)))
            kv_rows = (nb + 1) * block_size
        else:
            kv_rows = self.n_rows * (-(-smax // 128) * 128)
        kv_item = torch.empty((), dtype=str_dtype_to_torch(
            cfg.kv_dtype)).element_size()
        kv = (2 * cfg.num_layers * cfg.num_kv_heads * cfg.head_dim
              * kv_rows * kv_item)
        # admission transient: the largest prefill call's activations
        # (~6 residual-width + 4 intermediate-width live tensors per token,
        # every slot at the largest bucket), plus decode logits
        bucket = max(engine_cfg.prefill_buckets or (engine_cfg.max_input_len,))
        act = self.max_slots * bucket * (6 * cfg.hidden_size
                                         + 4 * cfg.intermediate_size) * 2
        logits = self.n_rows * cfg.vocab_size * 4 * 2
        weights = _tree_bytes(params)
        return {"weights": weights, "kv": kv, "act": act, "logits": logits,
                "need": weights + kv + act + logits,
                "resident": _tree_bytes(params, "cuda")}

    # ------------------------------------------------------------------
    def _dev(self, x):
        """A host value as a new device tensor. On the card the copy goes
        through pinned memory, asynchronously: a copy from pageable memory
        synchronizes the stream, so it would wait for a decode chunk in
        flight. The pinned buffer belongs to PyTorch's caching host
        allocator, which reuses it only once its copy has run (one staging
        buffer a copy in flight)."""
        t = torch.from_numpy(np.array(x))      # a copy: the caller keeps x
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def _stage(self, *tensors):
        """Start one device-to-host copy of `tensors` (int32 or f32 device
        tensors, or None), packed as int32. On the card it lands in pinned
        memory, asynchronously, and an event marks its end; `_collect`
        waits on that event alone, not on work queued after it."""
        parts = [t.reshape(-1).to(torch.int32) if t.dtype != torch.float32
                 else t.reshape(-1).view(torch.int32)
                 for t in tensors if t is not None]
        flat = torch.cat(parts)
        layout = [None if t is None else (tuple(t.shape),
                                          t.dtype == torch.float32)
                  for t in tensors]
        if flat.device.type != "cuda":
            return flat, None, layout
        host = torch.empty(flat.shape, dtype=torch.int32, pin_memory=True)
        host.copy_(flat, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event, layout

    @staticmethod
    def _collect(staged):
        """The staged tensors as numpy arrays (None where None was
        staged), after waiting for their copy's event."""
        host, event, layout = staged
        if event is not None:
            event.synchronize()
        flat, out, off = host.numpy(), [], 0
        for item in layout:
            if item is None:
                out.append(None)
                continue
            shape, is_f32 = item
            n = int(np.prod(shape))
            a = flat[off:off + n].reshape(shape).copy()
            out.append(a.view(np.float32) if is_f32 else a)
            off += n
        return out

    def _read(self, *tensors):
        """`tensors` (or None) as numpy in one device-to-host copy."""
        return self._collect(self._stage(*tensors))

    @staticmethod
    def _check_bad_word_ids(bad_words, vocab_size: int):
        if any(t < 0 or t >= vocab_size for w in bad_words for t in w):
            raise ValueError(
                f"bad_words token ids must be in [0, {vocab_size})")

    def _sample(self, logits, rows=None, counts=None, gen_lens=None,
                tail=None):
        """The engine's sampler, for admissions and decode steps alike:
        per-request, `sample_step_slots` over the slot parameters of `rows`
        (a device index; all rows when None) with token counts, generated
        lengths and the bad-word tail; else the engine's SamplingConfig."""
        if not self.per_request:
            return sample_step(logits, self.scfg, self._gen)
        params = self.slot_params if rows is None else self.slot_params.rows(
            rows)
        return sample_step_slots(logits, params, self._gen, counts, gen_lens,
                                 self.scfg.end_id, tail)

    @staticmethod
    def _chosen_logprobs(logits, tokens):
        """The model's log-softmax of each row's token ([B] f32)."""
        lsm = torch.log_softmax(logits.float(), dim=-1)
        return lsm.gather(1, tokens.clamp_min(0).long()[:, None])[:, 0]

    def _sample_admitted(self, logits, rows, counts):
        """First tokens of an admission (device [n]) and their logprobs, or
        None. Per-request: `counts` ([n, V], the prompts') take the token
        and become the rows' slot counts; a first token sees no tail, so
        only single-token bad words apply to it."""
        zeros = torch.zeros(logits.shape[0], dtype=torch.int32,
                            device=logits.device)
        tokens = self._sample(logits, rows, counts, zeros)
        if self.per_request:
            self.slot_counts[rows] = update_token_counts(counts, tokens)
        lps = (self._chosen_logprobs(logits, tokens) if self.return_logprobs
               else None)
        return tokens, lps

    def _set_slot_params(self, reqs: List[Request]):
        for req in reqs:
            self.slot_params = self.slot_params.set_slot(
                req.slot, self._req_sampling.get(req.request_id, self.scfg))

    def _register_prefilled(self, reqs: List[Request], tokens: np.ndarray,
                            lps: Optional[np.ndarray] = None,
                            device_updated: bool = False
                            ) -> List[FinishedRequest]:
        """Activate freshly prefilled slots (one upload for the group), then
        record each request's first token (and its logprob), finishing it on
        EOS, its budget or a stop word. device_updated=True (the mixed step)
        skips the activation: the step made it on the device."""
        if not device_updated:
            slots = self._dev(np.array([r.slot for r in reqs], np.int64))
            vals = self._dev(np.stack([
                np.array([len(r.input_ids) for r in reqs], np.int32),
                tokens[:len(reqs)].astype(np.int32),
                np.array([r.max_new_tokens for r in reqs], np.int32)]))
            self.slot_lens[slots] = vals[0]
            self.slot_tokens[slots] = vals[1]
            self.slot_budget[slots] = vals[2]
            self.slot_active[slots] = True
            self.slot_gen[slots] = 1
            if self.max_bad_words:
                self._reseed_tail(slots, vals[1])
        finished = []
        for i, req in enumerate(reqs):
            if lps is not None:
                self._req_logprobs.setdefault(req.request_id, []).append(
                    float(lps[i]))
            if self._record_token(req, int(tokens[i])):
                self._release_slot(req.slot)
                finished.append(self._finish_recorded(req))
            elif self._stop_matched(req):
                finished.append(self._finish_stopped(req))
        return finished

    def _reseed_tail(self, slots, first_tokens):
        """Fresh slots' bad-word tails: the -2 sentinel, then the first
        token (bad words match generated ids only)."""
        rows = torch.full((len(slots), self.slot_tail.shape[1]), -2,
                          dtype=torch.int32, device=self.device)
        rows[:, -1] = first_tokens
        self.slot_tail[slots] = rows

    def _stop_matched(self, req: Request) -> bool:
        """Does the request's output end with one of its stop words (its
        own SamplingConfig's, or the engine's)? Checked on the host on the
        recorded ids; tokens the device decoded past the match are
        dropped with the slot."""
        out = req.output_ids
        for w in self._req_sampling.get(req.request_id, self.scfg).stop_words:
            if w and len(out) >= len(w) and tuple(out[-len(w):]) == tuple(w):
                return True
        return False

    def _finish_stopped(self, req: Request) -> FinishedRequest:
        t = self._req_times.get(req.request_id)
        if t is not None and t[2] is None:
            t[2] = time.perf_counter()
        self.scheduler.finish(req.request_id, "stop_words")
        self._release_slot(req.slot)
        return self._finished(req)

    def _finish_recorded(self, req: Request) -> FinishedRequest:
        """A request record_token just closed: a stop word completed by the
        token that exhausted its budget reports "stop_words", as the
        reference's stop criterion runs on the final step too."""
        if req.finished_reason == "length" and self._stop_matched(req):
            req.finished_reason = "stop_words"
        return self._finished(req)

    def _record_token(self, req: Request, token: int) -> bool:
        """scheduler.record_token + latency stamps (TTFT on the first
        recorded token, completion time when the request closes)."""
        done = self.scheduler.record_token(req.request_id, token,
                                           self.scfg.end_id)
        t = self._req_times.get(req.request_id)
        if t is not None:
            now = time.perf_counter()
            if t[1] is None:
                t[1] = now
            t[3] += 1
            if done:
                t[2] = now
        return done

    def latency_stats(self) -> dict:
        """TTFT / TPOT / end-to-end percentiles (seconds) over completed
        requests. TTFT includes queue wait. Times are chunk-granular: tokens
        become visible at chunk readback."""
        done = [t for t in self._req_times.values()
                if t[1] is not None and t[2] is not None]
        if not done:
            return {}

        def pct(a):
            a = np.asarray(a, np.float64)
            return {"p50": round(float(np.percentile(a, 50)), 4),
                    "p90": round(float(np.percentile(a, 90)), 4),
                    "p99": round(float(np.percentile(a, 99)), 4),
                    "mean": round(float(a.mean()), 4)}

        tpot = [(t[2] - t[1]) / (t[3] - 1) for t in done if t[3] > 1]
        return {"n_done": len(done),
                "ttft_s": pct([t[1] - t[0] for t in done]),
                "e2e_s": pct([t[2] - t[0] for t in done]),
                "tpot_s": pct(tpot) if tpot else None}

    def phase_stats(self) -> dict:
        """Mean milliseconds per engine step of each phase (admission /
        decode dispatch / chunk readback / host bookkeeping); the phases are
        disjoint in wall time within step()."""
        n = max(self.phase_times["steps"], 1)
        out = {k: round(1e3 * v / n, 3)
               for k, v in self.phase_times.items() if k != "steps"}
        out["steps"] = self.phase_times["steps"]
        return out

    def _finished(self, req: Request) -> FinishedRequest:
        self._req_sampling.pop(req.request_id, None)
        return FinishedRequest(
            req.request_id, req.output_ids, req.finished_reason,
            logprobs=self._req_logprobs.pop(req.request_id, None)
            if self.return_logprobs else None)

    def _release_slot(self, slot: int):
        self.slot_active[slot] = False
        if self.paged:
            self.kv_mgr.remove_sequence(slot)
            self._tables_np[slot] = self.trash_block

    def _host_table_row(self, slot: int) -> np.ndarray:
        """Block table row for a slot, -1 pads remapped to the trash block."""
        row = self.kv_mgr.block_table([slot])[0]
        return np.where(row < 0, self.trash_block, row).astype(np.int32)

    # ------------------------------------------------------------------
    def submit(self, input_ids: List[int], max_new_tokens: int,
               sampling: Optional[SamplingConfig] = None) -> int:
        """Queue a request. `sampling` (per_request_sampling=True) replaces
        the engine's default for this request."""
        if sampling is not None and not self.per_request:
            raise ValueError(
                "per-request sampling configs need per_request_sampling=True")
        if sampling is not None and sampling.bad_words:
            if not self.max_bad_words:
                raise ValueError("per-request bad_words need the engine "
                                 "built with max_bad_words > 0")
            if (len(sampling.bad_words) > self.max_bad_words or any(
                    not w or len(w) > self.max_bad_word_len
                    for w in sampling.bad_words)):
                raise ValueError(
                    f"bad_words exceed engine capacity (max "
                    f"{self.max_bad_words} words of length <= "
                    f"{self.max_bad_word_len}; empty words not allowed)")
            self._check_bad_word_ids(sampling.bad_words, self.cfg.vocab_size)
        rid = self.scheduler.submit(input_ids, max_new_tokens)
        self._req_times[rid] = [time.perf_counter(), None, None, 0]
        if sampling is not None:
            self._req_sampling[rid] = sampling
        return rid

    def poll(self, request_id: int) -> List[int]:
        """Tokens generated so far (streaming consumers read between
        steps)."""
        req = self.scheduler.get(request_id)
        if req is None:
            raise KeyError(request_id)
        return list(req.output_ids)

    def poll_logprobs(self, request_id: int) -> List[float]:
        """Logprobs of the tokens poll() returns (return_logprobs=True)."""
        if not self.return_logprobs:
            raise ValueError("engine built without return_logprobs")
        return list(self._req_logprobs.get(request_id, []))

    @torch.inference_mode()
    def cancel(self, request_id: int):
        """Cancel a queued or in-flight request, releasing its slot and
        blocks."""
        req = self.scheduler.get(request_id)
        slot = getattr(req, "slot", None) if req is not None else None
        in_flight = req is not None and req.state.name in ("PREFILL", "DECODE")
        self.scheduler.cancel(request_id)
        self._req_sampling.pop(request_id, None)
        self._req_logprobs.pop(request_id, None)
        self._partial.pop(request_id, None)
        if in_flight and slot is not None:
            self._release_slot(slot)

    # ------------------------------------------------------------------
    def _prefill_group(self, group: List[Request], bucket: int):
        """Prefill a same-bucket group in one batched call, each request's
        K/V written straight into its slot's rows (dense) or its blocks
        (paged), and sample its first tokens. Returns the device slots,
        prompt lengths, first tokens and their logprobs (or None)."""
        ids = np.full((len(group), bucket), self.scfg.pad_id, np.int32)
        for i, req in enumerate(group):
            ids[i, :len(req.input_ids)] = req.input_ids
        lengths = np.array([len(r.input_ids) for r in group], np.int32)
        slot_ids = [r.slot for r in group]
        slots = self._dev(np.array(slot_ids, np.int64))
        caches, write_slots = self.caches, slots
        if self.paged:
            for req in group:
                self.kv_mgr.add_sequence(req.slot, len(req.input_ids))
                self._tables_np[req.slot] = self._host_table_row(req.slot)
            # a view sharing the pools with the group's table rows: whole
            # bucket-padded blocks go to these requests' blocks or, past
            # them, the trash block
            caches = caches._replace(tables=self._dev(
                self._tables_np[slot_ids]))
            write_slots = None
        ids, lengths = self._dev(ids), self._dev(lengths)
        kw = {} if write_slots is None else {"slots": write_slots}
        logits, _ = self.model.forward_prefill(
            self.params, self.model_cfg, ids, lengths, caches, rope=self.rope,
            **kw)
        self._prefill_draft(ids, lengths, slots)
        self.calls["prefills"] += 1
        counts = None
        if self.per_request:
            self._set_slot_params(group)
            counts = init_token_counts(ids, lengths, self.cfg.vocab_size)
        tokens, lps = self._sample_admitted(logits, slots, counts)
        return slots, lengths, tokens, lps

    def _prefill_draft(self, ids, lengths, slots):
        """A speculative engine's draft prefill of the same group
        (runtime/serving_spec.py); nothing here."""

    def _admit_group(self, group: List[Request], bucket: int
                     ) -> List[FinishedRequest]:
        """Prefill a same-bucket group (_prefill_group), read its first
        tokens back and activate its slots."""
        _, _, tokens, lps = self._prefill_group(group, bucket)
        return self._register_prefilled(group, *self._read(tokens, lps))

    def _t_bucket(self, t: int) -> int:
        """Power-of-two ladder for the packed stream length."""
        b = 16
        cap = self.max_slots * self.engine_cfg.max_input_len
        while b < t and b < cap:
            b *= 2
        return min(b, max(cap, 16))

    def _admit_packed(self, reqs: List[Request]) -> List[FinishedRequest]:
        """Prefill every admitted request in one packed call (split when
        the stream exceeds the largest bucket)."""
        total = sum(len(r.input_ids) for r in reqs)
        tb = self._t_bucket(total)
        if total > tb:
            cut, acc = 0, 0
            for i, r in enumerate(reqs):
                if acc + len(r.input_ids) > tb:
                    cut = i
                    break
                acc += len(r.input_ids)
            return (self._admit_packed(reqs[:max(cut, 1)])
                    + self._admit_packed(reqs[max(cut, 1):]))
        token_ids, meta, last_idx = pack_prompts(
            [r.input_ids for r in reqs], [r.slot for r in reqs], tb,
            self.trash_slot, self.max_slots)
        meta, token_ids = self._dev(meta), self._dev(token_ids)
        logits, _ = self.model.forward_prefill_packed(
            self.params, self.model_cfg, token_ids, PackedMeta(*meta),
            self._dev(last_idx), self.caches, rope=self.rope)
        self.calls["packed_prefills"] += 1
        rows = counts = None
        if self.per_request:
            # every stream row samples (the unused ones on the trash
            # slot's neutral parameters); counts from the stream's tokens
            self._set_slot_params(reqs)
            ms = self.max_slots
            rows = self._dev(np.array([r.slot for r in reqs]
                                      + [self.trash_slot] * (ms - len(reqs)),
                                      np.int64))
            seg = meta[0].long()
            v = self.cfg.vocab_size
            counts = torch.zeros(((ms + 1) * v,), dtype=torch.int32,
                                 device=self.device)
            counts.scatter_add_(0, torch.where(seg >= 0, seg, ms) * v
                                + token_ids.long(), torch.ones_like(token_ids))
            counts = counts.view(ms + 1, v)[:ms]
        return self._register_prefilled(
            reqs, *self._read(*self._sample_admitted(logits, rows, counts)))

    def _advance_partials(self) -> List[FinishedRequest]:
        """Advance every partially prefilled request by one chunk, all in
        one forward_extend call over [n, C] prompt slabs at per-row starts
        into their slots' rows. A final chunk overlaps backward to stay
        exactly C tokens (identical K/V is rewritten; no pad writes); its
        last row's logits seed generation as a whole prefill's would, and
        its token activates the slot (per-request: counts from the full
        prompt). Calls with no final chunk read nothing back."""
        c = self.prefill_chunk
        parts = sorted(self._partial.items())
        n = len(parts)
        ids = np.full((n, c), self.scfg.pad_id, np.int32)
        starts = np.zeros((n,), np.int32)
        reqs, last = [], []
        for i, (rid, st) in enumerate(parts):
            req = self.scheduler.get(rid)
            st = min(st, len(req.input_ids) - c)
            ids[i] = req.input_ids[st:st + c]
            starts[i] = st
            reqs.append(req)
            if st + c >= len(req.input_ids):
                last.append(i)
            else:
                self._partial[rid] = st + c
        slots = self._dev(np.array([r.slot for r in reqs], np.int64))
        logits, _ = self.model.forward_extend(
            self.params, self.model_cfg, self._dev(ids), self._dev(starts),
            self.caches, rope=self.rope, slots=slots)
        self.calls["chunk_prefills"] += 1
        self.chunk_rows.append(n * c)
        if not last:
            return []
        done = [reqs[i] for i in last]
        for req in done:
            del self._partial[req.request_id]
        at = self._dev(np.array(last, np.int64))
        counts = None
        if self.per_request:
            # penalty state: the full prompts' token counts
            width = max(len(r.input_ids) for r in done)
            prompts = np.zeros((len(done), width), np.int32)
            for i, r in enumerate(done):
                prompts[i, :len(r.input_ids)] = r.input_ids
            counts = init_token_counts(
                self._dev(prompts), self._dev(np.array(
                    [len(r.input_ids) for r in done], np.int32)),
                self.cfg.vocab_size)
        tokens, lps = self._sample_admitted(logits[at, -1], slots[at], counts)
        return self._register_prefilled(done, *self._read(tokens, lps))

    def _decode_chunk(self, n_steps: int):
        """n_steps decode steps over every row, state kept on the device;
        returns the chunk's tokens [n_rows, n_steps] (pad_id where a row
        was inactive) and their logprobs (0.0 there; None without
        return_logprobs), not yet read back. Under chunked prefill an
        inactive row writes at max_seq_len, away from a partial prompt."""
        pad, end = self.scfg.pad_id, self.scfg.end_id
        tokens, lens = self.slot_tokens, self.slot_lens
        active, gen, budget = self.slot_active, self.slot_gen, self.slot_budget
        tail = self.slot_tail if self.max_bad_words else None
        counts = self.slot_counts if self.per_request else None
        parked = self.engine_cfg.max_seq_len
        out = torch.empty((self.n_rows, n_steps), dtype=torch.int32,
                          device=self.device)
        out_lp = (torch.zeros((self.n_rows, n_steps), dtype=torch.float32,
                              device=self.device)
                  if self.return_logprobs else None)
        for i in range(n_steps):
            pos = (torch.where(active, lens, parked)
                   if self.prefill_chunk is not None else lens)
            logits, self.caches = self.model.forward_decode(
                self.params, self.model_cfg, tokens, pos, self.caches,
                rope=self.rope)
            nxt = self._sample(logits, counts=counts, gen_lens=gen, tail=tail)
            if counts is not None:      # active rows count their token
                counts.scatter_add_(1, nxt.long()[:, None],
                                    active.to(torch.int32)[:, None])
            nxt = nxt.masked_fill(~active, pad)
            out[:, i] = nxt
            if tail is not None:
                # frozen slots roll pads in: they sample again only after
                # their tail is reseeded at the next admission
                tail = update_tail(tail, nxt)
            if out_lp is not None:
                out_lp[:, i] = torch.where(
                    active, self._chosen_logprobs(logits, nxt), 0.0)
            live = active.to(torch.int32)
            gen = gen + live
            lens = lens + live
            # freeze on EOS or when the slot's own budget is spent; the
            # other slots keep decoding full chunks
            active = active & (nxt != end) & (gen < budget)
            tokens = nxt.masked_fill(~active, pad)
        self.calls["decode_steps"] += n_steps
        self.slot_tokens, self.slot_lens = tokens, lens
        self.slot_active, self.slot_gen = active, gen
        if tail is not None:
            self.slot_tail = tail
        return out, out_lp

    def _admit_requests(self) -> List[Request]:
        """The scheduler's admissions; under chunked prefill the prompts
        longer than the chunk become partial requests (their first chunk
        runs this step) and only the others are returned."""
        admitted = self.scheduler.admit()
        if self.prefill_chunk is None:
            return admitted
        long = [r for r in admitted if len(r.input_ids) > self.prefill_chunk]
        for req in long:
            self._partial[req.request_id] = 0
        if self.per_request:
            self._set_slot_params(long)
        return [r for r in admitted if len(r.input_ids) <= self.prefill_chunk]

    def _by_bucket(self, reqs: List[Request]) -> Dict[int, List[Request]]:
        groups: Dict[int, List[Request]] = {}
        for req in reqs:
            groups.setdefault(self.engine_cfg.bucket_for(len(req.input_ids)),
                              []).append(req)
        return dict(sorted(groups.items()))

    def _admit(self, admitted: List[Request]) -> List[FinishedRequest]:
        """Prefill this step's admissions (one packed stream, or a batched
        call a bucket), then advance the partial prompts by a chunk."""
        finished: List[FinishedRequest] = []
        if self.packed:
            if admitted:
                finished.extend(self._admit_packed(admitted))
        else:
            for bucket, group in self._by_bucket(admitted).items():
                finished.extend(self._admit_group(group, bucket))
        if self._partial:
            finished.extend(self._advance_partials())
        return finished

    @torch.inference_mode()
    def step(self) -> List[FinishedRequest]:
        """One engine step: admit and prefill new requests (batched per
        bucket, or one packed stream) and advance chunked prompts, then
        decode up to decode_chunk tokens for every active slot. mixed_step
        folds a one-bucket admission into the decode chunk; pipelined
        reorders the phases (_step_pipelined). The engine's tp group is
        published for the step."""
        with tp_scope(self.group):
            return self._step()

    def _step(self) -> List[FinishedRequest]:
        if self.pipelined:
            return self._step_pipelined()
        t0 = time.perf_counter()
        admitted = self._admit_requests()
        if self.mixed and admitted:
            groups = self._by_bucket(admitted)
            if len(groups) == 1:
                (bucket, group), = groups.items()
                mixed = self._mixed_phase(group, bucket)
                if mixed is not None:
                    return mixed
        finished = self._admit(admitted)
        self.phase_times["admit"] += time.perf_counter() - t0
        self.phase_times["steps"] += 1
        if not self.scheduler.active_requests():
            return finished
        finished.extend(self._decode_phase())
        return finished

    def _step_pipelined(self) -> List[FinishedRequest]:
        """Dispatch chunk N first, then record chunk N-1 (its readback
        waits for N-1's copy alone, so the host's bookkeeping overlaps
        chunk N on the card), then admit: admissions prefill after chunk N
        on the stream and join chunk N+1."""
        finished: List[FinishedRequest] = []
        t0 = time.perf_counter()
        dispatched = self._decode_dispatch()
        self.phase_times["dispatch"] += time.perf_counter() - t0
        if self._pending_chunk is not None:
            finished.extend(self._decode_process(self._pending_chunk))
        self._pending_chunk = dispatched
        t0 = time.perf_counter()
        finished.extend(self._admit(self._admit_requests()))
        self.phase_times["admit"] += time.perf_counter() - t0
        self.phase_times["steps"] += 1
        return finished

    def _mixed_phase(self, reqs: List[Request], bucket: int
                     ) -> Optional[List[FinishedRequest]]:
        """One step with the admission's prefill and the decode chunk and
        one readback, or None when the step has no decode budget (the
        caller then runs them apart). The fresh slots are activated on the
        device, with the EOS / budget freeze the host applies between the
        separate calls; the prefill samples before the chunk's steps."""
        t0 = time.perf_counter()
        existing = [r for r in self.scheduler.active_requests()
                    if r not in reqs]
        budgets = ([r.max_new_tokens - len(r.output_ids) for r in existing]
                   + [r.max_new_tokens - 1 for r in reqs])
        chunk = min(self.decode_chunk, max(budgets)) if budgets else 0
        if chunk <= 0:
            return None
        slots, lengths, ptoks, plps = self._prefill_group(reqs, bucket)
        self.slot_tokens[slots] = ptoks
        self.slot_lens[slots] = lengths
        self.slot_budget[slots] = self._dev(np.array(
            [r.max_new_tokens for r in reqs], np.int32))
        self.slot_gen[slots] = 1
        self.slot_active[slots] = True
        if self.max_bad_words:
            self._reseed_tail(slots, ptoks)
        self.slot_active = (self.slot_active
                            & (self.slot_tokens != self.scfg.end_id)
                            & (self.slot_gen < self.slot_budget))
        slot_of = {r.slot: r for r in self.scheduler.active_requests()}
        out, out_lp = self._decode_chunk(chunk)
        staged = self._stage(ptoks, plps, out, out_lp)
        t1 = time.perf_counter()
        self.phase_times["dispatch"] += t1 - t0
        ptoks, plps, out, out_lp = self._collect(staged)
        t2 = time.perf_counter()
        self.phase_times["readback"] += t2 - t1
        finished = self._register_prefilled(reqs, ptoks, plps,
                                            device_updated=True)
        finished.extend(self._record_chunk(slot_of, out, out_lp))
        self.phase_times["host"] += time.perf_counter() - t2
        self.phase_times["steps"] += 1
        return finished

    def _decode_phase(self) -> List[FinishedRequest]:
        """Advance all decoding slots by one chunk and record the tokens."""
        t0 = time.perf_counter()
        pending = self._decode_dispatch()
        self.phase_times["dispatch"] += time.perf_counter() - t0
        if pending is None:
            return []
        return self._decode_process(pending)

    def _decode_dispatch(self):
        """Enqueue one decode chunk and the copy of its tokens; returns
        (slot -> request, steps a request was given, the staged copy) or
        None when there is nothing to decode. The chunk is long enough for
        the request with the most steps left (each slot freezes at its own
        budget on the device); the steps of the chunk still unrecorded
        (pipelined) count as taken, so a host that lags one chunk never
        dispatches past a budget."""
        decoding = [r for r in self.scheduler.active_requests()
                    if r.request_id not in self._partial]
        in_flight = {}
        if self._pending_chunk is not None:
            pending_of, pending_steps, _ = self._pending_chunk
            in_flight = {r.request_id: pending_steps[slot]
                         for slot, r in pending_of.items()}
        left = {r.slot: r.max_new_tokens - len(r.output_ids)
                - in_flight.get(r.request_id, 0) for r in decoding}
        chunk = min(self.decode_chunk, max(left.values())) if left else 0
        if chunk <= 0:
            return None
        slot_of = {r.slot: r for r in decoding}
        steps = {slot: max(0, min(chunk, n)) for slot, n in left.items()}
        if self.paged:
            # blocks for this chunk's writes, then the device tables from
            # the host mirror. The decode steps write positions len(prompt)
            # .. len(prompt) + max_new_tokens - 2; the clamp is against the
            # allocator's own length
            for slot, req in slot_of.items():
                room = (len(req.input_ids) + req.max_new_tokens - 1
                        - self.kv_mgr.seq_length(slot))
                for _ in range(max(0, min(steps[slot], room))):
                    self.kv_mgr.append_token(slot)
                self._tables_np[slot] = self._host_table_row(slot)
            self.caches = self.caches._replace(
                tables=self._dev(self._tables_np))
        out, out_lp = self._decode_chunk(chunk)
        return slot_of, steps, self._stage(out, out_lp)

    def _decode_process(self, pending) -> List[FinishedRequest]:
        """Read back one chunk (its one copy, waited on alone) and record
        its tokens."""
        slot_of, _, staged = pending
        t0 = time.perf_counter()
        out, out_lp = self._collect(staged)
        t1 = time.perf_counter()
        self.phase_times["readback"] += t1 - t0
        finished = self._record_chunk(slot_of, out, out_lp)
        self.phase_times["host"] += time.perf_counter() - t1
        return finished

    def _record_chunk(self, slot_of, out, out_lp, n_tokens=None
                      ) -> List[FinishedRequest]:
        """Record a chunk's tokens [n_rows, steps] for the requests it
        decoded (the first n_tokens[slot] of a row when given: a
        speculative chunk's commits); a request that finished while the
        chunk was in flight (pipelined: its slot may hold another request
        by now) is skipped."""
        finished: List[FinishedRequest] = []
        live = {r.request_id for r in self.scheduler.active_requests()}
        for slot, req in slot_of.items():
            if req.request_id not in live:
                continue
            row = out[slot] if n_tokens is None else out[slot, :n_tokens[slot]]
            for j, t in enumerate(row):
                if out_lp is not None:
                    self._req_logprobs.setdefault(req.request_id, []).append(
                        float(out_lp[slot, j]))
                if self._record_token(req, int(t)):
                    self._release_slot(slot)
                    finished.append(self._finish_recorded(req))
                    break
                if self._stop_matched(req):
                    finished.append(self._finish_stopped(req))
                    break
        return finished

    def run_to_completion(self, max_steps: int = 10_000
                          ) -> Dict[int, FinishedRequest]:
        """Drive until the queue drains and no chunk is left unrecorded
        (batch-mode convenience)."""
        done: Dict[int, FinishedRequest] = {}
        steps = 0
        while ((self.scheduler.has_work or self._pending_chunk is not None)
               and steps < max_steps):
            for fr in self.step():
                done[fr.request_id] = fr
            steps += 1
        return done
