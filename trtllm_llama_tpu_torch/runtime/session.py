"""GenerationSession: greedy generation (the port's `runtime/session.py`).

The JAX session jit-compiles prefill plus an on-device `lax.while_loop`;
here the same steps run eagerly as a Python loop over device tensors:
bucket the prompt, prefill, then decode one token per step with the
`done` / `lengths` / `positions` bookkeeping of the reference, until
`max_new_tokens` or every sequence hit `end_id`. The parameters may hold
any container the port runs (int8 / int4 weight-only, fp8, SmoothQuant,
a quantized lm_head): the model code dispatches on them. The model is
`model=` (llama, or a decoder family such as `models.decoder.BLOOM`) or
the one `models.by_architecture(cfg.architecture)` names.
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
from .sampling import SamplingConfig, sample_step


@dataclasses.dataclass
class GenerationOutput:
    """output_ids: [B, max_new] (pad_id after a sequence ends); lengths: [B]."""

    output_ids: np.ndarray
    lengths: np.ndarray


def _params_to(tree, device):
    if isinstance(tree, dict):
        return {k: _params_to(v, device) for k, v in tree.items()}
    return tree.to(device)


class GenerationSession:
    def __init__(self, cfg: ModelConfig, params, engine_cfg: EngineConfig,
                 kv_scales=None, device="cuda", model=None):
        """kv_scales: optional [L] int8-KV dequant scales (calibrated by the
        converter; 1.0 when omitted, as in the JAX package). model: the
        model object (default `by_architecture(cfg.architecture)`)."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.engine_cfg = engine_cfg
        self.model = model or by_architecture(cfg.architecture)
        self.kv_scales = (None if kv_scales is None else torch.as_tensor(
            np.asarray(kv_scales, np.float32), device=self.device))
        self.params = _params_to(params, self.device)
        # one device: fuse q/k/v into one matmul where the model has the
        # rewrite, as the JAX session does; gate/up fusion is opt-in there,
        # by the environment variable TLLM_FUSE_GU, and here the same
        fuse = getattr(self.model, "fuse_qkv_params", None)
        if fuse is not None:
            self.params = fuse(self.params)
        fuse_gu = getattr(self.model, "fuse_gate_up_params", None)
        if fuse_gu is not None and os.environ.get("TLLM_FUSE_GU"):
            self.params = fuse_gu(self.params)
        self.rope = self.model.rope_tables(cfg, device=self.device)

    def generate(self, input_ids, seq_lens=None,
                 sampling: Optional[SamplingConfig] = None,
                 max_new_tokens: int = 32) -> GenerationOutput:
        """input_ids: [B, S] numpy (right-padded with pad_id) or a list of
        token lists. Greedy decoding only."""
        scfg = sampling or SamplingConfig()
        scfg.check_supported()
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

        dev, cfg = self.device, self.cfg
        with torch.inference_mode():
            model = self.model
            caches = model.init_caches(cfg, b, max_len, dev, self.kv_scales)
            ids = torch.as_tensor(padded, device=dev)
            lens = torch.as_tensor(np.asarray(seq_lens, np.int32), device=dev)
            logits, caches = model.forward_prefill(self.params, cfg, ids, lens,
                                                   caches, rope=self.rope)
            tokens = sample_step(logits, scfg,
                                 torch.zeros(b, dtype=torch.int32, device=dev))
            out = torch.full((b, max_new_tokens), scfg.pad_id,
                             dtype=torch.int32, device=dev)
            out[:, 0] = tokens
            done = tokens == scfg.end_id
            lengths = torch.ones(b, dtype=torch.int32, device=dev)
            positions = lens.clone()
            step = 1
            while step < max_new_tokens and not bool(done.all()):
                logits, caches = model.forward_decode(
                    self.params, cfg, tokens, positions, caches,
                    rope=self.rope)
                gen_lens = torch.full((b,), step, dtype=torch.int32, device=dev)
                nxt = sample_step(logits, scfg, gen_lens)
                nxt = torch.where(done, torch.full_like(nxt, scfg.pad_id), nxt)
                out[:, step] = nxt
                live = (~done).to(torch.int32)
                lengths += live
                positions += live
                done = done | (nxt == scfg.end_id)
                tokens = nxt
                step += 1
        return GenerationOutput(out.cpu().numpy(), lengths.cpu().numpy())

