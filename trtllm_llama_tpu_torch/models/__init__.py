"""Model families.

`by_architecture` maps the ModelConfig.architecture tag to the object that
implements the forward contract: the `llama` module, the `gpt` module
(GPT-2, with prompt tuning), or one of the decoder families of
`models/decoder.py`. Every model has

- init_caches(cfg, batch, max_len, device, kv_scales) -> dense KVCache;
- rope_tables(cfg, device) -> (cos, sin), or None without rotary;
- forward_prefill(params, cfg, ids [B, S], lens [B], caches,
  return_all_logits=False, rope=None, slots=None) -> (logits, caches)
  (gpt and the decoder families also take prompt=, a
  `models.gpt.PromptTuning`);
- forward_extend(params, cfg, tokens [B, T], start [B], caches, rope=None,
  slots=None) -> (logits [B, T, V], caches), a slab at per-row offsets;
- forward_decode(params, cfg, tokens [B], positions [B], caches,
  rope=None) -> (logits [B, V], caches).

`slots` [B] are the dense cache rows a call writes (default 0..B-1). Only
llama has `forward_prefill_packed`, `fuse_qkv_params` and a paged KV pool
(`PAGED_CACHE`); the serving engine checks for them.
"""


def by_architecture(name: str):
    """The model of a ModelConfig.architecture tag (default llama)."""
    name = (name or "llama").lower()
    if name == "llama":
        from . import llama
        return llama
    if name in ("gpt", "gpt2"):
        from . import gpt
        return gpt
    from . import decoder
    families = {"gptj": decoder.GPTJ, "gpt-j": decoder.GPTJ,
                "gptneox": decoder.GPTNEOX, "gpt-neox": decoder.GPTNEOX,
                "bloom": decoder.BLOOM, "opt": decoder.OPT,
                "falcon": decoder.FALCON}
    if name in families:
        return families[name]
    unported = {"chatglm": "models/chatglm.py", "mixtral": "models/moe.py"}
    if name in unported:
        raise NotImplementedError(
            f"architecture {name!r} ({unported[name]} of the JAX package) is "
            "not ported yet")
    raise ValueError(f"unknown architecture {name!r}")
