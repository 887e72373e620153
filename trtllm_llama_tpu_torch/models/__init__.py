"""Model families.

`by_architecture` maps the ModelConfig.architecture tag to the object that
implements the forward contract (init_caches / rope_tables /
forward_prefill / forward_decode): the `llama` module, or one of the
decoder families of `models/decoder.py`.
"""


def by_architecture(name: str):
    """The model of a ModelConfig.architecture tag (default llama)."""
    name = (name or "llama").lower()
    if name == "llama":
        from . import llama
        return llama
    from . import decoder
    families = {"gptj": decoder.GPTJ, "gpt-j": decoder.GPTJ,
                "gptneox": decoder.GPTNEOX, "gpt-neox": decoder.GPTNEOX,
                "bloom": decoder.BLOOM, "opt": decoder.OPT,
                "falcon": decoder.FALCON}
    if name in families:
        return families[name]
    unported = {"gpt": "models/gpt.py", "gpt2": "models/gpt.py",
                "chatglm": "models/chatglm.py", "mixtral": "models/moe.py"}
    if name in unported:
        raise NotImplementedError(
            f"architecture {name!r} ({unported[name]} of the JAX package) is "
            "not ported yet")
    raise ValueError(f"unknown architecture {name!r}")
