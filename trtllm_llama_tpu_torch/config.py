"""Model and engine configuration (the port's copy).

`ModelConfig` and `EngineConfig` carry the same fields, defaults, presets,
JSON form and `from_hf_config` as the JAX package's `config.py`, so one
`config.json` serves both packages. The dtype strings map to torch dtypes
here.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

import torch

from .quantization.mode import QuantMode

_DTYPE_MAP = {
    "float32": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "int8": torch.int8,
    # fp8 KV-cache storage: e4m3fn bit-codes in uint8 tensors
    "fp8": torch.uint8,
}


def str_dtype_to_torch(name: str) -> torch.dtype:
    return _DTYPE_MAP[name]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """LLaMA-family architecture description (fields as in the JAX package)."""

    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: int = 128
    max_position_embeddings: int = 2048
    rope_theta: float = 10000.0
    rotary_dim: int = 0
    rope_scaling_type: str = ""      # '', 'linear' or 'ntk'
    rope_scaling_factor: float = 1.0
    num_experts: int = 0
    experts_per_token: int = 2
    architecture: str = "llama"
    rms_norm_eps: float = 1e-6
    dtype: str = "bfloat16"          # activation/weight compute dtype
    quant_mode: QuantMode = QuantMode(0)
    group_size: int = 0              # 0 => per-channel weight-only scales
    tie_word_embeddings: bool = False

    @property
    def kv_dtype(self) -> str:
        if self.quant_mode.has_int8_kv_cache():
            return "int8"
        if self.quant_mode.has_fp8_kv_cache():
            return "fp8"
        return self.dtype

    @property
    def torch_dtype(self) -> torch.dtype:
        return str_dtype_to_torch(self.dtype)

    @classmethod
    def llama_7b(cls, **over) -> "ModelConfig":
        return cls(**over)

    @classmethod
    def tiny(cls, **over) -> "ModelConfig":
        """Small config for tests (the JAX package's `tiny`)."""
        d = dict(
            vocab_size=256, hidden_size=128, intermediate_size=256,
            num_layers=2, num_heads=4, num_kv_heads=4, head_dim=32,
            max_position_embeddings=128,
        )
        d.update(over)
        return cls(**d)

    @classmethod
    def from_hf_config(cls, hf_cfg: Any, **over) -> "ModelConfig":
        """Build from any object with the attributes of a transformers
        LlamaConfig (vocab_size, hidden_size, intermediate_size,
        num_hidden_layers, num_attention_heads, optional
        num_key_value_heads / head_dim / rope_theta / tie_word_embeddings /
        rope_scaling, max_position_embeddings, rms_norm_eps), as the JAX
        package's. rope_scaling types 'linear' and 'dynamic' / 'ntk' map to
        'linear' and 'ntk' with their factor (max_position_embeddings is
        taken as the extended window); any other type raises."""
        d = dict(
            vocab_size=hf_cfg.vocab_size,
            hidden_size=hf_cfg.hidden_size,
            intermediate_size=hf_cfg.intermediate_size,
            num_layers=hf_cfg.num_hidden_layers,
            num_heads=hf_cfg.num_attention_heads,
            num_kv_heads=getattr(hf_cfg, "num_key_value_heads", None)
            or hf_cfg.num_attention_heads,
            head_dim=getattr(hf_cfg, "head_dim", None)
            or hf_cfg.hidden_size // hf_cfg.num_attention_heads,
            max_position_embeddings=hf_cfg.max_position_embeddings,
            rope_theta=getattr(hf_cfg, "rope_theta", 10000.0),
            rms_norm_eps=hf_cfg.rms_norm_eps,
            tie_word_embeddings=getattr(hf_cfg, "tie_word_embeddings", False),
        )
        rs = getattr(hf_cfg, "rope_scaling", None)
        if rs:
            kind = rs.get("rope_type", rs.get("type", ""))
            if kind in ("linear", "dynamic", "ntk"):
                d["rope_scaling_type"] = "linear" if kind == "linear" else "ntk"
                d["rope_scaling_factor"] = float(rs.get("factor", 1.0))
            elif kind not in ("default", ""):
                # llama3 / yarn / longrope change inv_freq in ways the
                # engine does not implement: converting anyway would give
                # wrong logits at every position
                raise ValueError(f"unsupported rope_scaling type {kind!r} "
                                 "(supported: linear, dynamic/ntk)")
        d.update(over)
        return cls(**d)

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["quant_mode"] = int(self.quant_mode)
        return json.dumps(d, indent=2)

    @classmethod
    def from_json(cls, s: str) -> "ModelConfig":
        d = json.loads(s)
        d["quant_mode"] = QuantMode(d.get("quant_mode", 0))
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Serving-shape limits; prefill lengths are bucketed to
    `prefill_buckets` (a power-of-two ladder from 16 by default)."""

    max_batch_size: int = 8
    max_input_len: int = 1024
    max_seq_len: int = 2048          # input + generated
    prefill_buckets: tuple = ()

    def buckets(self) -> list:
        if self.prefill_buckets:
            return sorted(self.prefill_buckets)
        out, b = [], 16
        while b < self.max_input_len:
            out.append(b)
            b *= 2
        out.append(self.max_input_len)
        return out

    def bucket_for(self, n: int) -> int:
        for b in self.buckets():
            if n <= b:
                return b
        raise ValueError(f"input length {n} exceeds max_input_len {self.max_input_len}")
