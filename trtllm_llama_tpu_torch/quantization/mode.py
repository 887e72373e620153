"""QuantMode: the quantization contract (bit flags and predicates).

The port's own copy of the JAX package's quantization/mode.py: the same
flags, values and predicates, so a `config.json` written by either package
means the same thing to both.
"""

from __future__ import annotations

import enum


class QuantMode(enum.IntFlag):
    NONE = 0
    INT4_WEIGHTS = enum.auto()
    INT8_WEIGHTS = enum.auto()
    ACTIVATIONS = enum.auto()       # activations quantized to int8 (W8A8)
    PER_CHANNEL = enum.auto()       # weight scales per output channel
    PER_TOKEN = enum.auto()         # dynamic activation scales per token
    PER_GROUP = enum.auto()         # grouped weight scales (TPU addition)
    INT8_KV_CACHE = enum.auto()
    FP8_KV_CACHE = enum.auto()
    FP8_QDQ = enum.auto()

    # ---- predicates (same surface as reference mode.py:24-72) ----
    def has_int4_weights(self) -> bool:
        return bool(self & QuantMode.INT4_WEIGHTS)

    def has_int8_weights(self) -> bool:
        return bool(self & QuantMode.INT8_WEIGHTS)

    def has_any_quant(self) -> bool:
        return bool(
            self
            & (
                QuantMode.INT4_WEIGHTS
                | QuantMode.INT8_WEIGHTS
                | QuantMode.ACTIVATIONS
                | QuantMode.INT8_KV_CACHE
                | QuantMode.FP8_KV_CACHE
                | QuantMode.FP8_QDQ
            )
        )

    def is_weight_only(self) -> bool:
        return ((self.has_int4_weights() or self.has_int8_weights())
                and not bool(self & QuantMode.ACTIVATIONS))

    def has_act_and_weight_quant(self) -> bool:
        return bool(self & QuantMode.ACTIVATIONS) and self.has_int8_weights()

    def has_act_static_scaling(self) -> bool:
        return bool(self & QuantMode.ACTIVATIONS) and not self.has_per_token_dynamic_scaling()

    def has_per_channel_scaling(self) -> bool:
        return bool(self & QuantMode.PER_CHANNEL)

    def has_per_token_dynamic_scaling(self) -> bool:
        return bool(self & QuantMode.PER_TOKEN)

    def has_per_group_scaling(self) -> bool:
        return bool(self & QuantMode.PER_GROUP)

    def has_int8_kv_cache(self) -> bool:
        return bool(self & QuantMode.INT8_KV_CACHE)

    def has_fp8_kv_cache(self) -> bool:
        return bool(self & QuantMode.FP8_KV_CACHE)

    def has_fp8_qdq(self) -> bool:
        return bool(self & QuantMode.FP8_QDQ)

    # ---- factories (reference mode.py:74-137) ----
    @staticmethod
    def use_smooth_quant(per_token: bool = False, per_channel: bool = False) -> "QuantMode":
        mode = QuantMode.INT8_WEIGHTS | QuantMode.ACTIVATIONS
        if per_token:
            mode |= QuantMode.PER_TOKEN
        if per_channel:
            mode |= QuantMode.PER_CHANNEL
        return mode

    @staticmethod
    def use_weight_only(use_int4_weights: bool = False, per_group: bool = False) -> "QuantMode":
        mode = QuantMode.INT4_WEIGHTS if use_int4_weights else QuantMode.INT8_WEIGHTS
        mode |= QuantMode.PER_CHANNEL
        if per_group:
            mode |= QuantMode.PER_GROUP
        return mode

    @staticmethod
    def from_description(
        quantize_weights: bool = False,
        quantize_activations: bool = False,
        per_token: bool = False,
        per_channel: bool = False,
        use_int4_weights: bool = False,
        use_int8_kv_cache: bool = False,
        use_fp8_kv_cache: bool = False,
        use_fp8_qdq: bool = False,
    ) -> "QuantMode":
        mode = QuantMode.NONE
        if quantize_weights and quantize_activations:
            mode = QuantMode.use_smooth_quant(per_token, per_channel)
        elif quantize_weights:
            mode = QuantMode.use_weight_only(use_int4_weights)
        if use_int8_kv_cache:
            mode |= QuantMode.INT8_KV_CACHE
        if use_fp8_kv_cache:
            mode |= QuantMode.FP8_KV_CACHE
        if use_fp8_qdq:
            mode |= QuantMode.FP8_QDQ
        return mode
