"""Offline converter: HF LLaMA -> quantized engine directory (the port's
`convert/convert.py`).

One entry point for every QuantMode, as in the JAX package:

    convert_hf_model(model, tokenizer, out_dir,
                     quant_mode=QuantMode.use_smooth_quant() | QuantMode.INT8_KV_CACHE,
                     calib_texts=[...])

calibrates the activation ranges where the mode needs them (SmoothQuant,
a quantized KV cache), migrates them with SmoothQuant alpha, loads the
state dict in f32, quantizes (static or per-token W8A8 scale sets,
weight-only int8 / int4, fp8), casts the remaining float leaves to the
engine dtype, and writes the engine dir with its per-layer KV scales.
Everything runs on the device of the HF model's tensors. The directory is
the JAX package's format v2: either package loads it.
"""

from __future__ import annotations

import os
from typing import Iterable, Optional

import torch

from ..config import ModelConfig
from ..quantization.calibrate import (act_ranges_for_smoothquant,
                                      capture_activation_ranges,
                                      kv_scales_from_ranges)
from ..quantization.mode import QuantMode
from ..quantization.quantize import quantize_params
from ..quantization.smoothquant import smooth_hf_state_dict
from .hf import params_from_hf_state_dict
from .serialize import save_engine


def convert_hf_model(hf_model, tokenizer, out_dir: str,
                     quant_mode: QuantMode = QuantMode.NONE,
                     group_size: int = 0,
                     dtype: str = "bfloat16",
                     calib_texts: Optional[Iterable[str]] = None,
                     calib_max_seq_len: int = 512,
                     smoothquant_alpha: float = 0.5,
                     quantize_lm_head: bool = False) -> ModelConfig:
    """Convert a loaded transformers LlamaForCausalLM into an engine dir;
    returns its ModelConfig."""
    cfg = ModelConfig.from_hf_config(hf_model.config, dtype=dtype,
                                     quant_mode=quant_mode,
                                     group_size=group_size)
    needs_calib = (quant_mode.has_act_and_weight_quant()
                   or quant_mode.has_int8_kv_cache()
                   or quant_mode.has_fp8_kv_cache())
    ranges = None
    if needs_calib:
        if calib_texts is None:
            raise ValueError(
                "SmoothQuant / quantized-KV conversion requires calib_texts "
                "(the reference uses the lambada set)")
        ranges = capture_activation_ranges(
            hf_model, tokenizer, calib_texts, max_seq_len=calib_max_seq_len)

    sd = hf_model.state_dict()
    act_ranges = None
    if quant_mode.has_act_and_weight_quant():
        sd, x_absmax = smooth_hf_state_dict(
            sd, ranges, cfg.num_layers, alpha=smoothquant_alpha)
        act_ranges = act_ranges_for_smoothquant({"x_absmax": x_absmax})

    # quantize from f32 weights (a bf16 cast first would round the int
    # values and their scales twice); the other float leaves are cast to
    # the engine dtype afterwards
    load_dtype = "float32" if quant_mode.has_any_quant() else dtype
    params = params_from_hf_state_dict(sd, cfg, dtype=load_dtype)
    del sd
    params = quantize_params(params, quant_mode, group_size,
                             act_ranges=act_ranges,
                             quantize_lm_head=quantize_lm_head)
    if load_dtype != dtype:
        params = cast_fp_leaves(params, cfg.torch_dtype)

    kv_scales = None
    if quant_mode.has_int8_kv_cache():
        kv_scales = kv_scales_from_ranges(ranges)
    elif quant_mode.has_fp8_kv_cache():
        kv_scales = kv_scales_from_ranges(ranges, qmax=448.0)
    os.makedirs(out_dir, exist_ok=True)
    save_engine(out_dir, cfg, params, kv_scales)
    return cfg


def cast_fp_leaves(params, dtype: torch.dtype):
    """Plain f32 tensors (norms, embedding, lm_head, unquantized
    projections) cast to the engine dtype; quantized containers are left
    whole, so their f32 scales stay f32."""
    if isinstance(params, dict):
        return {k: cast_fp_leaves(v, dtype) for k, v in params.items()}
    if isinstance(params, torch.Tensor) and params.dtype == torch.float32:
        return params.to(dtype)
    return params


def convert_hf_checkpoint(model_dir: str, out_dir: str, device="cuda",
                          **kwargs):
    """Load a HF LLaMA checkpoint from disk, move it to `device` (the card
    unless the caller asks for the CPU) and convert it there (the CLI
    entry). A Mixtral checkpoint raises: its converter (`convert/hf_moe.py`
    of the JAX package) is not ported yet."""
    from transformers import AutoConfig, AutoTokenizer, LlamaForCausalLM

    arch = (getattr(AutoConfig.from_pretrained(model_dir),
                    "architectures", None) or ["Llama"])[0]
    if "mixtral" in arch.lower():
        raise NotImplementedError(
            "Mixtral checkpoints (convert/hf_moe.py of the JAX package) are "
            "not ported yet")
    tokenizer = AutoTokenizer.from_pretrained(model_dir)
    model = LlamaForCausalLM.from_pretrained(
        model_dir, torch_dtype="auto", low_cpu_mem_usage=True).to(device)
    return convert_hf_model(model, tokenizer, out_dir, **kwargs)
