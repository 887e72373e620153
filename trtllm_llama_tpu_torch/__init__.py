"""PyTorch/CUDA port of trtllm_llama_tpu for NVIDIA Hopper (H100).

The JAX package `trtllm_llama_tpu` is the reference; this package imports
nothing of it (nor JAX). Entry points run on the GPU by default and on the
CPU only when asked (`device="cpu"`), where every kernel wrapper takes its
plain PyTorch version.
"""

from .config import EngineConfig, ModelConfig
from .quantization.mode import QuantMode

__all__ = ["EngineConfig", "ModelConfig", "QuantMode"]
