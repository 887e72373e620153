"""Attention dispatch knobs (the port's copy of the JAX package's
`ops/registry.py`, its attention entries only).

The JAX registry also switches each Pallas kernel on or off and holds the
registered kernels; the port has no such switch: every kernel wrapper
launches its CUDA kernel for CUDA tensors and runs its plain PyTorch
version for CPU tensors. What is left are the knobs that pick between the
attention kernels:

- `decode_attn_mode` (read by `ops.attention.fused_decode_attention_at`,
  the dense decode step's write + attend):
  - 'auto', 'dma' and 'xla': kernel 3 (`kernels.decode_attention.
    dma_decode_attention`: the in-place write plus a flash-decoding split
    over the live 32-row chunks and a combine launch). The JAX package's
    'auto' picks its DMA kernel only at S_max >= its `decode_dma_min_s` (a
    crossover measured on a TPU) and XLA's scatter + einsum below it; the
    port has no such crossover and runs kernel 3 at every length, and for
    'xla' too;
  - 'split': the plain write (`write_kv_decode_at`), then the read-only
    kernel (`decode_attention_kernel`) over rows < positions + 1;
  - 'fused': the write and the attention in one launch with no chunk split
    (`fused_decode_attention`);
  - any other value raises `ValueError`.
  The paged decode (kernel 14) has no mode: the JAX package's
  `paged_attn_mode` picks between its Pallas kernel and XLA.
- `prefill_streaming_min_s` (read by `ops.attention.prefill_attention`):
  a prompt of more rows than this goes to the streaming prefill kernel
  (`kernels.streaming_prefill_attention`), a shorter one to kernel 2;
  None means 2048 and 0 sends every prompt to the streaming kernel.
"""

from __future__ import annotations

KERNELS = {
    "decode_attn_mode": "auto",
    "prefill_streaming_min_s": 2048,
}
