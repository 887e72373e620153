"""Dispatch knobs (the port's copy of the JAX package's `ops/registry.py`:
its attention entries, the tensor-parallel overlap knobs and the active
tp group).

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
- `overlap_chunks` (default 4) and `overlap_min_rows` (default 64), read
  by `ops.linear`'s row-parallel path (`_row_overlap`), with the JAX
  package's meaning: a row-parallel matmul of at least `overlap_min_rows`
  rows whose N splits into `overlap_chunks` windows of whole 128 columns
  runs one windowed kernel launch (`n_window`) per window, each followed
  by its asynchronous all-reduce, so that one window's all-reduce overlaps
  the next window's matmul; the outputs are bit-identical to one launch
  and one all-reduce (no K sum is reassociated). Fewer rows (decode,
  whose all-reduce is latency-bound) or 0 / 1 chunks take one launch and
  one all-reduce.
- `tp_group`: the tensor-parallel process group of the session or engine
  whose call is running (None: one device). Each session and serving
  engine publishes its own before every call, as the JAX package's
  publish `KERNELS["mesh"]`; `ops.linear`'s `part=` paths and the
  models' logits read it.
"""

from __future__ import annotations

KERNELS = {
    "decode_attn_mode": "auto",
    "prefill_streaming_min_s": 2048,
    "overlap_chunks": 4,
    "overlap_min_rows": 64,
    "tp_group": None,
}
