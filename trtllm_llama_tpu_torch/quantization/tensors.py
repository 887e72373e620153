"""Weight-only quantized weight container and its quantizer (torch).

The port's counterpart of the JAX package's `quantization/tensors.py`
(`WOQWeight`, `quantize_weight_only`, `concat_columns`). This slice carries
INT8 per-channel weights only; the container keeps the `w_bits`,
`group_size` and `pack_block` fields so the int4 / grouped layouts of the
engine dir map onto it unchanged when their kernels are ported.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class WOQWeight:
    """qweight: int8 [..., K, N]; scale: f32 [..., N] (per output channel)."""

    qweight: torch.Tensor
    scale: torch.Tensor
    w_bits: int = 8
    group_size: int = 0     # 0 => per-channel
    pack_block: int = 0     # int4 pack layout block (0 for int8)

    @property
    def k_dim(self) -> int:
        k = self.qweight.shape[-2]
        return 2 * k if self.w_bits == 4 else k

    def check_supported(self) -> None:
        if self.w_bits != 8 or self.group_size or self.pack_block:
            raise NotImplementedError(
                "only int8 per-channel weight-only weights are ported "
                f"(got w_bits={self.w_bits}, group_size={self.group_size})")

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        self.check_supported()
        return (self.qweight.float() * self.scale[..., None, :]).to(dtype)

    def to(self, device) -> "WOQWeight":
        return dataclasses.replace(self, qweight=self.qweight.to(device),
                                   scale=self.scale.to(device))


def quantize_weight_only(w: torch.Tensor, w_bits: int = 8,
                         group_size: int = 0) -> WOQWeight:
    """Quantize [..., K, N] weights per output channel: scale = amax/127,
    q = clip(round(w / scale), -127, 127) (round half to even)."""
    if w_bits != 8 or group_size:
        raise NotImplementedError("only int8 per-channel quantization is ported")
    wf = w.float()
    amax = wf.abs().amax(dim=-2)                                   # [..., N]
    scale = amax.clamp_min(1e-8) / 127.0
    q = torch.round(wf / scale[..., None, :]).clamp(-127, 127).to(torch.int8)
    return WOQWeight(q, scale.float())


def concat_columns(ws):
    """Concatenate weights sharing K along the output-channel axis (the
    q/k/v fusion). Exact: scales are per output column. Returns None when
    the inputs cannot be fused (mixed types or quantization metadata)."""
    t = type(ws[0])
    if any(type(w) is not t for w in ws):
        return None
    if t is WOQWeight:
        meta = (ws[0].w_bits, ws[0].group_size, ws[0].pack_block)
        if any((w.w_bits, w.group_size, w.pack_block) != meta for w in ws):
            return None
        return WOQWeight(torch.cat([w.qweight for w in ws], dim=-1),
                         torch.cat([w.scale for w in ws], dim=-1), *meta)
    if t is torch.Tensor:
        return torch.cat(list(ws), dim=-1)
    return None
