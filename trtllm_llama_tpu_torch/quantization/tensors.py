"""Quantized weight containers, their quantizers and the int8 helpers
(torch).

The port's counterpart of the JAX package's `quantization/tensors.py`:
`WOQWeight` / `quantize_weight_only` (INT8 per-channel weight-only; the
container keeps the `w_bits`, `group_size` and `pack_block` fields so the
int4 / grouped layouts of the engine dir map onto it unchanged when their
kernels are ported), `SQWeight` / `quantize_smoothquant_weight`
(SmoothQuant W8A8), `concat_columns`, and the symmetric int8 primitives
used for weights, activations and the KV cache. Rounding is torch.round
(half to even) of a true division, as jnp.round of the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch


def absmax_scale(x, dim=None, keepdim=False, eps=1e-8):
    """scale such that x / scale fits int8: max(amax, eps) / 127."""
    xa = x.float().abs()
    amax = xa.amax() if dim is None else xa.amax(dim=dim, keepdim=keepdim)
    return amax.clamp_min(eps) / 127.0


def quantize_int8(x, scale):
    """Symmetric round-to-nearest-even int8: clip(round(x / scale), +-127)."""
    return torch.round(x.float() / scale).clamp(-127, 127).to(torch.int8)


def quantize_per_token(x):
    """x [..., K] -> (int8 x_q, f32 per-row scale [..., 1])."""
    scale = absmax_scale(x, dim=-1, keepdim=True)
    return quantize_int8(x, scale), scale


def quantize_static(x, scale_x):
    """Static per-tensor activation quantization."""
    return quantize_int8(x, scale_x)


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
    scale = absmax_scale(w, dim=-2)                                # [..., N]
    return WOQWeight(quantize_int8(w, scale[..., None, :]), scale)


@dataclasses.dataclass
class SQWeight:
    """SmoothQuant W8A8 weight with static scale sets (the JAX package's
    semantics): scale_w = w_amax / 127 per output channel [..., N] or per
    tensor [..., 1]; scale_x = x_amax / 127, the static per-tensor
    activation scale (ignored in per-token mode, which computes dynamic
    per-row scales); scale_y = y_amax / 127 (unused: the epilogue
    dequantizes to floating point)."""

    qweight: torch.Tensor      # int8 [..., K, N]
    scale_w: torch.Tensor      # f32 [..., N] or [..., 1]
    scale_x: torch.Tensor      # f32 [...] (one per stacked layer)
    scale_y: torch.Tensor      # f32 [...]
    per_channel: bool = True
    per_token: bool = True

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        return (self.qweight.float() * self.scale_w[..., None, :]).to(dtype)

    def to(self, device) -> "SQWeight":
        return dataclasses.replace(
            self, qweight=self.qweight.to(device),
            scale_w=self.scale_w.to(device), scale_x=self.scale_x.to(device),
            scale_y=self.scale_y.to(device))


def quantize_smoothquant_weight(w, act_amax, y_amax=None, per_channel=True,
                                per_token=True) -> SQWeight:
    """SQWeight from float weights [..., K, N] and the calibrated max |x|
    feeding them (a scalar or one per stacked layer)."""
    w = w.float()
    if per_channel:
        scale_w = absmax_scale(w, dim=-2)                          # [..., N]
    else:
        scale_w = absmax_scale(w, dim=(-2, -1)).unsqueeze(-1)      # [..., 1]
    q = quantize_int8(w, scale_w[..., None, :])
    act_amax = torch.as_tensor(act_amax, dtype=torch.float32)
    scale_x = act_amax.clamp_min(1e-8) / 127.0
    scale_y = (torch.as_tensor(y_amax, dtype=torch.float32).clamp_min(1e-8)
               / 127.0 if y_amax is not None else torch.ones_like(scale_x))
    return SQWeight(q, scale_w, scale_x, scale_y, per_channel, per_token)


def concat_columns(ws):
    """Concatenate weights sharing K along the output-channel axis (the
    q/k/v fusion). Exact: scales are per output column (a per-tensor SQ
    scale becomes constant columns). Returns None when the inputs cannot
    be fused (mixed types or quantization metadata, static-SQ members with
    differing activation scales)."""
    t = type(ws[0])
    if any(type(w) is not t for w in ws):
        return None
    if t is WOQWeight:
        meta = (ws[0].w_bits, ws[0].group_size, ws[0].pack_block)
        if any((w.w_bits, w.group_size, w.pack_block) != meta for w in ws):
            return None
        return WOQWeight(torch.cat([w.qweight for w in ws], dim=-1),
                         torch.cat([w.scale for w in ws], dim=-1), *meta)
    if t is SQWeight:
        if any(w.per_token != ws[0].per_token for w in ws):
            return None
        if not ws[0].per_token and any(
                w.scale_x.shape != ws[0].scale_x.shape
                or not torch.allclose(w.scale_x, ws[0].scale_x) for w in ws):
            return None    # the static act scale is baked into the input
        sw = [w.scale_w if w.per_channel else
              w.scale_w.expand(*w.scale_w.shape[:-1], w.qweight.shape[-1])
              for w in ws]
        return SQWeight(torch.cat([w.qweight for w in ws], dim=-1),
                        torch.cat(sw, dim=-1), ws[0].scale_x, ws[0].scale_y,
                        per_channel=True, per_token=ws[0].per_token)
    if t is torch.Tensor:
        return torch.cat(list(ws), dim=-1)
    return None
