"""Quantized weight containers, their quantizers and the int8 helpers
(torch).

The port's counterpart of the JAX package's `quantization/tensors.py`:
`WOQWeight` / `quantize_weight_only` (weight-only INT8 or INT4, per output
channel or with grouped scales along K; INT4 in the JAX package's biased,
quartered pack layout, `pack_int4`), `FP8Weight` / `quantize_fp8_weight`
(e4m3 byte codes with per-channel scales, rows interleaved by
`interleave_fp8_rows`), `SQWeight` / `quantize_smoothquant_weight`
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


# ---------------------------------------------------------------------------
# INT4 packing: two nibbles per int8 byte along the contraction axis
# ---------------------------------------------------------------------------

INT4_BIAS = 8   # nibbles are stored biased-unsigned: u = q + 8 in [0, 15]


def default_pack_block(k: int, group_size: int = 0) -> int:
    """The int4 pack block: group_size when grouped, else the largest of
    128/64/32/16/8 dividing K."""
    if group_size:
        return group_size
    for pb in (128, 64, 32, 16, 8):
        if k % pb == 0:
            return pb
    raise ValueError(f"K={k} must be a multiple of 8 for int4 packing")


def pack_int4(q, pack_block: int):
    """Pack ints in [-8, 7] along axis -2 (K) into int8 bytes of biased
    nibbles (u = q + 8), in the JAX package's quartered layout: block b's
    pb logical rows split into quarters A|B|C|D; packed row 2m holds
    (lo=A[m], hi=C[m]) and packed row 2m+1 holds (lo=B[m], hi=D[m])."""
    k, n = q.shape[-2], q.shape[-1]
    pb = pack_block
    if pb % 8 or k % pb:
        raise ValueError(f"pack_int4: K={k} is not whole blocks of {pb}")
    lead = q.shape[:-2]
    u = (q.to(torch.int32) + INT4_BIAS).to(torch.uint8)
    ub = u.reshape(*lead, k // pb, 4, pb // 4, n)                # quarters
    lo = ub[..., 0:2, :, :].transpose(-3, -2).reshape(*lead, k // pb, pb // 2, n)
    hi = ub[..., 2:4, :, :].transpose(-3, -2).reshape(*lead, k // pb, pb // 2, n)
    packed = (lo & 0xF) | ((hi & 0xF) << 4)
    return packed.reshape(*lead, k // 2, n).contiguous().view(torch.int8)


def unpack_int4(packed, pack_block: int):
    """Inverse of pack_int4: [..., K//2, N] -> [..., K, N] int8 in [-8, 7]."""
    pb = pack_block
    k2, n = packed.shape[-2], packed.shape[-1]
    lead = packed.shape[:-2]
    b = packed.view(torch.uint8).reshape(*lead, (2 * k2) // pb, pb // 4, 2, n)
    lo = ((b & 0xF).to(torch.int32) - INT4_BIAS).transpose(-3, -2)
    hi = ((b >> 4).to(torch.int32) - INT4_BIAS).transpose(-3, -2)
    out = torch.cat([lo, hi], dim=-3)             # [.., 4 (A|B|C|D), pb/4, n]
    return out.reshape(*lead, 2 * k2, n).to(torch.int8)


# ---------------------------------------------------------------------------
# Weight-only containers
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class WOQWeight:
    """Weight-only quantized weight.

    qweight: int8 [..., K, N] (w_bits 8) or packed int4 [..., K//2, N]
             (w_bits 4, pack_int4 layout with block `pack_block`);
    scale:   f32 [..., N] per output channel, or [..., K//g, N] with
             `group_size` g > 0 (for int4, g == pack_block).
    """

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
        """Raise for layouts the port does not run: int4 needs a pack block
        (and grouped int4 a group equal to it, as the JAX kernel asserts);
        int8 has none."""
        ok = ((self.w_bits == 8 and not self.pack_block)
              or (self.w_bits == 4 and self.pack_block > 0
                  and self.group_size in (0, self.pack_block)))
        if not ok:
            raise NotImplementedError(
                "weight-only layout not ported: w_bits="
                f"{self.w_bits}, group_size={self.group_size}, "
                f"pack_block={self.pack_block}")

    def codes(self, layer=None) -> torch.Tensor:
        """Unpacked int8 codes [..., K, N] (of one stacked layer if given)."""
        q = self.qweight if layer is None else self.qweight[layer]
        return unpack_int4(q, self.pack_block) if self.w_bits == 4 else q

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        self.check_supported()
        q = self.codes()
        if self.group_size:
            g = self.group_size
            shp = q.shape
            qg = q.reshape(*shp[:-2], shp[-2] // g, g, shp[-1]).float()
            return (qg * self.scale[..., :, None, :]).reshape(shp).to(dtype)
        return (q.float() * self.scale[..., None, :]).to(dtype)

    def to(self, device) -> "WOQWeight":
        return dataclasses.replace(self, qweight=self.qweight.to(device),
                                   scale=self.scale.to(device))


def quantize_weight_only(w: torch.Tensor, w_bits: int = 8,
                         group_size: int = 0) -> WOQWeight:
    """Quantize [..., K, N] weights per output channel, or per group of
    `group_size` K rows: scale = max(amax, 1e-8) / qmax (qmax 127 or 7),
    q = clip(round(w / scale), -qmax, qmax) (round half to even); int4
    codes are packed by pack_int4."""
    if w_bits not in (4, 8):
        raise ValueError(f"w_bits must be 4 or 8, got {w_bits}")
    qmax = 7.0 if w_bits == 4 else 127.0
    w = w.float()
    if group_size:
        g = group_size
        shp = w.shape
        if shp[-2] % g:
            raise ValueError(f"K={shp[-2]} is not a multiple of group {g}")
        wg = w.reshape(*shp[:-2], shp[-2] // g, g, shp[-1])
        scale = wg.abs().amax(dim=-2).clamp_min(1e-8) / qmax     # [..., K//g, N]
        q = torch.round(wg / scale[..., :, None, :]).clamp(-qmax, qmax)
        q = q.reshape(shp).to(torch.int8)
    else:
        scale = w.abs().amax(dim=-2).clamp_min(1e-8) / qmax      # [..., N]
        q = torch.round(w / scale[..., None, :]).clamp(-qmax, qmax).to(torch.int8)
    pack_block = 0
    if w_bits == 4:
        pack_block = default_pack_block(w.shape[-2], group_size)
        q = pack_int4(q, pack_block)
    return WOQWeight(q, scale, w_bits, group_size, pack_block)


# ---------------------------------------------------------------------------
# FP8 (e4m3fn) weights
# ---------------------------------------------------------------------------

FP8_INTERLEAVE_BLOCK = 128


def interleave_fp8_rows(q, block: int):
    """Reorder rows within each `block` K rows: stored row 2m holds logical
    row m (first half), stored row 2m+1 logical row block/2 + m."""
    k, n = q.shape[-2], q.shape[-1]
    if block % 8 or k % block:
        raise ValueError(f"interleave_fp8_rows: K={k}, block {block}")
    b = q.reshape(*q.shape[:-2], k // block, 2, block // 2, n)
    return b.transpose(-3, -2).reshape(q.shape)


def deinterleave_fp8_rows(q, block: int):
    """Inverse of interleave_fp8_rows."""
    k, n = q.shape[-2], q.shape[-1]
    b = q.reshape(*q.shape[:-2], k // block, block // 2, 2, n)
    return b.transpose(-3, -2).reshape(q.shape)


@dataclasses.dataclass
class FP8Weight:
    """FP8 (e4m3fn) weight (QuantMode.FP8_QDQ).

    qweight: uint8 [..., K, N] e4m3fn codes (ops/fp8.py codec);
    scale:   f32 [..., N] per-channel dequant scale (amax -> 448);
    interleave_block: 0 = logical row order; > 0 = rows permuted by
             interleave_fp8_rows(., block).
    """

    qweight: torch.Tensor
    scale: torch.Tensor
    interleave_block: int = 0

    @property
    def k_dim(self) -> int:
        return self.qweight.shape[-2]

    def codes(self, layer=None) -> torch.Tensor:
        """Codes [..., K, N] in logical row order (of one layer if given)."""
        q = self.qweight if layer is None else self.qweight[layer]
        ib = self.interleave_block
        return deinterleave_fp8_rows(q, ib) if ib else q

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        from ..ops.fp8 import fp8_decode
        return (fp8_decode(self.codes()) * self.scale[..., None, :]).to(dtype)

    def to(self, device) -> "FP8Weight":
        return dataclasses.replace(self, qweight=self.qweight.to(device),
                                   scale=self.scale.to(device))


def quantize_fp8_weight(w) -> FP8Weight:
    """Quantize [..., K, N] weights to e4m3 with per-channel scales
    (amax / 448). Subnormal codes (the 14 smallest nonzero magnitudes) are
    flushed to signed zero and the NaN codes never emitted, the JAX
    package's storage contract; rows are interleaved by 128 when K allows."""
    from ..ops.fp8 import FP8_MAX, fp8_encode
    w = w.float()
    scale = w.abs().amax(dim=-2).clamp_min(1e-8) / FP8_MAX         # [..., N]
    q = fp8_encode(w / scale[..., None, :])
    q = torch.where((q & 0x7F) < 8, q & 0x80, q)    # flush subnormals to +-0
    ib = FP8_INTERLEAVE_BLOCK if w.shape[-2] % FP8_INTERLEAVE_BLOCK == 0 else 0
    if ib:
        q = interleave_fp8_rows(q, ib)
    return FP8Weight(q.contiguous(), scale, ib)


# ---------------------------------------------------------------------------
# SmoothQuant W8A8
# ---------------------------------------------------------------------------

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
    act_amax = torch.as_tensor(act_amax, dtype=torch.float32, device=w.device)
    scale_x = act_amax.clamp_min(1e-8) / 127.0
    scale_y = (torch.as_tensor(y_amax, dtype=torch.float32, device=w.device)
               .clamp_min(1e-8) / 127.0 if y_amax is not None
               else torch.ones_like(scale_x))
    return SQWeight(q, scale_w, scale_x, scale_y, per_channel, per_token)


def concat_columns(ws):
    """Concatenate weights sharing K along the output-channel axis (the
    q/k/v fusion). Exact: codes, packing and scales are all per output
    column (a per-tensor SQ scale becomes constant columns). Returns None
    when the inputs cannot be fused (mixed types or quantization metadata,
    static-SQ members with differing activation scales)."""
    t = type(ws[0])
    if any(type(w) is not t for w in ws):
        return None
    if t is WOQWeight:
        meta = (ws[0].w_bits, ws[0].group_size, ws[0].pack_block)
        if any((w.w_bits, w.group_size, w.pack_block) != meta for w in ws):
            return None
        return WOQWeight(torch.cat([w.qweight for w in ws], dim=-1),
                         torch.cat([w.scale for w in ws], dim=-1), *meta)
    if t is FP8Weight:
        if any(w.interleave_block != ws[0].interleave_block for w in ws):
            return None
        return FP8Weight(torch.cat([w.qweight for w in ws], dim=-1),
                         torch.cat([w.scale for w in ws], dim=-1),
                         ws[0].interleave_block)
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
