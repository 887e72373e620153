"""Kernel 1: weight-only INT8 / INT4 matmul: three CUDA bodies, picked from
the call before launch.

Replaces `trtllm_llama_tpu/ops/pallas/woq_matmul.py::woq_matmul_stacked`
(int8 and int4 branches, per-channel or grouped scales, the norm and
SwiGLU prologues, the residual epilogue) and its 2-D form `woq_matmul`.
Bound on the H100: the weight bytes at decode rows (a GEMV at M <= 16
does 2*M flops per int8 byte, 4*M per int4 byte); above ~300 rows the
operations.
- The tensor-core GEMV (csrc/woq_gemv_tc.cu, body in csrc/woq_gemv_tc.cuh)
  takes bf16 / fp16 calls of TC_MIN_ROWS..16 rows on a layout it tiles
  (`tc_route`): mma.sync with the weight as the A operand, its codes read
  once per call into registers and decoded there by byte permutes, K in
  stored order, split-K blocks whose sums a second launch adds up (from
  the per-stream workspace `_build.workspace`).
- The one-row GEMV (csrc/woq_matmul.cu, body in csrc/woq_gemv.cuh on
  csrc/gemv_stream.cuh) takes one-row calls, f32 at every row count and
  the layouts neither tensor-core body tiles: one launch that streams the
  weight in 16-byte loads from a register ring over a grid of column
  tiles x K splits sized to one wave (`gemv_plan`), one FFMA per weight
  and row, the splits merged in the kernel by the last block of each
  column tile (from the per-stream workspace `_build.workspace`).
- The tensor-core GEMM (csrc/woq_gemm.cu, body in csrc/woq_gemm.cuh) takes
  bf16 / fp16 calls of at least GEMM_MIN_ROWS rows with no prologue and no
  residual on a layout it tiles (`gemm_route`): each K tile's codes
  decoded into shared memory once per 128-row M tile, then wgmma.

`woq_matmul_stacked` and `woq_matmul` take the plain version for CPU
tensors and launch a kernel for CUDA tensors; each counts its launches
in `.launches`, the GEMM's share of them in `.gemm_launches` and the
tensor-core GEMV's in `.tc_launches` (`woq_matmul_stacked.swiglu_launches`
counts the GEMV launches with the SwiGLU prologue, `.ragged_launches` the
GEMM launches on a K that is not whole 128-row tiles).

`n_window=(start, length)` (the stacked entries; tensor parallelism's
row-parallel overlap, `ops/linear.py::_row_overlap`) computes only the
output columns [start, start + length), as the JAX kernel's `n_window`
does: every body takes the weight (and grouped scales) from column
`start` with the full N as its row stride (`ldw`), so nothing of the
weight is copied, and plans its grid from the full N (`gemv_plan`,
`tc_plan`, `_gemm_split`), so that a window equals the full call's
columns bit for bit. Windows are whole WINDOW_ALIGN columns (the tensor-
core GEMV's: whole column tiles of 16 nt), exclude the prologues and the
residual, and are counted in `.window_launches`. `launch_gemv`,
`launch_tc` and `launch_gemm` are shared with the fp8 wrapper, `gemv_plan`
with the W8A8 dp4a GEMV.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import NamedTuple

import torch

from ...quantization.tensors import WOQWeight
from . import _build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"tllm_woq_matmul_stacked":
               [_P] * 8 + [_I] * 12 + [_F, _I, _I, _P]}
_TC_SIGNATURES = {"tllm_woq_gemv_tc": [_P] * 7 + [_I] * 12 + [_F, _I, _I, _P]}
_GEMM_SIGNATURES = {"tllm_woq_gemm": [_P] * 6 + [_I] * 10 + [_P]}

_PART_BYTES = 32 << 20   # cap on the GEMM's split-K partial buffer

# A column window starts and ends on whole 128 columns (the GEMM's column
# tile; JAX's caller makes only such windows, ops/linear.py:214-215).
WINDOW_ALIGN = 128

# The one-row GEMV (csrc/woq_gemv.cuh) and the W8A8 dp4a GEMV
# (csrc/w8a8_matmul.cu) stream the weight in one launch
# (csrc/gemv_stream.cuh): a block of GEMV_THREADS threads covers a column
# tile of 16 x lanes columns over one K split, lanes threads along N and
# GEMV_THREADS / lanes stored rows at a time; the splits of a column tile
# merge inside the launch.
GEMV_THREADS = 256        # kThreads in the source
GEMV_WARPS = GEMV_THREADS // 32
# threads along N a plan takes, in this order: narrow tiles first (more
# column tiles, fewer K splits to merge); grouped weights wide tiles first
# (a thread's rows are then closer, so it scales a group's sums every 8
# rows rather than every 2), unless that takes more than
# GEMV_GROUPED_SPLITS K splits (the last block of a column tile reads every
# split's sums). Measured at one row, int4 g128 (gemv_breakdown.py, H100):
# qkv 0.0194 / 0.0211 / 0.0252 ms at 32 / 16 / 8 lanes, wo (33 splits at
# 32 lanes) 0.0123 / 0.0113 / 0.0116.
GEMV_LANES = (8, 16, 32)
GEMV_LANES_GROUPED = (32, 16, 8)
GEMV_GROUPED_SPLITS = 16
GEMV_BLOCKS_PER_SM = 2    # resident blocks an SM (__launch_bounds__)
GEMV_KC_MIN = 64          # fewest logical K rows a split gets
GEMV_SMEM_BYTES = 96 << 10  # most dynamic shared memory a block takes

# The GEMM takes calls of at least this many rows (FUSE_MAX_ROWS + 1 of
# ops/linear.py: above 16 rows the paths compose the norm, SwiGLU and
# residual as plain ops, so their calls carry no prologue). The kernel
# phase of chip_smoke.py times both kernels at 16-8192 rows (PERF.md).
GEMM_MIN_ROWS = 17
GEMM_TILE_K = 128        # logical K rows per GEMM tile (kBK in the source)
GEMM_DTYPES = (torch.bfloat16, torch.float16)
_GEMM_BM = _GEMM_BN = 128  # the GEMM's block tile (kBM, kBN)
_GEMM_SPLIT_TILES = 4      # fewest K tiles a split of the GEMM gets


# The tensor-core GEMV (csrc/woq_gemv_tc.cuh) takes bf16 / fp16 calls of
# TC_MIN_ROWS..TC_MAX_ROWS rows (FUSE_MAX_ROWS of ops/linear.py: every call
# with a prologue or a residual is at most that) on a layout it tiles
# (tc_takes). The kernel phase of chip_smoke.py times it beside the
# one-row GEMV at 1-16 rows (PERF.md).
TC_MIN_ROWS = 2
TC_MAX_ROWS = 16
TC_STEP = 16              # K slots of one mma step (kStep in the source)
TC_WARPS = 4              # warps of a block, each a part of its K (kWarps)
# blocks of the body that reside on an SM (its registers bound them): three
# at up to 8 rows, two at 9-16 rows or with grouped fragments
TC_BLOCKS_PER_SM = {(8, False): 3, (8, True): 2, (16, False): 2,
                    (16, True): 2}
TC_PANEL_BYTES = 32 << 10  # most of a block's staged x panel

_SM_COUNT: dict = {}


def _sm_count(device) -> int:
    n = _SM_COUNT.get(device.index)
    if n is None:
        n = torch.cuda.get_device_properties(device).multi_processor_count
        _SM_COUNT[device.index] = n
    return n


def _gemm_split(m: int, k: int, n: int, n_sm: int):
    """(ksplit, kt_per) of the GEMM: split K over whole 128-row tiles (the
    last one ragged where K is not whole tiles) only while the grid has
    fewer output tiles than SMs (decode-sized M on a narrow N), each split
    >= _GEMM_SPLIT_TILES tiles, the f32 partials within _PART_BYTES."""
    tiles = -(-m // _GEMM_BM) * -(-n // _GEMM_BN)
    nk = -(-k // GEMM_TILE_K)
    ksplit = max(1, min(n_sm // tiles, nk // _GEMM_SPLIT_TILES,
                        _PART_BYTES // (m * n * 4)))
    kt_per = -(-nk // ksplit)
    return -(-nk // kt_per), kt_per


class GemvPlan(NamedTuple):
    """One launch of the one-row GEMV or the dp4a GEMV."""
    ksplit: int   # K splits of a column tile (grid y)
    kc: int       # logical K rows of a split (the last one shorter)
    lanes: int    # threads along N: a column tile of 16 x lanes columns
    mr: int       # rows of the register tile (1, 2 or 4)


def gemv_rows_per_tile(m: int, grouped: bool = False) -> int:
    """Rows of the GEMVs' register tile: 1, 2 or 4 (2 at most when
    grouped: each row keeps a second accumulator)."""
    return 1 if m == 1 else 2 if m == 2 or grouped else 4


def gemv_smem(plan: GemvPlan, x_bytes: int = 4, group: int = 0) -> int:
    """Dynamic shared memory of one block (the sources' smem_bytes): x's
    [mr, kc] staged (f32, or int8 for dp4a), the split's group scales
    [kc / group, 16 lanes] and the block sum [warps, mr, 16 lanes]."""
    bn = 16 * plan.lanes
    return (plan.mr * plan.kc * x_bytes
            + (plan.kc // group * bn * 4 if group else 0)
            + GEMV_WARPS * plan.mr * bn * 4)


def _group_fits(group_rows: int, rows: int) -> bool:
    """A scale group of group_rows stored rows and a block covering `rows`
    stored rows at a time: one divides the other, so a thread's rows (rows
    apart) end a group on a fixed count."""
    return not group_rows or group_rows % rows == 0 or rows % group_rows == 0


def gemv_plan(m: int, k: int, n: int, sms: int, unit: int = 8,
              group: int = 0, kr: int = 1, x_bytes: int = 4) -> GemvPlan:
    """The grid of one GEMV launch: column tiles of 16 x lanes columns
    times ksplit K splits of kc logical rows, sized to one wave of
    GEMV_BLOCKS_PER_SM blocks on each of `sms` SMs.

    unit: what kc is whole of (the int4 pack block, the fp8 interleave
    block or the scale group; 8, or 16 for dp4a); group: logical rows of a
    scale group (0: per-channel); kr: logical rows a stored row holds (2
    for int4); x_bytes: bytes of a staged x value (4, or 1 for dp4a).
    Takes the first of GEMV_LANES (when grouped,
    GEMV_LANES_GROUPED, those of at most GEMV_GROUPED_SPLITS splits first)
    whose tile the register tile and the group allow and whose grid fills
    the SMs (else the fullest grid); each split gets at least
    GEMV_KC_MIN rows, the splits' sums fit the workspace's floats
    (_build.WORKSPACE_MIN) and a block's shared memory GEMV_SMEM_BYTES."""
    mr = gemv_rows_per_tile(m, bool(group))
    order = GEMV_LANES_GROUPED if group else GEMV_LANES
    cands = [c for c in order
             if mr * c <= 32 and _group_fits(group // kr, GEMV_THREADS // c)]
    if group:                     # wide tiles while their splits stay few
        few = [c for c in cands if GEMV_BLOCKS_PER_SM * sms
               // -(-n // (16 * c)) <= GEMV_GROUPED_SPLITS]
        cands = few + [c for c in cands if c not in few]
    if not cands:
        raise ValueError(f"gemv_plan: no column tile takes {mr} rows with "
                         f"groups of {group} (lanes {order})")
    best = None
    for c in cands:
        tiles = -(-n // (16 * c))
        ksplit = min(max(1, GEMV_BLOCKS_PER_SM * sms // tiles),
                     max(1, k // max(GEMV_KC_MIN, unit)),
                     max(1, _build.WORKSPACE_MIN[0] // (m * n)))
        kc = -(-k // ksplit)
        kc = -(-kc // unit) * unit
        # shared memory: x, the group scales and the block sum
        bn = 16 * c
        per_row = mr * x_bytes + (bn * 4 / group if group else 0)
        kc_max = int((GEMV_SMEM_BYTES - GEMV_WARPS * mr * bn * 4) // per_row)
        kc = min(kc, max(unit, kc_max // unit * unit))
        plan = GemvPlan(-(-k // kc), kc, c, mr)
        if tiles * plan.ksplit >= sms:
            return plan
        if best is None or tiles * plan.ksplit > best[0]:
            best = (tiles * plan.ksplit, plan)
    return best[1]


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def prologue(x, norm_w, layer: int, eps: float, swiglu: bool = False):
    """x [..., K] -> h [M, K] in x's dtype (the kernel's prologues): x;
    RMSNorm(x) * norm_w[layer] in f32, cast to x's dtype; or, with swiglu,
    x [..., 2K] = [g | u] -> silu(g) in f32, cast to x's dtype, times u."""
    h = x.reshape(-1, x.shape[-1])
    if swiglu:
        if norm_w is not None:
            raise ValueError("norm_w and swiglu are mutually exclusive")
        k = h.shape[-1] // 2
        return torch.nn.functional.silu(h[:, :k].float()).to(x.dtype) * h[:, k:]
    if norm_w is None:
        return h
    hf = h.float()
    var = (hf * hf).mean(dim=-1, keepdim=True)
    return (hf * torch.rsqrt(var + eps) * norm_w[layer].float()).to(x.dtype)


def resid_epilogue(acc, x, resid):
    """f32 acc [M, N] -> f32 [..., N]: [resid + acc cast to resid's dtype,
    in that dtype] (the unfused rounding order)."""
    if resid is not None:
        r = resid.reshape(acc.shape)
        acc = (r + acc.to(r.dtype)).float()
    return acc.reshape(*x.shape[:-1], acc.shape[-1])


def check_window(what, n_window, n: int, prologue: bool = False,
                 resid: bool = False):
    """(start, length) of an n_window over N columns, or None. Raises for
    a window with a prologue or a residual, one outside [0, N), or one not
    of whole WINDOW_ALIGN columns."""
    if n_window is None:
        return None
    start, length = (int(v) for v in n_window)
    if prologue or resid:
        raise ValueError(f"{what}: n_window excludes the norm / SwiGLU "
                         "prologue and the residual")
    if start < 0 or length <= 0 or start + length > n:
        raise ValueError(f"{what}: window ({start}, {length}) outside N={n}")
    if start % WINDOW_ALIGN or length % WINDOW_ALIGN:
        raise ValueError(f"{what}: window ({start}, {length}) must be whole "
                         f"{WINDOW_ALIGN} columns")
    return start, length


def window_cols(acc, window):
    """The window's columns of a full [M, N] result (the plain versions
    compute the full product and keep the window's columns, so a window is
    the full call's columns bit for bit on every backend), contiguous as a
    kernel's output."""
    if window is None:
        return acc
    return acc[:, window[0]:sum(window)].contiguous()


def woq_matmul_stacked_plain(x, w: WOQWeight, layer: int, norm_w=None,
                             eps: float = 1e-6, resid=None,
                             swiglu: bool = False, n_window=None):
    """Plain PyTorch version. x [..., K] ([..., 2K] with swiglu) -> f32
    [..., N] (the window's [..., length] with n_window): f32 products of
    the compute-dtype input and the int8 (or unpacked int4) codes, f32 sum,
    then the per-channel scale; grouped: each group's sum times its scale,
    summed over the groups."""
    w.check_supported()
    window = check_window("woq_matmul_stacked", n_window, w.qweight.shape[-1],
                          norm_w is not None or swiglu, resid is not None)
    k = w.k_dim
    h = prologue(x, norm_w, layer, eps, swiglu).float()
    q = w.codes(layer).float()
    if w.group_size:
        g = w.group_size
        yg = torch.einsum("mgk,gkn->mgn", h.reshape(-1, k // g, g),
                          q.reshape(k // g, g, -1))
        acc = (yg * w.scale[layer]).sum(dim=1)
    else:
        acc = torch.matmul(h, q) * w.scale[layer]
    return resid_epilogue(window_cols(acc, window), x, resid)


# ---------------------------------------------------------------------------
# the GEMM's routing rule and tile maps
# ---------------------------------------------------------------------------

def gemm_takes(k: int, block: int = 0, group: int = 0) -> bool:
    """Whether the GEMM tiles this layout: K in whole 16-row mma steps (a K
    that is not whole 128-row tiles, such as GPT-2 XL's 1600, runs a last
    tile zero-filled past K), an int4 pack block or fp8 interleave block
    (0: none) that divides the tile, and per-channel scales or groups of
    one tile (then K in whole tiles)."""
    return (k > 0 and k % TC_STEP == 0
            and (block == 0 or GEMM_TILE_K % block == 0)
            and (group == 0 or (group == GEMM_TILE_K
                                and k % GEMM_TILE_K == 0)))


def gemm_route(rows: int, dtype, prologue: bool = False,
               residual: bool = False, k: int = GEMM_TILE_K, block: int = 0,
               group: int = 0) -> bool:
    """True where a CUDA call goes to the GEMM, False where it goes to the
    GEMV: the GEMM takes bf16 / fp16 activations of at least GEMM_MIN_ROWS
    rows, with no norm / SwiGLU prologue and no residual, on a layout it
    tiles (gemm_takes). f32 activations stay on the GEMV at every row count
    (the tensor cores have no exact f32 product), and so does a call with a
    prologue or a residual (no path makes one above 16 rows)."""
    return (rows >= GEMM_MIN_ROWS and dtype in GEMM_DTYPES
            and not prologue and not residual
            and gemm_takes(k, block, group))


def tc_takes(k: int, block: int = 0, group: int = 0) -> bool:
    """Whether the tensor-core GEMV tiles this layout: K in whole 16-slot
    mma steps and groups (if any) of whole steps. A split-K range starts
    on whole pack (interleave) blocks and groups (tc_plan), so the block
    itself needs nothing more (K is whole blocks by the weight's own
    contract)."""
    return k > 0 and k % TC_STEP == 0 and group % TC_STEP == 0


def tc_route(rows: int, dtype, k: int = TC_STEP, block: int = 0,
             group: int = 0) -> bool:
    """True where a CUDA call of at most GEMM_MIN_ROWS - 1 rows goes to the
    tensor-core GEMV (any prologue or residual), False where it goes to the
    one-row GEMV: bf16 / fp16 activations of TC_MIN_ROWS..TC_MAX_ROWS rows
    on a layout it tiles (tc_takes). f32 stays on the one-row GEMV's CUDA
    cores (the tensor cores have no exact f32 product)."""
    return (TC_MIN_ROWS <= rows <= TC_MAX_ROWS and dtype in GEMM_DTYPES
            and tc_takes(k, block, group))


def tc_plan(m: int, k: int, n: int, sms: int, w_bits: int = 8,
            block: int = 0, group: int = 0) -> tuple[int, int, int, int]:
    """(ksplit, sps, mt, nt) of one tensor-core GEMV launch: mt 8 (M <= 8,
    one mma per 16 columns and step) or 16 (two; grouped scales then apply
    to each step's products); nt the tiles a warp covers (16: 256 columns;
    8 for grouped int8); the K steps split into ksplit ranges of sps steps
    (the last one shorter), each whole pack or interleave blocks and
    groups, so that the grid of column tiles x ksplit fills the card in one
    wave of TC_BLOCKS_PER_SM[mt, grouped] blocks an SM (the most that its
    registers let reside), each of the block's TC_WARPS warps at least one
    step (grouped: one group) and, where K allows, an equal share, and the
    x panel within TC_PANEL_BYTES."""
    mt = 8 if m <= 8 else 16
    nt = 8 if group and w_bits == 8 else 16
    tiles = -(-n // (16 * nt))
    steps = k // TC_STEP
    unit = math.lcm(TC_STEP, block or TC_STEP, group or TC_STEP) // TC_STEP
    warp_unit = group // TC_STEP if group else 1
    want = max(1, TC_BLOCKS_PER_SM[mt, bool(group)] * sms // tiles)
    most = max(1, steps // (TC_WARPS * warp_unit))
    fewest = -(-steps * TC_STEP * mt * 2 // TC_PANEL_BYTES)
    ksplit = max(fewest, min(want, most))
    # whole blocks and groups a split, and where K allows an equal share
    # for every warp (an uneven share is time the other warps wait)
    per = math.lcm(unit, TC_WARPS * warp_unit)
    if steps >= per * ksplit:
        unit = per
    sps = -(-steps // ksplit)
    sps = -(-sps // unit) * unit
    return -(-steps // sps), sps, mt, nt


def tc_column_map(n: int, nt: int) -> list:
    """The output column of each (column tile, tile j, A row r) of the
    tensor-core GEMV, r and j in 0..15 and 0..nt-1: tile j's row r is
    column 16 nt * tile + nt * r + j (None past N), so that thread g of a
    warp reads nt contiguous bytes of a stored row at nt * g and at
    nt * (g + 8) and feeds slot j of every tile from byte j."""
    tiles = -(-n // (16 * nt))
    return [[[c if (c := 16 * nt * tile + nt * r + j) < n else None
              for r in range(16)] for j in range(nt)]
            for tile in range(tiles)]


def tile_rows(fmt: str, block: int = 0) -> list:
    """The logical row, within a 128-row K tile, of each stored slot of the
    tile: the map by which the GEMM writes its decoded tile in logical row
    order (csrc/woq_gemm.cuh reads it). fmt "int8": slot = stored row, in
    logical order. "int4": slot = 2 * stored row + nibble (0 low, 1 high)
    in pack_int4's layout with pack block `block`: block-local packed row
    2m holds quarters (A[m], C[m]), row 2m + 1 holds (B[m], D[m]). "fp8":
    slot = stored row, rows interleaved within blocks of `block` by
    interleave_fp8_rows (stored 2m: logical m, 2m + 1: block / 2 + m; 0:
    logical order)."""
    t = GEMM_TILE_K
    if fmt == "int4":
        rows = []
        for slot in range(t):
            s, nibble = divmod(slot, 2)
            b, sl = divmod(s, block // 2)
            quarter = 2 * nibble + (sl & 1)
            rows.append(b * block + quarter * (block // 4) + (sl >> 1))
        return rows
    if fmt == "fp8" and block:
        return [b * block + (j & 1) * (block // 2) + (j >> 1)
                for b, j in (divmod(s, block) for s in range(t))]
    if fmt in ("int8", "fp8"):
        return list(range(t))
    raise ValueError(f"tile_rows: unknown format {fmt!r}")


_TILE_MAPS: dict = {}


def _tile_map(fmt, block, device):
    """tile_rows as a uint8 tensor on `device` (built once per layout)."""
    key = (fmt, block, device)
    t = _TILE_MAPS.get(key)
    if t is None:
        t = torch.tensor(tile_rows(fmt, block), dtype=torch.uint8,
                         device=device)
        _TILE_MAPS[key] = t
    return t


# ---------------------------------------------------------------------------
# kernel launch
# ---------------------------------------------------------------------------

def _check_operands(what, x, q, scale, layer, k, k_x, extra=()):
    """The checks both kernels make: x [..., k_x] beside the stacked codes
    q [L, ., N] (K = k) and f32 scales, a layer in range, N % 16 == 0,
    16-byte aligned weight and scales, every tensor contiguous on x's
    device."""
    n_layers, n = q.shape[0], q.shape[-1]
    if x.shape[-1] != k_x or not 0 <= layer < n_layers:
        raise ValueError(f"{what}: x {tuple(x.shape)}, weight "
                         f"{tuple(q.shape)} (K={k}), layer {layer}")
    if (n % 16 or q.data_ptr() % 16 or scale.data_ptr() % 16
            or scale.dtype != torch.float32):
        raise ValueError(f"{what}: weight and scales must be 16-byte "
                         "aligned with N % 16 == 0 and f32 scales")
    if any(t.device != x.device or not t.is_contiguous()
           for t in [x, q, scale, *extra]):
        raise ValueError(f"{what}: tensors must be contiguous and on one "
                         "device")


def _check_options(what, x, q, scale, layer, k, norm_w, resid, swiglu):
    """The checks both GEMVs make: _check_operands, one prologue at most, a
    norm_w [L, K] and a resid [..., N] in x's dtype. Returns M."""
    n_layers, n = q.shape[0], q.shape[-1]
    k_x = 2 * k if swiglu else k
    if swiglu and norm_w is not None:
        raise ValueError(f"{what}: norm_w and swiglu are mutually exclusive")
    _check_operands(what, x, q, scale, layer, k, k_x,
                    [t for t in (norm_w, resid) if t is not None])
    if norm_w is not None and (norm_w.dtype != x.dtype
                               or norm_w.shape != (n_layers, k)):
        raise ValueError(f"{what}: norm_w must be [L, K] in x's dtype")
    m = x.numel() // k_x
    if resid is not None and (resid.dtype != x.dtype or resid.numel() != m * n):
        raise ValueError(f"{what}: resid must be [..., N] in x's dtype")
    return m


def _columns(q, scale, layer, window):
    """(codes, scale pointers of `layer` from the window's first column,
    the columns computed N, the row stride ldw): a window moves both
    pointers by its start (the scale's row stride is N too) and keeps the
    full N as the stride."""
    ldw = q.shape[-1]
    start, n = window if window is not None else (0, ldw)
    return (_P(q.data_ptr() + layer * q.stride(0) + start),
            _P(scale.data_ptr() + (layer * scale.stride(0) + start) * 4),
            n, ldw)


def launch_gemv(what, lib_name, entry, signatures, x, q, scale, layer, k,
                fmt_args, unit, kr=1, group=0, norm_w=None, eps=1e-6,
                resid=None, swiglu=False, window=None):
    """Check the operands of one stacked one-row GEMV and launch it.

    q: stacked stored codes [L, K or K/2, N] (1 byte per element); scale:
    f32 [L, N] or grouped [L, K/g, N]; fmt_args: the entry's format ints
    (after lanes); unit, kr, group: the layout, for gemv_plan (what K
    splits are whole of, logical rows a stored row, a scale group's rows);
    swiglu: x is [..., 2K] = [gate | up]; window: (start, length) of the
    columns computed (check_window), planned as the full N. One launch;
    its splits meet in the stream's workspace (made at the stream's first
    call). Returns f32 [..., N or length]."""
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{what}: unsupported dtype {x.dtype}")
    m = _check_options(what, x, q, scale, layer, k, norm_w, resid, swiglu)
    # unit 8 only aligns kc; a larger unit is a block K must be whole of
    if k % unit and unit > 8:
        raise ValueError(f"{what}: K={k} must be whole blocks of {unit}")

    lib = _build.load(lib_name, signatures)
    q_ptr, s_ptr, n, ldw = _columns(q, scale, layer, window)
    plan = gemv_plan(m, k, ldw, _sm_count(x.device), unit, group, kr)
    part, counters = _build.workspace(
        x.device, plan.ksplit * m * n if plan.ksplit > 1 else 0,
        -(-n // (16 * plan.lanes)))
    out = torch.empty((m, n), device=x.device, dtype=torch.float32)
    nw_ptr = (_P(norm_w.data_ptr() + layer * k * x.element_size())
              if norm_w is not None else _P(None))
    err = getattr(lib, entry)(
        _build.ptr(x), q_ptr, s_ptr, nw_ptr,
        _build.ptr(resid), _build.ptr(out), _build.ptr(part),
        _build.ptr(counters), _build.DTYPE_CODES[x.dtype], m, k, n, ldw,
        plan.ksplit, plan.kc, plan.mr, plan.lanes, *fmt_args, eps,
        int(swiglu), x.device.index or 0, _build.stream_of(x))
    _build.check(err, what)
    return out.reshape(*x.shape[:-1], n)


def _aligned(t):
    """t, or a copy of it where its data is not 16-byte aligned (the
    kernels read it in 16-byte vectors)."""
    return t if t is None or t.data_ptr() % 16 == 0 else t.clone()


def launch_tc(what, lib_name, entry, signatures, x, q, scale, layer, k,
              fmt_args, w_bits, block, group, norm_w=None, eps=1e-6,
              resid=None, swiglu=False, window=None):
    """Check the operands of one stacked tensor-core GEMV and launch it.

    q: stacked stored codes [L, K or K/2, N]; scale: f32 [L, N] or grouped
    [L, K/g, N]; fmt_args: the entry's format ints (after nt); w_bits,
    block (pack or interleave block, 0: none) and group: the layout, for
    tc_plan; swiglu: x is [..., 2K] = [gate | up]; window: (start, length)
    of the columns computed, whole column tiles of 16 nt, planned as the
    full N. Raises before launch (and before any build) for a dtype, row
    count, layout or window the body does not take. Returns f32 [...,
    N or length]."""
    if x.dtype not in GEMM_DTYPES:
        raise TypeError(f"{what}: the tensor-core GEMV takes bf16 or fp16, "
                        f"not {x.dtype}")
    if not tc_takes(k, block, group):
        raise ValueError(f"{what}: the tensor-core GEMV takes K in whole "
                         f"{TC_STEP}-row steps and groups of whole steps; "
                         f"got K={k}, group {group}")
    m = _check_options(what, x, q, scale, layer, k, norm_w, resid, swiglu)
    if not 1 <= m <= TC_MAX_ROWS:
        raise ValueError(f"{what}: the tensor-core GEMV takes 1-"
                         f"{TC_MAX_ROWS} rows, got {m}")
    x2 = _aligned(x.reshape(m, x.shape[-1]))
    norm_w = _aligned(norm_w)

    q_ptr, s_ptr, n, ldw = _columns(q, scale, layer, window)
    ksplit, sps, mt, nt = tc_plan(m, k, ldw, _sm_count(x.device), w_bits,
                                  block, group)
    if window is not None and (window[0] % (16 * nt)
                               or (n % (16 * nt) and sum(window) != ldw)):
        raise ValueError(f"{what}: the tensor-core GEMV's windows are whole "
                         f"column tiles of {16 * nt}; got {window}")
    lib = _build.load(lib_name, signatures)
    part = (_build.workspace(x.device, ksplit * m * n)[0] if ksplit > 1
            else None)
    out = torch.empty((m, n), device=x.device, dtype=torch.float32)
    nw_ptr = (_P(norm_w.data_ptr() + layer * k * x.element_size())
              if norm_w is not None else _P(None))
    err = getattr(lib, entry)(
        _build.ptr(x2), q_ptr, s_ptr, nw_ptr,
        _build.ptr(resid), _build.ptr(out), _build.ptr(part),
        _build.DTYPE_CODES[x.dtype], m, k, n, ldw, ksplit, sps, mt, nt,
        *fmt_args, eps, int(swiglu), x.device.index or 0,
        _build.stream_of(x))
    _build.check(err, what)
    return out.reshape(*x.shape[:-1], n)


def launch_gemm(what, lib_name, entry, signatures, x, q, scale, layer, k,
                fmt, block, group, fmt_args=(), window=None):
    """Check the operands of one stacked GEMM kernel and launch it.

    q: stacked stored codes [L, K or K/2, N]; scale: f32 [L, N] or grouped
    [L, K/128, N]; fmt / block: the layout's tile_rows; group: 0 or 128;
    fmt_args: the entry's format ints (after kt_per); window: (start,
    length) of the columns computed, planned as the full N. Raises before
    launch for a dtype or layout the GEMM does not take. Returns f32 [...,
    N or length]."""
    if x.dtype not in GEMM_DTYPES:
        raise TypeError(f"{what}: the GEMM takes bf16 or fp16, not {x.dtype}")
    if not gemm_takes(k, block, group):
        raise ValueError(f"{what}: the GEMM takes K in whole {TC_STEP}-row "
                         f"steps, blocks dividing its {GEMM_TILE_K}-row "
                         f"tiles and groups of {GEMM_TILE_K}; got K={k}, "
                         f"block {block}, group {group}")
    _check_operands(what, x, q, scale, layer, k, k)
    m = x.numel() // k
    x2 = x.reshape(m, k)
    if x2.data_ptr() % 16:        # cp.async reads x in 16-byte chunks
        x2 = x2.clone()
    lib = _build.load(lib_name, signatures)
    q_ptr, s_ptr, n, ldw = _columns(q, scale, layer, window)
    ksplit, kt_per = _gemm_split(m, k, ldw, _sm_count(x.device))
    out = torch.empty((m, n), device=x.device, dtype=torch.float32)
    part = None if ksplit == 1 else torch.empty(
        (ksplit, m, n), device=x.device, dtype=torch.float32)
    err = getattr(lib, entry)(
        _build.ptr(x2), q_ptr, s_ptr,
        _build.ptr(_tile_map(fmt, block, x.device)), _build.ptr(out),
        _build.ptr(part), _build.DTYPE_CODES[x.dtype], m, k, n, ldw, ksplit,
        kt_per, *fmt_args, x.device.index or 0, _build.stream_of(x))
    _build.check(err, what)
    return out.reshape(*x.shape[:-1], n)


def _launch(what, x, w: WOQWeight, layer, norm_w, eps, resid, swiglu=False,
            window=None):
    """(f32 [..., N or the window's length], the route: "gemm", "tc" or
    "gemv") for one CUDA call."""
    w.check_supported()
    n_layers, n = w.qweight.shape[0], w.qweight.shape[-1]
    grouped = bool(w.group_size)
    sshape = ((n_layers, w.k_dim // w.group_size, n) if grouped
              else (n_layers, n))
    if w.qweight.dtype != torch.int8 or w.scale.shape != sshape:
        raise ValueError(f"{what}: qweight must be int8 and scale "
                         f"{sshape}, got {tuple(w.scale.shape)}")
    if gemm_route(x.numel() // x.shape[-1], x.dtype,
                  norm_w is not None or swiglu, resid is not None, w.k_dim,
                  w.pack_block, w.group_size):
        return launch_gemm(what, "woq_gemm", "tllm_woq_gemm",
                           _GEMM_SIGNATURES, x, w.qweight, w.scale, layer,
                           w.k_dim, "int4" if w.w_bits == 4 else "int8",
                           w.pack_block, w.group_size,
                           (w.w_bits, int(grouped)), window), "gemm"
    fmt_args = (w.w_bits, w.pack_block, w.group_size)
    if tc_route(x.numel() // x.shape[-1], x.dtype, w.k_dim, w.pack_block,
                w.group_size):
        return launch_tc(what, "woq_gemv_tc", "tllm_woq_gemv_tc",
                         _TC_SIGNATURES,
                         x, w.qweight, w.scale, layer, w.k_dim, fmt_args,
                         w.w_bits, w.pack_block, w.group_size, norm_w, eps,
                         resid, swiglu, window), "tc"
    return launch_gemv(what, "woq_matmul", "tllm_woq_matmul_stacked",
                       _SIGNATURES, x, w.qweight, w.scale, layer, w.k_dim,
                       fmt_args, w.pack_block or w.group_size or 8,
                       2 if w.w_bits == 4 else 1, w.group_size, norm_w, eps,
                       resid, swiglu, window), "gemv"


def _device_kind(x, what):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")
    return x.device.type


def woq_matmul_stacked(x, w: WOQWeight, layer: int, norm_w=None,
                       eps: float = 1e-6, resid=None, swiglu: bool = False,
                       n_window=None):
    """y = [resid +] (norm(x) | silu(g) * u | x) @ dequant(w.qweight[layer]).

    x: [..., K] f32, bf16 or fp16 ([..., 2K] = [g | u] with swiglu); w:
    stacked WOQWeight, int8 [L, K, N] or packed int4 [L, K/2, N], scale
    [L, N] or grouped [L, K/g, N]; norm_w: optional stacked [L, K] RMSNorm
    weight (prologue; not with swiglu); resid: optional [..., N] in x's
    dtype (epilogue); n_window: (start, length), only the output columns
    [start, start + length) (check_window; not with a prologue or resid).
    Returns f32 [..., N] ([..., length] with n_window).

    On the card: bf16 / fp16 calls of at least GEMM_MIN_ROWS rows with no
    prologue and no residual run the GEMM (gemm_route); bf16 / fp16 calls
    of TC_MIN_ROWS..16 rows the tensor-core GEMV (tc_route); one-row calls,
    f32 calls and the layouts neither tiles the one-row GEMV at every row
    count (correct, and no path makes such a call above 16 rows)."""
    if _device_kind(x, "woq_matmul_stacked") == "cpu":
        return woq_matmul_stacked_plain(x, w, layer, norm_w, eps, resid,
                                        swiglu, n_window)
    window = check_window("woq_matmul_stacked", n_window, w.qweight.shape[-1],
                          norm_w is not None or swiglu, resid is not None)
    out, route = _launch("woq_matmul_stacked", x, w, layer, norm_w, eps,
                         resid, swiglu, window)
    woq_matmul_stacked.launches += 1
    woq_matmul_stacked.gemm_launches += int(route == "gemm")
    woq_matmul_stacked.tc_launches += int(route == "tc")
    woq_matmul_stacked.swiglu_launches += int(swiglu)
    woq_matmul_stacked.window_launches += int(window is not None)
    woq_matmul_stacked.ragged_launches += int(
        route == "gemm" and w.k_dim % GEMM_TILE_K != 0)
    return out


woq_matmul_stacked.launches = 0
woq_matmul_stacked.gemm_launches = 0
woq_matmul_stacked.tc_launches = 0
woq_matmul_stacked.swiglu_launches = 0
woq_matmul_stacked.window_launches = 0
woq_matmul_stacked.ragged_launches = 0


def unit_layer(w):
    """A 2-D weight container (WOQWeight or FP8Weight) as a stack of one
    layer (views, no copy)."""
    return dataclasses.replace(w, qweight=w.qweight[None], scale=w.scale[None])


def woq_matmul_plain(x, w: WOQWeight):
    """Plain version of the 2-D entry."""
    return woq_matmul_stacked_plain(x, unit_layer(w), 0)


def woq_matmul(x, w: WOQWeight):
    """2-D entry: x [..., K] @ dequant(w), w int8 [K, N] or packed int4
    [K/2, N] with scale [N] or [K/g, N]; the stacked kernels on a unit
    layer axis (the GEMM, the tensor-core or the one-row GEMV, as
    woq_matmul_stacked routes), counted in its own `woq_matmul.launches`,
    `.gemm_launches` and `.tc_launches`. Returns f32 [..., N]."""
    if _device_kind(x, "woq_matmul") == "cpu":
        return woq_matmul_plain(x, w)
    out, route = _launch("woq_matmul", x, unit_layer(w), 0, None, 1e-6,
                         None)
    woq_matmul.launches += 1
    woq_matmul.gemm_launches += int(route == "gemm")
    woq_matmul.tc_launches += int(route == "tc")
    return out


woq_matmul.launches = 0
woq_matmul.gemm_launches = 0
woq_matmul.tc_launches = 0
