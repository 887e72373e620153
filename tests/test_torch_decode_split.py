"""The host's split of the split-cache decode's one launch (kernel 3, rows
8 and 9; ops/kernels/decode_attention.py::decode_split, the function the
wrappers call) over ranges of B, Hkv, S_max, the GQA group and the SM count:
the splits tile the S_max rows in whole 64-row tiles, none empty; the split
count stays within the kernel's limit; a short cache is one split; the grid
(a block per split, chunk of up to 8 heads, kv head and sequence) fills the
card whenever the cache and the split limit allow it, in one wave. Row 8's
wrapper launches with kernel 3's split and asks for kernel 3's workspace
(driven on meta tensors, its library replaced by a recorder). Row 14 runs
the same split over the MB * BS rows of its block table: its addressing,
as the wrapper states it (`paged_decode_attention.split_rows`), reads each
live row once, through the table as the plain version gathers, from a
table slice that fits the kernel's (`table_slice`), and exactly one block
writes, where `_write_blocks` says. Which rows each block then reads lives
only in the kernel; the card tests (-m cuda) run groups 1-71 and reach its
edges.
"""

import re
from pathlib import Path
from unittest import mock

import torch

from hypothesis import given, settings
from hypothesis import strategies as st

from trtllm_llama_tpu_torch.ops.kernels import decode_attention as da
from trtllm_llama_tpu_torch.ops.kernels import paged_decode_attention as pda

HEADER = (Path(da.__file__).resolve().parents[2] / "csrc"
          / "flash_decode.cuh").read_text()


H100_SMS = 132     # the SMs of the card the rule is tuned for


def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", HEADER).group(1))


def test_split_constants_match_the_kernel():
    """The rule's tile, split limit, head chunk and blocks an SM are the
    kernel's."""
    assert da.TILE == _constant("kTile")
    assert da.MAX_SPLITS == _constant("kMaxSplits") == 32
    assert da.HEAD_CHUNK == _constant("kChunk")
    assert re.search(rf"__launch_bounds__\(kThreads, {da.BLOCKS_PER_SM}\)",
                     HEADER)


@settings(max_examples=400, deadline=None)
@given(b=st.integers(1, 64), hkv=st.integers(1, 64),
       s_chunks=st.integers(1, 4096),
       group=st.sampled_from([1, 2, 4, 8, 9, 32, 71, 128]),
       sms=st.sampled_from([H100_SMS, 114, 78]))     # SXM, PCIe, a cut card
def test_splits_tile_the_cache(b, hkv, s_chunks, group, sms):
    s = da.CHUNK * s_chunks            # S_max % 32 == 0 (the wrappers' check)
    splits, tps = da.decode_split(b, hkv, s, group, sms)
    tiles = -(-s // da.TILE)
    assert 1 <= splits <= da.MAX_SPLITS and tps >= 1
    # split i covers tiles [i * tps, (i + 1) * tps): all rows, none empty
    assert (splits - 1) * tps < tiles <= splits * tps
    assert tiles >= da.SHORT_TILES or splits == 1
    # the card fills whenever the cache and the split limit allow two
    # blocks an SM, and a split grid stays within one wave of them
    per_split = b * hkv * -(-group // da.HEAD_CHUNK)
    blocks = splits * per_split
    room = min(da.MAX_SPLITS, tiles if tiles >= da.SHORT_TILES else 1)
    if per_split * room >= da.BLOCKS_PER_SM * sms:
        assert blocks >= sms
    assert splits == 1 or blocks <= da.BLOCKS_PER_SM * sms


@given(b=st.integers(1, 256), hkv=st.integers(1, 128),
       s=st.sampled_from([32, 64, 96, 128, 160, 192]),
       group=st.integers(1, 80))
def test_a_short_cache_is_one_split(b, hkv, s, group):
    assert (da.decode_split(b, hkv, s, group, H100_SMS)
            == (1, -(-s // da.TILE)))


def test_the_paths_splits():
    """The shapes the paths give kernel 3: paths 1-4 and the families
    (S_max 128, B = 1 / 4) and serving (9 rows of 256) are one launch of
    one split per kv head; path 5's 8320 rows and Task A's 1152 fill the
    card; at 2048 rows one KV head takes 32 splits of a tile for a group
    of 8 or 32 (4 chunks), 16 splits of 2 tiles for Falcon-7B's 71 (9
    chunks)."""
    def split(b, hkv, s, group=1):
        return da.decode_split(b, hkv, s, group, H100_SMS)

    assert split(1, 32, 128) == (1, 2)
    assert split(4, 32, 128) == (1, 2)
    assert split(9, 32, 256) == (1, 4)      # 264 // 288 blocks: 1
    splits, tps = split(1, 32, 8320)        # LLaMA-7B, bs1
    assert splits * 32 >= H100_SMS and splits * tps * da.TILE >= 8320
    splits, _ = split(1, 32, 1152)          # Task A
    assert splits * 32 >= H100_SMS
    assert split(1, 1, 2048) == (32, 1)
    assert split(1, 1, 2048, 32) == (32, 1)
    assert split(1, 1, 2048, 71) == (16, 2)


class _Recorder:
    """Stands in for the kernel library: records each entry's arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, entry):
        def launch(*args):
            self.calls.append((entry, args))
            return 0
        return launch


@settings(max_examples=200, deadline=None)
@given(b=st.integers(1, 16), hkv=st.sampled_from([1, 2, 8, 32]),
       s_chunks=st.integers(1, 300), group=st.sampled_from([1, 4, 8, 32, 71]),
       d=st.sampled_from([64, 128, 256]), int8=st.booleans())
def test_read_only_wrapper_asks_for_kernel3s_workspace(b, hkv, s_chunks,
                                                       group, d, int8):
    """Row 8's wrapper and kernel 3's at the same shapes: one launch each,
    with the same (splits, tiles per split), asking the per-stream
    workspace for the same size (`workspace_size`), none at one split; each
    passes as many arguments as its entry's signature names."""
    s, hq = da.CHUNK * s_chunks, hkv * group
    meta = dict(device="meta", dtype=torch.bfloat16)
    q, new = torch.empty((b, hq, d), **meta), torch.empty((b, hkv, d), **meta)
    cache = torch.empty((2, b, hkv, s, d), device="meta",
                        dtype=torch.int8 if int8 else torch.bfloat16)
    kv_scale = torch.empty(2, device="meta") if int8 else None
    lens = torch.empty(b, device="meta", dtype=torch.int32)
    asked, lib = [], _Recorder()
    launches = (da.decode_attention_kernel.launches,
                da.dma_decode_attention.launches)
    with mock.patch.object(da, "_check", lambda name, q, kc, vc, layer, lens,
                           kvs, new=(): lens), \
            mock.patch.object(da, "sm_count", lambda device: H100_SMS), \
            mock.patch.object(da, "_workspace", lambda device, *n: (
                asked.append(n), (None, None))[1]), \
            mock.patch.object(da._build, "load", lambda name, sigs: lib), \
            mock.patch.object(da._build, "stream_of", lambda t: None):
        try:
            da.decode_attention_kernel(q, cache, cache, 1, lens,
                                       kv_scale=kv_scale)
            da.dma_decode_attention(q, new, new, cache, cache, 1, lens,
                                    kv_scale=kv_scale)
        finally:
            (da.decode_attention_kernel.launches,
             da.dma_decode_attention.launches) = launches
    (read, read_args), (write, write_args) = lib.calls
    assert (read, write) == ("tllm_decode_attention_read",
                             "tllm_decode_attention")
    assert len(read_args) == len(da._SIGNATURES[read])
    assert len(write_args) == len(da._SIGNATURES[write])
    splits, tps = da.decode_split(b, hkv, s, group, H100_SMS)
    assert read_args[-4:-2] == write_args[-4:-2] == (splits, tps)
    want = [da.workspace_size(b, hq, d, splits)] * 2 if splits > 1 else []
    assert asked == want


@settings(max_examples=300, deadline=None)
@given(data=st.data(), b=st.integers(1, 16),
       hkv=st.sampled_from([1, 2, 8, 32]),
       group=st.sampled_from([1, 4, 8, 32]), mb=st.integers(1, 150),
       bs=st.sampled_from([8, 16, 24, 32, 64, 96]))
def test_paged_splits_read_the_table_rows_once(data, b, hkv, group, mb, bs):
    """Row 14's addressing over random tables with -1 entries and positions
    below, at and past MB * BS: the splits attend rows 0 .. n_live - 1 once
    each, at the (block, row) the plain version gathers; each split's
    table entries fit its slice; one split writes, at `_write_blocks`'s
    row (the trash block past the table or through a -1 entry)."""
    nb = mb + 4                     # the pool's blocks, the last the trash
    cap = mb * bs
    table = data.draw(st.lists(st.integers(-1, nb - 2), min_size=mb,
                               max_size=mb))
    pos = data.draw(st.one_of(st.integers(0, cap - 1),
                              st.integers(cap, cap + 2 * bs)))
    splits, tps = da.decode_split(b, hkv, cap, group, H100_SMS)
    model = pda.split_rows(table, pos, nb, bs, splits, tps)
    assert len(model) == splits
    rows = [row for split, _ in model for row in split]
    n_live = min(pos + 1, cap)
    assert [r for r, _, _ in rows] == list(range(n_live))
    # the plain version's gather: pool[layer][tables] -> rows of the table
    ids = torch.arange(nb * bs).reshape(nb, 1, bs, 1)
    tbl = torch.where(torch.tensor(table) < 0, nb - 1, torch.tensor(table))
    gathered = ids[tbl].permute(1, 0, 2, 3).reshape(mb * bs)[:n_live]
    assert [blk * bs + off for _, blk, off in rows] == gathered.tolist()
    for split, _ in model:
        assert len({r // bs for r, _, _ in split}) <= pda.table_slice(bs, tps)
    _, w_blk, w_row = pda._write_blocks(torch.tensor([table]),
                                        torch.tensor([pos]), nb, bs)
    writes = [w for _, w in model if w is not None]
    assert writes == [(int(w_blk[0]), int(w_row[0]))]
