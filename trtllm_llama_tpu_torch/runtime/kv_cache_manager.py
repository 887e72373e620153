"""Paged KV-cache management: block pool, ref-counted sharing, slot mapping
(the port's copy of the JAX package's `runtime/kv_cache_manager.py`,
unchanged: numpy only).

Host-side allocator with the semantics of the reference's
KVCacheManager/BlocksManager (runtime/kv_cache_manager.py:58-292): fixed-size
token blocks, per-sequence block lists, ref-counts so beams share context
blocks copy-on-write, and a dense pointer table handed to the device.

Instead of per-block device pointers (KVBlockArray, kvCacheUtils.h:34-114),
the device cache is one stacked array [L, n_blocks, H, block_size, D] and
the manager maintains an int32 *block-index table*
[max_seqs, max_blocks_per_seq] that the paged attention kernel consumes.
Same bookkeeping, index-based instead of pointer-based.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


class Block:
    __slots__ = ("idx", "ref_count")

    def __init__(self, idx: int):
        self.idx = idx
        self.ref_count = 0


class BlocksManager:
    """Free-list block pool with ref counting (reference BlocksManager)."""

    def __init__(self, num_blocks: int, block_size: int):
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._blocks = [Block(i) for i in range(num_blocks)]
        self._free: List[Block] = list(self._blocks)

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def allocate(self) -> Block:
        if not self._free:
            raise RuntimeError("KV cache out of blocks")
        blk = self._free.pop()
        blk.ref_count = 1
        return blk

    def retain(self, blk: Block):
        blk.ref_count += 1

    def release(self, blk: Block):
        blk.ref_count -= 1
        if blk.ref_count == 0:
            self._free.append(blk)
        elif blk.ref_count < 0:
            raise RuntimeError("double free of KV block")


class SequenceState:
    __slots__ = ("seq_id", "blocks", "length")

    def __init__(self, seq_id: int):
        self.seq_id = seq_id
        self.blocks: List[Block] = []
        self.length = 0


class KVCacheManager:
    """Per-sequence paged allocation + block-index table emission."""

    def __init__(self, num_blocks: int, block_size: int,
                 max_blocks_per_seq: int):
        self.blocks = BlocksManager(num_blocks, block_size)
        self.block_size = block_size
        self.max_blocks_per_seq = max_blocks_per_seq
        self._seqs: Dict[int, SequenceState] = {}
        # (src_block_idx, dst_block_idx) pairs produced by copy-on-write
        # tail splits: the DEVICE must copy the partially-filled tail from
        # src to dst before the next write (pop_pending_copies)
        self._pending_copies: List[tuple] = []

    # ---- lifecycle -----------------------------------------------------
    def add_sequence(self, seq_id: int, context_len: int):
        if seq_id in self._seqs:
            raise ValueError(f"sequence {seq_id} already active")
        if self._blocks_needed(context_len) > self.max_blocks_per_seq:
            # reject at admission — otherwise block_table() blows up later,
            # far from the faulty call
            raise RuntimeError("sequence exceeds max_blocks_per_seq")
        st = SequenceState(seq_id)
        try:
            for _ in range(self._blocks_needed(context_len)):
                st.blocks.append(self.blocks.allocate())
        except RuntimeError:
            for blk in st.blocks:       # roll back the partial allocation
                self.blocks.release(blk)
            raise
        st.length = context_len
        self._seqs[seq_id] = st

    def fork_sequence(self, src_id: int, dst_id: int):
        """Beam/prefix sharing: dst references src's blocks (copy-on-write
        happens by allocating a fresh tail block on the next append)."""
        if dst_id in self._seqs:
            raise ValueError(f"sequence {dst_id} already active")
        src = self._seqs[src_id]
        st = SequenceState(dst_id)
        for blk in src.blocks:
            self.blocks.retain(blk)
            st.blocks.append(blk)
        st.length = src.length
        self._seqs[dst_id] = st

    def append_token(self, seq_id: int):
        """Advance by one token, allocating (or COW-ing) the tail block."""
        st = self._seqs[seq_id]
        new_len = st.length + 1
        needed = self._blocks_needed(new_len)
        if needed > self.max_blocks_per_seq:
            raise RuntimeError("sequence exceeds max_blocks_per_seq")
        if needed > len(st.blocks):
            st.blocks.append(self.blocks.allocate())
        else:
            tail = st.blocks[-1]
            if tail.ref_count > 1:          # copy-on-write of shared tail
                new_blk = self.blocks.allocate()  # allocate-first: OOM leaves
                self.blocks.release(tail)         # state untouched
                st.blocks[-1] = new_blk
                # the shared tail already holds this sequence's first
                # length % block_size tokens — the device must copy them
                # into the fresh block before the next write
                self._pending_copies.append((tail.idx, new_blk.idx))
        st.length = new_len

    def remove_sequence(self, seq_id: int):
        st = self._seqs.pop(seq_id)
        for blk in st.blocks:
            self.blocks.release(blk)

    # ---- device-facing -------------------------------------------------
    def _blocks_needed(self, length: int) -> int:
        return max(1, -(-length // self.block_size))

    def seq_length(self, seq_id: int) -> int:
        return self._seqs[seq_id].length

    def active_sequences(self) -> List[int]:
        return list(self._seqs)

    def block_table(self, seq_ids: Optional[List[int]] = None) -> np.ndarray:
        """int32 [len(seq_ids), max_blocks_per_seq] block indices (-1 pad) —
        the index-table analogue of the reference's pointer arrays
        (kv_cache_manager.py get_block_pointers)."""
        seq_ids = seq_ids if seq_ids is not None else self.active_sequences()
        table = np.full((len(seq_ids), self.max_blocks_per_seq), -1, np.int32)
        for row, sid in enumerate(seq_ids):
            for j, blk in enumerate(self._seqs[sid].blocks):
                table[row, j] = blk.idx
        return table

    def pop_pending_copies(self) -> List[tuple]:
        """Drain (src_block, dst_block) copy directives created by
        copy-on-write tail splits; the caller performs the device-pool
        copies before its next cache write. (No runtime caller forks yet —
        the serving engine's per-slot caches don't share blocks — but this
        keeps the manager, which is also the spec for the C++ twin, a
        complete COW implementation.)"""
        out, self._pending_copies = self._pending_copies, []
        return out

    def cow_sources(self) -> Dict[int, int]:
        """Blocks that still share storage (for debug/verification)."""
        return {sid: sum(1 for b in st.blocks if b.ref_count > 1)
                for sid, st in self._seqs.items()}
