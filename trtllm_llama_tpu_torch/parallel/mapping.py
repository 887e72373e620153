"""Parallel layout (the port's copy of the JAX package's
`parallel/mapping.py`).

`Mapping` has the JAX package's axes: dp (batch replicas), tp (tensor
parallel, the reference's only axis), sp (sequence parallel, with
`shard_kv_seq` the KV cache's S axis too), pp (pipeline stages) and ep
(MoE experts); `world_size` is their product. The JAX package builds one
`jax.sharding.Mesh` and lets GSPMD insert the collectives. The port holds
each rank's shard itself (`parallel/sharding.py`) and calls the
collectives itself (`parallel/comm.py`) over a `torch.distributed` process
group: `Mapping.make_group` is the counterpart of `make_mesh`.

Only tp is ported. dp, sp, pp and ep above 1 raise `NotImplementedError`
naming ROADMAP item A 5, where they are queued.
"""

from __future__ import annotations

import dataclasses

import torch

# where the unported axes are queued
_UNPORTED = "ROADMAP A 5 (dp, sp with shard_kv_seq, pp, ep)"


@dataclasses.dataclass(frozen=True)
class Mapping:
    """How many ways each axis is sharded (the JAX package's fields)."""

    dp: int = 1
    tp: int = 1
    sp: int = 1
    pp: int = 1
    ep: int = 1
    shard_kv_seq: bool = False

    @property
    def world_size(self) -> int:
        return self.dp * self.pp * self.sp * self.ep * self.tp

    def check_ported(self) -> None:
        """Raise NotImplementedError for an axis the port does not run."""
        unported = [f"{a}={getattr(self, a)}" for a in ("dp", "sp", "pp", "ep")
                    if getattr(self, a) > 1]
        if self.shard_kv_seq:
            unported.append("shard_kv_seq")
        if unported:
            raise NotImplementedError(
                f"Mapping({', '.join(unported)}): only tp is ported; the "
                f"other mapping axes are {_UNPORTED}")

    def make_group(self, backend=None, device="cuda"):
        """(tp process group, this process's rank in it) from an initialised
        `torch.distributed`, the counterpart of the JAX package's
        `make_mesh`. The group holds ranks 0..tp-1 of the world. backend:
        the caller's choice; None means NCCL for `device` "cuda" (raises
        where NCCL is missing: no quiet switch) and gloo for "cpu". Raises
        ValueError when the world is smaller than world_size, as make_mesh
        does for too few devices."""
        import torch.distributed as dist
        self.check_ported()
        if not dist.is_initialized():
            raise RuntimeError("Mapping.make_group needs an initialised "
                               "torch.distributed (parallel/launch.py)")
        world = dist.get_world_size()
        if world < self.world_size:
            raise ValueError(f"need {self.world_size} ranks, have {world}")
        if backend is None:
            if torch.device(device).type == "cuda":
                if not dist.is_nccl_available():
                    raise RuntimeError(
                        "NCCL is not available in this torch build; pass "
                        "backend='gloo' explicitly to run over gloo")
                backend = "nccl"
            else:
                backend = "gloo"
        # every rank of the world takes part in new_group, as it must
        group = dist.new_group(list(range(self.tp)), backend=backend)
        rank = dist.get_rank()
        if rank >= self.tp:
            raise ValueError(f"rank {rank} is outside the tp group of "
                             f"{self.tp} (only tp is ported)")
        return group, rank


def single_device_mapping() -> Mapping:
    return Mapping(dp=1, tp=1)
