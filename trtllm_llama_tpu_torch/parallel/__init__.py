"""Tensor parallelism over `torch.distributed` (the port's `parallel/`):
`mapping` (the layout and its process group), `sharding` (each rank's
parameter shards), `comm` (the collectives) and `launch` (N ranks of a
worker on one machine)."""

from .mapping import Mapping, single_device_mapping  # noqa: F401
