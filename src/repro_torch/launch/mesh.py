"""Device meshes for sharded SpGEMM plans.

The port of ``repro.launch.mesh.make_shard_mesh``. The JAX package lays
a sharded plan's numeric phase out as one ``shard_map`` program over a
mesh axis; PyTorch has no such program, so a shard here is one program of
its own on its device, and a :class:`Mesh` is only what the plan needs to
know: the axis name, the shard count and the devices, one per shard.

A device may appear more than once. That is the counterpart of the JAX
package's forced host devices, and how one card holds 2, 4 or 8 shards
(``make_shard_mesh(4, devices=["cuda:0"] * 4)``). The JAX package's
other helpers (``make_production_mesh``, ``make_host_mesh``) and its
sharding rules (``launch/sharding.py``) have no counterpart: they place
the LM's arrays on a TPU mesh, which one card does not have.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.kernels.backend import resolve_device

__all__ = ["Mesh", "make_shard_mesh"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A one-axis device mesh: ``devices[i]`` runs shard ``i``."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("shard",)

    def __post_init__(self):
        if len(self.axis_names) != 1:
            raise ValueError(f"a shard mesh has one axis, got {self.axis_names}")
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        kinds = {d.type for d in self.devices}
        if len(kinds) != 1:
            raise ValueError(f"a mesh's devices are all of one type, got {sorted(kinds)}")

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis_names[0]: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)


def make_shard_mesh(
    n_shards: Optional[int] = None,
    axis: str = "shard",
    *,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """1-D mesh over the first ``n_shards`` of ``devices`` (default: every
    CUDA device; ``n_shards`` defaults to all of them). The mesh shape the
    sharded SpGEMM plan partitions its panel schedule over.

    ``devices`` may repeat a device, so that several shards share one
    card (or the CPU). More shards than devices raises, as in the JAX
    package. Plans key their cache entries on the mesh's axis, shard
    count and device list, so pattern-equal callers building meshes here
    meet on one cache entry.
    """
    if devices is None:
        resolve_device("cuda")  # raises without a card
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    if n_shards is None:
        n_shards = len(devices)
    if n_shards < 1 or n_shards > len(devices):
        raise ValueError(f"n_shards={n_shards} out of range for {len(devices)} devices")
    return Mesh(tuple(devices[:n_shards]), (axis,))
