"""The shard mesh: the port's counterpart of ``repro/launch/mesh.py``'s
``flatten_mesh`` and of ``shard_map``'s single-controller model.

JAX's ``shard_map`` is single-controller SPMD: one process drives every
device of the mesh, and the collectives inside a shard body (``all_gather``,
``ppermute``, ``pmin``) are array operations over the shards.  A
:class:`ShardMesh` is the same: one process holds a list of S shards, each
with its device, and its collectives take and return per-shard lists of
tensors.  On one card the shards are S logical shards of ``cuda:0``
(``ShardMesh.on("cuda", shards=4)``); with distinct devices a shard's
tensors live on its device and a collective copies between them.  DPC is
data-parallel only, so the mesh has one axis (``flatten``).

A ``torch.distributed`` mesh for hosts with several cards is not ported
(ROADMAP Queue A item 9b).
"""
from __future__ import annotations

import torch

from ..core.device import resolve_device

__all__ = ["ShardMesh"]


class ShardMesh:
    """S shards along one axis, shard s on ``devices[s]``."""

    def __init__(self, devices, axis: str = "data"):
        devices = [torch.device(d) for d in devices]
        if not devices:
            raise ValueError("a mesh needs at least one shard")
        if not axis or not isinstance(axis, str):
            raise ValueError(f"axis must be a non-empty name, got {axis!r}")
        for dev in devices:
            resolve_device(dev)
        self.devices = devices
        self.axis = axis

    @classmethod
    def on(cls, device=None, shards: int = 1,
           axis: str = "data") -> "ShardMesh":
        """``shards`` logical shards on one device; ``device=None`` means
        the card and raises where no GPU is present."""
        if not isinstance(shards, int) or shards < 1:
            raise ValueError(f"shards must be a positive int, got {shards!r}")
        return cls([resolve_device(device)] * shards, axis)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def one_device(self) -> bool:
        return all(d == self.devices[0] for d in self.devices)

    def __repr__(self) -> str:
        return f"ShardMesh({self.size} x {self.axis!r} on {self.devices})"

    def flatten(self, axis: str) -> "ShardMesh":
        """The same shards along the axis ``axis`` (``flatten_mesh``)."""
        return self if axis == self.axis else ShardMesh(self.devices, axis)

    def axis_index(self, shard: int) -> int:
        """The shard's index along the axis (``jax.lax.axis_index``)."""
        return shard

    def shard(self, x: torch.Tensor) -> list[torch.Tensor]:
        """Split rows into S equal contiguous blocks, block s on shard s
        (``P(axis)``); the row count must divide."""
        if x.shape[0] % self.size:
            raise ValueError(f"{x.shape[0]} rows do not split into "
                             f"{self.size} shards")
        rows = x.shape[0] // self.size
        return [x[s * rows:(s + 1) * rows].to(dev)
                for s, dev in enumerate(self.devices)]

    def unshard(self, parts) -> torch.Tensor:
        """Concatenate per-shard row blocks on shard 0's device."""
        return torch.cat([p.to(self.devices[0]) for p in parts])

    def all_gather(self, parts) -> list[torch.Tensor]:
        """Every shard gets the row blocks concatenated in shard order
        (``all_gather(tiled=True)``).  On one device the shards share one
        concatenated tensor, so memory holds one table, not S copies."""
        if self.one_device:
            full = torch.cat(list(parts))
            return [full] * self.size
        return [torch.cat([p.to(dev) for p in parts]) for dev in self.devices]

    def ppermute(self, parts, perm) -> list:
        """Shard ``dst`` gets shard ``src``'s tensor for each (src, dst) of
        ``perm``; a shard that receives nothing gets zeros (``ppermute``)."""
        out = [None] * self.size
        for src, dst in perm:
            out[dst] = parts[src].to(self.devices[dst])
        return [torch.zeros_like(parts[s], device=self.devices[s])
                if o is None else o for s, o in enumerate(out)]

    def psum(self, parts) -> list[torch.Tensor]:
        """The elementwise sum over the shards in shard order, on every
        shard (``psum``)."""
        total = parts[0].to(self.devices[0])
        for p in parts[1:]:
            total = total + p.to(self.devices[0])
        return [total.to(dev) for dev in self.devices]

    def pmin(self, parts) -> list[torch.Tensor]:
        """The elementwise minimum over the shards, on every shard
        (``pmin``)."""
        low = parts[0].to(self.devices[0])
        for p in parts[1:]:
            low = torch.minimum(low, p.to(self.devices[0]))
        return [low.to(dev) for dev in self.devices]
