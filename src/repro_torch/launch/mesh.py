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

Inside ``collective_stats.counting()`` every collective reports its
per-shard payload (``launch/collective_stats.py``).

The model stack's mesh is a ``torch.distributed`` ``DeviceMesh`` over
the process group (NCCL on cards, gloo on the CPU), one rank per device,
with DTensor placements for the reference's ``NamedSharding``s:
``rules_for`` resolves a mesh's logical rules, ``batch_spec`` and
``batch_sharding`` shard the batch over the data axes,
``specs_to_placements`` turns a tree of specs into placement lists,
``distribute`` places a tree of tensors by its specs, and
``make_production_mesh`` builds the reference's 16x16 and 2x16x16
meshes over a process group of 256 or 512 ranks.
"""
from __future__ import annotations

import math
from collections.abc import Mapping

import torch
from torch import nn

from ..core.device import resolve_device
from ..models.common import MeshRules, P, spec_to_placements
from . import collective_stats

__all__ = ["ShardMesh", "make_production_mesh", "rules_for", "batch_spec",
           "batch_sharding", "map_specs", "specs_to_placements",
           "distribute"]


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
        parts = list(parts)
        collective_stats.note("all_gather", parts)
        if self.one_device:
            full = torch.cat(parts)
            return [full] * self.size
        return [torch.cat([p.to(dev) for p in parts]) for dev in self.devices]

    def ppermute(self, parts, perm) -> list:
        """Shard ``dst`` gets shard ``src``'s tensor for each (src, dst) of
        ``perm``; a shard that receives nothing gets zeros (``ppermute``)."""
        collective_stats.note("ppermute", parts)
        out = [None] * self.size
        for src, dst in perm:
            out[dst] = parts[src].to(self.devices[dst])
        return [torch.zeros_like(parts[s], device=self.devices[s])
                if o is None else o for s, o in enumerate(out)]

    def psum(self, parts) -> list[torch.Tensor]:
        """The elementwise sum over the shards in shard order, on every
        shard (``psum``)."""
        collective_stats.note("psum", parts)
        total = parts[0].to(self.devices[0])
        for p in parts[1:]:
            total = total + p.to(self.devices[0])
        return [total.to(dev) for dev in self.devices]

    def pmin(self, parts) -> list[torch.Tensor]:
        """The elementwise minimum over the shards, on every shard
        (``pmin``)."""
        collective_stats.note("pmin", parts)
        low = parts[0].to(self.devices[0])
        for p in parts[1:]:
            low = torch.minimum(low, p.to(self.devices[0]))
        return [low.to(dev) for dev in self.devices]


# ------------------------------------------------- the model stack's mesh
def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production mesh over the process group: 16x16
    ``("data", "model")`` or, ``multi_pod``, 2x16x16 ``("pod", "data",
    "model")``; the group must hold 256 or 512 ranks.  The mesh is a CPU
    one: the dry run builds it over a fake group and traces on it."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def _axis_sizes(mesh) -> dict:
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def rules_for(mesh, *, data_only: bool = False) -> MeshRules:
    """Logical rules for a ``DeviceMesh`` (or an ordered name -> size
    mapping of its axes).  ``data_only`` folds the model axis into the
    data axes (pure data parallelism), the layout for small archs whose
    dims cannot use 16-way tensor parallelism."""
    axis_sizes = _axis_sizes(mesh)
    data_axes = tuple(a for a in ("pod", "data") if a in axis_sizes)
    if data_only:
        return MeshRules(data_axes=data_axes + ("model",), model_axis=None,
                         axis_sizes=axis_sizes)
    return MeshRules(data_axes=data_axes, model_axis="model",
                     axis_sizes=axis_sizes)


def batch_spec(rules: MeshRules, global_batch: int) -> P:
    """Batch-dim sharding over the data axes, falling back to the
    trailing data axis alone, then to replication, where the batch does
    not divide (long_500k has global_batch=1)."""
    total = math.prod(rules.axis_sizes.get(a, 1) for a in rules.data_axes)
    if global_batch % total == 0:
        return P(rules.data)
    last = rules.data_axes[-1]
    if global_batch % rules.axis_sizes.get(last, 1) == 0:
        return P(last)
    return P(None)


def batch_sharding(rules: MeshRules, batch_tree: Mapping) -> dict:
    """Per-leaf input spec: the batch dim over data, the rest
    replicated.  Leaves are anything with a ``shape``."""
    out = {}
    for name, leaf in batch_tree.items():
        bs = batch_spec(rules, leaf.shape[0])
        out[name] = P(*(tuple(bs) + (None,) * (len(leaf.shape) - 1)))
    return out


def map_specs(fn, tree):
    """``fn`` applied to every spec of a tree (dicts, NamedTuples, lists
    and tuples of specs)."""
    if isinstance(tree, P):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_specs(fn, v) for v in tree))
    if isinstance(tree, Mapping):
        return {k: map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_specs(fn, v) for v in tree)
    return tree


def specs_to_placements(mesh, spec_tree):
    """A tree of specs -> the same tree of placement lists on ``mesh``
    (the reference's ``specs_to_shardings``)."""
    return map_specs(lambda s: spec_to_placements(mesh, s), spec_tree)


def _place(t: torch.Tensor, mesh, spec):
    """``t`` (a full tensor, the same on every rank, or a DTensor) as a
    DTensor on ``mesh`` placed by ``spec``; each rank keeps its own slice,
    so placing a full tensor moves nothing between ranks."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    placements = spec_to_placements(mesh, spec)
    if isinstance(t, DTensor):
        return t.redistribute(mesh, placements)
    return distribute_tensor(t, mesh, placements, src_data_rank=None)


def distribute(tree, mesh, spec_tree):
    """Place every tensor of ``tree`` on ``mesh`` by its spec in
    ``spec_tree``: a params module (its class rebuilt from the placed
    tensors, by dotted name), a dict (dotted or nested names), a
    NamedTuple cache, or one tensor."""
    if isinstance(tree, nn.Module):
        named = {n: t.detach() for n, t in tree.named_parameters()}
        return type(tree)(tree.cfg, distribute(named, mesh, spec_tree))
    if isinstance(tree, torch.Tensor):
        return _place(tree, mesh, spec_tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(distribute(v, mesh, s)
                            for v, s in zip(tree, spec_tree)))
    if isinstance(tree, Mapping):
        return {k: distribute(v, mesh, spec_tree[k]) for k, v in tree.items()}
    raise TypeError(f"cannot place a {type(tree).__name__}")
