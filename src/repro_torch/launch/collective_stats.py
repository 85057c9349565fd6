"""Collective traffic of a run over a shard mesh: the port's counterpart of
``repro/launch/hlo_stats.py``.

The reference sums the result sizes of every collective instruction in a
partitioned HLO module.  The port's collectives are the methods of
:class:`~repro_torch.launch.mesh.ShardMesh`, called eagerly, so inside
:func:`counting` each call reports its payload here, with
``hlo_stats.py``'s conventions, per shard:

    all_gather  -> ``all-gather``: the gathered (output) size, what
                   crosses the links to every shard
    psum, pmin  -> ``all-reduce``: the tensor size
    ppermute    -> ``collective-permute``: the tensor size

No link multipliers are applied (a ring all-reduce moves about twice its
payload): these are raw per-shard payload bytes per collective kind, as
the reference reports them.  With no counter active each report is one
list test.

On a ``torch.distributed`` mesh DTensor issues the functional
collectives (``torch.ops._c10d_functional``) on each rank's local
shards; ``functional_payload`` gives one call's kind and per-device
payload with the same conventions (the dry run counts one rank's):

    all_gather_into_tensor -> ``all-gather``: the gathered (output) size
    all_reduce             -> ``all-reduce``: the tensor size
    reduce_scatter_tensor  -> ``reduce-scatter``: the output shard
    all_to_all_single      -> ``all-to-all``: the tensor size
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Iterator

__all__ = ["CollectiveStats", "counting", "note", "KINDS", "FUNCTIONAL",
           "functional_payload"]

# ShardMesh's method -> the HLO collective kind it stands for
KINDS = {"all_gather": "all-gather", "psum": "all-reduce",
         "pmin": "all-reduce", "ppermute": "collective-permute"}

# a functional collective's op name -> (its kind, whether its payload is
# the output's size (else the input's))
FUNCTIONAL = {"all_gather_into_tensor": ("all-gather", True),
              "all_reduce": ("all-reduce", False),
              "reduce_scatter_tensor": ("reduce-scatter", True),
              "all_to_all_single": ("all-to-all", False)}

_STACK: list["CollectiveStats"] = []


@dataclass
class CollectiveStats:
    """Payload bytes per kind and per shard, and the calls per kind."""

    shards: int = 0
    per_shard: dict = field(default_factory=dict)   # kind -> [bytes, ...]
    counts: dict = field(default_factory=dict)      # kind -> calls

    def add(self, kind: str, shard_bytes: list[int]) -> None:
        if len(shard_bytes) > self.shards:
            self.shards = len(shard_bytes)
            for v in self.per_shard.values():
                v.extend([0] * (self.shards - len(v)))
        acc = self.per_shard.setdefault(kind, [0] * self.shards)
        for s, b in enumerate(shard_bytes):
            acc[s] += int(b)
        self.counts[kind] = self.counts.get(kind, 0) + 1

    def bytes(self) -> dict:
        """Per kind, the most any shard moved (every shard moves the same
        where the shards are equal, as a partitioned module's one program
        does)."""
        return {k: max(v) for k, v in self.per_shard.items()}

    def as_dict(self) -> dict:
        """``hlo_stats.collective_bytes``'s shape: ``bytes`` and
        ``counts`` per kind and ``total_bytes`` (per shard), plus
        ``per_shard``."""
        b = self.bytes()
        return {"bytes": b, "counts": dict(self.counts),
                "total_bytes": sum(b.values()),
                "per_shard": {k: list(v) for k, v in self.per_shard.items()}}


@contextlib.contextmanager
def counting() -> Iterator[CollectiveStats]:
    """Count the collectives of the block, on every active counter."""
    stats = CollectiveStats()
    _STACK.append(stats)
    try:
        yield stats
    finally:
        _STACK.remove(stats)


def note(method: str, parts) -> None:
    """Report one ``ShardMesh`` collective: ``method`` its name, ``parts``
    the per-shard tensors it was given.  An all-gather delivers every
    part to every shard; the others deliver one tensor of a part's size to
    each shard."""
    if not _STACK:
        return
    sizes = [p.numel() * p.element_size() for p in parts]
    shard_bytes = ([sum(sizes)] * len(sizes) if method == "all_gather"
                   else sizes)
    for stats in _STACK:
        stats.add(KINDS[method], shard_bytes)


def functional_payload(func, args, out):
    """(kind, [bytes]) of one functional collective call on one rank
    (``FUNCTIONAL``), or None for any other op."""
    if (func.namespace != "_c10d_functional"
            or func.overloadpacket.__name__ == "wait_tensor"):
        return None
    entry = FUNCTIONAL.get(func.overloadpacket.__name__)
    if entry is None:
        raise ValueError(f"{func}: a collective this count does not know")
    kind, of_output = entry
    t = out if of_output else args[0]
    return kind, [t.numel() * t.element_size()]
