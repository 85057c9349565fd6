"""The sharded stream's repair tail: maxima NN, label propagation and the
center distances, the port of ``repro/stream/sharded.py``.

``incremental.make_sharded_repair`` shards the rho repair; the stages
after it shard too, over the same axis of a
:class:`~repro_torch.launch.mesh.ShardMesh`, the window's slots split into
S contiguous blocks (``mesh.shard``):

* **maxima NN re-query** (:func:`make_sharded_nn_update`), in place of
  ``backend.denser_nn_update`` (K6): the query rows are gathered once,
  each shard runs ``backend.denser_nn`` (K2, or K9 on the best-1 ring
  under a block-sparse layout) against its block, and the shards' answers
  merge on the lexicographic (d2, global slot) minimum before the square
  root, as K6 picks.  The reference merges the rooted delta first
  (``pmin``), then the lowest slot among its holders; two d2 one ulp apart
  can share an f32 root, and there it takes the lower slot where K6 takes
  the smaller d2 (ROADMAP "Reference gaps").
* **label propagation** (:func:`make_sharded_labels`): the ceil(log2 n)
  pointer-jump rounds of ``core.labels._propagate``, each shard jumping
  its own chunk of the table against the all-gathered one and
  ``all_gather`` re-replicating it.  The reference contracts a
  (chunk, n) one-hot per round; a gather gives the same integer
  trajectory without the 2^38 floats that one-hot holds at a 2^20 window.
* **center distances** (:func:`make_sharded_center_dists`): the f64
  (m_new, m_old) matrix of ``StreamDPC._match_centers``, each shard's
  block of new-center rows computed on its device and summed over the
  dims in numpy's order (pairwise from eight dims on), the square root
  taken by numpy on the host, so the matrix equals the reference's numpy
  expression bit for bit.  The single-device stream runs it on a
  one-shard mesh of its device.

The NN and label stages equal their single-device counterparts bit for
bit.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import obs
from repro_torch.analysis.audit import audit_check_rep
from repro_torch.core.labels import Clustering, select_centers

__all__ = ["make_sharded_nn_update", "make_sharded_labels",
           "make_sharded_center_dists"]

_INT32_MAX = 2**31 - 1


def _shards(mesh, axis: str, capacity: int | None = None):
    """The mesh along ``axis``; ``capacity`` rows must split evenly."""
    flat = mesh.flatten(axis)
    if capacity is not None and capacity % flat.size:
        raise ValueError(f"{flat.size} shards do not divide the window "
                         f"capacity {capacity}")
    return flat


def make_sharded_nn_update(mesh, axis: str, backend, layout: str | None = None):
    """``backend.denser_nn_update``'s signature, the window's rows sharded
    over ``mesh``; ``layout`` is the shard phases' layout
    (``distributed.dpc.shard_blocksparse_layout``)."""
    flat = _shards(mesh, axis)
    S = flat.size

    @audit_check_rep(
        "window rows and keys are shard-local; both outputs are made the "
        "same on every shard by explicit lexicographic pmin reductions "
        "(best d2, then the lowest global slot among its holders)",
        collectives=("pmin",))
    def nn_update(window_dev, rho_key, q_slots):
        n = window_dev.shape[0]
        _shards(flat, axis, n)              # the rows must split evenly
        slots = torch.as_tensor(q_slots, device=window_dev.device).long()
        q = slots.numel()
        if q == 0:
            return (torch.full((0,), float("inf"), device=window_dev.device),
                    torch.full((0,), -1, dtype=torch.int32,
                               device=window_dev.device))
        # the query rows, gathered once from clean slots: slots outside
        # [0, n) are padding, keyed +inf, and come back (inf, -1)
        valid = (slots >= 0) & (slots < n)
        rows = torch.where(valid, slots, 0)
        x = window_dev[rows]
        x_key = torch.where(valid, rho_key[rows], float("inf"))
        w_p, k_p = flat.shard(window_dev), flat.shard(rho_key)
        rows_per = n // S
        d2, cols = [], []
        for s, dev in enumerate(flat.devices):
            dd, pp = backend.denser_nn(x.to(dev), x_key.to(dev), w_p[s],
                                       k_p[s], layout=layout, squared=True)
            d2.append(dd)
            cols.append(torch.where(pp >= 0, pp.long() + s * rows_per,
                                    _INT32_MAX))
        # (d2, global slot) lexicographic minimum: the best d2 first, then
        # the lowest slot among its holders; the root only after
        best = flat.pmin(d2)
        arg = flat.pmin([torch.where(dd == b, c, _INT32_MAX)
                         for dd, b, c in zip(d2, best, cols)])[0]
        best = best[0].to(window_dev.device)
        parent = torch.where(torch.isfinite(best), arg.to(best.device), -1)
        return torch.sqrt(best), parent.to(torch.int32)

    return nn_update


def make_sharded_labels(mesh, axis: str, capacity: int):
    """``assign(res, rho_min, delta_min) -> Clustering``, equal to
    ``core.labels.assign_labels`` at the window's capacity."""
    n = int(capacity)
    flat = _shards(mesh, axis, n)
    S = flat.size
    chunk = n // S
    steps = max(int(math.ceil(math.log2(max(n, 2)))), 1)

    @audit_check_rep(
        "each pointer-jump round jumps my shard's chunk against the "
        "replicated table and re-replicates it with an explicit "
        "all_gather, the same on every shard by construction",
        collectives=("all_gather",))
    def propagate(p0: torch.Tensor) -> torch.Tensor:
        table = flat.all_gather(flat.shard(p0))
        for _ in range(steps):
            table = flat.all_gather([
                t[t[s * chunk:(s + 1) * chunk]] for s, t in enumerate(table)])
        return table[0]

    def assign(res, rho_min: float, delta_min: float) -> Clustering:
        with obs.span("labels.assign", shards=S) as sp:
            centers, noise = select_centers(res, rho_min, delta_min)
            ar = torch.arange(n, dtype=torch.int64, device=res.parent.device)
            p0 = torch.where(centers, ar, res.parent.long())
            p0 = torch.where(p0 < 0, ar, p0)      # the global peak: a root
            root = propagate(p0).to(ar.device)
            cid = torch.cumsum(centers.to(torch.int32), 0) - 1
            labels = cid[root]
            reached = centers[root]
            labels = torch.where(noise | ~reached, -1, labels).to(torch.int32)
            sp.sync(labels)
        return Clustering(labels=labels, centers=centers,
                          num_clusters=centers.sum(dtype=torch.int32))

    return assign


def _numpy_sum(cols: list) -> torch.Tensor:
    """The sum of ``cols`` in the order numpy's ``add.reduce`` takes over a
    contiguous axis (its pairwise summation): in order below eight terms;
    up to 128, eight running sums combined as ((r0+r1)+(r2+r3)) +
    ((r4+r5)+(r6+r7)) and the rest added in order; above, split at half
    rounded down to a multiple of eight."""
    n = len(cols)
    if n < 8:
        total = cols[0]
        for c in cols[1:]:
            total = total + c
        return total
    if n <= 128:
        r = list(cols[:8])
        i = 8
        while i < n - n % 8:
            r = [r[j] + cols[i + j] for j in range(8)]
            i += 8
        total = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5])
                                                   + (r[6] + r[7]))
        for c in cols[i:]:
            total = total + c
        return total
    half = n // 2
    half -= half % 8
    return _numpy_sum(cols[:half]) + _numpy_sum(cols[half:])


def _center_block(new: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """Squared f64 distances of a block of new centers to every previous
    one, summed over the dims in numpy's order."""
    diff = new[:, None, :].double() - prev[None, :, :].double()
    sq = diff * diff
    return _numpy_sum([sq[..., k] for k in range(sq.shape[-1])])


def make_sharded_center_dists(mesh, axis: str):
    """``center_dists(new_pos, prev_pos) -> (m_new, m_old) f64 ndarray``,
    the new centers sharded over the mesh; equal bit for bit to the
    reference's ``sqrt(((new[:, None] - prev[None]) ** 2).sum(-1))`` in
    numpy f64."""
    flat = _shards(mesh, axis)
    S = flat.size

    def center_dists(new_pos: np.ndarray, prev_pos: np.ndarray) -> np.ndarray:
        m, d = new_pos.shape
        pad = np.zeros((-(-m // S) * S, d), np.float32)
        pad[:m] = new_pos
        new_p = flat.shard(torch.from_numpy(pad).to(flat.devices[0]))
        prev = torch.from_numpy(np.ascontiguousarray(prev_pos, np.float32))
        d2 = flat.unshard([_center_block(nb, prev.to(dev))
                           for nb, dev in zip(new_p, flat.devices)])
        # the root on the host: torch's vectorized f64 sqrt on the CPU is
        # not always correctly rounded, numpy's is
        return np.sqrt(d2[:m].cpu().numpy())

    return center_dists
