"""Incremental maintenance of the grouping cell list and the sliding-window
rho: the port of ``repro/stream/incremental.py``.

* Cell coordinates are canonical (``core.grid.canonical_group_coords``,
  absolute-origin ``floor(p / side)``), so the maintained partition equals
  what a from-scratch grid of the current window would give.
* ``apply`` updates cell membership with O(batch) host bookkeeping — a
  key -> cell-id dict, per-cell member counts and a free list that
  recycles the ids of emptied cells, keeping every id below the window
  capacity — and mirrors the per-slot segment ids to the device.  As in the
  reference the bookkeeping stays on the host; the device mirror
  ``seg_dev`` is updated **in place** (``index_copy_``), so ``snapshot``
  clones it.
* Capacities are measured at rebuild time: the live-cell budget
  ``maxima_cap`` and the coordinate box that bounds key packing.  A batch
  that overflows either raises :class:`CellOverflow`, and the caller
  rebuilds.  rho does not depend on the partition and survives a rebuild.
* Dirty tracking: ``apply`` records the grouping-cell coordinates the
  batch touched (inserted and evicted points), and ``dirty_near`` answers
  which query cells lie within a Chebyshev radius of any of them.  The
  reference forms the (queries, touched, d) difference array on the host;
  here the same boolean comes from a set of dilated touched-cell keys where
  (2 r + 1)^d offsets are few, and from chunked differences otherwise, both
  on the grid's device.
* ``repair_rho``: one signed range count over the insert/evict batch (K5)
  plus fresh counts for the inserted rows (K4).

``make_sharded_repair`` (the sharded stream) waits for the next
distributed slice (ROADMAP Queue A item 9); the distributed batch phases
are ported (``repro_torch.distributed``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.grid import canonical_group_coords

# dirty_near's work budgets: dilated keys held at once, and query x touched
# x dim differences per chunk of the fallback
_DILATED_MAX = 1 << 24
_PAIRWISE_CHUNK = 1 << 24


class CellOverflow(Exception):
    """A batch exceeded a measured capacity; the grid must be rebuilt."""


def _round_up(x: int, m: int) -> int:
    return -(-int(x) // m) * m


def _near_dilated(q: torch.Tensor, t: torch.Tensor, rc: int) -> torch.Tensor:
    """(len(q),) bool: some row of t lies within Chebyshev ``rc`` of the
    row of q — by packing every t + offset, offset in [-rc, rc]^d, into a
    key over a box that holds them and q, and looking q's keys up in the
    sorted set."""
    d = q.shape[1]
    lo = torch.minimum(q.amin(0), t.amin(0) - rc)
    ext = torch.maximum(q.amax(0), t.amax(0) + rc) - lo + 1
    strides = torch.ones(d, dtype=torch.int64, device=q.device)
    for k in range(d - 2, -1, -1):
        strides[k] = strides[k + 1] * ext[k + 1]
    span = torch.arange(-rc, rc + 1, dtype=torch.int64, device=q.device)
    offs = torch.cartesian_prod(*([span] * d)).reshape(-1, d)
    # int64 sums of products (CUDA has no int64 matrix product)
    keys = (((t - lo) * strides).sum(1)[:, None]
            + (offs * strides).sum(1)[None, :])
    keys = torch.unique(keys.flatten())               # sorted
    qk = ((q - lo) * strides).sum(1)
    pos = torch.searchsorted(keys, qk).clamp(max=keys.numel() - 1)
    return keys[pos] == qk


def _near_pairwise(q: torch.Tensor, t: torch.Tensor, rc: int) -> torch.Tensor:
    """The same boolean from the Chebyshev differences, a chunk of query
    rows at a time."""
    out = torch.zeros(q.shape[0], dtype=torch.bool, device=q.device)
    step = max(1, _PAIRWISE_CHUNK // max(t.numel(), 1))
    for r0 in range(0, q.shape[0], step):
        cheb = (q[r0:r0 + step, None, :] - t[None]).abs().amax(-1)
        out[r0:r0 + step] = (cheb <= rc).any(1)
    return out


def _box_fits(q: torch.Tensor, t: torch.Tensor, rc: int) -> bool:
    """The dilated box's key range fits int64."""
    ext = (torch.maximum(q.amax(0), t.amax(0) + rc)
           - torch.minimum(q.amin(0), t.amin(0) - rc) + 1)
    vol = 1
    for e in ext.tolist():
        vol *= int(e)
    return vol < 2**62


class IncrementalGrid:
    """Slot-indexed grouping-cell bookkeeping over a sliding window."""

    def __init__(self, d_cut: float, capacity: int, dim: int,
                 cell_slack: float = 2.0, extent_margin: int = 4,
                 device="cpu"):
        if cell_slack < 1.0:
            raise ValueError("cell_slack must be >= 1")
        self.d_cut = float(d_cut)
        self.capacity = int(capacity)
        self.dim = int(dim)
        self.cell_slack = float(cell_slack)
        self.extent_margin = int(extent_margin)
        self.device = torch.device(device)
        self.rebuilds = 0
        self._built = False
        # what stats() reads; 0 until the first rebuild measures them (the
        # reference sets neither here, so its stats() raises before then)
        self.live_cells = 0
        self.maxima_cap = 0
        # grouping-cell coords touched by the last successful apply();
        # None = unknown (fresh build / rebuild) -> treat everything dirty
        self.last_touched: np.ndarray | None = None

    # ------------------------------------------------------------- helpers
    def _coords(self, pts: np.ndarray) -> np.ndarray:
        """Canonical grouping coords, computed on the host with the same f32
        division as build_grid (bit-identical partitions)."""
        return canonical_group_coords(torch.from_numpy(
            np.ascontiguousarray(pts, np.float32)), self.d_cut).numpy()

    def _pack(self, coords: np.ndarray) -> np.ndarray:
        """Pack coords into int64 keys against the measured box; raises
        CellOverflow when a coordinate falls outside it."""
        rel = coords - self.box_lo
        if (rel < 0).any() or (rel >= self.box_extent).any():
            raise CellOverflow("coordinate outside the indexed box")
        return rel @ self.strides

    # ------------------------------------------------------------- rebuild
    def rebuild(self, pts: np.ndarray, count: int) -> None:
        """Re-derive all bookkeeping from the current window (host, O(n))."""
        pts = np.asarray(pts[:count], np.float32)
        coords = self._coords(pts)
        margin = self.extent_margin
        self.box_lo = coords.min(axis=0) - margin
        self.box_extent = (coords.max(axis=0) + margin + 1) - self.box_lo
        ext = self.box_extent.astype(np.int64)
        self.strides = np.concatenate(
            [np.cumprod(ext[::-1])[::-1][1:], np.ones(1, np.int64)])
        keys = self._pack(coords)
        uniq, inv = np.unique(keys, return_inverse=True)
        live = len(uniq)
        self.key_to_id = {int(k): i for i, k in enumerate(uniq)}
        self.cell_count = np.zeros(self.capacity, np.int32)
        self.cell_count[:live] = np.bincount(inv, minlength=live)
        self.live_cells = live
        self.free_ids: list[int] = []
        self.next_id = live
        self.maxima_cap = min(
            self.capacity,
            _round_up(max(64, int(live * self.cell_slack)), 64))
        self.seg_np = np.zeros(self.capacity, np.int32)
        self.seg_np[:count] = inv
        self.seg_dev = torch.from_numpy(self.seg_np.copy()).to(self.device)
        self.rebuilds += 1 if self._built else 0
        self._built = True
        self.last_touched = None        # apply may have part-mutated

    # --------------------------------------------------------------- apply
    def apply(self, slots: np.ndarray, new_pts: np.ndarray,
              old_pts: np.ndarray, r: int) -> None:
        """Batched insert/evict: slot ``slots[i]``'s point changes from
        ``old_pts[i]`` to ``new_pts[i]`` for i < r.

        Raises CellOverflow when the live-cell count would exceed the
        measured ``maxima_cap`` or a new point leaves the indexed box; the
        caller must ``rebuild`` (the bookkeeping may be part-updated)."""
        if not self._built:
            raise RuntimeError("apply before rebuild")
        if r == 0:
            self.last_touched = np.zeros((0, self.dim), np.int64)
            return
        old_coords = self._coords(old_pts[:r])
        new_coords = self._coords(new_pts[:r])
        old_keys = self._pack(old_coords)
        new_keys = self._pack(new_coords)                    # may raise
        # evictions first: emptied ids return to the free list before the
        # insert loop allocates, so ids never exceed the live-cell bound
        for k in old_keys:
            cid = self.key_to_id[int(k)]
            self.cell_count[cid] -= 1
            if self.cell_count[cid] == 0:
                del self.key_to_id[int(k)]
                self.free_ids.append(cid)
                self.live_cells -= 1
        ids = np.empty(r, np.int32)
        for i, k in enumerate(new_keys):
            cid = self.key_to_id.get(int(k))
            if cid is None:
                if self.live_cells + 1 > self.maxima_cap:
                    raise CellOverflow("live cells exceed measured capacity")
                cid = self.free_ids.pop() if self.free_ids else self.next_id
                if cid == self.next_id:
                    self.next_id += 1
                self.key_to_id[int(k)] = cid
                self.live_cells += 1
            self.cell_count[cid] += 1
            ids[i] = cid
        self.seg_np[slots[:r]] = ids
        self.seg_dev.index_copy_(0, torch.from_numpy(
            np.asarray(slots[:r], np.int64)).to(self.device),
            torch.from_numpy(ids).to(self.device))
        self.last_touched = np.concatenate([old_coords, new_coords])

    # ----------------------------------------------------------- snapshot
    def snapshot(self) -> dict:
        """Pre-tick state capture for transactional rollback.  What
        ``apply`` mutates in place (``cell_count``, ``seg_np``, ``seg_dev``)
        is copied; what it only reassigns is kept by reference."""
        if not self._built:
            return {"built": False}
        return {
            "built": True,
            "box_lo": self.box_lo, "box_extent": self.box_extent,
            "strides": self.strides,
            "key_to_id": dict(self.key_to_id),
            "cell_count": self.cell_count.copy(),
            "live_cells": self.live_cells,
            "free_ids": list(self.free_ids),
            "next_id": self.next_id,
            "maxima_cap": self.maxima_cap,
            "seg_np": self.seg_np.copy(),
            "seg_dev": self.seg_dev.clone(),
            "rebuilds": self.rebuilds,
            "last_touched": self.last_touched,
        }

    def restore(self, snap: dict) -> None:
        """Roll back to a :meth:`snapshot`."""
        self._built = snap["built"]
        if not self._built:
            self.last_touched = None
            self.live_cells = self.maxima_cap = 0
            return
        self.box_lo = snap["box_lo"]
        self.box_extent = snap["box_extent"]
        self.strides = snap["strides"]
        self.key_to_id = dict(snap["key_to_id"])
        self.cell_count = snap["cell_count"].copy()
        self.live_cells = snap["live_cells"]
        self.free_ids = list(snap["free_ids"])
        self.next_id = snap["next_id"]
        self.maxima_cap = snap["maxima_cap"]
        self.seg_np = snap["seg_np"].copy()
        self.seg_dev = snap["seg_dev"].clone()
        self.rebuilds = snap["rebuilds"]
        self.last_touched = snap["last_touched"]

    # --------------------------------------------------------------- dirty
    def dirty_near(self, coords, radius_cells: int) -> np.ndarray:
        """(len(coords),) bool: within ``radius_cells`` (Chebyshev, grouping
        cells) of any cell the last batch touched.  ``None`` record (fresh
        build / rebuild / overflow) reports all-dirty.  ``coords`` is a
        numpy array or a tensor of int64 cell coordinates."""
        n = len(coords)
        if self.last_touched is None:
            return np.ones(n, bool)
        if len(self.last_touched) == 0 or n == 0:
            return np.zeros(n, bool)
        rc = int(radius_cells)
        q = torch.as_tensor(coords, dtype=torch.int64, device=self.device)
        t = torch.unique(torch.from_numpy(self.last_touched.astype(
            np.int64)).to(self.device), dim=0)
        dilated = t.shape[0] * (2 * rc + 1) ** self.dim
        if dilated <= _DILATED_MAX and _box_fits(q, t, rc):
            near = _near_dilated(q, t, rc)
        else:
            near = _near_pairwise(q, t, rc)
        return near.cpu().numpy()


# ------------------------------------------------------------- rho repair
def repair_rho(backend, d_cut: float, window_dev, rho, delta_batch, signs,
               ins_batch, slots):
    """Exact sliding-window density repair (slot-indexed).

    * survivors: rho += the signed range count over the (insert +1 /
      evict -1) batch — ``range_count_delta`` (K5);
    * inserted rows: a fresh ``range_count`` against the post-insert
      window (K4), written into their slots (``slots`` >= len(rho) are
      padding rows and are dropped).

    Counts are exact integers in f32, so repairs never drift from a
    from-scratch recount.  Returns a new tensor; ``rho`` is not modified.
    """
    delta = backend.range_count_delta(window_dev, delta_batch, signs, d_cut)
    fresh = backend.range_count(ins_batch, window_dev, d_cut)
    out = rho + delta
    slots = torch.as_tensor(slots, dtype=torch.int64, device=out.device)
    keep = slots < out.shape[0]
    out[slots[keep]] = fresh[keep]
    return out
