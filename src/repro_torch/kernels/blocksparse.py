"""Block-sparse tile worklists: the grid-pruned, sub-quadratic sweep.

The port of the flat-worklist half of ``repro/kernels/blocksparse.py``.  On
grid-sorted points (``core.grid``'s (candidate, grouping) sort) each tile
of rows covers a compact region of space, so a per-tile axis-aligned
bounding box bounds every distance a tile pair can produce:

* ``lb`` — the least squared distance between two boxes, shrunk by
  ``LB_SHRINK`` so the bound's own f32 rounding can never exceed a pair's
  direct-difference d2 (pruning by it is exact);
* ``ub`` — the largest, grown by ``UB_GROW``.

:func:`build_flat_worklist` keeps, per row tile, the column tiles whose
``lb <= d_cut^2`` (``in_cut``: the count needs them) and those whose ``lb``
is within the static k-NN radius (the kept-k needs them), sorted by
ascending ``lb`` — the ring order in which the CUDA kernel K3 walks them
and skips, against each row's live k-th distance, the entries that can no
longer matter.  Its other two forms: the count-only worklist (the
``in_cut`` pairs, for K8) and the best-1 ring (every tile pair, for K9,
which stops its walk where no row can improve).  The reference builds them
on the host in numpy; here they are built in torch on the points' device,
a chunk of row tiles at a time, so the build's own peak memory stays small
at millions of points.

Not ported: the jnp ring walk (the reference backend's form), the halo
spans (``starts``/``ends``, with ``nn_dcut``: the halo worklist forms) and
the fingerprint cache ``worklist_cache``: every call builds its worklist.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..obs import metrics as _obsm

__all__ = ["LB_SHRINK", "UB_GROW", "BLOCK_N", "BLOCK_M", "Worklist",
           "tile_bounds", "pair_bounds", "knn_radius", "build_flat_worklist"]

# Conservative slack on the f32 bound arithmetic (the reference's values).
LB_SHRINK = 1.0 - 1e-5
UB_GROW = 1.0 + 1e-5

# The fused sweep's tile shape: rows per row tile (one K3 block, one thread
# per row) and columns per column tile (kWlRows / kWlCols in csrc/sweep.cu).
BLOCK_N = 256
BLOCK_M = 512

# bound matrices are built over chunks of at most this many tile pairs
_CHUNK_PAIRS = 1 << 24

_M_BUILDS = _obsm.counter("worklist_builds", "flat-worklist builds")
_G_WL_LEN = _obsm.gauge(
    "worklist_len", "kept tile-pair count of the most recent build")
_G_WL_PRUNED = _obsm.gauge(
    "worklist_pruned_frac", "pruned tile fraction of the most recent build")


@dataclass(frozen=True)
class Worklist:
    """Kept tile pairs in CSR form over row tiles.

    Row tile ``t`` owns entries ``row_ptr[t] .. row_ptr[t+1]``, sorted by
    ascending ``lb`` (ties in column-tile order).
    """

    row_ptr: torch.Tensor       # (nbr + 1,) int32
    col_tile: torch.Tensor      # (W,) int32
    in_cut: torch.Tensor        # (W,) bool: lb <= d_cut^2, the count's pairs
    lb: torch.Tensor            # (W,) f32 lower bound of the pair's d2
    n_kept: int                 # W
    n_total: int                # nbr * nbc, the dense tile-pair count

    @property
    def pruned_frac(self) -> float:
        return 1.0 - self.n_kept / max(self.n_total, 1)

    @property
    def num_row_tiles(self) -> int:
        return self.row_ptr.numel() - 1

    def row_tile(self) -> torch.Tensor:
        """(W,) int64 row tile of every entry."""
        counts = (self.row_ptr[1:] - self.row_ptr[:-1]).long()
        return torch.repeat_interleave(
            torch.arange(self.num_row_tiles, device=counts.device), counts)


def tile_bounds(x: torch.Tensor, block: int):
    """Per-tile AABB (lo, hi), each (ceil(n / block), d): the ragged last
    tile is bounded by its real rows only."""
    n, d = x.shape
    nb = -(-n // block)
    lo = torch.full((nb * block, d), float("inf"), dtype=torch.float32,
                    device=x.device)
    hi = torch.full_like(lo, float("-inf"))
    lo[:n] = x
    hi[:n] = x
    return (lo.view(nb, block, d).amin(1), hi.view(nb, block, d).amax(1))


def pair_bounds(rlo, rhi, clo, chi):
    """(lb, ub), each (nbr, nbc) f32: the least and largest squared
    distance between a row box and a column box, summed over dims in
    order (as ``direct_d2``), then shrunk / grown."""
    lb = ub = None
    for k in range(rlo.shape[1]):
        gap = torch.maximum(clo[None, :, k] - rhi[:, None, k],
                            rlo[:, None, k] - chi[None, :, k]).clamp_min(0.0)
        reach = torch.maximum(chi[None, :, k] - rlo[:, None, k],
                              rhi[:, None, k] - clo[None, :, k]).clamp_min(0.0)
        g2, r2 = gap * gap, reach * reach
        lb = g2 if lb is None else lb + g2
        ub = r2 if ub is None else ub + r2
    return lb * LB_SHRINK, ub * UB_GROW


def knn_radius(ub: torch.Tensor, col_counts: torch.Tensor,
               k: int) -> torch.Tensor:
    """Per row tile, the smallest upper bound v such that the column tiles
    with ub <= v hold at least k candidates (+inf if all of y holds fewer):
    a pair whose lb exceeds it has k strictly closer candidates and never
    enters the row's kept k.

    The reference sorts ub per row tile and walks the cumulative counts
    (``_knn_radius``; ``_knn_walk`` here).  Where the tiles holding fewer
    than k candidates hold fewer than k together (all of y: only the last
    tile is short, since ``BLOCK_M >= k``), that walk stops at the first
    tile that holds k alone, so the radius is the least ub over such
    tiles, with no sort.  A gate's per-tile counts (S-Approx-DPC) take the
    walk.
    """
    small = col_counts < k
    if int(col_counts[small].sum()) >= k:
        return _knn_walk(ub, col_counts, k)
    return torch.where(small[None, :], float("inf"), ub).amin(1)


def _knn_walk(ub: torch.Tensor, col_counts: torch.Tensor,
              k: int) -> torch.Tensor:
    """The reference's walk: sort ub per row tile, sum the counts in that
    order, take the ub of the first prefix that holds k."""
    ub_sorted, o = torch.sort(ub, dim=1)
    cum = torch.cumsum(col_counts[o], dim=1)
    reach = (cum < k).sum(1, keepdim=True).clamp(max=ub.shape[1] - 1)
    radius = ub_sorted.gather(1, reach)[:, 0]
    return torch.where(cum[:, -1] >= k, radius, float("inf"))


def build_flat_worklist(x: torch.Tensor, y: torch.Tensor, d_cut=None, *,
                        count: bool = True, nn: str | None = "topk",
                        k: int = 8,
                        nn_col_counts: torch.Tensor | None = None
                        ) -> Worklist:
    """A worklist of x's ``BLOCK_N``-row tiles over y's ``BLOCK_M``-row
    column tiles (the reference's ``build_flat_worklist`` at that tile
    shape), built on the points' device.  Three forms:

    * ``count=True, nn="topk"`` (default; K3): kept ``lb <= d_cut^2``
      (``in_cut``) or ``lb <= knn_radius``;
    * ``count=True, nn=None`` (K8): kept ``in_cut``;
    * ``count=False, nn="best1"`` (K9, ``d_cut`` unused): every tile pair,
      ``in_cut`` False.

    The least-lb pair of every row tile is kept too, so every row tile has
    an entry.  The threshold is ``float(d_cut) ** 2`` rounded once to f32,
    as the reference compares it with its f32 bounds.  ``nn_col_counts``
    ((column tiles,) int) counts the columns of each tile that may enter
    the kept k (a gated sweep's selected columns); by default every column
    may.
    """
    if (count, nn) not in ((True, "topk"), (True, None), (False, "best1")):
        raise ValueError(f"worklist form count={count!r}, nn={nn!r} is not "
                         f"ported (topk with count, count alone, or best1 "
                         f"alone)")
    if BLOCK_M < k:
        raise ValueError(f"BLOCK_M={BLOCK_M} must hold the kept k={k}")
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    dev = x.device
    n, m = x.shape[0], y.shape[0]
    nbr, nbc = -(-n // BLOCK_N), -(-m // BLOCK_M)
    _M_BUILDS.inc()
    rlo, rhi = tile_bounds(x, BLOCK_N)
    clo, chi = tile_bounds(y, BLOCK_M)
    thr = float(np.float32(float(d_cut) ** 2)) if count else 0.0
    if nn_col_counts is None:
        col_counts = (m - torch.arange(nbc, device=dev) * BLOCK_M).clamp(
            0, BLOCK_M)
    else:
        col_counts = torch.as_tensor(nn_col_counts, device=dev).long()
        if col_counts.shape != (nbc,):
            raise ValueError(f"nn_col_counts of shape "
                             f"{tuple(col_counts.shape)} for {nbc} column "
                             f"tiles")

    per_row, cols, cuts, lbs = [], [], [], []
    step = max(1, _CHUNK_PAIRS // max(nbc, 1))
    for r0 in range(0, nbr, step):
        r1 = min(nbr, r0 + step)
        lb, ub = pair_bounds(rlo[r0:r1], rhi[r0:r1], clo, chi)
        if nn == "best1":
            # every pair: a per-row sort is np.lexsort((lb, row tile))
            wl, wj = torch.sort(lb, dim=1, stable=True)
            per_row.append(torch.full((r1 - r0,), nbc, device=dev))
            cols.append(wj.flatten().to(torch.int32))
            cuts.append(torch.zeros((wl.numel(),), dtype=torch.bool,
                                    device=dev))
            lbs.append(wl.flatten())
            continue
        in_cut = lb <= thr
        keep = in_cut.clone()
        if nn == "topk":
            keep |= lb <= knn_radius(ub, col_counts, k)[:, None]
        rows = torch.arange(r1 - r0, device=dev)
        keep[rows, lb.argmin(1)] = True
        wi, wj = torch.nonzero(keep, as_tuple=True)      # row-major
        wl = lb[wi, wj]
        # np.lexsort((wl, wi)): by row tile, then lb, ties in column order
        o = torch.sort(wl, stable=True).indices
        o = o[torch.sort(wi[o], stable=True).indices]
        wi, wj, wl = wi[o], wj[o], wl[o]
        per_row.append(keep.sum(1))
        cols.append(wj.to(torch.int32))
        cuts.append(in_cut[wi, wj])
        lbs.append(wl)

    counts = torch.cat(per_row) if per_row else torch.zeros(
        (0,), dtype=torch.int64, device=dev)
    row_ptr = torch.zeros((nbr + 1,), dtype=torch.int64, device=dev)
    row_ptr[1:] = torch.cumsum(counts, 0)
    n_kept = int(row_ptr[-1])
    if n_kept >= 2**31:
        raise ValueError(f"{n_kept} worklist entries exceed int32 indexing")
    out = Worklist(
        row_ptr=row_ptr.to(torch.int32),
        col_tile=torch.cat(cols) if cols else torch.zeros(
            (0,), dtype=torch.int32, device=dev),
        in_cut=torch.cat(cuts) if cuts else torch.zeros(
            (0,), dtype=torch.bool, device=dev),
        lb=torch.cat(lbs) if lbs else torch.zeros(
            (0,), dtype=torch.float32, device=dev),
        n_kept=n_kept, n_total=nbr * nbc)
    _G_WL_LEN.set(out.n_kept)
    _G_WL_PRUNED.set(round(out.pruned_frac, 6))
    return out
