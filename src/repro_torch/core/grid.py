"""Uniform-grid cell lists: the port of ``repro/core/grid.py``.

* a *grouping* grid with side ``d_cut/sqrt(d)`` over all ``d`` dims —
  same-cell diameter < d_cut, the paper's G (Approx-DPC rule 1);
* a *candidate* grid over ``g = min(d, 3)`` leading dims with side
  ``ceil(sqrt(d)) * d_cut/sqrt(d) >= d_cut``, a coarsening of the grouping
  grid, so one stable sort by (candidate, grouping) key makes both
  partitions contiguous.

Cell boundaries are canonical: coordinates quantize as ``floor(p / side)``
against the absolute origin.  Keys are int64 and every field equals the
reference's ``build_grid`` on the same f32 points.  ``point_span_bounds``
gives each point's candidate spans (the distributed halo strategy's);
``cell_span_bounds`` comes with the stencil slice.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

SENTINEL = torch.iinfo(torch.int64).max


@dataclass(frozen=True)
class Grid:
    """Sorted cell-list view of a point set (indices refer to sorted order)."""

    points: torch.Tensor        # (n, d) float32, sorted by (candidate, grouping) key
    order: torch.Tensor         # (n,) int64 original index of sorted slot i
    inv_order: torch.Tensor     # (n,) int64 sorted slot of original index i
    cand_key: torch.Tensor      # (n,) int64 candidate-cell key, non-decreasing
    group_key: torch.Tensor     # (n,) int64 grouping-cell key
    cand_coords: torch.Tensor   # (n, g) int32 candidate-cell coords per point
    cand_extent: torch.Tensor   # (g,) int64 candidate cells per dim
    cand_strides: torch.Tensor  # (g,) int64 mixed-radix strides of cand key
    cell_keys: torch.Tensor     # (n,) int64 unique candidate keys, then SENTINEL
    cell_start: torch.Tensor    # (n,) int32 first sorted slot of each cell
    cell_count: torch.Tensor    # (n,) int32 members per cell
    point_cell: torch.Tensor    # (n,) int32 unique-cell index of each sorted point
    num_cells: int
    span_cap: int               # max span length
    cell_cap: int               # max members per cell
    g: int                      # gridded dims
    d: int
    d_cut: float


def prefix_offsets(g: int) -> np.ndarray:
    """All {-1,0,1}^(g-1) offsets over the leading g-1 candidate dims."""
    if g <= 1:
        return np.zeros((1, 0), dtype=np.int64)
    grids = np.meshgrid(*([np.array([-1, 0, 1])] * (g - 1)), indexing="ij")
    return np.stack([a.ravel() for a in grids], axis=-1).astype(np.int64)


def group_side(d_cut: float, d: int) -> float:
    """Side of the grouping grid G: d_cut/sqrt(d) (in-cell diameter < d_cut)."""
    return d_cut / math.sqrt(d)


def canonical_group_coords(points: torch.Tensor, d_cut: float) -> torch.Tensor:
    """Canonical (absolute-origin) grouping-cell coordinates, (n, d) int64.

    f32 division by the f32-rounded side, tensor by tensor (no reciprocal
    product), then floor: the reference's quantization bit for bit.
    """
    pts = points.to(torch.float32)
    side = torch.full_like(pts, group_side(d_cut, pts.shape[-1]))
    return torch.floor(pts / side).to(torch.int64)


def _strides(extent: torch.Tensor) -> torch.Tensor:
    """Mixed-radix strides: suffix products of the extents after each dim."""
    tail = torch.cat([extent[1:], torch.ones((1,), dtype=torch.int64,
                                             device=extent.device)])
    return torch.flip(torch.cumprod(torch.flip(tail, (0,)), 0), (0,))


def build_grid(points: torch.Tensor, d_cut: float, g: int | None = None) -> Grid:
    """Build the two-level sorted cell list (measures capacities on the host)."""
    points = torch.as_tensor(points, dtype=torch.float32)
    dev = points.device
    n, d = points.shape
    if g is None:
        g = min(d, 3)
    q = max(int(math.ceil(math.sqrt(d))), 1)     # coarsening factor

    gcoords = canonical_group_coords(points, d_cut)
    gcoords = gcoords - gcoords.min(dim=0).values
    ccoords = torch.div(gcoords[:, :g], q, rounding_mode="floor")

    c_ext = ccoords.max(dim=0).values + 1
    g_ext = gcoords.max(dim=0).values + 1
    c_strides = _strides(c_ext)
    g_strides = _strides(g_ext)
    cand_key = (ccoords * c_strides).sum(-1)
    group_key = (gcoords * g_strides).sum(-1)

    sort_key = cand_key * (group_key.max() + 1) + group_key
    order = torch.argsort(sort_key, stable=True)
    inv_order = torch.argsort(order, stable=True)

    pts_s = points[order]
    cand_s = cand_key[order]
    group_s = group_key[order]
    ccoords_s = ccoords[order].to(torch.int32)

    ar = torch.arange(n, device=dev)
    is_first = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                          cand_s[1:] != cand_s[:-1]])
    num_cells = int(is_first.sum())
    first_slots = torch.full((n,), n - 1, dtype=torch.int64, device=dev)
    first_slots[:num_cells] = torch.nonzero(is_first).flatten()
    alive = ar < num_cells
    cell_keys = torch.where(alive, cand_s[first_slots], SENTINEL)
    cell_start = torch.where(alive, first_slots, n).to(torch.int32)
    nxt = torch.cat([cell_start[1:],
                     torch.full((1,), n, dtype=torch.int32, device=dev)])
    cell_count = torch.where(alive, nxt - cell_start, 0).to(torch.int32)
    point_cell = (torch.cumsum(is_first, 0) - 1).to(torch.int32)

    cell_cap = int(cell_count.max())
    offs = torch.as_tensor(prefix_offsets(g), device=dev)
    starts, ends = _span_bounds(ccoords_s[first_slots[:num_cells]], offs,
                                c_ext, c_strides, cand_s, g)
    span_cap = int((ends - starts).max()) if num_cells > 0 else 0

    return Grid(points=pts_s, order=order, inv_order=inv_order,
                cand_key=cand_s, group_key=group_s, cand_coords=ccoords_s,
                cand_extent=c_ext, cand_strides=c_strides,
                cell_keys=cell_keys, cell_start=cell_start,
                cell_count=cell_count, point_cell=point_cell,
                num_cells=num_cells, span_cap=max(span_cap, 1),
                cell_cap=max(cell_cap, 1), g=g, d=d, d_cut=float(d_cut))


def _span_bounds(coords, offs, extent, strides, cand_sorted, g):
    """[start, end) sorted-slot bounds of each (cell, prefix-offset) span.

    coords: (m, g) candidate coords of the query cells; offs: (S, g-1).
    Returns (m, S) int32 starts and ends.  Out-of-range prefix offsets yield
    empty spans.  The span covers last-dim coords {c-1, c, c+1} clamped.
    """
    m = coords.shape[0]
    S = offs.shape[0]
    c = coords.to(torch.int64)[:, None, :]                          # (m,1,g)
    if g > 1:
        pref = c[..., :-1] + offs[None, :, :]                       # (m,S,g-1)
        valid = ((pref >= 0) & (pref < extent[:-1])).all(dim=-1)
        base = (pref * strides[:-1]).sum(-1)
    else:
        valid = torch.ones((m, S), dtype=torch.bool, device=coords.device)
        base = torch.zeros((m, S), dtype=torch.int64, device=coords.device)
    last = c[..., -1]                                               # (m,1)
    lo_last = torch.clamp_min(last - 1, 0)
    hi_last = torch.minimum(last + 1, extent[-1] - 1)
    key_lo = base + lo_last * strides[-1]
    key_hi = base + hi_last * strides[-1]
    starts = torch.searchsorted(cand_sorted, key_lo.contiguous(), right=False)
    ends = torch.searchsorted(cand_sorted, key_hi.contiguous(), right=True)
    starts = torch.where(valid, starts, 0).to(torch.int32)
    ends = torch.where(valid, ends, 0).to(torch.int32)
    return starts, torch.maximum(ends, starts)


def point_span_bounds(grid: Grid) -> tuple[torch.Tensor, torch.Tensor]:
    """Per sorted-point candidate spans: (n, S) int32 starts and ends of
    the sorted slots in the 3^(g-1) candidate-cell columns around each
    point's cell (S = 9 at d = 3)."""
    offs = torch.as_tensor(prefix_offsets(grid.g), device=grid.points.device)
    return _span_bounds(grid.cand_coords, offs, grid.cand_extent,
                        grid.cand_strides, grid.cand_key, grid.g)


def unsort_dpc(grid: Grid, rho, rho_key, delta, parent):
    """Map engine outputs computed on ``grid.points`` (sorted layout) back to
    the original point order; parents translate from sorted slots to
    original ids."""
    parent_orig = torch.where(parent >= 0,
                              grid.order[parent.clamp_min(0).long()], -1)
    inv = grid.inv_order
    return (rho[inv], rho_key[inv], delta[inv],
            parent_orig[inv].to(torch.int32))
