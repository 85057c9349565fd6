"""Grid-stencil range counting and higher-density NN search: the port of
``repro/core/stencil.py``, the reference backend's forms of the two hot
spots the paper optimizes (local density = range count; dependent point =
constrained NN).

Every function works in *sorted* (grid) order.  A point's candidates are
its 3^(g-1) candidate-cell spans (``grid.point_span_bounds``), which hold
every point within d_cut of it.  The reference pads every query to the
widest span, ``grid.span_cap``, and every cell to the fullest,
``grid.cell_cap``, so its gathers keep static shapes; here each chunk of
queries is padded only to its own widest (``sweep.span_chunks``, queries
in descending order of their candidate count), which gives the same
answers: counts are sums, and each NN is the lowest sorted slot among the
equally near, as the reference's first argmin over spans in slot order.
``sweep._PLAIN_PAIRS`` caps the pairs of a chunk and ``block``, where
given, its queries (the reference's ``block`` sizes its static padding;
here ``None``, the default, leaves the pair budget alone to size the
chunks); no result depends on either.  The
reference's padded query rows (0-valued points, sliced off at ``[:n]``)
are never evaluated here, and its gathers' clamp at n - 1 stays where a
padded position reads the table.
"""
from __future__ import annotations

import torch

from ..kernels.sweep import (clipped_spans, d2cut_of, direct_d2,
                             halo_masked_nn_plain, halo_range_count_plain,
                             masked_nn_plain, span_chunks, span_columns)
from .grid import Grid, cell_span_bounds, point_span_bounds

__all__ = ["density_per_point", "density_per_cell", "dependent_stencil",
           "density_for_slots", "dependent_stencil_slots", "masked_nn_rows"]


def density_per_point(grid: Grid, block: int | None = None) -> torch.Tensor:
    """Exact rho per sorted point, each point gathering its own candidate
    spans (Ex-DPC's "one range search per point"): (n,) f32."""
    starts, ends = point_span_bounds(grid)
    return halo_range_count_plain(grid.points, grid.points, starts, ends,
                                  d2cut_of(grid.d_cut),
                                  block=block).to(torch.float32)


def density_per_cell(grid: Grid, block: int | None = None) -> torch.Tensor:
    """Exact rho per sorted point by *joint* per-cell gathers (Approx-DPC
    §4.2): all members of a candidate cell share one gather of the cell's
    spans, the paper's one enlarged search serving the whole cell.  (n,)
    f32 in sorted order; ``block`` caps the cells of a chunk.

    A chunk's cells are padded to its fullest cell; a padded member slot
    (past its cell's count) is masked before the scatter, where the
    reference scatters it to index n and drops it."""
    pts = grid.points
    n = pts.shape[0]
    nc = grid.num_cells
    rho = torch.zeros((n,), dtype=torch.float32, device=pts.device)
    if n == 0:
        return rho
    starts, ends = cell_span_bounds(grid)
    st, cum = clipped_spans(starts[:nc], ends[:nc], n)
    first = grid.cell_start[:nc].long()
    members = grid.cell_count[:nc].long()
    d2cut = d2cut_of(grid.d_cut)
    for cells, width, m_cap in span_chunks(cum[:, -1], block, mult=members):
        col, valid = span_columns(st[cells], cum[cells], width)
        cand = pts[col]                                    # (k, W, d)
        midx = first[cells, None] + torch.arange(m_cap, device=pts.device)
        mvalid = midx < (first[cells] + members[cells])[:, None]
        mpts = pts[midx.clamp(max=n - 1)]                  # (k, M, d)
        d2 = direct_d2(mpts[:, :, None, :], cand[:, None, :, :])
        cnt = ((d2 < d2cut) & valid[:, None, :]).sum(dim=2,
                                                      dtype=torch.int32)
        rho[midx[mvalid]] = cnt[mvalid].to(torch.float32)
    return rho


def dependent_stencil(grid: Grid, rho_key_sorted: torch.Tensor,
                      block: int | None = None):
    """Nearest higher-density point within the d_cut stencil, per sorted
    point: (delta, parent sorted slot int32, resolved).  Where ``resolved``
    is True, delta/parent are exact (a denser point within d_cut lies in
    the stencil); where False none exists and the caller runs the global
    fallback (delta inf, parent -1)."""
    starts, ends = point_span_bounds(grid)
    best, parent = halo_masked_nn_plain(
        grid.points, rho_key_sorted, grid.points, rho_key_sorted, starts,
        ends, d2cut_of(grid.d_cut), block=block)
    return torch.sqrt(best), parent, torch.isfinite(best)


def _slot_rows(grid: Grid, slots: torch.Tensor):
    """(alive, slots clamped to n - 1, their spans' starts and ends): a slot
    at or past n is padding."""
    n = grid.points.shape[0]
    slots = torch.as_tensor(slots, device=grid.points.device).long()
    slc = slots.clamp(max=n - 1)
    starts, ends = point_span_bounds(grid)
    return slots < n, slc, starts[slc], ends[slc]


def density_for_slots(grid: Grid, slots: torch.Tensor,
                      block: int | None = None) -> torch.Tensor:
    """Exact rho for a subset of sorted slots (S-Approx-DPC's
    representatives), (len(slots),) f32; a slot at or past n is padding
    and returns 0."""
    alive, slc, starts, ends = _slot_rows(grid, slots)
    cnt = halo_range_count_plain(grid.points[slc], grid.points, starts, ends,
                                 d2cut_of(grid.d_cut), block=block)
    return torch.where(alive, cnt, 0).to(torch.float32)


def dependent_stencil_slots(grid: Grid, rho_key_sorted: torch.Tensor,
                            slots: torch.Tensor,
                            block: int | None = None):
    """``dependent_stencil`` restricted to the query rows ``slots`` (a slot
    at or past n is padding, keyed +inf: (inf, -1, False)).  A candidate
    keyed -inf never matches, so callers restrict the candidate set (to
    representatives, say) by masking ``rho_key_sorted``."""
    alive, slc, starts, ends = _slot_rows(grid, slots)
    rk = torch.where(alive, rho_key_sorted[slc], float("inf"))
    best, parent = halo_masked_nn_plain(
        grid.points[slc], rk, grid.points, rho_key_sorted, starts, ends,
        d2cut_of(grid.d_cut), block=block)
    return torch.sqrt(best), parent, torch.isfinite(best)


def masked_nn_rows(query_pts: torch.Tensor, query_rk: torch.Tensor,
                   all_pts: torch.Tensor, all_rk: torch.Tensor):
    """Exact NN among strictly-denser points, query rows against the full
    set: (delta, parent), parent the lowest index among the equally near,
    (inf, -1) where none.  The global fallback for stencil-unresolved
    points (the paper's Lemma 2 (1 - alpha) case), O(m n)."""
    best, parent = masked_nn_plain(query_pts, query_rk, all_pts, all_rk)
    return torch.sqrt(best), parent
