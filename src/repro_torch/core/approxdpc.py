"""Approx-DPC (§4): exact rho, O(1) approximate dependents, same centers.

Paper rules over the grouping grid G (side d_cut/sqrt(d), in-cell
diameter < d_cut):

1. p_i != p*(cell)  ->  parent = p*(cell), delta = d_cut.     [segment argmax]
2. p_i == p*(cell)  ->  the nearest denser point, if within d_cut:
   parent = it, delta = d_cut.
3. otherwise (a cell maximum with no denser point within d_cut): the exact
   nearest denser point and its distance — the "stem" roots, |roots| << n.

Both of the reference's branches, chosen as it chooses
(``repro/core/approxdpc.py:66``, ``use_engine = mxu_dense or sparse``):

* the engine branch (``cuda``, and any backend under the block-sparse
  layout): one fused ``rho_delta`` call counts every row's density and
  answers Def. 2 for the cell maxima, whose nearest denser point decides
  rules 2 and 3.  Under the block-sparse layout that call runs on the
  grid-sorted table and its answers map back through ``unsort_dpc``
  (``exdpc.fused_dpc``, shared with Ex-DPC and Scan);
* the stencil branch (``torch`` in the dense layout): rho by the joint
  per-cell range count (``stencil.density_per_cell``, span
  ``approxdpc.rho``), rule 2 by the d_cut stencil
  (``stencil.dependent_stencil``, span ``approxdpc.stencil``; computed for
  every row, read for the cell maxima) and rule 3 by
  ``exdpc.resolve_fallback`` (span ``approxdpc.fallback``).
"""
from __future__ import annotations

import torch

from .. import obs
from ..engine.planner import as_plan
from .device import as_points
from .dpc_types import DPCResult, with_jitter
from .exdpc import fused_dpc, resolve_fallback
from .grid import Grid, build_grid, unsort_nn
from .stencil import density_per_cell, dependent_stencil


def _group_segments(grid: Grid) -> torch.Tensor:
    """Contiguous grouping-cell segment id per sorted point (G refines the
    candidate grid on the leading dims, so one sort serves both)."""
    gk = grid.group_key
    is_first = torch.cat([torch.ones((1,), dtype=torch.bool, device=gk.device),
                          gk[1:] != gk[:-1]])
    return torch.cumsum(is_first, 0) - 1


def _segment_max(vals: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """Per-segment max (n segments at most; empty segments are never read)."""
    out = torch.empty_like(vals)
    return out.scatter_reduce(0, seg, vals, "amax", include_self=False)


def _maxima_mask(grid: Grid, seg: torch.Tensor, rho_key: torch.Tensor):
    """(n,) bool in original order: the row is its grouping cell's max."""
    rk_s = rho_key[grid.order]
    return (rk_s == _segment_max(rk_s, seg)[seg])[grid.inv_order]


def _run_stencil(points, d_cut: float, pl, grid: Grid,
                 seg: torch.Tensor) -> DPCResult:
    """The stencil branch (``repro/core/approxdpc.py:96-161``)."""
    n = points.shape[0]
    with obs.span("approxdpc.rho", n=n) as sp:
        rho = sp.sync(density_per_cell(grid)[grid.inv_order])
    rho_key = with_jitter(rho)
    rk_sorted = rho_key[grid.order]

    # --- rule 1: in-cell O(1) dependents via segment argmax ---
    is_cellmax = rk_sorted == _segment_max(rk_sorted, seg)[seg]
    slot = torch.arange(n, dtype=torch.int64, device=points.device)
    parent_s = _segment_max(torch.where(is_cellmax, slot, -1), seg)[seg]
    delta_s = torch.full((n,), d_cut, dtype=torch.float32,
                         device=points.device)

    # --- rule 2: cell maxima consult the d_cut stencil (computed for every
    #     row, as the reference's; only the cell maxima read it) ---
    with obs.span("approxdpc.stencil", n=n) as sp:
        _, st_parent, st_found = dependent_stencil(grid, rk_sorted,
                                                   block=pl.block)
        use2 = is_cellmax & st_found
        parent_s = torch.where(use2, st_parent.long(), parent_s)
        resolved_s = ~is_cellmax | use2
        delta, parent = unsort_nn(grid, delta_s, parent_s)
        resolved = sp.sync(resolved_s[grid.inv_order])

    # --- rule 3: the exact fallback for the stem roots ---
    with obs.span("approxdpc.fallback",
                  unresolved=int((~resolved).sum())) as sp:
        delta, parent = sp.sync(resolve_fallback(points, rho_key, delta,
                                                 parent, resolved,
                                                 backend=pl.backend))
    return DPCResult(rho=rho, rho_key=rho_key, delta=delta, parent=parent)


def run_approxdpc(points, d_cut: float, *, g: int | None = None,
                  grid: Grid | None = None, exec_spec=None) -> DPCResult:
    """A tensor runs on its own device; anything else goes to the card.
    The stencil branch's joint per-cell count is chunked by the pair budget
    alone (the reference's ``cell_block`` is not ported), its stencil NN
    also by ``ExecSpec.block`` where given; no result depends on either."""
    points = as_points(points)
    pl = as_plan(exec_spec, points)
    n = points.shape[0]
    dev = points.device
    if grid is None:
        with obs.span("approxdpc.grid", n=n) as sp:
            grid = build_grid(points, d_cut, g=g)
            sp.sync(grid.points)

    seg = _group_segments(grid)
    if not (pl.backend.mxu_dense or pl.grid_sort):
        return _run_stencil(points, d_cut, pl, grid, seg)

    # one engine invocation answers Def. 1 for every row AND Def. 2 for the
    # rows that will need it: only cell maxima consume it (rules 2 + 3)
    rho, rho_key, nn_delta_all, nn_parent_all = fused_dpc(
        points, d_cut, pl, phase="approxdpc", grid=grid,
        fallback_interest=lambda rk: _maxima_mask(grid, seg, rk))
    rk_sorted = rho_key[grid.order]

    # --- rule 1: in-cell O(1) dependents via segment argmax ---
    is_cellmax = rk_sorted == _segment_max(rk_sorted, seg)[seg]
    slot = torch.arange(n, dtype=torch.int64, device=dev)
    cellmax_slot = _segment_max(torch.where(is_cellmax, slot, -1), seg)
    parent_s = cellmax_slot[seg]                  # rule-1 parent (sorted idx)

    # --- rules 2 + 3 from the fused sweep's per-row denser NN.  NN within
    #     d_cut -> rule 2 (delta stamped d_cut); beyond -> rule 3, the exact
    #     root delta (inf at the peak) ---
    with obs.span("approxdpc.rules", n=n) as sp:
        cm_rows = torch.nonzero(is_cellmax[grid.inv_order]).flatten()
        nn_delta = nn_delta_all[cm_rows]
        nn_parent = nn_parent_all[cm_rows]
        parent1 = torch.where(parent_s >= 0,
                              grid.order[parent_s.clamp_min(0)], -1)
        parent1 = parent1[grid.inv_order]
        found2 = torch.isfinite(nn_delta) & (nn_delta < d_cut)
        cm_delta = torch.where(found2, torch.full_like(nn_delta, d_cut),
                               nn_delta)
        delta = torch.full((n,), d_cut, dtype=torch.float32, device=dev)
        delta[cm_rows] = cm_delta
        parent = parent1.to(torch.int32)
        parent[cm_rows] = nn_parent
        sp.sync((delta, parent))
    return DPCResult(rho=rho, rho_key=rho_key, delta=delta, parent=parent)
