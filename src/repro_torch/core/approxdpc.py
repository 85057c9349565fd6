"""Approx-DPC (§4): exact rho, O(1) approximate dependents, same centers.

Paper rules over the grouping grid G (side d_cut/sqrt(d), in-cell
diameter < d_cut):

1. p_i != p*(cell)  ->  parent = p*(cell), delta = d_cut.     [segment argmax]
2. p_i == p*(cell)  ->  the nearest denser point, if within d_cut:
   parent = it, delta = d_cut.
3. otherwise (a cell maximum with no denser point within d_cut): the exact
   nearest denser point and its distance — the "stem" roots, |roots| << n.

This is the reference's engine branch (``repro/core/approxdpc.py:81-135``):
one fused ``rho_delta`` call counts every row's density and answers Def. 2
for the cell maxima, whose nearest denser point decides rules 2 and 3.  The
stencil branch, which the reference takes on its ``jnp`` backend, comes with
the reference-backend slice (ROADMAP Queue A).
"""
from __future__ import annotations

import torch

from .. import obs
from ..engine.planner import as_plan
from .device import as_points
from .dpc_types import DPCResult, density_jitter
from .grid import Grid, build_grid


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


def run_approxdpc(points, d_cut: float, *, g: int | None = None,
                  grid: Grid | None = None, exec_spec=None) -> DPCResult:
    """A tensor runs on its own device; anything else goes to the card."""
    points = as_points(points)
    pl = as_plan(exec_spec, points)
    n = points.shape[0]
    dev = points.device
    if grid is None:
        with obs.span("approxdpc.grid", n=n) as sp:
            grid = build_grid(points, d_cut, g=g)
            sp.sync(grid.points)

    seg = _group_segments(grid)

    # one engine invocation answers Def. 1 for every row AND Def. 2 for the
    # rows that will need it: only cell maxima consume it (rules 2 + 3)
    with obs.span("approxdpc.rho_delta", n=n, layout=pl.layout) as sp:
        rho, rho_key, nn_delta_all, nn_parent_all = sp.sync(pl.rho_delta(
            points, points, d_cut, jitter=density_jitter(n, dev),
            fallback_interest=lambda rk: _maxima_mask(grid, seg, rk)))
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
