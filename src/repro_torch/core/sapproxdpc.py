"""S-Approx-DPC (§5): grid sampling + cell-based clustering.

A coarse grid G' with side eps*d_cut/sqrt(d) picks one *representative* per
cell; only representatives do range searches (exact rho) and dependent-point
searches; the other points chain to their representative in O(1).

This is the reference's engine branch (``repro/core/sapproxdpc.py:37-180``):
one fused ``rho_delta`` call of the representatives against all points
counts their exact rho and, with the kept-k gated to representative
columns (``y_sel_slots``), finds each one's nearest strictly denser
representative.  Within d_cut that answers the paper's phase 1 (delta
stamped d_cut, inside its (1+eps)*d_cut bound); beyond, it IS phase 2's
exact answer.  Members: parent = their representative, delta =
min(eps, 1)*d_cut (below delta_min, so a member is never a center), rho =
the representative's.  The stencil branch, which the reference takes on
its ``jnp`` backend, comes with the reference-backend slice (ROADMAP
Queue A item 1).
"""
from __future__ import annotations

import math

import torch

from .. import obs
from ..engine.planner import as_plan
from .device import as_points
from .dpc_types import DPCResult, density_jitter, with_jitter
from .grid import Grid, _strides, build_grid


def coarse_cell_key(points: torch.Tensor, d_cut: float,
                    eps: float) -> torch.Tensor:
    """(n,) int64 key of each point's cell in G' (side eps*d_cut/sqrt(d),
    origin at the points' minimum), mixed radix over all d dims.

    The division is tensor by tensor at the f32-rounded side, so no backend
    swaps it for a product with the reciprocal: the reference's cells bit
    for bit."""
    d = points.shape[1]
    off = points - points.min(dim=0).values
    side = torch.full_like(off, eps * d_cut / math.sqrt(d))
    coords = torch.floor(off / side).to(torch.int64)
    strides = _strides(coords.max(dim=0).values + 1)
    return (coords * strides).sum(-1)


def representatives(grid: Grid, d_cut: float, eps: float):
    """(rep_slots, seg): per G' cell its representative, the first point of
    the cell in grid-sorted order, as a grid-sorted slot, in coarse-key
    order (the reference's order); and each sorted slot's cell index into
    ``rep_slots``."""
    ckey = coarse_cell_key(grid.points, d_cut, eps)
    order_c = torch.argsort(ckey, stable=True)
    ck = ckey[order_c]
    is_first = torch.cat([torch.ones((1,), dtype=torch.bool,
                                     device=ck.device), ck[1:] != ck[:-1]])
    rep_slots = order_c[is_first]
    seg = torch.empty_like(order_c)
    seg[order_c] = torch.cumsum(is_first, 0) - 1
    return rep_slots, seg


def run_sapproxdpc(points, d_cut: float, eps: float = 0.8, *,
                   g: int | None = None, grid: Grid | None = None,
                   exec_spec=None) -> DPCResult:
    """A tensor runs on its own device; anything else goes to the card."""
    if eps <= 0.0:
        raise ValueError(f"S-Approx-DPC needs eps > 0 (the coarse-grid "
                         f"side is eps*d_cut/sqrt(d)); got {eps!r}")
    points = as_points(points)
    pl = as_plan(exec_spec, points)
    n = points.shape[0]
    dev = points.device
    if grid is None:
        with obs.span("sapproxdpc.grid", n=n) as sp:
            grid = build_grid(points, d_cut, g=g)
            sp.sync(grid.points)

    with obs.span("sapproxdpc.reps", n=n) as sp:
        rep_slots, seg = representatives(grid, d_cut, eps)
        num_reps = rep_slots.numel()
        sp.set(num_reps=num_reps)
        sp.sync(seg)

    # the reps' exact rho and their nearest strictly denser representative,
    # in one gated sweep of the reps against all points; the jitter indexes
    # by original point id, so a rep's key equals its rho_key below
    rep_jit = density_jitter(n, dev)[grid.order[rep_slots]]
    with obs.span("sapproxdpc.rep_sweep", n=n, reps=num_reps,
                  layout=pl.layout) as sp:
        rep_rho, _, nn_d, nn_p = sp.sync(pl.rho_delta(
            grid.points[rep_slots], grid.points, d_cut, jitter=rep_jit,
            y_sel_slots=rep_slots))

    with obs.span("sapproxdpc.assemble", n=n) as sp:
        # members inherit their representative's rho
        rho = rep_rho[seg][grid.inv_order]
        rho_key = with_jitter(rho)
        # phase 1 (a denser rep within d_cut: delta stamped d_cut) or
        # phase 2 (the exact NN among reps; inf at the peak)
        found = torch.isfinite(nn_d) & (nn_d < d_cut)
        rep_delta = torch.where(found, torch.full_like(nn_d, d_cut), nn_d)
        is_rep = torch.zeros((n,), dtype=torch.bool, device=dev)
        is_rep[rep_slots] = True
        member_delta = torch.full((n,), min(eps, 1.0) * d_cut,
                                  dtype=torch.float32, device=dev)
        delta_s = torch.where(is_rep, rep_delta[seg], member_delta)
        parent_s = torch.where(is_rep, nn_p[seg].long(), rep_slots[seg])
        delta = delta_s[grid.inv_order]
        parent_sorted = parent_s[grid.inv_order]
        parent = torch.where(parent_sorted >= 0,
                             grid.order[parent_sorted.clamp_min(0)],
                             -1).to(torch.int32)
        sp.sync((delta, parent))
    return DPCResult(rho=rho, rho_key=rho_key, delta=delta, parent=parent)
