"""S-Approx-DPC (§5): grid sampling + cell-based clustering.

A coarse grid G' with side eps*d_cut/sqrt(d) picks one *representative* per
cell; only representatives do range searches (exact rho) and dependent-point
searches; the other points chain to their representative in O(1).

Both of the reference's branches (``repro/core/sapproxdpc.py:37-180``),
chosen as it chooses (``use_engine = mxu_dense or sparse``):

* the engine branch (``cuda``, and any backend under the block-sparse
  layout): one fused ``rho_delta`` call of the representatives against
  all points counts their exact rho and, with the kept-k gated to
  representative columns (``y_sel_slots``), finds each one's nearest
  strictly denser representative;
* the stencil branch (``torch`` in the dense layout): the
  representatives' rho by ``stencil.density_for_slots`` (span
  ``sapproxdpc.rep_rho``), then (span ``sapproxdpc.phase12``) phase 1 by
  ``stencil.dependent_stencil_slots`` among the representatives and
  phase 2 by the dense ``denser_nn`` among them for the ones it leaves.

Within d_cut the nearest denser representative answers the paper's
phase 1 (delta stamped d_cut, inside its (1+eps)*d_cut bound); beyond, it
IS phase 2's exact answer.  Members: parent = their representative, delta
= min(eps, 1)*d_cut (below delta_min, so a member is never a center), rho
= the representative's.  The representatives are marked by their own
slots, where the reference's padded scatter also marks the last grid slot
a member (ROADMAP "Reference gaps").
"""
from __future__ import annotations

import math

import torch

from .. import obs
from ..engine.planner import as_plan
from .device import as_points
from .dpc_types import DPCResult, density_jitter, with_jitter
from .grid import Grid, _strides, build_grid
from .stencil import density_for_slots, dependent_stencil_slots


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


def _stencil_reps(grid: Grid, d_cut: float, pl, rep_slots: torch.Tensor,
                  seg: torch.Tensor):
    """The stencil branch (``repro/core/sapproxdpc.py:95-99``, ``:126-157``):
    (rho, rho_key in the points' order, and per representative the
    distance and sorted slot of its nearest strictly denser
    representative).  Phase 1 finds it within d_cut; phase 2 searches all
    representatives for those it leaves, its parent the lowest
    representative index among the equally near, as the reference's."""
    n = grid.points.shape[0]
    block = pl.block
    with obs.span("sapproxdpc.rep_rho", n=n, reps=rep_slots.numel()) as sp:
        rep_rho = sp.sync(density_for_slots(grid, rep_slots, block=block))
    # members inherit their representative's rho
    rho = rep_rho[seg][grid.inv_order]
    rho_key = with_jitter(rho)
    rk_sorted = rho_key[grid.order]
    with obs.span("sapproxdpc.phase12", reps=rep_slots.numel()) as sp:
        rk_reps = torch.full_like(rk_sorted, float("-inf"))
        rk_reps[rep_slots] = rk_sorted[rep_slots]
        nn_d, nn_p, found = dependent_stencil_slots(grid, rk_reps, rep_slots,
                                                    block=block)
        unresolved = torch.nonzero(~found).flatten()
        sp.set(unresolved=unresolved.numel())
        if unresolved.numel():
            rep_pts = grid.points[rep_slots]
            rep_rk = rk_sorted[rep_slots]
            fd, fp = pl.denser_nn(rep_pts[unresolved], rep_rk[unresolved],
                                  rep_pts, rep_rk)
            nn_d, nn_p = nn_d.clone(), nn_p.clone()
            nn_d[unresolved] = fd
            nn_p[unresolved] = torch.where(
                fp >= 0, rep_slots[fp.clamp_min(0).long()], -1).to(nn_p.dtype)
        sp.sync((nn_d, nn_p))
    return rho, rho_key, nn_d, nn_p


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

    if pl.backend.mxu_dense or pl.grid_sort:
        # the reps' exact rho and their nearest strictly denser
        # representative, in one gated sweep of the reps against all
        # points; the jitter indexes by original point id, so a rep's key
        # equals its rho_key below
        rep_jit = density_jitter(n, dev)[grid.order[rep_slots]]
        with obs.span("sapproxdpc.rep_sweep", n=n, reps=num_reps,
                      layout=pl.layout) as sp:
            rep_rho, _, nn_d, nn_p = sp.sync(pl.rho_delta(
                grid.points[rep_slots], grid.points, d_cut, jitter=rep_jit,
                y_sel_slots=rep_slots))
        rho = None
    else:
        rho, rho_key, nn_d, nn_p = _stencil_reps(grid, d_cut, pl, rep_slots,
                                                 seg)

    with obs.span("sapproxdpc.assemble", n=n) as sp:
        if rho is None:     # members inherit their representative's rho
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
