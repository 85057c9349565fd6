"""Ex-DPC (§3): the exact algorithm, on the kernel backend.

The port of the reference's engine path (``repro/core/exdpc.py:65-103``):
one fused ``rho_delta`` call counts every row's density and keeps its 8
nearest candidates; the kept-k resolution answers Def. 2 wherever a denser
point is among them, and a masked-NN pass answers every other row, so the
result is exact — the paper's incremental kd-tree invariant ("the tree holds
exactly the denser points") becomes that static masked search.  Under the
block-sparse layout the call runs on the grid-sorted table and its answers
map back through ``unsort_dpc``.

The reference's stencil route (its ``jnp`` backend, with
``resolve_fallback``) comes with the reference-backend slice (ROADMAP
Queue A item 1).
"""
from __future__ import annotations

from .. import obs
from ..engine.planner import as_plan
from .device import as_points
from .dpc_types import DPCResult, density_jitter
from .grid import Grid, build_grid, unsort_dpc


def fused_dpc(points, d_cut: float, pl, *, phase: str,
              grid: Grid | None = None, g: int | None = None,
              fallback_interest=None) -> DPCResult:
    """Rho, rho_key, delta and parent of every row through the plan's fused
    ``rho_delta``, grid-sorted first when the plan asks for it; spans are
    named ``<phase>.grid`` and ``<phase>.rho_delta``.

    ``fallback_interest`` (rho_key in the points' order -> (n,) bool) names
    the rows whose delta and parent the caller reads; the others may come
    back as (inf, -1).  Without it every row is exact.
    """
    n = points.shape[0]
    jitter = density_jitter(n, points.device)
    if not pl.grid_sort:
        with obs.span(f"{phase}.rho_delta", n=n, layout=pl.layout) as sp:
            return DPCResult(*sp.sync(pl.rho_delta(
                points, points, d_cut, jitter=jitter,
                fallback_interest=fallback_interest)))
    if grid is None:
        with obs.span(f"{phase}.grid", n=n) as sp:
            grid = build_grid(points, d_cut, g=g)
            sp.sync(grid.points)
    interest = None if fallback_interest is None else (
        lambda rk_s: fallback_interest(rk_s[grid.inv_order])[grid.order])
    with obs.span(f"{phase}.rho_delta", n=n, layout=pl.layout) as sp:
        out = pl.rho_delta(grid.points, grid.points, d_cut,
                           jitter=jitter[grid.order],
                           fallback_interest=interest)
        return DPCResult(*sp.sync(unsort_dpc(grid, *out)))


def run_exdpc(points, d_cut: float, *, g: int | None = None,
              grid: Grid | None = None, exec_spec=None) -> DPCResult:
    """A tensor runs on its own device; anything else goes to the card."""
    points = as_points(points)
    pl = as_plan(exec_spec, points)
    return fused_dpc(points, d_cut, pl, phase="exdpc", grid=grid, g=g)
