"""Ex-DPC (§3): the exact algorithm, on the kernel backend.

The paper's incremental kd-tree invariant ("the tree holds exactly the
denser points") becomes a static masked search, realized two ways, chosen
by the backend as the reference chooses (``repro/core/exdpc.py:102``):

* the fused route (``cuda``, and any backend under the block-sparse
  layout): one ``rho_delta`` call counts every row's density and answers
  Def. 2 — on ``cuda`` by the kept-8 resolution plus a masked-NN pass for
  the rows it leaves.  Under the block-sparse layout the call runs on the
  grid-sorted table and its answers map back through ``unsort_dpc``;
* the stencil route (``torch`` in the dense layout, the reference's
  ``jnp`` path): the grid-stencil range count for rho, then the d_cut
  stencil for delta (exact wherever a denser point lies within d_cut, the
  paper's Lemma-2 alpha fraction) and ``resolve_fallback``, the global
  masked NN, for the few rows it leaves.

Both are exact; the stencil route breaks exact distance ties by the
lowest grid-sorted slot, the fused dense route by the lowest original
index (ROADMAP "Reference gaps").
"""
from __future__ import annotations

import torch

from .. import obs
from ..engine.planner import as_plan
from ..kernels.backend import get_backend
from .device import as_points
from .dpc_types import DPCResult, density_jitter, with_jitter
from .grid import Grid, build_grid, unsort_dpc, unsort_nn
from .stencil import density_per_point, dependent_stencil


def resolve_fallback(points, rho_key, delta, parent, resolved, backend=None):
    """The global denser NN of the stencil-unresolved rows: (delta, parent)
    with those rows' answers replaced by ``backend.denser_nn`` of them
    against all points (dense: the reference's ``resolve_fallback``,
    ``repro/core/exdpc.py:41-61``).  The single global density peak keeps
    (inf, -1) (Def. 3).  The reference pads the rows to a power of two for
    its jit; here only the real rows are searched."""
    unresolved = torch.nonzero(~resolved).flatten()
    if unresolved.numel() == 0:
        return delta, parent
    fd, fp = get_backend(backend).denser_nn(points[unresolved],
                                            rho_key[unresolved], points,
                                            rho_key)
    delta, parent = delta.clone(), parent.clone()
    delta[unresolved] = fd
    parent[unresolved] = fp.to(parent.dtype)
    return delta, parent


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
    """A tensor runs on its own device; anything else goes to the card.
    The stencil route's spans are ``exdpc.grid``, ``exdpc.rho``,
    ``exdpc.stencil`` and ``exdpc.fallback``; ``ExecSpec.block`` caps its
    rows evaluated together (``None``: the pair budget alone)."""
    points = as_points(points)
    pl = as_plan(exec_spec, points)
    if pl.backend.mxu_dense or pl.grid_sort:
        return fused_dpc(points, d_cut, pl, phase="exdpc", grid=grid, g=g)

    n = points.shape[0]
    block = pl.block
    if grid is None:
        with obs.span("exdpc.grid", n=n) as sp:
            grid = build_grid(points, d_cut, g=g)
            sp.sync(grid.points)
    with obs.span("exdpc.rho", n=n) as sp:
        rho = sp.sync(density_per_point(grid, block=block)[grid.inv_order])
    rho_key = with_jitter(rho)
    with obs.span("exdpc.stencil", n=n) as sp:
        delta_s, parent_s, resolved_s = dependent_stencil(
            grid, rho_key[grid.order], block=block)
        delta, parent = unsort_nn(grid, delta_s, parent_s)
        resolved = sp.sync(resolved_s[grid.inv_order])
    with obs.span("exdpc.fallback",
                  unresolved=int((~resolved).sum())) as sp:
        delta, parent = sp.sync(resolve_fallback(points, rho_key, delta,
                                                 parent, resolved,
                                                 backend=pl.backend))
    return DPCResult(rho=rho, rho_key=rho_key, delta=delta, parent=parent)
