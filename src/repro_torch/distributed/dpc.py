"""Distributed exact DPC over a shard mesh: the port of
``repro/distributed/dpc.py``.

The reference maps the paper's multicore parallelization onto
``shard_map`` SPMD phases over a ``data`` mesh axis; the port runs the same
phases over a :class:`~repro_torch.launch.mesh.ShardMesh`, one process
driving every shard, with the reference's collectives as tensor operations
over the shards' tensors (``all_gather``, ``ppermute`` rings):

* points are grid-sorted and split into S equal contiguous chunks (rows
  padded at 1e9 to a multiple of S): equal point counts of a space-sorted
  table are the paper's cost model;
* **gather** strategy: every shard counts (rho) and searches the nearest
  strictly denser row (delta) over the all-gathered table, dense (K4, K2)
  or under a block-sparse plan on worklists (K8, K9); the delta phase is
  globally exact, so nothing falls back.  On a backend that is not
  ``mxu_dense`` (``torch``) in the dense layout the phases are the
  reference's gather-form stencil instead (``_make_rho`` /
  ``_make_delta``): each shard's rows over their candidate spans into the
  gathered table, the delta within d_cut, and the rows without a denser
  point there go to the fallback;
* **halo** strategy: each shard assembles the window ``[lo, lo + W)`` of
  the sorted table its candidate spans reach, through two ``ppermute``
  chains of ``hops_fwd`` / ``hops_bwd`` hops, and runs the span-masked
  count (K10) and the d_cut-bounded denser NN (K11) on it; rows without a
  denser point within d_cut go to the fallback, the denser NN over the
  gathered table (K2, or K9 on a block-sparse plan).

Everything is exact: the output equals ``core.run_exdpc`` / ``run_scan``
up to exact distance ties, which every phase breaks by the lowest
grid-sorted slot.  Not ported: ``_bs_shards_safe``, the probe against a jax
XLA SPMD miscompile, which has nothing to guard here.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import obs
from ..analysis.audit import audit_check_rep
from ..core.device import as_points
from ..core.dpc_types import DPCResult, with_jitter
from ..core.grid import build_grid, point_span_bounds
from ..engine.planner import as_plan
from ..engine.spec import ExecSpec
from ..kernels.sweep import PAD_COORD
from ..launch.mesh import ShardMesh

__all__ = ["DistDPCConfig", "distributed_dpc", "shard_blocksparse_layout"]

_STRATEGIES = ("gather", "halo")


@dataclass(frozen=True)
class DistDPCConfig:
    """Distributed-phase parameters; execution (backend, layout, data axis)
    is one :class:`ExecSpec` on ``exec_spec``.  The reference's legacy
    ``backend``/``layout``/``block``/``data_axis`` fields are not ported
    (``carry.dist_config`` folds them into the spec)."""

    d_cut: float
    fallback_cap_factor: float = 0.05
    # 'gather': replicate the sorted table per shard; 'halo': ring-exchange
    #   only the blocks each shard's candidate window reaches
    strategy: str = "gather"
    exec_spec: ExecSpec | None = None

    def __post_init__(self):
        if not self.d_cut > 0.0:
            raise ValueError(f"d_cut must be positive, got {self.d_cut!r}")
        if self.strategy not in _STRATEGIES:
            raise ValueError(f"unknown strategy {self.strategy!r}; "
                             f"expected one of {_STRATEGIES}")
        if self.exec_spec is None:
            object.__setattr__(self, "exec_spec", ExecSpec())
        elif not isinstance(self.exec_spec, ExecSpec):
            raise TypeError(f"exec_spec must be an ExecSpec, got "
                            f"{type(self.exec_spec).__name__}")

    def resolved_exec(self) -> ExecSpec:
        return self.exec_spec


def _pad_rows(x: torch.Tensor, m: int, value) -> torch.Tensor:
    out = torch.full((m, *x.shape[1:]), value, dtype=x.dtype,
                     device=x.device)
    out[:x.shape[0]] = x
    return out


@audit_check_rep(
    "each shard's window is assembled from the blocks the ppermute ring "
    "delivers to it, copied into the window rows its own lo[s] names; "
    "nothing is claimed the same on every shard",
    collectives=("ppermute",))
def _halo_window(mesh: ShardMesh, tbl_parts, lo, W: int, hops_fwd: int,
                 hops_bwd: int) -> list[torch.Tensor]:
    """Each shard's candidate window, rows [lo[s], lo[s] + W) of the sorted
    table, assembled through two ppermute chains: passing left delivers the
    blocks after a shard's own (hop h: block s+h), passing right those
    before it (hop h: block s-h), and the window rows a visiting block owns
    are copied in.  Rows past the table stay zero, as the reference's.  The
    ring moves (hops_fwd + hops_bwd) blocks per shard, against S blocks for
    the all-gather."""
    S, m = mesh.size, tbl_parts[0].shape[0]
    windows = [torch.zeros((W, *p.shape[1:]), dtype=p.dtype, device=p.device)
               for p in tbl_parts]

    def take_into(visiting, vid):
        for s in range(S):
            b = vid(s) % S               # the block shard s holds now
            r0, r1 = max(lo[s], b * m), min(lo[s] + W, (b + 1) * m)
            if r0 < r1:
                windows[s][r0 - lo[s]:r1 - lo[s]] = \
                    visiting[s][r0 - b * m:r1 - b * m]

    left = [(i, (i - 1) % S) for i in range(S)]
    right = [(i, (i + 1) % S) for i in range(S)]
    visiting = list(tbl_parts)
    for h in range(hops_fwd + 1):        # h = 0: the shard's own block
        take_into(visiting, lambda s, h=h: s + h)
        if h < hops_fwd:
            visiting = mesh.ppermute(visiting, left)
    visiting = list(tbl_parts)
    for h in range(1, hops_bwd + 1):
        visiting = mesh.ppermute(visiting, right)
        take_into(visiting, lambda s, h=h: s - h)
    return windows


def _window_bounds(starts: torch.Tensor, ends: torch.Tensor, S: int):
    """Host-computed per-shard window bounds from the (padded) span table:
    ``lo`` (S,) the first slot any of a shard's spans reach (or its own
    first row), ``W`` the widest window, and the ring's reach in blocks,
    forward ``hf`` and backward ``hb``."""
    rows_per = starts.shape[0] // S
    st = starts.cpu().numpy().astype(np.int64).reshape(S, rows_per, -1)
    en = ends.cpu().numpy().astype(np.int64).reshape(S, rows_per, -1)
    lo = np.where(en > st, st, np.iinfo(np.int64).max).reshape(S, -1).min(1)
    hi = en.reshape(S, -1).max(1)
    first = np.arange(S) * rows_per
    lo = np.minimum(lo, first)
    hi = np.maximum(hi, first + rows_per)
    W = int((hi - lo).max())
    hf = int(min(S - 1, -(-max(int((hi - first - rows_per).max()), 0)
                          // rows_per)))
    hb = int(min(S - 1, -(-max(int((first - lo).max()), 0) // rows_per)))
    return [int(v) for v in lo], W, hf, hb


@audit_check_rep(
    "window rows arrive via the ppermute ring (_halo_window); every "
    "output row is shard-local (my rows' counts over my window), nothing "
    "is claimed replicated", collectives=("ppermute",))
def _rho_halo(mesh, be, d_cut, span_w, lo, W, hf, hb, pts_p, st_p, en_p):
    """Halo rho phase: ring-assemble each shard's window, then the
    backend's span-masked range count on window-local spans."""
    windows = _halo_window(mesh, pts_p, lo, W, hf, hb)
    return [be.range_count_halo(pts_p[s], windows[s], st_p[s] - lo[s],
                                en_p[s] - lo[s], d_cut, span_cap=span_w)
            for s in range(mesh.size)]


@audit_check_rep(
    "same ppermute-ring window assembly as the rho phase; the outputs "
    "(delta, parent, found) are all shard-local per-row results, parents "
    "mapped to global slots through the shard's own lo[s]",
    collectives=("ppermute",))
def _delta_halo(mesh, be, d_cut, span_w, lo, W, hf, hb, pts_p, rkq_p,
                st_p, en_p, rk_p):
    """Halo delta phase: the window of (point, key) rows, then the
    backend's span-masked NN within d_cut; window parents map to global
    sorted slots."""
    both = [torch.cat([p, k[:, None]], 1) for p, k in zip(pts_p, rk_p)]
    wboth = _halo_window(mesh, both, lo, W, hf, hb)
    out = []
    for s in range(mesh.size):
        window = wboth[s][:, :-1].contiguous()
        wkey = wboth[s][:, -1].contiguous()
        dd, pp, ok = be.denser_nn_halo(pts_p[s], rkq_p[s], window, wkey,
                                       st_p[s] - lo[s], en_p[s] - lo[s],
                                       d_cut, span_cap=span_w)
        out.append((dd, torch.where(ok, pp + lo[s], -1).to(torch.int32),
                    ok))
    return out


@audit_check_rep(
    "the gathered table is the same on every shard by all_gather (one "
    "concatenation in shard order); the range count reads it and writes "
    "shard-local per-row counts only", collectives=("all_gather",))
def _rho_gather(mesh, be, d_cut, layout, pts_p):
    """Gather rho phase: my rows x the all-gathered table (K4, or K8 on the
    count-only worklist: a shard's rows are a contiguous chunk of the
    space-sorted table, so their tiles prune most of it)."""
    tbl = mesh.all_gather(pts_p)
    return [be.range_count(pts_p[s], tbl[s], d_cut, layout=layout)
            for s in range(mesh.size)]


@audit_check_rep(
    "the gathered table is the same on every shard by all_gather; each "
    "shard counts its own rows over their global spans into it, "
    "shard-local per-row counts only", collectives=("all_gather",))
def _rho_stencil(mesh, be, d_cut, span_w, pts_p, st_p, en_p):
    """Gather-form stencil rho phase (the reference's ``_make_rho``): my
    rows over their candidate spans into the all-gathered table, through
    the backend's gather-form span count (the table is the window)."""
    tbl = mesh.all_gather(pts_p)
    return [be.range_count_halo(pts_p[s], tbl[s], st_p[s], en_p[s], d_cut,
                                span_cap=span_w)
            for s in range(mesh.size)]


@audit_check_rep(
    "table and keys are the same on every shard by all_gather before the "
    "span-masked NN; outputs (delta, parent in global slots, found) are "
    "shard-local per-row results", collectives=("all_gather",))
def _delta_stencil(mesh, be, d_cut, span_w, pts_p, rkq_p, st_p, en_p,
                   rk_p):
    """Gather-form stencil delta phase (the reference's ``_make_delta``):
    the strictly-denser NN within d_cut over my rows' spans into the
    all-gathered table and keys, parents in global sorted slots."""
    tbl = mesh.all_gather(pts_p)
    keys = mesh.all_gather(rk_p)
    return [be.denser_nn_halo(pts_p[s], rkq_p[s], tbl[s], keys[s], st_p[s],
                              en_p[s], d_cut, span_cap=span_w)
            for s in range(mesh.size)]


@audit_check_rep(
    "table and keys are the same on every shard by all_gather before the "
    "NN kernel; outputs are shard-local per-query-row (delta, parent) "
    "(the gather delta phase and the fallback)",
    collectives=("all_gather",))
def _delta_gather(mesh, be, layout, q_p, qk_p, pts_p, rk_p):
    """Denser NN of each shard's query rows over the all-gathered table and
    keys (K2, or K9 on the best-1 ring, built per shard just before its
    launch).  Globally exact."""
    tbl = mesh.all_gather(pts_p)
    keys = mesh.all_gather(rk_p)
    return [be.denser_nn(q_p[s], qk_p[s], tbl[s], keys[s], layout=layout)
            for s in range(mesh.size)]


# Shard-phase layout decisions, visible on the metrics registry: a decision
# that drops block-sparse would show as a dist_bs_degrade_total increment
# with its reason.
_M_BS_ENABLED = obs.counter(
    "dist_bs_enabled",
    "shard-phase layout decisions that kept block-sparse worklists")
_M_BS_DEGRADE = obs.counter(
    "dist_bs_degrade_total",
    "shard-phase layout decisions that degraded block-sparse to dense "
    "per-shard tiles, by reason")
_G_BS_LAYOUT = obs.gauge(
    "dist_bs_layout",
    "last shard-phase layout decision (1 = block-sparse, 0 = dense "
    "degrade), by reason")


def shard_blocksparse_layout(pl, mesh) -> str | None:
    """The layout the per-shard phases run with: ``"block-sparse"`` when
    the plan asks for it, else ``None`` (dense).

    The reference degrades its pallas shards to dense tiles because their
    worklists are built on the host and cannot be traced inside
    ``shard_map``.  The port builds every worklist on the points' device
    with nothing traced, so a block-sparse plan keeps block-sparse shard
    phases on any mesh (reason ``device-worklist-backend``); the result is
    exact either way.  Every decision on a sparse plan is counted with its
    reason (``dist_bs_enabled`` / ``dist_bs_degrade_total`` and the
    ``dist_bs_layout`` gauge)."""
    del mesh                            # the decision does not depend on it
    if not pl.grid_sort:
        return None                     # dense plan: nothing to decide
    reason = "device-worklist-backend"
    _M_BS_ENABLED.inc(reason=reason)
    _G_BS_LAYOUT.set(1.0, reason=reason)
    return "block-sparse"


def distributed_dpc(points, cfg: DistDPCConfig | None = None,
                    mesh: ShardMesh | None = None, *,
                    d_cut: float | None = None, exec_spec=None,
                    strategy: str | None = None,
                    fallback_cap_factor: float | None = None) -> DPCResult:
    """Exact DPC (Ex-DPC semantics) over a shard mesh, phase by phase.

    Two spellings, mutually exclusive: ``distributed_dpc(points, cfg,
    mesh)`` with a :class:`DistDPCConfig`, or ``distributed_dpc(points,
    mesh=mesh, d_cut=..., exec_spec=ExecSpec(...), strategy=...)``.  The
    points go to the mesh's first device (tensors and arrays alike); spans
    ``dist.grid``, ``dist.rho``, ``dist.delta`` and ``dist.fallback``.
    ``fallback_cap_factor`` is carried for the reference's signature: the
    fallback runs on the unresolved rows themselves, padded to a multiple
    of S.
    """
    if cfg is None:
        if d_cut is None:
            raise ValueError("distributed_dpc needs a DistDPCConfig or an "
                             "explicit d_cut=")
        cfg = DistDPCConfig(d_cut=d_cut, strategy=strategy or "gather",
                            fallback_cap_factor=0.05
                            if fallback_cap_factor is None
                            else fallback_cap_factor,
                            exec_spec=as_plan(exec_spec).spec
                            if exec_spec is not None else None)
    else:
        clashes = [n for n, v in (("d_cut", d_cut), ("exec_spec", exec_spec),
                                  ("strategy", strategy),
                                  ("fallback_cap_factor",
                                   fallback_cap_factor)) if v is not None]
        if clashes:
            raise ValueError(f"pass {clashes} either on the DistDPCConfig "
                             f"or as kwargs, not both")
    if not isinstance(mesh, ShardMesh):
        raise ValueError("distributed_dpc needs a ShardMesh")
    points = as_points(points, mesh.devices[0])
    pl = as_plan(cfg.resolved_exec(), points)
    be = pl.backend
    mesh = mesh.flatten(pl.data_axis)
    S = mesh.size
    n_orig = points.shape[0]

    with obs.span("dist.grid", n=n_orig) as sp:
        grid = build_grid(points, cfg.d_cut)
        sp.sync(grid.points)
    n = grid.points.shape[0]
    m = -(-n // S) * S                  # padded rows are inert
    pts_p = mesh.shard(_pad_rows(grid.points, m, PAD_COORD))

    halo = cfg.strategy == "halo"
    layout = shard_blocksparse_layout(pl, mesh)
    # the reference's decision (``repro/distributed/dpc.py:466``): the
    # stencil phases on a non-mxu_dense backend's dense gather plan
    stencil = not halo and not be.mxu_dense and layout is None
    if halo or stencil:
        starts, ends = point_span_bounds(grid)          # (n, S_spans)
        span_w = grid.span_cap
        starts, ends = _pad_rows(starts, m, 0), _pad_rows(ends, m, 0)
        st_p, en_p = mesh.shard(starts), mesh.shard(ends)
    if halo:
        lo, W, hf, hb = _window_bounds(starts, ends, S)
        with obs.span("dist.rho", n=n, shards=S, strategy=cfg.strategy,
                      window=W, hops_fwd=hf, hops_bwd=hb) as sp:
            rho_sorted = sp.sync(mesh.unshard(_rho_halo(
                mesh, be, cfg.d_cut, span_w, lo, W, hf, hb, pts_p, st_p,
                en_p))[:n])
    elif stencil:
        with obs.span("dist.rho", n=n, shards=S,
                      strategy=cfg.strategy) as sp:
            rho_sorted = sp.sync(mesh.unshard(_rho_stencil(
                mesh, be, cfg.d_cut, span_w, pts_p, st_p, en_p))[:n])
    else:
        with obs.span("dist.rho", n=n, shards=S,
                      strategy=cfg.strategy) as sp:
            rho_sorted = sp.sync(mesh.unshard(_rho_gather(
                mesh, be, cfg.d_cut, layout, pts_p))[:n])

    rho = rho_sorted[grid.inv_order]
    rho_key = with_jitter(rho)
    rk_sorted = rho_key[grid.order]
    # table keys: -inf on padded rows (never denser); query keys: +inf
    # (nothing is denser than them)
    rk_p = mesh.shard(_pad_rows(rk_sorted, m, float("-inf")))
    rkq_p = mesh.shard(_pad_rows(rk_sorted, m, float("inf")))
    with obs.span("dist.delta", n=n, shards=S) as sp:
        if halo:
            out = _delta_halo(mesh, be, cfg.d_cut, span_w, lo, W, hf, hb,
                              pts_p, rkq_p, st_p, en_p, rk_p)
            ok_s = mesh.unshard([o[2] for o in out])[:n]
        elif stencil:
            out = _delta_stencil(mesh, be, cfg.d_cut, span_w, pts_p, rkq_p,
                                 st_p, en_p, rk_p)
            ok_s = mesh.unshard([o[2] for o in out])[:n]
        else:
            out = _delta_gather(mesh, be, layout, pts_p, rkq_p, pts_p, rk_p)
            ok_s = None             # globally exact: nothing unresolved
        dlt_s = mesh.unshard([o[0] for o in out])[:n]
        par_s = mesh.unshard([o[1] for o in out])[:n]
        sp.sync((dlt_s, par_s))

    # ---- fallback for the stencil-unresolved rows (exact, the 1-alpha tail)
    unresolved = None if ok_s is None else torch.nonzero(~ok_s).flatten()
    if unresolved is not None and unresolved.numel():
        u = unresolved.numel()
        cap = max(S, -(-u // S) * S)
        q_idx = _pad_rows(unresolved, cap, 0)
        q_rk = _pad_rows(rk_sorted[unresolved], cap, float("inf"))
        with obs.span("dist.fallback", unresolved=u, shards=S) as sp:
            fb = _delta_gather(mesh, be, layout,
                               mesh.shard(grid.points[q_idx]),
                               mesh.shard(q_rk), pts_p, rk_p)
            fd = mesh.unshard([o[0] for o in fb])[:u]
            fp = mesh.unshard([o[1] for o in fb])[:u]
            dlt_s = dlt_s.clone()
            par_s = par_s.clone()
            dlt_s[unresolved] = fd
            par_s[unresolved] = fp
            sp.sync((dlt_s, par_s))

    delta = dlt_s[grid.inv_order]
    parent_sorted = par_s[grid.inv_order]
    parent = torch.where(parent_sorted >= 0,
                         grid.order[parent_sorted.clamp_min(0).long()],
                         -1).to(torch.int32)
    return DPCResult(rho=rho, rho_key=rho_key, delta=delta, parent=parent)
