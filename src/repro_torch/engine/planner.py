"""The planner: resolve an ExecSpec once, reuse it for every call.

The port of ``repro/engine/planner.py``.  ``plan(points_spec, exec_spec)``
resolves the execution axes a single time — the
:class:`~repro_torch.kernels.backend.KernelBackend` instance (through
``resilience.degrade.resolve_backend``, whose probe launches K4 once per
process on the card), the layout and with it the worklist strategy
(``grid_sort`` tells drivers to lay the points out grid-sorted, which the
block-sparse layout's pruning needs), the precision and the block — and
memoizes the plan on ``(PointsSpec, ExecSpec)``, so a refit on a
same-shaped input gets the same plan object back, with its caches.

Each plan owns a small LRU of the worklists its ``rho_delta`` wrapper
builds (``kernels.blocksparse.worklist_cache``), keyed by a content
fingerprint of the inputs: a refit of the same data builds no K3
worklist.  The worklists of all memoized plans together are held to
``blocksparse.WL_CACHE_MAX_BYTES`` of device memory: past it the least
recently used plans give theirs up first, and a plan evicted from the memo
frees its own.  The distributed phases and the stream call
``plan.backend`` directly and stay uncached, as in the reference.

The wrappers hold the ``kernel.dispatch`` fault-injection site.

Every memo miss runs the static analyzer's plan-time gate
(:func:`_plan_check`, ``repro_torch.analysis``) before the plan is handed
out: the plan's two primitives run once on the analyzer's 96-point
canonical input on the plan's device (the card wherever one exists),
under a launch recorder, and the launch and plan rules check what they
launched (a primitive that raises is an error finding) (row padding, int32 extents, the kernels' attributes against the
card's limits, the bf16 resolve, the ``d_cut`` spellings).  An error
finding raises :class:`~repro_torch.analysis.AnalysisError` at
``plan()``, before any data is touched; every finding is counted on
``analysis_findings_total{rule, level}``; results are memoized per
:class:`ExecSpec`.  The canonical run leaves no trace in the launch
counts, the worklist counters and caches, the fault-injection sites or the
spans; on the card it resets the peak-allocation statistic once, an open
span keeping its peak.  ``telemetry()`` carries the ``memory`` block
(``analysis.plan_memory``), built from the same run;
``telemetry(include_cost=True)`` adds the ``cost`` block, the plan's
kernels' work at its shape from ``launch/kernel_cost.py`` (the
reference's ``hlo_cost``: there is no HLO to read here).
"""
from __future__ import annotations

import contextlib
import logging
import os
from collections import OrderedDict
from dataclasses import dataclass

from repro_torch.kernels import blocksparse
from repro_torch.kernels.backend import KernelBackend, get_backend
from repro_torch.obs import metrics as _obsm
from repro_torch.resilience import faultinject
from repro_torch.resilience.degrade import resolve_backend

from .spec import ExecSpec

__all__ = ["PointsSpec", "DPCPlan", "plan", "as_plan", "plan_cache_info",
           "plan_cache_clear", "plan_cache_bytes"]

_PLAN_CACHE_MAX = 64


@dataclass(frozen=True)
class PointsSpec:
    """Static shape of a point table."""

    n: int
    d: int

    @classmethod
    def of(cls, points) -> "PointsSpec":
        return cls(n=int(points.shape[0]), d=int(points.shape[1]))


class DPCPlan:
    """A resolved execution plan: backend + layout + precision, with
    wrappers for the two driver-facing primitives that inject them (and the
    plan's worklist cache) into every call.

    ``worklist_strategy``: ``"dense"`` (no worklists), ``"ring"`` (the
    ``torch`` backend's block-sparse ring walk, which builds no worklist)
    or ``"device"`` (the ``cuda`` backend's worklists, built on the
    points' device and cached per plan) — the counterparts of the
    reference's ``dense``, ``traced`` and ``host``.
    """

    def __init__(self, pspec: PointsSpec | None, spec: ExecSpec):
        self.spec = spec
        self.pspec = pspec
        self.precision: str = spec.resolved_precision
        self.backend: KernelBackend = get_backend(
            resolve_backend(spec.backend))
        self.backend_name: str = self.backend.name
        self.layout: str = spec.resolved_layout
        self.grid_sort: bool = spec.sparse
        if self.precision == "bf16" and not self.backend.mxu_dense:
            raise ValueError(
                f"precision='bf16' needs the cuda backend; resolved backend "
                f"is {self.backend_name!r} (the f32 reference)")
        self.data_axis: str = spec.data_axis   # the shard mesh's axis
        # the stencil route's row chunk (None: each algorithm's default)
        self.block: int | None = spec.block
        if not spec.sparse:
            self.worklist_strategy = "dense"
        elif self.backend.builds_worklists:
            self.worklist_strategy = "device"
        else:
            self.worklist_strategy = "ring"
        self._wl: OrderedDict = OrderedDict()   # the worklist LRU
        self._scratch = False       # inside scratch_worklists()
        self._memory: dict | None = None
        self._cost: dict | None = None     # the kernel_cost estimate
        self._canonical = None      # the analyzer's canonical run

    # ------------------------------------------------------- introspection
    def describe(self) -> str:
        shape = "" if self.pspec is None \
            else f" n={self.pspec.n} d={self.pspec.d}"
        return (f"DPCPlan[{self.backend_name}:{self.layout}:"
                f"{self.precision}{shape}]")

    __repr__ = describe

    def worklist_cache_info(self) -> dict:
        return {"entries": len(self._wl),
                "max": blocksparse.WL_CACHE_MAX_ENTRIES,
                "bytes": self.worklist_bytes(),
                "max_bytes": blocksparse.WL_CACHE_MAX_BYTES}

    def worklist_bytes(self) -> int:
        """Device bytes of the worklists this plan's cache holds."""
        return sum(w.nbytes for w in self._wl.values())

    def telemetry(self, include_cost: bool = False) -> dict:
        """What this plan resolved to: its static axes, the row tile its
        sweep pads to (``pad``) and its live worklist cache
        (``worklists``: kept and total tile pairs, the pruned fraction and
        the bytes of each cached worklist), and the ``memory`` block of the
        analyzer (``analysis.plan_memory``: each kernel the plan's
        canonical run launched, with its registers, shared memory, spills
        and occupancy against the card's limits; computed once per
        plan).  ``include_cost=True`` adds ``cost`` (``_cost_estimate``),
        computed once per plan and cached."""
        t = {
            "backend": self.backend_name,
            "layout": self.layout,
            "precision": self.precision,
            "block": self.block,
            "worklist_strategy": self.worklist_strategy,
            "grid_sort": self.grid_sort,
            "data_axis": self.data_axis,
            "shape": None if self.pspec is None
            else {"n": self.pspec.n, "d": self.pspec.d},
            "pad": self._pad_telemetry(),
            "worklists": self._worklist_telemetry(),
            "memory": self._memory_estimate(),
        }
        if include_cost:
            t["cost"] = self._cost_estimate()
        return t

    def _pad_telemetry(self) -> dict | None:
        """The block-sparse sweeps pad x to whole row tiles: the cuda
        backend's worklists to ``blocksparse.BLOCK_N`` rows, the ring walk
        to ``BS_BLOCK_N``; the dense kernels and plain versions mask their
        ragged rows, so nothing pads (a row tile of 1)."""
        if self.pspec is None:
            return None
        n = self.pspec.n
        row_block = {"device": blocksparse.BLOCK_N,
                     "ring": blocksparse.BS_BLOCK_N,
                     "dense": 1}[self.worklist_strategy]
        padded = -(-n // row_block) * row_block
        return {"row_block": row_block, "n": n, "padded_n": padded,
                "pad_waste_frac": round(1.0 - n / padded, 6) if padded
                else 0.0}

    def _worklist_telemetry(self) -> dict:
        out: dict = {"strategy": self.worklist_strategy,
                     "cache_entries": len(self._wl),
                     "cache_max": blocksparse.WL_CACHE_MAX_ENTRIES,
                     "cache_bytes": self.worklist_bytes()}
        if self._wl:
            out["cached"] = [
                {"n_kept": w.n_kept, "n_total": w.n_total,
                 "pruned_frac": round(w.pruned_frac, 6), "bytes": w.nbytes}
                for w in self._wl.values()]
        return out

    def _memory_estimate(self) -> dict:
        if self._memory is None:
            from repro_torch.analysis import plan_memory

            self._memory = plan_memory(self)
        return self._memory

    def _cost_estimate(self) -> dict:
        """The work of the plan's fused sweep over n x n and of its
        nearest-denser search at its worst case, every row unresolved, at
        the plan's (n, d), each with its bytes, operations and bound on
        the published H100 rates (``launch/kernel_cost.py``).  The sweep
        is K1 (K12 in bf16) on a dense plan and K3 (K13) on a block-sparse
        one, the search K2 on a dense plan and K9 on a block-sparse one,
        in their ungated forms (a caller gates, not the plan).  A
        block-sparse plan's worklists are built from the data, so at plan
        time only their bound is known: every tile pair kept, formulation
        ``"dense-upper-bound"`` (``"dense"`` otherwise).  Nothing is
        launched and no worklist is built.

        A ``torch`` plan launches no kernel: it runs the reference's
        ``jnp`` math in plain PyTorch, the stencil route on a dense plan
        and the ring walk on a block-sparse one.  Its block names that
        route, holds no kernel and no bound, and says why in ``note``."""
        if self._cost is not None:
            return self._cost
        if self.pspec is None:
            return {"error": "plan has no bound shape"}
        from repro_torch.launch import kernel_cost as kc

        n, d = self.pspec.n, self.pspec.d
        if self.backend_name == "torch":
            self._cost = {
                "formulation": "dense-upper-bound" if self.grid_sort
                else "dense",
                "n": n, "d": d,
                "route": "ring" if self.grid_sort else "stencil",
                "kernels": {},
                "note": "the torch backend runs plain PyTorch math and "
                        "launches no CUDA kernel; no bound is given for it"}
            return self._cost
        bf16 = self.precision == "bf16"
        if self.grid_sort:
            row_tiles = -(-n // blocksparse.BLOCK_N)
            entries = row_tiles * -(-n // blocksparse.BLOCK_M)
            sweep = ("worklist_count_topk" + "_bf16" * bf16,
                     kc.bf16_work(n, n, d, entries=entries,
                                  row_tiles=row_tiles) if bf16
                     else kc.k3_work(n, n, d, entries, row_tiles))
            nn = ("worklist_masked_nn",
                  kc.k9_work(n, n, d, entries, row_tiles))
        else:
            sweep = ("fused_count_topk" + "_bf16" * bf16,
                     kc.bf16_work(n, n, d) if bf16 else kc.k1_work(n, n, d))
            nn = ("masked_nn", kc.k2_work(n, n, d))
        kernels = {}
        for name, w in (sweep, nn):
            b_ms, by = kc.bound_ms(w)
            kernels[name] = {"kernel": kc.KERNELS[name][0], "bytes": w.bytes,
                             "ops": w.ops, "tc_ops": w.tc_ops,
                             "bound_ms": b_ms, "bound_by": by,
                             "exact": w.exact}
        total = sweep[1] + nn[1]
        self._cost = {
            "formulation": "dense-upper-bound" if self.grid_sort
            else "dense",
            "n": n, "d": d, "kernels": kernels, "bytes": total.bytes,
            "ops": total.ops, "tc_ops": total.tc_ops,
            "bound_ms": sum(k["bound_ms"] for k in kernels.values()),
            "rates": "H100 SXM published peaks (kernel_cost.H100)"}
        return self._cost

    # ------------------------------------------------------ value helpers
    @contextlib.contextmanager
    def scratch_worklists(self):
        """The plan's wrappers on a throwaway worklist cache for the block
        (the analyzer's canonical run): this plan's cache and every other
        plan's are left as they were."""
        saved, self._wl, self._scratch = self._wl, OrderedDict(), True
        try:
            yield
        finally:
            self._wl, self._scratch = saved, False

    def _ctx(self):
        """Activate this plan's worklist cache for the wrapped call."""
        if self.worklist_strategy == "device":
            return blocksparse.worklist_cache(self._wl)
        return contextlib.nullcontext()

    # -------------------------------------------------- primitive wrappers
    # The two driver-facing primitives with the plan's layout and precision
    # injected.  ``denser_nn`` builds only the best-1 ring, which is never
    # cached (``blocksparse.build_flat_worklist``).

    def denser_nn(self, x, x_key, y, y_key):
        faultinject.fire("kernel.dispatch")
        return self.backend.denser_nn(x, x_key, y, y_key, layout=self.layout)

    def rho_delta(self, x, y, d_cut, *, jitter=None, y_sel_slots=None,
                  fallback_interest=None):
        """The backend's fused rho + delta in the plan's layout and
        precision."""
        faultinject.fire("kernel.dispatch")
        with self._ctx():
            out = self.backend.rho_delta(
                x, y, float(d_cut), jitter=jitter, y_sel_slots=y_sel_slots,
                fallback_interest=fallback_interest, layout=self.layout,
                precision=self.precision)
        if self._wl and not self._scratch:
            _trim_plans(self)
        return out


_PLANS: OrderedDict = OrderedDict()

_M_HITS = _obsm.counter("plan_cache_hits", "plan() memo hits")
_M_MISSES = _obsm.counter("plan_cache_misses", "plan() builds (memo misses)")
_M_EVICTIONS = _obsm.counter(
    "plan_cache_evictions", "plans LRU-evicted at _PLAN_CACHE_MAX")

# plan-time static analysis results, memoized per ExecSpec (the canonical
# run depends only on the spec's resolved axes, not the point shape)
_ANALYZED: dict = {}

# every plan-time finding lands here, bypassed or not — the escape hatch
# silences the raise, never the telemetry
_M_FINDINGS = _obsm.counter(
    "analysis_findings_total",
    "plan-time static-analyzer findings, labeled by rule and level")

_BYPASS_WARNED = False


def _plan_check(pl: DPCPlan) -> None:
    """Run the static analyzer (``repro_torch.analysis``) over the plan's
    canonical run and the plan itself, once per spec; raise on
    error-severity findings so a spec that dispatches into a flagged
    kernel path fails at ``plan()``, before any data is touched.

    ``REPRO_ANALYSIS=0`` (also ``off``/``no``) is the debugging escape
    hatch: findings are still computed and recorded on the
    ``analysis_findings_total`` counter, and the first bypassed error
    logs one warning — the raise is suppressed, the evidence is not.  The
    value ``suspend`` (set by the analyzer's own sweep, which builds plans
    *in order to* analyze them) skips entirely."""
    global _BYPASS_WARNED

    mode = os.environ.get("REPRO_ANALYSIS", "1").lower()
    if mode == "suspend":
        return
    res = _ANALYZED.get(pl.spec)
    if res is None:
        from repro_torch import analysis

        res = tuple(analysis.analyze_plan(pl))
        _ANALYZED[pl.spec] = res
        for f in res:
            _M_FINDINGS.inc(rule=f.rule, level=f.severity)
    errors = [f for f in res if f.severity == "error"]
    if not errors:
        return
    if mode in ("0", "off", "no"):
        if not _BYPASS_WARNED:
            logging.getLogger("repro_torch.analysis").warning(
                "REPRO_ANALYSIS=%s: bypassing %d error finding(s) for %s "
                "(recorded on analysis_findings_total; this warning is "
                "logged once per process)", mode, len(errors),
                pl.describe())
            _BYPASS_WARNED = True
        return
    from repro_torch.analysis import AnalysisError

    raise AnalysisError(errors)


def plan(points_spec: PointsSpec | tuple | None,
         exec_spec: ExecSpec | None = None) -> DPCPlan:
    """Resolve (points_spec, exec_spec) -> DPCPlan, memoized: the same
    inputs return the same object.  A miss runs the analyzer's gate
    (:func:`_plan_check`) before the plan is memoized."""
    if isinstance(points_spec, tuple):
        points_spec = PointsSpec(*points_spec)
    spec = exec_spec if exec_spec is not None else ExecSpec()
    key = (points_spec, spec)
    hit = _PLANS.get(key)
    if hit is not None:
        _M_HITS.inc()
        _PLANS.move_to_end(key)
        return hit
    _M_MISSES.inc()
    pl = DPCPlan(points_spec, spec)
    _plan_check(pl)
    _PLANS[key] = pl
    while len(_PLANS) > _PLAN_CACHE_MAX:
        _PLANS.popitem(last=False)[1]._wl.clear()
        _M_EVICTIONS.inc()
    return pl


def _trim_plans(keep: DPCPlan) -> None:
    """Hold the worklists of all memoized plans to
    ``blocksparse.WL_CACHE_MAX_BYTES``: the least recently planned give
    theirs up first; ``keep`` (the plan that just built one) keeps its
    own."""
    total = plan_cache_bytes()
    for pl in list(_PLANS.values()):
        if total <= blocksparse.WL_CACHE_MAX_BYTES:
            break
        if pl is not keep:
            total -= pl.worklist_bytes()
            pl._wl.clear()


def as_plan(exec_spec, points=None) -> DPCPlan:
    """Coerce a driver's ``exec_spec`` argument (ExecSpec | DPCPlan | None)
    into a plan for ``points``."""
    pspec = None if points is None else PointsSpec.of(points)
    if isinstance(exec_spec, DPCPlan):
        if pspec is None or exec_spec.pspec == pspec:
            return exec_spec
        return plan(pspec, exec_spec.spec)
    if exec_spec is not None and not isinstance(exec_spec, ExecSpec):
        raise TypeError(f"exec_spec must be an ExecSpec, DPCPlan or None, "
                        f"got {type(exec_spec).__name__}")
    return plan(pspec, exec_spec)


def plan_cache_info() -> dict:
    return {"hits": int(_M_HITS.value()), "misses": int(_M_MISSES.value()),
            "evictions": int(_M_EVICTIONS.value()), "entries": len(_PLANS)}


def plan_cache_bytes() -> int:
    """Device bytes of the worklists all memoized plans hold."""
    return sum(pl.worklist_bytes() for pl in _PLANS.values())


def plan_cache_clear() -> None:
    """Drop every cached plan, and the worklists each holds, and zero the
    cache counters."""
    for pl in _PLANS.values():
        pl._wl.clear()
    _PLANS.clear()
    for m in (_M_HITS, _M_MISSES, _M_EVICTIONS):
        m._reset()
