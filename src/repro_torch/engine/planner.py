"""The planner: resolve an ExecSpec once, reuse it for every call.

The port of ``repro/engine/planner.py``.  ``plan(points_spec, exec_spec)``
resolves the execution axes a single time — the
:class:`~repro_torch.kernels.backend.KernelBackend` instance, the layout
(``grid_sort`` tells drivers to lay the points out grid-sorted, which the
block-sparse layout's pruning needs) and the precision — and memoizes
the plan on ``(PointsSpec, ExecSpec)``, so a re-fit on same-shaped input
gets the same plan object back.

The plan's two primitive wrappers hold the ``kernel.dispatch``
fault-injection site.  Not ported: the jaxpr analyzer gate
(``_plan_check``), the worklist cache and strategy (every block-sparse
call builds its worklist on the device), and ``resolve_backend``'s
``pallas -> interpret -> jnp`` degradation chain — a fallback would hide
the kernel, and a CUDA tensor reaches the kernel or the call raises.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass

from repro_torch.kernels.backend import KernelBackend, get_backend
from repro_torch.obs import metrics as _obsm
from repro_torch.resilience import faultinject

from .spec import ExecSpec

__all__ = ["PointsSpec", "DPCPlan", "plan", "as_plan", "plan_cache_info",
           "plan_cache_clear"]

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
    wrappers for the two driver-facing primitives."""

    def __init__(self, pspec: PointsSpec | None, spec: ExecSpec):
        self.spec = spec
        self.pspec = pspec
        self.backend: KernelBackend = get_backend(spec.backend)
        self.backend_name: str = self.backend.name
        self.layout: str = spec.resolved_layout
        self.grid_sort: bool = spec.sparse
        self.precision: str = spec.resolved_precision
        self.data_axis: str = spec.data_axis   # the shard mesh's axis

    def describe(self) -> str:
        shape = "" if self.pspec is None \
            else f" n={self.pspec.n} d={self.pspec.d}"
        return (f"DPCPlan[{self.backend_name}:{self.layout}:"
                f"{self.precision}{shape}]")

    __repr__ = describe

    def denser_nn(self, x, x_key, y, y_key):
        faultinject.fire("kernel.dispatch")
        return self.backend.denser_nn(x, x_key, y, y_key)

    def rho_delta(self, x, y, d_cut, *, jitter=None, y_sel_slots=None,
                  fallback_interest=None):
        """The backend's fused rho + delta in the plan's layout and
        precision."""
        faultinject.fire("kernel.dispatch")
        return self.backend.rho_delta(x, y, float(d_cut), jitter=jitter,
                                      y_sel_slots=y_sel_slots,
                                      fallback_interest=fallback_interest,
                                      layout=self.layout,
                                      precision=self.precision)


_PLANS: OrderedDict = OrderedDict()

_M_HITS = _obsm.counter("plan_cache_hits", "plan() memo hits")
_M_MISSES = _obsm.counter("plan_cache_misses", "plan() builds (memo misses)")
_M_EVICTIONS = _obsm.counter(
    "plan_cache_evictions", "plans LRU-evicted at _PLAN_CACHE_MAX")


def plan(points_spec: PointsSpec | tuple | None,
         exec_spec: ExecSpec | None = None) -> DPCPlan:
    """Resolve (points_spec, exec_spec) -> DPCPlan, memoized: the same
    inputs return the same object."""
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
    _PLANS[key] = pl
    while len(_PLANS) > _PLAN_CACHE_MAX:
        _PLANS.popitem(last=False)
        _M_EVICTIONS.inc()
    return pl


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


def plan_cache_clear() -> None:
    """Drop every cached plan and zero the cache counters."""
    _PLANS.clear()
    for m in (_M_HITS, _M_MISSES, _M_EVICTIONS):
        m._reset()
