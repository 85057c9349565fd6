"""DPCEngine: the batch ``fit`` facade, the port of
``repro/engine/dpc_engine.py``.

``fit(points)`` admits the input, resolves one :class:`ExecSpec` into a
plan (memoized per input shape) and clusters through
:func:`repro_torch.core.dpc_api.cluster`.  It runs on the card unless the
engine was built with ``device="cpu"``: ``device=None`` means ``"cuda"``
and raises where no GPU is present.  ``partial_fit`` and ``predict`` come
with the stream slice; the distributed ``mesh`` with the distributed slice.
"""
from __future__ import annotations

import numpy as np
from repro_torch import obs
from repro_torch.core.device import as_points, resolve_device
from repro_torch.core.dpc_api import DPCConfig, check_algorithm, cluster
from repro_torch.core.labels import decision_graph as _decision_graph
from repro_torch.resilience.sanitize import AdmissionConfig, admit

from .planner import DPCPlan, as_plan
from .spec import ExecSpec

__all__ = ["DPCEngine"]


class DPCEngine:
    """One engine, one plan: ``fit`` / ``decision_graph`` over a single
    :class:`ExecSpec`, on one device.  Validation is fail-fast at
    construction."""

    def __init__(self, d_cut: float, *, algorithm: str = "approxdpc",
                 rho_min: float = 10.0, delta_min: float | None = None,
                 eps: float = 0.8, grid_dims: int | None = None,
                 exec_spec: ExecSpec | None = None,
                 admission: AdmissionConfig | None = AdmissionConfig(),
                 device=None):
        if not d_cut > 0.0:
            raise ValueError(f"d_cut must be positive, got {d_cut!r}")
        check_algorithm(algorithm)
        if delta_min is not None and delta_min <= d_cut:
            raise ValueError("delta_min must exceed d_cut (Def. 5)")
        if exec_spec is not None and not isinstance(exec_spec, ExecSpec):
            raise TypeError(f"exec_spec must be an ExecSpec, got "
                            f"{type(exec_spec).__name__}")
        if admission is not None and not isinstance(admission,
                                                    AdmissionConfig):
            raise TypeError(f"admission must be an AdmissionConfig or None, "
                            f"got {type(admission).__name__}")
        self.device = resolve_device(device)
        self.admission = admission
        self.d_cut = float(d_cut)
        self.algorithm = algorithm
        self.rho_min = float(rho_min)
        self.delta_min = delta_min
        self.eps = float(eps)
        self.grid_dims = grid_dims
        self.exec_spec = exec_spec if exec_spec is not None else ExecSpec()
        self._plan: DPCPlan | None = None
        self._result = None
        self._clustering = None

    # -------------------------------------------------------------- state
    @property
    def plan(self) -> DPCPlan | None:
        """The resolved plan of the most recent ``fit``."""
        return self._plan

    @property
    def result(self):
        """The current :class:`~repro_torch.core.dpc_types.DPCResult`."""
        self._require_fitted()
        return self._result

    @property
    def clustering(self):
        self._require_fitted()
        return self._clustering

    @property
    def labels_(self) -> np.ndarray:
        """Cluster ids of the fitted points (-1 for noise)."""
        self._require_fitted()
        return self._clustering.labels.cpu().numpy()

    def _require_fitted(self):
        if self._result is None:
            raise ValueError("engine is unfitted: call fit() first")

    # ---------------------------------------------------------------- fit
    def fit(self, points) -> "DPCEngine":
        """Batch clustering of ``points`` on the engine's device; re-fitting
        a same-shaped input reuses the plan."""
        if self.admission is not None:
            admitted = admit(points, self.admission, where="engine.fit")
            if admitted.points.size == 0:
                raise ValueError(
                    "fit: no points survived admission control "
                    f"({admitted.quarantined} quarantined)")
            points = admitted.points
        points = as_points(points, self.device)
        self._plan = as_plan(self.exec_spec, points)
        with obs.span("engine.fit", n=int(points.shape[0]),
                      algorithm=self.algorithm,
                      plan=self._plan.describe()) as sp:
            cl, res = cluster(points, DPCConfig(
                d_cut=self.d_cut, rho_min=self.rho_min,
                delta_min=self.delta_min, algorithm=self.algorithm,
                eps=self.eps, grid_dims=self.grid_dims,
                exec_spec=self._plan.spec))
            sp.sync((res.rho, res.delta, cl.labels))
        self._result = res
        self._clustering = cl
        return self

    def partial_fit(self, batch):
        raise NotImplementedError(
            "partial_fit (sliding-window streaming) is ported with the "
            "stream slice: ROADMAP Queue A item 6")

    def predict(self, points):
        raise NotImplementedError(
            "predict (nearest-label queries) is ported with the stream "
            "slice: ROADMAP Queue A item 6")

    def decision_graph(self):
        """(rho_i, delta_i) pairs of the fitted state (paper Fig. 1)."""
        return _decision_graph(self.result)
