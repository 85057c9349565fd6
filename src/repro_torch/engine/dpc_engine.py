"""DPCEngine: one facade over batch and streaming DPC, the port of
``repro/engine/dpc_engine.py``.

* ``fit(points)`` admits the input, resolves one :class:`ExecSpec` into a
  plan (memoized per input shape) and clusters through
  :func:`repro_torch.core.dpc_api.cluster`, or, when the engine holds a
  ``mesh`` (a :class:`repro_torch.launch.ShardMesh`), through the
  distributed phases of :func:`repro_torch.distributed.distributed_dpc`
  (``strategy="gather"`` or ``"halo"``; exact DPC only: ``exdpc`` and
  ``scan``).
* ``partial_fit(batch)`` — sliding-window streaming ingest through
  :class:`repro_torch.stream.StreamDPC`, sharded over the engine's
  ``mesh`` when it holds one; a ``fit`` of at most ``window_capacity``
  points seeds the window (a mesh engine's ``fit`` is exact DPC, which
  does not stream, so it seeds nothing).
* ``predict(points)`` — read-only nearest-label queries with
  ``StreamService.query``'s semantics (``HIT`` / ``MISS_FALLBACK`` /
  ``MISS``, and ``QUARANTINED`` for rows admission dropped).

Everything runs on the card unless the engine was built with
``device="cpu"``: ``device=None`` means ``"cuda"`` and raises where no GPU
is present, with a mesh too.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.device import as_points, resolve_device
from repro_torch.core.dpc_api import DPCConfig, check_algorithm, cluster
from repro_torch.core.labels import assign_labels
from repro_torch.core.labels import decision_graph as _decision_graph
from repro_torch.resilience.sanitize import AdmissionConfig, admit

from .planner import DPCPlan, as_plan
from .spec import ExecSpec

__all__ = ["DPCEngine"]

_DISTRIBUTED_OK = ("exdpc", "scan")     # distributed_dpc is exact DPC


class DPCEngine:
    """One engine, one plan: ``fit`` / ``partial_fit`` / ``predict`` /
    ``decision_graph`` over a single :class:`ExecSpec`, on one device.

    The streaming window shape is ``window_capacity`` / ``batch_cap``;
    other :class:`repro_torch.stream.StreamDPCConfig` fields ride in
    ``stream_options`` (checked when the first ``partial_fit`` builds the
    config).  ``mesh`` (a :class:`repro_torch.launch.ShardMesh` on the
    engine's device type) runs ``fit`` through the distributed phases with
    ``strategy``.  Validation is fail-fast at construction."""

    def __init__(self, d_cut: float, *, algorithm: str = "approxdpc",
                 rho_min: float = 10.0, delta_min: float | None = None,
                 eps: float = 0.8, grid_dims: int | None = None,
                 exec_spec: ExecSpec | None = None, mesh=None,
                 strategy: str = "gather",
                 window_capacity: int = 4096, batch_cap: int = 256,
                 stream_options: dict | None = None,
                 admission: AdmissionConfig | None = AdmissionConfig(),
                 device=None):
        if not d_cut > 0.0:
            raise ValueError(f"d_cut must be positive, got {d_cut!r}")
        check_algorithm(algorithm, eps)
        if delta_min is not None and delta_min <= d_cut:
            raise ValueError("delta_min must exceed d_cut (Def. 5)")
        if exec_spec is not None and not isinstance(exec_spec, ExecSpec):
            raise TypeError(f"exec_spec must be an ExecSpec, got "
                            f"{type(exec_spec).__name__}")
        if strategy not in ("gather", "halo"):
            raise ValueError(f"unknown strategy {strategy!r}; expected "
                             f"'gather' or 'halo'")
        if batch_cap > window_capacity:
            raise ValueError(f"batch_cap ({batch_cap}) cannot exceed "
                             f"window_capacity ({window_capacity})")
        if admission is not None and not isinstance(admission,
                                                    AdmissionConfig):
            raise TypeError(f"admission must be an AdmissionConfig or None, "
                            f"got {type(admission).__name__}")
        self.device = resolve_device(device)
        if mesh is not None:
            from repro_torch.launch.mesh import ShardMesh
            if not isinstance(mesh, ShardMesh):
                raise TypeError(f"mesh must be a ShardMesh, got "
                                f"{type(mesh).__name__}")
            if any(d.type != self.device.type for d in mesh.devices):
                raise ValueError(f"mesh {mesh} is not on the engine's "
                                 f"device type {self.device.type!r}")
        self.mesh = mesh
        self.strategy = strategy
        self.admission = admission
        self.d_cut = float(d_cut)
        self.algorithm = algorithm
        self.rho_min = float(rho_min)
        self.delta_min = delta_min
        self.eps = float(eps)
        self.grid_dims = grid_dims
        self.exec_spec = exec_spec if exec_spec is not None else ExecSpec()
        self.window_capacity = int(window_capacity)
        self.batch_cap = int(batch_cap)
        self.stream_options = dict(stream_options or {})
        self._plan: DPCPlan | None = None
        self._points = None             # fitted table (batch mode)
        self._result = None
        self._clustering = None
        self._stream = None             # StreamDPC (stream mode)
        self._mode: str | None = None

    # -------------------------------------------------------------- state
    @property
    def plan(self) -> DPCPlan | None:
        """The resolved plan of the most recent ``fit`` (or the stream's)."""
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
        """Current labels: cluster ids after ``fit`` (-1 for noise), the
        latest tick's *stable* ids after ``partial_fit``."""
        self._require_fitted()
        if self._mode == "stream":
            return np.asarray(self._stream._last.labels)
        return self._clustering.labels.cpu().numpy()

    @property
    def stream(self):
        """The underlying :class:`repro_torch.stream.StreamDPC` (or None)."""
        return self._stream

    def _require_fitted(self):
        if self._mode is None:
            raise ValueError("engine is unfitted: call fit() or "
                             "partial_fit() first")

    def resolved_delta_min(self) -> float:
        return 2.0 * self.d_cut if self.delta_min is None else self.delta_min

    # ---------------------------------------------------------------- fit
    def fit(self, points) -> "DPCEngine":
        """Batch (or distributed, when the engine holds a mesh) clustering
        of ``points`` on the engine's device; re-fitting a same-shaped
        input reuses the plan.  A ``fit`` replaces any streaming state: the
        next ``partial_fit`` starts a fresh window seeded from these points
        (when they fit)."""
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
            if self.mesh is not None:
                if self.algorithm not in _DISTRIBUTED_OK:
                    raise ValueError(
                        f"distributed fit implements exact DPC "
                        f"({'/'.join(_DISTRIBUTED_OK)}); algorithm="
                        f"{self.algorithm!r} is not distributed: drop the "
                        f"mesh or pick an exact algorithm")
                from repro_torch.distributed.dpc import distributed_dpc
                res = distributed_dpc(points, mesh=self.mesh,
                                      d_cut=self.d_cut,
                                      exec_spec=self._plan,
                                      strategy=self.strategy)
                cl = assign_labels(res, self.rho_min,
                                   self.resolved_delta_min())
            else:
                cl, res = cluster(points, DPCConfig(
                    d_cut=self.d_cut, rho_min=self.rho_min,
                    delta_min=self.delta_min, algorithm=self.algorithm,
                    eps=self.eps, grid_dims=self.grid_dims,
                    exec_spec=self._plan.spec))
            sp.sync((res.rho, res.delta, cl.labels))
        self._result = res
        self._clustering = cl
        self._points = points
        self._mode = "batch"
        self._stream = None     # fitted data supersedes any old window
        return self

    # -------------------------------------------------------- partial_fit
    def partial_fit(self, batch):
        """Sliding-window streaming ingest (micro-batched); returns the
        :class:`repro_torch.stream.StreamTick`.  The first call builds the
        stream driver, seeded with the batch-fitted points when ``fit`` ran
        first and they fit the window."""
        from repro_torch.stream.stream_dpc import StreamDPC, StreamDPCConfig

        if self.algorithm != "approxdpc":
            raise ValueError(
                f"partial_fit maintains Approx-DPC state (the stream parity "
                f"contract); algorithm={self.algorithm!r} does not stream")
        if self.admission is not None:
            batch = admit(batch, self.admission,
                          where="engine.partial_fit").points
        if np.asarray(batch).size == 0:
            # empty or fully quarantined batch: a no-op, never a ghost tick
            return self._stream._last if self._stream is not None else None
        with obs.span("engine.partial_fit") as sp:
            if self._stream is None:
                cfg = StreamDPCConfig(
                    d_cut=self.d_cut, capacity=self.window_capacity,
                    batch_cap=self.batch_cap, rho_min=self.rho_min,
                    delta_min=self.delta_min, exec_spec=self.exec_spec,
                    **self.stream_options)
                self._stream = StreamDPC(cfg, mesh=self.mesh,
                                         device=self.device)
                self._plan = self._stream.plan
                if self._mode == "batch" \
                        and self._points.shape[0] <= self.window_capacity:
                    self._stream.initialize(self._points.cpu().numpy())
            tick = self._stream.ingest(batch)
            sp.sync(self._stream.result.rho)
        self._result = self._stream.result
        self._clustering = self._stream.clustering
        self._mode = "stream"
        return tick

    # ------------------------------------------------------------ predict
    def predict(self, points):
        """Read-only nearest-label queries over the fitted state: a
        :class:`repro_torch.stream.QueryResult` of (labels, status) —
        ``HIT`` within d_cut of a fitted point, ``MISS_FALLBACK`` to the
        nearest center otherwise, ``MISS`` (-1) with no centers at all, and
        ``QUARANTINED`` (-1) for rows that admission dropped, in the
        caller's row order."""
        from repro_torch.stream.service import (QueryResult, QueryStatus,
                                                nearest_label_query)

        self._require_fitted()
        keep = None
        if self.admission is not None:
            admitted = admit(points, self.admission, where="engine.predict")
            points = admitted.points
            if admitted.quarantined:
                keep = admitted.keep
        with obs.span("engine.predict", mode=self._mode):
            if self._mode == "stream":
                s = self._stream
                ids, pos = s.center_positions()
                out = nearest_label_query(
                    s.be, points, self.d_cut, s.window.device,
                    s._last.labels, ids, pos)
            else:
                labels = self._clustering.labels.cpu().numpy()
                c_rows = torch.nonzero(self._clustering.centers).flatten()
                out = nearest_label_query(
                    self._plan.backend, points, self.d_cut, self._points,
                    labels, labels[c_rows.cpu().numpy()].astype(np.int64),
                    self._points[c_rows].cpu().numpy())
        if keep is not None:
            # re-expand to the caller's rows: dropped rows answer
            # (-1, QUARANTINED) instead of shifting every result
            labels = np.full(len(keep), -1, np.int64)
            status = np.full(len(keep), int(QueryStatus.QUARANTINED),
                             np.int8)
            labels[keep] = out.labels
            status[keep] = out.status
            out = QueryResult(labels=labels, status=status)
        return out

    def decision_graph(self):
        """(rho_i, delta_i) pairs of the fitted state (paper Fig. 1)."""
        return _decision_graph(self.result)
