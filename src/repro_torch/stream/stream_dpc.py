"""StreamDPC: incremental sliding-window density-peaks clustering, the port
of ``repro/stream/stream_dpc.py``.

``StreamDPC`` maintains Approx-DPC state over a fixed-capacity sliding
window with micro-batch ``ingest``:

* **rho** repairs incrementally (``incremental.repair_rho``): one signed
  range count over the insert/evict batch (K5) and fresh counts for the
  inserted rows (K4), instead of a full density pass.
* **delta / dependent points** re-derive from the repaired densities on
  the maintained grouping partition: rule 1 is segment ops (every
  non-maximum depends on its cell maximum), and only the cell maxima are
  re-queried, with one ``denser_nn_update`` pass (K6).  Found within d_cut
  -> rule 2; otherwise the query is the rule-3 root answer.
* **per-cell dirty tracking** (``cfg.dirty_tracking``): a cell maximum's
  answer can only change when something within 2 d_cut of it changed, so
  maxima of cells outside that halo of the batch (``dirty_near``,
  Chebyshev ceil(2 sqrt(d)) + 1 grouping cells) reuse their cached raw NN
  answer — except rule-3 roots, whose parent can be anywhere and which are
  always re-queried.  The reference pads the dirty set to a power of two to
  bound its retraces; the kernel takes its row count at run time, so only
  the real rows are launched.
* **full-rebuild fallback** when a batch overflows the measured cell
  capacities; rho survives a rebuild.
* **label continuity**: centers carry stable ids across ticks, matched by
  nearest center between consecutive windows.

Parity contract: after any sequence of batches, rho / delta / parent and
the derived labels equal a from-scratch ``run_approxdpc`` +
``assign_labels`` of ``window_points()`` (parents up to exact distance
ties, where the from-scratch fit's grid-sorted sweep may pick another
equally near parent).

In-place device state: the window table (``SlidingWindow.push``,
``initialize``) and the segment ids (``IncrementalGrid.apply``) are updated
in place, so the transactional snapshot clones both; rho is replaced each
tick, never modified, and the snapshot keeps a reference to it.

Not ported here: ``mesh=`` (the sharded repair tail, ROADMAP Queue A item
9), ``save`` / ``restore`` and the fault-injection sites (item 7).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.approxdpc import run_approxdpc
from repro_torch.core.device import resolve_device
from repro_torch.core.dpc_types import DPCResult, density_jitter
from repro_torch.core.grid import canonical_group_coords
from repro_torch.core.labels import Clustering, assign_labels
from repro_torch.engine.planner import plan
from repro_torch.engine.spec import ExecSpec
from repro_torch.kernels.sweep import PAD_COORD

from .incremental import CellOverflow, IncrementalGrid, repair_rho
from .window import SlidingWindow

_M_TICKS = obs.counter("stream_ticks", "StreamDPC ticks across all streams")
_M_FULL = obs.counter("stream_full_recomputes",
                      "full window recomputes (warm-up / bulk loads)")
_M_NN_MAXIMA = obs.counter(
    "stream_nn_maxima_total", "cell maxima seen by the incremental NN stage")
_M_NN_QUERIES = obs.counter(
    "stream_nn_queries",
    "maxima actually re-queried (dirty); maxima_total - queries = the "
    "dirty-tracking saving")


@dataclass(frozen=True)
class StreamDPCConfig:
    """Streaming DPC configuration (mirrors ``DPCConfig`` where shared).

    ``capacity`` is the sliding-window size, ``batch_cap`` the micro-batch
    size a tick takes.  Execution (kernel backend, full-tick layout) is one
    :class:`ExecSpec`; the legacy ``backend`` / ``layout`` / ``data_axis``
    spellings are not ported.
    """

    d_cut: float
    capacity: int = 4096
    batch_cap: int = 256
    rho_min: float = 10.0
    delta_min: float | None = None      # default 2 * d_cut (must be > d_cut)
    cell_slack: float = 2.0             # live-cell budget over measured count
    extent_margin: int = 4              # indexed-box margin, in cells
    continuity_radius: float | None = None  # center matching (default 2*d_cut)
    dirty_tracking: bool = True         # skip clean-cell maxima NN re-query
    transactional: bool = True          # roll a failed tick back pre-tick
    exec_spec: ExecSpec | None = None

    def __post_init__(self):
        if not self.d_cut > 0.0:
            raise ValueError(f"d_cut must be positive, got {self.d_cut!r}")
        if not 1 <= self.batch_cap <= self.capacity:
            raise ValueError("batch_cap must be in [1, capacity]")
        if self.exec_spec is None:
            object.__setattr__(self, "exec_spec", ExecSpec())
        elif not isinstance(self.exec_spec, ExecSpec):
            raise TypeError(f"exec_spec must be an ExecSpec, got "
                            f"{type(self.exec_spec).__name__}")

    def resolved_exec(self) -> ExecSpec:
        return self.exec_spec

    def resolved_delta_min(self) -> float:
        dm = 2.0 * self.d_cut if self.delta_min is None else self.delta_min
        if dm <= self.d_cut:
            raise ValueError("delta_min must exceed d_cut (Def. 5)")
        return dm

    def resolved_radius(self) -> float:
        return (2.0 * self.d_cut if self.continuity_radius is None
                else self.continuity_radius)


class StreamTick(NamedTuple):
    labels: np.ndarray        # (count,) stable cluster ids, -1 noise
    centers: np.ndarray       # (count,) bool center mask
    stable_ids: np.ndarray    # (k,) stable id of tick-local cluster 0..k-1
    num_clusters: int
    rebuilt: bool             # grid bookkeeping was rebuilt this tick
    full_recompute: bool      # warm-up path (window below capacity)
    tick: int


def _rule1(rho_key: torch.Tensor, seg_ids: torch.Tensor, num_segments: int):
    """Approx-DPC rule 1 over maintained segments: per-cell argmax of the
    all-distinct density key; every point's provisional parent is its cell
    maximum (the maximum points at itself until rules 2/3 overwrite it)."""
    n = rho_key.shape[0]
    seg = seg_ids.long()
    slot = torch.arange(n, dtype=torch.int64, device=rho_key.device)
    seg_max = torch.full((num_segments,), float("-inf"),
                         device=rho_key.device).scatter_reduce(
        0, seg, rho_key, "amax")
    is_max = rho_key == seg_max[seg]
    max_slot = torch.full((num_segments,), -1, dtype=torch.int64,
                          device=rho_key.device).scatter_reduce(
        0, seg, torch.where(is_max, slot, -1), "amax")
    return is_max, max_slot[seg]


def _assemble(parent1, q_slots, nn_delta, nn_parent, d_cut: float):
    """Merge rule 1 with the maxima NN answers: NN within d_cut -> rule 2
    (delta stamped d_cut); beyond -> rule 3, the root delta (inf at the
    global peak)."""
    n = parent1.shape[0]
    dc = torch.full_like(nn_delta, d_cut)
    found2 = torch.isfinite(nn_delta) & (nn_delta < dc)
    delta = torch.full((n,), d_cut, dtype=torch.float32,
                       device=parent1.device)
    delta[q_slots] = torch.where(found2, dc, nn_delta)
    parent = parent1.to(torch.int32)
    parent[q_slots] = nn_parent
    return delta, parent


class StreamDPC:
    """Micro-batch streaming driver over a sliding window, on one device
    (``device=None`` means the card, as for ``DPCEngine``)."""

    def __init__(self, cfg: StreamDPCConfig, mesh=None, device=None):
        if mesh is not None:
            raise NotImplementedError(
                "StreamDPC(mesh=...) shards the repair tail over devices; it "
                "is ported with the distributed slice (ROADMAP Queue A "
                "item 9)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.plan = plan(None, cfg.resolved_exec())
        self.be = self.plan.backend
        self.window: SlidingWindow | None = None
        self.grid: IncrementalGrid | None = None
        self._rho: torch.Tensor | None = None
        self._jitter = density_jitter(cfg.capacity, self.device)
        self._result: DPCResult | None = None
        self._clustering: Clustering | None = None
        self._registry: list[tuple[int, np.ndarray]] = []  # (stable_id, pos)
        self._next_stable = 0
        self._ticks = 0
        self._full_recomputes = 0
        self._last: StreamTick | None = None
        # raw (nn_delta, nn_parent) cache by slot for clean-cell maxima
        self._nn_delta_cache: np.ndarray | None = None
        self._nn_parent_cache: np.ndarray | None = None
        self._nn_valid: np.ndarray | None = None
        self._nn_maxima_total = 0
        self._nn_queries = 0

    # ------------------------------------------------------------- public
    def initialize(self, points) -> StreamTick:
        """Bulk-load up to ``capacity`` points (one full recompute)."""
        points = np.atleast_2d(np.asarray(points, np.float32))
        if len(points) > self.cfg.capacity:
            raise ValueError(
                f"initialize got {len(points)} points for a capacity-"
                f"{self.cfg.capacity} window; bulk-load at most capacity "
                f"and stream the rest through ingest()")
        self._ensure_window(points.shape[1])
        w = self.window
        w.host[: len(points)] = points
        w.device[: len(points)] = torch.from_numpy(points).to(self.device)
        w.count = len(points)
        w.cursor = w.count % self.cfg.capacity
        return self._full_tick()

    def ingest(self, batch) -> StreamTick:
        """Micro-batch ingest; batches larger than ``batch_cap`` chunk.

        Transactional (``cfg.transactional``): an exception inside a tick
        rolls window, grid and rho back to the pre-tick snapshot before it
        is re-raised, so a failed tick never leaves half-applied state.  An
        empty batch is a no-op (returns the last tick)."""
        batch = np.asarray(batch, np.float32)
        if batch.size == 0:
            return self._last
        batch = np.atleast_2d(batch)
        self._ensure_window(batch.shape[1])
        tick = self._last
        while len(batch):
            chunk, batch = batch[: self.cfg.batch_cap], \
                batch[self.cfg.batch_cap:]
            snap = None
            if self.cfg.transactional:
                with obs.span("stream.snapshot") as sp:
                    snap = self._snapshot()
                    sp.sync(snap["device"])
            try:
                if not self.window.full:
                    tick = self._warmup(chunk)
                else:
                    tick = self._steady(chunk)
            except Exception:
                if snap is not None:
                    self._rollback(snap)
                raise
        return tick

    def save(self, path: str) -> None:
        raise NotImplementedError(
            "stream checkpoints are ported with resilience (ROADMAP Queue A "
            "item 7)")

    @classmethod
    def restore(cls, path: str, mesh=None) -> "StreamDPC":
        raise NotImplementedError(
            "stream checkpoints are ported with resilience (ROADMAP Queue A "
            "item 7)")

    def window_points(self) -> np.ndarray:
        """Window contents in slot order — run_approxdpc on this array is
        the from-scratch reference the stream is held against."""
        return self.window.contents()

    def center_positions(self) -> tuple[np.ndarray, np.ndarray]:
        """(stable_ids, positions) of the current tick's cluster centers."""
        if not self._registry:
            dim = 0 if self.window is None else self.window.dim
            return np.zeros(0, np.int64), np.zeros((0, dim), np.float32)
        ids = np.array([s for s, _ in self._registry], np.int64)
        pos = np.stack([p for _, p in self._registry]).astype(np.float32)
        return ids, pos

    @property
    def result(self) -> DPCResult:
        return self._result

    @property
    def clustering(self) -> Clustering:
        return self._clustering

    def stats(self) -> dict:
        return {
            "ticks": self._ticks,
            "count": 0 if self.window is None else self.window.count,
            "capacity": self.cfg.capacity,
            "full_recomputes": self._full_recomputes,
            "rebuilds": 0 if self.grid is None else self.grid.rebuilds,
            "live_cells": 0 if self.grid is None else self.grid.live_cells,
            "maxima_cap": 0 if self.grid is None else self.grid.maxima_cap,
            "clusters": 0 if self._last is None else self._last.num_clusters,
            "nn_maxima_total": self._nn_maxima_total,
            "nn_queries": self._nn_queries,
        }

    # ------------------------------------------------------------ phases
    def _ensure_window(self, dim: int):
        if self.window is not None and dim != self.window.dim:
            raise ValueError(
                f"batch dimensionality {dim} != window dimensionality "
                f"{self.window.dim}; a stream's dimension is fixed at "
                f"first ingest")
        if self.window is None:
            self.window = SlidingWindow(self.cfg.capacity, dim, self.device)
            self.grid = IncrementalGrid(
                self.cfg.d_cut, self.cfg.capacity, dim,
                cell_slack=self.cfg.cell_slack,
                extent_margin=self.cfg.extent_margin, device=self.device)
            cap = self.cfg.capacity
            self._nn_delta_cache = np.full(cap, np.inf, np.float32)
            self._nn_parent_cache = np.full(cap, -1, np.int32)
            self._nn_valid = np.zeros(cap, bool)

    # ------------------------------------------------------- transactions
    def _snapshot(self) -> dict:
        """Pre-tick state capture.  Host arrays mutated in place (window
        mirror, NN caches) are copied, and so are the device tensors updated
        in place (the window table; the grid clones its segment ids); rho
        and the results are replaced each tick, never modified, and are
        kept by reference."""
        w = self.window
        return {
            "host": w.host.copy(), "device": w.device.clone(),
            "count": w.count, "cursor": w.cursor, "wticks": w.ticks,
            "grid": self.grid.snapshot(),
            "rho": self._rho,
            "nn_delta": self._nn_delta_cache.copy(),
            "nn_parent": self._nn_parent_cache.copy(),
            "nn_valid": self._nn_valid.copy(),
            "registry": list(self._registry),
            "next_stable": self._next_stable,
            "ticks": self._ticks,
            "full_recomputes": self._full_recomputes,
            "nn_maxima_total": self._nn_maxima_total,
            "nn_queries": self._nn_queries,
            "result": self._result,
            "clustering": self._clustering,
            "last": self._last,
        }

    def _rollback(self, snap: dict) -> None:
        w = self.window
        w.host[:] = snap["host"]
        w.device.copy_(snap["device"])
        w.count, w.cursor, w.ticks = snap["count"], snap["cursor"], \
            snap["wticks"]
        self.grid.restore(snap["grid"])
        self._rho = snap["rho"]
        self._nn_delta_cache[:] = snap["nn_delta"]
        self._nn_parent_cache[:] = snap["nn_parent"]
        self._nn_valid[:] = snap["nn_valid"]
        self._registry = list(snap["registry"])
        self._next_stable = snap["next_stable"]
        self._ticks = snap["ticks"]
        self._full_recomputes = snap["full_recomputes"]
        self._nn_maxima_total = snap["nn_maxima_total"]
        self._nn_queries = snap["nn_queries"]
        self._result = snap["result"]
        self._clustering = snap["clustering"]
        self._last = snap["last"]

    def _warmup(self, chunk: np.ndarray) -> StreamTick:
        """Below capacity: append and recompute from scratch (the density
        jitter is n-indexed, so every fill step reshuffles tie-breaks)."""
        w = self.window
        room = self.cfg.capacity - w.count
        take = chunk[:room]
        padded = np.full((self.cfg.batch_cap, w.dim), PAD_COORD, np.float32)
        padded[: len(take)] = take
        w.push(padded, len(take))
        tick = self._full_tick()
        rest = chunk[room:]
        return self._steady(rest) if len(rest) else tick

    def _full_tick(self) -> StreamTick:
        """Full recompute of the current window (warm-up / bulk load)."""
        w = self.window
        with obs.span("stream.full_tick", count=w.count) as sp:
            res = run_approxdpc(torch.from_numpy(w.contents()).to(self.device),
                                self.cfg.d_cut, exec_spec=self.plan.spec)
            sp.sync((res.rho, res.delta))
        self._full_recomputes += 1
        _M_FULL.inc()
        # the full tick stamps rule-2 deltas (not raw NN answers), so the
        # raw cache restarts empty — the next steady tick re-queries all
        self._nn_valid[:] = False
        if w.full:
            # steady state starts: rho at full window shape, and the
            # incremental bookkeeping derived from the window
            self._rho = res.rho
            self.grid.rebuild(w.host, w.count)
        return self._finish(res, rebuilt=False, full=True)

    def _steady(self, chunk: np.ndarray) -> StreamTick:
        cfg = self.cfg
        w = self.window
        r = len(chunk)
        if r == 0:
            return self._last
        B = cfg.batch_cap
        with obs.span("stream.tick", batch=r) as tick_sp:
            with obs.span("stream.push"):
                padded = np.full((B, w.dim), PAD_COORD, np.float32)
                padded[:r] = chunk
                slots, evicted, ev_valid = w.push(padded, r)
            rebuilt = False
            with obs.span("stream.grid_apply") as sp:
                try:
                    self.grid.apply(slots, padded, evicted, r)
                except CellOverflow:
                    self.grid.rebuild(w.host, w.count)
                    rebuilt = True
                sp.set(rebuilt=rebuilt)
            # rho repair: +1 per inserted, -1 per evicted neighbor (fused)
            delta_batch = np.concatenate(
                [padded, np.where(ev_valid[:, None], evicted, PAD_COORD)])
            signs = np.zeros(2 * B, np.float32)
            signs[:r] = 1.0
            signs[B:][ev_valid] = -1.0
            dev = self.device
            with obs.span("stream.rho_repair") as sp:
                self._rho = sp.sync(repair_rho(
                    self.be, cfg.d_cut, w.device, self._rho,
                    torch.from_numpy(delta_batch).to(dev),
                    torch.from_numpy(signs).to(dev),
                    torch.from_numpy(padded).to(dev), slots))
            out = self._finish(self._incremental_result(), rebuilt=rebuilt,
                               full=False)
            tick_sp.set(rebuilt=rebuilt)
        return out

    def _incremental_result(self) -> DPCResult:
        """Rules 1-3 from maintained state: segment ops for every point, one
        denser-NN pass for the *dirty* cell maxima only (clean-cell maxima
        reuse their cached raw answer — see the module docstring)."""
        cfg = self.cfg
        cap = cfg.capacity
        dev = self.device
        with obs.span("stream.maxima") as sp:
            rho_key = self._rho + self._jitter
            is_max, parent1 = _rule1(rho_key, self.grid.seg_dev, cap)
            q_t = torch.nonzero(is_max).flatten()
            q = q_t.cpu().numpy()
            if len(q) > self.grid.maxima_cap:
                raise RuntimeError("more cell maxima than the measured "
                                   "live-cell budget")
            if cfg.dirty_tracking:
                cached = self._nn_valid[q]
                # rule-3 roots (no denser point within d_cut): their parent
                # can be arbitrarily far, so any batch anywhere may flip it
                roots = ~(self._nn_delta_cache[q] < cfg.d_cut)
                rc = int(math.ceil(2.0 * math.sqrt(self.window.dim))) + 1
                near = self.grid.dirty_near(canonical_group_coords(
                    self.window.device[q_t], cfg.d_cut), rc)
                dirty = (~cached) | roots | near
            else:
                dirty = np.ones(len(q), bool)
            dq = q[dirty]
            sp.set(maxima=len(q), queries=len(dq))
        self._nn_maxima_total += len(q)
        self._nn_queries += len(dq)
        _M_NN_MAXIMA.inc(len(q))
        _M_NN_QUERIES.inc(len(dq))

        if len(dq):
            with obs.span("stream.nn_update", queries=len(dq)) as sp:
                nn_d, nn_p = sp.sync(self.be.denser_nn_update(
                    self.window.device, rho_key,
                    torch.from_numpy(dq).to(dev)))
                self._nn_delta_cache[dq] = nn_d.cpu().numpy()
                self._nn_parent_cache[dq] = nn_p.cpu().numpy()
            self._nn_valid[dq] = True

        with obs.span("stream.assemble") as sp:
            delta, parent = _assemble(
                parent1, q_t, torch.from_numpy(self._nn_delta_cache[q]).to(dev),
                torch.from_numpy(self._nn_parent_cache[q]).to(dev), cfg.d_cut)
            sp.sync((delta, parent))
        return DPCResult(rho=self._rho, rho_key=rho_key, delta=delta,
                         parent=parent)

    # ------------------------------------------------- labels + continuity
    def _finish(self, res: DPCResult, *, rebuilt: bool,
                full: bool) -> StreamTick:
        cfg = self.cfg
        cl = assign_labels(res, cfg.rho_min, cfg.resolved_delta_min())
        self._result, self._clustering = res, cl
        with obs.span("stream.continuity") as sp:
            labels = cl.labels.cpu().numpy()
            centers = cl.centers.cpu().numpy()
            c_slots = np.nonzero(centers)[0]
            stable = self._match_centers(self.window.host[c_slots])
            k = int(cl.num_clusters)
            by_label = np.full(max(k, 1), -1, np.int64)
            by_label[labels[c_slots]] = stable
            out = np.where(labels >= 0, by_label[np.maximum(labels, 0)], -1)
            self._registry = [(int(s), self.window.host[c].copy())
                              for s, c in zip(stable, c_slots)]
            sp.set(clusters=k)
        self._ticks += 1
        _M_TICKS.inc()
        self._last = StreamTick(labels=out, centers=centers,
                                stable_ids=stable, num_clusters=k,
                                rebuilt=rebuilt, full_recompute=full,
                                tick=self._ticks)
        return self._last

    def _match_centers(self, positions: np.ndarray) -> np.ndarray:
        """Greedy nearest matching of new centers to the previous tick's,
        within ``continuity_radius``; unmatched centers get fresh ids."""
        m = len(positions)
        stable = np.full(m, -1, np.int64)
        if self._registry and m:
            prev_pos = np.stack([p for _, p in self._registry])
            prev_ids = np.array([s for s, _ in self._registry])
            dist = np.sqrt(((positions[:, None, :].astype(np.float64)
                             - prev_pos[None]) ** 2).sum(-1))
            radius = self.cfg.resolved_radius()
            used_new = np.zeros(m, bool)
            used_old = np.zeros(len(prev_ids), bool)
            for flat in np.argsort(dist, axis=None):
                i, j = divmod(int(flat), len(prev_ids))
                if dist[i, j] > radius:
                    break
                if used_new[i] or used_old[j]:
                    continue
                stable[i] = prev_ids[j]
                used_new[i] = used_old[j] = True
        for i in range(m):
            if stable[i] < 0:
                stable[i] = self._next_stable
                self._next_stable += 1
        return stable
