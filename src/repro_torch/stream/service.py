"""Streaming clustering endpoint: the port of ``repro/stream/service.py``.

* ``submit`` buffers arriving points (after admission control) and fires a
  ``StreamDPC.ingest`` tick for every full micro-batch.
* ``flush`` drains the partial remainder as one tick.
* ``query`` labels arbitrary points without mutating the window, as a
  :class:`QueryResult` of (labels, status) per point: a point whose nearest
  window point lies within d_cut takes that point's stable cluster id
  (``HIT``); other points fall back to the nearest current cluster center
  (``MISS_FALLBACK``), or -1 / ``MISS`` when there is none; non-finite
  points are ``QUARANTINED``.  The window NN runs through the backend's
  ``denser_nn`` (K2) with a -inf query key: every window row is "denser",
  so the masked NN is a plain NN on the write path's kernel.

The reference pads each query batch to a multiple of the micro-batch so
that its jitted programs keep one shape; the kernel takes any row count,
so the port launches the real rows only.  The fault-injection site waits
for the resilience slice (ROADMAP Queue A item 7).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.kernels.sweep import PAD_COORD
from repro_torch.resilience.sanitize import AdmissionConfig, admit

from .stream_dpc import StreamDPC, StreamDPCConfig, StreamTick

_M_QUERY_POINTS = obs.counter(
    "serve_query_points", "nearest-label query points, labeled by status")
_M_QUERY_CALLS = obs.counter(
    "serve_query_calls", "nearest_label_query invocations")


class QueryStatus(enum.IntEnum):
    """Per-point provenance of a query answer."""

    HIT = 0            # nearest window point within d_cut; its stable label
    MISS_FALLBACK = 1  # out of coverage; nearest current center's stable id
    MISS = 2           # out of coverage and no centers exist; label is -1
    QUARANTINED = 3    # point failed admission (NaN/Inf/dropped); label -1


class QueryResult(NamedTuple):
    labels: np.ndarray   # (m,) int64 stable cluster ids (-1 = noise / MISS)
    status: np.ndarray   # (m,) int8 QueryStatus values


def nearest_label_query(backend, points, d_cut: float, ref_table,
                        ref_labels, center_ids, center_pos) -> QueryResult:
    """The read-only label query shared by ``StreamService.query`` and
    ``DPCEngine.predict``.

    ``ref_table``: (N, d) labeled reference points on the device (rows past
    the labels hold ``PAD_COORD`` and never match).  ``ref_labels``: labels
    aligned to the table's first rows (-1 = noise).  ``center_ids`` /
    ``center_pos``: the current cluster centers for the miss fallback.
    """
    points = np.atleast_2d(np.asarray(points, np.float32))
    m = len(points)
    if m == 0 or points.shape[1] == 0:
        return QueryResult(labels=np.zeros(0, np.int64),
                           status=np.zeros(0, np.int8))
    with obs.span("serve.query", m=m) as sp:
        # non-finite query rows would poison the kernel distances and the
        # fallback argmin: quarantine them (label -1) instead of guessing
        finite = np.isfinite(points).all(axis=1)
        q = np.where(finite[:, None], points, PAD_COORD).astype(np.float32)
        dev = ref_table.device
        qk = torch.full((m,), float("-inf"), device=dev)   # plain NN
        wkey = torch.zeros((ref_table.shape[0],), device=dev)
        dist, parent = sp.sync(backend.denser_nn(
            torch.from_numpy(q).to(dev), qk, ref_table, wkey))
        dist = dist.cpu().numpy()
        parent = parent.cpu().numpy()
        ref_labels = np.asarray(ref_labels)
        labels = np.full(m, -1, np.int64)
        status = np.full(m, int(QueryStatus.MISS), np.int8)
        ok = (np.isfinite(dist) & (dist < d_cut)
              & (parent >= 0) & (parent < len(ref_labels)) & finite)
        labels[ok] = ref_labels[parent[ok]]
        status[ok] = int(QueryStatus.HIT)
        miss = ~ok & finite
        if miss.any() and len(center_ids):
            d2 = ((points[miss][:, None, :].astype(np.float64)
                   - np.asarray(center_pos)[None]) ** 2).sum(-1)
            labels[miss] = np.asarray(center_ids)[np.argmin(d2, axis=1)]
            status[miss] = int(QueryStatus.MISS_FALLBACK)
        status[~finite] = int(QueryStatus.QUARANTINED)
        _M_QUERY_CALLS.inc()
        for st in QueryStatus:
            cnt = int((status == int(st)).sum())
            if cnt:
                _M_QUERY_POINTS.inc(cnt, status=st.name)
    return QueryResult(labels=labels, status=status)


@dataclass(frozen=True)
class StreamServeConfig:
    """Endpoint config: ``stream`` is the clustering config; ``micro_batch``
    (0 -> the stream's ``batch_cap``) is the request-accumulation size."""

    stream: StreamDPCConfig
    micro_batch: int = field(default=0)
    # write-path admission control (resilience.sanitize); None disables
    admission: AdmissionConfig | None = AdmissionConfig()

    def resolved_micro_batch(self) -> int:
        return self.micro_batch or self.stream.batch_cap


class StreamService:
    def __init__(self, cfg: StreamServeConfig, mesh=None, device=None):
        self.cfg = cfg
        self.engine = StreamDPC(cfg.stream, mesh=mesh, device=device)
        self._buffer: list[np.ndarray] = []
        self._buffered = 0
        self._submitted = 0

    # ------------------------------------------------------------- writes
    def submit(self, points) -> list[StreamTick]:
        """Buffer points; run one ingest tick per full micro-batch.

        Points pass admission control first (``cfg.admission``).  An empty
        or fully quarantined submit is a no-op."""
        if self.cfg.admission is not None:
            points = admit(points, self.cfg.admission,
                           where="service.submit").points
        else:
            points = np.atleast_2d(np.asarray(points, np.float32))
        if points.size == 0:
            return []
        self._buffer.append(points)
        self._buffered += len(points)
        self._submitted += len(points)
        B = self.cfg.resolved_micro_batch()
        if self._buffered < B:
            return []
        # one concatenation per submit, then slice out full micro-batches
        with obs.span("serve.submit", buffered=self._buffered):
            flat = np.concatenate(self._buffer)
            ticks = [self.engine.ingest(flat[i: i + B])
                     for i in range(0, len(flat) - B + 1, B)]
            rest = flat[len(ticks) * B:]
            self._buffer = [rest] if len(rest) else []
            self._buffered = len(rest)
        return ticks

    def flush(self) -> StreamTick | None:
        """Ingest the partial remainder."""
        if self._buffered == 0:
            return None
        with obs.span("serve.flush", buffered=self._buffered):
            flat = np.concatenate(self._buffer)
            self._buffer, self._buffered = [], 0
            return self.engine.ingest(flat)

    # ------------------------------------------------------------ queries
    def query(self, points) -> QueryResult:
        """(labels, status) per query point (read-only)."""
        last = self.engine._last
        if last is None:
            raise RuntimeError("query before any ingest tick")
        ids, pos = self.engine.center_positions()
        return nearest_label_query(
            self.engine.be, points, self.cfg.stream.d_cut,
            self.engine.window.device, last.labels, ids, pos)

    def stats(self) -> dict:
        return {**self.engine.stats(), "buffered": self._buffered,
                "submitted": self._submitted}
