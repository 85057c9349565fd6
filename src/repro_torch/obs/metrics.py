"""The metrics registry: named counters, gauges and histograms with labels,
the port of ``repro/obs/metrics.py``.

One process-global registry that the port's drivers write: the planner's
plan-cache traffic, the worklist builds, cache hits and fingerprint misses,
the stream's tick counters, quarantined points, injected faults and backend
degradations.  The old read surfaces (``plan_cache_info()``,
``worklist_build_count()``, ``StreamDPC.stats()``) are thin shims over
these metrics.

Metrics are plain host-side Python, written from driver code, never from
device code, so they add no device work.  All mutation happens under one
lock; values are numbers (counters, gauges) or ``{count, sum, min, max}``
stat dicts (histograms), keyed by a canonical rendering of the label set.
"""
from __future__ import annotations

import threading
from typing import Any, TypeVar, cast

__all__ = ["Metric", "Counter", "Gauge", "Histogram", "counter", "gauge",
           "histogram", "get_metric", "snapshot", "reset"]

_LOCK = threading.RLock()
_REGISTRY: dict[str, "Metric"] = {}


def _label_key(labels: dict) -> str:
    """Canonical label rendering: ``''`` for no labels, else ``k=v,...``
    sorted by key — the snapshot identity of a metric series."""
    return ",".join(f"{k}={v}" for k, v in sorted(labels.items()))


class Metric:
    """Base: a named family of label-keyed series."""

    kind = "metric"

    def __init__(self, name: str, help: str = "") -> None:
        self.name = name
        self.help = help
        self._vals: dict[str, Any] = {}

    # the full series state, snapshotted and restored atomically by
    # ``blocksparse.suspend_counters``
    def _state(self) -> dict:
        with _LOCK:
            return {k: (dict(v) if isinstance(v, dict) else v)
                    for k, v in self._vals.items()}

    def _restore(self, state: dict) -> None:
        with _LOCK:
            self._vals = {k: (dict(v) if isinstance(v, dict) else v)
                          for k, v in state.items()}

    def _reset(self) -> None:
        with _LOCK:
            self._vals.clear()

    def series(self) -> dict:
        """``{label_key: value}`` copy of every series in this family."""
        return self._state()


class Counter(Metric):
    """Monotonic counter per label set."""

    kind = "counter"

    def inc(self, v: float = 1, **labels: Any) -> None:
        k = _label_key(labels)
        with _LOCK:
            self._vals[k] = self._vals.get(k, 0) + v

    def value(self, **labels: Any) -> Any:
        return self._vals.get(_label_key(labels), 0)

    def total(self) -> Any:
        """Sum over every label set (the unlabeled view of the family)."""
        with _LOCK:
            return sum(self._vals.values())


class Gauge(Metric):
    """Last value set, per label set."""

    kind = "gauge"

    def set(self, v: float, **labels: Any) -> None:
        with _LOCK:
            self._vals[_label_key(labels)] = v

    def value(self, default: Any = None, **labels: Any) -> Any:
        return self._vals.get(_label_key(labels), default)


class Histogram(Metric):
    """Streaming summary stats (count / sum / min / max) per label set."""

    kind = "histogram"

    def observe(self, v: float, **labels: Any) -> None:
        k = _label_key(labels)
        with _LOCK:
            s = self._vals.get(k)
            if s is None:
                self._vals[k] = {"count": 1, "sum": v, "min": v, "max": v}
            else:
                s["count"] += 1
                s["sum"] += v
                s["min"] = min(s["min"], v)
                s["max"] = max(s["max"], v)

    def stats(self, **labels: Any) -> dict | None:
        s = self._vals.get(_label_key(labels))
        return dict(s) if s is not None else None


_M = TypeVar("_M", bound=Metric)


def _register(cls: type[_M], name: str, help: str) -> _M:
    with _LOCK:
        m = _REGISTRY.get(name)
        if m is None:
            m = cls(name, help)
            _REGISTRY[name] = m
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{m.kind}, not {cls.kind}")
        elif help and not m.help:
            m.help = help
        return cast(_M, m)


def counter(name: str, help: str = "") -> Counter:
    """Get-or-register the counter family ``name``."""
    return _register(Counter, name, help)


def gauge(name: str, help: str = "") -> Gauge:
    """Get-or-register the gauge family ``name``."""
    return _register(Gauge, name, help)


def histogram(name: str, help: str = "") -> Histogram:
    """Get-or-register the histogram family ``name``."""
    return _register(Histogram, name, help)


def get_metric(name: str) -> Metric | None:
    return _REGISTRY.get(name)


def snapshot() -> dict:
    """Machine-readable registry state: ``{name: {kind, help, values}}``,
    ``values`` mapping canonical label keys (``''`` unlabeled) to numbers
    or histogram stat dicts.  What the report CLI renders."""
    with _LOCK:
        return {name: {"kind": m.kind, "help": m.help, "values": m.series()}
                for name, m in sorted(_REGISTRY.items())}


def reset() -> None:
    """Zero every registered series (registrations survive)."""
    with _LOCK:
        for m in _REGISTRY.values():
            m._reset()
