"""Named counters and gauges with labels: the part of
``repro/obs/metrics.py`` that the ported drivers write (plan-cache
traffic, quarantined points, worklist builds and sizes).

They are plain host-side Python, written from driver code, never from
device code.
"""
from __future__ import annotations

import threading
from typing import Any

__all__ = ["Counter", "Gauge", "counter", "gauge", "reset"]

_LOCK = threading.RLock()
_REGISTRY: dict[str, "Counter"] = {}


def _label_key(labels: dict) -> str:
    """``''`` for no labels, else ``k=v,...`` sorted by key."""
    return ",".join(f"{k}={v}" for k, v in sorted(labels.items()))


class Counter:
    """Monotonic counter per label set."""

    def __init__(self, name: str, help: str = "") -> None:
        self.name = name
        self.help = help
        self._vals: dict[str, Any] = {}

    def inc(self, v: float = 1, **labels: Any) -> None:
        k = _label_key(labels)
        with _LOCK:
            self._vals[k] = self._vals.get(k, 0) + v

    def value(self, **labels: Any) -> Any:
        return self._vals.get(_label_key(labels), 0)

    def _reset(self) -> None:
        with _LOCK:
            self._vals.clear()


class Gauge(Counter):
    """Last value set, per label set."""

    def set(self, v: float, **labels: Any) -> None:
        with _LOCK:
            self._vals[_label_key(labels)] = v


def _register(cls, name: str, help: str):
    with _LOCK:
        m = _REGISTRY.get(name)
        if m is None:
            m = _REGISTRY[name] = cls(name, help)
        if type(m) is not cls:
            raise TypeError(f"metric {name!r} is a {type(m).__name__}")
        return m


def counter(name: str, help: str = "") -> Counter:
    """Get-or-register the counter family ``name``."""
    return _register(Counter, name, help)


def gauge(name: str, help: str = "") -> Gauge:
    """Get-or-register the gauge family ``name``."""
    return _register(Gauge, name, help)


def reset() -> None:
    """Zero every registered series (registrations survive)."""
    with _LOCK:
        for m in _REGISTRY.values():
            m._reset()
