"""Named counters with labels: the part of ``repro/obs/metrics.py`` that the
ported drivers increment (plan-cache traffic, quarantined points).

Counters are plain host-side Python, incremented from driver code, never
from device code.
"""
from __future__ import annotations

import threading
from typing import Any

__all__ = ["Counter", "counter", "reset"]

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


def counter(name: str, help: str = "") -> Counter:
    """Get-or-register the counter family ``name``."""
    with _LOCK:
        m = _REGISTRY.get(name)
        if m is None:
            m = _REGISTRY[name] = Counter(name, help)
        return m


def reset() -> None:
    """Zero every registered series (registrations survive)."""
    with _LOCK:
        for m in _REGISTRY.values():
            m._reset()
