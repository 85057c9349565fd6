"""Phase-scoped span tracer with host wall-time and device fencing.

The port's counterpart of ``repro/obs/tracer.py``, cut to what the drivers
call: ``with span("rho") as sp: ...; sp.sync(out); sp.set(rows=...)``.

Levels (``configure(level=...)``):

* ``"off"``     — default.  ``span()`` returns a shared null singleton and
  ``sync`` is the identity, so instrumented code keeps CUDA's asynchronous
  launches untouched.
* ``"metrics"`` — spans record host wall-time only.
* ``"trace"``   — ``sync`` fences with ``torch.cuda.synchronize()`` when the
  value holds a CUDA tensor, and the span records the start-to-last-fence
  window as ``device_s``; per-phase times then sum to the wall time.  Once
  CUDA is initialized, each span also records ``peak_bytes``, the most
  device memory allocated while it was open (its children's peaks
  included): the span resets the allocator's peak statistic at its start,
  so a caller's own ``torch.cuda.max_memory_allocated`` reading spans only
  the time since the last span opened.

Closed spans are kept in memory (:func:`spans`); the report CLI and the
JSON-lines sink of the reference are not ported.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Any

import torch

__all__ = ["LEVELS", "configure", "span", "spans", "reset_spans"]

LEVELS = ("off", "metrics", "trace")

_MAX_SPANS = 200_000      # retention cap for the in-memory span list

_LOCK = threading.RLock()
_TLS = threading.local()
_IDS = itertools.count(1)
_STATE = {"level": "off"}
_DONE: list[dict] = []


def configure(level: str) -> None:
    """Set the process-wide observability level (one of ``LEVELS``)."""
    if level not in LEVELS:
        raise ValueError(f"level must be one of {LEVELS}, got {level!r}")
    _STATE["level"] = level


def _on_cuda(value: Any) -> bool:
    if isinstance(value, torch.Tensor):
        return value.is_cuda
    if isinstance(value, (tuple, list)):
        return any(_on_cuda(v) for v in value)
    return False


def _tracks_memory() -> bool:
    """Peak memory is recorded at trace level once CUDA is initialized
    (never initializing it here)."""
    return _STATE["level"] == "trace" and torch.cuda.is_initialized()


class _NullSpan:
    """Shared no-op span for the off path."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False

    def sync(self, value: Any = None) -> Any:
        return value

    def set(self, **attrs: Any) -> None:
        pass


NULL_SPAN = _NullSpan()


class Span:
    __slots__ = ("name", "attrs", "id", "parent", "depth", "path", "_t0",
                 "_mark", "_fence_s", "_peak")

    def __init__(self, name: str, attrs: dict) -> None:
        self.name = name
        self.attrs = attrs
        self.id = next(_IDS)
        self.parent = None
        self.depth = 0
        self.path = name
        self._t0 = self._mark = 0.0
        self._fence_s = 0.0
        self._peak = None

    def sync(self, value: Any = None) -> Any:
        """At trace level, wait for the device work behind ``value`` (a
        tensor or a tuple/list of them) and add the window since the span's
        start (or its previous fence) to ``device_s``.  Returns ``value``."""
        if _STATE["level"] == "trace" and value is not None:
            if _on_cuda(value):
                torch.cuda.synchronize()
            now = time.perf_counter()
            self._fence_s += now - self._mark
            self._mark = now
        return value

    def set(self, **attrs: Any) -> None:
        """Add attributes known only inside the span."""
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        stack = getattr(_TLS, "stack", None)
        if stack is None:
            stack = _TLS.stack = []
        if stack:
            top = stack[-1]
            self.parent = top.id
            self.depth = top.depth + 1
            self.path = f"{top.path}/{self.name}"
        if _tracks_memory():
            peak = torch.cuda.max_memory_allocated()
            if stack:
                stack[-1]._peak = max(stack[-1]._peak or 0, peak)
            torch.cuda.reset_peak_memory_stats()
            self._peak = 0
        stack.append(self)
        self._t0 = self._mark = time.perf_counter()
        return self

    def __exit__(self, exc_type: Any, exc: Any, tb: Any) -> bool:
        t1 = time.perf_counter()
        stack = getattr(_TLS, "stack", None)
        if stack and stack[-1] is self:
            stack.pop()
        if self._peak is not None:
            self._peak = max(self._peak, torch.cuda.max_memory_allocated())
            if stack and stack[-1]._peak is not None:
                stack[-1]._peak = max(stack[-1]._peak, self._peak)
        rec: dict[str, Any] = {
            "name": self.name, "path": self.path, "id": self.id,
            "parent": self.parent, "depth": self.depth,
            "host_s": t1 - self._t0,
            "device_s": self._fence_s if _STATE["level"] == "trace" else None,
        }
        if self._peak is not None:
            rec["peak_bytes"] = self._peak
        if self.attrs:
            rec["attrs"] = self.attrs
        if exc_type is not None:
            rec["error"] = exc_type.__name__
        with _LOCK:
            _DONE.append(rec)
            if len(_DONE) > _MAX_SPANS:
                del _DONE[: len(_DONE) - _MAX_SPANS]
        return False


def span(name: str, **attrs: Any) -> "Span | _NullSpan":
    """Open a named span; the shared null span when the level is off."""
    if _STATE["level"] == "off":
        return NULL_SPAN
    return Span(name, attrs)


def spans() -> list[dict]:
    """Copy of every closed span record, in close order."""
    with _LOCK:
        return [dict(r) for r in _DONE]


def reset_spans() -> None:
    with _LOCK:
        _DONE.clear()
