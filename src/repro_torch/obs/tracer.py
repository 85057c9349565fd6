"""Phase-scoped span tracer with host wall-time and device fencing, the
port of ``repro/obs/tracer.py``.

``with span("rho") as sp: ...; sp.sync(out); sp.set(rows=...)`` opens a
nested span.  Spans are host-side bookkeeping: a perf-counter pair and a
thread-local stack that records parentage.

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
  the time since the last span opened, or since the analyzer's canonical
  run of a fresh plan (:func:`reset_peak_memory`), whatever the level.

Closed spans are kept in memory (:func:`spans`) and, where
``configure(trace_path=...)`` names a file, appended to it as JSON lines
as each closes — the reference's record format, so a trace written here
loads in ``repro.obs.report`` and the other way round.
``configure(profile_dir=...)`` starts a ``torch.profiler`` capture into
that directory (TensorBoard's trace format); it stops when the level
returns to ``"off"``.  ``REPRO_OBS=metrics|trace`` (and
``REPRO_OBS_TRACE=path``) set the level and the file at import.

A leaf module: torch and the standard library only.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
import warnings
from typing import Any

import torch

__all__ = ["LEVELS", "configure", "level", "enabled", "tracing", "span",
           "spans", "reset_spans", "flush", "suspended",
           "reset_peak_memory"]

LEVELS = ("off", "metrics", "trace")

_MAX_SPANS = 200_000      # retention cap for the in-memory span list

_LOCK = threading.RLock()
_TLS = threading.local()
_IDS = itertools.count(1)
_ORIGIN = time.perf_counter()


class _State:
    level: str = "off"
    trace_path: str | None = None
    file: Any = None            # the JSON-lines file, opened at first write
    profile_dir: str | None = None
    profiler: Any = None        # the running torch.profiler capture


_STATE = _State()
_DONE: list[dict] = []

_KEEP = object()    # configure() sentinel: leave this setting unchanged


def configure(level: Any = _KEEP, trace_path: Any = _KEEP,
              profile_dir: Any = _KEEP) -> None:
    """Set the process-wide level and trace sinks.

    ``level`` is one of ``LEVELS``.  ``trace_path`` names a JSON-lines file
    that closed spans are appended to (``None`` stops writing; spans stay
    in memory).  ``profile_dir`` starts a ``torch.profiler`` capture into
    that directory; it stops when the level returns to ``"off"`` or
    ``profile_dir=None`` is passed.  Arguments left out keep their value.
    """
    with _LOCK:
        if level is not _KEEP:
            if level not in LEVELS:
                raise ValueError(f"level must be one of {LEVELS}, "
                                 f"got {level!r}")
            _STATE.level = level
        if trace_path is not _KEEP and trace_path != _STATE.trace_path:
            if _STATE.file is not None:
                try:
                    _STATE.file.close()
                except OSError:
                    pass
                _STATE.file = None
            _STATE.trace_path = trace_path
        if profile_dir is not _KEEP and profile_dir != _STATE.profile_dir:
            _stop_profile()
            _STATE.profile_dir = profile_dir
            if profile_dir is not None:
                _start_profile(profile_dir)
        if _STATE.level == "off":
            _stop_profile()


def _start_profile(profile_dir: str) -> None:
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    try:
        prof = profile(activities=acts,
                       on_trace_ready=tensorboard_trace_handler(profile_dir))
        prof.start()
        _STATE.profiler = prof
    except Exception as e:  # noqa: BLE001 - the capture is optional
        warnings.warn(f"obs: torch.profiler capture unavailable: {e}",
                      stacklevel=3)


def _stop_profile() -> None:
    """Stop a running capture (which writes its trace); a later
    ``configure(profile_dir=...)`` starts a new one."""
    prof = _STATE.profiler
    if prof is None:
        return
    _STATE.profiler = _STATE.profile_dir = None
    try:
        prof.stop()
    except Exception as e:  # noqa: BLE001
        warnings.warn(f"obs: torch.profiler capture failed: {e}",
                      stacklevel=3)


def level() -> str:
    return _STATE.level


def enabled() -> bool:
    """True when any instrumentation level is active."""
    return _STATE.level != "off"


def tracing() -> bool:
    """True when spans fence device work (``level="trace"``)."""
    return _STATE.level == "trace"


def _on_cuda(value: Any) -> bool:
    if isinstance(value, torch.Tensor):
        return value.is_cuda
    if isinstance(value, (tuple, list)):
        return any(_on_cuda(v) for v in value)
    return False


def _tracks_memory() -> bool:
    """Peak memory is recorded at trace level once CUDA is initialized
    (never initializing it here)."""
    return _STATE.level == "trace" and torch.cuda.is_initialized()


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
        if _STATE.level == "trace" and value is not None:
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
            "t0": self._t0 - _ORIGIN,
            "host_s": t1 - self._t0,
            "device_s": self._fence_s if _STATE.level == "trace" else None,
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
            if _STATE.trace_path is not None:
                if _STATE.file is None:
                    _STATE.file = open(_STATE.trace_path, "a")
                json.dump(rec, _STATE.file, default=str)
                _STATE.file.write("\n")
        return False


def span(name: str, **attrs: Any) -> "Span | _NullSpan":
    """Open a named span; the shared null span when the level is off."""
    if _STATE.level == "off":
        return NULL_SPAN
    return Span(name, attrs)


@contextlib.contextmanager
def suspended():
    """Record no span inside the block (the analyzer's canonical run): the
    level reads ``"off"`` there and is restored on exit."""
    with _LOCK:
        saved, _STATE.level = _STATE.level, "off"
    try:
        yield
    finally:
        with _LOCK:
            _STATE.level = saved


def reset_peak_memory(device: Any = None) -> None:
    """Reset the card's peak-allocation statistic for a measurement of
    one's own (the analyzer's canonical run), first folding the peak so far
    into the innermost open span that records one, as a child span's start
    does: no span's ``peak_bytes`` loses what came before the reset."""
    stack = getattr(_TLS, "stack", None)
    if stack and stack[-1]._peak is not None:
        stack[-1]._peak = max(stack[-1]._peak,
                              torch.cuda.max_memory_allocated(device))
    torch.cuda.reset_peak_memory_stats(device)


def spans() -> list[dict]:
    """Copy of every closed span record, in close order."""
    with _LOCK:
        return [dict(r) for r in _DONE]


def reset_spans() -> None:
    with _LOCK:
        _DONE.clear()


def flush() -> None:
    """Flush the JSON-lines trace file, if one is open, to disk."""
    with _LOCK:
        if _STATE.file is not None:
            _STATE.file.flush()


# activation from the environment, so a run can be traced without touching
# code: REPRO_OBS=metrics|trace [REPRO_OBS_TRACE=/path/to/trace.jsonl]
_env_level = os.environ.get("REPRO_OBS", "").strip().lower()
if _env_level:
    if _env_level in LEVELS:
        configure(level=_env_level,
                  trace_path=os.environ.get("REPRO_OBS_TRACE") or None)
    else:
        warnings.warn(f"REPRO_OBS={_env_level!r} ignored (not in {LEVELS})",
                      stacklevel=1)
