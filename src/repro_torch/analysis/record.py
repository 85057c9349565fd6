"""The launch record: what the analyzer reads in place of a traced program,
the port's counterpart of ``repro/analysis/walker.py``.

Inside :func:`recording`, every kernel wrapper of ``kernels/ops.py``
reports its call in order, under its kernel's launch-count name (the keys
of ``ops.launch_counts()``): a CUDA tensor's call launches the kernel, a
CPU tensor's runs its plain version, and both are recorded alike.  The
record holds what the launch rules check — the shapes and dtypes of the
inputs, the query rows and the row tile they are padded to, the worklist's
entry count, the dimension, the threshold and the device — and the steps
of a target that are not kernels: the f32 direct-difference resolve of the
fused sweep's kept candidates (``kernels/backend.py::_fused_resolve``, R3's
subject) and each ``d_cut`` -> ``d2cut`` rounding (``sweep.d2cut_of``,
R7's).

Recording reads only tensor metadata (shapes, dtypes, devices, element
counts), so it adds no host sync; with no recorder active each report is
one list test.  The launch counts are not touched: a recorder extends
``ops.launch_counts()``, it does not replace it.

This module imports nothing of the port.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Any, Iterator

__all__ = ["Launch", "Step", "recording", "note_launch", "note_step",
           "launches", "steps"]

# the records being written, innermost last; every active one gets each
# event
_STACK: list[list] = []


@dataclass(frozen=True)
class Launch:
    """One kernel wrapper's call.  ``row_tile`` is the row tile the call's
    worklist pads the query rows to (1 where nothing pads), ``padded_rows``
    the rows it covers; ``entries`` the worklist's entry count (None
    without one); ``grid`` the launch grid where the wrapper knows it
    (K2's work items on a CUDA tensor), else None."""

    kernel: str
    shapes: tuple
    dtypes: tuple
    rows: int
    cols: int
    d: int
    row_tile: int
    padded_rows: int
    entries: int | None
    device: str
    d2cut: float | None
    grid: tuple | None = None


@dataclass(frozen=True)
class Step:
    """A step of a target that is not a kernel: ``kind`` ``"resolve"``
    (``info["direct"]``: the kept candidates re-evaluated in f32 direct
    differences) or ``"threshold"`` (``info["d2cut"]``, and the type of
    the ``d_cut`` it was rounded from)."""

    kind: str
    info: dict = field(default_factory=dict)


@contextlib.contextmanager
def recording() -> Iterator[list]:
    """Collect the events of the block, in order, into the list yielded."""
    events: list = []
    _STACK.append(events)
    try:
        yield events
    finally:
        _STACK.pop()


def _emit(event: Any) -> None:
    for events in _STACK:
        events.append(event)


def note_launch(kernel: str, x, y, *others, d2cut: float | None = None,
                worklist=None, row_tile: int = 1, grid=None,
                rows: int | None = None) -> None:
    """Report a wrapper's call of ``kernel`` on query rows ``x`` (n, d)
    and candidates ``y`` (m, d); ``others`` are its further tensor inputs
    (keys, spans, signs, slots).  ``row_tile``: the worklist's row tile;
    ``rows``: the query rows where they are not x's (K6's slots)."""
    if not _STACK:
        return
    tensors = [t for t in (x, y, *others) if t is not None]
    n = int(x.shape[0]) if rows is None else int(rows)
    m = int(y.shape[0])
    padded, entries, tile = n, None, 1
    if worklist is not None:
        tile = int(row_tile)
        padded = int(worklist.num_row_tiles) * tile
        entries = int(worklist.col_tile.numel())
    _emit(Launch(kernel=kernel,
                 shapes=tuple(tuple(int(s) for s in t.shape)
                              for t in tensors),
                 dtypes=tuple(str(t.dtype).removeprefix("torch.")
                              for t in tensors),
                 rows=n, cols=m, d=int(x.shape[1]),
                 row_tile=tile, padded_rows=padded, entries=entries,
                 device=str(x.device), d2cut=d2cut,
                 grid=None if grid is None else tuple(int(g) for g in grid)))


def note_step(kind: str, **info) -> None:
    if _STACK:
        _emit(Step(kind, info))


def launches(events: list) -> list[Launch]:
    return [e for e in events if isinstance(e, Launch)]


def steps(events: list, kind: str) -> list[Step]:
    return [e for e in events if isinstance(e, Step) and e.kind == kind]
