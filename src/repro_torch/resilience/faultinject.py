"""Deterministic fault injection for the chaos tests: the port of
``repro/resilience/faultinject.py``.

Failures arrive mid-tick: a kernel raises halfway through a streaming
ingest, the process dies between a checkpoint's temp-file write and its
rename.  This module plants *named sites* at those points (``fire(site)``,
a no-op costing one attribute read when nothing is armed), so tests can
kill, raise or corrupt at any of them deterministically and prove the
resilience invariants: transactional rollback (``repro_torch.stream``) and
atomic checkpoints (``resilience.checkpoint``).

Activation is programmatic (:func:`activate`) or by environment, as the
subprocess chaos tests do::

    REPRO_FAULT_SITE=tick.rho_repair  REPRO_FAULT_MODE=kill \\
    REPRO_FAULT_TRIGGER=2  python ...

A plan fires on the Nth hit of its site (``trigger=N``; ``0`` = every
hit); given only a ``seed``, the hit index derives from it by a fixed
mixing function, so every chaos run is replayable.

Modes: ``raise`` (a :class:`FaultError` the caller's transaction handling
must contain), ``kill`` (``os._exit(KILL_EXIT_CODE)``, a mid-tick crash
with no unwinding) and ``corrupt`` (never acts at ``fire``; a writer polls
:func:`should_corrupt` and damages its own output, e.g. the checkpoint's
temp file, to exercise the reader's validation).
"""
from __future__ import annotations

import contextlib
import os

from repro_torch import obs

__all__ = ["FaultError", "FaultPlan", "KILL_EXIT_CODE", "KNOWN_SITES",
           "MODES", "activate", "active", "deactivate", "fire",
           "should_corrupt", "suspended"]

# Every plantable site.  activate() validates against this tuple, so a typo
# in a chaos test fails loudly instead of never firing.
KNOWN_SITES = (
    "service.submit",        # StreamService.submit entry
    "tick.grid_apply",       # steady tick: before grid bookkeeping update
    "tick.rho_repair",       # steady tick: before the signed rho repair
    "tick.nn_update",        # steady tick: before the dirty-maxima NN pass
    "tick.finish",           # before label/continuity finalization
    "checkpoint.serialize",  # StreamDPC.save entry (before the temp write)
    "checkpoint.write",      # after the temp write, before the atomic rename
    "kernel.dispatch",       # DPCPlan primitive wrappers
    "degrade.probe",         # resilience.degrade.probe_backend
)
MODES = ("raise", "kill", "corrupt")
KILL_EXIT_CODE = 42

_M_FAULTS = obs.counter(
    "resilience_faults_injected_total",
    "faults actually fired, labeled by site and mode")


class FaultError(RuntimeError):
    """The exception an armed ``mode='raise'`` site throws."""


class FaultPlan:
    """One armed fault: fire ``mode`` on the ``trigger``-th hit of ``site``
    (``trigger == 0``: every hit).  ``hits`` counts site matches so far."""

    def __init__(self, site: str, mode: str, trigger: int):
        self.site = site
        self.mode = mode
        self.trigger = trigger
        self.hits = 0

    def describe(self) -> str:
        return (f"FaultPlan[{self.site} mode={self.mode} "
                f"trigger={self.trigger} hits={self.hits}]")

    __repr__ = describe


_PLAN: FaultPlan | None = None


def _seed_trigger(seed: int) -> int:
    """Deterministic hit index from a seed (Knuth multiplicative mix):
    the same seed gives the same trigger, spread over the first few hits."""
    return 1 + ((int(seed) * 2654435761) % (2 ** 32)) % 4


def activate(site: str, *, mode: str = "raise", trigger: int | None = None,
             seed: int | None = None) -> FaultPlan:
    """Arm one fault plan (replacing any previous one)."""
    global _PLAN
    if site not in KNOWN_SITES:
        raise ValueError(f"unknown fault site {site!r}; known sites: "
                         f"{KNOWN_SITES}")
    if mode not in MODES:
        raise ValueError(f"unknown fault mode {mode!r}; expected one of "
                         f"{MODES}")
    if trigger is None:
        trigger = 1 if seed is None else _seed_trigger(seed)
    if trigger < 0:
        raise ValueError(f"trigger must be >= 0, got {trigger}")
    _PLAN = FaultPlan(site, mode, int(trigger))
    return _PLAN


def deactivate() -> None:
    global _PLAN
    _PLAN = None


def active() -> FaultPlan | None:
    return _PLAN


@contextlib.contextmanager
def suspended():
    """Disarm the active plan for the block (restored on exit, its hit
    count intact), so probe traffic neither fires it nor spends its
    hits."""
    global _PLAN
    saved, _PLAN = _PLAN, None
    try:
        yield
    finally:
        _PLAN = saved


def fire(site: str) -> None:
    """A named injection site.  A no-op unless a plan is armed for
    ``site`` and its trigger is reached; then it counts the fault and
    raises or kills (``corrupt`` plans never act here, see
    :func:`should_corrupt`)."""
    plan = _PLAN
    if plan is None or plan.site != site:
        return
    plan.hits += 1
    if plan.trigger != 0 and plan.hits != plan.trigger:
        return
    if plan.mode == "corrupt":
        return
    _M_FAULTS.inc(site=site, mode=plan.mode)
    if plan.mode == "kill":
        os._exit(KILL_EXIT_CODE)
    raise FaultError(f"injected fault at {site!r} (hit {plan.hits})")


def should_corrupt(site: str) -> bool:
    """True when an armed ``mode='corrupt'`` plan targets ``site`` and its
    trigger is reached: the writer owning the site damages its output."""
    plan = _PLAN
    if plan is None or plan.mode != "corrupt" or plan.site != site:
        return False
    hit = plan.trigger == 0 or plan.hits == plan.trigger
    if hit:
        _M_FAULTS.inc(site=site, mode=plan.mode)
    return hit


def _from_env() -> None:
    site = os.environ.get("REPRO_FAULT_SITE")
    if not site:
        return
    trigger = os.environ.get("REPRO_FAULT_TRIGGER")
    seed = os.environ.get("REPRO_FAULT_SEED")
    activate(site, mode=os.environ.get("REPRO_FAULT_MODE", "raise"),
             trigger=None if trigger is None else int(trigger),
             seed=None if seed is None else int(seed))


_from_env()
