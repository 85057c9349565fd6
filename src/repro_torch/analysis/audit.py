"""Audit annotations: shard bodies and determinism blessings, the port of
``repro/analysis/audit.py`` (same decorators, records and registries).

Two structured "the author thought about this" records, both attached to
functions with zero-wrapper decorators (one attribute set; the decorated
function runs exactly as before):

* :func:`audit_check_rep` — a function that runs per shard and whose
  values a :class:`~repro_torch.launch.mesh.ShardMesh` collective moves
  (``psum``, ``pmin``, ``all_gather``, ``ppermute``) must be well defined
  per shard: every shard computes its own rows, and whatever is claimed
  the same on every shard is made so by a collective.  The decorator
  records *why* that holds and *which collectives* the argument rests on.
  Rule R2 fails any such function without it.
* :func:`audit_determinism` — a sum-like scatter (``index_add_``,
  ``scatter_add_``, a ``"sum"`` ``scatter_reduce``, an accumulating
  ``index_put_``) whose indices may collide adds in an order the device
  picks: on the card colliding float adds are atomics, so the bits can
  move from run to run.  The decorator records why a specific site is
  nevertheless deterministic (integer-valued counts) or what wobble is
  accepted.  Rule R8 fails any such site not lexically inside a decorated
  function: the blessing sits on the function that *contains* the
  scatter.

This module imports nothing of the port (kernel and model modules import
it at definition time).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, TypeVar

_F = TypeVar("_F", bound=Callable[..., Any])


@dataclass(frozen=True)
class CheckRepAudit:
    """One audited shard body: the argument that it is well defined per
    shard."""

    qualname: str
    module: str
    reason: str
    collectives: tuple[str, ...] = field(default=())

    @property
    def key(self) -> str:
        return f"{self.module}.{self.qualname}"


_REGISTRY: dict[str, CheckRepAudit] = {}

_AUDIT_ATTR = "__check_rep_audit__"


def audit_check_rep(reason: str, *,
                    collectives: tuple[str, ...] | list[str] = ()
                    ) -> Callable[[_F], _F]:
    """Annotate a shard body (a function that runs per shard around a
    ``ShardMesh`` collective) as audited.

    ``reason`` states why the body is well defined per shard;
    ``collectives`` names the collectives (``all_gather``, ``psum``,
    ``ppermute``, ...) whose semantics the argument rests on.  The
    decorated function is returned unchanged.
    """
    if not reason or not reason.strip():
        raise ValueError("audit_check_rep needs a non-empty reason: the "
                         "annotation exists to record the safety argument")

    def deco(fn: _F) -> _F:
        rec = CheckRepAudit(qualname=fn.__qualname__, module=fn.__module__,
                            reason=" ".join(reason.split()),
                            collectives=tuple(collectives))
        setattr(fn, _AUDIT_ATTR, rec)
        _REGISTRY[rec.key] = rec
        return fn

    return deco


def audit_of(fn: Any) -> CheckRepAudit | None:
    """The audit record attached to ``fn``, or None."""
    return getattr(fn, _AUDIT_ATTR, None)


def all_audits() -> dict[str, CheckRepAudit]:
    """Every audit registered so far (importing a module registers its
    decorated bodies); keys are ``module.qualname``."""
    return dict(_REGISTRY)


# ------------------------------------------------------------- determinism
@dataclass(frozen=True)
class DeterminismAudit:
    """One blessed order-dependent reduction site: the determinism
    argument.

    ``file_name`` / ``function_name`` name the decorated function; the
    blessing covers every flagged scatter *lexically inside* it, nothing
    else.
    """

    qualname: str
    module: str
    reason: str
    file_name: str
    function_name: str
    ops: tuple[str, ...] = field(default=())

    @property
    def key(self) -> str:
        return f"{self.module}.{self.qualname}"


_DET_REGISTRY: dict[str, DeterminismAudit] = {}

_DET_AUDIT_ATTR = "__determinism_audit__"


def audit_determinism(reason: str, *,
                      ops: tuple[str, ...] | list[str] = ()
                      ) -> Callable[[_F], _F]:
    """Annotate a function whose order-dependent reductions are
    deliberate and deterministic (or whose nondeterminism is accepted).

    ``reason`` states the argument — e.g. *counts are integer-exact in
    f32, so every summation order produces the same bits*; ``ops`` names
    the reductions the argument covers (``index_add_``, ...).  The
    decorated function is returned unchanged.
    """
    if not reason or not reason.strip():
        raise ValueError("audit_determinism needs a non-empty reason: the "
                         "annotation exists to record the determinism "
                         "argument")

    def deco(fn: _F) -> _F:
        code = fn.__code__
        rec = DeterminismAudit(qualname=fn.__qualname__,
                               module=fn.__module__,
                               reason=" ".join(reason.split()),
                               file_name=code.co_filename,
                               function_name=fn.__name__,
                               ops=tuple(ops))
        setattr(fn, _DET_AUDIT_ATTR, rec)
        _DET_REGISTRY[rec.key] = rec
        return fn

    return deco


def determinism_audit_of(fn: Any) -> DeterminismAudit | None:
    """The determinism audit attached to ``fn``, or None."""
    return getattr(fn, _DET_AUDIT_ATTR, None)


def all_determinism_audits() -> dict[str, DeterminismAudit]:
    """Every determinism audit registered so far, keyed
    ``module.qualname``."""
    return dict(_DET_REGISTRY)
