"""Poisoned-input admission control, the port of
``repro/resilience/sanitize.py``'s ``admit`` and ``finite_or``.

Malformed points are caught at the boundary (``DPCEngine.fit``) under one
quarantine policy:

* ``reject`` (default) — raise :class:`PoisonedInputError`; nothing enters.
* ``drop``   — quarantine the offending rows, admit the rest.
* ``clamp``  — repair: NaN -> 0, +-inf / out-of-range -> the largest
  admissible magnitude (strictly below ``max_abs``).

"Poisoned" means a non-numeric dtype (never repairable), a non-finite
coordinate after the f32 cast, or ``|x| >= max_abs`` (default
``PAD_COORD``).  Every quarantined point counts on
``resilience_quarantined_points{reason,policy,where}``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.kernels.sweep import PAD_COORD

__all__ = ["POLICIES", "AdmissionConfig", "AdmissionResult",
           "PoisonedInputError", "admit", "finite_or"]

POLICIES = ("reject", "drop", "clamp")

_M_QUARANTINED = obs.counter(
    "resilience_quarantined_points",
    "points caught by admission control, labeled by reason/policy/boundary")


class PoisonedInputError(ValueError):
    """Malformed points hit a ``reject`` boundary (or are unrepairable)."""


@dataclass(frozen=True)
class AdmissionConfig:
    """Quarantine policy for one admission boundary; ``max_abs`` is the
    open coordinate bound."""

    policy: str = "reject"
    max_abs: float = float(PAD_COORD)

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(f"unknown quarantine policy {self.policy!r}; "
                             f"expected one of {POLICIES}")
        if not self.max_abs > 0.0:
            raise ValueError(f"max_abs must be positive, got {self.max_abs!r}")


class AdmissionResult(NamedTuple):
    points: np.ndarray      # admitted rows, f32, 2-D (clamped under 'clamp')
    keep: np.ndarray        # (m,) bool over the INPUT rows; False = dropped
    quarantined: int        # rows caught (dropped, clamped, or — reject — 0)


def admit(points, cfg: AdmissionConfig, *,
          where: str = "ingest") -> AdmissionResult:
    """Validate ``points`` against ``cfg`` at boundary ``where``; a tensor
    is checked on the host.  ``reject`` raises on any poisoned row;
    non-numeric input raises under every policy."""
    if isinstance(points, torch.Tensor):
        points = points.detach().cpu().numpy()
    arr = np.asarray(points)
    if arr.dtype == object or arr.dtype.kind in "cSUVmM":
        _M_QUARANTINED.inc(max(arr.shape[0], 1) if arr.ndim else 1,
                           reason="bad_dtype", policy=cfg.policy, where=where)
        raise PoisonedInputError(
            f"{where}: points have non-numeric dtype {arr.dtype!r}; no "
            f"quarantine policy can repair that — submit a real-valued "
            f"array")
    pts = np.atleast_2d(np.asarray(arr, np.float32))
    if pts.size == 0:
        return AdmissionResult(pts, np.zeros(len(pts), bool), 0)
    nonfinite = ~np.isfinite(pts)
    oob = np.abs(pts) >= np.float32(cfg.max_abs)
    bad = (nonfinite | oob).any(axis=1)
    nbad = int(bad.sum())
    if nbad == 0:
        return AdmissionResult(pts, np.ones(len(pts), bool), 0)

    n_nonfin = int(nonfinite.any(axis=1).sum())
    if n_nonfin:
        _M_QUARANTINED.inc(n_nonfin, reason="non_finite",
                           policy=cfg.policy, where=where)
    if nbad - n_nonfin:
        _M_QUARANTINED.inc(nbad - n_nonfin, reason="out_of_range",
                           policy=cfg.policy, where=where)

    if cfg.policy == "reject":
        first = int(np.nonzero(bad)[0][0])
        raise PoisonedInputError(
            f"{where}: {nbad}/{len(pts)} poisoned point(s) (non-finite or "
            f"|x| >= {cfg.max_abs:g}); first bad row {first}: "
            f"{pts[first].tolist()} — policy='reject' admits nothing "
            f"(use 'drop' or 'clamp' to degrade instead)")
    if cfg.policy == "drop":
        return AdmissionResult(pts[~bad], ~bad, nbad)
    limit = np.nextafter(np.float32(cfg.max_abs), np.float32(0.0))
    fixed = np.nan_to_num(pts, nan=0.0, posinf=limit, neginf=-limit)
    fixed = np.clip(fixed, -limit, limit)
    return AdmissionResult(fixed, np.ones(len(pts), bool), nbad)


def finite_or(x: torch.Tensor, fill) -> torch.Tensor:
    """``x`` where finite, ``fill`` elsewhere: the non-finite guard of a
    kernel's epilogue (inf deltas at global density peaks, NaN distances
    from poisoned rows)."""
    return torch.where(torch.isfinite(x), x, torch.as_tensor(
        fill, dtype=x.dtype, device=x.device))
