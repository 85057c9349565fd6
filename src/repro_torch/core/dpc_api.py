"""Public DPC API: one config, one entry point.

The port of ``repro/core/dpc_api.py``.  Its dispatch table holds Approx-DPC
only; the other algorithm names stay valid and raise ``NotImplementedError``
naming the ROADMAP item that ports them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Literal

from repro_torch.engine.spec import ExecSpec

from .approxdpc import run_approxdpc
from .device import as_points, resolve_device
from .dpc_types import DPCResult
from .labels import Clustering, assign_labels, decision_graph

Algorithm = Literal["scan", "exdpc", "approxdpc", "sapproxdpc",
                    "lsh_ddp", "cfsfdp_a"]

_ALGORITHMS = ("scan", "exdpc", "approxdpc", "sapproxdpc", "lsh_ddp",
               "cfsfdp_a")

_RUNNERS = {
    "approxdpc": lambda p, c, x: run_approxdpc(p, c.d_cut, g=c.grid_dims,
                                               exec_spec=x),
}

_UNPORTED = {
    "scan": "ROADMAP Queue A item 4 (core/scan.py)",
    "exdpc": "ROADMAP Queue A item 4 (core/exdpc.py)",
    "sapproxdpc": "ROADMAP Queue A item 4 (core/sapproxdpc.py)",
    "lsh_ddp": "ROADMAP Queue A item 4 (core/lsh_ddp.py)",
    "cfsfdp_a": "ROADMAP Queue A item 4 (core/cfsfdp_a.py)",
}


def check_algorithm(algorithm: str) -> None:
    """ValueError for an unknown name, NotImplementedError for a known one
    that is not ported yet."""
    if algorithm not in _ALGORITHMS:
        raise ValueError(f"unknown algorithm {algorithm!r}; "
                         f"expected one of {_ALGORITHMS}")
    if algorithm in _UNPORTED:
        raise NotImplementedError(
            f"algorithm {algorithm!r} is not ported yet: "
            f"{_UNPORTED[algorithm]}")


@dataclass(frozen=True)
class DPCConfig:
    """One config for the DPC algorithms (fail-fast validation)."""

    d_cut: float
    rho_min: float = 10.0
    delta_min: float | None = None      # default 2 * d_cut (must be > d_cut)
    algorithm: Algorithm = "approxdpc"
    eps: float = 0.8                    # S-Approx-DPC only
    grid_dims: int | None = None        # candidate-grid dims (default min(d,3))
    exec_spec: ExecSpec | None = None

    def __post_init__(self):
        check_algorithm(self.algorithm)
        if not self.d_cut > 0.0:
            raise ValueError(f"d_cut must be positive, got {self.d_cut!r}")
        if self.exec_spec is None:
            object.__setattr__(self, "exec_spec", ExecSpec())

    def resolved_exec(self) -> ExecSpec:
        return self.exec_spec

    def resolved_delta_min(self) -> float:
        dm = 2.0 * self.d_cut if self.delta_min is None else self.delta_min
        if dm <= self.d_cut:
            raise ValueError("delta_min must exceed d_cut (Def. 5)")
        return dm


def compute_dpc(points, config: DPCConfig, *, device=None) -> DPCResult:
    """rho/delta/dependent-point computation with the configured algorithm."""
    return _RUNNERS[config.algorithm](as_points(points, device), config,
                                      config.resolved_exec())


def cluster(points, config: DPCConfig, *,
            device=None) -> tuple[Clustering, DPCResult]:
    res = compute_dpc(points, config, device=device)
    out = assign_labels(res, config.rho_min, config.resolved_delta_min())
    return out, res


__all__ = ["DPCConfig", "DPCResult", "Clustering", "compute_dpc", "cluster",
           "assign_labels", "decision_graph", "resolve_device"]
