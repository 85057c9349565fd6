"""Public DPC API: one config, one entry point.

The port of ``repro/core/dpc_api.py``.  Its dispatch table holds Scan,
Ex-DPC, Approx-DPC and S-Approx-DPC; the two baselines' names stay valid
and raise ``NotImplementedError`` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Literal

from repro_torch.engine.spec import ExecSpec

from .approxdpc import run_approxdpc
from .device import as_points, resolve_device
from .dpc_types import DPCResult
from .exdpc import run_exdpc
from .labels import Clustering, assign_labels, decision_graph
from .sapproxdpc import run_sapproxdpc
from .scan import run_scan

Algorithm = Literal["scan", "exdpc", "approxdpc", "sapproxdpc",
                    "lsh_ddp", "cfsfdp_a"]

_ALGORITHMS = ("scan", "exdpc", "approxdpc", "sapproxdpc", "lsh_ddp",
               "cfsfdp_a")

_RUNNERS = {
    "scan": lambda p, c, x: run_scan(p, c.d_cut, exec_spec=x),
    "exdpc": lambda p, c, x: run_exdpc(p, c.d_cut, g=c.grid_dims,
                                       exec_spec=x),
    "approxdpc": lambda p, c, x: run_approxdpc(p, c.d_cut, g=c.grid_dims,
                                               exec_spec=x),
    "sapproxdpc": lambda p, c, x: run_sapproxdpc(p, c.d_cut, eps=c.eps,
                                                 g=c.grid_dims, exec_spec=x),
}

# the baselines draw with jax.random (LSH projections, k-means pivots):
# their port decides how both packages get the same draws
_UNPORTED = {
    "lsh_ddp": "it waits for ROADMAP Queue A item 4 (core/lsh_ddp.py)",
    "cfsfdp_a": "it waits for ROADMAP Queue A item 4 (core/cfsfdp_a.py)",
}


def check_algorithm(algorithm: str, eps: float = 0.8) -> None:
    """ValueError for an unknown name or S-Approx-DPC with eps <= 0,
    NotImplementedError for a known name that is not ported yet."""
    if algorithm not in _ALGORITHMS:
        raise ValueError(f"unknown algorithm {algorithm!r}; "
                         f"expected one of {_ALGORITHMS}")
    if algorithm in _UNPORTED:
        raise NotImplementedError(
            f"algorithm {algorithm!r} is not ported yet: "
            f"{_UNPORTED[algorithm]}")
    if algorithm == "sapproxdpc" and not eps > 0.0:
        raise ValueError(f"S-Approx-DPC needs eps > 0 (coarse-grid side "
                         f"eps*d_cut/sqrt(d)); got {eps!r}")


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
        check_algorithm(self.algorithm, self.eps)
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
