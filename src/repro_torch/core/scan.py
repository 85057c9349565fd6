"""Scan: the paper's straightforward O(n^2) DPC (§2.1), the correctness
oracle.

The port of ``repro/core/scan.py::run_scan``: Def. 1 and Def. 2 answered
by one fused ``rho_delta`` call on the planned kernel backend.  With
``ExecSpec(layout="block-sparse")`` the points are grid-sorted and the
sweep visits only the worklist's tile pairs — sub-quadratic work, the same
function.  ``local_density_scan`` and ``dependent_scan`` are aliases of
the ``torch`` reference backend's primitives, the direct-difference math
the oracle contract relies on.
"""
from __future__ import annotations

from ..engine.planner import as_plan
from ..kernels.backend import get_backend
from .device import as_points
from .dpc_types import DPCResult
from .exdpc import fused_dpc


def local_density_scan(points, d_cut: float):
    """rho_i = |{j : dist(i, j) < d_cut}| by full scan (self included):
    the ``torch`` backend's range count."""
    return get_backend("torch").range_count(points, points, d_cut)


def dependent_scan(points, rho_key):
    """Exact dependent distance and point by full scan with a rho mask:
    the ``torch`` backend's denser NN."""
    return get_backend("torch").denser_nn(points, rho_key, points, rho_key)


def run_scan(points, d_cut: float, *, exec_spec=None) -> DPCResult:
    """A tensor runs on its own device; anything else goes to the card."""
    points = as_points(points)
    pl = as_plan(exec_spec, points)
    return fused_dpc(points, d_cut, pl, phase="scan")
