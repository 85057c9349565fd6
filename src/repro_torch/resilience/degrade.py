"""The plan-time backend probe, the port of ``repro/resilience/degrade.py``.

The planner resolves ``ExecSpec.backend`` once per plan through
:func:`resolve_backend`.  For ``cuda`` on a host with a CUDA device the
probe loads (building at first use) the kernel library, launches K4 on an
(8, 2) CUDA tensor and holds it against K4's plain version, so a library
that fails to build or launch shows at ``plan()`` and not inside a fit's
first launch.  On a host with no CUDA device the ``cuda`` backend runs its
kernels' plain versions on CPU tensors, so the probe fires its fault site
and passes without building anything.  ``torch`` is never probed.  Results
are memoized per backend name for the process; :func:`reset` clears them.

A failed probe raises ``RuntimeError`` at ``plan()``, naming the reason:
the port never runs a CUDA tensor without its kernels.  The reference
degrades along a chain to its plain backend instead; here a user who wants
the plain PyTorch math asks for it, ``ExecSpec(backend="torch")`` (ROADMAP
"Reference gaps").
"""
from __future__ import annotations

import torch

from repro_torch.kernels.backend import default_backend_name
from repro_torch.resilience import faultinject

__all__ = ["probe_backend", "reset", "resolve_backend"]

# backend name -> None (probe passed) | str (failure reason)
_PROBED: dict[str, str | None] = {}


def _probe_cuda() -> None:
    """Build or load the library, launch K4 on (8, 2) CUDA points, and
    hold its counts against the plain version's."""
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.sweep import d2cut_of, range_count_plain

    build.load_library()
    x = torch.arange(16, dtype=torch.float32, device="cuda").view(8, 2)
    got = ops.local_density_xy(x, x, 3.0)
    torch.cuda.synchronize()
    want = range_count_plain(x, x, d2cut_of(3.0)).to(torch.float32)
    if not torch.equal(got, want):
        raise RuntimeError(f"K4 probe gave {got.tolist()}, its plain "
                           f"version {want.tolist()}")


def probe_backend(name: str) -> str | None:
    """Probe ``name``: None if healthy, else the failure reason.  Memoized
    per process: one launch per backend name."""
    if name in _PROBED:
        return _PROBED[name]
    reason: str | None = None
    if name != "torch":
        try:
            faultinject.fire("degrade.probe")
            if name == "cuda" and torch.cuda.is_available():
                _probe_cuda()
        except Exception as exc:  # noqa: BLE001 - any failure is the reason
            reason = f"{type(exc).__name__}: {exc}"
    _PROBED[name] = reason
    return reason


def resolve_backend(requested: str | None) -> str:
    """The backend name a plan for ``requested`` runs on: the request
    (``None`` or ``"auto"``: the default backend) once its probe passes;
    a failed probe raises."""
    name = requested
    if name in (None, "auto"):
        name = default_backend_name()
    reason = probe_backend(name)
    if reason is not None:
        raise RuntimeError(
            f"backend {name!r} failed its probe ({reason}); the port does "
            f"not run without its kernels: fix the build, or plan on the "
            f"plain PyTorch math with ExecSpec(backend='torch')")
    return name


def reset() -> None:
    """Forget probe results."""
    _PROBED.clear()
