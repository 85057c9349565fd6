"""The kernel backend behind DPC's two primitives, and its registry.

The port's counterpart of ``repro/kernels/backend.py``.  One backend is
registered so far:

* ``cuda`` — the hand-written Hopper kernels of ``csrc/sweep.cu`` (the
  counterpart of the reference's ``pallas``).  Its primitives run on the
  device of the tensors they are given: CUDA tensors launch the kernels,
  CPU tensors run the kernels' plain versions.

The direct-difference reference backend (the counterpart of ``jnp``) and
the halo, streaming and block-sparse primitives come with later slices
(ROADMAP Queue A).
"""
from __future__ import annotations

import torch

from .. import obs
from ..core.dpc_types import density_jitter
from . import ops

__all__ = ["KernelBackend", "CudaBackend", "available_backends",
           "default_backend_name", "get_backend"]

_INT32_MAX = 2**31 - 1


class KernelBackend:
    """The DPC primitives: Def. 2 (``denser_nn``) and the fused Def. 1 +
    Def. 2 (``rho_delta``)."""

    name: str = "abstract"

    def denser_nn(self, x, x_key, y, y_key):
        """(delta, parent): NN among y rows with y_key strictly greater.
        delta = +inf, parent = -1 where no such row exists."""
        raise NotImplementedError

    def rho_delta(self, x, y, d_cut, *, jitter=None, y_sel_slots=None,
                  fallback_interest=None):
        """Fused Def. 1 + Def. 2: per x-row range count over y AND the
        nearest strictly-denser y row.  Returns (rho, rho_key, delta,
        parent) with rho_key = rho + jitter.  ``fallback_interest``: optional
        ``rho_key -> (n,) bool`` naming the rows whose Def.-2 answer the
        caller reads; other rows may come back as (inf, -1)."""
        raise NotImplementedError


def _fused_resolve(rho_key, col_key, topv, topi):
    """Denser-mask resolution of the kept-k candidates.

    Picks, per row, the nearest strictly denser kept candidate —
    lexicographic (d2, y-index), as the reference's ``_fused_resolve``
    (``repro/kernels/backend.py:573-595``).  The kept d2 are already direct
    differences, so nothing is re-evaluated.  Rows with no denser kept
    candidate report resolved = False.
    """
    ti = topi.clamp_min(0).long()
    ok = (topi >= 0) & (col_key[ti] > rho_key[:, None])
    cand = torch.where(ok, topv, float("inf"))
    best = cand.min(dim=1).values
    tied = torch.where(cand == best[:, None], topi, _INT32_MAX)
    resolved = torch.isfinite(best)
    parent = torch.where(resolved, tied.min(dim=1).values, -1)
    return torch.sqrt(best), parent.to(torch.int32), resolved


class CudaBackend(KernelBackend):
    """The Hopper kernels: ``fused_count_topk`` then ``masked_nn``."""

    name = "cuda"

    def denser_nn(self, x, x_key, y, y_key):
        return ops.dependent_masked(x, x_key, y, y_key)

    def rho_delta(self, x, y, d_cut, *, jitter=None, y_sel_slots=None,
                  fallback_interest=None):
        """One sweep (count + unmasked kept-8), the denser-mask resolution,
        then one masked-NN pass for the unresolved tail.

        The kept-k resolution is exact: if any kept candidate is strictly
        denser, every candidate nearer than it was kept too, so the nearest
        denser kept candidate IS the dependent point.  Rows whose 8 nearest
        are all less dense (the local maxima) go to ``masked_nn``;
        ``fallback_interest`` restricts that pass to the rows the caller
        reads (Approx-DPC: the cell maxima).  The reference pads the
        unresolved rows to a power of two to bound its retraces; the kernel
        takes its row count at run time, so only the real rows are launched.
        """
        if y_sel_slots is not None:
            raise NotImplementedError(
                "rho_delta(y_sel_slots=...) gates the kept-k to S-Approx "
                "representatives; it is ported with the S-Approx slice "
                "(ROADMAP Queue A item 4)")
        if jitter is None:
            jitter = density_jitter(x.shape[0], x.device)
        with obs.span("rho_delta.sweep", n=x.shape[0]) as sp:
            rho, topv, topi = sp.sync(ops.fused_sweep(x, y, d_cut))
        with obs.span("rho_delta.resolve") as sp:
            rho_key = rho + jitter
            col_key = rho_key
            delta, parent, resolved = _fused_resolve(rho_key, col_key, topv,
                                                     topi)
            unres = ~resolved
            if fallback_interest is not None:
                unres &= fallback_interest(rho_key).to(torch.bool)
            unresolved = torch.nonzero(unres).flatten()
            sp.sync(unresolved)
        if unresolved.numel():
            with obs.span("rho_delta.fallback",
                          rows=int(unresolved.numel())) as sp:
                fd, fp = self.denser_nn(x[unresolved], rho_key[unresolved],
                                        y, col_key)
                delta[unresolved] = fd
                parent[unresolved] = fp
                sp.sync((delta, parent))
        return rho, rho_key, delta, parent


# --------------------------------------------------------------- registry
_BACKENDS: dict[str, KernelBackend] = {"cuda": CudaBackend()}


def available_backends() -> list[str]:
    return sorted(_BACKENDS)


def default_backend_name() -> str:
    """The kernels: ``cuda`` is the only backend so far."""
    return "cuda"


def get_backend(backend: "str | KernelBackend | None" = None) -> KernelBackend:
    """Resolve a backend name (or None/'auto' for the default)."""
    if isinstance(backend, KernelBackend):
        return backend
    name = backend if backend not in (None, "auto") else default_backend_name()
    if name not in _BACKENDS:
        raise ValueError(f"unknown kernel backend {name!r}; "
                         f"available: {available_backends()}")
    return _BACKENDS[name]
