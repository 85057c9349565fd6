"""The kernel backend behind DPC's two primitives, and its registry.

The port's counterpart of ``repro/kernels/backend.py``.  One backend is
registered so far:

* ``cuda`` — the hand-written Hopper kernels of ``csrc/sweep.cu`` (the
  counterpart of the reference's ``pallas``).  Its primitives run on the
  device of the tensors they are given: CUDA tensors launch the kernels,
  CPU tensors run the kernels' plain versions.  ``rho_delta`` takes the
  ``dense`` or the ``block-sparse`` layout.

The streaming primitives (``range_count_delta``, ``denser_nn_update``)
run dense: kernels K5 and K6.  ``range_count`` is K4, or K8 on a count-only
worklist under ``layout="block-sparse"``; ``denser_nn`` is K2, or K9 on a
best-1 ring.  The halo primitives ``range_count_halo`` / ``denser_nn_halo``
(the distributed halo strategy) are K10 and K11.  ``rho_delta``'s
``y_sel_slots`` (S-Approx-DPC) runs the gated forms of K1/K3; ``prefix_nn``
is K7.  The direct-difference reference backend (the counterpart of
``jnp``), the worklist forms of K5 and of the halo primitives come with
later slices (ROADMAP Queues A and B).
"""
from __future__ import annotations

import torch

from .. import obs
from ..core.dpc_types import density_jitter
from . import blocksparse, density, dependent, ops

__all__ = ["KernelBackend", "CudaBackend", "available_backends",
           "default_backend_name", "get_backend"]

_INT32_MAX = 2**31 - 1


class KernelBackend:
    """The DPC primitives: Def. 1 (``range_count``), Def. 2
    (``denser_nn``), the fused Def. 1 + Def. 2 (``rho_delta``) and the
    stream's batched forms (``range_count_delta``, ``denser_nn_update``)."""

    name: str = "abstract"

    def range_count(self, x, y, d_cut, *, layout=None):
        """(n,) f32: |{j : ||x_i - y_j|| < d_cut}| per row of x."""
        raise NotImplementedError

    def range_count_halo(self, x, window, starts, ends, d_cut, *, span_cap,
                         layout=None):
        """Def. 1 restricted to per-row ragged [start, end) spans into a
        halo-exchanged window: ``starts``/``ends`` (n, S) window-local
        bounds, pairwise disjoint per row (the grid's candidate-cell spans
        are); empty or negative spans count nothing.  ``span_cap``: the
        longest span (the reference's gather-form backends read it)."""
        raise NotImplementedError

    def denser_nn_halo(self, x, x_key, window, w_key, starts, ends, d_cut, *,
                       span_cap, layout=None):
        """Def. 2 restricted to the row's spans AND to d_cut (stencil
        semantics): (delta, parent window index, found); rows with no
        strictly-denser window row within d_cut in their spans report
        found = False (the caller's global fallback answers them)."""
        raise NotImplementedError

    def range_count_delta(self, x, batch, signs, d_cut, *, layout=None):
        """(n,) f32: sum_b signs[b] * [||x_i - batch_b|| < d_cut] — the
        sliding-window rho repair (+1 inserted, -1 evicted, 0 padding)."""
        raise NotImplementedError

    def denser_nn_update(self, points, rho_key, q_slots, *, layout=None):
        """Def. 2 for the row subset ``q_slots`` of ``points`` against all
        of them; slots >= len(points) are padding and return (inf, -1)."""
        raise NotImplementedError

    def denser_nn(self, x, x_key, y, y_key, *, layout=None):
        """(delta, parent): NN among y rows with y_key strictly greater.
        delta = +inf, parent = -1 where no such row exists."""
        raise NotImplementedError

    def prefix_nn(self, pts_sorted_desc):
        """(delta, parent): per row, the NN among the rows before it in a
        table sorted by descending density key (Def. 2 as a triangle);
        (inf, -1) for row 0."""
        raise NotImplementedError

    def rho_delta(self, x, y, d_cut, *, jitter=None, y_sel_slots=None,
                  fallback_interest=None, layout=None):
        """Fused Def. 1 + Def. 2: per x-row range count over y AND the
        nearest strictly-denser y row.  Returns (rho, rho_key, delta,
        parent) with rho_key = rho + jitter.  ``fallback_interest``: optional
        ``rho_key -> (n,) bool`` naming the rows whose Def.-2 answer the
        caller reads; other rows may come back as (inf, -1).  ``layout``:
        ``"dense"`` (default) or ``"block-sparse"`` (x and y grid-sorted).
        ``y_sel_slots`` (len(x) y rows, x's rows in order): Def. 2 only
        among them — the kept-k is gated to those columns and the others
        are never denser (S-Approx-DPC's representatives)."""
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


def _sparse(layout) -> bool:
    """Resolve a layout name: None/'dense' -> False, 'block-sparse' -> True."""
    if layout not in (None, "dense", "block-sparse"):
        raise ValueError(f"unknown layout {layout!r}")
    return layout == "block-sparse"


def _dense_only(primitive: str, layout, who: str) -> None:
    """The worklist forms of K5, K6 and the halo kernels are not ported."""
    if _sparse(layout):
        raise NotImplementedError(
            f"{primitive}(layout='block-sparse') needs the worklist form of "
            f"its kernel, still to be ported (ROADMAP Queue B); {who} calls "
            f"it dense")


class CudaBackend(KernelBackend):
    """The Hopper kernels: ``fused_count_topk`` / ``worklist_count_topk``
    (gated or not) then ``masked_nn`` for the fit; ``range_count``,
    ``range_count_signed`` and ``gather_masked_nn`` for the stream;
    ``prefix_nn``; ``worklist_range_count``, ``worklist_masked_nn``,
    ``halo_range_count`` and ``halo_masked_nn`` for the distributed
    phases."""

    name = "cuda"

    def denser_nn(self, x, x_key, y, y_key, *, layout=None):
        """K2 over all of y, or under ``layout="block-sparse"`` K9 on the
        best-1 ring of x over y (every tile pair, ascending lb per row
        tile), built just before the launch and freed with it."""
        wl = None
        if _sparse(layout):
            wl = blocksparse.build_flat_worklist(x, y, count=False,
                                                 nn="best1")
        return dependent.masked_min_dist(x, x_key, y, y_key, worklist=wl)

    def prefix_nn(self, pts_sorted_desc):
        return dependent.prefix_min_dist(pts_sorted_desc)

    def range_count(self, x, y, d_cut, *, layout=None):
        """K4 over all of y, or under ``layout="block-sparse"`` K8 on the
        count-only worklist of x over y (the in-d_cut tile pairs)."""
        wl = None
        if _sparse(layout):
            wl = blocksparse.build_flat_worklist(x, y, d_cut, nn=None)
        return density.range_count(x, y, d_cut, worklist=wl)

    def range_count_delta(self, x, batch, signs, d_cut, *, layout=None):
        _dense_only("range_count_delta", layout, "the stream")
        return density.range_count_signed(x, batch, signs, d_cut)

    def denser_nn_update(self, points, rho_key, q_slots, *, layout=None):
        """The fused-gather kernel: the query rows are read from ``points``
        inside it, so the gathered subset never exists as a tensor."""
        _dense_only("denser_nn_update", layout, "the stream")
        return dependent.masked_min_dist_gather(points, rho_key, q_slots)

    def range_count_halo(self, x, window, starts, ends, d_cut, *, span_cap,
                         layout=None):
        """K10: each row walks its spans into the window; ``span_cap`` is
        unused, as in the reference's pallas backend."""
        del span_cap
        _dense_only("range_count_halo", layout, "the halo strategy")
        return density.range_count_halo(x, window, starts, ends, d_cut)

    def denser_nn_halo(self, x, x_key, window, w_key, starts, ends, d_cut, *,
                       span_cap, layout=None):
        """K11: K10's span walk for the strictly-denser NN within d_cut."""
        del span_cap
        _dense_only("denser_nn_halo", layout, "the halo strategy")
        return dependent.masked_min_dist_halo(x, x_key, window, w_key,
                                              starts, ends, d_cut)

    def rho_delta(self, x, y, d_cut, *, jitter=None, y_sel_slots=None,
                  fallback_interest=None, layout=None):
        """One sweep (count + unmasked kept-8), the denser-mask resolution,
        then one masked-NN pass for the unresolved tail.

        ``layout="block-sparse"`` builds the tile-pair worklist of x over y
        (``blocksparse.build_flat_worklist``) and sweeps only its pairs
        (K3); the result is the dense sweep's, since the pruning is exact.
        The unresolved tail stays dense, as the reference's does.

        The kept-k resolution is exact: if any kept candidate is strictly
        denser, every candidate nearer than it was kept too, so the nearest
        denser kept candidate IS the dependent point.  Rows whose 8 nearest
        are all less dense (the local maxima) go to ``masked_nn``;
        ``fallback_interest`` restricts that pass to the rows the caller
        reads (Approx-DPC: the cell maxima).  The reference pads the
        unresolved rows to a power of two to bound its retraces; the kernel
        takes its row count at run time, so only the real rows are launched.

        ``y_sel_slots`` (S-Approx-DPC, the reference's ``backend.py:653-727``
        branch): ``nn_sel`` is 1 at those y rows, so the kept-k holds only
        them (the gated K1/K3); the worklist's k-NN ring counts only them
        per column tile; ``col_key`` is ``rho_key`` at them and -inf
        elsewhere, so the resolution and the dense K2 pass over all of y
        reject every other column by its key before its distance.
        """
        sparse = _sparse(layout)
        if jitter is None:
            jitter = density_jitter(x.shape[0], x.device)
        nn_sel = sel_counts = slots = None
        if y_sel_slots is not None:
            slots = torch.as_tensor(y_sel_slots, device=y.device).long()
            if slots.shape != (x.shape[0],):
                raise ValueError(f"rho_delta: y_sel_slots of shape "
                                 f"{tuple(slots.shape)} for {x.shape[0]} "
                                 f"query rows")
            nn_sel = torch.zeros((y.shape[0],), dtype=torch.bool,
                                 device=y.device)
            nn_sel[slots] = True
            nbc = -(-y.shape[0] // blocksparse.BLOCK_M)
            sel_counts = torch.bincount(slots // blocksparse.BLOCK_M,
                                        minlength=nbc)
        wl = None
        if sparse:
            with obs.span("rho_delta.worklist", n=x.shape[0]) as sp:
                wl = blocksparse.build_flat_worklist(
                    x, y, d_cut, nn_col_counts=sel_counts)
                sp.sync(wl.lb)
        with obs.span("rho_delta.sweep", n=x.shape[0]) as sp:
            rho, topv, topi = sp.sync(ops.fused_sweep(
                x, y, d_cut, nn_sel=nn_sel, worklist=wl))
        with obs.span("rho_delta.resolve") as sp:
            rho_key = rho + jitter
            if slots is None:
                col_key = rho_key
            else:
                col_key = torch.full((y.shape[0],), float("-inf"),
                                     dtype=torch.float32, device=y.device)
                col_key[slots] = rho_key
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
