"""The kernel backend behind DPC's two primitives, and its registry.

The port's counterpart of ``repro/kernels/backend.py``.  Two backends:

* ``cuda`` — the hand-written Hopper kernels of ``csrc/sweep.cu`` (the
  counterpart of the reference's ``pallas``), and the default.  Its
  primitives run on the device of the tensors they are given: CUDA
  tensors launch the kernels, CPU tensors run the kernels' plain versions.
  ``rho_delta`` takes the ``dense`` or the ``block-sparse`` layout.
* ``torch`` — the direct-difference reference math (the counterpart of
  ``jnp``) in plain PyTorch on whatever device its tensors are on, with
  no kernel: chosen only by name (``ExecSpec(backend="torch")``).  Its
  ``mxu_dense`` is False, so the algorithms take the grid-stencil route on
  it in the dense layout (``core/stencil.py``).

The streaming primitives are K5 (``range_count_delta``; K14 on a
count-only worklist under ``layout="block-sparse"``) and K6
(``denser_nn_update``, already subset-shaped: it takes either layout).
``range_count`` is K4, or K8 on a count-only worklist; ``denser_nn`` is
K2, or K9 on a best-1 ring.  The halo primitives ``range_count_halo`` /
``denser_nn_halo`` (the distributed halo strategy) are K10 and K11, or
under ``layout="block-sparse"`` K15 and K16 on the span-pruned worklists.
``rho_delta`` is K1 (K3 on a worklist), or under ``precision="bf16"`` K12
(K13); its ``y_sel_slots`` (S-Approx-DPC) runs their gated forms.
``prefix_nn`` is K7.
"""
from __future__ import annotations

import abc

import torch

from .. import obs
from ..analysis import record
from ..core.dpc_types import density_jitter
from . import blocksparse, density, dependent, ops
from .sweep import (d2cut_of, direct_d2, halo_masked_nn_plain,
                    halo_range_count_plain, masked_nn_plain,
                    range_count_plain, range_count_signed_plain)

__all__ = ["KernelBackend", "CudaBackend", "TorchBackend",
           "available_backends", "default_backend_name", "get_backend",
           "rho_delta_sequential"]

_INT32_MAX = 2**31 - 1


class KernelBackend(abc.ABC):
    """The DPC primitives: Def. 1 (``range_count``), Def. 2
    (``denser_nn``), the fused Def. 1 + Def. 2 (``rho_delta``) and the
    stream's batched forms (``range_count_delta``, ``denser_nn_update``).

    ``mxu_dense`` (the reference's name) tells the algorithms the backend
    wants the dense fused formulation rather than the grid-stencil
    gathers, which are the reference math: only ``torch`` leaves it
    False.  ``builds_worklists`` tells the planner the block-sparse layout
    builds tile-pair worklists (the ``cuda`` backend's, cached per plan)
    rather than walking the ring with none (``torch``)."""

    name: str = "abstract"
    mxu_dense: bool = True
    builds_worklists: bool = True

    @abc.abstractmethod
    def range_count(self, x, y, d_cut, *, layout=None):
        """(n,) f32: |{j : ||x_i - y_j|| < d_cut}| per row of x."""

    @abc.abstractmethod
    def range_count_halo(self, x, window, starts, ends, d_cut, *, span_cap,
                         layout=None):
        """Def. 1 restricted to per-row ragged [start, end) spans into a
        halo-exchanged window: ``starts``/``ends`` (n, S) window-local
        bounds, pairwise disjoint per row (the grid's candidate-cell spans
        are); empty or negative spans count nothing.  ``span_cap``: the
        longest span (the reference's gather-form backends read it)."""

    @abc.abstractmethod
    def denser_nn_halo(self, x, x_key, window, w_key, starts, ends, d_cut, *,
                       span_cap, layout=None):
        """Def. 2 restricted to the row's spans AND to d_cut (stencil
        semantics): (delta, parent window index, found); rows with no
        strictly-denser window row within d_cut in their spans report
        found = False (the caller's global fallback answers them)."""

    @abc.abstractmethod
    def range_count_delta(self, x, batch, signs, d_cut, *, layout=None):
        """(n,) f32: sum_b signs[b] * [||x_i - batch_b|| < d_cut] — the
        sliding-window rho repair (+1 inserted, -1 evicted, 0 padding)."""

    @abc.abstractmethod
    def denser_nn_update(self, points, rho_key, q_slots, *, layout=None):
        """Def. 2 for the row subset ``q_slots`` of ``points`` against all
        of them; slots >= len(points) are padding and return (inf, -1)."""

    @abc.abstractmethod
    def denser_nn(self, x, x_key, y, y_key, *, layout=None, squared=False):
        """(delta, parent): NN among y rows with y_key strictly greater.
        delta = +inf, parent = -1 where no such row exists.  ``squared``:
        (d2, parent), the unrooted distance a caller merges on."""

    @abc.abstractmethod
    def prefix_nn(self, pts_sorted_desc):
        """(delta, parent): per row, the NN among the rows before it in a
        table sorted by descending density key (Def. 2 as a triangle);
        (inf, -1) for row 0."""

    @abc.abstractmethod
    def rho_delta(self, x, y, d_cut, *, jitter=None, y_sel_slots=None,
                  fallback_interest=None, layout=None, precision=None):
        """Fused Def. 1 + Def. 2: per x-row range count over y AND the
        nearest strictly-denser y row.  Returns (rho, rho_key, delta,
        parent) with rho_key = rho + jitter.  ``fallback_interest``: optional
        ``rho_key -> (n,) bool`` naming the rows whose Def.-2 answer the
        caller reads; other rows may come back as (inf, -1).  ``layout``:
        ``"dense"`` (default) or ``"block-sparse"`` (x and y grid-sorted).
        ``y_sel_slots`` (len(x) y rows, x's rows in order): Def. 2 only
        among them — the kept-k is gated to those columns and the others
        are never denser (S-Approx-DPC's representatives).  ``precision``:
        ``"f32"`` (default) or ``"bf16"``, the sweep's distances."""


def _fused_resolve(rho_key, col_key, topv, topi, x=None, y=None):
    """Denser-mask resolution of the kept-k candidates.

    Picks, per row, the nearest strictly denser kept candidate —
    lexicographic (d2, y-index), as the reference's ``_fused_resolve``
    (``repro/kernels/backend.py:573-595``).  K1's kept d2 are already
    direct differences and are used as they are; given ``x`` and ``y`` (the
    bf16 sweep, whose kept d2 are expanded-form), every kept candidate is
    re-evaluated first in direct-difference f32 (``sweep.direct_d2``, K1's
    order of operations), as the reference does.  Rows with no denser kept
    candidate report resolved = False.  The step is reported to the
    analyzer's launch record (R3: a bf16 sweep's winners pass through the
    direct-difference re-evaluation).
    """
    record.note_step("resolve", direct=x is not None)
    ti = topi.clamp_min(0).long()
    if x is not None:
        topv = direct_d2(x[:, None, :], y[ti])
    ok = (topi >= 0) & (col_key[ti] > rho_key[:, None])
    cand = torch.where(ok, topv, float("inf"))
    best = cand.min(dim=1).values
    tied = torch.where(cand == best[:, None], topi, _INT32_MAX)
    resolved = torch.isfinite(best)
    parent = torch.where(resolved, tied.min(dim=1).values, -1)
    return torch.sqrt(best), parent.to(torch.int32), resolved


def _sel_slots(y_sel_slots, x, y) -> torch.Tensor:
    """``rho_delta``'s ``y_sel_slots`` as an int64 tensor on y's device,
    one y row per query row."""
    slots = torch.as_tensor(y_sel_slots, device=y.device).long()
    if slots.shape != (x.shape[0],):
        raise ValueError(f"rho_delta: y_sel_slots of shape "
                         f"{tuple(slots.shape)} for {x.shape[0]} query rows")
    return slots


def _col_key(rho_key: torch.Tensor, slots, m: int) -> torch.Tensor:
    """The NN's column keys: ``rho_key`` itself (y is the query set), or
    ``rho_key`` at the selected ``slots`` of m y rows and -inf elsewhere,
    so no other column is ever denser."""
    if slots is None:
        return rho_key
    col_key = torch.full((m,), float("-inf"), dtype=torch.float32,
                         device=rho_key.device)
    col_key[slots] = rho_key
    return col_key


def _sparse(layout) -> bool:
    """Resolve a layout name: None/'dense' -> False, 'block-sparse' -> True."""
    if layout not in (None, "dense", "block-sparse"):
        raise ValueError(f"unknown layout {layout!r}")
    return layout == "block-sparse"


class CudaBackend(KernelBackend):
    """The Hopper kernels: ``fused_count_topk`` / ``worklist_count_topk``
    (gated or not; their ``_bf16`` forms under ``precision="bf16"``) then
    ``masked_nn`` (``worklist_masked_nn`` under the block-sparse layout)
    for the fit; ``range_count``, ``range_count_signed`` (or
    ``worklist_range_count_signed``) and ``gather_masked_nn`` for the
    stream; ``prefix_nn``; ``worklist_range_count``,
    ``worklist_masked_nn``, ``halo_range_count`` and ``halo_masked_nn``
    (``worklist_halo_range_count`` and ``worklist_halo_masked_nn`` under
    the block-sparse layout) for the distributed phases."""

    name = "cuda"

    def denser_nn(self, x, x_key, y, y_key, *, layout=None, squared=False):
        """K2 over all of y, or under ``layout="block-sparse"`` K9 on the
        best-1 ring of x over y (every tile pair, ascending lb per row
        tile), built just before the launch and freed with it."""
        wl = None
        if _sparse(layout):
            wl = blocksparse.build_flat_worklist(x, y, count=False,
                                                 nn="best1")
        return dependent.masked_min_dist(x, x_key, y, y_key, worklist=wl,
                                         squared=squared)

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
        """K5 over the whole batch, or under ``layout="block-sparse"`` K14
        on the count-only worklist of x over the batch (the in-d_cut tile
        pairs; both grid-sorted for it to prune)."""
        wl = None
        if _sparse(layout):
            wl = blocksparse.build_flat_worklist(x, batch, d_cut, nn=None)
        return density.range_count_signed(x, batch, signs, d_cut,
                                          worklist=wl)

    def denser_nn_update(self, points, rho_key, q_slots, *, layout=None):
        """K6: the rows ``points[q_slots]`` are gathered (q x d floats) and
        searched by the form the shape picks, K2's key-sorted prefix for
        many slots or a key test over unsorted columns for few
        (``ops.dependent_masked_gather``).  It is already subset-shaped, so
        ``layout`` is checked and ignored, as in the reference's pallas
        backend."""
        _sparse(layout)
        return dependent.masked_min_dist_gather(points, rho_key, q_slots)

    def range_count_halo(self, x, window, starts, ends, d_cut, *, span_cap,
                         layout=None):
        """K10: each row walks its spans into the window; or under
        ``layout="block-sparse"`` K15 on the span count worklist of x over
        the window (the in-d_cut tile pairs a span reaches).  ``span_cap``
        is unused, as in the reference's pallas backend."""
        del span_cap
        if not _sparse(layout):
            return density.range_count_halo(x, window, starts, ends, d_cut)
        wl = blocksparse.build_flat_worklist(x, window, d_cut, nn=None,
                                             starts=starts, ends=ends)
        return density.range_count_halo(x, window, starts, ends, d_cut,
                                        worklist=wl)

    def denser_nn_halo(self, x, x_key, window, w_key, starts, ends, d_cut, *,
                       span_cap, layout=None):
        """K11: K10's span walk for the strictly-denser NN within d_cut; or
        under ``layout="block-sparse"`` K16 on the halo ring (the tile
        pairs with lb <= d_cut^2 that a span reaches, ascending lb per row
        tile), built just before the launch."""
        del span_cap
        if not _sparse(layout):
            return dependent.masked_min_dist_halo(x, x_key, window, w_key,
                                                  starts, ends, d_cut)
        wl = blocksparse.build_flat_worklist(
            x, window, d_cut, count=False, nn="best1", nn_dcut=True,
            starts=starts, ends=ends)
        return dependent.masked_min_dist_halo(x, x_key, window, w_key,
                                              starts, ends, d_cut,
                                              worklist=wl)

    def rho_delta(self, x, y, d_cut, *, jitter=None, y_sel_slots=None,
                  fallback_interest=None, layout=None, precision=None):
        """One sweep (count + unmasked kept-8), the denser-mask resolution,
        then one masked-NN pass for the unresolved tail.

        ``layout="block-sparse"`` builds the tile-pair worklist of x over y
        (``blocksparse.build_flat_worklist``) and sweeps only its pairs
        (K3); the result is the dense sweep's, since the pruning is exact.
        The unresolved tail then walks its own best-1 ring (``denser_nn``'s
        block-sparse form, K9) where the reference scans all of y
        (``repro/kernels/backend.py:719-720``): the same (d2, index) as the
        dense K2, in a fraction of its time on grid-sorted data (PERF.md).

        The kept-k resolution is exact: if any kept candidate is strictly
        denser, every candidate nearer than it was kept too, so the nearest
        denser kept candidate IS the dependent point.  Rows whose 8 nearest
        are all less dense (the local maxima) go to ``denser_nn``;
        ``fallback_interest`` restricts that pass to the rows the caller
        reads (Approx-DPC: the cell maxima).  The reference pads the
        unresolved rows to a power of two to bound its retraces; the kernel
        takes its row count at run time, so only the real rows are launched.

        ``y_sel_slots`` (S-Approx-DPC, the reference's ``backend.py:653-727``
        branch): ``nn_sel`` is 1 at those y rows, so the kept-k holds only
        them (the gated K1/K3); the worklist's k-NN ring counts only them
        per column tile; ``col_key`` is ``rho_key`` at them and -inf
        elsewhere, so the resolution and the tail's K2 (or K9, whose column
        tiles with no representative hold only -inf keys and are skipped
        whole) reject every other column by its key before its distance.

        ``precision="bf16"`` (the reference's ``ExecSpec(precision=
        "bf16")``): the sweep is K12/K13, whose count and kept 8 come from
        the expanded form with a bf16 cross term; the resolution then
        re-evaluates the kept 8 in direct-difference f32 before it picks,
        and the tail stays f32 (K2, or K9 block-sparse), as in the reference
        (``repro/kernels/backend.py:653-727``).  On data where bf16 rounding
        is material the count, and the worklist's pruning, differ from f32:
        those are the reference's semantics, kept as they are.
        """
        precision = precision or "f32"
        sparse = _sparse(layout)
        if jitter is None:
            jitter = density_jitter(x.shape[0], x.device)
        nn_sel = sel_counts = slots = None
        if y_sel_slots is not None:
            slots = _sel_slots(y_sel_slots, x, y)
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
        with obs.span("rho_delta.sweep", n=x.shape[0],
                      precision=precision) as sp:
            rho, topv, topi = sp.sync(ops.fused_sweep(
                x, y, d_cut, nn_sel=nn_sel, worklist=wl,
                precision=precision))
        with obs.span("rho_delta.resolve") as sp:
            rho_key = rho + jitter
            col_key = _col_key(rho_key, slots, y.shape[0])
            delta, parent, resolved = _fused_resolve(
                rho_key, col_key, topv, topi,
                x=x if precision == "bf16" else None, y=y)
            unres = ~resolved
            if fallback_interest is not None:
                unres &= fallback_interest(rho_key).to(torch.bool)
            unresolved = torch.nonzero(unres).flatten()
            sp.sync(unresolved)
        if unresolved.numel():
            with obs.span("rho_delta.fallback",
                          rows=int(unresolved.numel())) as sp:
                fd, fp = self.denser_nn(x[unresolved], rho_key[unresolved],
                                        y, col_key, layout=layout)
                delta[unresolved] = fd
                parent[unresolved] = fp
                sp.sync((delta, parent))
        return rho, rho_key, delta, parent


def rho_delta_sequential(be: KernelBackend, x, y, d_cut, *, jitter=None,
                         y_sel_slots=None, layout=None):
    """Def. 1 then Def. 2 as two backend calls (the reference's
    ``rho_delta_sequential``, ``repro/kernels/backend.py:117``): the range
    count, rho_key = rho + jitter, then the strictly-denser NN.
    ``y_sel_slots`` (len(x) y rows, x's rows in order) keys every other y
    row -inf, so the NN runs among them only; ``None`` means y is the query
    set."""
    rho = be.range_count(x, y, d_cut, layout=layout)
    if jitter is None:
        jitter = density_jitter(x.shape[0], x.device)
    slots = None
    if y_sel_slots is not None:
        slots = _sel_slots(y_sel_slots, x, y)
    elif x.shape[0] != y.shape[0]:
        raise ValueError("rho_delta without y_sel_slots needs as many y rows "
                         "as query rows")
    rho_key = rho + jitter
    delta, parent = be.denser_nn(x, rho_key, y,
                                 _col_key(rho_key, slots, y.shape[0]),
                                 layout=layout)
    return rho, rho_key, delta, parent


class TorchBackend(KernelBackend):
    """The reference math in plain PyTorch: the counterpart of the
    reference's ``JnpBackend`` (``repro/kernels/backend.py:502-570``), on
    the device of the tensors it is given.

    Dense, every primitive is a plain version of ``kernels/sweep.py`` (the
    kernels' direct-difference arithmetic, ``sweep.direct_d2``): counts
    over all of y, the NN as the lowest index among equal d2 — the
    reference's per-tile first argmin with a strict ``<`` across tiles.
    Under ``layout="block-sparse"`` the count and the NN walk the ring
    (``blocksparse.ring_range_count`` / ``ring_denser_nn``, the
    reference's ``_count_bs_jnp`` / ``_denser_nn_bs_jnp``): the same
    answers.  The halo primitives are gather form: the spans already are
    the grid's pruning, so they check ``layout`` and ignore it, as the
    reference does.  ``rho_delta`` is the count then the NN
    (``rho_delta_sequential``): the reference's ``_rho_delta_jnp``
    recovers its argmin from the winning tile only to save TPU memory, and
    its answer is this one.  It computes f32 only (bf16 raises) and
    answers every row, so it ignores ``fallback_interest``.
    """

    name = "torch"
    mxu_dense = False
    builds_worklists = False

    def range_count(self, x, y, d_cut, *, layout=None):
        if _sparse(layout):
            return blocksparse.ring_range_count(x, y, d_cut)
        return range_count_plain(x, y, d2cut_of(d_cut)).to(torch.float32)

    def range_count_delta(self, x, batch, signs, d_cut, *, layout=None):
        signs = signs.to(torch.float32)
        if _sparse(layout):
            return blocksparse.ring_range_count(x, batch, d_cut, signs)
        return range_count_signed_plain(x, batch, signs, d2cut_of(d_cut))

    def denser_nn(self, x, x_key, y, y_key, *, layout=None, squared=False):
        if _sparse(layout):
            best, arg = blocksparse.ring_denser_nn(x, x_key, y, y_key)
        else:
            best, arg = masked_nn_plain(x, x_key, y, y_key)
        return (best if squared else torch.sqrt(best)), arg

    def prefix_nn(self, pts_sorted_desc):
        """The strict prefix is the strictly greater key when rows are keyed
        by -row_index (the reference's ``backend.py:536-542``)."""
        key = -torch.arange(pts_sorted_desc.shape[0],
                            device=pts_sorted_desc.device)
        return self.denser_nn(pts_sorted_desc, key, pts_sorted_desc, key)

    def rho_delta(self, x, y, d_cut, *, jitter=None, y_sel_slots=None,
                  fallback_interest=None, layout=None, precision=None):
        if precision not in (None, "f32"):
            raise ValueError("the torch backend is the f32 direct-difference "
                             "reference; use the cuda backend for bf16")
        del fallback_interest       # every row is answered exactly
        return rho_delta_sequential(self, x, y, d_cut, jitter=jitter,
                                    y_sel_slots=y_sel_slots, layout=layout)

    def range_count_halo(self, x, window, starts, ends, d_cut, *, span_cap,
                         layout=None):
        del span_cap                # each chunk takes its own widest row
        _sparse(layout)
        return halo_range_count_plain(x, window, starts, ends,
                                      d2cut_of(d_cut)).to(torch.float32)

    def denser_nn_halo(self, x, x_key, window, w_key, starts, ends, d_cut, *,
                       span_cap, layout=None):
        del span_cap
        _sparse(layout)
        best, arg = halo_masked_nn_plain(x, x_key, window, w_key, starts,
                                         ends, d2cut_of(d_cut))
        return torch.sqrt(best), arg, torch.isfinite(best)

    def denser_nn_update(self, points, rho_key, q_slots, *, layout=None):
        """The reference's base-class default (``backend.py:248-265``): the
        rows ``points[q_slots]`` (slots clamped into the table) against all
        of them; a slot >= len(points) is padding, keyed +inf, and comes
        back (inf, -1)."""
        n = points.shape[0]
        slots = torch.as_tensor(q_slots, device=points.device).long()
        slot_c = slots.clamp(0, max(n - 1, 0))
        qk = torch.where(slots < n, rho_key[slot_c], float("inf"))
        return self.denser_nn(points[slot_c], qk, points, rho_key,
                              layout=layout)


# --------------------------------------------------------------- registry
_BACKENDS: dict[str, KernelBackend] = {"cuda": CudaBackend(),
                                       "torch": TorchBackend()}


def available_backends() -> list[str]:
    return sorted(_BACKENDS)


def default_backend_name() -> str:
    """The kernels: ``cuda``.  ``torch`` is chosen only by name."""
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
