"""Block-sparse tile worklists: the grid-pruned, sub-quadratic sweep.

The port of the flat-worklist half of ``repro/kernels/blocksparse.py``.  On
grid-sorted points (``core.grid``'s (candidate, grouping) sort) each tile
of rows covers a compact region of space, so a per-tile axis-aligned
bounding box bounds every distance a tile pair can produce:

* ``lb`` — the least squared distance between two boxes, shrunk by
  ``LB_SHRINK`` so the bound's own f32 rounding can never exceed a pair's
  direct-difference d2 (pruning by it is exact);
* ``ub`` — the largest, grown by ``UB_GROW``.

:func:`build_flat_worklist` keeps, per row tile, the column tiles whose
``lb <= d_cut^2`` (``in_cut``: the count needs them) and those whose ``lb``
is within the static k-NN radius (the kept-k needs them), sorted by
ascending ``lb`` — the ring order in which the CUDA kernel K3 walks them
and skips, against each row's live k-th distance, the entries that can no
longer matter.  Its other forms: the count-only worklist (the ``in_cut``
pairs, for K8), the best-1 ring (every tile pair, for K9, which stops its
walk where no row can improve), and the halo forms of both over per-row
window spans (``starts``/``ends``: only the tile pairs a span reaches, for
K15 and K16).  The reference builds them
on the host in numpy; here they are built in torch on the points' device,
a chunk of row tiles at a time, so the build's own peak memory stays small
at millions of points.

The reference backend's own block-sparse form, the ring walk
(:func:`ring_range_count`, :func:`ring_denser_nn`: the ``torch`` backend's
``layout="block-sparse"``), evaluates the tile pairs of each row tile in
ascending-lb order with no worklist.

Inside a :func:`worklist_cache` scope (a plan's ``rho_delta`` wrapper,
``engine/planner.py``) :func:`build_flat_worklist` memoizes its sweep
worklists by a content fingerprint of everything the build reads, so a
refit of the same data builds no K3 worklist (the reference's
``worklist_cache``, ``repro/kernels/blocksparse.py:420-523``).  Three
things differ: the fingerprint is taken on the points' device
(:func:`fingerprint`), never from a host copy; the cache's cap counts the
worklists' device bytes; and the best-1 rings are never cached, since
fingerprinting their columns costs more than building them.  Direct
backend calls, with no scope active, build every time.
"""
from __future__ import annotations

import hashlib
from contextlib import contextmanager
from dataclasses import dataclass

import numpy as np
import torch

from .. import obs
from ..obs import metrics as _obsm

__all__ = ["LB_SHRINK", "UB_GROW", "BLOCK_N", "BLOCK_M", "BS_BLOCK_N",
           "BS_BLOCK_M", "WL_CACHE_MAX_ENTRIES", "WL_CACHE_MAX_BYTES",
           "Worklist", "tile_bounds", "pair_bounds", "knn_radius",
           "build_flat_worklist", "worklist_cache", "suspend_counters",
           "fingerprint", "worklist_build_count", "worklist_cache_hits",
           "worklist_fingerprint_misses", "ring_range_count",
           "ring_denser_nn"]

# Conservative slack on the f32 bound arithmetic (the reference's values).
LB_SHRINK = 1.0 - 1e-5
UB_GROW = 1.0 + 1e-5

# The fused sweep's tile shape: rows per row tile (one K3 block) and columns
# per column tile (kWlRows / kWlCols in csrc/sweep.cu).
BLOCK_N = 256
BLOCK_M = 512

# The ring walk's tile shape, the reference's jnp one: its answers do not
# depend on it, its work does.
BS_BLOCK_N = 128
BS_BLOCK_M = 256

# bound matrices are built over chunks of at most this many tile pairs
_CHUNK_PAIRS = 1 << 24
# the ring walk evaluates its tile pairs in batches of this many point pairs
_ENTRY_PAIRS = 1 << 24

_M_BUILDS = _obsm.counter(
    "worklist_builds", "flat-worklist builds (cache misses included)")
_M_CACHE_HITS = _obsm.counter(
    "worklist_cache_hits", "fingerprint hits inside a worklist_cache scope")
_M_FP_MISSES = _obsm.counter(
    "worklist_fingerprint_misses",
    "cache was active but the content fingerprint was absent (true rebuild)")
_G_WL_LEN = _obsm.gauge(
    "worklist_len", "kept tile-pair count of the most recent build")
_G_WL_PRUNED = _obsm.gauge(
    "worklist_pruned_frac", "pruned tile fraction of the most recent build")


@dataclass(frozen=True)
class Worklist:
    """Kept tile pairs in CSR form over row tiles.

    Row tile ``t`` owns entries ``row_ptr[t] .. row_ptr[t+1]``, sorted by
    ascending ``lb`` (ties in column-tile order).
    """

    row_ptr: torch.Tensor       # (nbr + 1,) int32
    col_tile: torch.Tensor      # (W,) int32
    in_cut: torch.Tensor        # (W,) bool: lb <= d_cut^2, the count's pairs
    lb: torch.Tensor            # (W,) f32 lower bound of the pair's d2
    n_kept: int                 # W
    n_total: int                # nbr * nbc, the dense tile-pair count

    @property
    def pruned_frac(self) -> float:
        return 1.0 - self.n_kept / max(self.n_total, 1)

    @property
    def num_row_tiles(self) -> int:
        return self.row_ptr.numel() - 1

    @property
    def nbytes(self) -> int:
        """Bytes of its four tensors on their device (9 an entry)."""
        return sum(t.numel() * t.element_size() for t in
                   (self.row_ptr, self.col_tile, self.in_cut, self.lb))

    def row_tile(self) -> torch.Tensor:
        """(W,) int64 row tile of every entry."""
        counts = (self.row_ptr[1:] - self.row_ptr[:-1]).long()
        return torch.repeat_interleave(
            torch.arange(self.num_row_tiles, device=counts.device), counts)


def tile_bounds(x: torch.Tensor, block: int):
    """Per-tile AABB (lo, hi), each (ceil(n / block), d): the ragged last
    tile is bounded by its real rows only."""
    n, d = x.shape
    nb = -(-n // block)
    lo = torch.full((nb * block, d), float("inf"), dtype=torch.float32,
                    device=x.device)
    hi = torch.full_like(lo, float("-inf"))
    lo[:n] = x
    hi[:n] = x
    return (lo.view(nb, block, d).amin(1), hi.view(nb, block, d).amax(1))


def pair_bounds(rlo, rhi, clo, chi):
    """(lb, ub), each (nbr, nbc) f32: the least and largest squared
    distance between a row box and a column box, summed over dims in
    order (as ``direct_d2``), then shrunk / grown."""
    lb = ub = None
    for k in range(rlo.shape[1]):
        gap = torch.maximum(clo[None, :, k] - rhi[:, None, k],
                            rlo[:, None, k] - chi[None, :, k]).clamp_min(0.0)
        reach = torch.maximum(chi[None, :, k] - rlo[:, None, k],
                              rhi[:, None, k] - clo[None, :, k]).clamp_min(0.0)
        g2, r2 = gap * gap, reach * reach
        lb = g2 if lb is None else lb + g2
        ub = r2 if ub is None else ub + r2
    return lb * LB_SHRINK, ub * UB_GROW


def knn_radius(ub: torch.Tensor, col_counts: torch.Tensor,
               k: int) -> torch.Tensor:
    """Per row tile, the smallest upper bound v such that the column tiles
    with ub <= v hold at least k candidates (+inf if all of y holds fewer):
    a pair whose lb exceeds it has k strictly closer candidates and never
    enters the row's kept k.

    The reference sorts ub per row tile and walks the cumulative counts
    (``_knn_radius``; ``_knn_walk`` here).  Where the tiles holding fewer
    than k candidates hold fewer than k together (all of y: only the last
    tile is short, since ``BLOCK_M >= k``), that walk stops at the first
    tile that holds k alone, so the radius is the least ub over such
    tiles, with no sort.  A gate's per-tile counts (S-Approx-DPC) take the
    walk.
    """
    small = col_counts < k
    if int(col_counts[small].sum()) >= k:
        return _knn_walk(ub, col_counts, k)
    return torch.where(small[None, :], float("inf"), ub).amin(1)


def _knn_walk(ub: torch.Tensor, col_counts: torch.Tensor,
              k: int) -> torch.Tensor:
    """The reference's walk: sort ub per row tile, sum the counts in that
    order, take the ub of the first prefix that holds k."""
    ub_sorted, o = torch.sort(ub, dim=1)
    cum = torch.cumsum(col_counts[o], dim=1)
    reach = (cum < k).sum(1, keepdim=True).clamp(max=ub.shape[1] - 1)
    radius = ub_sorted.gather(1, reach)[:, 0]
    return torch.where(cum[:, -1] >= k, radius, float("inf"))


def _span_reach(starts: torch.Tensor, ends: torch.Tensor, n: int,
                nbr: int, dev) -> tuple[torch.Tensor, torch.Tensor]:
    """Per row tile, (least start, largest end) of its rows' live spans
    (end > start), each (nbr,) int64; a tile with none gets (int64 max,
    int64 min), which reaches no column tile."""
    if starts is None or ends is None:
        raise ValueError("the halo forms need both starts and ends")
    st = torch.as_tensor(starts, device=dev).long()
    en = torch.as_tensor(ends, device=dev).long()
    if st.shape != en.shape or st.dim() != 2 or st.shape[0] != n:
        raise ValueError(f"starts {tuple(st.shape)} and ends "
                         f"{tuple(en.shape)} for {n} rows: expected (n, S)")
    live = en > st
    big = torch.iinfo(torch.int64)
    # rows past n (the ragged last tile's) have no live span
    smin = torch.full((nbr * BLOCK_N,), big.max, dtype=torch.int64,
                      device=dev)
    emax = torch.full((nbr * BLOCK_N,), big.min, dtype=torch.int64,
                      device=dev)
    if st.shape[1]:
        smin[:n] = torch.where(live, st, big.max).amin(1)
        emax[:n] = torch.where(live, en, big.min).amax(1)
    return (smin.view(nbr, BLOCK_N).amin(1), emax.view(nbr, BLOCK_N).amax(1))


_FORMS = {(True, "topk", False, False), (True, None, False, False),
          (False, "best1", False, False), (True, None, False, True),
          (False, "best1", True, True)}


# ------------------------------------------------------- the worklist cache
# A plan keeps an LRU of its built worklists, as the reference's does
# (8 entries), trimmed by size.  The reference caps host tables at 64 MiB
# (``repro/kernels/blocksparse.py:443``); here the cap counts the
# worklists' device bytes, and the planner holds all plans' worklists
# together to it.  It is sized for the 5.8M Airline Approx-DPC fit, whose
# K3 worklist holds 46,762,768 entries of 9 bytes (col_tile int32, in_cut
# bool, lb f32) and 22,699 row pointers, about 421 MB: 64 MiB would never
# hold it, and 1 GiB holds two such plans' (the f32 and bf16 fits of the
# same points), 1.3 % of an 80 GB card.
WL_CACHE_MAX_ENTRIES = 8
WL_CACHE_MAX_BYTES = 1 << 30

_WL_CACHE_STACK: list = []


@contextmanager
def worklist_cache(cache):
    """Activate ``cache`` (a MutableMapping, LRU-trimmed, oldest first, to
    ``WL_CACHE_MAX_ENTRIES`` and to ``WL_CACHE_MAX_BYTES`` of worklist
    device bytes; the newest entry always stays) for the
    ``build_flat_worklist`` calls inside the context; the innermost active
    cache serves them."""
    _WL_CACHE_STACK.append(cache)
    try:
        yield cache
    finally:
        _WL_CACHE_STACK.pop()


@contextmanager
def suspend_counters():
    """Scope inside which worklist instrumentation is discarded: on exit
    every worklist metric family is restored to its value at entry."""
    saved = [(m, m._state()) for m in
             (_M_BUILDS, _M_CACHE_HITS, _M_FP_MISSES, _G_WL_LEN,
              _G_WL_PRUNED)]
    try:
        yield
    finally:
        for m, state in saved:
            m._restore(state)


def worklist_build_count() -> int:
    return int(_M_BUILDS.value())


def worklist_cache_hits() -> int:
    return int(_M_CACHE_HITS.value())


def worklist_fingerprint_misses() -> int:
    return int(_M_FP_MISSES.value())


# The fingerprint's two lanes: a prime below 2^31 and a multiplier each.
# The primes' product exceeds 2^32, so no change of one 32-bit word is a
# multiple of both.
_FP_LANES = ((2_147_483_647, 1_000_003), (2_147_483_629, 7_919))
_FP_CHUNK = 1 << 22     # words a step
_FP_ROW = 1 << 14       # products (each < 2^48) summed before a reduction


def _words(t: torch.Tensor) -> torch.Tensor:
    """(k,) int32 words of ``t``'s values in row-major order, on its device:
    4-byte types as they are, 8-byte ones as two words each, narrower ones
    widened (2-byte floats by their bits)."""
    t = t.reshape(-1).contiguous()
    if t.dtype in (torch.float16, torch.bfloat16):
        return t.view(torch.int16).to(torch.int32)
    if t.dtype == torch.bool or t.element_size() < 4:
        return t.to(torch.int32)
    return t.view(torch.int32)


def fingerprint(t: torch.Tensor) -> tuple[int, int]:
    """Two residues of ``t``'s words, computed where ``t`` lies with integer
    torch ops (so the same on the CPU and the card; nothing is copied to
    the host but the two results).

    Each 32-bit word u_i (as unsigned) enters lane p as
    lo_i * a_i + hi_i * (a_i * 2^16 mod p), its 16-bit halves weighted by a
    position-dependent multiplier a_i = 1 + (i * mult mod (p - 1)), nonzero
    mod p: that is u_i * a_i mod p, summed over i mod p.  Products stay
    below 2^48 and are summed 2^14 at a time before a reduction, so no int64
    overflows.  One changed word moves lane p by (u' - u) * a_i, nonzero
    unless p divides u' - u; as 0 < |u' - u| < 2^32 is below the lanes'
    product of primes, at least one lane changes."""
    w = _words(t)
    n = w.numel()
    acc = torch.zeros((len(_FP_LANES),), dtype=torch.int64, device=w.device)
    for s0 in range(0, n, _FP_CHUNK):
        u = w[s0:s0 + _FP_CHUNK].to(torch.int64) & 0xFFFFFFFF
        lo, hi = u & 0xFFFF, u >> 16
        idx = torch.arange(s0, s0 + u.numel(), dtype=torch.int64,
                           device=w.device)
        pad = -u.numel() % _FP_ROW
        for j, (p, mult) in enumerate(_FP_LANES):
            a = (idx % (p - 1)) * mult % (p - 1) + 1
            v = lo * a + hi * ((a << 16) % p)
            if pad:
                v = torch.nn.functional.pad(v, (0, pad))
            acc[j] = (acc[j] + (v.view(-1, _FP_ROW).sum(1) % p).sum()) % p
    return tuple(acc.tolist())


def _fp_part(h, a) -> None:
    """Feed ``a`` (a tensor, an array or None) into the blake2b ``h``: its
    shape, dtype and fingerprint."""
    if a is None:
        h.update(b"\x00none")
        return
    t = torch.as_tensor(a)
    h.update(repr((tuple(t.shape), str(t.dtype), fingerprint(t))).encode())


def _wl_key(x, y, src_dtypes, thr, knobs, nn_col_counts, starts,
            ends) -> bytes:
    """The cache key: blake2b over the fingerprints, shapes and dtypes of
    everything the build reads (the f32 points, the column counts, the
    spans), the source dtypes, the device, the f32 threshold, the tile
    shape and the form knobs."""
    h = hashlib.blake2b(digest_size=16)
    _fp_part(h, x)
    if y is x:
        h.update(b"\x00same")
    else:
        _fp_part(h, y)
    for a in (nn_col_counts, starts, ends):
        _fp_part(h, a)
    h.update(repr((src_dtypes, str(x.device), thr, BLOCK_N, BLOCK_M,
                   knobs)).encode())
    return h.digest()


def build_flat_worklist(x: torch.Tensor, y: torch.Tensor, d_cut=None, *,
                        count: bool = True, nn: str | None = "topk",
                        k: int = 8, nn_dcut: bool = False,
                        nn_col_counts: torch.Tensor | None = None,
                        starts: torch.Tensor | None = None,
                        ends: torch.Tensor | None = None) -> Worklist:
    """A worklist of x's ``BLOCK_N``-row tiles over y's ``BLOCK_M``-row
    column tiles (the reference's ``build_flat_worklist`` at that tile
    shape), built on the points' device.  Five forms:

    * ``count=True, nn="topk"`` (default; K3): kept ``lb <= d_cut^2``
      (``in_cut``) or ``lb <= knn_radius``;
    * ``count=True, nn=None`` (K8): kept ``in_cut``;
    * ``count=False, nn="best1"`` (K9, ``d_cut`` unused): every tile pair,
      ``in_cut`` False;
    * the halo forms, with ``starts``/``ends`` ((n, S) window-local
      [start, end) spans of x's rows into y, the window): a row tile
      reaches column tile j where the least start and the largest end of
      its live spans (end > start) give ``smin < (j+1) * BLOCK_M`` and
      ``emax > j * BLOCK_M``.  ``count=True, nn=None`` (K15) keeps
      ``in_cut = lb <= d_cut^2`` AND reached; ``count=False,
      nn="best1", nn_dcut=True`` (K16, the NN within d_cut) keeps the same
      pairs with ``in_cut`` False.

    The least-lb pair of every row tile is kept too, so every row tile has
    an entry (its ``in_cut`` False where no span reaches it).  Entries are
    ordered by row tile, then ascending ``lb``, ties in column order.  The
    threshold is ``float(d_cut) ** 2`` rounded once to f32, as the
    reference compares it with its f32 bounds.  ``nn_col_counts``
    ((column tiles,) int) counts the columns of each tile that may enter
    the kept k (a gated sweep's selected columns); by default every column
    may.

    Inside a :func:`worklist_cache` scope a sweep worklist (every form but
    ``nn="best1"``) is memoized by the content fingerprint of the inputs
    and every knob (:func:`_wl_key`).  A best-1 ring is built every time:
    on the 5.8M fit the ring's lookup, which fingerprints all its columns,
    took longer than its build (PERF.md §5).
    """
    halo = starts is not None or ends is not None
    if (count, nn, bool(nn_dcut), halo) not in _FORMS:
        raise ValueError(f"worklist form count={count!r}, nn={nn!r}, "
                         f"nn_dcut={nn_dcut!r}, spans={halo} is not ported "
                         f"(topk with count, count alone, best1 alone, or "
                         f"with spans count alone or best1 with nn_dcut)")
    if BLOCK_M < k:
        raise ValueError(f"BLOCK_M={BLOCK_M} must hold the kept k={k}")
    # the dtypes the caller handed in, before the cast to f32: the same
    # coordinates at another source precision are another cache identity,
    # as in the reference (the sweeps read the original tensors)
    src_dtypes = (str(x.dtype), str(y.dtype))
    same = y is x
    x = x.to(torch.float32)
    y = x if same else y.to(torch.float32)
    thr = float(np.float32(float(d_cut) ** 2)) if count or nn_dcut else 0.0
    key = None
    if _WL_CACHE_STACK and nn != "best1":
        cache = _WL_CACHE_STACK[-1]
        with obs.span("worklist.fingerprint", n=x.shape[0],
                      m=y.shape[0]) as sp:
            # the lanes reached the host, so the device work is done
            key = sp.sync(_wl_key(x, y, src_dtypes, thr,
                                  (bool(count), nn, int(k), bool(nn_dcut)),
                                  nn_col_counts, starts, ends))
        hit = cache.get(key)
        if hit is not None:
            _M_CACHE_HITS.inc()
            if hasattr(cache, "move_to_end"):
                cache.move_to_end(key)
            return hit
        _M_FP_MISSES.inc()
    dev = x.device
    n, m = x.shape[0], y.shape[0]
    nbr, nbc = -(-n // BLOCK_N), -(-m // BLOCK_M)
    _M_BUILDS.inc()
    rlo, rhi = tile_bounds(x, BLOCK_N)
    clo, chi = tile_bounds(y, BLOCK_M)
    if nn_col_counts is None:
        col_counts = (m - torch.arange(nbc, device=dev) * BLOCK_M).clamp(
            0, BLOCK_M)
    else:
        col_counts = torch.as_tensor(nn_col_counts, device=dev).long()
        if col_counts.shape != (nbc,):
            raise ValueError(f"nn_col_counts of shape "
                             f"{tuple(col_counts.shape)} for {nbc} column "
                             f"tiles")
    if halo:
        smin, emax = _span_reach(starts, ends, n, nbr, dev)
        jlo = torch.arange(nbc, device=dev, dtype=torch.int64) * BLOCK_M

    per_row, cols, cuts, lbs = [], [], [], []
    step = max(1, _CHUNK_PAIRS // max(nbc, 1))
    for r0 in range(0, nbr, step):
        r1 = min(nbr, r0 + step)
        lb, ub = pair_bounds(rlo[r0:r1], rhi[r0:r1], clo, chi)
        if nn == "best1" and not nn_dcut:
            # every pair: a per-row sort is np.lexsort((lb, row tile))
            wl, wj = torch.sort(lb, dim=1, stable=True)
            per_row.append(torch.full((r1 - r0,), nbc, device=dev))
            cols.append(wj.flatten().to(torch.int32))
            cuts.append(torch.zeros((wl.numel(),), dtype=torch.bool,
                                    device=dev))
            lbs.append(wl.flatten())
            continue
        in_cut = lb <= thr
        keep = in_cut.clone()
        if nn == "topk":
            keep |= lb <= knn_radius(ub, col_counts, k)[:, None]
        if halo:
            reach = ((smin[r0:r1, None] < jlo + BLOCK_M)
                     & (emax[r0:r1, None] > jlo))
            keep &= reach
            in_cut &= reach
        if not count:
            in_cut.zero_()
        rows = torch.arange(r1 - r0, device=dev)
        keep[rows, lb.argmin(1)] = True
        wi, wj = torch.nonzero(keep, as_tuple=True)      # row-major
        wl = lb[wi, wj]
        # np.lexsort((wl, wi)): by row tile, then lb, ties in column order
        o = torch.sort(wl, stable=True).indices
        o = o[torch.sort(wi[o], stable=True).indices]
        wi, wj, wl = wi[o], wj[o], wl[o]
        per_row.append(keep.sum(1))
        cols.append(wj.to(torch.int32))
        cuts.append(in_cut[wi, wj])
        lbs.append(wl)

    counts = torch.cat(per_row) if per_row else torch.zeros(
        (0,), dtype=torch.int64, device=dev)
    row_ptr = torch.zeros((nbr + 1,), dtype=torch.int64, device=dev)
    row_ptr[1:] = torch.cumsum(counts, 0)
    n_kept = int(row_ptr[-1])
    if n_kept >= 2**31:
        raise ValueError(f"{n_kept} worklist entries exceed int32 indexing")
    out = Worklist(
        row_ptr=row_ptr.to(torch.int32),
        col_tile=torch.cat(cols) if cols else torch.zeros(
            (0,), dtype=torch.int32, device=dev),
        in_cut=torch.cat(cuts) if cuts else torch.zeros(
            (0,), dtype=torch.bool, device=dev),
        lb=torch.cat(lbs) if lbs else torch.zeros(
            (0,), dtype=torch.float32, device=dev),
        n_kept=n_kept, n_total=nbr * nbc)
    _G_WL_LEN.set(out.n_kept)
    _G_WL_PRUNED.set(round(out.pruned_frac, 6))
    if key is not None:
        cache[key] = out
        while len(cache) > 1 and (
                len(cache) > WL_CACHE_MAX_ENTRIES
                or sum(w.nbytes for w in cache.values())
                > WL_CACHE_MAX_BYTES):
            cache.pop(next(iter(cache)))    # the oldest entry
    return out


# ----------------------------------------------------------- the ring walk
# The reference backend's block-sparse form (``_count_bs_jnp``,
# ``_nn_ring_rows``, ``_denser_nn_bs_jnp``,
# ``repro/kernels/blocksparse.py:119-370``).  The reference selects each
# step's column tile by a one-hot contraction, only to keep sort-derived
# gather indices out of a jax 0.4.37 SPMD bug (``:19-34``); here the ring
# order is an index gather.  Both walks are exact: a pair is passed over
# only where its tile pair's lb (a lower bound of every d2 in it, shrunk by
# LB_SHRINK past the bound's own rounding) shows it cannot count or win.

_FINITE_CAP = 3e38
# (d2 bits << 32 | column) of "no candidate yet": (+inf, int32 max)
_NO_WINNER = (0x7F800000 << 32) | (2**31 - 1)


def _finitize(a: torch.Tensor) -> torch.Tensor:
    """Coordinates clamped into +-3e38: a padded column row (+inf) at the
    cap still squares past the f32 max against any row, so it never counts
    and never wins, and never meets a padded (+inf) row as inf - inf."""
    return a.clamp(-_FINITE_CAP, _FINITE_CAP)


def _tiled(a: torch.Tensor, block: int, value: float) -> torch.Tensor:
    """(ceil(r / block), block, ...) view of ``a`` padded with ``value``."""
    r = a.shape[0]
    nb = -(-r // block)
    out = torch.full((nb * block, *a.shape[1:]), value, dtype=a.dtype,
                     device=a.device)
    out[:r] = a
    return out.view(nb, block, *a.shape[1:])


def _lb_chunks(x: torch.Tensor, y: torch.Tensor, bn: int, bm: int):
    """(first row tile, lb) over chunks of x's ``bn``-row tiles: lb
    (tiles, nbc) the lower bounds against y's ``bm``-row tiles."""
    rlo, rhi = tile_bounds(x, bn)
    clo, chi = tile_bounds(y, bm)
    step = max(1, _CHUNK_PAIRS // max(clo.shape[0], 1))
    for t0 in range(0, rlo.shape[0], step):
        yield t0, pair_bounds(rlo[t0:t0 + step], rhi[t0:t0 + step], clo,
                              chi)[0]


def _pair_d2(xt: torch.Tensor, yt: torch.Tensor, ti: torch.Tensor,
             tj: torch.Tensor) -> torch.Tensor:
    """(E, bn, bm) direct-difference d2 of row tiles ``ti`` against column
    tiles ``tj`` (``sweep.direct_d2``, the kernels' arithmetic)."""
    from .sweep import direct_d2       # sweep imports this module
    return direct_d2(xt[ti][:, :, None, :], yt[tj][:, None, :, :])


def ring_range_count(x: torch.Tensor, y: torch.Tensor, d_cut,
                     weights: torch.Tensor | None = None):
    """(n,) f32: per x row the count of y rows with d2 < f32(d_cut)^2, or
    with ``weights`` ((m,), the signs of the stream's delta batch) their
    sum over those rows.  Only the tile pairs with lb <= d_cut^2 (the
    reference's count prefix of the ring) are evaluated.  Every partial sum
    is an integer below 2^24, so the result equals the dense count bit for
    bit, in any order of summation."""
    from .sweep import d2cut_of
    n, m = x.shape[0], y.shape[0]
    bn, bm = BS_BLOCK_N, BS_BLOCK_M
    if n == 0 or m == 0:
        return torch.zeros((n,), dtype=torch.float32, device=x.device)
    xt = _tiled(x.to(torch.float32), bn, float("inf"))
    yt = _finitize(_tiled(y.to(torch.float32), bm, float("inf")))
    wt = None if weights is None else _tiled(weights.to(torch.float32), bm,
                                             0.0)
    d2cut = d2cut_of(d_cut)
    acc = torch.zeros((xt.shape[0], bn), dtype=torch.float32,
                      device=x.device)
    batch = max(1, _ENTRY_PAIRS // (bn * bm))
    for t0, lb in _lb_chunks(x, y, bn, bm):
        ti, tj = torch.nonzero(lb <= d2cut, as_tuple=True)
        ti = ti + t0
        for e0 in range(0, ti.numel(), batch):
            a, b = ti[e0:e0 + batch], tj[e0:e0 + batch]
            inside = _pair_d2(xt, yt, a, b) < d2cut
            upd = (inside.sum(2, dtype=torch.float32) if wt is None
                   else torch.where(inside, wt[b][:, None, :], 0.0).sum(2))
            acc.index_add_(0, a, upd)
    return acc.flatten()[:n]


def ring_denser_nn(x: torch.Tensor, x_key: torch.Tensor, y: torch.Tensor,
                   y_key: torch.Tensor):
    """Per x row: the nearest y row with a key strictly greater (keys in
    f32, as the reference casts them), as (best d2 f32, index i32),
    lexicographic on (d2, index); (+inf, -1) where none qualifies.

    Each row tile walks its column tiles in ascending lb (ties in tile
    order) and stops at the first whose lb exceeds the worst current best
    among its real rows: every later pair is strictly worse for every row.
    The walk advances all live row tiles together, a step of entries at a
    time, the step doubling each round, so the longest walk takes a
    logarithmic count of rounds; a step may pass a tile's stop, which
    evaluates more pairs and changes no answer.  Winners merge as the
    minimum of (d2 bits << 32 | column), the reference's lexicographic tie
    rule (``_nn_ring_rows``)."""
    n, m = x.shape[0], y.shape[0]
    bn, bm = BS_BLOCK_N, BS_BLOCK_M
    dev = x.device
    best = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
    parent = torch.full((n,), -1, dtype=torch.int32, device=dev)
    if n == 0 or m == 0:
        return best, parent
    xt = _tiled(x.to(torch.float32), bn, float("inf"))
    yt = _finitize(_tiled(y.to(torch.float32), bm, float("inf")))
    rk = _tiled(x_key.to(torch.float32), bn, float("inf"))
    ck = _tiled(y_key.to(torch.float32), bm, float("-inf"))
    nbr, nbc = xt.shape[0], yt.shape[0]
    real = (torch.arange(nbr * bn, device=dev) < n).view(nbr, bn)
    win = torch.full((nbr, bn), _NO_WINNER, dtype=torch.int64, device=dev)
    lane = torch.arange(bn, device=dev)
    batch = max(1, _ENTRY_PAIRS // (bn * bm))
    for t0, lb in _lb_chunks(x, y, bn, bm):
        t1 = t0 + lb.shape[0]
        lbs, order = torch.sort(lb, dim=1, stable=True)
        p = torch.zeros((t1 - t0,), dtype=torch.int64, device=dev)
        step = 1
        while True:
            cur = (win[t0:t1] >> 32).to(torch.int32).view(torch.float32)
            worst = torch.where(real[t0:t1], cur, float("-inf")).amax(1)
            next_lb = lbs.gather(1, p.clamp(max=nbc - 1)[:, None])[:, 0]
            live = torch.nonzero((p < nbc) & (next_lb <= worst)).flatten()
            if live.numel() == 0:
                break
            pos = p[live, None] + torch.arange(step, device=dev)
            ok = pos < nbc
            ti = (live[:, None] + t0).expand_as(pos)[ok]
            tj = order[live[:, None], pos.clamp(max=nbc - 1)][ok]
            for e0 in range(0, ti.numel(), batch):
                a, b = ti[e0:e0 + batch], tj[e0:e0 + batch]
                d2 = _pair_d2(xt, yt, a, b)
                d2 = torch.where(ck[b][:, None, :] > rk[a][:, :, None], d2,
                                 float("inf"))
                v, j = d2.min(dim=2)          # the first column among equal
                key = (v.view(torch.int32).to(torch.int64) << 32) \
                    | (b[:, None] * bm + j)
                win.view(-1).scatter_reduce_(
                    0, (a[:, None] * bn + lane).flatten(), key.flatten(),
                    "amin")
            p[live] += step
            step = min(2 * step, nbc)
    win = win.view(-1)[:n]
    best = (win >> 32).to(torch.int32).view(torch.float32)
    found = torch.isfinite(best)
    parent = torch.where(found, win & 0xFFFFFFFF, -1).to(torch.int32)
    return best, parent
