"""CFSFDP-A baseline [Bai et al., Pattern Recognition'17]: the paper's
exact competitor (§2.2, §6), the port of ``repro/core/cfsfdp_a.py``.

k-means pivots and the triangle inequality filter each point's candidate
set for the rho range count: a point skips cluster c when
``|p - pivot_c| - r_c >= d_cut`` (r_c the cluster's radius), since no
point of c can then lie within d_cut of it.  As in the paper's own
experiments, the dependent distances use Scan's approach (Table 1 notes
CFSFDP-A's own delta step is Omega(n^2) and slower than Scan's).

The k-means pivots start from ``core/threefry.py``'s ``choice``, the same
draw as the reference's ``jax.random.choice`` for the same seed.  rho is
the backend's ``range_count_halo`` (K10 on the card) of every point over k
spans of the cluster-sorted table: the windows of the clusters that
survive its filter, empty where pruned.  The windows are disjoint, as K10
requires.  delta and parent are the backend's ``denser_nn`` of all points
against all points (K2).  On the card the k-means sums are atomic adds, so
the centroids may differ in their last bits from run to run; only the
filter reads them, and it keeps every cluster that can hold a point within
d_cut (up to f32 rounding at its margin), so rho does not change.
"""
from __future__ import annotations

import torch

from .. import obs
from ..analysis.audit import audit_determinism
from ..engine.planner import as_plan
from . import threefry
from .device import as_points
from .dpc_types import DPCResult, with_jitter

__all__ = ["sq_dists", "kmeans_pivots", "triangle_keep", "cluster_windows",
           "row_spans", "pattern_order", "run_cfsfdp_a"]


def sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(|a|, |b|) squared distances in the reference's expanded form
    ``max(|a|^2 + |b|^2 - 2 a.b, 0)`` (``repro/core/grid.py:234-239``),
    each sum over dims in order."""
    a2 = b2 = ab = None
    for k in range(a.shape[1]):
        ak, bk = a[:, k], b[:, k]
        terms = (ak * ak, bk * bk, ak[:, None] * bk[None, :])
        if a2 is None:
            a2, b2, ab = terms
        else:
            a2, b2, ab = a2 + terms[0], b2 + terms[1], ab + terms[2]
    return torch.clamp_min(a2[:, None] + b2[None, :] - 2.0 * ab, 0.0)


@audit_determinism(
    "the cluster counts are integer-valued, exact in f32 in any order; the "
    "coordinate sums are float atomics on the card, so the centroids move "
    "in their last bits between runs; only the triangle filter reads them, "
    "and it keeps every cluster that can hold a point within d_cut (up to "
    "f32 rounding at its margin), so the fit's rho and parent do not move: "
    "phase 31 of chip_smoke.py fits 2^20 points twice and holds both equal "
    "bit for bit",
    ops=("index_add_",))
def kmeans_pivots(points: torch.Tensor, k: int, iters: int = 10,
                  seed: int = 0):
    """k pivots by Lloyd's k-means from ``choice(PRNGKey(seed), n, (k,),
    replace=False)``; a cluster left empty keeps its centroid.  Returns
    (centroids (k, d), assignment (n,) int64)."""
    n = points.shape[0]
    init = threefry.choice(threefry.prng_key(seed, points.device), n, (k,))
    cents = points[init]
    ones = torch.ones((n,), dtype=torch.float32, device=points.device)
    for _ in range(iters):
        assign = torch.argmin(sq_dists(points, cents), dim=1)
        sums = torch.zeros_like(cents).index_add_(0, assign, points)
        cnts = torch.zeros((k,), dtype=torch.float32,
                           device=points.device).index_add_(0, assign, ones)
        cents = torch.where(cnts[:, None] > 0,
                            sums / cnts.clamp_min(1.0)[:, None], cents)
    return cents, torch.argmin(sq_dists(points, cents), dim=1)


def triangle_keep(points: torch.Tensor, cents: torch.Tensor,
                  assign: torch.Tensor, d_cut: float) -> torch.Tensor:
    """(n, k) bool: cluster c may hold a point within d_cut of the row,
    ``|p - pivot_c| - r_c < d_cut``, the pivot distance in the expanded
    form and r_c the largest direct distance of c's points to its pivot
    (-inf for an empty cluster, which is always pruned)."""
    k = cents.shape[0]
    own = torch.sqrt(((points - cents[assign]) ** 2).sum(dim=1))
    radius = torch.full((k,), float("-inf"), dtype=torch.float32,
                        device=points.device).scatter_reduce(
        0, assign, own, "amax")
    dp = torch.sqrt(sq_dists(points, cents))
    return dp - radius[None, :] < d_cut


def cluster_windows(assign: torch.Tensor, k: int):
    """The rows stably sorted by cluster, and the window ``[start, end)``
    of each cluster in that order, (k,) each, indexed by the cluster id.
    The reference reads its window starts, indexed by the rank of each
    non-empty cluster, by id (``repro/core/cfsfdp_a.py:59-61, 90``): past
    an empty cluster it counts the wrong rows."""
    order = torch.argsort(assign, stable=True)
    count = torch.bincount(assign, minlength=k)
    start = torch.cumsum(count, 0) - count
    return order, start, start + count


def row_spans(keep: torch.Tensor, start: torch.Tensor, end: torch.Tensor):
    """(n, k) int32 starts and ends of rows whose kept clusters are
    ``keep`` (n, k): cluster c's window where kept, empty where pruned."""
    return (torch.where(keep, start[None, :], 0).to(torch.int32),
            torch.where(keep, end[None, :], 0).to(torch.int32))


def pattern_order(keep: torch.Tensor) -> torch.Tensor:
    """A row order that puts rows with the same kept clusters next to each
    other (stable sorts by the mask, 62 clusters a word), so K10 sees long
    runs of rows sharing their spans."""
    n, k = keep.shape
    perm = torch.arange(n, device=keep.device)
    for w0 in reversed(range(0, k, 62)):
        bits = keep[:, w0:w0 + 62].long()
        weights = 2 ** torch.arange(bits.shape[1], device=keep.device)
        word = (bits * weights).sum(dim=1)
        perm = perm[torch.argsort(word[perm], stable=True)]
    return perm


def run_cfsfdp_a(points, d_cut: float, *, k: int = 32, block: int = 256,
                 scan_block: int = 1024, exec_spec=None) -> DPCResult:
    """A tensor runs on its own device; anything else goes to the card.
    ``block`` and ``scan_block`` (the reference's static chunks) are
    accepted and unused."""
    del block, scan_block
    points = as_points(points)
    be = as_plan(exec_spec, points).backend
    n = points.shape[0]
    k = min(k, n)
    with obs.span("cfsfdp_a.kmeans", n=n, k=k) as sp:
        cents, assign = sp.sync(kmeans_pivots(points, k))
    with obs.span("cfsfdp_a.rho", n=n) as sp:
        order, start, end = cluster_windows(assign, k)
        keep = triangle_keep(points, cents, assign, d_cut)
        rows = pattern_order(keep)
        starts, ends = row_spans(keep[rows], start, end)
        cnt = be.range_count_halo(points[rows], points[order], starts, ends,
                                  d_cut, span_cap=0)
        rho = torch.empty_like(cnt)
        rho[rows] = cnt
        sp.set(pruned=float(1.0 - keep.float().mean()),
               empty=int((end == start).sum()))
        sp.sync(rho)
    rho_key = with_jitter(rho)
    with obs.span("cfsfdp_a.delta", n=n) as sp:
        delta, parent = sp.sync(be.denser_nn(points, rho_key, points,
                                             rho_key))
    return DPCResult(rho=rho, rho_key=rho_key, delta=delta, parent=parent)
