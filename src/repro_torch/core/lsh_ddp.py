"""LSH-DDP baseline [Zhang et al., TKDE'16]: the paper's approximate
competitor (§2.2, §6), the port of ``repro/core/lsh_ddp.py``.

p-stable compound LSH partitions the points into buckets; rho and the
dependent point are approximated *within* each point's bucket, and points
that find no denser point in any bucket fall back to a full scan.  M
independent rounds refine the estimates: rho is the max over rounds
(in-bucket counts only undercount), delta the min (strict, so the earliest
round wins a tie).

Each round draws its projections and offsets with ``core/threefry.py``,
the same draws as the reference's ``jax.random`` for the same seed.  The
projection is a sum over dims in order, one f32 rounding per operation.
XLA's CPU dot sums in another order, so a bucket id can differ from the
reference's where a projection lies within an ulp or two of a bucket
boundary.

Rows sorted by bucket (a stable sort) scan one span of the sorted table,
``[bucket start, min(bucket start + cap, bucket end))``: the in-bucket rho
is the backend's ``range_count_halo`` over that span (K10 on the card) and
the in-bucket strictly-denser NN its ``denser_nn_halo`` with the d_cut
bound lifted (K11; ``d_cut = inf`` is ``d2cut = inf``, which every
candidate's finite d2 is below, in the kernel and in its plain version).
Rows of one bucket share their span, the case K10/K11's pieces are built
for.  The fallback is the backend's ``denser_nn`` of the rows still at inf
against all points (K2).  The spans are the pruning, so both span passes
and the fallback take the dense layout whatever the plan's.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import obs
from ..engine.planner import as_plan
from . import threefry
from .device import as_points
from .dpc_types import DPCResult, with_jitter

__all__ = ["Buckets", "bucket_ids", "partition", "in_bucket_rho",
           "in_bucket_nn", "round_keys", "run_lsh_ddp"]

_MIX = 1000003          # the bucket-id mixing multiplier (int64, wrapping)


class Buckets(NamedTuple):
    """One round's compound-LSH partition."""

    order: torch.Tensor   # (n,) int64: the rows in bucket order (stable)
    starts: torch.Tensor  # (n, 1) int32: a sorted row's span start
    ends: torch.Tensor    # (n, 1) int32: its span end
    cap: int              # the longest span
    count: int            # the buckets


def round_keys(seed: int, M: int, device=None) -> list[torch.Tensor]:
    """The M rounds' keys: ``key, sub = split(key)`` from ``PRNGKey(seed)``."""
    key = threefry.prng_key(seed, device)
    subs = []
    for _ in range(M):
        key, sub = threefry.split(key)
        subs.append(sub)
    return subs


def bucket_ids(points: torch.Tensor, key: torch.Tensor, d_cut: float,
               L: int) -> torch.Tensor:
    """One round's (n,) int64 bucket ids (``repro/core/lsh_ddp.py:29-36``):
    L hashes ``floor((p . a_l + b_l) / w)`` with w = 2 d_cut, a ~ N(0, I)
    and b ~ U(0, w), mixed into one id with int64 wraparound.  The draws
    are made on the key's device and moved to the points'."""
    n, d = points.shape
    dev = points.device
    w = torch.tensor(np.float32(2.0 * d_cut), device=key.device)
    ka, kb = threefry.split(key)
    a = threefry.normal(ka, (d, L)).to(dev)
    b = (threefry.uniform(kb, (L,)) * w).to(dev)
    w = w.to(dev)
    proj = points[:, :1] * a[0]
    for k in range(1, d):
        proj = proj + points[:, k:k + 1] * a[k]
    h = torch.floor(threefry.div_f32(proj + b, w)).long()
    bid = torch.zeros((n,), dtype=torch.int64, device=dev)
    for col in range(L):
        bid = bid * _MIX + h[:, col]
    return bid


def partition(bid: torch.Tensor, cap: int | None = None) -> Buckets:
    """The rows stably sorted by bucket id, and each sorted row's span
    ``[bucket start, min(bucket start + cap, bucket end))``; ``cap``
    (default: the largest bucket) cuts each span to its first slots."""
    n, dev = bid.shape[0], bid.device
    order = torch.argsort(bid, stable=True)
    bs = bid[order]
    is_first = torch.ones((n,), dtype=torch.bool, device=dev)
    is_first[1:] = bs[1:] != bs[:-1]
    first = torch.nonzero(is_first).flatten()
    last = torch.cat([first[1:], torch.tensor([n], device=dev)])
    seg = torch.cumsum(is_first, 0) - 1
    big = int((last - first).max()) if n else 0
    cap = big if cap is None else min(int(cap), big)
    start = first[seg]
    end = torch.minimum(start + cap, last[seg])
    return Buckets(order, start.to(torch.int32)[:, None].contiguous(),
                   end.to(torch.int32)[:, None].contiguous(), cap,
                   int(first.numel()))


def in_bucket_rho(be, points: torch.Tensor, bk: Buckets,
                  d_cut: float) -> torch.Tensor:
    """(n,) f32, original order: each row's count within d_cut over its
    span (``range_count_halo``: K10 on the card)."""
    pts_s = points[bk.order]
    rho_s = be.range_count_halo(pts_s, pts_s, bk.starts, bk.ends, d_cut,
                                span_cap=bk.cap)
    rho = torch.empty_like(rho_s)
    rho[bk.order] = rho_s
    return rho


def in_bucket_nn(be, points: torch.Tensor, rho_key: torch.Tensor,
                 bk: Buckets):
    """(delta, parent int64), original order: each row's nearest strictly
    denser row inside its span, with no d_cut bound (``denser_nn_halo``
    at d_cut = inf: K11 on the card); (inf, -1) where none.  Equal
    distances go to the lowest sorted slot."""
    pts_s, rk_s = points[bk.order], rho_key[bk.order]
    dl_s, par_s, _ = be.denser_nn_halo(pts_s, rk_s, pts_s, rk_s, bk.starts,
                                       bk.ends, float("inf"),
                                       span_cap=bk.cap)
    par_s = torch.where(par_s >= 0, bk.order[par_s.long().clamp_min(0)], -1)
    delta = torch.empty_like(dl_s)
    delta[bk.order] = dl_s
    parent = torch.empty_like(par_s)
    parent[bk.order] = par_s
    return delta, parent


def run_lsh_ddp(points, d_cut: float, *, M: int = 4, L: int = 3,
                cap: int | None = None, block: int = 64, seed: int = 0,
                fallback_block: int = 4096, exec_spec=None) -> DPCResult:
    """A tensor runs on its own device; anything else goes to the card.
    ``block`` and ``fallback_block`` (the reference's static chunks) are
    accepted and unused: the span passes take each row's own span and the
    fallback searches only the unresolved rows."""
    del block, fallback_block
    points = as_points(points)
    be = as_plan(exec_spec, points).backend
    n = points.shape[0]
    dev = points.device
    rho_best = torch.zeros((n,), dtype=torch.float32, device=dev)
    rounds = []
    # the draws are a few words: made on the host, as a handful of
    # threefry rounds would be hundreds of tiny launches on the card
    for r, key in enumerate(round_keys(seed, M)):
        with obs.span("lsh_ddp.buckets", round=r) as sp:
            bk = partition(bucket_ids(points, key, d_cut, L), cap)
            sp.set(cap=bk.cap, buckets=bk.count)
        with obs.span("lsh_ddp.rho", round=r) as sp:
            rho_best = sp.sync(torch.maximum(
                rho_best, in_bucket_rho(be, points, bk, d_cut)))
        rounds.append(bk)

    rho_key = with_jitter(rho_best)
    delta = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
    parent = torch.full((n,), -1, dtype=torch.int64, device=dev)
    for r, bk in enumerate(rounds):
        with obs.span("lsh_ddp.delta", round=r) as sp:
            dl, par = in_bucket_nn(be, points, rho_key, bk)
            better = dl < delta         # strict: the earliest round wins
            delta = torch.where(better, dl, delta)
            parent = sp.sync(torch.where(better, par, parent))

    unresolved = torch.nonzero(~torch.isfinite(delta)).flatten()
    with obs.span("lsh_ddp.fallback", unresolved=unresolved.numel()) as sp:
        if unresolved.numel():
            fd, fp = be.denser_nn(points[unresolved], rho_key[unresolved],
                                  points, rho_key)
            delta[unresolved] = fd
            parent[unresolved] = fp.long()
        sp.sync(delta)
    return DPCResult(rho=rho_best, rho_key=rho_key, delta=delta,
                     parent=parent.to(torch.int32))
