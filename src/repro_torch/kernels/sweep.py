"""Sweep constants and the plain PyTorch versions of the hand-written CUDA
kernels in ``csrc/sweep.cu``.

The reference (``repro/kernels/sweep.py``) builds every DPC primitive from
one Pallas tile sweep over expanded-form distances |x|^2+|y|^2-2x.y fed to
the TPU's matrix unit, then re-ranks candidates in direct-difference form to
repair the expanded form's f32 cancellation.  On Hopper the f32 contract
rules out TF32 and the inner dimension is d = 2..8, so the matrix unit buys
nothing: the kernels compute **direct-difference** f32 distances on the CUDA
cores, and no re-rank is needed.

Arithmetic contract shared by the kernels and the plain versions here: the
squared distance of a pair is ``(x0-y0)^2``, then ``+ (xk-yk)^2`` for
k = 1..d-1 in order, each subtraction, product and sum rounded once
(``__fsub_rn``/``__fmul_rn``/``__fadd_rn`` in CUDA, one torch op each here),
so a kernel and its plain version agree bit for bit on the card.
"""
from __future__ import annotations

import numpy as np
import torch

from .blocksparse import BLOCK_M, BLOCK_N

# The admission bound: a real point at or beyond it is refused at the
# boundary (resilience.sanitize).  The CUDA kernels mask ragged edges
# themselves and never pad with it.
PAD_COORD = 1e9

# kept candidates per row in the fused count + kept-k sweep (compiled into
# csrc/sweep.cu as kTopK)
FUSED_TOPK = 8

# plain versions work on row blocks of at most this many pair distances
_PLAIN_PAIRS = 1 << 24


def d2cut_of(d_cut) -> float:
    """The f32 threshold ``f32(d_cut)**2``, rounded once, as the reference
    computes it (``jnp.asarray(d_cut, f32) ** 2``)."""
    c = np.float32(float(d_cut))
    return float(c * c)


def direct_d2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared distances between broadcast rows of ``a`` and ``b`` (last
    axis = coordinates), summed over dims 0..d-1 in order, one rounding per
    operation: the kernels' arithmetic."""
    d2 = None
    for k in range(a.shape[-1]):
        diff = a[..., k] - b[..., k]
        sq = diff * diff
        d2 = sq if d2 is None else d2 + sq
    return d2


def _row_block(m: int) -> int:
    return max(1, _PLAIN_PAIRS // max(m, 1))


def fused_count_topk_plain(x: torch.Tensor, y: torch.Tensor, d2cut: float,
                           k: int = FUSED_TOPK,
                           sel: torch.Tensor | None = None):
    """Per x-row: the count of y rows with d2 < d2cut (i32), and the k
    nearest (d2, index) pairs, lexicographic on (d2, index) — a stable sort
    over index-ordered columns.  Slots past m hold (+inf, -1).

    ``sel`` ((m,) bool) gates the kept-k: a column whose gate is 0 never
    enters it (slots past the selected columns hold (+inf, -1)); the count
    ignores the gate."""
    n, m = x.shape[0], y.shape[0]
    count = torch.zeros((n,), dtype=torch.int32, device=x.device)
    topv = torch.full((n, k), float("inf"), dtype=torch.float32,
                      device=x.device)
    topi = torch.full((n, k), -1, dtype=torch.int32, device=x.device)
    kk = min(k, m)
    if m == 0:
        return count, topv, topi
    cols = None if sel is None else torch.nonzero(sel).flatten()
    step = _row_block(m)
    for r0 in range(0, n, step):
        r1 = min(n, r0 + step)
        d2 = direct_d2(x[r0:r1, None, :], y[None, :, :])
        count[r0:r1] = (d2 < d2cut).sum(dim=1, dtype=torch.int32)
        if cols is not None:
            topv[r0:r1], topi[r0:r1] = _lex_smallest(d2[:, cols], cols, k)
            continue
        v, idx = torch.sort(d2, dim=1, stable=True)
        topv[r0:r1, :kk] = v[:, :kk]
        topi[r0:r1, :kk] = idx[:, :kk].to(torch.int32)
    return count, topv, topi


def _lex_smallest(d2: torch.Tensor, cols: torch.Tensor, k: int):
    """Per row of d2 (R, C), the k smallest (d2, column) pairs in
    lexicographic order, columns named by ``cols`` (C,) ascending; slots past
    C hold (+inf, -1).  The k-th smallest value bounds the answer, so only
    the columns at or below it are sorted."""
    R, C = d2.shape
    topv = torch.full((R, k), float("inf"), dtype=torch.float32,
                      device=d2.device)
    topi = torch.full((R, k), -1, dtype=torch.int32, device=d2.device)
    kk = min(k, C)
    if kk == 0 or R == 0:
        return topv, topi
    kth = torch.topk(d2, kk, dim=1, largest=False).values.amax(1)
    r, c = torch.nonzero(d2 <= kth[:, None], as_tuple=True)   # row-major
    v = d2[r, c]
    o = torch.sort(v, stable=True).indices          # by d2, ties by column
    o = o[torch.sort(r[o], stable=True).indices]    # then by row
    r, c, v = r[o], c[o], v[o]
    first = torch.searchsorted(r, torch.arange(R, device=r.device))
    slot = torch.arange(r.numel(), device=r.device) - first[r]
    ok = slot < kk
    topv[r[ok], slot[ok]] = v[ok]
    topi[r[ok], slot[ok]] = cols[c[ok]].to(torch.int32)
    return topv, topi


def worklist_count_topk_plain(x: torch.Tensor, y: torch.Tensor,
                              d2cut: float, wl, k: int = FUSED_TOPK,
                              sel: torch.Tensor | None = None):
    """The fused count + kept-k over a tile-pair worklist
    (``blocksparse.Worklist``): per row tile, the count of y rows with
    d2 < d2cut over the ``in_cut`` entries' columns, and the k nearest
    (d2, index) pairs over the columns of every kept entry, lexicographic;
    ``sel`` gates the kept-k as in ``fused_count_topk_plain``.

    Skips nothing by liveness (the kernel's skip is exact), so on a
    worklist from ``build_flat_worklist`` (with ``nn_col_counts`` from the
    same gate) the result equals ``fused_count_topk_plain`` over all of y.
    """
    n, m = x.shape[0], y.shape[0]
    bn, bm = BLOCK_N, BLOCK_M
    count = torch.zeros((n,), dtype=torch.int32, device=x.device)
    topv = torch.full((n, k), float("inf"), dtype=torch.float32,
                      device=x.device)
    topi = torch.full((n, k), -1, dtype=torch.int32, device=x.device)
    ptr = wl.row_ptr.tolist()
    lane = torch.arange(bm, device=x.device)
    for t in range(wl.num_row_tiles):
        r0, r1 = t * bn, min(n, (t + 1) * bn)
        tiles = wl.col_tile[ptr[t]:ptr[t + 1]].long()
        cut = wl.in_cut[ptr[t]:ptr[t + 1]]
        o = torch.argsort(tiles)                      # index-ordered columns
        cols = (tiles[o, None] * bm + lane).flatten()
        cut = cut[o, None].expand(-1, bm).flatten()
        real = cols < m
        cols, cut = cols[real], cut[real]
        kept = None if sel is None else sel[cols]
        yc = y[cols]
        step = _row_block(cols.numel())
        for q0 in range(r0, r1, step):
            q1 = min(r1, q0 + step)
            d2 = direct_d2(x[q0:q1, None, :], yc[None, :, :])
            count[q0:q1] = ((d2 < d2cut) & cut).sum(dim=1, dtype=torch.int32)
            if kept is None:
                topv[q0:q1], topi[q0:q1] = _lex_smallest(d2, cols, k)
            else:
                topv[q0:q1], topi[q0:q1] = _lex_smallest(d2[:, kept],
                                                         cols[kept], k)
    return count, topv, topi


def masked_nn_plain(x: torch.Tensor, x_key: torch.Tensor, y: torch.Tensor,
                    y_key: torch.Tensor):
    """Per x-row: the nearest y row with ``y_key > x_key`` as (best d2 f32,
    index i32), the lowest index among equal distances; (+inf, -1) where no
    row qualifies."""
    n, m = x.shape[0], y.shape[0]
    best = torch.full((n,), float("inf"), dtype=torch.float32,
                      device=x.device)
    arg = torch.full((n,), -1, dtype=torch.int32, device=x.device)
    if m == 0:
        return best, arg
    cols = torch.arange(m, device=x.device)
    step = _row_block(m)
    for r0 in range(0, n, step):
        r1 = min(n, r0 + step)
        d2 = direct_d2(x[r0:r1, None, :], y[None, :, :])
        d2 = torch.where(y_key[None, :] > x_key[r0:r1, None], d2,
                         float("inf"))
        b = d2.min(dim=1).values
        a = torch.where(d2 == b[:, None], cols, m).min(dim=1).values
        best[r0:r1] = b
        arg[r0:r1] = torch.where(torch.isinf(b), -1, a).to(torch.int32)
    return best, arg


def prefix_nn_plain(pts: torch.Tensor):
    """Per row i of a table sorted by descending key: the nearest earlier
    row j < i as (best d2 f32, index i32), the lowest index among equal
    distances; (+inf, -1) for row 0.  Each row block reads only the
    columns before its last row (the triangle)."""
    n = pts.shape[0]
    best = torch.full((n,), float("inf"), dtype=torch.float32,
                      device=pts.device)
    arg = torch.full((n,), -1, dtype=torch.int32, device=pts.device)
    step = _row_block(n)
    for r0 in range(1, n, step):
        r1 = min(n, r0 + step)
        d2 = direct_d2(pts[r0:r1, None, :], pts[None, :r1 - 1, :])
        cols = torch.arange(r1 - 1, device=pts.device)
        rows = torch.arange(r0, r1, device=pts.device)
        d2 = torch.where(cols[None, :] < rows[:, None], d2, float("inf"))
        b = d2.min(dim=1).values
        a = torch.where(d2 == b[:, None], cols, n).min(dim=1).values
        best[r0:r1] = b
        arg[r0:r1] = a.to(torch.int32)
    return best, arg


def range_count_plain(x: torch.Tensor, y: torch.Tensor, d2cut: float):
    """Per x-row: the count of y rows with d2 < d2cut (i32)."""
    n = x.shape[0]
    count = torch.zeros((n,), dtype=torch.int32, device=x.device)
    step = _row_block(y.shape[0])
    for r0 in range(0, n, step):
        d2 = direct_d2(x[r0:r0 + step, None, :], y[None, :, :])
        count[r0:r0 + step] = (d2 < d2cut).sum(dim=1, dtype=torch.int32)
    return count


def range_count_signed_plain(x: torch.Tensor, y: torch.Tensor,
                             signs: torch.Tensor, d2cut: float):
    """Per x-row: the sum of ``signs[j]`` over the y rows with d2 < d2cut
    (f32).  With signs in {+1, -1, 0} every partial sum is an integer below
    2^24, so the kernel's column-order sum and this one agree bit for bit."""
    n = x.shape[0]
    out = torch.zeros((n,), dtype=torch.float32, device=x.device)
    step = _row_block(y.shape[0])
    for r0 in range(0, n, step):
        d2 = direct_d2(x[r0:r0 + step, None, :], y[None, :, :])
        out[r0:r0 + step] = torch.where(d2 < d2cut, signs[None, :],
                                        0.0).sum(dim=1)
    return out


def gather_masked_nn_plain(table: torch.Tensor, keys: torch.Tensor,
                           q_slots: torch.Tensor):
    """Per slot s: the nearest table row j with ``keys[j] > keys[s]`` as
    (best d2 f32, index i32), the lowest index among equal distances;
    (+inf, -1) where no row qualifies and for slots outside [0, m)."""
    m, q = table.shape[0], q_slots.numel()
    if m == 0:
        return (torch.full((q,), float("inf"), device=table.device),
                torch.full((q,), -1, dtype=torch.int32, device=table.device))
    slots = q_slots.long()
    live = (slots >= 0) & (slots < m)
    rows = torch.where(live, slots, 0)
    qk = torch.where(live, keys[rows], float("inf"))
    return masked_nn_plain(table[rows], qk, table, keys)
