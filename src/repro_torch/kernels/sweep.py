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

The exception is ``precision="bf16"`` (K12, K13), which keeps the
reference's semantics: the expanded form with a bf16 cross term on the
tensor cores (``expanded_d2_bf16``).  The tensor cores' f32 accumulation is
not an in-order IEEE sum, so there the kernels equal their plain versions
bit for bit only where every partial sum is exact (integer coordinates
times a power of two), and within a few ulps of sum_k |x_k y_k| elsewhere.
"""
from __future__ import annotations

import numpy as np
import torch

from .blocksparse import BLOCK_M, BLOCK_N

# The admission bound: a real point at or beyond it is refused at the
# boundary (resilience.sanitize).  The CUDA kernels mask ragged edges
# themselves and never pad with it; ``distributed_dpc`` pads its shards'
# rows with it, as the reference does, so padded rows lie outside every
# d_cut.
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


def sq_norms(a: torch.Tensor) -> torch.Tensor:
    """Per row of ``a`` (r, d): sum_k a_k^2 in f32, over dims in order, one
    rounding per operation (the bf16 kernels' norms)."""
    out = a[:, 0] * a[:, 0]
    for k in range(1, a.shape[1]):
        out = out + a[:, k] * a[:, k]
    return out


def expanded_d2_bf16(x: torch.Tensor, y: torch.Tensor,
                     x2: torch.Tensor | None = None,
                     y2: torch.Tensor | None = None) -> torch.Tensor:
    """(r, c) expanded-form squared distances with a bf16 cross term: the
    reference's ``tile_d2(precision="bf16")`` (``repro/kernels/sweep.py``)
    written out.  The norms are f32 (``sq_norms``; pass them to reuse); x
    and y are rounded to bf16 (round to nearest even, as jnp's ``astype``),
    their products taken in f32, where they are exact, and summed over dims
    in order; then ``(x2 + y2) - 2 * xy``.  The result may be negative."""
    x2 = sq_norms(x) if x2 is None else x2
    y2 = sq_norms(y) if y2 is None else y2
    xb = x.to(torch.bfloat16).to(torch.float32)
    yb = y.to(torch.bfloat16).to(torch.float32)
    xy = xb[:, None, 0] * yb[None, :, 0]
    for k in range(1, x.shape[1]):
        xy = xy + xb[:, None, k] * yb[None, :, k]
    return (x2[:, None] + y2[None, :]) - 2.0 * xy


def fused_count_topk_bf16_plain(x: torch.Tensor, y: torch.Tensor,
                                d2cut: float, sel: torch.Tensor | None = None,
                                k: int = FUSED_TOPK):
    """K12's function: ``fused_count_topk_plain`` on the bf16 expanded-form
    d2 of ``expanded_d2_bf16`` — per x-row the count of d2 < d2cut (i32) and
    the k smallest (d2, index) pairs, lexicographic, among the columns that
    ``sel`` admits (all without it); (+inf, -1) past them."""
    n, m = x.shape[0], y.shape[0]
    count = torch.zeros((n,), dtype=torch.int32, device=x.device)
    topv = torch.full((n, k), float("inf"), dtype=torch.float32,
                      device=x.device)
    topi = torch.full((n, k), -1, dtype=torch.int32, device=x.device)
    if m == 0:
        return count, topv, topi
    cols = (torch.arange(m, device=x.device) if sel is None
            else torch.nonzero(sel).flatten())
    y2 = sq_norms(y)
    step = _row_block(m)
    for r0 in range(0, n, step):
        r1 = min(n, r0 + step)
        d2 = expanded_d2_bf16(x[r0:r1], y, y2=y2)
        count[r0:r1] = (d2 < d2cut).sum(dim=1, dtype=torch.int32)
        topv[r0:r1], topi[r0:r1] = _lex_smallest(d2[:, cols], cols, k)
    return count, topv, topi


def _lex_merge(tv: torch.Tensor, ti: torch.Tensor, v: torch.Tensor,
               cols: torch.Tensor):
    """Per row, the k smallest (d2, index) pairs of the kept list (tv, ti)
    ((R, k), empty slots (+inf, -1)) and the new candidates v (R, C) at
    columns ``cols`` (C,), lexicographic."""
    R, k = tv.shape
    big = torch.iinfo(torch.int64).max
    idx = torch.cat([torch.where(ti >= 0, ti.long(), big),
                     cols.long()[None, :].expand(R, -1)], 1)
    val = torch.cat([tv, v], 1)
    o = torch.sort(idx, dim=1, stable=True).indices      # by index, then
    o = o.gather(1, torch.sort(val.gather(1, o), dim=1,  # by value
                               stable=True).indices)[:, :k]
    val, idx = val.gather(1, o), idx.gather(1, o)
    return val, torch.where(idx == big, -1, idx).to(torch.int32)


def worklist_count_topk_bf16_plain(x: torch.Tensor, y: torch.Tensor,
                                   d2cut: float, wl,
                                   sel: torch.Tensor | None = None,
                                   k: int = FUSED_TOPK):
    """K13's function: the bf16 fused count + kept-k over a worklist, with
    the reference's liveness (``repro/kernels/sweep.py:255-260``).

    Per row tile, the entries in worklist order; an entry is NN-live when
    its ``lb`` is at most the largest kept k-th d2 of the tile's rows so
    far (the reference's ``lb <= max(topv)``).  Only ``in_cut`` entries
    count; only NN-live entries enter the kept k.  Unlike the f32 sweep,
    this skip is not exact: a bf16 d2 may lie below its pair's true-
    distance ``lb``, even below 0, so the kept k depends on the walk, and
    the kernel and this version agree because they skip the same entries.
    """
    n, m = x.shape[0], y.shape[0]
    count = torch.zeros((n,), dtype=torch.int32, device=x.device)
    topv = torch.full((n, k), float("inf"), dtype=torch.float32,
                      device=x.device)
    topi = torch.full((n, k), -1, dtype=torch.int32, device=x.device)
    ptr = wl.row_ptr.tolist()
    ents = zip(wl.col_tile.tolist(), wl.in_cut.tolist(), wl.lb.tolist())
    x2, y2 = sq_norms(x), sq_norms(y)
    for t in range(wl.num_row_tiles):
        r0, r1 = t * BLOCK_N, min(n, (t + 1) * BLOCK_N)
        for _ in range(ptr[t], ptr[t + 1]):
            tile, cut, lb = next(ents)
            live = lb <= float(topv[r0:r1, k - 1].max())
            if not (cut or live):
                continue
            cols = torch.arange(tile * BLOCK_M, min(m, (tile + 1) * BLOCK_M),
                                device=x.device)
            d2 = expanded_d2_bf16(x[r0:r1], y[cols], x2[r0:r1], y2[cols])
            if cut:
                count[r0:r1] += (d2 < d2cut).sum(dim=1, dtype=torch.int32)
            if live:
                if sel is not None:
                    d2, cols = d2[:, sel[cols]], cols[sel[cols]]
                topv[r0:r1], topi[r0:r1] = _lex_merge(
                    topv[r0:r1], topi[r0:r1], d2, cols)
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


def worklist_range_count_plain(x: torch.Tensor, y: torch.Tensor,
                               d2cut: float, wl):
    """Per x-row: the count of y rows with d2 < d2cut over the columns of
    its row tile's ``in_cut`` entries (i32): K8's function.  On a
    count-only worklist from ``build_flat_worklist`` it equals
    ``range_count_plain`` over all of y."""
    n, m = x.shape[0], y.shape[0]
    count = torch.zeros((n,), dtype=torch.int32, device=x.device)
    ptr = wl.row_ptr.tolist()
    lane = torch.arange(BLOCK_M, device=x.device)
    for t in range(wl.num_row_tiles):
        r0, r1 = t * BLOCK_N, min(n, (t + 1) * BLOCK_N)
        seg = slice(ptr[t], ptr[t + 1])
        tiles = wl.col_tile[seg][wl.in_cut[seg]].long()
        cols = (tiles[:, None] * BLOCK_M + lane).flatten()
        count[r0:r1] = range_count_plain(x[r0:r1], y[cols[cols < m]], d2cut)
    return count


def worklist_range_count_signed_plain(x: torch.Tensor, y: torch.Tensor,
                                      signs: torch.Tensor, d2cut: float, wl):
    """Per x-row: the sum of ``signs[j]`` over the y rows with d2 < d2cut
    among the columns of its row tile's ``in_cut`` entries (f32): K14's
    function.  On a count-only worklist from ``build_flat_worklist`` it
    equals ``range_count_signed_plain`` over all of y."""
    n, m = x.shape[0], y.shape[0]
    out = torch.zeros((n,), dtype=torch.float32, device=x.device)
    ptr = wl.row_ptr.tolist()
    lane = torch.arange(BLOCK_M, device=x.device)
    for t in range(wl.num_row_tiles):
        r0, r1 = t * BLOCK_N, min(n, (t + 1) * BLOCK_N)
        seg = slice(ptr[t], ptr[t + 1])
        tiles = wl.col_tile[seg][wl.in_cut[seg]].long()
        cols = (tiles[:, None] * BLOCK_M + lane).flatten()
        cols = cols[cols < m]
        out[r0:r1] = range_count_signed_plain(x[r0:r1], y[cols], signs[cols],
                                              d2cut)
    return out


def worklist_masked_nn_plain(x: torch.Tensor, x_key: torch.Tensor,
                             y: torch.Tensor, y_key: torch.Tensor, wl):
    """Per x-row: the nearest y row with ``y_key > x_key`` among the
    columns of every entry of its row tile, as (best d2 f32, index i32),
    the lowest index among equal distances; (+inf, -1) where none
    qualifies: K9's function.  Skips nothing by liveness (the kernel's
    early end is exact), so on a best-1 ring from ``build_flat_worklist``
    (every tile pair) it equals ``masked_nn_plain`` over all of y."""
    n, m = x.shape[0], y.shape[0]
    best = torch.full((n,), float("inf"), dtype=torch.float32,
                      device=x.device)
    arg = torch.full((n,), -1, dtype=torch.int32, device=x.device)
    ptr = wl.row_ptr.tolist()
    lane = torch.arange(BLOCK_M, device=x.device)
    for t in range(wl.num_row_tiles):
        r0, r1 = t * BLOCK_N, min(n, (t + 1) * BLOCK_N)
        tiles = torch.sort(wl.col_tile[ptr[t]:ptr[t + 1]].long()).values
        cols = (tiles[:, None] * BLOCK_M + lane).flatten()
        cols = cols[cols < m]
        b, a = masked_nn_plain(x[r0:r1], x_key[r0:r1], y[cols], y_key[cols])
        best[r0:r1] = b
        arg[r0:r1] = torch.where(a >= 0, cols[a.clamp_min(0).long()],
                                 -1).to(torch.int32)
    return best, arg


def _span_candidates(starts, ends, w: int):
    """Window columns of each row's spans, gather form: (idx (r, S, L)
    int64 clamped into the window, valid (r, S, L) bool), L the longest
    span; a column is valid inside [max(start, 0), min(end, w)), the range
    the kernels walk."""
    st, en = starts.long(), ends.long()
    span_w = int((en - st).clamp_min(0).max()) if st.numel() else 0
    idx = st[..., None] + torch.arange(span_w, device=st.device)
    valid = (idx >= 0) & (idx < en[..., None]) & (idx < w)
    return idx.clamp(0, max(w - 1, 0)), valid


def _span_rows(starts, ends) -> int:
    """Rows per block of the halo plain versions, whose gather holds S x
    the longest span per row: about _PLAIN_PAIRS candidates a block."""
    lens = (ends.long() - starts.long()).clamp_min(0)
    return _row_block(starts.shape[1] * int(lens.max()) if lens.numel()
                      else 1)


def clipped_spans(starts, ends, w: int):
    """Each row's spans clipped to ``[0, w)`` and laid end to end: (first
    column (r, S) int64, running total (r, S + 1) int64 of the clipped
    lengths, whose last column is the row's candidate count)."""
    st = starts.long().clamp(0, w)
    ln = (ends.long().clamp(max=w) - st).clamp_min(0)
    cum = torch.cat([torch.zeros_like(ln[:, :1]), ln.cumsum(1)], 1)
    return st, cum


def span_chunks(count: torch.Tensor, block: int | None = None,
                mult: torch.Tensor | None = None):
    """Rows in descending order of their candidate ``count`` (r,), cut into
    chunks: yields (rows (k,) int64, width, widest mult) where width is the
    chunk's largest count and k * width * (the chunk's largest ``mult``, 1
    without it) stays within ``_PLAIN_PAIRS``; ``block`` caps k.  Rows with
    no candidate are left out.  Padding each chunk only to its own widest
    row, not to the widest row overall, keeps skewed data from paying the
    densest row's width on every row."""
    order = torch.argsort(count, descending=True, stable=True)
    widths = count[order].cpu().numpy()
    mults = None if mult is None else mult[order].cpu().numpy()
    i, r = 0, int(widths.size)
    while i < r and widths[i] > 0:
        width = int(widths[i])
        top = 1 if mults is None else max(int(mults[i]), 1)
        k = max(1, _PLAIN_PAIRS // (width * top))
        if block is not None:
            k = min(k, block)
        if mults is not None:
            cm = np.maximum.accumulate(np.maximum(mults[i:i + k], 1))
            k = max(1, int((np.arange(1, cm.size + 1) * width * cm
                            <= _PLAIN_PAIRS).sum()))
            top = int(cm[k - 1])
        k = int((widths[i:i + k] > 0).sum())
        yield order[i:i + k], width, top
        i += k


def span_columns(st: torch.Tensor, cum: torch.Tensor, width: int):
    """Window columns of rows' spans laid end to end (``clipped_spans``):
    (col (k, width) int64, valid (k, width) bool), position j of a row
    valid below its candidate count; an invalid position's column is 0."""
    j = torch.arange(width, device=st.device)
    valid = j < cum[:, -1:]
    jj = j.expand(st.shape[0], width)
    if st.shape[1] == 1:
        s = torch.zeros_like(jj)
    else:   # the span of position j: the span ends at or before it
        s = torch.searchsorted(cum[:, 1:-1].contiguous(), jj.contiguous(),
                               right=True)
    col = st.gather(1, s) + (j - cum.gather(1, s))
    return torch.where(valid, col, 0), valid


def halo_range_count_plain(x: torch.Tensor, window: torch.Tensor,
                           starts: torch.Tensor, ends: torch.Tensor,
                           d2cut: float, block: int | None = None):
    """Per x-row: the count of window rows with d2 < d2cut inside the row's
    ``[start, end)`` spans (each clipped to the window), i32: K10's
    function, and the stencil's range count.  The spans of a row must be
    disjoint.  ``block`` caps the rows evaluated together
    (``span_chunks``); the result does not depend on it."""
    n, w = x.shape[0], window.shape[0]
    count = torch.zeros((n,), dtype=torch.int32, device=x.device)
    if w == 0 or n == 0:
        return count
    st, cum = clipped_spans(starts, ends, w)
    for rows, width, _ in span_chunks(cum[:, -1], block):
        col, valid = span_columns(st[rows], cum[rows], width)
        d2 = direct_d2(x[rows, None, :], window[col])
        count[rows] = ((d2 < d2cut) & valid).sum(dim=1, dtype=torch.int32)
    return count


def halo_masked_nn_plain(x: torch.Tensor, x_key: torch.Tensor,
                         window: torch.Tensor, w_key: torch.Tensor,
                         starts: torch.Tensor, ends: torch.Tensor,
                         d2cut: float, block: int | None = None):
    """Per x-row: the nearest window row inside the row's spans with a key
    strictly greater and d2 < d2cut, as (best d2 f32, window index i32),
    the lowest index among equal distances; (+inf, -1) where none
    qualifies: K11's function, and the stencil's denser NN.  ``block`` as
    in ``halo_range_count_plain``."""
    n, w = x.shape[0], window.shape[0]
    best = torch.full((n,), float("inf"), dtype=torch.float32,
                      device=x.device)
    arg = torch.full((n,), -1, dtype=torch.int32, device=x.device)
    if w == 0 or n == 0:
        return best, arg
    st, cum = clipped_spans(starts, ends, w)
    for rows, width, _ in span_chunks(cum[:, -1], block):
        col, valid = span_columns(st[rows], cum[rows], width)
        d2 = direct_d2(x[rows, None, :], window[col])
        ok = valid & (w_key[col] > x_key[rows, None]) & (d2 < d2cut)
        d2 = torch.where(ok, d2, float("inf"))
        b = d2.min(dim=1).values
        a = torch.where(ok & (d2 == b[:, None]), col, w).min(dim=1).values
        best[rows] = b
        arg[rows] = torch.where(torch.isinf(b), -1, a).to(torch.int32)
    return best, arg


def _halo_tile_candidates(x, window, starts, ends, r0: int, r1: int):
    """The span columns of rows [r0, r1) (one row tile): (idx (r, S, L)
    int64 window columns, valid (r, S, L) bool, d2 (r, S, L) f32)."""
    idx, valid = _span_candidates(starts[r0:r1], ends[r0:r1],
                                  window.shape[0])
    return idx, valid, direct_d2(x[r0:r1, None, None, :], window[idx])


def worklist_halo_range_count_plain(x: torch.Tensor, window: torch.Tensor,
                                    starts: torch.Tensor, ends: torch.Tensor,
                                    d2cut: float, wl):
    """Per x-row: the count of window rows with d2 < d2cut inside the row's
    spans (clipped to the window) and inside its row tile's ``in_cut``
    entries' column tiles, i32: K15's function.  On a span count worklist
    from ``build_flat_worklist(count=True, nn=None, starts=, ends=)`` it
    equals ``halo_range_count_plain``."""
    n, w = x.shape[0], window.shape[0]
    count = torch.zeros((n,), dtype=torch.int32, device=x.device)
    if w == 0:
        return count
    ptr = wl.row_ptr.tolist()
    nbc = -(-w // BLOCK_M)
    for t in range(wl.num_row_tiles):
        r0, r1 = t * BLOCK_N, min(n, (t + 1) * BLOCK_N)
        seg = slice(ptr[t], ptr[t + 1])
        cut = torch.zeros((nbc,), dtype=torch.bool, device=x.device)
        cut[wl.col_tile[seg][wl.in_cut[seg]].long()] = True
        idx, valid, d2 = _halo_tile_candidates(x, window, starts, ends, r0,
                                               r1)
        valid &= cut[idx // BLOCK_M]
        count[r0:r1] = ((d2 < d2cut) & valid).sum(dim=(1, 2),
                                                  dtype=torch.int32)
    return count


def worklist_halo_masked_nn_plain(x: torch.Tensor, x_key: torch.Tensor,
                                  window: torch.Tensor, w_key: torch.Tensor,
                                  starts: torch.Tensor, ends: torch.Tensor,
                                  d2cut: float, wl, live=None):
    """Per x-row: the nearest window row inside the row's spans with a key
    strictly greater and d2 < d2cut, as (best d2 f32, window index i32),
    lexicographic on (d2, index); (+inf, -1) where none qualifies: K16's
    function.  Each row tile walks its entries in stored (ascending lb)
    order and stops at the first entry for which no row with a finite key
    has ``lb <= best``: a block-wide walk, exact since lb ascends (the
    kernel ends each piece of rows on its own, which computes a subset of
    these entries); ``live`` ((row tiles,) int32, optional) receives the
    entries this walk computed.  On a halo ring from
    ``build_flat_worklist(count=False, nn="best1", nn_dcut=True, starts=,
    ends=)`` it equals ``halo_masked_nn_plain``."""
    n, w = x.shape[0], window.shape[0]
    best = torch.full((n,), float("inf"), dtype=torch.float32,
                      device=x.device)
    arg = torch.full((n,), -1, dtype=torch.int32, device=x.device)
    ptr = wl.row_ptr.tolist()
    for t in range(wl.num_row_tiles):
        r0, r1 = t * BLOCK_N, min(n, (t + 1) * BLOCK_N)
        seeks = x_key[r0:r1] < float("inf")
        b = torch.full((r1 - r0,), float("inf"), dtype=torch.float32,
                       device=x.device)
        a = torch.full((r1 - r0,), w, dtype=torch.int64, device=x.device)
        if w:
            idx, valid, d2 = _halo_tile_candidates(x, window, starts, ends,
                                                   r0, r1)
            ok = (valid & (w_key[idx] > x_key[r0:r1, None, None])
                  & (d2 < d2cut)).flatten(1)
            idx, d2 = idx.flatten(1), d2.flatten(1)
            tile = idx // BLOCK_M
        walked = 0
        for col, lb in zip(wl.col_tile[ptr[t]:ptr[t + 1]].tolist(),
                           wl.lb[ptr[t]:ptr[t + 1]].tolist()):
            if not bool((seeks & (lb <= b)).any()):
                break
            walked += 1
            if not w or idx.shape[1] == 0:      # no span column at all
                continue
            cand = torch.where(ok & (tile == col), d2, float("inf"))
            cb = cand.min(dim=1).values
            ca = torch.where(cand == cb[:, None], idx, w).min(dim=1).values
            upd = (cb < b) | ((cb == b) & torch.isfinite(cb) & (ca < a))
            b = torch.where(upd, cb, b)
            a = torch.where(upd, ca, a)
        if live is not None:
            live[t] = walked
        best[r0:r1] = b
        arg[r0:r1] = torch.where(torch.isinf(b), -1, a).to(torch.int32)
    return best, arg
