"""The host side of the K11 and K16 kernels (``kernels/packing.py``) and
their schedule.

Both kernels take the window as packed records with the key in the slot,
each column tile's largest key, and the rows by piece
(``packing.halo_layout``): consecutive rows whose spans clip to the same
columns form a run, sorted by key and cut into pieces of at most
``HALO_PIECE`` rows (K16's runs also at its ring's row tiles), each
piece's length at its first position.  A warp takes the pieces starting
in 64 positions and streams each span column once for all of a piece's
rows: a column tile whose largest key is not above the piece's
least key is not loaded, and of each chunk of 32 columns only those keyed
above it are computed.  K11 walks the piece's spans; K16 walks its row
tile's ring in ascending lb, computing the entries its rows need (lb at
most the piece's largest best, the tile's largest key above its least, a
span reaching the tile) and ending at the first entry that is not open.
Each row keeps (d2, index) as one key, starting at (d_cut^2, 0).

``schedule`` below runs that schedule in plain PyTorch with the kernels'
rules, on what the wrapper builds.  The tests hold it bit for bit against
``halo_masked_nn_plain`` and ``worklist_halo_masked_nn_plain`` (the plain
K11 and K16) and against the JAX package's ``masked_min_dist_halo``
(Pallas interpret mode on unit-scale data, ``jnp`` on domain-scale data
off the threshold band), and assert each case the kernels must meet on
its input.  The kernels themselves are held against the plain versions
on the card by chip_smoke.py (phases 16, 17 and 23).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.grid import build_grid as jbuild_grid
from repro.core.grid import point_span_bounds as jpoint_span_bounds
from repro.kernels import ops as jops
from repro.kernels.backend import get_backend as jget_backend

from repro_torch.core.dpc_types import density_jitter
from repro_torch.core.grid import build_grid, point_span_bounds
from repro_torch.core.tuning import pick_dcut
from repro_torch.data.points import gaussian_mixture, real_proxy
from repro_torch.kernels import blocksparse, ops, packing, sweep
from repro_torch.kernels.blocksparse import BLOCK_M, BLOCK_N

from _torch_ref import (clear_dcut, f32_d2cut, f32_ulp, near_threshold_rows,
                        uniform_points)
from _torch_ref import one_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

INF = float("inf")
CHUNK = 32                       # columns a warp loads at once


def _t(a):
    return torch.from_numpy(np.array(a))


class Work:
    """What the schedule ran: column tiles passed over by key, columns
    loaded and computed (a piece each), the rows' pairs, and K16's
    ``live`` (per row tile the entries its pieces computed and the
    longest walk)."""

    def __init__(self, nbr):
        self.tiles_skipped = self.loaded = self.kept = self.pairs = 0
        self.splits = 0          # splits beyond one a piece
        self.live = torch.zeros((nbr, 2), dtype=torch.int64)
        self.walk_ends = 0       # pieces whose walk ended before the ring's


def halo_pieces(lay):
    """(P, 5) int64: the pieces of a layout in the kernels' order (most
    work first), each as the kernels read it: its first position in
    ``row_id``, its rows, the row whose spans it walks (its first), that
    row's ``BLOCK_N``-row tile, and its splits (``item_end``'s steps)."""
    live = lay.plen[lay.order.long()] > 0
    p0 = lay.order.long()[live]
    ends = lay.item_end.long()[live]
    parts = torch.diff(ends, prepend=ends.new_zeros(1))
    src = lay.row_id[p0].long()
    return torch.stack([p0, lay.plen[p0].long(), src, src // BLOCK_N, parts],
                       1)


def _cols(a, b, kmin, ykey, work):
    """The columns of [a, b) a piece computes, chunk by chunk: those keyed
    above its least key (the ballot)."""
    work.loaded += b - a
    c = torch.arange(a, b)
    keep = c[ykey[a:b] > kmin]
    work.kept += keep.numel()
    return keep


def _take(best, arg, x, key, yc, ykey, cols, work):
    """The rows' (best, index) after the columns ``cols``: kept where the
    column's key is above the row's and (d2, index) is below the row's
    (best, index): the lexicographic minimum of the 64-bit keys, the
    starting (d_cut^2, 0) losing every tie (index -1 here)."""
    if not cols.numel():
        return best, arg
    work.pairs += x.shape[0] * cols.numel()
    d2 = sweep.direct_d2(x[:, None, :], yc[cols][None, :, :])
    ok = (ykey[cols][None, :] > key[:, None]) & ~torch.isnan(d2)
    v = torch.cat([best[:, None], torch.where(ok, d2, INF)], 1)
    i = torch.cat([arg[:, None], torch.where(ok, cols[None, :], 2**40)], 1)
    vmin = v.min(1).values
    # a tie with the starting (d_cut^2, -1) is never taken
    lo = torch.where(v == vmin[:, None], i, 2**41).min(1).values
    better = (vmin < best) | ((vmin == best) & (lo < arg) & (arg >= 0))
    return torch.where(better, vmin, best), torch.where(better, lo, arg)


def _k11_split(spans, part, parts, kmin, tm, take, work):
    """K11's split ``part`` of ``parts``: its slice of the spans' columns
    laid end to end, a column tile passed over where its largest key is
    not above ``kmin``."""
    cols = sum(b - a for a, b in spans if b > a)
    c0, c1 = cols * part // parts, cols * (part + 1) // parts
    off = 0
    for a0, b0 in spans:
        if a0 >= b0 or off >= c1:
            continue
        a, b = a0 + max(c0 - off, 0), a0 + min(c1 - off, b0 - a0)
        off += b0 - a0
        ra = a
        while ra < b:
            while ra < b and not bool(tm[ra // BLOCK_M] > kmin):
                work.tiles_skipped += 1
                ra = (ra // BLOCK_M + 1) * BLOCK_M
            rb = ra
            while rb < b and bool(tm[rb // BLOCK_M] > kmin):
                rb = min(b, (rb // BLOCK_M + 1) * BLOCK_M)
            if ra < rb:
                take(ra, rb)
            ra = rb


def _k16_split(ring, tile, part, parts, spans, kmin, tm, w, bests, take,
               work):
    """K16's split ``part`` of ``parts``: every parts-th entry of the row
    tile's ring from the part-th, 32 a ballot, each needed one computed
    after a fresh test of lb, the walk ended at the first one not open.
    Returns the entries computed and whether the walk ended before the
    split's last entry."""
    e0, e1 = int(ring.row_ptr[tile]), int(ring.row_ptr[tile + 1])
    mine = list(range(e0 + part, e1, parts))
    bmax, walked = bests(), 0
    for m in range(0, len(mine), CHUNK):
        js = mine[m:m + CHUNK]
        lbs = [float(ring.lb[j]) for j in js]
        opened = [lb <= bmax for lb in lbs]              # stale bmax
        need = []
        for j, lb, o in zip(js, lbs, opened):
            ct = int(ring.col_tile[j])
            j0, j1 = ct * BLOCK_M, min(ct * BLOCK_M + BLOCK_M, w)
            if o and bool(tm[ct] > kmin) and any(
                    max(a, j0) < min(b, j1) for a, b in spans):
                need.append((lb, j0, j1))
        done = not all(opened) or len(js) < CHUNK
        for lb, j0, j1 in need:
            if not lb <= bmax:                           # fresh: the end
                done = True
                break
            for a, b in spans:
                if max(a, j0) < min(b, j1):
                    take(max(a, j0), min(b, j1))
            bmax = bests()
            walked += 1
        if done:
            break
    return walked, bool(mine) and float(ring.lb[mine[-1]]) > bmax


def schedule(x, xk, win, wk, st, en, d2cut, ring=None, splits=64):
    """(best d2, index) through K11's schedule, or K16's on ``ring`` (d2
    +inf and index -1 where no column qualifies), the layout (pieces of
    more than 1/``splits`` of the work split) and the ``Work``.  Each
    split starts from (d_cut^2, -1) and the splits of a piece merge by
    the lexicographic minimum, as the kernels' atomicMin does."""
    n, d = x.shape
    w = win.shape[0]
    lay = packing.halo_layout(xk, win, wk, st, en, ring=ring is not None,
                              splits=splits)
    yc, ykey = lay.rec[:, :d], lay.rec[:, d]
    tm = lay.tmax
    init = d2cut if d2cut > 0 else 0.0          # NaN: nothing qualifies
    best = torch.full((n,), init, dtype=torch.float32)
    arg = torch.full((n,), -1, dtype=torch.int64)
    key_all = torch.where(xk < INF, xk, INF)    # NaN and +inf never seek
    work = Work(ring.num_row_tiles if ring is not None else 0)
    for p0, cnt, src, tile, parts in halo_pieces(lay).tolist():
        rows = lay.row_id[p0:p0 + cnt].long()
        key = key_all[rows]
        kmin = float(key.min())
        if not kmin < INF:
            continue
        spans = [(max(int(s), 0), min(int(e), w))
                 for s, e in zip(st[src].tolist(), en[src].tolist())]
        xr = x[rows]
        seek = key < INF
        work.splits += parts - 1
        for part in range(parts):
            cur = [torch.full((cnt,), init, dtype=torch.float32),
                   torch.full((cnt,), -1, dtype=torch.int64)]

            def take(a, b):
                cur[:] = _take(*cur, xr, key, yc, ykey,
                               _cols(a, b, kmin, ykey, work), work)

            if ring is None:
                _k11_split(spans, part, parts, kmin, tm, take, work)
            else:
                walked, ended = _k16_split(
                    ring, tile, part, parts, spans, kmin, tm, w,
                    lambda: float(cur[0][seek].max()), take, work)
                work.walk_ends += ended
                work.live[tile, 0] += walked
                work.live[tile, 1] = max(int(work.live[tile, 1]), walked)
            b_, a_ = cur
            b0, a0 = best[rows], arg[rows]
            upd = (b_ < b0) | ((b_ == b0) & (a_ >= 0) & (a_ < a0))
            best[rows] = torch.where(upd, b_, b0)
            arg[rows] = torch.where(upd, a_, a0)
    found = arg >= 0
    return (torch.where(found, best, INF),
            torch.where(found, arg, -1).to(torch.int32), lay, work)


def _keys(x, dc):
    """rho + jitter keys of the table x, as the fits make them."""
    return (sweep.range_count_plain(x, x, sweep.d2cut_of(dc)).float()
            + density_jitter(x.shape[0]))


def _shard(pts, dc, r0, r1, extra=False, pad=0, key=None):
    """Rows [r0, r1) of the grid-sorted table (``pad`` padded rows at
    1e9 appended to the table, the shard reaching into them as a ragged
    last shard does: keyed +inf as queries, -inf in the window), the
    window their spans reach and the spans made window-local.  ``extra``
    adds a reversed, a negative, a negative-start and a past-the-window
    span to every row.  Returns (x, xk, window, wk, starts, ends)."""
    g = build_grid(_t(pts), dc)
    gp = g.points
    n = gp.shape[0]
    key = _keys(gp, dc) if key is None else key(gp)
    st, en = (a.numpy() for a in point_span_bounds(g))
    gp = torch.cat([gp, torch.full((pad, gp.shape[1]), sweep.PAD_COORD)])
    tk = torch.cat([key, torch.full((pad,), -INF)])
    qk = torch.cat([key, torch.full((pad,), INF)])
    st = np.concatenate([st, np.zeros((pad, st.shape[1]), st.dtype)])
    en = np.concatenate([en, np.zeros((pad, en.shape[1]), en.dtype)])
    r1 = min(r1, n + pad)
    st = np.pad(st[r0:r1], ((0, 0), (0, 1)))       # an empty span at 0
    en = np.pad(en[r0:r1], ((0, 0), (0, 1)))
    live = en > st
    lo = min(int(st[live].min()), r0)
    hi = max(int(en[live].max()), r1)
    st, en = st - lo, en - lo
    if extra:
        w = hi - lo
        more = np.array([[7, 3], [-9, -3], [-5, 0], [w, w + 40]])
        st = np.concatenate([st, np.tile(more[:, 0], (len(st), 1))], 1)
        en = np.concatenate([en, np.tile(more[:, 1], (len(en), 1))], 1)
    return (gp[r0:r1].contiguous(), qk[r0:r1].contiguous(),
            gp[lo:hi].contiguous(), tk[lo:hi].contiguous(),
            _t(st.astype(np.int32)), _t(en.astype(np.int32)))


def _ring(x, win, st, en, dc):
    return blocksparse.build_flat_worklist(x, win, dc, count=False,
                                           nn="best1", nn_dcut=True,
                                           starts=st, ends=en)


def _check(x, xk, win, wk, st, en, dc):
    """Both schedules bit for bit against the plain K11 and K16; returns
    (best, index, K11's layout and work, K16's layout and work)."""
    d2cut = sweep.d2cut_of(dc)
    want_b, want_a = sweep.halo_masked_nn_plain(x, xk, win, wk, st, en,
                                                d2cut)
    ring = _ring(x, win, st, en, dc)
    b11, a11, lay11, w11 = schedule(x, xk, win, wk, st, en, d2cut)
    b16, a16, lay16, w16 = schedule(x, xk, win, wk, st, en, d2cut, ring)
    tile_walk = torch.zeros(ring.num_row_tiles, dtype=torch.int32)
    pb, pa = sweep.worklist_halo_masked_nn_plain(x, xk, win, wk, st, en,
                                                 d2cut, ring, live=tile_walk)
    for b, a in ((b11, a11), (b16, a16), (pb, pa)):
        assert torch.equal(b, want_b) and torch.equal(a, want_a)
    d, p, f = ops.halo_dependent(x, xk, win, wk, st, en, dc)
    assert torch.equal(d, torch.sqrt(b11)) and torch.equal(p, a11)
    assert torch.equal(f, a11 >= 0)
    # a piece's walk ends no later than its row tile's block-wide walk
    assert bool((w16.live[:, 1] <= tile_walk).all())
    return b11, a11, (lay11, w11), (lay16, w16, ring, tile_walk)


def _runs(starts, ends, w):
    """Rows per run."""
    new = packing.span_runs(starts, ends, w)
    return torch.bincount(torch.cumsum(new, 0) - 1)


@pytest.mark.parametrize("case", ["airline", "mixture", "whole"])
def test_schedule_matches_plain(case):
    """Grid-sorted shards (Airline's d = 3, a 2-d mixture) with a ragged
    last shard's padded rows and the extra empty, negative, reversed and
    past-the-window spans, and one run of every row (spans over the whole
    window): both schedules equal the plain K11 and K16."""
    if case == "airline":
        pts = real_proxy("airline", 2500, seed=11)[0]
        dc = pick_dcut(pts, target_rho=30)
        args = _shard(pts, dc, 1500, 2600, extra=True, pad=100)
    elif case == "mixture":
        pts = gaussian_mixture(2500, d=2, seed=11)[0]
        dc = pick_dcut(pts, target_rho=30)
        args = _shard(pts, dc, 200, 1400, extra=True)
    else:
        pts = uniform_points(1300, 3, seed=11)
        dc = pick_dcut(pts, target_rho=20)
        x, xk, win, wk, _, _ = _shard(pts, dc, 0, 1300)
        w = win.shape[0]
        sp = torch.tensor([[0, w // 3], [w // 3, w + 5], [9, 2]],
                          dtype=torch.int32)
        args = (x, xk, win, wk, sp[:, 0].expand(len(x), 3).contiguous(),
                sp[:, 1].expand(len(x), 3).contiguous())
    x, xk, win, wk, st, en = args
    b, a, (lay, w11), (lay16, w16, ring, _) = _check(*args, dc)
    runs = _runs(st, en, win.shape[0])
    pieces = halo_pieces(lay)
    assert int(pieces[:, 1].max()) <= packing.HALO_PIECE
    assert int(pieces[:, 1].sum()) == len(x)           # every row, once
    assert torch.equal(torch.sort(lay.row_id.long()).values,
                       torch.arange(len(x)))
    if case == "whole":
        assert runs.tolist() == [len(x)]               # a run of every row
        assert int((pieces[:, 1] == packing.HALO_PIECE).sum()) > 1
    else:
        assert int(runs.min()) == 1 and int(runs.max()) > 1
        # K16's runs are cut at its ring's row tiles
        tiles = lay16.row_id.long() // BLOCK_N
        for p0, c, _, t, _ in halo_pieces(lay16).tolist():
            assert bool((tiles[p0:p0 + c] == t).all())
    if case == "airline":
        assert bool((xk == INF).any()) and bool((wk == -INF).any())
        assert not bool((a[xk == INF] >= 0).any())
    assert 0 < int((a >= 0).sum()) < len(x)
    # the skips: columns keyed at most a piece's least key pass over
    assert w11.kept < w11.loaded
    assert int(w16.live[:, 0].sum()) > 0


def test_long_runs_and_key_bands():
    """A dense mixture in 2-d: runs longer than a piece, cut into key
    bands of HALO_PIECE rows from each run's first row, keys ascending
    within a run."""
    pts = gaussian_mixture(3000, d=2, seed=4)[0]
    dc = pick_dcut(pts, target_rho=200)
    x, xk, win, wk, st, en = _shard(pts, dc, 0, 3000)
    _check(x, xk, win, wk, st, en, dc)
    lay = packing.halo_layout(xk, win, wk, st, en, ring=False)
    runs = _runs(st, en, win.shape[0])
    assert int(runs.max()) > 2 * packing.HALO_PIECE
    new = packing.span_runs(st, en, win.shape[0])
    first = torch.nonzero(new).flatten()
    rid = torch.cumsum(new, 0) - 1
    # rows stay in their run's positions, sorted by key within it
    assert torch.equal(rid[lay.row_id.long()], rid)
    k = xk[lay.row_id.long()]
    same = rid[1:] == rid[:-1]
    assert bool((k[1:][same] >= k[:-1][same]).all())
    pieces = halo_pieces(lay)
    off = pieces[:, 0] - first[rid[pieces[:, 0]]]
    assert bool((off % packing.HALO_PIECE == 0).all())
    a, b = packing.clip_spans(st, en, win.shape[0])
    cost = ((b - a).sum(1)[pieces[:, 2]]
            * (1 + (pieces[:, 1] > 32))).tolist()
    assert cost == sorted(cost, reverse=True)          # most work first
    # the heaviest pieces cut into splits (here 1/64 of the work each at
    # most), which merge to the same answer as one split a piece
    d2cut = sweep.d2cut_of(dc)
    ring = _ring(x, win, st, en, dc)
    one = schedule(x, xk, win, wk, st, en, d2cut, splits=1)
    for r in (None, ring):
        b64, a64, lay64, w64 = schedule(x, xk, win, wk, st, en, d2cut, r)
        assert w64.splits > 0 and int(lay64.meta[0]) == int(
            halo_pieces(lay64)[:, 4].sum())
        assert torch.equal(b64, one[0]) and torch.equal(a64, one[1])


def test_walks_end_on_their_own():
    """Keys falling left to right on the 48 x 48 lattice (d_cut 12.5):
    every row but the first lattice column's finds its left neighbour at
    distance 1, so pieces end their walks before their ring's end, and
    sooner than their row tile's block-wide walk."""
    g = np.stack(np.meshgrid(np.arange(48), np.arange(48)), -1)
    pts = g.reshape(-1, 2).astype(np.float32)

    def key(gp):
        return -gp[:, 0].contiguous()

    args = _shard(pts, 12.5, 500, 1800, key=key)
    b, a, _, (lay16, w16, ring, tile_walk) = _check(*args, 12.5)
    assert int((b == 1.0).sum()) > len(b) // 2
    assert w16.walk_ends > 0
    assert bool((w16.live[:, 1] < tile_walk).any())


@pytest.mark.parametrize("levels", [3, 1])
def test_ties_equal_keys_and_dcut(levels):
    """The 40 x 40 lattice, d_cut 2 (d2cut 4, an exact integer): pairs at
    d2 exactly d_cut^2 are left out, equal keys are not denser (three key
    levels, or one: nothing is denser), and exact ties go to the lower
    window index."""
    g = np.stack(np.meshgrid(np.arange(40), np.arange(40)), -1)
    pts = g.reshape(-1, 2).astype(np.float32)
    dc = 2.0

    def key(gp):
        return (torch.arange(len(gp)) % levels).float()

    x, xk, win, wk, st, en = _shard(pts, dc, 300, 1400, key=key)
    b, a, _, _ = _check(x, xk, win, wk, st, en, dc)
    idx, valid = sweep._span_candidates(st, en, win.shape[0])
    d2 = sweep.direct_d2(x[:, None, None, :], win[idx])
    denser = valid & (wk[idx] > xk[:, None, None])
    equal = valid & (wk[idx] == xk[:, None, None]) & (d2 > 0)
    if levels == 1:
        assert not bool(denser.any()) and not bool((a >= 0).any())
        return
    assert bool((denser & (d2 == 4.0)).any())          # at d_cut^2: out
    assert bool((b[a >= 0] < 4.0).all())
    # an equal key nearer than the answer, passed over
    near_eq = (equal & (d2 < b[:, None, None])).flatten(1).any(1)
    assert bool((near_eq & (a >= 0)).any())
    # ties: rows whose best d2 two denser columns share
    hits = (denser & (d2 == b[:, None, None])).flatten(1).sum(1)
    assert int((hits > 1).sum()) > 10


def test_tie_across_spans_and_ring_entries():
    """A tie at d2 = 25 between window index 100 (span 0, column tile 0)
    and 700 (span 1, tile 1), the ring visiting tile 1 first (a row at the
    query's own point, not denser, gives it lb 0): both pick 100.  A
    column tile whose largest key equals the rows' key is passed over."""
    w = 1100
    win = np.zeros((w, 2), np.float32)
    win[:, 0] = 1000 + np.arange(w)                 # far from the query
    win[:, 1] = 1000
    win[100] = (3, 4)
    win[700] = (5, 0)
    win[650] = (0, 0)
    wk = np.full(w, 1.0, np.float32)
    wk[650] = -1.0
    wk[1024:] = 0.5                                 # tile 2: largest key 0.5
    x = np.array([[0, 0], [0, 0]], np.float32)
    xk = np.array([0.5, 0.0], np.float32)
    st = np.array([[0, 600, 1030]] * 2, np.int32)
    en = np.array([[300, 900, 1100]] * 2, np.int32)
    args = [_t(v) for v in (x, xk, win, wk, st, en)]
    ring = _ring(args[0], args[2], args[4], args[5], 6.0)
    order = ring.col_tile[ring.row_ptr[0]:ring.row_ptr[1]].tolist()
    assert order.index(1) < order.index(0)            # tile 1 first
    b, a, (lay, w11), _ = _check(*args, 6.0)
    assert a.tolist() == [100, 100] and b.tolist() == [25.0, 25.0]
    # the piece's least key (0.0) is below tile 2's largest (0.5): tile 2
    # is loaded; a piece of the 0.5 row alone passes it over
    one = [t[:1].contiguous() for t in args[:2]] + args[2:4] + \
        [t[:1].contiguous() for t in args[4:]]
    b1, a1, _, w1 = schedule(*one, sweep.d2cut_of(6.0), splits=1)
    assert w1.tiles_skipped == 1 and a1.tolist() == [100]
    assert float(packing.tile_max_key(args[3])[2]) == float(xk[0])


@pytest.mark.parametrize("d", [1, 2, 3, 8, 11])
def test_dims(d):
    """d = 1-8 (the kernels' register rows) and d = 11 (the generic
    path): both schedules equal the plain versions on a grid shard."""
    pts = uniform_points(1200, d, seed=50 + d) * 100
    dc = pick_dcut(pts, target_rho=20)
    args = _shard(pts, dc, 300, 1100, extra=True)
    b, a, _, _ = _check(*args, dc)
    assert 0 < int((a >= 0).sum())


def _jhalo_inputs(pts, dc, r0, r1):
    """A shard of the reference's grid (the port's is bit-equal), its
    window and window-local spans, as test_torch_dist_kernels makes
    them."""
    g = jbuild_grid(jnp.asarray(pts), dc)
    st, en = (np.asarray(a) for a in jpoint_span_bounds(g))
    st, en = st[r0:r1], en[r0:r1]
    live = en > st
    lo = min(int(st[live].min()), r0)
    hi = max(int(en[live].max()), r1)
    gp = np.asarray(g.points)
    return gp[r0:r1], gp[lo:hi], (st - lo).astype(np.int32), \
        (en - lo).astype(np.int32), gp, lo


def test_schedule_matches_pallas():
    """Both schedules against the reference's Pallas kernel in interpret
    mode on unit-scale data, d_cut clear of every pair."""
    pts = uniform_points(1000, 2, seed=23)
    dc = clear_dcut(pts, target_rho=20)
    x, win, st, en, gp, lo = _jhalo_inputs(pts, dc, 300, 800)
    key = _keys(_t(gp), dc)
    xk = key[300:800].contiguous()
    wk = key[lo:lo + len(win)].contiguous()
    jd, jp, jf = (np.asarray(v) for v in jops.halo_dependent(
        jnp.asarray(x), jnp.asarray(xk.numpy()), jnp.asarray(win),
        jnp.asarray(wk.numpy()), jnp.asarray(st), jnp.asarray(en), dc,
        interpret=True))
    args = (_t(x), xk, _t(win), wk, _t(st), _t(en))
    ring = _ring(args[0], args[2], args[4], args[5], dc)
    for r in (None, ring):
        b, a, _, _ = schedule(*args, sweep.d2cut_of(dc), r)
        np.testing.assert_array_equal((a >= 0).numpy(), jf)
        np.testing.assert_array_equal(a.numpy(), jp)
        np.testing.assert_allclose(torch.sqrt(b).numpy(), jd, rtol=1e-6)
    assert 0 < int(jf.sum()) < len(x)


def test_schedule_matches_jnp():
    """Both schedules against the reference's ``jnp`` halo NN on Airline's
    domain-scale data, off the rows with a pair within 4 f32 ulps of
    d_cut^2."""
    pts = real_proxy("airline", 2000, seed=12)[0]
    dc = pick_dcut(pts, target_rho=30)
    x, win, st, en, gp, lo = _jhalo_inputs(pts, dc, 700, 1400)
    key = _keys(_t(gp), dc)
    xk = key[700:1400].contiguous()
    wk = key[lo:lo + len(win)].contiguous()
    span_w = int((en - st).max())
    jd, jp, jf = (np.asarray(v) for v in jget_backend("jnp").denser_nn_halo(
        jnp.asarray(x), jnp.asarray(xk.numpy()), jnp.asarray(win),
        jnp.asarray(wk.numpy()), jnp.asarray(st), jnp.asarray(en), dc,
        span_cap=span_w))
    thr = f32_d2cut(dc)
    keep = ~near_threshold_rows(x, win, thr, 4 * f32_ulp(thr))
    args = (_t(x), xk, _t(win), wk, _t(st), _t(en))
    ring = _ring(args[0], args[2], args[4], args[5], dc)
    for r in (None, ring):
        b, a, _, _ = schedule(*args, sweep.d2cut_of(dc), r)
        np.testing.assert_array_equal((a >= 0).numpy()[keep], jf[keep])
        np.testing.assert_array_equal(a.numpy()[keep], jp[keep])
        np.testing.assert_allclose(torch.sqrt(b).numpy()[keep], jd[keep],
                                   rtol=1e-6)
