"""The host side of the K10 and K15 kernels (``kernels/packing.py``) and
their schedule.

Both kernels count, per query row, the window rows within d_cut inside
the row's spans (K15 only inside its row tile's ``in_cut`` worklist
entries).  They take the window as packed records and the rows by piece
(``packing.halo_layout`` with no key): consecutive rows whose spans clip
to the same columns form a run, the rows keep their positions, each run
is cut into pieces of at most ``HALO_PIECE`` rows from its first (K15's
runs also at its worklist's row tiles), the pieces ordered by work, most
first, and the heaviest cut into splits.  A warp takes a piece's split
and streams each of its span columns once for all of the piece's rows,
32 columns a chunk: a row a lane (two above 32 rows), or, for a piece of
at most ``COUNT_BALLOT_ROWS`` rows (d <= 8), a column a lane, each row's
count the popcount of a ballot.  A split is a slice of the piece's span
columns laid end to end; K15 computes only its stretches in the column
tiles of its row tile's in_cut entries.  A piece of one split stores its
counts, splits add theirs.

``schedule`` below runs that schedule in plain PyTorch with the kernels'
rules, on what the wrapper builds.  The tests hold it bit for bit against
``halo_range_count_plain`` and ``worklist_halo_range_count_plain`` (the
plain K10 and K15) and against the JAX package's ``halo_density`` (Pallas
interpret mode on unit-scale data, ``jnp`` on domain-scale data off the
threshold band), and assert each case the kernels must meet on its
input.  The kernels themselves are held against the plain versions on
the card by chip_smoke.py (phases 16, 17 and 23).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels.backend import get_backend as jget_backend

from repro_torch.core.grid import build_grid, point_span_bounds
from repro_torch.core.tuning import pick_dcut
from repro_torch.data.points import gaussian_mixture, real_proxy
from repro_torch.kernels import blocksparse, ops, packing, sweep
from repro_torch.kernels.blocksparse import BLOCK_M, BLOCK_N

from _torch_ref import (clear_dcut, f32_d2cut, f32_ulp, near_threshold_rows,
                        uniform_points)
from _torch_ref import one_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

CHUNK = 32                       # columns a warp loads at once
NAN = float("nan")


def _t(a):
    return torch.from_numpy(np.array(a))


class Work:
    """What the schedule ran: pieces by form (``cols``: a column a lane;
    ``rows1``, ``rows2``: one or two rows a lane), splits beyond one a
    piece, the column ranges and 32-column chunks walked, the lane-pairs
    computed and those holding a real row and column."""

    def __init__(self):
        self.forms = {"cols": 0, "rows1": 0, "rows2": 0}
        self.splits = self.ranges = self.chunks = 0
        self.lane_pairs = self.real_pairs = 0


def count_pieces(lay):
    """(P, 3) int64: the pieces of a layout in the kernels' order (most
    work first): first position (its rows are the positions from it, and
    its spans its first row's), rows, splits (``item_end``'s steps)."""
    live = lay.plen[lay.order.long()] > 0
    p0 = lay.order.long()[live]
    ends = lay.item_end.long()[live]
    parts = torch.diff(ends, prepend=ends.new_zeros(1))
    return torch.stack([p0, lay.plen[p0].long(), parts], 1)


def form_of(rows: int, d: int) -> str:
    """The kernel's form for a piece of ``rows`` rows at dimension d."""
    if rows > 32:
        return "rows2"
    return "cols" if d <= 8 and rows <= packing.COUNT_BALLOT_ROWS \
        else "rows1"


def k10_ranges(spans, part, parts):
    """Split ``part`` of ``parts``: its slice of the spans' columns
    (clipped) laid end to end, as [a, b) ranges."""
    cols = sum(b - a for a, b in spans if b > a)
    c0, c1 = cols * part // parts, cols * (part + 1) // parts
    out, off = [], 0
    for a0, b0 in spans:
        if off >= c1:
            break
        if a0 >= b0:
            continue
        a, b = a0 + max(c0 - off, 0), a0 + min(c1 - off, b0 - a0)
        off += b0 - a0
        if a < b:
            out.append((a, b))
    return out


def cut_tiles(wl, tile):
    """The column tiles of the row tile's in_cut entries (the bits K15's
    call sets for it)."""
    seg = slice(int(wl.row_ptr[tile]), int(wl.row_ptr[tile + 1]))
    return set(wl.col_tile[seg][wl.in_cut[seg]].tolist())


def k15_ranges(wl, tile, spans, part, parts):
    """K15's split ``part`` of ``parts``: K10's slice, each range cut to
    its stretches in the column tiles of the row tile's in_cut entries."""
    cut = cut_tiles(wl, tile)
    out = []
    for a, b in k10_ranges(spans, part, parts):
        ra = a
        while ra < b:
            while ra < b and ra // BLOCK_M not in cut:
                ra = (ra // BLOCK_M + 1) * BLOCK_M
            rb = ra
            while rb < b and rb // BLOCK_M in cut:
                rb = min(b, (rb // BLOCK_M + 1) * BLOCK_M)
            if ra < rb:
                out.append((ra, rb))
            ra = rb
    return out


def _count(xr, rec, d, a, b, d2cut, form, work):
    """The piece's rows' counts over columns [a, b), 32 a chunk: the
    lanes past b load column a; a row a lane computes only the columns
    below b, a column a lane sets a lane past b to NaN (d2 NaN, not
    counted) and takes each row's popcount."""
    nc = -(-(b - a) // CHUNK)
    j = a + torch.arange(nc * CHUNK).view(nc, CHUNK)
    live = j < b
    y = rec[torch.where(live, j, a), :d]
    if form == "cols":
        y[..., 0] = torch.where(live, y[..., 0], NAN)
        ok = sweep.direct_d2(xr[:, None, None, :], y[None]) < d2cut
        lanes = CHUNK
    else:
        ok = (sweep.direct_d2(xr[:, None, None, :], y[None]) < d2cut) & live
        lanes = CHUNK * (2 if form == "rows2" else 1)
    work.ranges += 1
    work.chunks += nc
    work.lane_pairs += (nc * CHUNK * xr.shape[0] if form == "cols"
                        else lanes * (b - a))
    work.real_pairs += xr.shape[0] * (b - a)
    return ok.sum((1, 2))


def schedule(x, win, st, en, d2cut, wl=None, splits=64):
    """(n,) int32 counts through K10's schedule, or K15's on ``wl``, the
    layout (pieces of more than 1/``splits`` of the work split) and the
    ``Work``."""
    n, d = x.shape
    w = win.shape[0]
    lay = packing.halo_layout(None, win, None, st, en, ring=wl is not None,
                              splits=splits)
    count = torch.zeros((n,), dtype=torch.int64)
    work = Work()
    for p0, rows, parts in count_pieces(lay).tolist():
        form = form_of(rows, d)
        work.forms[form] += 1
        work.splits += parts - 1
        spans = [(max(int(s), 0), min(int(e), w))
                 for s, e in zip(st[p0].tolist(), en[p0].tolist())]
        xr = x[lay.row_id[p0:p0 + rows].long()]
        for part in range(parts):
            ranges = (k10_ranges(spans, part, parts) if wl is None else
                      k15_ranges(wl, p0 // BLOCK_N, spans, part, parts))
            cnt = torch.zeros((rows,), dtype=torch.int64)
            for a, b in ranges:
                cnt += _count(xr, lay.rec, d, a, b, d2cut, form, work)
            if parts == 1:
                count[p0:p0 + rows] = cnt
            else:
                count[p0:p0 + rows] += cnt
    return count.to(torch.int32), lay, work


def _count_wl(x, win, st, en, dc):
    return blocksparse.build_flat_worklist(x, win, dc, nn=None, starts=st,
                                           ends=en)


def _check(x, win, st, en, dc, splits=64):
    """Both schedules bit for bit against the plain K10 and K15 and the
    CPU route of ``ops.halo_density``; returns (counts, K10's layout and
    work, K15's layout, work and worklist)."""
    d2cut = sweep.d2cut_of(dc)
    want = sweep.halo_range_count_plain(x, win, st, en, d2cut)
    wl = _count_wl(x, win, st, en, dc)
    c10, lay10, w10 = schedule(x, win, st, en, d2cut, splits=splits)
    c15, lay15, w15 = schedule(x, win, st, en, d2cut, wl, splits=splits)
    assert torch.equal(c10, want)
    assert torch.equal(c15, sweep.worklist_halo_range_count_plain(
        x, win, st, en, d2cut, wl))
    assert torch.equal(c15, want)
    assert torch.equal(ops.halo_density(x, win, st, en, dc), want.float())
    return want, (lay10, w10), (lay15, w15, wl)


def _shard(pts, dc, r0, r1, extra=False, pad=0):
    """Rows [r0, r1) of the grid-sorted table (``pad`` padded rows at 1e9
    appended to it, the shard reaching into them as a ragged last shard
    does, with empty spans), the window their spans reach and the spans
    made window-local.  ``extra`` adds a reversed, a negative, a
    negative-start and a past-the-window span to every row.  Returns
    (x, window, starts, ends)."""
    g = build_grid(_t(pts), dc)
    gp = g.points
    st, en = (a.numpy() for a in point_span_bounds(g))
    gp = torch.cat([gp, torch.full((pad, gp.shape[1]), sweep.PAD_COORD)])
    st = np.concatenate([st, np.zeros((pad, st.shape[1]), st.dtype)])
    en = np.concatenate([en, np.zeros((pad, en.shape[1]), en.dtype)])
    r1 = min(r1, len(gp))
    st, en = st[r0:r1], en[r0:r1]
    live = en > st
    lo = min(int(st[live].min()), r0)
    hi = max(int(en[live].max()), r1)
    st, en = st - lo, en - lo
    if extra:
        w = hi - lo
        more = np.array([[7, 3], [-9, -3], [-5, 0], [w, w + 40]])
        st = np.concatenate([st, np.tile(more[:, 0], (len(st), 1))], 1)
        en = np.concatenate([en, np.tile(more[:, 1], (len(en), 1))], 1)
    return (gp[r0:r1].contiguous(), gp[lo:hi].contiguous(),
            _t(st.astype(np.int32)), _t(en.astype(np.int32)))


def _runs(st, en, w):
    """Rows per run."""
    return torch.bincount(torch.cumsum(packing.span_runs(st, en, w), 0) - 1)


@pytest.mark.parametrize("case", ["airline", "mixture"])
def test_schedule_matches_plain(case):
    """Grid-sorted shards (Airline's d = 3 with a ragged last shard's
    padded rows, a 2-d mixture) with the extra empty, negative, reversed
    and past-the-window spans: both schedules equal the plain K10 and
    K15, padded rows count 0, and every form of piece occurs."""
    if case == "airline":
        pts = real_proxy("airline", 1500, seed=11)[0]
        dc = pick_dcut(pts, target_rho=30)
        x, win, st, en = _shard(pts, dc, 900, 1600, extra=True, pad=100)
    else:
        pts = gaussian_mixture(1500, d=2, seed=11)[0]
        dc = pick_dcut(pts, target_rho=60)
        x, win, st, en = _shard(pts, dc, 200, 900, extra=True)
    want, (lay, w10), (lay15, w15, wl) = _check(x, win, st, en, dc)
    runs = _runs(st, en, win.shape[0])
    assert int(runs.min()) == 1 and int(runs.max()) > 1
    if case == "airline":
        pad = x[:, 0] == sweep.PAD_COORD
        assert bool(pad.any()) and not bool(want[pad].any())
    assert 0 < int((want > 0).sum()) < len(x) + 1
    for w in (w10, w15):
        assert w.forms["cols"] > 0 and w.forms["rows1"] + w.forms["rows2"] > 0


def _layout_rules(lay, st, en, w, ring):
    """The keyless layout's rules on its arrays."""
    n = st.shape[0]
    assert torch.equal(lay.row_id.long(), torch.arange(n))  # position order
    assert lay.tmax.numel() == 0
    new = packing.span_runs(st, en, w, BLOCK_N if ring else None)
    rid = torch.cumsum(new, 0) - 1
    first = torch.nonzero(new).flatten()
    pieces = count_pieces(lay)
    p0, rows, parts = pieces.T
    assert int(rows.max()) <= packing.HALO_PIECE
    assert int(rows.sum()) == n                                # every row
    assert int(lay.meta[1]) == len(pieces)
    assert int(lay.meta[0]) == int(parts.sum())
    # a piece starts every HALO_PIECE rows from its run's first, inside it
    assert bool(((p0 - first[rid[p0]]) % packing.HALO_PIECE == 0).all())
    assert bool((rid[p0 + rows - 1] == rid[p0]).all())
    if ring:
        assert bool(((p0 // BLOCK_N) == ((p0 + rows - 1) // BLOCK_N)).all())
    a, b = packing.clip_spans(st, en, w)
    cols = (b - a).long().sum(1)[p0]
    cost = torch.where(rows > 32, 64, torch.where(
        rows > packing.COUNT_BALLOT_ROWS, 32, 2 * rows))
    work = (cols * cost).tolist()
    assert work == sorted(work, reverse=True)                  # most first
    return pieces


def test_keyless_layout():
    """The count's layout on a 2-d mixture shard with long runs: rows in
    position order, pieces of at most HALO_PIECE rows cut from each run's
    first, K15's at its row tiles, the records' slots 0, no tile keys;
    with ``splits`` 512 the heaviest pieces cut mid-span and at span
    ends, the splits' columns disjoint and covering the piece's span
    columns (K15: those in its in_cut tiles) exactly once."""
    pts = gaussian_mixture(2000, d=2, seed=4)[0]
    dc = pick_dcut(pts, target_rho=150)
    x, win, st, en = _shard(pts, dc, 0, 2000, extra=True)
    w = win.shape[0]
    assert int(_runs(st, en, w).max()) > 2 * packing.HALO_PIECE
    wl = _count_wl(x, win, st, en, dc)
    for ring in (False, True):
        lay = packing.halo_layout(None, win, None, st, en, ring=ring,
                                  splits=512)
        assert torch.equal(lay.rec[:, :2], win)
        assert not bool(lay.rec[:, 2:].view(torch.int32).any())
        pieces = _layout_rules(lay, st, en, w, ring)
        split = pieces[pieces[:, 2] > 1]
        assert len(split) > 0
        mid = ends = 0
        for p0, rows, parts in split.tolist():
            spans = [(max(int(s), 0), min(int(e), w))
                     for s, e in zip(st[p0].tolist(), en[p0].tolist())]
            want = sorted(j for a, b in spans for j in range(a, b))
            got = []
            for part in range(parts):
                rs = (k10_ranges(spans, part, parts) if not ring else
                      k15_ranges(wl, p0 // BLOCK_N, spans, part, parts))
                got += [j for a, b in rs for j in range(a, b)]
                last = rs[-1][1] if rs else None
                mid += not any(last == b for _, b in spans)
                ends += any(last == b for _, b in spans)
            if ring:
                cut = cut_tiles(wl, p0 // BLOCK_N)
                want = [j for j in want if j // BLOCK_M in cut]
            assert sorted(got) == want                   # once each
        assert mid > 0 and ends > 0
        # the splits change nothing
        one = schedule(x, win, st, en, sweep.d2cut_of(dc),
                       wl if ring else None, splits=1)
        many = schedule(x, win, st, en, sweep.d2cut_of(dc),
                        wl if ring else None, splits=512)
        assert one[2].splits == 0 and many[2].splits > 0
        assert torch.equal(one[0], many[0])
    _check(x, win, st, en, dc, splits=512)


def _run_table(lengths, d, seed, w=3000):
    """Rows in runs of the given lengths, each run with its own spans (two
    disjoint ones) over a uniform window of ``w`` points; d_cut near 20
    neighbours.  Returns (x, window, starts, ends, d_cut)."""
    rng = np.random.default_rng(seed)
    win = rng.uniform(size=(w, d)).astype(np.float32)
    n = sum(lengths)
    x = rng.uniform(size=(n, d)).astype(np.float32)
    st = np.zeros((n, 2), np.int32)
    en = np.zeros((n, 2), np.int32)
    r = 0
    for length in lengths:
        a = int(rng.integers(0, w // 2))
        b = a + int(rng.integers(40, 900))
        c = b + int(rng.integers(1, 300))
        e = min(w, c + int(rng.integers(1, 700)))
        st[r:r + length] = (a, c)
        en[r:r + length] = (b, e)
        r += length
    dc = clear_dcut(win, target_rho=20)
    return _t(x), _t(win), _t(st), _t(en), dc


@pytest.mark.parametrize("d", [2, 3])
def test_run_lengths(d):
    """Runs of 1, 31, 32, 33, 64, 65, 16, 17 and 300 rows (a piece of
    one row, the forms' edges, a run longer than a piece, a row tile
    boundary inside a run): the pieces and their forms, and both
    schedules equal the plain versions."""
    lengths = [1, 31, 32, 33, 64, 65, 16, 17, 300]
    x, win, st, en, dc = _run_table(lengths, d, seed=30 + d)
    w = win.shape[0]
    assert _runs(st, en, w).tolist() == lengths
    _, (lay, w10), (lay15, w15, _) = _check(x, win, st, en, dc)
    _layout_rules(lay, st, en, w, ring=False)
    _layout_rules(lay15, st, en, w, ring=True)
    got = sorted(count_pieces(lay)[:, 1].tolist())
    assert got == sorted([1, 31, 32, 33, 64, 64, 1, 16, 17]
                         + [64] * 4 + [44])
    # a column a lane: 1, 65's last row, 16; a row a lane: 31, 32, 17;
    # two: 33, 64, 65's first 64, 300's five
    assert w10.forms == {"cols": 3, "rows1": 3, "rows2": 8}
    # K15's pieces stop at the row tiles' bounds inside the runs of 17
    # (positions 242-258) and 300 (259-558)
    firsts = count_pieces(lay15)[:, 0].tolist()
    assert 256 in firsts and 512 in firsts


def test_whole_window_one_run():
    """Every row with the same spans over the whole window (one run cut
    into pieces of HALO_PIECE rows, the last shorter), a reversed and a
    past-the-window span among them: the count is the dense one."""
    pts = uniform_points(1300, 3, seed=11)
    dc = pick_dcut(pts, target_rho=20)
    x, win, _, _ = _shard(pts, dc, 0, 1300)
    w = win.shape[0]
    sp = torch.tensor([[0, w // 3], [w // 3, w + 5], [9, 2]],
                      dtype=torch.int32)
    st = sp[:, 0].expand(len(x), 3).contiguous()
    en = sp[:, 1].expand(len(x), 3).contiguous()
    want, (lay, _), _ = _check(x, win, st, en, dc)
    assert _runs(st, en, w).tolist() == [len(x)]
    rows = count_pieces(lay)[:, 1]
    assert int((rows == packing.HALO_PIECE).sum()) == len(x) // 64
    assert torch.equal(want, sweep.range_count_plain(x, win,
                                                     sweep.d2cut_of(dc)))


def test_edge_cases():
    """NaN coordinates never count; a row count that is not a multiple of
    256; an empty window (W = 0); no rows (n = 0)."""
    pts = uniform_points(700, 2, seed=5) * 100
    dc = pick_dcut(pts, target_rho=20)
    x, win, st, en = _shard(pts, dc, 100, 400)
    x[7, 1] = NAN                      # a NaN query row
    win[win.shape[0] // 2, 0] = NAN    # a NaN window row
    d2cut = sweep.d2cut_of(dc)
    want = sweep.halo_range_count_plain(x, win, st, en, d2cut)
    assert int(want[7]) == 0 and len(x) % BLOCK_N != 0
    wl = _count_wl(x, win, st, en, dc)
    for r in (None, wl):
        c, _, _ = schedule(x, win, st, en, d2cut, r)
        plain = want if r is None else \
            sweep.worklist_halo_range_count_plain(x, win, st, en, d2cut, r)
        assert torch.equal(c, plain)
    # the NaN window row counts as a row far away would
    far = win.clone()
    far[win.shape[0] // 2] = sweep.PAD_COORD
    assert torch.equal(want, sweep.halo_range_count_plain(x, far, st, en,
                                                          d2cut))
    empty = win[:0]
    c, lay, _ = schedule(x, empty, st, en, d2cut)
    assert not bool(c.any()) and int(lay.meta[0]) == len(count_pieces(lay))
    assert ops.halo_density(x[:0], win, st[:0], en[:0], dc).shape == (0,)
    assert not bool(ops.halo_density(x, empty, st, en, dc).any())


@pytest.mark.parametrize("d", [1, 2, 3, 8, 11])
def test_dims(d):
    """d = 1-8 (the kernels' register rows, both forms) and d = 11 (the
    generic path, a row a lane only): both schedules equal the plain
    versions on a grid shard."""
    pts = uniform_points(900, d, seed=50 + d) * 100
    dc = pick_dcut(pts, target_rho=20)
    x, win, st, en = _shard(pts, dc, 200, 800, extra=True)
    want, (_, w10), _ = _check(x, win, st, en, dc)
    assert int(want.sum()) > 0
    assert (w10.forms["cols"] > 0) == (d <= 8)


def test_schedule_matches_pallas():
    """Both schedules against the reference's Pallas kernel in interpret
    mode on unit-scale data, d_cut clear of every pair."""
    pts = uniform_points(500, 2, seed=23)
    dc = clear_dcut(pts, target_rho=20)
    args = _shard(pts, dc, 200, 400)
    want = np.asarray(jops.halo_density(
        *(jnp.asarray(a.numpy()) for a in args), dc, interpret=True))
    for r in (None, _count_wl(*args, dc)):
        c, _, _ = schedule(*args, sweep.d2cut_of(dc), r)
        np.testing.assert_array_equal(c.numpy(), want)
    assert 0 < int(want.min()) and int(want.max()) > 20


def test_schedule_matches_jnp():
    """Both schedules against the reference's ``jnp`` halo count on
    Airline's domain-scale data, off the rows with a pair within 4 f32
    ulps of d_cut^2."""
    pts = real_proxy("airline", 1200, seed=12)[0]
    dc = pick_dcut(pts, target_rho=30)
    args = _shard(pts, dc, 500, 850)
    x, win, st, en = (a.numpy() for a in args)
    span_w = int((en - st).max())
    want = np.asarray(jget_backend("jnp").range_count_halo(
        jnp.asarray(x), jnp.asarray(win), jnp.asarray(st), jnp.asarray(en),
        dc, span_cap=span_w))
    thr = f32_d2cut(dc)
    keep = ~near_threshold_rows(x, win, thr, 4 * f32_ulp(thr))
    for r in (None, _count_wl(*args, dc)):
        c, _, _ = schedule(*args, sweep.d2cut_of(dc), r)
        np.testing.assert_array_equal(c.numpy()[keep], want[keep])
    assert int(keep.sum()) > len(x) // 2 and int(want.max()) > 1
