"""K13's schedule: the bf16 fused count + kept-8 on a worklist.

K13 puts K12's body on K3's walk.  A block owns one 256-row tile, 8 warps
of 32 rows, and walks its worklist segment in the stored order (ascending
lb), reading K12's bf16 column records (``packing.bf16_records``).  At each
entry one tile vote on the owners' fresh 8th kept d2 decides whether the
entry is NN-live (its lb at most some real row's 8th); an entry that is
neither in_cut nor NN-live is skipped, and past the split
(``packing.phase_split``) the first such entry ends the walk.  Each warp
then takes the entry's columns 16 at a time: the cheap test xy >= lim +
half with the entry's bound T (max(d2cut, cut) for an in_cut, NN-live
entry, d2cut for an in_cut one, cut, which may be below 0, for an NN-live
one; no test while some row of the warp has T = +inf), voted per warp and
group, and where it is taken, or the warp's last group counted or filtered
in, the exact d2: counted below d2cut in an in_cut entry, filtered at d2 <=
cut in an NN-live one (gated: the gate set).  Where the filter vote is taken, each
row's owner takes its 16 values in index order and inserts those below its
last kept pair lexicographically on (d2, index): entries arrive in lb
order, so a later entry may hold a lower index at an equal d2.
``schedule_k13`` runs that schedule in plain PyTorch; the tests hold it
against ``worklist_count_topk_bf16_plain`` (the kernel's plain version) bit
for bit and against the JAX package's bf16 worklist sweep in interpret
mode, and show on which inputs each of its cases occurs.
"""
import numpy as np
import pytest
import torch

from repro_torch import carry
from repro_torch.core.grid import build_grid
from repro_torch.data.points import real_proxy
from repro_torch.kernels import blocksparse, packing, sweep
from repro_torch.kernels.blocksparse import BLOCK_M, BLOCK_N
from repro_torch.kernels.packing import BF16_GROUP

from _torch_ref import f32_d2cut, uniform_points
from _torch_ref import one_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("one_thread")
from test_torch_bf16 import _assert_same_kept, _lattice, _ref_sweep
from test_torch_k12_schedule import LANES, WARP_ROWS, cross_bf16, k12_lim

from repro.kernels import blocksparse as jbs

_INT_MAX = 2**31 - 1
WARPS = BLOCK_N // WARP_ROWS
INF = float("inf")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


class Work:
    """What the schedule did, per row tile: the entries it computed (the
    kernel's ``live``), whether its walk ended past the split, and which
    cases it met."""

    def __init__(self, wl):
        self.live = torch.zeros(wl.num_row_tiles, dtype=torch.int64)
        self.ended = torch.zeros(wl.num_row_tiles, dtype=torch.bool)
        self.kinds = {"in_cut only": 0, "NN-live only": 0, "both": 0}
        self.below_lb = 0      # computed pairs whose bf16 d2 is below lb
        self.tie_lower = 0     # insertions before an equal d2, higher index
        self.groups = 0        # (warp, 16-column group) pairs computed
        self.open_groups = 0   # of them, where some row had T = +inf
        self.col_tiles = set()  # column tiles of the computed entries


def _insert(tv, ti, v, j, take):
    """Rows' kept lists after (v, j) enters those where ``take`` holds,
    lexicographically on (d2, index) (``k12_keep<true>``)."""
    lt = (v[:, None] < tv) | ((v[:, None] == tv) & (j < ti))
    prev = np.concatenate([np.zeros_like(lt[:, :1]), lt[:, :-1]], 1)
    nv = np.where(lt, np.where(prev, np.roll(tv, 1, 1), v[:, None]), tv)
    ni = np.where(lt, np.where(prev, np.roll(ti, 1, 1), j), ti)
    return (np.where(take[:, None], nv, tv), np.where(take[:, None], ni, ti))


def schedule_k13(x, y, d2cut, wl, sel=None):
    """(count, topv, topi) through K13's schedule, and its ``Work``.  Each
    entry's cross term and d2 come from torch; the warps' steps run in
    numpy float32, one rounding per operation as in torch."""
    n, d = x.shape
    rec = packing.bf16_records(y, sel)
    m16 = rec.rec.shape[0]
    yb = rec.rec[:, :d].float()
    y2, half = rec.norms[0], rec.norms[1].numpy()
    gate = None if rec.gate is None else rec.gate.numpy() != 0
    split = packing.phase_split(wl)
    order = packing.heaviest_first(wl, split).tolist()
    split = split.tolist()
    ptr, tiles = wl.row_ptr.tolist(), wl.col_tile.tolist()
    in_cut, lbs = wl.in_cut.tolist(), wl.lb.numpy()
    count = torch.zeros(n, dtype=torch.int32)
    topv = torch.full((n, 8), INF)
    topi = torch.full((n, 8), -1, dtype=torch.int32)
    work = Work(wl)
    f32 = np.float32
    for t in order:
        rows = torch.arange(t * BLOCK_N, (t + 1) * BLOCK_N)
        real = (rows < n).numpy()        # padding rows compute, never vote
        xr = x[rows.clamp(max=n - 1)]
        x2 = sweep.sq_norms(xr)
        tv = np.full((BLOCK_N, 8), INF, f32)                # the owners'
        ti = np.full((BLOCK_N, 8), _INT_MAX, np.int64)
        cnt = np.zeros((BLOCK_N, LANES), np.int64)
        last = np.ones(WARPS, bool)      # a warp's last group counted or in
        for e in range(ptr[t], ptr[t + 1]):
            ecut = in_cut[e]
            elive = bool((real & (lbs[e] <= tv[:, 7])).any())  # fresh
            if not (ecut or elive):
                if e >= split[t]:
                    work.ended[t] = True       # this entry and all later
                    break
                continue
            work.live[t] += 1
            work.col_tiles.add(tiles[e])
            work.kinds["both" if ecut and elive else
                       "in_cut only" if ecut else "NN-live only"] += 1
            j0 = tiles[e] * BLOCK_M
            cols = torch.arange(j0, min(j0 + BLOCK_M, m16))
            xy = cross_bf16(xr, yb[cols])
            d2 = ((x2[:, None] + y2[None, cols]) - 2.0 * xy).numpy()
            xy, x2n = xy.numpy(), x2.numpy()
            work.below_lb += int((d2[real] < lbs[e]).sum())
            thr = f32(d2cut if ecut else -INF)
            for c0 in range(0, cols.numel(), BF16_GROUP):
                gc = np.arange(j0 + c0, j0 + c0 + BF16_GROUP)
                gd2, gxy = d2[:, c0:c0 + BF16_GROUP], xy[:, c0:c0 + BF16_GROUP]
                cut = tv[:, 7].copy()
                tb = np.maximum(np.full(BLOCK_N, d2cut if ecut else -INF, f32),
                                cut if elive else f32(-INF))
                lim = k12_lim(x2n, tb)
                opened = (tb == INF).reshape(WARPS, WARP_ROWS).any(1)
                work.groups += WARPS
                work.open_groups += int(opened.sum())
                # the cheap test holds wherever the pair may count or enter
                test = gxy >= lim[:, None] + half[None, gc]
                need = ((gd2 < d2cut) & ecut) | ((gd2 <= cut[:, None]) & elive)
                assert not (need & ~test)[~opened.repeat(WARP_ROWS)].any(), \
                    "the cheap test missed"
                warp_exact = last | opened | test.reshape(WARPS, -1).any(1)
                exact = warp_exact.repeat(WARP_ROWS)[:, None]
                counted = (gd2 < thr) & exact
                q = (gc % 8) // 2
                cnt += np.stack([counted[:, q == k].sum(1)
                                 for k in range(LANES)], 1)
                passed = (gd2 <= cut[:, None]) & exact & elive   # the filter
                if gate is not None:
                    passed = passed & gate[gc]
                kept = passed.reshape(WARPS, -1).any(1)
                last = kept | counted.reshape(WARPS, -1).any(1)
                if not kept.any():
                    continue
                kept = kept.repeat(WARP_ROWS)
                # each owner takes its row's 16 values in index order
                for s, j in enumerate(gc.tolist()):
                    v = gd2[:, s]
                    take = ((v < tv[:, 7]) | ((v == tv[:, 7]) & (j < ti[:, 7]))
                            ) & kept
                    if gate is not None:
                        take = take & gate[j]
                    if not take.any():
                        continue
                    tie = ((tv == v[:, None]) & (ti > j)).any(1)
                    work.tie_lower += int(tie[take & real].sum())
                    tv, ti = _insert(tv, ti, v, j, take)
        keep = torch.from_numpy(real)
        count[rows[keep]] = torch.from_numpy(cnt[real].sum(1)).to(torch.int32)
        topv[rows[keep]] = torch.from_numpy(tv[real])
        topi[rows[keep]] = torch.from_numpy(
            np.where(ti[real] == _INT_MAX, -1, ti[real])).to(torch.int32)
    return (count, topv, topi), work


def walk_plain(x, y, d2cut, wl, sel=None, walk_end=True):
    """``worklist_count_topk_bf16_plain``'s loop, with (``walk_end``) or
    without the end of a walk at the first entry past the split that no row
    needs; also the entries each row tile computed and whether its walk
    ended early."""
    n, m = x.shape[0], y.shape[0]
    count = torch.zeros(n, dtype=torch.int32)
    topv = torch.full((n, 8), INF)
    topi = torch.full((n, 8), -1, dtype=torch.int32)
    live = torch.zeros(wl.num_row_tiles, dtype=torch.int64)
    ended = torch.zeros(wl.num_row_tiles, dtype=torch.bool)
    split = packing.phase_split(wl).tolist()
    ptr = wl.row_ptr.tolist()
    for t in range(wl.num_row_tiles):
        r0, r1 = t * BLOCK_N, min(n, (t + 1) * BLOCK_N)
        for e in range(ptr[t], ptr[t + 1]):
            cut = bool(wl.in_cut[e])
            nn = float(wl.lb[e]) <= float(topv[r0:r1, 7].max())
            if not (cut or nn):
                if walk_end and e >= split[t]:
                    ended[t] = e < ptr[t + 1]
                    break
                continue
            live[t] += 1
            tile = int(wl.col_tile[e])
            cols = torch.arange(tile * BLOCK_M, min(m, (tile + 1) * BLOCK_M))
            d2 = sweep.expanded_d2_bf16(x[r0:r1], y[cols])
            if cut:
                count[r0:r1] += (d2 < d2cut).sum(1, dtype=torch.int32)
            if nn:
                if sel is not None:
                    d2, cols = d2[:, sel[cols]], cols[sel[cols]]
                topv[r0:r1], topi[r0:r1] = sweep._lex_merge(
                    topv[r0:r1], topi[r0:r1], d2, cols)
    return (count, topv, topi), live, ended


def _same(got, want):
    c, v, i = got
    wc, wv, wi = want
    assert torch.equal(c, wc)
    assert torch.equal(v.view(torch.int32), wv.view(torch.int32))
    assert torch.equal(i, wi)


def _inputs(case, gated):
    """(x, y, d2cut, worklist, gate) of a named input, grid-sorted, n and m
    ragged (not multiples of 256 and 512).  ``lattice``: integers in
    [0, 40) x [0, 30) (exact bf16, ties decided by index; d_cut^2 30.5
    against an 8th neighbour at d2 2 to 8, so an in_cut-only entry);
    ``unit``:
    unit-scale d = 3 (negative d2 where a row meets itself); ``airline``:
    the Airline proxy, norms near 1e10 against a d_cut^2 near 4e5, so bf16
    d2 fall below their pairs' lb."""
    if case == "lattice":
        g = np.stack(np.meshgrid(np.arange(40), np.arange(30)), -1)
        pts = g.reshape(-1, 2).astype(np.float32)[:1100]
        dc = float(np.sqrt(30.5))
    elif case == "unit":
        pts = uniform_points(900, 3, seed=7)
        dc = 0.12
    else:
        pts = real_proxy("airline", 1200, seed=1)[0]
        dc = 600.0
    x = build_grid(_t(pts), dc).points.contiguous()
    sel = None
    if gated:
        sel = _t(np.random.default_rng(len(pts)).uniform(size=len(pts)) < 0.4)
    return x, x, f32_d2cut(dc), _worklist(x, x, dc, sel), sel


def _worklist(x, y, dc, sel):
    counts = None
    if sel is not None:
        counts = torch.bincount(torch.nonzero(sel).flatten() // BLOCK_M,
                                minlength=-(-y.shape[0] // BLOCK_M))
    return blocksparse.build_flat_worklist(x, y, dc, nn_col_counts=counts)


@pytest.mark.parametrize("gated", [False, True], ids=["ungated", "gated"])
@pytest.mark.parametrize("case", ["lattice", "unit", "airline"])
def test_schedule_equals_plain(case, gated):
    x, y, d2cut, wl, sel = _inputs(case, gated)
    got, work = schedule_k13(x, y, d2cut, wl, sel)
    _same(got, sweep.worklist_count_topk_bf16_plain(x, y, d2cut, wl,
                                                    sel=sel))
    # the same entries as the walk of the plain version with the walk end
    want, live, ended = walk_plain(x, y, d2cut, wl, sel)
    assert torch.equal(work.live, live) and torch.equal(work.ended, ended)
    # a ragged last row tile and a ragged last column tile, both computed
    assert x.shape[0] % BLOCK_N and y.shape[0] % BLOCK_M
    last_col = y.shape[0] // BLOCK_M
    assert work.live[-1] > 0 and last_col in work.col_tiles
    assert work.kinds["both"] > 0
    if case == "lattice":
        assert work.kinds["in_cut only"] > 0 and bool(work.ended.any())
    else:
        assert work.kinds["NN-live only"] > 0
    if case == "unit":
        assert bool((got[1] < 0).any())               # negative d2 kept
    if case == "airline":
        assert work.below_lb > 0


def test_equal_d2_at_a_lower_index_in_a_later_entry():
    """Duplicate points across column tiles: column tile 1 (the later
    indices) holds copies of tile 0's nearest column and one point near the
    rows, so its lb is the least and it is walked first; tile 0 then offers
    the same d2 at lower indices, which must enter ahead of the copies."""
    rows = np.stack(np.meshgrid(np.arange(16), np.arange(16)), -1)
    x = rows.reshape(-1, 2).astype(np.float32)
    far = np.stack(np.meshgrid(np.arange(20, 36), np.arange(16)), -1)
    tile0 = np.concatenate([far.reshape(-1, 2), far.reshape(-1, 2) + [20, 0]])
    copies = np.stack([np.full(16, 20), np.arange(16)], 1)
    tile1 = np.concatenate([[[16, 0]], copies,
                            np.stack([100 + np.arange(90),
                                      np.full(90, 100)], 1)])
    y = np.concatenate([tile0, tile1]).astype(np.float32)
    xt, yt = _t(x), _t(y)
    dc = float(np.sqrt(2.5))
    wl = _worklist(xt, yt, dc, None)
    assert wl.col_tile.tolist() == [1, 0]              # tile 1 first
    got, work = schedule_k13(xt, yt, f32_d2cut(dc), wl)
    _same(got, sweep.worklist_count_topk_bf16_plain(xt, yt, f32_d2cut(dc),
                                                    wl))
    assert work.tie_lower > 0
    assert work.kinds == {"in_cut only": 0, "NN-live only": 1, "both": 1}
    # row (15, 0): (16, 0) at d2 1, then (20, k) at 25 + k^2 from tile 0
    # (index 16k) ahead of its copy in tile 1 (index 513 + k)
    assert got[2][15].tolist() == [512, 0, 513, 16, 514, 32, 515, 48]


def test_fewer_than_8_selected_columns():
    """Gated to 5 columns: every row's 8th stays +inf, so every entry is
    NN-live and none ends a walk; the warps never take the cheap test."""
    x, y, d2cut, _, _ = _inputs("lattice", False)
    sel = torch.zeros(y.shape[0], dtype=torch.bool)
    sel[torch.randperm(y.shape[0],
                       generator=torch.Generator().manual_seed(0))[:5]] = True
    wl = _worklist(x, y, float(np.sqrt(d2cut)), sel)
    got, work = schedule_k13(x, y, d2cut, wl, sel)
    _same(got, sweep.worklist_count_topk_bf16_plain(x, y, d2cut, wl,
                                                    sel=sel))
    assert bool(torch.isinf(got[1][:, 5:]).all())
    assert bool((got[2][:, 5:] == -1).all())
    seg = (wl.row_ptr[1:] - wl.row_ptr[:-1]).long()
    assert torch.equal(work.live, seg) and not bool(work.ended.any())
    assert work.kinds["in_cut only"] == 0
    assert work.open_groups == work.groups > 0


@pytest.mark.parametrize("gated", [False, True], ids=["ungated", "gated"])
def test_schedule_equals_jax_worklist_sweep(gated):
    """On a lattice of 1,024 rows (no padding rows in the reference's last
    tile), through the reference's own worklist, the schedule equals the
    JAX package's bf16 worklist sweep in interpret mode."""
    pts, dc = _lattice(1024, 2, 0, 3, high=60)
    gp = build_grid(_t(pts), dc).points.numpy()
    sel = np.random.default_rng(5).uniform(size=1024) < 0.4 if gated \
        else None
    counts = None if sel is None else np.bincount(
        np.nonzero(sel)[0] // BLOCK_M, minlength=2)
    jwl = jbs.build_flat_worklist(gp, gp, dc, block_n=BLOCK_N,
                                  block_m=BLOCK_M, count=True, nn="topk",
                                  k=8, nn_col_counts=counts)
    wl = carry.flat_worklist(jwl.meta, jwl.lb, jwl.n_kept, jwl.n_total)
    tsel = None if sel is None else _t(sel)
    got, _ = schedule_k13(_t(gp), _t(gp), f32_d2cut(dc), wl, tsel)
    want = _ref_sweep(gp, gp, dc, sel, block_n=BLOCK_N, block_m=BLOCK_M,
                      worklist=jwl)
    c, v, i = got
    _assert_same_kept((c.to(torch.float32), v, i), want, 1024)


@pytest.mark.parametrize("gated", [False, True], ids=["ungated", "gated"])
@pytest.mark.parametrize("case", ["lattice", "airline"])
def test_plain_walk_end_equals_plain(case, gated):
    """Ending a walk at the first entry past the split that no row needs
    changes nothing: lb ascends, each 8th d2 only falls and nothing past
    the split counts, so every later entry fails the vote too."""
    x, y, d2cut, wl, sel = _inputs(case, gated)
    with_end, live_e, ended = walk_plain(x, y, d2cut, wl, sel)
    without, live, _ = walk_plain(x, y, d2cut, wl, sel, walk_end=False)
    _same(with_end, without)
    _same(without, sweep.worklist_count_topk_bf16_plain(x, y, d2cut, wl,
                                                        sel=sel))
    assert torch.equal(live_e, live)
    if case == "lattice":
        assert bool(ended.any())
