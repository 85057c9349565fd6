"""The host side of the K3 kernel (``kernels/packing.py``) and its schedule.

K3 walks each row tile's worklist segment in two phases: phase 1 up to the
last in-d_cut entry, every row counting and keeping; phase 2 the rest, the
kept-8 alone, while the block's loosest 8th d2 reaches the entry's lb, each
row still able to take an entry taking it (a warp per row, its lanes the
columns).  ``schedule_k3`` below runs that schedule in plain PyTorch on
what the wrapper builds (records, split, tile order), with the kernel's
update rules: the rows left for phase 2, the per-chunk block maximum, the
stop at the first dead entry and the per-row check.  The tests hold it
against ``worklist_count_topk_plain`` (the kernel's plain version) bit for
bit and against the JAX package's worklist sweep, and count its work.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import blocksparse as jbs
from repro.kernels import ops as jops

from repro_torch import carry
from repro_torch.core.grid import build_grid
from repro_torch.core.tuning import pick_dcut
from repro_torch.kernels import blocksparse, packing, sweep
from repro_torch.kernels.blocksparse import BLOCK_M, BLOCK_N

from _torch_ref import (clear_dcut, f32_d2cut, near_threshold_rows, pair_d2,
                        uniform_points)
from _torch_ref import one_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

_INT_MAX = 2**31 - 1
STAGE_VECS = 1024              # float4s of one ring stage (kStageVecs)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def unpack(rec, d):
    """(coordinates (m, d) f32, slot (m,) int32) of packed records."""
    return rec[:, :d], rec.view(torch.int32)[:, d]


def chunk_cols(d: int) -> int:
    """Columns of one staged chunk (``k3_chunk_cols``)."""
    return min(BLOCK_M, max(1, STAGE_VECS // (packing.record_width(d) // 4)))


def merge(tv, ti, d2, idx):
    """Rows' kept 8 after the columns ``idx`` with distances ``d2``: the 8
    lexicographically least (d2, index) pairs, as ``keep`` inserts them."""
    v = torch.cat([tv, d2], 1)
    i = torch.cat([ti, idx[None, :].expand(d2.shape[0], -1)], 1)
    o = torch.sort(i, dim=1, stable=True).indices
    v, i = v.gather(1, o), i.gather(1, o)
    o = torch.sort(v, dim=1, stable=True).indices
    return v.gather(1, o)[:, :8], i.gather(1, o)[:, :8]


class Work:
    """What the schedule ran: entries per row tile (the kernel's ``live``),
    pairs per phase (its ``ran``), and the (row, entry) pairs computed."""

    def __init__(self, n, wl):
        self.live = torch.zeros(wl.num_row_tiles, dtype=torch.int64)
        self.ran = torch.zeros((wl.num_row_tiles, 2), dtype=torch.int64)
        self.computed = torch.zeros((n, wl.n_kept), dtype=torch.bool)


def schedule_k3(x, y, d2cut, wl, sel=None):
    """(count, topv, topi) through K3's schedule, and its ``Work``."""
    n, d = x.shape
    m = y.shape[0]
    lay = packing.k3_layout(wl, y, sel)
    cap = chunk_cols(d)
    yc, gate = unpack(lay.rec, d)
    kc, kidx = unpack(lay.keep_rec, d)
    ptr, split = wl.row_ptr.tolist(), lay.split.tolist()
    tiles, cut, lb = wl.col_tile.tolist(), wl.in_cut.tolist(), wl.lb.tolist()
    count = torch.zeros(n, dtype=torch.int32)
    topv = torch.full((n, 8), float("inf"))
    topi = torch.full((n, 8), -1, dtype=torch.int32)
    work = Work(n, wl)

    def keep_range(e):
        c = tiles[e]
        if lay.keep_off is None:
            return c * BLOCK_M, min(c * BLOCK_M + BLOCK_M, m)
        return int(lay.keep_off[c]), int(lay.keep_off[c + 1])

    for t in lay.order.tolist():
        rows = torch.arange(t * BLOCK_N, (t + 1) * BLOCK_N)
        alive = rows < n
        xs = x[rows.clamp(max=n - 1)]
        tv = torch.full((BLOCK_N, 8), float("inf"))
        ti = torch.full((BLOCK_N, 8), _INT_MAX, dtype=torch.int64)
        cnt = torch.zeros(BLOCK_N, dtype=torch.int32)
        e0, p1, e1 = ptr[t], split[t], ptr[t + 1]
        # phase 1: every chunk, every row
        for e in range(e0, p1):
            j0 = tiles[e] * BLOCK_M
            for c0 in range(j0, min(j0 + BLOCK_M, m), cap):
                c1 = min(c0 + cap, j0 + BLOCK_M, m)
                d2 = sweep.direct_d2(xs[:, None, :], yc[None, c0:c1])
                if cut[e]:
                    cnt += (d2 < d2cut).sum(1, dtype=torch.int32)
                ok = gate[c0:c1] != 0 if sel is not None else slice(None)
                tv, ti = merge(tv, ti, d2[:, ok], torch.arange(c0, c1)[ok])
                work.ran[t, 0] += (c1 - c0) * BLOCK_N
            work.computed[rows[alive], e] = True
        work.live[t] = p1 - e0
        count[rows[alive]] = cnt[alive]
        need = alive & (p1 < e1)
        if p1 < e1:
            need &= tv[:, 7] >= lb[p1]
        slot = torch.nonzero(need).flatten()     # the rows of phase 2
        ce = p1
        while ce < e1 and slot.numel():
            cj, cend = keep_range(ce)
            if cj < cend:
                break
            ce += 1
        head = True
        while ce < e1 and slot.numel():
            cols, j0, e, first = min(cap, cend - cj), cj, ce, head
            cj += cols
            head = cj >= cend
            tau = tv[slot, 7].max().item()     # fresh at the chunk barrier
            if first and lb[e] > tau:
                break                          # this entry and all later
            work.live[t] += first
            if head:
                ce += 1
                while ce < e1:
                    if lb[ce] > tau:
                        ce = e1
                        break
                    cj, cend = keep_range(ce)
                    if cj < cend:
                        break
                    ce += 1
            g = slot[tv[slot, 7] >= lb[e]]     # the rows that can take it
            d2 = sweep.direct_d2(xs[g][:, None, :], kc[None, j0:j0 + cols])
            tv[g], ti[g] = merge(tv[g], ti[g], d2, kidx[j0:j0 + cols].long())
            work.ran[t, 1] += cols * g.numel()
            work.computed[rows[g], e] = True
        topv[rows[alive]] = tv[alive]
        topi[rows[alive]] = torch.where(ti[alive] == _INT_MAX, -1,
                                        ti[alive]).to(torch.int32)
    return (count, topv, topi), work


def block_vote_entries(x, y, d2cut, wl, sel=None):
    """Entries per row tile that the earlier K3 computed: in order, every
    entry that is in d_cut or whose lb some row's 8th d2 reaches, the whole
    tile pair for all 256 rows."""
    n, m = x.shape[0], y.shape[0]
    ptr, tiles = wl.row_ptr.tolist(), wl.col_tile.tolist()
    out = torch.zeros(wl.num_row_tiles, dtype=torch.int64)
    for t in range(wl.num_row_tiles):
        rows = torch.arange(t * BLOCK_N, min(n, (t + 1) * BLOCK_N))
        tv = torch.full((rows.numel(), 8), float("inf"))
        ti = torch.full((rows.numel(), 8), _INT_MAX, dtype=torch.int64)
        for e in range(ptr[t], ptr[t + 1]):
            if not (bool(wl.in_cut[e])
                    or float(wl.lb[e]) <= tv[:, 7].max().item()):
                continue
            out[t] += 1
            cols = torch.arange(tiles[e] * BLOCK_M,
                                min(tiles[e] * BLOCK_M + BLOCK_M, m))
            if sel is not None:
                cols = cols[sel[cols]]
            d2 = sweep.direct_d2(x[rows][:, None, :], y[None, cols])
            tv, ti = merge(tv, ti, d2, cols)
    return out


def needed_entries(wl, n, topv):
    """(n, W) bool: the entries a row needs, by ``k3_needed_pairs``' rule
    (chip_smoke.py): those of its tile in d_cut, and those whose lb is at
    most its final 8th d2."""
    need = torch.zeros((n, wl.n_kept), dtype=torch.bool)
    ptr = wl.row_ptr.tolist()
    for i in range(n):
        t = i // BLOCK_N
        seg = slice(ptr[t], ptr[t + 1])
        need[i, seg] = wl.in_cut[seg] | (wl.lb[seg] <= topv[i, 7])
    return need


def _lattice(n):
    g = np.stack(np.meshgrid(np.arange(40), np.arange(40)), -1)
    return g.reshape(-1, 2).astype(np.float32)[:n], 2.5


def _clustered(n, d, seed):
    """Six tight clusters over a sparse uniform tenth: the sparse rows keep
    phase 2 busy (fewer than 8 columns within d_cut)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(size=(6, d))
    pts = centers[rng.integers(0, 6, n)] + rng.normal(scale=0.03,
                                                      size=(n, d))
    pts[:n // 10] = rng.uniform(size=(n // 10, d))
    return pts.astype(np.float32)


def _case(case, d):
    """(x, y, d_cut) on grid-sorted points, n and m ragged (not multiples
    of 256 and 512); x is y's leading rows where they differ (the
    S-Approx-DPC shape)."""
    if case == "lattice":              # exact d2 ties, decided by index
        pts, dc = _lattice(1600)
    elif case == "few columns":        # rows that see fewer than 8 columns
        pts = uniform_points(6, d, seed=3)
        dc = 0.3
    else:
        pts = _clustered(2500, d, seed=d)
        dc = pick_dcut(pts, target_rho=10)
    y = build_grid(_t(pts), dc).points.contiguous()
    x = y[:700].contiguous() if case == "rows apart" else y
    return x, y, dc


def _gate(m, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(size=m) < 0.4)


def _sel_counts(sel):
    nbc = -(-sel.numel() // BLOCK_M)
    return torch.bincount(torch.nonzero(sel).flatten() // BLOCK_M,
                          minlength=nbc)


CASES = [("clustered", 2), ("clustered", 3), ("clustered", 4),
         ("clustered", 8), ("clustered", 9), ("lattice", 2),
         ("rows apart", 3), ("few columns", 3)]


@pytest.mark.parametrize("gated", [False, True], ids=["ungated", "gated"])
@pytest.mark.parametrize("case,d", CASES)
def test_schedule_equals_plain(case, d, gated):
    x, y, dc = _case(case, d)
    sel = _gate(y.shape[0], seed=d) if gated else None
    wl = blocksparse.build_flat_worklist(
        x, y, dc, nn_col_counts=None if sel is None else _sel_counts(sel))
    d2cut = sweep.d2cut_of(dc)
    want = sweep.worklist_count_topk_plain(x, y, d2cut, wl, sel=sel)
    got, work = schedule_k3(x, y, d2cut, wl, sel)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if case == "clustered":
        assert int(work.ran[:, 1].sum()) > 0       # phase 2 ran
    if case == "few columns":
        assert bool((got[2][:, 6:] == -1).all())
        assert bool(torch.isinf(got[1][:, 6:]).all())
    # its work: no more entries than the block vote, every needed one
    assert bool((work.live <= block_vote_entries(x, y, d2cut, wl,
                                                 sel)).all())
    need = needed_entries(wl, x.shape[0], want[1])
    assert not bool((need & ~work.computed).any())
    if sel is None:                # the block vote's set, with phase 2
        assert bool((work.live == block_vote_entries(x, y, d2cut,
                                                     wl)).all())
    # phase 2 runs the pairs of its rows alone, not the block's
    split = packing.phase_split(wl).long()
    ph2 = work.live - (split - wl.row_ptr[:-1].long())
    assert bool((work.ran[:, 1] <= ph2 * BLOCK_N * BLOCK_M).all())


def test_schedule_equals_jax_worklist_sweep():
    """JAX's own worklist, carried across, through the schedule and the
    reference's Pallas worklist sweep in interpret mode."""
    pts = uniform_points(2048, 3, seed=5)
    dc = pick_dcut(pts, target_rho=20)
    gp = build_grid(_t(pts), dc).points.numpy()
    jwl = jbs.build_flat_worklist(gp, gp, dc, block_n=256, block_m=512,
                                  count=True, nn="topk", k=8)
    wl = carry.flat_worklist(jwl.meta, jwl.lb, jwl.n_kept, jwl.n_total)
    jc, _, ji = (np.asarray(a) for a in jops.fused_sweep(
        jnp.asarray(gp), jnp.asarray(gp), dc, block_n=256, block_m=512,
        interpret=True, worklist=jwl))
    (tc, tv, ti), _ = schedule_k3(_t(gp), _t(gp), sweep.d2cut_of(dc), wl)
    # the reference's expanded form: counts off the threshold band, kept
    # sets where the 8th and 9th float64 distances are apart
    thr = f32_d2cut(dc)
    band = near_threshold_rows(gp, gp, thr, 1e-5 * thr)
    assert band.sum() <= 8
    np.testing.assert_array_equal(tc.numpy()[~band], jc[~band])
    s = np.sort(pair_d2(gp, gp), axis=1)
    tie = np.abs(s[:, 8] - s[:, 7]) <= 1e-4 * s[:, 8]
    assert tie.sum() <= 8
    for r in np.nonzero(~tie)[0]:
        assert set(ti[r].tolist()) == set(ji[r].tolist()), r


def test_gated_schedule_equals_jax_worklist_sweep():
    pts = uniform_points(1536, 2, seed=9)
    dc = clear_dcut(pts, target_rho=20)
    gp = build_grid(_t(pts), dc).points.numpy()
    sel = _gate(len(gp), seed=1)
    counts = _sel_counts(sel)
    jwl = jbs.build_flat_worklist(gp, gp, dc, block_n=256, block_m=512,
                                  count=True, nn="topk", k=8,
                                  nn_col_counts=counts.numpy())
    wl = carry.flat_worklist(jwl.meta, jwl.lb, jwl.n_kept, jwl.n_total)
    jc, jv, ji = (np.asarray(a) for a in jops.fused_sweep(
        jnp.asarray(gp), jnp.asarray(gp), dc, nn_sel=jnp.asarray(sel.numpy()),
        block_n=256, block_m=512, interpret=True, worklist=jwl))
    (tc, tv, ti), _ = schedule_k3(_t(gp), _t(gp), sweep.d2cut_of(dc), wl,
                                  sel)
    np.testing.assert_array_equal(tc.numpy(), jc)     # a clear d_cut
    tv, ti, s = tv.numpy(), ti.numpy(), sel.numpy()
    assert set(ti[np.isfinite(tv)].tolist()) <= set(np.nonzero(s)[0])
    d2 = np.sort(pair_d2(gp, gp)[:, s], axis=1)
    tie = np.abs(d2[:, 8] - d2[:, 7]) <= 1e-4 * d2[:, 8]
    assert tie.sum() <= 8
    for r in np.nonzero(~tie)[0]:
        assert set(ti[r][np.isfinite(tv[r])].tolist()) == \
            set(ji[r][np.isfinite(jv[r])].tolist()), r


@pytest.mark.parametrize("d", [1, 3, 4, 8, 9])
@pytest.mark.parametrize("gated", [False, True], ids=["ungated", "gated"])
def test_k3_records(d, gated):
    """Phase 1's records carry the gate (gated) or the index; phase 2's
    the index, and, gated, the selected columns alone, by column tile."""
    rng = np.random.default_rng(d)
    m = 1300                                   # a ragged last tile
    y = _t(rng.normal(size=(m, d)).astype(np.float32))
    sel = torch.from_numpy(rng.uniform(size=m) < 0.3) if gated else None
    x = y[:300].contiguous()
    wl = blocksparse.build_flat_worklist(x, y, 1.0)
    lay = packing.k3_layout(wl, y, sel)
    coords, slot = unpack(lay.rec, d)
    assert torch.equal(coords, y)
    assert torch.equal(slot, sel.int() if gated else torch.arange(m).int())
    kc, kidx = unpack(lay.keep_rec, d)
    if not gated:
        assert lay.keep_off is None and lay.keep_rec is lay.rec
        return
    cols = torch.nonzero(sel).flatten()
    assert torch.equal(kidx.long(), cols) and torch.equal(kc, y[cols])
    off = lay.keep_off.long()
    assert lay.keep_off.dtype == torch.int32
    assert off.numel() == -(-m // BLOCK_M) + 1 and int(off[-1]) == cols.numel()
    for c in range(off.numel() - 1):
        assert bool((kidx[off[c]:off[c + 1]] // BLOCK_M == c).all())


def _worklist(row_ptr, in_cut, lb=None):
    row_ptr = torch.tensor(row_ptr, dtype=torch.int32)
    w = int(row_ptr[-1])
    in_cut = torch.tensor(in_cut, dtype=torch.bool)
    lb = torch.arange(w, dtype=torch.float32) if lb is None else lb
    return blocksparse.Worklist(row_ptr, torch.zeros(w, dtype=torch.int32),
                                in_cut, lb, w, w)


def test_phase_split_and_order():
    # tiles: 2 in-cut of 4; none of 2; all 3; the last of 2 (not a prefix)
    wl = _worklist([0, 4, 6, 9, 11],
                   [1, 1, 0, 0, 0, 0, 1, 1, 1, 0, 1])
    split = packing.phase_split(wl)
    assert split.dtype == torch.int32
    assert split.tolist() == [2, 4, 9, 11]
    order = packing.heaviest_first(wl, split)
    assert order.dtype == torch.int32
    assert order.tolist() == [2, 0, 3, 1]   # 3, 2, 2 (tile order), 0


@pytest.mark.parametrize("seed", range(4))
def test_order_covers_each_tile_once(seed):
    rng = np.random.default_rng(seed)
    nbr = int(rng.integers(1, 60))
    per = rng.integers(1, 9, nbr)
    row_ptr = np.concatenate([[0], np.cumsum(per)])
    # in_cut a prefix of each segment, as build_flat_worklist's lb order
    # makes it
    cut = np.concatenate([np.arange(k) < rng.integers(0, k + 1)
                          for k in per])
    wl = _worklist(row_ptr.tolist(), cut.tolist())
    split = packing.phase_split(wl)
    np.testing.assert_array_equal(
        split.numpy(),
        row_ptr[:-1] + np.add.reduceat(cut.astype(int), row_ptr[:-1]))
    order = packing.heaviest_first(wl, split).numpy()
    assert sorted(order.tolist()) == list(range(nbr))
    work = (split.numpy() - row_ptr[:-1])[order]
    assert (np.diff(work) <= 0).all()


def test_worklist_in_cut_is_a_prefix():
    """On build_flat_worklist's worklists phase 1 holds exactly the
    in-d_cut entries, so phase 2 counts nothing."""
    x, y, dc = _case("clustered", 3)
    wl = blocksparse.build_flat_worklist(x, y, dc)
    split = packing.phase_split(wl).long()
    for t in range(wl.num_row_tiles):
        seg = wl.in_cut[int(wl.row_ptr[t]):int(wl.row_ptr[t + 1])]
        assert int(seg.sum()) == int(split[t] - wl.row_ptr[t])
        assert bool(seg[:int(seg.sum())].all())
