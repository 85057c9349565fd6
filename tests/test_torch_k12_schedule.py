"""The host side of the K12 kernel (``kernels/packing.py``, ``bf16_records``)
and its schedule.

K12, the dense bf16 fused count + kept-8, keeps the tensor cores' C
fragments in registers through its epilogue: lane (g, q) of a warp holds
rows g and g+8 of each m16 tile at columns 2q and 2q+1 of each n8 tile, so
the 4 lanes q share a row, each seeing the columns c with (c % 8) // 2 == q.
A value first meets a cheap test, xy >= lim + half (``lim`` of its row
from x2 and T = max(d2cut, cut), ``half`` of its column from the records),
which every pair with d2 <= T passes; the test is voted per warp and 16
columns, and where it is taken, or where the warp's last group counted or
filtered in a pair, the group's exact d2 are counted by their lanes and
filtered: d2 below the row's ``cut`` (and, gated, the gate set), voted per
warp and group.  Where that vote is taken, the group's values go through
the warp's shared queue to each row's owner, the one lane that keeps the
row's kept-8, which takes its 16 columns in index order and inserts those
below its 8th value (gated: whose gate is set); every row's ``cut`` then
becomes its owner's 8th value, and ``lim`` follows.  At the end the 4
lanes' counts of a row add.  ``schedule_k12`` runs that schedule in plain
PyTorch on the wrapper's records, with d2 from ``expanded_d2_bf16``; the
tests hold it against ``fused_count_topk_bf16_plain`` (the kernel's plain
version) bit for bit and against the JAX package's bf16 sweep in
interpret mode.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.tuning import pick_dcut
from repro_torch.data.points import real_proxy
from repro_torch.kernels import packing, sweep
from repro_torch.kernels.packing import BF16_GROUP, BF16_HALF

from _torch_ref import f32_d2cut, uniform_points
from _torch_ref import one_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("one_thread")
from test_torch_bf16 import _assert_same_kept, _lattice, _ref_sweep

_INT_MAX = 2**31 - 1
LANES = 4                      # lanes sharing a row
WARP_ROWS = 32                 # rows of a warp: two m16 tiles


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


class Work:
    """What the schedule did: insertions per row (the kernel's
    ``inserted``), the (warp, 16-column group) pairs whose cheap test and
    whose filter were voted in, and the owners' (warp, column) votes."""

    def __init__(self, n):
        self.inserted = torch.zeros(n, dtype=torch.int64)
        self.exact = 0
        self.votes = 0
        self.col_votes = 0


def k12_lim(x2, t):
    """The row's share of the cheap test (``k12_lim``): T moved up by
    |T| 2^-20, which K13's bounds below 0 need."""
    return 0.5 * (x2 * (1.0 - 2.0 ** -20) - (t + abs(t) * 2.0 ** -20)) \
        - 2.0 ** -100


def cross_bf16(x, y):
    """x.y of the bf16-rounded rows, summed over dims in order: the term
    ``expanded_d2_bf16`` doubles."""
    xb = x.to(torch.bfloat16).to(torch.float32)
    yb = y.to(torch.bfloat16).to(torch.float32)
    xy = xb[:, None, 0] * yb[None, :, 0]
    for k in range(1, x.shape[1]):
        xy = xy + xb[:, None, k] * yb[None, :, k]
    return xy


def schedule_k12(x, y, d2cut, sel=None):
    """(count, topv, topi) through K12's schedule, and its ``Work``."""
    n = x.shape[0]
    rec = packing.bf16_records(y, sel)
    m16 = rec.rec.shape[0]
    yb = rec.rec[:, :x.shape[1]].float()
    # rows past n compute as the last row, vote, and are never written
    rows = -(-n // WARP_ROWS) * WARP_ROWS
    pad = torch.arange(rows).clamp(max=n - 1)
    xr = x[pad]
    x2, y2, half = sweep.sq_norms(xr), rec.norms[0], rec.norms[1]
    d2 = sweep.expanded_d2_bf16(xr, yb, x2, y2)
    xy = cross_bf16(xr, yb)
    torch.testing.assert_close(d2, (x2[:, None] + y2[None, :]) - 2.0 * xy,
                               rtol=0, atol=0, equal_nan=True)
    gate = None if rec.gate is None else rec.gate != 0
    R = rows
    tv = torch.full((R, 8), float("inf"))                   # the owners'
    ti = torch.full((R, 8), _INT_MAX, dtype=torch.int64)
    cnt = torch.zeros((R, LANES), dtype=torch.int64)
    last = torch.ones(R // WARP_ROWS, dtype=torch.bool)   # last group in
    work = Work(n)
    for c0 in range(0, m16, BF16_GROUP):
        cols = torch.arange(c0, c0 + BF16_GROUP)
        grp = d2[:, cols]                                   # (R, 16)
        q = (cols % 8) // 2
        cut = tv[:, 7]
        lim = k12_lim(x2, torch.maximum(torch.tensor(d2cut), cut))
        # the cheap test holds wherever the pair may count or be kept
        test = xy[:, cols] >= lim[:, None] + half[None, cols]
        need = grp <= torch.maximum(torch.tensor(d2cut), cut)[:, None]
        assert not bool((need & ~test).any()), "the cheap test missed"
        warp_exact = last | test.view(-1, WARP_ROWS * BF16_GROUP).any(1)
        work.exact += int(warp_exact.sum())
        exact = warp_exact.repeat_interleave(WARP_ROWS)     # (R,)
        counted = (grp < d2cut) & exact[:, None]
        cnt += torch.stack([counted[:, q == k].sum(1)
                            for k in range(LANES)], 1)
        passed = (grp < cut[:, None]) & exact[:, None]      # the filter
        if gate is not None:
            passed = passed & gate[cols]
        kept = passed.view(-1, WARP_ROWS * BF16_GROUP).any(1)
        work.votes += int(kept.sum())
        last = kept | counted.view(-1, WARP_ROWS * BF16_GROUP).any(1)
        kept = kept.repeat_interleave(WARP_ROWS)            # (R,)
        # each owner takes its row's 16 columns in index order
        for j in cols.tolist():
            v = d2[:, j]
            take = (v < tv[:, 7]) & kept
            if gate is not None:
                take = take & gate[j]
            work.col_votes += int(take.view(-1, WARP_ROWS).any(1).sum())
            lt = v[:, None] < tv                            # (R, 8)
            prev = torch.cat([torch.zeros_like(lt[:, :1]), lt[:, :-1]], 1)
            nv = torch.where(lt, torch.where(prev, tv.roll(1, 1),
                                             v[:, None]), tv)
            ni = torch.where(lt, torch.where(prev, ti.roll(1, 1),
                                             torch.full_like(ti, j)), ti)
            tv = torch.where(take[:, None], nv, tv)
            ti = torch.where(take[:, None], ni, ti)
            work.inserted += take[:n]
    topi = torch.where(ti[:n] == _INT_MAX, -1, ti[:n])
    return (cnt[:n].sum(1).to(torch.int32), tv[:n],
            topi.to(torch.int32)), work


def _case(case, d):
    """(x, y, d_cut) of a named input: ``ties`` integers in [0, 6) (many
    exact d2 ties, decided by index across lanes), ``unit`` unit-scale
    data (negative d2 where a row meets itself), ``ragged`` neither n nor
    m a multiple of 16 or 32, ``few`` fewer than 8 columns, ``airline``
    the Airline proxy's scale (norms near 1e10 against a d2cut near 2e5,
    where the cheap test's margin is widest)."""
    rng = np.random.default_rng(d)
    if case == "airline":
        pts = real_proxy("airline", 600, seed=d)[0]
        return pts, pts, pick_dcut(pts, target_rho=30)
    if case == "ties":
        pts = rng.integers(0, 6, (300, d)).astype(np.float32)
        return pts, pts, float(np.sqrt(2.5))
    if case == "unit":
        pts = uniform_points(400, d, seed=d)
        return pts, pts, float(np.sqrt(0.05))
    pts = rng.uniform(size=(203, d)).astype(np.float32)
    if case == "ragged":
        return pts, pts[:77], 0.3
    return pts, pts[:5], 0.5                                # "few"


def _gate(m, seed):
    return np.random.default_rng(seed).uniform(size=m) < 0.5


@pytest.mark.parametrize("gated", [False, True], ids=["ungated", "gated"])
@pytest.mark.parametrize("case,d", [("ties", 2), ("ties", 3), ("unit", 3),
                                    ("unit", 9), ("ragged", 3),
                                    ("few", 2), ("airline", 3)])
def test_schedule_equals_plain(case, d, gated):
    px, py, dc = _case(case, d)
    x, y = _t(px), _t(py)
    sel = _t(_gate(y.shape[0], d)) if gated else None
    (c, v, i), work = schedule_k12(x, y, f32_d2cut(dc), sel)
    pc, pv, pi = sweep.fused_count_topk_bf16_plain(x, y, f32_d2cut(dc),
                                                   sel=sel)
    assert torch.equal(c, pc)
    assert torch.equal(v.view(torch.int32), pv.view(torch.int32))
    assert torch.equal(i, pi)
    # every kept entry was inserted by its row's owner, in a group whose
    # votes were taken
    assert bool((work.inserted >= (i >= 0).sum(1)).all())
    assert work.col_votes >= work.votes >= 1
    assert work.exact >= work.votes
    if case == "ties":
        d2 = sweep.expanded_d2_bf16(x, y)
        kth = pv[:, 7:8]
        assert bool(((d2 == kth).sum(1) > 1).any())    # ties at the cut
    if case == "unit":
        assert bool((v < 0).any())                       # negative d2 kept
    if case == "few":
        assert bool((i[:, 5:] == -1).all())
        assert bool(torch.isinf(v[:, 5:]).all())


@pytest.mark.parametrize("gated", [False, True], ids=["ungated", "gated"])
def test_schedule_equals_jax_sweep(gated):
    """On a lattice the schedule equals the JAX package's bf16 sweep in
    interpret mode (the reference's padded slots aside)."""
    pts, dc = _lattice(160, 3, 1, 11)
    sel = _gate(160, 3) if gated else None
    got, _ = schedule_k12(_t(pts), _t(pts), f32_d2cut(dc),
                          None if sel is None else _t(sel))
    c, v, i = got
    _assert_same_kept((c.to(torch.float32), v, i),
                      _ref_sweep(pts, pts, dc, sel), 160)


@pytest.mark.parametrize("gated", [False, True], ids=["ungated", "gated"])
@pytest.mark.parametrize("d", [2, 3, 8, 16, 17])
def test_bf16_records(d, gated):
    """The records: y as bf16 and the norms of ``sq_norms`` bit for bit,
    the test's halves, zeros past d and past m, NaN norms and zero gates
    past m, m rounded up to the vote group."""
    rng = np.random.default_rng(d)
    for m in (1, 37, 64):
        y = _t(rng.normal(size=(m, d)).astype(np.float32) * 100)
        sel = _t(rng.uniform(size=m) < 0.5) if gated else None
        rec = packing.bf16_records(y, sel)
        m16 = -(-m // BF16_GROUP) * BF16_GROUP
        w = packing.bf16_record_width(d)
        assert w == (8 if d <= 8 else 16 * -(-d // 16))
        assert rec.rec.shape == (m16, w) and rec.rec.dtype == torch.bfloat16
        assert torch.equal(rec.rec[:m, :d].view(torch.int16),
                           y.to(torch.bfloat16).view(torch.int16))
        assert not bool(rec.rec[:, d:].view(torch.int16).any())
        assert not bool(rec.rec[m:].view(torch.int16).any())
        y2 = sweep.sq_norms(y)
        assert rec.norms.shape == (2, m16)
        assert torch.equal(rec.norms[0, :m].view(torch.int32),
                           y2.view(torch.int32))
        assert torch.equal(rec.norms[1, :m], y2 * BF16_HALF)
        assert bool(torch.isnan(rec.norms[:, m:]).all())
        if sel is None:
            assert rec.gate is None
        else:
            assert rec.gate.dtype == torch.uint8
            assert torch.equal(rec.gate[:m], sel.to(torch.uint8))
            assert not bool(rec.gate[m:].any())
