"""The host side of the K9 kernel (``kernels/packing.py``) and its schedule.

K9 walks each row's best-1 ring (every tile pair of its row tile,
ascending lb), a warp a row: it computes the entries the row needs, whose
lb its best d2 reaches and whose column tile holds a key above the row's
(the tile's largest key, ``packing.tile_max_key``), and ends at the first
entry whose lb is above the row's best.
``schedule_k9`` below runs that schedule in plain PyTorch on what the
wrapper builds (records with the key in the slot, tile maximum keys), with
the kernel's rules.  The tests hold it
against ``worklist_masked_nn_plain`` and ``masked_nn_plain`` (the plain
versions of K9 and K2) bit for bit, and against the JAX package's
dependent NN on a best-1 ring.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import blocksparse as jbs
from repro.kernels import ops as jops
from repro.kernels.backend import get_backend as jget_backend

from repro_torch import carry
from repro_torch.core.dpc_types import density_jitter
from repro_torch.core.grid import build_grid
from repro_torch.core.tuning import pick_dcut
from repro_torch.data.points import real_proxy
from repro_torch.kernels import blocksparse, ops, packing, sweep
from repro_torch.kernels.backend import CudaBackend
from repro_torch.kernels.blocksparse import BLOCK_M, BLOCK_N

from _torch_ref import clear_dcut, uniform_points
from _torch_ref import one_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

_INT_MAX = 2**31 - 1
INF = float("inf")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def lex_update(best, arg, d2, cols, ok):
    """Rows' (best, index) after the columns ``cols`` ((c,) int64) whose
    d2 are ``d2`` ((rows, c)), each taken where ``ok``: the lexicographic
    minimum of (d2, index), as the kernel's `d2 < best || (d2 == best &&
    j < arg)` keeps it (a NaN d2 is never taken; an overflowed +inf one
    can still set the index)."""
    ok = ok & ~torch.isnan(d2)
    v = torch.cat([best[:, None], torch.where(ok, d2, INF)], 1)
    i = torch.cat([arg[:, None],
                   torch.where(ok, cols[None, :], _INT_MAX)], 1)
    vmin = v.min(1).values
    imin = torch.where(v == vmin[:, None], i, _INT_MAX + 1).min(1).values
    return vmin, imin


class Work:
    """What the schedule ran: per row tile the entries its rows' walks
    computed and the longest walk (the kernel's ``live``), and the pairs
    computed (a row and a column each)."""

    def __init__(self, nbr):
        self.live = torch.zeros((nbr, 2), dtype=torch.int64)
        self.pairs = 0


def schedule_k9(x, xk, y, yk, wl):
    """(best d2, index) through K9's schedule (index -1 and d2 +inf where
    no column is denser), and its ``Work``.  Each row walks its tile's ring
    in order, computing the entries it needs (lb at most its best, the
    tile's largest key above its key) and ending at the first entry it is
    not open for (lb above its best); the rows of a tile are walked in
    lockstep here, which gives each row its own walk, since a row that is
    not open for an entry is open for no later one."""
    n, d = x.shape
    m = y.shape[0]
    rec = packing.pack_records(y, yk.view(torch.int32))
    yc, ykey = rec[:, :d], rec.view(torch.float32)[:, d]
    tm = packing.tile_max_key(yk).tolist()
    ptr, ct, lb = wl.row_ptr.tolist(), wl.col_tile.tolist(), wl.lb.tolist()
    key = torch.where(xk < INF, xk, INF)          # NaN and +inf never seek
    best = torch.full((n,), INF)
    arg = torch.full((n,), _INT_MAX, dtype=torch.int64)
    work = Work(wl.num_row_tiles)
    for t in range(wl.num_row_tiles):
        rows = torch.arange(t * BLOCK_N, min(n, (t + 1) * BLOCK_N))
        seek = key[rows] < INF
        walked = torch.zeros(len(rows), dtype=torch.int64)
        for e in range(ptr[t], ptr[t + 1]):
            open_ = seek & (lb[e] <= best[rows])  # each row's fresh best
            if not bool(open_.any()):
                break
            need = open_ & (tm[ct[e]] > key[rows])
            take = rows[need]
            if not len(take):
                continue
            j0 = ct[e] * BLOCK_M
            j1 = min(j0 + BLOCK_M, m)
            d2 = sweep.direct_d2(x[take][:, None, :], yc[j0:j1][None, :, :])
            ok = ykey[j0:j1][None, :] > key[take][:, None]
            best[take], arg[take] = lex_update(best[take], arg[take], d2,
                                               torch.arange(j0, j1), ok)
            walked += need
            work.pairs += len(take) * (j1 - j0)
        work.live[t, 0] = walked.sum()
        work.live[t, 1] = walked.max() if len(rows) else 0
    found = best < INF
    return best, torch.where(found, arg, -1).to(torch.int32), work


def _lattice(n, d, seed):
    """Integer points on a small lattice, many duplicates and exact distance
    ties; keys on three levels, so equal keys abound too."""
    rng = np.random.default_rng(seed)
    pts = rng.integers(0, 12, size=(n, d)).astype(np.float32)
    return pts, (np.arange(n) % 3).astype(np.float32)


def _keys(x, dc):
    """rho + jitter keys of the table x, as the fits make them."""
    return (sweep.range_count_plain(x, x, sweep.d2cut_of(dc)).float()
            + density_jitter(x.shape[0]))


def _case(case, d):
    """(x, x_key, y, y_key): query rows and the grid-sorted table."""
    if case == "lattice":
        pts, k = _lattice(1400, d, seed=d)
        gp = build_grid(_t(pts), 1.5)
        y, yk = gp.points, _t(k)[gp.order]
    else:
        pts = (real_proxy("airline", 1700, seed=2)[0][:, :d] if d == 3
               else uniform_points(1700, d, seed=d))
        dc = pick_dcut(pts, target_rho=12)
        y = build_grid(_t(pts), dc).points
        yk = _keys(y, dc)
    m = y.shape[0]
    x, xk = y, yk.clone()
    if case == "peak":                    # a lone global peak, far above
        xk[m // 2] = yk[m // 2] = float(yk.max()) + 100.0
    elif case == "sapprox":               # -inf off the representatives
        off = _t(np.random.default_rng(d).random(m) < 0.6)
        yk = torch.where(off, -INF, yk)
    elif case == "padding":               # +inf and NaN query keys
        xk[::7] = INF
        xk[3::11] = float("nan")
    elif case == "few-rows":              # under one row tile
        x, xk = y[300:470], xk[300:470]
    return x.contiguous(), xk.contiguous(), y.contiguous(), yk.contiguous()


CASES = [("lattice", 2), ("lattice", 3), ("peak", 3), ("peak", 8),
         ("sapprox", 3), ("padding", 2), ("few-rows", 3), ("peak", 11)]


@pytest.mark.parametrize("case,d", CASES)
def test_schedule_equals_plain(case, d):
    """The schedule, the plain K9 and the plain K2, bit for bit (d2 bits
    and index): m = 1,400 or 1,700 is no multiple of 512, so every ring
    ends in a ragged column tile; d = 11 takes the generic kernel."""
    x, xk, y, yk = _case(case, d)
    wl = blocksparse.build_flat_worklist(x, y, count=False, nn="best1")
    best, arg, work = schedule_k9(x, xk, y, yk, wl)
    pb, pa = sweep.worklist_masked_nn_plain(x, xk, y, yk, wl)
    db, da = sweep.masked_nn_plain(x, xk, y, yk)
    for b, a in ((pb, pa), (db, da)):
        assert torch.equal(best.view(torch.int32), b.view(torch.int32))
        assert torch.equal(arg, a)
    ring = (wl.row_ptr[1:] - wl.row_ptr[:-1]).long()
    assert bool((work.live[:, 1] <= ring).all())
    if case == "padding":
        assert bool((arg[~(xk < INF)] == -1).all())
    if case == "sapprox":                 # no -inf column is ever taken
        taken = arg[arg >= 0].long()
        assert bool((yk[taken] > -INF).all())


def test_peak_walks_nothing():
    """The global peak has no denser column: the key test passes over its
    whole ring (the parent walked all of it), and its answer is (inf, -1).
    A row just below it walks only to its one denser column's tile."""
    x, xk, y, yk = _case("peak", 3)
    top = int(torch.argmax(yk))
    for rows, want in (([top], 0), ([top, top - 1], None)):
        q, qk = x[rows].contiguous(), xk[rows].contiguous()
        qk[1:] = yk[top] - 1.0
        wl = blocksparse.build_flat_worklist(q, y, count=False, nn="best1")
        best, arg, work = schedule_k9(q, qk, y, yk, wl)
        assert float(best[0]) == INF and int(arg[0]) == -1
        if want is not None:
            assert int(work.live[0, 0]) == want
        else:
            # one denser column: the walk takes its tile's entry alone
            assert int(arg[1]) == top
            assert int(work.live[0, 0]) == 1 < wl.n_kept


@pytest.mark.parametrize("seed", [3, 4])
def test_schedule_equals_jax_dependent_masked(seed):
    """On the reference's own best-1 ring, carried across: the schedule
    against JAX's worklist NN (Pallas, interpret mode), the parent equal
    and the delta to the reference's f32 rounding (its tolerance in
    test_torch_dist_kernels), and against the JAX package's ``jnp``
    block-sparse ``denser_nn``."""
    pts = uniform_points(2500, 3, seed=seed)
    dc = clear_dcut(pts, target_rho=20)
    gp = build_grid(_t(pts), dc).points.numpy()
    key = _keys(_t(gp), dc)
    x, xk = gp[700:1900], key[700:1900].contiguous()
    jwl = jbs.build_flat_worklist(x, gp, None, block_n=256, block_m=512,
                                  count=False, nn="best1")
    wl = carry.flat_worklist(jwl.meta, jwl.lb, jwl.n_kept, jwl.n_total)
    best, arg, _ = schedule_k9(_t(x), xk, _t(gp), key, wl)
    jd, jp = (np.asarray(a) for a in jops.dependent_masked(
        jnp.asarray(x), jnp.asarray(xk.numpy()), jnp.asarray(gp),
        jnp.asarray(key.numpy()), block_n=256, block_m=512, interpret=True,
        worklist=jwl))
    np.testing.assert_array_equal(arg.numpy(), jp)
    np.testing.assert_allclose(torch.sqrt(best).numpy(), jd, rtol=1e-6)
    nd, npar = (np.asarray(a) for a in jget_backend("jnp").denser_nn(
        jnp.asarray(x), jnp.asarray(xk.numpy()), jnp.asarray(gp),
        jnp.asarray(key.numpy()), layout="block-sparse"))
    np.testing.assert_array_equal(arg.numpy(), npar)
    np.testing.assert_allclose(torch.sqrt(best).numpy(), nd, rtol=1e-6)


def test_tile_max_key():
    """The largest key of each 512-column tile, NaN left out (-inf where a
    tile holds only NaN), over the real columns of a ragged last tile."""
    m = 3 * BLOCK_M + 77
    k = torch.arange(m, dtype=torch.float32)
    k[BLOCK_M - 1] = float("nan")           # tile 0's largest is a NaN
    k[BLOCK_M:2 * BLOCK_M] = float("nan")   # tile 1: NaN alone
    k[2 * BLOCK_M + 5] = INF
    got = packing.tile_max_key(k)
    want = torch.tensor([BLOCK_M - 2, -INF, INF, m - 1], dtype=torch.float32)
    assert torch.equal(got, want)
    assert packing.tile_max_key(torch.zeros(0)).shape == (0,)
    # nothing in a tile is strictly denser than a key at its maximum
    y = torch.randn(m)
    tm = packing.tile_max_key(y)
    tile = torch.arange(m) // BLOCK_M
    assert bool((y <= tm[tile]).all())


@pytest.mark.parametrize("d", [1, 3, 4, 8, 9])
def test_k9_records(d):
    """K9's records: the coordinates, then the key's f32 bits in the slot
    (NaN and infinities kept), zero past it, 16-byte aligned widths."""
    rng = np.random.default_rng(d)
    y = _t(rng.normal(size=(37, d)).astype(np.float32))
    k = _t(rng.normal(size=37).astype(np.float32))
    k[0], k[1], k[2] = float("nan"), INF, -INF
    rec = packing.pack_records(y, k.view(torch.int32))
    w = packing.record_width(d)
    assert rec.shape == (37, w) and w % 4 == 0 and w >= d + 1
    assert torch.equal(rec[:, :d], y)
    assert torch.equal(rec.view(torch.int32)[:, d], k.view(torch.int32))
    assert not bool(rec[:, d + 1:].any())


@pytest.mark.parametrize("form", ["approx", "gated", "bf16"])
def test_block_sparse_fallback_walks_the_ring(form, monkeypatch):
    """``rho_delta``'s unresolved rows: under the dense layout the plain K2
    scans all of y, under the block-sparse layout the plain K9 walks their
    best-1 ring (K2 and K9 on the card), and both give the same (rho,
    rho_key, delta, parent) bit for bit: Approx-DPC's cell-maxima filter,
    S-Approx-DPC's gate (keys -inf off the representatives) and the bf16
    sweep, whose tail stays f32 (on integer points, where bf16 is exact and
    the two layouts' sweeps agree)."""
    if form == "bf16":
        pts, dc = _lattice(3000, 3, seed=5)[0] * 2.0, 3.5
    else:
        pts = real_proxy("airline", 3000, seed=3)[0]
        dc = pick_dcut(pts, target_rho=20)
    x = build_grid(_t(pts), dc).points
    n = x.shape[0]
    called = []
    for name in ("masked_nn_plain", "worklist_masked_nn_plain"):
        def plain(*a, _name=name, _fn=getattr(ops, name)):
            called.append((_name, a[0].shape[0]))
            return _fn(*a)
        monkeypatch.setattr(ops, name, plain)
    kw = {"jitter": density_jitter(n)}
    if form == "approx":
        kw["fallback_interest"] = lambda rk: torch.arange(n) % 3 == 0
    elif form == "gated":
        kw["y_sel_slots"] = torch.arange(0, n, 4)
        x = x[::4].contiguous()
        kw["jitter"] = density_jitter(x.shape[0])
    else:
        kw["precision"] = "bf16"
    y = build_grid(_t(pts), dc).points
    be = CudaBackend()
    dense = be.rho_delta(x, y, dc, **kw)
    sparse = be.rho_delta(x, y, dc, layout="block-sparse", **kw)
    rows = called[0][1]
    assert called == [("masked_nn_plain", rows),
                      ("worklist_masked_nn_plain", rows)] and rows > 1
    for a, b in zip(dense, sparse):
        assert torch.equal(a, b)
