"""The halo primitives on a span-pruned worklist on the CPU: the span
worklists (K15's count form, K16's halo ring) against the JAX package's
builder entry for entry, the plain K15/K16 against the plain K10/K11 bit
for bit and against the reference's block-sparse halo primitives
(``pallas-interpret`` on unit-scale data, ``jnp`` on domain-scale data),
and ``CudaBackend``'s block-sparse forms against its dense ones.

On the CPU the wrappers run the plain versions; the kernels themselves are
held against them, and against K10/K11, bit for bit on the card by
chip_smoke.py (phase 23).  Inputs are built once with numpy and handed to
both packages.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import blocksparse as jbs
from repro.kernels.backend import get_backend as jget_backend

from repro_torch.core.dpc_types import density_jitter
from repro_torch.core.grid import build_grid, point_span_bounds
from repro_torch.core.tuning import pick_dcut
from repro_torch.data.points import gaussian_mixture, real_proxy
from repro_torch.kernels import blocksparse, ops, sweep
from repro_torch.kernels.backend import CudaBackend

from _torch_ref import (clear_dcut, f32_d2cut, f32_ulp, near_threshold_rows,
                        uniform_points)


def _t(a):
    return torch.from_numpy(np.array(a))


def _shard(pts, dc, r0, r1, extra=False):
    """Shard rows [r0, r1) of the grid-sorted table, the window their spans
    reach and the spans made window-local, as ``distributed_dpc`` makes
    them (the port's ``point_span_bounds``; one more span per row, empty at
    slot 0 as a padded row's, turns negative).  ``extra`` adds a reversed,
    a negative, a negative-start and a past-the-window span to every row.
    Returns (x, window, starts, ends, keys of the whole table, lo)."""
    g = build_grid(_t(pts), dc)
    st, en = (a.numpy() for a in point_span_bounds(g))
    st = np.pad(st[r0:r1], ((0, 0), (0, 1)))
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
    gp = g.points
    key = (sweep.range_count_plain(gp, gp, sweep.d2cut_of(dc)).float()
           + density_jitter(len(gp)))
    return (gp[r0:r1].contiguous(), gp[lo:hi].contiguous(),
            _t(st.astype(np.int32)), _t(en.astype(np.int32)), key, lo)


def _same_worklist(got, want):
    meta = np.asarray(want.meta)
    first = np.zeros(got.n_kept, np.int32)
    first[got.row_ptr[:-1].numpy()] = 1
    assert (got.n_kept, got.n_total) == (want.n_kept, want.n_total)
    np.testing.assert_array_equal(got.row_tile().numpy(), meta[0])
    np.testing.assert_array_equal(got.col_tile.numpy(), meta[1])
    np.testing.assert_array_equal(first, meta[2])
    np.testing.assert_array_equal(got.in_cut.numpy(), meta[3] == 1)
    np.testing.assert_array_equal(got.lb.numpy(), np.asarray(want.lb))


@pytest.mark.parametrize("form", ["count", "best1"])
@pytest.mark.parametrize("case", ["unit-2", "airline", "ragged",
                                  "empty-tile"])
def test_span_worklists_match_reference(case, form):
    """K15's span count worklist and K16's halo ring against the
    reference's builder at the port's tile shape, entry for entry; the
    spans held to [0, W]."""
    if case == "airline":
        pts = real_proxy("airline", 2000, seed=4)[0]
    else:
        pts = uniform_points(2000, 2, seed=11)
    dc = pick_dcut(pts, target_rho=20)
    r0, r1 = (600, 1500) if case == "ragged" else (512, 1536)
    x, win, st, en, _, _ = _shard(pts, dc, r0, r1)
    w = win.shape[0]
    st, en = st.clamp(0, w), en.clamp(0, w)
    if case == "empty-tile":
        st[256:512], en[256:512] = 9, 4     # every span of row tile 1
    kw = ({"count": True, "nn": None} if form == "count"
          else {"count": False, "nn": "best1", "nn_dcut": True})
    # int64 spans: on int32 ones numpy 2 wraps the reference's int64-max
    # sentinel for a dead span to -1, so its least start is -1 in every
    # tile and every tile left of the spans counts as reached (ROADMAP,
    # Reference gaps)
    want = jbs.build_flat_worklist(x.numpy(), win.numpy(), dc, block_n=256,
                                   block_m=512,
                                   starts=st.numpy().astype(np.int64),
                                   ends=en.numpy().astype(np.int64), **kw)
    got = blocksparse.build_flat_worklist(x, win, dc, starts=st, ends=en,
                                          **kw)
    _same_worklist(got, want)
    if form == "best1":
        assert not got.in_cut.any()
    if case == "empty-tile":
        seg = slice(int(got.row_ptr[1]), int(got.row_ptr[2]))
        assert got.lb[seg].numel() == 1 and not got.in_cut[seg].any()
    if case == "ragged":
        assert x.shape[0] % 256
    assert got.n_kept < got.n_total


def test_span_forms_need_both_bounds():
    x = _t(uniform_points(300, 2, seed=0))
    sp = torch.zeros((300, 2), dtype=torch.int32)
    for kw in ({"starts": sp}, {"ends": sp}):
        with pytest.raises(ValueError, match="starts and ends"):
            blocksparse.build_flat_worklist(x, x, 0.1, nn=None, **kw)
    with pytest.raises(ValueError, match="for 300 rows"):
        blocksparse.build_flat_worklist(x, x, 0.1, nn=None, starts=sp[:9],
                                        ends=sp[:9])


@pytest.mark.parametrize("d", [2, 3, 8])
def test_plain_k15_k16_equal_k10_k11(d):
    """On the port's span worklists the plain K15 equals the plain K10 and
    the plain K16 the plain K11, bit for bit, with reversed, negative,
    negative-start, past-the-window and empty spans; K16's walk stops
    before its ring's end in some row tile."""
    pts = (uniform_points(1500, d, seed=30 + d) if d != 3
           else real_proxy("airline", 1500, seed=5)[0])
    dc = pick_dcut(pts, target_rho=20)
    x, win, st, en, key, lo = _shard(pts, dc, 300, 1300, extra=True)
    xk = key[300:1300].contiguous()
    wk = key[lo:lo + win.shape[0]].contiguous()
    cwl = blocksparse.build_flat_worklist(x, win, dc, nn=None, starts=st,
                                          ends=en)
    got = ops.halo_density(x, win, st, en, dc, worklist=cwl)
    assert torch.equal(got, ops.halo_density(x, win, st, en, dc))
    ring = blocksparse.build_flat_worklist(x, win, dc, count=False,
                                           nn="best1", nn_dcut=True,
                                           starts=st, ends=en)
    got = ops.halo_dependent(x, xk, win, wk, st, en, dc, worklist=ring)
    want = ops.halo_dependent(x, xk, win, wk, st, en, dc)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert 0 < int(got[2].sum()) < x.shape[0]
    live = torch.zeros(ring.num_row_tiles, dtype=torch.int32)
    best, arg = sweep.worklist_halo_masked_nn_plain(
        x, xk, win, wk, st, en, sweep.d2cut_of(dc), ring, live=live)
    assert torch.equal(arg, want[1])
    per_tile = ring.row_ptr[1:] - ring.row_ptr[:-1]
    assert bool((live <= per_tile).all()) and int(live.sum()) > 0


@pytest.mark.parametrize("keys", ["levels", "leftward"])
def test_plain_k16_on_the_lattice(keys):
    """The 48 x 48 lattice: with three key levels (d_cut 2.5) exact
    distance ties are everywhere, decided by window index as K11 decides
    them; with keys falling left to right (d_cut 12.5) every row but those
    of the first lattice column finds its left neighbour at distance 1, so
    the walk stops before its ring's end in some row tile.  Both equal K11
    bit for bit."""
    g = np.stack(np.meshgrid(np.arange(48), np.arange(48)), -1)
    pts = g.reshape(-1, 2).astype(np.float32)
    dc = 2.5 if keys == "levels" else 12.5
    x, win, st, en, _, lo = _shard(pts, dc, 500, 1800)
    gp = build_grid(_t(pts), dc).points
    key = ((torch.arange(len(gp)) % 3).float() if keys == "levels"
           else -gp[:, 0].contiguous())
    xk = key[500:1800].contiguous()
    wk = key[lo:lo + win.shape[0]].contiguous()
    ring = blocksparse.build_flat_worklist(x, win, dc, count=False,
                                           nn="best1", nn_dcut=True,
                                           starts=st, ends=en)
    got = ops.halo_dependent(x, xk, win, wk, st, en, dc, worklist=ring)
    want = ops.halo_dependent(x, xk, win, wk, st, en, dc)
    for g_, w_ in zip(got, want):
        assert torch.equal(g_, w_)
    assert int((got[0] == 1.0).sum()) > x.shape[0] // 3
    live = torch.zeros(ring.num_row_tiles, dtype=torch.int32)
    sweep.worklist_halo_masked_nn_plain(x, xk, win, wk, st, en,
                                        sweep.d2cut_of(dc), ring, live=live)
    per_tile = ring.row_ptr[1:] - ring.row_ptr[:-1]
    if keys == "leftward":
        assert bool((live < per_tile).any())


@pytest.mark.parametrize("d", [2, 3])
def test_block_sparse_halo_matches_pallas(d):
    """``CudaBackend``'s block-sparse halo primitives (the plain K15/K16
    on the port's span worklists) against the reference's
    ``pallas-interpret`` block-sparse forms, on unit-scale data: counts
    equal, delta to rtol 1e-6, parent and found equal; and against the
    port's dense forms bit for bit."""
    pts = uniform_points(1200, d, seed=40 + d)
    dc = clear_dcut(pts, target_rho=20)
    r0 = 300 if d == 2 else 800
    x, win, st, en, key, lo = _shard(pts, dc, r0, 1100)
    assert lo > 0 and (st < 0).any()
    xk = key[r0:1100].contiguous()
    wk = key[lo:lo + win.shape[0]].contiguous()
    be, jbe = CudaBackend(), jget_backend("pallas-interpret")
    cnt = be.range_count_halo(x, win, st, en, dc, span_cap=1,
                              layout="block-sparse")
    assert torch.equal(cnt, be.range_count_halo(x, win, st, en, dc,
                                                span_cap=1))
    want = np.asarray(jbe.range_count_halo(
        jnp.asarray(x.numpy()), jnp.asarray(win.numpy()), st.numpy(),
        en.numpy(), dc, span_cap=1, layout="block-sparse"))
    np.testing.assert_array_equal(cnt.numpy(), want)
    got = be.denser_nn_halo(x, xk, win, wk, st, en, dc, span_cap=1,
                            layout="block-sparse")
    for g, w in zip(got, be.denser_nn_halo(x, xk, win, wk, st, en, dc,
                                           span_cap=1)):
        assert torch.equal(g, w)
    jd, jp, jf = (np.asarray(a) for a in jbe.denser_nn_halo(
        jnp.asarray(x.numpy()), jnp.asarray(xk.numpy()),
        jnp.asarray(win.numpy()), jnp.asarray(wk.numpy()), st.numpy(),
        en.numpy(), dc, span_cap=1, layout="block-sparse"))
    np.testing.assert_array_equal(got[2].numpy(), jf)
    np.testing.assert_array_equal(got[1].numpy(), jp)
    np.testing.assert_allclose(got[0].numpy(), jd, rtol=1e-6)
    assert 0 < int(got[2].sum()) < x.shape[0]


@pytest.mark.parametrize("data", ["airline", "mixture"])
def test_block_sparse_halo_matches_jnp(data):
    """On domain-scale data, ``CudaBackend``'s block-sparse halo primitives
    against the reference's ``jnp`` halo primitives (the port rule for
    domain data), off the rows with a pair within 4 f32 ulps of d_cut^2."""
    pts = (real_proxy("airline", 2000, seed=8)[0] if data == "airline"
           else gaussian_mixture(2000, d=2, seed=8)[0])
    dc = pick_dcut(pts, target_rho=30)
    x, win, st, en, key, lo = _shard(pts, dc, 700, 1700)
    xk = key[700:1700].contiguous()
    wk = key[lo:lo + win.shape[0]].contiguous()
    span_w = int((en - st).max())
    be, jbe = CudaBackend(), jget_backend("jnp")
    cnt = be.range_count_halo(x, win, st, en, dc, span_cap=span_w,
                              layout="block-sparse")
    want = np.asarray(jbe.range_count_halo(
        jnp.asarray(x.numpy()), jnp.asarray(win.numpy()),
        jnp.asarray(st.numpy()), jnp.asarray(en.numpy()), dc,
        span_cap=span_w, layout="block-sparse"))
    thr = f32_d2cut(dc)
    keep = ~near_threshold_rows(x.numpy(), win.numpy(), thr,
                                4 * f32_ulp(thr))
    np.testing.assert_array_equal(cnt.numpy()[keep], want[keep])
    td, tp, tf = be.denser_nn_halo(x, xk, win, wk, st, en, dc,
                                   span_cap=span_w, layout="block-sparse")
    jd, jp, jf = (np.asarray(a) for a in jbe.denser_nn_halo(
        jnp.asarray(x.numpy()), jnp.asarray(xk.numpy()),
        jnp.asarray(win.numpy()), jnp.asarray(wk.numpy()),
        jnp.asarray(st.numpy()), jnp.asarray(en.numpy()), dc,
        span_cap=span_w, layout="block-sparse"))
    np.testing.assert_array_equal(tf.numpy()[keep], jf[keep])
    np.testing.assert_array_equal(tp.numpy()[keep], jp[keep])
    np.testing.assert_allclose(td.numpy()[keep], jd[keep], rtol=1e-6)


def test_denser_nn_update_takes_either_layout():
    """``denser_nn_update(layout="block-sparse")`` is the fused-gather
    kernel's dense result, as in the reference, whose pallas backend
    ignores the layout: equal to the port's dense call bit for bit and to
    the reference's ``pallas-interpret`` call (parent equal, delta to rtol
    1e-6), padding slots included."""
    pts = uniform_points(900, 2, seed=12)
    dc = clear_dcut(pts, target_rho=20)
    table = _t(pts)
    key = (sweep.range_count_plain(table, table, sweep.d2cut_of(dc)).float()
           + density_jitter(len(pts)))
    slots = torch.tensor(
        np.random.default_rng(3).permutation(900)[:200].tolist()
        + [900, 900, 901], dtype=torch.int32)
    be = CudaBackend()
    got = be.denser_nn_update(table, key, slots, layout="block-sparse")
    for g, w in zip(got, be.denser_nn_update(table, key, slots)):
        assert torch.equal(g, w)
    jd, jp = (np.asarray(a) for a in jget_backend(
        "pallas-interpret").denser_nn_update(
            jnp.asarray(pts), jnp.asarray(key.numpy()),
            jnp.asarray(slots.numpy()), layout="block-sparse"))
    np.testing.assert_array_equal(got[1].numpy(), jp)
    np.testing.assert_allclose(got[0].numpy(), jd, rtol=1e-6)
    assert bool((got[1][-3:] == -1).all())
    with pytest.raises(ValueError):
        be.denser_nn_update(table, key, slots, layout="sparse")


def test_halo_wrappers_refuse_what_the_kernels_do_not_take():
    x = _t(uniform_points(600, 2, seed=0))
    st = torch.zeros((600, 1), dtype=torch.int32)
    en = st + 600
    k = torch.rand(600)
    ring = blocksparse.build_flat_worklist(x, x, 0.1, count=False,
                                           nn="best1", nn_dcut=True,
                                           starts=st, ends=en)
    with pytest.raises(ValueError, match="row tiles"):
        ops.halo_density(x[:300], x, st[:300], en[:300], 0.1, worklist=ring)
    with pytest.raises(ValueError, match="column tile past"):
        ops.halo_dependent(x, k, x[:100], k[:100], st, en, 0.1,
                           worklist=ring)
    with pytest.raises(ValueError, match="live counts"):
        ops.halo_dependent(x, k, x, k, st, en, 0.1, worklist=ring,
                           live=torch.zeros(3, dtype=torch.int32))
    with pytest.raises(TypeError, match="Worklist"):
        ops.halo_density(x, x, st, en, 0.1, worklist=ring.row_ptr)
