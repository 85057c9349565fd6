"""The distributed slice's kernels on the CPU: the count-only and best-1
worklists (K8/K9's), the halo spans (K10/K11's), and the kernels' plain
versions held against the JAX package's Pallas kernels in interpret mode on
unit-scale data and against its ``jnp`` primitives on domain-scale data.

On the CPU the wrappers run the plain versions; the kernels themselves are
held against them, bit for bit, on the card by chip_smoke.py (phase 16).
Inputs are built once with numpy and handed to both packages.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.grid import build_grid as jbuild_grid
from repro.core.grid import point_span_bounds as jpoint_span_bounds
from repro.kernels import blocksparse as jbs
from repro.kernels import ops as jops
from repro.kernels.backend import get_backend as jget_backend

from repro_torch import carry
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


def _sorted(pts, dc):
    return build_grid(_t(pts), dc).points.numpy()


def _keys(x, dc):
    """rho + jitter keys of the table x, as the fits make them."""
    return (sweep.range_count_plain(x, x, sweep.d2cut_of(dc)).float()
            + density_jitter(x.shape[0]))


def _lattice():
    g = np.stack(np.meshgrid(np.arange(48), np.arange(48)), -1)
    return g.reshape(-1, 2).astype(np.float32), 2.5


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
@pytest.mark.parametrize("kind", ["unit-2", "unit-3", "airline"])
def test_worklist_forms_match_reference(kind, form):
    """The count-only worklist and the best-1 ring, row block against the
    whole table and the whole table against itself."""
    if kind == "airline":
        pts = real_proxy("airline", 6000, seed=2)[0]
    else:
        pts = uniform_points(3000, int(kind[-1]), seed=9)
    dc = pick_dcut(pts, target_rho=20)
    gp = _sorted(pts, dc)
    for x in (gp[1000:2300], gp):
        if form == "count":
            want = jbs.build_flat_worklist(x, gp, dc, block_n=256,
                                           block_m=512, count=True)
            got = blocksparse.build_flat_worklist(_t(x), _t(gp), dc, nn=None)
        else:
            want = jbs.build_flat_worklist(x, gp, None, block_n=256,
                                           block_m=512, count=False,
                                           nn="best1")
            got = blocksparse.build_flat_worklist(_t(x), _t(gp), count=False,
                                                  nn="best1")
        _same_worklist(got, want)
    if form == "best1":
        assert got.n_kept == got.n_total and not got.in_cut.any()
    elif kind == "airline":
        assert got.n_kept < got.n_total


def test_worklist_form_refused():
    """The forms that stay unported: with or without halo spans, only count
    alone, topk with count, best1 alone and (with spans) best1 with
    nn_dcut are built."""
    x = _t(uniform_points(300, 2, seed=0))
    sp = torch.zeros((300, 2), dtype=torch.int32)
    for kw in ({"count": False, "nn": "topk"}, {"count": False, "nn": None},
               {"count": True, "nn": "best1"},
               {"count": False, "nn": "best1", "nn_dcut": True},
               {"count": True, "nn": "topk", "starts": sp, "ends": sp},
               {"count": False, "nn": "best1", "starts": sp, "ends": sp},
               {"count": True, "nn": "best1", "nn_dcut": True, "starts": sp,
                "ends": sp}):
        with pytest.raises(ValueError, match="not ported"):
            blocksparse.build_flat_worklist(x, x, 0.1, **kw)


@pytest.mark.parametrize("seed", [3, 4])
def test_plain_worklist_count_matches_pallas(seed):
    """The reference's own count-only worklist, carried across, through the
    port's plain K8 and the reference's Pallas worklist count; shard-like
    rows (a contiguous block of the sorted table) against the table."""
    pts = uniform_points(2500, 3, seed=seed)
    dc = clear_dcut(pts, target_rho=20)
    gp = _sorted(pts, dc)
    x = gp[700:1900]
    jwl = jbs.build_flat_worklist(x, gp, dc, block_n=256, block_m=512,
                                  count=True)
    wl = carry.flat_worklist(jwl.meta, jwl.lb, jwl.n_kept, jwl.n_total)
    want = np.asarray(jops.local_density_xy(
        jnp.asarray(x), jnp.asarray(gp), dc, block_n=256, block_m=512,
        interpret=True, worklist=jwl))
    got = ops.local_density_xy(_t(x), _t(gp), dc, worklist=wl)
    # d_cut^2 is clear of every pair by 1e-4 relative: counts are exact
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, ops.local_density_xy(_t(x), _t(gp), dc))


@pytest.mark.parametrize("seed", [3, 4])
def test_plain_worklist_nn_matches_pallas(seed):
    """The reference's best-1 ring, carried across, through the port's
    plain K9 and the reference's Pallas worklist NN."""
    pts = uniform_points(2500, 3, seed=seed)
    dc = clear_dcut(pts, target_rho=20)
    gp = _sorted(pts, dc)
    key = _keys(_t(gp), dc)
    x, xk = gp[700:1900], key[700:1900].contiguous()
    jwl = jbs.build_flat_worklist(x, gp, None, block_n=256, block_m=512,
                                  count=False, nn="best1")
    wl = carry.flat_worklist(jwl.meta, jwl.lb, jwl.n_kept, jwl.n_total)
    jd, jp = (np.asarray(a) for a in jops.dependent_masked(
        jnp.asarray(x), jnp.asarray(xk.numpy()), jnp.asarray(gp),
        jnp.asarray(key.numpy()), block_n=256, block_m=512, interpret=True,
        worklist=jwl))
    td, tp = ops.dependent_masked(_t(x), xk, _t(gp), key, worklist=wl)
    np.testing.assert_array_equal(tp.numpy(), jp)
    np.testing.assert_allclose(td.numpy(), jd, rtol=1e-6)
    assert int((tp == -1).sum()) == int(torch.argmax(key) in range(700, 1900))
    for g, w in zip((td, tp), ops.dependent_masked(_t(x), xk, _t(gp), key)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("case", ["airline", "unit-2", "lattice"])
def test_plain_worklist_kernels_equal_dense(case):
    """On the port's own worklists the plain K8 equals the dense count and
    the plain K9 the dense NN, bit for bit; on the lattice exact distance
    ties are decided by index, as K2 decides them."""
    if case == "lattice":
        pts, dc = _lattice()
    elif case == "airline":
        pts = real_proxy("airline", 4096, seed=1)[0]
        dc = pick_dcut(pts, target_rho=30)
    else:
        pts = uniform_points(4096, 2, seed=8)
        dc = pick_dcut(pts, target_rho=20)
    gp = _t(_sorted(pts, dc))
    key = (torch.arange(len(gp)) % 3).float() if case == "lattice" \
        else _keys(gp, dc)
    for r0, r1 in ((0, len(gp)), (1000, 2100)):
        x, xk = gp[r0:r1], key[r0:r1].contiguous()
        cwl = blocksparse.build_flat_worklist(x, gp, dc, nn=None)
        assert torch.equal(ops.local_density_xy(x, gp, dc, worklist=cwl),
                           ops.local_density_xy(x, gp, dc))
        bwl = blocksparse.build_flat_worklist(x, gp, count=False, nn="best1")
        got = ops.dependent_masked(x, xk, gp, key, worklist=bwl)
        want = ops.dependent_masked(x, xk, gp, key)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    if case == "lattice":
        d2 = sweep.masked_nn_plain(gp, key, gp, key)[0]
        assert int((d2 == 1.0).sum()) > len(gp) // 2   # ties everywhere


def _halo_inputs(pts, dc, r0, r1):
    """A shard's rows [r0, r1) of the grid-sorted table, the window of
    sorted slots their spans reach, and the window-local spans, from the
    reference's grid (the port's is bit-equal: test_point_span_bounds)."""
    g = jbuild_grid(jnp.asarray(pts), dc)
    st, en = (np.asarray(a) for a in jpoint_span_bounds(g))
    # one more span per row, empty at slot 0 (distributed_dpc's padding rows'
    # spans): window-local, it turns negative
    st = np.pad(st[r0:r1], ((0, 0), (0, 1)))
    en = np.pad(en[r0:r1], ((0, 0), (0, 1)))
    live = en > st
    lo = min(int(st[live].min()), r0)
    hi = max(int(en[live].max()), r1)
    gp = np.asarray(g.points)
    return gp[r0:r1], gp[lo:hi], (st - lo).astype(np.int32), \
        (en - lo).astype(np.int32), gp, lo


@pytest.mark.parametrize("d", [2, 3])
def test_plain_halo_kernels_match_pallas(d):
    """The plain K10/K11 against the reference's ``ops.halo_density`` and
    ``ops.halo_dependent`` in interpret mode, on unit-scale data: a shard
    of rows whose window starts inside the table (empty spans turn
    negative)."""
    pts = uniform_points(2000, d, seed=20 + d)
    dc = clear_dcut(pts, target_rho=20)
    x, win, st, en, gp, lo = _halo_inputs(pts, dc, 600, 1500)
    assert lo > 0 and (st < 0).any()
    key = _keys(_t(gp), dc)
    xk = key[600:1500].contiguous()
    wk = key[lo:lo + len(win)].contiguous()
    want_c = np.asarray(jops.halo_density(
        jnp.asarray(x), jnp.asarray(win), jnp.asarray(st), jnp.asarray(en),
        dc, interpret=True))
    got_c = ops.halo_density(_t(x), _t(win), _t(st), _t(en), dc)
    np.testing.assert_array_equal(got_c.numpy(), want_c)
    jd, jp, jf = (np.asarray(a) for a in jops.halo_dependent(
        jnp.asarray(x), jnp.asarray(xk.numpy()), jnp.asarray(win),
        jnp.asarray(wk.numpy()), jnp.asarray(st), jnp.asarray(en), dc,
        interpret=True))
    td, tp, tf = ops.halo_dependent(_t(x), xk, _t(win), wk, _t(st), _t(en),
                                    dc)
    np.testing.assert_array_equal(tf.numpy(), jf)
    np.testing.assert_array_equal(tp.numpy(), jp)
    np.testing.assert_allclose(td.numpy(), jd, rtol=1e-6)
    assert 0 < int(tf.sum()) < len(x)        # both kinds of rows occur


@pytest.mark.parametrize("data", ["airline", "mixture"])
def test_plain_halo_kernels_match_jnp(data):
    """The plain K10/K11 on domain-scale data against the reference's
    ``JnpBackend.range_count_halo`` / ``denser_nn_halo``."""
    pts = (real_proxy("airline", 3000, seed=6)[0] if data == "airline"
           else gaussian_mixture(3000, d=2, seed=6)[0])
    dc = pick_dcut(pts, target_rho=30)
    x, win, st, en, gp, lo = _halo_inputs(pts, dc, 1000, 2200)
    key = _keys(_t(gp), dc)
    xk = key[1000:2200].contiguous()
    wk = key[lo:lo + len(win)].contiguous()
    be = jget_backend("jnp")
    span_w = int((en - st).max())
    want_c = np.asarray(be.range_count_halo(
        jnp.asarray(x), jnp.asarray(win), jnp.asarray(st), jnp.asarray(en),
        dc, span_cap=span_w))
    got_c = CudaBackend().range_count_halo(_t(x), _t(win), _t(st), _t(en),
                                           dc, span_cap=span_w)
    thr = f32_d2cut(dc)
    # domain 1e5: a pair within 4 f32 ulps of d_cut^2 may round either way
    band = near_threshold_rows(x, win, thr, 4 * f32_ulp(thr))
    np.testing.assert_array_equal(got_c.numpy()[~band], want_c[~band])
    jd, jp, jf = (np.asarray(a) for a in be.denser_nn_halo(
        jnp.asarray(x), jnp.asarray(xk.numpy()), jnp.asarray(win),
        jnp.asarray(wk.numpy()), jnp.asarray(st), jnp.asarray(en), dc,
        span_cap=span_w))
    td, tp, tf = CudaBackend().denser_nn_halo(
        _t(x), xk, _t(win), wk, _t(st), _t(en), dc, span_cap=span_w)
    keep = ~band
    np.testing.assert_array_equal(tf.numpy()[keep], jf[keep])
    np.testing.assert_array_equal(tp.numpy()[keep], jp[keep])
    np.testing.assert_allclose(td.numpy()[keep], jd[keep], rtol=1e-6)


def test_halo_whole_window_equals_dense():
    """Spans covering the whole window: K10 is the dense count and K11 the
    dense NN masked to d_cut; empty spans, spans past the window and
    padded 1e9 rows count nothing."""
    pts = _t(_sorted(*_lattice()))
    dc = 2.5
    n = len(pts)
    key = (torch.arange(n) % 3).float()
    x = torch.cat([pts, torch.full((3, 2), 1e9)])
    xk = torch.cat([key, torch.full((3,), float("inf"))])
    st = torch.zeros((n + 3, 4), dtype=torch.int32)
    en = torch.zeros_like(st)
    st[:n, 1], en[:n, 1] = -5, n // 2           # negative start: clipped
    st[:n, 2], en[:n, 2] = n // 2, n + 40       # past the window: clipped
    st[:n, 3], en[:n, 3] = 7, 3                 # a reversed span: empty
    cnt = ops.halo_density(x, pts, st, en, dc)
    assert torch.equal(cnt[:n], ops.local_density_xy(pts, pts, dc))
    assert not cnt[n:].any()
    d, p, f = ops.halo_dependent(x, xk, pts, key, st, en, dc)
    best, arg = sweep.masked_nn_plain(pts, key, pts, key)
    within = best < sweep.d2cut_of(dc)
    assert torch.equal(f[:n], within)
    assert torch.equal(p[:n], torch.where(within, arg, -1))
    assert torch.equal(d[:n], torch.where(within, best.sqrt(),
                                          float("inf")))
    assert not f[n:].any() and bool((p[n:] == -1).all())


@pytest.mark.parametrize("d", [2, 3, 4])
def test_point_span_bounds_match_reference(d):
    pts = (real_proxy("airline", 5000, seed=3)[0] if d == 3
           else gaussian_mixture(5000, d=d, seed=d)[0])
    dc = pick_dcut(pts, target_rho=30)
    st, en = point_span_bounds(build_grid(_t(pts), dc))
    jst, jen = jpoint_span_bounds(jbuild_grid(jnp.asarray(pts), dc))
    assert st.dtype == en.dtype == torch.int32
    assert st.shape == (len(pts), 3 ** (min(d, 3) - 1))
    np.testing.assert_array_equal(st.numpy(), np.asarray(jst))
    np.testing.assert_array_equal(en.numpy(), np.asarray(jen))


def test_backend_layouts():
    """``range_count``, ``denser_nn`` and the halo pair under the
    block-sparse layout equal the dense forms."""
    pts = real_proxy("airline", 3000, seed=7)[0]
    dc = pick_dcut(pts, target_rho=30)
    gp = _t(_sorted(pts, dc))
    key = _keys(gp, dc)
    be = CudaBackend()
    x, xk = gp[500:1700], key[500:1700].contiguous()
    assert torch.equal(be.range_count(x, gp, dc, layout="block-sparse"),
                       be.range_count(x, gp, dc))
    for g, w in zip(be.denser_nn(x, xk, gp, key, layout="block-sparse"),
                    be.denser_nn(x, xk, gp, key)):
        assert torch.equal(g, w)
    # the halo pair over whole-table spans: K15 and K16 on their span
    # worklists equal K10 and K11
    sp = torch.tensor([[0, len(gp)], [7, 3], [-9, -2]], dtype=torch.int32)
    st = sp[:, 0].expand(len(x), 3).contiguous()
    en = sp[:, 1].expand(len(x), 3).contiguous()
    assert torch.equal(be.range_count_halo(x, gp, st, en, dc, span_cap=1,
                                           layout="block-sparse"),
                       be.range_count_halo(x, gp, st, en, dc, span_cap=1))
    for g, w in zip(be.denser_nn_halo(x, xk, gp, key, st, en, dc,
                                      span_cap=1, layout="block-sparse"),
                    be.denser_nn_halo(x, xk, gp, key, st, en, dc,
                                      span_cap=1)):
        assert torch.equal(g, w)
    with pytest.raises(ValueError):
        be.denser_nn(x, xk, gp, key, layout="sparse")


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = _t(uniform_points(600, 3, seed=0))
    k = torch.rand(600)
    wl = blocksparse.build_flat_worklist(x, x, count=False, nn="best1")
    with pytest.raises(ValueError, match="row tiles"):
        ops.dependent_masked(x[:100].contiguous(), k[:100].contiguous(), x,
                             k, worklist=wl)
    with pytest.raises(ValueError, match="column tile"):
        ops.local_density_xy(x, x[:400].contiguous(), 0.1,
                             worklist=blocksparse.build_flat_worklist(
                                 x, x, 0.1, nn=None))
    with pytest.raises(ValueError, match="live"):
        ops.dependent_masked(x, k, x, k, worklist=wl,
                             live=torch.zeros(3, dtype=torch.int32))
    sp = torch.zeros((600, 9), dtype=torch.int32)
    for bad in (sp.long(), sp[:10], sp.t().contiguous().t(),
                torch.zeros((600, 0), dtype=torch.int32)):
        with pytest.raises(ValueError, match="starts and ends"):
            ops.halo_density(x, x, bad, sp, 0.1)
    with pytest.raises(ValueError):
        ops.halo_dependent(x, k, x, k[:10].contiguous(), sp, sp, 0.1)
