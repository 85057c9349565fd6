"""The port's block-sparse layout held against the JAX package's: the
worklist build, the worklist sweep (K3's plain version) and ``rho_delta``
(the drivers: tests/test_torch_drivers.py).

On the CPU the wrappers run the kernels' plain versions (K3 itself is held
against its plain version and against dense K1 on the card by
chip_smoke.py).  Inputs are built once with numpy and handed to both
packages.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import blocksparse as jbs
from repro.kernels import ops as jops
from repro.kernels.backend import get_backend as jget_backend

from repro_torch import carry, obs
from repro_torch.core.dpc_types import density_jitter
from repro_torch.core.grid import build_grid
from repro_torch.core.tuning import pick_dcut
from repro_torch.data.points import real_proxy
from repro_torch.kernels import blocksparse, ops, sweep
from repro_torch.kernels.backend import CudaBackend

from _torch_ref import (clear_dcut, f32_d2cut, f32_ulp, near_threshold_rows,
                        pair_d2, uniform_points)

def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _sorted(pts, dc):
    """The grid-sorted table, as the drivers lay it out."""
    return build_grid(_t(pts), dc).points.numpy()


def _data(kind, n, d):
    if kind == "airline":
        pts = real_proxy("airline", n, seed=1)[0]
        return pts, pick_dcut(pts, target_rho=30)
    pts = uniform_points(n, d, seed=n + d)
    return pts, pick_dcut(pts, target_rho=20)


def _lattice():
    """Integer lattice: many exactly equal distances."""
    g = np.stack(np.meshgrid(np.arange(48), np.arange(48)), -1)
    return g.reshape(-1, 2).astype(np.float32), 2.5


@pytest.mark.parametrize("kind,n,d", [
    ("unit", 2048, 2), ("unit", 2048, 3), ("unit", 8192, 2),
    ("unit", 8192, 3), ("unit", 2048, 8), ("airline", 8192, 3)])
def test_worklist_matches_reference(kind, n, d):
    pts, dc = _data(kind, n, d)
    gp = _sorted(pts, dc)
    want = jbs.build_flat_worklist(gp, gp, dc, block_n=256, block_m=512,
                                   count=True, nn="topk", k=8)
    got = blocksparse.build_flat_worklist(_t(gp), _t(gp), dc)
    meta = np.asarray(want.meta)
    first = np.zeros(got.n_kept, np.int32)
    first[got.row_ptr[:-1].numpy()] = 1
    assert (got.n_kept, got.n_total) == (want.n_kept, want.n_total)
    np.testing.assert_array_equal(got.row_tile().numpy(), meta[0])
    np.testing.assert_array_equal(got.col_tile.numpy(), meta[1])
    np.testing.assert_array_equal(first, meta[2])
    np.testing.assert_array_equal(got.in_cut.numpy(), meta[3] == 1)
    if d < 8:
        np.testing.assert_array_equal(got.lb.numpy(), np.asarray(want.lb))
    else:
        # numpy's pairwise summation may add 8 dims in another order
        np.testing.assert_allclose(got.lb.numpy(), np.asarray(want.lb),
                                   rtol=1e-6)
    assert got.pruned_frac == pytest.approx(want.pruned_frac)
    # at n = 8192 some kept pairs are outside d_cut; on the skewed Airline
    # proxy some pairs are pruned outright
    if n == 8192:
        assert not got.in_cut.all()
    if kind == "airline":
        assert got.n_kept < got.n_total


def test_one_cell_degenerates_to_dense():
    pts = uniform_points(3000, 3, seed=2) * np.float32(1e-3)
    wl = blocksparse.build_flat_worklist(_t(pts), _t(pts), 1.0)
    assert wl.n_kept == wl.n_total == 12 * 6
    assert bool(wl.in_cut.all())
    np.testing.assert_array_equal(
        wl.col_tile.numpy().reshape(12, 6), np.tile(np.arange(6), (12, 1)))


def test_worklist_counters():
    builds = obs.counter("worklist_builds")
    before = builds.value()
    pts, dc = _data("unit", 2048, 2)
    wl = blocksparse.build_flat_worklist(_t(pts), _t(pts), dc)
    assert builds.value() == before + 1
    assert obs.gauge("worklist_len").value() == wl.n_kept
    assert obs.gauge("worklist_pruned_frac").value() == pytest.approx(
        wl.pruned_frac, abs=1e-6)


@pytest.mark.parametrize("seed", [5, 6])
def test_worklist_sweep_matches_pallas(seed):
    """JAX's own worklist, carried across, through the port's plain K3 and
    the reference's Pallas worklist sweep."""
    pts = uniform_points(2048, 3, seed=seed)
    dc = pick_dcut(pts, target_rho=20)
    gp = _sorted(pts, dc)
    jwl = jbs.build_flat_worklist(gp, gp, dc, block_n=256, block_m=512,
                                  count=True, nn="topk", k=8)
    wl = carry.flat_worklist(jwl.meta, jwl.lb, jwl.n_kept, jwl.n_total)
    jc, _, ji = (np.asarray(a) for a in jops.fused_sweep(
        jnp.asarray(gp), jnp.asarray(gp), dc, block_n=256, block_m=512,
        interpret=True, worklist=jwl))
    tc, tv, ti = sweep.worklist_count_topk_plain(_t(gp), _t(gp),
                                                 sweep.d2cut_of(dc), wl)
    # the reference's expanded form carries ~1e-7 relative error: a pair
    # within 1e-5 relative of d_cut^2 may count on one side only
    thr = f32_d2cut(dc)
    band = near_threshold_rows(gp, gp, thr, 1e-5 * thr)
    assert band.sum() <= 8
    np.testing.assert_array_equal(tc.numpy()[~band], jc[~band])
    # kept sets equal wherever the 8th and 9th float64 distances are more
    # than 1e-4 apart (relative), beyond either form's error
    s = np.sort(pair_d2(gp, gp), axis=1)
    tie = np.abs(s[:, 8] - s[:, 7]) <= 1e-4 * s[:, 8]
    assert tie.sum() <= 8
    for r in np.nonzero(~tie)[0]:
        assert set(ti[r].tolist()) == set(ji[r].tolist()), r
    # and bit-equal to the port's dense sweep on the same table
    dense = sweep.fused_count_topk_plain(_t(gp), _t(gp), sweep.d2cut_of(dc))
    for g, w in zip((tc, tv, ti), dense):
        assert torch.equal(g, w)


@pytest.mark.parametrize("case", ["airline", "unit-d2", "lattice"])
def test_worklist_sweep_equals_dense(case):
    """Pruned and ring-ordered, the worklist sweep is the dense sweep bit
    for bit; on the lattice exact distance ties are decided by index, as
    the dense sweep decides them."""
    if case == "lattice":
        pts, dc = _lattice()
    else:
        pts, dc = _data(*(("airline", 4096, 3) if case == "airline"
                          else ("unit", 4096, 2)))
    gp = _t(_sorted(pts, dc))
    d2cut = sweep.d2cut_of(dc)
    dense = sweep.fused_count_topk_plain(gp, gp, d2cut)
    wl = blocksparse.build_flat_worklist(gp, gp, dc)
    got = sweep.worklist_count_topk_plain(gp, gp, d2cut, wl)
    for g, w in zip(got, dense):
        assert torch.equal(g, w)
    if case == "lattice":
        # ring order is not column order, so ties meet out of index order
        rt = wl.row_tile()
        assert bool(((wl.col_tile[1:] < wl.col_tile[:-1])
                     & (rt[1:] == rt[:-1])).any())
        ties = (dense[1][:, 1:] == dense[1][:, :-1]).sum()
        assert ties > len(pts)          # the kept 8 hold many exact ties


def test_rho_delta_block_sparse_matches_jnp_on_realistic_data():
    pts, _ = real_proxy("airline", 2048, seed=3)
    dc = pick_dcut(pts)
    gp = _sorted(pts, dc)
    jitter = np.asarray(density_jitter(2048))
    jout = [np.asarray(a) for a in jget_backend("jnp").rho_delta(
        jnp.asarray(gp), jnp.asarray(gp), dc, jitter=jnp.asarray(jitter),
        layout="block-sparse")]
    tout = [a.numpy() for a in CudaBackend().rho_delta(
        _t(gp), _t(gp), dc, jitter=_t(jitter), layout="block-sparse")]
    thr = f32_d2cut(dc)
    # domain 1e5: a pair within 4 f32 ulps of d_cut^2 may round either way
    band = near_threshold_rows(gp, gp, thr, 4 * f32_ulp(thr))
    np.testing.assert_array_equal(tout[0][~band], jout[0][~band])
    np.testing.assert_array_equal(tout[3], jout[3])
    np.testing.assert_allclose(tout[2], jout[2], rtol=1e-6)


def test_rho_delta_block_sparse_matches_pallas_and_dense():
    pts = uniform_points(2048, 3, seed=7)
    dc = clear_dcut(pts, target_rho=20)
    gp = _sorted(pts, dc)
    jout = [np.asarray(a) for a in jget_backend("pallas-interpret").rho_delta(
        jnp.asarray(gp), jnp.asarray(gp), dc, layout="block-sparse")]
    be = CudaBackend()
    sparse = be.rho_delta(_t(gp), _t(gp), dc, layout="block-sparse")
    # d_cut^2 is clear of every pair by 1e-4 relative: counts are exact
    np.testing.assert_array_equal(sparse[0].numpy(), jout[0])
    np.testing.assert_array_equal(sparse[1].numpy(), jout[1])
    np.testing.assert_array_equal(sparse[3].numpy(), jout[3])
    np.testing.assert_allclose(sparse[2].numpy(), jout[2], rtol=1e-6)
    for g, w in zip(sparse, be.rho_delta(_t(gp), _t(gp), dc)):
        assert torch.equal(g, w)


def test_carried_worklist_equals_own():
    pts, dc = _data("airline", 8192, 3)
    gp = _sorted(pts, dc)
    jwl = jbs.build_flat_worklist(gp, gp, dc, block_n=256, block_m=512,
                                  count=True, nn="topk", k=8)
    got = carry.flat_worklist(jwl.meta, jwl.lb, jwl.n_kept, jwl.n_total)
    own = blocksparse.build_flat_worklist(_t(gp), _t(gp), dc)
    for name in ("row_ptr", "col_tile", "in_cut", "lb"):
        assert torch.equal(getattr(got, name), getattr(own, name)), name
    assert (got.n_kept, got.n_total) == (own.n_kept, own.n_total)


def test_wrapper_refuses_worklists_the_kernel_does_not_take():
    x = _t(uniform_points(600, 3, seed=0))
    wl = blocksparse.build_flat_worklist(x, x, 0.1)
    with pytest.raises(ValueError, match="row tiles"):
        ops.fused_sweep(x[:100].contiguous(), x, 0.1, worklist=wl)
    with pytest.raises(ValueError, match="column tile"):
        ops.fused_sweep(x, x[:400].contiguous(), 0.1, worklist=wl)
    with pytest.raises(ValueError, match="live"):
        ops.fused_sweep(x, x, 0.1, worklist=wl,
                        live=torch.zeros(3, dtype=torch.int32))
    with pytest.raises(TypeError):
        ops.fused_sweep(x, x, 0.1, worklist=(wl.row_ptr, wl.col_tile))
    with pytest.raises(ValueError):
        CudaBackend().rho_delta(x, x, 0.1, layout="sparse")
