"""The stream's kernels and bookkeeping held against the JAX package's.

On the CPU the wrappers of K4 ``range_count``, K5 ``range_count_signed``
and K6 ``gather_masked_nn`` run the kernels' plain versions (the CUDA
kernels are held against those on the card by chip_smoke.py).  Inputs are
built once with numpy and handed to both packages.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.tuning import pick_dcut
from repro.data.points import real_proxy
from repro.kernels import ops as jops
from repro.kernels.backend import get_backend as jget_backend
from repro.stream.incremental import CellOverflow as JCellOverflow
from repro.stream.incremental import IncrementalGrid as JGrid
from repro.stream.window import SlidingWindow as JWindow

from repro_torch.data.points import drifting_batches
from repro_torch.kernels import build, density, ops, sweep
from repro_torch.kernels.backend import CudaBackend
from repro_torch.kernels.dependent import masked_min_dist_gather
from repro_torch.stream import incremental
from repro_torch.stream.incremental import CellOverflow, IncrementalGrid
from repro_torch.stream.window import SlidingWindow

from _torch_ref import (clear_dcut, f32_d2cut, f32_ulp, near_threshold_rows,
                        pair_d2, uniform_points)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def airline():
    pts, _ = real_proxy("airline", 4096)
    return pts, pick_dcut(pts)


def test_range_counts_match_jnp_on_airline(airline):
    pts, dc = airline
    rng = np.random.default_rng(0)
    ins = pts[rng.permutation(len(pts))[:300]]
    signs = rng.choice([-1.0, 0.0, 1.0], len(ins)).astype(np.float32)
    jb = jget_backend("jnp")
    be = CudaBackend()
    got = be.range_count(_t(ins), _t(pts), dc).numpy()
    want = np.asarray(jb.range_count(jnp.asarray(ins), jnp.asarray(pts), dc))
    # a pair within 4 f32 ulps of d_cut^2 may round to either side
    thr = f32_d2cut(dc)
    band = near_threshold_rows(ins, pts, thr, 4 * f32_ulp(thr))
    np.testing.assert_array_equal(got[~band], want[~band])
    got = be.range_count_delta(_t(pts), _t(ins), _t(signs), dc).numpy()
    want = np.asarray(jb.range_count_delta(
        jnp.asarray(pts), jnp.asarray(ins), jnp.asarray(signs), dc))
    band = near_threshold_rows(pts, ins, thr, 4 * f32_ulp(thr))
    np.testing.assert_array_equal(got[~band], want[~band])
    assert got.dtype == np.float32 and (got < 0).any() and (got > 0).any()


def test_gather_nn_matches_jnp_on_airline(airline):
    pts, dc = airline
    n = len(pts)
    rng = np.random.default_rng(1)
    key = (ops.local_density_xy(_t(pts), _t(pts), dc).numpy()
           + rng.uniform(size=n).astype(np.float32))
    slots = np.concatenate([[np.argmax(key)], rng.permutation(n)[:700],
                            [n, n + 3, 2 * n]])
    td, tp = CudaBackend().denser_nn_update(_t(pts), _t(key), _t(slots))
    jd, jp = jget_backend("jnp").denser_nn_update(
        jnp.asarray(pts), jnp.asarray(key), jnp.asarray(slots))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6)
    assert (tp.numpy()[-3:] == -1).all() and np.isinf(td.numpy()[-3:]).all()
    # only the global peak has no strictly denser row
    np.testing.assert_array_equal(tp.numpy()[:-3] == -1,
                                  slots[:-3] == np.argmax(key))


@pytest.mark.parametrize("d", [2, 3, 8])
def test_stream_kernels_match_pallas_interpret(d):
    """Unit-scale data, d_cut clear of every pair: the reference's expanded
    form is exact here, so counts and parents agree exactly."""
    pts = uniform_points(600, d, seed=d)
    dc = clear_dcut(pts, target_rho=15)
    rng = np.random.default_rng(d)
    ins = pts[rng.permutation(600)[:200]]
    signs = rng.choice([-1.0, 0.0, 1.0], 200).astype(np.float32)
    np.testing.assert_array_equal(
        density.range_count(_t(ins), _t(pts), dc).numpy(),
        np.asarray(jops.local_density_xy(jnp.asarray(ins), jnp.asarray(pts),
                                         dc, interpret=True)))
    np.testing.assert_array_equal(
        density.range_count_signed(_t(pts), _t(ins), _t(signs), dc).numpy(),
        np.asarray(jops.local_density_delta(
            jnp.asarray(pts), jnp.asarray(ins), jnp.asarray(signs), dc,
            interpret=True)))
    key = rng.permutation(600).astype(np.float32)
    slots = np.concatenate([rng.permutation(600)[:150], [600, 601, 700]])
    td, tp = masked_min_dist_gather(_t(pts), _t(key), _t(slots))
    jd, jp = jops.dependent_masked_gather(
        jnp.asarray(pts), jnp.asarray(key), jnp.asarray(slots.astype(np.int32)),
        interpret=True)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6)
    assert (tp.numpy()[-3:] == -1).all()


def test_plain_versions_match_float64():
    pts = uniform_points(400, 3, seed=9)
    d2 = pair_d2(pts[:100], pts)
    thr = f32_d2cut(0.2)
    band = near_threshold_rows(pts[:100], pts, thr, 1e-5)
    cnt = sweep.range_count_plain(_t(pts[:100]), _t(pts), thr).numpy()
    np.testing.assert_array_equal(cnt[~band], (d2 < thr).sum(1)[~band])
    signs = np.random.default_rng(3).choice([-1.0, 1.0], 400).astype(
        np.float32)
    got = sweep.range_count_signed_plain(_t(pts[:100]), _t(pts), _t(signs),
                                         thr).numpy()
    np.testing.assert_array_equal(got[~band],
                                  ((d2 < thr) * signs).sum(1)[~band])


def test_gather_ties_are_lexicographic():
    """Integer lattice: many exactly equal distances; the winner is the
    lowest index among the nearest strictly denser rows."""
    g = np.stack(np.meshgrid(np.arange(12), np.arange(12)), -1)
    pts = g.reshape(-1, 2).astype(np.float32)
    key = (np.arange(len(pts)) % 3).astype(np.float32)
    slots = np.arange(len(pts) + 4)
    _, par = ops.dependent_masked_gather(_t(pts), _t(key), _t(slots))
    d2 = pair_d2(pts, pts)
    for r in range(len(pts)):
        cand = [(d2[r, j], j) for j in range(len(pts)) if key[j] > key[r]]
        assert par[r] == (min(cand)[1] if cand else -1)
    assert (par[len(pts):] == -1).all()
    # the same answers as K2 on the gathered rows
    _, par2 = ops.dependent_masked(_t(pts), _t(key), _t(pts), _t(key))
    assert torch.equal(par[:len(pts)], par2)


def test_stream_wrappers_refuse_and_never_build_on_cpu(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("nvcc must not run for CPU tensors")
    monkeypatch.setattr(build, "build", refuse)
    monkeypatch.setattr(build, "load_library", refuse)
    ops.reset_launch_counts()
    x = _t(uniform_points(50, 3, seed=0))
    be = CudaBackend()
    be.range_count(x, x, 0.1)
    be.range_count_delta(x, x, torch.ones(50), 0.1)
    be.denser_nn_update(x, torch.rand(50), torch.arange(50))
    assert set(ops.launch_counts().values()) == {0}
    with pytest.raises(ValueError):
        ops.local_density_delta(x, x, torch.ones(49), 0.1)
    with pytest.raises(TypeError):
        ops.local_density_xy(x.double(), x.double(), 0.1)
    with pytest.raises(ValueError):
        ops.dependent_masked_gather(x, torch.rand(50), torch.arange(5.0))
    with pytest.raises(ValueError):
        ops.dependent_masked_gather(x, torch.rand(50),
                                    torch.arange(10).reshape(2, 5))
    # the count's worklist form (K8) is ported: its plain version runs here
    assert torch.equal(be.range_count(x, x, 0.1, layout="block-sparse"),
                       be.range_count(x, x, 0.1))
    assert set(ops.launch_counts().values()) == {0}
    for call in (lambda: be.range_count_delta(x, x, torch.ones(50), 0.1,
                                              layout="block-sparse"),
                 lambda: be.denser_nn_update(x, torch.rand(50),
                                             torch.arange(3),
                                             layout="block-sparse")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()


# ------------------------------------------------------------ the window
def test_window_matches_reference_ring():
    rng = np.random.default_rng(0)
    jw, tw = JWindow(16, 2), SlidingWindow(16, 2)
    for r in (5, 8, 0, 8, 3, 8, 8):
        batch = np.full((8, 2), 1e9, np.float32)
        batch[:r] = rng.uniform(size=(r, 2))
        js, je, jv = jw.push(batch, r)
        ts, te, tv = tw.push(batch, r)
        np.testing.assert_array_equal(ts, js)
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(te[tv], je[jv])
        np.testing.assert_array_equal(tw.host, jw.host)
        np.testing.assert_array_equal(tw.device.numpy(), np.asarray(jw.device))
        assert (tw.count, tw.cursor, tw.ticks) == (jw.count, jw.cursor,
                                                   jw.ticks)
    np.testing.assert_array_equal(tw.contents(), jw.contents())


# -------------------------------------------------------------- the grid
def _grid_pair(pts, d_cut, **kw):
    jg = JGrid(d_cut, len(pts), pts.shape[1], **kw)
    tg = IncrementalGrid(d_cut, len(pts), pts.shape[1], **kw)
    jg.rebuild(pts, len(pts))
    tg.rebuild(pts, len(pts))
    return jg, tg


def _assert_same_grid(tg, jg):
    for name in ("box_lo", "box_extent", "strides", "cell_count", "seg_np"):
        np.testing.assert_array_equal(getattr(tg, name),
                                      np.asarray(getattr(jg, name)))
    np.testing.assert_array_equal(tg.seg_dev.numpy(), np.asarray(jg.seg_dev))
    assert tg.key_to_id == jg.key_to_id
    assert (tg.live_cells, tg.next_id, tg.maxima_cap, tg.rebuilds,
            tg.free_ids) == (jg.live_cells, jg.next_id, jg.maxima_cap,
                             jg.rebuilds, jg.free_ids)


def test_grid_apply_rebuild_and_snapshot_match_reference():
    frames = list(drifting_batches(64, 8, k=4, d=2, seed=1, drift=0.03))
    pts = np.concatenate([f[0] for f in frames[:4]])         # 256 points
    jg, tg = _grid_pair(pts, 4000.0)
    _assert_same_grid(tg, jg)
    window = pts.copy()
    for t, (batch, _, _) in enumerate(frames[4:]):
        slots = (np.arange(64) + 64 * t) % 256
        old = window[slots].copy()
        for g in (jg, tg):
            try:
                g.apply(slots, batch, old, 64)
            except (CellOverflow, JCellOverflow):
                window[slots] = batch
                g.rebuild(window, 256)
                window[slots] = old
        window[slots] = batch
        _assert_same_grid(tg, jg)
    snap = tg.snapshot()
    seg = tg.seg_dev.clone()
    tg.apply(np.arange(8), window[100:108], window[:8], 8)
    tg.restore(snap)
    assert torch.equal(tg.seg_dev, seg)
    _assert_same_grid(tg, jg)


@pytest.mark.parametrize("case", ["drift", "collapse"])
def test_cell_overflow_matches_reference(case):
    rng = np.random.default_rng(2)
    pts = rng.normal(5e4, 1500.0, (512, 2)).astype(np.float32)
    if case == "drift":      # walks out of the indexed box
        kw = dict(extent_margin=1, cell_slack=1.0)
        batch = rng.normal([9.5e4, 9.5e4], 500.0, (64, 2)).astype(np.float32)
    else:                    # spawns more cells than the live-cell budget
        kw = dict(extent_margin=32, cell_slack=1.0)
        batch = rng.uniform(1e4, 9e4, (64, 2)).astype(np.float32)
    jg, tg = _grid_pair(pts, 2000.0, **kw)
    with pytest.raises(JCellOverflow):
        jg.apply(np.arange(64), batch, pts[:64], 64)
    with pytest.raises(CellOverflow):
        tg.apply(np.arange(64), batch, pts[:64], 64)
    window = pts.copy()
    window[:64] = batch
    jg.rebuild(window, 512)
    tg.rebuild(window, 512)
    _assert_same_grid(tg, jg)
    assert tg.rebuilds == 1 and tg.last_touched is None


@pytest.mark.parametrize("kind", ["random", "clustered"])
@pytest.mark.parametrize("d", [2, 3, 5])
def test_dirty_near_matches_reference(kind, d, monkeypatch):
    rng = np.random.default_rng(d)
    if kind == "random":
        q = rng.integers(-40, 40, (3000, d))
        t = rng.integers(-40, 40, (50, d))
    else:
        q = np.concatenate([rng.integers(-12, 12, (2000, d)),
                            rng.integers(15, 40, (1000, d))])
        t = np.concatenate([rng.integers(-3, 3, (60, d)),
                            rng.integers(20, 26, (5, d))])
    rc = int(np.ceil(2 * np.sqrt(d))) + 1
    jg = JGrid(1.0, 8, d)
    jg.last_touched = t
    want = jg.dirty_near(q, rc)
    assert 0 < want.sum() < len(q)
    tg = IncrementalGrid(1.0, 8, d)
    tg.last_touched = t
    np.testing.assert_array_equal(tg.dirty_near(q, rc), want)
    # both routes give the reference's boolean
    qt, tt = torch.from_numpy(q), torch.unique(torch.from_numpy(t), dim=0)
    np.testing.assert_array_equal(
        incremental._near_dilated(qt, tt, rc).numpy(), want)
    monkeypatch.setattr(incremental, "_PAIRWISE_CHUNK", 1000)
    np.testing.assert_array_equal(
        incremental._near_pairwise(qt, tt, rc).numpy(), want)
    tg.last_touched = None
    assert tg.dirty_near(q, rc).all()
    tg.last_touched = np.zeros((0, d), np.int64)
    assert not tg.dirty_near(q, rc).any()
