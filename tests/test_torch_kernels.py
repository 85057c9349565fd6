"""The port's kernel layer held against the JAX package's.

On the CPU the wrappers run the kernels' plain PyTorch versions (the CUDA
kernels themselves are held against those on the card by chip_smoke.py).
Inputs are built once with numpy and handed to both packages.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.tuning import pick_dcut
from repro.data.points import real_proxy
from repro.kernels import ops as jops
from repro.kernels.backend import get_backend as jget_backend

from repro_torch.core.dpc_types import density_jitter
from repro_torch.kernels import build, ops, sweep
from repro_torch.kernels.backend import CudaBackend, get_backend
from repro_torch.kernels.dependent import masked_min_dist, prefix_min_dist

from _torch_ref import (clear_dcut, f32_d2cut, f32_ulp, near_threshold_rows,
                        pair_d2, uniform_points)

SHAPES = [(n, d) for n in (64, 1000, 2048) for d in (2, 3, 8)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("n,d", SHAPES)
def test_fused_sweep_matches_pallas(n, d):
    pts = uniform_points(n, d, seed=n + d)
    dc = pick_dcut(pts, target_rho=20)
    jc, _, ji = (np.asarray(a) for a in jops.fused_sweep(
        jnp.asarray(pts), jnp.asarray(pts), dc, interpret=True))
    tc, tv, ti = (a.numpy() for a in ops.fused_sweep(_t(pts), _t(pts), dc))

    # counts: the reference's expanded form |x|^2+|y|^2-2xy carries about
    # 1e-7 relative error, so a pair within 1e-5 relative of d_cut^2 may
    # count on one side only; every other row must agree exactly
    thr = f32_d2cut(dc)
    band = near_threshold_rows(pts, pts, thr, 1e-5 * thr)
    assert band.sum() <= 8
    np.testing.assert_array_equal(tc[~band], jc[~band])

    # kept-8 index sets: equal wherever the 8th and 9th float64 distances
    # are more than 1e-4 apart (relative), beyond either form's error
    s = np.sort(pair_d2(pts, pts), axis=1)
    tie = np.abs(s[:, 8] - s[:, 7]) <= 1e-4 * s[:, 8]
    assert tie.sum() <= 8
    for r in np.nonzero(~tie)[0]:
        assert set(ti[r]) == set(ji[r]), r
    # the port's kept d2 are direct differences, ascending per row
    assert np.all(np.diff(tv, axis=1) >= 0)


@pytest.mark.parametrize("n,d", SHAPES)
def test_dependent_masked_matches_pallas(n, d):
    pts = uniform_points(n, d, seed=7 * n + d)
    key = np.random.default_rng(n).permutation(n).astype(np.float32)
    jd, jp = (np.asarray(a) for a in jops.dependent_masked(
        jnp.asarray(pts), jnp.asarray(key), jnp.asarray(pts),
        jnp.asarray(key), interpret=True))
    td, tp = (a.numpy() for a in masked_min_dist(_t(pts), _t(key), _t(pts),
                                                 _t(key)))
    np.testing.assert_array_equal(tp, jp)
    # both deltas are direct-difference f32 sqrt; summation order may
    # differ by an ulp
    np.testing.assert_allclose(td, jd, rtol=1e-6)


@pytest.mark.parametrize("interest", [False, True])
def test_rho_delta_matches_pallas_interpret(interest):
    pts = uniform_points(1000, 3, seed=3)
    dc = clear_dcut(pts, target_rho=20)
    jitter = np.asarray(density_jitter(1000))
    mask = np.random.default_rng(1).uniform(size=1000) < 0.3
    jfi = (lambda rk: jnp.asarray(mask)) if interest else None
    tfi = (lambda rk: _t(mask)) if interest else None
    jout = [np.asarray(a) for a in jget_backend("pallas-interpret").rho_delta(
        jnp.asarray(pts), jnp.asarray(pts), dc, jitter=jnp.asarray(jitter),
        fallback_interest=jfi)]
    tout = [a.numpy() for a in CudaBackend().rho_delta(
        _t(pts), _t(pts), dc, jitter=_t(jitter), fallback_interest=tfi)]
    # d_cut^2 is clear of every pair by 1e-4 relative: counts are exact
    np.testing.assert_array_equal(tout[0], jout[0])
    np.testing.assert_array_equal(tout[1], jout[1])
    np.testing.assert_array_equal(tout[3], jout[3])
    np.testing.assert_allclose(tout[2], jout[2], rtol=1e-6)
    if interest:     # some rows really were left unresolved, as (inf, -1)
        assert (tout[3] == -1).sum() > 1


def test_realistic_data_matches_jnp():
    """Domain 1e5: the reference's expanded form loses counts here, its
    direct-difference jnp backend does not; the port is held against jnp."""
    pts, _ = real_proxy("airline", 2048)
    dc = pick_dcut(pts)
    x = _t(pts)
    rho = ops.fused_sweep(x, x, dc)[0].numpy()
    jrho = np.asarray(jget_backend("jnp").range_count(
        jnp.asarray(pts), jnp.asarray(pts), dc))
    thr = f32_d2cut(dc)
    # a pair within 4 f32 ulps of d_cut^2 may round to either side
    band = near_threshold_rows(pts, pts, thr, 4 * f32_ulp(thr))
    np.testing.assert_array_equal(rho[~band], jrho[~band])

    key = jrho + np.asarray(density_jitter(2048))
    jd, jp = (np.asarray(a) for a in jget_backend("jnp").denser_nn(
        jnp.asarray(pts), jnp.asarray(key), jnp.asarray(pts),
        jnp.asarray(key)))
    td, tp = (a.numpy() for a in get_backend("cuda").denser_nn(
        x, _t(key), x, _t(key)))
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_allclose(td, jd, rtol=1e-6)


def test_kept_k_is_lexicographic_on_ties():
    """Integer lattice: many exactly equal distances.  The kept 8 are the
    8 smallest (d2, index) pairs, and the NN winner is the lowest index."""
    g = np.stack(np.meshgrid(np.arange(9), np.arange(9)), -1)
    pts = g.reshape(-1, 2).astype(np.float32)
    x = _t(pts)
    _, tv, ti = ops.fused_sweep(x, x, 1.5)
    d2 = pair_d2(pts, pts)
    for r in range(len(pts)):
        want = sorted(zip(d2[r], range(len(pts))))[:8]
        assert [j for _, j in want] == ti[r].tolist()
        assert [v for v, _ in want] == tv[r].tolist()
    key = np.zeros(len(pts), np.float32)
    key[::2] = 1.0
    _, par = ops.dependent_masked(x, _t(key), x, _t(key))
    for r in np.nonzero(key == 0)[0]:
        cand = [(d2[r, j], j) for j in range(len(pts)) if key[j] > key[r]]
        assert par[r] == min(cand)[1]
    assert (par[key == 1] == -1).all()


def test_fewer_than_k_columns_are_empty_slots():
    x = _t(uniform_points(16, 3, seed=0))
    y = _t(uniform_points(5, 3, seed=1))
    cnt, tv, ti = ops.fused_sweep(x, y, 10.0)
    assert (cnt == 5).all()
    assert (ti[:, 5:] == -1).all() and torch.isinf(tv[:, 5:]).all()
    assert sorted(ti[0, :5].tolist()) == list(range(5))


def test_plain_versions_match_direct_float64_search():
    pts = uniform_points(300, 4, seed=5)
    x = _t(pts)
    cnt, _, _ = sweep.fused_count_topk_plain(x, x, f32_d2cut(0.2))
    d2 = pair_d2(pts, pts)
    band = near_threshold_rows(pts, pts, f32_d2cut(0.2), 1e-5)
    np.testing.assert_array_equal(cnt.numpy()[~band],
                                  (d2 < f32_d2cut(0.2)).sum(1)[~band])
    key = np.random.default_rng(2).permutation(300).astype(np.float32)
    best, arg = sweep.masked_nn_plain(x, _t(key), x, _t(key))
    masked = np.where(key[None, :] > key[:, None], d2, np.inf)
    want = np.where(np.isinf(masked.min(1)), -1, masked.argmin(1))
    np.testing.assert_array_equal(arg.numpy(), want)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros((8, 3))
    with pytest.raises(TypeError):
        ops.fused_sweep(x.double(), x.double(), 1.0)
    with pytest.raises(ValueError):
        ops.fused_sweep(x, torch.zeros((8, 2)), 1.0)
    with pytest.raises(ValueError):
        ops.fused_sweep(torch.zeros((3, 8)).t(), x, 1.0)
    with pytest.raises(ValueError):
        ops.dependent_masked(x, torch.zeros(7), x, torch.zeros(8))
    with pytest.raises(ValueError):
        ops.fused_sweep(x, x, 1.0, nn_sel=torch.ones(8))      # f32 gate
    with pytest.raises(TypeError):
        ops.dependent_prefix(x.double())
    # the gated sweep and the gated rho_delta run on CPU tensors
    pts = _t(uniform_points(8, 3, seed=0))
    sel = torch.tensor([1, 0, 1, 1, 0, 0, 1, 0], dtype=torch.bool)
    cnt, tv, ti = ops.fused_sweep(pts, pts, 0.5, nn_sel=sel)
    assert (ti[:, 4:] == -1).all() and torch.isinf(tv[:, 4:]).all()
    assert set(ti[0, :4].tolist()) == {0, 2, 3, 6}
    slots = torch.nonzero(sel).flatten()
    rho = CudaBackend().rho_delta(pts[slots].contiguous(), pts, 0.5,
                                  y_sel_slots=slots)[0]
    assert torch.equal(rho, cnt[slots])


def test_masked_nn_gets_only_the_unresolved_rows(monkeypatch):
    """No padding: the fallback pass is launched on exactly the rows that
    the kept-k left unresolved and the caller reads."""
    pts = uniform_points(1000, 3, seed=3)
    dc = clear_dcut(pts, target_rho=20)
    mask = np.random.default_rng(1).uniform(size=1000) < 0.3
    given = []
    launch = ops.dependent_masked

    def recording(xq, xk, y, yk, **kw):
        given.append(xq.shape[0])
        return launch(xq, xk, y, yk, **kw)

    monkeypatch.setattr(ops, "dependent_masked", recording)
    x = _t(pts)
    rho, rho_key, _, _ = CudaBackend().rho_delta(
        x, x, dc, fallback_interest=lambda rk: _t(mask))
    _, topv, topi = ops.fused_sweep(x, x, dc)
    kept_denser = (rho_key[topi.long()] > rho_key[:, None]).any(1).numpy()
    want = int((~kept_denser & mask).sum())
    assert given == [want] and want > 1


def test_cpu_tensors_never_build_or_count(monkeypatch):
    def refuse():
        raise AssertionError("nvcc must not run for CPU tensors")
    monkeypatch.setattr(build, "build", refuse)
    monkeypatch.setattr(build, "load_library", refuse)
    ops.reset_launch_counts()
    x = _t(uniform_points(100, 3, seed=0))
    CudaBackend().rho_delta(x, x, 0.1)
    CudaBackend().rho_delta(x, x, 0.1, layout="block-sparse")
    slots = torch.arange(0, 100, 3)
    for layout in ("dense", "block-sparse"):
        for precision in ("f32", "bf16"):
            CudaBackend().rho_delta(x[slots].contiguous(), x, 0.1,
                                    y_sel_slots=slots, layout=layout,
                                    precision=precision)
            CudaBackend().rho_delta(x, x, 0.1, layout=layout,
                                    precision=precision)
        st = torch.zeros((100, 1), dtype=torch.int32)
        CudaBackend().range_count_halo(x, x, st, st + 100, 0.1,
                                       span_cap=100, layout=layout)
        CudaBackend().denser_nn_halo(x, torch.rand(100), x, torch.rand(100),
                                     st, st + 100, 0.1, span_cap=100,
                                     layout=layout)
    CudaBackend().prefix_nn(x)
    assert ops.launch_counts() == {
        "fused_count_topk": 0, "worklist_count_topk": 0,
        "fused_count_topk_sel": 0, "worklist_count_topk_sel": 0,
        "fused_count_topk_bf16": 0, "worklist_count_topk_bf16": 0,
        "fused_count_topk_bf16_sel": 0, "worklist_count_topk_bf16_sel": 0,
        "masked_nn": 0, "range_count": 0, "range_count_signed": 0,
        "gather_masked_nn": 0, "prefix_nn": 0, "worklist_range_count": 0,
        "worklist_masked_nn": 0, "worklist_range_count_signed": 0,
        "halo_range_count": 0, "halo_masked_nn": 0,
        "worklist_halo_range_count": 0, "worklist_halo_masked_nn": 0}


def _prefix_cases():
    """Unit-scale rows in a random order; with equal points (row 0 among
    them) and the lattice of exact distance ties."""
    unit = uniform_points(700, 3, seed=13)
    dup = uniform_points(300, 2, seed=14)
    dup[[0, 7, 40, 41, 299]] = dup[3]
    g = np.stack(np.meshgrid(np.arange(20), np.arange(20)), -1)
    lat = g.reshape(-1, 2).astype(np.float32)
    lat = lat[np.random.default_rng(0).permutation(len(lat))]
    return {"unit": unit, "equal points": dup, "lattice": lat}


@pytest.mark.parametrize("case", ["unit", "equal points", "lattice"])
def test_prefix_nn_matches_pallas(case):
    pts = _prefix_cases()[case]
    jd, jp = (np.asarray(a) for a in jops.dependent_prefix(
        jnp.asarray(pts), interpret=True))
    td, tp = (a.numpy() for a in prefix_min_dist(_t(pts)))
    assert tp[0] == -1 and np.isinf(td[0])
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_allclose(td, jd, rtol=1e-6)
    # the lowest index wins among equal distances, as a float64 search
    d2 = pair_d2(pts, pts)
    d2[np.triu_indices(len(pts))] = np.inf
    want = d2.argmin(1)
    np.testing.assert_array_equal(tp[1:], want[1:])
    if case != "unit":
        assert (td == 0).sum() >= 4 or case == "lattice"


def test_prefix_nn_matches_jnp_on_realistic_data():
    """Domain 1e5, sorted by descending density: the port against the
    reference's jnp route (K2's formulation with key -row_index)."""
    pts, _ = real_proxy("airline", 2048, seed=2)
    dc = pick_dcut(pts)
    rho = ops.fused_sweep(_t(pts), _t(pts), dc)[0].numpy()
    key = rho + np.asarray(density_jitter(2048))
    pts = np.ascontiguousarray(pts[np.argsort(-key, kind="stable")])
    jd, jp = (np.asarray(a) for a in jget_backend("jnp").prefix_nn(
        jnp.asarray(pts)))
    td, tp = (a.numpy() for a in get_backend("cuda").prefix_nn(_t(pts)))
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_allclose(td, jd, rtol=1e-6)
    # and K2's plain version with key -position
    pos = -np.arange(2048, dtype=np.float32)
    kd, kp = masked_min_dist(_t(pts), _t(pos), _t(pts), _t(pos))
    assert torch.equal(kd, torch.from_numpy(td))
    assert torch.equal(kp, torch.from_numpy(tp))
