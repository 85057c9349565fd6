"""S-Approx-DPC on the port held against the JAX package: the coarse grid
and its representatives, the gated kept-k sweeps (K1/K3's plain versions),
the gated worklist and its k-NN radius, ``run_sapproxdpc`` in both layouts,
and the paper's accuracy checks (Table 5) run on the port.

On the CPU the wrappers run the kernels' plain versions (the gated CUDA
kernels are held against those on the card by chip_smoke.py).  Inputs are
built once with numpy and handed to both packages.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core.grid import build_grid as jbuild_grid
from repro.core.sapproxdpc import coarse_cell_key as jcoarse_cell_key
from repro.core.sapproxdpc import run_sapproxdpc as jrun_sapproxdpc
from repro.engine import ExecSpec as JExecSpec
from repro.kernels import blocksparse as jbs
from repro.kernels import ops as jops

from repro_torch import DPCEngine, ExecSpec
from repro_torch.core.dpc_api import DPCConfig, cluster
from repro_torch.core.grid import build_grid
from repro_torch.core.labels import assign_labels
from repro_torch.core.metrics import rand_index
from repro_torch.core.sapproxdpc import (coarse_cell_key, representatives,
                                         run_sapproxdpc)
from repro_torch.data.points import gaussian_mixture
from repro_torch.kernels import blocksparse, ops, sweep
from repro_torch.kernels.backend import CudaBackend

from _torch_ref import (clear_dcut, f32_d2cut, near_threshold_rows, pair_d2,
                        uniform_points)

GATES = ["ones", "zeros", "random", "few"]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _gate(kind: str, m: int, seed: int = 0) -> np.ndarray:
    """(m,) bool: every column, none, about 40 % of them, or 5 of them
    (fewer than the kept 8 in all of y)."""
    rng = np.random.default_rng(seed)
    if kind == "ones":
        return np.ones(m, bool)
    if kind == "zeros":
        return np.zeros(m, bool)
    if kind == "random":
        return rng.uniform(size=m) < 0.4
    sel = np.zeros(m, bool)
    sel[rng.permutation(m)[:5]] = True
    return sel


def _ref_reps(points_sorted, d_cut, eps):
    """The reference's representative selection
    (``repro/core/sapproxdpc.py:66-78``) on its grid-sorted points."""
    n = points_sorted.shape[0]
    ck = jcoarse_cell_key(points_sorted, d_cut, eps)
    order_c = jnp.argsort(ck, stable=True)
    cks = ck[order_c]
    is_first = jnp.concatenate([jnp.ones((1,), bool), cks[1:] != cks[:-1]])
    seg = (jnp.cumsum(is_first) - 1).astype(jnp.int32)
    num_reps = int(jnp.sum(is_first))
    per_seg = jax.ops.segment_min(
        jnp.where(is_first, order_c, n).astype(jnp.int32), seg,
        num_segments=n)
    return np.asarray(ck), np.asarray(per_seg[:num_reps])


@pytest.mark.parametrize("eps", [0.2, 0.8, 1.0])
@pytest.mark.parametrize("d", [2, 3])
def test_coarse_keys_and_representatives_match_reference(d, eps):
    pts, _ = gaussian_mixture(2000, k=6, d=d, seed=d)
    dc = 2500.0
    jgrid = jbuild_grid(jnp.asarray(pts), dc)
    want_key, want_reps = _ref_reps(jgrid.points, dc, eps)
    grid = build_grid(_t(pts), dc)
    got_key = coarse_cell_key(grid.points, dc, eps)
    assert got_key.dtype == torch.int64
    np.testing.assert_array_equal(got_key.numpy(), want_key)
    reps, seg = representatives(grid, dc, eps)
    assert reps.dtype == torch.int64
    np.testing.assert_array_equal(reps.numpy(), want_reps)
    # every slot's cell names a representative of the same coarse cell
    assert torch.equal(got_key[reps[seg]], got_key)
    assert 1 < reps.numel() < len(pts)


def _finite_slots(v, i):
    """Per row, the set of kept indices whose value is finite."""
    return [set(i[r][np.isfinite(v[r])].tolist()) for r in range(len(v))]


def _assert_gated_like_reference(x, y, sel, dc, got, want):
    """Count equal off the threshold band; the finite kept slots name the
    same columns wherever the 8th and 9th selected float64 distances are
    apart beyond either form's error (JAX's expanded form carries ~1e-7
    relative error, and may carry gated or padding columns in +inf
    slots where fewer than 8 columns are selected)."""
    tc, tv, ti = (a.numpy() for a in got)
    jc, jv, ji = (np.asarray(a) for a in want)
    thr = f32_d2cut(dc)
    band = near_threshold_rows(x, y, thr, 1e-5 * thr)
    assert band.sum() <= 8
    np.testing.assert_array_equal(tc[~band], jc[~band])
    assert np.all(ti[~np.isfinite(tv)] == -1)
    assert set(ti[np.isfinite(tv)].tolist()) <= set(np.nonzero(sel)[0])
    s = np.sort(pair_d2(x, y)[:, sel], axis=1)
    if s.shape[1] > 8:
        tie = np.abs(s[:, 8] - s[:, 7]) <= 1e-4 * s[:, 8]
    else:
        tie = np.zeros(len(x), bool)
    assert tie.sum() <= 8
    want_sets, got_sets = _finite_slots(jv, ji), _finite_slots(tv, ti)
    for r in np.nonzero(~tie)[0]:
        assert got_sets[r] == want_sets[r], r
        assert len(got_sets[r]) == min(8, int(sel.sum()))


@pytest.mark.parametrize("gate", GATES)
def test_gated_sweep_matches_pallas(gate):
    pts = uniform_points(700, 3, seed=3)
    dc = clear_dcut(pts, target_rho=20)
    sel = _gate(gate, len(pts))
    want = jops.fused_sweep(jnp.asarray(pts), jnp.asarray(pts), dc,
                            nn_sel=jnp.asarray(sel), interpret=True)
    got = ops.fused_sweep(_t(pts), _t(pts), dc, nn_sel=_t(sel))
    _assert_gated_like_reference(pts, pts, sel, dc, got, want)
    if gate == "ones":          # the all-ones gate is the ungated sweep
        for g, w in zip(got, ops.fused_sweep(_t(pts), _t(pts), dc)):
            assert torch.equal(g, w)
    # a uint8 gate is the same gate
    for g, w in zip(got, ops.fused_sweep(_t(pts), _t(pts), dc,
                                         nn_sel=_t(sel.astype(np.uint8)))):
        assert torch.equal(g, w)


def _sorted(pts, dc):
    return build_grid(_t(pts), dc).points.numpy()


def _sel_counts(sel):
    nbc = -(-len(sel) // blocksparse.BLOCK_M)
    return np.bincount(np.nonzero(sel)[0] // blocksparse.BLOCK_M,
                       minlength=nbc)


@pytest.mark.parametrize("gate", GATES)
def test_gated_worklist_sweep_matches_pallas(gate):
    """The gated worklist sweep on the reference's gated worklist, through
    the port's plain K3 and the reference's Pallas worklist sweep; and the
    port's own gated worklist gives the same answer."""
    from repro_torch import carry
    pts = uniform_points(1536, 2, seed=9)
    dc = clear_dcut(pts, target_rho=20)
    gp = _sorted(pts, dc)
    sel = _gate(gate, len(gp), seed=1)
    counts = _sel_counts(sel)
    jwl = jbs.build_flat_worklist(gp, gp, dc, block_n=256, block_m=512,
                                  count=True, nn="topk", k=8,
                                  nn_col_counts=counts)
    want = jops.fused_sweep(jnp.asarray(gp), jnp.asarray(gp), dc,
                            nn_sel=jnp.asarray(sel), block_n=256,
                            block_m=512, interpret=True, worklist=jwl)
    own = blocksparse.build_flat_worklist(_t(gp), _t(gp), dc,
                                          nn_col_counts=_t(counts))
    carried = carry.flat_worklist(jwl.meta, jwl.lb, jwl.n_kept, jwl.n_total)
    for name in ("row_ptr", "col_tile", "in_cut", "lb"):
        assert torch.equal(getattr(own, name), getattr(carried, name)), name
    got = ops.fused_sweep(_t(gp), _t(gp), dc, nn_sel=_t(sel), worklist=own)
    _assert_gated_like_reference(gp, gp, sel, dc, got, want)


@pytest.mark.parametrize("gate", GATES)
def test_gated_worklist_keeps_every_needed_pair(gate):
    """With the selected columns' counts, the worklist holds every pair the
    gated kept-k needs: the gated worklist sweep is the gated dense sweep
    bit for bit — on the S-Approx shape (a subset of the rows against all
    of them) and on the lattice of exact ties."""
    pts, _ = gaussian_mixture(4096, k=5, d=2, seed=4)
    dc = 1500.0
    gp = _t(_sorted(pts, dc))
    rows = torch.from_numpy(np.sort(np.random.default_rng(2).permutation(
        len(gp))[:1500]))
    lat = np.stack(np.meshgrid(np.arange(40), np.arange(40)), -1)
    lat = _t(lat.reshape(-1, 2).astype(np.float32))
    for x, y, d_cut in ((gp[rows].contiguous(), gp, dc), (lat, lat, 2.5)):
        sel = _t(_gate(gate, y.shape[0], seed=5))
        wl = blocksparse.build_flat_worklist(
            x, y, d_cut, nn_col_counts=_t(_sel_counts(sel.numpy())))
        dense = ops.fused_sweep(x, y, d_cut, nn_sel=sel)
        got = ops.fused_sweep(x, y, d_cut, nn_sel=sel, worklist=wl)
        for g, w in zip(got, dense):
            assert torch.equal(g, w)
        assert wl.n_kept <= wl.n_total


def test_knn_radius_matches_reference():
    """``knn_radius`` equals the reference's ``_knn_radius`` on random
    bounds and counts, totals below k included, through the walk and
    through the no-sort shortcut; where it takes the shortcut (short
    tiles holding fewer than k together, as all of y does) the walk gives
    the same radius."""
    rng = np.random.default_rng(0)
    full = np.full(40, blocksparse.BLOCK_M)
    full[-1] = 3
    for nbc, counts in ((1, 9), (7, 5), (40, 3), (40, 600), (40, full),
                        (5, 1)):
        ub = rng.uniform(0, 10, (64, nbc)).astype(np.float32)
        ub[:, ::3] = np.round(ub[:, ::3])             # equal bounds
        if np.isscalar(counts):
            counts = rng.integers(0, counts, nbc)
        want = jbs._knn_radius(ub, counts, 8)
        got = blocksparse.knn_radius(_t(ub), _t(counts), 8).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            blocksparse._knn_walk(_t(ub), _t(counts), 8).numpy(), want)
        if counts.sum() < 8:
            assert np.isinf(got).all()


def _gap_rows(pts, dc, eps):
    """Original rows the reference marks wrongly: where the last grid slot
    is a representative and the rep count is not a power of two, the
    reference's padded scatter (``sapproxdpc.py:116``) marks it a member
    of its own cell (parent itself, delta min(eps,1)*d_cut).  ROADMAP
    Queue C."""
    grid = build_grid(_t(pts), dc)
    reps, _ = representatives(grid, dc, eps)
    n, k = len(pts), reps.numel()
    if (reps == n - 1).any() and k & (k - 1):
        return np.asarray([int(grid.order[n - 1])])
    return np.zeros(0, np.int64)


def _assert_same_sapprox(port, ref, pts, dc, eps):
    """rho and rho_key equal (d_cut^2 clear of every pair), parent equal,
    delta to f32 rounding, members' delta exactly min(eps,1)*d_cut — off
    the reference's gap row, where the port gives the representative's
    answer."""
    gap = _gap_rows(pts, dc, eps)
    n = len(pts)
    ok = np.ones(n, bool)
    ok[gap] = False
    rp, rd = np.asarray(ref.parent), np.asarray(ref.delta)
    np.testing.assert_array_equal(port.rho.numpy(), np.asarray(ref.rho))
    np.testing.assert_array_equal(port.rho_key.numpy(),
                                  np.asarray(ref.rho_key))
    np.testing.assert_array_equal(port.parent.numpy()[ok], rp[ok])
    np.testing.assert_allclose(port.delta.numpy()[ok], rd[ok], rtol=1e-6)
    assert (rp[gap] == gap).all() and (port.parent.numpy()[gap] != gap).all()
    member = np.float32(min(eps, 1.0) * dc)
    grid = build_grid(_t(pts), dc)
    reps, _ = representatives(grid, dc, eps)
    is_rep = np.zeros(n, bool)
    is_rep[grid.order[reps].numpy()] = True
    assert (port.delta.numpy()[~is_rep] == member).all()
    assert (port.parent.numpy()[~is_rep] >= 0).all()


@pytest.mark.parametrize("eps", [0.2, 0.8])
def test_sapproxdpc_matches_pallas_interpret_on_unit_data(monkeypatch, eps):
    # the reference's plan-time analyzer raises on the installed jax for
    # every pallas plan (ROADMAP "Reference gaps"); suspend it
    monkeypatch.setenv("REPRO_ANALYSIS", "suspend")
    pts = uniform_points(900, 3, seed=21)
    dc = clear_dcut(pts, target_rho=25)
    ref = jrun_sapproxdpc(pts, dc, eps=eps, exec_spec=JExecSpec(
        backend="pallas-interpret"))
    fits = [run_sapproxdpc(_t(pts), dc, eps=eps, exec_spec=ExecSpec(
        layout=layout)) for layout in ("dense", "block-sparse")]
    _assert_same_sapprox(fits[0], ref, pts, dc, eps)
    for a, b in zip(*fits):           # block-sparse equals dense
        assert torch.equal(a, b)


@pytest.mark.parametrize("eps", [0.2, 0.8])
def test_sapproxdpc_matches_jnp_on_realistic_data(eps):
    """Domain 1e5 (the expanded form miscounts there): the port against
    the reference's direct-difference engine branch (jnp, block-sparse)
    and, at eps 0.8, its stencil branch (jnp, dense)."""
    pts, _ = gaussian_mixture(2000, k=8, seed=6)
    dc = clear_dcut(pts, target_rho=15)
    ref = jrun_sapproxdpc(pts, dc, eps=eps, exec_spec=JExecSpec(
        backend="jnp", layout="block-sparse"))
    sparse = DPCEngine(dc, algorithm="sapproxdpc", eps=eps, device="cpu",
                       exec_spec=ExecSpec(layout="block-sparse")).fit(pts)
    dense = DPCEngine(dc, algorithm="sapproxdpc", eps=eps,
                      device="cpu").fit(pts)
    _assert_same_sapprox(sparse.result, ref, pts, dc, eps)
    for a, b in zip(sparse.result, dense.result):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(sparse.labels_, dense.labels_)
    if eps == 0.8:
        # the stencil branch marks the gap row's rep as no candidate too,
        # so it is held only where the gap does not arise
        assert _gap_rows(pts, dc, eps).size == 0
        stencil = jrun_sapproxdpc(pts, dc, eps=eps, exec_spec=JExecSpec(
            backend="jnp"))
        _assert_same_sapprox(dense.result, stencil, pts, dc, eps)


def test_cluster_and_config_run_sapproxdpc():
    pts, _ = gaussian_mixture(1200, k=4, seed=3)
    cfg = DPCConfig(d_cut=2500.0, rho_min=5, algorithm="sapproxdpc",
                    eps=0.5)
    cl, res = cluster(pts, cfg, device="cpu")
    want = run_sapproxdpc(_t(pts), 2500.0, eps=0.5)
    for a, b in zip(res, want):
        assert torch.equal(a, b)
    assert int(cl.num_clusters) >= 1
    for bad in (0.0, -0.5):
        with pytest.raises(ValueError, match="eps"):
            DPCConfig(d_cut=1.0, algorithm="sapproxdpc", eps=bad)
        with pytest.raises(ValueError, match="eps"):
            run_sapproxdpc(_t(pts), 2500.0, eps=bad)
    DPCConfig(d_cut=1.0, algorithm="approxdpc", eps=0.0)   # eps unused


# --- the paper's accuracy checks (tests/test_dpc_core.py:100-130), on the
#     port: S-Approx-DPC's labels against the port's own Ex-DPC (Table 5)
def _labels(res, rho_min=5.0, delta_min=5000.0):
    return assign_labels(res, rho_min, delta_min).labels


def _exdpc(pts, d_cut):
    return DPCEngine(d_cut, algorithm="exdpc", device="cpu").fit(pts).result


@pytest.mark.parametrize("eps", [0.2, 0.5, 1.0])
def test_reasonable_accuracy(eps):
    pts, _ = gaussian_mixture(2000, k=8, d=2, overlap=0.02, seed=6)
    ex = _exdpc(pts, 2500.0)
    sa = run_sapproxdpc(_t(pts), 2500.0, eps=eps)
    assert rand_index(_labels(sa), _labels(ex)) > 0.9


def test_smaller_eps_more_accurate_or_equal():
    pts, _ = gaussian_mixture(2000, k=8, d=2, overlap=0.02, seed=7)
    le = _labels(_exdpc(pts, 2500.0))
    ris = [rand_index(_labels(run_sapproxdpc(_t(pts), 2500.0, eps=eps)), le)
           for eps in (0.2, 1.0)]
    assert ris[0] >= ris[1] - 0.02     # paper Table 5 trend (with slack)


def test_members_never_centers():
    pts, _ = gaussian_mixture(1500, k=6, d=2, overlap=0.02, seed=8)
    sa = run_sapproxdpc(_t(pts), 2500.0, eps=1.0)
    cl = assign_labels(sa, 5.0, 5000.0)
    # centers must be representatives: their delta came from the sweep
    assert (sa.delta[cl.centers] >= 5000.0).all()
    assert int(cl.num_clusters) >= 1


def test_rand_index_matches_reference():
    from repro.core.metrics import rand_index as jrand_index
    rng = np.random.default_rng(3)
    for n, ka, kb in ((1, 1, 1), (50, 3, 4), (2000, 12, 9)):
        a = rng.integers(-1, ka, n)
        b = rng.integers(-1, kb, n)
        assert rand_index(a, b) == jrand_index(a, b)
        assert rand_index(_t(a), b) == jrand_index(a, b)
    assert rand_index(a, a) == 1.0


def test_rho_delta_gate_reaches_the_backend_in_both_layouts(monkeypatch):
    """The plan forwards ``y_sel_slots``; the gated sweep gets nn_sel, the
    block-sparse worklist the selected columns' counts, and the fallback
    (K2, or K9 on a best-1 ring under the block-sparse layout) the keys
    with -inf at every other column."""
    pts, _ = gaussian_mixture(1500, k=4, seed=2)
    seen = []
    sweep_fn, nn_fn = ops.fused_sweep, ops.dependent_masked

    def rec_sweep(x, y, d_cut, *, nn_sel=None, worklist=None, live=None,
                  precision="f32"):
        assert precision == "f32"
        seen.append(("sweep", nn_sel is not None, worklist is not None))
        return sweep_fn(x, y, d_cut, nn_sel=nn_sel, worklist=worklist)

    def rec_nn(x, xk, y, yk, worklist=None):
        seen.append(("nn", int(torch.isinf(yk).sum()), y.shape[0],
                     worklist is not None))
        return nn_fn(x, xk, y, yk, worklist=worklist)

    monkeypatch.setattr(ops, "fused_sweep", rec_sweep)
    monkeypatch.setattr(ops, "dependent_masked", rec_nn)
    for layout in ("dense", "block-sparse"):
        seen.clear()
        res = run_sapproxdpc(_t(pts), 2500.0, eps=0.8,
                             exec_spec=ExecSpec(layout=layout))
        grid = build_grid(_t(pts), 2500.0)
        reps, _ = representatives(grid, 2500.0, 0.8)
        assert seen[0] == ("sweep", True, layout == "block-sparse")
        # the fallback sweeps all of y, or its ring of all of y; the
        # members' keys are -inf
        assert [s for s in seen[1:]] == [("nn", len(pts) - reps.numel(),
                                          len(pts),
                                          layout == "block-sparse")]
        assert torch.isinf(res.delta).sum() == 1        # the global peak


def test_gated_backend_on_cpu_tensors():
    """``rho_delta(y_sel_slots=...)`` on CPU tensors: rho over all of y,
    Def. 2 among the selected rows only."""
    pts = uniform_points(600, 2, seed=1)
    x = _t(pts)
    slots = torch.from_numpy(np.sort(np.random.default_rng(0).permutation(
        600)[:150]))
    be = CudaBackend()
    rho, rho_key, delta, parent = be.rho_delta(
        x[slots].contiguous(), x, 0.08, y_sel_slots=slots)
    np.testing.assert_array_equal(
        rho.numpy(), (pair_d2(pts[slots.numpy()], pts)
                      < f32_d2cut(0.08)).sum(1))
    key = torch.full((600,), float("-inf"))
    key[slots] = rho_key
    d, p = ops.dependent_masked(x[slots].contiguous(), rho_key, x, key)
    assert torch.equal(parent, p) and torch.equal(delta, d)
    with pytest.raises(ValueError, match="y_sel_slots"):
        be.rho_delta(x[:10].contiguous(), x, 0.08, y_sel_slots=slots)
    with pytest.raises(ValueError, match="nn_sel"):
        ops.fused_sweep(x, x, 0.08, nn_sel=torch.ones(10, dtype=torch.bool))
    with pytest.raises(ValueError, match="nn_sel"):
        ops.fused_sweep(x, x, 0.08, nn_sel=torch.ones(600))
