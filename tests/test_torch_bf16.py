"""The bf16 precision path of the port held against the JAX package: the
plain versions of K12/K13 (the bf16 fused count + kept-8, dense and on a
worklist) against the reference's Pallas sweep in interpret mode,
``CudaBackend.rho_delta(precision="bf16")`` and its re-evaluation of the
kept candidates, the four drivers under ``ExecSpec(precision="bf16")``, and
K14's plain version (the signed range count on a worklist) through
``range_count_delta(layout="block-sparse")``.

On the CPU the wrappers run the kernels' plain versions (chip_smoke.py
holds the CUDA kernels against those on the card).  Inputs are made once
with numpy and handed to both packages.  On lattice data (integers times a
power of two) every norm, product and partial sum of the bf16 expanded form
is exact, so the comparisons there are bit for bit; off the lattice XLA's
bf16 dot may sum in another order, and the stated tolerance is
``d * 2^-20 * (|x|^2 + |y|^2)`` per pair.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.dpc_types import density_jitter as jdensity_jitter
from repro.engine import DPCEngine as JEngine
from repro.engine import ExecSpec as JExecSpec
from repro.kernels import blocksparse as jbs
from repro.kernels import get_backend as jget_backend
from repro.kernels import ops as jops

from repro_torch import DPCEngine, ExecSpec, carry
from repro_torch.core.grid import build_grid
from repro_torch.core.tuning import pick_dcut
from repro_torch.data.points import real_proxy
from repro_torch.engine import planner
from repro_torch.kernels import blocksparse, ops, sweep
from repro_torch.kernels.backend import CudaBackend, _fused_resolve

from _torch_ref import (clear_dcut, f32_d2cut, f32_ulp, near_threshold_rows,
                        uniform_points)

# tests/test_sweep_fused.py's seed matrix: (n, d, scale exponent, seed)
SEED_MATRIX = [(17, 2, 0, 0), (96, 3, 3, 1), (64, 4, 6, 2), (2, 2, 0, 3),
               (33, 2, 1, 4)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _lattice(n, d, sexp, seed, high=13):
    """The reference's ``_lattice`` (tests/test_sweep_fused.py): integers
    in [0, high) times 2^sexp, and a d_cut whose square is a half integer
    times 4^sexp, so it never ties an integer d2."""
    rng = np.random.default_rng(seed)
    pts = rng.integers(0, high, (n, d)).astype(np.float32) * (2.0 ** sexp)
    d2cut = (float(rng.integers(1, 3 * high ** 2)) + 0.5) \
        * (2.0 ** (2 * sexp))
    return pts, float(np.sqrt(d2cut))


def _gate(kind, m, seed=0):
    if kind is None:
        return None
    return np.random.default_rng(seed).uniform(size=m) < 0.4


def _ref_sweep(x, y, dc, sel=None, **kw):
    return [np.asarray(a) for a in jops.fused_sweep(
        jnp.asarray(x), jnp.asarray(y), dc, precision="bf16", interpret=True,
        nn_sel=None if sel is None else jnp.asarray(sel), **kw)]


def _assert_same_kept(got, want, m):
    """Count, topv and topi bit for bit, except the slots past the columns
    that may enter: the port writes (inf, -1) there, the reference a
    padding or gated column (ROADMAP "Reference gaps")."""
    tc, tv, ti = (a.numpy() for a in got)
    jc, jv, ji = want
    np.testing.assert_array_equal(tc, jc)
    real = ti >= 0
    np.testing.assert_array_equal(ti[real], ji[real])
    np.testing.assert_array_equal(tv[real], jv[real])
    assert np.all(np.isinf(tv[~real]))
    assert np.all(np.isinf(jv[~real]) | (ji[~real] >= m))


@pytest.mark.parametrize("gate", [None, "random"])
@pytest.mark.parametrize("n,d,sexp,seed", SEED_MATRIX)
def test_plain_bf16_sweep_matches_reference_on_lattice(n, d, sexp, seed,
                                                       gate):
    pts, dc = _lattice(n, d, sexp, seed)
    sel = _gate(gate, n, seed)
    got = ops.fused_sweep(_t(pts), _t(pts), dc, precision="bf16",
                          nn_sel=None if sel is None else _t(sel))
    _assert_same_kept(got, _ref_sweep(pts, pts, dc, sel), n)


@pytest.mark.parametrize("gate", [None, "random"])
def test_plain_bf16_sweep_matches_reference_on_ints_256(gate):
    """Integers in [0, 256)^3: the Airline-sized domain that bf16 still
    holds exactly; bf16 and f32 agree bit for bit there too."""
    pts, _ = _lattice(128, 3, 0, 5, high=256)
    dc = float(np.sqrt(4624.5))
    sel = _gate(gate, 128, 5)
    tsel = None if sel is None else _t(sel)
    got = ops.fused_sweep(_t(pts), _t(pts), dc, precision="bf16",
                          nn_sel=tsel)
    _assert_same_kept(got, _ref_sweep(pts, pts, dc, sel), 128)
    for g, w in zip(got, ops.fused_sweep(_t(pts), _t(pts), dc, nn_sel=tsel)):
        assert torch.equal(g, w)
    assert got[0].mean() > 5


def _tau(x2, y2, d):
    """The stated per-pair tolerance of a bf16 d2 between two sums of the
    same exact products: d * 2^-20 * (|x|^2 + |y|^2)."""
    return d * 2.0 ** -20 * (x2 + y2)


@pytest.mark.parametrize("gate", [None, "random"])
@pytest.mark.parametrize("d", [2, 3])
def test_plain_bf16_sweep_on_unit_data_within_tolerance(d, gate):
    """Off the lattice: the count equal on every row with no pair whose d2
    lies within the tolerance of d_cut^2; the kept d2 within the
    tolerance, and the kept indices equal wherever the 8th and 9th d2 are
    apart beyond twice the tolerance."""
    n = 128
    pts = uniform_points(n, d, seed=d)
    dc = float(np.sqrt(0.02))
    sel = _gate(gate, n, d)
    x = _t(pts)
    tc, tv, ti = (a.numpy() for a in ops.fused_sweep(
        x, x, dc, precision="bf16", nn_sel=None if sel is None else _t(sel)))
    jc, jv, ji = _ref_sweep(pts, pts, dc, sel)
    x2 = sweep.sq_norms(x).numpy()
    d2 = sweep.expanded_d2_bf16(x, x).numpy()
    tau = _tau(x2[:, None], x2[None, :], d)
    band = (np.abs(d2 - f32_d2cut(dc)) <= tau).any(1)
    assert band.sum() <= 4
    np.testing.assert_array_equal(tc[~band], jc[~band])
    cols = np.arange(n) if sel is None else np.nonzero(sel)[0]
    s = np.sort(d2[:, cols], axis=1)
    tie = np.abs(s[:, 8] - s[:, 7]) <= 2 * tau.max(1)
    assert tie.sum() <= 4
    np.testing.assert_array_equal(ti[~tie], ji[~tie])
    tol = _tau(x2[:, None], x2[np.maximum(ti, 0)], d)
    assert np.all(np.abs(tv - jv)[~tie] <= tol[~tie])


def test_plain_worklist_bf16_sweep_on_lattice():
    """On the lattice the worklist's skips are exact: the plain worklist
    sweep equals the dense plain sweep on the port's own worklist, and the
    reference's worklist sweep on the reference's worklist, gated or not."""
    rng = np.random.default_rng(3)
    raw = rng.integers(0, 400, (1100, 2)).astype(np.float32) * 2.0
    dc = float(np.sqrt(20.5)) * 2.0
    gp = build_grid(_t(raw), dc).points.numpy()
    for sel in (None, _gate("random", len(gp), 1)):
        counts = None if sel is None else np.bincount(
            np.nonzero(sel)[0] // 512, minlength=-(-len(gp) // 512))
        tsel = None if sel is None else _t(sel)
        wl = blocksparse.build_flat_worklist(
            _t(gp), _t(gp), dc,
            nn_col_counts=None if counts is None else _t(counts))
        got = ops.fused_sweep(_t(gp), _t(gp), dc, precision="bf16",
                              worklist=wl, nn_sel=tsel)
        dense = ops.fused_sweep(_t(gp), _t(gp), dc, precision="bf16",
                                nn_sel=tsel)
        for g, w in zip(got, dense):
            assert torch.equal(g, w)
        jwl = jbs.build_flat_worklist(gp, gp, dc, block_n=256, block_m=512,
                                      count=True, nn="topk", k=8,
                                      nn_col_counts=counts)
        want = _ref_sweep(gp, gp, dc, sel, block_n=256, block_m=512,
                          worklist=jwl)
        _assert_same_kept(got, want, len(gp))
        assert bool((wl.lb > 0).any())          # entries the walk may skip


def test_plain_worklist_bf16_liveness_is_the_references():
    """A bf16 d2 may lie below its pair's lb, so which entries are NN-live
    decides the kept 8 (the reference's ``lb <= max(topv)`` over the row
    tile).  On the reference's worklist of lattice data with every entry
    but each row tile's first given an lb far above any d2 (and no
    in_cut), those entries never enter: the plain worklist sweep equals
    the reference's on that worklist bit for bit, and differs from a walk
    that inserts from every entry (lb -inf), which is the dense sweep."""
    rng = np.random.default_rng(4)
    raw = rng.integers(0, 100, (1280, 2)).astype(np.float32)
    dc = float(np.sqrt(30.5))
    gp = build_grid(_t(raw), dc).points.numpy()
    jwl = jbs.build_flat_worklist(gp, gp, dc, block_n=256, block_m=512,
                                  count=True, nn="topk", k=8)
    meta, lb = np.asarray(jwl.meta).copy(), np.asarray(jwl.lb).copy()
    later = meta[2] == 0
    lb[later], meta[3, later] = 1e30, 0
    want = _ref_sweep(gp, gp, dc, block_n=256, block_m=512,
                      worklist=types.SimpleNamespace(meta=jnp.asarray(meta),
                                                     lb=jnp.asarray(lb)))
    wl = carry.flat_worklist(meta, lb, jwl.n_kept, jwl.n_total)
    x = _t(gp)
    got = ops.fused_sweep(x, x, dc, precision="bf16", worklist=wl)
    _assert_same_kept(got, want, len(gp))
    every = ops.fused_sweep(x, x, dc, precision="bf16",
                            worklist=dataclasses.replace(
                                wl, lb=torch.full_like(wl.lb,
                                                       float("-inf"))))
    assert not torch.equal(got[2], every[2])
    dense = ops.fused_sweep(x, x, dc, precision="bf16")
    for e, w in zip(every[1:], dense[1:]):
        assert torch.equal(e, w)


def _blocksparse_lattice(n, d, sexp, seed):
    """tests/test_blocksparse.py's ``_lattice``: grid-sorted lattice data."""
    pts, dc = _lattice(n, d, sexp, seed)
    return build_grid(_t(pts), dc).points.numpy(), dc


@pytest.mark.parametrize("layout", ["dense", "block-sparse"])
@pytest.mark.parametrize("n,d,sexp,seed", SEED_MATRIX[:3])
def test_rho_delta_bf16_matches_pallas_interpret(n, d, sexp, seed, layout):
    pts, dc = _blocksparse_lattice(n, d, sexp, seed)
    jit_ = np.asarray(jdensity_jitter(n))
    got = CudaBackend().rho_delta(_t(pts), _t(pts), dc, jitter=_t(jit_),
                                  precision="bf16", layout=layout)
    want = jget_backend("pallas-interpret").rho_delta(
        jnp.asarray(pts), jnp.asarray(pts), dc, jitter=jnp.asarray(jit_),
        precision="bf16", layout=layout)
    for g, w, name in zip(got, want, ("rho", "rho_key", "delta", "parent")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), name)
    f32 = CudaBackend().rho_delta(_t(pts), _t(pts), dc, jitter=_t(jit_),
                                  layout=layout)
    for g, w in zip(got, f32):
        assert torch.equal(g, w)


def test_resolve_reevaluates_kept_candidates_in_direct_difference():
    """Unit-scale data where the bf16 order of the kept candidates is not
    the f32 order: the resolution picks each row's nearest strictly denser
    kept candidate by its direct-difference d2, as the reference's
    ``_fused_resolve`` does, not by the bf16 value."""
    pts = uniform_points(128, 2, seed=21)
    x = _t(pts)
    dc = float(np.sqrt(0.03))
    jit_ = _t(np.asarray(jdensity_jitter(128)))
    rho, topv, topi = ops.fused_sweep(x, x, dc, precision="bf16")
    rho_key = rho + jit_
    ti = topi.long()
    direct = sweep.direct_d2(x[:, None, :], x[ti])
    denser = rho_key[ti] > rho_key[:, None]
    by_direct = torch.where(denser, direct, float("inf")).argmin(1)
    by_bf16 = torch.where(denser, topv, float("inf")).argmin(1)
    resolved = denser.any(1)
    flips = resolved & (by_direct != by_bf16)
    assert int(flips.sum()) >= 3, "the data must reorder some candidates"
    _, _, delta, parent = CudaBackend().rho_delta(x, x, dc, jitter=jit_,
                                                  precision="bf16")
    rows = torch.nonzero(resolved).flatten()
    want = ti[rows, by_direct[rows]].to(torch.int32)
    assert torch.equal(parent[rows], want)
    assert torch.equal(delta[rows], torch.sqrt(
        direct[rows, by_direct[rows]]))
    d, p, _ = _fused_resolve(rho_key, rho_key, topv, topi, x, x)
    assert torch.equal(p[rows], want)
    assert not torch.equal(_fused_resolve(rho_key, rho_key, topv, topi)[1],
                           p)
    # the reference resolves the same way: its parents agree wherever its
    # kept candidates are the port's (XLA may sum the bf16 dot apart)
    _, jtv, jti = _ref_sweep(pts, pts, dc)
    jrk, _, jp = (np.asarray(a) for a in jget_backend(
        "pallas-interpret").rho_delta(jnp.asarray(pts), jnp.asarray(pts), dc,
                                      jitter=jnp.asarray(jit_.numpy()),
                                      precision="bf16")[1:])
    same = (jti == topi.numpy()).all(1) & (jrk == rho_key.numpy())
    assert same.mean() > 0.9
    np.testing.assert_array_equal(parent.numpy()[same], jp[same])


_DRIVERS = [("approxdpc", {}), ("exdpc", {}), ("scan", {}),
            ("sapproxdpc", {"eps": 0.8})]


@pytest.mark.parametrize("layout", ["dense", "block-sparse"])
@pytest.mark.parametrize("algo,kw", _DRIVERS)
def test_drivers_bf16_match_pallas_interpret_on_lattice(algo, kw, layout,
                                                        monkeypatch):
    # the reference's plan-time analyzer raises on the installed jax for
    # every pallas plan (ROADMAP "Reference gaps"); suspend it
    monkeypatch.setenv("REPRO_ANALYSIS", "suspend")
    pts, dc = _lattice(96, 3, 3, 1)
    ref = JEngine(dc, rho_min=3, algorithm=algo, exec_spec=JExecSpec(
        backend="pallas-interpret", precision="bf16", layout=layout),
        **kw).fit(pts)
    port = DPCEngine(dc, rho_min=3, algorithm=algo, device="cpu",
                     exec_spec=ExecSpec(precision="bf16", layout=layout),
                     **kw).fit(pts)
    np.testing.assert_array_equal(port.labels_, np.asarray(ref.labels_))
    for name in ("rho", "delta", "parent"):
        np.testing.assert_array_equal(getattr(port.result, name).numpy(),
                                      np.asarray(getattr(ref.result, name)),
                                      name)
    assert port.plan.describe().endswith(f"{layout}:bf16 n=96 d=3]")


def test_range_count_delta_block_sparse_matches_jnp_on_airline():
    """K14's plain version: the block-sparse signed count equals its dense
    form bit for bit, and the reference's direct-difference ``jnp`` one off
    a 4-ulp band around d_cut^2 (domain 1e5)."""
    pts = real_proxy("airline", 2048, seed=6)[0]
    dc = pick_dcut(pts)
    gp = build_grid(_t(pts), dc).points
    rng = np.random.default_rng(6)
    batch = gp[np.sort(rng.permutation(2048)[:1200])].contiguous()
    signs = _t(rng.choice([-1.0, 0.0, 1.0], 1200).astype(np.float32))
    be = CudaBackend()
    got = be.range_count_delta(gp, batch, signs, dc, layout="block-sparse")
    assert torch.equal(got, be.range_count_delta(gp, batch, signs, dc))
    want = np.asarray(jget_backend("jnp").range_count_delta(
        jnp.asarray(gp.numpy()), jnp.asarray(batch.numpy()),
        jnp.asarray(signs.numpy()), dc))
    thr = f32_d2cut(dc)
    band = near_threshold_rows(gp.numpy(), batch.numpy(), thr,
                               4 * f32_ulp(thr))
    np.testing.assert_array_equal(got.numpy()[~band], want[~band])
    wl = blocksparse.build_flat_worklist(gp, batch, dc, nn=None)
    assert wl.n_kept < wl.n_total
    assert torch.equal(got, sweep.worklist_range_count_signed_plain(
        gp, batch, signs, sweep.d2cut_of(dc), wl))


def test_range_count_delta_block_sparse_matches_pallas_interpret():
    """On unit-scale data with a clear threshold the block-sparse signed
    count equals the reference's Pallas worklist form."""
    pts = uniform_points(600, 2, seed=12)
    dc = clear_dcut(pts, target_rho=20)
    gp = build_grid(_t(pts), dc).points
    rng = np.random.default_rng(12)
    batch = gp[np.sort(rng.permutation(600)[:120])].contiguous()
    signs = _t(rng.choice([-1.0, 0.0, 1.0], 120).astype(np.float32))
    got = CudaBackend().range_count_delta(gp, batch, signs, dc,
                                          layout="block-sparse")
    want = jget_backend("pallas-interpret").range_count_delta(
        jnp.asarray(gp.numpy()), jnp.asarray(batch.numpy()),
        jnp.asarray(signs.numpy()), dc, layout="block-sparse")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_exec_spec_carries_bf16():
    got = carry.exec_spec(dataclasses.asdict(JExecSpec(
        backend="pallas", precision="bf16")))
    assert got == ExecSpec(backend="cuda", precision="bf16")
    sparse = carry.exec_spec(dataclasses.asdict(JExecSpec(
        backend="pallas-interpret", layout="block-sparse",
        precision="bf16")))
    assert sparse == ExecSpec(backend="cuda", layout="block-sparse",
                              precision="bf16")
    pl = planner.plan((10, 2), sparse)
    assert pl.precision == "bf16" and pl.grid_sort


def test_bf16_sweep_counts_its_own_launches_and_refuses_bad_precision():
    x = _t(uniform_points(50, 2, seed=1))
    with pytest.raises(ValueError, match="precision"):
        ops.fused_sweep(x, x, 0.1, precision="fp8")
    for name in ("fused_count_topk_bf16", "worklist_count_topk_bf16",
                 "fused_count_topk_bf16_sel", "worklist_count_topk_bf16_sel",
                 "worklist_range_count_signed"):
        assert name in ops.launch_counts()
