"""The paper's two baselines, LSH-DDP and CFSFDP-A, and ``with_noise``
(the Table 2 noise setup), held against the JAX package on the same numpy
inputs.

* LSH-DDP per round, on the reference's own buckets (``_bucket_round``'s
  order and bucket ids, ``_bucket_dependent``'s NN): the port's in-bucket
  passes on the ``cuda`` route (the plain K10/K11 on CPU tensors) and on
  ``torch``: rho equal off the 4-ulp band around d_cut^2, delta to rtol
  1e-6, parents equal; one case cuts the spans at a ``cap`` below the
  largest bucket.
* LSH-DDP end to end (M 4, L 3): every round's bucket ids equal but on
  rows proven to lie within 2 f32 ulps of a bucket boundary in float64
  (XLA's CPU dot sums in another order than the port's f32 sum over dims);
  where no id differs, rho, delta and parent as above, else the labels'
  Rand index at least 0.99.
* CFSFDP-A: the k-means pivots bit for bit; rho equal to the reference's
  where no k-means cluster is empty and to the port's exact Scan on every
  input, including one where the reference miscounts past an empty
  cluster (its window starts are indexed by rank, read by cluster id);
  delta (rtol 1e-6) and parent against the reference's ``dependent_scan``.
* Dispatch: ``DPCConfig``, ``compute_dpc``, ``cluster`` and
  ``DPCEngine.fit`` run both; a mesh engine refuses them.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.core.cfsfdp_a import run_cfsfdp_a as jrun_cfsfdp_a
from repro.core.dpc_types import with_jitter as jwith_jitter
from repro.core.labels import assign_labels as jassign_labels
from repro.core.lsh_ddp import _bucket_dependent, _bucket_round
from repro.core.lsh_ddp import run_lsh_ddp as jrun_lsh_ddp
from repro.core.scan import dependent_scan as jdependent_scan
from repro.core.scan import local_density_scan as jlocal_density_scan
from repro.data.points import gaussian_mixture as jgaussian_mixture
from repro.data.points import with_noise as jwith_noise

from repro_torch import DPCEngine, ExecSpec
from repro_torch.core import cfsfdp_a, lsh_ddp, threefry
from repro_torch.core.dpc_api import DPCConfig, cluster, compute_dpc
from repro_torch.core.labels import assign_labels
from repro_torch.core.metrics import rand_index
from repro_torch.core.scan import run_scan
from repro_torch.data.points import gaussian_mixture, with_noise
from repro_torch.engine.planner import as_plan
from repro_torch.launch import ShardMesh

from _torch_ref import f32_d2cut, f32_ulp, near_threshold_rows
from _torch_ref import one_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

D_CUT = 2500.0
M, L = 4, 3
SPECS = {"cuda": ExecSpec(), "torch": ExecSpec(backend="torch")}


def _data(kind: str, d: int, seed: int) -> np.ndarray:
    """1,200 points: a mixture, or a mixture of 1,000 with 20 % noise."""
    if kind == "mixture":
        return gaussian_mixture(1200, k=8, d=d, seed=seed)[0]
    pts, lab = gaussian_mixture(1000, k=8, d=d, seed=seed)
    return with_noise(pts, lab, 0.2, seed=seed)[0]


def _empty_cluster_data(seed: int = 0) -> np.ndarray:
    """400 copies of 6 sites plus 200 uniform points, d = 2: k-means from
    32 pivots leaves clusters empty (pivots drawn on copies of one site)."""
    rng = np.random.default_rng(seed)
    sites = rng.uniform(0, 1e5, (6, 2))
    return np.concatenate([sites[rng.integers(0, 6, 400)],
                           rng.uniform(0, 1e5, (200, 2))]).astype(np.float32)


def _band(pts) -> np.ndarray:
    """Rows whose count f32 rounding may decide: a pair within 4 ulps of
    d_cut^2 in float64."""
    thr = f32_d2cut(D_CUT)
    return near_threshold_rows(pts, pts, thr, 4 * f32_ulp(thr))


def _assert_rho(got, want, band, what):
    got, want = np.asarray(got), np.asarray(want)
    assert np.array_equal(got[~band], want[~band]), what


def _assert_nn(got_delta, got_parent, want_delta, want_parent, what):
    gd, wd = np.asarray(got_delta), np.asarray(want_delta)
    assert np.array_equal(np.isinf(gd), np.isinf(wd)), what
    fin = np.isfinite(wd)
    np.testing.assert_allclose(gd[fin], wd[fin], rtol=1e-6, atol=0,
                               err_msg=what)
    assert np.array_equal(np.asarray(got_parent).astype(np.int64),
                          np.asarray(want_parent).astype(np.int64)), what


# ------------------------------------------------------------ with_noise
@pytest.mark.parametrize("rate", [0.0, 0.05, 0.3])
def test_with_noise_matches_reference(rate):
    pts, lab = gaussian_mixture(500, k=5, d=3, seed=4)
    got = with_noise(pts, lab, rate, seed=2)
    want = jwith_noise(*jgaussian_mixture(500, k=5, d=3, seed=4), rate,
                       seed=2)
    assert len(got[0]) == 500 + int(500 * rate)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


# ------------------------------------------------- LSH-DDP, one round
def _reference_round(pts, seed, r, cap):
    """Round r of the reference's LSH-DDP: its order, bucket ids (in point
    order), span starts, in-bucket rho and sub key."""
    key = jax.random.PRNGKey(seed)
    for _ in range(r + 1):
        key, sub = jax.random.split(key)
    rho, order, _, bs, _, st_p, _ = _bucket_round(jnp.asarray(pts), sub,
                                                  D_CUT, L, cap)
    order = np.asarray(order)
    bid = np.empty(len(pts), np.int64)
    bid[order] = np.asarray(bs)
    return order, bid, np.asarray(st_p), np.asarray(rho), bs


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("case", ["mixture d2", "noise d3", "noise d3 cap"])
def test_lsh_round_on_reference_buckets(case, backend):
    kind, dims = case.split()[:2]
    pts = _data(kind, int(dims[1]), seed=1)
    n = len(pts)
    cut = case.endswith("cap")
    for r in range(2):
        order, bid, st_p, rho_ref, bs = _reference_round(pts, 1, r, n)
        big = int(np.unique(bid, return_counts=True)[1].max())
        cap = n
        if cut:     # the spans cut to a third of the largest bucket
            cap = max(1, big // 3)
            order, bid, st_p, rho_ref, bs = _reference_round(pts, 1, r, cap)
        bk = lsh_ddp.partition(torch.from_numpy(bid), cap if cut else None)
        assert bk.cap == (cap if cut else big)
        assert np.array_equal(bk.order.numpy(), order)
        assert np.array_equal(bk.starts[:, 0].numpy(), st_p[:n])
        be = as_plan(SPECS[backend]).backend
        x = torch.from_numpy(pts)
        rho = lsh_ddp.in_bucket_rho(be, x, bk, D_CUT)
        _assert_rho(rho.numpy(), rho_ref, _band(pts), f"{case} round {r}")
        rk = np.array(jwith_jitter(jnp.asarray(rho_ref)))
        dl_s, par_s = _bucket_dependent(jnp.asarray(pts[order]),
                                        jnp.asarray(rk[order]), bs,
                                        jnp.asarray(st_p), cap, 64)
        dl_s, par_s = np.asarray(dl_s), np.asarray(par_s)
        want_d = np.empty(n, np.float32)
        want_d[order] = dl_s
        want_p = np.empty(n, np.int64)
        want_p[order] = np.where(par_s >= 0, order[np.maximum(par_s, 0)], -1)
        delta, parent = lsh_ddp.in_bucket_nn(be, x, torch.from_numpy(rk), bk)
        _assert_nn(delta, parent, want_d, want_p, f"{case} round {r}")


# ---------------------------------------------- LSH-DDP, end to end
def _boundary_rows(pts, key, rows) -> np.ndarray:
    """(rows,) bool: some hash's float64 projection p . a + b lies within
    2 f32 ulps of a multiple of w (the draws are the reference's, bit for
    bit)."""
    d = pts.shape[1]
    w = np.float32(2 * D_CUT)
    ka, kb = threefry.split(key)
    a = threefry.normal(ka, (d, L)).numpy().astype(np.float64)
    b = (threefry.uniform(kb, (L,)) * torch.tensor(w)).numpy()
    proj = pts[rows].astype(np.float64) @ a + b.astype(np.float64)
    off = np.abs(proj - float(w) * np.round(proj / float(w)))
    return (off <= 2 * np.spacing(np.abs(proj).astype(np.float32))).any(1)


@pytest.mark.parametrize("d", [2, 3, 8])
def test_projection_dot_order(d):
    """Why a bucket id may differ: XLA's CPU dot ``points @ a`` and the
    port's f32 sum over dims in order round differently on some rows.
    Prints the share of rows where the (n, d) @ (d, 3) projections are
    equal bit for bit; every sum is within the two summations' error
    bound, (d - 1) 2^-23 sum_k |x_k a_k|, of the other."""
    pts = (gaussian_mixture(4000, k=8, d=d, seed=d)[0] if d <= 3 else
           np.random.default_rng(d).uniform(0, 1e5, (4000, d))
           .astype(np.float32))
    a = threefry.normal(threefry.split(threefry.prng_key(d))[0], (d, L))
    want = np.asarray(jnp.asarray(pts) @ jnp.asarray(a.numpy()))
    x = torch.from_numpy(pts)
    got = x[:, :1] * a[0]
    for k in range(1, d):
        got = got + x[:, k:k + 1] * a[k]
    got = got.numpy()
    same = (got == want).all(axis=1)
    print(f"d={d}: XLA's dot equals the ordered f32 sum on "
          f"{same.mean():.4f} of {len(pts)} rows")
    terms = np.abs(pts.astype(np.float64)[:, :, None]
                   * a.numpy().astype(np.float64)[None]).sum(1)
    assert (np.abs(got.astype(np.float64) - want)
            <= (d - 1) * 2.0**-23 * terms).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind,d", [("mixture", 2), ("mixture", 3),
                                    ("noise", 2), ("noise", 3)])
def test_lsh_end_to_end(kind, d, seed):
    pts = _data(kind, d, seed)
    want = jrun_lsh_ddp(pts, D_CUT, M=M, L=L, seed=seed)
    got = lsh_ddp.run_lsh_ddp(torch.from_numpy(pts), D_CUT, M=M, L=L,
                              seed=seed)
    differ = 0
    keys = lsh_ddp.round_keys(seed, M)
    for r in range(M):
        _, bid_ref, _, _, _ = _reference_round(pts, seed, r, len(pts))
        bid = lsh_ddp.bucket_ids(torch.from_numpy(pts), keys[r], D_CUT,
                                 L).numpy()
        rows = np.nonzero(bid != bid_ref)[0]
        assert _boundary_rows(pts, keys[r], rows).all(), \
            f"round {r}: a bucket id differs off a boundary"
        differ += rows.size
    if differ == 0:
        print(f"LSH-DDP {kind} d={d} seed={seed}: every bucket id equal")
        _assert_rho(got.rho.numpy(), want.rho, _band(pts), "rho")
        _assert_nn(got.delta.numpy(), got.parent.numpy(), want.delta,
                   want.parent, "delta/parent")
    else:
        la = assign_labels(got, 10.0, 2 * D_CUT).labels
        lb = jassign_labels(want, 10.0, 2 * D_CUT).labels
        ri = rand_index(la, np.asarray(lb))
        print(f"LSH-DDP {kind} d={d} seed={seed}: {differ} boundary ids "
              f"differ, Rand index {ri:.4f}")
        assert ri >= 0.99


# ------------------------------------------------------------ CFSFDP-A
CF_INPUTS = {
    "mixture seed 0": lambda: jgaussian_mixture(2000, k=8, seed=0)[0],
    "mixture seed 1": lambda: jgaussian_mixture(2000, k=8, seed=1)[0],
    "noise d3": lambda: _data("noise", 3, 2),
    "empty clusters": _empty_cluster_data,
}


@pytest.mark.parametrize("name", list(CF_INPUTS))
def test_cfsfdp_a(name):
    pts = CF_INPUTS[name]()
    dc = 3000.0 if name == "empty clusters" else D_CUT
    n = len(pts)
    want_init = jax.random.choice(jax.random.PRNGKey(0), n, (32,),
                                  replace=False)
    got_init = threefry.choice(threefry.prng_key(0), n, (32,))
    assert np.array_equal(np.asarray(want_init), got_init.numpy())
    x = torch.from_numpy(pts)
    _, assign = cfsfdp_a.kmeans_pivots(x, 32)
    empty = int((torch.bincount(assign, minlength=32) == 0).sum())
    ref = jrun_cfsfdp_a(pts, dc)
    exact = jlocal_density_scan(jnp.asarray(pts), dc)
    ref_miss = int((np.asarray(ref.rho) != np.asarray(exact)).sum())
    scan = run_scan(x, dc)
    for backend, spec in SPECS.items():
        got = cfsfdp_a.run_cfsfdp_a(x, dc, exec_spec=spec)
        what = f"{name} ({backend})"
        assert torch.equal(got.rho, scan.rho), what
        if empty == 0:
            assert np.array_equal(got.rho.numpy(), np.asarray(ref.rho)), what
        dl, par = jdependent_scan(jnp.asarray(pts),
                                  jnp.asarray(got.rho_key.numpy()))
        _assert_nn(got.delta.numpy(), got.parent.numpy(), dl, par, what)
    if name == "empty clusters":
        # the reference's gap: windows past an empty cluster are misread
        assert empty > 0 and ref_miss > 0
    else:
        assert empty == 0 and ref_miss == 0


# ------------------------------------------------------------ dispatch
@pytest.mark.parametrize("algo", ["lsh_ddp", "cfsfdp_a"])
def test_entry_points_run_the_baselines(algo):
    pts = _data("mixture", 2, 0)[:600]
    cfg = DPCConfig(d_cut=D_CUT, algorithm=algo, rho_min=5)
    res = compute_dpc(pts, cfg, device="cpu")
    runner = {"lsh_ddp": lsh_ddp.run_lsh_ddp,
              "cfsfdp_a": cfsfdp_a.run_cfsfdp_a}[algo]
    direct = runner(torch.from_numpy(pts), D_CUT)
    for a, b in zip(res, direct):
        assert torch.equal(a, b)
    labels, _ = cluster(pts, cfg, device="cpu")
    eng = DPCEngine(D_CUT, algorithm=algo, rho_min=5, device="cpu").fit(pts)
    for a, b in zip(eng.result, res):
        assert torch.equal(a, b)
    assert np.array_equal(np.asarray(eng.labels_),
                          np.asarray(labels.labels))
    torch_eng = DPCEngine(D_CUT, algorithm=algo, rho_min=5, device="cpu",
                          exec_spec=SPECS["torch"]).fit(pts)
    assert torch.equal(torch_eng.result.rho, res.rho)
    with pytest.raises(ValueError, match="not distributed"):
        DPCEngine(D_CUT, algorithm=algo, device="cpu",
                  mesh=ShardMesh.on("cpu", shards=2)).fit(pts)
