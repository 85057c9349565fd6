"""The port's DPC-KV (``repro_torch.serve.dpc_kv``) against the JAX
package's on the same caches.

The oracle is the reference's ``jnp`` DPC-KV (its pallas plans raise on
this tree, ROADMAP "Reference gaps").  The port runs its three legal
routes: ``cuda`` dense (here K4's and K2's plain versions, on CPU
tensors), ``torch`` dense and ``torch`` block-sparse (the ring walk).
Contract: the projection within 2e-6 of the largest |projected key| with
equal column signs (the two QRs and products round apart by an ulp), and
``_dcut_estimate`` within rtol 1e-6 on the same points.  From the same
projected points on, rho equal off the 4-ulp band around d_cut^2, and on
every head with no row in the band the center indices equal as ordered
lists, the counts equal and k_c/v_c within one ulp of their dtype; the
band heads are counted and only they may differ.  End to end, on each
package's own projection, every head whose clustering the projection's
last-ulp difference leaves alone equals the reference's.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ref import f32_ulp, one_thread  # noqa: F401  (fixture)
from repro.core.dpc_types import density_jitter as ref_jitter
from repro.engine import ExecSpec as RefSpec
from repro.kernels.backend import get_backend as ref_backend
from repro.resilience.sanitize import finite_or as ref_finite_or
from repro.serve import dpc_kv as R
from repro_torch.engine.spec import ExecSpec
from repro_torch.serve import dpc_kv as T

ROUTES = {"cuda": ExecSpec(backend="cuda"),
          "torch": ExecSpec(backend="torch"),
          "torch-bs": ExecSpec(backend="torch", layout="block-sparse")}


def clustered_cache(B=2, S=512, K=2, hd=32, modes=6, seed=0):
    """Keys drawn around a few attention modes + matching values (the
    reference's ``tests/test_dpc_kv.py`` data), as numpy f32."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 1, (modes, hd)).astype(np.float32) * 3
    assign = rng.integers(0, modes, (B, S, K))
    k = centers[assign] + rng.normal(0, 0.15, (B, S, K, hd))
    v = centers[assign] * 0.5 + rng.normal(0, 0.05, (B, S, K, hd))
    return k.astype(np.float32), v.astype(np.float32)


# (name, cache seed, budget, length, dtype): a full cache; a bf16 cache
# with a length per sequence; a budget above the valid rows
CASES = [("full", 0, 32, 512, np.float32),
         ("ragged-bf16", 1, 48, [300, 512], jnp.bfloat16),
         ("over-budget", 2, 64, [40, 20], np.float32)]


@partial(jax.jit, static_argnames=("M", "block"))
def _ref_cluster(kh, valid, M, block):
    """The reference's ``_compress_head`` on its jnp route up to the top-M
    (``repro/serve/dpc_kv.py:131-160``), from its own functions, vmapped
    over heads: pts, d_cut, rho and the centers."""
    def one(k, val):
        S = k.shape[0]
        pts = R._project(k, 4)
        pts = jnp.where(val[:, None], pts, 1e9 + jnp.arange(S)[:, None] * 1e3)
        d_cut = R._dcut_estimate(jnp.where(val[:, None], pts, 0.0), 0.05)
        mask = jnp.where(val, ref_jitter(S), -jnp.inf)
        rho, _, delta, _ = ref_backend("jnp").rho_delta(
            pts, pts, d_cut, jitter=mask, block=min(block, S),
            precision=None, layout=None)
        rho = jnp.where(val, rho, 0.0)
        delta = ref_finite_or(delta, 2.0 * d_cut * 10.0)
        gamma = jnp.where(val, rho * delta, -jnp.inf)
        return pts, d_cut, rho, jax.lax.top_k(gamma, M)[1]
    return jax.vmap(one)(kh, valid)


def _heads_np(k, length):
    B, S, K, hd = k.shape
    valid = np.arange(S)[None, :] < np.broadcast_to(length, (B,))[:, None]
    return (np.ascontiguousarray(k.transpose(0, 2, 1, 3)).reshape(B * K, S,
                                                                  hd),
            np.repeat(valid, K, axis=0))


@pytest.fixture(scope="module")
def runs():
    """Per case: the reference's outputs and intermediates, and each port
    route's on the reference's projected points (``same``) and on its own
    (``own``)."""
    out = {}
    for name, seed, M, length, dt in CASES:
        k, v = clustered_cache(seed=seed)
        kj, vj = jnp.asarray(k).astype(dt), jnp.asarray(v).astype(dt)
        rcfg = R.DPCKVConfig(budget=M, exec_spec=RefSpec(backend="jnp"))
        ref = R.compress_kv(kj, vj, jnp.asarray(length, jnp.int32), rcfg)
        kh, valid = _heads_np(np.asarray(kj.astype(jnp.float32)), length)
        inter = [np.asarray(a) for a in _ref_cluster(
            jnp.asarray(kh).astype(dt), jnp.asarray(valid), M,
            rcfg.resolved_block)]
        tdt = torch.bfloat16 if dt == jnp.bfloat16 else torch.float32
        kt = torch.from_numpy(np.asarray(kj.astype(jnp.float32))).to(tdt)
        vt = torch.from_numpy(np.asarray(vj.astype(jnp.float32))).to(tdt)
        ln = torch.tensor(length)
        th, tv = T._heads(kt, ln)
        got = {}
        for route, spec in ROUTES.items():
            cfg = T.DPCKVConfig(budget=M, exec_spec=spec)
            own = (T.compress_kv(kt, vt, ln, cfg),
                   T._cluster_heads(th, tv, cfg))
            project = T._project
            T._project = lambda keys, proj_dim, seed=0: torch.from_numpy(
                inter[0])
            try:
                same = (T.compress_kv(kt, vt, ln, cfg),
                        T._cluster_heads(th, tv, cfg))
            finally:
                T._project = project
            got[route] = {"own": own, "same": same}
        out[name] = (ref, inter, got, valid, th)
    return out


def _band_rows(pts, dcut, valid) -> np.ndarray:
    """(H, S) bool: valid rows with a valid pair whose float64 d^2 lies
    within 4 f32 ulp of d_cut^2, where f32 rounding may decide the
    count."""
    rows = np.zeros(valid.shape, bool)
    for h in range(len(pts)):
        x = pts[h][valid[h]].astype(np.float64)
        thr = float(np.float32(dcut[h]) ** 2)
        d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
        rows[h][valid[h]] = (np.abs(d2 - thr) <= 4 * f32_ulp(thr)).any(1)
    return rows


def _held(got, ref, heads):
    """The port's (k_c, v_c, counts) equal the reference's on ``heads``
    (B, K) bool: counts exactly, k_c/v_c within one ulp of their dtype."""
    (k_c, v_c, counts), (rk, rv, rc) = got, (np.asarray(a) for a in ref)
    np.testing.assert_array_equal(counts.numpy().transpose(0, 2, 1)[heads],
                                  rc.transpose(0, 2, 1)[heads])
    for g, w in ((k_c, rk), (v_c, rv)):
        assert g.dtype == (torch.bfloat16 if w.dtype.name == "bfloat16"
                           else torch.float32)
        g = g.float().numpy().transpose(0, 2, 1, 3)[heads]
        w = w.astype(np.float32).transpose(0, 2, 1, 3)[heads]
        eps = 2.0 ** (-7 if k_c.dtype == torch.bfloat16 else -23)
        assert np.all(np.abs(g - w) <= eps * np.abs(w)), np.abs(g - w).max()


def test_project_and_dcut_match_reference(runs, one_thread):
    for name, (_, (pts_r, dcut_r, _, _), got, valid, th) in runs.items():
        pts_t = T._project(th, 4).numpy()
        scale = np.abs(pts_r[valid]).max()
        np.testing.assert_allclose(pts_t[valid], pts_r[valid], rtol=0,
                                   atol=2e-6 * scale)
        zeroed = np.where(valid[:, :, None], pts_r, np.float32(0.0))
        np.testing.assert_allclose(
            T._dcut_estimate(torch.from_numpy(zeroed), 0.05).numpy(),
            dcut_r, rtol=1e-6)
    q_r = np.asarray(jnp.linalg.qr(jax.random.normal(
        jax.random.PRNGKey(0), (32, 32), jnp.float32))[0])[:, :4]
    q_t = T._projection(32, 4, 0, "cpu").numpy()
    np.testing.assert_array_equal(np.sign(q_t), np.sign(q_r))
    np.testing.assert_allclose(q_t, q_r, rtol=0, atol=2e-6)


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_compress_matches_reference(runs, case, route, one_thread):
    """From the reference's projected points on."""
    ref, (pts_r, dcut_r, rho_r, centers_r), got, valid, _ = runs[case]
    out, inter = got[route]["same"]
    np.testing.assert_allclose(inter["d_cut"].numpy(), dcut_r, rtol=1e-6)
    rows = _band_rows(pts_r, dcut_r, valid)
    np.testing.assert_array_equal(inter["rho"].numpy()[~rows],
                                  rho_r[~rows])
    off = ~rows.any(axis=1)
    np.testing.assert_array_equal(inter["centers"].numpy()[off],
                                  centers_r[off])
    B, M, K = np.asarray(ref[2]).shape
    _held(out, ref, off.reshape(B, K))
    assert off.sum() >= len(off) - 1, f"{(~off).sum()} band heads"


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_compress_end_to_end(runs, case, route, one_thread):
    """On the port's own projection: every head whose clusters the
    projection's last-ulp difference leaves unchanged equals the
    reference's."""
    ref, _, got, _, _ = runs[case]
    (out, own), (_, same) = got[route]["own"], got[route]["same"]
    alike = (own["member_slot"] == same["member_slot"]).all(dim=1) & \
        (own["centers"] == same["centers"]).all(dim=1)
    B, M, K = np.asarray(ref[2]).shape
    _held(out, ref, alike.numpy().reshape(B, K))
    assert int(alike.sum()) >= 1


def test_over_budget_and_ragged_lengths(runs):
    """A budget above the valid rows keeps every valid row as its own
    center; a length per sequence drops the rows past it."""
    (_, _, counts), _ = runs["over-budget"][2]["cuda"]["own"]
    c = counts.numpy()                       # (B, M, K) = (2, 64, 2)
    assert c.shape == (2, 64, 2)
    np.testing.assert_array_equal(c.sum(axis=1), [[40, 40], [20, 20]])
    assert c.max() == 1.0
    (_, _, counts), _ = runs["ragged-bf16"][2]["torch"]["own"]
    s = counts.numpy().sum(axis=1)
    assert (s[0] <= 300).all() and (s[1] <= 512).all() and (s > 0).all()


def test_attend_compressed_matches_reference(runs):
    ref, _, got, _, _ = runs["full"]
    q = np.random.default_rng(1).normal(0, 1, (2, 4, 32)).astype(np.float32)
    want = R.attend_compressed(jnp.asarray(q), *ref)
    k_c, v_c, counts = got["cuda"]["same"][0]
    have = T.attend_compressed(torch.from_numpy(q), k_c, v_c, counts)
    np.testing.assert_allclose(have.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def full_attention(q, k, v):
    B, H, hd = q.shape
    K = k.shape[2]
    qg = q.reshape(B, K, H // K, hd)
    logits = torch.einsum("bkgh,bskh->bkgs", qg, k) * hd ** -0.5
    out = torch.einsum("bkgs,bskh->bkgh", torch.softmax(logits, -1), v)
    return out.reshape(B, H, hd)


@pytest.mark.parametrize("route", list(ROUTES))
def test_better_than_random_eviction(route, one_thread):
    """On clustered keys DPC-KV beats random keeping at an equal budget
    for attention-output fidelity (the reference's test, on the port)."""
    k, v = (torch.from_numpy(a) for a in clustered_cache(seed=3))
    B, S, K, hd = k.shape
    q = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1, (B, 4, hd)).astype(np.float32))
    ref = full_attention(q, k, v)
    cfg = T.DPCKVConfig(budget=48, exec_spec=ROUTES[route])
    got = T.attend_compressed(q, *T.compress_kv(k, v, S, cfg))
    err_dpc = float(torch.linalg.norm(got - ref) / torch.linalg.norm(ref))
    keep = torch.from_numpy(np.random.default_rng(0).choice(S, 48,
                                                             replace=False))
    got_r = T.attend_compressed(q, k[:, keep], v[:, keep],
                                torch.ones((B, 48, K)))
    err_rand = float(torch.linalg.norm(got_r - ref) / torch.linalg.norm(ref))
    assert err_dpc < err_rand, (err_dpc, err_rand)
    assert err_dpc < 0.25, err_dpc


def test_legal_set_matches_reference():
    """The reference's legal set: budget >= 1; a kernel backend refuses
    block-sparse; bf16 raises on every backend; the plain backend's ring
    walk is legal."""
    for budget in (0, -3):
        with pytest.raises(ValueError, match="budget"):
            R.DPCKVConfig(budget=budget)
        with pytest.raises(ValueError, match="budget"):
            T.DPCKVConfig(budget=budget)
    with pytest.raises(ValueError, match="block-sparse"):
        T.DPCKVConfig(exec_spec=ExecSpec(backend="cuda",
                                         layout="block-sparse"))
    with pytest.raises(ValueError, match="block-sparse"):
        T.DPCKVConfig(exec_spec=ExecSpec(layout="block-sparse"))
    with pytest.raises(ValueError, match="bf16"):
        R.DPCKVConfig(exec_spec=RefSpec(backend="jnp", precision="bf16"))
    with pytest.raises(ValueError, match="bf16"):
        T.DPCKVConfig(exec_spec=ExecSpec(backend="cuda", precision="bf16"))
    with pytest.raises(ValueError, match="bf16"):
        T.DPCKVConfig(exec_spec=ExecSpec(backend="torch", precision="bf16"))
    R.DPCKVConfig(exec_spec=RefSpec(backend="jnp", layout="block-sparse"))
    cfg = T.DPCKVConfig(exec_spec=ExecSpec(backend="torch",
                                           layout="block-sparse"))
    assert cfg.resolved_exec().sparse
    assert T.DPCKVConfig().resolved_exec() == ExecSpec()


@pytest.mark.parametrize("route", list(ROUTES))
def test_budget_above_the_cache_raises(route):
    """A budget above the cache's S slots: the reference's top_k raises,
    and so does the port, rather than return budget - S empty slots."""
    k = np.random.default_rng(0).normal(size=(1, 16, 1, 8)).astype(np.float32)
    with pytest.raises(ValueError, match="top_k"):
        R.compress_kv(jnp.asarray(k), jnp.asarray(k), jnp.int32(16),
                      R.DPCKVConfig(budget=20,
                                    exec_spec=RefSpec(backend="jnp")))
    cfg = T.DPCKVConfig(budget=20, exec_spec=ROUTES[route])
    with pytest.raises(ValueError, match="exceeds the cache's 16 slots"):
        T.compress_kv(torch.from_numpy(k), torch.from_numpy(k), 16, cfg)
    k_c, _, counts = T.compress_kv(torch.from_numpy(k), torch.from_numpy(k),
                                   16, T.DPCKVConfig(budget=16,
                                                     exec_spec=ROUTES[route]))
    assert k_c.shape == (1, 16, 1, 8) and float(counts.sum()) == 16
