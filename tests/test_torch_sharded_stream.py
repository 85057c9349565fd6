"""The sharded stream: ``StreamDPC(cfg, mesh=ShardMesh.on("cpu", shards=S))``
held against the port's single-device stream tick by tick, bit for bit, and
against a from-scratch fit of its window; each sharded stage against its
single-device counterpart; ``DPCEngine(mesh=...).partial_fit`` and
``StreamService(mesh=...)``.  In a subprocess with four host devices the
JAX package's sharded stream runs the same ticks, and checkpoints cross
between the packages in both directions.  Inputs are built once with
numpy and handed to both packages."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.data.points import gaussian_mixture

from repro_torch import DPCEngine, ExecSpec
from repro_torch.core.approxdpc import run_approxdpc
from repro_torch.core.dpc_types import DPCResult
from repro_torch.core.labels import assign_labels
from repro_torch.kernels.backend import get_backend
from repro_torch.kernels.sweep import direct_d2
from repro_torch.launch import ShardMesh
from repro_torch.stream import (StreamDPC, StreamDPCConfig,
                                StreamServeConfig, StreamService, repair_rho)
from repro_torch.stream.incremental import make_sharded_repair
from repro_torch.stream.sharded import (make_sharded_center_dists,
                                        make_sharded_labels,
                                        make_sharded_nn_update)

from _torch_ref import f32_d2cut, f32_ulp, near_threshold_rows

SRC = Path(__file__).resolve().parents[1] / "src"
CAP, B, D_CUT, RHO_MIN = 256, 64, 2000.0, 3.0
LAYOUTS = ["dense", "block-sparse"]


def _cfg(layout="dense", **kw):
    base = dict(d_cut=D_CUT, capacity=CAP, batch_cap=B, rho_min=RHO_MIN,
                exec_spec=ExecSpec(layout=layout))
    base.update(kw)
    return StreamDPCConfig(**base)


def _mesh(shards):
    return ShardMesh.on("cpu", shards=shards)


def _steps(seed=5):
    """Warm-up by ingest alone, scattered, localized, partial and oversize
    batches, and drift out of the indexed box (a rebuild)."""
    pts, lab = gaussian_mixture(4 * CAP, k=4, d=2, overlap=0.02, seed=seed)
    one = pts[lab == 0]
    far = np.random.default_rng(0).normal(
        [9.7e4, 9.7e4], 400.0, (B, 2)).astype(np.float32)
    return [pts[:CAP], pts[CAP:CAP + B], one[:17],
            pts[CAP + B:CAP + B + 150], far, one[17:17 + B]]


def _assert_same(a: StreamDPC, b: StreamDPC, ta, tb):
    """Every StreamTick field and rho, rho_key, delta, parent, labels,
    centers bit for bit."""
    for name in ta._fields:
        np.testing.assert_array_equal(np.asarray(getattr(ta, name)),
                                      np.asarray(getattr(tb, name)), name)
    for name in DPCResult._fields:
        assert torch.equal(getattr(a.result, name),
                           getattr(b.result, name)), name
    for name in ("labels", "centers", "num_clusters"):
        assert torch.equal(getattr(a.clustering, name),
                           getattr(b.clustering, name)), name
    assert a.stats() == b.stats()


def _assert_matches_fresh_fit(s: StreamDPC):
    """rho, rho_key and delta equal a from-scratch fit of the window bit
    for bit, parents equal or equally near, centers (and labels where no
    parent differs) equal."""
    w = torch.from_numpy(s.window_points())
    fresh = run_approxdpc(w, s.cfg.d_cut, exec_spec=s.plan.spec)
    res = s.result
    for name in ("rho", "rho_key", "delta"):
        assert torch.equal(getattr(fresh, name), getattr(res, name)), name
    rows = torch.nonzero(fresh.parent != res.parent).flatten()
    assert torch.equal(direct_d2(w[rows], w[fresh.parent[rows].long()]),
                       direct_d2(w[rows], w[res.parent[rows].long()]))
    cl = assign_labels(fresh, s.cfg.rho_min, s.cfg.resolved_delta_min())
    assert torch.equal(cl.centers, s.clustering.centers)
    if rows.numel() == 0:
        assert torch.equal(cl.labels, s.clustering.labels)


# ------------------------------------------------------ the whole stream
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("shards", [1, 2, 4])
def test_sharded_stream_matches_single_device(shards, layout):
    a = StreamDPC(_cfg(layout, extent_margin=1), mesh=_mesh(shards))
    b = StreamDPC(_cfg(layout, extent_margin=1), device="cpu")
    assert a.device == torch.device("cpu") and a.mesh.size == shards
    rebuilt = 0
    for batch in _steps():
        ta, tb = a.ingest(batch), b.ingest(batch)
        _assert_same(a, b, ta, tb)
        if a.window.full:
            _assert_matches_fresh_fit(a)
        rebuilt += ta.rebuilt
    assert rebuilt == 1
    assert all(f is not None for f in (a._sharded, a._sharded_nn,
                                       a._sharded_labels))
    s = a.stats()
    assert s["nn_queries"] < s["nn_maxima_total"]    # dirty tracking ran


@pytest.mark.parametrize("layout", LAYOUTS)
def test_lattice_ties(layout):
    """Integer coordinates: exact distance ties between rows of different
    shards, and equal densities."""
    rng = np.random.default_rng(3)
    pts = rng.integers(0, 24, size=(CAP + 5 * B, 2)).astype(np.float32)
    cfg = dict(d_cut=2.5, capacity=CAP, batch_cap=B, rho_min=2.0,
               exec_spec=ExecSpec(layout=layout))
    a = StreamDPC(StreamDPCConfig(**cfg), mesh=_mesh(4))
    b = StreamDPC(StreamDPCConfig(**cfg), device="cpu")
    _assert_same(a, b, a.initialize(pts[:CAP]), b.initialize(pts[:CAP]))
    for t in range(5):
        batch = pts[CAP + t * B:CAP + (t + 1) * B]
        _assert_same(a, b, a.ingest(batch), b.ingest(batch))
        _assert_matches_fresh_fit(a)


def test_mesh_refusals():
    with pytest.raises(ValueError, match=r"4 shards.*capacity 250"):
        StreamDPC(_cfg(capacity=250), mesh=_mesh(4))
    with pytest.raises(ValueError, match=r"3 shards.*capacity 256"):
        StreamDPC(_cfg(), mesh=_mesh(3))
    with pytest.raises(TypeError, match="ShardMesh"):
        StreamDPC(_cfg(), mesh=object(), device="cpu")
    card = _mesh(2)
    card.devices = [torch.device("cuda")] * 2
    with pytest.raises(ValueError, match="device type"):
        StreamDPC(_cfg(), mesh=card, device="cpu")
    StreamDPC(_cfg(), mesh=_mesh(2), device="cpu")    # divides: accepted


# ------------------------------------------------------------- the stages
def _table(n=256, d=2, seed=0):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32) * 10)
    keys = torch.from_numpy(rng.permutation(n).astype(np.float32))
    return w, keys


@pytest.mark.parametrize("layout", [None, "block-sparse"])
@pytest.mark.parametrize("shards", [1, 2, 4])
def test_nn_update_stage_matches_k6(shards, layout):
    be = get_backend()
    fn = make_sharded_nn_update(_mesh(shards), "data", be, layout=layout)
    for w, keys in (_table(), _table(512, 3, 1),
                    # equal keys and exact distance ties
                    (torch.from_numpy(np.random.default_rng(2).integers(
                        0, 8, (256, 2)).astype(np.float32)),
                     torch.from_numpy((np.arange(256) % 3).astype(
                         np.float32)))):
        n = w.shape[0]
        slots = torch.cat([torch.tensor([int(torch.argmax(keys))]),
                           torch.randperm(n, generator=torch.Generator()
                                          .manual_seed(0))[:100],
                           torch.tensor([n, n + 3, -1])])
        got = fn(w, keys, slots)
        want = be.denser_nn_update(w, keys, slots)
        for g, x in zip(got, want):
            assert torch.equal(g, x)
        assert int(got[1][0]) == -1 and bool((got[1][-3:] == -1).all())
    empty = fn(w, keys, torch.zeros(0, dtype=torch.int64))
    assert empty[0].shape == (0,) and empty[1].shape == (0,)


# Two d2 one ulp apart with one f32 square root: the query at the origin,
# B (the larger d2) at slot 1 and A (the smaller) at slot 6, both denser.
_A = (1.1213271617889404, 1.1458992958068848)
_B = (1.1213271617889404, 1.1458994150161743)


def _rooted_tie():
    w = np.full((8, 2), 100.0, np.float32)
    w[0] = (0.0, 0.0)
    w[1], w[6] = _B, _A
    w[2:6] = np.arange(8, dtype=np.float32).reshape(4, 2) * 10 + 50
    w[7] = (200.0, 200.0)
    keys = (np.array([1, 5, 0, 0, 0, 0, 5, 0], np.float32)
            + np.arange(8, dtype=np.float32) * 1e-3)
    return w, keys


def test_rooted_tie_merges_on_d2():
    """The merge takes the smaller d2 (slot 6), as K6 does, where a merge
    on the rooted delta would take the lower slot (1)."""
    w, keys = _rooted_tie()
    d2 = direct_d2(torch.from_numpy(w[[1, 6]]), torch.zeros(2, 2))
    assert float(d2[0]) == np.nextafter(np.float32(d2[1]), np.float32(np.inf))
    assert torch.equal(torch.sqrt(d2[0]), torch.sqrt(d2[1]))
    be = get_backend()
    w_t, k_t = torch.from_numpy(w), torch.from_numpy(keys)
    want = be.denser_nn_update(w_t, k_t, torch.tensor([0, 8]))
    assert want[1].tolist() == [6, -1]
    for layout in (None, "block-sparse"):
        got = make_sharded_nn_update(_mesh(4), "data", be, layout=layout)(
            w_t, k_t, torch.tensor([0, 8]))
        for g, x in zip(got, want):
            assert torch.equal(g, x)


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_labels_stage_matches_assign_labels(shards):
    rng = np.random.default_rng(shards)
    n = 256
    for trial in range(3):
        rho = torch.from_numpy(rng.integers(0, 12, n).astype(np.float32))
        rho_key = rho + torch.from_numpy(rng.permutation(n).astype(
            np.float32) * 1e-4)
        # a dependency forest: each row points at a denser one, or is a root
        order = torch.argsort(rho_key, descending=True)
        parent = torch.full((n,), -1, dtype=torch.int32)
        for i in range(1, n):
            if rng.random() < 0.9:
                parent[order[i]] = order[rng.integers(0, i)]
        delta = torch.from_numpy(rng.uniform(0, 5, n).astype(np.float32))
        delta[parent < 0] = float("inf")
        res = DPCResult(rho=rho, rho_key=rho_key, delta=delta, parent=parent)
        want = assign_labels(res, 3.0, 2.0)
        got = make_sharded_labels(_mesh(shards), "data", n)(res, 3.0, 2.0)
        for g, x in zip(got, want):
            assert torch.equal(g, x)
    with pytest.raises(ValueError, match="capacity 250"):
        make_sharded_labels(_mesh(4), "data", 250)


@pytest.mark.parametrize("d", [2, 3, 8, 17])
@pytest.mark.parametrize("shards", [1, 4])
def test_center_dists_stage_matches_numpy(d, shards):
    """Bit for bit against the reference's numpy matrix; numpy sums
    eight or more dims pairwise, in another order than a running sum."""
    rng = np.random.default_rng(d)
    fn = make_sharded_center_dists(_mesh(shards), "data")
    for m, k in ((1, 1), (7, 5), (33, 40)):
        new = (rng.normal(size=(m, d)) * 1e4).astype(np.float32)
        prev = (rng.normal(size=(k, d)) * 1e4).astype(np.float32)
        want = np.sqrt(((new[:, None, :].astype(np.float64)
                         - prev[None]) ** 2).sum(-1))
        got = fn(new, prev)
        assert got.dtype == np.float64 and got.shape == (m, k)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_repair_stage_matches_repair_rho(shards):
    be = get_backend()
    rng = np.random.default_rng(shards)
    n, nb, d_cut = 256, 16, 4.0
    w = torch.from_numpy(rng.integers(0, 30, (n, 2)).astype(np.float32))
    rho = torch.from_numpy(rng.integers(0, 9, n).astype(np.float32))
    batch = torch.from_numpy(rng.integers(0, 30, (2 * nb, 2)).astype(
        np.float32))
    signs = torch.from_numpy(np.r_[np.ones(nb - 3), np.zeros(3),
                                   -np.ones(nb)].astype(np.float32))
    ins = batch[:nb].contiguous()
    slots = np.r_[rng.permutation(n)[:nb - 3], [n] * 3]
    want = repair_rho(be, d_cut, w, rho, batch, signs, ins, slots)
    got = make_sharded_repair(_mesh(shards), "data", be, d_cut)(
        w, rho, batch, signs, ins, slots)
    assert torch.equal(got, want)


# ----------------------------------------------- the engine and the service
@pytest.mark.parametrize("layout", LAYOUTS)
def test_engine_and_service_with_a_mesh(layout):
    pts, _ = gaussian_mixture(3 * CAP, k=4, d=2, overlap=0.02, seed=4)
    kw = dict(rho_min=RHO_MIN, window_capacity=CAP, batch_cap=B,
              exec_spec=ExecSpec(layout=layout), device="cpu")
    a = DPCEngine(D_CUT, mesh=_mesh(4), **kw)
    b = DPCEngine(D_CUT, **kw)
    scfg = _cfg(layout)
    sa = StreamService(StreamServeConfig(stream=scfg), mesh=_mesh(4))
    sb = StreamService(StreamServeConfig(stream=scfg), device="cpu")
    assert sa.engine.mesh.size == 4 and sb.engine.mesh is None
    for t in range(8):
        batch = pts[t * B:(t + 1) * B] if t < 4 else \
            pts[CAP + t * 40:CAP + (t + 1) * 40]
        ta, tb = a.partial_fit(batch), b.partial_fit(batch)
        _assert_same(a.stream, b.stream, ta, tb)
        np.testing.assert_array_equal(a.labels_, b.labels_)
        for ga, gb in zip(sa.submit(batch), sb.submit(batch)):
            _assert_same(sa.engine, sb.engine, ga, gb)
    assert a.stream.mesh.size == 4
    _assert_same(sa.engine, sb.engine, sa.flush(), sb.flush())
    q = pts[-20:]
    np.testing.assert_array_equal(a.predict(q).labels, b.predict(q).labels)
    np.testing.assert_array_equal(sa.query(q).labels, sb.query(q).labels)


# --------------------------------------- the JAX package's 4-device stream
_XCAP, _XB = 512, 64

_JAX_SCRIPT = r"""
import sys, warnings
warnings.filterwarnings("ignore")
import numpy as np, jax, jax.numpy as jnp
from repro.engine import ExecSpec
from repro.kernels.backend import get_backend
from repro.stream import StreamDPC, StreamDPCConfig
from repro.stream.sharded import make_sharded_nn_update

assert jax.device_count() == 4
out_dir = sys.argv[1]
pts = np.load(f"{out_dir}/pts.npy")
CAP, B = 512, 64
mesh = jax.make_mesh((4,), ("data",))
out = {}

def record(key, s, tick):
    out[f"{key}/labels"] = tick.labels
    out[f"{key}/stable"] = tick.stable_ids
    out[f"{key}/centers"] = np.asarray(tick.centers)
    out[f"{key}/meta"] = np.array([tick.num_clusters, tick.rebuilt,
                                   tick.full_recompute, tick.tick])
    for f in ("rho", "rho_key", "delta", "parent"):
        out[f"{key}/{f}"] = np.asarray(getattr(s.result, f))

for layout in ("dense", "block-sparse"):
    s = StreamDPC(StreamDPCConfig(d_cut=8000.0, capacity=CAP, batch_cap=B,
                                  rho_min=3.0,
                                  exec_spec=ExecSpec(layout=layout)),
                  mesh=mesh)
    record(f"{layout}/0", s, s.initialize(pts[:CAP]))
    for t in range(3):
        if t == 2:
            s.save(f"{out_dir}/ref-{layout}.npz")
        record(f"{layout}/{t + 1}", s,
               s.ingest(pts[CAP + t * B:CAP + (t + 1) * B]))
    for where, m in (("mesh", mesh), ("none", None)):
        r = StreamDPC.restore(f"{out_dir}/port-{layout}.npz", mesh=m)
        record(f"{layout}/port-{where}", r,
               r.ingest(pts[CAP + 2 * B:CAP + 3 * B]))

# the reference's own merge on the rooted tie, sharded and not
w, keys = np.load(f"{out_dir}/tie.npy"), np.load(f"{out_dir}/tie_keys.npy")
slots = jnp.asarray(np.array([0, 8], np.int32))
be = get_backend("jnp")
out["tie/sharded"] = np.asarray(make_sharded_nn_update(mesh, "data", be)(
    jnp.asarray(w), jnp.asarray(keys), slots)[1])
out["tie/single"] = np.asarray(be.denser_nn_update(
    jnp.asarray(w), jnp.asarray(keys), slots)[1])
np.savez(f"{out_dir}/ref-out.npz", **out)
"""


def _record(s, tick) -> dict:
    return {"labels": tick.labels, "stable": tick.stable_ids,
            "centers": np.asarray(tick.centers),
            "meta": np.array([tick.num_clusters, tick.rebuilt,
                              tick.full_recompute, tick.tick]),
            **{f: getattr(s.result, f).numpy()
               for f in ("rho", "rho_key", "delta", "parent")}}


@pytest.fixture(scope="module")
def xref(tmp_path_factory):
    """The port's 4-shard stream (its checkpoint after tick 2 written
    first), then the reference's 4-device stream in a subprocess, which
    also restores the port's checkpoint."""
    out = tmp_path_factory.mktemp("xref")
    pts, _ = gaussian_mixture(_XCAP + 3 * _XB, k=4, d=2, overlap=0.05,
                              seed=2)
    np.save(out / "pts.npy", pts)
    w, keys = _rooted_tie()
    np.save(out / "tie.npy", w)
    np.save(out / "tie_keys.npy", keys)
    port = {}
    for layout in LAYOUTS:
        s = StreamDPC(StreamDPCConfig(d_cut=8000.0, capacity=_XCAP,
                                      batch_cap=_XB, rho_min=3.0,
                                      exec_spec=ExecSpec(layout=layout)),
                      mesh=_mesh(4))
        port[layout, 0] = _record(s, s.initialize(pts[:_XCAP]))
        for t in range(3):
            if t == 2:
                s.save(str(out / f"port-{layout}.npz"))
            port[layout, t + 1] = _record(s, s.ingest(
                pts[_XCAP + t * _XB:_XCAP + (t + 1) * _XB]))
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, str(out)],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    z = np.load(out / "ref-out.npz")
    ref = {k: z[k] for k in z.files}
    return {"dir": out, "pts": pts, "port": port, "ref": ref}


def _assert_same_as_ref(got: dict, ref: dict, key: str, window):
    """The port's tick against the reference's: labels, stable ids,
    centers and the tick's counters equal; rho and rho_key equal off the
    d_cut threshold band, parent equal, delta to f32 rounding (the
    reference's jnp distances, as in tests/test_torch_stream.py)."""
    for name in ("labels", "stable", "centers", "meta", "parent"):
        np.testing.assert_array_equal(got[name], ref[f"{key}/{name}"], name)
    thr = f32_d2cut(8000.0)
    band = near_threshold_rows(window, window, thr, 4 * f32_ulp(thr))
    for name in ("rho", "rho_key"):
        np.testing.assert_array_equal(got[name][~band],
                                      ref[f"{key}/{name}"][~band], name)
    np.testing.assert_allclose(got["delta"], ref[f"{key}/delta"], rtol=1e-6)


def _window(pts, tick):
    """The window after ``tick`` ticks of the cross-package stream, in slot
    order."""
    w = pts[:_XCAP].copy()
    for t in range(tick):
        w[(t * _XB) % _XCAP:(t * _XB) % _XCAP + _XB] = \
            pts[_XCAP + t * _XB:_XCAP + (t + 1) * _XB]
    return w


@pytest.mark.parametrize("layout", LAYOUTS)
def test_port_matches_reference_4_device_stream(xref, layout):
    for t in range(4):
        _assert_same_as_ref(xref["port"][layout, t], xref["ref"],
                            f"{layout}/{t}", _window(xref["pts"], t))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("shards", [4, None])
def test_reference_checkpoint_restores_in_port(xref, layout, shards):
    mesh = None if shards is None else _mesh(shards)
    r = StreamDPC.restore(str(xref["dir"] / f"ref-{layout}.npz"), mesh=mesh,
                          device="cpu")
    assert r.stats()["ticks"] == 3 and (r.mesh is None) == (shards is None)
    pts = xref["pts"]
    tick = r.ingest(pts[_XCAP + 2 * _XB:_XCAP + 3 * _XB])
    _assert_same_as_ref(_record(r, tick), xref["ref"], f"{layout}/3",
                        _window(pts, 3))
    for name, val in xref["port"][layout, 3].items():
        np.testing.assert_array_equal(_record(r, tick)[name], val, name)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("where", ["mesh", "none"])
def test_port_checkpoint_restores_in_reference(xref, layout, where):
    _assert_same_as_ref(xref["port"][layout, 3], xref["ref"],
                        f"{layout}/port-{where}", _window(xref["pts"], 3))


def test_reference_merge_on_the_rooted_tie(xref):
    """The reference's sharded merge takes the lower slot of two d2 with
    one root, where its single-device pass and K6 take the smaller d2
    (ROADMAP "Reference gaps"); the port's sharded merge is K6's."""
    assert xref["ref"]["tie/single"].tolist() == [6, -1]
    assert xref["ref"]["tie/sharded"].tolist() == [1, -1]
    w, keys = _rooted_tie()
    got = make_sharded_nn_update(_mesh(4), "data", get_backend())(
        torch.from_numpy(w), torch.from_numpy(keys), torch.tensor([0, 8]))
    assert got[1].tolist() == [6, -1]
