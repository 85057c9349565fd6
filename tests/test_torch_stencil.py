"""The stencil route on the ``torch`` reference backend, held against the
JAX package's ``jnp`` backend on the same numpy inputs: ``core/stencil.py``
function by function, the dense (stencil) and block-sparse fits of
Approx-DPC, Ex-DPC and S-Approx-DPC, Scan's aliases, distributed Ex-DPC on
1-4 CPU shards, the stream, the sharded stream, the engine and the service
on a ``torch`` plan, and a ``jnp`` checkpoint restored onto ``torch``.

The [0, 20)^2 and [0, 12)^3 integer lattices make every distance exact and
tie-heavy: there the ``torch`` fits equal the reference's ``jnp`` fits in
every rho, parent and label, which checks the stencil route's tie order
(the lowest grid-sorted slot).  Elsewhere the carried contracts: rho equal
off the 4-ulp band around d_cut^2, parents equal, delta to f32 rounding."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import stencil as jstencil
from repro.core.approxdpc import run_approxdpc as jrun_approxdpc
from repro.core.exdpc import run_exdpc as jrun_exdpc
from repro.core.grid import build_grid as jbuild_grid
from repro.core.labels import assign_labels as jassign_labels
from repro.core.sapproxdpc import run_sapproxdpc as jrun_sapproxdpc
from repro.core.scan import dependent_scan as jdependent_scan
from repro.core.scan import local_density_scan as jlocal_density_scan
from repro.data.points import gaussian_mixture
from repro.engine import ExecSpec as JExecSpec
from repro.stream import StreamDPC as JStreamDPC
from repro.stream import StreamDPCConfig as JStreamDPCConfig

from repro_torch import DPCEngine, ExecSpec, obs
from repro_torch.core import stencil
from repro_torch.core.approxdpc import run_approxdpc
from repro_torch.core.exdpc import resolve_fallback, run_exdpc
from repro_torch.core.grid import build_grid
from repro_torch.core.labels import assign_labels
from repro_torch.core.sapproxdpc import representatives, run_sapproxdpc
from repro_torch.core.scan import dependent_scan, local_density_scan
from repro_torch.distributed import DistDPCConfig, distributed_dpc
from repro_torch.kernels import sweep
from repro_torch.launch import ShardMesh
from repro_torch.stream import (StreamDPC, StreamDPCConfig,
                                StreamServeConfig, StreamService)

from _torch_ref import f32_d2cut, f32_ulp, near_threshold_rows
from _torch_ref import one_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

TORCH = ExecSpec(backend="torch")
TORCH_BS = ExecSpec(backend="torch", layout="block-sparse")


def _lattice(high, d, n=3000, seed=0):
    return np.random.default_rng(seed).integers(
        0, high, size=(n, d)).astype(np.float32)


def _mixture():
    pts, _ = gaussian_mixture(2000, k=6, d=2, overlap=0.03, seed=7)
    return pts, 2500.0


# (points, d_cut, exact)
_DATA = {"lattice2": lambda: (_lattice(20, 2), 1.5, True),
         "lattice3": lambda: (_lattice(12, 3), 1.01, True),
         "mixture": lambda: (*_mixture(), False)}
_CACHE: dict = {}


def _data(name):
    if name not in _CACHE:
        _CACHE[name] = _DATA[name]()
    return _CACHE[name]


def _t(a):
    return torch.from_numpy(np.array(a))


def _band(pts, dc, exact):
    if exact:
        return np.zeros(len(pts), bool)
    thr = f32_d2cut(dc)
    return near_threshold_rows(pts, pts, thr, 4 * f32_ulp(thr))


def _labels(res, rho_min, dc):
    return np.asarray(assign_labels(res, rho_min, 2 * dc).labels)


def _assert_same_fit(got, want, pts, dc, exact, ok=None):
    """rho, parent and labels equal (rho off the band), delta bit for bit
    on exact data and to f32 rounding elsewhere; ``ok`` masks rows out."""
    ok = np.ones(len(pts), bool) if ok is None else ok
    band = _band(pts, dc, exact)
    g = [a.numpy() for a in got]
    w = [np.asarray(a) for a in want]
    np.testing.assert_array_equal(g[0][~band], w[0][~band])
    np.testing.assert_array_equal(g[1][~band], w[1][~band])
    np.testing.assert_array_equal(g[3][ok], w[3][ok])
    if exact:
        np.testing.assert_array_equal(g[2][ok], w[2][ok])
    else:
        np.testing.assert_allclose(g[2][ok], w[2][ok], rtol=1e-6)
    rho_min = 2.0 if exact else 5.0
    np.testing.assert_array_equal(
        _labels(got, rho_min, dc),
        np.asarray(jassign_labels(want, rho_min, 2 * dc).labels))


# ------------------------------------------------------- core/stencil.py
@pytest.mark.parametrize("data", list(_DATA))
def test_stencil_functions_match_reference(data):
    pts, dc, exact = _data(data)
    jg = jbuild_grid(jnp.asarray(pts), dc)
    tg = build_grid(_t(pts), dc)
    n = len(pts)
    band = _band(np.asarray(jg.points), dc, exact)
    want_rho = np.asarray(jstencil.density_per_point(jg))
    for block in (256, 7):
        np.testing.assert_array_equal(
            stencil.density_per_point(tg, block=block).numpy()[~band],
            want_rho[~band])
    for block in (32, 3):
        np.testing.assert_array_equal(
            stencil.density_per_cell(tg, block=block).numpy()[~band],
            np.asarray(jstencil.density_per_cell(jg))[~band])
    rng = np.random.default_rng(1)
    rk = (want_rho + rng.permutation(n) / n).astype(np.float32)

    def same(got, want):
        g = [a.numpy() for a in got]
        w = [np.asarray(a) for a in want]
        np.testing.assert_array_equal(g[1], w[1])
        if len(g) > 2:
            np.testing.assert_array_equal(g[2], w[2])
        np.testing.assert_allclose(g[0], w[0], rtol=0 if exact else 1e-6)

    same(stencil.dependent_stencil(tg, _t(rk), block=41),
         jstencil.dependent_stencil(jg, jnp.asarray(rk)))
    # slots padded with n (and past it) return 0 and (inf, -1, False)
    slots = np.concatenate([rng.choice(n, 300, replace=False),
                            [n, n, n + 3]]).astype(np.int32)
    np.testing.assert_array_equal(
        stencil.density_for_slots(tg, _t(slots), block=64).numpy(),
        np.asarray(jstencil.density_for_slots(jg, jnp.asarray(slots))))
    masked = np.where(rng.random(n) < 0.3, rk, -np.inf).astype(np.float32)
    same(stencil.dependent_stencil_slots(tg, _t(masked), _t(slots)),
         jstencil.dependent_stencil_slots(jg, jnp.asarray(masked),
                                          jnp.asarray(slots)))
    q = np.arange(0, n, 11)
    sp = np.asarray(jg.points)
    same(stencil.masked_nn_rows(_t(sp[q]), _t(rk[q]), _t(sp), _t(rk)),
         jstencil.masked_nn_rows(jnp.asarray(sp[q]), jnp.asarray(rk[q]),
                                 jnp.asarray(sp), jnp.asarray(rk)))


def test_resolve_fallback_answers_only_the_unresolved_rows():
    pts, dc, _ = _data("lattice2")
    x = _t(pts)
    rk = torch.rand(len(pts), generator=torch.Generator().manual_seed(0))
    delta = torch.full((len(pts),), 7.0)
    parent = torch.full((len(pts),), 5, dtype=torch.int32)
    resolved = torch.arange(len(pts)) % 4 != 0
    d, p = resolve_fallback(x, rk, delta, parent, resolved, backend="torch")
    assert torch.equal(d[resolved], delta[resolved])
    assert torch.equal(p[resolved], parent[resolved])
    fd, fp = sweep.masked_nn_plain(x[~resolved], rk[~resolved], x, rk)
    assert torch.equal(d[~resolved], torch.sqrt(fd))
    assert torch.equal(p[~resolved], fp)
    assert (parent == 5).all() and (delta == 7.0).all()   # inputs untouched


# -------------------------------------------------------- the algorithms
_REF: dict = {}


def _ref(algo, data):
    """The reference's jnp fit (its stencil route, dense), memoized."""
    key = (algo, data)
    if key not in _REF:
        pts, dc, _ = _data(data)
        fn = {"approxdpc": jrun_approxdpc, "exdpc": jrun_exdpc,
              "sapproxdpc": jrun_sapproxdpc}[algo]
        _REF[key] = fn(pts, dc, exec_spec=JExecSpec(backend="jnp"))
    return _REF[key]


_RUN = {"approxdpc": run_approxdpc, "exdpc": run_exdpc,
        "sapproxdpc": run_sapproxdpc}


def _gap_rows(pts, dc, eps=0.8):
    """The reference's "last grid slot" gap (ROADMAP "Reference gaps"):
    with a lone representative in slot n - 1 and a rep count that is not a
    power of two it marks that representative a member, and keys it -inf
    for phase 1, so the rows it would parent differ too; the other rows
    must match."""
    grid = build_grid(_t(pts), dc)
    reps, _ = representatives(grid, dc, eps)
    n, k = len(pts), reps.numel()
    if (reps == n - 1).any() and k & (k - 1):
        return np.asarray([int(grid.order[n - 1])])
    return np.zeros(0, np.int64)


@pytest.mark.parametrize("algo", list(_RUN))
@pytest.mark.parametrize("data", list(_DATA))
def test_dense_fit_matches_jnp(algo, data):
    """The dense ``torch`` fit takes the stencil route, as the reference's
    ``jnp`` fit does, and spans its phases by the reference's names."""
    pts, dc, exact = _data(data)
    obs.configure("metrics")
    obs.reset_spans()
    try:
        got = _RUN[algo](_t(pts), dc, exec_spec=TORCH)
    finally:
        obs.configure("off")
    ok = None
    if algo == "sapproxdpc":
        ok = np.ones(len(pts), bool)
        ok[_gap_rows(pts, dc)] = False
        assert ok.all() or data == "mixture"
    _assert_same_fit(got, _ref(algo, data), pts, dc, exact, ok)
    names = {s["name"] for s in obs.spans()}
    want = {"approxdpc": ("approxdpc.rho", "approxdpc.stencil",
                          "approxdpc.fallback"),
            "exdpc": ("exdpc.rho", "exdpc.stencil", "exdpc.fallback"),
            "sapproxdpc": ("sapproxdpc.rep_rho", "sapproxdpc.phase12")}[algo]
    assert set(want) <= names, names


@pytest.mark.parametrize("algo", list(_RUN))
@pytest.mark.parametrize("data", ["lattice2", "lattice3"])
def test_block_sparse_fit_matches_jnp_and_cuda(algo, data):
    """The block-sparse ``torch`` fit (the fused route on the ring walk)
    equals the reference's block-sparse ``jnp`` fit and the port's
    block-sparse ``cuda`` fit in every rho and parent."""
    pts, dc, exact = _data(data)
    got = _RUN[algo](_t(pts), dc, exec_spec=TORCH_BS)
    want = {"approxdpc": jrun_approxdpc, "exdpc": jrun_exdpc,
            "sapproxdpc": jrun_sapproxdpc}[algo](
        pts, dc, exec_spec=JExecSpec(backend="jnp", layout="block-sparse"))
    _assert_same_fit(got, want, pts, dc, exact)
    cu = _RUN[algo](_t(pts), dc, exec_spec=ExecSpec(layout="block-sparse"))
    for a, b in zip(got, cu):
        assert torch.equal(a, b)


def test_dense_routes_break_ties_apart():
    """On the [0, 20)^2 lattice the stencil route (``torch``, as ``jnp``)
    and the fused dense route (``cuda``) pick different parents among
    equally near denser points: 120 rows in Approx-DPC, 150 in Ex-DPC;
    each such pair of parents is an exact distance tie."""
    pts, dc, _ = _data("lattice2")
    x = _t(pts)
    for algo, rows in (("approxdpc", 120), ("exdpc", 150)):
        a = _RUN[algo](x, dc, exec_spec=TORCH)
        b = _RUN[algo](x, dc, exec_spec=ExecSpec())
        diff = torch.nonzero(a.parent != b.parent).flatten()
        assert diff.numel() == rows
        assert torch.equal(a.rho, b.rho)
        if algo == "exdpc":
            assert torch.equal(
                sweep.direct_d2(x[diff], x[a.parent[diff].long()]),
                sweep.direct_d2(x[diff], x[b.parent[diff].long()]))


def test_scan_aliases_match_reference():
    pts, dc, _ = _data("mixture")
    rho = local_density_scan(_t(pts), dc)
    np.testing.assert_array_equal(rho.numpy(),
                                  np.asarray(jlocal_density_scan(pts, dc)))
    rk = (rho.numpy() + np.arange(len(pts)) / len(pts)).astype(np.float32)
    d, p = dependent_scan(_t(pts), _t(rk))
    jd, jp = (np.asarray(a) for a in jdependent_scan(pts, rk))
    np.testing.assert_array_equal(p.numpy(), jp)
    np.testing.assert_allclose(d.numpy(), jd, rtol=1e-6)


def test_engine_fit_runs_the_stencil_route():
    pts, dc, _ = _data("lattice2")
    eng = DPCEngine(dc, rho_min=2.0, algorithm="approxdpc", device="cpu",
                    exec_spec=ExecSpec(backend="torch", block=100)).fit(pts)
    assert eng.plan.backend.name == "torch" and eng.plan.block == 100
    want = _ref("approxdpc", "lattice2")
    np.testing.assert_array_equal(eng.result.parent.numpy(),
                                  np.asarray(want.parent))
    np.testing.assert_array_equal(
        eng.labels_, np.asarray(jassign_labels(want, 2.0, 2 * dc).labels))


# ----------------------------------------------------------- distributed
def _tied_parents(pts, got, want) -> int:
    rows = np.nonzero(got != want)[0]
    if rows.size:
        x = _t(pts)
        r = torch.from_numpy(rows)
        assert (got[rows] >= 0).all() and (want[rows] >= 0).all()
        assert torch.equal(
            sweep.direct_d2(x[r], x[torch.from_numpy(got[rows]).long()]),
            sweep.direct_d2(x[r], x[torch.from_numpy(want[rows]).long()]))
    return rows.size


@pytest.mark.parametrize("layout", ["dense", "block-sparse"])
@pytest.mark.parametrize("data", ["lattice2", "mixture"])
def test_distributed_matches_single_device(data, layout):
    """1-4 shards, both strategies: rho, rho_key equal, delta equal, and
    parents equal up to counted exact ties to the single-device ``torch``
    Ex-DPC (and to the reference's single-device ``jnp`` one).  The dense
    gather strategy runs the gather-form stencil phases."""
    pts, dc, exact = _data(data)
    spec = ExecSpec(backend="torch", layout=layout)
    own = run_exdpc(_t(pts), dc, exec_spec=spec)
    ref = _ref("exdpc", data)
    ties = set()
    for shards in (1, 2, 3, 4):
        for strategy in ("gather", "halo"):
            obs.configure("metrics")
            obs.reset_spans()
            try:
                res = distributed_dpc(
                    pts, DistDPCConfig(d_cut=dc, strategy=strategy,
                                       exec_spec=spec),
                    ShardMesh.on("cpu", shards=shards))
            finally:
                obs.configure("off")
            assert torch.equal(res.rho, own.rho)
            assert torch.equal(res.rho_key, own.rho_key)
            assert torch.equal(res.delta, own.delta)
            np.testing.assert_array_equal(res.rho.numpy(),
                                          np.asarray(ref.rho))
            ties.add(_tied_parents(pts, res.parent.numpy(),
                                   own.parent.numpy()))
            _tied_parents(pts, res.parent.numpy(), np.asarray(ref.parent))
            # the stencil phases (halo, or gather in the dense layout)
            # leave the global peak at least to the fallback
            names = [s["name"] for s in obs.spans()]
            assert names.count("dist.fallback") == (
                strategy == "halo" or layout == "dense")
    # the count of tied rows is one per input, whatever the mesh
    assert len(ties) == 1
    if not exact or layout == "block-sparse":
        assert ties == {0}


# ---------------------------------------------------------------- stream
CAP, B, D_CUT = 256, 64, 2000.0


def _stream_data():
    pts, _ = gaussian_mixture(4 * CAP, k=4, d=2, overlap=0.02, seed=5)
    return pts


def _stream_pair(layout, **kw):
    base = dict(d_cut=D_CUT, capacity=CAP, batch_cap=B, rho_min=3.0)
    base.update(kw)
    j = JStreamDPC(JStreamDPCConfig(
        **base, exec_spec=JExecSpec(backend="jnp", layout=layout)))
    p = StreamDPC(StreamDPCConfig(**base, exec_spec=ExecSpec(
        backend="torch", layout=layout)), device="cpu")
    return j, p


def _assert_same_tick(p, j, pt, jt):
    np.testing.assert_array_equal(pt.labels, jt.labels)
    np.testing.assert_array_equal(pt.stable_ids, jt.stable_ids)
    assert (pt.num_clusters, pt.rebuilt, pt.full_recompute, pt.tick) == \
        (jt.num_clusters, jt.rebuilt, jt.full_recompute, jt.tick)
    w = p.window_points()
    thr = f32_d2cut(D_CUT)
    band = near_threshold_rows(w, w, thr, 4 * f32_ulp(thr))
    for name in ("rho", "rho_key"):
        np.testing.assert_array_equal(
            getattr(p.result, name).numpy()[~band],
            np.asarray(getattr(j.result, name))[~band])
    np.testing.assert_array_equal(p.result.parent.numpy(),
                                  np.asarray(j.result.parent))
    np.testing.assert_allclose(p.result.delta.numpy(),
                               np.asarray(j.result.delta), rtol=1e-6)
    assert p.stats() == j.stats()


@pytest.mark.parametrize("layout", ["dense", "block-sparse"])
def test_stream_matches_jnp_tick_by_tick(layout, tmp_path):
    """A ``torch`` stream against the reference's ``jnp`` stream, tick by
    tick; then the reference's checkpoint restores onto ``torch`` and ticks
    as the reference stream does."""
    pts = _stream_data()
    j, p = _stream_pair(layout)
    _assert_same_tick(p, j, p.initialize(pts[:CAP]), j.initialize(pts[:CAP]))
    steps = [pts[CAP:CAP + B], pts[CAP + B:CAP + B + 17],
             pts[CAP + 2 * B:CAP + 2 * B + 150]]
    for batch in steps:
        _assert_same_tick(p, j, p.ingest(batch), j.ingest(batch))
    path = str(tmp_path / "jnp.npz")
    j.save(path)
    r = StreamDPC.restore(path, device="cpu")
    assert r.plan.backend_name == "torch" and r.plan.layout == layout
    for t in range(2):
        batch = pts[CAP + 4 * B + t * B:CAP + 5 * B + t * B]
        _assert_same_tick(r, j, r.ingest(batch), j.ingest(batch))


def test_sharded_stream_engine_and_service_on_torch():
    """The sharded stream, ``DPCEngine.partial_fit`` and ``StreamService``
    on a ``torch`` plan equal the single-device ``torch`` stream tick by
    tick."""
    pts = _stream_data()
    cfg = dict(d_cut=D_CUT, capacity=CAP, batch_cap=B, rho_min=3.0,
               exec_spec=ExecSpec(backend="torch", layout="block-sparse"))
    one = StreamDPC(StreamDPCConfig(**cfg), device="cpu")
    two = StreamDPC(StreamDPCConfig(**cfg),
                    mesh=ShardMesh.on("cpu", shards=2))
    eng = DPCEngine(D_CUT, rho_min=3.0, window_capacity=CAP, batch_cap=B,
                    exec_spec=cfg["exec_spec"], device="cpu")
    svc = StreamService(StreamServeConfig(stream=StreamDPCConfig(**cfg)),
                        device="cpu")
    one.initialize(pts[:CAP])
    two.initialize(pts[:CAP])
    svc.engine.initialize(pts[:CAP])
    eng.fit(pts[:CAP])              # seeds the window of the first tick
    for t in range(3):
        batch = pts[CAP + t * B:CAP + (t + 1) * B]
        a, b = one.ingest(batch), two.ingest(batch)
        np.testing.assert_array_equal(a.labels, b.labels)
        np.testing.assert_array_equal(a.stable_ids, b.stable_ids)
        for x, y in zip(one.result, two.result):
            assert torch.equal(x, y)
        c = svc.submit(batch)
        np.testing.assert_array_equal(c[-1].labels, a.labels)
        eng.partial_fit(batch)
        np.testing.assert_array_equal(eng.labels_, a.labels)
    assert svc.engine.plan.backend_name == "torch"
