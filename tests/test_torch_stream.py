"""The port's ``StreamDPC`` held against the JAX package's, tick by tick.

Both packages get the same numpy batches.  The reference runs its ``jnp``
backend (its Pallas plans do not run on the installed jax; ROADMAP
"Reference gaps"); the port runs the plain versions of its kernels on the
CPU.  Per tick: rho and rho_key equal off the threshold band, parent
equal, delta to f32 rounding, labels / stable ids / centers / ``stats()``
equal.  The port's stream is also held against its own from-scratch fit
of the window, and a failed tick must roll back bit for bit.
"""
import numpy as np
import pytest
import torch

from repro.data.points import gaussian_mixture
from repro.engine import ExecSpec as JExecSpec
from repro.stream import StreamDPC as JStreamDPC
from repro.stream import StreamDPCConfig as JStreamDPCConfig
from repro.stream import StreamServeConfig as JServeConfig
from repro.stream import StreamService as JService

from repro_torch import ExecSpec
from repro_torch.carry import stream_state
from repro_torch.core.approxdpc import run_approxdpc
from repro_torch.core.labels import assign_labels
from repro_torch.kernels.sweep import direct_d2
from repro_torch.resilience.checkpoint import CheckpointError
from repro_torch.stream import (StreamDPC, StreamDPCConfig,
                                StreamServeConfig, StreamService)

from _torch_ref import f32_d2cut, f32_ulp, near_threshold_rows

CAP, B, D_CUT, RHO_MIN = 256, 64, 2000.0, 3.0


def _pair(layout="dense", **kw):
    base = dict(d_cut=D_CUT, capacity=CAP, batch_cap=B, rho_min=RHO_MIN)
    base.update(kw)
    j = JStreamDPC(JStreamDPCConfig(
        **base, exec_spec=JExecSpec(backend="jnp", layout=layout)))
    p = StreamDPC(StreamDPCConfig(**base, exec_spec=ExecSpec(layout=layout)),
                  device="cpu")
    return j, p


def _data(seed=5):
    """Four tight clusters far apart (the dirty radius at d_cut = 2000 is
    about 5,700), so a batch from one cluster leaves the others clean."""
    pts, lab = gaussian_mixture(4 * CAP, k=4, d=2, overlap=0.02, seed=seed)
    return pts, lab


def _assert_same_tick(p, j, pt, jt):
    np.testing.assert_array_equal(pt.labels, jt.labels)
    np.testing.assert_array_equal(pt.stable_ids, jt.stable_ids)
    np.testing.assert_array_equal(pt.centers, np.asarray(jt.centers))
    assert (pt.num_clusters, pt.rebuilt, pt.full_recompute, pt.tick) == \
        (jt.num_clusters, jt.rebuilt, jt.full_recompute, jt.tick)
    w = p.window_points()
    np.testing.assert_array_equal(w, j.window_points())
    thr = f32_d2cut(D_CUT)
    band = near_threshold_rows(w, w, thr, 4 * f32_ulp(thr))
    tr, jr = p.result, j.result
    for name in ("rho", "rho_key"):
        np.testing.assert_array_equal(getattr(tr, name).numpy()[~band],
                                      np.asarray(getattr(jr, name))[~band])
    np.testing.assert_array_equal(tr.parent.numpy(), np.asarray(jr.parent))
    np.testing.assert_allclose(tr.delta.numpy(), np.asarray(jr.delta),
                               rtol=1e-6)
    assert p.stats() == j.stats()
    ids, pos = p.center_positions()
    jids, jpos = j.center_positions()
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(pos, jpos)


def _assert_matches_fresh_fit(p):
    """The stream equals the port's from-scratch fit of its window: rho,
    rho_key and delta bit for bit, parents equal or equally near."""
    w = torch.from_numpy(p.window_points())
    fresh = run_approxdpc(w, D_CUT, exec_spec=p.plan.spec)
    res = p.result
    for name in ("rho", "rho_key", "delta"):
        assert torch.equal(getattr(fresh, name), getattr(res, name)), name
    rows = torch.nonzero(fresh.parent != res.parent).flatten()
    assert torch.equal(direct_d2(w[rows], w[fresh.parent[rows].long()]),
                       direct_d2(w[rows], w[res.parent[rows].long()]))
    cl = assign_labels(fresh, RHO_MIN, 2 * D_CUT)
    assert torch.equal(cl.centers, p.clustering.centers)


@pytest.mark.parametrize("layout", ["dense", "block-sparse"])
@pytest.mark.parametrize("dirty", [True, False])
def test_stream_matches_reference_tick_by_tick(layout, dirty):
    """Warm-up by ingest alone, scattered, localized, partial and oversize
    batches, and drift out of the indexed box (a rebuild)."""
    pts, lab = _data()
    j, p = _pair(layout, dirty_tracking=dirty, extent_margin=1)
    one = pts[lab == 0]
    far = np.random.default_rng(0).normal(
        [9.7e4, 9.7e4], 400.0, (B, 2)).astype(np.float32)
    steps = [pts[:CAP],                       # warm-up: CAP / B full ticks
             pts[CAP:CAP + B],                # scattered
             one[:17],                        # localized, partial
             pts[CAP + B:CAP + B + 150],      # oversize: three chunks
             far,                             # drift: rebuild
             one[17:17 + B]]                  # localized after the rebuild
    rebuilt = 0
    for batch in steps:
        jt, pt = j.ingest(batch), p.ingest(batch)
        _assert_same_tick(p, j, pt, jt)
        rebuilt += pt.rebuilt
    assert rebuilt == 1 and p.stats()["full_recomputes"] == CAP // B
    s = p.stats()
    if dirty:       # the localized batches left clean maxima to reuse
        assert s["nn_queries"] < s["nn_maxima_total"]
    else:
        assert s["nn_queries"] == s["nn_maxima_total"]
    _assert_matches_fresh_fit(p)


def test_initialize_then_steady_matches_fresh_fit():
    pts, _ = _data(seed=7)
    p = StreamDPC(StreamDPCConfig(d_cut=D_CUT, capacity=CAP, batch_cap=B,
                                  rho_min=RHO_MIN), device="cpu")
    p.initialize(pts[:CAP])
    for t in range(4):
        p.ingest(pts[CAP + t * B:CAP + (t + 1) * B])
        _assert_matches_fresh_fit(p)
    with pytest.raises(ValueError):
        p.initialize(pts[:CAP + 1])
    with pytest.raises(ValueError):
        p.ingest(np.zeros((3, 3), np.float32))
    assert p.ingest(np.zeros((0, 2), np.float32)) is p._last


def _state(p):
    w, g = p.window, p.grid
    return (w.host.copy(), w.device.clone(), w.count, w.cursor, w.ticks,
            g.seg_np.copy(), g.seg_dev.clone(), g.cell_count.copy(),
            dict(g.key_to_id), p._rho.clone(), p._nn_valid.copy(),
            p._nn_delta_cache.copy(), p.stats())


def _assert_same_state(a, b):
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y)
        elif isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        else:
            assert x == y


def test_failed_tick_rolls_back_bit_for_bit(monkeypatch):
    """The tick raises after the push and the grid update have changed the
    window table and the segment ids in place: the rollback restores them,
    rho and the host state bit for bit, and a replay equals an
    uninterrupted run."""
    pts, _ = _data(seed=9)
    cfg = StreamDPCConfig(d_cut=D_CUT, capacity=CAP, batch_cap=B,
                          rho_min=RHO_MIN)
    p = StreamDPC(cfg, device="cpu")
    twin = StreamDPC(cfg, device="cpu")
    for s in (p, twin):
        s.initialize(pts[:CAP])
        s.ingest(pts[CAP:CAP + B])
    before = _state(p)
    last = p._last
    batch = pts[CAP + B:CAP + 2 * B]

    seen = []

    def boom(*a, **k):
        seen.append((torch.equal(p.window.device, before[1]),
                     torch.equal(p.grid.seg_dev, before[6])))
        raise RuntimeError("injected fault in the fresh counts")

    monkeypatch.setattr(p.be, "range_count", boom)
    with pytest.raises(RuntimeError, match="injected"):
        p.ingest(batch)
    # the failed tick had changed both device tables in place
    assert seen == [(False, False)]
    _assert_same_state(_state(p), before)
    assert p._last is last
    monkeypatch.undo()
    got, want = p.ingest(batch), twin.ingest(batch)
    np.testing.assert_array_equal(got.labels, want.labels)
    for a, b in zip(p.result, twin.result):
        assert torch.equal(a, b)
    _assert_same_state(_state(p), _state(twin))


def test_carried_state_continues_the_reference_stream():
    pts, lab = _data(seed=11)
    j, _ = _pair("dense")
    j.initialize(pts[:CAP])
    j.ingest(pts[CAP:CAP + B])
    j.ingest(pts[lab == 1][:20])
    p = stream_state(j, device="cpu")
    assert p.stats() == j.stats()
    for t in range(3):
        batch = pts[CAP + (t + 1) * B:CAP + (t + 2) * B]
        _assert_same_tick(p, j, p.ingest(batch), j.ingest(batch))


def test_mesh_and_checkpoints_are_not_ported(tmp_path):
    """Once the raises of the unported mesh and checkpoints; both are
    ported now (tests/test_torch_sharded_stream.py,
    tests/test_torch_checkpoint.py), and these are their refusals."""
    cfg = StreamDPCConfig(d_cut=1.0)
    with pytest.raises(TypeError, match="ShardMesh"):
        StreamDPC(cfg, mesh=object(), device="cpu")
    s = StreamDPC(cfg, device="cpu")
    with pytest.raises(ValueError, match="window state"):
        s.save(str(tmp_path / "x.npz"))
    with pytest.raises(CheckpointError):
        StreamDPC.restore(str(tmp_path / "x.npz"), device="cpu")
    with pytest.raises(ValueError):
        StreamDPCConfig(d_cut=1.0, capacity=8, batch_cap=9)
    with pytest.raises(TypeError):
        StreamDPCConfig(d_cut=1.0, exec_spec="cuda")


def test_stats_before_the_window_fills():
    """Before the window first fills (no grid rebuild yet) ``stats()``
    reports ``live_cells`` and ``maxima_cap`` as 0, and the service's stats
    follow; the reference's raise AttributeError there, a divergence
    listed in ROADMAP "Reference gaps"."""
    cfg = dict(d_cut=0.5, capacity=256, batch_cap=64, rho_min=2.0)
    pts = np.random.default_rng(1).normal(size=(100, 2)).astype(
        np.float32)[:64]
    p = StreamDPC(StreamDPCConfig(**cfg), device="cpu")
    p.ingest(pts)
    svc = StreamService(StreamServeConfig(stream=StreamDPCConfig(**cfg)),
                        device="cpu")
    svc.submit(pts)
    for s in (p.stats(), svc.stats()):
        assert s["count"] == 64 and s["rebuilds"] == 0, s
        assert s["live_cells"] == 0 and s["maxima_cap"] == 0, s
    j = JStreamDPC(JStreamDPCConfig(**cfg))
    j.ingest(pts)
    with pytest.raises(AttributeError, match="live_cells"):
        j.stats()
    ref = JService(JServeConfig(stream=JStreamDPCConfig(**cfg)))
    ref.submit(pts)
    with pytest.raises(AttributeError, match="live_cells"):
        ref.stats()
