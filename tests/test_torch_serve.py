"""The port's stream entry points held against the JAX package's:
``DPCEngine.partial_fit`` / ``predict`` (batch and stream mode, with
quarantined rows) and ``StreamService`` (submit / flush / query)."""
import numpy as np
import pytest
import torch

from repro.data.points import gaussian_mixture
from repro.engine import DPCEngine as JEngine
from repro.engine import ExecSpec as JExecSpec
from repro.resilience.sanitize import AdmissionConfig as JAdmission
from repro.stream import StreamDPC as JStreamDPC
from repro.stream import StreamDPCConfig as JStreamDPCConfig
from repro.stream import StreamServeConfig as JServeConfig
from repro.stream import StreamService as JService

from repro_torch import DPCEngine, ExecSpec
from repro_torch.carry import stream_state
from repro_torch.resilience.sanitize import AdmissionConfig
from repro_torch.stream import (QueryStatus, StreamDPCConfig,
                                StreamServeConfig, StreamService)

CAP, B, D_CUT = 256, 64, 2000.0


def _points(seed):
    pts, _ = gaussian_mixture(3 * CAP, k=4, d=2, overlap=0.02, seed=seed)
    return pts


def _queries(pts, rng):
    """Stream points, points far outside coverage, and NaN rows."""
    q = np.concatenate([pts[rng.permutation(len(pts))[:40]],
                        np.array([[5e8, 5e8], [-5e8, 1e3]], np.float32),
                        np.array([[np.nan, 1.0], [2.0, np.inf]], np.float32)])
    return q[rng.permutation(len(q))]


def _assert_same_query(got, want):
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.status, want.status)


@pytest.mark.parametrize("layout", ["dense", "block-sparse"])
def test_engine_partial_fit_and_predict_match_reference(layout):
    pts = _points(seed=2)
    rng = np.random.default_rng(0)
    kw = dict(rho_min=3.0, window_capacity=CAP, batch_cap=B)
    ref = JEngine(D_CUT, exec_spec=JExecSpec(backend="jnp", layout=layout),
                  admission=JAdmission(policy="drop"), **kw)
    port = DPCEngine(D_CUT, exec_spec=ExecSpec(layout=layout),
                     admission=AdmissionConfig(policy="drop"), device="cpu",
                     **kw)
    ref.fit(pts[:CAP])
    port.fit(pts[:CAP])
    q = _queries(pts, rng)
    got, want = port.predict(q), ref.predict(q)      # batch mode
    _assert_same_query(got, want)
    assert {int(s) for s in got.status} >= {QueryStatus.HIT,
                                            QueryStatus.MISS_FALLBACK,
                                            QueryStatus.QUARANTINED}
    for t in range(3):                                # seeds, then streams
        batch = pts[CAP + t * B:CAP + (t + 1) * B]
        jt, pt = ref.partial_fit(batch), port.partial_fit(batch)
        np.testing.assert_array_equal(pt.labels, jt.labels)
        np.testing.assert_array_equal(port.labels_, ref.labels_)
        np.testing.assert_array_equal(port.result.parent.numpy(),
                                      np.asarray(ref.result.parent))
    assert port.stream.stats() == ref.stream.stats()
    assert port.stream.stats()["full_recomputes"] == 1   # the seeding fit
    q = _queries(pts, rng)
    _assert_same_query(port.predict(q), ref.predict(q))  # stream mode
    # a fit resets the stream: the next partial_fit seeds a new window
    port.fit(pts[:CAP])
    assert port.stream is None
    assert port.partial_fit(pts[-B:]).tick == 2


def test_partial_fit_without_fit_and_engine_rules():
    pts = _points(seed=3)
    kw = dict(rho_min=3.0, window_capacity=CAP, batch_cap=B)
    ref = JEngine(D_CUT, exec_spec=JExecSpec(backend="jnp"), **kw)
    port = DPCEngine(D_CUT, device="cpu", **kw)
    for i in range(0, CAP + B, 2 * B):               # warm-up, then steady
        jt, pt = ref.partial_fit(pts[i:i + 2 * B]), \
            port.partial_fit(pts[i:i + 2 * B])
        np.testing.assert_array_equal(pt.labels, jt.labels)
    assert port.stream.stats() == ref.stream.stats()
    assert port.partial_fit(np.zeros((0, 2), np.float32)) is pt
    with pytest.raises(ValueError):
        DPCEngine(D_CUT, window_capacity=8, batch_cap=9, device="cpu")
    with pytest.raises(ValueError):
        DPCEngine(D_CUT, algorithm="exdpc", device="cpu").partial_fit(pts)
    with pytest.raises(ValueError):
        DPCEngine(D_CUT, device="cpu").predict(pts)


def test_stream_entry_points_target_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DPCEngine(D_CUT)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamService(StreamServeConfig(stream=StreamDPCConfig(d_cut=1.0)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        stream_state(JStreamDPC(JStreamDPCConfig(d_cut=1.0)))


def test_service_matches_reference():
    pts = _points(seed=4)
    rng = np.random.default_rng(1)
    jcfg = JStreamDPCConfig(d_cut=D_CUT, capacity=CAP, batch_cap=B,
                            rho_min=3.0, exec_spec=JExecSpec(backend="jnp"))
    ref = JService(JServeConfig(stream=jcfg))
    port = StreamService(StreamServeConfig(stream=StreamDPCConfig(
        d_cut=D_CUT, capacity=CAP, batch_cap=B, rho_min=3.0)), device="cpu")
    ref.engine.initialize(pts[:CAP])
    port.engine.initialize(pts[:CAP])
    for sl in (slice(CAP, CAP + B // 2), slice(CAP + B // 2, CAP + 2 * B + 10)):
        jt, pt = ref.submit(pts[sl]), port.submit(pts[sl])
        assert len(pt) == len(jt)
        for a, b in zip(pt, jt):
            np.testing.assert_array_equal(a.labels, b.labels)
        assert port.stats() == ref.stats()
    q = _queries(pts, rng)
    q = q[np.isfinite(q).all(1)]
    _assert_same_query(port.query(q), ref.query(q))
    assert port.flush().tick == ref.flush().tick
    assert port.flush() is None
    assert port.stats() == ref.stats()
    _assert_same_query(port.query(q), ref.query(q))
    # poisoned writes are refused at submit, as in the reference
    with pytest.raises(ValueError):
        port.submit(np.array([[np.nan, 0.0]], np.float32))
