"""The port's resilience slice: fault injection, transactional ticks at
every ``tick.*`` site, stream checkpoints (atomic writes, rejected files,
restores onto other shard counts) and the chaos kill/restore suite, ported
from the JAX package's ``tests/test_resilience.py`` (its ``TestFaultInject``,
``TestTransactionalIngest``, ``TestCheckpoint`` and the chaos cases), with
the 4 -> 1 shard restore, and ``sanitize.finite_or``."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import ExecSpec, obs
from repro_torch.data.points import gaussian_mixture
from repro_torch.engine.planner import plan
from repro_torch.launch import ShardMesh
from repro_torch.resilience import checkpoint, faultinject
from repro_torch.resilience.sanitize import finite_or
from repro_torch.stream import (StreamDPC, StreamDPCConfig,
                                StreamServeConfig, StreamService)

SRC = Path(__file__).resolve().parents[1] / "src"
CAP, B, D_CUT, RHO_MIN = 512, 64, 8000.0, 3.0


def _cfg(layout="dense", **kw):
    base = dict(d_cut=D_CUT, capacity=CAP, batch_cap=B, rho_min=RHO_MIN,
                exec_spec=ExecSpec(layout=layout))
    base.update(kw)
    return StreamDPCConfig(**base)


def _data(ticks=3, seed=2):
    pts, _ = gaussian_mixture(CAP + ticks * B, k=4, d=2, overlap=0.05,
                              seed=seed)
    return pts


def _batch(pts, t):
    return pts[CAP + t * B: CAP + (t + 1) * B]


def _new(shards=None, layout="dense", **kw):
    if shards is None:
        return StreamDPC(_cfg(layout, **kw), device="cpu")
    return StreamDPC(_cfg(layout, **kw),
                     mesh=ShardMesh.on("cpu", shards=shards))


def _stream(ticks=2, shards=None, **kw):
    pts = _data(ticks=max(ticks, 3))
    s = _new(shards, **kw)
    s.initialize(pts[:CAP])
    for t in range(ticks):
        s.ingest(_batch(pts, t))
    return s, pts


def _assert_same_state(r: StreamDPC, ref: StreamDPC, tick, t_ref):
    np.testing.assert_array_equal(tick.labels, t_ref.labels)
    np.testing.assert_array_equal(tick.stable_ids, t_ref.stable_ids)
    assert torch.equal(r._rho, ref._rho)
    for name in ("delta", "parent", "rho_key"):
        assert torch.equal(getattr(r.result, name),
                           getattr(ref.result, name)), name


@pytest.fixture(autouse=True)
def _no_leftover_faults():
    """Every test starts and ends with no armed fault plan."""
    faultinject.deactivate()
    yield
    faultinject.deactivate()


# ------------------------------------------------------------ faultinject
class TestFaultInject:
    def test_fires_on_nth_hit(self):
        faultinject.activate("tick.finish", trigger=3)
        faultinject.fire("tick.finish")
        faultinject.fire("tick.finish")
        with pytest.raises(faultinject.FaultError):
            faultinject.fire("tick.finish")
        faultinject.fire("tick.finish")     # one-shot: hit 4 does not fire

    def test_trigger_zero_fires_every_hit(self):
        faultinject.activate("kernel.dispatch", trigger=0)
        for _ in range(3):
            with pytest.raises(faultinject.FaultError):
                faultinject.fire("kernel.dispatch")

    def test_other_sites_unaffected(self):
        faultinject.activate("tick.rho_repair", trigger=1)
        faultinject.fire("tick.finish")
        faultinject.fire("checkpoint.write")

    def test_seed_trigger_is_deterministic(self):
        t1 = faultinject.activate("tick.finish", seed=7).trigger
        t2 = faultinject.activate("tick.finish", seed=7).trigger
        t3 = faultinject.activate("tick.finish", seed=8).trigger
        assert t1 == t2 and t1 >= 1 and t3 >= 1

    def test_unknown_site_or_mode_fails_loudly(self):
        with pytest.raises(ValueError, match="unknown fault site"):
            faultinject.activate("tick.typo")
        with pytest.raises(ValueError, match="unknown fault mode"):
            faultinject.activate("tick.finish", mode="explode")

    def test_corrupt_mode_never_raises_at_fire(self):
        faultinject.activate("checkpoint.write", mode="corrupt", trigger=1)
        faultinject.fire("checkpoint.write")
        assert faultinject.should_corrupt("checkpoint.write")
        assert not faultinject.should_corrupt("checkpoint.serialize")

    def test_sites_and_counter_match_the_reference(self):
        from repro.resilience import faultinject as ref
        assert faultinject.KNOWN_SITES == ref.KNOWN_SITES
        assert faultinject.MODES == ref.MODES
        assert faultinject.KILL_EXIT_CODE == ref.KILL_EXIT_CODE == 42
        for seed in range(8):
            assert faultinject._seed_trigger(seed) == ref._seed_trigger(seed)
        m = obs.counter("resilience_faults_injected_total")
        before = m.value(site="tick.finish", mode="raise")
        faultinject.activate("tick.finish")
        with pytest.raises(faultinject.FaultError):
            faultinject.fire("tick.finish")
        assert m.value(site="tick.finish", mode="raise") == before + 1
        with faultinject.suspended():
            assert faultinject.active() is None
            faultinject.fire("tick.finish")
        assert faultinject.active().hits == 1

    def test_service_and_plan_sites(self):
        pts = _data(ticks=1)
        svc = StreamService(StreamServeConfig(stream=_cfg()), device="cpu")
        faultinject.activate("service.submit")
        with pytest.raises(faultinject.FaultError):
            svc.submit(pts[:B])
        assert svc.stats()["buffered"] == 0
        pl = plan(None, ExecSpec())
        x = torch.from_numpy(pts[:32])
        k = torch.arange(32, dtype=torch.float32)
        faultinject.activate("kernel.dispatch", trigger=0)
        with pytest.raises(faultinject.FaultError):
            pl.denser_nn(x, k, x, k)
        with pytest.raises(faultinject.FaultError):
            pl.rho_delta(x, x, D_CUT)
        faultinject.deactivate()
        assert int(pl.denser_nn(x, k, x, k)[1][31]) == -1   # disarmed


# ---------------------------------------------------- transactional ingest
class TestTransactionalIngest:
    @pytest.mark.parametrize("shards", [None, 4])
    @pytest.mark.parametrize("site", ["tick.grid_apply", "tick.rho_repair",
                                      "tick.nn_update", "tick.finish"])
    def test_failed_tick_rolls_back_and_replays_bit_identical(self, site,
                                                              shards):
        pts = _data(ticks=2)
        control = _new(shards)
        control.initialize(pts[:CAP])
        control.ingest(_batch(pts, 0))
        t_ref = control.ingest(_batch(pts, 1))

        s = _new(shards)
        s.initialize(pts[:CAP])
        s.ingest(_batch(pts, 0))
        pre_host = s.window.host.copy()
        pre_dev = s.window.device.clone()
        pre_seg = s.grid.seg_dev.clone()
        pre_rho = s._rho.clone()
        pre_stats = s.stats()
        faultinject.activate(site, trigger=1)
        with pytest.raises(faultinject.FaultError):
            s.ingest(_batch(pts, 1))
        faultinject.deactivate()
        # rollback: window, grid, rho and counters exactly pre-tick
        np.testing.assert_array_equal(s.window.host, pre_host)
        assert torch.equal(s.window.device, pre_dev)
        assert torch.equal(s.grid.seg_dev, pre_seg)
        assert torch.equal(s._rho, pre_rho)
        assert s.stats() == pre_stats
        # replaying the failed batch matches the never-faulted control
        _assert_same_state(s, control, s.ingest(_batch(pts, 1)), t_ref)

    def test_transactional_off_skips_snapshots(self):
        s, pts = _stream(ticks=1, transactional=False)
        faultinject.activate("tick.finish", trigger=1)
        with pytest.raises(faultinject.FaultError):
            s.ingest(_batch(pts, 1))


# ------------------------------------------------------------- checkpoints
class TestCheckpoint:
    @pytest.mark.parametrize("layout", ["dense", "block-sparse"])
    @pytest.mark.parametrize("saved,restored", [(None, None), (4, None),
                                                (None, 4), (4, 2)])
    def test_restore_ticks_bit_identical(self, layout, saved, restored,
                                         tmp_path):
        ticks = 3
        pts = _data(ticks=ticks)
        ref = _new(None, layout)
        ref.initialize(pts[:CAP])
        for t in range(ticks):
            t_ref = ref.ingest(_batch(pts, t))

        s = _new(saved, layout)
        s.initialize(pts[:CAP])
        s.ingest(_batch(pts, 0))
        p = str(tmp_path / "ckpt.npz")
        s.save(p)
        mesh = None if restored is None else ShardMesh.on("cpu",
                                                         shards=restored)
        r = StreamDPC.restore(p, mesh=mesh, device="cpu")
        assert r.stats() == s.stats()
        assert (r.mesh is None) == (restored is None)
        for t in range(1, ticks):
            tick = r.ingest(_batch(pts, t))
        _assert_same_state(r, ref, tick, t_ref)

    def test_warmup_state_round_trips(self, tmp_path):
        pts = _data(ticks=0)
        s = _new()
        s.initialize(pts[: CAP // 2])       # below capacity: grid unbuilt
        p = str(tmp_path / "warm.npz")
        s.save(p)
        r = StreamDPC.restore(p, device="cpu")
        t1 = r.ingest(pts[CAP // 2: CAP // 2 + B])
        t2 = s.ingest(pts[CAP // 2: CAP // 2 + B])
        np.testing.assert_array_equal(t1.labels, t2.labels)

    def test_save_before_data_raises(self, tmp_path):
        with pytest.raises(ValueError, match="window state"):
            _new().save(str(tmp_path / "x.npz"))

    def test_atomic_write_keeps_previous_checkpoint(self, tmp_path):
        s, pts = _stream(ticks=2)
        p = str(tmp_path / "ckpt.npz")
        s.save(p)
        ticks_saved = s._ticks
        s.ingest(_batch(pts, 2))
        faultinject.activate("checkpoint.write", trigger=1)
        with pytest.raises(faultinject.FaultError):
            s.save(p)
        faultinject.deactivate()
        r = StreamDPC.restore(p, device="cpu")   # the previous file, intact
        assert r._ticks == ticks_saved
        faultinject.activate("checkpoint.serialize", trigger=1)
        with pytest.raises(faultinject.FaultError):
            s.save(p)
        assert StreamDPC.restore(p, device="cpu")._ticks == ticks_saved

    def test_corrupted_file_raises_checkpoint_error(self, tmp_path):
        s, _ = _stream(ticks=1)
        p = str(tmp_path / "ckpt.npz")
        faultinject.activate("checkpoint.write", mode="corrupt", trigger=1)
        s.save(p)
        faultinject.deactivate()
        with pytest.raises(checkpoint.CheckpointError):
            StreamDPC.restore(p, device="cpu")

    def test_garbage_file_raises_checkpoint_error(self, tmp_path):
        p = tmp_path / "junk.npz"
        p.write_bytes(b"not a checkpoint")
        with pytest.raises(checkpoint.CheckpointError):
            StreamDPC.restore(str(p), device="cpu")
        with pytest.raises(checkpoint.CheckpointError):
            StreamDPC.restore(str(tmp_path / "missing.npz"), device="cpu")

    def test_future_version_raises_checkpoint_error(self, tmp_path):
        meta = {"format": checkpoint.FORMAT, "version": checkpoint.VERSION + 1}
        p = str(tmp_path / "future.npz")
        np.savez(p, meta=np.frombuffer(json.dumps(meta).encode(), np.uint8))
        with pytest.raises(checkpoint.CheckpointError, match="version"):
            StreamDPC.restore(p, device="cpu")

    def _rewrite(self, src, dst, **exec_fields):
        """A copy of checkpoint ``src`` with its meta's exec fields (and
        the fingerprint, unless given) changed."""
        z = dict(np.load(src))
        meta = json.loads(bytes(z["meta"]).decode())
        fp = exec_fields.pop("fingerprint", None)
        meta["exec"].update(exec_fields)
        ex = meta["exec"]
        meta["fingerprint"] = fp or (f"{ex['backend'] or 'auto'}:"
                                     f"{ex['layout'] or 'dense'}:"
                                     f"{ex['precision'] or 'f32'}")
        z["meta"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
        np.savez(dst, **z)
        return dst

    def test_exec_fields_map_as_carry_maps_them(self, tmp_path):
        s, pts = _stream(ticks=1)
        p = str(tmp_path / "ckpt.npz")
        s.save(p)
        want = s.ingest(_batch(pts, 1))
        for backend in ("pallas", "pallas-interpret", "auto", "cuda"):
            q = self._rewrite(p, str(tmp_path / f"{backend}.npz"),
                              backend=backend)
            r = StreamDPC.restore(q, device="cpu")
            assert r.plan.backend_name == "cuda"
            np.testing.assert_array_equal(r.ingest(_batch(pts, 1)).labels,
                                          want.labels)
        q = self._rewrite(p, str(tmp_path / "jnp.npz"), backend="jnp")
        with pytest.raises(checkpoint.CheckpointError,
                           match="Queue A item 1"):
            StreamDPC.restore(q, device="cpu")
        q = self._rewrite(p, str(tmp_path / "fp.npz"),
                          fingerprint="auto:block-sparse:f32")
        with pytest.raises(checkpoint.CheckpointError, match="fingerprint"):
            StreamDPC.restore(q, device="cpu")

    def test_mesh_that_does_not_divide_raises(self, tmp_path):
        s, _ = _stream(ticks=1)
        p = str(tmp_path / "ckpt.npz")
        s.save(p)
        with pytest.raises(ValueError, match=r"3 shards.*capacity 512"):
            StreamDPC.restore(p, mesh=ShardMesh.on("cpu", shards=3))


# ------------------------------------------------------------- chaos suite
# A subprocess runs the stream on 4 CPU shards with a checkpoint after
# every tick and an env-armed kill fault; the parent restores the last
# checkpoint onto one device and proves the resumed run bit-identical to
# an uninterrupted single-device one.
_CHAOS_SCRIPT = r"""
import sys
from repro_torch.data.points import gaussian_mixture
from repro_torch.launch import ShardMesh
from repro_torch.stream import StreamDPC, StreamDPCConfig

ckpt = sys.argv[1]
CAP, B, TICKS = 512, 64, 4
pts, _ = gaussian_mixture(CAP + TICKS * B, k=4, d=2, overlap=0.05, seed=2)
s = StreamDPC(StreamDPCConfig(d_cut=8000.0, capacity=CAP, batch_cap=B,
                              rho_min=3.0),
              mesh=ShardMesh.on("cpu", shards=4))
s.initialize(pts[:CAP])
s.save(ckpt)
for t in range(TICKS):
    s.ingest(pts[CAP + t * B: CAP + (t + 1) * B])   # the fault kills here
    s.save(ckpt)
print("SURVIVED")   # only reached when no fault is armed
"""


class TestChaosCrashRestore:
    @pytest.mark.parametrize("site,trigger", [
        ("tick.grid_apply", 2), ("tick.rho_repair", 2),
        ("tick.nn_update", 2),
        # initialize's full tick hits tick.finish once already
        ("tick.finish", 3),
        # between the temp write and the rename: the old file must survive
        ("checkpoint.write", 3),
    ])
    def test_kill_restore_parity(self, site, trigger, tmp_path):
        """Kill the 4-shard stream mid-tick at every injection site,
        restore the last checkpoint onto one device, replay: bit-identical
        to the uninterrupted run."""
        ticks = 4
        pts = _data(ticks=ticks)
        ref = _new()
        ref.initialize(pts[:CAP])
        for t in range(ticks):
            t_ref = ref.ingest(_batch(pts, t))

        ckpt = str(tmp_path / f"chaos-{site.replace('.', '-')}.npz")
        env = dict(os.environ, PYTHONPATH=str(SRC), REPRO_FAULT_SITE=site,
                   REPRO_FAULT_MODE="kill", REPRO_FAULT_TRIGGER=str(trigger))
        proc = subprocess.run([sys.executable, "-c", _CHAOS_SCRIPT, ckpt],
                              env=env, capture_output=True, text=True,
                              timeout=300)
        assert proc.returncode == faultinject.KILL_EXIT_CODE, \
            (proc.returncode, proc.stderr[-2000:])
        assert "SURVIVED" not in proc.stdout
        r = StreamDPC.restore(ckpt, device="cpu")
        done = r.stats()["ticks"] - 1      # initialize counts one tick
        assert 0 <= done < ticks
        for t in range(done, ticks):
            tick = r.ingest(_batch(pts, t))
        _assert_same_state(r, ref, tick, t_ref)


# ---------------------------------------------------------------- sanitize
def test_finite_or():
    x = torch.tensor([1.0, float("inf"), float("-inf"), float("nan")])
    assert finite_or(x, 7.0).tolist() == [1.0, 7.0, 7.0, 7.0]
    d = torch.tensor([0.5, float("inf")], dtype=torch.float64)
    out = finite_or(d, torch.tensor(2.0))
    assert out.dtype == torch.float64 and out.tolist() == [0.5, 2.0]
