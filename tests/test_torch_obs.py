"""The port's observability (``repro_torch.obs``): the tracer with its
JSON-lines sink, the metrics registry, the report and its CLI, held
against the reference's ``tests/test_obs.py`` (``TestTracer``,
``TestMetrics``, ``TestReport``) and against ``repro.obs`` itself: on the
same span records and snapshot both render the same strings, and traces
cross between the packages in both directions."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.engine import DPCEngine as JEngine
from repro.engine import ExecSpec as JExecSpec
from repro.obs import report as jreport

from repro_torch import DPCEngine, ExecSpec, obs
from repro_torch.kernels import blocksparse
from repro_torch.obs import report
from repro_torch.obs.__main__ import main as obs_main

SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(autouse=True)
def _clean_obs():
    obs.configure(level="off", trace_path=None)
    obs.reset_spans()
    yield
    obs.configure(level="off", trace_path=None)
    obs.reset_spans()


def _blobs(n=256, d=2, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, 6000.0, (4, d))
    return (centers[rng.integers(0, 4, n)]
            + rng.normal(0, 150.0, (n, d))).astype(np.float32)


def _recs():
    """The reference's ``TestReport`` records."""
    return [
        {"name": "fit", "path": "fit", "id": 1, "parent": None,
         "depth": 0, "t0": 0.0, "host_s": 1.0, "device_s": 0.6},
        {"name": "rho", "path": "fit/rho", "id": 2, "parent": 1,
         "depth": 1, "t0": 0.1, "host_s": 0.7, "device_s": 0.5},
    ]


def _tree():
    """A deeper tree: repeated paths, an error, spans with no device time
    and times in each of the table's units."""
    recs = []
    for rep in range(3):
        base = 10 * rep + 10
        recs += [
            {"name": "sweep", "path": "fit/rho/sweep", "id": base + 3,
             "parent": base + 2, "depth": 2, "t0": 0.2,
             "host_s": 0.0004 * (rep + 1), "device_s": 0.0003},
            {"name": "rho", "path": "fit/rho", "id": base + 2,
             "parent": base + 1, "depth": 1, "t0": 0.1,
             "host_s": 0.002 * (rep + 1), "device_s": None},
            {"name": "labels", "path": "fit/labels", "id": base + 4,
             "parent": base + 1, "depth": 1, "t0": 0.3, "host_s": 2.5,
             "device_s": 1.25, "error": "RuntimeError"},
            {"name": "fit", "path": "fit", "id": base + 1, "parent": None,
             "depth": 0, "t0": 0.0, "host_s": 3.0, "device_s": None,
             "attrs": {"n": 7}},
        ]
    return recs


def _snap():
    return {
        "plan_cache_hits": {"kind": "counter", "help": "", "values": {"": 2}},
        "worklist_len": {"kind": "gauge", "help": "h",
                         "values": {"": 17, "a=1,b=x": 0.25}},
        "fit_seconds": {
            "kind": "histogram", "help": "",
            "values": {"": {"count": 3, "sum": 0.006, "min": 0.001,
                            "max": 0.003}}},
        "empty": {"kind": "counter", "help": "", "values": {}},
    }


# --------------------------------------------------------------- tracer
class TestTracer:
    def test_off_returns_null_singleton(self):
        s1 = obs.span("a", n=3)
        s2 = obs.span("b")
        assert s1 is obs.NULL_SPAN and s2 is obs.NULL_SPAN
        x = object()
        with s1 as sp:
            assert sp.sync(x) is x
            sp.set(ignored=1)
        assert obs.spans() == []
        assert obs.level() == "off" and not obs.enabled()
        assert not obs.tracing()

    def test_metrics_level_host_time_only(self):
        obs.configure(level="metrics")
        assert obs.enabled() and not obs.tracing()
        with obs.span("phase", n=7):
            pass
        (rec,) = obs.spans()
        assert rec["name"] == "phase" and rec["path"] == "phase"
        assert rec["host_s"] >= 0.0 and rec["t0"] >= 0.0
        assert rec["device_s"] is None
        assert rec["attrs"] == {"n": 7}

    def test_trace_level_fences_device_time(self):
        obs.configure(level="trace")
        assert obs.tracing()
        with obs.span("compute") as sp:
            out = sp.sync(torch.arange(1024.0).sum())
        assert float(out) == 1024.0 * 1023.0 / 2.0
        (rec,) = obs.spans()
        assert rec["device_s"] is not None and rec["device_s"] >= 0.0
        assert rec["host_s"] >= rec["device_s"]

    def test_nesting_paths_and_parents(self):
        obs.configure(level="metrics")
        with obs.span("outer"):
            with obs.span("mid"):
                with obs.span("inner"):
                    pass
        recs = {r["name"]: r for r in obs.spans()}
        assert recs["outer"]["path"] == "outer"
        assert recs["mid"]["path"] == "outer/mid"
        assert recs["inner"]["path"] == "outer/mid/inner"
        assert recs["inner"]["depth"] == 2
        assert recs["mid"]["parent"] == recs["outer"]["id"]
        assert recs["inner"]["t0"] >= recs["outer"]["t0"]

    def test_exception_closes_span(self):
        obs.configure(level="metrics")
        with pytest.raises(RuntimeError):
            with obs.span("boom"):
                raise RuntimeError("x")
        (rec,) = obs.spans()
        assert rec["error"] == "RuntimeError"
        with obs.span("after"):
            pass
        assert obs.spans()[-1]["path"] == "after"

    def test_jsonl_roundtrip_both_ways(self, tmp_path):
        """A port trace loads in both reports with the reference's keys;
        the reference's own trace loads in the port's."""
        path = str(tmp_path / "trace.jsonl")
        obs.configure(level="trace", trace_path=path)
        with obs.span("a", n=1):
            with obs.span("b"):
                pass
        obs.flush()
        obs.configure(trace_path=None)
        for load in (report.load_trace, jreport.load_trace):
            recs = load(path)
            assert [r["path"] for r in recs] == ["a/b", "a"]
            assert all({"id", "host_s", "t0", "depth"} <= set(r)
                       for r in recs)
        jpath = str(tmp_path / "ref.jsonl")
        jobs.configure(level="trace", trace_path=jpath)
        try:
            with jobs.span("x"):
                with jobs.span("y"):
                    pass
            jobs.flush()
        finally:
            jobs.configure(level="off", trace_path=None)
            jobs.reset_spans()
        assert [r["path"] for r in report.load_trace(jpath)] == ["x/y", "x"]
        assert report.aggregate(report.load_trace(jpath)) == \
            jreport.aggregate(jreport.load_trace(jpath))

    def test_configure_keeps_what_it_is_not_given(self, tmp_path):
        path = str(tmp_path / "t.jsonl")
        obs.configure(level="metrics", trace_path=path)
        obs.configure(level="trace")             # the sink stays
        with obs.span("kept"):
            pass
        obs.configure(trace_path=None)           # the level stays
        assert obs.level() == "trace"
        with obs.span("memory only"):
            pass
        assert [r["name"] for r in report.load_trace(path)] == ["kept"]
        assert [r["name"] for r in obs.spans()] == ["kept", "memory only"]

    def test_configure_rejects_bad_level(self):
        with pytest.raises(ValueError, match="level"):
            obs.configure(level="verbose")

    def test_profile_dir_captures_until_off(self, tmp_path):
        d = tmp_path / "prof"
        obs.configure(level="metrics", profile_dir=str(d))
        with obs.span("profiled"):
            torch.ones(64).sum()
        obs.configure(level="off")
        assert any(p.name.endswith(".pt.trace.json") for p in d.iterdir())

    def test_environment_activation(self, tmp_path):
        """``REPRO_OBS`` / ``REPRO_OBS_TRACE`` configure the tracer at
        import, as the reference's do; a bad level warns and is ignored."""
        path = tmp_path / "env.jsonl"
        code = ("import repro_torch.obs as o\n"
                "with o.span('env', k=1):\n"
                "    pass\n"
                "o.flush()\n"
                "print(o.level())\n")
        env = dict(os.environ, PYTHONPATH=str(SRC), REPRO_OBS="trace",
                   REPRO_OBS_TRACE=str(path))
        out = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert out.stdout.split() == ["trace"]
        (rec,) = report.load_trace(str(path))
        assert rec["name"] == "env" and rec["attrs"] == {"k": 1}
        assert rec["device_s"] is not None
        env["REPRO_OBS"] = "loud"
        out = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert out.stdout.split() == ["off"] and "ignored" in out.stderr


# -------------------------------------------------------------- metrics
class TestMetrics:
    def test_counter_labels_and_total(self):
        c = obs.counter("t_port_counter")
        c._reset()
        c.inc()
        c.inc(3, kind="x")
        c.inc(2, kind="x")
        assert c.value() == 1
        assert c.value(kind="x") == 5
        assert c.total() == 6
        assert c.series() == {"": 1, "kind=x": 5}
        assert c.kind == "counter"

    def test_gauge_and_histogram(self):
        g = obs.gauge("t_port_gauge")
        assert g.value() is None and g.value(default=0) == 0
        g.set(0.25)
        g.set(0.5)
        assert g.value() == 0.5
        h = obs.histogram("t_port_hist")
        h._reset()
        for v in (1.0, 3.0, 2.0):
            h.observe(v)
        assert h.stats() == {"count": 3, "sum": 6.0, "min": 1.0, "max": 3.0}
        assert h.stats(missing="yes") is None

    def test_registry_get_or_register_as_the_reference(self):
        a = obs.counter("t_port_same")
        assert obs.counter("t_port_same", "later help") is a
        assert a.help == "later help", "help fills in once"
        obs.counter("t_port_same", "other")
        assert a.help == "later help"
        with pytest.raises(TypeError) as port_err:
            obs.gauge("t_port_same")
        jobs.counter("t_port_same")
        with pytest.raises(TypeError) as ref_err:
            jobs.gauge("t_port_same")
        assert str(port_err.value) == str(ref_err.value)
        assert obs.get_metric("t_port_same") is a
        assert obs.get_metric("t_port_missing") is None

    def test_snapshot_and_reset(self):
        c = obs.counter("t_port_snap")
        c._reset()
        c.inc(4)
        snap = obs.metrics_snapshot()
        assert snap["t_port_snap"] == {"kind": "counter", "help": "",
                                       "values": {"": 4}}
        assert list(snap) == sorted(snap)
        c._reset()
        assert obs.metrics_snapshot()["t_port_snap"]["values"] == {}

    def test_the_port_registers_its_families(self):
        snap = obs.metrics_snapshot()
        for name, kind in (("plan_cache_hits", "counter"),
                           ("worklist_builds", "counter"),
                           ("worklist_cache_hits", "counter"),
                           ("worklist_fingerprint_misses", "counter"),
                           ("worklist_len", "gauge"),
                           ("worklist_pruned_frac", "gauge")):
            assert snap[name]["kind"] == kind, name


# ------------------------------------------------------- engine tracing
def test_port_fit_trace_reads_the_same_in_both_reports(tmp_path):
    path = str(tmp_path / "fit.jsonl")
    eng = DPCEngine(300.0, exec_spec=ExecSpec(layout="block-sparse"),
                    device="cpu")
    pts = _blobs(600)
    eng.fit(pts)                                # cold: builds, uncaptured
    obs.configure(level="trace", trace_path=path)
    eng.fit(pts)
    obs.flush()
    obs.configure(level="off", trace_path=None)
    mine = report.aggregate(report.load_trace(path))
    theirs = jreport.aggregate(jreport.load_trace(path))
    assert mine == theirs
    assert report.render_table(mine) == jreport.render_table(theirs)
    assert {"engine.fit", "engine.fit/approxdpc.grid",
            "engine.fit/approxdpc.rho_delta",
            "engine.fit/approxdpc.rho_delta/rho_delta.worklist",
            "engine.fit/approxdpc.rho_delta/rho_delta.worklist/"
            "worklist.fingerprint",
            "engine.fit/approxdpc.rho_delta/rho_delta.sweep",
            "engine.fit/approxdpc.rules", "engine.fit/labels.assign"} \
        <= set(mine)
    root = mine["engine.fit"]
    child = sum(r["host_s"] for p, r in mine.items()
                if p.count("/") == 1)
    assert child <= root["host_s"] + 1e-6
    assert mine["engine.fit/approxdpc.rho_delta"]["device_s"] is not None


def test_reference_fit_trace_reads_the_same_in_both_reports(tmp_path):
    path = str(tmp_path / "ref.jsonl")
    eng = JEngine(300.0, exec_spec=JExecSpec(backend="jnp",
                                             layout="block-sparse"))
    pts = _blobs(256)
    jobs.configure(level="trace", trace_path=path)
    try:
        eng.fit(pts)
        jobs.flush()
    finally:
        jobs.configure(level="off", trace_path=None)
        jobs.reset_spans()
    mine = report.aggregate(report.load_trace(path))
    assert mine == jreport.aggregate(jreport.load_trace(path))
    assert "engine.fit/approxdpc.rho_delta" in mine
    assert report.render_table(mine, top=3) == \
        jreport.render_table(mine, top=3)


def test_fit_off_emits_nothing():
    DPCEngine(300.0, device="cpu").fit(_blobs(128))
    assert obs.spans() == []


# --------------------------------------------------------------- report
class TestReport:
    def test_aggregate_self_time(self):
        phases = report.aggregate(_recs())
        assert phases["fit"]["self_s"] == pytest.approx(0.3)
        assert phases["fit/rho"]["host_s"] == pytest.approx(0.7)
        assert phases["fit/rho"]["device_s"] == pytest.approx(0.5)
        for recs in (_recs(), _tree(), []):
            assert report.aggregate(recs) == jreport.aggregate(recs)

    @pytest.mark.parametrize("top", [None, 1, 2, 10])
    def test_render_table_and_metrics_equal_the_reference(self, top):
        for recs in (_recs(), _tree()):
            phases = report.aggregate(recs)
            assert report.render_table(phases, top=top) == \
                jreport.render_table(phases, top=top)
        assert report.render_table({}) == jreport.render_table({}) == \
            "(no spans recorded)"
        for snap in (_snap(), {}, {"c": {"kind": "counter", "help": "",
                                         "values": {"": 3}}}):
            assert report.render_metrics(snap) == \
                jreport.render_metrics(snap)
        assert "c = 3" in report.render_metrics(
            {"c": {"kind": "counter", "help": "", "values": {"": 3}}})

    def test_snapshot_schema(self, tmp_path):
        snap = report.build_snapshot(_recs(), {})
        assert snap["schema"] == "repro.obs/1"
        assert "fit/rho" in snap["phases"]
        assert snap == jreport.build_snapshot(_recs(), {})
        out = report.export_snapshot(str(tmp_path / "s.json"), _tree(),
                                     _snap())
        assert json.loads((tmp_path / "s.json").read_text()) == \
            json.loads(json.dumps(out))
        live = report.build_snapshot()
        assert live["metrics"]["worklist_builds"]["kind"] == "counter"
        assert live["level"] == "off"

    def test_cli_report(self, tmp_path, capsys):
        trace = tmp_path / "t.jsonl"
        trace.write_text("".join(json.dumps(r) + "\n" for r in _recs()))
        mpath = tmp_path / "m.json"
        mpath.write_text(json.dumps(
            {"plan_cache_hits": {"kind": "counter", "help": "",
                                 "values": {"": 2}}}))
        out = tmp_path / "snap.json"
        rc = obs_main(["report", "--trace", str(trace), "--metrics",
                       str(mpath), "--json", str(out)])
        assert rc == 0
        printed = capsys.readouterr().out
        assert "rho" in printed and "plan_cache_hits = 2" in printed
        snap = json.loads(out.read_text())
        assert snap["schema"] == "repro.obs/1"
        assert snap["metrics"]["plan_cache_hits"]["values"][""] == 2

    def test_cli_in_a_subprocess_prints_what_the_reference_prints(
            self, tmp_path):
        trace = tmp_path / "t.jsonl"
        trace.write_text("".join(json.dumps(r) + "\n" for r in _tree()))
        mpath = tmp_path / "m.json"
        mpath.write_text(json.dumps({"schema": "repro.obs/1",
                                     "metrics": _snap()}))
        env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
        outs = []
        for pkg in ("repro_torch.obs", "repro.obs"):
            snap = tmp_path / f"{pkg}.json"
            run = subprocess.run(
                [sys.executable, "-m", pkg, "report", "--trace", str(trace),
                 "--metrics", str(mpath), "--json", str(snap), "--top", "3"],
                env=env, capture_output=True, text=True, timeout=180)
            assert run.returncode == 0, run.stderr
            assert f"snapshot written to {snap}" in run.stderr
            outs.append((run.stdout, json.loads(snap.read_text())))
        (port_out, port_snap), (ref_out, ref_snap) = outs
        assert port_out == ref_out
        assert "fit_seconds = count=3" in port_out
        port_snap.pop("level"), ref_snap.pop("level")
        assert port_snap == ref_snap
        bad = subprocess.run([sys.executable, "-m", "repro_torch.obs",
                              "report"], env=env, capture_output=True,
                             text=True, timeout=60)
        assert bad.returncode == 2 and "--trace" in bad.stderr


def test_suspend_counters_restores_worklist_metrics():
    """The reference's test of the same name, on the port's registry."""
    builds = obs.get_metric("worklist_builds")
    before = builds.value()
    with blocksparse.suspend_counters():
        builds.inc(17)
        assert builds.value() == before + 17
    assert builds.value() == before
    assert blocksparse.worklist_build_count() == int(before)
