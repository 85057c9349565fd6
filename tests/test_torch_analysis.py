"""The port's static analyzer (``repro_torch.analysis``): its vocabulary,
SARIF and baseline held against ``repro.analysis`` on the same inputs, a
positive control for every rule, the shipped tree analyzing clean through
the CLI, and the neutrality of the canonical run.  On a host with no CUDA
device a ``cuda`` plan runs its kernels' plain versions and R4's attribute
half is skipped; the attributes are held on the card by phase 31 of
``chip_smoke.py``."""
import collections
import datetime
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.analysis import rules as jrules
from repro.analysis import report as jreport
from repro.analysis import sarif as jsarif
from repro.analysis import targets as jtargets

from repro_torch import ExecSpec, obs
from repro_torch.analysis import (AnalysisError, Finding, audit,
                                  audit_check_rep, audit_determinism, record,
                                  report, sarif, targets)
from repro_torch.analysis import (r2_check_rep, r3_precision, r4_launch,
                                  r5_coverage, r6_merge_race,
                                  r7_transfer_retrace, r8_determinism,
                                  r9_memory_budget)
from repro_torch.engine import planner
from repro_torch.kernels import ops
from repro_torch.resilience import faultinject

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"


def _fresh(spec):
    """Forget ``spec``'s gate result and plans, so plan() runs the gate."""
    planner._ANALYZED.pop(spec, None)
    for key in [k for k in planner._PLANS if k[1] == spec]:
        planner._PLANS.pop(key)


# ------------------------------------------------------ parity with repro
def test_canonical_points_bit_equal():
    a, b = targets.canonical_points(), jtargets.canonical_points()
    assert a.dtype == b.dtype == np.float32 and a.shape == (96, 2)
    assert a.tobytes() == b.tobytes()
    assert (targets.N_POINTS, targets.DIM, targets.D_CUT) == \
        (jtargets.N_POINTS, jtargets.DIM, jtargets.D_CUT)


def test_finding_to_dict_and_error_text_equal():
    kw = dict(rule="R4-x", severity="error", target="t", message="m",
              where="a.py:3")
    assert Finding(**kw).to_dict() == jrules.Finding(**kw).to_dict()
    assert str(AnalysisError([Finding(**kw)])) == \
        str(jrules.AnalysisError([jrules.Finding(**kw)]))
    assert str(AnalysisError([Finding(**kw)])).splitlines()[-1].count(
        "REPRO_ANALYSIS=0") == 1


def _sweep_report():
    findings = [
        {"rule": "R2-check-rep-audit", "severity": "error", "target": "t",
         "message": "body", "where": "src/x.py:12"},
        {"rule": "R3-precision-flow", "severity": "warn", "target": "t2",
         "message": "w", "where": "launch[3]"},
        {"rule": "R8-determinism", "severity": "suppressed", "target": "t3",
         "message": "s", "where": "analysis-baseline.json:1",
         "suppressed_reason": "argued", "suppressed_until": "2999-01-01"},
        {"rule": "trace", "severity": "info", "target": "t4",
         "message": "i", "where": ""}]
    return {"ok": False, "findings": findings, "targets": ["a", "b"],
            "skipped": ["c"],
            "rules": {"R2-check-rep-audit": {"kind": "project",
                                             "description": "d2"},
                      "R3-precision-flow": {"kind": "launch",
                                            "description": "d3"}}}


def test_sarif_equals_the_reference():
    rep = _sweep_report()
    mine = sarif.to_sarif(rep)
    driver = mine["runs"][0]["tool"]["driver"]
    assert driver["name"] == "repro_torch.analysis"
    driver["name"] = "repro.analysis"
    assert mine == jsarif.to_sarif(rep)
    cu = sarif.to_sarif({"findings": [{"rule": "R6-merge-race",
                                       "severity": "error", "target": "t",
                                       "message": "m",
                                       "where": "k/sweep.cu:770"}]})
    loc = cu["runs"][0]["results"][0]["locations"][0]
    assert loc["physicalLocation"]["region"]["startLine"] == 770


_TODAY = datetime.date(2026, 6, 1)
_LEASES = {
    "matching": [{"rule": "R8-*", "target": "*", "reason": "argued",
                  "expires": "2026-12-31"}],
    "expired": [{"rule": "R8-*", "reason": "old", "expires": "2026-01-01"}],
    "no_reason_or_date": [{"rule": "R8-*"}],
}


@pytest.mark.parametrize("case", sorted(_LEASES))
def test_baseline_equals_the_reference(case, tmp_path):
    path = tmp_path / "baseline.json"
    path.write_text(json.dumps({"suppressions": _LEASES[case]}))
    entries = report.load_baseline(str(path))
    assert entries == jreport.load_baseline(str(path))
    kw = dict(rule="R8-determinism", severity="error", target="t",
              message="m", where="x.py:1")
    mine = report.apply_baseline([Finding(**kw)], entries, _TODAY)
    ref = jreport.apply_baseline([jrules.Finding(**kw)], entries, _TODAY)
    assert mine == ref
    hygiene = [f.to_dict() for f in
               report._baseline_findings(entries, str(path), _TODAY)]
    assert hygiene == [f.to_dict() for f in jreport._baseline_findings(
        entries, str(path), _TODAY)]
    assert (mine[0]["severity"] == "suppressed") == (case == "matching")
    assert bool(hygiene) == (case != "matching")


def test_shipped_baseline_is_empty_and_well_formed():
    doc = json.loads(Path(report.BASELINE_FILE).read_text())
    assert doc["suppressions"] == [] and doc["comment"]


# -------------------------------------------------------------- audits
@pytest.mark.parametrize("deco", [audit_check_rep, audit_determinism])
def test_audit_decorator_attaches_and_rejects_empty_reason(deco):
    with pytest.raises(ValueError, match="non-empty reason"):
        deco("   ")

    @deco("a reason  spread\n over lines")
    def body(x):
        return x

    rec = audit.audit_of(body) or audit.determinism_audit_of(body)
    assert body(3) == 3 and rec.reason == "a reason spread over lines"
    assert rec.key.endswith("test_audit_decorator_attaches_and_rejects_"
                            "empty_reason.<locals>.body")


# ----------------------------------------------------- R2 shard bodies
_R2_CASES = {
    "unaudited": ("def body(mesh, parts):\n"
                  "    return mesh.psum(parts)\n", 1),
    "audited": ("from repro_torch.analysis.audit import audit_check_rep\n"
                "@audit_check_rep('why', collectives=('psum',))\n"
                "def body(mesh, parts):\n"
                "    return mesh.psum(parts)\n", 0),
    "factory": ("def make(mesh):\n"
                "    @audit_check_rep('why')\n"
                "    def body(parts):\n"
                "        return mesh.pmin(parts)\n"
                "    return body\n", 0),
    "factory_unaudited": ("def make(mesh):\n"
                          "    def body(parts):\n"
                          "        return mesh.all_gather(parts)\n"
                          "    return body\n", 1),
    "unresolvable": ("body = lambda mesh, parts: mesh.ppermute(parts, [])\n",
                     1),
}


@pytest.mark.parametrize("case", sorted(_R2_CASES))
def test_r2_scan(case, tmp_path):
    text, want = _R2_CASES[case]
    pkg = tmp_path / "src" / "repro_torch" / "dist"
    pkg.mkdir(parents=True)
    (pkg / "m.py").write_text(text)
    got = r2_check_rep.CheckRepAuditRule().check_project(str(tmp_path))
    assert len(got) == want, got
    assert all(f.where.startswith("src/repro_torch/dist/m.py:")
               for f in got)
    if case == "unresolvable":
        assert "cannot resolve" in got[0].message


# ------------------------------------------------------ R3 bf16 resolve
def _launch(kernel, **kw):
    base = dict(shapes=((300, 2), (300, 2)), dtypes=("float32",) * 2,
                rows=300, cols=300, d=2, row_tile=1, padded_rows=300,
                entries=None, device="cpu", d2cut=0.01)
    return record.Launch(kernel=kernel, **{**base, **kw})


@pytest.mark.parametrize("steps,fires", [
    ([], True), ([record.Step("resolve", {"direct": False})], True),
    ([record.Step("resolve", {"direct": True})], False)])
def test_r3_bf16_sweep_needs_the_direct_resolve(steps, fires):
    events = [_launch("fused_count_topk_bf16"), *steps, _launch("masked_nn")]
    got = r3_precision.PrecisionFlowRule().check_launches("t", events)
    assert bool(got) == fires
    f32 = [_launch("fused_count_topk"), _launch("masked_nn")]
    assert r3_precision.PrecisionFlowRule().check_launches("t", f32) == []


def test_r3_shipping_bf16_plan_records_the_resolve():
    pl = planner.plan(None, ExecSpec(precision="bf16",
                                     layout="block-sparse"))
    with targets.neutral(pl):
        events, _ = targets.run_target(targets.plan_targets(pl)[0][1])
    kinds = [e.kernel if isinstance(e, record.Launch) else e.kind
             for e in events]
    assert kinds.index("worklist_count_topk_bf16") < kinds.index("resolve")
    assert r3_precision.PrecisionFlowRule().check_launches("t", events) == []


# --------------------------------------------------- R4 launch legality
@pytest.mark.parametrize("launch,what", [
    (_launch("worklist_count_topk", row_tile=256, padded_rows=300,
             entries=4), "whole row tiles"),
    (_launch("worklist_count_topk", row_tile=256, padded_rows=768,
             entries=4), "whole row tiles"),
    (_launch("range_count", rows=2**31), "past int32"),
    (_launch("worklist_range_count", row_tile=256, padded_rows=512,
             entries=2**31), "past int32"),
    (_launch("masked_nn", cols=2**30, d=3), "past int32")])
def test_r4_record_checks_fire(launch, what):
    got = r4_launch.LaunchLegalityRule().check_launches("t", [launch])
    errors = [f for f in got if f.severity == "error"]
    assert errors and what in errors[0].message
    assert [f.severity for f in got if f.severity != "error"] == ["warn"]


def test_r4_attribute_half_skipped_with_a_warning_on_the_cpu():
    pl = planner.plan(None, ExecSpec(layout="block-sparse"))
    with targets.neutral(pl):
        events, _ = targets.run_target(targets.plan_targets(pl)[0][1])
    assert [e.padded_rows for e in record.launches(events)] == [256, 256]
    got = r4_launch.LaunchLegalityRule().check_launches("t", events)
    assert [(f.severity, f.where) for f in got] == [("warn",
                                                     "<attributes>")]
    assert "skipped" in got[0].message


# ------------------------------------------------------ R5 coverage
def test_r5_clean_on_the_tree():
    assert r5_coverage.SpecCoverageRule().check_project(str(ROOT)) == []


def test_r5_snapshot_drift_fires(monkeypatch):
    monkeypatch.setattr(r5_coverage, "KNOWN_BACKENDS", ("cuda",))
    got = r5_coverage.SpecCoverageRule().check_project(str(ROOT))
    assert any("backends changed" in f.message for f in got)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("layout", ["dense", "block-sparse"])
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_r5_validity_table_matches_spec_and_plan(backend, layout,
                                                 precision, monkeypatch):
    monkeypatch.setenv("REPRO_ANALYSIS", "suspend")
    want = r5_coverage.expected_spec_valid(backend, layout, precision)
    try:
        spec = ExecSpec(backend=backend, layout=layout, precision=precision)
    except ValueError:
        assert not want
        return
    assert want
    pl = planner.plan(None, spec)
    assert r5_coverage.expected_plan_valid(pl.backend, precision)
    assert pl.worklist_strategy == r5_coverage.expected_strategy(
        pl.backend, layout)
    assert pl.grid_sort == (layout == "block-sparse")


# ----------------------------------------------------- R6 merge scan
_R6_CASES = {
    "unannotated": ("__global__ void k(int* c) {\n"
                    "  atomicAdd(c, 1);\n}\n", 1),
    "annotated": ("__global__ void k(int* c) {\n"
                  "  // audit-merge: an integer count, exact in any order\n"
                  "  if (threadIdx.x == 0)\n"
                  "    atomicAdd(c, 1);\n"
                  "  atomicMax(c + 1, 2);\n}\n", 0),
    "empty_tag": ("__global__ void k(int* c) {\n"
                  "  // audit-merge:\n"
                  "  atomicAdd(c, 1);\n}\n", 1),
    "in_prose": ("// merged by atomicMin on (d2 bits << 32 | index)\n"
                 "__global__ void k(int* c) { c[0] = 1; }\n", 0),
    "after_code": ("__global__ void k(unsigned long long* c) {\n"
                   "  // audit-merge: a lexicographic minimum\n"
                   "  c[1] = 0;\n"
                   "  atomicExch(c, 1ull);\n}\n", 1),
}


@pytest.mark.parametrize("case", sorted(_R6_CASES))
def test_r6_scan(case, tmp_path):
    text, want = _R6_CASES[case]
    csrc = tmp_path / "src" / "repro_torch" / "kernels" / "csrc"
    csrc.mkdir(parents=True)
    (csrc / "k.cu").write_text(text)
    got = r6_merge_race.MergeRaceRule().check_project(str(tmp_path))
    assert len(got) == want, got


def test_r6_every_atomic_of_the_shipped_source_is_annotated():
    src = SRC / "repro_torch" / "kernels" / "csrc" / "sweep.cu"
    lines = src.read_text().splitlines()
    atomics = [i for i, line in enumerate(lines)
               if r6_merge_race._ATOMIC.search(r6_merge_race._code(line))]
    assert len(atomics) == 14
    assert all(r6_merge_race._annotated(lines, i) for i in atomics)


# --------------------------------------------------- R7 spellings
def test_r7_clean_on_a_shipping_plan():
    for spec in (ExecSpec(), ExecSpec(backend="torch",
                                      layout="block-sparse")):
        pl = planner.plan(None, spec)
        assert r7_transfer_retrace.SpellingRule().check_plan(pl) == []


def test_r7_fires_on_a_threshold_squared_in_f64(monkeypatch):
    spec = ExecSpec(block=7)
    monkeypatch.setenv("REPRO_ANALYSIS", "suspend")
    pl = planner.plan(None, spec)
    orig = pl.rho_delta

    def rho_delta_f64(x, y, d_cut, **kw):
        # the threshold squared in the spelling's own precision, in f64
        d2 = float(np.float64(d_cut)) ** 2
        with monkeypatch.context() as m:
            m.setattr(ops, "d2cut_of", lambda _: d2)
            return orig(x, y, d_cut, **kw)

    monkeypatch.setattr(pl, "rho_delta", rho_delta_f64)
    got = r7_transfer_retrace.SpellingRule().check_plan(pl)
    assert got and "not one f32 value" in got[0].message


# ------------------------------------------------- R8 scatter scan
_R8_CASES = {
    "index_add": ("def f(t, i, v):\n    return t.index_add_(0, i, v)\n", 1),
    "torch_index_add": ("import torch\ndef f(t, i, v):\n"
                        "    return torch.index_add(t, 0, i, v)\n", 1),
    "scatter_sum": ("def f(t, i, v):\n"
                    "    return t.scatter_reduce(0, i, v, 'sum')\n", 1),
    "scatter_amax": ("def f(t, i, v):\n"
                     "    return t.scatter_reduce(0, i, v, 'amax')\n", 0),
    "scatter_amin_kw": ("def f(t, i, v):\n"
                        "    return t.scatter_reduce_(0, i, v,\n"
                        "                             reduce='amin')\n", 0),
    "put_accumulate": ("def f(t, i, v):\n"
                       "    return t.index_put_((i,), v, accumulate=True)\n",
                       1),
    "put_plain": ("def f(t, i, v):\n    return t.index_put_((i,), v)\n", 0),
    "audited": ("from repro_torch.analysis.audit import audit_determinism\n"
                "@audit_determinism('integer counts')\n"
                "def f(t, i, v):\n"
                "    def inner():\n"
                "        return t.scatter_add_(0, i, v)\n"
                "    return inner()\n", 0),
}


@pytest.mark.parametrize("case", sorted(_R8_CASES))
def test_r8_scan(case, tmp_path):
    text, want = _R8_CASES[case]
    pkg = tmp_path / "src" / "repro_torch" / "core"
    pkg.mkdir(parents=True)
    (pkg / "m.py").write_text(text)
    got = r8_determinism.DeterminismRule().check_project(str(tmp_path))
    assert len(got) == want, got


# ---------------------------------------------------- R9 budgets
def _table(dyn_smem):
    """A synthetic attribute table: every launch name served at every d."""
    names = tuple(ops.launch_counts())
    return [{"name": "synthetic<2>", "launch": names, "d_lo": 1,
             "d_hi": 2**31 - 1, "threads": 256, "rows_per_block": 256,
             "grid_y_max": 1, "dyn_smem": dyn_smem, "num_regs": 80,
             "static_smem": 0, "local_bytes": 0, "max_threads": 256,
             "max_dyn_smem": dyn_smem, "occupancy": 3, "error": 0}]


def test_r9_synthetic_table_over_a_lowered_smem_budget_fires_at_plan(
        monkeypatch):
    spec = ExecSpec(precision="bf16", block=11)
    monkeypatch.delenv("REPRO_ANALYSIS", raising=False)
    monkeypatch.setattr(r4_launch, "kernel_table",
                        lambda device, d: _table(67_584))
    _fresh(spec)
    try:
        assert planner.plan(None, spec) is not None    # under the opt-in
        _fresh(spec)
        monkeypatch.setenv("REPRO_LIMIT_SMEM_BYTES", "65536")
        with pytest.raises(AnalysisError, match="R9-memory-budget"):
            planner.plan(None, spec)
        rules = {f.rule for f in planner._ANALYZED[spec]}
        assert rules == {"R9-memory-budget"}
    finally:
        _fresh(spec)


def test_r9_live_gate_arms_only_with_its_variable(monkeypatch):
    pl = planner.plan(None, ExecSpec())
    monkeypatch.setattr(r9_memory_budget, "live_peak",
                        lambda pl: (10**9, "synthetic"))
    rule = r9_memory_budget.LivePeakRule()
    monkeypatch.delenv("REPRO_LIMIT_LIVE_BYTES", raising=False)
    assert rule.check_plan(pl) == []
    monkeypatch.setenv("REPRO_LIMIT_LIVE_BYTES", str(2 * 10**9))
    assert rule.check_plan(pl) == []
    monkeypatch.setenv("REPRO_LIMIT_LIVE_BYTES", str(10**6))
    got = rule.check_plan(pl)
    assert [f.severity for f in got] == ["error"]
    assert r9_memory_budget.live_peak(pl)[0] == 10**9


def test_telemetry_memory_block_has_the_reference_keys():
    pl = planner.plan((96, 2), ExecSpec(layout="block-sparse"))
    mem = pl.telemetry()["memory"]
    assert {"kernels", "live_peak_bytes", "live_budget_bytes",
            "limits"} <= set(mem)
    assert [k["kernel"] for k in mem["kernels"]] == \
        ["worklist_count_topk", "worklist_masked_nn", "worklist_masked_nn"]
    assert all(k["attributes"] is None for k in mem["kernels"])
    assert mem["live_peak_bytes"] is None and mem["limits"]["sms"] == 132
    assert pl.telemetry()["memory"] is mem             # once per plan


# ------------------------------------------------------ neutrality
def test_plan_is_neutral(monkeypatch):
    """plan()'s gate moves no launch count, no worklist counter, no fault
    site's hits, no span, and leaves no worklist in any plan's cache."""
    spec = ExecSpec(layout="block-sparse", block=13)
    monkeypatch.delenv("REPRO_ANALYSIS", raising=False)
    _fresh(spec)
    other = planner.plan((96, 2), ExecSpec(layout="block-sparse"))
    x = torch.from_numpy(targets.canonical_points())
    other.rho_delta(x, x, 0.35)
    cached = dict(other._wl)
    names = ("worklist_builds", "worklist_cache_hits",
             "worklist_fingerprint_misses", "worklist_len",
             "worklist_pruned_frac")
    before = {n: obs.get_metric(n).series() for n in names}
    counts = ops.launch_counts()
    prev_level = obs.level()
    obs.configure(level="metrics")
    obs.reset_spans()
    faultinject.activate("kernel.dispatch", mode="raise", trigger=10**6)
    try:
        with record.recording() as events:
            pl = planner.plan((96, 2), spec)
        # the two targets once, then the three spellings of rho_delta that
        # R7 does not take from the canonical run
        assert collections.Counter(e.kernel for e in record.launches(
            events)) == {"worklist_count_topk": 4, "worklist_masked_nn": 5}
        assert faultinject.active().hits == 0
        assert obs.spans() == []
        assert ops.launch_counts() == counts
        assert {n: obs.get_metric(n).series() for n in names} == before
        assert len(pl._wl) == 0 and dict(other._wl) == cached
    finally:
        faultinject.deactivate()
        obs.configure(level=prev_level)
        _fresh(spec)


def test_telemetry_reads_the_gate_run(monkeypatch):
    """The gate's canonical run is the plan's one run: telemetry's memory
    block is built from it and launches nothing more."""
    spec = ExecSpec(layout="block-sparse", block=23)
    monkeypatch.delenv("REPRO_ANALYSIS", raising=False)
    _fresh(spec)
    try:
        pl = planner.plan((96, 2), spec)
        run = pl._canonical
        assert run is not None and run.failures == []
        with record.recording() as events:
            mem = pl.telemetry()["memory"]
        assert events == [] and pl._canonical is run
        assert [k["kernel"] for k in mem["kernels"]] == [
            e.kernel for name in run.names
            for e in record.launches(run.events[name])]
    finally:
        _fresh(spec)


def test_reset_peak_memory_keeps_an_open_span_peak(monkeypatch):
    """The canonical run's reset of the peak statistic folds the peak so
    far into the open span first: a fit's span keeps its peak."""
    from repro_torch.obs import tracer

    class Card:
        allocated = peak = 10

        def max_memory_allocated(self, device=None):
            return self.peak

        def reset_peak_memory_stats(self, device=None):
            self.peak = self.allocated

    card = Card()
    monkeypatch.setattr(tracer, "_tracks_memory", lambda: True)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        card.max_memory_allocated)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        card.reset_peak_memory_stats)
    prev = obs.level()
    obs.configure(level="trace")
    obs.reset_spans()
    try:
        with obs.span("fit"):
            card.peak = 300             # the fit's own peak, before the gate
            tracer.reset_peak_memory()
            assert card.peak == 10
        assert obs.spans()[-1]["peak_bytes"] == 300
    finally:
        obs.configure(level=prev)
        obs.reset_spans()


# ---------------------------------------------- a target that raises
def _raises(*_a, **_kw):
    raise RuntimeError("no kernel image is available for execution")


def test_a_target_that_raises_fails_plan(monkeypatch):
    """A canonical target that raises (on the card, a kernel that will
    not launch) is an error finding: plan() raises; under
    REPRO_ANALYSIS=0 the plan is made and its telemetry raises too."""
    spec = ExecSpec(block=17)
    monkeypatch.delenv("REPRO_ANALYSIS", raising=False)
    monkeypatch.setattr(planner.DPCPlan, "denser_nn", _raises)
    _fresh(spec)
    try:
        with pytest.raises(AnalysisError, match="no kernel image") as err:
            planner.plan(None, spec)
        assert {(f.rule, f.severity) for f in err.value.findings} == \
            {("trace", "error")}
        monkeypatch.setenv("REPRO_ANALYSIS", "0")
        _fresh(spec)
        pl = planner.plan(None, spec)
        with pytest.raises(AnalysisError, match="no kernel image"):
            pl.telemetry()
    finally:
        _fresh(spec)


def test_a_sweep_target_that_raises_fails_the_sweep(monkeypatch):
    spec = ExecSpec(block=19)
    monkeypatch.setattr(targets, "sweep_specs", lambda: [spec])
    monkeypatch.setattr(targets, "serve_targets", lambda spec, dev: (
        [("serve:compress_head", _raises)], []))
    try:
        rep = report.run_sweep(device="cpu")
    finally:
        _fresh(spec)
    assert not rep["ok"]
    assert [(f["rule"], f["severity"], f["target"]) for f in rep["findings"]
            if f["rule"] == "trace"] == [
        ("trace", "error", "plan[cuda:dense:f32]:serve:compress_head")]


def test_suspend_launch_counts_restores():
    counts = ops.launch_counts()
    with ops.suspend_launch_counts():
        ops._LAUNCHES["range_count"] += 5
    assert ops.launch_counts() == counts


@pytest.mark.parametrize("layout", ["dense", "block-sparse"])
def test_every_wrapper_records_under_its_launch_name(layout):
    """The CLI sweep's record of every target names only kernels that
    ``ops.launch_counts()`` knows, on CPU tensors as on the card."""
    pl = planner.plan(None, ExecSpec(layout=layout))
    names = set()
    for source in (targets.distributed_targets(pl, "cpu"),
                   targets.stream_targets(pl, "cpu")):
        for _name, thunk in source[0]:
            with targets.neutral():
                events, _ = targets.run_target(thunk)
            names |= {e.kernel for e in record.launches(events)}
    assert names and names <= set(ops.launch_counts())


# ---------------------------------------------------------- the CLI
@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    out = tmp_path_factory.mktemp("cli")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    env.pop("REPRO_ANALYSIS", None)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--device", "cpu",
         "--sarif", str(out / "a.sarif"), "--out", str(out / "r.json")],
        env=env, capture_output=True, text=True, timeout=300)
    return proc, out


def test_cli_exits_zero_with_well_formed_sarif(cli):
    proc, out = cli
    assert proc.returncode == 0, proc.stderr
    log = json.loads((out / "a.sarif").read_text())
    assert log["version"] == "2.1.0" and len(log["runs"]) == 1
    run = log["runs"][0]
    assert run["tool"]["driver"]["name"] == "repro_torch.analysis"
    ids = [r["id"] for r in run["tool"]["driver"]["rules"]]
    assert {"R2-check-rep-audit", "R6-merge-race", "R9-memory-budget",
            "trace", "baseline"} <= set(ids)
    assert all(r["level"] != "error" for r in run["results"])
    assert run["properties"]["ok"] is True


def test_shipped_tree_analyzes_clean(cli):
    proc, out = cli
    rep = json.loads((out / "r.json").read_text())
    assert rep["ok"] and rep["device"] == "cpu"
    assert rep["rules_run"] == sorted(rep["rules"]) and len(rep["rules"]) == 8
    # the only findings on a CPU host: R4's skipped attribute half
    assert {(f["rule"], f["severity"], f["where"])
            for f in rep["findings"]} == {("R4-launch-legality", "warn",
                                           "<attributes>")}
    assert len(rep["targets"]) >= 40 and rep["host_syncs"] is None
    launched = set().union(*(set(v) for v in rep["launches"].values()))
    assert {"fused_count_topk", "worklist_count_topk",
            "fused_count_topk_bf16", "worklist_count_topk_bf16",
            "masked_nn", "worklist_masked_nn", "range_count",
            "range_count_signed", "worklist_range_count",
            "halo_range_count", "halo_masked_nn"} <= launched
    for body in ("distributed.dpc._rho_halo", "distributed.dpc._delta_halo",
                 "distributed.dpc._rho_gather",
                 "distributed.dpc._delta_gather",
                 "distributed.dpc._rho_stencil",
                 "distributed.dpc._delta_stencil",
                 "distributed.dpc._halo_window",
                 "stream.incremental.make_sharded_repair.<locals>.repair",
                 "stream.sharded.make_sharded_nn_update.<locals>.nn_update",
                 "stream.sharded.make_sharded_labels.<locals>.propagate"):
        assert f"repro_torch.{body}" in rep["audits"], body
    sites = {a["site"].rsplit(":", 1)[-1]
             for a in rep["determinism_audits"].values()}
    assert sites == {"compress_kv", "kmeans_pivots", "moe_ffn",
                     "ring_range_count"}
