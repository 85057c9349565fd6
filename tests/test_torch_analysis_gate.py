"""The port's plan-time gate (``repro_torch.engine.planner._plan_check``)
against the reference's (``repro.engine.planner._plan_check``) in the same
process: one injected error rule makes both ``plan()`` raise
``AnalysisError``; under ``REPRO_ANALYSIS=0`` both make the plan, count the
finding under the same counter name and labels, and warn once per
process; ``suspend`` skips both; both memoize per spec.  The reference's
side uses ``jnp`` plans (its pallas plans raise at plan time on the
installed jax, ROADMAP "Reference gaps"); the port's side ``cuda`` and
``torch`` plans, on a host with no CUDA device their plain versions."""
import logging
from dataclasses import dataclass

import pytest

from repro.analysis import rules as jrules
from repro.engine import ExecSpec as JExecSpec
from repro.engine import planner as jplanner

from repro_torch import ExecSpec
from repro_torch.analysis import AnalysisError, Finding, Rule, rules
from repro_torch.engine import planner

RULE = "X-injected"


@dataclass(frozen=True)
class _Injected(Rule):
    name: str = RULE
    kind: str = "plan"
    calls: list = None

    def check_plan(self, pl):
        self.calls.append(pl.spec)
        return [Finding(rule=RULE, severity="error", target="injected",
                        message="injected failure", where="<test>")]


@dataclass(frozen=True)
class _JInjected(jrules.Rule):
    name: str = RULE
    kind: str = "plan"
    calls: list = None

    def check_plan(self, pl):
        self.calls.append(pl.spec)
        return [jrules.Finding(rule=RULE, severity="error",
                               target="injected", message="injected failure",
                               where="<test>")]


class _Side:
    """One package's planner, spec and injected rule."""

    def __init__(self, mod, spec, rule):
        self.mod, self.spec, self.rule = mod, spec, rule

    def forget(self):
        self.mod._ANALYZED.pop(self.spec, None)
        self.mod._PLANS.pop((None, self.spec), None)

    def plan(self):
        return self.mod.plan(None, self.spec)

    def counted(self):
        return self.mod._M_FINDINGS.value(rule=RULE, level="error")


@pytest.fixture(params=["cuda", "torch"])
def sides(request, monkeypatch):
    """Both gates with the injected rule registered, on specs unique to
    the test (a memo miss each), every registry restored after."""
    block = 200 + len(request.node.name)
    rules.all_rules()
    jrules.all_rules()
    port = _Side(planner, ExecSpec(backend=request.param, block=block),
                 _Injected(calls=[]))
    ref = _Side(jplanner, JExecSpec(backend="jnp", block=block),
                _JInjected(calls=[]))
    monkeypatch.setattr(rules, "_RULES", [*rules._RULES, port.rule])
    monkeypatch.setattr(jrules, "_RULES", [*jrules._RULES, ref.rule])
    for side in (port, ref):
        monkeypatch.setattr(side.mod, "_BYPASS_WARNED", False)
        side.forget()
    monkeypatch.delenv("REPRO_ANALYSIS", raising=False)
    yield port, ref
    for side in (port, ref):
        side.forget()


def test_an_error_rule_fails_plan_in_both(sides):
    for side, error in zip(sides, (AnalysisError, jrules.AnalysisError)):
        with pytest.raises(error, match="REPRO_ANALYSIS=0") as err:
            side.plan()
        assert [f.rule for f in err.value.findings] == [RULE]
        assert side.spec not in [k[1] for k in side.mod._PLANS]


def test_bypass_records_and_warns_once_in_both(sides, monkeypatch, caplog):
    monkeypatch.setenv("REPRO_ANALYSIS", "0")
    for side, logger in zip(sides, ("repro_torch.analysis",
                                    "repro.analysis")):
        before = side.counted()
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger=logger):
            assert side.plan() is not None
            assert side.counted() == before + 1
            side.forget()
            assert side.plan() is not None
            assert side.counted() == before + 2
        warned = [r for r in caplog.records if "bypassing" in r.message]
        assert len(warned) == 1 and warned[0].name == logger
    assert sides[0].mod._M_FINDINGS.name == sides[1].mod._M_FINDINGS.name \
        == "analysis_findings_total"


def test_suspend_skips_in_both(sides, monkeypatch):
    monkeypatch.setenv("REPRO_ANALYSIS", "suspend")
    for side in sides:
        assert side.plan() is not None
        assert side.rule.calls == [] and side.spec not in side.mod._ANALYZED


def test_memoized_per_spec_in_both(sides, monkeypatch):
    monkeypatch.setenv("REPRO_ANALYSIS", "off")
    for side in sides:
        side.plan()
        side.mod._PLANS.pop((None, side.spec))
        side.mod.plan((50, 2), side.spec)
        assert side.rule.calls == [side.spec]
        assert [f.rule for f in side.mod._ANALYZED[side.spec]
                if f.rule == RULE] == [RULE]


def test_shipping_plans_pass_the_gate_in_both(monkeypatch):
    """With the registered rules alone, fresh plans of the shipping specs
    pass both gates; the port's only findings on a host with no CUDA device
    are R4's skipped attribute checks, warnings."""
    monkeypatch.delenv("REPRO_ANALYSIS", raising=False)
    for spec in (ExecSpec(block=301), ExecSpec(backend="torch", block=301),
                 ExecSpec(layout="block-sparse", precision="bf16",
                          block=301)):
        side = _Side(planner, spec, None)
        side.forget()
        try:
            assert side.plan() is not None
            assert {(f.rule, f.severity) for f in planner._ANALYZED[spec]} \
                <= {("R4-launch-legality", "warn")}
        finally:
            side.forget()
    jspec = JExecSpec(backend="jnp", layout="block-sparse", block=301)
    side = _Side(jplanner, jspec, None)
    side.forget()
    try:
        assert side.plan() is not None and jplanner._ANALYZED[jspec] == ()
    finally:
        side.forget()
