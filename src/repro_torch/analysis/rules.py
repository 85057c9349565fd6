"""Rule base and registry of the port's static analyzer, the port of
``repro/analysis/rules.py``.

Three rule kinds share one :class:`Finding` vocabulary:

* **launch rules** (``kind = "launch"``) check one target's launch record
  at a time (:mod:`.record`: the kernel calls and resolve steps a target
  made, in order) — they run at plan time
  (``repro_torch.engine.planner.plan``) on each plan's canonical targets,
  and in the CLI sweep on every target the subsystems expose.  Eager
  PyTorch has no traced program, so the record takes the jaxpr's place.
* **plan rules** (``kind = "plan"``) check a resolved :class:`DPCPlan`
  itself — properties that live *between* calls, like R7's spelling
  probe (the same plan called with equivalent ``d_cut`` spellings must
  give one threshold and one answer).
* **project rules** (``kind = "project"``) check the source tree or the
  spec/dispatch tables once per sweep (R2's shard-body scan, R5's coverage
  cross-check, R6's merge scan, R8's scatter scan).

This module imports nothing of the port: kernel modules import the
analysis package's audit and record modules at definition time.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterable

__all__ = ["Finding", "AnalysisError", "Rule", "register_rule", "all_rules",
           "launch_rules", "plan_rules", "project_rules", "analyze_launches"]


@dataclass(frozen=True)
class Finding:
    """One analyzer result: a rule violation at a location.

    ``severity`` is ``"error"`` (fails the sweep and plan-time checks) or
    ``"warn"`` (reported, never fatal — used for skipped targets and for
    checks a host cannot make, not for rule violations).
    """

    rule: str                  # e.g. "R4-launch-legality"
    severity: str              # "error" | "warn"
    target: str                # target or file being checked
    message: str
    where: str = ""            # launch position or file:line

    def to_dict(self) -> dict:
        return {"rule": self.rule, "severity": self.severity,
                "target": self.target, "message": self.message,
                "where": self.where}


class AnalysisError(ValueError):
    """Raised by plan-time analysis when error-severity findings exist."""

    def __init__(self, findings: Iterable[Finding]) -> None:
        self.findings = tuple(findings)
        lines = [f"static analysis found {len(self.findings)} problem(s):"]
        lines += [f"  [{f.rule}] {f.target} @ {f.where}: {f.message}"
                  for f in self.findings]
        lines.append("  (set REPRO_ANALYSIS=0 to bypass while debugging — "
                     "findings still land on analysis_findings_total)")
        super().__init__("\n".join(lines))


@dataclass(frozen=True)
class Rule:
    """A registered analyzer rule.  Subclasses override one ``check_*``."""

    name: str = ""
    description: str = ""
    kind: str = "launch"       # "launch" | "plan" | "project"

    def check_launches(self, target: str, record: Any) -> list[Finding]:
        return []

    def check_plan(self, pl: Any) -> list[Finding]:
        return []

    def check_project(self, repo_root: str) -> list[Finding]:
        return []


_RULES: list[Rule] = []
_LOADED = False


def register_rule(rule: Rule) -> Rule:
    _RULES.append(rule)
    return rule


def _load() -> None:
    """Import the rule modules once (lazily: they import the port)."""
    global _LOADED
    if _LOADED:
        return
    from . import r2_check_rep, r3_precision, r4_launch       # noqa: F401
    from . import r5_coverage, r6_merge_race                  # noqa: F401
    from . import r7_transfer_retrace, r8_determinism         # noqa: F401
    from . import r9_memory_budget                            # noqa: F401
    _LOADED = True


def all_rules() -> tuple[Rule, ...]:
    _load()
    return tuple(_RULES)


def launch_rules() -> tuple[Rule, ...]:
    return tuple(r for r in all_rules() if r.kind == "launch")


def plan_rules() -> tuple[Rule, ...]:
    return tuple(r for r in all_rules() if r.kind == "plan")


def project_rules() -> tuple[Rule, ...]:
    return tuple(r for r in all_rules() if r.kind == "project")


def analyze_launches(target: str, record: Any,
                     rules: tuple[Rule, ...] | None = None) -> list[Finding]:
    """Run every (or the given) launch rule over one target's record."""
    out: list[Finding] = []
    for rule in (launch_rules() if rules is None else rules):
        out.extend(rule.check_launches(target, record))
    return out
