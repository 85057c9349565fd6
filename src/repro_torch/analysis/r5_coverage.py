"""R5 spec-coverage: the ExecSpec axes, the planner dispatch and the test
parametrizations stay mutually exhaustive; the port of
``r5_coverage.py``.

The failure mode this rule exists for: someone adds an axis value (a new
backend, a new precision) and it ships reachable-but-untested — the spec
validation accepts it, the planner dispatches it somewhere, and no parity
test ever names it.  R5 cross-checks four things and fails if any drift:

1. **pinned axis snapshot** — the live ``available_backends()`` /
   ``LAYOUTS`` / ``PRECISIONS`` must equal the snapshot reviewed into this
   rule.  Adding an axis value therefore *requires* touching this file,
   which is the review hook for the other three checks.
2. **validation-table consistency** — for the full explicit product,
   ``ExecSpec`` construction and ``plan()`` resolution must succeed/fail
   exactly where the documented table says (bf16 needs the ``cuda``
   backend, the one that is ``mxu_dense``; everything else is legal).
3. **planner dispatch totality** — every valid plan must land on exactly
   the documented ``worklist_strategy`` (``dense``; under the
   block-sparse layout ``device`` where the backend builds worklists, else
   ``ring``) and ``grid_sort`` (block-sparse only).
4. **parity-test coverage** — every axis value must appear as a literal
   in ``tests/``, so a new value cannot ship without a test naming it.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any

from .rules import Finding, Rule, register_rule

RULE_NAME = "R5-spec-coverage"

# The reviewed snapshot (check 1).  When an axis grows, update this tuple
# AND the validity logic below AND the parity-test parametrizations —
# that is the point.
KNOWN_BACKENDS = ("cuda", "torch")
KNOWN_LAYOUTS = ("dense", "block-sparse")
KNOWN_PRECISIONS = ("f32", "bf16")


def expected_spec_valid(backend: str, layout: str, precision: str) -> bool:
    """ExecSpec construction-time validity (backend-explicit specs)."""
    del layout
    return not (precision == "bf16" and backend == "torch")


def expected_plan_valid(be: Any, precision: str) -> bool:
    """plan()-time validity for a resolved backend instance."""
    return precision != "bf16" or be.mxu_dense


def expected_strategy(be: Any, layout: str) -> str:
    if layout != "block-sparse":
        return "dense"
    return "device" if be.builds_worklists else "ring"


@dataclass(frozen=True)
class SpecCoverageRule(Rule):
    name: str = RULE_NAME
    description: str = ("ExecSpec axes, validation table, planner dispatch "
                        "and parity-test literals cross-checked for "
                        "exhaustiveness")
    kind: str = "project"

    def check_project(self, repo_root: str) -> list[Finding]:
        from repro_torch.engine.planner import plan
        from repro_torch.engine.spec import LAYOUTS, PRECISIONS
        from repro_torch.kernels.backend import available_backends

        out: list[Finding] = []

        def finding(msg: str, where: str = "") -> None:
            out.append(Finding(rule=RULE_NAME, severity="error",
                               target="spec-coverage", message=msg,
                               where=where))

        # 1. pinned snapshot
        for label, live, known in (
                ("backends", tuple(available_backends()), KNOWN_BACKENDS),
                ("layouts", tuple(LAYOUTS), KNOWN_LAYOUTS),
                ("precisions", tuple(PRECISIONS), KNOWN_PRECISIONS)):
            if set(live) != set(known):
                finding(f"{label} changed: live {sorted(live)} vs reviewed "
                        f"snapshot {sorted(known)} — update "
                        f"analysis/r5_coverage.py (validity table + "
                        f"snapshot) and the parity-test parametrizations "
                        f"together", where="r5_coverage.py")

        # 2 + 3. the validation table and the dispatch over the explicit
        # product; plan-time analysis is suspended for these probe plans
        # (AnalysisError subclasses ValueError and would read as validity
        # drift here, and the sweep analyzes every spec itself)
        prev = os.environ.get("REPRO_ANALYSIS")
        os.environ["REPRO_ANALYSIS"] = "suspend"
        try:
            check_table(plan, finding)
        finally:
            if prev is None:
                os.environ.pop("REPRO_ANALYSIS", None)
            else:
                os.environ["REPRO_ANALYSIS"] = prev

        # 4. every axis value appears in the test suites
        tests_dir = os.path.join(repo_root, "tests")
        corpus = ""
        if os.path.isdir(tests_dir):
            for fname in sorted(os.listdir(tests_dir)):
                if fname.endswith(".py"):
                    with open(os.path.join(tests_dir, fname),
                              encoding="utf-8") as fh:
                        corpus += fh.read()
        for value in (*KNOWN_BACKENDS, *KNOWN_LAYOUTS, *KNOWN_PRECISIONS):
            if f'"{value}"' not in corpus and f"'{value}'" not in corpus:
                finding(f"axis value {value!r} appears in no test under "
                        f"tests/ — parametrize a parity test over it "
                        f"before shipping", where="tests/")
        return out


def check_table(plan: Any, finding: Any) -> None:
    """Checks 2 and 3 over the explicit product of the reviewed axes."""
    from repro_torch.engine.spec import ExecSpec
    from repro_torch.kernels.backend import get_backend

    for backend in KNOWN_BACKENDS:
        for layout in KNOWN_LAYOUTS:
            for precision in KNOWN_PRECISIONS:
                combo = f"{backend}:{layout}:{precision}"
                try:
                    spec = ExecSpec(backend=backend, layout=layout,
                                    precision=precision)
                    spec_ok = True
                except ValueError:
                    spec_ok = False
                if spec_ok != expected_spec_valid(backend, layout,
                                                  precision):
                    finding(f"ExecSpec validation drift for {combo}: "
                            f"construction "
                            f"{'succeeded' if spec_ok else 'failed'} but "
                            f"the documented table says otherwise",
                            where=combo)
                    continue
                if not spec_ok:
                    continue
                be = get_backend(backend)
                try:
                    pl = plan(None, spec)
                    plan_ok = True
                except ValueError:
                    plan_ok = False
                if plan_ok != expected_plan_valid(be, precision):
                    finding(f"plan() validity drift for {combo}: "
                            f"resolution "
                            f"{'succeeded' if plan_ok else 'failed'} but "
                            f"bf16-needs-mxu_dense says otherwise",
                            where=combo)
                    continue
                if not plan_ok:
                    continue
                want = expected_strategy(be, layout)
                if pl.worklist_strategy != want:
                    finding(f"planner dispatch drift for {combo}: "
                            f"worklist_strategy={pl.worklist_strategy!r}, "
                            f"documented table says {want!r}", where=combo)
                if pl.grid_sort != (layout == "block-sparse"):
                    finding(f"planner dispatch drift for {combo}: "
                            f"grid_sort={pl.grid_sort!r} but the grid_sort "
                            f"contract is block-sparse only", where=combo)


register_rule(SpecCoverageRule())
