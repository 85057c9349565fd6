"""R7 transfer-retrace: one threshold and one answer for every ``d_cut``
spelling; the port of ``r7_transfer_retrace.py``.

The reference's plan half traces the plan's density primitive under
``d_cut`` spelled as a Python float, ``np.float32`` and ``np.float64``
and requires one jit-boundary signature: a weak-typed python float and a
strong numpy scalar would otherwise land two trace-cache entries.  Eager
PyTorch has no trace cache, so the port holds the same plan to the
property the reference's normalization exists for, on results: the plan
is called on the canonical input with ``d_cut`` as a Python float,
``np.float32``, ``np.float64`` and a 0-d tensor on the plan's device, and
every call must hand its kernels (and its plain math) one f32 ``d2cut`` —
``f32(d_cut)**2`` rounded once (``kernels/sweep.py::d2cut_of``) — and give
equal rho, delta and parent.  Any difference is an error: a threshold
squared in the spelling's own precision moves a boundary pair across
``d_cut`` for one caller and not another.  The float spelling is the
plan's canonical run (``targets.canonical_run``); the other three run
here.  All four stay, although ``DPCPlan.rho_delta`` calls ``float()``
first: that call is what the probe holds.

The reference's other half (host callbacks inside a trace, jit retrace
churn) has no compiler to guard here.  Instead the CLI sweep on the card
runs each target under ``torch.cuda.set_sync_debug_mode("warn")`` and
writes the number of host syncs it makes into the report per target
(``host_syncs``): reported, not gated.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from . import record
from .rules import Finding, Rule, register_rule

RULE_NAME = "R7-transfer-retrace"


def _spellings(d_cut: float, device: torch.device) -> list[tuple[str, Any]]:
    return [("float", float(d_cut)), ("np.float32", np.float32(d_cut)),
            ("np.float64", np.float64(d_cut)),
            ("tensor", torch.tensor(d_cut, device=device))]


def thresholds(events: list) -> set:
    """Every d2cut the record's launches and threshold steps carry."""
    out = {e.d2cut for e in record.launches(events) if e.d2cut is not None}
    return out | {s.info["d2cut"] for s in record.steps(events, "threshold")}


@dataclass(frozen=True)
class SpellingRule(Rule):
    name: str = RULE_NAME
    description: str = ("d_cut spelled as a float, np.float32, np.float64 "
                        "or a 0-d device tensor gives one f32 d2cut and "
                        "equal rho, delta and parent; host syncs per "
                        "target reported by the sweep")
    kind: str = "plan"

    def check_plan(self, pl: Any) -> list[Finding]:
        from .targets import (D_CUT, canonical_points, canonical_run,
                              gate_device, label_of, neutral, run_target)

        target = label_of(pl)
        dev = gate_device()
        x = torch.from_numpy(canonical_points()).to(dev)
        # the float spelling is the canonical run's own rho_delta target
        run = canonical_run(pl)
        given = {}
        if "rho_delta" in run.events:
            given["float"] = (run.events["rho_delta"],
                              run.outputs["rho_delta"])
        seen: dict[str, tuple] = {}
        with neutral(pl):
            for label, value in _spellings(D_CUT, dev):
                events, out = given.get(label) or run_target(
                    lambda v=value: pl.rho_delta(x, x, v))
                rho, _key, delta, parent = out
                seen[label] = (thresholds(events), rho, delta, parent)
        findings = []

        def finding(msg: str) -> None:
            findings.append(Finding(rule=self.name, severity="error",
                                    target=target, message=msg,
                                    where="<spelling-probe>"))

        every = set().union(*(v[0] for v in seen.values()))
        bad = {t for t in every if float(np.float32(t)) != t}
        if len(every) != 1 or bad:
            per = {k: sorted(v[0]) for k, v in seen.items()}
            finding(f"the d_cut spellings reach the kernels as d2cut "
                    f"{per}: not one f32 value (d2cut_of rounds "
                    f"f32(d_cut)**2 once; a threshold squared in the "
                    f"spelling's own precision moves boundary pairs)")
        base_label, base = next(iter(seen.items()))
        for label, val in seen.items():
            diff = [name for name, a, b in zip(
                ("rho", "delta", "parent"), base[1:], val[1:])
                if not torch.equal(a, b)]
            if diff:
                finding(f"d_cut spelled as {label} gives another "
                        f"{', '.join(diff)} than {base_label}")
        return findings


register_rule(SpellingRule())
