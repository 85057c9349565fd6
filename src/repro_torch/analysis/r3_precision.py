"""R3 precision-flow: a bf16 sweep's winners pass through the f32
direct-difference resolve before the target returns.

The bf16 sweeps (K12, K13 and their gated forms) evaluate expanded-form
squared distances with a bf16 cross term — absolute error
~eps*(|x|^2+|y|^2), a *large relative* error for small distances, which
flips near-tie argmins.  The contract (the port's rules in ``ROADMAP.md``,
the reference's ``refine_topk_d2`` / ``_fused_resolve``) is that every
bf16 path re-evaluates its kept candidates in direct-difference f32
(``kernels/backend.py::_fused_resolve`` given ``x`` and ``y``), so the
winner and its value are exact whenever the true NN is within the kept 8.

A refactor that drops the re-evaluation changes no shapes and no tests on
well-separated data — the silent-regression class a static check catches.
The resolve is Python, not a kernel, so the launch record logs it as a
step of its own (``record.Step("resolve", direct=...)``); R3 fires when a
target's record holds a bf16 sweep launch with no direct resolve after it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from . import record
from .rules import Finding, Rule, register_rule

RULE_NAME = "R3-precision-flow"


def is_bf16_sweep(kernel: str) -> bool:
    return "count_topk_bf16" in kernel


@dataclass(frozen=True)
class PrecisionFlowRule(Rule):
    name: str = RULE_NAME
    description: str = ("a bf16 sweep launch (K12, K13) is followed by the "
                        "f32 direct-difference resolve of its kept "
                        "candidates before the target returns")
    kind: str = "launch"

    def check_launches(self, target: str, events: Any) -> list[Finding]:
        pending = None
        for pos, e in enumerate(events):
            if isinstance(e, record.Launch) and is_bf16_sweep(e.kernel):
                pending = pending or (pos, e)
            elif isinstance(e, record.Step) and e.kind == "resolve" \
                    and e.info.get("direct"):
                pending = None
        if pending is None:
            return []
        pos, e = pending
        return [Finding(
            rule=self.name, severity="error", target=target,
            message=(f"{e.kernel}: bf16 sweep with no f32 direct-difference "
                     f"resolve of its kept candidates after it — expanded-"
                     f"form d2 error flips near-tie NN winners (the "
                     f"_fused_resolve contract, kernels/backend.py)"),
            where=f"launch[{pos}]")]


register_rule(PrecisionFlowRule())
