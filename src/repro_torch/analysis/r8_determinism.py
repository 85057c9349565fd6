"""R8 determinism: order-dependent sum-like scatters need a blessing; the
port of ``r8_determinism.py``.

Float addition is not associative; a scatter whose colliding indices add
in an order the device picks can move bits from run to run.  On the card
PyTorch's ``index_add_`` / ``scatter_add_`` / ``scatter_reduce`` with a
sum lower colliding float adds to atomics, so their order is the order of
arrival.  Neither is a bug per se: counts summed in f32 are integer-exact
under any order, and some accumulations tolerate last-bit wobble by
design.  What *is* a bug is shipping one silently.

R8 is a source scan of ``src/repro_torch`` for the sum-like scatters —
``index_add_`` / ``index_add``, ``scatter_add_`` / ``scatter_add``,
``scatter_reduce`` / ``scatter_reduce_`` with ``"sum"``, ``"mean"`` or
``"prod"`` (or a reduction the scanner cannot read), and
``index_put_`` / ``index_put`` with ``accumulate=True`` (or a flag it
cannot read) — and requires each to sit lexically inside a function
decorated with :func:`repro_torch.analysis.audit.audit_determinism`,
stating why the order does not matter (integer-valued counts) or what
wobble is accepted.  ``"amax"`` / ``"amin"`` reductions are exact in any
order and are not flagged.  ``src/repro_torch/analysis`` is excluded.
"""
from __future__ import annotations

import ast
import os
from dataclasses import dataclass
from typing import Any

from .r2_check_rep import has_decorator
from .rules import Finding, Rule, register_rule

RULE_NAME = "R8-determinism"
_DECORATOR = "audit_determinism"
_ADDS = ("index_add_", "index_add", "scatter_add_", "scatter_add")
_REDUCES = ("scatter_reduce", "scatter_reduce_")
_PUTS = ("index_put_", "index_put")
_SUMLIKE = ("sum", "mean", "prod")


def _arg(call: ast.Call, pos: int, name: str) -> Any:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return call.args[pos] if len(call.args) > pos else None


def sumlike(call: ast.Call) -> str | None:
    """The scatter's name if ``call`` is an order-dependent sum-like
    scatter, else None.  Positions are the tensor methods' (``t.op(dim,
    index, src, reduce)``, ``t.index_put_(indices, values, accumulate)``);
    a ``torch.op(t, ...)`` call shifts them by one."""
    f = call.func
    if not isinstance(f, ast.Attribute):
        return None
    shift = int(isinstance(f.value, ast.Name) and f.value.id == "torch")
    if f.attr in _ADDS:
        return f.attr
    if f.attr in _REDUCES:
        red = _arg(call, 3 + shift, "reduce")
        if isinstance(red, ast.Constant) and red.value not in _SUMLIKE:
            return None
        return f.attr
    if f.attr in _PUTS:
        acc = _arg(call, 2 + shift, "accumulate")
        if acc is None or (isinstance(acc, ast.Constant)
                           and acc.value is False):
            return None
        return f.attr
    return None


def scan_module(path: str, rel: str) -> list[Finding]:
    with open(path, encoding="utf-8") as fh:
        tree = ast.parse(fh.read(), filename=path)
    findings: list[Finding] = []

    def visit(node: Any, blessed: bool, fn: str) -> None:
        for child in ast.iter_child_nodes(node):
            b, name = blessed, fn
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                b = blessed or has_decorator(child, _DECORATOR)
                name = child.name
            if isinstance(child, ast.Call) and not blessed:
                op = sumlike(child)
                if op is not None:
                    findings.append(Finding(
                        rule=RULE_NAME, severity="error", target=rel,
                        message=(f"{op} in `{fn}`: colliding indices add "
                                 f"in the order the device picks (atomics "
                                 f"on the card) and no enclosing function "
                                 f"carries an @audit_determinism blessing "
                                 f"— state why the order cannot move the "
                                 f"result (integer-valued counts) or that "
                                 f"the wobble is accepted"),
                        where=f"{rel}:{child.lineno}"))
            visit(child, b, name)

    visit(tree, False, "<module>")
    return findings


@dataclass(frozen=True)
class DeterminismRule(Rule):
    name: str = RULE_NAME
    description: str = ("order-dependent sum-like scatters (index_add_, "
                        "scatter_add_, a sum scatter_reduce, an "
                        "accumulating index_put_) sit inside an "
                        "@audit_determinism function")
    kind: str = "project"

    def check_project(self, repo_root: str) -> list[Finding]:
        src = os.path.join(repo_root, "src", "repro_torch")
        findings: list[Finding] = []
        for dirpath, dirnames, filenames in os.walk(src):
            dirnames.sort()
            if os.path.relpath(dirpath, src).startswith("analysis"):
                continue
            for fname in sorted(filenames):
                if fname.endswith(".py"):
                    path = os.path.join(dirpath, fname)
                    findings.extend(scan_module(
                        path, os.path.relpath(path, repo_root)))
        return findings


register_rule(DeterminismRule())
