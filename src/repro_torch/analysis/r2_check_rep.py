"""R2 check-rep-audit: every shard body carries an explicit
:func:`repro_torch.analysis.audit.audit_check_rep` annotation; the port of
``r2_check_rep.py``.

The reference runs its kernel-backed ``shard_map`` bodies with
``check_rep=False`` (``pallas_call`` has no replication rule) and R2
makes the human argument for why that is safe mandatory.  The port has no
``shard_map``: one process drives every shard of a
:class:`~repro_torch.launch.mesh.ShardMesh`, and a shard body is the
function that runs the per-shard work around a mesh collective —
``psum``, ``pmin``, ``all_gather`` or ``ppermute``
(``launch/mesh.py``), whose values it moves between the shards.  Nothing
checks that such a body computes each shard's rows from that shard's
inputs and makes whatever it claims identical on every shard through the
collective; the decorator records the argument, and R2 makes it
mandatory, so a new collective site cannot ship with the argument still
in its author's head.

The check is a source scan of ``src/repro_torch``.  For each call of a
collective (an attribute call named ``psum``, ``pmin``, ``all_gather`` or
``ppermute``), the body is the innermost ``def`` around it — a module
function, a method, or an inner function a factory returns (the
``stream/sharded.py`` idiom) — and it must carry an ``audit_check_rep``
decorator.  A collective with no ``def`` around it, or inside a lambda,
is unresolvable and a finding too (conservative: if the scanner cannot
name the body, a reviewer cannot either).

``launch/mesh.py`` (which defines the collectives) and
``src/repro_torch/analysis`` (whose targets call the bodies) are
excluded.
"""
from __future__ import annotations

import ast
import os
from dataclasses import dataclass
from typing import Any

from .rules import Finding, Rule, register_rule

RULE_NAME = "R2-check-rep-audit"
_DECORATOR = "audit_check_rep"
COLLECTIVES = ("psum", "pmin", "all_gather", "ppermute")
_EXCLUDED = (os.path.join("launch", "mesh.py"), "analysis")


def _is_collective(call: ast.Call) -> bool:
    f = call.func
    return isinstance(f, ast.Attribute) and f.attr in COLLECTIVES


def has_decorator(fn: Any, name: str) -> bool:
    for dec in fn.decorator_list:
        node = dec.func if isinstance(dec, ast.Call) else dec
        if isinstance(node, ast.Name) and node.id == name:
            return True
        if isinstance(node, ast.Attribute) and node.attr == name:
            return True
    return False


def scan_module(path: str, rel: str) -> list[Finding]:
    with open(path, encoding="utf-8") as fh:
        tree = ast.parse(fh.read(), filename=path)
    findings: list[Finding] = []
    reported: set = set()

    def visit(node: Any, body: Any) -> None:
        for child in ast.iter_child_nodes(node):
            inner = body
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                inner = child
            elif isinstance(child, ast.Lambda):
                inner = None
            if isinstance(child, ast.Call) and _is_collective(child):
                where = f"{rel}:{child.lineno}"
                if body is None:
                    findings.append(Finding(
                        rule=RULE_NAME, severity="error", target=rel,
                        message=(f"ShardMesh.{child.func.attr} outside any "
                                 f"named def (module level or a lambda): "
                                 f"this scanner cannot resolve its shard "
                                 f"body — make the body a named function "
                                 f"and annotate it with @audit_check_rep"),
                        where=where))
                elif not has_decorator(body, _DECORATOR) \
                        and id(body) not in reported:
                    reported.add(id(body))
                    findings.append(Finding(
                        rule=RULE_NAME, severity="error", target=rel,
                        message=(f"shard body `{body.name}` moves values "
                                 f"between shards ({child.func.attr}) but "
                                 f"carries no @audit_check_rep annotation "
                                 f"— record why it is well defined per "
                                 f"shard (see repro_torch.analysis.audit)"),
                        where=where))
            visit(child, inner)

    visit(tree, None)
    return findings


@dataclass(frozen=True)
class CheckRepAuditRule(Rule):
    name: str = RULE_NAME
    description: str = ("every function that runs per shard around a "
                        "ShardMesh collective carries an explicit "
                        "@audit_check_rep annotation")
    kind: str = "project"

    def check_project(self, repo_root: str) -> list[Finding]:
        src = os.path.join(repo_root, "src", "repro_torch")
        findings: list[Finding] = []
        for dirpath, dirnames, filenames in os.walk(src):
            dirnames.sort()
            for fname in sorted(filenames):
                if not fname.endswith(".py"):
                    continue
                path = os.path.join(dirpath, fname)
                inside = os.path.relpath(path, src)
                if inside.startswith(_EXCLUDED):
                    continue
                rel = os.path.relpath(path, repo_root)
                findings.extend(scan_module(path, rel))
        return findings


register_rule(CheckRepAuditRule())
