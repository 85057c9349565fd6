"""SARIF 2.1.0 emission for the analysis sweep, the port of
``repro/analysis/sarif.py``.

``python -m repro_torch.analysis --sarif out.sarif`` converts the sweep report
into one SARIF run so code hosts and IDE problem panes render the
findings natively.  Mapping:

* each registered rule becomes a ``tool.driver.rules`` entry (id = rule
  name, e.g. ``R6-merge-race``); the trace/baseline pseudo-rules ride
  along so every result has a rule to anchor to;
* severity ``error`` -> SARIF ``error``, ``warn`` -> ``warning``;
  baseline-``suppressed`` findings keep level ``error`` but carry a
  ``suppressions`` entry (``kind: external``) with the lease's reason —
  exactly how SARIF models accepted findings, and how viewers know to
  fold them;
* a ``where`` of ``file:line`` shape (a ``.py``, ``.json`` or ``.cu``
  file) becomes a ``physicalLocation``; launch positions
  (``launch[3]``) and the like become ``logicalLocations`` with
  ``fullyQualifiedName = target::where`` — a position in a launch record
  has no source file, and pretending otherwise would pin findings to
  wrong lines.

This module is pure (dict in, dict out) and imports nothing of the port.
"""
from __future__ import annotations

import re

SARIF_VERSION = "2.1.0"
SARIF_SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
                "master/Schemata/sarif-schema-2.1.0.json")

_FILE_LINE = re.compile(
    r"^(?P<file>[^\s:]+\.(?:py|json|cu)):(?P<line>\d+)$")

_LEVELS = {"error": "error", "warn": "warning",
           "suppressed": "error", "info": "note"}


def _location(finding: dict) -> dict:
    where = str(finding.get("where", ""))
    m = _FILE_LINE.match(where)
    if m:
        return {"physicalLocation": {
            "artifactLocation": {"uri": m.group("file")},
            "region": {"startLine": int(m.group("line"))}}}
    fq = f"{finding.get('target', '<sweep>')}::{where or '<top>'}"
    return {"logicalLocations": [{"fullyQualifiedName": fq,
                                  "kind": "function"}]}


def to_sarif(report: dict) -> dict:
    """One SARIF 2.1.0 log for a ``run_sweep`` report."""
    rule_ids: dict[str, int] = {}
    rules: list[dict] = []

    def rule_index(rid: str, description: str = "") -> int:
        if rid not in rule_ids:
            rule_ids[rid] = len(rules)
            entry: dict = {"id": rid}
            if description:
                entry["shortDescription"] = {"text": description}
            rules.append(entry)
        return rule_ids[rid]

    for name, meta in sorted(report.get("rules", {}).items()):
        rule_index(name, meta.get("description", ""))
    rule_index("trace", "target could not be traced (reported, non-fatal)")
    rule_index("baseline", "suppression-file hygiene: entries carry a "
                           "reason and an unexpired lease")

    results: list[dict] = []
    for f in report.get("findings", []):
        sev = str(f.get("severity", "warn"))
        res: dict = {
            "ruleId": str(f.get("rule", "unknown")),
            "ruleIndex": rule_index(str(f.get("rule", "unknown"))),
            "level": _LEVELS.get(sev, "warning"),
            "message": {"text": str(f.get("message", ""))},
            "locations": [_location(f)],
            "properties": {"target": f.get("target", "")},
        }
        if sev == "suppressed":
            res["suppressions"] = [{
                "kind": "external",
                "justification": str(f.get("suppressed_reason", "")),
            }]
            res["properties"]["suppressedUntil"] = \
                f.get("suppressed_until", "")
        results.append(res)

    return {
        "$schema": SARIF_SCHEMA,
        "version": SARIF_VERSION,
        "runs": [{
            "tool": {"driver": {
                "name": "repro_torch.analysis",
                "rules": rules,
            }},
            "results": results,
            "properties": {
                "ok": bool(report.get("ok", False)),
                "targets": len(report.get("targets", [])),
                "skipped": len(report.get("skipped", [])),
            },
        }],
    }
