"""The full analysis sweep: every ExecSpec x every subsystem target, plus
the project rules, folded into one JSON-able report; the port of
``repro/analysis/report.py``.

``run_sweep`` is what ``python -m repro_torch.analysis`` runs.  Shape::

    {"ok": bool,                  # no *unsuppressed* error findings
     "findings": [Finding.to_dict(), ...],  # suppressed ones carry
                                            # severity "suppressed" + why
     "targets": ["<spec>:<target>", ...],   # every target analyzed
     "skipped": ["<reason>", ...],          # impossible specs, with why
     "rules":   {name: {kind, description}, ...},
     "rules_run": [name, ...],              # every rule the sweep ran
     "audits":  {key: {...}, ...},          # registered shard-body audits
     "determinism_audits": {key: {...}, ...},
     "device": "cuda" | "cpu",
     "launches": {target: {kernel: calls}},   # what each target launched
     "host_syncs": {target: count} | None}    # on the card (R7's half)

Plan-time analysis is suspended for the duration
(``REPRO_ANALYSIS=suspend``): the sweep runs the same rules itself over a
superset of the plan-time targets, and a plan-time
:class:`AnalysisError` mid-sweep would surface as a failed target
instead of the real findings.

**Baseline suppressions** (``baseline.json`` in this package, or
``--baseline``): each entry matches findings by ``rule`` / ``target`` /
``where`` fnmatch globs and must carry a ``reason`` and an ``expires``
date (ISO ``YYYY-MM-DD``).  A matched error finding is downgraded to
severity ``"suppressed"`` (reported, not fatal); an entry past its expiry
is itself an error — suppressions are leases, not landfills.
"""
from __future__ import annotations

import collections
import contextlib
import datetime
import fnmatch
import json
import os
from typing import Any, Iterator

from . import record
from .rules import Finding, project_rules

BASELINE_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "baseline.json")


def _repo_root() -> str:
    # .../src/repro_torch/analysis/report.py -> repo root
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(os.path.dirname(os.path.dirname(here)))


def load_baseline(path: str) -> list[dict]:
    """Suppression entries from a baseline file (missing file: none)."""
    if not os.path.exists(path):
        return []
    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    entries = doc.get("suppressions", []) if isinstance(doc, dict) else doc
    if not isinstance(entries, list):
        raise ValueError(f"{path}: 'suppressions' must be a list")
    return entries


def _baseline_findings(entries: list[dict], path: str,
                       today: datetime.date) -> list[Finding]:
    """Malformed / expired suppression entries, as error findings."""
    out: list[Finding] = []
    for i, e in enumerate(entries):
        where = f"{os.path.basename(path)}[{i}]"
        reason = str(e.get("reason", "")).strip()
        raw_exp = str(e.get("expires", "")).strip()
        if not reason:
            out.append(Finding(
                rule="baseline", severity="error", target=path,
                message="suppression entry carries no reason — a "
                        "suppression is an argued exception, not a mute "
                        "button", where=where))
        try:
            expires = datetime.date.fromisoformat(raw_exp)
        except ValueError:
            out.append(Finding(
                rule="baseline", severity="error", target=path,
                message=f"suppression entry has no parseable 'expires' "
                        f"date (got {raw_exp!r}; want YYYY-MM-DD) — "
                        f"suppressions are leases and leases end",
                where=where))
            continue
        if expires < today:
            out.append(Finding(
                rule="baseline", severity="error", target=path,
                message=f"suppression expired {expires.isoformat()} "
                        f"(rule={e.get('rule', '*')!r} "
                        f"target={e.get('target', '*')!r}): fix the "
                        f"finding or renew the lease with a fresh "
                        f"review", where=where))
    return out


def _matches(entry: dict, f: Finding) -> bool:
    return (fnmatch.fnmatch(f.rule, str(entry.get("rule", "*")))
            and fnmatch.fnmatch(f.target, str(entry.get("target", "*")))
            and fnmatch.fnmatch(f.where, str(entry.get("where", "*"))))


def apply_baseline(findings: list[Finding], entries: list[dict],
                   today: datetime.date | None = None) -> list[dict]:
    """Finding dicts with baseline-matched errors downgraded to
    ``"suppressed"`` (the suppression's reason attached).  Expired
    entries never match — their error finding keeps the pressure on."""
    today = today or datetime.date.today()

    def live(e: dict) -> bool:
        try:
            return datetime.date.fromisoformat(
                str(e.get("expires", ""))) >= today
        except ValueError:
            return False

    live_entries = [e for e in entries if live(e)]
    out: list[dict] = []
    for f in findings:
        d = f.to_dict()
        if f.severity == "error":
            hit = next((e for e in live_entries if _matches(e, f)), None)
            if hit is not None:
                d["severity"] = "suppressed"
                d["suppressed_reason"] = str(hit.get("reason", ""))
                d["suppressed_until"] = str(hit.get("expires", ""))
        out.append(d)
    return out


@contextlib.contextmanager
def _suspended_gate() -> Iterator[None]:
    prev = os.environ.get("REPRO_ANALYSIS")
    os.environ["REPRO_ANALYSIS"] = "suspend"
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop("REPRO_ANALYSIS", None)
        else:
            os.environ["REPRO_ANALYSIS"] = prev


def run_sweep(repo_root: str | None = None,
              baseline_path: str | None = None,
              device: str | None = None) -> dict:
    """Analyze every sweep spec's targets on ``device`` (default: the card
    wherever one exists), run the project rules, apply the baseline."""
    from repro_torch.engine.planner import plan

    from .audit import all_audits, all_determinism_audits
    from .rules import all_rules, analyze_launches, launch_rules, plan_rules
    from .targets import (canonical_run, count_syncs, distributed_targets,
                          failure, label_of, neutral, on_device, run_target,
                          serve_targets, stream_targets, sweep_specs)

    root = repo_root or _repo_root()
    baseline = baseline_path or BASELINE_FILE
    findings: list[Finding] = []
    targets_run: list[str] = []
    skipped: list[str] = []
    launched: dict[str, dict] = {}
    rules_run: set[str] = set()

    with _suspended_gate(), on_device(device) as dev:
        card = dev.type == "cuda"
        syncs = {} if card else None

        def analyzed(target: str, events: list) -> None:
            launched[target] = dict(collections.Counter(
                e.kernel for e in record.launches(events)))
            findings.extend(analyze_launches(target, events))
            rules_run.update(r.name for r in launch_rules())

        def run_one(target: str, thunk: Any) -> None:
            targets_run.append(target)
            try:
                with neutral():
                    if card:
                        (events, _), syncs[target] = count_syncs(
                            lambda: run_target(thunk))
                    else:
                        events, _ = run_target(thunk)
            except Exception as exc:              # noqa: BLE001
                findings.append(failure(target, exc))
                return
            analyzed(target, events)

        for spec in sweep_specs():
            pl = plan(None, spec)
            label = label_of(pl)
            run = canonical_run(pl)
            findings.extend(run.failures)
            for name in run.names:
                targets_run.append(f"{label}:{name}")
                if card and name in run.syncs:
                    syncs[f"{label}:{name}"] = run.syncs[name]
                if name in run.events:
                    analyzed(f"{label}:{name}", run.events[name])
            for rule in plan_rules():
                findings.extend(rule.check_plan(pl))
                rules_run.add(rule.name)
            for tgts, skip in (distributed_targets(pl, dev),
                               stream_targets(pl, dev),
                               serve_targets(spec, dev)):
                skipped.extend(f"{label}:{s}" for s in skip)
                for name, thunk in tgts:
                    run_one(f"{label}:{name}", thunk)

    for rule in project_rules():
        findings.extend(rule.check_project(root))
        rules_run.add(rule.name)

    today = datetime.date.today()
    entries = load_baseline(baseline)
    findings.extend(_baseline_findings(entries, baseline, today))
    finding_dicts = apply_baseline(findings, entries, today)

    audits = {k: {"reason": a.reason, "collectives": list(a.collectives)}
              for k, a in sorted(all_audits().items())}
    det_audits = {k: {"reason": a.reason, "ops": list(a.ops),
                      "site": f"{a.file_name}:{a.function_name}"}
                  for k, a in sorted(all_determinism_audits().items())}
    rules_meta: dict[str, dict] = {}
    for r in all_rules():
        meta = rules_meta.setdefault(
            r.name, {"kind": r.kind, "description": r.description})
        if r.kind not in meta["kind"].split("+"):
            meta["kind"] += f"+{r.kind}"
    errors = [d for d in finding_dicts if d["severity"] == "error"]
    return {"ok": not errors,
            "findings": finding_dicts,
            "targets": sorted(set(targets_run)),
            "skipped": sorted(set(skipped)),
            "rules": rules_meta,
            "rules_run": sorted(rules_run),
            "audits": audits,
            "determinism_audits": det_audits,
            "device": dev.type,
            "launches": launched,
            "host_syncs": syncs}
