"""Render traces and metrics into a phase-time table and a snapshot, the
port of ``repro/obs/report.py`` (the same functions, output and schema).

Aggregation is by span *path* (``engine.fit/approxdpc.rho_delta``): every
occurrence of the same phase under the same ancestry folds into one row
with count / total host / total device / self time.  ``self_s`` is host
time not covered by child spans — the orchestration overhead of a phase.
"""
from __future__ import annotations

import json

from . import metrics as _metrics
from . import tracer as _tracer

__all__ = ["load_trace", "aggregate", "render_table", "render_metrics",
           "export_snapshot", "build_snapshot"]


def load_trace(path: str) -> list[dict]:
    """Parse a JSON-lines trace file into span records."""
    out: list[dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def aggregate(spans: list[dict]) -> dict[str, dict]:
    """Fold span records into per-path phase rows.

    Returns ``{path: {count, host_s, device_s, self_s, depth}}`` with
    ``device_s`` ``None`` when no occurrence fenced device work.
    """
    phases: dict[str, dict] = {}
    child_host: dict[int, float] = {}  # parent span id -> sum of child host_s
    for rec in spans:
        p = rec.get("parent")
        if p is not None:
            child_host[p] = child_host.get(p, 0.0) + rec.get("host_s", 0.0)
    for rec in spans:
        path = rec.get("path", rec.get("name", "?"))
        row = phases.setdefault(path, {"count": 0, "host_s": 0.0,
                                       "device_s": None, "self_s": 0.0,
                                       "depth": rec.get("depth", 0)})
        host = rec.get("host_s", 0.0)
        row["count"] += 1
        row["host_s"] += host
        row["self_s"] += max(0.0, host - child_host.get(rec.get("id"), 0.0))
        dev = rec.get("device_s")
        if dev is not None:
            row["device_s"] = (row["device_s"] or 0.0) + dev
    return phases


def _fmt_s(v: float | None) -> str:
    if v is None:
        return "-"
    if v >= 1.0:
        return f"{v:.3f}s"
    if v >= 1e-3:
        return f"{v * 1e3:.2f}ms"
    return f"{v * 1e6:.1f}us"


def render_table(phases: dict[str, dict], top: int | None = None) -> str:
    """Phase-time table, tree-indented by path depth, roots first."""
    if not phases:
        return "(no spans recorded)"
    root_host = sum(r["host_s"] for r in phases.values() if r["depth"] == 0)
    rows = sorted(phases.items(), key=lambda kv: kv[0])
    if top is not None:
        keep = sorted(rows, key=lambda kv: -kv[1]["host_s"])[:top]
        kept = {k for k, _ in keep}
        rows = [kv for kv in rows if kv[0] in kept]
    name_w = max(24, max(len(_indent_name(p, r)) for p, r in rows) + 2)
    hdr = (f"{'phase':<{name_w}} {'count':>6} {'host':>10} {'device':>10} "
           f"{'self':>10} {'%run':>6}")
    lines = [hdr, "-" * len(hdr)]
    for path, row in rows:
        pct = 100.0 * row["host_s"] / root_host if root_host > 0 else 0.0
        lines.append(
            f"{_indent_name(path, row):<{name_w}} {row['count']:>6} "
            f"{_fmt_s(row['host_s']):>10} {_fmt_s(row['device_s']):>10} "
            f"{_fmt_s(row['self_s']):>10} {pct:>5.1f}%")
    return "\n".join(lines)


def _indent_name(path: str, row: dict) -> str:
    return "  " * row["depth"] + path.rsplit("/", 1)[-1]


def render_metrics(snap: dict) -> str:
    """Flat ``name{labels} = value`` listing of a metrics snapshot."""
    lines: list[str] = []
    for name, fam in sorted(snap.items()):
        for key, val in sorted(fam.get("values", {}).items()):
            label = f"{{{key}}}" if key else ""
            if isinstance(val, dict):  # histogram stats
                val = ("count=%d sum=%.6g min=%.6g max=%.6g"
                       % (val["count"], val["sum"], val["min"], val["max"]))
            lines.append(f"{name}{label} = {val}")
    return "\n".join(lines) if lines else "(no metrics recorded)"


def build_snapshot(spans: list[dict] | None = None,
                   metrics_snap: dict | None = None) -> dict:
    """Machine-readable run snapshot: aggregated phases + metric values."""
    if spans is None:
        spans = _tracer.spans()
    if metrics_snap is None:
        metrics_snap = _metrics.snapshot()
    return {"schema": "repro.obs/1",
            "level": _tracer.level(),
            "phases": aggregate(spans),
            "metrics": metrics_snap}


def export_snapshot(path: str, spans: list[dict] | None = None,
                    metrics_snap: dict | None = None) -> dict:
    """Write :func:`build_snapshot` as JSON to ``path`` and return it."""
    snap = build_snapshot(spans, metrics_snap)
    with open(path, "w") as f:
        json.dump(snap, f, indent=2, sort_keys=True, default=str)
        f.write("\n")
    return snap
