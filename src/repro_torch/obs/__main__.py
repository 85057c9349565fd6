"""``python -m repro_torch.obs`` — render traces and metrics snapshots, the
port of ``repro/obs/__main__.py``.

    python -m repro_torch.obs report --trace run.jsonl [--metrics snap.json]
                                     [--json out.json] [--top N]

Reads a JSON-lines trace (written by ``obs.configure(trace_path=...)``, by
this package or the reference) and/or a metrics snapshot, prints the
phase-time table, and optionally exports the ``repro.obs/1`` snapshot.
"""
from __future__ import annotations

import argparse
import json
import sys

from . import report


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs")
    sub = ap.add_subparsers(dest="cmd", required=True)
    rp = sub.add_parser("report", help="render a trace/metrics snapshot")
    rp.add_argument("--trace", help="JSON-lines span trace file")
    rp.add_argument("--metrics",
                    help="metrics snapshot JSON (raw registry snapshot or a "
                         "repro.obs/1 run snapshot)")
    rp.add_argument("--json", dest="json_out",
                    help="write the aggregated run snapshot here")
    rp.add_argument("--top", type=int, default=None,
                    help="only show the N costliest phases")
    args = ap.parse_args(argv)

    if not args.trace and not args.metrics:
        ap.error("report needs --trace and/or --metrics")

    spans = report.load_trace(args.trace) if args.trace else []
    metrics_snap = None
    if args.metrics:
        with open(args.metrics) as f:
            metrics_snap = json.load(f)
        # a full run snapshot as well as a bare registry snapshot
        if metrics_snap.get("schema") == "repro.obs/1":
            metrics_snap = metrics_snap.get("metrics", {})

    if spans:
        phases = report.aggregate(spans)
        print(report.render_table(phases, top=args.top))
    if metrics_snap is not None:
        if spans:
            print()
        print(report.render_metrics(metrics_snap))

    if args.json_out:
        report.export_snapshot(args.json_out, spans=spans,
                               metrics_snap=metrics_snap or {})
        print(f"\nsnapshot written to {args.json_out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
