"""``python -m repro_torch.analysis``: the full static-analysis sweep.

Runs on the card unless ``--device`` says otherwise (``--device cpu``: the
kernels' plain versions, with R4's attribute checks skipped).  The
distributed and stream targets run on four logical shards of the device,
so one device is enough.

Exit status 1 iff unsuppressed error-severity findings exist (warn-only
reports pass).
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static analysis sweep over every ExecSpec and "
                    "subsystem entry point of the port")
    parser.add_argument("--out", default="-",
                        help="write the JSON report here ('-' = stdout)")
    parser.add_argument("--pretty", action="store_true",
                        help="indent the JSON report")
    parser.add_argument("--root", default=None,
                        help="repo root for the project rules "
                             "(default: derived from the package location)")
    parser.add_argument("--sarif", default=None,
                        help="also write the report as SARIF 2.1.0 here "
                             "(for code-host/IDE problem panes)")
    parser.add_argument("--baseline", default=None,
                        help="suppression file (default: baseline.json in "
                             "this package); entries carry a reason and an "
                             "expiry date")
    parser.add_argument("--device", default=None,
                        help="run the targets here (default: the card; "
                             "'cpu' runs the kernels' plain versions)")
    args = parser.parse_args(argv)

    from .report import run_sweep

    t0 = time.perf_counter()
    report = run_sweep(args.root, baseline_path=args.baseline,
                       device=args.device)
    seconds = time.perf_counter() - t0
    if args.sarif:
        from .sarif import to_sarif

        with open(args.sarif, "w", encoding="utf-8") as fh:
            json.dump(to_sarif(report), fh, indent=2, sort_keys=True)
            fh.write("\n")
        print(f"analysis: wrote SARIF to {args.sarif}", file=sys.stderr)
    text = json.dumps(report, indent=2 if args.pretty else None,
                      sort_keys=True)
    if args.out == "-":
        print(text)
    else:
        with open(args.out, "w", encoding="utf-8") as fh:
            fh.write(text + "\n")

    errors = [f for f in report["findings"] if f["severity"] == "error"]
    suppressed = [f for f in report["findings"]
                  if f["severity"] == "suppressed"]
    warns = [f for f in report["findings"]
             if f["severity"] not in ("error", "suppressed")]
    print(f"analysis: {len(report['targets'])} targets, "
          f"{len(report['skipped'])} skipped, {len(errors)} error(s), "
          f"{len(suppressed)} suppressed, {len(warns)} warning(s) on "
          f"{report['device']} in {seconds:.2f} s", file=sys.stderr)
    for f in errors:
        print(f"  [{f['rule']}] {f['target']} @ {f['where']}: "
              f"{f['message']}", file=sys.stderr)
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
