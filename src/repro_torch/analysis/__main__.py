"""CLI: ``python -m repro_torch.analysis [--strict] [paths...]``.

Runs every source rule over the given paths (default ``src/repro_torch``)
plus the graph audit of the real step functions (``graph_audit``; skip it
with ``--no-graphs``), splits the findings against the committed
baseline, prints a report, and — under ``--strict`` — exits non-zero iff
any NEW error-severity finding survives (grandfathered findings and
warnings never fail).

``--write-baseline`` regenerates ``analysis/baseline.json`` from the
current findings (justifications must then be filled in by hand before
committing — the loader rejects entries without one).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.analysis import engine


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Source analysis and graph audit of the port "
                    "(DESIGN.md §analysis)")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/dirs to lint (default: src/repro_torch)")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 on any non-baselined error finding")
    ap.add_argument("--no-graphs", action="store_true",
                    help="skip the graph audit (make_fx of the step "
                         "functions)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable report on stdout")
    ap.add_argument("--write-baseline", action="store_true",
                    help="rewrite analysis/baseline.json from current "
                         "findings (fill in justifications before commit)")
    args = ap.parse_args(argv)

    paths = [Path(p) for p in (args.paths or
                               [engine.REPO_ROOT / "src" / "repro_torch"])]
    report = engine.run_analysis(paths, with_graphs=not args.no_graphs)

    if args.write_baseline:
        entries = engine.baseline_entries(report.new + report.baselined)
        engine.BASELINE_PATH.write_text(json.dumps(
            {"findings": entries}, indent=2) + "\n")
        print(f"wrote {len(entries)} entries to {engine.BASELINE_PATH}")
        return 0

    if args.as_json:
        json.dump({
            "new": [vars(f) for f in report.new],
            "baselined": [vars(f) for f in report.baselined],
            "fingerprints": report.fingerprints,
            "ok": report.ok(),
        }, sys.stdout, indent=2)
        print()
    else:
        for f in report.new:
            print(f.render())
        if report.baselined:
            print(f"[baseline] {len(report.baselined)} grandfathered "
                  f"finding(s) suppressed")
        for unit, fp in sorted(report.fingerprints.items()):
            print(f"[fingerprint] {unit}: {fp}")
        n_err = len(report.new_errors)
        print(f"{len(report.new)} new finding(s), {n_err} error(s)")
    if args.strict and not report.ok():
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
