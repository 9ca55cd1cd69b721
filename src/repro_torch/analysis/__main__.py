"""CLI for the port's static-analysis suite.

Usage::

    python -m repro_torch.analysis [paths...] [options]

Defaults to scanning ``src/repro_torch`` (when it exists under the
current directory) with the baseline at
``analysis_baseline_torch.json``. Exits 0 iff there are no unbaselined
findings and no baseline hygiene errors, 1 otherwise, and 2 for a rule
id it does not run (RA101 and RA301 do not apply to the port). ``--json``
writes the report in the shape of ``repro.analysis``'s, with ``"tool":
"repro_torch.analysis"``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
from typing import List

from .engine import TOOL, analyze
from .rules import ALL_RULES, NOT_APPLICABLE

DEFAULT_ROOT = "src/repro_torch"
DEFAULT_BASELINE = "analysis_baseline_torch.json"


def main(argv: List[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog=f"python -m {TOOL}",
        description="Static analysis of the port's serving stack "
                    "(cache-key completeness, hot-path purity, "
                    "layering).")
    ap.add_argument("paths", nargs="*",
                    help=f"files/directories to scan (default: "
                         f"{DEFAULT_ROOT})")
    ap.add_argument("--json", metavar="FILE",
                    help="write the JSON report to FILE ('-' for stdout)")
    ap.add_argument("--baseline", metavar="FILE", default=DEFAULT_BASELINE,
                    help=f"baseline file (default: {DEFAULT_BASELINE}; "
                         f"missing file = empty baseline)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline entirely")
    ap.add_argument("--rules", metavar="ID", nargs="+",
                    help="run only these rule ids (e.g. RA501)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for r in ALL_RULES:
            print(f"{r.id}  {r.name}: {r.rationale}")
        for rid, (name, why) in NOT_APPLICABLE.items():
            print(f"{rid}  {name}: not applicable — {why}")
        return 0

    paths = args.paths or ([DEFAULT_ROOT] if pathlib.Path(DEFAULT_ROOT)
                           .exists() else ["."])
    baseline = None if args.no_baseline else args.baseline
    try:
        report = analyze(paths, rules=args.rules, baseline=baseline)
    except KeyError as e:
        print(f"{TOOL}: {e.args[0]}", file=sys.stderr)
        return 2

    if args.json:
        payload = json.dumps(report.to_json(), indent=2) + "\n"
        if args.json == "-":
            sys.stdout.write(payload)
        else:
            pathlib.Path(args.json).write_text(payload, encoding="utf-8")

    for f in report.findings:
        print(f.render())
    for e in report.errors:
        print(f"error: {e}")
    n_base = len(report.baselined)
    base_note = f", {n_base} baselined" if n_base else ""
    if report.ok:
        print(f"{TOOL}: OK ({report.files} files, "
              f"{len(report.rule_meta)} rule(s){base_note})")
        return 0
    print(f"{TOOL}: {len(report.findings)} finding(s), "
          f"{len(report.errors)} error(s) across {report.files} "
          f"file(s){base_note}")
    return 1


if __name__ == "__main__":
    sys.exit(main())
