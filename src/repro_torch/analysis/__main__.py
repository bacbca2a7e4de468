"""CLI: ``python -m repro_torch.analysis [paths...] [--json] [--baseline F]
[--no-baseline] [--only IDS] [--list-rules]``.

With no paths it scans ``src/repro_torch`` of the repository it is run
from, ``csrc/`` included.  Exit codes: 0 clean, 1 findings (or unused
waivers), 2 bad usage.  The default baseline is the committed
``src/repro_torch/analysis/baseline.json``; ``--no-baseline`` audits the raw
findings.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from repro_torch.analysis import engine

_DEFAULT_BASELINE = Path(__file__).parent / "baseline.json"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's contract checker")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/dirs to scan (default: src/repro_torch)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable report (deterministic bytes)")
    ap.add_argument("--baseline", type=Path, default=None,
                    help=f"waiver file (default {_DEFAULT_BASELINE})")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the committed baseline")
    ap.add_argument("--only", default=None,
                    help="comma-separated rule ids to run (e.g. CU101,RC203)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    try:
        args = ap.parse_args(argv)
    except SystemExit as e:
        return 0 if e.code == 0 else 2

    if args.list_rules:
        for rule in engine.all_rules():
            print(f"{rule.id}  {rule.title}")
        return 0

    paths = [Path(p) for p in args.paths] if args.paths else None
    if paths is None:
        root = engine.find_root(Path.cwd())
        if root is None:
            print("error: no paths given and no repository root found "
                  "(run from the repository or pass paths)", file=sys.stderr)
            return 2
        paths = [root / engine.PORT]
    for p in paths:
        if not p.exists():
            print(f"error: no such path {p}", file=sys.stderr)
            return 2

    baseline = {} if args.no_baseline else engine.load_baseline(
        args.baseline if args.baseline is not None else _DEFAULT_BASELINE)
    only = args.only.split(",") if args.only else None
    if only is not None:
        known = {r.id for r in engine.all_rules()}
        unknown = sorted(set(only) - known)
        if unknown:
            print(f"error: unknown rule ids {unknown}; known: {sorted(known)}",
                  file=sys.stderr)
            return 2
    report = engine.run(paths, only=only, baseline=baseline)
    print(engine.render_json(report) if args.as_json
          else engine.render_text(report))
    return 1 if (report.findings or report.unused_waivers) else 0


if __name__ == "__main__":
    sys.exit(main())
