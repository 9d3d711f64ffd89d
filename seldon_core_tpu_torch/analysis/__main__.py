"""seldon-lint CLI for the PyTorch port: the package's invariant gate.

Runs the :mod:`seldon_core_tpu_torch.analysis` rule set (thread roles,
lock discipline, device hot-path hygiene, metric/annotation/clock
contract drift) over the given paths and fails on any finding not
covered by the checked-in baseline.

Usage:

    python -m seldon_core_tpu_torch.analysis seldon_core_tpu_torch
    python -m seldon_core_tpu_torch.analysis --rules metric-drift,annotation-drift seldon_core_tpu_torch
    python -m seldon_core_tpu_torch.analysis --write-baseline seldon_core_tpu_torch
    python -m seldon_core_tpu_torch.analysis --list-rules

Exit codes: 0 = clean (or baseline-covered), 1 = new findings, 2 = usage.

Suppression: ``# seldon-lint: disable=<rule>`` on the flagged line or as
a standalone comment on the line above; always pair it with a
justification. The baseline (``seldon_core_tpu_torch/analysis/baseline.json``)
covers accepted findings so the gate fails only on regressions; refresh
it with ``--write-baseline`` after an intentional change and check its
diff as closely as code.
"""

from __future__ import annotations

import argparse
import os
import sys

from . import core

_HERE = os.path.dirname(os.path.abspath(__file__))
# the repository root: relative paths and docs/ discovery
ROOT = os.path.dirname(os.path.dirname(_HERE))
DEFAULT_BASELINE = os.path.join(_HERE, "baseline.json")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m seldon_core_tpu_torch.analysis",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*", help="files or directories to lint")
    ap.add_argument(
        "--baseline", default=DEFAULT_BASELINE,
        help="baseline file (default seldon_core_tpu_torch/analysis/baseline.json)",
    )
    ap.add_argument(
        "--no-baseline", action="store_true",
        help="ignore the baseline: report every finding",
    )
    ap.add_argument(
        "--write-baseline", action="store_true",
        help="accept all current findings into the baseline file and exit 0",
    )
    ap.add_argument(
        "--rules", default=None,
        help="comma-separated rule ids to run (default: all)",
    )
    ap.add_argument(
        "--root", default=ROOT,
        help="repo root for relative paths and docs/ discovery",
    )
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument(
        "-q", "--quiet", action="store_true",
        help="findings only, no summary",
    )
    args = ap.parse_args(argv)

    if args.list_rules:
        from .. import analysis

        print(analysis.__doc__.split("Rule catalog", 1)[1])
        return 0
    if not args.paths:
        ap.print_usage()
        return 2

    rules = (
        [r.strip() for r in args.rules.split(",") if r.strip()]
        if args.rules else None
    )
    baseline = (
        core.load_baseline(args.baseline)
        if not (args.no_baseline or args.write_baseline) else None
    )
    try:
        result = core.run_lint(
            args.paths, root=args.root, rules=rules, baseline=baseline
        )
    except ValueError as e:
        print(f"seldon-lint: {e}", file=sys.stderr)
        return 2

    if args.write_baseline:
        core.write_baseline(args.baseline, result.findings)
        print(
            f"seldon-lint: wrote {len(result.findings)} accepted finding(s) "
            f"to {os.path.relpath(args.baseline, args.root)}"
        )
        return 0

    for f in result.findings:
        print(f.format())
    if not args.quiet:
        print(
            f"seldon-lint: {len(result.findings)} finding(s) "
            f"({len(result.baselined)} baselined, "
            f"{len(result.suppressed)} suppressed) "
            f"across {result.files} file(s)",
            file=sys.stderr,
        )
    return result.exit_code


if __name__ == "__main__":
    raise SystemExit(main())
