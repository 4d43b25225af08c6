"""CLI: statically verify saved design artifacts.

    python -m repro_torch.analysis ARTIFACT_DIR [ARTIFACT_DIR ...]
        [--tier cheap|strict] [--json OUT.json] [--quiet]

Runs the artifact auditor plus the program/steps (and, under
``--tier strict``, emission) passes on every directory and prints a
per-artifact summary.  Exit status 1 if any artifact produced an
error-severity diagnostic, 0 otherwise — suitable as a CI gate.
"""

from __future__ import annotations

import argparse
import json
import sys

from .verify import TIERS, verify_design


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Statically verify da4ml-design artifact directories.",
    )
    ap.add_argument("paths", nargs="+", help="artifact directories to verify")
    ap.add_argument(
        "--tier", choices=[t for t in TIERS if t != "off"], default="strict",
        help="verification tier (default: strict)",
    )
    ap.add_argument(
        "--json", metavar="OUT", default=None,
        help="write all diagnostics as one JSON document to OUT ('-' = stdout)",
    )
    ap.add_argument(
        "--quiet", action="store_true",
        help="suppress per-diagnostic lines (summaries only)",
    )
    args = ap.parse_args(argv)

    results = {}
    n_errors = 0
    for path in args.paths:
        rep = verify_design(path, tier=args.tier)
        results[path] = rep.to_dict()
        n_errors += len(rep.errors)
        status = "OK" if rep.ok else "FAIL"
        line = (
            f"{status:<5} {path}  "
            f"({len(rep.errors)} errors, {len(rep.warnings)} warnings, "
            f"tier={args.tier})"
        )
        print(line)
        if not args.quiet:
            for d in rep.diagnostics:
                print(f"    {d}")

    if args.json is not None:
        doc = json.dumps(results, indent=2, sort_keys=True)
        if args.json == "-":
            print(doc)
        else:
            with open(args.json, "w") as f:
                f.write(doc + "\n")
    return 1 if n_errors else 0


if __name__ == "__main__":
    sys.exit(main())
