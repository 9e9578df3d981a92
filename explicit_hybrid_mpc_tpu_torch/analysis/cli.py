"""tpulint CLI for the torch port: the pre-merge gate for device-hostile
code patterns.

Lints the port package (default: ``explicit_hybrid_mpc_tpu_torch/``)
with the analysis/rules pack -- host-sync-in-jit, recompile-hazard,
dtype-discipline, obs-in-hot-loop, silent-except -- and exits nonzero
on any finding not covered by the port's own baseline
(``explicit_hybrid_mpc_tpu_torch/analysis/baseline.json``) or an inline
``# tpulint: disable=<rule>`` pragma.  It never reads or writes the JAX
package's baseline.

Usage:
    python -m explicit_hybrid_mpc_tpu_torch.analysis            # gate
    python -m explicit_hybrid_mpc_tpu_torch.analysis path/ x.py
    python -m explicit_hybrid_mpc_tpu_torch.analysis --json report.json
    python -m explicit_hybrid_mpc_tpu_torch.analysis \\
        --rules silent-except,dtype-discipline
    python -m explicit_hybrid_mpc_tpu_torch.analysis --update-baseline
    python -m explicit_hybrid_mpc_tpu_torch.analysis --no-baseline

Exit codes: 0 clean (or fully baselined/suppressed), 1 new findings,
2 usage error.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys

from explicit_hybrid_mpc_tpu_torch.analysis import engine
from explicit_hybrid_mpc_tpu_torch.analysis.rules import (all_rules,
                                                          rules_by_name)

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PACKAGE)
DEFAULT_BASELINE = os.path.join(PACKAGE, "analysis", "baseline.json")
DEFAULT_TARGET = PACKAGE


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m explicit_hybrid_mpc_tpu_torch.analysis",
        description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*",
                    help="files/directories to lint "
                         "(default: the port package)")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="baseline JSON (default: the port's "
                         "analysis/baseline.json)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline: every finding gates")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline from the current "
                         "findings and exit 0")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule ids to run "
                         "(default: all)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    ap.add_argument("--json", dest="json_out", default=None,
                    help="also write findings as JSON here "
                         "('-' = stdout)")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="summary line only")
    args = ap.parse_args(argv)

    if args.list_rules:
        for r in all_rules():
            print(f"{r.name:20s} [{r.severity}] {r.doc}")
        return 0

    rules = all_rules()
    if args.rules:
        known = rules_by_name()
        picked = []
        for name in args.rules.split(","):
            name = name.strip()
            if name not in known:
                print(f"tpulint: unknown rule {name!r} (known: "
                      f"{', '.join(sorted(known))})", file=sys.stderr)
                return 2
            picked.append(known[name])
        rules = picked

    paths = args.paths or [DEFAULT_TARGET]
    findings = engine.lint_paths(paths, rules, root=REPO)

    if args.update_baseline:
        # The package baseline covers the WHOLE package under ALL
        # rules: rewriting it from a restricted run (explicit paths or
        # --rules) would silently drop every other file's/rule's
        # baselined entries and fail the next full gate.  Scoped
        # updates are fine against an explicit --baseline file (the
        # fixture workflow).
        if (args.paths or args.rules) and os.path.abspath(
                args.baseline) == os.path.abspath(DEFAULT_BASELINE):
            print("tpulint: refusing to rewrite the package baseline "
                  "from a restricted run (explicit paths / --rules would "
                  "drop every other baselined entry); run without "
                  "targets or pass --baseline FILE", file=sys.stderr)
            return 2
        with open(args.baseline, "w", encoding="utf-8") as fh:
            json.dump(engine.baseline_payload(findings), fh, indent=2,
                      sort_keys=True)
            fh.write("\n")
        print(f"tpulint: baseline updated: {len(findings)} finding(s) "
              f"-> {os.path.relpath(args.baseline, REPO)}")
        return 0

    baseline = (engine.load_baseline(args.baseline)
                if not args.no_baseline else collections.Counter())
    new, baselined = engine.split_baselined(findings, baseline)

    if not args.quiet:
        for f in new:
            print(f.render())
        if baselined:
            print(f"tpulint: {len(baselined)} baselined finding(s) "
                  "suppressed (see --no-baseline)")
    n_err = sum(1 for f in new if f.severity == "error")
    print(f"tpulint: {len(new)} new finding(s) "
          f"({n_err} error, {len(new) - n_err} warn), "
          f"{len(baselined)} baselined, "
          f"{len(paths)} target(s)")
    if args.json_out:
        payload = {"findings": [f.to_dict() for f in new],
                   "baselined": [f.to_dict() for f in baselined]}
        if args.json_out == "-":
            json.dump(payload, sys.stdout, indent=2)
            print()
        else:
            with open(args.json_out, "w", encoding="utf-8") as fh:
                json.dump(payload, fh, indent=2)
    return 1 if new else 0
