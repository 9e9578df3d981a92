"""The bench regression gate over the port's own history: a candidate row
against the trailing window of comparable rows, one verdict.

    python -m explicit_hybrid_mpc_tpu_torch.tools.bench_gate
    python -m explicit_hybrid_mpc_tpu_torch.tools.bench_gate RESULT.json
    python -m explicit_hybrid_mpc_tpu_torch.tools.bench_gate --update DIR
    python -m explicit_hybrid_mpc_tpu_torch.tools.bench_gate \\
        --tol value=0.05 --window 8 --json verdict.json

The JAX package's scripts/bench_gate.py (``gate``, ``roll_history``,
``_parse_tols``, ``main``) over the port's rows: the same gated metrics,
directions, tolerances and absolute slacks (bench_history.GATED_METRICS),
the same verdict lines and exit codes (1 on a regression, else 0).  What
differs:

- **Comparable rows** share, besides the JAX rule's platform and serve
  workload shape, the card's ``device_name`` and ``power_limit``: a card
  held below its maximum runs slower under load.  A row whose
  ``contended`` is null (contention not measured) is comparable, as the
  JAX rule reads a falsy value.
- **Where it reads**: the port's history (bench_history.history_path:
  ``BENCH_HISTORY``, else ``BENCH_HISTORY_TORCH.jsonl``; the JAX
  package's ``BENCH_HISTORY.jsonl`` is refused), never the repository
  root's ``BENCH_*.json``, which are the JAX package's TPU and CPU
  captures.  With no candidate path the candidate is the history's
  newest row, gated against the rows before it (every bench of the port
  appends its row).  A candidate path must be a result of the port's
  benches (``PACKAGE_KEY``).
- **``--update DIR``** rolls the ``BENCH_*.json`` of DIR that the port's
  benches wrote (``PACKAGE_KEY``) into the history and names the others
  it skipped; it refuses without a directory and refuses the repository
  root.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

from explicit_hybrid_mpc_tpu_torch.parallel.launch import ROOT
from explicit_hybrid_mpc_tpu_torch.tools.bench_history import (
    GATED_METRICS, PACKAGE, PACKAGE_KEY, append_history, history_path,
    load_history, summarize)


def is_port_result(bench: dict) -> bool:
    """Whether a bench JSON (or a capture wrapper around one) is a
    result of the port's benches."""
    if isinstance(bench.get("parsed"), dict):
        bench = bench["parsed"]
    return bench.get(PACKAGE_KEY) == PACKAGE


def roll_history(bench_dir: str, path: str) -> tuple[list, list]:
    """Fold every port result among `bench_dir`'s BENCH_*.json not yet in
    the history at `path` into it, oldest first; (the rows added, the
    names of the files skipped as not the port's or unreadable)."""
    if os.path.realpath(bench_dir) == os.path.realpath(ROOT):
        raise ValueError(f"{bench_dir} is the repository root, whose "
                         "BENCH_*.json are the JAX package's captures")
    added, skipped = [], []
    paths = sorted(glob.glob(os.path.join(bench_dir, "BENCH_*.json")),
                   key=os.path.getmtime)
    seen = {(r.get("source"), r.get("mtime")) for r in load_history(path)}
    for p in paths:
        try:
            with open(p) as f:
                bench = json.load(f)
        except (OSError, json.JSONDecodeError):
            skipped.append(os.path.basename(p))
            continue
        if not isinstance(bench, dict) or not is_port_result(bench):
            skipped.append(os.path.basename(p))
            continue
        row = append_history(bench, p, path, mtime=os.path.getmtime(p),
                             seen=seen)
        if row is not None:
            added.append(row)
    return added, skipped


def gate(candidate: dict, history: list[dict], tol: dict | None = None,
         window: int = 5) -> tuple[list[str], list[str]]:
    """(regression flags, info lines) for `candidate` against the mean of
    the trailing `window` comparable rows of `history` carrying each
    metric (scripts/bench_gate.py's gate; comparable rows also share the
    candidate's device_name and power_limit)."""
    tol = tol or {}
    flags: list[str] = []
    info: list[str] = []
    if candidate.get("error"):
        info.append(f"candidate carries error={candidate['error']!r}: "
                    "nothing to gate")
        return flags, info
    if candidate.get("contended"):
        info.append("candidate capture was CONTENDED: numbers are "
                    "known-degraded, gating skipped")
        return flags, info

    def _workload(r: dict) -> tuple:
        # The serve workload (tenants, skew) and the card (its name and
        # power limit); rows without them compare equal.
        return (r.get("tenants") or 0, float(r.get("skew") or 0.0),
                r.get("device_name"), r.get("power_limit"))

    base = [r for r in history
            if r.get("platform") == candidate.get("platform")
            and not r.get("contended") and not r.get("error")
            and r.get("source") != candidate.get("source")
            and _workload(r) == _workload(candidate)]
    if not base:
        info.append(f"no comparable history rows (platform="
                    f"{candidate.get('platform')!r}): gate vacuously "
                    "passes -- run with --update to start the history")
        return flags, info
    for metric, spec in GATED_METRICS.items():
        direction, default_tol = spec[0], spec[1]
        abs_slack = spec[2] if len(spec) > 2 else 0.0
        cand = candidate.get(metric)
        if cand is None:
            continue
        # Rows carrying this metric first, then the window: another
        # metric family's rows must not push this family's out of it.
        carrying = [r for r in base
                    if isinstance(r.get(metric), (int, float))]
        vals = [r[metric] for r in carrying[-window:]]
        # Zeros carry no information for a purely relative metric; a
        # metric with an absolute slack keeps them (0 is its healthy
        # state).
        if len(spec) <= 2:
            vals = [v for v in vals if v != 0]
        if not vals:
            continue
        ref = sum(vals) / len(vals)
        t = tol.get(metric, default_tol)
        if ref == 0:
            regressed = (cand > abs_slack) if direction == "lower" \
                else (cand < -abs_slack)
            line = (f"{metric}: {cand:.4g} vs trailing-{len(vals)} "
                    f"mean 0 (abs slack {abs_slack:g})")
        else:
            delta = cand / ref - 1
            if direction == "higher":
                regressed = delta < -t and cand < ref - abs_slack
            else:
                regressed = delta > t and cand > ref + abs_slack
            verb = "higher" if delta >= 0 else "lower"
            line = (f"{metric}: {cand:.4g} vs trailing-{len(vals)} "
                    f"mean {ref:.4g} ({100 * abs(delta):.1f}% {verb}, "
                    f"tol {100 * t:.0f}%)")
        if regressed:
            flags.append("REGRESSION " + line)
        else:
            info.append("ok " + line)
    return flags, info


def _parse_tols(pairs: list[str]) -> dict:
    out: dict[str, float] = {}
    for kv in pairs:
        if "=" not in kv:
            raise SystemExit(f"--tol needs METRIC=FRAC, got {kv!r}")
        k, v = kv.split("=", 1)
        if k not in GATED_METRICS:
            raise SystemExit(f"unknown gated metric {k!r} (known: "
                             f"{', '.join(GATED_METRICS)})")
        out[k] = float(v)
    return out


#: --update given without a directory.
_NO_DIR = object()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m explicit_hybrid_mpc_tpu_torch.tools.bench_gate",
        description=__doc__.splitlines()[0])
    ap.add_argument("candidate", nargs="?", default=None,
                    help="a result JSON of the port's benches to gate "
                         "(default: the history's newest row)")
    ap.add_argument("--history", default=None,
                    help="history path (default BENCH_HISTORY, else "
                         "BENCH_HISTORY_TORCH.jsonl)")
    ap.add_argument("--update", nargs="?", const=_NO_DIR, default=None,
                    metavar="DIR",
                    help="first roll DIR's un-summarized BENCH_*.json "
                         "results of the port into the history")
    ap.add_argument("--window", type=int, default=5,
                    help="trailing history rows per metric (default 5)")
    ap.add_argument("--tol", action="append", default=[],
                    metavar="METRIC=FRAC",
                    help="per-metric relative tolerance override "
                         "(repeatable)")
    ap.add_argument("--json", dest="json_out", default=None,
                    help="write the structured verdict here")
    args = ap.parse_args(argv)
    tols = _parse_tols(args.tol)

    try:
        hist_path = history_path(args.history)
    except ValueError as e:
        raise SystemExit(f"bench gate: {e}")
    if hist_path is None:
        print("bench gate: the history is off (BENCH_HISTORY is empty); "
              "nothing to gate", file=sys.stderr)
        return 0
    if args.update is _NO_DIR:
        raise SystemExit("bench gate: --update needs the directory whose "
                         "BENCH_*.json to roll; the repository root's are "
                         "the JAX package's captures, never rolled")
    if args.update is not None:
        try:
            added, skipped = roll_history(args.update, hist_path)
        except ValueError as e:
            raise SystemExit(f"bench gate: {e}")
        print(f"history: {len(added)} new row(s) rolled into "
              f"{os.path.basename(hist_path)}", file=sys.stderr)
        if skipped:
            print(f"history: skipped {len(skipped)} file(s) that are not "
                  f"the port's results: {', '.join(skipped)}",
                  file=sys.stderr)

    history = load_history(hist_path)
    if args.candidate is not None:
        with open(args.candidate) as f:
            bench = json.load(f)
        if not is_port_result(bench):
            raise SystemExit(f"bench gate: {args.candidate} is not a result "
                             f"of the port's benches (no {PACKAGE_KEY!r} "
                             f"{PACKAGE!r}); the gate reads no JAX capture")
        candidate = summarize(bench, args.candidate,
                              mtime=os.path.getmtime(args.candidate))
        name = os.path.basename(args.candidate)
    elif history:
        candidate, history = history[-1], history[:-1]
        name = candidate.get("source")
    else:
        print(f"no row in {os.path.basename(hist_path)}; nothing to gate",
              file=sys.stderr)
        return 0
    flags, info = gate(candidate, history, tol=tols, window=args.window)

    print(f"bench gate: {name} vs {os.path.basename(hist_path)} "
          f"({len(history)} rows, window {args.window})")
    for line in info:
        print("  " + line)
    for line in flags:
        print("  " + line)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump({"candidate": candidate, "flags": flags,
                       "info": info}, f, indent=2)
    if flags:
        print(f"GATE FAILED: {len(flags)} regression(s)")
        return 1
    print("GATE OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
