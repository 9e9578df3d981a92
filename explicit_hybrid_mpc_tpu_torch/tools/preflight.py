"""Pre-merge preflight: the port's verification battery as ONE command
with ONE verdict.

    python -m explicit_hybrid_mpc_tpu_torch.tools.preflight
    python -m explicit_hybrid_mpc_tpu_torch.tools.preflight --quick
    python -m explicit_hybrid_mpc_tpu_torch.tools.preflight --backend cpu \\
        --only lint,fleet_smoke
    python -m explicit_hybrid_mpc_tpu_torch.tools.preflight --skip chaos_suite
    python -m explicit_hybrid_mpc_tpu_torch.tools.preflight --list
    python -m explicit_hybrid_mpc_tpu_torch.tools.preflight --json -

Runs the battery in sequence, times each check, streams each check's
output to its own log file, and prints a single JSON verdict -- exit 0
iff every check that ran passed (the JAX package's scripts/preflight.py,
over the port's own checks).  Checks, cheapest first, so a lint finding
fails in seconds, not after the chaos suite:

- **lint**: the port's static analysis (``python -m
  explicit_hybrid_mpc_tpu_torch.analysis``) against its own baseline;
- **tier1**: the tier-1 pytest command of ROADMAP.md.  The tests hold
  the port against the JAX package, so the check runs only where JAX is
  installed; elsewhere it is listed under ``not_run`` with the reason;
- **chaos_suite**, **fleet_smoke**, **drift_smoke**: the port's tools
  (``tools/``), each on the backend given to ``--backend`` (default the
  card; ``--quick`` passes ``--eps 0.5``).

``bench_gate`` waits for the port's bench (ROADMAP A7): the JAX
package's scripts/bench_gate.py gates the JAX package's own bench
history, which holds no row of the port.  It is not in the battery;
``--only bench_gate`` exits non-zero saying so, and every verdict lists
it under ``not_run``, so no one takes its absence for a pass.

Verdict JSON: ``{"ok": bool, "wall_s": total, "quick": bool, "backend":
str, "checks": [{"name", "cmd", "exit", "ok", "wall_s", "log"}, ...],
"not_run": {name: reason}}`` -- also written to
``<out-dir>/preflight.json`` (default ``build/preflight/``, which git
ignores) so the next reader can see the last verdict without re-running
the battery.  With the card's backend (the default) and no card, a
battery that holds a smoke refuses to start and runs nothing.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

from explicit_hybrid_mpc_tpu_torch import device as device_lib
from explicit_hybrid_mpc_tpu_torch.parallel.launch import ROOT

PY = sys.executable
PKG = "explicit_hybrid_mpc_tpu_torch"

#: Checks of the JAX package's battery that the port cannot run yet.
WAITING = {
    "bench_gate": ("waits for ROADMAP A7 (the port's bench): "
                   "scripts/bench_gate.py gates the JAX package's "
                   "BENCH_HISTORY.jsonl, which holds no row of the port"),
}
NO_JAX = ("needs jax (the tier-1 tests hold the port against the JAX "
          "package), which is not installed here")


def battery(quick: bool, backend: str = "cuda") -> list[dict]:
    """The pre-merge checks, cheapest first.  Each entry: name, argv,
    per-check timeout (generous -- a hung check is a failure, not a
    wait), env overrides, and whether it runs on the backend."""
    smoke = ["--backend", backend] + (["--eps", "0.5"] if quick else [])
    return [
        {"name": "lint", "argv": [PY, "-m", f"{PKG}.analysis"],
         "timeout": 180, "env": {}, "device": False},
        # The ROADMAP.md tier-1 command, minus the tee/grep counting
        # wrapper (the exit code is the verdict here; the log file
        # replaces the tee).
        {"name": "tier1",
         "argv": [PY, "-m", "pytest", "tests/", "-q", "-m", "not slow",
                  "--continue-on-collection-errors",
                  "-p", "no:cacheprovider", "-p", "no:xdist",
                  "-p", "no:randomly"],
         "timeout": 870, "env": {"JAX_PLATFORMS": "cpu"}, "device": False},
        {"name": "chaos_suite",
         "argv": [PY, "-m", f"{PKG}.tools.chaos_suite"] + smoke,
         "timeout": 900, "env": {}, "device": True},
        {"name": "fleet_smoke",
         "argv": [PY, "-m", f"{PKG}.tools.fleet_smoke"] + smoke,
         "timeout": 600, "env": {}, "device": True},
        {"name": "drift_smoke",
         "argv": [PY, "-m", f"{PKG}.tools.drift_smoke"] + smoke,
         "timeout": 600, "env": {}, "device": True},
    ]


def has_jax() -> bool:
    return importlib.util.find_spec("jax") is not None


def run_check(chk: dict, out_dir: str) -> dict:
    log_path = os.path.join(out_dir, chk["name"] + ".log")
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.update(chk["env"])
    t0 = time.monotonic()
    with open(log_path, "wb") as log:
        try:
            proc = subprocess.run(chk["argv"], cwd=ROOT, env=env,
                                  stdout=log, stderr=subprocess.STDOUT,
                                  timeout=chk["timeout"])
            code: object = proc.returncode
        except subprocess.TimeoutExpired:
            code = f"timeout>{chk['timeout']}s"
    wall = time.monotonic() - t0
    ok = code == 0
    return {"name": chk["name"], "cmd": " ".join(chk["argv"]),
            "exit": code, "ok": ok, "wall_s": round(wall, 1),
            "log": log_path}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m explicit_hybrid_mpc_tpu_torch.tools.preflight",
        description="run the port's pre-merge battery; one JSON "
                    "verdict, exit 0 iff all checks pass")
    ap.add_argument("--quick", action="store_true",
                    help="pass --eps 0.5 to the smoke checks")
    ap.add_argument("--backend", choices=("cuda", "cpu"), default="cuda",
                    help="the smokes' backend: 'cuda' (default; refuses "
                         "to start without a card) or 'cpu'")
    ap.add_argument("--only", default=None,
                    help="comma-separated check names to run")
    ap.add_argument("--skip", default=None,
                    help="comma-separated check names to skip")
    ap.add_argument("--out-dir",
                    default=os.path.join(ROOT, "build", "preflight"),
                    help="per-check logs + preflight.json land here")
    ap.add_argument("--json", dest="json_out", default=None,
                    help="also write the verdict JSON here ('-' = "
                         "stdout only, no file)")
    ap.add_argument("--list", action="store_true",
                    help="print the battery and exit")
    args = ap.parse_args(argv)

    checks = battery(args.quick, args.backend)
    names = {c["name"] for c in checks} | set(WAITING)
    for flag in ("only", "skip"):
        val = getattr(args, flag)
        if val:
            unknown = set(val.split(",")) - names
            if unknown:
                ap.error(f"--{flag}: unknown check(s) "
                         f"{sorted(unknown)}; have {sorted(names)}")
    not_run = dict(WAITING)
    if not has_jax():
        not_run["tier1"] = NO_JAX
    if args.only:
        keep = set(args.only.split(","))
        refused = sorted(keep & set(not_run))
        if refused:
            ap.exit(2, "".join(f"preflight: {n} cannot run: {not_run[n]}\n"
                               for n in refused))
        checks = [c for c in checks if c["name"] in keep]
    if args.skip:
        drop = set(args.skip.split(","))
        checks = [c for c in checks if c["name"] not in drop]
    checks = [c for c in checks if c["name"] not in not_run]

    if args.list:
        for c in checks:
            print(f"{c['name']:12s} timeout {c['timeout']:>4d}s  "
                  f"{' '.join(c['argv'])}")
        for n, why in sorted(not_run.items()):
            print(f"{n:12s} not run: {why}")
        return 0
    if any(c["device"] for c in checks):
        try:
            device_lib.resolve(args.backend)
        except RuntimeError as e:
            raise SystemExit(f"preflight: {e}")

    os.makedirs(args.out_dir, exist_ok=True)
    results = []
    t0 = time.monotonic()
    for chk in checks:
        print(f"preflight: {chk['name']} ...", flush=True)
        res = run_check(chk, args.out_dir)
        results.append(res)
        tag = "ok" if res["ok"] else f"FAIL (exit {res['exit']})"
        print(f"preflight: {chk['name']}: {tag} "
              f"in {res['wall_s']}s  [{res['log']}]", flush=True)

    verdict = {"ok": all(r["ok"] for r in results),
               "wall_s": round(time.monotonic() - t0, 1),
               "quick": args.quick, "backend": args.backend,
               "checks": results, "not_run": not_run}
    out = json.dumps(verdict, indent=2)
    print(out)
    if args.json_out != "-":
        path = args.json_out or os.path.join(args.out_dir,
                                             "preflight.json")
        with open(path, "w") as f:
            f.write(out + "\n")
    if not verdict["ok"]:
        failed = [r["name"] for r in results if not r["ok"]]
        print(f"PREFLIGHT FAILED: {', '.join(failed)}", file=sys.stderr)
        return 1
    print("PREFLIGHT OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
