"""Fleet-telemetry smoke: the per-process obs streams of a supervised
2-process build must reconcile EXACTLY with the single-process build's
totals.

    python -m explicit_hybrid_mpc_tpu_torch.tools.fleet_smoke
    python -m explicit_hybrid_mpc_tpu_torch.tools.fleet_smoke --sharded
    python -m explicit_hybrid_mpc_tpu_torch.tools.fleet_smoke \\
        --backend cpu --eps 0.5

The fleet aggregation layer (obs/fleet.py) claims that summing N
per-process streams' final metrics snapshots reproduces what one process
would have recorded.  This tool makes that claim a gate (the JAX
package's scripts/fleet_smoke.py, with its counters, bars and exit
codes):

1. **Reference**: the tier-1 double-integrator build (N=3,
   theta_box=1.5, eps 0.2, 64 simplices a batch, checkpoints every 4
   steps) single-process with ``--obs jsonl --obs-per-process`` -- one
   suffixed stream whose final snapshot holds the ground-truth counters.
2. **Fleet**: the same build under tools/supervise_build.py with an
   injected ``os._exit`` at the 2nd ``checkpoint.written`` site -- the
   checkpoint is fully on disk, the process dies at the boundary, and
   the supervisor resumes a SECOND process from it.  Two processes =>
   two per-process streams, each ending in a metrics snapshot (the
   engine flushes one per checkpoint, before the injection site, so a
   boundary kill ships its totals).
3. **Reconcile**: ``tools.obs_report --fleet --strict`` over the two
   streams must exit 0 (schema v2 + identity everywhere, one shared
   run_id from the supervisor's EHM_RUN_ID), and the rollup's summed
   counters must EQUAL the reference stream's -- bit-exactly, they are
   integers -- while the trees match node for node.

A crash at the checkpoint BOUNDARY is the one restart shape with zero
replayed work (the resumed session re-executes nothing), which is what
makes exact counter equality the right assertion; mid-interval crashes
re-execute the steps since the checkpoint and their streams
legitimately over-count.

``--sharded`` runs the 2-process SHARDED build (parallel/launch.py,
``main --shard-frontier``) instead of the restart chain, speculation off
in both runs: its leaf, split and solve counters must sum bit-exactly to
the single process's and the tree must be canonically identical.  The
double integrator has one commutation, so no warm-start knife edge can
move the sharded tree there (a hybrid problem's sharded tree is held
only to a region bar; see ROADMAP.md section C).

Every build runs on the CUDA device unless ``--backend cpu`` is given;
without a card the default refuses to start.  A child that loses its
card ends with ``device.NoCpuFallback`` (exit 69): that fails the smoke
and is not retried.  The verdict JSON (``--json``) carries the
reconciliation, the tree diffs and every failure.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

from explicit_hybrid_mpc_tpu_torch import device as device_lib
from explicit_hybrid_mpc_tpu_torch.parallel.launch import MAIN, ROOT
from explicit_hybrid_mpc_tpu_torch.tools import chaos_suite

TIMEOUT_S = 900.0

#: Counters whose fleet-rollup sum must equal the reference stream's
#: value exactly (all integers; every one counts work the session
#: itself executed, so a zero-replay restart chain partitions them).
RECONCILED_COUNTERS = (
    "build.steps", "build.leaves", "build.splits",
    "build.oracle_solves", "oracle.point_solves",
    "oracle.simplex_solves",
)

#: The --sharded subset: a sharded build partitions the LEAF/SPLIT/
#: SOLVE work across shards (bit-exact sums -- zero duplicate solves),
#: but each shard batches its own sub-frontier, so build.steps
#: legitimately differs from the single-process schedule and is
#: excluded.
SHARDED_RECONCILED_COUNTERS = (
    "build.leaves", "build.splits",
    "oracle.point_solves", "oracle.simplex_solves",
)


def _build_argv(out_prefix: str, eps: float, batch: int,
                backend: str = "cuda") -> list[str]:
    """The chaos suite's build argv (the same fixture, checkpoints every
    4 steps) with one obs stream a process."""
    return chaos_suite.build_argv(out_prefix, eps, batch, backend) \
        + ["--obs", "jsonl", "--obs-per-process"]


def run_build(out_prefix: str, eps: float, batch: int,
              backend: str = "cuda", plan_path: str | None = None,
              supervised: bool = False, timeout_s: float = TIMEOUT_S,
              extra_argv: list[str] | None = None,
              entry: list[str] | None = None) -> dict:
    """One build (supervised: a restart chain under
    tools/supervise_build.py, at most 2 restarts), its children's output
    to ``<out_prefix>.log``; returns {rc, wall_s, hung, log (the tail)}
    and, supervised, the attempts.  `entry` is the command before the
    build argv (default ``python -m explicit_hybrid_mpc_tpu_torch.main``)."""
    from explicit_hybrid_mpc_tpu_torch.tools.supervise_build import (
        run_supervised)

    argv = _build_argv(out_prefix, eps, batch, backend) + (extra_argv or [])
    env = chaos_suite._env()
    if plan_path is not None:
        env["EHM_FAULT_PLAN"] = plan_path
    log_path = out_prefix + ".log"
    t0 = time.time()
    row: dict = {}
    with open(log_path, "wb") as log:
        if supervised:
            sup = run_supervised(argv, out_prefix + ".ckpt.pkl",
                                 max_restarts=2, attempt_timeout_s=timeout_s,
                                 entry=entry, env=env, stdout=log,
                                 stderr=subprocess.STDOUT)
            rc = sup["rc"]
            hung = any(a["rc"] == -9 for a in sup["attempts"])
            row["attempts"] = [{k: a[k] for k in ("rc", "resumed_from",
                                                  "wall_s")}
                               for a in sup["attempts"]]
        else:
            try:
                rc = subprocess.call(list(entry or MAIN) + argv, env=env,
                                     cwd=ROOT, stdout=log,
                                     stderr=subprocess.STDOUT,
                                     timeout=timeout_s)
                hung = False
            except subprocess.TimeoutExpired:
                rc, hung = -9, True
    row.update(rc=rc, wall_s=round(time.time() - t0, 1), hung=hung,
               log=chaos_suite._tail(log_path, 2000))
    return row


def _failed_build(what: str, r: dict) -> str:
    """The message for a build that did not finish; a child that lost
    its card says so (it is never retried)."""
    rcs = [r.get("rc")] + list(r.get("rcs") or []) \
        + [a["rc"] for a in r.get("attempts", [])]
    lost = device_lib.NO_CPU_FALLBACK_EXIT in rcs
    return (f"fleet_smoke: {what} failed (rc {r.get('rc')}, hung "
            f"{r.get('hung')})"
            + (f": a child lost its card (NoCpuFallback, exit "
               f"{device_lib.NO_CPU_FALLBACK_EXIT}); not retried"
               if lost else ""))


def _stream_counters(prefix: str) -> tuple[dict, list]:
    """(final-snapshot counters, streams) for one build prefix's
    per-process obs stream family."""
    from explicit_hybrid_mpc_tpu_torch.obs import fleet as fleet_lib

    streams = fleet_lib.load_fleet(prefix + ".obs.jsonl")
    roll = fleet_lib.fleet_rollup(streams)
    return roll["counters"], streams


def _fleet_report(pattern: str, rep_json: str) -> int:
    """``tools.obs_report <pattern> --fleet --strict --json rep_json``
    in this process; its exit code."""
    from explicit_hybrid_mpc_tpu_torch.tools import obs_report

    return obs_report.main([pattern, "--fleet", "--strict",
                            "--json", rep_json])


def run_sharded_smoke(wd: str, args, verdict: dict,
                      failures: list[str],
                      entry: list[str] | None = None) -> int:
    """--sharded mode: the 2-process SHARDED DI build (not a supervised
    restart chain) must reconcile counters bit-exactly with the
    single-process build and produce a node-for-node identical tree
    (canonical comparison -- the merged tree orders nodes per-subtree).
    Speculation is off in BOTH runs: it is timing-gated and disabled
    under sharding, and the zero-duplicate bar is exact equality, not a
    budget.  `args` carries eps, batch, backend and timeout."""
    from explicit_hybrid_mpc_tpu_torch.obs import fleet as fleet_lib
    from explicit_hybrid_mpc_tpu_torch.parallel.launch import launch_sharded

    ref = os.path.join(wd, "straight")
    print(f"fleet_smoke[sharded]: single-process reference "
          f"(eps {args.eps}) ...", file=sys.stderr)
    argv_extra = ["--no-speculate"]
    r = run_build(ref, args.eps, args.batch, args.backend,
                  timeout_s=args.timeout, extra_argv=argv_extra, entry=entry)
    verdict["reference"] = {k: v for k, v in r.items() if k != "log"}
    if r["rc"] != 0 or r["hung"]:
        print(_failed_build("reference build", r) + "\n" + r["log"],
              file=sys.stderr)
        return 2
    flt = os.path.join(wd, "sharded")
    print("fleet_smoke[sharded]: 2-process sharded build ...",
          file=sys.stderr)
    r = launch_sharded(
        _build_argv(flt, args.eps, args.batch, args.backend) + argv_extra,
        n_processes=2, timeout_s=args.timeout, entry=entry, cwd=ROOT)
    verdict["sharded"] = {k: r[k] for k in
                          ("rc", "rcs", "wall_s", "hung")}
    if r["rc"] != 0 or r["hung"]:
        print(_failed_build(f"sharded build ({r['rcs']})", r) + "\n"
              + "\n".join(t[-800:] for t in r["stderr"]), file=sys.stderr)
        return 2

    ref_counters, _ref_streams = _stream_counters(ref)
    streams = fleet_lib.load_fleet(flt + ".obs.jsonl")
    roll = fleet_lib.fleet_rollup(streams)
    verdict["n_fleet_streams"] = len(streams)
    if len(streams) != 2:
        failures.append(f"expected 2 per-shard streams, got "
                        f"{len(streams)}")
    run_ids = {s.identity.get("run_id") for s in streams
               if s.identity}
    if len(run_ids) != 1:
        failures.append(f"shard streams carry {len(run_ids)} run_ids; "
                        "the launcher's EHM_RUN_ID should unify them")
    recon = {}
    for key in SHARDED_RECONCILED_COUNTERS:
        a, b = ref_counters.get(key), roll["counters"].get(key)
        recon[key] = {"reference": a, "sharded_sum": b}
        if a != b:
            failures.append(f"counter {key}: sharded sum {b} != "
                            f"single-process {a}")
    verdict["reconciliation"] = recon

    with open(ref + ".stats.json") as f:
        ref_stats = json.load(f)
    with open(flt + ".stats.json") as f:
        flt_stats = json.load(f)
    verdict["regions"] = ref_stats["regions"]
    verdict["per_shard"] = flt_stats.get("per_shard")
    if ref_stats["regions"] != flt_stats["regions"]:
        failures.append(f"regions {flt_stats['regions']} != reference "
                        f"{ref_stats['regions']}")
    if roll.get("regions_sum") != ref_stats["regions"]:
        failures.append(f"rollup regions_sum {roll.get('regions_sum')} "
                        f"!= reference {ref_stats['regions']}")
    if flt_stats.get("shard_fallback_cells"):
        failures.append(
            f"{flt_stats['shard_fallback_cells']} remote cells hit "
            "the local-fallback timeout (duplicate solves)")
    diffs = chaos_suite.compare_trees_canonical_paths(ref + ".tree.pkl",
                                                      flt + ".tree.pkl")
    verdict["tree_diffs"] = diffs
    if diffs:
        failures.append("tree DIVERGED -- " + "; ".join(diffs))

    rc = _fleet_report(flt + ".obs.p*.jsonl",
                       os.path.join(wd, "fleet_report.json"))
    verdict["obs_report_rc"] = rc
    if rc != 0:
        failures.append(f"obs_report --fleet --strict exited {rc}")
    if not failures:
        print(f"FLEET SMOKE (sharded) OK: 2 shards reconcile exactly "
              f"({ref_stats['regions']} regions, "
              f"{len(SHARDED_RECONCILED_COUNTERS)} counters bit-equal, "
              "tree node-for-node identical)", file=sys.stderr)
    return 0


def run_chain_smoke(wd: str, args, verdict: dict, failures: list[str],
                    entry: list[str] | None = None) -> int:
    """The default mode: the supervised restart chain killed at its 2nd
    checkpoint boundary against the single-process build (module
    docstring).  Returns 2 when a build did not finish, else 0 (the
    reconciliation's verdict is in `failures`)."""
    ref = os.path.join(wd, "straight")
    print(f"fleet_smoke: single-process reference build "
          f"(eps {args.eps}) ...", file=sys.stderr)
    r = run_build(ref, args.eps, args.batch, args.backend,
                  timeout_s=args.timeout, entry=entry)
    verdict["reference"] = {k: v for k, v in r.items() if k != "log"}
    if r["rc"] != 0 or r["hung"]:
        print(_failed_build("reference build", r) + "\n" + r["log"],
              file=sys.stderr)
        return 2

    flt = os.path.join(wd, "fleet")
    plan_path = os.path.join(wd, "plan.json")
    with open(plan_path, "w") as f:
        # Die at the 2nd checkpoint BOUNDARY (fully-written file, no
        # replay on resume -- see module docstring).
        json.dump({"seed": 7, "process_exit": True,
                   "faults": [{"site": "checkpoint.written",
                               "kind": "crash", "at": 2}]}, f)
    print("fleet_smoke: supervised 2-process build "
          "(crash at checkpoint 2) ...", file=sys.stderr)
    r = run_build(flt, args.eps, args.batch, args.backend,
                  plan_path=plan_path, supervised=True,
                  timeout_s=args.timeout, entry=entry)
    verdict["fleet"] = {k: v for k, v in r.items() if k != "log"}
    if r["rc"] != 0 or r["hung"]:
        print(_failed_build("supervised build", r) + "\n" + r["log"],
              file=sys.stderr)
        return 2

    # -- reconcile ---------------------------------------------------------
    ref_counters, _ref_streams = _stream_counters(ref)
    flt_counters, flt_streams = _stream_counters(flt)
    verdict["n_fleet_streams"] = len(flt_streams)
    if len(flt_streams) != 2:
        failures.append(
            f"expected 2 per-process streams from the supervised run, "
            f"got {len(flt_streams)} "
            f"({[os.path.basename(s.path) for s in flt_streams]})")
    run_ids = {s.identity.get("run_id") for s in flt_streams
               if s.identity}
    if len(run_ids) != 1:
        failures.append(f"fleet streams carry {len(run_ids)} run_ids "
                        f"({sorted(run_ids)}); the supervisor's "
                        "EHM_RUN_ID should unify the chain")
    recon = {}
    for key in RECONCILED_COUNTERS:
        a, b = ref_counters.get(key), flt_counters.get(key)
        recon[key] = {"reference": a, "fleet_sum": b}
        if a != b:
            failures.append(f"counter {key}: fleet sum {b} != "
                            f"single-process {a}")
    verdict["reconciliation"] = recon

    with open(ref + ".stats.json") as f:
        ref_stats = json.load(f)
    with open(flt + ".stats.json") as f:
        flt_stats = json.load(f)
    verdict["regions"] = ref_stats["regions"]
    if ref_stats["regions"] != flt_stats["regions"]:
        failures.append(f"regions {flt_stats['regions']} != reference "
                        f"{ref_stats['regions']}")
    diffs = chaos_suite.compare_trees(ref + ".tree.pkl", flt + ".tree.pkl")
    verdict["tree_diffs"] = diffs
    if diffs:
        failures.append("tree DIVERGED -- " + "; ".join(diffs))

    # obs_report --fleet --strict must render + pass (schema v2,
    # identity present, one run_id).
    rc = _fleet_report(flt + ".obs.p*.jsonl",
                       os.path.join(wd, "fleet_report.json"))
    verdict["obs_report_rc"] = rc
    if rc != 0:
        failures.append(f"obs_report --fleet --strict exited {rc}")
    if not failures:
        print(f"FLEET SMOKE OK: {len(flt_streams)} streams reconcile "
              f"exactly with the single-process build "
              f"({ref_stats['regions']} regions, "
              f"{len(RECONCILED_COUNTERS)} counters bit-equal, tree "
              "node-for-node identical)", file=sys.stderr)
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m explicit_hybrid_mpc_tpu_torch.tools.fleet_smoke",
        description=__doc__.splitlines()[0])
    ap.add_argument("--backend", choices=("cuda", "cpu"), default="cuda",
                    help="where every build runs: 'cuda' (default; refuses "
                         "to start without a card) or 'cpu'")
    ap.add_argument("--eps", type=float, default=0.2,
                    help="eps_a (default 0.2 = the 392-region tier-1 "
                         "build; raise for a quicker smoke)")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--sharded", action="store_true",
                    help="smoke the 2-process SHARDED build "
                         "(partition/shard.py) instead of the "
                         "supervised-restart chain: counters must "
                         "reconcile bit-exactly, trees node-for-node "
                         "(canonical)")
    ap.add_argument("--timeout", type=float, default=TIMEOUT_S)
    ap.add_argument("--workdir", default=None,
                    help="keep artifacts here instead of a temp dir")
    ap.add_argument("--json", dest="json_out", default=None)
    args = ap.parse_args(argv)
    try:
        device_lib.resolve(args.backend)
    except RuntimeError as e:
        raise SystemExit(f"fleet_smoke: {e}")

    wd = args.workdir or tempfile.mkdtemp(prefix="fleet_smoke.")
    os.makedirs(wd, exist_ok=True)
    verdict: dict = {"eps": args.eps, "backend": args.backend,
                     "workdir": wd, "sharded_mode": args.sharded}
    failures: list[str] = []
    run = run_sharded_smoke if args.sharded else run_chain_smoke
    try:
        rc = run(wd, args, verdict, failures)
    finally:
        if not args.workdir:
            shutil.rmtree(wd, ignore_errors=True)
    verdict["failures"] = failures
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(verdict, f, indent=2)
    if rc:
        return rc
    if failures:
        print(f"FLEET SMOKE{' (sharded)' if args.sharded else ''} "
              "FAILED:", file=sys.stderr)
        for f_ in failures:
            print("  " + f_, file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
