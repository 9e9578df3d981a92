"""Mixed-precision schedule sweep: the cheapest (n_f32, n_f64) IPM
schedule that still converges and keeps the tree.

    python -m explicit_hybrid_mpc_tpu_torch.tools.tune_schedule
    TUNE_PROBLEM=double_integrator TUNE_POINTS=16 TUNE_EPS=0.5 \\
        python -m explicit_hybrid_mpc_tpu_torch.tools.tune_schedule \\
        --backend cpu --out /tmp/tune.json

The JAX package's scripts/tune_schedule.py, with its knobs, schedules
and JSON keys, on the port.  For each schedule of SCHEDULES, on the
card unless ``--backend cpu``:

- the point grid (TUNE_POINTS thetas x every commutation): µs a QP,
  the converged fraction and the fraction the rescue pass re-solved;
- a joint simplex-min batch of 64 simplices: µs a QP issued;
- ``conv_ok``: converged within 1e-3 of the default schedule's.

Then the default schedule and the fastest conv_ok one build the
partition at TUNE_EPS, and ``fastest_parity_ok`` says whether their
regions and tree nodes are equal.  Every time is taken around a call
that ends with the device synchronized.  Env: TUNE_OUT, TUNE_POINTS
(512), TUNE_EPS (0.2), TUNE_PROBLEM (inverted_pendulum),
TUNE_BUILD_BUDGET (s, 900), BENCH_PLATFORM.  The JSON goes to
``--out``, else TUNE_OUT, else a fresh temp dir.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from explicit_hybrid_mpc_tpu_torch.tools.capture import (
    SENTINEL, choose_device, is_cuda_error, log, out_path, retry_transient,
    sync)

# The first entry is the shipping default.  n_f32/n_f64 set the
# simplex-class (joint QP) schedule; "point" overrides the point-class
# schedule, and "rescue" re-solves feasible-but-unconverged point
# stragglers cold with that many float64 iterations.
SCHEDULES = [
    {"n_f32": 20, "n_f64": 10},
    {"n_f32": 20, "n_f64": 6},
    {"n_f32": 16, "n_f64": 6},
    {"n_f32": 0, "n_f64": 30},
    {"n_f32": 20, "n_f64": 10, "point": (16, 4), "rescue": 30},
    {"n_f32": 20, "n_f64": 10, "point": (12, 4), "rescue": 30},
    {"n_f32": 20, "n_f64": 10, "point": (8, 4), "rescue": 30},
]


def _make_oracle(problem, backend: str, sched: dict, points_cap: int):
    from explicit_hybrid_mpc_tpu_torch.oracle.oracle import Oracle

    n_f32, n_f64 = sched["n_f32"], sched["n_f64"]
    precision = "f64" if n_f32 == 0 else "mixed"
    return Oracle(problem, backend=backend, n_iter=n_f32 + n_f64,
                  precision=precision,
                  n_f32=n_f32 if precision == "mixed" else None,
                  point_schedule=sched.get("point"),
                  rescue_iter=sched.get("rescue", 0),
                  points_cap=points_cap)


def _timed(dev, fn) -> float:
    """Seconds of fn(), the device synchronized before and after."""
    sync(dev)
    t0 = time.perf_counter()
    fn()
    sync(dev)
    return time.perf_counter() - t0


def run(result: dict, dev) -> None:
    from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
    from explicit_hybrid_mpc_tpu_torch.partition import geometry
    from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
        build_partition)
    from explicit_hybrid_mpc_tpu_torch.problems.registry import make

    problem_name = os.environ.get("TUNE_PROBLEM", "inverted_pendulum")
    n_points = int(os.environ.get("TUNE_POINTS", "512"))
    eps_a = float(os.environ.get("TUNE_EPS", "0.2"))
    build_budget = float(os.environ.get("TUNE_BUILD_BUDGET", "900"))
    on_card = dev.type == "cuda"

    problem = make(problem_name)
    nd = problem.canonical.n_delta
    result["problem"] = problem_name
    result["n_delta"] = nd
    result["n_points"] = n_points
    rng = np.random.default_rng(11)
    thetas = np.asarray(rng.uniform(problem.theta_lb, problem.theta_ub,
                                    size=(n_points, problem.n_theta)))

    # One shared simplex-min batch (64 simplices spread over the box).
    span = problem.theta_ub - problem.theta_lb
    Ms = []
    for _ in range(64):
        lo = problem.theta_lb + 0.8 * span * rng.random(problem.n_theta)
        V = np.vstack([lo, lo + 0.1 * np.diag(span)])
        Ms.append(geometry.barycentric_matrix(V))
    Ms = np.stack(Ms)
    ds64 = np.arange(64, dtype=np.int64) % nd

    points_cap = 2048 if on_card else 256
    rows = []
    result["schedules"] = rows
    for sched in SCHEDULES:
        n_f32, n_f64 = sched["n_f32"], sched["n_f64"]
        orc = _make_oracle(problem, dev.type, sched, points_cap)
        row = dict(sched)
        if "point" in row:
            row["point"] = list(row["point"])
        try:
            retry_transient(lambda: orc.solve_vertices(thetas),
                            what=f"warm {n_f32}+{n_f64}")
            orc.n_rescue_solves = 0  # the warm call's rescues don't count
            out = {}
            dt = _timed(dev, lambda: out.update(
                sol=orc.solve_vertices(thetas)))
            conv = np.asarray(out["sol"].conv)
            row["point_us_per_qp"] = round(dt / (n_points * nd) * 1e6, 3)
            row["converged_frac"] = round(float(conv.mean()), 5)
            row["rescue_frac"] = round(
                orc.n_rescue_solves / (n_points * nd), 5)
            retry_transient(lambda: orc.solve_simplex_min(Ms, ds64),
                            what=f"simplex warm {n_f32}+{n_f64}")
            before = orc.n_simplex_solves
            dt2 = _timed(dev, lambda: orc.solve_simplex_min(Ms, ds64))
            # 1 QP a row (the elastic min witnessed feasibility) to 2
            # (phase 1 ran): divide by the oracle's own count.
            issued = max(1, orc.n_simplex_solves - before)
            row["simplex_qps_issued"] = issued
            row["simplex_us_per_qp"] = round(dt2 / issued * 1e6, 3)
        except (RuntimeError, OSError) as e:
            if is_cuda_error(e):
                raise
            row["error"] = repr(e)[:300]
        log(f"  {row}")
        rows.append(row)

    # conv_ok against the DEFAULT schedule's measured baseline (rows[0]);
    # without it no recommendation is made.
    default_row = rows[0] if rows else None
    if default_row is None or "error" in default_row:
        result["note"] = "default schedule row failed; no recommendation"
        return
    base_conv = default_row["converged_frac"]
    for r in rows:
        if "error" not in r:
            r["conv_ok"] = r["converged_frac"] >= base_conv - 1e-3

    # Parity builds: default schedule vs the fastest conv_ok candidate.
    candidates = [r for r in rows[1:]
                  if r.get("conv_ok") and "error" not in r]
    if candidates:
        fastest = min(candidates, key=lambda r: r["point_us_per_qp"])
        counts = {}
        for tag, sched in (("default", SCHEDULES[0]),
                           ("fastest", {k: fastest[k]
                                        for k in ("n_f32", "n_f64",
                                                  "point", "rescue")
                                        if k in fastest})):
            if "point" in sched:
                sched = dict(sched, point=tuple(sched["point"]))
            orc = _make_oracle(problem, dev.type, sched, points_cap)
            cfg = PartitionConfig(problem=problem_name, eps_a=eps_a,
                                  backend=dev.type, batch_simplices=256,
                                  max_steps=50_000, precision="mixed",
                                  time_budget_s=build_budget)
            res = build_partition(problem, cfg, oracle=orc)
            counts[tag] = {"schedule": dict(sched, point=list(
                               sched.get("point", ())) or None),
                           "regions": res.stats["regions"],
                           "tree_nodes": res.stats["tree_nodes"],
                           "truncated": res.stats["truncated"],
                           "wall_s": round(res.stats["wall_s"], 2),
                           "regions_per_s": round(
                               res.stats["regions_per_s"], 2)}
            log(f"  build {tag}: {counts[tag]}")
        both = not (counts["default"]["truncated"]
                    or counts["fastest"]["truncated"])
        result["parity_builds"] = counts
        result["parity_valid"] = both
        result["fastest_parity_ok"] = (
            both and counts["default"]["regions"]
            == counts["fastest"]["regions"]
            and counts["default"]["tree_nodes"]
            == counts["fastest"]["tree_nodes"])
        result["fastest_speedup"] = (
            round(counts["default"]["wall_s"] / counts["fastest"]["wall_s"],
                  2) if counts["fastest"]["wall_s"] else None)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m explicit_hybrid_mpc_tpu_torch.tools.tune_schedule",
        description=__doc__.splitlines()[0])
    ap.add_argument("--backend", choices=("cuda", "cpu"), default=None,
                    help="'cuda' (the default, else BENCH_PLATFORM; "
                         "refuses to start without a card) or 'cpu'")
    ap.add_argument("--out", default=None,
                    help="the JSON's path (else TUNE_OUT, else a temp dir)")
    ap.add_argument("--sentinel", default=SENTINEL,
                    help="the capture-active file held while this runs")
    args = ap.parse_args(argv)
    result: dict = {"captured_at": time.strftime("%Y-%m-%d %H:%M:%S")}
    dev = choose_device(result, args.backend, sentinel=args.sentinel)
    path = out_path(args.out, "TUNE_OUT", "tune_schedule.json",
                    "tune_schedule")
    try:
        run(result, dev)
    except BaseException as e:
        import traceback

        result["error"] = repr(e)
        traceback.print_exc(file=sys.stderr)
    finally:
        with open(path, "w") as f:
            json.dump(result, f, indent=2)
        print(json.dumps(result))
    return 0 if "error" not in result else 1


if __name__ == "__main__":
    raise SystemExit(main())
