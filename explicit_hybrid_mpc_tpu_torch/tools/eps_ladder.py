"""Flagship tolerance ladder: complete pendulum builds at shrinking eps,
each with the O(depth) descent's export cost and µs a query.

    python -m explicit_hybrid_mpc_tpu_torch.tools.eps_ladder
    BENCH_PLATFORM=cpu LADDER_PROBLEM=double_integrator LADDER_EPS=0.5,0.2 \\
        python -m explicit_hybrid_mpc_tpu_torch.tools.eps_ladder

The JAX package's scripts/eps_ladder.py, its knobs and JSON keys, on the
port: one oracle, shared by every rung for its warm buckets (its counters
reset a rung), builds the problem (LADDER_PROBLEM, default the inverted
pendulum) at each LADDER_EPS (default 1e-2,5e-3,3e-3) with max_depth 60,
512 simplices a batch and LADDER_BUDGET seconds (default 420).  A rung is
``complete`` when it is not truncated and has no uncertified leaf.  Then
the rung's descent table (online/descent.py: export_descent) and its µs
a query over 4,096 seeded queries (evaluate_descent, five timed calls
after a warm one, the device synchronized before the clock stops:
tools/bench.timed_us).

Where it runs: the card unless ``--backend cpu`` or BENCH_PLATFORM=cpu
(tools/capture.choose_device: no card, no start; 'tpu' refused).  The
precision is 'f64' on the card (capture.default_precision) and the JAX
script's 'mixed' on the CPU.  The JSON goes to ``--out``, else
LADDER_OUT, else ``eps_ladder_<platform>.json`` in a fresh temp dir,
rewritten after every rung.  A descent failure is the rung's
``descent_error``, as in the JAX script, except a card fault (a kernel
error, a ``NoCpuFallback``, a CUDA error: capture.card_fault), which
ends the run as the result's ``error``.  Exit 0 only when every rung is
complete and there is no error.  No history row (the JAX script writes
none).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import numpy as np

from explicit_hybrid_mpc_tpu_torch.tools.capture import (
    SENTINEL, card_fault, choose_device, default_precision, log, out_path,
    schedule_kwargs)

#: Queries of a rung's descent figure, its timed calls, and their seed.
QUERIES = 4096
REPS = 5
SEED = 5


def _flush(path: str, result: dict) -> None:
    with open(path, "w") as f:
        json.dump(result, f, indent=2)


def descent_row(row: dict, res, problem, dev, rng) -> None:
    """The rung's descent figures into `row`: export seconds and µs a
    query."""
    import torch

    from explicit_hybrid_mpc_tpu_torch.online import (descent, evaluator,
                                                      export)
    from explicit_hybrid_mpc_tpu_torch.tools.bench import timed_us

    table = export.export_leaves(res.tree)
    t0 = time.perf_counter()
    dt = descent.export_descent(res.tree, res.roots, table, device=dev)
    row["descent_export_s"] = round(time.perf_counter() - t0, 3)
    dtab = evaluator.stage(table, device=dev)
    qs = torch.as_tensor(rng.uniform(problem.theta_lb, problem.theta_ub,
                                     size=(QUERIES, problem.n_theta)),
                         device=dev)
    us, _ = timed_us(dev, lambda: descent.evaluate_descent(dt, dtab, qs),
                     QUERIES, REPS)
    row["descent_us_per_query"] = round(us, 3)


def run(result: dict, path: str, dev) -> None:
    from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
    from explicit_hybrid_mpc_tpu_torch.oracle.oracle import Oracle
    from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
        build_partition)
    from explicit_hybrid_mpc_tpu_torch.problems.registry import make

    eps_list = [float(x) for x in os.environ.get(
        "LADDER_EPS", "1e-2,5e-3,3e-3").split(",")]
    budget = float(os.environ.get("LADDER_BUDGET", "420"))
    problem_name = os.environ.get("LADDER_PROBLEM", "inverted_pendulum")
    on_card = dev.type == "cuda"
    precision = default_precision(True) if on_card else "mixed"

    problem = make(problem_name)
    result["problem"] = problem_name
    result["per_build_budget_s"] = budget
    sched_kw = schedule_kwargs(result)
    rows: list = []
    result["rows"] = rows
    oracle = Oracle(problem, backend=dev.type, precision=precision,
                    points_cap=2048 if on_card else 256, **sched_kw)
    rng = np.random.default_rng(SEED)
    for eps in eps_list:
        # The oracle is shared for its warm buckets; its counters are a
        # build's.
        oracle.n_solves = oracle.n_point_solves = 0
        oracle.n_simplex_solves = oracle.n_rescue_solves = 0
        cfg = PartitionConfig(problem=problem_name, eps_a=eps,
                              backend=dev.type, batch_simplices=512,
                              max_depth=60, precision=precision,
                              max_steps=50_000, time_budget_s=budget)
        res = build_partition(problem, cfg, oracle=oracle)
        s = res.stats
        row = {"eps_a": eps, "regions": s["regions"],
               "complete": (not s["truncated"] and s["uncertified"] == 0),
               "uncertified": s["uncertified"],
               "wall_s": round(s["wall_s"], 2),
               "regions_per_s": round(s["regions_per_s"], 2),
               "max_depth": s["max_depth"],
               "oracle_solves": s["oracle_solves"]}
        try:
            descent_row(row, res, problem, dev, rng)
        except Exception as e:  # the online extras never void the rung
            if card_fault(e):
                raise
            row["descent_error"] = repr(e)[:200]
        rows.append(row)
        log(f"  eps {eps}: {row}")
        _flush(path, result)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m explicit_hybrid_mpc_tpu_torch.tools.eps_ladder",
        description=__doc__.splitlines()[0])
    ap.add_argument("--backend", choices=("cuda", "cpu"), default=None,
                    help="'cuda' (the default, else BENCH_PLATFORM; "
                         "refuses to start without a card) or 'cpu'")
    ap.add_argument("--out", default=None,
                    help="the JSON's path (else LADDER_OUT, else "
                         "eps_ladder_<platform>.json in a temp dir)")
    ap.add_argument("--sentinel", default=SENTINEL,
                    help="the capture-active file held while this runs")
    args = ap.parse_args(argv)
    result: dict = {"captured_at": time.strftime("%Y-%m-%d %H:%M:%S")}
    dev = choose_device(result, args.backend, sentinel=args.sentinel)
    path = out_path(args.out, "LADDER_OUT",
                    f"eps_ladder_{result['platform']}.json", "eps_ladder")
    try:
        run(result, path, dev)
    except BaseException as e:
        result["error"] = repr(e)
        traceback.print_exc(file=sys.stderr)
    finally:
        _flush(path, result)
        print(json.dumps(result))
    return 0 if "error" not in result and all(
        r.get("complete") for r in result.get("rows", [])) else 1


if __name__ == "__main__":
    raise SystemExit(main())
