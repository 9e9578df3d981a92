"""Online point-location cost against leaf count: brute force, the
descent, and K2 on the card.

    python -m explicit_hybrid_mpc_tpu_torch.tools.online_crossover
    BENCH_PLATFORM=cpu CROSS_EPS=0.5,0.2 \\
        python -m explicit_hybrid_mpc_tpu_torch.tools.online_crossover

The JAX package's scripts/online_crossover.py, its knobs and JSON keys,
on the port: double-integrator partitions at each CROSS_EPS (default
0.5,0.2,0.1,0.05,0.02,0.01), then the µs a query of each locate-and-
evaluate path over CROSS_BATCH queries (default 4,096, seed 3), each the
mean of 20 calls after a warm one, the device synchronized before the
clock stops (tools/bench.timed_us):

- ``jax_us`` (the JAX key's name kept): the brute-force evaluator,
  online/evaluator.py, plain torch in float64;
- ``descent_us``: the O(depth) descent, online/descent.py;
- ``locate_us`` (the card only): K2, csrc/locate.cu through
  online/locate.py, where the JAX script times its Pallas kernel on a
  TPU (``pallas_us``); ``locate_leaf_match_frac`` is the share of all
  queries whose K2 leaf is the float64 evaluator's, from the last timed
  calls of both (no launch of its own; leaves tie on shared faces, so it
  can fall below 1 there).

Where it runs: the card unless ``--backend cpu`` or BENCH_PLATFORM=cpu
(tools/capture.choose_device: no card, no start; 'tpu' refused).  The
builds' precision is 'f64' on the card (capture.default_precision) and
the JAX script's 'mixed' on the CPU.  The JSON goes to ``--out``, else
CROSS_OUT, else a fresh temp dir, rewritten after every row.  A row's
RuntimeError or OSError is that row's ``error``, as in the JAX script,
except a card fault (a kernel error, a ``NoCpuFallback``, a CUDA error:
capture.card_fault), which ends the run as the result's ``error``, exit
1.  No history row (the JAX script writes none).
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
    SENTINEL, card_fault, choose_device, default_precision, log, out_path)

#: Timed calls a column, after one warm call.
REPS = 20
#: The queries' seed.
SEED = 3


def _flush(path: str, result: dict) -> None:
    with open(path, "w") as f:
        json.dump(result, f, indent=2)


def columns(row: dict, res, qs, dev) -> None:
    """The row's leaf count, depth and export cost, then its timed
    columns (the locate column on the card only)."""
    from explicit_hybrid_mpc_tpu_torch.online import (descent, evaluator,
                                                      export, locate)
    from explicit_hybrid_mpc_tpu_torch.tools.bench import timed_us

    B = qs.shape[0]
    table = export.export_leaves(res.tree)
    dtab = evaluator.stage(table, device=dev)
    t0 = time.perf_counter()
    dt = descent.export_descent(res.tree, res.roots, table, device=dev)
    row.update(leaves=table.n_leaves, max_depth=dt.max_depth,
               descent_export_s=round(time.perf_counter() - t0, 3),
               truncated=res.stats["truncated"])
    us, ev = timed_us(dev, lambda: evaluator.evaluate(dtab, qs), B, REPS)
    row["jax_us"] = round(us, 4)
    us, _ = timed_us(dev, lambda: descent.evaluate_descent(dt, dtab, qs), B,
                     REPS)
    row["descent_us"] = round(us, 4)
    if dev.type == "cuda":
        lt = locate.stage(table, device=dev)
        us, (leaf, _score) = timed_us(dev, lambda: locate.locate(lt, qs), B,
                                      REPS)
        row["locate_us"] = round(us, 4)
        row["locate_leaf_match_frac"] = round(float(
            (leaf.long() == ev.leaf).double().mean()), 6)


def run(result: dict, path: str, dev) -> None:
    import torch

    from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
    from explicit_hybrid_mpc_tpu_torch.oracle.oracle import Oracle
    from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
        build_partition)
    from explicit_hybrid_mpc_tpu_torch.problems.registry import make

    eps_list = [float(e) for e in os.environ.get(
        "CROSS_EPS", "0.5,0.2,0.1,0.05,0.02,0.01").split(",")]
    on_card = dev.type == "cuda"
    precision = default_precision(True) if on_card else "mixed"
    prob = make("double_integrator")
    oracle = Oracle(prob, backend=dev.type, precision=precision,
                    points_cap=2048 if on_card else 256)
    rngq = np.random.default_rng(SEED)
    qs = torch.as_tensor(rngq.uniform(prob.theta_lb, prob.theta_ub,
                                      size=(result["batch"], prob.n_theta)),
                         device=dev)
    for eps in eps_list:
        # A row's failure costs that row; what it measured before stays.
        row: dict = {"eps_a": eps}
        try:
            cfg = PartitionConfig(problem="double_integrator", eps_a=eps,
                                  backend=dev.type, batch_simplices=512,
                                  max_steps=20_000, precision=precision,
                                  time_budget_s=900.0)
            res = build_partition(prob, cfg, oracle=oracle)
            columns(row, res, qs, dev)
        except (RuntimeError, OSError) as e:
            if card_fault(e):
                raise
            row["error"] = repr(e)[:300]
        log(f"  {row}")
        result["rows"].append(row)
        _flush(path, result)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m explicit_hybrid_mpc_tpu_torch.tools."
             "online_crossover",
        description=__doc__.splitlines()[0])
    ap.add_argument("--backend", choices=("cuda", "cpu"), default=None,
                    help="'cuda' (the default, else BENCH_PLATFORM; "
                         "refuses to start without a card) or 'cpu'")
    ap.add_argument("--out", default=None,
                    help="the JSON's path (else CROSS_OUT, else a temp "
                         "dir)")
    ap.add_argument("--sentinel", default=SENTINEL,
                    help="the capture-active file held while this runs")
    args = ap.parse_args(argv)
    result: dict = {"captured_at": time.strftime("%Y-%m-%d %H:%M:%S"),
                    "batch": int(os.environ.get("CROSS_BATCH", "4096")),
                    "rows": []}
    dev = choose_device(result, args.backend, sentinel=args.sentinel)
    path = out_path(args.out, "CROSS_OUT", "online_crossover.json",
                    "online_crossover")
    try:
        run(result, path, dev)
    except Exception as e:  # noqa: BLE001 -- only a card fault is caught
        if not card_fault(e):
            raise
        result["error"] = repr(e)
        traceback.print_exc(file=sys.stderr)
    _flush(path, result)
    print(json.dumps(result))
    return 1 if "error" in result else 0


if __name__ == "__main__":
    raise SystemExit(main())
