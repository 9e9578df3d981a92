"""North-star capture: the flagship build, its speedup over the serial
oracle, and batched-versus-serial region parity at a tractable eps.

    python -m explicit_hybrid_mpc_tpu_torch.tools.north_star
    BENCH_PLATFORM=cpu NS_PROBLEM=double_integrator NS_PARITY_EPS=0.5 \\
        NS_MAX_DEPTH=12 \\
        python -m explicit_hybrid_mpc_tpu_torch.tools.north_star

The JAX package's scripts/north_star.py, its sections, knobs and JSON
keys, on the port:

1. **flagship**: the problem (NS_PROBLEM, default the inverted pendulum)
   at eps_a 1e-2, NS_MAX_DEPTH 56, 512 simplices a batch, after every
   bucket is warmed and an eps 1.0 warm build: regions, regions/s, wall,
   truncation, uncertified;
2. **vs_serial_estimate**: the serial oracle's measured seconds a point
   and a joint simplex QP (tools/bench.measure_serial_latencies) times
   the QPs the batched build issued, over its wall.  The serial oracle
   is ``Oracle(backend="serial")``, the port's one-QP-a-call host
   solver, not the reference's program (``baseline_definition``);
3. **parity**: the same problem at NS_PARITY_EPS (default 0.1) built by
   the batched oracle and by the serial one; ``parity_ok`` when both are
   complete with equal regions and tree nodes.

Where it runs: the card unless ``--backend cpu`` or BENCH_PLATFORM=cpu
(tools/capture.choose_device: no card, no start; 'tpu' refused).  The
precision is NS_PRECISION, else 'f64' on the card
(capture.default_precision) and the JAX script's 'mixed' on the CPU.
The JSON goes to ``--out``, else NORTH_STAR_OUT, else a fresh temp dir,
rewritten after each section; the per-step log (NS_LOG, default
``north_star.log.jsonl``) beside it.  A kernel error, a
``NoCpuFallback`` or a CUDA error ends the run as the result's
``error``, exit 1; so does any other failure, as in the JAX script.
Exit 0 only when ``parity_ok``.  No history row (the JAX script writes
none).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

from explicit_hybrid_mpc_tpu_torch.tools.capture import (
    SENTINEL, choose_device, default_precision, log, out_path,
    schedule_kwargs, warm_oracle)

#: What the serial stand-in is (tools/bench.py's baseline_definition).
BASELINE_DEFINITION = (
    "measured serial per-QP latency x issued QP counts / batched wall; "
    "the serial stand-in is Oracle(backend='serial') on the host: its "
    "point QPs one a call, solved in numpy on the host "
    "(oracle/host_qp.py), its joint simplex QPs eight to a call of the "
    "plain torch program; not the reference's compiled program")


def _flush(path: str, result: dict) -> None:
    with open(path, "w") as f:
        json.dump(result, f, indent=2)


def run(result: dict, path: str, dev) -> None:
    from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
    from explicit_hybrid_mpc_tpu_torch.oracle.oracle import Oracle
    from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
        build_partition)
    from explicit_hybrid_mpc_tpu_torch.problems.registry import make
    from explicit_hybrid_mpc_tpu_torch.tools.bench import (
        measure_serial_latencies)

    on_card = dev.type == "cuda"
    precision = os.environ.get("NS_PRECISION") or (
        default_precision(True) if on_card else "mixed")
    parity_eps = float(os.environ.get("NS_PARITY_EPS", "0.1"))
    budget = float(os.environ.get("NS_TIME_BUDGET", "900"))
    problem_name = os.environ.get("NS_PROBLEM", "inverted_pendulum")
    platform = result["platform"]
    problem = make(problem_name)
    points_cap = int(os.environ.get("NS_POINTS_CAP",
                                    "2048" if on_card else "256"))

    # -- 1. flagship build -------------------------------------------------
    sched_kw = schedule_kwargs(result)
    oracle = Oracle(problem, backend=dev.type, precision=precision,
                    points_cap=points_cap, **sched_kw)
    warm_oracle(oracle, problem)
    build_partition(problem, PartitionConfig(
        problem=problem_name, eps_a=1.0, backend=dev.type,
        batch_simplices=512, max_steps=50, time_budget_s=120.0,
        precision=precision), oracle=oracle)
    oracle.n_solves = oracle.n_point_solves = oracle.n_simplex_solves = 0
    oracle.n_rescue_solves = 0

    log(f"flagship build (eps_a=1e-2, budget {budget:.0f}s)...")
    # One run a log: the RunLog appends, so an old file goes first.
    log_path = os.environ.get("NS_LOG") or os.path.join(
        os.path.dirname(os.path.abspath(path)), "north_star.log.jsonl")
    if os.path.exists(log_path):
        os.remove(log_path)
    max_depth = int(os.environ.get("NS_MAX_DEPTH", "56"))
    cfg = PartitionConfig(problem=problem_name, eps_a=1e-2,
                          backend=dev.type, batch_simplices=512,
                          max_steps=20_000, precision=precision,
                          max_depth=max_depth, time_budget_s=budget,
                          log_path=log_path)
    res = build_partition(problem, cfg, oracle=oracle)
    n_point = oracle.n_point_solves
    stats = res.stats
    log(f"flagship: {stats}")
    result["flagship"] = {
        "problem": problem_name, "eps_a": 1e-2,
        "precision": precision, "platform": platform,
        "regions": stats["regions"],
        "regions_per_s": round(stats["regions_per_s"], 2),
        "wall_s": round(stats["wall_s"], 2),
        "truncated": stats["truncated"],
        "uncertified": stats["uncertified"],
        "max_depth": stats["max_depth"],
        "oracle_solves": stats["oracle_solves"],
        "point_solves": stats["point_solves"],
        "simplex_solves": stats["simplex_solves"],
        "inherited_skips": stats["inherited_skips"],
        "device_failures": stats["device_failures"],
        "cache_peak_mb": stats["cache_peak_mb"],
    }

    # -- speedup over the serial oracle, point and joint simplex QPs
    # weighted by the counts the batched build issued ----------------------
    serial = Oracle(problem, backend="serial", precision=precision,
                    **sched_kw)
    n_simplex = stats["simplex_solves"]
    per_solve, per_simplex = measure_serial_latencies(
        serial, problem, with_simplex=bool(n_simplex))
    serial_wall = per_solve * n_point + per_simplex * n_simplex
    result["flagship"]["serial_ms_per_solve"] = round(per_solve * 1e3, 3)
    result["flagship"]["serial_ms_per_simplex"] = round(per_simplex * 1e3, 3)
    result["flagship"]["vs_serial_estimate"] = round(
        serial_wall / stats["wall_s"], 2)
    result["flagship"]["baseline_definition"] = BASELINE_DEFINITION
    _flush(path, result)

    # -- 2. parity at a tractable eps ---------------------------------------
    log(f"parity builds (eps_a={parity_eps}): batched vs serial...")
    counts = {}
    for backend in (dev.type, "serial"):
        pcfg = PartitionConfig(problem=problem_name, eps_a=parity_eps,
                               backend=backend, batch_simplices=256,
                               precision=precision, max_depth=max_depth,
                               time_budget_s=1800.0)
        orc = Oracle(problem, backend=backend, precision=precision,
                     points_cap=points_cap, **sched_kw)
        pres = build_partition(problem, pcfg, oracle=orc)
        counts[backend] = {"regions": pres.stats["regions"],
                           "tree_nodes": pres.stats["tree_nodes"],
                           "max_depth": pres.stats["max_depth"],
                           "truncated": pres.stats["truncated"],
                           "wall_s": round(pres.stats["wall_s"], 2),
                           "regions_per_s": round(
                               pres.stats["regions_per_s"], 2)}
        result["parity_partial"] = counts
        _flush(path, result)
        log(f"  {backend}: {counts[backend]}")
    bk = dev.type
    # Counts compare only between complete builds: a truncated side stops
    # at an arbitrary batch boundary.
    both_complete = not (counts[bk]["truncated"]
                         or counts["serial"]["truncated"])
    result["parity"] = {
        "eps_a": parity_eps,
        "batched_backend": bk,
        "batched": counts[bk],
        "serial": counts["serial"],
        "parity_valid": both_complete,
        "parity_ok": (both_complete
                      and counts[bk]["regions"] == counts["serial"]["regions"]
                      and counts[bk]["tree_nodes"]
                      == counts["serial"]["tree_nodes"]),
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m explicit_hybrid_mpc_tpu_torch.tools.north_star",
        description=__doc__.splitlines()[0])
    ap.add_argument("--backend", choices=("cuda", "cpu"), default=None,
                    help="'cuda' (the default, else BENCH_PLATFORM; "
                         "refuses to start without a card) or 'cpu'")
    ap.add_argument("--out", default=None,
                    help="the JSON's path (else NORTH_STAR_OUT, else a "
                         "temp dir)")
    ap.add_argument("--sentinel", default=SENTINEL,
                    help="the capture-active file held while this runs")
    args = ap.parse_args(argv)
    result: dict = {"captured_at": time.strftime("%Y-%m-%d %H:%M:%S"),
                    "flagship": None, "parity": None}
    dev = choose_device(result, args.backend, sentinel=args.sentinel)
    path = out_path(args.out, "NORTH_STAR_OUT", "north_star.json",
                    "north_star")
    try:
        run(result, path, dev)
    except BaseException as e:
        result["error"] = repr(e)
        traceback.print_exc(file=sys.stderr)
    finally:
        _flush(path, result)
        print(json.dumps(result))
    parity = result.get("parity")
    return 0 if (parity and parity["parity_ok"]
                 and "error" not in result) else 1


if __name__ == "__main__":
    raise SystemExit(main())
