"""All-configs capture: one measured row a BASELINE.md configuration, at
benchmark size.

    python -m explicit_hybrid_mpc_tpu_torch.tools.bench_configs
    BENCH_PLATFORM=cpu CFG_ONLY=double_integrator \\
        python -m explicit_hybrid_mpc_tpu_torch.tools.bench_configs

The JAX package's scripts/bench_configs.py, its CONFIGS table (the five
BASELINE.md rows and the demonstration rows 4b, 4c and 5b), knobs and
JSON keys, on the port.  Each row warms every bucket and runs an eps 1.0
warm build, then builds its configuration within CFG_TIME_BUDGET
seconds (default 600) and reports regions, regions/s, wall, truncation
and the certified volume fraction (post/analysis.partition_report): a
build the budget cuts is an honest truncated row, not an error.  The
result is rewritten after every row.

Where it runs: the card unless ``--backend cpu`` or BENCH_PLATFORM=cpu
(tools/capture.choose_device: no card, no start; 'tpu' refused).  The
precision is CFG_PRECISION, else capture.default_precision ('f64' on
the card; on the CPU the JAX rule, the problem's hint else 'mixed').  A
problem with a ``prune_hint`` runs the pruned oracle on the CPU only, as
in the JAX script.  CFG_ONLY is a comma list of problem names
(``satellite`` selects rows 4, 4b and 4c).  The JSON goes to ``--out``,
else CONFIGS_OUT, else a fresh temp dir.

One configuration's failure does not void the others and is that row's
``error``, as in the JAX script, except a card fault (a kernel error, a
``NoCpuFallback``, a CUDA error: capture.card_fault): it ends the run,
is the result's ``error``, and the exit code is 1.  No history row (the
JAX script writes none).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

from explicit_hybrid_mpc_tpu_torch.tools.capture import (
    SENTINEL, card_fault, choose_device, default_precision, log, out_path,
    warm_oracle)

# (BASELINE.md row, problem name, constructor kwargs, eps_a, eps_r): the
# JAX script's table.  Tolerances are per configuration, matched to each
# problem's cost scale: eps_a covers the small-V region near the origin,
# eps_r the far field.
CONFIGS = [
    ("1. double integrator (2s, 1i, N=5)", "double_integrator",
     {}, 1e-2, 0.0),
    ("2. mass-spring mp-QP (4s, N=10)", "mass_spring", {}, 1.0, 0.1),
    ("3. inverted pendulum PWA mp-MIQP", "inverted_pendulum",
     {}, 1e-2, 0.0),
    ("4. satellite desaturation (6s, 27 deltas)", "satellite",
     {"axes": 3}, 1.0, 0.1),
    ("5. quadrotor obstacle avoidance (4-D pv, 16 deltas)", "quadrotor",
     {"param": "pv"}, 1.0, 0.1),
    # Demonstration rows: the same families certified end to end at a
    # tractable scale.
    ("4b. satellite z-axis slice (2s, 3 deltas)", "satellite",
     {"axes": 1}, 1e-2, 0.0),
    ("4c. satellite 6-D sub-box (25% box, 27 deltas)", "satellite",
     {"axes": 3, "omega_box": 0.03, "h_box": 0.3}, 1.0, 0.1),
    ("5b. quadrotor pv sub-box (10% box, 16 deltas)", "quadrotor",
     {"param": "pv", "pos_box": 0.4, "vel_box": 0.2}, 1.0, 0.1),
]


def _flush(path: str, result: dict) -> None:
    with open(path, "w") as f:
        json.dump(result, f, indent=2)


def config_row(label: str, name: str, kwargs: dict, eps_a: float,
               eps_r: float, dev, budget: float,
               forced_precision: str | None) -> dict:
    """One configuration built and measured: its row."""
    from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
    from explicit_hybrid_mpc_tpu_torch.oracle.oracle import Oracle
    from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
        build_partition)
    from explicit_hybrid_mpc_tpu_torch.post import analysis
    from explicit_hybrid_mpc_tpu_torch.problems.registry import make

    on_card = dev.type == "cuda"
    problem = make(name, **kwargs)
    precision = forced_precision or default_precision(on_card, problem)
    okw = dict(backend=dev.type, precision=precision,
               points_cap=2048 if on_card else 256)
    if not on_card and getattr(problem, "prune_hint", False):
        from explicit_hybrid_mpc_tpu_torch.oracle.prune import PrunedOracle

        oracle = PrunedOracle(problem, **okw)
    else:
        oracle = Oracle(problem, **okw)
    warm_oracle(oracle, problem)
    build_partition(problem, PartitionConfig(
        problem=name, eps_a=1.0, backend=dev.type, batch_simplices=512,
        max_steps=30, time_budget_s=120.0, precision=precision),
        oracle=oracle)
    oracle.n_solves = oracle.n_point_solves = oracle.n_rescue_solves = 0
    oracle.n_simplex_solves = 0

    cfg = PartitionConfig(problem=name, eps_a=eps_a, eps_r=eps_r,
                          backend=dev.type, batch_simplices=512,
                          max_steps=50_000, precision=precision,
                          time_budget_s=budget)
    res = build_partition(problem, cfg, oracle=oracle)
    stats = res.stats
    report = analysis.partition_report(res.tree, res.roots)
    return {
        "label": label, "problem": name, "kwargs": kwargs,
        "eps_a": eps_a, "eps_r": eps_r, "precision": precision,
        "n_theta": problem.n_theta,
        "n_delta": problem.canonical.n_delta,
        "regions": stats["regions"],
        "regions_per_s": round(stats["regions_per_s"], 2),
        "wall_s": round(stats["wall_s"], 2),
        "truncated": stats["truncated"],
        "frontier_left": stats["frontier_left"],
        "uncertified": stats["uncertified"],
        "max_depth": stats["max_depth"],
        "oracle_solves": stats["oracle_solves"],
        "cache_peak_mb": stats["cache_peak_mb"],
        "volume_certified_frac": round(report["volume_certified_frac"], 6),
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m explicit_hybrid_mpc_tpu_torch.tools.bench_configs",
        description=__doc__.splitlines()[0])
    ap.add_argument("--backend", choices=("cuda", "cpu"), default=None,
                    help="'cuda' (the default, else BENCH_PLATFORM; "
                         "refuses to start without a card) or 'cpu'")
    ap.add_argument("--out", default=None,
                    help="the JSON's path (else CONFIGS_OUT, else a temp "
                         "dir)")
    ap.add_argument("--sentinel", default=SENTINEL,
                    help="the capture-active file held while this runs")
    args = ap.parse_args(argv)
    budget = float(os.environ.get("CFG_TIME_BUDGET")
                   or os.environ.get("CONFIGS_TIME_BUDGET") or "600")
    only = os.environ.get("CFG_ONLY")
    only_names = set(only.split(",")) if only else None

    result: dict = {"captured_at": time.strftime("%Y-%m-%d %H:%M:%S"),
                    "per_config_budget_s": budget, "rows": []}
    dev = choose_device(result, args.backend, sentinel=args.sentinel)
    path = out_path(args.out, "CONFIGS_OUT", "configs.json",
                    "bench_configs")
    forced_precision = os.environ.get("CFG_PRECISION")
    result["precision"] = forced_precision or "per-problem default"
    for label, name, kwargs, eps_a, eps_r in CONFIGS:
        if only_names and name not in only_names:
            continue
        log(f"== {label} ==")
        try:
            row = config_row(label, name, kwargs, eps_a, eps_r, dev,
                             budget, forced_precision)
            log(f"  -> {row}")
        except Exception as e:  # one config must not void the others
            traceback.print_exc(file=sys.stderr)
            if card_fault(e):
                result["error"] = repr(e)
                break
            row = {"label": label, "problem": name, "error": repr(e)}
        result["rows"].append(row)
        _flush(path, result)
    _flush(path, result)
    print(json.dumps(result))
    return 1 if "error" in result else 0


if __name__ == "__main__":
    raise SystemExit(main())
