"""CLI entry point of the torch port: the offline partition build, and
the ``serve`` subcommand.

    python -m explicit_hybrid_mpc_tpu_torch.main -e inverted_pendulum \\
        -a 1e-2 --batch 256 -o build/pend --evaluate 65536 \\
        --artifacts-out build/pend.artifacts --simulate 100
    python -m explicit_hybrid_mpc_tpu_torch.main serve \\
        --artifacts build/pend.artifacts --selftest 4096

Runs on the first CUDA device unless ``--backend cpu`` is given (the
serve subcommand likewise: serve/cli.py).  Outputs under --output
PREFIX: PREFIX.tree.pkl (the simplex tree), PREFIX.stats.json (build
statistics), PREFIX.log.jsonl (per-step metrics).  ``--evaluate N``
then exports the leaf table, stages it on the build's device and
evaluates the controller at N sampled thetas through the
point-location kernel, printing the evaluation summary.
``--artifacts-out DIR`` exports the tree as a serving artifact
directory (the ``serve --artifacts`` input).  ``--simulate T`` runs a
T-step closed-loop explicit-vs-implicit comparison on the build's
device (the explicit controller through the point-location kernel,
the implicit one through the oracle) and writes PREFIX.sim.json.

The JAX package's other surfaces (serve-rebuild, rebuild, --resume,
--mesh) exit with "not yet ported".
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

_UNPORTED_COMMANDS = ("serve-rebuild", "rebuild")
_UNPORTED_FLAGS = ("--resume", "--mesh")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="explicit_hybrid_mpc_tpu_torch",
        description="approximate explicit hybrid MPC on CUDA: offline "
                    "partition build and online evaluation")
    p.add_argument("-e", "--example", required=True,
                   help="benchmark problem name")
    p.add_argument("-a", "--eps-a", type=float, default=1e-2,
                   help="absolute suboptimality tolerance eps_a")
    p.add_argument("--backend", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--precision", choices=("f64", "mixed"), default="f64",
                   help="IPM iteration precision: pure float64 vs "
                        "f32-bulk + f64-polish (same tolerance)")
    p.add_argument("--ipm-kernel", choices=("auto", "cuda", "torch"),
                   default="auto",
                   help="IPM leg dispatch (oracle/ipm_leg.py): 'auto' "
                        "follows the backend (CUDA kernel on cuda, its "
                        "plain torch version on cpu)")
    p.add_argument("--batch", type=int, default=256,
                   help="frontier simplices per device step")
    p.add_argument("--max-depth", type=int, default=40)
    p.add_argument("--problem-arg", action="append", default=[],
                   metavar="K=V", help="problem constructor overrides, "
                   "e.g. --problem-arg N=5")
    p.add_argument("-o", "--output", default="partition",
                   help="output file prefix")
    p.add_argument("--evaluate", type=int, default=0, metavar="N",
                   help="after the build, export the leaf table and "
                        "evaluate the controller at N sampled thetas")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the --evaluate thetas")
    p.add_argument("--artifacts-out", metavar="DIR", default=None,
                   help="additionally export the built tree as a "
                        "provenance-stamped serving artifact directory "
                        "(serve/registry.save_artifacts layout; deploy "
                        "with `main serve --artifacts DIR`)")
    p.add_argument("--simulate", type=int, default=0, metavar="T",
                   help="after the build, run a T-step closed-loop "
                        "explicit-vs-implicit comparison on the build's "
                        "device and write PREFIX.sim.json")
    return p


def _parse_problem_args(pairs: list[str]) -> dict:
    out = {}
    for kv in pairs:
        if "=" not in kv:
            raise SystemExit(f"--problem-arg needs K=V, got {kv!r}")
        k, v = kv.split("=", 1)
        try:
            out[k] = json.loads(v)
        except json.JSONDecodeError:
            out[k] = v
    return out


def evaluate_sampled(problem, tree, n: int, device, seed: int = 0) -> dict:
    """Export `tree`, stage it on `device`, and evaluate the controller
    at `n` thetas drawn uniformly from the problem's box: located by
    the point-location kernel, interpolated in f64."""
    import numpy as np
    import torch

    from explicit_hybrid_mpc_tpu_torch.online import evaluator, export, locate

    table = export.export_leaves(tree)
    dev_table = evaluator.stage(table, device=device)
    ltable = locate.stage(table, device=device)
    rng = np.random.default_rng(seed)
    thetas = rng.uniform(problem.theta_lb, problem.theta_ub,
                         size=(n, problem.n_theta))
    th = torch.as_tensor(thetas, device=device)
    t0 = time.perf_counter()
    res = locate.evaluate(ltable, dev_table, th)
    inside = res.inside.cpu().numpy()
    if th.is_cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    u = res.u.cpu().numpy()
    return {"queries": n, "leaves": int(table.n_leaves),
            "inside_frac": float(inside.mean()) if n else 0.0,
            "u_finite": bool(np.isfinite(u).all()),
            "wall_s": wall, "us_per_query": 1e6 * wall / max(n, 1)}


def main(argv: list[str] | None = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "serve":
        # The online serving runtime is a subcommand, dispatched before
        # the build parser (whose -e/--example is required).
        from explicit_hybrid_mpc_tpu_torch.serve.cli import serve_main

        return serve_main(argv[1:])
    if argv and argv[0] in _UNPORTED_COMMANDS:
        raise SystemExit(f"{argv[0]}: not yet ported to the torch package "
                         "(see ROADMAP.md)")
    for flag in _UNPORTED_FLAGS:
        if any(a == flag or a.startswith(flag + "=") for a in argv):
            raise SystemExit(f"{flag}: not yet ported to the torch package "
                             "(see ROADMAP.md)")
    args = build_parser().parse_args(argv)

    from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
    from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
        FrontierEngine, make_oracle)
    from explicit_hybrid_mpc_tpu_torch.problems.registry import make
    from explicit_hybrid_mpc_tpu_torch.utils.logging import RunLog

    problem_args = _parse_problem_args(args.problem_arg)
    prefix = args.output
    os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
    cfg = PartitionConfig(
        problem=args.example,
        problem_args=tuple(sorted(problem_args.items())),
        eps_a=args.eps_a, backend=args.backend, precision=args.precision,
        ipm_kernel=args.ipm_kernel, batch_simplices=args.batch,
        max_depth=args.max_depth, log_path=f"{prefix}.log.jsonl")
    problem = make(cfg.problem, **dict(cfg.problem_args))
    oracle = make_oracle(problem, cfg)
    log = RunLog(cfg.log_path, echo=True)
    res = FrontierEngine(problem, oracle, cfg, log).run()
    res.tree.save(f"{prefix}.tree.pkl")
    with open(f"{prefix}.stats.json", "w") as f:
        json.dump(res.stats, f, indent=2)
    print(json.dumps(res.stats), file=sys.stderr)
    if args.evaluate:
        summary = evaluate_sampled(problem, res.tree, args.evaluate,
                                   oracle.device, seed=args.seed)
        print(json.dumps({"evaluate": summary}), file=sys.stderr)
    if args.artifacts_out:
        from explicit_hybrid_mpc_tpu_torch.serve.registry import (
            save_artifacts)

        save_artifacts(res.tree, res.roots, args.artifacts_out)
        print(f"serving artifacts written to {args.artifacts_out}",
              file=sys.stderr)
    if args.simulate:
        simulate_to(f"{prefix}.sim.json", problem, res.tree, oracle,
                    args.simulate, cfg.algorithm == "feasible")
    return 0


def simulate_to(path: str, problem, tree, oracle, T: int,
                semi_explicit: bool) -> dict:
    """The --simulate step: a T-step closed-loop explicit-vs-implicit
    comparison from 0.8 * theta_ub on the oracle's device (explicit
    controller through the point-location kernel), written to `path`
    with the JAX package's sim.json keys; returns the written dict."""
    import numpy as np

    from explicit_hybrid_mpc_tpu_torch.online import export
    from explicit_hybrid_mpc_tpu_torch.sim import simulator

    table = export.export_leaves(tree)
    theta0 = 0.8 * problem.theta_ub
    # Feasibility-only partitions deploy semi-explicitly (the leaf fixes
    # delta and a small convex QP runs online); hybrid builds carry
    # semi-explicit BOUNDARY leaves, which the mask routes through the
    # online fixed-delta QP.
    semi_mask = export.semi_explicit_mask(tree, table)
    cmp = simulator.compare(problem, table, oracle, theta0, T=T,
                            backend="kernel", semi_explicit=semi_explicit,
                            semi_mask=semi_mask, device=oracle.device)
    sim_stats = {
        "theta0": np.asarray(theta0).tolist(),
        "explicit_cost": cmp.explicit.total_cost,
        "implicit_cost": cmp.implicit.total_cost,
        "cost_ratio": cmp.cost_ratio,
        "explicit_us_per_step": cmp.explicit.mean_eval_us,
        "implicit_us_per_step": cmp.implicit.mean_eval_us,
        "online_speedup": cmp.speedup,
        # Full trajectories, so a plot of the closed loop needs only
        # this file.
        "trajectories": {
            label: {"states": np.asarray(r.states).tolist(),
                    "inputs": np.asarray(r.inputs).tolist()}
            for label, r in (("explicit", cmp.explicit),
                             ("implicit", cmp.implicit))},
    }
    with open(path, "w") as f:
        json.dump(sim_stats, f, indent=2)
    # stderr keeps the compact summary; the trajectories live only in
    # the file.
    print(json.dumps({k: v for k, v in sim_stats.items()
                      if k != "trajectories"}), file=sys.stderr)
    return sim_stats


if __name__ == "__main__":
    raise SystemExit(main())
