"""CLI entry point for the offline partition build (torch port).

    python -m explicit_hybrid_mpc_tpu_torch.main -e inverted_pendulum \\
        -a 1e-2 --batch 256 -o build/pend --evaluate 65536

Runs on the first CUDA device unless ``--backend cpu`` is given.
Outputs under --output PREFIX: PREFIX.tree.pkl (the simplex tree),
PREFIX.stats.json (build statistics), PREFIX.log.jsonl (per-step
metrics).  ``--evaluate N`` then exports the leaf table, stages it on
the build's device and evaluates the controller at N sampled thetas
through the point-location kernel, printing the evaluation summary.

The JAX package's other surfaces (serve, serve-rebuild, rebuild,
--resume, --mesh, --simulate) exit with "not yet ported".
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

_UNPORTED_COMMANDS = ("serve", "serve-rebuild", "rebuild")
_UNPORTED_FLAGS = ("--resume", "--mesh", "--simulate")


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
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
