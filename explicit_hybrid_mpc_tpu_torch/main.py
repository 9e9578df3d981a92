"""CLI entry point of the torch port: the offline partition build, the
warm ``rebuild``, and the ``serve`` and ``serve-rebuild`` subcommands.

    python -m explicit_hybrid_mpc_tpu_torch.main -e inverted_pendulum \\
        -a 1e-2 --batch 256 -o build/pend --evaluate 65536 \\
        --artifacts-out build/pend.artifacts --simulate 100
    python -m explicit_hybrid_mpc_tpu_torch.main -e quadrotor -r 0.1 -a 1 \\
        --problem-arg param='"pv"' --problem-arg pos_box=0.4 \\
        --problem-arg vel_box=0.2 -o build/quad --checkpoint-every 5
    python -m explicit_hybrid_mpc_tpu_torch.main -e quadrotor \\
        -o build/quad2 --resume build/quad.ckpt.pkl
    python -m explicit_hybrid_mpc_tpu_torch.main rebuild \\
        --from build/pend.tree.pkl -e inverted_pendulum -a 9e-3 \\
        -o build/pend2
    python -m explicit_hybrid_mpc_tpu_torch.main serve \\
        --artifacts build/pend.artifacts --selftest 4096
    python -m explicit_hybrid_mpc_tpu_torch.main serve-rebuild \\
        -e double_integrator --problem-arg N=3 --revisions 1 \\
        --artifacts-root build/lc

Runs on the first CUDA device unless ``--backend cpu`` is given (the
serve and serve-rebuild subcommands likewise: serve/cli.py,
lifecycle/cli.py).  The build flags are the JAX
package's, with its defaults and its tolerance rule (``-a`` defaults to
1e-2, or to 0 when ``-r`` is given); ``config_from_args`` maps them to
the PartitionConfig.  Outputs under --output PREFIX: PREFIX.tree.pkl
(the simplex tree), PREFIX.stats.json (build statistics),
PREFIX.log.jsonl (per-step metrics), PREFIX.ckpt.pkl with
``--checkpoint-every K`` (resume with ``--resume``: the snapshot's
solver settings, this run's budget and output paths).  ``--evaluate N``
then exports the leaf table, stages it on the build's device and
evaluates the controller at N sampled thetas through the
point-location kernel, printing the evaluation summary.
``rebuild --from PRIOR`` (or ``--rebuild-from PRIOR`` on the build
surface) is the incremental warm rebuild of partition/rebuild.py: the
prior .tree.pkl or .ckpt.pkl is transferred, its leaves re-certified
against this problem and eps, and only what the revision invalidated
is subdivided; ``--strict-provenance`` refuses a prior without a
provenance stamp.  ``--artifacts-out DIR`` exports the tree as a
serving artifact directory (the ``serve --artifacts`` input).
``--simulate T`` runs a T-step closed-loop explicit-vs-implicit comparison on the build's
device (the explicit controller through the point-location kernel,
the implicit one through the oracle) and writes PREFIX.sim.json.

The JAX package's flags in _UNPORTED_FLAGS exit with "not yet ported"
and the ROADMAP item that brings them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

#: Build flags of the JAX package whose modules are not ported yet:
#: flag -> the ROADMAP item and the JAX package's module it waits for.
_UNPORTED_FLAGS = {
    "--mesh": "A4 (parallel/mesh.py)",
    "--prune-rows": "A3 (oracle/prune.py)",
    "--shard-frontier": "A4 (partition/shard.py)",
    "--shard-dir": "A4 (partition/shard.py)",
    "--shard-timeout": "A4 (partition/shard.py)",
    "--profile": "A2 (the profiler capture of partition/frontier.py)",
    "--profile-steps": "A2 (the profiler capture of partition/frontier.py)",
    "--auto-profile": "A2 (obs/profiling.py)",
    "--recorder": "A5 (obs/recorder.py)",
    "--recorder-dir": "A5 (obs/recorder.py)",
    "--health-rule": "A5 (obs/health.py)",
    "--obs-per-process": "A5 (obs/fleet.py)",
    "--recompile-guard": "A6 (analysis/recompile_guard.py)",
}

#: PartitionConfig fields that belong to one run, not to the partition
#: being built: a resumed build takes them from its own command line and
#: every other field from the snapshot (budget, outputs, pipelining,
#: diagnostics, recovery -- none of them changes a solved value).
_RUN_SCOPED = (
    "log_path", "prefetch_solves", "pipeline_depth", "speculate",
    "dedup_window", "max_steps", "checkpoint_every", "checkpoint_path",
    "profile_path", "profile_steps", "obs", "obs_path", "obs_per_process",
    "auto_profile", "obs_recorder", "recorder_dir", "health_rules",
    "recompile_guard", "solve_timeout_s", "oracle_retry_attempts",
    "oracle_retry_backoff_s", "device_failure_cap", "fault_plan",
    "shard_frontier", "shard_dir", "shard_timeout_s", "async_certify")

#: Solver fields a resumed build takes from the snapshot; a command-line
#: value that differs is reported and ignored.
_SOLVER_FIELDS = (
    "problem", "problem_args", "eps_a", "eps_r", "algorithm", "backend",
    "precision", "ipm_point_schedule", "ipm_rescue_iters", "ipm_two_phase",
    "ipm_phase1_iters", "ipm_phase1_iters_point",
    "ipm_phase1_iters_simplex", "warm_start_tree", "ipm_kernel",
    "batch_simplices", "max_depth", "semi_explicit_boundary_depth",
    "prune_rows")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="explicit_hybrid_mpc_tpu_torch",
        description="approximate explicit hybrid MPC on CUDA: offline "
                    "partition build and online evaluation")
    p.add_argument("-e", "--example", required=True,
                   help="benchmark problem name (see --list)")
    p.add_argument("-a", "--eps-a", type=float, default=None,
                   help="absolute suboptimality tolerance eps_a "
                        "(default 1e-2, or 0 when -r is given)")
    p.add_argument("-r", "--eps-r", type=float, default=None,
                   help="relative suboptimality tolerance eps_r")
    p.add_argument("--algorithm", choices=("suboptimal", "feasible"),
                   default="suboptimal",
                   help="fully-explicit eps-suboptimal partition vs "
                        "semi-explicit feasibility-only variant")
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
    p.add_argument("--boundary-depth", type=int, default=None,
                   metavar="D", help="close mixed-feasibility simplices "
                   "at depth >= D as semi-explicit boundary leaves "
                   "(online fixed-delta QP) instead of splitting to "
                   "--max-depth")
    p.add_argument("--no-two-phase", action="store_true",
                   help="disable the two-phase early-exit IPM cohort "
                   "(run the full fixed schedule on every QP)")
    p.add_argument("--phase1-iters", type=int, default=None, metavar="N",
                   help="f64 iterations in the cohort's first phase "
                   "(default: 2/5 of each class's f64 schedule)")
    p.add_argument("--phase1-iters-point", type=int, default=None,
                   metavar="N", help="per-class override of "
                   "--phase1-iters for the point-class programs only")
    p.add_argument("--phase1-iters-simplex", type=int, default=None,
                   metavar="N", help="per-class override of "
                   "--phase1-iters for the joint elastic-simplex "
                   "programs only")
    p.add_argument("--no-warm-start", action="store_true",
                   help="disable tree warm-starts (cold-start every "
                   "child-vertex QP)")
    p.add_argument("--pipeline-depth", type=int, default=None,
                   metavar="N", help="frontier batches planned and "
                   "dispatched ahead of the committing step (default 2; "
                   "0 = synchronous; the tree is the same at any depth)")
    p.add_argument("--no-speculate", action="store_true",
                   help="disable speculative child dispatch")
    p.add_argument("--dedup-window", type=int, default=None, metavar="K",
                   help="max in-flight vertices tracked for cross-batch "
                   "solve dedup (default 8192)")
    p.add_argument("--async-certify", action="store_true",
                   help="a background waiter resolves in-flight "
                   "lookahead programs while the host certifies (the "
                   "tree is the same)")
    p.add_argument("--max-steps", type=int, default=10_000)
    p.add_argument("--checkpoint-every", type=int, default=0, metavar="K",
                   help="snapshot frontier+tree to PREFIX.ckpt.pkl every "
                   "K steps")
    p.add_argument("--resume", metavar="CKPT",
                   help="resume a build from a checkpoint file")
    p.add_argument("--rebuild-from", "--from", dest="rebuild_from",
                   metavar="PRIOR", default=None,
                   help="incremental warm rebuild (partition/rebuild.py"
                        "): transfer PRIOR (.tree.pkl or .ckpt.pkl), "
                        "bulk re-certify its leaves against THIS "
                        "problem/eps, and subdivide only what the "
                        "revision invalidated (the `rebuild` "
                        "subcommand implies this flag)")
    p.add_argument("--strict-provenance", action="store_true",
                   help="refuse rebuild priors without a provenance "
                        "stamp (legacy artifacts otherwise shim with a "
                        "stats note)")
    p.add_argument("--solve-timeout", type=float, default=None,
                   metavar="S", help="watchdog timeout per oracle "
                   "attempt (faults/policy.py)")
    p.add_argument("--fault-plan", metavar="PLAN.json", default=None,
                   help="deterministic fault-injection plan "
                   "(faults/plan.py; chaos testing only)")
    p.add_argument("--obs", choices=("off", "jsonl", "full"),
                   default="off",
                   help="observability mode: 'jsonl' streams spans and "
                   "metrics to PREFIX.obs.jsonl")
    p.add_argument("--obs-path", metavar="FILE", default=None,
                   help="override the obs stream path "
                   "(default PREFIX.obs.jsonl)")
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
    p.add_argument("--list", action="store_true",
                   help="list registered problems and exit")
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


def config_from_args(args: argparse.Namespace):
    """The PartitionConfig of a fresh build from parsed build flags, as
    the JAX package's CLI builds it from the same flags."""
    from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig

    problem_args = _parse_problem_args(args.problem_arg)
    prefix = args.output
    eps_a = args.eps_a if args.eps_a is not None else (
        1e-2 if args.eps_r is None else 0.0)
    return PartitionConfig(
        problem=args.example,
        problem_args=tuple(sorted(problem_args.items())), eps_a=eps_a,
        eps_r=args.eps_r if args.eps_r is not None else 0.0,
        algorithm=args.algorithm, backend=args.backend,
        batch_simplices=args.batch, max_depth=args.max_depth,
        semi_explicit_boundary_depth=args.boundary_depth,
        ipm_two_phase=not args.no_two_phase,
        ipm_phase1_iters=args.phase1_iters,
        ipm_phase1_iters_point=args.phase1_iters_point,
        ipm_phase1_iters_simplex=args.phase1_iters_simplex,
        warm_start_tree=not args.no_warm_start,
        ipm_kernel=args.ipm_kernel,
        **({"pipeline_depth": args.pipeline_depth}
           if args.pipeline_depth is not None else {}),
        speculate=not args.no_speculate,
        **({"dedup_window": args.dedup_window}
           if args.dedup_window is not None else {}),
        max_steps=args.max_steps,
        checkpoint_every=args.checkpoint_every,
        checkpoint_path=(f"{prefix}.ckpt.pkl"
                         if args.checkpoint_every else None),
        log_path=f"{prefix}.log.jsonl",
        precision=args.precision,
        obs=args.obs,
        obs_path=(args.obs_path or f"{prefix}.obs.jsonl"
                  if args.obs != "off" else None),
        solve_timeout_s=args.solve_timeout,
        fault_plan=args.fault_plan,
        rebuild_from=args.rebuild_from,
        rebuild_strict_provenance=args.strict_provenance,
        async_certify=args.async_certify)


def resumed_config(cfg, snap_cfg):
    """The config a resumed build runs with: the snapshot's solver
    settings (a command-line value that differs is reported on stderr
    and ignored) and this run's run-scoped fields (_RUN_SCOPED)."""
    for fld in _SOLVER_FIELDS:
        cli_v, snap_v = getattr(cfg, fld), getattr(snap_cfg, fld)
        if cli_v != snap_v:
            print(f"resume: using snapshot {fld}={snap_v!r} (CLI value "
                  f"{cli_v!r} ignored)", file=sys.stderr)
    return dataclasses.replace(
        snap_cfg, **{fld: getattr(cfg, fld) for fld in _RUN_SCOPED})


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
    if argv and argv[0] == "serve-rebuild":
        # The continuous rebuild daemon dispatches the same way: its
        # flags are service-scoped, not the build parser's.
        from explicit_hybrid_mpc_tpu_torch.lifecycle.cli import (
            serve_rebuild_main)

        return serve_rebuild_main(argv[1:])
    # `rebuild` is sugar over the build surface: same parser, --from
    # required.
    rebuild_cmd = bool(argv) and argv[0] == "rebuild"
    if rebuild_cmd:
        argv = argv[1:]
    for flag, item in _UNPORTED_FLAGS.items():
        if any(a == flag or a.startswith(flag + "=") for a in argv):
            raise SystemExit(f"{flag}: not yet ported to the torch package "
                             f"(ROADMAP {item})")
    args = build_parser().parse_args(argv)
    if rebuild_cmd and not args.rebuild_from:
        raise SystemExit("rebuild: --from PRIOR (a .tree.pkl or "
                         ".ckpt.pkl) is required")
    if args.rebuild_from and args.resume:
        raise SystemExit("--rebuild-from and --resume are exclusive: "
                         "resume continues ONE build mid-flight, "
                         "rebuild starts a NEW build from a prior "
                         "tree's certificates")

    from explicit_hybrid_mpc_tpu_torch.problems.registry import make, names
    if args.list:
        print("\n".join(names()))
        return 0

    from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
        FrontierEngine, load_checkpoint, make_oracle)
    from explicit_hybrid_mpc_tpu_torch.utils.logging import RunLog

    prefix = args.output
    os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
    cfg = config_from_args(args)
    snapshot = None
    if args.resume:
        # load_checkpoint verifies the content checksum and falls back
        # to the .prev generation on a torn file.
        snapshot = load_checkpoint(args.resume)
        cfg = resumed_config(cfg, snapshot["cfg"])
    problem = make(cfg.problem, **dict(cfg.problem_args))
    oracle = make_oracle(problem, cfg)
    log = RunLog(cfg.log_path, echo=True)
    if snapshot is not None:
        res = FrontierEngine.resume(snapshot, problem, oracle, log,
                                    cfg=cfg).run()
    elif cfg.rebuild_from:
        from explicit_hybrid_mpc_tpu_torch.partition.provenance import (
            ProvenanceMismatch)
        from explicit_hybrid_mpc_tpu_torch.partition.rebuild import (
            RebuildError, warm_rebuild)

        try:
            res = warm_rebuild(
                problem, cfg, cfg.rebuild_from, oracle=oracle, log=log,
                strict_provenance=cfg.rebuild_strict_provenance)
        except (RebuildError, ProvenanceMismatch) as e:
            raise SystemExit(f"rebuild: {e}")
    else:
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
