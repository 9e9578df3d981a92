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
lifecycle/cli.py); ``--backend serial`` is the host baseline (one
point or pair per call, each QP solved in numpy on the host:
oracle/host_qp.py), reached only by that name.  The build flags are the JAX
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
``--profile DIR`` writes a torch.profiler Chrome trace of the first
``--profile-steps`` frontier steps to DIR (CPU activity, plus the
card's kernels on cuda).  Diagnostics (obs/): ``--health-rule
NAME=VALUE`` (repeatable, needs ``--obs``) runs the in-build health
monitor, whose health.* events land in the obs stream;
``--auto-profile`` arms the bounded capture of obs/profiling.py, which
the first critical health verdict opens; ``--recorder`` (bundles under
PREFIX.repro/, or ``--recorder-dir DIR``, which implies it) dumps repro
bundles of solver anomalies, replayed by ``python -m
explicit_hybrid_mpc_tpu_torch.obs.replay BUNDLE``; ``--obs-per-process``
suffixes the obs stream with ``.pI-PID`` so several processes sharing
one prefix write one stream each (obs/fleet.py merges them).
``--mesh D`` splits the vertex-grid solves over a (D, 1) device mesh
(parallel/mesh.py: D distinct cards, or D entries of the CPU device
under ``--backend cpu``).  ``--shard-frontier`` builds this process's
share of the roots (partition/shard.py), exchanging shared cells with
its peers through files under ``--shard-dir`` (default PREFIX.shard);
start the N processes with the launcher, which sets RANK / WORLD_SIZE
and the rendezvous::

    python -m explicit_hybrid_mpc_tpu_torch.parallel.launch -n 2 -- \
        -e inverted_pendulum -a 1e-2 -o build/pend2

Every process merges the same tree; rank 0 writes the outputs, each
shard its own log (PREFIX.log.jsonl.pI), checkpoint (.pI) and, with
``--obs``, obs stream.

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
#: Empty since ROADMAP A6: every build flag of the JAX package runs.
_UNPORTED_FLAGS: dict = {}

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
    p.add_argument("--backend", choices=("cuda", "cpu", "serial"),
                   default="cuda",
                   help="'cuda' (default; raises without a GPU), 'cpu' "
                        "(the kernels' plain versions) or 'serial' (the "
                        "one-QP-per-call host baseline)")
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
    p.add_argument("--mesh", type=int, default=None, metavar="D",
                   help="split the vertex-grid solves over D devices "
                        "(D distinct cards; D entries of the CPU device "
                        "under --backend cpu)")
    p.add_argument("--max-depth", type=int, default=40)
    p.add_argument("--boundary-depth", type=int, default=None,
                   metavar="D", help="close mixed-feasibility simplices "
                   "at depth >= D as semi-explicit boundary leaves "
                   "(online fixed-delta QP) instead of splitting to "
                   "--max-depth")
    p.add_argument("--prune-rows", action="store_true",
                   help="prune never-active constraint rows with "
                   "KKT-verified per-solve fallback (row-heavy configs; "
                   "the reduced QPs run through the same IPM leg)")
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
    p.add_argument("--shard-frontier", action="store_true",
                   help="sharded frontier (partition/shard.py): each "
                        "process builds its own round-robin share of "
                        "the root simplices, with cross-process vertex "
                        "dedup through the exchange under --shard-dir; "
                        "the merged tree is node-for-node the single-"
                        "process build's (start the processes with "
                        "python -m explicit_hybrid_mpc_tpu_torch."
                        "parallel.launch)")
    p.add_argument("--shard-dir", metavar="DIR", default=None,
                   help="exchange/result directory shared by every "
                        "shard (default PREFIX.shard)")
    p.add_argument("--shard-timeout", type=float, default=None,
                   metavar="S",
                   help="remote-cell wait budget before a shard "
                        "re-solves locally (default 300)")
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
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="write a torch.profiler trace of the first "
                        "--profile-steps frontier steps to DIR")
    p.add_argument("--profile-steps", type=int, default=5)
    p.add_argument("--obs", choices=("off", "jsonl", "full"),
                   default="off",
                   help="observability mode: 'jsonl' streams spans and "
                   "metrics to PREFIX.obs.jsonl")
    p.add_argument("--obs-path", metavar="FILE", default=None,
                   help="override the obs stream path "
                   "(default PREFIX.obs.jsonl)")
    p.add_argument("--obs-per-process", action="store_true",
                   help="suffix the obs stream with .p<index>-<pid> "
                        "(fleet telemetry): N processes sharing one "
                        "prefix write N streams instead of interleaving "
                        "one file; obs.fleet.load_fleet merges them")
    p.add_argument("--auto-profile", action="store_true",
                   help="health-triggered bounded profiling "
                        "(obs/profiling.py): the first CRITICAL in-build "
                        "health verdict opens a torch.profiler capture "
                        "of --profile-steps steps and drops a summarized "
                        "auto_profile JSON bundle (needs --obs and "
                        "--health-rule)")
    p.add_argument("--recorder", action="store_true",
                   help="flight recorder: dump versioned compressed "
                        "repro bundles on solver anomalies (diverged "
                        "cells, simplex stalls, device failures, "
                        "uncertified leaves); replay them with python -m "
                        "explicit_hybrid_mpc_tpu_torch.obs.replay")
    p.add_argument("--recorder-dir", metavar="DIR", default=None,
                   help="bundle directory (default PREFIX.repro/; "
                        "implies --recorder)")
    p.add_argument("--health-rule", action="append", default=[],
                   metavar="NAME=VALUE",
                   help="override a streaming health rule (repeatable; "
                        "see obs.health.DEFAULT_RULES).  Any override "
                        "activates the in-build watchdog: health.* "
                        "events land in the obs stream (needs --obs)")
    p.add_argument("--recompile-guard", choices=("warn", "raise"),
                   default=None,
                   help="runtime recompile sentinel "
                        "(analysis/recompile_guard.py): after the "
                        "steady-state warmup, any NEW oracle shape on a "
                        "full-size frontier step emits a "
                        "health.recompile event (warn) or aborts the "
                        "build (raise)")
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


def _parse_health_rules(pairs: list[str]) -> tuple:
    """NAME=VALUE pairs -> cfg.health_rules tuple, with CLI-friendly
    errors.  Name/value validation is delegated to the ONE validator
    (obs.health.rules_from_pairs) so the known-rule list can never go
    stale here."""
    if not pairs:
        return ()
    from explicit_hybrid_mpc_tpu_torch.obs.health import rules_from_pairs

    out = []
    for kv in pairs:
        if "=" not in kv:
            raise SystemExit(f"--health-rule needs NAME=VALUE, got {kv!r}")
        k, v = kv.split("=", 1)
        try:
            rules_from_pairs([(k, float(v))])
        except ValueError as e:
            raise SystemExit(f"--health-rule: {e}")
        out.append((k, float(v)))
    return tuple(out)


def config_from_args(args: argparse.Namespace):
    """The PartitionConfig of a fresh build from parsed build flags, as
    the JAX package's CLI builds it from the same flags."""
    from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
    from explicit_hybrid_mpc_tpu_torch.parallel import distributed

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
        prune_rows=args.prune_rows,
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
        # Per-process log stream under sharding (the engine suffixes
        # the checkpoint itself): two shards appending one JSONL file
        # would interleave torn lines.
        log_path=(f"{prefix}.log.jsonl.p{distributed.process_index()}"
                  if args.shard_frontier else f"{prefix}.log.jsonl"),
        precision=args.precision,
        profile_path=args.profile, profile_steps=args.profile_steps,
        obs=args.obs,
        obs_path=(args.obs_path or f"{prefix}.obs.jsonl"
                  if args.obs != "off" else None),
        # Sharded builds force per-process obs streams: N shards
        # sharing one configured path would interleave one file.
        obs_per_process=(args.obs_per_process
                         or (args.shard_frontier and args.obs != "off")),
        auto_profile=args.auto_profile,
        # --recorder-dir implies --recorder: naming a bundle directory
        # and silently recording nothing would be the worst reading.
        obs_recorder=args.recorder or bool(args.recorder_dir),
        recorder_dir=(args.recorder_dir or f"{prefix}.repro"
                      if args.recorder or args.recorder_dir else None),
        health_rules=_parse_health_rules(args.health_rule),
        recompile_guard=args.recompile_guard or "off",
        solve_timeout_s=args.solve_timeout,
        fault_plan=args.fault_plan,
        rebuild_from=args.rebuild_from,
        rebuild_strict_provenance=args.strict_provenance,
        shard_frontier=args.shard_frontier,
        shard_dir=(args.shard_dir or f"{prefix}.shard"
                   if args.shard_frontier else args.shard_dir),
        **({"shard_timeout_s": args.shard_timeout}
           if args.shard_timeout is not None else {}),
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
    if args.health_rule and args.obs == "off":
        # The in-build watchdog lives on the obs stream; configuring
        # rules that can never fire is the exact silent failure the
        # rule-name validation exists to prevent.
        raise SystemExit("--health-rule requires --obs jsonl|full "
                         "(the watchdog evaluates the obs stream)")
    if rebuild_cmd and not args.rebuild_from:
        raise SystemExit("rebuild: --from PRIOR (a .tree.pkl or "
                         ".ckpt.pkl) is required")
    if args.rebuild_from and args.resume:
        raise SystemExit("--rebuild-from and --resume are exclusive: "
                         "resume continues ONE build mid-flight, "
                         "rebuild starts a NEW build from a prior "
                         "tree's certificates")

    from explicit_hybrid_mpc_tpu_torch.problems.registry import names
    if args.list:
        print("\n".join(names()))
        return 0

    from explicit_hybrid_mpc_tpu_torch.parallel import distributed
    from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
        load_checkpoint)

    if args.shard_frontier and args.resume:
        # Each shard resumes its OWN checkpoint (the engine suffixes it
        # with .p<rank>); a single-shard run saved it unsuffixed.
        cand = f"{args.resume}.p{distributed.process_index()}"
        if os.path.exists(cand) or os.path.exists(cand + ".prev"):
            args.resume = cand
    prefix = args.output
    os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
    cfg = config_from_args(args)
    snapshot = None
    if args.resume:
        # load_checkpoint verifies the content checksum and falls back
        # to the .prev generation on a torn file.
        snapshot = load_checkpoint(args.resume)
        cfg = resumed_config(cfg, snapshot["cfg"])
    # The rendezvous comes before any device is touched (a launch
    # without RANK / WORLD_SIZE is a single-shard run, the plain build);
    # a group the caller joined stays the caller's.
    joined = args.shard_frontier and not distributed.initialized()
    if joined:
        distributed.init_distributed()
    try:
        return _build(args, cfg, snapshot, prefix)
    finally:
        if joined:
            distributed.shutdown()


def _build(args, cfg, snapshot, prefix: str) -> int:
    """main's build and its outputs, from the final config."""
    from explicit_hybrid_mpc_tpu_torch.parallel import distributed
    from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
        FrontierEngine, make_oracle)
    from explicit_hybrid_mpc_tpu_torch.problems.registry import make
    from explicit_hybrid_mpc_tpu_torch.utils.logging import RunLog

    problem = make(cfg.problem, **dict(cfg.problem_args))
    mesh = None
    if args.mesh:
        from explicit_hybrid_mpc_tpu_torch.parallel.mesh import cli_mesh

        try:
            mesh = cli_mesh(args.mesh, cfg.backend)
        except (RuntimeError, ValueError) as e:
            raise SystemExit(f"--mesh {args.mesh}: {e}")
    # strict: a --prune-rows that cannot take effect (--backend serial,
    # --mesh) is a command-line error, not a silent plain build.
    try:
        oracle = make_oracle(problem, cfg, mesh=mesh, strict=True)
    except ValueError as e:
        raise SystemExit(str(e))
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
    if args.shard_frontier and not distributed.is_frontier_owner():
        # Every shard holds the identical merged result; only the owner
        # writes the shared outputs (the per-shard trees and stats stay
        # under the shard directory).
        return 0
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


def cli(argv: list[str] | None = None) -> int:
    """main() as its process runs it: a NoCpuFallback (a card build's
    device failure) prints its traceback, the failure it was chained to
    included, and exits with device.NO_CPU_FALLBACK_EXIT, which tells a
    supervisor that no restart can mend it.  In-process callers of
    main() see the exception itself."""
    import traceback

    from explicit_hybrid_mpc_tpu_torch import device as device_lib

    try:
        return main(argv)
    except device_lib.NoCpuFallback:
        traceback.print_exc()
        return device_lib.NO_CPU_FALLBACK_EXIT


if __name__ == "__main__":
    raise SystemExit(cli())
