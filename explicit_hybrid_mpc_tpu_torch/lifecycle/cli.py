"""CLI for the continuous rebuild daemon: ``main serve-rebuild``.

Runs a RebuildService against either the simulated plant-drift driver
(the default: a seeded bounded walk on one constructor argument) or an
external JSONL revision stream (``--source FILE``: one revision dict
per line, the integration surface for a real sys-id pipeline).  Prints
a JSON summary (generations, staleness p50/p99, reuse decay, delta
byte ratio) and exits nonzero on any rebuild failure.

    python -m explicit_hybrid_mpc_tpu_torch.main serve-rebuild \\
        -e double_integrator --problem-arg N=3 \\
        --problem-arg theta_box=1.5 -a 0.2 \\
        --revisions 3 --artifacts-root build/lc --obs jsonl

Rebuilds run, and the in-process registry serves, on the CUDA device
unless ``--backend cpu`` is given.  The JAX package's CLI defaults to
the CPU instead.
"""

from __future__ import annotations

import argparse
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="explicit_hybrid_mpc_tpu_torch serve-rebuild",
        description="continuous rebuild daemon: plant-drift watch -> "
                    "SLA-scheduled warm rebuild -> delta publish -> "
                    "hot swap, on the CUDA device by default")
    p.add_argument("-e", "--example", required=True,
                   help="benchmark problem name (problems/registry.py)")
    p.add_argument("--problem-arg", action="append", default=[],
                   metavar="K=V", help="problem constructor overrides")
    p.add_argument("-a", "--eps-a", type=float, default=1e-2)
    p.add_argument("-r", "--eps-r", type=float, default=0.0)
    p.add_argument("--backend", choices=("cuda", "cpu", "serial"),
                   default="cuda",
                   help="rebuild and serving device: 'cuda' (default; "
                        "raises without a GPU) or 'cpu'.  'serial' is "
                        "not yet ported.  The JAX package's CLI defaults "
                        "to cpu")
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--controller", default="default",
                   help="registry controller name rebuilt generations "
                        "publish under")
    p.add_argument("--artifacts-root", required=True, metavar="DIR",
                   help="published artifact root "
                        "(<DIR>/<controller>/<version>[.delta])")
    p.add_argument("--source", metavar="FILE.jsonl", default=None,
                   help="external JSONL revision stream (default: the "
                        "simulated drift driver)")
    p.add_argument("--drift-arg", default="u_max", metavar="ARG",
                   help="constructor argument the drift walk perturbs "
                        "(default u_max; never the theta box)")
    p.add_argument("--drift-frac", type=float, default=0.02,
                   help="per-revision drift step fraction (default "
                        "0.02; the walk is clamped to +-20%%)")
    p.add_argument("--eps-frac", type=float, default=0.0,
                   help="per-revision eps_a walk step fraction "
                        "(default 0: eps fixed)")
    p.add_argument("--revisions", type=int, default=3, metavar="K",
                   help="drift revisions to emit before exiting "
                        "(default 3; 0 = run until --duration)")
    p.add_argument("--period", type=float, default=0.0, metavar="S",
                   help="min seconds between drift revisions")
    p.add_argument("--probe-T", type=int, default=0, metavar="T",
                   help="open-loop divergence probe horizon (sim/"
                        "simulator.py) recorded with each revision; "
                        "0 skips the probe")
    p.add_argument("--sla", type=float, default=600.0, metavar="S",
                   help="staleness budget (health.staleness past it)")
    p.add_argument("--prior", metavar="TREE.pkl", default=None,
                   help="seed the controller chain from a prior tree/"
                        "checkpoint (default: generation 0 builds "
                        "cold)")
    p.add_argument("--no-delta", action="store_true",
                   help="always publish full artifacts")
    p.add_argument("--full-every", type=int, default=0, metavar="K",
                   help="re-anchor with a full artifact every K "
                        "generations (bounds replica delta chains)")
    p.add_argument("--no-serve", action="store_true",
                   help="publish to disk only (no in-process registry "
                        "hot swap)")
    p.add_argument("--duration", type=float, default=None, metavar="S",
                   help="wall budget; default: exit once the drift "
                        "source is exhausted and the queue drains")
    p.add_argument("--obs", choices=("off", "jsonl", "full"),
                   default="off")
    p.add_argument("--obs-path", metavar="FILE", default=None,
                   help="obs stream path (default <artifacts-root>/"
                        "lifecycle.obs.jsonl)")
    p.add_argument("--fault-plan", metavar="PLAN.json", default=None,
                   help="deterministic fault injection (chaos only)")
    p.add_argument("--json", dest="json_out", default=None,
                   help="also write the summary JSON here")
    return p


def serve_rebuild_main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if not args.source and args.revisions <= 0 and args.duration is None:
        raise SystemExit(
            "serve-rebuild: an unbounded drift walk (--revisions 0) "
            "needs --duration S (otherwise the daemon would rebuild "
            "for an arbitrary hour and exit)")
    if args.backend == "serial":
        raise SystemExit(
            "serve-rebuild: backend='serial' is not yet ported to the torch "
            "package (ROADMAP A1: oracle/bnb.py serial baseline)")
    import os

    from explicit_hybrid_mpc_tpu_torch import device as device_lib

    try:
        # Resolved before the daemon starts: without a GPU the default
        # exits here instead of failing every generation.
        device_lib.resolve(args.backend)
    except RuntimeError as e:
        raise SystemExit(f"serve-rebuild: {e}")

    from explicit_hybrid_mpc_tpu_torch import obs as obs_lib
    from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
    from explicit_hybrid_mpc_tpu_torch.lifecycle.revision import (
        DriftSource, FileRevisionSource)
    from explicit_hybrid_mpc_tpu_torch.lifecycle.service import (
        LifecycleConfig, RebuildService)
    from explicit_hybrid_mpc_tpu_torch.main import _parse_problem_args

    problem_args = tuple(sorted(
        _parse_problem_args(args.problem_arg).items()))
    # The default obs stream lives under the artifacts root: it must
    # exist before the sink opens (the daemon itself creates only the
    # per-version subdirectories).
    os.makedirs(args.artifacts_root, exist_ok=True)
    build_cfg = PartitionConfig(
        problem=args.example, problem_args=problem_args,
        eps_a=args.eps_a, eps_r=args.eps_r, backend=args.backend,
        batch_simplices=args.batch, obs=args.obs,
        obs_path=(args.obs_path
                  or os.path.join(args.artifacts_root,
                                  "lifecycle.obs.jsonl")
                  if args.obs != "off" else None),
        fault_plan=args.fault_plan)
    if args.source:
        source = FileRevisionSource(args.source,
                                    controller=args.controller)
    else:
        source = DriftSource(
            args.example, problem_args=problem_args,
            controller=args.controller, eps_a=args.eps_a,
            eps_r=args.eps_r, drift_arg=args.drift_arg,
            drift_frac=args.drift_frac, eps_frac=args.eps_frac,
            n_revisions=args.revisions or None, period_s=args.period,
            probe_T=args.probe_T)
    lc_cfg = LifecycleConfig(
        artifacts_root=args.artifacts_root, sla_s=args.sla,
        delta_publish=not args.no_delta, full_every=args.full_every)
    obs = obs_lib.from_config(build_cfg)
    registry = None
    if not args.no_serve:
        from explicit_hybrid_mpc_tpu_torch.serve.registry import (
            ControllerRegistry)

        registry = ControllerRegistry(obs=obs)
    # Seed under the controller the revisions actually arrive for --
    # a bare value would land on the literal name "default" and a
    # --controller di run would silently cold-build generation 0.
    prior = {args.controller: args.prior} if args.prior else None
    svc = RebuildService(source, build_cfg, cfg=lc_cfg,
                         registry=registry, prior=prior, obs=obs)
    if not args.source:
        # Drift mode paces itself on liveness: revision k+1 is
        # emitted once generation k is live (or failed), so
        # `--revisions K` predictably yields K generations instead of
        # the daemon coalescing a faster-than-rebuild walk down to a
        # couple (coalescing still governs FileRevisionSource storms
        # -- that source reflects an EXTERNAL clock).
        source.gate = (lambda: len(svc.generations) + svc.n_failures
                       >= source.n_emitted)
    svc.start()
    import time

    try:
        if args.duration is not None:
            deadline = time.time() + args.duration
            while time.time() < deadline:
                time.sleep(min(0.2, args.duration))
                if svc.worker_error is not None:
                    break
        else:
            # Run the source dry, then drain the queue.  File mode
            # without --duration drains whatever the file holds now.
            t_end = time.time() + 3600.0
            while time.time() < t_end and svc.worker_error is None:
                if source.exhausted() and svc.wait_idle(timeout=30.0):
                    break
                time.sleep(0.2)
    finally:
        svc.close()
    summary = svc.summary()
    summary["controller"] = args.controller
    print(json.dumps(summary))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump({"summary": summary,
                       "generations": svc.generations}, f, indent=2)
    if svc.worker_error is not None:
        print(f"serve-rebuild: worker crashed: {svc.worker_error}",
              file=sys.stderr)
        return 2
    return 1 if summary["failures"] else 0
