"""`python -m explicit_hybrid_mpc_tpu_torch.main serve` -- the serving CLI.

Deploys a controller from exported artifacts (serve.registry
save_artifacts layout: leaf-table ``.npy`` files + ``descent.npz``;
the pickled Tree is never loaded) behind the micro-batching scheduler:

    python -m explicit_hybrid_mpc_tpu_torch.main serve \\
        --artifacts build/pend.artifacts --controller pend \\
        --obs jsonl --obs-path serve.obs.jsonl --selftest 4096

The descent tables live on the CUDA devices (``--backend cuda``, the
default; it raises without a GPU).  ``--backend cpu`` serves on the
CPU.  The JAX package's CLI defaults to the CPU instead: this port's
entry points run on the card unless the caller asks otherwise.

Two modes:

- ``--selftest N``: generate N queries over the controller's certified
  box (a 10% band deliberately lands outside to exercise the fallback
  path), drive them through the scheduler closed-loop, and print one
  JSON summary line (p50/p99 us, fallback counts, version) -- the
  smoke test for a deploy.
- default (no --selftest): read JSONL queries from stdin (``{"theta":
  [...]}`` or a bare list per line), write one JSONL result per line
  to stdout (u, cost, leaf, inside, version, fallback) and a summary
  to stderr at EOF.  A malformed line gets an ``{"error": ...}``
  record and the loop keeps serving.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def build_serve_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="explicit_hybrid_mpc_tpu_torch serve",
        description="online serving runtime over exported partition "
                    "artifacts, on the CUDA devices by default")
    p.add_argument("--artifacts", required=True, metavar="DIR",
                   help="artifact directory (leaf-table .npy files + "
                        "descent.npz; serve.registry.save_artifacts)")
    p.add_argument("--controller", default="default",
                   help="controller name in the registry")
    p.add_argument("--version", default="v1",
                   help="version tag recorded on results and swap "
                        "events")
    p.add_argument("--shards", type=int, default=None, metavar="N",
                   help="descent shard count (default: one per device)")
    p.add_argument("--max-batch", type=int, default=256,
                   help="micro-batch flush threshold (power of two)")
    p.add_argument("--max-wait-us", type=float, default=2000.0,
                   help="deadline budget before a partial batch "
                        "flushes")
    p.add_argument("--max-bucket", type=int, default=None,
                   help="largest evaluator padding bucket; larger "
                        "submissions split (health.oversized_batch)")
    p.add_argument("--fallback", choices=("clamp", "off"),
                   default="clamp",
                   help="degraded-mode policy for not-inside queries")
    p.add_argument("--backend", choices=("cuda", "cpu"), default="cuda",
                   help="serving device: 'cuda' (default; every CUDA "
                        "device, raises without one) or 'cpu'.  The JAX "
                        "package's CLI defaults to cpu")
    p.add_argument("--obs", choices=("off", "jsonl", "full"),
                   default="off")
    p.add_argument("--obs-path", metavar="FILE", default=None)
    p.add_argument("--demand", choices=("off", "on"), default="off",
                   help="demand telemetry (not yet ported: 'on' raises, "
                        "ROADMAP A5: obs/demand.py)")
    p.add_argument("--demand-dir", metavar="DIR", default=None,
                   help="demand snapshot root (not yet ported)")
    p.add_argument("--selftest", type=int, default=0, metavar="N",
                   help="serve N self-generated queries closed-loop, "
                        "print a JSON summary, and exit")
    return p


def _summary(sched, fallback, registry, name: str,
             latencies_s=None) -> dict:
    """Run summary; `latencies_s` = full-run per-request latencies when
    the caller tracked them (selftest), else the scheduler's rolling
    window stands in (long-lived stdin mode)."""
    lat = np.asarray(latencies_s if latencies_s is not None
                     else [v for _t, v in sched._lat_roll],
                     dtype=np.float64) * 1e6
    return {
        "controller": name,
        "version": registry.active_version(name),
        "requests": sched.n_requests,
        "batches": sched.n_batches,
        "p50_us": round(float(np.percentile(lat, 50)), 3) if lat.size
        else None,
        "p99_us": round(float(np.percentile(lat, 99)), 3) if lat.size
        else None,
        "fallback_seen": fallback.n_seen if fallback else 0,
        "fallback_oracle": fallback.n_oracle if fallback else 0,
    }


def serve_main(argv: list[str] | None = None) -> int:
    args = build_serve_parser().parse_args(argv)

    import torch

    from explicit_hybrid_mpc_tpu_torch import obs as obs_lib
    from explicit_hybrid_mpc_tpu_torch.config import ServeConfig
    from explicit_hybrid_mpc_tpu_torch.serve.fallback import FallbackPolicy
    from explicit_hybrid_mpc_tpu_torch.serve.registry import (
        ControllerRegistry, root_box)
    from explicit_hybrid_mpc_tpu_torch.serve.scheduler import (
        RequestScheduler)

    try:
        cfg = ServeConfig(
            controller=args.controller, max_batch=args.max_batch,
            max_wait_us=args.max_wait_us, max_bucket=args.max_bucket,
            n_shards=args.shards, fallback=args.fallback,
            obs=args.obs, obs_path=args.obs_path,
            demand=args.demand, demand_dir=args.demand_dir)
    except ValueError as e:
        raise SystemExit(str(e))
    if args.backend == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "serve: --backend cuda (the default) needs a CUDA device and "
            "torch.cuda.is_available() is False; pass --backend cpu to "
            "serve on the CPU")
    devices = [torch.device("cpu")] if args.backend == "cpu" else None

    o = obs_lib.Obs(cfg.obs, path=cfg.obs_path) if cfg.obs != "off" \
        else obs_lib.NOOP
    registry = ControllerRegistry(obs=o)
    ver = registry.load_artifacts(
        cfg.controller, args.version, args.artifacts,
        n_shards=cfg.n_shards, max_bucket=cfg.max_bucket, devices=devices)
    lb, ub = root_box(ver.server)  # ShardedDescent keeps host root_bary
    fallback = None
    if cfg.fallback != "off":
        fallback = FallbackPolicy(lb, ub, mode=cfg.fallback,
                                  max_oracle_frac=cfg.max_oracle_frac,
                                  obs=o)
    sched = RequestScheduler(registry, cfg.controller,
                             max_batch=cfg.max_batch,
                             max_wait_us=cfg.max_wait_us,
                             fallback=fallback, obs=o)
    try:
        if args.selftest:
            rng = np.random.default_rng(0)
            span = ub - lb
            # 10% band outside the box: the fallback path must carry
            # real traffic in the smoke test, not just the happy path.
            thetas = rng.uniform(lb - 0.1 * span, ub + 0.1 * span,
                                 size=(args.selftest, lb.size))
            results = [r for t in [sched.submit(t) for t in thetas]
                       for r in t.result(60.0)]
            n_fb = sum(1 for r in results if r.fallback is not None)
            summ = _summary(sched, fallback, registry, cfg.controller,
                            latencies_s=[r.latency_s for r in results])
            summ["selftest"] = args.selftest
            summ["fallback_served"] = n_fb
            print(json.dumps(summ))
            return 0
        for line in sys.stdin:
            if not line.strip():
                continue
            # Per-line fault isolation: one malformed query must not
            # kill a long-lived serving process -- the client gets an
            # error record on its line and the loop keeps serving.
            try:
                q = json.loads(line)
                theta = np.asarray(
                    q["theta"] if isinstance(q, dict) else q,
                    dtype=np.float64)
                (r,) = sched.submit(theta).result(60.0)
            except Exception as e:  # noqa: BLE001 -- reported, not dropped
                print(json.dumps({"error": repr(e)}), flush=True)
                continue
            print(json.dumps({
                "u": r.u.tolist(), "cost": r.cost, "leaf": r.leaf,
                "inside": r.inside, "version": r.version,
                "fallback": r.fallback}), flush=True)
        print(json.dumps(_summary(sched, fallback, registry,
                                  cfg.controller)), file=sys.stderr)
        return 0
    finally:
        sched.close()
        if o is not obs_lib.NOOP:
            o.close()
