"""Drift smoke: the rebuild service under live load.

    python -m explicit_hybrid_mpc_tpu_torch.tools.drift_smoke
    python -m explicit_hybrid_mpc_tpu_torch.tools.drift_smoke \\
        --backend cpu --eps 0.5

Drives the tier-1 double-integrator build (N=3, theta_box=1.5, eps 0.2)
through the lifecycle loop end to end: a 3-revision simulated drift walk
feeds a live ``RebuildService`` (lifecycle/service.py: a cold generation
0, then delta-published warm generations) while a ``RequestScheduler``
serves concurrent queries across every hot swap, with demand telemetry,
request tracing and SLO tracking on.  Rebuilds and serving run on the
CUDA device unless ``--backend cpu`` is given.  Prints one verdict JSON
on standard output and exits non-zero unless:

- every revision produced a live generation (0 rebuild failures, 0
  delta fallbacks, at least one delta publish);
- the load saw 0 dropped requests and 0 torn results: every served
  result is bitwise the evaluation of its theta on a fresh load of the
  artifact directory its version names;
- the staleness p99 (revision observed -> live) is under the budget;
- a committed demand snapshot exists for the controller, loads strictly
  (sha-verified) and holds at least one hot leaf;
- the ``serve.ctl.di.phase.*_us`` histograms exist and their means sum
  to the traced request wall within 2%;
- the serve-side SloTracker discovered the controller's specs and the
  daemon reports its own SLO summary.

The verdict also carries the staleness and request p50/p99.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import threading
import time

import numpy as np

from explicit_hybrid_mpc_tpu_torch import device as device_lib

PROBLEM_ARGS = (("N", 3), ("theta_box", 1.5))
#: The serve-side SLO windows, scaled to the sub-second tick (one ring
#: slot an interval across the longest window), and a generous p99
#: target: the audit checks the wiring, not a latency bar.
SLO_WINDOWS = ((5.0, 60.0), (120.0, 600.0))
SLO_TEMPLATE = {"p99_target_us": 250_000.0, "goal": 0.999}


def run_smoke(wd: str, eps: float = 0.2, batch: int = 64,
              revisions: int = 3, staleness_budget: float = 120.0,
              timeout: float = 900.0, backend: str = "cuda") -> dict:
    """The whole smoke in `wd`; the verdict, with "failures"."""
    import torch

    from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
    from explicit_hybrid_mpc_tpu_torch.lifecycle import (DriftSource,
                                                         LifecycleConfig,
                                                         RebuildService)
    from explicit_hybrid_mpc_tpu_torch.obs import Obs
    from explicit_hybrid_mpc_tpu_torch.obs.demand import (DemandHub,
                                                          load_demand)
    from explicit_hybrid_mpc_tpu_torch.obs.reqtrace import ReqTrace
    from explicit_hybrid_mpc_tpu_torch.obs.slo import SloTracker
    from explicit_hybrid_mpc_tpu_torch.serve.registry import (
        ControllerRegistry)
    from explicit_hybrid_mpc_tpu_torch.serve.scheduler import (
        RequestScheduler)

    failures: list[str] = []
    devices = ([torch.device("cpu")] if backend == "cpu" else None)
    obs = Obs("jsonl", path=os.path.join(wd, "lifecycle.obs.jsonl"))
    registry = ControllerRegistry(obs=obs)
    build_cfg = PartitionConfig(
        problem="double_integrator", problem_args=PROBLEM_ARGS,
        eps_a=eps, backend=backend, batch_simplices=batch)
    source = DriftSource(
        "double_integrator", problem_args=PROBLEM_ARGS, controller="di",
        eps_a=eps, drift_arg="u_max", drift_frac=0.05,
        n_revisions=revisions, probe_T=10, seed=7)
    # Demand telemetry rides the whole walk: the scheduler feeds the
    # hub, snapshots land under demand_dir, and the daemon takes the
    # committed snapshot as a warm-rebuild priority hint.
    demand_dir = os.path.join(wd, "demand")
    hub = DemandHub(mode="on", max_leaves=1024, snapshot_every_s=0.5,
                    snapshot_dir=demand_dir, obs=obs)
    svc = RebuildService(
        source, build_cfg,
        cfg=LifecycleConfig(artifacts_root=os.path.join(wd, "art"),
                            sla_s=staleness_budget, demand_dir=demand_dir,
                            slo=True, slo_dir=os.path.join(wd, "slo")),
        registry=registry, obs=obs)
    source.gate = (lambda: len(svc.generations) + svc.n_failures
                   >= source.n_emitted)
    print(f"drift_smoke: {revisions}-revision walk on {backend}, eps "
          f"{eps} ...", file=sys.stderr)
    t0 = time.perf_counter()
    svc.start()
    if not svc.wait_idle(timeout=timeout, target_generations=1):
        svc.close()
        obs.close()
        return {"failures": ["generation 0 never went live "
                             f"({svc.worker_error or 'timeout'})"]}

    trace = ReqTrace(mode="on", obs=obs)
    slo = SloTracker(interval_s=0.5, windows=SLO_WINDOWS, obs=obs,
                     serve_template=SLO_TEMPLATE)
    sched = RequestScheduler(registry, "di", max_batch=32,
                             max_wait_us=2000.0, obs=obs, demand=hub,
                             trace=trace, slo=slo)
    served: list = []
    dropped: list[str] = []
    stop = threading.Event()
    rng = np.random.default_rng(3)

    def load_loop() -> None:
        lb = -1.5 * 0.95 * np.ones(2)
        ub = 1.5 * 0.95 * np.ones(2)
        while not stop.is_set():
            thetas = rng.uniform(lb, ub, size=(8, 2))
            try:
                results = sched.submit_batch(thetas).result(timeout=30)
            except Exception as e:  # noqa: BLE001 -- a drop IS the verdict
                dropped.append(repr(e))
                continue
            served.extend(zip(thetas, results))
            time.sleep(0.002)

    loader = threading.Thread(target=load_loop, daemon=True)
    loader.start()
    ok = svc.wait_idle(timeout=timeout, target_generations=revisions)
    time.sleep(0.3)  # a few more batches against the final version
    stop.set()
    loader.join(30)
    if loader.is_alive():
        failures.append("the load thread did not stop within 30 s")
    sched.close()
    slo.tick(obs.metrics.snapshot())  # the tail of the last window
    hub.close()  # the final committed snapshot under demand_dir/di/
    svc.close()
    obs.close()
    summary = svc.summary()
    wall = time.perf_counter() - t0

    if not ok:
        failures.append(
            f"daemon did not complete {revisions} generations "
            f"({svc.worker_error or 'timeout'}; {len(svc.generations)} "
            f"done, {svc.n_failures} failed)")
    if summary["failures"]:
        failures.append(f"{summary['failures']} rebuild failure(s)")
    if summary["delta_publishes"] < 1:
        failures.append("no delta publish happened (every generation "
                        "fell back to full artifacts)")
    counters = obs.metrics.snapshot()["counters"]
    if counters.get("lifecycle.delta_fallbacks", 0):
        failures.append(f"{counters['lifecycle.delta_fallbacks']} delta "
                        "fallback(s) on a healthy walk")
    if dropped:
        failures.append(f"{len(dropped)} DROPPED request(s): {dropped[:3]}")
    if not served:
        failures.append("the load produced no results (the scheduler "
                        "never ran against the daemon)")
    p99 = summary.get("staleness_p99_s")
    if p99 is None or p99 > staleness_budget:
        failures.append(f"staleness p99 {p99} s over the "
                        f"{staleness_budget} s budget")

    # -- demand snapshot: committed, strict-loads, nonempty ----------------
    demand_leaves = 0
    snap_dir = os.path.join(demand_dir, "di")
    try:
        snap = load_demand(snap_dir)  # raises CorruptArtifact if torn
        demand_leaves = int(snap.leaf_ids.size)
        if demand_leaves < 1:
            failures.append("demand snapshot committed but observed zero "
                            "hot leaves under live load")
    except Exception as e:  # noqa: BLE001 -- the failure list IS the verdict
        failures.append(f"demand snapshot missing or torn under "
                        f"{snap_dir}: {e!r}")

    # -- request trace: phase histograms exist and sum to the wall ---------
    ph = {k.rsplit(".phase.", 1)[1][:-3]: h
          for k, h in obs.metrics.snapshot()["histograms"].items()
          if k.startswith("serve.ctl.di.phase.")}
    if not ph.get("wall", {}).get("count"):
        failures.append("request tracing produced no serve.ctl.di.phase.* "
                        "histograms under live load")
    else:
        wall_mean = ph["wall"]["sum"] / ph["wall"]["count"]
        phase_sum = sum(h["sum"] / h["count"] for p2, h in ph.items()
                        if p2 != "wall" and h["count"])
        if abs(phase_sum - wall_mean) > 0.02 * wall_mean:
            failures.append(
                f"trace phase means sum to {phase_sum:.1f} us against a "
                f"request wall of {wall_mean:.1f} us (> 2%): a stamp went "
                "missing across the hot swaps")

    # -- error budgets: serve specs discovered, daemon tracked -------------
    slo_eval = slo.evaluate()
    slo_comp = (min(d["compliance"] for d in slo_eval.values())
                if slo_eval else None)
    slo_burn = (max(d["burn_fast"] for d in slo_eval.values())
                if slo_eval else None)
    if not slo_eval:
        failures.append("the serve SLO tracker discovered no specs under "
                        "live load")
    lc_slo = summary.get("slo")
    if not lc_slo:
        failures.append("the lifecycle daemon reported no SLO summary")

    # -- torn swaps: every result bitwise against its version's table ------
    by_version: dict[str, list[int]] = {}
    for i, (_th, r) in enumerate(served):
        by_version.setdefault(r.version, []).append(i)
    dirs = {g["version"]: g["artifact_dir"] for g in svc.generations}
    torn = 0
    for version, idxs in sorted(by_version.items()):
        d = dirs.get(version)
        if d is None:
            failures.append(f"served version {version!r} matches no "
                            "published generation")
            continue
        ref_reg = ControllerRegistry()
        ref_reg.load_artifacts("ref", version, d, devices=devices)
        with ref_reg.lease("ref") as ver:
            ref = ver.server.evaluate(np.stack([served[i][0]
                                                for i in idxs]))
        for j, i in enumerate(idxs):
            r = served[i][1]
            if r.fallback is not None:
                continue  # degraded-mode rows re-evaluate differently
            if not (np.array_equal(r.u, np.asarray(ref.u[j]))
                    and r.leaf == int(ref.leaf[j])):
                torn += 1
    if torn:
        failures.append(f"{torn} TORN result(s): served values do not "
                        "match their claimed version's artifact")
    lat = np.asarray([r.latency_s for _th, r in served], dtype=np.float64)
    return {
        "backend": backend, "wall_s": wall, "summary": summary,
        "served": len(served), "dropped": len(dropped), "torn": torn,
        "versions_served": sorted(by_version),
        "staleness_p50_s": summary.get("staleness_p50_s"),
        "staleness_p99_s": p99,
        "request_p50_ms": (float(np.percentile(lat, 50)) * 1e3
                           if lat.size else None),
        "request_p99_ms": (float(np.percentile(lat, 99)) * 1e3
                           if lat.size else None),
        "demand_leaves": demand_leaves, "trace_phases": sorted(ph),
        "slo_compliance": slo_comp, "slo_burn_fast_max": slo_burn,
        "lifecycle_slo": lc_slo, "failures": failures,
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m explicit_hybrid_mpc_tpu_torch.tools.drift_smoke",
        description=__doc__.splitlines()[0])
    ap.add_argument("--backend", choices=("cuda", "cpu"), default="cuda",
                    help="rebuild and serving device: 'cuda' (default; "
                         "refuses to start without a card) or 'cpu'")
    ap.add_argument("--eps", type=float, default=0.2,
                    help="eps_a (default 0.2, the tier-1 build; raise for "
                         "a quicker smoke)")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--revisions", type=int, default=3)
    ap.add_argument("--staleness-budget", type=float, default=120.0,
                    metavar="S", help="staleness p99 budget (revision "
                    "observed -> live; default 120 s)")
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="whole-run hang budget")
    ap.add_argument("--workdir", default=None,
                    help="keep the artifacts here instead of a temp dir")
    ap.add_argument("--json", dest="json_out", default=None)
    args = ap.parse_args(argv)
    try:
        device_lib.resolve(args.backend)
    except RuntimeError as e:
        raise SystemExit(f"drift_smoke: {e}")
    wd = args.workdir or tempfile.mkdtemp(prefix="drift_smoke.")
    os.makedirs(wd, exist_ok=True)
    try:
        verdict = run_smoke(wd, args.eps, args.batch, args.revisions,
                            args.staleness_budget, args.timeout,
                            args.backend)
    finally:
        if not args.workdir:
            shutil.rmtree(wd, ignore_errors=True)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(verdict, f, indent=2, default=str)
    print(json.dumps(verdict, default=str))
    if verdict["failures"]:
        print("DRIFT SMOKE FAILED:\n  " + "\n  ".join(verdict["failures"]),
              file=sys.stderr)
        return 1
    print(f"DRIFT SMOKE OK on {args.backend}: "
          f"{verdict['summary']['generations']} generations "
          f"({verdict['summary']['delta_publishes']} delta), "
          f"{verdict['served']} requests, 0 dropped / 0 torn, staleness "
          f"p99 {verdict['staleness_p99_s']} s, {verdict['wall_s']:.0f} s",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
