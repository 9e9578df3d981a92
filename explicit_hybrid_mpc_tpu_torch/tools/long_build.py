"""Checkpointed campaign: one partition build carried across sessions
to a region target, a time budget or a drained frontier.

    python -m explicit_hybrid_mpc_tpu_torch.tools.long_build --out run/lb.json
    LONG_PROBLEM=double_integrator \\
        LONG_PROBLEM_ARGS='{"N":3,"theta_box":1.5}' \\
        LONG_EPS=0.2 LONG_CKPT_EVERY=4 \\
        python -m explicit_hybrid_mpc_tpu_torch.tools.long_build \\
        --backend cpu --out /tmp/lb/long_build.json

The JAX package's scripts/long_build.py, with its LONG_* knobs and JSON
keys, on the port, on the card unless ``--backend cpu``:

- a checkpoint every LONG_CKPT_EVERY steps (frontier.save_checkpoint,
  rotated with a .prev generation); restarted with the same LONG_CKPT
  it resumes (frontier.load_checkpoint, the newest intact generation),
  refusing a checkpoint built with another problem, eps_a, eps_r,
  precision or boundary depth;
- a progress row at every checkpoint in the JSON, so a killed campaign
  still says how far it got;
- stop reasons ``target_regions`` (LONG_TARGET_REGIONS), ``budget``
  (LONG_BUDGET_S of build wall in this session) and ``drained``;
- a pause, 30 s at a time, while a fresh capture-active sentinel exists
  (``--sentinel``; one whose mtime stopped for 600 s is an orphan);
- a health monitor over every checkpoint's metrics snapshot that, on a
  critical verdict, opens the auto-profile capture
  (FrontierEngine.trigger_auto_profile, torch.profiler), runs its steps,
  then checkpoints and halts (``health_halt``);
- the recompile guard (LONG_RECOMPILE_GUARD), a durable build SLO
  tracker (LONG_SLO), GC pauses and capture-pause overshoots as host
  forensics;
- at the end, the leaf table and the descent tables exported next to
  the JSON, and the online µs a query at final scale through the
  descent (timed with the device synchronized), then through the
  sharded server.

Pruning follows the problem's prune_hint on the CPU only.  Knobs:
LONG_EPS (5e-4), LONG_EPS_R (0), LONG_TARGET_REGIONS (1.05e6; 0 = to
drain), LONG_BUDGET_S (21000), LONG_PROBLEM (inverted_pendulum),
LONG_PROBLEM_ARGS (JSON), LONG_OUT, LONG_CKPT (default next to the
JSON), LONG_CKPT_EVERY (1000), LONG_BATCH (1024), LONG_MAX_DEPTH (64),
LONG_BOUNDARY_DEPTH, LONG_PRECISION (default capture.default_precision),
LONG_STORE_Z, LONG_PIPELINE_DEPTH, LONG_SPECULATE, LONG_DEDUP_WINDOW,
LONG_RECORDER, LONG_HEALTH, LONG_HEALTH_RULES (JSON),
LONG_RECOMPILE_GUARD (warn; 0/off, raise), LONG_AUTO_PROFILE,
LONG_OBS_PER_PROCESS, LONG_OBS (jsonl), LONG_SLO, LONG_SLO_GOAL,
LONG_EXPORT_DIR (default next to the JSON), LONG_SHARDS (8), and the
BENCH_* schedule knobs.  The JSON goes to ``--out``, else LONG_OUT,
else a fresh temp dir.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from explicit_hybrid_mpc_tpu_torch.tools.capture import (
    SENTINEL, choose_device, default_precision, log, out_path,
    schedule_kwargs, sentinel_active, sync)

#: Seconds a capture window is waited out at a time.
PAUSE_S = 30.0


def write_out(path: str, result: dict) -> None:
    with open(path, "w") as f:
        json.dump(result, f, indent=2)


def _rc_guard_mode(env: str) -> str:
    """LONG_RECOMPILE_GUARD -> cfg.recompile_guard ('0'/'1' mean
    off/warn, like the other LONG_ switches)."""
    return {"0": "off", "1": "warn"}.get(env, env)


def run(result: dict, out: str, dev, sentinel: str = SENTINEL) -> None:
    from explicit_hybrid_mpc_tpu_torch import obs as obs_lib
    from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
    from explicit_hybrid_mpc_tpu_torch.oracle.oracle import Oracle
    from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
        FrontierEngine, load_checkpoint)
    from explicit_hybrid_mpc_tpu_torch.problems.registry import make
    from explicit_hybrid_mpc_tpu_torch.utils.logging import RunLog

    out_dir = os.path.dirname(out) or "."
    eps_a = float(os.environ.get("LONG_EPS", "5e-4"))
    eps_r = float(os.environ.get("LONG_EPS_R", "0"))
    target = float(os.environ.get("LONG_TARGET_REGIONS", "1.05e6"))
    budget = float(os.environ.get("LONG_BUDGET_S", "21000"))
    problem_name = os.environ.get("LONG_PROBLEM", "inverted_pendulum")
    problem_args = json.loads(os.environ.get("LONG_PROBLEM_ARGS", "{}"))
    ckpt = os.environ.get("LONG_CKPT",
                          os.path.join(out_dir, "long_build.ckpt.pkl"))
    ckpt_every = int(os.environ.get("LONG_CKPT_EVERY", "1000"))
    batch = int(os.environ.get("LONG_BATCH", "1024"))
    max_depth = int(os.environ.get("LONG_MAX_DEPTH", "64"))
    bd_env = os.environ.get("LONG_BOUNDARY_DEPTH")
    boundary_depth = int(bd_env) if bd_env else None
    on_card = dev.type == "cuda"

    problem = make(problem_name, **problem_args)
    # After make(): the problem's cpu_precision_hint must reach the
    # campaign.
    precision = os.environ.get("LONG_PRECISION",
                               default_precision(on_card, problem))
    result.update(problem=problem_name, problem_args=problem_args,
                  eps_a=eps_a, eps_r=eps_r, precision=precision,
                  target_regions=target, budget_s=budget,
                  boundary_depth=boundary_depth,
                  checkpoint_every=ckpt_every, progress=[])
    sched_kw = schedule_kwargs(result)
    recorder_on = os.environ.get("LONG_RECORDER", "1") != "0"
    cfg = PartitionConfig(
        problem=problem_name,
        problem_args=tuple(sorted(problem_args.items())),
        eps_a=eps_a, eps_r=eps_r, backend=dev.type,
        batch_simplices=batch, max_steps=10_000_000, max_depth=max_depth,
        semi_explicit_boundary_depth=boundary_depth,
        precision=precision,
        # LONG_STORE_Z=0 drops the per-leaf primal matrices (the largest
        # leaf payload at scale); they feed offline soundness sampling.
        store_vertex_z=os.environ.get("LONG_STORE_Z", "1") != "0",
        # The build pipeline's knobs leave the tree as it is, so a
        # campaign may resume under other settings.
        **({"pipeline_depth": int(os.environ["LONG_PIPELINE_DEPTH"])}
           if os.environ.get("LONG_PIPELINE_DEPTH") else {}),
        speculate=os.environ.get("LONG_SPECULATE", "1") != "0",
        **({"dedup_window": int(os.environ["LONG_DEDUP_WINDOW"])}
           if os.environ.get("LONG_DEDUP_WINDOW") else {}),
        # A non-None recorder_dir implies the recorder, so it stays
        # None when LONG_RECORDER=0.
        obs_recorder=recorder_on,
        recorder_dir=os.path.join(out_dir, "repro") if recorder_on
        else None,
        recompile_guard=_rc_guard_mode(
            os.environ.get("LONG_RECOMPILE_GUARD", "warn")),
        auto_profile=os.environ.get("LONG_AUTO_PROFILE", "1") != "0",
        obs_per_process=os.environ.get("LONG_OBS_PER_PROCESS",
                                       "0") != "0",
        log_path=out.replace(".json", ".log.jsonl"))
    okw = dict(backend=dev.type, precision=precision, **sched_kw)
    # The problem's own pruning hint, on the CPU only.
    if not on_card and getattr(problem, "prune_hint", False):
        from explicit_hybrid_mpc_tpu_torch.oracle.prune import PrunedOracle

        oracle = PrunedOracle(problem, **okw)
        result["prune_rows"] = True
    else:
        oracle = Oracle(problem, **okw)
        result["prune_rows"] = False
    base_wall = 0.0
    # A crash between rotation and the write leaves only .prev.
    resuming = os.path.exists(ckpt) or os.path.exists(ckpt + ".prev")
    if resuming:
        # The cumulative wall of the earlier sessions, from their JSON,
        # so regions/s and the log's `t` stay cumulative.
        try:
            with open(out) as f:
                prev = json.load(f)
            rows = prev.get("progress", [])
            base_wall = float(rows[-1]["wall_s"]) if rows else float(
                prev.get("stats", {}).get("wall_s", 0.0))
            result["progress"] = rows
        except (OSError, ValueError, KeyError):
            pass
        result["resumed_base_wall_s"] = round(base_wall, 1)
    obs_mode = os.environ.get("LONG_OBS", "jsonl")
    obs_path = (out.replace(".json", ".obs.jsonl")
                if obs_mode != "off" else None)
    result["obs_path"] = obs_path
    with RunLog(cfg.log_path, echo=False, base_t=base_wall) as runlog, \
            obs_lib.Obs(obs_mode, path=obs_path, base_t=base_wall,
                        per_process=cfg.obs_per_process) as build_obs:
        if resuming:
            log(f"resuming from {ckpt}")
            snap = load_checkpoint(ckpt)
            # A checkpoint certified under other settings must not be
            # continued silently.
            sc = snap["cfg"]
            for fld in ("problem", "problem_args", "eps_a", "eps_r",
                        "precision", "semi_explicit_boundary_depth"):
                snap_v = getattr(sc, fld, None)
                cfg_v = getattr(cfg, fld, None)
                if snap_v != cfg_v:
                    raise SystemExit(
                        f"checkpoint {ckpt} was built with "
                        f"{fld}={snap_v!r} but this run requests "
                        f"{cfg_v!r}; move the checkpoint aside or match "
                        "the knobs")
            eng = FrontierEngine.resume(snap, problem, oracle, log=runlog,
                                        cfg=cfg, obs=build_obs)
            result["resumed_from_step"] = eng.steps
        else:
            eng = FrontierEngine(problem, oracle, cfg, log=runlog,
                                 obs=build_obs)

        t0 = time.time()
        paused_s = 0.0

        def wall() -> float:
            return base_wall + time.time() - t0 - paused_s

        health_mon = None
        if os.environ.get("LONG_HEALTH", "1") != "0":
            from explicit_hybrid_mpc_tpu_torch.obs.health import (
                HealthMonitor)

            health_mon = HealthMonitor(
                json.loads(os.environ.get("LONG_HEALTH_RULES", "{}")),
                sink=(build_obs.sink if build_obs.enabled else None))

        gc_rec = None
        host_trace = None
        slo = None
        if build_obs.enabled:
            from explicit_hybrid_mpc_tpu_torch.obs.reqtrace import (
                GcPauseRecorder, ReqTrace)

            gc_rec = GcPauseRecorder(build_obs).start()
            host_trace = ReqTrace("on", obs=build_obs)
            if os.environ.get("LONG_SLO", "1") != "0":
                from explicit_hybrid_mpc_tpu_torch.obs.slo import (
                    SloTracker, build_slo_specs)

                slo = SloTracker(
                    build_slo_specs(float(os.environ.get(
                        "LONG_SLO_GOAL", "0.999"))),
                    obs=build_obs,
                    state_dir=os.path.dirname(ckpt) or ".",
                    identity="long_build")

        last_ckpt_step = eng.steps
        last_dev_failures = eng.n_device_failures
        while eng.frontier:
            regions = eng.tree.n_regions()
            if target > 0 and regions >= target:
                result["stop_reason"] = "target_regions"
                break
            if wall() - base_wall > budget:
                result["stop_reason"] = "budget"
                break
            in_pause = False
            while sentinel_active(sentinel):
                if not in_pause:
                    log("capture window active: pausing build")
                    in_pause = True
                ts = time.monotonic()
                time.sleep(PAUSE_S)
                if host_trace is not None:
                    host_trace.note_stall(max(
                        0, int((time.monotonic() - ts - PAUSE_S) * 1e9)))
                paused_s += PAUSE_S
            if in_pause:
                log("capture window over: resuming build")
            eng.step()
            if eng.steps - last_ckpt_step >= ckpt_every:
                last_ckpt_step = eng.steps
                tck = time.time()
                eng.save_checkpoint(ckpt)
                stats = eng.stats_dict(wall())
                row = {k: stats[k] for k in
                       ("regions", "tree_nodes", "steps", "frontier_left",
                        "oracle_solves", "cache_peak_vertices",
                        "cache_peak_mb", "regions_per_s", "uncertified")}
                row["ckpt_write_s"] = round(time.time() - tck, 1)
                row["wall_s"] = round(wall(), 1)
                result["progress"].append(row)
                result["paused_for_captures_s"] = round(paused_s, 1)
                write_out(out, result)
                snap_rec = build_obs.flush_metrics()  # None when off
                if slo is not None and snap_rec is not None:
                    slo.tick(snap_rec)
                if health_mon is not None:
                    new_ev = []
                    if snap_rec is not None:
                        new_ev += health_mon.feed(snap_rec)
                    new_ev += health_mon.feed({"kind": "event",
                                               "name": "build.step",
                                               "t": wall(),
                                               "regions": row["regions"]})
                    for _ in range(eng.n_device_failures
                                   - last_dev_failures):
                        new_ev += health_mon.feed(
                            {"kind": "event",
                             "name": "build.device_failure"})
                    last_dev_failures = eng.n_device_failures
                    for ev in new_ev:
                        log(f"health: [{ev['severity']}] {ev['name']}: "
                            f"{ev['msg']}")
                    if health_mon.worst == "critical":
                        # The evidence before the halt: a bounded
                        # profiler window over the sick build's next
                        # steps, summarized next to the recorder's
                        # bundles.
                        extra = eng.trigger_auto_profile(
                            "health_halt:" + ",".join(sorted(
                                {e["name"]
                                 for e in health_mon.events
                                 if e.get("severity") == "critical"})))
                        for _ in range(extra):
                            if not eng.frontier:
                                break
                            eng.step()
                        result["stop_reason"] = "health_halt"
                        result["health"] = health_mon.summary()
                        log("HEALTH CRITICAL: checkpoint-and-halt "
                            "(see result['health'])")
                        break
                log(f"ckpt @ step {eng.steps}: {row['regions']} regions, "
                    f"{row['frontier_left']} open, "
                    f"{row['regions_per_s']:.0f} r/s, "
                    f"cache peak {row['cache_peak_mb']} MB, "
                    f"ckpt write {row['ckpt_write_s']}s")
        else:
            result["stop_reason"] = "drained"
        eng.save_checkpoint(ckpt)

        total_wall = wall()
        stats = eng.stats_dict(total_wall)
        result["stats"] = stats
        result["paused_for_captures_s"] = round(paused_s, 1)
        if slo is not None:
            slo.tick(build_obs.metrics.snapshot())
            result["slo"] = slo.evaluate()
            slo.flush()
        if gc_rec is not None:
            gc_rec.stop()
            result["gc_collections"] = len(gc_rec.pauses)
            result["gc_pause_total_s"] = round(gc_rec.total_pause_s(), 3)
        write_out(out, result)
        build_obs.event("build.done", **stats)
        log(f"build stopped ({result['stop_reason']}): "
            f"{stats['regions']} regions in {total_wall:.0f}s")

        # -- online path at final scale ----------------------------------
        import resource

        from explicit_hybrid_mpc_tpu_torch.online import (descent, evaluator,
                                                          export, sharded)

        # Streamed memmap export next to the live tree: O(chunk) more
        # memory, not a second in-RAM table.
        exp_dir = os.environ.get("LONG_EXPORT_DIR",
                                 os.path.join(out_dir, "leaf_table"))
        rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        t = time.time()
        with build_obs.span("export.leaves"):
            export.write_leaf_table(eng.tree, exp_dir)
        result["export_leaves_s"] = round(time.time() - t, 2)
        result["export_rss_delta_mb"] = round(
            (resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - rss0)
            / 1024, 1)
        table = export.load_leaf_table(exp_dir)
        t = time.time()
        dt = descent.export_descent(eng.tree, eng.roots, table,
                                    stage=False, obs=build_obs)
        descent.save_descent(dt, os.path.join(exp_dir, "descent.npz"))
        result["export_descent_s"] = round(time.time() - t, 2)
        result["split_hyperplanes"] = eng.tree.split_hyperplanes_available()
        dt_dev = descent.stage_table(dt, device=dev)
        staged = evaluator.stage(table, device=dev, obs=build_obs)
        rng = np.random.default_rng(3)
        B = 4096
        qs_np = rng.uniform(problem.theta_lb, problem.theta_ub,
                            size=(B, problem.n_theta))
        import torch

        qs = torch.as_tensor(qs_np, dtype=torch.float64, device=dev)
        descent.evaluate_descent(dt_dev, staged, qs)
        sync(dev)
        reps = 5
        t = time.time()
        for _ in range(reps):
            descent.evaluate_descent(dt_dev, staged, qs)
        sync(dev)
        result["online_us_per_query"] = round(
            (time.time() - t) / (reps * B) * 1e6, 3)
        result["online_leaves"] = int(table.n_leaves)
        result["online_path"] = "descent"
        # The sharded server at the same scale (compacted per-shard
        # tables, analytic Kuhn root routing over the problem's box);
        # an extra figure, never fatal.
        try:
            from explicit_hybrid_mpc_tpu_torch.partition import geometry

            router = geometry.kuhn_root_locator(
                problem.theta_lb, problem.theta_ub,
                getattr(problem, "root_splits", None))
            srv = sharded.shard_descent(
                dt, table,
                n_shards=int(os.environ.get("LONG_SHARDS", "8")),
                devices=None if on_card else [dev],
                router=router, obs=build_obs)
            srv.evaluate(qs_np)
            t = time.time()
            for _ in range(reps):
                srv.evaluate(qs_np)
            result["online_us_per_query_sharded"] = round(
                (time.time() - t) / (reps * B) * 1e6, 3)
            result["online_shards"] = srv.n_shards
        except Exception as e:
            log(f"sharded online figure skipped: {e!r}")
        write_out(out, result)
        log(f"online: {result['online_us_per_query']} us/q "
            f"(sharded {result.get('online_us_per_query_sharded')}) over "
            f"{table.n_leaves} leaves "
            f"(export {result['export_descent_s']}s)")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m explicit_hybrid_mpc_tpu_torch.tools.long_build",
        description=__doc__.splitlines()[0])
    ap.add_argument("--backend", choices=("cuda", "cpu"), default=None,
                    help="'cuda' (the default, else BENCH_PLATFORM; "
                         "refuses to start without a card) or 'cpu'")
    ap.add_argument("--out", default=None,
                    help="the JSON's path (else LONG_OUT, else a temp "
                         "dir); the checkpoint, logs and tables go beside "
                         "it")
    ap.add_argument("--sentinel", default=SENTINEL,
                    help="the capture-active file the build pauses on")
    args = ap.parse_args(argv)
    result: dict = {"capture": "long_build", "platform": None}
    # The campaign is the pausee of the sentinel protocol, not a capture.
    dev = choose_device(result, args.backend, hold_capture_sentinel=False)
    out = out_path(args.out, "LONG_OUT", "long_build.json", "long_build")
    try:
        run(result, out, dev, args.sentinel)
    except BaseException as e:
        result["error"] = repr(e)
        import traceback

        traceback.print_exc(file=sys.stderr)
        write_out(out, result)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
