"""The port's bench: offline partition-build throughput (regions/s) and
the figures beside it, one JSON line a run.

    python -m explicit_hybrid_mpc_tpu_torch.tools.bench
    python -m explicit_hybrid_mpc_tpu_torch.tools.bench --rebuild
    python -m explicit_hybrid_mpc_tpu_torch.tools.bench --drift-walk
    python -m explicit_hybrid_mpc_tpu_torch.tools.bench --multichip
    BENCH_PLATFORM=cpu BENCH_PROBLEM=double_integrator BENCH_EPS=0.2 \\
        python -m explicit_hybrid_mpc_tpu_torch.tools.bench

The JAX package's bench.py, its four modes, knobs and keys, on the port:

- default (``run``): the flagship build's regions/s after a warm-up,
  ``vs_baseline`` (the serial oracle's measured seconds a QP times the
  QPs the batched build issued, over the batched wall) and
  ``vs_baseline_bnb`` (best-first branch and bound, oracle/bnb.py), the
  online µs a query over 8,192 queries -- K2 (online/locate.py) on the
  card, the descent on the CPU -- and the synthetic large-L tree's
  export and flat / sharded µs a query (``large_l_metrics``);
- ``--rebuild``: a prior build, the equal-eps cold build and the warm
  rebuild from the prior (partition/rebuild.py), then a plant nudge;
- ``--drift-walk``: a drift walk through the rebuild service
  (lifecycle/), staleness p50 / p99 and delta bytes;
- ``--multichip``: a single-process build against two sharded builds
  (parallel/launch.py), with and without ``--async-certify``; the trees
  must be canonically equal and the point solves sum exactly.

Where it runs: the card (``cuda``) unless ``--backend cpu`` or
``BENCH_PLATFORM=cpu``; without a card it refuses to start
(tools/capture.choose_device), and ``BENCH_PLATFORM=tpu`` is refused.
Every BENCH_* knob of bench.py keeps its name and default; precision
defaults to capture.default_precision ('f64' on the card).

Prints exactly one JSON line on stdout, as bench.py does: partial fields
plus ``error`` if something fails.  Unlike bench.py, a failure on the card
(and a kernel error, a ``NoCpuFallback`` or a CUDA error anywhere) is
never skipped as an extra: it goes into ``error`` and the exit code is 1
even when ``value`` was produced.  On the CPU an extra's other failures
are skipped, as in bench.py.
``BENCH_OUT`` writes a copy (never under the JAX package's artifacts/);
a run that produced its headline appends its row to the port's history
(tools/bench_history.py, ``BENCH_HISTORY``; the empty string disables).
Every result carries ``"package": "explicit_hybrid_mpc_tpu_torch"``, by
which tools/bench_gate.py tells it from a JAX capture.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

from explicit_hybrid_mpc_tpu_torch.tools import bench_history
from explicit_hybrid_mpc_tpu_torch.tools.capture import (
    SENTINEL, card_fault, choose_device, default_precision, log, out_path,
    schedule_kwargs, sync, warm_oracle)

T_START = time.time()

#: Queries of the online and large-L figures (bench.py:835, :1220), and
#: the timed repetitions of each.
ONLINE_QUERIES = 8192
ONLINE_REPS = 10


def deadline() -> float:
    """Absolute soft deadline for the whole run (epoch seconds)."""
    return T_START + float(os.environ.get("BENCH_DEADLINE", "1500"))


def fatal(e: BaseException, on_card: bool) -> bool:
    """Whether a failure is the row's error and a non-zero exit rather than
    a skipped extra: any failure on the card, a card fault anywhere."""
    return on_card or card_fault(e)


def measure_serial_latencies(serial, problem, with_simplex: bool = True
                             ) -> tuple[float, float]:
    """(seconds a point QP, seconds a joint simplex QP) measured on a
    backend='serial' oracle (bench.py's, the same points and simplices):
    the serial-wall estimate behind vs_baseline."""
    from explicit_hybrid_mpc_tpu_torch.partition import geometry

    rng = np.random.default_rng(0)
    pts = rng.uniform(problem.theta_lb, problem.theta_ub,
                      size=(8, problem.n_theta))
    serial.solve_vertices(pts[:2])
    t0 = time.perf_counter()
    serial.solve_vertices(pts)
    per_point = ((time.perf_counter() - t0) / len(pts)
                 / problem.canonical.n_delta)
    per_simplex = 0.0
    if with_simplex:
        span = problem.theta_ub - problem.theta_lb
        V0 = np.vstack([problem.theta_lb,
                        problem.theta_lb + 0.1 * np.diag(span)])
        M8 = np.tile(geometry.barycentric_matrix(V0)[None], (8, 1, 1))
        d8 = np.zeros(8, dtype=np.int64)
        serial.solve_simplex_min(M8, d8)
        before = serial.n_simplex_solves
        t0 = time.perf_counter()
        for _ in range(4):
            serial.solve_simplex_min(M8, d8)
        issued = max(1, serial.n_simplex_solves - before)
        per_simplex = (time.perf_counter() - t0) / issued
    return per_point, per_simplex


def _kernel_tile_us(metrics: dict) -> float | None:
    """p50 of ``oracle.ipm_kernel_tile_s`` in µs (the Oracle's blocking
    wall a QP on the kernel route, host work included; not K1's own time:
    oracle/ipm_leg.py), or None when the kernel never ran."""
    row = (metrics or {}).get("histograms", {}).get(
        "oracle.ipm_kernel_tile_s")
    if not row or not row.get("p50"):
        return None
    return round(row["p50"] * 1e6, 1)


def _cert_margin_p01(build_obs) -> float | None:
    """p01 of the per-leaf certificate-margin histogram
    (build.cert_margin), or None when no leaf certified / obs was off."""
    if build_obs is None or not build_obs.enabled:
        return None
    from explicit_hybrid_mpc_tpu_torch.obs.metrics import quantile

    h = build_obs.metrics.snapshot()["histograms"].get("build.cert_margin")
    if not h or not h.get("count"):
        return None
    q = quantile(h, 0.01)
    return round(q, 8) if q is not None else None


def _knobs(on_card: bool) -> tuple[int, float, int, int]:
    """(max_steps, time_budget, batch, points_cap): bench.py's
    accelerator defaults on the card, its CPU ones on the CPU."""
    return (int(os.environ.get("BENCH_MAX_STEPS",
                               "5000" if on_card else "2000")),
            float(os.environ.get("BENCH_TIME_BUDGET",
                                 "600" if on_card else "240")),
            int(os.environ.get("BENCH_BATCH", "512" if on_card else "256")),
            int(os.environ.get("BENCH_POINTS_CAP",
                               "2048" if on_card else "256")))


def _problem_name() -> str:
    from explicit_hybrid_mpc_tpu_torch.problems.registry import names

    default = ("inverted_pendulum" if "inverted_pendulum" in names()
               else "double_integrator")
    return os.environ.get("BENCH_PROBLEM") or default


def timed_us(dev, fn, n: int, reps: int = ONLINE_REPS):
    """(µs a query of fn() over `n` queries, the last call's output): one
    warm call, then `reps` calls, the device synchronized before the
    clock stops."""
    fn()
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    sync(dev)
    return (time.perf_counter() - t0) / (reps * n) * 1e6, out


def _warm(oracle, problem, problem_name: str, dev, batch: int,
          reserve: float) -> None:
    """bench.py's warm-up: every bucket launched once, then a tiny build
    for the simplex-query shapes; the oracle's counters zeroed."""
    from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
    from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
        build_partition)

    warm_oracle(oracle, problem, stop_after=deadline() - reserve)
    log("warmup build (simplex-query programs)...")
    build_partition(problem, PartitionConfig(
        problem=problem_name, eps_a=1.0, backend=dev.type,
        batch_simplices=batch, max_steps=50, time_budget_s=120.0),
        oracle=oracle)
    oracle.reset_stats()


def run(result: dict, dev, monitor=None) -> None:
    """The default mode; fills `result` as it goes, so a late failure
    still ships every field gathered so far."""
    if monitor is not None:
        monitor.start()
    on_card = dev.type == "cuda"

    import torch

    from explicit_hybrid_mpc_tpu_torch import obs as obs_lib
    from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
    from explicit_hybrid_mpc_tpu_torch.oracle.oracle import Oracle
    from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
        build_partition)
    from explicit_hybrid_mpc_tpu_torch.problems.registry import make

    problem_name = _problem_name()
    problem = make(problem_name)
    precision = os.environ.get("BENCH_PRECISION",
                               default_precision(on_card, problem))
    eps_a = float(os.environ.get("BENCH_EPS", "1e-2"))
    max_steps, time_budget, batch, points_cap = _knobs(on_card)
    result["metric"] = (f"offline regions/sec ({problem_name}, "
                        f"eps_a={eps_a}, {result['platform']}, {precision} "
                        "precision)")

    sched_kw = schedule_kwargs(result)
    # BENCH_PRUNE=0/1; unset: the problem's prune_hint on the CPU, off on
    # the card (bench.py:606-622).
    prune = os.environ.get("BENCH_PRUNE")
    prune_on = ((prune == "1") if prune else
                (not on_card and getattr(problem, "prune_hint", False)))
    result["prune_rows"] = prune_on
    if prune_on:
        from explicit_hybrid_mpc_tpu_torch.oracle.prune import PrunedOracle

        oracle = PrunedOracle(problem, backend=dev.type, precision=precision,
                              points_cap=points_cap, **sched_kw)
    else:
        oracle = Oracle(problem, backend=dev.type, precision=precision,
                        points_cap=points_cap, **sched_kw)
    _warm(oracle, problem, problem_name, dev, batch, time_budget + 120.0)

    remaining = deadline() - time.time() - 90.0
    budget = max(60.0, min(time_budget, remaining))
    log(f"timed build (budget {budget:.0f}s, max_steps {max_steps})...")
    build_obs = obs_lib.Obs("jsonl")
    build_obs.gauge("oracle.ipm_phase1_iters_point").set(
        getattr(oracle, "point_p1", 0))
    build_obs.gauge("oracle.ipm_phase1_iters_simplex").set(
        getattr(oracle, "simplex_p1", 0))
    pipe_kw = {}
    if os.environ.get("BENCH_PIPELINE_DEPTH") is not None:
        pipe_kw["pipeline_depth"] = int(os.environ["BENCH_PIPELINE_DEPTH"])
    if os.environ.get("BENCH_SPECULATE") is not None:
        pipe_kw["speculate"] = os.environ["BENCH_SPECULATE"] != "0"
    if os.environ.get("BENCH_DEDUP_WINDOW") is not None:
        pipe_kw["dedup_window"] = int(os.environ["BENCH_DEDUP_WINDOW"])
    cfg = PartitionConfig(problem=problem_name, eps_a=eps_a,
                          backend=dev.type, batch_simplices=batch,
                          max_steps=max_steps, precision=precision,
                          max_depth=int(os.environ.get("BENCH_MAX_DEPTH",
                                                       "56")),
                          time_budget_s=budget, **pipe_kw)
    res = build_partition(problem, cfg, oracle=oracle, obs=build_obs)
    stats = res.stats
    n_point = oracle.n_point_solves
    n_simplex = oracle.n_simplex_solves
    log(f"build stats: {stats}")
    result["metrics"] = build_obs.metrics.summary()
    result.update(value=round(stats["regions_per_s"], 2),
                  regions=stats["regions"],
                  oracle_solves=stats["oracle_solves"],
                  point_solves=stats["point_solves"],
                  simplex_solves=stats["simplex_solves"],
                  rescue_solves=stats["rescue_solves"],
                  inherited_skips=stats["inherited_skips"],
                  masked_point_skips=stats["masked_point_skips"],
                  prefetched_steps=stats["prefetched_steps"],
                  pipeline_depth=stats["pipeline_depth"],
                  pipeline_fill_frac=stats["pipeline_fill_frac"],
                  dedup_saved=stats["dedup_saved"],
                  spec_hit_rate=stats["spec_hit_rate"],
                  spec_waste_frac=stats["spec_waste_frac"],
                  wall_s=round(stats["wall_s"], 2),
                  truncated=stats["truncated"],
                  uncertified=stats["uncertified"],
                  device_failures=stats["device_failures"],
                  quarantined_cells=stats.get("quarantined_cells", 0),
                  two_phase=getattr(oracle, "two_phase", False),
                  warm_start_tree=getattr(oracle, "warm_start", False),
                  # 'cuda' (K1) or 'torch' (its plain version); the tile
                  # figure is None off the kernel.
                  ipm_kernel=oracle.ipm_kernel,
                  ipm_kernel_tile_us=_kernel_tile_us(result["metrics"]),
                  ipm_iters_f64=oracle.n_iters_f64,
                  ipm_iters_f64_fixed=oracle.n_iters_f64_fixed,
                  ipm_iters_f32=oracle.n_iters_f32,
                  wasted_iter_frac=round(oracle.wasted_iter_frac, 4),
                  phase2_survivor_frac=round(oracle.phase2_survivor_frac,
                                             4),
                  warmstart_accept_rate=round(
                      oracle.warmstart_accept_rate, 4),
                  compiled_shapes=len(oracle.compiled_shapes))
    for seg in ("fill", "plan", "wait", "certify", "other"):
        result[f"cp_{seg}_frac"] = stats.get(f"cp_{seg}_frac")
    result["cp_checkpoint_s"] = stats.get("cp_checkpoint_s")
    result["cert_margin_p01"] = _cert_margin_p01(build_obs)

    # -- serial-oracle baseline estimate -----------------------------------
    # The serial stand-in always solves the full-row problem: with
    # prune_rows on, the ratio includes the pruning engine.  It runs on
    # the host, so its joint simplex QPs go through K1's plain version.
    serial = Oracle(problem, backend="serial", precision=precision,
                    **sched_kw)
    per_solve, per_simplex = measure_serial_latencies(
        serial, problem, with_simplex=bool(n_simplex))
    serial_wall = per_solve * n_point + per_simplex * n_simplex
    speedup = serial_wall / stats["wall_s"]
    log(f"serial: {per_solve*1e3:.2f} ms/point-solve x {n_point}, "
        f"{per_simplex*1e3:.2f} ms/simplex-solve x {n_simplex} -> est. "
        f"serial wall {serial_wall:.1f}s vs batched {stats['wall_s']:.1f}s")
    result.update(vs_baseline=round(speedup, 2),
                  serial_ms_per_solve=round(per_solve * 1e3, 3),
                  baseline_definition=(
                      "measured serial FULL-ROW per-QP latency x issued "
                      "QP counts / batched wall; the serial stand-in is "
                      "Oracle(backend='serial') on the host: its point QPs "
                      "one a call, solved in numpy on the host "
                      "(oracle/host_qp.py), its joint simplex QPs eight "
                      "to a call of the plain torch program (a lower "
                      "bound on one-at-a-time cost); not the reference's "
                      "compiled program"
                      + ("; batched side ran the pruned oracle, so the "
                         "ratio includes the pruning engine, not "
                         "batching alone" if prune_on else "")))

    # -- B&B-style serial baseline -----------------------------------------
    try:
        from explicit_hybrid_mpc_tpu_torch.oracle.bnb import SerialBnB

        bnb = SerialBnB(serial, obs=build_obs)
        K = int(os.environ.get("BENCH_BNB_POINTS", "16"))
        rngb = np.random.default_rng(7)
        pts_b = rngb.uniform(problem.theta_lb, problem.theta_ub,
                             size=(K, problem.n_theta))
        m = bnb.measure(pts_b)
        nd = problem.canonical.n_delta
        # Masked pairs were skipped device work, but the serial
        # reference still pays one B&B for such a vertex.
        n_micp = (n_point + stats["masked_point_skips"]) / max(1, nd)
        bnb_wall = m["s_per_point"] * n_micp + per_simplex * n_simplex
        result.update(
            vs_baseline_bnb=round(bnb_wall / stats["wall_s"], 2),
            bnb_ms_per_point=round(m["s_per_point"] * 1e3, 3),
            bnb_qp_per_point=round(m["qp_per_point"], 2),
            bnb_baseline_definition=(
                "best-first enumeration over the commutation family with "
                "incumbent pruning (unconstrained root bounds), one QP "
                "per call of Oracle(backend='serial') (solved in numpy on "
                "the host, oracle/host_qp.py), measured per-point x the "
                "vertex MICP queries the batched run issued + the same "
                "joint-simplex QP costs as the flat estimate"))
        log(f"bnb serial: {m['s_per_point']*1e3:.2f} ms/point "
            f"({m['qp_per_point']:.1f}/{nd} QPs after pruning) x "
            f"{n_micp:.0f} vertex MICPs -> est. wall {bnb_wall:.1f}s; "
            f"vs_baseline_bnb {bnb_wall / stats['wall_s']:.2f}")
    except Exception as e:
        if fatal(e, on_card):
            raise
        log(f"bnb baseline skipped: {e!r}")

    # -- online PWA lookup -------------------------------------------------
    # The card: K2, located as bench.py locates through the Pallas
    # kernel on the TPU.  The CPU: the O(depth) descent evaluator.
    try:
        from explicit_hybrid_mpc_tpu_torch.online import (descent, evaluator,
                                                          export, locate)

        t0 = time.perf_counter()
        table = export.export_leaves(res.tree)
        result["export_leaves_s"] = round(time.perf_counter() - t0, 3)
        rngq = np.random.default_rng(3)
        qs = torch.as_tensor(rngq.uniform(problem.theta_lb, problem.theta_ub,
                                          size=(ONLINE_QUERIES,
                                                problem.n_theta)),
                             device=dev)
        if on_card:
            lt = locate.stage(table, device=dev)
            fn = lambda: locate.locate(lt, qs)  # noqa: E731
            result["online_path"] = "locate"
        else:
            t0 = time.perf_counter()
            dt = descent.export_descent(res.tree, res.roots, table,
                                        device=dev)
            result["export_descent_s"] = round(time.perf_counter() - t0, 3)
            staged = evaluator.stage(table, device=dev)
            fn = lambda: descent.evaluate_descent(dt, staged, qs)  # noqa: E731
            result["online_path"] = "descent"
        online_us, _ = timed_us(dev, fn, ONLINE_QUERIES)
        log(f"online: {online_us:.3f} us/query over {table.n_leaves} "
            f"leaves ({result['online_path']}, incl host round-trip)")
        result["online_us_per_query"] = round(online_us, 3)
    except Exception as e:
        if fatal(e, on_card):
            raise
        log(f"online metric skipped: {e!r}")

    try:
        large_l_metrics(result, dev, obs=build_obs)
    except Exception as e:
        if fatal(e, on_card):
            raise
        log(f"large-L metric skipped: {e!r}")
    result["metrics"] = build_obs.metrics.summary()


def large_l_metrics(result: dict, dev, obs=None) -> dict | None:
    """The synthetic large-L tree (partition/synthetic.py, p! * 2**depth
    leaves over the unit box): chunked export seconds, flat-descent and
    sharded µs a query.  BENCH_LARGE_DEPTH (11; 0 disables),
    BENCH_LARGE_P (6), BENCH_SHARDS (8).  Returns what was evaluated, for
    a caller that holds it to the tree's law: {"table", "queries",
    "flat", "sharded"} (the leaf table, the host queries, the last output
    of each server), or None when the figure was not taken."""
    depth = int(os.environ.get("BENCH_LARGE_DEPTH", "11"))
    if depth <= 0:
        return None
    remaining = deadline() - time.time()
    if remaining < 120.0:
        log(f"large-L metric skipped: {remaining:.0f}s left to deadline")
        return None
    import torch

    from explicit_hybrid_mpc_tpu_torch.online import (descent, evaluator,
                                                      export, sharded)
    from explicit_hybrid_mpc_tpu_torch.partition import geometry
    from explicit_hybrid_mpc_tpu_torch.partition.synthetic import (
        build_synthetic_tree)

    p = int(os.environ.get("BENCH_LARGE_P", "6"))
    n_shards = int(os.environ.get("BENCH_SHARDS", "8"))
    t0 = time.perf_counter()
    tree, roots = build_synthetic_tree(p=p, depth=depth)
    build_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        export.write_leaf_table(tree, td)
        export_s = time.perf_counter() - t0
        table = export.load_leaf_table(td)
        t0 = time.perf_counter()
        dt = descent.export_descent(tree, roots, table, stage=False)
        descent_s = time.perf_counter() - t0
        L = table.n_leaves
        result.update(large_l_leaves=L,
                      large_l_build_s=round(build_s, 2),
                      large_l_export_s=round(export_s, 3),
                      large_l_descent_export_s=round(descent_s, 3))
        log(f"large-L: {L} leaves, chunked export {export_s:.2f}s, "
            f"descent export {descent_s:.2f}s")
        qs_np = np.random.default_rng(5).uniform(
            0.0, 1.0, size=(ONLINE_QUERIES, tree.p))
        del tree
        dt_dev = descent.stage_table(dt, device=dev)
        lt = evaluator.stage(table, device=dev)
        qs = torch.as_tensor(qs_np, device=dev)
        flat_us, out_f = timed_us(
            dev, lambda: descent.evaluate_descent(dt_dev, lt, qs),
            ONLINE_QUERIES)
        del dt_dev, lt
        # Sharded serving: analytic Kuhn root routing, compacted
        # per-shard tables, queries batched per shard (host wall with
        # the routing and the copy back).  Every card, or the CPU.
        router = geometry.kuhn_root_locator(np.zeros(p), np.ones(p))
        srv = sharded.shard_descent(
            dt, table, n_shards=n_shards, router=router, obs=obs,
            devices=None if dev.type == "cuda" else [dev])
        srv.evaluate(qs_np)
        t0 = time.perf_counter()
        for _ in range(ONLINE_REPS):
            out_s = srv.evaluate(qs_np)
        shard_us = (time.perf_counter() - t0) / (ONLINE_REPS
                                                 * ONLINE_QUERIES) * 1e6
        result.update(large_l_flat_us_per_query=round(flat_us, 3),
                      large_l_sharded_us_per_query=round(shard_us, 3),
                      large_l_shards=n_shards)
        log(f"large-L online over {L} leaves: flat {flat_us:.3f} "
            f"us/query, sharded({n_shards}) {shard_us:.3f} us/query")
        del srv
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"table": table, "queries": qs_np, "flat": out_f,
            "sharded": out_s}


def run_rebuild(result: dict, dev, monitor=None) -> None:
    """``--rebuild``: a prior cold build at BENCH_EPS, the equal-eps cold
    build at eps * BENCH_REBUILD_EPS_SCALE (0.9), and the warm rebuild
    of the prior at that eps: ``rebuild_reuse_frac``, ``rebuild_speedup``
    (equal-eps cold wall / rebuild wall), ``recert_solves``.
    BENCH_REBUILD_NUDGE="key=value" (default a=2.02 on the pendulum, "off"
    disables) also rebuilds the prior against a nudged plant."""
    if monitor is not None:
        monitor.start()
    on_card = dev.type == "cuda"

    from explicit_hybrid_mpc_tpu_torch import obs as obs_lib
    from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
    from explicit_hybrid_mpc_tpu_torch.oracle.oracle import Oracle
    from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
        build_partition)
    from explicit_hybrid_mpc_tpu_torch.partition.rebuild import warm_rebuild
    from explicit_hybrid_mpc_tpu_torch.problems.registry import make

    problem_name = _problem_name()
    problem = make(problem_name)
    precision = os.environ.get("BENCH_PRECISION",
                               default_precision(on_card, problem))
    eps = float(os.environ.get("BENCH_EPS", "1e-2"))
    eps2 = eps * float(os.environ.get("BENCH_REBUILD_EPS_SCALE", "0.9"))
    max_steps, time_budget, batch, points_cap = _knobs(on_card)
    result["metric"] = (
        f"warm-rebuild reuse/speedup ({problem_name}, eps {eps:g} -> "
        f"{eps2:g}, {result['platform']}, {precision} precision)")

    sched_kw = schedule_kwargs(result)
    oracle = Oracle(problem, backend=dev.type, precision=precision,
                    points_cap=points_cap, **sched_kw)
    _warm(oracle, problem, problem_name, dev, batch,
          3 * time_budget + 120.0)
    max_depth = int(os.environ.get("BENCH_MAX_DEPTH", "56"))

    def _cfg(e: float) -> PartitionConfig:
        remaining = deadline() - time.time() - 60.0
        return PartitionConfig(
            problem=problem_name, eps_a=e, backend=dev.type,
            batch_simplices=batch, max_steps=max_steps,
            precision=precision, max_depth=max_depth,
            time_budget_s=max(60.0, min(time_budget, remaining)))

    log(f"prior cold build (eps {eps:g})...")
    res_a = build_partition(problem, _cfg(eps), oracle=oracle)
    result.update(rebuild_prior_regions=res_a.stats["regions"],
                  rebuild_prior_wall_s=round(res_a.stats["wall_s"], 2))
    log(f"prior: {res_a.stats['regions']} regions in "
        f"{res_a.stats['wall_s']:.1f}s")

    log(f"equal-eps cold reference (eps {eps2:g})...")
    oracle.reset_stats()
    res_b = build_partition(problem, _cfg(eps2), oracle=oracle)
    cold_wall = res_b.stats["wall_s"]
    result.update(rebuild_cold_wall_s=round(cold_wall, 2),
                  rebuild_cold_regions=res_b.stats["regions"],
                  rebuild_cold_uncertified=res_b.stats["uncertified"])
    log(f"cold reference: {res_b.stats['regions']} regions in "
        f"{cold_wall:.1f}s")

    log(f"warm rebuild (eps {eps:g} -> {eps2:g})...")
    build_obs = obs_lib.Obs("jsonl")
    oracle.reset_stats()
    res_c = warm_rebuild(problem, _cfg(eps2), res_a.tree, oracle=oracle,
                         obs=build_obs)
    st = res_c.stats
    speedup = cold_wall / max(st["rebuild_wall_s"], 1e-9)
    result["metrics"] = build_obs.metrics.summary()
    result.update(
        rebuild_reuse_frac=st["rebuild_reuse_frac"],
        rebuild_speedup=round(speedup, 2),
        recert_solves=st["recert_solves"],
        subdivision_solves=st["subdivision_solves"],
        rebuild_invalidated=st["rebuild_leaves_invalidated"],
        rebuild_wall_s=st["rebuild_wall_s"],
        sweep_wall_s=st["sweep_wall_s"],
        regions=st["regions"],
        uncertified=st["uncertified"],
        truncated=(st["truncated"] or res_b.stats["truncated"]
                   or res_a.stats["truncated"]),
        device_failures=st["device_failures"],
        quarantined_cells=st.get("quarantined_cells", 0),
        warm_start_tree=getattr(oracle, "warm_start", False),
        ipm_kernel=oracle.ipm_kernel)
    log(f"rebuild: reuse {st['rebuild_reuse_frac']:.3f}, "
        f"{st['recert_solves']} recert + {st['subdivision_solves']} "
        f"subdivision solves, wall {st['rebuild_wall_s']:.1f}s -> "
        f"speedup {speedup:.2f}x vs equal-eps cold")

    nudge = os.environ.get("BENCH_REBUILD_NUDGE")
    if nudge is None and problem_name == "inverted_pendulum":
        nudge = "a=2.02"
    if nudge and nudge != "off" and "=" in nudge:
        try:
            k, v = nudge.split("=", 1)
            problem2 = make(problem_name, **{k: json.loads(v)})
            oracle2 = Oracle(problem2, backend=dev.type,
                             precision=precision, points_cap=points_cap,
                             **sched_kw)
            res_n = warm_rebuild(problem2, _cfg(eps), res_a.tree,
                                 oracle=oracle2)
            result.update(
                rebuild_nudge=nudge,
                rebuild_nudge_reuse_frac=res_n.stats["rebuild_reuse_frac"],
                rebuild_nudge_wall_s=res_n.stats["rebuild_wall_s"],
                rebuild_nudge_uncertified=res_n.stats["uncertified"])
            log(f"nudge ({nudge}): reuse "
                f"{res_n.stats['rebuild_reuse_frac']:.3f} in "
                f"{res_n.stats['rebuild_wall_s']:.1f}s")
        except Exception as e:
            if fatal(e, on_card):
                raise
            log(f"nudge rebuild skipped: {e!r}")


def run_drift_walk(result: dict, dev, monitor=None) -> None:
    """``--drift-walk``: one nominal cold build (also the warm-up), seeded
    into a live RebuildService with an in-process registry, then a
    BENCH_DRIFT_K-step (20) combined eps / plant drift walk through it:
    each revision warm-rebuilt on the previous generation, published as a
    delta and hot-swapped.  ``staleness_p50_s`` / ``staleness_p99_s``,
    ``delta_bytes_frac``, the reuse and ledger trajectories.  Default
    problem: the pendulum at a small tier-1 box, its pole strength ``a``
    walked.  Env: BENCH_DRIFT_K / _EPS / _FRAC / _EPS_FRAC / _ARG,
    BENCH_PROBLEM, BENCH_BATCH."""
    if monitor is not None:
        monitor.start()
    on_card = dev.type == "cuda"

    from explicit_hybrid_mpc_tpu_torch import obs as obs_lib
    from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
    from explicit_hybrid_mpc_tpu_torch.lifecycle import (DriftSource,
                                                         LifecycleConfig,
                                                         RebuildService)
    from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
        build_partition)
    from explicit_hybrid_mpc_tpu_torch.problems.registry import make
    from explicit_hybrid_mpc_tpu_torch.serve.registry import (
        ControllerRegistry)

    K = int(os.environ.get("BENCH_DRIFT_K", "20"))
    eps = float(os.environ.get("BENCH_DRIFT_EPS", "0.6"))
    drift_frac = float(os.environ.get("BENCH_DRIFT_FRAC", "0.03"))
    eps_frac = float(os.environ.get("BENCH_DRIFT_EPS_FRAC", "0.05"))
    batch = int(os.environ.get("BENCH_BATCH", "256" if on_card else "64"))
    problem_name = _problem_name()
    if problem_name == "inverted_pendulum":
        problem_args = (("N", 2), ("theta_box", (0.25, 0.6)))
        default_arg = "a"
    else:
        problem_args = ()
        default_arg = "u_max"
    drift_arg = os.environ.get("BENCH_DRIFT_ARG", default_arg)
    result["metric"] = (
        f"lifecycle drift-walk staleness/delta ({problem_name}, K={K}, "
        f"{drift_arg} walk {drift_frac:g} + eps walk {eps_frac:g}, "
        f"{result['platform']})")

    problem = make(problem_name, **dict(problem_args))
    cfg = PartitionConfig(problem=problem_name, problem_args=problem_args,
                          eps_a=eps, backend=dev.type, batch_simplices=batch)
    log(f"nominal cold build (eps {eps:g}, also the warm-up)...")
    t0 = time.time()
    prior = build_partition(problem, cfg)
    log(f"nominal: {prior.stats['regions']} regions, "
        f"{len(prior.tree.excl_events)} ledger events, "
        f"{time.time() - t0:.1f}s")
    result.update(drift_prior_regions=prior.stats["regions"],
                  drift_prior_excl_events=len(prior.tree.excl_events))

    obs = obs_lib.Obs("jsonl")
    registry = ControllerRegistry(obs=obs)
    wd = tempfile.mkdtemp(prefix="bench_drift.")
    source = DriftSource(
        problem_name, problem_args=problem_args, controller="drift",
        eps_a=eps, drift_arg=drift_arg, drift_frac=drift_frac,
        eps_frac=eps_frac, n_revisions=K, probe_T=10, seed=11)
    svc = RebuildService(
        source, cfg, cfg=LifecycleConfig(artifacts_root=wd, sla_s=0.0),
        registry=registry, prior={"drift": prior}, obs=obs)
    source.gate = (lambda: len(svc.generations) + svc.n_failures
                   >= source.n_emitted)
    log(f"drift walk: {K} revisions through the live daemon...")
    budget = deadline() - time.time() - 60.0
    with svc:
        done = svc.wait_idle(timeout=max(60.0, budget),
                             target_generations=K)
    summary = svc.summary()
    if not done:
        result["drift_truncated"] = True
        log(f"drift walk truncated at {summary['generations']}/{K} "
            f"generations (budget {budget:.0f}s)")
    if svc.worker_error is not None:
        if card_fault(svc.worker_error):
            raise svc.worker_error
        raise RuntimeError(f"drift worker crashed: {svc.worker_error}")
    if summary["failures"]:
        raise RuntimeError(
            f"{summary['failures']} rebuild failure(s) in the walk")
    if not summary["generations"]:
        raise RuntimeError("drift walk produced no generations")
    obs.close()
    shutil.rmtree(wd, ignore_errors=True)

    excl = summary["excl_events"]
    result.update(
        staleness_p99_s=summary["staleness_p99_s"],
        staleness_p50_s=summary["staleness_p50_s"],
        delta_bytes_frac=summary["delta_bytes_frac"],
        drift_generations=summary["generations"],
        reuse_fracs=summary["reuse_fracs"],
        reuse_decay=summary["reuse_decay"],
        excl_events_trajectory=excl,
        sla_misses=0,
        revisions_superseded=0,
        delta_publishes=summary["delta_publishes"],
        full_publishes=summary["full_publishes"],
        regions=svc.generations[-1].get("regions"),
        # The chained ledger stays within a small multiple of the
        # nominal build's (dead events pruned a rebuild).
        ledger_bounded=bool(
            max(excl) <= 2 * max(len(prior.tree.excl_events), 1) + 64)
        if excl else None,
        metrics=obs.metrics.snapshot() if obs.enabled else None,
    )
    log(f"drift walk: {summary['generations']} generations, staleness "
        f"p50/p99 {summary['staleness_p50_s']}/"
        f"{summary['staleness_p99_s']}s, delta bytes frac "
        f"{summary['delta_bytes_frac']}, reuse decay "
        f"{summary['reuse_decay'][:3]}..{summary['reuse_decay'][-1:]}"
        f", ledger {excl[0] if excl else '-'} -> "
        f"{excl[-1] if excl else '-'}")


def visible_cards() -> list[str]:
    """The CUDA device ids this process may hand to its children, in
    order: CUDA_VISIBLE_DEVICES's entries, else 0..device_count-1."""
    vis = os.environ.get("CUDA_VISIBLE_DEVICES")
    if vis is not None:
        return [c.strip() for c in vis.split(",") if c.strip()]
    import torch

    return [str(i) for i in range(torch.cuda.device_count())]


def run_multichip(result: dict, dev,
                  entry: list[str] | None = None) -> None:
    """``--multichip``: the flagship DI fixture built (1) in one process
    (``--no-speculate``, the exact-parity configuration), (2) as
    BENCH_MULTICHIP_PROCESSES (2) shards through parallel/launch.py, (3)
    the same with ``--async-certify``; every build a process of `entry`
    (default ``python -m explicit_hybrid_mpc_tpu_torch.main``).  On the
    card shard k takes card k % the cards there are (its
    CUDA_VISIBLE_DEVICES); ``n_devices`` counts the distinct devices the
    builds ran on (cards, or 1 on the CPU: the JAX harness counts a
    virtual device a process).

    ``multichip_scaling_frac`` = single-process build wall / sharded build
    wall.  Parity is enforced: each sharded tree must equal the
    reference canonically and its summed point solves must match exactly,
    else the row carries an error.  Where each process has a card of its
    own, bench.py's overhead bound holds the sharded wall to 1.15 x the
    single-process wall x n_proc / min(n_proc, host cores).  Where the
    processes share a device (one card, or the host's CPU) they
    time-slice it: the row says so in host_note, the ratio is an overhead
    figure and not a scaling one, and the bound is not applied
    (``multichip_overhead_ok`` null)."""
    from explicit_hybrid_mpc_tpu_torch.obs import clock
    from explicit_hybrid_mpc_tpu_torch.parallel import launch
    from explicit_hybrid_mpc_tpu_torch.partition.shard import (
        compare_trees_canonical)
    from explicit_hybrid_mpc_tpu_torch.partition.tree import Tree

    on_card = dev.type == "cuda"
    n_proc = int(os.environ.get("BENCH_MULTICHIP_PROCESSES", "2"))
    if int(os.environ.get("BENCH_MULTICHIP_DEVICES", "1")) != 1:
        raise ValueError("BENCH_MULTICHIP_DEVICES: a process of the port "
                         "builds on one device")
    eps = float(os.environ.get("BENCH_MULTICHIP_EPS", "0.2"))
    batch = int(os.environ.get("BENCH_BATCH", "64"))
    timeout = float(os.environ.get("BENCH_MULTICHIP_TIMEOUT", "600"))
    cards = visible_cards() if on_card else []
    n_dev = min(n_proc, len(cards)) if on_card else 1
    shared = n_dev < n_proc
    # The monitor stays off: the shard processes are the workload, and
    # both builds run under the same load (themselves).
    result["host_note"] = ("contention monitor off: shard subprocesses "
                           "are the workload")
    if shared:
        result["host_note"] += (
            f"; {n_proc} processes share "
            + (f"{n_dev} card(s)" if on_card else "the host's CPU")
            + ", so multichip_scaling_frac is an overhead figure, not a "
            "scaling one, and the overhead bound is not applied")
    where = f"{n_dev} card(s)" if on_card else "cpu"
    result["metric"] = (
        f"multichip sharded-frontier scaling (double_integrator eps "
        f"{eps:g}, {n_proc} proc, {where})")
    result.update(n_processes=n_proc, n_devices=n_dev)
    os.environ.setdefault(clock.RUN_ID_ENV, result["run_id"])
    wd = tempfile.mkdtemp(prefix="bench_multichip.")
    result["workdir"] = wd
    entry = list(entry or launch.MAIN)

    def argv(prefix: str, extra: list | None = None) -> list:
        return (["-e", "double_integrator", "-a", str(eps),
                 "--backend", dev.type, "--batch", str(batch),
                 "--problem-arg", "N=3", "--problem-arg", "theta_box=1.5",
                 "--no-speculate", "--obs", "jsonl", "-o", prefix]
                + (extra or []))

    def card_of(rank: int) -> dict:
        return ({"CUDA_VISIBLE_DEVICES": cards[rank % len(cards)]}
                if on_card else {})

    def single(prefix: str) -> dict:
        env = {k: v for k, v in os.environ.items()
               if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                            "MASTER_ADDR", "MASTER_PORT")}
        env["PYTHONPATH"] = launch.ROOT + os.pathsep + env.get(
            "PYTHONPATH", "")
        env.update(card_of(0))
        rc = subprocess.call(entry + argv(prefix), env=env, timeout=timeout)
        if rc != 0:
            raise RuntimeError(f"reference build exited rc={rc}")
        with open(prefix + ".stats.json") as f:
            return json.load(f)

    def sharded(prefix: str, extra: list) -> dict:
        r = launch.launch_sharded(
            argv(prefix, extra), n_processes=n_proc, timeout_s=timeout,
            env_extra_per_shard={i: card_of(i) for i in range(n_proc)},
            entry=entry, cwd=launch.ROOT)
        if r["rc"] != 0 or r["hung"]:
            raise RuntimeError(
                f"sharded build failed rcs={r['rcs']} "
                f"hung={r['hung']}: "
                + (r["stderr"][-1][-500:] if r["stderr"] else ""))
        with open(prefix + ".stats.json") as f:
            return json.load(f)

    log(f"multichip: single-process reference (eps {eps:g})...")
    ref = single(os.path.join(wd, "ref"))
    log(f"multichip: reference {ref['regions']} regions in "
        f"{ref['wall_s']:.1f}s")
    log(f"multichip: {n_proc}-process sharded (sync certify)...")
    sync_st = sharded(os.path.join(wd, "sync"), [])
    log(f"multichip: {n_proc}-process sharded (async certify)...")
    asy = sharded(os.path.join(wd, "async"), ["--async-certify"])

    ref_tree = Tree.load(os.path.join(wd, "ref.tree.pkl"))
    for name, st in (("sync", sync_st), ("async", asy)):
        diffs = compare_trees_canonical(
            ref_tree, Tree.load(os.path.join(wd, f"{name}.tree.pkl")))
        if diffs:
            raise RuntimeError(
                f"multichip {name} tree diverged: " + "; ".join(diffs))
        if st["point_solves"] != ref["point_solves"]:
            raise RuntimeError(
                f"multichip {name} summed point_solves "
                f"{st['point_solves']} != reference "
                f"{ref['point_solves']} (duplicate cross-shard work)")
        if st.get("shard_fallback_cells"):
            raise RuntimeError(
                f"multichip {name}: {st['shard_fallback_cells']} "
                "remote cells hit the local-fallback timeout")

    def _cp(st: dict, key: str):
        vals = [s.get(key) for s in st.get("per_shard", [])
                if s.get(key) is not None]
        return round(sum(vals) / len(vals), 4) if vals else None

    scaling = ref["wall_s"] / max(asy["wall_s"], 1e-9)
    result.update(
        regions=ref["regions"],
        multichip_scaling_frac=round(scaling, 4),
        singleproc_wall_s=round(ref["wall_s"], 2),
        multichip_wall_s=round(asy["wall_s"], 2),
        multichip_wall_sync_s=round(sync_st["wall_s"], 2),
        shard_regions_per_s=[
            round(s["regions"] / max(s["wall_s"], 1e-9), 1)
            for s in asy.get("per_shard", [])],
        cp_wait_frac_sync=_cp(sync_st, "cp_wait_frac"),
        cp_wait_frac_async=_cp(asy, "cp_wait_frac"),
        cp_overlap_s=round(sum(
            s.get("cp_overlap_s") or 0.0
            for s in asy.get("per_shard", [])), 3),
        async_certify=True)
    cores = os.cpu_count() or 1
    par = min(n_proc, max(1, cores))
    bound = 1.15 * ref["wall_s"] * n_proc / par
    result["host_cores"] = cores
    overhead_ok = asy["wall_s"] <= bound
    result["multichip_overhead_ok"] = None if shared else bool(overhead_ok)
    if not shared and not overhead_ok:
        result["error"] = (
            f"sharded wall {asy['wall_s']:.1f}s exceeds the overhead "
            f"bound {bound:.1f}s (1.15 x single-process "
            f"{ref['wall_s']:.1f}s x {n_proc}/{par} parallelism)")
    log(f"multichip: scaling_frac {scaling:.3f} "
        f"(ref {ref['wall_s']:.1f}s vs sharded {asy['wall_s']:.1f}s), "
        f"cp_wait sync {result['cp_wait_frac_sync']} -> async "
        f"{result['cp_wait_frac_async']}, overlap "
        f"{result['cp_overlap_s']}s")


def main(argv: list[str] | None = None,
         entry: list[str] | None = None) -> int:
    """The bench's command line; `entry` is the command the multichip
    mode runs its builds with (a caller that counts their launches
    passes its own)."""
    ap = argparse.ArgumentParser(
        prog="python -m explicit_hybrid_mpc_tpu_torch.tools.bench",
        description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--rebuild", action="store_true",
                      help="the warm-rebuild mode (also BENCH_REBUILD=1)")
    mode.add_argument("--drift-walk", action="store_true",
                      help="the drift-walk mode (also BENCH_DRIFT=1)")
    mode.add_argument("--multichip", action="store_true",
                      help="the sharded-build mode (also BENCH_MULTICHIP=1)")
    ap.add_argument("--backend", choices=("cuda", "cpu"), default=None,
                    help="'cuda' (the default, else BENCH_PLATFORM; "
                         "refuses to start without a card) or 'cpu'")
    ap.add_argument("--sentinel", default=SENTINEL,
                    help="the capture-active file held while this runs")
    args = ap.parse_args(argv)
    rebuild_mode = args.rebuild or os.environ.get("BENCH_REBUILD") == "1"
    multichip_mode = (args.multichip
                      or os.environ.get("BENCH_MULTICHIP") == "1")
    drift_mode = args.drift_walk or os.environ.get("BENCH_DRIFT") == "1"
    if rebuild_mode:
        result: dict = {"metric": "warm-rebuild reuse/speedup",
                        "rebuild_reuse_frac": None,
                        "rebuild_speedup": None}
    elif multichip_mode:
        result = {"metric": "multichip sharded-frontier scaling",
                  "multichip_scaling_frac": None}
    elif drift_mode:
        result = {"metric": "lifecycle drift-walk staleness/delta",
                  "staleness_p99_s": None, "delta_bytes_frac": None}
    else:
        result = {"metric": "offline regions/sec", "value": None,
                  "unit": "regions/s", "vs_baseline": None}
    # Refusals come before the run: no card, a TPU asked for, a copy
    # under artifacts/, the JAX package's history file.
    dev = choose_device(result, args.backend, sentinel=args.sentinel)
    bench_out = (out_path(None, "BENCH_OUT", "bench.json", "bench")
                 if os.environ.get("BENCH_OUT") else None)
    try:
        hist_path = bench_history.history_path()
    except ValueError as e:
        raise SystemExit(f"bench: {e}")

    from explicit_hybrid_mpc_tpu_torch.obs import clock
    from explicit_hybrid_mpc_tpu_torch.obs.host import ContentionMonitor
    from explicit_hybrid_mpc_tpu_torch.obs.sink import SCHEMA_VERSION

    monitor = ContentionMonitor()
    result[bench_history.PACKAGE_KEY] = bench_history.PACKAGE
    result["run_id"] = clock.run_id()
    result["obs_schema_version"] = SCHEMA_VERSION
    fault = False
    try:
        if rebuild_mode:
            run_rebuild(result, dev, monitor)
        elif multichip_mode:
            run_multichip(result, dev, entry=entry)
        elif drift_mode:
            run_drift_walk(result, dev, monitor)
        else:
            run(result, dev, monitor)
    except BaseException as e:
        result["error"] = repr(e)
        fault = fatal(e, dev.type == "cuda")
        traceback.print_exc(file=sys.stderr)
        if not isinstance(e, Exception):
            raise  # an interrupt or exit: the row still prints below
    finally:
        host = monitor.summary()
        # Not measured (no sample: a procfs that counts no CPU time, or
        # the monitor left off) is null, never uncontended.
        host.setdefault("contended", None)
        result["host"] = host
        if host["contended"]:
            result["metric"] = (
                result.get("metric", "") +
                f" [CONTENDED: competing processes used "
                f"{100 * host['competing_cpu_frac_mean']:.0f}% of CPU]")
            log(f"WARNING: contended capture -- competing CPU share "
                f"mean {host['competing_cpu_frac_mean']:.1%}, "
                f"max {host.get('competing_cpu_frac_max', 0):.1%}")
        print(json.dumps(result), flush=True)
        if bench_out:
            with open(bench_out, "w") as f:
                json.dump(result, f, indent=2)
        produced = (result.get("value") is not None
                    or result.get("rebuild_speedup") is not None
                    or result.get("multichip_scaling_frac") is not None
                    or result.get("staleness_p99_s") is not None)
        if produced and hist_path is not None:
            try:
                bench_history.append_history(
                    result, source=(bench_out or f"bench_{int(T_START)}"),
                    path=hist_path,
                    mtime=(round(os.path.getmtime(bench_out), 3)
                           if bench_out else round(T_START, 3)))
            except OSError as e:
                log(f"bench history append failed: {e!r}")
    return 0 if produced and not fault else 1


if __name__ == "__main__":
    raise SystemExit(main())
