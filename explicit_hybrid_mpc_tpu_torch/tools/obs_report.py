"""Render a run report from an obs JSONL stream; diff it against a
bench row to flag regressions.

    python -m explicit_hybrid_mpc_tpu_torch.tools.obs_report RUN.obs.jsonl \
        [--bench BENCH.json | --bench DIR] [--drift PREV.obs.jsonl] \
        [--json OUT.json] [--tol 0.10] [--strict]
    python -m explicit_hybrid_mpc_tpu_torch.tools.obs_report \
        'run.obs.*.jsonl' --fleet [--strict]

Reads the unified observability stream (obs/, the schema of the JAX
package's docs/observability.md) that a build and/or serving session of
the port wrote (``main --obs jsonl``, or an explicit ``obs.Obs`` handle)
and prints:

- build throughput: steps, regions, regions/sec, device_frac trend;
- oracle solve-time p50/p99 per QP class (point/simplex/rescue) plus
  IPM iteration volume, from the last metrics snapshot's histograms,
  and the adaptive-work rates (wasted_iter_frac, phase2_survivor_frac,
  warmstart_accept_rate, compiled-shape count) from its gauges;
- serving: per-shard query-latency p50/p99, batch sizes, routing mode
  counts, shard imbalance; the device arena's residency, hot-swap
  latency and launch amortization;
- demand telemetry (obs/demand.py): per-controller hot-leaf top-k,
  traffic top-decile share, box-exceedance dims, and sampled
  suboptimality p50/p99 + budget spent, off the serve.ctl.* demand
  gauges and the bounded demand.snapshot events; the request-phase
  decomposition (obs/reqtrace.py) and the SLO budgets (obs/slo.py);
- the faults, warm-rebuild, lifecycle and build-pipeline blocks, host
  contention, and the health events and repro bundles of the stream;
- with ``--bench``: a diff against that bench row, flagging >tol
  regressions in regions/sec and histogram p99s against the bench's
  own ``metrics`` block, plus iteration-economy regressions (lower
  wasted_iter_frac / warmstart_accept_rate than the bench recorded);
- with ``--drift PREV.obs.jsonl``: the ``oracle.compiled_shapes``
  ledger of this stream vs an earlier one -- GROWTH at comparable
  scale is a recompile regression (new program shapes minted per run;
  the static/runtime side of the same invariant lives in the port's
  analysis/ package) and is flagged like a latency regression.

The functions, keys, text and exit codes are the JAX package's
(scripts/obs_report.py) but for the default bench (and the wording of
the drift note for a stream without the gauge): a bench is read only when
``--bench`` names one (a BENCH_*.json, or a directory whose newest
BENCH_*.json is taken).  The JAX script diffs against the newest
BENCH_*.json of the repository root by default; those rows are the JAX
package's, taken on a TPU or a CPU, and a card stream diffed against
them would report made-up regressions and hide real ones.  With no
``--bench`` the report carries no bench diff and its JSON's ``"bench"``
is null.

Fleet mode: ``--fleet`` treats the stream argument as a glob /
directory / bare per-process stream name, merges every matching
stream through obs/fleet.py, and renders a per-shard table, the
exact counter rollup (counters SUM across shards' final snapshots;
histograms merge bucket-wise), the critical-path rollup, and the
straggler attribution.  Under ``--strict`` the fleet report exits
nonzero when the directory mixes stream schema versions or a stream
is missing its identity meta record -- silently folding
unattributable streams together is how a fleet number lies.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from explicit_hybrid_mpc_tpu_torch.obs.metrics import histogram_row
from explicit_hybrid_mpc_tpu_torch.obs.sink import SCHEMA_VERSION, load_jsonl

_SHARD_PREFIX = "serve.shard"


def report(records: list[dict]) -> dict:
    """Structured report dict from parsed stream records.  Tolerates
    partial streams (build-only, serve-only); keys are present only
    when their producers emitted."""
    out: dict = {"n_records": len(records)}
    meta = [r for r in records
            if r.get("kind") == "meta" and r.get("name") == "schema"]
    out["schema_version"] = meta[-1].get("version") if meta else None
    # v1 streams (pre-fleet, no identity record) read fine -- every
    # field this report consumes predates v2 -- so only a version the
    # reader does not know warns.
    if out["schema_version"] not in (None, 1, SCHEMA_VERSION):
        out["schema_warning"] = (
            f"stream schema v{out['schema_version']} != reader "
            f"v{SCHEMA_VERSION}; fields may have moved")
    ident = [r for r in records
             if r.get("kind") == "meta" and r.get("name") == "stream"]
    if ident:
        out["identity"] = {k: ident[0].get(k) for k in
                           ("run_id", "host", "pid", "process_index",
                            "process_count")}

    # -- build trajectory (per-step events) --------------------------------
    steps = [r for r in records
             if r.get("kind") == "event" and r.get("name") == "build.step"]
    if steps:
        last = steps[-1]
        dfrac = [r["device_frac"] for r in steps if "device_frac" in r]
        out["build"] = {
            "steps": last.get("step"),
            "regions": last.get("regions"),
            "frontier_left": last.get("frontier"),
            "wall_s": last["t"],
            "regions_per_s": (last.get("regions", 0)
                              / max(last["t"], 1e-9)),
            "device_frac_mean": (sum(dfrac) / len(dfrac)
                                 if dfrac else None),
        }
        # Pipeline occupancy trend off the per-step events (the
        # cumulative figures come from the gauges below).
        fills = [r["pipeline"] for r in steps if "pipeline" in r]
        if fills:
            out["build"]["pipeline_inflight_mean"] = (sum(fills)
                                                      / len(fills))
    done = [r for r in records
            if r.get("kind") == "event" and r.get("name") == "build.done"]
    if done:
        out.setdefault("build", {})["done"] = {
            k: v for k, v in done[-1].items()
            if k not in ("t", "kind", "name")}
        # Prefer the engine's own cumulative figure when present (it
        # accounts resumed-session base wall; the step-event ratio is
        # session-local).
        rps = done[-1].get("regions_per_s")
        if rps is not None:
            out["build"]["regions_per_s"] = rps
            out["build"]["regions"] = done[-1].get(
                "regions", out["build"].get("regions"))

    # -- metrics snapshot (the last one wins: snapshots are cumulative) ----
    snaps = [r for r in records if r.get("kind") == "metrics"]
    if snaps:
        snap = snaps[-1]
        out["counters"] = snap.get("counters", {})
        out["gauges"] = snap.get("gauges", {})
        hists = snap.get("histograms", {})
        out["histograms"] = {k: histogram_row(h) for k, h in hists.items()}
        oracle = {k.split(".", 1)[1]: v for k, v in out["histograms"].items()
                  if k.startswith("oracle.")}
        if oracle or any(k.startswith("oracle.") for k in out["gauges"]):
            out["oracle"] = oracle
            out["oracle"]["ipm_iters"] = out["counters"].get(
                "oracle.ipm_iters")
            out["oracle"]["ipm_iters_f64"] = out["counters"].get(
                "oracle.ipm_iters_f64")
            # Adaptive-work rates (two-phase cohort + tree warm-starts):
            # cumulative gauges the oracle refreshes every batch.
            for g in ("wasted_iter_frac", "phase2_survivor_frac",
                      "warmstart_accept_rate", "compiled_shapes"):
                if f"oracle.{g}" in out["gauges"]:
                    out["oracle"][g] = out["gauges"][f"oracle.{g}"]
        # Build-pipeline occupancy + speculation/dedup economy gauges
        # (partition/pipeline.py).  device_frac is the device-busy
        # fraction of each step; its complement is host-busy -- the
        # occupancy split the pipeline exists to overlap.
        pipe = {g: out["gauges"][f"build.{g}"]
                for g in ("pipeline_fill", "pipeline_fill_frac",
                          "dedup_saved", "spec_hit_rate",
                          "spec_waste_frac")
                if f"build.{g}" in out["gauges"]}
        if pipe:
            dfm = out.get("build", {}).get("device_frac_mean")
            if dfm is not None:
                pipe["device_busy_frac"] = dfm
                pipe["host_busy_frac"] = max(0.0, 1.0 - dfm)
            out["pipeline"] = pipe
        # Per-step critical-path attribution: run-mean
        # fraction of step wall per segment, from the cumulative
        # build.cp_* gauges; checkpoint wall rides separately (it
        # happens between steps).
        cp = {seg: out["gauges"][f"build.cp_{seg}_frac"]
              for seg in ("fill", "plan", "wait", "certify", "other")
              if f"build.cp_{seg}_frac" in out["gauges"]}
        if cp:
            if "build.cp_checkpoint_s" in out["gauges"]:
                cp["checkpoint_s"] = out["gauges"][
                    "build.cp_checkpoint_s"]
            out["critical_path"] = cp
        # Warm-rebuild reuse economy (partition/rebuild.py): counters +
        # the reuse_frac gauge, rendered and diff-flagged like the
        # pipeline gauges.
        reb = {c: out["counters"][f"rebuild.{c}"]
               for c in ("leaves_recertified", "leaves_reused",
                         "leaves_invalidated", "recert_solves")
               if f"rebuild.{c}" in out["counters"]}
        if "rebuild.reuse_frac" in out["gauges"]:
            reb["reuse_frac"] = out["gauges"]["rebuild.reuse_frac"]
        if reb:
            out["rebuild"] = reb
        # Continuous-rebuild lifecycle (lifecycle/service.py): revision
        # flow counters, rolling staleness gauges, and the reuse-decay
        # trajectory off the per-generation lifecycle.rebuilt events.
        lc = {c: out["counters"][f"lifecycle.{c}"]
              for c in ("revisions_seen", "rebuilds",
                        "revisions_superseded", "rebuild_failures",
                        "sla_misses", "publishes_delta",
                        "publishes_full", "delta_fallbacks")
              if f"lifecycle.{c}" in out["counters"]}
        for g in ("staleness_p50_s", "staleness_p99_s",
                  "last_reuse_frac", "delta_bytes_frac", "generation",
                  "excl_events"):
            if f"lifecycle.{g}" in out["gauges"]:
                lc[g] = out["gauges"][f"lifecycle.{g}"]
        if lc:
            reuse = [r.get("reuse_frac") for r in records
                     if r.get("kind") == "event"
                     and r.get("name") == "lifecycle.rebuilt"
                     and r.get("reuse_frac") is not None]
            if reuse:
                decay, cur = [], 1.0
                for v in reuse:
                    cur = min(cur, float(v))
                    decay.append(round(cur, 4))
                lc["reuse_decay"] = decay
            out["lifecycle"] = lc
        # Robustness ledger (faults/; docs/robustness.md): injected
        # faults that fired, poison cells quarantined, and the
        # degraded/lease-leak/quarantine health events -- zero on any
        # healthy run, so the block renders only when nonzero.
        flt = {}
        if out["counters"].get("faults.injected"):
            flt["injected"] = out["counters"]["faults.injected"]
        if out["counters"].get("build.quarantined_cells"):
            flt["quarantined_cells"] = \
                out["counters"]["build.quarantined_cells"]
        if flt:
            out["faults"] = flt
        shards = {}
        for k, v in out["histograms"].items():
            if k.startswith(_SHARD_PREFIX) and k.endswith(".query_s"):
                sid = k[len(_SHARD_PREFIX):].split(".", 1)[0]
                shards[sid] = v
        if shards or any(k.startswith("serve.") for k in out["gauges"]):
            out["serve"] = {
                "shards": shards,
                "imbalance": out["gauges"].get("serve.shard_imbalance"),
                "queries": out["counters"].get("serve.queries"),
                "route_analytic": out["counters"].get(
                    "serve.route_analytic_queries", 0),
                "route_brute": out["counters"].get(
                    "serve.route_brute_queries", 0),
                "query_s": out["histograms"].get("serve.query_s"),
            }
        # Device-resident multi-tenant arena (serve/arena.py +
        # ArenaScheduler): residency, hot-swap latency, and launch
        # amortization for the fused mixed-tenant serving path
        # (docs/serving.md#device-resident-arena).
        ar = {}
        for gname in ("controllers", "resident_bytes", "free_cols",
                      "launches_per_req", "mixed_batch_fill",
                      "batch_fill_frac", "p99_us", "fallback_frac"):
            if f"serve.arena.{gname}" in out["gauges"]:
                ar[gname] = out["gauges"][f"serve.arena.{gname}"]
        for cname in ("publishes", "delta_publishes", "launches"):
            if f"serve.arena.{cname}" in out["counters"]:
                ar[cname] = out["counters"][f"serve.arena.{cname}"]
        if "serve.arena.swap_us" in out["histograms"]:
            ar["swap_us"] = out["histograms"]["serve.arena.swap_us"]
        if ar:
            out["arena"] = ar
        # Demand telemetry (obs/demand.py): per-controller
        # traffic-sketch + sampled-suboptimality figures off the
        # serve.ctl.* demand gauges/counters.
        dem: dict = {}
        for key, v in out["gauges"].items():
            if key.startswith("serve.ctl.") \
                    and key.endswith(".demand_leaves"):
                ctl = key[len("serve.ctl."):-len(".demand_leaves")]
                pre = f"serve.ctl.{ctl}"
                dem[ctl] = {
                    "leaves_observed": int(v),
                    "top_decile_frac": out["gauges"].get(
                        f"{pre}.demand_top_decile_frac"),
                    "subopt_p50": out["gauges"].get(f"{pre}.subopt_p50"),
                    "subopt_p99": out["gauges"].get(f"{pre}.subopt_p99"),
                    "subopt_samples": out["counters"].get(
                        f"{pre}.subopt_samples"),
                    "rows": out["counters"].get(f"{pre}.demand_rows"),
                    "snapshots": out["counters"].get(
                        f"{pre}.demand_snapshots"),
                }
        if dem:
            out["demand"] = dem
        # Serve request tracing (obs/reqtrace.py): the
        # per-phase critical-path decomposition of request wall
        # (serve.ctl.*.phase.*_us histograms -- phases sum to wall by
        # construction) plus the queue_frac gauge the queue_dominated
        # health rule reads.
        phases: dict[str, dict] = {}
        for key, row in out["histograms"].items():
            seg = key.rsplit(".phase.", 1)
            if len(seg) != 2 or not seg[1].endswith("_us") \
                    or not seg[0].startswith("serve.ctl."):
                continue
            ctl = seg[0][len("serve.ctl."):]
            phases.setdefault(ctl, {})[seg[1][:-3]] = row
        trc: dict = {}
        for ctl, ph in phases.items():
            d: dict = {"phases": ph}
            wall = ph.get("wall")
            if wall and wall.get("mean"):
                d["fracs"] = {
                    p: round(r["mean"] / wall["mean"], 4)
                    for p, r in ph.items()
                    if p != "wall" and r.get("mean") is not None}
            qf = out["gauges"].get(f"serve.ctl.{ctl}.queue_frac")
            if qf is not None:
                d["queue_frac"] = qf
            trc[ctl] = d
        if trc:
            out["reqtrace"] = trc
        # Host-interference forensics next to the request phases: gc
        # pauses (GcPauseRecorder) + scheduler flush-loop sleep
        # overshoot (ReqTrace.note_stall).
        hostf = {h: out["histograms"][f"serve.host.{h}"]
                 for h in ("gc_pause_us", "stall_us")
                 if f"serve.host.{h}" in out["histograms"]}
        if hostf:
            out["serve_host"] = hostf
        # SLO / error-budget accounting (obs/slo.py): per-spec
        # compliance/budget/burn gauges plus lifetime good/bad unit
        # counters, published under slo.<spec>.<field>.  Field names
        # carry no dots, so rsplit cleanly peels them off dotted spec
        # names like "default.p99".
        slo: dict = {}
        for key, v in out["gauges"].items():
            if not key.startswith("slo.") or "." not in key[4:]:
                continue
            spec, field = key[4:].rsplit(".", 1)
            if field in ("goal", "compliance", "budget_remaining_frac",
                         "burn_fast", "burn_slow"):
                slo.setdefault(spec, {})[field] = v
        for key, v in out["counters"].items():
            if key.startswith("slo.") and key.endswith("_units") \
                    and "." in key[4:]:
                spec, field = key[4:].rsplit(".", 1)
                slo.setdefault(spec, {})[field] = v
        if slo:
            out["slo"] = slo

    # Exemplar digests ride the bounded serve.trace.exemplars events
    # (obs/reqtrace.py flush); the LAST event per controller wins --
    # the ring is a rolling window, so the final digest is the
    # freshest slowest-K view.
    for r in records:
        if r.get("kind") == "event" \
                and r.get("name") == "serve.trace.exemplars":
            out.setdefault("reqtrace", {}).setdefault(
                str(r.get("controller")), {})["exemplars"] = \
                r.get("slowest")

    # Hot-leaf / exceedance detail rides the demand.snapshot events,
    # not the metrics (bounded top-k, docs/observability.md "Demand
    # signals"); the LAST event per controller wins -- snapshots are
    # cumulative views of the decayed window.
    for r in records:
        if r.get("kind") == "event" and r.get("name") == "demand.snapshot":
            d = out.setdefault("demand", {}).setdefault(
                str(r.get("controller")), {})
            for k in ("hot", "exceed_dims", "leaves_observed",
                      "top_decile_frac", "subopt_p50", "subopt_p99",
                      "subopt_samples", "subopt_offered"):
                if r.get(k) is not None:
                    d[k] = r[k]

    # -- warnings: degraded-capture signals recorded in the stream ---------
    # (host.* gauges -- a report over a contended run must say so next
    # to its numbers.)
    warns: list[str] = []
    g = out.get("gauges", {})
    if g.get("host.contended"):
        warns.append(
            f"host CONTENDED: competing processes used "
            f"{100 * g.get('host.competing_cpu_frac_mean', 0):.0f}% of "
            f"CPU (max {100 * g.get('host.competing_cpu_frac_max', 0):.0f}"
            "%) -- throughput and latency figures are degraded")
    health = [r for r in records if r.get("kind") == "event"
              and str(r.get("name", "")).startswith("health.")]
    for r in health:
        warns.append(f"{r['name']} [{r.get('severity')}]: "
                     f"{r.get('msg')}")
    # Robustness events (faults/): a degraded device or a quarantined
    # batch is a warning on any capture -- the numbers were produced
    # on the fallback path.
    for r in records:
        if r.get("kind") != "event":
            continue
        name = str(r.get("name", ""))
        if name == "faults.device_degraded":
            warns.append(
                f"device DEGRADED after {r.get('failures')} failures: "
                "the build finished on the CPU fallback oracle")
        elif name == "faults.quarantine":
            warns.append(
                f"quarantined {r.get('cells')} cell(s) on "
                f"{r.get('query')}: every recovery attempt failed "
                f"({r.get('error')})")
    n_bundles = out.get("counters", {}).get("recorder.bundles")
    if n_bundles:
        warns.append(f"flight recorder dumped {n_bundles} repro "
                     "bundle(s): replay with scripts/replay_solve.py")
    if warns:
        out["warnings"] = warns
    return out


def bench_warnings(bench: dict) -> list[str]:
    """Degraded-capture signals recorded in a BENCH_*.json:
    backend-probe failures and the host contention verdict."""
    warns: list[str] = []
    err = bench.get("backend_probe_error")
    if err:
        warns.append(f"bench backend probe failed: {err}")
    if bench.get("backend_probe_failed"):
        warns.append("bench ran on the honest-CPU fallback "
                     "(device backend unreachable)")
    # backend_probe_skipped (CPU-only host: the accelerator probe came
    # back negative but the CPU-pinned probe was clean) is NOT a
    # warning: a CPU-only capture is the expected configuration there,
    # and rendering it as an error made every clean CPU run look
    # degraded.  The probe detail rides in
    # backend_probe_detail for triage.
    if bench.get("backend_init_failed"):
        warns.append("bench backend init failed after an OK probe; "
                     "fell back to CPU")
    host = bench.get("host", {})
    if host.get("contended"):
        warns.append(
            f"bench capture was CONTENDED: competing processes used "
            f"{100 * host.get('competing_cpu_frac_mean', 0):.0f}% of "
            "CPU -- its numbers are a degraded comparison base")
    return warns


def latest_bench(repo_dir: str) -> str | None:
    """The newest BENCH_*.json in `repo_dir` (by name), or None.  Only
    ``--bench DIR`` calls it: no directory is read by default."""
    paths = sorted(glob.glob(os.path.join(repo_dir, "BENCH_*.json")))
    return paths[-1] if paths else None


def diff_bench(rep: dict, bench: dict, tol: float = 0.10) -> list[str]:
    """Regression flags: this run vs a BENCH_*.json.  Directional --
    only worse-than-bench beyond `tol` is flagged (a faster run is not
    a regression)."""
    flags: list[str] = []
    bval = bench.get("value")
    rps = rep.get("build", {}).get("regions_per_s")
    if bval and rps and rps < (1 - tol) * bval:
        flags.append(
            f"regions/s regression: {rps:.1f} vs bench {bval:.1f} "
            f"({100 * (1 - rps / bval):.0f}% slower)")
    bhists = bench.get("metrics", {}).get("histograms", {})
    for name, row in rep.get("histograms", {}).items():
        brow = bhists.get(name)
        if not brow:
            continue
        bp99, p99 = brow.get("p99"), row.get("p99")
        if bp99 and p99 and p99 > (1 + tol) * bp99:
            flags.append(
                f"{name} p99 regression: {p99:.3g}s vs bench "
                f"{bp99:.3g}s ({100 * (p99 / bp99 - 1):.0f}% slower)")
    # Iteration-economy regressions are flagged like latency ones
    #: a run that saves a smaller fraction of the fixed f64
    # schedule, or whose tree warm-starts stop being accepted, is doing
    # more arithmetic per region even if wall-clock noise hides it.
    orc = rep.get("oracle", {})
    for field, label in (("wasted_iter_frac", "f64-iteration savings"),
                         ("warmstart_accept_rate",
                          "warm-start accept rate")):
        bval_f = bench.get(field)
        rval = orc.get(field)
        if bval_f and rval is not None and rval < (1 - tol) * bval_f:
            flags.append(
                f"{label} regression: {rval:.3f} vs bench {bval_f:.3f} "
                f"({100 * (1 - rval / bval_f):.0f}% lower)")
    # Pipeline-economy regressions, same directional logic: a
    # lookahead that stops filling re-serializes host and device; a
    # speculation hit-rate collapse or waste growth burns device work
    # on dropped mis-speculations.
    pipe = rep.get("pipeline", {})
    for field, label in (("pipeline_fill_frac", "pipeline fill"),
                         ("spec_hit_rate", "speculation hit rate")):
        bval_f = bench.get(field)
        rval = pipe.get(field)
        if bval_f and rval is not None and rval < (1 - tol) * bval_f:
            flags.append(
                f"{label} regression: {rval:.3f} vs bench {bval_f:.3f} "
                f"({100 * (1 - rval / bval_f):.0f}% lower)")
    # Rebuild-economy regression: a warm rebuild reusing a
    # smaller fraction of the prior tree than the bench's capture is
    # re-subdividing space the revision did not actually invalidate.
    b_reuse = bench.get("rebuild_reuse_frac")
    r_reuse = rep.get("rebuild", {}).get("reuse_frac")
    if b_reuse and r_reuse is not None and r_reuse < (1 - tol) * b_reuse:
        flags.append(
            f"rebuild reuse regression: {r_reuse:.3f} vs bench "
            f"{b_reuse:.3f} ({100 * (1 - r_reuse / b_reuse):.0f}% lower)")
    # Lifecycle staleness regression: a daemon whose
    # end-to-end staleness p99 grew past the last BENCH_drift row is
    # going live slower per revision -- flagged like a latency
    # regression (directional; faster is not a flag).  The delta byte
    # ratio gates the same way: a fatter delta re-ships tree bytes the
    # rebuild did not actually invalidate.
    lc = rep.get("lifecycle", {})
    b_stale = bench.get("staleness_p99_s")
    r_stale = lc.get("staleness_p99_s")
    if b_stale and r_stale is not None \
            and r_stale > (1 + tol) * b_stale:
        flags.append(
            f"lifecycle staleness regression: p99 {r_stale:.2f}s vs "
            f"bench {b_stale:.2f}s "
            f"({100 * (r_stale / b_stale - 1):.0f}% slower)")
    b_df = bench.get("delta_bytes_frac")
    r_df = lc.get("delta_bytes_frac")
    if b_df and r_df is not None and r_df > (1 + tol) * b_df:
        flags.append(
            f"delta-artifact size regression: {r_df:.3f} of full vs "
            f"bench {b_df:.3f}")
    b_waste = bench.get("spec_waste_frac")
    r_waste = pipe.get("spec_waste_frac")
    if r_waste is not None and b_waste is not None \
            and r_waste > b_waste + tol * max(b_waste, 0.05):
        flags.append(
            f"speculation waste regression: {r_waste:.3f} vs bench "
            f"{b_waste:.3f}")
    # Multi-tenant arena regressions, directional like the
    # rest: a slower delta hot swap holds the two-epoch window (and
    # its double residency) open longer; more launches per request
    # means mixed-tenant batching stopped amortizing dispatch, which
    # is the tentpole figure of the arena path.
    ar = rep.get("arena", {})
    b_swap = bench.get("arena_swap_us")
    r_swap = (ar.get("swap_us") or {}).get("p99")
    if b_swap and r_swap is not None and r_swap > (1 + tol) * b_swap:
        flags.append(
            f"arena swap regression: p99 {r_swap:.0f}us vs bench "
            f"{b_swap:.0f}us ({100 * (r_swap / b_swap - 1):.0f}% slower)")
    b_lpr = bench.get("batch_launches_per_req")
    r_lpr = ar.get("launches_per_req")
    if b_lpr and r_lpr is not None and r_lpr > (1 + tol) * b_lpr:
        flags.append(
            f"arena launch-amortization regression: {r_lpr:.3f} "
            f"launches/req vs bench {b_lpr:.3f}")
    # Sampled-suboptimality regression: the run's worst
    # per-controller subopt_p99 against the last serve bench's figure.
    # Bench captures legitimately read 0 (the synthetic law is exact),
    # so the comparison floors at the bench's own eps budget -- a run
    # is flagged only when it is BOTH worse than the bench and over
    # the budget the bench was gated under.
    b_sp = bench.get("subopt_p99")
    r_sps = [(ctl, d["subopt_p99"])
             for ctl, d in rep.get("demand", {}).items()
             if d.get("subopt_p99") is not None]
    if b_sp is not None and r_sps:
        floor = max((1 + tol) * b_sp, bench.get("subopt_eps") or 0.0)
        for ctl, r_sp in r_sps:
            if r_sp > floor:
                flags.append(
                    f"suboptimality regression [{ctl}]: sampled p99 "
                    f"{r_sp:.4g} vs bench {b_sp:.4g} (eps budget "
                    f"{bench.get('subopt_eps')}) -- the served answers "
                    "drifted outside the certificate")
    # Serve-phase regressions: this run's per-phase share
    # of request wall vs the last serve BENCH row's decomposition
    # (serve_bench writes phase_*_frac + serve_queue_frac).  A grown
    # queue share is the "scale replicas, not kernels" signal even at
    # flat p99; the +0.05 absolute slack keeps near-zero phases
    # (put/seal) from flagging on noise-level shifts.  Directional:
    # shrinking shares are not regressions.
    for ctl, d in sorted((rep.get("reqtrace") or {}).items()):
        fr = d.get("fracs") or {}
        for pz in ("queue", "seal", "put", "launch", "fallback",
                   "reply"):
            b_f = bench.get(f"phase_{pz}_frac")
            r_f = fr.get(pz)
            if b_f and r_f is not None and r_f > (1 + tol) * b_f \
                    and r_f > b_f + 0.05:
                flags.append(
                    f"serve phase regression [{ctl}]: {pz} "
                    f"{100 * r_f:.0f}% of request wall vs bench "
                    f"{100 * b_f:.0f}%")
        b_qf = bench.get("serve_queue_frac")
        r_qf = d.get("queue_frac")
        if b_qf and r_qf is not None and r_qf > (1 + tol) * b_qf \
                and r_qf > b_qf + 0.05:
            flags.append(
                f"queue_frac regression [{ctl}]: {r_qf:.2f} vs bench "
                f"{b_qf:.2f} -- the tail is going queue-dominated; "
                "scale replicas or raise max_batch "
                "(docs/observability.md queue_dominated runbook)")
    # SLO compliance regression, compared in BAD-fraction
    # space: 0.999 vs 0.995 is a 5x error-rate difference a relative
    # tolerance on the compliance figure itself cannot see.  The +0.005
    # absolute slack keeps tiny-volume captures (one bad unit in a
    # short run) from flagging on quantization noise.
    b_c = bench.get("slo_compliance")
    if b_c is not None and 0 < b_c <= 1:
        b_bad = 1.0 - b_c
        for spec, d in sorted((rep.get("slo") or {}).items()):
            r_c = d.get("compliance")
            if r_c is not None and (1.0 - r_c) > (1 + tol) * b_bad + 0.005:
                flags.append(
                    f"slo compliance regression [{spec}]: {r_c:.5f} vs "
                    f"bench {b_c:.5f} (bad fraction {1 - r_c:.4g} vs "
                    f"{b_bad:.4g}) -- the error budget is burning "
                    "faster than the gated capture's")
    # Serving headline: sharded us/query against the bench's large-L
    # figure, when both sides measured it.
    b_us = bench.get("large_l_sharded_us_per_query")
    q = rep.get("serve", {}).get("query_s") or {}
    if b_us and q.get("p50"):
        us = q["p50"] * 1e6
        if us > (1 + tol) * b_us:
            flags.append(
                f"sharded serving p50 regression: {us:.2f} us/q vs "
                f"bench {b_us:.2f} us/q")
    return flags


def diff_drift(rep: dict, prev: dict) -> tuple[list[str], dict]:
    """Compiled-shape drift between two streams' reports: (flags,
    summary).  Growth is directional -- a run that compiled FEWER
    shapes is not a regression; a run that compiled more minted new
    device programs for the same workload (shape churn, the recompile
    pathology tpulint's rules gate statically)."""
    cur = rep.get("gauges", {}).get("oracle.compiled_shapes")
    old = prev.get("gauges", {}).get("oracle.compiled_shapes")
    summary = {"compiled_shapes": cur, "prev_compiled_shapes": old}
    flags: list[str] = []
    if cur is None or old is None:
        summary["note"] = ("one or both streams carry no "
                           "oracle.compiled_shapes gauge (obs off, or a "
                           "stream older than the gauge)")
        return flags, summary
    if cur > old:
        flags.append(
            f"compiled-shape growth: {int(cur)} shapes vs {int(old)} in "
            f"the earlier stream (+{int(cur - old)}): the same workload "
            "minted new device programs -- a recompile regression "
            "(docs/static_analysis.md)")
    return flags, summary


def _fmt_lat(v: float | None) -> str:
    if v is None:
        return "-"
    return f"{v * 1e6:.2f}us" if v < 1e-3 else f"{v * 1e3:.2f}ms" \
        if v < 1.0 else f"{v:.2f}s"


def render_text(rep: dict, flags: list[str], bench_path: str | None) -> str:
    ln = [f"obs report: {rep['n_records']} records, schema "
          f"v{rep.get('schema_version')}"]
    b = rep.get("build")
    if b:
        ln.append(f"build: {b.get('regions')} regions in "
                  f"{b.get('wall_s', 0):.1f}s "
                  f"({b.get('regions_per_s', 0):.1f} regions/s, "
                  f"{b.get('steps')} steps, device_frac mean "
                  f"{(b.get('device_frac_mean') or 0):.2f})")
    orc = rep.get("oracle")
    if orc:
        for cls in ("point_solve_s", "simplex_solve_s", "rescue_solve_s"):
            row = orc.get(cls)
            if row:
                ln.append(f"oracle {cls.split('_')[0]}: "
                          f"{row['count']} QPs, p50 "
                          f"{_fmt_lat(row['p50'])}, p99 "
                          f"{_fmt_lat(row['p99'])}")
        if orc.get("ipm_iters"):
            it_line = f"oracle IPM iterations: {orc['ipm_iters']}"
            if orc.get("ipm_iters_f64"):
                it_line += f" ({orc['ipm_iters_f64']} f64)"
            ln.append(it_line)
        if orc.get("wasted_iter_frac") is not None:
            ln.append(
                f"adaptive work: wasted_iter_frac "
                f"{orc['wasted_iter_frac']:.3f}, phase2 survivors "
                f"{orc.get('phase2_survivor_frac', 0.0):.3f}, "
                f"warm-start accept "
                f"{orc.get('warmstart_accept_rate', 0.0):.3f}, "
                f"{int(orc.get('compiled_shapes', 0))} compiled shapes")
    pipe = rep.get("pipeline")
    if pipe:
        occ = ""
        if pipe.get("device_busy_frac") is not None:
            occ = (f", occupancy device {pipe['device_busy_frac']:.2f} /"
                   f" host {pipe['host_busy_frac']:.2f}")
        ln.append(
            f"pipeline: fill {pipe.get('pipeline_fill_frac', 0.0):.2f}"
            f", spec hit rate {pipe.get('spec_hit_rate', 0.0):.2f}"
            f", spec waste {pipe.get('spec_waste_frac', 0.0):.3f}"
            f", dedup saved {int(pipe.get('dedup_saved', 0))}" + occ)
    cp = rep.get("critical_path")
    if cp:
        segs = " / ".join(
            f"{seg} {100 * cp.get(seg, 0.0):.0f}%"
            for seg in ("fill", "plan", "wait", "certify", "other"))
        tail = (f" (ckpt {cp['checkpoint_s']:.1f}s)"
                if "checkpoint_s" in cp else "")
        ln.append(f"critical path: {segs}{tail}")
    reb = rep.get("rebuild")
    if reb:
        ln.append(
            f"rebuild: reused {int(reb.get('leaves_reused', 0))}/"
            f"{int(reb.get('leaves_reused', 0)) + int(reb.get('leaves_invalidated', 0))}"
            f" prior leaves (reuse_frac {reb.get('reuse_frac', 0.0):.3f}"
            f", {int(reb.get('recert_solves', 0))} recert solves)")
    lc = rep.get("lifecycle")
    if lc:
        decay = lc.get("reuse_decay")
        ln.append(
            f"lifecycle: {int(lc.get('revisions_seen', 0))} revisions "
            f"seen, {int(lc.get('rebuilds', 0))} rebuilt, "
            f"{int(lc.get('revisions_superseded', 0))} superseded, "
            f"staleness p50 {lc.get('staleness_p50_s', 0.0):.2f}s / "
            f"p99 {lc.get('staleness_p99_s', 0.0):.2f}s, "
            f"delta bytes frac {lc.get('delta_bytes_frac', 0.0):.3f}"
            + (f", reuse decay {' -> '.join(f'{v:.3f}' for v in decay)}"
               if decay else "")
            + (f", {int(lc['sla_misses'])} SLA MISS(ES)"
               if lc.get("sla_misses") else ""))
    flt = rep.get("faults")
    if flt:
        ln.append(
            f"faults: {int(flt.get('injected', 0))} injected, "
            f"{int(flt.get('quarantined_cells', 0))} cell(s) "
            "quarantined")
    srv = rep.get("serve")
    if srv:
        ln.append(f"serve: {srv.get('queries')} queries "
                  f"(route analytic/brute: {srv.get('route_analytic')}/"
                  f"{srv.get('route_brute')}), shard imbalance "
                  f"{(srv.get('imbalance') or 0):.2f}")
        q = srv.get("query_s")
        if q:
            ln.append(f"serve latency: p50 {_fmt_lat(q['p50'])}, "
                      f"p99 {_fmt_lat(q['p99'])} per query")
        for sid in sorted(srv.get("shards", {})):
            row = srv["shards"][sid]
            ln.append(f"  shard {sid}: {row['count']} queries, p50 "
                      f"{_fmt_lat(row['p50'])}, p99 {_fmt_lat(row['p99'])}")
    ar = rep.get("arena")
    if ar:
        ln.append(
            f"arena: {int(ar.get('controllers', 0))} controller(s) "
            f"resident ({(ar.get('resident_bytes') or 0) / 2**20:.1f} "
            f"MiB), {int(ar.get('launches', 0))} fused launch(es), "
            f"launches/req {(ar.get('launches_per_req') or 0):.3f}, "
            f"mixed fill {(ar.get('mixed_batch_fill') or 0):.2f}")
        sw = ar.get("swap_us")
        if sw:
            ln.append(
                f"arena swap: {int(sw['count'])} publish(es), p50 "
                f"{_fmt_lat(sw['p50'] / 1e6)}, p99 "
                f"{_fmt_lat(sw['p99'] / 1e6)}")
    trc = rep.get("reqtrace")
    if trc:
        for ctl in sorted(trc):
            d = trc[ctl]
            fr = d.get("fracs")
            if fr:
                segs = " / ".join(
                    f"{p} {100 * fr[p]:.0f}%"
                    for p in ("queue", "seal", "put", "launch",
                              "fallback", "reply") if p in fr)
                wall = (d.get("phases") or {}).get("wall") or {}
                tail = ""
                if wall.get("p99") is not None:
                    tail = (f" (wall p50 {_fmt_lat(wall['p50'] / 1e6)} /"
                            f" p99 {_fmt_lat(wall['p99'] / 1e6)})")
                if d.get("queue_frac") is not None:
                    tail += f", queue_frac {d['queue_frac']:.2f}"
                ln.append(f"serve critical path [{ctl}]: {segs}{tail}")
            ex = d.get("exemplars") or []
            if ex:
                e = ex[0]
                st = e.get("stamps_us") or {}
                ln.append(
                    f"  slowest [{ctl}]: {e.get('wall_us', 0):.0f}us "
                    f"(queued {st.get('seal', 0):.0f}us, launch ret "
                    f"{st.get('launch_return', 0):.0f}us, version "
                    f"{e.get('version')}, fill "
                    f"{e.get('batch_fill', 0):.2f}"
                    + (f", fallback {e['fallback']}"
                       if e.get("fallback") else "") + ")")
    sh = rep.get("serve_host")
    if sh:
        gp, stl = sh.get("gc_pause_us"), sh.get("stall_us")
        bits = []
        if gp:
            bits.append(f"gc pauses {int(gp['count'])} "
                        f"(p99 {_fmt_lat((gp['p99'] or 0) / 1e6)}, max "
                        f"{_fmt_lat((gp['max'] or 0) / 1e6)})")
        if stl:
            bits.append(f"sched stalls {int(stl['count'])} "
                        f"(p99 {_fmt_lat((stl['p99'] or 0) / 1e6)})")
        if bits:
            ln.append("serve host: " + ", ".join(bits))
    slo = rep.get("slo")
    if slo:
        for spec in sorted(slo):
            d = slo[spec]
            comp, goal = d.get("compliance"), d.get("goal")
            budget = d.get("budget_remaining_frac")
            n = int(d.get("good_units") or 0) \
                + int(d.get("bad_units") or 0)
            ln.append(
                f"slo [{spec}]: compliance "
                + (f"{comp:.5f}" if comp is not None else "-")
                + (f" (goal {goal:g})" if goal is not None else "")
                + (f", budget {100 * budget:.0f}% left"
                   if budget is not None else "")
                + f", burn fast/slow {d.get('burn_fast', 0.0):.2f}/"
                  f"{d.get('burn_slow', 0.0):.2f} over {n} unit(s)"
                + (" -- BUDGET EXHAUSTED" if budget is not None
                   and budget <= 0 else ""))
    dem = rep.get("demand")
    if dem:
        for ctl in sorted(dem):
            d = dem[ctl]
            hot = d.get("hot") or []
            hot_s = " ".join(f"{int(i)}:{h:.0f}" for i, h in hot[:5])
            tdf = d.get("top_decile_frac")
            sp50, sp99 = d.get("subopt_p50"), d.get("subopt_p99")
            sub = ("subopt p50/p99 "
                   f"{sp50:.3g}/{sp99:.3g} over "
                   f"{int(d.get('subopt_samples') or 0)} samples "
                   f"({int(d.get('subopt_offered') or 0)} offered)"
                   if sp99 is not None else "subopt not sampled")
            ln.append(
                f"demand [{ctl}]: {int(d.get('leaves_observed') or 0)} "
                "leaves observed, top-decile "
                + (f"{tdf:.2f}" if tdf is not None else "-")
                + (f", hot [{hot_s}]" if hot_s else "")
                + f", exceed dims {d.get('exceed_dims') or []}, {sub}")
    if bench_path:
        ln.append(f"bench diff vs {os.path.basename(bench_path)}: "
                  + ("OK" if not flags else f"{len(flags)} flag(s)"))
        for f in flags:
            ln.append(f"  REGRESSION: {f}")
    for w in rep.get("warnings", []):
        ln.append(f"  WARNING: {w}")
    return "\n".join(ln)


def fleet_report(streams) -> dict:
    """Fleet view over N loaded streams (obs.fleet.StreamInfo): the
    exact counter rollup, per-shard rows (each stream's own report),
    the critical-path rollup (cp segment SECONDS summed across shards,
    fractions of the summed step wall), straggler attribution, and
    the strict-mode schema/identity issues."""
    from explicit_hybrid_mpc_tpu_torch.obs import fleet as fleet_lib

    roll = fleet_lib.fleet_rollup(streams)
    shards = {}
    cp_s: dict[str, float] = {}
    for s in streams:
        shard_rep = report(s.records)
        shards[s.shard] = shard_rep
        for seg in ("fill", "plan", "wait", "certify", "other",
                    "checkpoint"):
            v = shard_rep.get("gauges", {}).get(f"build.cp_{seg}_s")
            if v is not None:
                cp_s[seg] = cp_s.get(seg, 0.0) + v
    cp = None
    step_total = sum(v for k, v in cp_s.items() if k != "checkpoint")
    if step_total > 0:
        cp = {seg: cp_s.get(seg, 0.0) / step_total
              for seg in ("fill", "plan", "wait", "certify", "other")}
        cp["checkpoint_s"] = cp_s.get("checkpoint", 0.0)
    # Sharded-frontier evidence: every stream came from a genuinely
    # multi-process run.  A supervised RESTART CHAIN also has several
    # streams, but each is a single-process session (process_count 1)
    # whose partial snapshots must NOT be summed into a "total".
    sharded = bool(streams) and all(
        ((s.identity or {}).get("process_count") or 1) > 1
        for s in streams)
    return {"n_streams": len(streams),
            "run_ids": roll["run_ids"],
            "sharded": sharded,
            "rollup": {"counters": roll["counters"],
                       "regions": roll["regions"],
                       # Sharded-frontier builds certify disjoint
                       # subtrees: the per-shard SUM is their total.
                       "regions_sum": roll.get("regions_sum"),
                       "histograms": {k: histogram_row(h) for k, h in
                                      roll["histograms"].items()}},
            # Per-shard cp fractions (obs/fleet.py rollup rows): a
            # straggling shard's own profile, invisible in the summed
            # fold above.
            "per_shard_cp": {sid: row.get("cp") or {}
                             for sid, row in
                             (roll.get("per_shard") or {}).items()},
            "critical_path": cp,
            # Fleet error budgets (obs/fleet.py slo_rollup): compliance
            # recomputed from summed unit counters, never averaged from
            # per-shard gauges.
            "slo": fleet_lib.slo_rollup(streams),
            "straggler": fleet_lib.straggler_report(streams),
            "issues": fleet_lib.strict_issues(streams),
            "shards": shards}


def render_fleet(rep: dict) -> str:
    ln = [f"fleet report: {rep['n_streams']} stream(s), run_ids "
          f"{', '.join(rep['run_ids']) or '(none)'}"]
    for shard in sorted(rep["shards"]):
        sr = rep["shards"][shard]
        b = sr.get("build", {})
        ident = sr.get("identity") or {}
        ln.append(
            f"  shard {shard}: {sr['n_records']} records, schema "
            f"v{sr.get('schema_version')}, host "
            f"{ident.get('host', '?')}, regions {b.get('regions', '-')}"
            f", {b.get('regions_per_s') or 0:.1f} regions/s"
            if b else
            f"  shard {shard}: {sr['n_records']} records, schema "
            f"v{sr.get('schema_version')} (no build.step events)")
    roll = rep["rollup"]
    headline = {k: v for k, v in roll["counters"].items()
                if k in ("build.steps", "build.leaves",
                         "build.oracle_solves", "oracle.point_solves",
                         "oracle.simplex_solves",
                         "build.quarantined_cells")}
    ln.append("rollup (counters sum across shards): "
              + ", ".join(f"{k}={int(v)}" for k, v in
                          sorted(headline.items())))
    if roll.get("regions") is not None:
        ln.append(f"rollup regions (max across shards): "
                  f"{int(roll['regions'])}"
                  + (f", sum {int(roll['regions_sum'])} (sharded-"
                     "frontier total)"
                     if rep.get("sharded")
                     and roll.get("regions_sum") is not None
                     and roll["regions_sum"] != roll["regions"]
                     else ""))
    for sid, cp in sorted((rep.get("per_shard_cp") or {}).items()):
        if cp:
            ln.append(f"  shard {sid} critical path: " + " / ".join(
                f"{seg} {100 * cp[seg]:.0f}%" for seg in
                ("fill", "plan", "wait", "certify", "other")
                if cp.get(seg) is not None))
    cp = rep.get("critical_path")
    if cp:
        ln.append("fleet critical path: " + " / ".join(
            f"{seg} {100 * cp[seg]:.0f}%"
            for seg in ("fill", "plan", "wait", "certify", "other"))
            + f" (ckpt {cp.get('checkpoint_s', 0.0):.1f}s)")
    sroll = rep.get("slo") or {}
    for spec in sorted(sroll.get("specs") or {}):
        d = sroll["specs"][spec]
        ln.append(
            f"slo [{spec}] (fleet): compliance {d['compliance']:.5f}"
            + (f" (goal {d['goal']:g})"
               if d.get("goal") is not None else "")
            + (f", budget {100 * d['budget_remaining_frac']:.0f}% left"
               if d.get("budget_remaining_frac") is not None else "")
            + f", worst-shard burn fast/slow "
              f"{d.get('burn_fast_max') or 0.0:.2f}/"
              f"{d.get('burn_slow_max') or 0.0:.2f}")
    for note in sroll.get("notes") or []:
        ln.append(f"  SLO NOTE: {note}")
    strag = rep.get("straggler", {})
    if strag.get("straggle_frac") is not None:
        ln.append(
            f"straggler: {strag['slowest']} at "
            f"{100 * (1 - strag['straggle_frac']):.0f}% of "
            f"{strag['fastest']}'s rate "
            f"(straggle_frac {strag['straggle_frac']:.2f})")
    elif not strag.get("concurrent"):
        ln.append("straggler: shards not concurrent (restart chain / "
                  "sequential sessions) -- attribution skipped")
    for issue in rep.get("issues", []):
        ln.append(f"  STRICT: {issue}")
    return "\n".join(ln)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m explicit_hybrid_mpc_tpu_torch.tools.obs_report",
        description=__doc__.splitlines()[0])
    ap.add_argument("stream", help="obs JSONL stream path")
    ap.add_argument("--bench", default=None,
                    help="BENCH_*.json to diff against, or a directory "
                         "whose newest BENCH_*.json is taken (default: "
                         "none -- no bench diff)")
    ap.add_argument("--drift", metavar="PREV", default=None,
                    help="earlier obs JSONL stream: flag "
                         "oracle.compiled_shapes growth vs it as a "
                         "recompile regression")
    ap.add_argument("--json", dest="json_out", default=None,
                    help="also write the structured report here")
    ap.add_argument("--tol", type=float, default=0.10,
                    help="relative regression tolerance (default 0.10)")
    ap.add_argument("--fleet", action="store_true",
                    help="the stream argument names N per-process "
                         "streams (glob / directory / bare name): "
                         "render the merged fleet view instead of one "
                         "stream's report")
    ap.add_argument("--strict", action="store_true",
                    help="exit nonzero when any bench-diff or drift "
                         "flag fires (CI mode); with --fleet, also "
                         "when streams mix schema versions or lack "
                         "identity meta records")
    args = ap.parse_args(argv)

    if args.fleet:
        from explicit_hybrid_mpc_tpu_torch.obs import fleet as fleet_lib

        streams = fleet_lib.load_fleet(args.stream)
        frep = fleet_report(streams)
        print(render_fleet(frep))
        if args.json_out:
            with open(args.json_out, "w") as f:
                json.dump({"fleet": frep}, f, indent=2,
                          default=lambda o: repr(o))
        return 1 if (args.strict and frep["issues"]) else 0

    rep = report(load_jsonl(args.stream))
    bench_path = args.bench
    if bench_path and os.path.isdir(bench_path):
        bench_path = latest_bench(bench_path)
    flags: list[str] = []
    if bench_path and os.path.exists(bench_path):
        with open(bench_path) as f:
            bench = json.load(f)
        flags = diff_bench(rep, bench, tol=args.tol)
        rep.setdefault("warnings", []).extend(bench_warnings(bench))
        if not rep["warnings"]:
            del rep["warnings"]
    else:
        bench_path = None
    drift_summary = None
    drift_flags: list[str] = []
    if args.drift:
        if os.path.exists(args.drift):
            prev = report(load_jsonl(args.drift))
            drift_flags, drift_summary = diff_drift(rep, prev)
        else:
            # Degrade like a missing --bench: a rotated-away artifact
            # must not exit with the same code as a real regression.
            drift_summary = {"note": f"previous stream {args.drift} "
                                     "not found; drift not computed"}
    print(render_text(rep, flags, bench_path))
    if drift_summary is not None:
        if "compiled_shapes" in drift_summary:
            print(f"compiled-shape drift vs "
                  f"{os.path.basename(args.drift)}: "
                  f"{drift_summary.get('compiled_shapes')} vs "
                  f"{drift_summary.get('prev_compiled_shapes')}"
                  + (f" ({drift_summary['note']})"
                     if "note" in drift_summary else ""))
        else:
            print(f"compiled-shape drift: {drift_summary['note']}")
        for fl in drift_flags:
            print(f"  REGRESSION: {fl}")
    if args.json_out:
        # Flags keep their provenance: machine consumers must not
        # attribute a compiled-shape drift regression to a bench
        # comparison that may never have run.
        with open(args.json_out, "w") as f:
            json.dump({"report": rep, "bench": bench_path,
                       "bench_flags": flags,
                       "drift_flags": drift_flags,
                       "drift": drift_summary}, f, indent=2)
    return 1 if (args.strict and (flags or drift_flags)) else 0


if __name__ == "__main__":
    raise SystemExit(main())
