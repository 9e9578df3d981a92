"""The port's bench history: one condensed row a bench run, appended to
a JSON-lines file of the port's own.

The JAX package's scripts/bench_gate.py row format (``summarize``,
``append_history``, ``load_history``, ``GATED_METRICS``), kept here so
that no tool of the port imports scripts/.  The gate, the rollup of
BENCH_*.json files and ``--update`` are not here: they read the history
this module writes.

- The default path is ``BENCH_HISTORY_TORCH.jsonl`` at the repository
  root, never the JAX package's ``BENCH_HISTORY.jsonl`` (whose rows were
  taken on a TPU or a CPU): ``history_path`` refuses that file.
  ``BENCH_HISTORY`` overrides the path and the empty string turns the
  history off, as in the JAX package.
- A row carries the metrics the JAX gate gates (``GATED_METRICS``, the
  same directions and tolerances), the row extras of the JAX gate and,
  from a card's run, ``device_name`` and ``power_limit``.  Its
  ``contended`` is null where the bench's host block says contention
  was not measured; the JAX row reads that as false.
"""

from __future__ import annotations

import json
import os

from explicit_hybrid_mpc_tpu_torch.parallel.launch import ROOT
from explicit_hybrid_mpc_tpu_torch.utils import atomic

#: The port's own history file.
HISTORY = os.path.join(ROOT, "BENCH_HISTORY_TORCH.jsonl")
#: The JAX package's history, which the port never writes.
JAX_HISTORY = os.path.join(ROOT, "BENCH_HISTORY.jsonl")
#: The key every result of the port's benches (tools/bench.py,
#: tools/serve_bench.py) carries, and its value: what tells a result of
#: the port from a JAX capture of the same shape (tools/bench_gate.py).
PACKAGE_KEY = "package"
PACKAGE = "explicit_hybrid_mpc_tpu_torch"

#: metric -> (direction, relative tolerance[, absolute slack]): "higher"
#: is better when bigger, "lower" when smaller (scripts/bench_gate.py's
#: table, key for key).
GATED_METRICS: dict[str, tuple] = {
    "value": ("higher", 0.10),
    "online_us_per_query": ("lower", 0.15),
    "large_l_sharded_us_per_query": ("lower", 0.15),
    "wasted_iter_frac": ("higher", 0.15),
    "warmstart_accept_rate": ("higher", 0.15),
    "pipeline_fill_frac": ("higher", 0.15),
    "spec_waste_frac": ("lower", 0.15, 0.02),
    "serve_p99_us": ("lower", 0.25, 1000.0),
    "fallback_frac": ("lower", 0.15, 0.02),
    "ipm_kernel_tile_us": ("lower", 0.25, 50.0),
    "rebuild_reuse_frac": ("higher", 0.15, 0.05),
    "rebuild_speedup": ("higher", 0.30, 0.25),
    "staleness_p99_s": ("lower", 0.30, 2.0),
    "delta_bytes_frac": ("lower", 0.15, 0.02),
    "multichip_scaling_frac": ("higher", 0.20, 0.10),
    "arena_swap_us": ("lower", 0.50, 20000.0),
    "batch_launches_per_req": ("lower", 0.25, 0.05),
    "serve_queue_frac": ("lower", 0.25, 0.10),
    "slo_compliance": ("higher", 0.05, 0.02),
}

#: Informational keys a row carries when the bench result has them: the
#: JAX gate's, then the card's name and power limit.
ROW_EXTRAS = (
    "regions", "unit", "precision", "truncated", "device_failures",
    "quarantined_cells", "uncertified", "serve_qps", "serve_batch_fill",
    "swap_dropped", "swap_torn", "ipm_kernel", "recert_solves",
    "subdivision_solves", "rebuild_invalidated", "rebuild_cold_wall_s",
    "rebuild_wall_s", "run_id", "obs_schema_version", "cp_fill_frac",
    "cp_plan_frac", "cp_wait_frac", "cp_certify_frac", "cp_other_frac",
    "cp_checkpoint_s", "n_processes", "n_devices", "shard_regions_per_s",
    "singleproc_wall_s", "multichip_wall_s", "multichip_wall_sync_s",
    "multichip_overhead_ok", "cp_wait_frac_sync", "cp_wait_frac_async",
    "cp_overlap_s", "async_certify", "drift_generations", "reuse_fracs",
    "reuse_decay", "excl_events_trajectory", "staleness_p50_s",
    "sla_misses", "revisions_superseded", "tenants", "arena_controllers",
    "arena_resident_bytes", "mixed_batch_fill", "delta_n_fresh",
    "delta_n_kept", "demand_top_decile_frac", "subopt_p99", "subopt_p50",
    "subopt_samples", "subopt_eps", "demand_leaves_observed",
    "demand_overhead_frac", "skew", "phase_queue_frac", "phase_seal_frac",
    "phase_put_frac", "phase_launch_frac", "phase_fallback_frac",
    "phase_reply_frac", "phase_sum_err_frac", "exemplar_max_wall_us",
    "trace_exemplar_p99_bound", "trace_overhead_frac",
    "serve_p99_trace_off_us", "serve_p99_trace_on_us", "gc_pause_frac",
    "gc_pauses", "gc_disabled", "slo_budget_remaining_frac",
    "slo_burn_fast_max", "slo_overhead_frac", "cert_margin_p01",
    "device_name", "power_limit")


def history_path(path: str | None = None) -> str | None:
    """The history file a bench appends to (and the gate reads): `path`,
    else ``BENCH_HISTORY``, else HISTORY; None when ``BENCH_HISTORY`` is
    the empty string.  The JAX package's history is refused
    (ValueError)."""
    path = path if path is not None else os.environ.get("BENCH_HISTORY")
    if path == "":
        return None
    path = path or HISTORY
    if os.path.realpath(path) == os.path.realpath(JAX_HISTORY):
        raise ValueError(f"{path} is the JAX package's bench history; the "
                         f"port writes its own ({HISTORY})")
    return path


def summarize(bench: dict, source: str, mtime: float | None = None) -> dict:
    """One history row from a bench result (or from a capture wrapper
    {"cmd", "rc", "tail", "parsed": <result>})."""
    if isinstance(bench.get("parsed"), dict):
        bench = bench["parsed"]
    contended = (bench.get("host") or {}).get("contended", False)
    row = {"source": os.path.basename(source),
           "mtime": round(mtime, 3) if mtime is not None else None,
           "platform": bench.get("platform"),
           "metric": bench.get("metric"),
           # None where the host could not measure it (a procfs that
           # counts no CPU time), never read as uncontended.
           "contended": None if contended is None else bool(contended),
           "error": bench.get("error")}
    for m in GATED_METRICS:
        row[m] = bench.get(m)
    for k in ROW_EXTRAS:
        if k in bench:
            row[k] = bench[k]
    return row


def load_history(path: str = HISTORY) -> list[dict]:
    """The rows of `path` in order; a torn last line is skipped."""
    if not os.path.exists(path):
        return []
    rows = []
    with open(path) as f:
        for ln in f:
            if ln.strip():
                try:
                    rows.append(json.loads(ln))
                except json.JSONDecodeError:
                    continue
    return rows


def append_history(bench: dict, source: str, path: str = HISTORY,
                   mtime: float | None = None,
                   seen: set | None = None) -> dict | None:
    """Append the summarized row of `bench` to `path` (flushed and
    fsynced); the row, or None when it carries no gated metric and no
    error, or when a row of the same source and mtime is there already
    (`seen`: those keys, loaded once by a caller that appends many)."""
    row = summarize(bench, source, mtime)
    if all(row.get(m) is None for m in GATED_METRICS) \
            and not row.get("error"):
        return None
    if seen is None:
        seen = {(r.get("source"), r.get("mtime"))
                for r in load_history(path)}
    key = (row["source"], row["mtime"])
    if key in seen:
        return None
    atomic.append_line_fsync(path, json.dumps(row))
    seen.add(key)
    return row
