"""Closed-loop serving load generator: offered-QPS sweep + hot swap.

    python -m explicit_hybrid_mpc_tpu_torch.tools.serve_bench
    SERVE_BENCH_TENANTS=4 python -m explicit_hybrid_mpc_tpu_torch.tools.serve_bench
    BENCH_PLATFORM=cpu python -m explicit_hybrid_mpc_tpu_torch.tools.serve_bench

The JAX package's scripts/serve_bench.py on the port's serving runtime
(serve/), against a synthetic partition (partition/synthetic.py --
serving only cares about the TREE, so the sweep needs no oracle solves):

1. Build controller **v1** (a balanced depth-D bisection tree with the
   synthetic linear law) and publish it; **v2** is the same geometry
   with every payload DOUBLED -- doubling is exact in floating point,
   so v2 results are bitwise 2x v1 results and a torn cross-version
   read is detectable bit-for-bit.
2. For each offered rate, N closed-loop clients pace single-query
   submissions through the RequestScheduler (pow-2 micro-batches under
   the ``max_wait_us`` deadline); a configurable fraction of queries
   lands outside the certified box to keep the fallback path hot.
3. Mid-run at the TOP offered rate, v2 hot-swaps in
   (ControllerRegistry.publish).  The sweep then verifies the swap
   contract: ZERO dropped/errored requests, the old version drains,
   and every result is bit-identical to ITS version's reference
   evaluation -- never a mix.
4. One JSON result (``--out``, else ``SERVE_BENCH_OUT``, else a fresh
   temp dir; never under the JAX package's artifacts/) plus a condensed
   ``serve_*`` row appended to the port's bench history
   (tools/bench_history.py, ``BENCH_HISTORY_TORCH.jsonl``;
   ``BENCH_HISTORY`` overrides the path, the empty string disables it,
   the JAX package's ``BENCH_HISTORY.jsonl`` is refused).

Env knobs (the JAX script's, with its defaults):
    SERVE_BENCH_P=2 SERVE_BENCH_DEPTH=9 SERVE_BENCH_NU=2
    SERVE_BENCH_SHARDS=2 SERVE_BENCH_CLIENTS=8
    SERVE_BENCH_RATES=1000,4000,16000 SERVE_BENCH_SECS=2.0
    SERVE_BENCH_MAX_BATCH=64 SERVE_BENCH_WAIT_US=2000
    SERVE_BENCH_OUTSIDE_FRAC=0.05 SERVE_BENCH_OUT=...
    SERVE_BENCH_SKEW=0 SERVE_BENCH_DEMAND=on
    SERVE_BENCH_TRACE=on SERVE_BENCH_NO_GC=0
    SERVE_BENCH_SLO=on SERVE_BENCH_SLO_P99_US=50000
    SERVE_BENCH_SLO_GOAL=0.999 SERVE_BENCH_TENANTS=0

Modes and figures, as in the JAX script:

- **Error budgets**: with ``SERVE_BENCH_SLO=on`` both modes attach an
  obs/slo.py SloTracker to the scheduler's metrics-flush path; the row
  carries the worst-spec ``slo_compliance`` /
  ``slo_budget_remaining_frac``, the max fast-pair burn
  ``slo_burn_fast_max`` and ``slo_overhead_frac`` (the amortized fold
  cost over the measured p99, barred at 1%).
- **Request tracing**: with ``SERVE_BENCH_TRACE=on`` both modes run
  under a ReqTrace hub: each rate's per-phase means
  (``phase_mean_us``) and their sum-vs-wall error
  (``phase_sum_err_frac``, barred at 2%), the top rate's phase
  fractions and p50/p99, the slowest-request exemplar bound to the p99
  bucket, ``gc_pause_frac`` from a GcPauseRecorder (``--no-gc`` /
  ``SERVE_BENCH_NO_GC=1`` disables the collector for the sweep).
- **Skewed traffic + demand telemetry**: ``SERVE_BENCH_SKEW=a`` (a > 0)
  draws a seeded Zipf(a)-over-Gaussian-blobs mix; the demand hub's
  sketches, a reference 'oracle' (the active version's own evaluation)
  for the subopt sampler, a strict snapshot load, and five interleaved
  off/on pairs of top-rate windows (min p99 a side) for the demand and
  the trace overheads (each barred at 1%).
- **Mixed-tenant arena mode** (``SERVE_BENCH_TENANTS=K``, K >= 2): K
  controllers share one DeviceArena behind one ArenaScheduler -- every
  micro-batch is ONE launch of the fused kernel (csrc/arena_eval.cu on
  the card, ``batch_launches_per_req`` barred under 1); tenant t0's v2
  (half its leaf payloads doubled) publishes mid-top-rate through
  ``arena.publish_delta``, and every recorded in-box result is
  re-evaluated on a layout-identical reference arena, bitwise, on its
  own version.

Where it runs: the card (``cuda``) unless ``--backend cpu`` or
``BENCH_PLATFORM=cpu``; without a card it refuses to start
(tools/capture.choose_device) and writes nothing.  On the card both
arenas, and the legacy mode's shards, are on the card: K3 serves every
arena batch, with no fallback to the CPU or to its plain version.  A
card's row adds ``device_name`` and ``power_limit``; ``platform`` is
"gpu" or "cpu" and the arena row's ``config.backend`` "cuda" or
"torch".

A client's ``kernels.KernelError``, ``device.NoCpuFallback`` or CUDA
error is not counted as a dropped request (the JAX script counts every
exception): it stops the sweep and becomes the result's ``error``, the
exit code is 1 and no history row is appended.  Any other exception of
a client is counted in ``swap_dropped``, as in the JAX script.
``main()`` exits 1 when a bar of the JAX script's ``main()`` fails
(``bars``).  Every result carries ``"package":
"explicit_hybrid_mpc_tpu_torch"``, by which tools/bench_gate.py tells it
from a JAX capture.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import tempfile
import threading
import time

import numpy as np

from explicit_hybrid_mpc_tpu_torch.tools import bench_history
from explicit_hybrid_mpc_tpu_torch.tools.capture import (
    card_fault, choose_device, out_path)


def _env(name: str, default, cast=float):
    v = os.environ.get(name)
    return default if v in (None, "") else cast(v)


def _percentile_us(lat_s: list[float], q: float) -> float:
    return round(float(np.percentile(np.asarray(lat_s) * 1e6, q)), 3)


def _no_gc(flag: bool = False) -> bool:
    """--no-gc / SERVE_BENCH_NO_GC=1: the historical gc-disabled capture;
    default is collector ON + GcPauseRecorder attribution."""
    return flag or str(_env("SERVE_BENCH_NO_GC", "0", str)).lower() \
        in ("1", "on", "true")


def _make_trace(o):
    """ReqTrace hub for the sweep (SERVE_BENCH_TRACE=off disables).
    window_s >> sweep wall so the slowest request of the WHOLE run is
    still in the exemplar ring when the digest is cut at the end."""
    if str(_env("SERVE_BENCH_TRACE", "on", str)) == "off":
        return None
    from explicit_hybrid_mpc_tpu_torch.obs import reqtrace

    return reqtrace.ReqTrace(mode="on", exemplar_k=8, window_s=600.0,
                             obs=o)


def _make_slo(o):
    """SloTracker for the sweep (SERVE_BENCH_SLO=off disables): specs
    auto-discover per controller via the serve template, so one factory
    covers the legacy controller and the lazily minted arena tenants.
    The 0.5 s interval lets the budget ring advance inside a
    seconds-long sweep; the windows scale with it (the production
    pairs at 0.5 s would be half a million slots a spec)."""
    if str(_env("SERVE_BENCH_SLO", "on", str)) == "off":
        return None
    from explicit_hybrid_mpc_tpu_torch.obs.slo import SloTracker

    return SloTracker(
        interval_s=0.5, windows=((5.0, 60.0), (120.0, 600.0)), obs=o,
        serve_template={
            "p99_target_us": _env("SERVE_BENCH_SLO_P99_US", 50_000.0),
            "goal": _env("SERVE_BENCH_SLO_GOAL", 0.999)})


def _slo_row(slo, n_req: int, p99_us) -> dict:
    """Error-budget fields: worst-spec compliance/budget, max fast-pair
    burn, and the tracking overhead as the per-request amortized tick
    cost relative to the measured p99 (barred <= 1%)."""
    if slo is None:
        return {}
    ev = slo.evaluate()
    row: dict = {}
    if ev:
        row = {
            "slo_compliance": round(
                min(d["compliance"] for d in ev.values()), 6),
            "slo_budget_remaining_frac": round(
                min(d["budget_remaining_frac"] for d in ev.values()), 6),
            "slo_burn_fast_max": round(
                max(d["burn_fast"] for d in ev.values()), 4),
        }
    if p99_us and n_req:
        row["slo_overhead_frac"] = round(
            (slo.total_tick_s / n_req) / (p99_us * 1e-6), 6)
    return row


def _phase_hists(o) -> dict:
    """phase name -> cumulative histogram snapshot, summed over
    controllers (every serve.ctl.<name>.phase.<phase>_us shares one
    bounds vector, so elementwise count sums are exact)."""
    out: dict[str, dict] = {}
    if not o.enabled:
        return out
    for k, v in o.metrics.snapshot()["histograms"].items():
        seg = k.rsplit(".phase.", 1)
        if len(seg) != 2 or not seg[1].endswith("_us"):
            continue
        ph = seg[1][:-3]
        cur = out.get(ph)
        if cur is None:
            out[ph] = {"bounds": list(v["bounds"]),
                       "counts": list(v["counts"]),
                       "count": v["count"], "sum": v["sum"],
                       "min": v["min"], "max": v["max"]}
        else:
            cur["counts"] = [a + b for a, b in
                             zip(cur["counts"], v["counts"])]
            cur["count"] += v["count"]
            cur["sum"] += v["sum"]
            mins = [x for x in (cur["min"], v["min"]) if x is not None]
            maxs = [x for x in (cur["max"], v["max"]) if x is not None]
            cur["min"] = min(mins) if mins else None
            cur["max"] = max(maxs) if maxs else None
    return out


def _hist_delta(after: dict, before: dict | None) -> dict:
    """Histogram restricted to one rate window = cumulative-after minus
    cumulative-before (counts are monotone)."""
    if before is None:
        return after
    d = dict(after)
    d["counts"] = [a - b for a, b in
                   zip(after["counts"], before["counts"])]
    d["count"] = after["count"] - before["count"]
    d["sum"] = after["sum"] - before["sum"]
    return d


def _phase_rate_row(ph0: dict, ph1: dict) -> tuple[dict, dict]:
    """Per-rate phase decomposition from cumulative-histogram deltas:
    mean us per phase over THIS window plus the sum-vs-wall error.
    Phases partition each request's wall by construction (the trace
    fold computes reply as the remainder), so the means agree to float
    rounding; a larger gap than 2% means a stamp went missing."""
    delta = {ph: _hist_delta(ph1[ph], ph0.get(ph)) for ph in ph1}
    means = {ph: d["sum"] / d["count"]
             for ph, d in delta.items() if d["count"] > 0}
    wall = means.get("wall")
    row: dict = {}
    if means:
        row["phase_mean_us"] = {ph: round(m, 2)
                                for ph, m in sorted(means.items())}
    if wall:
        err = abs(sum(m for ph, m in means.items() if ph != "wall")
                  - wall) / wall
        row["phase_sum_err_frac"] = round(err, 6)
    return row, delta


def _trace_row(tr, o, top_delta: dict | None, sweep_wall_s: float,
               gcrec, no_gc: bool, per_rate: list[dict]) -> dict:
    """Trace + host-forensics fields shared by both modes: top-rate
    phase fractions and per-phase p50/p99, queue_frac, the exemplar
    digest with its p99-bucket binding, and the gc pause share."""
    row: dict = {
        "gc_disabled": bool(no_gc),
        "gc_pauses": len(gcrec.pauses) if gcrec is not None else None,
        "gc_pause_frac": (
            round(gcrec.total_pause_s() / sweep_wall_s, 6)
            if gcrec is not None and sweep_wall_s > 0 else None),
    }
    if tr is None:
        return row
    errs = [r.get("phase_sum_err_frac") for r in per_rate]
    errs = [e for e in errs if e is not None]
    if errs:
        row["phase_sum_err_frac"] = max(errs)
    from explicit_hybrid_mpc_tpu_torch.obs.metrics import quantile
    from explicit_hybrid_mpc_tpu_torch.obs.reqtrace import PHASES

    if top_delta:
        means = {ph: d["sum"] / d["count"]
                 for ph, d in top_delta.items() if d["count"] > 0}
        wall = means.get("wall")
        if wall:
            for ph in PHASES:
                m = means.get(ph)
                row[f"phase_{ph}_frac"] = (round(m / wall, 4)
                                           if m is not None else None)
        row["phase_p50_us"] = {
            ph: round(quantile(d, 0.50), 2)
            for ph, d in sorted(top_delta.items()) if d["count"] > 0}
        row["phase_p99_us"] = {
            ph: round(quantile(d, 0.99), 2)
            for ph, d in sorted(top_delta.items()) if d["count"] > 0}
    gauges = o.metrics.snapshot()["gauges"] if o.enabled else {}
    qfs = [v for k, v in gauges.items()
           if k.startswith("serve.ctl.") and k.endswith(".queue_frac")]
    row["serve_queue_frac"] = (round(sum(qfs) / len(qfs), 4)
                               if qfs else None)
    # The ring kept the slowest requests of the whole sweep, so the
    # slowest exemplar is the sample max and must sit at/above the
    # traced-wall p99 (0.999 covers log-linear interpolation).
    ex = tr.exemplars()
    row["trace_exemplars"] = ex[:3]
    row["exemplar_max_wall_us"] = (round(ex[0]["wall_us"], 2)
                                   if ex else None)
    whole = _phase_hists(o).get("wall")
    if ex and whole and whole["count"] > 0:
        p99 = quantile(whole, 0.99)
        row["trace_exemplar_p99_bound"] = bool(
            p99 is not None and ex[0]["wall_us"] >= 0.999 * p99)
    return row


def _skew_sampler(skew: float, lb: np.ndarray, ub: np.ndarray):
    """Seeded Zipf-over-Gaussian-blobs in-box theta mix
    (SERVE_BENCH_SKEW); None when skew <= 0 keeps the uniform draw."""
    if skew <= 0:
        return None
    p = lb.size
    span = ub - lb
    crng = np.random.default_rng(42)
    centers = crng.uniform(lb + 0.15 * span, ub - 0.15 * span,
                           size=(16, p))
    w = 1.0 / np.arange(1, 17, dtype=np.float64) ** skew
    w /= w.sum()
    # Tight blobs: ~1 leaf-cell wide at the depth-9 geometry, so each
    # hot center maps to a handful of hot leaves.
    sigma = 0.01 * span

    def draw(rng: np.random.Generator) -> np.ndarray:
        c = rng.choice(16, p=w)
        return np.clip(centers[c] + sigma * rng.standard_normal(p),
                       lb, ub)

    return draw


class _RefOracle:
    """Reference 'host oracle' for the demand hub's subopt sampler: V*
    for a query is the ACTIVE version's own reference evaluation (the
    synthetic law is exact barycentric interpolation, so the measured
    subopt is 0 up to float identity; samples queued on one version and
    drained across the hot swap clamp to 0 in the hub).  dstar >= 0
    marks in-box hits exactly as the real oracle does.

    The reference is the version's leaf table evaluated on the host in
    float64 (the first best leaf over all leaves, as
    online/evaluator.py's plain evaluator), single-threaded numpy, as
    the JAX script's reference runs on the host beside the serving
    program: a re-solve on the card would queue its kernels beside the
    serving batches' and be measured as the cost of demand capture."""

    def __init__(self, registry, name: str, tables: dict):
        self._registry = registry
        self._name = name
        # Per version: each vertex row of every leaf's barycentric
        # matrix as one contiguous (p+1, L) plane, and V.
        self._refs = {
            v: ([np.ascontiguousarray(t.bary_M[:, i, :].T)
                 for i in range(t.bary_M.shape[1])], np.asarray(t.V))
            for v, t in tables.items()}

    def solve_vertices(self, thetas):
        import types

        planes, V = self._refs[self._registry.active_version(self._name)]
        th = np.asarray(thetas, dtype=np.float64)
        th1 = np.concatenate([th, np.ones((th.shape[0], 1))], axis=1)
        lam = [th1 @ pl for pl in planes]          # (B, L) a vertex
        score = lam[0]
        for pl in lam[1:]:
            score = np.minimum(score, pl)
        leaf = np.argmax(score, axis=1)
        rows = np.arange(th.shape[0])
        best = np.stack([pl[rows, leaf] for pl in lam], axis=1)
        res = types.SimpleNamespace(
            cost=np.einsum("bi,bi->b", best, V[leaf]),
            inside=score[rows, leaf] >= -1e-9)
        return types.SimpleNamespace(
            Vstar=np.asarray(res.cost, dtype=np.float64),
            dstar=np.where(np.asarray(res.inside), 0, -1))


class _Clients:
    """The closed-loop clients of one sweep.  Client `cid` draws from
    its own seeded stream (1000 + cid) and paces its single-query
    submissions at its share of the offered rate; a fraction lands
    outside the box.  `submit(name, theta)` (arena: tenants round-robin
    from the client's id) or `submit(theta)` (legacy, names None).  A
    card fault stops every client and is kept in `fault`; any other
    exception ends the client and is counted in `errors`."""

    def __init__(self, submit, names, draw, lb, ub, outside_frac):
        self.submit = submit
        self.names = names
        self.draw = draw
        self.lb, self.ub = lb, ub
        self.outside_frac = outside_frac
        self.errors: list[str] = []
        self.fault: list[BaseException] = []
        self.stop = threading.Event()
        self.records: list[tuple] = []
        self._lock = threading.Lock()

    def client(self, cid: int, rate_per_client: float, t_end: float,
               lat_out: list, collect: bool) -> None:
        lb, ub = self.lb, self.ub
        p = lb.size
        span = ub - lb
        rng = np.random.default_rng(1000 + cid)
        interval = 1.0 / rate_per_client if rate_per_client > 0 else 0.0
        t_next = time.perf_counter()
        q = cid
        while time.perf_counter() < t_end and not self.stop.is_set():
            name = None
            if self.names is not None:
                name = self.names[q % len(self.names)]
                q += 1
            theta = self.draw(rng) if self.draw is not None \
                else rng.uniform(lb, ub)
            outside = rng.uniform() < self.outside_frac
            if outside:
                theta = ub + 0.05 * span * rng.uniform(0.1, 1.0, p)
            try:
                ticket = (self.submit(theta) if name is None
                          else self.submit(name, theta))
                (r,) = ticket.result(30.0)
            except Exception as e:  # noqa: BLE001 -- a drop IS the finding
                with self._lock:
                    if card_fault(e):
                        self.fault.append(e)
                        self.stop.set()
                    else:
                        self.errors.append(repr(e))
                return
            lat_out.append(r.latency_s)
            if collect and not outside:
                with self._lock:
                    self.records.append((name, theta, r))
            t_next += interval
            sleep = t_next - time.perf_counter()
            if sleep > 0:
                time.sleep(sleep)

    def window(self, rate: float, n_clients: int, secs: float,
               lat: list, collect: bool, mid=None) -> float:
        """One closed-loop window at `rate` for `secs`; `mid()` runs
        half-way (the hot swap).  Returns its wall; raises the card
        fault that stopped it."""
        t_end = time.perf_counter() + secs
        threads = [threading.Thread(
            target=self.client,
            args=(c, rate / n_clients, t_end, lat, collect))
            for c in range(n_clients)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        if mid is not None and not self.stop.wait(secs / 2):
            mid(time.perf_counter() - t0)
        for t in threads:
            t.join()
        if self.fault:
            raise self.fault[0]
        return time.perf_counter() - t0


def _sweep(sched, clients: _Clients, rates, n_clients: int, secs: float,
           o, tr, swap, arena: bool) -> tuple[list, dict | None]:
    """The offered-rate sweep: one window a rate, `swap(t)` half-way
    through the top one, whose in-box results are recorded.  Returns
    the per-rate rows and the top window's phase histograms."""
    per_rate = []
    top_delta = None
    for i, rate in enumerate(rates):
        top = i == len(rates) - 1
        lat: list[float] = []
        req0, bat0 = sched.n_requests, sched.n_batches
        ph0 = _phase_hists(o) if tr is not None else {}
        wall = clients.window(rate, n_clients, secs, lat, top,
                              mid=swap if top else None)
        fill = (sum(sched._fill_roll) / len(sched._fill_roll)
                if sched._fill_roll else 0.0)
        prow: dict = {}
        if tr is not None:
            # Let the worker finish the final batch's fold (scatter
            # wakes clients a hair before the fold runs).
            time.sleep(0.05)
            prow, delta = _phase_rate_row(ph0, _phase_hists(o))
            if top:
                top_delta = delta
        row = {
            "offered_qps": rate,
            "achieved_qps": round(len(lat) / wall, 1),
            "p50_us": _percentile_us(lat, 50) if lat else None,
            "p99_us": _percentile_us(lat, 99) if lat else None,
            "batch_fill": round(fill, 4),
        }
        if arena:
            mix = (sum(sched._mix_roll) / len(sched._mix_roll)
                   if sched._mix_roll else 0.0)
            nreq = sched.n_requests - req0
            nbat = sched.n_batches - bat0
            row["mixed_batch_fill"] = round(mix, 4)
            row["launches_per_req"] = (round(nbat / nreq, 4) if nreq
                                       else None)
        per_rate.append({**row, "requests": len(lat), **prow})
    return per_rate, top_delta


class _Run:
    """What both modes share around the sweep: the obs stream, the
    trace hub, the SLO tracker, the contention monitor, the GC recorder
    and the sweep's wall; `close()` stops what is still running (the
    scheduler and the demand hub included) on any path out."""

    def __init__(self, no_gc: bool):
        from explicit_hybrid_mpc_tpu_torch import obs as obs_lib

        self.o = obs_lib.Obs("jsonl")  # in-memory stream: events + metrics
        self.tr = _make_trace(self.o)
        self.slo = _make_slo(self.o)
        self.no_gc = _no_gc(no_gc)
        self.sched = None
        self.hub = None
        self.gcrec = None
        self.monitor = None
        self.t_sweep0 = None

    def start(self) -> None:
        """Contention monitor and GC recorder on; the sweep's clock
        starts.  The collector stays ON (pauses measured and attributed
        via serve.host.gc_pause_us) unless no_gc."""
        from explicit_hybrid_mpc_tpu_torch.obs.host import ContentionMonitor
        from explicit_hybrid_mpc_tpu_torch.obs.reqtrace import GcPauseRecorder

        o = self.o
        self.monitor = ContentionMonitor(
            interval_s=1.0,
            metrics=o.metrics if o.enabled else None).start()
        gc.collect()
        if self.no_gc:
            gc.disable()
        self.gcrec = GcPauseRecorder(obs=o).start()
        self.t_sweep0 = time.perf_counter()

    def stop(self) -> float:
        """GC recorder off, collector back on; the sweep's wall."""
        wall = time.perf_counter() - self.t_sweep0
        self.gcrec.stop()
        if self.no_gc:
            gc.enable()
        return wall

    def close_sched(self) -> None:
        """Drain and stop the scheduler (once)."""
        if self.sched is not None:
            self.sched.close()
            self.sched = None

    def close_hub(self) -> None:
        if self.hub is not None:
            self.hub.close(snapshot=False)
            self.hub = None

    def host(self) -> dict:
        host = self.monitor.summary()
        # Not measured (a procfs that counts no CPU time) is null, never
        # uncontended.
        host.setdefault("contended", None)
        return host

    def close(self) -> None:
        self.close_sched()
        self.close_hub()
        if self.gcrec is not None:
            self.gcrec.stop()
        if self.no_gc:
            gc.enable()
        if self.monitor is not None:
            self.monitor.summary()  # stops its thread
        self.o.close()


def _metric(text: str, platform: str, host: dict) -> str:
    """The metric line; a contended capture says so in it, so it can
    never read as a clean number."""
    metric = f"{text}, {platform})"
    if host.get("contended"):
        metric += (f" [CONTENDED: competing processes used "
                   f"{100 * host['competing_cpu_frac_mean']:.0f}% of "
                   f"CPU]")
    return metric


def run_arena(result: dict, dev, no_gc: bool = False) -> None:
    """Mixed-tenant sweep over one DeviceArena on `dev` (module
    docstring); fills `result`."""
    from explicit_hybrid_mpc_tpu_torch.lifecycle.delta import \
        write_delta_artifact
    from explicit_hybrid_mpc_tpu_torch.online import export
    from explicit_hybrid_mpc_tpu_torch.partition.synthetic import \
        build_synthetic_tree
    from explicit_hybrid_mpc_tpu_torch.serve import (ArenaScheduler,
                                                     DeviceArena,
                                                     FallbackPolicy)
    from explicit_hybrid_mpc_tpu_torch.serve.registry import save_artifacts

    p = int(_env("SERVE_BENCH_P", 2, int))
    depth = int(_env("SERVE_BENCH_DEPTH", 9, int))
    n_u = int(_env("SERVE_BENCH_NU", 2, int))
    tenants = int(_env("SERVE_BENCH_TENANTS", 4, int))
    n_clients = int(_env("SERVE_BENCH_CLIENTS", 8, int))
    rates = [float(r) for r in str(
        _env("SERVE_BENCH_RATES", "1000,4000,16000", str)).split(",")]
    secs = _env("SERVE_BENCH_SECS", 2.0)
    # Arena default is n_clients, not 64: closed-loop clients never
    # queue more than n_clients requests, so a larger cap means the
    # deadline always binds and every request eats the full wait.
    max_batch = int(_env("SERVE_BENCH_MAX_BATCH", n_clients, int))
    wait_us = _env("SERVE_BENCH_WAIT_US", 2000.0)
    outside_frac = _env("SERVE_BENCH_OUTSIDE_FRAC", 0.05)
    skew = _env("SERVE_BENCH_SKEW", 0.0)
    demand_on = str(_env("SERVE_BENCH_DEMAND", "on", str)) != "off"
    names = [f"t{k}" for k in range(tenants)]

    tree1, roots1 = build_synthetic_tree(p=p, depth=depth, n_u=n_u)
    table1 = export.export_leaves(tree1)
    tree2, roots2 = build_synthetic_tree(p=p, depth=depth, n_u=n_u)
    # v2 = tenant t0 with HALF its payload slots exactly doubled:
    # bitwise-detectable and a genuine O(changed) delta -- the untouched
    # half rides as kept rows the arena gathers on the device.
    half = tree2._n_slots // 2
    tree2._pl_inputs[:half] *= 2.0
    tree2._pl_costs[:half] *= 2.0

    run = _Run(no_gc)
    o, tr, slo = run.o, run.tr, run.slo
    try:
        with tempfile.TemporaryDirectory(prefix="serve_arena_bench_") \
                as work:
            base_dir = os.path.join(work, "t0_v1")
            delta_dir = os.path.join(work, "t0_v2.delta")
            demand_dir = os.path.join(work, "demand")
            save_artifacts(tree1, roots1, base_dir,
                           provenance={"problem": "synthetic-serve-bench"})
            delta_stats = write_delta_artifact(tree2, roots2, delta_dir,
                                               base_dir, base_version="v1")
            lb, ub = np.zeros(p), np.ones(p)  # the synthetic unit box
            cols = 128 * ((table1.n_leaves + 127) // 128)

            def layout(arena) -> None:
                # The publish history both arenas share: a throwaway
                # tenant runs the IDENTICAL publish_from_artifacts +
                # publish_delta as the sweep's swap (so the measured
                # arena_swap_us is not a first use), then the tenants.
                arena.publish_from_artifacts("warm", "v1", base_dir)
                arena.publish_delta("warm", "v2", delta_dir, base_dir)
                arena.retire("warm")
                for name in names:
                    if name == "t0":
                        arena.publish_from_artifacts(name, "v1", base_dir)
                    else:
                        arena.publish(name, "v1", table1, lb, ub)

            arena = DeviceArena(p=p, n_u=n_u,
                                capacity_cols=(tenants + 1) * cols,
                                device=dev, obs=o)
            layout(arena)
            # Every pow-2 batch bucket up to max_batch once: on the card
            # the kernel's build and first launch land here, not in a
            # measured window.
            wrng = np.random.default_rng(0)
            k = 1
            while k <= max_batch:
                arena.evaluate([names[i % tenants] for i in range(k)],
                               wrng.uniform(lb, ub, size=(k, p)))
                k *= 2

            fallback = FallbackPolicy(lb, ub, obs=o)
            if demand_on:
                from explicit_hybrid_mpc_tpu_torch.obs import \
                    demand as demand_mod

                # No oracle in arena mode (the audit pins correctness
                # bitwise); the hub carries sketches + geometry.
                run.hub = demand_mod.DemandHub(
                    mode="on", max_leaves=1024, decay_halflife_s=300.0,
                    reservoir_k=64, snapshot_every_s=max(0.5, secs / 2),
                    snapshot_dir=demand_dir, obs=o)
            run.sched = sched = ArenaScheduler(
                arena, max_batch=max_batch, max_wait_us=wait_us,
                fallback=fallback, obs=o, demand=run.hub, trace=tr,
                slo=slo)
            clients = _Clients(sched.submit, names,
                               _skew_sampler(skew, lb, ub), lb, ub,
                               outside_frac)
            e_v1 = arena.extent("t0")
            swap: dict = {}

            def hot_swap(at: float) -> None:
                # Mid-run O(changed) hot swap at the top offered rate.
                swap["at"] = at
                t_sw = time.perf_counter()
                arena.publish_delta("t0", "v2", delta_dir, base_dir)
                swap["us"] = round((time.perf_counter() - t_sw) * 1e6, 3)

            run.start()
            per_rate, top_delta = _sweep(sched, clients, rates, n_clients,
                                         secs, o, tr, hot_swap, arena=True)
            sweep_wall = run.stop()
            gc.collect()
            drained = arena.wait_retired(e_v1, 10.0)
            run.close_sched()
            host = run.host()
            if slo is not None:  # final fold: the last flush window's tail
                slo.tick(o.metrics.snapshot())

            # Demand epilogue (per tenant): publish + strict-load every
            # tenant's snapshot; the row carries the mean top-decile
            # share over tenants (each sees the same client mix).
            demand_row: dict = {}
            if run.hub is not None:
                from explicit_hybrid_mpc_tpu_torch.obs.demand import \
                    load_demand

                metas = run.hub.snapshot()
                run.close_hub()
                tdfs = [m["top_decile_frac"] for m in metas.values()
                        if m["top_decile_frac"] is not None]
                strict = all(
                    load_demand(os.path.join(demand_dir, nm)
                                ).meta["npz_sha256"] == m["npz_sha256"]
                    for nm, m in metas.items())
                demand_row = {
                    "demand_top_decile_frac": (
                        round(sum(tdfs) / len(tdfs), 4) if tdfs else None),
                    "demand_leaves_observed": sum(
                        m["leaves_observed"] for m in metas.values()),
                    "demand_snapshot_strict": bool(strict),
                }

            # Swap-atomicity audit: the serving arena's LAYOUT HISTORY
            # rebuilt in a reference arena on the same device, then
            # every recorded in-box row re-evaluated on its own leased
            # version.  Same device, buffers and row => bitwise equal (a
            # row's record does not depend on its batch); a torn
            # cross-version read shows bit for bit.
            ref = DeviceArena(p=p, n_u=n_u,
                              capacity_cols=(tenants + 1) * cols,
                              device=dev)
            layout(ref)
            records = clients.records

            def audit(rows) -> int:
                bad = 0
                for lo in range(0, len(rows), 256):
                    chunk = rows[lo:lo + 256]
                    out = ref.evaluate([nm for nm, _t, _r in chunk],
                                       np.stack([t for _n, t, _r in chunk]))
                    for j, (_nm, _th, r) in enumerate(chunk):
                        if not (np.array_equal(
                                r.u, out.u[j, :n_u].astype(np.float64))
                                and r.cost == float(out.cost[j])
                                and r.leaf == int(out.leaf[j])):
                            bad += 1
                return bad

            torn = audit([rec for rec in records if rec[2].version == "v1"])
            ref.publish_delta("t0", "v2", delta_dir, base_dir)
            torn += audit([rec for rec in records
                           if rec[2].version == "v2"])

        fb_ms = o.metrics.snapshot()["counters"] if o.enabled else {}
        n_req = sched.n_requests
        n_fb = fb_ms.get("serve.fallback.requests", 0)
        top_row = per_rate[-1]
        astats = arena.stats()
        result.update({
            "metric": _metric(f"serve p99 us (arena K={tenants} tenants "
                              f"p={p} depth={depth}, closed-loop "
                              f"x{n_clients}", result["platform"], host),
            "unit": "us p99",
            "serve_p99_us": top_row["p99_us"],
            "fallback_frac": round(n_fb / max(1, n_req), 4),
            "serve_qps": top_row["achieved_qps"],
            "serve_batch_fill": top_row["batch_fill"],
            "tenants": tenants,
            "batch_launches_per_req": top_row["launches_per_req"],
            "mixed_batch_fill": top_row["mixed_batch_fill"],
            "arena_swap_us": swap.get("us"),
            "arena_controllers": astats["controllers"],
            "arena_resident_bytes": astats["resident_bytes"],
            "delta_n_fresh": delta_stats["n_fresh"],
            "delta_n_kept": delta_stats["n_kept"],
            "swap_dropped": len(clients.errors),
            "swap_torn": torn,
            "swap_drained": bool(drained),
            "swap_at_s": round(swap["at"], 3) if swap.get("at") else None,
            "versions_seen": sorted({r.version for _n, _t, r in records}),
            "requests": n_req,
            "batches": sched.n_batches,
            "rates": per_rate,
            "host": host,
            "errors": clients.errors[:5],
            # Workload shape: skewed and unskewed captures never mix in
            # a history window.
            "skew": skew,
            "config": {"p": p, "depth": depth, "n_u": n_u,
                       "tenants": tenants, "clients": n_clients,
                       "max_batch": max_batch, "max_wait_us": wait_us,
                       "outside_frac": outside_frac, "secs": secs,
                       "capacity_cols": arena.capacity_cols,
                       "backend": "cuda" if dev.type == "cuda" else "torch",
                       "skew": skew, "demand": demand_on,
                       "trace": tr is not None, "no_gc": run.no_gc},
            **demand_row,
            **_trace_row(tr, o, top_delta, sweep_wall, run.gcrec,
                         run.no_gc, per_rate),
            **_slo_row(slo, n_req, top_row["p99_us"]),
        })
    finally:
        run.close()


def _ab_pairs(window, flip_off, flip_on, pairs: int = 5
              ) -> tuple[list, list, float | None, float | None,
                         float | None]:
    """Five INTERLEAVED off/on pairs of top-rate windows, min p99 a
    side: single-window p99 jitters tens of percent under identical
    load, the min over repetitions is each side's noise floor, and a
    systematic cost shifts the ON floor and survives the min.  Returns
    (offs, ons, p99 off, p99 on, overhead)."""
    offs: list = []
    ons: list = []
    for _rep in range(pairs):
        flip_off()
        offs.append(window())
        flip_on()
        ons.append(window())
    offs = [x for x in offs if x is not None]
    ons = [x for x in ons if x is not None]
    if not (offs and ons):
        return offs, ons, None, None, None
    p_off, p_on = min(offs), min(ons)
    return offs, ons, p_off, p_on, round((p_on - p_off) / p_off, 4)


def run_legacy(result: dict, dev, no_gc: bool = False) -> None:
    """The single-controller sweep through the RequestScheduler over a
    ShardedDescent on `dev`'s devices (module docstring); fills
    `result`."""
    from explicit_hybrid_mpc_tpu_torch.online import (descent, export,
                                                      sharded)
    from explicit_hybrid_mpc_tpu_torch.partition.synthetic import \
        build_synthetic_tree
    from explicit_hybrid_mpc_tpu_torch.serve import (ControllerRegistry,
                                                     FallbackPolicy,
                                                     RequestScheduler,
                                                     root_box)

    p = int(_env("SERVE_BENCH_P", 2, int))
    depth = int(_env("SERVE_BENCH_DEPTH", 9, int))
    n_u = int(_env("SERVE_BENCH_NU", 2, int))
    n_shards = int(_env("SERVE_BENCH_SHARDS", 2, int))
    n_clients = int(_env("SERVE_BENCH_CLIENTS", 8, int))
    rates = [float(r) for r in str(
        _env("SERVE_BENCH_RATES", "1000,4000,16000", str)).split(",")]
    secs = _env("SERVE_BENCH_SECS", 2.0)
    max_batch = int(_env("SERVE_BENCH_MAX_BATCH", 64, int))
    wait_us = _env("SERVE_BENCH_WAIT_US", 2000.0)
    outside_frac = _env("SERVE_BENCH_OUTSIDE_FRAC", 0.05)
    skew = _env("SERVE_BENCH_SKEW", 0.0)
    demand_on = str(_env("SERVE_BENCH_DEMAND", "on", str)) != "off"
    # The card's devices (every visible card, as the JAX script takes
    # every JAX device), or the CPU when asked for.
    devices = None if dev.type == "cuda" else [dev]
    run = _Run(no_gc)
    o, tr, slo = run.o, run.tr, run.slo

    def build(scale: float):
        tree, roots = build_synthetic_tree(p=p, depth=depth, n_u=n_u)
        if scale != 1.0:
            # Exact power-of-two payload scaling: v2 = bitwise 2x v1.
            tree._pl_inputs[:] *= scale
            tree._pl_costs[:] *= scale
        table = export.export_leaves(tree)
        dt = descent.export_descent(tree, roots, table, stage=False)
        return sharded.shard_descent(dt, table, n_shards=n_shards,
                                     devices=devices, obs=o), table

    try:
        srv1, table1 = build(1.0)
        srv2, table2 = build(2.0)
        registry = ControllerRegistry(obs=o)
        v1 = registry.publish("bench", "v1", srv1)
        lb, ub = root_box(srv1)
        fallback = FallbackPolicy(lb, ub, obs=o)
        with tempfile.TemporaryDirectory(prefix="serve_bench_demand_") \
                as demand_dir:
            if demand_on:
                from explicit_hybrid_mpc_tpu_torch.obs import \
                    demand as demand_mod

                run.hub = demand_mod.DemandHub(
                    mode="on", max_leaves=1024, decay_halflife_s=300.0,
                    reservoir_k=64, subopt_frac=0.05, subopt_eps=1e-3,
                    snapshot_every_s=max(0.5, secs / 2),
                    snapshot_dir=demand_dir,
                    oracle=_RefOracle(registry, "bench",
                                      {"v1": table1, "v2": table2}),
                    obs=o)
            run.sched = sched = RequestScheduler(
                registry, "bench", max_batch=max_batch,
                max_wait_us=wait_us, fallback=fallback, obs=o,
                demand=run.hub, trace=tr, slo=slo)
            hub = run.hub
            # Every pow-2 bucket of both servers once before the sweep,
            # so no first use lands inside a measured window; then every
            # (program, shard, bucket) of each, since a batch that falls
            # mostly to one shard mints a shard bucket a uniform batch
            # does not (on the card: each graph's capture).
            wrng = np.random.default_rng(0)
            k = 1
            while k <= max_batch:
                warm = wrng.uniform(lb, ub, size=(k, p))
                srv1.evaluate(warm)
                srv2.evaluate(warm)
                k *= 2
            srv1.warm(max_batch)
            srv2.warm(max_batch)

            clients = _Clients(sched.submit, None,
                               _skew_sampler(skew, lb, ub), lb, ub,
                               outside_frac)
            swap: dict = {}

            def hot_swap(at: float) -> None:
                # Mid-run hot swap at the top offered rate.
                swap["at"] = at
                registry.publish("bench", "v2", srv2)

            run.start()
            per_rate, top_delta = _sweep(sched, clients, rates, n_clients,
                                         secs, o, tr, hot_swap,
                                         arena=False)
            drained = registry.wait_retired(v1, 10.0)

            def ab_window() -> float | None:
                # One top-rate closed-loop window; its request p99.
                lat: list[float] = []
                clients.window(rates[-1], n_clients, secs, lat, False)
                return _percentile_us(lat, 99) if lat else None

            # demand=on vs off at the top rate (post-swap, warm): the
            # capture sits after ticket scatter on the worker thread, so
            # the request p99 must not move (<= 1%).  Skew (capture)
            # mode only: ten extra windows.
            demand_ab = ([], [], None, None, None)
            if hub is not None and skew > 0:
                demand_ab = _ab_pairs(
                    ab_window, lambda: setattr(sched, "demand", None),
                    lambda: setattr(sched, "demand", hub))
            # trace=on vs off, the same protocol: stamps are raw
            # perf_counter_ns and the fold runs once a micro-batch, so
            # tracing must cost <= 1% of the traced-off p99.
            trace_ab = ([], [], None, None, None)
            if tr is not None and skew > 0:
                trace_ab = _ab_pairs(
                    ab_window, lambda: setattr(sched, "trace", None),
                    lambda: setattr(sched, "trace", tr))

            sweep_wall = run.stop()
            run.close_sched()
            host = run.host()
            if slo is not None:  # final fold: the last flush window's tail
                slo.tick(o.metrics.snapshot())

            # Demand epilogue: drain the subopt queue, publish the
            # snapshot and STRICT-load it back (a torn snapshot fails
            # here, not in the consumer).
            demand_row: dict = {}
            if hub is not None:
                from explicit_hybrid_mpc_tpu_torch.obs.demand import \
                    load_demand

                hub.drain_for_test()
                meta = hub.snapshot()["bench"]
                run.close_hub()
                snap = load_demand(os.path.join(demand_dir, "bench"))
                offs, ons, p99_off, p99_on, overhead = demand_ab
                demand_row = {
                    "demand_top_decile_frac": meta["top_decile_frac"],
                    "demand_leaves_observed": meta["leaves_observed"],
                    "demand_exceed_dims": meta["fallback"]["exceed_dims"],
                    "subopt_p50": meta["subopt"]["p50"],
                    "subopt_p99": meta["subopt"]["p99"],
                    "subopt_samples": meta["subopt"]["n_samples"],
                    "subopt_eps": meta["subopt"]["eps"],
                    "subopt_budget_spent": meta["subopt"]["n_offered"],
                    "demand_snapshot_strict": bool(
                        snap.meta["npz_sha256"] == meta["npz_sha256"]),
                    "serve_p99_off_us": p99_off,
                    "serve_p99_on_us": p99_on,
                    "demand_overhead_frac": overhead,
                }
                if offs or ons:
                    demand_row["demand_ab_windows"] = {"off": offs,
                                                       "on": ons}

        # Swap-atomicity audit: every top-rate in-box result equals ITS
        # version's reference bit for bit (v2 refs are exactly 2x v1's).
        records = clients.records
        torn = 0
        if records:
            thetas = np.stack([th for _n, th, _r in records])
            ref = srv1.evaluate(thetas)
            for k, (_n, _th, r) in enumerate(records):
                scale = 1.0 if r.version == "v1" else 2.0
                if not (np.array_equal(r.u, scale * ref.u[k])
                        and r.cost == scale * float(ref.cost[k])):
                    torn += 1

        fb_ms = o.metrics.snapshot()["counters"] if o.enabled else {}
        n_req = sched.n_requests
        n_fb = fb_ms.get("serve.fallback.requests", 0)
        top_row = per_rate[-1]
        toffs, tons, t_p99_off, t_p99_on, t_overhead = trace_ab
        result.update({
            "metric": _metric(f"serve p99 us (synthetic p={p} "
                              f"depth={depth} {n_shards} shards, "
                              f"closed-loop x{n_clients}",
                              result["platform"], host),
            "unit": "us p99",
            "serve_p99_us": top_row["p99_us"],
            "fallback_frac": round(n_fb / max(1, n_req), 4),
            "serve_qps": top_row["achieved_qps"],
            "serve_batch_fill": top_row["batch_fill"],
            "swap_dropped": len(clients.errors),
            "swap_torn": torn,
            "swap_drained": bool(drained),
            "swap_at_s": round(swap["at"], 3) if swap.get("at") else None,
            "versions_seen": sorted({r.version for _n, _t, r in records}),
            "requests": n_req,
            "batches": sched.n_batches,
            "rates": per_rate,
            "host": host,
            "errors": clients.errors[:5],
            "skew": skew,
            "config": {"p": p, "depth": depth, "n_u": n_u,
                       "n_shards": n_shards, "clients": n_clients,
                       "max_batch": max_batch, "max_wait_us": wait_us,
                       "outside_frac": outside_frac, "secs": secs,
                       "skew": skew, "demand": demand_on,
                       "trace": tr is not None, "no_gc": run.no_gc},
            **demand_row,
            **_trace_row(tr, o, top_delta, sweep_wall, run.gcrec,
                         run.no_gc, per_rate),
            "serve_p99_trace_off_us": t_p99_off,
            "serve_p99_trace_on_us": t_p99_on,
            "trace_overhead_frac": t_overhead,
            **({"trace_ab_windows": {"off": toffs, "on": tons}}
               if toffs or tons else {}),
            **_slo_row(slo, n_req, top_row["p99_us"]),
        })
    finally:
        run.close()


def run(out_path_: str | None = None, backend: str | None = None,
        no_gc: bool = False) -> dict:
    """One sweep (the arena mode when SERVE_BENCH_TENANTS > 0): the
    result, written to its JSON file, its history row appended.
    Refusals come first and write nothing: no card, a TPU asked for, a
    path under the JAX package's artifacts/, the JAX package's history
    file (SystemExit).  A card fault ends the run with the result's
    `error` (no history row); any other exception propagates."""
    result: dict = {bench_history.PACKAGE_KEY: bench_history.PACKAGE}
    dev = choose_device(result, backend, hold_capture_sentinel=False)
    out = out_path(out_path_, "SERVE_BENCH_OUT", "serve_bench.json",
                   "serve_bench")
    try:
        hist_path = bench_history.history_path()
    except ValueError as e:
        raise SystemExit(f"serve_bench: {e}")
    mode = run_arena if int(_env("SERVE_BENCH_TENANTS", 0, int)) > 0 \
        else run_legacy
    try:
        mode(result, dev, no_gc)
    except Exception as e:  # noqa: BLE001 -- only a card fault is caught
        if not card_fault(e):
            raise
        result["error"] = repr(e)
    with open(out, "w") as f:
        json.dump(result, f, indent=2)
    if hist_path is not None and "error" not in result:
        bench_history.append_history(result, out, path=hist_path,
                                     mtime=os.path.getmtime(out))
    return result


def bars(result: dict) -> list[str]:
    """The JAX script's main() bars, thresholds unchanged; the ones the
    result misses (empty: it holds them all).  A result with an
    `error` misses."""
    bad = []
    if "error" in result:
        return [f"error {result['error']}"]
    if not (result["swap_dropped"] == 0 and result["swap_torn"] == 0
            and result["swap_drained"]):
        bad.append(f"dropped {result['swap_dropped']}, torn "
                   f"{result['swap_torn']}, drained "
                   f"{result['swap_drained']}")
    if result.get("tenants"):
        # A mixed-tenant batch must fuse: strictly fewer launches than
        # requests at the top offered rate.
        if not (result["batch_launches_per_req"] or 1.0) < 1.0:
            bad.append(f"batch_launches_per_req "
                       f"{result['batch_launches_per_req']} (bar < 1)")
    elif not (result["serve_batch_fill"] or 0.0) >= 0.5:
        # Under saturating load the deadline must not flush near-empty
        # batches.
        bad.append(f"serve_batch_fill {result['serve_batch_fill']} "
                   "(bar >= 0.5)")
    if (result["config"].get("skew") or 0) > 0:
        # The sketch must measure the Zipf hot set, and the sampled
        # suboptimality sit under the eps budget.
        tdf = result.get("demand_top_decile_frac")
        if tdf is None or tdf < 0.7:
            bad.append(f"demand_top_decile_frac {tdf} (bar >= 0.7)")
        sp99 = result.get("subopt_p99")
        if result.get("subopt_samples") and (
                sp99 is None or sp99 > result.get("subopt_eps", 0.0)):
            bad.append(f"subopt_p99 {sp99} (bar <= "
                       f"{result.get('subopt_eps')})")
    for key, bar in (("demand_overhead_frac", 0.01),
                     ("trace_overhead_frac", 0.01),
                     ("slo_overhead_frac", 0.01)):
        v = result.get(key)
        if v is not None and v > bar:
            bad.append(f"{key} {v} (bar <= {bar})")
    errs = [r.get("phase_sum_err_frac") for r in result["rates"]]
    errs = [e for e in errs if e is not None]
    if errs and max(errs) > 0.02:
        bad.append(f"phase_sum_err_frac {max(errs)} (bar <= 0.02)")
    if result.get("trace_exemplar_p99_bound") is False:
        bad.append("the slowest exemplar is not bound to the p99 bucket")
    return bad


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m explicit_hybrid_mpc_tpu_torch.tools.serve_bench",
        description=__doc__.splitlines()[0])
    ap.add_argument("--backend", choices=("cuda", "cpu"), default=None,
                    help="'cuda' (the default, else BENCH_PLATFORM; "
                         "refuses to start without a card) or 'cpu'")
    ap.add_argument("--out", default=None,
                    help="the result's JSON (else SERVE_BENCH_OUT, else a "
                         "fresh temp dir)")
    ap.add_argument("--no-gc", action="store_true",
                    help="disable the collector for the sweep (also "
                         "SERVE_BENCH_NO_GC=1)")
    args = ap.parse_args(argv)
    result = run(args.out, args.backend, args.no_gc)
    print(json.dumps({k: v for k, v in result.items() if k != "rates"}),
          flush=True)
    for row in result.get("rates", []):
        print(json.dumps(row), file=sys.stderr)
    bad = bars(result)
    for b in bad:
        print(f"serve_bench: bar missed: {b}", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
