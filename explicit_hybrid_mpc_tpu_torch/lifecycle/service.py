"""The continuous rebuild daemon: revisions in, live controllers out.

``RebuildService`` watches a ``RevisionSource`` (revision.py),
schedules warm rebuilds (partition/rebuild.py) under a wall-clock SLA,
publishes each generation as a DELTA-compressed artifact (delta.py,
full-artifact fallback), and hot-swaps it into a
``serve.ControllerRegistry`` (two-epoch handoff, serve/registry.py)
while traffic flows.  The
headline observable is END-TO-END STALENESS: revision observed ->
rebuilt controller live, measured per generation and rolled into
``lifecycle.staleness_p50_s`` / ``_p99_s`` gauges.

Scheduling semantics (the JAX package's docs/lifecycle.md):

- **Coalescing**: at most ONE revision per controller is ever queued;
  a newer revision of the same controller SUPERSEDES a queued older
  one (``lifecycle.revisions_superseded``) -- rebuilding against a
  stale intermediate revision would add a whole generation of
  staleness for a tree nobody wants.  The superseding revision keeps
  the OLDER observation time: the operator's staleness clock started
  when the plant first drifted away from the serving tree, not when
  the latest refinement of that drift was measured.
- **Priority**: workers claim the queued revision with the LEAST SLA
  headroom (oldest ``t_observed`` first) across controllers.
- **Bounded concurrency**: ``max_concurrent`` worker threads (default
  1 -- rebuilds are device-bound and two builds sharing one
  accelerator serialize anyway); a controller is never rebuilt by two
  workers at once.
- **SLA**: ``sla_s`` is a staleness budget, not a deadline scheduler:
  a generation that goes live past it emits ``health.staleness``
  (warn, adopted by any HealthMonitor / obs_watch) and counts
  ``lifecycle.sla_misses``.

Each generation chains the PREVIOUS generation's ``PartitionResult``
straight into ``warm_rebuild`` (no disk round-trip -- Tree.clone) and
appends a row to ``service.generations``: reuse_frac, ledger size,
staleness, delta-vs-full bytes.  Chained rebuilds keep the stage-2
fact ledger bounded (dead events pruned, duplicates collapsed);
tests/test_torch_lifecycle.py pins it on a drift walk.

Devices: every rebuild runs on ``build_cfg.backend``'s device (the
CUDA device by default), and the registry serves each published
generation on the same kind of device -- every CUDA device for a cuda
build, the CPU for a cpu or serial one.

Host forensics (obs/reqtrace.py): with obs on, GC pauses
(``serve.host.gc_pause_us``, GcPauseRecorder) and the watcher's sleep
overshoot past ``poll_s`` (``serve.host.stall_us``, ReqTrace.note_stall)
are recorded beside the ``lifecycle.*`` metrics, so a GC-stalled
rebuild worker is attributed to the host, not to the rebuild.

Error budgets and demand (obs/slo.py, obs/demand.py): with
``LifecycleConfig.slo`` and obs on, an ``SloTracker`` over the
lifecycle objectives (SLA-miss ratio, rolling staleness p99) ticks
from the watch loop and once more on ``close()``, and ``summary()``
carries its evaluation; with ``LifecycleConfig.demand_dir`` set, each
warm rebuild orders its invalidated leaves by the controller's latest
committed demand snapshot, hottest first (``lifecycle.demand_priority``
event).

Failure containment: a failed rebuild/publish (solver error,
provenance rejection, injected fault) leaves the PRIOR generation
serving and the prior result as the next chain link; the failure is
counted + evented and the daemon keeps running.  ``InjectedCrash``
(faults/plan.py) is deliberately NOT contained -- it must unwind like
the SIGKILL it stands for (the chaos drill asserts the old version
keeps serving).  Injection sites: ``lifecycle.revision`` (worker
picks up a revision) and ``lifecycle.publish_delta`` (between the
delta landing on disk and the swap).
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Optional

import numpy as np
import torch

from explicit_hybrid_mpc_tpu_torch import obs as obs_lib
from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
from explicit_hybrid_mpc_tpu_torch.faults import injector as faults_inj
from explicit_hybrid_mpc_tpu_torch.faults.plan import InjectedCrash
from explicit_hybrid_mpc_tpu_torch.lifecycle import delta as delta_mod
from explicit_hybrid_mpc_tpu_torch.lifecycle.revision import (
    Revision, RevisionSource)


@dataclasses.dataclass(frozen=True)
class LifecycleConfig:
    """Daemon knobs (distinct from PartitionConfig on purpose: these
    are SERVICE-scoped -- none of them can change a solved value, only
    when rebuilds run and how artifacts ship)."""

    #: Root directory for published artifacts:
    #: <root>/<controller>/<version>[.delta].
    artifacts_root: str = "artifacts/lifecycle"
    #: Staleness budget in wall seconds (revision observed -> new
    #: controller live); breaches emit health.staleness + count
    #: lifecycle.sla_misses.  <= 0 disables the alarm.
    sla_s: float = 600.0
    #: Revision-source poll cadence (the scheduler loop's idle sleep).
    poll_s: float = 0.05
    #: Rebuild worker threads (see module docstring).
    max_concurrent: int = 1
    #: Publish delta artifacts when a committed base exists (full
    #: fallback is automatic and counted).
    delta_publish: bool = True
    #: Refuse priors without a provenance stamp (rebuild strictness).
    strict_provenance: bool = False
    #: Re-anchor with a FULL artifact every K generations (0 = only
    #: when the delta path falls back).  Bounds the delta chain a
    #: cold-started replica must walk.
    full_every: int = 0
    #: Root of the serving fleet's demand snapshots
    #: (<demand_dir>/<controller>/demand.{npz,json}, obs/demand.py):
    #: when set, each warm rebuild loads the controller's latest
    #: committed snapshot, maps its hot leaf rows to tree node ids
    #: through the prior artifact's node_id.npy, and passes the
    #: result to ``warm_rebuild(priority=...)`` so live-traffic
    #: leaves re-certify first.  Best-effort: a missing/torn/stale
    #: snapshot degrades to the default node ordering.
    demand_dir: Optional[str] = None
    #: Attach an SloTracker (obs/slo.py) over the lifecycle metric
    #: family: per-generation SLA-miss ratio + rolling staleness p99
    #: as durable error budgets, ticked from the watch loop.  Needs
    #: an enabled obs handle to do anything.
    slo: bool = False
    #: Compliance goal for the lifecycle objectives.
    slo_goal: float = 0.999
    #: Retention-ring slot width (seconds) for the lifecycle budgets.
    slo_interval_s: float = 60.0
    #: Durable budget state directory (None = in-memory only).
    slo_dir: Optional[str] = None

    def __post_init__(self) -> None:
        if self.poll_s <= 0:
            raise ValueError("poll_s must be > 0")
        if self.max_concurrent < 1:
            raise ValueError("max_concurrent must be >= 1")
        if self.full_every < 0:
            raise ValueError("full_every must be >= 0 (0 = delta "
                             "whenever a base exists)")
        if not 0.0 < self.slo_goal < 1.0:
            raise ValueError("slo_goal must be in (0, 1)")
        if self.slo_interval_s <= 0:
            raise ValueError("slo_interval_s must be > 0")


class _ControllerState:
    """Per-controller chain state (owned by the service lock)."""

    __slots__ = ("prior", "prior_dir", "prior_version", "generation",
                 "in_flight", "queued")

    def __init__(self):
        self.prior = None          # last PartitionResult (chain link)
        self.prior_dir = None      # last FULL artifact dir (delta base)
        self.prior_version = None
        self.generation = 0
        self.in_flight = False
        self.queued: Optional[Revision] = None


class RebuildService:
    """The daemon (see module docstring).

    ``registry`` may be None (publish-to-disk only -- no serving
    fleet on this host); with a registry every generation hot-swaps
    under the controller's name.  ``prior`` seeds controller chains:
    a dict {controller: PartitionResult | path} or a single value for
    the default controller; revisions for a controller with no prior
    run a COLD build for generation 0.
    """

    def __init__(self, source: RevisionSource, build_cfg: PartitionConfig,
                 cfg: LifecycleConfig | None = None, registry=None,
                 prior=None, obs: "obs_lib.Obs | None" = None,
                 arena=None):
        self.source = source
        self.build_cfg = build_cfg
        self.cfg = cfg or LifecycleConfig()
        self.registry = registry
        #: Optional serve.DeviceArena: each published generation also
        #: hot-swaps into the device-resident arena (delta generations
        #: via the O(changed) publish_delta path).
        self.arena = arena
        self.obs = obs if obs is not None else obs_lib.NOOP
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        # obs Counters are single-producer by contract (obs/metrics.py)
        # and the watcher + max_concurrent workers all update the
        # lifecycle.* family: serialize metric writes.
        self._ms_lock = threading.Lock()
        self._ctl: dict[str, _ControllerState] = {}
        self._closed = False
        self._started = False
        # True while the watcher is between polling the source and
        # enqueueing what the poll returned: wait_idle() is not idle
        # then, so a caller that saw the source exhausted cannot find the
        # daemon idle before the last revision is queued (the JAX
        # package's service has this window).
        self._polling = False
        self._worker_error: Optional[BaseException] = None
        self._staleness: list[float] = []
        #: One row per completed generation, in completion order.
        self.generations: list[dict] = []
        self.n_failures = 0
        if isinstance(prior, dict):
            for name, p in prior.items():
                self._seed_prior(name, p)
        elif prior is not None:
            self._seed_prior("default", p=prior)
        self._ms = None
        if self.obs.enabled:
            m = self.obs.metrics
            self._ms = {
                "seen": m.counter("lifecycle.revisions_seen"),
                "superseded": m.counter("lifecycle.revisions_superseded"),
                "rebuilds": m.counter("lifecycle.rebuilds"),
                "failures": m.counter("lifecycle.rebuild_failures"),
                "pub_delta": m.counter("lifecycle.publishes_delta"),
                "pub_full": m.counter("lifecycle.publishes_full"),
                "fallbacks": m.counter("lifecycle.delta_fallbacks"),
                "sla": m.counter("lifecycle.sla_misses"),
                "stale_h": m.histogram("lifecycle.staleness_s"),
                "p50": m.gauge("lifecycle.staleness_p50_s"),
                "p99": m.gauge("lifecycle.staleness_p99_s"),
                "reuse": m.gauge("lifecycle.last_reuse_frac"),
                "gen": m.gauge("lifecycle.generation"),
                "dfrac": m.gauge("lifecycle.delta_bytes_frac"),
                "ledger": m.gauge("lifecycle.excl_events"),
                "depth": m.gauge("lifecycle.queue_depth"),
            }
        # Where the registry serves each generation: the build's kind
        # of device (None = every CUDA device; see the module docstring).
        self._serve_devices = ([torch.device("cpu")]
                               if build_cfg.backend in ("cpu", "serial")
                               else None)
        # Durable staleness error budget (obs/slo.py), ticked from the
        # watch loop at a bounded cadence; None when off -- the hub
        # pattern the schedulers use.
        self.slo = None
        if self.cfg.slo and self.obs.enabled:
            from explicit_hybrid_mpc_tpu_torch.obs import slo as slo_mod

            self.slo = slo_mod.SloTracker(
                slo_mod.lifecycle_slo_specs(self.cfg.sla_s,
                                            goal=self.cfg.slo_goal),
                interval_s=self.cfg.slo_interval_s, obs=self.obs,
                state_dir=self.cfg.slo_dir, identity="lifecycle")
        # Host forensics (obs/reqtrace.py): GC pauses and watcher sleep
        # overshoot are attributed to the HOST, so a GC-stalled rebuild
        # worker stops blaming the rebuild.
        self._gc_rec = None
        self._host_trace = None
        if self.obs.enabled:
            from explicit_hybrid_mpc_tpu_torch.obs import reqtrace as rt_mod

            self._gc_rec = rt_mod.GcPauseRecorder(obs=self.obs)
            self._host_trace = rt_mod.ReqTrace(mode="on", obs=self.obs)
        # Inherit an env/cfg fault plan exactly like the frontier
        # engine does (the chaos surface for subprocess daemons).
        faults_inj.install_from_config(build_cfg, obs=self.obs)
        self._watcher = threading.Thread(
            target=self._watch_loop, name="lifecycle-watch", daemon=True)
        self._workers = [
            threading.Thread(target=self._work_loop,
                             name=f"lifecycle-worker-{i}", daemon=True)
            for i in range(self.cfg.max_concurrent)]

    def _seed_prior(self, name: str, p) -> None:
        st = self._ctl.setdefault(name, _ControllerState())
        st.prior = p

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "RebuildService":
        if self._started:
            return self
        self._started = True
        if self._gc_rec is not None:
            self._gc_rec.start()
        self._watcher.start()
        for w in self._workers:
            w.start()
        return self

    def close(self, timeout: Optional[float] = 60.0) -> None:
        """Stop watching, let in-flight rebuilds finish, join."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if self._started:
            self._watcher.join(timeout)
            for w in self._workers:
                w.join(timeout)
        self.source.close()
        if self._gc_rec is not None:
            self._gc_rec.stop()
        if self.obs.enabled:
            rec = self.obs.flush_metrics()
            # Final budget fold + durable commit before the stream
            # closes, so a restarted service resumes the budget this
            # one actually earned.
            if self.slo is not None and rec is not None:
                self.slo.tick(rec)
        if self.slo is not None:
            self.slo.flush()

    def __enter__(self) -> "RebuildService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def wait_idle(self, timeout: float = 600.0,
                  target_generations: Optional[int] = None) -> bool:
        """Block until the queue is drained and no rebuild is in
        flight (or `target_generations` rows exist); False on
        timeout.  Surfaces a worker-killing error (InjectedCrash in
        the chaos drills) instead of spinning on a dead pool.

        With a target AND at least one contained failure, a
        persistently-idle daemon returns False after a short idle
        debounce instead of burning the whole timeout: the
        liveness-gated drift drivers count failures toward their
        emission gate, so a failed generation makes the target
        unreachable and only the failure count says so.  (The
        debounce, not bare idleness, is what keeps the brief
        between-generations gap of a gated walk from reading as
        exhaustion.)"""
        deadline = time.perf_counter() + timeout
        debounce = max(1.0, 5 * self.cfg.poll_s)
        idle_since: Optional[float] = None
        while time.perf_counter() < deadline:
            with self._lock:
                if self._worker_error is not None:
                    return False
                done = len(self.generations)
                failures = self.n_failures
                idle = not self._polling and not any(
                    st.queued or st.in_flight for st in self._ctl.values())
            if target_generations is not None:
                if done >= target_generations:
                    return True
                if idle and failures:
                    now = time.perf_counter()
                    if idle_since is None:
                        idle_since = now
                    elif now - idle_since >= debounce:
                        return False
                else:
                    idle_since = None
            elif idle:
                return True
            time.sleep(min(0.02, self.cfg.poll_s))
        return False

    @property
    def worker_error(self) -> Optional[BaseException]:
        return self._worker_error

    # -- watcher: source -> coalesced queue --------------------------------

    #: Watch-loop slo tick cadence (wall seconds): the budget fold is
    #: per-interval anyway, so ticking every poll (20 Hz default)
    #: would only burn snapshot walks.
    _SLO_TICK_S = 2.0

    def _watch_loop(self) -> None:
        last_tick = time.perf_counter()
        while True:
            with self._lock:
                if self._closed:
                    return
                self._polling = True
            try:
                revs = self.source.poll()
            # A flaky source must not kill the daemon: counted below.
            except Exception as e:  # noqa: BLE001
                revs = []
                self._count_failure(None, f"source poll failed: {e}")
            for rev in revs:
                self._enqueue(rev)
            with self._lock:
                self._polling = False
            if self.slo is not None:
                now = time.perf_counter()
                if now - last_tick >= self._SLO_TICK_S:
                    last_tick = now
                    rec = self.obs.flush_metrics()
                    if rec is not None:
                        self.slo.tick(rec)
            t_sleep = time.perf_counter()
            time.sleep(self.cfg.poll_s)
            if self._host_trace is not None:
                # Sleep-overshoot stall probe (the scheduler flush-loop
                # idiom): waking far past poll_s is host interference
                # -- GC, preemption -- not rebuild work, and it lands
                # in serve.host.stall_us instead of the staleness row.
                over = time.perf_counter() - t_sleep - self.cfg.poll_s
                if over > 0:
                    self._host_trace.note_stall(int(over * 1e9))

    def _enqueue(self, rev: Revision) -> None:
        with self._cond:
            st = self._ctl.setdefault(rev.controller, _ControllerState())
            old = st.queued
            if old is not None:
                # Coalesce: the newer revision supersedes, but keeps
                # the OLDER observation time (staleness is measured
                # from when the plant first drifted off the serving
                # tree, not from the latest refinement).
                rev = dataclasses.replace(rev,
                                          t_observed=old.t_observed)
            st.queued = rev
            depth = sum(1 for s in self._ctl.values() if s.queued)
            self._cond.notify()
        if self._ms:
            with self._ms_lock:
                self._ms["seen"].inc()
                self._ms["depth"].set(depth)
                if old is not None:
                    self._ms["superseded"].inc()
        self.obs.event("lifecycle.revision", controller=rev.controller,
                       seq=rev.seq, problem=rev.problem,
                       eps_a=rev.eps_a, note=rev.note,
                       superseded_seq=old.seq if old else None)

    # -- workers: claim -> rebuild -> publish -> swap ----------------------

    def _claim(self) -> Optional[tuple[str, Revision]]:
        """Least-SLA-headroom queued revision of an idle controller;
        blocks until one exists or the service closes."""
        with self._cond:
            while True:
                best, best_t = None, None
                for name, st in self._ctl.items():
                    if st.queued is not None and not st.in_flight:
                        t = st.queued.t_observed
                        if best_t is None or t < best_t:
                            best, best_t = name, t
                if best is not None:
                    st = self._ctl[best]
                    rev = st.queued
                    st.queued = None
                    st.in_flight = True
                    if self._ms:
                        with self._ms_lock:
                            self._ms["depth"].set(
                                sum(1 for s in self._ctl.values()
                                    if s.queued))
                    return best, rev
                if self._closed:
                    return None
                self._cond.wait(timeout=self.cfg.poll_s)

    def _work_loop(self) -> None:
        while True:
            claimed = self._claim()
            if claimed is None:
                return
            name, rev = claimed
            try:
                self._handle(name, rev)
            except InjectedCrash:
                # The SIGKILL stand-in: no containment layer may
                # swallow it -- record for wait_idle and unwind.
                with self._lock:
                    self._worker_error = InjectedCrash(
                        f"worker crashed on {name}#{rev.seq}")
                raise
            # Containment: the prior generation keeps serving.
            except Exception as e:  # noqa: BLE001
                self._count_failure(rev, str(e))
            finally:
                with self._cond:
                    self._ctl[name].in_flight = False
                    self._cond.notify_all()

    def _count_failure(self, rev: Optional[Revision], msg: str) -> None:
        with self._lock:
            self.n_failures += 1
        if self._ms:
            with self._ms_lock:
                self._ms["failures"].inc()
        self.obs.event(
            "lifecycle.rebuild_failed", severity="warn",
            controller=rev.controller if rev else None,
            seq=rev.seq if rev else None, msg=msg)

    def _handle(self, name: str, rev: Revision) -> None:
        from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
            build_partition, make_oracle)
        from explicit_hybrid_mpc_tpu_torch.partition.rebuild import (
            warm_rebuild)
        from explicit_hybrid_mpc_tpu_torch.problems.registry import make

        faults_inj.fire("lifecycle.revision",
                        label=f"{name}#{rev.seq}")
        t0 = time.perf_counter()
        with self._lock:
            st = self._ctl[name]
            prior = st.prior
            prior_dir = st.prior_dir
            gen = st.generation
        problem = make(rev.problem, **dict(rev.problem_args))
        cfg2 = dataclasses.replace(
            self.build_cfg, problem=rev.problem,
            problem_args=rev.problem_args, eps_a=rev.eps_a,
            eps_r=rev.eps_r)
        oracle = make_oracle(problem, cfg2)
        if prior is None:
            res = build_partition(problem, cfg2, oracle=oracle,
                                  obs=self.obs)
            reuse = None
        else:
            priority = self._demand_priority(name, prior_dir)
            res = warm_rebuild(
                problem, cfg2, prior, oracle=oracle, obs=self.obs,
                strict_provenance=self.cfg.strict_provenance,
                priority=priority)
            reuse = res.stats.get("rebuild_reuse_frac")
            if priority:
                self.obs.event(
                    "lifecycle.demand_priority", controller=name,
                    seq=rev.seq, hot_nodes=len(priority),
                    hinted=res.stats.get("rebuild_priority_hint"))
        rebuild_s = time.perf_counter() - t0
        row = self._publish(name, rev, res, gen)
        staleness = time.perf_counter() - rev.t_observed
        row.update(
            controller=name, seq=rev.seq, generation=gen,
            reuse_frac=reuse, rebuild_wall_s=round(rebuild_s, 3),
            staleness_s=round(staleness, 3),
            excl_events=len(res.tree.excl_events),
            subdivision_solves=res.stats.get("subdivision_solves"),
            recert_solves=res.stats.get("recert_solves"),
            regions=res.stats.get("regions"), note=rev.note)
        with self._lock:
            st.prior = res
            st.generation = gen + 1
            self._staleness.append(staleness)
            stale = np.asarray(self._staleness)
            self.generations.append(row)
        p50 = float(np.percentile(stale, 50))
        p99 = float(np.percentile(stale, 99))
        if self._ms:
            with self._ms_lock:
                self._ms["rebuilds"].inc()
                self._ms["stale_h"].observe(staleness)
                self._ms["p50"].set(p50)
                self._ms["p99"].set(p99)
                if reuse is not None:
                    self._ms["reuse"].set(reuse)
                self._ms["gen"].set(gen + 1)
                self._ms["ledger"].set(len(res.tree.excl_events))
        self.obs.event("lifecycle.rebuilt", controller=name,
                       seq=rev.seq, generation=gen,
                       reuse_frac=reuse,
                       staleness_s=round(staleness, 3),
                       published=row.get("published"),
                       version=row.get("version"),
                       delta_bytes=row.get("delta_bytes"),
                       full_bytes=row.get("full_bytes"))
        if 0 < self.cfg.sla_s < staleness:
            if self._ms:
                with self._ms_lock:
                    self._ms["sla"].inc()
            # health.* event: adopted by any HealthMonitor fed this
            # stream (obs/health.py), so obs_watch exits nonzero.
            self.obs.event(
                "health.staleness", severity="warn",
                value=round(staleness, 3), threshold=self.cfg.sla_s,
                controller=name,
                msg=f"generation {gen} of {name!r} went live "
                    f"{staleness:.1f}s after its revision was "
                    f"observed (SLA {self.cfg.sla_s:g}s): the rebuild "
                    "pipeline is not keeping up with plant drift")

    def _demand_priority(self, name: str,
                         prior_dir: Optional[str]
                         ) -> Optional[dict[int, float]]:
        """{node id: hits} hint from the controller's latest committed
        demand snapshot (cfg.demand_dir), mapped through the PRIOR
        artifact's node_id.npy -- the table the serving leaf rows
        index.  Best-effort by contract: no snapshot dir, a torn
        snapshot, or a missing prior artifact all return None (the
        rebuild proceeds in default node order)."""
        if self.cfg.demand_dir is None or prior_dir is None:
            return None
        from explicit_hybrid_mpc_tpu_torch.obs import demand as demand_mod
        try:
            snap = demand_mod.load_demand(
                os.path.join(self.cfg.demand_dir, name))
            node_id = np.load(os.path.join(prior_dir, "node_id.npy"))
            pr = demand_mod.priority_from_snapshot(snap, node_id)
        # The hint is best-effort: evented below, never fatal.
        except Exception as e:  # noqa: BLE001
            self.obs.event("lifecycle.demand_priority_skipped",
                           controller=name, msg=repr(e))
            return None
        return pr or None

    def _publish(self, name: str, rev: Revision, res, gen: int) -> dict:
        """Delta-compressed publish + hot swap; returns the byte
        accounting row.  The delta path: write the delta dir, fire the
        crash site, APPLY it against the base (the replica sync path,
        exercised live), and swap the APPLIED directory in -- so what
        serves is provably what a delta-syncing replica would load."""
        from explicit_hybrid_mpc_tpu_torch.serve import registry as reg_mod

        stamp = getattr(res.tree, "provenance", None)
        version = f"g{gen:04d}"
        if stamp is not None:
            version += f"-{stamp['problem_hash'][:8]}"
        root = os.path.join(self.cfg.artifacts_root, name)
        full_dir = os.path.join(root, version)
        with self._lock:
            st = self._ctl[name]
            base_dir, base_version = st.prior_dir, st.prior_version
        force_full = (self.cfg.full_every > 0
                      and gen % self.cfg.full_every == 0)
        published = "full"
        delta_bytes = None
        if (self.cfg.delta_publish and base_dir is not None
                and not force_full):
            delta_dir = full_dir + ".delta"
            try:
                dstats = delta_mod.write_delta_artifact(
                    res.tree, res.roots, delta_dir, base_dir,
                    base_version=base_version, provenance=stamp)
                # THE crash window: delta on disk, swap not yet run.
                faults_inj.fire("lifecycle.publish_delta",
                                label=f"{name}:{version}")
                delta_mod.apply_delta(delta_dir, base_dir, full_dir)
                published = "delta"
                delta_bytes = dstats["delta_bytes"]
            except delta_mod.DeltaMismatch as e:
                if self._ms:
                    with self._ms_lock:
                        self._ms["fallbacks"].inc()
                self.obs.event("lifecycle.delta_fallback",
                               controller=name, version=version,
                               msg=str(e))
        if published == "full":
            reg_mod.save_artifacts(res.tree, res.roots, full_dir,
                                   provenance=stamp)
        full_bytes = delta_mod.delta_size_bytes(full_dir)
        if self.registry is not None:
            self.registry.load_artifacts(name, version, full_dir,
                                         expect_provenance=stamp,
                                         devices=self._serve_devices)
        if self.arena is not None:
            # Device-resident fleet path: delta generations swap in
            # O(changed) (kept columns device-gathered from the
            # resident base extent); anything the arena cannot delta
            # against (first generation, non-resident base) loads full.
            try:
                if published == "delta":
                    self.arena.publish_delta(
                        name, version, full_dir + ".delta", base_dir)
                else:
                    self.arena.publish_from_artifacts(
                        name, version, full_dir)
            except delta_mod.DeltaMismatch:
                self.arena.publish_from_artifacts(name, version,
                                                  full_dir)
        with self._lock:
            st.prior_dir = full_dir
            st.prior_version = version
        if self._ms:
            with self._ms_lock:
                self._ms["pub_delta" if published == "delta"
                         else "pub_full"].inc()
                if delta_bytes is not None and full_bytes:
                    self._ms["dfrac"].set(delta_bytes / full_bytes)
        self.obs.event("lifecycle.published", controller=name,
                       version=version, published=published,
                       delta_bytes=delta_bytes, full_bytes=full_bytes,
                       dir=full_dir)
        return {"version": version, "published": published,
                "delta_bytes": delta_bytes, "full_bytes": full_bytes,
                "artifact_dir": full_dir}

    # -- reporting ---------------------------------------------------------

    def summary(self) -> dict:
        """Aggregate lifecycle report (the CLI/bench surface)."""
        with self._lock:
            gens = list(self.generations)
            stale = list(self._staleness)
            failures = self.n_failures
        reuse = [g["reuse_frac"] for g in gens
                 if g.get("reuse_frac") is not None]
        # Monotone-reported decay: the running MIN of per-generation
        # reuse -- by construction non-increasing, so a report reader
        # sees the worst decay so far, never a lucky generation
        # masking an earlier collapse.
        decay = list(np.minimum.accumulate(reuse)) if reuse else []
        deltas = [g for g in gens if g.get("published") == "delta"]
        dfracs = [g["delta_bytes"] / g["full_bytes"] for g in deltas
                  if g.get("delta_bytes") and g.get("full_bytes")]
        slo = self.slo.summary() if self.slo is not None else None
        return {
            "slo": slo,
            "generations": len(gens),
            "failures": failures,
            "staleness_p50_s": (round(float(np.percentile(stale, 50)), 3)
                                if stale else None),
            "staleness_p99_s": (round(float(np.percentile(stale, 99)), 3)
                                if stale else None),
            "reuse_fracs": [round(float(r), 4) for r in reuse],
            "reuse_decay": [round(float(r), 4) for r in decay],
            "excl_events": [g["excl_events"] for g in gens],
            "delta_publishes": len(deltas),
            "full_publishes": sum(1 for g in gens
                                  if g.get("published") == "full"),
            "delta_bytes_frac": (round(float(np.mean(dfracs)), 4)
                                 if dfracs else None),
        }
