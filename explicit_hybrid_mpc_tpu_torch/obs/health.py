"""Streaming build-health watchdog: rolling SLO rules over obs records.

The torch port's counterpart of the JAX package's obs/health.py, with
the same rules, defaults, events and exit codes (tests/
test_torch_diagnostics.py feeds both monitors the same records and
compares their events bitwise).

A multi-hour build can go *sick* long before it goes down: regions/sec
stalls while the frontier churns, a divergence storm sends every cohort
cell into phase 2, tree warm-starts stop being accepted, one serving
shard carries 10x the load, or a competing process steals the host's
cores.  Each of those is visible in the obs stream, and this module
watches it, so a sick build does not burn its card allocation to the
end.

``HealthMonitor`` evaluates a rule set over the stream incrementally:
feed it records (``feed``), poll it for wall-clock stall
(``check_stall``), and it returns/emits structured ``health.*`` events
with a severity; ``worst`` aggregates into the exit-status contract
drivers act on (0 healthy, 1 warn, 2 critical).  In a build the
frontier engine feeds its own monitor (``cfg.health_rules`` with obs
on), and the first critical verdict opens the armed auto-profile
capture (``cfg.auto_profile``, obs/profiling.py).

Rule schema (all values floats; 0 disables a threshold rule):

=========================  =============================================
``stall_s``                no new record for this many wall seconds ->
                           ``health.stall`` (critical)
``window_steps``           build.step window for the rolling rates
``min_regions_per_s``      rolling throughput floor ->
                           ``health.throughput_low`` (warn)
``max_rescue_frac``        rescue / point solve delta between metric
                           snapshots -> ``health.rescue_storm`` (critical)
``max_phase2_survivor_frac``  two-phase survivors gauge (divergence
                           storm proxy) -> ``health.divergence_storm``
                           (critical)
``min_warmstart_accept``   accept-rate collapse (after
                           ``min_solves_for_rates`` point solves) ->
                           ``health.warmstart_collapse`` (warn)
``max_shard_imbalance``    serve.shard_imbalance gauge ->
                           ``health.shard_imbalance`` (warn)
``max_competing_cpu_frac`` host contention gauge ->
                           ``health.host_contended`` (warn); a host
                           whose /proc/stat reads no CPU time publishes
                           no gauge (obs/host.py), and an absent gauge
                           is "not measured": the rule never fires on
                           it
``max_device_failures``    device_failure records tolerated before
                           ``health.device_failures`` (warn)
``serve_p99_us``           serving p99 latency ceiling in microseconds
                           (per-controller serve.ctl.<name>.p99_us
                           gauges, serve/scheduler.py; legacy bare
                           serve.p99_us also evaluated) ->
                           ``health.serve_p99_us`` (warn); 0 = off
                           (the budget is deployment-specific)
``fallback_frac``          rolling degraded-mode fraction
                           (serve.ctl.<name>.fallback_frac gauges) ->
                           ``health.fallback_frac`` (warn) -- the
                           serving SLO from docs/serving.md
``max_queue_frac``         queue-dominated tail: queue phase's share
                           of request wall over the rolling window
                           (serve.ctl.<name>.queue_frac gauges,
                           obs/reqtrace.py; volume-gated like p99) ->
                           ``health.serve_queue`` (warn) -- the
                           "scale replicas, not kernels" signal; 0 =
                           off (the acceptable share is
                           deployment-specific)
``max_subopt``             measured serving suboptimality ceiling
                           (serve.ctl.<name>.subopt_p99 gauges from
                           the demand hub's online oracle re-solves,
                           obs/demand.py; volume-gated on the
                           ``.subopt_samples`` counter vs
                           ``min_subopt_samples``, its OWN gate -- the
                           sample budget is a tiny fraction of request
                           volume) -> ``health.subopt`` (warn); 0 =
                           off.  Set it to the build's eps budget:
                           the paper's certificate as a measured SLO.
                           The hub also emits its own in-stream
                           ``health.subopt`` events, which any monitor
                           ADOPTS; this rule is the external-tailer
                           (obs_watch) complement reading the gauge
``min_subopt_samples``     sample-volume floor for ``max_subopt``
                           (three lucky re-solves must not alarm a
                           fresh deploy)
``min_rebuild_reuse``      warm-rebuild reuse_frac floor
                           (rebuild.reuse_frac gauge, volume-gated on
                           ``min_rebuild_leaves`` prior leaves -- its
                           OWN gate, in leaves, not the solve-count
                           knob) -> ``health.rebuild_reuse_collapse``
                           (warn): a near-zero reuse on a large prior
                           tree signals a silently-drifted problem
                           hash -- the rebuild is paying cold-build
                           cost while reporting warm; 0 = off
``min_rebuild_leaves``     prior-leaf volume floor for the rule above
                           (a tiny prior legitimately invalidates
                           wholesale)
``max_staleness_s``        continuous-rebuild staleness ceiling in
                           wall seconds (lifecycle.staleness_p99_s
                           gauge, lifecycle/service.py; volume-gated
                           on the lifecycle.rebuilds counter) ->
                           ``health.staleness`` (warn); 0 = off (the
                           budget is deployment-specific, like
                           ``serve_p99_us``).  The daemon also emits
                           its own per-generation ``health.staleness``
                           SLA-miss events, which any monitor ADOPTS;
                           this rule is the external-tailer
                           (obs_watch) complement reading the rolling
                           gauge
``max_quarantine_frac``    quarantined cells (build.quarantined_cells,
                           faults/policy.py poison-cell quarantine) as
                           a fraction of all solved point+simplex
                           cells, volume-gated on
                           ``min_solves_for_rates`` ->
                           ``health.quarantine`` (critical): the
                           build is surviving by GIVING UP on cells
                           at scale -- solver infrastructure is
                           broken, not one poison cell
``slo_burn_fast``          error-budget burn-rate ceiling on the FAST
                           window pair (obs/slo.py ``slo.<spec>.
                           burn_fast`` gauges, published as the MIN
                           across the pair's 5m/1h windows) ->
                           ``health.slo_burn`` (critical): the budget
                           is burning fast enough to exhaust a 3-day
                           allowance in hours; 0 = off
``slo_burn_slow``          same over the SLOW 6h/3d pair
                           (``burn_slow`` gauges) ->
                           ``health.slo_burn`` (warn): a sustained
                           on-or-over-budget burn -- ticket, don't
                           page; 0 = off
``max_shard_straggle_frac``  FLEET rule (obs/fleet.py FleetMonitor):
                           concurrent
                           shards' regions/s spread, 1 - slowest /
                           fastest -> ``health.shard_straggle`` (warn)
                           -- faster shards idle on the straggler's
                           work every step.  Single-stream monitors
                           never evaluate it.
``fleet_stall``            FLEET rule: EVERY shard's stream silent
                           for this many wall seconds ->
                           ``health.fleet_stall`` (critical); a single
                           silent shard still fires the per-stream
                           ``stall_s`` rule with the shard named
``min_solves_for_rates``   rate rules stay silent below this volume
``metrics_every_steps``    engine-side feed cadence (frontier.py)
=========================  =============================================

Overrides travel as ``(name, value)`` pairs (``cfg.health_rules``, the
``--health-rule`` CLI flag, ``LONG_HEALTH_RULES``); unknown names raise
-- a typo'd rule silently never firing is the failure mode this module
exists to prevent.

Besides its own rules, the monitor ADOPTS ``health.*`` event records
already in the flow it is fed -- the serving layer emits
``health.lease_leak`` and ``health.oversized_batch``, the rebuild
service ``health.staleness``, and a tailed stream may carry another
monitor's findings -- folding their severity into ``worst`` so every
driver's exit code sees them.
"""

from __future__ import annotations

import collections
from typing import Iterable, Optional

DEFAULT_RULES: dict[str, float] = {
    "stall_s": 300.0,
    "window_steps": 50.0,
    "min_regions_per_s": 0.0,
    "max_rescue_frac": 0.25,
    "max_phase2_survivor_frac": 0.95,
    "min_warmstart_accept": 0.02,
    "max_shard_imbalance": 8.0,
    "max_competing_cpu_frac": 0.25,
    "max_device_failures": 3.0,
    "serve_p99_us": 0.0,
    "fallback_frac": 0.25,
    "max_queue_frac": 0.0,
    "max_subopt": 0.0,
    "min_subopt_samples": 20.0,
    "min_rebuild_reuse": 0.2,
    "min_rebuild_leaves": 500.0,
    "max_staleness_s": 0.0,
    "max_quarantine_frac": 0.02,
    # SLO burn-rate ceilings (obs/slo.py): the tracker publishes each
    # pair's burn gauge as the MIN across its two windows, so one
    # gauge compare here IS the both-windows alert condition.  The
    # tracker also emits its own rising-edge health.slo_burn events,
    # which any monitor ADOPTS; these rules are the external-tailer
    # (obs_watch) complement re-deriving the verdict from gauges.
    "slo_burn_fast": 14.4,
    "slo_burn_slow": 1.0,
    # Fleet-level rules (obs/fleet.py FleetMonitor; single-stream
    # monitors carry but never evaluate them, so one validated rule
    # vocabulary covers obs_watch with and without --fleet).
    "max_shard_straggle_frac": 0.5,
    "fleet_stall": 300.0,
    "min_solves_for_rates": 2000.0,
    "metrics_every_steps": 100.0,
}

_SEVERITY = {"ok": 0, "warn": 1, "critical": 2}

#: {rule: (severity-or-'config', one-line doc)} -- the discovery
#: catalog behind the JAX package's ``obs_watch --list-rules``.
#: 'config' marks knobs that gate/shape other rules rather than firing
#: themselves.  Kept next to DEFAULT_RULES so a new rule without a
#: catalog row fails the covering test, not discovery.
RULE_DOCS: dict[str, tuple[str, str]] = {
    "stall_s": ("critical", "no new obs record for this many wall "
                            "seconds (health.stall)"),
    "window_steps": ("config", "build.step window behind the rolling "
                               "throughput rate"),
    "min_regions_per_s": ("warn", "rolling regions/s floor "
                                  "(health.throughput_low); 0 = off"),
    "max_rescue_frac": ("critical", "rescue share of point solves per "
                                    "snapshot delta "
                                    "(health.rescue_storm)"),
    "max_phase2_survivor_frac": ("critical", "two-phase survivor gauge "
                                             "ceiling "
                                             "(health.divergence_storm)"),
    "min_warmstart_accept": ("warn", "tree warm-start accept-rate "
                                     "floor "
                                     "(health.warmstart_collapse)"),
    "max_shard_imbalance": ("warn", "serving shard max/mean load "
                                    "ceiling (health.shard_imbalance)"),
    "max_competing_cpu_frac": ("warn", "competing host CPU share "
                                       "ceiling "
                                       "(health.host_contended)"),
    "max_device_failures": ("warn", "device failures tolerated before "
                                    "health.device_failures"),
    "serve_p99_us": ("warn", "per-controller rolling p99 ceiling in "
                             "us (health.serve_p99_us); 0 = off"),
    "fallback_frac": ("warn", "per-controller degraded-serve fraction "
                              "ceiling (health.fallback_frac)"),
    "max_queue_frac": ("warn", "queue share of request wall ceiling "
                               "(health.serve_queue); 0 = off"),
    "max_subopt": ("warn", "measured serving subopt p99 ceiling vs "
                           "the eps certificate (health.subopt); "
                           "0 = off"),
    "min_subopt_samples": ("config", "sample-volume floor for "
                                     "max_subopt"),
    "min_rebuild_reuse": ("warn", "warm-rebuild reuse_frac floor "
                                  "(health.rebuild_reuse_collapse); "
                                  "0 = off"),
    "min_rebuild_leaves": ("config", "prior-leaf volume floor for "
                                     "min_rebuild_reuse"),
    "max_staleness_s": ("warn", "lifecycle staleness p99 ceiling in "
                                "wall seconds (health.staleness); "
                                "0 = off"),
    "max_quarantine_frac": ("critical", "quarantined share of all "
                                        "solved cells "
                                        "(health.quarantine)"),
    "slo_burn_fast": ("critical", "error-budget burn multiplier "
                                  "ceiling, fast 5m/1h pair "
                                  "(health.slo_burn); 0 = off"),
    "slo_burn_slow": ("warn", "error-budget burn multiplier ceiling, "
                              "slow 6h/3d pair (health.slo_burn); "
                              "0 = off"),
    "max_shard_straggle_frac": ("warn", "fleet regions/s spread "
                                        "ceiling "
                                        "(health.shard_straggle)"),
    "fleet_stall": ("critical", "every fleet shard silent for this "
                                "many seconds (health.fleet_stall)"),
    "min_solves_for_rates": ("config", "volume floor shared by the "
                                       "rate rules"),
    "metrics_every_steps": ("config", "engine-side monitor feed "
                                      "cadence in steps"),
}


def rules_from_pairs(pairs: Iterable[tuple[str, float]] | dict
                     ) -> dict[str, float]:
    """DEFAULT_RULES overridden by (name, value) pairs / a dict; raises
    on unknown rule names (see module docstring)."""
    out = dict(DEFAULT_RULES)
    items = pairs.items() if isinstance(pairs, dict) else pairs
    for k, v in items:
        if k not in DEFAULT_RULES:
            raise ValueError(
                f"unknown health rule {k!r} (known: "
                f"{', '.join(sorted(DEFAULT_RULES))})")
        out[k] = float(v)
    return out


class HealthMonitor:
    """Incremental rule evaluator (see module docstring).

    Events are plain dicts ``{"name": "health.<rule>", "severity":
    "warn"|"critical", "value": ..., "threshold": ..., "msg": ...}``;
    when built with a sink they are ALSO emitted into the stream as
    ``kind="event"`` records, so a health verdict is part of the run's
    own record.  Each rule emits at most one event per `refire_after`
    fed records (storms emit periodic reminders, not thousands of
    duplicates); `worst` still updates on every suppressed trigger."""

    def __init__(self, rules: Optional[dict] = None, sink=None,
                 refire_after: int = 50):
        self.rules = dict(DEFAULT_RULES)
        if rules:
            self.rules.update(rules_from_pairs(rules))
        self.sink = sink
        self.events: list[dict] = []
        self.worst = "ok"
        self._refire_after = refire_after
        self._cooldown: dict[str, int] = {}
        w = max(2, int(self.rules["window_steps"]))
        self._steps: collections.deque[tuple[float, float]] = \
            collections.deque(maxlen=w)
        self._prev_counters: dict[str, float] = {}
        self._n_device_failures = 0
        self.n_records = 0
        self.last_t: Optional[float] = None  # stream time of last record

    # -- event plumbing ----------------------------------------------------

    def _fire(self, rule: str, severity: str, value, threshold,
              msg: str, key: Optional[str] = None) -> Optional[dict]:
        """`key` widens the cooldown identity beyond the rule name
        (per-controller serving rules: one breaching controller's
        cooldown must not silence another's first event)."""
        key = key or rule
        if _SEVERITY[severity] > _SEVERITY[self.worst]:
            self.worst = severity
        if self._cooldown.get(key, 0) > 0:
            # Still cooling down: severity updated, no event.  The
            # cooldown is NOT refreshed here -- a persistent condition
            # must re-notify once per refire_after records, not fall
            # silent for the rest of the episode.
            return None
        self._cooldown[key] = self._refire_after
        ev = {"name": f"health.{rule}", "severity": severity,
              "value": value, "threshold": threshold, "msg": msg}
        self.events.append(ev)
        if self.sink is not None:
            self.sink.emit("event", ev["name"],
                           **{k: v for k, v in ev.items() if k != "name"})
        return ev

    def _tick_cooldowns(self) -> None:
        for k in list(self._cooldown):
            if self._cooldown[k] > 0:
                self._cooldown[k] -= 1

    # -- feeding -----------------------------------------------------------

    def feed(self, rec: dict) -> list[dict]:
        """Evaluate one obs record; returns newly fired events."""
        n0 = len(self.events)
        self.n_records += 1
        t = rec.get("t")
        if isinstance(t, (int, float)):
            self.last_t = float(t)
        kind, name = rec.get("kind"), rec.get("name")
        self._tick_cooldowns()
        if kind == "event" and name == "build.step":
            self._feed_step(rec)
        elif kind == "metrics":
            self._feed_metrics(rec)
        elif kind == "event" and isinstance(name, str) \
                and name.startswith("health.") \
                and rec.get("severity") in _SEVERITY:
            # A health verdict ALREADY IN the record flow -- the
            # frontier's recompile sentinel (health.recompile), or a
            # prior monitor's events when tailing a stream: adopt it.
            # Without this fold, an external tailer (obs_watch) would
            # read a stream full of in-build findings and still exit 0,
            # and the in-build monitor would never see guard events.
            sev = rec["severity"]
            if _SEVERITY[sev] > _SEVERITY[self.worst]:
                self.worst = sev
            self.events.append({
                "name": name, "severity": sev,
                "value": rec.get("value"),
                "threshold": rec.get("threshold"),
                "msg": rec.get("msg", "(external health event)")})
        elif kind == "event" and (name == "build.device_failure"
                                  or (name == "runlog"
                                      and "device_failure" in rec)):
            self._n_device_failures += 1
            lim = self.rules["max_device_failures"]
            if self._n_device_failures > lim:
                self._fire("device_failures", "warn",
                           self._n_device_failures, lim,
                           f"{self._n_device_failures} device failures "
                           f"(> {lim:.0f}); batches run on the CPU twin")
        return self.events[n0:]

    def _feed_step(self, rec: dict) -> None:
        t = rec.get("t")
        regions = rec.get("regions")
        if not isinstance(t, (int, float)) \
                or not isinstance(regions, (int, float)):
            return
        self._steps.append((float(t), float(regions)))
        floor = self.rules["min_regions_per_s"]
        if floor <= 0 or len(self._steps) < self._steps.maxlen:
            return
        (t0, r0), (t1, r1) = self._steps[0], self._steps[-1]
        if t1 <= t0:
            return
        rps = (r1 - r0) / (t1 - t0)
        if rps < floor:
            self._fire("throughput_low", "warn", round(rps, 3), floor,
                       f"rolling throughput {rps:.2f} regions/s over the "
                       f"last {len(self._steps)} steps (< {floor:g})")

    def _feed_metrics(self, rec: dict) -> None:
        counters = rec.get("counters", {}) or {}
        gauges = rec.get("gauges", {}) or {}
        min_n = self.rules["min_solves_for_rates"]
        points = counters.get("oracle.point_solves", 0)

        # Rescue storm: rescue share of point solves since the last
        # EVALUATED snapshot (snapshots are cumulative; the delta is
        # the window).  The baseline rolls forward only once a window
        # reached min_n -- resetting it on every snapshot would let a
        # low-volume snapshot cadence keep each window under the
        # threshold forever and the rule would silently never fire.
        d_res = (counters.get("oracle.rescue_solves", 0)
                 - self._prev_counters.get("oracle.rescue_solves", 0))
        d_pt = points - self._prev_counters.get("oracle.point_solves", 0)
        lim = self.rules["max_rescue_frac"]
        if lim > 0:
            if d_pt >= min_n:
                frac = d_res / d_pt
                if frac > lim:
                    self._fire(
                        "rescue_storm", "critical", round(frac, 4), lim,
                        f"rescue pass re-solved {100 * frac:.1f}% of "
                        f"the last {d_pt} point QPs (> {100 * lim:.0f}%)"
                        ": the configured schedule is missing broadly")
                self._prev_counters = dict(counters)
        else:
            self._prev_counters = dict(counters)

        lim = self.rules["max_phase2_survivor_frac"]
        surv = gauges.get("oracle.phase2_survivor_frac")
        if lim > 0 and surv is not None and points >= min_n \
                and surv > lim:
            self._fire("divergence_storm", "critical", round(surv, 4),
                       lim,
                       f"{100 * surv:.1f}% of two-phase cells survive "
                       f"phase 1 unconverged (> {100 * lim:.0f}%): the "
                       "cohort split is buying nothing / solves diverge")

        lim = self.rules["min_warmstart_accept"]
        acc = gauges.get("oracle.warmstart_accept_rate")
        # Gated on the attempts gauge, not the rate alone: an oracle
        # with warm_start off reports rate 0.0 forever, which is not a
        # collapse -- nothing was ever offered to the merit gate.
        attempts = gauges.get("oracle.warm_attempts", 0)
        if lim > 0 and acc is not None and attempts >= min_n \
                and acc < lim:
            self._fire("warmstart_collapse", "warn", round(acc, 4),
                       lim,
                       f"tree warm-start accept rate {acc:.3f} over "
                       f"{attempts:.0f} attempts (< {lim:g}): donors "
                       "rejected by the merit gate; every midpoint "
                       "starts cold")

        lim = self.rules["max_shard_imbalance"]
        imb = gauges.get("serve.shard_imbalance")
        if lim > 0 and imb is not None and imb > lim:
            self._fire("shard_imbalance", "warn", round(imb, 3), lim,
                       f"serving shard imbalance {imb:.2f}x max/mean "
                       f"(> {lim:g}): re-shard or deepen the cut")

        # Serving SLO rules, evaluated PER CONTROLLER over the
        # namespaced serve.ctl.<name>.* gauges (serve/scheduler.py):
        # several schedulers share one obs handle, and a healthy
        # controller's gauge must not mask a breaching one.  The
        # un-namespaced serve.* names from older streams still
        # evaluate.  Each controller is volume-gated on ITS request
        # counter like the build-side rate rules -- a three-request
        # smoke run must not trip a p99 alarm.
        prefixes = {"serve"}
        for key in gauges:
            if key.startswith("serve.ctl.") and (
                    key.endswith(".p99_us")
                    or key.endswith(".fallback_frac")
                    or key.endswith(".queue_frac")
                    or key.endswith(".subopt_p99")):
                prefixes.add(key.rsplit(".", 1)[0])
        for pre in sorted(prefixes):
            ctl = pre[len("serve.ctl."):] if pre != "serve" else ""
            tag = f" [controller {ctl!r}]" if ctl else ""
            n_req = counters.get(f"{pre}.requests", 0)
            lim = self.rules["serve_p99_us"]
            p99 = gauges.get(f"{pre}.p99_us")
            if lim > 0 and p99 is not None and n_req >= min_n \
                    and p99 > lim:
                self._fire("serve_p99_us", "warn", round(p99, 1), lim,
                           f"serving p99 {p99:.0f} us over the rolling "
                           f"window{tag} (> {lim:g} us): deadline "
                           "budget or shard placement needs retuning",
                           key=f"serve_p99_us:{ctl}")

            lim = self.rules["fallback_frac"]
            fb = gauges.get(f"{pre}.fallback_frac")
            if lim > 0 and fb is not None and n_req >= min_n \
                    and fb > lim:
                self._fire("fallback_frac", "warn", round(fb, 4), lim,
                           f"{100 * fb:.1f}% of recent queries served "
                           f"degraded{tag} (> {100 * lim:.0f}%): "
                           "traffic has left the certified box or the "
                           "tree has holes -- rebuild or widen the "
                           "partition", key=f"fallback_frac:{ctl}")

            # Queue-dominated tail (obs/reqtrace.py queue_frac: the
            # queue phase's share of request wall over the rolling
            # window).  When the tail is queueing, kernel and shard
            # tuning cannot move it -- the fix is capacity ("scale
            # replicas, not kernels").  Same volume gate as p99.
            lim = self.rules["max_queue_frac"]
            qf = gauges.get(f"{pre}.queue_frac")
            if lim > 0 and qf is not None and n_req >= min_n \
                    and qf > lim:
                self._fire("serve_queue", "warn", round(qf, 4), lim,
                           f"{100 * qf:.1f}% of request wall spent "
                           f"queued{tag} (> {100 * lim:.0f}%): the "
                           "tail is queue-dominated -- scale replicas "
                           "or raise max_batch, kernel tuning will "
                           "not move it", key=f"serve_queue:{ctl}")

            # Measured suboptimality SLO (obs/demand.py online
            # re-solves).  Gated on ITS OWN sample counter, not
            # n_req: the sampler re-solves a tiny deterministic
            # fraction of traffic, so min_solves_for_rates in
            # REQUESTS would keep the rule silent long after the
            # subopt estimate is statistically sound.
            lim = self.rules["max_subopt"]
            sp = gauges.get(f"{pre}.subopt_p99")
            n_sub = counters.get(f"{pre}.subopt_samples", 0)
            if lim > 0 and sp is not None \
                    and n_sub >= self.rules["min_subopt_samples"] \
                    and sp > lim:
                self._fire("subopt", "warn", round(sp, 6), lim,
                           f"measured serving suboptimality p99 "
                           f"{sp:.4g} over {n_sub:.0f} sampled "
                           f"re-solves{tag} (> {lim:g}): served "
                           "answers exceed the eps certificate -- "
                           "check artifact provenance / trigger a "
                           "rebuild", key=f"subopt:{ctl}")

        # SLO burn rate (obs/slo.py): the tracker publishes
        # slo.<spec>.burn_fast / .burn_slow as the MIN across each
        # pair's two windows, so a single gauge compare IS the
        # both-windows multi-burn-rate condition.  No volume gate:
        # burn is 0.0 by construction until a window holds units.
        for key, rule, sev in (("burn_fast", "slo_burn_fast",
                                "critical"),
                               ("burn_slow", "slo_burn_slow", "warn")):
            lim = self.rules[rule]
            if lim <= 0:
                continue
            suffix = f".{key}"
            for gname, v in gauges.items():
                if not (gname.startswith("slo.")
                        and gname.endswith(suffix)):
                    continue
                if v is None or v <= lim:
                    continue
                spec = gname[len("slo."):-len(suffix)]
                pair = "fast" if key == "burn_fast" else "slow"
                self._fire(
                    "slo_burn", sev, round(v, 3), lim,
                    f"slo {spec!r} burning {v:.1f}x its budget rate "
                    f"on both {pair}-pair windows (> {lim:g}x): see "
                    "the budget-exhaustion runbook in "
                    "docs/observability.md",
                    key=f"{rule}:{spec}")

        # Warm-rebuild reuse collapse: a near-zero reuse fraction on a
        # LARGE prior tree means the revision invalidated (almost)
        # everything -- most often a silently-drifted problem hash
        # (wrong prior artifact, unnoticed model change), i.e. the
        # rebuild pays cold-build cost while the operator believes it
        # is warm.  Volume-gated on its OWN leaf-count floor
        # (min_rebuild_leaves) -- the min_solves_for_rates knob is in
        # SOLVES and would silently disable this rule for mid-size
        # trees (and retune it whenever the solve knob moves).
        lim = self.rules["min_rebuild_reuse"]
        reuse = gauges.get("rebuild.reuse_frac")
        n_leaves = (counters.get("rebuild.leaves_reused", 0)
                    + counters.get("rebuild.leaves_invalidated", 0))
        if lim > 0 and reuse is not None \
                and n_leaves >= self.rules["min_rebuild_leaves"] \
                and reuse < lim:
            self._fire("rebuild_reuse_collapse", "warn", round(reuse, 4),
                       lim,
                       f"warm rebuild reused {100 * reuse:.1f}% of "
                       f"{n_leaves:.0f} prior leaves (< {100 * lim:.0f}"
                       "%): the revision invalidated nearly everything "
                       "-- check the prior artifact's provenance stamp "
                       "(a drifted problem hash makes every "
                       "certificate fail)")

        # Continuous-rebuild staleness (lifecycle/service.py): the
        # rolling p99 of revision-observed -> new-controller-live.
        # Volume-gated on at least one completed rebuild (the gauge
        # is meaningless before the first generation lands).
        lim = self.rules["max_staleness_s"]
        stale = gauges.get("lifecycle.staleness_p99_s")
        if lim > 0 and stale is not None \
                and counters.get("lifecycle.rebuilds", 0) >= 1 \
                and stale > lim:
            self._fire("staleness", "warn", round(stale, 3), lim,
                       f"rebuild staleness p99 {stale:.1f}s "
                       f"(> {lim:g}s): revisions are going live "
                       "slower than the SLA -- the daemon is falling "
                       "behind plant drift")

        # Quarantine storm (faults/policy.py): poison-cell quarantine
        # exists so ONE unrecoverable batch cannot kill a campaign --
        # but a meaningful FRACTION of all cells being given up on
        # means the solver infrastructure itself is broken (dead
        # device AND broken CPU twin, systematic timeout), and the
        # "surviving" build is quietly producing an
        # uncertified-riddled tree.  Critical: checkpoint-and-halt
        # beats burning the allocation.
        lim = self.rules["max_quarantine_frac"]
        q = counters.get("build.quarantined_cells", 0)
        denom = q + points + counters.get("oracle.simplex_solves", 0)
        if lim > 0 and q > 0 and denom >= min_n:
            frac = q / denom
            if frac > lim:
                self._fire(
                    "quarantine", "critical", round(frac, 4), lim,
                    f"{q} cells quarantined ({100 * frac:.1f}% of "
                    f"{denom} solved cells, > {100 * lim:.0f}%): "
                    "recovery is failing at scale -- check the "
                    "fallback oracle and the device, not the cells")

        lim = self.rules["max_competing_cpu_frac"]
        host = gauges.get("host.competing_cpu_frac_mean")
        if lim > 0 and host is not None and host > lim:
            self._fire("host_contended", "warn", round(host, 3), lim,
                       f"competing processes used {100 * host:.0f}% of "
                       f"host CPU (> {100 * lim:.0f}%): measurements "
                       "and the build itself are degraded")

    # -- wall-clock stall --------------------------------------------------

    def check_stall(self, idle_s: float) -> list[dict]:
        """Wall-based stall check, driven by the tailer: `idle_s` is
        how long the stream has produced NOTHING (no file growth).  A
        frozen stream means the build is hung (device wedge, deadlock)
        or dead without its atexit flush -- either way, critical."""
        lim = self.rules["stall_s"]
        if lim <= 0 or idle_s < lim:
            return []
        ev = self._fire("stall", "critical", round(idle_s, 1), lim,
                        f"no obs records for {idle_s:.0f}s "
                        f"(> {lim:.0f}s): build frozen or dead")
        return [ev] if ev else []

    # -- verdict -----------------------------------------------------------

    @property
    def exit_code(self) -> int:
        """0 healthy, 1 warn-level findings, 2 critical (the exit
        contract of every driver that acts on a verdict)."""
        return _SEVERITY[self.worst]

    def summary(self) -> dict:
        return {"worst": self.worst, "exit_code": self.exit_code,
                "n_records": self.n_records,
                "n_events": len(self.events),
                "events": list(self.events)}
