"""SLO engine: durable error budgets + multi-window burn-rate alerting.

The port's copy of the JAX package's obs/slo.py, host-only and
unchanged in behaviour: the state file's layout and checksum are the
same, so a budget saved by either package restores in the other, and
``evaluate()`` gives the same floats bit for bit.

The instantaneous alerts (obs/health.py rules, the rolling
``serve.ctl.*`` gauges with their 60 s max-age cut) can say "p99 is
over the line right now" but not "controller X has burned 80% of its
p99 budget", cannot keep that answer across a restart, and cannot tell
a 2-minute spike from a week-long degradation.  This module gives the
existing per-controller signals the TIME dimension:

``SloSpec`` declares one objective over a metric family the package
already emits, in one of three shapes:

- ``hist_p``: a cumulative histogram (e.g.
  ``serve.ctl.<name>.phase.wall_us``) whose snapshot-to-snapshot
  bucket-count DELTA is split at ``threshold`` -- buckets whose upper
  bound is <= threshold are good units, the rest bad (exact at a
  bucket boundary, conservative by at most one log bucket otherwise).
  Units are REQUESTS, so a single bad micro-batch weighs what it
  served.
- ``counter``: a bad-event counter vs. one or more total counters
  (``build.quarantined_cells`` vs solved cells,
  ``lifecycle.sla_misses`` vs ``lifecycle.rebuilds``,
  ``serve.ctl.<name>.fallbacks`` vs ``.requests``); good = total -
  bad per delta window.
- ``gauge``: one unit per tracker tick, good iff the gauge is <=
  ``threshold`` (``lifecycle.staleness_p99_s`` vs the SLA,
  ``serve.ctl.<name>.subopt_p99`` vs the eps certificate).  Absent
  gauge = no unit (a quiet stream spends no budget either way).

``SloTracker`` folds those deltas into a fixed-interval ring of
(good, bad) slots sized to the longest burn window.  The ring is
persisted through ``utils/atomic.py`` (checksummed payload behind the
tmp+fsync+rename commit) keyed by a caller-chosen IDENTITY, so a
budget survives process restarts and hot swaps bit for bit: the JSON
float round-trip is exact (repr).  Spec definitions ride along in the
state file, so objectives discovered at runtime (arena tenants) are
restored before any traffic arrives.

Burn-rate alerting follows the multi-window multi-burn-rate pattern:
burn = (bad / total) / (1 - goal) -- 1.0 means "spending exactly the
budget", 14.4 means "a 3-day budget gone in 5 hours".  A pair alert
fires only when burn exceeds the pair's threshold on BOTH its short
and long window: the short window makes the alert fast to clear, the
long window keeps a brief spike (which dilutes to nothing over the
long window) from paging anyone.  Defaults: fast pair 5m/1h at 14.4x
(critical), slow pair 6h/3d at 1.0x (warn); intervals and windows are
constructor-injectable so tests scale seconds down from days.  Firing
emits ``health.slo_burn`` events -- adopted by any HealthMonitor --
and publishes ``slo.<spec>.{good_units,bad_units}`` counters (the fleet
rollup sums them exactly across processes, obs/fleet.py) plus
``slo.<spec>.{compliance,budget_remaining_frac,burn_fast,burn_slow,
goal}`` gauges (the ``slo_burn_fast``/``slo_burn_slow`` health rules
re-derive the verdict from them).  The published ``burn_fast`` /
``burn_slow`` gauges are each the MIN across their pair's two
windows, so "gauge > threshold" IS the both-windows alert condition.

Wiring: both serve schedulers tick the tracker at their
METRICS_FLUSH_S cadence (off the request hot path -- the tracker
never sees an individual request) and the lifecycle service ticks at
its run- and watch-loop cadence.  Off mode is the hub pattern shared
with demand/trace: the factory returns None when the config knob is
off and the schedulers test ``self.slo is None``.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import math
import os
import threading
import time
from typing import Callable, Optional, Sequence

from explicit_hybrid_mpc_tpu_torch.utils import atomic

#: Persisted-state schema version (bump on incompatible change; a
#: mismatched file is rejected and the budget restarts empty -- loud,
#: via the slo.state_rejected event, never a crash).
STATE_VERSION = 1

#: (short_s, long_s) burn-window pairs: fast page-worthy pair, slow
#: ticket-worthy pair (multi-window multi-burn-rate).
DEFAULT_WINDOWS: tuple[tuple[float, float], ...] = (
    (300.0, 3600.0), (21600.0, 259200.0))

#: Burn multipliers per pair: 14.4x on 5m/1h spends a 3-day budget in
#: 5 hours; 1.0x on 6h/3d is "exactly on budget" sustained.
DEFAULT_BURN_THRESHOLDS: tuple[float, ...] = (14.4, 1.0)

_PAIR_NAMES = ("fast", "slow")
_PAIR_SEVERITY = ("critical", "warn")

_KINDS = ("hist_p", "counter", "gauge")


@dataclasses.dataclass(frozen=True)
class SloSpec:
    """One objective over an existing metric family (module docstring).

    ``name`` is the spec's slug in the ``slo.<name>.*`` metric
    namespace and the persisted state (dots allowed -- specs are
    conventionally ``<scope>.<objective>``, e.g. ``default.p99``).
    ``threshold`` is the good/bad boundary in the metric's own units
    (hist_p, gauge); ``total`` names the denominator counter(s) for
    kind='counter'."""

    name: str
    kind: str
    metric: str
    goal: float = 0.999
    threshold: float = 0.0
    total: tuple = ()
    description: str = ""

    def __post_init__(self) -> None:
        if self.kind not in _KINDS:
            raise ValueError(f"unknown slo kind {self.kind!r} "
                             f"(expected one of {_KINDS})")
        if not 0.0 < self.goal < 1.0:
            raise ValueError(f"goal must be in (0, 1), got {self.goal}")
        if self.kind in ("hist_p", "gauge") and self.threshold <= 0:
            raise ValueError(f"{self.kind} spec {self.name!r} needs "
                             "threshold > 0")
        if self.kind == "counter" and isinstance(self.total, str):
            # Tuple-normalize eagerly: a bare string would iterate
            # per-character and sum garbage counters silently.
            object.__setattr__(self, "total", (self.total,))
        if self.kind == "counter" and not self.total:
            raise ValueError(f"counter spec {self.name!r} needs at "
                             "least one total counter name")


class _SpecState:
    """Per-spec mutable state: the retention ring plus cumulative
    baselines for the snapshot-delta fold."""

    __slots__ = ("spec", "ring", "prev_counts", "prev_count",
                 "prev_counters", "good_total", "bad_total", "ms")

    def __init__(self, spec: SloSpec, n_slots: int):
        self.spec = spec
        self.ring: list[list[float]] = [[0.0, 0.0]
                                        for _ in range(n_slots)]
        self.prev_counts: Optional[list] = None  # hist_p baseline
        self.prev_count = 0
        self.prev_counters: dict[str, float] = {}  # counter baseline
        self.good_total = 0.0  # lifetime units (published counters)
        self.bad_total = 0.0
        self.ms: Optional[dict] = None  # lazily minted slo.* metrics


class SloTracker:
    """Durable error-budget accountant (module docstring).

    ``tick(snapshot)`` is the whole write API: the caller hands it the
    metrics snapshot it already produced (scheduler flush, lifecycle
    poll, checkpoint cadence) and the tracker folds deltas, advances
    the ring on interval boundaries (zero-filling gaps -- silence
    spends no budget), evaluates every window, publishes the ``slo.*``
    metric family, fires ``health.slo_burn`` on rising edges, and
    persists on slot advance.  ``total_tick_s`` accumulates the
    tracker's own thread-CPU cost (time.thread_time: a tick
    descheduled by the GIL under client load must not charge the
    clients' work to the fold) for the <=1%-of-p99 overhead gate."""

    enabled = True

    def __init__(self, specs: Sequence[SloSpec] = (), *,
                 interval_s: float = 60.0,
                 windows: Sequence = DEFAULT_WINDOWS,
                 burn_thresholds: Sequence[float] = DEFAULT_BURN_THRESHOLDS,
                 obs=None,
                 state_dir: Optional[str] = None,
                 identity: str = "default",
                 serve_template: Optional[dict] = None,
                 clock: Callable[[], float] = time.time):
        if interval_s <= 0:
            raise ValueError("interval_s must be > 0")
        windows = tuple((float(s), float(l)) for s, l in windows)
        if not windows:
            raise ValueError("need at least one (short, long) window pair")
        for s, l in windows:
            if not 0 < s < l:
                raise ValueError(f"window pair ({s}, {l}) needs "
                                 "0 < short < long")
            if s < interval_s:
                raise ValueError(f"short window {s} is finer than the "
                                 f"ring interval {interval_s}")
        burn_thresholds = tuple(float(b) for b in burn_thresholds)
        if len(burn_thresholds) != len(windows):
            raise ValueError("burn_thresholds must match windows 1:1")
        self.interval_s = float(interval_s)
        self.windows = windows
        self.burn_thresholds = burn_thresholds
        #: Budget window = the longest configured window (the slow
        #: pair's long side by default): compliance and
        #: budget_remaining_frac are computed over it.
        self.budget_window_s = max(l for _s, l in windows)
        self.n_slots = max(1, int(math.ceil(
            self.budget_window_s / self.interval_s)))
        self._obs = obs if (obs is not None
                            and getattr(obs, "enabled", False)) else None
        self.identity = str(identity)
        self.state_dir = state_dir
        self.serve_template = serve_template
        self._clock = clock
        self._lock = threading.Lock()
        self._specs: dict[str, _SpecState] = {}
        self._epoch: Optional[int] = None
        self._alerting: dict[tuple[str, int], bool] = {}
        self._serve_ctls: set[str] = set()
        self.total_tick_s = 0.0
        self.n_ticks = 0
        for sp in specs:
            self.add_spec(sp)
        if self.state_dir is not None:
            self._load_state()

    # -- spec management ---------------------------------------------------

    def add_spec(self, spec: SloSpec) -> None:
        """Register one objective (idempotent by name; late additions
        start with an empty ring -- no budget is invented)."""
        with self._lock:
            if spec.name not in self._specs:
                self._specs[spec.name] = _SpecState(spec, self.n_slots)

    @property
    def specs(self) -> tuple:
        with self._lock:
            return tuple(st.spec for st in self._specs.values())

    def _discover_serve_locked(self, snapshot: dict) -> None:
        """Auto-register serve specs for controllers appearing in the
        snapshot (the arena mints tenants lazily; a fixed spec list
        would miss every controller after the first)."""
        tpl = self.serve_template
        counters = snapshot.get("counters") or {}
        for key in counters:
            if not (key.startswith("serve.ctl.")
                    and key.endswith(".requests")):
                continue
            c = key[len("serve.ctl."):-len(".requests")]
            if c in self._serve_ctls:
                continue
            self._serve_ctls.add(c)
            for sp in serve_slo_specs(
                    c, p99_target_us=tpl["p99_target_us"],
                    goal=tpl["goal"],
                    subopt_eps=tpl.get("subopt_eps", 0.0)):
                if sp.name not in self._specs:
                    self._specs[sp.name] = _SpecState(sp, self.n_slots)

    # -- fold --------------------------------------------------------------

    def tick(self, snapshot: Optional[dict] = None,
             now: Optional[float] = None) -> Optional[dict]:
        """Fold one metrics snapshot into the rings and evaluate.

        `snapshot` is a ``MetricsRegistry.snapshot()``-shaped dict
        (the record ``Obs.flush_metrics`` returns qualifies); None
        takes a fresh snapshot from the tracker's obs handle.  Returns
        the evaluation (``summary()`` shape) or None when there was
        nothing to fold."""
        t0 = time.thread_time()
        try:
            if snapshot is None:
                if self._obs is None:
                    return None
                snapshot = self._obs.metrics.snapshot()
            if now is None:
                now = self._clock()
            with self._lock:
                if self.serve_template is not None:
                    self._discover_serve_locked(snapshot)
                advanced = self._advance(now)
                for st in self._specs.values():
                    self._fold(st, snapshot)
                report = self._evaluate_locked()
            self._publish(report)
            self._fire_burns(report)
            if advanced and self.state_dir is not None:
                self.save_state()
            return report
        finally:
            self.total_tick_s += time.thread_time() - t0
            self.n_ticks += 1

    def _advance(self, now: float) -> bool:
        """Roll the ring forward to `now`'s interval; gaps (restart
        downtime, idle streams) zero-fill -- time without traffic
        neither spends nor refunds budget."""
        e = int(now // self.interval_s)
        if self._epoch is None:
            self._epoch = e
            return False
        if e <= self._epoch:
            return False  # same slot (or an injected clock stepping back)
        steps = e - self._epoch
        for j in range(min(steps, self.n_slots)):
            slot = (self._epoch + 1 + j) % self.n_slots
            for st in self._specs.values():
                st.ring[slot][0] = 0.0
                st.ring[slot][1] = 0.0
        self._epoch = e
        return True

    def _fold(self, st: _SpecState, snapshot: dict) -> None:
        spec = st.spec
        good = bad = 0.0
        if spec.kind == "hist_p":
            h = (snapshot.get("histograms") or {}).get(spec.metric)
            if h is None:
                return
            counts = h["counts"]
            if st.prev_counts is None or h["count"] < st.prev_count \
                    or len(counts) != len(st.prev_counts):
                # First sight, or the registry restarted under us
                # (cumulative count went backwards): the snapshot IS
                # the new window.
                delta = list(counts)
            else:
                delta = [c - p for c, p in zip(counts, st.prev_counts)]
            st.prev_counts = list(counts)
            st.prev_count = h["count"]
            n_good = bisect.bisect_right(h["bounds"], spec.threshold)
            good = float(sum(delta[:n_good]))
            bad = float(sum(delta[n_good:]))
        elif spec.kind == "counter":
            counters = snapshot.get("counters") or {}
            cur_bad = float(counters.get(spec.metric, 0))
            cur_tot = float(sum(counters.get(t, 0) for t in spec.total))
            d_bad = cur_bad - st.prev_counters.get("bad", 0.0)
            d_tot = cur_tot - st.prev_counters.get("total", 0.0)
            if d_bad < 0 or d_tot < 0:  # registry restarted under us
                d_bad, d_tot = cur_bad, cur_tot
            st.prev_counters = {"bad": cur_bad, "total": cur_tot}
            bad = max(0.0, d_bad)
            good = max(0.0, d_tot - bad)
        else:  # gauge
            v = (snapshot.get("gauges") or {}).get(spec.metric)
            if v is None:
                return
            if float(v) <= spec.threshold:
                good = 1.0
            else:
                bad = 1.0
        if good == 0.0 and bad == 0.0:
            return
        slot = st.ring[self._epoch % self.n_slots]
        slot[0] += good
        slot[1] += bad
        st.good_total += good
        st.bad_total += bad

    # -- evaluation --------------------------------------------------------

    def _window_units(self, st: _SpecState,
                      window_s: float) -> tuple:
        k = min(self.n_slots,
                max(1, int(round(window_s / self.interval_s))))
        g = b = 0.0
        for j in range(k):
            slot = st.ring[(self._epoch - j) % self.n_slots]
            g += slot[0]
            b += slot[1]
        return g, b

    @staticmethod
    def _burn(good: float, bad: float, goal: float) -> float:
        total = good + bad
        if total <= 0:
            return 0.0
        return (bad / total) / (1.0 - goal)

    def _evaluate_locked(self) -> dict:
        report: dict = {}
        if self._epoch is None:
            return report
        for name, st in self._specs.items():
            spec = st.spec
            g_budget, b_budget = self._window_units(
                st, self.budget_window_s)
            total = g_budget + b_budget
            compliance = (g_budget / total) if total > 0 else 1.0
            allowed = (1.0 - spec.goal) * total
            # Capped at 1.0 from above by construction, deliberately
            # NOT clamped from below: overdraw reads as negative.
            budget_remaining = (1.0 - b_budget / allowed) \
                if allowed > 0 else 1.0
            burns = []
            for (short_s, long_s) in self.windows:
                bs = self._burn(*self._window_units(st, short_s),
                                spec.goal)
                bl = self._burn(*self._window_units(st, long_s),
                                spec.goal)
                burns.append(min(bs, bl))
            report[name] = {
                "goal": spec.goal,
                "good": g_budget,
                "bad": b_budget,
                "compliance": compliance,
                "budget_remaining_frac": budget_remaining,
                "burn_fast": burns[0],
                "burn_slow": burns[-1],
                "burns": burns,
            }
        return report

    def evaluate(self, now: Optional[float] = None) -> dict:
        """Read-only evaluation of the current rings (no fold, no
        events): {spec name: {goal, good, bad, compliance,
        budget_remaining_frac, burn_fast, burn_slow, burns}}."""
        with self._lock:
            if now is not None:
                self._advance(now)
            return self._evaluate_locked()

    summary = evaluate

    # -- publication -------------------------------------------------------

    def _publish(self, report: dict) -> None:
        if self._obs is None:
            return
        m = self._obs.metrics
        for name, row in report.items():
            st = self._specs[name]
            if st.ms is None:
                ns = f"slo.{name}"
                st.ms = {
                    "good": m.counter(f"{ns}.good_units"),
                    "bad": m.counter(f"{ns}.bad_units"),
                    "goal": m.gauge(f"{ns}.goal"),
                    "compliance": m.gauge(f"{ns}.compliance"),
                    "budget": m.gauge(f"{ns}.budget_remaining_frac"),
                    "burn_fast": m.gauge(f"{ns}.burn_fast"),
                    "burn_slow": m.gauge(f"{ns}.burn_slow"),
                }
            ms = st.ms
            # The published counters track the tracker's lifetime
            # totals (restored state included), re-expressed as
            # increments so fleet rollup can SUM final snapshots
            # across shards exactly.
            d_good = st.good_total - ms["good"].value
            d_bad = st.bad_total - ms["bad"].value
            if d_good > 0:
                ms["good"].inc(d_good)
            if d_bad > 0:
                ms["bad"].inc(d_bad)
            ms["goal"].set(row["goal"])
            ms["compliance"].set(row["compliance"])
            ms["budget"].set(row["budget_remaining_frac"])
            ms["burn_fast"].set(row["burn_fast"])
            ms["burn_slow"].set(row["burn_slow"])

    def _fire_burns(self, report: dict) -> None:
        """Rising-edge ``health.slo_burn`` events per (spec, pair).
        The published burn gauges keep the condition visible every
        tick; the event stream carries transitions, so a sustained
        breach pages once and a cleared-then-returned breach pages
        again.  Monitors ADOPT these (obs/health.py), and the
        slo_burn_fast/slo_burn_slow gauge rules re-derive the verdict
        for tailers that only see metric snapshots."""
        if self._obs is None:
            return
        for name, row in report.items():
            for i, thr in enumerate(self.burn_thresholds):
                key = (name, i)
                burning = thr > 0 and row["burns"][i] > thr
                was = self._alerting.get(key, False)
                self._alerting[key] = burning
                if burning and not was:
                    pair = _PAIR_NAMES[min(i, len(_PAIR_NAMES) - 1)]
                    sev = _PAIR_SEVERITY[min(i,
                                             len(_PAIR_SEVERITY) - 1)]
                    short_s, long_s = self.windows[i]
                    self._obs.event(
                        "health.slo_burn", severity=sev,
                        value=round(row["burns"][i], 3),
                        threshold=thr, spec=name,
                        identity=self.identity, window=pair,
                        budget_remaining_frac=round(
                            row["budget_remaining_frac"], 6),
                        msg=(f"slo {name!r} burning "
                             f"{row['burns'][i]:.1f}x budget rate on "
                             f"both the {short_s:g}s and {long_s:g}s "
                             f"windows (> {thr:g}x, {pair} pair); "
                             f"{100 * row['budget_remaining_frac']:.1f}"
                             "% of the error budget remains -- see "
                             "docs/observability.md "
                             "(budget-exhaustion runbook)"))

    # -- durability --------------------------------------------------------

    def _state_path(self) -> str:
        safe = self.identity.replace(os.sep, "_").replace("..", "_")
        return os.path.join(self.state_dir, f"slo.{safe}.state.json")

    def save_state(self) -> Optional[str]:
        """Commit the rings atomically (checksummed payload behind
        tmp+fsync+rename, utils/atomic.py).  Returns the path (None
        when no state_dir is configured)."""
        if self.state_dir is None:
            return None
        with self._lock:
            state = {
                "magic": "ehm-slo-state",
                "version": STATE_VERSION,
                "identity": self.identity,
                "interval_s": self.interval_s,
                "windows": [list(w) for w in self.windows],
                "epoch": self._epoch,
                "specs": {
                    name: {"spec": dataclasses.asdict(st.spec),
                           "ring": [list(s) for s in st.ring],
                           "good_total": st.good_total,
                           "bad_total": st.bad_total}
                    for name, st in self._specs.items()},
            }
        os.makedirs(self.state_dir, exist_ok=True)
        path = self._state_path()
        payload = json.dumps(state).encode("utf-8")
        atomic.atomic_write_bytes(path, atomic.checksummed(payload))
        return path

    def _load_state(self) -> bool:
        """Restore rings (and runtime-discovered spec definitions)
        from the committed snapshot; any rejection -- missing, torn,
        wrong version, mismatched geometry -- starts fresh and says
        why in the stream."""
        path = self._state_path()
        try:
            with open(path, "rb") as f:
                data = f.read()
        except FileNotFoundError:
            return False
        try:
            payload, _checked = atomic.verify_checksum(data, where=path)
            state = json.loads(payload)
        except (atomic.CorruptArtifact, ValueError) as e:
            self._event("slo.state_rejected", path=path, msg=repr(e))
            return False
        if state.get("magic") != "ehm-slo-state" \
                or state.get("version") != STATE_VERSION \
                or state.get("interval_s") != self.interval_s \
                or [list(w) for w in self.windows] \
                != state.get("windows"):
            self._event(
                "slo.state_rejected", path=path,
                msg="geometry/version mismatch: budget restarts empty")
            return False
        with self._lock:
            self._epoch = state.get("epoch")
            for name, sp_state in (state.get("specs") or {}).items():
                st = self._specs.get(name)
                if st is None:
                    # A spec the saver knew and we don't (runtime
                    # discovery, e.g. arena tenants): recreate it from
                    # the persisted definition so the budget is intact
                    # before its traffic reappears.
                    fields = sp_state.get("spec")
                    if not isinstance(fields, dict):
                        continue
                    try:
                        spec = SloSpec(**{
                            **fields,
                            "total": tuple(fields.get("total") or ())})
                    except (TypeError, ValueError):
                        continue
                    st = self._specs[name] = _SpecState(spec,
                                                        self.n_slots)
                ring = sp_state.get("ring")
                if isinstance(ring, list) and len(ring) == self.n_slots:
                    st.ring = [[float(g), float(b)] for g, b in ring]
                st.good_total = float(sp_state.get("good_total", 0.0))
                st.bad_total = float(sp_state.get("bad_total", 0.0))
        self._event("slo.state_restored", path=path,
                    identity=self.identity,
                    n_specs=len(state.get("specs") or {}))
        return True

    def _event(self, name: str, **fields) -> None:
        if self._obs is not None:
            self._obs.event(name, **fields)

    def flush(self) -> None:
        """Persist without waiting for the next slot advance (clean
        shutdown hook)."""
        if self.state_dir is not None:
            self.save_state()


# -- spec factories ---------------------------------------------------------


def serve_slo_specs(controller: str, *, p99_target_us: float,
                    goal: float = 0.999,
                    subopt_eps: float = 0.0) -> list:
    """Per-controller serving objectives over the namespaced families
    both schedulers already emit (serve/scheduler.py,
    obs/reqtrace.py):

    - ``<ctl>.p99``: request wall <= target, REQUEST-weighted from the
      ``phase.wall_us`` cumulative histogram (needs tracing=on;
      without it the spec simply accrues no units).
    - ``<ctl>.p99_roll``: the rolling ``p99_us`` gauge <= target, one
      unit per tick -- the tracing-off complement.
    - ``<ctl>.fallback``: served in-tree, from the ``fallbacks`` /
      ``requests`` counters.
    - ``<ctl>.subopt`` (when `subopt_eps` > 0): measured
      suboptimality p99 within the eps certificate (obs/demand.py).
    """
    ns = f"serve.ctl.{controller}"
    specs = [
        SloSpec(name=f"{controller}.p99", kind="hist_p",
                metric=f"{ns}.phase.wall_us", goal=goal,
                threshold=float(p99_target_us),
                description="request wall within the p99 target"),
        SloSpec(name=f"{controller}.p99_roll", kind="gauge",
                metric=f"{ns}.p99_us", goal=goal,
                threshold=float(p99_target_us),
                description="rolling p99 gauge within target"),
        SloSpec(name=f"{controller}.fallback", kind="counter",
                metric=f"{ns}.fallbacks", total=(f"{ns}.requests",),
                goal=goal,
                description="served in-tree (not degraded)"),
    ]
    if subopt_eps > 0:
        specs.append(SloSpec(
            name=f"{controller}.subopt", kind="gauge",
            metric=f"{ns}.subopt_p99", goal=goal,
            threshold=float(subopt_eps),
            description="measured suboptimality within eps"))
    return specs


def lifecycle_slo_specs(sla_s: float, goal: float = 0.999) -> list:
    """Continuous-rebuild objectives (lifecycle/service.py): the
    per-generation SLA-miss ratio plus the rolling staleness p99 vs
    the budget."""
    specs = [
        SloSpec(name="lifecycle.staleness", kind="counter",
                metric="lifecycle.sla_misses",
                total=("lifecycle.rebuilds",), goal=goal,
                description="generations live within the staleness SLA"),
    ]
    if sla_s > 0:
        specs.append(SloSpec(
            name="lifecycle.staleness_p99", kind="gauge",
            metric="lifecycle.staleness_p99_s", goal=goal,
            threshold=float(sla_s),
            description="rolling staleness p99 within the SLA"))
    return specs


def build_slo_specs(goal: float = 0.999) -> list:
    """Build-engine objective: quarantined cells as a share of all
    solved cells (the health max_quarantine_frac signal with budget
    semantics -- a campaign that gives up on cells at a sustained rate
    burns this budget even when each snapshot stays under the
    instantaneous threshold)."""
    return [
        SloSpec(name="build.quarantine", kind="counter",
                metric="build.quarantined_cells",
                total=("oracle.point_solves",
                       "oracle.simplex_solves"), goal=goal,
                description="cells solved without quarantine"),
    ]


# -- config factories -------------------------------------------------------


def slo_from_serve_config(cfg, obs=None) -> Optional["SloTracker"]:
    """Build a serving SloTracker from ServeConfig's slo knobs; None
    when off (the schedulers test ``slo is None``, mirroring
    trace_from_serve_config).  getattr-safe for configs pickled before
    the knobs existed."""
    mode = getattr(cfg, "slo", "off") or "off"
    if mode == "off":
        return None
    controller = getattr(cfg, "controller", "default")
    return SloTracker(
        interval_s=getattr(cfg, "slo_interval_s", 60.0),
        obs=obs,
        state_dir=getattr(cfg, "slo_dir", None),
        identity=f"serve.{controller}",
        serve_template={
            "p99_target_us": getattr(cfg, "slo_p99_target_us",
                                     50_000.0),
            "goal": getattr(cfg, "slo_goal", 0.999),
            "subopt_eps": getattr(cfg, "demand_subopt_eps", 0.0),
        })
