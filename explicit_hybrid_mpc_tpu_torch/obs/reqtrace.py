"""Serve-path request tracing: per-ticket critical-path attribution.

The torch port's copy of the JAX package's obs/reqtrace.py.  The build
side has a critical-path decomposition (``build.cp_{fill,plan,wait,
certify}_frac`` summing to ``step_s`` by construction); this module is
the serve-side mirror:

Stamp vector.  Each ticket carries monotonic ``time.perf_counter_ns``
stamps written raw on the hot path (no emission, no locks): ``submit``
and ``enqueue`` on the ticket itself (``Ticket.t_ns``), then
batch-scoped stamps taken by the scheduler worker at batch-seal,
lease-acquired, launch-entry, launch-return, fallback-end, and reply
(all tickets filled).  Phases are differences of adjacent stamps:

    queue    submit -> batch seal        (waiting for friends)
    seal     seal -> lease               (concat + lease acquisition)
    put      lease -> launch entry       (heartbeat/injection/prep)
    launch   launch entry -> return      (device round trip: the
                                          evaluator returns host arrays,
                                          after its synchronizing copy)
    fallback launch return -> fb end     (clamp/oracle accounting)
    reply    fb end -> all tickets filled (scatter + result build)

and sum to request wall (``reply_stamp - submit``) BY CONSTRUCTION --
``fold`` computes reply as the remainder, so the phase-sum==wall
invariant is arithmetic, not sampling (tests pin it for both
schedulers).  Histograms are microseconds under
``serve.ctl.<name>.phase.{queue,seal,put,launch,fallback,reply}_us``
plus the trace's own ``...phase.wall_us``; the per-controller
``serve.ctl.<name>.queue_frac`` gauge (queue share of wall over the
rolling window) is the "scale replicas, not kernels" signal.

Exemplar ring.  A bounded ring binds the K slowest requests per
rolling window to their full stamp vectors plus identity (tenant,
batch fill, version, arena extent, fallback tag), so a p99 bucket is
one lookup from a concrete trace.  The ring is single-writer by
construction (each scheduler worker owns its controllers' rings; the
only lock guards the rare per-controller mint) and readers snapshot a
shallow copy -- lock-free on the record path.

Host forensics.  ``GcPauseRecorder`` hooks ``gc.callbacks`` and emits
``serve.host.gc_pause_us`` events + histogram per collection, so
major-GC stalls are measured and attributed instead of hidden.  The
callback only records: a collection runs on whichever thread allocated,
possibly one holding that histogram's or the stream's lock, so the
events and the histogram are published from the recorder's own thread
(within PUBLISH_S) and at ``stop()``.
``ReqTrace.note_stall`` records scheduler flush-loop sleep overshoot
(the worker woke this much past its deadline -- host interference, not
queueing) into ``serve.host.stall_us``.

Off mode is a single attribute test in the scheduler (``self.trace is
None``) -- byte-for-byte no-op on the serve path.
"""

from __future__ import annotations

import gc
import threading
import time
from collections import deque
from typing import Callable, Optional

from explicit_hybrid_mpc_tpu_torch import obs as obs_lib

#: Phase names, in lifecycle order; histogram names are
#: ``serve.ctl.<name>.phase.<phase>_us``.
PHASES = ("queue", "seal", "put", "launch", "fallback", "reply")

#: Log-spaced bucket bounds for MICROSECOND-valued histograms (the obs
#: default bounds top out at 1e2 and are sized for second-valued
#: latencies): 5 buckets/decade over 0.1 us .. 10 s.
PHASE_BOUNDS_US = tuple(10.0 ** (e / 5.0) for e in range(-5, 36))

#: Stall overshoots below this are scheduler-timer granularity, not
#: host interference; recorded in the histogram but never evented.
STALL_EVENT_MIN_US = 1000.0

#: Minimum seconds between serve.host.stall_us events (the histogram
#: always observes; the event stream must not flood under sustained
#: interference).
_STALL_EVENT_EVERY_S = 1.0

#: Size cap on the per-controller queue_frac roll (entries are per
#: ticket): bounds memory when window_s outlives the traffic rate.
_ROLL_CAP = 1024


class _Ring:
    """Bounded keep-the-K-slowest exemplar ring over a rolling window.

    Single-writer (one scheduler worker); ``snapshot`` copies, so
    readers never block the record path.  O(K) per offer with K ~ 8.
    """

    __slots__ = ("k", "window_s", "_items")

    def __init__(self, k: int, window_s: float):
        self.k = int(k)
        self.window_s = float(window_s)
        self._items: list[tuple[float, float, dict]] = []

    def offer(self, t: float, wall_us: float, exemplar: dict) -> None:
        items = self._items
        cut = t - self.window_s
        if items and items[0][0] < cut:
            items[:] = [it for it in items if it[0] >= cut]
        if len(items) < self.k:
            items.append((t, wall_us, exemplar))
            return
        i_min = min(range(len(items)), key=lambda i: items[i][1])
        if wall_us > items[i_min][1]:
            items[i_min] = (t, wall_us, exemplar)

    def would_accept(self, t: float, wall_us: float) -> bool:
        """True iff `offer` could change the ring -- lets the fold
        path skip building the exemplar payload for the vast majority
        of requests (a full ring rejects everything under its min).
        Mirrors offer's prune condition exactly."""
        items = self._items
        if len(items) < self.k or items[0][0] < t - self.window_s:
            return True
        return wall_us > min(it[1] for it in items)

    def snapshot(self) -> list[dict]:
        return [it[2] for it in
                sorted(self._items, key=lambda it: -it[1])]


class _CtlTrace:
    """Per-controller trace state (phase histograms, queue_frac roll,
    exemplar ring).  Minted lazily; written only by the owning
    scheduler worker."""

    __slots__ = ("hists", "wall", "qf_gauge", "qf", "roll", "ring",
                 "w_sum", "q_sum")

    def __init__(self, hub: "ReqTrace", name: str):
        ns = f"serve.ctl.{name}"
        o = hub._obs
        self.hists = {
            ph: o.histogram(f"{ns}.phase.{ph}_us",
                            bounds=PHASE_BOUNDS_US)
            for ph in PHASES}
        self.wall = o.histogram(f"{ns}.phase.wall_us",
                                bounds=PHASE_BOUNDS_US)
        self.qf_gauge = o.gauge(f"{ns}.queue_frac")
        self.qf: Optional[float] = None
        # (t, wall_us, queue_us, k) per ticket entry; the queue_frac
        # gauge is computed over entries younger than window_s, via
        # running sums maintained on append/evict (a full recompute
        # over the capped roll costs more per fold than the whole
        # per-ticket observe path).
        self.roll: deque = deque()
        self.w_sum = 0.0
        self.q_sum = 0.0
        self.ring = _Ring(hub.exemplar_k, hub.window_s)


class ReqTrace:
    """Fold point for per-ticket stamp vectors (module docstring).

    One hub serves any number of schedulers; per-controller state is
    single-writer (the owning scheduler worker) and the only lock
    guards the rare controller mint.  ``mode='off'`` keeps
    ``enabled=False`` so schedulers drop the hub at construction --
    off costs one attribute test per batch."""

    def __init__(self, mode: str = "off", exemplar_k: int = 8,
                 window_s: float = 30.0,
                 obs: "obs_lib.Obs | None" = None,
                 clock: Callable[[], float] = time.monotonic):
        if mode not in ("off", "on"):
            raise ValueError(f"unknown tracing mode {mode!r} "
                             "(expected 'off' or 'on')")
        if exemplar_k < 1:
            raise ValueError("exemplar_k must be >= 1")
        if window_s <= 0:
            raise ValueError("window_s must be > 0")
        self.mode = mode
        self.enabled = mode == "on"
        self.exemplar_k = int(exemplar_k)
        self.window_s = float(window_s)
        self._obs = obs if obs is not None else obs_lib.NOOP
        self._clock = clock
        self._lock = threading.Lock()
        self._ctl: dict[str, _CtlTrace] = {}
        self._stall_h = self._obs.histogram("serve.host.stall_us",
                                            bounds=PHASE_BOUNDS_US)
        self._last_stall_evt = -float("inf")

    # -- hot-path fold (scheduler worker thread) ---------------------------

    def ctl(self, name: str) -> _CtlTrace:
        ct = self._ctl.get(name)
        if ct is None:
            with self._lock:
                ct = self._ctl.get(name)
                if ct is None:
                    ct = _CtlTrace(self, name)
                    self._ctl[name] = ct
        return ct

    def fold(self, controller: str, *, seal: int, lease: int,
             eval0: int, eval1: int, fb_end: int, done: int,
             rows, fill: float, version: Optional[str] = None,
             extent=None, stall_ns: int = 0) -> None:
        """Fold one micro-batch's stamps into phase histograms +
        exemplars.  ``rows`` is ``[(t_ns, k, fb_tag)]`` with ``t_ns``
        the ticket's ``(submit_ns, enqueue_ns)`` pair (rows whose
        ticket was submitted while tracing was detached carry None and
        must be filtered by the caller).  Batch-scoped stamps are
        perf_counter_ns ints; called once per (controller,
        micro-batch), never per row, never in traced code."""
        if seal <= 0:
            # Tracing was attached between this batch's collect and
            # serve (a caller flipped the hub live); no
            # seal stamp exists, so the decomposition would be
            # garbage -- drop the batch.
            return
        ct = self.ctl(name=controller)
        now = self._clock()
        seal_us = (lease - seal) / 1e3
        put_us = (eval0 - lease) / 1e3
        launch_us = (eval1 - eval0) / 1e3
        fb_us = (fb_end - eval1) / 1e3
        # Hot loop: per TICKET, only the three per-ticket phases are
        # observed (queue/reply/wall); the four batch-constant phases
        # fold once below with n=total_k -- identical histogram
        # contents, 4 fewer observe calls per ticket.
        h_queue = ct.hists["queue"]
        h_reply = ct.hists["reply"]
        h_wall = ct.wall
        ring = ct.ring
        roll = ct.roll
        total_k = 0
        for t_ns, k, tag in rows:
            submit_ns, enqueue_ns = t_ns
            wall_us = (done - submit_ns) / 1e3
            queue_us = (seal - submit_ns) / 1e3
            reply_us = wall_us - (queue_us + seal_us + put_us
                                  + launch_us + fb_us)
            h_queue.observe(queue_us, n=k)
            h_reply.observe(reply_us, n=k)
            h_wall.observe(wall_us, n=k)
            total_k += k
            roll.append((now, wall_us, queue_us, k))
            ct.w_sum += wall_us * k
            ct.q_sum += queue_us * k
            # The exemplar payload is only built when the ring would
            # keep it -- at steady state a full ring rejects all but
            # the slowest-K, and the dict build dominates the row.
            if ring.would_accept(now, wall_us):
                ring.offer(now, wall_us, {
                    "controller": controller,
                    "wall_us": round(wall_us, 3),
                    "stamps_us": {
                        "enqueue": round(
                            (enqueue_ns - submit_ns) / 1e3, 3),
                        "seal": round(queue_us, 3),
                        "lease": round(queue_us + seal_us, 3),
                        "put": round(queue_us + seal_us + put_us, 3),
                        "launch_return": round(
                            queue_us + seal_us + put_us + launch_us,
                            3),
                        "fallback_end": round(
                            wall_us - reply_us, 3),
                        "reply": round(wall_us, 3),
                    },
                    "rows": int(k),
                    "batch_fill": round(float(fill), 4),
                    "version": version,
                    "extent": extent,
                    "fallback": tag,
                })
        ct.hists["seal"].observe(seal_us, n=total_k)
        ct.hists["put"].observe(put_us, n=total_k)
        ct.hists["launch"].observe(launch_us, n=total_k)
        ct.hists["fallback"].observe(fb_us, n=total_k)
        # queue_frac over the non-stale rolling window -- the
        # queue-dominated signal (the JAX package's obs/health.py
        # max_queue_frac rule reads it).
        # Eviction (age OR the size cap) subtracts from the running
        # sums, so the gauge is O(evicted), not O(window).
        cut = now - self.window_s
        while roll and (roll[0][0] < cut or len(roll) > _ROLL_CAP):
            _t, w, q, k = roll.popleft()
            ct.w_sum -= w * k
            ct.q_sum -= q * k
        if not roll:
            ct.w_sum = 0.0  # rebase: kill float residue at idle
            ct.q_sum = 0.0
        elif ct.w_sum > 0:
            ct.qf = ct.q_sum / ct.w_sum
            ct.qf_gauge.set(ct.qf)
        if stall_ns > 0:
            self.note_stall(stall_ns)

    def note_stall(self, overshoot_ns: int) -> None:
        """Record a scheduler sleep overshoot (the worker woke
        `overshoot_ns` past its flush deadline).  Histogram always;
        event only past STALL_EVENT_MIN_US and rate-limited."""
        us = overshoot_ns / 1e3
        self._stall_h.observe(us)
        if us >= STALL_EVENT_MIN_US:
            now = self._clock()
            if now - self._last_stall_evt >= _STALL_EVENT_EVERY_S:
                self._last_stall_evt = now
                self._obs.event("serve.host.stall_us",
                                overshoot_us=round(us, 1))

    # -- read side ---------------------------------------------------------

    def queue_frac(self, controller: str) -> Optional[float]:
        """Last folded queue_frac for one controller (None before any
        traffic); O(1) -- safe to read per batch (the scheduler merges
        it into the serve.eval heartbeat)."""
        ct = self._ctl.get(controller)
        return ct.qf if ct is not None else None

    def exemplars(self, controller: Optional[str] = None) -> list[dict]:
        """Current slowest-K exemplars (slowest first), one controller
        or all.  Snapshot copy; never blocks the fold path."""
        if controller is not None:
            ct = self._ctl.get(controller)
            return ct.ring.snapshot() if ct is not None else []
        out = []
        for ct in list(self._ctl.values()):
            out.extend(ct.ring.snapshot())
        return sorted(out, key=lambda e: -e["wall_us"])

    def flush(self) -> None:
        """Emit per-controller exemplar digests into the event stream
        (called by the scheduler at its metrics-flush cadence, never
        per batch)."""
        if not self._obs.enabled:
            return
        for name, ct in list(self._ctl.items()):
            ex = ct.ring.snapshot()
            if ex:
                self._obs.event("serve.trace.exemplars",
                                controller=name, n=len(ex),
                                slowest=ex[:self.exemplar_k])


#: Longest a recorded collection waits for its event and histogram
#: observation (GcPauseRecorder's publishing thread).
PUBLISH_S = 0.25


class GcPauseRecorder:
    """``gc.callbacks``-based collection-pause recorder.

    Each collection emits a ``serve.host.gc_pause_us`` event (pause,
    generation, collected/uncollectable counts) and observes the
    same-named histogram, so a major-GC stall lands in the stream beside
    the requests it stretched instead of being hidden by
    ``gc.disable()``.  ``pauses`` / ``total_pause_s()`` give callers
    the aggregate without parsing the stream.  Reentrant-safe:
    start/stop are idempotent and the callback tolerates a missed
    start phase.

    The callback takes no lock: it appends to ``pauses`` and to a
    pending queue (list and deque appends hold none).  A collection can
    start inside any allocation, on a thread that holds the histogram's
    lock (its snapshot copies) or the stream's (an emit), and a callback
    that observed or emitted there would wait on that thread's own lock
    forever (the JAX package's recorder does, and so hung a serving
    bench).  The recorder's thread publishes the pending collections
    every PUBLISH_S, and ``stop()`` publishes the rest."""

    def __init__(self, obs: "obs_lib.Obs | None" = None):
        self._obs = obs if obs is not None else obs_lib.NOOP
        self._h = self._obs.histogram("serve.host.gc_pause_us",
                                      bounds=PHASE_BOUNDS_US)
        self._t0: Optional[int] = None
        self._installed = False
        self._pending: deque = deque()
        self._halt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.pauses: list[float] = []   # microseconds, per collection

    def start(self) -> "GcPauseRecorder":
        if not self._installed:
            gc.callbacks.append(self._cb)
            self._installed = True
            self._halt.clear()
            self._thread = threading.Thread(
                target=self._run, name="gc-pause-publish", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        if self._installed:
            try:
                gc.callbacks.remove(self._cb)
            except ValueError:
                pass
            self._installed = False
            self._halt.set()
            self._thread.join()
            self._thread = None
        self._publish()

    def _cb(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter_ns()
        elif phase == "stop" and self._t0 is not None:
            pause_us = (time.perf_counter_ns() - self._t0) / 1e3
            self._t0 = None
            self.pauses.append(pause_us)
            self._pending.append((pause_us, info.get("generation"),
                                  info.get("collected"),
                                  info.get("uncollectable")))

    def _run(self) -> None:
        while not self._halt.wait(PUBLISH_S):
            self._publish()

    def _publish(self) -> None:
        """The pending collections' histogram observations and events,
        outside any collection."""
        while self._pending:
            pause_us, gen, collected, uncollectable = \
                self._pending.popleft()
            self._h.observe(pause_us)
            self._obs.event("serve.host.gc_pause_us",
                            pause_us=round(pause_us, 1), generation=gen,
                            collected=collected,
                            uncollectable=uncollectable)

    def total_pause_s(self) -> float:
        return sum(self.pauses) / 1e6

    def __enter__(self) -> "GcPauseRecorder":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def trace_from_serve_config(cfg, obs: "obs_lib.Obs | None" = None
                            ) -> Optional[ReqTrace]:
    """Build a ReqTrace from ServeConfig's tracing knobs; None when
    off (the schedulers test ``trace is None``, so off costs
    nothing).  getattr-safe for configs pickled before the knobs
    existed."""
    mode = getattr(cfg, "tracing", "off") or "off"
    if mode == "off":
        return None
    return ReqTrace(
        mode=mode,
        exemplar_k=getattr(cfg, "trace_exemplar_k", 8),
        window_s=getattr(cfg, "trace_window_s", 30.0),
        obs=obs)
