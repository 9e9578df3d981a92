"""Deadline-aware request schedulers: queue -> micro-batch -> device.

A stream of independent control queries (one state estimate each, or a
small burst from a multi-plant client) must become DEVICE BATCHES to
amortize dispatch overhead -- but a control loop has a deadline, so a
query cannot sit in the queue waiting for friends forever:

- ``submit`` / ``submit_batch`` enqueue onto a thread-safe queue and
  return a ticket; ``Ticket.result(timeout)`` blocks the caller.
- A worker thread flushes a micro-batch when EITHER the queue holds
  ``max_batch`` rows OR the oldest queued row has waited
  ``max_wait_us`` -- the deadline budget.

Two front ends, the counterparts of the JAX package's
serve/scheduler.py:

- ``RequestScheduler`` serves ONE controller name of a
  ``ControllerRegistry`` (serve/registry.py): every micro-batch runs
  under one registry lease (one tree version, tagged on every result),
  through the sharded descent evaluator (online/sharded.py, batches
  padded to its power-of-two buckets), and its not-inside rows go
  through ``FallbackPolicy.apply`` (clamp, optional budgeted oracle
  re-solve) before results scatter back to tickets.
- ``ArenaScheduler`` serves every tenant of a ``DeviceArena`` from one
  queue, one fused kernel launch per mixed-tenant micro-batch.

Demand capture, request tracing and SLO tracking (ROADMAP A5/A2) are not
ported: their hooks accept only None.

Observability: per-controller ``serve.ctl.<name>.*`` metrics (the
request scheduler's latency histogram, queue-depth / batch-fill /
rolling p99 / fallback-fraction gauges, request / batch / fallback
counters), ``serve.arena.*`` gauges and histograms, and the
cross-controller ``serve.requests`` / ``serve.batches`` aggregate
counters; each worker flushes a metrics snapshot into the stream every
``METRICS_FLUSH_S`` seconds of traffic, and each scheduler announces
itself with a ``serve.replica`` event.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import threading
import time
from collections import deque
from typing import Optional

import numpy as np

from explicit_hybrid_mpc_tpu_torch import config as config_mod
from explicit_hybrid_mpc_tpu_torch import obs as obs_lib
from explicit_hybrid_mpc_tpu_torch.faults import injector as faults_inj
from explicit_hybrid_mpc_tpu_torch.online.sharded import _bucket

#: Rolling window (requests) behind the p99_us / fallback_frac
#: gauges: large enough to smooth batch quantization, small enough that
#: an SLO breach surfaces within seconds at production rates.
_ROLL_WINDOW = 1024

#: Max age (seconds) of a rolling-window sample: after a traffic lull
#: the fixed window would otherwise serve an arbitrarily old p99 on the
#: first post-lull batch.
_ROLL_MAX_AGE_S = 60.0

#: Minimum seconds between metrics-snapshot flushes from the worker
#: loop (serving has no step counter, so the cadence is wall time
#: under traffic; an idle scheduler writes nothing).
METRICS_FLUSH_S = 2.0

#: Guards the cross-controller aggregate counters (serve.requests /
#: serve.batches): obs Counters are single-producer by contract, and
#: several schedulers' threads share these two names.
_AGG_LOCK = threading.Lock()

def _prune_stale(lat_roll: deque, fb_roll: deque, now: float) -> None:
    """Drop rolling-window samples older than _ROLL_MAX_AGE_S (entries
    are (perf_counter, value) tuples, appended in time order)."""
    cut = now - _ROLL_MAX_AGE_S
    while lat_roll and lat_roll[0][0] < cut:
        lat_roll.popleft()
    while fb_roll and fb_roll[0][0] < cut:
        fb_roll.popleft()


@dataclasses.dataclass(frozen=True)
class ServeResult:
    """One request's answer (host scalars/arrays; the serving boundary).

    ``fallback`` is None on the certified fast path, else the
    degraded-mode outcome tag ('clamp' | 'oracle' | 'unserved' --
    serve/fallback.py); ``ok`` is the serve-level success flag (a
    certified or fallback-served answer)."""

    u: np.ndarray
    cost: float
    leaf: int
    inside: bool
    version: str
    fallback: Optional[str]
    latency_s: float

    @property
    def ok(self) -> bool:
        return bool(self.inside)


class Ticket:
    """Caller-side handle for one submission (k rows)."""

    __slots__ = ("_evt", "_results", "_error", "t_submit", "n")

    def __init__(self, n: int):
        self._evt = threading.Event()
        self._results: list[Optional[ServeResult]] = [None] * n
        self._error: Optional[BaseException] = None
        self.t_submit = time.perf_counter()
        self.n = n

    def _fill(self, offset: int, results: list[ServeResult]) -> None:
        self._results[offset:offset + len(results)] = results
        if all(r is not None for r in self._results):
            self._evt.set()

    def _fail(self, err: BaseException) -> None:
        self._error = err
        self._evt.set()

    def done(self) -> bool:
        return self._evt.is_set()

    def result(self, timeout: Optional[float] = None
               ) -> list[ServeResult]:
        """Block until every row is served; raises TimeoutError on
        `timeout`, or the scheduler-side error on failure."""
        if not self._evt.wait(timeout):
            raise TimeoutError(
                f"serve ticket not complete within {timeout}s")
        if self._error is not None:
            raise self._error
        return list(self._results)  # type: ignore[arg-type]


class _Pending:
    """One queued submission (``key``: its controller route, where the
    scheduler serves several); `done` rows already claimed by batches."""

    __slots__ = ("ticket", "thetas", "key", "done")

    def __init__(self, ticket: Ticket, thetas: np.ndarray,
                 key: Optional[str] = None):
        self.ticket = ticket
        self.thetas = thetas
        self.key = key
        self.done = 0


#: Scheduler hooks whose modules wait for later port slices: hook ->
#: the ROADMAP item and the JAX package's module it waits for.
_HOOK_ITEMS = {"demand": "A5: obs/demand.py", "trace": "A2: obs/reqtrace.py",
               "slo": "A5: obs/slo.py"}


def _unported(cls: str, **hooks) -> None:
    for name, hub in hooks.items():
        if hub is not None:
            raise NotImplementedError(
                f"{cls}({name}=...) is not yet ported to the "
                f"torch package (ROADMAP {_HOOK_ITEMS[name]})")


class _MicroBatcher:
    """The queue both schedulers share: submissions append under one
    condition, a worker thread claims a micro-batch when ``max_batch``
    rows are queued or the oldest has waited ``max_wait_us`` (the
    deadline budget), serves it with the subclass's ``_serve``, fails
    the batch's tickets if that raises, and flushes a metrics snapshot
    every METRICS_FLUSH_S seconds of traffic; ``close()`` drains the
    queue and stops the worker (no request is ever dropped by a clean
    shutdown)."""

    def _setup(self, max_batch: int, max_wait_us: float, obs) -> None:
        if not config_mod.is_pow2(max_batch):
            raise ValueError(f"max_batch must be a power of two, "
                             f"got {max_batch}")
        if max_wait_us <= 0:
            raise ValueError("max_wait_us must be > 0")
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_us) * 1e-6
        self._obs = obs if obs is not None else obs_lib.NOOP
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue: deque[_Pending] = deque()
        self._queued_rows = 0
        self._closed = False
        self.n_requests = 0
        self.n_batches = 0
        self._lat_roll: deque = deque(maxlen=_ROLL_WINDOW)
        self._fb_roll: deque = deque(maxlen=_ROLL_WINDOW)
        self._fill_roll: deque[float] = deque(maxlen=64)
        self._last_flush = time.perf_counter()
        self._ms = None

    def _start(self, name: str) -> None:
        self._worker = threading.Thread(target=self._loop, name=name,
                                        daemon=True)
        self._worker.start()

    def queue_depth(self) -> int:
        with self._lock:
            return self._queued_rows

    def _collect(self) -> list[tuple[Ticket, int, Optional[str],
                                     np.ndarray]]:
        """Block until a flush condition holds, then claim up to
        max_batch rows: [(ticket, row offset in ticket, key, rows)]."""
        with self._cond:
            while True:
                if self._queue:
                    oldest = self._queue[0].ticket.t_submit
                    budget = oldest + self.max_wait_s \
                        - time.perf_counter()
                    if self._queued_rows >= self.max_batch \
                            or budget <= 0 or self._closed:
                        break
                    self._cond.wait(timeout=budget)
                elif self._closed:
                    return []
                else:
                    self._cond.wait()
            out = []
            room = self.max_batch
            while room and self._queue:
                pend = self._queue[0]
                take = min(room, pend.thetas.shape[0] - pend.done)
                out.append((pend.ticket, pend.done, pend.key,
                            pend.thetas[pend.done:pend.done + take]))
                pend.done += take
                room -= take
                self._queued_rows -= take
                if pend.done == pend.thetas.shape[0]:
                    self._queue.popleft()
            if self._ms:
                self._ms["depth"].set(self._queued_rows)
            return out

    def _loop(self) -> None:
        while True:
            entries = self._collect()
            if not entries:
                return  # closed and drained
            try:
                self._serve(entries)
            except BaseException as e:  # noqa: BLE001 -- scatter, don't die
                for ticket, _off, _key, _rows in entries:
                    ticket._fail(e)
            # Periodic metrics snapshot into the stream: without it the
            # serving SLO gauges reach the health rules only at close().
            if self._ms:
                now = time.perf_counter()
                if now - self._last_flush >= METRICS_FLUSH_S:
                    self._last_flush = now
                    self._obs.flush_metrics()

    def _serve(self, entries) -> None:
        raise NotImplementedError

    def _roll_gauges(self, now: float) -> None:
        """The rolling p99 latency and fallback-fraction gauges, over
        the last _ROLL_WINDOW requests no older than _ROLL_MAX_AGE_S."""
        if not (self._ms and self._lat_roll):
            return
        _prune_stale(self._lat_roll, self._fb_roll, now)
        if self._lat_roll:
            lat_us = np.asarray([v for _t, v in self._lat_roll]) * 1e6
            self._ms["p99"].set(float(np.percentile(lat_us, 99)))
        if self._fb_roll:
            self._ms["fb_frac"].set(
                sum(v for _t, v in self._fb_roll) / len(self._fb_roll))

    def close(self, timeout: Optional[float] = 30.0) -> None:
        """Stop accepting, drain everything queued, join the worker.
        A clean close never drops a request."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._worker.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class RequestScheduler(_MicroBatcher):
    """Micro-batching front end over a ControllerRegistry entry.

    One scheduler serves one controller name; run several for several
    controllers (they share the registry and the obs handle).  Start
    is implicit on construction; ``close()`` drains the queue and
    stops the worker (no request is ever dropped by a clean
    shutdown).  The worker thread evaluates on the device's default
    stream, the stream the registry's servers were staged on."""

    def __init__(self, registry, controller: str,
                 max_batch: int = 256, max_wait_us: float = 2000.0,
                 fallback=None, obs: "obs_lib.Obs | None" = None,
                 demand=None, trace=None, slo=None):
        self._setup(max_batch, max_wait_us, obs)
        _unported("RequestScheduler", demand=demand, trace=trace, slo=slo)
        self.registry = registry
        self.controller = controller
        self.fallback = fallback
        if self._obs.enabled:
            m = self._obs.metrics
            ns = f"serve.ctl.{controller}"
            self._ms = {
                "req_s": m.histogram(f"{ns}.request_s"),
                "batch_fill": m.histogram(f"{ns}.batch_fill"),
                "depth": m.gauge(f"{ns}.queue_depth"),
                "fill": m.gauge(f"{ns}.batch_fill_frac"),
                "p99": m.gauge(f"{ns}.p99_us"),
                "fb_frac": m.gauge(f"{ns}.fallback_frac"),
                "requests": m.counter(f"{ns}.requests"),
                "batches": m.counter(f"{ns}.batches"),
                # Cumulative degraded-request count (any fallback tag):
                # with .requests it gives the fallback SLO a
                # counter-delta denominator.
                "fallbacks": m.counter(f"{ns}.fallbacks"),
                # Cross-controller aggregates, incremented under
                # _AGG_LOCK (these two names are shared).
                "requests_all": m.counter("serve.requests"),
                "batches_all": m.counter("serve.batches"),
            }
            # Per-replica identity: binds the CONTROLLER name to this
            # process's run id, host and pid.
            from explicit_hybrid_mpc_tpu_torch.obs import clock

            self._obs.event("serve.replica", controller=controller,
                            run_id=clock.run_id(),
                            host=socket.gethostname(),
                            pid=os.getpid())
        self._start(f"serve-{controller}")

    # -- submission --------------------------------------------------------

    def submit(self, theta: np.ndarray) -> Ticket:
        """Enqueue ONE query (p,); Ticket.result() -> [ServeResult]."""
        return self.submit_batch(np.atleast_2d(theta))

    def submit_batch(self, thetas: np.ndarray) -> Ticket:
        """Enqueue a small batch (k, p); rows may be split across
        micro-batches (each row still evaluates on exactly one
        version).  Large k is legal -- the scheduler chunks it.

        Shape is validated HERE, against the submitting caller: a
        malformed submission must raise on its own thread, not poison
        the np.concatenate of a micro-batch it shares with other
        clients' healthy rows."""
        thetas = np.atleast_2d(np.asarray(thetas, dtype=np.float64))
        if thetas.ndim != 2:
            raise ValueError(f"thetas must be (k, p), got shape "
                             f"{thetas.shape}")
        # Queried per submit, not cached: the width is a
        # publish-enforced invariant of the controller name, so this
        # can only transition None -> p when the controller is first
        # published.
        p = self.registry.param_dim(self.controller)
        if p is not None and thetas.shape[1] != p:
            raise ValueError(
                f"theta width {thetas.shape[1]} does not match "
                f"controller {self.controller!r} parameter dim {p}")
        t = Ticket(thetas.shape[0])
        with self._cond:
            if self._closed:
                raise RuntimeError("scheduler is closed")
            self._queue.append(_Pending(t, thetas))
            self._queued_rows += thetas.shape[0]
            self.n_requests += thetas.shape[0]
            if self._ms:
                self._ms["requests"].inc(thetas.shape[0])
                with _AGG_LOCK:
                    self._ms["requests_all"].inc(thetas.shape[0])
                self._ms["depth"].set(self._queued_rows)
            self._cond.notify()
        return t

    # -- worker ------------------------------------------------------------

    def _serve(self, entries) -> None:
        thetas = np.concatenate([rows for _t, _o, _k, rows in entries])
        B = thetas.shape[0]
        fill = B / min(_bucket(B), self.max_batch)
        self._fill_roll.append(fill)
        self.n_batches += 1
        # The lease is a context manager: release runs in its finally,
        # so ANY raise below -- evaluator error, fallback error, or an
        # injected serve.batch crash -- drains the ref and a retiring
        # version can still retire.
        with self.registry.lease(self.controller) as ver:
            faults_inj.fire("serve.batch", label=self.controller)
            srv = ver.server
            # Heartbeat context for the evaluator's serve.eval event.
            hb = getattr(srv, "heartbeat", None)
            if hb is not None:
                hb["queue_depth"] = self.queue_depth()
                hb["batch_fill_frac"] = round(
                    sum(self._fill_roll) / len(self._fill_roll), 4)
            res = srv.evaluate(thetas)
            if self.fallback is not None:
                res, tags = self.fallback.apply(
                    thetas, res, srv, controller=self.controller)
            else:
                tags = [None] * B
        now = time.perf_counter()
        version = ver.version
        if self._ms:
            self._ms["batches"].inc()
            with _AGG_LOCK:
                self._ms["batches_all"].inc()
            self._ms["batch_fill"].observe(fill)
            self._ms["fill"].set(
                sum(self._fill_roll) / len(self._fill_roll))
            n_fb = sum(1 for t in tags if t is not None)
            if n_fb:
                self._ms["fallbacks"].inc(n_fb)
        lo = 0
        for ticket, off, _key, rows in entries:
            k = rows.shape[0]
            lat = now - ticket.t_submit
            results = [
                ServeResult(u=np.array(res.u[lo + i]),
                            cost=float(res.cost[lo + i]),
                            leaf=int(res.leaf[lo + i]),
                            inside=bool(res.inside[lo + i]),
                            version=version,
                            fallback=tags[lo + i],
                            latency_s=lat)
                for i in range(k)]
            self._lat_roll.extend([(now, lat)] * k)
            self._fb_roll.extend(
                [(now, 0 if t is None else 1)
                 for t in tags[lo:lo + k]])
            if self._ms:
                self._ms["req_s"].observe(lat, n=k)
            ticket._fill(off, results)
            lo += k
        self._roll_gauges(now)


class ArenaScheduler(_MicroBatcher):
    """Mixed-tenant micro-batching front end over a DeviceArena.

    ONE queue for all tenants: requests for different controllers pack
    into the same micro-batch and one fused kernel launch
    (serve/arena.py) serves them all, each row routed to its own
    controller's column extent.  The ``serve.arena.launches_per_req``
    gauge tracks launches over requests.

    The fused kernel clamps out-of-box rows to each row's certified box
    on the device, so the FallbackPolicy's clamp pass is already done by
    the time results land; ``fallback.account_kernel`` performs the
    counting/tagging `apply()` would (same ``serve.fallback.*``
    counters), and per-controller
    ``serve.ctl.<name>.fallback.outside_box`` counters attribute the
    clamps.  mode='off' disables the in-kernel clamp (the arena widens
    the row boxes to the identity) and counts nothing.  The oracle
    re-solve path does not exist on the kernel path; hole rows come
    back 'unserved'.

    Every batch leases the involved extents for its full device round
    trip (arena.evaluate holds them), so a hot swap mid-traffic follows
    the two-epoch handoff and results are tagged with the leased
    version per row.  ``close()`` drains the queue and stops the worker
    (no request is ever dropped by a clean shutdown).
    """

    def __init__(self, arena, max_batch: int = 256,
                 max_wait_us: float = 2000.0, fallback=None,
                 obs: "obs_lib.Obs | None" = None, demand=None,
                 trace=None, slo=None):
        self._setup(max_batch, max_wait_us, obs)
        _unported("ArenaScheduler", demand=demand, trace=trace, slo=slo)
        self.arena = arena
        self.fallback = fallback
        self._mix_roll: deque[int] = deque(maxlen=64)
        self._ctl_ms: dict[str, dict] = {}
        if self._obs.enabled:
            m = self._obs.metrics
            self._ms = {
                "req_s": m.histogram("serve.arena.request_s"),
                "depth": m.gauge("serve.arena.queue_depth"),
                "fill": m.gauge("serve.arena.batch_fill_frac"),
                "mix": m.gauge("serve.arena.mixed_batch_fill"),
                "lpr": m.gauge("serve.arena.launches_per_req"),
                "p99": m.gauge("serve.arena.p99_us"),
                "fb_frac": m.gauge("serve.arena.fallback_frac"),
                "requests_all": m.counter("serve.requests"),
                "batches_all": m.counter("serve.batches"),
            }
            from explicit_hybrid_mpc_tpu_torch.obs import clock

            self._obs.event("serve.replica", controller="<arena>",
                            run_id=clock.run_id(),
                            host=socket.gethostname(),
                            pid=os.getpid())
        self._start("serve-arena")

    def _ctl(self, name: str) -> Optional[dict]:
        """Lazily minted per-controller counters (worker thread only)."""
        if not self._obs.enabled:
            return None
        ms = self._ctl_ms.get(name)
        if ms is None:
            m = self._obs.metrics
            ns = f"serve.ctl.{name}"
            ms = {"requests": m.counter(f"{ns}.requests"),
                  "outside_box": m.counter(f"{ns}.fallback.outside_box"),
                  "fallbacks": m.counter(f"{ns}.fallbacks")}
            self._ctl_ms[name] = ms
        return ms

    # -- submission --------------------------------------------------------

    def submit(self, controller: str, theta: np.ndarray) -> Ticket:
        """Enqueue ONE query (p,) for `controller`."""
        return self.submit_batch(controller, np.atleast_2d(theta))

    def submit_batch(self, controller: str, thetas: np.ndarray
                     ) -> Ticket:
        """Enqueue a small batch (k, p) for one controller; rows may
        split across micro-batches (each row still evaluates on exactly
        one leased version).  Shape is validated HERE, on the submitting
        caller: a malformed submission must not poison a micro-batch it
        would share with other clients' rows."""
        thetas = np.atleast_2d(np.asarray(thetas, dtype=np.float64))
        if thetas.ndim != 2:
            raise ValueError(f"thetas must be (k, p), got shape "
                             f"{thetas.shape}")
        if thetas.shape[1] != self.arena.p:
            raise ValueError(
                f"theta width {thetas.shape[1]} does not match the "
                f"arena parameter dim {self.arena.p}")
        self.arena.extent(controller)   # raises KeyError if unpublished
        t = Ticket(thetas.shape[0])
        with self._cond:
            if self._closed:
                raise RuntimeError("scheduler is closed")
            self._queue.append(_Pending(t, thetas, controller))
            self._queued_rows += thetas.shape[0]
            self.n_requests += thetas.shape[0]
            if self._ms:
                with _AGG_LOCK:
                    self._ms["requests_all"].inc(thetas.shape[0])
                self._ms["depth"].set(self._queued_rows)
            self._cond.notify()
        return t

    # -- worker ------------------------------------------------------------

    def _serve(self, entries) -> None:
        thetas = np.concatenate([rows for _t, _o, _n, rows in entries])
        names: list[str] = []
        for _t, _o, name, rows in entries:
            names.extend([name] * rows.shape[0])
        B = thetas.shape[0]
        fill = B / min(_bucket(B), self.max_batch)
        self._fill_roll.append(fill)
        self._mix_roll.append(len(set(names)))
        self.n_batches += 1
        faults_inj.fire("serve.batch", label="<arena>")
        mode_off = (self.fallback is not None
                    and self.fallback.mode == "off")
        # ONE launch for the whole mixed-tenant batch; arena.evaluate
        # leases every involved extent across the device round trip.
        res = self.arena.evaluate(names, thetas, clamp=not mode_off)
        if self.fallback is not None:
            tags = self.fallback.account_kernel(res.clamped, res.served,
                                                names=names)
        else:
            tags = [None] * B
        now = time.perf_counter()
        if self._ms:
            with _AGG_LOCK:
                self._ms["batches_all"].inc()
            self._ms["fill"].set(
                sum(self._fill_roll) / len(self._fill_roll))
            self._ms["mix"].set(
                sum(self._mix_roll) / len(self._mix_roll))
            if self.n_requests:
                self._ms["lpr"].set(self.n_batches / self.n_requests)
        lo = 0
        for ticket, off, name, rows in entries:
            k = rows.shape[0]
            lat = now - ticket.t_submit
            n_u = res.n_us[name]
            version = res.versions[name]
            results = [
                ServeResult(u=np.array(res.u[lo + i, :n_u],
                                       dtype=np.float64),
                            cost=float(res.cost[lo + i]),
                            leaf=int(res.leaf[lo + i]),
                            inside=bool(res.served[lo + i]),
                            version=version,
                            fallback=tags[lo + i],
                            latency_s=lat)
                for i in range(k)]
            cms = self._ctl(name)
            if cms:
                cms["requests"].inc(k)
                n_out = int(np.sum(res.clamped[lo:lo + k]))
                if n_out:
                    cms["outside_box"].inc(n_out)
                n_fb = sum(1 for t in tags[lo:lo + k] if t is not None)
                if n_fb:
                    cms["fallbacks"].inc(n_fb)
            self._lat_roll.extend([(now, lat)] * k)
            self._fb_roll.extend(
                [(now, 0 if t is None else 1)
                 for t in tags[lo:lo + k]])
            if self._ms:
                self._ms["req_s"].observe(lat, n=k)
            ticket._fill(off, results)
            lo += k
        self._roll_gauges(now)
