"""Demand telemetry: where serving traffic actually lands.

The port's copy of the JAX package's obs/demand.py: host-side numpy,
the same seeded sketches, and the same ``demand-v1`` snapshot layout,
so a snapshot written by either package loads in the other.

Three signals the serving stack measures nowhere else: WHICH leaves
traffic visits (so a rebuild can re-open hot subtrees first), WHERE
fallback queries leave the certified box (so the next build can grow
it along the right dimensions), and HOW suboptimal the served answers
really are (the per-region eps guarantee measured online).  The
schedulers (serve/scheduler.py) feed it one BATCHED call per
micro-batch -- never per row -- and ``lifecycle.RebuildService`` /
``partition.rebuild.warm_rebuild(priority=...)`` consume the published
snapshot as a leaf-ordering hint.

Components (all host-side, all bounded):

- ``LeafSketch`` -- per-controller visit counts over GLOBAL leaf-table
  rows.  Exact (a plain dict) up to ``max_leaves`` distinct leaves;
  beyond that it degrades to a seeded count-min sketch (depth
  ``CM_DEPTH``, width auto-sized to ``CM_WIDTH_FACTOR * max_leaves``
  rounded up to a power of two) plus a bounded heavy-hitter candidate
  set, so memory stays O(max_leaves) at any tree size.  Error bound
  (standard count-min, Markov per row over ``CM_DEPTH`` independent
  rows): for total decayed weight N and width w, an estimate
  overestimates the true count by more than ``2 N / w`` with
  probability at most ``2**-CM_DEPTH``; it NEVER underestimates.
  Counts age by exponential decay with half-life ``decay_halflife_s``
  (applied lazily from the clock), so a snapshot reflects the RECENT
  traffic mix, not the whole process lifetime.
- ``Reservoir`` -- bounded uniform sample (Algorithm R, seeded rng) of
  fallback thetas, kept per cause (outside_box / hole).
- ``ExceedHist`` -- per-dimension counts of below-lb / above-ub box
  exceedance.
- ``SuboptSampler`` -- deterministic stride sample (every
  ``round(1/frac)``-th served row per controller) queued for an
  oracle re-solve; the hub's maintenance thread drains the queue
  through its own ``Oracle`` (on the card that is the K1 leg,
  csrc/ipm_leg.cu), folds ``V_served - V*`` into a rolling window, and
  publishes ``serve.ctl.<name>.subopt_p50`` / ``.subopt_p99`` gauges
  plus the ``.subopt_samples`` counter.  When ``subopt_eps`` > 0 and
  the volume gate is met, a breach emits a ``health.subopt`` event
  (warn, adopted by any HealthMonitor); the external-tailer complement
  is the ``max_subopt`` rule in obs/health.py.  The sampler copies
  thetas and costs on the host, so the re-solves never touch a
  serving arena's buffers.
- ``DemandHub`` -- the capture surface the schedulers hold.  Off-mode
  (``mode='off'``) is a single attribute test per batch; ``record``
  is fully vectorized (np.unique / bincount, no per-row Python in the
  sketch path) and everything slow (oracle re-solves, snapshot IO)
  runs on the hub's own maintenance thread, never the scheduler
  worker.  That thread turns every exception into a ``demand.error``
  event: telemetry must not kill serving.

The snapshot artifact (``snapshot()`` / ``load_demand``) follows the
directory commit-marker convention (utils/atomic.py): ``demand.npz``
(arrays) lands FIRST, the ``demand.json`` meta -- carrying the npz
sha256 and the window/provenance stamp -- is atomically written LAST.
A torn snapshot (npz without meta, or a truncated npz under a stale
meta) NEVER loads: ``load_demand`` raises ``CorruptArtifact``.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from typing import Callable, Optional

import numpy as np

from explicit_hybrid_mpc_tpu_torch import obs as obs_lib
from explicit_hybrid_mpc_tpu_torch.utils import atomic

#: Snapshot schema tag (bump on incompatible change; load_demand
#: rejects unknown majors).
SNAPSHOT_SCHEMA = "demand-v1"

#: Count-min geometry: depth = independent hash rows (failure
#: probability 2**-CM_DEPTH per query), width = CM_WIDTH_FACTOR *
#: max_leaves rounded up to a power of two (bias bound 2N/width).
CM_DEPTH = 4
CM_WIDTH_FACTOR = 4

#: Minimum subopt samples before the health gate may fire (the
#: volume gate: three lucky samples must not alarm a fresh deploy).
SUBOPT_MIN_SAMPLES = 20

#: Rolling subopt window (samples) behind the p50/p99 gauges.
_SUBOPT_WINDOW = 512

#: Cooldown between health.subopt events per controller (seconds) --
#: a persistent breach re-notifies, a storm does not spam the stream.
_SUBOPT_REFIRE_S = 10.0

#: Oracle drain cadence (seconds).  Draining on every maintenance
#: wake would dispatch one oracle solve per micro-batch -- launches
#: (and host work) competing with the serving worker.  Batching
#: the pending queue every _SUBOPT_DRAIN_S bounds oracle dispatches
#: to ~2/s regardless of load (max_pending bounds the queue between
#: drains; overflow is counted as n_dropped, per the budget).
_SUBOPT_DRAIN_S = 0.5

#: Top-k hot leaves carried in the snapshot meta / demand.snapshot
#: event (the full id/hit arrays live in the npz).
_TOP_K = 16


def _pow2_at_least(n: int) -> int:
    return 1 << max(3, (max(1, n) - 1).bit_length())


def _mix64(x: np.ndarray, mult: np.uint64, xor: np.uint64) -> np.ndarray:
    """Seeded 64-bit mixer (splitmix64 finalizer with per-row
    constants): the count-min hash rows.  Vectorized, deterministic
    across platforms (pure uint64 wraparound arithmetic)."""
    h = (x ^ xor) * mult
    h ^= h >> np.uint64(33)
    h *= np.uint64(0xFF51AFD7ED558CCD)
    h ^= h >> np.uint64(29)
    return h


class LeafSketch:
    """Decayed per-leaf visit counts: exact dict up to ``max_leaves``
    distinct keys, then count-min + bounded heavy-hitter candidates
    (module docstring has the error bound)."""

    def __init__(self, max_leaves: int = 4096,
                 decay_halflife_s: float = 300.0, seed: int = 0,
                 clock: Callable[[], float] = time.monotonic):
        if max_leaves < 1:
            raise ValueError("max_leaves must be >= 1")
        if decay_halflife_s <= 0:
            raise ValueError("decay_halflife_s must be > 0")
        self.max_leaves = int(max_leaves)
        self.halflife_s = float(decay_halflife_s)
        self.seed = int(seed)
        self._clock = clock
        self._exact: Optional[dict[int, float]] = {}
        self._cm: Optional[np.ndarray] = None
        self._heavy: dict[int, float] = {}
        rng = np.random.default_rng(seed)
        # Odd multipliers + xor constants per hash row (odd => the
        # multiply is a bijection on Z/2^64).
        self._mults = (rng.integers(0, 2 ** 63, size=CM_DEPTH,
                                    dtype=np.uint64) * 2 + 1)
        self._xors = rng.integers(0, 2 ** 63, size=CM_DEPTH,
                                  dtype=np.uint64)
        self.width = _pow2_at_least(CM_WIDTH_FACTOR * self.max_leaves)
        self.total = 0.0          # decayed total weight
        self.n_rows = 0           # raw (undecayed) row count
        self._last_decay = self._clock()

    @property
    def mode(self) -> str:
        return "exact" if self._exact is not None else "countmin"

    # -- decay -------------------------------------------------------------

    def _decay_to(self, now: float) -> None:
        dt = now - self._last_decay
        if dt <= 0:
            return
        self._last_decay = now
        f = 0.5 ** (dt / self.halflife_s)
        if f >= 1.0:
            return
        self.total *= f
        if self._exact is not None:
            for k in self._exact:
                self._exact[k] *= f
        else:
            self._cm *= f
            for k in self._heavy:
                self._heavy[k] *= f

    # -- update ------------------------------------------------------------

    def _rows_cols(self, keys: np.ndarray) -> np.ndarray:
        """(CM_DEPTH, n) column index per hash row."""
        x = keys.astype(np.int64).view(np.uint64) \
            if keys.dtype == np.int64 else \
            keys.astype(np.uint64)
        mask = np.uint64(self.width - 1)
        return np.stack([_mix64(x, self._mults[d], self._xors[d]) & mask
                         for d in range(CM_DEPTH)])

    def _cm_estimate(self, keys: np.ndarray) -> np.ndarray:
        cols = self._rows_cols(keys)
        ests = np.stack([self._cm[d, cols[d]] for d in range(CM_DEPTH)])
        return ests.min(axis=0)

    def _spill(self) -> None:
        """Exact -> count-min transition: fold every exact count into
        the sketch; the current keys seed the heavy-hitter set."""
        self._cm = np.zeros((CM_DEPTH, self.width))
        keys = np.fromiter(self._exact.keys(), dtype=np.int64,
                           count=len(self._exact))
        vals = np.fromiter(self._exact.values(), dtype=np.float64,
                           count=len(self._exact))
        cols = self._rows_cols(keys)
        for d in range(CM_DEPTH):
            np.add.at(self._cm[d], cols[d], vals)
        self._heavy = dict(zip(keys.tolist(), vals.tolist()))
        self._exact = None

    def update(self, leaves: np.ndarray) -> None:
        """Batched visit update: one np.unique over the micro-batch's
        leaf rows (negative rows -- payload-free landings -- are
        dropped; they are fallback causes, not demand)."""
        leaves = np.asarray(leaves, dtype=np.int64).ravel()
        leaves = leaves[leaves >= 0]
        if leaves.size == 0:
            return
        self._decay_to(self._clock())
        keys, counts = np.unique(leaves, return_counts=True)
        w = counts.astype(np.float64)
        self.total += float(w.sum())
        self.n_rows += int(leaves.size)
        if self._exact is not None:
            ex = self._exact
            for k, c in zip(keys.tolist(), w.tolist()):
                ex[k] = ex.get(k, 0.0) + c
            if len(ex) > self.max_leaves:
                self._spill()
            return
        cols = self._rows_cols(keys)
        for d in range(CM_DEPTH):
            np.add.at(self._cm[d], cols[d], w)
        # Heavy-hitter candidates: CM estimates for this batch's keys;
        # admit any key whose estimate beats the current weakest
        # candidate (bounded at max_leaves entries).
        est = self._cm_estimate(keys)
        hv = self._heavy
        for k, e in zip(keys.tolist(), est.tolist()):
            hv[k] = e
        if len(hv) > self.max_leaves:
            order = sorted(hv.items(), key=lambda kv: (-kv[1], kv[0]))
            self._heavy = dict(order[:self.max_leaves])

    # -- queries -----------------------------------------------------------

    def estimate(self, leaf: int) -> float:
        """Decayed visit estimate (exact in exact mode; count-min
        upper estimate -- never an underestimate -- after spill)."""
        self._decay_to(self._clock())
        if self._exact is not None:
            return self._exact.get(int(leaf), 0.0)
        return float(self._cm_estimate(
            np.asarray([leaf], dtype=np.int64))[0])

    def items(self) -> tuple[np.ndarray, np.ndarray]:
        """(leaf ids, decayed hits), hits-descending, id-ascending on
        ties -- exact counts in exact mode, the heavy-hitter candidate
        estimates after spill."""
        self._decay_to(self._clock())
        src = self._exact if self._exact is not None else self._heavy
        if not src:
            return (np.empty(0, dtype=np.int64), np.empty(0))
        pairs = sorted(src.items(), key=lambda kv: (-kv[1], kv[0]))
        ids = np.asarray([k for k, _v in pairs], dtype=np.int64)
        hits = np.asarray([v for _k, v in pairs], dtype=np.float64)
        return ids, hits

    def top(self, k: int) -> list[tuple[int, float]]:
        ids, hits = self.items()
        return list(zip(ids[:k].tolist(), hits[:k].tolist()))


def top_decile_frac(hits: np.ndarray) -> Optional[float]:
    """Share of total (decayed) traffic carried by the top 10% of the
    OBSERVED leaves (ceil, so one observed leaf => 1.0).  The skew
    figure: uniform traffic reads ~0.1, a hot working set reads near
    1."""
    hits = np.asarray(hits, dtype=np.float64)
    total = float(hits.sum())
    if hits.size == 0 or total <= 0:
        return None
    k = -(-hits.size // 10)
    topk = np.sort(hits)[::-1][:k]
    return float(topk.sum() / total)


class Reservoir:
    """Bounded uniform sample of theta rows (Algorithm R), seeded --
    the same stream under the same seed yields the same sample."""

    def __init__(self, k: int = 64, seed: int = 0):
        if k < 1:
            raise ValueError("reservoir size must be >= 1")
        self.k = int(k)
        self._rng = np.random.default_rng(seed)
        self.n_seen = 0
        self._rows: list[np.ndarray] = []

    def add(self, thetas: np.ndarray) -> None:
        thetas = np.atleast_2d(np.asarray(thetas, dtype=np.float64))
        for row in thetas:
            self.n_seen += 1
            if len(self._rows) < self.k:
                self._rows.append(np.array(row))
            else:
                j = int(self._rng.integers(0, self.n_seen))
                if j < self.k:
                    self._rows[j] = np.array(row)

    def sample(self) -> np.ndarray:
        """(m, p) current sample, m <= k (empty (0, 0) before any
        add)."""
        if not self._rows:
            return np.empty((0, 0))
        return np.stack(self._rows)


class ExceedHist:
    """Per-dimension box-exceedance counts: how many fallback queries
    crossed each face (below lb / above ub)."""

    def __init__(self, p: int):
        self.lo = np.zeros(p, dtype=np.int64)
        self.hi = np.zeros(p, dtype=np.int64)

    def update(self, thetas: np.ndarray, lb: np.ndarray,
               ub: np.ndarray) -> None:
        thetas = np.atleast_2d(thetas)
        if thetas.size == 0:
            return
        self.lo += (thetas < lb).sum(axis=0)
        self.hi += (thetas > ub).sum(axis=0)

    def hot_dims(self, k: int = 4) -> list[int]:
        """Dimensions by total exceedance, descending, nonzero only."""
        tot = self.lo + self.hi
        order = np.argsort(-tot, kind="stable")
        return [int(d) for d in order[:k] if tot[d] > 0]


class SuboptSampler:
    """Deterministic stride sample of served rows queued for a host
    oracle re-solve (module docstring).  ``offer`` is the scheduler-
    side batched call; ``take_pending`` hands the queued rows to the
    hub's maintenance thread."""

    def __init__(self, frac: float, max_pending: int = 256):
        if not 0.0 <= frac <= 1.0:
            raise ValueError("subopt frac must be in [0, 1]")
        self.frac = float(frac)
        self.stride = 0 if frac <= 0 else max(1, round(1.0 / frac))
        self.max_pending = int(max_pending)
        self._row_counter = 0
        self._pending_theta: list[np.ndarray] = []
        self._pending_v: list[float] = []
        self.n_offered = 0
        self.n_dropped = 0
        self.values: "np.ndarray | list[float]" = []
        self._roll: list[float] = []

    def offer(self, thetas: np.ndarray, costs: np.ndarray,
              served: np.ndarray) -> None:
        """Pick every stride-th SERVED row (deterministic in the row
        arrival order); bounded by max_pending (overflow counted, not
        queued -- the budget is the point)."""
        if self.stride == 0:
            return
        served = np.asarray(served, dtype=bool)
        idx = np.flatnonzero(served)
        if idx.size == 0:
            self._row_counter += int(served.size)
            return
        # Global row counter over served rows: rows where the running
        # index hits a stride multiple are sampled.
        gidx = self._row_counter + np.arange(idx.size)
        self._row_counter += int(served.size)
        pick = idx[gidx % self.stride == 0]
        self.n_offered += int(pick.size)
        for i in pick:
            if len(self._pending_theta) >= self.max_pending:
                self.n_dropped += 1
                continue
            self._pending_theta.append(
                np.array(thetas[i], dtype=np.float64))
            self._pending_v.append(float(costs[i]))

    def take_pending(self, max_n: int = 64
                     ) -> tuple[np.ndarray, np.ndarray]:
        """(thetas (m, p), V_served (m,)) and clears them, m <=
        max_n."""
        m = min(max_n, len(self._pending_theta))
        if m == 0:
            return np.empty((0, 0)), np.empty(0)
        th = np.stack(self._pending_theta[:m])
        v = np.asarray(self._pending_v[:m])
        del self._pending_theta[:m]
        del self._pending_v[:m]
        return th, v

    def fold(self, subopts: np.ndarray) -> None:
        self._roll.extend(float(s) for s in np.asarray(subopts).ravel())
        if len(self._roll) > _SUBOPT_WINDOW:
            del self._roll[:len(self._roll) - _SUBOPT_WINDOW]

    @property
    def n_samples(self) -> int:
        return len(self._roll)

    def quantiles(self) -> tuple[Optional[float], Optional[float]]:
        if not self._roll:
            return None, None
        a = np.asarray(self._roll)
        return (float(np.percentile(a, 50)),
                float(np.percentile(a, 99)))


class _ControllerDemand:
    """One controller's demand state (owned by the hub lock)."""

    __slots__ = ("sketch", "res_outside", "res_hole", "exceed",
                 "subopt", "n_fallback", "n_leaves_hint", "ms",
                 "last_subopt_event_t")

    def __init__(self, hub: "DemandHub", name: str):
        base_seed = hub.seed + (hash(name) & 0xFFFF)
        self.sketch = LeafSketch(hub.max_leaves, hub.decay_halflife_s,
                                 seed=base_seed, clock=hub._clock)
        self.res_outside = Reservoir(hub.reservoir_k, seed=base_seed + 1)
        self.res_hole = Reservoir(hub.reservoir_k, seed=base_seed + 2)
        self.exceed: Optional[ExceedHist] = None
        self.subopt = SuboptSampler(hub.subopt_frac)
        self.n_fallback = 0
        self.n_leaves_hint: Optional[int] = None
        self.last_subopt_event_t = -np.inf
        self.ms = None
        if hub._obs.enabled:
            m = hub._obs.metrics
            ns = f"serve.ctl.{name}"
            self.ms = {
                "rows": m.counter(f"{ns}.demand_rows"),
                "leaves": m.gauge(f"{ns}.demand_leaves"),
                "top_decile": m.gauge(f"{ns}.demand_top_decile_frac"),
                "snapshots": m.counter(f"{ns}.demand_snapshots"),
                "subopt_n": m.counter(f"{ns}.subopt_samples"),
                "subopt_p50": m.gauge(f"{ns}.subopt_p50"),
                "subopt_p99": m.gauge(f"{ns}.subopt_p99"),
            }


class DemandHub:
    """The shared capture surface (module docstring).  One hub serves
    any number of schedulers/controllers; ``record`` is thread-safe
    (scheduler worker threads) and batched.  ``mode='off'`` makes
    every method a no-op behind a single attribute test -- the hub can
    be constructed unconditionally and cost nothing."""

    def __init__(self, mode: str = "off", max_leaves: int = 4096,
                 decay_halflife_s: float = 300.0, reservoir_k: int = 64,
                 subopt_frac: float = 0.0, subopt_eps: float = 0.0,
                 snapshot_every_s: float = 30.0,
                 snapshot_dir: Optional[str] = None,
                 oracle=None, seed: int = 0,
                 obs: "obs_lib.Obs | None" = None,
                 clock: Callable[[], float] = time.monotonic):
        if mode not in ("off", "on"):
            raise ValueError(f"unknown demand mode {mode!r} "
                             "(expected 'off' or 'on')")
        if snapshot_every_s <= 0:
            raise ValueError("snapshot_every_s must be > 0")
        self.mode = mode
        self.enabled = mode == "on"
        self.max_leaves = int(max_leaves)
        self.decay_halflife_s = float(decay_halflife_s)
        self.reservoir_k = int(reservoir_k)
        self.subopt_frac = float(subopt_frac)
        self.subopt_eps = float(subopt_eps)
        self.snapshot_every_s = float(snapshot_every_s)
        self.snapshot_dir = snapshot_dir
        self.oracle = oracle
        self.seed = int(seed)
        self._obs = obs if obs is not None else obs_lib.NOOP
        self._clock = clock
        self._lock = threading.Lock()
        # One snapshot writer at a time: the maintenance thread's periodic
        # snapshot and a caller's must not interleave their npz and meta
        # writes in one directory (the meta would name the other's npz),
        # and a periodic one waiting behind a caller's is skipped
        # (_periodic_snapshot).
        self._snap_lock = threading.RLock()
        self._ctl: dict[str, _ControllerDemand] = {}
        self._closed = False
        self._last_snapshot = self._clock()
        self._last_drain = self._clock()
        self._thread: Optional[threading.Thread] = None
        self._wake = threading.Event()
        if self.enabled:
            # Validate the sampler knobs eagerly even when no oracle
            # is attached (SuboptSampler raises on a bad frac).
            SuboptSampler(self.subopt_frac)
        if self.enabled and (self.oracle is not None
                             or self.snapshot_dir is not None):
            self._thread = threading.Thread(
                target=self._maintenance_loop, name="demand-hub",
                daemon=True)
            self._thread.start()

    # -- capture (scheduler worker threads) --------------------------------

    def ctl(self, name: str) -> _ControllerDemand:
        st = self._ctl.get(name)
        if st is None:
            st = self._ctl[name] = _ControllerDemand(self, name)
        return st

    def record(self, name: str, thetas: np.ndarray, leaf: np.ndarray,
               tags, served: np.ndarray, costs: np.ndarray,
               box: Optional[tuple] = None,
               n_leaves: Optional[int] = None) -> None:
        """One BATCHED capture call per (controller, micro-batch):

        - `leaf`: global leaf-table rows (controller-local in the
          arena path -- the snapshot is per-controller either way);
        - `tags`: the fallback outcome list the scheduler already
          holds (None = certified fast path) -- rows with a tag are
          the fallback population;
        - `served`/`costs`: the post-fallback inside mask and cost
          vector (V_served for the subopt sample);
        - `box`: (lb, ub) of the leased version's certified box, for
          cause attribution + exceedance histograms (None skips the
          geometry channel, never the sketch).
        """
        if not self.enabled:
            return
        thetas = np.atleast_2d(np.asarray(thetas, dtype=np.float64))
        leaf = np.asarray(leaf)
        served = np.asarray(served, dtype=bool)
        costs = np.asarray(costs, dtype=np.float64)
        bad = np.asarray([t is not None for t in tags], dtype=bool) \
            if tags is not None else np.zeros(len(thetas), dtype=bool)
        with self._lock:
            st = self.ctl(name)
            if n_leaves is not None:
                st.n_leaves_hint = int(n_leaves)
            st.sketch.update(leaf[served])
            if st.ms:
                st.ms["rows"].inc(int(thetas.shape[0]))
            if bad.any() and box is not None:
                lb = np.asarray(box[0], dtype=np.float64)
                ub = np.asarray(box[1], dtype=np.float64)
                if st.exceed is None:
                    st.exceed = ExceedHist(thetas.shape[1])
                out = np.zeros(thetas.shape[0], dtype=bool)
                out[bad] = ((thetas[bad] < lb)
                            | (thetas[bad] > ub)).any(axis=1)
                st.n_fallback += int(bad.sum())
                if out.any():
                    st.res_outside.add(thetas[out])
                    st.exceed.update(thetas[out], lb, ub)
                hole = bad & ~out
                if hole.any():
                    st.res_hole.add(thetas[hole])
            st.subopt.offer(thetas, costs, served)
        if self._thread is not None:
            self._wake.set()

    # -- maintenance thread ------------------------------------------------

    def _maintenance_loop(self) -> None:
        while True:
            self._wake.wait(timeout=0.05)
            self._wake.clear()
            with self._lock:
                if self._closed:
                    return
            try:
                now = self._clock()
                if now - self._last_drain >= _SUBOPT_DRAIN_S:
                    self._last_drain = now
                    self._drain_subopt()
                if self.snapshot_dir is not None:
                    now = self._clock()
                    if now - self._last_snapshot \
                            >= self.snapshot_every_s:
                        self._periodic_snapshot()
            except Exception as e:  # noqa: BLE001 -- telemetry must never kill serving; evented below
                self._obs.event("demand.error", msg=repr(e))

    def _drain_subopt(self) -> None:
        """Re-solve one bounded pending batch per controller through
        the hub's oracle (K1 on the card, from this thread's current
        stream) and fold V_served - V* into the rolling window +
        gauges.  Runs on the maintenance thread only."""
        if self.oracle is None:
            return
        with self._lock:
            work = [(name, *st.subopt.take_pending())
                    for name, st in self._ctl.items()]
        for name, th, v_served in work:
            if th.size == 0:
                continue
            sol = self.oracle.solve_vertices(th)
            vstar = np.asarray(sol.Vstar, dtype=np.float64)
            dstar = np.asarray(sol.dstar)
            ok = (dstar >= 0) & np.isfinite(vstar)
            if not ok.any():
                continue
            # Served cost can sit an ulp below V* on interpolation
            # knife edges; the gap is clamped at 0 (the SLO is an
            # upper bound, not a signed residual).
            sub = np.maximum(0.0, v_served[ok] - vstar[ok])
            with self._lock:
                st = self.ctl(name)
                st.subopt.fold(sub)
                p50, p99 = st.subopt.quantiles()
                n = st.subopt.n_samples
                if st.ms:
                    st.ms["subopt_n"].inc(int(ok.sum()))
                    if p50 is not None:
                        st.ms["subopt_p50"].set(p50)
                        st.ms["subopt_p99"].set(p99)
                fire = (self.subopt_eps > 0 and p99 is not None
                        and n >= SUBOPT_MIN_SAMPLES
                        and p99 > self.subopt_eps
                        and (self._clock() - st.last_subopt_event_t
                             >= _SUBOPT_REFIRE_S))
                if fire:
                    st.last_subopt_event_t = self._clock()
            if fire:
                self._obs.event(
                    "health.subopt", severity="warn",
                    controller=name, value=round(p99, 6),
                    threshold=self.subopt_eps,
                    msg=(f"measured serving suboptimality p99 "
                         f"{p99:.4g} over {n} sampled re-solves "
                         f"[controller {name!r}] exceeds the eps "
                         f"budget {self.subopt_eps:g}: the tree is "
                         "serving answers outside its certificate -- "
                         "check provenance / trigger a rebuild"))

    def _periodic_snapshot(self) -> None:
        """The maintenance thread's snapshot, once the interval has
        passed since the last snapshot of ANY writer, checked under the
        snapshot lock: a caller's snapshot (a bench's epilogue, which
        then strict-loads it) is not overwritten by a periodic one that
        waited behind it."""
        with self._snap_lock:
            if self._clock() - self._last_snapshot \
                    >= self.snapshot_every_s:
                self.snapshot()

    def drain_for_test(self) -> None:
        """Synchronously run one subopt drain (deterministic tests --
        no sleeping on the maintenance thread's cadence)."""
        self._drain_subopt()

    # -- snapshot artifact -------------------------------------------------

    def _snapshot_one(self, name: str, dir_path: str) -> dict:
        """Write one controller's snapshot into `dir_path`
        (npz first, meta LAST -- the commit marker); returns the meta
        dict.  Caller holds no lock; state is copied under it."""
        with self._lock:
            st = self.ctl(name)
            ids, hits = st.sketch.items()
            mode = st.sketch.mode
            total = st.sketch.total
            n_rows = st.sketch.n_rows
            res_out = st.res_outside.sample()
            res_hole = st.res_hole.sample()
            n_out_seen = st.res_outside.n_seen
            n_hole_seen = st.res_hole.n_seen
            exc_lo = (st.exceed.lo.copy() if st.exceed is not None
                      else np.empty(0, dtype=np.int64))
            exc_hi = (st.exceed.hi.copy() if st.exceed is not None
                      else np.empty(0, dtype=np.int64))
            hot_dims = (st.exceed.hot_dims() if st.exceed is not None
                        else [])
            p50, p99 = st.subopt.quantiles()
            n_sub = st.subopt.n_samples
            n_offered = st.subopt.n_offered
            n_dropped = st.subopt.n_dropped
            sub_roll = np.asarray(st.subopt._roll, dtype=np.float64)
            n_leaves_hint = st.n_leaves_hint
            width = st.sketch.width
        os.makedirs(dir_path, exist_ok=True)
        npz_path = os.path.join(dir_path, "demand.npz")
        with atomic.atomic_file(npz_path) as f:
            np.savez(f, leaf_ids=ids, leaf_hits=hits,
                     exceed_lo=exc_lo, exceed_hi=exc_hi,
                     res_outside=res_out, res_hole=res_hole,
                     subopt=sub_roll)
        tdf = top_decile_frac(hits)
        meta = {
            "schema": SNAPSHOT_SCHEMA,
            "controller": name,
            "npz_sha256": atomic.file_sha256(npz_path),
            "window": {
                "decay_halflife_s": self.decay_halflife_s,
                "decayed_total": round(float(total), 3),
                "rows_total": int(n_rows),
                "written_t": time.time(),
            },
            "sketch": {
                "mode": mode,
                "max_leaves": self.max_leaves,
                "cm_depth": CM_DEPTH,
                "cm_width": width,
                "seed": self.seed,
                # Standard count-min guarantee for the documented
                # geometry (see module docstring).
                "error_bound": (
                    f"overestimate > 2*N/{width} with prob <= "
                    f"2^-{CM_DEPTH}; never underestimates"),
            },
            "leaves_observed": int(ids.size),
            "n_leaves_hint": n_leaves_hint,
            "top_decile_frac": tdf,
            "hot": [[int(i), round(float(h), 3)]
                    for i, h in zip(ids[:_TOP_K], hits[:_TOP_K])],
            "fallback": {
                "outside_seen": int(n_out_seen),
                "hole_seen": int(n_hole_seen),
                "exceed_dims": hot_dims,
            },
            "subopt": {
                "frac": self.subopt_frac,
                "eps": self.subopt_eps,
                "n_samples": int(n_sub),
                "n_offered": int(n_offered),
                "n_dropped": int(n_dropped),
                "p50": p50, "p99": p99,
            },
            "provenance": {
                "host": socket.gethostname(),
                "pid": os.getpid(),
            },
        }
        # demand.json is the COMMIT MARKER: it lands last, atomically,
        # carrying the npz digest -- load_demand refuses a directory
        # without it (or with a digest mismatch).
        atomic.atomic_write_json(os.path.join(dir_path, "demand.json"),
                                 meta, indent=1)
        return meta

    def snapshot(self, name: Optional[str] = None,
                 dir_path: Optional[str] = None) -> dict[str, dict]:
        """Publish snapshots for `name` (default: every controller
        seen) under ``<snapshot_dir>/<controller>/`` (or `dir_path`
        for a single named controller).  Returns {controller: meta};
        each write emits a ``demand.snapshot`` obs event and updates
        the demand gauges."""
        if not self.enabled:
            return {}
        with self._snap_lock:
            self._last_snapshot = self._clock()
            return self._snapshot_all(name, dir_path)

    def _snapshot_all(self, name: Optional[str],
                      dir_path: Optional[str]) -> dict[str, dict]:
        with self._lock:
            names = [name] if name is not None else sorted(self._ctl)
        out: dict[str, dict] = {}
        for nm in names:
            d = dir_path if dir_path is not None else (
                os.path.join(self.snapshot_dir, nm)
                if self.snapshot_dir else None)
            if d is None:
                raise ValueError("no snapshot_dir configured and no "
                                 "dir_path given")
            meta = self._snapshot_one(nm, d)
            out[nm] = meta
            with self._lock:
                st = self.ctl(nm)
                if st.ms:
                    st.ms["snapshots"].inc()
                    st.ms["leaves"].set(meta["leaves_observed"])
                    if meta["top_decile_frac"] is not None:
                        st.ms["top_decile"].set(
                            meta["top_decile_frac"])
            self._obs.event(
                "demand.snapshot", controller=nm, dir=d,
                leaves_observed=meta["leaves_observed"],
                top_decile_frac=meta["top_decile_frac"],
                hot=meta["hot"][:8],
                exceed_dims=meta["fallback"]["exceed_dims"],
                subopt_p50=meta["subopt"]["p50"],
                subopt_p99=meta["subopt"]["p99"],
                subopt_samples=meta["subopt"]["n_samples"],
                subopt_offered=meta["subopt"]["n_offered"])
        return out

    def top_decile(self, name: str) -> Optional[float]:
        with self._lock:
            st = self._ctl.get(name)
            if st is None:
                return None
            _ids, hits = st.sketch.items()
        return top_decile_frac(hits)

    def subopt_p99(self, name: str) -> Optional[float]:
        with self._lock:
            st = self._ctl.get(name)
            if st is None:
                return None
            return st.subopt.quantiles()[1]

    # -- lifecycle ---------------------------------------------------------

    def close(self, snapshot: bool = True) -> None:
        """Final snapshot (when a dir is configured) + stop the
        maintenance thread."""
        if not self.enabled:
            return
        t = self._thread
        with self._lock:
            self._closed = True
        self._wake.set()
        if t is not None:
            t.join(5.0)
        if self.oracle is not None:
            self._drain_subopt()
        if snapshot and self.snapshot_dir is not None:
            self.snapshot()

    def __enter__(self) -> "DemandHub":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def hub_from_serve_config(cfg, oracle=None,
                          obs: "obs_lib.Obs | None" = None
                          ) -> Optional[DemandHub]:
    """Build a DemandHub from ServeConfig's demand_* knobs; None when
    the knob family is off (the schedulers test `demand is not None`,
    so off costs nothing).  getattr-safe for configs pickled before
    the knobs existed."""
    mode = getattr(cfg, "demand", "off") or "off"
    if mode == "off":
        return None
    return DemandHub(
        mode=mode,
        max_leaves=getattr(cfg, "demand_max_leaves", 4096),
        decay_halflife_s=getattr(cfg, "demand_decay_s", 300.0),
        reservoir_k=getattr(cfg, "demand_reservoir", 64),
        subopt_frac=getattr(cfg, "demand_subopt_frac", 0.0),
        subopt_eps=getattr(cfg, "demand_subopt_eps", 0.0),
        snapshot_every_s=getattr(cfg, "demand_snapshot_every_s", 30.0),
        snapshot_dir=getattr(cfg, "demand_dir", None),
        oracle=oracle, obs=obs)


# -- snapshot loading / rebuild-priority consumption -----------------------


class DemandSnapshot:
    """One loaded (committed) demand snapshot."""

    __slots__ = ("meta", "leaf_ids", "leaf_hits", "exceed_lo",
                 "exceed_hi", "res_outside", "res_hole", "subopt")

    def __init__(self, meta: dict, arrays: dict):
        self.meta = meta
        self.leaf_ids = arrays["leaf_ids"]
        self.leaf_hits = arrays["leaf_hits"]
        self.exceed_lo = arrays["exceed_lo"]
        self.exceed_hi = arrays["exceed_hi"]
        self.res_outside = arrays["res_outside"]
        self.res_hole = arrays["res_hole"]
        self.subopt = arrays["subopt"]

    @property
    def top_decile_frac(self) -> Optional[float]:
        return top_decile_frac(self.leaf_hits)


def load_demand(dir_path: str) -> DemandSnapshot:
    """Load a committed snapshot directory; raises
    ``atomic.CorruptArtifact`` on anything torn: missing demand.json
    (the npz landed but the commit marker did not), a digest mismatch
    (truncated/bit-flipped npz under a stale marker), or an unknown
    schema.  FileNotFoundError when the directory itself is absent."""
    if not os.path.isdir(dir_path):
        raise FileNotFoundError(f"no demand snapshot dir {dir_path!r}")
    meta_path = os.path.join(dir_path, "demand.json")
    npz_path = os.path.join(dir_path, "demand.npz")
    if not os.path.exists(meta_path):
        raise atomic.CorruptArtifact(
            f"{dir_path}: demand.json missing -- the snapshot was "
            "never committed (torn write); refusing to load")
    with open(meta_path) as f:
        meta = json.load(f)
    if meta.get("schema") != SNAPSHOT_SCHEMA:
        raise atomic.CorruptArtifact(
            f"{meta_path}: unknown demand schema "
            f"{meta.get('schema')!r} (expected {SNAPSHOT_SCHEMA!r})")
    if not os.path.exists(npz_path):
        raise atomic.CorruptArtifact(
            f"{dir_path}: demand.npz missing under a committed "
            "demand.json -- the artifact directory is torn")
    got = atomic.file_sha256(npz_path)
    if got != meta.get("npz_sha256"):
        raise atomic.CorruptArtifact(
            f"{npz_path}: sha256 mismatch (recorded "
            f"{meta.get('npz_sha256')!r}, got {got!r}) -- truncated "
            "or bit-flipped after commit")
    with np.load(npz_path) as z:
        arrays = {k: np.array(z[k]) for k in z.files}
    return DemandSnapshot(meta, arrays)


def priority_from_snapshot(snap: DemandSnapshot,
                           node_id: np.ndarray) -> dict[int, float]:
    """{tree node id: decayed hits} rebuild priority hint: the
    snapshot counts GLOBAL leaf-table rows; `node_id` is the artifact's
    row -> tree-node map (``node_id.npy``, online/export.py).  Rows
    outside the table (a snapshot taken against a different version)
    are dropped -- the hint is best-effort by design."""
    node_id = np.asarray(node_id, dtype=np.int64)
    out: dict[int, float] = {}
    for row, hits in zip(snap.leaf_ids.tolist(),
                         snap.leaf_hits.tolist()):
        if 0 <= row < node_id.size:
            n = int(node_id[row])
            out[n] = out.get(n, 0.0) + float(hits)
    return out
