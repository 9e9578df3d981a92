"""Typed metrics registry: counters, gauges, log-bucket histograms.

Prometheus-shaped but in-process and dependency-free: the frontier
build, the oracle stack, and sharded serving all record into one
registry; `snapshot()` returns a plain JSON-ready dict and `emit()`
writes it to the JSONL sink as a single ``kind="metrics"`` record.
Histograms use FIXED log-spaced bucket boundaries -- never derived
from the data -- so two snapshots (or two runs, or a run and the last
BENCH_*.json) are always bucket-compatible and scripts/obs_report.py
can diff them without re-binning.
"""

from __future__ import annotations

import bisect
import math
import threading
from typing import Optional, Sequence

# 5 buckets per decade, 100 ns .. 100 s: spans one IPM iteration
# through a whole checkpointed frontier step.  Fixed by construction
# (see module docstring).
DEFAULT_LATENCY_BOUNDS: tuple[float, ...] = tuple(
    10.0 ** (e / 5.0) for e in range(-35, 11))


class Counter:
    """Monotonic counter.  inc() is guarded by the registry-wide GIL
    contract: single bytecode-level += per call, incremented from one
    producer thread per name in practice."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-write-wins scalar (frontier size, device_frac, shard
    imbalance, competing-CPU share)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed-bound histogram with len(bounds)+1 cells:
    counts[i] counts observations v with bounds[i-1] < v <= bounds[i]
    (counts[0]: v <= bounds[0]; counts[-1]: v > bounds[-1]).

    observe(value, n=k) records k observations of the same value in one
    call -- the batched-oracle pattern: one device program solves n QPs
    in wall seconds w, so per-QP latency w/n is observed with weight n
    and the histogram's quantiles stay per-solve figures."""

    __slots__ = ("bounds", "counts", "count", "sum", "min", "max",
                 "_lock")

    def __init__(self, bounds: Optional[Sequence[float]] = None):
        self.bounds = tuple(float(b) for b in
                            (bounds if bounds is not None
                             else DEFAULT_LATENCY_BOUNDS))
        self.counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._lock = threading.Lock()

    def observe(self, value: float, n: int = 1) -> None:
        v = float(value)
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self.counts[i] += n
            self.count += n
            self.sum += v * n
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v

    def snapshot(self) -> dict:
        with self._lock:
            return {"bounds": list(self.bounds),
                    "counts": list(self.counts),
                    "count": self.count, "sum": self.sum,
                    "min": (self.min if self.count else None),
                    "max": (self.max if self.count else None)}


def quantile(hist: dict, q: float) -> Optional[float]:
    """q-quantile estimate from a Histogram.snapshot() dict.

    Log-linear interpolation inside the landing bucket (the bounds are
    log-spaced, so this is linear in the exponent); the recorded exact
    min/max clamp the open-ended tail buckets.  Works on dicts so
    scripts/obs_report.py can compute quantiles from a parsed JSONL
    snapshot without reconstructing Histogram objects."""
    count = hist["count"]
    if not count:
        return None
    bounds, counts = hist["bounds"], hist["counts"]
    target = q * count
    cum = 0
    for i, c in enumerate(counts):
        if c == 0:
            continue
        lo_cum = cum
        cum += c
        if cum >= target:
            lo = bounds[i - 1] if i > 0 else hist["min"]
            hi = bounds[i] if i < len(bounds) else hist["max"]
            lo = max(lo, hist["min"])
            hi = max(lo, min(hi, hist["max"]))
            frac = (target - lo_cum) / c
            if lo <= 0.0 or hi <= 0.0:
                return float(lo + frac * (hi - lo))
            return float(lo * (hi / lo) ** frac)
    return float(hist["max"])


def histogram_row(h: dict, quantiles: Sequence[float] = (0.5, 0.99)
                  ) -> dict:
    """Condense one Histogram.snapshot() dict to count/mean/min/max +
    quantile fields (p50, p99, ...).  The ONE reduction behind both
    MetricsRegistry.summary() (the bench `metrics` block) and
    scripts/obs_report.py's rendered rows -- two copies would let the
    bench block and the report rows drift apart and diff_bench compare
    mismatched semantics."""
    row = {"count": h["count"],
           "mean": (h["sum"] / h["count"]) if h["count"] else None,
           "min": h["min"], "max": h["max"]}
    for q in quantiles:
        row[f"p{round(q * 100):d}"] = quantile(h, q)
    return row


class MetricsRegistry:
    """Name -> metric map with get-or-create accessors.

    Creation is lock-guarded; the returned metric objects are cached by
    the instrumentation sites, so the hot path touches only the metric
    itself."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._hists: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter()
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge()
            return g

    def histogram(self, name: str,
                  bounds: Optional[Sequence[float]] = None) -> Histogram:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram(bounds)
            return h

    def snapshot(self) -> dict:
        """Full plain-dict state: counters/gauges by name, histograms
        as Histogram.snapshot() dicts.  JSON-ready."""
        with self._lock:
            counters = dict(sorted(self._counters.items()))
            gauges = dict(sorted(self._gauges.items()))
            hists = dict(sorted(self._hists.items()))
        return {"counters": {k: c.value for k, c in counters.items()},
                "gauges": {k: g.value for k, g in gauges.items()},
                "histograms": {k: h.snapshot() for k, h in hists.items()}}

    def summary(self, quantiles: Sequence[float] = (0.5, 0.99)) -> dict:
        """Condensed snapshot for artifact JSON (the bench.py `metrics`
        block): counters + gauges verbatim, histograms reduced to
        count/mean/min/max plus the requested quantiles."""
        snap = self.snapshot()
        return {"counters": snap["counters"], "gauges": snap["gauges"],
                "histograms": {k: histogram_row(h, quantiles)
                               for k, h in snap["histograms"].items()}}

    def emit(self, sink) -> dict:
        """One kind="metrics" record holding the full snapshot.
        Returns the emitted record -- the ONE producer of the
        'metrics'/'snapshot' record shape; consumers that also feed a
        HealthMonitor (frontier step, long_build checkpoints) reuse
        the dict instead of re-inlining the shape."""
        return sink.emit("metrics", "snapshot", **self.snapshot())
