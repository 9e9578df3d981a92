"""Unified tracing + metrics across build, oracle, and sharded serving.

One ``Obs`` handle bundles the three obs primitives:

- ``span("name")`` -- nested tracing context managers (obs.trace):
  wall + thread-CPU time per host region, optional
  torch.profiler.record_function passthrough so host spans line up with
  device traces (mode='full');
- a typed metrics registry (obs.metrics): counters, gauges, fixed
  log-bucket latency histograms, ``snapshot()`` -> plain dict;
- a thread-safe in-memory + JSONL sink (obs.sink) every record flows
  through, with the versioned schema docs/observability.md describes.

Modes (config.PartitionConfig.obs): 'off' -- every call is a shared
no-op (measured sub-microsecond; tests/test_obs_schema.py bounds the
per-step cost under 1% of build wall); 'jsonl' -- spans/events/metric
snapshots stream to ``obs_path`` (or stay in memory when no path);
'full' -- jsonl plus device-trace annotations.

Instrumented layers: partition/frontier.py (per-step throughput,
device_frac, backlog), oracle/oracle.py (solve-time histograms, IPM
iteration counters).  The
diagnostics built on top in the JAX package (flight recorder, health
watchdog, SLO engine, fleet merging) are not yet ported (ROADMAP A2/A5).
"""

from __future__ import annotations

import contextlib
from typing import Optional

from explicit_hybrid_mpc_tpu_torch.obs.metrics import (  # noqa: F401
    DEFAULT_LATENCY_BOUNDS, Counter, Gauge, Histogram, MetricsRegistry,
    histogram_row, quantile)
from explicit_hybrid_mpc_tpu_torch.obs.sink import (  # noqa: F401
    SCHEMA_VERSION, JsonlSink, json_default, load_jsonl)
from explicit_hybrid_mpc_tpu_torch.obs.trace import Tracer  # noqa: F401

MODES = ("off", "jsonl", "full")


class _NullMetric:
    """Shared no-op counter/gauge/histogram for mode='off'."""

    __slots__ = ()
    value = 0

    def inc(self, n: int = 1) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, value: float, n: int = 1) -> None:
        pass


_NULL_METRIC = _NullMetric()
# One reusable nullcontext for off-mode spans.  It yields a SHARED attrs
# dict: callers may write span attrs into it (each site uses a fixed key
# set, so it stays bounded) and nothing ever reads it back.
_NULL_SPAN = contextlib.nullcontext({})


class Obs:
    """The unified observability handle (see module docstring)."""

    def __init__(self, mode: str = "off", path: Optional[str] = None,
                 echo: bool = False, base_t: float = 0.0,
                 per_process: bool = False):
        """per_process: suffix `path` with ``.pI-PID`` (obs/fleet.py)
        so N processes sharing one configured stream path -- a
        supervised restart chain, a multi-process pjit build, co-host
        serve replicas -- never interleave one file; readers resolve
        the bare name (sink.load_jsonl) and fleet tooling
        (obs_report/obs_watch --fleet) merges the family."""
        if mode not in MODES:
            raise ValueError(f"unknown obs mode {mode!r} "
                             f"(expected one of {MODES})")
        self.mode = mode
        self.enabled = mode != "off"
        if self.enabled:
            if path and per_process:
                raise NotImplementedError(
                    "per-process obs streams are not yet ported to the "
                    "torch package (ROADMAP A5: obs/fleet.py)")
            self.sink = JsonlSink(path, echo=echo, base_t=base_t,
                                  schema_meta=True)
            self.metrics = MetricsRegistry()
            self.tracer = Tracer(self.sink,
                                 device_annotations=(mode == "full"))
        else:
            self.sink = None
            self.metrics = None
            self.tracer = None

    # -- tracing -----------------------------------------------------------

    def span(self, name: str, **attrs):
        if not self.enabled:
            return _NULL_SPAN
        return self.tracer.span(name, **attrs)

    def event(self, name: str, **fields) -> Optional[dict]:
        """Emit one event record; returns it (callers that also feed a
        HealthMonitor reuse the dict instead of rebuilding it)."""
        if self.enabled:
            return self.sink.emit("event", name, **fields)
        return None

    # -- metrics -----------------------------------------------------------

    def counter(self, name: str):
        return self.metrics.counter(name) if self.enabled else _NULL_METRIC

    def gauge(self, name: str):
        return self.metrics.gauge(name) if self.enabled else _NULL_METRIC

    def histogram(self, name: str, bounds=None):
        return (self.metrics.histogram(name, bounds) if self.enabled
                else _NULL_METRIC)

    def flush_metrics(self) -> Optional[dict]:
        """Write one metrics-snapshot record to the stream; returns it
        (None when disabled)."""
        if self.enabled:
            return self.metrics.emit(self.sink)
        return None

    # -- lifecycle ---------------------------------------------------------

    def close(self, snapshot: bool = True) -> None:
        """Final metrics snapshot (unless snapshot=False) + file close."""
        if self.enabled:
            if snapshot:
                self.flush_metrics()
            self.sink.close()

    def __enter__(self) -> "Obs":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


#: The shared disabled handle -- default for every instrumented layer.
NOOP = Obs("off")


def from_config(cfg) -> Obs:
    """Build an Obs from PartitionConfig's obs / obs_path knobs
    (getattr-safe: configs pickled before the knobs existed resolve to
    'off')."""
    mode = getattr(cfg, "obs", "off") or "off"
    if mode == "off":
        return NOOP
    return Obs(mode, path=getattr(cfg, "obs_path", None),
               per_process=getattr(cfg, "obs_per_process", False))


_default: Obs = NOOP


def set_default(o: Optional[Obs]) -> Obs:
    """Install the process-wide default handle, used by free functions
    whose call chains predate the obs plumbing (descent export, leaf
    staging).  Pass None to reset to NOOP."""
    global _default
    _default = o if o is not None else NOOP
    return _default


def default() -> Obs:
    return _default
