"""Host-level observability: competing-CPU-load sampling.

The torch port's copy of the JAX package's obs/host.py.
``ContentionMonitor`` samples how much CPU other processes burn while a
measurement runs; its readings fold into the shared gauge registry
(``host.competing_cpu_frac_mean`` / ``_max`` / ``host.contended``) next
to the build, oracle and serving metrics, and the /proc readers are
injectable so the guest-jiffies accounting is testable without a live
procfs.  ``obs`` and ``parallel.mesh`` re-export the class, as in the
JAX package.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np


class ContentionMonitor:
    """Background sampler of how much CPU OTHER processes burned while
    a measurement ran.

    Samples /proc/stat total busy jiffies against /proc/self/stat own
    (+reaped children) jiffies; the difference over elapsed capacity is
    the competing share.  summary() returns the load fields a
    measurement reports beside its numbers and, when built with a
    MetricsRegistry, sets the host.* gauges; a mean share above
    `threshold` marks the capture CONTENDED."""

    def __init__(self, interval_s: float = 2.0, threshold: float = 0.05,
                 metrics=None, stat_path: str = "/proc/stat",
                 self_stat_path: str = "/proc/self/stat", reader=None):
        """metrics: optional obs.MetricsRegistry the summary folds its
        gauges into.  stat_path/self_stat_path: procfs locations,
        overridable with fixture files (tests).  reader: full override
        of the jiffies sampler -- a callable returning (total busy
        jiffies, own jiffies) or None; tests drive the sampling loop
        with scripted sequences through it."""
        self.interval_s = interval_s
        self.threshold = threshold
        self.metrics = metrics
        self._stat_path = stat_path
        self._self_stat_path = self_stat_path
        self._reader = reader if reader is not None else self._jiffies
        self._stop = threading.Event()
        self._samples: list[float] = []
        self._thread: threading.Thread | None = None
        self._load_start = None

    @staticmethod
    def _busy_jiffies(vals: list[int]) -> int:
        """Total busy jiffies from the /proc/stat cpu-line fields
        (user nice system idle iowait irq softirq steal guest
        guest_nice).  idle + iowait are not busy; guest + guest_nice
        are ALREADY counted inside user/nice (kernel accounting), so
        they must come off too or VM hosts running guests double-count
        and overstate the competing-CPU share."""
        busy = sum(vals) - vals[3] - (vals[4] if len(vals) > 4 else 0)
        busy -= (vals[8] if len(vals) > 8 else 0)   # guest
        busy -= (vals[9] if len(vals) > 9 else 0)   # guest_nice
        return busy

    def _jiffies(self) -> tuple[int, int] | None:
        try:
            with open(self._stat_path) as f:
                vals = [int(x) for x in f.readline().split()[1:]]
            if not any(vals):
                # A procfs that counts no CPU time at all (some
                # container hosts): contention is not measured, and no gauge
                # must read it as an uncontended 0.
                return None
            busy = ContentionMonitor._busy_jiffies(vals)
            with open(self._self_stat_path) as f:
                st = f.read().rsplit(")", 1)[1].split()
            own = sum(int(x) for x in st[11:15])  # utime stime cu cs
            return busy, own
        except (OSError, IndexError, ValueError):
            return None  # non-procfs host: monitor degrades to loadavg

    @staticmethod
    def _competing_frac(prev: tuple[int, int], cur: tuple[int, int],
                        capacity_jiffies: float) -> float:
        """Competing-CPU share over one interval: (total busy delta -
        own delta) / capacity, clamped to [0, 1]."""
        other = (cur[0] - prev[0]) - (cur[1] - prev[1])
        return min(1.0, max(0.0, other / capacity_jiffies))

    def _run(self) -> None:
        hz = os.sysconf("SC_CLK_TCK")
        ncpu = os.cpu_count() or 1
        prev, prev_t = self._reader(), time.time()
        while not self._stop.wait(self.interval_s):
            cur, now = self._reader(), time.time()
            if prev is not None and cur is not None:
                cap = (now - prev_t) * hz * ncpu
                if cap > 0:
                    self._samples.append(
                        self._competing_frac(prev, cur, cap))
            prev, prev_t = cur, now

    def start(self) -> "ContentionMonitor":
        try:
            self._load_start = os.getloadavg()
        except OSError:
            pass
        if self._reader() is not None:
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()
        return self

    def summary(self) -> dict:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.interval_s)
        out = {"cpu_count": os.cpu_count()}
        try:
            out["loadavg_end"] = [round(x, 2) for x in os.getloadavg()]
        except OSError:
            pass
        if self._load_start is not None:
            out["loadavg_start"] = [round(x, 2) for x in self._load_start]
        if self._samples:
            mean = float(np.mean(self._samples))
            out.update(
                competing_cpu_frac_mean=round(mean, 3),
                competing_cpu_frac_max=round(max(self._samples), 3),
                contended=mean > self.threshold)
        if self.metrics is not None:
            m = self.metrics
            m.gauge("host.cpu_count").set(os.cpu_count() or 1)
            if self._samples:
                m.gauge("host.competing_cpu_frac_mean").set(
                    out["competing_cpu_frac_mean"])
                m.gauge("host.competing_cpu_frac_max").set(
                    out["competing_cpu_frac_max"])
                m.gauge("host.contended").set(float(out["contended"]))
        return out
