"""Torch port: ``obs/host.py``'s ContentionMonitor against the JAX
package's.

The /proc arithmetic (``_busy_jiffies`` on /proc/stat cpu lines,
``_competing_frac`` on jiffy pairs) must equal the JAX package's on the
same scripted inputs, exactly.  The sampling loop is driven
synchronously through a scripted ``reader`` and a scripted wall clock,
so the two monitors see the same samples; ``summary()`` must then equal
the JAX package's key for key and set the same ``host.*`` gauges."""

import os
import time

import pytest

import explicit_hybrid_mpc_tpu  # noqa: F401
from explicit_hybrid_mpc_tpu.obs import MetricsRegistry as JaxRegistry
from explicit_hybrid_mpc_tpu.obs.host import (
    ContentionMonitor as JaxMonitor)
from explicit_hybrid_mpc_tpu_torch import obs
from explicit_hybrid_mpc_tpu_torch.obs import MetricsRegistry
from explicit_hybrid_mpc_tpu_torch.obs.host import ContentionMonitor
from explicit_hybrid_mpc_tpu_torch.parallel import mesh

#: /proc/stat cpu-line fields (user nice system idle iowait irq softirq
#: steal guest guest_nice), from old kernels' four fields to a VM host
#: running guests.
STAT_LINES = [
    [100, 0, 50, 1000],
    [100, 5, 50, 1000, 20],
    [4000, 10, 900, 88000, 300, 0, 12, 0],
    [4000, 10, 900, 88000, 300, 0, 12, 0, 700, 0],
    [52000, 310, 9100, 1200000, 5400, 0, 310, 44, 20000, 150],
]

#: (previous (busy, own), current (busy, own), capacity jiffies).
FRAC_CASES = [
    ((1000, 100), (1400, 200), 800.0),
    ((1000, 100), (1100, 200), 800.0),      # own > total: clamped to 0
    ((0, 0), (5000, 0), 800.0),             # clamped to 1
    ((500, 500), (500, 500), 100.0),
    ((12345, 678), (13345, 1178), 4000.0),
]

#: Scripted (busy, own) jiffy readings, one per interval (None: a
#: procfs read that failed).
READINGS = {
    "idle_host": [(1000, 100), (1100, 200), (1200, 300), (1300, 400)],
    "contended": [(1000, 100), (3000, 150), (5200, 180), (7000, 250)],
    "flaky_reads": [(1000, 100), None, (2000, 300), (2600, 320),
                    None, (3000, 400)],
    "one_sample": [(0, 0), (100, 10)],
}


@pytest.mark.parametrize("vals", STAT_LINES)
def test_busy_jiffies_matches_the_jax_package(vals):
    assert ContentionMonitor._busy_jiffies(list(vals)) \
        == JaxMonitor._busy_jiffies(list(vals))


@pytest.mark.parametrize("prev,cur,cap", FRAC_CASES)
def test_competing_frac_matches_the_jax_package(prev, cur, cap):
    got = ContentionMonitor._competing_frac(prev, cur, cap)
    assert got == JaxMonitor._competing_frac(prev, cur, cap)
    assert 0.0 <= got <= 1.0


def _scripted_summary(cls, registry, readings, monkeypatch):
    """Run `cls`'s sampling loop on this thread over `readings` (one per
    interval) with a wall clock that advances 1 s a read, then return
    its summary()."""
    seq = list(readings)
    clock = iter(range(10_000))
    monkeypatch.setattr(time, "time", lambda: float(next(clock)))
    mon = cls(interval_s=0.0, threshold=0.05, metrics=registry,
              reader=None)

    def reader():
        val = seq.pop(0)
        if not seq:
            mon._stop.set()   # the last reading ends the loop
        return val

    mon._reader = reader
    mon._run()
    monkeypatch.undo()
    return mon.summary()


@pytest.mark.parametrize("key", sorted(READINGS))
def test_summary_and_gauges_match_the_jax_package(key, monkeypatch):
    reg, jreg = MetricsRegistry(), JaxRegistry()
    got = _scripted_summary(ContentionMonitor, reg, READINGS[key],
                            monkeypatch)
    ref = _scripted_summary(JaxMonitor, jreg, READINGS[key], monkeypatch)
    # loadavg_end is read at summary() time, a moment apart.
    got.pop("loadavg_end", None)
    ref.pop("loadavg_end", None)
    assert got == ref
    assert "competing_cpu_frac_mean" in got
    gauges = {k: v for k, v in reg.snapshot()["gauges"].items()
              if k.startswith("host.")}
    jgauges = {k: v for k, v in jreg.snapshot()["gauges"].items()
               if k.startswith("host.")}
    assert gauges == jgauges
    assert set(gauges) == {"host.cpu_count", "host.competing_cpu_frac_mean",
                           "host.competing_cpu_frac_max", "host.contended"}


def test_contended_verdict_follows_the_threshold(monkeypatch):
    hot = _scripted_summary(ContentionMonitor, None, READINGS["contended"],
                            monkeypatch)
    cold = _scripted_summary(ContentionMonitor, None,
                             READINGS["idle_host"], monkeypatch)
    assert hot["contended"] is True and cold["contended"] is False
    assert hot["competing_cpu_frac_max"] >= hot["competing_cpu_frac_mean"]


def test_jiffies_from_procfs_files_match_the_jax_package(tmp_path):
    stat = tmp_path / "stat"
    stat.write_text("cpu  4000 10 900 88000 300 0 12 0 700 0\n"
                    "cpu0 2000 5 450 44000 150 0 6 0 350 0\n")
    self_stat = tmp_path / "self_stat"
    self_stat.write_text("4242 (python (x) y) S 1 2 3 4 5 6 7 8 9 10 "
                         "111 22 33 44 20 0 1 0 5 6 7\n")
    kw = dict(stat_path=str(stat), self_stat_path=str(self_stat))
    got = ContentionMonitor(**kw)._jiffies()
    assert got == JaxMonitor(**kw)._jiffies()
    # user nice system irq softirq steal (guest is inside user).
    assert got == (4000 + 10 + 900 + 0 + 12 + 0, 111 + 22 + 33 + 44)
    missing = dict(stat_path=str(tmp_path / "none"),
                   self_stat_path=str(self_stat))
    assert ContentionMonitor(**missing)._jiffies() is None
    assert JaxMonitor(**missing)._jiffies() is None


def test_no_procfs_degrades_to_loadavg_only():
    """A reader that cannot sample starts no thread; the summary holds
    the load fields only, as the JAX package's does."""
    got = ContentionMonitor(reader=lambda: None).start().summary()
    ref = JaxMonitor(reader=lambda: None).start().summary()
    assert set(got) == set(ref)
    assert "competing_cpu_frac_mean" not in got
    assert got["cpu_count"] == os.cpu_count()


def test_live_monitor_samples_this_host():
    """The real procfs reader over a few short intervals gives shares
    in [0, 1] and the JAX package's summary keys (the sample keys only
    where an interval completed)."""
    sample_keys = {"competing_cpu_frac_mean", "competing_cpu_frac_max",
                   "contended"}
    mon = ContentionMonitor(interval_s=0.05).start()
    jmon = JaxMonitor(interval_s=0.05).start()
    time.sleep(0.3)
    got, ref = mon.summary(), jmon.summary()
    assert set(got) - sample_keys == set(ref) - sample_keys
    if "competing_cpu_frac_mean" in got:
        assert set(got) >= sample_keys
        assert 0.0 <= got["competing_cpu_frac_mean"] \
            <= got["competing_cpu_frac_max"] <= 1.0


def test_reexported_from_obs_and_parallel_mesh():
    assert obs.ContentionMonitor is ContentionMonitor
    assert mesh.ContentionMonitor is ContentionMonitor
