"""Torch port: fleet telemetry (``obs/fleet.py``, ``obs/clock.py``'s
anchor, per-process streams) and the health-triggered auto-profile
capture, against the JAX package's obs/fleet.py and tests/test_fleet.py.

Hand-written streams go through both packages' readers; streams that
the port's own per-process sinks wrote (two processes sharing one
configured path) give equal ``fleet_rollup``, ``merge_events`` and
``straggler_report`` under both packages; the FleetMonitor's rules
fire alike.  The auto-profile schedule of the JAX package's
tests/test_fleet.py (a DI build, ``stall_s`` 0.2, two 0.4 s hangs at
``oracle.wait``) opens exactly one capture on the CPU, as it does on
the card (chip_smoke.py phase 18c)."""

import glob
import json
import os
import subprocess
import sys

import pytest
import torch

import explicit_hybrid_mpc_tpu  # noqa: F401
from explicit_hybrid_mpc_tpu.obs import clock as jclock
from explicit_hybrid_mpc_tpu.obs import fleet as jfleet
from explicit_hybrid_mpc_tpu_torch import faults as faults_lib
from explicit_hybrid_mpc_tpu_torch import obs as obs_lib
from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
from explicit_hybrid_mpc_tpu_torch.faults.plan import FaultPlan
from explicit_hybrid_mpc_tpu_torch.obs import clock, fleet
from explicit_hybrid_mpc_tpu_torch.obs.sink import (SCHEMA_VERSION,
                                                    load_jsonl)
from explicit_hybrid_mpc_tpu_torch.partition.frontier import build_partition
from explicit_hybrid_mpc_tpu_torch.problems.registry import make

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_stream(path, records, version=SCHEMA_VERSION, identity=None):
    with open(path, "w") as f:
        f.write(json.dumps({"t": 0.0, "kind": "meta", "name": "schema",
                            "version": version}) + "\n")
        if identity is not None:
            f.write(json.dumps({"t": identity.get("t", 0.0),
                                "kind": "meta", "name": "stream",
                                **identity}) + "\n")
        for r in records:
            f.write(json.dumps(r) + "\n")
    return path


def _ident(wall, pid, idx=0, host="h", count=2):
    return {"t": 0.0, "wall_time": wall, "run_id": "r", "pid": pid,
            "host": host, "process_index": idx, "process_count": count}


def _progress_stream(tmp_path, name, wall0, rate, n=6, pid=1, idx=0):
    recs = [{"t": float(i), "kind": "event", "name": "build.step",
             "step": i, "regions": int(i * rate)}
            for i in range(1, n + 1)]
    return _write_stream(str(tmp_path / name), recs,
                         identity=_ident(wall0, pid, idx))


# -- identity, anchor, naming ---------------------------------------------

def test_identity_record_and_anchor(tmp_path):
    p = str(tmp_path / "x.obs.jsonl")
    with obs_lib.Obs("jsonl", path=p):
        pass
    ident = load_jsonl(p)[1]
    assert (ident["kind"], ident["name"]) == ("meta", "stream")
    off = clock.wall_offset(ident)
    assert off == jclock.wall_offset(ident) is not None
    assert clock.to_wall(ident, ident["t"]) == pytest.approx(
        ident["wall_time"])
    assert clock.to_wall(ident, 2.5) == jclock.to_wall(ident, 2.5)
    assert clock.wall_offset({}) is None and clock.to_wall({}, 1.0) is None


@pytest.mark.parametrize("args", [("a/b.obs.jsonl", 3, 77),
                                  ("noext", 0, 5), ("x.y.z", 1, 2)])
def test_per_process_path_matches_the_reference(args):
    assert fleet.per_process_path(*args) == jfleet.per_process_path(*args)


def test_bare_name_resolution(tmp_path):
    bare = str(tmp_path / "run.obs.jsonl")
    o = obs_lib.Obs("jsonl", path=bare, per_process=True)
    o.event("tick", i=1)
    o.close()
    assert not os.path.exists(bare)
    assert len(fleet.sibling_streams(bare)) == 1
    assert any(r.get("name") == "tick" for r in load_jsonl(bare))
    _write_stream(str(tmp_path / "run.obs.p0-99999.jsonl"), [])
    with pytest.raises(FileNotFoundError, match="fleet"):
        load_jsonl(bare)
    assert len(fleet.load_fleet(bare)) == 2
    assert fleet.resolve_streams(bare) == jfleet.resolve_streams(bare)
    assert fleet.resolve_streams(str(tmp_path)) \
        == jfleet.resolve_streams(str(tmp_path))


# -- hand-written streams through both readers ------------------------------

def _same(a, b):
    return json.dumps(a, sort_keys=True, default=str) \
        == json.dumps(b, sort_keys=True, default=str)


def _both(paths):
    return fleet.load_fleet(paths), jfleet.load_fleet(paths)


def test_merge_orders_by_wall_anchor(tmp_path):
    steps = [{"t": 1.0, "kind": "event", "name": "build.step", "step": 1},
             {"t": 3.0, "kind": "event", "name": "build.step", "step": 2}]
    a = _write_stream(str(tmp_path / "a.jsonl"), steps,
                      identity=_ident(1000.0, 1, 0))
    b = _write_stream(str(tmp_path / "b.jsonl"), steps,
                      identity=_ident(1001.0, 2, 1))
    s, js = _both([a, b])
    merged = fleet.merge_events(s, kinds=("event",))
    assert [(r["shard"], r["step"]) for r in merged] == [
        ("p0:1", 1), ("p1:2", 1), ("p0:1", 2), ("p1:2", 2)]
    assert [r["t_abs"] for r in merged] == [1001.0, 1002.0, 1003.0, 1004.0]
    assert merged == jfleet.merge_events(js, kinds=("event",))


def test_rollup_counters_sum_bit_exact(tmp_path):
    big = 123_456_789_012_345
    hist = {"bounds": [1.0, 2.0], "counts": [1, 2, 3], "count": 6,
            "sum": 9.0, "min": 0.5, "max": 4.0}
    a = _write_stream(
        str(tmp_path / "a.jsonl"),
        [{"t": 1.0, "kind": "metrics", "name": "snapshot",
          "counters": {"oracle.point_solves": big, "build.leaves": 7},
          "gauges": {"build.regions": 7.0}, "histograms": {"x_s": hist}}],
        identity=_ident(10.0, 1, 0))
    b = _write_stream(
        str(tmp_path / "b.jsonl"),
        [{"t": 1.0, "kind": "metrics", "name": "snapshot",
          "counters": {"oracle.point_solves": 987_654_321,
                       "build.leaves": 5},
          "gauges": {"build.regions": 12.0},
          "histograms": {"x_s": {**hist, "counts": [0, 1, 0],
                                 "count": 1, "sum": 1.5, "min": 1.5,
                                 "max": 1.5}}}],
        identity=_ident(11.0, 2, 1))
    s, js = _both([a, b])
    roll = fleet.fleet_rollup(s)
    assert roll["counters"]["oracle.point_solves"] == big + 987_654_321
    assert roll["regions"] == 12.0 and roll["regions_sum"] == 19.0
    assert roll["histograms"]["x_s"]["counts"] == [1, 3, 3]
    assert _same(roll, jfleet.fleet_rollup(js))
    with pytest.raises(ValueError, match="bounds"):
        fleet.merge_histograms([hist, {**hist, "bounds": [1.0, 3.0]}])


def test_slo_rollup_matches_the_reference(tmp_path):
    snaps = [({"slo.p99.good_units": 90, "slo.p99.bad_units": 10},
              {"slo.p99.goal": 0.9, "slo.p99.burn_fast": 2.0,
               "slo.p99.budget_remaining_frac": 0.5}),
             ({"slo.p99.good_units": 50, "slo.p99.bad_units": 0},
              {"slo.p99.goal": 0.9, "slo.p99.burn_fast": 0.5,
               "slo.p99.budget_remaining_frac": 1.0})]
    paths = [_write_stream(
        str(tmp_path / f"s{i}.jsonl"),
        [{"t": 1.0, "kind": "metrics", "name": "snapshot", "counters": c,
          "gauges": g, "histograms": {}}], identity=_ident(5.0, i + 1, i))
        for i, (c, g) in enumerate(snaps)]
    s, js = _both(paths)
    roll = fleet.slo_rollup(s)
    assert roll["specs"]["p99"]["good"] == 140
    assert roll["specs"]["p99"]["burn_fast_max"] == 2.0
    assert _same(roll, jfleet.slo_rollup(js))


def test_v1_stream_tolerated_and_strict_issues(tmp_path):
    v1 = _write_stream(str(tmp_path / "v1.jsonl"),
                       [{"t": 1.0, "kind": "event", "name": "build.step",
                         "step": 1, "regions": 5}], version=1)
    v2 = _write_stream(str(tmp_path / "v2.jsonl"), [],
                       identity=_ident(1.0, 2, 0, count=1))
    s, js = _both([v1, v2])
    assert s[0].identity is None and s[0].schema_version == 1
    issues = fleet.strict_issues(s)
    assert issues == jfleet.strict_issues(js)
    assert any("mixed stream schema versions" in i for i in issues)
    assert fleet.strict_issues([s[1]]) == []


def test_straggler_report_concurrent_and_sequential(tmp_path):
    fast = _progress_stream(tmp_path, "fast.jsonl", 100.0, 100.0, pid=1,
                            idx=0)
    slow = _progress_stream(tmp_path, "slow.jsonl", 100.0, 10.0, pid=2,
                            idx=1)
    late = _progress_stream(tmp_path, "late.jsonl", 1000.0, 10.0, pid=3,
                            idx=0)
    for paths, concurrent in (([fast, slow], True), ([fast, late], False),
                              ([fast, slow, late], True)):
        s, js = _both(paths)
        rep = fleet.straggler_report(s)
        assert rep["concurrent"] is concurrent
        assert _same(rep, jfleet.straggler_report(js))
    rep = fleet.straggler_report(fleet.load_fleet([fast, slow]))
    assert rep["slowest"] == "p1:2" and rep["fastest"] == "p0:1"
    assert rep["straggle_frac"] == pytest.approx(0.9)


def test_shard_labels_deduped_across_hosts(tmp_path):
    for i, host in enumerate(("host-a", "host-b")):
        _write_stream(
            str(tmp_path / f"r{i}.jsonl"),
            [{"t": 1.0, "kind": "metrics", "name": "snapshot",
              "counters": {"build.leaves": 1}, "gauges": {},
              "histograms": {}}], identity=_ident(100.0, 1, 0, host=host))
    s, js = _both(str(tmp_path / "r*.jsonl"))
    assert [x.shard for x in s] == [x.shard for x in js]
    assert len({x.shard for x in s}) == 2
    assert fleet.fleet_rollup(s)["counters"]["build.leaves"] == 2


def test_fleet_monitor_rules(tmp_path):
    fast = _progress_stream(tmp_path, "fast.jsonl", 100.0, 100.0, pid=1,
                            idx=0)
    slow = _progress_stream(tmp_path, "slow.jsonl", 100.0, 10.0, pid=2,
                            idx=1)
    out = []
    for mod in (fleet, jfleet):
        streams = mod.load_fleet([fast, slow])
        mon = mod.FleetMonitor()
        for s in streams:
            for r in s.records:
                mon.feed(s.shard, r)
        evs = mon.finalize(streams)
        assert [e["name"] for e in evs] == ["health.shard_straggle"]
        assert mon.worst == "warn" and mon.exit_code == 1
        assert mon.finalize(streams) == []  # fires once
        live = mon.check_straggle_live()
        stall = mon.check_fleet_stall(400.0)
        assert [e["name"] for e in stall] == ["health.fleet_stall"]
        assert mon.exit_code == 2
        per = mon.check_stall("p0:1", 400.0)
        out.append((evs, live, stall, per, mon.summary()))
        with pytest.raises(ValueError, match="unknown health rule"):
            mod.FleetMonitor({"bogus": 1.0})
    assert _same(out[0], out[1])


# -- streams written by the port's per-process sinks -------------------------

_WRITER = r"""
import sys, time
from explicit_hybrid_mpc_tpu_torch import obs
path, rate = sys.argv[1], float(sys.argv[2])
o = obs.Obs("jsonl", path=path, per_process=True)
h = o.histogram("build.step_s")
for i in range(1, 7):
    o.event("build.step", step=i, regions=int(i * rate))
    o.counter("build.steps").inc()
    o.counter("oracle.point_solves").inc(1000 + i)
    o.gauge("build.regions").set(i * rate)
    h.observe(0.001 * i)
    if i % 3 == 0:
        o.flush_metrics()
    time.sleep(0.02)
o.close()
"""


@pytest.fixture(scope="module")
def port_streams(tmp_path_factory):
    d = tmp_path_factory.mktemp("fleet")
    path = str(d / "run.obs.jsonl")
    env = {**os.environ, "PYTHONPATH": REPO, "EHM_RUN_ID": "fleet0001"}
    procs = [subprocess.Popen([sys.executable, "-c", _WRITER, path, rate],
                              cwd=REPO, env=env)
             for rate in ("100", "10")]
    for p in procs:
        assert p.wait(timeout=120) == 0
    return path


def test_port_streams_roll_up_alike_under_both_packages(port_streams):
    paths = fleet.resolve_streams(port_streams)
    assert len(paths) == 2 and not os.path.exists(port_streams)
    s, js = fleet.load_fleet(port_streams), jfleet.load_fleet(port_streams)
    assert fleet.strict_issues(s) == [] == jfleet.strict_issues(js)
    assert {x.identity["run_id"] for x in s} == {"fleet0001"}
    roll = fleet.fleet_rollup(s)
    assert _same(roll, jfleet.fleet_rollup(js))
    last = [[r for r in x.records if r["kind"] == "metrics"][-1]
            for x in s]
    for k in ("build.steps", "oracle.point_solves"):
        assert roll["counters"][k] == sum(m["counters"][k] for m in last)
    assert roll["histograms"]["build.step_s"]["count"] == 12


def test_port_streams_merge_and_straggle_alike(port_streams):
    s, js = fleet.load_fleet(port_streams), jfleet.load_fleet(port_streams)
    merged = fleet.merge_events(s)
    assert merged == jfleet.merge_events(js)
    t = [r["t_abs"] for r in merged]
    assert t == sorted(t)
    assert _same(fleet.straggler_report(s), jfleet.straggler_report(js))


# -- auto-profile: the health monitor's trigger -------------------------------

def _auto_profile_build(tmp_path, kind):
    path = str(tmp_path / "run.obs.jsonl")
    prob = make("double_integrator", N=3, theta_box=1.5)
    cfg = PartitionConfig(eps_a=0.4, backend="cpu", batch_simplices=64,
                          obs="jsonl", obs_path=path, auto_profile=True,
                          profile_steps=2,
                          recorder_dir=str(tmp_path / "repro"),
                          health_rules=(("stall_s", 0.2),))
    # TWO hangs: the second stall must NOT open a second capture.
    plan = FaultPlan(faults=(
        {"site": "oracle.wait", "kind": kind, "at": 2, "hang_s": 0.4},
        {"site": "oracle.wait", "kind": kind, "at": 7, "hang_s": 0.4}))
    with faults_lib.activate(plan):
        res = build_partition(prob, cfg)
    return res, load_jsonl(path)


@pytest.mark.parametrize("kind", ["hang", "stall"])
def test_auto_profile_on_injected_stall(kind, tmp_path):
    """An injected hang (recovered on the CPU twin) or stall (the solve
    comes back late: the card's schedule) opens exactly ONE bounded
    capture with a summarized bundle."""
    res, recs = _auto_profile_build(tmp_path, kind)
    assert res.stats["regions"] > 0
    assert res.stats["device_failures"] == (2 if kind == "hang" else 0)
    stalls = [r for r in recs if r.get("name") == "health.stall"]
    assert stalls and stalls[0]["severity"] == "critical"
    assert len([r for r in recs if r.get("name") == "profile.capture"]) == 1
    (b,) = glob.glob(str(tmp_path / "repro" / "auto_profile_*.json"))
    bundle = json.load(open(b))
    assert bundle["reason"] == "health.stall" and "error" not in bundle
    summ = bundle["trace_summary"]
    assert summ.get("trace_files", 0) >= 1
    assert isinstance(summ.get("top_ops_ms"), list) and summ["top_ops_ms"]
    snap = [r for r in recs if r["kind"] == "metrics"][-1]
    assert snap["counters"]["build.auto_profiles"] == 1


def test_stall_fault_kind_sleeps_and_returns():
    plan = FaultPlan(faults=({"site": "build.step", "kind": "stall",
                              "hang_s": 0.05},))
    with faults_lib.activate(plan):
        assert faults_lib.fire("build.step") is None
        assert faults_lib.fire("build.step") is None
