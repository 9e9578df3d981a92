"""Torch port: the SLO engine (explicit_hybrid_mpc_tpu_torch/obs/slo.py).

The first part mirrors the JAX package's tests/test_slo.py case for
case on the port: spec validation, the three fold kinds, the
multi-window burn semantics (a sustained breach fires the fast pair
once, a brief spike of the same size does not), and bitwise restart
survival of the budget through the checksummed state file.

The second part holds the port to the JAX package in one process: the
same scripted snapshots (made from a seed with numpy) fed to both
trackers give bitwise equal ``evaluate()`` dicts, published metrics and
state files, and a state file written by either package restores in
the other to the same floats.  Host-only code: the bar is bitwise."""

import struct

import numpy as np
import pytest

from explicit_hybrid_mpc_tpu import obs as jobs_lib
from explicit_hybrid_mpc_tpu.obs import slo as jslo
from explicit_hybrid_mpc_tpu_torch import obs as obs_lib
from explicit_hybrid_mpc_tpu_torch.config import ServeConfig
from explicit_hybrid_mpc_tpu_torch.obs import slo as tslo
from explicit_hybrid_mpc_tpu_torch.obs.health import HealthMonitor
from explicit_hybrid_mpc_tpu_torch.obs.sink import load_jsonl
from explicit_hybrid_mpc_tpu_torch.obs.slo import (SloSpec, SloTracker,
                                                   build_slo_specs,
                                                   lifecycle_slo_specs,
                                                   serve_slo_specs,
                                                   slo_from_serve_config)

#: Test-scaled window geometry (the JAX tests' own): fast pair 5s/60s,
#: slow pair 120s/600s over a 1 s ring interval (600 slots).
WINDOWS = ((5.0, 60.0), (120.0, 600.0))
THRESH = (14.4, 1.0)


def _tracker(mod=tslo, **kw):
    kw.setdefault("interval_s", 1.0)
    kw.setdefault("windows", WINDOWS)
    kw.setdefault("burn_thresholds", THRESH)
    return mod.SloTracker(**kw)


def _avail_spec(mod=tslo, goal=0.999):
    return mod.SloSpec(name="t.avail", kind="counter", metric="bad",
                       total=("total",), goal=goal)


def _feed(tr, t, bad_cum, tot_cum):
    return tr.tick({"counters": {"bad": float(bad_cum),
                                 "total": float(tot_cum)}}, now=t)


def _bits(x: float) -> int:
    return struct.unpack("<Q", struct.pack("<d", x))[0]


# -- spec validation -------------------------------------------------------

def test_spec_rejects_unknown_kind():
    with pytest.raises(ValueError, match="unknown slo kind"):
        SloSpec(name="x", kind="ratio", metric="m")


def test_spec_rejects_goal_out_of_range():
    for goal in (0.0, 1.0, -0.5, 2.0):
        with pytest.raises(ValueError, match="goal"):
            SloSpec(name="x", kind="counter", metric="m",
                    total=("t",), goal=goal)


def test_spec_rejects_thresholdless_hist_and_gauge():
    for kind in ("hist_p", "gauge"):
        with pytest.raises(ValueError, match="threshold"):
            SloSpec(name="x", kind=kind, metric="m")


def test_counter_spec_normalizes_string_total():
    sp = SloSpec(name="x", kind="counter", metric="m", total="tot")
    assert sp.total == ("tot",)
    with pytest.raises(ValueError, match="total"):
        SloSpec(name="x", kind="counter", metric="m")


def test_tracker_rejects_bad_geometry():
    with pytest.raises(ValueError, match="finer than"):
        SloTracker(interval_s=10.0, windows=((5.0, 60.0),),
                   burn_thresholds=(1.0,))
    with pytest.raises(ValueError, match="1:1"):
        SloTracker(interval_s=1.0, windows=WINDOWS,
                   burn_thresholds=(1.0,))


# -- fold kinds ------------------------------------------------------------

def test_counter_fold_and_compliance():
    tr = _tracker(specs=[_avail_spec()])
    _feed(tr, 0.0, 0, 0)
    for i in range(1, 11):
        _feed(tr, float(i), 2 * i, 100 * i)   # 2% bad per interval
    rep = tr.evaluate()["t.avail"]
    assert rep["good"] == 980.0 and rep["bad"] == 20.0
    assert rep["compliance"] == pytest.approx(0.98)
    assert rep["budget_remaining_frac"] < -10


def test_counter_fold_tolerates_registry_restart():
    tr = _tracker(specs=[_avail_spec()])
    _feed(tr, 0.0, 5, 100)
    _feed(tr, 1.0, 2, 40)   # cumulative went BACKWARDS: fresh registry
    rep = tr.evaluate()["t.avail"]
    assert rep["bad"] == 7.0 and rep["good"] == 133.0


def test_hist_fold_splits_at_threshold():
    sp = SloSpec(name="t.p99", kind="hist_p", metric="lat",
                 threshold=100.0)
    tr = _tracker(specs=[sp])
    h1 = {"bounds": [10.0, 100.0, 1000.0], "counts": [5, 3, 2, 1],
          "count": 11}
    tr.tick({"histograms": {"lat": h1}}, now=0.0)
    rep = tr.evaluate()["t.p99"]
    assert rep["good"] == 8.0 and rep["bad"] == 3.0
    h2 = {"bounds": [10.0, 100.0, 1000.0], "counts": [6, 3, 2, 5],
          "count": 16}
    tr.tick({"histograms": {"lat": h2}}, now=1.0)
    rep = tr.evaluate()["t.p99"]
    assert rep["good"] == 9.0 and rep["bad"] == 7.0


def test_gauge_fold_one_unit_per_tick_absent_is_silent():
    sp = SloSpec(name="t.stale", kind="gauge", metric="staleness_s",
                 threshold=10.0)
    tr = _tracker(specs=[sp])
    tr.tick({"gauges": {}}, now=0.0)
    rep = tr.evaluate()["t.stale"]
    assert rep["good"] == 0.0 and rep["bad"] == 0.0
    tr.tick({"gauges": {"staleness_s": 3.0}}, now=1.0)
    tr.tick({"gauges": {"staleness_s": 30.0}}, now=2.0)
    rep = tr.evaluate()["t.stale"]
    assert rep["good"] == 1.0 and rep["bad"] == 1.0


def test_gap_zero_fills_and_burn_clears():
    tr = _tracker(specs=[_avail_spec()])
    _feed(tr, 0.0, 0, 0)
    _feed(tr, 1.0, 50, 100)
    assert tr.evaluate()["t.avail"]["burn_fast"] > THRESH[0]
    _feed(tr, 71.0, 50, 100)
    rep = tr.evaluate()["t.avail"]
    assert rep["burn_fast"] == 0.0
    assert rep["bad"] == 50.0


# -- burn semantics (the acceptance pair) ----------------------------------

def _burn_events(path, window):
    return [r for r in load_jsonl(path)
            if r.get("kind") == "event"
            and r.get("name") == "health.slo_burn"
            and r.get("window") == window]


def test_sustained_breach_fires_fast_pair_once(tmp_path):
    p = str(tmp_path / "s.obs.jsonl")
    with obs_lib.Obs("jsonl", path=p) as o:
        tr = _tracker(specs=[_avail_spec()], obs=o)
        _feed(tr, 0.0, 0, 0)
        for i in range(1, 131):
            _feed(tr, float(i), 30 * i, 100 * i)
    fast = _burn_events(p, "fast")
    assert len(fast) == 1
    ev = fast[0]
    assert ev["severity"] == "critical" and ev["spec"] == "t.avail"
    assert ev["value"] > 14.4
    assert "docs/observability.md" in ev["msg"]
    # A HealthMonitor fed the stream adopts the event (critical).
    mon = HealthMonitor()
    for r in load_jsonl(p):
        mon.feed(r)
    assert any(e["name"] == "health.slo_burn" for e in mon.events)
    assert mon.worst == "critical"


def test_brief_spike_of_same_magnitude_does_not_fire_fast(tmp_path):
    p = str(tmp_path / "s.obs.jsonl")
    with obs_lib.Obs("jsonl", path=p) as o:
        tr = _tracker(specs=[_avail_spec()], obs=o)
        _feed(tr, 0.0, 0, 0)
        for i in range(1, 61):
            _feed(tr, float(i), 0, 100 * i)
        _feed(tr, 61.0, 30, 6100)
        for i in range(62, 70):
            _feed(tr, float(i), 30, 100 * i)
    assert _burn_events(p, "fast") == []


def test_cleared_then_returned_breach_fires_again(tmp_path):
    p = str(tmp_path / "s.obs.jsonl")
    with obs_lib.Obs("jsonl", path=p) as o:
        tr = _tracker(specs=[_avail_spec()], obs=o)
        _feed(tr, 0.0, 0, 0)
        for i in range(1, 11):
            _feed(tr, float(i), 30 * i, 100 * i)
        bad, tot = 300, 1000
        for i in range(11, 81):
            tot += 100
            _feed(tr, float(i), bad, tot)
        for i in range(81, 91):
            bad += 30
            tot += 100
            _feed(tr, float(i), bad, tot)
    assert len(_burn_events(p, "fast")) == 2


# -- durability ------------------------------------------------------------

def test_budget_survives_restart_bitwise(tmp_path):
    sd = str(tmp_path / "slo")
    tr = _tracker(specs=[_avail_spec()], state_dir=sd, identity="t")
    _feed(tr, 0.0, 0, 0)
    for i in range(1, 31):
        _feed(tr, float(i), 0.1 * i, 33.3 * i)
    before = tr.evaluate(now=30.0)["t.avail"]
    tr.flush()
    tr2 = _tracker(specs=[_avail_spec()], state_dir=sd, identity="t")
    after = tr2.evaluate(now=30.0)["t.avail"]
    for field in ("good", "bad", "compliance", "budget_remaining_frac",
                  "burn_fast", "burn_slow"):
        assert _bits(after[field]) == _bits(before[field]), field


def test_restart_preserves_runtime_discovered_specs(tmp_path):
    sd = str(tmp_path / "slo")
    tpl = {"p99_target_us": 1000.0, "goal": 0.99}
    tr = _tracker(serve_template=tpl, state_dir=sd, identity="t")
    tr.tick({"counters": {"serve.ctl.A.requests": 100,
                          "serve.ctl.A.fallbacks": 7}}, now=0.0)
    tr.tick({"counters": {"serve.ctl.A.requests": 200,
                          "serve.ctl.A.fallbacks": 7}}, now=1.0)
    tr.flush()
    tr2 = _tracker(serve_template=tpl, state_dir=sd, identity="t")
    rep = tr2.evaluate(now=1.0)
    assert rep["A.fallback"]["bad"] == 7.0
    assert {"A.p99", "A.p99_roll", "A.fallback"} <= set(rep)


def test_corrupt_state_rejected_starts_empty(tmp_path):
    sd = str(tmp_path / "slo")
    o = obs_lib.Obs("jsonl")
    tr = _tracker(specs=[_avail_spec()], state_dir=sd, identity="t")
    _feed(tr, 0.0, 0, 0)
    _feed(tr, 1.0, 5, 100)
    tr.flush()
    with open(tr._state_path(), "r+b") as f:
        f.seek(20)
        f.write(b"\xff\xff\xff")
    tr2 = _tracker(specs=[_avail_spec()], state_dir=sd, identity="t",
                   obs=o)
    rep = tr2.evaluate(now=1.0)["t.avail"]
    assert rep["good"] == 0.0 and rep["bad"] == 0.0
    assert [r["name"] for r in o.sink.records
            if r.get("kind") == "event"] == ["slo.state_rejected"]


def test_geometry_mismatch_rejected(tmp_path):
    sd = str(tmp_path / "slo")
    tr = _tracker(specs=[_avail_spec()], state_dir=sd, identity="t")
    _feed(tr, 0.0, 0, 0)
    _feed(tr, 1.0, 5, 100)
    tr.flush()
    tr2 = SloTracker([_avail_spec()], interval_s=2.0, windows=WINDOWS,
                     burn_thresholds=THRESH, state_dir=sd, identity="t")
    rep = tr2.evaluate(now=1.0)["t.avail"]
    assert rep["good"] == 0.0 and rep["bad"] == 0.0


# -- factories + publication ----------------------------------------------

def test_spec_factories_cover_documented_objectives():
    names = {s.name for s in serve_slo_specs(
        "A", p99_target_us=1000.0, subopt_eps=0.01)}
    assert names == {"A.p99", "A.p99_roll", "A.fallback", "A.subopt"}
    assert {s.name for s in lifecycle_slo_specs(sla_s=60.0)} \
        == {"lifecycle.staleness", "lifecycle.staleness_p99"}
    (b,) = build_slo_specs()
    assert b.metric == "build.quarantined_cells" and b.kind == "counter"


def test_published_unit_counters_are_lifetime_sums(tmp_path):
    p = str(tmp_path / "s.obs.jsonl")
    with obs_lib.Obs("jsonl", path=p) as o:
        tr = _tracker(specs=[_avail_spec()], obs=o)
        _feed(tr, 0.0, 0, 0)
        _feed(tr, 1.0, 3, 100)
        _feed(tr, 2.0, 5, 250)
        snap = o.metrics.snapshot()
    c = snap["counters"]
    assert c["slo.t.avail.bad_units"] == 5.0
    assert c["slo.t.avail.good_units"] == 245.0
    g = snap["gauges"]
    assert g["slo.t.avail.goal"] == 0.999
    assert 0.0 < g["slo.t.avail.compliance"] < 1.0
    for k in ("burn_fast", "burn_slow", "budget_remaining_frac"):
        assert f"slo.t.avail.{k}" in g


def test_slo_from_serve_config():
    assert slo_from_serve_config(ServeConfig()) is None
    tr = slo_from_serve_config(ServeConfig(
        controller="pend", slo="on", slo_goal=0.99,
        slo_p99_target_us=800.0, slo_interval_s=30.0,
        demand_subopt_eps=0.01))
    assert tr.identity == "serve.pend" and tr.interval_s == 30.0
    assert tr.serve_template == {"p99_target_us": 800.0, "goal": 0.99,
                                 "subopt_eps": 0.01}


# -- parity with the JAX package -------------------------------------------

def _script(seed: int, n: int = 140) -> list:
    """Scripted metrics snapshots from a seed: cumulative counters (one
    registry restart half-way), a cumulative latency histogram and a
    gauge that comes and goes, at irregular times with gaps."""
    rng = np.random.default_rng(seed)
    bounds = [10.0, 100.0, 1000.0, 10000.0]
    counts = np.zeros(len(bounds) + 1, dtype=np.int64)
    bad = tot = 0.0
    t = 0.0
    out = []
    for i in range(n):
        t += float(rng.choice([0.3, 1.0, 1.7, 9.0, 70.0],
                              p=[0.2, 0.5, 0.2, 0.08, 0.02]))
        if i == n // 2:
            bad = tot = 0.0          # the registry restarted
        step = float(rng.integers(0, 300))
        tot += step + float(rng.uniform(0, 1))
        bad += float(rng.binomial(int(step), rng.choice([0.001, 0.3])))
        counts += rng.multinomial(int(rng.integers(0, 50)),
                                  [0.5, 0.3, 0.15, 0.04, 0.01])
        snap = {"counters": {"bad": bad, "total": tot,
                             "serve.ctl.A.requests": tot,
                             "serve.ctl.A.fallbacks": bad},
                "histograms": {"lat": {"bounds": bounds,
                                       "counts": counts.tolist(),
                                       "count": int(counts.sum())}},
                "gauges": ({"g": float(rng.uniform(0, 20))}
                           if rng.uniform() < 0.7 else {})}
        out.append((t, snap))
    return out


def _specs(mod):
    return [_avail_spec(mod, goal=0.99),
            mod.SloSpec(name="t.lat", kind="hist_p", metric="lat",
                        threshold=100.0, goal=0.95),
            mod.SloSpec(name="t.g", kind="gauge", metric="g",
                        threshold=10.0, goal=0.9)]


def _run(mod, obs_mod, script, state_dir=None, serve=False):
    o = obs_mod.Obs("jsonl")
    tr = _tracker(mod, specs=_specs(mod), obs=o, state_dir=state_dir,
                  identity="parity",
                  serve_template=({"p99_target_us": 500.0, "goal": 0.99,
                                   "subopt_eps": 0.0} if serve else None))
    reports = [tr.tick(snap, now=t) for t, snap in script]
    return tr, o, reports


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scripted_snapshots_give_the_jax_trackers_evaluation_bitwise(
        seed, tmp_path):
    script = _script(seed)
    jtr, jo, jreps = _run(jslo, jobs_lib, script,
                          str(tmp_path / "jax"), serve=True)
    ttr, to, treps = _run(tslo, obs_lib, script,
                          str(tmp_path / "torch"), serve=True)
    # Every tick's report, and the final evaluation, the same floats;
    # dict equality compares floats exactly.
    assert treps == jreps
    assert ttr.evaluate() == jtr.evaluate()
    assert ttr.evaluate(now=script[-1][0] + 30.0) \
        == jtr.evaluate(now=script[-1][0] + 30.0)
    # The published slo.* family and the burn events are the same.
    js, ts = jo.metrics.snapshot(), to.metrics.snapshot()
    for kind in ("counters", "gauges"):
        assert {k: v for k, v in ts[kind].items() if k.startswith("slo.")} \
            == {k: v for k, v in js[kind].items() if k.startswith("slo.")}
    strip = ("t", "t_abs", "seq")

    def burns(o):
        return [{k: v for k, v in r.items() if k not in strip}
                for r in o.sink.records
                if r.get("name") == "health.slo_burn"]

    assert burns(to) == burns(jo) and burns(to)
    # The state files are the same bytes.
    ttr.flush()
    jtr.flush()
    with open(ttr._state_path(), "rb") as f:
        tb = f.read()
    with open(jtr._state_path(), "rb") as f:
        jb = f.read()
    assert tb == jb


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_state_files_load_across_the_packages(writer, tmp_path):
    script = _script(7, n=80)
    sd = str(tmp_path / "slo")
    w_mod, w_obs = (jslo, jobs_lib) if writer == "jax" else (tslo, obs_lib)
    r_mod, r_obs = (tslo, obs_lib) if writer == "jax" else (jslo, jobs_lib)
    wtr, _o, _r = _run(w_mod, w_obs, script, sd, serve=True)
    wtr.flush()
    t_end = script[-1][0]
    before = wtr.evaluate(now=t_end)
    # The reader gets no specs and no traffic: the persisted definitions
    # (runtime-discovered serve specs included) restore the budget.
    o = r_obs.Obs("jsonl")
    rtr = _tracker(r_mod, state_dir=sd, identity="parity", obs=o)
    assert [r["name"] for r in o.sink.records if r.get("kind") == "event"] \
        == ["slo.state_restored"]
    after = rtr.evaluate(now=t_end)
    assert set(after) == set(before) and {"A.p99", "A.fallback"} <= set(after)
    for name, row in before.items():
        for field in ("good", "bad", "compliance", "budget_remaining_frac",
                      "burn_fast", "burn_slow"):
            assert _bits(after[name][field]) == _bits(row[field]), (
                name, field)
    # Saved again by the reader, the file is the writer's bytes.
    with open(wtr._state_path(), "rb") as f:
        wb = f.read()
    rtr.flush()
    with open(rtr._state_path(), "rb") as f:
        assert f.read() == wb
