"""Torch port: the build's diagnostics -- the streaming health monitor
(``obs/health.py``), the flight recorder (``obs/recorder.py``) and the
standalone bundle replay (``obs/replay.py``) -- against the JAX
package's obs/health.py, obs/recorder.py and scripts/replay_solve.py.

- Health: the scripted record sequences of the JAX package's
  tests/test_diagnostics.py and tests/test_fleet.py go through both
  monitors; events, exit codes and summaries are equal, bitwise.
- Recorder: the tier-1 DI fixture under a 2-iteration IPM schedule (a
  schedule that cannot converge any QP: every feasible cell ends
  feasible-but-unconverged) gives a ``diverged_cells`` bundle in each
  package; each package's bundle has the other's keys and replays in
  the other (conv and feas masks equal, V within 1e-9 x max(1, |V|)).
- Build: the ring and its cap (per trigger in the port, over all
  triggers in the JAX package), the fault-injected build whose bundles
  replay, the recorder off by default, recorder_dir implying the
  recorder, and the DI build with recorder and health on giving the
  JAX package's tree node for node and, where neither package's cap
  binds, its bundles' (trigger, kind) multiset.
Everything runs on the CPU: the port's IPM leg is its plain version
there."""

import collections
import json
import os
import sys

import numpy as np
import pytest
import torch

import explicit_hybrid_mpc_tpu  # noqa: F401  (enables x64)
from explicit_hybrid_mpc_tpu.config import PartitionConfig as JaxConfig
from explicit_hybrid_mpc_tpu.obs import health as jhealth
from explicit_hybrid_mpc_tpu.obs import recorder as jrecorder
from explicit_hybrid_mpc_tpu.oracle.oracle import Oracle as JaxOracle
from explicit_hybrid_mpc_tpu.partition.frontier import (
    build_partition as jax_build)
from explicit_hybrid_mpc_tpu.problems.registry import make as jax_make
from explicit_hybrid_mpc_tpu_torch import obs as obs_lib
from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
from explicit_hybrid_mpc_tpu_torch.obs import health, recorder, replay
from explicit_hybrid_mpc_tpu_torch.obs.recorder import (BUNDLE_VERSION,
                                                        FlightRecorder,
                                                        load_bundle)
from explicit_hybrid_mpc_tpu_torch.oracle.oracle import Oracle
from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
    FrontierEngine, build_partition, make_oracle)
from explicit_hybrid_mpc_tpu_torch.problems.registry import make

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DI = {"N": 3, "theta_box": 1.5}


def _jax_replay_script():
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import replay_solve
    finally:
        sys.path.pop(0)
    return replay_solve


@pytest.fixture(scope="module")
def prob():
    return make("double_integrator", **DI)


@pytest.fixture(scope="module")
def jprob():
    return jax_make("double_integrator", **DI)


# -- health: the same scripted records through both monitors ----------------

def _metrics(t=1.0, counters=None, gauges=None):
    return {"t": t, "kind": "metrics", "name": "snapshot",
            "counters": counters or {}, "gauges": gauges or {}}


def _steps(n, rate):
    return [{"t": float(k), "kind": "event", "name": "build.step",
             "regions": rate * k} for k in range(n)]


#: name -> (rules, refire_after, records, stall probes).  The sequences
#: of the JAX package's tests/test_diagnostics.py (health section) and
#: tests/test_fleet.py, plus one per rule those leave out.
HEALTH_CASES = {
    "rescue_storm": ({"min_solves_for_rates": 100}, 50, [
        _metrics(1.0, {"oracle.point_solves": 0,
                       "oracle.rescue_solves": 0}),
        _metrics(2.0, {"oracle.point_solves": 1000,
                       "oracle.rescue_solves": 400})], ()),
    "divergence_and_warmstart": ({"min_solves_for_rates": 100}, 50, [
        _metrics(1.0, {"oracle.point_solves": 5000},
                 {"oracle.phase2_survivor_frac": 0.99,
                  "oracle.warmstart_accept_rate": 0.001,
                  "oracle.warm_attempts": 5000})], ()),
    "warmstart_needs_attempts": ({"min_solves_for_rates": 100}, 50, [
        _metrics(1.0, {"oracle.point_solves": 5000},
                 {"oracle.warmstart_accept_rate": 0.0,
                  "oracle.warm_attempts": 0})], ()),
    "imbalance_and_contention": ({}, 50, [
        _metrics(1.0, gauges={"serve.shard_imbalance": 20.0,
                              "host.competing_cpu_frac_mean": 0.5})], ()),
    # A host whose procfs counts nothing publishes no contention gauge:
    # not measured, so the rule must stay silent (never read as 0).
    "contention_not_measured": ({"max_competing_cpu_frac": 0.01}, 50, [
        _metrics(1.0, gauges={"host.cpu_count": 8.0})], ()),
    "throughput_and_cooldown": (
        {"min_regions_per_s": 100.0, "window_steps": 3}, 1000,
        _steps(6, 10), ()),
    "cooldown_refires": ({"max_shard_imbalance": 1.5}, 3, [
        _metrics(float(k), gauges={"serve.shard_imbalance": 9.0})
        for k in range(7)], ()),
    "device_failures": ({"max_device_failures": 0}, 50, [
        {"t": 1.0, "kind": "event", "name": "runlog",
         "device_failure": "RuntimeError('dead device')",
         "query": "solve_vertices"},
        {"t": 2.0, "kind": "event", "name": "build.device_failure",
         "error": "x"}], ()),
    "adopts_health_events": ({}, 50, [
        {"t": 1.0, "kind": "event", "name": "health.lease_leak",
         "severity": "warn", "value": 1, "threshold": 30.0,
         "msg": "lease"},
        {"t": 2.0, "kind": "event", "name": "health.oversized_batch",
         "severity": "warn", "msg": "big"},
        {"t": 3.0, "kind": "event", "name": "health.staleness",
         "severity": "critical", "value": 9.0, "threshold": 1.0}], ()),
    "stall": ({"stall_s": 0.2}, 50, [
        {"t": 0.0, "kind": "event", "name": "build.step", "regions": 1}],
        (0.1, 0.4, 0.5)),
    "serve_rules_per_controller": (
        {"serve_p99_us": 1000.0, "max_queue_frac": 0.5,
         "max_subopt": 0.01, "min_solves_for_rates": 10}, 50, [
            _metrics(1.0, {"serve.ctl.a.requests": 5.0,
                           "serve.ctl.b.requests": 50.0,
                           "serve.ctl.b.subopt_samples": 30.0},
                     {"serve.ctl.a.p99_us": 5000.0,
                      "serve.ctl.b.p99_us": 5000.0,
                      "serve.ctl.b.fallback_frac": 0.5,
                      "serve.ctl.b.queue_frac": 0.7,
                      "serve.ctl.b.subopt_p99": 0.2,
                      "serve.p99_us": 2000.0})], ()),
    "queue_frac_volume_gated": ({"max_queue_frac": 0.5}, 50, [
        _metrics(1.0, {"serve.ctl.c.requests": 10.0},
                 {"serve.ctl.c.queue_frac": 0.62}),
        _metrics(2.0, {"serve.ctl.c.requests": 5000.0},
                 {"serve.ctl.c.queue_frac": 0.62})], ()),
    "rebuild_staleness_quarantine_slo": (
        {"max_staleness_s": 5.0, "min_solves_for_rates": 10}, 50, [
            _metrics(1.0, {"rebuild.leaves_reused": 10,
                           "rebuild.leaves_invalidated": 990,
                           "lifecycle.rebuilds": 2,
                           "build.quarantined_cells": 5,
                           "oracle.point_solves": 50},
                     {"rebuild.reuse_frac": 0.01,
                      "lifecycle.staleness_p99_s": 9.5,
                      "slo.serve_p99.burn_fast": 20.0,
                      "slo.serve_p99.burn_slow": 2.0})], ()),
}


def _drive(mod, rules, refire, records, stalls):
    mon = mod.HealthMonitor(rules, refire_after=refire)
    fired = [mon.feed(dict(r)) for r in records]
    fired += [mon.check_stall(s) for s in stalls]
    return mon, fired


@pytest.mark.parametrize("case", sorted(HEALTH_CASES))
def test_health_monitor_matches_the_reference(case):
    rules, refire, records, stalls = HEALTH_CASES[case]
    mon, fired = _drive(health, rules, refire, records, stalls)
    jmon, jfired = _drive(jhealth, rules, refire, records, stalls)
    key = ("name", "severity", "value", "threshold")
    assert [[tuple(e[k] for k in key) for e in f] for f in fired] \
        == [[tuple(e[k] for k in key) for e in f] for f in jfired]
    assert mon.exit_code == jmon.exit_code
    assert json.dumps(mon.summary(), sort_keys=True) \
        == json.dumps(jmon.summary(), sort_keys=True)
    # Every case but the silent ones fires something.
    silent = {"warmstart_needs_attempts", "contention_not_measured"}
    assert bool(mon.events) is (case not in silent)


def test_health_rule_vocabulary_is_the_reference():
    assert health.DEFAULT_RULES == jhealth.DEFAULT_RULES
    assert health.RULE_DOCS == jhealth.RULE_DOCS
    assert set(health.RULE_DOCS) == set(health.DEFAULT_RULES)
    for bad in ([("bogus_rule", 1.0)], {"bogus": 2.0}):
        with pytest.raises(ValueError, match="unknown health rule"):
            health.rules_from_pairs(bad)
    with pytest.raises(ValueError, match="unknown health rule"):
        PartitionConfig(backend="cpu", health_rules=(("bogus_rule", 1.0),))
    assert health.rules_from_pairs([("fleet_stall", 10.0)])["fleet_stall"] \
        == 10.0
    assert obs_lib.HealthMonitor is health.HealthMonitor
    assert obs_lib.FlightRecorder is FlightRecorder


def test_health_events_land_in_the_sink():
    o = obs_lib.Obs("jsonl")
    mon = health.HealthMonitor({"max_shard_imbalance": 1.5}, sink=o.sink)
    mon.feed(_metrics(1.0, gauges={"serve.shard_imbalance": 3.0}))
    recs = [r for r in o.sink.records
            if r["name"] == "health.shard_imbalance"]
    assert len(recs) == 1 and recs[0]["severity"] == "warn"


def test_blind_procfs_publishes_no_contention_gauge(tmp_path):
    """A /proc/stat of zeros (some container hosts count no CPU time)
    reads as "not measured": no sample, no gauge, and the rule stays
    silent."""
    from explicit_hybrid_mpc_tpu_torch.obs.host import ContentionMonitor

    stat = tmp_path / "stat"
    stat.write_text("cpu  0 0 0 0 0 0 0 0 0 0\n")
    mon = ContentionMonitor(stat_path=str(stat))
    assert mon._jiffies() is None
    o = obs_lib.Obs("jsonl")
    ContentionMonitor(stat_path=str(stat), metrics=o.metrics,
                      interval_s=0.01).start().summary()
    gauges = o.metrics.snapshot()["gauges"]
    assert "host.competing_cpu_frac_mean" not in gauges
    hm = health.HealthMonitor({"max_competing_cpu_frac": 1e-9})
    assert hm.feed(_metrics(1.0, gauges=gauges)) == []


# -- recorder + replay, across the packages --------------------------------

def _diverge(orc, rec, prob, n=24):
    """A 2-iteration schedule cannot converge any QP (the JAX package's
    fault injection): every feasible cell is feasible-but-unconverged."""
    orc.recorder = rec
    rng = np.random.default_rng(0)
    th = rng.uniform(prob.theta_lb, prob.theta_ub, size=(n, prob.n_theta))
    ds = rng.integers(0, prob.canonical.n_delta, size=n)
    _V, conv, *_ = orc.solve_pairs(th, ds)
    return conv


@pytest.fixture(scope="module")
def bundles(prob, jprob, tmp_path_factory):
    d = tmp_path_factory.mktemp("bundles")
    rec = FlightRecorder(str(d / "port"))
    conv = _diverge(Oracle(prob, backend="cpu", n_iter=2), rec, prob)
    jrec = jrecorder.FlightRecorder(str(d / "jax"))
    jconv = _diverge(JaxOracle(jprob, backend="cpu", n_iter=2), jrec, jprob)
    assert not conv.any() and not np.asarray(jconv).any()
    return rec.bundles[0], jrec.bundles[0]


def test_divergence_bundle_replays_bit_for_bit(bundles):
    path, _ = bundles
    meta, arrays = load_bundle(path)
    assert meta["bundle_version"] == BUNDLE_VERSION
    assert (meta["kind"], meta["trigger"]) == ("pairs", "diverged_cells")
    assert meta["oracle"]["n_iter"] == 2
    assert meta["oracle"]["ipm_kernel"] == "xla"  # the plain leg's word
    for k in ("can_H", "can_G", "thetas", "delta_idx", "obs_conv",
              "obs_feas", "obs_V"):
        assert k in arrays, k
    rep = replay.replay_bundle(path, backend="cpu")
    assert rep["ok"] and rep["same_platform"]
    assert rep["conv_match"] and rep["feas_match"] and rep["V_bitwise"]
    assert replay.main([path, "--backend", "cpu"]) == 0


def test_replay_defaults_to_the_card(bundles):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-GPU path is moot")
    with pytest.raises(RuntimeError, match="CUDA"):
        replay.replay_bundle(bundles[0])


def test_replay_kernel_only_probe(bundles):
    rep = replay.replay_bundle(bundles[0], backend="cpu", kernel_only=True)
    assert rep["kernel_only"] and rep["ok"]
    assert rep["kernel_vs_obs_conv_match"]
    plain = replay.replay_bundle(bundles[0], backend="cpu",
                                 kernel_only=True, kernel="torch")
    assert plain["kernel_converged"] == rep["kernel_converged"]
    with pytest.raises(ValueError, match="card"):
        replay.replay_bundle(bundles[0], backend="cpu", kernel_only=True,
                             kernel="cuda")


def test_port_bundle_has_the_reference_layout(bundles):
    """Same array keys, same meta keys (the nested oracle meta too), the
    same arrays bitwise: only the ring's and the file's timestamps
    differ."""
    (pm, pa), (jm, ja) = load_bundle(bundles[0]), jrecorder.load_bundle(
        bundles[1])
    assert sorted(pa) == sorted(ja)
    assert set(pm) == set(jm) and set(pm["oracle"]) == set(jm["oracle"])
    for k in pm:
        if k not in ("ring", "created_unix"):
            assert pm[k] == jm[k], k
    for k in pa:
        assert np.array_equal(pa[k], ja[k]), k


def test_port_bundle_replays_in_the_reference(bundles):
    rep = _jax_replay_script().replay_bundle(bundles[0])
    assert rep["ok"] and rep["conv_match"]


def test_reference_bundle_replays_in_the_port(bundles):
    _meta, arrays = jrecorder.load_bundle(bundles[1])
    rep = replay.replay_bundle(bundles[1], backend="cpu")
    assert rep["ok"] and rep["conv_match"] and rep["feas_match"]
    # V within 1e-9 x max(1, |V|) (the cells are unconverged: +inf on
    # both sides).
    meta, _ = load_bundle(bundles[1])
    orc = replay._build_oracle(
        {**meta, "_canonical": recorder.rebuild_canonical(arrays)}, "cpu")
    V, conv, feas = orc.solve_pairs_masks(arrays["thetas"],
                                          arrays["delta_idx"])
    want = arrays["obs_V"]
    assert np.array_equal(np.isfinite(V), np.isfinite(want))
    fin = np.isfinite(want)
    assert np.all(np.abs(V[fin] - want[fin])
                  <= 1e-9 * np.maximum(1.0, np.abs(want[fin])))
    assert np.array_equal(conv, arrays["obs_conv"])
    assert np.array_equal(feas, arrays["obs_feas"])


@pytest.mark.parametrize("kind", ["vertices", "simplex"])
def test_other_bundle_kinds_replay(kind, prob, tmp_path):
    """Vertex-grid and simplex bundles, written through the frontier's
    device-failure capture (a batch re-solved on the CPU twin) and the
    oracle's simplex capture."""
    rec = FlightRecorder(str(tmp_path))
    orc = Oracle(prob, backend="cpu", n_iter=2)
    rng = np.random.default_rng(3)
    cfg = PartitionConfig(backend="cpu", eps_a=0.3, obs_recorder=True,
                          recorder_dir=str(tmp_path))
    eng = FrontierEngine(prob, orc, cfg)
    eng.recorder = rec
    if kind == "vertices":
        th = rng.uniform(prob.theta_lb, prob.theta_ub, (6, prob.n_theta))
        sol = orc.solve_vertices(th)
        eng._capture_device_failure("vertices", (th,), sol, "injected")
        path = [b for b in rec.bundles if "device_failure" in b][0]
    else:
        from explicit_hybrid_mpc_tpu_torch.partition import geometry

        c = rng.uniform(prob.theta_lb, prob.theta_ub, (4, prob.n_theta))
        offs = rng.uniform(-1, 1, (4, prob.n_theta + 1, prob.n_theta)) \
            * 0.1
        Ms = geometry.barycentric_matrices(c[:, None, :] + offs)
        ds = np.zeros(4, dtype=np.int64)
        out = orc.solve_simplex_min(Ms, ds)
        eng._capture_oracle_failure("solve_simplex_min", (Ms, ds), out,
                                    "injected")
        path = [b for b in rec.bundles if "device_failure" in b][0]
    rep = replay.replay_bundle(path, backend="cpu")
    assert rep["kind"] == kind and rep["ok"]
    jrep = _jax_replay_script().replay_bundle(path)
    assert jrep["ok"]


# -- build: ring, cap, fault-injected build, defaults ------------------------

def test_recorder_ring_and_bundle_cap(tmp_path):
    rec = FlightRecorder(str(tmp_path / "b"), capacity=4, max_bundles=1)
    for i in range(8):
        rec.note({"kind": "event", "name": f"e{i}"})
    assert len(rec.ring) == 4  # bounded ring keeps the newest
    p1 = rec.dump("t", {"x": np.zeros(2)}, {"kind": "pairs"})
    p2 = rec.dump("t", {"x": np.zeros(2)}, {"kind": "pairs"})
    assert p1 is not None and p2 is None
    assert rec.n_dropped == 1
    meta, _arrays = load_bundle(p1)
    assert [r["name"] for r in meta["ring"]] == ["e4", "e5", "e6", "e7"]
    jmeta, _ = jrecorder.load_bundle(p1)
    assert jmeta == meta


def test_recorder_caps_each_trigger_apart(prob, jprob, tmp_path):
    """The port caps each trigger at max_bundles (16); the JAX package
    caps all triggers together, so there the diverged cells met first
    crowd out the uncertified leaves met at the end of a build.  At
    max_depth 3 the forced-divergence build meets 4 diverged-cell
    batches and 16 uncertified leaves: the port keeps all 20, the JAX
    package 16 (4 + 12)."""
    out = {}
    for tag, cfg_cls, build, p, orc in (
            ("port", PartitionConfig, build_partition, prob,
             Oracle(prob, backend="cpu", n_iter=2)),
            ("jax", JaxConfig, jax_build, jprob,
             JaxOracle(jprob, backend="cpu", n_iter=2))):
        bdir = str(tmp_path / tag)
        build(p, cfg_cls(backend="cpu", obs_recorder=True,
                         recorder_dir=bdir, **FAULT_CFG), oracle=orc)
        out[tag] = _bundle_kinds(bdir)
    assert out["port"] == {("uncertified_leaf", "cell"): 16,
                           ("diverged_cells", "pairs"): 4}
    assert out["jax"] == {("uncertified_leaf", "cell"): 12,
                          ("diverged_cells", "pairs"): 4}
    rec = FlightRecorder(str(tmp_path / "cap"), max_bundles=2)
    for trig in ("a", "a", "a", "b"):
        rec.dump(trig, {"x": np.zeros(1)}, {"kind": "pairs"})
    assert len(rec.bundles) == 3 and rec.n_dropped == 1


def test_capture_errors_are_counted_not_raised(prob, tmp_path):
    """A capture that raises (here: the bundle directory is a file)
    leaves the solve intact and counts one recorder.capture_errors."""
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("x")
    o = obs_lib.Obs("jsonl")
    rec = FlightRecorder(str(blocker / "sub"), obs=o)
    conv = _diverge(Oracle(prob, backend="cpu", n_iter=2), rec, prob)
    assert not conv.any() and rec.bundles == []
    assert rec.n_capture_errors == 1
    assert o.metrics.snapshot()["counters"]["recorder.capture_errors"] == 1


FAULT_CFG = dict(eps_a=0.3, batch_simplices=32, max_steps=40, max_depth=3)


def test_fault_injected_build_emits_bundles_and_replays(prob, tmp_path):
    """The JAX package's CI acceptance flow on the port: tiny build,
    forced-divergence oracle, obs='jsonl' -> bundles exist, the stream
    records them, and every one replays."""
    stream = str(tmp_path / "run.obs.jsonl")
    bdir = str(tmp_path / "repro")
    cfg = PartitionConfig(backend="cpu", obs="jsonl", obs_path=stream,
                          obs_recorder=True, recorder_dir=bdir, **FAULT_CFG)
    res = build_partition(prob, cfg, oracle=Oracle(prob, backend="cpu",
                                                   n_iter=2))
    assert res.stats["uncertified"] > 0
    bnames = sorted(os.listdir(bdir))
    assert bnames
    recs = obs_lib.load_jsonl(stream)
    ev = [r for r in recs if r.get("name") == "recorder.bundle"]
    snap = [r for r in recs if r["kind"] == "metrics"][-1]
    assert snap["counters"]["recorder.bundles"] == len(ev) == len(bnames)
    assert snap["counters"]["recorder.capture_errors"] == 0
    kinds = set()
    for b in bnames:
        rep = replay.replay_bundle(os.path.join(bdir, b), backend="cpu")
        kinds.add(rep["kind"])
        assert rep["ok"], rep
        if rep["kind"] == "cell":
            assert rep["snapshot_stage1_status"] != "certified"
    assert "cell" in kinds


def test_recorder_off_by_default(prob):
    cfg = PartitionConfig(eps_a=0.5, backend="cpu", batch_simplices=32)
    eng = FrontierEngine(prob, make_oracle(prob, cfg), cfg)
    assert eng.recorder is None and eng._health is None
    assert eng.oracle.recorder is None


def test_recorder_dir_implies_the_recorder(prob, tmp_path):
    cfg = PartitionConfig(eps_a=0.5, backend="cpu", batch_simplices=32,
                          recorder_dir=str(tmp_path / "r"))
    eng = FrontierEngine(prob, make_oracle(prob, cfg), cfg)
    assert eng.recorder is not None
    assert eng.recorder.out_dir == str(tmp_path / "r")
    assert eng.oracle.recorder is eng.recorder
    # Health rules without obs build no monitor (nothing to watch).
    cfg2 = PartitionConfig(eps_a=0.5, backend="cpu",
                           health_rules=(("stall_s", 5.0),))
    assert FrontierEngine(prob, make_oracle(prob, cfg2), cfg2)._health \
        is None


def test_engine_feeds_device_failures_to_health(prob):
    cfg = PartitionConfig(eps_a=0.5, backend="cpu", batch_simplices=32,
                          obs="jsonl",
                          health_rules=(("max_device_failures", 0),))
    eng = FrontierEngine(prob, make_oracle(prob, cfg), cfg)
    eng._health_device_failure(RuntimeError("dead device"))
    assert [e["name"] for e in eng._health.events] == \
        ["health.device_failures"]


def _signature(res):
    tree = res.tree
    leaves = tree.converged_leaves()
    return (res.stats["regions"], res.stats["tree_nodes"],
            res.stats["uncertified"],
            tuple(tree.vertices[n].tobytes() for n in range(len(tree))),
            tuple(tree.leaf_data[n].delta_idx for n in leaves),
            tuple(bool(tree.leaf_data[n].certified) for n in leaves))


def _bundle_kinds(bdir):
    out = collections.Counter()
    for b in os.listdir(bdir):
        meta, _ = load_bundle(os.path.join(bdir, b))
        out[(meta["trigger"], meta["kind"])] += 1
    return out


@pytest.mark.parametrize("variant", ["forced_divergence", "tier1"])
def test_engine_with_diagnostics_matches_the_reference(variant, prob,
                                                       jprob, tmp_path):
    """The DI build with the recorder and the health monitor on gives
    the JAX package's tree node for node and the same bundle (trigger,
    kind) multiset: watching changes nothing."""
    rules = (("min_regions_per_s", 1e9), ("window_steps", 3),
             ("metrics_every_steps", 2))
    if variant == "forced_divergence":
        # max_depth 2: 11 anomalies, under either package's bundle cap
        # (test_recorder_caps_each_trigger_apart has the difference).
        kw = {**FAULT_CFG, "max_depth": 2}
        orc, jorc = (Oracle(prob, backend="cpu", n_iter=2),
                     JaxOracle(jprob, backend="cpu", n_iter=2))
    else:
        kw = dict(eps_a=0.5, batch_simplices=64, max_depth=20)
        orc = jorc = None
    out = {}
    for tag, cfg_cls, build, p, o in (
            ("port", PartitionConfig, build_partition, prob, orc),
            ("jax", JaxConfig, jax_build, jprob, jorc)):
        cfg = cfg_cls(backend="cpu", obs="jsonl",
                      obs_path=str(tmp_path / f"{tag}.obs.jsonl"),
                      obs_recorder=True,
                      recorder_dir=str(tmp_path / f"{tag}.repro"),
                      health_rules=rules, **kw)
        res = build(p, cfg, oracle=o) if o is not None else build(p, cfg)
        bdir = str(tmp_path / f"{tag}.repro")
        out[tag] = (_signature(res),
                    _bundle_kinds(bdir) if os.path.isdir(bdir)
                    else collections.Counter())
    assert out["port"][0] == out["jax"][0]
    assert out["port"][1] == out["jax"][1]
    if variant == "forced_divergence":
        assert out["port"][1] == {("uncertified_leaf", "cell"): 8,
                                  ("diverged_cells", "pairs"): 3}
    recs = obs_lib.load_jsonl(str(tmp_path / "port.obs.jsonl"))
    assert any(r.get("name") == "health.throughput_low" for r in recs)
    assert sum(r["kind"] == "metrics" for r in recs) >= 2
