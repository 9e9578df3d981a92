"""Torch port: the operator's tools (explicit_hybrid_mpc_tpu_torch/tools/
obs_report.py, obs_watch.py, fleet_smoke.py, preflight.py) on the CPU,
against the JAX package's scripts of the same names.

Each JAX test case that drives ``obs_report`` or ``obs_watch`` runs here
on a stream that the port wrote (through its sink, or a CPU build, rebuild,
service or serving run of the case's configuration); the JAX script,
loaded from ``scripts/`` by importlib, reads the same file.  The two
``report()`` dicts are equal, ``render_text`` is identical, the CLIs print
the same text and return the same exit codes, the watchers emit the same
event names with the same verdicts, and the JAX case's own asserts hold.
The one deliberate difference is the default bench: the JAX report diffs
against the newest BENCH_*.json of the repository root, the port's reads a
bench only when ``--bench`` names one (ROADMAP.md section C), so where a
JAX case gives no ``--bench`` the JAX side is given a missing file.

Beside them: the port's ``fleet_smoke --backend cpu --eps 0.5`` gives the
JAX script's reconciliation on the same arguments, ``--sharded`` holds its
exact bar, ``preflight`` lists, refuses, runs ``lint`` and passes
``--backend`` on, and every tool with a backend refuses to start without a
card under its default."""

import dataclasses
import importlib.util
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import explicit_hybrid_mpc_tpu  # noqa: F401  (enables x64)
from explicit_hybrid_mpc_tpu_torch import device as device_lib
from explicit_hybrid_mpc_tpu_torch import faults as faults_lib
from explicit_hybrid_mpc_tpu_torch import obs as obs_lib
from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
from explicit_hybrid_mpc_tpu_torch.faults.plan import FaultPlan
from explicit_hybrid_mpc_tpu_torch.obs.sink import (SCHEMA_VERSION,
                                                    JsonlSink, load_jsonl)
from explicit_hybrid_mpc_tpu_torch.partition.frontier import build_partition
from explicit_hybrid_mpc_tpu_torch.problems.registry import make
from explicit_hybrid_mpc_tpu_torch.tools import (fleet_smoke, obs_report,
                                                 obs_watch, preflight)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DI_ARGS = (("N", 3), ("theta_box", 1.5))
CPU = torch.device("cpu")
_SCRIPTS: dict = {}


def _jax(name):
    """The JAX package's scripts/<name>.py, loaded once by importlib."""
    if name not in _SCRIPTS:
        spec = importlib.util.spec_from_file_location(
            f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _SCRIPTS[name] = mod
    return _SCRIPTS[name]


def _same_report(path):
    """Both packages' report() of one stream file: equal dicts and
    identical text; the port's."""
    jr = _jax("obs_report")
    rep = obs_report.report(obs_report.load_jsonl(path))
    jrep = jr.report(jr.load_jsonl(path))
    assert rep == jrep
    text = obs_report.render_text(rep, [], None)
    assert text == jr.render_text(jrep, [], None)
    return rep, text


def _same_cli(capsys, port_argv, jax_argv=None):
    """Both CLIs on the same arguments (the JAX side's may differ where
    the default bench does): equal exit codes and identical stdout;
    (rc, stdout)."""
    rc = obs_report.main(port_argv)
    out = capsys.readouterr().out
    jrc = _jax("obs_report").main(jax_argv or port_argv)
    assert (rc, out) == (jrc, capsys.readouterr().out)
    return rc, out


def _no_bench(tmp_path):
    """--bench at a missing file: the JAX report's run without a bench,
    which is the port's default."""
    return ["--bench", str(tmp_path / "missing.json")]


def _metrics_rec(t=1.0, counters=None, gauges=None):
    return {"t": t, "kind": "metrics", "name": "snapshot",
            "counters": counters or {}, "gauges": gauges or {}}


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


def _progress_stream(tmp_path, name, wall0, rate, n=6, pid=1, idx=0):
    recs = [{"t": float(i), "kind": "event", "name": "build.step",
             "step": i, "regions": int(rate * i)} for i in range(1, n)]
    return _write_stream(
        str(tmp_path / name), recs,
        identity={"t": 0.0, "wall_time": wall0, "run_id": "r",
                  "pid": pid, "host": "h", "process_index": idx,
                  "process_count": 2})


# -- obs_watch (tests/test_diagnostics.py, tests/test_fleet.py) -------------

def _event_names(out):
    return [json.loads(ln)["name"]
            for ln in out.getvalue().strip().splitlines()]


def test_obs_watch_stall_on_frozen_stream(tmp_path):
    """A stream that stops growing raises health.stall and the watcher
    exits critical, in both packages (the threshold far under the wall
    limit, which is never reached: the stall ends the watch)."""
    path = str(tmp_path / "frozen.obs.jsonl")
    _write_stream(path, [{"t": 1.0, "kind": "event", "name": "build.step",
                          "step": 1, "regions": 10}], version=1)
    verdicts = []
    for mod in (obs_watch, _jax("obs_watch")):
        out = io.StringIO()
        rc, mon = mod.watch(path, rules={"stall_s": 0.3}, interval=0.05,
                            max_wall=60.0, out=out)
        assert rc == 2
        assert any(e["name"] == "health.stall" for e in mon.events)
        names = _event_names(out)
        assert names and names[-1] == "health.stall"
        verdicts.append((rc, mon.worst, names))
    assert verdicts[0] == verdicts[1]


def test_obs_watch_once_mode_healthy(tmp_path):
    path = str(tmp_path / "ok.obs.jsonl")
    with open(path, "w") as f:
        for k in range(3):
            f.write(json.dumps({"t": float(k), "kind": "event",
                                "name": "build.step", "step": k,
                                "regions": 10 * k}) + "\n")
    for mod in (obs_watch, _jax("obs_watch")):
        out = io.StringIO()
        rc, mon = mod.watch(path, once=True, out=out)
        assert rc == 0 and mon.worst == "ok" and mon.n_records == 3
        assert out.getvalue() == ""


def test_obs_watch_cli_once(tmp_path, capsys):
    path = str(tmp_path / "bad.obs.jsonl")
    with open(path, "w") as f:
        f.write(json.dumps(_metrics_rec(
            1.0, gauges={"serve.shard_imbalance": 99.0})) + "\n")
    rc = obs_watch.main([path, "--once"])
    got = capsys.readouterr()
    assert rc == 1  # warn-level verdict
    assert "health.shard_imbalance" in got.out
    assert _jax("obs_watch").main([path, "--once"]) == rc
    assert capsys.readouterr() == got


def test_obs_watch_fleet_once(tmp_path, capsys):
    ok = _progress_stream(tmp_path, "run.obs.p0-1.jsonl", 100.0, 50.0,
                          pid=1, idx=0)
    _write_stream(
        str(tmp_path / "run.obs.p0-2.jsonl"),
        [{"t": 1.0, "kind": "event", "name": "health.quarantine",
          "severity": "critical", "msg": "boom"}],
        identity={"t": 0.0, "wall_time": 100.0, "run_id": "r", "pid": 2,
                  "host": "h", "process_index": 0, "process_count": 2})
    jw = _jax("obs_watch")
    for argv, want in (([str(tmp_path / "run.obs.p*.jsonl"), "--fleet",
                         "--once"], 2),  # the adopted critical dominates
                       ([ok, "--fleet", "--once"], 0)):
        assert obs_watch.main(argv) == want
        got = capsys.readouterr()
        assert jw.main(argv) == want
        assert capsys.readouterr() == got


def test_obs_watch_list_rules_is_the_reference(capsys):
    assert obs_watch.main(["--list-rules"]) == 0
    got = capsys.readouterr().out
    assert _jax("obs_watch").main(["--list-rules"]) == 0
    assert capsys.readouterr().out == got and "stall_s" in got


def test_obs_watch_follows_a_growing_stream_to_build_done(tmp_path):
    """Follow mode: a partial trailing line stays buffered until its
    newline lands, and build.done ends the watch healthy."""
    import threading
    import time

    path = str(tmp_path / "live.obs.jsonl")
    _write_stream(path, [], version=SCHEMA_VERSION)
    done = json.dumps({"t": 2.0, "kind": "event", "name": "build.done",
                       "regions": 10})

    def writer():
        with open(path, "a") as f:
            f.write(json.dumps({"t": 1.0, "kind": "event",
                                "name": "build.step", "step": 1,
                                "regions": 10}) + "\n" + done[:9])
            f.flush()
            time.sleep(0.3)
            f.write(done[9:] + "\n")

    th = threading.Thread(target=writer)
    th.start()
    rc, mon = obs_watch.watch(path, rules={"stall_s": 60.0},
                              interval=0.05, max_wall=60.0,
                              out=io.StringIO())
    th.join(10)
    assert not th.is_alive()
    assert rc == 0 and mon.worst == "ok" and mon.n_records == 3


# -- obs_report on hand-written streams (tests/test_diagnostics.py) --------

def _mini_stream(tmp_path, gauges=None):
    path = str(tmp_path / "mini.obs.jsonl")
    with JsonlSink(path, schema_meta=True) as s:
        s.emit("event", "build.step", step=1, regions=100,
               frontier=0, device_frac=0.5)
        s.emit("metrics", "snapshot", counters={}, histograms={},
               gauges=gauges or {})
    return path


def test_obs_report_renders_contention_and_probe_warnings(tmp_path,
                                                          capsys):
    stream = _mini_stream(tmp_path, gauges={
        "host.contended": 1.0,
        "host.competing_cpu_frac_mean": 0.42,
        "host.competing_cpu_frac_max": 0.9})
    bench_path = str(tmp_path / "BENCH_x.json")
    with open(bench_path, "w") as f:
        json.dump({"value": 1.0,
                   "backend_probe_error": "probe timed out after 180s",
                   "host": {"contended": True,
                            "competing_cpu_frac_mean": 0.3}}, f)
    rc, out = _same_cli(capsys, [stream, "--bench", bench_path])
    assert rc == 0  # no regression flags, warnings alone never gate
    assert "WARNING" in out
    assert "CONTENDED" in out
    assert "probe timed out" in out


def test_obs_report_strict_exits_nonzero_on_flags(tmp_path, capsys):
    stream = _mini_stream(tmp_path)
    fast_bench = str(tmp_path / "BENCH_fast.json")
    with open(fast_bench, "w") as f:
        json.dump({"value": 1e9}, f)  # absurdly fast bench -> regression
    assert _same_cli(capsys, [stream, "--bench", fast_bench])[0] == 0
    rc, out = _same_cli(capsys, [stream, "--bench", fast_bench,
                                 "--strict"])
    assert rc == 1
    assert "REGRESSION" in out


def test_obs_report_surfaces_health_events_and_bundles(tmp_path, capsys):
    path = str(tmp_path / "h.obs.jsonl")
    with JsonlSink(path, schema_meta=True) as s:
        s.emit("event", "health.divergence_storm", severity="critical",
               value=0.99, threshold=0.95, msg="storm")
        s.emit("metrics", "snapshot",
               counters={"recorder.bundles": 2}, gauges={},
               histograms={})
    # The JAX case runs without --bench, so its script diffs against
    # the newest BENCH_*.json of the repository root; the port's reads
    # none (the section C deviation).
    rc, out = _same_cli(capsys, [path], [path] + _no_bench(tmp_path))
    assert rc == 0
    assert "health.divergence_storm" in out
    assert "2 repro bundle(s)" in out
    assert "bench diff" not in out
    assert _jax("obs_report").main([path]) == 0
    assert "bench diff vs BENCH_" in capsys.readouterr().out


def test_obs_report_drift_flags_compiled_shape_growth(tmp_path, capsys):
    """--drift: oracle.compiled_shapes growth between two streams is a
    recompile regression; shrinkage is not."""
    def stream(name, shapes):
        path = str(tmp_path / name)
        with JsonlSink(path, schema_meta=True) as s:
            s.emit("metrics", "snapshot", counters={}, histograms={},
                   gauges={"oracle.compiled_shapes": float(shapes)})
        return path

    old = stream("old.obs.jsonl", 40)
    grown = stream("grown.obs.jsonl", 52)
    no_bench = _no_bench(tmp_path)
    rc, out = _same_cli(capsys, [grown, "--drift", old] + no_bench)
    assert rc == 0  # advisory without --strict
    assert "compiled-shape growth" in out and "52" in out
    assert _same_cli(capsys, [grown, "--drift", old, "--strict"]
                     + no_bench)[0] == 1
    # Fewer shapes than before: directional, not a regression.
    rc, out = _same_cli(capsys, [old, "--drift", grown, "--strict"]
                        + no_bench)
    assert rc == 0 and "compiled-shape drift" in out
    # The JSON keeps the flags' provenance alike in both packages.
    outs = []
    for mod in (obs_report, _jax("obs_report")):
        j = str(tmp_path / f"{mod.__name__}.json")
        mod.main([grown, "--drift", old, "--json", j] + no_bench)
        with open(j) as f:
            outs.append(json.load(f))
    capsys.readouterr()
    assert outs[0] == outs[1] and outs[0]["bench"] is None
    assert outs[0]["drift_flags"] and outs[0]["bench_flags"] == []


# -- the fleet views (tests/test_fleet.py) ------------------------------------

def test_obs_report_fleet_and_strict(tmp_path, capsys):
    _progress_stream(tmp_path, "f.obs.p0-1.jsonl", 100.0, 50.0,
                     pid=1, idx=0)
    _write_stream(str(tmp_path / "f.obs.p0-2.jsonl"),
                  [{"t": 1.0, "kind": "metrics", "name": "snapshot",
                    "counters": {"build.leaves": 3}, "gauges": {},
                    "histograms": {}}], version=1)
    pat = str(tmp_path / "f.obs.p*.jsonl")
    rc, out = _same_cli(capsys, [pat, "--fleet"])
    assert rc == 0
    assert "fleet report: 2 stream(s)" in out
    assert "rollup" in out
    # --strict: the v1 identity-less stream gates the fold.
    rc, out = _same_cli(capsys, [pat, "--fleet", "--strict"])
    assert rc == 1
    assert "STRICT" in out
    outs = []
    for mod in (obs_report, _jax("obs_report")):
        j = str(tmp_path / f"{mod.__name__}.json")
        mod.main([pat, "--fleet", "--json", j])
        with open(j) as f:
            outs.append(json.load(f))
    capsys.readouterr()
    assert outs[0] == outs[1]


@pytest.fixture(scope="module")
def cp_build(tmp_path_factory):
    """One small DI build with obs + checkpoints (the JAX case's)."""
    d = tmp_path_factory.mktemp("cp")
    path = str(d / "run.obs.jsonl")
    cfg = PartitionConfig(eps_a=0.4, backend="cpu", batch_simplices=64,
                          obs="jsonl", obs_path=path, checkpoint_every=4,
                          checkpoint_path=str(d / "x.ckpt.pkl"))
    res = build_partition(make("double_integrator", **dict(DI_ARGS)), cfg)
    return path, res


def test_obs_report_renders_critical_path(cp_build):
    path, res = cp_build
    rep, text = _same_report(path)
    cp = rep["critical_path"]
    assert sum(cp[s] for s in ("fill", "plan", "wait", "certify",
                               "other")) == pytest.approx(1.0, abs=0.02)
    assert "checkpoint_s" in cp
    assert "critical path:" in text
    assert rep["identity"]["pid"] == os.getpid()
    assert rep["build"]["regions"] == res.stats["regions"]


def test_auto_profile_stall_exits_the_watcher_critical(tmp_path):
    """The JAX auto-profile case's stream (a DI build, stall_s 0.2, two
    0.4 s hangs at oracle.wait, one bounded capture): the watcher exits 2
    on it in both packages."""
    path = str(tmp_path / "run.obs.jsonl")
    cfg = PartitionConfig(eps_a=0.4, backend="cpu", batch_simplices=64,
                          obs="jsonl", obs_path=path, auto_profile=True,
                          profile_steps=2,
                          recorder_dir=str(tmp_path / "repro"),
                          health_rules=(("stall_s", 0.2),))
    plan = FaultPlan(faults=(
        {"site": "oracle.wait", "kind": "hang", "at": 2, "hang_s": 0.4},
        {"site": "oracle.wait", "kind": "hang", "at": 7, "hang_s": 0.4}))
    with faults_lib.activate(plan):
        res = build_partition(make("double_integrator", **dict(DI_ARGS)),
                              cfg)
    assert res.stats["regions"] > 0
    recs = load_jsonl(path)
    assert any(r.get("name") == "health.stall" for r in recs)
    assert len([r for r in recs if r.get("name") == "profile.capture"]) == 1
    verdicts = []
    for mod in (obs_watch, _jax("obs_watch")):
        out = io.StringIO()
        rc, mon = mod.watch(path, once=True, out=out)
        assert rc == 2
        verdicts.append((rc, mon.worst, _event_names(out)))
    assert verdicts[0] == verdicts[1]
    _same_report(path)


# -- the blocks of a port build, rebuild, service and arena -----------------

def test_obs_report_renders_faults_block(tmp_path):
    """tests/test_faults.py's schedule: the small pendulum with the
    primary and the fallback scripted dead for one stage-2 call, so a
    cell is quarantined."""
    path = str(tmp_path / "s.obs.jsonl")
    obs = obs_lib.Obs("jsonl", path=path)
    plan = FaultPlan(faults=(
        {"site": "oracle.call", "kind": "error", "at": 1},
        {"site": "oracle.fallback", "kind": "error", "at": 1,
         "count": 2},))
    cfg = PartitionConfig(problem="inverted_pendulum", eps_a=0.5,
                          backend="cpu", batch_simplices=32, max_depth=10,
                          oracle_retry_backoff_s=0.0,
                          oracle_retry_attempts=2)
    with faults_lib.activate(plan):
        build_partition(make("inverted_pendulum", N=2), cfg, obs=obs)
    obs.flush_metrics()
    obs.close(snapshot=False)
    rep, text = _same_report(path)
    assert rep["faults"]["quarantined_cells"] > 0
    assert rep["faults"]["injected"] >= 2
    assert "faults:" in text and "quarantined" in text
    assert any("quarantined" in w for w in rep.get("warnings", []))


def _synthetic_table(rng, L=40, p=2, n_u=2):
    """Disjoint unit-grid simplices (tests/test_arena.py's)."""
    from explicit_hybrid_mpc_tpu_torch.online import export
    from explicit_hybrid_mpc_tpu_torch.partition import geometry

    base = np.vstack([np.zeros(p), np.eye(p)])
    side = int(np.ceil(np.sqrt(L)))
    bary, U, V = [], [], []
    for i in range(L):
        off = np.array([i % side, i // side], dtype=float)[:p]
        verts = 0.8 * base + off + 0.1 * rng.uniform(size=p)
        bary.append(geometry.barycentric_matrix(verts))
        U.append(rng.normal(size=(p + 1, n_u)))
        V.append(np.abs(rng.normal(size=p + 1)))
    return export.LeafTable(
        bary_M=np.stack(bary), U=np.stack(U), V=np.stack(V),
        delta=np.zeros(L, dtype=np.int64),
        node_id=np.arange(L, dtype=np.int64))


def _centroids(table):
    return np.stack([np.linalg.inv(table.bary_M[i])[:-1, :].mean(axis=1)
                     for i in range(table.n_leaves)])


def test_obs_report_renders_arena_block(rng, tmp_path):
    """The arena's stream (two tenants, 16 mixed requests, a third
    publish) assembles into rep['arena'], renders the `arena:` / `arena
    swap:` lines, and both arena bench metrics diff-flag directionally,
    alike in both packages."""
    from explicit_hybrid_mpc_tpu_torch.serve import (ArenaScheduler,
                                                     DeviceArena)

    box = (np.zeros(2), np.full(2, 8.0))
    path = str(tmp_path / "arena.obs.jsonl")
    o = obs_lib.Obs("jsonl", path=path)
    arena = DeviceArena(p=2, n_u=2, capacity_cols=384, device=CPU, obs=o)
    tables = {n: _synthetic_table(rng, L=20) for n in ("a", "b")}
    for n, t in tables.items():
        arena.publish(n, "v1", t, *box)
    with ArenaScheduler(arena, max_batch=8, max_wait_us=20000.0,
                        obs=o) as sched:
        tickets = [sched.submit(n, _centroids(tables[n])[i % 5])
                   for i, n in enumerate(["a", "b"] * 8)]
        for t in tickets:
            t.result(30.0)
    arena.publish("a", "v2", tables["a"], *box)  # third swap_us sample
    o.flush_metrics()
    o.close()
    rep, txt = _same_report(path)
    ar = rep["arena"]
    assert ar["controllers"] == 2
    assert ar["publishes"] == 3
    assert ar["launches"] >= 1
    assert ar["swap_us"]["count"] == 3
    assert ar["resident_bytes"] > 0
    assert ar["launches_per_req"] <= 1.0
    assert "arena:" in txt and "arena swap:" in txt
    jr = _jax("obs_report")
    for bench, want in (({"arena_swap_us": ar["swap_us"]["p99"] / 10,
                          "batch_launches_per_req": 1e-4}, True),
                        ({"arena_swap_us": ar["swap_us"]["p99"] * 10,
                          "batch_launches_per_req": 2.0}, False)):
        flags = obs_report.diff_bench(rep, bench)
        assert flags == jr.diff_bench(rep, bench)
        if want:
            assert any("arena swap regression" in f for f in flags)
            assert any("launch-amortization" in f for f in flags)
        else:
            assert not any("arena" in f for f in flags)


@pytest.fixture(scope="module")
def di_cfg():
    return PartitionConfig(problem="double_integrator",
                           problem_args=DI_ARGS, eps_a=0.3,
                           backend="cpu", batch_simplices=128)


@pytest.fixture(scope="module")
def prior(di_cfg):
    return build_partition(make("double_integrator", **dict(DI_ARGS)),
                           di_cfg)


def test_obs_report_renders_lifecycle_block(di_cfg, prior, tmp_path):
    from explicit_hybrid_mpc_tpu_torch.lifecycle import (DriftSource,
                                                         LifecycleConfig,
                                                         RebuildService)

    path = str(tmp_path / "lc.obs.jsonl")
    obs = obs_lib.Obs("jsonl", path=path)
    src = DriftSource("double_integrator", problem_args=DI_ARGS,
                      controller="di", eps_a=0.3, drift_arg="u_max",
                      drift_frac=0.05, n_revisions=1, seed=9)
    svc = RebuildService(
        src, di_cfg,
        cfg=LifecycleConfig(artifacts_root=str(tmp_path / "art"),
                            sla_s=1e-4),  # everything misses: rendered
        prior={"di": prior}, obs=obs)
    with svc:
        assert svc.wait_idle(timeout=300, target_generations=1)
    obs.close()
    rep, txt = _same_report(path)
    lc = rep["lifecycle"]
    assert lc["rebuilds"] == 1
    assert lc["staleness_p99_s"] > 0
    assert lc["sla_misses"] == 1
    assert lc["reuse_decay"]
    assert "lifecycle:" in txt and "SLA MISS" in txt
    # The SLA-miss health event lands in the warnings block.
    assert any("health.staleness" in w for w in rep.get("warnings", []))
    # Staleness + delta-size regressions diff-flag vs a bench row.
    jr = _jax("obs_report")
    for r, bench, want in (
            (rep, {"staleness_p99_s": lc["staleness_p99_s"] / 10},
             "staleness regression"),
            ({"lifecycle": {"delta_bytes_frac": 0.5}},
             {"delta_bytes_frac": 0.1}, "delta-artifact size regression")):
        flags = obs_report.diff_bench(r, bench)
        assert flags == jr.diff_bench(r, bench)
        assert any(want in f for f in flags)


def test_obs_report_renders_rebuild_block(di_cfg, prior, tmp_path):
    from explicit_hybrid_mpc_tpu_torch.partition.rebuild import warm_rebuild

    path = str(tmp_path / "r.obs.jsonl")
    o = obs_lib.Obs("jsonl", path=path)
    warm_rebuild(make("double_integrator", **dict(DI_ARGS)),
                 dataclasses.replace(di_cfg, eps_a=0.15), prior.tree, obs=o)
    o.close()
    rep, txt = _same_report(path)
    assert "rebuild" in rep
    assert rep["rebuild"]["reuse_frac"] > 0
    assert "rebuild:" in txt
    # diff_bench flags a reuse collapse vs a bench row.
    bench = {"rebuild_reuse_frac": rep["rebuild"]["reuse_frac"] * 4}
    flags = obs_report.diff_bench(rep, bench)
    assert flags == _jax("obs_report").diff_bench(rep, bench)
    assert any("rebuild reuse regression" in f for f in flags)


def test_obs_report_pipeline_block(tmp_path):
    """The pipeline occupancy block from a stream's gauges, and the
    pipeline-economy regressions against a bench JSON."""
    records = [
        {"kind": "event", "name": "build.step", "t": 1.0, "step": 1,
         "regions": 10, "device_frac": 0.4, "pipeline": 2},
        {"kind": "metrics", "counters": {},
         "gauges": {"build.pipeline_fill": 1.0,
                    "build.pipeline_fill_frac": 0.4,
                    "build.dedup_saved": 12.0,
                    "build.spec_hit_rate": 0.3,
                    "build.spec_waste_frac": 0.2},
         "histograms": {}},
    ]
    path = str(tmp_path / "pipe.obs.jsonl")
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")
    rep, text = _same_report(path)
    pipe = rep["pipeline"]
    assert pipe["pipeline_fill_frac"] == 0.4
    assert pipe["dedup_saved"] == 12.0
    assert pipe["device_busy_frac"] == 0.4
    assert abs(pipe["host_busy_frac"] - 0.6) < 1e-12
    assert "pipeline: fill 0.40" in text
    bench = {"pipeline_fill_frac": 0.668, "spec_hit_rate": 0.58,
             "spec_waste_frac": 0.004}
    flags = obs_report.diff_bench(rep, bench, tol=0.10)
    assert flags == _jax("obs_report").diff_bench(rep, bench, tol=0.10)
    assert any("pipeline fill" in f for f in flags)
    assert any("speculation hit rate" in f for f in flags)
    assert any("speculation waste" in f for f in flags)


def test_obs_report_renders_headline_signals(tmp_path):
    """tests/test_obs_schema.py's stream: one short build and 10,000
    queries through a 4-shard descent, streamed to JSONL."""
    from explicit_hybrid_mpc_tpu_torch.online import (descent, export,
                                                      sharded)

    path = str(tmp_path / "run.obs.jsonl")
    o = obs_lib.Obs("jsonl", path=path)
    prob = make("double_integrator", **dict(DI_ARGS))
    res = build_partition(prob, PartitionConfig(
        eps_a=0.3, backend="cpu", batch_simplices=64), obs=o)
    table = export.export_leaves(res.tree)
    dt = descent.export_descent(res.tree, res.roots, table, stage=False,
                                obs=o)
    srv = sharded.shard_descent(dt, table, n_shards=4, devices=[CPU],
                                obs=o)
    rng = np.random.default_rng(0)
    for _ in range(10):
        out = srv.evaluate(rng.uniform(-1.5, 1.5, size=(1000, prob.n_theta)))
        assert out.u.shape == (1000, prob.n_u)
    o.close()
    rep, text = _same_report(path)
    assert rep["schema_version"] == SCHEMA_VERSION
    assert rep["build"]["regions"] == res.stats["regions"]
    assert rep["build"]["regions_per_s"] > 0
    pt = rep["oracle"]["point_solve_s"]
    assert 0 < pt["p50"] <= pt["p99"]
    assert rep["serve"]["shards"]
    for row in rep["serve"]["shards"].values():
        assert 0 < row["p50"] <= row["p99"]
    assert "regions/s" in text and "shard" in text
    jr = _jax("obs_report")
    fake_bench = {"metrics": {"histograms": {
        "oracle.point_solve_s": {"p99": pt["p99"] / 100}}}}
    for bench, want in (({"value": 1e9}, "regions/s regression"),
                        ({"value": rep["build"]["regions_per_s"] * 0.5},
                         None),
                        (fake_bench, "oracle.point_solve_s p99")):
        flags = obs_report.diff_bench(rep, bench)
        assert flags == jr.diff_bench(rep, bench)
        assert (any(want in f for f in flags) if want else flags == [])


def test_bench_warnings_classification():
    """tests/test_bench.py's classification, on bench rows only: a
    skipped probe is no warning, a failed one is; and every committed
    BENCH_*.json row gives the JAX script's warnings."""
    import glob

    jr = _jax("obs_report")
    skipped = {"backend_probe_skipped": True,
               "backend_probe_detail": "probe timed out"}
    failed = {"backend_probe_failed": True,
              "backend_probe_error": "probe timed out"}
    assert obs_report.bench_warnings(skipped) == [] \
        == jr.bench_warnings(skipped)
    assert obs_report.bench_warnings(failed) \
        == jr.bench_warnings(failed) != []
    rows = sorted(glob.glob(os.path.join(REPO, "BENCH_*.json")))
    assert rows
    for p in rows:
        with open(p) as f:
            row = json.load(f)
        assert obs_report.bench_warnings(row) == jr.bench_warnings(row), p


# -- the default bench: read only when --bench names one ------------------

def test_no_bench_flag_reads_no_bench_row(tmp_path, monkeypatch, capsys):
    """Run from a directory holding a BENCH_*.json that would flag every
    stream (the repository root holds the JAX package's rows): with no
    --bench the port reads none -- no diff line, "bench" null, exit 0
    under --strict -- and --bench DIR takes the newest row there, as the
    JAX script does with that file named."""
    stream = _mini_stream(tmp_path)
    rows = tmp_path / "rows"
    rows.mkdir()
    for name in ("BENCH_r01.json", "BENCH_r02.json"):
        with open(rows / name, "w") as f:
            json.dump({"value": 1e9}, f)
    monkeypatch.chdir(rows)
    j = str(tmp_path / "rep.json")
    assert obs_report.main([stream, "--strict", "--json", j]) == 0
    out = capsys.readouterr().out
    assert "bench diff" not in out and "REGRESSION" not in out
    with open(j) as f:
        doc = json.load(f)
    assert doc["bench"] is None and doc["bench_flags"] == []
    assert obs_report.latest_bench(str(rows)) == str(rows / "BENCH_r02.json")
    assert obs_report.latest_bench(str(tmp_path / "none")) is None
    rc, out = _same_cli(capsys, [stream, "--bench", str(rows), "--strict"],
                        [stream, "--bench", str(rows / "BENCH_r02.json"),
                         "--strict"])
    assert rc == 1 and "bench diff vs BENCH_r02.json" in out


# -- fleet_smoke ----------------------------------------------------------

EPS = 0.5


@pytest.fixture(scope="module")
def jax_fleet_smoke(tmp_path_factory):
    """The JAX script at --eps 0.5 in its own process, started before
    the port's smoke runs and read after it."""
    out = str(tmp_path_factory.mktemp("jax_fleet") / "verdict.json")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "scripts", "fleet_smoke.py"),
         "--eps", str(EPS), "--json", out], cwd=REPO, env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
        proc.wait(30)


def test_fleet_smoke_reconciles_as_the_jax_script(jax_fleet_smoke,
                                                  tmp_path, capsys):
    proc, jax_out = jax_fleet_smoke
    j = str(tmp_path / "verdict.json")
    rc = fleet_smoke.main(["--backend", "cpu", "--eps", str(EPS),
                           "--json", j])
    err = capsys.readouterr().err
    assert rc == 0, err
    assert "FLEET SMOKE OK: 2 streams reconcile exactly" in err
    with open(j) as f:
        v = json.load(f)
    assert v["failures"] == [] and v["tree_diffs"] == []
    assert v["n_fleet_streams"] == 2 and v["obs_report_rc"] == 0
    assert [a["rc"] for a in v["fleet"]["attempts"]] == [43, 0]
    _, jerr = proc.communicate(timeout=600)
    assert proc.returncode == 0, jerr.decode()[-2000:]
    with open(jax_out) as f:
        jv = json.load(f)
    assert v["reconciliation"] == jv["reconciliation"]
    assert all(r["reference"] == r["fleet_sum"]
               for r in v["reconciliation"].values())
    assert set(v["reconciliation"]) == set(fleet_smoke.RECONCILED_COUNTERS)


def test_fleet_smoke_sharded_holds_its_exact_bar(tmp_path, capsys):
    wd = str(tmp_path / "wd")
    j = str(tmp_path / "verdict.json")
    rc = fleet_smoke.main(["--backend", "cpu", "--eps", str(EPS),
                           "--sharded", "--workdir", wd, "--json", j])
    err = capsys.readouterr().err
    assert rc == 0, err
    assert "FLEET SMOKE (sharded) OK" in err
    with open(j) as f:
        v = json.load(f)
    assert v["failures"] == [] and v["tree_diffs"] == []
    assert v["sharded"]["rcs"] == [0, 0]
    assert set(v["reconciliation"]) \
        == set(fleet_smoke.SHARDED_RECONCILED_COUNTERS)
    assert all(r["reference"] == r["sharded_sum"]
               for r in v["reconciliation"].values())
    # The per-shard streams fold as one fleet in the JAX reader too.
    jr = _jax("obs_report")
    pat = os.path.join(wd, "sharded.obs.p*.jsonl")
    assert jr.main([pat, "--fleet", "--strict"]) == 0
    assert obs_report.main([pat, "--fleet", "--strict"]) == 0


def test_a_child_that_loses_its_card_fails_the_smoke(tmp_path, capsys):
    """A build that ends with NoCpuFallback (exit 69) fails the smoke and
    is not retried: one attempt, the exit named."""
    child = ("import sys\nfrom explicit_hybrid_mpc_tpu_torch import "
             "device\nsys.exit(device.NO_CPU_FALLBACK_EXIT)\n")
    args = type("A", (), {"eps": EPS, "batch": 64, "backend": "cpu",
                          "timeout": 60.0})()
    verdict, failures = {}, []
    rc = fleet_smoke.run_chain_smoke(str(tmp_path), args, verdict,
                                     failures,
                                     entry=[sys.executable, "-c", child])
    err = capsys.readouterr().err
    assert rc == 2 and verdict["reference"]["rc"] \
        == device_lib.NO_CPU_FALLBACK_EXIT
    assert "NoCpuFallback, exit 69" in err and "not retried" in err
    r = fleet_smoke.run_build(str(tmp_path / "sup"), EPS, 64, "cpu",
                              supervised=True,
                              entry=[sys.executable, "-c", child])
    assert [a["rc"] for a in r["attempts"]] \
        == [device_lib.NO_CPU_FALLBACK_EXIT]


# -- preflight ------------------------------------------------------------

def test_preflight_lists_the_battery(capsys):
    assert preflight.main(["--list"]) == 0
    out = capsys.readouterr().out
    for name in ("lint", "bench_gate", "chaos_suite", "fleet_smoke",
                 "drift_smoke"):
        assert name in out
    assert "not run" not in out.replace("tier1        not run", "")
    assert "explicit_hybrid_mpc_tpu_torch.tools.bench_gate" in out


@pytest.mark.parametrize("flag", ["--only", "--skip"])
def test_preflight_rejects_unknown_checks(flag, capsys):
    with pytest.raises(SystemExit) as e:
        preflight.main([flag, "lint,tpulint"])
    assert e.value.code == 2
    assert "unknown check(s) ['tpulint']" in capsys.readouterr().err


@pytest.mark.parametrize("values,rc", [([], 0), ([100.0, 102.0, 80.0], 1)])
def test_preflight_runs_the_bench_gate(values, rc, tmp_path, monkeypatch,
                                       capsys):
    """`--only bench_gate` runs the port's gate on the port's history
    (BENCH_HISTORY): an empty history passes, a newest row 20% below the
    window fails the battery."""
    from explicit_hybrid_mpc_tpu_torch.tools import bench_history

    hist = str(tmp_path / "history.jsonl")
    for i, v in enumerate(values):
        bench_history.append_history(
            {"value": v, "platform": "cpu", "unit": "regions/s"},
            f"bench_{i}", path=hist, mtime=float(i))
    monkeypatch.setenv("BENCH_HISTORY", hist)
    assert preflight.main(["--only", "bench_gate", "--out-dir",
                           str(tmp_path / "pf")]) == rc
    out = capsys.readouterr().out
    with open(tmp_path / "pf" / "preflight.json") as f:
        v = json.load(f)
    assert [c["name"] for c in v["checks"]] == ["bench_gate"]
    assert v["checks"][0]["exit"] == rc and v["ok"] is (rc == 0)
    with open(v["checks"][0]["log"]) as f:
        log = f.read()
    assert ("GATE FAILED: 1 regression(s)" in log) == (rc == 1)
    assert ("PREFLIGHT OK" in out) == (rc == 0)


def test_preflight_runs_lint_and_writes_the_verdict(tmp_path, capsys):
    rc = preflight.main(["--backend", "cpu", "--only", "lint",
                         "--out-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0 and "PREFLIGHT OK" in out
    with open(tmp_path / "preflight.json") as f:
        v = json.load(f)
    assert v["ok"] is True and v["backend"] == "cpu"
    assert [c["name"] for c in v["checks"]] == ["lint"]
    assert v["checks"][0]["exit"] == 0 and v["checks"][0]["wall_s"] > 0
    assert os.path.exists(v["checks"][0]["log"])
    assert "bench_gate" not in v["not_run"]


@pytest.mark.parametrize("backend", ["cpu", "cuda"])
def test_preflight_passes_the_backend_to_the_smokes(backend):
    checks = {c["name"]: c for c in preflight.battery(True, backend)}
    for name in ("chaos_suite", "fleet_smoke", "drift_smoke"):
        argv = checks[name]["argv"]
        assert argv[argv.index("--backend") + 1] == backend
        assert argv[-2:] == ["--eps", "0.5"]
        assert argv[2] == f"explicit_hybrid_mpc_tpu_torch.tools.{name}"
    assert "--backend" not in checks["lint"]["argv"]
    # tier1 is the ROADMAP command's pytest run, never started here.
    assert checks["tier1"]["argv"][1:4] == ["-m", "pytest", "tests/"]


def test_preflight_lists_tier1_as_not_run_without_jax(tmp_path,
                                                      monkeypatch, capsys):
    monkeypatch.setattr(preflight, "has_jax", lambda: False)
    monkeypatch.setenv("BENCH_HISTORY", str(tmp_path / "history.jsonl"))
    with pytest.raises(SystemExit) as e:
        preflight.main(["--only", "tier1"])
    assert e.value.code != 0 and "needs jax" in capsys.readouterr().err
    rc = preflight.main(["--backend", "cpu", "--skip", "chaos_suite,"
                         "fleet_smoke,drift_smoke", "--out-dir",
                         str(tmp_path)])
    capsys.readouterr()
    with open(tmp_path / "preflight.json") as f:
        v = json.load(f)
    assert rc == 0 and [c["name"] for c in v["checks"]] == ["lint",
                                                            "bench_gate"]
    assert set(v["not_run"]) == {"tier1"}


# -- no card, no quiet CPU run ---------------------------------------------

@pytest.mark.parametrize("tool,argv", [
    (fleet_smoke, []),
    (fleet_smoke, ["--sharded"]),
    (preflight, ["--only", "lint,fleet_smoke"]),
])
def test_tools_refuse_to_start_without_a_card(tool, argv, tmp_path,
                                              monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as e:
        tool.main(argv + (["--out-dir", str(tmp_path / "pf")]
                          if tool is preflight else []))
    assert "cpu" in str(e.value) and "CUDA" in str(e.value)
    assert list(tmp_path.iterdir()) == []  # nothing was run
