"""Torch port: profiler capture (``obs/profiling.py`` on torch.profiler,
the frontier engine's ``--profile`` trace and its AutoProfiler) against
the JAX package's.

``summarize_trace`` reads the Chrome trace torch.profiler exports: on a
CPU capture it returns the JAX package's summary keys, and the JAX
package's own summarizer reads the same file to the same values.
AutoProfiler's trigger / on_step / finish / max_captures lifecycle is
driven with the same step sequences through both packages (the
profilers themselves stubbed, so only the bookkeeping is compared), and
a profiler that cannot start writes its error into the bundle in both.
End to end on the CPU: ``main --profile DIR --profile-steps 2`` writes
a trace and builds bitwise the tree built without it, and an engine
armed with ``auto_profile`` captures through its external trigger."""

import json
import os

import numpy as np
import pytest
import torch

import explicit_hybrid_mpc_tpu  # noqa: F401
from explicit_hybrid_mpc_tpu.obs import profiling as jprofiling
from explicit_hybrid_mpc_tpu_torch import main as tmain
from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
from explicit_hybrid_mpc_tpu_torch.obs import profiling
from explicit_hybrid_mpc_tpu_torch.oracle.oracle import Oracle
from explicit_hybrid_mpc_tpu_torch.partition.frontier import FrontierEngine
from explicit_hybrid_mpc_tpu_torch.partition.tree import Tree
from explicit_hybrid_mpc_tpu_torch.problems.registry import make

torch.set_num_threads(1)

JAX_KEYS = {"trace_files", "events", "tracks", "top_ops_ms"}
DI_ARGV = ["-e", "double_integrator", "--problem-arg", "N=3",
           "--problem-arg", "theta_box=1.5", "-a", "0.5", "--batch", "64",
           "--max-depth", "20", "--backend", "cpu"]


def _cpu_trace(trace_dir):
    prof = profiling.start_trace("cpu")
    a = torch.randn(64, 64, dtype=torch.float64)
    for _ in range(5):
        a = torch.tanh(a @ a.T / 64.0)
    return profiling.stop_trace(prof, trace_dir)


def test_summarize_trace_has_the_jax_keys_on_a_cpu_trace(tmp_path):
    path = _cpu_trace(str(tmp_path / "t"))
    assert path.endswith(".trace.json") and os.path.exists(path)
    s = profiling.summarize_trace(str(tmp_path / "t"))
    assert JAX_KEYS <= set(s) and set(s) - JAX_KEYS == {"device_ops_ms"}
    assert s["trace_files"] == 1 and s["events"] > 0
    names = [op["name"] for op in s["top_ops_ms"]]
    assert any("mm" in n or "matmul" in n for n in names), names
    # A CPU capture records no work on a card.
    assert s["device_ops_ms"] == []


def test_summarize_trace_reads_as_the_jax_summarizer(tmp_path):
    """The JAX package's summarizer on the same torch.profiler trace
    gives the same values under every key it has."""
    _cpu_trace(str(tmp_path / "t"))
    got = profiling.summarize_trace(str(tmp_path / "t"), top_n=10)
    ref = jprofiling.summarize_trace(str(tmp_path / "t"), top_n=10)
    assert {k: got[k] for k in ref} == ref


def test_summarize_trace_device_ops_and_missing_dir(tmp_path):
    """Events of the card's categories rank under device_ops_ms (a
    scripted gzipped trace, as a CUDA capture writes them); no trace
    gives the JAX package's error record."""
    import gzip

    d = tmp_path / "dev" / "run"
    d.mkdir(parents=True)
    evs = [{"ph": "M", "name": "process_name", "pid": 7,
            "args": {"name": "python"}},
           {"ph": "M", "name": "process_name", "pid": 0,
            "args": {"name": "GPU 0"}},
           {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "dur": 900.0},
           {"ph": "X", "cat": "kernel", "name": "ipm_leg_fixed", "dur": 40.0},
           {"ph": "X", "cat": "kernel", "name": "ipm_leg_fixed", "dur": 60.0},
           {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH",
            "dur": 5.0},
           {"ph": "i", "name": "marker"}]
    with gzip.open(d / "x.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": evs}, f)
    s = profiling.summarize_trace(str(tmp_path / "dev"))
    assert s["tracks"] == ["GPU 0", "python"] and s["events"] == 4
    assert s["device_ops_ms"] == [
        {"name": "ipm_leg_fixed", "total_ms": 0.1},
        {"name": "Memcpy DtoH", "total_ms": 0.005}]
    assert s["top_ops_ms"][0] == {"name": "aten::mm", "total_ms": 0.9}
    ref = jprofiling.summarize_trace(str(tmp_path / "dev"))
    assert {k: s[k] for k in ref} == ref
    none = profiling.summarize_trace(str(tmp_path / "empty"))
    assert none == jprofiling.summarize_trace(str(tmp_path / "empty"))
    assert "error" in none


class _FakeProf:
    def __init__(self, log):
        self.log = log

    def stop(self):
        self.log.append("stop")

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": []}, f)


def _stub_profilers(monkeypatch, log):
    """Both packages' profiler entry points as recorders (the lifecycle
    bookkeeping is what is compared, not the captures)."""
    import jax

    monkeypatch.setattr(jax.profiler, "start_trace",
                        lambda d: log["jax"].append("start"))
    monkeypatch.setattr(jax.profiler, "stop_trace",
                        lambda: log["jax"].append("stop"))

    def start(device):
        log["torch"].append("start")
        return _FakeProf(log["torch"])

    monkeypatch.setattr(profiling, "start_trace", start)


#: (AutoProfiler kwargs, the driver's script: "t" trigger, "s" on_step,
#: "f" finish).
SCRIPTS = {
    "window_closes": ({"steps": 2}, "tsssss"),
    "finish_mid_window": ({"steps": 5}, "tssf"),
    "budget_spent": ({"steps": 1}, "tsts"),
    "two_captures": ({"steps": 2, "max_captures": 2}, "tssttsstf"),
    "trigger_while_open": ({"steps": 3}, "ttssst"),
}


def _drive(ap, script):
    trace = []
    for c in script:
        if c == "t":
            r = ap.trigger("external", step=len(trace))
        elif c == "s":
            r = ap.on_step()
        else:
            r = ap.finish()
        trace.append((c, r if isinstance(r, bool) or r is None
                      else os.path.basename(r), ap.active, ap.n_captures))
    return trace


@pytest.mark.parametrize("key", sorted(SCRIPTS))
def test_auto_profiler_lifecycle_matches_the_jax_package(key, tmp_path,
                                                         monkeypatch):
    log = {"jax": [], "torch": []}
    _stub_profilers(monkeypatch, log)
    kw, script = SCRIPTS[key]
    ap = profiling.AutoProfiler(str(tmp_path / "t"), **kw)
    jap = jprofiling.AutoProfiler(str(tmp_path / "j"), **kw)
    assert _drive(ap, script) == _drive(jap, script)
    assert log["torch"] == log["jax"]
    assert [os.path.basename(b) for b in ap.bundles] \
        == [os.path.basename(b) for b in jap.bundles]
    for b, jb in zip(ap.bundles, jap.bundles):
        got, ref = json.load(open(b)), json.load(open(jb))
        assert (got["captured_steps"], got["reason"], got.get("error")) \
            == (ref["captured_steps"], ref["reason"], ref.get("error"))


def test_a_profiler_that_cannot_start_writes_its_error(tmp_path,
                                                       monkeypatch):
    import jax

    def boom(*a, **kw):
        raise RuntimeError("profiler already active")

    monkeypatch.setattr(jax.profiler, "start_trace", boom)
    monkeypatch.setattr(profiling, "start_trace", boom)
    out = []
    for mod, d in ((profiling, "t"), (jprofiling, "j")):
        ap = mod.AutoProfiler(str(tmp_path / d), steps=2)
        assert ap.trigger("external") is False
        assert not ap.active and ap.n_captures == 1   # budget burned
        assert ap.trigger("again") is False
        (b,) = ap.bundles
        meta = json.load(open(b))
        assert "start_trace failed" in meta["error"]
        out.append((os.path.basename(b), meta["reason"]))
    assert out[0] == out[1]


def _di_tree_signature(prefix):
    tree = Tree.load(prefix + ".tree.pkl")
    leaves = tree.converged_leaves()
    return (len(tree), tuple(tree.vertices[n].tobytes()
                             for n in range(len(tree))),
            tuple(tree.leaf_data[n].delta_idx for n in leaves),
            tuple(tree.leaf_data[n].vertex_inputs.tobytes()
                  for n in leaves),
            tuple(tree.leaf_data[n].vertex_costs.tobytes()
                  for n in leaves))


def test_main_profile_writes_a_trace_and_the_same_tree(tmp_path):
    plain, profiled = str(tmp_path / "a"), str(tmp_path / "b")
    tdir = str(tmp_path / "trace")
    assert tmain.main([*DI_ARGV, "-o", plain]) == 0
    assert tmain.main([*DI_ARGV, "-o", profiled, "--profile", tdir,
                       "--profile-steps", "2"]) == 0
    s = profiling.summarize_trace(tdir)
    assert s["trace_files"] == 1 and s["events"] > 0
    assert _di_tree_signature(plain) == _di_tree_signature(profiled)
    logs = [json.loads(ln) for ln in open(profiled + ".log.jsonl")]
    assert any(r.get("profiling") for r in logs)


def _engine(tmp_path, **kw):
    prob = make("double_integrator", N=3, theta_box=1.5)
    cfg = PartitionConfig(problem="double_integrator",
                          problem_args=(("N", 3), ("theta_box", 1.5)),
                          backend="cpu", eps_a=0.5, batch_simplices=16,
                          max_depth=20, obs="jsonl",
                          obs_path=str(tmp_path / "di.obs.jsonl"), **kw)
    return FrontierEngine(prob, Oracle(prob, backend="cpu"), cfg)


def test_external_trigger_captures_through_the_engine(tmp_path):
    eng = _engine(tmp_path, auto_profile=True, profile_steps=2)
    eng.step()
    assert eng.trigger_auto_profile("external") == 2
    assert eng.trigger_auto_profile("again") == 0   # already capturing
    eng.step()
    eng.step()
    ap = eng._auto_prof
    assert not ap.active and len(ap.bundles) == 1
    meta = json.load(open(ap.bundles[0]))
    assert "error" not in meta and meta["captured_steps"] == 2
    assert meta["reason"] == "external" and meta["step"] == 1
    assert meta["trace_summary"]["events"] > 0
    assert os.path.dirname(ap.bundles[0]) == str(tmp_path)
    assert eng.trigger_auto_profile("budget") == 0  # max_captures 1
    res = eng.run()
    assert not res.stats["truncated"]
    recs = [json.loads(ln) for ln in open(tmp_path / "di.obs.jsonl")]
    assert any(r.get("name") == "profile.capture" for r in recs)


def test_a_run_that_ends_mid_capture_still_writes_its_bundle(tmp_path):
    eng = _engine(tmp_path, auto_profile=True, profile_steps=50)
    assert eng.trigger_auto_profile("external") == 50
    eng.run()   # drains long before 50 steps; finish_obs closes it
    (b,) = eng._auto_prof.bundles
    meta = json.load(open(b))
    assert "error" not in meta and 0 < meta["captured_steps"] < 50


def test_auto_profile_is_armed_only_without_a_manual_trace(tmp_path):
    assert _engine(tmp_path)._auto_prof is None
    assert _engine(tmp_path).trigger_auto_profile("x") == 0
    manual = _engine(tmp_path, auto_profile=True,
                     profile_path=str(tmp_path / "manual"))
    assert manual._auto_prof is None
    armed = _engine(tmp_path, auto_profile=True)
    assert armed._auto_prof is not None
    # No health rules, so no monitor: polling never opens a capture.
    assert armed._health is None
    armed._poll_auto_profile()
    assert armed._auto_prof.n_captures == 0


def test_profile_steps_keeps_its_jax_default():
    import explicit_hybrid_mpc_tpu.config as jconfig

    assert PartitionConfig().profile_steps \
        == jconfig.PartitionConfig().profile_steps == 5
    args = tmain.build_parser().parse_args(["-e", "double_integrator"])
    assert args.profile_steps == 5 and args.profile is None
    assert args.auto_profile is False
    assert np.isfinite(PartitionConfig(profile_path="x").profile_steps)


@pytest.mark.parametrize("flag", [True, False])
def test_cli_auto_profile_warns_that_nothing_triggers_it(flag, tmp_path,
                                                         capsys,
                                                         monkeypatch):
    """`main --auto-profile` arms the profiler.  The health monitor (its
    trigger) is ported, so the command line no longer warns that nothing
    opens it: with the flag or without, nothing is said on stderr."""
    from explicit_hybrid_mpc_tpu_torch.partition import frontier

    class Captured(Exception):
        pass

    def capture(problem, cfg, *a, **kw):
        assert cfg.auto_profile is flag
        raise Captured

    monkeypatch.setattr(frontier, "make_oracle", capture)
    argv = ["-e", "double_integrator", "--backend", "cpu",
            "-o", str(tmp_path / "p")] + (["--auto-profile"] if flag else [])
    with pytest.raises(Captured):
        tmain.main(argv)
    err = capsys.readouterr().err
    assert "--auto-profile" not in err and "ROADMAP" not in err
