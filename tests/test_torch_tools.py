"""Torch port: the robustness gate's tools (explicit_hybrid_mpc_tpu_torch/
tools/) on the CPU, against the JAX package's scripts.

- the build supervisor: the fault plan is stripped after the first
  crash, ``.prev`` is chosen when the newest generation is torn,
  restarts are bounded, the summary JSON is written, and a child that
  ends with NoCpuFallback (here a stand-in that raises it) is not
  restarted;
- the chaos suite at ``--backend cpu --eps 0.5``, one case a schedule
  against one fault-free reference build, whose tree is also the JAX
  package's clean build of the same argv (through the arrays); the
  card's verdicts rehearsed with children that stand in for a card
  build (a CPU build whose recovery acts as on the card);
- the suite's lanes (schedules run concurrently) keeping its serial
  verdict;
- the port's comparators against scripts/chaos_suite.py's on the same
  pairs of trees and artifact directories, identical and perturbed;
- the drift smoke at ``--backend cpu --eps 0.5``;
- every tool refusing to start without a card under its default
  backend."""

import dataclasses
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

import explicit_hybrid_mpc_tpu  # noqa: F401  (enables x64)
from explicit_hybrid_mpc_tpu import main as jmain
from explicit_hybrid_mpc_tpu.partition.tree import Tree as JaxTree
from explicit_hybrid_mpc_tpu_torch import device as device_lib
from explicit_hybrid_mpc_tpu_torch.partition.tree import Tree
from explicit_hybrid_mpc_tpu_torch.tools import (chaos_suite, drift_smoke,
                                                 supervise_build)
from explicit_hybrid_mpc_tpu_torch.utils import atomic

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPS = 0.5
BATCH = 64

#: A child standing in for a `main` run on the card: the build runs on
#: the CPU (`--backend cuda` read as cpu), but its recovery sees a CUDA
#: oracle, so its first device failure ends it with NoCpuFallback, as a
#: card build's does.
CARD_STAND_IN = r"""
import sys, torch
from explicit_hybrid_mpc_tpu_torch import main
from explicit_hybrid_mpc_tpu_torch.partition import frontier
argv = ["cpu" if a == "cuda" else a for a in sys.argv[1:]]
real = frontier.FrontierEngine._recover
def on_card(self, kind, args, err):
    dev = self.oracle.device
    self.oracle.device = torch.device("cuda", 0)
    try:
        return real(self, kind, args, err)
    finally:
        self.oracle.device = dev
frontier.FrontierEngine._recover = on_card
sys.exit(main.cli(argv))
"""

#: A child that notes its argv and whether it saw a fault plan, then
#: exits with the code the next line of CODES names (0 once they run
#: out).
RECORDING_CHILD = r"""
import json, os, sys
log, codes = os.environ["CHILD_LOG"], os.environ["CHILD_CODES"].split(",")
n = sum(1 for _ in open(log)) if os.path.exists(log) else 0
with open(log, "a") as f:
    f.write(json.dumps({"argv": sys.argv[1:],
                        "plan": "EHM_FAULT_PLAN" in os.environ,
                        "run_id": os.environ.get("EHM_RUN_ID")}) + "\n")
sys.exit(int(codes[n]) if n < len(codes) else 0)
"""

#: A child that ends with NoCpuFallback chained to an injected fault,
#: through main.cli as a `main` process does.
NO_CPU_FALLBACK_CHILD = r"""
import sys
from explicit_hybrid_mpc_tpu_torch import device, main
from explicit_hybrid_mpc_tpu_torch.faults import InjectedFault
def lost(argv):
    raise device.NoCpuFallback("oracle query failed on cuda:0") \
        from InjectedFault("injected device failure")
main.main = lost
sys.exit(main.cli(sys.argv[1:]))
"""


# -- the supervisor --------------------------------------------------------

def _records(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f]


def _recording(tmp_path, codes, monkeypatch):
    log = str(tmp_path / "children.jsonl")
    monkeypatch.setenv("CHILD_LOG", log)
    monkeypatch.setenv("CHILD_CODES", ",".join(map(str, codes)))
    monkeypatch.setenv("EHM_FAULT_PLAN", str(tmp_path / "plan.json"))
    return log, [sys.executable, "-c", RECORDING_CHILD]


@pytest.mark.parametrize("keep", [False, True])
def test_supervisor_strips_the_plan_after_the_first_crash(
        tmp_path, monkeypatch, keep):
    log, entry = _recording(tmp_path, [43, 1], monkeypatch)
    ck = str(tmp_path / "b.ckpt.pkl")
    atomic.atomic_pickle(ck, {"tree": None})
    s = supervise_build.run_supervised(["-o", str(tmp_path / "b")], ck,
                                       keep_fault_plan=keep, entry=entry)
    recs = _records(log)
    assert s["rc"] == 0 and s["restarts"] == 2 and s["final"] == "ok"
    assert [a["rc"] for a in s["attempts"]] == [43, 1, 0]
    assert [r["plan"] for r in recs] == [True, keep, keep]
    assert recs[0]["argv"] == ["-o", str(tmp_path / "b")]
    assert recs[1]["argv"][-2:] == ["--resume", ck]
    # One run id across the restart chain.
    assert len({r["run_id"] for r in recs}) == 1 and recs[0]["run_id"]


def test_supervisor_resumes_from_prev_when_the_newest_is_torn(
        tmp_path, monkeypatch):
    log, entry = _recording(tmp_path, [43], monkeypatch)
    ck = str(tmp_path / "b.ckpt.pkl")
    atomic.atomic_pickle(ck + ".prev", {"tree": "gen 1"})
    atomic.atomic_pickle(ck, {"tree": "gen 2"})
    with open(ck, "r+b") as f:
        f.truncate(os.path.getsize(ck) - 5)
    assert supervise_build.latest_checkpoint(ck) == ck + ".prev"
    s = supervise_build.run_supervised([], ck, entry=entry)
    assert s["attempts"][1]["resumed_from"] == ck + ".prev"
    assert _records(log)[1]["argv"] == ["--resume", ck + ".prev"]
    # Both generations torn (or none on disk): the restart is cold.
    with open(ck + ".prev", "r+b") as f:
        f.truncate(20)
    assert supervise_build.latest_checkpoint(ck) is None
    assert supervise_build.latest_checkpoint(str(tmp_path / "no")) is None


def test_supervisor_bounds_restarts(tmp_path, monkeypatch):
    log, entry = _recording(tmp_path, [1] * 9, monkeypatch)
    s = supervise_build.run_supervised([], str(tmp_path / "x.ckpt.pkl"),
                                       max_restarts=2, entry=entry)
    assert s["rc"] == 1 and s["restarts"] == 2
    assert s["final"] == "restarts_exhausted"
    assert len(_records(log)) == 3


def test_supervisor_does_not_restart_after_no_cpu_fallback(tmp_path):
    s = supervise_build.run_supervised(
        [], str(tmp_path / "x.ckpt.pkl"),
        entry=[sys.executable, "-c", NO_CPU_FALLBACK_CHILD])
    assert s["rc"] == device_lib.NO_CPU_FALLBACK_EXIT
    assert s["restarts"] == 0 and s["final"] == "no_cpu_fallback"
    assert len(s["attempts"]) == 1


def test_supervisor_cli_writes_the_summary(tmp_path):
    """The CLI over a real CPU build: exit 0, no restart, the summary
    JSON beside the outputs."""
    out = str(tmp_path / "di")
    rc = supervise_build.main([
        "--", "-e", "double_integrator", "--problem-arg", "N=3",
        "--problem-arg", "theta_box=1.5", "-a", str(EPS), "--batch",
        str(BATCH), "--backend", "cpu", "--checkpoint-every", "4",
        "-o", out])
    assert rc == 0
    with open(out + ".supervise.json") as f:
        s = json.load(f)
    assert s["rc"] == 0 and s["restarts"] == 0 and s["final"] == "ok"
    assert s["checkpoint"] == out + ".ckpt.pkl"
    assert os.path.exists(out + ".tree.pkl")


# -- the chaos suite -------------------------------------------------------

@pytest.fixture(scope="module")
def chaos_wd(tmp_path_factory):
    wd = str(tmp_path_factory.mktemp("chaos"))
    ref = chaos_suite.reference_build(wd, EPS, BATCH, "cpu", timeout_s=300)
    assert ref["rc"] == 0 and not ref["failures"], ref
    return wd


@pytest.mark.parametrize("name", sorted(chaos_suite.SCHEDULES))
def test_chaos_schedule_on_the_cpu(chaos_wd, name):
    row = chaos_suite.run_schedule(name, chaos_wd, EPS, BATCH, "cpu",
                                   timeout_s=300)
    assert row["failures"] == [], row
    assert not row["hung"]
    if "stats" in row:
        assert row["stats"]["quarantined_cells"] == 0
        assert row["tree_diffs"] == []


def test_chaos_reference_is_the_jax_clean_build(chaos_wd, tmp_path):
    """The suite's fault-free tree equals the JAX package's clean build
    of the same argv: vertices, leaf ids and commutations bitwise, the
    payloads to 1e-12 relative (the packages' BLAS round the last
    bits differently)."""
    out = str(tmp_path / "jax_base")
    argv = chaos_suite.build_argv(out, EPS, BATCH, "cpu")
    assert jmain.main(argv) == 0
    a = Tree.load(os.path.join(chaos_wd, "base.tree.pkl"))
    b = JaxTree.load(out + ".tree.pkl")
    ia, ib = a.converged_leaf_ids(), b.converged_leaf_ids()
    assert np.array_equal(a.vertices, b.vertices)
    assert np.array_equal(ia, ib)
    (da, Ua, Va), (db, Ub, Vb) = a.leaf_payloads(ia), b.leaf_payloads(ib)
    assert np.array_equal(da, db)
    np.testing.assert_allclose(Ua, Ub, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(Va, Vb, rtol=1e-12, atol=1e-12)


def test_chaos_card_verdicts_rehearse_with_card_stand_ins(chaos_wd,
                                                          tmp_path):
    """The cuda verdicts, with children standing in for card builds:
    schedules 1-2 end with NoCpuFallback chained to their cause and no
    tree, the process gone within hang_s + HANG_SLACK_S of the fault;
    schedule 4's faulted shard ends the same way and the launcher
    returns non-zero, shard 0 stopped."""
    import shutil

    wd = str(tmp_path)
    # The stand-in reference is the CPU build of the same config.
    for ext in (".tree.pkl", ".stats.json"):
        shutil.copy(os.path.join(chaos_wd, "base" + ext),
                    os.path.join(wd, "base" + ext))
    entry = [sys.executable, "-c", CARD_STAND_IN]
    rows = {n: chaos_suite.run_schedule(n, wd, EPS, BATCH, "cuda",
                                        timeout_s=300, entry=entry)
            for n in ("device_failure", "solve_timeout",
                      "sharded_device_failure")}
    for n, row in rows.items():
        assert row["failures"] == [], (n, row)
    assert rows["device_failure"]["exception_chain"][-2:] \
        == ["InjectedFault", "NoCpuFallback"]
    st = rows["solve_timeout"]
    assert st["exception_chain"][-2:] == ["SolveTimeout", "NoCpuFallback"]
    assert st["rc"] == device_lib.NO_CPU_FALLBACK_EXIT
    assert not st["tree_written"]
    assert 1.5 <= st["exit_after_fault_s"] \
        <= 4.0 + chaos_suite.HANG_SLACK_S
    sh = rows["sharded_device_failure"]
    assert sh["rcs"][1] == device_lib.NO_CPU_FALLBACK_EXIT
    assert sh["shard0"] == "stopped" and sh["rc"] != 0


def _script_chaos_suite():
    spec = importlib.util.spec_from_file_location(
        "jax_chaos_suite", os.path.join(REPO, "scripts", "chaos_suite.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _perturbed(tree, path, load):
    """`tree` with one converged leaf's vertex costs moved, saved to
    `path` and loaded back through `load`."""
    n = int(tree.converged_leaf_ids()[0])
    ld = tree.leaf_data[n]
    tree.set_leaf(n, dataclasses.replace(
        ld, vertex_costs=np.asarray(ld.vertex_costs) + 1.0))
    tree.save(path)
    return load(path)


def test_comparators_agree_with_the_jax_scripts(chaos_wd, tmp_path):
    """compare_trees, the canonical comparison and compare_artifact_dirs
    give scripts/chaos_suite.py's verdicts on the same pairs: each
    package's comparators on its own trees of one build (identical, one
    leaf's costs perturbed, another build), both on the same artifact
    directories."""
    from explicit_hybrid_mpc_tpu_torch.serve.registry import save_artifacts

    js = _script_chaos_suite()
    port_base = os.path.join(chaos_wd, "base.tree.pkl")
    jax_base = str(tmp_path / "jax.tree.pkl")
    assert jmain.main(chaos_suite.build_argv(str(tmp_path / "jax"), EPS,
                                             BATCH, "cpu")) == 0
    jax_other = str(tmp_path / "jax_other")
    port_other = str(tmp_path / "port_other")
    for mod, out in ((jmain, jax_other), (None, port_other)):
        argv = chaos_suite.build_argv(out, 0.4, BATCH, "cpu")
        if mod is None:
            from explicit_hybrid_mpc_tpu_torch import main as tmain
            assert tmain.main(argv) == 0
        else:
            assert mod.main(argv) == 0
    _perturbed(Tree.load(port_base), str(tmp_path / "p.tree.pkl"),
               Tree.load)
    _perturbed(JaxTree.load(jax_base), str(tmp_path / "jp.tree.pkl"),
               JaxTree.load)
    pairs = [((port_base, port_base), (jax_base, jax_base)),
             ((port_base, str(tmp_path / "p.tree.pkl")),
              (jax_base, str(tmp_path / "jp.tree.pkl"))),
             ((port_base, port_other + ".tree.pkl"),
              (jax_base, jax_other + ".tree.pkl"))]
    verdicts = []
    for (pa, pb), (ja, jb) in pairs:
        got = chaos_suite.compare_trees(pa, pb)
        assert got == js.compare_trees(ja, jb)
        for payloads in (False, True):
            assert chaos_suite.compare_trees_canonical_paths(
                pa, pb, payloads=payloads) \
                == js.compare_trees_canonical_paths(ja, jb,
                                                    payloads=payloads)
        verdicts.append(got)
    assert verdicts[0] == []
    assert verdicts[1] == ["leaf vertex-cost payloads differ"]
    assert verdicts[2] and verdicts[2][0].startswith("node count")
    # Artifact directories: one build's, twice, then one field changed.
    t = Tree.load(port_base)
    d1, d2 = str(tmp_path / "a1"), str(tmp_path / "a2")
    save_artifacts(t, t.roots(), d1)
    save_artifacts(t, t.roots(), d2)
    assert chaos_suite.compare_artifact_dirs(d1, d2) \
        == js.compare_artifact_dirs(d1, d2) == []
    V = np.load(os.path.join(d2, "V.npy"))
    V[0] += 1.0
    np.save(os.path.join(d2, "V.npy"), V)
    assert chaos_suite.compare_artifact_dirs(d1, d2) \
        == js.compare_artifact_dirs(d1, d2) == ["leaf field V differs"]


def test_exception_chain_reads_the_last_traceback():
    text = ("step lines\nTraceback (most recent call last):\n  File "
            "\"x\", line 1\nexplicit_hybrid_mpc_tpu_torch.faults.plan."
            "InjectedFault: injected device failure at oracle.wait#5\n\n"
            "The above exception was the direct cause of the following "
            "exception:\n\nTraceback (most recent call last):\n  File "
            "\"y\", line 2\nexplicit_hybrid_mpc_tpu_torch.device."
            "NoCpuFallback: oracle query 'vertices' failed on cuda:0\n")
    assert chaos_suite.exception_chain(text) == ["InjectedFault",
                                                 "NoCpuFallback"]
    assert chaos_suite.exception_chain("no traceback here\n") == []


@pytest.mark.parametrize("lanes", [1, 3])
def test_the_suites_lanes_keep_its_verdict(tmp_path, monkeypatch, lanes):
    """run_suite with `lanes` schedules at a time gives the serial
    verdict: the same reference, every schedule's row with its "ok", the
    failures in schedule order, whatever order the lanes finish in; the
    schedules of several processes start first, and at 3 lanes
    schedules do overlap."""
    import threading
    import time as _time

    names = list(chaos_suite.SCHEDULES)
    live, most, order = [0], [0], []
    lock = threading.Lock()

    def ref(wd, eps, batch, backend, timeout_s, entry):
        return {"rc": 0, "hung": False, "wall_s": 1.0, "stderr": "x",
                "t_exit": 0.0, "failures": []}

    def sched(name, wd, eps, batch, backend, timeout_s=0.0, entry=None):
        with lock:
            order.append(name)
            live[0] += 1
            most[0] = max(most[0], live[0])
        _time.sleep(0.05 * (len(names) - names.index(name)))
        with lock:
            live[0] -= 1
        return {"rc": 0, "wall_s": 2.0, "name": name,
                "failures": ([f"{name} broke"] if name in (
                    "solve_timeout", "sharded_device_failure") else [])}
    monkeypatch.setattr(chaos_suite, "reference_build", ref)
    monkeypatch.setattr(chaos_suite, "run_schedule", sched)
    v = chaos_suite.run_suite(str(tmp_path), EPS, BATCH, "cpu",
                              lanes=lanes)
    assert v["reference"] == {"rc": 0, "hung": False, "wall_s": 1.0}
    assert list(v["schedules"]) == names
    assert v["schedules"]["device_failure"] == {
        "rc": 0, "wall_s": 2.0, "name": "device_failure", "ok": True}
    assert [n for n in names if not v["schedules"][n]["ok"]] == [
        "solve_timeout", "sharded_device_failure"]
    assert v["failures"] == ["solve_timeout: solve_timeout broke",
                             "sharded_device_failure: "
                             "sharded_device_failure broke"]
    assert most[0] == min(lanes, len(names))
    assert set(order[:3]) == {"kill_mid_checkpoint",
                              "lifecycle_publish_crash",
                              "sharded_device_failure"}


# -- the drift smoke -------------------------------------------------------

def test_drift_smoke_on_the_cpu(capsys):
    assert drift_smoke.main(["--backend", "cpu", "--eps", str(EPS)]) == 0
    verdict = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert verdict["failures"] == [] and verdict["dropped"] == 0
    assert verdict["torn"] == 0 and verdict["summary"]["generations"] == 3
    assert verdict["summary"]["delta_publishes"] >= 1
    assert verdict["demand_leaves"] >= 1
    assert verdict["staleness_p99_s"] <= 120.0


# -- no card, no quiet CPU run ---------------------------------------------

@pytest.mark.parametrize("tool,argv", [
    (supervise_build, ["--", "-e", "double_integrator", "-o", "x"]),
    (chaos_suite, []),
    (drift_smoke, []),
])
def test_tools_refuse_to_start_without_a_card(tool, argv, tmp_path,
                                              monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as e:
        tool.main(argv)
    assert "cpu" in str(e.value) and "CUDA" in str(e.value)
    assert list(tmp_path.iterdir()) == []  # nothing was run
