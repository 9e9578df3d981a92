"""Torch port: tools/long_build.py against the JAX package's
scripts/long_build.py on the CPU, on the tier-1 double-integrator
fixture (N=3, theta_box=1.5, eps 0.2, 64 simplices a batch, a checkpoint
every 4 steps, run to drain).

- A drained campaign has the JAX script's regions, stop reason and
  progress rows (both paused once on a fresh capture sentinel, the 30 s
  sleep patched to remove it).
- A resume with another LONG_EPS is refused with the JAX script's
  message.
- A campaign stopped by LONG_BUDGET_S after its 2nd checkpoint and
  resumed gives the uninterrupted campaign's tree node for node, its
  progress rows continuous (an orphaned sentinel, 700 s old, pauses
  nothing).
- A health rule that trips ends in ``health_halt`` with one
  ``auto_profile_*.json`` (as JAX tests/test_fleet.py's
  ``test_trigger_auto_profile_external``).

The JAX script runs in its own process (BENCH_PLATFORM=cpu), loaded by
a small launcher that points its SENTINEL and its clock's sleep at the
test's; the port's tool runs in this one with ``--backend cpu``."""

import glob
import json
import os
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

from explicit_hybrid_mpc_tpu_torch.partition.frontier import load_checkpoint
from explicit_hybrid_mpc_tpu_torch.tools import long_build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KNOBS = {"LONG_PROBLEM": "double_integrator",
         "LONG_PROBLEM_ARGS": '{"N": 3, "theta_box": 1.5}',
         "LONG_EPS": "0.2", "LONG_CKPT_EVERY": "4", "LONG_BATCH": "64",
         "LONG_TARGET_REGIONS": "0"}
#: The progress row's keys that follow from the tree alone (the rest are
#: times and rates).
ROW_KEYS = ("regions", "tree_nodes", "steps", "frontier_left",
            "oracle_solves", "cache_peak_vertices", "uncertified")

_JAX_LAUNCHER = r"""
import importlib.util, os, sys, time, types
spec = importlib.util.spec_from_file_location("jax_long_build", sys.argv[1])
m = importlib.util.module_from_spec(spec)
spec.loader.exec_module(m)
m.SENTINEL = sys.argv[2]

def sleep(s):
    if os.path.exists(m.SENTINEL):
        os.unlink(m.SENTINEL)

m.time = types.SimpleNamespace(time=time.time, monotonic=time.monotonic,
                               sleep=sleep)
sys.exit(m.main())
"""


def _jax_env(wd, **extra):
    return {**os.environ, "BENCH_PLATFORM": "cpu", **KNOBS,
            "LONG_OUT": str(wd / "long_build.json"),
            "LONG_CKPT": str(wd / "long_build.ckpt.pkl"),
            "LONG_EXPORT_DIR": str(wd / "leaf_table"), **extra}


def _jax(wd, **extra):
    return subprocess.Popen(
        [sys.executable, "-c", _JAX_LAUNCHER,
         os.path.join(REPO, "scripts", "long_build.py"),
         str(wd / "sentinel")], cwd=REPO, env=_jax_env(wd, **extra),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)


def _port(monkeypatch, wd, sleep=None, **extra):
    """The port's tool in this process on the fixture in `wd`; (exit
    code, JSON).  `sleep` stands in for the module's clock's."""
    for k, v in {**KNOBS, **extra}.items():
        monkeypatch.setenv(k, v)
    if sleep is not None:
        monkeypatch.setattr(long_build, "time", types.SimpleNamespace(
            time=time.time, monotonic=time.monotonic, sleep=sleep))
    out = str(wd / "long_build.json")
    rc = long_build.main(["--backend", "cpu", "--out", out, "--sentinel",
                          str(wd / "sentinel")])
    monkeypatch.setattr(long_build, "time", time)
    with open(out) as f:
        return rc, json.load(f)


def _sign(ckpt: str) -> dict:
    """The checkpointed tree's arrays, for a node-for-node comparison."""
    tree = load_checkpoint(ckpt)["tree"]
    ids = tree.converged_leaf_ids()
    delta, U, V = tree.leaf_payloads(ids)
    return {"vertices": np.asarray(tree.vertices), "leaf_ids": ids,
            "delta": np.asarray(delta), "U": np.asarray(U),
            "V": np.asarray(V), "n_regions": np.asarray(tree.n_regions())}


def _remove(path):
    def sleep(_s):
        if os.path.exists(path):
            os.unlink(path)
    return sleep


@pytest.fixture(scope="module")
def drained(tmp_path_factory):
    """Both packages' drained campaigns, each paused once on a fresh
    sentinel; then the JAX script refusing a resume at another eps."""
    jwd = tmp_path_factory.mktemp("jax_long")
    pwd = tmp_path_factory.mktemp("port_long")
    for wd in (jwd, pwd):
        open(wd / "sentinel", "w").close()
    proc = _jax(jwd)
    try:
        mp = pytest.MonkeyPatch()
        try:
            rc, port = _port(mp, pwd, sleep=_remove(str(pwd / "sentinel")))
        finally:
            mp.undo()
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err.decode()[-3000:]
        with open(jwd / "long_build.json") as f:
            jax = json.load(f)
        proc = _jax(jwd, LONG_EPS="0.3")
        _, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
    with open(jwd / "long_build.json") as f:
        jax_refused = json.load(f)
    return {"jax": jax, "port": port, "rc": rc, "jwd": jwd, "pwd": pwd,
            "jax_refused": jax_refused, "jax_refused_rc": proc.returncode}


def test_a_drained_campaign_is_the_jax_scripts(drained):
    jax, port = drained["jax"], drained["port"]
    assert drained["rc"] == 0
    assert set(port) == set(jax)
    assert set(port["stats"]) >= set(jax["stats"]) - {"mesh_devices"}
    for k in ("stop_reason", "problem", "problem_args", "eps_a", "eps_r",
              "precision", "checkpoint_every", "prune_rows",
              "online_leaves", "online_path", "online_shards",
              "split_hyperplanes", "paused_for_captures_s"):
        assert port[k] == jax[k], k
    assert port["stop_reason"] == "drained"
    assert port["paused_for_captures_s"] == 30.0
    for k in ("regions", "tree_nodes", "steps", "uncertified",
              "oracle_solves"):
        assert port["stats"][k] == jax["stats"][k], k
    assert port["stats"]["regions"] == 392
    assert [{k: r[k] for k in ROW_KEYS} for r in port["progress"]] \
        == [{k: r[k] for k in ROW_KEYS} for r in jax["progress"]]
    assert [r["steps"] for r in port["progress"]] == [4, 8, 12, 16]
    assert port["online_us_per_query"] > 0
    assert set(port["slo"]) == set(jax["slo"])


def test_a_resume_at_another_eps_is_refused_as_the_jax_script_refuses(
        drained, monkeypatch):
    pwd = drained["pwd"]
    rc, port = _port(monkeypatch, pwd, LONG_EPS="0.3")
    jax = drained["jax_refused"]
    assert rc == drained["jax_refused_rc"] == 1
    msg = port["error"].replace(str(pwd), "WD")
    assert msg == jax["error"].replace(str(drained["jwd"]), "WD")
    assert "was built with eps_a=0.2 but this run requests 0.3" in msg
    assert set(port) == set(jax)


def test_a_budget_stop_resumes_to_the_uninterrupted_tree(
        drained, tmp_path, monkeypatch):
    """Stopped by LONG_BUDGET_S right after its 2nd checkpoint (the
    module's clock jumps then), resumed with the same knobs: the
    uninterrupted campaign's tree node for node, progress rows [4, 8]
    then [12, 16], resumed from step 8; an orphaned sentinel pauses
    nothing."""
    sent = tmp_path / "sentinel"
    open(sent, "w").close()
    old = time.time() - 700
    os.utime(sent, (old, old))
    jump = {"n": 0, "t": 0.0}

    def clock():
        return time.time() + jump["t"]

    def log(msg):
        if msg.startswith("ckpt @ step"):
            jump["n"] += 1
            if jump["n"] == 2:
                jump["t"] = 1e6

    def never(_s):
        raise AssertionError("paused on an orphaned sentinel")
    for k, v in {**KNOBS, "LONG_BUDGET_S": "100"}.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(long_build, "log", log)
    monkeypatch.setattr(long_build, "time", types.SimpleNamespace(
        time=clock, monotonic=time.monotonic, sleep=never))
    out = str(tmp_path / "long_build.json")
    argv = ["--backend", "cpu", "--out", out, "--sentinel", str(sent)]
    assert long_build.main(argv) == 0
    with open(out) as f:
        first = json.load(f)
    assert first["stop_reason"] == "budget"
    assert [r["steps"] for r in first["progress"]] == [4, 8]
    assert first["paused_for_captures_s"] == 0.0
    monkeypatch.setattr(long_build, "time", time)
    monkeypatch.setenv("LONG_BUDGET_S", "21000")
    assert long_build.main(argv) == 0
    with open(out) as f:
        second = json.load(f)
    assert second["stop_reason"] == "drained"
    assert second["resumed_from_step"] == 8
    assert [r["steps"] for r in second["progress"]] == [4, 8, 12, 16]
    assert [{k: r[k] for k in ROW_KEYS} for r in second["progress"]] \
        == [{k: r[k] for k in ROW_KEYS}
            for r in drained["port"]["progress"]]
    a = _sign(str(tmp_path / "long_build.ckpt.pkl"))
    b = _sign(str(drained["pwd"] / "long_build.ckpt.pkl"))
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    assert second["stats"]["regions"] == 392


def test_a_critical_health_rule_halts_with_one_profile(tmp_path,
                                                       monkeypatch):
    """A rescue storm (a 0+2 point schedule, every straggler re-solved,
    no rescue share allowed): the campaign opens its auto-profile
    capture, runs its steps, checkpoints and halts."""
    rc, res = _port(
        monkeypatch, tmp_path, BENCH_POINT_SCHEDULE="0,2",
        BENCH_RESCUE="30",
        LONG_HEALTH_RULES='{"max_rescue_frac": 1e-9, '
                          '"min_solves_for_rates": 1}')
    assert rc == 0
    assert res["stop_reason"] == "health_halt"
    assert res["health"]["worst"] == "critical"
    assert [e["name"] for e in res["health"]["events"]] \
        == ["health.rescue_storm"]
    bundles = glob.glob(str(tmp_path / "repro" / "auto_profile_*.json"))
    assert len(bundles) == 1
    with open(bundles[0]) as f:
        bundle = json.load(f)
    assert bundle["reason"].startswith("health_halt:health.rescue_storm")
    assert "error" not in bundle
    assert res["stats"]["steps"] > res["progress"][-1]["steps"]
    assert os.path.exists(tmp_path / "long_build.ckpt.pkl")


def test_refuses_without_a_card(monkeypatch, tmp_path):
    monkeypatch.delenv("BENCH_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no card"):
        long_build.main(["--out", str(tmp_path / "l.json")])
    assert not (tmp_path / "l.json").exists()
