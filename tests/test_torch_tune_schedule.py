"""Torch port: tools/tune_schedule.py against the JAX package's
scripts/tune_schedule.py on the CPU.

Both run at the knobs of tests/test_capture_scripts.py's smoke (the
double integrator, 16 points, eps 0.5, a 20 s build budget): the JAX
script in its own process with BENCH_PLATFORM=cpu, the port's tool in
this one with ``--backend cpu``.  They give the same seven schedule rows
in order with the same keys, converged and rescue fractions within 0.02,
the same parity builds' regions and tree nodes and the same parity
verdict; timings are only checked to be positive (CPU times are no
device metric)."""

import json
import os
import subprocess
import sys

import pytest
import torch

from explicit_hybrid_mpc_tpu_torch.tools import tune_schedule

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KNOBS = {"TUNE_POINTS": "16", "TUNE_EPS": "0.5", "TUNE_BUILD_BUDGET": "20",
         "TUNE_PROBLEM": "double_integrator"}
TOL = 0.02


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    jax_out = str(tmp_path_factory.mktemp("jax_tune") / "tune.json")
    env = dict(os.environ, BENCH_PLATFORM="cpu", TUNE_OUT=jax_out, **KNOBS)
    proc = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "scripts", "tune_schedule.py")],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        wd = tmp_path_factory.mktemp("port_tune")
        out = str(wd / "tune.json")
        mp = pytest.MonkeyPatch()
        for k, v in KNOBS.items():
            mp.setenv(k, v)
        try:
            rc = tune_schedule.main(["--backend", "cpu", "--out", out,
                                     "--sentinel", str(wd / "sentinel")])
        finally:
            mp.undo()
        _, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
    assert proc.returncode == 0, err.decode()[-2000:]
    assert rc == 0
    with open(jax_out) as f:
        jax = json.load(f)
    with open(out) as f:
        port = json.load(f)
    return jax, port


def test_the_keys_are_the_jax_scripts(both):
    jax, port = both
    assert set(port) == set(jax)
    assert port["platform"] == jax["platform"] == "cpu"
    for k in ("problem", "n_delta", "n_points"):
        assert port[k] == jax[k]


def test_the_seven_rows_are_the_jax_scripts(both):
    jax, port = both
    assert len(port["schedules"]) == len(jax["schedules"]) \
        == len(tune_schedule.SCHEDULES) == 7
    for pr, jr, s in zip(port["schedules"], jax["schedules"],
                         tune_schedule.SCHEDULES):
        assert set(pr) == set(jr), s
        for k in ("n_f32", "n_f64", "point", "rescue", "conv_ok"):
            assert pr.get(k) == jr.get(k), (s, k)
        assert abs(pr["converged_frac"] - jr["converged_frac"]) <= TOL, s
        assert abs(pr["rescue_frac"] - jr["rescue_frac"]) <= TOL, s
        assert pr["point_us_per_qp"] > 0 and pr["simplex_us_per_qp"] > 0
        assert pr["simplex_qps_issued"] >= 64


def test_the_parity_builds_are_the_jax_scripts(both):
    jax, port = both
    for tag in ("default", "fastest"):
        for k in ("regions", "tree_nodes", "truncated"):
            assert port["parity_builds"][tag][k] \
                == jax["parity_builds"][tag][k], (tag, k)
        assert port["parity_builds"][tag]["regions"] == 1566
    assert port["parity_builds"]["default"]["schedule"] \
        == jax["parity_builds"]["default"]["schedule"]
    assert port["parity_valid"] == jax["parity_valid"] is True
    assert port["fastest_parity_ok"] == jax["fastest_parity_ok"] is True
    assert port["fastest_speedup"] > 0


def test_refuses_without_a_card(monkeypatch, tmp_path):
    monkeypatch.delenv("BENCH_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no card"):
        tune_schedule.main(["--out", str(tmp_path / "t.json")])
    monkeypatch.setenv("BENCH_PLATFORM", "tpu")
    with pytest.raises(SystemExit, match="no TPU backend"):
        tune_schedule.main(["--out", str(tmp_path / "t.json")])
    assert not (tmp_path / "t.json").exists()
