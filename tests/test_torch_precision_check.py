"""Torch port: tools/precision_check.py against the JAX package's
scripts/precision_check.py on the CPU.

Both run at the knobs of tests/test_capture_scripts.py's smoke (the
double integrator, eps 0.5, 32 points, 64 soundness samples): the JAX
script in its own process with BENCH_PLATFORM=cpu, started first, the
port's tool in this one with ``--backend cpu``.  Their JSONs have the
same keys, both builds the same regions and tree nodes, the same
parity, regions-equal and eps-sound verdicts and exit code, and the
acceptance rates and converged fractions within 0.02."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from explicit_hybrid_mpc_tpu_torch.problems.registry import make
from explicit_hybrid_mpc_tpu_torch.tools import precision_check

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KNOBS = {"PREC_PROBLEM": "double_integrator", "PREC_EPS": "0.5",
         "PREC_POINTS": "32", "PREC_TIME_BUDGET": "60",
         "PREC_SOUND_SAMPLES": "64"}
TOL = 0.02


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX script in its own process, started before the port's tool
    runs; (process, JSON path)."""
    out = str(tmp_path_factory.mktemp("jax_prec") / "precision.json")
    env = dict(os.environ, BENCH_PLATFORM="cpu", PREC_OUT=out, **KNOBS)
    proc = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "scripts", "precision_check.py")],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
        proc.wait(30)


@pytest.fixture(scope="module")
def both(jax_run, tmp_path_factory):
    wd = tmp_path_factory.mktemp("port_prec")
    out = str(wd / "precision.json")
    mp = pytest.MonkeyPatch()
    for k, v in KNOBS.items():
        mp.setenv(k, v)
    try:
        rc = precision_check.main(["--backend", "cpu", "--out", out,
                                   "--sentinel", str(wd / "sentinel")])
    finally:
        mp.undo()
    proc, jax_out = jax_run
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err.decode()[-2000:]
    with open(jax_out) as f:
        jax = json.load(f)
    with open(out) as f:
        port = json.load(f)
    return jax, port, proc.returncode, rc


def test_the_keys_are_the_jax_scripts(both):
    jax, port, _, _ = both
    assert set(port) == set(jax)
    for k in ("mixed_kkt", "f64_kkt", "mixed_sound_sampled"):
        assert set(port[k]) == set(jax[k]), k
    for p in ("mixed", "f64"):
        assert set(port["builds"][p]) == set(jax["builds"][p])
    assert port["platform"] == jax["platform"] == "cpu"


def test_both_builds_are_the_jax_scripts(both):
    jax, port, _, _ = both
    for p in ("mixed", "f64"):
        for k in ("regions", "tree_nodes", "truncated", "device_failures"):
            assert port["builds"][p][k] == jax["builds"][p][k], (p, k)
    assert port["builds"]["f64"]["regions"] == 1566
    assert port["builds"]["f64"]["tree_nodes"] == 3130


def test_the_verdicts_are_the_jax_scripts(both):
    jax, port, jax_rc, rc = both
    for k in ("parity_valid", "mixed_vs_f64_regions_equal",
              "mixed_eps_sound", "sampled_instances", "n_delta", "problem"):
        assert port[k] == jax[k], k
    assert rc == jax_rc == precision_check.verdict(port) == 0
    js, ps = jax["mixed_sound_sampled"], port["mixed_sound_sampled"]
    assert ps["n_checked"] == js["n_checked"] == 64
    assert ps["n_skipped"] == js["n_skipped"]
    assert ps["eps_budget"] == js["eps_budget"]
    assert ps["max_excess"] == pytest.approx(js["max_excess"], abs=1e-6)
    assert ps["max_violation"] == pytest.approx(js["max_violation"],
                                                abs=1e-6)


def test_the_rates_are_the_jax_scripts(both):
    jax, port, _, _ = both
    for k in ("f32_accept_rate", "f32_accept_rate_converged",
              "convergence_agree_frac"):
        assert abs(port[k] - jax[k]) <= TOL, k
    for s in ("mixed_kkt", "f64_kkt"):
        assert abs(port[s]["converged_frac"]
                   - jax[s]["converged_frac"]) <= TOL, s
        assert port[s]["rp_max"] < 1e-8 and port[s]["rd_max"] < 1e-8


def test_the_exit_rule():
    assert precision_check.verdict({"mixed_eps_sound": True}) == 0
    assert precision_check.verdict(
        {"mixed_vs_f64_regions_equal": True}) == 0
    assert precision_check.verdict(
        {"mixed_vs_f64_regions_equal": False, "mixed_eps_sound": False}) == 1
    assert precision_check.verdict({"mixed_eps_sound": True,
                                    "error": "x"}) == 1


def test_acceptance_takes_any_problem_object():
    """The step chip_smoke runs at the sub-boxes: a problem object in, the
    section's keys out, the grid solved as one batch (8 thetas x 4
    commutations of a small pendulum)."""
    prob = make("inverted_pendulum", N=2)
    out = precision_check.acceptance(prob, torch.device("cpu"), 8)
    assert out["sampled_instances"] == 8 * prob.canonical.n_delta
    assert set(out) == {"sampled_instances", "f32_accept_rate",
                        "f32_accept_rate_converged", "mixed_kkt", "f64_kkt",
                        "convergence_agree_frac",
                        "max_obj_diff_mixed_vs_f64"}
    assert 0.0 <= out["f32_accept_rate"] <= 1.0


def test_grid_solve_is_the_oracles_point_grid():
    """grid_solve's cells are the oracle's own point-grid cells."""
    from explicit_hybrid_mpc_tpu_torch.oracle.oracle import Oracle

    prob = make("inverted_pendulum", N=2)
    o = Oracle(prob, backend="cpu", precision="mixed")
    th = np.random.default_rng(0).uniform(prob.theta_lb, prob.theta_ub,
                                          (6, prob.n_theta))
    g = precision_check.grid_solve(o, th)
    sol = o.solve_vertices(th)
    assert g["converged"].shape == (6, prob.canonical.n_delta)
    np.testing.assert_array_equal(g["converged"], sol.conv)


def test_refuses_without_a_card_and_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.delenv("BENCH_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "p.json"
    with pytest.raises(SystemExit, match="no card"):
        precision_check.main(["--out", str(out)])
    assert not out.exists()
