"""Torch port: tools/north_star.py, bench_configs.py, eps_ladder.py and
online_crossover.py against the JAX package's scripts of the same names,
on the CPU.

The eight runs start together once (module fixture), each in its own
process with BENCH_PLATFORM=cpu, at sizes at which every build completes
in both packages (a truncated build's counts depend on the wall clock):
north_star on the double integrator, its depth capped at 12, parity at
eps 0.5; bench_configs' double-integrator row; the ladder on the double
integrator at eps 0.5 and 0.2; the crossover at eps 0.5 and 0.2 over 512
queries.  The JSONs have the same keys (the port's flagship adds
``baseline_definition``, and a card's run its K2 column), equal regions,
tree nodes, parity, leaf counts, depths and completeness, and the
certified volume within 1e-9.  The refusals and the error exit of a card
fault run in this process at a tiny size."""

import importlib.util
import json
import os
import subprocess
import sys

import pytest
import torch

from explicit_hybrid_mpc_tpu_torch import kernels
from explicit_hybrid_mpc_tpu_torch.tools import (bench_configs, eps_ladder,
                                                 north_star,
                                                 online_crossover)
from explicit_hybrid_mpc_tpu_torch.tools.capture import ARTIFACTS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: tool -> (its JAX script's JSON variable, the knobs of both runs).
RUNS = {
    "north_star": ("NORTH_STAR_OUT", {
        "NS_PROBLEM": "double_integrator", "NS_TIME_BUDGET": "300",
        "NS_PARITY_EPS": "0.5", "NS_POINTS_CAP": "64",
        "NS_MAX_DEPTH": "12"}),
    "bench_configs": ("CONFIGS_OUT", {"CFG_ONLY": "double_integrator",
                                      "CFG_TIME_BUDGET": "300"}),
    "eps_ladder": ("LADDER_OUT", {"LADDER_PROBLEM": "double_integrator",
                                  "LADDER_EPS": "0.5,0.2",
                                  "LADDER_BUDGET": "300"}),
    "online_crossover": ("CROSS_OUT", {"CROSS_EPS": "0.5,0.2",
                                       "CROSS_BATCH": "512"}),
}
#: Keys of a JAX result that exist only for its backend probe.
PROBE_KEYS = {"backend_probe_error", "backend_probe_detail",
              "backend_probe_skipped", "backend_probe_failed",
              "backend_init_failed"}
TOOLS = {"north_star": north_star, "bench_configs": bench_configs,
         "eps_ladder": eps_ladder, "online_crossover": online_crossover}


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """{tool: (the JAX script's JSON, the port's JSON)}."""
    tmp = tmp_path_factory.mktemp("captures")
    procs = {}
    for tool, (var, knobs) in RUNS.items():
        for side in ("jax", "port"):
            out = str(tmp / f"{side}_{tool}.json")
            # One thread a process: eight processes start at once beside
            # the suite's other workers.
            env = dict(os.environ, BENCH_PLATFORM="cpu", OMP_NUM_THREADS="1",
                       NS_LOG=str(tmp / f"{side}_ns.log.jsonl"), **knobs)
            env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " --xla_cpu_"
                                "multi_thread_eigen=false").strip()
            env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
            if side == "jax":
                env[var] = out
                cmd = [sys.executable, os.path.join("scripts", f"{tool}.py")]
            else:
                cmd = [sys.executable, "-m",
                       f"explicit_hybrid_mpc_tpu_torch.tools.{tool}",
                       "--out", out, "--sentinel",
                       str(tmp / f"{tool}.sentinel")]
            err = open(tmp / f"{side}_{tool}.err", "w+")
            procs[(tool, side)] = (subprocess.Popen(
                cmd, cwd=REPO, env=env, stdout=subprocess.DEVNULL,
                stderr=err), err, out)
    results = {}
    try:
        for (tool, side), (proc, err, out) in procs.items():
            rc = proc.wait(600)
            err.seek(0)
            assert rc == 0, (tool, side, err.read()[-3000:])
            with open(out) as f:
                results.setdefault(tool, {})[side] = json.load(f)
    finally:
        for proc, err, _out in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(30)
            err.close()
    return {t: (r["jax"], r["port"]) for t, r in results.items()}


def _same_keys(jax: dict, port: dict, port_only=()) -> None:
    assert set(jax) - PROBE_KEYS == set(port) - set(port_only), \
        (set(jax) ^ set(port))


def test_north_star_is_the_jax_scripts(both):
    jax, port = both["north_star"]
    _same_keys(jax, port)
    _same_keys(jax["flagship"], port["flagship"], ("baseline_definition",))
    for k in ("problem", "eps_a", "precision", "platform", "regions",
              "truncated", "uncertified", "max_depth", "oracle_solves",
              "point_solves", "simplex_solves", "inherited_skips",
              "device_failures"):
        assert port["flagship"][k] == jax["flagship"][k], k
    assert port["flagship"]["precision"] == "mixed"
    assert port["flagship"]["regions"] == 8192
    assert port["flagship"]["vs_serial_estimate"] > 0
    assert "Oracle(backend='serial')" \
        in port["flagship"]["baseline_definition"]
    jp, pp = jax["parity"], port["parity"]
    assert set(pp) == set(jp)
    for k in ("eps_a", "batched_backend", "parity_valid", "parity_ok"):
        assert pp[k] == jp[k], k
    for side in ("batched", "serial"):
        assert set(pp[side]) == set(jp[side])
        for k in ("regions", "tree_nodes", "max_depth", "truncated"):
            assert pp[side][k] == jp[side][k], (side, k)
    assert pp["parity_ok"] is True and pp["batched"]["regions"] == 1566
    assert set(port["parity_partial"]) == set(jax["parity_partial"]) \
        == {"cpu", "serial"}


def test_bench_configs_is_the_jax_scripts(both):
    jax, port = both["bench_configs"]
    _same_keys(jax, port)
    for k in ("per_config_budget_s", "platform", "precision"):
        assert port[k] == jax[k], k
    (jr,), (pr,) = jax["rows"], port["rows"]
    assert set(pr) == set(jr)
    for k in ("label", "problem", "kwargs", "eps_a", "eps_r", "precision",
              "n_theta", "n_delta", "regions", "truncated", "frontier_left",
              "uncertified", "max_depth", "oracle_solves"):
        assert pr[k] == jr[k], k
    assert pr["regions"] == 52374 and pr["truncated"] is False
    assert abs(pr["volume_certified_frac"]
               - jr["volume_certified_frac"]) <= 1e-9


def test_eps_ladder_is_the_jax_scripts(both):
    jax, port = both["eps_ladder"]
    _same_keys(jax, port)
    for k in ("platform", "problem", "per_build_budget_s"):
        assert port[k] == jax[k], k
    assert len(port["rows"]) == len(jax["rows"]) == 2
    for jr, pr in zip(jax["rows"], port["rows"]):
        assert set(pr) == set(jr)
        for k in ("eps_a", "regions", "complete", "uncertified",
                  "max_depth", "oracle_solves"):
            assert pr[k] == jr[k], k
        assert pr["complete"] is True and pr["descent_us_per_query"] > 0
    assert [r["regions"] for r in port["rows"]] == [1566, 2528]


def test_online_crossover_is_the_jax_scripts(both):
    jax, port = both["online_crossover"]
    _same_keys(jax, port)
    assert port["batch"] == jax["batch"] == 512
    assert port["platform"] == jax["platform"] == "cpu"
    for jr, pr in zip(jax["rows"], port["rows"], strict=True):
        # Off the card there is no K2 column, as the JAX script has no
        # Pallas column off a TPU.
        assert set(pr) == set(jr)
        for k in ("eps_a", "leaves", "max_depth", "truncated"):
            assert pr[k] == jr[k], k
        assert pr["jax_us"] > 0 and pr["descent_us"] > 0
    assert [r["leaves"] for r in port["rows"]] == [1566, 2528]


def _jax_script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_configs_are_the_jax_scripts():
    assert bench_configs.CONFIGS == _jax_script("bench_configs").CONFIGS


# -- the card rules without a card --------------------------------------------

@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_refuses_without_a_card(tool, monkeypatch, tmp_path):
    monkeypatch.delenv("BENCH_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no card"):
        TOOLS[tool].main(["--out", str(tmp_path / "o.json"), "--sentinel",
                          str(tmp_path / "s")])
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_refuses_a_tpu(tool, monkeypatch, tmp_path):
    monkeypatch.setenv("BENCH_PLATFORM", "tpu")
    with pytest.raises(SystemExit, match="no TPU backend"):
        TOOLS[tool].main(["--out", str(tmp_path / "o.json"), "--sentinel",
                          str(tmp_path / "s")])
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_refuses_to_write_under_artifacts(tool, tmp_path):
    out = os.path.join(ARTIFACTS, f"{tool}_port_test.json")
    with pytest.raises(SystemExit, match="artifacts/"):
        TOOLS[tool].main(["--backend", "cpu", "--out", out, "--sentinel",
                          str(tmp_path / "s")])
    assert not os.path.exists(out)


# -- a card fault is the result's error, exit 1 -------------------------------

#: tool -> (the knobs of a tiny run, the module and function the fault is
#: raised from, the key whose presence shows the run went that far).
FAULTS = {
    "north_star": ({"NS_PROBLEM": "double_integrator", "NS_MAX_DEPTH": "4",
                    "NS_POINTS_CAP": "16"},
                   "explicit_hybrid_mpc_tpu_torch.tools.bench",
                   "measure_serial_latencies"),
    "bench_configs": ({"CFG_ONLY": "double_integrator"},
                      "explicit_hybrid_mpc_tpu_torch.tools.bench_configs",
                      "config_row"),
    "eps_ladder": ({"LADDER_PROBLEM": "double_integrator",
                    "LADDER_EPS": "1.0"},
                   "explicit_hybrid_mpc_tpu_torch.tools.eps_ladder",
                   "descent_row"),
    "online_crossover": ({"CROSS_EPS": "1.0", "CROSS_BATCH": "16"},
                         "explicit_hybrid_mpc_tpu_torch.tools."
                         "online_crossover", "columns"),
}
CARD_FAULTS = {
    "kernel": kernels.KernelError("ipm_leg: CUDA launch failed: test"),
    "cuda": RuntimeError("CUDA error: an illegal memory access was "
                         "encountered"),
}


def _run_with(tool, exc, monkeypatch, tmp_path) -> tuple[int, dict]:
    knobs, module, fn = FAULTS[tool]
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("NS_LOG", str(tmp_path / "ns.log.jsonl"))

    def boom(*a, **k):
        raise exc
    monkeypatch.setattr(importlib.import_module(module), fn, boom)
    mod = TOOLS[tool]
    if hasattr(mod, "warm_oracle"):
        monkeypatch.setattr(mod, "warm_oracle", lambda *a, **k: None)
    out = tmp_path / "o.json"
    rc = mod.main(["--backend", "cpu", "--out", str(out), "--sentinel",
                   str(tmp_path / "s")])
    with open(out) as f:
        return rc, json.load(f)



@pytest.mark.parametrize("fault", sorted(CARD_FAULTS))
@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_a_card_fault_is_the_results_error(tool, fault, monkeypatch,
                                           tmp_path):
    """Where the JAX script catches broadly (bench_configs' row,
    eps_ladder's descent, online_crossover's RuntimeError), a kernel
    error or a CUDA error is not swallowed into a row: it is the result's
    error and the exit code is 1."""
    rc, res = _run_with(tool, CARD_FAULTS[fault], monkeypatch, tmp_path)
    assert rc == 1
    assert repr(CARD_FAULTS[fault]) == res["error"]
    rows = res.get("rows") or []
    assert not any("error" in r or "descent_error" in r for r in rows)
    if tool == "north_star":
        assert res["flagship"]["regions"] > 0 and res["parity"] is None
    if tool == "eps_ladder":
        assert rows == []


@pytest.mark.parametrize("tool,exc,key", [
    ("bench_configs", ValueError("one config"), "error"),
    ("eps_ladder", ValueError("one descent"), "descent_error"),
    ("online_crossover", RuntimeError("one row"), "error")])
def test_another_error_keeps_the_jax_behaviour(tool, exc, key, monkeypatch,
                                               tmp_path):
    """Any other failure is the row's, as in the JAX script: the run goes
    on and the result has no error."""
    rc, res = _run_with(tool, exc, monkeypatch, tmp_path)
    assert "error" not in res
    (row,) = res["rows"]
    assert repr(exc) in row[key]
    assert rc == (1 if tool == "eps_ladder" and not row["complete"] else 0)
