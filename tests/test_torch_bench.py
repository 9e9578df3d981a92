"""Torch port: tools/bench.py's default mode and its history row, held to
the JAX package's bench.py on the CPU.

Both benches run once each (module fixture, side by side) as
subprocesses at tests/test_bench.py's smoke sizes, each with its history
pointed into the test's directory; the rows must agree on the keys, the
build's figures, the online path and the large-L tree, and each history
row must be what both packages' ``summarize`` make of it.  The refusals
(no card, a TPU, a copy under artifacts/, the JAX package's history) and
the error exit of a kernel fault run in their own processes or in this
one at a tiny size."""

import hashlib
import json
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import bench_gate  # noqa: E402

sys.path.remove(os.path.join(REPO, "scripts"))

from explicit_hybrid_mpc_tpu_torch.tools import bench_history  # noqa: E402

#: tests/test_bench.py's smoke knobs.
SMOKE = dict(BENCH_PLATFORM="cpu", BENCH_PROBLEM="double_integrator",
             BENCH_EPS="0.2", BENCH_MAX_STEPS="80", BENCH_TIME_BUDGET="60",
             BENCH_DEADLINE="240", BENCH_BATCH="64", BENCH_POINTS_CAP="64",
             BENCH_LARGE_DEPTH="6", BENCH_LARGE_P="3", BENCH_SHARDS="4")
#: Keys of a JAX row that exist only for its backend probe.
PROBE_KEYS = {"backend_probe_error", "backend_probe_detail",
              "backend_probe_skipped", "backend_probe_failed",
              "backend_init_failed"}
PORT = [sys.executable, "-m", "explicit_hybrid_mpc_tpu_torch.tools.bench"]


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def summaries(row, source, mtime):
    """The history row of `row` by the port's summarize, after checking it
    against scripts/bench_gate.py's key for key.  The one difference:
    where the row's host could not measure contention, the port's
    ``contended`` is None, the JAX row's False."""
    port = bench_history.summarize(row, source, mtime)
    jax = bench_gate.summarize(row, source, mtime)
    if (row.get("host") or {}).get("contended", False) is None:
        assert port["contended"] is None and jax["contended"] is False
        jax["contended"] = None
    assert port == jax
    return port


def start(cmd, tmp, tag, env_extra):
    """A bench subprocess with its history in <tmp>/<tag>.history.jsonl;
    (process, history path)."""
    env = dict(os.environ, **env_extra, TMPDIR=str(tmp),
               BENCH_HISTORY=str(tmp / f"{tag}.history.jsonl"),
               OMP_NUM_THREADS="2")
    env.pop("BENCH_OUT", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = open(tmp / f"{tag}.out", "w+")
    err = open(tmp / f"{tag}.err", "w+")
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=out, stderr=err)
    return proc, (out, err), tmp / f"{tag}.history.jsonl"


def finish(started, timeout=420):
    """(exit code, the last JSON line, stderr, history rows)."""
    proc, (out, err), hist = started
    rc = proc.wait(timeout)
    out.seek(0)
    err.seek(0)
    lines = [ln for ln in out.read().splitlines() if ln.strip()]
    text = err.read()
    out.close()
    err.close()
    assert lines, f"no JSON line (rc {rc}); stderr tail: {text[-2000:]}"
    return rc, json.loads(lines[-1]), text, bench_history.load_history(
        str(hist))


#: The refusals: the environment, and the words the message must hold.
REFUSALS = {
    "tpu": ({"BENCH_PLATFORM": "tpu"}, "no TPU backend"),
    "card": ({}, "no card"),
    "artifacts": ({"BENCH_PLATFORM": "cpu", "BENCH_OUT": os.path.join(
        REPO, "artifacts", "bench_refused.json")}, "artifacts/"),
    "history": ({"BENCH_PLATFORM": "cpu", "BENCH_HISTORY": os.path.join(
        REPO, "BENCH_HISTORY.jsonl")}, "JAX package"),
}
#: The default mode at a tiny size, twice in one process with its
#: warm-up skipped: the large-L figure raises a kernel error, then a
#: ValueError; argv[1] is the directory of its BENCH_OUT copies.
_FAULT = r"""
import json, os, sys
from explicit_hybrid_mpc_tpu_torch import kernels
from explicit_hybrid_mpc_tpu_torch.tools import bench
bench.warm_oracle = lambda *a, **k: None
rcs = {}
for name, exc in (("kernel", kernels.KernelError("ipm_leg: CUDA launch "
                                                 "failed: test")),
                  ("other", ValueError("not a card fault"))):
    def boom(*a, exc=exc, **k):
        raise exc
    bench.large_l_metrics = boom
    os.environ["BENCH_OUT"] = os.path.join(sys.argv[1], name + ".json")
    rcs[name] = bench.main(["--sentinel", os.path.join(sys.argv[1], "s")])
print("RCS=" + json.dumps(rcs))
"""
TINY = dict(BENCH_PLATFORM="cpu", BENCH_PROBLEM="double_integrator",
            BENCH_EPS="1.0", BENCH_MAX_STEPS="400", BENCH_BATCH="16",
            BENCH_POINTS_CAP="16", BENCH_BNB_POINTS="2")


@pytest.fixture(scope="module")
def rows(tmp_path_factory):
    """The JAX bench.py and the port's tool, default mode, side by side;
    beside them the refusals and the fault runs."""
    tmp = tmp_path_factory.mktemp("bench")
    jax_hist = os.path.join(REPO, "BENCH_HISTORY.jsonl")
    before = _sha(jax_hist)
    jax = start([sys.executable, "bench.py"], tmp, "jax", SMOKE)
    port = start(PORT + ["--sentinel", str(tmp / "sentinel")], tmp, "port",
                 SMOKE)
    refused = {}
    for case, (env_extra, _words) in REFUSALS.items():
        env = dict(os.environ, BENCH_HISTORY="")
        env.update(env_extra)
        if "BENCH_PLATFORM" not in env_extra:
            env.pop("BENCH_PLATFORM", None)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        refused[case] = subprocess.Popen(
            PORT + ["--sentinel", str(tmp / f"{case}.sentinel")], cwd=REPO,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
    (tmp / "fault").mkdir()
    fault = start([sys.executable, "-c", _FAULT, str(tmp / "fault")], tmp,
                  "fault", TINY)
    out: dict = {"refused": {}}
    for case, p in refused.items():
        o, e = p.communicate(timeout=120)
        out["refused"][case] = (p.returncode, o, e)
    fault[0].wait(300)
    with open(tmp / "fault.out") as f:
        rcs = [ln for ln in f.read().splitlines() if ln.startswith("RCS=")]
    out["fault"] = (json.loads(rcs[-1][4:]) if rcs else None,
                    tmp / "fault", fault[2])
    for f in fault[1]:
        f.close()
    out.update(port=finish(port), jax=finish(jax))
    out["jax_history_unchanged"] = _sha(jax_hist) == before
    return out


def test_both_benches_produce_their_row(rows):
    for tag in ("port", "jax"):
        rc, row, err, _h = rows[tag]
        assert rc == 0, (tag, row.get("error"), err[-2000:])
        assert "error" not in row, (tag, row["error"])
        assert row["value"] > 0 and row["platform"] == "cpu"
    assert rows["port"][1]["unit"] == "regions/s"
    # The stamp by which the gate's --update tells a port result.
    assert rows["port"][1]["package"] == "explicit_hybrid_mpc_tpu_torch"
    assert "package" not in rows["jax"][1]


def test_every_jax_key_has_its_namesake_in_the_port(rows):
    port, jax = rows["port"][1], rows["jax"][1]
    assert set(jax) - PROBE_KEYS <= set(port)
    assert not set(port) & PROBE_KEYS
    for block in ("counters", "gauges", "histograms"):
        assert set(jax["metrics"][block]) <= set(port["metrics"][block]), \
            block


def test_the_build_and_the_online_figures_agree(rows):
    port, jax = rows["port"][1], rows["jax"][1]
    for key in ("regions", "uncertified", "truncated", "point_solves",
                "simplex_solves", "large_l_leaves", "large_l_shards"):
        assert port[key] == jax[key], key
    assert port["large_l_leaves"] == 6 * 2 ** 6
    assert port["online_path"] == jax["online_path"] == "descent"
    assert port["ipm_kernel_tile_us"] is None
    assert jax["ipm_kernel_tile_us"] is None
    for key in ("online_us_per_query", "large_l_flat_us_per_query",
                "large_l_sharded_us_per_query", "vs_baseline",
                "vs_baseline_bnb"):
        assert port[key] > 0, key


def test_the_baselines_name_the_host_solver(rows):
    port = rows["port"][1]
    for key in ("baseline_definition", "bnb_baseline_definition"):
        assert "Oracle(backend='serial')" in port[key], key
        assert "numpy on the host" in port[key], key
    assert "incumbent pruning" in port["bnb_baseline_definition"]
    assert port["bnb_qp_per_point"] >= 1


def test_each_bench_appends_its_row_and_the_jax_history_is_untouched(rows):
    assert rows["jax_history_unchanged"]
    for tag in ("port", "jax"):
        _rc, row, _err, hist = rows[tag]
        assert len(hist) == 1, tag
        src = hist[0]["source"]
        assert src.startswith("bench_"), src
        assert summaries(row, src, hist[0]["mtime"]) == hist[0], tag


def test_the_history_row_is_the_jax_row_format(rows):
    """summarize of the port and of scripts/bench_gate.py, key for key,
    on both rows; the tables are the JAX gate's (the port's extras add
    the card's name and power limit)."""
    assert bench_history.GATED_METRICS == bench_gate.GATED_METRICS
    assert bench_history.ROW_EXTRAS == bench_gate._ROW_EXTRAS \
        + ("device_name", "power_limit")
    for tag in ("port", "jax"):
        summaries(rows[tag][1], "x.json", 1.5)
    # A row whose host could not measure contention is not read as
    # uncontended.
    assert summaries({"value": 1.0, "host": {"contended": None}}, "y",
                     None)["contended"] is None


def test_the_history_path_is_the_ports_own(monkeypatch, tmp_path):
    monkeypatch.delenv("BENCH_HISTORY", raising=False)
    assert bench_history.history_path() == bench_history.HISTORY
    assert os.path.basename(bench_history.HISTORY) \
        == "BENCH_HISTORY_TORCH.jsonl"
    monkeypatch.setenv("BENCH_HISTORY", "")
    assert bench_history.history_path() is None
    monkeypatch.setenv("BENCH_HISTORY", str(tmp_path / "h.jsonl"))
    assert bench_history.history_path() == str(tmp_path / "h.jsonl")
    monkeypatch.setenv("BENCH_HISTORY",
                       os.path.join(REPO, "BENCH_HISTORY.jsonl"))
    with pytest.raises(ValueError, match="JAX package"):
        bench_history.history_path()
    # No gated metric and no error: nothing appended.
    path = str(tmp_path / "n.jsonl")
    assert bench_history.append_history({"metric": "m"}, "s", path) is None
    row = bench_history.append_history({"value": 2.0}, "s", path, mtime=1.0)
    assert bench_history.append_history({"value": 2.0}, "s", path,
                                        mtime=1.0) is None
    assert bench_history.load_history(path) == [row]


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_the_bench_refuses_to_start(rows, case):
    """A TPU, the card where there is none, a copy under the JAX
    package's artifacts/ and its history file: refused before any build,
    with a message and no row."""
    if case == "card" and torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rc, out, err = rows["refused"][case]
    assert rc != 0
    assert REFUSALS[case][1] in err, err[-1500:]
    assert '"platform"' not in out
    assert not os.path.exists(os.path.join(REPO, "artifacts",
                                           "bench_refused.json"))


def test_a_kernel_fault_is_the_rows_error_and_the_exit(rows):
    """A kernel error in an extra (the large-L figure here) is never
    skipped: the row keeps its value and carries the error, and the exit
    code is 1; on the CPU any other error in that extra is skipped, as in
    bench.py; on the card every error is fatal (`bench.fatal`)."""
    rcs, copies, hist_path = rows["fault"]
    assert rcs == {"kernel": 1, "other": 0}
    results = {}
    for name in rcs:
        with open(copies / f"{name}.json") as f:
            results[name] = json.load(f)
    row = results["kernel"]
    assert row["value"] is not None and row["regions"] > 0
    assert "KernelError" in row["error"]
    row = results["other"]
    assert row["value"] is not None and "error" not in row
    # Both produced their headline, so both rows are in the history.
    hist = bench_history.load_history(str(hist_path))
    assert [(r["source"], bool(r["error"])) for r in hist] \
        == [("kernel.json", True), ("other.json", False)]


def test_card_faults_are_told_from_other_errors():
    """A card fault is fatal anywhere; on the card every failure is."""
    from explicit_hybrid_mpc_tpu_torch import device, kernels
    from explicit_hybrid_mpc_tpu_torch.tools.bench import card_fault, fatal

    assert card_fault(kernels.KernelError("x"))
    assert card_fault(device.NoCpuFallback("x"))
    assert card_fault(RuntimeError("CUDA error: an illegal memory access"))
    assert not card_fault(RuntimeError("drift walk produced no generations"))
    assert not card_fault(ValueError("x"))
    assert fatal(kernels.KernelError("x"), on_card=False)
    assert fatal(ValueError("x"), on_card=True)
    assert fatal(IndexError("x"), on_card=True)
    assert not fatal(ValueError("x"), on_card=False)
