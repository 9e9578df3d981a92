"""Torch port: tools/serve_bench.py's legacy sweep and its history row,
held to the JAX package's scripts/serve_bench.py on the CPU, and the
tool's rules for the card, checked without one.

Both tools run once (module fixture, side by side, as subprocesses) at
tests/test_serve.py's serve_bench sizes, each with its result and its
history pointed into the test's directory.  The port's run is held to
every assertion of the JAX package's test_serve_bench_sweep_with_hot_swap
(the gate of scripts/bench_gate.py aside: it is not ported yet), the
rows must share every key and the configuration, and each history row
must be what both packages' ``summarize`` make of its result.  The
helpers the rows are made of are compared on the same inputs in this
process.  No test compares a timing across packages or asserts an
overhead figure: those are latency A/B figures."""

import hashlib
import json
import os
import subprocess
import sys
import threading
import types

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import bench_gate  # noqa: E402
import serve_bench as jax_sb  # noqa: E402

sys.path.remove(os.path.join(REPO, "scripts"))

from explicit_hybrid_mpc_tpu_torch import kernels  # noqa: E402
from explicit_hybrid_mpc_tpu_torch.tools import bench_history  # noqa: E402
from explicit_hybrid_mpc_tpu_torch.tools import serve_bench  # noqa: E402

#: tests/test_serve.py's serve_bench sizes.
SMALL = {"SERVE_BENCH_SECS": "0.5", "SERVE_BENCH_DEPTH": "5",
         "SERVE_BENCH_RATES": "800,6000", "SERVE_BENCH_MAX_BATCH": "32"}
JAX_CMD = [sys.executable, os.path.join("scripts", "serve_bench.py")]
PORT_CMD = [sys.executable, "-m",
            "explicit_hybrid_mpc_tpu_torch.tools.serve_bench",
            "--backend", "cpu"]
JAX_HISTORY = os.path.join(REPO, "BENCH_HISTORY.jsonl")


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
    """A serve bench subprocess with its result in <tmp>/<tag>.json and
    its history in <tmp>/<tag>.history.jsonl."""
    env = dict(os.environ, **env_extra, TMPDIR=str(tmp),
               SERVE_BENCH_OUT=str(tmp / f"{tag}.json"),
               BENCH_HISTORY=str(tmp / f"{tag}.history.jsonl"),
               OMP_NUM_THREADS="2")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    err = open(tmp / f"{tag}.err", "w+")
    proc = subprocess.Popen(cmd, cwd=REPO, env=env,
                            stdout=subprocess.DEVNULL, stderr=err)
    return proc, err, tmp, tag


def finish(started, timeout=300):
    """(exit code, the result, the history rows, the result's mtime)."""
    proc, err, tmp, tag = started
    rc = proc.wait(timeout)
    err.seek(0)
    text = err.read()
    err.close()
    out = tmp / f"{tag}.json"
    assert out.exists(), f"no result (rc {rc}); stderr: {text[-2000:]}"
    with open(out) as f:
        result = json.load(f)
    return rc, result, bench_gate.load_history(
        str(tmp / f"{tag}.history.jsonl")), os.path.getmtime(out)


def sweeps(tmp, extra, tags=("jax", "port")):
    """Both tools side by side with the knobs SMALL + `extra`: {tag: (rc,
    result, history rows, mtime)}; the JAX package's history untouched."""
    before = _sha(JAX_HISTORY)
    cmds = {"jax": JAX_CMD, "port": PORT_CMD}
    procs = {t: start(cmds[t], tmp, t, dict(SMALL, **extra)) for t in tags}
    out = {t: finish(p) for t, p in procs.items()}
    assert _sha(JAX_HISTORY) == before
    return out


def hold_the_jax_tests_assertions(result, hist):
    """tests/test_serve.py::test_serve_bench_sweep_with_hot_swap's
    assertions on a result and its history (the gate aside)."""
    assert result["serve_p99_us"] is not None
    assert result["serve_batch_fill"] >= 0.5
    assert result["swap_dropped"] == 0
    assert result["swap_torn"] == 0
    assert result["swap_drained"] is True
    assert result["versions_seen"] == ["v1", "v2"]
    assert all(r["p99_us"] is not None for r in result["rates"])
    assert len(hist) == 1
    row = hist[0]
    assert row["serve_p99_us"] == result["serve_p99_us"]
    assert row["fallback_frac"] == result["fallback_frac"]
    assert row["value"] is None
    assert row["swap_dropped"] == 0


@pytest.fixture(scope="module")
def legacy(tmp_path_factory):
    return sweeps(tmp_path_factory.mktemp("serve_bench"), {})


@pytest.mark.parametrize("tag", ["port", "jax"])
def test_the_sweep_holds_the_jax_tests_assertions(legacy, tag):
    _rc, result, hist, _mtime = legacy[tag]
    hold_the_jax_tests_assertions(result, hist)


def test_every_jax_key_is_in_the_ports_row(legacy):
    jax, port = legacy["jax"][1], legacy["port"][1]
    assert set(jax) <= set(port), set(jax) - set(port)
    assert port["config"] == jax["config"]
    for pr, jr in zip(port["rates"], jax["rates"]):
        assert set(pr) == set(jr)
        assert pr["offered_qps"] == jr["offered_qps"]
    assert port["platform"] == jax["platform"] == "cpu"
    assert "device_name" not in port and "power_limit" not in port
    assert port["package"] == "explicit_hybrid_mpc_tpu_torch"
    # The metric line names the same sweep (a contended host says so).
    assert port["metric"].split(" [")[0] == jax["metric"].split(" [")[0]


def test_the_history_row_is_what_both_summarize_make(legacy):
    for tag in ("port", "jax"):
        _rc, result, hist, mtime = legacy[tag]
        src = f"{tag}.json"
        assert hist == [summaries(result, src, mtime)], tag


def test_the_ports_exit_is_its_bars(legacy):
    rc, result, _hist, _mtime = legacy["port"]
    assert rc == (1 if serve_bench.bars(result) else 0)


@pytest.mark.parametrize("skew", [0.0, 1.5, 3.0])
@pytest.mark.parametrize("box", [(np.zeros(2), np.ones(2)),
                                 (np.array([-1.5, -0.3, 0.0]),
                                  np.array([1.5, 0.3, 2.0]))])
def test_the_skew_sampler_draws_bitwise_equal(skew, box):
    lb, ub = box
    a = serve_bench._skew_sampler(skew, lb, ub)
    b = jax_sb._skew_sampler(skew, lb, ub)
    if skew <= 0:
        assert a is None and b is None
        return
    for seed in (1000, 1007):
        ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
        da = np.stack([a(ra) for _ in range(64)])
        db = np.stack([b(rb) for _ in range(64)])
        assert da.tobytes() == db.tobytes()


def _hist(counts, bounds=(10.0, 100.0, 1000.0), total=None):
    counts = list(counts)
    n = sum(counts)
    return {"bounds": list(bounds), "counts": counts, "count": n,
            "sum": float(total if total is not None else 37.0 * n),
            "min": 1.0 if n else None, "max": 999.0 if n else None}


def test_the_percentile_and_histogram_helpers_are_equal():
    rng = np.random.default_rng(3)
    lat = list(rng.exponential(2e-3, 977))
    for q in (50, 90, 99, 99.9):
        assert serve_bench._percentile_us(lat, q) == \
            jax_sb._percentile_us(lat, q)
    after, before = _hist([5, 9, 4, 1]), _hist([2, 3, 1, 0])
    for b in (before, None):
        assert serve_bench._hist_delta(after, b) == jax_sb._hist_delta(
            after, b)
    ph0 = {"queue": _hist([1, 2, 0, 0], total=40.0),
           "wall": _hist([0, 3, 0, 0], total=150.0)}
    ph1 = {"queue": _hist([4, 6, 1, 0], total=410.0),
           "launch": _hist([0, 5, 2, 0], total=900.0),
           "reply": _hist([3, 1, 0, 0], total=20.0),
           "wall": _hist([0, 8, 3, 0], total=1490.0)}
    assert serve_bench._phase_rate_row(ph0, ph1) == \
        jax_sb._phase_rate_row(ph0, ph1)
    assert serve_bench._phase_rate_row({}, {}) == \
        jax_sb._phase_rate_row({}, {})


class _Slo:
    total_tick_s = 0.0123

    def __init__(self, ev):
        self._ev = ev

    def evaluate(self):
        return self._ev


@pytest.mark.parametrize("ev,n_req,p99", [
    ({"a": {"compliance": 0.9991234567, "budget_remaining_frac": 0.25,
            "burn_fast": 1.23456},
      "b": {"compliance": 0.95, "budget_remaining_frac": -3.5,
            "burn_fast": 40.0}}, 5000, 1234.5),
    ({}, 100, None), ({}, 0, 800.0)])
def test_the_slo_row_is_equal(ev, n_req, p99):
    assert serve_bench._slo_row(_Slo(ev), n_req, p99) == \
        jax_sb._slo_row(_Slo(ev), n_req, p99)
    assert serve_bench._slo_row(None, n_req, p99) == \
        jax_sb._slo_row(None, n_req, p99) == {}


class _Metrics:
    def __init__(self, snap):
        self._snap = snap

    def snapshot(self):
        return self._snap


def test_the_trace_row_is_equal():
    """_trace_row of both packages on one stub hub, stream, recorder and
    per-rate rows (the quantiles come from each package's own
    obs.metrics.quantile)."""
    hists = {f"serve.ctl.t{k}.phase.{ph}_us": _hist(c, total=t)
             for k in range(2) for ph, c, t in (
                 ("queue", [3, 5, 1, 0], 700.0),
                 ("launch", [0, 6, 2, 1], 2500.0),
                 ("reply", [8, 1, 0, 0], 60.0),
                 ("wall", [0, 4, 4, 1], 3260.0))}
    o = types.SimpleNamespace(enabled=True, metrics=_Metrics({
        "histograms": hists,
        "gauges": {"serve.ctl.t0.queue_frac": 0.21,
                   "serve.ctl.t1.queue_frac": 0.34, "other.gauge": 9.0}}))
    ex = [{"controller": "t0", "wall_us": 980.123456, "rows": 1},
          {"controller": "t1", "wall_us": 700.0, "rows": 2}]
    tr = types.SimpleNamespace(exemplars=lambda: ex)
    gcrec = types.SimpleNamespace(pauses=[120.0, 80.0],
                                  total_pause_s=lambda: 2e-4)
    top = {ph: _hist(c, total=t) for ph, c, t in (
        ("queue", [3, 5, 1, 0], 700.0), ("wall", [0, 4, 4, 1], 3260.0),
        ("seal", [0, 0, 0, 0], 0.0))}
    per_rate = [{"phase_sum_err_frac": 0.001}, {},
                {"phase_sum_err_frac": 0.0004}]
    for args in ((tr, o, top, 2.5, gcrec, False, per_rate),
                 (tr, o, None, 2.5, gcrec, True, per_rate),
                 (None, o, top, 0.0, None, False, per_rate)):
        assert serve_bench._trace_row(*args) == jax_sb._trace_row(*args)


def test_a_card_is_refused_without_one_and_nothing_is_written(
        tmp_path, monkeypatch):
    """--backend cuda (and the default) without a card: refused as
    capture.choose_device refuses it, and no result or history row is
    written; a TPU is refused too."""
    monkeypatch.setenv("BENCH_HISTORY", str(tmp_path / "h.jsonl"))
    monkeypatch.delenv("BENCH_PLATFORM", raising=False)
    out = tmp_path / "r.json"
    for argv, env, words in ((["--backend", "cuda"], {}, "no card"),
                             ([], {}, "no card"),
                             ([], {"BENCH_PLATFORM": "tpu"},
                              "no TPU backend")):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        with pytest.raises(SystemExit, match=words):
            serve_bench.main(argv + ["--out", str(out)])
        assert not out.exists() and not (tmp_path / "h.jsonl").exists()


@pytest.mark.parametrize("env,words", [
    ({"SERVE_BENCH_OUT": os.path.join(REPO, "artifacts",
                                      "serve_bench_refused.json")},
     "artifacts/"),
    ({"BENCH_HISTORY": JAX_HISTORY}, "JAX package"),
])
def test_the_jax_packages_files_are_refused(tmp_path, monkeypatch, env,
                                            words):
    monkeypatch.setenv("BENCH_HISTORY", str(tmp_path / "h.jsonl"))
    monkeypatch.setenv("SERVE_BENCH_OUT", str(tmp_path / "r.json"))
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    before = _sha(JAX_HISTORY)
    with pytest.raises(SystemExit, match=words):
        serve_bench.main(["--backend", "cpu"])
    assert not os.path.exists(os.path.join(REPO, "artifacts",
                                           "serve_bench_refused.json"))
    assert not (tmp_path / "r.json").exists()
    assert _sha(JAX_HISTORY) == before


def _stub_arena(monkeypatch, exc):
    """serve.DeviceArena whose evaluate raises `exc` on the scheduler's
    worker thread (the warm-up and the audit evaluate as usual)."""
    from explicit_hybrid_mpc_tpu_torch import serve

    class Stub(serve.DeviceArena):
        def evaluate(self, *a, **kw):
            if threading.current_thread().name == "serve-arena":
                raise exc
            return super().evaluate(*a, **kw)

    monkeypatch.setattr(serve, "DeviceArena", Stub)


@pytest.fixture
def tiny_arena(tmp_path, monkeypatch):
    for k, v in dict(SMALL, SERVE_BENCH_TENANTS="2", SERVE_BENCH_SECS="0.2",
                     SERVE_BENCH_DEMAND="off",
                     SERVE_BENCH_MAX_BATCH="8").items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("BENCH_HISTORY", str(tmp_path / "h.jsonl"))
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    return tmp_path


def test_a_kernel_fault_is_the_results_error_not_a_drop(tiny_arena,
                                                        monkeypatch,
                                                        capsys):
    """A client's KernelError stops the sweep: the result's error, exit
    1, no swap_dropped count, no history row."""
    _stub_arena(monkeypatch, kernels.KernelError(
        "arena_eval: CUDA launch failed: test"))
    out = tiny_arena / "r.json"
    assert serve_bench.main(["--backend", "cpu", "--out", str(out)]) == 1
    with open(out) as f:
        result = json.load(f)
    assert "KernelError" in result["error"]
    assert "swap_dropped" not in result
    assert serve_bench.bars(result) == [f"error {result['error']}"]
    assert not (tiny_arena / "h.jsonl").exists()
    assert "KernelError" in capsys.readouterr().out


def test_any_other_client_error_is_counted_as_dropped(tiny_arena,
                                                      monkeypatch):
    """Any other exception of a client is counted, as the JAX script
    counts it, and the bars then fail."""
    _stub_arena(monkeypatch, ValueError("not a card fault"))
    out = tiny_arena / "r.json"
    assert serve_bench.main(["--backend", "cpu", "--out", str(out)]) == 1
    with open(out) as f:
        result = json.load(f)
    assert "error" not in result
    assert result["swap_dropped"] > 0
    assert "ValueError('not a card fault')" in result["errors"]
    assert any("dropped" in b for b in serve_bench.bars(result))


@pytest.mark.parametrize("exc,fault", [
    (kernels.KernelError("x"), True),
    (RuntimeError("CUDA error: an illegal memory access"), True),
    (RuntimeError("x"), False), (ValueError("x"), False)])
def test_card_faults_are_told_from_other_errors(exc, fault):
    from explicit_hybrid_mpc_tpu_torch import device

    assert serve_bench.card_fault(exc) is fault
    assert serve_bench.card_fault(device.NoCpuFallback("x"))
