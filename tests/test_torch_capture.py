"""Torch port: the capture tools' shared helpers
(explicit_hybrid_mpc_tpu_torch/tools/capture.py) against the JAX
package's bench.py helpers of the same names.

``schedule_kwargs`` gives bench.py's kwargs and overrides for every
``BENCH_*`` environment of the set below; ``default_precision`` on the
CPU is bench.py's for every registry problem; ``warm_oracle`` launches
every bucket a build can use; the sentinel helpers keep bench.py's file
protocol.  The three deliberate deviations (ROADMAP.md section C) are
pinned: ``choose_device`` refuses the card where there is none and
refuses 'tpu', ``retry_transient`` re-raises a kernel error, a
NoCpuFallback and a CUDA error at once, and ``default_precision`` on the
card is 'f64'."""

import importlib.util
import os
import time

import pytest
import torch

from explicit_hybrid_mpc_tpu.problems import registry as jax_registry
from explicit_hybrid_mpc_tpu_torch import device as device_lib
from explicit_hybrid_mpc_tpu_torch import kernels
from explicit_hybrid_mpc_tpu_torch.oracle.oracle import Oracle
from explicit_hybrid_mpc_tpu_torch.problems import registry
from explicit_hybrid_mpc_tpu_torch.tools import capture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def bench():
    """The JAX package's bench.py, loaded by importlib (importing it
    loads no JAX)."""
    spec = importlib.util.spec_from_file_location(
        "jax_bench", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_BENCH_KNOBS = ("BENCH_POINT_SCHEDULE", "BENCH_RESCUE", "BENCH_TWO_PHASE",
                "BENCH_PHASE1", "BENCH_IPM_KERNEL", "BENCH_PHASE1_POINT",
                "BENCH_PHASE1_SIMPLEX", "BENCH_WARM")


@pytest.mark.parametrize("env", [
    {},
    {"BENCH_POINT_SCHEDULE": "12,4", "BENCH_RESCUE": "30"},
    {"BENCH_RESCUE": "0", "BENCH_TWO_PHASE": "0", "BENCH_WARM": "0"},
    {"BENCH_TWO_PHASE": "1", "BENCH_WARM": "1", "BENCH_PHASE1": "0"},
    {"BENCH_PHASE1": "3", "BENCH_IPM_KERNEL": "auto"},
    {"BENCH_PHASE1_POINT": "2", "BENCH_PHASE1_SIMPLEX": "0"},
    {"BENCH_PHASE1_POINT": "0", "BENCH_PHASE1_SIMPLEX": "4",
     "BENCH_POINT_SCHEDULE": "8,4"},
    {"BENCH_PHASE1": "-1"},
], ids=lambda e: ",".join(f"{k[6:]}={v}" for k, v in e.items()) or "unset")
def test_schedule_kwargs_are_bench_pys(bench, monkeypatch, env):
    for k in _BENCH_KNOBS:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    res_port, res_jax = {}, {}
    assert capture.schedule_kwargs(res_port) == bench.schedule_kwargs(res_jax)
    assert res_port == res_jax
    assert capture.schedule_kwargs() == bench.schedule_kwargs()


def test_schedule_kwargs_reach_the_oracle(monkeypatch):
    """Every kwarg is one the port's Oracle takes."""
    monkeypatch.setenv("BENCH_POINT_SCHEDULE", "12,4")
    monkeypatch.setenv("BENCH_RESCUE", "30")
    monkeypatch.setenv("BENCH_PHASE1_POINT", "2")
    o = Oracle(registry.make("double_integrator"), backend="cpu",
               **capture.schedule_kwargs())
    assert (o.point_n_f32, o.point_n_iter) == (12, 4)
    assert o.rescue_iter == 30 and o.two_phase and o.warm_start
    assert o.point_p1 == 2


@pytest.mark.parametrize("name", jax_registry.names())
def test_default_precision_on_the_cpu_is_bench_pys(bench, name):
    jp, tp = jax_registry.make(name), registry.make(name)
    assert capture.default_precision(False, tp) \
        == bench.default_precision(False, jp)
    assert capture.default_precision(False) == bench.default_precision(False)
    # On the card the port's default, not the TPU's "mixed".
    assert capture.default_precision(True, tp) == "f64"
    assert bench.default_precision(True, jp) == "mixed"


def test_registry_names_are_the_jax_packages():
    assert registry.names() == jax_registry.names()


def test_choose_device(monkeypatch):
    monkeypatch.delenv("BENCH_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no card"):
        capture.choose_device(hold_capture_sentinel=False)
    for name in ("cuda", "gpu"):
        with pytest.raises(SystemExit, match="no card"):
            capture.choose_device(backend=name,
                                  hold_capture_sentinel=False)
        monkeypatch.setenv("BENCH_PLATFORM", name)
        with pytest.raises(SystemExit, match="no card"):
            capture.choose_device(hold_capture_sentinel=False)
    monkeypatch.setenv("BENCH_PLATFORM", "tpu")
    with pytest.raises(SystemExit, match="no TPU backend"):
        capture.choose_device(hold_capture_sentinel=False)
    res: dict = {}
    # --backend wins over BENCH_PLATFORM.
    assert capture.choose_device(res, backend="cpu",
                                 hold_capture_sentinel=False).type == "cpu"
    assert res == {"platform": "cpu"}
    monkeypatch.setenv("BENCH_PLATFORM", "cpu")
    assert capture.choose_device(hold_capture_sentinel=False).type == "cpu"


def test_choose_device_holds_the_sentinel_until_exit(tmp_path, monkeypatch):
    held = []
    monkeypatch.setattr(capture.atexit, "register", held.append)
    sent = str(tmp_path / "s" / ".capture_active")
    capture.choose_device(backend="cpu", sentinel=sent)
    assert os.path.exists(sent) and capture.sentinel_active(sent)
    held[0]()
    assert not os.path.exists(sent)
    capture.choose_device(backend="cpu", hold_capture_sentinel=False,
                          sentinel=sent)
    assert not os.path.exists(sent) and len(held) == 1


@pytest.mark.parametrize("exc", [
    kernels.KernelError("ipm_leg: CUDA launch failed: invalid argument"),
    device_lib.NoCpuFallback("the card failed"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB"),
], ids=["KernelError", "NoCpuFallback", "cuda_error", "cuda_oom"])
def test_retry_transient_never_retries_a_dead_card(exc):
    calls = []

    def fn():
        calls.append(1)
        raise exc
    with pytest.raises(type(exc)):
        capture.retry_transient(fn, wait_s=0.0, what="test")
    assert len(calls) == 1


def test_retry_transient_retries_what_bench_py_retries(bench):
    for helper in (capture.retry_transient, bench.retry_transient):
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise OSError("connection reset")
            return 7
        assert helper(flaky, wait_s=0.0) == 7 and len(calls) == 3
        calls.clear()

        def always():
            calls.append(1)
            raise RuntimeError("remote_compile: read body")
        with pytest.raises(RuntimeError):
            helper(always, attempts=2, wait_s=0.0)
        assert len(calls) == 2
        calls.clear()

        def typo():
            calls.append(1)
            raise ValueError("bad shape")
        with pytest.raises(ValueError):
            helper(typo, wait_s=0.0)
        assert len(calls) == 1


def test_sentinel_protocol_is_bench_pys(bench, tmp_path, monkeypatch):
    """Both helpers: create and own a missing sentinel and remove it at
    stop(); leave one another process holds; an orphan (mtime 700 s old)
    is inactive."""
    jax_sent = str(tmp_path / "jax" / ".capture_active")
    port_sent = str(tmp_path / "port" / ".capture_active")
    monkeypatch.setattr(bench, "SENTINEL", jax_sent)
    for path, hold in ((jax_sent, bench.hold_sentinel),
                       (port_sent, lambda: capture.hold_sentinel(port_sent))):
        stop = hold()
        assert os.path.exists(path)
        assert capture.sentinel_active(path)
        stop()
        assert not os.path.exists(path)
        open(path, "w").close()  # another holder's
        stop = hold()
        stop()
        assert os.path.exists(path)
        old = time.time() - 700
        os.utime(path, (old, old))
        assert not capture.sentinel_active(path)
        os.unlink(path)
        assert not capture.sentinel_active(path)


def test_out_path(tmp_path, monkeypatch, capsys):
    monkeypatch.delenv("PREC_OUT", raising=False)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(capture.tempfile, "tempdir", None)
    p = capture.out_path(None, "PREC_OUT", "precision.json", "tool")
    assert os.path.basename(p) == "precision.json"
    assert os.path.dirname(os.path.dirname(p)) == str(tmp_path)
    assert f"tool: writing to {os.path.dirname(p)}" in capsys.readouterr().err
    monkeypatch.setenv("PREC_OUT", str(tmp_path / "a" / "x.json"))
    assert capture.out_path(None, "PREC_OUT", "p.json", "tool") \
        == str(tmp_path / "a" / "x.json")
    assert os.path.isdir(tmp_path / "a")
    assert capture.out_path(str(tmp_path / "b.json"), "PREC_OUT", "p.json",
                            "tool") == str(tmp_path / "b.json")
    for bad in (os.path.join(capture.ARTIFACTS, "precision_cpu.json"),
                os.path.join(capture.ARTIFACTS, "new", "x.json")):
        with pytest.raises(SystemExit, match="artifacts"):
            capture.out_path(bad, "PREC_OUT", "p.json", "tool")
    assert not os.path.exists(os.path.join(capture.ARTIFACTS, "new"))


def test_warm_oracle_launches_every_bucket():
    """After warm_oracle a build's oracle launches no new shape: its
    ledger holds every bucket chip_smoke.warm_buckets launches."""
    import chip_smoke

    problem = registry.make("inverted_pendulum", N=2)
    kw = dict(backend="cpu", precision="mixed", points_cap=64,
              two_phase=True, warm_start=True)
    a, b = Oracle(problem, **kw), Oracle(problem, **kw)
    for o in (a, b):
        o.max_pairs_per_call = o.max_simplex_rows_per_call = 64
    capture.warm_oracle(a, problem)
    assert frozenset(a.compiled_shapes) == chip_smoke.warm_buckets(b,
                                                                   problem)
    assert a.n_point_solves > 0  # bench.py's warmup counts its solves


def test_warm_oracle_stops_at_its_deadline(capsys):
    o = Oracle(registry.make("double_integrator"), backend="cpu",
               points_cap=64)
    capture.warm_oracle(o, registry.make("double_integrator"),
                        stop_after=time.time() - 1)
    assert o.compiled_shapes == set()
    assert "warmup stopped early at bucket 8" in capsys.readouterr().err


def test_the_tools_import_no_bench_and_no_jax():
    """tests/test_torch_imports.py walks the package in a fresh
    interpreter; here the five modules' own imports are read."""
    import ast

    for name in ("capture", "precision_check", "tune_schedule",
                 "onset_probe", "long_build"):
        path = os.path.join(REPO, "explicit_hybrid_mpc_tpu_torch", "tools",
                            f"{name}.py")
        tree = ast.parse(open(path).read())
        mods = {n.module for n in ast.walk(tree)
                if isinstance(n, ast.ImportFrom)} | {
            a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names}
        assert not any(m.split(".")[0] in ("jax", "bench", "scripts",
                                           "explicit_hybrid_mpc_tpu")
                       for m in mods if m), (name, mods)
