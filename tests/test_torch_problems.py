"""Torch port: problem canonicalization, package boundary and device
policy, held against the JAX package on the same inputs."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import explicit_hybrid_mpc_tpu  # noqa: F401  (enables x64)
from explicit_hybrid_mpc_tpu.problems.registry import make as jax_make
from explicit_hybrid_mpc_tpu_torch import device as device_lib
from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
from explicit_hybrid_mpc_tpu_torch.oracle.oracle import Oracle
from explicit_hybrid_mpc_tpu_torch.problems.base import (
    CanonicalMPQP, canonical_from_arrays)
from explicit_hybrid_mpc_tpu_torch.problems.registry import make, names

# The suite runs in several worker processes at once: one torch thread
# each keeps these tests from crowding the cores the others time on.
torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = [("double_integrator", {}),
         ("double_integrator", {"N": 3, "theta_box": 1.5}),
         ("inverted_pendulum", {}),
         ("inverted_pendulum", {"N": 2}),
         ("mass_spring", {}),
         ("satellite", {}),
         ("satellite", {"axes": 1, "N": 3}),
         ("satellite_soc", {}),
         ("quadrotor", {})]

#: Every problem of the JAX package's registry.
ALL_PROBLEMS = ["double_integrator", "inverted_pendulum", "mass_spring",
                "quadrotor", "satellite", "satellite_soc"]


def _fields(can) -> dict:
    return {f.name: getattr(can, f.name)
            for f in dataclasses.fields(CanonicalMPQP)}


@pytest.mark.parametrize("name,kw", CASES)
def test_canonical_arrays_bitwise_equal(name, kw):
    ref = _fields(jax_make(name, **kw).canonical)
    got = _fields(make(name, **kw).canonical)
    assert set(ref) == set(got)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        assert got[k].shape == ref[k].shape, k
        assert got[k].tobytes() == ref[k].tobytes(), k


@pytest.mark.parametrize("name,kw", CASES[1:3])
def test_problem_boxes_and_dims_match(name, kw):
    a, b = jax_make(name, **kw), make(name, **kw)
    assert (a.n_theta, a.n_u) == (b.n_theta, b.n_u)
    np.testing.assert_array_equal(a.theta_lb, b.theta_lb)
    np.testing.assert_array_equal(a.theta_ub, b.theta_ub)


def test_canonical_from_arrays_carries_the_reference_unchanged():
    ref = jax_make("inverted_pendulum").canonical
    can = canonical_from_arrays(_fields(ref))
    assert isinstance(can, CanonicalMPQP)
    for k, v in _fields(ref).items():
        assert getattr(can, k).tobytes() == v.tobytes(), k
    with pytest.raises(KeyError):
        canonical_from_arrays({"H": ref.H})


def test_registry_lists_the_ported_problems():
    from explicit_hybrid_mpc_tpu.problems.registry import names as jax_names

    assert names() == jax_names() == ALL_PROBLEMS
    with pytest.raises(KeyError):
        make("no_such_problem")


@pytest.mark.parametrize("name", ALL_PROBLEMS)
def test_every_problem_matches_the_jax_package(name):
    """Dims, box, root splits, plant and cost agree with the JAX
    package on the same inputs (the canonical arrays above bitwise)."""
    a, b = jax_make(name), make(name)
    assert (a.n_theta, a.n_u) == (b.n_theta, b.n_u)
    np.testing.assert_array_equal(a.theta_lb, b.theta_lb)
    np.testing.assert_array_equal(a.theta_ub, b.theta_ub)
    assert getattr(a, "root_splits", None) == getattr(b, "root_splits", None)
    th = 0.3 * a.theta_lb + 0.2 * a.theta_ub
    x = b.state_of_theta(th)
    np.testing.assert_array_equal(x, a.state_of_theta(th))
    u = np.full(b.n_u, 0.1)
    np.testing.assert_array_equal(b.plant_step(x, u), a.plant_step(x, u))
    assert b.stage_cost(x, u) == a.stage_cost(x, u)


@pytest.mark.parametrize("kw", [{}, {"N": 3}])
def test_satellite_soc_cones_are_the_jax_packages(kw):
    got = make("satellite_soc", **kw).soc_cones()
    ref = jax_make("satellite_soc", **kw).soc_cones()
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.tobytes() == r.tobytes()


def test_port_imports_neither_jax_nor_the_jax_package():
    code = ("import sys\n"
            "import explicit_hybrid_mpc_tpu_torch\n"
            "import explicit_hybrid_mpc_tpu_torch.main\n"
            "import explicit_hybrid_mpc_tpu_torch.kernels\n"
            "from explicit_hybrid_mpc_tpu_torch.partition import frontier\n"
            "from explicit_hybrid_mpc_tpu_torch.online import locate, "
            "evaluator, export\n"
            "from explicit_hybrid_mpc_tpu_torch.oracle import ipm_leg\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'explicit_hybrid_mpc_tpu' "
            "or m.startswith('explicit_hybrid_mpc_tpu.'))\n"
            "print(bad)\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=_REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_port_sources_never_name_jax():
    pkg = os.path.join(_REPO, "explicit_hybrid_mpc_tpu_torch")
    for root, _dirs, files in os.walk(pkg):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            with open(os.path.join(root, fn)) as f:
                for ln in f:
                    s = ln.strip()
                    assert not s.startswith(("import jax", "from jax")), \
                        (fn, s)
                    assert not s.startswith(
                        ("import explicit_hybrid_mpc_tpu\n",
                         "from explicit_hybrid_mpc_tpu ",
                         "from explicit_hybrid_mpc_tpu.")), (fn, s)


def test_tf32_is_off_for_the_process():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_config_defaults_match_the_reference_except_backend():
    from explicit_hybrid_mpc_tpu.config import PartitionConfig as JaxCfg

    ref = {f.name: f.default for f in dataclasses.fields(JaxCfg)}
    got = {f.name: f.default for f in dataclasses.fields(PartitionConfig)}
    assert set(ref) == set(got)
    diff = {k for k in ref if ref[k] != got[k]}
    assert diff == {"backend"}
    assert got["backend"] == "cuda" and got["ipm_kernel"] == "auto"


@pytest.mark.parametrize("field,value", [
    ("recompile_guard", "raise"),
    ("recompile_guard", "warn")])
def test_unported_knobs_raise_naming_the_roadmap(field, value, monkeypatch):
    """The last unported knob (ROADMAP A6) now runs: accepted as the
    reference accepts it, the refusal table empty.  A knob put back in
    the table still raises naming its ROADMAP item."""
    from explicit_hybrid_mpc_tpu.config import PartitionConfig as JaxCfg

    from explicit_hybrid_mpc_tpu_torch import config

    assert config._UNPORTED == ()
    got = PartitionConfig(backend="cpu", **{field: value})
    assert getattr(got, field) == getattr(
        JaxCfg(backend="cpu", **{field: value}), field) == value
    monkeypatch.setattr(config, "_UNPORTED", (
        (field, lambda v: v != "off", "A6: analysis/recompile_guard.py"),))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PartitionConfig(backend="cpu", **{field: value})


@pytest.mark.parametrize("field,value", [
    ("obs_recorder", True), ("recorder_dir", "repro"),
    ("health_rules", (("stall_s", 1.0),))])
def test_diagnostics_knobs_are_accepted_as_the_reference_accepts_them(
        field, value):
    from explicit_hybrid_mpc_tpu.config import PartitionConfig as JaxCfg

    got = PartitionConfig(backend="cpu", **{field: value})
    ref = JaxCfg(backend="cpu", **{field: value})
    assert getattr(got, field) == getattr(ref, field) == value


@pytest.mark.parametrize("field,value", [
    ("shard_frontier", True), ("mesh_devices", 2), ("shard_dir", "ex"),
    ("shard_timeout_s", 30.0)])
def test_multi_gpu_knobs_are_accepted_as_the_reference_accepts_them(
        field, value):
    from explicit_hybrid_mpc_tpu.config import PartitionConfig as JaxCfg

    got = PartitionConfig(backend="cpu", **{field: value})
    ref = JaxCfg(backend="cpu", **{field: value})
    assert getattr(got, field) == getattr(ref, field) == value


@pytest.mark.parametrize("field,value", [
    ("backend", "tpu"), ("backend", "gpu"), ("ipm_kernel", "pallas"),
    ("ipm_kernel", "xla")])
def test_reference_only_choices_are_rejected(field, value):
    with pytest.raises(ValueError):
        PartitionConfig(**{field: value})


def test_cuda_backend_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-GPU path is moot")
    with pytest.raises(RuntimeError, match="CUDA"):
        device_lib.resolve("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        Oracle(make("double_integrator", N=3, theta_box=1.5))
    assert device_lib.resolve("cpu").type == "cpu"


def test_oracle_rejects_unported_backends_and_kernel_requests():
    prob = make("double_integrator", N=3, theta_box=1.5)
    # 'serial' is the host baseline now, and refuses a mesh by contract
    # (one solve at a time); a mesh must be of the backend's kind of
    # device.
    from explicit_hybrid_mpc_tpu_torch.parallel.mesh import make_mesh

    assert Oracle(prob, backend="serial").ipm_kernel == "torch"
    with pytest.raises(ValueError, match="serial"):
        Oracle(prob, backend="serial", mesh=object())
    with pytest.raises(ValueError, match="mesh's devices"):
        Oracle(prob, backend="cpu",
               mesh=make_mesh((1, 1), [torch.device("cuda", 0)]))
    assert Oracle(prob, backend="cpu", mesh=make_mesh(
        (2, 1), [torch.device("cpu")] * 2)).mesh.shape["batch"] == 2
    with pytest.raises(ValueError, match="cuda"):
        Oracle(prob, backend="cpu", ipm_kernel="cuda")
    assert Oracle(prob, backend="cpu").ipm_kernel == "torch"
