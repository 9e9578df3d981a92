"""Torch port: whole partition builds against the JAX package.

The tier-1 double-integrator build (the JAX package's own cross-tier
parity configuration) and a small inverted-pendulum build (hybrid: 8
commutations, stage-2 simplex bounds, Farkas exclusions, two-phase
cohorts and warm-start donors all exercised) must produce node-for-node
identical trees: vertex matrices bitwise, leaf commutations and
certification statuses, region/node counts.  Trees are compared by
this signature, not by unpickling (a pickle names its package's
classes)."""

import json
import os
import stat

import numpy as np
import pytest
import torch

import explicit_hybrid_mpc_tpu  # noqa: F401  (enables x64)
from explicit_hybrid_mpc_tpu.config import PartitionConfig as JaxConfig
from explicit_hybrid_mpc_tpu.partition.frontier import (
    build_partition as jax_build)
from explicit_hybrid_mpc_tpu.problems.registry import make as jax_make
from explicit_hybrid_mpc_tpu_torch import device as device_lib
from explicit_hybrid_mpc_tpu_torch import kernels
from explicit_hybrid_mpc_tpu_torch import main as tmain
from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
from explicit_hybrid_mpc_tpu_torch.oracle import ipm_leg
from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
    FrontierEngine, build_partition, make_oracle)
from explicit_hybrid_mpc_tpu_torch.partition.tree import Tree
from explicit_hybrid_mpc_tpu_torch.problems.registry import make

# The suite runs in several worker processes at once: one torch thread
# each keeps these tests from crowding the cores the others time on.
torch.set_num_threads(1)

BUILDS = {
    "di_tier1": ("double_integrator", {"N": 3, "theta_box": 1.5},
                 dict(eps_a=0.5, batch_simplices=64, max_depth=20)),
    "pendulum_small": ("inverted_pendulum", {"N": 2},
                       dict(eps_a=0.5, batch_simplices=64, max_depth=14)),
    # Sub-boxes of the other problems at reduced horizons, each a few to
    # 25 s on one thread (their published configurations run on the
    # card: chip_smoke.py phase 14).  The quadrotor's QPs (nz 24-27,
    # nc 144-147) take the CUDA kernel's large path on a card.
    "mass_spring": ("mass_spring", {"N": 4, "theta_box": 0.5},
                    dict(eps_a=1.0, eps_r=0.1)),
    "satellite": ("satellite", {"axes": 3, "N": 2, "omega_box": 0.03,
                                "h_box": 0.3},
                  dict(eps_a=1.0, eps_r=0.1)),
    "quadrotor": ("quadrotor", {"param": "p", "N": 4, "pos_box": 0.3},
                  dict(eps_a=0.1, eps_r=0.01)),
}


def _tree_signature(res):
    """Node-for-node structural identity (the JAX package's
    tests/test_pallas_ipm.py contract)."""
    tree = res.tree
    leaves = tree.converged_leaves()
    return (res.stats["regions"], res.stats["tree_nodes"],
            res.stats["uncertified"], res.stats["semi_explicit"],
            tuple(tree.vertices[n].tobytes() for n in range(len(tree))),
            tuple(tree.leaf_data[n].delta_idx for n in leaves),
            tuple(bool(tree.leaf_data[n].certified) for n in leaves))


@pytest.fixture(scope="module")
def port_builds():
    out = {}
    for key, (name, kw, cfg) in BUILDS.items():
        out[key] = build_partition(
            make(name, **kw),
            PartitionConfig(problem=name, backend="cpu",
                            problem_args=tuple(sorted(kw.items())), **cfg))
    return out


@pytest.mark.parametrize("key", sorted(BUILDS))
def test_build_tree_identical_to_the_reference(key, port_builds):
    name, kw, cfg = BUILDS[key]
    ref = jax_build(jax_make(name, **kw),
                    JaxConfig(problem=name, backend="cpu",
                              problem_args=tuple(sorted(kw.items())), **cfg))
    got = port_builds[key]
    assert got.stats["regions"] > 100
    assert not got.stats["truncated"]
    assert _tree_signature(got) == _tree_signature(ref)
    for k in ("uncertified", "steps", "simplex_solves", "max_depth"):
        assert got.stats[k] == ref.stats[k], k


def test_pendulum_build_exercises_the_hybrid_paths(port_builds):
    st = port_builds["pendulum_small"].stats
    assert st["simplex_solves"] > 0 and st["masked_point_skips"] > 0
    assert st["device_failures"] == 0 and not st["device_degraded"]
    assert st["quarantined_cells"] == 0 and st["uncertified"] == 0


def test_tree_save_load_and_provenance(port_builds, tmp_path):
    res = port_builds["di_tier1"]
    path = str(tmp_path / "di.tree.pkl")
    res.tree.save(path)
    back = Tree.load(path)
    assert len(back) == len(res.tree)
    for n in range(len(back)):
        assert np.array_equal(back.vertices[n], res.tree.vertices[n])
    prov = res.tree.provenance
    assert prov["solver"]["backend"] == "cpu"
    assert prov["solver"]["ipm_kernel"] == "auto"


def test_cli_builds_and_evaluates_on_cpu(tmp_path):
    prefix = str(tmp_path / "di")
    rc = tmain.main(["-e", "double_integrator", "--problem-arg", "N=3",
                     "--problem-arg", "theta_box=1.5", "-a", "0.5",
                     "--batch", "64", "--max-depth", "20", "--backend",
                     "cpu", "-o", prefix, "--evaluate", "512"])
    assert rc == 0
    with open(prefix + ".stats.json") as f:
        stats = json.load(f)
    assert stats["regions"] > 100 and stats["uncertified"] == 0
    assert os.path.exists(prefix + ".tree.pkl")
    summary = tmain.evaluate_sampled(
        make("double_integrator", N=3, theta_box=1.5),
        Tree.load(prefix + ".tree.pkl"), 256, __import__("torch").device(
            "cpu"))
    assert summary["u_finite"] and summary["inside_frac"] == 1.0


@pytest.mark.parametrize("argv", [
    ["-e", "double_integrator", "--recompile-guard", "warn"]])
def test_cli_unported_surfaces_exit(argv, monkeypatch):
    """The last unported flag (ROADMAP A6) now parses into the config
    and the refusal table is empty; a flag put back in the table still
    exits "not yet ported" before the build parser runs."""
    assert tmain._UNPORTED_FLAGS == {}
    args = tmain.build_parser().parse_args(argv)
    assert tmain.config_from_args(args).recompile_guard == argv[-1]
    monkeypatch.setattr(tmain, "_UNPORTED_FLAGS", {
        argv[2]: "A6 (analysis/recompile_guard.py)"})
    with pytest.raises(SystemExit, match="not yet ported"):
        tmain.main(argv)


@pytest.mark.parametrize("flags", [
    ["--obs", "jsonl", "--health-rule", "stall_s=300"],
    ["--obs", "jsonl", "--obs-per-process"],
    ["--recorder-dir=bundles"]])
def test_cli_diagnostics_surfaces_build(flags, tmp_path):
    """The diagnostics flags build the tier-1 DI tree on the CPU: the
    watchdog's rules validated, the obs stream suffixed per process,
    the bundle directory named (here nothing diverges, so it stays
    empty) -- and the tree is the plain build's."""
    prefix = str(tmp_path / "di")
    argv = ["-e", "double_integrator", "--problem-arg", "N=3",
            "--problem-arg", "theta_box=1.5", "-a", "0.5", "--batch", "64",
            "--backend", "cpu", "-o", prefix]
    assert tmain.main([*argv, *flags]) == 0
    got = Tree.load(prefix + ".tree.pkl")
    assert tmain.main([*argv[:-1], prefix + "_plain"]) == 0
    ref = Tree.load(prefix + "_plain.tree.pkl")
    assert [v.tobytes() for v in got.vertices] \
        == [v.tobytes() for v in ref.vertices]
    if "--obs-per-process" in flags:
        assert not os.path.exists(prefix + ".obs.jsonl")
        (p,) = [f for f in os.listdir(tmp_path) if ".obs.p0-" in f]
        assert p == os.path.basename(prefix) + f".obs.p0-{os.getpid()}.jsonl"
    elif "--obs" in flags:
        assert os.path.exists(prefix + ".obs.jsonl")


# -- a kernel that cannot run stops the build ---------------------------------

def _di_cfg(**kw):
    return PartitionConfig(problem="double_integrator", backend="cpu",
                           problem_args=(("N", 3), ("theta_box", 1.5)),
                           eps_a=0.5, batch_simplices=64, max_depth=4, **kw)


def test_kernel_launch_failure_ends_the_build(monkeypatch):
    """A refused launch raises KernelError, which is no RuntimeError:
    the frontier's device-failure recovery does not catch it, so the
    build neither retries on the CPU twin nor quarantines cells."""
    assert not issubclass(kernels.KernelError, RuntimeError)
    calls = []

    def refused(*args, **kw):
        calls.append(1)
        raise kernels.KernelError("ipm_leg: CUDA launch failed: injected")

    monkeypatch.setattr(ipm_leg, "ipm_leg", refused)
    with pytest.raises(kernels.KernelError, match="injected"):
        build_partition(make("double_integrator", N=3, theta_box=1.5),
                        _di_cfg())
    assert len(calls) == 1


def test_kernel_build_failure_raises_kernel_error(monkeypatch, tmp_path):
    """nvcc failing (here a stand-in that exits 1) raises KernelError
    with the compiler's output; nothing is loaded."""
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\necho 'error: injected' >&2\nexit 1\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", str(fake.parent))
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(kernels, "_libs", {})
    with pytest.raises(kernels.KernelError, match="injected"):
        kernels.library("ipm_leg")
    assert kernels._libs == {}


def test_device_failure_on_cuda_raises_instead_of_cpu_fallback():
    """A CPU build recovers a failed batch on its CPU twin; a build on a
    CUDA device raises NoCpuFallback (chained to the failure) before any
    twin is made."""
    problem = make("double_integrator", N=3, theta_box=1.5)
    cfg = _di_cfg()
    eng = FrontierEngine(problem, make_oracle(problem, cfg), cfg)
    thetas = np.zeros((1, problem.n_theta))
    vertices = eng._recover("vertices", (thetas,), RuntimeError("x"))
    assert eng._fb_oracle is not None and len(vertices) > 0
    eng._fb_oracle = None
    eng.oracle.device = torch.device("cuda", 0)
    lost = RuntimeError("CUDA error: an illegal memory access")
    with pytest.raises(device_lib.NoCpuFallback) as e:
        eng._recover("vertices", (thetas,), lost)
    assert e.value.__cause__ is lost and eng._fb_oracle is None
    assert not issubclass(device_lib.NoCpuFallback, RuntimeError)
