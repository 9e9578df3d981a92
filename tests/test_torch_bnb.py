"""Torch port: the serial baseline -- ``Oracle(backend="serial")`` and
``oracle/bnb.py``'s ``SerialBnB`` -- against the JAX package's.

The same seeded numpy points (the 12 of the JAX package's
tests/test_bnb.py, on ``inverted_pendulum`` with N=3) go through both
packages.  Tolerances: the root bounds are host numpy in both packages,
held to 1e-12 relative; V* to rtol 1e-6 / atol 1e-8 (the JAX test's
bar: the QPs are solved by two implementations of the same IPM), d* and
the QP count exactly.  The north star's region parity (JAX
tests/test_partition.py::test_serial_vs_batched_region_parity): the
serial and cpu oracles build the same double-integrator tree, and it
is the JAX serial build's.  The entry points: ``main --backend
serial`` reaches the serial oracle; ``serve-rebuild --backend serial``
runs one generation."""

import json

import numpy as np
import pytest
import torch

import explicit_hybrid_mpc_tpu  # noqa: F401  (enables x64)
from explicit_hybrid_mpc_tpu import obs as jobs
from explicit_hybrid_mpc_tpu.config import PartitionConfig as JaxConfig
from explicit_hybrid_mpc_tpu.oracle.bnb import SerialBnB as JaxBnB
from explicit_hybrid_mpc_tpu.oracle.oracle import Oracle as JaxOracle
from explicit_hybrid_mpc_tpu.partition.frontier import (
    build_partition as jax_build)
from explicit_hybrid_mpc_tpu.problems.registry import make as jax_make
from explicit_hybrid_mpc_tpu_torch import main as tmain
from explicit_hybrid_mpc_tpu_torch import obs
from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
from explicit_hybrid_mpc_tpu_torch.oracle import host_qp, ipm, ipm_leg
from explicit_hybrid_mpc_tpu_torch.oracle import oracle as oracle_mod
from explicit_hybrid_mpc_tpu_torch.oracle.bnb import SerialBnB
from explicit_hybrid_mpc_tpu_torch.oracle.oracle import Oracle
from explicit_hybrid_mpc_tpu_torch.partition.frontier import build_partition
from explicit_hybrid_mpc_tpu_torch.problems.registry import make

torch.set_num_threads(1)

N_POINTS = 12
#: test_serial_vs_batched_region_parity's configuration.
DI_KW = {"N": 3, "theta_box": 1.5}
DI_CFG = dict(problem="double_integrator",
              problem_args=tuple(sorted(DI_KW.items())), eps_a=0.5,
              batch_simplices=32, max_depth=20)
DI_ARGV = ["-e", "double_integrator", "--problem-arg", "N=3",
           "--problem-arg", "theta_box=1.5", "-a", "0.5", "--batch", "32",
           "--max-depth", "20"]


@pytest.fixture(scope="module")
def pendulum():
    return make("inverted_pendulum", N=3)


@pytest.fixture(scope="module")
def serial(pendulum):
    return Oracle(pendulum, backend="serial")


@pytest.fixture(scope="module")
def points(pendulum):
    rng = np.random.default_rng(77)
    return rng.uniform(pendulum.theta_lb, pendulum.theta_ub,
                       size=(N_POINTS, pendulum.n_theta))


@pytest.fixture(scope="module")
def jax_serial():
    return JaxOracle(jax_make("inverted_pendulum", N=3), backend="serial")


@pytest.fixture(scope="module")
def jax_solved(jax_serial, points):
    """The JAX package's B&B on every point: (root bounds, (V*, d*,
    n_qp)) per point."""
    bnb = JaxBnB(jax_serial)
    return [(bnb.root_bounds(th), bnb.solve_point(th)) for th in points]


@pytest.mark.parametrize("i", range(N_POINTS))
def test_root_bounds_match_the_jax_package(serial, points, jax_solved, i):
    got = SerialBnB(serial).root_bounds(points[i])
    ref = jax_solved[i][0]
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=0.0)


@pytest.mark.parametrize("i", range(N_POINTS))
def test_solve_point_matches_the_jax_package(serial, points, jax_solved, i):
    V, d, n_qp = SerialBnB(serial).solve_point(points[i])
    jV, jd, jn = jax_solved[i][1]
    assert d == jd and n_qp == jn
    if np.isfinite(jV):
        assert np.isclose(V, jV, rtol=1e-6, atol=1e-8), (V, jV)
    else:
        assert not np.isfinite(V) and d == -1


def test_requires_serial_backend(pendulum):
    with pytest.raises(ValueError, match="serial"):
        SerialBnB(Oracle(pendulum, backend="cpu"))


def test_root_bounds_are_lower_bounds(serial, points):
    bnb = SerialBnB(serial)
    sol = serial.solve_vertices(points)
    for i, th in enumerate(points):
        lbs = bnb.root_bounds(th)
        conv = sol.conv[i]
        slack = 1e-6 * np.maximum(1.0, np.abs(sol.V[i][conv]))
        assert np.all(lbs[conv] <= sol.V[i][conv] + slack), (
            f"point {i}: root bound above the converged QP optimum")


def test_bnb_matches_enumeration(serial, points, pendulum):
    bnb = SerialBnB(serial)
    sol = serial.solve_vertices(points)
    nd = pendulum.canonical.n_delta
    for i, th in enumerate(points):
        V, d, n_qp = bnb.solve_point(th)
        assert n_qp <= nd
        if np.isfinite(sol.Vstar[i]):
            assert np.isfinite(V)
            assert np.isclose(V, sol.Vstar[i], rtol=1e-6, atol=1e-8)
            # d* may differ on exact cost ties; the chosen commutation's
            # own cost must equal the optimum.
            assert np.isclose(sol.V[i][d], sol.Vstar[i],
                              rtol=1e-6, atol=1e-8)
        else:
            assert not np.isfinite(V) and d == -1


def test_pruning_happens(serial, points, pendulum):
    stats = SerialBnB(serial).measure(points)
    assert stats["points"] == N_POINTS
    assert stats["n_delta"] == pendulum.canonical.n_delta
    assert stats["qp_per_point"] <= pendulum.canonical.n_delta
    assert stats["pruned_per_point"] > 0, (
        "no commutation was ever pruned -- bound or ordering is broken")


def test_bnb_metrics_match_the_jax_package(serial, jax_serial, points):
    """With obs on, the bnb.* counters (points, nodes expanded and
    pruned) equal the JAX package's on the same points."""
    o, jo = obs.Obs("jsonl"), jobs.Obs("jsonl")
    bnb, jbnb = SerialBnB(serial, obs=o), JaxBnB(jax_serial, obs=jo)
    for th in points[:6]:
        bnb.solve_point(th)
        jbnb.solve_point(th)
    got = {k: v for k, v in o.metrics.snapshot()["counters"].items()
           if k.startswith("bnb.")}
    ref = {k: v for k, v in jo.metrics.snapshot()["counters"].items()
           if k.startswith("bnb.")}
    assert got == ref and got["bnb.points"] == 6
    assert o.metrics.snapshot()["histograms"]["bnb.point_s"]["count"] == 6


def test_serial_oracle_decisions_match_cpu_and_jax(serial, jax_serial,
                                                   pendulum, points):
    """Oracle(backend='serial') decides every point as the port's
    backend='cpu' oracle and the JAX serial oracle do."""
    sol = serial.solve_vertices(points)
    cpu = Oracle(pendulum, backend="cpu").solve_vertices(points)
    ref = jax_serial.solve_vertices(points)
    np.testing.assert_array_equal(sol.dstar, cpu.dstar)
    np.testing.assert_array_equal(sol.dstar, ref.dstar)
    np.testing.assert_array_equal(sol.conv, ref.conv)
    np.testing.assert_allclose(sol.Vstar, ref.Vstar, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(sol.Vstar, cpu.Vstar, rtol=1e-9, atol=1e-12)


def test_serial_pairs_are_one_qp_a_call(serial, pendulum, points,
                                        monkeypatch):
    """dispatch_pairs solves one pair per call of the host pair program
    and gives the batched cpu oracle's answers; nothing is padded."""
    calls = []
    real = Oracle._host_pairs

    def spy(self, th, ds, n_iter, n_f32):
        calls.append(tuple(th.shape))
        return real(self, th, ds, n_iter, n_f32)

    monkeypatch.setattr(Oracle, "_host_pairs", spy)
    ds = np.arange(N_POINTS) % pendulum.canonical.n_delta
    V, conv, grad, u0, z = serial.solve_pairs(points, ds)
    assert calls == [(1, pendulum.n_theta)] * N_POINTS
    rV, rconv, rgrad, ru0, rz = Oracle(pendulum, backend="cpu").solve_pairs(
        points, ds)
    np.testing.assert_array_equal(conv, rconv)
    np.testing.assert_allclose(V[conv], rV[conv], rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(u0[conv], ru0[conv], rtol=1e-7, atol=1e-9)


def test_serial_contract_forces_the_fixed_schedule(pendulum):
    """Two-phase and warm starts are off, the plain leg runs on the CPU
    whatever ipm_kernel asks, a mesh is refused, and the serial oracle
    is reached only by name (the default stays cuda)."""
    o = Oracle(pendulum, backend="serial", two_phase=True, warm_start=True,
               ipm_kernel="cuda")
    assert (o.two_phase, o.warm_start) == (False, False)
    assert o.device.type == "cpu" and o.ipm_kernel == "torch"
    with pytest.raises(ValueError, match="mesh"):
        Oracle(pendulum, backend="serial", mesh=object())
    assert PartitionConfig().backend == "cuda"
    assert PartitionConfig(backend="serial").backend == "serial"
    assert Oracle(pendulum, backend="cpu").cpu_twin(pendulum).backend == "cpu"


def test_serial_rescue_is_one_qp_a_call(pendulum, points, monkeypatch):
    """With rescue_iter > 0 the serial oracle re-solves its feasible but
    unconverged cells one pair per call, with the batched cpu oracle's
    results."""
    calls = []
    real = Oracle._solve_rescue

    def spy(self, th, ds):
        if self.backend == "serial":
            calls.append(tuple(ds.shape))
        return real(self, th, ds)

    monkeypatch.setattr(Oracle, "_solve_rescue", spy)
    kw = dict(n_iter=6, rescue_iter=30)
    sol = Oracle(pendulum, backend="serial", **kw).solve_vertices(points)
    ref = Oracle(pendulum, backend="cpu", two_phase=False,
                 **kw).solve_vertices(points)
    assert calls, "no cell needed a rescue at 6 iterations"
    assert set(calls) == {(1,)}
    np.testing.assert_array_equal(sol.dstar, ref.dstar)
    np.testing.assert_array_equal(sol.conv, ref.conv)


@pytest.fixture(scope="module")
def di_builds():
    """The tier-1 double integrator built by the port's serial and cpu
    oracles and by the JAX package's serial oracle."""
    out = {}
    for backend in ("serial", "cpu"):
        prob = make("double_integrator", **DI_KW)
        res = build_partition(prob, PartitionConfig(backend=backend,
                                                    **DI_CFG),
                              Oracle(prob, backend=backend))
        out[backend] = res
    jprob = jax_make("double_integrator", **DI_KW)
    out["jax_serial"] = jax_build(jprob, JaxConfig(backend="serial",
                                                   **DI_CFG),
                                  JaxOracle(jprob, backend="serial"))
    return out


def _tree_key(res):
    tree = res.tree
    leaves = tree.converged_leaves()
    return (res.stats["regions"], res.stats["tree_nodes"],
            tuple(tree.vertices[n].tobytes() for n in range(len(tree))),
            tuple(tree.leaf_data[n].delta_idx for n in leaves))


@pytest.mark.parametrize("other", ["cpu", "jax_serial"])
def test_serial_vs_batched_region_parity(di_builds, other):
    """North-star requirement: the serial baseline builds the same
    regions and tree nodes as the batched backend and as the JAX
    package's serial build -- the same tree, node for node."""
    assert _tree_key(di_builds["serial"]) == _tree_key(di_builds[other])


def test_main_backend_serial_reaches_the_serial_oracle(tmp_path,
                                                       monkeypatch):
    calls = []
    real = Oracle._host_points

    def spy(self, thetas):
        calls.append((self.backend, thetas.shape[0]))
        return real(self, thetas)

    monkeypatch.setattr(oracle_mod.Oracle, "_host_points", spy)
    prefix = str(tmp_path / "di")
    assert tmain.main([*DI_ARGV, "--backend", "serial", "-o", prefix]) == 0
    assert calls and set(calls) == {("serial", 1)}
    stats = json.load(open(prefix + ".stats.json"))
    assert not stats["truncated"] and stats["regions"] > 0


def test_serve_rebuild_backend_serial_runs_one_generation(tmp_path,
                                                          capsys,
                                                          monkeypatch):
    calls = []
    real = Oracle._host_points

    def spy(self, thetas):
        calls.append((self.backend, thetas.shape[0]))
        return real(self, thetas)

    monkeypatch.setattr(oracle_mod.Oracle, "_host_points", spy)
    rc = tmain.main(["serve-rebuild", "-e", "double_integrator",
                     "--problem-arg", "N=3", "--problem-arg",
                     "theta_box=1.5", "-a", "0.5", "--batch", "64",
                     "--backend", "serial", "--revisions", "1",
                     "--artifacts-root", str(tmp_path / "lc")])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["generations"] == 1 and summary["failures"] == 0
    assert calls and set(calls) == {("serial", 1)}


@pytest.mark.parametrize("n_f32", [0, 20])
def test_host_qp_matches_the_batched_solver(pendulum, points, n_f32):
    """The serial baseline's one-QP host solve (oracle/host_qp.py) gives
    the batched plain solver's answer on the pendulum's point QPs: the
    same masks, the objective to rtol 1e-9, z to rtol 1e-6."""
    can = pendulum.canonical
    ds = np.random.default_rng(3).integers(0, can.n_delta, N_POINTS)
    n_conv = 0
    for th, d in zip(points, ds):
        q = can.f[d] + can.F[d] @ th
        b = can.w[d] + can.S[d] @ th
        z, _lam, _s, obj, conv, feas = host_qp.qp_solve(
            can.H[d], q, can.G[d], b, n_iter=30, n_f32=n_f32)
        ref = ipm.qp_solve(*(torch.as_tensor(x[None]) for x in
                             (can.H[d], q, can.G[d], b)),
                           n_iter=30, n_f32=n_f32)
        assert conv == bool(ref.converged[0])
        assert feas == bool(ref.feasible[0])
        if conv:
            n_conv += 1
            assert np.isclose(obj, float(ref.obj[0]), rtol=1e-9, atol=1e-12)
            np.testing.assert_allclose(z, ref.z[0].numpy(), rtol=1e-6,
                                       atol=1e-8)
    assert n_conv > 0


@pytest.mark.parametrize("C", [[[4.0, 2.0], [2.0, 3.0]],
                               [[1.0, 2.0], [2.0, 1.0]]],
                         ids=["definite", "indefinite"])
def test_host_factor_is_the_plain_legs_factor(C):
    """LAPACK's factor where C is positive definite; the plain leg's
    clamped rank-1 form, bit for bit, where potrf refuses it."""
    C = np.asarray(C)
    got = host_qp._factor(C)
    ref = ipm_leg.chol_factor(torch.as_tensor(C[None]), 0.0)[0].numpy()
    np.testing.assert_allclose(np.tril(got), ref, rtol=1e-15, atol=0.0)
