"""Torch port: the closed loop (sim/simulator.py), Oracle.solve_fixed and
the ``--simulate`` / ``--artifacts-out`` CLI steps, held against the
JAX package on the same inputs, on the CPU.

Setup: the JAX package's tests/test_sim.py double integrator (N=3,
theta_box=1.5, eps_a=0.05, batch_simplices=64), built by each package.
Tolerances: states 1e-5 and inputs 1e-6 for the closed loops (the JAX
test's own for its pallas-vs-jax loop: float32 point location in both,
f64 interpolation, differences compound over the steps);
``solve_fixed`` converged flags equal and u0 / V to 1e-9 where
converged (the same f64 IPM on the same QPs, summed in another
order)."""

import json

import numpy as np
import pytest
import torch

import explicit_hybrid_mpc_tpu  # noqa: F401  (enables x64)
from explicit_hybrid_mpc_tpu.config import PartitionConfig as JaxConfig
from explicit_hybrid_mpc_tpu.online import export as jexport
from explicit_hybrid_mpc_tpu.oracle.oracle import Oracle as JaxOracle
from explicit_hybrid_mpc_tpu.partition.frontier import (
    build_partition as jax_build)
from explicit_hybrid_mpc_tpu.problems.registry import make as jax_make
from explicit_hybrid_mpc_tpu.sim import simulator as jsim
from explicit_hybrid_mpc_tpu_torch import main as tmain
from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
from explicit_hybrid_mpc_tpu_torch.online import descent, export
from explicit_hybrid_mpc_tpu_torch.oracle.oracle import Oracle
from explicit_hybrid_mpc_tpu_torch.partition.frontier import build_partition
from explicit_hybrid_mpc_tpu_torch.problems.registry import make
from explicit_hybrid_mpc_tpu_torch.sim import simulator

torch.set_num_threads(1)

CPU = torch.device("cpu")
DI = dict(N=3, theta_box=1.5)


def _table(jtable):
    """The JAX package's leaf table as the port's (same arrays)."""
    return export.LeafTable(*(np.asarray(a) for a in jtable))


@pytest.fixture(scope="module")
def di():
    jprob = jax_make("double_integrator", **DI)
    jorc = JaxOracle(jprob, backend="cpu")
    jres = jax_build(jprob, JaxConfig(
        problem="double_integrator", eps_a=0.05, backend="cpu",
        batch_simplices=64), oracle=jorc)
    prob = make("double_integrator", **DI)
    orc = Oracle(prob, backend="cpu")
    res = build_partition(prob, PartitionConfig(
        problem="double_integrator", eps_a=0.05, backend="cpu",
        batch_simplices=64), oracle=orc)
    return dict(jprob=jprob, jorc=jorc, jtable=jexport.export_leaves(
        jres.tree), prob=prob, orc=orc, res=res,
        table=export.export_leaves(res.tree))


def test_the_port_builds_the_jax_table(di):
    """The slice's input: both packages' DI builds export the same leaf
    table, so the closed loops below compare like with like."""
    a, b = di["table"], di["jtable"]
    assert a.n_leaves == b.n_leaves
    for k in ("node_id", "delta"):
        assert np.array_equal(getattr(a, k), np.asarray(getattr(b, k)))
    for k in ("bary_M", "U", "V"):
        np.testing.assert_allclose(getattr(a, k), np.asarray(getattr(b, k)),
                                   rtol=0, atol=1e-9)


@pytest.mark.parametrize("backend,jbackend", [("torch", "jax"),
                                              ("kernel", "pallas")])
def test_explicit_closed_loop_matches_the_jax_package(di, backend,
                                                      jbackend):
    """'torch' against the JAX package's 'jax', 'kernel' (K2's plain
    version on the CPU) against its 'pallas' (interpret mode)."""
    theta0 = np.array([0.9, -0.4])
    ref = jsim.simulate(di["jprob"], jsim.ExplicitController(
        di["jtable"], backend=jbackend), theta0, T=15)
    got = simulator.simulate(di["prob"], simulator.ExplicitController(
        _table(di["jtable"]), backend=backend, device=CPU), theta0, T=15)
    np.testing.assert_allclose(got.inputs, ref.inputs, atol=1e-6)
    np.testing.assert_allclose(got.states, ref.states, atol=1e-5)
    assert np.array_equal(got.inside, ref.inside)
    np.testing.assert_allclose(got.cost_pred, ref.cost_pred, atol=1e-6)
    assert got.eval_s.shape == (15,) and np.all(got.eval_s > 0)


def test_descent_backend_and_the_port_table_regulate(di):
    """The port's own table through the descent backend: the same loop
    as the 'torch' backend, and it regulates to the origin."""
    table = di["table"]
    dt = descent.export_descent(di["res"].tree, di["res"].roots, table,
                                stage=False)
    theta0 = np.array([1.0, -0.5])
    a = simulator.simulate(di["prob"], simulator.ExplicitController(
        table, backend="descent", device=CPU, descent_table=dt),
        theta0, T=40)
    b = simulator.simulate(di["prob"], simulator.ExplicitController(
        table, backend="torch", device=CPU), theta0, T=40)
    np.testing.assert_allclose(a.inputs, b.inputs, atol=1e-9)
    assert np.all(a.inside)
    assert np.linalg.norm(a.states[-1]) < 1e-2
    assert np.all(np.abs(a.inputs) <= di["prob"].u_max + 1e-8)


def test_implicit_controller_matches_the_jax_package(di):
    """ImplicitController over each package's oracle, and the JAX
    package's counter bookkeeping (the warm solve is not counted)."""
    theta0 = np.array([-1.2, 0.8])
    n0 = di["orc"].n_solves, di["orc"].n_point_solves
    ctrl = simulator.ImplicitController(di["orc"], device=CPU)
    assert (di["orc"].n_solves, di["orc"].n_point_solves) == n0
    got = simulator.simulate(di["prob"], ctrl, theta0, T=12)
    ref = jsim.simulate(di["jprob"], jsim.ImplicitController(di["jorc"]),
                        theta0, T=12)
    np.testing.assert_allclose(got.inputs, ref.inputs, atol=1e-6)
    np.testing.assert_allclose(got.states, ref.states, atol=1e-5)
    assert np.array_equal(got.inside, ref.inside)
    np.testing.assert_allclose(got.cost_pred, ref.cost_pred, rtol=1e-6)
    assert di["orc"].n_solves - n0[0] == 12 * di["prob"].canonical.n_delta


def test_compare_matches_the_jax_package(di):
    theta0 = np.array([-1.2, 0.8])
    got = simulator.compare(di["prob"], _table(di["jtable"]), di["orc"],
                            theta0, T=10, backend="torch", device=CPU)
    ref = jsim.compare(di["jprob"], di["jtable"], di["jorc"], theta0, T=10)
    for g, r in ((got.explicit, ref.explicit), (got.implicit, ref.implicit)):
        np.testing.assert_allclose(g.states, r.states, atol=1e-5)
        np.testing.assert_allclose(g.inputs, r.inputs, atol=1e-6)
    assert abs(got.cost_ratio - ref.cost_ratio) < 1e-5
    assert got.cost_ratio < 1.05 and np.all(got.explicit.inside)


def test_solve_fixed_matches_the_jax_package():
    """The semi-explicit online QP on the same (theta, delta) pairs of
    the 32-commutation pendulum."""
    rng = np.random.default_rng(3)
    jprob, prob = jax_make("inverted_pendulum", N=3), \
        make("inverted_pendulum", N=3)
    th = rng.uniform(prob.theta_lb, prob.theta_ub, (24, prob.n_theta))
    ds = rng.integers(0, prob.canonical.n_delta, 24)
    ju0, jV, jconv, _jz = JaxOracle(jprob, backend="cpu").solve_fixed(th, ds)
    orc = Oracle(prob, backend="cpu")
    u0, V, conv, z = orc.solve_fixed(th, ds)
    assert np.array_equal(conv, np.asarray(jconv))
    assert conv.any() and (~conv).any()
    np.testing.assert_allclose(u0[conv], np.asarray(ju0)[conv], atol=1e-9)
    np.testing.assert_allclose(V[conv], np.asarray(jV)[conv], atol=1e-9)
    assert np.all(np.isinf(V[~conv]))
    assert z.shape == (24, prob.canonical.nz)
    assert orc.n_point_solves == 24
    empty = orc.solve_fixed(np.zeros((0, prob.n_theta)),
                            np.zeros(0, dtype=np.int64))
    assert [a.shape[0] for a in empty] == [0, 0, 0, 0]


def test_semi_explicit_pendulum_matches_the_jax_package():
    """A feasibility-only pendulum partition (built once, by the JAX
    package) deployed semi-explicitly by each package: locate fixes the
    leaf's delta, solve_fixed supplies u; same closed loop."""
    jprob = jax_make("inverted_pendulum", N=3)
    jorc = JaxOracle(jprob, backend="cpu")
    jres = jax_build(jprob, JaxConfig(
        problem="inverted_pendulum", algorithm="feasible", backend="cpu",
        batch_simplices=64, max_steps=400), oracle=jorc)
    jtable = jexport.export_leaves(jres.tree)
    theta0 = np.array([0.3, 0.5])
    ref = jsim.simulate(jprob, jsim.SemiExplicitController(jtable, jorc),
                        theta0, T=30)
    prob = make("inverted_pendulum", N=3)
    orc = Oracle(prob, backend="cpu")
    n0 = orc.n_solves, orc.n_point_solves
    ctrl = simulator.SemiExplicitController(_table(jtable), orc,
                                            backend="torch", device=CPU)
    assert (orc.n_solves, orc.n_point_solves) == n0
    got = simulator.simulate(prob, ctrl, theta0, T=30)
    np.testing.assert_allclose(got.inputs, ref.inputs, atol=1e-6)
    np.testing.assert_allclose(got.states, ref.states, atol=1e-5)
    assert np.array_equal(got.inside, ref.inside) and np.all(got.inside)
    assert np.linalg.norm(got.states[-1]) < 0.05
    # A hybrid mask with no semi-explicit leaf returns the interpolated
    # law without an online QP.
    none = np.zeros(jtable.n_leaves, dtype=bool)
    hyb = simulator.SemiExplicitController(_table(jtable), orc,
                                           backend="torch", device=CPU,
                                           semi_mask=none)
    n1 = orc.n_solves
    u, info = hyb(theta0)
    assert orc.n_solves == n1 and info.inside


def test_controllers_default_to_the_gpu(di):
    with pytest.raises(RuntimeError, match="CUDA"):
        simulator.ExplicitController(di["table"])
    with pytest.raises(RuntimeError, match="CUDA"):
        simulator.ImplicitController(di["orc"])
    with pytest.raises(ValueError, match="backend"):
        simulator.ExplicitController(di["table"], backend="pallas",
                                     device=CPU)
    with pytest.raises(ValueError, match="descent_table"):
        simulator.ExplicitController(di["table"], backend="descent",
                                     device=CPU)


def test_cli_simulate_writes_the_jax_sim_json(tmp_path, capsys):
    """``--simulate T`` (and ``--artifacts-out``): PREFIX.sim.json has
    the JAX package's keys, trajectories included, and the artifact
    directory loads in the serve path."""
    from explicit_hybrid_mpc_tpu.main import main as jmain

    args = ["-e", "double_integrator", "--problem-arg", "N=3",
            "--problem-arg", "theta_box=1.5", "-a", "0.5", "--batch", "64",
            "--max-depth", "20", "--backend", "cpu", "--simulate", "8"]
    jmain(args + ["-o", str(tmp_path / "jax" / "di")])
    tmain.main(args + ["-o", str(tmp_path / "port" / "di"),
                       "--artifacts-out", str(tmp_path / "art")])
    capsys.readouterr()
    ref = json.load(open(tmp_path / "jax" / "di.sim.json"))
    got = json.load(open(tmp_path / "port" / "di.sim.json"))
    assert set(got) == set(ref)
    assert set(got["trajectories"]) == set(ref["trajectories"])
    for k in ("explicit", "implicit"):
        assert set(got["trajectories"][k]) == set(ref["trajectories"][k])
        np.testing.assert_allclose(got["trajectories"][k]["states"],
                                   ref["trajectories"][k]["states"],
                                   atol=1e-5)
    assert got["theta0"] == ref["theta0"]
    np.testing.assert_allclose(got["cost_ratio"], ref["cost_ratio"],
                               rtol=1e-5)
    assert (tmp_path / "art" / "descent.npz").exists()
