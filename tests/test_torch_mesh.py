"""Torch port: the solve mesh (parallel/mesh.py) against the JAX
package's.

The JAX package's tests/test_parallel.py on the port: MeshSolver on
meshes of CPU-device entries -- the counterpart of the JAX tests' eight
virtual CPU devices (tests/conftest.py) -- must give the JAX package's
MeshSolver results on its virtual mesh of the same shape, from the same
seeded inputs: d*, conv and feas equal, the floats within rtol = atol =
1e-9 (the JAX test's tolerance).  Delta padding, Oracle(mesh=) parity
on the double integrator, the mesh build's tree and the refusals
follow."""

import numpy as np
import pytest
import torch

import explicit_hybrid_mpc_tpu  # noqa: F401  (enables x64)
from explicit_hybrid_mpc_tpu.oracle import oracle as jomod
from explicit_hybrid_mpc_tpu.parallel import MeshSolver as JaxMeshSolver
from explicit_hybrid_mpc_tpu.parallel import make_mesh as jax_make_mesh
from explicit_hybrid_mpc_tpu.problems import base as jbase
from explicit_hybrid_mpc_tpu.problems.registry import make as jax_make
from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
from explicit_hybrid_mpc_tpu_torch.oracle import oracle as omod
from explicit_hybrid_mpc_tpu_torch.parallel import mesh as mesh_lib
from explicit_hybrid_mpc_tpu_torch.parallel.mesh import (MeshSolver,
                                                         make_mesh)
from explicit_hybrid_mpc_tpu_torch.problems import base
from explicit_hybrid_mpc_tpu_torch.problems.registry import make

torch.set_num_threads(1)

CPU = torch.device("cpu")
NAMES = ("V", "conv", "feas", "grad", "u0", "z", "Vstar", "dstar")


def _slices(mod, nd=4, nz=3, nc=5, nt=2, seed=0):
    """Random PD mp-QP family with nd commutations (no MPC semantics),
    built with `mod`'s CondensedSlice from one seeded stream."""
    r = np.random.default_rng(seed)

    def slice_(i):
        B = r.normal(size=(nz, nz))
        H = B @ B.T + nz * np.eye(nz)
        G = r.normal(size=(nc, nz))
        # b = w + S theta with w > 0 keeps z=0 feasible for small theta.
        return mod.CondensedSlice(
            H=H, f=r.normal(size=nz), F=r.normal(size=(nz, nt)),
            G=G, w=np.abs(r.normal(size=nc)) + 1.0,
            S=0.1 * r.normal(size=(nc, nt)),
            Y=np.eye(nt) * (0.5 + i), pvec=r.normal(size=nt) * 0.1,
            cconst=0.1 * i, u_map=np.eye(1, nz))

    return mod.stack_slices([slice_(i) for i in range(nd)],
                            deltas=np.arange(nd)[:, None])


def _cpu_mesh(shape):
    return make_mesh(shape, [CPU] * 8)


def _assert_close(ref, got, names=NAMES):
    for name, a, b in zip(names, ref, got):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, name
        if a.dtype == bool or np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            mask = np.isfinite(a)
            np.testing.assert_array_equal(mask, np.isfinite(b),
                                          err_msg=name)
            np.testing.assert_allclose(a[mask], b[mask], rtol=1e-9,
                                       atol=1e-9, err_msg=name)


@pytest.mark.parametrize("mesh_shape", [(8, 1), (4, 2), (2, 4)])
def test_sharded_matches_the_jax_mesh_solver(mesh_shape):
    thetas = np.random.default_rng(7).normal(size=(16, 2)) * 0.5
    jprob = jomod.to_device(_slices(jbase))
    ref = JaxMeshSolver(jprob, jax_make_mesh(mesh_shape), n_iter=30)(thetas)
    prob = omod.to_device(_slices(base), CPU)
    got = [t.numpy() for t in MeshSolver(prob, _cpu_mesh(mesh_shape),
                                         n_iter=30)(thetas)]
    _assert_close(ref, got)
    # And the port's own dense grid program.
    dense = omod._solve_points_grid(prob, torch.as_tensor(thetas), 30)[:8]
    _assert_close([t.numpy() for t in dense], got)


def test_delta_padding_mesh():
    """nd=3 on a delta-axis-2 mesh: the padded slice must not leak into
    the results (the JAX package's padding, and its results)."""
    thetas = np.random.default_rng(3).normal(size=(8, 2)) * 0.5
    jprob = jomod.to_device(_slices(jbase, nd=3))
    ref = JaxMeshSolver(jprob, jax_make_mesh((4, 2)), n_iter=30)(thetas)
    prob = omod.to_device(_slices(base, nd=3), CPU)
    padded, nd = mesh_lib._replicate_pad_deltas(prob, 2)
    assert nd == 3 and padded.H.shape[0] == 4
    assert torch.equal(padded.H[3], prob.H[0])
    got = [t.numpy() for t in MeshSolver(prob, _cpu_mesh((4, 2)),
                                         n_iter=30)(thetas)]
    _assert_close(ref, got)
    assert got[0].shape == (8, 3)  # delta padding removed


def test_pad_batch_is_the_jax_packages():
    jprob = jomod.to_device(_slices(jbase))
    prob = omod.to_device(_slices(base), CPU)
    for shape in ((8, 1), (4, 2), (2, 4)):
        j = JaxMeshSolver(jprob, jax_make_mesh(shape), n_iter=2)
        t = MeshSolver(prob, _cpu_mesh(shape), n_iter=2)
        assert [t.pad_batch(p) for p in range(1, 40)] \
            == [j.pad_batch(p) for p in range(1, 40)]


def test_oracle_mesh_backend_parity():
    """Oracle(mesh=) on the double integrator against the JAX package's
    mesh oracle and the port's plain one (decisions equal, floats to
    1e-9)."""
    problem = make("double_integrator")
    o_plain = omod.Oracle(problem, backend="cpu")
    o_mesh = omod.Oracle(problem, backend="cpu", mesh=_cpu_mesh((8, 1)))
    j_mesh = jomod.Oracle(jax_make("double_integrator"), backend="cpu",
                          mesh=jax_make_mesh((8, 1)))
    thetas = np.random.default_rng(11).uniform(-2, 2, size=(13, 2))
    a = o_plain.solve_vertices(thetas)
    b = o_mesh.solve_vertices(thetas)
    c = j_mesh.solve_vertices(thetas)
    for ref in (a, c):
        np.testing.assert_array_equal(ref.dstar, b.dstar)
        np.testing.assert_array_equal(ref.conv, b.conv)
        np.testing.assert_allclose(ref.Vstar, b.Vstar, rtol=1e-9)
        np.testing.assert_allclose(ref.u0, b.u0, rtol=1e-9, atol=1e-10)


def test_mesh_oracle_decisions_follow_the_jax_mesh_oracle():
    """Under a mesh the cohort and warm starts are forced off, as the JAX
    package does; the counters count the same solves."""
    problem = make("inverted_pendulum", N=2)
    o = omod.Oracle(problem, backend="cpu", two_phase=True,
                    warm_start=True, mesh=_cpu_mesh((2, 2)))
    j = jomod.Oracle(jax_make("inverted_pendulum", N=2), backend="cpu",
                     two_phase=True, warm_start=True,
                     mesh=jax_make_mesh((2, 2)))
    assert (o.two_phase, o.warm_start) == (j.two_phase, j.warm_start) \
        == (False, False)
    th = np.random.default_rng(5).uniform(problem.theta_lb,
                                          problem.theta_ub, (9, 2))
    a, b = o.solve_vertices(th), j.solve_vertices(th)
    np.testing.assert_array_equal(a.dstar, b.dstar)
    np.testing.assert_array_equal(a.conv, b.conv)
    np.testing.assert_allclose(a.Vstar[np.isfinite(a.Vstar)],
                               b.Vstar[np.isfinite(b.Vstar)], rtol=1e-9)
    assert o.n_point_solves == j.n_point_solves == 9 * 4


def test_mesh_build_tree_is_the_plain_build():
    """The tier-1 DI build with the vertex grid on an (8, 1) CPU mesh is
    the plain build's tree, node for node."""
    from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
        build_partition)

    prob = make("double_integrator", N=3, theta_box=1.5)
    cfg = PartitionConfig(problem="double_integrator",
                          problem_args=(("N", 3), ("theta_box", 1.5)),
                          eps_a=0.5, backend="cpu", batch_simplices=64,
                          max_depth=20)
    plain = build_partition(prob, cfg)
    meshed = build_partition(prob, cfg, oracle=omod.Oracle(
        prob, backend="cpu", mesh=_cpu_mesh((8, 1))))
    assert [v.tobytes() for v in meshed.tree.vertices] \
        == [v.tobytes() for v in plain.tree.vertices]
    leaves = plain.tree.converged_leaves()
    assert [meshed.tree.leaf_data[n].delta_idx for n in leaves] \
        == [plain.tree.leaf_data[n].delta_idx for n in leaves]


def test_make_mesh_refuses_what_it_cannot_place():
    with pytest.raises(ValueError, match="needs 8 devices, have 2"):
        make_mesh((4, 2), [CPU, CPU])
    if torch.cuda.device_count() == 0:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh((1, 1))
    m = make_mesh(None, [CPU] * 3)
    assert m.shape == {"batch": 3, "delta": 1}
    assert m.local_entries() == [(0, 0), (1, 0), (2, 0)]
    assert not m.multiprocess


def test_mesh_of_another_kind_than_the_backend_raises():
    """A cuda oracle cannot hand its grid to CPU entries (no silent move
    off the card), and the serial baseline takes no mesh."""
    problem = make("double_integrator", N=3)
    with pytest.raises(ValueError, match="mesh"):
        omod.Oracle(problem, backend="serial", mesh=_cpu_mesh((2, 1)))
    if torch.cuda.device_count() == 0:
        with pytest.raises(RuntimeError, match="CUDA"):
            omod.Oracle(problem, backend="cuda", mesh=_cpu_mesh((2, 1)))


def test_prune_rows_under_a_mesh_is_the_jax_refusal():
    """make_oracle(strict=True) refuses --prune-rows under a mesh with
    the JAX package's message; the library default builds the plain
    mesh oracle."""
    from explicit_hybrid_mpc_tpu.config import PartitionConfig as JaxCfg
    from explicit_hybrid_mpc_tpu.partition import frontier as jfrontier
    from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
        make_oracle)

    prob = make("double_integrator", N=3)
    cfg = PartitionConfig(backend="cpu", prune_rows=True)
    with pytest.raises(ValueError) as got:
        make_oracle(prob, cfg, mesh=_cpu_mesh((2, 1)), strict=True)
    with pytest.raises(ValueError) as ref:
        jfrontier.make_oracle(jax_make("double_integrator", N=3),
                              JaxCfg(backend="cpu", prune_rows=True),
                              mesh=jax_make_mesh((2, 1)), strict=True)
    assert str(got.value) == str(ref.value)
    o = make_oracle(prob, cfg, mesh=_cpu_mesh((2, 1)))
    assert type(o) is omod.Oracle and o.mesh is not None


def test_cli_mesh_is_d_entries_of_the_backends_device():
    """--mesh D: a (D, 1) mesh of the CPU device under --backend cpu (and
    serial, which the oracle then refuses); PartitionConfig.mesh_devices
    is accepted and read nowhere, as in the JAX package."""
    o = omod.Oracle(make("double_integrator", N=3), backend="cpu",
                    mesh=mesh_lib.cli_mesh(4, "cpu"))
    assert o.mesh.shape == {"batch": 4, "delta": 1}
    assert {str(d) for d in o.mesh.devices.flat} == {"cpu"}
    with pytest.raises(ValueError, match="mesh"):
        omod.Oracle(make("double_integrator", N=3), backend="serial",
                    mesh=mesh_lib.cli_mesh(2, "serial"))
    from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
        make_oracle)

    assert make_oracle(make("double_integrator", N=3), PartitionConfig(
        backend="cpu", mesh_devices=4)).mesh is None
