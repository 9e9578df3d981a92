"""Torch port: constraint-row pruning (oracle/prune.py) against the JAX
package's PrunedOracle and against the port's plain Oracle.

The row and var masks and the reduced arrays equal the JAX package's on
the published quadrotor and satellite sub-boxes; the pruned vertex and
pair solutions equal the plain oracle's at the JAX package's
tests/test_prune.py tolerances (pruning is EXACT: verified instances
satisfy the full KKT system, violators re-solve on the full program);
and a pruned build is node for node the JAX package's pruned build.
No row of either sub-box has a sampled minimum slack within 1e-4 of the
margin, so the masks are compared exactly.
"""

import numpy as np
import pytest
import torch

import explicit_hybrid_mpc_tpu  # noqa: F401  (enables x64)
from explicit_hybrid_mpc_tpu.config import PartitionConfig as JaxCfg
from explicit_hybrid_mpc_tpu.oracle.prune import PrunedOracle as JaxPruned
from explicit_hybrid_mpc_tpu.partition.frontier import (
    build_partition as jax_build)
from explicit_hybrid_mpc_tpu.problems.registry import make as jmake
from explicit_hybrid_mpc_tpu_torch import obs as obs_lib
from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
from explicit_hybrid_mpc_tpu_torch.oracle import prune
from explicit_hybrid_mpc_tpu_torch.oracle.oracle import Oracle
from explicit_hybrid_mpc_tpu_torch.oracle.prune import PrunedOracle
from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
    build_partition, make_oracle)
from explicit_hybrid_mpc_tpu_torch.problems.registry import make

torch.set_num_threads(1)

#: The published sub-boxes (artifacts/configs_cpu_r5.json rows "5b" and
#: "4c"; chip_smoke.py OTHER_BUILDS) and their reduced (nzr, ncr).
QUAD_PV = ("quadrotor", {"pos_box": 0.4, "vel_box": 0.2})
SAT_4C = ("satellite", {"axes": 3, "omega_box": 0.03, "h_box": 0.3})
REDUCED = {"quadrotor": (60, 49), "satellite": (24, 14)}


@pytest.fixture(scope="module")
def sat():
    return make(SAT_4C[0], **SAT_4C[1])


@pytest.fixture(scope="module")
def sat_pruned(sat):
    return PrunedOracle(sat, backend="cpu")


@pytest.fixture(scope="module")
def sat_full(sat):
    return Oracle(sat, backend="cpu")


@pytest.fixture(scope="module")
def points(sat):
    rng = np.random.default_rng(3)
    return rng.uniform(sat.theta_lb, sat.theta_ub, size=(12, sat.n_theta))


def _jax_reduced(jp):
    red = jp._red_dev
    return {k: np.asarray(getattr(red, k)) for k in ("H", "f", "F", "G", "w",
                                                     "S", "u_map")}


def _assert_reduced_equal(red, var_idx, dropped, jp):
    for k, ref in _jax_reduced(jp).items():
        assert np.array_equal(getattr(red, k), ref), k
    assert np.array_equal(var_idx, jp._var_idx)
    for got, ref in zip(dropped, (jp._Gd, jp._wd, jp._Sd)):
        assert np.array_equal(got, ref)


def test_satellite_masks_and_reduced_arrays_equal_the_jax_package(
        sat_pruned):
    jp = JaxPruned(jmake(SAT_4C[0], **SAT_4C[1]), backend="cpu")
    assert np.array_equal(sat_pruned.row_keep, jp.row_keep)
    assert np.array_equal(sat_pruned.var_keep, jp.var_keep)
    red = sat_pruned._red_dev
    assert sat_pruned.reduced_shape == REDUCED["satellite"]
    for k, ref in _jax_reduced(jp).items():
        assert np.array_equal(getattr(red, k).numpy(), ref), k
    assert np.array_equal(sat_pruned._var_idx, jp._var_idx)
    for got, ref in zip((sat_pruned._Gd, sat_pruned._wd, sat_pruned._Sd),
                        (jp._Gd, jp._wd, jp._Sd)):
        assert np.array_equal(got, ref)


def test_quadrotor_masks_and_reduced_arrays_equal_the_jax_package():
    """The quadrotor's published sub-box (nz 60, nc 360): the port's
    activity_masks / droppable_vars / reduced_problem over the JAX
    package's PrunedOracle.  The port samples through its host QP solver
    (the serial oracle): the plain CPU leg materializes K x nc x nz x nz
    products at this shape (minutes on the CPU); the PrunedOracle's own
    CUDA sampling is held to the same masks on the card
    (tests/test_torch_cuda.py, chip_smoke.py phase 17)."""
    quad = make(QUAD_PV[0], **QUAD_PV[1])
    row_keep = prune.activity_masks(Oracle(quad, backend="serial"), quad)
    var_keep, row_keep = prune.droppable_vars(quad.canonical, row_keep)
    jp = JaxPruned(jmake(QUAD_PV[0], **QUAD_PV[1]), backend="cpu")
    assert np.array_equal(row_keep, jp.row_keep)
    assert np.array_equal(var_keep, jp.var_keep)
    red, var_idx, dropped = prune.reduced_problem(quad.canonical, row_keep,
                                                  var_keep)
    assert (red.nz, red.nc) == REDUCED["quadrotor"]
    _assert_reduced_equal(red, var_idx, dropped, jp)
    # Rows actually pruned, and some commutations drop slack vars.
    assert row_keep.sum(axis=1).max() < quad.canonical.nc / 2
    assert var_keep.sum(axis=1).min() < quad.canonical.nz


def test_vertex_grid_matches_full(sat_full, sat_pruned, points):
    a = sat_full.solve_vertices(points)
    b = sat_pruned.solve_vertices(points)
    np.testing.assert_array_equal(a.dstar, b.dstar)
    np.testing.assert_allclose(b.Vstar, a.Vstar, rtol=1e-6, atol=1e-8)
    m = a.conv & b.conv
    assert m.any()
    np.testing.assert_allclose(b.V[m], a.V[m], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(b.grad[m], a.grad[m], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(b.u0[m], a.u0[m], rtol=1e-5, atol=1e-7)
    assert b.z.shape == a.z.shape  # full-width primal out


def test_pairs_match_full(sat_full, sat_pruned, points, sat):
    nd = sat.canonical.n_delta
    ds = (np.arange(len(points)) % nd).astype(np.int64)
    Va, conva, grada, u0a, _za = sat_full.solve_pairs(points, ds)
    Vb, convb, gradb, u0b, zb = sat_pruned.solve_pairs(points, ds)
    m = conva & convb
    assert m.any()
    np.testing.assert_allclose(Vb[m], Va[m], rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(gradb[m], grada[m], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(u0b[m], u0a[m], rtol=1e-5, atol=1e-7)
    assert zb.shape[-1] == sat.canonical.nz


def test_simplex_min_matches_full(sat_full, sat_pruned, points, sat):
    """The pruned elastic simplex-min bound (verified, else re-solved on
    the full program) equals the plain oracle's on small simplices."""
    from explicit_hybrid_mpc_tpu_torch.partition import geometry

    rng = np.random.default_rng(5)
    span = sat.theta_ub - sat.theta_lb
    verts = points[:8, None, :] + rng.uniform(
        -0.02, 0.02, (8, sat.n_theta + 1, sat.n_theta)) * span
    Ms = geometry.barycentric_matrices(verts)
    ds = np.arange(8, dtype=np.int64) % sat.canonical.n_delta
    Va, fa = sat_full.solve_simplex_min(Ms, ds)
    Vb, fb = sat_pruned.solve_simplex_min(Ms, ds)
    np.testing.assert_array_equal(fa, fb)
    np.testing.assert_array_equal(np.isfinite(Va), np.isfinite(Vb))
    fin = np.isfinite(Va)
    np.testing.assert_allclose(Vb[fin], Va[fin], rtol=1e-6, atol=1e-6)


def test_scatter_and_dropped_violation_equal_the_jax_package(sat_pruned,
                                                             points):
    jp = JaxPruned(jmake(SAT_4C[0], **SAT_4C[1]), backend="cpu",
                   n_samples=8)
    port = PrunedOracle(make(SAT_4C[0], **SAT_4C[1]), backend="cpu",
                        n_samples=8)
    rng = np.random.default_rng(9)
    nzr = port.reduced_shape[0]
    K = len(points)
    ds = rng.integers(0, port.can.n_delta, K)
    z_red = rng.normal(size=(K, nzr))
    z = port._scatter_z(z_red, ds)
    assert np.array_equal(z, jp._scatter_z(z_red, ds))
    t = np.abs(rng.normal(size=K))
    assert np.array_equal(port._dropped_violation(points, ds, z, t),
                          jp._dropped_violation(points, ds, z, t))


def test_all_dropped_still_exact(sat, sat_full, points):
    """margin < 0 drops EVERY row: the reduced solve is unconstrained,
    verification fails everywhere, and the fallback must still produce
    the full answers (the stress case for the fallback path); the obs
    counters record the fallbacks."""
    obs = obs_lib.Obs("jsonl")
    harsh = PrunedOracle(sat, backend="cpu", margin=-1.0, n_samples=8,
                         obs=obs)
    assert harsh.row_keep.sum() == 0
    a = sat_full.solve_vertices(points[:4])
    b = harsh.solve_vertices(points[:4])
    assert harsh.n_prune_fallbacks > 0
    np.testing.assert_array_equal(a.dstar, b.dstar)
    np.testing.assert_allclose(b.Vstar, a.Vstar, rtol=1e-6, atol=1e-8)
    snap = obs.metrics.snapshot()
    assert snap["counters"]["oracle.prune_fallbacks"] \
        == harsh.n_prune_fallbacks


def test_stalled_gate_directions():
    """Stalled (~feas & ~conv) reduced cells must not be trusted as
    infeasible-on-full unchecked: the reduced phase-1 gate demands a
    re-solve for every feasible cell and certifies decisively infeasible
    ones without one (margin=1e9 keeps every row, so reduced == full)."""
    ms = make("mass_spring", N=4, theta_box=3.0)
    po = PrunedOracle(ms, backend="cpu", margin=1e9)
    rng = np.random.default_rng(7)
    inner = rng.uniform(-0.5, 0.5, size=(12, ms.n_theta))
    sgn = rng.choice([-1.0, 1.0], size=(16, ms.n_theta))
    corners = sgn * rng.uniform(2.7, 3.0, size=(16, ms.n_theta))
    full = Oracle(ms, backend="cpu")
    sol_in = full.solve_vertices(inner)
    sol_co = full.solve_vertices(corners)
    ok = (sol_in.conv & sol_in.feas)[:, 0]
    bad = (~sol_co.feas & ~sol_co.conv)[:, 0]
    assert ok.any() and bad.any(), "box must straddle feasibility"
    need = po._stalled_need_resolve(inner[ok],
                                    np.zeros(int(ok.sum()), dtype=np.int64))
    assert need.all(), "gate certified a FEASIBLE cell infeasible"
    need_i = po._stalled_need_resolve(
        corners[bad], np.zeros(int(bad.sum()), dtype=np.int64))
    assert not need_i.all(), "gate never certifies -- pruning win erased"


def test_serial_backend_rejected(sat):
    with pytest.raises(ValueError, match="batched single-device"):
        PrunedOracle(sat, backend="serial")


def test_make_oracle_routes_prune_rows():
    ms = make("mass_spring", N=4, theta_box=3.0)
    cfg = PartitionConfig(problem="mass_spring", backend="cpu",
                          prune_rows=True)
    o = make_oracle(ms, cfg)
    assert isinstance(o, PrunedOracle)
    assert (o.two_phase, o.warm_start) == (False, False)
    serial = PartitionConfig(problem="mass_spring", backend="serial",
                             prune_rows=True)
    with pytest.raises(ValueError, match="--backend serial"):
        make_oracle(ms, serial, strict=True)
    plain = make_oracle(ms, serial)
    assert type(plain) is Oracle and plain.backend == "serial"


def _structure(res):
    tree = res.tree
    leaves = tree.converged_leaves()
    return (res.stats["regions"], res.stats["tree_nodes"],
            res.stats["uncertified"], res.stats["semi_explicit"],
            tuple(tree.vertices[n].tobytes() for n in range(len(tree))),
            tuple(leaves),
            tuple(bool(tree.leaf_data[n].certified) for n in leaves))


def test_partition_parity_with_pruning():
    """The pruned build of the JAX package's test_prune fixture
    (quadrotor N=3 param p) is node for node the JAX package's pruned
    build: the same vertices, leaves and certificates, and each leaf's
    commutation the JAX package's -- except where two commutations tie
    exactly at every vertex of the leaf (the reduced QPs of two
    commutations keep different rows, so their values can round one ulp
    apart where the full problems' are equal, and the first-minimum
    tie-break then picks the other one).  Such a leaf's two commutations
    must give the plain oracle's values equal to 1e-12 at each of its
    vertices; on this fixture that is one leaf of 516 (commutations 9
    and 10, values equal to 1 ulp at 113.4)."""
    kw = dict(problem="quadrotor", eps_a=0.05, eps_r=0.5, backend="cpu",
              batch_simplices=128, max_steps=800, max_depth=12,
              prune_rows=True)
    ref = jax_build(jmake("quadrotor", N=3, param="p"), JaxCfg(**kw))
    quad = make("quadrotor", N=3, param="p")
    got = build_partition(quad, PartitionConfig(**kw))
    assert _structure(got) == _structure(ref)
    assert not got.stats["truncated"]
    assert got.stats["uncertified"] == 0
    plain = Oracle(quad, backend="cpu")
    leaves = got.tree.converged_leaves()
    differ = [n for n in leaves if got.tree.leaf_data[n].delta_idx
              != ref.tree.leaf_data[n].delta_idx]
    assert len(differ) <= 1
    for n in differ:
        d_got = got.tree.leaf_data[n].delta_idx
        d_ref = ref.tree.leaf_data[n].delta_idx
        sol = plain.solve_vertices(got.tree.vertices[n])
        assert sol.conv[:, [d_got, d_ref]].all()
        np.testing.assert_allclose(sol.V[:, d_got], sol.V[:, d_ref],
                                   rtol=1e-12, atol=0)
