"""Torch port: the Oracle's three query classes against the JAX
package's Oracle on the double integrator and the inverted pendulum,
same seeded inputs, both at the build's default knobs (two-phase
cohorts and warm-start donors on).

Decision masks (converged, feasible, the +inf / -inf / finite encoding
of simplex bounds, Farkas certificates, argmin commutations) must match
bitwise; values to 1e-8 relative (the two solvers sum in different
orders)."""

import numpy as np
import pytest
import torch

import explicit_hybrid_mpc_tpu  # noqa: F401  (enables x64)
import jax.numpy as jnp
from explicit_hybrid_mpc_tpu.oracle import oracle as joracle
from explicit_hybrid_mpc_tpu.partition import geometry as jgeometry
from explicit_hybrid_mpc_tpu.problems.registry import make as jax_make
from explicit_hybrid_mpc_tpu_torch.oracle import oracle as toracle
from explicit_hybrid_mpc_tpu_torch.problems.registry import make

# The suite runs in several worker processes at once: one torch thread
# each keeps these tests from crowding the cores the others time on.
torch.set_num_threads(1)

PROBLEMS = {"di": ("double_integrator", {"N": 3, "theta_box": 1.5}),
            "pendulum": ("inverted_pendulum", {})}
KNOBS = dict(two_phase=True, warm_start=True)


@pytest.fixture(scope="module", params=sorted(PROBLEMS))
def pair(request):
    name, kw = PROBLEMS[request.param]
    jp, tp = jax_make(name, **kw), make(name, **kw)
    return (jp, joracle.Oracle(jp, backend="cpu", **KNOBS),
            toracle.Oracle(tp, backend="cpu", **KNOBS))


def _simplices(prob, rng, K, scale=0.1):
    lb, ub = prob.theta_lb, prob.theta_ub
    c = rng.uniform(lb, ub, (K, prob.n_theta))
    off = rng.uniform(-1, 1, (K, prob.n_theta + 1, prob.n_theta)) \
        * scale * (ub - lb)
    return jgeometry.barycentric_matrices(c[:, None, :] + off)


def _close(a, b, mask):
    np.testing.assert_allclose(a[mask], b[mask], rtol=1e-8, atol=1e-8)


def _encoding(v):
    return np.where(np.isposinf(v), 1, np.where(np.isneginf(v), -1, 0))


def test_solve_vertices_matches_the_reference(pair):
    prob, jo, to = pair
    rng = np.random.default_rng(0)
    th = rng.uniform(prob.theta_lb, prob.theta_ub, (24, prob.n_theta))
    a, b = jo.solve_vertices(th), to.solve_vertices(th)
    for f in ("conv", "feas", "dstar"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert a.conv.any()
    _close(a.V, b.V, a.conv)
    _close(a.Vstar, b.Vstar, np.isfinite(a.Vstar))
    for f in ("grad", "u0", "z", "lam", "s"):
        _close(getattr(a, f), getattr(b, f), a.conv)
    assert (jo.n_point_solves, jo.n_iters_f64, jo.n_tp_survivors) == \
        (to.n_point_solves, to.n_iters_f64, to.n_tp_survivors)


def test_solve_pairs_with_warm_donors_matches_the_reference(pair):
    prob, jo, to = pair
    rng = np.random.default_rng(1)
    K = 40
    th = rng.uniform(prob.theta_lb, prob.theta_ub, (K, prob.n_theta))
    ds = rng.integers(0, prob.canonical.n_delta, K)
    donor = jo.solve_vertices(th + 1e-3)
    warm = (donor.z[np.arange(K), ds], donor.s[np.arange(K), ds],
            donor.lam[np.arange(K), ds], np.arange(K) % 3 != 0)
    ra = jo.solve_pairs_full(th, ds, warm=warm)
    rb = to.solve_pairs_full(th, ds, warm=warm)
    assert np.array_equal(ra[1], rb[1])
    assert np.array_equal(np.isfinite(ra[0]), np.isfinite(rb[0]))
    for x, y in zip(ra[:5], rb[:5]):
        _close(np.asarray(x), np.asarray(y), ra[1])
    assert (jo.n_warm_attempts, jo.n_warm_accepts) == \
        (to.n_warm_attempts, to.n_warm_accepts)


def test_simplex_min_and_farkas_match_the_reference(pair):
    prob, jo, to = pair
    rng = np.random.default_rng(2)
    K = 20
    Ms = _simplices(prob, rng, K)
    ds = rng.integers(0, prob.canonical.n_delta, K)
    va, fa = jo.solve_simplex_min(Ms, ds)
    vb, fb = to.solve_simplex_min(Ms, ds)
    assert np.array_equal(_encoding(va), _encoding(vb))
    assert np.array_equal(fa, fb)
    _close(va, vb, np.isfinite(va))
    ta, fsa, ia = jo.simplex_feasibility(Ms, ds)
    tb, fsb, ib = to.simplex_feasibility(Ms, ds)
    assert np.array_equal(fsa, fsb) and np.array_equal(ia, ib)
    np.testing.assert_allclose(tb, ta, rtol=1e-8, atol=1e-10)
    assert jo.n_simplex_solves == to.n_simplex_solves


def test_point_feasibility_matches_the_reference(pair):
    prob, jo, to = pair
    rng = np.random.default_rng(3)
    th = rng.uniform(prob.theta_lb, prob.theta_ub, (10, prob.n_theta))
    ds = rng.integers(0, prob.canonical.n_delta, 10)
    np.testing.assert_allclose(to.feasibility(th, ds),
                               jo.feasibility(th, ds), rtol=1e-7, atol=1e-9)


def test_argmin_ties_take_the_first_commutation():
    V = np.array([[1.0, 1.0, 2.0], [3.0, 0.5, 0.5], [2.0, 2.0, 2.0],
                  [4.0, 1.0, 1.0]])
    conv = np.array([[True, True, True], [True, True, True],
                     [False, True, True], [True, False, True]])
    vj, dj = joracle.reduce_deltas(jnp.asarray(V), jnp.asarray(conv))
    vt, dt = toracle.reduce_deltas(torch.as_tensor(V), torch.as_tensor(conv))
    assert dt.tolist() == [0, 1, 1, 2] == np.asarray(dj).tolist()
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


def test_bucket_and_schedule_arithmetic_match(pair):
    _prob, jo, to = pair
    for attr in ("max_points_per_call", "max_pairs_per_call",
                 "max_simplex_rows_per_call", "n_iter", "n_f32",
                 "point_p1", "point_p2", "simplex_p1", "simplex_p2",
                 "stage2_phase1_first", "_point_full_out"):
        assert getattr(jo, attr) == getattr(to, attr), attr
    for K in (1, 7, 8, 9, 300, 5000):
        assert jo.simplex_bucket(K) == to.simplex_bucket(K)


def test_cpu_twin_mirrors_the_solver_semantics(pair):
    _prob, _jo, to = pair
    twin = to.cpu_twin(to.problem)
    assert twin.device.type == "cpu" and twin.ipm_kernel == "torch"
    for attr in ("n_iter", "n_f32", "two_phase", "warm_start",
                 "point_p1", "simplex_p1", "rescue_iter"):
        assert getattr(twin, attr) == getattr(to, attr), attr


def test_mixed_precision_oracle_matches_the_reference():
    name, kw = PROBLEMS["pendulum"]
    jp, tp = jax_make(name, **kw), make(name, **kw)
    jo = joracle.Oracle(jp, backend="cpu", precision="mixed",
                        ipm_kernel="pallas", **KNOBS)
    to = toracle.Oracle(tp, backend="cpu", precision="mixed", **KNOBS)
    th = np.random.default_rng(4).uniform(jp.theta_lb, jp.theta_ub,
                                          (6, jp.n_theta))
    a, b = jo.solve_vertices(th), to.solve_vertices(th)
    assert (to.n_f32, to.n_iter) == (jo.n_f32, jo.n_iter)
    assert np.array_equal(a.conv, b.conv) and np.array_equal(a.dstar,
                                                             b.dstar)
    _close(a.V, b.V, a.conv)


@pytest.mark.parametrize("route", ["cuda", "torch"])
def test_the_kernel_tile_histogram_follows_the_route(route):
    """oracle.ipm_kernel_tile_s (the JAX package's per-tile figure, read
    by the bench's ipm_kernel_tile_us): one observation a batch, its
    blocking wall over the batch's QPs -- K1's blocks, one a QP -- when
    the route is the kernel, nothing on the plain route.  The kernel's route is stubbed on
    the CPU: the legs follow the tensors' device, so the plain leg runs
    under either name."""
    from explicit_hybrid_mpc_tpu_torch import obs as obs_lib

    name, kw = PROBLEMS["di"]
    prob = make(name, **kw)
    obs = obs_lib.Obs("jsonl")
    to = toracle.Oracle(prob, backend="cpu", obs=obs, **KNOBS)
    to.ipm_kernel = route
    batches = []
    real = to._obs_batch

    def counted(cls, n, wall, *a, **k):
        if n > 0:
            batches.append((cls, n, wall))
        return real(cls, n, wall, *a, **k)

    to._obs_batch = counted
    rng = np.random.default_rng(5)
    to.solve_vertices(rng.uniform(prob.theta_lb, prob.theta_ub,
                                  (24, prob.n_theta)))
    to.solve_simplex_min(_simplices(prob, rng, 12),
                         np.zeros(12, dtype=np.int64))
    assert {c for c, _n, _w in batches} >= {"point", "simplex"}
    hists = obs.metrics.snapshot()["histograms"]
    if route == "torch":
        assert "oracle.ipm_kernel_tile_s" not in hists
        return
    tile = hists["oracle.ipm_kernel_tile_s"]
    assert tile["count"] == len(batches)
    assert tile["sum"] == pytest.approx(sum(w / n for _c, n, w in batches),
                                        rel=1e-12)
    point = hists["oracle.point_solve_s"]
    (p_n, p_wall), = [(n, w) for c, n, w in batches if c == "point"]
    assert point["sum"] == pytest.approx(p_wall, rel=1e-12)
    assert p_n == 24 * prob.canonical.n_delta
