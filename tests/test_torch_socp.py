"""Torch port: the SOC-constrained QP solver (oracle/socp.py) against the
JAX package's socp_solve on the families of its tests/test_socp.py.

Same numpy-seeded instances through both packages, float64: the
converged and feasible masks are equal, and on converged rows the
objective agrees to 1e-9.  The primal agrees to 1e-9 on every row but
at most one of a family: on the active-cone family one instance's NT
iteration converges at about 10 iterations and then wanders (the JAX
package notes that extra iterations make such stalls worse; at 50
iterations the two packages' iterates are 2.5e-4 apart), and both land
on verified KKT points through the tangent-cone rescue, 4.4e-7 apart --
that row is held to the JAX SOC tests' tolerance (rtol 1e-5, atol 1e-7).
"""

import numpy as np
import pytest
import torch

import explicit_hybrid_mpc_tpu  # noqa: F401  (enables x64)
import jax.numpy as jnp
from jax import vmap

from explicit_hybrid_mpc_tpu.oracle.socp import socp_solve as jax_socp
from explicit_hybrid_mpc_tpu_torch.oracle import socp
from explicit_hybrid_mpc_tpu_torch.oracle.socp import socp_solve

torch.set_num_threads(1)


def _rand_qp(rng, nz=6, nl=8):
    B = rng.normal(size=(nz, nz))
    Q = B @ B.T + nz * np.eye(nz)
    q = rng.normal(size=nz)
    Al = rng.normal(size=(nl, nz))
    bl = np.abs(rng.normal(size=nl)) + 0.5
    return Q, q, Al, bl


def _qp_limit():
    rng = np.random.default_rng(0)
    return [(*_rand_qp(rng), np.zeros((0, 3, 6)), np.zeros((0, 3)))
            for _ in range(5)], 40


def _dim2_cones():
    rng = np.random.default_rng(1)
    out = []
    for _ in range(5):
        qp = _rand_qp(rng)
        Ac = rng.normal(size=(2, 2, 6)) * 0.7
        bc = np.stack([np.abs(rng.normal(size=2)) + 2.0,
                       rng.normal(size=2) * 0.3], axis=1)
        out.append((*qp, Ac, bc))
    return out, 40


def _active_cone():
    rng = np.random.default_rng(2)
    out = []
    for _ in range(8):
        qp = _rand_qp(rng)
        Ac = rng.normal(size=(3, 3, 6)) * 0.8
        bc = np.stack([np.abs(rng.normal(size=3)) * 0.5 + 0.2,
                       rng.normal(size=3) * 0.2,
                       rng.normal(size=3) * 0.2], axis=1)
        out.append((*qp, Ac, bc))
    return out, 60


def _infeasible():
    rng = np.random.default_rng(3)
    Q, q, Al, bl = _rand_qp(rng)
    # The cone needs e'z <= -1 AND a linear row e'z >= 1.
    Ac = np.zeros((1, 3, 6))
    Ac[0, 0, 0] = 1.0
    bc = np.array([[-1.0, 0.0, 0.0]])
    return [(Q, q, np.concatenate([Al, -np.eye(6)[:1]]),
             np.concatenate([bl, [-1.0]]), Ac, bc)], 40


def _batched():
    rng = np.random.default_rng(4)
    out = []
    for _ in range(8):
        qp = _rand_qp(rng)
        Ac = rng.normal(size=(2, 3, 6)) * 0.5
        bc = np.stack([np.abs(rng.normal(size=2)) + 1.0,
                       rng.normal(size=2) * 0.3,
                       rng.normal(size=2) * 0.3], axis=1)
        out.append((*qp, Ac, bc))
    return out, 40


FAMILIES = {"qp_limit": _qp_limit, "dim2_cones": _dim2_cones,
            "active_cone": _active_cone, "infeasible": _infeasible,
            "batched": _batched}


def _stack(insts):
    return [np.stack([x[k] for x in insts]) for k in range(6)]


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_socp_solve_matches_the_jax_package(family):
    insts, n_iter = FAMILIES[family]()
    arrs = _stack(insts)
    ref = vmap(lambda *a: jax_socp(*a, n_iter=n_iter))(
        *map(jnp.asarray, arrs))
    got = socp_solve(*map(torch.as_tensor, arrs), n_iter=n_iter)
    for m in ("converged", "feasible"):
        assert np.array_equal(getattr(got, m).numpy(),
                              np.asarray(getattr(ref, m))), m
    conv = np.asarray(ref.converged)
    if family == "infeasible":
        assert not conv.any() and not got.feasible.numpy().any()
        return
    assert conv.all()
    np.testing.assert_allclose(got.obj.numpy(), np.asarray(ref.obj),
                               rtol=1e-9, atol=1e-9)
    z, zr = got.z.numpy(), np.asarray(ref.z)
    tight = [np.allclose(a, b, rtol=1e-9, atol=1e-9) for a, b in zip(z, zr)]
    assert sum(tight) >= len(tight) - 1, tight
    np.testing.assert_allclose(z, zr, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got.lam_l.numpy()[np.array(tight)],
                               np.asarray(ref.lam_l)[np.array(tight)],
                               rtol=1e-6, atol=1e-8)


def test_qp_limit_matches_the_port_qp_solver():
    """With zero cones socp_solve is the linear QP (ipm.qp_solve)."""
    from explicit_hybrid_mpc_tpu_torch.oracle import ipm

    insts, n_iter = _qp_limit()
    Q, q, Al, bl, Ac, bc = map(torch.as_tensor, _stack(insts))
    a = socp_solve(Q, q, Al, bl, Ac, bc, n_iter=n_iter)
    b = ipm.qp_solve(Q, q, Al, bl)
    assert a.converged.all() and b.converged.all()
    np.testing.assert_allclose(a.obj.numpy(), b.obj.numpy(), rtol=1e-7,
                               atol=1e-9)
    np.testing.assert_allclose(a.z.numpy(), b.z.numpy(), rtol=1e-6,
                               atol=1e-8)


def test_a_row_does_not_depend_on_its_batch():
    insts, n_iter = _batched()
    batched = socp_solve(*map(torch.as_tensor, _stack(insts)),
                         n_iter=n_iter)
    for i, inst in enumerate(insts):
        single = socp_solve(*(torch.as_tensor(x)[None] for x in inst),
                            n_iter=n_iter)
        np.testing.assert_allclose(batched.obj[i].item(),
                                   single.obj[0].item(), rtol=1e-9,
                                   atol=1e-12)
        assert bool(batched.converged[i]) == bool(single.converged[0])


def test_nt_scaling_maps_lam_and_s_to_one_point():
    """The defining NT property W lam = W^{-1} s, with W^{-1} the
    inverse of W, on random interior cone pairs."""
    rng = np.random.default_rng(5)

    def interior(n):
        u = rng.normal(size=(n, 3))
        u[:, 0] = np.linalg.norm(u[:, 1:], axis=1) + rng.uniform(0.1, 2, n)
        return torch.as_tensor(u)

    s, lam = interior(16), interior(16)
    wbar, eta = socp._nt_scaling(s, lam)
    np.testing.assert_allclose(socp._det(wbar).numpy(), 1.0, rtol=1e-12)
    Wl = socp._W_apply(wbar, eta, lam)
    np.testing.assert_allclose(Wl.numpy(),
                               socp._Winv_apply(wbar, eta, s).numpy(),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(
        socp._Winv_apply(wbar, eta, socp._W_apply(wbar, eta, s)).numpy(),
        s.numpy(), rtol=1e-12, atol=1e-12)


def test_cone_step_stops_at_the_boundary():
    s = torch.tensor([[2.0, 0.0, 0.0]], dtype=torch.float64)
    ds = torch.tensor([[-1.0, 1.0, 0.0]], dtype=torch.float64)
    # s + a ds = (2 - a, a, 0) reaches the boundary at a = 1.
    assert socp._cone_step(s, ds, tau=1.0).item() == pytest.approx(1.0)
    assert socp._cone_step(s, 3 * ds, tau=1.0).item() == pytest.approx(
        1 / 3)
    # A direction into the cone's interior is not capped.
    into = torch.tensor([[1.0, 0.0, 0.0]], dtype=torch.float64)
    assert socp._cone_step(s, into).item() == 1.0
