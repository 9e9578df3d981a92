"""Torch port: the IPM leg's plain version and qp_solve against the JAX
package (the XLA reference and the Pallas kernel in interpret mode) on
the same seeded inputs, plus an independent ADMM ground truth.

Tolerances: converged/feasible masks bitwise; z to 1e-9 on converged
rows (the JAX package's own cross-tier bar).  Bare legs from the same
start agree to 1e-12 (f64) and 1e-5 (f32) relative after 4 iterations:
the two implementations sum in different orders, and later iterations
near the boundary amplify that (f32 reaches ~1e-4 by iteration 6)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import explicit_hybrid_mpc_tpu  # noqa: F401  (enables x64)
from explicit_hybrid_mpc_tpu.oracle import ipm as jipm
from explicit_hybrid_mpc_tpu.oracle import pallas_ipm
from explicit_hybrid_mpc_tpu_torch.oracle import ipm, ipm_leg
from qp_ref import admm_qp

# The suite runs in several worker processes at once: one torch thread
# each keeps these tests from crowding the cores the others time on.
torch.set_num_threads(1)

SCHEDULES = [dict(n_iter=20), dict(n_iter=8, n_f32=15)]


def _qp_batch(rng, K=21, nz=8, nc=20, infeasible_every=3):
    """Random strictly-feasible QPs with a sprinkling of infeasible
    instances (contradictory row pair), as numpy arrays."""
    Qs, qs, As, bs = [], [], [], []
    for i in range(K):
        W = rng.normal(size=(nz, nz))
        Qs.append(W @ W.T + np.eye(nz))
        qs.append(rng.normal(size=nz))
        A = rng.normal(size=(nc, nz))
        b = np.abs(rng.normal(size=nc)) + 0.5
        if infeasible_every and i % infeasible_every == 0:
            A[0] = -A[1]
            b[0] = -b[1] - 1.0
        As.append(A)
        bs.append(b)
    return tuple(np.stack(x) for x in (Qs, qs, As, bs))


def _jax_solve(tier, arrays, **kw):
    return jax.jit(jax.vmap(functools.partial(
        jipm.qp_solve, kernel=tier, **kw)))(*map(jnp.asarray, arrays))


def _torch(arrays):
    return tuple(torch.as_tensor(np.array(a)) for a in arrays)


@pytest.mark.parametrize("tier", ["xla", "pallas"])
@pytest.mark.parametrize("kw", SCHEDULES, ids=["f64", "mixed"])
def test_qp_solve_matches_the_reference(tier, kw):
    arrays = _qp_batch(np.random.default_rng(11))
    ref = _jax_solve(tier, arrays, **kw)
    got = ipm.qp_solve(*_torch(arrays), **kw)
    # f32_ok is a merit comparison the XLA tier makes after a library
    # f32 Cholesky: only the Pallas tier shares the leg's algebra.
    masks = ("converged", "feasible") + (("f32_ok",) if tier == "pallas"
                                         else ())
    for m in masks:
        assert np.array_equal(getattr(got, m).numpy(),
                              np.asarray(getattr(ref, m))), m
    conv = np.asarray(ref.converged)
    assert conv.any() and not conv.all()
    np.testing.assert_allclose(got.z.numpy()[conv], np.asarray(ref.z)[conv],
                               atol=1e-9)
    np.testing.assert_allclose(got.obj.numpy()[conv],
                               np.asarray(ref.obj)[conv], rtol=1e-9,
                               atol=1e-9)


@pytest.mark.parametrize("kw", SCHEDULES, ids=["f64", "mixed"])
def test_warm_start_gate_matches_the_reference(kw):
    arrays = _qp_batch(np.random.default_rng(5), K=13)
    base = _jax_solve("xla", arrays, n_iter=20)
    valid = np.arange(13) % 2 == 0
    warm_np = (np.asarray(base.z), np.asarray(base.s), np.asarray(base.lam),
               valid)
    ref = jax.jit(jax.vmap(lambda Q, q, A, b, z, s, l, h: jipm.qp_solve(
        Q, q, A, b, warm_start=(z, s, l, h), **kw)))(
        *map(jnp.asarray, arrays), *map(jnp.asarray, warm_np))
    got = ipm.qp_solve(*_torch(arrays), warm_start=_torch(warm_np), **kw)
    for m in ("warm_ok", "converged", "feasible"):
        assert np.array_equal(getattr(got, m).numpy(),
                              np.asarray(getattr(ref, m))), m
    assert got.warm_ok.numpy()[valid].any()
    assert not got.warm_ok.numpy()[~valid].any()
    conv = np.asarray(ref.converged)
    np.testing.assert_allclose(got.z.numpy()[conv], np.asarray(ref.z)[conv],
                               atol=1e-9)


#: (K, nz, nc, n_iter) of the bare-leg comparison: a small batch, and the
#: quadrotor's elastic simplex-min QP (nz 65, nc 366), which the CUDA
#: kernel runs on its large path.  Interpret mode traces the unrolled
#: nz-step factor and substitutions (~45 s at nz 65 whatever n_iter),
#: and the f32 gap between two summation orders grows with the
#: iterations (~1e-5 by the 4th at this size), so the large case runs 3.
_LEGS = {"small": (10, 8, 20, 4), "quadrotor": (3, 65, 366, 3)}


@pytest.mark.parametrize("shape,dtype,tol", [
    ("small", np.float64, 1e-12), ("small", np.float32, 1e-5),
    ("quadrotor", np.float64, 1e-12), ("quadrotor", np.float32, 1e-5)],
    ids=["f64", "f32", "quadrotor-f64", "quadrotor-f32"])
def test_plain_leg_matches_the_pallas_kernel(shape, dtype, tol):
    """ipm_leg_torch against pallas_ipm.solve_tiles (interpret mode) on
    the same equilibrated-free raw QPs and the same start."""
    K, nz, nc, n_iter = _LEGS[shape]
    rng = np.random.default_rng(3)
    Q, q, A, b = (a.astype(dtype) for a in _qp_batch(rng, K=K, nz=nz, nc=nc,
                                                     infeasible_every=0))
    z0 = np.zeros((K, nz), dtype)
    s0 = (np.abs(rng.normal(size=(K, nc))) + 1.0).astype(dtype)
    l0 = np.ones((K, nc), dtype)
    ref = pallas_ipm.solve_tiles(*map(jnp.asarray, (Q, q, A, b, z0, s0, l0)),
                                 n_iter=n_iter, interpret=True)
    got = ipm_leg.ipm_leg_torch(*_torch((Q, q, A, b, z0, s0, l0)),
                                n_iter=n_iter)
    for g, r in zip(got, ref):
        g, r = g.numpy(), np.asarray(r)
        assert g.dtype == r.dtype
        np.testing.assert_allclose(g, r, rtol=tol, atol=tol)


def test_leg_wrapper_runs_the_plain_version_on_cpu_tensors():
    arrays = _torch(_qp_batch(np.random.default_rng(7), K=4,
                              infeasible_every=0))
    K, nz = arrays[1].shape
    nc = arrays[3].shape[1]
    start = (torch.zeros(K, nz, dtype=torch.float64),
             torch.ones(K, nc, dtype=torch.float64),
             torch.ones(K, nc, dtype=torch.float64))
    before = ipm_leg.launches
    a = ipm_leg.ipm_leg(*arrays, *start, n_iter=5)
    b = ipm_leg.ipm_leg_torch(*arrays, *start, n_iter=5)
    assert ipm_leg.launches == before
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="CUDA"):
        ipm_leg.ipm_leg_cuda(*arrays, *start, n_iter=5)
    assert ipm_leg.ipm_leg(*arrays, *start, n_iter=0) == start


def test_leg_constants_match_the_reference():
    assert ipm_leg.leg_constants(torch.float32) == jipm.leg_constants(
        jnp.float32)
    assert ipm_leg.leg_constants(torch.float64) == jipm.leg_constants(
        jnp.float64)
    assert ipm.schedule_iters(20, 10) == jipm.schedule_iters(20, 10) == 30


def test_kernel_requests_follow_the_device():
    cpu = torch.device("cpu")
    assert ipm.resolve_kernel("auto", cpu) == "torch"
    assert ipm.resolve_kernel("torch", cpu) == "torch"
    with pytest.raises(ValueError):
        ipm.resolve_kernel("cuda", cpu)
    with pytest.raises(ValueError):
        ipm.resolve_kernel("pallas", cpu)
    assert ipm.resolve_kernel("auto", torch.device("cuda", 0)) == "cuda"
    with pytest.raises(ValueError):
        ipm.resolve_kernel("torch", torch.device("cuda", 0))
    # The legs follow the tensors: a CPU solve never counts a launch.
    arrays = _torch(_qp_batch(np.random.default_rng(1), K=2))
    before = ipm_leg.launches
    ipm.qp_solve(*arrays, n_iter=3, n_f32=2)
    assert ipm_leg.launches == before


def test_converged_solutions_match_admm_ground_truth():
    arrays = _qp_batch(np.random.default_rng(17), K=9, nz=6, nc=12)
    sol = ipm.qp_solve(*_torch(arrays), n_iter=30)
    conv = sol.converged.numpy()
    assert conv.sum() >= 4
    for k in np.nonzero(conv)[0]:
        z, obj, ok = admm_qp(*(a[k] for a in arrays))
        assert ok
        np.testing.assert_allclose(sol.z.numpy()[k], z, atol=1e-6)
        np.testing.assert_allclose(sol.obj.numpy()[k], obj, rtol=1e-7,
                                   atol=1e-7)


def test_solve_mask_and_phase1_match_the_reference():
    arrays = _qp_batch(np.random.default_rng(29), K=10)
    cx, fx, rx = jipm.solve_mask(*map(jnp.asarray, arrays), n_iter=15)
    cp, fp, rp = ipm.solve_mask(*arrays, n_iter=15, device="cpu")
    assert np.array_equal(cx, cp) and np.array_equal(fx, fp)
    fin = np.isfinite(rx) & np.isfinite(rp)
    np.testing.assert_allclose(rp[fin], rx[fin], rtol=1e-6, atol=1e-12)
    A, b = arrays[2], arrays[3]
    tj = jax.vmap(lambda a_, b_: jipm.phase1(a_, b_, n_iter=30))(
        jnp.asarray(A), jnp.asarray(b))
    tt = ipm.phase1(torch.as_tensor(A), torch.as_tensor(b), n_iter=30)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=1e-7,
                               atol=1e-9)
