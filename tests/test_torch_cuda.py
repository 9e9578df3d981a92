"""Torch port: the CUDA kernels against their plain versions, on a GPU.

Every test here needs an NVIDIA GPU with the CUDA toolkit and skips
without one.  This file imports neither jax nor the JAX package, so it
also runs on a machine that has only the port's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from explicit_hybrid_mpc_tpu_torch.online import evaluator, export, locate
from explicit_hybrid_mpc_tpu_torch.oracle import ipm, ipm_leg, oracle
from explicit_hybrid_mpc_tpu_torch.problems.registry import make

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no "
                    "CPU mode (their plain versions are tested on the CPU)")
    return torch.device("cuda", 0)


def _qps(rng, K, nz, nc, dtype, dev):
    W = rng.normal(size=(K, nz, nz))
    arrs = [W @ W.transpose(0, 2, 1) + np.eye(nz), rng.normal(size=(K, nz)),
            rng.normal(size=(K, nc, nz)), np.abs(rng.normal(size=(K, nc))) + .5]
    return [torch.as_tensor(a, dtype=dtype, device=dev) for a in arrs]


@pytest.mark.parametrize("nz,nc", [(5, 35), (8, 39), (32, 128)])
def test_ipm_leg_kernel_matches_plain(gpu, nz, nc):
    """f64: kernel against plain to 1e-9 relative (summation order
    only).  f32: both are float32 approximations of the float64
    iterates, their worst rows are the QPs float32 resolves poorly on
    either side; the kernel's worst error against them is held to 4x
    the plain version's, plus 1e-4."""
    Q, q, A, b = _qps(np.random.default_rng(nz), 257, nz, nc,
                      torch.float64, gpu)
    st = (torch.zeros_like(q), torch.ones_like(b), torch.ones_like(b))
    before = ipm_leg.launches
    kern = ipm_leg.ipm_leg(Q, q, A, b, *st, n_iter=4)
    torch.cuda.synchronize()
    assert ipm_leg.launches == before + 1
    truth = ipm_leg.ipm_leg_torch(Q, q, A, b, *st, n_iter=4)

    def rel(xs):
        return max(float(((x.double() - y).abs() / (1 + y.abs())).max())
                   for x, y in zip(xs, truth))
    assert rel(kern) <= 1e-9
    f32 = [t.float() for t in (Q, q, A, b, *st)]
    err_k = rel(ipm_leg.ipm_leg(*f32, n_iter=4))
    err_p = rel(ipm_leg.ipm_leg_torch(*f32, n_iter=4))
    assert err_k <= 4 * err_p + 1e-4


def test_ipm_leg_wrapper_rejects_what_the_kernel_cannot_take(gpu):
    Q, q, A, b = _qps(np.random.default_rng(0), 4, 5, 10, torch.float64, gpu)
    st = (torch.zeros_like(q), torch.ones_like(b), torch.ones_like(b))
    with pytest.raises(TypeError):
        ipm_leg.ipm_leg_cuda(Q.float(), q, A, b, *st, n_iter=2)
    with pytest.raises(ValueError):
        ipm_leg.ipm_leg_cuda(Q, q, A.transpose(1, 2).contiguous()
                             .transpose(1, 2), b, *st, n_iter=2)
    big = _qps(np.random.default_rng(0), 2, 33, 10, torch.float64, gpu)
    with pytest.raises(ValueError, match="maxima"):
        ipm_leg.ipm_leg_cuda(*big, torch.zeros_like(big[1]),
                             torch.ones_like(big[3]),
                             torch.ones_like(big[3]), n_iter=2)


def test_qp_solve_on_the_card_matches_the_cpu(gpu):
    prob = make("inverted_pendulum")
    dev_prob = oracle.to_device(prob.canonical, gpu)
    rng = np.random.default_rng(1)
    th = torch.as_tensor(rng.uniform(prob.theta_lb, prob.theta_ub,
                                     (512, prob.n_theta)), device=gpu)
    ds = torch.as_tensor(rng.integers(0, prob.canonical.n_delta, 512),
                         device=gpu)
    qp = oracle.point_qp(dev_prob, th, ds)
    a = ipm.qp_solve(*qp, n_iter=30)
    b = ipm.qp_solve(*(t.cpu() for t in qp), n_iter=30)
    assert torch.equal(a.converged.cpu(), b.converged)
    assert torch.equal(a.feasible.cpu(), b.feasible)
    c = b.converged
    assert c.any()
    assert float((a.z.cpu()[c] - b.z[c]).abs().max()) <= 1e-9


def test_oracle_on_the_card_refuses_the_plain_leg(gpu):
    prob = make("double_integrator", N=3, theta_box=1.5)
    with pytest.raises(ValueError):
        oracle.Oracle(prob, backend="cuda", ipm_kernel="torch")
    o = oracle.Oracle(prob, backend="cuda")
    assert o.ipm_kernel == "cuda"
    before = ipm_leg.launches
    sol = o.solve_vertices(np.zeros((3, prob.n_theta)))
    assert ipm_leg.launches > before and sol.conv.all()


def test_dispatch_does_not_synchronize(gpu):
    prob = make("inverted_pendulum")
    o = oracle.Oracle(prob, backend="cuda", two_phase=True, warm_start=True)
    rng = np.random.default_rng(3)
    th = rng.uniform(prob.theta_lb, prob.theta_ub, (64, prob.n_theta))
    ds = rng.integers(0, prob.canonical.n_delta, 64)
    o.solve_vertices(th)                 # warm the pinned-memory pool
    o.solve_pairs(th, ds)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        hv = o.dispatch_vertices(th)
        hp = o.dispatch_pairs(th, ds)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert o.wait_vertices(hv).conv.any()
    assert o.wait_pairs(hp)[1].shape == (64,)


def test_locate_kernel_matches_plain(gpu):
    rng = np.random.default_rng(2)
    L, p = 1000, 2
    V = rng.uniform(-1, 1, (L, p + 1, p))
    from explicit_hybrid_mpc_tpu_torch.partition import geometry

    table = export.LeafTable(
        bary_M=geometry.barycentric_matrices(V), U=rng.normal(size=(L, 3, 1)),
        V=rng.normal(size=(L, 3)), delta=np.zeros(L, dtype=np.int64),
        node_id=np.arange(L))
    lt = locate.stage(table, device=gpu)
    th = torch.as_tensor(rng.uniform(-1, 1, (3000, p)), device=gpu)
    before = locate.launches
    leaf, score = locate.locate(lt, th)
    assert locate.launches == before + 1
    pl, ps = locate.locate_torch(lt.bary, th)
    assert float((score - ps).abs().max()) <= 1e-5
    # Overlapping random simplices: the kernel's leaf must be a best leaf
    # up to float32 noise wherever the two picks differ.
    th1 = torch.cat([th.float(), torch.ones_like(th[:, :1]).float()], 1)
    full = torch.einsum("lij,bj->bli", lt.bary, th1).amin(2)
    chosen = full.gather(1, leaf.long()[:, None])[:, 0]
    assert bool((chosen >= full.amax(1) - 1e-5).all())
    res = locate.evaluate(lt, evaluator.stage(table, device=gpu), th)
    assert res.u.shape == (3000, 1) and bool(torch.isfinite(res.u).all())
