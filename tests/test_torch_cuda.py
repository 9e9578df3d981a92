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


#: (nz, nc) of the leg tests: both sides of the kernel's register path
#: (nz <= 8) and its general path, the register path at one (nc <= 32),
#: two (nc <= 64) and four (nc <= 128) constraint rows a lane, and the
#: large path just past the general path's limits and at the
#: quadrotor's point, Farkas and elastic simplex-min QPs; then the
#: pruned oracle's reduced point and elastic simplex-min QPs on the
#: satellite 4c box (24, 14), (31, 22) and the quadrotor pv box (60, 49),
#: (65, 55); then the satellite 4c build's point, elastic simplex-min
#: and Farkas QPs (24, 96), (31, 104), (31, 103), the pruned phase-1
#: gate (25, 14), and the general path's bucket edges (16, 33) and
#: (17, 128).
_SHAPES = [(1, 7), (5, 35), (5, 70), (8, 39), (8, 128), (9, 70), (32, 128),
           (33, 129), (60, 360), (65, 365), (65, 366),
           (24, 14), (31, 22), (60, 49), (65, 55),
           (24, 96), (31, 104), (31, 103), (25, 14), (16, 33), (17, 128)]


def _plain(args, n_iter):
    """ipm_leg_torch in chunks of 128 QPs (at the large shapes it
    materializes K x nc x nz x nz products)."""
    K = args[0].shape[0]
    outs = [ipm_leg.ipm_leg_torch(*(t[i:i + 128] for t in args),
                                  n_iter=n_iter) for i in range(0, K, 128)]
    return tuple(torch.cat([o[j] for o in outs]) for j in range(3))


@pytest.mark.parametrize("K", [1, 8, 257, 2048])
@pytest.mark.parametrize("nz,nc", _SHAPES)
def test_ipm_leg_kernel_matches_plain(gpu, nz, nc, K):
    """f64: kernel against plain to 1e-9 relative (summation order
    only).  f32: both are float32 approximations of the float64
    iterates, their worst rows are the QPs float32 resolves poorly on
    either side; the kernel's worst error against them is held to 4x
    the plain version's, plus 1e-4."""
    Q, q, A, b = _qps(np.random.default_rng(nz * 10_000 + nc * 100 + K), K,
                      nz, nc, torch.float64, gpu)
    st = (torch.zeros_like(q), torch.ones_like(b), torch.ones_like(b))
    before = ipm_leg.launches
    kern = ipm_leg.ipm_leg(Q, q, A, b, *st, n_iter=4)
    torch.cuda.synchronize()
    assert ipm_leg.launches == before + 1
    truth = _plain((Q, q, A, b, *st), 4)

    def rel(xs):
        return max(float(((x.double() - y).abs() / (1 + y.abs())).max())
                   for x, y in zip(xs, truth))
    assert rel(kern) <= 1e-9
    f32 = [t.float() for t in (Q, q, A, b, *st)]
    err_k = rel(ipm_leg.ipm_leg(*f32, n_iter=4))
    err_p = rel(_plain(f32, 4))
    assert err_k <= 4 * err_p + 1e-4


@pytest.mark.parametrize("nz,nc", [(5, 35), (5, 70), (8, 39), (8, 128),
                                   (9, 70), (65, 366), (60, 360), (60, 49),
                                   (24, 96), (24, 14), (31, 22)])
def test_ipm_leg_result_does_not_depend_on_the_batch(gpu, nz, nc):
    """A QP's result is bitwise the same launched alone, in its batch,
    and at another offset inside a larger batch of other QPs."""
    rng = np.random.default_rng(nz * 1000 + nc)
    mine = _qps(rng, 40, nz, nc, torch.float64, gpu)
    other = _qps(rng, 300, nz, nc, torch.float64, gpu)

    def start(t):
        return (torch.zeros_like(t[1]), torch.ones_like(t[3]),
                torch.ones_like(t[3]))

    def leg(t):
        return ipm_leg.ipm_leg_cuda(*t, *start(t), n_iter=6)
    batch = leg(mine)
    alone = [leg([x[k:k + 1].contiguous() for x in mine]) for k in (0, 17)]
    mixed = leg([torch.cat([o[:123], m, o[123:]]) for o, m in zip(other,
                                                                   mine)])
    torch.cuda.synchronize()
    for j, k in enumerate((0, 17)):
        for a, b in zip(alone[j], batch):
            assert torch.equal(a[0], b[k])
    for a, b in zip(mixed, batch):
        assert torch.equal(a[123:163], b)


@pytest.mark.parametrize("nz,nc", [(5, 35), (65, 366), (60, 49), (33, 129),
                                   (24, 96), (24, 14), (31, 22)])
def test_ipm_leg_nan_and_infeasible_qps(gpu, nz, nc):
    """A NaN in q comes back non-finite from the kernel and the plain
    version alike; a QP whose feasible set is empty comes back not
    converged and not feasible from qp_solve on the card, as on the
    CPU (the register path, the large path at the quadrotor's elastic
    simplex-min shape, its pruned point shape and just past the general
    path's limits, and the general path at the satellite's point, pruned
    point and pruned elastic simplex-min shapes)."""
    Q, q, A, b = _qps(np.random.default_rng(3), 6, nz, nc, torch.float64,
                      gpu)
    q[2, 1] = float("nan")
    st = (torch.zeros_like(q), torch.ones_like(b), torch.ones_like(b))
    for z, _s, _lam in (ipm_leg.ipm_leg_cuda(Q, q, A, b, *st, n_iter=5),
                        ipm_leg.ipm_leg_torch(Q, q, A, b, *st, n_iter=5)):
        assert not bool(torch.isfinite(z[2]).all())
        assert bool(torch.isfinite(z[[0, 1, 3, 4, 5]]).all())
    # z_0 <= -1 and -z_0 <= -1: no z satisfies both.
    Q, q, A, b = _qps(np.random.default_rng(4), 8, nz, nc, torch.float64,
                      gpu)
    A[:4, :2] = 0.0
    A[:4, 0, 0], A[:4, 1, 0] = 1.0, -1.0
    b[:4, :2] = -1.0
    cpu = ipm.qp_solve(*(t.cpu() for t in (Q, q, A, b)), n_iter=30)
    card = ipm.qp_solve(Q, q, A, b, n_iter=30)
    assert not bool(cpu.converged[:4].any() or cpu.feasible[:4].any())
    assert torch.equal(card.converged.cpu(), cpu.converged)
    assert torch.equal(card.feasible.cpu(), cpu.feasible)


def _tree_signature(res):
    """Node-for-node structural identity (as in test_torch_build.py)."""
    tree = res.tree
    leaves = tree.converged_leaves()
    return (res.stats["regions"], res.stats["tree_nodes"],
            res.stats["uncertified"], res.stats["semi_explicit"],
            tuple(tree.vertices[n].tobytes() for n in range(len(tree))),
            tuple(tree.leaf_data[n].delta_idx for n in leaves),
            tuple(bool(tree.leaf_data[n].certified) for n in leaves))


def test_tier1_build_on_the_card_is_the_cpu_build(gpu):
    """The tier-1 double-integrator build through the kernel is
    node-for-node the port's CPU build (which test_torch_build.py holds
    to the JAX package)."""
    from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
    from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
        build_partition)

    kw = {"N": 3, "theta_box": 1.5}
    res = {}
    for backend in ("cuda", "cpu"):
        before = ipm_leg.launches
        res[backend] = build_partition(
            make("double_integrator", **kw),
            PartitionConfig(problem="double_integrator", backend=backend,
                            problem_args=tuple(sorted(kw.items())),
                            eps_a=0.5, batch_simplices=64, max_depth=20))
        launched = ipm_leg.launches - before
        assert launched > 0 if backend == "cuda" else launched == 0
    assert res["cuda"].stats["device_failures"] == 0
    assert not res["cuda"].stats["truncated"]
    assert _tree_signature(res["cuda"]) == _tree_signature(res["cpu"])


def test_ipm_leg_wrapper_rejects_what_the_kernel_cannot_take(gpu):
    Q, q, A, b = _qps(np.random.default_rng(0), 4, 5, 10, torch.float64, gpu)
    st = (torch.zeros_like(q), torch.ones_like(b), torch.ones_like(b))
    with pytest.raises(TypeError):
        ipm_leg.ipm_leg_cuda(Q.float(), q, A, b, *st, n_iter=2)
    with pytest.raises(ValueError):
        ipm_leg.ipm_leg_cuda(Q, q, A.transpose(1, 2).contiguous()
                             .transpose(1, 2), b, *st, n_iter=2)
    # Past the large path's ceiling: more variables than its block has
    # threads, or more shared memory than one block may use (nz 200 at
    # nc 366 in float64); the largest nz that fits at nc 366 launches.
    for nz, dtype in ((ipm_leg.LARGE_THREADS + 1, torch.float32),
                      (200, torch.float64)):
        assert not ipm_leg.kernel_takes(nz, 366, dtype.itemsize)
        big = _qps(np.random.default_rng(0), 2, nz, 366, dtype, gpu)
        before = ipm_leg.launches
        with pytest.raises(ValueError, match="ceiling"):
            ipm_leg.ipm_leg_cuda(*big, torch.zeros_like(big[1]),
                                 torch.ones_like(big[3]),
                                 torch.ones_like(big[3]), n_iter=2)
        assert ipm_leg.launches == before
    top = max(n for n in range(1, 257) if ipm_leg.kernel_takes(n, 366, 8))
    fit = _qps(np.random.default_rng(0), 2, top, 366, torch.float64, gpu)
    z, s, lam = ipm_leg.ipm_leg_cuda(*fit, torch.zeros_like(fit[1]),
                                     torch.ones_like(fit[3]),
                                     torch.ones_like(fit[3]), n_iter=2)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(z).all())


def test_quadrotor_subbox_builds_on_the_card(gpu):
    """The quadrotor sub-box of the CPU parity tests (test_torch_build.py
    BUILDS["quadrotor"]: QPs nz 24-27, nc 144-147, the kernel's large
    path) built on the card is node-for-node the port's CPU build."""
    from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
    from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
        build_partition)

    kw = {"param": "p", "N": 4, "pos_box": 0.3}
    res = {}
    for backend in ("cuda", "cpu"):
        before = ipm_leg.launches
        res[backend] = build_partition(
            make("quadrotor", **kw),
            PartitionConfig(problem="quadrotor", backend=backend,
                            problem_args=tuple(sorted(kw.items())),
                            eps_a=0.1, eps_r=0.01))
        launched = ipm_leg.launches - before
        assert launched > 0 if backend == "cuda" else launched == 0
    assert make("quadrotor", **kw).canonical.nc > ipm_leg.GENERAL_MAX_NC
    assert res["cuda"].stats["device_failures"] == 0
    assert not res["cuda"].stats["truncated"]
    assert _tree_signature(res["cuda"]) == _tree_signature(res["cpu"])


@pytest.mark.parametrize("N", [2, 3, 4])
def test_satellite_subbox_builds_on_the_card(gpu, N):
    """The satellite 4c sub-box (axes 3, omega_box 0.03, h_box 0.3;
    artifacts/configs_cpu_r5.json "4c") at horizons 2, 3 and its own 4
    (QPs nz 12 / 18 / 24, nc 48 / 72 / 96: the kernel's general path in
    its 16 and 24 buckets) built on the card is node-for-node the port's
    CPU build, with the general path launched."""
    from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
    from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
        build_partition)

    kw = {"axes": 3, "omega_box": 0.03, "h_box": 0.3, "N": N}
    prob = make("satellite", **kw)
    assert 8 < prob.canonical.nz <= ipm_leg.GENERAL_MAX_NZ
    res = {}
    for backend in ("cuda", "cpu"):
        before = ipm_leg.launches
        res[backend] = build_partition(
            make("satellite", **kw),
            PartitionConfig(problem="satellite", backend=backend,
                            problem_args=tuple(sorted(kw.items())),
                            eps_a=1.0, eps_r=0.1))
        launched = ipm_leg.launches - before
        assert launched > 0 if backend == "cuda" else launched == 0
    assert res["cuda"].stats["device_failures"] == 0
    assert not res["cuda"].stats["truncated"]
    assert _tree_signature(res["cuda"]) == _tree_signature(res["cpu"])


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


def _random_table(rng, L, p=2):
    from explicit_hybrid_mpc_tpu_torch.partition import geometry

    V = rng.uniform(-1, 1, (L, p + 1, p))
    return export.LeafTable(
        bary_M=geometry.barycentric_matrices(V), U=rng.normal(size=(L, 3, 1)),
        V=rng.normal(size=(L, 3)), delta=np.zeros(L, dtype=np.int64),
        node_id=np.arange(L))


@pytest.mark.parametrize("L", [1, 129, 11670])
@pytest.mark.parametrize("B", [1, 5, 513, 8191])
def test_locate_kernel_at_ragged_shapes(gpu, B, L):
    """Batches that are no multiple of the 4 queries a thread holds or
    of the 512 a block holds, tables of 1 leaf, of one tile and a bit
    (129) and of the flagship's size (split across blocks): scores to
    1e-5 of the plain version, the kernel's leaf a best leaf to 1e-5,
    and the plain version's leaf wherever the best leaf clears the
    runner-up by 1e-4."""
    rng = np.random.default_rng(B * 100_000 + L)
    lt = locate.stage(_random_table(rng, L), device=gpu)
    th = torch.as_tensor(rng.uniform(-1, 1, (B, 2)), device=gpu)
    leaf, score = locate.locate(lt, th)
    pl, ps = locate.locate_torch(lt.bary, th)
    assert float((score - ps).abs().max()) <= 1e-5
    th1 = torch.cat([th.float(), torch.ones_like(th[:, :1]).float()], 1)
    full = torch.einsum("lij,bj->bli", lt.bary, th1).amin(2)
    chosen = full.gather(1, leaf.long()[:, None])[:, 0]
    assert bool((chosen >= full.amax(1) - 1e-5).all())
    top = full.topk(min(2, L), dim=1).values
    clear = (top[:, 0] - top[:, -1] > 1e-4) if L > 1 else \
        torch.ones(B, dtype=torch.bool, device=gpu)
    assert torch.equal(leaf[clear], pl[clear])


def test_locate_kernel_nan_queries(gpu):
    """A NaN in either coordinate or both: every leaf scores NaN, NaN
    ranks first, so leaf 0 with score NaN and not inside, on the kernel
    as on the plain version; finite rows beside them are unaffected."""
    rng = np.random.default_rng(5)
    table = _random_table(rng, 3000)
    lt = locate.stage(table, device=gpu)
    th = rng.uniform(-1, 1, (1100, 2))
    nan_rows = np.arange(3, 1100, 97)
    th[nan_rows, nan_rows % 3 % 2] = np.nan
    th[nan_rows[::3]] = np.nan
    tt = torch.as_tensor(th, device=gpu)
    for leaf, score in (locate.locate(lt, tt),
                        locate.locate_torch(lt.bary, tt)):
        assert leaf[nan_rows].tolist() == [0] * len(nan_rows)
        assert bool(torch.isnan(score[nan_rows]).all())
        assert int(torch.isnan(score).sum()) == len(nan_rows)
    res = locate.evaluate(lt, evaluator.stage(table, device=gpu), tt)
    assert not bool(res.inside[nan_rows].any())
    fin = np.setdiff1d(np.arange(1100), nan_rows)
    alone, _ = locate.locate(lt, tt[fin])
    assert torch.equal(alone, locate.locate(lt, tt)[0][fin])


# -- the fused serving kernel (csrc/arena_eval.cu) -------------------------


def _grid_table(rng, L, n_u=1):
    """Disjoint unit-grid simplices: each contains its own centroid, so
    location is tie-free."""
    from explicit_hybrid_mpc_tpu_torch.partition import geometry

    base = np.vstack([np.zeros(2), np.eye(2)])
    side = int(np.ceil(np.sqrt(L)))
    offs = np.stack([np.arange(L) % side, np.arange(L) // side], 1)
    verts = 0.8 * base[None] + offs[:, None, :] \
        + 0.1 * rng.uniform(size=(L, 1, 2))
    return export.LeafTable(
        bary_M=geometry.barycentric_matrices(verts),
        U=rng.normal(size=(L, 3, n_u)), V=np.abs(rng.normal(size=(L, 3))),
        delta=np.zeros(L, dtype=np.int64), node_id=np.arange(L))


def _arena_inputs(gpu, rng, sizes, B, n_u=2):
    """Tenants of `sizes` leaves packed at 128-column granules, and a
    (3, B, 3) query batch: centroids, random points, 10% out of box."""
    from explicit_hybrid_mpc_tpu_torch.online import fused

    C = 128 * sum(max(1, -(-L // 128)) for L in sizes)
    bary = np.zeros((3, 3, C), np.float32)
    U = np.zeros((3, C, n_u), np.float32)
    V = np.zeros((3, C), np.float32)
    exts, cents, start = [], [], 0
    for L in sizes:
        n = 128 * max(1, -(-L // 128))
        if L:
            t = _grid_table(rng, L, n_u)
            b, u, v = fused.pack_columns(t, n, 3, 3, n_u)
            bary[:, :, start:start + n], U[:, start:start + n] = b, u
            V[:, start:start + n] = v
            cents.append(np.stack([np.linalg.inv(m)[:-1].mean(1)
                                   for m in t.bary_M]))
        else:
            cents.append(np.zeros((1, 2)))
        exts.append((start, start + L))
        start += n
    tenant = rng.integers(0, len(sizes), B)
    th = np.stack([cents[k][rng.integers(0, len(cents[k]))] for k in tenant])
    side = int(np.ceil(np.sqrt(max(sizes))))
    rand = rng.uniform(0, side, (B, 2))
    th = np.where((rng.uniform(size=B) < 0.3)[:, None], rand, th)
    out = rng.uniform(size=B) < 0.1
    th[out] = rng.uniform(-5, side + 5, (int(out.sum()), 2))
    q = np.zeros((3, B, 3), np.float32)
    q[0, :, :2] = th
    q[1, :, :2] = 0.0
    q[2, :, :2] = side
    q[:, :, 2] = 1.0
    ext = np.array([exts[k] for k in tenant], np.int32)
    t = [torch.as_tensor(a, device=gpu) for a in (bary, U, V, q, ext)]
    return t, ext


@pytest.mark.parametrize("sizes,B", [((0, 37, 1000), 300),
                                     ((11, 128, 129, 5000), 4096),
                                     ((1,), 1)] + [
    ((0, 1, 37, 1000, 5000), B) for B in (1, 16, 257, 4096)])
def test_arena_eval_kernel_matches_plain(gpu, sizes, B):
    """Empty, one-tile and multi-tile extents, rows outside the box,
    rows with a NaN coordinate: column, clamped and served exact
    (tie-free tables); val/u/cost to 1e-5 times max(1, |value|) -- the
    same float32 products summed in another order differ by a few ulps,
    and points far outside every leaf extrapolate to values of tens --
    and NaN exactly where the plain version has NaN.  A NaN row is
    clamped and unserved on both."""
    from explicit_hybrid_mpc_tpu_torch.online import fused

    args, ext = _arena_inputs(gpu, np.random.default_rng(len(sizes)),
                              sizes, B)
    nan_rows = torch.arange(1, B, 97, device=gpu)
    args[3][0, nan_rows, (nan_rows % 2)] = float("nan")
    before = fused.launches
    rec = fused.arena_eval(*args, fused.make_plan(ext, gpu),
                           fused.Scratch(gpu))
    torch.cuda.synchronize()
    assert fused.launches == before + 1
    ref = fused.arena_eval_torch(*args)
    k, p = fused.unpack(rec), fused.unpack(ref)
    assert torch.equal(k[1], p[1]) and torch.equal(k[4], p[4])
    assert torch.equal(k[0] >= -1e-4, p[0] >= -1e-4)            # served
    assert bool(k[4][nan_rows].all())
    assert not bool((k[0][nan_rows] >= -1e-4).any())
    for a, b in zip((k[0], k[2], k[3]), (p[0], p[2], p[3])):
        both = torch.isnan(a) & torch.isnan(b)
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        assert bool(((a - b).abs() <= 1e-5 * b.abs().clamp(min=1))
                    [~both].all())
    col = k[1].cpu().numpy()
    live = ext[:, 1] > ext[:, 0]
    assert ((col >= ext[:, 0]) & (col < ext[:, 1]))[live].all()
    assert (col[~live] == 0).all()


def test_arena_eval_kernel_is_deterministic(gpu):
    from explicit_hybrid_mpc_tpu_torch.online import fused

    args, ext = _arena_inputs(gpu, np.random.default_rng(9), (300, 2000),
                              2048)
    sc = fused.Scratch(gpu)
    plan = fused.make_plan(ext, gpu)
    a = fused.arena_eval_cuda(*args, plan, sc)
    b = fused.arena_eval_cuda(*args, plan, sc)
    # A row's answer does not depend on the batch it rides in.
    c = fused.arena_eval_cuda(*args[:3], args[3][:, 100:164].contiguous(),
                              args[4][100:164].contiguous(),
                              fused.make_plan(ext[100:164], gpu), sc)
    assert torch.equal(a, b) and torch.equal(a[100:164], c)


def _plan(ext, chunks, gpu):
    """A launch plan with the chunk count forced."""
    from explicit_hybrid_mpc_tpu_torch.online import fused

    return fused.make_plan(ext, gpu)._replace(chunks=chunks)


@pytest.mark.parametrize("B", [1, 16, 257])
def test_arena_eval_record_does_not_depend_on_batch_or_chunking(gpu, B):
    """Bitwise: each row's record is the same alone (one row, one
    tile), inside the batch, under 1, 7 and 64 column chunks, with the
    rows shuffled, and in a second launch -- NaN, clamped and
    empty-extent rows included."""
    from explicit_hybrid_mpc_tpu_torch.online import fused

    rng = np.random.default_rng(B + 3)
    args, ext = _arena_inputs(gpu, rng, (0, 1, 37, 1000, 5000), B)
    args[3][0, torch.arange(0, B, 5, device=gpu), 0] = float("nan")
    sc = fused.Scratch(gpu)
    whole = [fused.arena_eval_cuda(*args, _plan(ext, k, gpu), sc)
             for k in (1, 7, 64, 64)]
    for r in whole[1:]:
        assert torch.equal(whole[0], r)
    assert torch.equal(whole[0], fused.arena_eval_cuda(
        *args, fused.make_plan(ext, gpu), sc))
    sh = rng.permutation(B)
    sht = torch.as_tensor(sh, device=gpu)
    shuffled = fused.arena_eval_cuda(
        *args[:3], args[3][:, sht].contiguous(), args[4][sht].contiguous(),
        fused.make_plan(ext[sh], gpu), sc)
    assert torch.equal(shuffled, whole[0][sht])
    for b in rng.choice(B, min(B, 12), replace=False):
        for k in (1, 5):
            alone = fused.arena_eval_cuda(
                *args[:3], args[3][:, b:b + 1].contiguous(),
                args[4][b:b + 1].contiguous(), _plan(ext[b:b + 1], k, gpu),
                sc)
            assert torch.equal(alone[0], whole[0][b])


def test_arena_eval_kernel_rejects_a_bad_plan(gpu):
    from explicit_hybrid_mpc_tpu_torch.online import fused

    args, ext = _arena_inputs(gpu, np.random.default_rng(1), (40, 300), 20)
    plan = _plan(ext, 3, gpu)
    sc = fused.Scratch(gpu)
    for bad in (plan._replace(chunks=0), plan._replace(chunks=65),
                plan._replace(tiles=plan.tiles[:, :-1].contiguous()),
                plan._replace(tiles=plan.tiles.long()),
                plan._replace(tiles=plan.tiles.cpu()),
                plan._replace(rows=19)):
        with pytest.raises(ValueError):
            fused.arena_eval_cuda(*args, bad, sc)
    with pytest.raises(ValueError):
        fused.arena_eval_cuda(*args, plan, fused.Scratch("cpu"))
    with pytest.raises(ValueError):
        fused.arena_eval(*args)                    # no plan, no scratch
    # A tile whose row ids lie past the batch is skipped; every other
    # row keeps its record.
    good = fused.arena_eval_cuda(*args, plan, sc)
    tiles = plan.tiles.clone()
    skipped = tiles[0, 4:4 + int(tiles[0, 0])].long()
    tiles[0, 4:4 + int(tiles[0, 0])] += 20
    rec = fused.arena_eval_cuda(*args, plan._replace(tiles=tiles), sc)
    torch.cuda.synchronize()
    keep = torch.ones(20, dtype=torch.bool, device=gpu)
    keep[skipped] = False
    assert torch.equal(rec[keep], good[keep])


def test_device_arena_on_the_card(gpu):
    """The arena on cuda serves through the kernel, with the CPU arena's
    answers on the same publish history."""
    from explicit_hybrid_mpc_tpu_torch.online import fused
    from explicit_hybrid_mpc_tpu_torch.serve import DeviceArena

    rng = np.random.default_rng(4)
    tabs = {n: _grid_table(rng, L) for n, L in (("a", 300), ("b", 77))}
    arenas = [DeviceArena(p=2, n_u=1, capacity_cols=1024, device=d)
              for d in (gpu, "cpu")]
    for ar in arenas:
        for n, t in tabs.items():
            ar.publish(n, "v1", t, np.zeros(2), np.full(2, 18.0))
    names = ["a", "b"] * 64
    th = rng.uniform(-1, 19, (128, 2))
    before = fused.launches
    g, c = (ar.evaluate(names, th) for ar in arenas)
    assert fused.launches == before + 1
    assert np.array_equal(g.col, c.col) and np.array_equal(g.served, c.served)
    assert np.array_equal(g.clamped, c.clamped)
    np.testing.assert_allclose(g.u, c.u, atol=1e-5)


def test_device_arena_raises_when_the_kernel_cannot_load(gpu, monkeypatch):
    """No fallback: a kernel that cannot be built or loaded fails the
    evaluation, and the plain version never runs on a CUDA tensor."""
    from explicit_hybrid_mpc_tpu_torch import kernels
    from explicit_hybrid_mpc_tpu_torch.online import fused
    from explicit_hybrid_mpc_tpu_torch.serve import DeviceArena

    arena = DeviceArena(p=2, n_u=1, capacity_cols=512, device=gpu)
    arena.publish("a", "v1", _grid_table(np.random.default_rng(1), 100),
                  np.zeros(2), np.full(2, 10.0))

    def no_lib(name):
        raise kernels.KernelError(f"cannot load the {name} kernel")

    def no_plain(*a, **k):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(kernels, "library", no_lib)
    monkeypatch.setattr(fused, "arena_eval_torch", no_plain)
    with pytest.raises(kernels.KernelError):
        arena.evaluate("a", np.ones((4, 2)))
    assert arena.stats()["retiring"] == 0 and arena.extent("a")._refs == 0


# -- the single-controller serving path and the closed loop on the card -----


def _synthetic_server(dev, p=3, depth=6, n_u=2, scale=1.0, n_shards=4,
                      router=False):
    from explicit_hybrid_mpc_tpu_torch.online import descent, sharded
    from explicit_hybrid_mpc_tpu_torch.partition import geometry
    from explicit_hybrid_mpc_tpu_torch.partition.synthetic import (
        build_synthetic_tree)

    tree, roots = build_synthetic_tree(p=p, depth=depth, n_u=n_u)
    if scale != 1.0:
        tree._pl_inputs[:] *= scale
        tree._pl_costs[:] *= scale
    table = export.export_leaves(tree)
    dt = descent.export_descent(tree, roots, table, stage=False)
    rt = geometry.kuhn_root_locator(np.zeros(p), np.ones(p)) \
        if router else None
    return sharded.shard_descent(dt, table, n_shards=n_shards,
                                 devices=[dev], router=rt)


@pytest.mark.parametrize("router", [False, True])
def test_sharded_descent_on_the_card_matches_the_cpu(gpu, router):
    """The same f64 descent and interpolation on both devices: rows,
    nodes and inside equal, u / cost to 1e-12; devices=None is the
    card."""
    from explicit_hybrid_mpc_tpu_torch.online import sharded

    g = _synthetic_server(gpu, router=router)
    c = _synthetic_server(torch.device("cpu"), router=router)
    assert all(d.type == "cuda" for d in g.devices)
    th = np.random.default_rng(7).uniform(-0.1, 1.1, (3000, 3))
    a, b = g.evaluate(th), c.evaluate(th)
    assert np.array_equal(a.leaf, b.leaf)
    assert np.array_equal(a.inside, b.inside) and not a.inside.all()
    np.testing.assert_allclose(a.u, b.u, atol=1e-12)
    np.testing.assert_allclose(a.cost, b.cost, atol=1e-12)
    for x, y in zip(g.locate(th), c.locate(th)):
        assert np.array_equal(x, y)
    from explicit_hybrid_mpc_tpu_torch.online import descent
    from explicit_hybrid_mpc_tpu_torch.partition.synthetic import (
        build_synthetic_tree)

    tree, roots = build_synthetic_tree(p=2, depth=4)
    table = export.export_leaves(tree)
    dflt = sharded.shard_descent(descent.export_descent(
        tree, roots, table, stage=False), table, n_shards=2)
    assert all(d.type == "cuda" for d in dflt.devices)


def test_sharded_descent_replays_its_graphs_bitwise(gpu):
    """A bucket's first call runs eagerly and captures its graphs (the
    routing and each shard's); a replay on other inputs of the same
    buckets gives the eager program's bits, row for row, and so does a
    replay after the other buckets' captures."""
    g = _synthetic_server(gpu)
    rng = np.random.default_rng(11)
    first = rng.uniform(-0.1, 1.1, (40, 3))
    again = rng.uniform(-0.1, 1.1, (40, 3))
    a0 = g.evaluate(first)
    (graphs,) = g._graph_sets
    n_graphs = len(graphs)
    assert n_graphs >= 2 and ("route", 64) in graphs
    r1 = g.evaluate(again)                       # replays
    assert g._graph_sets == [graphs] and len(graphs) == n_graphs
    g.evaluate(rng.uniform(0, 1, (300, 3)))      # other buckets
    eager = _synthetic_server(gpu)
    eager._run = lambda graphs, key, fn, inputs: fn(*inputs)
    for th, got in ((first, a0), (again, r1), (again, g.evaluate(again))):
        ref = eager.evaluate(th)
        for x, y in zip(got, ref):
            assert np.array_equal(x, y)
    for x, y in zip(g.locate(again), eager.locate(again)):
        assert np.array_equal(x, y)


def test_concurrent_calls_take_graph_sets_of_their_own(gpu):
    """Two threads evaluating one server at once, one on a stream of
    its own: each call takes a set of graphs no other call is using,
    and every answer is the eager program's, bitwise."""
    import threading

    g = _synthetic_server(gpu)
    eager = _synthetic_server(gpu)
    eager._run = lambda graphs, key, fn, inputs: fn(*inputs)
    rng = np.random.default_rng(12)
    batches = [rng.uniform(-0.1, 1.1, (int(n), 3))
               for n in rng.integers(1, 200, 64)]
    got: dict = {}
    errors: list = []

    def client(c):
        try:
            stream = torch.cuda.Stream(gpu) if c else None
            with torch.cuda.stream(stream):
                for j in range(c, len(batches), 2):
                    got[j] = g.evaluate(batches[j])
        except BaseException as e:  # noqa: BLE001 -- reported below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,)) for c in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert not errors and not any(t.is_alive() for t in threads)
    assert 1 <= len(g._graph_sets) <= 2
    for j, th in enumerate(batches):
        for x, y in zip(got[j], eager.evaluate(th)):
            assert np.array_equal(x, y)


def test_request_scheduler_on_the_card_with_a_hot_swap(gpu):
    """16 threads submit while v2 (payloads exactly 2x v1's) is published:
    nothing drops, every answer is bitwise its version's."""
    import threading

    from explicit_hybrid_mpc_tpu_torch.serve import (ControllerRegistry,
                                                     RequestScheduler)

    v1s, v2s = (_synthetic_server(gpu, scale=s) for s in (1.0, 2.0))
    reg = ControllerRegistry()
    v1 = reg.publish("c", "v1", v1s)
    sched = RequestScheduler(reg, "c", max_batch=64, max_wait_us=500.0)
    outs, errors = [], []
    lock = threading.Lock()
    half = threading.Barrier(17)

    def client(cid):
        r = np.random.default_rng(cid)
        for k in range(60):
            if k == 30:
                half.wait(30.0)
            th = r.uniform(0, 1, (2, 3))
            try:
                res = sched.submit_batch(th).result(30.0)
            except Exception as e:  # noqa: BLE001 -- a drop IS a failure
                errors.append(e)
                return
            with lock:
                outs.extend(zip(th, res))

    ts = [threading.Thread(target=client, args=(c,)) for c in range(16)]
    for t in ts:
        t.start()
    half.wait(30.0)
    reg.publish("c", "v2", v2s)
    for t in ts:
        t.join(60.0)
    sched.close()
    assert not any(t.is_alive() for t in ts) and not errors
    assert len(outs) == 16 * 60 * 2
    assert reg.wait_retired(v1, 10.0)
    assert {r.version for _t, r in outs} == {"v1", "v2"}
    ref = v1s.evaluate(np.stack([t for t, _r in outs]))
    for k, (_t, r) in enumerate(outs):
        s = 1.0 if r.version == "v1" else 2.0
        assert np.array_equal(r.u, s * ref.u[k])
        assert r.cost == s * float(ref.cost[k])


def test_closed_loop_on_the_card_matches_the_cpu(gpu):
    """The DI closed loop (N=3, theta_box=1.5, eps_a=0.05) on the card
    against the CPU: the explicit controller through K2 against K2's
    plain version (float32 location, f64 interpolation: inputs 1e-9 on
    the same leaves), the implicit one through K1 against the plain leg
    (1e-6)."""
    from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
    from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
        build_partition)
    from explicit_hybrid_mpc_tpu_torch.sim import simulator

    prob = make("double_integrator", N=3, theta_box=1.5)
    res = build_partition(prob, PartitionConfig(
        problem="double_integrator", eps_a=0.05, backend="cpu",
        batch_simplices=64))
    table = export.export_leaves(res.tree)
    theta0 = np.array([-1.2, 0.8])
    k1, k2 = ipm_leg.launches, locate.launches
    g = simulator.compare(prob, table, oracle.Oracle(prob, backend="cuda"),
                          theta0, T=25, device=gpu)
    assert locate.launches - k2 == 25 + 1      # the steps and the warm call
    assert ipm_leg.launches > k1
    c = simulator.compare(prob, table, oracle.Oracle(prob, backend="cpu"),
                          theta0, T=25, device="cpu")
    np.testing.assert_allclose(g.explicit.inputs, c.explicit.inputs,
                               atol=1e-9)
    np.testing.assert_allclose(g.implicit.inputs, c.implicit.inputs,
                               atol=1e-6)
    assert np.array_equal(g.explicit.inside, c.explicit.inside)
    assert g.cost_ratio < 1.05


def test_fallback_oracle_resolve_on_the_card(gpu):
    """FallbackPolicy.apply's budgeted re-solve through a CUDA oracle
    (K1): a hole row gets the point MICP's u0 and V*, as the CPU oracle
    gives them (1e-6)."""
    from explicit_hybrid_mpc_tpu_torch.online import descent, sharded
    from explicit_hybrid_mpc_tpu_torch.partition import geometry
    from explicit_hybrid_mpc_tpu_torch.partition.tree import LeafData, Tree
    from explicit_hybrid_mpc_tpu_torch.serve import FallbackPolicy

    t = Tree(p=1, n_u=1)
    r = t.add_root(np.array([[0.0], [1.0]]))
    left, right, i, j, _ = geometry.bisect(t.vertices[r])
    li, _ri = t.split(r, left, right, (i, j))
    t.set_leaf(li, LeafData(delta_idx=0, vertex_inputs=np.ones((2, 1)),
                            vertex_costs=np.zeros(2)))
    table = export.export_leaves(t)
    srv = sharded.shard_descent(descent.export_descent(
        t, [r], table, stage=False), table, n_shards=2, granularity=1,
        devices=[gpu])
    prob = make("double_integrator", N=3)

    class OnLine:
        """The DI oracle along theta = (x, 0.2)."""

        def __init__(self, backend):
            self.o = oracle.Oracle(prob, backend=backend)

        def solve_vertices(self, th):
            return self.o.solve_vertices(
                np.concatenate([th, np.full_like(th, 0.2)], axis=1))

    thetas = np.array([[0.25], [0.75], [0.9]])
    before = ipm_leg.launches
    fb = FallbackPolicy(np.zeros(1), np.ones(1), oracle=OnLine("cuda"),
                        max_oracle_frac=1.0)
    got, tags = fb.apply(thetas, srv.evaluate(thetas), srv)
    assert ipm_leg.launches > before
    assert tags == [None, "oracle", "oracle"] and got.inside.all()
    ref = OnLine("cpu").solve_vertices(thetas[1:])
    np.testing.assert_allclose(
        got.u[1:], ref.u0[np.arange(2), ref.dstar], atol=1e-6)
    np.testing.assert_allclose(got.cost[1:], ref.Vstar, rtol=1e-6)


# -- the warm rebuild and the rebuild service on the card ---------------------

_DI_ARGS = (("N", 3), ("theta_box", 1.5))


def _di_cfg(backend, eps_a=0.3):
    from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig

    return PartitionConfig(problem="double_integrator",
                           problem_args=_DI_ARGS, eps_a=eps_a,
                           backend=backend, batch_simplices=128)


def test_unchanged_rebuild_on_the_card_is_the_prior(gpu):
    """The tier-1 fixture of the rebuild tests, on the card: the sweep's
    oracle queries launch the IPM leg kernel, and the unchanged rebuild
    is bitwise its prior with no subdivision solve."""
    from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
        build_partition)
    from explicit_hybrid_mpc_tpu_torch.partition.rebuild import warm_rebuild

    problem = make("double_integrator", **dict(_DI_ARGS))
    prior = build_partition(problem, _di_cfg("cuda"))
    before = ipm_leg.launches
    res = warm_rebuild(problem, _di_cfg("cuda"), prior.tree)
    assert ipm_leg.launches > before
    st = res.stats
    assert st["subdivision_solves"] == 0 and st["recert_solves"] > 0
    assert st["rebuild_reuse_frac"] == 1.0 and st["device_failures"] == 0
    a, b = prior.tree.__getstate__(), res.tree.__getstate__()
    for k in a:
        if k != "provenance":
            va, vb = a[k], b[k]
            assert (np.array_equal(va, vb) if isinstance(va, np.ndarray)
                    else va == vb), k


def test_tightened_rebuild_on_the_card_is_the_cpu_rebuild(gpu):
    """eps_a 0.3 -> 0.15 from the same fixture: the card's rebuilt tree
    is node-for-node the port's CPU rebuild (which test_torch_rebuild.py
    holds to the JAX package)."""
    from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
        build_partition)
    from explicit_hybrid_mpc_tpu_torch.partition.rebuild import warm_rebuild

    problem = make("double_integrator", **dict(_DI_ARGS))
    res = {}
    for backend in ("cuda", "cpu"):
        prior = build_partition(problem, _di_cfg(backend))
        res[backend] = warm_rebuild(problem, _di_cfg(backend, 0.15),
                                    prior.tree)
    for k in ("regions", "uncertified", "subdivision_solves",
              "recert_solves", "rebuild_reuse_frac"):
        assert res["cuda"].stats[k] == res["cpu"].stats[k], k
    assert res["cuda"].stats["device_failures"] == 0
    assert _tree_signature(res["cuda"]) == _tree_signature(res["cpu"])


def test_rebuild_service_on_the_card_swaps_under_load(gpu, tmp_path):
    """RebuildService with the build and the registry on the card: two
    drift generations (full, then delta) swap in while 4 threads submit;
    0 failures, 0 dropped, 0 torn (every result bitwise equal to a fresh
    load of its version's artifact on the card)."""
    import threading

    from explicit_hybrid_mpc_tpu_torch.lifecycle import (DriftSource,
                                                         LifecycleConfig,
                                                         RebuildService)
    from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
        build_partition)
    from explicit_hybrid_mpc_tpu_torch.serve.registry import (
        ControllerRegistry)
    from explicit_hybrid_mpc_tpu_torch.serve.scheduler import (
        RequestScheduler)

    cfg = _di_cfg("cuda")
    prior = build_partition(make("double_integrator", **dict(_DI_ARGS)), cfg)
    reg = ControllerRegistry()
    src = DriftSource("double_integrator", problem_args=_DI_ARGS,
                      controller="di", eps_a=0.3, drift_arg="u_max",
                      drift_frac=0.05, n_revisions=2, seed=5)
    svc = RebuildService(src, cfg, cfg=LifecycleConfig(
        artifacts_root=str(tmp_path)), registry=reg, prior={"di": prior})
    src.gate = (lambda: len(svc.generations) + svc.n_failures
                >= src.n_emitted)
    svc.start()
    assert svc.wait_idle(timeout=300, target_generations=1)
    sched = RequestScheduler(reg, "di", max_batch=32)
    served, dropped = [], []
    stop = threading.Event()

    def load(seed):
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            th = rng.uniform(-1.4, 1.4, size=(4, 2))
            try:
                served.extend(zip(th, sched.submit_batch(th).result(30)))
            except Exception as e:  # noqa: BLE001 -- a drop IS the verdict
                dropped.append(e)

    threads = [threading.Thread(target=load, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    assert svc.wait_idle(timeout=300, target_generations=2)
    stop.set()
    for t in threads:
        t.join(60)
        assert not t.is_alive()
    sched.close()
    svc.close()
    assert svc.n_failures == 0 and not dropped and served
    assert [g["published"] for g in svc.generations] == ["full", "delta"]
    dirs = {g["version"]: g["artifact_dir"] for g in svc.generations}
    torn = 0
    for ver in {r.version for _th, r in served}:
        rows = [(th, r) for th, r in served if r.version == ver]
        ref_reg = ControllerRegistry()
        ref_reg.load_artifacts("ref", ver, dirs[ver])
        with ref_reg.lease("ref") as v:
            ref = v.server.evaluate(np.stack([th for th, _ in rows]))
        torn += sum(not np.array_equal(r.u, np.asarray(ref.u[j]))
                    for j, (_th, r) in enumerate(rows) if r.fallback is None)
    assert torn == 0


def test_serial_oracle_against_the_card(gpu):
    """The serial baseline (one QP a call, in numpy on the host)
    against the card's oracle on 16 flagship thetas: V* to the JAX
    package's bar (rtol 1e-6, atol 1e-8), d* wherever the two best
    commutations are apart by more than it."""
    from explicit_hybrid_mpc_tpu_torch.oracle.bnb import SerialBnB

    problem = make("inverted_pendulum")
    thetas = np.random.default_rng(18).uniform(
        problem.theta_lb, problem.theta_ub, (16, problem.n_theta))
    ser = oracle.Oracle(problem, backend="serial")
    assert ser.device.type == "cpu" and ser.ipm_kernel == "torch"
    before = ipm_leg.launches
    bnb = [SerialBnB(ser).solve_point(th) for th in thetas]
    assert ipm_leg.launches == before
    sol = oracle.Oracle(problem, backend="cuda").solve_vertices(thetas)
    assert ipm_leg.launches > before
    V = np.array([v for v, _d, _n in bnb])
    d = np.array([dd for _v, dd, _n in bnb])
    fin = np.isfinite(sol.Vstar)
    assert np.array_equal(np.isfinite(V), fin)
    np.testing.assert_allclose(V[fin], sol.Vstar[fin], rtol=1e-6, atol=1e-8)
    Vs = np.sort(sol.V, axis=1)
    with np.errstate(invalid="ignore"):
        clear = fin & (Vs[:, 1] - Vs[:, 0] > 1e-8 + 1e-6 * np.abs(Vs[:, 0]))
    assert clear.any()
    np.testing.assert_array_equal(d[clear], sol.dstar[clear])


def test_traced_arena_scheduler_on_the_card_is_bitwise_untraced(gpu):
    """ServeConfig(tracing='on') through the arena kernel: every ticket's
    phases sum to its wall, and every result is bitwise the untraced
    run's on the same requests."""
    from explicit_hybrid_mpc_tpu_torch.config import ServeConfig
    from explicit_hybrid_mpc_tpu_torch.obs import Obs
    from explicit_hybrid_mpc_tpu_torch.obs.reqtrace import (
        PHASES, trace_from_serve_config)
    from explicit_hybrid_mpc_tpu_torch.online import fused
    from explicit_hybrid_mpc_tpu_torch.serve import (ArenaScheduler,
                                                     DeviceArena,
                                                     FallbackPolicy)

    rng = np.random.default_rng(9)
    tabs = {n: _grid_table(rng, L) for n, L in (("a", 300), ("b", 77))}
    box = (np.zeros(2), np.full(2, 18.0))
    th = rng.uniform(-1, 19, (400, 2))
    out = {}
    for mode in ("off", "on"):
        o = Obs("jsonl")
        tr = trace_from_serve_config(ServeConfig(tracing=mode), obs=o)
        arena = DeviceArena(p=2, n_u=1, capacity_cols=1024, device=gpu)
        for n, t in tabs.items():
            arena.publish(n, "v1", t, *box)
        before = fused.launches
        with ArenaScheduler(arena, max_batch=64, max_wait_us=500.0,
                            fallback=FallbackPolicy(*box), obs=o,
                            trace=tr) as sched:
            tickets = [sched.submit("ab"[i % 2], q)
                       for i, q in enumerate(th)]
            out[mode] = [t.result(30.0)[0] for t in tickets]
        assert fused.launches - before == sched.n_batches > 0
        assert (sched.trace is None) == (mode == "off")
    for a, b in zip(out["off"], out["on"]):
        assert np.array_equal(a.u, b.u) and a.cost == b.cost
        assert (a.leaf, a.inside, a.fallback) == (b.leaf, b.inside,
                                                  b.fallback)
    hists = o.metrics.snapshot()["histograms"]
    for n in ("a", "b"):
        h = {p: hists[f"serve.ctl.{n}.phase.{p}_us"] for p in
             (*PHASES, "wall")}
        assert h["wall"]["count"] == 200
        assert abs(sum(h[p]["sum"] for p in PHASES) - h["wall"]["sum"]) \
            <= 1e-3 * h["wall"]["count"]


def test_profiled_build_on_the_card_names_ipm_leg_fixed(gpu, tmp_path):
    """`main --profile` on the card: the torch.profiler trace's device
    ops name K1's register-path kernel, and the tree is the unprofiled
    build's."""
    from explicit_hybrid_mpc_tpu_torch import main as tmain
    from explicit_hybrid_mpc_tpu_torch.obs.profiling import summarize_trace
    from explicit_hybrid_mpc_tpu_torch.partition.tree import Tree

    argv = ["-e", "double_integrator", "--problem-arg", "N=3",
            "--problem-arg", "theta_box=1.5", "-a", "0.5", "--batch", "64",
            "--max-depth", "20"]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    tdir = str(tmp_path / "trace")
    assert tmain.main([*argv, "-o", a]) == 0
    assert tmain.main([*argv, "-o", b, "--profile", tdir,
                       "--profile-steps", "3"]) == 0
    s = summarize_trace(tdir, top_n=50)
    assert any("ipm_leg_fixed" in op["name"] for op in s["device_ops_ms"])
    ta, tb = Tree.load(a + ".tree.pkl"), Tree.load(b + ".tree.pkl")
    assert len(ta) == len(tb)
    assert all(np.array_equal(ta.vertices[n], tb.vertices[n])
               for n in range(len(ta)))


def test_quadrotor_pv_pruned_build_on_the_card(gpu):
    """--prune-rows on the quadrotor's published sub-box: the card's
    PrunedOracle keeps the JAX package's masks (chip_smoke.PRUNE_MASKS,
    held to the JAX package by tests/test_torch_chip_smoke.py), its
    reduced point QPs (60, 49) launch the kernel, and the build gives
    the reference's 1,208 regions within 2%."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke

    from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
    from explicit_hybrid_mpc_tpu_torch.oracle.prune import PrunedOracle
    from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
        build_partition, make_oracle)

    kw = (("param", "pv"), ("pos_box", 0.4), ("vel_box", 0.2))
    prob = make("quadrotor", **dict(kw))
    cfg = PartitionConfig(problem="quadrotor", problem_args=kw, eps_a=1.0,
                          eps_r=0.1, prune_rows=True)
    o = make_oracle(prob, cfg)
    assert isinstance(o, PrunedOracle) and o.device.type == "cuda"
    digest, rows, nvars, shape = chip_smoke.PRUNE_MASKS["quadrotor"]
    assert chip_smoke.mask_digest(o.row_keep, o.var_keep) == digest
    assert (int(o.row_keep.sum()), int(o.var_keep.sum()),
            o.reduced_shape) == (rows, nvars, tuple(shape))
    shapes = []
    real = ipm_leg.ipm_leg_cuda
    ipm_leg.ipm_leg_cuda = chip_smoke.record_legs(real, shapes)
    try:
        res = build_partition(prob, cfg, oracle=o)
    finally:
        ipm_leg.ipm_leg_cuda = real
    assert any((nz, nc) == tuple(shape) for _k, nz, nc, _it in shapes)
    st = res.stats
    assert st["device_failures"] == 0 and not st["truncated"]
    assert abs(st["regions"] - 1208) <= 0.02 * 1208
    assert st["uncertified"] <= 5


def test_pruned_oracle_on_the_card_matches_the_cpu(gpu):
    """The satellite 4c box's PrunedOracle on the card and on the CPU:
    the same masks, commutation choices and values."""
    from explicit_hybrid_mpc_tpu_torch.oracle.prune import PrunedOracle

    prob = make("satellite", axes=3, omega_box=0.03, h_box=0.3)
    card = PrunedOracle(prob, backend="cuda")
    cpu = PrunedOracle(prob, backend="cpu")
    assert np.array_equal(card.row_keep, cpu.row_keep)
    assert np.array_equal(card.var_keep, cpu.var_keep)
    th = np.random.default_rng(3).uniform(prob.theta_lb, prob.theta_ub,
                                          (64, prob.n_theta))
    before = ipm_leg.launches
    a, b = card.solve_vertices(th), cpu.solve_vertices(th)
    assert ipm_leg.launches > before
    np.testing.assert_array_equal(a.dstar, b.dstar)
    np.testing.assert_allclose(a.Vstar, b.Vstar, rtol=1e-6, atol=1e-8)


def test_soc_oracle_on_the_card_matches_the_cpu(gpu):
    """SOCOracle on the card against the CPU at 8 thetas of the
    satellite_soc 4c box: converged masks and commutation choices equal,
    V* to 1e-6 relative; the SOC solves' linear QPs launch the kernel."""
    from explicit_hybrid_mpc_tpu_torch.oracle.soc_oracle import SOCOracle

    prob = make("satellite_soc", N=3, h_box=0.3, omega_box=0.03)
    th = np.random.default_rng(17).uniform(prob.theta_lb, prob.theta_ub,
                                           (8, prob.n_theta))
    before = ipm_leg.launches
    a = SOCOracle(prob).solve_vertices(th)
    assert ipm_leg.launches > before
    b = SOCOracle(prob, backend="cpu").solve_vertices(th)
    np.testing.assert_array_equal(a.conv, b.conv)
    np.testing.assert_array_equal(a.dstar, b.dstar)
    np.testing.assert_allclose(a.Vstar, b.Vstar, rtol=1e-6, atol=1e-8)


#: The forced-divergence problems of chip_smoke.py phase 18a, one per K1
#: path: (problem, constructor args).
_DIAG = {"register": ("inverted_pendulum", {}),
         "general": ("satellite", {"axes": 3, "omega_box": 0.03,
                                   "h_box": 0.3}),
         "large": ("quadrotor", {"param": "pv", "pos_box": 0.4,
                                 "vel_box": 0.2})}


@pytest.fixture(scope="module")
def diag_bundles(gpu, tmp_path_factory):
    """One diverged_cells bundle per K1 path: Oracle(n_iter=2) on the card
    over 256 seeded (theta, delta) cells, with a flight recorder."""
    from explicit_hybrid_mpc_tpu_torch.obs.recorder import FlightRecorder

    d = tmp_path_factory.mktemp("diag")
    out = {}
    for path, (name, kw) in _DIAG.items():
        prob = make(name, **kw)
        rec = FlightRecorder(str(d / path))
        orc = oracle.Oracle(prob, backend="cuda", n_iter=2)
        orc.recorder = rec
        g = np.random.default_rng(18)
        th = g.uniform(prob.theta_lb, prob.theta_ub,
                       (256, prob.canonical.n_theta))
        orc.solve_pairs(th, g.integers(0, prob.canonical.n_delta, 256))
        assert len(rec.bundles) == 1 and rec.n_capture_errors == 0
        out[path] = rec.bundles[0]
    return out


@pytest.mark.parametrize("path", sorted(_DIAG))
def test_diverged_bundle_replays_bitwise_on_the_card(diag_bundles, path):
    from explicit_hybrid_mpc_tpu_torch.obs import replay

    n0 = ipm_leg.launches
    rep = replay.replay_bundle(diag_bundles[path])  # the card by default
    assert ipm_leg.launches > n0
    assert rep["ok"] and rep["same_platform"]
    assert rep["conv_match"] and rep["feas_match"] and rep["V_bitwise"]


@pytest.mark.parametrize("path", sorted(_DIAG))
def test_kernel_only_probe_on_the_card_agrees(diag_bundles, path):
    from explicit_hybrid_mpc_tpu_torch.obs import replay

    n0 = ipm_leg.launches
    rep = replay.replay_bundle(diag_bundles[path], kernel_only=True,
                               kernel="cuda")
    assert ipm_leg.launches > n0
    assert rep["kernel_vs_obs_conv_match"]
    plain = replay.replay_bundle(diag_bundles[path], kernel_only=True,
                                 kernel="torch")
    assert plain["kernel_vs_obs_conv_match"]


# -- the demand hub's re-solves and the demand-ordered rebuild on the card ----


def test_demand_hub_drain_on_the_card_matches_the_plain_oracle(gpu):
    """The hub's suboptimality drain through an Oracle on the card
    (K1, launched from the calling thread): the folded V_served - V*
    equal the same hub's drain through the CPU oracle (V* to 1e-9
    relative), with no demand.error event and K1 launched."""
    from explicit_hybrid_mpc_tpu_torch.obs import Obs
    from explicit_hybrid_mpc_tpu_torch.obs.demand import DemandHub

    prob = make("double_integrator", **dict(_DI_ARGS))
    rng = np.random.default_rng(19)
    thetas = rng.uniform(prob.theta_lb, prob.theta_ub, (256, 2))
    costs = rng.uniform(0, 50, 256)
    folded = {}
    for backend in ("cuda", "cpu"):
        o = Obs("jsonl")
        hub = DemandHub(mode="on", subopt_frac=1 / 4, obs=o,
                        oracle=oracle.Oracle(prob, backend=backend),
                        clock=lambda: 0.0)
        hub.record("di", thetas, np.zeros(256, dtype=np.int64), None,
                   np.ones(256, dtype=bool), costs)
        before = ipm_leg.launches
        hub.drain_for_test()
        torch.cuda.synchronize()
        if backend == "cuda":
            assert ipm_leg.launches > before
        folded[backend] = np.asarray(hub._ctl["di"].subopt._roll)
        hub.close(snapshot=False)
        assert not [r for r in o.sink.records
                    if r.get("name") == "demand.error"]
    assert folded["cuda"].size == folded["cpu"].size > 0
    assert (np.abs(folded["cuda"] - folded["cpu"])
            <= 1e-9 * (1 + np.abs(costs).max())).all()


def test_prioritized_rebuild_on_the_card_is_bit_identical(gpu):
    """The JAX tests' depth-capped case on the card (double_integrator
    N=3, theta_box 1.5, eps_a 0.3, max_depth 6): the hinted rebuild puts
    the hot leaves first and its tree is node for node the unhinted
    one's."""
    from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
    from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
        build_partition)
    from explicit_hybrid_mpc_tpu_torch.partition.rebuild import warm_rebuild

    problem = make("double_integrator", **dict(_DI_ARGS))
    cfg = PartitionConfig(problem="double_integrator", problem_args=_DI_ARGS,
                          eps_a=0.3, backend="cuda", batch_simplices=128,
                          max_depth=6)
    prior = build_partition(problem, cfg)
    ra = warm_rebuild(problem, cfg, prior)
    order = ra.stats["rebuild_priority_order"]
    assert ra.stats["rebuild_leaves_invalidated"] > 3
    hot = [order[-1], order[3]]
    rb = warm_rebuild(problem, cfg, prior, priority={hot[0]: 100.0,
                                                     hot[1]: 40.0})
    assert rb.stats["rebuild_priority_order"][:2] == hot
    assert rb.stats["device_failures"] == 0
    sa, sb = ra.tree.__getstate__(), rb.tree.__getstate__()
    for k in ("children", "parent", "depth", "leaf_flags", "normal",
              "offset", "split_edge", "n", "n_regions"):
        assert np.array_equal(sa[k], sb[k]), k
    ta, tb = export.export_leaves(ra.tree), export.export_leaves(rb.tree)
    for name, va, vb in zip(ta._fields, ta, tb):
        assert (np.array_equal(va, vb) if isinstance(va, np.ndarray)
                else va == vb), name


# -- the solve mesh and the sharded frontier on the card ---------------------


@pytest.mark.parametrize("shape", [(1, 1), (2, 1), (1, 2), (2, 2)])
def test_mesh_solver_on_the_card_matches_the_dense_grid(gpu, shape):
    """MeshSolver on the flagship's 32 commutations (cuda:0 repeated
    where the machine has one card, else distinct cards): d*, conv and
    feas equal to the dense grid program's, the converged cells' floats
    and V* to 1e-9, each block launching K1 once."""
    import math

    from explicit_hybrid_mpc_tpu_torch.parallel.mesh import (MeshSolver,
                                                             make_mesh)

    problem = make("inverted_pendulum")
    ora = oracle.Oracle(problem, backend="cuda", two_phase=False,
                        warm_start=False)
    th = np.random.default_rng(20).uniform(problem.theta_lb,
                                           problem.theta_ub, (256, 2))
    dense = [t.cpu().numpy() for t in oracle._solve_points_grid(
        ora.prob, torch.as_tensor(th, device=gpu), ora.point_n_iter)[:8]]
    k = math.prod(shape)
    n = torch.cuda.device_count()
    devs = [torch.device("cuda", i % n) for i in range(k)]
    ms = MeshSolver(ora.prob, make_mesh(shape, devs), ora.point_n_iter)
    before = ipm_leg.launches
    got = [t.cpu().numpy() for t in ms(th)]
    assert ipm_leg.launches - before == k
    conv = dense[1]
    for j in (1, 2, 7):
        np.testing.assert_array_equal(dense[j], got[j])
    for j in (0, 3, 4, 5):
        np.testing.assert_allclose(got[j][conv], dense[j][conv],
                                   rtol=1e-9, atol=1e-9)
    fin = np.isfinite(dense[6])
    np.testing.assert_array_equal(fin, np.isfinite(got[6]))
    np.testing.assert_allclose(got[6][fin], dense[6][fin], rtol=1e-9,
                               atol=1e-9)


def test_mesh_build_on_the_card_is_the_plain_build(gpu):
    """The tier-1 DI build with the vertex grid on a (2, 1) mesh of the
    card(s) is the plain card build's tree, node for node."""
    from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
    from explicit_hybrid_mpc_tpu_torch.parallel.mesh import make_mesh
    from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
        build_partition)

    prob = make("double_integrator", N=3, theta_box=1.5)
    cfg = PartitionConfig(problem="double_integrator",
                          problem_args=(("N", 3), ("theta_box", 1.5)),
                          eps_a=0.5, batch_simplices=64, max_depth=20)
    n = torch.cuda.device_count()
    mesh = make_mesh((2, 1), [torch.device("cuda", i % n)
                              for i in range(2)])
    plain = build_partition(prob, cfg)
    got = build_partition(prob, cfg, oracle=oracle.Oracle(prob, mesh=mesh))
    assert [v.tobytes() for v in got.tree.vertices] \
        == [v.tobytes() for v in plain.tree.vertices]


def test_cli_mesh_wider_than_the_cards_raises(gpu):
    """--mesh D on the card takes D distinct cards and names the count
    where fewer exist (no silent reuse of a card, no CPU fallback)."""
    from explicit_hybrid_mpc_tpu_torch.parallel.mesh import cli_mesh

    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"needs {n + 1} devices, have {n}"):
        cli_mesh(n + 1, "cuda")
    assert {d.index for d in cli_mesh(n, "cuda").devices.flat} \
        == set(range(n))
