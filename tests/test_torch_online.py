"""Torch port: leaf-table export/load and online evaluation against the
JAX package.

Point location runs in float32 in both packages (the kernels' plain
versions here); leaf ids are compared on tie-free queries -- points
strictly inside a leaf (barycentric weights >= 0.02), where no shared
face can be resolved either way -- and the f64 interpolation to 1e-9
(absolute) since both interpolate the same float64 table."""

import numpy as np
import pytest
import torch

import explicit_hybrid_mpc_tpu  # noqa: F401  (enables x64)
import jax.numpy as jnp
from explicit_hybrid_mpc_tpu.config import PartitionConfig as JaxConfig
from explicit_hybrid_mpc_tpu.online import evaluator as jevaluator
from explicit_hybrid_mpc_tpu.online import export as jexport
from explicit_hybrid_mpc_tpu.online import pallas_eval
from explicit_hybrid_mpc_tpu.partition.frontier import (
    build_partition as jax_build)
from explicit_hybrid_mpc_tpu.problems.registry import make as jax_make
from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
from explicit_hybrid_mpc_tpu_torch.online import evaluator, export, locate
from explicit_hybrid_mpc_tpu_torch.partition.frontier import build_partition
from explicit_hybrid_mpc_tpu_torch.problems.registry import make

# The suite runs in several worker processes at once: one torch thread
# each keeps these tests from crowding the cores the others time on.
torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def pend():
    """A hybrid (pendulum, p=2) partition built by the port."""
    prob = make("inverted_pendulum", N=2)
    res = build_partition(prob, PartitionConfig(
        problem="inverted_pendulum", problem_args=(("N", 2),),
        backend="cpu", eps_a=0.5, batch_simplices=64, max_depth=14))
    return prob, res, export.export_leaves(res.tree)


def _interior(res, table, n, rng):
    """n query points strictly inside random leaves (every barycentric
    weight >= 0.02)."""
    ids = rng.integers(0, table.n_leaves, n)
    verts = np.stack([res.tree.vertices[i] for i in table.node_id])[ids]
    k = verts.shape[1]
    w = 0.02 + (1.0 - 0.02 * k) * rng.dirichlet(np.ones(k), n)
    return np.einsum("bi,bij->bj", w, verts), ids


def _jax_table(table):
    return jexport.LeafTable(*(np.asarray(a) for a in table))


def test_locate_matches_the_pallas_kernel(pend):
    _prob, res, table = pend
    th, ids = _interior(res, table, 300, np.random.default_rng(0))
    ref_leaf, ref_score = pallas_eval.locate(
        pallas_eval.stage_pallas(_jax_table(table)), jnp.asarray(th),
        interpret=True)
    lt = locate.stage(table, device=CPU)
    leaf, score = locate.locate(lt, torch.as_tensor(th))
    assert leaf.dtype == torch.int32 and score.dtype == torch.float32
    assert np.array_equal(leaf.numpy(), np.asarray(ref_leaf))
    assert np.array_equal(leaf.numpy(), ids)
    np.testing.assert_allclose(score.numpy(), np.asarray(ref_score),
                               atol=1e-5)


def test_evaluate_matches_the_reference_evaluators(pend):
    _prob, res, table = pend
    th, _ids = _interior(res, table, 300, np.random.default_rng(1))
    jt = _jax_table(table)
    ref_pal = pallas_eval.evaluate(
        pallas_eval.stage_pallas(jt), jevaluator.stage(jt),
        jnp.asarray(th), interpret=True)
    ref_f64 = jevaluator.evaluate(jevaluator.stage(jt), jnp.asarray(th))
    dt = evaluator.stage(table, device=CPU)
    got = locate.evaluate(locate.stage(table, device=CPU), dt,
                          torch.as_tensor(th))
    plain = evaluator.evaluate(dt, torch.as_tensor(th))
    for ref in (ref_pal, ref_f64):
        assert np.array_equal(got.leaf.numpy(), np.asarray(ref.leaf))
        np.testing.assert_allclose(got.u.numpy(), np.asarray(ref.u),
                                   atol=1e-9)
        np.testing.assert_allclose(got.cost.numpy(), np.asarray(ref.cost),
                                   atol=1e-9)
    assert np.array_equal(plain.leaf.numpy(), np.asarray(ref_f64.leaf))
    np.testing.assert_allclose(plain.u.numpy(), np.asarray(ref_f64.u),
                               atol=1e-12)
    assert bool(got.inside.all()) and bool(plain.inside.all())
    for k in range(5):
        np.testing.assert_allclose(plain.u.numpy()[k],
                                   evaluator.evaluate_np(table, th[k]),
                                   atol=1e-12)


def test_evaluate_chunking_and_outside_queries(pend, monkeypatch):
    prob, _res, table = pend
    rng = np.random.default_rng(2)
    th = rng.uniform(prob.theta_lb * 1.2, prob.theta_ub * 1.2,
                     (200, prob.n_theta))
    dt = evaluator.stage(table, device=CPU)
    whole = evaluator.evaluate(dt, torch.as_tensor(th))
    monkeypatch.setattr(evaluator, "_CHUNK_ELEMS", 7 * table.n_leaves * 3)
    monkeypatch.setattr(locate, "_CHUNK_ELEMS", 5 * table.n_leaves * 3)
    chunked = evaluator.evaluate(dt, torch.as_tensor(th))
    assert torch.equal(whole.leaf, chunked.leaf)
    assert torch.equal(whole.u, chunked.u)
    assert not bool(whole.inside.all())
    leaf, _ = locate.locate(locate.stage(table, device=CPU),
                            torch.as_tensor(th))
    ref, _ = pallas_eval.locate(pallas_eval.stage_pallas(_jax_table(table)),
                                jnp.asarray(th), interpret=True)
    assert np.array_equal(leaf.numpy(), np.asarray(ref))


def test_load_leaf_table_reads_a_table_the_reference_wrote(tmp_path):
    name, kw = "double_integrator", {"N": 3, "theta_box": 1.5}
    jres = jax_build(jax_make(name, **kw), JaxConfig(
        problem=name, problem_args=tuple(sorted(kw.items())),
        backend="cpu", eps_a=0.5, batch_simplices=64, max_depth=20))
    d = str(tmp_path / "table")
    jexport.write_leaf_table(jres.tree, d)
    ref = jexport.export_leaves(jres.tree)
    got = export.load_leaf_table(d, verify_checksum=True)
    for a, b in zip(got, ref):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    # The port's own build of the same problem exports the same leaves.
    tres = build_partition(make(name, **kw), PartitionConfig(
        problem=name, problem_args=tuple(sorted(kw.items())),
        backend="cpu", eps_a=0.5, batch_simplices=64, max_depth=20))
    mine = export.export_leaves(tres.tree)
    assert mine.bary_M.tobytes() == ref.bary_M.tobytes()
    np.testing.assert_array_equal(mine.delta, ref.delta)
    np.testing.assert_allclose(mine.U, ref.U, atol=1e-8)
    np.testing.assert_allclose(mine.V, ref.V, rtol=1e-8, atol=1e-8)


def test_staging_defaults_to_the_gpu():
    table = export.LeafTable(
        bary_M=np.eye(3)[None].repeat(2, 0), U=np.zeros((2, 3, 1)),
        V=np.zeros((2, 3)), delta=np.zeros(2, dtype=np.int64),
        node_id=np.arange(2))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-GPU path is moot")
    with pytest.raises(RuntimeError, match="CUDA"):
        locate.stage(table)
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluator.stage(table)
    before = locate.launches
    lt = locate.stage(table, device="cpu")
    leaf, score = locate.locate(lt, torch.zeros(4, 2))
    assert locate.launches == before
    assert leaf.tolist() == [0, 0, 0, 0]
    with pytest.raises(ValueError):
        locate.locate_cuda(lt.bary, torch.zeros(4, 2))


def test_nan_queries_are_leaf_0_and_never_inside(pend):
    """A theta with a NaN coordinate (either one, or both) locates to
    leaf 0 and is not inside, in the JAX package (Pallas kernel in
    interpret mode, and its evaluate) and in the port's plain version
    (whose score is NaN: torch.argmax ranks NaN first, the order the
    CUDA kernel follows); a finite row beside them gets the same leaf
    and score from both."""
    _prob, res, table = pend
    th, _ids = _interior(res, table, 1, np.random.default_rng(3))
    nan = np.nan
    thetas = np.array([[nan, 0.1], [0.2, nan], [nan, nan], th[0]])
    jt = _jax_table(table)
    ref_leaf, ref_score = pallas_eval.locate(
        pallas_eval.stage_pallas(jt), jnp.asarray(thetas), interpret=True)
    ref_ev = pallas_eval.evaluate(pallas_eval.stage_pallas(jt),
                                  jevaluator.stage(jt), jnp.asarray(thetas),
                                  interpret=True)
    lt = locate.stage(table, device=CPU)
    leaf, score = locate.locate_torch(lt.bary, torch.as_tensor(thetas))
    got = locate.evaluate(lt, evaluator.stage(table, device=CPU),
                          torch.as_tensor(thetas))
    for lf, ins in ((np.asarray(ref_leaf), np.asarray(ref_ev.inside)),
                    (leaf.numpy(), got.inside.numpy())):
        assert lf[:3].tolist() == [0, 0, 0]
        assert not ins[:3].any() and ins[3]
    assert np.isnan(score.numpy()[:3]).all()
    assert leaf[3] == int(np.asarray(ref_leaf)[3])
    np.testing.assert_allclose(score.numpy()[3], np.asarray(ref_score)[3],
                               atol=1e-5)


@pytest.mark.parametrize("B,L", [(1, 0), (1, 1), (5, 129), (513, 300),
                                 (8192, 11670), (65536, 11670),
                                 (3, 1_000_003)])
def test_plan_splits_cover_the_leaves_once(B, L):
    """The CUDA kernel's leaf splits: contiguous, every leaf in exactly
    one, none under MIN_SPLIT_LEAVES leaves unless the table is smaller,
    and about BLOCKS_PER_SM blocks per SM where the leaves allow."""
    n_sm = 132
    splits, per = locate.plan_splits(B, L, n_sm)
    assert splits >= 1 and splits * per >= L and (splits - 1) * per < max(L, 1)
    covered = np.zeros(L, dtype=int)
    for s in range(splits):
        covered[min(s * per, L):min(s * per + per, L)] += 1
    assert (covered == 1).all()
    assert splits == 1 or per >= locate.MIN_SPLIT_LEAVES
    qblocks = -(-B // locate.BLOCK_QUERIES)
    assert qblocks * splits <= max(qblocks, locate.BLOCKS_PER_SM * n_sm
                                   + qblocks)
    if L >= locate.MIN_SPLIT_LEAVES * 64 and qblocks < 64:
        assert qblocks * splits >= locate.BLOCKS_PER_SM * n_sm
