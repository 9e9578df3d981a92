"""Torch port: the sharded descent server (online/sharded.py), its
device placement (parallel/mesh.py) and the synthetic tree builder
(partition/synthetic.py), held against the JAX package on the same
host tables, on the CPU.

Tolerances: synthetic trees bitwise (both packages run the same
numpy); routing rows and nodes equal on the sampled points (the same
f64 hyperplane tests, tie-free there); u / cost within 1e-8 of the JAX
package's ShardedDescent (both interpolate the same f64 table, summed
in another order) and bitwise within the port."""

import os

import numpy as np
import pytest
import torch

import explicit_hybrid_mpc_tpu  # noqa: F401  (enables x64)
import jax
import jax.numpy as jnp
from explicit_hybrid_mpc_tpu.config import PartitionConfig as JaxConfig
from explicit_hybrid_mpc_tpu.online import descent as jdescent
from explicit_hybrid_mpc_tpu.online import evaluator as jevaluator
from explicit_hybrid_mpc_tpu.online import export as jexport
from explicit_hybrid_mpc_tpu.online import sharded as jsharded
from explicit_hybrid_mpc_tpu.partition import synthetic as jsynthetic
from explicit_hybrid_mpc_tpu.partition.frontier import (
    build_partition as jax_build)
from explicit_hybrid_mpc_tpu.problems.registry import make as jax_make
from explicit_hybrid_mpc_tpu.serve import registry as jregistry
from explicit_hybrid_mpc_tpu_torch import obs as obs_lib
from explicit_hybrid_mpc_tpu_torch.online import (descent, evaluator, export,
                                                  sharded)
from explicit_hybrid_mpc_tpu_torch.parallel.mesh import serving_placement
from explicit_hybrid_mpc_tpu_torch.partition import geometry
from explicit_hybrid_mpc_tpu_torch.partition.synthetic import (
    build_synthetic_tree, leaf_payload)
from explicit_hybrid_mpc_tpu_torch.partition.tree import LeafData, Tree
from explicit_hybrid_mpc_tpu_torch.serve import ControllerRegistry

torch.set_num_threads(1)

CPU = torch.device("cpu")
CPUS = [CPU]


def _port_tree(jtree):
    """The JAX package's tree as the port's Tree (same columnar state)."""
    t = Tree.__new__(Tree)
    t.__setstate__(jtree.__getstate__())
    return t


@pytest.fixture(scope="module")
def built():
    """The tier-1 DI tree (built by the JAX package) and each package's
    host leaf and descent tables of it."""
    jres = jax_build(jax_make("double_integrator", N=3, theta_box=1.5),
                     JaxConfig(problem="double_integrator", eps_a=0.5,
                               backend="cpu", batch_simplices=64,
                               max_depth=20))
    jtable = jexport.export_leaves(jres.tree)
    jdt = jdescent.export_descent(jres.tree, jres.roots, jtable,
                                  stage=False)
    tree = _port_tree(jres.tree)
    table = export.export_leaves(tree)
    dt = descent.export_descent(tree, jres.roots, table, stage=False)
    return dict(jres=jres, jtable=jtable, jdt=jdt, tree=tree,
                roots=jres.roots, table=table, dt=dt)


def _thetas(n, seed, lb=-1.5, ub=1.5, p=2):
    return np.random.default_rng(seed).uniform(lb, ub, size=(n, p))


# -- placement ---------------------------------------------------------------


def test_serving_placement_round_robin():
    devs = [torch.device("cpu"), torch.device("cuda", 0),
            torch.device("cuda", 1)]
    pl = serving_placement(7, devs)
    assert pl == [devs[k % 3] for k in range(7)]
    assert serving_placement(2, CPUS) == CPUS * 2
    with pytest.raises(ValueError):
        serving_placement(0, CPUS)


def test_placement_and_server_default_to_the_gpus(built):
    """devices=None means every CUDA device: without one it raises."""
    with pytest.raises(RuntimeError, match="CUDA"):
        serving_placement(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        sharded.shard_descent(built["dt"], built["table"], n_shards=2)


# -- against the JAX package -------------------------------------------------


@pytest.mark.parametrize("n_shards", [1, 4])
def test_sharded_matches_the_jax_package(built, n_shards):
    th = _thetas(257, 0)
    ref = jsharded.shard_descent(built["jdt"], built["jtable"],
                                 n_shards=n_shards).evaluate(th)
    srv = sharded.shard_descent(built["dt"], built["table"],
                                n_shards=n_shards, devices=CPUS)
    out = srv.evaluate(th)
    assert np.array_equal(out.inside, np.asarray(ref.inside))
    assert out.inside.all()
    assert np.array_equal(out.leaf, np.asarray(ref.leaf))
    np.testing.assert_allclose(out.u, np.asarray(ref.u), atol=1e-8)
    np.testing.assert_allclose(out.cost, np.asarray(ref.cost), atol=1e-8)
    assert srv.cut_depth == jsharded.shard_descent(
        built["jdt"], built["jtable"], n_shards=n_shards).cut_depth


def test_sharded_matches_flat_descent_rows_and_nodes(built):
    """Values equal the flat descent path's, and so do the routing rows
    and nodes (this partition has no shared-facet tie at the sampled
    points); leaf ids are GLOBAL table rows."""
    th = _thetas(257, 1)
    table, dt = built["table"], built["dt"]
    srv = sharded.shard_descent(dt, table, n_shards=4, devices=CPUS)
    flat = descent.evaluate_descent(descent.stage_table(dt, CPU),
                                    evaluator.stage(table, device=CPU),
                                    torch.as_tensor(th))
    out = srv.evaluate(th)
    assert np.array_equal(out.inside, flat.inside.numpy())
    np.testing.assert_allclose(out.u, flat.u.numpy(), atol=1e-12)
    np.testing.assert_allclose(out.cost, flat.cost.numpy(), atol=1e-12)
    rows, nodes = srv.locate(th)
    frow, fnode = descent.locate_descent(descent.stage_table(dt, CPU),
                                         torch.as_tensor(th))
    assert np.array_equal(rows, frow.numpy())
    assert np.array_equal(nodes, fnode.numpy())
    assert np.array_equal(table.node_id[rows], fnode.numpy())
    jrows, jnodes = jsharded.shard_descent(
        built["jdt"], built["jtable"], n_shards=4).locate(th)
    assert np.array_equal(rows, np.asarray(jrows))
    assert np.array_equal(nodes, np.asarray(jnodes))


def test_sharded_outside_flagged(built):
    srv = sharded.shard_descent(built["dt"], built["table"], n_shards=4,
                                devices=CPUS)
    out = srv.evaluate(np.asarray([[10.0, 10.0], [0.1, 0.1]]))
    assert list(out.inside) == [False, True]


def test_shards_are_balanced_and_cover(built):
    table = built["table"]
    srv = sharded.shard_descent(built["dt"], table, n_shards=4,
                                devices=CPUS)
    ref = jsharded.shard_descent(built["jdt"], built["jtable"], n_shards=4)
    sizes = srv.shard_sizes()
    assert sizes == ref.shard_sizes()
    assert sum(sizes) == table.n_leaves == srv.n_leaves
    assert max(sizes) <= 2 * max(1, table.n_leaves // 4)
    got = np.sort(np.concatenate([s["rows_global"] for s in srv._shards
                                  if s is not None]))
    assert np.array_equal(got, np.arange(table.n_leaves))
    nb = srv.device_bytes()
    assert nb["leaves"] == sum(a.nbytes for a in (
        table.bary_M, table.U, table.V))
    assert nb["descent"] > 0


def test_serving_from_jax_written_artifacts(built, tmp_path):
    """The serving path needs only the exported artifacts, and the port
    serves the JAX package's files: same rows and values as the JAX
    package's server loaded from the same directory."""
    d = str(tmp_path / "art")
    jregistry.save_artifacts(built["jres"].tree, built["roots"], d)
    t2 = export.load_leaf_table(d)
    dt2 = descent.load_descent(os.path.join(d, "descent.npz"))
    th = _thetas(64, 2)
    srv = sharded.shard_descent(dt2, t2, n_shards=3, devices=CPUS)
    out = srv.evaluate(th)
    ref = sharded.shard_descent(built["dt"], built["table"], n_shards=3,
                                devices=CPUS).evaluate(th)
    assert out.u.tobytes() == ref.u.tobytes()
    assert np.array_equal(out.leaf, ref.leaf)
    jreg = jregistry.ControllerRegistry()
    jref = jreg.load_artifacts("c", "v1", d, n_shards=3).server.evaluate(th)
    reg = ControllerRegistry()
    ver = reg.load_artifacts("c", "v1", d, n_shards=3, devices=CPUS)
    got = ver.server.evaluate(th)
    assert np.array_equal(got.leaf, np.asarray(jref.leaf))
    np.testing.assert_allclose(got.u, np.asarray(jref.u), atol=1e-8)


def test_sharded_with_kuhn_router():
    """Analytic root routing on a synthetic box tree: same rows as the
    brute-scan server and as the JAX package's routed server, values
    matching the flat path."""
    tree, roots = build_synthetic_tree(p=3, depth=6, n_u=2)
    table = export.export_leaves(tree)
    dt = descent.export_descent(tree, roots, table, stage=False)
    router = geometry.kuhn_root_locator(np.zeros(3), np.ones(3))
    th = _thetas(300, 3, 0.0, 1.0, 3)
    a = sharded.shard_descent(dt, table, n_shards=5,
                              devices=CPUS).evaluate(th)
    b = sharded.shard_descent(dt, table, n_shards=5, router=router,
                              devices=CPUS).evaluate(th)
    assert np.array_equal(a.leaf, b.leaf)
    assert a.u.tobytes() == b.u.tobytes()
    assert a.inside.all()
    jtree, jroots = jsynthetic.build_synthetic_tree(p=3, depth=6, n_u=2)
    jtable = jexport.export_leaves(jtree)
    jref = jsharded.shard_descent(
        jdescent.export_descent(jtree, jroots, jtable, stage=False),
        jtable, n_shards=5, router=router).evaluate(th)
    assert np.array_equal(b.leaf, np.asarray(jref.leaf))
    np.testing.assert_allclose(b.u, np.asarray(jref.u), atol=1e-8)
    flat = descent.evaluate_descent(descent.stage_table(dt, CPU),
                                    evaluator.stage(table, device=CPU),
                                    torch.as_tensor(th))
    np.testing.assert_allclose(b.u, flat.u.numpy(), atol=1e-9)


def _half_hole_tree():
    """p=1: the left half certified, the right half payload-free."""
    t = Tree(p=1, n_u=1)
    r = t.add_root(np.array([[0.0], [1.0]]))
    left, right, i, j, _ = geometry.bisect(t.vertices[r])
    li, ri = t.split(r, left, right, (i, j))
    t.set_leaf(li, LeafData(delta_idx=0, vertex_inputs=np.ones((2, 1)),
                            vertex_costs=np.zeros(2)))
    return t, [r], ri


def test_payload_free_shard_flags_outside():
    """A shard covering only payload-free subtrees keeps one zero row:
    its queries come back outside with row -1, as in the JAX package."""
    t, roots, ri = _half_hole_tree()
    table = export.export_leaves(t)
    dt = descent.export_descent(t, roots, table, stage=False)
    srv = sharded.shard_descent(dt, table, n_shards=2, granularity=1,
                                devices=CPUS)
    assert srv.shard_sizes() == [1, 0] or srv.shard_sizes() == [0, 1]
    out = srv.evaluate(np.array([[0.25], [0.75]]))
    assert bool(out.inside[0]) and not bool(out.inside[1])
    assert out.leaf[0] == 0 and out.leaf[1] == -1
    rows, nodes = srv.locate(np.array([[0.75]]))
    assert rows[0] == -1 and nodes[0] == ri
    jt = jexport.export_leaves(_jax_half_hole())
    jref = jsharded.shard_descent(
        jdescent.export_descent(_jax_half_hole(), roots, jt, stage=False),
        jt, n_shards=2, granularity=1).evaluate(np.array([[0.25], [0.75]]))
    assert np.array_equal(out.leaf, np.asarray(jref.leaf))
    assert np.array_equal(out.inside, np.asarray(jref.inside))


def _jax_half_hole():
    from explicit_hybrid_mpc_tpu.partition import geometry as jgeom
    from explicit_hybrid_mpc_tpu.partition.tree import LeafData as JLD
    from explicit_hybrid_mpc_tpu.partition.tree import Tree as JTree

    t = JTree(p=1, n_u=1)
    r = t.add_root(np.array([[0.0], [1.0]]))
    left, right, i, j, _ = jgeom.bisect(t.vertices[r])
    li, _ri = t.split(r, left, right, (i, j))
    t.set_leaf(li, JLD(delta_idx=0, vertex_inputs=np.ones((2, 1)),
                       vertex_costs=np.zeros(2)))
    return t


def test_oversized_batch_splits_and_reports():
    """A batch beyond max_bucket is split to the max bucket -- results
    identical to the uncapped server -- with a health.oversized_batch
    event and the serve.oversized_batches counter, as in the JAX
    package."""
    tree, roots = build_synthetic_tree(p=2, depth=6, n_u=2)
    table = export.export_leaves(tree)
    dt = descent.export_descent(tree, roots, table, stage=False)
    o = obs_lib.Obs("jsonl")
    cap = sharded.shard_descent(dt, table, n_shards=2, obs=o,
                                max_bucket=16, devices=CPUS)
    ref = sharded.shard_descent(dt, table, n_shards=2, devices=CPUS)
    th = _thetas(70, 4, 0.0, 1.0)
    a, b = cap.evaluate(th), ref.evaluate(th)
    for f in ("u", "cost", "leaf", "inside"):
        assert getattr(a, f).tobytes() == getattr(b, f).tobytes()
    rc, nc = cap.locate(th)
    rr, nr = ref.locate(th)
    assert np.array_equal(rc, rr) and np.array_equal(nc, nr)
    evs = [r for r in o.sink.records
           if r.get("name") == "health.oversized_batch"]
    assert len(evs) == 2
    assert evs[0]["severity"] == "warn"
    assert evs[0]["value"] == 70 and evs[0]["threshold"] == 16
    snap = o.metrics.snapshot()
    assert snap["counters"]["serve.oversized_batches"] == 2
    assert snap["counters"]["serve.queries"] == 70
    assert snap["gauges"]["serve.shards"] == 2
    assert any(r.get("name") == "serve.sharded" for r in o.sink.records)
    for bad in (24, 4):
        with pytest.raises(ValueError):
            sharded.shard_descent(dt, table, max_bucket=bad, devices=CPUS)
    o.close()


def test_bucket_and_cut_helpers_match_the_jax_package(built):
    for n in (1, 7, 8, 9, 100, 1 << 14):
        assert sharded._bucket(n) == jsharded._bucket(n)
    ch = np.asarray(built["dt"].children)
    rn = np.asarray(built["dt"].root_node)
    for target in (1, 8, 32):
        a, ka = sharded._find_cut(ch, rn, target)
        b, kb = jsharded._find_cut(ch, rn, target)
        assert np.array_equal(a, b) and ka == kb
        assert np.array_equal(sharded._subtree_owners(ch, a),
                              jsharded._subtree_owners(ch, b))
    counts = np.random.default_rng(5).integers(0, 50, 40)
    assert np.array_equal(sharded._balance(counts, 6),
                          jsharded._balance(counts, 6))


# -- synthetic trees ---------------------------------------------------------


#: The columnar arrays: per node (the first len(tree) rows are live) and
#: per payload slot (the first _n_slots rows).
_NODE_COLUMNS = ("_vertices", "_parent", "_depth", "_children",
                 "_split_edge", "_normal", "_offset", "_leaf_slot",
                 "_leaf_flags")
_SLOT_COLUMNS = ("_pl_delta", "_pl_inputs", "_pl_costs")


@pytest.mark.parametrize("p,depth,n_u", [(1, 4, 1), (2, 5, 2), (3, 4, 1)])
def test_synthetic_tree_is_bitwise_the_jax_packages(p, depth, n_u):
    a, ra = build_synthetic_tree(p=p, depth=depth, n_u=n_u)
    b, rb = jsynthetic.build_synthetic_tree(p=p, depth=depth, n_u=n_u)
    assert ra == rb and len(a) == len(b)
    assert a.max_depth() == b.max_depth() == depth
    assert (a._n_slots, a._n_regions) == (b._n_slots, b._n_regions)
    for cols, n in ((_NODE_COLUMNS, len(a)), (_SLOT_COLUMNS, a._n_slots)):
        for col in cols:
            x, y = getattr(a, col)[:n], getattr(b, col)[:n]
            assert x.dtype == y.dtype and x.shape == y.shape, col
            assert x.tobytes() == y.tobytes(), col
    U, c = leaf_payload(a.vertices[:3], n_u)
    jU, jc = jsynthetic.leaf_payload(b.vertices[:3], n_u)
    assert U.tobytes() == jU.tobytes() and c.tobytes() == jc.tobytes()


def test_synthetic_tree_matches_split_loop():
    """The builder's own contract: bit-identical to the same tree grown
    through geometry.bisect + Tree.split + Tree.set_leaf."""
    p, depth, n_u = 2, 5, 2
    t_vec, roots = build_synthetic_tree(p=p, depth=depth, n_u=n_u,
                                        lb=[0.0, -1.0], ub=[2.0, 1.0])
    t_loop = Tree(p=p, n_u=n_u)
    frontier = [t_loop.add_root(V) for V in geometry.box_triangulation(
        np.array([0.0, -1.0]), np.array([2.0, 1.0]))]
    assert frontier == roots
    for _ in range(depth):
        nxt = []
        for n in frontier:
            left, right, i, j, _ = geometry.bisect(t_loop.vertices[n])
            nxt.extend(t_loop.split(n, left, right, (i, j)))
        frontier = nxt
    for n in frontier:
        U, c = leaf_payload(t_loop.vertices[n][None], n_u)
        t_loop.set_leaf(n, LeafData(delta_idx=0, vertex_inputs=U[0],
                                    vertex_costs=c[0]))
    for f in ("vertices", "children", "parent", "split_edge",
              "split_normals", "split_offsets"):
        assert np.array_equal(getattr(t_vec, f), getattr(t_loop, f)), f
    ids = t_vec.converged_leaf_ids()
    assert np.array_equal(ids, t_loop.converged_leaf_ids())
    for x, y in zip(t_vec.leaf_payloads(ids), t_loop.leaf_payloads(ids)):
        assert np.array_equal(x, y)


def test_flat_descent_of_jax_tables_unchanged(built):
    """The JAX package's flat descent and the port's agree on the DI
    tables the sharded tests use (values to 1e-8)."""
    th = _thetas(128, 6)
    ref = jdescent.evaluate_descent(
        jax.tree_util.tree_map(jnp.asarray, built["jdt"]),
        jevaluator.stage(built["jtable"]), jnp.asarray(th))
    got = descent.evaluate_descent(descent.stage_table(built["dt"], CPU),
                                   evaluator.stage(built["table"],
                                                   device=CPU),
                                   torch.as_tensor(th))
    np.testing.assert_allclose(got.u.numpy(), np.asarray(ref.u), atol=1e-8)
    assert np.array_equal(got.inside.numpy(), np.asarray(ref.inside))


def test_warm_makes_every_capture_a_skewed_batch_needs(built, monkeypatch):
    """ShardedDescent.warm(max_batch) runs every (program, shard, bucket)
    first call: with the graph path forced on the CPU (a stand-in graph
    that counts its captures and replays eagerly), batches routed all to
    one shard, or split unevenly, capture nothing after it, and serve
    the same values as an unwarmed server's."""
    captured: list = []

    class _Counted:
        def __init__(self, fn, inputs):
            captured.append(tuple(t.shape for t in inputs))
            self.fn = fn

        def __call__(self, inputs):
            return self.fn(*inputs)

    plain = sharded.shard_descent(built["dt"], built["table"], n_shards=2,
                                  devices=CPUS)
    th = _thetas(512, 11)
    shard = plain._r_shard[plain._route(th, {})]
    assert (shard == 0).any() and (shard == 1).any()
    batches = [th[shard == 0][:k] for k in (1, 9, 17, 32)]
    batches += [th[shard == 1][:k] for k in (3, 31)]
    batches += [np.concatenate([th[shard == 0][:29], th[shard == 1][:3]])]
    refs = [plain.evaluate(b) for b in batches]
    monkeypatch.setattr(sharded, "_graphable", lambda t: True)
    monkeypatch.setattr(sharded, "_Graphed", _Counted)
    srv = sharded.shard_descent(built["dt"], built["table"], n_shards=2,
                                devices=CPUS)
    n = srv.warm(32)
    # Buckets 8, 16, 32: the routing descent and both shards' programs.
    assert n == len(captured) == 3 * 3
    for b, ref in zip(batches, refs):
        got = srv.evaluate(b)
        np.testing.assert_array_equal(got.u, ref.u)
        np.testing.assert_array_equal(got.cost, ref.cost)
    assert len(captured) == n
    # Unwarmed, the same batches capture (the route's buckets and each
    # shard's).
    cold = sharded.shard_descent(built["dt"], built["table"], n_shards=2,
                                 devices=CPUS)
    for b in batches:
        cold.evaluate(b)
    assert len(captured) > n
