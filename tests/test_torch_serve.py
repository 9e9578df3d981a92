"""Torch port: the serving path on the CPU -- descent export, serving
artifacts, delta artifacts, the device arena, its scheduler and the
fallback policy -- against the JAX package on the same inputs.

Every test runs the port with ``device="cpu"``, where the arena runs
the fused kernel's plain version (tests/test_torch_fused.py holds that
to the JAX kernel).  Tolerances: host arrays and files bitwise (both
packages run the same numpy); arena leaf/served/clamped exact and
u/cost to 1e-5 against the JAX XLA arena (float32 products summed in
another order); bitwise within the port (the torn-read audit)."""

import json
import os
import threading
from typing import NamedTuple

import numpy as np
import pytest
import torch

import explicit_hybrid_mpc_tpu  # noqa: F401  (enables x64)
import jax.numpy as jnp
from explicit_hybrid_mpc_tpu import config as jconfig
from explicit_hybrid_mpc_tpu.config import PartitionConfig as JaxConfig
from explicit_hybrid_mpc_tpu.lifecycle import delta as jdelta
from explicit_hybrid_mpc_tpu.online import descent as jdescent
from explicit_hybrid_mpc_tpu.online import export as jexport
from explicit_hybrid_mpc_tpu.partition.frontier import (
    build_partition as jax_build)
from explicit_hybrid_mpc_tpu.problems.registry import make as jax_make
from explicit_hybrid_mpc_tpu.serve import DeviceArena as JaxArena
from explicit_hybrid_mpc_tpu.serve import registry as jregistry
from explicit_hybrid_mpc_tpu_torch import config, obs
from explicit_hybrid_mpc_tpu_torch.lifecycle import delta
from explicit_hybrid_mpc_tpu_torch.online import (descent, evaluator, export,
                                                  sharded)
from explicit_hybrid_mpc_tpu_torch.partition import geometry
from explicit_hybrid_mpc_tpu_torch.partition.synthetic import (
    build_synthetic_tree)
from explicit_hybrid_mpc_tpu_torch.partition.tree import LeafData, Tree
from explicit_hybrid_mpc_tpu_torch.serve import (ArenaFull, ArenaScheduler,
                                                 ControllerRegistry,
                                                 DeviceArena, FallbackPolicy,
                                                 RequestScheduler, registry)

torch.set_num_threads(1)

CPU = torch.device("cpu")
#: The tier-1 double-integrator configuration (p = 2, n_u = 1).
DI = ("double_integrator", {"N": 3, "theta_box": 1.5})
_BOX = (np.zeros(2), np.full(2, 8.0))


def _doubled(tree):
    """A v2 generation: half of the used payload slots doubled (exact in
    floating point, so a cross-version read shows bit for bit; the other
    half rides a delta as kept rows)."""
    t = tree.clone()
    n = t._n_slots
    t._pl_inputs[:n // 2] *= 2.0
    t._pl_costs[:n // 2] *= 2.0
    return t


def _port_tree(jtree):
    """The JAX package's tree as the port's Tree (the columnar state is
    the same in both), so both packages export the same inputs."""
    t = Tree.__new__(Tree)
    t.__setstate__(jtree.__getstate__())
    return t


@pytest.fixture(scope="module")
def di(tmp_path_factory):
    """The tier-1 DI tree (built once, by the JAX package) and, written
    by each package, a v1 artifact of it plus a v2 delta against that."""
    name, kw = DI
    jres = jax_build(jax_make(name, **kw), JaxConfig(
        problem=name, problem_args=tuple(sorted(kw.items())),
        backend="cpu", eps_a=0.5, batch_simplices=64, max_depth=20))
    root = tmp_path_factory.mktemp("di")
    out = {}
    for pkg, tree, save, write in (
            ("jax", jres.tree, jregistry.save_artifacts,
             jdelta.write_delta_artifact),
            ("torch", _port_tree(jres.tree), registry.save_artifacts,
             delta.write_delta_artifact)):
        base, dd = str(root / f"{pkg}_v1"), str(root / f"{pkg}_d2")
        save(tree, jres.roots, base)
        v2 = _doubled(tree)
        stats = write(v2, jres.roots, dd, base, base_version="v1")
        out[pkg] = dict(tree=tree, roots=jres.roots, base=base, delta=dd,
                        stats=stats, v2=v2)
    return out


def _thetas(n, rng, outside=0.0):
    """DI queries: uniform in the box, a fraction pushed outside it."""
    th = rng.uniform(-1.5, 1.5, (n, 2))
    k = int(outside * n)
    th[:k] *= rng.uniform(1.2, 2.0, (k, 1))
    return th


def _files(d):
    return sorted(f for f in os.listdir(d) if not f.startswith("."))


def _same_dir(a, b):
    """Two artifact directories hold the same files with the same
    arrays (npy/npz bitwise) and the same JSON."""
    assert _files(a) == _files(b)
    for f in _files(a):
        pa, pb = os.path.join(a, f), os.path.join(b, f)
        if f.endswith(".npz"):
            with np.load(pa) as za, np.load(pb) as zb:
                assert sorted(za.files) == sorted(zb.files)
                for k in za.files:
                    assert za[k].dtype == zb[k].dtype
                    assert za[k].tobytes() == zb[k].tobytes(), (f, k)
        elif f.endswith(".json"):
            with open(pa) as fa, open(pb) as fb:
                assert json.load(fa) == json.load(fb), f
        else:
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                assert fa.read() == fb.read(), f


# -- descent, artifacts, deltas -------------------------------------------


@pytest.mark.parametrize("force_batched", [False, True])
def test_export_descent_matches_the_jax_package(di, force_batched):
    jt, tt, roots = di["jax"]["tree"], di["torch"]["tree"], \
        di["jax"]["roots"]
    jdt = jdescent.export_descent(jt, roots, jexport.export_leaves(jt),
                                  force_batched=force_batched, stage=False)
    tdt = descent.export_descent(tt, roots, export.export_leaves(tt),
                                 force_batched=force_batched, stage=False)
    assert tdt.max_depth == jdt.max_depth
    for k in descent._FIELDS:
        a, b = np.asarray(getattr(tdt, k)), np.asarray(getattr(jdt, k))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k


def test_descent_locate_and_evaluate_match(di):
    d = di["jax"]["base"]
    th = _thetas(300, np.random.default_rng(0), outside=0.1)
    jdt = jdescent.load_descent(os.path.join(d, "descent.npz"))
    jtab = jexport.load_leaf_table(d)
    from explicit_hybrid_mpc_tpu.online import evaluator as jevaluator

    ref = jdescent.evaluate_descent(jdt, jevaluator.stage(jtab),
                                    jnp.asarray(th))
    ref_row, ref_node = jdescent.locate_descent(jdt, jnp.asarray(th))
    tdt = descent.stage_table(descent.load_descent(
        os.path.join(d, "descent.npz")), device=CPU)
    row, node = descent.locate_descent(tdt, torch.as_tensor(th))
    assert np.array_equal(row.numpy(), np.asarray(ref_row))
    assert np.array_equal(node.numpy(), np.asarray(ref_node))
    got = descent.evaluate_descent(
        tdt, evaluator.stage(export.load_leaf_table(d), device=CPU),
        torch.as_tensor(th))
    assert np.array_equal(got.leaf.numpy(), np.asarray(ref.leaf))
    assert np.array_equal(got.inside.numpy(), np.asarray(ref.inside))
    np.testing.assert_allclose(got.u.numpy(), np.asarray(ref.u), atol=1e-12)
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(ref.cost),
                               atol=1e-12)
    assert 0 < int(got.inside.sum()) < len(th)


def test_descent_files_cross_load(di, tmp_path):
    d = di["jax"]["base"]
    host = descent.load_descent(os.path.join(d, "descent.npz"))
    p = str(tmp_path / "descent.npz")
    descent.save_descent(descent.stage_table(host, device=CPU), p)
    back = jdescent.load_descent(p)
    for k in descent._FIELDS:
        assert np.asarray(getattr(back, k)).tobytes() == \
            np.asarray(getattr(host, k)).tobytes()
    assert back.max_depth == host.max_depth


def test_save_artifacts_writes_the_jax_files(di):
    _same_dir(di["torch"]["base"], di["jax"]["base"])
    jlb, jub = jregistry.root_box(jdescent.load_descent(
        os.path.join(di["jax"]["base"], "descent.npz")))
    lb, ub = registry.root_box(descent.load_descent(
        os.path.join(di["torch"]["base"], "descent.npz")))
    assert lb.tobytes() == np.asarray(jlb).tobytes()
    assert ub.tobytes() == np.asarray(jub).tobytes()
    np.testing.assert_allclose(lb, [-1.5, -1.5], atol=1e-12)


def test_write_delta_artifact_writes_the_jax_files(di):
    assert di["torch"]["stats"] == di["jax"]["stats"]
    st = di["torch"]["stats"]
    assert 0 < st["n_fresh"] and st["n_kept"] > 0
    _same_dir(di["torch"]["delta"], di["jax"]["delta"])


def test_apply_delta_and_plan_match(di, tmp_path):
    """The port applies a JAX-written delta to bitwise the JAX result,
    and plans it the same way."""
    base, dd = di["jax"]["base"], di["jax"]["delta"]
    mine, ref = str(tmp_path / "mine"), str(tmp_path / "ref")
    delta.apply_delta(dd, base, mine)
    jdelta.apply_delta(dd, base, ref)
    _same_dir(mine, ref)
    plan, jplan = delta.load_delta_plan(dd, base), \
        jdelta.load_delta_plan(dd, base)
    assert plan["src_idx"].tobytes() == jplan["src_idx"].tobytes()
    for k, v in jplan["fresh"].items():
        assert plan["fresh"][k].tobytes() == v.tobytes()
    # The applied v2 table is the doubled tree's export.
    v2 = export.export_leaves(di["torch"]["v2"])
    got = export.load_leaf_table(mine)
    for a, b in zip(got, v2):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    # A delta against the wrong base is refused.
    other = str(tmp_path / "other")
    registry.save_artifacts(di["torch"]["v2"], di["torch"]["roots"],
                            other, provenance={"problem": "other"})
    with pytest.raises(delta.DeltaMismatch):
        delta.load_delta_plan(dd, other)


# -- the arena against the JAX arena --------------------------------------


def _synthetic_table(rng, L=40, n_u=1):
    """Disjoint unit-grid simplices (tests/test_arena.py's idiom)."""
    base = np.vstack([np.zeros(2), np.eye(2)])
    side = int(np.ceil(np.sqrt(L)))
    bary, U, V = [], [], []
    for i in range(L):
        off = np.array([i % side, i // side], dtype=float)
        verts = 0.8 * base + off + 0.1 * rng.uniform(size=2)
        bary.append(geometry.barycentric_matrix(verts))
        U.append(rng.normal(size=(3, n_u)))
        V.append(np.abs(rng.normal(size=3)))
    return export.LeafTable(
        bary_M=np.stack(bary), U=np.stack(U), V=np.stack(V),
        delta=np.zeros(L, dtype=np.int64),
        node_id=np.arange(L, dtype=np.int64))


def _centroids(table):
    return np.stack([np.linalg.inv(table.bary_M[i])[:-1, :].mean(axis=1)
                     for i in range(table.n_leaves)])


def _jt(table):
    return jexport.LeafTable(*(np.asarray(a) for a in table))


def test_arena_matches_the_jax_arena(di):
    """The same publish history -- a JAX-written artifact, a synthetic
    tenant, then the JAX-written delta -- into both arenas; one mixed
    batch gives the same leaves and flags, and the resident columns are
    the JAX arena's, sliced."""
    base, dd = di["jax"]["base"], di["jax"]["delta"]
    syn = _synthetic_table(np.random.default_rng(11))
    port = DeviceArena(p=2, n_u=1, capacity_cols=512, device="cpu")
    ref = JaxArena(p=2, n_u=1, capacity_cols=512, backend="xla")
    for a in (port, ref):
        a.publish_from_artifacts("c", "v1", base)
        a.publish("s", "v1", *((syn,) if a is port else (_jt(syn),)),
                  *_BOX)
    rng = np.random.default_rng(12)
    names = ["c", "s"] * 40
    th = np.where(np.array(names)[:, None] == "c",
                  _thetas(80, rng, outside=0.1),
                  _centroids(syn)[rng.integers(0, 40, 80)])
    for step in ("v1", "v2"):
        if step == "v2":
            for a in (port, ref):
                a.publish_delta("c", "v2", dd, base)
        got, exp = port.evaluate(names, th), ref.evaluate(names, th)
        assert got.versions == exp.versions == {"c": step, "s": "v1"}
        assert np.array_equal(got.leaf, exp.leaf)
        assert np.array_equal(got.col, exp.col)
        assert np.array_equal(got.served, exp.served)
        assert np.array_equal(got.clamped, exp.clamped)
        assert got.clamped.any() and got.served.any()
        np.testing.assert_allclose(got.u, exp.u[:, :1], atol=1e-5)
        np.testing.assert_allclose(got.cost, exp.cost, atol=1e-5)
        for n in ("c", "s"):
            e, r = port.extent(n), ref.extent(n)
            sl, rl = slice(e.start, e.end), slice(r.start, r.end)
            assert (e.start, e.n_cols, e.n_leaves) == \
                (r.start, r.n_cols, r.n_leaves)
            assert port.bary[:, :, sl].numpy().tobytes() == \
                np.asarray(ref.bary[:3, :3, rl]).tobytes()
            assert port.U[:, sl].numpy().tobytes() == \
                np.ascontiguousarray(np.asarray(ref.U[:3, rl, :1])).tobytes()
            assert port.V[:, sl].numpy().tobytes() == \
                np.asarray(ref.V[:3, rl]).tobytes()
    assert port.stats()["resident_cols"] == ref.stats()["resident_cols"]


def test_nan_query_is_unserved_in_both_arenas_and_the_scheduler():
    """A NaN state estimate never comes back as a certified control: the
    port's arena and the JAX XLA arena both flag it clamped and
    unserved, and the scheduler answers it not ok, tagged 'unserved'."""
    syn = _synthetic_table(np.random.default_rng(13))
    port = DeviceArena(p=2, n_u=1, capacity_cols=256, device="cpu")
    ref = JaxArena(p=2, n_u=1, capacity_cols=256, backend="xla")
    port.publish("s", "v1", syn, *_BOX)
    ref.publish("s", "v1", _jt(syn), *_BOX)
    cents = _centroids(syn)
    th = np.array([[np.nan, 1.0], cents[3], [2.0, np.nan], cents[7]])
    got, exp = port.evaluate("s", th), ref.evaluate("s", th)
    assert np.array_equal(got.served, exp.served)
    assert np.array_equal(got.clamped, exp.clamped)
    assert np.array_equal(got.col, exp.col)
    assert got.served.tolist() == [False, True, False, True]
    assert got.clamped.tolist() == [True, False, True, False]
    o = obs.Obs("jsonl")
    fb = FallbackPolicy(*_BOX, mode="clamp", obs=o)
    with ArenaScheduler(port, max_batch=8, max_wait_us=500.0,
                        fallback=fb, obs=o) as sched:
        res = [sched.submit("s", t).result(30.0)[0] for t in th]
    assert [r.ok for r in res] == [False, True, False, True]
    assert [r.fallback for r in res] == ["unserved", None, "unserved", None]
    c = o.metrics.snapshot()["counters"]
    assert c["serve.fallback.outside_box"] == 2
    assert c["serve.fallback.unserved"] == 2
    assert c.get("serve.fallback.clamp", 0) == 0
    o.close()


# -- arena directory, capacity, hot swap ----------------------------------


def test_publish_stats_and_capacity(rng):
    arena = DeviceArena(p=2, n_u=1, capacity_cols=256, device="cpu")
    t = _synthetic_table(rng)
    arena.publish("a", "v1", t, *_BOX)
    arena.publish("b", "v1", _synthetic_table(rng, L=30), *_BOX)
    s = arena.stats()
    assert s["controllers"] == 2 and s["free_cols"] == 0
    assert s["versions"] == {"a": "v1", "b": "v1"}
    assert s["resident_bytes"] == 256 * arena._col_bytes() == 256 * 60
    with pytest.raises(ArenaFull):
        arena.publish("c", "v1", _synthetic_table(rng, L=5), *_BOX)
    with pytest.raises(ValueError):
        arena.publish("a", "v1", t, *_BOX)
    arena.retire("a")
    assert arena.stats()["free_cols"] == 128
    arena.publish("c", "v1", _synthetic_table(rng, L=5), *_BOX)
    with pytest.raises(KeyError):
        arena.extent("a")
    with pytest.raises(KeyError):
        arena.evaluate("a", np.zeros((1, 2)))


@pytest.mark.parametrize("kw", [dict(capacity_cols=100),
                                dict(capacity_cols=0), dict(n_u=0)])
def test_arena_rejects_bad_shapes(kw):
    args = dict(p=2, n_u=1, capacity_cols=128, device="cpu")
    with pytest.raises(ValueError):
        DeviceArena(**{**args, **kw})


def test_arena_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-GPU path is moot")
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceArena(p=2, n_u=1, capacity_cols=128)


def test_theta_width_and_table_width_mismatch(rng):
    arena = DeviceArena(p=2, n_u=1, capacity_cols=128, device="cpu")
    arena.publish("a", "v1", _synthetic_table(rng), *_BOX)
    with pytest.raises(ValueError):
        arena.evaluate("a", np.zeros((2, 3)))
    with pytest.raises(ValueError):
        arena.evaluate(["a", "a", "a"], np.zeros((2, 2)))
    wide = export.LeafTable(bary_M=np.eye(4)[None], U=np.zeros((1, 4, 1)),
                            V=np.zeros((1, 4)), delta=np.zeros(1, int),
                            node_id=np.zeros(1, int))
    with pytest.raises(ValueError):
        arena.publish("w", "v1", wide, np.zeros(3), np.ones(3))


def test_two_epoch_handoff(rng):
    arena = DeviceArena(p=2, n_u=1, capacity_cols=256, device="cpu")
    t1, t2 = _synthetic_table(rng), _synthetic_table(rng)
    e1 = arena.publish("a", "v1", t1, *_BOX)
    cols = slice(e1.start, e1.end)
    before = (arena.bary[:, :, cols].clone(), arena.U[:, cols].clone(),
              arena.V[:, cols].clone())
    with arena.lease(["a"]):
        arena.publish("a", "v2", t2, *_BOX)
        assert arena.extent("a").version == "v2"
        assert e1.state == "retiring"
        assert not arena.wait_retired(e1, timeout=0.05)
        # The publish wrote free columns only: a reader of the leased v1
        # extent still finds its columns bitwise as they were.
        assert torch.equal(arena.bary[:, :, cols], before[0])
        assert torch.equal(arena.U[:, cols], before[1])
        assert torch.equal(arena.V[:, cols], before[2])
    assert e1.state == "retired" and arena.wait_retired(e1, timeout=1.0)
    assert arena.stats()["retiring"] == 0
    cents = _centroids(t2)[:4]
    out = arena.evaluate("a", cents)
    ref = evaluator.evaluate(evaluator.stage(t2, device=CPU),
                             torch.as_tensor(cents))
    assert np.array_equal(out.leaf, ref.leaf.numpy())
    assert out.versions == {"a": "v2"}


def test_swap_without_reader_retires_immediately(rng):
    arena = DeviceArena(p=2, n_u=1, capacity_cols=256, device="cpu")
    e1 = arena.publish("a", "v1", _synthetic_table(rng), *_BOX)
    arena.publish("a", "v2", _synthetic_table(rng), *_BOX)
    assert e1.state == "retired" and arena.wait_retired(e1, 0.0)
    assert arena.stats()["free_cols"] == 128


def test_publish_delta_is_bitwise_a_full_republish(di, tmp_path):
    base, dd = di["torch"]["base"], di["torch"]["delta"]
    full = str(tmp_path / "v2_full")
    delta.apply_delta(dd, base, full)
    o = obs.Obs("jsonl")
    arena = DeviceArena(p=2, n_u=1, capacity_cols=512, device="cpu", obs=o)
    e1 = arena.publish_from_artifacts("c", "v1", base)
    e2 = arena.publish_delta("c", "v2", dd, base)
    assert arena.extent("c").version == "v2" and e1.state == "retired"
    assert e2.n_leaves == e1.n_leaves
    ref = DeviceArena(p=2, n_u=1, capacity_cols=512, device="cpu")
    er = ref.publish_from_artifacts("c", "v2", full)
    sl, rl = slice(e2.start, e2.end), slice(er.start, er.end)
    for name in ("bary", "U", "V"):
        a = getattr(arena, name)
        b = getattr(ref, name)
        idx = (slice(None), slice(None), sl) if name == "bary" else \
            (slice(None), sl)
        ridx = idx[:-1] + (rl,)
        assert a[idx].numpy().tobytes() == b[ridx].numpy().tobytes(), name
    with pytest.raises(delta.DeltaMismatch):
        arena.publish_delta("c", "v3", dd, base)       # base is not active
    with pytest.raises(delta.DeltaMismatch):
        arena.publish_delta("nope", "v2", dd, base)
    assert arena.extent("c").version == "v2"
    c = o.metrics.snapshot()["counters"]
    assert c["serve.arena.publishes"] == 1
    assert c["serve.arena.delta_publishes"] == 1
    o.close()


# -- the scheduler --------------------------------------------------------


def test_arena_scheduler_mixed_batches(rng):
    o = obs.Obs("jsonl")
    arena = DeviceArena(p=2, n_u=1, capacity_cols=512, device="cpu", obs=o)
    tables = {}
    for k in range(3):
        tables[f"t{k}"] = _synthetic_table(rng, L=20 + 3 * k)
        arena.publish(f"t{k}", "v1", tables[f"t{k}"], *_BOX)
    fb = FallbackPolicy(*_BOX, obs=o)
    n_req = 36
    with ArenaScheduler(arena, max_batch=64, max_wait_us=20000.0,
                        fallback=fb, obs=o) as sched:
        names = [f"t{i % 3}" for i in range(n_req)]
        thetas = [_centroids(tables[nm])[i % 10]
                  for i, nm in enumerate(names)]
        tickets = [sched.submit(nm, th) for nm, th in zip(names, thetas)]
        results = [t.result(30.0)[0] for t in tickets]
        assert sched.n_requests == n_req
        assert sched.n_batches < n_req
        for nm, th, r in zip(names, thetas, results):
            ref = evaluator.evaluate(evaluator.stage(tables[nm], device=CPU),
                                     torch.as_tensor(th[None, :]))
            assert r.leaf == int(ref.leaf[0])
            assert r.inside and r.ok and r.version == "v1"
            assert r.fallback is None
            np.testing.assert_allclose(r.u, ref.u.numpy()[0], atol=1e-5)
        snap = o.metrics.snapshot()["counters"]
        assert snap.get("serve.requests") == n_req
        assert snap.get("serve.batches") == sched.n_batches
        assert sum(snap.get(f"serve.ctl.t{k}.requests", 0)
                   for k in range(3)) == n_req
        assert snap.get("serve.arena.launches", 0) == sched.n_batches
        with pytest.raises(KeyError):
            sched.submit("ghost", np.zeros(2))
        with pytest.raises(ValueError):
            sched.submit("t0", np.zeros(3))
    with pytest.raises(RuntimeError):
        sched.submit("t0", np.zeros(2))
    o.close()


def test_arena_scheduler_validation_and_unported_hooks(rng):
    arena = DeviceArena(p=2, n_u=1, capacity_cols=128, device="cpu")
    arena.publish("a", "v1", _synthetic_table(rng), *_BOX)
    with pytest.raises(ValueError):
        ArenaScheduler(arena, max_batch=48)
    with pytest.raises(ValueError):
        ArenaScheduler(arena, max_wait_us=0.0)
    for hook, item in (("demand", "A5: obs/demand.py"),
                       ("trace", "A2: obs/reqtrace.py"),
                       ("slo", "A5: obs/slo.py")):
        with pytest.raises(NotImplementedError, match=item):
            ArenaScheduler(arena, **{hook: object()})


def test_scheduler_swap_during_traffic_has_no_torn_reads(rng):
    """Requests race a hot swap to a payload-doubled v2: nothing drops,
    every row is tagged with the version it evaluated on, the old extent
    drains, and every served row is bitwise a reference arena's answer
    for that version."""
    t1 = _synthetic_table(rng)
    t2 = t1._replace(U=2.0 * t1.U, V=2.0 * t1.V)
    arena = DeviceArena(p=2, n_u=1, capacity_cols=256, device="cpu")
    e1 = arena.publish("a", "v1", t1, *_BOX)
    cents = _centroids(t1)
    tickets, started = [], threading.Event()
    with ArenaScheduler(arena, max_batch=8, max_wait_us=500.0) as sched:
        def pump():
            for i in range(200):
                tickets.append((i, sched.submit("a", cents[i % 40])))
                if i == 20:
                    started.set()

        th = threading.Thread(target=pump)
        th.start()
        started.wait(10.0)
        arena.publish("a", "v2", t2, *_BOX)
        th.join()
        results = [(i, t.result(30.0)[0]) for i, t in tickets]
    assert len(results) == 200
    versions = {r.version for _i, r in results}
    assert versions <= {"v1", "v2"} and "v2" in versions
    assert all(r.inside for _i, r in results)
    assert arena.wait_retired(e1, timeout=10.0)
    refs = {}
    for v, t in (("v1", t1), ("v2", t2)):
        refs[v] = DeviceArena(p=2, n_u=1, capacity_cols=128, device="cpu")
        refs[v].publish("a", v, t, *_BOX)
    torn = 0
    for i, r in results:
        ref = refs[r.version].evaluate("a", cents[i % 40][None])
        torn += not (np.float64(ref.u[0, 0]).tobytes()
                     == np.float64(r.u[0]).tobytes()
                     and np.float32(ref.cost[0]).tobytes()
                     == np.float32(r.cost).tobytes()
                     and int(ref.leaf[0]) == r.leaf)
    assert torn == 0


# -- fallback reconciliation ----------------------------------------------


class _HostServer:
    """Host-path server for FallbackPolicy.apply: the port's f64 plain
    evaluator with no root_bary (the policy clamps to its constructor
    box, the box the arena rows carry)."""

    root_bary = None

    def __init__(self, table):
        self._dev = evaluator.stage(table, device=CPU)

    def evaluate(self, thetas):
        return evaluator.evaluate(self._dev, torch.as_tensor(thetas))


def test_fallback_counters_reconcile_kernel_vs_host(rng):
    """The kernel path (arena clamp + account_kernel) and the host path
    (f64 evaluate + FallbackPolicy.apply) land identical
    serve.fallback.* counters and per-row tags on the same mix."""
    table = _synthetic_table(rng, L=40)
    cents = _centroids(table)
    lb = np.zeros(2)
    ub = cents[np.argmax(cents.sum(axis=1))]
    thetas = np.concatenate([
        cents[:6],
        np.array([[0.95, 0.95], [1.95, 2.95]]),
        ub + np.array([[2.0, 3.0], [5.0, 0.5]]),
        np.array([[-1.0, 0.95]])])
    o_k = obs.Obs("jsonl")
    arena = DeviceArena(p=2, n_u=1, capacity_cols=128, device="cpu",
                        obs=o_k)
    arena.publish("a", "v1", table, lb, ub)
    fb_k = FallbackPolicy(lb, ub, obs=o_k)
    res = arena.evaluate("a", thetas)
    tags_k = fb_k.account_kernel(res.clamped, res.served)
    o_h = obs.Obs("jsonl")
    fb_h = FallbackPolicy(lb, ub, obs=o_h)
    server = _HostServer(table)
    patched, tags_h = fb_h.apply(thetas, server.evaluate(thetas), server)
    assert tags_k == tags_h
    assert fb_k.n_seen == fb_h.n_seen == thetas.shape[0]
    ck = o_k.metrics.snapshot()["counters"]
    ch = o_h.metrics.snapshot()["counters"]
    for key in ("outside_box", "hole", "clamp", "unserved", "requests"):
        assert ck.get(f"serve.fallback.{key}", 0) == \
            ch.get(f"serve.fallback.{key}", 0), key
    assert ck["serve.fallback.outside_box"] == 3
    assert ck["serve.fallback.hole"] == 2
    assert ck["serve.fallback.clamp"] == 2
    assert ck["serve.fallback.unserved"] == 3
    clamp_rows = [i for i, t in enumerate(tags_k) if t == "clamp"]
    np.testing.assert_allclose(res.u[clamp_rows],
                               np.asarray(patched.u)[clamp_rows], atol=1e-5)
    o_k.close()
    o_h.close()


def test_fallback_mode_off_counts_nothing():
    o = obs.Obs("jsonl")
    fb = FallbackPolicy(*_BOX, mode="off", obs=o)
    tags = fb.account_kernel(np.array([True, False]),
                             np.array([False, True]))
    assert tags == [None, None] and fb.n_seen == 2
    assert o.metrics.snapshot()["counters"].get(
        "serve.fallback.requests", 0) == 0
    o.close()


# -- ServeConfig ----------------------------------------------------------


def test_serve_config_has_the_jax_fields_and_checks():
    import dataclasses

    mine = {f.name: f.default for f in dataclasses.fields(config.ServeConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(jconfig.ServeConfig)}
    assert mine == ref
    assert config.DEFAULT_MAX_BUCKET == jconfig.DEFAULT_MAX_BUCKET
    for n in (0, 1, 2, 3, 48, 64, 1 << 20):
        assert config.is_pow2(n) == jconfig.is_pow2(n)
    for bad in (dict(max_batch=48), dict(max_wait_us=0.0),
                dict(fallback="oracle"), dict(max_oracle_frac=2.0),
                dict(obs="loud"), dict(max_batch=1 << 15),
                dict(max_bucket=100)):
        with pytest.raises(ValueError):
            config.ServeConfig(**bad)
        with pytest.raises(ValueError):
            jconfig.ServeConfig(**bad)
    for knob, val, item in (("demand", "on", "A5: obs/demand.py"),
                            ("tracing", "on", "A2: obs/reqtrace.py"),
                            ("slo", "on", "A5: obs/slo.py"),
                            ("trace_exemplar_k", 4, "A2: obs/reqtrace.py")):
        jconfig.ServeConfig(**{knob: val})
        with pytest.raises(NotImplementedError, match=item):
            config.ServeConfig(**{knob: val})
    assert config.ServeConfig().max_batch == 256


def test_shuffled_tenant_order_answers_each_row_in_its_place(rng):
    """A mixed batch in shuffled tenant order: each row's answer is its
    own, in the caller's order, bitwise what the batch in tenant order
    gives it; the launch plan packed with the batch groups rows of one
    tenant into tiles of its extent and covers every row once."""
    from explicit_hybrid_mpc_tpu_torch.online import fused

    arena = DeviceArena(p=2, n_u=1, capacity_cols=640, device="cpu")
    tabs = {n: _synthetic_table(rng, L=30 + 7 * k)
            for k, n in enumerate(("a", "b", "c"))}
    for n, t in tabs.items():
        arena.publish(n, "v1", t, *_BOX)
    names = [n for n in ("a", "b", "c") for _ in range(13)]
    th = np.concatenate([_centroids(tabs[n])[:13] for n in ("a", "b", "c")])
    th[::5] = rng.uniform(-2.0, 10.0, (len(th[::5]), 2))
    base = arena.evaluate(names, th)
    perm = rng.permutation(len(names))
    sn = [names[i] for i in perm]
    got = arena.evaluate(sn, th[perm])
    for f in ("u", "cost", "leaf", "col", "served", "clamped"):
        assert getattr(got, f).tobytes() == getattr(base, f)[perm].tobytes()
    exts = {n: arena.extent(n) for n in tabs}
    buf, starts, chunks = arena.pack_queries(exts, sn, th[perm])
    q, ext, tiles = fused.split_queries(torch.as_tensor(buf), len(sn), 3)
    assert np.array_equal(ext[:, 0].numpy(), starts)
    covered = []
    for n, s, e, _unused, *rows in tiles.tolist():
        rows = rows[:n]
        covered += rows
        assert {sn[r] for r in rows} == {sn[rows[0]]}
        ex = exts[sn[rows[0]]]
        assert (s, e) == (ex.start, ex.start + ex.n_leaves)
    assert sorted(covered) == list(range(len(sn)))
    assert 1 <= chunks <= fused.MAX_CHUNKS


# -- the single-controller path: registry, RequestScheduler, fallback, CLI ----
#
# The JAX package's tests/test_serve.py cases, on the port's
# ShardedDescent servers on the CPU (tests/test_torch_sharded.py holds
# those servers to the JAX package's).


def _server(obs_h=None, scale=1.0, depth=6, max_bucket=None, p=2, n_u=2,
            **box):

    tree, roots = build_synthetic_tree(p=p, depth=depth, n_u=n_u, **box)
    if scale != 1.0:
        tree._pl_inputs[:] *= scale
        tree._pl_costs[:] *= scale
    table = export.export_leaves(tree)
    dt = descent.export_descent(tree, roots, table, stage=False)
    return sharded.shard_descent(dt, table, n_shards=2, obs=obs_h,
                                 max_bucket=max_bucket, devices=[CPU])


@pytest.fixture(scope="module")
def servers():
    """(v1, v2) servers over the same geometry; v2 payloads are exactly
    2x v1's, so v2 results are bitwise 2x v1 results."""
    return _server(), _server(scale=2.0)


def test_request_scheduler_micro_batches_and_heartbeat(servers, rng):

    srv1, _ = servers
    o = obs.Obs("jsonl")
    reg = ControllerRegistry(obs=o)
    reg.publish("c", "v1", _server(obs_h=o))
    with RequestScheduler(reg, "c", max_batch=32, max_wait_us=1500.0,
                          obs=o) as sched:
        thetas = rng.uniform(0, 1, size=(200, 2))
        results = [t.result(30.0)[0]
                   for t in [sched.submit(th) for th in thetas]]
    assert all(r.ok and r.version == "v1" for r in results)
    assert sched.n_batches < 200 and sched.n_requests == 200
    ref = srv1.evaluate(thetas)
    for i, r in enumerate(results):
        assert np.array_equal(r.u, ref.u[i])
        assert r.cost == float(ref.cost[i])
    evs = [rec for rec in o.sink.records if rec.get("name") == "serve.eval"]
    assert evs and all("queue_depth" in e and "batch_fill_frac" in e
                       for e in evs)
    assert any(rec.get("name") == "serve.replica"
               and rec.get("controller") == "c" for rec in o.sink.records)
    snap = o.metrics.snapshot()
    assert snap["counters"]["serve.ctl.c.requests"] == 200
    assert snap["counters"]["serve.requests"] == 200
    assert snap["counters"]["serve.ctl.c.batches"] == sched.n_batches
    assert snap["gauges"]["serve.ctl.c.p99_us"] > 0
    assert "serve.p99_us" not in snap["gauges"]
    assert "serve.ctl.c.request_s" in snap["histograms"]
    o.close()


def test_request_scheduler_deadline_split_and_close(servers, rng):
    """A lone query flushes on the deadline; a submission larger than
    max_batch spans micro-batches; close() drains; submit after close
    raises."""

    srv1, _ = servers
    reg = ControllerRegistry()
    reg.publish("c", "v1", srv1)
    with RequestScheduler(reg, "c", max_batch=256,
                          max_wait_us=2000.0) as sched:
        (r,) = sched.submit(np.array([0.3, 0.4])).result(10.0)
    assert r.ok
    sched = RequestScheduler(reg, "c", max_batch=16, max_wait_us=500.0)
    thetas = rng.uniform(0, 1, size=(70, 2))
    t = sched.submit_batch(thetas)
    sched.close()
    results = t.result(1.0)
    assert len(results) == 70 and all(r.ok for r in results)
    ref = srv1.evaluate(thetas)
    assert all(np.array_equal(results[i].u, ref.u[i]) for i in range(70))
    assert sched.n_batches >= 5
    with pytest.raises(RuntimeError):
        sched.submit(thetas[0])


def test_request_scheduler_validation_and_unported_hooks(servers, rng):

    srv1, _ = servers
    reg = ControllerRegistry()
    reg.publish("c", "v1", srv1)
    with pytest.raises(ValueError):
        RequestScheduler(reg, "c", max_batch=48)
    with pytest.raises(ValueError):
        RequestScheduler(reg, "c", max_wait_us=0.0)
    for hook, item in (("demand", "A5: obs/demand.py"),
                       ("trace", "A2: obs/reqtrace.py"),
                       ("slo", "A5: obs/slo.py")):
        with pytest.raises(NotImplementedError, match=item):
            RequestScheduler(reg, "c", **{hook: object()})
    # A wrong-width submission raises on its submitter and never poisons
    # the co-batched healthy rows.
    with RequestScheduler(reg, "c", max_batch=32,
                          max_wait_us=50_000.0) as sched:
        good = sched.submit_batch(rng.uniform(0, 1, size=(3, 2)))
        with pytest.raises(ValueError, match="parameter dim"):
            sched.submit(np.array([0.1, 0.2, 0.3]))
        with pytest.raises(ValueError, match=r"\(k, p\)"):
            sched.submit_batch(np.zeros((2, 2, 2)))
        assert all(r.ok for r in good.result(30.0))


def test_request_scheduler_flushes_metrics_while_serving(servers, rng,
                                                         monkeypatch):
    from explicit_hybrid_mpc_tpu_torch.serve import scheduler as sched_mod

    monkeypatch.setattr(sched_mod, "METRICS_FLUSH_S", 0.0)
    srv1, _ = servers
    o = obs.Obs("jsonl")
    reg = ControllerRegistry(obs=o)
    reg.publish("c", "v1", srv1)
    sched = RequestScheduler(reg, "c", max_batch=8, max_wait_us=500.0,
                             obs=o)
    for t in [sched.submit(th) for th in rng.uniform(0, 1, (40, 2))]:
        t.result(30.0)
    snaps = [r for r in o.sink.records if r.get("kind") == "metrics"]
    assert any("serve.ctl.c.p99_us" in (s.get("gauges") or {})
               for s in snaps)
    sched.close()
    o.close()


def test_publish_rejects_param_dim_change():

    reg = ControllerRegistry()
    reg.publish("c", "v1", _server(p=2))
    assert reg.param_dim("c") == 2
    with pytest.raises(ValueError, match="parameter dim 3"):
        reg.publish("c", "v2", _server(p=3, depth=4))
    assert reg.active_version("c") == "v1" and reg.param_dim("c") == 2
    reg.publish("c", "v2", _server(p=2, depth=5))
    reg.publish("c3", "v1", _server(p=3, depth=4))
    assert reg.param_dim("c3") == 3
    assert reg.controllers() == ["c", "c3"]
    assert reg.param_dim("nope") is None


def test_registry_publish_lease_retire(servers):

    srv1, srv2 = servers
    o = obs.Obs("jsonl")
    reg = ControllerRegistry(obs=o)
    with pytest.raises(KeyError):
        with reg.lease("nope"):
            pass
    v1 = reg.publish("c", "v1", srv1)
    assert reg.active_version("c") == "v1"
    with reg.lease("c") as ver:
        assert ver is v1 and v1.in_flight == 1
        reg.publish("c", "v2", srv2)
        assert v1.state == "retiring"
        assert reg.active_version("c") == "v2"
    assert reg.wait_retired(v1, 5.0) and v1.state == "retired"
    names = [r["name"] for r in o.sink.records]
    assert names.count("serve.swap") == 2 and "serve.retired" in names
    swap = [r for r in o.sink.records if r["name"] == "serve.swap"][-1]
    assert swap["from_version"] == "v1" and swap["to_version"] == "v2"
    assert o.metrics.snapshot()["counters"]["serve.swaps"] == 2
    o.close()


def test_wait_retired_times_out_with_a_lease_leak_event(servers):

    srv1, srv2 = servers
    o = obs.Obs("jsonl")
    reg = ControllerRegistry(obs=o)
    v1 = reg.publish("c", "v1", srv1)
    cm = reg.lease("c")
    cm.__enter__()
    reg.publish("c", "v2", srv2)
    assert not reg.wait_retired(v1, 0.05)
    ev = [r for r in o.sink.records if r["name"] == "health.lease_leak"]
    assert ev and ev[0]["value"] == 1
    cm.__exit__(None, None, None)
    assert reg.wait_retired(v1, 1.0)
    o.close()


def test_request_scheduler_hot_swap_has_no_torn_reads(servers):
    """Submitters racing a hot swap observe only complete-v1 or
    complete-v2 results (v2 payloads are exactly 2x v1's, so any mix is
    a bitwise mismatch), and nothing drops."""

    srv1, srv2 = servers
    reg = ControllerRegistry()
    v1 = reg.publish("c", "v1", srv1)
    sched = RequestScheduler(reg, "c", max_batch=32, max_wait_us=800.0)
    stop = threading.Event()
    swapped = threading.Event()
    errors, outs = [], []
    lock = threading.Lock()

    def client(cid):
        r = np.random.default_rng(cid)
        while not stop.is_set():
            th = r.uniform(0, 1, size=(3, 2))
            try:
                res = sched.submit_batch(th).result(10.0)
            except Exception as e:  # noqa: BLE001 -- a drop IS a failure
                errors.append(e)
                return
            with lock:
                outs.extend(zip(th, res))
                n = len(outs)
            if n > 150 and not swapped.is_set():
                swapped.set()
                reg.publish("c", "v2", srv2)
            if swapped.is_set() and sum(
                    1 for _t, x in outs[-40:] if x.version == "v2") >= 30:
                stop.set()

    threads = [threading.Thread(target=client, args=(c,)) for c in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60.0)
    sched.close()
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert reg.wait_retired(v1, 5.0)
    assert {r.version for _t, r in outs} == {"v1", "v2"}
    thetas = np.stack([t for t, _r in outs])
    ref = srv1.evaluate(thetas)
    for k, (_t, r) in enumerate(outs):
        scale = 1.0 if r.version == "v1" else 2.0
        assert np.array_equal(r.u, scale * ref.u[k]), (k, r.version)
        assert r.cost == scale * float(ref.cost[k])


def test_fallback_clamp_outside_box_on_a_sharded_server(servers):
    srv1, _ = servers
    o = obs.Obs("jsonl")
    lb, ub = registry.root_box(srv1)
    np.testing.assert_allclose(lb, 0.0, atol=1e-12)
    np.testing.assert_allclose(ub, 1.0, atol=1e-12)
    fb = FallbackPolicy(lb, ub, obs=o)
    thetas = np.array([[0.5, 0.5], [1.4, 0.5], [-0.2, 2.0]])
    res = srv1.evaluate(thetas)
    assert list(res.inside) == [True, False, False]
    patched, tags = fb.apply(thetas, res, srv1)
    assert tags == [None, "clamp", "clamp"] and patched.inside.all()
    ref = srv1.evaluate(np.clip(thetas, lb, ub))
    np.testing.assert_array_equal(patched.u, ref.u)
    c = o.metrics.snapshot()["counters"]
    assert (c["serve.fallback.outside_box"], c["serve.fallback.clamp"],
            c["serve.fallback.requests"]) == (2, 2, 2)
    assert c.get("serve.fallback.hole", 0) == 0
    o.close()


def test_fallback_box_follows_the_leased_server():
    srv2 = _server(depth=5, lb=[0.0, 0.0], ub=[2.0, 2.0])
    fb = FallbackPolicy(np.zeros(2), np.ones(2))
    theta = np.array([[2.5, 0.5]])
    res = srv2.evaluate(theta)
    assert not res.inside[0]
    patched, tags = fb.apply(theta, res, srv2)
    assert tags == ["clamp"] and patched.inside[0]
    np.testing.assert_array_equal(
        patched.u, srv2.evaluate(np.array([[2.0, 0.5]])).u)
    lb, ub = fb.box(object())
    assert np.array_equal(lb, np.zeros(2)) and np.array_equal(ub, np.ones(2))


class _Sol(NamedTuple):
    dstar: np.ndarray
    u0: np.ndarray
    Vstar: np.ndarray


class _FakeOracle:
    """solve_vertices stand-in: one commutation, u = 7 * theta."""

    def __init__(self):
        self.n_calls = 0

    def solve_vertices(self, thetas):
        self.n_calls += thetas.shape[0]
        K = thetas.shape[0]
        return _Sol(np.zeros(K, dtype=np.int64), 7.0 * thetas[:, None, :],
                    thetas.sum(axis=1))


class _MissOracle:
    """solve_vertices stand-in that finds NO valid commutation."""

    def solve_vertices(self, thetas):
        K = thetas.shape[0]
        return _Sol(np.full(K, -1, dtype=np.int64),
                    np.full((K, 1, thetas.shape[1]), np.nan),
                    np.full(K, np.inf))


def _hole_server():

    t = Tree(p=1, n_u=1)
    r = t.add_root(np.array([[0.0], [1.0]]))
    left, right, i, j, _ = geometry.bisect(t.vertices[r])
    li, _ri = t.split(r, left, right, (i, j))

    t.set_leaf(li, LeafData(delta_idx=0, vertex_inputs=np.ones((2, 1)),
                            vertex_costs=np.zeros(2)))
    table = export.export_leaves(t)
    dt = descent.export_descent(t, [r], table, stage=False)
    return sharded.shard_descent(dt, table, n_shards=2, granularity=1,
                                 devices=[CPU])


def test_fallback_hole_routes_to_the_budgeted_oracle():
    """In-box holes cannot be clamp-served: the oracle answers a bounded
    fraction, the rest are unserved."""
    srv = _hole_server()
    o = obs.Obs("jsonl")
    oracle = _FakeOracle()
    fb = FallbackPolicy(np.zeros(1), np.ones(1), oracle=oracle,
                        max_oracle_frac=0.5, obs=o)
    thetas = np.array([[0.25], [0.30], [0.75], [0.80]])
    patched, tags = fb.apply(thetas, srv.evaluate(thetas), srv)
    assert tags == [None, None, "oracle", "oracle"]
    np.testing.assert_allclose(patched.u[2:], 7.0 * thetas[2:])
    assert patched.inside.all()
    c = o.metrics.snapshot()["counters"]
    assert c["serve.fallback.hole"] == 2 and c["serve.fallback.oracle"] == 2
    thetas2 = np.array([[0.9], [0.95], [0.85]])
    _p2, tags2 = fb.apply(thetas2, srv.evaluate(thetas2), srv)
    assert tags2.count("unserved") >= 2
    assert oracle.n_calls <= int(0.5 * fb.n_seen)
    assert fb.n_oracle == oracle.n_calls == fb.oracle_spent("default")
    o.close()


def test_fallback_budgeted_oracle_is_the_ports_oracle():
    """The re-solve through the port's own Oracle (K1's plain version on
    the CPU) answers a hole with the point MICP's u and V*."""
    from explicit_hybrid_mpc_tpu_torch.oracle.oracle import Oracle
    from explicit_hybrid_mpc_tpu_torch.problems.registry import make

    srv = _hole_server()
    prob = make("double_integrator", N=3)

    class _P1:
        """The DI oracle at theta = (x, 0.2): a 1-D query space."""

        def __init__(self):
            self.o = Oracle(prob, backend="cpu")

        def solve_vertices(self, th):
            return self.o.solve_vertices(
                np.concatenate([th, np.full_like(th, 0.2)], axis=1))

    fb = FallbackPolicy(np.zeros(1), np.ones(1), oracle=_P1(),
                        max_oracle_frac=1.0)
    thetas = np.array([[0.75]])
    patched, tags = fb.apply(thetas, srv.evaluate(thetas), srv)
    ref = Oracle(prob, backend="cpu").solve_vertices(np.array([[0.75, 0.2]]))
    assert tags == ["oracle"] and patched.inside[0]
    np.testing.assert_allclose(patched.u[0], ref.u0[0, ref.dstar[0]],
                               atol=1e-12)
    assert patched.cost[0] == ref.Vstar[0]


def test_fallback_oracle_miss_leaves_the_row_untouched():
    srv = _hole_server()
    fb = FallbackPolicy(np.zeros(1), np.ones(1), oracle=_MissOracle(),
                        max_oracle_frac=1.0)
    thetas = np.array([[0.75]])
    res = srv.evaluate(thetas)
    patched, tags = fb.apply(thetas, res, srv)
    assert tags == ["unserved"] and not patched.inside[0]
    np.testing.assert_array_equal(patched.u, res.u)
    np.testing.assert_array_equal(patched.cost, res.cost)


def test_fallback_off_mode_passthrough(servers):
    srv1, _ = servers
    fb = FallbackPolicy(np.zeros(2), np.ones(2), mode="off")
    thetas = np.array([[2.0, 2.0]])
    patched, tags = fb.apply(thetas, srv1.evaluate(thetas), srv1)
    assert tags == [None] and not patched.inside[0]


# -- the serve CLI ------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_artifacts(tmp_path_factory):
    """A serving artifact directory written by the JAX package."""
    from explicit_hybrid_mpc_tpu.partition.synthetic import (
        build_synthetic_tree as jbuild)

    tree, roots = jbuild(p=2, depth=5, n_u=1)
    d = str(tmp_path_factory.mktemp("cli") / "artifacts")
    jregistry.save_artifacts(tree, roots, d)
    return d


def test_serve_cli_selftest_summary_has_the_jax_keys(jax_artifacts, capsys):
    from explicit_hybrid_mpc_tpu.main import main as jmain
    from explicit_hybrid_mpc_tpu_torch.main import main as tmain

    argv = ["serve", "--artifacts", jax_artifacts, "--controller", "t",
            "--shards", "2", "--max-batch", "16", "--selftest", "64"]
    assert jmain(argv) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tmain(argv + ["--backend", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) == set(ref)
    assert got["requests"] == ref["requests"] == 64
    assert got["controller"] == "t" and got["version"] == "v1"
    assert got["p99_us"] is not None
    # The same seeded queries: the same rows fall back.
    assert got["fallback_served"] == ref["fallback_served"] > 0
    assert got["fallback_seen"] == ref["fallback_seen"] == 64


def test_serve_cli_stdin_jsonl(jax_artifacts, capsys, monkeypatch):
    """JSONL on stdin: one result line per query, an error record for a
    malformed line (the loop keeps serving), a summary on stderr."""
    import io

    from explicit_hybrid_mpc_tpu_torch.serve.cli import serve_main

    lines = ['{"theta": [0.25, 0.5]}', "", "[0.5, 0.125]", "not json",
             "[0.1, 0.2, 0.3]", '{"theta": [2.0, 0.5]}']
    monkeypatch.setattr("sys.stdin", io.StringIO("\n".join(lines) + "\n"))
    assert serve_main(["--artifacts", jax_artifacts, "--backend", "cpu",
                       "--max-wait-us", "100"]) == 0
    cap = capsys.readouterr()
    out = [json.loads(x) for x in cap.out.strip().splitlines()]
    assert len(out) == 5
    assert out[0]["inside"] and out[0]["fallback"] is None
    assert out[0]["version"] == "v1" and len(out[0]["u"]) == 1
    # leaf_payload's law u = theta_0 + 2 theta_1, exact by interpolation.
    np.testing.assert_allclose(out[0]["u"], [1.25], atol=1e-12)
    np.testing.assert_allclose(out[1]["u"], [0.75], atol=1e-12)
    assert "error" in out[2] and "JSONDecodeError" in out[2]["error"]
    assert "error" in out[3] and "parameter dim" in out[3]["error"]
    assert out[4]["fallback"] == "clamp" and out[4]["inside"]
    summ = json.loads(cap.err.strip().splitlines()[-1])
    assert summ["requests"] == 3 and summ["p50_us"] is not None


def test_serve_cli_defaults_to_the_gpu(jax_artifacts):
    """The port's serve CLI defaults to --backend cuda and raises a clear
    error without a GPU (the JAX package's defaults to cpu)."""
    from explicit_hybrid_mpc_tpu_torch.serve.cli import (build_serve_parser,
                                                         serve_main)

    assert build_serve_parser().parse_args(
        ["--artifacts", "x"]).backend == "cuda"
    with pytest.raises(SystemExit, match="--backend cpu"):
        serve_main(["--artifacts", jax_artifacts, "--selftest", "4"])
    with pytest.raises(NotImplementedError, match="A5: obs/demand.py"):
        serve_main(["--artifacts", jax_artifacts, "--backend", "cpu",
                    "--demand", "on"])
    with pytest.raises(SystemExit):
        serve_main(["--artifacts", jax_artifacts, "--backend", "cpu",
                    "--max-batch", "48"])
