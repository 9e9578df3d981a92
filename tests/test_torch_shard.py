"""Torch port: the sharded frontier (partition/shard.py) against the JAX
package's.

Every case of the JAX package's tests/test_shard.py, on the port: the
ownership hash (the JAX package's owner for the same key bytes), the
exchange protocol and its recovery, the stale-directory refusal, the
2- and 4-shard builds (N engines in N threads of one process over one
exchange directory: the whole request / publish / drain protocol
without a process group) with the tree signature of the JAX package's
single-process build and the summed point solves equal, the obs
counters, per-shard checkpoints, the remote-timeout fallback, async
certify, and the merge / canonical-compare helpers.  The multi-process
path runs in tests/test_torch_distributed.py."""

import os
import pickle
import threading

import numpy as np
import pytest
import torch

import explicit_hybrid_mpc_tpu  # noqa: F401  (enables x64)
from explicit_hybrid_mpc_tpu.config import PartitionConfig as JaxConfig
from explicit_hybrid_mpc_tpu.partition import shard as jshard
from explicit_hybrid_mpc_tpu.partition.frontier import (
    build_partition as jax_build)
from explicit_hybrid_mpc_tpu.problems.registry import make as jax_make
from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
from explicit_hybrid_mpc_tpu_torch.oracle.oracle import Oracle
from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
    FrontierEngine, build_partition, load_checkpoint)
from explicit_hybrid_mpc_tpu_torch.partition.shard import (
    ShardExchange, compare_trees_canonical, merge_shard_trees,
    owned_root_indices, shard_owner)
from explicit_hybrid_mpc_tpu_torch.problems.registry import make

torch.set_num_threads(1)

BASE = dict(problem="double_integrator", eps_a=0.5, backend="cpu",
            batch_simplices=32, max_depth=20, speculate=False)
ARGS = {"N": 3, "theta_box": 1.5}


def _problem():
    return make("double_integrator", **ARGS)


def _oracle(prob):
    return Oracle(prob, backend="cpu")


def _signature(res):
    """Node-for-node identity in canonical (vertex-bytes) order: the
    merged tree orders nodes per shard subtree, the single-process
    build breadth-first."""
    tree = res.tree
    leaves = {tree.vertices[n].tobytes(): (tree.leaf_data[n].delta_idx,
                                           bool(tree.leaf_data[n].certified))
              for n in tree.converged_leaves()}
    return (res.stats["regions"], res.stats["tree_nodes"],
            res.stats["max_depth"],
            sorted(tree.vertices[n].tobytes() for n in range(len(tree))),
            sorted(leaves.items()))


@pytest.fixture(scope="module")
def reference():
    """The port's and the JAX package's single-process builds of the
    parity config."""
    prob = _problem()
    res = build_partition(prob, PartitionConfig(**BASE),
                          oracle=_oracle(prob))
    ref = jax_build(jax_make("double_integrator", **ARGS), JaxConfig(**BASE))
    assert _signature(res) == _signature(ref)
    assert res.stats["point_solves"] == ref.stats["point_solves"]
    return prob, res, ref


def _run_shards(prob, n_shards, wd, cfg_extra=None, timeout_s=180.0):
    """N engines in N threads over one exchange dir; returns
    [(PartitionResult, oracle, engine)] indexed by shard."""
    results = [None] * n_shards
    errors = [None] * n_shards

    def run(i):
        try:
            extra = cfg_extra(i) if callable(cfg_extra) \
                else (cfg_extra or {})
            cfg = PartitionConfig(
                **BASE, shard_frontier=True, shard_dir=wd,
                shard_index=i, shard_count=n_shards,
                shard_timeout_s=timeout_s, **extra)
            oracle = _oracle(prob)
            eng = FrontierEngine(prob, oracle, cfg)
            results[i] = (eng.run(), oracle, eng)
        except BaseException as e:  # surfaced by the assert below
            errors[i] = e

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(n_shards)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert all(e is None for e in errors), errors
    assert all(r is not None for r in results), "shard thread hung"
    return results


# -- ownership hash ---------------------------------------------------------


def test_shard_owner_is_the_jax_packages():
    """Every key maps to the JAX package's owner for every process count,
    and every (vertex, delta) cell to exactly one shard."""
    rng = np.random.default_rng(0)
    keys = [rng.standard_normal(2).round(9).tobytes()
            for _ in range(512)]
    for n in (1, 2, 3, 4):
        owners = [shard_owner(k, n) for k in keys]
        assert owners == [jshard.shard_owner(k, n) for k in keys]
        assert all(0 <= o < n for o in owners)
        if n > 1:
            # Non-degenerate spread (512 keys over <= 4 shards).
            assert len(set(owners)) == n


def test_shard_owner_deterministic_across_calls():
    k = np.asarray([0.125, -1.5]).tobytes()
    assert all(shard_owner(k, 4) == shard_owner(bytes(k), 4)
               for _ in range(10))
    assert shard_owner(k, 1) == 0


def test_owned_roots_round_robin():
    for n in (1, 2, 3):
        cover = sorted(sum((owned_root_indices(7, s, n)
                            for s in range(n)), []))
        assert cover == list(range(7))  # every root exactly once
        assert [owned_root_indices(7, s, n) for s in range(n)] \
            == [jshard.owned_root_indices(7, s, n) for s in range(n)]


def test_shard_cfg_validation():
    with pytest.raises(ValueError):
        PartitionConfig(**BASE, shard_timeout_s=0)
    with pytest.raises(ValueError):
        PartitionConfig(**BASE, shard_index=2, shard_count=2)
    with pytest.raises(ValueError):
        PartitionConfig(**BASE, shard_count=0)


# -- exchange protocol ------------------------------------------------------


def test_exchange_request_publish_roundtrip(tmp_path):
    """The port's exchange files are the JAX package's: a JAX shard reads
    the port's requests and publications and the port reads the JAX
    shard's."""
    nd, nt, nu, nz = 4, 2, 1, 3
    a = ShardExchange(str(tmp_path), 0, 2)
    b = ShardExchange(str(tmp_path), 1, 2)
    key = np.asarray([0.5, -0.25]).tobytes()
    theta = np.asarray([0.5, -0.25])
    need = np.asarray([True, False, True, False])
    assert b.request(key, theta, need) == 2
    # Duplicate request for the same cells is suppressed; a widened
    # request posts only the new cells.
    assert b.request(key, theta, need) == 0
    wider = np.asarray([True, True, True, False])
    assert b.request(key, theta, wider) == 1
    reqs = a.read_requests(nd)
    assert len(reqs) == 1
    rk, rtheta, rmask = reqs[0]
    assert rk == key
    np.testing.assert_array_equal(rtheta, theta)
    np.testing.assert_array_equal(rmask, wider)
    (jk, jtheta, jmask), = jshard.ShardExchange(
        str(tmp_path), 0, 2).read_requests(nd)
    assert jk == key and np.array_equal(jtheta, theta) \
        and np.array_equal(jmask, wider)
    # Owner answers: merge a partial row, publish, peer polls it in.
    a.merge_row(key, np.asarray([True, False, True, False]),
                V=np.arange(nd, dtype=float),
                conv=np.asarray([True, False, True, False]),
                grad=np.ones((nd, nt)), u0=np.ones((nd, nu)),
                z=np.ones((nd, nz)))
    assert a.publish([(key, rmask)]) == 1
    assert b.poll() == 1
    row = b.rows[key]
    np.testing.assert_array_equal(
        row["mask"], [True, False, True, False])
    assert row["V"][2] == 2.0 and not np.isfinite(row["V"][1])
    # Second publication covering more cells merges idempotently.
    a.merge_row(key, np.asarray([False, True, False, False]),
                V=np.full(nd, 7.0), conv=np.ones(nd, dtype=bool),
                grad=np.zeros((nd, nt)), u0=np.zeros((nd, nu)),
                z=np.zeros((nd, nz)))
    assert a.publish([(key, wider)]) == 1
    b.poll()
    np.testing.assert_array_equal(
        b.rows[key]["mask"], [True, True, True, False])
    assert b.rows[key]["V"][2] == 2.0  # earlier cells untouched
    assert b.rows[key]["V"][1] == 7.0
    # Fully-published cells are never re-shipped.
    assert a.publish([(key, wider)]) == 0
    # A JAX shard 1 reads the same publications to the same row.
    jb = jshard.ShardExchange(str(tmp_path), 1, 2)
    assert jb.poll() == 2
    for f in ("mask", "V", "conv", "grad", "u0", "z"):
        np.testing.assert_array_equal(jb.rows[key][f], b.rows[key][f])


def test_exchange_recovers_own_publications(tmp_path):
    """Crash/resume: a restarted owner must continue its publication
    sequence (an overwrite would be invisible to peers' basename
    dedup + sequence cursors) and serve re-read requests from the
    recovered store instead of re-solving."""
    nd, nt, nu, nz = 2, 2, 1, 3
    a = ShardExchange(str(tmp_path), 0, 2)
    key = np.asarray([0.25, 0.75]).tobytes()
    full = np.ones(nd, dtype=bool)
    a.merge_row(key, full, V=np.arange(nd, dtype=float),
                conv=np.ones(nd, dtype=bool), grad=np.ones((nd, nt)),
                u0=np.ones((nd, nu)), z=np.ones((nd, nz)))
    assert a.publish([(key, full)]) == 1
    # "Restart": a fresh exchange over the same dir.
    a2 = ShardExchange(str(tmp_path), 0, 2)
    assert a2._pub_seq == 1  # sequence continues, no overwrite
    assert key in a2.rows and a2.rows[key]["mask"].all()
    assert a2.publish([(key, full)]) == 0  # already published


def test_stale_shard_dir_rejected(tmp_path):
    """A reused shard_dir from a DIFFERENT build identity must be
    refused loudly (its recovered rows would be another problem's
    solutions keyed by theta coordinates)."""
    prob = _problem()
    cfg1 = PartitionConfig(**BASE, shard_frontier=True,
                           shard_dir=str(tmp_path), shard_index=0,
                           shard_count=2)
    FrontierEngine(prob, _oracle(prob), cfg1)  # claims the dir
    base2 = dict(BASE, eps_a=0.3)
    cfg2 = PartitionConfig(**base2, shard_frontier=True,
                           shard_dir=str(tmp_path), shard_index=1,
                           shard_count=2)
    with pytest.raises(ValueError, match="different build"):
        FrontierEngine(prob, _oracle(prob), cfg2)


# -- sharded build parity ----------------------------------------------------


@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_build_matches_single_process(reference, tmp_path,
                                              n_shards):
    """The N-shard build's merged tree has the JAX package's
    single-process tree signature (vertices bitwise, leaf commutations
    and certification) with ZERO duplicate (vertex, delta) solves:
    summed point solves equal the single-process count.  n_shards=4 on a
    2-root problem also runs idle shards through the exchange and drain
    protocol."""
    prob, res, ref = reference
    results = _run_shards(prob, n_shards, str(tmp_path))
    merged0 = results[0][0]
    # Every shard merges the identical global result.
    for r, _o, _e in results[1:]:
        assert compare_trees_canonical(merged0.tree, r.tree,
                                       payloads=True) == []
        assert r.stats["regions"] == merged0.stats["regions"]
    assert compare_trees_canonical(res.tree, merged0.tree) == []
    assert _signature(merged0) == _signature(ref)
    summed = sum(o.n_point_solves for _r, o, _e in results)
    assert summed == ref.stats["point_solves"]
    assert merged0.stats["point_solves"] == ref.stats["point_solves"]
    assert merged0.stats["simplex_solves"] == ref.stats["simplex_solves"]
    assert merged0.stats["uncertified"] == ref.stats["uncertified"] == 0
    # No shard hit the remote-timeout fallback.
    assert merged0.stats["shard_fallback_cells"] == 0
    assert merged0.stats["n_shards"] == n_shards
    assert len(merged0.stats["per_shard"]) == n_shards


def test_sharded_obs_counters_reconcile(reference, tmp_path):
    """Per-shard obs streams: summed final-snapshot counters equal the
    single-process build's."""
    from explicit_hybrid_mpc_tpu_torch.obs import fleet as fleet_lib

    prob, _res, _ref = reference
    ref_obs = str(tmp_path / "ref.obs.jsonl")
    res = build_partition(
        prob, PartitionConfig(**BASE, obs="jsonl", obs_path=ref_obs),
        oracle=_oracle(prob))
    wd = str(tmp_path / "ex")
    os.makedirs(wd)
    # Distinct per-shard stream paths: both engines share one PROCESS
    # here (threaded harness), so the per-process suffix cannot
    # disambiguate them the way it does for the launcher's processes.
    results = _run_shards(
        prob, 2, wd,
        cfg_extra=lambda i: {
            "obs": "jsonl",
            "obs_path": str(tmp_path / f"fleet.obs.p{i}.jsonl")})
    for _r, _o, eng in results:
        eng.finish_obs()
    ref_counters = fleet_lib.fleet_rollup(
        fleet_lib.load_fleet([ref_obs]))["counters"]
    roll = fleet_lib.fleet_rollup(
        fleet_lib.load_fleet(str(tmp_path / "fleet.obs.p*.jsonl")))
    assert roll["n_streams"] == 2
    for key in ("oracle.point_solves", "build.leaves", "build.splits"):
        assert roll["counters"].get(key) == ref_counters.get(key), key
    assert res.stats["regions"] == results[0][0].stats["regions"]
    # Sharded rollups carry the per-shard regions SUM alongside the
    # lockstep-max (each shard certifies its own subtree).
    assert roll["regions_sum"] == res.stats["regions"]


def test_sharded_checkpoints_are_per_shard(reference, tmp_path):
    prob, res, _ref = reference
    ck = str(tmp_path / "b.ckpt.pkl")
    results = _run_shards(
        prob, 2, str(tmp_path / "ex"),
        cfg_extra={"checkpoint_every": 2, "checkpoint_path": ck})
    assert results[0][0].stats["regions"] == res.stats["regions"]
    for i in (0, 1):
        path = f"{ck}.p{i}"
        assert os.path.exists(path), path
        snap = load_checkpoint(path)
        assert snap["cfg"].shard_frontier


def test_remote_timeout_falls_back_locally(reference, tmp_path):
    """Liveness: a shard whose peer never answers re-solves remote
    cells locally after shard_timeout_s and still finishes its own
    subtree soundly (loud: shard_fallback_cells > 0)."""
    prob, res, _ref = reference
    cfg = PartitionConfig(**BASE, shard_frontier=True,
                          shard_dir=str(tmp_path),
                          shard_index=0, shard_count=2,
                          shard_timeout_s=0.3)
    eng = FrontierEngine(prob, _oracle(prob), cfg)
    while eng.frontier:  # step manually: run() would block in finalize
        eng.step()
    assert eng._shard.fallback_cells > 0
    assert eng.n_uncertified == 0
    # This shard certified exactly its own root's subtree.
    assert 0 < eng.tree.n_regions() < res.stats["regions"]


# -- async host-certify ------------------------------------------------------


def test_async_certify_bit_identical(reference):
    """cfg.async_certify resolves the same device programs earlier:
    the tree is BIT-identical (payloads included) and solve counters
    are unchanged; the overlap ledger records background waits."""
    prob, ref, _jref = reference
    res = build_partition(
        prob, PartitionConfig(**BASE, async_certify=True),
        oracle=_oracle(prob))
    a, b = ref.tree, res.tree
    assert len(a) == len(b)
    assert np.array_equal(a.vertices, b.vertices)
    ia, ib = a.converged_leaf_ids(), b.converged_leaf_ids()
    assert np.array_equal(ia, ib)
    for xa, xb in zip(a.leaf_payloads(ia), b.leaf_payloads(ib)):
        assert np.array_equal(xa, xb)
    assert res.stats["point_solves"] == ref.stats["point_solves"]
    assert res.stats["async_certify"] is True
    assert res.stats["cp_overlap_s"] >= 0.0
    assert res.stats["regions"] == ref.stats["regions"]


def test_async_certify_absorbs_wait_into_certify_window(reference):
    """With a wait-side delay injected into the oracle (standing in for
    device latency), the background waiter absorbs wait wall into the
    certify window (cp_overlap_s > 0), and the tree stays BIT-identical
    to the same build without async certify."""
    import time as _time

    prob, _res, _ref = reference
    base = dict(BASE, batch_simplices=8)  # small batches: full-size
    # claims (the pipeline's lookahead unit) occur on most steps.

    def build(async_on: bool):
        oracle = _oracle(prob)
        orig = oracle.wait_vertices

        def slow_wait(handle):
            _time.sleep(0.01)
            return orig(handle)

        oracle.wait_vertices = slow_wait
        cfg = PartitionConfig(**base, async_certify=async_on)
        return FrontierEngine(prob, oracle, cfg).run()

    sync = build(False)
    asy = build(True)
    assert asy.stats["cp_overlap_s"] > 0.0, \
        "background waiter never absorbed a wait"
    assert sync.stats["cp_overlap_s"] == 0.0
    a, b = sync.tree, asy.tree
    assert np.array_equal(a.vertices, b.vertices)
    assert np.array_equal(a.converged_leaf_ids(),
                          b.converged_leaf_ids())
    assert asy.stats["point_solves"] == sync.stats["point_solves"]


def test_async_certify_with_sharding(reference, tmp_path):
    """Async certify composes with the sharded frontier: the parity bar
    is unchanged."""
    prob, res, ref = reference
    results = _run_shards(prob, 2, str(tmp_path),
                          cfg_extra={"async_certify": True})
    merged = results[0][0]
    assert compare_trees_canonical(res.tree, merged.tree) == []
    assert _signature(merged) == _signature(ref)
    summed = sum(o.n_point_solves for _r, o, _e in results)
    assert summed == ref.stats["point_solves"]


# -- merge / canonical compare ----------------------------------------------


def test_merge_rejects_diverged_roots(reference):
    _prob, res, _ref = reference
    t2 = pickle.loads(pickle.dumps(res.tree))
    t2._vertices[0, 0, 0] += 1.0
    with pytest.raises(ValueError, match="roots diverge"):
        merge_shard_trees([res.tree, t2], lambda r: r % 2)


def test_compare_trees_canonical_flags_status_drift(reference):
    _prob, res, _ref = reference
    assert compare_trees_canonical(res.tree, res.tree,
                                   payloads=True) == []
    t2 = pickle.loads(pickle.dumps(res.tree))
    leaf = int(t2.converged_leaf_ids()[0])
    t2.clear_leaf(leaf)
    diffs = compare_trees_canonical(res.tree, t2)
    assert diffs, "cleared leaf must surface as a canonical diff"
