"""Torch port: demand telemetry (explicit_hybrid_mpc_tpu_torch/obs/demand.py).

The first part mirrors the JAX package's tests/test_demand.py case for
case on the port: count-min accuracy under an adversarial key stream,
decay, reservoir determinism, the off mode (here held structurally,
not by a timing gate), snapshot commit and torn-load refusal, the
online suboptimality sampler's health gate, the per-controller
fallback oracle budget, and the warm-rebuild priority hint (hot leaves
first, the final tree identical) on the CPU.

The second part holds the port to the JAX package in one process, on
inputs made from a seed with numpy: the same ``record`` calls give the
same snapshot arrays and meta (apart from the time and host stamps); a
snapshot written by either package loads in the other with the same
priority map; both schedulers on the CPU (the plain versions of the
kernels) with demand and SLO on build the JAX schedulers' sketches on
the same requests, and the port hub's re-solves through its own CPU
Oracle give the JAX hub's V* to the oracle's parity bar (1e-8
relative); and the rebuild service with ``demand_dir`` orders its
prioritized rebuild as the JAX service does.  Host arrays: bitwise."""

import json
import os
import shutil
import time

import numpy as np
import pytest
import torch

import explicit_hybrid_mpc_tpu  # noqa: F401  (enables x64)
from explicit_hybrid_mpc_tpu import obs as jobs_lib
from explicit_hybrid_mpc_tpu.config import PartitionConfig as JaxConfig
from explicit_hybrid_mpc_tpu.config import ServeConfig as JaxServeConfig
from explicit_hybrid_mpc_tpu.obs import demand as jdemand
from explicit_hybrid_mpc_tpu.obs import slo as jslo
from explicit_hybrid_mpc_tpu.utils import atomic as jatomic
from explicit_hybrid_mpc_tpu_torch import obs as obs_lib
from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig, ServeConfig
from explicit_hybrid_mpc_tpu_torch.obs import demand as demand_mod
from explicit_hybrid_mpc_tpu_torch.obs.demand import (CM_DEPTH, DemandHub,
                                                      ExceedHist, LeafSketch,
                                                      Reservoir,
                                                      SuboptSampler,
                                                      hub_from_serve_config,
                                                      load_demand,
                                                      priority_from_snapshot,
                                                      top_decile_frac)
from explicit_hybrid_mpc_tpu_torch.obs.health import HealthMonitor
from explicit_hybrid_mpc_tpu_torch.utils import atomic

torch.set_num_threads(1)

CPU = torch.device("cpu")
DI_ARGS = (("N", 3), ("theta_box", 1.5))


class _Clock:
    """Injectable monotonic clock: decay/cadence under test control."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


# -- LeafSketch --------------------------------------------------------------


def test_leafsketch_exact_mode_matches_truth():
    clk = _Clock()
    sk = LeafSketch(max_leaves=1024, decay_halflife_s=300.0, clock=clk)
    rng = np.random.default_rng(0)
    truth: dict[int, float] = {}
    for _ in range(20):
        batch = rng.integers(0, 100, size=64)
        sk.update(batch)
        for k in batch.tolist():
            truth[k] = truth.get(k, 0.0) + 1.0
    assert sk.mode == "exact"
    for k, v in truth.items():
        assert sk.estimate(k) == v
    ids, hits = sk.items()
    assert ids.size == len(truth)
    assert all(hits[i] >= hits[i + 1] for i in range(hits.size - 1))
    assert sk.total == pytest.approx(sum(truth.values()))


def test_leafsketch_countmin_adversarial_never_underestimates():
    clk = _Clock()
    sk = LeafSketch(max_leaves=32, decay_halflife_s=300.0, seed=3,
                    clock=clk)
    rng = np.random.default_rng(7)
    n_keys = 400
    keys = rng.integers(0, 2 ** 40, size=n_keys)
    w = 1.0 / np.arange(1, n_keys + 1) ** 1.2
    w /= w.sum()
    truth: dict[int, float] = {}
    for _ in range(40):
        batch = rng.choice(keys, size=128, p=w)
        sk.update(batch)
        for k in batch.tolist():
            truth[k] = truth.get(k, 0.0) + 1.0
    assert sk.mode == "countmin"
    total = sum(truth.values())
    assert sk.total == pytest.approx(total)
    bound = 2.0 * total / sk.width
    n_over = 0
    for k, v in truth.items():
        est = sk.estimate(k)
        assert est >= v - 1e-9, f"count-min underestimated key {k}"
        if est > v + bound:
            n_over += 1
    assert n_over <= 2 * len(truth) * 2.0 ** -CM_DEPTH
    hottest = max(truth, key=truth.get)
    assert hottest in [k for k, _h in sk.top(5)]


def test_leafsketch_decay_ages_old_traffic():
    clk = _Clock()
    sk = LeafSketch(max_leaves=64, decay_halflife_s=10.0, clock=clk)
    sk.update(np.full(100, 1))
    clk.t = 10.0
    sk.update(np.full(60, 2))
    assert sk.estimate(1) == pytest.approx(50.0)
    assert sk.estimate(2) == pytest.approx(60.0)
    ids, _hits = sk.items()
    assert ids[0] == 2
    clk.t = 210.0
    assert sk.estimate(1) < 1e-3
    assert sk.total == pytest.approx(110.0 * 0.5 ** 20, abs=1e-3)


def test_top_decile_frac_shapes():
    assert top_decile_frac(np.empty(0)) is None
    assert top_decile_frac(np.array([5.0])) == 1.0
    assert top_decile_frac(np.full(20, 3.0)) == pytest.approx(0.1)
    assert top_decile_frac(np.r_[1000.0, np.full(9, 1.0)]) > 0.99


# -- Reservoir / ExceedHist --------------------------------------------------


def test_reservoir_seeded_determinism_and_bound():
    rng = np.random.default_rng(11)
    stream = rng.uniform(-1, 1, size=(300, 3))
    r1, r2 = Reservoir(k=16, seed=5), Reservoir(k=16, seed=5)
    for lo in range(0, 300, 32):
        r1.add(stream[lo:lo + 32])
        r2.add(stream[lo:lo + 32])
    assert r1.n_seen == r2.n_seen == 300
    assert r1.sample().shape == (16, 3)
    np.testing.assert_array_equal(r1.sample(), r2.sample())
    r3 = Reservoir(k=16, seed=6)
    r3.add(stream)
    assert not np.array_equal(r1.sample(), r3.sample())
    seen = {tuple(row) for row in stream}
    assert all(tuple(row) in seen for row in r1.sample())


def test_exceed_hist_attributes_dimensions():
    h = ExceedHist(3)
    lb, ub = np.zeros(3), np.ones(3)
    th = np.array([[1.5, 0.5, 0.5],
                   [2.0, 0.5, -0.2],
                   [0.5, 0.5, 0.5]])
    h.update(th, lb, ub)
    assert h.hi.tolist() == [2, 0, 0]
    assert h.lo.tolist() == [0, 0, 1]
    assert h.hot_dims() == [0, 2]


# -- off mode ----------------------------------------------------------------


class _Untouchable:
    """An argument that raises as soon as anything converts or reads
    it: an off hub must return before looking at its arguments."""

    def __array__(self, *a, **kw):
        raise AssertionError("the off hub converted an argument")

    def __len__(self):
        raise AssertionError("the off hub read an argument")

    def __iter__(self):
        raise AssertionError("the off hub iterated an argument")


def test_demand_off_mode_is_noop_and_under_one_percent(tmp_path):
    """The JAX test times mode='off' against a serving batch; here the
    same contract is held structurally: ``record`` returns before it
    reads an argument, no state is kept, nothing is written and no
    thread is started, even with a snapshot dir and an oracle given."""
    hub = DemandHub(snapshot_dir=str(tmp_path), oracle=object())
    assert not hub.enabled and hub._thread is None
    x = _Untouchable()
    for _ in range(100):
        assert hub.record("c", x, x, x, x, x, box=x, n_leaves=x) is None
    assert hub._ctl == {}
    assert hub.snapshot() == {}
    hub.close()
    assert os.listdir(tmp_path) == []
    assert hub_from_serve_config(ServeConfig()) is None


# -- hub capture + snapshot commit -------------------------------------------


def _fill_hub(hub, name: str = "c") -> None:
    """One deterministic capture mix (the JAX tests' own): hot leaves
    3/7, some fallback rows outside the unit box on dim 0, one in-box
    hole."""
    rng = np.random.default_rng(4)
    box = (np.zeros(2), np.ones(2))
    for _ in range(8):
        thetas = rng.uniform(0, 1, size=(16, 2))
        leaf = np.r_[np.full(10, 3), np.full(4, 7),
                     rng.integers(0, 50, size=2)]
        hub.record(name, thetas, leaf, None,
                   np.ones(16, dtype=bool), np.zeros(16), box=box,
                   n_leaves=64)
    bad_th = np.array([[1.7, 0.5], [2.1, 0.4], [0.5, 0.5]])
    hub.record(name, bad_th, np.array([-1, -1, -1]),
               ["clamp", "clamp", "oracle"],
               np.array([False, False, False]), np.zeros(3), box=box)


def test_hub_snapshot_roundtrip_and_priority_mapping(tmp_path):
    clk = _Clock()
    o = obs_lib.Obs("jsonl")
    hub = DemandHub(mode="on", max_leaves=256, reservoir_k=8,
                    snapshot_dir=str(tmp_path), obs=o, clock=clk)
    _fill_hub(hub)
    metas = hub.snapshot()
    hub.close(snapshot=False)
    meta = metas["c"]
    assert meta["schema"] == demand_mod.SNAPSHOT_SCHEMA == "demand-v1"
    assert meta["sketch"]["mode"] == "exact"
    assert meta["leaves_observed"] >= 2
    assert meta["n_leaves_hint"] == 64
    assert meta["hot"][0][0] == 3
    assert meta["fallback"]["outside_seen"] == 2
    assert meta["fallback"]["hole_seen"] == 1
    assert meta["fallback"]["exceed_dims"] == [0]
    snap = load_demand(str(tmp_path / "c"))
    assert snap.meta["npz_sha256"] == meta["npz_sha256"]
    assert snap.leaf_ids[0] == 3
    assert snap.top_decile_frac == pytest.approx(meta["top_decile_frac"])
    assert snap.res_outside.shape[0] == 2
    assert snap.exceed_hi[0] == 2
    evs = [r for r in o.sink.records if r.get("name") == "demand.snapshot"]
    assert evs and evs[-1]["controller"] == "c"
    for key in ("leaves_observed", "top_decile_frac", "hot",
                "exceed_dims", "subopt_p50", "subopt_p99",
                "subopt_samples", "subopt_offered"):
        assert key in evs[-1]
    o.close()
    node_id = np.arange(100, 150)
    pr = priority_from_snapshot(snap, node_id)
    assert pr[103] == pytest.approx(float(snap.leaf_hits[0]))
    assert all(100 <= n < 150 for n in pr)
    assert set(priority_from_snapshot(snap, np.arange(2))) <= {0, 1}


def test_concurrent_snapshots_never_mix_their_files(tmp_path,
                                                    monkeypatch):
    """Two writers of one controller's snapshot (the maintenance
    thread's periodic one and a caller's) take turns.  A slow writer's
    meta is delayed so that, without the turns, a second writer's npz
    and meta land between the first's npz and meta, and the first's
    meta, written last, names an npz that is no longer there: the strict
    load fails."""
    import threading

    hub = DemandHub(mode="on", snapshot_dir=str(tmp_path), clock=_Clock())
    _fill_hub(hub)
    real = atomic.atomic_write_json

    def slow_meta(*a, **kw):
        if threading.current_thread().name == "slow-writer":
            time.sleep(0.3)
        return real(*a, **kw)

    monkeypatch.setattr(atomic, "atomic_write_json", slow_meta)
    slow = threading.Thread(target=hub.snapshot, name="slow-writer")
    slow.start()
    time.sleep(0.1)
    # Different contents, so the two npz files differ.
    hub.record("c", np.full((1, 2), 0.5), np.array([9]), [None],
               np.array([True]), np.array([1.0]),
               box=(np.zeros(2), np.ones(2)))
    hub.snapshot()
    slow.join(60)
    assert not slow.is_alive()
    hub.close(snapshot=False)
    snap = load_demand(str(tmp_path / "c"))   # strict: npz sha == meta's
    assert snap.meta["controller"] == "c"


def test_a_periodic_snapshot_never_overwrites_a_newer_one(tmp_path):
    """The maintenance thread's periodic snapshot, checked under the
    snapshot lock, is skipped while the interval since ANY writer's
    last snapshot has not passed: a caller's snapshot (a bench's
    epilogue, strict-loaded against the meta it returned) stays the
    newest.  Sketch decay makes a later snapshot's npz differ."""
    clock = _Clock()
    hub = DemandHub(mode="on", snapshot_dir=str(tmp_path), clock=clock,
                    snapshot_every_s=1.0)
    _fill_hub(hub)
    clock.t = 5.0
    meta = hub.snapshot()["c"]
    clock.t = 5.5    # a periodic snapshot that waited behind the caller's
    hub._periodic_snapshot()
    assert load_demand(str(tmp_path / "c")).meta["npz_sha256"] \
        == meta["npz_sha256"]
    clock.t = 6.0    # the interval has passed: it writes
    hub._periodic_snapshot()
    newer = load_demand(str(tmp_path / "c")).meta["npz_sha256"]
    hub.close(snapshot=False)
    assert newer != meta["npz_sha256"]


def test_torn_snapshot_never_loads(tmp_path):
    hub = DemandHub(mode="on", snapshot_dir=str(tmp_path), clock=_Clock())
    _fill_hub(hub)
    hub.snapshot()
    hub.close(snapshot=False)
    good = tmp_path / "c"
    assert load_demand(str(good)).leaf_ids.size

    torn_a = tmp_path / "torn_a"
    shutil.copytree(good, torn_a)
    os.remove(torn_a / "demand.json")
    with pytest.raises(atomic.CorruptArtifact, match="never committed"):
        load_demand(str(torn_a))

    torn_b = tmp_path / "torn_b"
    shutil.copytree(good, torn_b)
    with open(torn_b / "demand.npz", "r+b") as f:
        f.truncate(max(8, os.path.getsize(torn_b / "demand.npz") // 2))
    with pytest.raises(atomic.CorruptArtifact, match="sha256 mismatch"):
        load_demand(str(torn_b))

    torn_c = tmp_path / "torn_c"
    shutil.copytree(good, torn_c)
    with open(torn_c / "demand.json") as f:
        meta = json.load(f)
    meta["schema"] = "demand-v999"
    with open(torn_c / "demand.json", "w") as f:
        json.dump(meta, f)
    with pytest.raises(atomic.CorruptArtifact, match="unknown demand"):
        load_demand(str(torn_c))

    with pytest.raises(FileNotFoundError):
        load_demand(str(tmp_path / "never_written"))


# -- online suboptimality sampling -------------------------------------------


class _GapOracle:
    """solve_vertices stand-in: V* = 0 for every theta."""

    def __init__(self):
        self.n_calls = 0

    def solve_vertices(self, thetas):
        from types import SimpleNamespace

        self.n_calls += thetas.shape[0]
        K = thetas.shape[0]
        return SimpleNamespace(Vstar=np.zeros(K),
                               dstar=np.zeros(K, dtype=np.int64))


def test_subopt_sampler_stride_and_budget():
    s = SuboptSampler(frac=0.25, max_pending=4)
    thetas = np.arange(16, dtype=np.float64).reshape(8, 2)
    s.offer(thetas, np.arange(8.0), np.ones(8, dtype=bool))
    assert s.n_offered == 2
    s.offer(thetas, np.arange(8.0), np.ones(8, dtype=bool))
    s.offer(thetas, np.arange(8.0), np.ones(8, dtype=bool))
    assert s.n_offered == 6
    assert s.n_dropped == 2
    th, v = s.take_pending()
    assert th.shape == (4, 2) and v.shape == (4,)
    assert len(s._pending_theta) == 0
    # The queued rows are copies: the caller's buffers may be reused.
    s.offer(thetas, np.arange(8.0), np.ones(8, dtype=bool))
    thetas[:] = -1.0
    th, _v = s.take_pending()
    assert (th >= 0).all()


def test_hub_subopt_gauges_and_health_gate():
    clk = _Clock()
    o = obs_lib.Obs("jsonl")
    oracle = _GapOracle()
    hub = DemandHub(mode="on", subopt_frac=1.0, subopt_eps=0.01,
                    oracle=oracle, obs=o, clock=clk)
    thetas = np.random.default_rng(5).uniform(0, 1, size=(16, 2))
    costs = np.full(16, 0.05)
    hub.record("c", thetas, np.zeros(16), None,
               np.ones(16, dtype=bool), costs)
    hub.drain_for_test()
    g = o.metrics.snapshot()["gauges"]
    assert g["serve.ctl.c.subopt_p50"] == pytest.approx(0.05)
    assert g["serve.ctl.c.subopt_p99"] == pytest.approx(0.05)
    assert not [r for r in o.sink.records
                if r.get("name") == "health.subopt"]
    hub.record("c", thetas, np.zeros(16), None,
               np.ones(16, dtype=bool), costs)
    hub.drain_for_test()
    hub.drain_for_test()
    evs = [r for r in o.sink.records if r.get("name") == "health.subopt"]
    assert len(evs) == 1
    assert evs[0]["severity"] == "warn"
    assert evs[0]["controller"] == "c"
    assert evs[0]["value"] == pytest.approx(0.05)
    assert oracle.n_calls == 32
    assert hub.subopt_p99("c") == pytest.approx(0.05)
    mon = HealthMonitor({"max_subopt": 0.01})
    fired = mon.feed(o.flush_metrics())
    assert [e["name"] for e in fired] == ["health.subopt"]
    hub.close(snapshot=False)
    o.close()


def test_hub_subopt_clamps_knife_edge_negative_gaps():
    from types import SimpleNamespace

    class _HighOracle:
        def solve_vertices(self, thetas):
            K = thetas.shape[0]
            return SimpleNamespace(Vstar=np.full(K, 1.0),
                                   dstar=np.zeros(K, dtype=np.int64))

    hub = DemandHub(mode="on", subopt_frac=1.0, oracle=_HighOracle(),
                    clock=_Clock())
    hub.record("c", np.zeros((8, 2)), np.zeros(8), None,
               np.ones(8, dtype=bool), np.full(8, 1.0 - 1e-12))
    hub.drain_for_test()
    p50, p99 = hub._ctl["c"].subopt.quantiles()
    assert p50 == 0.0 and p99 == 0.0
    hub.close(snapshot=False)


def test_maintenance_errors_become_demand_error_events():
    """The maintenance thread turns an oracle failure into a
    demand.error event and keeps running (telemetry never kills
    serving)."""
    class _Broken:
        def solve_vertices(self, thetas):
            raise RuntimeError("device lost")

    clk = _Clock()
    o = obs_lib.Obs("jsonl")
    hub = DemandHub(mode="on", subopt_frac=1.0, oracle=_Broken(), obs=o,
                    clock=clk)
    hub.record("c", np.zeros((4, 2)), np.zeros(4), None,
               np.ones(4, dtype=bool), np.zeros(4))
    clk.t = 1.0     # past the drain cadence
    hub._wake.set()
    deadline = time.perf_counter() + 10.0
    while time.perf_counter() < deadline and not any(
            r.get("name") == "demand.error" for r in o.sink.records):
        time.sleep(0.01)
    errs = [r for r in o.sink.records if r.get("name") == "demand.error"]
    assert errs and "device lost" in errs[0]["msg"]
    assert hub._thread.is_alive()
    # The closing drain runs on the caller's thread and is not swallowed.
    hub.record("c", np.zeros((4, 2)), np.zeros(4), None,
               np.ones(4, dtype=bool), np.zeros(4))
    with pytest.raises(RuntimeError, match="device lost"):
        hub.close(snapshot=False)
    o.close()


def test_hub_from_serve_config():
    assert hub_from_serve_config(ServeConfig()) is None
    cfg = ServeConfig(demand="on", demand_max_leaves=77,
                      demand_decay_s=12.5, demand_reservoir=9,
                      demand_subopt_frac=0.25, demand_subopt_eps=0.3)
    hub = hub_from_serve_config(cfg)
    assert hub is not None and hub.enabled
    assert hub.max_leaves == 77
    assert hub.decay_halflife_s == 12.5
    assert hub.reservoir_k == 9
    assert hub.subopt_frac == 0.25
    assert hub.subopt_eps == 0.3
    hub.close()


# -- per-controller fallback oracle budget (two-tenant regression) -----------


def test_fallback_oracle_budget_scoped_per_controller():
    from explicit_hybrid_mpc_tpu_torch.online import descent, export, sharded
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
    dt = descent.export_descent(t, [r], table, stage=False)
    srv = sharded.shard_descent(dt, table, n_shards=2, granularity=1,
                                devices=[CPU])

    class _Oracle(_GapOracle):
        def solve_vertices(self, thetas):
            from types import SimpleNamespace

            self.n_calls += thetas.shape[0]
            K = thetas.shape[0]
            return SimpleNamespace(dstar=np.zeros(K, dtype=np.int64),
                                   u0=np.ones((K, 1, 1)),
                                   Vstar=thetas.sum(axis=1))

    fb = FallbackPolicy(np.zeros(1), np.ones(1), oracle=_Oracle(),
                        max_oracle_frac=0.1)
    rng = np.random.default_rng(6)
    th_b = rng.uniform(0.01, 0.49, size=(100, 1))
    _res, tags = fb.apply(th_b, srv.evaluate(th_b), srv, controller="B")
    assert tags == [None] * 100
    th_a = rng.uniform(0.51, 0.99, size=(20, 1))
    _res, tags_a = fb.apply(th_a, srv.evaluate(th_a), srv, controller="A")
    assert tags_a.count("oracle") == 2
    assert tags_a.count("unserved") == 18
    assert fb.oracle_spent("A") == 2
    th_b2 = np.r_[rng.uniform(0.01, 0.49, size=(5, 1)),
                  rng.uniform(0.51, 0.99, size=(5, 1))]
    _res, tags_b2 = fb.apply(th_b2, srv.evaluate(th_b2), srv,
                             controller="B")
    assert tags_b2[:5] == [None] * 5
    assert tags_b2[5:] == ["oracle"] * 5
    assert fb.oracle_spent("B") == 5
    assert fb.n_seen == 130
    assert fb.n_oracle == 7


# -- warm_rebuild priority hint ----------------------------------------------


@pytest.fixture(scope="module")
def depth_capped_prior():
    """The JAX tests' depth-capped build (max_depth=6): its best-effort
    leaves are invalidated by the rebuild but cannot split."""
    from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
        build_partition)
    from explicit_hybrid_mpc_tpu_torch.problems.registry import make

    prob = make("double_integrator", N=3, theta_box=1.5)
    cfg = PartitionConfig(problem="double_integrator", eps_a=0.3,
                          backend="cpu", batch_simplices=128, max_depth=6)
    return prob, cfg, build_partition(prob, cfg)


def test_warm_rebuild_priority_hot_first_and_bit_identical(
        depth_capped_prior):
    from explicit_hybrid_mpc_tpu_torch.online import export
    from explicit_hybrid_mpc_tpu_torch.partition.rebuild import warm_rebuild

    prob, cfg, prior = depth_capped_prior
    ra = warm_rebuild(prob, cfg, prior)
    assert ra.stats["rebuild_leaves_invalidated"] > 0
    assert ra.stats["rebuild_priority_hint"] == 0
    order_a = ra.stats["rebuild_priority_order"]
    assert order_a == sorted(order_a)
    hot = [order_a[-1], order_a[3]]
    rb = warm_rebuild(prob, cfg, prior,
                      priority={hot[0]: 100.0, hot[1]: 40.0})
    assert rb.stats["rebuild_priority_hint"] == 2
    order_b = rb.stats["rebuild_priority_order"]
    assert order_b[:2] == hot
    rest = [n for n in order_a if n not in hot]
    assert order_b[2:] == rest[:len(order_b) - 2]
    assert len(ra.tree) == len(rb.tree) == len(prior.tree)
    assert (rb.stats["rebuild_leaves_invalidated"]
            == ra.stats["rebuild_leaves_invalidated"])
    sa, sb = ra.tree.__getstate__(), rb.tree.__getstate__()
    for key in ("children", "parent", "depth", "leaf_flags", "normal",
                "offset", "split_edge", "n", "n_regions"):
        assert np.array_equal(sa[key], sb[key]), f"tree field {key} diverged"
    assert (set(map(tuple, sa["excl_events"] or []))
            == set(map(tuple, sb["excl_events"] or [])))
    ta, tb = export.export_leaves(ra.tree), export.export_leaves(rb.tree)
    for name, va, vb in zip(ta._fields, ta, tb):
        assert (np.array_equal(va, vb) if isinstance(va, np.ndarray)
                else va == vb), f"exported leaf table field {name} diverged"


# -- parity with the JAX package ---------------------------------------------


_STAMPS = ("written_t", "host", "pid")


def _meta_sans_stamps(meta: dict) -> dict:
    meta = json.loads(json.dumps(meta))
    meta["window"].pop("written_t")
    meta.pop("provenance")
    return meta


def _scripted_records(hub, seed: int, n_batches: int = 40) -> None:
    """Seeded record calls over three controllers: skewed leaf rows
    (one controller past max_leaves, so it spills to count-min), some
    unserved and fallback rows with boxes, with and without tags."""
    rng = np.random.default_rng(seed)
    lb, ub = np.array([-1.0, -2.0, 0.0]), np.array([1.0, 2.0, 3.0])
    for b in range(n_batches):
        name = ("a", "b", "wide")[b % 3]
        k = int(rng.integers(1, 48))
        th = rng.uniform(lb - 0.5, ub + 0.5, (k, 3))
        span = 40 if name != "wide" else 5000
        leaf = np.minimum(rng.zipf(1.3, k), span).astype(np.int64) - 1
        served = rng.uniform(size=k) > 0.1
        outside = ((th < lb) | (th > ub)).any(axis=1)
        tags = [("clamp" if o else ("unserved" if not s else None))
                for o, s in zip(outside, served)]
        costs = rng.uniform(0, 5, k)
        hub.record(name, th, leaf, tags if b % 4 else None, served, costs,
                   box=(lb, ub) if b % 5 else None,
                   n_leaves=span if b % 2 else None)


@pytest.mark.parametrize("seed", [0, 1])
def test_same_records_give_the_jax_hubs_snapshot(seed, tmp_path):
    hubs = {}
    for pkg, mod, obs_mod in (("jax", jdemand, jobs_lib),
                              ("torch", demand_mod, obs_lib)):
        o = obs_mod.Obs("jsonl")
        hub = mod.DemandHub(mode="on", max_leaves=64, reservoir_k=6,
                            subopt_frac=0.125, subopt_eps=0.5,
                            snapshot_dir=str(tmp_path / pkg), obs=o,
                            seed=seed, clock=_Clock(3.0))
        _scripted_records(hub, seed)
        hubs[pkg] = (hub, hub.snapshot(), o)
    (jh, jmeta, jo), (th, tmeta, to) = hubs["jax"], hubs["torch"]
    assert set(tmeta) == set(jmeta) == {"a", "b", "wide"}
    assert tmeta["wide"]["sketch"]["mode"] == "countmin"
    for name in jmeta:
        assert _meta_sans_stamps(tmeta[name]) \
            == _meta_sans_stamps(jmeta[name])
        with np.load(tmp_path / "jax" / name / "demand.npz") as zj, \
                np.load(tmp_path / "torch" / name / "demand.npz") as zt:
            assert sorted(zt.files) == sorted(zj.files)
            for k in zj.files:
                assert zt[k].dtype == zj[k].dtype, (name, k)
                assert zt[k].tobytes() == zj[k].tobytes(), (name, k)
        # The pending re-solve queues are the same rows, in order.
        for a, b in zip(th.ctl(name).subopt.take_pending(256),
                        jh.ctl(name).subopt.take_pending(256)):
            assert a.tobytes() == b.tobytes()
    # The demand.snapshot events, apart from time stamps and the dir.
    strip = ("t", "t_abs", "seq", "dir")
    got, exp = ([{k: v for k, v in r.items() if k not in strip}
                 for r in o.sink.records if r.get("name") == "demand.snapshot"]
                for o in (to, jo))
    assert got == exp and got
    assert to.metrics.snapshot() == jo.metrics.snapshot()
    for h, _m, o in hubs.values():
        h.close(snapshot=False)
        o.close()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_snapshots_load_across_the_packages(writer, tmp_path):
    w_mod, r_mod = ((jdemand, demand_mod) if writer == "jax"
                    else (demand_mod, jdemand))
    hub = w_mod.DemandHub(mode="on", max_leaves=64,
                          snapshot_dir=str(tmp_path), clock=_Clock())
    _scripted_records(hub, 5)
    hub.close()
    node_id = np.random.default_rng(9).permutation(80) + 1000
    for name in ("a", "b", "wide"):
        d = str(tmp_path / name)
        own, other = w_mod.load_demand(d), r_mod.load_demand(d)
        assert other.meta == own.meta
        for f in ("leaf_ids", "leaf_hits", "exceed_lo", "exceed_hi",
                  "res_outside", "res_hole", "subopt"):
            assert getattr(other, f).tobytes() == getattr(own, f).tobytes()
        assert other.top_decile_frac == own.top_decile_frac
        assert (r_mod.priority_from_snapshot(other, node_id)
                == w_mod.priority_from_snapshot(own, node_id))
    # A torn snapshot is refused by the reader too, with its own class.
    os.remove(tmp_path / "a" / "demand.json")
    with pytest.raises((atomic if writer == "jax"
                        else jatomic).CorruptArtifact):
        r_mod.load_demand(str(tmp_path / "a"))


@pytest.fixture(scope="module")
def di_artifacts(tmp_path_factory):
    """The tier-1 DI tree at eps_a 0.5, built and saved by the JAX
    package (both registries load this directory)."""
    from explicit_hybrid_mpc_tpu.partition.frontier import (
        build_partition as jax_build)
    from explicit_hybrid_mpc_tpu.problems.registry import make as jax_make
    from explicit_hybrid_mpc_tpu.serve import registry as jregistry

    jres = jax_build(jax_make("double_integrator", **dict(DI_ARGS)),
                     JaxConfig(problem="double_integrator",
                               problem_args=DI_ARGS, backend="cpu",
                               eps_a=0.5, batch_simplices=64))
    d = str(tmp_path_factory.mktemp("demand_di") / "v1")
    jregistry.save_artifacts(jres.tree, jres.roots, d)
    return d


def _drain_all(hub) -> None:
    for _ in range(64):
        if not any(st.subopt._pending_theta for st in hub._ctl.values()):
            return
        hub.drain_for_test()


def _compare_snapshots(tmp_path, names, subopt_rtol=1e-8):
    for name in names:
        dj, dt = (load_demand(str(tmp_path / p / name))
                  for p in ("jax", "torch"))
        mj, mt = (_meta_sans_stamps(d.meta) for d in (dj, dt))
        sj, st = mj.pop("subopt"), mt.pop("subopt")
        for m in (mj, mt):
            m.pop("npz_sha256")
        assert mt == mj, name
        for f in ("leaf_ids", "leaf_hits", "exceed_lo", "exceed_hi",
                  "res_outside", "res_hole"):
            assert getattr(dt, f).tobytes() == getattr(dj, f).tobytes(), \
                (name, f)
        assert {k: v for k, v in st.items() if k not in ("p50", "p99")} \
            == {k: v for k, v in sj.items() if k not in ("p50", "p99")}
        assert st["n_samples"] > 0
        np.testing.assert_allclose(dt.subopt, dj.subopt, rtol=subopt_rtol,
                                   atol=1e-9)


def test_request_schedulers_build_the_jax_sketches(di_artifacts, tmp_path,
                                                   monkeypatch):
    """`main serve`'s path on the CPU in both packages: the same
    requests through a RequestScheduler with demand and SLO on give
    the same sketch, reservoirs and exceedance, and the hubs' re-solves
    (each through its own package's CPU Oracle) the same V_served - V*
    to the oracle's bar."""
    from explicit_hybrid_mpc_tpu.oracle.oracle import Oracle as JOracle
    from explicit_hybrid_mpc_tpu.problems.registry import make as jax_make
    from explicit_hybrid_mpc_tpu.serve import FallbackPolicy as JFallback
    from explicit_hybrid_mpc_tpu.serve import registry as jregistry
    from explicit_hybrid_mpc_tpu.serve import scheduler as jsched_mod
    from explicit_hybrid_mpc_tpu.serve.scheduler import (
        RequestScheduler as JSched)
    from explicit_hybrid_mpc_tpu_torch.obs import slo as tslo
    from explicit_hybrid_mpc_tpu_torch.oracle.oracle import Oracle
    from explicit_hybrid_mpc_tpu_torch.problems.registry import make
    from explicit_hybrid_mpc_tpu_torch.serve import (FallbackPolicy,
                                                     RequestScheduler)
    from explicit_hybrid_mpc_tpu_torch.serve import registry
    from explicit_hybrid_mpc_tpu_torch.serve import scheduler as sched_mod

    # Every micro-batch flushes a metrics snapshot and ticks the SLO
    # tracker (whose clock is frozen below: one ring slot).
    for m in (jsched_mod, sched_mod):
        monkeypatch.setattr(m, "METRICS_FLUSH_S", 0.0)

    rng = np.random.default_rng(21)
    lb, ub = np.full(2, -1.5), np.full(2, 1.5)
    # A tenth of the queries leave the box along ONE dimension, so their
    # clamped images fall inside an edge of the box, never on a corner
    # that several leaves share (a tie either package may break).
    thetas = rng.uniform(lb, ub, (600, 2))
    out = rng.uniform(size=600) < 0.1
    dim = rng.integers(0, 2, 600)
    thetas[out, dim[out]] = np.sign(thetas[out, dim[out]]) \
        * rng.uniform(1.6, 1.9, int(out.sum()))
    kw = dict(controller="di", demand="on", demand_subopt_frac=1 / 16,
              demand_subopt_eps=0.5, slo="on", slo_interval_s=1.0)
    sides = {
        "jax": (JaxServeConfig(**kw), jregistry, JFallback, JSched,
                jdemand, jslo, jobs_lib,
                lambda: JOracle(jax_make("double_integrator",
                                         **dict(DI_ARGS)), backend="cpu"),
                {}),
        "torch": (ServeConfig(**kw), registry, FallbackPolicy,
                  RequestScheduler, demand_mod, tslo, obs_lib,
                  lambda: Oracle(make("double_integrator", **dict(DI_ARGS)),
                                 backend="cpu"),
                  {"devices": [CPU]})}
    answers = {}
    for pkg, (cfg, reg_mod, fb_cls, sched_cls, dmod, smod, omod, mk_oracle,
              dev_kw) in sides.items():
        o = omod.Obs("jsonl")
        reg = reg_mod.ControllerRegistry(obs=o)
        ver = reg.load_artifacts("di", "v1", di_artifacts, n_shards=2,
                                 **dev_kw)
        fb = fb_cls(*reg_mod.root_box(ver.server), obs=o)
        hub = dmod.DemandHub(
            mode="on", subopt_frac=cfg.demand_subopt_frac,
            subopt_eps=cfg.demand_subopt_eps, oracle=mk_oracle(), obs=o,
            clock=_Clock())
        tracker = smod.slo_from_serve_config(cfg, obs=o)
        tracker._clock = _Clock()
        sched = sched_cls(reg, "di", max_batch=64, max_wait_us=200_000.0,
                          fallback=fb, obs=o, demand=hub, slo=tracker)
        res = sched.submit_batch(thetas).result(60.0)
        sched.close()
        _drain_all(hub)
        hub.snapshot(dir_path=str(tmp_path / pkg / "di"), name="di")
        answers[pkg] = (res, tracker.evaluate())
        hub.close(snapshot=False)
        o.close()
    (jr, jev), (tr, tev) = answers["jax"], answers["torch"]
    assert [r.leaf for r in tr] == [r.leaf for r in jr]
    assert [r.fallback for r in tr] == [r.fallback for r in jr]
    # The tracker discovered the controller and holds its fallback SLO
    # on the same counters in both packages.
    assert tev["di.fallback"]["good"] == jev["di.fallback"]["good"]
    assert tev["di.fallback"]["bad"] == jev["di.fallback"]["bad"] > 0
    _compare_snapshots(tmp_path, ["di"])


def test_arena_schedulers_build_the_jax_sketches(tmp_path):
    """Four tenants in one arena (the port's plain arena on the CPU, the
    JAX package's XLA arena), the same requests through an
    ArenaScheduler with demand on: per-tenant sketches, reservoirs and
    exceedance equal, the stride samples the same rows."""
    from explicit_hybrid_mpc_tpu.online import export as jexport
    from explicit_hybrid_mpc_tpu.serve import DeviceArena as JArena
    from explicit_hybrid_mpc_tpu.serve import FallbackPolicy as JFallback
    from explicit_hybrid_mpc_tpu.serve.scheduler import (
        ArenaScheduler as JSched)
    from explicit_hybrid_mpc_tpu_torch.online import export
    from explicit_hybrid_mpc_tpu_torch.partition import geometry
    from explicit_hybrid_mpc_tpu_torch.serve import (ArenaScheduler,
                                                     DeviceArena,
                                                     FallbackPolicy)

    rng = np.random.default_rng(31)
    box = (np.zeros(2), np.full(2, 8.0))
    tables = {}
    for k in range(4):
        L = 20 + 5 * k
        side = int(np.ceil(np.sqrt(L)))
        bary, U, V = [], [], []
        for i in range(L):
            off = np.array([i % side, i // side], dtype=float)
            verts = 0.8 * np.vstack([np.zeros(2), np.eye(2)]) + off \
                + 0.1 * rng.uniform(size=2)
            bary.append(geometry.barycentric_matrix(verts))
            U.append(rng.normal(size=(3, 1)))
            V.append(np.abs(rng.normal(size=3)))
        tables[f"t{k}"] = dict(
            bary_M=np.stack(bary), U=np.stack(U), V=np.stack(V),
            delta=np.zeros(L, dtype=np.int64),
            node_id=np.arange(L, dtype=np.int64))
    # Interior points of random leaves (ties off the facets) and a tenth
    # outside the box.
    names, th = [], []
    for i in range(800):
        nm = f"t{int(rng.integers(0, 4))}"
        M = np.linalg.inv(tables[nm]["bary_M"][
            int(rng.integers(0, len(tables[nm]["V"])))])[:-1, :]
        w = rng.dirichlet(np.ones(3)) * 0.8 + 0.2 / 3
        x = M @ w
        if rng.uniform() < 0.1:
            x = x + np.array([9.0, 0.0]) * rng.choice([-1, 1])
        names.append(nm)
        th.append(x)
    snaps = {}
    for pkg, arena, fb_cls, sched_cls, dmod, omod, mk in (
            ("jax", JArena(p=2, n_u=1, capacity_cols=1024, backend="xla"),
             JFallback, JSched, jdemand, jobs_lib, jexport.LeafTable),
            ("torch", DeviceArena(p=2, n_u=1, capacity_cols=1024,
                                  device="cpu"),
             FallbackPolicy, ArenaScheduler, demand_mod, obs_lib,
             export.LeafTable)):
        for nm, t in tables.items():
            arena.publish(nm, "v1", mk(**t), *box)
        o = omod.Obs("jsonl")
        hub = dmod.DemandHub(mode="on", max_leaves=64, subopt_frac=0.25,
                             obs=o, clock=_Clock())
        sched = sched_cls(arena, max_batch=64, max_wait_us=200_000.0,
                          fallback=fb_cls(*box, obs=o), obs=o, demand=hub)
        # One submitting thread: each tenant's rows reach the hub in the
        # submission order, whatever the micro-batches.
        tickets = [sched.submit(nm, x) for nm, x in zip(names, th)]
        res = [t.result(60.0)[0] for t in tickets]
        sched.close()
        for nm in sorted(tables):
            hub.snapshot(name=nm, dir_path=str(tmp_path / pkg / nm))
        pend = {nm: hub.ctl(nm).subopt.take_pending(512)
                for nm in sorted(tables)}
        snaps[pkg] = (res, pend)
        hub.close(snapshot=False)
        o.close()
    (jr, jp), (tr, tp) = snaps["jax"], snaps["torch"]
    assert [r.leaf for r in tr] == [r.leaf for r in jr]
    assert [r.fallback for r in tr] == [r.fallback for r in jr]
    for nm in sorted(tables):
        dj = load_demand(str(tmp_path / "jax" / nm))
        dt = load_demand(str(tmp_path / "torch" / nm))
        assert dt.leaf_ids.tobytes() == dj.leaf_ids.tobytes()
        assert dt.leaf_hits.tobytes() == dj.leaf_hits.tobytes()
        for f in ("exceed_lo", "exceed_hi", "res_outside", "res_hole"):
            assert getattr(dt, f).tobytes() == getattr(dj, f).tobytes()
        assert dt.meta["fallback"] == dj.meta["fallback"]
        assert dt.meta["n_leaves_hint"] == dj.meta["n_leaves_hint"]
        # The stride picks the same served rows: thetas bitwise, served
        # costs (float32 arena products) to 1e-5.
        assert tp[nm][0].tobytes() == jp[nm][0].tobytes()
        np.testing.assert_allclose(tp[nm][1], jp[nm][1], atol=1e-5)
        # The hits are a bincount of the served rows' leaves.
        served = [r.leaf for r, n in zip(tr, names) if n == nm and r.inside]
        bc = np.bincount(served)
        assert dict(zip(dt.leaf_ids.tolist(), dt.leaf_hits.tolist())) \
            == {i: float(c) for i, c in enumerate(bc) if c}


def test_rebuild_service_demand_order_is_the_jax_services(tmp_path):
    """The rebuild service with demand_dir in both packages, on the
    tier-1 DI fixture (eps_a 0.3): generation 0 (u_max drift) publishes
    an artifact; a demand snapshot over its rows -- written by the OTHER
    package's hub -- then orders generation 1's rebuild (eps_a 0.15):
    the same rebuild_priority_order, hottest first."""
    from explicit_hybrid_mpc_tpu.lifecycle import revision as jrevision
    from explicit_hybrid_mpc_tpu.lifecycle import service as jservice
    from explicit_hybrid_mpc_tpu.partition.frontier import (
        build_partition as jax_build)
    from explicit_hybrid_mpc_tpu.problems.registry import make as jax_make
    from explicit_hybrid_mpc_tpu_torch.lifecycle import (LifecycleConfig,
                                                         RebuildService,
                                                         Revision,
                                                         RevisionSource)
    from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
        build_partition)
    from explicit_hybrid_mpc_tpu_torch.problems.registry import make

    class _Staged(RevisionSource):
        def __init__(self, stages):
            self._stages = list(stages)

        def poll(self):
            if self._stages and self._stages[0][0]():
                return self._stages.pop(0)[1]
            return []

    def rev(cls, seq, eps, extra=()):
        return cls(controller="di", problem="double_integrator",
                   problem_args=tuple(sorted(DI_ARGS + extra)),
                   eps_a=eps, seq=seq, t_observed=time.perf_counter())

    def snapshot(dmod, svc, ddir):
        """Hits over generation 0's table rows (hub of `dmod`)."""
        node_id = np.load(os.path.join(svc.generations[0]["artifact_dir"],
                                       "node_id.npy"))
        rows = np.arange(node_id.size)
        hits = (rows * 7919) % 97 + 1
        hub = dmod.DemandHub(mode="on", snapshot_dir=ddir, clock=_Clock())
        hub.record("di", np.zeros((int(hits.sum()), 2)),
                   np.repeat(rows, hits), None,
                   np.ones(int(hits.sum()), dtype=bool),
                   np.zeros(int(hits.sum())))
        hub.close()
        return True

    jcfg = JaxConfig(problem="double_integrator", problem_args=DI_ARGS,
                     eps_a=0.3, backend="cpu", batch_simplices=128)
    tcfg = PartitionConfig(problem="double_integrator", problem_args=DI_ARGS,
                           eps_a=0.3, backend="cpu", batch_simplices=128)
    out = {}
    for pkg, rev_cls, svc_cls, lc_cls, cfg, prior, writer, omod in (
            ("jax", jrevision.Revision, jservice.RebuildService,
             jservice.LifecycleConfig, jcfg,
             jax_build(jax_make("double_integrator", **dict(DI_ARGS)), jcfg),
             demand_mod, jobs_lib),
            ("torch", Revision, RebuildService, LifecycleConfig, tcfg,
             build_partition(make("double_integrator", **dict(DI_ARGS)),
                             tcfg), jdemand, obs_lib)):
        ddir = str(tmp_path / pkg / "demand")
        holder = []
        src = _Staged([
            (lambda: True, [rev(rev_cls, 1, 0.3, (("u_max", 0.99),))]),
            (lambda: (len(holder[0].generations) >= 1
                      and snapshot(writer, holder[0], ddir)),
             [rev(rev_cls, 2, 0.15, (("u_max", 0.99),))])])
        o = omod.Obs("jsonl")
        svc = svc_cls(src, cfg, cfg=lc_cls(
            artifacts_root=str(tmp_path / pkg / "art"), demand_dir=ddir),
            prior={"di": prior}, obs=o)
        holder.append(svc)
        with svc:
            assert svc.wait_idle(timeout=300, target_generations=2)
        assert svc.n_failures == 0
        st = svc._ctl["di"].prior.stats
        evs = [r for r in o.sink.records
               if r.get("name") == "lifecycle.demand_priority"]
        out[pkg] = (st, evs)
        o.close()
    (jst, jev), (tst, tev) = out["jax"], out["torch"]
    assert tst["rebuild_priority_hint"] == jst["rebuild_priority_hint"] > 0
    assert tst["rebuild_priority_order"] == jst["rebuild_priority_order"]
    assert tst["regions"] == jst["regions"]
    assert len(tev) == len(jev) == 1
    assert tev[0]["hot_nodes"] == jev[0]["hot_nodes"]
    assert tev[0]["hinted"] == jev[0]["hinted"]
