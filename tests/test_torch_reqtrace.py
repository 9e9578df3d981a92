"""Torch port: serve request tracing (``obs/reqtrace.py``) and the
schedulers' trace hooks, against the JAX package's.

The port's versions of the JAX package's timing-free
tests/test_reqtrace.py cases: the phase-sum == wall invariant for both
schedulers (an arithmetic identity: reply is folded as the remainder),
the exemplar ring across a hot swap, the ring's keep-K-slowest rule,
exemplar digests, the dropped pre-attach batch, the off mode, the
rolling window's max-age cut and the health rules that read it (the
stale-window p99 rule, the volume-gated ``max_queue_frac`` rule and its
end-to-end trip, through the port's obs/health.py), the GC-pause
recorder, the rate-limited stall events, and the config plumbing.  Not
ported: ``test_trace_overhead_ab``, a latency A/B that is no parity
check (no test here asserts a time).

Parity: one scripted sequence of ``fold`` calls with an injected clock
through both hubs gives the same histograms, the same ``queue_frac`` and
the same exemplar digests.  Servers run on the CPU (the descent's and
the arena kernel's plain versions); traced results are bitwise the
untraced ones."""

import gc
import threading
import time
from collections import deque

import numpy as np
import pytest
import torch

import explicit_hybrid_mpc_tpu  # noqa: F401
from explicit_hybrid_mpc_tpu import obs as jobs
from explicit_hybrid_mpc_tpu.obs import reqtrace as jreqtrace
from explicit_hybrid_mpc_tpu_torch import obs as obs_lib
from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig, ServeConfig
from explicit_hybrid_mpc_tpu_torch.obs import reqtrace
from explicit_hybrid_mpc_tpu_torch.obs.health import HealthMonitor
from explicit_hybrid_mpc_tpu_torch.obs.reqtrace import (
    GcPauseRecorder, ReqTrace, _Ring, trace_from_serve_config)
from explicit_hybrid_mpc_tpu_torch.online import descent, export, sharded
from explicit_hybrid_mpc_tpu_torch.partition import geometry
from explicit_hybrid_mpc_tpu_torch.partition.synthetic import (
    build_synthetic_tree)
from explicit_hybrid_mpc_tpu_torch.serve import (ArenaScheduler,
                                                 ControllerRegistry,
                                                 DeviceArena, FallbackPolicy,
                                                 RequestScheduler)
from explicit_hybrid_mpc_tpu_torch.serve import scheduler as sched_mod

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _server(obs=None, scale=1.0, depth=6):
    tree, roots = build_synthetic_tree(p=2, depth=depth, n_u=2)
    if scale != 1.0:
        tree._pl_inputs[:] *= scale
        tree._pl_costs[:] *= scale
    table = export.export_leaves(tree)
    dt = descent.export_descent(tree, roots, table, stage=False)
    return sharded.shard_descent(dt, table, n_shards=2, obs=obs,
                                 devices=[CPU])


def _synthetic_table(rng, L=24, p=2, n_u=2):
    """Disjoint unit-grid simplices (the JAX tests' idiom)."""
    base = np.vstack([np.zeros(p), np.eye(p)])
    side = int(np.ceil(np.sqrt(L)))
    bary, U, V = [], [], []
    for i in range(L):
        off = np.array([i % side, i // side], dtype=float)[:p]
        verts = 0.8 * base + off + 0.1 * rng.uniform(size=p)
        bary.append(geometry.barycentric_matrix(verts))
        U.append(rng.normal(size=(p + 1, n_u)))
        V.append(np.abs(rng.normal(size=p + 1)))
    return export.LeafTable(
        bary_M=np.stack(bary), U=np.stack(U), V=np.stack(V),
        delta=np.zeros(L, dtype=np.int64),
        node_id=np.arange(L, dtype=np.int64))


_BOX = (np.zeros(2), np.full(2, 8.0))

_STAMP_ORDER = ("enqueue", "seal", "lease", "put", "launch_return",
                "fallback_end", "reply")


def _arena(rng, o=None):
    arena = DeviceArena(p=2, n_u=2, capacity_cols=256, obs=o, device="cpu")
    arena.publish("a", "v1", _synthetic_table(rng), *_BOX)
    arena.publish("b", "v1", _synthetic_table(rng), *_BOX)
    return arena


def _phase_hists(o, ctl):
    pre = f"serve.ctl.{ctl}.phase."
    return {k[len(pre):-3]: h
            for k, h in o.metrics.snapshot()["histograms"].items()
            if k.startswith(pre)}


def _assert_phases_sum_to_wall(ph, n_expected):
    assert set(reqtrace.PHASES) | {"wall"} == set(ph)
    n = ph["wall"]["count"]
    assert n == n_expected
    wall_mean = ph["wall"]["sum"] / n
    phase_sum = sum(ph[p]["sum"] / ph[p]["count"] for p in reqtrace.PHASES)
    # Arithmetic identity (reply is computed as the remainder), so the
    # tolerance covers float summation order only -- not sampling.
    assert abs(phase_sum - wall_mean) <= 1e-6 * wall_mean
    assert all(ph[p]["count"] == n for p in reqtrace.PHASES)


# -- the module's constants are the JAX package's ------------------------------


def test_phases_and_bounds_are_the_jax_package_s():
    assert reqtrace.PHASES == jreqtrace.PHASES
    assert reqtrace.PHASE_BOUNDS_US == jreqtrace.PHASE_BOUNDS_US
    assert reqtrace.STALL_EVENT_MIN_US == jreqtrace.STALL_EVENT_MIN_US
    assert reqtrace._ROLL_CAP == jreqtrace._ROLL_CAP


# -- phase-sum == wall invariant, both schedulers ---------------------------


def test_request_scheduler_phase_sum_equals_wall(rng):
    o = obs_lib.Obs("jsonl")
    srv = _server(obs=o)
    reg = ControllerRegistry(obs=o)
    reg.publish("c", "v1", srv)
    tr = ReqTrace(mode="on", obs=o)
    with RequestScheduler(reg, "c", max_batch=16, max_wait_us=1000.0,
                          obs=o, trace=tr) as sched:
        tickets = [sched.submit(th)
                   for th in rng.uniform(0, 1, size=(120, 2))]
        for t in tickets:
            assert t.result(30.0)[0].ok
    _assert_phases_sum_to_wall(_phase_hists(o, "c"), 120)
    # queue_frac gauge minted and sane.
    qf = o.metrics.snapshot()["gauges"]["serve.ctl.c.queue_frac"]
    assert 0.0 <= qf <= 1.0
    assert tr.queue_frac("c") == pytest.approx(qf)


def test_arena_scheduler_phase_sum_equals_wall(rng):
    o = obs_lib.Obs("jsonl")
    arena = _arena(rng, o)
    fb = FallbackPolicy(*_BOX, obs=o)
    tr = ReqTrace(mode="on", obs=o)
    with ArenaScheduler(arena, max_batch=16, max_wait_us=2000.0,
                        fallback=fb, obs=o, trace=tr) as sched:
        names = ["a", "b"]
        tickets = [sched.submit(names[i % 2], th) for i, th
                   in enumerate(rng.uniform(0, 8, size=(60, 2)))]
        for t in tickets:
            t.result(30.0)
    for ctl in ("a", "b"):
        _assert_phases_sum_to_wall(_phase_hists(o, ctl), 30)


def test_heartbeat_carries_queue_frac_when_tracing(rng):
    """With tracing on, the rolling queue_frac rides the serve.eval
    heartbeat (online/sharded.py's heartbeat fields)."""
    o = obs_lib.Obs("jsonl")
    reg = ControllerRegistry(obs=o)
    reg.publish("c", "v1", _server(obs=o))
    tr = ReqTrace(mode="on", obs=o)
    with RequestScheduler(reg, "c", max_batch=8, max_wait_us=500.0,
                          obs=o, trace=tr) as sched:
        for _ in range(3):
            for t in [sched.submit(th)
                      for th in rng.uniform(0, 1, size=(16, 2))]:
                t.result(30.0)
    evs = [r for r in o.sink.records if r.get("name") == "serve.eval"]
    qfs = [e["queue_frac"] for e in evs if "queue_frac" in e]
    assert qfs and all(0.0 <= q <= 1.0 for q in qfs)


@pytest.mark.parametrize("which", ["request", "arena"])
def test_traced_results_are_bitwise_the_untraced(rng, which):
    """Tracing only stamps: the same requests, traced and untraced, give
    bitwise the same answers."""
    thetas = rng.uniform(0, 1, size=(80, 2)) * (8.0 if which == "arena"
                                                  else 1.0)
    out = {}
    for mode in ("off", "on"):
        tr = ReqTrace(mode=mode)
        if which == "request":
            reg = ControllerRegistry()
            reg.publish("c", "v1", _server())
            sched = RequestScheduler(reg, "c", max_batch=16,
                                     max_wait_us=500.0, trace=tr)
            tickets = [sched.submit(th) for th in thetas]
        else:
            sched = ArenaScheduler(_arena(np.random.default_rng(5)),
                                   max_batch=16, max_wait_us=500.0,
                                   fallback=FallbackPolicy(*_BOX),
                                   trace=tr)
            tickets = [sched.submit("ab"[i % 2], th)
                       for i, th in enumerate(thetas)]
        res = [t.result(30.0)[0] for t in tickets]
        sched.close()
        assert (sched.trace is None) == (mode == "off")
        out[mode] = res
    for a, b in zip(out["off"], out["on"]):
        assert np.array_equal(a.u, b.u) and a.cost == b.cost
        assert (a.leaf, a.inside, a.version, a.fallback) \
            == (b.leaf, b.inside, b.version, b.fallback)


# -- exemplar ring ----------------------------------------------------------


def test_exemplar_ring_race_across_hot_swap(rng):
    """Six concurrent submitters racing a registry hot swap: every
    exemplar must bind to a COMMITTED version (v1 or v2), carry a
    monotone stamp vector, and the ring must stay bounded at K.  The
    swap happens once a third of the traffic is answered (counted, not
    timed)."""
    o = obs_lib.Obs("jsonl")
    reg = ControllerRegistry(obs=o)
    reg.publish("c", "v1", _server(obs=o))
    v2 = _server(obs=o, scale=2.0)
    tr = ReqTrace(mode="on", exemplar_k=8, obs=o)
    errors: list = []
    n_each = 40
    answered = []
    lock = threading.Lock()
    third = threading.Event()

    with RequestScheduler(reg, "c", max_batch=16, max_wait_us=500.0,
                          obs=o, trace=tr) as sched:

        def submitter(seed):
            r = np.random.default_rng(seed)
            try:
                for _ in range(n_each):
                    res = sched.submit(r.uniform(0, 1, 2)).result(30.0)
                    with lock:
                        answered.append(res[0].version)
                        if len(answered) >= 2 * n_each:
                            third.set()
            except Exception as e:  # pragma: no cover - fail loud
                errors.append(repr(e))

        threads = [threading.Thread(target=submitter, args=(i,))
                   for i in range(6)]
        for t in threads:
            t.start()
        assert third.wait(60.0)
        reg.publish("c", "v2", v2)
        for t in threads:
            t.join(60.0)
        assert not any(t.is_alive() for t in threads)
        ex = tr.exemplars("c")

    assert not errors and len(answered) == 6 * n_each
    assert 1 <= len(ex) <= 8
    # Slowest-first ordering.
    walls = [e["wall_us"] for e in ex]
    assert walls == sorted(walls, reverse=True)
    for e in ex:
        assert e["version"] in ("v1", "v2")
        st = e["stamps_us"]
        vals = [st[k] for k in _STAMP_ORDER]
        assert all(b >= a - 1e-6 for a, b in zip(vals, vals[1:]))
        assert st["reply"] == pytest.approx(e["wall_us"], abs=1e-3)
        assert e["rows"] >= 1 and 0.0 < e["batch_fill"] <= 1.0


def test_ring_keeps_k_slowest_within_window():
    ring = _Ring(k=3, window_s=10.0)
    for i, w in enumerate([5.0, 1.0, 9.0, 3.0, 7.0]):
        ring.offer(float(i), w, {"wall_us": w})
    assert [e["wall_us"] for e in ring.snapshot()] == [9.0, 7.0, 5.0]
    # Entries older than the window are evicted on the next offer.
    ring.offer(100.0, 0.5, {"wall_us": 0.5})
    assert [e["wall_us"] for e in ring.snapshot()] == [0.5]


def test_flush_emits_exemplar_digest_events():
    o = obs_lib.Obs("jsonl")
    tr = ReqTrace(mode="on", obs=o)
    base = time.perf_counter_ns()
    tr.fold("c", seal=base + 2_000, lease=base + 3_000,
            eval0=base + 4_000, eval1=base + 6_000, fb_end=base + 6_500,
            done=base + 9_000, rows=[((base, base + 500), 2, None)],
            fill=0.5, version="v1", extent=64)
    tr.flush()
    evs = [r for r in o.sink.records
           if r.get("name") == "serve.trace.exemplars"]
    assert len(evs) == 1
    assert evs[0]["controller"] == "c" and evs[0]["n"] == 1
    assert evs[0]["slowest"][0]["version"] == "v1"


def test_fold_drops_batch_sealed_before_attach():
    """A batch collected while tracing was detached has no seal stamp;
    fold must drop it rather than emit a garbage decomposition."""
    o = obs_lib.Obs("jsonl")
    tr = ReqTrace(mode="on", obs=o)
    base = time.perf_counter_ns()
    tr.fold("c", seal=0, lease=base, eval0=base, eval1=base,
            fb_end=base, done=base, rows=[((base, base), 1, None)],
            fill=1.0)
    assert not _phase_hists(o, "c")
    assert tr.queue_frac("c") is None


# -- parity with the JAX hub on scripted folds --------------------------------


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _scripted_folds(seed):
    """(controller, fold kwargs, clock advance s) of a seeded batch
    sequence: three controllers, 1-6 tickets a batch, fallback tags,
    stalls, and clock jumps past the rolling window."""
    r = np.random.default_rng(seed)
    base = 1_000_000_000
    out = []
    for _ in range(60):
        ctl = ("a", "b", "c")[int(r.integers(3))]
        n = int(r.integers(1, 7))
        sub = base + np.sort(r.integers(0, 400_000, n))
        seal = int(sub.max()) + int(r.integers(1_000, 50_000))
        gaps = np.cumsum(r.integers(100, 30_000, 5))
        lease, eval0, eval1, fb_end, done = (seal + int(g) for g in gaps)
        rows = [((int(s), int(s) + int(r.integers(10, 900))),
                 int(r.integers(1, 4)),
                 (None, "clamp", "unserved")[int(r.integers(3))])
                for s in sub]
        out.append((ctl, dict(
            seal=seal, lease=lease, eval0=eval0, eval1=eval1,
            fb_end=fb_end, done=done, rows=rows,
            fill=round(float(r.uniform(0.1, 1.0)), 4),
            version=f"v{int(r.integers(1, 3))}",
            extent=int(r.integers(10, 100)),
            stall_ns=int(r.choice([0, 0, 400_000, 2_500_000]))),
            float(r.choice([0.01, 0.3, 12.0]))))
        base = done
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_scripted_folds_match_the_jax_hub(seed):
    o, jo = obs_lib.Obs("jsonl"), jobs.Obs("jsonl")
    clk, jclk = _Clock(), _Clock()
    tr = ReqTrace(mode="on", exemplar_k=4, window_s=10.0, obs=o, clock=clk)
    jtr = jreqtrace.ReqTrace(mode="on", exemplar_k=4, window_s=10.0,
                             obs=jo, clock=jclk)
    for ctl, kw, dt in _scripted_folds(seed):
        tr.fold(ctl, **kw)
        jtr.fold(ctl, **kw)
        assert tr.queue_frac(ctl) == jtr.queue_frac(ctl)
        clk.t += dt
        jclk.t += dt
    snap, jsnap = o.metrics.snapshot(), jo.metrics.snapshot()
    for kind in ("histograms", "gauges"):
        got = {k: v for k, v in snap[kind].items()
               if k.startswith(("serve.ctl.", "serve.host."))}
        ref = {k: v for k, v in jsnap[kind].items()
               if k.startswith(("serve.ctl.", "serve.host."))}
        assert got == ref and got
    assert tr.exemplars() == jtr.exemplars()
    for ctl in ("a", "b", "c"):
        assert tr.exemplars(ctl) == jtr.exemplars(ctl)
        assert len(tr.exemplars(ctl)) <= 4
    tr.flush()
    jtr.flush()

    def digests(records):
        return [(r["controller"], r["n"], r["slowest"]) for r in records
                if r.get("name") == "serve.trace.exemplars"]

    assert digests(o.sink.records) == digests(jo.sink.records)
    stalls = [r["overshoot_us"] for r in o.sink.records
              if r.get("name") == "serve.host.stall_us"]
    assert stalls == [r["overshoot_us"] for r in jo.sink.records
                      if r.get("name") == "serve.host.stall_us"]


# -- off mode ---------------------------------------------------------------


def test_off_mode_is_byte_for_byte_noop(rng):
    """mode='off' (and a missing hub) must leave the serve path with
    zero trace work: the scheduler drops the hub at construction, no
    ticket carries stamps, and no phase metric is ever minted."""
    o = obs_lib.Obs("jsonl")
    reg = ControllerRegistry(obs=o)
    reg.publish("c", "v1", _server(obs=o))
    with RequestScheduler(reg, "c", max_batch=8, max_wait_us=500.0,
                          obs=o, trace=ReqTrace(mode="off")) as sched:
        assert sched.trace is None  # dropped at construction
        tickets = [sched.submit(th)
                   for th in rng.uniform(0, 1, size=(20, 2))]
        for t in tickets:
            assert t.result(30.0)[0].ok
        assert all(t.t_ns is None for t in tickets)
    snap = o.metrics.snapshot()
    assert not any(".phase." in k for k in snap["histograms"])
    assert not any(k.endswith(".queue_frac") for k in snap["gauges"])


# -- rolling-window max-age cut ---------------------------------------------


def test_prune_stale_unit():
    now = 1000.0
    old = now - sched_mod._ROLL_MAX_AGE_S - 1.0
    lat = deque([(old, 9.9), (old, 9.9), (now - 1.0, 0.001)])
    fb = deque([(old, 1), (now - 1.0, 0)])
    sched_mod._prune_stale(lat, fb, now)
    assert list(lat) == [(now - 1.0, 0.001)]
    assert list(fb) == [(now - 1.0, 0)]


def test_stale_window_stops_firing_serve_p99(rng):
    """Latency samples older than the max-age cut must fall out of the
    rolling p99 gauge: a burst of old slow requests cannot keep firing
    ``health.serve_p99_us`` forever, while the SAME samples with fresh
    timestamps must fire it (the rule still works)."""
    o = obs_lib.Obs("jsonl")
    reg = ControllerRegistry(obs=o)
    reg.publish("c", "v1", _server(obs=o))
    rules = {"serve_p99_us": 1e6, "min_solves_for_rates": 1.0}

    def fired():
        snap = o.metrics.snapshot()
        mon = HealthMonitor(rules=rules)
        mon.feed({"kind": "metrics", "counters": snap["counters"],
                  "gauges": snap["gauges"]})
        return any(e["name"] == "health.serve_p99_us" for e in mon.events)

    with RequestScheduler(reg, "c", max_batch=16, max_wait_us=500.0,
                          obs=o) as sched:
        # A stale burst of 5 s latencies, older than _ROLL_MAX_AGE_S.
        sched._lat_roll.extend([(time.perf_counter() - 120.0, 5.0)] * 200)
        for t in [sched.submit(th)
                  for th in rng.uniform(0, 1, size=(30, 2))]:
            t.result(30.0)
        assert o.metrics.snapshot()["gauges"]["serve.ctl.c.p99_us"] < 1e6
        assert not fired()
        # Control: the same burst with FRESH timestamps dominates the
        # window and the rule fires.
        sched._lat_roll.extend([(time.perf_counter(), 5.0)] * 200)
        for t in [sched.submit(th)
                  for th in rng.uniform(0, 1, size=(30, 2))]:
            t.result(30.0)
        assert o.metrics.snapshot()["gauges"]["serve.ctl.c.p99_us"] > 1e6
        assert fired()


def test_max_queue_frac_rule_fires_volume_gated():
    gauges = {"serve.ctl.c.queue_frac": 0.62}
    # Below the volume gate: silent.
    mon = HealthMonitor(rules={"max_queue_frac": 0.5})
    mon.feed({"kind": "metrics",
              "counters": {"serve.ctl.c.requests": 10.0},
              "gauges": gauges})
    assert not mon.events
    # Past the gate: warn, keyed per controller, nonzero exit.
    mon.feed({"kind": "metrics",
              "counters": {"serve.ctl.c.requests": 5000.0},
              "gauges": gauges})
    evs = [e for e in mon.events if e["name"] == "health.serve_queue"]
    assert len(evs) == 1
    assert evs[0]["severity"] == "warn"
    assert "queue" in evs[0]["msg"]
    assert mon.exit_code != 0
    # Default rules keep the rule off (opt-in like serve_p99_us).
    mon2 = HealthMonitor()
    mon2.feed({"kind": "metrics",
               "counters": {"serve.ctl.c.requests": 5000.0},
               "gauges": gauges})
    assert not mon2.events


def test_queue_frac_rule_end_to_end(rng):
    """A long batching window on single-row submits is queue-dominated
    by construction; the gauge the scheduler publishes must trip the
    rule through a real metrics snapshot."""
    o = obs_lib.Obs("jsonl")
    reg = ControllerRegistry(obs=o)
    reg.publish("c", "v1", _server(obs=o))
    # Short trace window so the warmup round ages OUT of the queue_frac
    # roll before the measured round.
    tr = ReqTrace(mode="on", window_s=0.5, obs=o)
    with RequestScheduler(reg, "c", max_batch=64, max_wait_us=20000.0,
                          obs=o, trace=tr) as sched:
        for t in [sched.submit(th)
                  for th in rng.uniform(0, 1, size=(40, 2))]:
            t.result(30.0)  # warmup
        time.sleep(0.6)
        for t in [sched.submit(th)
                  for th in rng.uniform(0, 1, size=(40, 2))]:
            t.result(30.0)
    snap = o.metrics.snapshot()
    mon = HealthMonitor(rules={"max_queue_frac": 0.2,
                               "min_solves_for_rates": 1.0})
    mon.feed({"kind": "metrics", "counters": snap["counters"],
              "gauges": snap["gauges"]})
    assert any(e["name"] == "health.serve_queue" for e in mon.events)


# -- host forensics ---------------------------------------------------------


def test_gc_pause_recorder_captures_forced_collect():
    o = obs_lib.Obs("jsonl")
    with GcPauseRecorder(obs=o) as rec:
        junk = []
        for _ in range(1000):
            a, b = [], []
            a.append(b)
            b.append(a)
            junk.append(a)
        del junk
        gc.collect()
    assert rec.pauses and all(p > 0 for p in rec.pauses)
    assert rec.total_pause_s() == pytest.approx(sum(rec.pauses) / 1e6)
    evs = [r for r in o.sink.records
           if r.get("name") == "serve.host.gc_pause_us"]
    assert evs and evs[-1]["pause_us"] > 0
    h = o.metrics.snapshot()["histograms"]["serve.host.gc_pause_us"]
    assert h["count"] == len(rec.pauses)
    # Stop is idempotent and the hook is really gone.
    rec.stop()
    n = len(rec.pauses)
    gc.collect()
    assert len(rec.pauses) == n


def test_a_collection_under_the_recorders_locks_does_not_hang():
    """A collection that starts while its own thread holds the
    histogram's lock (a snapshot copying it) or the stream's (an emit)
    finishes: the callback only records, the recorder's thread publishes
    the event and the observation, and stop() the rest."""
    o = obs_lib.Obs("jsonl")
    rec = GcPauseRecorder(obs=o).start()
    done = threading.Event()

    def collect_under_the_locks():
        with rec._h._lock, o.sink._lock:
            gc.collect()
        done.set()

    threading.Thread(target=collect_under_the_locks, daemon=True).start()
    assert done.wait(10.0), "gc.collect() under the recorder's locks hung"
    deadline = time.monotonic() + 10.0
    while not [r for r in o.sink.records
               if r.get("name") == "serve.host.gc_pause_us"]:
        assert time.monotonic() < deadline, "no event published"
        time.sleep(0.01)
    rec.stop()
    assert not any(t.name == "gc-pause-publish"
                   for t in threading.enumerate())
    h = o.metrics.snapshot()["histograms"]["serve.host.gc_pause_us"]
    evs = [r for r in o.sink.records
           if r.get("name") == "serve.host.gc_pause_us"]
    assert h["count"] == len(evs) == len(rec.pauses) >= 1


def test_note_stall_histogram_always_event_rate_limited():
    clk = _Clock()
    o = obs_lib.Obs("jsonl")
    tr = ReqTrace(mode="on", obs=o, clock=clk)

    def stall_events():
        return [r for r in o.sink.records
                if r.get("name") == "serve.host.stall_us"]

    tr.note_stall(500_000)  # 500 us: below the event floor
    assert not stall_events()
    tr.note_stall(2_000_000)  # 2 ms: evented
    assert len(stall_events()) == 1
    tr.note_stall(3_000_000)  # same second: rate-limited
    assert len(stall_events()) == 1
    clk.t += 1.5
    tr.note_stall(3_000_000)
    assert len(stall_events()) == 2
    h = o.metrics.snapshot()["histograms"]["serve.host.stall_us"]
    assert h["count"] == 4  # the histogram always observes


def test_rebuild_service_records_host_forensics(tmp_path):
    """With obs on, the rebuild service installs the GC-pause recorder
    for its life and feeds the watcher's sleep overshoot into
    serve.host.stall_us; with obs off it records neither."""
    from explicit_hybrid_mpc_tpu_torch.lifecycle import (DriftSource,
                                                         LifecycleConfig,
                                                         RebuildService)

    args = (("N", 3), ("theta_box", 1.5))
    cfg = PartitionConfig(problem="double_integrator", problem_args=args,
                          backend="cpu", eps_a=0.5, batch_simplices=64,
                          max_depth=20)
    o = obs_lib.Obs("jsonl")
    src = DriftSource("double_integrator", problem_args=args,
                      controller="di", eps_a=0.5, n_revisions=1, seed=0)
    svc = RebuildService(src, cfg, cfg=LifecycleConfig(
        artifacts_root=str(tmp_path / "lc"), poll_s=0.01), obs=o)
    n_cb = len(gc.callbacks)
    with svc:
        assert len(gc.callbacks) == n_cb + 1
        assert svc.wait_idle(timeout=120.0, target_generations=1)
        gc.collect()
    assert len(gc.callbacks) == n_cb
    assert len(svc.generations) == 1 and svc.n_failures == 0
    hists = o.metrics.snapshot()["histograms"]
    assert hists["serve.host.stall_us"]["count"] > 0
    assert hists["serve.host.gc_pause_us"]["count"] > 0
    off = RebuildService(DriftSource("double_integrator", problem_args=args,
                                     n_revisions=0), cfg,
                         cfg=LifecycleConfig(
                             artifacts_root=str(tmp_path / "off")))
    assert off._gc_rec is None and off._host_trace is None


# -- config plumbing --------------------------------------------------------


def test_trace_from_serve_config():
    assert trace_from_serve_config(ServeConfig()) is None
    tr = trace_from_serve_config(
        ServeConfig(tracing="on", trace_exemplar_k=4, trace_window_s=5.0))
    assert tr is not None and tr.enabled
    assert tr.exemplar_k == 4 and tr.window_s == 5.0

    class _Legacy:  # config pickled before the knobs existed
        pass

    assert trace_from_serve_config(_Legacy()) is None


def test_trace_validation():
    with pytest.raises(ValueError, match="tracing mode"):
        ReqTrace(mode="sometimes")
    with pytest.raises(ValueError, match="exemplar_k"):
        ReqTrace(mode="on", exemplar_k=0)
    with pytest.raises(ValueError, match="window_s"):
        ReqTrace(mode="on", window_s=0.0)
    with pytest.raises(ValueError, match="tracing mode"):
        ServeConfig(tracing="verbose")
    with pytest.raises(ValueError, match="trace_exemplar_k"):
        ServeConfig(tracing="on", trace_exemplar_k=0)
    with pytest.raises(ValueError, match="trace_window_s"):
        ServeConfig(tracing="on", trace_window_s=-1.0)
