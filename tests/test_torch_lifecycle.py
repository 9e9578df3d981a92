"""Torch port: the continuous rebuild lifecycle (lifecycle/revision.py,
lifecycle/service.py, lifecycle/cli.py) against the JAX package's.

Revision streams are held to the JAX package's: ``DriftSource`` emits
the same ``Revision.to_dict()`` sequence for the same seed and
arguments, ``plant_divergence`` agrees to 1e-12, and
``FileRevisionSource`` tails a JSONL file through a torn last line.
The daemon is driven on the CPU on the JAX tests' fixture (the tier-1
double integrator at eps_a=0.3): a swap under load with 0 dropped and
0 torn results, coalescing of a revision storm, failure containment,
a crash between the delta write and the swap, a bounded exclusion
ledger over a K=5 drift walk, and the same generation rows as the JAX
package's service on the same drift walk.  The CLI: ``serve-rebuild``
needs ``--artifacts-root``, an unbounded walk needs ``--duration``,
``--backend`` defaults to cuda."""

import dataclasses
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import explicit_hybrid_mpc_tpu  # noqa: F401  (enables x64)
from explicit_hybrid_mpc_tpu.config import PartitionConfig as JaxConfig
from explicit_hybrid_mpc_tpu.lifecycle import revision as jrevision
from explicit_hybrid_mpc_tpu.lifecycle import service as jservice
from explicit_hybrid_mpc_tpu.partition.frontier import (
    build_partition as jax_build)
from explicit_hybrid_mpc_tpu.problems.registry import make as jax_make
from explicit_hybrid_mpc_tpu_torch import faults
from explicit_hybrid_mpc_tpu_torch import main as tmain
from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
from explicit_hybrid_mpc_tpu_torch.lifecycle import (DriftSource,
                                                     FileRevisionSource,
                                                     LifecycleConfig,
                                                     RebuildService, Revision,
                                                     RevisionSource,
                                                     plant_divergence)
from explicit_hybrid_mpc_tpu_torch.lifecycle.cli import build_parser
from explicit_hybrid_mpc_tpu_torch.obs import Obs
from explicit_hybrid_mpc_tpu_torch.partition.frontier import build_partition
from explicit_hybrid_mpc_tpu_torch.partition.rebuild import warm_rebuild
from explicit_hybrid_mpc_tpu_torch.problems.registry import make
from explicit_hybrid_mpc_tpu_torch.serve.registry import ControllerRegistry

torch.set_num_threads(1)

DI_ARGS = (("N", 3), ("theta_box", 1.5))
CPU = [torch.device("cpu")]


@pytest.fixture(scope="module")
def di_problem():
    return make("double_integrator", **dict(DI_ARGS))


@pytest.fixture(scope="module")
def di_cfg():
    return PartitionConfig(problem="double_integrator",
                           problem_args=DI_ARGS, eps_a=0.3,
                           backend="cpu", batch_simplices=128)


@pytest.fixture(scope="module")
def prior(di_problem, di_cfg):
    return build_partition(di_problem, di_cfg)


class ListSource(RevisionSource):
    """Test source: hands out a scripted revision list, then dries up."""

    def __init__(self, revisions):
        self._revs = list(revisions)

    def poll(self):
        out, self._revs = self._revs, []
        return out


class StagedSource(RevisionSource):
    """Test source releasing revision batches behind ready-gates, so
    enqueue-vs-claim interleavings are deterministic."""

    def __init__(self, stages):
        self._stages = list(stages)  # [(ready_fn, [revisions])]

    def poll(self):
        if self._stages and self._stages[0][0]():
            return self._stages.pop(0)[1]
        return []


def _rev(seq, controller="di", eps=0.3, extra=(), problem_args=DI_ARGS):
    return Revision(controller=controller, problem="double_integrator",
                    problem_args=tuple(sorted(problem_args + extra)),
                    eps_a=eps, seq=seq, t_observed=time.perf_counter())


def _wait_for(cond, timeout: float = 300.0) -> bool:
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return False


def _gate(src, svc):
    """Emit revision k+1 once generation k is live (or failed)."""
    src.gate = (lambda: len(svc.generations) + svc.n_failures
                >= src.n_emitted)


# -- chained priors -----------------------------------------------------------


def test_warm_rebuild_accepts_partition_result(di_problem, di_cfg, prior):
    res = warm_rebuild(di_problem, di_cfg, prior)
    assert res.stats["rebuild_prior_source"] == "result"
    assert res.stats["rebuild_reuse_frac"] == 1.0
    assert res.stats["subdivision_solves"] == 0


# -- revision sources against the JAX package's -------------------------------


@pytest.mark.parametrize("kw", [
    dict(drift_arg="u_max", drift_frac=0.05, max_drift_frac=0.2,
         n_revisions=4, seed=3),
    dict(drift_arg="u_max", drift_frac=0.02, eps_frac=0.1, n_revisions=5,
         seed=7),
    dict(drift_arg="dt", drift_frac=0.05, n_revisions=3, probe_T=5,
         min_divergence=1e-9, seed=1)], ids=["u_max", "eps", "dt_probe"])
def test_drift_source_sequence_is_the_jax_sequence(kw):
    a = DriftSource("double_integrator", problem_args=DI_ARGS, eps_a=0.3,
                    **kw)
    b = jrevision.DriftSource("double_integrator", problem_args=DI_ARGS,
                              eps_a=0.3, **kw)
    ra = [r.to_dict() for _ in range(10) for r in a.poll()]
    rb = [r.to_dict() for _ in range(10) for r in b.poll()]
    assert len(ra) == kw["n_revisions"] and a.exhausted()
    assert ra == rb


def test_drift_source_deterministic_bounded_and_exhausts():
    kw = dict(problem_args=DI_ARGS, eps_a=0.3, drift_arg="u_max",
              drift_frac=0.05, max_drift_frac=0.2, n_revisions=4, seed=3)
    src = DriftSource("double_integrator", **kw)
    ra = [r for _ in range(10) for r in src.poll()]
    assert len(ra) == 4 and src.exhausted() and src.n_emitted == 4
    for r in ra:
        assert abs(dict(r.problem_args)["u_max"] - 1.0) <= 0.2 + 1e-12
    assert len({r.problem_args for r in ra}) > 1  # it does drift


def test_drift_source_refuses_box_drift_and_unknown_arg():
    with pytest.raises(ValueError, match="root geometry"):
        DriftSource("double_integrator", drift_arg="theta_box")
    with pytest.raises(ValueError, match="no numeric"):
        DriftSource("double_integrator", drift_arg="nonsense")


@pytest.mark.parametrize("drift", [{}, {"dt": 0.3}, {"u_max": 0.8}],
                         ids=["same", "dt", "u_max"])
def test_plant_divergence_is_the_jax_divergence(drift):
    args = dict(DI_ARGS)
    got = plant_divergence(make("double_integrator", **args),
                           make("double_integrator", **args, **drift), T=10)
    ref = jrevision.plant_divergence(
        jax_make("double_integrator", **args),
        jax_make("double_integrator", **args, **drift), T=10)
    assert got == pytest.approx(ref, rel=1e-12, abs=1e-12)
    assert (got > 0.0) == ("dt" in drift)


def test_drift_source_gates_on_divergence():
    # u_max is a CONSTRAINT parameter: the open-loop probe sees zero
    # divergence, so a min_divergence gate must suppress emission.
    src = DriftSource("double_integrator", problem_args=DI_ARGS,
                      drift_arg="u_max", drift_frac=0.05,
                      n_revisions=3, probe_T=5, min_divergence=1e-9)
    assert [r for _ in range(5) for r in src.poll()] == []
    src2 = DriftSource("double_integrator", problem_args=DI_ARGS,
                       drift_arg="dt", drift_frac=0.05,
                       n_revisions=2, probe_T=5, min_divergence=1e-9)
    revs = [r for _ in range(5) for r in src2.poll()]
    assert len(revs) == 2
    assert all("divergence" in r.note for r in revs)


def test_file_revision_source_tails_and_tolerates_torn_tail(tmp_path):
    p = str(tmp_path / "revs.jsonl")
    full = json.dumps({"problem": "double_integrator",
                       "problem_args": {"N": 3}, "eps_a": 0.25})
    with open(p, "w") as f:
        f.write(full + "\n")
        f.write("not json\n")  # garbage line: skipped, never wedges
        f.write(full + "\n")
        f.write('{"problem": "double_int')  # torn: writer mid-append
    src = FileRevisionSource(p, controller="di")
    revs = src.poll()
    assert [r.seq for r in revs] == [1, 2]
    assert revs[0].controller == "di"
    assert revs[0].problem_args == (("N", 3),)
    assert revs[0].eps_a == 0.25
    assert src.poll() == []  # torn tail not consumed
    with open(p, "a") as f:
        f.write('egrator"}\n')
    revs = src.poll()
    assert len(revs) == 1 and revs[0].seq == 3
    assert revs[0].problem == "double_integrator"
    # The same file through the JAX package's source: the same records.
    ref = jrevision.FileRevisionSource(p, controller="di").poll()
    assert [r.to_dict() for r in ref] == [
        r.to_dict() for r in FileRevisionSource(p, controller="di").poll()]


def test_file_revision_source_is_exhausted_after_a_dry_poll(tmp_path):
    """exhausted() turns True only once a poll found nothing new, so
    `serve-rebuild --source` never finds the daemon idle before the
    watcher has polled and enqueued the file's revisions."""
    p = str(tmp_path / "revs.jsonl")
    with open(p, "w") as f:
        f.write(json.dumps({"problem": "double_integrator"}) + "\n")
    src = FileRevisionSource(p)
    assert not src.exhausted()          # never polled
    assert len(src.poll()) == 1
    assert not src.exhausted()          # the last poll handed one out
    assert src.poll() == [] and src.exhausted()
    with open(p, "a") as f:
        f.write(json.dumps({"problem": "double_integrator"}) + "\n")
    assert len(src.poll()) == 1 and not src.exhausted()


def test_wait_idle_is_not_idle_while_the_watcher_polls(di_cfg):
    """A poll in progress counts as work: wait_idle() cannot report the
    daemon idle between the source handing out its last revision and
    the watcher queueing it."""
    entered, release = threading.Event(), threading.Event()

    class SlowSource(RevisionSource):
        def poll(self):
            entered.set()
            release.wait(10)
            return []

    svc = RebuildService(SlowSource(), di_cfg, cfg=LifecycleConfig(
        artifacts_root="unused"))
    svc.start()
    try:
        assert entered.wait(10)
        assert not svc.wait_idle(timeout=0.2)
        release.set()
        assert svc.wait_idle(timeout=10)
    finally:
        release.set()
        svc.close(timeout=10)


# -- the daemon ---------------------------------------------------------------


def test_service_swaps_under_load_with_no_drop_and_no_torn(di_cfg, prior,
                                                          tmp_path):
    """The daemon observes revisions, warm-rebuilds, publishes a full
    artifact and then a delta, and the registry hot-swaps while a
    scheduler serves traffic -- 0 dropped, 0 torn (every result bitwise
    equals a fresh load of its version's artifact)."""
    from explicit_hybrid_mpc_tpu_torch.obs.sink import load_jsonl
    from explicit_hybrid_mpc_tpu_torch.serve.scheduler import (
        RequestScheduler)

    obs = Obs("jsonl", path=str(tmp_path / "lc.obs.jsonl"))
    reg = ControllerRegistry(obs=obs)
    src = DriftSource("double_integrator", problem_args=DI_ARGS,
                      controller="di", eps_a=0.3, drift_arg="u_max",
                      drift_frac=0.05, n_revisions=2, seed=5)
    svc = RebuildService(
        src, di_cfg, cfg=LifecycleConfig(
            artifacts_root=str(tmp_path / "art"), sla_s=300.0),
        registry=reg, prior={"di": prior}, obs=obs)
    _gate(src, svc)
    svc.start()
    assert svc.wait_idle(timeout=300, target_generations=1)

    sched = RequestScheduler(reg, "di", max_batch=32, obs=obs)
    served, dropped = [], []
    stop = threading.Event()
    rng = np.random.default_rng(0)

    def load():
        while not stop.is_set():
            thetas = rng.uniform(-1.4, 1.4, size=(4, 2))
            try:
                served.extend(
                    zip(thetas, sched.submit_batch(thetas).result(30)))
            except Exception as e:  # noqa: BLE001 -- a drop IS the verdict
                dropped.append(e)

    t = threading.Thread(target=load, daemon=True)
    t.start()
    assert svc.wait_idle(timeout=300, target_generations=2)
    time.sleep(0.1)
    stop.set()
    t.join(30)
    assert not t.is_alive()
    sched.close()
    svc.close()
    obs.close()

    assert not dropped and served
    assert svc.n_failures == 0 and len(svc.generations) == 2
    assert [g["published"] for g in svc.generations] == ["full", "delta"]
    assert reg.active_version("di") == svc.generations[1]["version"]
    for g in svc.generations:
        assert g["staleness_s"] > 0 and g["reuse_frac"] is not None
    dirs = {g["version"]: g["artifact_dir"] for g in svc.generations}
    by_ver = {}
    for th, r in served:
        by_ver.setdefault(r.version, []).append((th, r))
    assert set(by_ver) <= set(dirs)
    torn = 0
    for ver, rows in by_ver.items():
        ref_reg = ControllerRegistry()
        ref_reg.load_artifacts("ref", ver, dirs[ver], devices=CPU)
        with ref_reg.lease("ref") as v:
            ref = v.server.evaluate(np.stack([th for th, _ in rows]))
        for j, (_th, r) in enumerate(rows):
            if r.fallback is None:
                torn += not np.array_equal(r.u, np.asarray(ref.u[j]))
    assert torn == 0
    recs = load_jsonl(str(tmp_path / "lc.obs.jsonl"))
    snaps = [r for r in recs if r.get("kind") == "metrics"]
    c = snaps[-1]["counters"]
    assert c["lifecycle.rebuilds"] == 2
    assert c["lifecycle.publishes_delta"] == 1
    assert c["lifecycle.sla_misses"] == 0
    assert snaps[-1]["gauges"]["lifecycle.staleness_p99_s"] > 0
    s = svc.summary()
    assert s["generations"] == 2 and s["delta_publishes"] == 1
    assert 0 < s["delta_bytes_frac"] < 1 and s["slo"] is None


def test_service_generations_match_the_jax_service(di_cfg, prior, tmp_path):
    """The same drift walk through both packages' daemons, each chained
    on its own prior: the same generation rows."""
    keys = ("seq", "generation", "reuse_frac", "excl_events",
            "subdivision_solves", "recert_solves", "regions", "note",
            "published", "version")
    jcfg = JaxConfig(problem="double_integrator", problem_args=DI_ARGS,
                     eps_a=0.3, backend="cpu", batch_simplices=128)
    jprior = jax_build(jax_make("double_integrator", **dict(DI_ARGS)), jcfg)
    rows = {}
    for name, (src_cls, svc_cls, lc_cls, cfg, pr) in {
            "port": (DriftSource, RebuildService, LifecycleConfig, di_cfg,
                     prior),
            "jax": (jrevision.DriftSource, jservice.RebuildService,
                    jservice.LifecycleConfig, jcfg, jprior)}.items():
        src = src_cls("double_integrator", problem_args=DI_ARGS,
                      controller="di", eps_a=0.3, drift_arg="u_max",
                      drift_frac=0.05, eps_frac=0.2, n_revisions=2, seed=11)
        svc = svc_cls(src, cfg, cfg=lc_cls(
            artifacts_root=str(tmp_path / name)), prior={"di": pr})
        _gate(src, svc)
        with svc:
            assert svc.wait_idle(timeout=300, target_generations=2)
        assert svc.n_failures == 0
        rows[name] = [{k: g[k] for k in keys} for g in svc.generations]
    assert rows["port"] == rows["jax"]


def test_service_coalesces_revision_storm(di_cfg, prior, tmp_path):
    obs = Obs("jsonl")
    revs = [_rev(1, extra=(("u_max", 0.99),)),
            _rev(2, extra=(("u_max", 0.98),)),
            _rev(3, extra=(("u_max", 0.97),))]
    holder: list = []
    src = StagedSource([
        (lambda: True, [revs[0]]),
        # The storm lands only once rev 1 is IN FLIGHT, so exactly rev 2
        # sits queued for rev 3 to supersede.
        (lambda: holder[0]._ctl["di"].in_flight, [revs[1], revs[2]]),
    ])
    svc = RebuildService(
        src, di_cfg, cfg=LifecycleConfig(
            artifacts_root=str(tmp_path / "art")),
        prior={"di": prior}, obs=obs)
    holder.append(svc)
    with svc:
        assert svc.wait_idle(timeout=300, target_generations=2)
        assert svc.wait_idle(timeout=60)
    assert svc.n_failures == 0
    assert [g["seq"] for g in svc.generations] == [1, 3]
    snap = obs.metrics.snapshot()["counters"]
    assert snap["lifecycle.revisions_seen"] == 3
    assert snap["lifecycle.revisions_superseded"] == 1


def test_service_contains_failures_and_keeps_serving(di_cfg, prior,
                                                     tmp_path):
    reg = ControllerRegistry()
    # rev 2's box change cannot warm-transfer (RebuildError): the daemon
    # counts it, keeps the old version serving, and still takes rev 3.
    ok1 = _rev(1, extra=(("u_max", 0.99),))
    bad = _rev(2, problem_args=(("N", 3), ("theta_box", 2.0)))
    good = _rev(3, extra=(("u_max", 0.98),))
    box: list = []
    src = StagedSource([
        (lambda: True, [ok1]),
        (lambda: len(box[0].generations) >= 1, [bad]),
        (lambda: box[0].n_failures >= 1, [good]),
    ])
    svc = RebuildService(
        src, di_cfg, cfg=LifecycleConfig(
            artifacts_root=str(tmp_path / "art")),
        registry=reg, prior={"di": prior})
    box.append(svc)
    with svc:
        assert svc.wait_idle(timeout=300, target_generations=1)
        v1 = reg.active_version("di")
        assert _wait_for(lambda: svc.n_failures == 1)
        assert reg.active_version("di") == v1  # old version serving
        assert svc.wait_idle(timeout=300, target_generations=2)
    assert svc.n_failures == 1 and len(svc.generations) == 2
    assert reg.active_version("di") == svc.generations[-1]["version"]


def test_injected_revision_fault_is_contained(di_cfg, prior, tmp_path):
    plan = faults.FaultPlan(faults=(
        faults.FaultSpec(site="lifecycle.revision", kind="error"),))
    box: list = []
    src = StagedSource([
        (lambda: True, [_rev(1, extra=(("u_max", 0.99),))]),
        (lambda: box[0].n_failures >= 1,
         [_rev(2, extra=(("u_max", 0.98),))])])
    with faults.activate(plan) as inj:
        svc = RebuildService(src, di_cfg, cfg=LifecycleConfig(
            artifacts_root=str(tmp_path / "art")), prior={"di": prior})
        box.append(svc)
        with svc:
            assert svc.wait_idle(timeout=300, target_generations=1)
        inj.assert_all_fired()
    assert svc.n_failures == 1
    assert [g["seq"] for g in svc.generations] == [2]


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_service_publish_crash_leaves_old_version_serving(di_cfg, prior,
                                                          tmp_path):
    """An injected crash BETWEEN the delta write and the swap kills the
    worker, the registry keeps serving the prior generation, and the
    crashed generation's directory never gets a commit marker."""
    reg = ControllerRegistry()
    plan = faults.FaultPlan(faults=(
        faults.FaultSpec(site="lifecycle.publish_delta", kind="crash"),))
    revs = [_rev(1, extra=(("u_max", 0.99),)),
            _rev(2, extra=(("u_max", 0.98),))]
    box: list = []
    src = StagedSource([
        (lambda: True, [revs[0]]),
        (lambda: len(box[0].generations) >= 1, [revs[1]]),
    ])
    with faults.activate(plan) as inj:
        svc = RebuildService(src, di_cfg, cfg=LifecycleConfig(
            artifacts_root=str(tmp_path / "art")), registry=reg,
            prior={"di": prior})
        box.append(svc)
        svc.start()
        assert not svc.wait_idle(timeout=300, target_generations=2)
        assert isinstance(svc.worker_error, faults.InjectedCrash)
        inj.assert_all_fired()
        assert reg.active_version("di") == svc.generations[0]["version"]
        art = os.path.join(str(tmp_path / "art"), "di")
        for name in os.listdir(art):
            if name.startswith("g0001") and not name.endswith(".delta"):
                assert not os.path.exists(
                    os.path.join(art, name, "meta.json"))
        svc.close(timeout=5)


def test_lifecycle_fault_sites_registered():
    faults.FaultSpec(site="lifecycle.revision", kind="error")
    faults.FaultSpec(site="lifecycle.publish_delta", kind="crash")
    faults.FaultSpec(site="rebuild.sweep", kind="error")


def test_drift_walk_ledger_bounded_and_decay_monotone(tmp_path):
    """A K=5 eps/plant drift walk of chained warm rebuilds on a hybrid
    problem keeps the stage-2 fact ledger bounded (dead events pruned,
    duplicates collapsed), and the summary reports the reuse decay as
    the running minimum of the per-generation fractions."""
    K = 5
    args = (("N", 2), ("theta_box", (0.25, 0.6)))
    cfg = PartitionConfig(problem="inverted_pendulum", problem_args=args,
                          eps_a=1.0, backend="cpu", batch_simplices=64)
    prior = build_partition(make("inverted_pendulum", **dict(args)), cfg)
    assert len(prior.tree.excl_events) > 0  # hybrid: a real ledger
    src = DriftSource("inverted_pendulum", problem_args=args,
                      controller="pend", eps_a=1.0, drift_arg="a",
                      drift_frac=0.01, eps_frac=0.02, n_revisions=K, seed=2)
    svc = RebuildService(src, cfg, cfg=LifecycleConfig(
        artifacts_root=str(tmp_path / "art")), prior={"pend": prior})
    _gate(src, svc)
    with svc:
        assert svc.wait_idle(timeout=600, target_generations=K)
    assert svc.n_failures == 0
    summary = svc.summary()
    assert summary["generations"] == K
    bound = 2 * len(prior.tree.excl_events) + 64
    assert max(summary["excl_events"]) <= bound
    reuse, decay = summary["reuse_fracs"], summary["reuse_decay"]
    assert len(reuse) == K and len(decay) == K
    assert all(d2 <= d1 + 1e-12 for d1, d2 in zip(decay, decay[1:]))
    assert decay == [round(float(m), 4) for m in np.minimum.accumulate(reuse)]
    assert min(reuse) < 1.0
    assert summary["delta_publishes"] >= K - 2
    assert summary["delta_bytes_frac"] < 0.8


def test_summary_reports_monotone_decay_without_builds(di_cfg):
    svc = RebuildService(ListSource([]), di_cfg,
                         cfg=LifecycleConfig(artifacts_root="unused"))
    reuse = [1.0, 0.97, 0.99, 0.91, 0.95, 0.91]
    for i, r in enumerate(reuse):
        svc.generations.append(
            {"generation": i, "reuse_frac": r, "excl_events": 10 + i,
             "published": "delta", "delta_bytes": 10, "full_bytes": 100})
        svc._staleness.append(1.0 + i)
    s = svc.summary()
    assert s["reuse_fracs"] == [round(r, 4) for r in reuse]
    assert s["reuse_decay"] == [1.0, 0.97, 0.97, 0.91, 0.91, 0.91]
    assert s["staleness_p50_s"] == pytest.approx(3.5)
    assert s["delta_bytes_frac"] == pytest.approx(0.1)


# -- configuration ------------------------------------------------------------


def test_lifecycle_config_validates():
    with pytest.raises(ValueError, match="poll_s"):
        LifecycleConfig(poll_s=0)
    with pytest.raises(ValueError, match="max_concurrent"):
        LifecycleConfig(max_concurrent=0)
    with pytest.raises(ValueError, match="full_every"):
        LifecycleConfig(full_every=-1)
    assert [f.name for f in dataclasses.fields(LifecycleConfig)] == [
        f.name for f in dataclasses.fields(jservice.LifecycleConfig)]


@pytest.mark.parametrize("field,value,module", [
    ("slo", True, "obs/slo.py"), ("slo_goal", 0.99, "obs/slo.py"),
    ("slo_interval_s", 5.0, "obs/slo.py"), ("slo_dir", "x", "obs/slo.py"),
    ("demand_dir", "x", "obs/demand.py")])
def test_unported_service_knobs_raise(field, value, module):
    jservice.LifecycleConfig(**{field: value})
    with pytest.raises(NotImplementedError, match=module):
        LifecycleConfig(**{field: value})


# -- the CLI ------------------------------------------------------------------

_DI = ["-e", "double_integrator", "--problem-arg", "N=3", "--problem-arg",
       "theta_box=1.5", "-a", "0.3", "--batch", "128"]


def test_serve_rebuild_cli_requires_artifacts_root():
    with pytest.raises(SystemExit):
        tmain.main(["serve-rebuild", "-e", "double_integrator"])


def test_serve_rebuild_unbounded_walk_needs_duration(tmp_path):
    with pytest.raises(SystemExit, match="--duration"):
        tmain.main(["serve-rebuild", *_DI, "--revisions", "0",
                    "--artifacts-root", str(tmp_path)])


def test_serve_rebuild_backend_defaults_to_cuda(tmp_path):
    args = build_parser().parse_args(
        ["-e", "double_integrator", "--artifacts-root", "x"])
    assert args.backend == "cuda"
    with pytest.raises(SystemExit, match="serial.*A1: oracle/bnb.py"):
        tmain.main(["serve-rebuild", *_DI, "--backend", "serial",
                    "--artifacts-root", str(tmp_path)])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="--backend cpu|'cpu'"):
            tmain.main(["serve-rebuild", *_DI,
                        "--artifacts-root", str(tmp_path)])


def test_serve_rebuild_cli_end_to_end_on_cpu(tmp_path, capsys):
    """One drift revision through `main serve-rebuild`: generation 0
    builds cold (no --prior), then the summary is printed."""
    out = str(tmp_path / "summary.json")
    rc = tmain.main(["serve-rebuild", *_DI, "--backend", "cpu",
                     "--revisions", "1", "--controller", "di",
                     "--artifacts-root", str(tmp_path / "lc"),
                     "--obs", "jsonl", "--json", out])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["generations"] == 1 and summary["failures"] == 0
    assert summary["controller"] == "di"
    assert summary["full_publishes"] == 1
    assert os.path.exists(str(tmp_path / "lc" / "lifecycle.obs.jsonl"))
    gens = json.load(open(out))["generations"]
    assert gens[0]["reuse_frac"] is None  # cold generation 0
    assert os.path.exists(os.path.join(gens[0]["artifact_dir"],
                                       "descent.npz"))


def test_serve_rebuild_cli_chains_from_a_prior(prior, tmp_path, capsys):
    path = str(tmp_path / "prior.tree.pkl")
    prior.tree.save(path)
    rev = str(tmp_path / "revs.jsonl")
    with open(rev, "w") as f:
        f.write(json.dumps({"problem": "double_integrator",
                            "problem_args": dict(DI_ARGS), "eps_a": 0.25,
                            "controller": "di"}) + "\n")
    rc = tmain.main(["serve-rebuild", *_DI, "--backend", "cpu",
                     "--controller", "di", "--source", rev, "--prior", path,
                     "--no-serve", "--artifacts-root",
                     str(tmp_path / "lc")])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["generations"] == 1 and summary["failures"] == 0
    assert 0.0 < summary["reuse_fracs"][0] < 1.0


def test_service_publishes_each_generation_into_a_device_arena(
        di_cfg, prior, tmp_path):
    """With an arena the service also hot-swaps every generation into it:
    the first from the full artifact, the next through the delta path."""
    from explicit_hybrid_mpc_tpu_torch.serve.arena import DeviceArena

    arena = DeviceArena(2, 1, device="cpu")
    src = DriftSource("double_integrator", problem_args=DI_ARGS,
                      controller="di", eps_a=0.3, drift_arg="u_max",
                      drift_frac=0.05, n_revisions=2, seed=5)
    svc = RebuildService(src, di_cfg, cfg=LifecycleConfig(
        artifacts_root=str(tmp_path / "art")), prior={"di": prior},
        arena=arena)
    _gate(src, svc)
    with svc:
        assert svc.wait_idle(timeout=300, target_generations=2)
    assert svc.n_failures == 0
    assert [g["published"] for g in svc.generations] == ["full", "delta"]
    assert arena.extent("di").version == svc.generations[1]["version"]
