"""Torch port: every refusal of a surface that is not ported yet names
its ROADMAP item and the JAX package's module it waits for, and that
module is a file of the JAX package.  Since ROADMAP A6 there is none
left: the tables stay, empty, and every lifted surface runs.

A refusal names the module, not only the item number, so that a later
renumbering of ROADMAP.md cannot strand it.  The check reads paths
only: it imports nothing of the JAX package."""

import os
import re

import pytest

from explicit_hybrid_mpc_tpu_torch import config
from explicit_hybrid_mpc_tpu_torch import main as tmain
from explicit_hybrid_mpc_tpu_torch.lifecycle import service
from explicit_hybrid_mpc_tpu_torch.obs import Obs
from explicit_hybrid_mpc_tpu_torch.obs.demand import hub_from_serve_config
from explicit_hybrid_mpc_tpu_torch.obs.slo import slo_from_serve_config
from explicit_hybrid_mpc_tpu_torch.serve import scheduler

_JAX_PKG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "explicit_hybrid_mpc_tpu")


def _raised(fn) -> str:
    with pytest.raises((NotImplementedError, SystemExit)) as e:
        fn()
    return str(e.value)


#: (site, a callable giving the refusal's text; it takes a scratch dir).
#: Empty since ROADMAP A6 lifted the last refusal; a future one lands
#: here through the two tables.
SITES = (
    [(f"PartitionConfig.{f}", lambda tmp, item=item: item)
     for f, _on, item in config._UNPORTED]
    + [(f"main {flag}", lambda tmp, flag=flag: _raised(
        lambda: tmain.main(["-e", "double_integrator", flag, "1"])))
       for flag in tmain._UNPORTED_FLAGS])


def _check_refusal(site: str, msg: str) -> None:
    """A refusal's text names an A<n> ROADMAP label and a module that is
    a file of the JAX package."""
    assert re.search(r"\bA\d+\b", msg), msg
    modules = re.findall(r"[\w/]+\.py\b", msg)
    assert modules, msg
    for m in modules:
        assert os.path.isfile(os.path.join(_JAX_PKG, m)), (site, m)


#: The cases the check runs on: every refusal in the tables, or, while
#: they are empty, the tables' emptiness itself (so the parametrization
#: never collects zero cases).
CASES = SITES or [("no refusal left", None)]


@pytest.mark.parametrize("site,text", CASES, ids=[s for s, _ in CASES])
def test_a_refusal_names_its_item_and_an_existing_jax_module(site, text,
                                                             tmp_path):
    if text is None:
        assert config._UNPORTED == () and tmain._UNPORTED_FLAGS == {}
        return
    _check_refusal(site, text(str(tmp_path)))


@pytest.mark.parametrize("msg,ok", [
    ("PartitionConfig.x is not yet ported to the torch package (ROADMAP "
     "A6: analysis/recompile_guard.py)", True),
    ("--x: not yet ported to the torch package (ROADMAP "
     "A6 (analysis/recompile_guard.py))", True),
    ("not yet ported (ROADMAP analysis/recompile_guard.py)", False),
    ("not yet ported (ROADMAP A6: analysis/no_such_module.py)", False),
    ("not yet ported (ROADMAP A6)", False)])
def test_a_future_refusal_must_name_a_label_and_a_jax_module(msg, ok):
    """The check any future refusal goes through, on the texts the two
    tables format: a label and an existing JAX module pass; a missing
    label, a missing module or a module the JAX package lacks fail."""
    if ok:
        _check_refusal("future", msg)
    else:
        with pytest.raises(AssertionError):
            _check_refusal("future", msg)


def _guard_di(tmp, flags=(), **kw):
    """The tier-1 DI build under the recompile guard (warn), through
    main or PartitionConfig, on the CPU: the plain build's tree, no
    health event."""
    from explicit_hybrid_mpc_tpu_torch.obs import load_jsonl

    obs = os.path.join(tmp, "g.obs.jsonl")
    if flags:
        _main_di(tmp, [*flags, "--obs", "jsonl", "--obs-path", obs])
    else:
        _lib_di(tmp, obs="jsonl", obs_path=obs, **kw)
    assert not [r for r in load_jsonl(obs)
                if str(r.get("name", "")).startswith("health.")]


def _obs_per_process(tmp):
    from explicit_hybrid_mpc_tpu_torch.obs import Obs, fleet

    o = Obs("jsonl", path=os.path.join(tmp, "x.obs.jsonl"), per_process=True)
    o.close()
    assert len(fleet.sibling_streams(os.path.join(tmp, "x.obs.jsonl"))) == 1


def _main_flag(tmp, flags):
    """The DI build through main with `flags`, to max-steps 2."""
    assert tmain.main(["-e", "double_integrator", "--problem-arg", "N=3",
                       "--backend", "cpu", "-a", "0.5", "--max-steps", "2",
                       "-o", os.path.join(tmp, "p"), *flags]) == 0


def _hub(tmp, attr, want, **kw):
    """ServeConfig(demand="on", **kw) builds an enabled hub whose
    `attr` is `want`."""
    hub = hub_from_serve_config(config.ServeConfig(demand="on", **kw))
    try:
        assert hub is not None and hub.enabled
        assert getattr(hub, attr) == want, (attr, getattr(hub, attr))
    finally:
        hub.close(snapshot=False)


def _demand_dir(tmp):
    """--demand-dir's field: the hub's closing snapshot lands there."""
    import numpy as np

    from explicit_hybrid_mpc_tpu_torch.obs.demand import load_demand

    hub = hub_from_serve_config(config.ServeConfig(demand="on",
                                                   demand_dir=tmp))
    hub.record("c", np.zeros((3, 2)), np.array([4, 4, 1]), None,
               np.ones(3, dtype=bool), np.zeros(3))
    hub.close()
    assert load_demand(os.path.join(tmp, "c")).leaf_ids.tolist() == [4, 1]


def _tracker(tmp, attr, want, **kw):
    """ServeConfig(slo="on", **kw) builds a serving tracker whose `attr`
    (a serve_template key when it starts with "tpl.") is `want`."""
    tr = slo_from_serve_config(config.ServeConfig(slo="on", **kw))
    assert tr is not None and tr.enabled
    got = (tr.serve_template[attr[4:]] if attr.startswith("tpl.")
           else getattr(tr, attr))
    assert got == want, (attr, got)


def _lifecycle(tmp, **kw):
    """A RebuildService under LifecycleConfig(**kw) with obs on: built,
    summarized and closed without a generation; with slo on its tracker
    is attached and its state file lands in slo_dir."""
    from explicit_hybrid_mpc_tpu_torch.lifecycle.revision import (
        FileRevisionSource)

    lc = service.LifecycleConfig(**kw)
    o = Obs("jsonl")
    svc = service.RebuildService(
        FileRevisionSource(os.path.join(tmp, "revs.jsonl")),
        config.PartitionConfig(backend="cpu"), lc, obs=o)
    summ = svc.summary()
    svc.close()
    o.close()
    assert (svc.slo is not None) == lc.slo
    assert (summ["slo"] is not None) == lc.slo
    if lc.slo_dir is not None:
        assert os.path.isfile(os.path.join(lc.slo_dir,
                                           "slo.lifecycle.state.json"))
    if lc.slo:
        assert svc.slo.interval_s == lc.slo_interval_s
        assert {s.goal for s in svc.slo.specs} == {lc.slo_goal}


def _hook(tmp, hook):
    """RequestScheduler(demand=/slo=) holds an enabled hub and serves
    without it: the slo tracker persists on close()."""
    from explicit_hybrid_mpc_tpu_torch.obs.demand import DemandHub
    from explicit_hybrid_mpc_tpu_torch.obs.slo import SloTracker
    from explicit_hybrid_mpc_tpu_torch.serve.registry import (
        ControllerRegistry)

    hub = (DemandHub(mode="on") if hook == "demand"
           else SloTracker(interval_s=1.0, windows=((5.0, 60.0),),
                           burn_thresholds=(14.4,), state_dir=tmp))
    sched = scheduler.RequestScheduler(ControllerRegistry(), "c",
                                       **{hook: hub})
    assert getattr(sched, hook) is hub
    sched.close()
    if hook == "slo":
        assert os.path.isfile(hub._state_path())
    else:
        hub.close()


_DI = ["-e", "double_integrator", "--problem-arg", "N=3", "--problem-arg",
       "theta_box=1.5", "-a", "0.5", "--batch", "32", "--backend", "cpu"]


def _tree_bytes(prefix: str) -> list:
    from explicit_hybrid_mpc_tpu_torch.partition.tree import Tree

    return sorted(v.tobytes() for v in Tree.load(prefix + ".tree.pkl")
                  .vertices)


def _main_di(tmp, flags, name="x") -> list:
    """The tier-1 DI build through main with `flags`, against the plain
    build: the same tree (canonical order); returns its vertex bytes."""
    out = os.path.join(tmp, name)
    assert tmain.main([*_DI, *flags, "-o", out]) == 0
    assert tmain.main([*_DI, "-o", os.path.join(tmp, "plain")]) == 0
    got = _tree_bytes(out)
    assert got == _tree_bytes(os.path.join(tmp, "plain"))
    return got


def _lib_di(tmp, oracle_mesh=None, **kw):
    """build_partition on the tier-1 DI under PartitionConfig(**kw) (and
    an oracle on `oracle_mesh`): the plain build's tree."""
    from explicit_hybrid_mpc_tpu_torch.oracle.oracle import Oracle
    from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
        build_partition)
    from explicit_hybrid_mpc_tpu_torch.problems.registry import make

    prob = make("double_integrator", N=3, theta_box=1.5)
    cfg = dict(problem="double_integrator",
               problem_args=(("N", 3), ("theta_box", 1.5)), eps_a=0.5,
               backend="cpu", batch_simplices=32)
    plain = build_partition(prob, config.PartitionConfig(**cfg))
    oracle = None if oracle_mesh is None else Oracle(
        prob, backend="cpu", mesh=oracle_mesh)
    got = build_partition(prob, config.PartitionConfig(**cfg, **kw),
                          oracle=oracle)
    assert [v.tobytes() for v in got.tree.vertices] \
        == [v.tobytes() for v in plain.tree.vertices]
    return got


def _cpu_mesh(n):
    import torch

    from explicit_hybrid_mpc_tpu_torch.parallel import make_mesh

    return make_mesh((n, 1), [torch.device("cpu")] * n)


def _oracle_mesh(tmp):
    """Oracle(mesh=) answers the plain oracle's vertex grid."""
    import numpy as np

    from explicit_hybrid_mpc_tpu_torch.oracle.oracle import Oracle
    from explicit_hybrid_mpc_tpu_torch.problems.registry import make

    prob = make("double_integrator", N=3)
    th = np.random.default_rng(0).uniform(-1, 1, (9, 2))
    a = Oracle(prob, backend="cpu", mesh=_cpu_mesh(4)).solve_vertices(th)
    b = Oracle(prob, backend="cpu").solve_vertices(th)
    assert np.array_equal(a.dstar, b.dstar)
    assert np.allclose(a.Vstar, b.Vstar, rtol=1e-9, atol=0)


def _shard_dir(tmp):
    """--shard-dir: two launcher shards exchange cells there and leave
    each shard's tree beside the manifest; the merged tree is the plain
    build's."""
    from explicit_hybrid_mpc_tpu_torch.parallel.launch import launch_sharded

    ex, out = os.path.join(tmp, "ex"), os.path.join(tmp, "sh")
    r = launch_sharded([*_DI, "--shard-dir", ex, "-o", out], n_processes=2,
                       timeout_s=300)
    assert r["rc"] == 0, r["stderr"]
    assert {"manifest.json", "tree.p0.pkl", "tree.p1.pkl"} \
        <= set(os.listdir(ex))
    assert not os.path.exists(out + ".shard")
    assert tmain.main([*_DI, "-o", os.path.join(tmp, "plain")]) == 0
    assert _tree_bytes(out) == _tree_bytes(os.path.join(tmp, "plain"))


def _shard_timeout(tmp):
    """--shard-timeout S is the build's remote-cell budget; a lone shard
    builds the plain tree."""
    args = tmain.build_parser().parse_args(
        [*_DI, "--shard-frontier", "--shard-timeout", "30"])
    assert tmain.config_from_args(args).shard_timeout_s == 30.0
    _main_di(tmp, ["--shard-frontier", "--shard-timeout", "30"])


def _shard_resume(tmp):
    """A lone shard's checkpoint resumes to the straight build."""
    ck = os.path.join(tmp, "x")
    assert tmain.main([*_DI, "--shard-frontier", "--max-steps", "3",
                       "--checkpoint-every", "1", "-o", ck]) == 0
    assert tmain.main([*_DI, "--shard-frontier", "-o",
                       os.path.join(tmp, "r"), "--resume",
                       ck + ".ckpt.pkl"]) == 0
    assert tmain.main([*_DI, "-o", os.path.join(tmp, "plain")]) == 0
    assert _tree_bytes(os.path.join(tmp, "r")) \
        == _tree_bytes(os.path.join(tmp, "plain"))


#: The surfaces ROADMAP A4 lifted (the solve mesh, the sharded frontier):
#: each now runs on the CPU instead of refusing.
LIFTED_A4 = {
    # Accepted and read nowhere, as in the JAX package: the build is
    # the plain one.
    "PartitionConfig.mesh_devices": lambda tmp: _lib_di(tmp,
                                                        mesh_devices=2),
    "PartitionConfig.shard_frontier": lambda tmp: _lib_di(
        tmp, shard_frontier=True),
    "Oracle mesh": _oracle_mesh,
    "Oracle mesh build": lambda tmp: _lib_di(tmp, oracle_mesh=_cpu_mesh(2)),
    "main --mesh": lambda tmp: _main_di(tmp, ["--mesh", "2"]),
    "main --shard-frontier": lambda tmp: _main_di(
        tmp, ["--shard-frontier", "--obs", "jsonl"]),
    "main --shard-dir": _shard_dir,
    "main --shard-timeout": _shard_timeout,
    "main --shard-frontier --resume": _shard_resume,
}

#: The surfaces ROADMAP A6 lifted (analysis/recompile_guard.py): each
#: runs a DI build on the CPU under the guard in warn mode.
LIFTED_A6 = {
    "PartitionConfig.recompile_guard": lambda tmp: _guard_di(
        tmp, recompile_guard="warn"),
    "main --recompile-guard": lambda tmp: _guard_di(
        tmp, ["--recompile-guard", "warn"]),
}

#: The surfaces ROADMAP A5 lifted: each now runs instead of refusing.
#: The first half ported obs/recorder.py, obs/health.py and
#: obs/fleet.py; the second obs/slo.py and obs/demand.py, whose
#: ServeConfig fields, LifecycleConfig fields and scheduler hooks follow.
LIFTED = {
    "ServeConfig.demand": lambda tmp: _hub(tmp, "mode", "on"),
    "ServeConfig.demand_max_leaves": lambda tmp: _hub(
        tmp, "max_leaves", 77, demand_max_leaves=77),
    "ServeConfig.demand_decay_s": lambda tmp: _hub(
        tmp, "decay_halflife_s", 12.5, demand_decay_s=12.5),
    "ServeConfig.demand_reservoir": lambda tmp: _hub(
        tmp, "reservoir_k", 9, demand_reservoir=9),
    "ServeConfig.demand_subopt_frac": lambda tmp: _hub(
        tmp, "subopt_frac", 0.25, demand_subopt_frac=0.25),
    "ServeConfig.demand_subopt_eps": lambda tmp: _hub(
        tmp, "subopt_eps", 0.3, demand_subopt_eps=0.3),
    "ServeConfig.demand_snapshot_every_s": lambda tmp: _hub(
        tmp, "snapshot_every_s", 4.0, demand_snapshot_every_s=4.0),
    "ServeConfig.demand_dir": _demand_dir,
    "ServeConfig.slo": lambda tmp: _tracker(tmp, "identity",
                                            "serve.default"),
    "ServeConfig.slo_goal": lambda tmp: _tracker(
        tmp, "tpl.goal", 0.99, slo_goal=0.99),
    "ServeConfig.slo_p99_target_us": lambda tmp: _tracker(
        tmp, "tpl.p99_target_us", 900.0, slo_p99_target_us=900.0),
    "ServeConfig.slo_interval_s": lambda tmp: _tracker(
        tmp, "interval_s", 30.0, slo_interval_s=30.0),
    "ServeConfig.slo_dir": lambda tmp: _tracker(
        tmp, "state_dir", tmp, slo_dir=tmp),
    "LifecycleConfig.demand_dir": lambda tmp: _lifecycle(
        tmp, demand_dir=tmp),
    "LifecycleConfig.slo": lambda tmp: _lifecycle(tmp, slo=True),
    "LifecycleConfig.slo_goal": lambda tmp: _lifecycle(
        tmp, slo=True, slo_goal=0.99),
    "LifecycleConfig.slo_interval_s": lambda tmp: _lifecycle(
        tmp, slo=True, slo_interval_s=30.0),
    "LifecycleConfig.slo_dir": lambda tmp: _lifecycle(
        tmp, slo=True, slo_dir=os.path.join(tmp, "slo")),
    "scheduler hook demand": lambda tmp: _hook(tmp, "demand"),
    "scheduler hook slo": lambda tmp: _hook(tmp, "slo"),
    "PartitionConfig.obs_recorder": lambda tmp: config.PartitionConfig(
        backend="cpu", obs_recorder=True),
    "PartitionConfig.recorder_dir": lambda tmp: config.PartitionConfig(
        backend="cpu", recorder_dir=tmp),
    "PartitionConfig.health_rules": lambda tmp: config.PartitionConfig(
        backend="cpu", health_rules=(("stall_s", 9.0),)),
    "main --recorder": lambda tmp: _main_flag(tmp, ["--recorder"]),
    "main --recorder-dir": lambda tmp: _main_flag(
        tmp, ["--recorder-dir", os.path.join(tmp, "b")]),
    "main --health-rule": lambda tmp: _main_flag(
        tmp, ["--obs", "jsonl", "--health-rule", "stall_s=300"]),
    "main --obs-per-process": lambda tmp: _main_flag(
        tmp, ["--obs", "jsonl", "--obs-per-process"]),
    "Obs per_process": _obs_per_process,
    **LIFTED_A4,
    **LIFTED_A6,
}


@pytest.mark.parametrize("site", sorted(LIFTED))
def test_a_lifted_refusal_now_runs(site, tmp_path):
    LIFTED[site](str(tmp_path))
    assert not any(site == s for s, _ in SITES)
