"""Torch port: the runtime recompile sentinel
(``explicit_hybrid_mpc_tpu_torch/analysis/recompile_guard.py``) and its
frontier wiring, against the JAX package's tests/test_recompile_guard.py
(its 12 cases, ported) and the JAX engine itself.

- The guard over duck-typed probes: a cache of compiled variants that
  grows inside the guarded phase raises; a stable one passes; the
  kernel loader probe (``kernels.loader``) counts a kernel library
  loaded mid-phase; warn mode emits ``health.recompile`` and re-arms;
  the event lands in the port's obs stream; an in-flight exception is
  never masked; unusable probes are refused.
- The HealthMonitor adopts the event; PartitionConfig validates the
  mode.
- The frontier: the tier-1 DI build (N=3, theta_box=1.5, eps 0.2,
  batch_simplices 16 and 32) with the guard in warn mode has 0
  violations, no ``health.*`` event and the JAX package's tree node for
  node; synthetic ledger growth after the arm gives one event whose
  fields and step equal the JAX engine's at the same point of the same
  build; raise aborts; the partial-batch re-arm absolves; `main
  --recompile-guard` reaches the engine (and `--resume`), and `main
  rebuild --from` runs the guard too.
- A cold hybrid build (the small pendulum) trips the guard in BOTH
  packages: stage-2 and phase-2 buckets are first minted after the
  8-full-step warmup.  Warmed at every bucket first (the JAX package's
  benchmark practice, ``chip_smoke.warm_buckets``), the same build runs
  under raise with 0 violations and the cold build's tree.
"""

import os

import pytest
import torch

import explicit_hybrid_mpc_tpu  # noqa: F401  (enables x64)
from explicit_hybrid_mpc_tpu import obs as jobs
from explicit_hybrid_mpc_tpu.config import PartitionConfig as JaxConfig
from explicit_hybrid_mpc_tpu.partition.frontier import (
    FrontierEngine as JaxEngine)
from explicit_hybrid_mpc_tpu.partition.frontier import (
    make_oracle as jax_make_oracle)
from explicit_hybrid_mpc_tpu.partition.shard import (
    compare_trees_canonical)
from explicit_hybrid_mpc_tpu.problems.registry import make as jax_make
from explicit_hybrid_mpc_tpu_torch import kernels
from explicit_hybrid_mpc_tpu_torch import obs as obs_lib
from explicit_hybrid_mpc_tpu_torch.analysis.recompile_guard import (
    RecompileError, RecompileGuard)
from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
from explicit_hybrid_mpc_tpu_torch.obs.health import HealthMonitor
from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
    FrontierEngine, build_partition, make_oracle)
from explicit_hybrid_mpc_tpu_torch.problems.registry import make

import chip_smoke

torch.set_num_threads(1)


class _LedgerOracle:
    """Duck-typed stand-in for Oracle's compiled-shape ledger."""

    def __init__(self):
        self.compiled_shapes = {("grid", 8), ("pairs", 16)}


class _ShapeCache:
    """A callable caching one compiled variant per input shape, the way
    a jit cache does: the guard's `watch=` duck type."""

    def __init__(self):
        self.cache = {}

    def __call__(self, x):
        fn = self.cache.setdefault(tuple(x.shape), lambda t: t * 2.0)
        return fn(x)

    def _cache_size(self) -> int:
        return len(self.cache)


def test_guard_catches_shape_unstable_call():
    fn = _ShapeCache()
    with pytest.raises(RecompileError, match="cache entr"):
        with RecompileGuard(watch=[fn], action="raise"):
            fn(torch.zeros(4))   # first variant INSIDE the guarded phase
            fn(torch.zeros(16))  # second shape: the violation


def test_guard_passes_shape_stable_call():
    fn = _ShapeCache()
    fn(torch.zeros(4))  # built before the guarded phase
    with RecompileGuard(watch=[fn], action="raise"):
        for _ in range(3):
            fn(torch.ones(4))  # same shape: cache hits only


def test_kernel_loader_probe_counts_a_library_loaded_mid_phase(
        monkeypatch):
    """kernels.loader: a kernel library loaded inside the guarded phase
    is the port's counterpart of a new lowering (the load is stubbed:
    no nvcc or card here)."""
    monkeypatch.setattr(kernels, "_libs", {})
    monkeypatch.setattr(kernels, "_built", set())
    monkeypatch.setattr(kernels, "build", lambda names=None: {})
    monkeypatch.setattr(kernels.ctypes, "CDLL", lambda path: object())
    g = RecompileGuard(watch=[kernels.loader], action="warn")
    assert g.check() is None
    kernels.library("ipm_leg")
    kernels.library("ipm_leg")          # loaded once
    kernels.library("locate")
    ev = g.check()
    assert ev["value"] == 2 and "2 new cache entries" in ev["msg"]
    with pytest.raises(RecompileError):
        with RecompileGuard(watch=[kernels.loader], action="raise"):
            kernels.library("arena_eval")


def test_guard_ledger_warn_mode_emits_and_rearms():
    o = _LedgerOracle()
    g = RecompileGuard(oracle=o, action="warn", label="t")
    assert g.check() is None
    o.compiled_shapes.add(("grid", 32))
    ev = g.check(step=7)
    assert ev["name"] == "health.recompile" and ev["severity"] == "warn"
    assert ev["step"] == 7 and "grid[32]" in ev["msg"]
    # Re-armed: the same ledger state does not re-fire.
    assert g.check() is None
    assert g.n_violations == 1


def test_guard_event_lands_in_obs_stream(tmp_path):
    path = str(tmp_path / "s.obs.jsonl")
    with obs_lib.Obs("jsonl", path=path) as o:
        lo = _LedgerOracle()
        g = RecompileGuard(oracle=lo, obs=o, action="warn")
        lo.compiled_shapes.add(("grid", 64))
        g.check()
    recs = obs_lib.load_jsonl(path)
    evs = [r for r in recs if r.get("name") == "health.recompile"]
    assert len(evs) == 1 and evs[0]["severity"] == "warn"


def test_guard_exit_never_masks_inflight_exception():
    fn = _ShapeCache()
    with pytest.raises(KeyError):
        with RecompileGuard(watch=[fn], action="raise"):
            fn(torch.zeros(4))
            fn(torch.zeros(8))  # would raise at exit...
            raise KeyError("boom")  # ...but the real error wins


def test_guard_rejects_unusable_probes():
    with pytest.raises(ValueError, match="oracle"):
        RecompileGuard()
    with pytest.raises(ValueError, match="compiled_shapes"):
        RecompileGuard(oracle=object())
    with pytest.raises(ValueError, match="_cache_size"):
        RecompileGuard(watch=[lambda x: x])
    with pytest.raises(ValueError, match="action"):
        RecompileGuard(oracle=_LedgerOracle(), action="loud")


def test_health_monitor_adopts_external_health_events():
    mon = HealthMonitor()
    evs = mon.feed({"kind": "event", "name": "health.recompile",
                    "severity": "warn", "value": 1, "msg": "new shape"})
    assert mon.worst == "warn" and mon.exit_code == 1
    assert evs and evs[0]["name"] == "health.recompile"
    assert any(e["name"] == "health.recompile" for e in mon.events)
    mon.feed({"kind": "event", "name": "health.stall",
              "severity": "critical", "msg": "frozen"})
    assert mon.worst == "critical" and mon.exit_code == 2


def test_config_validates_guard_mode():
    with pytest.raises(ValueError, match="recompile_guard"):
        PartitionConfig(eps_a=0.2, recompile_guard="loud")
    for mode in ("off", "warn", "raise"):
        cfg = PartitionConfig(eps_a=0.2, backend="cpu",
                              recompile_guard=mode)
        assert cfg.recompile_guard == mode


# -- the frontier's wiring ------------------------------------------------------

_DI = dict(N=3, theta_box=1.5)


def _engines(path=None, B=16, mode="warn"):
    """The tier-1 DI fixture's engines, port and JAX, with the guard on
    (and an obs stream at `path` + '.port' / '.jax' when given)."""
    out = []
    for Cfg, Eng, mo, mk, O, tag in (
            (PartitionConfig, FrontierEngine, make_oracle, make, obs_lib,
             "port"),
            (JaxConfig, JaxEngine, jax_make_oracle, jax_make, jobs, "jax")):
        prob = mk("double_integrator", **_DI)
        kw = dict(obs="jsonl", obs_path=f"{path}.{tag}") if path else {}
        cfg = Cfg(eps_a=0.2, backend="cpu", batch_simplices=B,
                  recompile_guard=mode, **kw)
        o = O.Obs("jsonl", path=f"{path}.{tag}") if path else None
        eng = Eng(prob, mo(prob, cfg), cfg, **({"obs": o} if o else {}))
        out.append((eng, o, cfg))
    return out


def _strip(ev: dict) -> dict:
    """An event's fields without its timestamps."""
    return {k: v for k, v in ev.items() if k not in ("t", "ts", "wall")}


def test_frontier_guard_fires_on_synthetic_ledger_growth(tmp_path):
    """A DI build with the guard in warn mode is CLEAN in both packages,
    and a synthetic post-warmup ledger insertion produces ONE
    health.recompile event through the engine's own hook -- the same
    fields, and the same step, as the JAX engine's."""
    evs = []
    for eng, o, cfg in _engines(str(tmp_path / "b.obs.jsonl")):
        with o:
            while eng.frontier and eng.steps < 200:
                eng.step()
            assert eng.tree.n_regions() > 100
            assert eng._rc_guard.n_violations == 0
            eng._rc_steady_steps = eng._GUARD_WARMUP_FULL_STEPS + 1
            eng.oracle.compiled_shapes.add(("synthetic", 12345))
            eng._guard_step(cfg.batch_simplices)
            assert eng._rc_guard.n_violations == 1
        mod = obs_lib if "torch" in type(eng).__module__ else jobs
        recs = mod.load_jsonl(cfg.obs_path)
        got = [r for r in recs if r.get("name") == "health.recompile"]
        assert len(got) == 1 and "synthetic" in got[0]["msg"]
        evs.append(_strip(got[0]))
    port, ref = evs
    assert port == ref
    assert port["step"] > 0 and port["shapes"] == [["synthetic", 12345]]


def test_frontier_guard_absolves_partial_batch_shapes():
    """A backlog dip's partial wave legitimately mints a small bucket;
    the next FULL-size step must not inherit it as a violation (the
    partial branch re-arms an armed guard)."""
    eng, _o, cfg = _engines(mode="raise")[0]
    eng._rc_steady_steps = eng._GUARD_WARMUP_FULL_STEPS + 1
    eng.oracle.compiled_shapes.add(("partial_wave", 4))
    eng._guard_step(cfg.batch_simplices - 1)  # partial: exempt + re-arm
    eng._guard_step(cfg.batch_simplices)      # full: must NOT raise
    assert eng._rc_guard.n_violations == 0
    # A FULL step's own mint is still caught by its own end-of-step
    # check, partial re-arms notwithstanding.
    eng.oracle.compiled_shapes.add(("full_wave", 8))
    with pytest.raises(RecompileError):
        eng._guard_step(cfg.batch_simplices)


def test_frontier_guard_raise_mode_aborts():
    eng, _o, cfg = _engines(mode="raise")[0]
    eng._rc_steady_steps = eng._GUARD_WARMUP_FULL_STEPS + 1
    eng.oracle.compiled_shapes.add(("synthetic", 999))
    with pytest.raises(RecompileError):
        eng._guard_step(cfg.batch_simplices)
    # Off by default: no guard, no per-step work.
    prob = make("double_integrator", **_DI)
    cfg = PartitionConfig(eps_a=0.2, backend="cpu")
    assert FrontierEngine(prob, make_oracle(prob, cfg), cfg)._rc_guard \
        is None


@pytest.mark.parametrize("B", [16, 32])
def test_healthy_build_with_guard_emits_no_events(tmp_path, B):
    from explicit_hybrid_mpc_tpu.partition.frontier import (
        build_partition as jax_build)

    path = str(tmp_path / "clean.obs.jsonl")
    cfg = PartitionConfig(eps_a=0.2, backend="cpu", batch_simplices=B,
                          obs="jsonl", obs_path=path,
                          recompile_guard="warn")
    res = build_partition(make("double_integrator", **_DI), cfg)
    assert res.stats["uncertified"] == 0
    recs = obs_lib.load_jsonl(path)
    assert not [r for r in recs
                if str(r.get("name", "")).startswith("health.")]
    ref = jax_build(jax_make("double_integrator", **_DI),
                    JaxConfig(eps_a=0.2, backend="cpu", batch_simplices=B))
    assert compare_trees_canonical(res.tree, ref.tree) == []


# -- hybrid builds: cold trips the guard in both packages; warmed is clean -----

_PEND = dict(problem="inverted_pendulum", problem_args=(("N", 2),),
             eps_a=0.5, backend="cpu", batch_simplices=16, max_depth=14)


def _run(eng) -> list:
    """Step `eng` to the end; the (step, new shapes) of each step whose
    guard check fired."""
    fired = []
    while eng.frontier:
        before = set(eng.oracle.compiled_shapes)
        n0 = eng._rc_guard.n_violations
        eng.step()
        if eng._rc_guard.n_violations > n0:
            fired.append((eng.steps, sorted(set(eng.oracle.compiled_shapes)
                                            - before)))
    return fired


def test_a_cold_hybrid_build_trips_the_guard_in_both_packages():
    """The small pendulum from a cold oracle: after the 8 full steps the
    guard arms on, both engines still mint pair buckets (the phase-1
    pair batch of 16 at step 15, a phase-2 cohort of 16 later) -- the
    JAX package's guard fires the same way; its benchmark warms every
    bucket before a build."""
    out = []
    for Cfg, Eng, mo, mk in ((PartitionConfig, FrontierEngine, make_oracle,
                              make),
                             (JaxConfig, JaxEngine, jax_make_oracle,
                              jax_make)):
        prob = mk("inverted_pendulum", N=2)
        cfg = Cfg(**_PEND, recompile_guard="warn")
        eng = Eng(prob, mo(prob, cfg), cfg)
        out.append((_run(eng), sorted(eng.oracle.compiled_shapes),
                    eng.tree))
    (port, port_ledger, port_tree), (ref, ref_ledger, ref_tree) = out
    assert port and ref
    assert port[0] == ref[0] == (15, [("pairs", 16)])
    assert {s for _, ss in port for s in ss} \
        == {s for _, ss in ref for s in ss}
    assert port_ledger == ref_ledger
    assert compare_trees_canonical(port_tree, ref_tree) == []


def test_a_warmed_hybrid_build_runs_clean_under_raise():
    """Warmed at every bucket first (chip_smoke.warm_buckets, phase 21a's
    warmup; launches uncounted), the same build runs under raise with 0
    violations, the cold build's tree and the cold build's solves."""
    prob = make("inverted_pendulum", N=2)
    cold = build_partition(prob, PartitionConfig(**_PEND))
    cfg = PartitionConfig(**_PEND, recompile_guard="raise")
    oracle = make_oracle(prob, cfg)
    warmed = chip_smoke.warm_buckets(oracle, prob)
    assert ("pairs", 16) in warmed and ("simplex_min", 1024) in warmed
    eng = FrontierEngine(prob, oracle, cfg)
    assert _run(eng) == []
    res = eng.run()
    assert set(oracle.compiled_shapes) <= set(warmed)
    assert compare_trees_canonical(res.tree, cold.tree) == []
    assert res.stats["point_solves"] == cold.stats["point_solves"]


def test_main_recompile_guard_flag_reaches_the_engine(tmp_path):
    from explicit_hybrid_mpc_tpu_torch import main as tmain

    argv = ["-e", "double_integrator", "--problem-arg", "N=3",
            "--problem-arg", "theta_box=1.5", "-a", "0.2", "--batch", "16",
            "--backend", "cpu", "--recompile-guard", "raise"]
    args = tmain.build_parser().parse_args(argv)
    assert tmain.config_from_args(args).recompile_guard == "raise"
    assert tmain.config_from_args(tmain.build_parser().parse_args(
        argv[:-2])).recompile_guard == "off"
    out = os.path.join(str(tmp_path), "g")
    assert tmain.main([*argv, "-o", out, "--checkpoint-every", "3",
                       "--max-steps", "6"]) == 0
    # --resume takes this run's guard mode (a run-scoped field).
    from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
        load_checkpoint)

    snap = load_checkpoint(out + ".ckpt.pkl")
    assert snap["cfg"].recompile_guard == "raise"
    warn = tmain.config_from_args(tmain.build_parser().parse_args(
        [*argv[:-1], "warn"]))
    assert tmain.resumed_config(warn, snap["cfg"]).recompile_guard \
        == "warn"
    assert tmain.main([*argv[:-1], "warn", "-o", out + "r",
                       "--resume", out + ".ckpt.pkl"]) == 0


def test_the_warm_rebuild_runs_the_guard(tmp_path, monkeypatch):
    """`main rebuild --from` goes through the same engine (resume shares
    _init_diagnostics): its steps reach the guard hook, and a tightened
    DI rebuild under raise finishes clean."""
    from explicit_hybrid_mpc_tpu_torch import main as tmain

    di = ["-e", "double_integrator", "--problem-arg", "N=3",
          "--problem-arg", "theta_box=1.5", "--batch", "16",
          "--backend", "cpu"]
    prior = os.path.join(str(tmp_path), "p")
    assert tmain.main([*di, "-a", "0.3", "-o", prior]) == 0
    calls = []
    real = FrontierEngine._guard_step

    def hook(self, batch):
        calls.append((self._rc_guard.action, batch))
        return real(self, batch)
    monkeypatch.setattr(FrontierEngine, "_guard_step", hook)
    assert tmain.main(["rebuild", *di, "-a", "0.2", "--from",
                       prior + ".tree.pkl", "--recompile-guard", "raise",
                       "-o", os.path.join(str(tmp_path), "r")]) == 0
    assert calls and {a for a, _b in calls} == {"raise"}
