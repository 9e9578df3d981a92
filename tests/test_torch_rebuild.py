"""Torch port: the incremental warm rebuild (partition/rebuild.py) against
the JAX package's.

The JAX package's own fixture (tests/test_rebuild.py): the tier-1
double integrator (N=3, theta_box=1.5) at eps_a=0.3 with 128 simplices a
batch is the prior; the tightened revision is eps_a=0.15.  The two
packages' priors are node-for-node equal (tests/test_torch_build.py), so
each package rebuilds from its own:

- unchanged: the rebuilt tree is bitwise the prior and the frontier
  issues no oracle solve;
- tightened: the rebuilt tree is node-for-node the JAX package's --
  structure, decisions, certificates and the exclusion ledger bitwise,
  payload floats to 1e-12 relative -- and the reuse statistics are
  equal;
- the JAX tests' contracts (checkpoint donors, resume mid-rebuild,
  incompatible and unstamped priors, publish, ledger pruning, the CLI).

Trees are compared through their columnar state, never by unpickling
one package's pickle in the other (a pickle names its package's
classes)."""

import dataclasses
import json
import os
import pickle

import numpy as np
import pytest
import torch

import explicit_hybrid_mpc_tpu  # noqa: F401  (enables x64)
from explicit_hybrid_mpc_tpu import main as jmain
from explicit_hybrid_mpc_tpu.config import PartitionConfig as JaxConfig
from explicit_hybrid_mpc_tpu.partition import frontier as jfrontier
from explicit_hybrid_mpc_tpu.partition.rebuild import (
    warm_rebuild as jax_rebuild)
from explicit_hybrid_mpc_tpu.problems.registry import make as jax_make
from explicit_hybrid_mpc_tpu_torch import device as device_lib
from explicit_hybrid_mpc_tpu_torch import faults
from explicit_hybrid_mpc_tpu_torch import main as tmain
from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
from explicit_hybrid_mpc_tpu_torch.obs import Obs
from explicit_hybrid_mpc_tpu_torch.partition import provenance as prov
from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
    FrontierEngine, build_partition, make_oracle)
from explicit_hybrid_mpc_tpu_torch.partition.rebuild import (
    RebuildError, publish_rebuild, warm_rebuild)
from explicit_hybrid_mpc_tpu_torch.partition.tree import Tree
from explicit_hybrid_mpc_tpu_torch.problems.registry import make

torch.set_num_threads(1)

DI_ARGS = {"N": 3, "theta_box": 1.5}
EPS, EPS_TIGHT = 0.3, 0.15

#: Tree-state columns compared bitwise; the float payload columns are
#: compared to 1e-12 relative (their last bits follow the summation
#: order of each package's solver).
_EXACT = ("format", "p", "n_u", "n", "root_vertices", "parent", "children",
          "depth", "split_edge", "leaf_flags", "leaf_slot", "pl_delta",
          "pl_zidx", "n_regions", "max_depth", "excl_events")
_FLOAT = ("normal", "offset", "pl_inputs", "pl_costs", "z_store")


def _states_equal(ta, tb, ignore=("provenance",)) -> bool:
    """Bitwise equality of two port trees' columnar states."""
    a, b = ta.__getstate__(), tb.__getstate__()
    if set(a) != set(b):
        return False
    for k in a:
        if k in ignore:
            continue
        va, vb = a[k], b[k]
        if isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
            if not np.array_equal(va, vb):
                return False
        elif va != vb:
            return False
    return True


def assert_tree_matches_reference(got, ref) -> None:
    """A port tree against a JAX tree: node for node (ROADMAP C)."""
    a, b = got.__getstate__(), ref.__getstate__()
    assert set(a) == set(b)
    assert set(a) == set(_EXACT) | set(_FLOAT) | {"provenance"}
    for k in _EXACT:
        va, vb = a[k], b[k]
        if isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
            assert va is not None and vb is not None, k
            assert va.dtype == vb.dtype and np.array_equal(va, vb), k
        else:
            assert va == vb, k
    for k in _FLOAT:
        va, vb = a[k], b[k]
        if va is None or vb is None:
            assert va is None and vb is None, k
            continue
        scale = max(1.0, float(np.abs(vb).max())) if vb.size else 1.0
        np.testing.assert_allclose(va, vb, rtol=1e-12, atol=1e-12 * scale,
                                   err_msg=k)
    n = a["n"]
    assert np.array_equal(got.vertices[:n], ref.vertices[:n])
    assert got.provenance["problem_hash"] == ref.provenance["problem_hash"]


@pytest.fixture(scope="module")
def di_problem():
    return make("double_integrator", **DI_ARGS)


@pytest.fixture(scope="module")
def di_cfg():
    return PartitionConfig(problem="double_integrator", eps_a=EPS,
                           backend="cpu", batch_simplices=128)


@pytest.fixture(scope="module")
def tight_cfg(di_cfg):
    return dataclasses.replace(di_cfg, eps_a=EPS_TIGHT)


@pytest.fixture(scope="module")
def prior(di_problem, di_cfg):
    return build_partition(di_problem, di_cfg)


@pytest.fixture(scope="module")
def tight_rebuild(di_problem, tight_cfg, prior):
    return warm_rebuild(di_problem, tight_cfg, prior.tree)


@pytest.fixture(scope="module")
def reference():
    """The JAX package's prior and its unchanged and tightened rebuilds."""
    problem = jax_make("double_integrator", **DI_ARGS)
    cfg = JaxConfig(problem="double_integrator", eps_a=EPS, backend="cpu",
                    batch_simplices=128)
    prior = jfrontier.build_partition(problem, cfg)
    return {"prior": prior,
            "unchanged": jax_rebuild(problem, cfg, prior.tree),
            "tight": jax_rebuild(problem, dataclasses.replace(
                cfg, eps_a=EPS_TIGHT), prior.tree)}


# -- the acceptance cases -----------------------------------------------------


def test_unchanged_rebuild_bit_identical_zero_subdivision(
        di_problem, di_cfg, prior, tmp_path):
    path = str(tmp_path / "prior.tree.pkl")
    prior.tree.save(path)
    res = warm_rebuild(di_problem, di_cfg, path)
    st = res.stats
    assert st["subdivision_solves"] == 0
    assert st["rebuild_leaves_invalidated"] == 0
    assert st["rebuild_reuse_frac"] == 1.0
    assert st["recert_solves"] > 0  # the sweep DID re-prove everything
    assert st["regions"] == prior.stats["regions"]
    assert st["rebuild_prior_source"] == "tree"
    assert _states_equal(prior.tree, res.tree)
    assert res.tree.provenance is not None
    assert prov.diff_stamps(res.tree.provenance,
                            prior.tree.provenance) == []


def test_the_priors_are_the_same_tree(prior, reference):
    assert_tree_matches_reference(prior.tree, reference["prior"].tree)


def test_unchanged_rebuild_matches_the_reference(di_problem, di_cfg, prior,
                                                 reference):
    res = warm_rebuild(di_problem, di_cfg, prior.tree)
    ref = reference["unchanged"]
    assert ref.stats["subdivision_solves"] == 0
    assert_tree_matches_reference(res.tree, ref.tree)
    for k in ("recert_solves", "rebuild_leaves_total",
              "rebuild_excl_events", "rebuild_excl_reverified"):
        assert res.stats[k] == ref.stats[k], k


def test_unchanged_rebuild_via_build_partition_route(di_problem, di_cfg,
                                                     prior, tmp_path):
    path = str(tmp_path / "prior.tree.pkl")
    prior.tree.save(path)
    res = build_partition(di_problem,
                          dataclasses.replace(di_cfg, rebuild_from=path))
    assert res.stats["rebuild_reuse_frac"] == 1.0
    assert res.stats["subdivision_solves"] == 0
    assert _states_equal(prior.tree, res.tree)


def test_tightened_rebuild_tree_matches_the_reference(tight_rebuild,
                                                      reference):
    assert tight_rebuild.stats["subdivision_solves"] > 0
    assert_tree_matches_reference(tight_rebuild.tree,
                                  reference["tight"].tree)


@pytest.mark.parametrize("key", [
    "recert_solves", "subdivision_solves", "rebuild_leaves_total",
    "rebuild_leaves_reused", "rebuild_leaves_invalidated",
    "rebuild_leaves_recertified", "rebuild_reuse_frac", "regions",
    "uncertified", "truncated", "rebuild_excl_events",
    "rebuild_excl_reverified", "provenance_changed"])
def test_tightened_rebuild_stats_match_the_reference(key, tight_rebuild,
                                                     reference):
    assert tight_rebuild.stats[key] == reference["tight"].stats[key]


def test_eps_tightened_rebuild_matches_cold_verdicts(
        di_problem, tight_cfg, tight_rebuild):
    cold = build_partition(di_problem, tight_cfg)
    st = tight_rebuild.stats
    assert st["uncertified"] == 0 and cold.stats["uncertified"] == 0
    assert not st["truncated"] and not cold.stats["truncated"]
    assert 0.0 < st["rebuild_reuse_frac"] < 1.0
    assert st["rebuild_leaves_invalidated"] > 0
    assert st["provenance_changed"] == ["eps_a: 0.3 != 0.15"]
    rng = np.random.default_rng(0)
    qs = rng.uniform(di_problem.theta_lb, di_problem.theta_ub,
                     size=(400, di_problem.n_theta))
    for q in qs:
        la = cold.tree.locate(q, cold.roots)
        lb = tight_rebuild.tree.locate(q, tight_rebuild.roots)
        da = cold.tree.leaf_data[la] if la >= 0 else None
        db = tight_rebuild.tree.leaf_data[lb] if lb >= 0 else None
        assert (da is None) == (db is None)
        if da is not None:
            assert da.certified == db.certified


# -- the JAX tests' contracts -------------------------------------------------


def test_rebuild_checkpoint_donors_are_consumed(di_problem, di_cfg,
                                                tmp_path):
    ckpt = str(tmp_path / "prior.ckpt.pkl")
    cfg = dataclasses.replace(di_cfg, checkpoint_every=3,
                              checkpoint_path=ckpt, max_steps=6)
    build_partition(di_problem, cfg)  # truncated, checkpoint written
    assert os.path.exists(ckpt)
    full_cfg = dataclasses.replace(cfg, checkpoint_every=0,
                                   checkpoint_path=None, max_steps=10_000)
    reb = warm_rebuild(di_problem, full_cfg, ckpt)
    assert reb.stats["rebuild_prior_source"] == "checkpoint"
    assert reb.stats["uncertified"] == 0
    assert not reb.stats["truncated"]
    assert reb.stats["rebuild_leaves_total"] > 0
    assert reb.stats["warm_donor_vertices"] > 0
    assert reb.stats["regions"] > 0


def test_resume_mid_rebuild_reaches_the_same_tree(
        di_problem, tight_cfg, prior, tight_rebuild, tmp_path):
    ckpt = str(tmp_path / "rebuild.ckpt.pkl")
    cfg = dataclasses.replace(tight_cfg, checkpoint_every=1,
                              checkpoint_path=ckpt, max_steps=1)
    partial = warm_rebuild(di_problem, cfg, prior.tree)
    assert partial.stats["truncated"]
    assert os.path.exists(ckpt)
    eng = FrontierEngine.resume(
        ckpt, di_problem, make_oracle(di_problem, tight_cfg),
        cfg=dataclasses.replace(tight_cfg, max_steps=10_000))
    res = eng.run()
    assert res.stats["uncertified"] == 0
    assert _states_equal(res.tree, tight_rebuild.tree)


def test_incompatible_prior_rejected(prior):
    other = make("double_integrator", N=3, theta_box=2.0)
    cfg = PartitionConfig(problem="double_integrator", eps_a=EPS,
                          backend="cpu")
    with pytest.raises(RebuildError, match="root triangulation"):
        warm_rebuild(other, cfg, prior.tree)
    with pytest.raises(RebuildError, match="p=2"):
        warm_rebuild(make("double_integrator", N=3), cfg,
                     Tree(p=3, n_u=1))


def test_prior_of_the_wrong_kind_rejected(di_problem, di_cfg, tmp_path):
    with pytest.raises(RebuildError, match="unsupported prior"):
        warm_rebuild(di_problem, di_cfg, 42)
    with pytest.raises(RebuildError, match="without a tree.pkl"):
        warm_rebuild(di_problem, di_cfg, str(tmp_path))
    torn = tmp_path / "torn.tree.pkl"
    torn.write_bytes(b"not a pickle")
    with pytest.raises(RebuildError):
        warm_rebuild(di_problem, di_cfg, str(torn))


def test_strict_provenance_rejects_unstamped_prior(di_problem, di_cfg,
                                                   prior):
    legacy = pickle.loads(pickle.dumps(prior.tree))
    legacy.provenance = None
    with pytest.raises(prov.ProvenanceMismatch, match="no provenance"):
        warm_rebuild(di_problem, di_cfg, legacy, strict_provenance=True)
    res = warm_rebuild(di_problem, di_cfg, legacy)
    assert any("no provenance" in d
               for d in res.stats["provenance_changed"])
    assert res.stats["rebuild_reuse_frac"] == 1.0


def test_publish_rebuild_hot_swaps_registry(di_problem, di_cfg, prior,
                                            tmp_path):
    from explicit_hybrid_mpc_tpu_torch.serve.registry import (
        ControllerRegistry)

    cpu = [torch.device("cpu")]
    reg = ControllerRegistry()
    v1 = publish_rebuild(prior, str(tmp_path / "v1"), registry=reg,
                         name="di", devices=cpu)
    assert reg.active_version("di") == v1
    res = warm_rebuild(di_problem, dataclasses.replace(di_cfg, eps_a=0.25),
                       prior.tree)
    v2 = publish_rebuild(res, str(tmp_path / "v2"), registry=reg,
                         name="di", devices=cpu)
    assert v2 != v1
    assert reg.active_version("di") == v2
    with reg.lease("di") as ver:
        assert ver.version == v2


def test_dead_ledger_events_pruned_from_rebuilt_tree(di_problem, di_cfg,
                                                     prior):
    doctored = pickle.loads(pickle.dumps(prior.tree))
    root = doctored.roots()[0]
    # The root simplex is feasible for delta 0, so this bogus emptiness
    # certificate cannot re-verify.
    doctored.excl_events.append((int(root), 0, np.inf))
    res = warm_rebuild(di_problem, di_cfg, doctored)
    assert (int(root), 0, np.inf) not in [
        (a, d, v) for a, d, v in res.tree.excl_events]
    assert res.stats["rebuild_reuse_frac"] == 1.0
    assert res.stats["rebuild_excl_events"] == \
        len(set((a, d) for a, d, _v in doctored.excl_events))


def test_rebuild_obs_counters_land_in_schema(di_problem, tight_cfg, prior):
    o = Obs("jsonl")
    res = warm_rebuild(di_problem, tight_cfg, prior.tree, obs=o)
    snap = o.metrics.snapshot()
    c, g = snap["counters"], snap["gauges"]
    st = res.stats
    assert c["rebuild.leaves_recertified"] == \
        st["rebuild_leaves_recertified"]
    assert c["rebuild.leaves_reused"] == st["rebuild_leaves_reused"]
    assert c["rebuild.leaves_invalidated"] == \
        st["rebuild_leaves_invalidated"]
    assert c["rebuild.recert_solves"] == st["recert_solves"]
    assert g["rebuild.reuse_frac"] == pytest.approx(
        st["rebuild_reuse_frac"], abs=1e-4)
    events = [r for r in o.sink.records
              if r.get("kind") == "event" and r.get("name") == "rebuild.sweep"]
    assert len(events) == 1
    o.close()


def test_priority_hint_orders_the_frontier_entry(di_problem, tight_cfg,
                                                 prior, tight_rebuild):
    """The demand hint reorders only the frontier's entry: the rebuilt
    tree keeps the same leaves and certificates."""
    invalid = [n for n in tight_rebuild.stats["rebuild_priority_order"]]
    hot = invalid[-1]
    res = warm_rebuild(di_problem, tight_cfg, prior.tree,
                       priority={hot: 5.0})
    assert res.stats["rebuild_priority_hint"] == 1
    assert res.stats["rebuild_priority_order"][0] == hot
    assert res.stats["regions"] == tight_rebuild.stats["regions"]
    assert res.stats["uncertified"] == 0


def test_sweep_fault_site_fires(di_problem, di_cfg, prior):
    plan = faults.FaultPlan(faults=(
        faults.FaultSpec(site="rebuild.sweep", kind="error"),))
    with faults.activate(plan) as inj:
        with pytest.raises(faults.InjectedFault):
            warm_rebuild(di_problem, di_cfg, prior.tree)
        inj.assert_all_fired()


def test_sweep_device_failure_on_cuda_raises_instead_of_cpu_fallback(
        di_problem, di_cfg, prior, monkeypatch):
    """On a CUDA oracle the sweep's oracle queries never fall back to the
    CPU: a failed query ends the rebuild with NoCpuFallback."""
    oracle = make_oracle(di_problem, di_cfg)

    def lost(*a, **kw):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(oracle, "simplex_feasibility", lost)
    monkeypatch.setattr(oracle, "solve_vertices", lost)
    monkeypatch.setattr(oracle, "device", torch.device("cuda", 0))
    with pytest.raises(device_lib.NoCpuFallback):
        warm_rebuild(di_problem, di_cfg, prior.tree, oracle=oracle)


# -- the CLI ------------------------------------------------------------------

_DI = ["-e", "double_integrator", "--problem-arg", "N=3", "--problem-arg",
       "theta_box=1.5", "--batch", "128", "--backend", "cpu"]


def test_rebuild_subcommand_requires_from():
    with pytest.raises(SystemExit, match="--from"):
        tmain.main(["rebuild", "-e", "double_integrator"])


def test_rebuild_and_resume_exclusive():
    with pytest.raises(SystemExit, match="exclusive"):
        tmain.main(["-e", "double_integrator", "--rebuild-from", "x.pkl",
                    "--resume", "y.pkl"])


@pytest.mark.parametrize("argv", [
    ["rebuild", *_DI, "--from", "PRIOR"],
    [*_DI, "--rebuild-from", "PRIOR", "--strict-provenance"]])
def test_rebuild_cli_config_is_the_jax_cli_config(argv, tmp_path,
                                                  monkeypatch):
    """The rebuild flags map field by field as the JAX CLI maps them
    (its config captured where it hands it to make_oracle)."""
    argv = [a.replace("PRIOR", str(tmp_path / "prior.tree.pkl"))
            for a in argv] + ["-o", str(tmp_path / "p")]

    class Captured(Exception):
        pass

    def capture(problem, cfg, *a, **kw):
        raise Captured(cfg)

    monkeypatch.setattr(jfrontier, "make_oracle", capture)
    with pytest.raises(Captured) as e:
        jmain.main(argv)
    ref = e.value.args[0]
    got = tmain.config_from_args(tmain.build_parser().parse_args(
        argv[1:] if argv[0] == "rebuild" else argv))
    assert got.rebuild_from == str(tmp_path / "prior.tree.pkl")
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(ref, f.name), f.name


def test_rebuild_cli_end_to_end(prior, tmp_path, capsys):
    """`main rebuild --from PRIOR` at the tightened eps writes the tree
    the library call gives, with the rebuild statistics."""
    path = str(tmp_path / "prior.tree.pkl")
    prior.tree.save(path)
    out = str(tmp_path / "tight")
    assert tmain.main(["rebuild", *_DI, "-a", str(EPS_TIGHT), "--from",
                       path, "-o", out, "--evaluate", "256"]) == 0
    st = json.load(open(out + ".stats.json"))
    assert st["subdivision_solves"] > 0 and st["uncertified"] == 0
    assert 0.0 < st["rebuild_reuse_frac"] < 1.0
    lib = warm_rebuild(make("double_integrator", **DI_ARGS),
                       PartitionConfig(problem="double_integrator",
                                       problem_args=tuple(
                                           sorted(DI_ARGS.items())),
                                       eps_a=EPS_TIGHT, backend="cpu",
                                       batch_simplices=128), path)
    assert _states_equal(Tree.load(out + ".tree.pkl"), lib.tree)
    # A prior that cannot transfer exits with the reason.
    with pytest.raises(SystemExit, match="rebuild: .*root triangulation"):
        tmain.main(["rebuild", "-e", "double_integrator", "--problem-arg",
                    "theta_box=2.0", "--backend", "cpu", "--from", path,
                    "-o", str(tmp_path / "bad")])

