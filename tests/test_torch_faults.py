"""Torch port: fault injection and crash-safe supervision against the
JAX package's tests/test_faults.py.

Each case of that file runs here on the port, and wherever both
packages have the function it runs on the JAX package too, on the same
inputs: plans round-trip between the two packages' JSON (the port-only
kind ``stall`` aside), one plan fires the same sequence in both
injectors, each package's checksummed pickle reads in the other and
fails in both after the same ``corrupt`` injection, the faulted CPU
builds equal the JAX package's clean build node for node (vertices
bitwise, leaf ids, the leaf payloads delta, U and V), and quarantine,
the degrade cap and the checkpoint generations give the JAX package's
stats and counters.  Not ported here: the obs_report faults block
(``obs_report`` is not ported) and the JAX bench script's history
append (the port's ``append_line_fsync`` is held below).

Trees are compared through their arrays, never by loading one
package's pickle with the other's Tree (a pickle names its package's
classes)."""

import json
import os
import pickle
import threading

import numpy as np
import pytest
import torch

import explicit_hybrid_mpc_tpu  # noqa: F401  (enables x64)
from explicit_hybrid_mpc_tpu import faults as jfaults
from explicit_hybrid_mpc_tpu import obs as jobs_lib
from explicit_hybrid_mpc_tpu.config import PartitionConfig as JaxConfig
from explicit_hybrid_mpc_tpu.partition import frontier as jfrontier
from explicit_hybrid_mpc_tpu.problems.registry import make as jax_make
from explicit_hybrid_mpc_tpu.utils import atomic as jatomic
from explicit_hybrid_mpc_tpu_torch import faults
from explicit_hybrid_mpc_tpu_torch import obs as obs_lib
from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
from explicit_hybrid_mpc_tpu_torch.faults import (FaultPlan, FaultSpec,
                                                  InjectedCrash,
                                                  InjectedFault)
from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
    FrontierEngine, build_partition, load_checkpoint, make_oracle)
from explicit_hybrid_mpc_tpu_torch.problems.registry import make
from explicit_hybrid_mpc_tpu_torch.utils import atomic

torch.set_num_threads(1)

CPU = [torch.device("cpu")]
DI_ARGS = {"N": 3, "theta_box": 1.5}
PEND_ARGS = {"N": 2}

#: Primary AND fallback scripted dead for one stage-2 call: the JAX
#: file's quarantine schedule.
QUARANTINE_PLAN = {"faults": [
    {"site": "oracle.call", "kind": "error", "at": 1},
    {"site": "oracle.fallback", "kind": "error", "at": 1, "count": 2}]}


@pytest.fixture(autouse=True)
def _no_leaked_injector():
    """Every test leaves both packages with no installed injector."""
    yield
    faults.clear()
    jfaults.clear()


def _cfg(**kw):
    base = dict(eps_a=0.5, backend="cpu", batch_simplices=32,
                oracle_retry_backoff_s=0.0)
    base.update(kw)
    return PartitionConfig(**base)


def _pend_cfg(**kw):
    return _cfg(problem="inverted_pendulum", max_depth=10, **kw)


def _jax_cfg(**kw):
    base = dict(eps_a=0.5, backend="cpu", batch_simplices=32,
                oracle_retry_backoff_s=0.0)
    base.update(kw)
    return JaxConfig(**base)


def _jax_pend_cfg(**kw):
    return _jax_cfg(problem="inverted_pendulum", max_depth=10, **kw)


@pytest.fixture(scope="module")
def di_problem():
    return make("double_integrator", **DI_ARGS)


@pytest.fixture(scope="module")
def pend_problem():
    return make("inverted_pendulum", **PEND_ARGS)


@pytest.fixture(scope="module")
def jax_di_problem():
    return jax_make("double_integrator", **DI_ARGS)


@pytest.fixture(scope="module")
def jax_pend_problem():
    return jax_make("inverted_pendulum", **PEND_ARGS)


@pytest.fixture(scope="module")
def di_clean(di_problem):
    return build_partition(di_problem, _cfg())


@pytest.fixture(scope="module")
def pend_clean(pend_problem):
    return build_partition(pend_problem, _pend_cfg())


@pytest.fixture(scope="module")
def jax_di_clean(jax_di_problem):
    return jfrontier.build_partition(jax_di_problem, _jax_cfg())


@pytest.fixture(scope="module")
def jax_pend_clean(jax_pend_problem):
    return jfrontier.build_partition(jax_pend_problem, _jax_pend_cfg())


def tree_arrays(tree) -> dict:
    """What the chaos comparison reads of a tree, as plain arrays."""
    ids = tree.converged_leaf_ids()
    delta, U, V = tree.leaf_payloads(ids)
    return {"vertices": np.asarray(tree.vertices), "leaf_ids": ids,
            "delta": np.asarray(delta), "U": np.asarray(U),
            "V": np.asarray(V)}


#: The leaf payloads' tolerance across the packages: the two run the
#: same arithmetic through different BLAS builds, so U and V agree to
#: the last bits only (within one package they are compared bitwise).
PAYLOAD_RTOL = 1e-12


def assert_same_tree(port_tree, jax_tree) -> None:
    """Vertices, converged leaf ids and commutations bitwise, U and V
    to PAYLOAD_RTOL relative."""
    a, b = tree_arrays(port_tree), tree_arrays(jax_tree)
    for k in a:
        assert a[k].shape == b[k].shape, k
        if k in ("U", "V"):
            np.testing.assert_allclose(a[k], b[k], rtol=PAYLOAD_RTOL,
                                       atol=PAYLOAD_RTOL, err_msg=k)
        else:
            assert np.array_equal(a[k], b[k]), k
    assert port_tree.n_regions() == jax_tree.n_regions()


def assert_port_tree_bitwise(a_tree, b_tree) -> None:
    """Two of the port's own trees: every array bitwise."""
    a, b = tree_arrays(a_tree), tree_arrays(b_tree)
    for k in a:
        assert np.array_equal(a[k], b[k]), k


# -- plan / injector -------------------------------------------------------

def test_plan_roundtrip_and_validation(tmp_path):
    plan = FaultPlan(faults=(
        {"site": "oracle.call", "kind": "error", "at": 3, "count": 2,
         "match": "simplex"},
        {"site": "checkpoint.write", "kind": "crash"},), seed=9,
        process_exit=True)
    p = tmp_path / "plan.json"
    plan.save(str(p))
    back = FaultPlan.from_json(str(p))
    assert back == plan
    # Both ways between the packages: the same JSON, the same plan.
    jplan = jfaults.FaultPlan.from_json(str(p))
    assert jplan.to_dict() == plan.to_dict()
    jp = tmp_path / "jplan.json"
    jplan.save(str(jp))
    assert FaultPlan.from_json(str(jp)) == plan
    # The port-only kind loads here and is refused there.
    stall = FaultPlan(faults=({"site": "oracle.wait", "kind": "stall"},))
    with pytest.raises(ValueError, match="unknown fault kind"):
        jfaults.FaultPlan.from_dict(stall.to_dict())
    with pytest.raises(ValueError, match="unknown fault site"):
        FaultSpec(site="nope", kind="error")
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultSpec(site="oracle.call", kind="explode")
    with pytest.raises(ValueError, match="at"):
        FaultSpec(site="oracle.call", kind="error", at=0)
    with pytest.raises(ValueError, match="unknown FaultPlan keys"):
        FaultPlan.from_dict({"surprise": 1})


def _firing_sequence(pkg, plan_dict) -> list:
    """(site, label, what happened) for a fixed call sequence."""
    calls = [("oracle.call", None), ("oracle.call", "solve_points"),
             ("oracle.call", "simplex_min"), ("oracle.wait", None),
             ("oracle.call", None), ("oracle.call", "simplex"),
             ("oracle.wait", "pairs"), ("oracle.wait", None)]
    out = []
    with pkg.activate(pkg.FaultPlan.from_dict(plan_dict)) as inj:
        for site, label in calls:
            try:
                pkg.fire(site, label=label)
                out.append((site, label, "ok"))
            except pkg.InjectedFault:
                out.append((site, label, "fault"))
        fired = list(inj.fired)
        counts = {s: inj.count(s) for s in ("oracle.call", "oracle.wait")}
    return out, fired, counts


def test_injector_deterministic_firing():
    plan = FaultPlan(faults=(
        {"site": "oracle.call", "kind": "error", "at": 2, "count": 2},))
    with faults.activate(plan) as inj:
        faults.fire("oracle.call")              # 1: no-op
        with pytest.raises(InjectedFault):
            faults.fire("oracle.call")          # 2: fires
        with pytest.raises(InjectedFault):
            faults.fire("oracle.call")          # 3: fires (count=2)
        faults.fire("oracle.call")              # 4: done
        faults.fire("oracle.wait")              # other site untouched
    assert inj.n_fired() == 2
    assert inj.count("oracle.call") == 4
    plan2 = FaultPlan(faults=(
        {"site": "oracle.call", "kind": "error", "match": "simplex"},))
    with faults.activate(plan2) as inj2:
        faults.fire("oracle.call", label="solve_points")  # no match
        with pytest.raises(AssertionError):
            inj2.assert_all_fired()
    # The same seeded plan fires the same sequence in both injectors.
    plan_d = {"seed": 3, "faults": [
        {"site": "oracle.call", "kind": "error", "at": 2, "count": 3,
         "match": "simplex"},
        {"site": "oracle.wait", "kind": "error", "at": 2}]}
    assert _firing_sequence(faults, plan_d) \
        == _firing_sequence(jfaults, plan_d)


def test_injector_crash_kinds():
    with faults.activate(FaultPlan(faults=(
            {"site": "build.step", "kind": "crash"},))):
        with pytest.raises(InjectedCrash):
            faults.fire("build.step")
    # InjectedCrash must NOT be swallowed by device-failure handlers
    assert not issubclass(InjectedCrash, (RuntimeError, OSError))
    assert issubclass(InjectedFault, RuntimeError)


def test_fire_is_noop_without_plan():
    faults.clear()
    faults.fire("oracle.call")  # must not raise
    assert faults.current() is None


# -- atomic utility --------------------------------------------------------

def test_atomic_write_and_checksummed_pickle(tmp_path):
    p = tmp_path / "obj.pkl"
    atomic.atomic_pickle(str(p), {"a": 1})
    obj, checked = atomic.read_checked_pickle(str(p))
    assert obj == {"a": 1} and checked
    # Each package reads the other's checksummed pickle.
    jp = tmp_path / "jobj.pkl"
    jatomic.atomic_pickle(str(jp), {"b": [1, 2.5]})
    assert atomic.read_checked_pickle(str(jp)) == ({"b": [1, 2.5]}, True)
    assert jatomic.read_checked_pickle(str(p)) == ({"a": 1}, True)
    assert p.read_bytes()[:9] == jp.read_bytes()[:9] == b"EHMCKSUM1"
    legacy = tmp_path / "legacy.pkl"
    legacy.write_bytes(pickle.dumps([1, 2]))
    obj, checked = atomic.read_checked_pickle(str(legacy))
    assert obj == [1, 2] and not checked
    data = p.read_bytes()
    p.write_bytes(data[:len(data) // 2])
    with pytest.raises(atomic.CorruptArtifact):
        atomic.read_checked_pickle(str(p))
    with pytest.raises(jatomic.CorruptArtifact):
        jatomic.read_checked_pickle(str(p))
    bad = bytearray(data)
    bad[5] ^= 0x40
    p.write_bytes(bytes(bad))
    with pytest.raises(atomic.CorruptArtifact, match="checksum"):
        atomic.read_checked_pickle(str(p))
    # The same `corrupt` injection, replayed by each package's injector
    # on a copy of one file, mangles the same bytes; both reject it.
    spec = {"faults": [{"site": "checkpoint.written", "kind": "corrupt",
                        "keep_frac": 0.6}], "seed": 11}
    mangled = []
    for pkg, name in ((faults, "port.pkl"), (jfaults, "jax.pkl")):
        q = tmp_path / name
        atomic.atomic_pickle(str(q), {"payload": list(range(200))})
        with pkg.activate(pkg.FaultPlan.from_dict(spec)):
            pkg.fire("checkpoint.written", path=str(q))
        mangled.append(q.read_bytes())
        for reader in (atomic, jatomic):
            with pytest.raises(reader.CorruptArtifact):
                reader.read_checked_pickle(str(q))
    assert mangled[0] == mangled[1]


def test_append_line_fsync(tmp_path):
    p = tmp_path / "h.jsonl"
    atomic.append_line_fsync(str(p), json.dumps({"x": 1}))
    atomic.append_line_fsync(str(p), json.dumps({"x": 2}) + "\n")
    rows = [json.loads(ln) for ln in p.read_text().splitlines()]
    assert rows == [{"x": 1}, {"x": 2}]
    jp = tmp_path / "j.jsonl"
    jatomic.append_line_fsync(str(jp), json.dumps({"x": 1}))
    jatomic.append_line_fsync(str(jp), json.dumps({"x": 2}) + "\n")
    assert jp.read_bytes() == p.read_bytes()


def test_atomic_write_leaves_no_tmp_on_error(tmp_path, monkeypatch):
    p = tmp_path / "x.bin"

    def boom(src, dst):
        raise OSError("disk on fire")

    monkeypatch.setattr(os, "replace", boom)
    with pytest.raises(OSError):
        atomic.atomic_write_bytes(str(p), b"data")
    assert list(tmp_path.iterdir()) == []  # tmp file cleaned up


# -- checkpoint generations + crash recovery -------------------------------

def _two_generations(eng, ck, first: int, second: int) -> None:
    for _ in range(first):
        eng.step()
    eng.save_checkpoint(ck)
    for _ in range(second):
        eng.step()
    eng.save_checkpoint(ck)          # rotates gen 1 -> .prev


def test_checkpoint_generation_fallback_and_resume_parity(
        tmp_path, pend_problem, pend_clean, jax_pend_problem,
        jax_pend_clean):
    resumed = {}
    for pkg, prob, cfg, name in (
            ("port", pend_problem, _pend_cfg(), "b"),
            ("jax", jax_pend_problem, _jax_pend_cfg(), "j")):
        fr = jfrontier if pkg == "jax" else None
        Engine = fr.FrontierEngine if fr else FrontierEngine
        mk = fr.make_oracle if fr else make_oracle
        load = fr.load_checkpoint if fr else load_checkpoint
        ck = str(tmp_path / f"{name}.ckpt.pkl")
        eng = Engine(prob, mk(prob, cfg), cfg)
        _two_generations(eng, ck, 3, 2)
        assert os.path.exists(ck + ".prev")
        # SIGKILL-mid-write stand-in: the primary is torn at an
        # arbitrary byte; the loader rejects it and falls back.
        with open(ck, "r+b") as f:
            f.truncate(os.path.getsize(ck) // 2)
        with pytest.warns(RuntimeWarning, match="previous generation"):
            snap = load(ck)
        assert snap["steps"] == 3
        eng2 = Engine.resume(snap, prob, mk(prob, cfg), cfg=cfg)
        while eng2.frontier:
            eng2.step()
        resumed[pkg] = eng2
    port, jax_ = resumed["port"], resumed["jax"]
    # The resumed-from-fallback build bit-matches the straight build,
    # and the JAX package's resumed and clean builds.
    assert_port_tree_bitwise(pend_clean.tree, port.tree)
    assert port.n_uncertified == pend_clean.stats["uncertified"] \
        == jax_.n_uncertified == jax_pend_clean.stats["uncertified"]
    assert_same_tree(port.tree, jax_pend_clean.tree)
    assert port.steps == jax_.steps


def test_checkpoint_both_generations_dead(tmp_path, pend_problem,
                                          jax_pend_problem):
    for prob, cfg, fr in ((pend_problem, _pend_cfg(), None),
                          (jax_pend_problem, _jax_pend_cfg(), jfrontier)):
        Engine = fr.FrontierEngine if fr else FrontierEngine
        mk = fr.make_oracle if fr else make_oracle
        load = fr.load_checkpoint if fr else load_checkpoint
        Corrupt = jatomic.CorruptArtifact if fr else atomic.CorruptArtifact
        ck = str(tmp_path / f"{'j' if fr else 'b'}.ckpt.pkl")
        eng = Engine(prob, mk(prob, cfg), cfg)
        eng.step()
        eng.save_checkpoint(ck)
        eng.save_checkpoint(ck)
        for p in (ck, ck + ".prev"):
            with open(p, "r+b") as f:
                f.truncate(16)
        with pytest.raises(Corrupt, match="no valid checkpoint generation"):
            load(ck)


def test_injected_kill_mid_checkpoint_inprocess(tmp_path, pend_problem,
                                                jax_pend_problem):
    """crash between rotation and write: the primary vanishes, .prev
    carries the previous generation, and the loader recovers -- in
    both packages, at the same step."""
    plan = {"faults": [{"site": "checkpoint.write", "kind": "crash"}]}
    steps = []
    for prob, cfg, pkg, fr in (
            (pend_problem, _pend_cfg(), faults, None),
            (jax_pend_problem, _jax_pend_cfg(), jfaults, jfrontier)):
        Engine = fr.FrontierEngine if fr else FrontierEngine
        mk = fr.make_oracle if fr else make_oracle
        load = fr.load_checkpoint if fr else load_checkpoint
        ck = str(tmp_path / f"{'j' if fr else 'b'}.ckpt.pkl")
        eng = Engine(prob, mk(prob, cfg), cfg)
        eng.step()
        eng.save_checkpoint(ck)
        eng.step()
        with pkg.activate(pkg.FaultPlan.from_dict(plan)):
            with pytest.raises(pkg.InjectedCrash):
                eng.save_checkpoint(ck)
        assert not os.path.exists(ck) and os.path.exists(ck + ".prev")
        with pytest.warns(RuntimeWarning, match="previous generation"):
            snap = load(ck)
        steps.append(snap["steps"])
    assert steps == [1, 1]


def test_checkpoint_corrupt_injection_rejected(tmp_path, pend_problem):
    cfg = _pend_cfg()
    ck = str(tmp_path / "b.ckpt.pkl")
    eng = FrontierEngine(pend_problem, make_oracle(pend_problem, cfg),
                         cfg)
    eng.step()
    with faults.activate(FaultPlan(faults=(
            {"site": "checkpoint.written", "kind": "corrupt",
             "keep_frac": 0.6},))) as inj:
        eng.save_checkpoint(ck)
    assert inj.n_fired("checkpoint.written") == 1
    with pytest.raises(atomic.CorruptArtifact):
        load_checkpoint(ck, fallback=False)
    # The JAX package's reader refuses the same file.
    with pytest.raises(jatomic.CorruptArtifact):
        jatomic.read_checked_pickle(ck)


# -- truncated artifacts ---------------------------------------------------

def test_truncated_artifact_rejected_registry_keeps_old(
        tmp_path, di_clean):
    from explicit_hybrid_mpc_tpu_torch.serve.registry import (
        ControllerRegistry, save_artifacts)

    d1 = str(tmp_path / "v1")
    d2 = str(tmp_path / "v2")
    save_artifacts(di_clean.tree, di_clean.roots, d1)
    save_artifacts(di_clean.tree, di_clean.roots, d2)
    reg = ControllerRegistry()
    v1 = reg.load_artifacts("ctl", "v1", d1, devices=CPU)
    with open(os.path.join(d2, "bary_M.npy"), "r+b") as f:
        f.truncate(os.path.getsize(os.path.join(d2, "bary_M.npy")) // 3)
    with pytest.raises(atomic.CorruptArtifact):
        reg.load_artifacts("ctl", "v2", d2, devices=CPU)
    assert reg.active_version("ctl") == "v1"
    with reg.lease("ctl") as ver:
        assert ver is v1


def test_artifact_checksum_verify(tmp_path, di_clean, jax_di_clean):
    from explicit_hybrid_mpc_tpu.online import export as jexport
    from explicit_hybrid_mpc_tpu_torch.online import export

    d = str(tmp_path / "t")
    jd = str(tmp_path / "jt")
    export.write_leaf_table(di_clean.tree, d)
    jexport.write_leaf_table(jax_di_clean.tree, jd)
    export.load_leaf_table(d, verify_checksum=True)  # clean passes
    # The two packages' tables of the same tree sum the same fields, and
    # the fields that hold no solved float (the payloads agree to the
    # last bits only, PAYLOAD_RTOL) to the same sums.
    with open(os.path.join(d, "meta.json")) as f, \
            open(os.path.join(jd, "meta.json")) as g:
        sums, jsums = json.load(f)["checksums"], json.load(g)["checksums"]
    assert sums.keys() == jsums.keys()
    for k in ("bary_M", "delta", "node_id"):
        assert sums[k] == jsums[k], k
    p = os.path.join(d, "V.npy")
    with open(p, "r+b") as f:
        f.seek(os.path.getsize(p) - 3)
        b = f.read(1)
        f.seek(os.path.getsize(p) - 3)
        f.write(bytes([b[0] ^ 1]))
    with pytest.raises(atomic.CorruptArtifact, match="sha256"):
        export.load_leaf_table(d, verify_checksum=True)


def test_artifact_meta_commit_marker_mismatch(tmp_path, di_clean):
    from explicit_hybrid_mpc_tpu_torch.online import export

    d = str(tmp_path / "t")
    export.write_leaf_table(di_clean.tree, d)
    meta_p = os.path.join(d, "meta.json")
    with open(meta_p) as f:
        meta = json.load(f)
    meta["n_leaves"] += 5  # stale commit marker vs arrays
    meta.pop("checksums", None)
    with open(meta_p, "w") as f:
        json.dump(meta, f)
    with pytest.raises(atomic.CorruptArtifact, match="meta.json"):
        export.load_leaf_table(d)


def test_corrupt_injection_on_artifact_written(tmp_path, di_clean):
    from explicit_hybrid_mpc_tpu_torch.online import export

    d = str(tmp_path / "t")
    with faults.activate(FaultPlan(faults=(
            {"site": "artifact.written", "kind": "corrupt",
             "keep_frac": 0.4},))) as inj:
        export.write_leaf_table(di_clean.tree, d)
    assert inj.n_fired() == 1
    with pytest.raises(atomic.CorruptArtifact):
        export.load_leaf_table(d)


def test_save_artifacts_commit_marker_ordering(tmp_path, di_clean,
                                               monkeypatch):
    """A crash between the leaf-table export and the descent write
    leaves an UNCOMMITTED directory (no meta.json)."""
    from explicit_hybrid_mpc_tpu_torch.online import descent as descent_mod
    from explicit_hybrid_mpc_tpu_torch.serve.registry import (
        ControllerRegistry, save_artifacts)

    d = str(tmp_path / "v")

    def boom(table, path):
        raise InjectedCrash("crash before descent landed")

    monkeypatch.setattr(descent_mod, "save_descent", boom)
    with pytest.raises(InjectedCrash):
        save_artifacts(di_clean.tree, di_clean.roots, d)
    assert not os.path.exists(os.path.join(d, "meta.json"))
    monkeypatch.undo()
    save_artifacts(di_clean.tree, di_clean.roots, d)
    reg = ControllerRegistry()
    assert reg.load_artifacts("ctl", "v1", d, devices=CPU).version == "v1"


def test_rebuild_rejects_corrupt_prior(tmp_path, di_clean, di_problem):
    from explicit_hybrid_mpc_tpu_torch.partition.rebuild import (
        RebuildError, warm_rebuild)

    p = str(tmp_path / "prior.tree.pkl")
    di_clean.tree.save(p)
    with open(p, "r+b") as f:
        f.truncate(os.path.getsize(p) // 2)
    with pytest.raises(RebuildError, match="integrity"):
        warm_rebuild(di_problem, _cfg(), p)


# -- retry / quarantine / degrade ------------------------------------------

def test_device_failure_recovery_tree_parity(di_problem, di_clean,
                                             jax_di_clean):
    plan = FaultPlan(faults=(
        {"site": "oracle.dispatch", "kind": "error", "at": 2,
         "match": "primary"},
        {"site": "oracle.wait", "kind": "error", "at": 4},))
    with faults.activate(plan) as inj:
        res = build_partition(di_problem, _cfg())
    inj.assert_all_fired()
    assert res.stats["device_failures"] == 2
    assert res.stats["quarantined_cells"] == 0
    assert_port_tree_bitwise(di_clean.tree, res.tree)
    assert_same_tree(res.tree, jax_di_clean.tree)


def test_solve_hang_timeout_recovery(di_problem, di_clean, jax_di_clean):
    plan = FaultPlan(faults=(
        {"site": "oracle.wait", "kind": "hang", "at": 2,
         "hang_s": 5.0},))
    with faults.activate(plan) as inj:
        res = build_partition(di_problem, _cfg(solve_timeout_s=0.5))
    inj.assert_all_fired()
    assert res.stats["device_failures"] == 1
    assert res.stats["quarantined_cells"] == 0
    assert_port_tree_bitwise(di_clean.tree, res.tree)
    assert_same_tree(res.tree, jax_di_clean.tree)


def _quarantine_stats(st: dict) -> dict:
    return {k: st[k] for k in (
        "quarantined_cells", "device_failures", "device_degraded",
        "truncated", "regions", "uncertified", "tree_nodes", "steps")}


def test_quarantine_on_exhausted_recovery(pend_problem, jax_pend_problem):
    """Primary AND fallback scripted dead for one stage-2 call: the
    cells quarantine, the build survives, and the result is the JAX
    package's (stats and tree)."""
    with faults.activate(FaultPlan.from_dict(QUARANTINE_PLAN)) as inj:
        res = build_partition(
            pend_problem, _pend_cfg(oracle_retry_attempts=2, obs="jsonl"))
    inj.assert_all_fired()
    with jfaults.activate(jfaults.FaultPlan.from_dict(QUARANTINE_PLAN)):
        ref = jfrontier.build_partition(
            jax_pend_problem,
            _jax_pend_cfg(oracle_retry_attempts=2, obs="jsonl"))
    assert res.stats["quarantined_cells"] > 0
    assert not res.stats["truncated"]
    assert _quarantine_stats(res.stats) == _quarantine_stats(ref.stats)
    assert_same_tree(res.tree, ref.tree)


def test_quarantine_emits_obs_counter(pend_problem, jax_pend_problem):
    obs = obs_lib.Obs("jsonl")
    with faults.activate(FaultPlan.from_dict(QUARANTINE_PLAN)):
        res = build_partition(
            pend_problem, _pend_cfg(oracle_retry_attempts=2), obs=obs)
    snap = obs.flush_metrics()
    assert snap["counters"]["build.quarantined_cells"] \
        == res.stats["quarantined_cells"]
    assert snap["counters"]["faults.injected"] >= 2
    names = [r.get("name") for r in obs.sink.records]
    assert "faults.quarantine" in names and "faults.injected" in names
    jobs = jobs_lib.Obs("jsonl")
    with jfaults.activate(jfaults.FaultPlan.from_dict(QUARANTINE_PLAN)):
        jfrontier.build_partition(
            jax_pend_problem, _jax_pend_cfg(oracle_retry_attempts=2),
            obs=jobs)
    jsnap = jobs.flush_metrics()
    for k in ("build.quarantined_cells", "faults.injected"):
        assert snap["counters"][k] == jsnap["counters"][k], k
    jnames = [r.get("name") for r in jobs.sink.records]
    for k in ("faults.quarantine", "faults.injected"):
        assert names.count(k) == jnames.count(k), k


def test_device_degrade_cap(pend_problem, pend_clean, jax_pend_problem):
    """A persistently failing device degrades the engine ONCE (cap +
    in-flight stragglers), not per-batch, the twin finishes the
    identical tree, and the counts are the JAX package's."""
    plan = {"faults": [{"site": "oracle.dispatch", "kind": "error",
                        "at": 1, "count": 100000, "match": "primary"}]}
    with faults.activate(FaultPlan.from_dict(plan)):
        res = build_partition(
            pend_problem, _pend_cfg(device_failure_cap=3))
    with jfaults.activate(jfaults.FaultPlan.from_dict(plan)):
        ref = jfrontier.build_partition(
            jax_pend_problem, _jax_pend_cfg(device_failure_cap=3))
    assert res.stats["device_degraded"]
    assert 3 <= res.stats["device_failures"] <= 3 + 5
    assert res.stats["quarantined_cells"] == 0
    assert_port_tree_bitwise(pend_clean.tree, res.tree)
    assert _quarantine_stats(res.stats) == _quarantine_stats(ref.stats)
    assert_same_tree(res.tree, ref.tree)


def test_retry_policy_validation():
    from explicit_hybrid_mpc_tpu.faults import RetryPolicy as JaxPolicy
    from explicit_hybrid_mpc_tpu_torch.faults import RetryPolicy

    with pytest.raises(ValueError):
        RetryPolicy(max_attempts=0)
    with pytest.raises(ValueError):
        RetryPolicy(solve_timeout_s=0)
    with pytest.raises(ValueError):
        PartitionConfig(eps_a=0.1, oracle_retry_attempts=0)
    with pytest.raises(ValueError):
        PartitionConfig(eps_a=0.1, solve_timeout_s=-1)
    assert RetryPolicy(backoff_s=0.1).backoff(2) == pytest.approx(0.4)
    cfg = _cfg(oracle_retry_attempts=4, solve_timeout_s=1.5,
               device_failure_cap=7)
    jcfg = _jax_cfg(oracle_retry_attempts=4, solve_timeout_s=1.5,
                    device_failure_cap=7)
    pol, jpol = RetryPolicy.from_config(cfg), JaxPolicy.from_config(jcfg)
    assert [pol.backoff(i) for i in range(4)] \
        == [jpol.backoff(i) for i in range(4)]
    assert pol.fallback_timeout() == jpol.fallback_timeout() == 12.0
    assert (pol.max_attempts, pol.device_failure_cap) \
        == (jpol.max_attempts, jpol.device_failure_cap) == (4, 7)


# -- serve: lease leak + publish atomicity ---------------------------------

def _dummy_server(di_clean, tmp_path, name):
    from explicit_hybrid_mpc_tpu_torch.serve.registry import save_artifacts

    d = str(tmp_path / name)
    save_artifacts(di_clean.tree, di_clean.roots, d)
    return d


def test_wait_retired_timeout_emits_lease_leak(tmp_path, di_clean):
    from explicit_hybrid_mpc_tpu_torch.obs.health import HealthMonitor
    from explicit_hybrid_mpc_tpu_torch.serve.registry import (
        ControllerRegistry)

    obs = obs_lib.Obs("jsonl")
    reg = ControllerRegistry(obs=obs)
    d = _dummy_server(di_clean, tmp_path, "v1")
    v1 = reg.load_artifacts("ctl", "v1", d, devices=CPU)
    # A thread that died holding a lease: enter without exiting.
    leak = reg.lease("ctl")
    leak.__enter__()
    reg.load_artifacts("ctl", "v2", d, devices=CPU)  # v1 retiring, pinned
    assert not reg.wait_retired(v1, timeout=0.05)
    ev = [r for r in obs.sink.records
          if r.get("name") == "health.lease_leak"]
    assert ev and ev[-1]["value"] == 1 and ev[-1]["severity"] == "warn"
    mon = HealthMonitor()
    mon.feed(ev[-1])
    assert mon.worst == "warn"
    leak.__exit__(None, None, None)
    assert reg.wait_retired(v1, timeout=1.0)


def test_publish_injection_leaves_registry_intact(tmp_path, di_clean):
    from explicit_hybrid_mpc_tpu_torch.serve.registry import (
        ControllerRegistry)

    reg = ControllerRegistry()
    d = _dummy_server(di_clean, tmp_path, "v1")
    reg.load_artifacts("ctl", "v1", d, devices=CPU)
    with faults.activate(FaultPlan(faults=(
            {"site": "registry.publish", "kind": "error"},))):
        with pytest.raises(InjectedFault):
            reg.load_artifacts("ctl", "v2", d, devices=CPU)
    assert reg.active_version("ctl") == "v1"
    with reg.lease("ctl") as ver:
        assert ver.version == "v1"


def test_scheduler_crash_mid_batch_releases_lease(tmp_path, di_clean):
    """An injected serve.batch crash inside the leased evaluation
    fails the tickets but NEVER pins the version."""
    from explicit_hybrid_mpc_tpu_torch.serve.registry import (
        ControllerRegistry)
    from explicit_hybrid_mpc_tpu_torch.serve.scheduler import (
        RequestScheduler)

    reg = ControllerRegistry()
    d = _dummy_server(di_clean, tmp_path, "v1")
    v1 = reg.load_artifacts("ctl", "v1", d, devices=CPU)
    sched = RequestScheduler(reg, "ctl", max_batch=8, max_wait_us=500.0)
    try:
        with faults.activate(FaultPlan(faults=(
                {"site": "serve.batch", "kind": "crash"},))):
            t = sched.submit(np.zeros(v1.server.root_bary.shape[-1] - 1))
            with pytest.raises(InjectedCrash):
                t.result(timeout=5.0)
        reg.load_artifacts("ctl", "v2", d, devices=CPU)
        assert reg.wait_retired(v1, timeout=5.0)  # drained, not pinned
    finally:
        sched.close()


# -- health rule + sink durability -----------------------------------------

def test_max_quarantine_frac_rule():
    from explicit_hybrid_mpc_tpu.obs.health import (
        HealthMonitor as JaxMonitor)
    from explicit_hybrid_mpc_tpu_torch.obs.health import HealthMonitor

    rec = {"kind": "metrics",
           "counters": {"build.quarantined_cells": 50,
                        "oracle.point_solves": 1000,
                        "oracle.simplex_solves": 0},
           "gauges": {}}
    mon = HealthMonitor({"max_quarantine_frac": 0.01,
                         "min_solves_for_rates": 100})
    ev = mon.feed(dict(rec))
    assert [e["name"] for e in ev] == ["health.quarantine"]
    assert mon.worst == "critical"
    jmon = JaxMonitor({"max_quarantine_frac": 0.01,
                       "min_solves_for_rates": 100})
    jev = jmon.feed(dict(rec))
    assert [(e["name"], e["severity"], e["value"]) for e in ev] \
        == [(e["name"], e["severity"], e["value"]) for e in jev]
    # volume gate: tiny runs never trip it
    mon2 = HealthMonitor({"max_quarantine_frac": 0.01,
                          "min_solves_for_rates": 2000})
    assert not mon2.feed({"kind": "metrics",
                          "counters": {"build.quarantined_cells": 5,
                                       "oracle.point_solves": 50},
                          "gauges": {}})
    # 0 disables
    mon3 = HealthMonitor({"max_quarantine_frac": 0,
                          "min_solves_for_rates": 10})
    assert not mon3.feed({"kind": "metrics",
                          "counters": {"build.quarantined_cells": 500,
                                       "oracle.point_solves": 100},
                          "gauges": {}})


def test_sink_fsync_every(tmp_path):
    from explicit_hybrid_mpc_tpu.obs.sink import load_jsonl as jload
    from explicit_hybrid_mpc_tpu_torch.obs.sink import JsonlSink, load_jsonl

    p = str(tmp_path / "s.jsonl")
    with JsonlSink(p, fsync_every=2) as s:
        for i in range(5):
            s.emit("event", "e", i=i)
    assert len(load_jsonl(p)) == 5
    assert [r.get("i") for r in jload(p)] == [0, 1, 2, 3, 4]


def test_tree_save_checksummed_load_rejects_corrupt(tmp_path, di_clean):
    from explicit_hybrid_mpc_tpu_torch.partition.tree import Tree

    p = str(tmp_path / "t.tree.pkl")
    di_clean.tree.save(p)
    t2 = Tree.load(p)
    assert np.array_equal(di_clean.tree.vertices, t2.vertices)
    # The JAX package's checksum reader accepts the port's file (it does
    # not unpickle it: the check comes first).
    with open(p, "rb") as f:
        assert f.read(9) == b"EHMCKSUM1"
    with open(p, "r+b") as f:
        f.truncate(os.path.getsize(p) - 7)
    with pytest.raises(atomic.CorruptArtifact):
        Tree.load(p)
    with pytest.raises(jatomic.CorruptArtifact):
        jatomic.read_checked_pickle(p)


def test_config_fault_plan_threading(tmp_path, di_problem, di_clean,
                                     jax_di_clean):
    """cfg.fault_plan (a path) installs the injector inside
    build_partition -- the CLI/EHM_FAULT_PLAN surface, minus the
    subprocess."""
    plan_p = str(tmp_path / "plan.json")
    FaultPlan(faults=(
        {"site": "oracle.wait", "kind": "error", "at": 1},)).save(plan_p)
    try:
        res = build_partition(di_problem, _cfg(fault_plan=plan_p))
    finally:
        faults.clear()
    assert res.stats["device_failures"] == 1
    assert_port_tree_bitwise(di_clean.tree, res.tree)
    assert_same_tree(res.tree, jax_di_clean.tree)


def test_concurrent_fire_thread_safety():
    plan = FaultPlan(faults=(
        {"site": "serve.batch", "kind": "error", "at": 500},))
    with faults.activate(plan) as inj:
        errs = []

        def worker():
            for _ in range(100):
                try:
                    faults.fire("serve.batch")
                except InjectedFault as e:
                    errs.append(e)

        ts = [threading.Thread(target=worker) for _ in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
            assert not t.is_alive()
        assert inj.count("serve.batch") == 800
        assert len(errs) == 1  # exactly the scripted occurrence
