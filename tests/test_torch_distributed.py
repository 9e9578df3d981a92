"""Torch port: multi-process scale-out (parallel/distributed.py and the
launcher) against the JAX package.

The JAX package's tests/test_distributed.py on the port: two processes
joined by torch.distributed (gloo, localhost) build the tier-1 double
integrator in lockstep with the vertex grid on the GLOBAL mesh (four CPU
entries a process), and each must give the single-process build -- the
JAX package's tree signature, and the port's counts; the staging
predicate on the JAX cases; staging on a mesh whose device order
interleaves the processes; a single-process round trip.  Then the
launcher runs the sharded build through the CLI.

The worker processes run this file (``python
tests/test_torch_distributed.py MODE OUT``, with RANK, WORLD_SIZE and
MASTER_ADDR / MASTER_PORT from the launcher's shard_env); they import
neither JAX nor the JAX package."""

import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

ARGS = (("N", 3), ("theta_box", 1.5))
CFG = dict(problem="double_integrator", eps_a=0.5, backend="cpu",
           batch_simplices=32, max_depth=20)
LOCAL = 4          # CPU mesh entries a process (the JAX workers' devices)
TIMEOUT_S = 300


def _digest(tree) -> str:
    """The tree signature of tests/test_torch_build.py as one hash, in
    canonical order (a merged sharded tree orders its nodes by shard
    subtree): vertex matrices bitwise, and each leaf's commutation and
    certified flag by its vertex bytes."""
    h = hashlib.sha256()
    for v in sorted(tree.vertices[n].tobytes() for n in range(len(tree))):
        h.update(v)
    for v, d, c in sorted((tree.vertices[n].tobytes(),
                           tree.leaf_data[n].delta_idx,
                           bool(tree.leaf_data[n].certified))
                          for n in tree.converged_leaves()):
        h.update(v + np.int64(d).tobytes() + bytes([c]))
    return h.hexdigest()


def _worker(mode: str, out: str) -> None:
    """One rank: 'build' = the lockstep mesh build; 'stage_permuted' =
    stage_batch on a mesh whose batch axis interleaves the ranks."""
    from explicit_hybrid_mpc_tpu_torch.parallel import distributed
    from explicit_hybrid_mpc_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    rank = distributed.init_distributed()
    n = distributed.process_count()
    try:
        if mode == "stage_permuted":
            ranks = [r for _ in range(LOCAL) for r in range(n)]
            mesh = make_mesh((LOCAL * n, 1), [torch.device("cpu")] * len(
                ranks), ranks=ranks)
            x = np.arange(16 * n * 3, dtype=np.float64).reshape(-1, 3)
            idx_map = distributed.addressable_indices_map(mesh, x.shape)
            block = distributed.local_contiguous_block(idx_map, x.shape)
            staged = distributed.stage_batch(mesh, x)
            ok = all(np.array_equal(staged[ij].numpy(), x[idx])
                     for ij, idx in idx_map.items())
            rec = {"rank": rank, "ok": ok, "contiguous_block": block,
                   "n_local_shards": len(idx_map)}
        else:
            from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
            from explicit_hybrid_mpc_tpu_torch.oracle.oracle import Oracle
            from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
                build_partition)
            from explicit_hybrid_mpc_tpu_torch.problems.registry import make

            prob = make("double_integrator", **dict(ARGS))
            mesh = distributed.global_mesh(
                local_devices=[torch.device("cpu")] * LOCAL)
            oracle = Oracle(prob, backend="cpu", mesh=mesh)
            res = build_partition(prob, PartitionConfig(
                problem_args=ARGS, **CFG), oracle=oracle)
            rec = {"rank": rank, "owner": distributed.is_frontier_owner(),
                   "mesh": [mesh.shape["batch"], mesh.shape["delta"]],
                   "multiprocess": mesh.multiprocess,
                   "digest": _digest(res.tree),
                   **{k: res.stats[k] for k in (
                       "regions", "tree_nodes", "max_depth",
                       "oracle_solves", "point_solves")}}
        with open(f"{out}.r{rank}.json", "w") as f:
            json.dump(rec, f)
    finally:
        distributed.shutdown()


def _run_workers(mode: str, tmp_path, n: int = 2) -> list:
    from explicit_hybrid_mpc_tpu_torch.parallel.launch import (free_port,
                                                               shard_env)

    port = free_port()
    out = str(tmp_path / mode)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), mode, out], cwd=ROOT,
        env=shard_env(os.environ, port, i, n, "test"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(n)]
    try:
        for p in procs:
            log, _ = p.communicate(timeout=TIMEOUT_S)
            assert p.returncode == 0, f"worker failed:\n{log[-3000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=60)
    recs = []
    for i in range(n):
        with open(f"{out}.r{i}.json") as f:
            recs.append(json.load(f))
    return recs


def test_two_process_build_matches_single_process(tmp_path):
    import explicit_hybrid_mpc_tpu  # noqa: F401  (enables x64)
    from explicit_hybrid_mpc_tpu.config import PartitionConfig as JaxCfg
    from explicit_hybrid_mpc_tpu.partition.frontier import (
        build_partition as jax_build)
    from explicit_hybrid_mpc_tpu.problems.registry import make as jax_make
    from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
    from explicit_hybrid_mpc_tpu_torch.oracle.oracle import Oracle
    from explicit_hybrid_mpc_tpu_torch.parallel.mesh import make_mesh
    from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
        build_partition)
    from explicit_hybrid_mpc_tpu_torch.problems.registry import make

    jref = jax_build(jax_make("double_integrator", **dict(ARGS)),
                     JaxCfg(problem_args=ARGS, **CFG))
    prob = make("double_integrator", **dict(ARGS))
    ref = build_partition(prob, PartitionConfig(problem_args=ARGS, **CFG),
                          oracle=Oracle(prob, backend="cpu", mesh=make_mesh(
                              (2 * LOCAL, 1), [torch.device("cpu")] * 8)))
    recs = _run_workers("build", tmp_path)
    assert [r["owner"] for r in recs] == [True, False]
    assert all(r["mesh"] == [2 * LOCAL, 1] and r["multiprocess"]
               for r in recs)
    # Both processes ran the frontier in lockstep: identical trees ...
    keys = ("regions", "tree_nodes", "max_depth", "oracle_solves",
            "point_solves", "digest")
    assert {k: recs[0][k] for k in keys} == {k: recs[1][k] for k in keys}
    # ... the single-process mesh build's, and the JAX package's tree.
    for k in keys[:-1]:
        assert recs[0][k] == ref.stats[k], k
    assert recs[0]["digest"] == _digest(ref.tree) == _digest(jref.tree)
    for k in ("regions", "tree_nodes", "max_depth"):
        assert recs[0][k] == jref.stats[k], k


def test_local_contiguous_block_predicate():
    """The staging fast-path predicate, on the JAX test's cases and
    against the JAX package's function."""
    from explicit_hybrid_mpc_tpu.parallel.distributed import (
        local_contiguous_block as jax_block)
    from explicit_hybrid_mpc_tpu_torch.parallel.distributed import (
        local_contiguous_block)

    shape = (8, 4)
    cases = {
        "ok": ({0: (slice(0, 2), slice(None)),
                1: (slice(2, 4), slice(None))}, (0, 4)),
        "full_stop": ({0: (slice(0, 4), slice(0, 4)),
                       1: (slice(4, 8), slice(0, 4))}, (0, 8)),
        # Interleaved local rows (permuted global device order).
        "gap": ({0: (slice(0, 2), slice(None)),
                 1: (slice(4, 6), slice(None))}, None),
        # Replicated blocks (the delta axis of one batch row) count once.
        "repl": ({0: (slice(0, 4), slice(None)),
                  1: (slice(0, 4), slice(None)),
                  2: (slice(4, 8), slice(None)),
                  3: (slice(4, 8), slice(None))}, (0, 8)),
        # Trailing-dim blocks are not dim-0 slices of the global array.
        "trailing": ({0: (slice(0, 8), slice(0, 2)),
                      1: (slice(0, 8), slice(2, 4))}, None),
        "ragged": ({0: (slice(0, 3), slice(None)),
                    1: (slice(3, 4), slice(None))}, None),
        "strided": ({0: (slice(0, 8, 2), slice(None))}, None),
        "empty": ({}, None),
    }
    for name, (idx_map, want) in cases.items():
        assert local_contiguous_block(idx_map, shape) == want, name
        assert jax_block(idx_map, shape) == want, name


def test_two_process_stage_batch_permuted_mesh(tmp_path):
    """A mesh whose batch axis interleaves the two processes gives each
    non-contiguous local rows: the one-slice fast path is refused
    (contiguous block None) and every entry still stages its exact
    rows."""
    for rec in _run_workers("stage_permuted", tmp_path):
        assert rec["ok"], rec
        assert rec["contiguous_block"] is None, rec
        assert rec["n_local_shards"] == LOCAL


def test_stage_batch_single_process_roundtrip():
    """stage_batch / stage_replicated on one process: the blocks
    reassemble to the host arrays."""
    from explicit_hybrid_mpc_tpu_torch.parallel import distributed
    from explicit_hybrid_mpc_tpu_torch.parallel.mesh import make_mesh

    assert distributed.init_distributed() == 0  # one process: no-op
    assert not distributed.initialized()
    mesh = make_mesh((4, 2), [torch.device("cpu")] * 8)
    x = np.arange(32, dtype=np.float64).reshape(8, 4)
    blocks = distributed.stage_batch(mesh, x)
    assert sorted(blocks) == sorted(np.ndindex(4, 2))
    back = np.concatenate([blocks[(i, 0)].numpy() for i in range(4)])
    np.testing.assert_array_equal(back, x)
    assert all(np.array_equal(blocks[(i, 0)].numpy(),
                              blocks[(i, 1)].numpy()) for i in range(4))
    m = np.arange(6) < 4
    rep = distributed.stage_replicated(mesh, m)
    np.testing.assert_array_equal(
        np.concatenate([rep[(0, j)].numpy() for j in range(2)]), m)
    assert distributed.process_coords()["process_count"] == 1
    assert distributed.is_frontier_owner()


def test_launcher_runs_the_sharded_cli_build(tmp_path):
    """The launcher's two `main --shard-frontier --obs jsonl` processes:
    the merged tree has the JAX package's single-process signature, the
    per-process streams' summed point solves are the single-process
    count, only rank 0 writes the outputs, each shard its own log."""
    import explicit_hybrid_mpc_tpu  # noqa: F401  (enables x64)
    from explicit_hybrid_mpc_tpu.config import PartitionConfig as JaxCfg
    from explicit_hybrid_mpc_tpu.partition.frontier import (
        build_partition as jax_build)
    from explicit_hybrid_mpc_tpu.problems.registry import make as jax_make
    from explicit_hybrid_mpc_tpu_torch.obs import fleet
    from explicit_hybrid_mpc_tpu_torch.parallel.launch import launch_sharded
    from explicit_hybrid_mpc_tpu_torch.partition.tree import Tree

    jref = jax_build(jax_make("double_integrator", **dict(ARGS)),
                     JaxCfg(problem_args=ARGS, **CFG))
    out = str(tmp_path / "di")
    r = launch_sharded(
        ["-e", "double_integrator", "--problem-arg", "N=3", "--problem-arg",
         "theta_box=1.5", "-a", "0.5", "--batch", "32", "--max-depth", "20",
         "--backend", "cpu", "--obs", "jsonl", "-o", out],
        n_processes=2, timeout_s=TIMEOUT_S, cwd=ROOT)
    assert r["rc"] == 0 and not r["hung"], r["stderr"]
    assert _digest(Tree.load(out + ".tree.pkl")) == _digest(jref.tree)
    with open(out + ".stats.json") as f:
        st = json.load(f)
    assert st["n_shards"] == 2 and st["shard_fallback_cells"] == 0
    assert st["regions"] == jref.stats["regions"]
    roll = fleet.fleet_rollup(fleet.load_fleet(out + ".obs.p*.jsonl"))
    assert roll["n_streams"] == 2
    assert roll["counters"]["oracle.point_solves"] \
        == jref.stats["point_solves"]
    assert os.path.exists(out + ".log.jsonl.p0")
    assert os.path.exists(out + ".log.jsonl.p1")
    assert os.path.isdir(out + ".shard")


def test_launcher_puts_a_fault_plan_in_one_shard(tmp_path):
    """env_extra_per_shard: a dead device scripted in shard 1 only (the
    JAX chaos suite's sharded_device_failure plan): shard 1 degrades to
    its CPU twin, shard 0 sees no failure, and the merged tree is still
    the single-process one."""
    from explicit_hybrid_mpc_tpu_torch.parallel.launch import launch_sharded
    from explicit_hybrid_mpc_tpu_torch.partition.tree import Tree

    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps({"faults": [
        {"site": "oracle.dispatch", "kind": "error", "at": 2,
         "match": "primary"},
        {"site": "oracle.wait", "kind": "error", "at": 2},
        {"site": "oracle.wait", "kind": "error", "at": 4}]}))
    out, plain = str(tmp_path / "f"), str(tmp_path / "plain")
    argv = ["-e", "double_integrator", "--problem-arg", "N=3",
            "--problem-arg", "theta_box=1.5", "-a", "0.5", "--batch", "32",
            "--max-depth", "20", "--backend", "cpu", "--no-speculate"]
    r = launch_sharded([*argv, "-o", out], n_processes=2,
                       timeout_s=TIMEOUT_S, cwd=ROOT,
                       env_extra_per_shard={1: {"EHM_FAULT_PLAN": str(plan)}})
    assert r["rc"] == 0, r["stderr"]
    with open(out + ".stats.json") as f:
        per = {s["shard"]: s for s in json.load(f)["per_shard"]}
    assert per[1]["device_degraded"] and not per[0]["device_degraded"]
    from explicit_hybrid_mpc_tpu_torch import main as tmain

    assert tmain.main([*argv, "-o", plain]) == 0
    assert _digest(Tree.load(out + ".tree.pkl")) \
        == _digest(Tree.load(plain + ".tree.pkl"))


def test_launcher_fails_when_a_shard_fails(tmp_path):
    from explicit_hybrid_mpc_tpu_torch.parallel.launch import main

    assert main(["-n", "2", "--timeout", "120", "--", "-e",
                 "no_such_problem", "--backend", "cpu", "-o",
                 str(tmp_path / "x")]) == 1


if __name__ == "__main__":
    _worker(sys.argv[1], sys.argv[2])
