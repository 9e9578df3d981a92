"""Chaos check: the tier-1 build under scripted fault schedules.

    python -m explicit_hybrid_mpc_tpu_torch.tools.chaos_suite
    python -m explicit_hybrid_mpc_tpu_torch.tools.chaos_suite \\
        --backend cpu --eps 0.5 --schedule device_failure

Runs the tier-1 double-integrator build (N=3, theta_box=1.5, eps 0.2,
64 simplices a batch) fault-free, then under five scripted fault
schedules, each build a child process under a hard time limit (a hung
child is a failure), and prints one verdict JSON on standard output.
It exits non-zero when any schedule fails, and a schedule whose
scripted fault never fired fails as vacuous.

1. ``device_failure``: dispatch and wait failures on the primary oracle
   mid-build.
2. ``solve_timeout``: a 4 s solve hang under ``--solve-timeout 1.5``.
3. ``kill_mid_checkpoint``: the process ``os._exit``s between checkpoint
   rotation and the atomic write (only ``.prev`` survives), under the
   build supervisor (tools/supervise_build.py), which resumes it.
4. ``sharded_device_failure``: a two-process sharded build
   (parallel/launch.py) with the fault plan in shard 1's environment
   only.
5. ``lifecycle_publish_crash``: the rebuild daemon (``main
   serve-rebuild``) dies between a delta artifact landing on disk and
   the registry swap.

Under ``--backend cpu`` every verdict is the JAX package's
(scripts/chaos_suite.py): a failed batch recovers on the CPU twin, so
each faulted tree is node for node the clean one, fully certified, with
0 quarantined cells; schedule 4's faulted shard degrades to its twin and
the merged tree is canonically the clean one; schedule 5 leaves
generation 0 the last committed generation, bitwise the fault-free
run's, and generation 1 without a commit marker.

Under ``--backend cuda`` (the default) a build never finishes on the
CPU: its first device failure ends it with ``device.NoCpuFallback``.
So there:

- schedules 1 and 2: the child exits non-zero (with
  ``device.NO_CPU_FALLBACK_EXIT``), its stderr names NoCpuFallback
  chained to the InjectedFault (1) or to the SolveTimeout (2), and no
  tree is written; the seconds from the fault to the process's exit are
  reported (schedule 2 within ``hang_s`` plus HANG_SLACK_S: the
  watchdog's thread, still asleep in the fault, must not hold the
  process);
- schedule 3: as on the CPU, node for node the clean card build's tree;
- schedule 4: shard 1 ends with NoCpuFallback, the launcher returns
  non-zero within the time limit, and what shard 0 did is reported
  (each shard waits ``--shard-timeout`` CARD_SHARD_TIMEOUT_S for a
  silent peer); no merged tree is claimed;
- schedule 5: the CPU's disk verdicts.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

from explicit_hybrid_mpc_tpu_torch import device as device_lib
from explicit_hybrid_mpc_tpu_torch.parallel.launch import MAIN, ROOT

#: The tier-1 chaos configuration (the JAX suite's): small enough that
#: a dozen builds stay a pre-merge check, deep enough that checkpoints,
#: pipeline lookahead and the dispatch path all run.
PROBLEM_ARGS = ["--problem-arg", "N=3", "--problem-arg", "theta_box=1.5"]
TIMEOUT_S = 900.0
#: Seconds past a hang's ``hang_s`` that a card build may take to exit
#: after the fault fired (schedule 2).
HANG_SLACK_S = 3.0
#: A card shard's wait for a silent peer (schedule 4): shard 1 is dead,
#: so shard 0's remote cells and its final merge wait this long each.
CARD_SHARD_TIMEOUT_S = 2.0

SCHEDULES: dict[str, dict] = {
    # A dead device mid-build: the 2nd primary dispatch raises, a wait
    # fails later -- under the degrade cap.
    "device_failure": {
        "faults": [
            {"site": "oracle.dispatch", "kind": "error", "at": 2,
             "match": "primary"},
            {"site": "oracle.wait", "kind": "error", "at": 5},
        ],
        "cause": "InjectedFault"},
    # A wedged solve: the 3rd wait hangs 4 s; --solve-timeout 1.5 cuts
    # it loose.
    "solve_timeout": {
        "extra_argv": ["--solve-timeout", "1.5"],
        "faults": [
            {"site": "oracle.wait", "kind": "hang", "at": 3,
             "hang_s": 4.0},
        ],
        "cause": "SolveTimeout"},
    # SIGKILL stand-in between checkpoint rotation and the atomic write
    # of the 2nd checkpoint; a supervised restart resumes from .prev.
    "kill_mid_checkpoint": {
        "supervised": True,
        "process_exit": True,
        "faults": [
            {"site": "checkpoint.write", "kind": "crash", "at": 2},
        ]},
    # The rebuild daemon dies between generation 1's delta artifact
    # landing on disk and the registry swap.
    "lifecycle_publish_crash": {
        "lifecycle": True,
        "process_exit": True,
        "faults": [
            {"site": "lifecycle.publish_delta", "kind": "crash",
             "at": 1},
        ]},
    # A dead device on shard 1 of a two-process sharded build only:
    # three failures trip the degrade cap on the CPU.
    "sharded_device_failure": {
        "sharded": True,
        "fault_shard": 1,
        "faults": [
            {"site": "oracle.dispatch", "kind": "error", "at": 2,
             "match": "primary"},
            {"site": "oracle.wait", "kind": "error", "at": 2},
            {"site": "oracle.wait", "kind": "error", "at": 4},
        ]},
}


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


def build_argv(out_prefix: str, eps: float, batch: int,
               backend: str) -> list[str]:
    return ["-e", "double_integrator", "-a", str(eps), "--backend",
            backend, "--batch", str(batch), *PROBLEM_ARGS,
            "--checkpoint-every", "4", "-o", out_prefix]


def _tail(path: str, n: int = 20_000) -> str:
    with open(path, "rb") as f:
        f.seek(0, os.SEEK_END)
        f.seek(max(0, f.tell() - n))
        return f.read().decode("utf-8", errors="replace")


def run_build(out_prefix: str, argv: list[str],
              plan_path: str | None = None,
              timeout_s: float = TIMEOUT_S,
              entry: list[str] | None = None) -> dict:
    """One child process ``<entry> <argv>`` (entry: ``python -m
    explicit_hybrid_mpc_tpu_torch.main``), its stderr to
    ``<out_prefix>.stderr``; returns {rc, wall_s, hung, t_exit, stderr
    (the tail)}."""
    env = _env()
    if plan_path is not None:
        env["EHM_FAULT_PLAN"] = plan_path
    err_path = out_prefix + ".stderr"
    t0 = time.perf_counter()
    with open(err_path, "wb") as err:
        try:
            rc = subprocess.call(list(entry or MAIN) + argv, env=env,
                                 cwd=ROOT, stdout=subprocess.DEVNULL,
                                 stderr=err, timeout=timeout_s)
            hung = False
        except subprocess.TimeoutExpired:
            rc, hung = -9, True
    return {"rc": rc, "wall_s": time.perf_counter() - t0, "hung": hung,
            "t_exit": time.time(), "stderr": _tail(err_path)}


def exception_chain(stderr: str) -> list[str]:
    """The exception class names of the last traceback in `stderr`, the
    first cause first (Python prints a chain cause before effect)."""
    start = stderr.rfind("Traceback (most recent call last):")
    names = []
    # A chain's earlier tracebacks come before the last "Traceback"
    # line; walk back over "direct cause" separators.
    while start > 0:
        prev = stderr.rfind("Traceback (most recent call last):", 0, start)
        if prev < 0 or "The above exception was the direct cause" \
                not in stderr[prev:start]:
            break
        start = prev
    for ln in stderr[max(start, 0):].splitlines():
        m = re.match(r"^([A-Za-z_][\w.]*)(?::|$)", ln)
        if m and not ln.startswith(("Traceback", "The above", "During")):
            names.append(m.group(1).rsplit(".", 1)[-1])
    return names


def fault_wall(obs_path: str) -> float | None:
    """Wall time at which the first scripted fault fired, from a child's
    obs stream (its identity record anchors stream time to the wall)."""
    from explicit_hybrid_mpc_tpu_torch.obs import clock
    from explicit_hybrid_mpc_tpu_torch.obs.sink import load_jsonl

    if not os.path.exists(obs_path):
        return None
    recs = load_jsonl(obs_path)
    ident = next((r for r in recs if r.get("kind") == "meta"
                  and r.get("name") == "stream"), None)
    ev = next((r for r in recs if r.get("name") == "faults.injected"),
              None)
    if ident is None or ev is None:
        return None
    return clock.to_wall(ident, ev["t"])


def compare_trees(ref_path: str, cand_path: str) -> list[str]:
    """Node-for-node divergence list ([] = identical): node count,
    vertex matrices bitwise, converged-leaf set, per-leaf payloads
    (delta, U, V) bitwise, region count, max depth."""
    import numpy as np

    from explicit_hybrid_mpc_tpu_torch.partition.tree import Tree

    a, b = Tree.load(ref_path), Tree.load(cand_path)
    diffs: list[str] = []
    if len(a) != len(b):
        return [f"node count {len(a)} != {len(b)}"]
    if not np.array_equal(a.vertices, b.vertices):
        diffs.append("vertex matrices differ")
    ia, ib = a.converged_leaf_ids(), b.converged_leaf_ids()
    if not np.array_equal(ia, ib):
        diffs.append(f"converged leaf sets differ "
                     f"({ia.size} vs {ib.size})")
        return diffs
    da, Ua, Va = a.leaf_payloads(ia)
    db, Ub, Vb = b.leaf_payloads(ib)
    if not np.array_equal(da, db):
        diffs.append("leaf commutations differ")
    if not np.array_equal(Ua, Ub):
        diffs.append("leaf vertex-input payloads differ")
    if not np.array_equal(Va, Vb):
        diffs.append("leaf vertex-cost payloads differ")
    if a.n_regions() != b.n_regions():
        diffs.append(f"regions {a.n_regions()} != {b.n_regions()}")
    if a.max_depth() != b.max_depth():
        diffs.append(f"max depth {a.max_depth()} != {b.max_depth()}")
    return diffs


def compare_trees_canonical_paths(ref_path: str, cand_path: str,
                                  payloads: bool = False) -> list[str]:
    """partition/shard.py's canonical (insertion-order independent)
    comparison over two tree pickles: the bar for sharded candidates."""
    from explicit_hybrid_mpc_tpu_torch.partition.shard import (
        compare_trees_canonical)
    from explicit_hybrid_mpc_tpu_torch.partition.tree import Tree

    return compare_trees_canonical(Tree.load(ref_path),
                                   Tree.load(cand_path), payloads=payloads)


def compare_artifact_dirs(a: str, b: str) -> list[str]:
    """Bitwise divergence list between two published serving artifact
    directories (leaf-table fields + descent arrays)."""
    import numpy as np

    diffs: list[str] = []
    for k in ("bary_M", "U", "V", "delta", "node_id"):
        xa = np.load(os.path.join(a, f"{k}.npy"))
        xb = np.load(os.path.join(b, f"{k}.npy"))
        if not np.array_equal(xa, xb):
            diffs.append(f"leaf field {k} differs")
    with np.load(os.path.join(a, "descent.npz")) as za, \
            np.load(os.path.join(b, "descent.npz")) as zb:
        for k in za.files:
            if not np.array_equal(za[k], zb[k]):
                diffs.append(f"descent {k} differs")
    return diffs


def _serve_rebuild_argv(artifacts_root: str, eps: float, batch: int,
                        backend: str) -> list[str]:
    return ["serve-rebuild", "-e", "double_integrator", *PROBLEM_ARGS,
            "-a", str(eps), "--backend", backend, "--batch", str(batch),
            "--controller", "di", "--revisions", "2",
            "--drift-frac", "0.05", "--artifacts-root", artifacts_root]


def _stats(prefix: str) -> dict:
    with open(prefix + ".stats.json") as f:
        return json.load(f)


def _write_plan(wd: str, name: str, spec: dict) -> str:
    path = os.path.join(wd, f"{name}.plan.json")
    with open(path, "w") as f:
        json.dump({"seed": 7, "process_exit": spec.get("process_exit",
                                                       False),
                   "faults": spec["faults"]}, f, indent=2)
    return path


def reference_build(wd: str, eps: float, batch: int, backend: str,
                    timeout_s: float = TIMEOUT_S,
                    entry: list[str] | None = None) -> dict:
    """The fault-free build every tree verdict is held to
    (``<wd>/base``); its row, with "failures"."""
    base = os.path.join(wd, "base")
    r = run_build(base, build_argv(base, eps, batch, backend),
                  timeout_s=timeout_s, entry=entry)
    r["failures"] = []
    if r["rc"] != 0 or r["hung"]:
        r["failures"].append(f"reference build failed (rc {r['rc']}, hung "
                             f"{r['hung']}): {r['stderr'][-500:]}")
        return r
    st = _stats(base)
    r["stats"] = {k: st.get(k) for k in ("regions", "uncertified",
                                         "quarantined_cells")}
    if st.get("uncertified", 0) != 0:
        r["failures"].append(
            f"reference build is not fully certified "
            f"({st['uncertified']} uncertified leaves): the chaos config "
            "must certify cleanly to be a parity anchor")
    return r


def run_lifecycle_schedule(wd: str, plan_path: str, eps: float,
                           batch: int, backend: str,
                           timeout_s: float = TIMEOUT_S,
                           entry: list[str] | None = None) -> dict:
    """Crash-mid-publish drill: a fault-free 2-revision daemon run (the
    reference) against one crashed by the plan between the delta write
    and the swap; verdicts on the surviving disk state."""
    art_ref = os.path.join(wd, "lc_ref")
    art_crash = os.path.join(wd, "lc_crash")
    t0 = time.perf_counter()
    ref = run_build(art_ref, _serve_rebuild_argv(art_ref, eps, batch,
                                                 backend),
                    timeout_s=timeout_s, entry=entry)
    r = run_build(art_crash, _serve_rebuild_argv(art_crash, eps, batch,
                                                 backend),
                  plan_path=plan_path, timeout_s=timeout_s, entry=entry)
    row = {"rc": r["rc"], "rc_ref": ref["rc"],
           "hung": r["hung"] or ref["hung"],
           "wall_s": time.perf_counter() - t0, "failures": []}
    if row["hung"] or ref["rc"] != 0:
        row["failures"].append(
            f"reference rc={ref['rc']}, a daemon hung={row['hung']}: "
            f"{ref['stderr'][-500:]}")
        return row
    if r["rc"] == 0:
        row["failures"].append(
            "crashed run exited 0: the scripted publish crash never "
            "fired (vacuous drill)")
        return row

    def _gens(root: str) -> dict[int, str]:
        d = os.path.join(root, "di")
        out = {}
        for name in (os.listdir(d) if os.path.isdir(d) else []):
            if name.startswith("g") and not name.endswith(".delta"):
                out[int(name[1:5])] = os.path.join(d, name)
        return out

    refg, crash = _gens(art_ref), _gens(art_crash)
    if 0 not in refg or 1 not in refg:
        row["failures"].append(f"reference run published {sorted(refg)}"
                               ", expected generations 0 and 1")
        return row
    if 0 not in crash:
        row["failures"].append("crashed run lost generation 0")
        return row
    row["gen1_committed"] = 1 in crash and os.path.exists(
        os.path.join(crash[1], "meta.json"))
    if row["gen1_committed"]:
        row["failures"].append(
            "crashed generation 1 carries a COMMIT MARKER: the crash "
            "site fired after the swap (window broken)")
    if not os.path.exists(os.path.join(crash[0], "meta.json")):
        row["failures"].append(
            "surviving generation 0 lost its commit marker")
    diffs = compare_artifact_dirs(refg[0], crash[0])
    row["tree_diffs"] = diffs
    if diffs:
        row["failures"].append(
            "surviving generation 0 diverged from the fault-free "
            "reference: " + "; ".join(diffs))
    return row


def _card_failure_verdict(spec: dict, prefix: str, r: dict,
                          row: dict) -> None:
    """Schedules 1 and 2 on the card: a non-zero exit naming
    NoCpuFallback chained to the scheduled cause, no tree written, and
    the process gone promptly after the fault."""
    chain = exception_chain(r["stderr"])
    row["exception_chain"] = chain
    row["tree_written"] = os.path.exists(prefix + ".tree.pkl")
    fw = fault_wall(prefix + ".obs.jsonl")
    row["exit_after_fault_s"] = None if fw is None else r["t_exit"] - fw
    f = row["failures"]
    if r["rc"] == 0:
        f.append("the card build exited 0: the scripted fault never "
                 "fired or was absorbed (vacuous, or a hidden fallback)")
        return
    if r["rc"] != device_lib.NO_CPU_FALLBACK_EXIT \
            or chain[-2:] != [spec["cause"], "NoCpuFallback"]:
        f.append(f"exit {r['rc']} with exception chain {chain}, expected "
                 f"{spec['cause']} -> NoCpuFallback (exit "
                 f"{device_lib.NO_CPU_FALLBACK_EXIT})")
    if row["tree_written"]:
        f.append("a tree was written at the prefix")
    if fw is None:
        f.append("no faults.injected event in the child's obs stream")
    hang = max((x.get("hang_s", 0.0) for x in spec["faults"]
                if x["kind"] == "hang"), default=0.0)
    if fw is not None and row["exit_after_fault_s"] > hang + HANG_SLACK_S:
        f.append(f"the process exited {row['exit_after_fault_s']:.2f} s "
                 f"after the fault (more than hang_s {hang} + "
                 f"{HANG_SLACK_S})")


def _card_sharded_verdict(spec: dict, r: dict, row: dict) -> None:
    """Schedule 4 on the card: the faulted shard ends with NoCpuFallback,
    the launcher returns non-zero within its limit; shard 0's outcome is
    reported, no merged tree claimed."""
    fs = spec.get("fault_shard", 1)
    rcs = r.get("rcs", [])
    row["fault_shard_chain"] = exception_chain(r["stderr"][fs])
    row["shard0"] = ("finished alone" if rcs and rcs[0] == 0
                     else "stopped" if rcs and rcs[0] is not None
                     else "killed by the launcher")
    row["shard0_tail"] = r["stderr"][0].strip().splitlines()[-1:] \
        if r["stderr"][0].strip() else []
    if r["rc"] == 0:
        row["failures"].append("the sharded card build exited 0: the "
                               "faulted shard did not end")
    if len(rcs) <= fs or rcs[fs] != device_lib.NO_CPU_FALLBACK_EXIT \
            or row["fault_shard_chain"][-1:] != ["NoCpuFallback"]:
        row["failures"].append(
            f"faulted shard {fs} exited {rcs[fs] if len(rcs) > fs else '?'}"
            f" with exception chain {row['fault_shard_chain']}, expected "
            "NoCpuFallback")


def run_schedule(name: str, wd: str, eps: float, batch: int,
                 backend: str, timeout_s: float = TIMEOUT_S,
                 entry: list[str] | None = None) -> dict:
    """One schedule against the reference build in `wd`
    (reference_build); its row, with "failures"."""
    spec = SCHEDULES[name]
    on_card = backend == "cuda"
    prefix = os.path.join(wd, name)
    base = os.path.join(wd, "base")
    plan_path = _write_plan(wd, name, spec)
    if spec.get("lifecycle"):
        row = run_lifecycle_schedule(wd, plan_path, eps, batch, backend,
                                     timeout_s, entry)
        if row["hung"]:
            row["failures"].append(f"daemon HUNG (> {timeout_s} s)")
        return row
    argv = build_argv(prefix, eps, batch, backend) \
        + spec.get("extra_argv", [])
    if spec.get("sharded"):
        from explicit_hybrid_mpc_tpu_torch.parallel.launch import (
            launch_sharded)

        argv += ["--no-speculate"]
        if on_card:
            argv += ["--shard-timeout", str(CARD_SHARD_TIMEOUT_S)]
        r = launch_sharded(
            argv, n_processes=2, timeout_s=timeout_s,
            env_extra_per_shard={spec["fault_shard"]:
                                 {"EHM_FAULT_PLAN": plan_path}},
            entry=entry, cwd=ROOT)
    elif spec.get("supervised"):
        from explicit_hybrid_mpc_tpu_torch.tools.supervise_build import (
            run_supervised)

        env = _env()
        env["EHM_FAULT_PLAN"] = plan_path
        t0 = time.perf_counter()
        with open(prefix + ".stderr", "wb") as err:
            sup = run_supervised(argv, prefix + ".ckpt.pkl",
                                 max_restarts=2, attempt_timeout_s=timeout_s,
                                 entry=entry, env=env,
                                 stdout=subprocess.DEVNULL, stderr=err)
        r = {"rc": sup["rc"], "wall_s": time.perf_counter() - t0,
             "hung": any(a["rc"] == -9 for a in sup["attempts"]),
             "supervise": sup, "stderr": _tail(prefix + ".stderr")}
    else:
        if on_card:
            # The child's obs stream dates the fault (exit_after_fault_s).
            argv += ["--obs", "jsonl"]
        r = run_build(prefix, argv, plan_path=plan_path,
                      timeout_s=timeout_s, entry=entry)
    row = {k: v for k, v in r.items()
           if k not in ("stderr", "stdout", "t_exit")}
    row["failures"] = f = []
    if r["hung"]:
        f.append(f"build HUNG (> {timeout_s} s)")
        return row
    if spec.get("supervised"):
        att = r["supervise"]["attempts"]
        if len(att) < 2 or att[0]["rc"] != 43:
            f.append(f"the scripted checkpoint crash never fired (attempt "
                     f"codes {[a['rc'] for a in att]}): vacuous")
        elif not (att[1]["resumed_from"] or "").endswith(".prev"):
            f.append(f"the restart resumed from {att[1]['resumed_from']}, "
                     "not the surviving .prev generation")
    if on_card and spec.get("sharded"):
        _card_sharded_verdict(spec, r, row)
        return row
    if on_card and "cause" in spec:
        _card_failure_verdict(spec, prefix, r, row)
        return row
    if r["rc"] != 0:
        tail = r.get("stderr", "")
        if spec.get("sharded"):
            tail = "\n".join(tail)
        f.append(f"build exited rc={r['rc']} {tail[-500:]}")
        return row
    st = _stats(prefix)
    row["stats"] = {k: st.get(k) for k in
                    ("regions", "uncertified", "quarantined_cells",
                     "device_failures", "device_degraded")}
    if not on_card and not spec.get("supervised") \
            and not st.get("device_failures"):
        f.append("no device failure recorded: the scripted faults never "
                 "fired (vacuous)")
    if st.get("quarantined_cells", 0) != 0:
        f.append(f"{st['quarantined_cells']} quarantined cell(s) -- an "
                 "injected fault ESCAPED recovery on the acceptance config")
    base_st = _stats(base)
    if st.get("uncertified", 0) != base_st.get("uncertified", 0):
        f.append(f"uncertified {st.get('uncertified')} != reference "
                 f"{base_st.get('uncertified')}")
    if spec.get("sharded"):
        fs = spec.get("fault_shard", 1)
        per = {s.get("shard"): s for s in st.get("per_shard", [])}
        row["per_shard"] = st.get("per_shard")
        if not per.get(fs, {}).get("device_degraded"):
            f.append(f"faulted shard {fs} did not degrade ({per.get(fs)})")
        for h in [s for s in per if s != fs]:
            if per[h].get("device_degraded") \
                    or per[h].get("quarantined_cells"):
                f.append(f"fault LEAKED to healthy shard {h} ({per[h]})")
        diffs = compare_trees_canonical_paths(base + ".tree.pkl",
                                              prefix + ".tree.pkl")
    else:
        diffs = compare_trees(base + ".tree.pkl", prefix + ".tree.pkl")
    row["tree_diffs"] = diffs
    if diffs:
        f.append("tree DIVERGED -- " + "; ".join(diffs))
    return row


def run_suite(wd: str, eps: float = 0.2, batch: int = 64,
              backend: str = "cuda", schedules=None,
              timeout_s: float = TIMEOUT_S,
              entry: list[str] | None = None, lanes: int = 1) -> dict:
    """The reference build, then each schedule (default all), `lanes` of
    them at a time (each its own processes and files; the schedules of
    several processes, the longest, start first); the verdict
    {"backend", "eps", "batch", "reference", "schedules", "failures"},
    in schedule order whatever order the lanes run them in."""
    from concurrent.futures import ThreadPoolExecutor

    names = list(schedules or SCHEDULES)
    verdict: dict = {"backend": backend, "eps": eps, "batch": batch,
                     "schedules": {}, "failures": []}
    print(f"chaos: fault-free reference build on {backend} (eps {eps}) "
          "...", file=sys.stderr)
    ref = reference_build(wd, eps, batch, backend, timeout_s, entry)
    verdict["reference"] = {k: v for k, v in ref.items()
                            if k not in ("stderr", "t_exit", "failures")}
    verdict["failures"] += ref["failures"]
    if ref["rc"] != 0 or ref["hung"]:
        return verdict

    def one(name: str) -> dict:
        print(f"chaos: schedule {name} ...", file=sys.stderr)
        row = run_schedule(name, wd, eps, batch, backend, timeout_s, entry)
        print(f"chaos: {name}: "
              + ("ok" if not row["failures"] else "FAILED: "
                 + "; ".join(row["failures"]))
              + f" ({row.get('wall_s', 0.0):.1f} s)", file=sys.stderr)
        return row

    def several(name: str) -> bool:
        spec = SCHEDULES[name]
        return bool(spec.get("sharded") or spec.get("lifecycle")
                    or spec.get("supervised"))
    with ThreadPoolExecutor(max(1, lanes)) as pool:
        started = {name: pool.submit(one, name) for name in
                   sorted(names, key=lambda n: not several(n))}
        rows = {name: f.result() for name, f in started.items()}
    for name in names:
        row = rows[name]
        verdict["schedules"][name] = {k: v for k, v in row.items()
                                      if k != "failures"}
        verdict["schedules"][name]["ok"] = not row["failures"]
        verdict["failures"] += [f"{name}: {m}" for m in row["failures"]]
    return verdict


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m explicit_hybrid_mpc_tpu_torch.tools.chaos_suite",
        description=__doc__.splitlines()[0])
    ap.add_argument("--backend", choices=("cuda", "cpu"), default="cuda",
                    help="where every build runs: 'cuda' (default; refuses "
                         "to start without a card) or 'cpu'")
    ap.add_argument("--eps", type=float, default=0.2,
                    help="eps_a of the chaos config (default 0.2, the "
                         "tier-1 build; raise for a quicker smoke)")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--schedule", action="append", default=[],
                    choices=sorted(SCHEDULES),
                    help="run only these schedules (repeatable; default "
                         "all)")
    ap.add_argument("--timeout", type=float, default=TIMEOUT_S,
                    metavar="S", help="per-build hang budget")
    ap.add_argument("--workdir", default=None,
                    help="keep the artifacts here instead of a temp dir")
    ap.add_argument("--json", dest="json_out", default=None,
                    help="also write the verdict here")
    args = ap.parse_args(argv)
    try:
        device_lib.resolve(args.backend)
    except RuntimeError as e:
        raise SystemExit(f"chaos_suite: {e}")
    wd = args.workdir or tempfile.mkdtemp(prefix="chaos_suite.")
    os.makedirs(wd, exist_ok=True)
    try:
        verdict = run_suite(wd, args.eps, args.batch, args.backend,
                            args.schedule or None, args.timeout)
    finally:
        if not args.workdir:
            shutil.rmtree(wd, ignore_errors=True)
    verdict["workdir"] = args.workdir
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(verdict, f, indent=2)
    print(json.dumps(verdict, default=str))
    if verdict["failures"]:
        print("CHAOS SUITE FAILED:\n  " + "\n  ".join(verdict["failures"]),
              file=sys.stderr)
        return 1
    print(f"CHAOS SUITE OK on {args.backend}: "
          f"{len(verdict['schedules'])} schedule(s)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
