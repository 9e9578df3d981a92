"""Local launcher of a sharded build: N processes of the build CLI, one
per shard (the counterpart of the JAX package's scripts/shard_launch.py).

    python -m explicit_hybrid_mpc_tpu_torch.parallel.launch -n 2 -- \\
        -e inverted_pendulum -a 1e-2 -o build/pend2

spawns N ``python -m explicit_hybrid_mpc_tpu_torch.main <argv>
--shard-frontier`` processes with the environment torch.distributed
reads (``MASTER_ADDR`` / ``MASTER_PORT`` on localhost, ``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``) and one ``EHM_RUN_ID``, so their per-process
obs streams join as one fleet (obs/fleet.py).  Every shard runs on the
device the build flags name: several shards on one card time-slice it.
``launch_sharded(..., env_extra_per_shard={i: {...}})`` gives one shard
an environment of its own (a fault plan in that shard only).  The
launcher waits for all of them within ``--timeout`` and exits non-zero
when any shard fails or the time runs out (then it kills them all).
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import tempfile
import time

#: The directory that holds the package (put on the shards' PYTHONPATH).
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

MAIN = [sys.executable, "-m", "explicit_hybrid_mpc_tpu_torch.main"]


def free_port() -> int:
    """A TCP port on localhost that is free now."""
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def shard_env(base: dict, port: int, rank: int, n: int,
              run_id: str) -> dict:
    """Environment of shard `rank` of `n` rendezvousing on localhost
    `port`."""
    env = dict(base)
    # Append to PYTHONPATH, never replace it.
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
               WORLD_SIZE=str(n), RANK=str(rank), LOCAL_RANK=str(rank),
               EHM_RUN_ID=run_id)
    return env


def _tail(f, n: int = 4000) -> str:
    f.seek(0, os.SEEK_END)
    size = f.tell()
    f.seek(max(0, size - n))
    return f.read().decode("utf-8", errors="replace")


def launch_sharded(build_argv: list[str], n_processes: int = 2,
                   timeout_s: float = 900.0,
                   env_extra_per_shard: dict | None = None,
                   entry: list[str] | None = None,
                   cwd: str | None = None) -> dict:
    """Run ``<entry> <build_argv> --shard-frontier`` as `n_processes`
    shards and wait for all of them; returns {"rc": 0 or the worst
    non-zero rc, "rcs": [...], "wall_s": float, "hung": bool,
    "stdout": [tails], "stderr": [tails]}.

    `entry` is the command before the build flags (default: ``python
    -m explicit_hybrid_mpc_tpu_torch.main``); a caller that wraps the
    CLI (to count launches, say) passes its own."""
    from explicit_hybrid_mpc_tpu_torch.obs import clock

    port = free_port()
    argv = list(build_argv)
    if "--shard-frontier" not in argv:
        argv.append("--shard-frontier")
    run_id = os.environ.get(clock.RUN_ID_ENV) or clock.new_run_id()
    procs, files = [], []
    t0 = time.time()
    try:
        for i in range(n_processes):
            env = shard_env(os.environ, port, i, n_processes, run_id)
            env.update((env_extra_per_shard or {}).get(i, {}))
            # Output to files, never pipes: a shard not yet waited for
            # that filled a pipe would block mid-write, stop serving
            # the exchange, and stall every shard until the timeout.
            out, err = (tempfile.TemporaryFile(mode="w+b")
                        for _ in range(2))
            files.append((out, err))
            procs.append(subprocess.Popen(
                list(entry or MAIN) + argv, cwd=cwd or os.getcwd(),
                env=env, stdout=out, stderr=err))
        rcs, hung = [], False
        for p in procs:
            left = max(1.0, timeout_s - (time.time() - t0))
            try:
                rcs.append(p.wait(timeout=left))
            except subprocess.TimeoutExpired:
                hung = True
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)
    if hung:
        rcs = [p.returncode for p in procs]
    outs = [_tail(o) for o, _e in files]
    errs = [_tail(e) for _o, e in files]
    for o, e in files:
        o.close()
        e.close()
    bad = [abs(r) for r in rcs if r]
    return {"rc": max(bad) if bad else 0, "rcs": rcs,
            "wall_s": time.time() - t0, "hung": hung, "stdout": outs,
            "stderr": errs}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m explicit_hybrid_mpc_tpu_torch.parallel.launch",
        description=__doc__.splitlines()[0])
    ap.add_argument("-n", "--processes", type=int, default=2)
    ap.add_argument("--timeout", type=float, default=900.0)
    ap.add_argument("build_argv", nargs=argparse.REMAINDER,
                    help="the build flags of main, after --")
    args = ap.parse_args(argv)
    build = [a for a in args.build_argv if a != "--"]
    if not build:
        ap.error("pass the build flags of main after --")
    r = launch_sharded(build, n_processes=args.processes,
                       timeout_s=args.timeout)
    for i, tail in enumerate(r["stderr"]):
        if r["rcs"][i] != 0:
            print(f"--- shard {i} (rc {r['rcs'][i]}) ---\n{tail}",
                  file=sys.stderr)
    print(f"sharded launch: rcs={r['rcs']} wall={r['wall_s']:.2f}s "
          f"hung={r['hung']}", file=sys.stderr)
    return 0 if r["rc"] == 0 and not r["hung"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
