"""Crash-safe build supervisor: run a build, restart it from the newest
valid checkpoint generation until it finishes.

    python -m explicit_hybrid_mpc_tpu_torch.tools.supervise_build \\
        [--max-restarts N] [--attempt-timeout S] [--keep-fault-plan] \\
        [--ckpt PATH] [--summary PATH] -- \\
        -e inverted_pendulum -a 1e-2 --checkpoint-every 20 -o build/pend

Everything after ``--`` is the build argv of ``python -m
explicit_hybrid_mpc_tpu_torch.main``.  The supervisor:

1. runs the build as a child process;
2. on a non-zero exit restarts it with ``--resume`` at the newest
   generation whose checksum holds (``<prefix>.ckpt.pkl``, else its
   ``.prev``), or cold when neither does;
3. bounds the restarts (``--max-restarts``, default 3);
4. writes a summary JSON (restarts, each attempt's exit code and wall,
   the final code) next to the output, ``<prefix>.supervise.json``.

Every attempt shares one ``EHM_RUN_ID`` (obs/clock.py), so their obs
streams join as one run.  A child that inherits ``EHM_FAULT_PLAN``
replays its faults once: after the first crash the plan is stripped
from the children's environment (``--keep-fault-plan`` keeps it),
because injection counters restart with each process and a re-armed
crash-at-checkpoint-K plan would kill every restart at the same K.

A child that ends with ``device.NoCpuFallback`` (exit code
``device.NO_CPU_FALLBACK_EXIT``: a build asked for the card lost its
device) is not restarted: a restart cannot mend a dead device, and the
build never finishes on the CPU instead.  That exit is final and the
restart count stays 0 for it.  (The JAX package's supervisor has no
such case: its builds recover on the CPU twin.)

The supervisor itself follows the build argv's ``--backend`` (default
cuda): without a card it refuses to start a cuda build.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

from explicit_hybrid_mpc_tpu_torch import device as device_lib
from explicit_hybrid_mpc_tpu_torch.obs import clock
from explicit_hybrid_mpc_tpu_torch.parallel.launch import MAIN, ROOT
from explicit_hybrid_mpc_tpu_torch.utils import atomic


def argv_value(argv: list[str], *names: str) -> str | None:
    """The value of the first of `names` in a build argv (``--flag
    value`` and ``--flag=value`` both)."""
    for i, a in enumerate(argv):
        for n in names:
            if a == n and i + 1 < len(argv):
                return argv[i + 1]
            if a.startswith(n + "="):
                return a.split("=", 1)[1]
    return None


def intact(path: str, chunk: int = 1 << 20) -> bool:
    """Whether the checkpoint file at `path` exists and its content
    checksum holds (streamed: the file is hashed, never unpickled).  A
    file without the checksum header (written before the format) counts
    as intact: the child's loader is its only judge."""
    try:
        with open(path, "rb") as f:
            head = f.read(len(atomic.CHECKSUM_MAGIC))
            if head != atomic.CHECKSUM_MAGIC:
                return True
            digest = f.read(32)
            h = hashlib.sha256()
            while True:
                b = f.read(chunk)
                if not b:
                    break
                h.update(b)
    except OSError:
        return False
    return h.digest() == digest


def latest_checkpoint(ckpt: str) -> str | None:
    """The newest intact generation on disk: `ckpt`, else its ``.prev``,
    else None (the restart is cold)."""
    for p in (ckpt, ckpt + ".prev"):
        if intact(p):
            return p
    return None


def run_supervised(build_argv: list[str], ckpt: str,
                   max_restarts: int = 3, keep_fault_plan: bool = False,
                   attempt_timeout_s: float | None = None,
                   entry: list[str] | None = None,
                   env: dict | None = None, stdout=None,
                   stderr=None) -> dict:
    """Run the build to completion under supervision; returns the summary
    {"rc", "restarts", "attempts", "checkpoint", "final"}: "final" names
    why the last attempt ended the run ("ok", "no_cpu_fallback",
    "restarts_exhausted").  `entry` is the command before the build argv
    (default ``python -m explicit_hybrid_mpc_tpu_torch.main``); `env` the
    children's environment (default this process's); `stdout` and
    `stderr` where the children write (default this process's)."""
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    # An id an outer launcher already exported wins.
    env.setdefault(clock.RUN_ID_ENV, clock.new_run_id())
    attempts: list[dict] = []
    rc, final = -1, "restarts_exhausted"
    for attempt in range(max_restarts + 1):
        argv = list(build_argv)
        resumed = None
        if attempt > 0:
            resumed = latest_checkpoint(ckpt)
            if resumed and "--resume" not in argv:
                argv += ["--resume", resumed]
            if not keep_fault_plan:
                env.pop("EHM_FAULT_PLAN", None)
        t0 = time.perf_counter()
        try:
            rc = subprocess.call(list(entry or MAIN) + argv, env=env,
                                 cwd=ROOT, stdout=stdout, stderr=stderr,
                                 timeout=attempt_timeout_s)
        except subprocess.TimeoutExpired:
            rc = -9
            print(f"supervise: attempt {attempt} timed out after "
                  f"{attempt_timeout_s} s (killed)", file=sys.stderr)
        attempts.append({"attempt": attempt, "rc": rc,
                         "resumed_from": resumed,
                         "wall_s": time.perf_counter() - t0})
        if rc == 0:
            final = "ok"
            break
        if rc == device_lib.NO_CPU_FALLBACK_EXIT:
            final = "no_cpu_fallback"
            print(f"supervise: attempt {attempt} lost its device "
                  "(NoCpuFallback); a restart cannot mend that, giving up",
                  file=sys.stderr)
            break
        print(f"supervise: attempt {attempt} exited rc={rc}; "
              f"{'restarting' if attempt < max_restarts else 'giving up'}"
              f" ({max_restarts - attempt} restart(s) left)",
              file=sys.stderr)
    return {"rc": rc, "restarts": len(attempts) - 1, "attempts": attempts,
            "checkpoint": ckpt, "final": final}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m explicit_hybrid_mpc_tpu_torch.tools.supervise_build",
        description=__doc__.splitlines()[0],
        usage="%(prog)s [options] -- <main build argv>")
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint path (default: <output>.ckpt.pkl from "
                         "the build argv's -o)")
    ap.add_argument("--attempt-timeout", type=float, default=None,
                    metavar="S",
                    help="kill an attempt that runs longer (the summary "
                         "records rc=-9)")
    ap.add_argument("--keep-fault-plan", action="store_true",
                    help="keep EHM_FAULT_PLAN in restarted children "
                         "(default: stripped after the first crash)")
    ap.add_argument("--summary", default=None,
                    help="summary JSON path (default: "
                         "<output>.supervise.json)")
    if argv is None:
        argv = sys.argv[1:]
    if "--" not in argv:
        ap.error("separate the supervisor's flags from the build argv "
                 "with --")
    split = argv.index("--")
    args = ap.parse_args(argv[:split])
    build_argv = argv[split + 1:]
    if not build_argv:
        ap.error("empty build argv after --")
    backend = argv_value(build_argv, "--backend") or "cuda"
    try:
        device_lib.resolve("cpu" if backend == "serial" else backend)
    except RuntimeError as e:
        raise SystemExit(f"supervise_build: {e}")
    prefix = argv_value(build_argv, "-o", "--output") or "partition"
    ckpt = args.ckpt or f"{prefix}.ckpt.pkl"
    if argv_value(build_argv, "--checkpoint-every") is None:
        print("supervise: WARNING -- the build argv has no "
              "--checkpoint-every; a crash restarts from scratch",
              file=sys.stderr)
    summary = run_supervised(build_argv, ckpt,
                             max_restarts=args.max_restarts,
                             keep_fault_plan=args.keep_fault_plan,
                             attempt_timeout_s=args.attempt_timeout)
    out = args.summary or f"{prefix}.supervise.json"
    with open(out, "w") as f:
        json.dump(summary, f, indent=2)
    print(f"supervise: rc={summary['rc']} after {summary['restarts']} "
          f"restart(s), {summary['final']}; summary -> {out}",
          file=sys.stderr)
    return 0 if summary["rc"] == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
