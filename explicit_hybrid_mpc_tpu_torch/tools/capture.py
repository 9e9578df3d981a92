"""Helpers shared by the capture tools (precision_check, tune_schedule,
onset_probe, long_build): the JAX package's bench.py helpers of the same
names, kept here so that no tool of the port imports bench.py.

- ``log``: a line to standard error, flushed.
- ``choose_device``: where a capture runs.  ``cuda`` (the default) is
  the first CUDA device and refuses to start without one; ``cpu`` only
  when asked for, by ``--backend cpu`` or ``BENCH_PLATFORM=cpu``.  There
  is no probe and no fallback to the CPU (bench.py's ``choose_backend``
  probes the TPU in a subprocess and falls back to the CPU).  On the
  card the result also names the card and its power limit.
- ``default_precision``: on the CPU the JAX rule (the problem's
  ``cpu_precision_hint``, else ``"mixed"``); on the card ``"f64"``, the
  port's ``PartitionConfig.precision`` default.
- ``card_fault``: a kernel error, a ``NoCpuFallback`` or a CUDA error:
  the failures a tool on the card reports and never skips or counts.
- ``retry_transient``: bench.py's retry of transient device errors,
  except that a kernel error, a ``NoCpuFallback`` and a CUDA error are
  raised at once: a dead card does not come back in 20 s.
- ``schedule_kwargs``: the ``BENCH_*`` IPM-schedule knobs, key for key.
- ``warm_oracle``: every vertex, pair and simplex bucket launched once.
- ``hold_sentinel`` / ``sentinel_active``: the capture-active file
  protocol (create, heartbeat every 20 s, remove at exit; a file whose
  mtime stopped for 600 s is an orphan).
- ``out_path``: where a tool writes its JSON (``--out``, else the JAX
  knob, else a fresh temp dir), never over the JAX package's
  ``artifacts/``.
"""

from __future__ import annotations

import atexit
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

from explicit_hybrid_mpc_tpu_torch import device as device_lib
from explicit_hybrid_mpc_tpu_torch import kernels
from explicit_hybrid_mpc_tpu_torch.parallel.launch import ROOT

#: The JAX package's committed captures; no tool writes under it.
ARTIFACTS = os.path.join(ROOT, "artifacts")
#: The capture-active sentinel of the JAX file protocol
#: (bench.py:81); .gitignore lists it.
SENTINEL = os.path.join(ARTIFACTS, ".capture_active")
#: A sentinel whose mtime has not moved for this long is an orphan.
SENTINEL_ORPHAN_S = 600.0
SENTINEL_BEAT_S = 20.0

#: BENCH_PLATFORM / --backend values -> the device kind.
_PLATFORMS = {"cuda": "cuda", "gpu": "cuda", "cpu": "cpu"}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def choose_device(result: dict | None = None, backend: str | None = None,
                  hold_capture_sentinel: bool = True,
                  sentinel: str = SENTINEL):
    """The torch device a capture runs on, recorded in
    ``result["platform"]`` ("gpu" or "cpu", as jax.default_backend()
    names them) and, on the card, ``result["device_name"]`` and
    ``result["power_limit"]`` (``power_limit``).

    `backend` (a tool's ``--backend``) wins over ``BENCH_PLATFORM``;
    neither given means the card.  'tpu' and unknown names are refused,
    and so is the card where there is none (SystemExit).  With
    hold_capture_sentinel (the default) the process holds `sentinel`
    until it exits, as every JAX capture script does; long_build, which
    pauses on it, passes False."""
    result = result if result is not None else {}
    forced = backend or os.environ.get("BENCH_PLATFORM") or "cuda"
    kind = _PLATFORMS.get(forced.lower())
    if kind is None:
        raise SystemExit(f"backend {forced!r}: the port runs on 'cuda' "
                         "(also 'gpu') or 'cpu'; there is no TPU backend")
    try:
        dev = device_lib.resolve(kind)
    except RuntimeError as e:
        raise SystemExit(f"no card: {e}")
    if hold_capture_sentinel:
        atexit.register(hold_sentinel(sentinel))
    result["platform"] = "gpu" if dev.type == "cuda" else "cpu"
    if dev.type == "cuda":
        import torch

        result["device_name"] = torch.cuda.get_device_name(dev)
        result["power_limit"] = power_limit(dev)
    log(f"platform: {result['platform']}, device: {dev}")
    return dev


def power_limit(dev) -> str | None:
    """The power limit of CUDA device `dev` as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives it
    ("700.00 W"); None where nvidia-smi cannot say or the device's
    index among nvidia-smi's cards is not known (CUDA_VISIBLE_DEVICES
    naming cards by UUID).  A card below its maximum runs slower under
    load, so a timed row carries it."""
    idx = dev.index or 0
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible:
        ids = [v.strip() for v in visible.split(",")]
        if idx >= len(ids) or not ids[idx].isdigit():
            return None
        idx = int(ids[idx])
    try:
        lines = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    if idx >= len(lines):
        return None
    return lines[idx].rsplit(",", 1)[-1].strip()


def sync(dev) -> None:
    """Wait for `dev`'s queued work (a no-op on the CPU): every time a
    capture takes ends here."""
    if dev.type == "cuda":
        import torch

        torch.cuda.synchronize(dev)


def default_precision(on_card: bool, problem=None) -> str:
    """The IPM precision a capture uses when none is asked for.  On the
    CPU, bench.py's rule: the problem's cpu_precision_hint ('f64' for
    the quadrotor, whose f32 phase collapses), else 'mixed'.  On the
    card 'f64', PartitionConfig's default: bench.py's 'mixed' there
    dodged the TPU's emulated float64, which Hopper does not emulate."""
    if on_card:
        return "f64"
    return getattr(problem, "cpu_precision_hint", "mixed")


def is_cuda_error(e: BaseException) -> bool:
    """A CUDA runtime error as torch raises it: a RuntimeError (or its
    subclasses AcceleratorError, OutOfMemoryError) naming CUDA."""
    return "CUDA" in str(e) or "cuda" in type(e).__name__.lower() \
        or type(e).__name__ in ("AcceleratorError", "OutOfMemoryError")


def card_fault(e: BaseException) -> bool:
    """A failure of the card or of a kernel (a kernels.KernelError, a
    device.NoCpuFallback, a CUDA error)."""
    return isinstance(e, (kernels.KernelError, device_lib.NoCpuFallback)) \
        or is_cuda_error(e)


def retry_transient(fn, attempts: int = 3, wait_s: float = 20.0,
                    what: str = ""):
    """Run fn(), retrying a transient RuntimeError / OSError up to
    `attempts` times, `wait_s` apart.  A kernels.KernelError, a
    device.NoCpuFallback and a CUDA error are never retried, nor are
    programming errors (TypeError, ValueError)."""
    for k in range(attempts):
        try:
            return fn()
        except (kernels.KernelError, device_lib.NoCpuFallback):
            raise
        except (RuntimeError, OSError) as e:
            if k == attempts - 1 or is_cuda_error(e):
                raise
            log(f"transient error in {what}: {e!r}; "
                f"retry {k + 1}/{attempts - 1} in {wait_s:.0f}s")
            time.sleep(wait_s)


def schedule_kwargs(result: dict | None = None) -> dict:
    """The IPM-schedule env knobs, as Oracle kwargs (bench.py's
    schedule_kwargs, key for key): BENCH_POINT_SCHEDULE="nf32,nf64",
    BENCH_RESCUE, BENCH_TWO_PHASE=0/1 (default on), BENCH_PHASE1 (0 =
    auto), BENCH_IPM_KERNEL, BENCH_PHASE1_POINT / _SIMPLEX, BENCH_WARM=0/1
    (default on).  The knobs set in the environment are recorded in
    result["schedule_overrides"]."""
    kw = {}
    overrides = {}
    ps = os.environ.get("BENCH_POINT_SCHEDULE")
    if ps:
        a, b = ps.split(",")
        kw["point_schedule"] = (int(a), int(b))
        overrides["point_schedule"] = [int(a), int(b)]
    r = os.environ.get("BENCH_RESCUE")
    if r and int(r) > 0:
        kw["rescue_iter"] = int(r)
        overrides["rescue_iter"] = int(r)
    tp = os.environ.get("BENCH_TWO_PHASE")
    kw["two_phase"] = tp != "0" if tp is not None else True
    if tp is not None:
        overrides["two_phase"] = kw["two_phase"]
    p1 = os.environ.get("BENCH_PHASE1")
    if p1 and int(p1) != 0:
        kw["phase1_iters"] = int(p1)
        overrides["phase1_iters"] = int(p1)
    ik = os.environ.get("BENCH_IPM_KERNEL")
    if ik:
        kw["ipm_kernel"] = ik
        overrides["ipm_kernel"] = ik
    for env, kw_name in (("BENCH_PHASE1_POINT", "phase1_iters_point"),
                         ("BENCH_PHASE1_SIMPLEX", "phase1_iters_simplex")):
        v = os.environ.get(env)
        if v and int(v) != 0:
            kw[kw_name] = int(v)
            overrides[kw_name] = int(v)
    wm = os.environ.get("BENCH_WARM")
    kw["warm_start"] = wm != "0" if wm is not None else True
    if wm is not None:
        overrides["warm_start"] = kw["warm_start"]
    if result is not None and overrides:
        result["schedule_overrides"] = overrides
    return kw


def warm_oracle(oracle, problem, stop_after: float | None = None) -> None:
    """Launch every vertex-batch, pair and simplex bucket once, so a
    build that follows launches no shape for the first time (bench.py's
    warm_oracle).  `stop_after`: an optional epoch deadline."""
    from explicit_hybrid_mpc_tpu_torch.partition import geometry

    rng = np.random.default_rng(42)
    nd = problem.canonical.n_delta

    def buckets(cap, what):
        b = 8
        while b <= cap:
            if stop_after is not None and time.time() > stop_after:
                log(f"warmup stopped early at {what}bucket {b}")
                return
            log(f"warmup: {what}bucket {b}")
            yield b
            b *= 2

    for b in buckets(oracle.max_points_per_call, ""):
        pts = rng.uniform(problem.theta_lb, problem.theta_ub,
                          size=(b, problem.n_theta))
        retry_transient(lambda: oracle.solve_vertices(pts),
                        what=f"warmup bucket {b}")
    if (nd > 1 or getattr(oracle, "two_phase", False)
            or getattr(oracle, "warm_start", False)
            or getattr(oracle, "rescue_iter", 0) > 0):
        for b in buckets(oracle.max_pairs_per_call, "pair "):
            pts = rng.uniform(problem.theta_lb, problem.theta_ub,
                              size=(b, problem.n_theta))
            ds = np.arange(b, dtype=np.int64) % nd
            retry_transient(lambda: oracle.warm_pair_bucket(pts, ds),
                            what=f"pair warmup {b}")
    span = problem.theta_ub - problem.theta_lb
    M1 = geometry.barycentric_matrix(np.vstack(
        [problem.theta_lb, problem.theta_lb + 0.1 * np.diag(span)]))
    for b in buckets(oracle.max_simplex_rows_per_call, "simplex "):
        Ms = np.tile(M1[None], (b, 1, 1))
        ds = np.arange(b, dtype=np.int64) % nd
        retry_transient(lambda: oracle.warm_simplex_bucket(Ms, ds),
                        what=f"simplex warmup {b}")


def hold_sentinel(path: str = SENTINEL):
    """Create `path` (if absent) and touch it every SENTINEL_BEAT_S
    until the returned stop() is called, which removes it when this
    process created it.  Ownership is taken atomically (O_CREAT|O_EXCL);
    a sentinel another process owned and removed meanwhile is
    re-created by the beat and then owned here (bench.py's
    hold_sentinel)."""
    state = {"owned": False}
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        try:
            os.close(os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY))
            state["owned"] = True
        except FileExistsError:
            pass
    except OSError:
        return lambda: None
    stop_ev = threading.Event()

    def beat():
        while not stop_ev.wait(SENTINEL_BEAT_S):
            try:
                if not os.path.exists(path):
                    open(path, "a").close()
                    state["owned"] = True
                os.utime(path)
            except OSError:
                pass

    threading.Thread(target=beat, daemon=True).start()

    def stop():
        stop_ev.set()
        if state["owned"]:
            try:
                os.unlink(path)
            except OSError:
                pass

    return stop


def sentinel_active(path: str = SENTINEL,
                    orphan_s: float = SENTINEL_ORPHAN_S) -> bool:
    """True while `path` exists and its mtime moved in the last
    `orphan_s` seconds (an older one is an orphan of a killed holder)."""
    try:
        return time.time() - os.path.getmtime(path) < orphan_s
    except OSError:
        return False


def out_path(cli_out: str | None, env: str, name: str, tool: str) -> str:
    """The JSON path a tool writes: `cli_out`, else the environment
    variable `env`, else `name` in a fresh temp dir, whose path is
    printed.  A path under the JAX package's artifacts/ is refused."""
    path = cli_out or os.environ.get(env)
    if not path:
        wd = tempfile.mkdtemp(prefix=f"{tool}.")
        log(f"{tool}: writing to {wd}")
        path = os.path.join(wd, name)
    real = os.path.realpath(path)
    if os.path.commonpath([real, os.path.realpath(ARTIFACTS)]) \
            == os.path.realpath(ARTIFACTS):
        raise SystemExit(f"{tool}: {path} is under the JAX package's "
                         f"artifacts/ ({ARTIFACTS}); write elsewhere")
    os.makedirs(os.path.dirname(real) or ".", exist_ok=True)
    return path
