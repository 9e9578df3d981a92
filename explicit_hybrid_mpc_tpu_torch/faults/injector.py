"""The runtime half of fault injection: counters, firing, corruption.

One process holds at most ONE active injector (module global): the
hooks threaded through the stack are a single ``fire(site, ...)``
call that is a dict-free no-op when no plan is installed, so the
production fast path pays one global read and one ``is None`` test.

Installation surfaces:

- ``activate(plan)``: context manager for in-process tests (fresh
  counters per use, restores the previous injector on exit);
- ``install(plan)`` / ``clear()``: explicit process-wide install (the
  supervised-subprocess chaos runs);
- ``install_from_config(cfg, obs)``: the engine entry point --
  ``cfg.fault_plan`` (a FaultPlan, a dict, or a JSON path) or the
  ``EHM_FAULT_PLAN`` env var (a JSON path, how chaos_suite reaches a
  subprocess build).  Returns the active injector or None.  If an
  injector is ALREADY active (a test's ``activate`` block), it is
  kept -- the engine only attaches its obs handle for events.

Every fired fault is recorded in ``injector.fired`` and emitted as a
``faults.injected`` obs event + ``faults.injected`` counter when an
obs handle is attached, so a chaos run's stream documents exactly
which scripted faults actually landed (a plan whose faults never fire
is a silently-vacuous test -- ``assert_all_fired`` guards that).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

import numpy as np

from explicit_hybrid_mpc_tpu_torch.faults.plan import (FaultPlan, FaultSpec,
                                                 InjectedCrash,
                                                 InjectedFault)

ENV_PLAN = "EHM_FAULT_PLAN"


class FaultInjector:
    """Replays a FaultPlan against the site hooks (thread-safe: serve
    worker threads and the build loop share the one injector)."""

    def __init__(self, plan: FaultPlan, obs=None):
        self.plan = plan
        self.obs = obs
        self._lock = threading.Lock()
        self._counts: dict[str, int] = {}
        # [(site, n, kind, label)] of every fault that actually fired.
        self.fired: list[tuple[str, int, str, Optional[str]]] = []
        self._rng = np.random.default_rng(plan.seed)

    # -- bookkeeping -------------------------------------------------------

    def count(self, site: str) -> int:
        with self._lock:
            return self._counts.get(site, 0)

    def n_fired(self, site: Optional[str] = None) -> int:
        with self._lock:
            if site is None:
                return len(self.fired)
            return sum(1 for s, *_ in self.fired if s == site)

    def assert_all_fired(self) -> None:
        """Raise when any scripted fault never fired -- the guard
        against a chaos schedule that silently tested nothing (site
        typo'd, build too short to reach the scripted call)."""
        with self._lock:
            fired = {(s, k) for s, _n, k, _l in self.fired}
        missing = [f for f in self.plan.faults
                   if (f.site, f.kind) not in fired]
        if missing:
            raise AssertionError(
                f"{len(missing)} scripted fault(s) never fired: "
                + "; ".join(f"{f.site}/{f.kind}@{f.at}" for f in missing))

    def _note(self, spec: FaultSpec, n: int, label: Optional[str]) -> None:
        with self._lock:
            self.fired.append((spec.site, n, spec.kind, label))
        if self.obs is not None and self.obs.enabled:
            self.obs.metrics.counter("faults.injected").inc()
            self.obs.event("faults.injected", site=spec.site,
                           fault_kind=spec.kind, n=n, label=label)

    # -- the hook ----------------------------------------------------------

    def fire(self, site: str, label: Optional[str] = None,
             path: Optional[str] = None) -> None:
        """The injection point: counts the invocation and acts out any
        matching spec.  May raise InjectedFault/InjectedCrash, sleep,
        corrupt `path`, or kill the process -- per the plan."""
        with self._lock:
            n = self._counts.get(site, 0) + 1
            self._counts[site] = n
            spec = next((f for f in self.plan.faults
                         if f.site == site and f.applies(n, label)), None)
        if spec is None:
            return
        self._note(spec, n, label)
        if spec.kind == "error":
            raise InjectedFault(
                f"injected device failure at {site}#{n}"
                + (f" ({label})" if label else ""))
        if spec.kind == "hang":
            # Bounded by design (module docstring): sleep then fail.
            time.sleep(spec.hang_s)
            raise InjectedFault(
                f"injected solve hang ({spec.hang_s}s) at {site}#{n}")
        if spec.kind == "stall":
            time.sleep(spec.hang_s)
            return
        if spec.kind == "crash":
            if self.plan.process_exit:
                # The SIGKILL stand-in: no cleanup, no atexit, no
                # buffered flushes -- the supervisor must recover from
                # whatever is on disk.
                os._exit(spec.exit_code)
            raise InjectedCrash(f"injected crash at {site}#{n}")
        if spec.kind == "corrupt" and path is not None \
                and os.path.exists(path):
            self._corrupt(path, spec)

    def _corrupt(self, path: str, spec: FaultSpec) -> None:
        """Truncate to keep_frac of the file, then flip one seeded
        byte -- a torn write AND bit rot in one deterministic mangle."""
        size = os.path.getsize(path)
        keep = int(size * spec.keep_frac)
        with open(path, "r+b") as f:
            f.truncate(keep)
            if keep > 0:
                f.seek(keep - 1)
                b = f.read(1)
                f.seek(keep - 1)
                f.write(bytes([b[0] ^ (1 + int(self._rng.integers(255)))]))


# -- module-global installation (the hooks' fast path) ---------------------

_active: Optional[FaultInjector] = None
_lock = threading.Lock()


def fire(site: str, label: Optional[str] = None,
         path: Optional[str] = None) -> None:
    """The one-line hook the stack calls.  No plan installed -> one
    global read + None test (the production fast path)."""
    inj = _active
    if inj is not None:
        inj.fire(site, label=label, path=path)


def current() -> Optional[FaultInjector]:
    return _active


def install(plan_or_injector, obs=None) -> FaultInjector:
    global _active
    inj = (plan_or_injector
           if isinstance(plan_or_injector, FaultInjector)
           else FaultInjector(_coerce_plan(plan_or_injector), obs=obs))
    with _lock:
        _active = inj
    return inj


def clear() -> None:
    global _active
    with _lock:
        _active = None


class activate:
    """Context manager: install a fresh injector for `plan`, restore
    the previous one on exit.  ``as`` yields the injector so tests can
    assert on ``fired``."""

    def __init__(self, plan, obs=None):
        self._plan = plan
        self._obs = obs
        self._prev: Optional[FaultInjector] = None

    def __enter__(self) -> FaultInjector:
        global _active
        with _lock:
            self._prev = _active
        inj = install(self._plan, obs=self._obs)
        return inj

    def __exit__(self, *exc) -> None:
        global _active
        with _lock:
            _active = self._prev


def _coerce_plan(plan) -> FaultPlan:
    if isinstance(plan, FaultPlan):
        return plan
    if isinstance(plan, dict):
        return FaultPlan.from_dict(plan)
    if isinstance(plan, (str, os.PathLike)):
        return FaultPlan.from_json(os.fspath(plan))
    raise TypeError(f"cannot build a FaultPlan from {type(plan)!r}")


def install_from_config(cfg, obs=None) -> Optional[FaultInjector]:
    """Engine-init hook: install from cfg.fault_plan or EHM_FAULT_PLAN
    (cfg wins).  An ALREADY-active injector (a test's activate block)
    is kept -- only its obs handle is refreshed so injected-fault
    events land in the build's stream."""
    inj = _active
    if inj is not None:
        if obs is not None and inj.obs is None:
            inj.obs = obs
        return inj
    plan = getattr(cfg, "fault_plan", None) or os.environ.get(ENV_PLAN)
    if not plan:
        return None
    return install(plan, obs=obs)
