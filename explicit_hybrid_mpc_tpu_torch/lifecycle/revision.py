"""Problem-revision streams: what the rebuild daemon watches.

A *revision* is one observed change of the controlled plant (or of the
certification targets) that invalidates the currently-serving tree:
new dynamics parameters, a tightened eps.  Revisions are value
objects (JSON round-trippable, so a file can carry them between
processes); the daemon measures END-TO-END staleness from the moment a
revision is OBSERVED (``t_observed``, stamped by the source on the
monotonic clock) to the moment the rebuilt controller is live.

Sources:

- ``DriftSource``: the simulated plant-drift driver.  A seeded,
  bounded random walk perturbs one numeric constructor argument of a
  registered problem (``problems/registry.py``) -- the stand-in for a
  system-identification pipeline re-estimating plant parameters -- and
  optionally *verifies the drift is observable* by rolling the nominal
  and drifted plants open-loop through the closed-loop simulator
  (``sim/simulator.py``; ``plant_divergence``) and only emitting a
  revision once the trajectories diverge past a threshold.  The walk
  deliberately never touches ``theta_box``/bounds: the parameter box
  is the partition's root geometry, and a box change is a COLD-build
  event (partition/rebuild.RebuildError), not a warm revision.
- ``FileRevisionSource``: tails a JSONL file of revision records --
  the test/integration surface, and how an external watcher (a real
  sys-id job) feeds the daemon.  Tolerates a torn final line (the
  writer may still be appending).

Both implement the two-method ``RevisionSource`` protocol: ``poll()``
returns newly-observed revisions (non-blocking), ``close()`` releases
resources.  Sources never block the daemon's scheduler loop.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class Revision:
    """One observed problem revision.

    ``problem_args`` uses the PartitionConfig convention: a sorted
    tuple of (key, value) pairs, drop-in for ``cfg.problem_args``.
    ``t_observed`` is on ``time.perf_counter()``'s clock -- staleness
    is measured against it, so it must never be a wall-clock stamp
    from another process (a file source re-stamps at read time: the
    daemon can only be held accountable for latency it can see)."""

    controller: str
    problem: str
    problem_args: tuple
    eps_a: float
    eps_r: float = 0.0
    seq: int = 0
    t_observed: float = 0.0
    note: str = ""

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["problem_args"] = [list(kv) for kv in self.problem_args]
        d.pop("t_observed")  # clock-local; re-stamped by the reader
        return d

    @classmethod
    def from_dict(cls, d: dict, controller: str = "default",
                  seq: int = 0) -> "Revision":
        args = d.get("problem_args") or ()
        if isinstance(args, dict):
            args = args.items()
        return cls(
            controller=str(d.get("controller", controller)),
            problem=d["problem"],
            problem_args=tuple(sorted((str(k), v) for k, v in args)),
            eps_a=float(d.get("eps_a", 1e-2)),
            eps_r=float(d.get("eps_r", 0.0)),
            seq=int(d.get("seq", seq)),
            t_observed=time.perf_counter(),
            note=str(d.get("note", "")))


class RevisionSource:
    """Protocol base: poll() -> newly observed revisions; close()."""

    def poll(self) -> list[Revision]:
        raise NotImplementedError

    def close(self) -> None:
        pass


class FileRevisionSource(RevisionSource):
    """JSONL revision stream: one revision dict per line, observed in
    file order as lines COMPLETE (a torn final line -- a writer still
    appending -- is retried on the next poll, never half-parsed).
    Each record needs at least ``problem``; see Revision.from_dict."""

    def __init__(self, path: str, controller: str = "default"):
        self.path = path
        self.controller = controller
        self._offset = 0
        self._seq = 0
        self._dry = False

    def poll(self) -> list[Revision]:
        out = self._read()
        self._dry = not out
        return out

    def exhausted(self) -> bool:
        """True once a poll() found no new revision: every complete line
        the file held by then has been handed out -- and, when the
        rebuild service's watcher polls, enqueued, since it enqueues a
        poll's revisions before it polls again.  ``main serve-rebuild
        --source`` without ``--duration`` drains the file to this point.
        (The JAX package's file source has no such test: its CLI can
        find the daemon idle before the watcher's first poll and exit
        with no generation.)"""
        return self._dry

    def _read(self) -> list[Revision]:
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return []
        if size <= self._offset:
            return []
        with open(self.path, "rb") as f:
            f.seek(self._offset)
            buf = f.read()
        out: list[Revision] = []
        consumed = 0
        for line in buf.splitlines(keepends=True):
            if not line.endswith(b"\n"):
                break  # torn tail: the writer is mid-append
            consumed += len(line)
            s = line.strip()
            if not s:
                continue
            try:
                d = json.loads(s)
            except json.JSONDecodeError:
                continue  # garbage line: skip, never wedge the stream
            self._seq += 1
            out.append(Revision.from_dict(d, controller=self.controller,
                                          seq=self._seq))
        self._offset += consumed
        return out


class _ProbeController:
    """Zero-input probe controller for the open-loop divergence roll
    (sim.simulate needs a theta -> (u, StepInfo) callable)."""

    def __init__(self, n_u: int):
        self._u = np.zeros(n_u)

    def __call__(self, theta):
        from explicit_hybrid_mpc_tpu_torch.sim.simulator import StepInfo

        return self._u, StepInfo(eval_s=0.0, inside=True,
                                 cost_pred=float("nan"))


def plant_divergence(nominal, drifted, T: int = 20,
                     theta0: Optional[np.ndarray] = None) -> float:
    """Max state divergence of the drifted plant vs the nominal model
    over a T-step open-loop roll from a corner of the certified box --
    the drift-watch observable (a plant that tracks its model produces
    0.0; the DriftSource gates revision emission on it).  Runs through
    the closed-loop simulator's plant-rolling path (sim/simulator.py)
    with a zero-input probe controller."""
    from explicit_hybrid_mpc_tpu_torch.sim import simulator

    if theta0 is None:
        theta0 = 0.8 * np.asarray(nominal.theta_ub, dtype=np.float64)
    ctrl = _ProbeController(nominal.n_u)
    a = simulator.simulate(nominal, ctrl, theta0, T)
    b = simulator.simulate(drifted, ctrl, theta0, T)
    return float(np.max(np.abs(a.states - b.states)))


class DriftSource(RevisionSource):
    """Simulated plant drift: a bounded random walk on one numeric
    constructor argument of a registered problem.

    Every ``period_s`` the walk advances one step; the drifted problem
    is instantiated through ``problems.registry.make`` and (when
    ``min_divergence`` > 0) its open-loop trajectory is compared
    against the nominal plant's (``plant_divergence``) -- a revision
    is emitted only once the drift is actually OBSERVABLE, so a
    dormant plant does not trigger rebuild churn.  ``eps_frac`` adds
    an independent walk on eps_a (certification-target drift).

    The walk is bounded to ``+-max_drift_frac`` around the base value:
    warm rebuild reuse decays with revision distance, and an unbounded
    walk would quietly turn every rebuild cold.  Deterministic under
    ``seed`` (the bench/test surface)."""

    def __init__(self, problem: str, problem_args: tuple = (),
                 controller: str = "default",
                 eps_a: float = 1e-2, eps_r: float = 0.0,
                 drift_arg: str = "u_max", drift_frac: float = 0.02,
                 max_drift_frac: float = 0.2, eps_frac: float = 0.0,
                 n_revisions: Optional[int] = 3, period_s: float = 0.0,
                 seed: int = 0, probe_T: int = 0,
                 min_divergence: float = 0.0):
        from explicit_hybrid_mpc_tpu_torch.problems.registry import make

        if drift_frac < 0 or max_drift_frac <= 0:
            raise ValueError("drift_frac must be >= 0 and "
                             "max_drift_frac > 0")
        self.problem = problem
        self.controller = controller
        self.eps_a, self.eps_r = float(eps_a), float(eps_r)
        self.drift_arg = drift_arg
        self.drift_frac = float(drift_frac)
        self.max_drift_frac = float(max_drift_frac)
        self.eps_frac = float(eps_frac)
        self.n_revisions = n_revisions
        self.period_s = float(period_s)
        self.probe_T = int(probe_T)
        self.min_divergence = float(min_divergence)
        self._base_args = dict(problem_args)
        self._nominal = make(problem, **self._base_args)
        if drift_arg in ("theta_box", "theta_lb", "theta_ub"):
            raise ValueError(
                "the parameter box is the partition's root "
                "geometry: drifting it is a cold-build event, "
                "not a warm revision (pick a dynamics argument)")
        base = self._base_args.get(drift_arg,
                                   getattr(self._nominal, drift_arg, None))
        if base is None or not isinstance(base, (int, float)):
            raise ValueError(
                f"problem {problem!r} has no numeric constructor "
                f"argument {drift_arg!r} to drift")
        self._base_value = float(base)
        self._rng = np.random.default_rng(seed)
        self._frac = 0.0       # accumulated drift fraction of base
        self._eps_frac_state = 0.0
        self._seq = 0
        self._t_last = -float("inf")
        #: Optional emission gate: poll() emits nothing while it
        #: returns False.  The K-generation drives (``main
        #: serve-rebuild``'s drift mode, chip_smoke.py) gate revision
        #: k+1 on generation k being LIVE, so daemon-side coalescing -- the
        #: right behavior under a revision storm -- cannot shrink a
        #: fixed-K walk (a fast walk against a slow rebuild would
        #: otherwise supersede most of its revisions).
        self.gate = None

    @property
    def n_emitted(self) -> int:
        return self._seq

    def exhausted(self) -> bool:
        return (self.n_revisions is not None
                and self._seq >= self.n_revisions)

    def _advance(self) -> tuple[float, float]:
        # Bounded multiplicative random walk: each step moves the
        # accumulated drift fraction by up to +-drift_frac, clamped to
        # the max excursion (an unbounded walk would quietly turn
        # every warm rebuild cold).
        self._frac = float(np.clip(
            self._frac + self.drift_frac * self._rng.uniform(-1.0, 1.0),
            -self.max_drift_frac, self.max_drift_frac))
        val = self._base_value * (1.0 + self._frac)
        eps = self.eps_a
        if self.eps_frac > 0:
            self._eps_frac_state = float(np.clip(
                self._eps_frac_state
                + self.eps_frac * self._rng.uniform(-1.0, 1.0),
                -0.5, 0.5))
            eps = self.eps_a * (1.0 + self._eps_frac_state)
        return val, float(eps)

    def poll(self) -> list[Revision]:
        if self.exhausted():
            return []
        if self.gate is not None and not self.gate():
            return []
        now = time.perf_counter()
        if now - self._t_last < self.period_s:
            return []
        from explicit_hybrid_mpc_tpu_torch.problems.registry import make

        val, eps = self._advance()
        args = dict(self._base_args)
        args[self.drift_arg] = val
        note = f"{self.drift_arg}={val:.6g}"
        if self.probe_T > 0 or self.min_divergence > 0:
            drifted = make(self.problem, **args)
            div = plant_divergence(self._nominal, drifted,
                                   T=max(self.probe_T, 1))
            note += f" divergence={div:.3g}"
            if div < self.min_divergence:
                # Drift not yet observable: keep walking silently.
                self._t_last = now
                return []
        self._t_last = now
        self._seq += 1
        return [Revision(
            controller=self.controller, problem=self.problem,
            problem_args=tuple(sorted(args.items())),
            eps_a=eps, eps_r=self.eps_r, seq=self._seq,
            t_observed=now, note=note)]
