"""Retry / timeout / backoff policy + poison-cell quarantine synthesis.

The frontier's device-failure handling used to be one unconditional
CPU re-solve per failed batch: a PERSISTENTLY failing device paid the
dispatch-fail-fallback tax on every batch forever, a CPU re-solve that
ALSO failed aborted the build, and a solve that simply never returned
hung it.  ``RetryPolicy`` bounds all three:

- ``solve_timeout_s``: every oracle attempt (device and fallback) runs
  under a watchdog; a blocked solve raises ``SolveTimeout`` (a
  RuntimeError, so the device-failure handlers own it).  Off (None) by
  default -- the watchdog thread costs a thread-hop per call.
- ``max_attempts`` x ``backoff_s`` x ``backoff_factor``: bounded
  CPU-twin retries with exponential backoff after a device failure.
- ``device_failure_cap``: total device failures before the engine
  DEGRADES to the CPU twin permanently (``faults.device_degraded``
  event) -- a dead accelerator costs the fallback tax once, not
  per-batch (frontier._note_device_failure).
- exhaustion => QUARANTINE: the batch's cells get synthesized
  no-information results (``synthesize_failure``) -- +inf /
  unconverged point cells, -inf "no usable bound" simplex rows, no
  infeasibility certificates -- so certification degrades soundly
  (affected simplices split or close uncertified) and the build
  CONTINUES instead of dying on a poison cell.  Quarantined counts
  surface in stats/bench (``quarantined_cells``) and obs
  (``build.quarantined_cells``), gated by the ``max_quarantine_frac``
  health rule.

Soundness: every synthesized value is the MOST CONSERVATIVE one the
consumer accepts -- +inf/unconverged never certifies a leaf, -inf is
the existing "stalled solve, no usable bound" encoding (never logged
to the fact ledger, never inherited), and infeasible_certified=False
never closes an infeasible leaf.  A quarantined cell can therefore
cost extra subdivision or an uncertified leaf, never a wrong
certificate (docs/robustness.md "Quarantine semantics").
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional

import numpy as np


class SolveTimeout(RuntimeError):
    """An oracle attempt exceeded solve_timeout_s.  RuntimeError on
    purpose: the device-failure handlers treat a wedged solve exactly
    like a dead device."""


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded-recovery knobs (built from PartitionConfig fields of
    the same names by ``from_config``)."""

    max_attempts: int = 2
    backoff_s: float = 0.05
    backoff_factor: float = 2.0
    solve_timeout_s: Optional[float] = None
    device_failure_cap: int = 3  # tpulint: disable=recompile-hazard -- failure count, not a shape
    # Fallback attempts run under a LAXER deadline (solve_timeout_s x
    # this factor): the CPU twin's first batch of a shape pays jit
    # COMPILE wall, and a watchdog tuned to steady-state device solves
    # would spuriously time out the compile and quarantine cells the
    # twin was about to recover.  The fallback is the last line before
    # giving up -- patience there is cheap relative to a lost cell.
    fallback_timeout_factor: float = 8.0

    def __post_init__(self) -> None:
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.backoff_s < 0 or self.backoff_factor < 1.0:
            raise ValueError("backoff_s must be >= 0 and "
                             "backoff_factor >= 1")
        if self.solve_timeout_s is not None and self.solve_timeout_s <= 0:
            raise ValueError("solve_timeout_s must be > 0 (or None)")
        if self.device_failure_cap < 1:
            raise ValueError("device_failure_cap must be >= 1")
        if self.fallback_timeout_factor < 1.0:
            raise ValueError("fallback_timeout_factor must be >= 1")

    @classmethod
    def from_config(cls, cfg) -> "RetryPolicy":
        # getattr defaults: pickled pre-knob checkpoint cfgs lack the
        # fields; class-level dataclass defaults resolve them, but a
        # plain dict-like cfg in tests may not -- be defensive.
        return cls(
            max_attempts=getattr(cfg, "oracle_retry_attempts", 2),
            backoff_s=getattr(cfg, "oracle_retry_backoff_s", 0.05),
            solve_timeout_s=getattr(cfg, "solve_timeout_s", None),
            device_failure_cap=getattr(cfg, "device_failure_cap", 3))

    def backoff(self, attempt: int) -> float:
        """Sleep before fallback attempt `attempt` (0-based)."""
        return self.backoff_s * (self.backoff_factor ** attempt)

    def fallback_timeout(self) -> Optional[float]:
        """Watchdog deadline for CPU-twin fallback attempts (see
        fallback_timeout_factor); None when the watchdog is off."""
        if self.solve_timeout_s is None:
            return None
        return self.solve_timeout_s * self.fallback_timeout_factor


def call_with_timeout(fn, timeout_s: Optional[float]):
    """Run ``fn()`` under the watchdog: None timeout = direct call
    (the default fast path, no thread); otherwise a fresh daemon
    thread per call, SolveTimeout on expiry.

    The timed-out thread is left to finish (Python cannot safely kill
    it); its eventual result is discarded.  Stats it increments on the
    oracle land late -- solve COUNTS under timeout recovery are
    therefore approximate; trees are not (the consumer only uses the
    fallback's results).  A fresh thread per call is deliberate: a
    pooled worker wedged by a genuinely hung solve would poison every
    later call's queue."""
    if timeout_s is None:
        return fn()
    box: dict = {}
    done = threading.Event()

    def run() -> None:
        try:
            box["out"] = fn()
        except BaseException as e:  # noqa: BLE001 -- re-raised on caller
            box["err"] = e
        finally:
            done.set()

    t = threading.Thread(target=run, daemon=True,
                         name="oracle-solve-watchdog")
    t.start()
    if not done.wait(timeout_s):
        raise SolveTimeout(
            f"oracle solve exceeded solve_timeout_s={timeout_s}")
    if "err" in box:
        raise box["err"]
    return box["out"]


# -- quarantine synthesis --------------------------------------------------


def synthesize_failure(kind: str, args: tuple, oracle):
    """The most conservative well-shaped result for a batch whose
    every recovery attempt failed (see module docstring for the
    soundness argument).  `kind` is the frontier's query kind:
    'vertices' | 'pairs' | 'pairs_full' | 'solve_simplex_min' |
    'simplex_feasibility'.  Returns (result, n_cells)."""
    can = oracle.can
    nd, nt, nu, nz = can.n_delta, can.n_theta, can.n_u, can.nz
    nc = can.nc
    # Warm-capable oracles always return duals/slacks and the pipeline
    # indexes them unconditionally -- synthesized rows must carry
    # (zero) arrays, not None, on those oracles.
    full = bool(getattr(oracle, "_point_full_out", False))
    if kind == "vertices":
        from explicit_hybrid_mpc_tpu_torch.oracle.oracle import VertexSolution

        P = np.atleast_2d(np.asarray(args[0])).shape[0]
        return VertexSolution(
            V=np.full((P, nd), np.inf),
            conv=np.zeros((P, nd), dtype=bool),
            feas=np.zeros((P, nd), dtype=bool),
            grad=np.zeros((P, nd, nt)), u0=np.zeros((P, nd, nu)),
            z=np.zeros((P, nd, nz)), Vstar=np.full(P, np.inf),
            dstar=np.full(P, -1, dtype=np.int64),
            lam=np.zeros((P, nd, nc)) if full else None,
            s=np.zeros((P, nd, nc)) if full else None), P * nd
    if kind in ("pairs", "pairs_full"):
        K = np.atleast_2d(np.asarray(args[0])).shape[0]
        out = (np.full(K, np.inf), np.zeros(K, dtype=bool),
               np.zeros((K, nt)), np.zeros((K, nu)), np.zeros((K, nz)))
        if kind == "pairs_full":
            lam_s = ((np.zeros((K, nc)), np.zeros((K, nc)))
                     if full else (None, None))
            return out + lam_s, K
        return out, K
    K = np.asarray(args[0]).shape[0]
    if kind == "solve_simplex_min":
        # -inf = the existing "stalled solve, no usable bound"
        # encoding: never certifies, never enters the fact ledger.
        return (np.full(K, -np.inf), np.zeros(K, dtype=bool)), K
    if kind == "simplex_feasibility":
        # No Farkas certificate => the candidate splits instead of
        # closing as an infeasible leaf (sound, possibly wasteful).
        return (np.zeros(K), np.zeros(K, dtype=bool),
                np.zeros(K, dtype=bool)), K
    raise ValueError(f"no quarantine synthesis for query kind {kind!r}")
