"""Degraded-mode fallback for queries the certified partition misses.

The offline tree certifies a bounded box; a live service sees whatever
state estimation produces.  Two distinct miss causes (per-cause
counters -- the split matters operationally):

- ``outside_box``: the query lies outside the triangulated parameter
  box entirely (estimator transient, actuator saturation upstream).
  The default policy CLAMPS the query to the certified box and
  re-evaluates: the nearest certified leaf's law, evaluated at the
  clamped point -- continuous with the in-box law on the boundary, and
  the standard explicit-MPC practice for box excursions.
- ``hole``: the query is inside the box but the descent lands on a
  leaf with no certified payload (an uncertified depth-capped cell, or
  an infeasible region the build proved empty).  Clamping cannot help
  (the point IS in the box); the optional **oracle re-solve** path
  solves the full point MICP on the host for a BOUNDED fraction of
  traffic (``max_oracle_frac`` of requests seen, a running budget --
  a hole storm must degrade to best-effort answers, not turn the
  serving host into an accidental build cluster).

The counterpart of the JAX package's serve/fallback.py: the same
policy, counters and tags.  Every fallback outcome is tagged on the
per-request result (``ServeResult.fallback``: None | 'clamp' | 'oracle'
| 'unserved') and counted (``serve.fallback.*``); the scheduler folds
the rolling rate into a ``fallback_frac`` gauge, the serving SLO.
"""

from __future__ import annotations

import threading
import weakref
from typing import Optional

import numpy as np
import torch

from explicit_hybrid_mpc_tpu_torch import obs as obs_lib
from explicit_hybrid_mpc_tpu_torch.online.evaluator import EvalResult

#: Fallback cause/outcome tags, in the order counters are reported.
CAUSES = ("outside_box", "hole")
OUTCOMES = ("clamp", "oracle", "unserved")


def _host(a) -> np.ndarray:
    """A result field as a host array (evaluators return tensors on
    their device; the policy's bookkeeping is host numpy)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class FallbackPolicy:
    """Clamp-to-certified-box with optional budgeted oracle re-solve.

    `lb`/`ub`: the DEFAULT certified parameter box
    (serve.registry.root_box recovers it from the descent artifact).
    At apply() time the box is re-derived from the LEASED server's own
    root_bary whenever it carries one (cached per server), so a hot
    swap to a tree rebuilt on a different box clamps to the new
    version's certified boundary, not the boot-time one; the
    constructor box serves servers without root_bary.  `oracle`: an
    object with ``solve_vertices(thetas) -> VertexSolution``
    (oracle.Oracle) or None; `max_oracle_frac` bounds
    oracle re-solves to that fraction of requests seen (running
    budget, so a burst of holes early cannot starve the budget
    forever).

    The budget is scoped PER CONTROLLER NAME (the `controller` /
    `names` arguments below), not per policy instance: one policy is
    routinely shared across tenants (several RequestSchedulers, or an
    ArenaScheduler's whole mixed batch), and a single instance-global
    counter pair would let one hot tenant's hole storm consume the
    whole ``max_oracle_frac`` allowance and starve every other
    tenant's re-solves -- each controller now earns budget from ITS
    OWN request volume.  ``n_seen``/``n_oracle`` remain as
    all-controller totals for summaries."""

    def __init__(self, lb: np.ndarray, ub: np.ndarray,
                 mode: str = "clamp", oracle=None,
                 max_oracle_frac: float = 0.05,
                 obs: "obs_lib.Obs | None" = None):
        if mode not in ("clamp", "off"):
            raise ValueError(f"unknown fallback mode {mode!r} "
                             "(expected 'clamp' or 'off')")
        self.lb = np.asarray(lb, dtype=np.float64)
        self.ub = np.asarray(ub, dtype=np.float64)
        self.mode = mode
        self.oracle = oracle
        self.max_oracle_frac = float(max_oracle_frac)
        self._obs = obs if obs is not None else obs_lib.NOOP
        # Per-server certified boxes (weak: retired versions must stay
        # collectable; a recycled id() can never alias a stale box).
        self._boxes: "weakref.WeakKeyDictionary" = \
            weakref.WeakKeyDictionary()
        # Per-controller running budget (class docstring).  The lock
        # covers the read-modify-write pair: schedulers for different
        # tenants share one policy across worker threads.
        self._budget_lock = threading.Lock()
        self._seen: dict[str, int] = {}
        self._oracle_n: dict[str, int] = {}
        self._ms = None
        if self._obs.enabled:
            m = self._obs.metrics
            self._ms = {
                **{c: m.counter(f"serve.fallback.{c}") for c in CAUSES},
                **{o: m.counter(f"serve.fallback.{o}")
                   for o in OUTCOMES},
                "total": m.counter("serve.fallback.requests"),
            }

    def _count(self, key: str, n: int) -> None:
        if self._ms and n:
            self._ms[key].inc(n)

    # -- per-controller budget (class docstring) ---------------------------

    @property
    def n_seen(self) -> int:
        """All-controller requests seen (summary/back-compat total)."""
        with self._budget_lock:
            return sum(self._seen.values())

    @property
    def n_oracle(self) -> int:
        """All-controller oracle re-solves spent (summary total)."""
        with self._budget_lock:
            return sum(self._oracle_n.values())

    def _see(self, controller: str, n: int) -> None:
        with self._budget_lock:
            self._seen[controller] = self._seen.get(controller, 0) + n

    def _take_budget(self, controller: str, want: int) -> int:
        """Claim up to `want` oracle re-solves from `controller`'s OWN
        running allowance; returns the number granted."""
        with self._budget_lock:
            budget = int(self.max_oracle_frac
                         * self._seen.get(controller, 0)) \
                - self._oracle_n.get(controller, 0)
            got = max(0, min(want, budget))
            if got:
                self._oracle_n[controller] = \
                    self._oracle_n.get(controller, 0) + got
            return got

    def oracle_spent(self, controller: str) -> int:
        """Oracle re-solves charged to one controller's budget."""
        with self._budget_lock:
            return self._oracle_n.get(controller, 0)

    def _box(self, server) -> tuple[np.ndarray, np.ndarray]:
        """The certified box of THIS server (see class docstring)."""
        if getattr(server, "root_bary", None) is None:
            return self.lb, self.ub
        try:
            return self._boxes[server]
        except (KeyError, TypeError):  # TypeError: not weakref-able
            pass
        from explicit_hybrid_mpc_tpu_torch.serve.registry import root_box

        box = root_box(server)
        try:
            self._boxes[server] = box
        except TypeError:
            pass
        return box

    def box(self, server) -> tuple[np.ndarray, np.ndarray]:
        """Public view of `server`'s certified box (lb, ub) -- the
        demand hub's exceedance attribution reads it (obs/demand.py)."""
        return self._box(server)

    def apply(self, thetas: np.ndarray, res: EvalResult, server,
              controller: str = "default"
              ) -> tuple[EvalResult, list[Optional[str]]]:
        """Resolve the not-inside rows of one evaluated batch.

        Returns (patched EvalResult, per-row outcome tags).  `server`
        is the SAME leased version the batch evaluated on -- the clamp
        re-evaluation must not straddle a hot swap (the scheduler holds
        the lease across this call).  `controller` names the budget
        account the batch charges (class docstring)."""
        B = thetas.shape[0]
        self._see(controller, B)
        tags: list[Optional[str]] = [None] * B
        bad = np.flatnonzero(~res.inside)
        if bad.size == 0 or self.mode == "off":
            return res, tags
        lb, ub = self._box(server)
        u = np.array(_host(res.u))
        cost = np.array(_host(res.cost))
        leaf = np.array(_host(res.leaf))
        inside = np.array(_host(res.inside))

        outside = np.zeros(B, dtype=bool)
        outside[bad] = ((thetas[bad] < lb)
                        | (thetas[bad] > ub)).any(axis=1)
        n_out = int(outside.sum())
        self._count("outside_box", n_out)
        self._count("hole", bad.size - n_out)
        self._count("total", bad.size)

        # Clamp pass: one re-evaluation of ALL bad rows at their
        # box-clamped coordinates (for in-box holes the clamp is the
        # identity, but a hole's neighbors may still catch the query
        # when the miss was a knife-edge lam < -tol rejection).
        clamped = np.clip(thetas[bad], lb, ub)
        res2 = server.evaluate(clamped)
        served = _host(res2.inside)
        rows = bad[served]
        u[rows] = _host(res2.u)[served]
        cost[rows] = _host(res2.cost)[served]
        leaf[rows] = _host(res2.leaf)[served]
        inside[rows] = True
        for i in rows:
            tags[int(i)] = "clamp"
        self._count("clamp", rows.size)

        # Oracle re-solve for what the clamp could not serve, under the
        # running budget.
        left = bad[~served]
        if left.size and self.oracle is not None:
            got = self._take_budget(controller, int(left.size))
            take = left[:got]
            if take.size:
                sol = self.oracle.solve_vertices(thetas[take])
                dstar = _host(sol.dstar)
                hit = dstar >= 0
                # Only hits are patched in; an oracle MISS (no valid
                # commutation, dstar=-1) leaves the raw evaluated row
                # untouched -- 'unserved' means untouched, and u0 rows
                # behind a miss are unconverged garbage (Vstar +inf
                # would also break strict-JSON result consumers).
                kk = np.flatnonzero(hit)
                rows_ok = take[kk]
                u[rows_ok] = _host(sol.u0)[kk, dstar[kk]]
                cost[rows_ok] = _host(sol.Vstar)[kk]
                inside[rows_ok] = True
                for k, i in enumerate(take):
                    tags[int(i)] = "oracle" if hit[k] else "unserved"
                self._count("oracle", int(hit.sum()))
                self._count("unserved", int((~hit).sum()))
                left = left[got:]
            if left.size:
                self._count("unserved", left.size)
                for i in left:
                    tags[int(i)] = "unserved"
        elif left.size:
            self._count("unserved", left.size)
            for i in left:
                tags[int(i)] = "unserved"
        return EvalResult(u=u, cost=cost, leaf=leaf, inside=inside), tags

    def account_kernel(self, clamped: np.ndarray, served: np.ndarray,
                       names=None) -> list[Optional[str]]:
        """Count and tag one FUSED-KERNEL batch (serve/arena.py).

        The fused arena kernel clamps in-kernel and evaluates every row
        at its box-clamped point, so by the time results reach the host
        the clamp pass `apply()` would run has already happened.  This
        method performs exactly the ACCOUNTING `apply()` would, from the
        kernel's two per-row bits:

        - ``clamped``: the in-kernel clip moved the query (<=> strictly
          outside the certified box, `apply()`'s ``outside`` test);
        - ``served``: the clamped point landed inside a leaf
          (score >= -tol).

        Reconciliation with the host path (the satellite test pins it):
        a row is ``bad`` iff ``clamped | ~served`` (for un-clamped rows
        the kernel evaluated the raw point, so ~served == ~inside; for
        clamped rows the raw point is outside every root simplex, so it
        was never inside).  cause outside_box = clamped rows, cause
        hole = ~clamped & ~served; outcome 'clamp' = clamped & served,
        everything else bad is 'unserved'.  Counter-for-counter this
        matches `apply()` on the same query mix, away from f32/f64
        knife edges at box faces and leaf facets.

        mode='off' mirrors `apply()`: rows counted into ``n_seen`` only,
        no fallback counters, all tags None (the arena then skips the
        in-kernel clamp entirely, so clamped rows cannot exist).  The
        kernel path never invokes the configured oracle -- rows an
        oracle might have rescued are tagged 'unserved' here; route
        hole-heavy tenants through the host scheduler if oracle rescue
        matters more than launch fusion.

        `names` (optional): per-row controller names for the mixed
        arena batch, so each row credits ITS tenant's budget account
        (class docstring); without it the whole batch charges
        'default' -- acceptable only for single-tenant callers.
        """
        clamped = np.asarray(clamped, dtype=bool)
        served = np.asarray(served, dtype=bool)
        B = clamped.shape[0]
        if names is None:
            self._see("default", B)
        else:
            for nm in set(names):
                self._see(str(nm), sum(1 for x in names if x == nm))
        tags: list[Optional[str]] = [None] * B
        bad = clamped | ~served
        if not bad.any() or self.mode == "off":
            return tags
        n_out = int(clamped.sum())
        n_bad = int(bad.sum())
        self._count("outside_box", n_out)
        self._count("hole", n_bad - n_out)
        self._count("total", n_bad)
        clamp_rows = np.flatnonzero(clamped & served)
        for i in clamp_rows:
            tags[int(i)] = "clamp"
        self._count("clamp", clamp_rows.size)
        for i in np.flatnonzero(~served):
            tags[int(i)] = "unserved"
        self._count("unserved", n_bad - clamp_rows.size)
        return tags
