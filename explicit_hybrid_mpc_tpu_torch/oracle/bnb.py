"""Best-first branch-and-bound serial baseline (the Gurobi stand-in).

The torch port's copy of the JAX package's oracle/bnb.py.  The
reference's per-point oracle is a serial branch-and-bound MICP solve;
this module prices that alternative honestly: best-first enumeration
over the finite commutation family with incumbent pruning, one QP per
call of a backend='serial' Oracle (oracle/host_qp.py: one QP solved in
numpy on the host).

Algorithm per point theta:

1. Root bounds: LB(d) = unconstrained minimum of the fixed-d QP,
   -1/2 q_d' H_d^{-1} q_d plus the theta-only cost terms.  Valid lower
   bound: dropping the inequality rows only enlarges the feasible set.
   Cholesky factors of each H[d] are computed once at construction.
2. Best-first: visit commutations in ascending-LB order (stable ties),
   solving the full QP one at a time (Oracle._solve_pair_one); keep the
   incumbent V_best.
3. Incumbent pruning: stop at the first candidate whose LB >= V_best;
   the visit order is sorted, so every later candidate is pruned with it.

The commutation family is flat (complete commutations are enumerated by
the canonicalization, problems/base.py), so best-first + incumbent
pruning over it is the exact finite-family specialization of B&B.  Its
unconstrained root bound is weaker than a commercial solver's presolve
and relaxation bounds, which overstates the QP count a little.
"""

from __future__ import annotations

import time

import numpy as np
from scipy.linalg import cho_factor, cho_solve

from explicit_hybrid_mpc_tpu_torch import obs as obs_lib


class SerialBnB:
    """Best-first enumeration with incumbent pruning, one QP at a time.

    Wraps a backend='serial' Oracle; uses its single-pair program (one
    QP per call) and its iteration schedule, so the B&B baseline and the
    batched engine share the same solver and tolerance.
    """

    def __init__(self, oracle, obs: "obs_lib.Obs | None" = None):
        if oracle.backend != "serial":
            raise ValueError("SerialBnB requires a backend='serial' Oracle "
                             f"(got {oracle.backend!r}): the baseline's "
                             "contract is one QP per call")
        self.oracle = oracle
        # bnb.* metrics (nodes expanded/pruned, per-point wall).
        self.obs = obs if obs is not None else obs_lib.NOOP
        can = oracle.can
        self.can = can
        # Cholesky of each commutation's (PD, problems/base.py canonical()
        # asserts it) Hessian for the unconstrained root bound.
        self._chol = [cho_factor(can.H[d]) for d in range(can.n_delta)]
        self.n_qp_solves = 0      # full QPs solved across solve_point calls
        self.n_pruned = 0         # commutations eliminated by the bound

    def root_bounds(self, theta: np.ndarray) -> np.ndarray:
        """(n_delta,) valid lower bounds on V_d(theta): the unconstrained
        minimum -1/2 q' H^-1 q plus the theta-only cost terms that the
        pair solve adds to the QP objective."""
        can = self.can
        th = np.asarray(theta, dtype=np.float64)
        lbs = np.empty(can.n_delta)
        for d in range(can.n_delta):
            q = can.f[d] + can.F[d] @ th
            lbs[d] = (-0.5 * q @ cho_solve(self._chol[d], q)
                      + 0.5 * th @ can.Y[d] @ th + can.pvec[d] @ th
                      + can.cconst[d])
        return lbs

    def solve_point(self, theta: np.ndarray):
        """MICP at one point by best-first enumeration with pruning.

        Returns (Vstar, dstar, n_qp) where n_qp is the number of full QPs
        actually solved (n_delta - n_qp were pruned or cut off).
        Vstar=+inf / dstar=-1 when no commutation admits a converged
        solve -- same convention as VertexSolution.
        """
        t0 = time.perf_counter()
        pruned0 = self.n_pruned
        lbs = self.root_bounds(theta)
        order = np.argsort(lbs, kind="stable")  # deterministic ties
        th = np.asarray(theta, dtype=np.float64)
        v_best, d_best, n_qp = np.inf, -1, 0
        for d in order:
            if lbs[d] >= v_best:
                # Sorted visit order: everything from here on is pruned.
                self.n_pruned += self.can.n_delta - n_qp
                break
            V, conv, _feas, _g, _u0, _z = self.oracle._solve_pair_one(
                th, int(d))
            n_qp += 1
            if bool(conv) and float(V) < v_best:
                v_best, d_best = float(V), int(d)
        self.n_qp_solves += n_qp
        if self.obs.enabled:
            m = self.obs.metrics
            m.counter("bnb.points").inc()
            m.counter("bnb.nodes_expanded").inc(n_qp)
            m.counter("bnb.nodes_pruned").inc(self.n_pruned - pruned0)
            m.histogram("bnb.point_s").observe(time.perf_counter() - t0)
        return v_best, d_best, n_qp

    def measure(self, thetas: np.ndarray) -> dict:
        """Timed B&B solves over a point sample: the per-point cost model
        a serial wall is extrapolated from.

        The first point is solved once untimed, so one-time set-up stays
        out of the measurement (as the batched build's warm-up does)."""
        thetas = np.atleast_2d(thetas)
        self.solve_point(thetas[0])  # warm-up
        n0_qp, n0_pruned = self.n_qp_solves, self.n_pruned
        t0 = time.perf_counter()
        for th in thetas:
            self.solve_point(th)
        wall = time.perf_counter() - t0
        n_pts = len(thetas)
        n_qp = self.n_qp_solves - n0_qp
        return {
            "points": n_pts,
            "s_per_point": wall / n_pts,
            "qp_per_point": n_qp / n_pts,
            "pruned_per_point": (self.n_pruned - n0_pruned) / n_pts,
            "n_delta": self.can.n_delta,
        }
