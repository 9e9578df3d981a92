"""Full partition oracle for SOC-constrained hybrid problems (torch), as
in the JAX package's oracle/soc_oracle.py.  The query classes are split
by what each certificate actually needs:

- POINT class (vertex grids, sparse pairs, fixed-commutation online):
  the exact SOCP solver (oracle/socp.py, NT-scaled Mehrotra + verified
  tangent-cone rescue).  `conv` is the strict 1e-8 KKT flag, and the
  envelope gradient dV/dtheta = F'z* + Y theta + p - S'lam* is
  certificate-grade (the cones are theta-INDEPENDENT, so they add no
  gradient term).

- JOINT simplex class (stage-2 lower bounds, Farkas exclusions): the
  LINEAR RELAXATION, inherited verbatim from the QP Oracle (on a CUDA
  device, the hand-written IPM kernel).  Dropping theta-independent
  cones RELAXES the feasible set, so
    (a) the relaxation's simplex-min is a valid LOWER bound on the true
        SOC simplex-min (certificates use it on the lower-bound side
        only -- sound, possibly loose: extra splits, never a wrong
        certificate), and
    (b) a linear-Farkas infeasibility certificate on the relaxation
        implies SOC infeasibility.

- Upper-bound side: a certified leaf interpolates the vertex primal
  sequences; each vertex z_i satisfies the cones and the cones are
  convex and theta-independent, so every barycentric combination does
  too -- the QP certificate argument carries over unchanged.

Stalled point cells report conv=False and simply weaken the certificate
at that vertex -- the engine splits more in stall pockets; soundness is
unaffected.
"""

from __future__ import annotations

import torch

from explicit_hybrid_mpc_tpu_torch.oracle.oracle import (Oracle, _bmtv,
                                                         reduce_deltas)
from explicit_hybrid_mpc_tpu_torch.oracle.soc_point import soc_pairs


class SOCOracle(Oracle):
    """Oracle for problems exposing `soc_cones()` (Ac (K, m, nz),
    bc (K, m), theta-independent).  Batched single-device backends only
    ('cuda' by default, or 'cpu'); the SOC solver is float64."""

    def __init__(self, problem, soc_n_iter: int = 60, **kw):
        if kw.get("backend") == "serial" or kw.get("mesh") is not None:
            raise ValueError("SOCOracle supports batched single-device "
                             "backends only")
        if kw.get("rescue_iter") or kw.get("point_schedule"):
            # The base class's rescue/schedule programs are built from the
            # cone-blind linear solver: a rescue pass would overwrite
            # stalled SOC cells with LP-relaxation results flagged
            # converged -- silently unsound certificates.
            raise ValueError("SOCOracle does not support rescue_iter or "
                             "point_schedule (linear-kernel programs)")
        if kw.get("two_phase") or kw.get("warm_start"):
            # The SOC point programs return no duals/slacks, so the base
            # class's cohort/warm machinery cannot consume them; the LP
            # joint programs this oracle inherits stay single-phase
            # with it.
            raise ValueError("SOCOracle does not support two_phase or "
                             "warm_start (8-output SOC point programs)")
        kw.setdefault("precision", "f64")  # the SOC solver is f64-only
        super().__init__(problem, **kw)
        self._soc_n_iter = soc_n_iter
        Ac, bc = problem.soc_cones()
        self._Ac = torch.as_tensor(Ac, dtype=torch.float64).to(self.device)
        self._bc = torch.as_tensor(bc, dtype=torch.float64).to(self.device)

    # The POINT-class programs run the SOC solver; the JOINT simplex
    # programs (_simplex_min / _simplex_feas) stay on the linear
    # relaxation by design (module docstring).

    def _soc_pairs(self, th, ds):  # tpulint: device-region
        """(V, conv, feas, grad, u0, z) of the SOCPs at pairs (th, ds)."""
        prob = self.prob
        sol, V, u0 = soc_pairs(prob, self._Ac, self._bc, th, ds,
                               self._soc_n_iter)
        grad = (_bmtv(prob.F[ds], sol.z)
                + torch.matmul(prob.Y[ds], th[..., None])[..., 0]
                + prob.pvec[ds] - _bmtv(prob.S[ds], sol.lam_l))
        return V, sol.converged, sol.feasible, grad, u0, sol.z

    def _solve_points(self, thetas):  # tpulint: device-region
        nd = self.can.n_delta
        P = thetas.shape[0]
        th = thetas.repeat_interleave(nd, dim=0)
        ds = torch.arange(nd, device=thetas.device).repeat(P)
        V, conv, feas, grad, u0, z = (
            t.reshape((P, nd) + t.shape[1:])
            for t in self._soc_pairs(th, ds))
        # Shared first-minimum tie-break; _finalize applies the
        # dstar=-1 masking exactly as on the QP path.
        Vstar, dstar = reduce_deltas(V, conv)
        return V, conv, feas, grad, u0, z, Vstar, dstar

    def _solve_fixed(self, th, ds):  # tpulint: device-region
        return self._soc_pairs(th, ds)

    def cpu_twin(self, problem) -> "SOCOracle":
        # Device-failure fallback (frontier._fallback_oracle): the twin
        # must run the SAME exact SOC solver -- a plain QP twin would
        # silently replace cone solves with the linear relaxation and
        # certify cone-violating leaves.  Solver-semantics kwargs are
        # forwarded like the base Oracle.cpu_twin: n_iter / precision
        # drive the LP joint-bound programs, and a twin with different
        # settings would break the bit-compatibility contract.
        # (rescue_iter / point_schedule / two_phase / warm_start are
        # rejected by __init__ and therefore always at their defaults.)
        return SOCOracle(problem, soc_n_iter=self._soc_n_iter,
                         backend="cpu",
                         n_iter=self.n_iter + self.n_f32,
                         precision=self.precision,
                         n_f32=(self.n_f32 if self.precision == "mixed"
                                else None),
                         points_cap=self.points_cap)

    def point_feasibility(self, thetas, delta_idx):
        # Phase-1 on the LINEAR rows: its "feasible" verdict would be
        # unsound for a cone-constrained problem (LP-feasible does not
        # imply SOC-feasible).  The feasibility-only variant stays
        # QP-scope.
        raise NotImplementedError(
            "feasibility-only variant is QP-scope; SOC partitions run "
            "the 'suboptimal' algorithm")
