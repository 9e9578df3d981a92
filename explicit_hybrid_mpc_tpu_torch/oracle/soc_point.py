"""Point-query oracle for SOC-constrained hybrid problems (torch), as in
the JAX package's oracle/soc_point.py.

The MICP-at-a-point query for problems whose fixed-commutation
subproblem is an SOCP rather than a QP: batched socp_solve over the
(points x commutations) grid with first-minimum delta reduction -- the
same enumeration-replaces-B&B design as oracle.Oracle, restricted to
the queries the SOC class supports:

  - solve_vertices: full MICP at parameter points (V, usable, u0,
    Vstar, dstar);
  - solve_fixed: fixed-commutation online solve, mirroring
    Oracle.solve_fixed's (u0, V, conv, z) arity and the n_solves/
    n_point_solves counters, so a semi-explicit controller can deploy
    it unchanged.

NOT provided (certified SOC partitions run oracle/soc_oracle.py):
envelope-theorem cost gradients, joint simplex-wide minima, Farkas
infeasibility certificates.

Runs on the first CUDA device unless the caller passes device='cpu'.
"""

from __future__ import annotations

import numpy as np
import torch

from explicit_hybrid_mpc_tpu_torch import device as device_lib
from explicit_hybrid_mpc_tpu_torch.oracle.oracle import _bmv, _np, to_device
from explicit_hybrid_mpc_tpu_torch.oracle.socp import socp_solve


# tpulint: device-region
def soc_pairs(prob, Ac: torch.Tensor, bc: torch.Tensor,
              thetas: torch.Tensor, ds: torch.Tensor, n_iter: int):
    """The fixed-commutation SOCPs at (point, commutation) pairs: thetas
    (K, n_theta), ds (K,), the cones (Ac (Kc, m, nz), bc (Kc, m)) shared
    by every commutation.  Returns (sol, V, u0): socp_solve's solution,
    the value with its theta terms, and the first move."""
    K = thetas.shape[0]
    q = prob.f[ds] + _bmv(prob.F[ds], thetas)
    b = prob.w[ds] + _bmv(prob.S[ds], thetas)
    sol = socp_solve(prob.H[ds], q, prob.G[ds], b,
                     Ac.expand((K,) + Ac.shape), bc.expand((K,) + bc.shape),
                     n_iter=n_iter)
    tc = (0.5 * torch.sum(thetas * _bmv(prob.Y[ds], thetas), dim=-1)
          + torch.sum(prob.pvec[ds] * thetas, dim=-1) + prob.cconst[ds])
    u0 = (_bmv(prob.u_map[ds], sol.z) + _bmv(prob.u_theta[ds], thetas)
          + prob.u_const[ds])
    return sol, sol.obj + tc, u0


class SOCPointOracle:
    def __init__(self, problem, n_iter: int = 60, device="cuda"):
        can = problem.canonical
        Ac, bc = problem.soc_cones()
        self.problem = problem
        self.can = can
        self.n_delta = can.n_delta
        self.n_iter = n_iter
        self.device = device_lib.resolve(device)
        self.prob = to_device(can, self.device)
        self._Ac = torch.as_tensor(Ac, dtype=torch.float64).to(self.device)
        self._bc = torch.as_tensor(bc, dtype=torch.float64).to(self.device)
        self.n_solves = 0
        self.n_point_solves = 0

    # tpulint: device-region
    def _solve(self, thetas: np.ndarray, ds: np.ndarray):
        th = torch.as_tensor(thetas, dtype=torch.float64).to(self.device)
        dj = torch.as_tensor(ds, dtype=torch.int64).to(self.device)
        sol, V, u0 = soc_pairs(self.prob, self._Ac, self._bc, th, dj,
                               self.n_iter)
        # `usable` is the value-quality gate for the delta reduction: a
        # minority of cone instances stall with the primal exact (rp ~
        # 1e-16, gap tiny) but the dual residual frozen around 1e-7 --
        # their objective is accurate to ~1e-5 relative, which is what
        # the POINT-QUERY scope needs.  `conv` stays the strict 1e-8 KKT
        # flag.
        usable = sol.converged | (sol.feasible & (sol.gap < 1e-5)
                                  & (sol.rd < 1e-4))
        return V, usable, u0, sol.z

    def solve_vertices(self, thetas: np.ndarray):
        """(V, usable, u0, Vstar, dstar) over the full commutation grid;
        first-minimum tie-break over USABLE values (deterministic,
        matching oracle.reduce_deltas)."""
        thetas = np.atleast_2d(np.asarray(thetas, dtype=np.float64))
        P, nd = thetas.shape[0], self.n_delta
        V, usable, u0, _z = self._solve(
            np.repeat(thetas, nd, axis=0), np.tile(np.arange(nd), P))
        self.n_solves += P * nd
        self.n_point_solves += P * nd
        V = V.reshape(P, nd)
        usable = usable.reshape(P, nd)
        Vval = torch.where(usable, V, torch.full_like(V, np.inf))
        dstar = torch.argmin(Vval, dim=-1)
        Vstar = torch.gather(Vval, -1, dstar[:, None])[:, 0]
        dstar = torch.where(torch.isfinite(Vstar), dstar,
                            torch.full_like(dstar, -1))
        return (_np(V), _np(usable), _np(u0.reshape(P, nd, -1)),
                _np(Vstar), _np(dstar))

    def solve_fixed(self, thetas: np.ndarray, delta_idx: np.ndarray):
        """Online fixed-commutation SOCP (semi-explicit deployment):
        (u0, V, conv, z) with conv = the usable-quality flag (see
        solve_vertices) -- Oracle.solve_fixed's arity."""
        thetas = np.atleast_2d(np.asarray(thetas, dtype=np.float64))
        ds = np.atleast_1d(delta_idx).astype(np.int64)
        V, usable, u0, z = self._solve(thetas, ds)
        self.n_solves += thetas.shape[0]
        self.n_point_solves += thetas.shape[0]
        return _np(u0), _np(V), _np(usable), _np(z)
