"""Config 1: double-integrator explicit MPC (2-state, 1-input, N=5, box
constraints) -- BASELINE.md row 1.  Pure mp-QP (single commutation): the
minimum end-to-end slice of SURVEY.md section 8 exercises every layer except
delta-enumeration on this problem.
"""

from __future__ import annotations

import functools

import numpy as np

from explicit_hybrid_mpc_tpu_torch.problems import base
from explicit_hybrid_mpc_tpu_torch.problems.registry import register


@register
class DoubleIntegrator(base.HybridMPC):
    name = "double_integrator"

    # x_max default keeps the whole Theta box inside the N-step feasible
    # set (|pos| grows at most theta_box * (1 + N*dt) from any corner), so
    # the partition terminates without depth-capped boundary cells.
    def __init__(self, N: int = 5, dt: float = 0.25,
                 theta_box: float = 3.0, u_max: float = 1.0,
                 x_max: float = 10.0):
        self.N = N
        self.dt = dt
        self.u_max = u_max
        self.x_max = x_max
        self.theta_lb = -theta_box * np.ones(2)
        self.theta_ub = theta_box * np.ones(2)
        self.n_u = 1
        self.Qc = np.diag([1.0, 0.1])
        self.Rc = np.array([[0.1]])

    @functools.cache
    def _plant(self):
        Ac = np.array([[0.0, 1.0], [0.0, 0.0]])
        Bc = np.array([[0.0], [1.0]])
        return base.zoh(Ac, Bc, self.dt)

    def plant_step(self, x, u):
        A, B = self._plant()
        return A @ x + B @ u

    def build_canonical(self) -> base.CanonicalMPQP:
        A, B = self._plant()
        N = self.N
        Q = np.diag([1.0, 0.1])
        R = np.array([[0.1]])
        # Discrete LQR terminal weight for stability-flavoured cost.
        P = _dare(A, B, Q, R)
        Cx, cx = base.box_rows(-self.x_max * np.ones(2), self.x_max * np.ones(2))
        Cu, cu = base.box_rows(np.array([-self.u_max]), np.array([self.u_max]))
        sl = base.condense(
            A_seq=[A] * N, B_seq=[B] * N, e_seq=[np.zeros(2)] * N,
            Q=Q, R=R, P=P, E=np.eye(2), x_nom=np.zeros(2), n_u=1,
            state_con=[(Cx, cx)] * N, input_con=[(Cu, cu)] * N,
        )
        return base.stack_slices([sl], deltas=np.zeros((1, 0), dtype=np.int64))


def _dare(A, B, Q, R):
    import scipy.linalg

    return np.asarray(scipy.linalg.solve_discrete_are(A, B, Q, R))
