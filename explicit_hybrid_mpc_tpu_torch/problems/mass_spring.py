"""Config 2: constrained LQR mp-QP on a 4-state mass-spring chain, N=10 --
BASELINE.md row 2.  Two masses coupled by springs, one force input on the
first mass; tight input bounds make the constrained region structure
non-trivial.  Pure mp-QP (single commutation).
"""

from __future__ import annotations

import functools

import numpy as np

from explicit_hybrid_mpc_tpu_torch.problems import base
from explicit_hybrid_mpc_tpu_torch.problems.registry import register


@register
class MassSpring(base.HybridMPC):
    name = "mass_spring"

    def __init__(self, N: int = 10, dt: float = 0.2, theta_box: float = 2.0,
                 u_max: float = 0.5, x_max: float = 4.0):
        self.N = N
        self.dt = dt
        self.u_max = u_max
        self.x_max = x_max
        self.theta_lb = -theta_box * np.ones(4)
        self.theta_ub = theta_box * np.ones(4)
        self.n_u = 1
        self.Qc = np.diag([1.0, 0.1, 1.0, 0.1])
        self.Rc = np.array([[0.5]])

    @staticmethod
    def _continuous():
        # Two unit masses, springs k=1 wall-m1-m2, light damping.
        k, c = 1.0, 0.1
        Ac = np.array([
            [0.0, 1.0, 0.0, 0.0],
            [-2 * k, -c, k, 0.0],
            [0.0, 0.0, 0.0, 1.0],
            [k, 0.0, -k, -c],
        ])
        Bc = np.array([[0.0], [1.0], [0.0], [0.0]])
        return Ac, Bc

    @functools.cache
    def _plant(self):
        return base.zoh(*self._continuous(), self.dt)

    def plant_step(self, x, u):
        A, B = self._plant()
        return A @ x + B @ u

    def build_canonical(self) -> base.CanonicalMPQP:
        Ac, Bc = self._continuous()
        A, B = base.zoh(Ac, Bc, self.dt)
        N = self.N
        Q = np.diag([1.0, 0.1, 1.0, 0.1])
        R = np.array([[0.5]])
        import scipy.linalg

        P = np.asarray(scipy.linalg.solve_discrete_are(A, B, Q, R))
        Cx, cx = base.box_rows(-self.x_max * np.ones(4), self.x_max * np.ones(4))
        Cu, cu = base.box_rows(np.array([-self.u_max]), np.array([self.u_max]))
        sl = base.condense(
            A_seq=[A] * N, B_seq=[B] * N, e_seq=[np.zeros(4)] * N,
            Q=Q, R=R, P=P, E=np.eye(4), x_nom=np.zeros(4), n_u=1,
            state_con=[(Cx, cx)] * N, input_con=[(Cu, cu)] * N,
        )
        return base.stack_slices([sl], deltas=np.zeros((1, 0), dtype=np.int64))
