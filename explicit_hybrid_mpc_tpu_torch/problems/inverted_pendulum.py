"""Config 3: inverted-pendulum hybrid MPC (2 PWA modes, mp-MIQP) --
BASELINE.md row 3, and the north-star headline benchmark.

Plant: torque-controlled inverted pendulum linearized about upright, with
an elastic wall at angle 0 on the positive side:

    mode 0 (free,    th <= 0):  thdd = a*th            + u
    mode 1 (contact, th >= 0):  thdd = (a - ks)*th     + u

The PWA vector field is continuous at the mode boundary (the wall force
ks*th vanishes at th = 0), so the optimal value function is continuous and
the eps-suboptimal partition is well posed.

Hybrid encoding: the commutation delta in {0,1}^N is the mode *sequence*
over the horizon.  For fixed delta, the dynamics are the time-varying
linear sequence A_{delta_k} and mode *membership* becomes linear state
constraints (step k's mode constrains x_k: th_k <= 0 for mode 0,
-th_k <= 0 for mode 1).  Enumerating all 2^N sequences turns the MIQP into
a batch of 2^N mp-QPs solved by one vmapped kernel -- the TPU-native
replacement for branch-and-bound (SURVEY.md section 8 layer 2; the
reference solves the same problem with Gurobi's B&B through cvxpy
[M-high], citation UNVERIFIED -- reference mount empty).
"""

from __future__ import annotations

import itertools

import numpy as np

from explicit_hybrid_mpc_tpu_torch.problems import base
from explicit_hybrid_mpc_tpu_torch.problems.registry import register


@register
class InvertedPendulum(base.HybridMPC):
    name = "inverted_pendulum"

    def __init__(self, N: int = 5, dt: float = 0.1, a: float = 2.0,
                 ks: float = 10.0, theta_box=(0.4, 1.0), u_max: float = 8.0,
                 th_max: float = 1.2, w_max: float = 4.0):
        """a: unstable pole strength g/l; ks: wall spring stiffness
        (ks > a so contact is restoring); theta_box: half-widths of the
        partitioned (th, thdot) set; u_max sized so the whole box is
        N-step recoverable (keeps infeasible leaves at the margins)."""
        if ks <= a:
            raise ValueError("need ks > a for a restoring wall")
        self.N = N
        self.dt = dt
        self.a = a
        self.ks = ks
        self.u_max = u_max
        self.th_max = th_max
        self.w_max = w_max
        self.theta_lb = -np.asarray(theta_box, dtype=np.float64)
        self.theta_ub = np.asarray(theta_box, dtype=np.float64)
        self.n_u = 1
        # The step-0 mode membership flips across the wall th = 0, a fixed
        # hyperplane in theta: root cells must align with it (see
        # geometry.box_triangulation).
        self.root_splits = {0: (0.0,)}
        self.Qc = np.diag([4.0, 0.4])
        self.Rc = np.array([[0.2]])

    def plant_step(self, x, u):
        """PWA plant: mode by the wall side of the CURRENT angle, matching
        the prediction model's Euler discretization (build_canonical)."""
        a_eff = self.a if x[0] <= 0.0 else self.a - self.ks
        A = np.eye(2) + self.dt * np.array([[0.0, 1.0], [a_eff, 0.0]])
        B = np.array([[0.5 * self.dt ** 2], [self.dt]])
        return A @ x + B @ u

    def build_canonical(self) -> base.CanonicalMPQP:
        B_c = np.array([[0.0], [1.0]])
        A_free = np.array([[0.0, 1.0], [self.a, 0.0]])
        A_wall = np.array([[0.0, 1.0], [self.a - self.ks, 0.0]])
        # Forward Euler in A, NOT ZOH: per-mode ZOH lets the chosen mode
        # act over the whole interval even after the trajectory crosses
        # the wall, making the discrete PWA map (and hence V*) jump at
        # th = 0.  Euler is affine in the continuous-time field, which the
        # two modes share at the boundary, so the discrete map stays
        # continuous.  B is the double-integrator second-order hold
        # [dt^2/2, dt], IDENTICAL for both modes (mode-independent B
        # preserves continuity): actuating the angle at second order gives
        # every later-step mode-membership hyperplane a control band of
        # half-width (dt^2/2) u_max, so simplices near those lines certify
        # at finite depth instead of refining forever.
        dt = self.dt
        Bd = np.array([[0.5 * dt * dt], [dt]])
        AB = [(np.eye(2) + dt * A_free, Bd),
              (np.eye(2) + dt * A_wall, Bd)]

        N = self.N
        Q = np.diag([4.0, 0.4])
        R = np.array([[0.2]])
        P = _dare(AB[0][0], AB[0][1], Q, R)  # free-mode terminal weight
        x_lb = np.array([-self.th_max, -self.w_max])
        Cbox, cbox = base.box_rows(x_lb, -x_lb)
        Cu, cu = base.box_rows(np.array([-self.u_max]),
                               np.array([self.u_max]))
        # Mode-membership half-space on the angle: mode 0 needs th <= 0,
        # mode 1 needs -th <= 0.
        mode_row = {0: (np.array([[1.0, 0.0]]), np.zeros(1)),
                    1: (np.array([[-1.0, 0.0]]), np.zeros(1))}

        slices = []
        deltas = list(itertools.product((0, 1), repeat=N))
        for delta in deltas:
            A_seq = [AB[m][0] for m in delta]
            B_seq = [AB[m][1] for m in delta]
            # state_con[k] constrains x_{k+1}: box everywhere, plus the
            # membership row of the mode ACTIVE AT step k+1 (x_N, beyond
            # the last mode decision, gets the box only).
            state_con = []
            for k in range(N):
                if k + 1 < N:
                    Cm, cm = mode_row[delta[k + 1]]
                    state_con.append((np.vstack([Cbox, Cm]),
                                      np.concatenate([cbox, cm])))
                else:
                    state_con.append((Cbox, cbox))
            # Step 0's mode constrains x_0 = theta directly.
            Cm0, cm0 = mode_row[delta[0]]
            slices.append(base.condense(
                A_seq=A_seq, B_seq=B_seq, e_seq=[np.zeros(2)] * N,
                Q=Q, R=R, P=P, E=np.eye(2), x_nom=np.zeros(2), n_u=1,
                state_con=state_con, input_con=[(Cu, cu)] * N,
                theta_con=(Cm0, cm0)))
        return base.stack_slices(
            slices, deltas=np.asarray(deltas, dtype=np.int64))


def _dare(A, B, Q, R):
    import scipy.linalg

    return np.asarray(scipy.linalg.solve_discrete_are(A, B, Q, R))
