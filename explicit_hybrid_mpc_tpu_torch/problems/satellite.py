"""Config 4: satellite reaction-wheel desaturation (6-state, mixed-integer
thruster selection) -- BASELINE.md row 4.

Plant: rigid spacecraft with a spin bias about +z, three reaction wheels
(continuous torques) and three axis-aligned thruster pairs.  State
x = (omega, h): body angular-rate error (3) + wheel momentum (3).
Linearized Euler dynamics about (omega_bar = n e_z, h = 0):

    omega_dot = J^-1 [ (skew(J omega_bar) - skew(omega_bar) J) omega
                       - skew(omega_bar) h  - u_w + T(delta) m ]
    h_dot     = u_w

Wheels torque the body and absorb momentum (they conserve TOTAL angular
momentum J omega + h, so wheels alone cannot desaturate -- the physical
reason thrusters, and hence the integer structure, exist).  Each thruster
pair i has a MINIMUM IMPULSE BOUND: per MPC cycle it is either off, or
fires with |torque| in [u_min, u_max].  The commutation is the per-axis
firing decision delta in {-1, 0, +1}^3 held over the horizon -- 27
commutations, each a convex mp-QP (the reference models the same
min-impulse satellite family with per-thruster binaries solved by Gurobi
B&B; SURVEY.md section 3 "Problem library" [M-med], citation UNVERIFIED --
reference mount empty).

Convexification per commutation: the decision channel m_i >= 0 is the
thrust MAGNITUDE; the firing sign is folded into the input matrix column
and the u_selector, so "fire negative" stays a convex box [u_min, u_max]
on m_i.  Off thrusters get a zeroed input column plus m_i in [0, u_max]:
with R positive definite the optimizer parks m_i at exactly 0, avoiding
empty-interior equality rows that would degrade the IPM.

`axes=1` gives the scalar (omega, h) single-wheel variant (3 commutations,
2-D parameter set) used by fast partition tests; `axes=3` is the full
6-state benchmark.
"""

from __future__ import annotations

import functools
import itertools

import numpy as np

from explicit_hybrid_mpc_tpu_torch.problems import base
from explicit_hybrid_mpc_tpu_torch.problems.registry import register


def _skew(v: np.ndarray) -> np.ndarray:
    return np.array([[0.0, -v[2], v[1]],
                     [v[2], 0.0, -v[0]],
                     [-v[1], v[0], 0.0]])


@register
class Satellite(base.HybridMPC):
    name = "satellite"
    # Row pruning (oracle/prune.py) measured on the 6-D 25%-box config:
    # warm 1.72x at the IDENTICAL 7,744-region tree (96 -> <=14 kept
    # rows per commutation, verified fallbacks) -- the A/B is
    # artifacts/sat_prune_ab_cpu.json; CPU benchmark drivers pick the
    # pruned oracle up via this hint.
    prune_hint = True

    def __init__(self, N: int = 4, dt: float = 2.0, axes: int = 3,
                 J=(5.0, 6.0, 7.0), spin: float = 0.05,
                 u_w_max: float = 0.2, u_min: float = 0.2,
                 u_max: float = 0.5, omega_box: float = 0.12,
                 h_box: float = 1.2, omega_max: float = 0.3,
                 h_max: float = 2.5):
        """spin: rate bias n about +z giving gyroscopic coupling; u_min:
        the min-impulse torque bound (the hybrid structure; u_min > 0);
        omega_box/h_box: half-widths of the partitioned parameter set;
        omega_max/h_max: the (looser) state constraint box."""
        if axes not in (1, 3):
            raise ValueError("axes must be 1 or 3")
        if not 0.0 < u_min < u_max:
            raise ValueError("need 0 < u_min < u_max")
        self.N = N
        self.dt = dt
        self.axes = axes
        self.J = np.asarray(J, dtype=np.float64)[:axes]
        self.spin = spin
        self.u_w_max = u_w_max
        self.u_min = u_min
        self.u_max = u_max
        self.omega_max = omega_max
        self.h_max = h_max
        self.theta_lb = -np.concatenate([np.full(axes, omega_box),
                                         np.full(axes, h_box)])
        self.theta_ub = -self.theta_lb
        self.n_u = 2 * axes   # applied (u_w, signed thruster torque)
        self.root_splits = None
        self.Qc = np.diag(np.concatenate([np.full(axes, 50.0),
                                          np.full(axes, 2.0)]))
        self.Rc = np.diag(np.concatenate([np.full(axes, 1.0),
                                          np.full(axes, 4.0)]))

    @functools.cache
    def _plant(self):
        A_c, B_w_c, B_t_c = self._continuous()
        return base.zoh(A_c, np.hstack([B_w_c, B_t_c]), self.dt)

    def plant_step(self, x, u):
        """u = (wheel torques, SIGNED thruster torques) -- the applied
        input the online controller emits (u_selector folds the firing
        sign into the magnitude channel)."""
        A, B = self._plant()
        return A @ x + B @ u

    def _continuous(self):
        """(A_c, B_w_c, B_t_unit_c): drift, wheel columns, unit-thrust
        columns (sign applied per commutation)."""
        a = self.axes
        Jinv = np.diag(1.0 / self.J)
        if a == 3:
            wbar = np.array([0.0, 0.0, self.spin])
            A_ww = Jinv @ (_skew(np.diag(self.J) @ wbar)
                           - _skew(wbar) @ np.diag(self.J))
            A_wh = Jinv @ (-_skew(wbar))
        else:
            A_ww = np.zeros((1, 1))
            A_wh = np.zeros((1, 1))
        A = np.block([[A_ww, A_wh],
                      [np.zeros((a, a)), np.zeros((a, a))]])
        B_w = np.vstack([-Jinv, np.eye(a)])
        B_t = np.vstack([Jinv, np.zeros((a, a))])
        return A, B_w, B_t

    def build_canonical(self) -> base.CanonicalMPQP:
        a = self.axes
        N = self.N
        A_c, B_w_c, B_t_c = self._continuous()

        Q = np.diag(np.concatenate([np.full(a, 50.0), np.full(a, 2.0)]))
        R = np.diag(np.concatenate([np.full(a, 1.0), np.full(a, 4.0)]))

        # Common terminal weight so V_delta are comparable across
        # commutations (certificate requirement): DARE with ALL actuators
        # at positive sign -- wheels alone leave total momentum
        # uncontrollable and the DARE has no stabilizing solution.
        A_full, B_full = base.zoh(A_c, np.hstack([B_w_c, B_t_c]), self.dt)
        import scipy.linalg
        P = np.asarray(scipy.linalg.solve_discrete_are(A_full, B_full, Q, R))

        x_ub = np.concatenate([np.full(a, self.omega_max),
                               np.full(a, self.h_max)])
        Cx, cx = base.box_rows(-x_ub, x_ub)

        slices, deltas = [], list(itertools.product((-1, 0, 1), repeat=a))
        for delta in deltas:
            s = np.asarray(delta, dtype=np.float64)
            # Signs folded into the thruster columns; off columns zeroed.
            Ad, Bd = base.zoh(A_c, np.hstack([B_w_c, B_t_c @ np.diag(s)]),
                              self.dt)
            # Magnitude boxes: on-axis [u_min, u_max], off-axis [0, u_max].
            m_lb = np.where(s != 0.0, self.u_min, 0.0)
            Cu, cu = base.box_rows(
                np.concatenate([np.full(a, -self.u_w_max), m_lb]),
                np.concatenate([np.full(a, self.u_w_max),
                                np.full(a, self.u_max)]))
            sel = np.diag(np.concatenate([np.ones(a), s]))
            slices.append(base.condense(
                A_seq=[Ad] * N, B_seq=[Bd] * N,
                e_seq=[np.zeros(2 * a)] * N,
                Q=Q, R=R, P=P, E=np.eye(2 * a), x_nom=np.zeros(2 * a),
                n_u=2 * a, state_con=[(Cx, cx)] * N,
                input_con=[(Cu, cu)] * N, u_selector=sel))
        return base.stack_slices(
            slices, deltas=np.asarray(deltas, dtype=np.int64))
