"""Config 5: 6-DOF quadrotor obstacle avoidance (12-state, 8 integer mode
vars, N=10) -- BASELINE.md row 5.

Plant: hover-linearized quadrotor, x = (p, v, att, omega) in R^12 with
p position, v velocity, att = (roll, pitch, yaw) small angles, omega body
rates; u = (thrust delta, 3 torques).  Near hover:

    p_dot = v,   v_dot = g (pitch, -roll, 0) + (0, 0, dT/m),
    att_dot = omega,   omega_dot = J^-1 tau.

Hybrid structure: two axis-aligned box obstacles in the (x, y) plane.  The
mixed-integer encoding assigns each obstacle a one-hot choice of WHICH
FACE the whole predicted trajectory stays clear of (left/right/front/
back) -- 2 obstacles x 4 one-hot binaries = the config's 8 integer mode
vars, 16 valid assignments.  For a fixed assignment the avoidance rows are
linear in the state, so each commutation is a convex mp-QP; the 16-way
enumeration replaces the big-M branch-and-bound the reference's Gurobi
oracle would run (SURVEY.md section 8 layer 2; reference encoding
UNVERIFIED -- mount empty).

The avoidance rows are SOFT (quadratic-penalty slacks, base.soften):
hard rows would put the feasible parameter set's boundary on a
dynamics-dependent surface slightly off the obstacle faces, and simplices
straddling that surface can never certify (they subdivide to the depth
cap).  With the penalty, every commutation is feasible everywhere, V* is
continuous on all of Theta, and the mode structure (which side to pass)
lives in the cost, where the eps-certificate can decide it.

Side-choice-per-horizon is a restriction of per-step big-M (a trajectory
may not switch faces mid-horizon); it upper-bounds the big-M optimal cost
while preserving feasibility for the maneuvers the benchmark exercises,
and it is what keeps the commutation set enumerable (SURVEY.md section 8:
enumeration requires finite, small Delta).

The partitioned parameter is the initial (px, py, vx, vy) slice, theta in
R^4, embedded into x0 by E (altitude/attitude start at hover nominal):
partitioning all 12 states is neither useful (attitude transients are
fast) nor tractable for a simplicial partition (the Kuhn triangulation of
a 12-box has 12! roots).
"""

from __future__ import annotations

import functools

import numpy as np

from explicit_hybrid_mpc_tpu_torch.problems import base
from explicit_hybrid_mpc_tpu_torch.problems.registry import register

# Face selections per obstacle: (normal sign, axis).  "left of" = stay at
# x <= cx - w  <=>  +x row; encoded one-hot over 4 faces.
_FACES = ((-1, 0), (+1, 0), (-1, 1), (+1, 1))


@register
class Quadrotor(base.HybridMPC):
    name = "quadrotor"
    # Every commutation is feasible everywhere (the avoidance rows are
    # softened), so stage-2's hybrid phase1-first default would run a
    # 360-row joint phase-1 per pair that never excludes anything;
    # min-first lets the elastic minimum's own t=0 witness prove
    # feasibility and reserves phase-1 for the (empty) remainder.
    stage2_hint = "min_first"
    # The mixed schedule's f32 phase collapses on this problem (60% of
    # point solves unconverged after the short f64 polish, r4 A/B in
    # artifacts/quad_prune_ab_cpu.json): CPU benchmark drivers should
    # run full f64 (4x faster end-to-end); TPU keeps mixed (emulated
    # f64 changes the tradeoff -- to be re-measured on-chip).
    cpu_precision_hint = "f64"
    # Row-heavy config (nc=360): benchmark drivers should use the
    # pruned oracle on CPU (measured 2.87x at the identical tree).
    prune_hint = True

    def __init__(self, N: int = 10, dt: float = 0.25, mass: float = 1.0,
                 g: float = 9.81, J=(0.01, 0.01, 0.02),
                 obstacles=(((1.5, 0.0), 0.6), ((-1.5, 0.0), 0.6)),
                 pos_box: float = 4.0, vel_box: float = 2.0,
                 pos_max: float = 5.0, vel_max: float = 3.0,
                 tilt_max: float = 0.35, rate_max: float = 2.0,
                 dT_max: float = 5.0, tau_max: float = 0.15,
                 param: str = "pv", obs_rho: float = 200.0):
        """obstacles: ((cx, cy), half_width) axis-aligned squares the
        trajectory keeps one face clear of; pos_box/vel_box: half-widths
        of the partitioned (px, py, vx, vy) set; *_max: state/input
        constraint boxes (looser than the parameter box); param: which
        initial-condition slice is the partitioned parameter -- "pv" =
        (px, py, vx, vy) (the benchmark), "p" = (px, py) only (2-D,
        for fast tests/figures)."""
        if param not in ("pv", "p"):
            raise ValueError("param must be 'pv' or 'p'")
        self.param = param
        self.obs_rho = obs_rho
        self.N = N
        self.dt = dt
        self.mass = mass
        self.g = g
        self.J = np.asarray(J, dtype=np.float64)
        self.obstacles = tuple(((float(c[0]), float(c[1])), float(w))
                               for c, w in obstacles)
        self.pos_max = pos_max
        self.vel_max = vel_max
        self.tilt_max = tilt_max
        self.rate_max = rate_max
        self.dT_max = dT_max
        self.tau_max = tau_max
        if param == "pv":
            self.theta_lb = -np.array([pos_box, pos_box, vel_box, vel_box])
        else:
            self.theta_lb = -np.array([pos_box, pos_box])
        self.theta_ub = -self.theta_lb
        self.n_u = 4
        self.Qc = np.diag([4.0, 4.0, 4.0, 1.0, 1.0, 1.0,
                           2.0, 2.0, 2.0, 0.5, 0.5, 0.5])
        self.Rc = np.diag([0.1, 0.5, 0.5, 0.5])
        # Obstacle faces are fixed hyperplanes in (px, py); align root
        # cells so near-edge simplices certify at finite depth.
        xs, ys = set(), set()
        for (cx, cy), w in self.obstacles:
            for val, box, acc in ((cx, pos_box, xs), (cy, pos_box, ys)):
                for edge in (val - w, val + w):
                    if -box < edge < box:
                        acc.add(round(edge, 12))
        self.root_splits = {}
        if xs:
            self.root_splits[0] = tuple(sorted(xs))
        if ys:
            self.root_splits[1] = tuple(sorted(ys))

    def plant_step(self, x, u):
        Ad, Bd = self._discrete()
        return Ad @ x + Bd @ u

    def theta_of_state(self, x):
        """Project the 12-state onto the partitioned slice.  The explicit
        law is exact on the slice and an approximation off it (attitude
        transients are treated as disturbances by the closed loop)."""
        idx = [0, 1, 3, 4] if self.param == "pv" else [0, 1]
        return np.asarray(x, dtype=np.float64)[idx]

    def state_of_theta(self, theta):
        x = np.zeros(12)
        x[0], x[1] = theta[0], theta[1]
        if self.param == "pv":
            x[3], x[4] = theta[2], theta[3]
        return x

    @functools.cache
    def _discrete(self):
        g, m = self.g, self.mass
        A = np.zeros((12, 12))
        A[0:3, 3:6] = np.eye(3)            # p_dot = v
        A[3, 7] = g                         # vx_dot =  g * pitch
        A[4, 6] = -g                        # vy_dot = -g * roll
        A[6:9, 9:12] = np.eye(3)           # att_dot = omega
        B = np.zeros((12, 4))
        B[5, 0] = 1.0 / m                  # vz_dot = dT/m
        B[9:12, 1:4] = np.diag(1.0 / self.J)
        return base.zoh(A, B, self.dt)

    def build_canonical(self) -> base.CanonicalMPQP:
        N = self.N
        Ad, Bd = self._discrete()
        E = np.zeros((12, self.n_theta))
        E[0, 0] = E[1, 1] = 1.0
        if self.param == "pv":
            E[3, 2] = E[4, 3] = 1.0

        Q = np.diag([4.0, 4.0, 4.0, 1.0, 1.0, 1.0,
                     2.0, 2.0, 2.0, 0.5, 0.5, 0.5])
        R = np.diag([0.1, 0.5, 0.5, 0.5])
        import scipy.linalg
        P = np.asarray(scipy.linalg.solve_discrete_are(Ad, Bd, Q, R))

        # State rows: position, velocity, tilt, rates (yaw box too).
        Cx_rows, cx_rows = [], []
        for idx, lim in ((range(0, 3), self.pos_max),
                         (range(3, 6), self.vel_max),
                         (range(6, 9), self.tilt_max),
                         (range(9, 12), self.rate_max)):
            for i in idx:
                e = np.zeros(12)
                e[i] = 1.0
                Cx_rows += [e, -e]
                cx_rows += [lim, lim]
        Cx = np.stack(Cx_rows)
        cx = np.asarray(cx_rows, dtype=np.float64)
        Cu, cu = base.box_rows(
            np.array([-self.dT_max] + [-self.tau_max] * 3),
            np.array([self.dT_max] + [self.tau_max] * 3))

        # Prestabilizing LQR gain: condensing the (unstable) 12-state
        # linearization open-loop over N=10 grows H entries with powers
        # of A (cond(H) ~ 3e8 -- stalls fixed-iteration IPMs and makes
        # the f32 phase of the mixed schedule useless); condensing the
        # closed loop u = Kx + v keeps H near the weight scale.  Exact
        # substitution: same value function and applied inputs
        # (tests/test_problems.py equivalence test).  K_pre is derived
        # from the SAME DARE solution P used as the terminal cost above
        # -- that pairing is load-bearing: it is the completion-of-
        # squares identity that makes the condensed Hessian essentially
        # diagonal (scaled cond ~1.0, docs/perf.md).
        K_pre = -np.linalg.solve(R + Bd.T @ P @ Bd, Bd.T @ P @ Ad)

        slices, deltas = [], []
        for f0 in range(4):
            for f1 in range(4):
                rows, offs = [], []
                for (face, ((cxy), w)) in zip(
                        (f0, f1), self.obstacles):
                    sgn, ax = _FACES[face]
                    # stay clear of face: sgn * p_ax >= sgn * c_ax + w
                    # <=>  -sgn * p_ax <= -(sgn * c_ax + w)
                    row = np.zeros(12)
                    row[ax] = -sgn
                    rows.append(row)
                    offs.append(-(sgn * cxy[ax] + w))
                C_obs = np.stack(rows)
                c_obs = np.asarray(offs, dtype=np.float64)
                Call = np.vstack([Cx, C_obs])
                call = np.concatenate([cx, c_obs])
                sl = base.condense(
                    A_seq=[Ad] * N, B_seq=[Bd] * N,
                    e_seq=[np.zeros(12)] * N,
                    Q=Q, R=R, P=P, E=E, x_nom=np.zeros(12), n_u=4,
                    state_con=[(Call, call)] * N,
                    input_con=[(Cu, cu)] * N, K_prestab=K_pre)
                # Obstacle rows are the trailing 2 rows of each step's
                # 26-row state block.  Hard avoidance makes the feasible
                # set's boundary a dynamics-dependent surface slightly off
                # the obstacle faces -- simplices straddling it never
                # certify; the quadratic penalty (exact enough at rho for
                # the benchmark's clearances) keeps V* continuous on all
                # of Theta (see base.soften).
                nrow = Call.shape[0]
                obs_rows = np.concatenate(
                    [k * nrow + np.arange(Cx.shape[0], nrow)
                     for k in range(N)])
                slices.append(base.soften(sl, obs_rows, rho=self.obs_rho))
                # Report as the 8-bit one-hot integer encoding.
                bits = np.zeros(8, dtype=np.int64)
                bits[f0] = 1
                bits[4 + f1] = 1
                deltas.append(bits)
        return base.stack_slices(slices, deltas=np.stack(deltas))
