"""Hybrid MPC problem canonicalization.

The reference builds cvxpy programs once per process and re-solves them with
new parameter values in the hot loop (SURVEY.md section 4.4, [M-med]).  The
TPU-native analogue canonicalizes ONCE on the host to dense matrices; the
device kernel then consumes only parameter vectors.  Concretely, every
problem is reduced to a *family of multiparametric QPs indexed by the integer
commutation delta*:

    V_delta(theta) = min_z  1/2 z'H z + (f + F theta)'z
                            + 1/2 theta'Y theta + p'theta + c
                     s.t.   G z <= w + S theta

with one matrix slice per delta, stacked along axis 0 so a single vmapped
interior-point kernel solves (points x commutations) in one shot
(BASELINE.json north-star: enumeration over the finite commutation set
replaces Gurobi's branch-and-bound -- sound because every benchmark's delta
set is finite and enumerable, SURVEY.md section 8 layer 2).

The MICP value function is V*(theta) = min_delta V_delta(theta); its
eps-suboptimal PWA approximation is what the partitioner builds.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class CanonicalMPQP:
    """Stacked per-commutation mp-QP data (all float64 numpy, host-resident).

    Shapes: n_delta commutations, nz decision vars, nc constraint rows
    (padded to a common count across commutations with vacuous rows
    0'z <= 1), n_theta parameters.
    """

    H: np.ndarray      # (nd, nz, nz) PD Hessian
    f: np.ndarray      # (nd, nz)
    F: np.ndarray      # (nd, nz, n_theta)
    G: np.ndarray      # (nd, nc, nz)
    w: np.ndarray      # (nd, nc)
    S: np.ndarray      # (nd, nc, n_theta)
    Y: np.ndarray      # (nd, n_theta, n_theta) theta-quadratic cost term
    pvec: np.ndarray   # (nd, n_theta)  theta-linear cost term
    cconst: np.ndarray  # (nd,) constant cost term
    # First applied control move: u0 = u_map[d] @ z + u_theta[d] @ theta
    # + u_const[d].  The affine theta part is nonzero only under
    # prestabilized condensing (z holds v, u = K x + v).
    u_map: np.ndarray  # (nd, n_u, nz)
    u_theta: np.ndarray  # (nd, n_u, n_theta)
    u_const: np.ndarray  # (nd, n_u)
    deltas: np.ndarray  # (nd, m) integer encodings, for reporting/tie-breaks

    @property
    def n_delta(self) -> int:
        return self.H.shape[0]

    @property
    def nz(self) -> int:
        return self.H.shape[1]

    @property
    def nc(self) -> int:
        return self.G.shape[1]

    @property
    def n_theta(self) -> int:
        return self.F.shape[2]

    @property
    def n_u(self) -> int:
        return self.u_map.shape[1]

    def value(self, d: int, theta: np.ndarray, z: np.ndarray) -> float:
        """Objective of commutation d at (theta, z) -- for tests/checks."""
        th = np.asarray(theta, dtype=np.float64)
        return float(
            0.5 * z @ self.H[d] @ z + (self.f[d] + self.F[d] @ th) @ z
            + 0.5 * th @ self.Y[d] @ th + self.pvec[d] @ th + self.cconst[d]
        )


def canonical_from_arrays(arrays: dict) -> CanonicalMPQP:
    """A CanonicalMPQP from a dict of arrays keyed by field name -- the
    bridge that carries another implementation's canonical matrices (for
    example the JAX package's, as ``{f.name: getattr(can, f.name)}``)
    into this package unchanged.  Float fields become float64, the delta
    encodings int64; a missing or extra key raises."""
    names = [f.name for f in dataclasses.fields(CanonicalMPQP)]
    if set(arrays) != set(names):
        raise KeyError(f"canonical arrays need exactly {names}, got "
                       f"{sorted(arrays)}")
    return CanonicalMPQP(**{
        k: np.array(arrays[k], dtype=np.int64 if k == "deltas"
                    else np.float64) for k in names})


@dataclasses.dataclass(frozen=True)
class CondensedSlice:
    """One commutation's canonical matrices before stacking/padding."""

    H: np.ndarray
    f: np.ndarray
    F: np.ndarray
    G: np.ndarray
    w: np.ndarray
    S: np.ndarray
    Y: np.ndarray
    pvec: np.ndarray
    cconst: float
    u_map: np.ndarray
    # Affine-in-theta part of u0 (prestabilized condensing; zero otherwise).
    u_theta: np.ndarray | None = None
    u_const: np.ndarray | None = None


def condense(
    A_seq: Sequence[np.ndarray],
    B_seq: Sequence[np.ndarray],
    e_seq: Sequence[np.ndarray],
    Q: np.ndarray,
    R: np.ndarray,
    P: np.ndarray,
    E: np.ndarray,
    x_nom: np.ndarray,
    n_u: int,
    state_con: Optional[Sequence[tuple[np.ndarray, np.ndarray]]] = None,
    input_con: Optional[Sequence[tuple[np.ndarray, np.ndarray]]] = None,
    theta_con: Optional[tuple[np.ndarray, np.ndarray]] = None,
    u_selector: Optional[np.ndarray] = None,
    K_prestab: Optional[np.ndarray] = None,
) -> CondensedSlice:
    """Condense one fixed-commutation linear MPC into an mp-QP slice.

    Dynamics (commutation-dependent, time-varying):
        x_{k+1} = A_k x_k + B_k u_k + e_k,   k = 0..N-1,
        x_0 = x_nom + E theta                 (theta embeds into the state).
    Cost: sum_k 1/2 x_k'Q x_k + 1/2 u_k'R u_k  (k=0..N-1)  + 1/2 x_N'P x_N.
    Constraints:
        state_con[k] = (Cx, cx): Cx x_{k+1} <= cx  for step k (on x_1..x_N),
        input_con[k] = (Cu, cu): Cu u_k <= cu,
        theta_con = (Ct, ct):    Ct theta <= ct  (pure parameter rows, e.g.
                                 mode-region membership of x_0).
    The decision vector is z = [u_0; ...; u_{N-1}].  u_selector (n_u x n_u,
    default identity) maps z's first block to the physically applied input
    (e.g. zeroing thrusters that this commutation switches off).

    Returns the slice of V_delta(theta) = min_z 1/2 z'Hz + (f+F theta)'z
    + theta-terms s.t. Gz <= w + S theta, with the theta-only cost terms kept
    so that value functions are comparable ACROSS commutations (required by
    the eps-suboptimality certificates, SURVEY.md section 8 "certificate
    math").

    K_prestab: optional (m, n_x) feedback gain for CLOSED-LOOP condensing
    (u_k = K x_k + v_k; the decision vector becomes v).  An EXACT variable
    substitution -- same value function, same applied inputs -- whose
    point is conditioning: condensing an unstable plant open-loop grows
    H entries with powers of A (quadrotor: cond(H) ~ 3e8), while the
    prestabilized A + BK keeps H near the weight scale so the f32-bulk
    mixed IPM schedule stays usable on TPU.  Constraint row ORDER matches
    the open-loop path exactly (soften() indexes rows by position).
    """
    if K_prestab is not None:
        return _condense_prestab(
            A_seq, B_seq, e_seq, Q, R, P, E, x_nom, n_u,
            np.asarray(K_prestab, dtype=np.float64),
            state_con, input_con, theta_con, u_selector)
    N = len(A_seq)
    n_x = A_seq[0].shape[0]
    m = B_seq[0].shape[1]
    nz = N * m
    E = np.asarray(E, dtype=np.float64)
    n_theta = E.shape[1]
    x_nom = np.asarray(x_nom, dtype=np.float64)

    # Prediction matrices: X = Phi x0 + Gam z + phi with X = [x_1..x_N].
    Phi = np.zeros((N * n_x, n_x))
    Gam = np.zeros((N * n_x, nz))
    phi = np.zeros(N * n_x)
    for k in range(N):
        rows = slice(k * n_x, (k + 1) * n_x)
        if k == 0:
            Phi[rows] = A_seq[0]
            phi[rows] = e_seq[0]
        else:
            prev = slice((k - 1) * n_x, k * n_x)
            Phi[rows] = A_seq[k] @ Phi[prev]
            phi[rows] = A_seq[k] @ phi[prev] + e_seq[k]
            Gam[rows] = A_seq[k] @ Gam[prev]
        Gam[rows, k * m:(k + 1) * m] = B_seq[k]

    # Block cost weights over X and z.
    Qbar = np.zeros((N * n_x, N * n_x))
    for k in range(N - 1):
        Qbar[k * n_x:(k + 1) * n_x, k * n_x:(k + 1) * n_x] = Q
    Qbar[(N - 1) * n_x:, (N - 1) * n_x:] = P
    Rbar = np.kron(np.eye(N), R)

    H = Gam.T @ Qbar @ Gam + Rbar
    H = 0.5 * (H + H.T)

    # Linear-in-z term: (Phi x0 + phi)'Qbar Gam z with x0 = x_nom + E theta.
    F = Gam.T @ Qbar @ Phi @ E                      # (nz, n_theta)
    f = Gam.T @ Qbar @ (Phi @ x_nom + phi)

    # theta-only cost: 1/2 (Phi x0 + phi)'Qbar(Phi x0 + phi) + 1/2 x0'Q x0.
    Q0 = Phi.T @ Qbar @ Phi + Q
    Y = E.T @ Q0 @ E
    Y = 0.5 * (Y + Y.T)
    g0 = Phi.T @ Qbar @ phi
    pvec = E.T @ (Q0 @ x_nom + g0)
    cconst = float(0.5 * x_nom @ Q0 @ x_nom + x_nom @ g0
                   + 0.5 * phi @ Qbar @ phi)

    # Constraints.
    G_rows, w_rows, S_rows = [], [], []
    if state_con is not None:
        for k, con in enumerate(state_con):
            if con is None:
                continue
            Cx, cx = con
            rows = slice(k * n_x, (k + 1) * n_x)
            G_rows.append(Cx @ Gam[rows])
            w_rows.append(cx - Cx @ (Phi[rows] @ x_nom + phi[rows]))
            S_rows.append(-Cx @ Phi[rows] @ E)
    if input_con is not None:
        for k, con in enumerate(input_con):
            if con is None:
                continue
            Cu, cu = con
            Gk = np.zeros((Cu.shape[0], nz))
            Gk[:, k * m:(k + 1) * m] = Cu
            G_rows.append(Gk)
            w_rows.append(np.asarray(cu, dtype=np.float64))
            S_rows.append(np.zeros((Cu.shape[0], n_theta)))
    if theta_con is not None:
        Ct, ct = theta_con
        G_rows.append(np.zeros((Ct.shape[0], nz)))
        w_rows.append(np.asarray(ct, dtype=np.float64))
        S_rows.append(-np.asarray(Ct, dtype=np.float64))

    G = np.vstack(G_rows) if G_rows else np.zeros((0, nz))
    w = np.concatenate(w_rows) if w_rows else np.zeros(0)
    S = np.vstack(S_rows) if S_rows else np.zeros((0, n_theta))

    sel = np.eye(n_u, m) if u_selector is None else np.asarray(u_selector)
    if sel.shape != (n_u, m):
        raise ValueError(f"u_selector must be ({n_u}, {m}), got {sel.shape}")
    u_map = np.zeros((n_u, nz))
    u_map[:, :m] = sel
    return CondensedSlice(H=H, f=f, F=F, G=G, w=w, S=S, Y=Y, pvec=pvec,
                          cconst=cconst, u_map=u_map)


def _condense_prestab(A_seq, B_seq, e_seq, Q, R, P, E, x_nom, n_u, K,
                      state_con, input_con, theta_con,
                      u_selector) -> CondensedSlice:
    """Closed-loop condensing: substitute u_k = K x_k + v_k and condense
    in v.  Derivation (stage cost with the substitution):

        1/2 x'Qx + 1/2 u'Ru = 1/2 x'(Q + K'RK)x + x'K'R v + 1/2 v'Rv

    so with X0 = [x_0..x_{N-1}] (affine in (x0, v) through the CLOSED-
    LOOP prediction matrices) the objective is quadratic in v with a
    cross term X0' blkdiag(K'R) v; x_N carries the terminal P.  Exactness
    is tested against the open-loop path (tests/test_problems.py)."""
    N = len(A_seq)
    n_x = A_seq[0].shape[0]
    m = B_seq[0].shape[1]
    nz = N * m
    E = np.asarray(E, dtype=np.float64)
    n_theta = E.shape[1]
    x_nom = np.asarray(x_nom, dtype=np.float64)

    Acl = [np.asarray(A_seq[k]) + np.asarray(B_seq[k]) @ K
           for k in range(N)]
    # Closed-loop prediction: X = Phi x0 + Gam v + phi, X = [x_1..x_N].
    Phi = np.zeros((N * n_x, n_x))
    Gam = np.zeros((N * n_x, nz))
    phi = np.zeros(N * n_x)
    for k in range(N):
        rows = slice(k * n_x, (k + 1) * n_x)
        if k == 0:
            Phi[rows] = Acl[0]
            phi[rows] = e_seq[0]
        else:
            prev = slice((k - 1) * n_x, k * n_x)
            Phi[rows] = Acl[k] @ Phi[prev]
            phi[rows] = Acl[k] @ phi[prev] + e_seq[k]
            Gam[rows] = Acl[k] @ Gam[prev]
        Gam[rows, k * m:(k + 1) * m] = B_seq[k]

    # X0 = [x_0..x_{N-1}] map (x_0 is affine in theta, not part of X).
    Phi0 = np.vstack([np.eye(n_x), Phi[:(N - 1) * n_x]])
    Gam0 = np.vstack([np.zeros((n_x, nz)), Gam[:(N - 1) * n_x]])
    phi0 = np.concatenate([np.zeros(n_x), phi[:(N - 1) * n_x]])
    PhiN = Phi[(N - 1) * n_x:]
    GamN = Gam[(N - 1) * n_x:]
    phiN = phi[(N - 1) * n_x:]

    Qk = Q + K.T @ R @ K
    Qt = np.kron(np.eye(N), Qk)
    Cross = np.kron(np.eye(N), K.T @ R)      # (N n_x, N m)
    Rbar = np.kron(np.eye(N), R)

    H = (Gam0.T @ Qt @ Gam0 + Gam0.T @ Cross + Cross.T @ Gam0 + Rbar
         + GamN.T @ P @ GamN)
    H = 0.5 * (H + H.T)
    Fx0 = Gam0.T @ Qt @ Phi0 + Cross.T @ Phi0 + GamN.T @ P @ PhiN
    F = Fx0 @ E
    f = (Fx0 @ x_nom + Gam0.T @ Qt @ phi0 + Cross.T @ phi0
         + GamN.T @ P @ phiN)

    Q0 = Phi0.T @ Qt @ Phi0 + PhiN.T @ P @ PhiN
    g0 = Phi0.T @ Qt @ phi0 + PhiN.T @ P @ phiN
    Y = E.T @ Q0 @ E
    Y = 0.5 * (Y + Y.T)
    pvec = E.T @ (Q0 @ x_nom + g0)
    cconst = float(0.5 * x_nom @ Q0 @ x_nom + x_nom @ g0
                   + 0.5 * phi0 @ Qt @ phi0 + 0.5 * phiN @ P @ phiN)

    # Constraints -- SAME row order as the open-loop path.
    G_rows, w_rows, S_rows = [], [], []
    if state_con is not None:
        for k, con in enumerate(state_con):
            if con is None:
                continue
            Cx, cx = con
            rows = slice(k * n_x, (k + 1) * n_x)
            G_rows.append(Cx @ Gam[rows])
            w_rows.append(cx - Cx @ (Phi[rows] @ x_nom + phi[rows]))
            S_rows.append(-Cx @ Phi[rows] @ E)
    if input_con is not None:
        for k, con in enumerate(input_con):
            if con is None:
                continue
            Cu, cu = con
            # u_k = K x_k + v_k with x_k affine in (x0, v).
            if k == 0:
                xk_Phi, xk_Gam, xk_phi = (np.eye(n_x),
                                          np.zeros((n_x, nz)),
                                          np.zeros(n_x))
            else:
                rs = slice((k - 1) * n_x, k * n_x)
                xk_Phi, xk_Gam, xk_phi = Phi[rs], Gam[rs], phi[rs]
            CuK = Cu @ K
            Gk = CuK @ xk_Gam
            Gk[:, k * m:(k + 1) * m] += Cu
            G_rows.append(Gk)
            w_rows.append(np.asarray(cu, dtype=np.float64)
                          - CuK @ (xk_Phi @ x_nom + xk_phi))
            S_rows.append(-CuK @ xk_Phi @ E)
    if theta_con is not None:
        Ct, ct = theta_con
        G_rows.append(np.zeros((Ct.shape[0], nz)))
        w_rows.append(np.asarray(ct, dtype=np.float64))
        S_rows.append(-np.asarray(Ct, dtype=np.float64))

    G = np.vstack(G_rows) if G_rows else np.zeros((0, nz))
    w = np.concatenate(w_rows) if w_rows else np.zeros(0)
    S = np.vstack(S_rows) if S_rows else np.zeros((0, n_theta))

    sel = np.eye(n_u, m) if u_selector is None else np.asarray(u_selector)
    if sel.shape != (n_u, m):
        raise ValueError(f"u_selector must be ({n_u}, {m}), got {sel.shape}")
    u_map = np.zeros((n_u, nz))
    u_map[:, :m] = sel
    selK = sel @ K
    return CondensedSlice(H=H, f=f, F=F, G=G, w=w, S=S, Y=Y, pvec=pvec,
                          cconst=cconst, u_map=u_map,
                          u_theta=selK @ E, u_const=selK @ x_nom)


def soften(sl: CondensedSlice, rows: np.ndarray,
           rho: float = 1e3) -> CondensedSlice:
    """Soften the given constraint rows with quadratic-penalty slacks.

    Each row i in `rows` becomes  G_i z - s_i <= w_i + S_i theta,  s_i >= 0,
    with rho/2 * s_i^2 added to the cost.  Use on constraints whose hard
    version would make the feasible parameter set's boundary cut through
    Theta along a dynamics-dependent (curved) surface: simplices straddling
    such a surface can never certify and subdivide to the depth cap,
    whereas the softened V_delta is finite and continuous on ALL of Theta
    and the eps-certificate closes at finite depth.
    """
    rows = np.asarray(rows, dtype=np.int64)
    nz = sl.H.shape[0]
    ns = len(rows)
    nt = sl.F.shape[1]
    nc = sl.G.shape[0]
    H = np.block([[sl.H, np.zeros((nz, ns))],
                  [np.zeros((ns, nz)), rho * np.eye(ns)]])
    f = np.concatenate([sl.f, np.zeros(ns)])
    F = np.vstack([sl.F, np.zeros((ns, nt))])
    sel = np.zeros((nc, ns))
    sel[rows, np.arange(ns)] = 1.0
    G = np.block([[sl.G, -sel],
                  [np.zeros((ns, nz)), -np.eye(ns)]])
    w = np.concatenate([sl.w, np.zeros(ns)])
    S = np.vstack([sl.S, np.zeros((ns, nt))])
    u_map = np.hstack([sl.u_map, np.zeros((sl.u_map.shape[0], ns))])
    return CondensedSlice(H=H, f=f, F=F, G=G, w=w, S=S, Y=sl.Y,
                          pvec=sl.pvec, cconst=sl.cconst, u_map=u_map,
                          u_theta=sl.u_theta, u_const=sl.u_const)


def stack_slices(slices: Sequence[CondensedSlice],
                 deltas: np.ndarray) -> CanonicalMPQP:
    """Stack per-commutation slices, padding constraint rows to a common
    count with vacuous rows 0'z <= 1 (static shapes for vmap over delta).

    At least one row is always kept: the IPM kernel's reductions over the
    constraint axis require nc >= 1, and a vacuous row solves the
    unconstrained problem exactly."""
    nc = max(1, max(s.G.shape[0] for s in slices))
    nz = slices[0].H.shape[0]
    n_theta = slices[0].F.shape[1]

    def pad(s: CondensedSlice):
        k = nc - s.G.shape[0]
        G = np.vstack([s.G, np.zeros((k, nz))])
        w = np.concatenate([s.w, np.ones(k)])
        S = np.vstack([s.S, np.zeros((k, n_theta))])
        return G, w, S

    padded = [pad(s) for s in slices]
    n_u = slices[0].u_map.shape[0]
    return CanonicalMPQP(
        H=np.stack([s.H for s in slices]),
        f=np.stack([s.f for s in slices]),
        F=np.stack([s.F for s in slices]),
        G=np.stack([g for g, _, _ in padded]),
        w=np.stack([w for _, w, _ in padded]),
        S=np.stack([s for _, _, s in padded]),
        Y=np.stack([s.Y for s in slices]),
        pvec=np.stack([s.pvec for s in slices]),
        cconst=np.array([s.cconst for s in slices]),
        u_map=np.stack([s.u_map for s in slices]),
        u_theta=np.stack([s.u_theta if s.u_theta is not None
                          else np.zeros((n_u, n_theta)) for s in slices]),
        u_const=np.stack([s.u_const if s.u_const is not None
                          else np.zeros(n_u) for s in slices]),
        deltas=np.asarray(deltas),
    )


def box_rows(lb: np.ndarray, ub: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(C, c) with C v <= c encoding lb <= v <= ub."""
    n = len(lb)
    C = np.vstack([np.eye(n), -np.eye(n)])
    c = np.concatenate([ub, -np.asarray(lb, dtype=np.float64)])
    return C, c


def zoh(Ac: np.ndarray, Bc: np.ndarray, dt: float) -> tuple[np.ndarray, np.ndarray]:
    """Zero-order-hold discretization (the reference discretizes its plants
    with ZOH; SURVEY.md section 3 "Problem library", [M-med])."""
    import scipy.linalg

    n, m = Bc.shape
    M = np.zeros((n + m, n + m))
    M[:n, :n] = Ac
    M[:n, n:] = Bc
    eM = scipy.linalg.expm(M * dt)
    return eM[:n, :n], eM[:n, n:]


class HybridMPC:
    """Base class for benchmark problems (the reference's `MPC` base class
    role, SURVEY.md section 3 "Problem library" -- UNVERIFIED naming).

    Subclasses define the parameter box (the partitioned set Theta), the
    commutation enumeration, and build_canonical().
    """

    name: str = "base"
    theta_lb: np.ndarray
    theta_ub: np.ndarray
    n_u: int
    # Axis-aligned hyperplanes (axis -> coordinate values) that the ROOT
    # triangulation must align with: any fixed theta-hyperplane across
    # which commutation feasibility flips (e.g. PWA mode membership of
    # x_0) must land on root cell faces or cells straddling it can never
    # certify (see geometry.box_triangulation).  None = no splits;
    # subclasses ASSIGN a fresh dict (a mutable class-level default would
    # be shared across every problem).
    root_splits = None

    @property
    def n_theta(self) -> int:
        return int(self.theta_lb.size)

    # Stage-cost weights for closed-loop evaluation (sim/), set by
    # subclasses alongside their canonical cost.  Shapes (n_x, n_x) and
    # (n_u, n_u) in APPLIED-input coordinates.
    Qc: np.ndarray
    Rc: np.ndarray

    def plant_step(self, x: np.ndarray, u: np.ndarray) -> np.ndarray:
        """True plant update x+ = f(x, u) with the APPLIED input u (what
        the online controller emits).  Used by the closed-loop simulator
        (SURVEY.md section 4.3); the default raises so prediction-only
        problems fail loudly."""
        raise NotImplementedError(f"{self.name} defines no plant")

    def theta_of_state(self, x: np.ndarray) -> np.ndarray:
        """Partition parameter for plant state x (identity when the
        parameter IS the state; slice problems override)."""
        return np.asarray(x, dtype=np.float64)

    def state_of_theta(self, theta: np.ndarray) -> np.ndarray:
        """Initial plant state for parameter theta (identity default)."""
        return np.asarray(theta, dtype=np.float64)

    def stage_cost(self, x: np.ndarray, u: np.ndarray) -> float:
        return float(0.5 * x @ self.Qc @ x + 0.5 * u @ self.Rc @ u)

    @functools.cached_property
    def canonical(self) -> CanonicalMPQP:
        can = self.build_canonical()
        for d in range(can.n_delta):
            eig = np.linalg.eigvalsh(can.H[d])
            if eig.min() <= 0:
                raise ValueError(
                    f"{self.name}: H[{d}] not PD (min eig {eig.min():.3e}); "
                    "add input regularization R > 0")
        return can

    def build_canonical(self) -> CanonicalMPQP:
        raise NotImplementedError
