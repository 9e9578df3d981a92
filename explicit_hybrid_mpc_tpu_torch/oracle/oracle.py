"""The Oracle: the solver plugin boundary (torch).

The same three query classes as the JAX package's oracle/oracle.py,
batched over a leading axis and run on the oracle's device:

- `solve_vertices(thetas)` -- for a batch of parameter points, solve the
  fixed-commutation QP for EVERY commutation (enumeration replaces
  branch-and-bound) and reduce to V*(theta), delta*(theta): one batched
  IPM solve over (points x commutations).
- `solve_simplex_min(simplices, delta_idx)` -- certified lower bound on
  min V_delta over a simplex via the elastic joint QP in (z, theta).
- `simplex_feasibility(simplices, delta_idx)` / `feasibility(thetas,
  delta_idx)` -- phase-1 minimal-violation queries (+ Farkas dual check
  for the simplex form).

Backends: 'cuda' (the first CUDA device; every IPM leg is one launch of
the hand-written kernel, csrc/ipm_leg.cu), 'cpu' (the same code with
the kernel's plain torch version) and 'serial' (one point or one
(point, commutation) pair per call, each QP solved in numpy on the host
by oracle/host_qp.py: the baseline that oracle/bnb.py's branch-and-bound
stand-in runs on, and that the benchmarks price the batched backends
against).  'serial' is reached only by name: no 'cuda' oracle ever
becomes one.  A `mesh` (parallel/mesh.py) splits the vertex-grid
solves over a (batch, delta) grid of devices; every other query runs
on the oracle's own device.

Asynchrony: `dispatch_*` only enqueues device work -- host inputs go
through pinned memory without blocking and no result is read back -- so
the build pipeline can certify one batch on the host while the next
batch solves.  `wait_*` is where results come back to the host (and
where the two-phase cohort and the rescue pass read their masks).
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from explicit_hybrid_mpc_tpu_torch import device as device_lib
from explicit_hybrid_mpc_tpu_torch import obs as obs_lib
from explicit_hybrid_mpc_tpu_torch.faults import injector as faults_inj
from explicit_hybrid_mpc_tpu_torch.oracle import host_qp, ipm
from explicit_hybrid_mpc_tpu_torch.problems.base import CanonicalMPQP

_INF = np.inf

# Quadratic weight on the elastic slack of the stage-2 simplex bound --
# used BOTH in the Hessian block and in the bound's penalty subtraction
# (_solve_simplex_min); the two must stay equal or the reported
# "lower bound" silently retains un-subtracted penalty (unsound).
_ELASTIC_QUAD = 1e-2


class DeviceProblem(NamedTuple):
    """CanonicalMPQP staged as tensors (one slice per commutation)."""

    H: torch.Tensor
    f: torch.Tensor
    F: torch.Tensor
    G: torch.Tensor
    w: torch.Tensor
    S: torch.Tensor
    Y: torch.Tensor
    pvec: torch.Tensor
    cconst: torch.Tensor
    u_map: torch.Tensor
    u_theta: torch.Tensor
    u_const: torch.Tensor


def to_device(can: CanonicalMPQP, device: torch.device) -> DeviceProblem:
    return DeviceProblem(*(
        torch.as_tensor(np.ascontiguousarray(getattr(can, k)),
                        dtype=torch.float64).to(device)
        for k in DeviceProblem._fields))


class VertexSolution(NamedTuple):
    """Per-point oracle results (host numpy). P points, nd commutations."""

    V: np.ndarray        # (P, nd) fixed-commutation value; +inf if invalid
    conv: np.ndarray     # (P, nd) bool, solver converged (cost trustworthy)
    feas: np.ndarray     # (P, nd) bool, primal residual small
    grad: np.ndarray     # (P, nd, n_theta) dV_delta/dtheta
    u0: np.ndarray       # (P, nd, n_u) first control move
    z: np.ndarray        # (P, nd, nz) full primal solution
    Vstar: np.ndarray    # (P,) min over valid commutations; +inf if none
    dstar: np.ndarray    # (P,) argmin commutation; -1 if none valid
    lam: np.ndarray | None = None  # (P, nd, nc) final duals (two-phase /
    #                      warm-start oracles only; None otherwise)
    s: np.ndarray | None = None    # (P, nd, nc) final slacks (ditto)


def _bmv(M, v):
    return torch.matmul(M, v.unsqueeze(-1)).squeeze(-1)


def _bmtv(M, v):
    return torch.matmul(v.unsqueeze(-2), M).squeeze(-2)


def point_qp(prob: DeviceProblem, thetas: torch.Tensor, ds: torch.Tensor):
    """The fixed-commutation point QPs (H, q, G, b) at (point,
    commutation) pairs: thetas (K, n_theta), ds (K,)."""
    q = prob.f[ds] + _bmv(prob.F[ds], thetas)
    b = prob.w[ds] + _bmv(prob.S[ds], thetas)
    return prob.H[ds], q, prob.G[ds], b


# tpulint: device-region
def _solve_pairs(prob: DeviceProblem, thetas: torch.Tensor,
                 ds: torch.Tensor, n_iter: int, n_f32: int = 0, warm=None):
    """Fixed-commutation QPs at (point, commutation) pairs: thetas
    (K, n_theta), ds (K,) commutation indices.  `warm` is an optional
    (z0, s0, lam0, valid) tuple in original units, threaded to the
    merit-gated warm path.  Returns (V, conv, feas, grad, u0, z, lam, s,
    rp, warm_ok), each with leading axis K."""
    F, S, Y = prob.F[ds], prob.S[ds], prob.Y[ds]
    sol = ipm.qp_solve(*point_qp(prob, thetas, ds), n_iter=n_iter,
                       n_f32=n_f32, warm_start=warm)
    Yth = _bmv(Y, thetas)
    pv = prob.pvec[ds]
    theta_cost = (torch.sum(0.5 * thetas * Yth, dim=-1)
                  + torch.sum(pv * thetas, dim=-1) + prob.cconst[ds])
    V = sol.obj + theta_cost
    # Envelope theorem: dV/dtheta = F'z* + Y theta + p - S'lam*.
    grad = _bmtv(F, sol.z) + Yth + pv - _bmtv(S, sol.lam)
    # Affine theta part is nonzero only under prestabilized condensing
    # (z holds v; the applied input is u = K x(theta) + v).
    u0 = (_bmv(prob.u_map[ds], sol.z) + _bmv(prob.u_theta[ds], thetas)
          + prob.u_const[ds])
    return (V, sol.converged, sol.feasible, grad, u0, sol.z, sol.lam,
            sol.s, sol.rp, sol.warm_ok)


# tpulint: device-region
def reduce_deltas(V: torch.Tensor, conv: torch.Tensor):
    """V*(theta), delta*(theta) from the (P, nd) grid values.  First
    minimum = deterministic tie-break (torch.argmin returns the first
    minimal index), required for backend parity of the produced tree."""
    Vval = torch.where(conv, V, torch.full_like(V, _INF))
    dstar = torch.argmin(Vval, dim=-1)
    Vstar = torch.gather(Vval, -1, dstar[..., None])[..., 0]
    return Vstar, dstar


def _solve_points_grid(prob: DeviceProblem, thetas: torch.Tensor,
                       n_iter: int, n_f32: int = 0):  # tpulint: device-region
    """(P points) x (nd commutations) in one batched solve: returns
    (V, conv, feas, grad, u0, z, Vstar, dstar, lam, s, rp), the per-cell
    fields shaped (P, nd, ...)."""
    nd = prob.H.shape[0]
    P = thetas.shape[0]
    th = thetas.repeat_interleave(nd, dim=0)
    ds = torch.arange(nd, device=thetas.device).repeat(P)
    out = _solve_pairs(prob, th, ds, n_iter, n_f32)
    V, conv, feas, grad, u0, z, lam, s, rp, _wok = (
        t.reshape((P, nd) + t.shape[1:]) for t in out)
    Vstar, dstar = reduce_deltas(V, conv)
    return V, conv, feas, grad, u0, z, Vstar, dstar, lam, s, rp


def _simplex_rows(prob: DeviceProblem, bary_M: torch.Tensor,
                  ds: torch.Tensor):
    """Shared row blocks of the joint (z, theta, t) programs: problem
    rows Gz - S theta - t <= w and simplex rows -M_theta theta <= m_c."""
    nz = prob.H.shape[1]
    nt = prob.Y.shape[1]
    nc = prob.G.shape[1]
    K, nb, _ = bary_M.shape
    dtype, dev = bary_M.dtype, bary_M.device
    M_th = bary_M[:, :, :nt]
    m_c = bary_M[:, :, nt]
    prob_rows = torch.cat([prob.G[ds], -prob.S[ds],
                           -torch.ones((K, nc, 1), dtype=dtype, device=dev)],
                          dim=2)
    simplex_rows = torch.cat([
        torch.zeros((K, nb, nz), dtype=dtype, device=dev), -M_th,
        torch.zeros((K, nb, 1), dtype=dtype, device=dev)], dim=2)
    return prob_rows, simplex_rows, m_c


def simplex_feas_qp(prob: DeviceProblem, bary_M: torch.Tensor,
                    ds: torch.Tensor):
    """The joint phase-1 QPs (Q, q, A, b) over (z, theta, t):
    min ridge|z,theta|^2/2 + rho t^2/2 + t  s.t.  Gz - S theta - t <= w,
    -M_theta theta <= m_c (t not elastic on the simplex rows: theta must
    stay IN R)."""
    nz = prob.H.shape[1]
    nt = prob.Y.shape[1]
    K = bary_M.shape[0]
    dtype, dev = bary_M.dtype, bary_M.device
    prob_rows, simplex_rows, m_c = _simplex_rows(prob, bary_M, ds)
    A = torch.cat([prob_rows, simplex_rows], dim=1)
    b = torch.cat([prob.w[ds], m_c], dim=1)
    n = nz + nt + 1
    Q = torch.eye(n, dtype=dtype, device=dev) * 1e-9
    Q[n - 1, n - 1] = 1e-6
    Q = Q.expand(K, n, n).contiguous()
    q = torch.zeros((K, n), dtype=dtype, device=dev)
    q[:, n - 1] = 1.0
    return Q, q, A, b


# tpulint: device-region
def _simplex_feas(prob: DeviceProblem, bary_M: torch.Tensor,
                  ds: torch.Tensor, n_iter: int, n_f32: int = 0):
    """Joint phase-1 over simplices: t* = min violation of commutation
    d's constraints over {(z, theta) : theta in R}.

    t* <= tol  => delta d is feasible SOMEWHERE in R.  Infeasibility on
    ALL of R requires BOTH t* > tol and an approximate Farkas
    certificate from the phase-1 duals: y >= 0 with A0'y ~ 0 and
    b'y < 0 proves {A0 x <= b} empty (robust to the primal ridge, which
    biases t* upward -- the unsound direction).
    Returns (t*, converged, farkas_ok), each (K,)."""
    nz = prob.H.shape[1]
    nt = prob.Y.shape[1]
    dtype, dev = bary_M.dtype, bary_M.device
    Q, q, A, b = simplex_feas_qp(prob, bary_M, ds)
    sol = ipm.qp_solve(Q, q, A, b, n_iter=n_iter, n_f32=n_f32)
    # Farkas check on the ORIGINAL system A0 x <= b (t column dropped).
    A0 = A[:, :, :nz + nt]
    lam_sum = torch.sum(sol.lam, dim=-1)
    y = sol.lam / torch.maximum(
        lam_sum, torch.full((), 1e-300, dtype=dtype, device=dev))[:, None]
    stat = _bmtv(A0, y).abs().amax(dim=-1) / (
        1.0 + A0.abs().amax(dim=(-2, -1)))
    gain = torch.sum(b * y, dim=-1) / (1.0 + b.abs().amax(dim=-1))
    farkas_ok = ((stat <= 1e-7) & (gain <= -1e-9)
                 & torch.isfinite(y).all(dim=-1))
    return sol.z[:, nz + nt], sol.converged, farkas_ok


def simplex_min_qp(prob: DeviceProblem, bary_M: torch.Tensor,
                   ds: torch.Tensor, rho_elastic: float = 1e4):
    """The elastic joint simplex-min QPs (Hj, qj, Gj, bj) over
    (z, theta, t): Hessian [[H, F, 0], [F', Y + ridge, 0], [0, 0,
    _ELASTIC_QUAD]], linear term [f; p; rho_elastic], rows
    Gz - S theta - t <= w, -M_theta theta <= m_c (hard), -t <= 0."""
    nz = prob.H.shape[1]
    nt = prob.Y.shape[1]
    K, nb, _ = bary_M.shape
    dtype, dev = bary_M.dtype, bary_M.device
    ridge = 1e-9
    n = nz + nt + 1
    Hj = torch.zeros((K, n, n), dtype=dtype, device=dev)
    Fd = prob.F[ds]
    Hj[:, :nz, :nz] = prob.H[ds]
    Hj[:, :nz, nz:nz + nt] = Fd
    Hj[:, nz:nz + nt, :nz] = Fd.transpose(1, 2)
    Hj[:, nz:nz + nt, nz:nz + nt] = prob.Y[ds] + ridge * torch.eye(
        nt, dtype=dtype, device=dev)
    Hj[:, n - 1, n - 1] = _ELASTIC_QUAD
    qj = torch.cat([prob.f[ds], prob.pvec[ds],
                    torch.full((K, 1), rho_elastic, dtype=dtype,
                               device=dev)], dim=1)
    # Gz - S theta - t <= w;  -M_theta theta <= m_c (hard);  -t <= 0.
    prob_rows, simplex_rows, m_c = _simplex_rows(prob, bary_M, ds)
    t_row = torch.zeros((K, 1, n), dtype=dtype, device=dev)
    t_row[:, 0, n - 1] = -1.0
    Gj = torch.cat([prob_rows, simplex_rows, t_row], dim=1)
    bj = torch.cat([prob.w[ds], m_c,
                    torch.zeros((K, 1), dtype=dtype, device=dev)], dim=1)
    return Hj, qj, Gj, bj


# tpulint: device-region
def _solve_simplex_min(prob: DeviceProblem, bary_M: torch.Tensor,
                       ds: torch.Tensor, n_iter: int, n_f32: int = 0,
                       rho_elastic: float = 1e4, warm=None):
    """Lower bound on min_{theta in R} V_delta(theta): ELASTIC joint QP
    over (z, theta, t).

    bary_M is the (p+1, p+1) barycentric matrix of each simplex (lambda
    = bary_M @ [theta;1]); theta-in-simplex is lambda >= 0.  The joint
    Hessian [[H, F],[F', Y]] is PSD by construction; a small ridge on
    the theta block keeps the Cholesky PD.  The scalar elastic t >= 0
    relaxes the problem rows (NOT the simplex rows) with an exact linear
    penalty: the relaxation only ENLARGES the feasible set, so the
    optimum is a valid lower bound (sound for the certificate), exact
    whenever rho_e exceeds the active duals' l1 norm, and the elastic
    problem always has a strict interior.

    Returns (bound, converged, feasible, t_elastic, z, lam, s)."""
    nz = prob.H.shape[1]
    nt = prob.Y.shape[1]
    n = nz + nt + 1
    dtype, dev = bary_M.dtype, bary_M.device
    Hj, qj, Gj, bj = simplex_min_qp(prob, bary_M, ds, rho_elastic)
    # tol 1e-9: the convergence test is RELATIVE to scale_d ~ 1+max|q|,
    # which rho_elastic inflates to ~rho; 1e-9 keeps the absolute value
    # error ~1e-5, far below every config's eps.
    sol = ipm.qp_solve(Hj, qj, Gj, bj, n_iter=n_iter, n_f32=n_f32,
                       tol=1e-9, warm_start=warm)
    # Clamp: the -t <= 0 row is only honored to the primal tolerance,
    # and a slightly NEGATIVE t would ADD rho*|t| to the reported bound
    # -- the unsound direction for a lower bound.  Clamped, any solver
    # error only loosens the bound (safe).
    t_el = torch.maximum(sol.z[:, n - 1],
                         torch.zeros((), dtype=dtype, device=dev))
    # Drop the penalty term from the reported bound: value + rho*t >=
    # value, and value alone is the (possibly looser) valid lower bound.
    obj = sol.obj - rho_elastic * t_el - 0.5 * _ELASTIC_QUAD * (t_el * t_el)
    return (obj + prob.cconst[ds], sol.converged, sol.feasible, t_el,
            sol.z, sol.lam, sol.s)


def _np(t: torch.Tensor) -> np.ndarray:
    """Device tensor -> host numpy (the blocking read-back)."""
    return t.cpu().numpy()


class Oracle:
    """Solver plugin boundary on one torch device."""

    # Fault-injection role tag carried in the oracle.dispatch site
    # label: "primary" for the build's oracle, "fallback" on the CPU
    # recovery twin (frontier._fallback_oracle flips it).
    _fault_role = "primary"

    def __init__(self, problem, backend: str = "cuda", n_iter: int = 30,
                 precision: str = "f64",
                 points_cap: int | None = None,
                 n_f32: int | None = None,
                 rescue_iter: int = 0,
                 point_schedule: tuple[int, int] | None = None,
                 stage2_order: str = "auto",
                 two_phase: bool = False,
                 phase1_iters: int | None = None,
                 phase1_iters_point: int | None = None,
                 phase1_iters_simplex: int | None = None,
                 warm_start: bool = False,
                 ipm_kernel: str = "auto",
                 obs: "obs_lib.Obs | None" = None,
                 mesh=None):
        """backend: 'cuda' (raises without a CUDA device), 'cpu', or
        'serial' (the one-QP-per-call host baseline: pinned to the CPU,
        its QPs solved one at a time by oracle/host_qp.py whatever
        ipm_kernel asks, two-phase and warm starts forced off, no
        mesh; the batched simplex programs run the plain leg).

        mesh: a parallel.mesh.Mesh; solve_vertices then splits the
        (points x commutations) grid over its devices
        (parallel/mesh.py MeshSolver), each block through the leg of
        its device (K1 on a card), instead of running on the oracle's
        device.  Its devices must be of the backend's kind.  Two-phase
        cohorts and warm starts are forced off under a mesh (the block
        solver has no cohort or warm path), as in the JAX package.

        precision: 'f64' = every IPM iteration in float64; 'mixed' =
        two-thirds of n_iter as float32 iterations + the remaining third
        as warm-started float64 polish, to the same KKT tolerance.

        two_phase: adaptive-WORK cohort solve (cfg.ipm_two_phase).  The
        point-class and elastic-simplex-min programs run a SHORT
        first-phase f64 schedule (phase1_iters; default 2/5 of the
        class's f64 length), the `converged` mask is read on host, and
        only the unconverged survivors are compacted into a fresh
        power-of-two bucket and finished with the remaining iterations,
        warm-started from their own phase-1 iterates through the merit
        gate.  Cells already DIVERGING after phase 1 (relative primal
        residual > _DIVERGED_RP) exit early.  Per-instance deterministic,
        so trees stay batch-composition-independent.  The sound
        single-shot programs (joint phase-1/Farkas, point phase-1) keep
        their full single-phase schedule.

        ipm_kernel: cfg.ipm_kernel, checked here and nowhere else: the
        IPM legs always follow the device (the CUDA kernel on cuda, its
        plain version on cpu); 'auto' accepts that, and 'cuda' /
        'torch' raise where they are not the device's leg.

        warm_start: accept caller-supplied warm starts on the pair path
        (dispatch_pairs(..., warm=...)) and return final duals/slacks
        from the point-class programs so the frontier can cache them as
        tree warm-start donors (cfg.warm_start_tree)."""
        if mesh is not None and backend == "serial":
            raise ValueError("backend='serial' is the one-solve-at-a-time "
                             "baseline; it cannot shard over a mesh")
        if backend not in ("cuda", "cpu", "serial"):
            raise ValueError(f"unknown backend {backend!r}")
        self.problem = problem
        self.can = problem.canonical
        self.backend = backend
        self.mesh = mesh
        # Observability handle: per-class solve-time histograms + IPM
        # iteration counters flow through it.  NOOP by default; the
        # frontier engine re-points it at the build's own handle.
        self.obs = obs if obs is not None else obs_lib.NOOP
        # Flight recorder (obs/recorder.py): None by default; the
        # frontier engine points it at the build's recorder when
        # cfg.obs_recorder is set.  When live, cells that finish the
        # full pipeline feasible-but-unconverged and simplex rows with
        # no usable bound are dumped as replayable repro bundles.
        self.recorder = None
        if precision not in ("f64", "mixed"):
            raise ValueError(f"unknown precision {precision!r}")
        self.precision = precision
        # points_cap: optional hard ceiling on the point-batch bucket
        # (see max_points_per_call).
        self.points_cap = points_cap
        # Mixed precision splits the caller's iteration budget 2:1
        # between the f32 bulk and the f64 polish (default n_iter=30 ->
        # 20 + 10); an explicit n_f32 overrides the split.
        if n_f32 is not None and precision != "mixed":
            raise ValueError("n_f32 override requires precision='mixed'")
        if n_f32 is not None and not 0 <= n_f32 <= n_iter:
            raise ValueError(f"n_f32={n_f32} must lie in [0, n_iter="
                             f"{n_iter}] (the rest is the f64 polish)")
        # Conditioning gate for the mixed schedule: problems whose
        # EQUILIBRATED Hessians are still ill-conditioned (> 1e4) fall
        # back to the full-length f64 schedule (the f32 phase would
        # never pass the f64 merit gate).  An explicit n_f32 skips it.
        self.hessian_cond_scaled = None
        if precision == "mixed" and n_f32 is None:
            self.hessian_cond_scaled = self._scaled_cond(self.can.H)
            if self.hessian_cond_scaled > 1e4:
                n_f32 = 0
        self.n_f32 = ((2 * n_iter) // 3 if n_f32 is None else n_f32) \
            if precision == "mixed" else 0
        self.n_iter = n_iter - self.n_f32
        # point_schedule = (n_f32, n_f64) override for the POINT-class
        # programs only; None = the simplex class's schedule.
        if point_schedule is None:
            self.point_n_f32, self.point_n_iter = self.n_f32, self.n_iter
        else:
            self.point_n_f32, self.point_n_iter = map(int, point_schedule)
            if self.point_n_f32 < 0 or self.point_n_iter < 1:
                raise ValueError(f"bad point_schedule {point_schedule!r}: "
                                 "need (n_f32 >= 0, n_f64 >= 1)")
        self.point_schedule = point_schedule
        # -- two-phase cohort + tree warm-starts (see __init__ doc) --------
        if phase1_iters is not None and int(phase1_iters) < 1:
            raise ValueError(f"phase1_iters={phase1_iters} must be >= 1")
        self.phase1_iters = (None if phase1_iters is None
                             else int(phase1_iters))
        for nm, v in (("phase1_iters_point", phase1_iters_point),
                      ("phase1_iters_simplex", phase1_iters_simplex)):
            if v is not None and int(v) < 1:
                raise ValueError(f"{nm}={v} must be >= 1")
        self.phase1_iters_point = (None if phase1_iters_point is None
                                   else int(phase1_iters_point))
        self.phase1_iters_simplex = (None if phase1_iters_simplex is None
                                     else int(phase1_iters_simplex))
        # The serial baseline is the conservative fixed schedule, and
        # the mesh's block solver has no cohort or warm path: neither
        # takes a cohort or warm starts.
        plain_schedule = backend == "serial" or mesh is not None
        self.two_phase = bool(two_phase) and not plain_schedule
        self.warm_start = bool(warm_start) and not plain_schedule

        def _split(n_f64: int,
                   override: int | None) -> tuple[int, int]:
            # Auto split: 2/5 of the class's f64 leg in phase 1.  A
            # per-class override wins over the shared phase1_iters,
            # which wins over the auto split.
            if override is None:
                override = self.phase1_iters
            p1 = min(n_f64, override if override is not None
                     else max(1, (2 * n_f64) // 5))
            return p1, n_f64 - p1
        self.point_p1, self.point_p2 = _split(self.point_n_iter,
                                              self.phase1_iters_point)
        self.simplex_p1, self.simplex_p2 = _split(
            self.n_iter, self.phase1_iters_simplex)
        # Degenerate splits (phase1_iters >= class schedule) fall back to
        # the single-phase path for that class.
        self._point_cohort = self.two_phase and self.point_p2 > 0
        self._simplex_cohort = self.two_phase and self.simplex_p2 > 0
        # The full-output grid program is needed whenever the cohort
        # must continue from phase-1 iterates OR the frontier wants
        # duals/slacks cached as warm-start donors.
        self._point_full_out = self._point_cohort or self.warm_start
        # Iteration ledger (host ints): actual f32/f64 IPM iterations
        # issued vs the f64 iterations the single-phase fixed schedule
        # would have issued for the same solves.
        self.n_iters_f32 = 0
        self.n_iters_f64 = 0
        self.n_iters_f64_fixed = 0
        self.n_tp_cells = 0
        self.n_tp_survivors = 0
        self.n_warm_attempts = 0
        self.n_warm_accepts = 0
        # Distinct (program family, padded rows) shapes this oracle has
        # launched (the pow-2 bucket ledger).
        self.compiled_shapes: set[tuple[str, int]] = set()
        # QP solves issued, split into point QPs and the structurally
        # larger joint simplex-wide QPs.
        self.n_solves = 0
        self.n_point_solves = 0
        self.n_simplex_solves = 0
        # rescue_iter > 0: point solves that end FEASIBLE but UNCONVERGED
        # are re-solved cold with a full-length f64 schedule.
        self.rescue_iter = int(rescue_iter)
        self.n_rescue_solves = 0
        if stage2_order not in ("auto", "min_first", "phase1_first"):
            raise ValueError(f"unknown stage2_order {stage2_order!r}")
        # 'auto' honors a problem-declared hint first, else phase-1
        # first on hybrid problems (pending pairs are overwhelmingly
        # infeasible exclusions there), elastic-min first otherwise.
        hint = getattr(problem, "stage2_hint", None)
        if stage2_order == "auto" and hint in ("min_first",
                                               "phase1_first"):
            self.stage2_phase1_first = hint == "phase1_first"
        else:
            self.stage2_phase1_first = (self.can.n_delta > 1
                                        if stage2_order == "auto"
                                        else stage2_order == "phase1_first")
        self.device = device_lib.resolve(
            "cpu" if backend == "serial" else backend)
        # The IPM leg that runs (public: obs gauge, provenance): 'cuda'
        # or 'torch'; raises for a request the device cannot honor.  The
        # serial baseline always runs the plain leg (one QP per call has
        # no batch for a kernel to fill).
        self.ipm_kernel = ipm.resolve_kernel(
            "auto" if backend == "serial" else ipm_kernel, self.device)
        self.prob = to_device(self.can, self.device)
        self._mesh_solver = None
        if mesh is not None:
            from explicit_hybrid_mpc_tpu_torch.parallel.mesh import (
                MeshSolver)

            kinds = {mesh.devices[ij].type for ij in mesh.local_entries()}
            if kinds != {self.device.type}:
                raise ValueError(
                    f"backend={backend!r} runs on {self.device.type}, but "
                    f"the mesh's devices are {sorted(kinds)}")
            self._mesh_solver = MeshSolver(self.prob, mesh,
                                           n_iter=self.point_n_iter,
                                           n_f32=self.point_n_f32)
        if backend == "serial":
            # One point / one pair per call through the chunk loops
            # below; each call runs the host programs on these arrays.
            self.max_pairs_per_call = 1
            self._host = DeviceProblem(*(
                np.ascontiguousarray(getattr(self.can, k), dtype=np.float64)
                for k in DeviceProblem._fields))

    def cpu_twin(self, problem) -> "Oracle":
        """CPU re-instantiation with identical solver semantics -- the
        frontier's failure recovery of a CPU build retries failed batches
        on it, so results must match this oracle's (a CUDA build raises
        instead of falling back)."""
        return Oracle(
            problem, backend="cpu",
            n_iter=self.n_iter + self.n_f32,
            precision=self.precision,
            n_f32=(self.n_f32 if self.precision == "mixed" else None),
            points_cap=self.points_cap,
            rescue_iter=self.rescue_iter,
            point_schedule=self.point_schedule,
            two_phase=self.two_phase,
            phase1_iters=self.phase1_iters,
            phase1_iters_point=self.phase1_iters_point,
            phase1_iters_simplex=self.phase1_iters_simplex,
            warm_start=self.warm_start)

    # -- host <-> device -----------------------------------------------------

    def _dev(self, a, dtype=torch.float64) -> torch.Tensor:
        return device_lib.to_device(a, self.device, dtype)

    def _idx(self, a) -> torch.Tensor:
        return device_lib.to_device(np.asarray(a, dtype=np.int64),
                                    self.device, torch.int64)

    # -- the batched programs (pairs / grid / simplex) -----------------------

    @property
    def _point_leg1(self) -> int:
        """f64 iterations of the point class's first (or only) pass: the
        cohort's phase 1, else the whole schedule."""
        return self.point_p1 if self._point_cohort else self.point_n_iter

    @property
    def _n_grid_out(self) -> int:
        return 11 if self._point_full_out else 8

    def _solve_points(self, thetas: torch.Tensor):  # tpulint: device-region
        """Grid program: 11 outputs when full-output (phase-1 cohort or
        warm-start donors), else the first 8."""
        if self.backend == "serial":
            return self._host_points(thetas)
        return _solve_points_grid(self.prob, thetas, self._point_leg1,
                                  self.point_n_f32)[:self._n_grid_out]

    # tpulint: device-region
    def _solve_pairs_ws(self, th, ds, zw, sw, lw, hw):
        """Warm-capable pair phase-1 (tree warm-start dispatch)."""
        return _solve_pairs(self.prob, th, ds, self._point_leg1,
                            self.point_n_f32, warm=(zw, sw, lw, hw))

    def _solve_pairs_p2(self, th, ds, zw, sw, lw):  # tpulint: device-region
        """Phase-2 cohort finisher: pure-f64 remainder, warm-started from
        each survivor's own phase-1 iterates (merit-gated)."""
        valid = torch.ones(th.shape[0], dtype=torch.bool, device=th.device)
        return _solve_pairs(self.prob, th, ds, self.point_p2, 0,
                            warm=(zw, sw, lw, valid))

    def _solve_fixed(self, th, ds):  # tpulint: device-region
        if self.backend == "serial":
            return self._host_pairs(th, ds, self.point_n_iter,
                                    self.point_n_f32)
        return _solve_pairs(self.prob, th, ds, self.point_n_iter,
                            self.point_n_f32)[:6]

    def _solve_rescue(self, th, ds):  # tpulint: device-region
        if self.backend == "serial":
            return self._host_pairs(th, ds, self.rescue_iter, 0)
        return _solve_pairs(self.prob, th, ds, self.rescue_iter, 0)[:6]

    # -- the serial baseline's programs: one QP at a time on the host ------

    def _pair_host(self, theta: np.ndarray, d: int, n_iter: int,
                   n_f32: int):
        """_solve_pairs for ONE (point, commutation) pair, in numpy:
        (V, conv, feas, grad, u0, z)."""
        h = self._host
        q = h.f[d] + h.F[d] @ theta
        b = h.w[d] + h.S[d] @ theta
        z, lam, _s, obj, conv, feas = host_qp.qp_solve(
            h.H[d], q, h.G[d], b, n_iter=n_iter, n_f32=n_f32)
        Yth = h.Y[d] @ theta
        V = (obj + np.sum(0.5 * theta * Yth) + np.sum(h.pvec[d] * theta)
             + h.cconst[d])
        grad = h.F[d].T @ z + Yth + h.pvec[d] - h.S[d].T @ lam
        u0 = h.u_map[d] @ z + h.u_theta[d] @ theta + h.u_const[d]
        return V, conv, feas, grad, u0, z

    def _solve_pair_one(self, theta: np.ndarray, d: int):
        """The single-pair program SerialBnB calls: one QP."""
        return self._pair_host(np.asarray(theta, dtype=np.float64), int(d),
                               self.point_n_iter, self.point_n_f32)

    def _host_pairs(self, th, ds, n_iter: int, n_f32: int):
        """The pair program's six outputs for a staged pair batch (one
        pair per call under the serial cap), solved on the host."""
        outs = [self._pair_host(t, int(d), n_iter, n_f32)
                for t, d in zip(_np(th), _np(ds))]
        return [torch.from_numpy(np.stack([np.asarray(o[k]) for o in outs]))
                for k in range(6)]

    def _host_points(self, thetas):
        """The grid program's 8 outputs for a staged point batch (one
        point per call under the serial cap): every commutation's QP at
        each point, then reduce_deltas' first-minimum reduction."""
        nd = self.can.n_delta
        th = _np(thetas)
        out = [[self._pair_host(t, d, self.point_n_iter, self.point_n_f32)
                 for d in range(nd)] for t in th]
        V, conv, feas, grad, u0, z = (
            np.array([[np.asarray(o[k]) for o in row] for row in out])
            for k in range(6))
        Vval = np.where(conv, V, _INF)
        dstar = np.argmin(Vval, axis=-1)
        Vstar = np.take_along_axis(Vval, dstar[:, None], -1)[:, 0]
        return [torch.from_numpy(a) for a in
                (V, conv, feas, grad, u0, z, Vstar, dstar)]

    def _simplex_min(self, Ms, ds):  # tpulint: device-region
        it = self.simplex_p1 if self._simplex_cohort else self.n_iter
        return _solve_simplex_min(self.prob, Ms, ds, it, self.n_f32)

    def _simplex_min_p2(self, Ms, ds, zw, sw, lw):  # tpulint: device-region
        valid = torch.ones(Ms.shape[0], dtype=torch.bool, device=Ms.device)
        return _solve_simplex_min(self.prob, Ms, ds, self.simplex_p2, 0,
                                  warm=(zw, sw, lw, valid))

    def _simplex_feas(self, Ms, ds):  # tpulint: device-region
        return _simplex_feas(self.prob, Ms, ds, self.n_iter, self.n_f32)

    # -- iteration ledger + metrics --------------------------------------

    def _iters(self, f32: int, f64: int, f64_fixed: int) -> None:
        """Record issued IPM iterations (and the f64 count the fixed
        single-phase schedule would have issued) in the host ledger."""
        self.n_iters_f32 += int(f32)
        self.n_iters_f64 += int(f64)
        self.n_iters_f64_fixed += int(f64_fixed)

    @property
    def wasted_iter_frac(self) -> float:
        """(fixed - actual) / fixed f64 iterations; 0.0 when two-phase is
        off or nothing has solved yet."""
        fixed = self.n_iters_f64_fixed
        return (fixed - self.n_iters_f64) / fixed if fixed else 0.0

    @property
    def phase2_survivor_frac(self) -> float:
        return (self.n_tp_survivors / self.n_tp_cells
                if self.n_tp_cells else 0.0)

    @property
    def warmstart_accept_rate(self) -> float:
        return (self.n_warm_accepts / self.n_warm_attempts
                if self.n_warm_attempts else 0.0)

    # Every additive statistic a CPU-fallback retry must fold back into
    # the main oracle (frontier._recover).
    _FOLD_STATS = ("n_solves", "n_point_solves", "n_simplex_solves",
                   "n_rescue_solves", "n_iters_f32", "n_iters_f64",
                   "n_iters_f64_fixed", "n_tp_cells", "n_tp_survivors",
                   "n_warm_attempts", "n_warm_accepts")

    def stat_snapshot(self) -> tuple:
        return tuple(getattr(self, k) for k in self._FOLD_STATS)

    def fold_stats(self, other: "Oracle", before: tuple) -> None:
        """Add the statistics `other` accumulated since `before` (its
        stat_snapshot) into this oracle."""
        for k, b in zip(self._FOLD_STATS, before):
            setattr(self, k, getattr(self, k) + getattr(other, k) - b)

    def reset_stats(self) -> None:
        for k in self._FOLD_STATS:
            setattr(self, k, 0)

    def _note_shape(self, family: str, rows: int) -> None:
        self.compiled_shapes.add((family, int(rows)))

    def _obs_batch(self, cls: str, n: int, wall: float,
                   iters_total: int, iters_f64: int | None = None) -> None:
        """Fold one batched device query into the metrics registry:
        per-QP blocking-wait latency (observed with weight n) plus the
        `oracle.ipm_iters` counter (exact, from the host ledger)."""
        if not self.obs.enabled or n <= 0:
            return
        m = self.obs.metrics
        m.histogram(f"oracle.{cls}_solve_s").observe(wall / n, n=n)
        m.counter(f"oracle.{cls}_solves").inc(n)
        m.counter("oracle.ipm_iters").inc(int(iters_total))
        if iters_f64 is not None:
            m.counter("oracle.ipm_iters_f64").inc(int(iters_f64))
        m.gauge("oracle.wasted_iter_frac").set(self.wasted_iter_frac)
        m.gauge("oracle.phase2_survivor_frac").set(
            self.phase2_survivor_frac)
        m.gauge("oracle.warmstart_accept_rate").set(
            self.warmstart_accept_rate)
        m.gauge("oracle.warm_attempts").set(self.n_warm_attempts)
        m.gauge("oracle.compiled_shapes").set(len(self.compiled_shapes))
        # 1 = the CUDA kernel runs the IPM legs, 0 = the plain version.
        m.gauge("oracle.ipm_kernel").set(
            1.0 if self.ipm_kernel == "cuda" else 0.0)
        # The blocking wall a QP on the kernel route, host work included
        # (the JAX package's per-tile figure): the batch's wall over its n
        # QPs, one K1 block each (oracle/ipm_leg.py); one observation a
        # batch, none on the plain route.
        if self.ipm_kernel == "cuda":
            m.histogram("oracle.ipm_kernel_tile_s").observe(wall / n)

    @staticmethod
    def _scaled_cond(H: np.ndarray) -> float:
        """Worst condition number over commutations of the Jacobi-scaled
        Hessians -- what the IPM iterates on after equilibration."""
        worst = 1.0
        for d in range(H.shape[0]):
            dg = np.diag(H[d])
            dc = np.sqrt(np.maximum(dg, max(dg.max(), 1e-300) * 1e-14))
            ev = np.linalg.eigvalsh(H[d] / dc[:, None] / dc[None, :])
            worst = max(worst, ev[-1] / max(ev[0], 1e-300))
        return float(worst)

    # -- the MICP-at-a-point query (reference: P_theta) --------------------

    @property
    def max_points_per_call(self) -> int:
        """Point-batch cap per launch group: bounds the (points x
        commutations) grid to ~2^16 simultaneous QP solves (2^15 for
        mixed precision) -- device memory for the per-cell KKT data.
        One for the serial baseline."""
        if self.backend == "serial":
            return 1
        nd = max(1, self.can.n_delta)
        budget = 65536 if self.point_n_f32 == 0 else 32768
        cap = 1 << max(3, (budget // nd).bit_length() - 1)
        return min(self.points_cap or 2048, 2048, cap)

    # -- flight-recorder capture (obs/recorder.py) -------------------------

    # Per-bundle cell cap: a storm of anomalies must produce a usable
    # repro, not a multi-GB artifact.
    MAX_CAPTURE_CELLS = 64

    def _capture_pairs(self, thetas: np.ndarray, ds: np.ndarray,
                       conv: np.ndarray, feas: np.ndarray, V: np.ndarray,
                       warm=None, trigger: str = "diverged_cells") -> None:
        """Dump (point, delta) cells that are feasible but unconverged
        AFTER the full pipeline into a repro bundle (no-op without a
        recorder or without anomalies).  Infeasible commutations are
        excluded by construction: they can never converge and are the
        normal, expected unconverged population."""
        rec = self.recorder
        if rec is None:
            return
        bad = np.asarray(feas, dtype=bool) & ~np.asarray(conv, dtype=bool)
        if not bad.any():
            return
        try:  # diagnostics must never break the solve it observes
            from explicit_hybrid_mpc_tpu_torch.obs import recorder as rec_lib

            idx = np.nonzero(bad)[0][:self.MAX_CAPTURE_CELLS]
            arrays = {**rec_lib.canonical_arrays(self.can),
                      "thetas": np.asarray(thetas)[idx],
                      "delta_idx": np.asarray(ds, dtype=np.int64)[idx],
                      "obs_conv": np.asarray(conv, dtype=bool)[idx],
                      "obs_feas": np.asarray(feas, dtype=bool)[idx],
                      "obs_V": np.asarray(V, dtype=np.float64)[idx]}
            if warm is not None:
                zw, sw, lw, hw = warm
                arrays.update(warm_z=np.asarray(zw)[idx],
                              warm_s=np.asarray(sw)[idx],
                              warm_lam=np.asarray(lw)[idx],
                              warm_has=np.asarray(hw, dtype=bool)[idx])
            rec.dump(trigger, arrays,
                     {"kind": "pairs",
                      "oracle": rec_lib.oracle_meta(self),
                      "backend": self.backend,
                      "n_anomalous": int(bad.sum()),
                      "captured": int(idx.size)})
        except Exception as e:  # full disk, bad permissions: counted
            rec.capture_error("oracle.pairs", e)

    def _capture_simplex(self, Ms: np.ndarray, ds: np.ndarray,
                         vmin: np.ndarray, feas_sw: np.ndarray) -> None:
        """Dump simplex rows whose stage-2 bound came back -inf (both
        joint solves stalled: certification is conservatively blocked
        and the cell will split -- the exact 'why did this region
        subdivide forever' repro)."""
        rec = self.recorder
        if rec is None:
            return
        bad = ~np.isfinite(vmin) & (vmin < 0)
        if not bad.any():
            return
        try:  # diagnostics must never break the solve it observes
            from explicit_hybrid_mpc_tpu_torch.obs import recorder as rec_lib

            idx = np.nonzero(bad)[0][:self.MAX_CAPTURE_CELLS]
            rec.dump("simplex_stall",
                     {**rec_lib.canonical_arrays(self.can),
                      "bary_Ms": np.asarray(Ms)[idx],
                      "delta_idx": np.asarray(ds, dtype=np.int64)[idx],
                      "obs_vmin": np.asarray(vmin,
                                             dtype=np.float64)[idx],
                      "obs_feas_sw": np.asarray(feas_sw,
                                                dtype=bool)[idx]},
                     {"kind": "simplex",
                      "oracle": rec_lib.oracle_meta(self),
                      "backend": self.backend,
                      "n_anomalous": int(bad.sum()),
                      "captured": int(idx.size)})
        except Exception as e:  # same contract as _capture_pairs
            rec.capture_error("oracle.simplex", e)

    def solve_vertices(self, thetas: np.ndarray) -> VertexSolution:
        """Solve the full enumeration at each point; pads the point batch
        to power-of-two buckets (bounded by max_points_per_call, larger
        batches are chunked)."""
        return self.wait_vertices(self.dispatch_vertices(thetas))

    def dispatch_vertices(self, thetas: np.ndarray):
        """Enqueue the device work for a vertex-grid solve WITHOUT
        blocking on the results; returns an opaque handle for
        wait_vertices."""
        thetas = np.atleast_2d(np.asarray(thetas, dtype=np.float64))
        P = thetas.shape[0]
        if P == 0:
            return ("empty",)
        # Fault-injection site: a scripted dispatch-time device error
        # raises here (the label carries the oracle's ROLE so a "dead
        # device" plan does not also fail the CPU recovery twin).
        faults_inj.fire("oracle.dispatch",
                        label="vertices:" + self._fault_role)
        # Solve counters increment at WAIT time, not here (a dispatched-
        # but-never-consumed lookahead must not count).  The serial
        # backend's cap of one point runs one host program per point.
        cap = self.max_points_per_call
        chunks = []
        for lo in range(0, P, cap):
            chunk = thetas[lo:lo + cap]
            Pc = chunk.shape[0]
            if self._mesh_solver is not None:
                # Unpadded device tensors, every block launched.
                chunks.append((self._mesh_solver(chunk), Pc))
                continue
            Ppad = min(cap, max(8, 1 << (Pc - 1).bit_length()))
            self._note_shape("grid", Ppad)
            pad = np.zeros((Ppad - Pc, thetas.shape[1]))
            out = self._solve_points(self._dev(np.concatenate([chunk, pad])))
            chunks.append((out, Pc))
        return ("chunks", thetas, chunks)

    def wait_vertices(self, handle) -> VertexSolution:
        """Block on a dispatch_vertices handle: device->host transfer,
        two-phase cohort, rescue pass, finalization."""
        kind = handle[0]
        if kind == "empty":
            nd = self.can.n_delta
            nt, nu, nz = self.can.n_theta, self.can.n_u, self.can.nz
            return VertexSolution(
                V=np.zeros((0, nd)), conv=np.zeros((0, nd), dtype=bool),
                feas=np.zeros((0, nd), dtype=bool),
                grad=np.zeros((0, nd, nt)), u0=np.zeros((0, nd, nu)),
                z=np.zeros((0, nd, nz)), Vstar=np.zeros(0),
                dstar=np.zeros(0, dtype=np.int64))
        t0 = time.perf_counter()
        lam = s = None
        surv = 0
        _, thetas, chunks = handle
        parts = [np.concatenate([_np(out[k])[:Pc] for out, Pc in chunks])
                 for k in range(self._n_grid_out)]
        if self._n_grid_out == 11:
            lam, s, rp = parts[8], parts[9], parts[10]
            parts = parts[:8]
            if self._point_cohort:
                # Two-phase: compact the unconverged survivors and
                # finish only those with the remaining iterations.
                surv = self._phase2_grid(thetas, parts, lam, s, rp)
        self._rescue_grid(thetas, parts, lam, s)
        # Counters last: if the transfer or the rescue raised, the caller
        # reroutes the WHOLE batch to the CPU fallback, whose own counts
        # are folded in -- counting here first would double-count it.
        n = thetas.shape[0] * self.can.n_delta
        self.n_solves += n
        self.n_point_solves += n
        if self._point_full_out:
            f64 = n * self._point_leg1 + surv * self.point_p2
            if self._point_cohort:
                self.n_tp_cells += n
                self.n_tp_survivors += surv
            self._iters(n * self.point_n_f32, f64, n * self.point_n_iter)
            self._obs_batch("point", n, time.perf_counter() - t0,
                            n * self.point_n_f32 + f64, f64)
        else:
            f64 = n * self.point_n_iter
            self._iters(n * self.point_n_f32, f64, f64)
            self._obs_batch("point", n, time.perf_counter() - t0,
                            n * ipm.schedule_iters(self.point_n_f32,
                                                   self.point_n_iter),
                            f64)
        sol = VertexSolution(*self._finalize(parts), lam=lam, s=s)
        if self.recorder is not None:
            # Grid cells replay bit-for-bit through the pair path: the
            # per-cell programs share schedules, and the cold start of a
            # gated-but-invalid warm tuple is bitwise the ungated cold
            # start.
            pt, dsb = np.nonzero(sol.feas & ~sol.conv)
            if pt.size:
                self._capture_pairs(thetas[pt], dsb, sol.conv[pt, dsb],
                                    sol.feas[pt, dsb], sol.V[pt, dsb])
        return sol

    def _rescue_grid(self, thetas: np.ndarray, parts: list,
                     lam: np.ndarray | None = None,
                     s: np.ndarray | None = None) -> None:
        """Re-solve feasible-but-unconverged grid cells in place (no-op
        when rescue_iter == 0 or nothing qualifies).  Rescued cells'
        lam/s donor slots are invalidated with NaN (the rescue program
        returns no duals)."""
        if self.rescue_iter <= 0:
            return
        V, conv, feas, grad, u0, z, Vstar, dstar = parts
        pt, ds = np.nonzero(feas & ~conv)
        if pt.size == 0:
            return
        rV, rconv, rfeas, rgrad, ru0, rz = self._rescue_pairs(
            thetas[pt], ds.astype(np.int64))
        V[pt, ds] = rV
        conv[pt, ds] = rconv
        feas[pt, ds] = rfeas
        grad[pt, ds] = rgrad
        u0[pt, ds] = ru0
        z[pt, ds] = rz
        if lam is not None:
            lam[pt, ds] = np.nan
            s[pt, ds] = np.nan
        self._rereduce(np.unique(pt), V, conv, Vstar, dstar)

    @staticmethod
    def _rereduce(points, V, conv, Vstar, dstar) -> None:
        """Re-reduce touched points (same first-minimum tie-break as
        reduce_deltas)."""
        for p in points:
            Vval = np.where(conv[p], V[p], _INF)
            j = int(np.argmin(Vval))
            Vstar[p] = Vval[j]
            dstar[p] = j if np.isfinite(Vval[j]) else -1

    def _rescue_pairs(self, thetas: np.ndarray, ds: np.ndarray):
        """Cold full-length f64 re-solve of (point, delta) pairs with the
        dedicated rescue program; padded/chunked like solve_pairs."""
        K = thetas.shape[0]
        self.n_solves += K
        self.n_rescue_solves += K
        t0 = time.perf_counter()
        # The serial cap keeps the one-QP-per-call contract here too.
        cap = self.max_pairs_per_call
        chunks = []
        for lo in range(0, K, cap):
            tj, dj, Kc = self._pad_pairs(thetas[lo:lo + cap],
                                         ds[lo:lo + cap], family="rescue")
            out = self._solve_rescue(tj, dj)
            chunks.append([_np(o)[:Kc] for o in out])
        parts = [np.concatenate([c[k] for c in chunks]) for k in range(6)]
        f64 = K * self.rescue_iter
        self._iters(0, f64, f64)
        self._obs_batch("rescue", K, time.perf_counter() - t0, f64, f64)
        return parts

    def _pad_pairs(self, thetas: np.ndarray, ds: np.ndarray,
                   family: str = "pairs"):
        """Pad a (point, delta) pair batch to its power-of-two bucket and
        stage it on the device.  `family` names the program the batch
        feeds for the bucket ledger.  A cap below 8 (the serial
        baseline's 1) is honoured."""
        Kc = thetas.shape[0]
        Kpad = min(self.max_pairs_per_call,
                   max(8, 1 << (Kc - 1).bit_length()))
        self._note_shape(family, Kpad)
        tpad = np.concatenate(
            [thetas, np.zeros((Kpad - Kc, thetas.shape[1]))])
        dpad = np.concatenate([ds, np.zeros(Kpad - Kc, dtype=np.int64)])
        return self._dev(tpad), self._idx(dpad), Kc

    # -- two-phase cohort (point class) ------------------------------------

    def _pad_warm(self, arrs, lo: int, hi: int, n_pad: int):
        """Zero-pad slices of per-cell warm arrays to a padded bucket and
        stage them on the device (the one padding rule shared by the ws
        dispatch and the point and simplex phase-2 finishers)."""
        return [self._dev(np.concatenate(
            [a[lo:hi], np.zeros((n_pad,) + a.shape[1:], dtype=a.dtype)]),
            dtype=None) for a in arrs]

    def _solve_p2_cells(self, thetas: np.ndarray, ds: np.ndarray,
                        zw: np.ndarray, sw: np.ndarray, lw: np.ndarray):
        """Chunked+padded phase-2 finisher over (point, delta) survivor
        cells, warm-started from their own phase-1 iterates.  Returns the
        8 result arrays (V, conv, feas, grad, u0, z, lam, s) truncated to
        K."""
        K = thetas.shape[0]
        cap = self.max_pairs_per_call
        outs = []
        for lo in range(0, K, cap):
            tj, dj, Kc = self._pad_pairs(thetas[lo:lo + cap],
                                         ds[lo:lo + cap], family="pairs_p2")
            zj, sj, lj = self._pad_warm((zw, sw, lw), lo, lo + cap,
                                        tj.shape[0] - Kc)
            out = self._solve_pairs_p2(tj, dj, zj, sj, lj)
            outs.append([_np(o)[:Kc] for o in out[:8]])
        return [np.concatenate([c[k] for c in outs]) for k in range(8)]

    # Diverged-cell early exit: an unconverged phase-1 cell whose
    # relative primal residual is still above this is an infeasible QP
    # diverging -- the remaining schedule cannot converge it.  Skipping
    # it keeps conv=False/feas=False exactly as the full schedule would.
    _DIVERGED_RP = 1e-2

    def _tp_survivors(self, conv, rp):
        """Indices of cells that continue into phase 2."""
        return np.nonzero(~np.asarray(conv, dtype=bool)
                          & np.isfinite(rp) & (rp <= self._DIVERGED_RP))

    def _phase2_grid(self, thetas: np.ndarray, parts: list,
                     lam: np.ndarray, s: np.ndarray,
                     rp: np.ndarray) -> int:
        """Finish the unconverged, non-diverged survivors of a phase-1
        grid solve in place.  Updates `parts` AND the lam/s donor
        arrays; returns the survivor count."""
        V, conv, feas, grad, u0, z, Vstar, dstar = parts
        pt, ds = self._tp_survivors(conv, rp)
        if pt.size == 0:
            return 0
        rV, rconv, rfeas, rgrad, ru0, rz, rlam, rs = self._solve_p2_cells(
            thetas[pt], ds.astype(np.int64), z[pt, ds], s[pt, ds],
            lam[pt, ds])
        V[pt, ds] = rV
        conv[pt, ds] = rconv
        feas[pt, ds] = rfeas
        grad[pt, ds] = rgrad
        u0[pt, ds] = ru0
        z[pt, ds] = rz
        lam[pt, ds] = rlam
        s[pt, ds] = rs
        self._rereduce(np.unique(pt), V, conv, Vstar, dstar)
        return int(pt.size)

    @staticmethod
    def _finalize(parts):
        V, conv, feas, grad, u0, z, Vstar, dstar = parts
        V = np.where(conv, V, _INF)
        dstar = np.where(np.isfinite(Vstar), dstar, -1)
        return (V, conv.astype(bool), feas.astype(bool), grad, u0, z,
                Vstar, dstar.astype(np.int64))

    # -- the simplex-wide bound query (reference: V_R-style) ---------------

    # Simplex-query batches pad to power-of-two buckets CAPPED at this many
    # rows; larger batches are chunked.
    max_simplex_rows_per_call: int = 1024

    def simplex_bucket(self, K: int) -> int:
        """Padded row count for a K-row simplex query: power-of-two,
        capped at max_simplex_rows_per_call."""
        return max(8, min(self.max_simplex_rows_per_call,
                          1 << (K - 1).bit_length()))

    def _pad_simplex(self, Ms: np.ndarray, ds: np.ndarray,
                     family: str = "simplex_min"):
        K = Ms.shape[0]
        Kpad = self.simplex_bucket(K)
        self._note_shape(family, Kpad)
        Mpad = np.concatenate(
            [Ms, np.tile(np.eye(Ms.shape[1])[None], (Kpad - K, 1, 1))])
        dpad = np.concatenate([ds, np.zeros(Kpad - K, dtype=np.int64)])
        return self._dev(Mpad), self._idx(dpad)

    def solve_simplex_min(self, bary_Ms: np.ndarray,
                          delta_idx: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """min_{theta in R} V_delta(theta) for a batch of (simplex, delta).

        Returns (Vmin, feasible_somewhere).  Encoding of Vmin:
        - finite: certified LOWER BOUND on the simplex minimum from the
                  elastic joint QP (sound either way);
        - +inf:   POSITIVE evidence of infeasibility on all of R (the
                  joint phase-1 converged with violation t* > tol and a
                  Farkas certificate) -- excludable from the V* bound;
        - -inf:   no usable bound (either solve stalled) -- blocks
                  certification, forcing a split.

        Solve order: min-first (single-commutation problems; phase-1
        only on rows without a zero-slack elastic witness) or
        phase1-first (hybrid problems; the elastic min only on rows not
        certified infeasible)."""
        K = bary_Ms.shape[0]
        if K == 0:
            return np.zeros(0), np.zeros(0, dtype=bool)
        t0 = time.perf_counter()
        n_before = self.n_solves
        it0 = self.n_iters_f32 + self.n_iters_f64
        f64_0 = self.n_iters_f64
        delta_idx = np.asarray(delta_idx, dtype=np.int64)
        cap = self.max_simplex_rows_per_call
        outs, feas_sw = [], []
        for lo in range(0, K, cap):
            Kc = min(cap, K - lo)
            Ms_c = bary_Ms[lo:lo + cap]
            ds_c = delta_idx[lo:lo + cap]
            if self.stage2_phase1_first:
                self.n_solves += Kc
                self.n_simplex_solves += Kc
                t, t_conv, farkas = self._run_simplex_feas(Ms_c, ds_c)
                infeasible = t_conv & (t > 1e-6) & farkas
                out = np.full(Kc, _INF)
                feasible_somewhere = t_conv & (t <= 1e-6)
                self._elastic_min_into(Ms_c, ds_c,
                                       np.where(~infeasible)[0],
                                       out, feasible_somewhere)
            else:
                out = np.full(Kc, -_INF)
                feasible_somewhere = np.zeros(Kc, dtype=bool)
                self._elastic_min_into(Ms_c, ds_c, np.arange(Kc),
                                       out, feasible_somewhere)
                need_p1 = ~feasible_somewhere
                if np.any(need_p1):
                    idx = np.where(need_p1)[0]
                    self.n_solves += idx.size
                    self.n_simplex_solves += idx.size
                    t, t_conv, farkas = self._run_simplex_feas(
                        Ms_c[idx], ds_c[idx])
                    infeasible = t_conv & (t > 1e-6) & farkas
                    out[idx[infeasible]] = _INF
                    feasible_somewhere[idx] = t_conv & (t <= 1e-6)
            outs.append(out)
            feas_sw.append(feasible_somewhere)
        self._obs_batch("simplex", self.n_solves - n_before,
                        time.perf_counter() - t0,
                        self.n_iters_f32 + self.n_iters_f64 - it0,
                        self.n_iters_f64 - f64_0)
        out_all = np.concatenate(outs)
        feas_all = np.concatenate(feas_sw)
        if self.recorder is not None:
            self._capture_simplex(bary_Ms, delta_idx, out_all, feas_all)
        return out_all, feas_all

    def _elastic_min_into(self, Ms: np.ndarray, ds: np.ndarray,
                          idx: np.ndarray, out: np.ndarray,
                          feasible_somewhere: np.ndarray) -> None:
        """Run the elastic simplex-min on rows `idx`, scattering the
        (finite bound | -inf) encoding into `out` and OR-ing the
        zero-slack feasibility witness into `feasible_somewhere`."""
        if idx.size == 0:
            return
        n = idx.size
        self.n_solves += n
        self.n_simplex_solves += n
        Mj, dj = self._pad_simplex(Ms[idx], ds[idx], family="simplex_min")
        V, conv, _feas, t_el, zj, lamj, sj = self._simplex_min(Mj, dj)
        V = _np(V)[:n].copy()
        conv = _np(conv)[:n].astype(bool)
        t_el = _np(t_el)[:n].copy()
        if self._simplex_cohort:
            # Two-phase: short first leg on every row, host-read of the
            # converged mask, warm-started finisher on the survivors
            # only -- survivors receive exactly the remaining schedule.
            surv = np.nonzero(~conv)[0]
            self.n_tp_cells += n
            self.n_tp_survivors += surv.size
            self._iters(n * self.n_f32,
                        n * self.simplex_p1 + surv.size * self.simplex_p2,
                        n * self.n_iter)
            if surv.size:
                zj = _np(zj)[:n]
                lamj = _np(lamj)[:n]
                sj = _np(sj)[:n]
                Mj2, dj2 = self._pad_simplex(Ms[idx[surv]], ds[idx[surv]],
                                             family="simplex_p2")
                z2, s2, l2 = self._pad_warm(
                    (zj[surv], sj[surv], lamj[surv]), 0, surv.size,
                    Mj2.shape[0] - surv.size)
                V2, conv2, _f2, t2, _z2, _l2, _s2 = self._simplex_min_p2(
                    Mj2, dj2, z2, s2, l2)
                V[surv] = _np(V2)[:surv.size]
                conv[surv] = _np(conv2)[:surv.size]
                t_el[surv] = _np(t2)[:surv.size]
        else:
            self._iters(n * self.n_f32, n * self.n_iter, n * self.n_iter)
        out[idx] = np.where(conv, V, -_INF)
        feasible_somewhere[idx] |= conv & (t_el <= 1e-6)

    def warm_pair_bucket(self, thetas: np.ndarray, ds: np.ndarray) -> None:
        """Launch every pair-class program (phase-1 -- warm-capable or
        legacy -- plus the phase-2 cohort finisher and the rescue
        program when enabled) at the padded bucket of `thetas` without
        counting solves, noting each shape in the ledger.  A warmup
        over every bucket makes the ledger hold the EXACT program set a
        build dispatches ("warm shapes == run shapes"): the cohort
        re-pads survivors into the same {8..cap} bucket family, so one
        zero-warm call per bucket covers phase 2 too."""
        thetas = np.atleast_2d(np.asarray(thetas, dtype=np.float64))
        ds = np.asarray(ds, dtype=np.int64)
        tj, dj, _Kc = self._pad_pairs(thetas, ds)
        K = int(tj.shape[0])
        nz, nc = self.can.nz, self.can.nc
        zeros = (torch.zeros((K, nz), dtype=torch.float64,
                             device=self.device),
                 torch.zeros((K, nc), dtype=torch.float64,
                             device=self.device),
                 torch.zeros((K, nc), dtype=torch.float64,
                             device=self.device))
        if self._point_full_out:
            self._solve_pairs_ws(tj, dj, *zeros, torch.zeros(
                K, dtype=torch.bool, device=self.device))
        else:
            self._solve_fixed(tj, dj)
        if self._point_cohort:
            self._note_shape("pairs_p2", K)
            self._solve_pairs_p2(tj, dj, *zeros)
        if self.rescue_iter > 0:
            self._note_shape("rescue", K)
            self._solve_rescue(tj, dj)

    def warm_simplex_bucket(self, Ms: np.ndarray, ds: np.ndarray) -> None:
        """Launch BOTH joint-QP programs (elastic min + phase-1) at the
        padded bucket of `Ms` without counting solves.  A warmup must hit
        every bucket directly: going through solve_simplex_min runs the
        second program of the active stage-2 order only on a
        data-dependent subset."""
        Mj, dj = self._pad_simplex(np.asarray(Ms),
                                   np.asarray(ds, dtype=np.int64),
                                   family="simplex_min")
        self._note_shape("simplex_feas", Mj.shape[0])
        self._simplex_min(Mj, dj)
        self._simplex_feas(Mj, dj)
        if self._simplex_cohort:
            # Phase-2 cohort buckets run at the SAME padded sizes
            # (survivor compaction re-pads into the {8..cap} set), so
            # one zero-warm call per bucket covers them.
            self._note_shape("simplex_p2", Mj.shape[0])
            K = int(Mj.shape[0])
            dim_z = self.can.nz + self.can.n_theta + 1
            dim_c = self.can.nc + int(Mj.shape[1]) + 1
            self._simplex_min_p2(
                Mj, dj, *(torch.zeros((K, d), dtype=torch.float64,
                                      device=self.device)
                          for d in (dim_z, dim_c, dim_c)))

    def _run_simplex_feas(self, Ms: np.ndarray, ds: np.ndarray
                          ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """One padded+chunked pass of the joint phase-1 program (raw
        (t*, converged, farkas) triplets, no solve counting)."""
        K = Ms.shape[0]
        cap = self.max_simplex_rows_per_call
        ts, convs, fks = [], [], []
        for lo in range(0, K, cap):
            Mj, dj = self._pad_simplex(Ms[lo:lo + cap], ds[lo:lo + cap],
                                       family="simplex_feas")
            Kc = min(cap, K - lo)
            t, conv, farkas = self._simplex_feas(Mj, dj)
            ts.append(_np(t)[:Kc])
            convs.append(_np(conv)[:Kc])
            fks.append(_np(farkas)[:Kc])
        # The sound Farkas/phase-1 program is single-phase by design.
        self._iters(K * self.n_f32, K * self.n_iter, K * self.n_iter)
        return np.concatenate(ts), np.concatenate(convs), np.concatenate(fks)

    def simplex_feasibility(self, bary_Ms: np.ndarray,
                            delta_idx: np.ndarray
                            ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Joint phase-1 over simplices: (t*, feasible_somewhere,
        infeasible_certified) per (simplex, delta) row;
        infeasible_certified requires t* > tol AND a Farkas dual
        certificate."""
        K = bary_Ms.shape[0]
        if K == 0:
            z = np.zeros(0)
            return z, z.astype(bool), z.astype(bool)
        self.n_solves += K
        self.n_simplex_solves += K
        delta_idx = np.asarray(delta_idx, dtype=np.int64)
        t0 = time.perf_counter()
        t, conv, farkas = self._run_simplex_feas(bary_Ms, delta_idx)
        it = K * ipm.schedule_iters(self.n_f32, self.n_iter)
        self._obs_batch("simplex", K, time.perf_counter() - t0,
                        it, K * self.n_iter)
        return t, conv & (t <= 1e-6), conv & (t > 1e-6) & farkas

    # -- fixed-commutation (point, delta) pair solves ----------------------

    # Pair-batch cap per launch group (same role as
    # max_simplex_rows_per_call).
    max_pairs_per_call: int = 1024

    def solve_pairs(self, thetas: np.ndarray, delta_idx: np.ndarray):
        """P_theta_delta at given (point, commutation) pairs: the sparse
        counterpart of solve_vertices' dense grid.  Returns (V (K,),
        converged (K,), grad (K, n_theta), u0 (K, n_u), z (K, nz)); V is
        +inf where unconverged."""
        return self.wait_pairs(self.dispatch_pairs(thetas, delta_idx))

    def solve_pairs_full(self, thetas: np.ndarray, delta_idx: np.ndarray,
                         warm=None):
        """solve_pairs plus the final duals/slacks appended (None on
        oracles without the full-output programs)."""
        return self.wait_pairs_full(
            self.dispatch_pairs(thetas, delta_idx, warm=warm))

    def dispatch_pairs(self, thetas: np.ndarray, delta_idx: np.ndarray,
                       warm=None):
        """Non-blocking counterpart of solve_pairs (see
        dispatch_vertices).

        warm: optional (z0 (K,nz), s0 (K,nc), lam0 (K,nc), has (K,))
        tree-warm-start donor arrays aligned with the pair batch; each
        cell's start goes through the merit gate (valid only where
        `has` is set).  Ignored on oracles without the warm-capable
        programs (the serial one among them)."""
        thetas = np.atleast_2d(np.asarray(thetas, dtype=np.float64))
        K = thetas.shape[0]
        if K == 0:
            return ("empty",)
        faults_inj.fire("oracle.dispatch",
                        label="pairs:" + self._fault_role)
        delta_idx = np.asarray(delta_idx, dtype=np.int64)
        cap = self.max_pairs_per_call
        chunks = []
        if self._point_full_out:
            nz, nc = self.can.nz, self.can.nc
            if warm is None:
                zw = np.zeros((K, nz))
                sw = np.zeros((K, nc))
                lw = np.zeros((K, nc))
                hw = np.zeros(K, dtype=bool)
            else:
                zw, sw, lw, hw = warm
            for lo in range(0, K, cap):
                tj, dj, Kc = self._pad_pairs(thetas[lo:lo + cap],
                                             delta_idx[lo:lo + cap])
                zj, sj, lj, hj = self._pad_warm(
                    (zw, sw, lw, hw), lo, lo + cap, tj.shape[0] - Kc)
                chunks.append(
                    (self._solve_pairs_ws(tj, dj, zj, sj, lj, hj), Kc))
            # The warm arrays ride the handle so the flight recorder's
            # wait-time capture can bundle the EXACT starts the failing
            # cells were given (references only -- no copies).
            return ("ws_chunks", thetas, delta_idx, chunks, hw,
                    (zw, sw, lw))
        for lo in range(0, K, cap):
            tj, dj, Kc = self._pad_pairs(thetas[lo:lo + cap],
                                         delta_idx[lo:lo + cap])
            chunks.append((self._solve_fixed(tj, dj), Kc))
        return ("chunks", thetas, delta_idx, chunks)

    def wait_pairs(self, handle):
        """Block on a dispatch_pairs handle: transfer, cohort phase 2,
        rescue, finalize."""
        return self.wait_pairs_full(handle)[:5]

    def wait_pairs_full(self, handle):
        """wait_pairs returning (V, conv, grad, u0, z, lam, s); lam/s
        are the final duals/slacks on full-output paths, None on the
        others."""
        out = self._wait_pairs_all(handle)
        return out[:2] + out[3:]

    def solve_pairs_masks(self, thetas: np.ndarray, delta_idx: np.ndarray,
                          warm=None):
        """(V, conv, feas) of solve_pairs_full's pipeline: the values and
        masks a flight-recorder pairs bundle holds, for its replay."""
        out = self._wait_pairs_all(
            self.dispatch_pairs(thetas, delta_idx, warm=warm))
        return out[0], out[1], out[2]

    def _wait_pairs_all(self, handle):
        """The pair wait: (V, conv, feas, grad, u0, z, lam, s)."""
        kind = handle[0]
        if kind == "empty":
            nt, nu, nz = self.can.n_theta, self.can.n_u, self.can.nz
            return (np.zeros(0), np.zeros(0, dtype=bool),
                    np.zeros(0, dtype=bool), np.zeros((0, nt)),
                    np.zeros((0, nu)), np.zeros((0, nz)), None, None)
        t0 = time.perf_counter()
        if kind == "ws_chunks":
            _, thetas, delta_idx, chunks, hw, (zw_in, sw_in, lw_in) = handle
            parts = [np.concatenate([_np(out[k])[:Kc]
                                     for out, Kc in chunks])
                     for k in range(10)]
            V, conv, feas, grad, u0, z, lam, s, rp, wok = parts
            conv, feas = conv.astype(bool), feas.astype(bool)
            K = thetas.shape[0]
            surv = 0
            if self._point_cohort:
                (sidx,) = self._tp_survivors(conv, rp)
                surv = sidx.size
            if surv:
                rV, rconv, rfeas, rgrad, ru0, rz, rlam, rs = \
                    self._solve_p2_cells(thetas[sidx], delta_idx[sidx],
                                         z[sidx], s[sidx], lam[sidx])
                V[sidx], conv[sidx], feas[sidx] = rV, rconv, rfeas
                grad[sidx], u0[sidx], z[sidx] = rgrad, ru0, rz
                lam[sidx], s[sidx] = rlam, rs
            if self.rescue_iter > 0 and np.any(feas & ~conv):
                idx = np.nonzero(feas & ~conv)[0]
                rV, rconv, _rfeas, rgrad, ru0, rz = self._rescue_pairs(
                    thetas[idx], delta_idx[idx])
                V[idx], conv[idx], grad[idx] = rV, rconv, rgrad
                u0[idx], z[idx] = ru0, rz
                # No duals from the rescue program: invalidate the
                # donor slots (see _rescue_grid).
                lam[idx] = np.nan
                s[idx] = np.nan
            # Counters last (see wait_vertices) -- including the warm
            # ledger.
            n_att = int(hw.sum())
            if n_att:
                self.n_warm_attempts += n_att
                self.n_warm_accepts += int(wok.astype(bool)[hw].sum())
            self.n_solves += K
            self.n_point_solves += K
            f64 = K * self._point_leg1 + surv * self.point_p2
            if self._point_cohort:
                self.n_tp_cells += K
                self.n_tp_survivors += surv
            self._iters(K * self.point_n_f32, f64, K * self.point_n_iter)
            self._obs_batch("point", K, time.perf_counter() - t0,
                            K * self.point_n_f32 + f64, f64)
            Vout = np.where(conv, V, _INF)
            if self.recorder is not None:
                self._capture_pairs(thetas, delta_idx, conv, feas, Vout,
                                    warm=(zw_in, sw_in, lw_in, hw))
            return Vout, conv, feas, grad, u0, z, lam, s
        _, thetas, delta_idx, chunks = handle
        parts = [np.concatenate([_np(out[k])[:Kc] for out, Kc in chunks])
                 for k in range(6)]
        V, conv, feas, grad, u0, z = parts
        conv, feas = conv.astype(bool), feas.astype(bool)
        if self.rescue_iter > 0 and np.any(feas & ~conv):
            idx = np.nonzero(feas & ~conv)[0]
            rV, rconv, _rfeas, rgrad, ru0, rz = self._rescue_pairs(
                thetas[idx], delta_idx[idx])
            V[idx], conv[idx], grad[idx] = rV, rconv, rgrad
            u0[idx], z[idx] = ru0, rz
        K = thetas.shape[0]
        self.n_solves += K
        self.n_point_solves += K
        f64 = K * self.point_n_iter
        self._iters(K * self.point_n_f32, f64, f64)
        self._obs_batch("point", K, time.perf_counter() - t0,
                        K * ipm.schedule_iters(self.point_n_f32,
                                               self.point_n_iter), f64)
        Vout = np.where(conv, V, _INF)
        if self.recorder is not None:
            self._capture_pairs(thetas, delta_idx, conv, feas, Vout)
        return Vout, conv, feas, grad, u0, z, None, None

    # -- fixed-commutation point solve (the semi-explicit ONLINE stage) ----

    def solve_fixed(self, thetas: np.ndarray, delta_idx: np.ndarray
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                               np.ndarray]:
        """P_theta_delta at given (point, commutation) pairs.

        The deployment-time query of the feasibility-only
        ('feasible'/ECC) variant: the offline partition only fixes a
        feasible commutation per leaf, and the online controller solves
        this small fixed-delta convex QP at the current parameter (one
        pair padded to a bucket of 8 through the IPM leg).

        Returns (u0 (K, n_u), V (K,), converged (K,), z (K, nz)).
        """
        thetas = np.atleast_2d(np.asarray(thetas, dtype=np.float64))
        if thetas.shape[0] == 0:
            return (np.zeros((0, self.can.n_u)), np.zeros(0),
                    np.zeros(0, dtype=bool), np.zeros((0, self.can.nz)))
        V, conv, _grad, u0, z = self.solve_pairs(thetas, delta_idx)
        return u0, V, conv, z

    # -- pointwise feasibility (phase-1) -----------------------------------

    def feasibility(self, thetas: np.ndarray,
                    delta_idx: np.ndarray) -> np.ndarray:
        """Minimal constraint violation t* of commutation delta_idx[k] at
        point thetas[k] (<= tol means feasible).  Keeps the sound full
        single-phase schedule."""
        thetas = np.atleast_2d(np.asarray(thetas, dtype=np.float64))
        K = thetas.shape[0]
        self.n_solves += K
        Kpad = max(8, 1 << (K - 1).bit_length())
        self._note_shape("point_feas", Kpad)
        tpad = np.concatenate(
            [thetas, np.zeros((Kpad - K, thetas.shape[1]))])
        dpad = np.concatenate([np.asarray(delta_idx, dtype=np.int64),
                               np.zeros(Kpad - K, dtype=np.int64)])
        th, ds = self._dev(tpad), self._idx(dpad)
        t = ipm.phase1(self.prob.G[ds],
                       self.prob.w[ds] + _bmv(self.prob.S[ds], th),
                       n_iter=self.n_iter, n_f32=self.n_f32)
        self._iters(K * self.n_f32, K * self.n_iter, K * self.n_iter)
        return _np(t)[:K]
