"""Closed-loop simulation: explicit PWA controller vs implicit MPC.

Rolls the plant under the explicit controller and, for comparison,
under the implicit (online-solved) MPC, recording trajectories and
per-step evaluation times.  The counterpart of the JAX package's
sim/simulator.py.

Controllers are callables theta -> (u, info), each on an explicit
torch device ('cuda' by default, raising without one; 'cpu' on
request):

- ExplicitController: the deployed artifact -- point location +
  barycentric interpolation over the exported leaf table.  Backends:
  'kernel' (online/locate.py: the point-location kernel K2 plus the
  f64 gather -- the JAX package's 'pallas'; on the CPU it runs K2's
  plain version), 'torch' (online/evaluator.py, the plain f64
  evaluator -- the JAX package's 'jax') and 'descent'
  (online/descent.py).
- SemiExplicitController: a feasibility-only partition's deployment --
  locate fixes the leaf's commutation, Oracle.solve_fixed solves the
  small fixed-delta QP online (through the IPM leg, K1, on a CUDA
  oracle).
- ImplicitController: the comparison baseline -- one full enumeration
  oracle solve (the MICP, K1 on a CUDA oracle) at the current
  parameter, what online MPC would run without the offline partition.

Each controller is warmed before its first timed step: on the card the
warm call builds the kernels (nvcc, first use) and makes their first
launch, so neither lands in ``eval_s``.  A step reads its result back
to the host once.

The explicit controller's certificate guarantees u within eps of
optimal INSIDE the partitioned set; the simulator records the `inside`
flag so excursions are visible rather than silent.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from explicit_hybrid_mpc_tpu_torch import device as device_lib
from explicit_hybrid_mpc_tpu_torch.online import evaluator
from explicit_hybrid_mpc_tpu_torch.online.export import LeafTable

#: ExplicitController backends (the JAX package's 'pallas' / 'jax' /
#: 'descent').
BACKENDS = ("kernel", "torch", "descent")


class StepInfo(NamedTuple):
    eval_s: float
    inside: bool
    cost_pred: float     # controller's own cost claim (certified upper
    #                      bound for explicit, V* for implicit); NaN if n/a


class SimResult(NamedTuple):
    states: np.ndarray      # (T+1, n_x)
    inputs: np.ndarray      # (T, n_u)
    stage_costs: np.ndarray  # (T,)
    eval_s: np.ndarray      # (T,) per-step controller wall time
    inside: np.ndarray      # (T,) bool
    cost_pred: np.ndarray   # (T,)

    @property
    def total_cost(self) -> float:
        return float(self.stage_costs.sum())

    @property
    def mean_eval_us(self) -> float:
        return float(self.eval_s.mean() * 1e6)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class ExplicitController:
    """theta -> interpolated PWA law from a built partition."""

    def __init__(self, table: LeafTable, backend: str = "kernel",
                 device="cuda", descent_table=None):
        """backend: one of BACKENDS; 'descent' needs `descent_table`
        (online.descent.export_descent, host or staged)."""
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r} (expected one "
                             f"of {BACKENDS})")
        self.device = device_lib.resolve(device)
        self.table = table
        self.backend = backend
        self.dev = evaluator.stage(table, device=self.device)
        if backend == "kernel":
            from explicit_hybrid_mpc_tpu_torch.online import locate

            self._lt = locate.stage(table, device=self.device)
            self._eval = lambda th: locate.evaluate(self._lt, self.dev, th)
        elif backend == "descent":
            from explicit_hybrid_mpc_tpu_torch.online import descent

            if descent_table is None:
                raise ValueError("backend='descent' needs descent_table")
            dt = descent.stage_table(descent_table, self.device)
            self._eval = lambda th: descent.evaluate_descent(dt, self.dev,
                                                             th)
        else:
            self._eval = lambda th: evaluator.evaluate(self.dev, th)
        # Warm: the kernels' first-use build and first launch must not
        # land in the per-step timing.
        p = table.bary_M.shape[1] - 1
        self._eval(torch.zeros((1, p), dtype=torch.float64,
                               device=self.device))
        _sync(self.device)

    def locate_step(self, theta: np.ndarray) -> tuple[int, bool, np.ndarray,
                                                      float]:
        """(leaf, inside, u, cost) at one theta, read back in ONE
        device-to-host copy."""
        th = torch.as_tensor(np.asarray(theta, dtype=np.float64)[None],
                             device=self.device)
        out = self._eval(th)
        f64 = torch.float64
        row = torch.cat([out.u[0].to(f64), out.cost[:1].to(f64),
                         out.inside[:1].to(f64),
                         out.leaf[:1].to(f64)]).cpu().numpy()
        n_u = out.u.shape[1]
        return (int(row[n_u + 2]), bool(row[n_u + 1]), row[:n_u],
                float(row[n_u]))

    def __call__(self, theta: np.ndarray) -> tuple[np.ndarray, StepInfo]:
        t0 = time.perf_counter()
        _leaf, inside, u, cost = self.locate_step(theta)
        dt = time.perf_counter() - t0
        return u, StepInfo(eval_s=dt, inside=inside, cost_pred=cost)


class SemiExplicitController:
    """Deployment of a feasibility-only ('feasible'/ECC) partition.

    The offline stage only certifies a FEASIBLE commutation per leaf;
    the online guarantee comes from solving the small fixed-delta
    convex QP at the current parameter, not from interpolating vertex
    inputs.  Point location fixes delta; Oracle.solve_fixed supplies u.

    Falls back to the interpolated vertex inputs only if the online QP
    fails to converge, and then flips `inside` False so the failure is
    visible.
    """

    def __init__(self, table: LeafTable, oracle,
                 backend: str = "kernel", device="cuda", semi_mask=None):
        """semi_mask: optional (L,) bool (online.export.semi_explicit_mask).
        When given, only rows marked True take the online fixed-delta QP
        path; the rest return the interpolated eps-certified law
        directly (a HYBRID partition).  None = every leaf is
        semi-explicit (a pure 'feasible' build)."""
        self.oracle = oracle
        self._loc = ExplicitController(table, backend=backend,
                                       device=device)
        self.table = table
        self.semi_mask = semi_mask
        # Warm the fixed-delta solve (timing parity with the other
        # controllers' warmup), leaving the oracle's counters as they
        # were.
        n = oracle.n_solves
        oracle.solve_fixed(np.zeros((1, oracle.can.n_theta)),
                           np.zeros(1, dtype=np.int64))
        oracle.n_solves = n
        oracle.n_point_solves -= 1

    def __call__(self, theta: np.ndarray) -> tuple[np.ndarray, StepInfo]:
        t0 = time.perf_counter()
        leaf, inside, u_interp, cost = self._loc.locate_step(theta)
        if self.semi_mask is not None and not self.semi_mask[leaf]:
            # eps-certified leaf of a hybrid partition: the interpolated
            # law already carries the certificate; no online QP.
            return u_interp, StepInfo(eval_s=time.perf_counter() - t0,
                                      inside=inside, cost_pred=cost)
        d = int(self.table.delta[leaf])
        u0, V, conv, _z = self.oracle.solve_fixed(theta[None],
                                                  np.array([d]))
        dt = time.perf_counter() - t0
        if conv[0]:
            return u0[0], StepInfo(eval_s=dt, inside=inside,
                                   cost_pred=float(V[0]))
        # Online QP failed: interpolated law as best effort, flagged.
        return u_interp, StepInfo(eval_s=dt, inside=False, cost_pred=cost)


class ImplicitController:
    """theta -> u from a full online enumeration solve (the baseline the
    explicit law replaces)."""

    def __init__(self, oracle, device="cuda"):
        """`device` must be the oracle's own (the solve runs there)."""
        if device_lib.resolve(device) != oracle.device:
            raise ValueError(f"ImplicitController(device={device!r}) but "
                             f"the oracle runs on {oracle.device}")
        self.oracle = oracle
        # Warm the single-point solve (timing parity with
        # ExplicitController's warmup), leaving the counters as they
        # were.
        n_solves = oracle.n_solves
        oracle.solve_vertices(np.zeros((1, oracle.can.n_theta)))
        oracle.n_solves = n_solves
        oracle.n_point_solves -= oracle.can.n_delta

    def __call__(self, theta: np.ndarray) -> tuple[np.ndarray, StepInfo]:
        t0 = time.perf_counter()
        sol = self.oracle.solve_vertices(theta[None])
        dt = time.perf_counter() - t0
        feasible = sol.dstar[0] >= 0
        u = (sol.u0[0, sol.dstar[0]] if feasible
             else np.zeros(self.oracle.can.n_u))
        return np.asarray(u), StepInfo(
            eval_s=dt, inside=bool(feasible),
            cost_pred=float(sol.Vstar[0]))


def simulate(problem, controller: Callable, theta0: np.ndarray,
             T: int, noise: np.ndarray | None = None) -> SimResult:
    """Roll problem.plant_step under `controller` for T steps from
    parameter theta0.  noise: optional (T, n_x) additive state
    disturbance sequence (pass a pre-drawn array for reproducibility)."""
    x = problem.state_of_theta(np.asarray(theta0, dtype=np.float64))
    states = [x]
    inputs, costs, infos = [], [], []
    for k in range(T):
        u, info = controller(problem.theta_of_state(x))
        x = problem.plant_step(x, u)
        if noise is not None:
            x = x + noise[k]
        states.append(x)
        inputs.append(u)
        costs.append(problem.stage_cost(states[-2], u))
        infos.append(info)
    return SimResult(
        states=np.stack(states), inputs=np.stack(inputs),
        stage_costs=np.asarray(costs),
        eval_s=np.asarray([i.eval_s for i in infos]),
        inside=np.asarray([i.inside for i in infos]),
        cost_pred=np.asarray([i.cost_pred for i in infos]))


class Comparison(NamedTuple):
    explicit: SimResult
    implicit: SimResult

    @property
    def cost_ratio(self) -> float:
        """Closed-loop explicit cost / implicit cost (1 = parity; the
        certificate bounds the OPEN-loop gap, so this is the honest
        closed-loop check)."""
        return self.explicit.total_cost / max(self.implicit.total_cost,
                                              1e-300)

    @property
    def speedup(self) -> float:
        return self.implicit.mean_eval_us / max(
            self.explicit.mean_eval_us, 1e-12)


def compare(problem, table: LeafTable, oracle, theta0: np.ndarray,
            T: int, backend: str = "kernel",
            noise: np.ndarray | None = None,
            semi_explicit: bool = False,
            semi_mask: np.ndarray | None = None,
            device="cuda") -> Comparison:
    """Same initial condition and noise under both controllers, both on
    `device` (the oracle's).

    semi_explicit=True deploys the feasibility-only variant's intended
    online stage (leaf-fixed delta + small online QP) instead of the
    interpolated PWA law.  semi_mask deploys a HYBRID partition: only
    the marked boundary leaves take the online QP; pass
    online.export.semi_explicit_mask(tree, table)."""
    if semi_explicit:
        ctrl = SemiExplicitController(table, oracle, backend=backend,
                                      device=device)
    elif semi_mask is not None and np.any(semi_mask):
        ctrl = SemiExplicitController(table, oracle, backend=backend,
                                      device=device,
                                      semi_mask=np.asarray(semi_mask))
    else:
        ctrl = ExplicitController(table, backend=backend, device=device)
    exp = simulate(problem, ctrl, theta0, T, noise)
    imp = simulate(problem, ImplicitController(oracle, device=device),
                   theta0, T, noise)
    return Comparison(explicit=exp, implicit=imp)
