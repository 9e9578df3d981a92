"""Batched dense primal-dual interior-point QP solver (torch).

The compute heart of the build: thousands of (point x commutation) QPs
solved together by a fixed-iteration Mehrotra predictor-corrector, as
in the JAX package's oracle/ipm.py, with the batch written out as a
leading axis K instead of vmap.  Design notes:

- Fixed iteration count + static shapes: each precision leg is ONE
  launch of the hand-written CUDA kernel on the card (oracle/ipm_leg.py,
  csrc/ipm_leg.cu) -- or its plain torch version on the CPU -- and a
  `converged` mask is computed from final residuals.  Adaptive WORK
  lives one level up, in the Oracle's two-phase cohort solve.
- float64 by default; the optional f32 leg (n_f32 > 0, precision
  'mixed') warm-starts the f64 polish through a merit gate.  Hopper
  runs FP64 natively, so both legs go through the same kernel.
- Infeasible problems cannot converge in primal residual; they are
  classified by residual thresholds.  Sound decisions go through the
  elastic / phase-1 programs plus a Farkas check (oracle.Oracle).

Problem form (one batch row):
    min_z 1/2 z'Qz + q'z   s.t.  A z <= b
KKT with slacks s >= 0, multipliers lam >= 0:
    Qz + q + A'lam = 0;  Az + s - b = 0;  s .* lam = 0.

Nothing here synchronizes with the device: every reduction stays a
tensor, so a caller can launch many solves and read them back later.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from explicit_hybrid_mpc_tpu_torch import device as device_lib
from explicit_hybrid_mpc_tpu_torch.oracle import ipm_leg

#: IPM leg dispatch choices (cfg.ipm_kernel / Oracle(ipm_kernel=...)).
KERNEL_TIERS = ("auto", "cuda", "torch")

_TINY = 1e-12


class QPSolution(NamedTuple):
    z: torch.Tensor        # (K, nz) primal solution
    lam: torch.Tensor      # (K, nc) dual solution
    s: torch.Tensor        # (K, nc) slacks
    obj: torch.Tensor      # (K,) 1/2 z'Qz + q'z at the returned z
    rp: torch.Tensor       # (K,) final primal residual (inf-norm, relative)
    rd: torch.Tensor       # (K,) final dual residual (inf-norm, relative)
    gap: torch.Tensor      # (K,) final complementarity mu (relative)
    converged: torch.Tensor  # (K,) bool: KKT satisfied to tolerance
    feasible: torch.Tensor   # (K,) bool: primal residual small
    f32_ok: torch.Tensor     # (K,) bool: the f32 leg passed the f64 merit
    #                          gate (False when n_f32 == 0)
    warm_ok: torch.Tensor    # (K,) bool: a caller-supplied warm start
    #                          passed the f64 merit gate


def resolve_kernel(requested: str, device: torch.device) -> str:
    """'auto'|'cuda'|'torch' -> the leg that runs for tensors on
    `device`, checked once where an oracle is made (the legs themselves
    always follow the tensors' device): 'auto' names the device's leg;
    an explicit choice that cannot run there raises (a 'torch' request
    on a CUDA device would hide the kernel; 'cuda' on the CPU has no
    kernel to launch)."""
    if requested not in KERNEL_TIERS:
        raise ValueError(f"unknown ipm_kernel {requested!r} "
                         f"(expected one of {KERNEL_TIERS})")
    actual = "cuda" if device.type == "cuda" else "torch"
    if requested not in ("auto", actual):
        raise ValueError(f"ipm_kernel={requested!r} cannot run on "
                         f"{device.type}: a {device.type} solve runs "
                         f"the {actual!r} leg")
    return actual


def _bmv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matvec (K, m, n) @ (K, n) -> (K, m)."""
    return torch.matmul(M, v.unsqueeze(-1)).squeeze(-1)


def _bmtv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched M'v: (K, m, n), (K, m) -> (K, n)."""
    return torch.matmul(v.unsqueeze(-2), M).squeeze(-2)


# tpulint: device-region
def _run_leg(Q, q, A, b, start, n_iter: int, plain: bool = False):
    """One fixed-iteration leg; ipm_leg dispatches on the tensors'
    device (the CUDA kernel or its plain version), or the plain version
    wherever the tensors are when `plain`."""
    if n_iter <= 0:
        return start
    leg = ipm_leg.ipm_leg_torch if plain else ipm_leg.ipm_leg
    return leg(*(t.contiguous() for t in (Q, q, A, b, *start)),
               n_iter=n_iter)


def schedule_iters(n_f32: int, n_f64: int) -> int:
    """Mehrotra iterations one QP spends under an (n_f32, n_f64)
    schedule -- exact, since the legs have no early exit."""
    return int(n_f32) + int(n_f64)


def cho_solve(L: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """(L L')^-1 r with the plain substitutions of the leg."""
    return ipm_leg.bwd_sub(L, ipm_leg.fwd_sub(L, r))


def qp_solve(Q: torch.Tensor, q: torch.Tensor, A: torch.Tensor,
             b: torch.Tensor, n_iter: int = 30, tol: float = 1e-8,
             n_f32: int = 0, warm_start: tuple | None = None,
             plain_leg: bool = False) -> QPSolution:  # tpulint: device-region
    """Solve a batch of dense convex QPs with Mehrotra predictor-corrector.

    Shapes: Q (K,nz,nz) PD, q (K,nz), A (K,nc,nz), b (K,nc), one dtype
    and device.

    The legs run where the tensors are: the CUDA kernel on a CUDA
    device, its plain version on the CPU.  Everything OUTSIDE the legs
    -- Jacobi
    equilibration, the cold start, the warm-start merit gate, residual
    classification -- is this function's plain torch code.

    warm_start, when given, is a ``(z0, s0, lam0, valid)`` tuple of
    (K, ...) tensors in ORIGINAL (unequilibrated) units.  Row k's start
    is accepted only when ``valid[k]`` is set AND its f64 KKT merit is
    no worse than the cold start's, so a bad warm start can never make
    a solve worse than cold.  When both a warm start and an f32 phase
    are configured, the gate runs FIRST and the f32 phase then iterates
    from whichever start won.

    n_f32 > 0 runs n_f32 float32 iterations first (full IEEE float32:
    TF32 is off for the process), accepted per row by the same merit
    gate, then `n_iter` float64 iterations polish.
    """
    K, nz = q.shape
    nc = b.shape[-1]
    dtype = Q.dtype
    dev = Q.device
    reg = 1e-10

    # -- Jacobi equilibration -------------------------------------------
    # Symmetric column scaling by sqrt(diag(Q)) + constraint row scaling
    # (penalty-weighted problems otherwise stall the fixed-iteration
    # IPM); the objective value is invariant, duals unscale as
    # lam = lam_s / row, slacks as s = row * s_s.
    dQ = torch.diagonal(Q, dim1=-2, dim2=-1)
    dcol = torch.sqrt(torch.maximum(
        dQ, dQ.amax(dim=-1, keepdim=True) * 1e-14 + _TINY))
    Q_in, q_in, A_in, b_in = Q, q, A, b
    Q = Q / dcol[:, :, None] / dcol[:, None, :]
    q = q / dcol
    A = A / dcol[:, None, :]
    rown = A.abs().amax(dim=-1)
    rown = torch.where(rown > 1e-10, rown, torch.ones_like(rown))
    A = A / rown[:, :, None]
    b = b / rown

    # Initial point: unconstrained minimizer, unit duals, slacks shifted
    # to cover the initial primal infeasibility (standard Mehrotra start).
    Lq = ipm_leg.chol_factor(Q, reg)
    z0 = -cho_solve(Lq, q)
    resid0 = _bmv(A, z0) - b
    zero = torch.zeros((), dtype=dtype, device=dev)
    one = torch.ones((), dtype=dtype, device=dev)
    shift = torch.maximum(
        one, 1.1 * torch.maximum(resid0, zero).amax(dim=-1))
    s0 = torch.maximum(b - _bmv(A, z0), zero) + shift[:, None]
    lam0 = torch.ones((K, nc), dtype=dtype, device=dev)

    scale_p = 1.0 + b.abs().amax(dim=-1)
    scale_d = 1.0 + q.abs().amax(dim=-1)
    tiny = torch.full((), _TINY, dtype=dtype, device=dev)

    def merit(carry):
        """f64 KKT merit: max(scaled r_p, r_d, mu); NaN-safe (NaN
        compares False, so a non-finite warm start is rejected)."""
        zc, sc, lc = carry
        sc = torch.maximum(sc, tiny)
        lc = torch.maximum(lc, tiny)
        mrp = (_bmv(A, zc) + sc - b).abs().amax(dim=-1) / scale_p
        mrd = (_bmv(Q, zc) + q + _bmtv(A, lc)).abs().amax(dim=-1) / scale_d
        mmu = torch.sum(sc * lc, dim=-1) / nc / scale_d
        return torch.maximum(mrp, torch.maximum(mrd, mmu))

    def pick(ok, new, old):
        return tuple(torch.where(ok[:, None], w, c)
                     for w, c in zip(new, old))

    start = (z0, s0, lam0)
    warm_ok = torch.zeros(K, dtype=torch.bool, device=dev)
    if warm_start is not None:
        zw, sw, lw, wvalid = warm_start
        # Caller units -> the equilibrated space the iteration runs in.
        warm = (zw.to(dtype) * dcol,
                torch.maximum(sw.to(dtype) / rown, tiny),
                torch.maximum(lw.to(dtype) * rown, tiny))
        m_warm = merit(warm)
        warm_ok = (wvalid.to(torch.bool) & torch.isfinite(m_warm)
                   & (m_warm <= merit(start)))
        start = pick(warm_ok, warm, start)
    f32_ok = torch.zeros(K, dtype=torch.bool, device=dev)
    if n_f32 > 0:
        f32 = torch.float32
        warm32 = _run_leg(Q.to(f32), q.to(f32), A.to(f32), b.to(f32),
                          tuple(c.to(f32) for c in start), n_f32,
                          plain_leg)
        warm = tuple(c.to(dtype) for c in warm32)
        m_warm = merit(warm)
        f32_ok = torch.isfinite(m_warm) & (m_warm <= merit(start))
        start = pick(f32_ok, warm, start)

    z, s, lam = _run_leg(Q, q, A, b, start, n_iter, plain_leg)

    # Back to original units for the returned solution and the KKT
    # residual checks (tolerances must mean what callers think they mean).
    z = z / dcol
    s = s * rown
    lam = lam / rown
    scale_p = 1.0 + b_in.abs().amax(dim=-1)
    scale_d = 1.0 + q_in.abs().amax(dim=-1)
    r_p = (_bmv(A_in, z) + s - b_in).abs().amax(dim=-1) / scale_p
    r_d = (_bmv(Q_in, z) + q_in + _bmtv(A_in, lam)).abs().amax(
        dim=-1) / scale_d
    gap = torch.sum(s * lam, dim=-1) / nc / scale_d
    obj = torch.sum(_bmv(Q_in, z) * (0.5 * z), dim=-1) \
        + torch.sum(q_in * z, dim=-1)
    # Infeasible problems diverge (lam blows up; residuals may go NaN/inf):
    # any non-finite iterate is classified not-converged, not-feasible.
    finite = (torch.isfinite(z).all(dim=-1) & torch.isfinite(r_p)
              & torch.isfinite(r_d) & torch.isfinite(gap))
    converged = finite & (r_p < tol) & (r_d < tol) & (gap < tol)
    feasible = finite & (r_p < math.sqrt(tol))
    return QPSolution(z=z, lam=lam, s=s, obj=obj, rp=r_p, rd=r_d, gap=gap,
                      converged=converged, feasible=feasible, f32_ok=f32_ok,
                      warm_ok=warm_ok)


def solve_mask(Q, q, A, b, n_iter: int = 30, n_f32: int = 0,
               tol: float = 1e-8, device="cuda", kernel: str = "auto"):
    """Batched host-level convergence probe: run qp_solve over a batch
    of raw QPs on `device` (default the card; 'cpu' on request) and
    return numpy ``(converged, feasible, rp)``.

    The flight recorder's kernel-only replay entry (obs/replay.py
    --kernel-only): a repro bundle carries the exact per-cell matrices,
    and this answers "what does the bare kernel say about these QPs
    under this schedule" without the Oracle pipeline (two-phase
    cohorts, rescue, warm gating) in the way.

    kernel: 'auto' runs the device's leg (the CUDA kernel on the card,
    its plain version on the CPU); 'cuda' insists on the kernel (raises
    off the card); 'torch' runs the plain version on either device --
    the bisection step between the kernel and its plain version.
    Shapes: Q (K, nz, nz), q (K, nz), A (K, nc, nz), b (K, nc)."""
    if kernel not in KERNEL_TIERS:
        raise ValueError(f"unknown kernel {kernel!r} "
                         f"(expected one of {KERNEL_TIERS})")
    dev = device_lib.resolve(device)
    if kernel == "cuda" and dev.type != "cuda":
        raise ValueError("kernel='cuda' runs on the card; this probe "
                         f"was asked for {dev}")
    Q, q, A, b = (torch.as_tensor(x).to(dev) for x in (Q, q, A, b))
    sol = qp_solve(Q, q, A, b, n_iter=n_iter, tol=tol, n_f32=n_f32,
                   plain_leg=kernel == "torch")
    return (sol.converged.cpu().numpy(), sol.feasible.cpu().numpy(),
            sol.rp.cpu().numpy())


def phase1(A: torch.Tensor, b: torch.Tensor, n_iter: int = 30,
           rho: float = 1e-4, n_f32: int = 0) -> torch.Tensor:
    """Minimal constraint violation t* = min max(A z - b) (smoothed) per
    batch row: min_z,t 1/2 rho t^2 + t  s.t.  A z - t <= b, strictly
    feasible, with t* <= 0 iff {z : Az <= b} is nonempty (up to the rho
    smoothing).  A (K, nc, nz), b (K, nc) -> t* (K,)."""
    K, nc, nz = A.shape
    dtype, dev = A.dtype, A.device
    Q = torch.eye(nz + 1, dtype=dtype, device=dev) * 1e-6
    Q[nz, nz] = rho
    Q = Q.expand(K, nz + 1, nz + 1).contiguous()
    q = torch.zeros((K, nz + 1), dtype=dtype, device=dev)
    q[:, nz] = 1.0
    At = torch.cat([A, -torch.ones((K, nc, 1), dtype=dtype, device=dev)],
                   dim=2)
    sol = qp_solve(Q, q, At, b, n_iter=n_iter, n_f32=n_f32)
    return sol.z[:, nz]
