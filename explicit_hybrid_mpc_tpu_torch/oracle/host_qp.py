"""One dense QP at a time on the host: the serial baseline's solver.

The serial backend (``Oracle(backend="serial")``) solves one QP per
call, the stand-in for the reference's serial branch-and-bound oracle.
Its programs run here, in numpy on the host, so that a call costs what
one small QP costs -- LAPACK's Cholesky of an nz x nz matrix and a few
BLAS products an iteration -- and not the per-operator overhead of the
batched torch programs run at a batch of one (the JAX package's serial
backend runs a compiled program for the same reason).

The algebra is the batched solver's (oracle/ipm.py ``qp_solve`` and
oracle/ipm_leg.py ``ipm_leg_torch``) written for one QP: the same
Jacobi equilibration, Mehrotra start, fixed iteration count, optional
float32 leg behind the f64 merit gate, and residual classification.
Only rounding differs: the factor is LAPACK's potrf (the clamped
rank-1-downdate form of ``ipm_leg.chol_factor`` where potrf finds a
pivot that is not positive), the triangular solves are potrs, and the
step to the boundary is tau over the largest -dv/v.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy.linalg import lapack

from explicit_hybrid_mpc_tpu_torch.oracle import ipm_leg

_TINY = 1e-12
# The ufuncs' reductions, without ndarray.min/sum's Python wrappers.
_MIN = np.minimum.reduce
_SUM = np.add.reduce


def _potrf(dtype):
    return lapack.spotrf if dtype == np.float32 else lapack.dpotrf


def _factor(C: np.ndarray) -> np.ndarray:
    """Lower Cholesky factor of C (the ridge already added)."""
    L, info = _potrf(C.dtype)(C, lower=1, clean=0)
    if info == 0:
        return L
    # Not positive definite in this precision: the plain leg's clamped
    # form, d = sqrt(max(C_jj, 0)) over max(d, floor).
    # A zero pivot overflows the column, as it does in the plain leg.
    floor = 1e-30 if C.dtype == np.float32 else 1e-300
    C = C.copy()
    L = np.zeros_like(C)
    with np.errstate(over="ignore", invalid="ignore"):
        for j in range(C.shape[0]):
            d = np.sqrt(np.maximum(C[j, j], 0))
            col = C[j:, j] / np.maximum(d, floor)
            L[j:, j] = col
            C[j:, j:] -= np.outer(col, col)
    return L


def _cho_solve(L: np.ndarray, r: np.ndarray) -> np.ndarray:
    potrs = lapack.spotrs if L.dtype == np.float32 else lapack.dpotrs
    return potrs(L, r, lower=1)[0]


def _alpha(v: np.ndarray, dv: np.ndarray, tau: float):
    """min(1, tau * min_{dv<0} (-v/dv)) for v > 0, written as
    tau / max(max(-dv/v), tau): two array operations, NaN-propagating
    (max returns its first argument when that is NaN)."""
    return tau / max(-_MIN(dv / v), tau)


def leg(Q, q, A, b, z, s, lam, n_iter: int):
    """`n_iter` Mehrotra predictor-corrector iterations of one QP, in
    the dtype of Q (ipm_leg_torch's algebra)."""
    nc = b.shape[0]
    reg, tiny = ipm_leg.leg_constants(
        torch.float32 if Q.dtype == np.float32 else torch.float64)
    At = np.ascontiguousarray(A.T)
    Qr = Q + reg * np.eye(Q.shape[0], dtype=Q.dtype)
    for _ in range(n_iter):
        s = np.maximum(s, tiny)
        lam = np.maximum(lam, tiny)
        sl = s * lam
        r_d = Q @ z + q + At @ lam
        r_p = A @ z + s - b
        mu = _SUM(sl) / nc
        D = lam / s
        L = _factor(Qr + (At * D) @ A)
        n_rd, D_rp, n_lam = -r_d, D * r_p, -lam

        def kkt_step(r_c):
            t = D_rp - r_c / s
            dz = _cho_solve(L, n_rd - At @ t)
            dlam = D * (A @ dz) + t
            return dz, (r_c + s * dlam) / n_lam, dlam

        dz_a, ds_a, dl_a = kkt_step(sl)
        a_p = _alpha(s, ds_a, 1.0)
        a_d = _alpha(lam, dl_a, 1.0)
        mu_aff = ((s + a_p * ds_a) @ (lam + a_d * dl_a)) / nc
        ratio = mu_aff / max(mu, _TINY)
        sigma = ratio * ratio * ratio
        dz, ds, dlam = kkt_step(sl + ds_a * dl_a - sigma * mu)
        a_p = _alpha(s, ds, 0.995)
        a_d = _alpha(lam, dlam, 0.995)
        z, s, lam = z + a_p * dz, s + a_p * ds, lam + a_d * dlam
    return z, s, lam


def qp_solve(Q, q, A, b, n_iter: int = 30, tol: float = 1e-8,
             n_f32: int = 0):
    """min 1/2 z'Qz + q'z s.t. Az <= b for ONE QP (float64 arrays Q
    (nz,nz), q (nz,), A (nc,nz), b (nc,)) from the cold Mehrotra start:
    ipm.qp_solve's semantics without a warm start.  Returns (z, lam, s,
    obj, converged, feasible) in original units."""
    with np.errstate(all="ignore"):
        return _qp_solve(Q, q, A, b, n_iter, tol, n_f32)


def _qp_solve(Q, q, A, b, n_iter, tol, n_f32):
    nc = b.shape[0]
    dQ = np.diag(Q)
    dcol = np.sqrt(np.maximum(dQ, dQ.max() * 1e-14 + _TINY))
    Qs = Q / dcol[:, None] / dcol[None, :]
    qs = q / dcol
    As = A / dcol[None, :]
    rown = np.abs(As).max(axis=1)
    rown = np.where(rown > 1e-10, rown, 1.0)
    As = As / rown[:, None]
    bs = b / rown

    z0 = -_cho_solve(_factor(Qs + 1e-10 * np.eye(Qs.shape[0])), qs)
    shift = np.maximum(1.0, 1.1 * np.maximum(As @ z0 - bs, 0).max())
    start = (z0, np.maximum(bs - As @ z0, 0) + shift, np.ones(nc))
    if n_f32 > 0:
        scale_p = 1.0 + np.abs(bs).max()
        scale_d = 1.0 + np.abs(qs).max()

        def merit(carry):
            zc, sc, lc = carry
            sc = np.maximum(sc, _TINY)
            lc = np.maximum(lc, _TINY)
            # np.max, not max: a NaN term must make the merit NaN.
            return np.max([np.abs(As @ zc + sc - bs).max() / scale_p,
                           np.abs(Qs @ zc + qs + As.T @ lc).max() / scale_d,
                           np.sum(sc * lc) / nc / scale_d])

        f32 = np.float32
        warm = tuple(c.astype(np.float64) for c in leg(
            Qs.astype(f32), qs.astype(f32), As.astype(f32), bs.astype(f32),
            *(c.astype(f32) for c in start), n_f32))
        m_warm = merit(warm)
        # NaN compares False: a non-finite f32 leg keeps the cold start.
        if math.isfinite(m_warm) and m_warm <= merit(start):
            start = warm

    z, s, lam = leg(Qs, qs, As, bs, *start, n_iter)
    z = z / dcol
    s = s * rown
    lam = lam / rown
    r_p = np.abs(A @ z + s - b).max() / (1.0 + np.abs(b).max())
    r_d = np.abs(Q @ z + q + A.T @ lam).max() / (1.0 + np.abs(q).max())
    gap = np.sum(s * lam) / nc / (1.0 + np.abs(q).max())
    obj = np.sum((Q @ z) * (0.5 * z)) + np.sum(q * z)
    finite = bool(np.isfinite(z).all() and np.isfinite(r_p)
                  and np.isfinite(r_d) and np.isfinite(gap))
    converged = finite and r_p < tol and r_d < tol and gap < tol
    feasible = finite and r_p < math.sqrt(tol)
    return z, lam, s, float(obj), bool(converged), bool(feasible)
