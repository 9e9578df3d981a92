"""Batched second-order-cone QP solver (NT-scaled Mehrotra IPM, torch),
as in the JAX package's oracle/socp.py, with the batch written out as a
leading axis B instead of vmap.

Problem form (one batch row):

    min_z 1/2 z'Qz + q'z
    s.t.  Al z <= bl                      (nl linear rows)
          s_k = bc_k - Ac_k z in SOC_m    (K cones, uniform dim m)

SOC_m = {(s0, s1) in R x R^{m-1} : s0 >= ||s1||}.  Uniform cone
dimension keeps every cone operation a tensor op over the (B, K) axes
(problems with mixed dims pad to the max and use dummy cones (s=e)).

Design notes, mirroring ipm.qp_solve:
- fixed iteration count, no data-dependent control flow and no host
  synchronization inside the loop (the factorizations are the _ex forms,
  which report failure as NaN instead of raising);
- the KKT reduction keeps the dense nz x nz Cholesky: each cone
  contributes Ac_k' W_k^{-2} Ac_k to the Schur complement, with W_k the
  (m x m) Nesterov-Todd scaling matrix;
- converged/feasible masks from final residuals, no early exit;
- the tangent-cone rescue and the relaxation shortcut are linear QPs
  solved by ipm.qp_solve -- on a CUDA device each leg of those is one
  launch of the hand-written IPM kernel (csrc/ipm_leg.cu).

Math (standard NT-scaled predictor-corrector, cf. the public CVXOPT
coneqp/ECOS derivations).  For s, lam in int(SOC) the NT scaling is
W = eta * V(wbar), where V(w) = [[w0, w1'], [w1, I + w1 w1'/(1+w0)]]
satisfies V(w)^2 = 2 w w' - J = P(w) (the quadratic representation;
J = diag(1, -I)), and wbar is the normalized NT point of the pair:
    gamma = sqrt((1 + sbar'lbar) / 2)
    wbar  = (sbar + J lbar) / (2 gamma)          (det wbar = 1)
    eta   = (det s / det lam)^{1/4},  det u = u0^2 - ||u1||^2,
with sbar = s/sqrt(det s), lbar = lam/sqrt(det lam).
Then W lam = W^{-1} s (the scaled point v).  Newton direction for
target complementarity d_c (Jordan product o, Arw(u) x = u o x):
    v o (W^{-1} ds + W dlam) = d_c
    ds = W (v^{-1} o d_c) - W^2 dlam
    => dlam = W^{-2} (Ac dz + rp_c + W (v^{-1} o d_c))
    => (Q + Al' D Al + sum_k Ac_k' W_k^{-2} Ac_k) dz = rhs.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from explicit_hybrid_mpc_tpu_torch.oracle import ipm

_TINY = 1e-12


class SOCPSolution(NamedTuple):
    z: torch.Tensor          # (B, nz) primal
    obj: torch.Tensor        # (B,) objective at z
    rp: torch.Tensor         # (B,) final primal residual (relative)
    rd: torch.Tensor         # (B,) final dual residual
    gap: torch.Tensor        # (B,) complementarity measure
    converged: torch.Tensor  # (B,) bool
    feasible: torch.Tensor   # (B,) bool (primal residual small)
    lam_l: torch.Tensor      # (B, nl) linear-row duals -- the envelope-
    #                          theorem gradient of a parametric instance
    #                          needs them (dV/dtheta = F'z + Y theta + p
    #                          - S'lam for b(theta) = w + S theta;
    #                          theta-independent cones contribute nothing)


# -- small Jordan-algebra helpers over the trailing cone axis (m) ----------

def _dot(u, v):
    return torch.sum(u * v, dim=-1)


def _det(u):
    return u[..., 0] ** 2 - torch.sum(u[..., 1:] ** 2, dim=-1)


def _J(u):
    """J u = (u0, -u1)."""
    return torch.cat([u[..., :1], -u[..., 1:]], dim=-1)


def _jordan_mul(u, v):  # tpulint: device-region
    """u o v = (u'v, u0 v1 + v0 u1)."""
    return torch.cat([_dot(u, v)[..., None],
                      u[..., :1] * v[..., 1:] + v[..., :1] * u[..., 1:]],
                     dim=-1)


def _arw_inv_apply(v, r):
    """Arw(v)^{-1} r in closed form (v in int SOC)."""
    d = torch.clamp(_det(v), min=_TINY)[..., None]
    v0, v1 = v[..., :1], v[..., 1:]
    r0, r1 = r[..., :1], r[..., 1:]
    v1r1 = _dot(v1, r1)[..., None]
    out0 = (v0 * r0 - v1r1) / d
    out1 = (-r0 * v1 + (d / v0) * r1 + v1r1 * v1 / v0) / d
    return torch.cat([out0, out1], dim=-1)


def _nt_scaling(s, lam):  # tpulint: device-region
    """(wbar, eta) of the NT scaling for each cone pair: wbar the
    NORMALIZED NT point (det wbar = 1), W = eta * V(wbar), so that
    W^2 lam = eta^2 P(wbar) lam = s with eta = (det s / det lam)^{1/4}
    -- the defining NT property W lam = W^{-1} s."""
    ds = torch.clamp(_det(s), min=_TINY)
    dl = torch.clamp(_det(lam), min=_TINY)
    sbar = s / torch.sqrt(ds)[..., None]
    lbar = lam / torch.sqrt(dl)[..., None]
    gamma = torch.sqrt(torch.clamp((1.0 + _dot(sbar, lbar)) / 2.0,
                                   min=_TINY))
    wbar = (sbar + _J(lbar)) / (2.0 * gamma)[..., None]
    eta = (ds / dl) ** 0.25
    return wbar, eta


def _W_apply(wbar, eta, x):
    """W x = eta * V(wbar) x (see _nt_scaling)."""
    w0, w1 = wbar[..., :1], wbar[..., 1:]
    x0, x1 = x[..., :1], x[..., 1:]
    w1x1 = _dot(w1, x1)[..., None]
    y0 = w0 * x0 + w1x1
    y1 = x0 * w1 + x1 + w1 * w1x1 / (1.0 + w0)
    return eta[..., None] * torch.cat([y0, y1], dim=-1)


def _Winv_apply(wbar, eta, x):
    """W^{-1} x = (1/eta) J V(wbar) J x  (V J V = J => V^{-1} = J V J)."""
    y = _W_apply(wbar, torch.ones_like(eta), _J(x))
    return _J(y) / eta[..., None]


def _cone_step(s, ds, tau=0.995):  # tpulint: device-region
    """Max alpha in (0, 1] with s + alpha ds in SOC (s in int SOC), per
    cone."""
    a = _det(ds)
    b = 2.0 * (s[..., 0] * ds[..., 0] - _dot(s[..., 1:], ds[..., 1:]))
    c = _det(s)
    sq = torch.sqrt(torch.clamp(b * b - 4.0 * a * c, min=0.0))
    inf = torch.full_like(a, float("inf"))
    one = torch.ones_like(a)
    # Roots of a t^2 + b t + c = 0; the boundary is the smallest positive
    # root of det(s + t ds) = 0 intersected with s0 + t ds0 >= 0.
    # Degenerate cases: a ~ 0 -> linear root -c/b; a AND b ~ 0 -> the
    # direction never touches this cone's boundary (det constant at
    # c > 0): NO cap (a padded/dummy cone would otherwise clamp every
    # step).
    big_a = a.abs() > _TINY
    big_b = b.abs() > _TINY
    a_safe = torch.where(big_a, a, one)
    r1 = torch.where(big_a, (-b - sq) / (2 * a_safe),
                     torch.where(big_b, -c / torch.where(big_b, b, one),
                                 inf))
    r2 = torch.where(big_a, (-b + sq) / (2 * a_safe), inf)
    neg0 = ds[..., 0] < 0
    t0 = torch.where(neg0, -s[..., 0] / torch.where(neg0, ds[..., 0], -one),
                     inf)
    pos = torch.stack([r1, r2, t0], dim=-1)
    pos = torch.where(pos > _TINY, pos, inf[..., None])
    return torch.clamp(tau * pos.amin(dim=-1), max=1.0)


def _min_init(x, init: float):
    """min over the last axis with an initial value (an empty axis gives
    `init`), as jnp.min(..., initial=init)."""
    return torch.cat([x, torch.full(x.shape[:-1] + (1,), init,
                                    dtype=x.dtype, device=x.device)],
                     dim=-1).amin(dim=-1)


def _max_init(x, init: float):
    """max over the last axis with an initial value, as
    jnp.max(..., initial=init)."""
    return torch.cat([x, torch.full(x.shape[:-1] + (1,), init,
                                    dtype=x.dtype, device=x.device)],
                     dim=-1).amax(dim=-1)


def _ftb(u, du, tau=1.0):  # tpulint: device-region
    """Fraction to the boundary of the linear slacks/duals, per row."""
    neg = du < 0
    ratio = torch.where(neg, -u / torch.where(neg, du, -torch.ones_like(du)),
                        torch.full_like(u, float("inf")))
    return torch.clamp(tau * _min_init(ratio, 1.0), max=1.0)


def _mv(M, v):
    """(B, m, n) @ (B, n) -> (B, m)."""
    return torch.matmul(M, v.unsqueeze(-1)).squeeze(-1)


def _mtv(M, v):
    """(B, m, n)' @ (B, m) -> (B, n)."""
    return torch.matmul(v.unsqueeze(-2), M).squeeze(-2)


def _cone_mv(Ac, z):
    """Ac_k z for every cone: (B, K, m, nz), (B, nz) -> (B, K, m)."""
    return torch.einsum("bkmn,bn->bkm", Ac, z)


def _cone_mtv(Ac, lam):
    """sum_k Ac_k' lam_k: (B, K, m, nz), (B, K, m) -> (B, nz)."""
    return torch.einsum("bkmn,bkm->bn", Ac, lam)


def _cholesky(M):
    """Batched Cholesky without a host synchronization: a factorization
    that fails comes back as NaN (as XLA's does), not as an error."""
    L, info = torch.linalg.cholesky_ex(M)
    return torch.where((info == 0)[:, None, None], L,
                       torch.full_like(L, float("nan")))


def _interior(u):
    """Cone-interior floor: a fraction-to-boundary rounding error can
    land an iterate ON or just outside the boundary, where det <= 0
    makes the NT normalization produce NaNs that poison the solve."""
    n1 = torch.linalg.vector_norm(u[..., 1:], dim=-1)
    u0 = torch.maximum(u[..., 0], n1 * (1 + 1e-12) + _TINY)
    return torch.cat([u0[..., None], u[..., 1:]], dim=-1)


# tpulint: device-region
def socp_solve(Q: torch.Tensor, q: torch.Tensor, Al: torch.Tensor,
               bl: torch.Tensor, Ac: torch.Tensor, bc: torch.Tensor,
               n_iter: int = 40, tol: float = 1e-8) -> SOCPSolution:
    """Solve a batch of SOC-constrained QPs.

    Shapes: Q (B,nz,nz) PD, q (B,nz), Al (B,nl,nz), bl (B,nl),
    Ac (B,K,m,nz), bc (B,K,m) -- K cones of uniform dim m a row;
    constraint: bc_k - Ac_k z in SOC_m.  K=0 recovers a plain QP.
    float64 throughout; runs where the tensors are.
    """
    B, nz = q.shape
    nl = Al.shape[-2]
    K = Ac.shape[1]
    dtype, dev = Q.dtype, Q.device
    reg = 1e-10
    eye = torch.eye(nz, dtype=dtype, device=dev)

    # -- Jacobi equilibration (same scheme as ipm.qp_solve) ---------------
    # Column scaling z = z_s / dcol; linear rows by their inf-norm; each
    # CONE by one positive scalar (a scalar preserves SOC membership --
    # per-row scaling would not).  Solution and residuals are reported
    # in ORIGINAL units.
    Q_in, q_in, Al_in, bl_in, Ac_in, bc_in = Q, q, Al, bl, Ac, bc
    dQ = torch.diagonal(Q, dim1=-2, dim2=-1)
    dcol = torch.sqrt(torch.maximum(
        dQ, dQ.amax(dim=-1, keepdim=True) * 1e-14 + _TINY))
    Q = Q / dcol[:, :, None] / dcol[:, None, :]
    q = q / dcol
    Al = Al / dcol[:, None, :]
    rown = Al.abs().amax(dim=-1)
    rown = torch.where(rown > 1e-10, rown, torch.ones_like(rown))
    Al = Al / rown[:, :, None]
    bl = bl / rown
    Ac = Ac / dcol[:, None, None, :]
    conen = Ac.abs().amax(dim=(2, 3))
    conen = torch.where(conen > 1e-10, conen, torch.ones_like(conen))
    Ac = Ac / conen[:, :, None, None]
    bc = bc / conen[:, :, None]

    # Start: unconstrained minimizer; linear slacks shifted positive;
    # cone slacks pushed into the interior (s0 > ||s1||).
    Lq = _cholesky(Q + reg * eye)
    z = -torch.cholesky_solve(q[..., None], Lq)[..., 0]
    resid = _mv(Al, z) - bl
    shift = torch.clamp(1.1 * _max_init(torch.clamp(resid, min=0.0), 0.0),
                        min=1.0)
    s_l = torch.clamp(bl - _mv(Al, z), min=0.0) + shift[:, None]
    lam_l = torch.ones((B, nl), dtype=dtype, device=dev)
    sc0 = bc - _cone_mv(Ac, z)
    norm1 = torch.linalg.vector_norm(sc0[..., 1:], dim=-1)
    bump = torch.clamp(1.1 * (norm1 - sc0[..., 0]) + 1.0, min=1.0)
    s_c = torch.cat([(sc0[..., 0] + bump)[..., None], sc0[..., 1:]], dim=-1)
    e = torch.zeros((B, K, bc.shape[-1]), dtype=dtype, device=dev)
    e[..., 0] = 1.0
    lam_c = e

    nu = nl + K  # complementarity normalization (degree-1 per cone pair)

    for _ in range(n_iter):
        s_l = torch.clamp(s_l, min=_TINY)
        lam_l = torch.clamp(lam_l, min=_TINY)
        s_c = _interior(s_c)
        lam_c = _interior(lam_c)

        r_d = _mv(Q, z) + q + _mtv(Al, lam_l) + _cone_mtv(Ac, lam_c)
        r_pl = _mv(Al, z) + s_l - bl
        r_pc = _cone_mv(Ac, z) + s_c - bc
        mu = (_dot(s_l, lam_l) + torch.sum(s_c * lam_c, dim=(1, 2))) / nu

        wbar, eta = _nt_scaling(s_c, lam_c)
        v = _W_apply(wbar, eta, lam_c)                  # = W lam = W^-1 s
        # Schur complement: Q + Al' D Al + sum_k Ac_k' W_k^-2 Ac_k.
        D = lam_l / s_l
        WinvA = _Winv_apply(wbar[:, :, None, :], eta[:, :, None],
                            Ac.transpose(2, 3)).transpose(2, 3)
        M = (Q + torch.matmul(Al.transpose(1, 2) * D[:, None, :], Al)
             + torch.einsum("bkmn,bkmo->bno", WinvA, WinvA))
        L = _cholesky(M + reg * eye)

        def kkt_step(rc_l, rc_c):
            """Direction for complementarity targets: linearized
            lam o ds + s o dlam = -rc; for cones, in the scaled space,
            v o (W^{-1} ds + W dlam) = -rc_c
              => dlam_c = W^{-2} (Ac dz + r_pc - W (v^{-1} o rc_c))."""
            g = _arw_inv_apply(v, rc_c)                  # v^-1 o rc_c
            t_c = r_pc - _W_apply(wbar, eta, g)          # (B, K, m)
            Winv_t = _Winv_apply(wbar, eta, t_c)
            rhs = (-r_d - _mtv(Al, D * r_pl - rc_l / s_l)
                   - _cone_mtv(WinvA, Winv_t))
            dz = torch.cholesky_solve(rhs[..., None], L)[..., 0]
            dlam_l = D * (_mv(Al, dz) + r_pl) - rc_l / s_l
            ds_l = -(rc_l + s_l * dlam_l) / lam_l
            Acdz = _cone_mv(Ac, dz)
            dlam_c = _Winv_apply(wbar, eta,
                                 _Winv_apply(wbar, eta, Acdz + t_c))
            ds_c = -r_pc - Acdz
            return dz, ds_l, dlam_l, ds_c, dlam_c

        # Predictor.
        vv = _jordan_mul(v, v)
        dz_a, ds_la, dlam_la, ds_ca, dlam_ca = kkt_step(s_l * lam_l, vv)
        a_p = torch.minimum(_ftb(s_l, ds_la),
                            _min_init(_cone_step(s_c, ds_ca, 1.0), 1.0))
        a_d = torch.minimum(_ftb(lam_l, dlam_la),
                            _min_init(_cone_step(lam_c, dlam_ca, 1.0), 1.0))
        mu_aff = (_dot(s_l + a_p[:, None] * ds_la,
                       lam_l + a_d[:, None] * dlam_la)
                  + torch.sum((s_c + a_p[:, None, None] * ds_ca)
                              * (lam_c + a_d[:, None, None] * dlam_ca),
                              dim=(1, 2))) / nu
        sigma = (torch.clamp(mu_aff, min=0.0)
                 / torch.clamp(mu, min=_TINY)) ** 3

        # Corrector.  Cone corrector term in the scaled space:
        # (W^-1 ds_a) o (W dlam_a).
        corr = _jordan_mul(_Winv_apply(wbar, eta, ds_ca),
                           _W_apply(wbar, eta, dlam_ca))
        rc_c = vv + corr - (sigma * mu)[:, None, None] * e
        rc_l = s_l * lam_l + ds_la * dlam_la - (sigma * mu)[:, None]
        dz, ds_l, dlam_l, ds_c, dlam_c = kkt_step(rc_l, rc_c)
        # SYMMETRIC corrector step (one alpha for primal and dual): with
        # separate step lengths the NT-scaled iterates can shear -- s on
        # its boundary while lam still moves -- and the dual residual
        # stalls; the common step keeps (s, lam) on the scaling's
        # central trajectory.
        a = torch.minimum(
            torch.minimum(_ftb(s_l, ds_l, 0.995),
                          _min_init(_cone_step(s_c, ds_c), 1.0)),
            torch.minimum(_ftb(lam_l, dlam_l, 0.995),
                          _min_init(_cone_step(lam_c, dlam_c), 1.0)))
        z = z + a[:, None] * dz
        s_l = s_l + a[:, None] * ds_l
        lam_l = lam_l + a[:, None] * dlam_l
        s_c = s_c + a[:, None, None] * ds_c
        lam_c = lam_c + a[:, None, None] * dlam_c

    # Back to original units (z_s = dcol * z; row/cone scalings invert
    # on the duals and slacks), then KKT residuals against the ORIGINAL
    # data so tol means what callers think it means.
    z = z / dcol
    s_l = s_l * rown
    lam_l = lam_l / rown
    s_c = s_c * conen[:, :, None]
    lam_c = lam_c / conen[:, :, None]

    def stationarity(zz, ll, lc):
        return (_mv(Q_in, zz) + q_in + _mtv(Al_in, ll)
                + _cone_mtv(Ac_in, lc)).abs().amax(dim=-1)

    # -- dual polish --------------------------------------------------------
    # On a minority of instances the interior iteration stalls with the
    # PRIMAL essentially exact but the dual residual frozen around
    # 1e-5..1e-7 (boundary-degenerate duals block the step length).  The
    # optimal duals then have a known structure: zero off the active
    # set, and for an active cone ALIGNED with the boundary slack,
    # lam_k = beta_k * (s_k0, -s_k1).  Solve the ridge-regularized
    # least-squares stationarity system for the active multipliers,
    # clip to the cone (beta, lam_l >= 0), and keep the polished duals
    # iff they reduce the dual residual.
    one = torch.ones((), dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    act_l = s_l < 1e-6 * (1.0 + bl_in.abs())
    margin_c = s_c[..., 0] - torch.linalg.vector_norm(s_c[..., 1:], dim=-1)
    act_c = margin_c < 1e-6 * (1.0 + bc_in[..., 0].abs())
    shat = _J(s_c)
    shat = shat / (1.0 + torch.linalg.vector_norm(shat, dim=-1,
                                                  keepdim=True))
    # Columns: Al_in' (nz, nl) masked to active rows; cone directions
    # Ac_k' shat_k (nz,) masked to active cones.
    Bl = Al_in.transpose(1, 2) * torch.where(act_l, one, zero)[:, None, :]
    Bc = (torch.einsum("bkmn,bkm->bkn", Ac_in, shat)
          * torch.where(act_c, one, zero)[:, :, None]).transpose(1, 2)
    Bm = torch.cat([Bl, Bc], dim=2)                        # (B, nz, nB)
    r0 = _mv(Q_in, z) + q_in
    nB = Bm.shape[2]
    eyeB = torch.eye(nB, dtype=dtype, device=dev)
    BtB = torch.matmul(Bm.transpose(1, 2), Bm)
    x = torch.linalg.solve_ex(BtB + 1e-10 * eyeB, -_mtv(Bm, r0))[0]
    # One NNLS-style support restriction: drop clipped columns, re-solve.
    keep = torch.where(x > 0, one, zero)
    B2 = Bm * keep[:, None, :]
    x = torch.linalg.solve_ex(
        torch.matmul(B2.transpose(1, 2), B2) + 1e-10 * eyeB,
        -_mtv(B2, r0))[0] * keep
    x = torch.clamp(x, min=0.0)
    lam_l_p = x[:, :nl] * torch.where(act_l, one, zero)
    lam_c_p = (x[:, nl:, None] * shat) \
        * torch.where(act_c, one, zero)[:, :, None]
    use = stationarity(z, lam_l_p, lam_c_p) < stationarity(z, lam_l, lam_c)
    lam_l = torch.where(use[:, None], lam_l_p, lam_l)
    lam_c = torch.where(use[:, None, None], lam_c_p, lam_c)
    scale_p = 1.0 + torch.maximum(_max_init(bl_in.abs(), 0.0),
                                  _max_init(bc_in.abs().flatten(1), 0.0))
    scale_d = 1.0 + q_in.abs().amax(dim=-1)
    r_p = torch.maximum(
        _max_init((_mv(Al_in, z) + s_l - bl_in).abs(), 0.0),
        _max_init((_cone_mv(Ac_in, z) + s_c - bc_in).abs().flatten(1),
                  0.0)) / scale_p
    r_d = stationarity(z, lam_l, lam_c) / scale_d
    gap = (_dot(s_l, lam_l) + torch.sum(s_c * lam_c, dim=(1, 2))) \
        / nu / scale_d
    obj = 0.5 * _dot(z, _mv(Q_in, z)) + _dot(q_in, z)
    finite = (torch.isfinite(z).all(dim=-1) & torch.isfinite(r_p)
              & torch.isfinite(r_d) & torch.isfinite(gap))
    # Residuals reach ~1e-16; the complementarity measure plateaus a
    # decade above tol (fraction-to-boundary steps shrink once iterates
    # hug the cone boundary).  10x tol on the gap keeps the certificate
    # honest (duality gap <= 1e-7 * scale) without failing fully-solved
    # instances.
    converged = finite & (r_p < tol) & (r_d < tol) & (gap < 10 * tol)
    feasible = finite & (r_p < math.sqrt(tol))

    # -- tangent-cone QP rescue ---------------------------------------------
    # The remaining stall class: iterates hug a cone boundary,
    # fraction-to-boundary steps collapse, and extra iterations make it
    # worse.  At such a point the PRIMAL is essentially exact, so each
    # cone can be replaced by its supporting halfspace at the current
    # slack direction u_k = s_k1/||s_k1||:
    #     ||s1|| - s0 <= u's1 - s0  =>  (Ac0 - u'Ac1) z <= bc0 - u'bc1,
    # a RELAXATION of the cone constraint.  The linear QP solver solves
    # that tangent problem and its row duals map back exactly:
    # lam_c = beta * (1, -u) lies on the dual cone boundary with
    # lam_c's_c = 0 at the tangent optimum.  ACCEPTANCE IS VERIFIED on
    # the original SOCP's full KKT system (cone membership included), so
    # a bad linearization can never corrupt the result -- the rescue is
    # take-if-strictly-better.
    def tangent_pass(carry):
        """One verified tangent linearization at the carry's (z, s_c);
        run twice -- the second pass re-aims the halfspace directions at
        the first pass's point."""
        (z, obj, r_p, r_d, gap, lam_l, lam_c, s_l, s_c, converged,
         feasible) = carry
        n1 = torch.linalg.vector_norm(s_c[..., 1:], dim=-1)
        u_dir = s_c[..., 1:] / torch.clamp(n1, min=_TINY)[..., None]
        T = Ac_in[:, :, 0, :] - torch.einsum("bkm,bkmn->bkn", u_dir,
                                             Ac_in[:, :, 1:, :])
        t_rhs = bc_in[..., 0] - _dot(u_dir, bc_in[..., 1:])
        tan = ipm.qp_solve(Q_in, q_in, torch.cat([Al_in, T], dim=1),
                           torch.cat([bl_in, t_rhs], dim=1),
                           n_iter=n_iter, tol=tol)
        z_t = tan.z
        lam_l_t = tan.lam[:, :nl]
        beta = tan.lam[:, nl:]
        lam_c_t = beta[..., None] * torch.cat(
            [torch.ones_like(u_dir[..., :1]), -u_dir], dim=-1)
        s_l_t = bl_in - _mv(Al_in, z_t)
        s_c_t = bc_in - _cone_mv(Ac_in, z_t)
        cone_viol = _max_init(torch.clamp(
            torch.linalg.vector_norm(s_c_t[..., 1:], dim=-1)
            - s_c_t[..., 0], min=0.0), 0.0)
        lin_viol = _max_init(torch.clamp(-s_l_t, min=0.0), 0.0)
        rp_t = torch.maximum(cone_viol, lin_viol) / scale_p
        rd_t = stationarity(z_t, lam_l_t, lam_c_t) / scale_d
        gap_t = (_dot(s_l_t, lam_l_t)
                 + torch.sum(s_c_t * lam_c_t, dim=(1, 2))) / nu / scale_d
        obj_t = 0.5 * _dot(z_t, _mv(Q_in, z_t)) + _dot(q_in, z_t)
        conv_t = (tan.converged & torch.isfinite(z_t).all(dim=-1)
                  & torch.isfinite(lam_c_t).flatten(1).all(dim=-1)
                  & (rp_t < tol) & (rd_t < tol) & (gap_t.abs() < 10 * tol))
        take_t = conv_t & ~converged
        # An unconverged cell still adopts the tangent point as the next
        # linearization base when it is primal-better; only the VERIFIED
        # take flips flags/results.
        relin = ~converged & ~take_t & tan.converged & (rp_t < r_p)

        def pk(a, b):
            return torch.where(take_t.view((-1,) + (1,) * (a.dim() - 1)),
                               a, b)

        s_c_next = torch.where((take_t | relin)[:, None, None], s_c_t, s_c)
        return (pk(z_t, z), pk(obj_t, obj), pk(rp_t, r_p), pk(rd_t, r_d),
                pk(gap_t.abs(), gap), pk(lam_l_t, lam_l),
                pk(lam_c_t, lam_c), pk(s_l_t, s_l), s_c_next,
                converged | take_t, feasible | take_t)

    carry = (z, obj, r_p, r_d, gap, lam_l, lam_c, s_l, s_c, converged,
             feasible)
    carry = tangent_pass(tangent_pass(carry))
    (z, obj, r_p, r_d, gap, lam_l, lam_c, s_l, s_c, converged,
     feasible) = carry

    # -- relaxation shortcut ------------------------------------------------
    # Solve the LINEAR-ONLY relaxation; if every cone is strictly slack
    # at its optimum, that point plus zero cone duals satisfies the full
    # SOCP KKT system EXACTLY -- use it.  This also covers a degeneracy
    # of the NT iteration: when the optimal cone dual sits at the apex
    # (inactive cone), the scaling blows up there and the dual can stall
    # short of zero.
    rel = ipm.qp_solve(Q_in, q_in, Al_in, bl_in, n_iter=n_iter, tol=tol)
    s_rel = bc_in - _cone_mv(Ac_in, rel.z)
    margin = s_rel[..., 0] - torch.linalg.vector_norm(s_rel[..., 1:], dim=-1)
    rel_ok = rel.converged & (margin > math.sqrt(tol)).all(dim=-1)
    take = rel_ok & (~converged | (rel.obj < obj))

    def pick(a, b):
        return torch.where(take.view((-1,) + (1,) * (a.dim() - 1)), a, b)

    return SOCPSolution(
        z=pick(rel.z, z), obj=pick(rel.obj, obj),
        rp=pick(rel.rp, r_p), rd=pick(rel.rd, r_d),
        gap=pick(rel.gap, gap),
        converged=take | converged,
        feasible=take | feasible,
        # Relaxation path: strictly-slack cones carry zero duals, so the
        # QP solver's linear duals ARE the SOCP's.
        lam_l=pick(rel.lam, lam_l))
