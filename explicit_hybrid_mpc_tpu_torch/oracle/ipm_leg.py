"""One fixed-iteration Mehrotra leg over a batch of QPs: the CUDA kernel
(csrc/ipm_leg.cu) and its plain torch version.

``ipm_leg(Q, q, A, b, z, s, lam, n_iter) -> (z, s, lam)`` runs `n_iter`
predictor-corrector iterations of  min 1/2 z'Qz + q'z  s.t.  Az <= b
for every QP of the leading batch axis K, in the tensors' dtype (float32
or float64).  It is the counterpart of the JAX package's Pallas leg
(oracle/pallas_ipm.py ``_make_leg_kernel`` / ``solve_tiles``): a tensor
on a CUDA device launches the hand-written kernel -- one launch per leg,
all iterations inside it -- and raises when it cannot; a tensor on the
CPU runs ``ipm_leg_torch``, the tile-batched torch transcription of the
same algebra (the rank-1-downdate Cholesky, the unrolled column
substitutions, broadcast-multiply-reduce products).  Equilibration,
warm-start gating and residual classification stay in
``oracle/ipm.qp_solve``, shared by both.
"""

from __future__ import annotations

import ctypes

import torch

from explicit_hybrid_mpc_tpu_torch import kernels

#: Launches of the CUDA kernel (one per leg on a CUDA tensor).  A plain
#: counter; chip_smoke.py zeroes it before the main path and reads it
#: after, to show the build went through the kernel.
launches = 0

#: Compiled shape limits of the CUDA kernel (one lane per row of the
#: KKT matrix; operands in shared memory).
MAX_NZ = 32
MAX_NC = 128

_TINY = 1e-12


def leg_constants(dtype: torch.dtype) -> tuple[float, float]:
    """(cholesky ridge, slack/dual floor) for one precision leg -- shared
    by the plain version and the CUDA kernel (csrc/ipm_leg.cu holds the
    same literals).  f32 factorizations need a heavier ridge than f64 to
    survive the terminal D = lam/s blow-up."""
    if dtype == torch.float32:
        return 1e-7, 1e-8
    return 1e-10, _TINY


# -- plain torch version ------------------------------------------------------

def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matvec (K, m, n) @ (K, n) -> (K, m) as multiply-reduce."""
    return torch.sum(M * v[:, None, :], dim=-1)


def _mtv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched M'v: (K, m, n), (K, m) -> (K, n)."""
    return torch.sum(M * v[:, :, None], dim=1)


def chol_factor(M: torch.Tensor, reg: float) -> torch.Tensor:
    """Batched Cholesky of M + reg*I in the clamped rank-1-downdate form:
    d = sqrt(max(C_jj, 0)), column j = C[:, j] / max(d, floor) on and
    below the diagonal, zero above, then C -= col col'."""
    K, nz, _ = M.shape
    dtype = M.dtype
    C = M + reg * torch.eye(nz, dtype=dtype, device=M.device)
    rows = torch.arange(nz, device=M.device)[None, :]
    floor = torch.full((), 1e-300 if dtype != torch.float32 else 1e-30,
                       dtype=dtype, device=M.device)
    zero = torch.zeros((), dtype=dtype, device=M.device)
    cols = []
    for j in range(nz):
        d = torch.sqrt(torch.maximum(C[:, j, j], zero))
        col = C[:, :, j] / torch.maximum(d, floor)[:, None]
        col = torch.where(rows >= j, col, zero)
        cols.append(col)
        C = C - col[:, :, None] * col[:, None, :]
    return torch.stack(cols, dim=-1)


def fwd_sub(L: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Solve L y = r (batched, column-oriented, unrolled)."""
    nz = r.shape[-1]
    rows = torch.arange(nz, device=r.device)[None, :]
    zero = torch.zeros((), dtype=r.dtype, device=r.device)
    y = r
    for j in range(nz):
        d = y[:, j] / L[:, j, j]
        y = y - d[:, None] * torch.where(rows > j, L[:, :, j], zero)
        y = torch.where(rows == j, d[:, None], y)
    return y


def bwd_sub(L: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Solve L' x = r (batched, column-oriented, unrolled)."""
    nz = r.shape[-1]
    rows = torch.arange(nz, device=r.device)[None, :]
    zero = torch.zeros((), dtype=r.dtype, device=r.device)
    x = r
    for j in reversed(range(nz)):
        d = x[:, j] / L[:, j, j]
        x = x - d[:, None] * torch.where(rows < j, L[:, j, :], zero)
        x = torch.where(rows == j, d[:, None], x)
    return x


def fraction_to_boundary(v: torch.Tensor, dv: torch.Tensor,
                         tau: float) -> torch.Tensor:
    """alpha = min(1, tau * min_{dv<0} (-v/dv)) per batch row."""
    neg = dv < 0
    inf = torch.full((), float("inf"), dtype=v.dtype, device=v.device)
    ratio = torch.where(neg, -v / torch.where(neg, dv, -1.0), inf)
    one = torch.ones((), dtype=v.dtype, device=v.device)
    return torch.minimum(one, tau * torch.amin(ratio, dim=-1))


def ipm_leg_torch(Q, q, A, b, z, s, lam, n_iter: int):
    """Plain torch version of the leg: (K, ...) batch, dtype of Q."""
    nc = b.shape[-1]
    dtype = Q.dtype
    reg, tiny = leg_constants(dtype)
    tiny_t = torch.full((), tiny, dtype=dtype, device=Q.device)
    mu_floor = torch.full((), _TINY, dtype=dtype, device=Q.device)
    for _ in range(n_iter):
        s = torch.maximum(s, tiny_t)
        lam = torch.maximum(lam, tiny_t)
        r_d = _mv(Q, z) + q + _mtv(A, lam)
        r_p = _mv(A, z) + s - b
        mu = torch.sum(s * lam, dim=-1) / nc
        D = lam / s
        # KKT assembly: M = Q + A' diag(D) A as a sum of nc outer products.
        M = Q + torch.sum(A[:, :, :, None] * (D[:, :, None, None]
                                              * A[:, :, None, :]), dim=1)
        L = chol_factor(M, reg)

        def kkt_step(r_c):
            rhs = -r_d - _mtv(A, D * r_p - r_c / s)
            dz = bwd_sub(L, fwd_sub(L, rhs))
            dlam = D * (_mv(A, dz) + r_p) - r_c / s
            ds = -(r_c + s * dlam) / lam
            return dz, ds, dlam

        dz_a, ds_a, dl_a = kkt_step(s * lam)
        a_p = fraction_to_boundary(s, ds_a, 1.0)
        a_d = fraction_to_boundary(lam, dl_a, 1.0)
        mu_aff = torch.sum((s + a_p[:, None] * ds_a)
                           * (lam + a_d[:, None] * dl_a), dim=-1) / nc
        ratio = mu_aff / torch.maximum(mu, mu_floor)
        sigma = ratio * ratio * ratio

        r_c = s * lam + ds_a * dl_a - (sigma * mu)[:, None]
        dz, ds, dlam = kkt_step(r_c)
        a_p = fraction_to_boundary(s, ds, 0.995)[:, None]
        a_d = fraction_to_boundary(lam, dlam, 0.995)[:, None]
        z, s, lam = z + a_p * dz, s + a_p * ds, lam + a_d * dlam
    return z, s, lam


# -- the CUDA kernel ----------------------------------------------------------

def _lib():
    lib = kernels.library("ipm_leg")
    if not getattr(lib, "_ehm_typed", False):
        for fn in (lib.ipm_leg_f64, lib.ipm_leg_f32):
            fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 \
                + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.ipm_leg_error_string.argtypes = [ctypes.c_int]
        lib.ipm_leg_error_string.restype = ctypes.c_char_p
        lib._ehm_typed = True
    return lib


def ipm_leg_cuda(Q, q, A, b, z, s, lam, n_iter: int):
    """Launch the CUDA kernel on CUDA tensors; raises on anything it does
    not take (device, dtype, shapes, contiguity, compiled limits) and on
    a refused launch.  Does not synchronize."""
    K, nz = q.shape
    nc = b.shape[-1]
    dtype = Q.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"ipm_leg: dtype {dtype} (expected float32/64)")
    if nz > MAX_NZ or nc > MAX_NC:
        raise ValueError(f"ipm_leg: nz={nz}, nc={nc} exceed the kernel's "
                         f"compiled maxima nz<={MAX_NZ}, nc<={MAX_NC}")
    want = {"Q": (K, nz, nz), "q": (K, nz), "A": (K, nc, nz),
            "b": (K, nc), "z": (K, nz), "s": (K, nc), "lam": (K, nc)}
    args = {"Q": Q, "q": q, "A": A, "b": b, "z": z, "s": s, "lam": lam}
    dev = Q.device
    for name, t in args.items():
        if t.device != dev or not t.is_cuda:
            raise ValueError(f"ipm_leg: {name} on {t.device}, expected "
                             f"the CUDA device {dev}")
        if t.dtype != dtype:
            raise TypeError(f"ipm_leg: {name} is {t.dtype}, Q is {dtype}")
        if tuple(t.shape) != want[name]:
            raise ValueError(f"ipm_leg: {name} shape {tuple(t.shape)}, "
                             f"expected {want[name]}")
        if not t.is_contiguous():
            raise ValueError(f"ipm_leg: {name} is not contiguous")
    zo = torch.empty_like(z)
    so = torch.empty_like(s)
    lo = torch.empty_like(lam)
    if K == 0 or n_iter <= 0:
        return z, s, lam
    lib = _lib()
    fn = lib.ipm_leg_f64 if dtype == torch.float64 else lib.ipm_leg_f32
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(Q.data_ptr(), q.data_ptr(), A.data_ptr(), b.data_ptr(),
                 z.data_ptr(), s.data_ptr(), lam.data_ptr(), zo.data_ptr(),
                 so.data_ptr(), lo.data_ptr(), K, nz, nc, int(n_iter),
                 stream)
    if err != 0:
        raise kernels.KernelError("ipm_leg: CUDA launch failed: "
                           + lib.ipm_leg_error_string(err).decode())
    global launches
    launches += 1
    return zo, so, lo


def ipm_leg(Q, q, A, b, z, s, lam, n_iter: int):
    """One Mehrotra leg: the CUDA kernel for CUDA tensors, the plain
    torch version for CPU tensors."""
    if n_iter <= 0:
        return z, s, lam
    if Q.device.type == "cuda":
        return ipm_leg_cuda(Q, q, A, b, z, s, lam, n_iter)
    if Q.device.type != "cpu":
        raise ValueError(f"ipm_leg: unsupported device {Q.device}")
    return ipm_leg_torch(Q, q, A, b, z, s, lam, n_iter)
