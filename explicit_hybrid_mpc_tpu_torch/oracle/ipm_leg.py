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

# A launch over K QPs runs K blocks, one QP a block, on every path.  The
# Oracle's ``oracle.ipm_kernel_tile_s`` (the JAX package's per-tile
# histogram, whose tile holds several QPs) is therefore a batch's
# blocking wall over its n QPs, one observation a batch: the Oracle's
# wall a QP on the kernel route, host work included (assembly, every
# leg of the batch -- two precisions, a phase-2 cohort, a rescue pass --
# and the copies back), as the JAX figure is its blocking wall a tile.
# It is not K1's own time a block, which CUDA events time far lower.
# The padding rows that round a launch up to its bucket run blocks too
# and are not counted.

#: The CUDA kernel's three paths.  Up to GENERAL_MAX_NZ variables and
#: GENERAL_MAX_NC constraints a QP runs on one warp: nz <= 8 in its
#: register-resident path, larger nz in its general path (the
#: satellite's QPs), which unrolls its loops to the smallest bucket of
#: GENERAL_BUCKETS at or above nz and keeps A, Q and the factor in
#: shared memory (general_smem_bytes, at most 57 KB).  Every larger
#: shape (the quadrotor's nz 60-65, nc 360-366) runs the large path, one
#: block of LARGE_THREADS threads per QP streaming A in double-buffered
#: chunks of LARGE_ROWS rows, its Cholesky and substitutions on one
#: warp.  Its ceiling: the rows a lane of that warp holds (nz <=
#: LARGE_THREADS) and the shared memory one block may use
#: (large_smem_bytes <= MAX_SMEM_BYTES; in float64 at the quadrotor's
#: nc 366 that is nz <= 151).  csrc/ipm_leg.cu holds the same numbers;
#: _lib() checks them against the library.
GENERAL_MAX_NZ = 32
GENERAL_MAX_NC = 128
#: nz bucket -> edge of the general path's A'DA register tiles.
GENERAL_BUCKETS = {16: 3, 24: 4, 32: 5}
LARGE_THREADS = 256
LARGE_ROWS = 32
LARGE_TILE = 4
LARGE_WARPS = LARGE_THREADS // 32
MAX_SMEM_BYTES = 232_448


def general_smem_bytes(nz: int, nc: int, itemsize: int) -> int:
    """Shared memory of the general path for one QP (8 < nz <= 32, nc <=
    128): A staged in nc rows rounded up to 4 (the f64 leg's tensor-core
    steps), each row LDA = 4 (mod 16) wide and at least the bucket + 3
    (a row is shifted by (r // 4) % 4), Q and C in rows of an odd
    stride, four nz-vectors and three nc-vectors of the rounded rows."""
    nzb = min(b for b in GENERAL_BUCKETS if b >= nz)
    ncp = -(-nc // 4) * 4
    lda = (nzb + 14) // 16 * 16 + 4
    ldc = nzb | 1
    return itemsize * (ncp * lda + 2 * nzb * ldc + 4 * nzb + 3 * ncp)


def large_smem_bytes(nz: int, nc: int, itemsize: int) -> int:
    """Shared memory of the large path for one QP: the packed factor,
    six nz-vectors, eleven nc-vectors, two chunks of A (a row is nb
    tiles of LARGE_TILE columns, each followed by one pad), the
    corrector's A't partials and the reduction slots, then the tile
    table (2 bytes a tile)."""
    nb = -(-nz // LARGE_TILE)
    ld = nb * (LARGE_TILE + 1)
    return (itemsize * (nz * (nz + 1) // 2 + 6 * nz + 11 * nc
                        + 2 * LARGE_ROWS * ld + LARGE_THREADS
                        + 4 * LARGE_WARPS)
            + 2 * (nb * (nb + 1) // 2))


def kernel_takes(nz: int, nc: int, itemsize: int) -> bool:
    """Whether one of the CUDA kernel's paths takes this QP shape."""
    if nz <= GENERAL_MAX_NZ and nc <= GENERAL_MAX_NC:
        return True
    return (nz <= LARGE_THREADS
            and large_smem_bytes(nz, nc, itemsize) <= MAX_SMEM_BYTES)

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


# tpulint: device-region
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
        for fn in (lib.ipm_leg_f64, lib.ipm_leg_f32, lib.ipm_leg_large_f64):
            fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 \
                + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.ipm_leg_error_string.argtypes = [ctypes.c_int]
        lib.ipm_leg_error_string.restype = ctypes.c_char_p
        for name in ("ipm_leg_max_smem", "ipm_leg_large_smem",
                     "ipm_leg_general_smem"):
            getattr(lib, name).restype = ctypes.c_longlong
        lib.ipm_leg_large_smem.argtypes = [ctypes.c_int] * 3
        lib.ipm_leg_general_smem.argtypes = [ctypes.c_int] * 3
        general = [(nz, nc, size) for nz in (9, 16, 17, 24, 25, 32)
                   for nc in (14, 128) for size in (4, 8)]
        if (lib.ipm_leg_max_nz(), lib.ipm_leg_max_nc(),
                lib.ipm_leg_large_threads(), lib.ipm_leg_large_rows(),
                lib.ipm_leg_max_smem(),
                lib.ipm_leg_large_smem(65, 366, 8),
                [lib.ipm_leg_general_smem(*x) for x in general]) != (
                GENERAL_MAX_NZ, GENERAL_MAX_NC, LARGE_THREADS, LARGE_ROWS,
                MAX_SMEM_BYTES, large_smem_bytes(65, 366, 8),
                [general_smem_bytes(*x) for x in general]):
            raise kernels.KernelError(
                "ipm_leg: the kernel's path limits differ from the "
                "wrapper's (GENERAL_*, LARGE_*, MAX_SMEM_BYTES)")
        lib._ehm_typed = True
    return lib


def ipm_leg_cuda(Q, q, A, b, z, s, lam, n_iter: int):  # tpulint: device-region
    """Launch the CUDA kernel on CUDA tensors; raises on anything it does
    not take (device, dtype, shapes, contiguity, the large path's
    ceiling) and on a refused launch.  Does not synchronize."""
    K, nz = q.shape
    nc = b.shape[-1]
    dtype = Q.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"ipm_leg: dtype {dtype} (expected float32/64)")
    if not kernel_takes(nz, nc, dtype.itemsize):
        raise ValueError(
            f"ipm_leg: nz={nz}, nc={nc} exceed the kernel's ceiling "
            f"(large path: nz <= {LARGE_THREADS} and "
            f"{large_smem_bytes(nz, nc, dtype.itemsize)} bytes of shared "
            f"memory <= {MAX_SMEM_BYTES})")
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


def ipm_leg(Q, q, A, b, z, s, lam, n_iter: int):  # tpulint: device-region
    """One Mehrotra leg: the CUDA kernel for CUDA tensors, the plain
    torch version for CPU tensors."""
    if n_iter <= 0:
        return z, s, lam
    if Q.device.type == "cuda":
        return ipm_leg_cuda(Q, q, A, b, z, s, lam, n_iter)
    if Q.device.type != "cpu":
        raise ValueError(f"ipm_leg: unsupported device {Q.device}")
    return ipm_leg_torch(Q, q, A, b, z, s, lam, n_iter)
