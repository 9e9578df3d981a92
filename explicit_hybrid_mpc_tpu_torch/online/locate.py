"""Online point location: the CUDA kernel (csrc/locate.cu) and its plain
torch version, plus the located-then-interpolated controller evaluation.

The online controller is "locate the leaf simplex containing theta, then
barycentrically interpolate the vertex inputs".  Point location is
where the work is: every query scores every leaf,
    score[b, l] = min_i  th1[b] . bary[l, i, :]   (th1 = [theta; 1]),
and takes the first leaf with the largest score, in float32 (scores
only SELECT a leaf; the interpolation then runs on the f64 tables).
This is the counterpart of the JAX package's Pallas kernel
(online/pallas_eval.py ``_locate_kernel``; ``stage_pallas`` /
``locate`` / ``evaluate``), with the same public functions and results:
``stage`` packs a LeafTable for the kernel, ``locate`` returns
(leaf int32, score float32), ``evaluate`` locates and interpolates.

A table on a CUDA device launches the kernel (and raises when it
cannot); a table on the CPU runs ``locate_torch``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from explicit_hybrid_mpc_tpu_torch import device as device_lib
from explicit_hybrid_mpc_tpu_torch import kernels
from explicit_hybrid_mpc_tpu_torch.online.evaluator import (DeviceLeafTable,
                                                            EvalResult)
from explicit_hybrid_mpc_tpu_torch.online.export import LeafTable

#: Launches of the CUDA kernel.  A plain counter; chip_smoke.py zeroes
#: it before the main path and reads it after.
launches = 0

#: Largest p + 1 the kernel is instantiated for.
MAX_K = 8

#: Query rows per chunk of the plain version's (chunk, L, p+1) tensor.
_CHUNK_ELEMS = 1 << 26


class LocateTable(NamedTuple):
    """Leaf table staged for point location: bary (L, p+1, p+1) float32,
    the f32 cast of LeafTable.bary_M, on the device that will run it."""

    bary: torch.Tensor
    n_leaves: int
    p: int


def stage(table: LeafTable, device=None) -> LocateTable:
    """Host-side pack: LeafTable -> float32 table on `device` ('cuda' by
    default; 'cpu' on request)."""
    dev = device_lib.resolve(device)
    L, pp1, _ = table.bary_M.shape
    bary = torch.as_tensor(np.ascontiguousarray(table.bary_M,
                                                dtype=np.float32)).to(dev)
    return LocateTable(bary=bary, n_leaves=int(L), p=int(pp1 - 1))


def _th1(thetas: torch.Tensor) -> torch.Tensor:
    B = thetas.shape[0]
    return torch.cat([thetas, torch.ones((B, 1), dtype=thetas.dtype,
                                         device=thetas.device)], dim=1)


def locate_torch(bary: torch.Tensor, thetas: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: (leaf (B,) int32, score (B,) float32), computed on
    the tensors' device in float32, in query chunks."""
    th1 = _th1(thetas.to(torch.float32))
    L, pp1, _ = bary.shape
    B = th1.shape[0]
    if L == 0:
        return (torch.zeros(B, dtype=torch.int32, device=th1.device),
                torch.full((B,), -np.inf, dtype=torch.float32,
                           device=th1.device))
    chunk = max(1, _CHUNK_ELEMS // max(1, L * pp1))
    leaves, scores = [], []
    for lo in range(0, B, chunk):
        lam = torch.einsum("lij,bj->bli", bary, th1[lo:lo + chunk])
        score = lam.amin(dim=-1)
        leaf = torch.argmax(score, dim=-1)       # first maximum
        leaves.append(leaf.to(torch.int32))
        scores.append(torch.gather(score, 1, leaf[:, None])[:, 0])
    return torch.cat(leaves), torch.cat(scores)


def _lib():
    lib = kernels.library("locate")
    if not getattr(lib, "_ehm_typed", False):
        lib.locate_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_void_p]
        lib.locate_f32.restype = ctypes.c_int
        lib.locate_error_string.argtypes = [ctypes.c_int]
        lib.locate_error_string.restype = ctypes.c_char_p
        lib._ehm_typed = True
    return lib


def locate_cuda(bary: torch.Tensor, thetas: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel; raises on anything it does not take.
    Does not synchronize."""
    dev = bary.device
    L, pp1, pp1b = bary.shape
    if not bary.is_cuda or bary.dtype != torch.float32 \
            or not bary.is_contiguous() or pp1 != pp1b:
        raise ValueError("locate: bary must be a contiguous (L, p+1, p+1) "
                         "float32 CUDA tensor")
    if pp1 > MAX_K or pp1 < 2:
        raise ValueError(f"locate: p+1={pp1} outside the kernel's 2..{MAX_K}")
    th = thetas.to(device=dev, dtype=torch.float32).contiguous()
    B, p = th.shape
    if p != pp1 - 1:
        raise ValueError(f"locate: thetas have {p} columns, table p={pp1 - 1}")
    leaf = torch.empty(B, dtype=torch.int32, device=dev)
    score = torch.empty(B, dtype=torch.float32, device=dev)
    if B == 0:
        return leaf, score
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.locate_f32(th.data_ptr(), bary.data_ptr(), B, L, p,
                             leaf.data_ptr(), score.data_ptr(), stream)
    if err != 0:
        raise kernels.KernelError("locate: CUDA launch failed: "
                           + lib.locate_error_string(err).decode())
    global launches
    launches += 1
    return leaf, score


def locate(ltable: LocateTable, thetas: torch.Tensor
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Best-containing leaf per query: (leaf_idx (B,) int32, score (B,)
    float32).  score >= -tol  <=>  theta is inside leaf_idx's simplex.
    The CUDA kernel for a CUDA table, the plain version for a CPU one."""
    thetas = torch.as_tensor(thetas, device=ltable.bary.device)
    if ltable.bary.device.type == "cuda":
        return locate_cuda(ltable.bary, thetas)
    if ltable.bary.device.type != "cpu":
        raise ValueError(f"locate: unsupported device {ltable.bary.device}")
    return locate_torch(ltable.bary, thetas)


def evaluate(ltable: LocateTable, dev_table: DeviceLeafTable,
             thetas: torch.Tensor, tol: float = 1e-4) -> EvalResult:
    """Kernel-located, f64-interpolated PWA evaluation: the located
    leaf's barycentric matrix and vertex data are gathered from the f64
    table (online.evaluator.DeviceLeafTable), so the control law itself
    is computed at full precision."""
    thetas = torch.as_tensor(thetas, dtype=torch.float64,
                             device=dev_table.bary_M.device)
    leaf, score = locate(ltable, thetas)
    idx = leaf.long()
    # (p+1)-term products as elementwise multiply-reduce rather than a
    # batched matmul of one tiny block per query.
    lam = torch.sum(dev_table.bary_M[idx] * _th1(thetas)[:, None, :], dim=2)
    u = torch.sum(lam[:, :, None] * dev_table.U[idx], dim=1)
    cost = torch.sum(lam * dev_table.V[idx], dim=1)
    return EvalResult(u=u, cost=cost, leaf=leaf, inside=score >= -tol)
