"""Online PWA controller evaluation: the plain f64 reference.

u(theta): locate the leaf simplex containing theta, take barycentric
weights lambda, return u = sum_i lambda_i u_i.  Point location here is
brute force: lambda for EVERY leaf, then the leaf with the
least-negative minimum barycentric coordinate (inside <=> min_i
lambda_i >= 0), first leaf on ties.  This is the float64 reference the
point-location kernel (online/locate.py) is checked against; it runs in
query chunks so the (queries x leaves) tensor stays bounded.

A query outside every simplex returns the best-matching leaf anyway;
callers needing strict domain checks read the returned `inside` flag.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from explicit_hybrid_mpc_tpu_torch import device as device_lib
from explicit_hybrid_mpc_tpu_torch import obs as obs_lib
from explicit_hybrid_mpc_tpu_torch.online.export import LeafTable

#: Query rows per chunk of the brute-force contraction: bounds the
#: (chunk, L, p+1) float64 tensor to ~chunk * L * 24 bytes.
_CHUNK_ELEMS = 1 << 25


class EvalResult(NamedTuple):
    u: torch.Tensor        # (B, n_u)
    cost: torch.Tensor     # (B,) interpolated vertex cost (certified upper bd)
    leaf: torch.Tensor     # (B,) leaf row index
    inside: torch.Tensor   # (B,) bool: min barycentric coord >= -tol


class DeviceLeafTable(NamedTuple):
    bary_M: torch.Tensor   # (L, p+1, p+1) float64
    U: torch.Tensor        # (L, p+1, n_u) float64
    V: torch.Tensor        # (L, p+1) float64


def stage(table: LeafTable, device=None,
          obs: "obs_lib.Obs | None" = None) -> DeviceLeafTable:
    """Host leaf table -> float64 tensors on `device` ('cuda' by
    default; 'cpu' on request).  The staging span makes the one-time
    host->device transfer visible at large L."""
    dev = device_lib.resolve(device)
    o = obs if obs is not None else obs_lib.default()
    with o.span("serve.stage_leaves", leaves=int(table.n_leaves)):
        return DeviceLeafTable(*(
            torch.as_tensor(np.ascontiguousarray(a),
                            dtype=torch.float64).to(dev)
            for a in (table.bary_M, table.U, table.V)))


def evaluate(dev: DeviceLeafTable, thetas: torch.Tensor,
             tol: float = 1e-9) -> EvalResult:  # tpulint: device-region
    """Batched PWA evaluation: thetas (B, p) -> EvalResult, in float64
    on the table's device."""
    thetas = torch.as_tensor(thetas, dtype=torch.float64,
                             device=dev.bary_M.device)
    B, p = thetas.shape
    L = dev.bary_M.shape[0]
    th1 = torch.cat([thetas, torch.ones((B, 1), dtype=thetas.dtype,
                                        device=thetas.device)], dim=1)
    chunk = max(1, _CHUNK_ELEMS // max(1, L * (p + 1)))
    leaves, lams, best = [], [], []
    for lo in range(0, B, chunk):
        # lam[b, l, i] = bary_M[l, i, :] . th1[b]
        lam = torch.einsum("lij,bj->bli", dev.bary_M, th1[lo:lo + chunk])
        score = lam.amin(dim=-1)                 # (b, L) containment margin
        leaf = torch.argmax(score, dim=-1)       # best (first on ties)
        leaves.append(leaf)
        best.append(torch.gather(score, 1, leaf[:, None])[:, 0])
        lams.append(lam[torch.arange(leaf.shape[0], device=leaf.device),
                        leaf])
    leaf = torch.cat(leaves)
    lam_best = torch.cat(lams)                   # (B, p+1)
    u = torch.einsum("bi,bin->bn", lam_best, dev.U[leaf])
    cost = torch.einsum("bi,bi->b", lam_best, dev.V[leaf])
    inside = torch.cat(best) >= -tol
    return EvalResult(u=u, cost=cost, leaf=leaf, inside=inside)


def evaluate_np(table: LeafTable, theta: np.ndarray) -> np.ndarray:
    """Single-point numpy evaluation (host reference for tests)."""
    th1 = np.concatenate([theta, [1.0]])
    lam = table.bary_M @ th1                  # (L, p+1)
    leaf = int(np.argmax(lam.min(axis=1)))
    return table.U[leaf].T @ lam[leaf]
