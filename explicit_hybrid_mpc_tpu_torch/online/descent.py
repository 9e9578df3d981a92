"""O(depth) tree-descent point location.

The brute-force locate (online/evaluator.py, online/locate.py) touches
every leaf per query -- O(L) work, the right trade at 10^3-10^4 leaves
where one fused contraction wins.  This module is the O(depth)
alternative for LARGE partitions: the tree's internal nodes export as
flat split-hyperplane arrays and the descent runs as a fixed-trip-count
loop of gathers, one hyperplane sign test per level.  It is the
counterpart of the JAX package's online/descent.py, in plain torch
(there is no device kernel here).

Geometry: a longest-edge bisection's two children are separated by the
hyperplane through the shared face = {edge midpoint} u {the p-1 unsplit
vertices}.  Sign convention: h(x) = w.x - c <= 0 on the LEFT child (the
child that kept vertex i of the split edge (i, j), left = V with V[j]
replaced by the midpoint -- partition/geometry.bisect).

Root location is a brute-force min-barycentric argmax over the ROOTS
only (at most p! per sub-box, tiny next to the leaf count).

The serving arena reads one thing from a descent artifact: ``root_bary``,
whose inverses give the certified box (serve/registry.root_box).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from explicit_hybrid_mpc_tpu_torch import device as device_lib
from explicit_hybrid_mpc_tpu_torch import obs as obs_lib
from explicit_hybrid_mpc_tpu_torch.online.evaluator import (DeviceLeafTable,
                                                            EvalResult)
from explicit_hybrid_mpc_tpu_torch.online.export import LeafTable
from explicit_hybrid_mpc_tpu_torch.partition import geometry
from explicit_hybrid_mpc_tpu_torch.partition.tree import NO_CHILD, Tree

_FIELDS = ("root_bary", "root_node", "children", "normal", "offset",
           "leaf_row")


@dataclasses.dataclass(frozen=True)
class DescentTable:
    """Flat arrays for the descent locate: host numpy (export with
    stage=False, load_descent) or torch tensors on one device
    (``stage_table``).  max_depth is the descent loop's trip count."""

    root_bary: "np.ndarray | torch.Tensor"  # (R, p+1, p+1)
    root_node: "np.ndarray | torch.Tensor"  # (R,) i32 tree node per root
    children: "np.ndarray | torch.Tensor"   # (Nn, 2) i32, NO_CHILD at leaves
    normal: "np.ndarray | torch.Tensor"     # (Nn, p) split normal
    offset: "np.ndarray | torch.Tensor"     # (Nn,) split offset
    leaf_row: "np.ndarray | torch.Tensor"   # (Nn,) i32 table row; -1 elsewhere
    max_depth: int


def stage_table(table: DescentTable, device=None) -> DescentTable:
    """Host arrays -> tensors on `device` ('cuda' by default; 'cpu' on
    request)."""
    dev = device_lib.resolve(device)
    return DescentTable(
        **{k: torch.as_tensor(np.asarray(getattr(table, k))).to(dev)
           for k in _FIELDS},
        max_depth=int(table.max_depth))


def export_descent(tree: Tree, roots: list[int], table: LeafTable,
                   force_batched: bool = False, stage: bool = True,
                   obs: "obs_lib.Obs | None" = None,
                   device=None) -> DescentTable:
    """Flatten a built tree into descent arrays (host, then staged on
    `device` unless stage=False).

    Trees built with split-time hyperplanes (Tree.split, the default)
    already hold every internal node's normal/offset, so this is array
    slicing; trees without them fall back to ONE batched SVD over all
    internal nodes (geometry.split_hyperplanes); `force_batched=True`
    forces that path for the split-time-vs-batched cross-check."""
    o = obs if obs is not None else obs_lib.default()
    with o.span("export.descent", nodes=len(tree),
                leaves=int(table.n_leaves)) as sp:
        Nn = len(tree)
        p = tree.p
        children = np.asarray(tree.children, dtype=np.int32)
        use_stored = tree.split_hyperplanes_available() and not force_batched
        sp["stored_hyperplanes"] = bool(use_stored)
        if use_stored:
            normal = np.array(tree.split_normals, dtype=np.float64)
            offset = np.array(tree.split_offsets, dtype=np.float64)
        else:
            normal = np.zeros((Nn, p))
            offset = np.zeros(Nn)
            internal = np.flatnonzero(children[:, 0] != NO_CHILD)
            if internal.size:
                w, c = geometry.split_hyperplanes(
                    np.asarray(tree.vertices[internal]),
                    np.asarray(tree.split_edge[internal], dtype=np.int64))
                normal[internal] = w
                offset[internal] = c
        leaf_row = np.full(Nn, -1, dtype=np.int32)
        leaf_row[table.node_id] = np.arange(table.n_leaves, dtype=np.int32)
        root_bary = geometry.barycentric_matrices(
            tree.vertices[np.asarray(roots, dtype=np.int64)])
        host = DescentTable(
            root_bary=np.asarray(root_bary),
            root_node=np.asarray(roots, dtype=np.int32),
            children=children, normal=normal, offset=offset,
            leaf_row=leaf_row, max_depth=int(tree.max_depth()))
    return stage_table(host, device) if stage else host


# tpulint: device-region
def descend_from(table: DescentTable, thetas: torch.Tensor,
                 node: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Descend from per-query start nodes ((B,) int): max_depth rounds
    of hyperplane sign tests.  Returns (leaf-table row (B,) i32, tree
    node (B,) i32).  Every product here and in evaluate_rows is an
    elementwise multiply-reduce, so a row's answer does not depend on
    the batch it came in (a batched matmul's algorithm on the card may
    change with the batch count); the serving path's bitwise audits
    rely on that."""
    node = node.to(torch.int64)
    for _ in range(table.max_depth):
        ch = table.children[node].to(torch.int64)               # (B, 2)
        h = (torch.sum(table.normal[node] * thetas, dim=1)
             - table.offset[node])
        nxt = torch.where(h <= 0, ch[:, 0], ch[:, 1])
        node = torch.where(ch[:, 0] == NO_CHILD, node, nxt)
    return table.leaf_row[node], node.to(torch.int32)


# tpulint: device-region
def locate_descent(table: DescentTable, thetas: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Leaf-table row per query (i32 (B,)), plus the tree node id.

    Row is -1 when the descent lands on a non-converged (infeasible /
    hole) leaf.  Queries outside every root descend from the
    best-matching root (callers read the evaluator's `inside` flag)."""
    thetas = torch.as_tensor(thetas, dtype=table.normal.dtype,
                             device=table.normal.device)
    B = thetas.shape[0]
    th1 = torch.cat([thetas, torch.ones((B, 1), dtype=thetas.dtype,
                                        device=thetas.device)], dim=1)
    lam = torch.einsum("rij,bj->bri", table.root_bary, th1)
    best_root = torch.argmax(lam.amin(dim=-1), dim=-1)          # (B,)
    return descend_from(table, thetas, table.root_node[best_root])


# tpulint: device-region
def evaluate_rows(dev: DeviceLeafTable, thetas: torch.Tensor,
                  row: torch.Tensor, tol: float = 1e-9) -> EvalResult:
    """Barycentric-interpolated PWA evaluation at already-located leaf
    rows (-1 = no converged leaf; flagged outside)."""
    B = thetas.shape[0]
    safe = torch.clamp(row.to(torch.int64), min=0)
    th1 = torch.cat([thetas, torch.ones((B, 1), dtype=dev.bary_M.dtype,
                                        device=thetas.device)], dim=1)
    lam = torch.sum(dev.bary_M[safe] * th1[:, None, :], dim=2)
    u = torch.sum(lam[:, :, None] * dev.U[safe], dim=1)
    cost = torch.sum(lam * dev.V[safe], dim=1)
    inside = (row >= 0) & (lam.amin(dim=-1) >= -tol)
    return EvalResult(u=u, cost=cost, leaf=safe, inside=inside)


def evaluate_descent(table: DescentTable, dev: DeviceLeafTable,
                     thetas: torch.Tensor, tol: float = 1e-9) -> EvalResult:
    """Descent-located, barycentric-interpolated PWA evaluation -- same
    contract as online.evaluator.evaluate, O(depth) instead of O(L)."""
    thetas = torch.as_tensor(thetas, dtype=torch.float64,
                             device=dev.bary_M.device)
    row, _node = locate_descent(table, thetas)
    return evaluate_rows(dev, thetas, row, tol)


def save_descent(table: DescentTable, path: str) -> None:
    """Persist descent arrays as one .npz, written atomically
    (utils/atomic.py tmp+rename, np.savez streaming into the tmp
    handle): a crash mid-save leaves the previous complete file."""
    from explicit_hybrid_mpc_tpu_torch.utils import atomic

    def host(a):
        return a.cpu().numpy() if isinstance(a, torch.Tensor) \
            else np.asarray(a)

    with atomic.atomic_file(path) as f:
        np.savez(f, **{k: host(getattr(table, k)) for k in _FIELDS},
                 max_depth=np.asarray(table.max_depth, dtype=np.int64))


def load_descent(path: str) -> DescentTable:
    """Load a descent .npz as host arrays (``stage_table`` moves them
    to a device)."""
    with np.load(path) as z:
        return DescentTable(**{k: np.asarray(z[k]) for k in _FIELDS},
                            max_depth=int(z["max_depth"]))
