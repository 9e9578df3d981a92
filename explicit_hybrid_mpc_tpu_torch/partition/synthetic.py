"""Vectorized synthetic partition trees (export / serving scale tests).

Building a million-leaf tree through the real engine takes hours of
oracle solves; the export and serving layers, though, only care about
the TREE -- its geometry, hyperplanes, and leaf payloads.  This module
grows a balanced longest-edge-bisection tree with a synthetic linear
control law ONE LEVEL AT A TIME, each level as a handful of vectorized
numpy passes over every leaf at once (~2 s for 2^20 leaves, vs minutes
through per-node Tree.split calls), writing the columnar storage
directly.

Fidelity contract (tests/test_torch_sharded.py pins it): the result
is bit-identical to the same tree built through
geometry.bisect + Tree.split + Tree.set_leaf -- same edge selection
(the relative-margin longest-edge tie-break of geometry.longest_edge,
vectorized), same midpoint arithmetic, same split-time hyperplanes --
so anything proven on a synthetic tree transfers to engine-built ones.
"""

from __future__ import annotations

import numpy as np

from explicit_hybrid_mpc_tpu_torch.partition import geometry
from explicit_hybrid_mpc_tpu_torch.partition.tree import (_F_CERTIFIED, _F_DATA,
                                                    Tree)


def _longest_edges(V: np.ndarray) -> np.ndarray:
    """(K, 2) longest-edge (i, j) per simplex: geometry.longest_edge's
    sequential relative-margin scan, vectorized over the batch (the
    pair loop is over the (p+1)p/2 index pairs, not the K simplices)."""
    K, m, _ = V.shape
    D = V[:, :, None, :] - V[:, None, :, :]
    d2 = np.einsum("kijp,kijp->kij", D, D)
    best_d = np.full(K, -1.0)
    best = np.zeros((K, 2), dtype=np.int64)
    for i in range(m):
        for j in range(i + 1, m):
            d = d2[:, i, j]
            upd = d > best_d * (1.0 + 1e-12)
            best_d[upd] = d[upd]
            best[upd] = (i, j)
    return best


def leaf_payload(V: np.ndarray, n_u: int
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Synthetic vertex payloads for leaf vertex matrices V (K, m, p):
    a fixed linear law u(theta) = A theta (exactly reproduced by
    barycentric interpolation, so evaluator cross-checks stay exact)
    and cost V(theta) = sum(theta).  Returns (U (K, m, n_u), c (K, m))."""
    p = V.shape[2]
    A = (np.arange(n_u)[:, None] + 1.0) * (np.arange(p)[None, :] + 1.0)
    return np.einsum("kmp,up->kmu", V, A), V.sum(axis=2)


def build_synthetic_tree(p: int = 2, depth: int = 10, n_u: int = 1,
                         lb=None, ub=None) -> tuple[Tree, list[int]]:
    """Balanced depth-`depth` bisection tree over the [lb, ub] box
    (default unit box): n_roots * 2^depth leaves, every leaf carrying a
    synthetic certified payload, split-time hyperplanes live.  Returns
    (tree, roots) matching build_partition's result shape."""
    lb = np.full(p, 0.0) if lb is None else np.asarray(lb, float)
    ub = np.full(p, 1.0) if ub is None else np.asarray(ub, float)
    roots_V = geometry.box_triangulation(lb, ub)
    R = roots_V.shape[0]
    m = p + 1
    tree = Tree(p=p, n_u=n_u)
    n_total = R * (2 ** (depth + 1) - 1)
    tree._grow(n_total)
    tree._vertices[:R] = roots_V
    tree._depth[:R] = 0
    tree._n = R
    ids = np.arange(R, dtype=np.int64)
    V = roots_V
    for d in range(depth):
        K = ids.size
        ij = _longest_edges(V)
        ar = np.arange(K)
        w, c = geometry.split_hyperplanes(V, ij)
        mid = 0.5 * (V[ar, ij[:, 0]] + V[ar, ij[:, 1]])
        left = V.copy()
        left[ar, ij[:, 1]] = mid
        right = V.copy()
        right[ar, ij[:, 0]] = mid
        # Children interleave left/right per parent, in parent order --
        # the same id layout a Tree.split loop produces.
        n0 = tree._n
        kids = np.empty((2 * K, m, p))
        kids[0::2] = left
        kids[1::2] = right
        tree._vertices[n0:n0 + 2 * K] = kids
        tree._parent[n0:n0 + 2 * K] = np.repeat(ids, 2).astype(np.int32)
        tree._depth[n0:n0 + 2 * K] = d + 1
        li = n0 + 2 * ar
        tree._children[ids, 0] = li.astype(np.int32)
        tree._children[ids, 1] = (li + 1).astype(np.int32)
        tree._split_edge[ids] = ij
        tree._normal[ids] = w
        tree._offset[ids] = c
        tree._n = n0 + 2 * K
        ids = np.arange(n0, n0 + 2 * K, dtype=np.int64)
        V = np.empty((2 * K, m, p))
        V[0::2] = left
        V[1::2] = right
    tree._max_depth = depth
    # Leaf payloads, written columnar in one pass (a per-leaf set_leaf
    # loop is minutes at 10^6 leaves).
    K = ids.size
    U, costs = leaf_payload(V, n_u)
    tree._grow_payload(K)
    tree._pl_delta[:K] = 0
    tree._pl_inputs[:K] = U
    tree._pl_costs[:K] = costs
    tree._leaf_slot[ids] = np.arange(K, dtype=np.int32)
    tree._leaf_flags[ids] = _F_DATA | _F_CERTIFIED
    tree._n_slots = K
    tree._n_regions = K
    return tree, list(range(R))
