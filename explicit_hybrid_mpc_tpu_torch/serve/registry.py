"""Serving artifacts on disk: write one from a built tree, and recover
the certified box from its descent arrays.

Artifacts are the flat files the online stage deploys from (the
online/export.py leaf table + the online/descent.py ``descent.npz``;
the pickled Tree is never needed), the same directory layout the JAX
package's serve/registry.py writes and reads.  The versioned
``ControllerRegistry`` and its ``load_artifacts`` serve through the
sharded descent evaluator and wait for that port slice (ROADMAP A12).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch


def save_artifacts(tree, roots, dir_path: str,
                   provenance: Optional[dict] = None,
                   checksum: bool = True) -> None:
    """Export a built tree as one serving artifact directory: the
    memmap-streamed leaf table (online/export.write_leaf_table) plus
    the descent arrays as ``descent.npz``.  RSS stays O(chunk);
    ``checksum=False`` skips the per-field sha256 re-read pass.  The
    build-provenance stamp (default: the tree's own) rides the table's
    meta.json.

    Write order is crash-safe: the table fields AND descent.npz land
    first, the meta.json commit marker LAST (export.commit_leaf_table)
    -- a crash anywhere mid-export leaves an uncommitted directory,
    never a 'valid' table next to a missing or stale descent file."""
    from explicit_hybrid_mpc_tpu_torch.online import descent as descent_mod
    from explicit_hybrid_mpc_tpu_torch.online import export as export_mod

    if provenance is None:
        provenance = getattr(tree, "provenance", None)
    table = export_mod.write_leaf_table(tree, dir_path,
                                        provenance=provenance,
                                        commit=False)
    dt = descent_mod.export_descent(tree, roots, table, stage=False)
    descent_mod.save_descent(dt, os.path.join(dir_path, "descent.npz"))
    export_mod.commit_leaf_table(dir_path, table.n_leaves, tree.p,
                                 tree.n_u, provenance,
                                 checksum=checksum)


def root_box(dt) -> tuple[np.ndarray, np.ndarray]:
    """(lb, ub) bounding box of the root simplices of anything carrying
    a ``root_bary`` field (a DescentTable, host or staged).

    The serving artifacts deliberately omit the problem object, but the
    fallback clamp needs the certified box.  Each root's barycentric
    matrix M satisfies inv(M) = [[V^T], [1]] (lam = M @ [theta; 1]), so
    the root vertices are recoverable from the table alone."""
    M = dt.root_bary
    if isinstance(M, torch.Tensor):
        M = M.cpu().numpy()
    inv = np.linalg.inv(np.asarray(M, dtype=np.float64))  # (R, p+1, p+1)
    verts = inv[:, :-1, :]  # (R, p, p+1): column k = vertex k
    return verts.min(axis=(0, 2)), verts.max(axis=(0, 2))
