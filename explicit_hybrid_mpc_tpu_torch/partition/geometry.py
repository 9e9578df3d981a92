"""Simplex geometry for the partition engine.

Host-side (numpy) counterparts of the reference's geometry helpers
(SURVEY.md section 3 "Geometry & misc tools", [M-med], UNVERIFIED --
reference mount empty): triangulation of the parameter box into root
simplices, barycentric coordinates, longest-edge bisection, volumes.

Everything here is deterministic (lexicographic tie-breaks) because region-
count parity between the serial-CPU and TPU oracle paths requires identical
subdivision decisions (BASELINE.json north-star).

A simplex in R^p is stored as a vertex matrix ``V`` of shape (p+1, p).
"""

from __future__ import annotations

import itertools
import math

import numpy as np


def kuhn_triangulation(lb: np.ndarray, ub: np.ndarray) -> np.ndarray:
    """Triangulate the box [lb, ub] into p! simplices (Kuhn/Freudenthal).

    Each permutation ``pi`` of (0..p-1) yields the simplex with vertices
    ``v_0 = lb``, ``v_{k+1} = v_k + (ub-lb)[pi[k]] * e_{pi[k]}``.  The union
    covers the box exactly, interiors are disjoint, and the construction is
    deterministic -- unlike Delaunay of the 2^p corners, it needs no Qhull
    and is stable in any dimension.  Returns (p!, p+1, p).

    The reference Delaunay-triangulates the parameter box into root
    simplices (SURVEY.md section 1 step 1, [P]); Kuhn gives the same cover
    with a reproducible simplex set.
    """
    lb = np.asarray(lb, dtype=np.float64)
    ub = np.asarray(ub, dtype=np.float64)
    if lb.shape != ub.shape or lb.ndim != 1:
        raise ValueError("lb/ub must be 1-D with equal shapes")
    if not np.all(ub > lb):
        raise ValueError("need ub > lb elementwise")
    p = lb.size
    if p > 7:
        raise ValueError(
            f"Kuhn triangulation of a {p}-D box has {math.factorial(p)} "
            "root simplices; partition over a lower-dimensional parameter "
            "subspace instead (see problems.base.ParameterMap)"
        )
    edges = ub - lb
    sims = []
    for pi in itertools.permutations(range(p)):
        verts = np.empty((p + 1, p), dtype=np.float64)
        verts[0] = lb
        for k, axis in enumerate(pi):
            verts[k + 1] = verts[k]
            verts[k + 1, axis] += edges[axis]
        sims.append(verts)
    return np.stack(sims)


def box_triangulation(lb: np.ndarray, ub: np.ndarray,
                      splits: dict | None = None) -> np.ndarray:
    """Kuhn-triangulate the box after pre-splitting along axis planes.

    ``splits`` maps axis index -> iterable of coordinate values; the box is
    cut into sub-boxes at each value strictly inside the range, and every
    sub-box is Kuhn-triangulated.  Returns (n_simplices, p+1, p).

    Why pre-split: a problem whose commutation feasibility changes across a
    fixed hyperplane in theta (e.g. PWA mode membership of the initial
    state) can never certify a simplex STRADDLING that plane -- no single
    commutation is feasible at vertices on both sides -- and longest-edge
    bisection midpoints approach but need not ever hit the plane, so the
    subdivision would refine forever.  Aligning root cell faces with the
    plane makes every descendant stay in one closed halfspace.
    """
    lb = np.asarray(lb, dtype=np.float64)
    ub = np.asarray(ub, dtype=np.float64)
    boxes = [(lb, ub)]
    for axis, values in sorted((splits or {}).items()):
        new = []
        for lo, hi in boxes:
            cuts = [v for v in sorted(set(values))
                    if lo[axis] < v < hi[axis]]
            edges = [lo[axis]] + cuts + [hi[axis]]
            for a, b in zip(edges[:-1], edges[1:]):
                nlo, nhi = lo.copy(), hi.copy()
                nlo[axis], nhi[axis] = a, b
                new.append((nlo, nhi))
        boxes = new
    return np.concatenate([kuhn_triangulation(lo, hi) for lo, hi in boxes])


def _perm_rank(order: np.ndarray) -> np.ndarray:
    """(B, p) permutation rows -> lexicographic rank (Lehmer code),
    matching the order itertools.permutations(range(p)) yields."""
    B, p = order.shape
    rank = np.zeros(B, dtype=np.int64)
    for i in range(p):
        smaller = (order[:, i + 1:] < order[:, i:i + 1]).sum(axis=1)
        rank += smaller * math.factorial(p - 1 - i)
    return rank


def kuhn_root_locator(lb: np.ndarray, ub: np.ndarray,
                      splits: dict | None = None):
    """O(p^2)-per-query analytic root location for box_triangulation
    partitions: returns ``locate(thetas (B, p)) -> (B,) root index``
    into the triangulation's simplex order.

    The brute root pick (min-barycentric argmax over ALL roots) is a
    (B, R, p+1, p+1) contraction -- at the satellite full box's 720
    roots it costs more than the whole tree descent it routes for.  A
    Kuhn simplex needs no scan: x lies in the sub-box found by
    per-axis bisection of the split planes, and within it in the
    permutation simplex given by sorting the normalized coordinates
    DESCENDING (v_{k+1} = v_k + edge[pi[k]] e_{pi[k]}, so axes added
    earlier carry larger normalized coordinates).  Stable descending
    argsort reproduces the brute pick's first-max tie-break on shared
    faces WITHIN a sub-box (the lexicographically smallest containing
    permutation).  Queries EXACTLY ON a split plane land in the lower
    sub-box (its t=1 face); the brute scan's pick there is decided by
    last-ulp noise in the barycentric inverses (the true margins tie
    at 0), so the two may name different roots -- both contain the
    query, and interpolated values agree by facet continuity, the same
    caveat as shared facets everywhere in the online stack.  Queries
    OUTSIDE the box clamp to the nearest sub-box, which may differ
    from the brute pick's best-margin root -- callers read the
    evaluator's `inside` flag either way, exactly as with the scan.

    Only valid for trees whose roots came from box_triangulation(lb,
    ub, splits) with THESE arguments, in its simplex order.
    """
    lb = np.asarray(lb, dtype=np.float64)
    ub = np.asarray(ub, dtype=np.float64)
    p = lb.size
    fact = math.factorial(p)
    # Interior cut values per split axis, in box_triangulation's
    # (sorted-axis, ascending-interval) nesting order.
    axes = []
    for axis, values in sorted((splits or {}).items()):
        cuts = np.asarray([v for v in sorted(set(values))
                           if lb[axis] < v < ub[axis]], dtype=np.float64)
        if cuts.size:
            axes.append((axis, cuts))

    def locate(thetas: np.ndarray) -> np.ndarray:
        thetas = np.asarray(thetas, dtype=np.float64)
        B = thetas.shape[0]
        box_idx = np.zeros(B, dtype=np.int64)
        lo = np.broadcast_to(lb, thetas.shape).copy()
        hi = np.broadcast_to(ub, thetas.shape).copy()
        for axis, cuts in axes:
            # side="left": a query EXACTLY ON a cut plane lands in the
            # LOWER sub-box (on its t=1 face), which is the first
            # containing root in triangulation order -- the same root
            # the brute argmax's first-max tie-break picks.
            k = np.searchsorted(cuts, thetas[:, axis], side="left")
            box_idx = box_idx * (cuts.size + 1) + k
            edges = np.concatenate([[lb[axis]], cuts, [ub[axis]]])
            lo[:, axis] = edges[k]
            hi[:, axis] = edges[k + 1]
        t = (thetas - lo) / (hi - lo)
        order = np.argsort(-t, axis=1, kind="stable")
        return box_idx * fact + _perm_rank(order)

    return locate


def barycentric_matrix(V: np.ndarray) -> np.ndarray:
    """Matrix M with lambda = M @ [theta; 1] the barycentric coordinates.

    V is (p+1, p).  Solves [V^T; 1^T] lambda = [theta; 1]; M is the inverse
    of that (p+1)x(p+1) system, precomputed per leaf for the online
    evaluator (SURVEY.md section 4.2).
    """
    p = V.shape[1]
    A = np.vstack([V.T, np.ones((1, p + 1))])
    return np.linalg.inv(A)


def barycentric_matrices(Vs: np.ndarray,
                         chunk: int = 1 << 20) -> np.ndarray:
    """Batched barycentric_matrix: (L, p+1, p) -> (L, p+1, p+1).

    One batched inverse per chunk instead of a per-leaf python loop --
    the loop (plus its L small-array intermediates) is what blew the
    online export past host RAM at the 9.8M-leaf satellite full-box
    ledger.  Chunking bounds the transient [V^T; 1] stack."""
    Vs = np.asarray(Vs, dtype=np.float64)
    L, m, p = Vs.shape
    out = np.empty((L, m, m), dtype=np.float64)
    for lo in range(0, L, chunk):
        Vc = Vs[lo:lo + chunk]
        A = np.concatenate(
            [Vc.transpose(0, 2, 1),
             np.ones((Vc.shape[0], 1, m), dtype=np.float64)], axis=1)
        out[lo:lo + chunk] = np.linalg.inv(A)
    return out


def barycentric(V: np.ndarray, theta: np.ndarray) -> np.ndarray:
    """Barycentric coordinates of theta w.r.t. simplex V ((p+1,p))."""
    M = barycentric_matrix(V)
    return M @ np.concatenate([theta, [1.0]])


def contains(V: np.ndarray, theta: np.ndarray, tol: float = 1e-9) -> bool:
    """Point-in-simplex test via barycentric nonnegativity."""
    lam = barycentric(V, theta)
    return bool(np.all(lam >= -tol))


def simplex_volume(V: np.ndarray) -> float:
    """Volume of the simplex with vertex matrix V ((p+1, p))."""
    p = V.shape[1]
    D = V[1:] - V[0]
    return float(abs(np.linalg.det(D)) / math.factorial(p))


def longest_edge(V: np.ndarray) -> tuple[int, int]:
    """Indices (i, j), i < j, of the longest edge; lexicographic tie-break.

    The subdivision step bisects this edge (SURVEY.md section 1 step 2c,
    [P]/[NS]: "longest-edge bisection").  Tie-break must be deterministic
    for backend-parity of the produced tree.
    """
    n = V.shape[0]
    # One vectorized pass for the pairwise squared lengths (the python
    # np.dot double loop was ~150 ms/step at cluster-scale batch sizes);
    # the selection loop below runs on plain floats and keeps the exact
    # sequential tie-break semantics.
    D = V[:, None, :] - V[None, :, :]
    d2 = np.einsum("ijk,ijk->ij", D, D)
    best = (-1.0, 0, 1)
    for i in range(n):
        row = d2[i]
        for j in range(i + 1, n):
            d = row[j]
            # Strict > with a RELATIVE margin keeps the lexicographically
            # first pair on ties at ANY scale: squared edge lengths shrink
            # ~4x per bisection level, so an absolute epsilon would turn
            # every comparison at depth >~ 20 into a "tie" and silently
            # replace longest-edge (Rivara shape regularity) with
            # lexicographic-first selection.
            if d > best[0] * (1.0 + 1e-12):
                best = (d, i, j)
    return best[1], best[2]


def bisect(V: np.ndarray) -> tuple[np.ndarray, np.ndarray, int, int, np.ndarray]:
    """Longest-edge bisection: split V into two children.

    Returns (child_left, child_right, i, j, midpoint) where the split edge
    is (i, j) and each child replaces one endpoint with the midpoint.  The
    children cover V exactly with disjoint interiors; repeated longest-edge
    bisection keeps simplices shape-regular (Rivara).
    """
    i, j = longest_edge(V)
    mid = 0.5 * (V[i] + V[j])
    left = V.copy()
    left[j] = mid
    right = V.copy()
    right[i] = mid
    return left, right, i, j, mid


def split_hyperplanes(Vs: np.ndarray, ij: np.ndarray
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Batched split-face hyperplanes of longest-edge bisections.

    Vs (N, p+1, p) parent vertex matrices, ij (N, 2) split edges.
    Returns (w (N, p), c (N,)) with ||w||=1, oriented so w.x - c <= 0 on
    the LEFT child (the child that keeps vertex i of edge (i, j)): the
    hyperplane passes through the shared child face = {edge midpoint} u
    {the p-1 unsplit vertices}, and its normal is the nullspace direction
    of that face's spanning vectors.

    This is THE hyperplane definition of the descent locate
    (online/descent.py).  Tree.split calls it with N=1 at split time and
    export_descent with N=all-internal-nodes as the fallback; per-row
    results are bit-identical between the two (np.linalg.svd and the
    einsum row reductions operate per matrix/row), which is what the
    split-time-vs-batched parity tests pin."""
    Vs = np.asarray(Vs, dtype=np.float64)
    ij = np.asarray(ij, dtype=np.int64)
    N, m, p = Vs.shape
    ar = np.arange(N)
    mid = 0.5 * (Vs[ar, ij[:, 0]] + Vs[ar, ij[:, 1]])          # (N, p)
    if p == 1:
        w = np.ones((N, 1))
    else:
        # Rows of each simplex not on the split edge, in stable order:
        # the face spanning set whose nullspace is the split normal.
        idx = np.arange(p + 1)
        keep = ((idx[None, :] != ij[:, :1])
                & (idx[None, :] != ij[:, 1:2]))                # (N, p+1)
        rows = np.argsort(~keep, axis=1, kind="stable")[:, :p - 1]
        others = np.take_along_axis(Vs, rows[:, :, None], axis=1)
        _, _, vt = np.linalg.svd(others - mid[:, None, :])
        w = vt[:, -1, :]                                       # (N, p)
    c = np.einsum("np,np->n", w, mid)
    flip = np.einsum("np,np->n", w, Vs[ar, ij[:, 0]]) > c
    w[flip] *= -1.0
    c[flip] *= -1.0
    nrm = np.linalg.norm(w, axis=1)
    return w / nrm[:, None], c / nrm


def vertex_key(v: np.ndarray, decimals: int = 9) -> bytes:
    """Hashable key for a vertex, for the solve cache.

    Bisection midpoints are shared by siblings and by neighbouring
    simplices; caching per-vertex oracle solutions reproduces the
    reference's work complexity (SURVEY.md section 8 layer 3, "vertex-solve
    caching").  Rounding makes keys stable under the exact-midpoint
    arithmetic used here (midpoints are computed identically everywhere).
    """
    return np.round(np.asarray(v, dtype=np.float64), decimals).tobytes()


def vertex_keys(V: np.ndarray, decimals: int = 9) -> list[bytes]:
    """Per-row vertex_key for an (m, p) vertex matrix.

    Byte-identical to [vertex_key(v) for v in V] (np.round is
    elementwise), in ONE rounding pass: per-vertex rounding was the
    single largest host cost in cluster-scale step profiles (~350 k
    np.round calls per dozen steps at the 800 k-region satellite)."""
    R = np.round(np.asarray(V, dtype=np.float64), decimals)
    return [R[i].tobytes() for i in range(R.shape[0])]
