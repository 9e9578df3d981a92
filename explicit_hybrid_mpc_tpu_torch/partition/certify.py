"""Simplex-wide eps-suboptimality and feasibility certificates.

The certificate decides, for a leaf-candidate simplex R = conv{v_0..v_p} and
a candidate commutation delta, whether the barycentric-interpolated control
law with commutation delta is certified feasible and eps-suboptimal over ALL
of R (SURVEY.md section 1 step 2b, [P]; section 8 "hard parts" item 5).

Mathematical basis (each bound is sound; derivations in docs/certificates.md):

U  (upper bound on the implemented cost):  V_delta is convex in theta, so the
   affine interpolation of vertex values over-approximates it on R:
   V_delta(theta) <= U(theta) := sum_i lam_i(theta) V_delta(v_i).

L  (lower bound on the optimal cost V* = min_delta' V_delta'):
   for every commutation delta' and any vertex v_i where the fixed-delta'
   QP converged, the envelope-theorem tangent
       l_{delta',i}(theta) = V_delta'(v_i) + g_delta'(v_i)'(theta - v_i)
   under-approximates the convex V_delta' GLOBALLY (off its feasible set
   V_delta' = +inf, so the bound holds trivially).  Hence
       V*(theta) >= min_delta' max_i l_{delta',i}(theta).
   For a delta' converged at NO vertex, the engine asks the oracle for the
   certified lower bound on min_{theta in R} V_delta'(theta) (an elastic
   joint QP over
   (z, theta)), a constant valid lower bound on R -- or a proof that delta'
   is infeasible on all of R, excluding it from the min.

Gap (all evaluated at vertices only -- affine functions on a simplex attain
their extrema at vertices):
   max_R [U - L] <= max_delta' min_i max_j [U(v_j) - l_{delta',i}(v_j)].
The certificate passes when this gap is <= eps_a (absolute) or
<= eps_r * min_j |V*(v_j)| (relative), matching the reference's eps_a/eps_r
pair (SURVEY.md section 1, [NS] "absolute (eps_a) or relative (eps_r)
suboptimality test").

Feasibility over R is inherited from the vertices: the feasible set of the
fixed-delta problem is convex in theta (projection of a polyhedron), so
delta feasible at every vertex implies feasible on conv{v_i} = R.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SimplexVertexData:
    """Oracle results at the p+1 vertices of one simplex (host numpy)."""

    verts: np.ndarray   # (p+1, p)
    V: np.ndarray       # (p+1, nd) +inf where not converged
    conv: np.ndarray    # (p+1, nd) bool
    grad: np.ndarray    # (p+1, nd, p)
    u0: np.ndarray      # (p+1, nd, n_u)
    z: np.ndarray       # (p+1, nd, nz)
    Vstar: np.ndarray   # (p+1,)
    dstar: np.ndarray   # (p+1,)


@dataclasses.dataclass
class CertificateResult:
    status: str                 # 'certified' | 'split' | 'infeasible' | 'pending'
    delta_idx: int = -1
    vertex_inputs: np.ndarray | None = None
    vertex_costs: np.ndarray | None = None
    vertex_z: np.ndarray | None = None
    gap: float = np.inf
    # Commutations needing a stage-2 simplex-min solve (converged nowhere).
    pending_deltas: np.ndarray | None = None
    # True on a 'split' caused by MIXED vertex feasibility (the hybrid
    # feasible set's boundary crosses R): no whole-simplex certificate can
    # ever close such a cell, so the frontier may instead close it as a
    # semi-explicit boundary leaf (cfg.semi_explicit_boundary_depth).
    mixed_feasibility: bool = False
    # Internal: stage-1 partial gaps, completed by stage 2.
    _stage1_gap: np.ndarray | None = None
    _candidates: np.ndarray | None = None


def cell_snapshot(sd: SimplexVertexData) -> dict[str, np.ndarray]:
    """Canonical array packaging of one simplex's certification inputs
    -- THE serialization repro bundles use for cell-level anomalies
    (uncertified depth-capped leaves, obs/recorder.py).  Everything the
    certificate read is here: replaying the vertex solves against
    ``cell_verts`` and re-running the stage-1 certificate over this
    snapshot reproduces the certify/split decision exactly."""
    return {"cell_verts": np.asarray(sd.verts),
            "obs_V": np.asarray(sd.V),
            "obs_conv": np.asarray(sd.conv, dtype=bool),
            "obs_grad": np.asarray(sd.grad),
            "obs_Vstar": np.asarray(sd.Vstar),
            "obs_dstar": np.asarray(sd.dstar, dtype=np.int64)}


def candidate_set(sd: SimplexVertexData) -> np.ndarray:
    """Vertex-optimal commutations, deterministic ascending order
    (SURVEY.md section 4.1: candidate delta from vertex solutions)."""
    ds = sd.dstar[sd.dstar >= 0]
    return np.unique(ds)


def best_feasible_candidate(sd: SimplexVertexData) -> int | None:
    """Lowest-total-vertex-cost commutation among vertex-optimal candidates
    that converged at EVERY vertex; None if there is none.  Deterministic
    (ascending candidate order, argmin takes the first minimum) -- shared by
    the feasibility-variant leaf rule and the depth-cap best-effort leaf so
    backend parity cannot diverge between them."""
    cands = candidate_set(sd)
    cands = cands[np.all(sd.conv[:, cands], axis=0)]
    if cands.size == 0:
        return None
    tot = np.array([np.sum(sd.V[:, int(d)]) for d in cands])
    return int(cands[int(np.argmin(tot))])


def boundary_candidate(sd: SimplexVertexData) -> int | None:
    """Commutation stored by a semi-explicit BOUNDARY leaf (mixed vertex
    feasibility; round-3 verdict item 4).

    Chooses the commutation converged at the MOST vertices (maximizing
    the convex-hull sub-region where offline vertex feasibility +
    convexity already guarantee the online fixed-delta QP succeeds);
    ties break to the lowest mean cost over converged vertices, then the
    lowest index.  Deterministic, so backend/tree parity is preserved.
    None when no commutation converged at any vertex.
    """
    n_conv = sd.conv.sum(axis=0)
    if n_conv.max(initial=0) == 0:
        return None
    cand = np.where(n_conv == n_conv.max())[0]
    means = np.array([float(np.mean(sd.V[sd.conv[:, d], d]))
                      for d in cand])
    return int(cand[int(np.argmin(means))])


def boundary_payload(sd: SimplexVertexData, d: int
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Finite leaf payload (u0, V, z) for a semi-explicit boundary leaf.

    Vertices where commutation d did not converge hold +inf costs and
    garbage inputs; they are filled deterministically (inputs/z with the
    mean over converged vertices, costs with the converged max) so the
    exported table stays finite.  The fills only feed the online FALLBACK
    interpolation -- the boundary leaf's primary online path is the
    fixed-delta QP (sim.SemiExplicitController), which never reads them
    when it converges.
    """
    conv = sd.conv[:, d]
    u = sd.u0[:, d, :].copy()
    z = sd.z[:, d, :].copy()
    V = sd.V[:, d].copy()
    u[~conv] = u[conv].mean(axis=0)
    z[~conv] = z[conv].mean(axis=0)
    V[~conv] = V[conv].max()
    return u, V, z


def tangent_gaps(sd: SimplexVertexData, U: np.ndarray) -> np.ndarray:
    """gap_{delta'} = min_i max_j [U_j - l_{delta',i}(v_j)] for all delta'.

    Returns (nd,); NaN where delta' converged at no vertex (stage 2 needed).
    U is (p+1,) -- the candidate's vertex costs.
    """
    # tangents[i, j, d] = V[i, d] + grad[i, d] . (v_j - v_i)
    dv = sd.verts[None, :, :] - sd.verts[:, None, :]      # (p+1, p+1, p)
    # Unconverged cells hold V=+inf with garbage grad (possibly inf/nan,
    # e.g. masked-skip fabrications): inf arithmetic raises 'invalid
    # value' warnings, yet every such lane is overwritten by the conv
    # mask below.
    with np.errstate(invalid="ignore"):
        t = sd.V[:, None, :] + np.einsum("ijk,idk->ijd", dv, sd.grad)
        slack = U[None, :, None] - t                      # (i, j, d)
        worst = np.max(slack, axis=1)                     # (i, d) max over j
    worst = np.where(sd.conv, worst, np.inf)              # only valid tangents
    gap = np.min(worst, axis=0)                           # (d,) min over i
    none_conv = ~np.any(sd.conv, axis=0)
    return np.where(none_conv, np.nan, gap)


def _passes(gap: float, Vstar_verts: np.ndarray, eps_a: float,
            eps_r: float) -> bool:
    if eps_a > 0 and gap <= eps_a:
        return True
    if eps_r > 0 and gap <= eps_r * float(np.min(np.abs(Vstar_verts))):
        return True
    return False


def cert_margin(gap: float, Vstar_verts: np.ndarray, eps_a: float,
                eps_r: float) -> float | None:
    """Certificate slack: effective eps budget minus the certified gap
    (>= 0 whenever ``_passes`` held).  The budget is the LARGEST
    enabled bound -- passing under either eps_a or eps_r means the
    slack against the looser one is what a precision change must not
    consume.  None when no budget is enabled or the gap is not finite
    (a -inf stage-1 gap means the candidate dominates outright; there
    is no meaningful scalar slack to histogram).

    Feeds ``build.cert_margin`` (frontier.py) -- the evidence base for
    ROADMAP item 4's "f32 iterative refinement suffices": if the p01
    margin dwarfs the f32 round-off on V, a lower-precision refine
    cannot flip a certificate."""
    budget = -np.inf
    if eps_a > 0:
        budget = eps_a
    if eps_r > 0:
        budget = max(budget,
                     eps_r * float(np.min(np.abs(Vstar_verts))))
    margin = budget - gap
    if not np.isfinite(margin):
        return None
    return float(margin)


def certify_suboptimal_stage1(sd: SimplexVertexData, eps_a: float,
                              eps_r: float) -> CertificateResult:
    """Vertex-data-only certification attempt.

    Outcomes: 'infeasible' (no commutation valid at any vertex),
    'certified', 'split' (a candidate exists but its gap from complete
    stage-1 information already exceeds eps), or 'pending' (gap depends on
    commutations with no converged vertex -> stage-2 simplex-min solves).
    """
    feas_vertex = sd.dstar >= 0
    if not np.any(feas_vertex):
        return CertificateResult(status="infeasible")
    if not np.all(feas_vertex):
        # Mixed feasibility: the feasible/infeasible boundary crosses R.
        return CertificateResult(status="split", mixed_feasibility=True)

    cands = candidate_set(sd)
    # Candidates must be feasible (converged) at every vertex to define U.
    cands = cands[np.all(sd.conv[:, cands], axis=0)]
    if cands.size == 0:
        return CertificateResult(status="split")

    nd = sd.V.shape[1]
    pending = np.zeros(nd, dtype=bool)
    best = None  # (gap, delta, U)
    stage1 = np.full((len(cands), nd), np.nan)
    for ci, d in enumerate(cands):
        U = sd.V[:, int(d)]
        gaps = tangent_gaps(sd, U)
        stage1[ci] = gaps
        nan = np.isnan(gaps)
        pending |= nan
        g = np.max(np.where(nan, -np.inf, gaps))
        if not np.any(nan):
            if best is None or g < best[0]:
                best = (float(g), int(d), U)
    if not np.any(pending):
        if best is not None and _passes(best[0], sd.Vstar, eps_a, eps_r):
            d = best[1]
            return CertificateResult(
                status="certified", delta_idx=d,
                vertex_inputs=sd.u0[:, d, :], vertex_costs=sd.V[:, d],
                vertex_z=sd.z[:, d, :], gap=best[0])
        return CertificateResult(status="split",
                                 gap=best[0] if best else np.inf)
    return CertificateResult(status="pending",
                             pending_deltas=np.where(pending)[0],
                             _stage1_gap=stage1, _candidates=cands)


def certify_stage1_batch(verts: np.ndarray, V: np.ndarray,
                         conv: np.ndarray, grad: np.ndarray,
                         Vstar: np.ndarray, dstar: np.ndarray,
                         eps_a: float, eps_r: float
                         ) -> list[CertificateResult]:
    """Vectorized certify_suboptimal_stage1 over a batch of B simplices.

    Shapes: verts (B, m, p), V/conv (B, m, nd), grad (B, m, nd, p),
    Vstar/dstar (B, m).  Decision-identical to the scalar function node
    by node (tests/test_partition.py asserts it on random batches and
    end-to-end); it exists because the scalar path's per-node Python
    loops (a tangent einsum per (node, candidate)) dominated host-side
    certification time in steady-state profiles.

    Memory note: the slack tensor is (B, C, m, m, nd) where C is the
    batch's max candidate count -- candidates are the few vertex-optimal
    commutations (C << nd), which keeps the tensor a few MB at the
    shipping batch sizes rather than the (B, nd, m, m, nd) a dense
    formulation would need.
    """
    B, m, nd = V.shape
    results: list[CertificateResult | None] = [None] * B
    feas_vertex = dstar >= 0                          # (B, m)
    feas_any = feas_vertex.any(axis=1)
    feas_all = feas_vertex.all(axis=1)
    for b in np.where(~feas_any)[0]:
        results[b] = CertificateResult(status="infeasible")
    for b in np.where(feas_any & ~feas_all)[0]:
        results[b] = CertificateResult(status="split",
                                       mixed_feasibility=True)
    todo = np.where(feas_all)[0]
    if todo.size == 0:
        return results

    # Candidate sets: vertex-optimal commutations converged at EVERY
    # vertex, in ascending order per node (matches candidate_set +
    # the conv filter in the scalar path).
    dmask = np.zeros((B, nd), dtype=bool)
    np.put_along_axis(dmask, np.maximum(dstar, 0),
                      feas_vertex, axis=1)            # d in dstar set
    cand_mask = dmask & conv.all(axis=1)              # (B, nd)
    n_c = cand_mask[todo].sum(axis=1)
    for b in todo[n_c == 0]:
        results[b] = CertificateResult(status="split")
    todo = todo[n_c > 0]
    if todo.size == 0:
        return results
    C = int(cand_mask[todo].sum(axis=1).max())
    # Padded candidate index list (B', C), -1 = empty slot.
    cand_idx = np.full((todo.size, C), -1, dtype=np.int64)
    for r, b in enumerate(todo):                      # cheap: B' rows
        ds = np.where(cand_mask[b])[0]
        cand_idx[r, :ds.size] = ds
    slot = cand_idx >= 0                              # (B', C)
    safe_idx = np.maximum(cand_idx, 0)

    vb = verts[todo]                                  # (B', m, p)
    Vb, convb, gradb = V[todo], conv[todo], grad[todo]
    # tangents[b, i, j, d] = V[b,i,d] + grad[b,i,d,:].(v_j - v_i)
    dv = vb[:, None, :, :] - vb[:, :, None, :]        # (B', i, j, p)
    with np.errstate(invalid="ignore"):
        t = Vb[:, :, None, :] + np.einsum("bijk,bidk->bijd", dv, gradb)
        # U[b, c, j] = V[b, j, cand c]
        U = np.take_along_axis(
            Vb, safe_idx[:, None, :], axis=2).transpose(0, 2, 1)
        slack = U[:, :, None, :, None] - t[:, None, :, :, :]
        worst = np.max(slack, axis=3)                 # (B', C, i, d)
    worst = np.where(convb[:, None, :, :], worst, np.inf)
    gaps = np.min(worst, axis=2)                      # (B', C, d)
    none_conv = ~convb.any(axis=1)                    # (B', d)
    gaps = np.where(none_conv[:, None, :], np.nan, gaps)

    pending = none_conv.any(axis=1)                   # (B',)
    # Nodes with pending deltas: hand stage-2 the per-candidate partial
    # gaps exactly as the scalar path does.
    for r in np.where(pending)[0]:
        b = todo[r]
        cands = cand_idx[r][slot[r]]
        results[b] = CertificateResult(
            status="pending", pending_deltas=np.where(none_conv[r])[0],
            _stage1_gap=gaps[r][slot[r]], _candidates=cands)
    # Complete nodes: best candidate by max-over-deltas gap (first
    # minimum among slots = ascending candidate order, matching the
    # scalar path's strict-< update).
    done = np.where(~pending)[0]
    if done.size:
        g = np.max(gaps[done], axis=2)                # (D, C)
        g = np.where(slot[done], g, np.inf)
        ci = np.argmin(g, axis=1)
        gbest = g[np.arange(done.size), ci]
        for k, r in enumerate(done):
            b = todo[r]
            gk = float(gbest[k])
            d = int(cand_idx[r, ci[k]])
            if _passes(gk, Vstar[b], eps_a, eps_r):
                results[b] = CertificateResult(
                    status="certified", delta_idx=d,
                    vertex_inputs=None, vertex_costs=V[b, :, d],
                    vertex_z=None, gap=gk)
            else:
                results[b] = CertificateResult(status="split", gap=gk)
    return results


def certify_suboptimal_stage2(sd: SimplexVertexData, res: CertificateResult,
                              Vmin: dict[int, float], eps_a: float,
                              eps_r: float) -> CertificateResult:
    """Complete a 'pending' certification with stage-2 simplex minima.

    Vmin maps pending delta' -> certified lower bound on V_delta' over R
    (exact when the elastic slack is zero; +inf if delta'
    infeasible on all of R; -inf if the joint solve failed, blocking
    certification conservatively).
    """
    best = None
    for ci, d in enumerate(res._candidates):
        gaps = res._stage1_gap[ci]
        U = sd.V[:, int(d)]
        g = -np.inf
        for dp in range(gaps.size):
            if np.isnan(gaps[dp]):
                lo = Vmin[dp]
                gd = -np.inf if lo == np.inf else float(np.max(U) - lo)
            else:
                gd = gaps[dp]
            g = max(g, gd)
        if best is None or g < best[0]:
            best = (float(g), int(d))
    if best is not None and _passes(best[0], sd.Vstar, eps_a, eps_r):
        d = best[1]
        return CertificateResult(
            status="certified", delta_idx=d, vertex_inputs=sd.u0[:, d, :],
            vertex_costs=sd.V[:, d], vertex_z=sd.z[:, d, :], gap=best[0])
    return CertificateResult(status="split", gap=best[0] if best else np.inf)


def recertify_stored_stage1(sd: SimplexVertexData, delta_idx: int,
                            eps_a: float, eps_r: float
                            ) -> CertificateResult:
    """Re-certification of a leaf's ALREADY-STORED commutation against
    fresh oracle data (the warm-rebuild keep-check, partition/rebuild).

    Unlike certify_suboptimal_stage1 this fixes the candidate to the
    leaf's stored ``delta_idx`` -- the question is not "can some law
    certify here" but "does the law this leaf already serves still
    carry its eps-certificate".  The bound mathematics is identical
    (same U from the stored delta's vertex costs, same tangent lower
    envelope over every commutation), so a pass is exactly as sound as
    the cold build's certificate; the stored delta need not be
    vertex-optimal under the revised problem for the pass to be valid
    (any delta converged at every vertex defines a valid U).

    Outcomes: 'certified' (keep the leaf untouched), 'split'
    (invalidated -- re-open into the frontier), or 'pending' with
    ``pending_deltas`` (stage-2 simplex bounds needed; complete via
    certify_suboptimal_stage2, which accepts this result's
    single-candidate ``_candidates``/``_stage1_gap`` directly)."""
    d = int(delta_idx)
    if d < 0 or not bool(np.all(sd.conv[:, d])):
        # Stored law no longer converges at every vertex: U is not a
        # valid upper bound anywhere on R -- certificate gone.
        return CertificateResult(status="split")
    U = sd.V[:, d]
    gaps = tangent_gaps(sd, U)
    nan = np.isnan(gaps)
    if np.any(nan):
        return CertificateResult(
            status="pending", pending_deltas=np.where(nan)[0],
            _stage1_gap=gaps[None], _candidates=np.asarray([d]))
    g = float(np.max(gaps))
    if _passes(g, sd.Vstar, eps_a, eps_r):
        return CertificateResult(
            status="certified", delta_idx=d, vertex_inputs=sd.u0[:, d, :],
            vertex_costs=sd.V[:, d], vertex_z=sd.z[:, d, :], gap=g)
    return CertificateResult(status="split", gap=g)


def recertify_stored_stage2(stage1_gaps: np.ndarray, U_max: float,
                            Vstar: np.ndarray, Vmin: dict,
                            eps_a: float, eps_r: float
                            ) -> tuple[bool, float]:
    """Complete a recertify_stored_stage1 'pending' verdict with
    stage-2 lower bounds; returns (passes, gap).

    Same bound algebra as certify_suboptimal_stage2 restricted to the
    single stored candidate: a NaN stage-1 gap (delta' converged at no
    vertex) is replaced by ``U_max - Vmin[dp]`` (+inf Vmin = certified
    exclusion contributes -inf; -inf Vmin = stalled solve contributes
    +inf, conservatively blocking the keep).  ``Vmin`` entries may be
    ANCESTOR-simplex bounds (warm rebuild lifts stage-2 solves up the
    tree): a lower bound on a superset is a lower bound on the leaf,
    so a PASS is sound with loose bounds -- a FAIL is inconclusive and
    the caller re-solves exactly, mirroring the frontier's round A/B."""
    g = -np.inf
    for dp in range(stage1_gaps.size):
        if np.isnan(stage1_gaps[dp]):
            lo = Vmin[dp]
            gd = -np.inf if lo == np.inf else float(U_max - lo)
        else:
            gd = float(stage1_gaps[dp])
        g = max(g, gd)
    return _passes(g, Vstar, eps_a, eps_r), g


def recertify_infeasible(sd: SimplexVertexData) -> str:
    """Vertex-level re-check of a closed INFEASIBLE leaf (warm rebuild):
    'split' when any vertex became feasible under the revised problem
    (the emptiness proof is void -- re-open), 'pending' otherwise (all
    vertices still infeasible; the whole-simplex Farkas certificates
    must be re-established per commutation, exactly as the cold build's
    infeasible path does)."""
    return "pending" if not np.any(sd.dstar >= 0) else "split"


def certify_feasible(sd: SimplexVertexData) -> CertificateResult:
    """Feasibility-only ('feasible'/ECC) certification: a commutation
    feasible at every vertex is feasible on all of R (convexity); the leaf
    stores it and the online stage solves a small fixed-delta QP
    (semi-explicit, SURVEY.md section 1 variant 'ecc' [P])."""
    feas_vertex = sd.dstar >= 0
    if not np.any(feas_vertex):
        return CertificateResult(status="infeasible")
    if not np.all(feas_vertex):
        return CertificateResult(status="split", mixed_feasibility=True)
    d = best_feasible_candidate(sd)
    if d is None:
        return CertificateResult(status="split")
    return CertificateResult(status="certified", delta_idx=d,
                             vertex_inputs=sd.u0[:, d, :],
                             vertex_costs=sd.V[:, d],
                             vertex_z=sd.z[:, d, :], gap=0.0)
