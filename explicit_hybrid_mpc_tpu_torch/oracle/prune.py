"""Constraint-row / slack-variable pruning with KKT-verified fallback
(torch), as in the JAX package's oracle/prune.py.

The per-QP cost of a row-heavy problem (the quadrotor's nz=60, nc=360)
is dominated by the A'DA Schur product, O(nc * nz^2) an iteration, and
most rows never matter on a sub-box: dropping provably irrelevant rows
(and the soft-constraint slack variables only those rows touch) cuts
the dominant term several-fold.  The reduced programs are the same IPM
legs as the full ones -- on a CUDA device each is one launch of the
hand-written kernel (csrc/ipm_leg.cu) at the reduced shape.

Soundness is NOT sampled -- it is verified per instance:

1. Offline (construction): solve a deterministic sample of full QPs on
   the parameter box; keep rows whose minimum slack over the sample is
   below `margin` (plus every row of commutations with no converged
   sample).  Drop a VARIABLE only when (a) every row touching it was
   dropped, (b) its Hessian column is separable (diagonal-only), and
   (c) its linear/parametric cost terms and u_map column are zero --
   then z_j = 0 is stationary whenever its rows carry zero multipliers.
2. Online (every solve): the reduced solution, scattered back to full
   coordinates with dropped vars at 0, is checked against EVERY dropped
   row.  If it satisfies them, the point (z_red, lam_kept, lam_drop=0)
   satisfies the FULL problem's KKT system exactly -- stationarity by
   (a)-(c), complementarity because dropped rows carry zero duals --
   so it IS the full optimum (convexity), same values, gradients, and
   first moves.  Violations (and unconverged instances) fall back to
   the full-problem program for those (point, commutation) pairs.

The pruned path covers the POINT class (vertex grids + sparse pairs)
and the elastic simplex-min bound; phase-1 feasibility and the Farkas
certificates keep the full row set -- their soundness arguments are
row-global.
"""

from __future__ import annotations

import time

import numpy as np

from explicit_hybrid_mpc_tpu_torch.oracle import ipm
from explicit_hybrid_mpc_tpu_torch.oracle.oracle import (
    Oracle, VertexSolution, _bmv, _np, _solve_pairs, _solve_points_grid,
    _solve_simplex_min, to_device)
from explicit_hybrid_mpc_tpu_torch.problems import base

_INF = np.inf


def activity_masks(oracle: Oracle, problem, n_samples: int = 48,
                   margin: float = 0.02, seed: int = 0) -> np.ndarray:
    """(nd, nc) bool: rows to KEEP, from a deterministic sampled solve.

    margin is relative to each row's own scale (1 + |w|): a row whose
    slack never came within `margin` of active across the sample is a
    candidate for dropping (the per-instance verification makes any
    sampling miss a fallback re-solve, never an error).

    The sampling always runs a FULL-f64 schedule regardless of the
    caller's precision: an aggressive mixed schedule can leave most
    sample solves unconverged, and a sampler with no converged data
    keeps every row -- silently turning pruning into a no-op.
    """
    can = problem.canonical
    rng = np.random.default_rng(seed)
    pts = rng.uniform(problem.theta_lb, problem.theta_ub,
                      size=(n_samples, can.n_theta))
    sampler = oracle
    if oracle.precision != "f64" or oracle.point_schedule is not None:
        sampler = Oracle(problem, backend=oracle.backend, precision="f64")
    sol = sampler.solve_vertices(pts)
    keep = np.zeros((can.n_delta, can.nc), dtype=bool)
    for d in range(can.n_delta):
        conv = sol.conv[:, d]
        if not conv.any():
            keep[d] = True  # no data: keep everything (conservative)
            continue
        z = sol.z[conv, d]                       # (S', nz)
        th = pts[conv]
        slack = (can.w[d][None, :] + th @ can.S[d].T
                 - z @ can.G[d].T)               # (S', nc)
        rel = slack / (1.0 + np.abs(can.w[d]))[None, :]
        keep[d] = rel.min(axis=0) < margin
    return keep


def droppable_vars(can: base.CanonicalMPQP, row_keep: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray]:
    """(var_keep (nd, nz), row_keep adjusted): vars to KEEP, and the row
    mask with dropped vars' pure sign rows removed.

    A var is dropped only under the exactness conditions in the module
    docstring.  A PURE SIGN ROW of var j (single nonzero entry on j,
    w = 0, no theta dependence -- the nonneg row base.soften appends per
    slack) does not block dropping even though it is ACTIVE at s = 0:
    stationarity at z_j = 0 forces its multiplier to 0 (f_j = 0 and no
    other kept row touches j), and a zero-dual active row drops from the
    KKT system exactly; at z_j = 0 it is trivially satisfied, so the
    per-instance verification of dropped rows never flags it.
    """
    var_keep = np.ones((can.n_delta, can.nz), dtype=bool)
    row_keep = row_keep.copy()
    for d in range(can.n_delta):
        G = can.G[d]
        nonzero = np.abs(G) > 0
        pure_sign = ((nonzero.sum(axis=1) == 1) & (can.w[d] == 0)
                     & (np.abs(can.S[d]).max(axis=1) == 0))
        # Kept rows touching var j, EXCLUDING j's own pure sign rows.
        blocking = nonzero & row_keep[d][:, None] & ~pure_sign[:, None]
        touched = blocking.any(axis=0)
        H = can.H[d]
        offdiag = np.abs(H - np.diag(np.diag(H)))
        separable = offdiag.max(axis=0) == 0
        cost_free = (np.abs(can.f[d]) == 0) & (np.abs(can.F[d]).max(axis=1)
                                               == 0)
        in_umap = np.abs(can.u_map[d]).max(axis=0) > 0
        drop = (~touched) & separable & cost_free & (~in_umap)
        var_keep[d] = ~drop
        # Remove the dropped vars' sign rows from the kept set too.
        sign_of_dropped = pure_sign & (nonzero & drop[None, :]).any(axis=1)
        row_keep[d] &= ~sign_of_dropped
    return var_keep, row_keep


def reduced_problem(can: base.CanonicalMPQP, row_keep: np.ndarray,
                    var_keep: np.ndarray):
    """(reduced CanonicalMPQP, var_idx, (Gd, wd, Sd)): the kept rows and
    vars of every commutation stacked to one padded width, the scatter
    map of its vars into full coordinates, and the dropped rows.

    Padding rows are 0 z <= 1 (inactive), padding vars get H diag 1 and
    zero cost (they park at 0); padding dropped rows are always
    satisfied.  Reduced var j of delta d lands at var_idx[d, j] in a
    width-(nz+1) buffer whose last column is a padding trash slot."""
    nd = can.n_delta
    ncr = max(8, int(row_keep.sum(axis=1).max()))
    nzr = max(4, int(var_keep.sum(axis=1).max()))
    ncd = max(1, int((~row_keep).sum(axis=1).max()))
    Hn = np.tile(np.eye(nzr)[None], (nd, 1, 1))
    fn = np.zeros((nd, nzr))
    Fn = np.zeros((nd, nzr, can.n_theta))
    Gn = np.zeros((nd, ncr, nzr))
    wn = np.ones((nd, ncr))
    Sn = np.zeros((nd, ncr, can.n_theta))
    un = np.zeros((nd, can.u_map.shape[1], nzr))
    Gd = np.zeros((nd, ncd, can.nz))
    wd = np.ones((nd, ncd))
    Sd = np.zeros((nd, ncd, can.n_theta))
    var_idx = np.full((nd, nzr), can.nz, dtype=np.int64)
    for d in range(nd):
        vi = np.where(var_keep[d])[0]
        ri = np.where(row_keep[d])[0]
        di = np.where(~row_keep[d])[0]
        var_idx[d, :vi.size] = vi
        Hn[d, :vi.size, :vi.size] = can.H[d][np.ix_(vi, vi)]
        fn[d, :vi.size] = can.f[d][vi]
        Fn[d, :vi.size] = can.F[d][vi]
        Gn[d, :ri.size, :vi.size] = can.G[d][np.ix_(ri, vi)]
        wn[d, :ri.size] = can.w[d][ri]
        Sn[d, :ri.size] = can.S[d][ri]
        un[d, :, :vi.size] = can.u_map[d][:, vi]
        Gd[d, :di.size] = can.G[d][di]
        wd[d, :di.size] = can.w[d][di]
        Sd[d, :di.size] = can.S[d][di]
    red = base.CanonicalMPQP(
        H=Hn, f=fn, F=Fn, G=Gn, w=wn, S=Sn,
        Y=np.asarray(can.Y), pvec=np.asarray(can.pvec),
        cconst=np.asarray(can.cconst), u_map=un,
        u_theta=np.asarray(can.u_theta),
        u_const=np.asarray(can.u_const),
        deltas=np.asarray(can.deltas))
    return red, var_idx, (Gd, wd, Sd)


class PrunedOracle(Oracle):
    """Oracle whose point-class and elastic simplex-min programs run on
    the pruned problem with per-instance verified fallback to the full
    problem.

    Restricted to the batched single-device backends ('cuda', 'cpu'):
    the serial baseline's contract is one honest full QP at a time, and
    a mesh would shard the dense full problem.
    """

    def __init__(self, problem, n_samples: int = 48, margin: float = 0.02,
                 **kw):
        if kw.get("backend") == "serial" or kw.get("mesh") is not None:
            raise ValueError("PrunedOracle supports batched single-device "
                             "backends only")
        # The reduced program set has no two-phase cohort or warm-start
        # variants (pruning already adapts per-instance work through the
        # verified fallback); forcing the knobs off keeps the pruned
        # paths single-phase and the frontier from offering warm data
        # this oracle cannot consume.
        kw["two_phase"] = False
        kw["warm_start"] = False
        # None until the masks exist: the construction-time sampling
        # pass (activity_masks) runs the FULL problem's base programs.
        self._red_dev = None
        super().__init__(problem, **kw)
        can = self.can
        row_keep = activity_masks(self, problem, n_samples=n_samples,
                                  margin=margin)
        var_keep, row_keep = droppable_vars(can, row_keep)
        self.row_keep, self.var_keep = row_keep, var_keep
        self.n_prune_fallbacks = 0
        # Reset the counters the sampling pass incremented: construction
        # cost must not pollute build statistics.
        self.n_solves = self.n_point_solves = 0
        self.n_rescue_solves = 0
        red, self._var_idx, (self._Gd, self._wd, self._Sd) = \
            reduced_problem(can, row_keep, var_keep)
        self._red_dev = to_device(red, self.device)

    @property
    def reduced_shape(self) -> tuple[int, int]:
        """(nzr, ncr): the padded width of the reduced point QPs."""
        return int(self._red_dev.H.shape[1]), int(self._red_dev.G.shape[1])

    # -- the reduced programs (the oracle's IPM leg at the reduced shape) --

    def _solve_pairs_red(self, th, ds):  # tpulint: device-region
        return _solve_pairs(self._red_dev, th, ds, self.point_n_iter,
                            self.point_n_f32)[:6]

    def _simplex_min_red(self, Ms, ds):  # tpulint: device-region
        # Pruned elastic simplex-min: same joint program on the reduced
        # rows/vars.  Its bound is sound UNCONDITIONALLY (dropping rows
        # relaxes the min), and exact whenever the witness satisfies the
        # dropped rows (the verified case); violators re-solve full.
        return _solve_simplex_min(self._red_dev, Ms, ds, self.n_iter,
                                  self.n_f32)[:5]

    def _point_feas_red(self, th, ds):  # tpulint: device-region
        # Reduced phase-1, the gate behind _stalled_need_resolve: full
        # schedule for the same reason as the base feasibility (phase-1
        # returns no convergence flag, so a schedule miss has no rescue
        # signal and errs in the unsound direction).
        red = self._red_dev
        return ipm.phase1(red.G[ds], red.w[ds] + _bmv(red.S[ds], th),
                          n_iter=self.n_iter, n_f32=self.n_f32)

    def warm_pair_bucket(self, thetas: np.ndarray, ds: np.ndarray) -> None:
        """Launch the reduced pair program at this bucket too: the base
        method covers only the full-problem programs (the verified
        fallback path), while the hot path runs reduced."""
        super().warm_pair_bucket(thetas, ds)
        if self._red_dev is not None:
            thetas = np.atleast_2d(np.asarray(thetas, dtype=np.float64))
            tj, dj, _Kc = self._pad_pairs(
                thetas, np.asarray(ds, dtype=np.int64), family="pairs_red")
            self._solve_pairs_red(tj, dj)

    def warm_simplex_bucket(self, Ms: np.ndarray, ds: np.ndarray) -> None:
        super().warm_simplex_bucket(Ms, ds)
        if self._red_dev is not None:
            Mj, dj = self._pad_simplex(np.asarray(Ms),
                                       np.asarray(ds, dtype=np.int64),
                                       family="simplex_min_red")
            self._simplex_min_red(Mj, dj)

    # -- helpers -----------------------------------------------------------

    def _scatter_z(self, z_red: np.ndarray, ds: np.ndarray) -> np.ndarray:
        """(..., nzr) reduced primal -> (..., nz) full primal with
        dropped vars at 0.  ds broadcasts over the leading axes."""
        out = np.zeros(z_red.shape[:-1] + (self.can.nz + 1,))
        idx = self._var_idx[ds]                    # (..., nzr)
        np.put_along_axis(out, idx, z_red, axis=-1)
        return out[..., :-1]

    def _dropped_violation(self, thetas: np.ndarray, ds: np.ndarray,
                           z_full: np.ndarray,
                           t_elastic: np.ndarray | None = None
                           ) -> np.ndarray:
        """max RELATIVE dropped-row violation per instance (thetas
        (...,nt), ds int (...,), z_full (..., nz)).

        Relative to each row's own scale (1 + |w|), matching the IPM's
        convergence test: an ABSOLUTE threshold flags solver-tolerance
        noise on large-scale rows as violations and sends many solves
        through the double-solve fallback, erasing the pruning win."""
        Gd, wd, Sd = self._Gd[ds], self._wd[ds], self._Sd[ds]
        lhs = np.einsum("...rn,...n->...r", Gd, z_full)
        rhs = wd + np.einsum("...rt,...t->...r", Sd, thetas)
        if t_elastic is not None:
            rhs = rhs + t_elastic[..., None]
        return ((lhs - rhs) / (1.0 + np.abs(wd))).max(axis=-1)

    # -- overridden point-class paths --------------------------------------

    def dispatch_vertices(self, thetas: np.ndarray):
        if self._red_dev is None:
            # Construction-time sampling pass (activity_masks) runs on
            # the FULL problem through the base paths.
            return super().dispatch_vertices(thetas)
        thetas = np.atleast_2d(np.asarray(thetas, dtype=np.float64))
        P = thetas.shape[0]
        if P == 0:
            return ("empty",)
        cap = self.max_points_per_call
        chunks = []
        for lo in range(0, P, cap):
            chunk = thetas[lo:lo + cap]
            Pc = chunk.shape[0]
            Ppad = min(cap, max(8, 1 << (Pc - 1).bit_length()))
            self._note_shape("grid_red", Ppad)
            pad = np.zeros((Ppad - Pc, thetas.shape[1]))
            out = _solve_points_grid(
                self._red_dev, self._dev(np.concatenate([chunk, pad])),
                self.point_n_iter, self.point_n_f32)[:8]
            chunks.append((out, Pc))
        return ("pruned-chunks-v", thetas, chunks)

    def wait_vertices(self, handle) -> VertexSolution:
        if handle[0] != "pruned-chunks-v":
            return super().wait_vertices(handle)
        t0 = time.perf_counter()
        _, thetas, chunks = handle
        parts = [np.concatenate([_np(out[k])[:Pc] for out, Pc in chunks])
                 for k in range(8)]
        P, nd = parts[0].shape
        all_d = np.broadcast_to(np.arange(nd)[None, :], (P, nd))
        parts[5] = self._scatter_z(parts[5], all_d)    # z -> full width
        n_fb, n_gate = self._verify_or_fallback(thetas, parts)
        self._rescue_grid(thetas, parts)
        # Counters last (base wait_vertices contract): if the transfer,
        # verification, or rescue raised, the frontier reroutes the WHOLE
        # batch to the CPU fallback and folds in its own counts --
        # incrementing before the rescue pass would double-count.
        self.n_prune_fallbacks += n_fb
        self.n_solves += P * nd + n_fb + n_gate
        self.n_point_solves += P * nd + n_fb
        n = P * nd + n_fb
        f32 = n * self.point_n_f32 + n_gate * self.n_f32
        f64 = n * self.point_n_iter + n_gate * self.n_iter
        self._iters(f32, f64, f64)
        self._obs_batch("point", n, time.perf_counter() - t0,
                        f32 + f64, f64)
        self._obs_prune(n_fb, n_gate)
        return VertexSolution(*self._finalize(parts))

    def _obs_prune(self, n_fb: int, n_gate: int) -> None:
        """Pruning-engine observables: verified-fallback re-solves (the
        cost of each sampling miss) and phase-1 gate solves for stalled
        reduced cells."""
        if not self.obs.enabled:
            return
        self.obs.metrics.counter("oracle.prune_fallbacks").inc(n_fb)
        self.obs.metrics.counter("oracle.prune_gate_solves").inc(n_gate)

    def _stalled_need_resolve(self, thetas: np.ndarray, ds: np.ndarray
                              ) -> np.ndarray:
        """(K,) bool for stalled (~feasible & ~converged) reduced cells:
        True = the cell needs a full-problem re-solve.

        Dropping rows relaxes the constraint set, and kept rows touch no
        dropped variable, so reduced-INFEASIBLE implies full-infeasible;
        but a stalled reduced solve proves nothing by itself -- a
        reduced-path stall (different Schur conditioning) on a cell the
        full path solves would silently flip it to V=inf and break tree
        parity with an unpruned build.  The gate runs the reduced
        phase-1 (a strictly feasible QP -- it does not stall): a
        decisively positive minimal violation certifies the cell
        infeasible with no re-solve; anything near-feasible (<= 1e-3,
        loose on purpose: the unsound direction is claiming infeasible)
        re-solves on the full problem."""
        K = thetas.shape[0]
        need = np.empty(K, dtype=bool)
        cap = self.max_pairs_per_call
        for lo in range(0, K, cap):
            # Same "pairs_red" ledger family as the reduced pair solve.
            tj, dj, Kc = self._pad_pairs(thetas[lo:lo + cap],
                                         ds[lo:lo + cap].astype(np.int64),
                                         family="pairs_red")
            t = _np(self._point_feas_red(tj, dj))[:Kc]
            need[lo:lo + Kc] = ~(np.isfinite(t) & (t > 1e-3))
        return need

    def _verify_or_fallback(self, thetas: np.ndarray,
                            parts: list) -> tuple[int, int]:
        """Check every converged reduced grid cell against its dropped
        rows; re-solve violators on the full problem, in place.  Returns
        (fallback re-solve count, phase-1 gate solve count) for the
        caller to fold into the counters AFTER the rescue pass."""
        V, conv, feas, grad, u0, z = parts[:6]
        P, nd = V.shape
        th_grid = np.broadcast_to(thetas[:, None, :], (P, nd,
                                                       thetas.shape[1]))
        all_d = np.broadcast_to(np.arange(nd)[None, :], (P, nd))
        viol = self._dropped_violation(th_grid, all_d, z)
        # Converged-but-violating cells AND feasible-but-unconverged
        # ones both re-solve on the full problem: a reduced program can
        # stall where the full one converges (different Schur
        # conditioning), and leaving such a cell at V=inf would flip
        # dstar vs an unpruned build.  Cells reporting infeasible-and-
        # unconverged go through the reduced phase-1 gate
        # (_stalled_need_resolve): certified-infeasible cells stay, the
        # rest re-solve full.
        conv_b, feas_b = conv.astype(bool), feas.astype(bool)
        bad = (conv_b & (viol > 1e-6)) | (feas_b & ~conv_b)
        n_gate = 0
        stalled = ~feas_b & ~conv_b
        if np.any(stalled):
            ps, dss = np.nonzero(stalled)
            n_gate = ps.size
            res = self._stalled_need_resolve(thetas[ps], dss)
            bad[ps[res], dss[res]] = True
        if not np.any(bad):
            return 0, n_gate
        pt, ds = np.nonzero(bad)
        cap = self.max_pairs_per_call
        for lo in range(0, pt.size, cap):
            tj, dj, Kc = self._pad_pairs(thetas[pt[lo:lo + cap]],
                                         ds[lo:lo + cap].astype(np.int64))
            out = [_np(o)[:Kc] for o in self._solve_fixed(tj, dj)]
            sl = (pt[lo:lo + cap], ds[lo:lo + cap])
            V[sl], conv[sl], feas[sl] = out[0], out[1], out[2]
            grad[sl], u0[sl], z[sl] = out[3], out[4], out[5]
        # Re-reduce the touched points (first-minimum tie-break).
        Vm = np.where(conv.astype(bool), V, _INF)
        for p in np.unique(pt):
            j = int(np.argmin(Vm[p]))
            parts[6][p] = Vm[p][j]
            parts[7][p] = j if np.isfinite(Vm[p][j]) else -1
        return pt.size, n_gate

    def _elastic_min_into(self, Ms: np.ndarray, ds: np.ndarray,
                          idx: np.ndarray, out: np.ndarray,
                          feasible_somewhere: np.ndarray) -> None:
        """Pruned elastic simplex-min with verified fallback.

        The reduced joint witness (z_red, theta*, t*) is checked against
        every dropped row at elastic slack t*: satisfied means
        (z, theta, t) is feasible for the FULL elastic program and the
        dropped rows carry zero duals, so the bound (and the t = 0
        feasibility witness) equals the full program's.  Violating or
        unconverged rows re-solve on the full program -- tree parity
        with an unpruned build is preserved, and a feasibility witness
        is never claimed from an unverified pruned solve.
        """
        if self._red_dev is None or idx.size == 0:
            return super()._elastic_min_into(Ms, ds, idx, out,
                                             feasible_somewhere)
        self.n_solves += idx.size
        self.n_simplex_solves += idx.size
        self._iters(idx.size * self.n_f32, idx.size * self.n_iter,
                    idx.size * self.n_iter)
        nzr = int(self._red_dev.H.shape[1])
        nt = self.can.n_theta
        cap = self.max_simplex_rows_per_call
        V = np.empty(idx.size)
        conv = np.empty(idx.size, dtype=bool)
        t_el = np.empty(idx.size)
        zj = np.empty((idx.size, nzr + nt + 1))
        for lo in range(0, idx.size, cap):
            sub = idx[lo:lo + cap]
            Mj, dj = self._pad_simplex(Ms[sub], ds[sub],
                                       family="simplex_min_red")
            Vc, cc, _f, tc, zc = self._simplex_min_red(Mj, dj)
            n = sub.size
            V[lo:lo + n] = _np(Vc)[:n]
            conv[lo:lo + n] = _np(cc)[:n]
            t_el[lo:lo + n] = _np(tc)[:n]
            zj[lo:lo + n] = _np(zc)[:n]
        dsx = ds[idx]
        z_full = self._scatter_z(zj[:, :nzr], dsx)
        theta = zj[:, nzr:nzr + nt]
        t = np.maximum(zj[:, -1], 0.0)
        # The elastic t relaxes every problem row (G z - S theta - t <= w),
        # so it enters the row residual before the per-row scaling.
        viol = self._dropped_violation(theta, dsx, z_full, t_elastic=t)
        bad = ~conv | (viol > 1e-6)
        ok = ~bad
        out[idx[ok]] = V[ok]
        feasible_somewhere[idx[ok]] |= conv[ok] & (t_el[ok] <= 1e-6)
        if np.any(bad):
            self.n_prune_fallbacks += int(bad.sum())
            self._obs_prune(int(bad.sum()), 0)
            # Counter note: the full pass below counts its own solves.
            super()._elastic_min_into(Ms, ds, idx[bad], out,
                                      feasible_somewhere)

    def dispatch_pairs(self, thetas: np.ndarray, delta_idx: np.ndarray,
                       warm=None):
        # warm is accepted for signature parity and ignored: the pruned
        # reduced problem lives in a different variable space, and the
        # oracle advertises warm_start=False so the frontier never
        # offers donor data.
        if self._red_dev is None:
            return super().dispatch_pairs(thetas, delta_idx)
        thetas = np.atleast_2d(np.asarray(thetas, dtype=np.float64))
        K = thetas.shape[0]
        if K == 0:
            return ("empty",)
        delta_idx = np.asarray(delta_idx, dtype=np.int64)
        cap = self.max_pairs_per_call
        chunks = []
        for lo in range(0, K, cap):
            tj, dj, Kc = self._pad_pairs(thetas[lo:lo + cap],
                                         delta_idx[lo:lo + cap],
                                         family="pairs_red")
            chunks.append((self._solve_pairs_red(tj, dj), Kc))
        return ("pruned-chunks", thetas, delta_idx, chunks)

    def wait_pairs(self, handle):
        if handle[0] != "pruned-chunks":
            return super().wait_pairs(handle)
        t0 = time.perf_counter()
        _, thetas, delta_idx, chunks = handle
        parts = [np.concatenate([_np(out[k])[:Kc] for out, Kc in chunks])
                 for k in range(6)]
        V, conv, feas, grad, u0, z = parts
        conv, feas = conv.astype(bool), feas.astype(bool)
        z = self._scatter_z(z, delta_idx)
        viol = self._dropped_violation(thetas, delta_idx, z)
        # Same rules as _verify_or_fallback: violators and feasible-but-
        # unconverged cells re-solve full; stalled cells go through the
        # reduced phase-1 gate before being trusted as infeasible.
        bad = (conv & (viol > 1e-6)) | (feas & ~conv)
        n_gate = 0
        stalled = ~feas & ~conv
        if np.any(stalled):
            sidx = np.nonzero(stalled)[0]
            n_gate = sidx.size
            res = self._stalled_need_resolve(thetas[sidx],
                                             delta_idx[sidx])
            bad[sidx[res]] = True
        n_fb = 0
        if np.any(bad):
            idx = np.nonzero(bad)[0]
            n_fb = idx.size
            cap = self.max_pairs_per_call
            for lo in range(0, idx.size, cap):
                sub = idx[lo:lo + cap]
                tj, dj, Kc = self._pad_pairs(thetas[sub], delta_idx[sub])
                out = [_np(o)[:Kc] for o in self._solve_fixed(tj, dj)]
                V[sub], conv[sub], feas[sub] = out[0], out[1], out[2]
                grad[sub], u0[sub], z[sub] = out[3], out[4], out[5]
        if self.rescue_iter > 0 and np.any(feas & ~conv):
            ridx = np.nonzero(feas & ~conv)[0]
            rV, rconv, _rf, rgrad, ru0, rz = self._rescue_pairs(
                thetas[ridx], delta_idx[ridx])
            V[ridx], conv[ridx], grad[ridx] = rV, rconv, rgrad
            u0[ridx], z[ridx] = ru0, rz
        # Counters last (base wait_pairs contract; see wait_vertices).
        self.n_prune_fallbacks += n_fb
        self.n_solves += thetas.shape[0] + n_fb + n_gate
        self.n_point_solves += thetas.shape[0] + n_fb
        n = thetas.shape[0] + n_fb
        f32 = n * self.point_n_f32 + n_gate * self.n_f32
        f64 = n * self.point_n_iter + n_gate * self.n_iter
        self._iters(f32, f64, f64)
        self._obs_batch("point", n, time.perf_counter() - t0,
                        f32 + f64, f64)
        self._obs_prune(n_fb, n_gate)
        return np.where(conv, V, _INF), conv, grad, u0, z
