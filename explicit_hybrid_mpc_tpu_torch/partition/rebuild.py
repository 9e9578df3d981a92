"""Incremental warm rebuild: certificate-reuse tree transfer across
problem revisions.

The offline stage pays the full simplex-subdivision cost -- per-vertex
oracle grids, stage-2 joint QPs, eps-certification -- for every
controller it ships, yet in the production setting (ROADMAP: trees
rebuilt continuously as plant models, horizons, or eps targets are
revised and hot-swapped into ``serve/``) successive problems are
overwhelmingly similar.  The cheapest compute is *not solving at all*:
transfer the previous tree, re-certify its leaves in bulk against the
revised oracle, and subdivide only what the revision invalidated.

``warm_rebuild(problem, cfg, prior)`` runs three phases:

1. **Transfer**: the prior tree (a ``Tree``/tree pickle, or a build
   checkpoint -- whose ``VertexCache`` rows additionally donate warm
   starts) is copied bit-identically and re-stamped with the new build
   provenance (partition/provenance.py).  Priors whose root
   triangulation or problem shapes cannot transfer raise
   ``RebuildError`` (a cold build is required); a provenance diff of
   everything else is recorded in the stats.
2. **Re-certification sweep**: the prior build's stage-2 fact ledger
   (Tree.excl_events: whole-simplex Farkas exclusions + finite simplex
   lower bounds, recorded at the node that proved them) is re-VERIFIED
   against the new oracle and the survivors inherited down the tree --
   the sweep's stand-in for cold-build bound inheritance
   (_verify_excl_events).  Every prior leaf's vertices are then solved
   in pow-2 buckets through the engine's own MASKED planner
   (re-verified ancestor exclusions skip their point cells; vertices
   with a prior-checkpoint donor row go through the warm pair path,
   started from the cached prior duals/slacks exactly like the
   in-build tree warm-starts), and each leaf's STORED certificate is
   re-checked: eps-certified leaves via the stored-delta stage-1/
   stage-2 bounds (certify.recertify_stored_stage1/_stage2; loose
   ledger bounds retry exactly on the leaf, the frontier's round A/B),
   infeasible leaves via the re-verified emptiness certificates plus
   leaf-exact checks.  A pass keeps the leaf UNTOUCHED -- payloads are
   never rewritten, which is both the perf point and what makes an
   unchanged-problem rebuild bit-identical.
3. **Frontier re-entry**: invalidated leaves drop their payload
   (Tree.clear_leaf), seed their sweep-learned stage-2 facts into the
   bound-inheritance map, and re-enter the ordinary ``BuildPipeline``
   frontier, which runs exactly as a cold build from there
   (speculation/dedup/two-phase/the IPM leg kernel inherited).

Every oracle query of the sweep goes through the engine's
``_oracle_call``, so on a CUDA build it runs the IPM leg kernel and a
device failure ends the rebuild (``device.NoCpuFallback``), as in a
cold build: nothing is retried on the CPU.

Contract (the JAX package's tests/test_rebuild.py, held against this
port by tests/test_torch_rebuild.py): an UNCHANGED problem rebuilds
node-for-node bit-identical with ZERO subdivision solves (the sweep is
the only oracle traffic); any revision produces a tree whose every
kept or newly-built leaf carries the same certificates a cold build
would establish -- reuse is a perf tier, never a correctness
relaxation.  One caveat at scale, the same last-ulp pow-2-bucket class
the build pipeline documents: the sweep's batch shapes differ from the
original build's, so a KNIFE-EDGE certificate (a Farkas cert or gap
within float noise of its threshold) can flip and invalidate a handful
of leaves even on an unchanged problem -- those leaves re-certify
soundly through the frontier (measured: 15 of 12,033 flagship pendulum
leaves in the reference's measurement; 0 on the tier-1 acceptance
config, which is exactly bit-identical).  A kept leaf's certificate is
re-proved from fresh oracle data under the NEW problem/eps (the
sweep's pass is exactly the cold build's certificate mathematics,
docs/certificates.md); the only
structural difference to a cold build is that the transferred tree may
be FINER than necessary (a certificate that now holds higher up is not
coarsened), which is sound by refinement.

Leaves that carried no eps-certificate (depth-cap best-effort,
semi-explicit boundary leaves) are conservatively invalidated and
re-opened -- they re-close through the frontier's own rules.

Publish: ``publish_rebuild`` exports the result as a provenance-
stamped serving artifact directory and (optionally) hot-swaps it into
a ``serve.ControllerRegistry`` as a new version under the same
controller name (two-epoch handoff, docs/serving.md).
"""

from __future__ import annotations

import os
import time

import numpy as np

from explicit_hybrid_mpc_tpu_torch import obs as obs_lib
from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
from explicit_hybrid_mpc_tpu_torch.oracle.oracle import Oracle
from explicit_hybrid_mpc_tpu_torch.partition import certify, geometry
from explicit_hybrid_mpc_tpu_torch.partition import provenance as prov
from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
    FrontierEngine, PartitionResult, _donor_warm, make_oracle)
from explicit_hybrid_mpc_tpu_torch.partition.tree import NO_CHILD, Tree
from explicit_hybrid_mpc_tpu_torch.utils.logging import RunLog


class RebuildError(ValueError):
    """The prior artifact cannot transfer to the revised problem at all
    (root triangulation / shape mismatch): a cold build is required."""


class RebuildResult(PartitionResult):
    """PartitionResult whose stats additionally carry the rebuild_*
    reuse/invalidation accounting (see warm_rebuild)."""


def _load_prior(prior) -> tuple[Tree, dict, str]:
    """(prior tree, prior VertexCache rows or {}, source kind).

    Accepts a PartitionResult (the immediately-preceding build/rebuild,
    chained in memory by the continuous-rebuild daemon -- no disk
    round-trip per generation), a Tree instance, a tree pickle path
    (main.py's PREFIX.tree.pkl), a build-checkpoint path
    (PREFIX.ckpt.pkl -- its cache rows become warm-start donors), or an
    already-loaded checkpoint dict.  (A serve-registry version is NOT
    accepted: it carries only the flat leaf table, no tree structure --
    keep the PartitionResult next to what you publish.)"""
    if isinstance(prior, PartitionResult):
        return prior.tree, {}, "result"
    if isinstance(prior, Tree):
        return prior, {}, "tree"
    if isinstance(prior, dict):
        return prior["tree"], prior.get("cache", {}) or {}, "checkpoint"
    if not isinstance(prior, (str, os.PathLike)):
        raise RebuildError(f"unsupported prior type {type(prior)!r}")
    if os.path.isdir(prior):
        # Serving artifact dirs hold only the flat leaf table -- no
        # internal structure to transfer.  A tree pickle next to the
        # artifacts makes them rebuild-capable.
        cand = os.path.join(prior, "tree.pkl")
        if os.path.exists(cand):
            return Tree.load(cand), {}, "artifact"
        raise RebuildError(
            f"{prior} is an artifact directory without a tree.pkl: "
            "flat leaf tables carry no tree structure to transfer -- "
            "pass the build's .tree.pkl or .ckpt.pkl instead")
    from explicit_hybrid_mpc_tpu_torch.utils import atomic

    try:
        obj, _checked = atomic.read_checked_pickle(prior)
    except atomic.CorruptArtifact as e:
        raise RebuildError(
            f"prior {prior} failed its integrity check ({e}): a "
            "truncated/corrupt prior transfers garbage structure -- "
            "restore a previous generation (.prev for checkpoints) or "
            "run a cold build") from e
    if isinstance(obj, Tree):
        return obj, {}, "tree"
    if isinstance(obj, dict) and "tree" in obj:
        return obj["tree"], obj.get("cache", {}) or {}, "checkpoint"
    raise RebuildError(f"{prior} contains neither a Tree nor a build "
                       "checkpoint")


def _donor_rows(prior_cache: dict) -> dict:
    """Prior-checkpoint cache rows usable as warm-start donors: the
    10-slot layout with live duals (shimmed exactly like
    FrontierEngine.resume shims restored rows)."""
    donors: dict[bytes, tuple] = {}
    for k, row in prior_cache.items():
        if len(row) >= 10 and row[8] is not None:
            donors[k] = row
    return donors


def _check_transferable(prior_tree: Tree, problem) -> None:
    """Raise RebuildError when the prior's geometry cannot host the
    revised problem: parameter/input dims and the root triangulation
    must match bit-exactly (children are midpoint functions of roots,
    so a root drift poisons every vertex)."""
    if prior_tree.p != problem.n_theta or prior_tree.n_u != problem.n_u:
        raise RebuildError(
            f"prior tree has (p={prior_tree.p}, n_u={prior_tree.n_u}) "
            f"but the revised problem has (p={problem.n_theta}, "
            f"n_u={problem.n_u}): nothing transfers, run a cold build")
    roots_V = geometry.box_triangulation(
        problem.theta_lb, problem.theta_ub,
        getattr(problem, "root_splits", None))
    prior_roots = prior_tree.roots()
    if len(prior_roots) != len(roots_V) or not all(
            np.array_equal(prior_tree.vertices[r], V)
            for r, V in zip(prior_roots, roots_V)):
        raise RebuildError(
            "prior tree's root triangulation differs from the revised "
            "problem's box (theta bounds or root_splits changed): "
            "vertex geometry does not transfer, run a cold build")


def _verify_excl_events(eng: FrontierEngine, tree: Tree, nd: int
                        ) -> tuple[list, list, int, int]:
    """Re-verify the prior build's Farkas EXCLUSION events against the
    NEW oracle and push the survivors down the tree; index the FINITE
    bound events for lazy re-solving.

    Returns (excl_of, finfact_of, n_events, n_excl_ok):

    - ``excl_of[node]``: accumulated {delta: +inf} exclusions inherited
      from re-verified ancestor emptiness certificates (shared dict
      refs -- one object per distinct set);
    - ``finfact_of[node]``: {delta: fact_node} pointing at the DEEPEST
      ancestor (or the node itself) where the prior build solved a
      finite simplex lower bound for that commutation -- the sweep
      re-solves the bound AT THAT NODE on demand, one joint QP shared
      by every descendant leaf (the cold build's inheritance shape,
      re-proved fresh).

    This is the sweep's answer to cold-build bound inheritance: each
    event is ONE certificate covering every descendant leaf, re-proved
    under the revised problem (reuse is never trusted, only
    re-targeted).  Without the ledger (legacy priors) every pending
    (leaf, commutation) pays its own joint QP -- correct, but the
    dominant sweep cost on hybrid problems."""
    # Last-wins dedup at first-occurrence position: a chained rebuild's
    # frontier appends FRESH facts after the transferred prior ledger,
    # and the freshest fact for a (node, delta) is the one to re-verify;
    # keeping the first occurrence's position preserves the exact list
    # (hence tree bit-identity) when there are no duplicates.
    seen: dict[tuple[int, int], float] = {}
    for a, d, v in tree.excl_events:
        key = (int(a), int(d))
        if 0 <= key[1] < nd and 0 <= key[0] < len(tree):
            seen[key] = float(v)
    inf_events = [k for k, v in seen.items() if v == np.inf]
    verified: dict[int, set] = {}
    n_ok = 0
    if inf_events:
        # Batched barycentric inverses: a python-loop
        # barycentric_matrix per event is ~seconds of pure host
        # overhead at flagship ledger sizes (~20k events).
        nodes_a = np.array([a for a, _ in inf_events], dtype=np.int64)
        Ms = geometry.barycentric_matrices(tree.vertices[nodes_a])
        ds = np.array([d for _, d in inf_events], dtype=np.int64)
        _t, _f, cert = eng._oracle_call("simplex_feasibility", Ms, ds)
        for (a, d), ok in zip(inf_events, cert):
            if ok:
                n_ok += 1
                verified.setdefault(a, set()).add(d)
    fin_at: dict[int, list[int]] = {}
    for (a, d), v in seen.items():
        if np.isfinite(v):
            fin_at.setdefault(a, []).append(d)
    # Push down: children inherit the parent's accumulated maps (node
    # ids ascend parent-before-child by construction); nodes adding
    # nothing SHARE the parent's dict -- O(distinct sets) memory.
    # Deeper finite facts override shallower ones (tighter bounds,
    # exactly like frontier inheritance).
    parent = tree.parent
    empty_b: dict[int, float] = {}
    empty_f: dict[int, int] = {}
    excl_of: list = [None] * len(tree)
    finfact_of: list = [None] * len(tree)
    for i in range(len(tree)):
        pi = int(parent[i])
        base_b = excl_of[pi] if pi >= 0 else empty_b
        base_f = finfact_of[pi] if pi >= 0 else empty_f
        mine_b = verified.get(i)
        if mine_b:
            base_b = dict(base_b)
            for d in mine_b:
                base_b[d] = np.inf
        mine_f = fin_at.get(i)
        if mine_f:
            base_f = dict(base_f)
            for d in mine_f:
                base_f[d] = i
        excl_of[i] = base_b
        finfact_of[i] = base_f
    # The REBUILT tree's ledger: deduped facts minus exclusion events
    # that failed re-verification (a dead event would otherwise be
    # re-checked -- and fail -- on every future rebuild, and the
    # ledger would grow monotonically across chained rebuilds).
    surviving = [(a, d, v) for (a, d), v in seen.items()
                 if np.isfinite(v) or d in verified.get(a, ())]
    return excl_of, finfact_of, len(seen), n_ok, surviving


def _inject_prior_donors(plan: dict, donors: dict) -> None:
    """Override a plan's pair-path warm starts with SAME-VERTEX donor
    rows from a prior checkpoint's VertexCache: the prior solution of
    the exact vertex being re-solved is a strictly better IPM start
    than the sibling-vertex donor _plan_missing picked (and the merit
    gate still protects against a stale one).  Mutates the plan's
    pair_warm arrays in place; wire order (z, s, lam, has) matches
    _PlanBuilder / Oracle.dispatch_pairs."""
    if not donors or plan.get("pair_warm") is None:
        return
    zw, sw, lw, hw = plan["pair_warm"]
    for k, ds, lo in plan["pair_slices"]:
        drow = donors.get(k)
        if drow is None:
            continue
        z2, l2, s2, h2 = _donor_warm(drow, ds)
        sl = slice(lo, lo + ds.size)
        zw[sl], sw[sl], lw[sl], hw[sl] = z2, s2, l2, h2


def _dispatch_sweep(eng: FrontierEngine, plan: dict):
    """Run a sweep plan's device programs (grid + warm pairs) through
    the engine's device-failure-fallback oracle path."""
    sol = pair_out = None
    if plan["grid_arr"] is not None:
        sol = eng._oracle_call("solve_vertices", plan["grid_arr"])
    if plan["pair_t"] is not None:
        pair_out = eng._oracle_call("solve_pairs_full", plan["pair_t"],
                                    plan["pair_d"], plan["pair_warm"])
    return sol, pair_out


def warm_rebuild(problem, cfg: PartitionConfig, prior,
                 oracle: Oracle | None = None,
                 obs: "obs_lib.Obs | None" = None,
                 log: RunLog | None = None,
                 strict_provenance: bool = False,
                 priority: dict | None = None) -> RebuildResult:
    """Rebuild a fully eps-certified tree for (problem, cfg) by
    transferring `prior` (see module docstring).

    strict_provenance: refuse priors that carry NO provenance stamp
    (legacy artifacts cannot be validated against the revision; the
    default shims them with a stats note and proceeds -- the sweep
    itself re-proves every kept certificate either way).

    priority: optional {tree node id: weight} demand hint (the JAX
    package's obs/demand.py ``priority_from_snapshot`` maps a serving
    traffic snapshot's leaf rows to node ids; that module is not ported
    yet, so the rebuild service always passes None).  Invalidated
    leaves re-enter the frontier hottest-first instead of in node
    order, so under an interrupted or wall-bounded rebuild the leaves
    live traffic actually visits are re-certified before cold
    corners.  It is an ORDERING hint only: the same leaves are
    processed either way, so a rebuild that re-certifies every
    invalidated leaf WITHOUT splitting yields a bit-identical tree
    (node numbering only diverges when splits allocate fresh node ids
    in a different order).  Nodes
    missing from the map sort as weight 0 in node order -- a stale
    snapshot degrades to the default ordering, never to an error.

    Returns a RebuildResult whose stats extend the ordinary build
    stats with::

        rebuild_leaves_total / _recertified / _reused / _invalidated
        rebuild_reuse_frac          kept / total prior leaves
        recert_solves               oracle solves issued by the sweep
        subdivision_solves          oracle solves issued by the frontier
        sweep_wall_s / rebuild_wall_s
        provenance_changed          field-level prior-vs-new stamp diff
        rebuild_priority_hint       nodes matched by the demand hint
        rebuild_priority_order      first frontier entries (hint runs)
    """
    t0 = time.perf_counter()
    # Fault-injection site (faults/injector.py): scripted failures at
    # the rebuild boundary -- the sweep inherits the engine's full
    # bounded-recovery policy for everything downstream.
    from explicit_hybrid_mpc_tpu_torch.faults import injector as faults_inj

    faults_inj.fire("rebuild.sweep")
    prior_tree, prior_cache, src = _load_prior(prior)
    prior_stamp = getattr(prior_tree, "provenance", None)
    if strict_provenance and prior_stamp is None:
        raise prov.ProvenanceMismatch(
            "prior artifact carries no provenance stamp and "
            "strict_provenance is set: cannot validate what problem/"
            "config it was built for (re-export it from a stamped "
            "build, or drop --strict-provenance to shim)")
    if oracle is None:
        oracle = make_oracle(problem, cfg)
    _check_transferable(prior_tree, problem)
    new_stamp = prov.build_stamp(problem, cfg)
    stamp_diffs = prov.diff_stamps(prior_stamp, new_stamp)

    # Bit-identical structure transfer: columnar copy (Tree.clone; a
    # prior loaded from disk was already normalized + vertex-rederived
    # by __setstate__, and an in-memory prior is columnar by
    # construction -- the old pickle.dumps round-trip serialized
    # O(tree) bytes per generation in the rebuild daemon's hot loop
    # for a copy the columns give directly).
    new_tree: Tree = prior_tree.clone()
    new_tree.provenance = new_stamp

    eng = FrontierEngine.resume(
        {"tree": new_tree, "roots": new_tree.roots(), "frontier": [],
         "cache": {}, "steps": 0, "n_uncertified": 0,
         "n_semi_explicit": 0, "n_unique_solves": 0, "cfg": cfg},
        problem, oracle, log=log, cfg=cfg, obs=obs)
    nd = oracle.can.n_delta
    tree = eng.tree
    childless = np.nonzero(tree.children[:, 0] == NO_CHILD)[0]
    data_ids = tree.converged_leaf_ids()
    deltas = tree.leaf_payloads(data_ids)[0] if data_ids.size else \
        np.zeros(0, dtype=np.int32)
    cert_mask = tree.certified_flags(data_ids)
    # Re-certifiable: eps-certified leaves with a transferable delta,
    # plus closed-infeasible leaves (childless, no payload).  Best-
    # effort/semi-explicit leaves carried no certificate to transfer:
    # conservatively invalidated (they re-close through the frontier's
    # own depth rules).
    recert_ok = cert_mask & (deltas < nd)
    certified = set(int(i) for i in data_ids[recert_ok])
    stored_delta = {int(i): int(d)
                    for i, d in zip(data_ids[recert_ok],
                                    deltas[recert_ok])}
    infeasible = set(int(i) for i in childless) \
        - set(int(i) for i in data_ids)
    pre_invalid = [int(i) for i in data_ids[~recert_ok]]
    sweep_nodes = sorted(certified | infeasible)
    n_total = len(sweep_nodes) + len(pre_invalid)

    # Retain every prior leaf up front: shared vertices between a kept
    # leaf (released after its verdict) and a later batch's leaf must
    # not be evicted mid-sweep, and every node that enters the frontier
    # must hold its refcounts like step()-split children do.
    for node in sweep_nodes:
        eng._retain(node)
    for node in pre_invalid:
        eng._retain(node)

    donors = _donor_rows(prior_cache)
    feasible_variant = getattr(cfg, "algorithm", "suboptimal") == "feasible"
    use_inh = getattr(cfg, "inherit_bounds", True)
    n_reused = n_invalid = 0
    invalid_nodes: list[int] = []

    def invalidate(node: int, facts: dict | None = None) -> None:
        nonlocal n_invalid
        n_invalid += 1
        tree.clear_leaf(node)
        if facts and use_inh:
            # MERGE on top of the ancestor-exclusion seeds (below):
            # both are inherited facts for the frontier phase.
            eng._inherit.setdefault(node, {}).update(facts)
        invalid_nodes.append(node)

    def keep(node: int) -> None:
        nonlocal n_reused
        n_reused += 1
        # Kept leaves never reach a frontier commit: drop their
        # ancestor-exclusion seeds and cache refcounts here.
        eng._inherit.pop(node, None)
        eng._release(node)

    for node in pre_invalid:
        invalidate(node)

    # Sweep chunk size: leaves are verdict-independent, so the sweep
    # batches far wider than the frontier's step size -- the oracle
    # still pads/chunks device programs at its own pow-2 caps (no new
    # compiled shapes), and fewer chunks means fewer host passes
    # (gather/plan/certify fixed costs).  The floor is 1024 leaves
    # REGARDLESS of cfg.batch_simplices (chunk memory is a few MB of
    # vertex rows; a larger batch_simplices widens chunks further).
    batch = max(1024, cfg.batch_simplices)
    # Re-verify the prior build's Farkas exclusion ledger ONCE and
    # inherit the survivors down the tree (see _verify_excl_events):
    # the per-node exclusion dicts seed the engine's inheritance map
    # chunk by chunk, so the ORDINARY masked planner skips the excluded
    # point cells exactly like a cold build, and the stage-2 keep-check
    # reads their +inf bounds for free.  Exclusions are eps-independent
    # feasibility geometry, so an eps-only revision re-verifies the
    # whole ledger.
    with eng.obs.span("rebuild.verify_exclusions"):
        (excl_of, finfact_of, n_excl_events, n_excl_ok,
         surviving_events) = _verify_excl_events(eng, tree, nd)
    # The new tree carries the PRUNED ledger (dead exclusions dropped,
    # duplicates collapsed); the frontier phase appends its fresh facts
    # on top, so chained rebuilds stay bounded.
    tree.excl_events = surviving_events
    if use_inh:
        # Pre-invalidated leaves (best-effort/semi-explicit) re-opened
        # above inherit the re-verified exclusions too -- their
        # re-subdivision then masks point cells like any cold child.
        for node in invalid_nodes:
            excl = excl_of[node]
            if excl:
                eng._inherit.setdefault(node, {}).update(excl)
    # Finite-bound facts re-solve LAZILY at their recorded node, once,
    # shared by every descendant leaf that demands them.
    fact_memo: dict[tuple[int, int], float] = {}
    bary_memo: dict[int, np.ndarray] = {}

    def _bary(node: int) -> np.ndarray:
        M = bary_memo.get(node)
        if M is None:
            M = geometry.barycentric_matrix(tree.vertices[node])
            bary_memo[node] = M
        return M

    with eng.obs.span("rebuild.sweep"):
        for lo in range(0, len(sweep_nodes), batch):
            chunk = sweep_nodes[lo:lo + batch]
            if use_inh:
                for n in chunk:
                    excl = excl_of[n]
                    if excl:
                        eng._inherit.setdefault(n, {}).update(excl)
            plan = eng._plan_missing(chunk)
            if plan is not None:
                _inject_prior_donors(plan, donors)
                sol, pair_out = _dispatch_sweep(eng, plan)
                eng._merge_plan_results(plan, sol, pair_out)
            sds, _ = eng._gather_batch(chunk)
            pending: dict[int, certify.CertificateResult] = {}
            farkas_pend: list[int] = []
            for node in chunk:
                sd = sds[node]
                if node in infeasible:
                    if certify.recertify_infeasible(sd) == "split":
                        invalidate(node)
                    else:
                        farkas_pend.append(node)
                    continue
                d = stored_delta[node]
                if feasible_variant:
                    # Feasibility-only partitions: the stored law's
                    # certificate IS vertex convergence + convexity.
                    if bool(np.all(sd.conv[:, d])):
                        keep(node)
                    else:
                        invalidate(node)
                    continue
                res = certify.recertify_stored_stage1(
                    sd, d, cfg.eps_a, cfg.eps_r)
                if res.status == "certified":
                    keep(node)
                elif res.status == "split":
                    # (The JAX package dumps a flight-recorder bundle of
                    # the invalidated leaf here; the recorder is not
                    # ported -- PartitionConfig refuses obs_recorder.)
                    invalidate(node)
                else:  # pending: stage-2 bounds needed
                    pending[node] = res

            # -- Farkas re-proof for closed-infeasible leaves ----------
            # The re-verified ledger already covers most commutations;
            # only the ones with no surviving ancestor certificate need
            # a leaf-exact emptiness check.
            if farkas_pend:
                rows_b = []
                unproved: dict[int, list[int]] = {}
                for nn in farkas_pend:
                    excl = excl_of[nn]
                    miss = [d for d in range(nd) if d not in excl]
                    unproved[nn] = miss
                    rows_b.extend((nn, d) for d in miss)
                exact: dict[tuple[int, int], bool] = {}
                if rows_b:
                    Ms = np.stack([_bary(n2) for n2, _ in rows_b])
                    ds = np.array([d for _, d in rows_b],
                                  dtype=np.int64)
                    _t, _f, cert = eng._oracle_call(
                        "simplex_feasibility", Ms, ds)
                    for key, ok in zip(rows_b, cert):
                        exact[key] = bool(ok)
                for nn in farkas_pend:
                    if all(exact[(nn, d)] for d in unproved[nn]):
                        # Still certified empty on all of R: the closed
                        # infeasible leaf stands untouched.
                        keep(nn)
                    else:
                        facts = {d: np.inf for d in unproved[nn]
                                 if exact[(nn, d)]}
                        invalidate(nn, facts)

            # -- stage-2 bounds for stored-delta keeps -----------------
            # Three tiers per pending commutation: ledger exclusions
            # carry +inf for free; commutations with a finite ledger
            # fact re-solve the bound AT THE RECORDED NODE (memoized --
            # one joint QP shared by every descendant leaf) and try the
            # certificate with that valid-but-possibly-loose bound (the
            # frontier's round A); only commutations with no fact, or
            # whose loose bound failed the keep, pay an EXACT leaf
            # solve (round B).
            if pending:
                fact_rows: list[tuple[int, int]] = []
                seen_rows: set[tuple[int, int]] = set()
                rows_l: list[tuple[int, int]] = []
                for nn, res in pending.items():
                    excl = excl_of[nn]
                    fin = finfact_of[nn]
                    for dp in res.pending_deltas:
                        dp = int(dp)
                        if dp in excl:
                            continue
                        fn = fin.get(dp)
                        if fn is None:
                            rows_l.append((nn, dp))  # no fact: exact
                        else:
                            key = (fn, dp)
                            if key not in fact_memo \
                                    and key not in seen_rows:
                                seen_rows.add(key)
                                fact_rows.append(key)
                if fact_rows:
                    Ms = np.stack([_bary(a) for a, _ in fact_rows])
                    ds = np.array([d for _, d in fact_rows],
                                  dtype=np.int64)
                    Vmin, _f = eng._oracle_call("solve_simplex_min",
                                                Ms, ds)
                    for key, v in zip(fact_rows, Vmin):
                        fact_memo[key] = float(v)
                vm_exact: dict[tuple[int, int], float] = {}
                if rows_l:
                    Ms = np.stack([_bary(n2) for n2, _ in rows_l])
                    ds = np.array([d for _, d in rows_l],
                                  dtype=np.int64)
                    Vmin, _f = eng._oracle_call("solve_simplex_min",
                                                Ms, ds)
                    for key, v in zip(rows_l, Vmin):
                        vm_exact[key] = float(v)

                def _leaf_vm(nn: int, res) -> tuple[dict, list[int]]:
                    """(per-delta bounds, loose deltas): exclusion /
                    exact bounds are final; fact-node bounds are loose
                    unless the fact node IS the leaf."""
                    excl = excl_of[nn]
                    fin = finfact_of[nn]
                    vm: dict[int, float] = {}
                    loose: list[int] = []
                    for dp in res.pending_deltas:
                        dp = int(dp)
                        if dp in excl:
                            vm[dp] = np.inf
                        elif (nn, dp) in vm_exact:
                            vm[dp] = vm_exact[(nn, dp)]
                        else:
                            fn = fin[dp]
                            vm[dp] = fact_memo[(fn, dp)]
                            if fn != nn and vm[dp] != np.inf:
                                loose.append(dp)
                    return vm, loose

                round_b: list[tuple[int, int]] = []
                loose_of: dict[int, list[int]] = {}
                vm_of: dict[int, dict[int, float]] = {}
                for nn, res in pending.items():
                    d = stored_delta[nn]
                    gaps = res._stage1_gap[0]
                    vm, loose = _leaf_vm(nn, res)
                    vm_of[nn] = vm
                    u_max = float(np.max(sds[nn].V[:, d]))
                    ok, _g = certify.recertify_stored_stage2(
                        gaps, u_max, sds[nn].Vstar, vm, cfg.eps_a,
                        cfg.eps_r)
                    if ok:
                        keep(nn)
                        pending[nn] = None
                        continue
                    if loose:
                        loose_of[nn] = loose
                        round_b.extend((nn, dp) for dp in loose)
                if round_b:
                    Ms = np.stack([_bary(n2) for n2, _ in round_b])
                    ds = np.array([d for _, d in round_b],
                                  dtype=np.int64)
                    Vmin, _f = eng._oracle_call("solve_simplex_min",
                                                Ms, ds)
                    for (nn, dp), v in zip(round_b, Vmin):
                        vm_of[nn][dp] = float(v)
                for nn, res in pending.items():
                    if res is None:
                        continue  # kept in round A
                    vm = vm_of[nn]
                    d = stored_delta[nn]
                    gaps = res._stage1_gap[0]
                    u_max = float(np.max(sds[nn].V[:, d]))
                    kept = False
                    if nn in loose_of:
                        kept, _g = certify.recertify_stored_stage2(
                            gaps, u_max, sds[nn].Vstar, vm, cfg.eps_a,
                            cfg.eps_r)
                    if kept:
                        keep(nn)
                        continue
                    # Invalidated: seed the frontier's inheritance map
                    # with what the sweep proved -- ledger exclusions,
                    # re-proved fact bounds (valid ancestor bounds for
                    # this node and its children), and exact leaf
                    # bounds are inherited facts exactly like step()'s
                    # fresh results (-inf stalls are never stored,
                    # matching step()).  (No recorder bundle: see above.)
                    invalidate(nn, {dp: v for dp, v in vm.items()
                                    if v != -np.inf})

    sweep_s = time.perf_counter() - t0
    recert_solves = oracle.n_solves
    n_recert = len(sweep_nodes)
    reuse_frac = n_reused / max(1, n_total)
    o = eng.obs
    if o.enabled:
        m = o.metrics
        m.counter("rebuild.leaves_recertified").inc(n_recert)
        m.counter("rebuild.leaves_reused").inc(n_reused)
        m.counter("rebuild.leaves_invalidated").inc(n_invalid)
        m.counter("rebuild.recert_solves").inc(recert_solves)
        m.gauge("rebuild.reuse_frac").set(reuse_frac)
        rec = o.event("rebuild.sweep", prior_source=src,
                      leaves_total=n_total, recertified=n_recert,
                      reused=n_reused, invalidated=n_invalid,
                      reuse_frac=round(reuse_frac, 4),
                      recert_solves=recert_solves,
                      sweep_s=round(sweep_s, 3),
                      provenance_changed=stamp_diffs)
        if eng._health is not None:
            # The reuse-collapse rule reads the metrics snapshot; feed
            # one now so an unchanged rebuild (zero frontier steps --
            # the engine's periodic feed never runs) still gets a
            # verdict.
            eng._health.feed(rec)
            snap = o.flush_metrics()
            if snap is not None:
                eng._health.feed(snap)
    eng.log.emit(rebuild_sweep=True, leaves_total=n_total,
                 reused=n_reused, invalidated=n_invalid,
                 reuse_frac=round(reuse_frac, 4),
                 recert_solves=recert_solves,
                 sweep_s=round(sweep_s, 3))

    # Invalidated leaves re-enter the frontier IN NODE ORDER (the
    # deterministic order a resumed build would see them) unless a
    # demand priority hint reorders them hottest-first (docstring);
    # then the ordinary pipelined build runs to completion.
    n_hinted = 0
    if priority:
        pr = {int(k): float(v) for k, v in priority.items()}
        entry = sorted(invalid_nodes,
                       key=lambda n2: (-pr.get(int(n2), 0.0), int(n2)))
        n_hinted = sum(1 for n2 in invalid_nodes
                       if pr.get(int(n2), 0.0) > 0)
    else:
        entry = sorted(invalid_nodes)
    for node in entry:
        eng.frontier.append(node)
    res = eng.run()

    wall = time.perf_counter() - t0
    stats = dict(res.stats)
    stats.update(
        rebuild_prior_source=src,
        rebuild_prior_regions=int(prior_tree.n_regions()),
        rebuild_leaves_total=n_total,
        rebuild_leaves_recertified=n_recert,
        rebuild_leaves_reused=n_reused,
        rebuild_leaves_invalidated=n_invalid,
        rebuild_reuse_frac=round(reuse_frac, 4),
        recert_solves=recert_solves,
        subdivision_solves=oracle.n_solves - recert_solves,
        sweep_wall_s=round(sweep_s, 3),
        rebuild_wall_s=round(wall, 3),
        regions_per_s=res.tree.n_regions() / max(wall, 1e-9),
        provenance_changed=stamp_diffs,
        warm_donor_vertices=len(donors),
        # Prior Farkas exclusion ledger economy: events carried by the
        # prior tree vs events whose certificates re-verified under the
        # revised problem (each survivor covers every descendant leaf's
        # pending commutation for free).
        rebuild_excl_events=n_excl_events,
        rebuild_excl_reverified=n_excl_ok,
        # Demand-hint consumption (docstring): how many invalidated
        # leaves the hint actually ranked, and the order the first of
        # them entered the frontier -- the priority smoke asserts hot
        # nodes lead it.
        rebuild_priority_hint=n_hinted,
        rebuild_priority_order=[int(n2) for n2 in entry[:16]],
    )
    return RebuildResult(res.tree, res.roots, stats)


def publish_rebuild(result: PartitionResult, dir_path: str,
                    registry=None, name: str = "default",
                    version: str | None = None,
                    **load_kwargs) -> str:
    """Export `result` as a provenance-stamped serving artifact
    directory and, when a ``serve.ControllerRegistry`` is given,
    publish it as a new version under `name` (atomic two-epoch hot
    swap -- in-flight batches drain on the old tree, docs/serving.md).
    Returns the version string (default: derived from the build
    stamp's problem hash + eps, so successive rebuilds of the same
    revision publish under the same version name).  ``load_kwargs`` go
    to ``ControllerRegistry.load_artifacts``: its default serves on
    every CUDA device; ``devices=[torch.device("cpu")]`` on the CPU."""
    from explicit_hybrid_mpc_tpu_torch.serve import registry as reg_mod

    stamp = getattr(result.tree, "provenance", None)
    if version is None:
        if stamp is not None:
            version = (f"rebuild-{stamp['problem_hash'][:8]}"
                       f"-eps{stamp['eps_a']:g}")
        else:
            version = f"rebuild-r{result.tree.n_regions()}"
    reg_mod.save_artifacts(result.tree, result.roots, dir_path,
                           provenance=stamp)
    if registry is not None:
        registry.load_artifacts(name, version, dir_path,
                                expect_provenance=stamp, **load_kwargs)
    return version
