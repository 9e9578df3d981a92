"""Bounded asynchronous build pipeline: depth-N in-flight scheduling,
cross-batch vertex dedup, and speculative child dispatch.

The frontier engine's old overlap was a SINGLE prefetch slot: one step's
point solves could be dispatched while the previous step's host work ran,
and everything else (stage-2 joint programs, certify/bisect, tree
commits) serialized against the device.  This module generalizes it into
a bounded pipeline (cfg.pipeline_depth): up to N frontier batches are
planned and dispatched ahead of the committing step, so plan(k+2) and
dispatch(k+2) run while wait(k+1) resolves and commit(k) writes the tree.

Correctness model -- the produced tree is NODE-FOR-NODE BIT-IDENTICAL
to the synchronous (pipeline_depth=0) build: same region count, same
node vertex matrices (bitwise -- bisection arithmetic is exact), same
leaf commutation choices and certification statuses.  (Leaf payload
FLOATS may differ in the final ulp when a cell's solve was served from
a program padded to a different pow-2 bucket -- batched products
of another size may sum in another order; converged lanes are bitwise lane-independent WITHIN a
bucket, measured, but not across bucket sizes.  The legacy prefetch's
duplicate-and-overwrite merges and the CPU bench's warm-start donors
carry exactly the same caveat; certificates sit eps away from these
ulps.)  The scheduling invariants:

- Claims are full-size frontier prefixes only; the frontier deque pops
  at the front (commits) and appends at the back (children), so a
  claimed batch always equals the batch the synchronous loop would pop.
- Fill-time plans are TENTATIVE: they may be computed against a cache
  state older than the one the synchronous build would plan against.
  Every step therefore re-plans AUTHORITATIVELY at commit time, when the
  cache state is exactly the synchronous build's, and serves each
  missing (vertex, delta) cell from the in-flight window only when the
  dispatched program's route matches the authoritative plan's route --
  same program family (dense grid vs sparse pair) and the same
  warm-start donor row (identity, or bitwise-equal donor cells).  The
  per-cell IPM programs are batch-composition independent within a
  program family, so a route-matched cell is the cell the synchronous
  build would have solved (to the ulp caveat above); mismatched cells
  are re-solved synchronously from the authoritative plan.  Cache rows
  are then written through the same merge code, in commit order.
- Speculative results live in the same window and obey the same route
  match; a mis-speculation is dropped before it can ever reach a cache
  row.

Dedup: duplicate (vertex, delta) requests across the whole in-flight
window -- sibling bisection midpoints, the batch-boundary overlaps the
old prefetch re-solved ("a midpoint shared across the batch boundary can
be solved twice") -- coalesce into one dispatched program fanned back
out to every requester through the window, shrinking point_solves.

Speculation (cfg.speculate): when a frontier cell's inherited
certificate gap is INFINITE (the mixed-feasibility boundary
population, the only one whose re-split is predictable; see
speculate() for the measurement), the cell's own children's shared new
vertex (its longest-edge bisection midpoint) is dispatched at consume
time, BEFORE the cell's certificate verdict lands and only while the
device is not already the bottleneck (SPEC_DEVICE_FRAC_MAX).  The
device then solves next-generation vertices while the host certifies
this one; hits are served through the window when the children are
claimed, and misses (the cell certified or closed instead of
splitting) are dropped at commit and tallied as spec_waste.
"""

from __future__ import annotations

import collections
import itertools
import queue
import threading
import time
import types

import numpy as np

#: Speculation is an idle-device filler: it only pays when the device
#: would otherwise sit out the host's certify/commit work.  When the
#: rolling device-busy fraction of recent steps exceeds this bound the
#: device is already the bottleneck and speculative batches would only
#: deepen its queue (measured on the tier-1 CPU bench, device_frac
#: ~0.94: unconditional speculation wasted 16% of point-solve work and
#: cost ~8% wall), so dispatch is skipped.  Tests raise the bound to
#: force speculation on CPU.
SPEC_DEVICE_FRAC_MAX = 0.6


class _Program:
    """One dispatched oracle program batch (grid or pairs): handle,
    fallback args, resolved output, and speculation accounting in
    point-QP cells."""

    __slots__ = ("kind", "handle", "args", "out", "spec", "n_cells",
                 "n_used", "live_refs", "retired", "lock", "queued")

    def __init__(self, kind: str, handle, args: tuple, spec: bool,
                 n_cells: int):
        self.kind = kind
        self.handle = handle
        self.args = args
        self.out = None
        self.spec = spec
        self.n_cells = n_cells
        self.n_used = 0
        self.live_refs = 0
        self.retired = False
        # Serializes resolution between the committing thread and the
        # async-certify background waiter (cfg.async_certify); a
        # plain Lock is ~100 ns uncontended, noise next to a dispatch.
        self.lock = threading.Lock()
        self.queued = False


class _Src:
    """A (program, row) reference serving one window cell or one full
    grid row; `donor` is the warm-start donor row the program's warm
    arrays were sliced from (None = cold), `owner` the speculating
    parent node (None for real plan programs)."""

    __slots__ = ("prog", "idx", "donor", "owner")

    def __init__(self, prog: _Program, idx: int, donor, owner):
        self.prog = prog
        self.idx = idx
        self.donor = donor
        self.owner = owner


class _Entry:
    """Window entry for one vertex key: dense-grid sources (cover every
    commutation, cold) and per-delta pair sources."""

    __slots__ = ("grid", "cells")

    def __init__(self):
        self.grid: list[_Src] = []
        self.cells: dict[int, list[_Src]] = {}


class BuildPipeline:
    """Scheduler + dedup window + speculation for one FrontierEngine.

    The engine drives it per step: fill() claims and dispatches ahead,
    pop_claim() consumes the head claim, serve() resolves the
    authoritative plan from the window (sync-solving route mismatches),
    speculate() dispatches predicted grandchildren, on_commit() settles
    speculation, cancel() drops every in-flight handle (checkpoints,
    end of run)."""

    #: Class attribute so tests (and subclasses) can force speculation
    #: on a host whose "device" is never idle.
    SPEC_DEVICE_FRAC_MAX = SPEC_DEVICE_FRAC_MAX

    def __init__(self, eng):
        self.eng = eng
        cfg = eng.cfg
        self.depth = (int(getattr(cfg, "pipeline_depth", 2))
                      if getattr(cfg, "prefetch_solves", True) else 0)
        # eps_r-only builds never speculate (the infinite-gap split
        # predictor was only validated on eps_a builds; config.py
        # documents the limitation), and neither do mesh-sharded
        # oracles: the speculation gate reads
        # the TIMING-dependent device_frac EMA, and under multi-process
        # SPMD a dispatch decision that differs across processes would
        # desynchronize the collective mesh programs.
        self.spec_on = (bool(getattr(cfg, "speculate", True))
                        and self.depth >= 1
                        and getattr(cfg, "eps_a", 0.0) > 0
                        and getattr(eng.oracle, "mesh", None) is None
                        # Sharded frontiers never speculate: a
                        # mis-speculated midpoint on a shard boundary
                        # would post exchange requests the owner then
                        # solves for a child that never materializes --
                        # wasted remote work AND a broken summed-
                        # point_solves parity bar.
                        and getattr(eng, "_shard", None) is None)
        self.window_cap = int(getattr(cfg, "dedup_window", 8192))
        # (batch node tuple, planned?) -- planned is False when the
        # full dedup window refused the tentative plan at fill time.
        self._claims: collections.deque[
            tuple[tuple[int, ...], bool]] = collections.deque()
        self._win: dict[bytes, _Entry] = {}
        self._spec_keys: dict[int, list[bytes]] = {}
        self._child_gap: dict[int, float] = {}
        self.n_pipelined_steps = 0
        self.dedup_saved = 0
        self.spec_hits = 0
        self.spec_waste = 0
        self.spec_dropped_unwaited = 0
        self._fill_sum = 0.0
        self._fill_steps = 0
        # Asynchronous host-certify (cfg.async_certify): a background
        # waiter resolves in-flight NON-speculative programs while the
        # engine certifies, so the next step's serve() finds them
        # memoized and the serialized cp_wait share shrinks.
        # Speculative programs are excluded on purpose: the oracle
        # counts solves at WAIT time, and pre-waiting a speculation
        # that gets dropped would count device work the synchronous
        # build never counts.  Mesh oracles are excluded like the
        # speculation gate: collective programs must resolve in the
        # engine thread's deterministic order on every process.
        self.async_on = (bool(getattr(cfg, "async_certify", False))
                         and self.depth >= 1
                         and getattr(eng.oracle, "mesh", None) is None)
        self.overlap_wait_s = 0.0
        self.n_overlap_resolved = 0
        self._bg_thread: threading.Thread | None = None
        self._bg_q: "queue.Queue[_Program | None]" | None = None
        # Wall seconds of the most recent fill() call -- the
        # "pipeline fill" segment of the engine's per-step critical-
        # path breakdown (frontier.step; measured here so lookahead
        # planning + dispatch cost is attributed by its owner).
        self.last_fill_wall = 0.0

    # -- stats -------------------------------------------------------------

    @property
    def in_flight(self) -> int:
        return len(self._claims)

    @property
    def planned_in_flight(self) -> int:
        """Claims whose batch was tentatively planned + dispatched at
        fill time (a full dedup window admits claims unplanned; those
        re-solve synchronously and do not count as occupancy)."""
        return sum(1 for _, p in self._claims if p)

    def fill_frac(self) -> float:
        """Mean pipeline occupancy: PLANNED in-flight claims / depth,
        averaged over steps (1.0 = the lookahead stayed full and the
        window never refused a plan)."""
        return self._fill_sum / self._fill_steps if self._fill_steps \
            else 0.0

    def spec_hit_rate(self) -> float:
        """Fraction of settled speculative cells that were consumed."""
        tot = self.spec_hits + self.spec_waste
        return self.spec_hits / tot if tot else 0.0

    def spec_waste_frac(self, n_point_solves: int) -> float:
        """Wasted speculative cells over all point-QP cells the device
        actually ran (waited solves + speculative programs dropped
        before their wait -- those never reach the oracle counters)."""
        denom = n_point_solves + self.spec_dropped_unwaited
        return self.spec_waste / denom if denom else 0.0

    # -- fill / claim ------------------------------------------------------

    def fill(self) -> None:
        """Claim + tentatively plan + dispatch future batches until the
        lookahead holds `depth` claims or the unclaimed frontier cannot
        fill a whole batch.  Only full-size batches are claimed: a
        partial batch's membership depends on in-flight verdicts, while
        a full prefix of the deque is exactly what the synchronous loop
        would pop (children append at the back)."""
        if self.depth == 0:
            self.last_fill_wall = 0.0
            return
        t_fill = time.perf_counter()
        eng = self.eng
        B = eng.cfg.batch_simplices
        while len(self._claims) < self.depth:
            off = sum(len(c) for c, _ in self._claims)
            if len(eng.frontier) - off < B:
                break
            nodes = list(itertools.islice(eng.frontier, off, off + B))
            # Bounded window (cfg.dedup_window): when full, claim the
            # batch WITHOUT dispatching -- refusing admission keeps the
            # head claim's in-flight results (evicting oldest-first
            # would drop exactly the rows the next serve() consumes);
            # the skipped batch just re-solves synchronously at its
            # commit.  A single plan may overshoot the cap (soft
            # bound).
            planned = len(self._win) < self.window_cap
            if planned:
                plan = eng._plan_missing(nodes, window=self)
                if plan is not None:
                    self.admit_plan(plan)
            self._claims.append((tuple(nodes), planned))
        # Occupancy counts PLANNED claims only: a claim refused by the
        # full window re-solves synchronously at its commit, and
        # reporting it as fill would hide exactly the degradation the
        # pipeline_fill_frac bench gate exists to catch.
        self._fill_sum += self.planned_in_flight / self.depth
        self._fill_steps += 1
        self.last_fill_wall = time.perf_counter() - t_fill

    def pop_claim(self, nodes: list[int]) -> bool:
        """Consume the head claim if it matches this step's batch.  A
        mismatch is structurally unreachable (claims are full-batch
        frontier prefixes); if it ever happens the whole lookahead is
        cancelled so the build degrades to synchronous, never to a
        wrong tree."""
        if not self._claims:
            return False
        batch, planned = self._claims[0]
        if batch == tuple(nodes):
            self._claims.popleft()
            if planned:
                self.n_pipelined_steps += 1
            return True
        self.cancel()
        return False

    # -- fill-time coverage (consulted by _plan_missing(window=...)) -------

    def covers_grid(self, k: bytes) -> bool:
        """True when an in-flight dense-grid program already covers this
        vertex; tallies the dedup save for non-speculative coverage
        (speculative coverage settles at serve/commit time)."""
        e = self._win.get(k)
        if e is None or not e.grid:
            return False
        if any(not s.prog.spec for s in e.grid):
            self.dedup_saved += int(self.eng.oracle.can.n_delta)
        return True

    def cover_masks(self, k: bytes, donor, nd: int):
        """(real, spec) boolean delta masks of in-flight coverage whose
        route is compatible with a pair-path request carrying `donor`
        (None = cold).  None when the vertex has no window entry.
        Grid sources never cover pair needs -- the two program families
        are not bitwise interchangeable per cell (see _match_cell)."""
        e = self._win.get(k)
        if e is None:
            return None
        real = np.zeros(nd, dtype=bool)
        spec = np.zeros(nd, dtype=bool)
        for d, lst in e.cells.items():
            for s in lst:
                if s.donor is donor:
                    (spec if s.prog.spec else real)[d] = True
        return real, spec

    # -- program admission / dispatch --------------------------------------

    def has_entry(self, k: bytes) -> bool:
        return k in self._win

    def _entry(self, k: bytes) -> _Entry:
        e = self._win.get(k)
        if e is None:
            e = self._win[k] = _Entry()
        return e

    def admit_plan(self, plan: dict,
                   owners: dict[bytes, int] | None = None) -> None:
        """Dispatch a (tentative or speculative) plan's device programs
        and register their rows in the window."""
        spec = owners is not None
        nd = int(self.eng.oracle.can.n_delta)
        if plan["grid_arr"] is not None:
            h = self._dispatch("grid", plan["grid_arr"], None, None)
            prog = _Program("grid", h, (plan["grid_arr"],), spec,
                            plan["grid_arr"].shape[0] * nd)
            for i, k in enumerate(plan["grid_keys"]):
                self._entry(k).grid.append(
                    _Src(prog, i, None, owners.get(k) if spec else None))
                prog.live_refs += 1
        if plan["pair_slices"]:
            h = self._dispatch("pairs", plan["pair_t"], plan["pair_d"],
                               plan["pair_warm"])
            prog = _Program(
                "pairs", h,
                (plan["pair_t"], plan["pair_d"], plan["pair_warm"]),
                spec, plan["pair_t"].shape[0])
            for (k, ds, lo), dnr in zip(plan["pair_slices"],
                                        plan["pair_donors"]):
                e = self._entry(k)
                own = owners.get(k) if spec else None
                for pos, d in enumerate(ds):
                    e.cells.setdefault(int(d), []).append(
                        _Src(prog, lo + pos, dnr, own))
                    prog.live_refs += 1

    def _timed(self, span: str, fn):
        """Run a dispatch/wait thunk under its obs span and charge its
        wall time to eng._oracle_s — the ONE device-time accounting
        point, since _oracle_s drives device_frac and the speculation
        idle-device gate (SPEC_DEVICE_FRAC_MAX)."""
        eng = self.eng
        t0 = time.perf_counter()
        try:
            with eng.obs.span(span):
                return fn()
        finally:
            eng._oracle_s += time.perf_counter() - t0

    def _dispatch(self, kind: str, a, b, warm):
        """Non-blocking oracle dispatch; a dispatch-time device error is
        recorded in the handle and rerouted to the CPU fallback at
        resolve time (same contract as the old prefetch path).  A
        DEGRADED engine (device-failure cap tripped,
        frontier._note_device_failure) mints a ("degraded", kind)
        handle instead of touching the dead device at all: the wait
        routes straight to the CPU twin with no per-batch re-failure."""
        eng = self.eng
        if eng._degraded:
            return ("degraded", kind)

        def go():
            if kind == "grid":
                return eng.oracle.dispatch_vertices(a)
            if warm is not None:
                return eng.oracle.dispatch_pairs(a, b, warm=warm)
            return eng.oracle.dispatch_pairs(a, b)

        try:
            return self._timed("build.dispatch", go)
        except (RuntimeError, OSError) as e:
            return ("failed", e)

    def _wait_pairs(self, handle, args: tuple):
        """Pair-handle wait normalized to the 7-tuple wire format.
        Legacy oracles (and subclasses with their own handle kinds --
        PrunedOracle's 'pruned-chunks') must resolve through wait_pairs,
        not wait_pairs_full."""
        eng = self.eng
        if getattr(eng.oracle, "_point_full_out", False):
            return eng._wait_or_fallback("pairs_full", handle, args)
        out5 = eng._wait_or_fallback("pairs", handle,
                                     (args[0], args[1]))
        return (*out5, None, None)

    def _resolve(self, prog: _Program, background: bool = False):
        """Block on a program's handle (device failures retry on the
        CPU fallback, bit-compatible); memoized.  Thread-safe under
        the per-program lock: the committing thread and the async-
        certify waiter may race to the same program, and exactly one
        performs the wait.  Background resolution charges
        ``overlap_wait_s`` instead of the engine's ``_oracle_s`` (the
        overlap is the point: that wall no longer serializes a
        step)."""
        if prog.out is not None:
            return prog.out
        eng = self.eng
        # eng._oracle_lock (an RLock) serializes this wait against
        # BOTH the waiter thread and the engine's own synchronous
        # oracle calls: the oracle's wait paths mutate shared counters
        # (n_point_solves += K, the iteration ledger, obs batching)
        # and the device-failure/degrade machinery, none of which are
        # thread-safe -- per-program locks alone would let two
        # DIFFERENT programs' waits interleave those read-modify-write
        # updates and silently lose increments the bit-exact parity
        # gates depend on.
        with eng._oracle_lock, prog.lock:
            if prog.out is not None:
                return prog.out
            if prog.kind == "grid":
                span = "build.wait_vertices"

                def fn():
                    return eng._wait_or_fallback(
                        "vertices", prog.handle, prog.args)
            else:
                span = "build.wait_pairs"

                def fn():
                    return self._wait_pairs(prog.handle, prog.args)
            if background:
                # No obs span off-thread (the tracer's span stack is
                # thread-local; a background span would orphan).
                t0 = time.perf_counter()
                prog.out = fn()
                self.overlap_wait_s += time.perf_counter() - t0
                self.n_overlap_resolved += 1
            else:
                prog.out = self._timed(span, fn)
            prog.handle = None
        return prog.out

    # -- asynchronous host-certify (cfg.async_certify) ---------------------

    def _ensure_waiter(self) -> None:
        if self._bg_thread is not None:
            return
        self._bg_q = queue.Queue()

        def loop():
            while True:
                prog = self._bg_q.get()
                try:
                    if prog is None:
                        return
                    try:
                        self._resolve(prog, background=True)
                    except Exception:  # tpulint: disable=silent-except -- overlap is best-effort; the foreground wait re-raises
                        pass
                finally:
                    self._bg_q.task_done()

        self._bg_thread = threading.Thread(
            target=loop, daemon=True, name="ehm-async-certify")
        self._bg_thread.start()

    def prewait(self) -> None:
        """Queue every unresolved, non-speculative in-flight program
        for background resolution -- called by the engine right before
        its certify/commit block, so the device waits of steps k+1..
        overlap the host wall of step k.  A no-op unless
        cfg.async_certify armed the waiter."""
        if not self.async_on:
            return
        self._ensure_waiter()
        seen: set[int] = set()
        for e in self._win.values():
            for src in itertools.chain(
                    e.grid, *e.cells.values()):
                prog = src.prog
                if (prog.spec or prog.queued or prog.out is not None
                        or id(prog) in seen):
                    continue
                seen.add(id(prog))
                prog.queued = True
                self._bg_q.put(prog)

    def quiesce(self) -> None:
        """Stop the background waiter at a safe point: PENDING queue
        entries are dropped UN-resolved (their programs were never
        waited, so -- like the sync build's dropped in-flight handles
        -- the oracle never counts them; resolving them here would
        count device work whose cells cancel() is about to discard),
        then the one program the waiter may currently be resolving is
        allowed to finish (a snapshot must never race a half-resolved
        wait; that single program's wait-time counting is the at-most-
        one-program drift async certify can add at a cancel
        boundary)."""
        if self._bg_q is None:
            return
        while True:
            try:
                prog = self._bg_q.get_nowait()
            except queue.Empty:
                break
            if prog is not None:
                prog.queued = False
            self._bg_q.task_done()
        self._bg_q.join()

    def resolve_vertex(self, k: bytes, nd: int) -> dict | None:
        """Resolve this vertex's in-flight NON-speculative coverage
        into (nd,)-shaped row parts: {"mask","V","conv","grad","u0",
        "z"} -- the sharded frontier's request server uses it so a
        peer's request for a cell this shard already has ON THE DEVICE
        waits the existing program instead of re-solving (counting is
        unaffected: wait-time counters fire once per program, and the
        claim's own serve() later reads the memoized result).  None
        when nothing in flight covers the vertex."""
        e = self._win.get(k)
        if e is None:
            return None
        can = self.eng.oracle.can
        for src in e.grid:
            if src.prog.spec:
                continue
            sol = self._resolve(src.prog)
            i = src.idx
            return {"mask": np.ones(nd, dtype=bool), "V": sol.V[i],
                    "conv": sol.conv[i], "grad": sol.grad[i],
                    "u0": sol.u0[i], "z": sol.z[i]}
        res = None
        for d, lst in e.cells.items():
            for src in lst:
                if src.prog.spec:
                    continue
                out = self._resolve(src.prog)
                if res is None:
                    res = {"mask": np.zeros(nd, dtype=bool),
                           "V": np.full(nd, np.inf),
                           "conv": np.zeros(nd, dtype=bool),
                           "grad": np.zeros((nd, can.n_theta)),
                           "u0": np.zeros((nd, can.n_u)),
                           "z": np.zeros((nd, can.nz))}
                res["mask"][d] = True
                res["V"][d] = out[0][src.idx]
                res["conv"][d] = out[1][src.idx]
                res["grad"][d] = out[2][src.idx]
                res["u0"][d] = out[3][src.idx]
                res["z"][d] = out[4][src.idx]
                break
        return res

    # -- authoritative serve -----------------------------------------------

    def serve(self, plan: dict):
        """Resolve an AUTHORITATIVE plan's results: every route-matched
        cell comes from the window (one solve fanned out to every
        requester); the residual is solved synchronously with the
        authoritative warm data.  Returns (grid_sol, pair_out) shaped
        exactly like the oracle's own wait outputs, so the engine's
        merge code cannot tell the difference.

        Residual programs for BOTH parts dispatch before either part
        blocks (same overlap the legacy plan path had: the pair batch
        queues on the device behind the grid batch instead of waiting
        for its transfer)."""
        eng = self.eng
        can = eng.oracle.can
        nd = int(can.n_delta)
        gprep = pprep = None
        if plan["grid_arr"] is not None:
            gprep = self._prep_grid(plan)
        if plan["pair_slices"]:
            pprep = self._prep_pairs(plan)
        grid_sol = self._finish_grid(plan, can, nd, *gprep) \
            if gprep is not None else None
        pair_out = self._finish_pairs(plan, can, *pprep) \
            if pprep is not None else None
        # Window copies of the deltas THIS plan merges are redundant
        # from here on (later requesters hit the cache row), so they
        # retire now.  Other claims' in-flight cells for OTHER deltas
        # of the same vertex stay: the cache row being written does not
        # cover them, and dropping them would force their claims to
        # re-solve work the device already ran.
        for k in plan["grid_keys"]:
            self._pop_entry(k)
        for k, ds, _lo in plan["pair_slices"] or ():
            self._drop_cells(k, ds)
        return grid_sol, pair_out

    def _prep_grid(self, plan: dict):
        """Window lookup + residual dispatch (non-blocking) for the
        grid part: (srcs, miss, handle)."""
        srcs = []
        for k in plan["grid_keys"]:
            e = self._win.get(k)
            srcs.append(e.grid[0] if e is not None and e.grid else None)
        miss = [i for i, s in enumerate(srcs) if s is None]
        h = None
        if miss:
            arr = (plan["grid_arr"] if len(miss) == len(srcs)
                   else plan["grid_arr"][np.asarray(miss,
                                                    dtype=np.int64)])
            h = self._dispatch("grid", arr, None, None)
        return srcs, miss, h

    def _finish_grid(self, plan: dict, can, nd: int, srcs, miss, h):
        eng = self.eng
        keys = plan["grid_keys"]
        if len(miss) == len(srcs):
            # Nothing in flight (synchronous tail / depth 0): wait the
            # whole dispatched grid directly -- the legacy path.
            return self._timed(
                "build.wait_vertices",
                lambda: eng._wait_or_fallback(
                    "vertices", h, (plan["grid_arr"],)))
        P = len(keys)
        nt, nu, nz, nc = can.n_theta, can.n_u, can.nz, can.nc
        have_lam = bool(getattr(eng.oracle, "_point_full_out", False))
        V = np.empty((P, nd))
        conv = np.empty((P, nd), dtype=bool)
        grad = np.empty((P, nd, nt))
        u0 = np.empty((P, nd, nu))
        z = np.empty((P, nd, nz))
        Vs = np.empty(P)
        dstar = np.empty(P, dtype=np.int64)
        lam = np.empty((P, nd, nc)) if have_lam else None
        s = np.empty((P, nd, nc)) if have_lam else None
        by_prog: dict[int, tuple[_Program, list[int]]] = {}
        for i, src in enumerate(srcs):
            if src is not None:
                by_prog.setdefault(id(src.prog),
                                   (src.prog, []))[1].append(i)
        for prog, idxs in by_prog.values():
            sol = self._resolve(prog)
            ii = np.asarray(idxs, dtype=np.int64)
            jj = np.asarray([srcs[i].idx for i in idxs], dtype=np.int64)
            V[ii], conv[ii], grad[ii] = sol.V[jj], sol.conv[jj], \
                sol.grad[jj]
            u0[ii], z[ii] = sol.u0[jj], sol.z[jj]
            Vs[ii], dstar[ii] = sol.Vstar[jj], sol.dstar[jj]
            if have_lam:
                lam[ii], s[ii] = sol.lam[jj], sol.s[jj]
            prog.n_used += len(idxs) * nd
            if prog.spec:
                self.spec_hits += len(idxs) * nd
        if miss:
            mi = np.asarray(miss, dtype=np.int64)
            arr = plan["grid_arr"][mi]
            sol = self._timed(
                "build.wait_vertices",
                lambda: eng._wait_or_fallback("vertices", h, (arr,)))
            V[mi], conv[mi], grad[mi] = sol.V, sol.conv, sol.grad
            u0[mi], z[mi] = sol.u0, sol.z
            Vs[mi], dstar[mi] = sol.Vstar, sol.dstar
            if have_lam:
                lam[mi], s[mi] = sol.lam, sol.s
        return types.SimpleNamespace(V=V, conv=conv, grad=grad, u0=u0,
                                     z=z, Vstar=Vs, dstar=dstar, lam=lam,
                                     s=s)

    @staticmethod
    def _donor_equal(r1, r2, d: int) -> bool:
        """Bitwise equality of the donor cells a warm start actually
        reads (a widened cache row replaces the tuple, so identity
        misses rows whose delta-d slices never changed).  equal_nan:
        rescued cells carry NaN dual slots by design, and two rows
        identical up to those NaNs produce the identical warm tuple
        (the isfinite-gated `has` mask is False on both sides)."""
        if r1 is None or r2 is None or r1[8] is None or r2[8] is None:
            return False
        return (bool(r1[1][d]) == bool(r2[1][d])
                and bool(np.array_equal(r1[4][d], r2[4][d],
                                        equal_nan=True))
                and bool(np.array_equal(r1[8][d], r2[8][d],
                                        equal_nan=True))
                and bool(np.array_equal(r1[9][d], r2[9][d],
                                        equal_nan=True)))

    def _match_cell(self, e: _Entry, d: int, donor):
        """Route-matched window source for one pair cell, or None.
        Pair sources must carry the SAME donor row (identity, or
        bitwise-equal donor cells).  A dense-grid source is NEVER
        served to a pair-route need: the grid and pair program families
        are different batched programs whose per-cell results can
        differ in the last ulp (measured: ~1e-16 drift on pendulum leaf
        payloads), and the bit-identity contract is family-exact, not
        just decision-exact."""
        for src in e.cells.get(d, ()):
            if src.donor is donor or self._donor_equal(src.donor, donor,
                                                       d):
                return src
        return None

    def _prep_pairs(self, plan: dict):
        """Window lookup + residual dispatch (non-blocking) for the
        pair part: (srcs, miss, handle)."""
        K = plan["pair_t"].shape[0]
        warm = plan["pair_warm"]
        srcs: list = [None] * K
        for (k, ds, lo), dnr in zip(plan["pair_slices"],
                                    plan["pair_donors"]):
            e = self._win.get(k)
            if e is None:
                continue
            for pos, d in enumerate(ds):
                srcs[lo + pos] = self._match_cell(e, int(d), dnr)
        miss = [i for i, s in enumerate(srcs) if s is None]
        h = None
        if miss:
            if len(miss) == K:
                h = self._dispatch("pairs", plan["pair_t"],
                                   plan["pair_d"], warm)
            else:
                mi = np.asarray(miss, dtype=np.int64)
                wa = (tuple(w[mi] for w in warm)
                      if warm is not None else None)
                h = self._dispatch("pairs", plan["pair_t"][mi],
                                   plan["pair_d"][mi], wa)
        return srcs, miss, h

    def _finish_pairs(self, plan: dict, can, srcs, miss, h):
        eng = self.eng
        K = plan["pair_t"].shape[0]
        warm = plan["pair_warm"]
        nt, nu, nz, nc = can.n_theta, can.n_u, can.nz, can.nc
        if len(miss) == K:
            # Nothing in flight: wait the whole dispatched batch
            # directly -- the legacy path.
            return self._timed(
                "build.wait_pairs",
                lambda: self._wait_pairs(
                    h, (plan["pair_t"], plan["pair_d"], warm)))
        have_lam = bool(getattr(eng.oracle, "_point_full_out", False))
        V = np.empty(K)
        conv = np.empty(K, dtype=bool)
        grad = np.empty((K, nt))
        u0 = np.empty((K, nu))
        z = np.empty((K, nz))
        lam = np.empty((K, nc)) if have_lam else None
        s = np.empty((K, nc)) if have_lam else None
        by_prog: dict[int, tuple[_Program, list[int]]] = {}
        for flat, src in enumerate(srcs):
            if src is not None:
                by_prog.setdefault(id(src.prog),
                                   (src.prog, []))[1].append(flat)
        for prog, idxs in by_prog.values():
            # Always a pair-family program (_match_cell is family-
            # exact), so `out` is the 7-tuple wire format.
            out = self._resolve(prog)
            ii = np.asarray(idxs, dtype=np.int64)
            jj = np.asarray([srcs[i].idx for i in idxs], dtype=np.int64)
            V[ii], conv[ii] = out[0][jj], out[1][jj]
            grad[ii], u0[ii], z[ii] = out[2][jj], out[3][jj], out[4][jj]
            if have_lam:
                lam[ii], s[ii] = out[5][jj], out[6][jj]
            prog.n_used += len(idxs)
            if prog.spec:
                self.spec_hits += len(idxs)
        if miss:
            mi = np.asarray(miss, dtype=np.int64)
            ta, da = plan["pair_t"][mi], plan["pair_d"][mi]
            wa = (tuple(w[mi] for w in warm)
                  if warm is not None else None)
            out = self._timed(
                "build.wait_pairs",
                lambda: self._wait_pairs(h, (ta, da, wa)))
            V[mi], conv[mi], grad[mi] = out[0], out[1], out[2]
            u0[mi], z[mi] = out[3], out[4]
            if have_lam and out[5] is not None:
                lam[mi], s[mi] = out[5], out[6]
        return V, conv, grad, u0, z, lam, s

    # -- speculation -------------------------------------------------------

    def note_children(self, li: int, ri: int, gap: float) -> None:
        """Record the split gap of a fresh split as the children's
        split-prediction hint (read once when their batch consumes)."""
        if self.spec_on:
            self._child_gap[li] = gap
            self._child_gap[ri] = gap

    def speculate(self, nodes: list[int]) -> None:
        """Dispatch the bisection-midpoint programs of every batch cell
        the gap heuristic predicts will split -- called after the
        batch's own rows landed in the cache (donor rows final) and
        BEFORE its certificates run, so the device chews on the next
        generation while the host certifies this one."""
        hints = {n: self._child_gap.pop(n, None) for n in nodes}
        if not self.spec_on:
            return
        eng = self.eng
        # Idle-device gate: when recent steps were device-bound the
        # speculative batch would only queue behind real work (see
        # SPEC_DEVICE_FRAC_MAX).  The hints above are still consumed --
        # they are one-shot either way.
        if eng.device_frac_ema > self.SPEC_DEVICE_FRAC_MAX:
            return
        if len(self._win) >= self.window_cap:
            return  # bounded window: see fill()
        # The only population whose split is predictable BEFORE its
        # certificate is the cells whose inherited gap is INFINITE --
        # i.e. whose parent split on mixed vertex feasibility or an
        # inconclusive infeasibility check: the hybrid feasible set's
        # boundary crosses the parent, so (almost) every child
        # straddles it and must split again.  Measured on the pendulum
        # (eps_a 0.05 and 0.02): children of gap=inf splits re-split at
        # 100%, while children of FINITE-gap splits re-split at ~0.49
        # independent of gap magnitude (bisection localizes the error
        # into one child, so the parent's scalar gap carries ~1 bit) --
        # a finite-gap threshold, however tuned, would waste nearly
        # one solve per hit, so no such knob exists.
        sb = eng.cfg.semi_explicit_boundary_depth
        cands = [n for n in nodes
                 if hints[n] is not None and hints[n] == np.inf
                 and eng.tree.depth[n] < eng.cfg.max_depth
                 # A predicted-mixed cell at the semi-explicit closure
                 # depth closes as a boundary leaf instead of splitting.
                 and (sb is None or eng.tree.depth[n] < sb)]
        if not cands:
            return
        planned = eng._plan_spec_children(cands, window=self)
        if planned is None:
            return
        plan, owners = planned
        self.admit_plan(plan, owners=owners)
        for k, n in owners.items():
            self._spec_keys.setdefault(n, []).append(k)

    def on_commit(self, n: int, split: bool) -> None:
        """Settle node n's speculation: a split leaves the staged
        midpoint rows for the children to consume; anything else drops
        them before they can reach a cache row (waste)."""
        keys = self._spec_keys.pop(n, None)
        if keys is None or split:
            return
        for k in keys:
            e = self._win.get(k)
            if e is None:
                continue
            kept = []
            for src in e.grid:
                if src.owner == n:
                    self._drop_ref(src.prog)
                else:
                    kept.append(src)
            e.grid = kept
            for d in list(e.cells):
                lst = []
                for src in e.cells[d]:
                    if src.owner == n:
                        self._drop_ref(src.prog)
                    else:
                        lst.append(src)
                if lst:
                    e.cells[d] = lst
                else:
                    del e.cells[d]
            if not e.grid and not e.cells:
                self._win.pop(k, None)

    # -- retirement / cancel ----------------------------------------------

    def _drop_ref(self, prog: _Program) -> bool:
        prog.live_refs -= 1
        if prog.live_refs <= 0 and not prog.retired:
            prog.retired = True
            if prog.spec:
                unused = max(0, prog.n_cells - prog.n_used)
                self.spec_waste += unused
                if prog.out is None:
                    # Dropped before anyone waited: the device ran the
                    # work but it never reached the oracle's solve
                    # counters -- tracked so spec_waste_frac's
                    # denominator stays "cells the device actually ran".
                    self.spec_dropped_unwaited += unused
        return True

    def _pop_entry(self, k: bytes) -> None:
        e = self._win.pop(k, None)
        if e is None:
            return
        for src in e.grid:
            self._drop_ref(src.prog)
        for lst in e.cells.values():
            for src in lst:
                self._drop_ref(src.prog)

    def _drop_cells(self, k: bytes, ds) -> None:
        """Retire one vertex's window sources for the deltas a served
        plan just merged, plus any dense-grid sources (the cache row
        now exists, and grid coverage is only ever consulted for
        row-less vertices, so they are dead weight).  Pair sources for
        other deltas stay to serve the claims that dispatched them."""
        e = self._win.get(k)
        if e is None:
            return
        for src in e.grid:
            self._drop_ref(src.prog)
        e.grid = []
        for d in map(int, ds):
            lst = e.cells.pop(d, None)
            if lst:
                for src in lst:
                    self._drop_ref(src.prog)
        if not e.cells:
            self._win.pop(k, None)

    def cancel(self) -> None:
        """Drop every in-flight claim, window row, and handle.  Called
        before a checkpoint serializes (so a resume can never
        re-dispatch or double-commit in-flight work) and at the end of
        a run.  Dispatched-but-unwaited programs were never counted by
        the oracle, so solve statistics stay exact.  (Under
        cfg.async_certify, quiesce() drops the waiter's PENDING work
        un-resolved for the same reason; only a program mid-resolve at
        this instant is waited-and-counted -- an at-most-one-program
        stats drift per cancel, never a tree change.)"""
        self.quiesce()
        if self._bg_thread is not None:
            # Shut the waiter down for real: a daemon thread parked in
            # get() would otherwise pin the whole engine (tree, cache,
            # oracle) through its closure for the life of the process
            # -- one leaked build per async-certify run in long-lived
            # hosts.  prewait() restarts a fresh one on demand.
            self._bg_q.put(None)
            self._bg_q.join()
            self._bg_thread.join(timeout=5.0)
            self._bg_thread = None
            self._bg_q = None
        for k in list(self._win):
            self._pop_entry(k)
        self._claims.clear()
        self._spec_keys.clear()
