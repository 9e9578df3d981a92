"""Run configuration.

The reference keeps runtime constants in a module of globals plus argparse
flags (SURVEY.md section 3, "Global config", [M-med]); here a single frozen
dataclass is threaded through the stack instead, with the CLI (main.py)
populating it for parity.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

#: Largest padding bucket a single evaluator call may mint when the
#: deploy config leaves max_bucket unset (ServeConfig validates
#: max_batch against it).
DEFAULT_MAX_BUCKET = 1 << 14


def is_pow2(n: int) -> bool:
    """True when `n` is a positive power of two -- the one batching
    validity check, shared by ServeConfig and the scheduler so their
    contracts cannot drift."""
    return n >= 1 and not (n & (n - 1))


@dataclasses.dataclass(frozen=True)
class PartitionConfig:
    """Configuration for an offline partition build.

    Mirrors the reference CLI surface (example name, eps_a/eps_r, algorithm
    variant, process count -- SURVEY.md section 2 L8) with device-native fields
    (backend, batch size) replacing the MPI process count.
    """

    # Which benchmark problem (problems/registry.py).
    problem: str = "double_integrator"
    # Problem constructor overrides as a sorted (key, value) pair tuple
    # (tuple: hashable-ish + frozen-friendly).  Recorded so checkpoints pin
    # the EXACT problem: resuming with different constructor args changes
    # matrix shapes and corrupts the solve cache (found by e2e verify r3).
    problem_args: tuple = ()
    # Absolute suboptimality tolerance (eps_a <= 0 disables the check).
    eps_a: float = 1e-2
    # Relative suboptimality tolerance (eps_r <= 0 disables the check).
    eps_r: float = 0.0
    # 'suboptimal' = fully-explicit eps-suboptimal partition (the reference's
    # L-CSS algorithm); 'feasible' = semi-explicit feasibility-only partition
    # (the reference's ECC algorithm).  SURVEY.md section 1 "two variants" [P].
    algorithm: str = "suboptimal"
    # Oracle execution backend: 'cuda' (the first CUDA device; raises
    # when there is none -- a build never carries on on the CPU unasked)
    # vs 'cpu' (the same solver with each kernel's plain torch version).
    backend: str = "cuda"
    # Device-batch padding size for the frontier solve (static shape; the
    # frontier is packed/padded to this many simplices per step).
    batch_simplices: int = 256
    # Maximum tree depth (safety valve against runaway subdivision).
    max_depth: int = 40
    # Maximum number of frontier steps.
    max_steps: int = 10_000
    # Wall-clock budget for the build loop in seconds (None = unlimited).
    # Exceeding it stops cleanly after the current step with
    # stats['truncated']=True -- the benchmark capture's guarantee that a
    # number is produced on ANY platform within the capture window.
    time_budget_s: Optional[float] = None
    # Snapshot the frontier + tree every N steps (0 disables).  SURVEY.md
    # section 6.4: build obligation "frontier checkpointing".
    checkpoint_every: int = 0
    checkpoint_path: Optional[str] = None
    # Structured JSONL metrics stream (SURVEY.md section 6.5).
    log_path: Optional[str] = None
    # Mesh axis size for sharding the solve batch (None = all local devices).
    mesh_devices: Optional[int] = None
    # Profiler trace output directory (None disables).  Not yet ported:
    # a non-None value raises (ROADMAP A2).
    profile_path: Optional[str] = None
    profile_steps: int = 5
    # IPM precision schedule: 'f64' (every iteration in float64) or
    # 'mixed' (f32 bulk + f64 polish to the same KKT tolerance).
    precision: str = "f64"
    # Optional (n_f32, n_f64) schedule override for the POINT-class IPM
    # programs only (the joint simplex programs keep the full schedule;
    # they need it).  Pair with ipm_rescue_iters so schedule misses cost
    # one extra solve instead of certification failures.
    ipm_point_schedule: Optional[tuple] = None
    # Full-length cold-f64 re-solve of feasible-but-unconverged point
    # solves (0 disables).  See Oracle(rescue_iter=...).
    ipm_rescue_iters: int = 0
    # Two-phase early-exit cohort solve (Oracle(two_phase=...)): run a
    # short first-phase f64 schedule on every point/elastic-simplex QP,
    # read the converged mask on host, and finish only the unconverged
    # survivors (compacted into a fresh power-of-two bucket) with the
    # remaining iterations, warm-started from their own phase-1
    # iterates through the kernel's merit gate.  Per-instance
    # deterministic; the sound Farkas/phase-1 programs stay
    # single-phase.  Ignored by backend='serial' (the conservative
    # fixed-schedule baseline) and mesh-sharded oracles.
    ipm_two_phase: bool = True
    # f64 iterations in the cohort's first phase (clamped per program
    # class to its f64 schedule length); None = 2/5 of the class
    # schedule.
    ipm_phase1_iters: Optional[int] = None
    # Per-class phase-1 overrides (the point-class and
    # joint-simplex programs converge at very different rates, and one
    # shared phase1_iters forces a compromise -- wasted_iter_frac 0.27
    # on the tier-1 bench).  Each overrides ipm_phase1_iters for its
    # class only; None preserves the shared value / auto 2/5 split.
    ipm_phase1_iters_point: Optional[int] = None
    ipm_phase1_iters_simplex: Optional[int] = None
    # IPM leg dispatch (oracle/ipm_leg.py): 'auto' follows the oracle's
    # device (CUDA -> the hand-written CUDA kernel that runs a whole
    # fixed-iteration predictor-corrector leg per launch, CPU -> its
    # plain torch version); 'cuda' / 'torch' name one explicitly and
    # raise where it cannot run ('cuda' on the CPU, 'torch' on a CUDA
    # oracle).  Schedules, cohort splits, and warm-start gating are
    # shared code; only per-iteration arithmetic ordering differs.
    ipm_kernel: str = "auto"
    # Tree warm-starts (Oracle(warm_start=...)): cache the oracle's
    # final duals/slacks per vertex row and feed a cached sibling
    # vertex's iterates as the IPM start for new bisection midpoints,
    # through the same merit gate (a bad donor falls back to the cold
    # start, so certificates cannot degrade -- only iteration counts
    # change).
    warm_start_tree: bool = True
    # Dispatch future frontier batches' point solves while the host
    # certifies the current batch (asynchronous CUDA launches; results consumed
    # when their step commits).  False forces the strictly-synchronous
    # solve -> certify -> solve loop and is the legacy kill switch:
    # prefetch_solves=False == pipeline_depth=0, and prefetch_solves=True
    # with pipeline_depth=1 reproduces the old single-slot prefetch.
    prefetch_solves: bool = True
    # Bounded asynchronous build pipeline (partition/pipeline.py): up to
    # this many frontier batches are planned AND dispatched ahead of the
    # committing step, so plan(k+2)/dispatch(k+2) run while wait(k+1)
    # resolves and commit(k) writes the tree.  Commits stay strictly
    # ordered and every step re-plans authoritatively against the
    # serial-point cache state before writing rows, so the produced
    # tree is node-for-node BIT-IDENTICAL to the pipeline_depth=0 build
    # at any depth (same regions, vertex matrices, leaf commutations
    # and statuses; see partition/pipeline.py for the one caveat on
    # last-ulp payload floats served across pow-2 buckets).  Only
    # full-size batches are claimed ahead (a partial batch's membership
    # depends on in-flight verdicts); 0 = fully synchronous.
    pipeline_depth: int = 2
    # Speculative child dispatch: when the inherited-gap heuristic
    # predicts a frontier cell will SPLIT (inherited certificate gap
    # INFINITE -- the mixed-feasibility boundary population, the only
    # one whose re-split is predictable; finite-gap children re-split
    # at ~0.49 regardless of magnitude), its children's shared new
    # vertex (the longest-edge bisection midpoint) is dispatched before
    # the cell's own verdict lands.  A hit overlaps the child's point
    # solves with host certification; a mis-speculation is dropped
    # before commit, so the tree stays bit-identical either way and
    # only spec_waste grows.  Speculation is an idle-device filler: it
    # self-gates on the rolling device-busy fraction
    # (pipeline.SPEC_DEVICE_FRAC_MAX) and stays dormant while the
    # device is already the bottleneck.  Requires pipeline_depth >= 1;
    # eps_r-only builds never speculate (the predictor was only
    # validated on eps_a builds).
    speculate: bool = True
    # Cross-batch vertex-dedup window (partition/pipeline.py): maximum
    # distinct in-flight vertices whose dispatched (delta, vertex)
    # programs are tracked for coalescing.  Duplicate requests across
    # the whole in-flight window (sibling bisection midpoints, batch-
    # boundary overlaps the old prefetch re-solved) collapse into one
    # device solve fanned back out to every requester.  A full window
    # refuses new lookahead/speculative admissions (those batches just
    # solve synchronously at their commit) -- correctness is
    # unaffected.
    dedup_window: int = 8192
    # Inherit per-commutation stage-2 facts (Farkas infeasibility
    # exclusions, simplex-min lower bounds) from parent to children across
    # bisections.  Certified-exact decision parity with the uninherited
    # build (frontier.py step(); tests/test_partition.py); False exists for
    # that parity test and for debugging.
    inherit_bounds: bool = True
    # Skip point solves for commutations Farkas-excluded on an ancestor
    # simplex (every vertex of a child lies inside the ancestor, so the
    # excluded commutation's point QP is infeasible by certificate --
    # solving it is pure waste; deep subdivision tails spend most of their
    # point-solve work there).  Requires inherit_bounds; single-device
    # oracles only (a mesh-sharded oracle keeps the dense grid so the
    # batch still shards).  Tree-identical to the unmasked build
    # (tests/test_partition.py).
    mask_point_solves: bool = True
    # Compose the two algorithm variants on feasible-set-boundary cells
    # (round-3 verdict item 4): a simplex whose vertices have MIXED
    # feasibility can never pass a whole-simplex certificate (the
    # boundary crosses it), so at depth >= this it closes as a
    # SEMI-EXPLICIT leaf -- certified-feasible commutation on the
    # converged-vertex hull, online fixed-delta QP at the query point --
    # instead of splitting until max_depth and leaving a hole.  None
    # disables (pure variant behavior).  Reported separately from
    # certified volume (post.analysis, stats['semi_explicit']).
    semi_explicit_boundary_depth: Optional[int] = None
    # Prune constraint rows (and decoupled slack vars) that a sampled
    # solve shows never active on the box, with per-instance KKT-verified
    # fallback to the full problem (oracle/prune.py).  Point-class
    # programs only; exact by construction.  Big win on row-heavy
    # configs (quadrotor: 360 -> ~100 rows); off by default.
    prune_rows: bool = False
    # Store the (p+1, nz) full primal sequences per converged leaf
    # (LeafData.vertex_z).  They feed the offline sampled-soundness
    # checks (scripts/precision_check.py) and full-sequence
    # interpolation, NOT the deployed first-move controller; at
    # cluster scale they are the single largest leaf payload (~1 GB per
    # 0.8M satellite leaves), so multi-million-region campaigns can turn
    # them off (scripts/long_build.py LONG_STORE_Z=0).
    store_vertex_z: bool = True
    # Compute each split's descent hyperplane AT SPLIT TIME (one small
    # nullspace solve inside Tree.split, amortized into the device-bound
    # build) so online.descent.export_descent is pure array slicing
    # instead of a post-hoc batched SVD over every internal node (1129 s
    # at the 9.8M-leaf satellite).  False exists for the parity tests
    # and for measuring the amortized cost itself.
    split_hyperplanes: bool = True
    # Observability (obs/): 'off' = every hook a
    # shared no-op; 'jsonl' = spans/events/metric snapshots stream to
    # obs_path (in-memory only when obs_path is None); 'full' = jsonl
    # plus torch.profiler.record_function passthrough on host spans, so
    # a profiler trace shows the frontier's host regions aligned with
    # the kernels they launched.  Distinct from log_path (the
    # legacy flat per-step RunLog stream, kept for existing consumers).
    obs: str = "off"
    obs_path: Optional[str] = None
    # Per-process obs streams (obs/fleet.py): suffix obs_path with
    # .p<process_index>-<pid>, so N processes sharing one configured
    # path (supervised restart chains, multi-process pjit builds)
    # write N separate streams instead of interleaving one file -- a
    # crashed writer's torn line mid-file would make load_jsonl reject
    # the whole stream.  Readers resolve the bare name transparently;
    # obs_report/obs_watch --fleet merge the family.
    obs_per_process: bool = False
    # Health-triggered bounded device profiling (obs/profiling.py
    # AutoProfiler): the first CRITICAL in-build health verdict
    # (stall, quarantine storm, ...; needs cfg.health_rules + obs on)
    # opens a profiler capture bounded to profile_steps frontier
    # steps and drops a summarized auto_profile JSON bundle next to
    # the recorder's -- a sick long build self-captures the evidence
    # instead of burning the allocation.  At most one capture per run;
    # ignored while cfg.profile_path runs a manual trace (one active
    # trace at a time).  Not yet ported: True raises.
    auto_profile: bool = False
    # Flight recorder (obs/recorder.py): when True, solver anomalies --
    # cells still feasible-but-unconverged after the two-phase cohort
    # and the rescue pass, simplex rows with no usable bound, device-
    # failure batches, depth-capped uncertified leaves -- are dumped as
    # versioned compressed repro bundles under `recorder_dir`;
    # scripts/replay_solve.py re-runs a bundle standalone and must
    # reproduce the converged/diverged mask bit-for-bit.  Works with
    # obs='off' too (the recorder's ring is just empty then); every
    # hook is a None-check when disabled.
    obs_recorder: bool = False
    # Bundle directory (default artifacts/repro).  Setting it IMPLIES
    # obs_recorder -- naming a bundle directory while recording nothing
    # would be a silent no-op trap (frontier._init_diagnostics).
    recorder_dir: Optional[str] = None
    # Streaming health rules as (name, value) override pairs on
    # obs.health.DEFAULT_RULES (tuple: frozen-friendly, like
    # problem_args).  Non-empty AND obs enabled => the frontier engine
    # feeds an in-stream HealthMonitor per step (plus a periodic
    # metrics snapshot) and structured health.* events land in the obs
    # stream.  scripts/obs_watch.py applies the same schema to a live
    # stream from outside the process.
    health_rules: tuple = ()
    # Incremental warm rebuild (partition/rebuild.py): path to a prior
    # build's .tree.pkl or .ckpt.pkl.  When set, build_partition
    # transfers the prior tree, re-certifies its leaves in bulk against
    # THIS config's problem/eps/oracle, and subdivides only what the
    # revision invalidated -- an unchanged problem rebuilds
    # node-for-node bit-identical with zero subdivision solves.  CLI:
    # the `rebuild` subcommand / --rebuild-from.  None = cold build.
    rebuild_from: Optional[str] = None
    # Refuse rebuild priors that carry no provenance stamp (legacy
    # artifacts cannot be validated against the revision); the default
    # shims them with a stats note.
    rebuild_strict_provenance: bool = False
    # Runtime recompile sentinel (analysis/recompile_guard.py): once
    # the build has run a warmup of FULL-size batches (the compiled-
    # shape set is complete by then -- pow-2 padding bounds it), any
    # NEW oracle program shape minted during a subsequent full-size
    # step is an unexpected recompilation.  'warn' emits a
    # health.recompile event into the obs stream (and the in-build
    # HealthMonitor's verdict); 'raise' aborts the build (CI mode);
    # 'off' adds no per-step work.  Ramp-up and drain-down steps
    # (partial batches) are exempt: small final batches legitimately
    # mint new pow-2 buckets.
    recompile_guard: str = "off"
    # Bounded-recovery policy around oracle solves (faults/policy.py
    # RetryPolicy; docs/robustness.md).  solve_timeout_s arms a
    # watchdog around EVERY oracle attempt -- a wedged solve raises
    # SolveTimeout and takes the device-failure recovery path instead
    # of hanging the build (None = off: the watchdog costs one thread
    # hop per synchronous oracle call).
    solve_timeout_s: Optional[float] = None
    # CPU-twin retry attempts (with exponential backoff starting at
    # oracle_retry_backoff_s) after a device failure before the batch's
    # cells are QUARANTINED: synthesized conservative no-information
    # results (+inf/unconverged points, -inf no-bound simplex rows) let
    # the build continue soundly -- affected cells split or close
    # uncertified, never certify wrong.  Quarantined counts surface in
    # stats['quarantined_cells'] / the build.quarantined_cells counter
    # and are gated by the max_quarantine_frac health rule.
    oracle_retry_attempts: int = 2
    oracle_retry_backoff_s: float = 0.05
    # Total device failures tolerated before the engine DEGRADES to
    # the CPU fallback oracle permanently (faults.device_degraded
    # event): a dead accelerator costs the dispatch-fail-fallback tax
    # once, not on every remaining batch of a multi-hour campaign.
    # (Not a padding bucket -- a failure COUNT; pow-2 is meaningless.)
    device_failure_cap: int = 3  # tpulint: disable=recompile-hazard -- failure count, not a shape
    # Pod-scale sharded frontier (partition/shard.py; docs/perf.md
    # "Sharded frontier").  When True and more than one shard resolves
    # (shard_count, else the process count), each process runs the
    # pipelined frontier over its OWN round-robin share of the root
    # simplices with its oracle on its local devices -- no lockstep
    # host replication, no per-step collectives.  Cross-shard vertex
    # dedup goes through the asynchronous exchange under shard_dir
    # (a directory every shard can reach): a deterministic ownership
    # hash assigns every (vertex, delta) cell to exactly one shard,
    # so summed point_solves equal the single-process build's.  The
    # merged tree is node-for-node identical to the single-process
    # build (canonical comparison; payload-ulp caveat documented).
    # Single-process runs (or shard_count 1) are behavior-identical
    # to shard_frontier=False.
    shard_frontier: bool = False
    # Exchange/result directory shared by every shard (required when
    # sharding is active; the CLI derives <output>.shard).
    shard_dir: Optional[str] = None
    # Explicit shard coordinates (tests / external launchers); None =
    # the process's rank / world size.
    shard_index: Optional[int] = None
    shard_count: Optional[int] = None
    # Budget for a remote cell before the requester re-solves it
    # locally (liveness over the zero-duplicate guarantee -- loud:
    # shard.request_timeout event + shard.fallback_cells counter).
    shard_timeout_s: float = 300.0
    # Asynchronous host-certify (partition/pipeline.py): a background
    # waiter thread resolves the in-flight lookahead programs of steps
    # k+1.. WHILE the main thread runs step k's certify/commit host
    # wall, so the serialized cp_wait share of the next step shrinks
    # (the results are the identical device programs, resolved
    # earlier: trees are bit-identical with the flag on or off).  Off
    # by default; bench.py --multichip measures the cp-breakdown
    # delta.
    async_certify: bool = False
    # Deterministic fault-injection plan (faults/plan.py FaultPlan, a
    # dict, or a path to a plan JSON; the EHM_FAULT_PLAN env var is the
    # subprocess surface).  None = no injection (the production
    # default: every hook is one global None-test).  Chaos testing
    # only -- scripts/chaos_suite.py is the pre-merge consumer.
    fault_plan: Optional[object] = None
    seed: int = 0

    def __post_init__(self) -> None:
        if self.algorithm not in ("suboptimal", "feasible"):
            raise ValueError(f"unknown algorithm {self.algorithm!r}")
        if self.obs not in ("off", "jsonl", "full"):
            raise ValueError(f"unknown obs mode {self.obs!r} "
                             "(expected 'off', 'jsonl', or 'full')")
        if self.eps_a <= 0 and self.eps_r <= 0 and self.algorithm == "suboptimal":
            raise ValueError("suboptimal variant needs eps_a > 0 or eps_r > 0")
        if (self.semi_explicit_boundary_depth is not None
                and self.semi_explicit_boundary_depth < 0):
            raise ValueError("semi_explicit_boundary_depth must be >= 0")
        if self.ipm_phase1_iters is not None and self.ipm_phase1_iters < 1:
            raise ValueError("ipm_phase1_iters must be >= 1 (or None for "
                             "the automatic 2/5 split)")
        for fld in ("ipm_phase1_iters_point", "ipm_phase1_iters_simplex"):
            v = getattr(self, fld)
            if v is not None and v < 1:
                raise ValueError(f"{fld} must be >= 1 (or None to "
                                 "inherit ipm_phase1_iters / the auto "
                                 "split)")
        if self.backend not in ("cuda", "cpu"):
            raise ValueError(f"unknown backend {self.backend!r} "
                             "(expected 'cuda' or 'cpu')")
        if self.ipm_kernel not in ("auto", "cuda", "torch"):
            raise ValueError(f"unknown ipm_kernel {self.ipm_kernel!r} "
                             "(expected 'auto', 'cuda', or 'torch')")
        if self.pipeline_depth < 0:
            raise ValueError("pipeline_depth must be >= 0 "
                             "(0 = synchronous build)")
        if self.dedup_window < 1:
            raise ValueError("dedup_window must be >= 1")
        if self.recompile_guard not in ("off", "warn", "raise"):
            raise ValueError(f"unknown recompile_guard "
                             f"{self.recompile_guard!r} (expected 'off', "
                             "'warn', or 'raise')")
        if self.solve_timeout_s is not None and self.solve_timeout_s <= 0:
            raise ValueError("solve_timeout_s must be > 0 (or None "
                             "to disable the solve watchdog)")
        if self.oracle_retry_attempts < 1:
            raise ValueError("oracle_retry_attempts must be >= 1")
        if self.oracle_retry_backoff_s < 0:
            raise ValueError("oracle_retry_backoff_s must be >= 0")
        if self.device_failure_cap < 1:
            raise ValueError("device_failure_cap must be >= 1")
        if self.shard_timeout_s <= 0:
            raise ValueError("shard_timeout_s must be > 0")
        if self.shard_count is not None and self.shard_count < 1:
            raise ValueError("shard_count must be >= 1")
        if self.shard_index is not None:
            if self.shard_index < 0:
                raise ValueError("shard_index must be >= 0")
            if (self.shard_count is not None
                    and self.shard_index >= self.shard_count):
                raise ValueError(
                    f"shard_index {self.shard_index} out of range for "
                    f"shard_count {self.shard_count}")
        for fld, on, item in _UNPORTED:
            if on(getattr(self, fld)):
                raise NotImplementedError(
                    f"PartitionConfig.{fld} is not yet ported to the "
                    f"torch package (ROADMAP {item})")


#: Knobs whose modules wait for later port slices: (field, "is set"
#: test, the ROADMAP item and the JAX package's module it waits for).
#: Setting one raises instead of silently building without it.
_UNPORTED = (
    ("prune_rows", bool, "A3: oracle/prune.py"),
    ("mesh_devices", lambda v: v is not None,
     "A4: parallel/mesh.py"),
    ("shard_frontier", bool, "A4: partition/shard.py"),
    ("obs_recorder", bool, "A5: obs/recorder.py"),
    ("recorder_dir", lambda v: v is not None, "A5: obs/recorder.py"),
    ("health_rules", bool, "A5: obs/health.py"),
    ("auto_profile", bool, "A2: obs/profiling.py"),
    ("profile_path", lambda v: v is not None,
     "A2: the profiler capture of partition/frontier.py"),
    ("recompile_guard", lambda v: v != "off",
     "A6: analysis/recompile_guard.py"),
)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Configuration for the online serving runtime (serve/).

    Distinct from PartitionConfig on purpose: serving knobs are
    RUN-scoped (a deploy restarts the server, never the build), and
    none of them can change a served value -- only latency, batching,
    and degraded-mode behavior.  Validated eagerly so a bad deploy
    config dies at startup, not on the first oversized batch.  The
    demand, tracing and SLO knobs belong to modules not yet ported: a
    non-default value raises NotImplementedError naming the ROADMAP
    item.
    """

    # Controller name in the registry (one scheduler per name).
    controller: str = "default"
    # Micro-batch flush threshold (rows).  Must be a power of two.
    max_batch: int = 256
    # Deadline budget: a queued query waits at most this long for the
    # batch to fill before the scheduler flushes a partial bucket.
    max_wait_us: float = 2000.0
    # Largest padding bucket a single evaluator call may mint.
    # None = the evaluator default.
    max_bucket: Optional[int] = None
    # Shard count for the descent tables (None = one per local device).
    n_shards: Optional[int] = None
    # Degraded-mode policy for not-inside queries (serve/fallback.py):
    # 'clamp' = clamp-to-certified-box re-evaluation (+ optional
    # budgeted oracle re-solve when an oracle is provided); 'off' =
    # return the raw not-inside result untouched.
    fallback: str = "clamp"
    # Running budget for host-side oracle re-solves, as a fraction of
    # all requests seen (0 disables oracle fallback even when an
    # oracle is available).
    max_oracle_frac: float = 0.05
    # Observability mode/path, same semantics as PartitionConfig.obs.
    obs: str = "off"
    obs_path: Optional[str] = None
    # Demand telemetry (ROADMAP A5: obs/demand.py).
    demand: str = "off"
    demand_max_leaves: int = 4096
    demand_decay_s: float = 300.0
    demand_reservoir: int = 64
    demand_subopt_frac: float = 0.0
    demand_subopt_eps: float = 0.0
    demand_snapshot_every_s: float = 30.0
    demand_dir: Optional[str] = None
    # Request tracing (ROADMAP A2: obs/reqtrace.py).
    tracing: str = "off"
    trace_exemplar_k: int = 8
    trace_window_s: float = 30.0
    # SLO engine (ROADMAP A5: obs/slo.py).
    slo: str = "off"
    slo_goal: float = 0.999
    slo_p99_target_us: float = 50_000.0
    slo_interval_s: float = 60.0
    slo_dir: Optional[str] = None

    def __post_init__(self) -> None:
        if not is_pow2(self.max_batch):
            raise ValueError(f"max_batch must be a power of two, "
                             f"got {self.max_batch}")
        if self.max_bucket is not None and not is_pow2(self.max_bucket):
            raise ValueError("max_bucket must be a power of two, "
                             f"got {self.max_bucket}")
        eff_bucket = (self.max_bucket if self.max_bucket is not None
                      else DEFAULT_MAX_BUCKET)
        if eff_bucket < self.max_batch:
            raise ValueError(
                f"max_batch {self.max_batch} exceeds the effective "
                f"evaluator bucket {eff_bucket} (max_bucket"
                f"{'' if self.max_bucket is not None else ' default'})"
                ": every full micro-batch would split")
        if self.max_wait_us <= 0:
            raise ValueError("max_wait_us must be > 0")
        if self.fallback not in ("clamp", "off"):
            raise ValueError(f"unknown fallback mode {self.fallback!r} "
                             "(expected 'clamp' or 'off')")
        if not 0.0 <= self.max_oracle_frac <= 1.0:
            raise ValueError("max_oracle_frac must be in [0, 1]")
        if self.obs not in ("off", "jsonl", "full"):
            raise ValueError(f"unknown obs mode {self.obs!r} "
                             "(expected 'off', 'jsonl', or 'full')")
        defaults = {f.name: f.default for f in dataclasses.fields(self)}
        for fld, item in _SERVE_UNPORTED:
            if getattr(self, fld) != defaults[fld]:
                raise NotImplementedError(
                    f"ServeConfig.{fld} is not yet ported to the torch "
                    f"package (ROADMAP {item})")


#: Serving knobs whose modules wait for later port slices: (field,
#: the ROADMAP item and the JAX package's module it waits for).  Any
#: value other than the default raises.
_SERVE_UNPORTED = tuple(
    [(f, "A5: obs/demand.py") for f in (
        "demand", "demand_max_leaves", "demand_decay_s",
        "demand_reservoir", "demand_subopt_frac", "demand_subopt_eps",
        "demand_snapshot_every_s", "demand_dir")]
    + [(f, "A2: obs/reqtrace.py") for f in (
        "tracing", "trace_exemplar_k", "trace_window_s")]
    + [(f, "A5: obs/slo.py") for f in (
        "slo", "slo_goal", "slo_p99_target_us", "slo_interval_s",
        "slo_dir")])
