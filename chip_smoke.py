"""End-to-end check of the torch port on one NVIDIA GPU.

    python3 chip_smoke.py                 # the whole check, one GPU

Builds the hand-written CUDA kernels from csrc/, holds each against its
plain torch version on the card, drives the port's main paths -- the
flagship inverted-pendulum partition build at eps_a=1e-2, the online
evaluation of 65,536 thetas through the point-location kernel, and
multi-tenant serving of the flagship table to four tenants from one
device arena (10,000 requests through the scheduler and the arena
kernel, with a delta hot swap mid-traffic and a bitwise torn-read
audit) -- with every kernel launch counted from zero just before each
path, and checks the results against the plain references.  Phases
11-13 then drive the single-controller paths: the closed loop
(sim.simulator.compare on the flagship table, the explicit controller
through the point-location kernel and the implicit one through the IPM
leg, with both kernels counted from zero and each loop held step by
step to a plain f64 reference, then `main --simulate` once); the
`main serve` entry point (`serve --selftest 20000` on the card by
default, ShardedDescent held to the f64 host evaluator, a hot swap
under 16 submitting threads with a bitwise audit); and sharded
descent at 368,640 synthetic leaves (flat against 8 shards, µs per
query, CUDA kernels a batch, device-resident bytes; phase 25 times the
1,474,560-leaf tree).  Phase 14 builds
the quadrotor's and the satellite's published sub-boxes through the
build CLI's main() on the card, held to the JAX package's region counts
and through the point-location kernel to the f64 host evaluator (both
builds under torch.profiler: K1's launches by (nz, nc, K), device time
and wall), and holds the IPM leg's large path (nz > 32 or nc > 128, the
quadrotor's QPs) and its general path (8 < nz <= 32, nc <= 128: every
satellite cell of K1_GENERAL_CELLS, timed in turns with K1_BASELINE's
kernel and the large path's own entry) against their plain version.  Phase 15 drives the warm rebuild and the rebuild
service from phase 3's tree: `main rebuild --from` unchanged and at
eps_a 9e-3 (held to the JAX package's region counts, the kept leaves'
payloads bitwise, the tightened table through the point-location kernel
to the f64 host evaluator), RebuildService over two drift revisions
hot-swapping a ControllerRegistry under 16 submitting threads (no
failure, no dropped request, no torn result), and `main serve-rebuild`
once.  Phase 16 drives the port's instruments from phase 3's result:
the serial baseline (SerialBnB over Oracle(backend="serial"), one QP
at a time in numpy on the host) against the card's oracle on 64 flagship thetas, `main --profile`
(the trace must name the IPM leg's kernel among its device ops) and an
auto-profile capture, phase 8's arena run and phase 12's
RequestScheduler run with ServeConfig(tracing="on") (every ticket's
stamps in order, the histograms' phase sums equal to their wall sums,
results bitwise an untraced run's, p50/p99
of every phase), and the rebuild service for one generation with obs
on (GC pauses and the watcher's stalls beside the request p99).  Phase
17 builds phase 14's sub-boxes again with `--prune-rows` (the
PrunedOracle's masks held to the JAX package's, the reduced programs
through the IPM leg, each reduced shape's K1 launches and device time
beside phase 14's unpruned build), holds the leg to its plain version at
the reduced shapes, the SOC solves on the card to the same on the CPU,
and builds satellite_soc with the SOCOracle (regions held to the JAX
package's, then a sampled soundness check).  Phase 18 drives the
build's diagnostics: 18a an Oracle(n_iter=2) with a flight recorder at
each K1 path (the flagship, the satellite 4c and the quadrotor pv
boxes), its diverged_cells bundle replayed on the card to the observed
conv and feas masks bit for bit and V bitwise, and the kernel-only
probe; 18b the flagship build with obs, the recorder and the health
monitor (a throughput floor that must fire): phase 3's tree cell for
cell, bundles = counter = events, no capture error, every bundle
replayed; 18c the auto-profile schedule (stall_s 0.2, two 0.4 s stalls
at oracle.wait): one critical health.stall, one capture naming K1;
18d phase 15a's rebuild with the recorder, its recert bundles replayed
with their verdicts; 18e two concurrent `main` builds sharing one obs
path with --obs-per-process, folded by obs.fleet; 18f `main serve`'s
obs stream through the monitor at ceilings below and above its p99.
Each replay's K1 launches are counted from zero.  Phase 19 drives the
SLO engine and demand telemetry: 19a `main serve --selftest 4096
--demand on --demand-dir D` (the snapshot loads, its rows are the
served rows, the answers bitwise those with --demand off); 19b phase
8's arena at 5,000 requests with demand capture and SLO tracking on and
off in turns (answers bitwise, 0 dropped, 0 torn, each tenant's sketch
the bincount of its served leaves, p50/p99 of both); 19c the hub's
suboptimality re-solves through its own Oracle on the card (K1 from
the hub's thread while the worker launches K3; any demand.error event
fails; V* held to the plain CPU oracle, certified rows within eps_a);
19d RebuildService with demand_dir ordering phase 15b's tightened
rebuild hottest-first (regions within 0.1% of 15b's) and the
depth-capped DI case bitwise; 19e SLO state reloaded bitwise in a fresh
interpreter, the fleet fold, and the burn alerts.  Phase 20 drives the
multi-GPU paths: 20a MeshSolver on (batch, delta) meshes (1,1), (2,1),
(1,2), (2,2) -- distinct cards where the machine has two or more, else
cuda:0 repeated -- against the dense grid program on 1,024 flagship
points (d*, conv, feas equal; the converged cells' floats and V* to
1e-9; K1 launched by every block), each timed in turns with the dense
call, and Oracle(mesh=) against the dense oracle; 20b the sharded build
through the launcher (parallel/launch.py, each shard a `main
--shard-frontier` process on the same card): the tier-1 DI fixture
with the single-process tree and point solves exactly, then phase 3's
flagship (0 fallback cells, no cell solved by two shards, regions
within 2% of 11,670, uncertified <= 70, the merged tree compared
canonically with phase 3's, each shard's K1 launches and device time,
the straggler report); 20c two gloo ranks
building the DI fixture in lockstep on the global mesh, equal to each
other and to the single-process build, rank 0 alone writing.  Phase 21 drives the
analysis package's recompile guard through the frontier: 21a the
flagship through `main --recompile-guard` with obs on, first cold under
warn (the guard fires after its 8-full-step warmup, as the JAX
package's does on a hybrid build: each event names new shapes only),
then under raise from an oracle warmed at every bucket (warm_buckets,
bench.py's warm_oracle): exit 0 and 0 violations; all three builds
(these two and an unguarded one) without speculation, whose dispatch
follows timing, so that both guarded builds hold phase 3's tree cell
for cell and the unguarded build's K1 launches exactly, the arm step, the
steps checked, the ledger's size at the arm and the end, and the
guard's share of the build wall; 21b the DI build with one real
dispatch forced through the engine's oracle at a bucket the build never
used right after the arm (one health.recompile, the monitor's worst
verdict warn, the unguarded tree; under raise RecompileError out of
step(); `main` in its own process exits non-zero); 21c kernels.loader
watched in a fresh process over a build plus an online batch (growth =
the libraries loaded: K1 and K2), and in this process from phase 3 to
after 21a (0).  Phase 22 drives the robustness gate (tools/): 22a the
chaos suite's five fault schedules on the card (three at a time after
the reference build) at the JAX package's
configuration (the tier-1 DI fixture at eps 0.2), with the card's
verdicts -- schedules 1 and 2 end with NoCpuFallback chained to their
injected fault (exit 69, no tree, the process gone within the hang
plus 3 s of the fault), 3 resumes from .prev to the clean card tree
node for node, 4 ends its faulted shard with NoCpuFallback while the
launcher returns non-zero within its limit, 5 leaves generation 0
committed and bitwise the fault-free run's -- each child's K1 launches
counted; 22b phase 3's flagship under the supervisor, killed between
rotation and write of its 2nd checkpoint (every 20 steps) and resumed
from .prev: regions within 2% of 11,670, uncertified <= 70, the tree
compared cell for cell with phase 3's (each differing cell listed),
the resumed process's K1 launches from zero; 22c the drift smoke (three
drift revisions into RebuildService under a RequestScheduler load, 0
dropped, 0 torn, staleness and request p50/p99).  Phase 23 drives the
operator's tools (tools/) over the card's own builds: 23a the fleet
smoke at the JAX script's defaults (the same DI fixture) -- the
supervised chain killed at its 2nd checkpoint boundary, its two
per-process streams reconciled bit-exactly with the single-process
build and its tree node for node, then the two-shard build, its
counters bit-equal and its tree canonically the single process's, each
with `obs_report --fleet --strict` exit 0 -- every child's K1 launches
counted; 23b the watchdog following a live `main --obs jsonl` build to
build.done (exit 0), and a build stopped with SIGSTOP after its first
build.step (exit 2 with health.stall under stall_s 3); 23c the report
over 23b's and 23a's streams (regions equal to .stats.json, --drift
against itself with no flag, no bench read) and `--fleet --strict`
over 23a's per-process streams; 23d `preflight --only lint` (verdict
ok; tier1 needs the JAX package, which the card's machine lacks, the
chaos suite is 22a's and the drift smoke 22c's).  Phase 24 drives the capture
tools (tools/), each a process of its own through counted_tool, which
tallies K1 by route, path and dtype over the process and each build:
24b tune_schedule at the JAX script's defaults (the seven schedule
rows, the parity builds, the all-f64 row's µs a QP beside the fastest
mixed row's); 24c onset_probe over both families' ladders under
precision mixed (every rung complete and within the JAX package's own
span of regions, 2% or 1 region; each build's K1 by path and dtype:
the float32 leg at the general and the large path in full builds);
24d long_build on the flagship at eps 0.1, checkpointed every 5
steps, its first process SIGKILLed after its 2nd progress row and a
second resumed to a drained frontier (regions within 2% of the CPU
build's, resumed from the 2nd checkpoint, the progress rows
continuous); 24a precision_check at
the JAX defaults against the same tool on the CPU (started before phase
23, on half the host's cores): f32_accept_rate within 0.02 and the same
verdict, then the acceptance step alone at the 5b and 4c sub-boxes on
the card and on the CPU (the large and the general path's float32 leg
on real problem data).  Phase 25 drives the bench tool
(tools/bench.py), each mode a process through bench_worker (counted:
K1 by route, path and dtype, K2's count; the multichip mode's builds
through counted_cli): the default mode alone at its card defaults --
the flagship at eps 1e-2, f64, max_depth 56, 512 simplices a batch,
the 1,474,560-leaf synthetic tree -- held to the JAX package's build at
those settings (regions within 2% of 13,152, uncertified <= 70, not
truncated), its online figure through K2, its large-L flat and sharded
outputs held to the synthetic tree's law as phase 13 holds its own,
both baselines, the online and large-L µs a query finite and positive
and K1's tile time present; then the rebuild mode at eps 0.1,
the drift walk over 5 revisions and the multichip mode at its defaults
together (no error, reuse in (0, 1], at least 5 generations, parity
held); every row's history row appended to its own file, and the JAX
package's BENCH_HISTORY.jsonl unchanged byte for byte.  Phase 26 drives
the serving bench (tools/serve_bench.py), one process at a time through
serve_bench_worker (counted, its client windows recorded): the
four-tenant arena sweep and the legacy sweep, each at the JAX script's
defaults but depth 13 (16,384 leaves), held to the JAX script's bars,
the card named and both versions seen (not the skewed capture, whose
1% overhead bars the card cannot resolve: SERVE_BENCH_RUNS); in the arena
child K3's launches over the windows equal to the scheduler's batches,
window by window against the row's launches per request, and at least
1,024 of its served in-box rows, over every extent, re-evaluated by
K3's plain version within 1e-5.  One
ContentionMonitor samples the host across the whole script; each
phase is followed by its verdict (competing CPU share, contended), and
the kernels line carries the whole run's summary under "host".  Any
failed phase exits non-zero.  The second-to-last line
of standard output is the kernels JSON object (each kernel's launches,
error against its plain version, its time, the plain version's time, a
library yardstick where one exists and the bound the card allows); the
last line is {"ok": true, "device": {...}}.  A launch is one wrapper
call: for locate it is two kernels when the leaves are split across
blocks (its entry's "splits" > 1), the split scan and the merge.
arena_eval's entry is at the serving run's most frequent batch size
("rows"), its error the largest over every size it was held to its
plain version at (the sweep's, that one and phase 26's served rows),
and its "profiled_*" keys come from a second, shorter serving run under torch.profiler
(the timed run's p50/p99 are taken without the profiler).  The
ipm_leg and locate entries' "sim_launches" count the closed loop's
launches (phase 11), from zero; the ipm_leg entry's "large" object is
phase 14's: the large path's time, bound and plain time at the
quadrotor build's most frequent K, its errors against the plain
version, the timed cells, and the quadrotor build's K1 launches and
device time against their summed bound; its "general" object the
general path's cells (each with its ratio to the baseline and to the
large path's entry, and their ranges) and the satellite 4c build's K1
record unpruned (phase 14) and pruned (17a);
its "pruned" object phase 17's: K1 at the pruned builds' reduced shapes
(time, bound, plain time), each pruned build's K1 launches and device
time beside its unpruned build's, and the SOC solves and partition.
The "rebuild_*" keys count phase 15's unchanged rebuild (K1: launches,
device time, summed bound) and its tightened rebuild's online batch
(locate), from zero.  The "subopt_*" keys count phase 19c's re-solves
(K1 launches from zero, device time), the "demand_rebuild_*" keys 19d's
prioritized rebuild; arena_eval's "capture_launches" is 19b's first run
with demand capture and SLO tracking on, "capture_p99_ratio" its p99
over the runs without them.  The "mesh_*" keys are 20a's (K1 launches a
call, ms a call, the dense call's ms, by mesh shape), "sharded_*" 20b's
(each shard's K1 launches and device time in the flagship build, and
whether its tree is phase 3's), "lockstep_launches" 20c's ranks'; the
"guard*" keys 21a's (the warmed build's K1 launches, the cold build's
violations, the guard hook's share of the wall), "forced_k1_launches"
21b's forced dispatch, "loader_growth" 21c's; the "chaos_*" keys 22a's
(each schedule's verdict, wall and K1 launches a process), the
"resumed_*" keys 22b's (the resumed process's K1 launches, regions,
tree identity with phase 3's), the "drift_*" keys 22c's (K1 launches,
staleness and request p50/p99); the "fleet_*" keys 23a's (K1 launches
a process by build, walls), the "watch_*" keys 23b's, "report_*" 23c's
regions, "preflight_walls_s" 23d's and "operator_wall_s" phase 23's; the
"tune_*" keys 24b's, "onset_*" 24c's, "long_*" 24d's, "prec_*" 24a's
(each with its K1 record by route, path and dtype: "cuda:large:float32"
and so on) and "capture_wall_s" phase 24's; the "bench_*" keys phase
25's (K1 launches and the bench process's K1 event ms by mode, each
mode's wall, the default row's headline figures), and the locate
entry's "bench_launches" the default mode's K2 launches; arena_eval's
"serve_bench_*" keys phase 26's (K3's launches over the arena sweep's
windows and in its process, the plain-version hold, K3's graph-replayed
ms a launch at the sweep's most frequent batch size beside its plain
version's and its bound, each child's wall).  The ipm_leg entry's
"build_ms" is K1's device time in phase 9's profiled window of the
flagship build (its steps "build_window_steps"), beside the summed
bound of the launches recorded in that window.

From phase 14 on, three processes share the card (LANES): this one runs
phases 14, 15, 17, 18 and 19, which build on one another's results;
lane B, from a flagship build of its own, phases 16, 20, 21 and 22;
lane C phases 23, 24 and 25.  Each lane's lines come through as they
are printed, behind "[lane B] " or "[lane C] "; a lane that fails
fails the script at this process's next phase boundary, and every lane
is stopped with it.  Phases 1-13 run before the lanes start and phase
26 after they have all ended, alone on the card both: the kernels'
timings and the serving sweeps' latencies see no other work there.

It refuses to run (exit code 2, no result) without a CUDA device, and
exits non-zero in a directory that does not hold the repository.

    K1_BASELINE=old_ipm_leg.cu python3 chip_smoke.py

also builds another version of csrc/ipm_leg.cu (the same C interface;
for a redesign of K1, its parent's source from `git show`) and holds
this kernel against it in the same call: phase 2's sweep of the build's
launch shapes, phase 14's and 17b's large-path cells timed in turns,
and (phase 10) four flagship builds in turns (baseline, kernel, kernel,
baseline) for the build wall, then one recorded build with each for a
cell-by-cell diff of the two trees that names, for every cell the two
builds decide differently, the test that decided it and how far from
its threshold it sat.

    python3 -c "import chip_smoke as c; c.k1_large_only()"

checks and times K1's large path alone (about two minutes,
K1_BASELINE as above), with the iteration split of a copy of the
kernel stamped with clock64() at its sections (k1_split).

    K1_BASELINE=old_ipm_leg.cu python3 -c \
        "import sys, chip_smoke as c; sys.exit(c.k1_general_only())"

does the same for the general path: every cell of K1_GENERAL_CELLS in
turns with the baseline and the large path's entry, and its split.

    python3 -c "import sys, chip_smoke as c; sys.exit(c.diagnostics_only())"

runs phase 18 alone (after a flagship build of its own), and

    python3 -c "import sys, chip_smoke as c; sys.exit(c.slo_demand_only())"

phase 19 likewise, and

    python3 -c "import sys, chip_smoke as c; sys.exit(c.multi_gpu_only())"

phase 20, and

    python3 -c "import sys, chip_smoke as c; sys.exit(c.analysis_only())"

phase 21, and

    python3 -c "import sys, chip_smoke as c; sys.exit(c.robustness_only())"

phase 22, and

    python3 -c "import sys, chip_smoke as c; sys.exit(c.operator_tools_only())"

phase 23, and

    python3 -c "import sys, chip_smoke as c; sys.exit(c.capture_tools_only())"

phase 24, and

    python3 -c "import sys, chip_smoke as c; sys.exit(c.bench_only())"

phase 25, and

    python3 -c "import sys, chip_smoke as c; sys.exit(c.serve_bench_only())"

phase 26.

    K2_BASELINE=old_locate.cu K3_BASELINE=old_arena_eval.cu \
        python3 chip_smoke.py

likewise builds the parents of csrc/locate.cu and csrc/arena_eval.cu
(each with the parent's own C interface, from the tree before their
redesign) and times each in turns with this tree's kernel on the same
buffers, by CUDA-graph replay: phase 5's K2 sweep (8,192 and 65,536
queries), phase 7's K3 sweep (1 to 65,536 rows at the serving mix) and
K3 at the serving run's most frequent batch size.  It then also
requires K2's leaves and scores and K3's records to be bitwise the
parent's on every input of those sweeps.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

#: Published peaks of one H100 SXM used for the bounds (NVIDIA's data
#: sheet): HBM bandwidth, float32 outside the tensor cores, and float64
#: on the FP64 tensor cores -- the card's highest rate for the type
#: (34 TFLOP/s outside them), so that a bound is never above what the
#: card could reach.
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
PEAK_F64_S = 67e12

#: Reference of the flagship build: the JAX package on the CPU at the
#: same configuration (inverted_pendulum defaults, eps_a=1e-2, every
#: other PartitionConfig field at its default).
REF_REGIONS = 11670
REF_UNCERTIFIED_MAX = 70

#: K1's sweep: (label, QP class, n_iter) of the flagship build's five
#: shape classes, the batch sizes K, and the cell that stands for K1 in
#: the kernels line (the build's most frequent point launch: K 1,024,
#: nz 5, nc 35, 12 iterations).
K1_CLASSES = (("point phase 1", "point", 12), ("point", "point", 18),
              ("elastic simplex-min", "simplex_min", 12),
              ("simplex-min", "simplex_min", 18), ("Farkas", "farkas", 30))
K1_SWEEP_K = (8, 64, 256, 1024, 2048)
K1_MAIN_K = 1024

#: Online batch (thetas evaluated through the locate kernel) and the
#: seed of every sampled input.
QUERIES = 65536
SEED = 0

#: K2's sweep (queries per launch) and K3's (rows per launch).
K2_SWEEP_B = (8192, QUERIES)
K3_SWEEP_B = (1, 4, 16, 64, 256, QUERIES)

#: The serving run: tenants of the flagship table in one arena (plus a
#: spare extent for the delta publish's two-epoch handoff), closed-loop
#: client threads, requests in all, the scheduler's micro-batch cap
#: (ServeConfig.max_batch) and deadline, and the share of queries
#: drawn outside the certified box.  REQUESTS (also 16c's traced arena
#: runs) is 10,000 since phase 26's arena sweep serves a delta hot swap
#: under load with the same bitwise audit and K3 count, traced.
TENANTS = 4
CLIENTS = 16
REQUESTS = 10_000
MAX_BATCH = 256
MAX_WAIT_US = 2000.0
OUTSIDE_FRAC = 0.05

#: Requests of the second, profiled serving run (K3's device time).
PROFILED_REQUESTS = 5_000

#: Phase 11, the closed loop: steps of the flagship loop (from 0.8 *
#: theta_ub, what `main --simulate` runs), the explicit controller's leaf
#: tie (the plain version's winning score within this of the runner-up's),
#: the implicit one's exact tie (two commutations' V this close), the
#: steps of the `main --simulate` run on the tier-1 double integrator,
#: and the keys of the JAX package's PREFIX.sim.json.
SIM_T = 100
SIM_LEAF_TIE = 1e-5
SIM_V_TIE = 1e-12
SIM_DI_T = 50
SIM_DI_ARGS = ("-e", "double_integrator", "--problem-arg", "N=3",
               "--problem-arg", "theta_box=1.5", "-a", "0.5", "--batch",
               "64", "--max-depth", "20")
SIM_JSON_KEYS = ("theta0", "explicit_cost", "implicit_cost", "cost_ratio",
                 "explicit_us_per_step", "implicit_us_per_step",
                 "online_speedup", "trajectories")

#: Phase 12, the serve entry point: `serve --selftest` requests, in-box
#: thetas held against the f64 host evaluator, and the hot swap's client
#: threads and requests per client (one theta each).
SERVE_SELFTEST = 20_000
SERVE_HOLD = 8192
SWAP_CLIENTS = 16
SWAP_REQUESTS = 250

#: Phase 13, the large partition (bench.py's large_l_metrics): a
#: synthetic depth-9 tree over the unit box in p = 6 (720 Kuhn roots,
#: the satellite's root layout), 368,640 leaves -- phase 25's bench row
#: drives the depth-11 tree, 1,474,560 leaves, through the same export,
#: flat and sharded paths and holds them to the same law (large_law);
#: the batch, the shard count, the timed
#: repetitions, the queries held to the tree's exact law and, of those,
#: the ones held to the brute f64 host evaluator.
LARGE_P = 6
LARGE_DEPTH = 9
LARGE_B = 8192
LARGE_SHARDS = 8
LARGE_REPS = 10
LARGE_HOLD = 4096
LARGE_NP_HOLD = 32

#: Phase 14, other problems: the published sub-box configurations of the
#: quadrotor and the satellite (artifacts/configs_cpu_r5.json rows "5b"
#: and "4c"), built through `python -m explicit_hybrid_mpc_tpu_torch.main`
#: at their full horizons in f64 (the quadrotor's cpu_precision_hint):
#: (name, argv, reference regions, --artifacts-out).  The reference counts
#: are the JAX package's on the CPU at today's defaults
#: (PartitionConfig(problem=..., problem_args=..., eps_a=1.0, eps_r=0.1,
#: backend="cpu"), every other field at its default): quadrotor 1,208
#: regions, 2,392 nodes, 3,136 oracle solves; satellite 7,744 regions,
#: 14,768 nodes, 7,155 solves; 0 uncertified in both.  Exact ties in a
#: vertex's best commutation can move a few regions, hence 2%.
OTHER_BUILDS = (
    ("quadrotor", ("-e", "quadrotor", "-r", "0.1", "-a", "1",
                   "--problem-arg", 'param="pv"', "--problem-arg",
                   "pos_box=0.4", "--problem-arg", "vel_box=0.2"),
     1208, True),
    ("satellite", ("-e", "satellite", "-r", "0.1", "-a", "1",
                   "--problem-arg", "axes=3", "--problem-arg",
                   "omega_box=0.03", "--problem-arg", "h_box=0.3"),
     7744, False))
OTHER_UNCERTIFIED_MAX = 5
OTHER_EVALUATE = QUERIES
#: Thetas of each table held to the f64 host evaluator through K2.
OTHER_HOLD = 4096
#: K1's large path against its plain version: the quadrotor's point and
#: elastic simplex-min shapes (with every large shape the build
#: launched), at these K and the build's most frequent K.
K1_LARGE_SHAPES = ((60, 360), (65, 366))
K1_LARGE_K = (8, 64, 256)
#: Iterations a large-path cell runs where no recorded build gives its
#: count (the quadrotor build's: 12 at its point shape, 18 at the
#: elastic simplex-min; the pruned programs run 30, single-phase).
K1_LARGE_ITERS = {(60, 360): 12, (65, 366): 18, (60, 49): 30, (65, 55): 30}
#: k1_large_only: the pruned quadrotor's reduced shapes (point and
#: elastic simplex-min) on the large path.
K1_PRUNED_SHAPES = ((60, 49), (65, 55))
#: k1_large_only: the large path's smaller shapes -- just past the
#: general path's limits, the quadrotor "p" sub-box's QPs of the GPU
#: tests (nz 24-27, nc 144-147), and a handful of variables over many
#: rows -- at these K, 18 iterations.
K1_LARGE_EXTRA = ((33, 129), (26, 146), (8, 200))
K1_LARGE_EXTRA_K = (8, 256)
#: QPs a call of the plain version at the large shapes (it materializes
#: K x nc x nz x nz products).
K1_PLAIN_CHUNK = 128
#: K1's general path (8 < nz <= 32, nc <= 128; the kernel's dispatch):
#: its cells, (label, (nz, nc), K, n_iter) -- the satellite 4c build's
#: QPs (point, elastic simplex-min, Farkas phase-1), the pruned
#: satellite's (point, elastic simplex-min and phase-1 gate at the
#: reduced shapes), then the path's two edges.  general_path_cells
#: takes a cell's n_iter from the satellite 4c build where phase 14
#: recorded the shape.
K1_REGISTER_MAX_NZ = 8
K1_GENERAL_CELLS = (
    ("satellite point", (24, 96), (64, 1024, 1728), 12),
    ("pruned satellite point", (24, 14), (64, 216, 256), 30),
    ("satellite elastic simplex-min", (31, 104), (64, 256), 18),
    ("satellite Farkas phase-1", (31, 103), (64, 256), 30),
    ("pruned elastic simplex-min", (31, 22), (64, 256), 12),
    ("pruned phase-1 gate", (25, 14), (64, 256), 30),
    ("smallest nz", (9, 70), (8, 256), 18),
    ("largest shape", (32, 128), (8, 256), 18))
#: The cell that stands for the general path in the kernels line.
K1_GENERAL_MAIN = ((24, 96), 1024)
#: The iteration split of the large path (k1_split): a copy of the
#: source with clock64() stamps on block 0's thread 0 (which runs the
#: factor and the solves) at the boundaries of an iteration's sections,
#: built under build/, at these (nz, nc, K, n_iter).  Each anchor list
#: names, in source order inside ipm_leg_large, a line and the code put
#: before and after it; "parent" fits the source before the redesign
#: (its large_solve and Cholesky), "new" this one.
K1_SPLIT_KERNEL = "ipm_leg_large(const T* __restrict__ Qg"
K1_SPLIT_CELLS = ((60, 360, 256, 12), (60, 49, 256, 30))
K1_SPLIT_SECTIONS = ("assembly (residuals, A'DA, A'lam, A't, mu)", "factor",
                     "solve (predictor)",
                     "steps, step lengths, sigma, corrector rhs",
                     "solve (corrector)", "steps, step lengths, update",
                     "prologue", "the barrier after the factor (Q z + q)")
_SPLIT_COMMON_HEAD = (
    ("unsigned char smem_raw[];", "", "long long ehm_last = clock64();"),
    ("for (int it = 0; it < n_iter; ++it) {", "",
     "EHM_STAMP(it ? 5 : 6);"))
_SPLIT_COMMON_TAIL = (
    ("for (int i = tid; i < nz; i += NT) zout[k * nz + i] = z[i];",
     "EHM_STAMP(5);", ""),)
K1_SPLIT_ANCHORS = {
    "parent": _SPLIT_COMMON_HEAD + (
        ("for (int j = 0; j < nz; ++j) {", "EHM_STAMP(0);", ""),
        ("large_solve(nz, L, tid < nz ? -rd[tid] - wt[tid] : T(0), bc, dz);",
         "EHM_STAMP(1);", "EHM_STAMP(2);"),
        ("large_solve(nz, L, y, bc, dz);", "EHM_STAMP(3);", "EHM_STAMP(4);"),
    ) + _SPLIT_COMMON_TAIL,
    "new": _SPLIT_COMMON_HEAD + (
        ("large_factor(nz, L, inv);", "EHM_STAMP(0);", "EHM_STAMP(1);"),
        ("large_solve(nz, L, inv, rd, wl, wt, part, 0, true, dz);",
         "EHM_STAMP(7);", "EHM_STAMP(2);"),
        ("large_solve(nz, L, inv, rd, wl, wt, part, G, false, dz);",
         "EHM_STAMP(3);", "EHM_STAMP(4);"),
    ) + _SPLIT_COMMON_TAIL}

#: The iteration split of the general path (k1_general_only): the same
#: stamps in ipm_leg_mid, at these (nz, nc, K, n_iter) of its cells.
K1_GENERAL_SPLIT_KERNEL = "ipm_leg_mid(const T* __restrict__ Qg"
K1_GENERAL_SPLIT_CELLS = ((24, 96, 64, 12), (24, 14, 64, 30),
                          (31, 104, 64, 18))
K1_GENERAL_SPLIT_SECTIONS = (
    "row pass (residuals, D, t, mu, Q z)", "assembly (A'DA tiles, A'lam, "
    "A't)", "factor (C rows, Cholesky)", "solve (predictor)",
    "steps, step lengths, sigma, corrector A't", "solve (corrector)",
    "prologue", "steps, step lengths, update")
K1_GENERAL_SPLIT_ANCHORS = (
    ("unsigned char smem_raw[];", "", "long long ehm_last = clock64();"),
    ("for (int it = 0; it < n_iter; ++it) {", "", "EHM_STAMP(it ? 7 : 6);"),
    ("    mid_assemble<NZB>(As, Ds, ls, ts, nc, nz, Cs, wl, wt);",
     "EHM_STAMP(0);", ""),
    ("    T L[NZB];", "EHM_STAMP(1);", ""),
    ("T dz = mid_solve<T, NZB>(nz, me, L, inv, Cs, -rd - at);",
     "EHM_STAMP(2);", "EHM_STAMP(3);"),
    ("dz = mid_solve<T, NZB>(nz, me, L, inv, Cs, -rd - ((p0 + p1) + (p2 + "
     "p3)));", "EHM_STAMP(4);", "EHM_STAMP(5);"),
    ("if (live) zout[k * nz + lane] = z;", "EHM_STAMP(7);", ""))

#: Phase 15, the warm rebuild and the rebuild service, from phase 3's
#: flagship tree.  The references are the JAX package's on the CPU at
#: today's defaults (warm_rebuild from its own 11,670-region cold build):
#: the unchanged rebuild 11,674 regions (58 uncertified, 62 leaves
#: invalidated through knife-edge certificates); the rebuild at eps_a
#: 9e-3, 13,106 regions; a cold build at 9e-3, 13,177 (printed beside).
REBUILD_REF_REGIONS = 11674
REBUILD_TIGHT_EPS = 9e-3
REBUILD_TIGHT_REF_REGIONS = 13106
REBUILD_TIGHT_COLD_REGIONS = 13177
REBUILD_INVALID_MAX_FRAC = 0.01
#: 15c: drift revisions of the flagship's u_max (a 2% walk) through
#: RebuildService while SERVICE_CLIENTS threads submit flagship thetas.
SERVICE_REVISIONS = 2
SERVICE_CLIENTS = 16
SERVICE_DRIFT_FRAC = 0.02
#: 15d: `main serve-rebuild` at the tier-1 double integrator's size.
SERVE_REBUILD_ARGS = ("-e", "double_integrator", "--problem-arg", "N=3",
                      "--problem-arg", "theta_box=1.5", "-a", "0.5",
                      "--batch", "64", "--revisions", "1")

#: Phase 16, the instruments: flagship thetas of the serial baseline
#: (drawn from SEED + 18) and its V* bar (the JAX package's
#: tests/test_bnb.py), the frontier steps the profiler captures, the
#: trace ring's K, and the contention monitor's sampling interval.
SERIAL_POINTS = 64
SERIAL_RTOL, SERIAL_ATOL = 1e-6, 1e-8
PROFILE_STEPS = 3
#: Phase 9: the flagship build is under the profiler from the end of its
#: first step here to the end of its second (steps 41-60), and stops
#: there (phase 3 holds the whole build).
PROFILE_WINDOW = (40, 60)
TRACE_EXEMPLAR_K = 8
HOST_INTERVAL_S = 1.0

#: Phase 17, constraint-row pruning and the SOC oracle stack.  17a
#: builds OTHER_BUILDS again with --prune-rows, held to the same
#: references; the PrunedOracle's masks on the card are held to the JAX
#: package's on the CPU (PrunedOracle defaults, 48 samples, margin 0.02):
#: (sha256 of packbits(row_keep) + packbits(var_keep), first 16 hex
#: digits; kept rows; kept vars; the reduced (nzr, ncr)).
PRUNE_MASKS = {"quadrotor": ("d065afe8f079f798", 496, 868, (60, 49)),
               "satellite": ("cb17bfc097c31632", 243, 540, (24, 14))}
#: 17b: K1 against its plain version at these K and the pruned builds'
#: most frequent K, at every reduced shape they launched.
K1_PRUNED_K = (64, 256)
#: 17c/17d: satellite_soc at the 4c box with scripts/soc_partition.py's
#: defaults; the reference is the JAX package's CPU build at today's
#: defaults (that script, SOC_BUDGET 2400): 1,440 regions, 2,160 nodes,
#: 0 uncertified, 1,755 point solves, not truncated.  SOC_THETAS thetas
#: (drawn from SEED + 17) go through the SOC solves on the card and on
#: the CPU; SOC_SAMPLES thetas in certified leaves through the sampled
#: soundness check.
SOC_ARGS = (("N", 3), ("h_box", 0.3), ("omega_box", 0.03))
SOC_CFG = (("eps_a", 2.0), ("eps_r", 0.3), ("batch_simplices", 64),
           ("max_depth", 24), ("semi_explicit_boundary_depth", 10))
SOC_REF_REGIONS = 1440
SOC_THETAS = 16
SOC_SAMPLES = 192


def log(*a) -> None:
    # One write a line: the lanes' relays print beside this process.
    sys.stdout.write(" ".join(map(str, a)) + "\n")
    sys.stdout.flush()


def fail(msg: str) -> None:
    log(f"chip_smoke: FAIL: {msg}")
    sys.exit(1)


def cuda_time(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of `fn` by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def graph_time(fn, reps: int) -> float:
    """Mean milliseconds per call of `fn` (which launches on the current
    stream) replayed from one CUDA graph of `reps` calls, by CUDA
    events: the device's time per launch, without the host's cost of
    launching (which paces back-to-back launches of kernels that take
    only microseconds)."""
    import torch

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    g.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def ipm_leg_cost(K: int, nz: int, nc: int, n_iter: int,
                 itemsize: int) -> tuple[float, float]:
    """(bytes, flops) one leg must move and do: each operand and start
    read once, each result written once; per iteration the residuals,
    the KKT assembly (D*A once, then the lower triangle of A'(DA)), the
    Cholesky, two solves, the step vectors and the line searches."""
    nbytes = K * itemsize * (nz * nz + nc * nz + 3 * nz + 5 * nc)
    tri = nz * (nz + 1) // 2
    per_iter = (2 * nz * nz + 4 * nc * nz + 8 * nc       # r_d, r_p, mu, D
                + nc * nz + 2 * nc * tri                  # KKT assembly
                + nz ** 3 // 3 + nz * nz                  # Cholesky
                + 2 * (4 * nc * nz + 2 * nz * nz + 8 * nc)  # two KKT steps
                + 4 * 3 * nc + 6 * nc + 2 * nz + 4 * nc)  # steps, mu_aff
    return float(nbytes), float(K * n_iter * per_iter)


def leg_bound_ms(K: int, nz: int, nc: int, n_iter: int) -> float:
    """The least time one f64 leg could take on the card (ipm_leg_cost)."""
    nbytes, flops = ipm_leg_cost(K, nz, nc, n_iter, 8)
    return 1e3 * max(nbytes / PEAK_BYTES_S, flops / PEAK_F64_S)


def record_legs(real, launches: list, store: dict | None = None,
                key: str | None = None):
    """A stand-in for ipm_leg.ipm_leg_cuda that notes each launch's
    (K, nz, nc, n_iter) in `launches` -- and, given `store`, keeps its
    inputs under `key` -- then launches the kernel."""
    def leg(Q, q, A, b, z, s, lam, n_iter):
        launches.append((q.shape[0], q.shape[1], b.shape[1], int(n_iter)))
        if store is not None:
            store[key] = (Q, q, A, b, z, s, lam)
        return real(Q, q, A, b, z, s, lam, n_iter)
    return leg


def leg_histogram(launches: list) -> float:
    """Log the recorded K1 launches (K, shape classes, iterations) and
    return their summed bound in ms."""
    from collections import Counter

    ks = Counter(k for k, _nz, _nc, _it in launches)
    shapes = Counter((nz, nc, it) for _k, nz, nc, it in launches)
    bound = sum(leg_bound_ms(*x) for x in launches)
    log(f"[legs]   {len(launches)} launches; K: " + ", ".join(
        f"{k} x{n}" for k, n in sorted(ks.items())))
    log("[legs]   (nz, nc, n_iter): " + ", ".join(
        f"{c} x{n}" for c, n in sorted(shapes.items())))
    small = sum(n for k, n in ks.items() if k <= 256) / max(1, len(launches))
    log(f"[legs]   sum n_iter {sum(x[3] for x in launches)}, sum K*n_iter "
        f"{sum(x[0] * x[3] for x in launches)}, share of launches with "
        f"K <= 256 {small:.3f}; summed bound {bound:.4f} ms")
    return bound


def baseline_source(env=None, var: str = "K1_BASELINE") -> str | None:
    """The absolute path of the other kernel source that `var`
    (K1_BASELINE, K2_BASELINE or K3_BASELINE) names, or None when it is
    unset or empty; fails when it names no file."""
    src = (os.environ if env is None else env).get(var, "").strip()
    if not src:
        return None
    if not os.path.isfile(src):
        fail(f"{var}={src} is not a file")
    return os.path.abspath(src)


def _ctypes_sigs():
    """The C interface of each kernel's parent, the tree before its
    redesign: argument types by function name."""
    import ctypes

    P, I = ctypes.c_void_p, ctypes.c_int
    return {
        "ipm_leg": {"ipm_leg_f64": [P] * 10 + [I] * 4 + [P],
                    "ipm_leg_f32": [P] * 10 + [I] * 4 + [P]},
        "locate": {"locate_f32": [P, P, I, I, I, P, P, P]},
        "arena_eval": {"arena_eval_f32": [P] * 5 + [I] * 4 + [P, P]},
    }


def baseline_lib(src: str, build_dir: str, nvcc_flags,
                 name: str = "ipm_leg"):
    """Build another version of csrc/<name>.cu -- its parent's source,
    with the parent's C interface -- into build_dir and load it, typed
    as that interface; logs its ptxas lines."""
    import ctypes
    import shutil

    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    out = os.path.join(build_dir, f"lib{name}_baseline.so")
    os.makedirs(build_dir, exist_ok=True)
    r = subprocess.run([nvcc, *nvcc_flags, "-o", out, src],
                       capture_output=True, text=True, timeout=600)
    if r.returncode:
        fail(f"the {name} baseline {src} does not build:\n"
             f"{r.stdout}{r.stderr}")
    for ln in ptxas_lines(f"{name} baseline", r.stdout + r.stderr):
        log(f"[build] {ln}")
    lib = ctypes.CDLL(out)
    for fn, argtypes in _ctypes_sigs()[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    err_fn = getattr(lib, f"{name}_error_string")
    err_fn.argtypes = [ctypes.c_int]
    err_fn.restype = ctypes.c_char_p
    lib._ehm_typed = True
    return lib


def tree_outcomes(tree) -> dict:
    """Cell (the bytes of its vertex matrix) -> what a build made of it:
    ("split",), ("leaf", delta, certified) or ("empty",) (a leaf without
    payload: certified infeasible on the whole cell)."""
    out = {}
    children = tree.children
    for n in range(len(tree)):
        key = tree.vertices[n].tobytes()
        if children[n, 0] >= 0:
            out[key] = ("split",)
            continue
        ld = tree.leaf_data[n]
        out[key] = ("empty",) if ld is None else \
            ("leaf", int(ld.delta_idx), bool(ld.certified))
    return out


def differing_cells(a: dict, b: dict) -> tuple[list, int]:
    """Cells of both trees that one build split and the other closed (or
    closed as different kinds), and the count of leaves both closed with
    another commutation."""
    both = a.keys() & b.keys()
    diff = sorted(k for k in both if a[k][0] != b[k][0])
    other_delta = sum(1 for k in both if a[k][0] == b[k][0] == "leaf"
                      and a[k][1] != b[k][1])
    return diff, other_delta


class DecisionRecorder:
    """Notes, while a build runs, every cell's certificate inputs and
    verdicts (stage 1, stage 2) and every QP's convergence margin
    max(r_p, r_d, mu) / tol (converged iff below 1), by wrapping
    certify's two entry points and ipm.qp_solve; restored on exit.
    The wrapper of qp_solve reads each result back, so a recorded
    build is slower and is not timed."""

    def __init__(self, certify, ipm):
        self.certify, self.ipm = certify, ipm
        self.cells: dict = {}
        self.qps: dict = {}

    @staticmethod
    def qp_key(q, b) -> list:
        """Per-row keys of a QP batch: its linear term and right-hand
        side, rounded to 9 decimals (a point QP's theta, a joint QP's
        cell and commutation live there)."""
        import torch

        x = np.round(torch.cat([q, b], 1).cpu().numpy(), 9)
        return [bytes([q.shape[1]]) + r.tobytes() for r in x]

    def __enter__(self):
        import torch

        s1, s2, qp = (self.certify.certify_stage1_batch,
                      self.certify.certify_suboptimal_stage2,
                      self.ipm.qp_solve)
        self._real = (s1, s2, qp)

        def stage1(verts, V, conv, grad, Vstar, dstar, eps_a, eps_r):
            res = s1(verts, V, conv, grad, Vstar, dstar, eps_a, eps_r)
            for i, r in enumerate(res):
                self.cells[verts[i].tobytes()] = dict(
                    s1=r.status, gap1=r.gap, conv=conv[i].copy(),
                    dstar=dstar[i].copy(), V=V[i].copy())
            return res

        def stage2(sd, res, Vmin, eps_a, eps_r):
            r = s2(sd, res, Vmin, eps_a, eps_r)
            self.cells.setdefault(sd.verts.tobytes(), {}).update(
                s2=r.status, gap2=r.gap, Vmin=dict(Vmin))
            return r

        def qp_solve(Q, q, A, b, n_iter=30, tol=1e-8, n_f32=0,
                     warm_start=None):
            sol = qp(Q, q, A, b, n_iter=n_iter, tol=tol, n_f32=n_f32,
                     warm_start=warm_start)
            m = torch.maximum(torch.maximum(sol.rp, sol.rd), sol.gap) / tol
            for k, v in zip(self.qp_key(q, b), m.cpu().numpy()):
                self.qps.setdefault(k, []).append(float(v))
            return sol

        self.certify.certify_stage1_batch = stage1
        self.certify.certify_suboptimal_stage2 = stage2
        self.ipm.qp_solve = qp_solve
        return self

    def __exit__(self, *exc):
        (self.certify.certify_stage1_batch,
         self.certify.certify_suboptimal_stage2,
         self.ipm.qp_solve) = self._real
        return False


def explain_cell(key: bytes, p: int, outs: tuple, recs: tuple,
                 eps_a: float, point_key, simplex_key) -> list[str]:
    """Lines naming why two builds (baseline, kernel) decided one cell
    (of a p-dimensional tree) differently: each build's verdicts and gap
    against eps_a, the (vertex, commutation) point QPs whose convergence
    differs, and the commutations whose stage-2 bound differs, each with
    every recorded margin of its QP in both builds (all digits: the
    threshold is 1).  point_key(vertex, d) and simplex_key(verts, d)
    give a QP's recorder key."""
    verts = np.frombuffer(key, dtype=np.float64).reshape(p + 1, p).copy()
    ca, cb = (r.cells.get(key, {}) for r in recs)

    def margins(k):
        return tuple("/".join(f"{v:.15g}" for v in r.qps.get(k, []))
                     or "not recorded" for r in recs)
    lines = [f"cell {np.array2string(verts.ravel(), precision=6)}: "
             f"baseline {outs[0]}, kernel {outs[1]}"]
    for name, c in (("baseline", ca), ("kernel", cb)):
        g = c.get("gap2", c.get("gap1", np.inf))
        lines.append(f"  {name}: stage 1 {c.get('s1')}, stage 2 "
                     f"{c.get('s2')}, gap {g!r} = eps_a x "
                     f"{g / eps_a if np.isfinite(g) else g!r}")
    if "conv" in ca and "conv" in cb:
        for i, d in zip(*np.nonzero(ca["conv"] != cb["conv"])):
            ma, mb = margins(point_key(verts[i], int(d)))
            lines.append(
                f"  vertex {i} commutation {d}: converged "
                f"{bool(ca['conv'][i, d])} / {bool(cb['conv'][i, d])}, V "
                f"{float(ca['V'][i, d])!r} / {float(cb['V'][i, d])!r}; "
                f"margins {ma} / "
                f"{mb}")
        # The vertex's best commutation (the first minimum of V over the
        # converged ones) differs: both values in both builds, and how
        # far apart the two are within each build (the decision's
        # margin; 0 is an exact tie, which goes to the lower index).
        for i in np.nonzero(ca["dstar"] != cb["dstar"])[0]:
            da, db = int(ca["dstar"][i]), int(cb["dstar"][i])
            ln = f"  vertex {i}: best commutation {da} / {db}"
            if min(da, db) >= 0:
                pair = [(float(c["V"][i, da]), float(c["V"][i, db]))
                        for c in (ca, cb)]
                rel = [(x - y) / abs(y) for x, y in pair]
                ln += (f"; V[{da}], V[{db}] = {pair[0][0]!r}, "
                       f"{pair[0][1]!r} / {pair[1][0]!r}, {pair[1][1]!r}; "
                       f"(V[{da}] - V[{db}]) / |V[{db}]| = {rel[0]:.3g} / "
                       f"{rel[1]:.3g}")
            lines.append(ln)
    va, vb = ca.get("Vmin", {}), cb.get("Vmin", {})
    for d in sorted(va.keys() | vb.keys()):
        a, b = va.get(d), vb.get(d)
        if a is None or b is None or not (
                a == b or abs(a - b) <= 1e-9 * max(1.0, abs(b))):
            ma, mb = margins(simplex_key(verts, d))
            lines.append(f"  commutation {d}: stage-2 bound {a!r} / {b!r}; "
                         f"margins {ma} / {mb}")
    return lines


def raw_leg(fn, args, n_iter: int):
    """(launch, outputs): a launcher of the f64 leg `fn` (a ctypes
    function of ipm_leg.cu's C interface) on fixed inputs into fixed
    outputs, for timing.  It skips the wrapper's checks and allocations,
    so back-to-back launches keep the card busy even where a leg takes
    only tens of microseconds; it counts no launches."""
    import torch

    q, b, z, s, lam = args[1], args[3], args[4], args[5], args[6]
    outs = (torch.empty_like(z), torch.empty_like(s), torch.empty_like(lam))
    ptrs = [t.data_ptr() for t in (*args, *outs)]
    dims = (q.shape[0], q.shape[1], b.shape[1], int(n_iter))
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        err = fn(*ptrs, *dims, stream)
        if err:
            fail(f"a timed K1 leg failed to launch (error {err})")
    return launch, outs


def raw_k2(lib, th, bary, parent: bool):
    """(launch, (leaf, score)): a launcher of the locate kernel `lib`
    (this tree's locate.cu, or with `parent` its parent's C interface)
    on fixed float32 queries into fixed outputs, for timing; it skips
    the wrapper and counts no launches."""
    import torch

    from explicit_hybrid_mpc_tpu_torch.online import locate

    B, p = th.shape
    L = bary.shape[0]
    leaf = torch.empty(B, dtype=torch.int32, device=th.device)
    score = torch.empty(B, dtype=torch.float32, device=th.device)
    keep = [th, bary, leaf, score]
    if parent:
        args = (th.data_ptr(), bary.data_ptr(), B, L, p, leaf.data_ptr(),
                score.data_ptr())
    else:
        splits, per = locate.plan_splits(B, L, torch.cuda.get_device_properties(
            th.device).multi_processor_count)
        parts = [torch.empty((splits, B), dtype=d, device=th.device)
                 for d in (torch.int32, torch.float32)]
        keep += parts
        args = (th.data_ptr(), bary.data_ptr(), B, L, p, per, splits,
                leaf.data_ptr(), score.data_ptr(), parts[0].data_ptr(),
                parts[1].data_ptr())

    def launch():
        err = lib.locate_f32(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            fail(f"a timed K2 launch failed (error {err})")
    launch.keep = keep      # the buffers behind the pointers stay alive
    return launch, (leaf, score)


def raw_k3(lib, arena, buf, B: int, chunks: int, parent: bool):
    """(launch, records): a launcher of the arena kernel `lib` (this
    tree's arena_eval.cu, or with `parent` its parent's C interface) on
    one packed batch `buf` (DeviceArena.pack_queries, on the device)
    into fixed records, for timing; it skips the wrapper and counts no
    launches."""
    import torch

    from explicit_hybrid_mpc_tpu_torch.online import fused

    pp1, C = arena.p + 1, arena.bary.shape[2]
    q, ext, tiles = fused.split_queries(buf, B, pp1)
    rec = torch.empty((B, fused.REC_HEAD + arena.n_u), dtype=torch.int32,
                      device=buf.device)
    keep = [buf, rec]
    tensors = (arena.bary.data_ptr(), arena.U.data_ptr(), arena.V.data_ptr())
    if parent:
        args = (q.data_ptr(), ext.data_ptr(), *tensors, B, C, pp1 - 1,
                arena.n_u, rec.data_ptr())
    else:
        cnt, part = fused.Scratch(buf.device).take(tiles.shape[0], chunks)
        keep += [cnt, part]
        args = (q.data_ptr(), tiles.data_ptr(), tiles.shape[0], chunks,
                *tensors, B, C, pp1 - 1, arena.n_u, cnt.data_ptr(),
                part.data_ptr(), rec.data_ptr())

    def launch():
        err = lib.arena_eval_f32(*args,
                                 torch.cuda.current_stream().cuda_stream)
        if err:
            fail(f"a timed K3 launch failed (error {err})")
    launch.keep = keep      # the buffers behind the pointers stay alive
    return launch, rec


def in_turns(new, old, reps: int, timer=None
             ) -> tuple[float, float | None, str]:
    """(kernel ms, baseline ms, log text): `new` timed alone, or with a
    baseline `old` in turns (baseline, kernel, kernel, baseline), each
    by `timer` (graph_time unless given)."""
    timer = timer or graph_time
    if old is None:
        return timer(new, reps), None, ""
    ms, runs = in_turns_each(new, {"base": old}, reps, timer)
    b1, b2 = runs["base"]
    base_ms = (b1 + b2) / 2
    return ms, base_ms, (f"; baseline {base_ms:.4f} ms ({b1:.4f}/{b2:.4f}), "
                         f"{base_ms / ms:.2f}x")


def in_turns_each(new, olds: dict, reps: int, timer
                  ) -> tuple[float, dict]:
    """(kernel ms, {name: (first ms, last ms)}): `new` and every
    baseline of `olds` timed in turns by `timer` -- the baselines in
    order, the kernel twice, the baselines in reverse order."""
    first = {k: timer(f, reps) for k, f in olds.items()}
    m1, m2 = timer(new, reps), timer(new, reps)
    last = {k: timer(olds[k], reps) for k in reversed(list(olds))}
    return (m1 + m2) / 2, {k: (first[k], last[k]) for k in olds}


def ptxas_lines(name: str, report: str) -> list[str]:
    """One line per kernel function of a ptxas -v report: registers,
    stack frame and spill stores/loads (template arguments read back
    from the mangled name: K1's dtype, NZ and ROWS or the general
    path's NZB; K2's and K3's K = p+1)."""
    import re

    out, fn, frame = [], None, ""
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            # The name follows its length; the namespace before it
            # holds the file name (ipm_leg_cu_...), not preceded by one.
            fn = m.group(1)
            mm = re.search(r"\d(ipm_leg_\w+?)I([fd])(?:Li(\d+)E(?:Li(\d+)E)?)?E",
                           fn)
            mk = re.search(r"\d(locate_kernel|locate_merge|arena_eval_kernel)"
                           r"(?:ILi(\d+)EE)?", fn)
            if mm:
                dtype = "double" if mm.group(2) == "d" else "float"
                args = (f", NZ={mm.group(3)}, ROWS={mm.group(4)}"
                        if mm.group(4) else f", NZB={mm.group(3)}"
                        if mm.group(3) else "")
                fn = f"{mm.group(1)}<{dtype}{args}>"
            elif mk:
                fn = mk.group(1) + (f"<K={mk.group(2)}>" if mk.group(2)
                                    else "")
        elif "stack frame" in ln:
            frame = ln.strip()
        elif "registers" in ln and fn:
            regs = re.search(r"Used (\d+) registers", ln)
            out.append(f"{name}: {fn}: {regs.group(1) if regs else '?'} "
                       f"registers; {frame}")
            fn, frame = None, ""
    return out


def build_ab(base, problem, cfg, prob, dev) -> None:
    """Phase 10 (K1_BASELINE only): the flagship build with the baseline
    kernel `base` and with this one.  Four unrecorded builds in turns
    (baseline, kernel, kernel, baseline) give the build wall and each
    kernel's tree; where the trees differ, one recorded build with each
    explains every cell the two decide differently."""
    import torch

    from explicit_hybrid_mpc_tpu_torch.oracle import ipm, ipm_leg, oracle
    from explicit_hybrid_mpc_tpu_torch.partition import certify, geometry
    from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
        build_partition)

    real_lib = ipm_leg._lib

    def run(which, recorder=None):
        ipm_leg._lib = (lambda: base) if which == "baseline" else real_lib
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            if recorder is None:
                res = build_partition(problem, cfg)
            else:
                with recorder:
                    res = build_partition(problem, cfg)
            torch.cuda.synchronize()
        finally:
            ipm_leg._lib = real_lib
        wall = time.perf_counter() - t0
        st = res.stats
        log(f"[k1-ab] {which} build{' (recorded)' if recorder else ''} "
            f"{wall:.2f} s: regions {st['regions']}, uncertified "
            f"{st['uncertified']}, point solves {st['point_solves']}, "
            f"simplex solves {st['simplex_solves']}, steps {st['steps']}")
        if st["device_failures"] or st["truncated"]:
            fail(f"the {which} build failed on the device or was truncated")
        return tree_outcomes(res.tree), wall

    walls: dict = {"baseline": [], "kernel": []}
    outs: dict = {}
    for which in ("baseline", "kernel", "kernel", "baseline"):
        o, wall = run(which)
        walls[which].append(wall)
        if which in outs and o != outs[which]:
            fail(f"two {which} builds gave different trees")
        outs[which] = o
    mb, mk = (sum(walls[w]) / 2 for w in ("baseline", "kernel"))
    log(f"[k1-ab] build wall in turns: baseline "
        f"{', '.join(f'{w:.2f}' for w in walls['baseline'])} s, kernel "
        f"{', '.join(f'{w:.2f}' for w in walls['kernel'])} s; means "
        f"{mb:.2f} / {mk:.2f} s = kernel/baseline {mk / mb:.3f}")
    a, k = outs["baseline"], outs["kernel"]
    diff, other = differing_cells(a, k)
    log(f"[k1-ab] trees: {len(a.keys() & k.keys())} cells in both, "
        f"{len(a.keys() - k.keys())} in the baseline's only, "
        f"{len(k.keys() - a.keys())} in the kernel's only; {len(diff)} "
        f"decided differently; {other} leaves closed with another "
        "commutation")
    if not diff:
        return
    recs = (DecisionRecorder(certify, ipm), DecisionRecorder(certify, ipm))
    for which, rec in zip(("baseline", "kernel"), recs):
        o, _ = run(which, rec)
        if o != outs[which]:
            log(f"[k1-ab] the recorded {which} build's tree differs from "
                "its unrecorded builds'")

    def point_key(v, d):
        _Q, q, _A, b = oracle.point_qp(
            prob, torch.as_tensor(v[None], device=dev),
            torch.as_tensor([d], device=dev))
        return DecisionRecorder.qp_key(q, b)[0]

    def simplex_key(verts, d):
        M = torch.as_tensor(geometry.barycentric_matrix(verts)[None],
                            device=dev)
        _Q, q, _A, b = oracle.simplex_min_qp(
            prob, M, torch.as_tensor([d], device=dev))
        return DecisionRecorder.qp_key(q, b)[0]

    for key in diff[:20]:
        for ln in explain_cell(key, problem.canonical.n_theta,
                               (a[key], k[key]), recs, cfg.eps_a,
                               point_key, simplex_key):
            log(f"[k1-ab] {ln}")


def serve_queries(tenants, lb, ub, n, rng):
    """n serving queries, tenants round-robin, OUTSIDE_FRAC of them
    pushed 5-50% past the certified box along a random direction:
    (names, thetas, outside mask)."""
    names = [tenants[i % len(tenants)] for i in range(n)]
    th = rng.uniform(lb, ub, (n, lb.size))
    out = rng.uniform(size=n) < OUTSIDE_FRAC
    d = rng.normal(size=(int(out.sum()), lb.size))
    d /= np.abs(d).max(axis=1, keepdims=True)
    th[out] = (lb + ub) / 2 + (ub - lb) / 2 * d \
        * rng.uniform(1.05, 1.5, (d.shape[0], 1))
    return names, th, out


def same_result(a, b) -> bool:
    """Two ServeResults bitwise equal (u, cost, leaf, flags, version)."""
    return (np.array_equal(a.u, b.u) and a.cost == b.cost
            and (a.leaf, a.inside, a.version, a.fallback)
            == (b.leaf, b.inside, b.version, b.fallback))


def closed_loop(sched, names, th, clients: int, mid=None):
    """Requests j (names[j], th[j]) from `clients` closed-loop threads
    through the ArenaScheduler `sched`, which is closed at the end;
    mid() runs on this thread once half are answered.  Fails on any
    errored or dropped request.  Returns (results, latencies s, submit
    times, wall s)."""
    import threading

    n = len(names)
    results = [None] * n
    t_sub, lat = np.zeros(n), np.zeros(n)
    errors: list[str] = []
    lock = threading.Lock()
    done = [0]
    halfway = threading.Event()

    def client(c):
        for j in range(c, n, clients):
            t0 = time.perf_counter()
            try:
                r = sched.submit(names[j], th[j]).result(60.0)[0]
            except BaseException as e:  # noqa: BLE001 -- counted, fails
                with lock:
                    errors.append(f"request {j}: {e!r}")
                continue
            lat[j], t_sub[j], results[j] = time.perf_counter() - t0, t0, r
            with lock:
                done[0] += 1
                if done[0] == n // 2:
                    halfway.set()

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    t_run = time.perf_counter()
    for t in threads:
        t.start()
    if mid is not None:
        if not halfway.wait(600.0):
            fail("a serving run did not reach half its requests")
        mid()
    for t in threads:
        t.join()
    sched.close()
    wall = time.perf_counter() - t_run
    dropped = sum(r is None for r in results)
    if errors or dropped:
        fail(f"serving run: {len(errors)} errored, {dropped} dropped "
             f"requests ({errors[:3]})")
    return results, lat, t_sub, wall


def arena_eval_cost(ext, B, pp1, n_u) -> tuple[float, float]:
    """(bytes, flops) one launch needs: every row scores its own
    tenant's leaves, (p+1)^2 FMAs each; the live extents' bary is read
    once, each row's query planes and extent read once, its record
    written once and its winner's U/V rows gathered once."""
    rows_l = (ext[:, 1] - ext[:, 0]).astype(np.float64)
    flops = 2.0 * float(rows_l.sum()) * pp1 * pp1
    live = {(int(s), int(e)) for s, e in ext}
    nbytes = 4.0 * (sum(e - s for s, e in live) * pp1 * pp1
                    + B * (3 * pp1 + 2) + B * (4 + n_u)
                    + B * pp1 * (n_u + 1))
    return nbytes, flops


def tenant_arenas(dev, res, table, tmp: str) -> dict:
    """Phase 8's publish history: phase 3's tree saved as t0's v1
    artifact, and a v2 delta of it with half of the payload slots
    doubled -- exact in floating point, so a read that mixes versions
    shows bit for bit.  Returns the tenants, the two directories, the
    delta's stats, the certified box, and fresh(obs=None): an arena on
    `dev` with t0 v1 from the artifact, the other tenants from `table`,
    and room for one more extent (the delta's)."""
    from explicit_hybrid_mpc_tpu_torch.lifecycle.delta import (
        write_delta_artifact)
    from explicit_hybrid_mpc_tpu_torch.online.descent import load_descent
    from explicit_hybrid_mpc_tpu_torch.serve import DeviceArena, registry

    tenants = [f"t{k}" for k in range(TENANTS)]
    v1_dir = os.path.join(tmp, "t0_v1")
    d2_dir = os.path.join(tmp, "t0_v2.delta")
    registry.save_artifacts(res.tree, res.roots, v1_dir)
    v2 = res.tree.clone()
    half = v2._n_slots // 2
    v2._pl_inputs[:half] *= 2.0
    v2._pl_costs[:half] *= 2.0
    dstats = write_delta_artifact(v2, res.roots, d2_dir, v1_dir,
                                  base_version="v1")
    lb, ub = registry.root_box(load_descent(os.path.join(v1_dir,
                                                         "descent.npz")))
    cols = 128 * -(-table.n_leaves // 128)

    def fresh(obs=None):
        a = DeviceArena(p=res.tree.p, n_u=res.tree.n_u,
                        capacity_cols=(TENANTS + 1) * cols, device=dev,
                        obs=obs)
        a.publish_from_artifacts("t0", "v1", v1_dir)
        for n in tenants[1:]:
            a.publish(n, "v1", table, lb, ub)
        return a

    return dict(tenants=tenants, v1_dir=v1_dir, d2_dir=d2_dir,
                dstats=dstats, lb=lb, ub=ub, fresh=fresh)


def serve_phases(dev, res, table, rng, tmp: str, base_k3=None,
                 k3_src: str | None = None) -> dict:
    """Phases 6-8: the flagship table served to TENANTS tenants from one
    device arena, the arena kernel against its plain version, and a
    closed-loop serving run with a mid-traffic delta hot swap and a
    bitwise torn-read audit.  `base_k3`: the parent's arena kernel
    (K3_BASELINE), timed in turns and held bitwise.  Returns the
    kernel's entry of the kernels line."""
    import torch

    from explicit_hybrid_mpc_tpu_torch import obs as obs_lib
    from explicit_hybrid_mpc_tpu_torch.online import fused
    from explicit_hybrid_mpc_tpu_torch.serve import (ArenaScheduler,
                                                     FallbackPolicy)

    # -- phase 6: the arena on the card -------------------------------------
    ten = tenant_arenas(dev, res, table, tmp)
    tenants, v1_dir, d2_dir = ten["tenants"], ten["v1_dir"], ten["d2_dir"]
    dstats, lb, ub, fresh_arena = (ten["dstats"], ten["lb"], ten["ub"],
                                   ten["fresh"])
    L, p, n_u = table.n_leaves, res.tree.p, res.tree.n_u
    pp1 = p + 1

    o = obs_lib.Obs("jsonl")
    arena = fresh_arena(o)
    ast = arena.stats()
    log(f"[arena] {TENANTS} tenants x {L} leaves (p={p}, n_u={n_u}) in "
        f"{arena.capacity_cols} columns on {dev}: resident "
        f"{ast['resident_bytes']} bytes ({arena._col_bytes()} per column, "
        f"U sized by n_u); v2 delta {dstats['n_fresh']} fresh / "
        f"{dstats['n_kept']} kept rows, {dstats['delta_bytes']} bytes")

    # -- phase 7: K3 (arena_eval) against its plain version -----------------
    exts = {n: arena.extent(n) for n in tenants}

    def score_at(q, rows, cols):
        # The plain score min_i thc . bary[i, :, col] of the given rows at
        # the given columns, elementwise in float32 (no TF32).
        thc = torch.minimum(torch.maximum(q[0, rows], q[1, rows]),
                            q[2, rows])
        return (thc.T[None] * arena.bary[:, :, cols]).sum(1).amin(0)

    def rel(a, b):
        return (a - b).abs() / b.abs().clamp(min=1)

    def k3_bound(buf, B):
        # (bound ms, by, bytes, flops) of one launch on a packed batch.
        nbytes, flops = arena_eval_cost(
            buf[3 * B * pp1:3 * B * pp1 + 2 * B].reshape(B, 2), B, pp1, n_u)
        return (1e3 * max(nbytes / PEAK_BYTES_S, flops / PEAK_F32_S),
                "bytes" if nbytes / PEAK_BYTES_S > flops / PEAK_F32_S
                else "operations", nbytes, flops)

    def k3_batch(exts_, B):
        # B rows of the serving mix, NaN rows every max(16, B // 4) from
        # row 7 (clamped, never served), packed as the arena packs a
        # batch -- its launch plan included -- and uploaded.
        names, th, out = serve_queries(tenants, lb, ub, B, rng)
        nan = np.zeros(B, dtype=bool)
        nan[7::max(16, B // 4)] = True
        th[nan, np.arange(B)[nan] % p] = np.nan
        buf, _, chunks = arena.pack_queries(exts_, names, th)
        return buf, torch.as_tensor(buf).to(dev), chunks, out, nan

    def most(t):
        return float(t.max()) if t.numel() else 0.0

    scratch = fused.Scratch(dev)

    def check_k3(B, bufd, chunks, out, nan):
        # K3 through its wrapper with the batch's own plan, twice, held
        # against its plain version on the same input.  Returns the
        # records and the largest |d val|, |d u|, |d cost|.
        q, e, tiles = fused.split_queries(bufd, B, pp1)
        args = (arena.bary, arena.U, arena.V, q, e)
        plan = fused.Plan(chunks, tiles, B)
        rk = fused.arena_eval_cuda(*args, plan, scratch)
        rk2 = fused.arena_eval_cuda(*args, plan, scratch)
        rp = fused.arena_eval_torch(*args)
        torch.cuda.synchronize()
        if not torch.equal(rk, rk2):
            fail(f"K3 B={B}: two launches on the same input differ")
        kv, kc, ku, kcost, kcl = fused.unpack(rk)
        pv, pc, pu, pcost, pcl = fused.unpack(rp)
        if not bool(((kc >= e[:, 0]) & (kc < e[:, 1])).all()):
            fail(f"K3 B={B}: a row won a column outside its extent")
        if not torch.equal(kcl, pcl):
            fail(f"K3 B={B}: clamped flags differ on "
                 f"{int((kcl != pcl).sum())} rows")
        if int(kcl.sum()) != int((out | nan).sum()):
            fail(f"K3 B={B}: {int(kcl.sum())} rows clamped, "
                 f"{int((out | nan).sum())} drawn outside the box or NaN")
        # NaN rows: val NaN at the extent's first column on both, so
        # unserved; no other row is NaN.
        nan_t = torch.as_tensor(nan, device=dev)
        if not (torch.equal(torch.isnan(kv), nan_t)
                and torch.equal(torch.isnan(pv), nan_t)
                and torch.equal(kc[nan_t], e[nan_t, 0])
                and torch.equal(pc[nan_t], e[nan_t, 0])):
            fail(f"K3 B={B}: the {int(nan.sum())} NaN rows are not NaN at "
                 "their extent's first column on both")
        fin = ~nan_t
        # Tie-free rows: the winner's score clears 1e-5, so the query is
        # strictly inside one leaf and every other leaf scores below 0.
        clear = pv > 1e-5
        n_clear = int(clear.sum())
        if not torch.equal(kc[clear], pc[clear]):
            fail(f"K3 B={B}: columns differ on "
                 f"{int((kc != pc)[clear].sum())} of {n_clear} tie-free "
                 "rows")
        # Served on both, except rows within the tolerance of the
        # threshold itself.
        edge = rel(-pv, torch.full_like(pv, arena.tol)) <= 1e-5
        if not torch.equal((kv >= -arena.tol)[~edge],
                           (pv >= -arena.tol)[~edge]):
            fail(f"K3 B={B}: served flags differ")
        # val on every finite row, u/cost on every finite row whose
        # column agrees: the same float32 products summed in another
        # order, a few ulps apart -- held to 1e-5 times max(1, |value|).
        # Where the columns differ (a tie on a shared facet, clamped rows
        # on the box's boundary among them), the plain score at the
        # kernel's column is held to 1e-5 of the plain maximum.
        same = (kc == pc) & fin
        diff = torch.nonzero((kc != pc) & fin)[:, 0]
        gap = rel(score_at(q, diff, kc[diff].long()), pv[diff])
        worst = {"val": most(rel(kv, pv)[fin]),
                 "u": most(rel(ku, pu)[same]),
                 "cost": most(rel(kcost, pcost)[same]), "tie": most(gap)}
        if not max(worst.values()) <= 1e-5:
            fail(f"K3 B={B}: relative differences {worst} (> 1e-5)")
        err = max(most((kv - pv)[fin].abs()), most((ku - pu)[same].abs()),
                  most((kcost - pcost)[same].abs()))
        log(f"[K3] B={B} ({tiles.shape[0]} tiles x {chunks} chunks) against "
            f"the plain version: columns equal on {n_clear} tie-free and "
            f"{int(same.sum()) - n_clear} other finite rows, {diff.numel()} "
            f"differ within {worst['tie']:.2e} of the plain maximum; "
            f"{int(kcl.sum())} clamped ({int(nan.sum())} NaN rows unserved "
            f"on both); two launches bitwise equal; max |d val,u,cost| "
            f"{err:.2e} (relative to max(1, |value|): val "
            f"{worst['val']:.2e}, u {worst['u']:.2e}, cost "
            f"{worst['cost']:.2e})")
        return rk, err

    # Each size: the wrapper against the plain version (above), then K3
    # through its C interface on the same buffers, timed by graph replay
    # (the wrapper's host work would pace microsecond launches); its
    # records equal the wrapper's on every row, and with K3_BASELINE the
    # parent's kernel runs in turns and its records must be bitwise the
    # same.
    log(f"[K3] sweep over {TENANTS} tenants x {L} leaves at the serving mix "
        f"(tenants round-robin, {OUTSIDE_FRAC:.0%} outside the box), device "
        "time by graph replay" + (f", against the baseline {k3_src} in "
                                  "turns" if base_k3 else ""))
    k3_err = 0.0
    for Bs in K3_SWEEP_B:
        buf, bufd, chunks, out, nan = k3_batch(exts, Bs)
        rk, err = check_k3(Bs, bufd, chunks, out, nan)
        k3_err = max(k3_err, err)
        new, nrec = raw_k3(fused._lib(), arena, bufd, Bs, chunks, False)
        new()
        torch.cuda.synchronize()
        if not torch.equal(nrec, rk):
            fail(f"K3 B={Bs}: the raw launch and the wrapper's differ")
        old = None
        if base_k3:
            old, orec = raw_k3(base_k3, arena, bufd, Bs, chunks, True)
            old()
            torch.cuda.synchronize()
            if not torch.equal(nrec, orec):
                fail(f"K3 B={Bs}: records differ bitwise from the "
                     f"baseline's on {int((nrec != orec).any(1).sum())} of "
                     f"{Bs} rows")
        ms, _base_ms, vs = in_turns(new, old, 200 if Bs <= MAX_BATCH else 10)
        bound_ms, bound_by, _nb, _fl = k3_bound(buf, Bs)
        log(f"[K3]   B={Bs}: kernel {ms:.4f} ms, bound {bound_ms:.5f} ms "
            f"({bound_by}){vs}"
            + ("; records bitwise equal to the baseline's on every row"
               if base_k3 else ""))

    # -- phase 8: the serving run -------------------------------------------
    names, th, out = serve_queries(tenants, lb, ub, REQUESTS, rng)

    real_pack = arena.pack_queries

    def recording(batches):
        # The arena's packing, noting every batch's rows and extents on
        # the host (reading them back from the device would synchronize):
        # a copy of 2 x rows int32 words a batch.
        def pack(exts_, names_, thetas_, clamp=True):
            out_ = real_pack(exts_, names_, thetas_, clamp)
            nb_ = len(thetas_)
            batches.append((nb_, out_[0][3 * nb_ * pp1:3 * nb_ * pp1 + 2 * nb_]
                            .reshape(nb_, 2).copy()))
            return out_
        return pack

    fb = FallbackPolicy(lb, ub, mode="clamp", obs=o)
    sched = ArenaScheduler(arena, max_batch=MAX_BATCH,
                           max_wait_us=MAX_WAIT_US, fallback=fb, obs=o)
    sw = {}

    def swap():
        sw["e_v1"] = arena.extent("t0")
        t_sw = time.perf_counter()
        arena.publish_delta("t0", "v2", d2_dir, v1_dir)
        sw["t_flip"] = time.perf_counter()
        sw["us"] = (sw["t_flip"] - t_sw) * 1e6

    batches: list = []
    arena.pack_queries = recording(batches)
    fused.launches = 0
    try:
        results, lat, t_sub, run_s = closed_loop(sched, names, th, CLIENTS,
                                                 swap)
    finally:
        del arena.pack_queries
    n_launch = fused.launches
    t_flip, swap_us = sw["t_flip"], sw["us"]
    drained = arena.wait_retired(sw["e_v1"], 30.0)

    if n_launch != sched.n_batches or n_launch <= 0:
        fail(f"arena_eval launched {n_launch} times for "
             f"{sched.n_batches} scheduler batches")
    if not drained:
        fail("the v1 extent of t0 never retired after the swap")
    versions = [r.version for r in results]
    late = [j for j in range(REQUESTS) if versions[j] == "v1"
            and names[j] == "t0" and t_sub[j] > t_flip]
    if late:
        fail(f"{len(late)} requests submitted after the swap were served "
             "by the retired v1")
    if "v2" not in versions or "v1" not in versions:
        fail(f"the swap was not mid-traffic: versions {set(versions)}")
    # Fallback counters against account_kernel's rule: outside_box =
    # clamped rows (the rows drawn outside), hole = unclamped unserved,
    # 'clamp' = clamped and served, everything else bad is 'unserved'.
    cnt = o.metrics.snapshot()["counters"]
    tags = [r.fallback for r in results]
    n_out, n_clamp = int(out.sum()), tags.count("clamp")
    n_unserved = tags.count("unserved")
    hole = sum(1 for j in range(REQUESTS)
               if not out[j] and tags[j] is not None)
    checks = {
        "outside_box": (cnt.get("serve.fallback.outside_box", 0), n_out),
        "hole": (cnt.get("serve.fallback.hole", 0), hole),
        "clamp": (cnt.get("serve.fallback.clamp", 0), n_clamp),
        "unserved": (cnt.get("serve.fallback.unserved", 0), n_unserved),
        "requests": (cnt.get("serve.fallback.requests", 0),
                     n_clamp + n_unserved),
        "per-tenant outside_box": (
            sum(cnt.get(f"serve.ctl.{n}.fallback.outside_box", 0)
                for n in tenants), n_out),
        "seen": (fb.n_seen, REQUESTS),
    }
    bad = {k: v for k, v in checks.items() if v[0] != v[1]}
    wrong_tag = sum(1 for j in range(REQUESTS)
                    if (out[j] and tags[j] is None)
                    or (tags[j] in (None, "clamp")) != results[j].inside)
    if bad or wrong_tag or n_clamp + n_unserved != n_out + hole:
        fail(f"fallback counters do not reconcile: {bad}, {wrong_tag} "
             "rows tagged against their flags")

    # Torn-read audit: a reference arena on the card with the same
    # publish history re-evaluates every recorded in-box row on the
    # version that served it; the kernel is deterministic and a row's
    # answer does not depend on its batch, so any cross-version read
    # shows bit for bit.
    ref = fresh_arena()
    audit_launch0 = fused.launches

    def audit(rows):
        bad = 0
        for lo in range(0, len(rows), MAX_BATCH):
            chunk = rows[lo:lo + MAX_BATCH]
            r = ref.evaluate([names[j] for j in chunk], th[chunk])
            for k, j in enumerate(chunk):
                s = results[j]
                bad += not (np.array_equal(s.u,
                                           r.u[k, :n_u].astype(np.float64))
                            and s.cost == float(r.cost[k])
                            and s.leaf == int(r.leaf[k]))
        return bad

    inbox = [j for j in range(REQUESTS) if not out[j]]
    rows_v1 = [j for j in inbox if versions[j] == "v1"]
    rows_v2 = [j for j in inbox if versions[j] == "v2"]
    torn = audit(rows_v1)
    # The audit can tell the versions apart: t0's v2 rows read against v1.
    cross = audit([j for j in rows_v2 if names[j] == "t0"])
    ref.publish_delta("t0", "v2", d2_dir, v1_dir)
    torn += audit(rows_v2)
    if torn:
        fail(f"{torn} torn reads: served rows differ bitwise from the "
             "reference arena's answer for their version")
    if cross == 0:
        fail("the audit cannot tell v1 from v2 (no t0 v2 row differs)")
    lat_us = lat * 1e6
    log(f"[serve] {REQUESTS} requests from {CLIENTS} closed-loop clients "
        f"over {TENANTS} tenants in {run_s:.2f} s "
        f"({REQUESTS / run_s:.0f} req/s): p50 "
        f"{np.percentile(lat_us, 50):.1f} us, p99 "
        f"{np.percentile(lat_us, 99):.1f} us; {sched.n_batches} launches "
        f"= {sched.n_batches / REQUESTS:.4f} launches per request "
        f"(mean batch {REQUESTS / sched.n_batches:.1f} rows)")
    t0_v = [v for v, n in zip(versions, names) if n == "t0"]
    log(f"[serve] publish_delta swap {swap_us:.1f} us mid-traffic; t0 "
        f"served v1 {t0_v.count('v1')}, v2 {t0_v.count('v2')} times; 0 "
        f"dropped, 0 errored, v1 drained; torn reads 0 of "
        f"{len(rows_v1) + len(rows_v2)} audited in-box rows (t0 v2 rows "
        f"that differ from v1: {cross}; audit launches "
        f"{fused.launches - audit_launch0}, not counted)")
    log(f"[serve] fallback: outside_box {n_out}, hole {hole}, clamp "
        f"{n_clamp}, unserved {n_unserved} (reconciled with "
        f"account_kernel); resident {arena.stats()['resident_bytes']} "
        "bytes")
    from collections import Counter

    def batch_bound_ms(bs):
        return sum(1e3 * max(nb_ / PEAK_BYTES_S, fl_ / PEAK_F32_S)
                   for nb_, fl_ in (arena_eval_cost(e_, b, pp1, n_u)
                                    for b, e_ in bs))

    if len(batches) != n_launch:
        fail(f"{len(batches)} batches packed, {n_launch} launches counted")
    hist = Counter(b for b, _ in batches)
    rows = hist.most_common(1)[0][0]
    log(f"[batches] {len(batches)} launches of the serving run, rows: "
        + ", ".join(f"{b} x{n}" for b, n in sorted(hist.items())))
    log(f"[batches] most frequent {rows} rows, mean "
        f"{sum(b for b, _ in batches) / len(batches):.2f}; summed bound "
        f"{batch_bound_ms(batches):.4f} ms")

    # K3's device time while serving: a second run of PROFILED_REQUESTS of
    # the same requests (no swap) under torch.profiler, kept apart from
    # the timed run so that the profiler's cost stays out of its p50/p99.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sched_p = ArenaScheduler(arena, max_batch=MAX_BATCH,
                             max_wait_us=MAX_WAIT_US,
                             fallback=FallbackPolicy(lb, ub, mode="clamp"))
    prof_batches: list = []
    arena.pack_queries = recording(prof_batches)
    launch0 = fused.launches
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as sprof:
            _res, _lat, _ts, prof_s = closed_loop(
                sched_p, names[:PROFILED_REQUESTS], th[:PROFILED_REQUESTS],
                CLIENTS)
    finally:
        del arena.pack_queries
    prof_launches = fused.launches - launch0
    if prof_launches != len(prof_batches):
        fail(f"{len(prof_batches)} batches packed, {prof_launches} launches "
             "counted in the profiled run")
    prof_bound_ms = batch_bound_ms(prof_batches)
    prows = [(e.key, e.self_device_time_total, e.count)
             for e in sprof.key_averages()
             if e.device_type == DeviceType.CUDA
             and e.self_device_time_total > 0]
    k3_rows = [r for r in prows if "arena_eval_kernel" in r[0]]
    prof_ms = sum(r[1] for r in k3_rows) / 1e3 if k3_rows else None
    if k3_rows:
        busy_ms = sum(r[1] for r in prows) / 1e3
        log(f"[profile] K3 (arena_eval) in a profiled serving run of "
            f"{PROFILED_REQUESTS} requests: {prof_ms:.4f} ms of device time "
            f"in {sum(r[2] for r in k3_rows)} launches "
            f"({1e3 * prof_ms / prof_launches:.2f} us a launch), "
            f"{prof_ms / prof_bound_ms:.1f}x their summed bound "
            f"{prof_bound_ms:.4f} ms; device busy {busy_ms:.2f} ms of the "
            f"{1e3 * prof_s:.0f} ms run (idle "
            f"{1 - busy_ms / 1e3 / prof_s:.4f})")
    else:
        log("[profile] K3's device time while serving: not measured (the "
            "profiler recorded no device time)")

    # K3 at the run's most frequent batch size, the kernels line's cell:
    # against its plain version, then timed.
    exts = {n: arena.extent(n) for n in tenants}
    buf, bufd, chunks, out_m, nan_m = k3_batch(exts, rows)
    rk, err = check_k3(rows, bufd, chunks, out_m, nan_m)
    k3_err = max(k3_err, err)
    new, nrec = raw_k3(fused._lib(), arena, bufd, rows, chunks, False)
    new()
    torch.cuda.synchronize()
    if not torch.equal(nrec, rk):
        fail(f"K3 B={rows}: the raw launch and the wrapper's differ")
    old = None
    if base_k3:
        old, orec = raw_k3(base_k3, arena, bufd, rows, chunks, True)
        old()
        torch.cuda.synchronize()
        if not torch.equal(nrec, orec):
            fail(f"K3 B={rows}: records differ bitwise from the baseline's")
    ms, _base_ms, vs = in_turns(new, old, 200)
    # The same launches back to back from Python, by events: the host's
    # pace, which graph replay leaves out.
    b2b_ms = cuda_time(new, 200)
    q, e, _tiles = fused.split_queries(bufd, rows, pp1)
    plain_ms = cuda_time(
        lambda: fused.arena_eval_torch(arena.bary, arena.U, arena.V, q, e),
        20)
    bound_ms, bound_by, nbytes, flops = k3_bound(buf, rows)
    log(f"[K3] B={rows} (the run's most frequent batch): kernel {ms:.4f} ms "
        f"by graph replay ({b2b_ms:.4f} ms a launch back to back from "
        f"Python), plain {plain_ms:.3f} ms, bound {bound_ms:.5f} ms "
        f"({bound_by}: {flops / 1e9:.5f} GFLOP, {nbytes / 1e6:.3f} MB){vs}")
    # Where a batch's time goes: one CLIENTS-row batch (the run's mean
    # batch) through arena.evaluate on this thread -- packing (the launch
    # plan included), one put, the launch and one device-to-host copy --
    # and the packing and the plan alone.
    nb, thb = names[:CLIENTS], th[:CLIENTS]
    for _ in range(5):
        arena.evaluate(nb, thb)
    t0 = time.perf_counter()
    for _ in range(200):
        arena.evaluate(nb, thb)
    ev_us = (time.perf_counter() - t0) / 200 * 1e6
    t0 = time.perf_counter()
    for _ in range(2000):
        pbuf, _, _ = arena.pack_queries(exts, nb, thb)
    pack_us = (time.perf_counter() - t0) / 2000 * 1e6
    ext_b = pbuf[3 * CLIENTS * pp1:3 * CLIENTS * pp1 + 2 * CLIENTS] \
        .reshape(CLIENTS, 2)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    t0 = time.perf_counter()
    for _ in range(2000):
        fused.plan_batch(ext_b, n_sm)
    plan_us = (time.perf_counter() - t0) / 2000 * 1e6
    cycle_ms = 1e3 * run_s / sched.n_batches
    log(f"[serve] batch cycle {cycle_ms:.3f} ms = {MAX_WAIT_US / 1e3:.1f} "
        f"ms deadline + host work; one {CLIENTS}-row arena.evaluate "
        f"{ev_us:.0f} us host wall, its pack_queries {pack_us:.1f} us of "
        f"which plan_batch {plan_us:.1f} us; the kernel at {rows} rows "
        f"{1e3 * ms:.1f} us")
    o.close()
    return {"name": "arena_eval", "route": "cuda",
            "source": "explicit_hybrid_mpc_tpu_torch/csrc/arena_eval.cu",
            "replaces": "explicit_hybrid_mpc_tpu/online/pallas_eval.py:266",
            "launches": n_launch, "max_abs_err": k3_err, "rows": rows,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "profiled_launches": prof_launches, "profiled_ms": prof_ms,
            "profiled_bound_ms": prof_bound_ms}


def host_scores(table, theta: np.ndarray) -> np.ndarray:
    """(L,) f64 containment margin of one theta in every leaf (host)."""
    return (table.bary_M @ np.append(theta, 1.0)).min(axis=1)


def host_eval(table, thetas: np.ndarray, tol: float = 1e-9,
              chunk: int = 256) -> tuple:
    """evaluator.evaluate_np over a batch, vectorized in query chunks:
    (u, cost, inside) in f64 numpy on the host, the first best leaf."""
    us, costs, ins = [], [], []
    for lo in range(0, thetas.shape[0], chunk):
        th1 = np.concatenate([thetas[lo:lo + chunk],
                              np.ones((len(thetas[lo:lo + chunk]), 1))], 1)
        lam = np.einsum("lij,bj->bli", table.bary_M, th1)
        score = lam.min(axis=2)
        leaf = np.argmax(score, axis=1)
        lb = lam[np.arange(leaf.size), leaf]
        us.append(np.einsum("bi,bin->bn", lb, table.U[leaf]))
        costs.append((lb * table.V[leaf]).sum(axis=1))
        ins.append(score[np.arange(leaf.size), leaf] >= -tol)
    return np.concatenate(us), np.concatenate(costs), np.concatenate(ins)


def device_profile(fn, dev) -> tuple[int | None, float | None]:
    """(CUDA kernels launched, their summed device microseconds) of one
    call of `fn`, by torch.profiler -- (None, None) on a CPU device or
    when the profiler records no kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if dev.type != "cuda":
        return None, None
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not e.key.startswith(("Memcpy", "Memset"))]
    n = sum(e.count for e in rows)
    if not n:
        return None, None
    return n, float(sum(e.self_device_time_total for e in rows))


def closed_loop_phase(dev, problem, cfg, table, tmp: str) -> dict:
    """Phase 11: the main path's last step.  simulator.compare on the
    flagship table and the build's oracle configuration, on `dev`, the
    explicit controller through K2 (kernel backend), from 0.8 *
    theta_ub for SIM_T steps, with K1 and K2 counted from zero; both
    loops held step by step to plain f64 references; then `main
    --simulate` once on the tier-1 double integrator.  Returns the
    phase's numbers."""
    import contextlib
    import io

    import torch

    from explicit_hybrid_mpc_tpu_torch import main as tmain
    from explicit_hybrid_mpc_tpu_torch.online import evaluator, locate
    from explicit_hybrid_mpc_tpu_torch.oracle import ipm_leg
    from explicit_hybrid_mpc_tpu_torch.partition.frontier import make_oracle
    from explicit_hybrid_mpc_tpu_torch.sim import simulator

    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    ora = make_oracle(problem, cfg)
    theta0 = 0.8 * problem.theta_ub
    legs: list = []
    real = ipm_leg.ipm_leg_cuda
    ipm_leg.ipm_leg_cuda = record_legs(real, legs)
    ipm_leg.launches = 0
    locate.launches = 0
    try:
        cmp = simulator.compare(problem, table, ora, theta0, T=SIM_T,
                                backend="kernel", device=dev)
    finally:
        ipm_leg.ipm_leg_cuda = real
    n_k1, n_k2 = ipm_leg.launches, locate.launches
    ex, im = cmp.explicit, cmp.implicit
    log(f"[sim] flagship closed loop, T={SIM_T} from 0.8*theta_ub on "
        f"{dev}: cost_ratio {cmp.cost_ratio:.6f} (explicit "
        f"{ex.total_cost:.6f}, implicit {im.total_cost:.6f}); explicit "
        f"{ex.mean_eval_us:.1f} us/step (median "
        f"{1e6 * float(np.median(ex.eval_s)):.1f}), implicit "
        f"{im.mean_eval_us:.1f} us/step (median "
        f"{1e6 * float(np.median(im.eval_s)):.1f}), speedup "
        f"{cmp.speedup:.1f}x; launches counted from zero: ipm_leg {n_k1}, "
        f"locate {n_k2}")
    if len(legs) != n_k1:
        fail(f"closed loop: {len(legs)} K1 launches recorded, {n_k1} "
             "counted")
    if on_card and (n_k1 <= 0 or n_k2 <= 0):
        fail(f"closed loop: a kernel of the path never launched (ipm_leg "
             f"{n_k1}, locate {n_k2})")
    if legs:
        shapes: dict = {}
        for k in legs:
            shapes[k] = shapes.get(k, 0) + 1
        log("[sim] K1 launches (K, nz, nc, n_iter) x count: " + ", ".join(
            f"{k} x {n}" for k, n in sorted(shapes.items())))
    if not (np.isfinite(ex.states).all() and np.isfinite(im.states).all()):
        fail("closed loop: non-finite states")

    # The explicit loop, step by step: at every theta it visited the f64
    # host evaluator gives the same u (1e-9), except at leaf ties (the
    # plain winning score within SIM_LEAF_TIE of the runner-up's, where a
    # float32 score may pick either leaf); K2 at B = 1 against its plain
    # version at the same thetas.
    lt = locate.stage(table, device=dev)
    ties = 0
    inside_diff = []
    worst = 0.0
    for k, x in enumerate(ex.states[:-1]):
        th = problem.theta_of_state(x)
        s = host_scores(table, th)
        second, best = np.partition(s, -2)[-2:]
        kl, ks = locate.locate(lt, torch.as_tensor(th[None], device=dev))
        pl_, ps = locate.locate_torch(lt.bary, torch.as_tensor(
            th[None], device=dev))
        if best - second < SIM_LEAF_TIE:
            ties += 1
            continue
        if int(kl[0]) != int(pl_[0]) \
                or abs(float(ks[0]) - float(ps[0])) > 1e-5:
            fail(f"closed loop step {k}: K2 at B=1 gives leaf {int(kl[0])} "
                 f"score {float(ks[0])}, its plain version {int(pl_[0])} "
                 f"{float(ps[0])}")
        err = float(np.abs(ex.inputs[k] - evaluator.evaluate_np(table, th))
                    .max())
        worst = max(worst, err)
        if err > 1e-9:
            fail(f"closed loop step {k}: explicit u differs from the f64 "
                 f"host evaluator by {err:.2e}")
        if bool(ex.inside[k]) != bool(best >= -1e-4):
            inside_diff.append((k, float(best)))
    log(f"[sim] explicit held at {SIM_T - ties}/{SIM_T} steps to the f64 "
        f"host evaluator: max |du| {worst:.2e}; {ties} leaf-tie steps "
        f"skipped; inside differs at {len(inside_diff)} steps "
        f"{inside_diff[:5]}")
    if any(abs(b + 1e-4) > 1e-5 for _k, b in inside_diff):
        fail("closed loop: inside differs away from the tolerance edge")

    # The implicit loop: at every theta it visited, K1's plain version on
    # the same device gives the same dstar and u0 (1e-6) wherever both
    # converged, except exact ties (two commutations' V within SIM_V_TIE).
    th_i = np.stack([problem.theta_of_state(x) for x in im.states[:-1]])
    ipm_leg.ipm_leg_cuda = ipm_leg.ipm_leg_torch
    try:
        ref = ora.solve_vertices(th_i)
    finally:
        ipm_leg.ipm_leg_cuda = real
    kern = ora.solve_vertices(th_i)
    vties = 0
    worst = 0.0
    for k in range(SIM_T):
        dp, dk = int(ref.dstar[k]), int(kern.dstar[k])
        if dp < 0 or dk < 0:
            if (dp < 0) != (dk < 0) or bool(im.inside[k]) != (dp >= 0):
                fail(f"implicit step {k}: feasibility differs (plain dstar "
                     f"{dp}, kernel {dk}, loop inside {im.inside[k]})")
            continue
        tie = (dp != dk and abs(ref.V[k, dk] - ref.Vstar[k]) <= SIM_V_TIE)
        if dp != dk and not tie:
            fail(f"implicit step {k}: dstar {dk} on the kernel, {dp} on its "
                 f"plain version (V {ref.V[k, dk]!r} vs {ref.Vstar[k]!r})")
        vties += int(tie)
        err = float(np.abs(im.inputs[k] - ref.u0[k, dk]).max())
        worst = max(worst, err)
        if err > 1e-6:
            fail(f"implicit step {k}: u0 differs from K1's plain version "
                 f"by {err:.2e}")
    log(f"[sim] implicit held at {SIM_T} steps to K1's plain version on "
        f"{dev}: dstar equal but {vties} exact ties, max |du0| {worst:.2e}")

    # Where a step's time goes: one explicit and one implicit step (at
    # theta0) under the profiler -- kernels launched and their device
    # time against the step's host wall (these launches are not counted).
    ectrl = simulator.ExplicitController(table, backend="kernel",
                                         device=dev)
    ictrl = simulator.ImplicitController(ora, device=dev)
    for name, ctrl in (("explicit", ectrl), ("implicit", ictrl)):
        walls = [ctrl(theta0)[1].eval_s for _ in range(20)]
        n, us = device_profile(lambda: ctrl(theta0), dev)
        log(f"[sim] one {name} step: host wall median "
            f"{1e6 * float(np.median(walls)):.1f} us, {n} CUDA kernels, "
            f"{us} us of device time")

    # The entry point itself: `main --simulate` (and --artifacts-out) on
    # the tier-1 double integrator, on the card by default.
    out = os.path.join(tmp, "di")
    argv = list(SIM_DI_ARGS) + ["-o", out, "--artifacts-out",
                                os.path.join(tmp, "di.artifacts"),
                                "--simulate", str(SIM_DI_T)]
    if not on_card:
        argv += ["--backend", "cpu"]
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(io.StringIO()):
        rc = tmain.main(argv)
    sim = json.load(open(f"{out}.sim.json"))
    if rc != 0 or tuple(sorted(sim)) != tuple(sorted(SIM_JSON_KEYS)) \
            or set(sim["trajectories"]) != {"explicit", "implicit"} \
            or len(sim["trajectories"]["explicit"]["inputs"]) != SIM_DI_T:
        fail(f"main --simulate: rc {rc}, sim.json keys {sorted(sim)}")
    if not os.path.exists(os.path.join(tmp, "di.artifacts", "descent.npz")):
        fail("main --artifacts-out wrote no descent.npz")
    log(f"[sim] main -e double_integrator (tier-1) --artifacts-out "
        f"--simulate {SIM_DI_T}: {time.perf_counter() - t0:.1f} s, sim.json "
        f"has the JAX package's keys; cost_ratio {sim['cost_ratio']:.6f}, "
        f"explicit {sim['explicit_us_per_step']:.1f} us/step, implicit "
        f"{sim['implicit_us_per_step']:.1f} us/step")
    log(f"[sim] (phase took {time.perf_counter() - t_phase:.1f} s)")
    return {"sim_k1": n_k1, "sim_k2": n_k2,
            "explicit_us": ex.mean_eval_us, "implicit_us": im.mean_eval_us}


def serve_entry_phase(dev, problem, cfg, res, table, rng, tmp: str) -> None:
    """Phase 12: the single-controller serving entry point.  `serve
    --selftest` on the flagship artifact directory (on the card by
    default), ShardedDescent held to the f64 host evaluator, and a hot
    swap under 16 submitting threads with a bitwise audit."""
    import contextlib
    import io
    import threading

    import torch

    from explicit_hybrid_mpc_tpu_torch.online import evaluator, fused, locate
    from explicit_hybrid_mpc_tpu_torch.oracle import ipm_leg
    from explicit_hybrid_mpc_tpu_torch.partition.frontier import make_oracle
    from explicit_hybrid_mpc_tpu_torch.serve import (ControllerRegistry,
                                                     FallbackPolicy,
                                                     RequestScheduler,
                                                     registry)
    from explicit_hybrid_mpc_tpu_torch.serve.cli import serve_main

    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    art = os.path.join(tmp, "pend")
    registry.save_artifacts(res.tree, res.roots, art)
    argv = ["--artifacts", art, "--controller", "pend", "--selftest",
            str(SERVE_SELFTEST)]
    if not on_card:
        argv += ["--backend", "cpu"]
    ipm_leg.launches = locate.launches = fused.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = serve_main(argv)
    wall = time.perf_counter() - t0
    summ = json.loads(buf.getvalue().strip().splitlines()[-1])
    log(f"[serve-cli] serve --selftest {SERVE_SELFTEST} on "
        f"{'cuda (default)' if on_card else 'cpu'}: {wall:.2f} s, "
        f"{json.dumps(summ)}; kernel launches ipm_leg {ipm_leg.launches}, "
        f"locate {locate.launches}, arena_eval {fused.launches} (the "
        "descent is plain torch)")
    if rc != 0 or summ["requests"] != SERVE_SELFTEST \
            or not summ["fallback_served"] > 0 \
            or not np.isfinite([summ["p50_us"], summ["p99_us"]]).all():
        fail(f"serve --selftest: rc {rc}, summary {summ}")

    devices = [dev]
    reg = ControllerRegistry()
    v1 = reg.load_artifacts("pend", "v1", art, devices=devices)
    srv = v1.server
    lb, ub = problem.theta_lb, problem.theta_ub
    th = rng.uniform(lb, ub, (SERVE_HOLD, problem.n_theta))
    out = srv.evaluate(th)
    u_r, c_r, in_r = host_eval(table, th)
    for k in range(8):
        if np.abs(evaluator.evaluate_np(table, th[k]) - u_r[k]).max() \
                > 1e-12:
            fail("host_eval disagrees with evaluator.evaluate_np")
    if not np.array_equal(out.inside, in_r):
        fail(f"ShardedDescent inside differs from the f64 host evaluator on "
             f"{int((out.inside != in_r).sum())} of {SERVE_HOLD} thetas")
    du = float(np.abs(out.u - u_r)[in_r].max())
    dc = float(np.abs(out.cost - c_r)[in_r].max())
    if du > 1e-9 or dc > 1e-9:
        fail(f"ShardedDescent differs from the f64 host evaluator: |du| "
             f"{du:.2e}, |dcost| {dc:.2e}")
    batch = th[:MAX_BATCH]
    n_l, us_l = device_profile(lambda: srv.evaluate(batch), dev)
    log(f"[serve] ShardedDescent ({srv.n_shards} shard, cut depth "
        f"{srv.cut_depth}, max_depth {srv.max_depth}) on {SERVE_HOLD} "
        f"in-box thetas: inside equal to the f64 host evaluator "
        f"({int(in_r.sum())} inside), max |du| {du:.2e}, |dcost| {dc:.2e}; "
        f"one {MAX_BATCH}-row batch launches {n_l} CUDA kernels, "
        f"{us_l} us of device time")

    # Hot swap under load: v2's payloads are exactly 2x v1's, loaded from
    # its own artifact directory while SWAP_CLIENTS threads submit.
    v2_tree = res.tree.clone()
    v2_tree._pl_inputs[:] *= 2.0
    v2_tree._pl_costs[:] *= 2.0
    art2 = os.path.join(tmp, "pend.v2")
    registry.save_artifacts(v2_tree, res.roots, art2)
    ora = make_oracle(problem, cfg)
    fb = FallbackPolicy(*registry.root_box(srv), oracle=ora)
    sched = RequestScheduler(reg, "pend", max_batch=MAX_BATCH,
                             max_wait_us=MAX_WAIT_US, fallback=fb)
    outs, errors = [], []
    lock = threading.Lock()
    half = threading.Barrier(SWAP_CLIENTS + 1)

    def client(cid: int) -> None:
        r = np.random.default_rng(1000 + cid)
        for k in range(SWAP_REQUESTS):
            if k == SWAP_REQUESTS // 2:
                half.wait(120.0)
            q = r.uniform(lb, ub)
            try:
                (res_k,) = sched.submit(q).result(120.0)
            except Exception as e:  # noqa: BLE001 -- a drop IS a failure
                errors.append(repr(e))
                return
            with lock:
                outs.append((q, res_k))

    ipm_leg.launches = 0
    ts = [threading.Thread(target=client, args=(c,))
          for c in range(SWAP_CLIENTS)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    half.wait(120.0)
    t_sw = time.perf_counter()
    reg.load_artifacts("pend", "v2", art2, devices=devices)
    swap_s = time.perf_counter() - t_sw
    for t in ts:
        t.join(300.0)
    sched.close()
    run_s = time.perf_counter() - t0
    if any(t.is_alive() for t in ts) or errors \
            or len(outs) != SWAP_CLIENTS * SWAP_REQUESTS:
        fail(f"hot swap: {len(outs)} of {SWAP_CLIENTS * SWAP_REQUESTS} "
             f"answered, errors {errors[:3]}")
    if not reg.wait_retired(v1, 30.0):
        fail("hot swap: v1 did not retire")
    seen = {r.version for _q, r in outs}
    thetas = np.stack([q for q, _r in outs])
    ref = srv.evaluate(thetas)
    torn = skipped = 0
    for k, (_q, r) in enumerate(outs):
        if r.fallback not in (None, "clamp"):
            skipped += 1
            continue
        s = 1.0 if r.version == "v1" else 2.0
        if not (np.array_equal(r.u, s * ref.u[k])
                and r.cost == s * float(ref.cost[k])):
            torn += 1
    lat = np.asarray([r.latency_s for _q, r in outs]) * 1e6
    n_v2 = sum(1 for _q, r in outs if r.version == "v2")
    log(f"[swap] {SWAP_CLIENTS} threads x {SWAP_REQUESTS} requests through "
        f"RequestScheduler(max_batch={MAX_BATCH}, max_wait_us="
        f"{MAX_WAIT_US:g}, fallback clamp + oracle on {ora.device}): "
        f"{run_s:.2f} s, {sched.n_batches} batches, p50 "
        f"{np.percentile(lat, 50):.0f} us, p99 {np.percentile(lat, 99):.0f} "
        f"us; v2 loaded and published mid-traffic in {1e3 * swap_s:.1f} ms; "
        f"versions {sorted(seen)} ({n_v2} v2 answers); 0 dropped, 0 errored; "
        f"{torn} answers not bitwise their version's, {skipped} oracle or "
        f"unserved rows not audited; fallback oracle re-solves "
        f"{fb.n_oracle} (ipm_leg launches {ipm_leg.launches})")
    if seen != {"v1", "v2"} or torn:
        fail(f"hot swap: versions {sorted(seen)}, {torn} torn answers")
    log(f"[serve-cli] (phase took {time.perf_counter() - t_phase:.1f} s)")


def large_partition_phase(dev) -> None:
    """Phase 13: sharded descent at a realistic size -- bench.py's
    large-partition case: a synthetic p = LARGE_P, depth-LARGE_DEPTH tree
    over the unit box, flat descent (one table) against ShardedDescent
    (LARGE_SHARDS shards on the one device, Kuhn router), both held to
    the tree's exact law and to the f64 host evaluator."""
    import torch

    from explicit_hybrid_mpc_tpu_torch.online import (descent, evaluator,
                                                      export, sharded)
    from explicit_hybrid_mpc_tpu_torch.partition import geometry
    from explicit_hybrid_mpc_tpu_torch.partition.synthetic import (
        build_synthetic_tree)

    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    p = LARGE_P
    t0 = time.perf_counter()
    tree, roots = build_synthetic_tree(p=p, depth=LARGE_DEPTH)
    build_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_large_") as td:
        t0 = time.perf_counter()
        export.write_leaf_table(tree, td)
        export_s = time.perf_counter() - t0
        table = export.load_leaf_table(td)
        t0 = time.perf_counter()
        dt = descent.export_descent(tree, roots, table, stage=False)
        descent_s = time.perf_counter() - t0
        del tree
        L = table.n_leaves
        log(f"[large] synthetic p={p} depth {LARGE_DEPTH}: {L} leaves, "
            f"{len(roots)} roots, {dt.children.shape[0]} nodes, max_depth "
            f"{dt.max_depth}; build {build_s:.1f} s, leaf-table export "
            f"{export_s:.1f} s, descent export {descent_s:.1f} s")
        qs = np.random.default_rng(5).uniform(0.0, 1.0, (LARGE_B, p))
        m0 = torch.cuda.memory_allocated(dev) if on_card else 0
        dt_dev = descent.stage_table(dt, dev)
        lt = evaluator.stage(table, device=dev)
        flat_bytes = sum(t.numel() * t.element_size() for t in lt) + sum(
            getattr(dt_dev, k).numel() * getattr(dt_dev, k).element_size()
            for k in descent._FIELDS)
        q_dev = torch.as_tensor(qs, device=dev)

        def flat():
            return descent.evaluate_descent(dt_dev, lt, q_dev)

        def sync():
            if on_card:
                torch.cuda.synchronize(dev)
        flat()
        sync()
        t0 = time.perf_counter()
        for _ in range(LARGE_REPS):
            out_f = flat()
        sync()
        flat_us = (time.perf_counter() - t0) / (LARGE_REPS * LARGE_B) * 1e6
        n_flat, us_flat = device_profile(flat, dev)
        router = geometry.kuhn_root_locator(np.zeros(p), np.ones(p))
        t0 = time.perf_counter()
        srv = sharded.shard_descent(dt, table, n_shards=LARGE_SHARDS,
                                    devices=[dev], router=router)
        shard_build_s = time.perf_counter() - t0
        srv.evaluate(qs)
        t0 = time.perf_counter()
        for _ in range(LARGE_REPS):
            out_s = srv.evaluate(qs)
        shard_us = (time.perf_counter() - t0) / (LARGE_REPS * LARGE_B) * 1e6
        n_shard, us_shard = device_profile(lambda: srv.evaluate(qs), dev)
        nb = srv.device_bytes()
        mem = torch.cuda.memory_allocated(dev) - m0 if on_card else 0
        log(f"[large] B={LARGE_B} on {dev}: flat descent (one table, brute "
            f"root scan) {flat_us:.4f} us/query, {n_flat} CUDA kernels and "
            f"{us_flat} us of device time a batch; ShardedDescent "
            f"({LARGE_SHARDS} shards, Kuhn router, "
            f"cut depth {srv.cut_depth}, shard sizes min/max "
            f"{min(srv.shard_sizes())}/{max(srv.shard_sizes())}) "
            f"{shard_us:.4f} us/query (host wall incl. routing and the "
            f"copy back), {n_shard} CUDA kernels and {us_shard} us of "
            f"device time a batch; built in "
            f"{shard_build_s:.1f} s")
        log(f"[large] device-resident bytes: flat {flat_bytes} (leaf table "
            f"{sum(t.numel() * t.element_size() for t in lt)}), sharded "
            f"{nb['leaves'] + nb['descent']} (leaf tables {nb['leaves']}, "
            f"descent arrays {nb['descent']}); allocated after both "
            f"{mem} bytes")
        law = large_law(table, qs, {"flat": out_f, "sharded": out_s})
        bad = large_law_failures(law)
        if bad:
            fail("; ".join(bad))
        for name, h in law.items():
            log(f"[large] {name}: {LARGE_HOLD} queries inside, max |du| "
                f"{h['du_law']:.2e}, |dcost| {h['dcost_law']:.2e} against "
                f"the tree's exact law; {LARGE_NP_HOLD} of them max |du| "
                f"{h['du_host']:.2e} against the f64 host evaluator")
        del srv, dt_dev, lt, out_f, out_s
        if on_card:
            torch.cuda.empty_cache()
    log(f"[large] (phase took {time.perf_counter() - t_phase:.1f} s)")


def large_law(table, qs, outs: dict) -> dict:
    """Each output of `outs` (name -> a flat or sharded descent's output
    over the host queries `qs` on the synthetic tree) held on LARGE_HOLD
    queries to the tree's law u = A theta, cost = sum(theta)
    (partition/synthetic.leaf_payload, reproduced exactly by the
    barycentric interpolation), and on LARGE_NP_HOLD of them to the brute
    f64 host evaluator (it scores every leaf): name -> {"outside",
    "du_law", "dcost_law", "du_host"}."""
    import torch

    from explicit_hybrid_mpc_tpu_torch.online import evaluator

    def host(x):
        return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
    p = qs.shape[1]
    sub = qs[:LARGE_HOLD]
    A = (np.arange(1)[:, None] + 1.0) * (np.arange(p)[None, :] + 1.0)
    u_law, c_law = sub @ A.T, sub.sum(axis=1)
    u_np = np.stack([evaluator.evaluate_np(table, sub[k])
                     for k in range(LARGE_NP_HOLD)])
    law = {}
    for name, o in outs.items():
        u, c, ins = host(o.u), host(o.cost), host(o.inside)
        law[name] = {
            "outside": int((~ins[:LARGE_HOLD].astype(bool)).sum()),
            "du_law": float(np.abs(u[:LARGE_HOLD] - u_law).max()),
            "dcost_law": float(np.abs(c[:LARGE_HOLD] - c_law).max()),
            "du_host": float(np.abs(u[:LARGE_NP_HOLD] - u_np).max())}
    return law


def large_law_failures(law) -> list:
    """large_law's verdict on the flat and the sharded output: 1e-9 for
    each distance, every held query inside."""
    if not law or set(law) != {"flat", "sharded"}:
        return [f"large-L outputs not held to the tree's law ({law})"]
    bad = []
    for name, h in law.items():
        if h["outside"] or not h["du_law"] <= 1e-9 \
                or not h["dcost_law"] <= 1e-9:
            bad.append(f"large {name}: {h['outside']} outside, |du| "
                       f"{h['du_law']:.2e}, |dcost| {h['dcost_law']:.2e} "
                       "against the tree's law")
        if not h["du_host"] <= 1e-9:
            bad.append(f"large {name}: |du| {h['du_host']:.2e} against the "
                       "f64 host evaluator")
    return bad


def plain_leg(args, n_iter: int):
    """ipm_leg_torch over a batch in chunks of K1_PLAIN_CHUNK QPs (each
    QP's iterations depend on its own inputs only)."""
    import torch

    from explicit_hybrid_mpc_tpu_torch.oracle import ipm_leg

    K = args[0].shape[0]
    outs = [ipm_leg.ipm_leg_torch(*(t[i:i + K1_PLAIN_CHUNK] for t in args),
                                  n_iter=n_iter)
            for i in range(0, K, K1_PLAIN_CHUNK)]
    return tuple(torch.cat([o[j] for o in outs]) for j in range(3))


def rel_err(xs, ys) -> float:
    """Largest |x - y| / (1 + |y|) over paired tensors, in f64."""
    return max(float(((x.double() - y).abs() / (1 + y.abs())).max())
               for x, y in zip(xs, ys))


def random_qps(rng, K: int, nz: int, nc: int, dev):
    """K well-conditioned random QPs (Q = W W' + I) in f64 on `dev`, with
    the cold start z = 0, s = lam = 1."""
    import torch

    W = rng.normal(size=(K, nz, nz))
    arrs = [W @ W.transpose(0, 2, 1) + np.eye(nz), rng.normal(size=(K, nz)),
            rng.normal(size=(K, nc, nz)), np.abs(rng.normal(size=(K, nc)))
            + 0.5]
    Q, q, A, b = (torch.as_tensor(a, device=dev) for a in arrs)
    return (Q, q, A, b, torch.zeros_like(q), torch.ones_like(b),
            torch.ones_like(b))


def k1_cell(dev, g, nz: int, nc: int, K: int, n_iter: int, tag: str,
            base=None, reps: int = 10):
    """One K1 cell: K random QPs (nz, nc) drawn from `g` through the
    wrapper against the plain version -- f64 to 1e-9 relative; f32
    within 4x the plain f32 version's error against the f64 iterates
    plus 1e-4 (as phase 2); 4 iterations from the cold start -- then,
    on the card, `n_iter` iterations timed by CUDA events, in turns
    (in_turns_each) with the baseline library `base` (K1_BASELINE) where
    given -- with the two kernels' gap on the QPs both keep bounded --
    and, on the general path, with the large path's own entry
    (ipm_leg_large_f64) on the same inputs, held to the plain version
    too.  Returns (the cell's dict, its inputs)."""
    import torch

    from explicit_hybrid_mpc_tpu_torch.oracle import ipm_leg

    on_card = dev.type == "cuda"
    path = k1_path(nz, nc)
    args = random_qps(g, K, nz, nc, dev)
    truth = plain_leg(args, 4)
    e64 = rel_err(ipm_leg.ipm_leg(*args, n_iter=4), truth)
    a32 = tuple(t.float() for t in args)
    e_k = rel_err(ipm_leg.ipm_leg(*a32, n_iter=4), truth)
    e_p = rel_err(plain_leg(a32, 4), truth)
    where = f"K1 {path} path {tag} nz={nz} nc={nc} K={K}"
    if not e64 <= 1e-9:
        fail(f"{where}: f64 differs from plain by {e64:.2e} (> 1e-9 "
             "relative)")
    if not e_k <= 4 * e_p + 1e-4:
        fail(f"{where}: f32 worse than plain ({e_k:.2e} vs {e_p:.2e})")
    nbytes, flops = ipm_leg_cost(K, nz, nc, n_iter, 8)
    bound = leg_bound_ms(K, nz, nc, n_iter)
    by = "bytes" if nbytes / PEAK_BYTES_S > flops / PEAK_F64_S \
        else "operations"
    cell = {"nz": nz, "nc": nc, "K": K, "n_iter": n_iter, "path": path,
            "ms": None, "bound_ms": bound, "bound_by": by,
            "max_rel_err_f64": e64, "max_rel_err_f32": e_k}
    vs = ""
    if on_card:
        lib = ipm_leg._lib()
        new, new_out = raw_leg(lib.ipm_leg_f64, args, n_iter)
        others = {}
        if base is not None:
            others["base"] = raw_leg(base.ipm_leg_f64, args, n_iter)
        if path == "general":
            others["large"] = raw_leg(lib.ipm_leg_large_f64, args, n_iter)
        ms, runs = in_turns_each(new, {k: v[0] for k, v in others.items()},
                                 reps, cuda_time)
        other_ms = {k: (a + b) / 2 for k, (a, b) in runs.items()}
        cell["ms"] = ms
        torch.cuda.synchronize()
        if "base" in others:
            other_out = others["base"][1]
            ok = torch.ones(K, dtype=torch.bool, device=dev)
            for x, y in zip(new_out, other_out):
                ok &= (x.abs().amax(1) < 1e8) & (y.abs().amax(1) < 1e8)
            gap = max(float(((x - y).abs() / (1 + y.abs()))[ok].max())
                      for x, y in zip(new_out, other_out)) \
                if ok.any() else 0.0
            b_ms = other_ms["base"]
            cell.update(base_ms=b_ms, base_ratio=b_ms / ms, base_gap=gap)
            vs += (f"; PR-parent baseline {b_ms:.4f} ms in turns, "
                   f"{b_ms / ms:.3f}x; kernel vs baseline {gap:.1e} "
                   f"relative on the {int(ok.sum())} bounded QPs")
        if "large" in others:
            check, outs = raw_leg(lib.ipm_leg_large_f64, args, 4)
            check()
            torch.cuda.synchronize()
            e_l = rel_err(outs, truth)
            if not e_l <= 1e-9:
                fail(f"{where}: the large path's entry differs from "
                     f"plain by {e_l:.2e} (> 1e-9 relative)")
            l_ms = other_ms["large"]
            cell.update(large_ms=l_ms, large_ratio=l_ms / ms, large_err=e_l)
            vs += (f"; the large path's entry on the same QPs {l_ms:.4f} ms "
                   f"in turns, {l_ms / ms:.3f}x, f64 vs plain {e_l:.2e}")
    log(f"{tag} nz={nz} nc={nc} K={K} n_iter={n_iter} ({path} path): f64 "
        f"vs plain {e64:.2e} (limit 1e-9); f32 vs the f64 iterates: kernel "
        f"{e_k:.2e}, plain {e_p:.2e}; kernel "
        + (f"{cell['ms']:.4f} ms = {1e3 * cell['ms'] / n_iter:.1f} "
           f"us/iteration, {bound / cell['ms']:.4f} of the bound"
           if cell["ms"] else "not measured")
        + f"; bound {bound:.5f} ms ({by}){vs}")
    return cell, args


def large_path_cells(dev, cells, ks, base=None, seed: int = SEED + 15,
                     tag: str = "[K1-large]"):
    """K1's large path at each (nz, nc, n_iter) of `cells` and each K of
    `ks` (k1_cell; with `base`, timed in turns against the baseline
    library).  Phase 14 calls it at the quadrotor build's shapes, 17b at
    the pruned builds' reduced shapes, k1_large_only at both.  Returns
    ([cell dicts], {(nz, nc, K): inputs}, max f64 error, max f32
    error)."""
    g = np.random.default_rng(seed)
    out, inputs, err64, err32 = [], {}, 0.0, 0.0
    for nz, nc, n_iter in cells:
        for K in ks:
            cell, args = k1_cell(dev, g, nz, nc, K, n_iter, tag, base)
            if cell["path"] != "large":
                fail(f"{tag} ({nz}, {nc}) does not take the large path")
            out.append(cell)
            inputs[(nz, nc, K)] = args
            err64 = max(err64, cell["max_rel_err_f64"])
            err32 = max(err32, cell["max_rel_err_f32"])
    return out, inputs, err64, err32


def stamped_source(src: str, anchors, kernel: str = K1_SPLIT_KERNEL) -> str:
    """csrc/ipm_leg.cu (or another version of it) with clock64() stamps
    in the kernel whose definition starts with `kernel` (ipm_leg_large's
    unless given): each anchor (a line's text, code before it, code
    after it), found in order after the kernel's definition; block 0's
    thread 0 adds the cycles since the previous stamp to ehm_split[n],
    which ehm_split_read / ehm_split_reset expose."""
    pos = src.index(kernel)
    for text, before, after in anchors:
        at = src.index(text, pos)
        start = src.rindex("\n", 0, at) + 1
        end = src.index("\n", at) + 1
        line = src[start:end]
        new = (before + "\n" if before else "") + line \
            + (after + "\n" if after else "")
        src = src[:start] + new + src[end:]
        pos = start + len(new)
    head = ("__device__ unsigned long long ehm_split[8];\n"
            "#define EHM_STAMP(n) do { if (blockIdx.x == 0 && "
            "threadIdx.x == 0) { const long long t_ = clock64(); "
            "ehm_split[n] += (unsigned long long)(t_ - ehm_last); "
            "ehm_last = t_; } } while (0)\n")
    tail = ('\nextern "C" int ehm_split_read(unsigned long long* out) {\n'
            "  return (int)cudaMemcpyFromSymbol(out, ehm_split, "
            "sizeof(ehm_split));\n}\n"
            'extern "C" int ehm_split_reset() {\n'
            "  static const unsigned long long zero[8] = {0};\n"
            "  return (int)cudaMemcpyToSymbol(ehm_split, zero, "
            "sizeof(zero));\n}\n")
    inc = src.index("#include <math.h>\n") + len("#include <math.h>\n")
    return src[:inc] + head + src[inc:] + tail


def k1_split(dev, src_path: str, label: str, anchors, lib=None,
             cells=None, sections=None, kernel: str = K1_SPLIT_KERNEL
             ) -> list:
    """The iteration split of the large path (or of `kernel`, a kernel's
    definition as stamped_source takes it) in the source `src_path`: its
    stamped copy (stamped_source) built under build/chiptmp, then at each
    cell of `cells` (K1_SPLIT_CELLS unless given) one launch after a warm
    one, block 0's cycles by section (`sections`, K1_SPLIT_SECTIONS
    unless given; the seventh is the prologue), each section's share of
    the iteration and its µs an iteration (the share of the stamped
    kernel's time by CUDA events), beside the time of `lib`'s unstamped
    kernel (the library built from the same source) where given."""
    import ctypes
    import shutil

    import torch

    from explicit_hybrid_mpc_tpu_torch import kernels

    cells = cells or K1_SPLIT_CELLS
    sections = sections or K1_SPLIT_SECTIONS
    with open(src_path) as f:
        text = stamped_source(f.read(), anchors, kernel)
    out_dir = os.path.join(os.path.dirname(kernels.BUILD_DIR), "chiptmp")
    os.makedirs(out_dir, exist_ok=True)
    cu = os.path.join(out_dir, f"ipm_leg_split_{label}.cu")
    so = os.path.join(out_dir, f"libipm_leg_split_{label}.so")
    with open(cu, "w") as f:
        f.write(text)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    r = subprocess.run([nvcc, *kernels.NVCC_FLAGS, "-o", so, cu],
                       capture_output=True, text=True, timeout=600)
    if r.returncode:
        fail(f"the stamped copy of {src_path} does not build:\n"
             f"{r.stdout}{r.stderr}")
    stamped = ctypes.CDLL(so)
    stamped.ipm_leg_f64.argtypes = _ctypes_sigs()["ipm_leg"]["ipm_leg_f64"]
    stamped.ipm_leg_f64.restype = ctypes.c_int
    stamped.ehm_split_read.argtypes = [ctypes.c_void_p]
    rows = []
    g = np.random.default_rng(SEED + 12)
    for nz, nc, K, n_iter in cells:
        args = random_qps(g, K, nz, nc, dev)
        launch, _ = raw_leg(stamped.ipm_leg_f64, args, n_iter)
        launch()
        torch.cuda.synchronize()
        stamped.ehm_split_reset()
        launch()
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 8)()
        if stamped.ehm_split_read(ctypes.addressof(buf)):
            fail("k1_split: cannot read the stamps")
        cyc = [int(v) for v in buf][:len(sections)]
        ms = cuda_time(launch, 5)
        kern_ms = (cuda_time(raw_leg(lib.ipm_leg_f64, args, n_iter)[0], 5)
                   if lib is not None else None)
        # Every bucket but the prologue (6) is a share of the iteration.
        loop = [n for n in range(len(sections)) if n != 6]
        it_cyc = sum(cyc[n] for n in loop) / n_iter
        us_it = 1e3 * ms / n_iter
        shares = {sections[n]: cyc[n] / n_iter / it_cyc
                  if it_cyc else 0.0 for n in loop}
        row = {"source": label, "nz": nz, "nc": nc, "K": K,
               "n_iter": n_iter, "cycles_per_iteration": it_cyc,
               "stamped_ms": ms, "kernel_ms": kern_ms,
               "sections": {s: {"share": sh, "us_per_iteration": sh * us_it}
                            for s, sh in shares.items()}}
        rows.append(row)
        log(f"[K1-split] {label} ({src_path}) nz={nz} nc={nc} K={K} "
            f"n_iter={n_iter}: block 0 {it_cyc:.0f} cycles an iteration; "
            f"stamped kernel {ms:.4f} ms = {us_it:.1f} us/iteration"
            + (f" (unstamped {kern_ms:.4f} ms)" if kern_ms else "")
            + "; " + "; ".join(f"{s} {sh:.3f} = {sh * us_it:.1f} us"
                               for s, sh in shares.items())
            + f"; prologue {cyc[6]} cycles")
    return rows


def k1_only_setup():
    """The card and the libraries of a K1-only entry: (device, K1_BASELINE's
    library or None) after building csrc/ipm_leg.cu and the baseline's
    source in parallel and logging the card, or None without a card."""
    import torch
    from concurrent.futures import ThreadPoolExecutor

    from explicit_hybrid_mpc_tpu_torch import kernels

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return None
    t0 = time.perf_counter()
    base_src = baseline_source()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    log(f"[device] {smi or torch.cuda.get_device_name(0)}")
    with ThreadPoolExecutor(2) as pool:
        fut = (pool.submit(baseline_lib, base_src, kernels.BUILD_DIR,
                           kernels.NVCC_FLAGS) if base_src else None)
        kernels.build(["ipm_leg"])
        base = fut.result() if fut else None
    log(f"[build] ipm_leg{' and its baseline' if base else ''} in "
        f"{time.perf_counter() - t0:.1f} s")
    for ln in ptxas_lines("ipm_leg", kernels.ptxas_report.get("ipm_leg", "")):
        if "fixed" not in ln:
            log(f"[build] {ln}")
    return dev, base


def k1_large_only(dev=None) -> int:
    """K1's large path alone, for iterating on its design in about
    two minutes on the card:

        python3 -c "import chip_smoke as c; c.k1_large_only()"
        K1_BASELINE=old_ipm_leg.cu python3 -c "..."   # and in turns

    Builds csrc/ipm_leg.cu (and K1_BASELINE's source, in parallel),
    then large_path_cells at K1_LARGE_SHAPES x K1_LARGE_K, at the
    pruned quadrotor's reduced shapes (K1_PRUNED_SHAPES x K1_PRUNED_K)
    and at the smaller large shapes (K1_LARGE_EXTRA x K1_LARGE_EXTRA_K),
    the general path's cells (general_path_cells: K1_GENERAL_CELLS with
    the baseline and the large path's entry in turns), and the
    iteration split (k1_split) of this source and of the baseline's.
    Exits non-zero (fail) on any check.  Given a CPU `dev` it rehearses
    the same cells through the plain version and only writes the
    stamped copies' text (no nvcc there)."""
    from explicit_hybrid_mpc_tpu_torch import kernels

    t0 = time.perf_counter()
    base_src = baseline_source()
    base = None
    if dev is None:
        setup = k1_only_setup()
        if setup is None:
            return 2
        dev, base = setup
    shapes = [(nz, nc, K1_LARGE_ITERS.get((nz, nc), 18))
              for nz, nc in K1_LARGE_SHAPES]
    large_path_cells(dev, shapes, K1_LARGE_K, base)
    large_path_cells(dev, [(nz, nc, K1_LARGE_ITERS.get((nz, nc), 30))
                           for nz, nc in K1_PRUNED_SHAPES], K1_PRUNED_K,
                     base, seed=SEED + 17, tag="[K1-pruned] quadrotor")
    large_path_cells(dev, [(nz, nc, 18) for nz, nc in K1_LARGE_EXTRA],
                     K1_LARGE_EXTRA_K, base, seed=SEED + 18)
    general_path_cells(dev, [], base)
    sources = [("new", os.path.join(kernels.CSRC, "ipm_leg.cu"))]
    if base_src:
        sources.append(("parent", base_src))
    for label, path in sources:
        if dev.type == "cuda":
            from explicit_hybrid_mpc_tpu_torch.oracle import ipm_leg

            k1_split(dev, path, label, K1_SPLIT_ANCHORS[label],
                     ipm_leg._lib() if label == "new" else base)
        else:
            with open(path) as f:
                text = stamped_source(f.read(), K1_SPLIT_ANCHORS[label])
            log(f"[K1-split] {label}: stamped copy of {path} written "
                f"({text.count('EHM_STAMP(') - 1} stamps), not built here")
    log(f"[K1-large] k1_large_only took {time.perf_counter() - t0:.1f} s")
    return 0


def k1_general_only(dev=None) -> int:
    """K1's general path alone (8 < nz <= 32, nc <= 128), in a few
    minutes on the card:

        K1_BASELINE=old_ipm_leg.cu python3 -c \
            "import sys, chip_smoke as c; sys.exit(c.k1_general_only())"

    Builds csrc/ipm_leg.cu (and K1_BASELINE's source, in parallel), then
    general_path_cells: every cell of K1_GENERAL_CELLS held to the plain
    version and timed in turns with the baseline and with the large
    path's own entry, each ratio printed, and the cells where the large
    path's entry was faster named.  Exits non-zero (fail) on any check.
    Given a CPU `dev` it rehearses the same cells through the plain
    version, measuring nothing."""
    t0 = time.perf_counter()
    base = None
    if dev is None:
        setup = k1_only_setup()
        if setup is None:
            return 2
        dev, base = setup
    out = general_path_cells(dev, [], base)
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "explicit_hybrid_mpc_tpu_torch", "csrc", "ipm_leg.cu")
    if dev.type == "cuda":
        from explicit_hybrid_mpc_tpu_torch.oracle import ipm_leg

        out["split"] = k1_split(
            dev, path, "general", K1_GENERAL_SPLIT_ANCHORS, ipm_leg._lib(),
            K1_GENERAL_SPLIT_CELLS, K1_GENERAL_SPLIT_SECTIONS,
            K1_GENERAL_SPLIT_KERNEL)
    else:
        with open(path) as f:
            text = stamped_source(f.read(), K1_GENERAL_SPLIT_ANCHORS,
                                  K1_GENERAL_SPLIT_KERNEL)
        log(f"[K1-split] general: stamped copy of {path} written "
            f"({text.count('EHM_STAMP(') - 1} stamps), not built here")
    log(json.dumps({"general": out}))
    log(f"[K1-general] k1_general_only took "
        f"{time.perf_counter() - t0:.1f} s")
    return 0


def hold_table(dev, tree, problem, seed: int, name: str) -> None:
    """K2 on a built table against the f64 host evaluator, as phase 4:
    OTHER_HOLD sampled thetas through locate.evaluate on `dev`; leaf ids,
    inside and u (1e-9) equal on the tie-free queries (inside the host's
    leaf by 1e-5 and ahead of the runner-up leaf by 1e-5)."""
    import torch

    from explicit_hybrid_mpc_tpu_torch.online import evaluator, export, locate

    table = export.export_leaves(tree)
    th = np.random.default_rng(seed).uniform(
        problem.theta_lb, problem.theta_ub, (OTHER_HOLD, problem.n_theta))
    res = locate.evaluate(locate.stage(table, device=dev),
                          evaluator.stage(table, device=dev),
                          torch.as_tensor(th, device=dev))
    u_h, _c_h, in_h = host_eval(table, th)
    best, second, leaf_h = [], [], []
    for lo in range(0, len(th), 256):
        sc = np.stack([host_scores(table, t) for t in th[lo:lo + 256]])
        top = np.partition(sc, -2, axis=1)
        best.append(top[:, -1])
        second.append(top[:, -2])
        leaf_h.append(sc.argmax(axis=1))
    best, second = np.concatenate(best), np.concatenate(second)
    leaf_h = np.concatenate(leaf_h)
    clear = (best > 1e-5) & (best - second > 1e-5)
    leaf_k = res.leaf.long().cpu().numpy()
    u_k = res.u.cpu().numpy()
    if not np.isfinite(u_k).all():
        fail(f"{name}: non-finite u from the online path")
    if not np.array_equal(leaf_k[clear], leaf_h[clear]):
        fail(f"{name}: K2 leaf ids differ from the f64 host evaluator on "
             f"{int((leaf_k != leaf_h)[clear].sum())} tie-free queries")
    du = float(np.abs(u_k - u_h)[clear].max()) if clear.any() else 0.0
    if du > 1e-9:
        fail(f"{name}: online u differs from the f64 host evaluator by "
             f"{du:.2e}")
    ins = res.inside.cpu().numpy()
    if not np.array_equal(ins[clear], in_h[clear]):
        fail(f"{name}: inside differs on "
             f"{int((ins != in_h)[clear].sum())} tie-free queries")
    log(f"[other] {name}: K2 (p={problem.n_theta}, {table.n_leaves} "
        f"leaves) on {int(clear.sum())}/{OTHER_HOLD} tie-free thetas: leaf "
        f"ids and inside equal to the f64 host evaluator, max |du| "
        f"{du:.2e}")


def other_problems_phase(dev, tmp: str, record: dict | None = None,
                         base=None):
    """Phase 14: the quadrotor's and the satellite's published sub-box
    builds through the build CLI's main() on `dev` (OTHER_BUILDS), each
    with its online evaluation, K1 and K2 counted from zero and K1's
    launches recorded; the quadrotor's under torch.profiler for K1's
    device time.  Each build is held to the reference's regions (2%),
    uncertified, not truncated, no device failure, and its table through
    K2 to the f64 host evaluator.  Then K1's large path against its
    plain version at the quadrotor's shapes (large_path_cells: f64 to
    1e-9 relative, f32 as phase 2), timed by CUDA events, in turns with
    the baseline library `base` (K1_BASELINE) where given.  Returns the
    kernels line's ipm_leg "large" object and (general_path_cells) its
    "general" one; `record`, where given, receives each build's stats,
    wall, K1 count, recorded K1 launches and (the profiled build) K1
    device ms, for phase 17 to print beside its pruned builds."""
    from collections import Counter

    from explicit_hybrid_mpc_tpu_torch import main as tmain
    from explicit_hybrid_mpc_tpu_torch.oracle import ipm_leg
    from explicit_hybrid_mpc_tpu_torch.partition.tree import Tree
    from explicit_hybrid_mpc_tpu_torch.problems.registry import make

    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    quad_legs: list = []
    sat_legs: list = []
    quad_ms = sat_build = None
    for name, args, ref_regions, artifacts in OTHER_BUILDS:
        out = os.path.join(tmp, name)
        argv = [*args, "--evaluate", str(OTHER_EVALUATE), "-o", out]
        if artifacts:
            argv += ["--artifacts-out", out + ".artifacts"]
        if not on_card:
            argv += ["--backend", "cpu"]
        rc, st, ev, wall, legs, n_k1, n_k2, prof = run_main(
            argv, on_card, profiled=True)
        if rc != 0 or ev is None or not ev["u_finite"]:
            fail(f"{name}: main returned {rc}, evaluate summary {ev}")
        log(f"[other] main {' '.join(args)} --evaluate {OTHER_EVALUATE} on "
            f"{dev}: {wall:.1f} s{' under the profiler' if prof else ''}; "
            f"regions {st['regions']} (reference {ref_regions}), "
            f"uncertified {st['uncertified']}, tree nodes "
            f"{st['tree_nodes']}, max_depth {st['max_depth']}, steps "
            f"{st['steps']}, oracle solves {st['oracle_solves']}, truncated "
            f"{st['truncated']}, device failures {st['device_failures']}, "
            f"degraded {st['device_degraded']}; launches counted from zero: "
            f"ipm_leg {n_k1}, locate {n_k2}")
        log(f"[other] {name} online: {ev['queries']} queries over "
            f"{ev['leaves']} leaves in {1e3 * ev['wall_s']:.2f} ms, inside "
            f"{ev['inside_frac']:.4f}")
        check_build(name, st, ref_regions, OTHER_UNCERTIFIED_MAX)
        if len(legs) != n_k1:
            fail(f"{name}: {len(legs)} K1 launches recorded, {n_k1} counted")
        if on_card and (n_k1 <= 0 or n_k2 <= 0):
            fail(f"{name}: a kernel of the path never launched (ipm_leg "
                 f"{n_k1}, locate {n_k2})")
        if artifacts and not os.path.exists(
                os.path.join(out + ".artifacts", "descent.npz")):
            fail(f"{name}: --artifacts-out wrote no descent.npz")
        if legs:
            log(f"[legs] {name}: K1 launches of the build, recorded from "
                "ipm_leg_cuda:")
            leg_histogram(legs)
        if name == "satellite":
            sat_legs = legs
        if name == "quadrotor":
            quad_legs = legs
            if on_card and not any(nz > ipm_leg.GENERAL_MAX_NZ
                                   for _k, nz, _nc, _it in legs):
                fail("quadrotor: no K1 launch with nz > "
                     f"{ipm_leg.GENERAL_MAX_NZ} (the large path)")
        k1_ms = profiled_ms(prof, "ipm_leg")
        if name == "quadrotor":
            quad_ms = k1_ms
        else:
            sat_build = k1_build_summary(legs, k1_ms, wall)
            log_k1_build(f"{name} (phase 14)", sat_build)
        if record is not None:
            record[name] = {"stats": st, "wall": wall, "n_k1": n_k1,
                            "legs": legs, "k1_ms": k1_ms}
        problem = make(args[args.index("-e") + 1], **tmain._parse_problem_args(
            [v for k, v in zip(args, args[1:]) if k == "--problem-arg"]))
        hold_table(dev, Tree.load(out + ".tree.pkl"), problem, SEED + 14,
                   name)

    # K1's large path at the quadrotor's shapes against its plain
    # version (large_path_cells: f64 to 1e-9 relative, f32 as phase 2),
    # timed at the build's iteration count for the shape by CUDA events,
    # with K1_BASELINE in turns.
    hist = Counter((nz, nc, it) for _k, nz, nc, it in quad_legs
                   if nz > ipm_leg.GENERAL_MAX_NZ
                   or nc > ipm_leg.GENERAL_MAX_NC)
    k_main = (Counter(k for k, *_ in quad_legs).most_common(1)[0][0]
              if quad_legs else max(K1_LARGE_K))
    iters = {}
    for (nz, nc, it), _n in hist.most_common():
        iters.setdefault((nz, nc), it)
    shapes = [(nz, nc, iters.get((nz, nc), K1_LARGE_ITERS.get((nz, nc), 18)))
              for nz, nc in sorted({*K1_LARGE_SHAPES, *iters})]
    timed, inputs, err64, err32 = large_path_cells(
        dev, shapes, sorted({*K1_LARGE_K, k_main}), base)
    nz0, nc0 = K1_LARGE_SHAPES[0]
    cell = next(c for c in timed if (c["nz"], c["nc"], c["K"])
                == (nz0, nc0, k_main))
    args, n_iter, by = inputs[(nz0, nc0, k_main)], cell["n_iter"], \
        cell["bound_by"]
    plain_ms = (cuda_time(lambda: plain_leg(args, n_iter), 2, warmup=1)
                if on_card else None)
    build_bound = sum(leg_bound_ms(*x) for x in quad_legs)
    n_large = sum(1 for x in quad_legs if x[1] > ipm_leg.GENERAL_MAX_NZ
                  or x[2] > ipm_leg.GENERAL_MAX_NC)
    log(f"[K1-large] at nz={cell['nz']} nc={cell['nc']} K={cell['K']} (the "
        f"quadrotor build's most frequent K) n_iter={n_iter}: plain version "
        + (f"{plain_ms:.2f} ms" if plain_ms else "not measured")
        + f"; the quadrotor build: {len(quad_legs)} K1 launches, {n_large} "
        "on the large path, device time "
        + (f"{quad_ms:.2f} ms" if quad_ms is not None else "not measured")
        + f" against a summed bound of {build_bound:.4f} ms")
    general = general_path_cells(dev, sat_legs, base)
    general["builds"] = {"unpruned": sat_build}
    log(f"[other] (phase took {time.perf_counter() - t_phase:.1f} s)")
    return {"nz": cell["nz"], "nc": cell["nc"], "K": cell["K"],
            "n_iter": n_iter, "ms": cell["ms"], "plain_ms": plain_ms,
            "bound_ms": cell["bound_ms"], "bound_by": by,
            "max_rel_err_f64": err64, "max_rel_err_f32": err32,
            "launches": len(quad_legs), "large_launches": n_large,
            "build_ms": quad_ms, "build_bound_ms": build_bound,
            "cells": timed}, general


def profiled_ms(prof, name: str) -> float | None:
    """Device ms of the kernels whose name holds `name` in a
    torch.profiler run (None without one, or when none ran)."""
    if prof is None:
        return None
    rows = [e for e in prof.key_averages()
            if name in e.key and e.self_device_time_total]
    return (sum(e.self_device_time_total for e in rows) / 1e3
            if rows else None)


def k1_build_summary(legs: list, k1_ms, wall: float) -> dict:
    """A build's K1 record for the kernels line: its launches in all and
    on the general path, by (nz, nc, K), their device time (profiler),
    their summed bound and the build's wall."""
    from collections import Counter

    by_cell = Counter((nz, nc, k) for k, nz, nc, _it in legs)
    return {"launches": len(legs),
            "general_launches": sum(1 for _k, nz, nc, _it in legs
                                    if k1_path(nz, nc) == "general"),
            "by_cell": {f"{nz}x{nc}xK{k}": n
                        for (nz, nc, k), n in sorted(by_cell.items())},
            "k1_ms": k1_ms, "bound_ms": sum(leg_bound_ms(*x) for x in legs),
            "wall_s": wall}


def log_k1_build(name: str, b: dict) -> None:
    """Log a satellite build's K1 record (k1_build_summary)."""
    log(f"[K1-general] the satellite 4c build {name}: K1 {b['launches']} "
        f"launches, {b['general_launches']} on the general path; by (nz, "
        f"nc, K): " + ", ".join(f"{c} x{n}" for c, n in b["by_cell"].items())
        + "; device time " + (f"{b['k1_ms']:.2f} ms" if b["k1_ms"] is not
                              None else "not measured")
        + f" (profiler), summed bound {b['bound_ms']:.4f} ms; wall "
        f"{b['wall_s']:.1f} s")


def general_path_cells(dev, sat_legs: list, base=None) -> dict:
    """K1's general path (8 < nz <= 32, nc <= 128) at every cell of
    K1_GENERAL_CELLS: against its plain version on random QPs (k1_cell:
    f64 to 1e-9 relative, f32 as phase 2, 4 iterations from the cold
    start), then ms a launch by CUDA events at the cell's K and at the
    satellite 4c build's iteration count for the shape where `sat_legs`
    (its K1 launches, recorded in phase 14) has one, in turns with
    K1_BASELINE's library `base` where given and with the large path's
    own entry, each ratio printed.  Returns the kernels line's ipm_leg
    "general" object: the cell K1_GENERAL_MAIN (its time, bound and
    plain time), every cell, the range of each ratio, the cells where
    the large path's entry was faster, and the satellite build's
    launches on the path."""
    from collections import Counter

    from explicit_hybrid_mpc_tpu_torch.oracle import ipm_leg

    on_card = dev.type == "cuda"
    gen_legs = [x for x in sat_legs if K1_REGISTER_MAX_NZ < x[1]
                <= ipm_leg.GENERAL_MAX_NZ and x[2] <= ipm_leg.GENERAL_MAX_NC]
    its: dict = {}
    for _k, z, c, it in gen_legs:
        its.setdefault((z, c), Counter())[it] += 1
    g = np.random.default_rng(SEED + 16)
    cells, err64, err32, main = [], 0.0, 0.0, None
    for label, (nz, nc), ks, n_iter in K1_GENERAL_CELLS:
        if (nz, nc) in its:
            n_iter = its[(nz, nc)].most_common(1)[0][0]
        for K in ks:
            cell, args = k1_cell(dev, g, nz, nc, K, n_iter,
                                 "[K1-general]", base, reps=20)
            cell["label"] = label
            cells.append(cell)
            err64 = max(err64, cell["max_rel_err_f64"])
            err32 = max(err32, cell["max_rel_err_f32"])
            if main is None or ((nz, nc), K) == K1_GENERAL_MAIN:
                main = (cell, args)
    cell, args = main
    plain_ms = (cuda_time(lambda: plain_leg(args, cell["n_iter"]), 2,
                          warmup=1) if on_card else None)

    def span(key):
        vals = [c[key] for c in cells if c.get(key) is not None]
        return [min(vals), max(vals)] if vals else None
    slower = [f"({c['nz']}, {c['nc']}) K {c['K']}" for c in cells
              if c.get("large_ratio") is not None and c["large_ratio"] < 1]
    shapes = Counter((z, c) for _k, z, c, _it in gen_legs)
    log(f"[K1-general] the satellite 4c build: {len(gen_legs)} K1 launches "
        f"on the general path of {len(sat_legs)} (shapes "
        + ", ".join(f"{k} x{n}" for k, n in sorted(shapes.items()))
        + f"); plain version at nz={cell['nz']} nc={cell['nc']} "
        f"K={cell['K']}: "
        + (f"{plain_ms:.2f} ms" if plain_ms else "not measured"))
    if on_card:
        b, lr = span("base_ratio"), span("large_ratio")
        log("[K1-general] in turns over the cells: the parent's kernel "
            + (f"{b[0]:.3f}-{b[1]:.3f}x" if b else "not run (no "
               "K1_BASELINE)")
            + f", the large path's entry {lr[0]:.3f}-{lr[1]:.3f}x this "
            "kernel's time; the large path faster at: "
            + (", ".join(slower) if slower else "no cell"))
    return {"nz": cell["nz"], "nc": cell["nc"], "K": cell["K"],
            "n_iter": cell["n_iter"], "ms": cell["ms"],
            "plain_ms": plain_ms, "bound_ms": cell["bound_ms"],
            "bound_by": cell["bound_by"], "max_rel_err_f64": err64,
            "max_rel_err_f32": err32, "cells": cells,
            "base_ratio": span("base_ratio"),
            "large_ratio": span("large_ratio"), "large_faster": slower,
            "launches": len(gen_legs)}


def run_main(argv: list, on_card: bool, profiled: bool = False):
    """`python -m explicit_hybrid_mpc_tpu_torch.main ARGV` in process, with
    K1's and K2's launch counts from zero and K1's launches recorded
    (and, `profiled` on the card, under torch.profiler): (rc, stats,
    evaluate summary or None, wall s, K1 launches recorded, K1 count,
    K2 count, the profiler or None)."""
    import contextlib
    import io

    import torch

    from explicit_hybrid_mpc_tpu_torch import main as tmain
    from explicit_hybrid_mpc_tpu_torch.online import locate
    from explicit_hybrid_mpc_tpu_torch.oracle import ipm_leg

    out = argv[argv.index("-o") + 1]
    real = ipm_leg.ipm_leg_cuda
    legs: list = []
    ipm_leg.ipm_leg_cuda = record_legs(real, legs)
    ipm_leg.launches = locate.launches = 0
    err = io.StringIO()
    prof = None
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stderr(err):
            if on_card and profiled:
                from torch.profiler import ProfilerActivity, profile

                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    rc = tmain.main(argv)
                    torch.cuda.synchronize()
            else:
                rc = tmain.main(argv)
    finally:
        ipm_leg.ipm_leg_cuda = real
    wall = time.perf_counter() - t0
    n_k1, n_k2 = ipm_leg.launches, locate.launches
    st = json.load(open(out + ".stats.json")) if rc == 0 else {}
    ev = [json.loads(ln)["evaluate"] for ln in err.getvalue().splitlines()
          if ln.startswith('{"evaluate"')]
    return rc, st, (ev[0] if ev else None), wall, legs, n_k1, n_k2, prof


def check_build(name: str, st: dict, ref: int, unc_max: int) -> None:
    """A build's (or rebuild's) stats against its reference: regions
    within 2%, uncertified, not truncated, no fallback from the device."""
    if st["device_failures"] != 0 or st["device_degraded"] is not False \
            or st["quarantined_cells"] != 0:
        fail(f"{name}: the build fell back from the device")
    if st["truncated"]:
        fail(f"{name}: the build was truncated")
    if abs(st["regions"] - ref) > 0.02 * ref:
        fail(f"{name}: regions {st['regions']} not within 2% of the "
             f"reference {ref}")
    if st["uncertified"] > unc_max:
        fail(f"{name}: uncertified {st['uncertified']} > {unc_max}")


def rebuild_phase(dev, problem, cfg, res, build_s: float, tmp: str) -> dict:
    """Phase 15: the warm rebuild and the rebuild service on `dev`, with
    phase 3's flagship result `res` (`problem` built with `cfg` in
    `build_s` s) as the prior.

    15a `main rebuild --from PRIOR` at the same eps (under torch.profiler
    for K1's device time): held to the reference's regions, uncertified,
    at most 1% of the prior's leaves invalidated, and every leaf whose
    payload slot the rebuild kept bitwise the prior's.  15b the same at
    eps_a 9e-3 with --evaluate, its table held through K2 to the f64 host
    evaluator.  15c RebuildService over SERVICE_REVISIONS drift revisions
    with a delta publish, hot-swapping a ControllerRegistry on `dev` while
    SERVICE_CLIENTS threads submit: no failure, no drop, no torn result
    (each bitwise a fresh load of its version's artifact).  15d `main
    serve-rebuild` at the tier-1 double integrator's size.  Returns the
    kernels line's rebuild counts."""
    import contextlib
    import io
    import threading

    import torch

    from explicit_hybrid_mpc_tpu_torch import main as tmain
    from explicit_hybrid_mpc_tpu_torch.lifecycle import (DriftSource,
                                                         LifecycleConfig,
                                                         RebuildService)
    from explicit_hybrid_mpc_tpu_torch.oracle import ipm_leg
    from explicit_hybrid_mpc_tpu_torch.partition.tree import Tree
    from explicit_hybrid_mpc_tpu_torch.serve import registry
    from explicit_hybrid_mpc_tpu_torch.serve.scheduler import (
        RequestScheduler)

    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    backend = [] if on_card else ["--backend", "cpu"]
    # The prior's configuration as build flags (the rebuild's -a follows).
    flags = ["-e", cfg.problem, "--batch", str(cfg.batch_simplices),
             "--max-depth", str(cfg.max_depth), *backend]
    for k, v in cfg.problem_args:
        flags += ["--problem-arg", f"{k}={json.dumps(v)}"]
    prior_path = os.path.join(tmp, "prior.tree.pkl")
    res.tree.save(prior_path)

    # -- 15a: the unchanged rebuild --------------------------------------
    out_a = os.path.join(tmp, "unchanged")
    rc, st, _ev, wall_a, legs, n_k1, _n_k2, prof = run_main(
        ["rebuild", *flags, "-a", str(cfg.eps_a), "--from", prior_path,
         "-o", out_a], on_card, profiled=True)
    if rc != 0:
        fail(f"main rebuild returned {rc}")
    k1_ms = None
    if prof is not None:
        rows = [e for e in prof.key_averages()
                if "ipm_leg" in e.key and e.self_device_time_total]
        k1_ms = (sum(e.self_device_time_total for e in rows) / 1e3
                 if rows else None)
    n_leaves = st["rebuild_leaves_total"]
    log(f"[rebuild] main rebuild --from the phase-3 tree on {dev} (eps_a "
        f"{cfg.eps_a:g}, unchanged): {wall_a:.1f} s"
        f"{' under the profiler' if prof is not None else ''} (phase 3's "
        f"cold build {build_s:.1f} s); regions {st['regions']} (reference "
        f"{REBUILD_REF_REGIONS}), uncertified {st['uncertified']}, truncated "
        f"{st['truncated']}; leaves {n_leaves}: reused "
        f"{st['rebuild_leaves_reused']}, invalidated "
        f"{st['rebuild_leaves_invalidated']}, reuse_frac "
        f"{st['rebuild_reuse_frac']}; recert_solves {st['recert_solves']}, "
        f"subdivision_solves {st['subdivision_solves']}; sweep "
        f"{st['sweep_wall_s']} s; provenance changed "
        f"{st['provenance_changed']}")
    bound_a = sum(leg_bound_ms(*x) for x in legs)
    k1_a, regions_a = n_k1, st["regions"]
    log(f"[rebuild] K1 in the rebuild, counted from zero: {n_k1} launches "
        f"({len(legs)} recorded), device time "
        + (f"{k1_ms:.2f} ms" if k1_ms is not None else "not measured")
        + f" against a summed bound of {bound_a:.4f} ms")
    if legs:
        leg_histogram(legs)
    check_build("unchanged rebuild", st, REBUILD_REF_REGIONS,
                REF_UNCERTIFIED_MAX)
    if st["rebuild_leaves_invalidated"] > REBUILD_INVALID_MAX_FRAC * n_leaves:
        fail(f"unchanged rebuild invalidated "
             f"{st['rebuild_leaves_invalidated']} of {n_leaves} leaves "
             f"(> {REBUILD_INVALID_MAX_FRAC:.0%})")
    if len(legs) != n_k1 or (on_card and n_k1 <= 0):
        fail(f"unchanged rebuild: {len(legs)} K1 launches recorded, {n_k1} "
             "counted (the sweep must run through the kernel)")
    # Kept leaves: a kept leaf keeps its payload slot; an invalidated one
    # loses it (a re-certified leaf gets a new slot at the end).
    sa, sb = res.tree.__getstate__(), Tree.load(out_a + ".tree.pkl")\
        .__getstate__()
    ids = res.tree.converged_leaf_ids()
    slot = sa["leaf_slot"][ids]
    kept = sb["leaf_slot"][ids] == slot
    ks = slot[kept]
    same = (np.array_equal(sa["pl_delta"][ks], sb["pl_delta"][ks])
            and np.array_equal(sa["pl_inputs"][ks], sb["pl_inputs"][ks])
            and np.array_equal(sa["pl_costs"][ks], sb["pl_costs"][ks])
            and np.array_equal(sa["leaf_flags"][ids[kept]],
                               sb["leaf_flags"][ids[kept]]))
    n_kept = int(kept.sum())
    n_closed = int(np.sum(sa["children"][:, 0] < 0)) - ids.size
    log(f"[rebuild] {n_kept} of the prior's {ids.size} payload leaves kept "
        f"their slot, payloads (delta, inputs, costs, flags) "
        f"{'bitwise' if same else 'NOT bitwise'} the prior's; with "
        f"{n_closed} closed-infeasible leaves the rebuild reports "
        f"{st['rebuild_leaves_reused']} reused")
    if not same or not (n_kept <= st["rebuild_leaves_reused"]
                        <= n_kept + n_closed):
        fail("unchanged rebuild: a kept leaf's payload differs from the "
             "prior's, or the kept count disagrees with the stats")

    # -- 15b: eps_a 1e-2 -> 9e-3 ------------------------------------------
    out_b = os.path.join(tmp, "tight")
    rc, st, ev, wall_b, legs, n_k1, n_k2, _ = run_main(
        ["rebuild", *flags, "-a", str(REBUILD_TIGHT_EPS), "--from",
         prior_path, "-o", out_b, "--evaluate", str(QUERIES)], on_card)
    if rc != 0 or ev is None or not ev["u_finite"]:
        fail(f"main rebuild -a {REBUILD_TIGHT_EPS}: returned {rc}, "
             f"evaluate summary {ev}")
    log(f"[rebuild] main rebuild --from the phase-3 tree -a "
        f"{REBUILD_TIGHT_EPS} --evaluate {QUERIES} on {dev}: {wall_b:.1f} s; "
        f"regions {st['regions']} (reference's warm rebuild "
        f"{REBUILD_TIGHT_REF_REGIONS}, its cold build "
        f"{REBUILD_TIGHT_COLD_REGIONS}), uncertified {st['uncertified']}, "
        f"truncated {st['truncated']}; reuse_frac {st['rebuild_reuse_frac']}"
        f" (reused {st['rebuild_leaves_reused']}, invalidated "
        f"{st['rebuild_leaves_invalidated']}); recert_solves "
        f"{st['recert_solves']}, subdivision_solves "
        f"{st['subdivision_solves']}; launches counted from zero: ipm_leg "
        f"{n_k1}, locate {n_k2}; online {ev['queries']} queries over "
        f"{ev['leaves']} leaves in {1e3 * ev['wall_s']:.2f} ms, inside "
        f"{ev['inside_frac']:.4f}")
    check_build("eps-tightened rebuild", st, REBUILD_TIGHT_REF_REGIONS,
                REF_UNCERTIFIED_MAX)
    if len(legs) != n_k1 or (on_card and (n_k1 <= 0 or n_k2 <= 0)):
        fail(f"eps-tightened rebuild: a kernel never launched (ipm_leg "
             f"{n_k1}, {len(legs)} recorded; locate {n_k2})")
    k1_b, k2_b = n_k1, n_k2
    hold_table(dev, Tree.load(out_b + ".tree.pkl"), problem, SEED + 17,
               f"rebuild eps {REBUILD_TIGHT_EPS:g}")

    # -- 15c: the service under load ----------------------------------------
    devices = None if on_card else [torch.device("cpu")]
    art0 = os.path.join(tmp, "v0")
    registry.save_artifacts(res.tree, res.roots, art0)
    reg = registry.ControllerRegistry()
    reg.load_artifacts("pend", "v0", art0, devices=devices)
    src = DriftSource(cfg.problem, problem_args=cfg.problem_args,
                      controller="pend", eps_a=cfg.eps_a, drift_arg="u_max",
                      drift_frac=SERVICE_DRIFT_FRAC,
                      n_revisions=SERVICE_REVISIONS, seed=SEED)
    svc = RebuildService(src, cfg, cfg=LifecycleConfig(
        artifacts_root=os.path.join(tmp, "lc")), registry=reg,
        prior={"pend": res})
    src.gate = (lambda: len(svc.generations) + svc.n_failures
                >= src.n_emitted)
    sched = RequestScheduler(reg, "pend", max_batch=MAX_BATCH,
                             max_wait_us=MAX_WAIT_US)
    outs, errors = [], []
    lock = threading.Lock()
    stop = threading.Event()
    lb, ub = problem.theta_lb, problem.theta_ub

    def client(cid: int) -> None:
        r = np.random.default_rng(2000 + cid)
        while not stop.is_set():
            q = r.uniform(lb, ub)
            try:
                (res_k,) = sched.submit(q).result(120.0)
            except Exception as e:  # noqa: BLE001 -- a drop IS a failure
                errors.append(repr(e))
                return
            with lock:
                outs.append((q, res_k))

    ipm_leg.launches = 0
    ts = [threading.Thread(target=client, args=(c,))
          for c in range(SERVICE_CLIENTS)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    svc.start()
    done = svc.wait_idle(timeout=600, target_generations=SERVICE_REVISIONS)
    time.sleep(0.2)  # the last version serves too
    stop.set()
    for t in ts:
        t.join(120.0)
    sched.close()
    svc.close()
    run_s = time.perf_counter() - t0
    n_k1 = ipm_leg.launches
    summ = svc.summary()
    gens = svc.generations
    if not done or svc.worker_error is not None or svc.n_failures \
            or len(gens) != SERVICE_REVISIONS:
        fail(f"rebuild service: {len(gens)} generations, "
             f"{svc.n_failures} failures, worker error {svc.worker_error}")
    if any(t.is_alive() for t in ts) or errors:
        fail(f"rebuild service: dropped requests {errors[:3]}")
    dirs = {"v0": art0, **{g["version"]: g["artifact_dir"] for g in gens}}
    torn = 0
    for ver in dirs:
        rows = [(q, r) for q, r in outs if r.version == ver]
        if not rows:
            continue
        ref_reg = registry.ControllerRegistry()
        ref_reg.load_artifacts("ref", ver, dirs[ver], devices=devices)
        with ref_reg.lease("ref") as v:
            ref = v.server.evaluate(np.stack([q for q, _r in rows]))
        torn += sum(not np.array_equal(r.u, np.asarray(ref.u[j]))
                    for j, (_q, r) in enumerate(rows))
    seen = sorted({r.version for _q, r in outs})
    lat = np.asarray([r.latency_s for _q, r in outs]) * 1e6
    # A generation's swap: its staleness beyond its rebuild -- the delta
    # or full publish, the artifact load and the registry's hot swap.
    swap_ms = np.asarray([g["staleness_s"] - g["rebuild_wall_s"]
                          for g in gens]) * 1e3
    for g in gens:
        log(f"[service]   generation {g['generation']} ({g['note']}): "
            f"{g['version']} published {g['published']}, regions "
            f"{g['regions']}, reuse_frac {g['reuse_frac']}, rebuild "
            f"{g['rebuild_wall_s']} s, staleness {g['staleness_s']} s, "
            f"subdivision_solves {g['subdivision_solves']}, recert_solves "
            f"{g['recert_solves']}, bytes: delta {g['delta_bytes']}, full "
            f"{g['full_bytes']}")
    log(f"[service] RebuildService on {dev}: {len(gens)} generations, "
        f"{svc.n_failures} failures in {run_s:.1f} s; staleness p50 "
        f"{summ['staleness_p50_s']} s, p99 {summ['staleness_p99_s']} s; "
        f"swap (staleness beyond the rebuild) p50 "
        f"{np.percentile(swap_ms, 50):.0f} ms, p99 "
        f"{np.percentile(swap_ms, 99):.0f} ms; "
        f"delta bytes / full bytes {summ['delta_bytes_frac']}; "
        f"{SERVICE_CLIENTS} threads, {len(outs)} requests through "
        f"RequestScheduler(max_batch={MAX_BATCH}) across the swaps: p50 "
        f"{np.percentile(lat, 50):.0f} us, p99 {np.percentile(lat, 99):.0f} "
        f"us; versions served {seen}; 0 dropped; {torn} results not bitwise "
        f"a fresh load of their version's artifact; ipm_leg launches {n_k1}")
    if torn or seen != sorted(dirs):
        fail(f"rebuild service: {torn} torn results, versions {seen} of "
             f"{sorted(dirs)}")
    if gens[-1]["published"] != "delta" or (on_card and n_k1 <= 0):
        fail(f"rebuild service: last publish {gens[-1]['published']}, "
             f"ipm_leg launches {n_k1}")

    # -- 15d: the entry point ----------------------------------------------
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = tmain.main(["serve-rebuild", *SERVE_REBUILD_ARGS,
                         "--artifacts-root", os.path.join(tmp, "lc_di"),
                         *backend])
    lines = out.getvalue().strip().splitlines()
    summary = json.loads(lines[-1]) if lines else {}
    log(f"[serve-rebuild] main serve-rebuild {' '.join(SERVE_REBUILD_ARGS)} "
        f"on {dev}: exit {rc} in {time.perf_counter() - t0:.1f} s; "
        f"generations {summary.get('generations')}, failures "
        f"{summary.get('failures')}, full publishes "
        f"{summary.get('full_publishes')}")
    if rc != 0 or summary.get("generations") != 1 \
            or summary.get("failures") != 0:
        fail(f"main serve-rebuild: exit {rc}, summary {summary}")
    log(f"[rebuild] (phase took {time.perf_counter() - t_phase:.1f} s)")
    return {"ipm_leg": {"rebuild_launches": k1_a, "rebuild_ms": k1_ms,
                        "rebuild_bound_ms": bound_a},
            "locate": {"rebuild_launches": k2_b},
            "refs": {"unchanged": {"regions": regions_a, "k1_launches": k1_a,
                                   "k1_ms": k1_ms},
                     "tight": {"regions": st["regions"],
                               "k1_launches": k1_b}}}


class HostVerdict:
    """One ContentionMonitor (obs/host.py) across the whole script,
    sampling every HOST_INTERVAL_S, read phase by phase: `end(name)`
    prints and returns the verdict over the samples taken since the
    previous call (the competing-CPU share of the host: other
    processes' busy jiffies over the host's capacity).  A host whose
    /proc/stat counts no CPU time at all (a sandbox's synthetic procfs:
    every field of its cpu line 0) cannot show other processes' load:
    its verdicts read "not measured", not an uncontended 0."""

    def __init__(self):
        from explicit_hybrid_mpc_tpu_torch.obs import ContentionMonitor

        self.mon = ContentionMonitor(interval_s=HOST_INTERVAL_S)
        first = self.mon._reader()
        self.blind = first is None or first[0] == 0
        self.mon.start()
        self._mark = 0
        self._t = time.perf_counter()

    def end(self, name: str) -> str:
        samples = self.mon._samples[self._mark:]
        self._mark += len(samples)
        t, self._t = self._t, time.perf_counter()
        if self.blind:
            text = ("not measured (this host's /proc/stat counts no CPU "
                    "time, so other processes' load cannot be seen)")
        elif samples:
            mean = float(np.mean(samples))
            text = (f"competing_cpu_frac_mean {mean:.3f}, max "
                    f"{max(samples):.3f}, contended "
                    f"{mean > self.mon.threshold} ({len(samples)} samples)")
        else:
            text = "no sample (the phase was shorter than the interval)"
        log(f"[host] {name}: {text} (wall since the last verdict "
            f"{self._t - t:.1f} s)")
        return text

    def summary(self) -> dict:
        """The monitor's summary, and whether the host's procfs could
        show contention at all.  On a blind host the competing shares
        and the verdict come from all-zero readings, not from a
        measurement: they are null."""
        out = {**self.mon.summary(), "procfs_counts_cpu": not self.blind}
        if self.blind:
            out.update(competing_cpu_frac_mean=None,
                       competing_cpu_frac_max=None, contended=None)
        return out


def recorded_folds(tr) -> list:
    """Record every fold call of the ReqTrace `tr` (its controller and
    stamps) in the returned list; nothing when `tr` is None."""
    folds: list = []
    if tr is not None:
        real_fold = tr.fold

        def fold(controller, **kw):
            folds.append((controller, kw))
            real_fold(controller, **kw)
        tr.fold = fold
    return folds


def traced_drive(submit, jobs, clients: int, tr=None):
    """`jobs` (one list of (args...) per client) submitted from `clients`
    closed-loop threads through `submit(*args)`; with a ReqTrace `tr`,
    every fold call's stamps are recorded.  Returns (results in job
    order per client, wall s, recorded folds)."""
    import threading

    folds = recorded_folds(tr)
    results = [[None] * len(j) for j in jobs]
    errors: list[str] = []

    def client(c):
        for k, args in enumerate(jobs[c]):
            try:
                (results[c][k],) = submit(*args).result(120.0)
            except Exception as e:  # noqa: BLE001 -- a drop IS a failure
                errors.append(repr(e))
                return

    ts = [threading.Thread(target=client, args=(c,))
          for c in range(clients)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join(600.0)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in ts) or errors:
        fail(f"traced serving: {len(errors)} errored ({errors[:3]})")
    return results, wall, folds


def check_trace(name: str, tr, o, folds, n_requests: int) -> dict:
    """Every ticket's stamps from the recorded fold calls: monotone (the
    six phases, integer ns differences of them, then sum to its wall by
    construction), every request folded once, the histograms' phase sums equal to their wall sums to
    the nanosecond a ticket, and at most trace_exemplar_k exemplars per
    controller (`o`: the hub's obs handle).  Returns {phase: per-ticket
    ns array} plus the
    batch-scoped phases' per-batch arrays under "batch"."""
    from explicit_hybrid_mpc_tpu_torch.obs import reqtrace

    phases = {p: [] for p in (*reqtrace.PHASES, "wall")}
    batch = {p: [] for p in ("seal", "put", "launch", "fallback",
                             "reply")}
    seen_batches = set()
    bad = 0
    for _ctl, kw in folds:
        st = (kw["seal"], kw["lease"], kw["eval0"], kw["eval1"],
              kw["fb_end"], kw["done"])
        if st not in seen_batches:   # a mixed batch folds per tenant
            seen_batches.add(st)
            for p, (a, b) in zip(batch, zip(st[:-1], st[1:])):
                batch[p].append(b - a)
        for (sub, enq), k, _tag in kw["rows"]:
            stamps = (sub, enq, *st)
            ph = (st[0] - sub, st[1] - st[0], st[2] - st[1],
                  st[3] - st[2], st[4] - st[3], st[5] - st[4])
            # The phases are differences of consecutive stamps, so they
            # sum to the wall by construction; what can fail is the
            # stamps' order (and, below, the hub's histograms).
            if any(b < a for a, b in zip(stamps, stamps[1:])):
                bad += 1
            for _ in range(k):
                for p, v in zip(reqtrace.PHASES, ph):
                    phases[p].append(v)
                phases["wall"].append(st[5] - sub)
    n = len(phases["wall"])
    snap = o.metrics.snapshot()["histograms"]
    ctls = sorted({c for c, _kw in folds})
    worst_ns = 0.0
    for ctl in ctls:
        pre = f"serve.ctl.{ctl}.phase."
        h = {p: snap[f"{pre}{p}_us"] for p in (*reqtrace.PHASES, "wall")}
        gap_us = abs(sum(h[p]["sum"] for p in reqtrace.PHASES)
                     - h["wall"]["sum"])
        worst_ns = max(worst_ns, 1e3 * gap_us / max(h["wall"]["count"], 1))
        if len(tr.exemplars(ctl)) > tr.exemplar_k:
            fail(f"{name}: {len(tr.exemplars(ctl))} exemplars for {ctl} "
                 f"(> trace_exemplar_k {tr.exemplar_k})")
    if bad or n != n_requests or not worst_ns <= 1.0:
        fail(f"{name}: {bad} tickets whose stamps are not monotone, "
             f"{n} of {n_requests} requests "
             f"folded, histogram phase sums {worst_ns:.3f} ns a ticket from "
             "the wall")
    log(f"[trace] {name}: {n} tickets in {len(seen_batches)} batches; every "
        f"ticket's stamps monotone (its six phases, differences of those "
        f"stamps, sum to its wall by construction); histogram phase sums "
        f"within {worst_ns:.4f} ns "
        f"a ticket of the wall sums; exemplars <= {tr.exemplar_k} per "
        "controller (" + ", ".join(f"{c} {len(tr.exemplars(c))}"
                                   for c in ctls) + ")")
    out = {p: np.asarray(v, dtype=np.int64) for p, v in phases.items()}
    out["batch"] = {p: np.asarray(v, dtype=np.int64)
                    for p, v in batch.items()}
    return out


def phase_table(name: str, ph: dict, verdict: str) -> None:
    """p50 / p99 of every phase (µs) and its share of the mean wall."""
    from explicit_hybrid_mpc_tpu_torch.obs import reqtrace

    wall_mean = float(ph["wall"].mean())
    parts = []
    for p in (*reqtrace.PHASES, "wall"):
        v = ph[p] / 1e3
        parts.append(f"{p} p50 {np.percentile(v, 50):.1f} p99 "
                     f"{np.percentile(v, 99):.1f}"
                     + (f" ({float(ph[p].mean()) / wall_mean:.3f} of the "
                        "mean wall)" if p != "wall" else ""))
    log(f"[trace] {name} phases (us): " + "; ".join(parts)
        + f" [host: {verdict}]")


def observability_phase(dev, problem, cfg, res, table, tmp: str,
                        host: HostVerdict) -> None:
    """Phase 16: the port's instruments on `dev`, from phase 3's result.

    16a the serial baseline (SerialBnB over Oracle(backend="serial"), one
    QP at a time in numpy on the host) against the card's oracle (K1) on SERIAL_POINTS
    flagship thetas: V* to the JAX package's bar, d* wherever the two best
    commutations are apart by more than it, and the baseline's cost per
    point over the card's.  16b `main --profile` at the flagship settings
    (the trace names K1's kernel among its device ops; the build held as
    phase 3's), then an engine armed with auto_profile captured through
    its external trigger (the bundle holds no error).  16c phase 8's
    arena run and phase 12's RequestScheduler run with
    ServeConfig(tracing="on"): every ticket's stamps in order, the
    histograms' phase sums within a nanosecond a ticket of their wall
    sums, at most trace_exemplar_k exemplars per controller, every
    result bitwise an untraced run's; p50/p99 of every phase, the arena
    cycle's split and queue_frac.  16d 15c's service for one generation
    with obs on: serve.host.gc_pause_us and serve.host.stall_us beside
    the request p99 (the requests traced too).  Each part prints the
    host's contention verdict over its own run."""
    import dataclasses
    import glob
    import threading

    import torch

    from explicit_hybrid_mpc_tpu_torch import obs as obs_lib
    from explicit_hybrid_mpc_tpu_torch.config import ServeConfig
    from explicit_hybrid_mpc_tpu_torch.lifecycle import (DriftSource,
                                                         LifecycleConfig,
                                                         RebuildService)
    from explicit_hybrid_mpc_tpu_torch.obs import histogram_row, profiling
    from explicit_hybrid_mpc_tpu_torch.obs.reqtrace import (
        trace_from_serve_config)
    from explicit_hybrid_mpc_tpu_torch.online import fused
    from explicit_hybrid_mpc_tpu_torch.online.descent import load_descent
    from explicit_hybrid_mpc_tpu_torch.oracle import ipm_leg, oracle
    from explicit_hybrid_mpc_tpu_torch.oracle.bnb import SerialBnB
    from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
        FrontierEngine, make_oracle)
    from explicit_hybrid_mpc_tpu_torch.serve import (ArenaScheduler,
                                                     ControllerRegistry,
                                                     DeviceArena,
                                                     FallbackPolicy,
                                                     RequestScheduler,
                                                     registry)

    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    backend = "cuda" if on_card else "cpu"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    lb, ub = problem.theta_lb, problem.theta_ub

    # -- 16a: the serial baseline against the card -------------------------
    thetas = np.random.default_rng(SEED + 18).uniform(
        lb, ub, (SERIAL_POINTS, problem.n_theta))
    bnb = SerialBnB(oracle.Oracle(problem, backend="serial"))
    # measure() solves the first theta once untimed, then every theta
    # timed: the timed solves' answers are kept for the checks below.
    ser, real_solve = [], bnb.solve_point

    def solve_point(th):
        ser.append(real_solve(th))
        return ser[-1]
    bnb.solve_point = solve_point
    ipm_leg.launches = 0
    stats = bnb.measure(thetas)
    ser = ser[1:]
    n_serial_k1 = ipm_leg.launches
    ora = oracle.Oracle(problem, backend=backend)
    ora.wait_vertices(ora.dispatch_vertices(thetas))   # warm
    sync()
    ipm_leg.launches = 0
    t0 = time.perf_counter()
    sol = ora.wait_vertices(ora.dispatch_vertices(thetas))
    sync()
    card_s = time.perf_counter() - t0
    n_card_k1 = ipm_leg.launches
    verdict = host.end("phase 16a (serial baseline)")
    V = np.array([v for v, _d, _n in ser])
    d = np.array([dd for _v, dd, _n in ser])
    fin = np.isfinite(sol.Vstar)
    if not np.array_equal(np.isfinite(V), fin):
        fail("serial baseline: finite V* on other thetas than the card's")
    ok = np.isclose(V[fin], sol.Vstar[fin], rtol=SERIAL_RTOL,
                    atol=SERIAL_ATOL)
    Vs = np.sort(sol.V, axis=1)
    with np.errstate(invalid="ignore"):
        clear = fin & (Vs[:, 1] - Vs[:, 0]
                       > SERIAL_ATOL + SERIAL_RTOL * np.abs(Vs[:, 0]))
    d_bad = int((d[clear] != sol.dstar[clear]).sum())
    v_err = float(np.max(np.abs(V[fin] - sol.Vstar[fin]))) if fin.any() \
        else 0.0
    card_pp = card_s / SERIAL_POINTS
    log(f"[serial] SerialBnB(Oracle(backend='serial')).measure on "
        f"{SERIAL_POINTS} flagship thetas (SEED + 18), on the CPU: "
        f"s_per_point {stats['s_per_point']:.6f}, qp_per_point "
        f"{stats['qp_per_point']:.3f}, pruned_per_point "
        f"{stats['pruned_per_point']:.3f} of n_delta {stats['n_delta']} "
        f"(ipm_leg launches {n_serial_k1}); the {backend} oracle's "
        f"dispatch_vertices + wait_vertices on the batch {card_s:.6f} s = "
        f"{card_pp:.6f} s a point (ipm_leg launches {n_card_k1}); baseline "
        f"over the {backend} oracle {stats['s_per_point'] / card_pp:.1f}x "
        f"[host: {verdict}]")
    log(f"[serial] V* agrees on {int(ok.sum())} of {int(fin.sum())} "
        f"finite thetas (rtol {SERIAL_RTOL:g}, atol {SERIAL_ATOL:g}; max "
        f"|dV*| {v_err:.2e}); d* equal on {int(clear.sum()) - d_bad} of "
        f"{int(clear.sum())} thetas whose two best commutations are apart "
        "by more than that")
    if not ok.all() or d_bad or n_serial_k1 != 0 \
            or (on_card and n_card_k1 <= 0):
        fail(f"serial baseline: {int((~ok).sum())} V* and {d_bad} d* differ "
             f"from the {backend} oracle's; ipm_leg launches: serial "
             f"{n_serial_k1}, {backend} {n_card_k1}")

    # -- 16b: profiler capture -----------------------------------------------
    pdir = os.path.join(tmp, "profile")
    out = os.path.join(tmp, "profiled")
    flags = ["-e", cfg.problem, "-a", str(cfg.eps_a), "--batch",
             str(cfg.batch_simplices), "--max-depth", str(cfg.max_depth)]
    for k, v in cfg.problem_args:
        flags += ["--problem-arg", f"{k}={json.dumps(v)}"]
    if not on_card:
        flags += ["--backend", "cpu"]
    rc, st, _ev, wall, _legs, n_k1, _n_k2, _p = run_main(
        [*flags, "-o", out, "--profile", pdir, "--profile-steps",
         str(PROFILE_STEPS)], on_card)
    if rc != 0:
        fail(f"main --profile returned {rc}")
    check_build("the profiled build", st, REF_REGIONS, REF_UNCERTIFIED_MAX)
    summ = profiling.summarize_trace(pdir, top_n=40)
    dev_ops = summ.get("device_ops_ms", [])
    k1_ops = [op for op in dev_ops if "ipm_leg_fixed" in op["name"]]
    # torch.profiler's own range event spans the capture.
    span = [op["total_ms"] for op in summ.get("top_ops_ms", [])
            if op["name"].startswith("PyTorch Profiler")]
    busy = (f"; device busy {sum(op['total_ms'] for op in dev_ops) / span[0]:.4f}"
            f" of the {span[0]:.1f} ms capture" if span and dev_ops else "")
    verdict = host.end("phase 16b (main --profile)")
    log(f"[profile] main {' '.join(flags)} --profile DIR --profile-steps "
        f"{PROFILE_STEPS} on {dev}: exit {rc} in {wall:.1f} s, regions "
        f"{st['regions']}, uncertified {st['uncertified']}; ipm_leg "
        f"launches {n_k1}; trace: {summ.get('trace_files')} file(s), "
        f"{summ.get('events')} events, tracks {summ.get('tracks')}; device "
        f"ops {sum(op['total_ms'] for op in dev_ops):.3f} ms in "
        f"{len(dev_ops)} names, ipm_leg_fixed "
        f"{sum(op['total_ms'] for op in k1_ops):.3f} ms{busy} "
        f"[host: {verdict}]")
    for op in dev_ops[:6]:
        log(f"[profile]   device {op['total_ms']:9.3f} ms  {op['name'][:80]}")
    for op in summ.get("top_ops_ms", [])[:6]:
        log(f"[profile]   all    {op['total_ms']:9.3f} ms  {op['name'][:80]}")
    if "error" in summ or (on_card and not k1_ops):
        fail(f"the --profile trace does not name ipm_leg_fixed among its "
             f"device ops: {summ.get('error') or [o['name'] for o in dev_ops]}")
    ap_dir = os.path.join(tmp, "auto_profile")
    os.makedirs(ap_dir, exist_ok=True)
    cfg_ap = dataclasses.replace(
        cfg, auto_profile=True, profile_steps=PROFILE_STEPS,
        max_steps=2 * PROFILE_STEPS, obs="jsonl",
        obs_path=os.path.join(ap_dir, "build.obs.jsonl"), log_path=None)
    eng = FrontierEngine(problem, make_oracle(problem, cfg_ap), cfg_ap)
    n_steps = eng.trigger_auto_profile("chip_smoke phase 16b")
    t0 = time.perf_counter()
    eng.run()
    ap_s = time.perf_counter() - t0
    bundles = sorted(glob.glob(os.path.join(ap_dir, "auto_profile_*.json")))
    meta = json.load(open(bundles[0])) if len(bundles) == 1 else {}
    ap_ops = meta.get("trace_summary", {}).get("device_ops_ms", [])
    ap_k1 = [op for op in ap_ops if "ipm_leg_fixed" in op["name"]]
    verdict = host.end("phase 16b (auto-profile)")
    log(f"[profile] auto_profile engine: trigger_auto_profile -> {n_steps} "
        f"steps, run of {eng.steps} steps in {ap_s:.1f} s; bundle "
        f"{[os.path.basename(b) for b in bundles]}: captured_steps "
        f"{meta.get('captured_steps')}, capture_wall_s "
        f"{meta.get('capture_wall_s')}, error {meta.get('error')}, device "
        f"ops {len(ap_ops)} names, ipm_leg_fixed "
        f"{sum(op['total_ms'] for op in ap_k1):.3f} ms [host: {verdict}]")
    if n_steps != PROFILE_STEPS or len(bundles) != 1 or "error" in meta \
            or "error" in meta.get("trace_summary", {"error": 1}) \
            or (on_card and not ap_k1):
        meta.pop("trace_summary", None)
        fail(f"auto-profile: {n_steps} steps, bundles {bundles}, {meta}")

    # -- 16c: request tracing ------------------------------------------------
    art = os.path.join(tmp, "pend")
    registry.save_artifacts(res.tree, res.roots, art)
    lb_c, ub_c = registry.root_box(load_descent(os.path.join(art,
                                                             "descent.npz")))
    tenants = [f"t{k}" for k in range(TENANTS)]
    cols = 128 * -(-table.n_leaves // 128)
    names, th, _outside = serve_queries(tenants, lb_c, ub_c, REQUESTS,
                                        np.random.default_rng(SEED + 19))
    arena_jobs = [[(names[j], th[j]) for j in range(c, REQUESTS, CLIENTS)]
                  for c in range(CLIENTS)]
    req_jobs = [[(q,) for q in np.random.default_rng(1000 + c).uniform(
        lb, ub, (SWAP_REQUESTS, problem.n_theta))]
        for c in range(SWAP_CLIENTS)]
    trace_cfg = ServeConfig(tracing="on", trace_exemplar_k=TRACE_EXEMPLAR_K)
    ora = make_oracle(problem, cfg)
    runs = {}
    for label in ("traced", "untraced"):
        scfg = trace_cfg if label == "traced" else ServeConfig()
        o = obs_lib.Obs("jsonl")
        tr = trace_from_serve_config(scfg, obs=o)
        arena = DeviceArena(p=res.tree.p, n_u=res.tree.n_u,
                            capacity_cols=TENANTS * cols, device=dev)
        for n in tenants:
            arena.publish(n, "v1", table, lb_c, ub_c)
        sched = ArenaScheduler(arena, max_batch=MAX_BATCH,
                               max_wait_us=MAX_WAIT_US,
                               fallback=FallbackPolicy(lb_c, ub_c,
                                                       mode="clamp"),
                               obs=o, trace=tr)
        fused.launches = 0
        a_res, a_wall, a_folds = traced_drive(sched.submit, arena_jobs,
                                              CLIENTS, tr)
        sched.close()
        a_batches, n_k3 = sched.n_batches, fused.launches
        a_verdict = host.end(f"phase 16c ({label} arena run)")
        reg = ControllerRegistry()
        reg.load_artifacts("pend", "v1", art, devices=[dev])
        with reg.lease("pend") as ver:
            box = registry.root_box(ver.server)
        o2 = obs_lib.Obs("jsonl")
        tr2 = trace_from_serve_config(scfg, obs=o2)
        rsched = RequestScheduler(reg, "pend", max_batch=MAX_BATCH,
                                  max_wait_us=MAX_WAIT_US,
                                  fallback=FallbackPolicy(*box, oracle=ora),
                                  obs=o2, trace=tr2)
        r_res, r_wall, r_folds = traced_drive(rsched.submit, req_jobs,
                                              SWAP_CLIENTS, tr2)
        rsched.close()
        r_verdict = host.end(f"phase 16c ({label} RequestScheduler run)")
        runs[label] = dict(arena=a_res, req=r_res, a_wall=a_wall,
                           r_wall=r_wall, a_batches=a_batches, n_k3=n_k3,
                           r_batches=rsched.n_batches, tr=tr, tr2=tr2,
                           o=o, o2=o2,
                           a_folds=a_folds, r_folds=r_folds,
                           a_verdict=a_verdict, r_verdict=r_verdict)
        lat = np.asarray([r.latency_s for rows in a_res for r in rows]) * 1e6
        rlat = np.asarray([r.latency_s for rows in r_res for r in rows]) * 1e6
        log(f"[trace] {label} arena run: {REQUESTS} requests from {CLIENTS} "
            f"clients over {TENANTS} tenants in {a_wall:.2f} s, "
            f"{a_batches} batches ({n_k3} arena_eval launches), p50 "
            f"{np.percentile(lat, 50):.1f} us, p99 "
            f"{np.percentile(lat, 99):.1f} us [host: {a_verdict}]; "
            f"RequestScheduler: {SWAP_CLIENTS} x {SWAP_REQUESTS} requests in "
            f"{r_wall:.2f} s, {rsched.n_batches} batches, p50 "
            f"{np.percentile(rlat, 50):.1f} us, p99 "
            f"{np.percentile(rlat, 99):.1f} us [host: {r_verdict}]")
    t, u = runs["traced"], runs["untraced"]
    if t["tr"] is None or t["tr2"] is None or u["tr"] is not None:
        fail("ServeConfig(tracing='on') did not give a trace hub")
    if on_card and (t["n_k3"] != t["a_batches"] or t["n_k3"] <= 0):
        fail(f"traced arena run: {t['n_k3']} arena_eval launches for "
             f"{t['a_batches']} batches")

    for kind, n_req in (("arena", REQUESTS),
                        ("req", SWAP_CLIENTS * SWAP_REQUESTS)):
        diff = sum(not same_result(a, b) for ra, rb in zip(t[kind], u[kind])
                   for a, b in zip(ra, rb))
        if diff:
            fail(f"traced {kind} run: {diff} of {n_req} results differ from "
                 "the untraced run's")
    ph_a = check_trace("arena", t["tr"], t["o"], t["a_folds"], REQUESTS)
    ph_r = check_trace("RequestScheduler", t["tr2"], t["o2"], t["r_folds"],
                       SWAP_CLIENTS * SWAP_REQUESTS)
    log(f"[trace] traced results bitwise the untraced runs' on all "
        f"{REQUESTS} arena and {SWAP_CLIENTS * SWAP_REQUESTS} "
        "RequestScheduler requests")
    phase_table("arena", ph_a, t["a_verdict"])
    phase_table("RequestScheduler", ph_r, t["r_verdict"])
    cycle_us = 1e6 * t["a_wall"] / t["a_batches"]
    bmean = {p: float(v.mean()) / 1e3 for p, v in ph_a["batch"].items()}
    busy = sum(bmean.values())
    log(f"[trace] arena batch cycle {cycle_us:.1f} us (run wall over "
        f"{t['a_batches']} batches): the worker's batch "
        + ", ".join(f"{p} {v:.1f}" for p, v in bmean.items())
        + f" us = {busy:.1f} us ({busy / cycle_us:.3f} of the cycle); "
        f"the rest, {cycle_us - busy:.1f} us, the worker waits for a flush "
        f"(max_batch {MAX_BATCH} rows or the {MAX_WAIT_US:g} us deadline)")
    log("[trace] queue_frac: arena "
        + ", ".join(f"{c} {t['tr'].queue_frac(c):.4f}" for c in tenants)
        + f"; RequestScheduler pend {t['tr2'].queue_frac('pend'):.4f}")
    for ex in t["tr"].exemplars()[:2]:
        log(f"[trace] slowest arena exemplar: {json.dumps(ex)}")

    # -- 16d: the rebuild service's host forensics ---------------------------
    devices = [dev]
    reg = ControllerRegistry()
    reg.load_artifacts("pend", "v0", art, devices=devices)
    o = obs_lib.Obs("jsonl")
    src = DriftSource(cfg.problem, problem_args=cfg.problem_args,
                      controller="pend", eps_a=cfg.eps_a, drift_arg="u_max",
                      drift_frac=SERVICE_DRIFT_FRAC, n_revisions=1, seed=SEED)
    svc = RebuildService(src, cfg, cfg=LifecycleConfig(
        artifacts_root=os.path.join(tmp, "lc")), registry=reg,
        prior={"pend": res}, obs=o)
    src.gate = (lambda: len(svc.generations) + svc.n_failures
                >= src.n_emitted)
    o2 = obs_lib.Obs("jsonl")
    tr = trace_from_serve_config(trace_cfg, obs=o2)
    folds = recorded_folds(tr)
    sched = RequestScheduler(reg, "pend", max_batch=MAX_BATCH,
                             max_wait_us=MAX_WAIT_US, obs=o2, trace=tr)
    outs, errors = [], []
    lock = threading.Lock()
    stop = threading.Event()

    def client(cid: int) -> None:
        r = np.random.default_rng(2000 + cid)
        while not stop.is_set():
            try:
                (res_k,) = sched.submit(r.uniform(lb, ub)).result(120.0)
            except Exception as e:  # noqa: BLE001 -- a drop IS a failure
                errors.append(repr(e))
                return
            with lock:
                outs.append(res_k)

    ts = [threading.Thread(target=client, args=(c,))
          for c in range(SERVICE_CLIENTS)]
    t0 = time.perf_counter()
    for th_ in ts:
        th_.start()
    svc.start()
    done = svc.wait_idle(timeout=600, target_generations=1)
    time.sleep(0.2)  # the new version serves too
    stop.set()
    for th_ in ts:
        th_.join(120.0)
    sched.close()
    svc.close()
    run_s = time.perf_counter() - t0
    verdict = host.end("phase 16d (rebuild service, obs on)")
    gens = svc.generations
    if not done or svc.worker_error is not None or svc.n_failures \
            or len(gens) != 1 or errors or any(x.is_alive() for x in ts):
        fail(f"16d: {len(gens)} generations, {svc.n_failures} failures, "
             f"worker error {svc.worker_error}, dropped {errors[:3]}")
    hists = o.metrics.snapshot()["histograms"]
    rows = {k: histogram_row(hists[k]) for k in
            ("serve.host.gc_pause_us", "serve.host.stall_us") if k in hists}
    if "serve.host.stall_us" not in rows:
        fail("16d: the service recorded no serve.host.stall_us")
    lat = np.asarray([r.latency_s for r in outs]) * 1e6
    ph = check_trace("requests during the rebuild", tr, o2, folds,
                     len(outs))
    g = gens[0]
    log(f"[forensics] RebuildService, one u_max generation with obs on, "
        f"{SERVICE_CLIENTS} threads through RequestScheduler: generation "
        f"{g['version']} ({g['published']}) rebuilt in "
        f"{g['rebuild_wall_s']} s, staleness {g['staleness_s']} s, run "
        f"{run_s:.1f} s; {len(outs)} requests p50 "
        f"{np.percentile(lat, 50):.0f} us, p99 "
        f"{np.percentile(lat, 99):.0f} us, max {lat.max():.0f} us "
        f"[host: {verdict}]")
    for k, row in rows.items():
        gc_sum = hists[k]["sum"]
        log(f"[forensics]   {k}: count {row['count']}, sum "
            f"{gc_sum / 1e3:.1f} ms, p50 {row['p50']:.0f} us, p99 "
            f"{row['p99']:.0f} us, max {row['max']:.0f} us")
    phase_table("requests during the rebuild", ph, verdict)
    log(f"[observe] (phase took {time.perf_counter() - t_phase:.1f} s)")


def k1_path(nz: int, nc: int) -> str:
    """The CUDA kernel's path for a QP shape (ipm_leg's dispatch)."""
    from explicit_hybrid_mpc_tpu_torch.oracle import ipm_leg

    if nz <= ipm_leg.GENERAL_MAX_NZ and nc <= ipm_leg.GENERAL_MAX_NC:
        return "register" if nz <= K1_REGISTER_MAX_NZ else "general"
    return "large"


def timed_legs(real, times: list):
    """A stand-in for ipm_leg.ipm_leg_cuda that brackets each launch with
    CUDA events, noting ((nz, nc, K), start, end) in `times`."""
    import torch

    def leg(Q, q, A, b, z, s, lam, n_iter):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        out = real(Q, q, A, b, z, s, lam, n_iter)
        t1.record()
        times.append(((q.shape[1], b.shape[1], q.shape[0]), t0, t1))
        return out
    return leg


def mask_digest(row_keep: np.ndarray, var_keep: np.ndarray) -> str:
    """The first 16 hex digits of sha256(packbits(row_keep) +
    packbits(var_keep)) (PRUNE_MASKS)."""
    import hashlib

    return hashlib.sha256(np.packbits(row_keep).tobytes()
                          + np.packbits(var_keep).tobytes()).hexdigest()[:16]


def pruned_families(po) -> dict:
    """(nz, nc) of a PrunedOracle's reduced programs and of the full ones
    that still run (the verified fallbacks and the Farkas phase-1)."""
    nzr, ncr = po.reduced_shape
    nt, nz, nc = po.can.n_theta, po.can.nz, po.can.nc
    return {"point (reduced)": (nzr, ncr),
            "elastic simplex-min (reduced)": (nzr + nt + 1, ncr + nt + 2),
            "phase-1 gate (reduced)": (nzr + 1, ncr),
            "point (full, fallbacks)": (nz, nc),
            "elastic simplex-min (full, fallbacks)": (nz + nt + 1,
                                                      nc + nt + 2),
            "Farkas phase-1 (full)": (nz + nt + 1, nc + nt + 1)}


def soc_primals_held(name: str, prob, thetas, ds, z, z_ref) -> str:
    """SOC primals on the card against the CPU's: rtol 1e-5 / atol 1e-7
    (the JAX SOC tests') on at least 95% of the rows; a row off that
    (two stopping points of the solver's own tolerance set) must satisfy
    its commutation's rows and every cone to 1e-7."""
    can = prob.canonical
    Ac, bc = prob.soc_cones()
    held = np.isclose(z, z_ref, rtol=1e-5, atol=1e-7).all(axis=1)
    if held.sum() < 0.95 * len(held):
        fail(f"{name}: primals held on {int(held.sum())}/{len(held)} rows "
             "(< 95%)")
    for th, d, zk in zip(thetas[~held], ds[~held], z[~held]):
        row = can.G[d] @ zk - can.w[d] - can.S[d] @ th
        sc = bc - np.einsum("kmn,n->km", Ac, zk)
        if (row > 1e-7 * (1 + np.abs(can.w[d]))).any() or (
                sc[:, 0] - np.linalg.norm(sc[:, 1:], axis=1) < -1e-7).any():
            fail(f"{name}: a primal off the CPU's violates its rows or cones")
    dz = float(np.abs(z - z_ref).max()) if len(z) else 0.0
    return (f"primals held on {int(held.sum())}/{len(held)} rows (max |dz| "
            f"{dz:.2e}; the rest feasible)")


def pruned_builds(dev, tmp: str, unpruned: dict) -> tuple[dict, dict]:
    """17a: OTHER_BUILDS through `main ... --prune-rows` on `dev` under
    torch.profiler, each held to phase 14's references, its masks to the
    JAX package's (PRUNE_MASKS), its table through K2 to the f64 host
    evaluator, and printed beside phase 14's unpruned build (`unpruned`,
    other_problems_phase's record).  Returns ({name: summary}, {name:
    (recorded K1 launches, the PrunedOracle)})."""
    from collections import Counter, defaultdict

    import torch

    from explicit_hybrid_mpc_tpu_torch import main as tmain
    from explicit_hybrid_mpc_tpu_torch.oracle import ipm_leg
    from explicit_hybrid_mpc_tpu_torch.oracle.prune import PrunedOracle
    from explicit_hybrid_mpc_tpu_torch.partition import frontier
    from explicit_hybrid_mpc_tpu_torch.partition.tree import Tree
    from explicit_hybrid_mpc_tpu_torch.problems.registry import make

    on_card = dev.type == "cuda"
    summary, launched = {}, {}
    for name, args, ref_regions, _artifacts in OTHER_BUILDS:
        prefix = os.path.join(tmp, name + "_pruned")
        argv = [*args, "--prune-rows", "--obs", "jsonl", "-o", prefix]
        if not on_card:
            argv += ["--backend", "cpu"]
        made: list = []
        real_make = frontier.make_oracle

        def capture(problem, cfg, mesh=None, strict=False):
            made.append(real_make(problem, cfg, mesh=mesh, strict=strict))
            return made[-1]

        times: list = []
        real_leg = ipm_leg.ipm_leg_cuda
        frontier.make_oracle = capture
        if on_card:
            ipm_leg.ipm_leg_cuda = timed_legs(real_leg, times)
        try:
            rc, st, _ev, wall, legs, n_k1, _n_k2, prof = run_main(
                argv, on_card, profiled=True)
        finally:
            frontier.make_oracle = real_make
            ipm_leg.ipm_leg_cuda = real_leg
        if rc != 0:
            fail(f"{name} --prune-rows: main returned {rc}")
        check_build(f"{name} --prune-rows", st, ref_regions,
                    OTHER_UNCERTIFIED_MAX)
        po = made[0] if made else None
        if not isinstance(po, PrunedOracle):
            fail(f"{name}: --prune-rows built {type(po).__name__}, not a "
                 "PrunedOracle")
        got = (mask_digest(po.row_keep, po.var_keep), int(po.row_keep.sum()),
               int(po.var_keep.sum()), po.reduced_shape)
        ref = PRUNE_MASKS[name]
        if got != (ref[0], ref[1], ref[2], tuple(ref[3])):
            fail(f"{name}: masks (digest, rows, vars, reduced shape) {got} "
                 f"differ from the JAX package's {ref}")
        if len(legs) != n_k1:
            fail(f"{name} --prune-rows: {len(legs)} K1 launches recorded, "
                 f"{n_k1} counted")
        if on_card and n_k1 <= 0:
            fail(f"{name} --prune-rows: K1 never launched")
        counters = po.obs.metrics.snapshot()["counters"]
        fams = pruned_families(po)
        shapes = Counter((nz, nc) for _k, nz, nc, _it in legs)
        for fam, (nz, nc) in fams.items():
            log(f"[prune] {name}: {fam} (nz, nc) = ({nz}, {nc}), K1 "
                f"{k1_path(nz, nc)} path: {shapes.get((nz, nc), 0)} "
                "launches")
        other = sum(n for sh, n in shapes.items()
                    if sh not in fams.values())
        if other:
            log(f"[prune] {name}: {other} launches at other shapes")
        k1_ms = profiled_ms(prof, "ipm_leg")
        k1 = k1_build_summary(legs, k1_ms, wall)
        if name == "satellite":
            log_k1_build("--prune-rows (phase 17a)", k1)
        if on_card:
            torch.cuda.synchronize()
        by_shape: dict = defaultdict(float)
        by_cell: dict = defaultdict(float)
        for (nz, nc, k), t0, t1 in times:
            ms = t0.elapsed_time(t1)
            by_shape[(nz, nc)] += ms
            by_cell[(nz, nc, k)] += ms
        by_k = Counter((nz, nc, k) for k, nz, nc, _it in legs)
        log(f"[prune] {name}: K1 launches by (nz, nc, K), most frequent: "
            + ", ".join(f"{c} x{n}" for c, n in by_k.most_common(12)))
        for sh, ms in sorted(by_shape.items(), key=lambda x: -x[1]):
            log(f"[prune] {name}: K1 at (nz, nc) = {sh} ({k1_path(*sh)} "
                f"path): {shapes[sh]} launches, {ms:.2f} ms by CUDA events")
        if by_cell:
            log(f"[prune] {name}: K1 ms by CUDA events at (nz, nc, K), "
                "largest: " + ", ".join(
                    f"{c} {ms:.2f}" for c, ms in sorted(
                        by_cell.items(), key=lambda x: -x[1])[:8]))
        bound = sum(leg_bound_ms(*x) for x in legs)
        base = unpruned.get(name, {})
        b_st = base.get("stats", {})
        b_legs = base.get("legs", [])
        b_bound = sum(leg_bound_ms(*x) for x in b_legs)

        def ms_text(v):
            return f"{v:.2f} ms" if v is not None else "not measured"
        log(f"[prune] {name} --prune-rows on {dev}: {wall:.1f} s under the "
            f"profiler; regions {st['regions']} (reference {ref_regions}), "
            f"uncertified {st['uncertified']}, oracle solves "
            f"{st['oracle_solves']}, device failures "
            f"{st['device_failures']}; prune fallbacks "
            f"{counters.get('oracle.prune_fallbacks', 0)}, gate solves "
            f"{counters.get('oracle.prune_gate_solves', 0)}; K1 {n_k1} "
            f"launches, device time {ms_text(k1_ms)}, summed bound "
            f"{bound:.4f} ms")
        log(f"[prune] {name} unpruned (phase 14, same run): "
            f"{base.get('wall', float('nan')):.1f} s; regions "
            f"{b_st.get('regions')}, uncertified {b_st.get('uncertified')}, "
            f"oracle solves {b_st.get('oracle_solves')}; K1 "
            f"{base.get('n_k1')} launches, device time "
            f"{ms_text(base.get('k1_ms'))}, summed bound {b_bound:.4f} ms")
        problem = make(args[args.index("-e") + 1], **tmain._parse_problem_args(
            [v for k, v in zip(args, args[1:]) if k == "--problem-arg"]))
        hold_table(dev, Tree.load(prefix + ".tree.pkl"), problem, SEED + 17,
                   name + " --prune-rows")
        summary[name] = {
            "regions": st["regions"], "wall_s": wall, "launches": n_k1,
            "k1_ms": k1_ms, "bound_ms": bound,
            "reduced": list(po.reduced_shape),
            "prune_fallbacks": counters.get("oracle.prune_fallbacks", 0),
            "prune_gate_solves": counters.get("oracle.prune_gate_solves", 0),
            "k1_ms_by_shape": {f"{a}x{b}": ms
                               for (a, b), ms in by_shape.items()},
            "k1": k1,
            "unpruned": {"wall_s": base.get("wall"),
                         "launches": base.get("n_k1"),
                         "k1_ms": base.get("k1_ms"), "bound_ms": b_bound}}
        launched[name] = (legs, po)
    return summary, launched


def pruned_k1_cells(dev, launched: dict, base=None) -> dict:
    """17b: K1 against its plain version at the reduced shapes the pruned
    builds launched (every reduced shape off the card), at K1_PRUNED_K
    and the build's most frequent K: f64 to 1e-9 relative, f32 as phase
    2, 4 iterations from the cold start; then timed at the shape's most
    frequent iteration count by CUDA events beside its bound -- the
    large path's shapes through large_path_cells (in turns with the
    baseline library `base` where given), the general path's through
    k1_cell (in turns with the large path's own entry)."""
    from collections import Counter

    on_card = dev.type == "cuda"
    g = np.random.default_rng(SEED + 17)
    cells, err64, err32, main_cell = [], 0.0, 0.0, None
    for name, (legs, po) in launched.items():
        k_main = (Counter(k for k, *_ in legs).most_common(1)[0][0]
                  if legs else max(K1_PRUNED_K))
        its: dict = {}
        for _k, nz, nc, it in legs:
            its.setdefault((nz, nc), Counter())[it] += 1
        reduced = [(f, sh) for f, sh in pruned_families(po).items()
                   if "reduced" in f and (sh in its or not legs)]
        for fam, (nz, nc) in reduced:
            n_iter = (its[(nz, nc)].most_common(1)[0][0]
                      if (nz, nc) in its else 18)
            ks = sorted({*K1_PRUNED_K, k_main})
            tag = f"[K1-pruned] {name} {fam}"
            if k1_path(nz, nc) == "large":
                got, inputs, _e64, _e32 = large_path_cells(
                    dev, [(nz, nc, n_iter)], ks, base,
                    seed=int(g.integers(2 ** 31)), tag=tag)
                pairs = [(c, inputs[(nz, nc, c["K"])]) for c in got]
            else:
                pairs = [k1_cell(dev, g, nz, nc, K, n_iter, tag, base,
                                 reps=20) for K in ks]
            for cell, args in pairs:
                cell.update(build=name, family=fam)
                cells.append(cell)
                err64 = max(err64, cell["max_rel_err_f64"])
                err32 = max(err32, cell["max_rel_err_f32"])
                if main_cell is None and cell["K"] == k_main:
                    main_cell = (args, n_iter, cell)
    args, n_iter, cell = main_cell
    # One call: the plain version takes seconds at the pruned builds' K.
    plain_ms = (cuda_time(lambda: plain_leg(args, n_iter), 1, warmup=0)
                if on_card else None)
    log(f"[K1-pruned] plain version at {cell['build']} {cell['family']} "
        f"K={cell['K']}: " + (f"{plain_ms:.2f} ms" if plain_ms
                              else "not measured"))
    return {"nz": cell["nz"], "nc": cell["nc"], "K": cell["K"],
            "n_iter": n_iter, "ms": cell["ms"], "plain_ms": plain_ms,
            "bound_ms": cell["bound_ms"], "bound_by": cell["bound_by"],
            "max_rel_err_f64": err64, "max_rel_err_f32": err32,
            "cells": cells}


def soc_solves(dev) -> dict:
    """17c: socp_solve, SOCPointOracle.solve_vertices and solve_fixed on
    `dev` against the same calls on the CPU, at SOC_THETAS thetas of
    satellite_soc (SOC_ARGS): usable/converged masks equal, d* equal and
    V* to 1e-6 relative (1e-8 absolute) on the clear thetas (the best
    and runner-up usable commutations apart by more than 1e-6 (1 +
    |V*|)), values to the same on the converged rows, primals as
    soc_primals_held."""
    import torch

    from explicit_hybrid_mpc_tpu_torch.oracle import ipm_leg
    from explicit_hybrid_mpc_tpu_torch.oracle.soc_point import (
        SOCPointOracle, soc_pairs)
    from explicit_hybrid_mpc_tpu_torch.problems.registry import make

    cpu = torch.device("cpu")
    prob = make("satellite_soc", **dict(SOC_ARGS))
    th = np.random.default_rng(SEED + 17).uniform(
        prob.theta_lb, prob.theta_ub, (SOC_THETAS, prob.n_theta))
    ora = {d: SOCPointOracle(prob, device=d) for d in (dev, cpu)}
    ipm_leg.launches = 0
    t0 = time.perf_counter()
    V, usable, _u0, Vstar, dstar = ora[dev].solve_vertices(th)
    grid_s = time.perf_counter() - t0
    n_grid = ipm_leg.launches
    rV, rusable, _ru0, rVstar, rdstar = ora[cpu].solve_vertices(th)
    if not np.array_equal(usable, rusable):
        fail(f"17c solve_vertices: usable differs on "
             f"{int((usable != rusable).sum())} cells")
    vv = np.sort(np.where(rusable, rV, np.inf), axis=1)
    clear = vv[:, 1] - vv[:, 0] > 1e-6 * (1 + np.abs(vv[:, 0]))
    if not np.array_equal(dstar[clear], rdstar[clear]):
        fail("17c solve_vertices: d* differs on clear thetas")
    if not np.allclose(Vstar[clear], rVstar[clear], rtol=1e-6, atol=1e-8):
        fail("17c solve_vertices: V* differs on clear thetas")
    # solve_fixed and the raw socp_solve at the CPU's d*.
    ds = np.where(rdstar >= 0, rdstar, 0)
    u0f, Vf, convf, zf = ora[dev].solve_fixed(th, ds)
    ru0f, rVf, rconvf, rzf = ora[cpu].solve_fixed(th, ds)
    if not np.array_equal(convf, rconvf):
        fail("17c solve_fixed: usable differs")
    if not np.allclose(Vf[rconvf], rVf[rconvf], rtol=1e-6, atol=1e-8):
        fail("17c solve_fixed: V differs")
    fixed = soc_primals_held("17c solve_fixed", prob, th[rconvf],
                             ds[rconvf], zf[rconvf], rzf[rconvf])
    sols = {}
    for d in (dev, cpu):
        o = ora[d]
        sol, Vd, _u = soc_pairs(
            o.prob, o._Ac, o._bc, torch.as_tensor(th, device=d),
            torch.as_tensor(ds, device=d), o.n_iter)
        sols[d] = (sol.converged.cpu().numpy(), sol.obj.cpu().numpy(),
                   sol.z.cpu().numpy())
    (c, obj, z), (rc, robj, rz) = sols[dev], sols[cpu]
    if not np.array_equal(c, rc):
        fail("17c socp_solve: converged differs")
    if not np.allclose(obj[rc], robj[rc], rtol=1e-6, atol=1e-8):
        fail("17c socp_solve: objective differs")
    raw = soc_primals_held("17c socp_solve", prob, th[rc], ds[rc], z[rc],
                           rz[rc])
    log(f"[soc] satellite_soc {dict(SOC_ARGS)} (nz {prob.canonical.nz}, "
        f"nc {prob.canonical.nc}, {len(prob.soc_cones()[1])} cones, "
        f"{prob.canonical.n_delta} commutations), {SOC_THETAS} thetas on "
        f"{dev} against the CPU: solve_vertices {1e3 * grid_s:.1f} ms "
        f"({n_grid} K1 launches), usable equal, d* and V* equal on "
        f"{int(clear.sum())}/{SOC_THETAS} clear thetas (max |dV*| "
        f"{float(np.abs(Vstar - rVstar)[clear].max()):.2e}); solve_fixed "
        f"at d*: {fixed}; socp_solve: converged {int(c.sum())}/"
        f"{SOC_THETAS} equal, objective to 1e-6, {raw}")
    return {"thetas": SOC_THETAS, "clear": int(clear.sum()),
            "grid_ms": 1e3 * grid_s, "grid_k1_launches": n_grid}


def soc_partition(dev) -> dict:
    """17d: satellite_soc (SOC_ARGS) through build_partition with
    SOCOracle on `dev` at scripts/soc_partition.py's defaults (SOC_CFG):
    regions within 2% of SOC_REF_REGIONS, 0 uncertified, no device
    failure, K1 launched (the joint programs and the SOC solves' linear
    QPs) -- then that script's sampled soundness check at SOC_SAMPLES
    thetas in certified leaves: the interpolated primal satisfies the
    linear rows and the cones, and its excess over the SOC ground truth
    is at most eps_a + eps_r |V*|."""
    import torch

    from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
    from explicit_hybrid_mpc_tpu_torch.oracle import ipm_leg
    from explicit_hybrid_mpc_tpu_torch.oracle.soc_oracle import SOCOracle
    from explicit_hybrid_mpc_tpu_torch.partition import geometry
    from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
        build_partition)
    from explicit_hybrid_mpc_tpu_torch.problems.registry import make

    on_card = dev.type == "cuda"
    prob = make("satellite_soc", **dict(SOC_ARGS))
    opts = dict(SOC_CFG)
    cfg = PartitionConfig(problem="satellite_soc", problem_args=SOC_ARGS,
                          backend=dev.type, **opts)
    ipm_leg.launches = 0
    oracle = SOCOracle(prob, backend=dev.type)
    t0 = time.perf_counter()
    res = build_partition(prob, cfg, oracle=oracle)
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_k1 = ipm_leg.launches
    st = res.stats
    log(f"[soc] SOC partition on {dev}: {wall:.1f} s; regions "
        f"{st['regions']} (reference {SOC_REF_REGIONS}), tree nodes "
        f"{st['tree_nodes']}, uncertified {st['uncertified']}, point solves "
        f"{st['point_solves']}, simplex solves {st['simplex_solves']}, "
        f"steps {st['steps']}, truncated {st['truncated']}, device failures "
        f"{st['device_failures']}; K1 launches {n_k1}")
    if st["device_failures"] != 0 or st["device_degraded"] is not False:
        fail("SOC partition: the build fell back from the device")
    if abs(st["regions"] - SOC_REF_REGIONS) > 0.02 * SOC_REF_REGIONS:
        fail(f"SOC partition: regions {st['regions']} not within 2% of "
             f"{SOC_REF_REGIONS}")
    if st["uncertified"] != 0:
        fail(f"SOC partition: uncertified {st['uncertified']}")
    if st["truncated"] and opts.get("max_steps", 10_000) >= 10_000:
        fail("SOC partition: truncated")
    if on_card and n_k1 <= 0:
        fail("SOC partition: K1 never launched")
    # -- the sampled soundness check of scripts/soc_partition.py, its
    # thetas drawn in the same order; the ground truth solved in batches.
    eps_a, eps_r = opts["eps_a"], opts["eps_r"]
    rng = np.random.default_rng(11)
    can = prob.canonical
    Ac, bc = prob.soc_cones()
    tree = res.tree
    checked = skipped = attempts = 0
    max_excess = max_lin = -np.inf
    min_cone = np.inf
    t0 = time.perf_counter()
    while checked < SOC_SAMPLES and attempts < 60 * SOC_SAMPLES:
        batch = []
        while (len(batch) < SOC_SAMPLES - checked
               and attempts < 60 * SOC_SAMPLES):
            attempts += 1
            th = rng.uniform(prob.theta_lb, prob.theta_ub)
            n = tree.locate(th, res.roots)
            ld = tree.leaf_data[n] if n >= 0 else None
            if (ld is None or not getattr(ld, "certified", True)
                    or ld.vertex_z is None):
                skipped += 1
                continue
            batch.append((th, n, ld))
        if not batch:
            break
        sol = oracle.solve_vertices(np.stack([b[0] for b in batch]))
        for (th, n, ld), Vs, dsr in zip(batch, sol.Vstar, sol.dstar):
            if dsr < 0:
                skipped += 1
                continue
            zbar = geometry.barycentric(tree.vertices[n], th) @ ld.vertex_z
            d = ld.delta_idx
            lin = float(np.max(can.G[d] @ zbar - can.w[d] - can.S[d] @ th))
            sc = bc - np.einsum("kmn,n->km", Ac, zbar)
            cone = float(np.min(sc[:, 0] - np.linalg.norm(sc[:, 1:],
                                                          axis=1)))
            excess = float(can.value(d, th, zbar)) - float(Vs)
            max_excess = max(max_excess, excess - eps_r * abs(float(Vs)))
            max_lin, min_cone = max(max_lin, lin), min(min_cone, cone)
            checked += 1
    sound = (checked == SOC_SAMPLES and max_excess <= eps_a + 1e-6
             and max_lin < 1e-6 and min_cone > -1e-8)
    log(f"[soc] soundness: {checked} thetas in certified leaves "
        f"({skipped} skipped) in {time.perf_counter() - t0:.1f} s: max "
        f"excess - eps_r |V*| {max_excess:.4g} (bound eps_a {eps_a}), max "
        f"linear violation {max_lin:.3g}, min cone margin {min_cone:.4g}")
    if not sound:
        fail("SOC partition: the sampled soundness check failed")
    return {"regions": st["regions"], "wall_s": wall, "launches": n_k1,
            "samples": checked, "max_excess_minus_rel": max_excess}


def pruning_soc_phase(dev, tmp: str, unpruned: dict, base=None) -> dict:
    """Phase 17: constraint-row pruning and the SOC oracle stack on
    `dev` (17a pruned_builds, 17b pruned_k1_cells -- with K1_BASELINE's
    library `base` in turns --, 17c soc_solves, 17d soc_partition).
    Returns the kernels line's ipm_leg "pruned" object."""
    t_phase = time.perf_counter()
    took = {}

    def part(label, fn, *args):
        t0 = time.perf_counter()
        r = fn(*args)
        took[label] = time.perf_counter() - t0
        return r

    builds, launched = part("17a", pruned_builds, dev, tmp, unpruned)
    out = part("17b", pruned_k1_cells, dev, launched, base)
    out["builds"] = builds
    out["soc"] = {"solves": part("17c", soc_solves, dev),
                  "partition": part("17d", soc_partition, dev)}
    log(f"[prune] (phase took {time.perf_counter() - t_phase:.1f} s: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in took.items()) + ")")
    return out


#: Phase 18a: forced divergence through each K1 path -- (label, problem,
#: constructor args, the K1 path its point QPs take), the sub-boxes of
#: phase 14 (artifacts/configs_cpu_r5.json rows "4c" and "5b").
DIAG_PROBLEMS = (
    ("inverted_pendulum", "inverted_pendulum", {}, "register"),
    ("satellite 4c", "satellite",
     {"axes": 3, "omega_box": 0.03, "h_box": 0.3}, "general"),
    ("quadrotor pv", "quadrotor",
     {"param": "pv", "pos_box": 0.4, "vel_box": 0.2}, "large"))
#: Seeded (theta, delta) cells a forced-divergence call solves, and the
#: IPM schedule that cannot converge them (the JAX package's
#: tests/test_diagnostics.py fault injection).
DIAG_CELLS = 256
DIAG_N_ITER = 2
#: Phase 18f: requests of the `main serve --selftest` run whose obs
#: stream goes through the health monitor.
DIAG_SERVE_REQUESTS = 4096


def timed_replay(dev, replay_fn, *args, **kw) -> tuple[dict, int, float]:
    """(report, K1 launches, ms) of one replay on `dev`: K1's count is
    set to 0 just before the replay and read just after."""
    import torch

    from explicit_hybrid_mpc_tpu_torch.oracle import ipm_leg

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    ipm_leg.launches = 0
    t0 = time.perf_counter()
    rep = replay_fn(*args, **kw)
    sync()
    return rep, ipm_leg.launches, 1e3 * (time.perf_counter() - t0)


def forced_divergence(dev, tmp: str) -> dict:
    """Phase 18a: Oracle(n_iter=2) with a flight recorder on the card at
    each K1 path; every call's diverged_cells bundle must replay on the
    card to the observed conv and feas masks bit for bit and V bitwise,
    and the kernel-only probe (ipm.solve_mask through K1) must agree
    with the observed conv mask.  Returns the replays' K1 launches and
    ms per problem."""
    from explicit_hybrid_mpc_tpu_torch.obs import replay
    from explicit_hybrid_mpc_tpu_torch.obs.recorder import (FlightRecorder,
                                                            load_bundle)
    from explicit_hybrid_mpc_tpu_torch.oracle import oracle
    from explicit_hybrid_mpc_tpu_torch.problems.registry import make

    out = {}
    for label, name, kw, path in DIAG_PROBLEMS:
        prob = make(name, **kw)
        can = prob.canonical
        if k1_path(can.nz, can.nc) != path:
            fail(f"18a {label}: nz={can.nz} nc={can.nc} takes K1's "
                 f"{k1_path(can.nz, can.nc)} path, not {path}")
        rec = FlightRecorder(os.path.join(tmp, f"18a_{name}"))
        orc = oracle.Oracle(prob, backend=dev.type, n_iter=DIAG_N_ITER)
        orc.recorder = rec
        g = np.random.default_rng(SEED + 18)
        th = g.uniform(prob.theta_lb, prob.theta_ub,
                       (DIAG_CELLS, can.n_theta))
        ds = g.integers(0, can.n_delta, DIAG_CELLS)
        _V, conv, *_ = orc.solve_pairs(th, ds)
        if len(rec.bundles) != 1 or rec.n_capture_errors:
            fail(f"18a {label}: {len(rec.bundles)} bundles, "
                 f"{rec.n_capture_errors} capture errors (want 1, 0)")
        meta, arrays = load_bundle(rec.bundles[0])
        if meta["trigger"] != "diverged_cells" or meta["kind"] != "pairs":
            fail(f"18a {label}: bundle {meta['trigger']}/{meta['kind']}")
        rep, n_rep, ms = timed_replay(dev, replay.replay_bundle,
                                      rec.bundles[0], backend=dev.type)
        kep, n_kep, kms = timed_replay(dev, replay.replay_bundle,
                                       rec.bundles[0], backend=dev.type,
                                       kernel_only=True)
        log(f"[diag] 18a {label} (K1 {path} path, nz={can.nz} "
            f"nc={can.nc}): {int(conv.sum())}/{DIAG_CELLS} converged, "
            f"{meta['n_anomalous']} feasible-unconverged, "
            f"{meta['captured']} captured; replay conv "
            f"{rep['conv_mismatches']} / feas {rep['feas_mismatches']} "
            f"mismatches, V bitwise {rep['V_bitwise']}, {n_rep} K1 "
            f"launches in {ms:.1f} ms; kernel-only conv mismatches "
            f"{kep['kernel_vs_obs_conv_mismatches']}, {n_kep} K1 launches "
            f"in {kms:.1f} ms")
        if not (rep["ok"] and rep["same_platform"] and rep["conv_match"]
                and rep["feas_match"] and rep["V_bitwise"]):
            fail(f"18a {label}: the replay on the card differs: {rep}")
        if not kep["kernel_vs_obs_conv_match"]:
            fail(f"18a {label}: the kernel-only probe differs: {kep}")
        if dev.type == "cuda" and (n_rep <= 0 or n_kep <= 0):
            fail(f"18a {label}: a replay did not go through K1 "
                 f"({n_rep}, {n_kep} launches)")
        out[label] = {"path": path, "captured": meta["captured"],
                      "replay_launches": n_rep, "replay_ms": ms,
                      "kernel_only_launches": n_kep, "kernel_only_ms": kms}
    return out


def replay_bundles(dev, paths: list, name: str) -> dict:
    """Replay every bundle of `paths` on the card: each must be ok by
    its kind's contract (a cell bundle's snapshot must not certify, a
    recert bundle must reproduce its invalidation).  Returns the counts
    by kind, vertex conv flips (advisory for cell/recert bundles), and
    the replays' K1 launches and ms."""
    from explicit_hybrid_mpc_tpu_torch.obs import replay

    out = {"kinds": {}, "conv_flips": 0, "launches": 0, "ms": 0.0}
    for path in paths:
        rep, n, ms = timed_replay(dev, replay.replay_bundle, path,
                                  backend=dev.type)
        kind = rep["kind"]
        out["kinds"][kind] = out["kinds"].get(kind, 0) + 1
        out["launches"] += n
        out["ms"] += ms
        if kind in ("cell", "recert"):
            out["conv_flips"] += rep["conv_mismatches"]
        if not rep["ok"] or (kind == "cell" and rep[
                "snapshot_stage1_status"] == "certified"):
            fail(f"{name}: the replay of {os.path.basename(path)} on the "
                 f"card contradicts its capture: {rep}")
    return out


def recorded_build(dev, problem, cfg, res, build_s: float, tmp: str) -> dict:
    """Phase 18b: the flagship build again with obs on, the flight
    recorder and the health monitor (default rules plus a throughput
    floor ten times phase 3's rate, which must fire
    health.throughput_low): the tree equal to phase 3's cell for cell,
    a cell bundle for each uncertified leaf up to the recorder's cap of
    16 a trigger with the overflow counted, the bundle counter equal to
    the bundle events, no capture error, and every bundle replayed on
    the card (a cell bundle's snapshot must not certify)."""
    import dataclasses

    import torch

    from explicit_hybrid_mpc_tpu_torch.obs import load_jsonl
    from explicit_hybrid_mpc_tpu_torch.oracle import ipm_leg
    from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
        FrontierEngine, make_oracle)

    floor = 10.0 * res.stats["regions"] / build_s
    stream = os.path.join(tmp, "18b.obs.jsonl")
    cfg_b = dataclasses.replace(
        cfg, obs="jsonl", obs_path=stream, obs_recorder=True,
        recorder_dir=os.path.join(tmp, "18b.repro"),
        health_rules=(("min_regions_per_s", floor),))
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    ipm_leg.launches = 0
    sync()
    t0 = time.perf_counter()
    eng = FrontierEngine(problem, make_oracle(problem, cfg_b), cfg_b)
    res_b = eng.run()
    sync()
    wall = time.perf_counter() - t0
    n_k1 = ipm_leg.launches
    rec = eng.recorder
    recs = load_jsonl(stream)
    snap = [r for r in recs if r["kind"] == "metrics"][-1]["counters"]
    n_events = sum(r.get("name") == "recorder.bundle" for r in recs)
    fired = [r for r in recs if str(r.get("name")).startswith("health.")]
    a, b = tree_outcomes(res.tree), tree_outcomes(res_b.tree)
    diff, other = differing_cells(a, b)
    st = res_b.stats
    log(f"[diag] 18b flagship build with recorder + health on: {wall:.1f} s "
        f"(phase 3: {build_s:.1f} s), regions {st['regions']}, uncertified "
        f"{st['uncertified']}, {n_k1} K1 launches; tree "
        f"{'equal to' if a == b else 'NOT equal to'} phase 3's cell for "
        f"cell ({len(a)} cells, {len(diff)} decided differently, {other} "
        f"other commutations); bundles {len(rec.bundles)} (counter "
        f"{snap.get('recorder.bundles')}, events {n_events}), dropped "
        f"{rec.n_dropped}, capture errors "
        f"{snap.get('recorder.capture_errors')}; health events "
        + ", ".join(f"{r['name']} ({r['severity']}, value {r.get('value')}"
                    f", threshold {r.get('threshold')})" for r in fired))
    if a != b:
        fail("18b: watching changed the tree")
    cells = [p for p in rec.bundles if "uncertified_leaf" in p]
    if not (len(cells) == min(rec.max_bundles, st["uncertified"])
            and snap.get("recorder.bundles") == n_events == len(rec.bundles)
            and rec.n_dropped >= st["uncertified"] - len(cells)):
        fail("18b: the bundles, their counter, their events and the "
             "overflow do not add up")
    if rec.n_capture_errors or snap.get("recorder.capture_errors") != 0:
        fail("18b: a capture raised")
    if not any(r["name"] == "health.throughput_low"
               and r["severity"] == "warn" for r in fired):
        fail("18b: health.throughput_low did not fire")
    if any(r["severity"] == "critical" for r in fired):
        fail("18b: a critical health verdict on a healthy build")
    rp = replay_bundles(dev, rec.bundles, "18b")
    log(f"[diag] 18b replays on the card: {rp['kinds']} ({len(cells)} cell "
        f"bundles, snapshot never certifies), vertex conv flips "
        f"{rp['conv_flips']} (advisory), {rp['launches']} K1 launches in "
        f"{rp['ms']:.1f} ms")
    return {"bundles": len(rec.bundles), "dropped": rec.n_dropped,
            "replays": rp}


def auto_profile_trigger(dev, tmp: str) -> dict:
    """Phase 18c: the JAX package's auto-profile schedule on the card --
    the tier-1 DI build with stall_s 0.2 and two 0.4 s stalls at
    oracle.wait (the port's 'stall' fault kind: the solve comes back
    late, so nothing fails and nothing falls back): health.stall
    (critical) fires, exactly one capture opens, its summary names K1's
    kernel among the card's ops (device_ops_ms: top_ops_ms ranks the
    host's ops and the card's together, and the host's fill it), and
    build.auto_profiles is 1."""
    import glob

    from explicit_hybrid_mpc_tpu_torch import faults
    from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
    from explicit_hybrid_mpc_tpu_torch.faults.plan import FaultPlan
    from explicit_hybrid_mpc_tpu_torch.obs import load_jsonl
    from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
        build_partition)
    from explicit_hybrid_mpc_tpu_torch.problems.registry import make

    path = os.path.join(tmp, "18c.obs.jsonl")
    rdir = os.path.join(tmp, "18c.repro")
    cfg = PartitionConfig(
        problem="double_integrator",
        problem_args=(("N", 3), ("theta_box", 1.5)), eps_a=0.4,
        backend=dev.type, batch_simplices=64, obs="jsonl", obs_path=path, auto_profile=True,
        profile_steps=2, recorder_dir=rdir,
        health_rules=(("stall_s", 0.2),))
    plan = FaultPlan(faults=(
        {"site": "oracle.wait", "kind": "stall", "at": 2, "hang_s": 0.4},
        {"site": "oracle.wait", "kind": "stall", "at": 7, "hang_s": 0.4}))
    t0 = time.perf_counter()
    with faults.activate(plan):
        res = build_partition(make("double_integrator", N=3,
                                   theta_box=1.5), cfg)
    wall = time.perf_counter() - t0
    recs = load_jsonl(path)
    stalls = [r for r in recs if r.get("name") == "health.stall"]
    caps = [r for r in recs if r.get("name") == "profile.capture"]
    bundles = glob.glob(os.path.join(rdir, "auto_profile_*.json"))
    snap = [r for r in recs if r["kind"] == "metrics"][-1]["counters"]
    st = res.stats
    summ = {}
    if len(bundles) == 1:
        with open(bundles[0]) as f:
            summ = json.load(f).get("trace_summary", {})
    top = [r["name"] for r in summ.get("top_ops_ms", [])]
    dev_top = [r["name"] for r in summ.get("device_ops_ms", [])]
    k1_rank, k1_dev = (next((i + 1 for i, n in enumerate(names)
                             if "ipm_leg" in n), None)
                       for names in (top, dev_top))
    log(f"[diag] 18c auto-profile on an injected stall: build {wall:.1f} s, "
        f"regions {st['regions']}, device failures {st['device_failures']}; "
        f"{len(stalls)} health.stall "
        f"({', '.join(str(r.get('value')) for r in stalls)} s idle, "
        f"{stalls[0]['severity'] if stalls else '-'}), {len(caps)} "
        f"profile.capture, {len(bundles)} auto_profile bundle(s), "
        f"build.auto_profiles {snap.get('build.auto_profiles')}; K1's "
        f"kernel at rank {k1_dev or 'absent'} of the {len(dev_top)} "
        f"device_ops_ms, {k1_rank or 'absent'} of the {len(top)} "
        "top_ops_ms (host and device ops)")
    if st["device_failures"] or st["device_degraded"] \
            or st["quarantined_cells"]:
        fail("18c: the build fell back from the device")
    if not stalls or stalls[0]["severity"] != "critical":
        fail("18c: health.stall (critical) did not fire")
    if len(caps) != 1 or len(bundles) != 1 \
            or snap.get("build.auto_profiles") != 1:
        fail(f"18c: {len(caps)} captures, {len(bundles)} bundles, "
             f"build.auto_profiles {snap.get('build.auto_profiles')} "
             "(want exactly one)")
    if dev.type == "cuda" and k1_dev is None:
        fail("18c: the capture's device ops do not name K1's kernel")
    return {"stalls": len(stalls), "captures": len(caps),
            "k1_device_rank": k1_dev, "k1_top_rank": k1_rank}


def recorded_rebuild(dev, cfg, res, tmp: str) -> dict:
    """Phase 18d: phase 15a's unchanged warm rebuild from phase 3's tree,
    with the recorder on: the leaves whose stored certificate fails
    stage 1 or stage 2 give recert bundles (at most 16; a closed-
    infeasible leaf's failed Farkas re-proof gives none, as in the JAX
    package), each replayed on the card with the invalidation verdict
    reproduced, and every other bundle of the run too."""
    from explicit_hybrid_mpc_tpu_torch.obs import load_jsonl

    on_card = dev.type == "cuda"
    flags = ["-e", cfg.problem, "--batch", str(cfg.batch_simplices),
             "--max-depth", str(cfg.max_depth),
             *([] if on_card else ["--backend", "cpu"])]
    for k, v in cfg.problem_args:
        flags += ["--problem-arg", f"{k}={json.dumps(v)}"]
    prior = os.path.join(tmp, "18d.prior.tree.pkl")
    res.tree.save(prior)
    out = os.path.join(tmp, "18d")
    bdir = out + ".bundles"
    rc, st, _ev, wall, _legs, n_k1, _n_k2, _prof = run_main(
        ["rebuild", *flags, "-a", str(cfg.eps_a), "--from", prior, "-o",
         out, "--recorder-dir", bdir, "--obs", "jsonl"], on_card)
    if rc != 0:
        fail(f"18d: main rebuild --recorder-dir returned {rc}")
    paths = sorted(os.path.join(bdir, f) for f in os.listdir(bdir)) \
        if os.path.isdir(bdir) else []
    recert = [p for p in paths if "recert_invalidated" in p]
    snap = [r for r in load_jsonl(out + ".obs.jsonl")
            if r["kind"] == "metrics"][-1]["counters"]
    rp = replay_bundles(dev, paths, "18d")
    log(f"[diag] 18d warm rebuild with the recorder: {wall:.1f} s, regions "
        f"{st['regions']}, invalidated {st['rebuild_leaves_invalidated']}, "
        f"{n_k1} K1 launches; bundles {len(paths)} ({len(recert)} recert), "
        f"capture errors {snap.get('recorder.capture_errors')}; replays on "
        f"the card {rp['kinds']}, every invalidation verdict reproduced, "
        f"vertex conv flips {rp['conv_flips']} (advisory), "
        f"{rp['launches']} K1 launches in {rp['ms']:.1f} ms")
    check_build("18d rebuild", st, REBUILD_REF_REGIONS, REF_UNCERTIFIED_MAX)
    if not 0 < len(recert) <= 16:
        fail(f"18d: {len(recert)} recert bundles (want 1..16)")
    if snap.get("recorder.capture_errors") != 0:
        fail("18d: a capture raised")
    return {"bundles": len(paths), "recert": len(recert), "replays": rp}


def fleet_streams(dev, tmp: str) -> dict:
    """Phase 18e: two `python -m explicit_hybrid_mpc_tpu_torch.main`
    builds of the tier-1 DI fixture at once on cuda:0, with one obs path,
    --obs-per-process, the recorder and a health rule: two .pI-PID
    streams, two identities, no strict issue, the fleet rollup's
    counters the sum of the two final snapshots bit exactly, the merged
    events ordered on t_abs, and the fleet monitor's verdict."""
    from explicit_hybrid_mpc_tpu_torch.obs import fleet

    obs_path = os.path.join(tmp, "18e.obs.jsonl")
    env = {**os.environ, "EHM_RUN_ID": "chipsmoke18e"}
    procs = []
    t0 = time.perf_counter()
    for i in range(2):
        cmd = [sys.executable, "-m", "explicit_hybrid_mpc_tpu_torch.main",
               *SIM_DI_ARGS, "--obs", "jsonl", "--obs-path", obs_path,
               "--obs-per-process", "--recorder", "--health-rule",
               "stall_s=300", "-o", os.path.join(tmp, f"18e_{i}"),
               *([] if dev.type == "cuda" else ["--backend", "cpu"])]
        procs.append(subprocess.Popen(cmd, cwd=os.path.dirname(
            os.path.abspath(__file__)), env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True))
    try:
        errs = [p.communicate(timeout=300)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for p, e in zip(procs, errs):
        if p.returncode != 0:
            fail(f"18e: a build exited {p.returncode}: {e[-2000:]}")
    paths = fleet.resolve_streams(obs_path)
    pids = sorted(p.pid for p in procs)
    streams = fleet.load_fleet(obs_path)
    issues = fleet.strict_issues(streams)
    roll = fleet.fleet_rollup(streams)
    last = [[r for r in s.records if r["kind"] == "metrics"][-1]["counters"]
            for s in streams]
    summed = {}
    for c in last:
        for k, v in c.items():
            summed[k] = summed.get(k, 0) + v
    merged = fleet.merge_events(streams)
    t_abs = [r["t_abs"] for r in merged]
    mon = fleet.FleetMonitor()
    for s in streams:
        for r in s.records:
            mon.feed(s.shard, r)
    verdict = mon.finalize(streams)
    strag = fleet.straggler_report(streams)
    log(f"[diag] 18e two concurrent builds on {dev}, one obs path: "
        f"{wall:.1f} s; streams "
        f"{[os.path.basename(p) for p in paths]}; identities "
        f"{sorted(s.shard for s in streams)}, run_ids {roll['run_ids']}, "
        f"strict issues {issues}; rollup build.steps "
        f"{roll['counters'].get('build.steps')}, oracle.point_solves "
        f"{roll['counters'].get('oracle.point_solves')}, regions max "
        f"{roll['regions']}; {len(merged)} merged records; fleet verdict "
        f"{mon.worst} ({[e['name'] for e in verdict]})")
    log(f"[diag] 18e straggler_report: " + json.dumps(
        {"concurrent": strag["concurrent"],
         "straggle_frac": strag["straggle_frac"],
         "slowest": strag["slowest"], "fastest": strag["fastest"],
         "shards": {k: {f: v.get(f) for f in ("steps", "regions",
                                              "regions_per_s", "lag_s")}
                    for k, v in strag["shards"].items()}}))
    if len(paths) != 2 or sorted(int(p.rsplit("-", 1)[1].split(".")[0])
                                 for p in paths) != pids:
        fail(f"18e: streams {paths}, want one per pid {pids}")
    if len({s.identity["pid"] for s in streams if s.identity}) != 2 \
            or issues:
        fail(f"18e: identities or strict issues wrong ({issues})")
    if roll["counters"] != summed:
        fail("18e: the fleet rollup's counters are not the sum of the "
             "two final snapshots")
    if t_abs != sorted(t_abs):
        fail("18e: merge_events is not ordered on t_abs")
    return {"streams": len(paths), "wall_s": wall, "worst": mon.worst}


def serving_health(dev, res, tmp: str) -> dict:
    """Phase 18f: `main serve --selftest` on the flagship artifacts with
    an obs stream (--fallback off: every answer from the table), fed
    record by record to a HealthMonitor: a serve_p99_us ceiling at half
    the measured p99 fires health.serve_p99_us for the controller, a
    ceiling at twice the largest p99 gauge fires nothing."""
    import contextlib
    import io

    from explicit_hybrid_mpc_tpu_torch.obs import load_jsonl
    from explicit_hybrid_mpc_tpu_torch.obs.health import HealthMonitor
    from explicit_hybrid_mpc_tpu_torch.serve import registry
    from explicit_hybrid_mpc_tpu_torch.serve.cli import serve_main

    art = os.path.join(tmp, "18f.pend")
    registry.save_artifacts(res.tree, res.roots, art)
    stream = os.path.join(tmp, "18f.obs.jsonl")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = serve_main(["--artifacts", art, "--controller", "pend",
                         "--selftest", str(DIAG_SERVE_REQUESTS),
                         "--fallback", "off", "--obs", "jsonl",
                         "--obs-path", stream,
                         *([] if dev.type == "cuda"
                           else ["--backend", "cpu"])])
    summ = json.loads(buf.getvalue().strip().splitlines()[-1])
    recs = load_jsonl(stream)
    p99s = [r["gauges"]["serve.ctl.pend.p99_us"] for r in recs
            if r["kind"] == "metrics"
            and "serve.ctl.pend.p99_us" in r.get("gauges", {})]
    if rc != 0 or not p99s:
        fail(f"18f: serve rc {rc}, {len(p99s)} p99 gauges in the stream")
    out = {}
    for label, ceiling in (("below", 0.5 * p99s[-1]),
                           ("above", 2.0 * max(p99s))):
        mon = HealthMonitor({"serve_p99_us": ceiling,
                             "min_solves_for_rates": 1.0})
        for r in recs:
            mon.feed(r)
        out[label] = mon
        log(f"[diag] 18f serve stream ({summ['requests']} requests, p99 "
            f"{summ['p99_us']:.0f} us; gauge {p99s[-1]:.0f} us) through "
            f"the monitor at a ceiling of {ceiling:.0f} us ({label} the "
            f"p99): {[e['name'] for e in mon.events]}, exit code "
            f"{mon.exit_code}")
    if not any(e["name"] == "health.serve_p99_us" and "'pend'" in e["msg"]
               for e in out["below"].events):
        fail("18f: health.serve_p99_us did not fire for the controller")
    if out["above"].events:
        fail("18f: the monitor fired above the p99")
    return {"p99_us": p99s[-1]}


def diagnostics_phase(dev, problem, cfg, res, build_s: float,
                      tmp: str) -> dict:
    """Phase 18: the build's diagnostics on the card (18a-18f above)."""
    t0 = time.perf_counter()
    out = {"forced": forced_divergence(dev, tmp),
           "build": recorded_build(dev, problem, cfg, res, build_s, tmp),
           "auto_profile": auto_profile_trigger(dev, tmp),
           "rebuild": recorded_rebuild(dev, cfg, res, tmp),
           "fleet": fleet_streams(dev, tmp),
           "serve": serving_health(dev, res, tmp)}
    log(f"[diag] phase 18 took {time.perf_counter() - t0:.1f} s")
    return out


def diagnostics_only() -> int:
    """Phase 18 alone, for iterating on the diagnostics on the card: the
    kernels built, a flagship build standing in for phase 3's, then
    18a-18f.

        python3 -c "import sys, chip_smoke as c; sys.exit(c.diagnostics_only())"
    """
    import torch

    from explicit_hybrid_mpc_tpu_torch import kernels
    from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
    from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
        build_partition)
    from explicit_hybrid_mpc_tpu_torch.problems.registry import make

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    kernels.build()
    log(f"[build] kernels in {time.perf_counter() - t0:.1f} s")
    problem = make("inverted_pendulum")
    cfg = PartitionConfig(problem="inverted_pendulum", eps_a=1e-2)
    t0 = time.perf_counter()
    res = build_partition(problem, cfg)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    log(f"[main] build {build_s:.1f} s: regions {res.stats['regions']}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_diag_") as tmp:
        diagnostics_phase(dev, problem, cfg, res, build_s, tmp)
    return 0


# -- phase 19: the SLO engine and demand telemetry ---------------------------

#: Phase 19 (the SLO engine and demand telemetry).  Requests of each arena
#: run (phase 8's traffic, cut to 5,000 so the phase stays short), the
#: run pairs timed in turns (off/on, on/off, ...), the online
#: suboptimality stride and eps (the flagship's eps_a; eps_r is 0),
#: `main serve --selftest` rows, the sketch's exact capacity (above the
#: flagship's leaf count, so the per-leaf counts stay exact), the SLO
#: windows scaled to seconds (the JAX tests' geometry, 1 s slots) with
#: their burn thresholds, and the demand-ordered rebuild's region
#: tolerance against phase 15a's unprioritized rebuild.
SD_REQUESTS = 5_000
SD_PAIRS = 2
SD_SUBOPT_FRAC = 1 / 16
SD_SUBOPT_EPS = 1e-2
SD_SELFTEST = 4096
SD_MAX_LEAVES = 16_384
SD_WINDOWS = ((5.0, 60.0), (120.0, 600.0))
SD_BURNS = (14.4, 1.0)
SD_REGION_TOL = 1e-3
# 19d's K1 launches against phase 15b's unprioritized rebuild at the same
# eps: the hint reorders the frontier's entry, not the work.
SD_K1_TOL = 0.10


class RecordingOracle:
    """The demand hub's oracle, recorded: each solve_vertices call's
    thetas, V* and d* (host copies) and the thread that made it, so the
    hub's re-solves can be held to another oracle on the same points."""

    def __init__(self, oracle):
        import threading

        self.oracle = oracle
        self.calls: list = []
        self._lock = threading.Lock()

    def solve_vertices(self, thetas):
        import threading

        sol = self.oracle.solve_vertices(thetas)
        with self._lock:
            self.calls.append((np.array(thetas, dtype=np.float64),
                               np.array(sol.Vstar, dtype=np.float64),
                               np.array(sol.dstar),
                               threading.get_ident()))
        return sol


def demand_serve(dev, res, tmp: str) -> dict:
    """19a: `main serve --selftest SD_SELFTEST` on phase 3's artifacts,
    with --demand on (snapshot under --demand-dir) and off, each
    request's answer kept from the CLI's scheduler: the answers bitwise
    the same in both; the snapshot commits and loads (load_demand), its
    raw row count is the served rows and its leaves theirs.  The path
    serves through ShardedDescent (plain torch): no hand kernel runs."""
    import contextlib
    import io

    from explicit_hybrid_mpc_tpu_torch.obs.demand import load_demand
    from explicit_hybrid_mpc_tpu_torch.online import fused, locate
    from explicit_hybrid_mpc_tpu_torch.oracle import ipm_leg
    from explicit_hybrid_mpc_tpu_torch.serve import registry, scheduler
    from explicit_hybrid_mpc_tpu_torch.serve.cli import serve_main

    art = os.path.join(tmp, "19a.pend")
    registry.save_artifacts(res.tree, res.roots, art)
    droot = os.path.join(tmp, "19a.demand")
    real = scheduler.RequestScheduler
    runs = {}
    for mode in ("on", "off"):
        tickets: list = []

        class Kept(real):
            def submit(self, theta):
                t = super().submit(theta)
                tickets.append(t)
                return t

        argv = ["--artifacts", art, "--controller", "pend", "--selftest",
                str(SD_SELFTEST), "--demand", mode,
                *(["--demand-dir", droot] if mode == "on" else []),
                *([] if dev.type == "cuda" else ["--backend", "cpu"])]
        ipm_leg.launches = locate.launches = fused.launches = 0
        out = io.StringIO()
        scheduler.RequestScheduler = Kept
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out):
                rc = serve_main(argv)
        finally:
            scheduler.RequestScheduler = real
        wall = time.perf_counter() - t0
        summ = json.loads(out.getvalue().strip().splitlines()[-1])
        results = [t.result(10.0)[0] for t in tickets]
        kern = (ipm_leg.launches, locate.launches, fused.launches)
        runs[mode] = (rc, summ, results, wall, kern)
        log(f"[demand] 19a main serve --selftest {SD_SELFTEST} --demand "
            f"{mode} on {dev}: exit {rc} in {wall:.1f} s, p50 "
            f"{summ['p50_us']} us, p99 {summ['p99_us']} us, fallback "
            f"{summ['fallback_served']}; hand-kernel launches (ipm_leg, "
            f"locate, arena_eval) {kern} -- ShardedDescent is plain torch")
    (rc_on, _s, on, wall_on, _k), (rc_off, _s2, off, _w, _k2) = \
        runs["on"], runs["off"]
    if rc_on or rc_off or len(on) != SD_SELFTEST or len(off) != SD_SELFTEST:
        fail(f"19a: exit {rc_on}/{rc_off}, {len(on)}/{len(off)} answers")
    diff = sum(not same_result(a, b) for a, b in zip(on, off))
    snap = load_demand(os.path.join(droot, "pend"))
    served = [r.leaf for r in on if r.inside]
    ids = snap.leaf_ids.tolist()
    hits = float(snap.leaf_hits.sum())
    rows = snap.meta["window"]["rows_total"]
    # The hits decay with a 300 s half-life from the hub's clock: over
    # this run they lose at most 0.5 ** (wall / 300) of the raw count.
    floor = len(served) * 0.5 ** (wall_on / 300.0)
    log(f"[demand] 19a: answers with --demand on bitwise those with it "
        f"off on {SD_SELFTEST - diff} of {SD_SELFTEST}; snapshot "
        f"{snap.meta['schema']} committed (npz sha256 "
        f"{snap.meta['npz_sha256'][:12]}...): rows {rows} = served "
        f"{len(served)}, decayed hits {hits:.3f} (>= {floor:.3f}), "
        f"{len(ids)} leaves observed = {len(set(served))} served leaves, "
        f"top-decile share {snap.top_decile_frac:.4f}")
    if diff:
        fail(f"19a: {diff} answers differ with --demand on")
    if rows != len(served) or not floor - 1e-6 <= hits <= len(served) \
            or sorted(ids) != sorted(set(served)):
        fail(f"19a: the snapshot counts {rows} rows / {hits} hits / "
             f"{len(ids)} leaves for {len(served)} served rows on "
             f"{len(set(served))} leaves")
    return {"served": len(served), "wall_s": wall_on}


def demand_arena(dev, res, table, tmp: str) -> dict:
    """19b: phase 8's arena (TENANTS tenants, CLIENTS closed-loop clients,
    SD_REQUESTS requests, a publish_delta half-way) with demand capture
    and SLO tracking on and off, in turns (SD_PAIRS pairs): every answer
    of the first run with capture on bitwise the first run without it
    wherever both were served by the same version, the torn-read audit
    of phase 8 (0 dropped, 0 torn), each tenant's sketch (exact: its
    clock frozen, SD_MAX_LEAVES above the tenant's leaves) equal to a
    bincount of its served leaves, and the tracker's fallback budget
    equal to the tenant's fallback count.  The first run with capture
    on writes the demand snapshots under `<tmp>/19b.demand`."""
    from explicit_hybrid_mpc_tpu_torch import obs as obs_lib
    from explicit_hybrid_mpc_tpu_torch.config import ServeConfig
    from explicit_hybrid_mpc_tpu_torch.obs.demand import DemandHub
    from explicit_hybrid_mpc_tpu_torch.obs.slo import slo_from_serve_config
    from explicit_hybrid_mpc_tpu_torch.online import fused
    from explicit_hybrid_mpc_tpu_torch.serve import (ArenaScheduler,
                                                     FallbackPolicy)

    ten = tenant_arenas(dev, res, table, os.path.join(tmp, "19b"))
    tenants, v1_dir, d2_dir = ten["tenants"], ten["v1_dir"], ten["d2_dir"]
    lb, ub, arena_v1 = ten["lb"], ten["ub"], ten["fresh"]
    n_u = res.tree.n_u

    names, th, out = serve_queries(tenants, lb, ub, SD_REQUESTS,
                                   np.random.default_rng(SEED + 23))
    scfg = ServeConfig(demand="on", slo="on",
                       demand_max_leaves=SD_MAX_LEAVES)
    droot = os.path.join(tmp, "19b.demand")
    order = [m for i in range(SD_PAIRS)
             for m in (("off", "on") if i % 2 == 0 else ("on", "off"))]
    runs: list = []
    for k, mode in enumerate(order):
        arena = arena_v1()
        path = os.path.join(tmp, f"19b.{k}.{mode}.obs.jsonl")
        o = obs_lib.Obs("jsonl", path=path)
        hub = tracker = None
        if mode == "on":
            hub = DemandHub(mode=scfg.demand, max_leaves=scfg.demand_max_leaves,
                            decay_halflife_s=scfg.demand_decay_s,
                            reservoir_k=scfg.demand_reservoir, obs=o,
                            clock=lambda: 0.0)
            tracker = slo_from_serve_config(scfg, obs=o)
        sched = ArenaScheduler(arena, max_batch=MAX_BATCH,
                               max_wait_us=MAX_WAIT_US,
                               fallback=FallbackPolicy(lb, ub, mode="clamp",
                                                       obs=o),
                               obs=o, demand=hub, slo=tracker)
        sw = {}

        def swap(arena=arena, sw=sw):
            arena.publish_delta("t0", "v2", d2_dir, v1_dir)
            sw["t_flip"] = time.perf_counter()

        fused.launches = 0
        results, lat, t_sub, wall = closed_loop(sched, names, th, CLIENTS,
                                                swap)
        n_k3 = fused.launches
        if tracker is not None:
            tracker.tick(o.flush_metrics())    # the last interval's fold
        if hub is not None and not any(r["mode"] == "on" for r in runs):
            for n in tenants:
                hub.snapshot(name=n, dir_path=os.path.join(droot, n))
        o.close()
        lat_us = lat * 1e6
        runs.append(dict(mode=mode, results=results, wall=wall, n_k3=n_k3,
                         batches=sched.n_batches, hub=hub, tracker=tracker,
                         path=path, p50=float(np.percentile(lat_us, 50)),
                         p99=float(np.percentile(lat_us, 99))))
        late = sum(1 for j in range(SD_REQUESTS) if names[j] == "t0"
                   and results[j].version == "v1" and t_sub[j] > sw["t_flip"])
        log(f"[demand] 19b run {k} capture {mode}: {SD_REQUESTS} requests "
            f"in {wall:.2f} s, p50 {runs[-1]['p50']:.1f} us, p99 "
            f"{runs[-1]['p99']:.1f} us, {sched.n_batches} batches, "
            f"arena_eval launches {n_k3}")
        if dev.type == "cuda" and n_k3 != sched.n_batches:
            fail(f"19b run {k}: {n_k3} arena_eval launches for "
                 f"{sched.n_batches} batches")
        if late:
            fail(f"19b run {k}: {late} requests after the swap served by v1")
    first = {m: next(r for r in runs if r["mode"] == m) for m in ("on", "off")}
    on, off = first["on"]["results"], first["off"]["results"]
    both = [j for j in range(SD_REQUESTS) if on[j].version == off[j].version]
    diff = sum(not same_result(on[j], off[j]) for j in both)
    # Torn-read audit (phase 8's): a reference arena with the same publish
    # history answers every in-box row of the capture run on its version.
    ref = arena_v1()

    def torn(rows):
        bad = 0
        for lo in range(0, len(rows), MAX_BATCH):
            chunk = rows[lo:lo + MAX_BATCH]
            r = ref.evaluate([names[j] for j in chunk], th[chunk])
            bad += sum(not (np.array_equal(on[j].u, r.u[i, :n_u]
                                           .astype(np.float64))
                            and on[j].cost == float(r.cost[i])
                            and on[j].leaf == int(r.leaf[i]))
                       for i, j in enumerate(chunk))
        return bad

    inbox = [j for j in range(SD_REQUESTS) if not out[j]]
    n_torn = torn([j for j in inbox if on[j].version == "v1"])
    ref.publish_delta("t0", "v2", d2_dir, v1_dir)
    n_torn += torn([j for j in inbox if on[j].version == "v2"])
    hub, tracker = first["on"]["hub"], first["on"]["tracker"]
    ev = tracker.evaluate()
    sketch_bad, budget_bad = [], []
    for n in tenants:
        leaves = [on[j].leaf for j in range(SD_REQUESTS)
                  if names[j] == n and on[j].inside]
        bc = np.bincount(leaves)
        ids, hits = hub.ctl(n).sketch.items()
        if hub.ctl(n).sketch.mode != "exact" or dict(zip(
                ids.tolist(), hits.tolist())) != {
                i: float(c) for i, c in enumerate(bc) if c}:
            sketch_bad.append(n)
        n_fb = sum(1 for j in range(SD_REQUESTS)
                   if names[j] == n and on[j].fallback is not None)
        row = ev.get(f"{n}.fallback")
        if row is None or row["bad"] != n_fb \
                or row["good"] + row["bad"] != names.count(n):
            budget_bad.append((n, row and (row["good"], row["bad"]), n_fb))
    ratio = {q: float(np.mean([r[q] for r in runs if r["mode"] == "on"])
                      / np.mean([r[q] for r in runs if r["mode"] == "off"]))
             for q in ("p50", "p99")}
    log(f"[demand] 19b: capture on vs off, {SD_PAIRS} pairs in turns "
        f"({', '.join(r['mode'] for r in runs)}): p50 ratio "
        f"{ratio['p50']:.3f}, p99 ratio {ratio['p99']:.3f} (on over off, "
        "means of each mode's runs; not held to a bound)")
    log(f"[demand] 19b: {len(both) - diff} of {len(both)} requests served "
        f"by the same version in both runs bitwise equal; torn reads "
        f"{n_torn} of {len(inbox)} audited in-box rows; sketches exact and "
        f"equal to the served leaves' bincount for "
        f"{TENANTS - len(sketch_bad)} of {TENANTS} tenants ("
        + ", ".join(f"{n} {hub.ctl(n).sketch.n_rows} rows on "
                    f"{len(hub.ctl(n).sketch.items()[0])} leaves"
                    for n in tenants)
        + f"); SLO specs {len(ev)} ({sorted(ev)[:3]}...), fallback budgets "
        + ", ".join(f"{n} {ev[f'{n}.fallback']['bad']:.0f} bad / "
                    f"{ev[f'{n}.fallback']['good']:.0f} good"
                    for n in tenants if f"{n}.fallback" in ev))
    if diff or n_torn:
        fail(f"19b: {diff} answers differ with capture on, {n_torn} torn")
    if len(both) < SD_REQUESTS // 2:
        fail(f"19b: only {len(both)} requests on the same version")
    if sketch_bad or budget_bad:
        fail(f"19b: sketches {sketch_bad} or fallback budgets {budget_bad} "
             "do not match the served rows")
    return {"droot": droot, "v1_dir": v1_dir, "tenant_arenas": ten,
            "streams": [r["path"] for r in runs if r["mode"] == "on"],
            "capture_launches": first["on"]["n_k3"], "ratio": ratio,
            "p50": {m: [r["p50"] for r in runs if r["mode"] == m]
                    for m in ("on", "off")},
            "p99": {m: [r["p99"] for r in runs if r["mode"] == m]
                    for m in ("on", "off")}}


def online_subopt(dev, problem, res, table, ten: dict) -> dict:
    """19c: the 19b traffic in the box (a clamped answer carries no
    certificate at its query) on v1 only (v2's doubled payloads are off
    any certificate), with demand_subopt_frac SD_SUBOPT_FRAC and
    demand_subopt_eps SD_SUBOPT_EPS; the hub re-solves its stride sample
    through its own Oracle on `dev` from its maintenance thread (K1 on
    the card) while the worker launches K3.  Fails on any demand.error
    event, no sample, or no K1 launch.  The hub's V* held to the plain
    (CPU) oracle's on the same points within 1e-9 relative; every
    sampled row on a certified leaf within eps + 1e-9; no health.subopt
    at eps; at eps half the measured p99 the hub's own event fires and a
    HealthMonitor's max_subopt rule fires on the gauges."""
    import contextlib

    import torch

    from explicit_hybrid_mpc_tpu_torch import obs as obs_lib
    from explicit_hybrid_mpc_tpu_torch.obs.demand import DemandHub
    from explicit_hybrid_mpc_tpu_torch.obs.health import HealthMonitor
    from explicit_hybrid_mpc_tpu_torch.online import fused
    from explicit_hybrid_mpc_tpu_torch.oracle import ipm_leg
    from explicit_hybrid_mpc_tpu_torch.oracle.oracle import Oracle
    from explicit_hybrid_mpc_tpu_torch.serve import (ArenaScheduler,
                                                     FallbackPolicy)

    on_card = dev.type == "cuda"
    tenants, lb, ub = ten["tenants"], ten["lb"], ten["ub"]
    names, th, out = serve_queries(tenants, lb, ub, SD_REQUESTS,
                                   np.random.default_rng(SEED + 23))
    keep = np.flatnonzero(~out)
    names, th = [names[j] for j in keep], th[keep]
    arena = ten["fresh"]()
    o = obs_lib.Obs("jsonl")
    ora = RecordingOracle(Oracle(problem, backend=dev.type))
    hub = DemandHub(mode="on", max_leaves=SD_MAX_LEAVES,
                    subopt_frac=SD_SUBOPT_FRAC, subopt_eps=SD_SUBOPT_EPS,
                    oracle=ora, obs=o)
    sched = ArenaScheduler(arena, max_batch=MAX_BATCH,
                           max_wait_us=MAX_WAIT_US,
                           fallback=FallbackPolicy(lb, ub, mode="clamp"),
                           obs=o, demand=hub)
    worker = sched._worker.ident
    ipm_leg.launches = fused.launches = 0
    prof = None
    ctx = contextlib.nullcontext()
    if on_card:
        from torch.profiler import ProfilerActivity, profile

        ctx = prof = profile(activities=[ProfilerActivity.CUDA])
    with ctx:
        results, lat, _ts, wall = closed_loop(sched, names, th, CLIENTS)
        n_thread_calls = len(ora.calls)
        hub.close(snapshot=False)      # the last drain, on this thread
        if on_card:
            torch.cuda.synchronize()
    n_k1, n_k3 = ipm_leg.launches, fused.launches
    k1_ms = k3_ms = None
    overlap = None
    if prof is not None:
        from torch.autograd import DeviceType

        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0]
        k1 = [e for e in rows if "ipm_leg" in e.key]
        k3 = [e for e in rows if "arena_eval" in e.key]
        k1_ms = sum(e.self_device_time_total for e in k1) / 1e3 if k1 else None
        k3_ms = sum(e.self_device_time_total for e in k3) / 1e3 if k3 else None
        # K1 (the hub's thread) and K3 (the worker) kernels that ran at
        # the same time on the card, from the trace's device intervals.
        spans: dict = {"k1": [], "k3": []}
        for e in prof.events():
            key = ("k1" if "ipm_leg" in e.name else
                   "k3" if "arena_eval" in e.name else None)
            tr = getattr(e, "time_range", None)
            if key and tr is not None and e.device_type == DeviceType.CUDA:
                spans[key].append((tr.start, tr.end))
        overlap = (sum(1 for a0, a1 in spans["k1"] for b0, b1 in spans["k3"]
                       if a0 < b1 and b0 < a1)
                   if spans["k1"] and spans["k3"] else None)
    errors = [r for r in o.sink.records if r.get("name") == "demand.error"]
    cnt = o.metrics.snapshot()["counters"]
    n_samples = sum(cnt.get(f"serve.ctl.{n}.subopt_samples", 0)
                    for n in tenants)
    threads = {c[3] for c in ora.calls[:n_thread_calls]}
    log(f"[subopt] 19c: {len(names)} in-box requests in {wall:.2f} s "
        f"(p99 {np.percentile(lat * 1e6, 99):.1f} us), {sched.n_batches} "
        f"batches, arena_eval launches {n_k3}; the hub's oracle "
        f"({dev.type}) re-solved {sum(len(c[0]) for c in ora.calls)} sampled "
        f"rows in {len(ora.calls)} calls ({n_thread_calls} from the hub's "
        f"thread {'(not the worker)' if worker not in threads else ''}, "
        f"the rest in close()); ipm_leg launches {n_k1}, device time "
        + (f"{k1_ms:.2f} ms" if k1_ms is not None else "not measured")
        + "; arena_eval device time "
        + (f"{k3_ms:.2f} ms" if k3_ms is not None else "not measured")
        + (f"; the arena's stream {arena._stream.cuda_stream} (0 = the "
           f"legacy default stream, which the hub's thread also uses), "
           f"K1/K3 kernel pairs overlapping in time {overlap}"
           if on_card else "")
        + f"; subopt_samples {n_samples}; demand.error events {len(errors)}")
    if errors:
        fail(f"19c: demand.error events: {[e.get('msg') for e in errors[:3]]}")
    if n_samples <= 0:
        fail("19c: the hub folded no suboptimality sample")
    if n_k1 <= 0:
        fail("19c: the hub's re-solves launched no K1")
    # V* against the plain oracle on the same points; the gaps by row.
    plain = Oracle(problem, backend="cpu")
    by_theta = {th[j].tobytes(): j for j in range(len(names))}
    gaps, cert_flags, inbox_v_err, n_dmis = [], [], 0.0, 0
    for pts, vstar, dstar, _tid in ora.calls:
        ref = plain.solve_vertices(pts)
        ok = (dstar >= 0) & np.isfinite(vstar) & (ref.dstar >= 0)
        rel = np.abs(vstar[ok] - ref.Vstar[ok]) \
            / np.maximum(1.0, np.abs(ref.Vstar[ok]))
        inbox_v_err = max(inbox_v_err, float(rel.max()) if rel.size else 0.0)
        n_dmis += int((dstar != ref.dstar).sum())
        for i in np.flatnonzero((dstar >= 0) & np.isfinite(vstar)):
            j = by_theta[pts[i].tobytes()]
            gaps.append(max(0.0, results[j].cost - float(vstar[i])))
            node = int(table.node_id[results[j].leaf])
            cert_flags.append(bool(res.tree.certified_flags(
                np.array([node]))[0]))
    gaps, cert_flags = np.asarray(gaps), np.asarray(cert_flags, dtype=bool)
    folded = np.sort(np.concatenate([np.asarray(hub.ctl(n).subopt._roll)
                                     for n in tenants]))
    p99 = float(np.percentile(folded, 99)) if folded.size else 0.0
    cert_max = float(gaps[cert_flags].max()) if cert_flags.any() else 0.0
    unc = gaps[~cert_flags]
    subopt_events = [r for r in o.sink.records
                     if r.get("name") == "health.subopt"]
    log(f"[subopt] 19c: V* of the hub ({dev.type}) against the plain CPU "
        f"oracle on the same {len(gaps)} rows: max relative difference "
        f"{inbox_v_err:.2e} (limit 1e-9), d* differing on {n_dmis}; the "
        f"folded gaps are the rows' served cost - V* "
        f"({'equal' if np.array_equal(folded, np.sort(gaps)) else 'NOT equal'}"
        f"); gaps p50 {np.percentile(gaps, 50):.3e}, p99 {p99:.3e}, max "
        f"on {int(cert_flags.sum())} certified rows {cert_max:.3e} (eps "
        f"{SD_SUBOPT_EPS:g}); {unc.size} rows on uncertified leaves, max "
        f"{(unc.max() if unc.size else 0.0):.3e}; health.subopt events at "
        f"eps {SD_SUBOPT_EPS:g}: {len(subopt_events)}")
    if not inbox_v_err <= 1e-9:
        fail(f"19c: the hub's V* differs from the plain oracle's by "
             f"{inbox_v_err:.2e}")
    if not np.array_equal(folded, np.sort(gaps)):
        fail("19c: the hub's folded gaps are not served cost - V*")
    if cert_max > SD_SUBOPT_EPS + 1e-9:
        fail(f"19c: a certified row is {cert_max:.3e} suboptimal "
             f"(> eps {SD_SUBOPT_EPS:g})")
    if subopt_events:
        fail(f"19c: health.subopt fired at eps {SD_SUBOPT_EPS:g}")
    if p99 <= 0:
        fail("19c: no positive gap to hold an alarm to")
    # At eps = p99 / 2 the hub's own event fires (the same rows and V*
    # replayed) and a HealthMonitor's max_subopt rule fires on the gauges.
    vmap = {pts[i].tobytes(): (float(v[i]), int(d[i]))
            for pts, v, d, _t in ora.calls for i in range(len(pts))}

    class Replay:
        def solve_vertices(self, pts):
            from types import SimpleNamespace

            vd = [vmap[p.tobytes()] for p in pts]
            return SimpleNamespace(Vstar=np.array([v for v, _d in vd]),
                                   dstar=np.array([d for _v, d in vd]))

    o2 = obs_lib.Obs("jsonl")
    low = p99 / 2
    hub2 = DemandHub(mode="on", subopt_frac=1.0, subopt_eps=low,
                     oracle=Replay(), obs=o2, clock=lambda: 0.0)
    sampled = [by_theta[b] for b in vmap]
    for n in tenants:
        js = [j for j in sampled if names[j] == n]
        if js:
            hub2.record(n, th[js], np.array([results[j].leaf for j in js]),
                        None, np.ones(len(js), dtype=bool),
                        np.array([results[j].cost for j in js]))
    hub2.close(snapshot=False)
    mon = HealthMonitor({"max_subopt": low})
    for r in list(o2.sink.records) + [o2.flush_metrics()]:
        mon.feed(r)
    fired = [e for e in o2.sink.records if e.get("name") == "health.subopt"]
    adopted = [e["name"] for e in mon.events]
    log(f"[subopt] 19c: at eps {low:.3e} (half the p99) the hub fires "
        f"health.subopt for {sorted({e['controller'] for e in fired})}; a "
        f"HealthMonitor(max_subopt={low:.3e}) fed that stream: "
        f"{len(adopted)} events ({sorted(set(adopted))}), worst {mon.worst}")
    if not fired or "health.subopt" not in adopted:
        fail("19c: health.subopt did not fire below the measured p99")
    return {"k1_launches": n_k1, "k1_ms": k1_ms, "k3_ms": k3_ms,
            "samples": n_samples, "p99": p99, "cert_max": cert_max,
            "overlap": overlap}


def demand_rebuild(dev, problem, cfg, res, tmp: str, v1_dir: str,
                   droot: str, refs: dict | None) -> dict:
    """19d: RebuildService with demand_dir = 19b's snapshot root and the
    lifecycle SLO tracker on, from phase 3's tree, controller t1: first
    at eps_a REBUILD_TIGHT_EPS (phase 15b's revision: an unchanged one
    invalidates only depth-capped cells that uniform traffic never
    reaches, so its hint would be empty), then back at the build's
    eps_a.  Its state starts as if it had published phase 3's tree as
    t1's artifact (19b's v1 directory, whose rows the snapshot counts),
    so the first generation maps the snapshot through that node_id
    table: lifecycle.demand_priority fires, the hint ranks invalidated
    leaves, the frontier's entry starts with the hinted ones in
    descending weight, and the regions stay within SD_REGION_TOL of
    phase 15b's unprioritized rebuild (`refs`: phase 15's regions and
    K1 counts; None: within 2% of REBUILD_TIGHT_REF_REGIONS).  The
    second generation's hint maps the snapshot through the first's
    artifact (best effort, as the service does).  Then the depth-capped
    DI case (capped_priority)."""
    import contextlib
    import threading

    import torch

    from explicit_hybrid_mpc_tpu_torch import obs as obs_lib
    from explicit_hybrid_mpc_tpu_torch.lifecycle import (LifecycleConfig,
                                                         RebuildService,
                                                         Revision,
                                                         RevisionSource)
    from explicit_hybrid_mpc_tpu_torch.obs.demand import (
        load_demand, priority_from_snapshot)
    from explicit_hybrid_mpc_tpu_torch.oracle import ipm_leg

    on_card = dev.type == "cuda"
    release = threading.Event()

    class TwoRevisions(RevisionSource):
        def __init__(self):
            self.stages = [(lambda: True, 1, REBUILD_TIGHT_EPS),
                           (release.is_set, 2, cfg.eps_a)]

        def poll(self):
            if self.stages and self.stages[0][0]():
                _ready, seq, eps = self.stages.pop(0)
                return [Revision(controller="t1", problem=cfg.problem,
                                 problem_args=cfg.problem_args,
                                 eps_a=eps, eps_r=cfg.eps_r, seq=seq,
                                 t_observed=time.perf_counter(),
                                 note=f"eps_a {eps:g}")]
            return []

    path = os.path.join(tmp, "19d.obs.jsonl")
    o = obs_lib.Obs("jsonl", path=path)
    lc = LifecycleConfig(artifacts_root=os.path.join(tmp, "19d.lc"),
                         demand_dir=droot, slo=True,
                         slo_dir=os.path.join(tmp, "19d.slo"))
    svc = RebuildService(TwoRevisions(), cfg, cfg=lc, obs=o,
                         prior={"t1": res})
    # The service's record of t1's last full artifact: phase 3's tree as
    # 19b served it (the delta base and the demand rows' node_id table).
    svc._ctl["t1"].prior_dir, svc._ctl["t1"].prior_version = v1_dir, "v1"
    real = ipm_leg.ipm_leg_cuda
    legs: list = []
    ipm_leg.ipm_leg_cuda = record_legs(real, legs)
    ipm_leg.launches = 0
    prof = None
    ctx = contextlib.nullcontext()
    if on_card:
        from torch.profiler import ProfilerActivity, profile

        ctx = prof = profile(activities=[ProfilerActivity.CUDA])
    t0 = time.perf_counter()
    try:
        with ctx:
            svc.start()
            ok1 = svc.wait_idle(timeout=600, target_generations=1)
            if on_card:
                torch.cuda.synchronize()
    finally:
        ipm_leg.ipm_leg_cuda = real
    wall1 = time.perf_counter() - t0
    n_k1 = ipm_leg.launches
    st1 = dict(svc._ctl["t1"].prior.stats)
    release.set()
    ok2 = svc.wait_idle(timeout=600, target_generations=2)
    svc.close()
    o.close()
    k1_ms = None
    if prof is not None:
        rows = [e for e in prof.key_averages()
                if "ipm_leg" in e.key and e.self_device_time_total]
        k1_ms = (sum(e.self_device_time_total for e in rows) / 1e3
                 if rows else None)
    lc_eval = hexed(svc.slo.evaluate()) if svc.slo is not None else {}
    gens = svc.generations
    if not (ok1 and ok2) or svc.n_failures or len(gens) != 2 \
            or svc.worker_error is not None:
        fail(f"19d: {len(gens)} generations, {svc.n_failures} failures, "
             f"worker error {svc.worker_error}")
    from explicit_hybrid_mpc_tpu_torch.obs import load_jsonl

    recs = load_jsonl(path)
    evs = [r for r in recs if r.get("name") == "lifecycle.demand_priority"]
    skipped = [r for r in recs
               if r.get("name") == "lifecycle.demand_priority_skipped"]
    pr = priority_from_snapshot(load_demand(os.path.join(droot, "t1")),
                                np.load(os.path.join(v1_dir, "node_id.npy")))
    order, hint = st1["rebuild_priority_order"], st1["rebuild_priority_hint"]
    k = min(len(order), hint)
    w = [pr.get(n, 0.0) for n in order]
    regions = st1["regions"]
    summ = svc.summary()
    tight = (refs or {}).get("tight", {})
    ref_regions = tight.get("regions", REBUILD_TIGHT_REF_REGIONS)
    tol = SD_REGION_TOL if refs else 0.02
    una = (refs or {}).get("unchanged", {})
    log(f"[demand] 19d RebuildService (demand_dir = 19b's snapshots, "
        f"lifecycle SLO on) from phase 3's tree, t1 at eps_a "
        f"{REBUILD_TIGHT_EPS:g}: generation 0 in {wall1:.1f} s, regions "
        f"{regions} (phase 15b unprioritized "
        f"{tight.get('regions', 'not run')}; reference {ref_regions} within "
        f"{tol:.1%}), reuse {st1['rebuild_reuse_frac']}, invalidated "
        f"{st1['rebuild_leaves_invalidated']}, hint {hint} of "
        f"{len(pr)} hot nodes; lifecycle.demand_priority events {len(evs)} "
        f"({[(e.get('seq'), e.get('hot_nodes'), e.get('hinted')) for e in evs]}"
        f"), skipped {len(skipped)}; frontier entry {order[:8]}... weights "
        f"{[round(x, 1) for x in w[:8]]}...; K1 {n_k1} launches ("
        f"{len(legs)} recorded), device time "
        + (f"{k1_ms:.2f} ms" if k1_ms is not None else "not measured")
        + f" (phase 15b: {tight.get('k1_launches', 'not run')} launches; "
        f"15a unchanged: {una.get('k1_launches', 'not run')} launches, "
        + (f"{una['k1_ms']:.2f} ms" if una.get("k1_ms") is not None
           else "not measured")
        + f"); generation 1 (eps_a {cfg.eps_a:g}): regions "
        f"{gens[1]['regions']}, reuse {gens[1]['reuse_frac']}, "
        f"published {gens[1]['published']}; lifecycle SLO "
        f"{ {n: (r['good'], r['bad']) for n, r in (summ['slo'] or {}).items()} }")
    if not evs or evs[0].get("seq") != 1 or hint <= 0:
        fail(f"19d: no demand priority on the first generation ({evs}, "
             f"hint {hint})")
    if any(x <= 0 for x in w[:k]) or w[:k] != sorted(w[:k], reverse=True) \
            or any(x > 0 for x in w[k:]):
        fail(f"19d: the frontier's entry is not the hinted nodes hottest "
             f"first: {list(zip(order, w))}")
    if abs(regions - ref_regions) > tol * ref_regions:
        fail(f"19d: regions {regions} not within {tol:.1%} of "
             f"{ref_regions}")
    if n_k1 <= 0 and on_card:
        fail("19d: the prioritized rebuild launched no K1")
    if refs and abs(n_k1 - tight.get("k1_launches", 0)) \
            > SD_K1_TOL * tight.get("k1_launches", 0):
        fail(f"19d: {n_k1} K1 launches, not within {SD_K1_TOL:.0%} of "
             f"phase 15b's {tight.get('k1_launches')}")
    if not summ["slo"] or "lifecycle.staleness" not in summ["slo"]:
        fail(f"19d: the lifecycle tracker reports {summ['slo']}")
    capped_priority(dev)
    return {"k1_launches": n_k1, "k1_ms": k1_ms, "regions": regions,
            "hint": hint, "slo_dir": lc.slo_dir, "sla_s": lc.sla_s,
            "slo_goal": lc.slo_goal, "slo_interval_s": lc.slo_interval_s,
            "lc_eval": lc_eval}


def capped_priority(dev) -> None:
    """19d's bit-identity case (the JAX package's depth-capped DI rebuild:
    N=3, theta_box 1.5, eps_a 0.3, max_depth 6, on `dev`): its
    invalidated leaves cannot split, so a hint that puts two of them
    first gives the unhinted tree node for node."""
    from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
    from explicit_hybrid_mpc_tpu_torch.online import export
    from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
        build_partition)
    from explicit_hybrid_mpc_tpu_torch.partition.rebuild import warm_rebuild
    from explicit_hybrid_mpc_tpu_torch.problems.registry import make

    args = (("N", 3), ("theta_box", 1.5))
    problem = make("double_integrator", **dict(args))
    cfg = PartitionConfig(problem="double_integrator", problem_args=args,
                          eps_a=0.3, backend=dev.type, batch_simplices=128,
                          max_depth=6)
    prior = build_partition(problem, cfg)
    ra = warm_rebuild(problem, cfg, prior)
    order = ra.stats["rebuild_priority_order"]
    hot = [order[-1], order[min(3, len(order) - 1)]]
    rb = warm_rebuild(problem, cfg, prior, priority={hot[0]: 100.0,
                                                     hot[1]: 40.0})
    sa, sb = ra.tree.__getstate__(), rb.tree.__getstate__()
    differ = [k for k in ("children", "parent", "depth", "leaf_flags",
                          "normal", "offset", "split_edge", "n",
                          "n_regions") if not np.array_equal(sa[k], sb[k])]
    ta, tb = export.export_leaves(ra.tree), export.export_leaves(rb.tree)
    differ += [f for f, a, b in zip(ta._fields, ta, tb)
               if not (np.array_equal(a, b) if isinstance(a, np.ndarray)
                       else a == b)]
    log(f"[demand] 19d depth-capped DI (max_depth 6) on {dev}: "
        f"{ra.stats['rebuild_leaves_invalidated']} leaves invalidated; "
        f"hinted entry {rb.stats['rebuild_priority_order'][:3]} (hot "
        f"{hot}); the hinted tree node for node the unhinted one: "
        f"{not differ}")
    if rb.stats["rebuild_priority_order"][:2] != hot or differ:
        fail(f"19d: the depth-capped hinted rebuild differs in {differ}")


_RELOAD = r"""
import json, sys
from explicit_hybrid_mpc_tpu_torch.obs.slo import SloTracker, lifecycle_slo_specs
out = []
for a in json.loads(sys.argv[1]):
    specs = lifecycle_slo_specs(*a["lifecycle"]) if a["lifecycle"] else ()
    tr = SloTracker(specs, interval_s=a["interval_s"], windows=a["windows"],
                    burn_thresholds=a["burns"], state_dir=a["dir"],
                    identity=a["identity"])
    out.append({n: {k: [x.hex() for x in v] if isinstance(v, list)
                    else v.hex() for k, v in row.items()}
                for n, row in tr.evaluate().items()})
print(json.dumps(out))
"""


def hexed(ev: dict) -> dict:
    """evaluate()'s floats as their exact hex spelling."""
    return {n: {k: [x.hex() for x in v] if isinstance(v, list) else v.hex()
                for k, v in row.items()} for n, row in ev.items()}


def reloaded(trackers: list) -> list:
    """One fresh interpreter's evaluate() (hexed) of each tracker state
    (state_dir, identity, interval_s, windows, burns, lifecycle_slo_specs
    arguments or None)."""
    arg = json.dumps([{"dir": d, "identity": i, "interval_s": iv,
                       "windows": [list(w) for w in ws], "burns": list(bs),
                       "lifecycle": lc}
                      for d, i, iv, ws, bs, lc in trackers])
    root = os.path.dirname(os.path.abspath(__file__))
    out = subprocess.run([sys.executable, "-c", _RELOAD, arg], cwd=root,
                         env={**os.environ, "PYTHONPATH": root},
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        fail(f"19e: the reload failed: {out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def slo_durability(tmp: str, streams: list, reb: dict) -> dict:
    """19e: a serving SloTracker (slo_from_serve_config's specs and
    identity, windows SD_WINDOWS on 1 s slots, an injected clock: one
    slot a snapshot) over 19b's first capture stream, and 19d's
    lifecycle tracker, each saved and reloaded in a fresh interpreter
    with evaluate() bitwise equal; fleet.slo_rollup over 19b's two
    capture streams equal to the exact sum of their slo.<spec>
    good/bad unit counters; a scripted sustained breach fires
    health.slo_burn once (critical, fast pair, adopted by a
    HealthMonitor) and a one-interval spike of the same size does not."""
    from explicit_hybrid_mpc_tpu_torch import obs as obs_lib
    from explicit_hybrid_mpc_tpu_torch.config import ServeConfig
    from explicit_hybrid_mpc_tpu_torch.obs import fleet, load_jsonl
    from explicit_hybrid_mpc_tpu_torch.obs.health import HealthMonitor
    from explicit_hybrid_mpc_tpu_torch.obs.slo import (
        DEFAULT_BURN_THRESHOLDS, DEFAULT_WINDOWS, SloSpec, SloTracker,
        slo_from_serve_config)

    t0 = time.perf_counter()
    sd = os.path.join(tmp, "19e.slo")
    base = slo_from_serve_config(ServeConfig(slo="on", slo_dir=sd))
    tr = SloTracker(interval_s=1.0, windows=SD_WINDOWS,
                    burn_thresholds=SD_BURNS, state_dir=sd,
                    identity=base.identity,
                    serve_template=base.serve_template, clock=lambda: 0.0)
    snaps = [r for r in load_jsonl(streams[0]) if r.get("kind") == "metrics"]
    for i, s in enumerate(snaps):
        tr.tick(s, now=float(i))
    tr.flush()
    serve_ev = tr.evaluate()
    # With the lifecycle tracker of 19d, saved on the service's close().
    lc_ev = reb["lc_eval"]
    got, lc_got = reloaded([
        (sd, base.identity, 1.0, SD_WINDOWS, SD_BURNS, None),
        (reb["slo_dir"], "lifecycle", reb["slo_interval_s"],
         DEFAULT_WINDOWS, DEFAULT_BURN_THRESHOLDS,
         [reb["sla_s"], reb["slo_goal"]])])
    serve_ok = got == hexed(serve_ev)
    lc_ok = lc_got == lc_ev
    # The fleet fold over the two capture streams.
    infos = fleet.load_fleet(streams)
    roll = fleet.slo_rollup(infos)
    summed: dict = {}
    for s in streams:
        last = [r for r in load_jsonl(s) if r.get("kind") == "metrics"][-1]
        for key, v in last["counters"].items():
            if key.startswith("slo.") and key.endswith("_units"):
                spec, field = key[4:].rsplit(".", 1)
                summed.setdefault(spec, {"good": 0, "bad": 0})[
                    field.split("_")[0]] += v
    folded = {n: {"good": r["good"], "bad": r["bad"]}
              for n, r in roll["specs"].items()}
    # Burn alerts, scripted: cumulative counters, one snapshot a slot.
    spec = SloSpec(name="scripted.avail", kind="counter", metric="bad",
                   total=("total",))

    def burns(ticks):
        o = obs_lib.Obs("jsonl")
        t = SloTracker([spec], interval_s=1.0, windows=SD_WINDOWS,
                       burn_thresholds=SD_BURNS, obs=o)
        for i, (bad, tot) in enumerate(ticks):
            t.tick({"counters": {"bad": float(bad), "total": float(tot)}},
                   now=float(i))
        mon = HealthMonitor()
        for r in o.sink.records:
            mon.feed(r)
        return [r for r in o.sink.records
                if r.get("name") == "health.slo_burn"
                and r.get("window") == "fast"], mon

    sustained, mon = burns([(30 * i, 100 * i) for i in range(131)])
    spike, _m = burns([(0, 100 * i) for i in range(61)] + [(30, 6100)]
                      + [(30, 100 * i) for i in range(62, 70)])
    log(f"[slo] 19e: a serving tracker over 19b's stream ({len(snaps)} "
        f"snapshots, {len(serve_ev)} specs) reloaded in a fresh interpreter: "
        f"evaluate() bitwise {serve_ok}; the lifecycle tracker of 19d "
        f"({len(lc_ev)} specs): bitwise {lc_ok}; fleet.slo_rollup over "
        f"{len(streams)} streams: {len(folded)} specs, the exact sum of "
        f"their unit counters {folded == summed}; scripted sustained "
        f"breach: {len(sustained)} fast health.slo_burn "
        f"({[e['severity'] for e in sustained]}), the monitor's worst "
        f"{mon.worst}; one-interval spike: {len(spike)}; "
        f"{time.perf_counter() - t0:.1f} s")
    if not (serve_ok and lc_ok) or not serve_ev or not lc_ev:
        fail("19e: a reloaded budget is not bitwise the saved one")
    if folded != summed or not folded:
        fail(f"19e: the rollup {folded} is not the sum {summed}")
    if len(sustained) != 1 or sustained[0]["severity"] != "critical" \
            or mon.worst != "critical" or spike:
        fail(f"19e: burn alerts: sustained {len(sustained)}, spike "
             f"{len(spike)}, monitor {mon.worst}")
    return {"serve_specs": len(serve_ev), "lifecycle_specs": len(lc_ev)}


def slo_demand_phase(dev, problem, cfg, res, table, tmp: str,
                     refs: dict | None) -> dict:
    """Phase 19: the SLO engine and demand telemetry on the card (19a-19e
    above).  `refs`: phase 15's rebuilds (demand_rebuild).  Returns the
    kernels line's additions."""
    from explicit_hybrid_mpc_tpu_torch.post import partition_report

    t0 = time.perf_counter()
    # post/ on the card's machine (no matplotlib there: post/__init__
    # reaches only post/analysis.py).
    rep = partition_report(res.tree, res.roots)
    log(f"[post] partition_report of phase 3's tree: regions "
        f"{rep['n_regions']}, certified volume "
        f"{rep['volume_certified_frac']:.6f}, best effort "
        f"{rep['n_best_effort']}, depth {rep['depth_min']}-"
        f"{rep['depth_max']}, {time.perf_counter() - t0:.1f} s")
    if rep["n_regions"] != res.stats["regions"]:
        fail(f"post: {rep['n_regions']} regions, the build "
             f"{res.stats['regions']}")
    demand_serve(dev, res, tmp)
    arena = demand_arena(dev, res, table, tmp)
    sub = online_subopt(dev, problem, res, table, arena["tenant_arenas"])
    reb = demand_rebuild(dev, problem, cfg, res, tmp, arena["v1_dir"],
                         arena["droot"], refs)
    slo_durability(tmp, arena["streams"], reb)
    log(f"[demand] phase 19 took {time.perf_counter() - t0:.1f} s")
    return {"ipm_leg": {"subopt_launches": sub["k1_launches"],
                        "subopt_ms": sub["k1_ms"],
                        "demand_rebuild_launches": reb["k1_launches"],
                        "demand_rebuild_ms": reb["k1_ms"]},
            "arena_eval": {"capture_launches": arena["capture_launches"],
                           "capture_p99_ratio": arena["ratio"]["p99"]}}


def slo_demand_only() -> int:
    """Phase 19 alone, for iterating on the card: the kernels built, a
    flagship build standing in for phase 3's, then 19a-19e (19d held to
    REBUILD_TIGHT_REF_REGIONS, phase 15 not having run).

        python3 -c "import sys, chip_smoke as c; sys.exit(c.slo_demand_only())"
    """
    import torch

    from explicit_hybrid_mpc_tpu_torch import kernels
    from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
    from explicit_hybrid_mpc_tpu_torch.online import export
    from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
        build_partition)
    from explicit_hybrid_mpc_tpu_torch.problems.registry import make

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    kernels.build()
    log(f"[build] kernels in {time.perf_counter() - t0:.1f} s")
    problem = make("inverted_pendulum")
    cfg = PartitionConfig(problem="inverted_pendulum", eps_a=1e-2)
    res = build_partition(problem, cfg)
    torch.cuda.synchronize()
    log(f"[main] build: regions {res.stats['regions']}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_slo_") as tmp:
        out = slo_demand_phase(dev, problem, cfg, res,
                               export.export_leaves(res.tree), tmp, None)
    log(json.dumps(out))
    return 0


# -- phase 20: multi-GPU (the solve mesh, the sharded frontier, the lockstep
# multi-process build) --------------------------------------------------------

#: Phase 20.  20a: the mesh shapes MeshSolver is held to the dense grid at
#: (the JAX tests' tolerance), on MESH_THETAS seeded flagship points, timed
#: in turns MESH_REPS times.  20b: the shards of each sharded build (one
#: card: they time-slice it) and the launcher's time limit.  20c: the ranks
#: of the lockstep build, and its time limit.  The tier-1 DI fixture (20b's
#: first build, 20c's) is the JAX package's tests/_mp_worker.py build.
MESH_SHAPES = ((1, 1), (2, 1), (1, 2), (2, 2))
MESH_THETAS = 1024
MESH_REPS = 5
MESH_TOL = 1e-9
SHARDS = 2
SHARD_TIMEOUT_S = 600.0
LOCKSTEP_RANKS = 2
DI_PROBLEM = ("double_integrator", (("N", 3), ("theta_box", 1.5)))
DI_CFG = dict(eps_a=0.5, batch_simplices=32, max_depth=20)
LOCKSTEP_TIMEOUT_S = 300.0

_COUNTED_MAIN = ("import sys, chip_smoke; "
                 "sys.exit(chip_smoke.counted_main(sys.argv[1:]))")
_LOCKSTEP = ("import sys, chip_smoke; "
             "sys.exit(chip_smoke.lockstep_worker())")


def _root() -> str:
    return os.path.dirname(os.path.abspath(__file__))


def mesh_devices_for(dev, k: int) -> tuple[list, str]:
    """k mesh entries on `dev`'s kind: distinct cards round-robin where
    the machine has two or more, else `dev` repeated (named in the
    second value)."""
    import torch

    n = torch.cuda.device_count() if dev.type == "cuda" else 0
    if n >= 2:
        return ([torch.device("cuda", i % n) for i in range(k)],
                f"{min(n, k)} distinct cards")
    return [dev] * k, f"{dev} repeated"


def _sync_all(devs) -> None:
    import torch

    for d in {str(d) for d in devs}:
        if d.startswith("cuda"):
            torch.cuda.synchronize(torch.device(d))


def wall_ms(fn, devs, reps: int) -> float:
    """Median host wall of `fn` over `reps` calls, each synchronized on
    every device in `devs` (blocks on distinct cards are timed whole)."""
    fn()
    _sync_all(devs)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        _sync_all(devs)
        ts.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(ts))


def _bits(t):
    """`t` with its floats viewed as same-width integers: equal iff
    bitwise equal (NaN payloads and signed zeros included)."""
    import torch

    if not t.is_floating_point():
        return t
    return t.contiguous().view({8: torch.int64, 4: torch.int32,
                                2: torch.int16}[t.element_size()])


def _same_rows(full, half):
    """Whether `half` is bitwise `full` (or `full`'s first rows, where
    `full` has twice `half`'s leading dimension); None where the two
    cannot be lined up."""
    import torch

    if tuple(full.shape) != tuple(half.shape):
        if not (full.dim() and half.dim()
                and full.shape[1:] == half.shape[1:]
                and full.shape[0] == 2 * half.shape[0]):
            return None
        full = full[:half.shape[0]]
    return full.dtype == half.dtype and torch.equal(_bits(full), _bits(half))


def batch_split_probe(ora, th) -> dict:
    """Where 20a's block shapes part from the dense grid: the grid
    program on the first half of the points against the same program on
    all of them, op by op.

    A TorchDispatchMode records every aten op's tensor inputs and outputs
    of the half run, then holds the full run's ops to them row for row
    (the full run's first half of each batch axis); uninitialized
    allocations are not compared.  The first op whose inputs all agree
    bitwise while an output does not is the batch-size-dependent one.  An
    op that reads a differing input no earlier op produced reads what the
    K1 leg wrote through its ctypes launch (outside aten).  Besides, every
    K1 leg of the full run is relaunched on its inputs' first half and
    held bitwise to its own outputs' first half: K1's batch independence
    at the inputs 20a gives it."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    from explicit_hybrid_mpc_tpu_torch.oracle import ipm_leg, oracle

    uninit = ("empty", "empty_like", "new_empty", "empty_strided")

    def tensors(x):
        return [t for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor)]

    class Tape(TorchDispatchMode):
        def __init__(self, ref=None):
            super().__init__()
            self.ref, self.ops, self.i = ref, [], 0
            self.first_read = self.first_op = self.misaligned = None
            self.n_differ = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ins = [t.clone() for t in tensors((args, kwargs))]
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            outs = ([] if name in uninit
                    else [t.clone() for t in tensors(out)])
            if self.ref is None:
                self.ops.append((str(func), ins, outs))
                return out
            i, self.i = self.i, self.i + 1
            if self.misaligned is not None:
                return out
            if i >= len(self.ref) or self.ref[i][0] != str(func):
                self.misaligned = (i, str(func))
                return out
            _, rins, routs = self.ref[i]
            same_in = [_same_rows(a, b) for a, b in zip(ins, rins)]
            same_out = [_same_rows(a, b) for a, b in zip(outs, routs)]
            differs = False in same_out
            self.n_differ += differs
            if self.first_read is None and False in same_in:
                self.first_read = (i, str(func))
            if self.first_op is None and differs and False not in same_in:
                self.first_op = (i, str(func), [tuple(t.shape) for t in ins],
                                 [str(t.dtype) for t in ins])
            return out

    h = th.shape[0] // 2
    legs = []
    real = ipm_leg.ipm_leg

    def leg(*a, n_iter):
        res = real(*a, n_iter=n_iter)
        legs.append((a, res, n_iter))
        return res

    def run(x):
        return oracle._solve_points_grid(ora.prob, x, ora.point_n_iter,
                                         ora.point_n_f32)[:8]

    th_half = th[:h]
    with Tape() as rec:
        half = run(th_half)
    with Tape(rec.ops) as cmp:
        ipm_leg.ipm_leg = leg
        try:
            full = run(th)
        finally:
            ipm_leg.ipm_leg = real
    conv = full[1][:h]
    diff = {n: float((a[:h] - b)[conv].abs().max()) if conv.any() else 0.0
            for n, a, b in zip(("V", "grad", "u0", "z"),
                               (full[0], full[3], full[4], full[5]),
                               (half[0], half[3], half[4], half[5]))}
    k1_same = []
    for a, res, n_iter in legs:
        k = a[0].shape[0] // 2
        again = real(*(t[:k].contiguous() for t in a), n_iter=n_iter)
        k1_same.append(all(_same_rows(x, y) for x, y in zip(res, again)))
    return {"n_ops": len(rec.ops), "ops_differing": cmp.n_differ,
            "first_op": cmp.first_op, "first_read": cmp.first_read,
            "misaligned": cmp.misaligned, "converged_diff": diff,
            "k1_legs": len(legs), "k1_bitwise": k1_same}


def mesh_solve_phase(dev, problem) -> dict:
    """20a: MeshSolver on each of MESH_SHAPES against the dense grid
    program of an Oracle on `dev` (two-phase and warm starts off, as
    under a mesh) on MESH_THETAS seeded points: d*, conv and feas equal,
    V, grad, u0, z on the converged cells and V* where finite to
    MESH_TOL (relative and absolute), V's differences on the others
    counted; first batch_split_probe, which names the op that makes the
    floats follow the block shape and fails the phase where K1 does;
    K1's launches a call counted from zero (a multiple of the block
    count, each block on the card launching); each shape timed in
    turns with the dense call (dense, mesh, mesh, dense).  Then
    Oracle(mesh=) on the largest shape against the dense Oracle's
    decisions.  Returns the kernels line's mesh counts."""
    import math

    import torch

    from explicit_hybrid_mpc_tpu_torch.oracle import ipm_leg, oracle
    from explicit_hybrid_mpc_tpu_torch.parallel import MeshSolver, make_mesh

    on_card = dev.type == "cuda"
    t_phase = time.perf_counter()
    ora = oracle.Oracle(problem, backend=dev.type, two_phase=False,
                        warm_start=False)
    rng = np.random.default_rng(SEED + 20)
    th = rng.uniform(problem.theta_lb, problem.theta_ub,
                     (MESH_THETAS, problem.n_theta))
    th_dev = torch.as_tensor(th, device=dev)

    def dense():
        return oracle._solve_points_grid(ora.prob, th_dev, ora.point_n_iter,
                                         ora.point_n_f32)[:8]

    ref = [t.cpu().numpy() for t in dense()]
    names = ("V", "conv", "feas", "grad", "u0", "z", "Vstar", "dstar")
    pr = batch_split_probe(ora, th_dev)
    first = pr["first_op"]
    log(f"[mesh] 20a batch split: the dense grid on the first "
        f"{MESH_THETAS // 2} points against all {MESH_THETAS}, op by op "
        f"({pr['n_ops']} aten ops recorded, {pr['ops_differing']} with an "
        "output that differs): first op whose inputs agree bitwise and "
        "output does not: " + (
            f"#{first[0]} {first[1]} on {first[2]} {first[3]}" if first
            else "none")
        + "; first op reading a differing input: " + (
            f"#{pr['first_read'][0]} {pr['first_read'][1]}"
            if pr["first_read"] else "none")
        + ("" if pr["misaligned"] is None else
           f"; the op sequences part at #{pr['misaligned'][0]}")
        + f"; K1 relaunched on the first half of each of its "
        f"{pr['k1_legs']} legs' inputs: bitwise {pr['k1_bitwise']}; max "
        f"|diff| on the converged cells " + ", ".join(
            f"{n} {e:.1e}" for n, e in pr["converged_diff"].items()))
    if on_card and not (pr["k1_legs"] and all(pr["k1_bitwise"])):
        fail("20a: K1's result on a QP depends on the rest of its batch")
    launches, times = {}, {}
    for shape in MESH_SHAPES:
        k = math.prod(shape)
        devs, which = mesh_devices_for(dev, k)
        ms = MeshSolver(ora.prob, make_mesh(shape, devs), ora.point_n_iter,
                        ora.point_n_f32)
        ipm_leg.launches = 0
        got = [t.cpu().numpy() for t in ms(th)]
        n_k1 = ipm_leg.launches
        errs = {}
        for name, a, b in zip(names, ref, got):
            if a.shape != b.shape:
                fail(f"20a {shape}: {name} shape {b.shape}, dense {a.shape}")
            if a.dtype == bool or np.issubdtype(a.dtype, np.integer):
                if not np.array_equal(a, b):
                    fail(f"20a {shape}: {name} differs from the dense grid "
                         f"on {int((a != b).sum())} cells")
                continue
            # A cell's floats on the cells that converged (conv is equal
            # by now).  On the card qp_solve's batched matvecs round by
            # the batch's size (batch_split_probe names the first; K1 is
            # held batch independent there), and an unconverged cell's
            # iterates amplify those last bits; the oracle discards them.
            fin = np.isfinite(a) if name == "Vstar" else ref[1]
            if name == "Vstar" and not np.array_equal(fin, np.isfinite(b)):
                fail(f"20a {shape}: V*'s finite points differ")
            d = np.abs(a[fin] - b[fin])
            errs[name] = float(d.max()) if d.size else 0.0
            if name == "V":
                with np.errstate(invalid="ignore"):
                    loose = ~ref[1] & ~((a == b) | (np.isnan(a)
                                                    & np.isnan(b)))
                n_loose = int(loose.sum())
            if not np.all(d <= MESH_TOL + MESH_TOL * np.abs(a[fin])):
                fail(f"20a {shape}: {name} differs from the dense grid by "
                     f"{errs[name]:.2e} (rtol = atol = {MESH_TOL:g})")
        if n_k1 % k or (on_card and n_k1 <= 0):
            fail(f"20a {shape}: {n_k1} K1 launches for {k} blocks")
        d1 = wall_ms(dense, [dev], MESH_REPS)
        m1 = wall_ms(lambda: ms(th), devs, MESH_REPS)
        m2 = wall_ms(lambda: ms(th), devs, MESH_REPS)
        d2 = wall_ms(dense, [dev], MESH_REPS)
        launches[f"{shape[0]}x{shape[1]}"] = n_k1
        times[f"{shape[0]}x{shape[1]}"] = ((m1 + m2) / 2, (d1 + d2) / 2)
        log(f"[mesh] 20a {shape} on {which}: {MESH_THETAS} points x "
            f"{problem.canonical.n_delta} commutations; d*, conv, feas "
            f"equal; max |diff| on the {int(ref[1].sum())} converged "
            f"cells (V* where finite) " + ", ".join(f"{n} {e:.1e}"
                                               for n, e in errs.items())
            + f"; V differs on {n_loose} of the "
            f"{int((~ref[1]).sum())} unconverged cells (not compared: "
            "the oracle discards them)"
            + f"; K1 {n_k1} launches a call ({n_k1 // k} a block); "
            f"{(m1 + m2) / 2:.3f} ms a call ({m1:.3f}/{m2:.3f}) against "
            f"the dense call's {(d1 + d2) / 2:.3f} ms ({d1:.3f}/{d2:.3f})")
    shape = MESH_SHAPES[-1]
    devs, which = mesh_devices_for(dev, math.prod(shape))
    mo = oracle.Oracle(problem, backend=dev.type,
                       mesh=make_mesh(shape, devs))
    a, b = ora.solve_vertices(th), mo.solve_vertices(th)
    same = (np.array_equal(a.dstar, b.dstar)
            and np.array_equal(a.conv, b.conv)
            and np.allclose(a.Vstar, b.Vstar, rtol=MESH_TOL, atol=MESH_TOL))
    log(f"[mesh] 20a Oracle(mesh={shape} on {which}).solve_vertices: d*, "
        f"conv and V* {'equal to' if same else 'DIFFERENT from'} the dense "
        f"Oracle's; two_phase {mo.two_phase}, warm_start {mo.warm_start}")
    if not same or mo.two_phase or mo.warm_start:
        fail("20a: the mesh oracle's decisions differ from the dense one's")
    log(f"[mesh] (20a took {time.perf_counter() - t_phase:.1f} s)")
    return {"mesh_launches": launches,
            "mesh_ms": {s: round(t[0], 4) for s, t in times.items()},
            "mesh_dense_ms": {s: round(t[1], 4) for s, t in times.items()}}


class CellRecorder:
    """Notes every (point, commutation) cell the oracle's point solves
    finished -- the cells oracle.point_solves counts: each grid row's
    commutations and each pair -- as 8-byte hashes of the point's
    float64 bytes and the commutation, by wrapping Oracle.wait_vertices
    and the pair path's wait on the class; restored on exit."""

    def __init__(self):
        self.cells: list = []

    def _note(self, thetas, ds) -> None:
        import hashlib

        th = np.ascontiguousarray(thetas, dtype=np.float64)
        for row, d in zip(th, np.asarray(ds, dtype=np.int64)):
            self.cells.append(int.from_bytes(hashlib.blake2b(
                row.tobytes() + d.tobytes(), digest_size=8).digest(),
                "little"))

    def __enter__(self):
        from explicit_hybrid_mpc_tpu_torch.oracle.oracle import Oracle

        self._real = (Oracle.wait_vertices, Oracle._wait_pairs_all)
        wv, wp = self._real
        rec = self

        def wait_vertices(o, handle):
            sol = wv(o, handle)
            if handle[0] == "chunks":
                nd = o.can.n_delta
                rec._note(np.repeat(handle[1], nd, axis=0),
                          np.tile(np.arange(nd), handle[1].shape[0]))
            return sol

        def wait_pairs(o, handle):
            out = wp(o, handle)
            if handle[0] in ("chunks", "ws_chunks"):
                rec._note(handle[1], handle[2])
            return out

        Oracle.wait_vertices, Oracle._wait_pairs_all = (wait_vertices,
                                                        wait_pairs)
        return self

    def __exit__(self, *exc):
        from explicit_hybrid_mpc_tpu_torch.oracle.oracle import Oracle

        Oracle.wait_vertices, Oracle._wait_pairs_all = self._real
        return False


class K1Tally:
    """While active, every IPM leg tallied by route ('cuda': the kernel,
    counted where ipm_leg's own count moves; 'plain': its plain
    version), K1 path and dtype, each CUDA launch bracketed by a pair of
    CUDA events on its stream.  Restores the legs on exit."""

    def __init__(self):
        self.rows: dict = {}

    def __enter__(self):
        from explicit_hybrid_mpc_tpu_torch.oracle import ipm_leg

        self._real = (ipm_leg.ipm_leg_cuda, ipm_leg.ipm_leg_torch)
        ipm_leg.ipm_leg_cuda = self._wrap(self._real[0], "cuda")
        ipm_leg.ipm_leg_torch = self._wrap(self._real[1], "plain")
        return self

    def __exit__(self, *exc):
        from explicit_hybrid_mpc_tpu_torch.oracle import ipm_leg

        ipm_leg.ipm_leg_cuda, ipm_leg.ipm_leg_torch = self._real
        return False

    def _wrap(self, real, route: str):
        import torch

        from explicit_hybrid_mpc_tpu_torch.oracle import ipm_leg

        def leg(Q, q, A, b, z, s, lam, n_iter):
            n0 = ipm_leg.launches
            ev = None
            if Q.is_cuda:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
            out = real(Q, q, A, b, z, s, lam, n_iter)
            went = (ipm_leg.launches > n0 if route == "cuda"
                    else q.shape[0] > 0 and n_iter > 0)
            if went:
                key = (route, k1_path(q.shape[1], b.shape[1]),
                       str(Q.dtype).replace("torch.", ""))
                row = self.rows.setdefault(key, [0, []])
                row[0] += 1
                if ev is not None:
                    ev[1].record()
                    row[1].append(ev)
            return out
        return leg

    def summary(self, timed: bool = True) -> dict:
        """{"route:path:dtype": {"launches", "ms"}}: ms is the launches'
        summed event spans (synchronizes), None without events or when
        not `timed`."""
        import torch

        if timed and any(r[1] for r in self.rows.values()):
            torch.cuda.synchronize()
        return {":".join(k): {"launches": n, "ms": (
            sum(a.elapsed_time(b) for a, b in evs) if evs and timed
            else None)} for k, (n, evs) in sorted(self.rows.items())}


#: The environment variable naming the JSON-lines file a counted child
#: (counted_main, counted_cli, counted_tool) appends its K1 record to.
K1_LOG_ENV = "K1_LOG"


def counted(run, argv: list, record: dict, cells: str | None = None) -> int:
    """`run(argv)` in this process with ipm_leg's count from zero and K1
    tallied (K1Tally) over the whole run and over each build_partition
    call.  Appends one JSON line to the file K1_LOG names when the
    process ends: by returning, by SIGTERM (exit 143 here), or by a fault
    plan's crash (os._exit, wrapped to write the line first; only SIGKILL
    leaves none).  SIGUSR1 appends a line marked partial (launches only,
    untimed) and the run goes on, so that a process about to be SIGKILLed
    can leave its count.  The line holds `record`'s keys, "pid", "rank",
    "rc", "partial", "wall_s", "k1" (ipm_leg's count), "k1_by"
    ({"route:path:dtype": {"launches", "ms"}}), "k1_ms" (the kernel's
    summed event spans; None off the card and when partial), "k2"
    (locate's count, from zero), "k3" (arena_eval's, from zero) and
    "builds" (regions, truncated, wall_s
    and k1_by of each call of frontier.build_partition through the
    module: the tools' builds).
    With `cells`, the point-solve cells (CellRecorder) also go to
    <cells>.cells.p<RANK>.npy."""
    import contextlib
    import signal

    from explicit_hybrid_mpc_tpu_torch.online import fused, locate
    from explicit_hybrid_mpc_tpu_torch.oracle import ipm_leg
    from explicit_hybrid_mpc_tpu_torch.partition import frontier

    tally = K1Tally()
    builds: list = []
    real_build, real_exit = frontier.build_partition, os._exit
    rank = os.environ.get("RANK", "0")
    t0 = time.perf_counter()

    def build_partition(*a, **kw):
        with K1Tally() as t:
            res = real_build(*a, **kw)
        builds.append({"regions": res.stats.get("regions"),
                       "truncated": res.stats.get("truncated"),
                       "wall_s": res.stats.get("wall_s"),
                       "k1_by": t.summary()})
        return res

    def note(rc, partial: bool = False) -> None:
        by = tally.summary(not partial)
        ms = [v["ms"] for k, v in by.items() if k.startswith("cuda:")]
        with open(os.environ[K1_LOG_ENV], "a") as f:
            f.write(json.dumps({
                **record, "pid": os.getpid(), "rank": int(rank), "rc": rc,
                "partial": partial, "wall_s": time.perf_counter() - t0,
                "k1": ipm_leg.launches, "k1_by": by,
                "k1_ms": (sum(ms) if ms and None not in ms else None),
                "k2": locate.launches, "k3": fused.launches,
                "builds": builds}) + "\n")

    def crash(code: int) -> None:
        note(code)
        real_exit(code)

    frontier.build_partition = build_partition
    os._exit = crash
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    signal.signal(signal.SIGUSR1, lambda *_: note(None, True))
    ipm_leg.launches = locate.launches = fused.launches = 0
    rec = CellRecorder() if cells else contextlib.nullcontext()
    rc = None
    try:
        with tally, rec:
            rc = run(argv)
        return rc
    except SystemExit as e:
        rc = e.code
        raise
    finally:
        frontier.build_partition, os._exit = real_build, real_exit
        if cells:
            np.save(f"{cells}.cells.p{rank}.npy",
                    np.asarray(rec.cells, dtype=np.uint64))
        note(rc)


def counted_main(argv: list) -> int:
    """`main(argv)` through `counted`, the point-solve cells recorded
    beside its output (-o): each shard of 20b's sharded builds, a process
    of the launcher, and each attempt of 22b's supervised build."""
    from explicit_hybrid_mpc_tpu_torch import main as tmain

    return counted(tmain.main, argv, {"argv": argv},
                   cells=argv[argv.index("-o") + 1])


def counted_cli(argv: list) -> int:
    """`main.cli(argv)` through `counted`: the children of the chaos
    suite (22a), of the fleet smoke (23a) and of 23b's watched builds."""
    from explicit_hybrid_mpc_tpu_torch import main as tmain

    return counted(tmain.cli, argv, {"argv": argv})


def counted_tool(argv: list) -> int:
    """`python -m explicit_hybrid_mpc_tpu_torch.tools.<argv[0]>
    argv[1:]` through `counted`: phase 24's children."""
    import importlib

    tool = importlib.import_module(
        f"explicit_hybrid_mpc_tpu_torch.tools.{argv[0]}")
    return counted(tool.main, argv[1:], {"tool": argv[0], "argv": argv[1:]})


def k1_records(path: str, **match) -> list:
    """The K1 records (`counted`) in the file at `path`, in order: those
    whose keys equal `match`'s, every one without."""
    if not os.path.exists(path):
        return []
    with open(path) as f:
        recs = [json.loads(ln) for ln in f]
    return [r for r in recs if all(r.get(k) == v for k, v in match.items())]


def _output_of(argv: list) -> str:
    """The output prefix (-o) of a main argv."""
    return argv[argv.index("-o") + 1]


class k1_log_env:
    """K1_LOG set to `path` in this process's environment while active,
    so that every counted child started meanwhile appends there."""

    def __init__(self, path: str):
        self.path = path

    def __enter__(self):
        os.environ[K1_LOG_ENV] = self.path
        return self.path

    def __exit__(self, *exc):
        os.environ.pop(K1_LOG_ENV, None)
        return False


def sharded_run(dev, cfg, tmp: str, name: str) -> dict:
    """The launcher's SHARDS processes of `main --shard-frontier --obs
    jsonl` with `cfg`'s build flags, every shard on `dev` through
    counted_main: its stats, merged tree, per-shard K1 records and
    point-solve cells, the streams' rollup and straggler report, and
    the cells two shards both solved."""
    from explicit_hybrid_mpc_tpu_torch.obs import fleet
    from explicit_hybrid_mpc_tpu_torch.parallel.launch import launch_sharded
    from explicit_hybrid_mpc_tpu_torch.partition.tree import Tree

    out = os.path.join(tmp, name)
    argv = ["-e", cfg.problem, "-a", repr(cfg.eps_a), "--batch",
            str(cfg.batch_simplices), "--max-depth", str(cfg.max_depth),
            "--obs", "jsonl", "-o", out,
            *([] if dev.type == "cuda" else ["--backend", "cpu"]),
            *([] if cfg.warm_start_tree else ["--no-warm-start"])]
    for k, v in cfg.problem_args:
        argv += ["--problem-arg", f"{k}={json.dumps(v)}"]
    with k1_log_env(out + ".k1.jsonl") as k1_log:
        r = launch_sharded(argv, n_processes=SHARDS,
                           timeout_s=SHARD_TIMEOUT_S,
                           entry=[sys.executable, "-c", _COUNTED_MAIN],
                           cwd=_root())
    if r["rc"] != 0 or r["hung"]:
        fail(f"20b {name}: the sharded build exited {r['rcs']} (hung "
             f"{r['hung']}): {r['stderr']}")
    with open(out + ".stats.json") as f:
        st = json.load(f)
    shards = sorted(k1_records(k1_log, partial=False),
                    key=lambda x: x["rank"])
    if [x["rank"] for x in shards] != list(range(SHARDS)):
        fail(f"20b {name}: K1 records of ranks "
             f"{[x['rank'] for x in shards]}, expected {SHARDS}")
    cells = [np.load(f"{out}.cells.p{i}.npy") for i in range(SHARDS)]
    streams = fleet.load_fleet(out + ".obs.p*.jsonl")
    shared = set(cells[0].tolist())
    for c in cells[1:]:
        shared &= set(c.tolist())
    return {"wall_s": r["wall_s"], "stats": st, "shards": shards,
            "cells": [int(c.size) for c in cells],
            "unique": [int(np.unique(c).size) for c in cells],
            "both": len(shared), "cell_arrays": cells,
            "tree": Tree.load(out + ".tree.pkl"),
            "roll": fleet.fleet_rollup(streams),
            "straggle": fleet.straggler_report(streams)}


def cell_recorded_build(problem, cfg):
    """build_partition(problem, cfg) with its point-solve cells recorded
    (CellRecorder): (result, cells as uint64 hashes)."""
    from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
        build_partition)

    with CellRecorder() as rec:
        res = build_partition(problem, cfg)
    return res, np.asarray(rec.cells, dtype=np.uint64)


def solve_accounting(label: str, single, single_cells, sharded) -> dict:
    """The summed point solves of a sharded build (`sharded`, from
    sharded_run) against a single-process build's (`single`, recorded
    by cell_recorded_build), cell by cell: the cells only one of them
    solved and each one's repeats (a cell solved again by the same
    process).  The
    difference of the two counts is exactly (only sharded - only single)
    + (sharded repeats - single repeats).  Logged; returned."""
    if single_cells.size != single["point_solves"]:
        fail(f"20b {label}: {single_cells.size} cells recorded against the "
             f"single process's {single['point_solves']} point solves")
    mine = set(single_cells.tolist())
    theirs = set()
    for c in sharded["cell_arrays"]:
        theirs |= set(c.tolist())
    acc = {"single": int(single_cells.size),
           "sharded": int(sum(c.size for c in sharded["cell_arrays"])),
           "only_single": len(mine - theirs),
           "only_sharded": len(theirs - mine),
           "single_repeats": int(single_cells.size) - len(mine),
           "sharded_repeats": int(sum(c.size for c in sharded["cell_arrays"]))
           - len(theirs)}
    log(f"[shard]   {label}: point solves sharded {acc['sharded']} "
        f"(summed), single process {acc['single']} (difference "
        f"{acc['sharded'] - acc['single']:+d}); cells only the single "
        f"process solved {acc['only_single']}, only the shards "
        f"{acc['only_sharded']}; cells solved again by the same process: "
        f"single {acc['single_repeats']}, shards {acc['sharded_repeats']}")
    return acc


def sharded_build_phase(dev, problem, cfg, res, build_s: float,
                        tmp: str) -> dict:
    """20b: the sharded build (sharded_run) of the tier-1 DI fixture and
    of phase 3's flagship, every shard on `dev` (one card time-sliced:
    the wall is the protocol's cost, not scaling).

    Both: 0 fallback cells, and no (point, commutation) cell solved by
    two shards (the ownership hash's zero-duplicate guarantee, read from
    the cells each shard's point solves finished; each shard's cells are
    its oracle.point_solves).  The DI fixture (one commutation: no
    masked point solves, nothing to warm-start) must give the
    single-process build's tree canonically and its point solves
    exactly.  The flagship: the merged tree compared canonically with
    phase 3's `res` (identical, or each differing cell named), regions
    within 2% of REF_REGIONS, uncertified <= REF_UNCERTIFIED_MAX, the
    summed point solves beside phase 3's and, cell by cell
    (solve_accounting), beside a single-process build's without
    speculation (phase 3 speculates; a sharded frontier never does),
    each differing cell named; each shard's K1 launches and the span of their event pairs, and the
    straggler report.  Returns the kernels line's sharded counts."""
    import dataclasses

    from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
    from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
        build_partition)
    from explicit_hybrid_mpc_tpu_torch.partition.shard import (
        compare_trees_canonical)
    from explicit_hybrid_mpc_tpu_torch.problems.registry import make

    on_card = dev.type == "cuda"
    t0 = time.perf_counter()
    name, args = DI_PROBLEM
    di_cfg = PartitionConfig(problem=name, problem_args=args,
                             backend=dev.type, **DI_CFG)
    di_ref = build_partition(make(name, **dict(args)), di_cfg)
    out = {}
    for tag, c, ref in (("di", di_cfg, di_ref), ("flagship", cfg, res)):
        r = sharded_run(dev, c, tmp, tag)
        st, roll, shards = r["stats"], r["roll"], r["shards"]
        solves = roll["counters"].get("oracle.point_solves")
        per_shard = [s.get("point_solves") for s in st["per_shard"]]
        diffs = compare_trees_canonical(ref.tree, r["tree"])
        cells, other_delta = differing_cells(tree_outcomes(ref.tree),
                                             tree_outcomes(r["tree"]))
        log(f"[shard] 20b {tag}: main --shard-frontier, {SHARDS} shards on "
            f"{dev} (the launcher, one process a shard): wall "
            f"{r['wall_s']:.1f} s (each shard's main "
            + ", ".join(f"{s['wall_s']:.1f}" for s in shards)
            + f" s; the single-process build {build_s if tag == 'flagship' else di_ref.stats['wall_s']:.1f} s); "
            f"regions {st['regions']} (single process: "
            f"{ref.stats['regions']}), uncertified {st['uncertified']}, "
            f"tree nodes {st['tree_nodes']} ({ref.stats['tree_nodes']}), "
            f"point solves summed over {roll['n_streams']} streams {solves} "
            f"(single process: {ref.stats['point_solves']}; per shard "
            f"{per_shard}), simplex solves {st['simplex_solves']} "
            f"({ref.stats['simplex_solves']}), remote cells "
            f"{st['shard_remote_cells']}, served "
            f"{st['shard_served_cells']}, fallback "
            f"{st['shard_fallback_cells']}; point-solve cells recorded "
            f"{r['cells']} ({r['unique']} distinct), solved by both "
            f"shards {r['both']}")
        for s in shards:
            span = s["k1_ms"]
            log(f"[shard]   {tag} shard {s['rank']}: K1 {s['k1']} "
                "launches; their CUDA event pairs span " + (
                    f"{span:.2f} ms in all" if span is not None
                    else "not measured")
                + " (not K1 device time: the shards time-slice one card, "
                "so a pair also spans the other shard's work)")
        log(f"[shard]   {tag}: canonical comparison with the single-process "
            "tree: " + ("identical" if not diffs else "; ".join(diffs))
            + f"; {len(cells)} cells decided differently (one build split, "
            f"the other closed), {other_delta} leaves with another "
            "commutation")
        outs_ref, outs_sh = tree_outcomes(ref.tree), tree_outcomes(r["tree"])
        for key in cells[:10]:
            verts = np.frombuffer(key, dtype=np.float64).reshape(
                ref.tree.p + 1, ref.tree.p)
            log(f"[shard]     cell "
                f"{np.array2string(verts.ravel(), precision=6)}: single "
                f"process {outs_ref[key]}, sharded {outs_sh[key]}")
        log(f"[shard]   {tag} straggler report: {json.dumps(r['straggle'])}")
        if on_card and any(s["k1"] <= 0 for s in shards):
            fail(f"20b {tag}: a shard launched no K1 ({shards})")
        if st["shard_fallback_cells"] != 0 or r["both"] != 0 \
                or r["cells"] != per_shard or solves != sum(per_shard):
            fail(f"20b {tag}: fallback cells {st['shard_fallback_cells']}, "
                 f"cells solved by both shards {r['both']}, cells recorded "
                 f"{r['cells']} against point solves {per_shard} (streams: "
                 f"{solves})")
        if tag == "di" and (diffs or solves != ref.stats["point_solves"]):
            fail(f"20b di: the sharded build is not the single-process one "
                 f"({diffs}; point solves {solves} against "
                 f"{ref.stats['point_solves']})")
        if tag == "flagship":
            check_build("sharded build", st, REF_REGIONS if on_card
                        else ref.stats["regions"], REF_UNCERTIFIED_MAX)
            # Phase 3 speculates and a sharded frontier never does: the
            # same single-process build without speculation, for its
            # tree and its point solves.
            ns, ns_cells = cell_recorded_build(
                problem, dataclasses.replace(cfg, speculate=False))
            ns_diffs = compare_trees_canonical(ref.tree, ns.tree)
            log(f"[shard]   flagship single process without speculation "
                f"(--no-speculate): regions {ns.stats['regions']}, point "
                f"solves {ns.stats['point_solves']} (phase 3: "
                f"{ref.stats['point_solves']}, of them speculative cells "
                f"wasted {ref.stats['spec_waste']}, used "
                f"{ref.stats['spec_hits']}); canonical comparison with "
                "phase 3's tree: " + ("identical" if not ns_diffs
                                      else "; ".join(ns_diffs)))
            solve_accounting("flagship against the single process without "
                             "speculation", ns.stats, ns_cells, r)
        out[tag] = {"launches": [s["k1"] for s in shards],
                    "ms": [s["k1_ms"] for s in shards],
                    "identical": not diffs, "differing_cells": len(cells),
                    "point_solves": solves}
    log(f"[shard] (20b took {time.perf_counter() - t0:.1f} s)")
    return {"sharded_launches": out["flagship"]["launches"],
            "sharded_k1_event_wall_ms": out["flagship"]["ms"],
            "sharded_identical": out["flagship"]["identical"],
            "sharded_differing_cells": out["flagship"]["differing_cells"],
            "sharded_di_launches": out["di"]["launches"]}


def lockstep_worker() -> int:
    """One rank of 20c (started by lockstep_phase with RANK, WORLD_SIZE,
    MASTER_ADDR/PORT, LOCKSTEP_OUT and LOCKSTEP_BACKEND): the tier-1 DI
    build with the oracle's vertex grid on the global mesh (one entry a
    rank, on this process's card or CPU), checkpoints every 2 steps
    (only rank 0's land), rank 0 saving the tree; writes its view of the
    result to LOCKSTEP_OUT.r<rank>.json."""
    import torch

    from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
    from explicit_hybrid_mpc_tpu_torch.oracle import ipm_leg
    from explicit_hybrid_mpc_tpu_torch.oracle.oracle import Oracle
    from explicit_hybrid_mpc_tpu_torch.parallel import distributed
    from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
        build_partition)
    from explicit_hybrid_mpc_tpu_torch.problems.registry import make

    out, backend = os.environ["LOCKSTEP_OUT"], os.environ["LOCKSTEP_BACKEND"]
    rank = distributed.init_distributed()
    try:
        # One card a rank where the machine has several, else all on
        # the one.
        dev = torch.device("cuda", rank % torch.cuda.device_count()) \
            if backend == "cuda" else torch.device("cpu")
        name, args = DI_PROBLEM
        prob = make(name, **dict(args))
        mesh = distributed.global_mesh(local_devices=[dev])
        ipm_leg.launches = 0
        oracle = Oracle(prob, backend=backend, mesh=mesh)
        cfg = PartitionConfig(problem=name, problem_args=args,
                              backend=backend, checkpoint_every=2,
                              checkpoint_path=f"{out}.r{rank}.ckpt.pkl",
                              **DI_CFG)
        res = build_partition(prob, cfg, oracle=oracle)
        owner = distributed.is_frontier_owner()
        if owner:
            res.tree.save(f"{out}.tree.pkl")
        with open(f"{out}.r{rank}.json", "w") as f:
            json.dump({"rank": rank, "owner": owner,
                       "mesh": repr(mesh), "k1_launches": ipm_leg.launches,
                       **{k: res.stats[k] for k in (
                           "regions", "tree_nodes", "max_depth",
                           "oracle_solves", "point_solves")}}, f)
    finally:
        distributed.shutdown()
    return 0


def lockstep_phase(dev, tmp: str) -> dict:
    """20c: LOCKSTEP_RANKS processes (gloo, every rank on `dev`) build the
    tier-1 DI fixture in lockstep with the oracle's vertex grid on the
    global mesh (lockstep_worker): every rank's regions, tree nodes, max
    depth and solves equal to each other's and to a single-process build
    on `dev` with the grid on a local mesh of the same shape (a mesh
    oracle runs no two-phase cohort and no warm starts, so its solves
    are its own), whose tree is the plain build's; only rank 0 writes its
    checkpoint and the tree.  Returns the kernels line's lockstep
    counts."""
    from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
    from explicit_hybrid_mpc_tpu_torch.oracle.oracle import Oracle
    from explicit_hybrid_mpc_tpu_torch.parallel import make_mesh
    from explicit_hybrid_mpc_tpu_torch.parallel.launch import (free_port,
                                                               shard_env)
    from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
        build_partition)
    from explicit_hybrid_mpc_tpu_torch.problems.registry import make

    on_card = dev.type == "cuda"
    name, args = DI_PROBLEM
    prob = make(name, **dict(args))
    # The ranks' checkpoint cadence too: a checkpoint drops the pipeline's
    # lookahead, whose cells are solved again.
    cfg = PartitionConfig(problem=name, problem_args=args, backend=dev.type,
                          checkpoint_every=2,
                          checkpoint_path=os.path.join(tmp, "ref.ckpt.pkl"),
                          **DI_CFG)
    plain = build_partition(prob, cfg).stats
    ref = build_partition(prob, cfg, oracle=Oracle(
        prob, backend=dev.type,
        mesh=make_mesh((LOCKSTEP_RANKS, 1), [dev] * LOCKSTEP_RANKS))).stats
    out = os.path.join(tmp, "lockstep")
    port = free_port()
    procs, files = [], []
    t0 = time.perf_counter()
    try:
        for rank in range(LOCKSTEP_RANKS):
            env = shard_env(os.environ, port, rank, LOCKSTEP_RANKS, "lockstep")
            env.update(LOCKSTEP_OUT=out, LOCKSTEP_BACKEND=dev.type)
            f = tempfile.TemporaryFile(mode="w+b")
            files.append(f)
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _LOCKSTEP], cwd=_root(), env=env,
                stdout=f, stderr=subprocess.STDOUT))
        rcs = [p.wait(timeout=max(1.0, LOCKSTEP_TIMEOUT_S
                                  - (time.perf_counter() - t0)))
               for p in procs]
    except subprocess.TimeoutExpired:
        rcs = None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)
    wall = time.perf_counter() - t0
    tails = []
    for f in files:
        f.seek(0)
        tails.append(f.read().decode("utf-8", errors="replace")[-3000:])
        f.close()
    if rcs is None or any(rcs):
        fail(f"20c: the lockstep ranks exited {rcs} (None: timed out after "
             f"{LOCKSTEP_TIMEOUT_S:.0f} s): {tails}")
    ranks = []
    for rank in range(LOCKSTEP_RANKS):
        with open(f"{out}.r{rank}.json") as f:
            ranks.append(json.load(f))
    keys = ("regions", "tree_nodes", "max_depth", "oracle_solves",
            "point_solves")
    ckpts = [os.path.exists(f"{out}.r{r}.ckpt.pkl")
             for r in range(LOCKSTEP_RANKS)]
    log(f"[lockstep] 20c {LOCKSTEP_RANKS} ranks (gloo) on {dev}, the DI "
        f"fixture {dict(args)} {DI_CFG} with the vertex grid on "
        f"{ranks[0]['mesh']}: {wall:.1f} s; "
        + "; ".join(f"rank {x['rank']}: " + ", ".join(f"{k} {x[k]}"
                                                       for k in keys)
                    + f", K1 {x['k1_launches']}" for x in ranks)
        + "; single process, local mesh: " + ", ".join(f"{k} {ref[k]}"
                                                        for k in keys)
        + "; plain: " + ", ".join(f"{k} {plain[k]}" for k in keys)
        + f"; owners {[x['owner'] for x in ranks]}, checkpoints written "
        f"{ckpts}, tree written {os.path.exists(out + '.tree.pkl')}")
    tree = ("regions", "tree_nodes", "max_depth")
    if any({k: x[k] for k in keys} != {k: ref[k] for k in keys}
           for x in ranks) or any(ref[k] != plain[k] for k in tree):
        fail("20c: a rank's build differs from the single-process build")
    if [x["owner"] for x in ranks] != [True] + [False] * (LOCKSTEP_RANKS - 1) \
            or ckpts != [True] + [False] * (LOCKSTEP_RANKS - 1) \
            or not os.path.exists(out + ".tree.pkl"):
        fail("20c: outputs were written by another rank than rank 0")
    if on_card and any(x["k1_launches"] <= 0 for x in ranks):
        fail(f"20c: a rank launched no K1 ({ranks})")
    return {"lockstep_launches": [x["k1_launches"] for x in ranks]}


def multi_gpu_phase(dev, problem, cfg, res, build_s: float, tmp: str) -> dict:
    """Phase 20 (20a-20c); returns the kernels line's ipm_leg counts."""
    t0 = time.perf_counter()
    out = mesh_solve_phase(dev, problem)
    out.update(sharded_build_phase(dev, problem, cfg, res, build_s, tmp))
    out.update(lockstep_phase(dev, tmp))
    log(f"[multi] phase 20 took {time.perf_counter() - t0:.1f} s")
    return out


def mesh_only() -> int:
    """20a and 20c alone on every card of the machine: the mesh over
    distinct cards, and one lockstep rank a card.

        python3 -c "import sys, chip_smoke as c; sys.exit(c.mesh_only())"
    """
    import torch

    from explicit_hybrid_mpc_tpu_torch import kernels
    from explicit_hybrid_mpc_tpu_torch.problems.registry import make

    global LOCKSTEP_RANKS
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    n = torch.cuda.device_count()
    log(f"[device] {n} x {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    kernels.build()
    log(f"[build] kernels in {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda", 0)
    out = mesh_solve_phase(dev, make("inverted_pendulum"))
    LOCKSTEP_RANKS = max(2, n)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        out.update(lockstep_phase(dev, tmp))
    log(json.dumps(out))
    return 0


def multi_gpu_only() -> int:
    """Phase 20 alone, for iterating on the card: the kernels built, a
    flagship build standing in for phase 3's, then 20a-20c.

        python3 -c "import sys, chip_smoke as c; sys.exit(c.multi_gpu_only())"
    """
    import torch

    from explicit_hybrid_mpc_tpu_torch import kernels
    from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
    from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
        build_partition)
    from explicit_hybrid_mpc_tpu_torch.problems.registry import make

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    kernels.build()
    log(f"[build] kernels in {time.perf_counter() - t0:.1f} s")
    problem = make("inverted_pendulum")
    cfg = PartitionConfig(problem="inverted_pendulum", eps_a=1e-2)
    t0 = time.perf_counter()
    res = build_partition(problem, cfg)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    log(f"[main] build {build_s:.1f} s: regions {res.stats['regions']}, "
        f"point solves {res.stats['point_solves']}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_multi_") as tmp:
        out = multi_gpu_phase(dev, problem, cfg, res, build_s, tmp)
    log(json.dumps(out))
    return 0


# -- phase 21: the analysis package (the recompile guard through the
# frontier on the card, the kernel-loader watch) --------------------------------

#: 21b's build: the tier-1 DI fixture at batch 16 (48 of its 51 steps
#: full), the JAX package's guard test build.
GUARD_DI = ["-e", "double_integrator", "--problem-arg", "N=3",
            "--problem-arg", "theta_box=1.5", "-a", "0.2", "--batch", "16"]
GUARD_DI_CFG = dict(problem="double_integrator",
                    problem_args=(("N", 3), ("theta_box", 1.5)), eps_a=0.2,
                    batch_simplices=16)
#: 21a's build: the flagship, as phase 3 builds it, but without
#: speculation: speculative dispatch is gated on the device's measured
#: share of the wall (partition/pipeline.py SPEC_DEVICE_FRAC_MAX), so
#: with it the K1 count moves build to build with one tree (phase 3 gave
#: 720-730 on the card); without it the count is a function of the tree.
GUARD_FLAGSHIP = ["-e", "inverted_pendulum", "-a", "1e-2", "--no-speculate"]
#: 21a's runs: cold under warn, then warmed under raise.
GUARD_MODES = ("warn", "raise")
#: 21c's online batch through the point-location kernel.
GUARD_EVALUATE = 4096
GUARD_TIMEOUT_S = 300.0
_FORCED_MAIN = ("import sys, chip_smoke; "
                "sys.exit(chip_smoke.forced_main_worker())")
_LOADER_WATCH = ("import sys, chip_smoke; "
                 "sys.exit(chip_smoke.loader_watch_worker())")


def warm_buckets(oracle, problem) -> frozenset:
    """bench.py's warm_oracle for the port's Oracle: every vertex-batch,
    pair and simplex bucket launched once, so the oracle's ledger holds
    every shape a build can dispatch ("warm shapes == run shapes");
    the solve counters are reset after.  Returns the ledger."""
    from explicit_hybrid_mpc_tpu_torch.partition import geometry

    rng = np.random.default_rng(42)
    nd = problem.canonical.n_delta

    def buckets(cap):
        b = 8
        while b <= cap:
            yield b
            b *= 2

    for b in buckets(oracle.max_points_per_call):
        oracle.solve_vertices(rng.uniform(problem.theta_lb, problem.theta_ub,
                                          (b, problem.n_theta)))
    # Grid survivors compact into pair buckets on two-phase / warm /
    # rescue oracles, even at one commutation.
    if nd > 1 or oracle.two_phase or oracle.warm_start \
            or oracle.rescue_iter > 0:
        for b in buckets(oracle.max_pairs_per_call):
            oracle.warm_pair_bucket(
                rng.uniform(problem.theta_lb, problem.theta_ub,
                            (b, problem.n_theta)), np.arange(b) % nd)
    span = problem.theta_ub - problem.theta_lb
    M1 = geometry.barycentric_matrix(np.vstack(
        [problem.theta_lb, problem.theta_lb + 0.1 * np.diag(span)]))
    for b in buckets(oracle.max_simplex_rows_per_call):
        oracle.warm_simplex_bucket(np.tile(M1[None], (b, 1, 1)),
                                   np.arange(b) % nd)
    oracle.reset_stats()
    return frozenset(oracle.compiled_shapes)


class GuardProbe:
    """While active, wraps FrontierEngine._guard_step to note, for the
    engine it runs in: the step the guard armed at and the ledger's size
    then, the full steps checked after, the ledger's size at the last
    step, the seconds spent in the hook (arms and checks), and each
    check that fired (step, the shapes it reported).  `force`, when
    given, is called once with the engine right after an armed step
    whose frontier holds a full batch (the next step is full)."""

    def __init__(self, force=None):
        self.force = force
        self.armed_step = self.shapes_at_arm = self.shapes_end = None
        self.checked = 0
        self.hook_s = 0.0
        self.fired: list = []
        self.forced = None

    def __enter__(self):
        from explicit_hybrid_mpc_tpu_torch.partition import frontier

        self._cls = frontier.FrontierEngine
        real = self._real = self._cls._guard_step
        probe = self

        def hook(eng, batch):
            warm = eng._GUARD_WARMUP_FULL_STEPS
            full = batch >= eng.cfg.batch_simplices
            n0 = eng._rc_guard.n_violations
            pending = eng._rc_guard.new_shapes()
            t0 = time.perf_counter()
            try:
                real(eng, batch)
            finally:
                probe.hook_s += time.perf_counter() - t0
                probe.shapes_end = len(eng.oracle.compiled_shapes)
                if full and eng._rc_steady_steps == warm:
                    probe.armed_step = eng.steps
                    probe.shapes_at_arm = probe.shapes_end
                elif full and eng._rc_steady_steps > warm:
                    probe.checked += 1
                if eng._rc_guard.n_violations > n0:
                    probe.fired.append((eng.steps, [tuple(s)
                                                    for s in pending]))
            if (probe.force is not None and probe.forced is None
                    and eng._rc_steady_steps >= warm
                    and len(eng.frontier) >= eng.cfg.batch_simplices):
                probe.forced = probe.force(eng)

        self._cls._guard_step = hook
        return self

    def __exit__(self, *exc):
        self._cls._guard_step = self._real
        return False


def force_new_bucket(eng) -> dict:
    """One real dispatch through the engine's own oracle at a padded row
    count the build never used: a vertex grid at the smallest
    power-of-two bucket missing from its ledger.  Returns what it
    launched."""
    from explicit_hybrid_mpc_tpu_torch.oracle import ipm_leg

    ora, prob = eng.oracle, eng.problem
    rows = 8
    while ("grid", rows) in ora.compiled_shapes:
        rows *= 2
    k1 = ipm_leg.launches
    th = np.random.default_rng(SEED + 21).uniform(
        prob.theta_lb, prob.theta_ub, (rows, prob.n_theta))
    ora.solve_vertices(th)
    return {"rows": rows, "k1": ipm_leg.launches - k1,
            "step": eng.steps}


def guarded_flagship(dev, res, n_k1: int, card: str, tmp: str) -> dict:
    """21a: the flagship through the CLI with the guard on (`main -e
    inverted_pendulum -a 1e-2 --obs jsonl`).  First from a cold oracle
    under --recompile-guard warn: the JAX package's guard fires there too
    (a hybrid build mints pair, cohort and stage-2 buckets after its 8
    full warmup steps; tests/test_torch_recompile_guard.py), and each
    event must name shapes no earlier event named.  Then under
    --recompile-guard raise from an oracle warmed at every bucket
    (warm_buckets; its launches are not the build's): exit 0, 0
    violations.  Before them the same build unguarded; all three without
    speculation (GUARD_FLAGSHIP).  Both guarded builds: phase 3's tree
    cell for cell and the unguarded build's K1 launches exactly (phase
    3's `n_k1`, with speculation, logged beside them)."""
    from explicit_hybrid_mpc_tpu_torch.obs import load_jsonl
    from explicit_hybrid_mpc_tpu_torch.oracle import ipm_leg
    from explicit_hybrid_mpc_tpu_torch.partition import frontier
    from explicit_hybrid_mpc_tpu_torch.partition.tree import Tree

    on_card = dev.type == "cuda"
    a = tree_outcomes(res.tree)
    prefix = os.path.join(tmp, "21a_unguarded")
    rc, st, _ev, wall, _legs, k1_ref, _k2, _p = run_main(
        [*GUARD_FLAGSHIP, "--backend", dev.type, "-o", prefix], on_card)
    ref_same = rc == 0 and tree_outcomes(
        Tree.load(prefix + ".tree.pkl")) == a
    log(f"[guard] 21a flagship, main {' '.join(GUARD_FLAGSHIP)} unguarded: "
        f"exit {rc}, {wall:.1f} s, regions {st.get('regions')}, K1 launches "
        f"{k1_ref} (phase 3, with speculation: {n_k1}); tree "
        f"{'equal to' if ref_same else 'NOT equal to'} phase 3's cell for "
        "cell")
    if not ref_same:
        fail(f"21a: the unguarded build without speculation exited {rc} "
             "or its tree is not phase 3's")
    out = {}
    for mode in GUARD_MODES:
        prefix = os.path.join(tmp, f"21a_{mode}")
        argv = [*GUARD_FLAGSHIP, "--backend", dev.type, "--obs", "jsonl",
                "--recompile-guard", mode, "-o", prefix]
        real_mo = frontier.make_oracle
        warmed = {}

        def make_oracle(problem, cfg, **kw):
            o = real_mo(problem, cfg, **kw)
            k0 = ipm_leg.launches
            t0 = time.perf_counter()
            warmed["shapes"] = warm_buckets(o, problem)
            warmed["k1"] = ipm_leg.launches - k0
            warmed["s"] = time.perf_counter() - t0
            return o

        if mode == "raise":
            frontier.make_oracle = make_oracle
        probe = GuardProbe()
        try:
            with probe:
                rc, st, _ev, wall, _legs, k1, _k2, _p = run_main(argv,
                                                                 on_card)
        except Exception as e:  # noqa: BLE001 -- reported, then failed
            fail(f"21a ({mode}): the guarded flagship build raised {e!r} "
                 f"at step {probe.fired[-1][0] if probe.fired else '?'}")
        finally:
            frontier.make_oracle = real_mo
        k1 -= warmed.get("k1", 0)
        evs = [r for r in load_jsonl(prefix + ".obs.jsonl")
               if r.get("name") == "health.recompile"]
        b = tree_outcomes(Tree.load(prefix + ".tree.pkl")) if rc == 0 else {}
        diff, other = differing_cells(a, b)
        named = [s for _step, shapes in probe.fired for s in shapes]
        log(f"[guard] 21a flagship, main --recompile-guard {mode}"
            + (f" (oracle warmed at {len(warmed['shapes'])} bucket shapes "
               f"in {warmed['s']:.1f} s, {warmed['k1']} K1 launches not "
               "counted)" if mode == "raise" else " (cold oracle)")
            + f": exit {rc}, {wall:.1f} s, steps {st.get('steps')}, regions "
            f"{st.get('regions')}; armed after 8 full steps at step "
            f"{probe.armed_step} with {probe.shapes_at_arm} ledger shapes, "
            f"{probe.checked} full steps checked, {probe.shapes_end} shapes "
            f"at the end; guard hook {1e3 * probe.hook_s:.2f} ms = "
            f"{probe.hook_s / wall:.2e} of the build wall; "
            f"{len(probe.fired)} violations ({len(evs)} health.recompile "
            f"events)" + "".join(
                f"; step {s} {', '.join(f'{f}[{r}]' for f, r in sh)}"
                for s, sh in probe.fired)
            + f"; K1 launches {k1} (unguarded: {k1_ref}); tree "
            f"{'equal to' if a == b else 'NOT equal to'} phase 3's cell "
            f"for cell ({len(diff)} decided differently, {other} other "
            f"commutations); {card}")
        if rc != 0:
            fail(f"21a ({mode}): main exited {rc}")
        if a != b:
            fail(f"21a ({mode}): the guarded build's tree is not phase 3's")
        if k1 != k1_ref:
            fail(f"21a ({mode}): {k1} K1 launches, the unguarded build "
                 f"{k1_ref}")
        if len(evs) != len(probe.fired) or len(named) != len(set(named)):
            fail(f"21a ({mode}): {len(evs)} events for {len(probe.fired)} "
                 "violations, or a shape reported twice")
        if mode == "raise" and probe.fired:
            fail(f"21a: the warmed build minted {named} after the arm")
        if probe.armed_step is None:
            fail(f"21a ({mode}): the guard never armed")
        out[mode] = {"violations": len(probe.fired), "k1": k1,
                     "armed_step": probe.armed_step,
                     "checked": probe.checked, "hook_s": probe.hook_s,
                     "wall_s": wall, "shapes_end": probe.shapes_end}
    out["unguarded_k1"] = k1_ref
    return out


def forced_violation(dev, tmp: str) -> dict:
    """21b: the DI build on `dev` with obs on, the health monitor and the
    guard in warn mode; right after the arm one real dispatch through
    the engine's own oracle at a padded row count the build never used
    (force_new_bucket, between steps): exactly one health.recompile
    event in the stream, the monitor's worst verdict warn, the tree the
    unguarded build's.  The same forcing under raise: RecompileError out
    of the engine's step(), caught by nothing inside it; and a `main`
    run that sees it (forced_main_worker, its own process) exits
    non-zero."""
    import dataclasses

    from explicit_hybrid_mpc_tpu_torch.analysis.recompile_guard import (
        RecompileError)
    from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
    from explicit_hybrid_mpc_tpu_torch.obs import load_jsonl
    from explicit_hybrid_mpc_tpu_torch.oracle import ipm_leg
    from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
        FrontierEngine, build_partition, make_oracle)
    from explicit_hybrid_mpc_tpu_torch.problems.registry import make

    prob = make("double_integrator", N=3, theta_box=1.5)
    base = PartitionConfig(backend=dev.type, **GUARD_DI_CFG)
    plain = tree_outcomes(build_partition(prob, base).tree)
    stream = os.path.join(tmp, "21b.obs.jsonl")
    cfg = dataclasses.replace(base, obs="jsonl", obs_path=stream,
                              recompile_guard="warn",
                              health_rules=(("stall_s", 300.0),))
    ipm_leg.launches = 0
    probe = GuardProbe(force=force_new_bucket)
    with probe:
        eng = FrontierEngine(prob, make_oracle(prob, cfg), cfg)
        got = eng.run()
    evs = [r for r in load_jsonl(stream)
           if r.get("name") == "health.recompile"]
    worst = eng._health.worst
    same = tree_outcomes(got.tree) == plain
    f = probe.forced or {}
    log(f"[guard] 21b DI on {dev.type}, --recompile-guard warn: forced a "
        f"grid dispatch of {f.get('rows')} rows after step {f.get('step')} "
        f"(the guard armed at step {probe.armed_step}), {f.get('k1')} K1 "
        f"launches; {len(evs)} health.recompile event(s) "
        + "; ".join(f"step {e.get('step')}: {e.get('msg')}" for e in evs)
        + f"; health monitor worst {worst}; tree "
        f"{'equal to' if same else 'NOT equal to'} the unguarded build's")
    if not f or (dev.type == "cuda" and f["k1"] < 1):
        fail("21b: the forced dispatch did not run (or launched no K1)")
    if len(evs) != 1 or ["grid", f["rows"]] not in evs[0]["shapes"]:
        fail(f"21b: {len(evs)} health.recompile events, expected one "
             f"naming grid[{f['rows']}]")
    if worst != "warn":
        fail(f"21b: the health monitor's worst verdict is {worst}")
    if not same:
        fail("21b: the guarded build's tree is not the unguarded build's")
    # The same forcing under raise: RecompileError out of step().
    cfg_r = dataclasses.replace(base, recompile_guard="raise")
    eng = FrontierEngine(prob, make_oracle(prob, cfg_r), cfg_r)
    raised = None
    with GuardProbe(force=force_new_bucket) as probe_r:
        try:
            while eng.frontier:
                eng.step()
        except RecompileError as e:
            raised = (eng.steps, str(e))
    log(f"[guard] 21b --recompile-guard raise: RecompileError out of "
        f"step() at step {raised and raised[0]} (forced after step "
        f"{(probe_r.forced or {}).get('step')}): {raised and raised[1]}")
    if raised is None:
        fail("21b: under raise the forced growth did not abort the build")
    # A `main` run that sees such growth exits non-zero.
    env = dict(os.environ, GUARD_ARGV=json.dumps(
        [*GUARD_DI, "--backend", dev.type, "--recompile-guard", "raise",
         "-o", os.path.join(tmp, "21b_main")]))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", _FORCED_MAIN], cwd=_root(),
                       env=env, capture_output=True, text=True,
                       timeout=GUARD_TIMEOUT_S)
    last = (r.stderr.strip().splitlines() or [""])[-1]
    log(f"[guard] 21b main --recompile-guard raise with the forced "
        f"dispatch, in its own process: exit {r.returncode} in "
        f"{time.perf_counter() - t0:.1f} s; {last[:160]}")
    if r.returncode == 0 or "RecompileError" not in r.stderr:
        fail(f"21b: main exited {r.returncode} without a RecompileError")
    return {"events": len(evs), "forced_k1": f["k1"],
            "main_rc": r.returncode}


def forced_main_worker() -> int:
    """21b's `main` run (argv in GUARD_ARGV): force_new_bucket right after
    the guard arms; the RecompileError it raises is left uncaught, so
    the process exits non-zero."""
    from explicit_hybrid_mpc_tpu_torch import main as tmain

    with GuardProbe(force=force_new_bucket):
        return tmain.main(json.loads(os.environ["GUARD_ARGV"]))


def loader_watch_worker() -> int:
    """21c's process: RecompileGuard(watch=[kernels.loader]) armed before
    the first launch, checked after a DI build with --evaluate (argv in
    GUARD_ARGV); prints the growth and the libraries loaded as JSON."""
    from explicit_hybrid_mpc_tpu_torch import kernels
    from explicit_hybrid_mpc_tpu_torch import main as tmain
    from explicit_hybrid_mpc_tpu_torch.analysis.recompile_guard import (
        RecompileGuard)

    g = RecompileGuard(watch=[kernels.loader], action="warn",
                       label="loader_watch")
    rc = tmain.main(json.loads(os.environ["GUARD_ARGV"]))
    ev = g.check()
    print(json.dumps({"rc": rc, "growth": ev["value"] if ev else 0,
                      "loaded": sorted(kernels._libs),
                      "built": sorted(kernels._built)}))
    return rc


def loader_watch(dev, tmp: str, loader_guard) -> dict:
    """21c: the kernel-loader probe.  In a fresh process, the growth a
    guard armed before the first launch sees over a DI build plus an
    online batch (loader_watch_worker) equals the libraries loaded: on
    the card K1 and K2.  In this process, `loader_guard` (armed right
    after phase 3) sees 0: every library was built in phase 1."""
    env = dict(os.environ, GUARD_ARGV=json.dumps(
        [*GUARD_DI, "--backend", dev.type, "--evaluate",
         str(GUARD_EVALUATE), "-o", os.path.join(tmp, "21c")]))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", _LOADER_WATCH], cwd=_root(),
                       env=env, capture_output=True, text=True,
                       timeout=GUARD_TIMEOUT_S)
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith('{"rc"')]
    got = json.loads(lines[-1]) if lines else {}
    here = loader_guard.cache_growth()
    want = ["ipm_leg", "locate"] if dev.type == "cuda" else []
    log(f"[guard] 21c kernels.loader in a fresh process over main (DI "
        f"build, --evaluate {GUARD_EVALUATE}): exit {r.returncode} in "
        f"{time.perf_counter() - t0:.1f} s, growth {got.get('growth')}, "
        f"libraries loaded {got.get('loaded')}, built there "
        f"{got.get('built')}; the guard armed after phase 3 sees {here} "
        "after 21a")
    if r.returncode != 0 or not got:
        fail(f"21c: the loader-watch process exited {r.returncode}: "
             f"{r.stderr[-400:]}")
    if got["loaded"] != want or got["growth"] != len(got["loaded"]):
        fail(f"21c: growth {got['growth']} for libraries {got['loaded']} "
             f"(expected {want})")
    if here != 0:
        fail(f"21c: the guard armed after phase 3 saw {here} new "
             "libraries")
    return {"loader_growth": got["growth"], "loaded": got["loaded"]}


def analysis_phase(dev, res, n_k1: int, card: str, tmp: str,
                   loader_guard) -> dict:
    """Phase 21 (21a-21c); returns the kernels line's ipm_leg keys."""
    t0 = time.perf_counter()
    flag = guarded_flagship(dev, res, n_k1, card, tmp)
    forced = forced_violation(dev, tmp)
    watch = loader_watch(dev, tmp, loader_guard)
    log(f"[guard] phase 21 took {time.perf_counter() - t0:.1f} s")
    return {"guarded_launches": flag["raise"]["k1"],
            "guard_violations_cold": flag["warn"]["violations"],
            "guard_unguarded_launches": flag["unguarded_k1"],
            "guard_hook_frac": flag["raise"]["hook_s"]
            / flag["raise"]["wall_s"],
            "forced_k1_launches": forced["forced_k1"],
            "loader_growth": watch["loader_growth"]}


def analysis_only() -> int:
    """Phase 21 alone, for iterating on the card: the kernels built, a
    flagship build standing in for phase 3's, then 21a-21c.

        python3 -c "import sys, chip_smoke as c; sys.exit(c.analysis_only())"
    """
    import torch

    from explicit_hybrid_mpc_tpu_torch import kernels
    from explicit_hybrid_mpc_tpu_torch.analysis.recompile_guard import (
        RecompileGuard)
    from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
    from explicit_hybrid_mpc_tpu_torch.oracle import ipm_leg
    from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
        build_partition)
    from explicit_hybrid_mpc_tpu_torch.problems.registry import make

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi unavailable"
    t0 = time.perf_counter()
    kernels.build()
    log(f"[build] kernels in {time.perf_counter() - t0:.1f} s")
    problem = make("inverted_pendulum")
    ipm_leg.launches = 0
    res = build_partition(problem, PartitionConfig(
        problem="inverted_pendulum", eps_a=1e-2))
    n_k1 = ipm_leg.launches
    for name in kernels.SOURCES:
        kernels.library(name)
    loader_guard = RecompileGuard(watch=[kernels.loader])
    log(f"[main] build: regions {res.stats['regions']}, K1 {n_k1}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_guard_") as tmp:
        out = analysis_phase(dev, res, n_k1, card, tmp, loader_guard)
    log(json.dumps(out))
    return 0


# -- phase 22: the robustness gate (the chaos suite, the supervised
# flagship resumed from .prev, the drift smoke) ------------------------------

#: 22a: the chaos suite at the JAX package's configuration (the tier-1
#: DI fixture, N=3, theta_box=1.5, eps 0.2, 64 simplices a batch).
CHAOS_EPS = 0.2
CHAOS_BATCH = 64
CHAOS_TIMEOUT_S = 300.0
#: After the reference build, 22a runs the schedules CHAOS_LANES at a time
#: (chaos_suite.run_suite's lanes).
CHAOS_LANES = 3
_CHAOS_MAIN = ("import sys, chip_smoke; "
               "sys.exit(chip_smoke.counted_cli(sys.argv[1:]))")
#: 22b: phase 3's flagship under the supervisor, checkpointed every 20
#: steps, the process killed between rotation and write of its 2nd
#: checkpoint and resumed from the surviving .prev.
ROBUST_FLAGSHIP = ["-e", "inverted_pendulum", "-a", "1e-2"]
ROBUST_CKPT_EVERY = 20
ROBUST_CRASH_AT = 2
ROBUST_TIMEOUT_S = 600.0
#: At most this many differing cells are listed one by one in 22b.
ROBUST_CELLS_LISTED = 50
#: 22c: the drift smoke at the chaos configuration.
DRIFT_EPS = 0.2


def _chaos_run_name(argv: list) -> str:
    """The schedule (or "reference") a chaos child's argv belongs to."""
    for flag in ("-o", "--artifacts-root"):
        if flag in argv:
            base = os.path.basename(argv[argv.index(flag) + 1])
            return {"base": "reference", "lc_ref": "lifecycle_publish_crash",
                    "lc_crash": "lifecycle_publish_crash"}.get(base, base)
    return "?"


def chaos_phase(dev, tmp: str) -> dict:
    """22a: tools/chaos_suite.py's five schedules on `dev`'s backend at
    the JAX package's configuration, CHAOS_LANES schedules at a time,
    every child through counted_cli (K1 launches a run).  On the card
    the verdicts are the card's
    (schedules 1, 2 and 4 end with NoCpuFallback; 3 and 5 as on the
    CPU); on the CPU the JAX package's.  Fails on any failed schedule
    and, on the card, on a build that launched no K1."""
    from explicit_hybrid_mpc_tpu_torch.tools import chaos_suite

    wd = os.path.join(tmp, "22a")
    os.makedirs(wd)
    t0 = time.perf_counter()
    with k1_log_env(os.path.join(tmp, "22a_k1.jsonl")) as k1_log:
        v = chaos_suite.run_suite(
            wd, CHAOS_EPS, CHAOS_BATCH, dev.type, timeout_s=CHAOS_TIMEOUT_S,
            entry=[sys.executable, "-c", _CHAOS_MAIN], lanes=CHAOS_LANES)
    wall = time.perf_counter() - t0
    k1: dict = {}
    for rec in k1_records(k1_log, partial=False):
        k1.setdefault(_chaos_run_name(rec["argv"]), []).append(rec["k1"])
    ref = v.get("reference", {})
    log(f"[chaos] 22a tools/chaos_suite on {dev.type} (eps {CHAOS_EPS}, "
        f"batch {CHAOS_BATCH}): reference build exit {ref.get('rc')} in "
        f"{ref.get('wall_s', 0.0):.1f} s, {ref.get('stats')}, K1 launches "
        f"{k1.get('reference')}")
    out = {}
    for name, row in v["schedules"].items():
        extra = {k: row[k] for k in (
            "rc", "rcs", "exception_chain", "fault_shard_chain",
            "exit_after_fault_s", "tree_written", "shard0", "shard0_tail",
            "stats", "tree_diffs", "gen1_committed") if k in row}
        if "supervise" in row:
            extra["attempts"] = [(a["rc"], a["resumed_from"] and
                                  os.path.basename(a["resumed_from"]))
                                 for a in row["supervise"]["attempts"]]
        log(f"[chaos]   {name}: {'ok' if row['ok'] else 'FAILED'} in "
            f"{row.get('wall_s', 0.0):.1f} s; K1 launches by process "
            f"{k1.get(name)}; {json.dumps(extra, default=str)}")
        out[f"chaos_{name}"] = {"verdict": "ok" if row["ok"] else "failed",
                                "wall_s": row.get("wall_s"),
                                "k1_launches": k1.get(name)}
    log(f"[chaos] 22a took {wall:.1f} s")
    if v["failures"] or len(v["schedules"]) != len(chaos_suite.SCHEDULES):
        fail("22a: " + "; ".join(v["failures"] or ["schedules missing"]))
    if dev.type == "cuda" and not all(k1.get("reference") or [0]):
        fail(f"22a: the reference build launched no K1 ({k1})")
    out["chaos_wall_s"] = wall
    return out


def supervised_flagship(dev, res, n_k1: int, tmp: str) -> dict:
    """22b: phase 3's flagship through tools/supervise_build.py with
    --checkpoint-every ROBUST_CKPT_EVERY, the child killed (os._exit)
    between rotation and write of its ROBUST_CRASH_AT-th checkpoint, the
    restart resumed from the surviving .prev; each attempt through
    counted_main, so the resumed process's K1 launches count from zero.
    Bar: regions within 2% of REF_REGIONS, uncertified <=
    REF_UNCERTIFIED_MAX, no fallback; the tree compared cell for cell
    with phase 3's `res`, each differing cell listed with both builds'
    outcomes."""
    from explicit_hybrid_mpc_tpu_torch.partition.tree import Tree
    from explicit_hybrid_mpc_tpu_torch.tools.supervise_build import (
        run_supervised)

    out = os.path.join(tmp, "22b")
    argv = [*ROBUST_FLAGSHIP, "--backend", dev.type, "--checkpoint-every",
            str(ROBUST_CKPT_EVERY), "-o", out]
    plan = os.path.join(tmp, "22b.plan.json")
    with open(plan, "w") as f:
        json.dump({"seed": 7, "process_exit": True, "faults": [
            {"site": "checkpoint.write", "kind": "crash",
             "at": ROBUST_CRASH_AT}]}, f)
    env = dict(os.environ, EHM_FAULT_PLAN=plan)
    t0 = time.perf_counter()
    env[K1_LOG_ENV] = out + ".k1.jsonl"
    with open(out + ".log", "wb") as f:
        sup = run_supervised(argv, out + ".ckpt.pkl", max_restarts=2,
                             attempt_timeout_s=ROBUST_TIMEOUT_S,
                             entry=[sys.executable, "-c", _COUNTED_MAIN],
                             env=env, stdout=f, stderr=subprocess.STDOUT)
    wall = time.perf_counter() - t0
    att = sup["attempts"]
    log(f"[robust] 22b flagship under tools/supervise_build "
        f"(--checkpoint-every {ROBUST_CKPT_EVERY}, crash at checkpoint "
        f"write {ROBUST_CRASH_AT}): {wall:.1f} s, attempts "
        + ", ".join(f"exit {a['rc']} in {a['wall_s']:.1f} s"
                    + (f" resumed from {os.path.basename(a['resumed_from'])}"
                       if a["resumed_from"] else "") for a in att)
        + f", {sup['final']}")
    if sup["rc"] != 0 or len(att) != 2 or att[0]["rc"] != 43 \
            or not (att[1]["resumed_from"] or "").endswith(".prev"):
        with open(out + ".log", "rb") as f:
            tail = f.read()[-2000:].decode("utf-8", errors="replace")
        fail(f"22b: the supervised build did not crash once and resume "
             f"from .prev to the end ({sup}): {tail}")
    with open(out + ".stats.json") as f:
        st = json.load(f)
    # The crashed attempt writes its record too (os._exit); the resumed
    # one is the last.
    k1 = k1_records(out + ".k1.jsonl", partial=False)[-1]
    a = tree_outcomes(res.tree)
    b = tree_outcomes(Tree.load(out + ".tree.pkl"))
    cells, other = differing_cells(a, b)
    log(f"[robust]   resumed build: regions {st['regions']} (phase 3: "
        f"{res.stats['regions']}), uncertified {st['uncertified']}, steps "
        f"{st['steps']} (phase 3: {res.stats['steps']}), point solves "
        f"{st['point_solves']} (phase 3: {res.stats['point_solves']}); the "
        f"resumed process's K1 launches {k1['k1']} counted from "
        f"zero (phase 3's whole build: {n_k1}); tree "
        f"{'equal to' if a == b else 'NOT equal to'} phase 3's cell for "
        f"cell ({len(a)} / {len(b)} cells, {len(cells)} decided "
        f"differently, {other} leaves with another commutation)")
    p = res.tree.p
    for key in cells[:ROBUST_CELLS_LISTED]:
        verts = np.frombuffer(key, dtype=np.float64).reshape(p + 1, p)
        log(f"[robust]     cell {np.array2string(verts.ravel(), precision=6)}"
            f": phase 3 {a[key]}, resumed {b[key]}")
    if len(cells) > ROBUST_CELLS_LISTED:
        log(f"[robust]     ... and {len(cells) - ROBUST_CELLS_LISTED} more")
    for key in [k for k in a.keys() & b.keys() if a[k][0] == b[k][0]
                == "leaf" and a[k][1] != b[k][1]][:ROBUST_CELLS_LISTED]:
        verts = np.frombuffer(key, dtype=np.float64).reshape(p + 1, p)
        log(f"[robust]     leaf {np.array2string(verts.ravel(), precision=6)}"
            f": commutation {a[key][1]} in phase 3, {b[key][1]} resumed")
    check_build("22b resumed build", st, REF_REGIONS if dev.type == "cuda"
                else res.stats["regions"], REF_UNCERTIFIED_MAX)
    if dev.type == "cuda" and (k1["rc"] != 0 or k1["k1"] <= 0):
        fail(f"22b: the resumed process launched no K1 ({k1})")
    return {"resumed_launches": k1["k1"],
            "resumed_regions": st["regions"],
            "resumed_identical": a == b,
            "resumed_differing_cells": len(cells), "resumed_wall_s": wall}


def drift_phase(dev, tmp: str) -> dict:
    """22c: tools/drift_smoke.py on `dev`'s backend in this process, K1
    counted from zero over the service's rebuilds; every verdict of the
    JAX script, and its staleness and request p50/p99."""
    from explicit_hybrid_mpc_tpu_torch.oracle import ipm_leg
    from explicit_hybrid_mpc_tpu_torch.tools import drift_smoke

    wd = os.path.join(tmp, "22c")
    os.makedirs(wd)
    ipm_leg.launches = 0
    t0 = time.perf_counter()
    v = drift_smoke.run_smoke(wd, eps=DRIFT_EPS, backend=dev.type)
    wall = time.perf_counter() - t0
    n_k1 = ipm_leg.launches
    s = v.get("summary", {})
    log(f"[drift] 22c tools/drift_smoke on {dev.type} (eps {DRIFT_EPS}): "
        f"{wall:.1f} s, generations {s.get('generations')} "
        f"({s.get('delta_publishes')} delta, failures "
        f"{s.get('failures')}), requests {v.get('served')} served, "
        f"{v.get('dropped')} dropped, {v.get('torn')} torn, versions "
        f"{len(v.get('versions_served', []))}; staleness p50/p99 "
        f"{v.get('staleness_p50_s')} / {v.get('staleness_p99_s')} s; "
        f"request p50/p99 {v.get('request_p50_ms')} / "
        f"{v.get('request_p99_ms')} ms; demand leaves "
        f"{v.get('demand_leaves')}, trace phases {v.get('trace_phases')}, "
        f"SLO compliance {v.get('slo_compliance')}; K1 launches {n_k1}")
    if v["failures"]:
        fail("22c: " + "; ".join(v["failures"]))
    if dev.type == "cuda" and n_k1 <= 0:
        fail("22c: the service's rebuilds launched no K1")
    return {"drift_launches": n_k1,
            "drift_staleness_p50_s": v["staleness_p50_s"],
            "drift_staleness_p99_s": v["staleness_p99_s"],
            "drift_request_p50_ms": v["request_p50_ms"],
            "drift_request_p99_ms": v["request_p99_ms"]}


def robustness_phase(dev, res, n_k1: int, tmp: str) -> dict:
    """Phase 22 (22a-22c); returns the kernels line's ipm_leg keys."""
    t0 = time.perf_counter()
    out = chaos_phase(dev, tmp)
    out.update(supervised_flagship(dev, res, n_k1, tmp))
    out.update(drift_phase(dev, tmp))
    log(f"[robust] phase 22 took {time.perf_counter() - t0:.1f} s")
    return out


def robustness_only() -> int:
    """Phase 22 alone, for iterating on the card: the kernels built, a
    flagship build standing in for phase 3's, then 22a-22c.

        python3 -c "import sys, chip_smoke as c; sys.exit(c.robustness_only())"
    """
    import torch

    from explicit_hybrid_mpc_tpu_torch import kernels
    from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
    from explicit_hybrid_mpc_tpu_torch.oracle import ipm_leg
    from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
        build_partition)
    from explicit_hybrid_mpc_tpu_torch.problems.registry import make

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    kernels.build()
    log(f"[build] kernels in {time.perf_counter() - t0:.1f} s")
    ipm_leg.launches = 0
    res = build_partition(make("inverted_pendulum"), PartitionConfig(
        problem="inverted_pendulum", eps_a=1e-2))
    n_k1 = ipm_leg.launches
    log(f"[main] build: regions {res.stats['regions']}, K1 {n_k1}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_robust_") as tmp:
        out = robustness_phase(dev, res, n_k1, tmp)
    log(json.dumps(out))
    return 0


# -- phase 23: the operator's tools (the fleet smoke in both modes, the
# watchdog over live and stopped card builds, the report over the card's
# own streams, the preflight battery) ---------------------------------------

#: 23a: tools/fleet_smoke at the JAX script's defaults (the tier-1 DI
#: fixture, eps 0.2, 64 simplices a batch, checkpoints every 4 steps).
FLEET_EPS = 0.2
FLEET_BATCH = 64
FLEET_TIMEOUT_S = 300.0
#: 23b: the watched builds (the same fixture through `main --obs jsonl`),
#: the stall rule for the stopped one, and the watcher's wall limit.
WATCH_STALL_S = 3.0
WATCH_MAX_WALL_S = 300.0
WATCH_POLL_S = 0.005
#: 23d: the preflight run.  tier1 is not asked for: it holds the port
#: against the JAX package, which the card's machine does not have
#: (preflight lists it under not_run); the chaos suite is 22a's and the
#: drift smoke 22c's.
PREFLIGHT_ARGV = ["--only", "lint"]


def fleet_smoke_phase(dev, tmp: str) -> dict:
    """23a: tools/fleet_smoke.py on `dev`'s backend in both modes, every
    child through counted_cli: the supervised chain killed at its 2nd
    checkpoint boundary (its two streams reconciled bit-exactly with the
    single-process build, the tree node for node), then --sharded (two
    shards, the sharded counters bit-equal, the tree canonically the
    single process's, `obs_report --fleet --strict` exit 0).  Fails on
    any failure of the smoke and, on the card, on a process that launched
    no K1."""
    from types import SimpleNamespace

    from explicit_hybrid_mpc_tpu_torch.tools import fleet_smoke

    args = SimpleNamespace(eps=FLEET_EPS, batch=FLEET_BATCH,
                           backend=dev.type, timeout=FLEET_TIMEOUT_S)
    entry = [sys.executable, "-c", _CHAOS_MAIN]
    out: dict = {}
    for mode, run in (("chain", fleet_smoke.run_chain_smoke),
                      ("sharded", fleet_smoke.run_sharded_smoke)):
        wd = os.path.join(tmp, f"23a_{mode}")
        os.makedirs(wd)
        verdict: dict = {}
        failures: list = []
        t0 = time.perf_counter()
        with k1_log_env(os.path.join(tmp, f"23a_{mode}_k1.jsonl")) as k1_log:
            rc = run(wd, args, verdict, failures, entry=entry)
        wall = time.perf_counter() - t0
        k1 = {}
        for rec in k1_records(k1_log, partial=False):
            k1.setdefault(os.path.basename(_output_of(rec["argv"])),
                          []).append(rec["k1"])
        builds = {k: verdict[k] for k in ("reference", "fleet", "sharded")
                  if k in verdict}
        log(f"[operator] 23a tools/fleet_smoke {mode} on {dev.type} (eps "
            f"{FLEET_EPS}, batch {FLEET_BATCH}): exit {rc} in {wall:.1f} "
            f"s, {verdict.get('regions')} regions, "
            f"{verdict.get('n_fleet_streams')} streams, obs_report --fleet "
            f"--strict exit {verdict.get('obs_report_rc')}; builds "
            + json.dumps(builds, default=str) + "; reconciliation "
            + json.dumps(verdict.get("reconciliation")) + "; tree diffs "
            f"{verdict.get('tree_diffs')}; K1 launches by process {k1}")
        if rc or failures:
            fail(f"23a ({mode}): exit {rc}; " + "; ".join(failures))
        n_proc = 3  # the reference, then two restarts or two shards
        if dev.type == "cuda" and (sum(len(v) for v in k1.values()) != n_proc
                                   or not all(all(v) for v in k1.values())):
            fail(f"23a ({mode}): K1 launches by process {k1}, expected "
                 f"{n_proc} processes each with a launch")
        out[f"fleet_{mode}_k1_launches"] = k1
        out[f"fleet_{mode}_wall_s"] = wall
        out[f"fleet_{mode}_dir"] = wd
    return out


def _watched_build(dev, prefix: str, k1_log: str):
    """`main` on the DI fixture (the chaos suite's build argv) with --obs
    jsonl through counted_cli, as a child process; (process, stream
    path)."""
    from explicit_hybrid_mpc_tpu_torch.tools import chaos_suite

    argv = chaos_suite.build_argv(prefix, FLEET_EPS, FLEET_BATCH,
                                  dev.type) + ["--obs", "jsonl"]
    env = dict(os.environ, **{K1_LOG_ENV: k1_log})
    env["PYTHONPATH"] = _root() + os.pathsep + env.get("PYTHONPATH", "")
    with open(prefix + ".log", "wb") as f:
        proc = subprocess.Popen([sys.executable, "-c", _CHAOS_MAIN] + argv,
                                cwd=_root(), env=env, stdout=f,
                                stderr=subprocess.STDOUT)
    return proc, prefix + ".obs.jsonl"


def _wait_for(pred, proc, what: str, limit_s: float) -> None:
    t0 = time.perf_counter()
    while not pred():
        if proc.poll() is not None or time.perf_counter() - t0 > limit_s:
            fail(f"23b: {what} never came (the build exited "
                 f"{proc.poll()})")
        time.sleep(WATCH_POLL_S)


def _has_step(path: str) -> bool:
    if not os.path.exists(path):
        return False
    with open(path) as f:
        return '"build.step"' in f.read()


def watch_phase(dev, tmp: str) -> dict:
    """23b: tools/obs_watch.py following two live builds of the DI
    fixture on `dev`: one to its build.done (the watcher must return 0),
    one stopped with SIGSTOP after its first build.step record and
    watched with stall_s WATCH_STALL_S (the watcher must return 2 with
    health.stall), then terminated.  Each build's K1 launches through
    counted_cli."""
    import io
    import signal

    from explicit_hybrid_mpc_tpu_torch.tools import obs_watch

    k1_log = os.path.join(tmp, "23b_k1.jsonl")
    out: dict = {}
    # The followed build: the watcher starts as soon as the stream exists.
    live = os.path.join(tmp, "23b_live")
    proc, path = _watched_build(dev, live, k1_log)
    _wait_for(lambda: os.path.exists(path), proc, "the live stream",
              WATCH_MAX_WALL_S)
    t0 = time.perf_counter()
    rc, mon = obs_watch.watch(path, interval=0.05,
                              max_wall=WATCH_MAX_WALL_S, out=io.StringIO())
    watch_s = time.perf_counter() - t0
    build_rc = proc.wait(timeout=WATCH_MAX_WALL_S)
    summ = mon.summary()
    log(f"[operator] 23b obs_watch following a live build on {dev.type}: "
        f"exit {rc} after {watch_s:.1f} s, {summ['n_records']} records, "
        f"{summ['n_events']} health events, verdict {summ['worst']}; the "
        f"build exited {build_rc}")
    if rc != 0 or build_rc != 0:
        fail(f"23b: the watcher of the live build exited {rc} "
             f"({[e['name'] for e in mon.events]}), the build {build_rc}")
    out["watch_live_records"] = summ["n_records"]
    out["watch_live_dir"] = live

    # The stopped build: frozen mid-run, the stall rule must fire.
    stopped = os.path.join(tmp, "23b_stopped")
    proc, spath = _watched_build(dev, stopped, k1_log)
    _wait_for(lambda: _has_step(spath), proc, "a build.step record",
              WATCH_MAX_WALL_S)
    os.kill(proc.pid, signal.SIGSTOP)
    try:
        t0 = time.perf_counter()
        rc, mon = obs_watch.watch(spath, rules={"stall_s": WATCH_STALL_S},
                                  interval=0.1, max_wall=WATCH_MAX_WALL_S,
                                  out=io.StringIO())
        watch_s = time.perf_counter() - t0
    finally:
        proc.terminate()
        os.kill(proc.pid, signal.SIGCONT)
        try:
            build_rc = proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            build_rc = proc.wait(timeout=60)
    names = [e["name"] for e in mon.events]
    summ = mon.summary()
    log(f"[operator] 23b obs_watch --rule stall_s={WATCH_STALL_S:g} over "
        f"the build stopped after its first build.step: exit {rc} after "
        f"{watch_s:.1f} s, events {names}, {summ['n_records']} records; "
        f"the build terminated (exit {build_rc})")
    if rc != 2 or "health.stall" not in names:
        fail(f"23b: the watcher of the stopped build exited {rc} with "
             f"{names}, expected 2 with health.stall")
    k1 = {os.path.basename(_output_of(r["argv"])): r["k1"]
          for r in k1_records(k1_log, partial=False)}
    log(f"[operator] 23b K1 launches by build {k1}")
    if dev.type == "cuda" and k1.get("23b_live", 0) <= 0:
        fail(f"23b: the live build launched no K1 ({k1})")
    out["watch_k1_launches"] = k1
    return out


def report_phase(dev, tmp: str, fleet: dict, watched: dict) -> dict:
    """23c: tools/obs_report.py over the card's own streams: 23b's live
    build and 23a's single-process reference (regions equal to their
    .stats.json, `--drift` against itself with no flag, the JSON's bench
    null), and `--fleet --strict` over 23a's per-process streams of both
    modes (exit 0, two streams)."""
    import contextlib
    import glob
    import io

    from explicit_hybrid_mpc_tpu_torch.tools import obs_report

    def quiet(argv):
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            rc = obs_report.main(argv)
        return rc, buf.getvalue()

    streams = {"23b live": (watched["watch_live_dir"] + ".obs.jsonl",
                            watched["watch_live_dir"] + ".stats.json")}
    ref = os.path.join(fleet["fleet_chain_dir"], "straight")
    (ref_stream,) = glob.glob(ref + ".obs.p*.jsonl")
    streams["23a reference"] = (ref_stream, ref + ".stats.json")
    out: dict = {}
    for name, (path, stats_path) in streams.items():
        j = path + ".report.json"
        rc, text = quiet([path, "--drift", path, "--strict", "--json", j])
        with open(j) as f:
            doc = json.load(f)
        with open(stats_path) as f:
            st = json.load(f)
        rep = doc["report"]
        regions = rep.get("build", {}).get("regions")
        log(f"[operator] 23c obs_report {name}: exit {rc}, regions "
            f"{regions} (.stats.json {st['regions']}), bench "
            f"{doc['bench']}, drift {doc['drift']} flags "
            f"{doc['drift_flags']}; " + " | ".join(text.splitlines()[:4]))
        if rc != 0 or regions != st["regions"] or doc["bench"] is not None \
                or doc["drift_flags"] or doc["bench_flags"] \
                or doc["drift"].get("compiled_shapes") is None:
            fail(f"23c: the report of {name} (exit {rc}, regions "
                 f"{regions} against {st['regions']}, bench {doc['bench']},"
                 f" drift {doc['drift']}, flags {doc['drift_flags']} "
                 f"{doc['bench_flags']})")
        out[f"report_{name.split()[1]}_regions"] = regions
    for mode, stem in (("chain", "fleet"), ("sharded", "sharded")):
        pat = os.path.join(fleet[f"fleet_{mode}_dir"],
                           f"{stem}.obs.p*.jsonl")
        j = os.path.join(tmp, f"23c_{mode}.json")
        rc, text = quiet([pat, "--fleet", "--strict", "--json", j])
        with open(j) as f:
            frep = json.load(f)["fleet"]
        log(f"[operator] 23c obs_report --fleet --strict over 23a's "
            f"{mode} streams: exit {rc}, {frep['n_streams']} streams, "
            f"sharded {frep['sharded']}, issues {frep['issues']}, rollup "
            f"regions {frep['rollup']['regions']} (sum "
            f"{frep['rollup']['regions_sum']})")
        if rc != 0 or frep["n_streams"] != 2 or frep["issues"]:
            fail(f"23c: obs_report --fleet --strict over 23a's {mode} "
                 f"streams exited {rc} ({frep['n_streams']} streams, "
                 f"{frep['issues']})")
    return out


def preflight_phase(dev, tmp: str) -> dict:
    """23d: tools/preflight.py with PREFLIGHT_ARGV on `dev`'s backend: the
    verdict ok, each check's exit 0 and wall logged."""
    import contextlib
    import io

    from explicit_hybrid_mpc_tpu_torch.tools import preflight

    out_dir = os.path.join(tmp, "23d")
    with contextlib.redirect_stdout(io.StringIO()):
        rc = preflight.main(PREFLIGHT_ARGV + ["--backend", dev.type,
                                              "--out-dir", out_dir])
    with open(os.path.join(out_dir, "preflight.json")) as f:
        v = json.load(f)
    log(f"[operator] 23d tools/preflight {' '.join(PREFLIGHT_ARGV)} on "
        f"{dev.type}: exit {rc}, ok {v['ok']} in {v['wall_s']} s; "
        + ", ".join(f"{c['name']} exit {c['exit']} in {c['wall_s']} s"
                    for c in v["checks"])
        + f"; not run: {sorted(v['not_run'])}")
    if rc != 0 or not v["ok"] or not v["checks"] \
            or any(c["exit"] != 0 for c in v["checks"]):
        tails = []
        for c in v["checks"]:
            if c["exit"] != 0:
                with open(c["log"], "rb") as f:
                    tails.append(f.read()[-1500:].decode(errors="replace"))
        fail(f"23d: preflight exited {rc}: {v['checks']} {tails}")
    return {"preflight_walls_s": {c["name"]: c["wall_s"]
                                  for c in v["checks"]}}


def operator_tools_phase(dev, tmp: str) -> dict:
    """Phase 23 (23a-23d); returns the kernels line's ipm_leg keys."""
    t0 = time.perf_counter()
    fleet = fleet_smoke_phase(dev, tmp)
    watched = watch_phase(dev, tmp)
    out = {k: v for k, v in {**fleet, **watched}.items()
           if not k.endswith("_dir")}
    out.update(report_phase(dev, tmp, fleet, watched))
    out.update(preflight_phase(dev, tmp))
    out["operator_wall_s"] = time.perf_counter() - t0
    log(f"[operator] phase 23 took {out['operator_wall_s']:.1f} s")
    return out


def operator_tools_only() -> int:
    """Phase 23 alone, for iterating on the card: the kernels built,
    then 23a-23d.

        python3 -c "import sys, chip_smoke as c; sys.exit(c.operator_tools_only())"
    """
    import torch

    from explicit_hybrid_mpc_tpu_torch import kernels

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    kernels.build()
    log(f"[build] kernels in {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_operator_") as tmp:
        out = operator_tools_phase(dev, tmp)
    log(json.dumps(out))
    return 0


# -- phase 24: the capture tools (precision_check, tune_schedule,
# onset_probe, long_build), each tool a process of its own ------------------

_COUNTED_TOOL = ("import sys, chip_smoke; "
                 "sys.exit(chip_smoke.counted_tool(sys.argv[1:]))")
CAPTURE_TIMEOUT_S = 900.0
#: 24a: tools/precision_check at the JAX script's defaults (the flagship
#: pendulum, eps 0.1, 256 points; PREC_ENV adds knobs), on the device and,
#: as the reference, on the CPU at the same seed (precision_reference:
#: the whole script starts it before phase 23 and it shares the host with
#: phases 23 and 24).  Every phase-24 child runs its CPU work on at most
#: CAPTURE_THREADS threads, so that two children never ask for more
#: threads than the host has cores.  The JAX package's CPU capture
#: (artifacts/precision_cpu.json): regions and tree nodes of its mixed and
#: f64 builds.
PREC_ENV: dict = {}
CAPTURE_THREADS = 4
PREC_JAX_BUILDS = {"mixed": (2146, 4288), "f64": (2150, 4296)}
PREC_TOL = 0.02
#: The acceptance step alone at phase 14's sub-boxes ("5b": K1's large
#: path, "4c": its general path), at this many thetas (256 and 432 QPs;
#: the CPU reference, in the same background process as precision_check's,
#: spends about a minute on the 5b grid), and the path each must launch
#: on the card.
PREC_SUBBOXES = (
    ("5b", "quadrotor", (("param", "pv"), ("pos_box", 0.4),
                         ("vel_box", 0.2)), "large"),
    ("4c", "satellite", (("axes", 3), ("omega_box", 0.03),
                         ("h_box", 0.3)), "general"))
PREC_SUBBOX_POINTS = 16
#: K1's float32 leg timed alone (f32_leg_cells) at the shapes 24a's builds
#: give it -- the flagship's point (5, 35) and joint (8, 39) QPs, the 5b
#: and 4c point QPs -- on F32_K QPs as qp_solve hands them to the leg,
#: F32_ITERS iterations (the mixed schedule's float32 share).
F32_K = 256
F32_ITERS = 20
#: How the float32 leg is held against its plain version on those inputs.
#: Float32 iterates near an IPM's end move with the last bits of every
#: operation (the joint QPs are elastic, rho 1e4, with a 1e-9 ridge; most
#: random point QPs are infeasible and diverge), so the limits come from
#: two witnesses of how far the plain leg itself moves on the same rows:
#: the plain leg on the CPU (another summation order; after F32_ITERS only
#: on the first F32_CPU_ROWS rows the plain leg on the card finishes,
#: since on all 256 it takes about a minute at 5b and half one at 4c),
#: and the plain leg on the card with q, A and b moved by one float32 ulp
#: (F32_ULP_SEED).
#: After F32_SHORT_ITERS iteration, before that movement compounds, every
#: row is held: the kernel's largest relative gap to the plain leg at most
#: F32_SHORT_X times the witnesses' largest.  After F32_ITERS: the rows
#: more than F32_OFF apart at most F32_ROWS_X times the witnesses' (as a
#: share of the rows each compares) plus max(2, 2% of the rows); the
#: kernel's count of finite rows as far from the plain leg's as F32_ROWS_X
#: times the moved inputs' plus that; and against the float64 iterates
#: from the same start (the plain leg in float64), the kernel's rows more
#: than F32_OFF apart at most F32_ROWS_X times the plain float32 leg's
#: share plus that.
F32_SHORT_ITERS = 1
F32_SHORT_X = 10.0
F32_OFF = 1e-3
F32_ROWS_X = 2
F32_ULP_SEED = 24
F32_CPU_ROWS = 64
#: The float64 iterations that polish the row the kernel puts farthest
#: from its plain version, from each leg's result (the mixed schedule's
#: float64 share): logged, to show whether the two starts end alike.
F32_POLISH_ITERS = 10
#: 24b: tools/tune_schedule at the JAX script's defaults (the flagship,
#: 512 points, eps 0.2; TUNE_ENV adds knobs).
TUNE_ENV: dict = {}
#: 24c: tools/onset_probe's default families over their whole ladders
#: (ONSET_ENV adds knobs), each build's budget, and the JAX package's
#: regions a rung as (least, most) over its own CPU runs under precision
#: mixed on two hosts: artifacts/onset_probes.json (29 / 96 / 1,208 for
#: the quadrotor), and `BENCH_PLATFORM=cpu ONSET_FAMILIES=quadrotor
#: ONSET_BUDGET=900 python3 scripts/onset_probe.py` run twice on another
#: host, 24 / 96 / 1,253 both times (PERF.md section 6; the script takes
#: no seed).  The quadrotor's float32 leg goes non-finite on about a
#: fifth of its joint QPs, a different fifth in each implementation
#: (ROADMAP section C), and the reference's own mixed trees differ
#: between those two hosts.  A rung is held to that span within
#: 2% or 1 region, whichever is larger (exact ties in a vertex's best
#: commutation).
#: Only the quadrotor's top rung (248.6 s in the JAX capture) may be cut
#: by its budget.
ONSET_ENV: dict = {}
ONSET_BUDGET_S = 90
ONSET_JAX_REGIONS = {"satellite": ((720, 720), (1224, 1224), (7744, 7744)),
                     "quadrotor": ((24, 29), (96, 96), (1208, 1253))}
ONSET_MAY_TRUNCATE = ("quadrotor", 0.1)
#: The K1 path each family's QPs take (satellite nz 24, quadrotor nz 60).
ONSET_PATHS = {"satellite": "general", "quadrotor": "large"}
#: 24d: tools/long_build on the flagship at eps 0.1 (22b holds a killed
#: and resumed flagship at phase 3's eps 1e-2), checkpointed every 5 of
#: its 26 steps, its batch and depth at PartitionConfig's defaults; the
#: first process is SIGKILLed after its 2nd progress row and a second one
#: resumes it.  Held to LONG_REF (regions within 2%, uncertified at
#: most): the port's CPU build at these settings, 2,158 regions and 0
#: uncertified (`main -e inverted_pendulum -a 0.1 --batch 256
#: --max-depth 40 --backend cpu`).
LONG_ENV = {"LONG_EPS": "0.1", "LONG_CKPT_EVERY": "5",
            "LONG_BATCH": "256", "LONG_MAX_DEPTH": "40"}
LONG_KILL_AFTER_ROWS = 2
LONG_REF = (2158, OTHER_UNCERTIFIED_MAX)
CAPTURE_POLL_S = 0.05


def _tool_child(dev, name: str, argv: list, env_extra: dict, tmp: str,
                tag: str):
    """One counted_tool child (`name` with `argv`, on `dev`'s backend
    unless argv names one, on CAPTURE_THREADS threads), its output in
    <tmp>/<tag>.log; the process."""
    env = dict(os.environ, **{K1_LOG_ENV: os.path.join(tmp, "24_k1.jsonl")},
               OMP_NUM_THREADS=str(CAPTURE_THREADS), **env_extra)
    env["PYTHONPATH"] = _root() + os.pathsep + env.get("PYTHONPATH", "")
    if "--backend" not in argv:
        argv = ["--backend", dev.type] + argv
    with open(os.path.join(tmp, f"{tag}.log"), "wb") as f:
        return subprocess.Popen(
            [sys.executable, "-c", _COUNTED_TOOL, name] + argv,
            cwd=_root(), env=env, stdout=f, stderr=subprocess.STDOUT)


def _tool_done(proc, tmp: str, tag: str, what: str) -> int:
    """Waits for a _tool_child; fails the phase when it outlives
    CAPTURE_TIMEOUT_S (the process killed first), with the log's tail."""
    try:
        return proc.wait(CAPTURE_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        with open(os.path.join(tmp, f"{tag}.log"), "rb") as f:
            tail = f.read()[-2000:].decode(errors="replace")
        fail(f"{what}: no exit within {CAPTURE_TIMEOUT_S:.0f} s\n{tail}")


def _tool_k1(tmp: str, pid: int) -> list:
    """The K1 records (counted_tool) of process `pid`, in order."""
    return k1_records(os.path.join(tmp, "24_k1.jsonl"), pid=pid)


def _read_json(path: str) -> dict | None:
    """A tool's JSON, or None while it is absent or half written."""
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _k1_text(k1: dict) -> str:
    return ", ".join(
        f"{k} {v['launches']}" + (f" ({v['ms']:.2f} ms)" if v["ms"]
                                  is not None else "")
        for k, v in k1.items()) or "none"


def _need_k1(what: str, k1: dict, paths, dtypes=("float32", "float64")):
    """On the card: fail unless the kernel ran at every one of `paths` in
    every one of `dtypes`."""
    for p in paths:
        for d in dtypes:
            if not k1.get(f"cuda:{p}:{d}", {}).get("launches"):
                fail(f"{what}: K1's {p} path never launched in {d} "
                     f"({_k1_text(k1)})")


def _tool_failed(what: str, rc: int, res: dict | None, tmp: str,
                 tag: str) -> None:
    if res is None or "error" in res:
        with open(os.path.join(tmp, f"{tag}.log"), "rb") as f:
            tail = f.read()[-3000:].decode(errors="replace")
        fail(f"{what}: exit {rc}, error "
             f"{(res or {}).get('error', 'no JSON written')}\n{tail}")


def leg_rows(xs, ys):
    """Per row of two legs' (z, s, lam): whether each finished (every
    entry finite), and the largest |x - y| / (1 + |y|) over the three in
    f64 where both did (0 elsewhere)."""
    import torch

    fx, fy = (torch.stack([torch.isfinite(t).all(1) for t in v]).all(0)
              for v in (xs, ys))
    gap = torch.stack([((x.double() - y.double()).abs()
                        / (1 + y.double().abs())).amax(1)
                       for x, y in zip(xs, ys)]).amax(0)
    return fx, fy, torch.where(fx & fy, gap, torch.zeros_like(gap))


def f32_leg_verdict(label: str, short: dict, long: dict) -> dict:
    """24a's hold on K1's float32 leg at one shape.  `short` and `long`:
    the legs' (z, s, lam) after F32_SHORT_ITERS and F32_ITERS iterations
    on the same inputs, by name: "kernel", "plain" (its plain version on
    the card) and the witnesses "plain_cpu" and "plain_ulp" (see
    F32_SHORT_X; a row the CPU witness did not run is NaN); `long` also
    holds "f64", the plain leg in float64 from the same start.  Fails where the kernel leaves a row unfinished after
    the short leg that the plain leg finishes, where its short gap
    exceeds F32_SHORT_X times the witnesses' largest, or where its rows
    apart, its finite count or its rows apart from the float64 iterates
    after the long leg exceed what the witnesses allow; returns the
    figures."""
    import math

    K = short["plain"][0].shape[0]
    slack = max(2, math.ceil(0.02 * K))
    v: dict = {}
    for n, legs in (("short", short), ("long", long)):
        fk, fp, gk = leg_rows(legs["kernel"], legs["plain"])
        v[n] = {"finite": {"kernel": int(fk.sum()), "plain": int(fp.sum())},
                "max_gap": {"kernel": float(gk.max())},
                "apart": {"kernel": int((gk > F32_OFF).sum())},
                "rows": {"kernel": int((fk & fp).sum())}}
        if n == "short":
            v[n]["lost"] = int((fp & ~fk).sum())
        for w in ("plain_cpu", "plain_ulp"):
            fw, _fp, gw = leg_rows(legs[w], legs["plain"])
            v[n]["finite"][w] = int(fw.sum())
            v[n]["max_gap"][w] = float(gw.max())
            v[n]["apart"][w] = int((gw > F32_OFF).sum())
            v[n]["rows"][w] = int((fw & fp).sum())
    sh, lo = v["short"], v["long"]
    fk, fp, gk = leg_rows(long["kernel"], long["plain"])
    fk64, _f, gk64 = leg_rows(long["kernel"], long["f64"])
    fp64, _f, gp64 = leg_rows(long["plain"], long["f64"])
    far = int(gk.argmax())
    lo["to_f64"] = {"kernel": int((gk64 > F32_OFF).sum()),
                    "plain": int((gp64 > F32_OFF).sum()),
                    "rows_kernel": int(fk64.sum()),
                    "rows_plain": int(fp64.sum()),
                    "max_kernel": float(gk64.max()),
                    "max_plain": float(gp64.max()),
                    "farthest_row": far, "farthest_kernel": float(gk64[far]),
                    "farthest_plain": float(gp64[far])}
    wit = ("plain_cpu", "plain_ulp")
    v["short_limit"] = F32_SHORT_X * max(sh["max_gap"][w] for w in wit)
    v["apart_limit"] = F32_ROWS_X * lo["rows"]["kernel"] * max(
        lo["apart"][w] / max(1, lo["rows"][w]) for w in wit) + slack
    v["finite_limit"] = F32_ROWS_X * abs(
        lo["finite"]["plain_ulp"] - lo["finite"]["plain"]) + slack
    t64 = lo["to_f64"]
    v["f64_limit"] = F32_ROWS_X * t64["rows_kernel"] * t64["plain"] / max(
        1, t64["rows_plain"]) + slack
    if sh["lost"]:
        fail(f"24a K1 float32 leg {label}: after {F32_SHORT_ITERS} "
             f"iteration the kernel leaves {sh['lost']} rows unfinished that "
             "its plain version finishes")
    if sh["max_gap"]["kernel"] > v["short_limit"]:
        fail(f"24a K1 float32 leg {label}: after {F32_SHORT_ITERS} "
             f"iteration the kernel is {sh['max_gap']['kernel']:.3e} from "
             f"its plain version, the witnesses {sh['max_gap']} (limit "
             f"{v['short_limit']:.3e})")
    if lo["apart"]["kernel"] > v["apart_limit"]:
        fail(f"24a K1 float32 leg {label}: after {F32_ITERS} iterations "
             f"{lo['apart']['kernel']} rows lie more than {F32_OFF:g} from "
             f"the plain version, the witnesses {lo['apart']} of "
             f"{lo['rows']} (limit {v['apart_limit']:.1f})")
    if abs(lo["finite"]["kernel"] - lo["finite"]["plain"]) \
            > v["finite_limit"]:
        fail(f"24a K1 float32 leg {label}: after {F32_ITERS} iterations "
             f"finite rows {lo['finite']} (limit "
             f"{v['finite_limit']} off the plain version's)")
    if t64["kernel"] > v["f64_limit"]:
        fail(f"24a K1 float32 leg {label}: after {F32_ITERS} iterations "
             f"{t64['kernel']} of {t64['rows_kernel']} rows lie more than "
             f"{F32_OFF:g} from the float64 iterates, the plain version "
             f"{t64['plain']} of {t64['rows_plain']} (limit "
             f"{v['f64_limit']:.1f})")
    return v


def ulp_moved(args, seed: int):
    """The leg's inputs with q, A and b each moved by one float32 ulp up
    or down (random signs from `seed`, made on the host)."""
    import torch

    g = np.random.default_rng(seed)
    out = list(args)
    for i in (1, 2, 3):
        t = args[i]
        sign = torch.as_tensor(g.choice((-1.0, 1.0), t.shape),
                               dtype=t.dtype, device=t.device)
        out[i] = t * (1 + sign * 2.0 ** -24)
    return tuple(out)


def f32_leg_inputs(prob, kind: str, g, dev, K: int) -> tuple:
    """The float32 leg's inputs (Q, q, A, b, z, s, lam) as ipm.qp_solve
    hands them to it under the mixed schedule, on `dev`: K point QPs of
    `prob` at random thetas and commutations (`kind` "point") or its
    elastic joint QPs over small simplices ("joint"), drawn from `g`."""
    import torch

    from explicit_hybrid_mpc_tpu_torch.oracle import ipm, ipm_leg
    from explicit_hybrid_mpc_tpu_torch.oracle.oracle import (
        Oracle, point_qp, simplex_min_qp)
    from explicit_hybrid_mpc_tpu_torch.partition import geometry

    o = Oracle(prob, backend=dev.type, precision="mixed")
    ds = torch.as_tensor(g.integers(0, prob.canonical.n_delta, K),
                         device=dev)
    lb, ub = prob.theta_lb, prob.theta_ub
    if kind == "point":
        th = torch.as_tensor(g.uniform(lb, ub, (K, prob.n_theta)),
                             device=dev)
        qp = point_qp(o.prob, th, ds)
    else:
        lo = lb + 0.8 * (ub - lb) * g.random((K, prob.n_theta))
        Ms = np.stack([geometry.barycentric_matrix(np.vstack(
            [v, v + 0.1 * np.diag(ub - lb)])) for v in lo])
        qp = simplex_min_qp(o.prob, torch.as_tensor(Ms, device=dev), ds)
    keep: dict = {}
    name = "ipm_leg_cuda" if dev.type == "cuda" else "ipm_leg_torch"
    real = getattr(ipm_leg, name)

    def capture(Q, q, A, b, z, s, lam, n_iter):
        if Q.dtype == torch.float32:
            keep["args"] = tuple(t.clone() for t in (Q, q, A, b, z, s, lam))
        return real(Q, q, A, b, z, s, lam, n_iter)
    setattr(ipm_leg, name, capture)
    try:
        ipm.qp_solve(*qp, n_iter=o.n_iter, n_f32=o.n_f32)
    finally:
        setattr(ipm_leg, name, real)
    return keep["args"]


def f32_leg_cells(dev) -> list:
    """On the card, K1's float32 leg at each F32 shape: its inputs
    captured from ipm.qp_solve's float32 call (random thetas or small
    simplices of the problem, F32_K QPs), F32_ITERS iterations timed by
    CUDA events (the timed launch bitwise the wrapper's) beside the
    plain version's time and the bound at the float32 rate, and the
    kernel held against its plain version after F32_SHORT_ITERS and
    F32_ITERS iterations by f32_leg_verdict."""
    import torch

    from explicit_hybrid_mpc_tpu_torch.oracle import ipm_leg
    from explicit_hybrid_mpc_tpu_torch.problems.registry import make

    if dev.type != "cuda":
        return []
    g = np.random.default_rng(SEED + 24)
    pend = make("inverted_pendulum")
    cases = [("flagship point", pend, "point"),
             ("flagship joint", pend, "joint")] + [
        (f"{tag} point", make(name, **dict(args)), "point")
        for tag, name, args, _path in PREC_SUBBOXES]
    rows = []
    real = ipm_leg.ipm_leg_cuda
    for label, prob, kind in cases:
        args = f32_leg_inputs(prob, kind, g, dev, F32_K)
        K, nz = args[1].shape
        nc = args[3].shape[1]
        lib = ipm_leg._lib()
        launch, out = raw_leg(lib.ipm_leg_f32, args, F32_ITERS)
        launch()
        wrapped = real(*args, F32_ITERS)
        torch.cuda.synchronize()
        if not all(a.view(torch.int32).equal(b.view(torch.int32))
                   for a, b in zip(out, wrapped)):
            fail(f"24a K1 float32 leg {label}: the timed launch is not "
                 "bitwise the wrapper's")
        host = tuple(t.cpu() for t in args)
        moved = ulp_moved(args, F32_ULP_SEED)
        legs = {}
        for n in (F32_SHORT_ITERS, F32_ITERS):
            plain = plain_leg(args, n)
            rows_p = torch.stack([torch.isfinite(t).all(1)
                                  for t in plain]).all(0).nonzero()[:, 0]
            rows_p = (torch.arange(K, device=dev) if n == F32_SHORT_ITERS
                      else rows_p[:F32_CPU_ROWS])
            cpu = tuple(torch.full_like(t, float("nan")) for t in plain)
            if rows_p.numel():
                on_cpu = plain_leg(tuple(t[rows_p.cpu()] for t in host), n)
                for c, t in zip(cpu, on_cpu):
                    c[rows_p] = t.to(dev)
            legs[n] = {"kernel": out if n == F32_ITERS else real(*args, n),
                       "plain": plain, "plain_cpu": cpu,
                       "plain_ulp": plain_leg(moved, n)}
        legs[F32_ITERS]["f64"] = plain_leg(tuple(t.double() for t in args),
                                           F32_ITERS)
        torch.cuda.synchronize()
        v = f32_leg_verdict(f"{label} ({nz}, {nc})", legs[F32_SHORT_ITERS],
                            legs[F32_ITERS])
        ms = cuda_time(launch, 10)
        plain_ms = cuda_time(lambda: plain_leg(args, F32_ITERS), 1, 0)
        nbytes, flops = ipm_leg_cost(K, nz, nc, F32_ITERS, 4)
        bound = 1e3 * max(nbytes / PEAK_BYTES_S, flops / PEAK_F32_S)
        by = "bytes" if nbytes / PEAK_BYTES_S > flops / PEAK_F32_S \
            else "operations"
        sh, lg = v["short"], v["long"]
        rows.append({"label": label, "nz": nz, "nc": nc, "K": K,
                     "n_iter": F32_ITERS, "path": k1_path(nz, nc),
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": by, "library_ms": None, "held": v})
        log(f"[capture] 24a K1 float32 leg, {label} QPs ({nz}, {nc}), K "
            f"{K}, {F32_ITERS} iterations ({k1_path(nz, nc)} path): kernel "
            f"{ms:.4f} ms (CUDA events, 10 launches), plain version "
            f"{plain_ms:.2f} ms, bound {bound:.5f} ms ({by}, float32 "
            f"{PEAK_F32_S / 1e12:.0f} TFLOP/s)")
        log(f"[capture]   against the plain version on the card, witnesses "
            f"the plain version on the CPU / on inputs one ulp moved: after "
            f"{F32_SHORT_ITERS} iteration largest gap kernel "
            f"{sh['max_gap']['kernel']:.3e}, witnesses "
            f"{sh['max_gap']['plain_cpu']:.3e} / "
            f"{sh['max_gap']['plain_ulp']:.3e} (limit "
            f"{v['short_limit']:.3e}); after {F32_ITERS}: finite rows kernel "
            f"{lg['finite']['kernel']}, plain {lg['finite']['plain']}, "
            f"witnesses {lg['finite']['plain_cpu']} (of the "
            f"{min(lg['finite']['plain'], F32_CPU_ROWS)} it ran) / "
            f"{lg['finite']['plain_ulp']} of {K} (limit "
            f"{v['finite_limit']} off); rows more than {F32_OFF:g} apart "
            f"kernel {lg['apart']['kernel']} of {lg['rows']['kernel']}, "
            f"witnesses {lg['apart']['plain_cpu']} of "
            f"{lg['rows']['plain_cpu']} / {lg['apart']['plain_ulp']} of "
            f"{lg['rows']['plain_ulp']} (limit {v['apart_limit']:.1f}); "
            "largest gap kernel "
            f"{lg['max_gap']['kernel']:.3e}, witnesses "
            f"{lg['max_gap']['plain_cpu']:.3e} / "
            f"{lg['max_gap']['plain_ulp']:.3e}")
        t64 = lg["to_f64"]
        far = t64["farthest_row"]
        objs = []
        for start in (legs[F32_ITERS]["kernel"], legs[F32_ITERS]["plain"]):
            row = tuple(t[far:far + 1].double() for t in (*args[:4], *start))
            z = plain_leg(row, F32_POLISH_ITERS)[0][0]
            Q, q = row[0][0], row[1][0]
            objs.append(float(0.5 * z @ Q @ z + q @ z))
        log(f"[capture]   against the float64 iterates from the same start "
            f"(the plain version in float64): rows more than {F32_OFF:g} "
            f"apart kernel {t64['kernel']} of {t64['rows_kernel']}, plain "
            f"version {t64['plain']} of {t64['rows_plain']} (limit "
            f"{v['f64_limit']:.1f}), largest gap kernel "
            f"{t64['max_kernel']:.3e}, plain version {t64['max_plain']:.3e}; "
            f"the row the kernel lies farthest from its plain version "
            f"({t64['farthest_row']}) lies {t64['farthest_kernel']:.3e} from "
            f"the float64 iterates, the plain version "
            f"{t64['farthest_plain']:.3e}; polished in float64 for "
            f"{F32_POLISH_ITERS} iterations from each, its objective "
            f"{objs[0]!r} from the kernel's, {objs[1]!r} from the plain "
            "version's")
    return rows


def precision_phase(dev, tmp: str, ref_proc) -> dict:
    """24a: precision_check on `dev` against its run on the CPU
    (`ref_proc`, started by the caller): f32_accept_rate within PREC_TOL,
    the same verdict (regions equal, eps-sound, the exit rule), both
    builds' regions and tree nodes beside the JAX package's capture, K1
    by path and dtype; then the acceptance step at PREC_SUBBOXES on
    `dev` and on the CPU, f32_accept_rate and converged_frac within
    PREC_TOL, and on the card each sub-box's path launched in both
    dtypes."""
    from explicit_hybrid_mpc_tpu_torch.problems.registry import make
    from explicit_hybrid_mpc_tpu_torch.tools import precision_check

    on_card = dev.type == "cuda"
    t0 = time.perf_counter()
    out_dev = os.path.join(tmp, "24a_device.json")
    proc = _tool_child(dev, "precision_check",
                       ["--out", out_dev, "--sentinel",
                        os.path.join(tmp, "24a.sentinel")], PREC_ENV, tmp,
                       "24a_device")
    rc = _tool_done(proc, tmp, "24a_device", "24a precision_check")
    wall = time.perf_counter() - t0
    res = _read_json(out_dev)
    _tool_failed("24a precision_check", rc, res, tmp, "24a_device")
    k1 = _tool_k1(tmp, proc.pid)[-1]
    rc_ref = _tool_done(ref_proc, tmp, "24a_cpu", "24a precision_check on "
                        "the CPU")
    ref = _read_json(os.path.join(tmp, "24a_cpu.json"))
    _tool_failed("24a precision_check on the CPU", rc_ref, ref, tmp,
                 "24a_cpu")
    verdict = {}
    for name, r, c in (("device", res, rc), ("cpu", ref, rc_ref)):
        verdict[name] = (r.get("mixed_vs_f64_regions_equal"),
                         r.get("mixed_eps_sound"), c)
        log(f"[capture] 24a precision_check ({r['problem']}, "
            f"{r['sampled_instances']} instances) on {name} "
            f"({r['platform']}): f32_accept_rate {r['f32_accept_rate']} "
            f"(converged {r['f32_accept_rate_converged']}), converged_frac "
            f"mixed {r['mixed_kkt']['converged_frac']} / f64 "
            f"{r['f64_kkt']['converged_frac']}, max |dobj| "
            f"{r['max_obj_diff_mixed_vs_f64']}; builds "
            + ", ".join(f"{p} {b['regions']} regions / {b['tree_nodes']} "
                        f"nodes in {b['wall_s']} s"
                        for p, b in r["builds"].items())
            + f" (the JAX package's CPU capture: "
            + ", ".join(f"{p} {n[0]} / {n[1]}"
                        for p, n in PREC_JAX_BUILDS.items())
            + f"); regions_equal {verdict[name][0]}, eps_sound "
            f"{verdict[name][1]} {r.get('mixed_sound_sampled')}, exit "
            f"{c}")
    log(f"[capture] 24a K1 on {dev.type} (the whole process, {wall:.1f} "
        f"s): {_k1_text(k1['k1_by'])}; by build: " + "; ".join(
            f"{b['regions']} regions: {_k1_text(b['k1_by'])}"
            for b in k1["builds"]))
    gap = abs(res["f32_accept_rate"] - ref["f32_accept_rate"])
    if gap > PREC_TOL:
        fail(f"24a: f32_accept_rate {res['f32_accept_rate']} on {dev.type} "
             f"against {ref['f32_accept_rate']} on the CPU")
    if verdict["device"] != verdict["cpu"]:
        fail(f"24a: the verdict on {dev.type} {verdict['device']} is not "
             f"the CPU's {verdict['cpu']} (regions_equal, eps_sound, exit)")
    if on_card:
        _need_k1("24a", k1["k1_by"], ("register",))
    out = {"prec_accept": res["f32_accept_rate"],
           "prec_accept_cpu": ref["f32_accept_rate"],
           "prec_verdict": list(verdict["device"]),
           "prec_builds": {p: [b["regions"], b["tree_nodes"]]
                           for p, b in res["builds"].items()},
           "prec_k1": k1["k1_by"], "prec_wall_s": wall}
    with open(os.path.join(tmp, "24a_subbox_cpu.json")) as f:
        sub_ref = json.load(f)
    for tag, name, args, path in PREC_SUBBOXES:
        prob = make(name, **dict(args))
        with K1Tally() as t:
            acc = precision_check.acceptance(prob, dev, PREC_SUBBOX_POINTS)
        sub_k1 = t.summary()
        acc_ref = sub_ref[tag]
        c, c_ref = (a["mixed_kkt"]["converged_frac"] for a in (acc, acc_ref))
        log(f"[capture] 24a acceptance step at {tag} ({name} "
            f"{dict(args)}, nz {prob.canonical.nz}, nc {prob.canonical.nc}, "
            f"{acc['sampled_instances']} instances): f32_accept_rate "
            f"{acc['f32_accept_rate']} on {dev.type}, "
            f"{acc_ref['f32_accept_rate']} on the CPU; converged_frac mixed "
            f"{c} / {c_ref}, f64 {acc['f64_kkt']['converged_frac']} / "
            f"{acc_ref['f64_kkt']['converged_frac']}; K1 {_k1_text(sub_k1)}")
        if abs(acc["f32_accept_rate"] - acc_ref["f32_accept_rate"]) \
                > PREC_TOL or abs(c - c_ref) > PREC_TOL:
            fail(f"24a {tag}: f32_accept_rate {acc['f32_accept_rate']} / "
                 f"{acc_ref['f32_accept_rate']}, converged_frac {c} / {c_ref}"
                 f" ({dev.type} / CPU) differ by more than {PREC_TOL}")
        if on_card:
            _need_k1(f"24a {tag}", sub_k1, (path,))
        out[f"prec_{tag}"] = {"accept": acc["f32_accept_rate"],
                              "accept_cpu": acc_ref["f32_accept_rate"],
                              "converged": c, "converged_cpu": c_ref,
                              "k1": sub_k1}
    out["prec_f32_cells"] = f32_leg_cells(dev)
    return out


def tune_phase(dev, tmp: str) -> dict:
    """24b: tune_schedule on `dev`: the seven rows, the fastest schedule
    that keeps parity, the all-f64 row's µs a QP beside the fastest
    mixed row's.  No bar on speed; fails on an error, and on the card
    unless K1 ran in both dtypes."""
    t0 = time.perf_counter()
    path = os.path.join(tmp, "24b.json")
    proc = _tool_child(dev, "tune_schedule",
                       ["--out", path, "--sentinel",
                        os.path.join(tmp, "24b.sentinel")], TUNE_ENV, tmp,
                       "24b")
    rc = _tool_done(proc, tmp, "24b", "24b tune_schedule")
    wall = time.perf_counter() - t0
    res = _read_json(path)
    _tool_failed("24b tune_schedule", rc, res, tmp, "24b")
    k1 = _tool_k1(tmp, proc.pid)[-1]
    rows = res["schedules"]
    for r in rows:
        log(f"[capture] 24b {json.dumps(r)}")
    ok = [r for r in rows if "error" not in r]
    f64 = [r for r in ok if r["n_f32"] == 0]
    mixed = sorted((r for r in ok if r["n_f32"] > 0),
                   key=lambda r: r["point_us_per_qp"])
    log(f"[capture] 24b tune_schedule ({res['problem']}, {res['n_points']} "
        f"points) on {dev.type} in {wall:.1f} s: fastest_parity_ok "
        f"{res.get('fastest_parity_ok')}, parity builds "
        f"{json.dumps(res.get('parity_builds'))}; point µs/QP all-f64 "
        + (f"{f64[0]['point_us_per_qp']}" if f64 else "n/a")
        + " against the fastest mixed row's "
        + (f"{mixed[0]['point_us_per_qp']} ("
           + json.dumps({k: mixed[0].get(k)
                         for k in ("n_f32", "n_f64", "point", "rescue")})
           + ")" if mixed else "n/a")
        + "; simplex µs/QP all-f64 "
        + (f"{f64[0]['simplex_us_per_qp']}" if f64 else "n/a")
        + f"; K1 {_k1_text(k1['k1_by'])}")
    if len(ok) != len(rows):
        fail(f"24b: a schedule row failed: "
             f"{[r for r in rows if 'error' in r]}")
    if dev.type == "cuda":
        _need_k1("24b", k1["k1_by"], ("register",))
    return {"tune_rows": rows,
            "tune_fastest_parity_ok": res.get("fastest_parity_ok"),
            "tune_k1": k1["k1_by"], "tune_wall_s": wall}


def onset_phase(dev, tmp: str) -> dict:
    """24c: onset_probe on `dev` under ONSET_BUDGET_S a build: every rung
    complete and within 2% (or 1 region) of ONSET_JAX_REGIONS, but for
    ONSET_MAY_TRUNCATE, which may be cut by its budget (reported); each
    build's K1 by path and dtype, and on the card each family's path in
    both dtypes."""
    t0 = time.perf_counter()
    path = os.path.join(tmp, "24c.json")
    proc = _tool_child(dev, "onset_probe",
                       ["--out", path, "--sentinel",
                        os.path.join(tmp, "24c.sentinel")],
                       {"ONSET_BUDGET": str(ONSET_BUDGET_S), **ONSET_ENV},
                       tmp, "24c")
    rc = _tool_done(proc, tmp, "24c", "24c onset_probe")
    wall = time.perf_counter() - t0
    res = _read_json(path)
    _tool_failed("24c onset_probe", rc, res, tmp, "24c")
    k1 = _tool_k1(tmp, proc.pid)[-1]
    builds = iter(k1["builds"])
    out: dict = {"onset_rows": {}, "onset_cut": []}
    for fam, rows in res["families"].items():
        ref = ONSET_JAX_REGIONS.get(fam, ())
        for i, r in enumerate(rows):
            b = next(builds)
            jax_r = ref[i] if i < len(ref) else None
            span = (None if jax_r is None else str(jax_r[0])
                    if jax_r[0] == jax_r[1] else f"{jax_r[0]}-{jax_r[1]}")
            log(f"[capture] 24c {fam} scale {r['scale']}: {r['regions']} "
                f"regions (JAX {span}), uncertified {r['uncertified']}, "
                f"truncated {r['truncated']}, volume_certified_frac "
                f"{r['volume_certified_frac']}, projected "
                f"{r['projected_full_box_regions']}, {r['wall_s']} s; K1 "
                f"{_k1_text(b['k1_by'])}")
            out["onset_rows"][f"{fam}@{r['scale']}"] = {
                "regions": r["regions"], "complete": r["complete"],
                "wall_s": r["wall_s"], "k1": b["k1_by"]}
            if not r["complete"] and (fam, r["scale"]) == ONSET_MAY_TRUNCATE \
                    and r["truncated"]:
                log(f"[capture] 24c {fam} scale {r['scale']} was cut by "
                    f"its {ONSET_BUDGET_S} s budget (not held to the JAX "
                    "rung)")
                out["onset_cut"].append(f"{fam}@{r['scale']}")
                continue
            if not r["complete"]:
                fail(f"24c {fam} scale {r['scale']}: not complete ({r})")
            if jax_r is not None and not (
                    jax_r[0] - max(1, 0.02 * jax_r[0]) <= r["regions"]
                    <= jax_r[1] + max(1, 0.02 * jax_r[1])):
                fail(f"24c {fam} scale {r['scale']}: {r['regions']} regions "
                     f"against the JAX package's {span}")
        if dev.type == "cuda" and fam in ONSET_PATHS:
            fam_k1: dict = {}
            for row in rows:
                for k, v in out["onset_rows"][
                        f"{fam}@{row['scale']}"]["k1"].items():
                    fam_k1.setdefault(k, {"launches": 0, "ms": None})
                    fam_k1[k]["launches"] += v["launches"]
            _need_k1(f"24c {fam}", fam_k1, (ONSET_PATHS[fam],))
    log(f"[capture] 24c onset_probe on {dev.type} took {wall:.1f} s; K1 "
        f"{_k1_text(k1['k1_by'])}")
    out.update(onset_k1=k1["k1_by"], onset_wall_s=wall)
    return out


def long_build_phase(dev, tmp: str) -> dict:
    """24d: long_build on the flagship (LONG_ENV), its first process
    SIGKILLed after LONG_KILL_AFTER_ROWS progress rows (SIGUSR1 first, for
    its K1 count), a second one resumed to a drained frontier: the
    regions and uncertified within LONG_REF's bar, resumed_from_step the
    last killed row's step, the progress rows continuous across the
    restart, each process's K1 and the online µs a query."""
    import signal

    t0 = time.perf_counter()
    wd = os.path.join(tmp, "24d")
    os.makedirs(wd)
    path = os.path.join(wd, "long_build.json")
    argv = ["--out", path, "--sentinel", os.path.join(wd, "sentinel")]
    proc = _tool_child(dev, "long_build", argv, LONG_ENV, tmp, "24d_1")
    rows: list = []
    while len(rows) < LONG_KILL_AFTER_ROWS:
        if proc.poll() is not None:
            fail(f"24d: the first process exited {proc.returncode} after "
                 f"{len(rows)} progress rows")
        if time.perf_counter() - t0 > CAPTURE_TIMEOUT_S:
            proc.kill()
            fail("24d: no 2nd progress row in time")
        time.sleep(CAPTURE_POLL_S)
        rows = (_read_json(path) or {}).get("progress", [])
    proc.send_signal(signal.SIGUSR1)
    while not _tool_k1(tmp, proc.pid) and proc.poll() is None:
        time.sleep(CAPTURE_POLL_S)
    proc.send_signal(signal.SIGKILL)
    proc.wait()
    killed_rows = (_read_json(path) or {}).get("progress", [])
    k1_first = (_tool_k1(tmp, proc.pid) or [{"k1_by": {}}])[-1]["k1_by"]
    t1 = time.perf_counter()
    proc2 = _tool_child(dev, "long_build", argv, LONG_ENV, tmp, "24d_2")
    rc = _tool_done(proc2, tmp, "24d_2", "24d long_build (resumed)")
    res = _read_json(path)
    _tool_failed("24d long_build (resumed)", rc, res, tmp, "24d_2")
    k1_second = _tool_k1(tmp, proc2.pid)[-1]["k1_by"]
    st = res["stats"]
    steps = [r["steps"] for r in res["progress"]]
    every = int(LONG_ENV["LONG_CKPT_EVERY"])
    log(f"[capture] 24d long_build ({res['problem']}, eps "
        f"{res['eps_a']}, {res['precision']}, checkpoints every {every} "
        f"steps) on {dev.type}: the first process SIGKILLed after "
        f"{len(killed_rows)} progress rows (steps "
        f"{[r['steps'] for r in killed_rows]}); the second resumed from "
        f"step {res.get('resumed_from_step')} to {res.get('stop_reason')} in "
        f"{time.perf_counter() - t1:.1f} s: {st['regions']} regions, "
        f"uncertified {st['uncertified']}, {st['steps']} steps, progress "
        f"steps {steps}; online {res.get('online_us_per_query')} µs/query "
        f"over {res.get('online_leaves')} leaves (descent; sharded "
        f"{res.get('online_us_per_query_sharded')}); K1 first process "
        f"{_k1_text(k1_first)}, second {_k1_text(k1_second)}")
    if res.get("stop_reason") != "drained":
        fail(f"24d: stop_reason {res.get('stop_reason')}")
    check_build("24d long_build", st, *LONG_REF)
    if res.get("resumed_from_step") != killed_rows[-1]["steps"] \
            or steps[:len(killed_rows)] != [r["steps"] for r in killed_rows] \
            or steps != list(range(every, every * len(steps) + 1, every)):
        fail(f"24d: resumed from step {res.get('resumed_from_step')}, "
             f"killed rows {[r['steps'] for r in killed_rows]}, progress "
             f"{steps}")
    if dev.type == "cuda":
        for what, k in (("first", k1_first), ("second", k1_second)):
            if not any(v["launches"] for key, v in k.items()
                       if key.startswith("cuda:")):
                fail(f"24d: the {what} process launched no K1 ({k})")
    return {"long_regions": st["regions"],
            "long_resumed_from_step": res.get("resumed_from_step"),
            "long_k1": [k1_first, k1_second],
            "long_online_us_per_query": res.get("online_us_per_query"),
            "long_wall_s": time.perf_counter() - t0}


_REFERENCE = ("import sys, chip_smoke; "
              "sys.exit(chip_smoke.reference_worker(sys.argv[1:]))")


def reference_worker(argv: list) -> int:
    """24a's CPU reference, one process: precision_check --backend cpu
    through counted_tool into <tmp>/24a_cpu.json, then the acceptance
    step on the CPU at each sub-box into <tmp>/24a_subbox_cpu.json.
    argv: tmp, then a JSON of {"points", "subboxes"} (PREC_SUBBOX_*)."""
    import torch

    from explicit_hybrid_mpc_tpu_torch.problems.registry import make
    from explicit_hybrid_mpc_tpu_torch.tools import precision_check

    tmp, spec = argv[0], json.loads(argv[1])
    rc = counted_tool(["precision_check", "--backend", "cpu", "--out",
                       os.path.join(tmp, "24a_cpu.json"), "--sentinel",
                       os.path.join(tmp, "24a_cpu.sentinel")])
    subs = {tag: precision_check.acceptance(
        make(name, **dict(args)), torch.device("cpu"), spec["points"])
        for tag, name, args, _path in spec["subboxes"]}
    with open(os.path.join(tmp, "24a_subbox_cpu.json"), "w") as f:
        json.dump(subs, f)
    return rc


def precision_reference(dev, tmp: str):
    """24a's reference (reference_worker) as a child on CAPTURE_THREADS
    threads, its output in <tmp>/24a_cpu.log; the process, which
    precision_phase waits for."""
    env = dict(os.environ, **{K1_LOG_ENV: os.path.join(tmp, "24_k1.jsonl")},
               OMP_NUM_THREADS=str(CAPTURE_THREADS), **PREC_ENV)
    env["PYTHONPATH"] = _root() + os.pathsep + env.get("PYTHONPATH", "")
    spec = json.dumps({"points": PREC_SUBBOX_POINTS,
                       "subboxes": PREC_SUBBOXES})
    with open(os.path.join(tmp, "24a_cpu.log"), "wb") as f:
        return subprocess.Popen(
            [sys.executable, "-c", _REFERENCE, tmp, spec], cwd=_root(),
            env=env, stdout=f, stderr=subprocess.STDOUT)


def capture_tools_phase(dev, tmp: str, ref_proc) -> dict:
    """Phase 24 (24b, then 24c beside 24d, then 24a) in `tmp`, beside
    24a's CPU reference `ref_proc` started earlier in the same `tmp`
    (precision_reference); returns the kernels line's ipm_leg keys."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    try:
        out = tune_phase(dev, tmp)
        # 24c and 24d hold counts and trees, no times: side by side.
        with ThreadPoolExecutor(2) as pool:
            both = [pool.submit(f, dev, tmp)
                    for f in (onset_phase, long_build_phase)]
            for f in both:
                out.update(f.result())
        out.update(precision_phase(dev, tmp, ref_proc))
    finally:
        if ref_proc.poll() is None:
            ref_proc.kill()
            ref_proc.wait()
    out["capture_wall_s"] = time.perf_counter() - t0
    log(f"[capture] phase 24 took {out['capture_wall_s']:.1f} s")
    return out


def capture_tools_only() -> int:
    """Phase 24 alone, for iterating on the card: the kernels built,
    then 24a-24d.

        python3 -c "import sys, chip_smoke as c; sys.exit(c.capture_tools_only())"
    """
    import torch

    from explicit_hybrid_mpc_tpu_torch import kernels

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    kernels.build()
    log(f"[build] kernels in {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_capture_") as tmp:
        out = capture_tools_phase(dev, tmp, precision_reference(dev, tmp))
    log(json.dumps(out))
    return 0


# -- phase 25: the bench tool (tools/bench.py), each mode a process of its
# own ---------------------------------------------------------------------

_BENCH = ("import sys, chip_smoke; "
          "sys.exit(chip_smoke.bench_worker(sys.argv[1:]))")
#: 25: tools/bench's four modes, each a child through bench_worker (K1 and
#: K2 of the bench's process counted; the multichip mode's builds each a
#: counted_cli process).  The default mode runs alone on CAPTURE_THREADS
#: threads, at the tool's card defaults; then the other three together,
#: BENCH_GROUP_THREADS threads
#: each: the rebuild at eps 0.1 (phase 15 holds the flagship's eps 9e-3
#: rebuild), the drift walk over 5 revisions, the multichip mode at its
#: defaults (the DI fixture at eps 0.2, two processes).
BENCH_MODES = (("default", [], {}),
               ("rebuild", ["--rebuild"], {"BENCH_EPS": "0.1"}),
               ("drift_walk", ["--drift-walk"], {"BENCH_DRIFT_K": "5"}),
               ("multichip", ["--multichip"], {}))
BENCH_GROUP_THREADS = 2
BENCH_TIMEOUT_S = 600.0
#: The default row's bar: regions within 2% of the JAX package's build
#: at the bench's card settings (f64, max_depth 56, 512 simplices a
#: batch: 13,152 regions, 0 uncertified, `python -m
#: explicit_hybrid_mpc_tpu.main -e inverted_pendulum -a 1e-2 --max-depth
#: 56 --precision f64 --batch 512 --backend cpu`; at max_depth 56 the
#: mode-boundary slivers certify, so it is not phase 3's 11,670 at depth
#: 40), uncertified at most phase 3's bound; the synthetic large-L tree's
#: leaves (6! x 2^11) and the drift walk's least generations.
BENCH_REF = (13152, REF_UNCERTIFIED_MAX)
BENCH_LARGE_LEAVES = 1_474_560
BENCH_DRIFT_MIN = 5
#: The multichip mode's build processes: the reference, then two shards
#: twice.
BENCH_MULTICHIP_PROCS = 5
#: The JAX package's bench history, which no child may touch.
JAX_HISTORY = "BENCH_HISTORY.jsonl"


def bench_worker(argv: list) -> int:
    """`python -m explicit_hybrid_mpc_tpu_torch.tools.bench argv` through
    `counted`, the multichip mode's builds through counted_cli: phase 25's
    children.  The default mode's large-L outputs are held to the
    synthetic tree's law (large_law) in the row's "large_l_law"."""
    from explicit_hybrid_mpc_tpu_torch.tools import bench

    large_l = bench.large_l_metrics

    def held(result, dev, obs=None):
        got = large_l(result, dev, obs=obs)
        if got is not None:
            result["large_l_law"] = large_law(
                got["table"], got["queries"],
                {k: got[k] for k in ("flat", "sharded")})
        return got
    bench.large_l_metrics = held
    entry = [sys.executable, "-c", _CHAOS_MAIN]
    return counted(lambda a: bench.main(a, entry=entry), argv,
                   {"tool": "bench", "argv": argv})


def _bench_child(dev, mode: str, argv: list, env_extra: dict, tmp: str,
                 threads: int):
    """One bench_worker child in `tmp`: its K1 records in
    25_<mode>_k1.jsonl, its history in 25_<mode>.history.jsonl, its
    BENCH_OUT copy in 25_<mode>.json, stdout in 25_<mode>.out, stderr in
    25_<mode>.log; the process."""
    def at(suffix):
        return os.path.join(tmp, f"25_{mode}{suffix}")
    env = dict(os.environ, **{K1_LOG_ENV: at("_k1.jsonl")},
               OMP_NUM_THREADS=str(threads), TMPDIR=tmp,
               BENCH_HISTORY=at(".history.jsonl"), BENCH_OUT=at(".json"),
               **env_extra)
    env["PYTHONPATH"] = _root() + os.pathsep + env.get("PYTHONPATH", "")
    argv = ["--backend", dev.type, "--sentinel", at(".sentinel")] + argv
    with open(at(".out"), "wb") as out, open(at(".log"), "wb") as err:
        return subprocess.Popen([sys.executable, "-c", _BENCH] + argv,
                                cwd=_root(), env=env, stdout=out,
                                stderr=err)


def _bench_done(proc, tmp: str, mode: str) -> tuple[int, dict]:
    """(exit code, the JSON line) of a _bench_child; fails the phase when
    it outlives BENCH_TIMEOUT_S or prints no JSON line, with its log's
    tail."""
    def tail():
        with open(os.path.join(tmp, f"25_{mode}.log"), "rb") as f:
            return f.read()[-3000:].decode(errors="replace")
    try:
        rc = proc.wait(BENCH_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        fail(f"25 bench {mode}: no exit within {BENCH_TIMEOUT_S:.0f} s\n"
             f"{tail()}")
    with open(os.path.join(tmp, f"25_{mode}.out")) as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    try:
        return rc, json.loads(lines[-1])
    except (IndexError, ValueError):
        fail(f"25 bench {mode}: exit {rc}, no JSON line\n{tail()}")


def _finite_positive(x) -> bool:
    return isinstance(x, (int, float)) and bool(np.isfinite(x)) and x > 0


def _bench_holds(mode: str, row: dict, on_card: bool, k2: int) -> list:
    """What phase 25 holds each mode's row to; the failures."""
    bad = []
    if "error" in row:
        bad.append(f"error {row['error']}")
    if mode == "default":
        ref, unc_max = BENCH_REF
        if row.get("regions") is None \
                or abs(row["regions"] - ref) > 0.02 * ref \
                or (row.get("uncertified") or 0) > unc_max \
                or row.get("truncated") is not False:
            bad.append(f"regions {row.get('regions')} (bar {ref} within "
                       f"2%), uncertified {row.get('uncertified')} (at "
                       f"most {unc_max}), truncated {row.get('truncated')}")
        path = "locate" if on_card else "descent"
        if row.get("online_path") != path or (on_card and k2 < 1):
            bad.append(f"online_path {row.get('online_path')} with {k2} "
                       f"K2 launches (expected {path})")
        if row.get("large_l_leaves") != BENCH_LARGE_LEAVES:
            bad.append(f"large_l_leaves {row.get('large_l_leaves')}")
        bad += large_law_failures(row.get("large_l_law"))
        for key in ("vs_baseline", "vs_baseline_bnb", "online_us_per_query",
                    "large_l_flat_us_per_query",
                    "large_l_sharded_us_per_query"):
            if not _finite_positive(row.get(key)):
                bad.append(f"{key} {row.get(key)}")
        tile = row.get("ipm_kernel_tile_us")
        if (on_card and not _finite_positive(tile)) \
                or (not on_card and tile is not None):
            bad.append(f"ipm_kernel_tile_us {tile}")
    elif mode == "rebuild":
        reuse = row.get("rebuild_reuse_frac")
        if not (isinstance(reuse, (int, float)) and 0 < reuse <= 1) \
                or not _finite_positive(row.get("rebuild_speedup")):
            bad.append(f"rebuild_reuse_frac {reuse}, rebuild_speedup "
                       f"{row.get('rebuild_speedup')}")
    elif mode == "drift_walk":
        if (row.get("drift_generations") or 0) < BENCH_DRIFT_MIN \
                or not all(_finite_positive(row.get(k)) for k in
                           ("staleness_p50_s", "staleness_p99_s")):
            bad.append(f"generations {row.get('drift_generations')} (at "
                       f"least {BENCH_DRIFT_MIN}), staleness p50/p99 "
                       f"{row.get('staleness_p50_s')}/"
                       f"{row.get('staleness_p99_s')}")
    elif row.get("multichip_scaling_frac") is None:
        bad.append("no multichip_scaling_frac (parity not shown)")
    return bad


def bench_phase(dev, tmp: str) -> dict:
    """Phase 25: tools/bench's default mode at full width alone, then its
    rebuild, drift-walk and multichip modes together (BENCH_MODES), each a
    process through bench_worker.  Each row held (_bench_holds), with
    exit 0, its history row appended to its own file (the summary of the
    row, key for key) and the JAX package's BENCH_HISTORY.jsonl
    unchanged byte for byte; on the card the default mode's online figure
    through K2, and K1 launched in every process (the multichip mode's
    BENCH_MULTICHIP_PROCS builds each).  Returns the kernels line's
    "bench_*" keys and "bench_history_rows" (each mode's history rows,
    which phase 27 gates)."""
    import hashlib

    from explicit_hybrid_mpc_tpu_torch.tools import bench_history

    t0 = time.perf_counter()
    on_card = dev.type == "cuda"
    jax_hist = os.path.join(_root(), JAX_HISTORY)

    def digest():
        if not os.path.exists(jax_hist):
            return None
        with open(jax_hist, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()
    before = digest()
    out: dict = {"bench_k1_launches": {}, "bench_k1_ms": {},
                 "bench_wall_s": {}}
    groups = ([(BENCH_MODES[0], CAPTURE_THREADS)],
              [(m, BENCH_GROUP_THREADS) for m in BENCH_MODES[1:]])
    for group in groups:
        t1 = time.perf_counter()
        procs = [(mode, _bench_child(dev, mode, argv, env, tmp, threads))
                 for (mode, argv, env), threads in group]
        for mode, proc in procs:
            rc, row = _bench_done(proc, tmp, mode)
            wall = time.perf_counter() - t1
            recs = k1_records(os.path.join(tmp, f"25_{mode}_k1.jsonl"),
                              partial=False)
            own = [r for r in recs if r.get("tool") == "bench"]
            builds = [r for r in recs if r.get("tool") != "bench"]
            k1_by = own[-1]["k1_by"] if own else {}
            k2 = own[-1]["k2"] if own else 0
            out["bench_k1_launches"][mode] = sum(r["k1"] for r in recs)
            out["bench_k1_ms"][mode] = own[-1]["k1_ms"] if own else None
            out["bench_wall_s"][mode] = wall
            log(f"[bench] 25 {mode}: exit {rc} in {wall:.1f} s; row "
                + json.dumps(row))
            log(f"[bench] 25 {mode}: K1 of the bench process "
                f"{_k1_text(k1_by)}, event ms "
                f"{own[-1]['k1_ms'] if own else None}; K2 {k2}"
                + (f"; K1 launches of its builds "
                   f"{[r['k1'] for r in builds]}" if builds else ""))
            bad = _bench_holds(mode, row, on_card, k2)
            if rc != 0:
                bad.append(f"exit {rc}")
            hist = bench_history.load_history(
                os.path.join(tmp, f"25_{mode}.history.jsonl"))
            out.setdefault("bench_history_rows", {})[mode] = hist
            copy = os.path.join(tmp, f"25_{mode}.json")
            want = (bench_history.summarize(
                row, copy, round(os.path.getmtime(copy), 3))
                if os.path.exists(copy) else None)
            if hist != [want]:
                bad.append(f"history {hist} against the row's summary "
                           f"{want}")
            if on_card and mode != "multichip" and not any(
                    v["launches"] for k, v in k1_by.items()
                    if k.startswith("cuda:")):
                bad.append(f"no K1 launch ({_k1_text(k1_by)})")
            if on_card and mode == "multichip" and (
                    len(builds) != BENCH_MULTICHIP_PROCS
                    or not all(r["k1"] for r in builds)):
                bad.append(f"K1 launches by build process "
                           f"{[r['k1'] for r in builds]}, expected "
                           f"{BENCH_MULTICHIP_PROCS} each with a launch")
            if mode == "default":
                out["bench_k2_launches"] = k2
                out["bench_default"] = {k: row.get(k) for k in (
                    "value", "regions", "uncertified", "vs_baseline",
                    "vs_baseline_bnb", "online_us_per_query",
                    "large_l_flat_us_per_query",
                    "large_l_sharded_us_per_query", "ipm_kernel_tile_us")}
            if bad:
                fail(f"25 bench {mode}: " + "; ".join(bad))
    if digest() != before:
        fail(f"25: {JAX_HISTORY} changed")
    out["bench_phase_s"] = time.perf_counter() - t0
    log(f"[bench] phase 25 took {out['bench_phase_s']:.1f} s; "
        f"{JAX_HISTORY} unchanged")
    return out


def bench_only() -> int:
    """Phase 25 alone, for iterating on the card: the kernels built, then
    the four modes.

        python3 -c "import sys, chip_smoke as c; sys.exit(c.bench_only())"
    """
    import torch

    from explicit_hybrid_mpc_tpu_torch import kernels

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    kernels.build()
    log(f"[build] kernels in {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_bench_") as tmp:
        out = bench_phase(dev, tmp)
    log(json.dumps(out))
    return 0


# -- phase 26: the serving bench (tools/serve_bench.py), each mode a process
# of its own ----------------------------------------------------------------

_SERVE_BENCH = ("import sys, chip_smoke; "
                "sys.exit(chip_smoke.serve_bench_worker(sys.argv[1:]))")
#: 26: tools/serve_bench at the JAX script's defaults (2 shards or 4
#: tenants, 8 clients, rates 1,000 / 4,000 / 16,000 for 2 s each), the
#: arena and the legacy sweep at depth 13: p = 2 and 2 x 2^13 = 16,384
#: leaves, the size of the flagship's table (11,674), where the JAX
#: default depth 9 gives 1,024.  One child at a time, the arena child
#: first; each runs and is held whatever the one before it showed.  The
#: skewed capture (SERVE_BENCH_SKEW) is not among them: its demand and
#: trace overhead bars (min p99 of five off/on windows a side, <= 1%)
#: read -27% to +41% between identical arms on the card at 2 s windows
#: and held in none of three runs at 4 and 6 s (PERF.md), so it would
#: fail this script in most runs; ROADMAP "The serving bench".
SERVE_BENCH_RUNS = (
    ("arena", {"SERVE_BENCH_DEPTH": "13", "SERVE_BENCH_TENANTS": "4"}),
    ("legacy", {"SERVE_BENCH_DEPTH": "13"}))
SERVE_BENCH_TIMEOUT_S = 300.0
#: The arena child's served in-box rows re-evaluated by K3's plain
#: version: at least this many (every one up to SB_PLAIN_MAX, else evenly
#: spaced), held to SB_PLAIN_TOL times max(1, |value|) -- the float32
#: products of the kernel and of the plain version, summed in another
#: order -- with the leaf ids equal where the winner clears
#: SB_PLAIN_TIE.
SB_PLAIN_MIN = 1024
SB_PLAIN_MAX = 16_384
SB_PLAIN_TOL = 1e-5
SB_PLAIN_TIE = 1e-5
SB_GRAPH_REPS = 200


class SweepRecorder:
    """In a serve_bench child: each client window's arena_eval launches
    and requests (tools/serve_bench._Clients.window), and every
    arena_eval call made inside a window (its arguments and records), for
    `hold_plain` and `time_k3` after the run.  A context manager that
    patches and restores both."""

    def __init__(self):
        self.windows: list = []
        self.calls: list = []
        self._active = False

    def __enter__(self):
        from explicit_hybrid_mpc_tpu_torch.online import fused
        from explicit_hybrid_mpc_tpu_torch.tools import serve_bench

        self._real = (serve_bench._Clients.window, fused.arena_eval)
        real_window, real_eval = self._real

        def window(clients, rate, *a, **kw):
            sched = clients.submit.__self__
            k0, r0 = fused.launches, sched.n_requests
            self._active = True
            try:
                return real_window(clients, rate, *a, **kw)
            finally:
                self._active = False
                self.windows.append({
                    "rate": rate, "k3": fused.launches - k0,
                    "requests": sched.n_requests - r0})

        def arena_eval(*args, **kw):
            rec = real_eval(*args, **kw)
            if self._active:
                self.calls.append((args, kw, rec))
            return rec

        serve_bench._Clients.window = window
        fused.arena_eval = arena_eval
        return self

    def __exit__(self, *exc) -> None:
        from explicit_hybrid_mpc_tpu_torch.online import fused
        from explicit_hybrid_mpc_tpu_torch.tools import serve_bench

        serve_bench._Clients.window, fused.arena_eval = self._real

    def hold_plain(self) -> dict | None:
        """The in-box rows served by K3 inside the windows (clamped 0),
        all up to SB_PLAIN_MAX, else evenly spaced, re-evaluated through
        fused.arena_eval_torch on the serving arena's buffers (a column a
        batch read is not written later: a publish writes free columns
        only, and nothing is published after the sweep).  None without an
        arena call."""
        import torch

        from explicit_hybrid_mpc_tpu_torch.online import fused

        if not self.calls:
            return None
        bary, U, V = self.calls[0][0][:3]
        q = torch.cat([a[3] for a, _kw, _r in self.calls], dim=1)
        ext = torch.cat([a[4] for a, _kw, _r in self.calls])
        rec = torch.cat([r for _a, _kw, r in self.calls])
        rows = torch.nonzero(rec[:, 3] == 0)[:, 0]
        if rows.numel() > SB_PLAIN_MAX:
            rows = rows[torch.linspace(0, rows.numel() - 1, SB_PLAIN_MAX,
                                       device=rows.device).long()]
        q, ext, rec = q[:, rows].contiguous(), ext[rows].contiguous(), \
            rec[rows]
        plain = fused.arena_eval_torch(bary, U, V, q, ext)
        kv, kc, ku, kcost, kcl = fused.unpack(rec)
        pv, pc, pu, pcost, pcl = fused.unpack(plain)

        def rel(a, b):
            return (a - b).abs() / b.abs().clamp(min=1)

        def most(t):
            return float(t.max()) if t.numel() else 0.0

        clear = pv > SB_PLAIN_TIE
        same = kc == pc
        diff = torch.nonzero(~same)[:, 0]
        # Where the columns differ (a tie on a shared facet), the plain
        # score at the kernel's column against the plain maximum.
        thc = torch.minimum(torch.maximum(q[0, diff], q[1, diff]),
                            q[2, diff])
        at_k = (thc.T[None] * bary[:, :, kc[diff].long()]).sum(1).amin(0)
        worst = {"val": most(rel(kv, pv)), "u": most(rel(ku, pu)[same]),
                 "cost": most(rel(kcost, pcost)[same]),
                 "tie": most(rel(at_k, pv[diff]))}
        return {
            "rows": int(rows.numel()),
            "extents": len({tuple(e) for e in ext.tolist()}),
            "clamped_differ": int((kcl != pcl).sum()),
            "tie_free": int(clear.sum()),
            "tie_free_cols_differ": int((kc != pc)[clear].sum()),
            "cols_differ": int(diff.numel()),
            "tol": SB_PLAIN_TOL, "max_rel": worst,
            "max_abs_err": max(most((kv - pv).abs()),
                               most((ku - pu)[same].abs()),
                               most((kcost - pcost)[same].abs()))}

    def time_k3(self) -> dict | None:
        """K3 at the windows' most frequent batch size, on the last such
        batch's own inputs and plan: device ms a launch by CUDA-graph
        replay (CUDA events around SB_GRAPH_REPS replayed launches), the
        plain version's ms by CUDA events, the bound.  None off the card
        or without an arena call."""
        import collections

        from explicit_hybrid_mpc_tpu_torch.online import fused

        cuda = [c for c in self.calls if c[0][0].device.type == "cuda"]
        if not cuda:
            return None
        sizes = collections.Counter(int(a[3].shape[1]) for a, _k, _r in cuda)
        B, n = sizes.most_common(1)[0]
        args = next(a for a, _k, _r in reversed(cuda)
                    if int(a[3].shape[1]) == B)
        bary, U, V, q, ext, plan, scratch = args
        pp1, n_u = int(bary.shape[0]), int(U.shape[2])
        ms = graph_time(lambda: fused.arena_eval_cuda(*args), SB_GRAPH_REPS)
        plain_ms = cuda_time(
            lambda: fused.arena_eval_torch(bary, U, V, q, ext), 20)
        nbytes, flops = arena_eval_cost(ext.cpu().numpy(), B, pp1, n_u)
        by_bytes = nbytes / PEAK_BYTES_S >= flops / PEAK_F32_S
        return {"rows": B, "batches_of_that_size": n, "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": 1e3 * max(nbytes / PEAK_BYTES_S,
                                      flops / PEAK_F32_S),
                "bound_by": "bytes" if by_bytes else "operations"}


def serve_bench_worker(argv: list) -> int:
    """`python -m explicit_hybrid_mpc_tpu_torch.tools.serve_bench argv`
    through `counted` (K3's count from zero over the process), under a
    SweepRecorder: the record adds "windows" (each window's K3 launches
    and requests), "k3_plain" (SweepRecorder.hold_plain) and "k3_time"
    (SweepRecorder.time_k3, after the run): phase 26's children."""
    from explicit_hybrid_mpc_tpu_torch.tools import serve_bench

    record = {"tool": "serve_bench", "argv": argv}

    def run(a):
        with SweepRecorder() as sweep:
            rc = serve_bench.main(a)
        record["windows"] = sweep.windows
        record["k3_plain"] = sweep.hold_plain()
        record["k3_time"] = sweep.time_k3()
        return rc

    return counted(run, argv, record)


def _serve_bench_child(dev, mode: str, env_extra: dict, tmp: str):
    """One serve_bench_worker child in `tmp`: its record in
    26_<mode>_k1.jsonl, its history in 26_<mode>.history.jsonl, its
    result in 26_<mode>.json, stdout in 26_<mode>.out, stderr in
    26_<mode>.log; the process."""
    def at(suffix):
        return os.path.join(tmp, f"26_{mode}{suffix}")
    env = dict(os.environ, **{K1_LOG_ENV: at("_k1.jsonl")}, TMPDIR=tmp,
               BENCH_HISTORY=at(".history.jsonl"),
               SERVE_BENCH_OUT=at(".json"), **env_extra)
    env["PYTHONPATH"] = _root() + os.pathsep + env.get("PYTHONPATH", "")
    with open(at(".out"), "wb") as out, open(at(".log"), "wb") as err:
        return subprocess.Popen(
            [sys.executable, "-c", _SERVE_BENCH, "--backend", dev.type],
            cwd=_root(), env=env, stdout=out, stderr=err)


def serve_bench_holds(mode: str, row: dict | None, rec: dict | None,
                      on_card: bool) -> list:
    """What phase 26 holds a child's result and record to; the failures.
    Every child: a result without `error` that holds the JAX script's
    bars (serve_bench.bars), `platform` "gpu" with `device_name` on the
    card, versions v1 and v2 seen, every rate's p99 finite.  The arena
    child on the card also: K3's launches over the windows equal to the
    scheduler's batches, each window's launches per request the row's,
    and at least SB_PLAIN_MIN served in-box rows, over every extent (the
    four tenants and t0's delta), equal to K3's plain version within
    SB_PLAIN_TOL, the leaf ids equal on tie-free rows."""
    from explicit_hybrid_mpc_tpu_torch.tools import serve_bench

    if row is None:
        return ["no result"]
    if "error" in row:
        return [f"error {row['error']}"]
    bad = serve_bench.bars(row)
    platform = "gpu" if on_card else "cpu"
    if row.get("platform") != platform or (on_card
                                           and not row.get("device_name")):
        bad.append(f"platform {row.get('platform')}, device_name "
                   f"{row.get('device_name')}")
    if row.get("versions_seen") != ["v1", "v2"]:
        bad.append(f"versions_seen {row.get('versions_seen')}")
    p99s = [r.get("p99_us") for r in row.get("rates", [])]
    if not p99s or not all(_finite_positive(x) for x in p99s):
        bad.append(f"rates' p99_us {p99s}")
    if mode != "arena" or not on_card:
        return bad
    if rec is None:
        return bad + ["no record of the child's K3 launches"]
    wins = rec.get("windows") or []
    k3 = sum(w["k3"] for w in wins)
    if k3 != row.get("batches") or k3 < 1:
        bad.append(f"K3 launched {k3} times over the sweep's windows for "
                   f"{row.get('batches')} batches")
    lpr = [round(w["k3"] / w["requests"], 4) if w["requests"] else None
           for w in wins]
    if lpr != [r.get("launches_per_req") for r in row.get("rates", [])] \
            or row.get("batch_launches_per_req") != (lpr or [None])[-1]:
        bad.append(f"K3 launches per request by window {lpr}, the row's "
                   f"{[r.get('launches_per_req') for r in row['rates']]} "
                   f"(top {row.get('batch_launches_per_req')})")
    held = rec.get("k3_plain")
    if held is None:
        return bad + ["K3 was not held to its plain version"]
    tenants = row.get("tenants") or 0
    if held["rows"] < SB_PLAIN_MIN or held["extents"] != tenants + 1 \
            or held["clamped_differ"] or held["tie_free_cols_differ"] \
            or not max(held["max_rel"].values()) <= SB_PLAIN_TOL:
        bad.append(f"K3 against its plain version: {held['rows']} rows "
                   f"(at least {SB_PLAIN_MIN}) over {held['extents']} "
                   f"extents ({tenants + 1}), clamped flags differ on "
                   f"{held['clamped_differ']}, columns differ on "
                   f"{held['tie_free_cols_differ']} tie-free rows, "
                   f"relative gaps {held['max_rel']} (at most "
                   f"{SB_PLAIN_TOL})")
    return bad


def serve_bench_phase(dev, tmp: str) -> dict:
    """Phase 26: tools/serve_bench's arena and legacy sweeps
    (SERVE_BENCH_RUNS), one serve_bench_worker child at a time, so that
    no two sweeps share the card.  Each held (serve_bench_holds), with
    exit 0 and its history row appended to its own file (the summary of
    the result, key for key); the JAX package's BENCH_HISTORY.jsonl
    unchanged byte for byte.  Every child runs; the phase fails once,
    after the last, naming every child's failures.  Prints each result
    without its rates, the rates' rows, K3's launches and ms a launch at
    the arena run's most frequent batch size, and each child's wall.
    Returns the kernels line's "serve_bench_*" keys of K3's entry and
    "serve_bench_history_rows" (each child's history rows, which phase 27
    gates)."""
    import hashlib

    from explicit_hybrid_mpc_tpu_torch.tools import bench_history

    t0 = time.perf_counter()
    on_card = dev.type == "cuda"
    jax_hist = os.path.join(_root(), JAX_HISTORY)

    def digest():
        if not os.path.exists(jax_hist):
            return None
        with open(jax_hist, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()
    before = digest()
    out: dict = {"serve_bench_wall_s": {}}
    failures = []
    for mode, env_extra in SERVE_BENCH_RUNS:
        def at(suffix, mode=mode):
            return os.path.join(tmp, f"26_{mode}{suffix}")
        t1 = time.perf_counter()
        proc = _serve_bench_child(dev, mode, env_extra, tmp)
        try:
            rc = proc.wait(SERVE_BENCH_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = None
        wall = time.perf_counter() - t1
        out["serve_bench_wall_s"][mode] = wall
        row = _read_json(at(".json"))
        recs = k1_records(at("_k1.jsonl"), partial=False)
        rec = recs[-1] if recs else None
        bad = serve_bench_holds(mode, row, rec, on_card)
        if rc != 0:
            with open(at(".log"), "rb") as f:
                tail = f.read()[-3000:].decode(errors="replace")
            bad.append(f"exit {rc} (limit {SERVE_BENCH_TIMEOUT_S:.0f} s)\n"
                       f"{tail}")
        if row is not None:
            log(f"[serve-bench] 26 {mode}: exit {rc} in {wall:.1f} s; row "
                + json.dumps({k: v for k, v in row.items() if k != "rates"}))
            for r in row.get("rates", []):
                log(f"[serve-bench] 26 {mode} rate " + json.dumps(r))
            hist = bench_history.load_history(at(".history.jsonl"))
            out.setdefault("serve_bench_history_rows", {})[mode] = hist
            want = bench_history.summarize(
                row, at(".json"), os.path.getmtime(at(".json")))
            if hist != [want]:
                bad.append(f"history {hist} against the result's summary "
                           f"{want}")
        if mode == "arena" and rec is not None:
            wins = rec.get("windows") or []
            tk = rec.get("k3_time")
            out["serve_bench_launches"] = sum(w["k3"] for w in wins)
            out["serve_bench_k3_process"] = rec.get("k3")
            out["serve_bench_plain"] = rec.get("k3_plain")
            out["serve_bench_k3"] = tk
            log(f"[serve-bench] 26 arena: K3 {out['serve_bench_launches']} "
                f"launches over the sweep's windows "
                f"({[w['k3'] for w in wins]} by window, for "
                f"{[w['requests'] for w in wins]} requests), "
                f"{rec.get('k3')} in the process (warm-up and audit "
                f"included); against its plain version "
                + json.dumps(rec.get("k3_plain")))
            if tk is not None:
                log(f"[serve-bench] 26 arena: K3 at the most frequent batch "
                    f"size {tk['rows']} ({tk['batches_of_that_size']} "
                    f"batches): {tk['ms']:.4f} ms a launch (CUDA events "
                    f"over {SB_GRAPH_REPS} graph-replayed launches), plain "
                    f"{tk['plain_ms']:.4f} ms, bound {tk['bound_ms']:.5f} "
                    f"ms ({tk['bound_by']})")
        if bad:
            log(f"[serve-bench] 26 {mode} FAILED: " + "; ".join(bad))
            failures.append(f"26 serve_bench {mode}: " + "; ".join(bad))
    if digest() != before:
        failures.append(f"26: {JAX_HISTORY} changed")
    if failures:
        fail(" | ".join(failures))
    out["serve_bench_phase_s"] = time.perf_counter() - t0
    log(f"[serve-bench] phase 26 took {out['serve_bench_phase_s']:.1f} s "
        "(walls " + ", ".join(f"{m} {w:.1f} s" for m, w in
                              out["serve_bench_wall_s"].items())
        + f"); {JAX_HISTORY} unchanged")
    return out


def serve_bench_only() -> int:
    """Phase 26 alone, for iterating on the card: the kernels built, then
    the sweeps.

        python3 -c "import sys, chip_smoke as c; sys.exit(c.serve_bench_only())"
    """
    import torch

    from explicit_hybrid_mpc_tpu_torch import kernels

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    kernels.build()
    log(f"[build] kernels in {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_bench_") as tmp:
        out = serve_bench_phase(dev, tmp)
    log(json.dumps(out))
    return 0


# -- phase 27: the bench gate (tools/bench_gate.py) over phases 25's and
# 26's history rows -------------------------------------------------------

#: 27: the power limit a row of another card setting carries.
GATE_OTHER_POWER = "350.00 W"
#: The port's history file at the repository root, which no phase writes.
TORCH_HISTORY = "BENCH_HISTORY_TORCH.jsonl"


def repo_histories() -> tuple:
    """(the JAX package's BENCH_HISTORY.jsonl digest or None, whether the
    port's BENCH_HISTORY_TORCH.jsonl exists) at the repository root."""
    import hashlib

    jax_hist = os.path.join(_root(), JAX_HISTORY)
    digest = None
    if os.path.exists(jax_hist):
        with open(jax_hist, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
    return digest, os.path.exists(os.path.join(_root(), TORCH_HISTORY))


def gate_phase(tmp: str, rows: list, default_row: dict,
               before: tuple) -> dict:
    """Phase 27: the port's gate over `rows` (phases 25's and 26's history
    rows, written to a history of its own).  A copy of phase 25's default
    row under another source gates clean against its comparable rows; a
    copy with `value` scaled to 0.8x is flagged, and as the history's
    newest row the CLI exits 1; a copy with another power limit has no
    comparable row and passes vacuously; `preflight --only bench_gate` on
    an empty history exits 0.  `before` (repo_histories() at the script's
    start): the JAX package's history unchanged byte for byte and no
    BENCH_HISTORY_TORCH.jsonl at the repository root.  Returns the walls
    and verdicts."""
    import contextlib
    import io

    from explicit_hybrid_mpc_tpu_torch.tools import bench_gate

    t0 = time.perf_counter()
    hist = os.path.join(tmp, "27.history.jsonl")
    with open(hist, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    history = bench_gate.load_history(hist)

    def copy(**kw):
        return {**default_row, "source": "27_candidate.json", **kw}
    out: dict = {"gate_rows": len(history)}
    bad = []
    flags, info = bench_gate.gate(copy(), history)
    out["gate_clean"] = [flags, info]
    if flags or not any(ln.startswith("ok value") for ln in info):
        bad.append(f"the default row's copy: flags {flags}, info {info}")
    low = copy(value=0.8 * default_row["value"])
    flags, info = bench_gate.gate(low, history)
    out["gate_low"] = flags
    if not any(f.startswith("REGRESSION value") for f in flags):
        bad.append(f"the 0.8x copy: flags {flags}, info {info}")
    low_hist = os.path.join(tmp, "27.low.history.jsonl")
    with open(low_hist, "w") as f:
        for r in rows + [low]:
            f.write(json.dumps(r) + "\n")
    cli = io.StringIO()
    with contextlib.redirect_stdout(cli):
        out["gate_low_rc"] = bench_gate.main(["--history", low_hist])
    cli_last = cli.getvalue().strip().splitlines()[-1:]
    if out["gate_low_rc"] != 1:
        bad.append(f"the CLI on the 0.8x copy exited {out['gate_low_rc']}")
    flags, info = bench_gate.gate(copy(power_limit=GATE_OTHER_POWER),
                                  history)
    out["gate_other_power"] = [flags, info]
    if flags or not any("no comparable history rows" in ln for ln in info):
        bad.append(f"the copy at {GATE_OTHER_POWER}: flags {flags}, info "
                   f"{info}")
    env = dict(os.environ, BENCH_HISTORY=os.path.join(tmp, "27.empty.jsonl"))
    env["PYTHONPATH"] = _root() + os.pathsep + env.get("PYTHONPATH", "")
    pf = subprocess.run(
        [sys.executable, "-m", "explicit_hybrid_mpc_tpu_torch.tools."
         "preflight", "--only", "bench_gate", "--out-dir",
         os.path.join(tmp, "27_preflight")], cwd=_root(), env=env,
        capture_output=True, text=True, timeout=300)
    out["gate_preflight_rc"] = pf.returncode
    if pf.returncode != 0 or "PREFLIGHT OK" not in pf.stdout:
        bad.append(f"preflight --only bench_gate on an empty history exited "
                   f"{pf.returncode}\n{pf.stdout[-2000:]}{pf.stderr[-2000:]}")
    if repo_histories() != before:
        bad.append(f"{JAX_HISTORY} changed or {TORCH_HISTORY} appeared at "
                   f"the repository root ({before} -> {repo_histories()})")
    out["gate_phase_s"] = time.perf_counter() - t0
    log(f"[gate] 27 over {len(history)} rows of phases 25 and 26: the "
        f"default row's copy {len(out['gate_clean'][1])} ok lines, no flag; "
        f"the 0.8x copy {out['gate_low']}; the 0.8x copy's CLI: "
        f"{' '.join(cli_last)}, exit {out['gate_low_rc']}; "
        f"at {GATE_OTHER_POWER}: {out['gate_other_power'][1]}; preflight "
        f"--only bench_gate on an empty history exit "
        f"{out['gate_preflight_rc']}; {JAX_HISTORY} unchanged, no "
        f"{TORCH_HISTORY}; {out['gate_phase_s']:.1f} s")
    if bad:
        fail("27 bench gate: " + "; ".join(bad))
    return out


# -- phase 28: the remaining captures (tools/north_star, bench_configs,
# eps_ladder, online_crossover), each a process of its own --------------------

_CAPTURE = ("import sys, chip_smoke; "
            "sys.exit(chip_smoke.capture_worker(sys.argv[1:]))")
#: 28: the four captures, one child at a time, each with its knobs: 28a
#: north_star at its card defaults, its parity builds at eps 2.0 (the
#: serial build of the pendulum there takes about 27 s on a CPU host, 446
#: regions; at the JAX default 0.1 it would take many minutes); 28b
#: bench_configs' rows 1 (the double integrator at eps 1e-2, built nowhere
#: else) and 2 (mass_spring, which CFG_TIME_BUDGET cuts); 28c eps_ladder
#: at its defaults; 28d online_crossover at its defaults.
CAPTURE_RUNS = (
    ("north_star", {"NS_PARITY_EPS": "2.0"}),
    ("bench_configs", {"CFG_ONLY": "double_integrator,mass_spring",
                       "CFG_TIME_BUDGET": "30"}),
    ("eps_ladder", {}),
    ("online_crossover", {}))
CAPTURE_RUN_THREADS = 2
CAPTURE_RUN_TIMEOUT_S = 600.0
#: 28b's complete row, by its label's start, and its regions: the double
#: integrator at eps 1e-2 in float64, the JAX package on the CPU:
#: `BENCH_PLATFORM=cpu CFG_ONLY=double_integrator CFG_PRECISION=f64
#: CFG_TIME_BUDGET=600 python3 scripts/bench_configs.py` (complete, 0
#: uncertified, volume 1.0); held within CFG_REF_TOL.  (None: no row
#: held so, for a rehearsal on a host that builds no such row in seconds.)
CFG_REF = ("1. ", 52374)
CFG_REF_TOL = 0.02
#: 28c and 28d: the phase's own check of each rung's and row's online
#: paths on HOLD_QUERIES seeded queries, tie-free where the f64
#: evaluator's leaf holds the query by HOLD_TIE in barycentric margin (as
#: phase 4): the descent's leaf and u (HOLD_DU) equal the evaluator's;
#: K2's leaf equal, and locate.evaluate's u and V within HOLD_REL relative
#: (x max(1, |v|)) on every query.
HOLD_QUERIES = 4096
HOLD_SEED = 28
HOLD_TIE = 1e-5
HOLD_DU = 1e-9
HOLD_REL = 1e-5


def online_held(res, problem, dev, qs=None) -> dict:
    """Phase 28's own check of a built tree's online paths: the f64
    evaluator against the descent (every device) and locate.evaluate (K2,
    the card only) on HOLD_QUERIES seeded queries (or `qs`)."""
    import torch

    from explicit_hybrid_mpc_tpu_torch.online import (descent, evaluator,
                                                      export, locate)

    table = export.export_leaves(res.tree)
    dtab = evaluator.stage(table, device=dev)
    if qs is None:
        qs = torch.as_tensor(np.random.default_rng(HOLD_SEED).uniform(
            problem.theta_lb, problem.theta_ub,
            (HOLD_QUERIES, problem.n_theta)), device=dev)
    ref = evaluator.evaluate(dtab, qs)
    th1 = torch.cat([qs, torch.ones_like(qs[:, :1])], 1)
    margin = torch.einsum("bij,bj->bi", dtab.bary_M[ref.leaf], th1).amin(1)
    clear = margin > HOLD_TIE
    dt = descent.export_descent(res.tree, res.roots, table, device=dev)
    de = descent.evaluate_descent(dt, dtab, qs)
    held = {"leaves": int(table.n_leaves), "queries": int(qs.shape[0]),
            "tie_free": int(clear.sum()),
            "descent_leaf_differ": int((de.leaf != ref.leaf)[clear].sum()),
            "descent_du": float((de.u - ref.u)[clear].abs().max())
            if bool(clear.any()) else 0.0}
    if dev.type == "cuda":
        k = locate.evaluate(locate.stage(table, device=dev), dtab, qs)

        def rel(a, b):
            return float(((a - b).abs() / b.abs().clamp(min=1.0)).max())
        held.update(
            locate_leaf_differ=int((k.leaf.long() != ref.leaf)[clear].sum()),
            locate_rel_u=rel(k.u, ref.u), locate_rel_V=rel(k.cost, ref.cost))
    return held


def parity_split(paths: dict) -> str:
    """28a's batched and serial parity trees (pickled by capture_worker)
    compared cell by cell under the canonical node identity (a node is
    its vertex bytes): the cells in one tree only, the cells a leaf in
    one and split in the other, and the leaves whose commutation
    differs."""
    import pickle

    trees = {}
    for backend, path in paths.items():
        with open(path, "rb") as f:
            trees[backend] = pickle.load(f)
    if len(trees) != 2 or "serial" not in trees:
        return f"parity trees not recorded ({sorted(paths)})"
    (bk,) = set(trees) - {"serial"}
    a, b = trees[bk], trees["serial"]

    def index(t):
        return {t.vertices[i].tobytes(): i for i in range(len(t))}
    ia, ib = index(a), index(b)
    both = set(ia) & set(ib)
    split_differs = [k for k in both if a.is_leaf(ia[k]) != b.is_leaf(ib[k])]

    def delta(t, i):
        ld = t.leaf_data[i]
        return None if ld is None else ld.delta_idx
    delta_differs = [k for k in both if a.is_leaf(ia[k]) and b.is_leaf(ib[k])
                     and delta(a, ia[k]) != delta(b, ib[k])]
    depths = sorted(int(a.depth[ia[k]]) for k in split_differs)
    return (f"cell by cell: {len(set(ia) - set(ib))} cells only in the "
            f"{bk} tree, {len(set(ib) - set(ia))} only in the serial one; "
            f"{len(split_differs)} cells a leaf in one and split in the "
            f"other (depths {depths}); {len(delta_differs)} leaves of "
            "another commutation")


def capture_worker(argv: list) -> int:
    """`python -m explicit_hybrid_mpc_tpu_torch.tools.<argv[0]> argv[1:]`
    through `counted`: phase 28's children.  eps_ladder's rungs and
    online_crossover's rows also run the phase's own check (online_held)
    after the tool's figures, into the record's "held"; a crossover row's
    K2 launches of the tool itself go in first, as "k2"."""
    import importlib

    from explicit_hybrid_mpc_tpu_torch.online import locate

    name = argv[0]
    tool = importlib.import_module(
        f"explicit_hybrid_mpc_tpu_torch.tools.{name}")
    record: dict = {"tool": name, "argv": argv[1:], "held": []}
    if name == "north_star":
        import pickle

        from explicit_hybrid_mpc_tpu_torch.partition import frontier

        build = frontier.build_partition
        eps = float(os.environ.get("NS_PARITY_EPS", "0.1"))

        def build_partition(problem, cfg, *a, **kw):
            res = build(problem, cfg, *a, **kw)
            if cfg.eps_a == eps and cfg.batch_simplices == 256:
                path = f"{os.environ[K1_LOG_ENV]}.{cfg.backend}.tree.pkl"
                with open(path, "wb") as f:
                    pickle.dump(res.tree, f)
                record.setdefault("parity_trees", {})[cfg.backend] = path
            return res
        frontier.build_partition = build_partition
    elif name == "eps_ladder":
        rung = tool.descent_row

        def descent_row(row, res, problem, dev, rng):
            rung(row, res, problem, dev, rng)
            record["held"].append(online_held(res, problem, dev))
        tool.descent_row = descent_row
    elif name == "online_crossover":
        cols = tool.columns

        def columns(row, res, qs, dev):
            from explicit_hybrid_mpc_tpu_torch.problems.registry import make

            n0 = locate.launches
            cols(row, res, qs, dev)
            k2 = locate.launches - n0
            record["held"].append({"k2": k2, **online_held(
                res, make("double_integrator"), dev, qs)})
        tool.columns = columns
    return counted(tool.main, argv[1:], record)


def _capture_child(dev, name: str, env_extra: dict, tmp: str):
    """One capture_worker child in `tmp`: its record in 28_<name>_k1.jsonl,
    its JSON in 28_<name>.json, stdout in 28_<name>.out, stderr in
    28_<name>.log; the process."""
    def at(suffix):
        return os.path.join(tmp, f"28_{name}{suffix}")
    env = dict(os.environ, **{K1_LOG_ENV: at("_k1.jsonl")}, TMPDIR=tmp,
               OMP_NUM_THREADS=str(CAPTURE_RUN_THREADS), **env_extra)
    env["PYTHONPATH"] = _root() + os.pathsep + env.get("PYTHONPATH", "")
    argv = [name, "--backend", dev.type, "--out", at(".json"),
            "--sentinel", at(".sentinel")]
    with open(at(".out"), "wb") as out, open(at(".log"), "wb") as err:
        return subprocess.Popen([sys.executable, "-c", _CAPTURE] + argv,
                                cwd=_root(), env=env, stdout=out, stderr=err)


def capture_holds(name: str, res: dict | None, rec: dict | None,
                  on_card: bool) -> list:
    """What phase 28 holds a capture's JSON and record to; the failures.
    Every capture: no `error`, `platform` "gpu" with `device_name` and
    `power_limit` on the card, and on the card K1 launched.  28a: the
    flagship to phase 25's bar (BENCH_REF, not truncated), a finite
    vs_serial_estimate, parity_ok.  28b: the row CFG_REF names complete
    with its regions within CFG_REF_TOL, a truncated row that reports a
    volume_certified_frac in [0, 1], no row's error.  28c: every rung
    complete, regions rising strictly, each rung's descent equal to the
    f64 evaluator on its tie-free queries.  28d:
    every row without error, its three columns timed (K2's on the card);
    each row's descent equal to the evaluator on tie-free queries and, on
    the card, K2 launched once a timed call plus the warm call, its leaf
    equal on tie-free queries (so locate_leaf_match_frac is 1 there) and
    locate.evaluate's u and V within HOLD_REL."""
    from explicit_hybrid_mpc_tpu_torch.tools import online_crossover

    if res is None:
        return ["no JSON"]
    if res.get("error"):
        return [f"error {res['error']}"]
    bad = []
    platform = "gpu" if on_card else "cpu"
    if res.get("platform") != platform or (on_card and not (
            res.get("device_name") and res.get("power_limit"))):
        bad.append(f"platform {res.get('platform')}, device_name "
                   f"{res.get('device_name')}, power_limit "
                   f"{res.get('power_limit')}")
    if rec is None:
        return bad + ["no record of the child's launches"]
    if on_card and not any(v["launches"] for k, v in rec["k1_by"].items()
                           if k.startswith("cuda:")):
        bad.append(f"no K1 launch ({_k1_text(rec['k1_by'])})")
    held = rec.get("held") or []

    def online_bad(h, i):
        out = []
        if not h["tie_free"] or h["descent_leaf_differ"] \
                or h["descent_du"] > HOLD_DU:
            out.append(f"{i}: descent against the f64 evaluator on "
                       f"{h['tie_free']} tie-free queries: leaves differ on "
                       f"{h['descent_leaf_differ']}, max |du| "
                       f"{h['descent_du']:.2e}")
        if on_card and (h["locate_leaf_differ"] or h["locate_rel_u"]
                        > HOLD_REL or h["locate_rel_V"] > HOLD_REL):
            out.append(f"{i}: K2 against the f64 evaluator: leaves differ "
                       f"on {h['locate_leaf_differ']} tie-free queries, "
                       f"relative u {h['locate_rel_u']:.2e}, V "
                       f"{h['locate_rel_V']:.2e}")
        return out

    if name == "north_star":
        fl, par = res.get("flagship") or {}, res.get("parity") or {}
        ref, unc_max = BENCH_REF
        if fl.get("regions") is None or abs(fl["regions"] - ref) > 0.02 * ref \
                or (fl.get("uncertified") or 0) > unc_max \
                or fl.get("truncated") is not False:
            bad.append(f"flagship regions {fl.get('regions')} (bar {ref} "
                       f"within 2%), uncertified {fl.get('uncertified')} (at "
                       f"most {unc_max}), truncated {fl.get('truncated')}")
        if not _finite_positive(fl.get("vs_serial_estimate")):
            bad.append(f"vs_serial_estimate {fl.get('vs_serial_estimate')}")
        if not par.get("parity_ok"):
            bad.append(f"parity {par}; "
                       + parity_split(rec.get("parity_trees") or {}))
    elif name == "bench_configs":
        rows = res.get("rows") or []
        label, ref = CFG_REF or ("", None)
        first = [r for r in rows if r.get("label", "").startswith(label)]
        r1 = first[0] if first else {}
        if ref is None:
            pass
        elif r1.get("truncated") is not False or r1.get("uncertified") != 0 \
                or r1.get("regions") is None \
                or abs(r1["regions"] - ref) > CFG_REF_TOL * ref:
            bad.append(f"row {label.strip()} regions {r1.get('regions')} "
                       f"(JAX {ref} within {CFG_REF_TOL:.0%}), truncated "
                       f"{r1.get('truncated')}, uncertified "
                       f"{r1.get('uncertified')}")
        cut = [r for r in rows if r.get("truncated")
               and isinstance(r.get("volume_certified_frac"), float)
               and 0.0 <= r["volume_certified_frac"] <= 1.0]
        if not cut:
            bad.append("no truncated row with a volume_certified_frac in "
                       "[0, 1]: " + json.dumps(
                           [[r.get(k) for k in ("label", "truncated",
                                                "volume_certified_frac")]
                            for r in rows]))
        errs = [r for r in rows if "error" in r]
        if errs:
            bad.append(f"rows with an error {errs}")
    elif name == "eps_ladder":
        rows = res.get("rows") or []
        regions = [r.get("regions") for r in rows]
        if not rows or not all(r.get("complete") for r in rows) \
                or any(b <= a for a, b in zip(regions, regions[1:])):
            bad.append(f"rungs complete {[r.get('complete') for r in rows]}"
                       f", regions {regions} (rising strictly)")
        for r in rows:
            if "descent_error" in r \
                    or not _finite_positive(r.get("descent_us_per_query")):
                bad.append(f"eps {r.get('eps_a')}: descent "
                           f"{r.get('descent_error')} "
                           f"{r.get('descent_us_per_query')}")
        if len(held) != len(rows):
            bad.append(f"{len(held)} rungs held of {len(rows)}")
        for r, h in zip(rows, held):
            bad += online_bad(h, f"eps {r['eps_a']}")
    else:
        rows = res.get("rows") or []
        keys = ("jax_us", "descent_us") + (("locate_us",) if on_card else ())
        for r in rows:
            if "error" in r or not all(_finite_positive(r.get(k))
                                       for k in keys):
                bad.append(f"row {r}")
        if len(held) != len(rows) or not rows:
            bad.append(f"{len(held)} rows held of {len(rows)}")
        for r, h in zip(rows, held):
            if on_card and h["k2"] != online_crossover.REPS + 1:
                bad.append(f"eps {r['eps_a']}: K2 launched {h['k2']} times "
                           f"for {online_crossover.REPS} timed calls and a "
                           "warm one")
            bad += online_bad(h, f"eps {r['eps_a']}")
    return bad


def captures_phase(dev, tmp: str) -> dict:
    """Phase 28: tools/north_star, bench_configs, eps_ladder and
    online_crossover (CAPTURE_RUNS), one capture_worker child at a time,
    each held (capture_holds) with exit 0.  Every child runs; the phase
    fails once, after the last, naming every child's failures.  Returns
    the kernels line's "captures_*" keys: K1's launches by child and K2's
    in 28d (the tool's own, the phase's checks apart)."""
    t0 = time.perf_counter()
    on_card = dev.type == "cuda"
    out: dict = {"captures_k1_launches": {}, "captures_k1_ms": {},
                 "captures_wall_s": {}}
    failures = []
    for name, env_extra in CAPTURE_RUNS:
        def at(suffix, name=name):
            return os.path.join(tmp, f"28_{name}{suffix}")
        t1 = time.perf_counter()
        proc = _capture_child(dev, name, env_extra, tmp)
        try:
            rc = proc.wait(CAPTURE_RUN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = None
        wall = time.perf_counter() - t1
        res = _read_json(at(".json"))
        recs = k1_records(at("_k1.jsonl"), partial=False)
        rec = recs[-1] if recs else None
        out["captures_wall_s"][name] = wall
        out["captures_k1_launches"][name] = rec["k1"] if rec else None
        out["captures_k1_ms"][name] = rec["k1_ms"] if rec else None
        bad = capture_holds(name, res, rec, on_card)
        if rc != 0:
            with open(at(".log"), "rb") as f:
                tail = f.read()[-3000:].decode(errors="replace")
            bad.append(f"exit {rc} (limit {CAPTURE_RUN_TIMEOUT_S:.0f} s)\n"
                       f"{tail}")
        log(f"[captures] 28 {name}: exit {rc} in {wall:.1f} s; "
            + json.dumps(res))
        if rec is not None:
            log(f"[captures] 28 {name}: K1 {_k1_text(rec['k1_by'])}; K2 "
                f"{rec['k2']}; builds "
                f"{[(b['regions'], b['truncated']) for b in rec['builds']]}"
                + (f"; held {json.dumps(rec['held'])}" if rec["held"]
                   else ""))
            if name == "online_crossover":
                out["captures_k2_launches"] = sum(h["k2"]
                                                  for h in rec["held"])
        if bad:
            log(f"[captures] 28 {name} FAILED: " + "; ".join(bad))
            failures.append(f"28 {name}: " + "; ".join(bad))
    if failures:
        fail(" | ".join(failures))
    out["captures_phase_s"] = time.perf_counter() - t0
    log(f"[captures] phase 28 took {out['captures_phase_s']:.1f} s (walls "
        + ", ".join(f"{n} {w:.1f} s" for n, w in
                    out["captures_wall_s"].items()) + ")")
    return out


def captures_only() -> int:
    """Phase 28 alone, for iterating on the card: the kernels built, then
    the four captures.

        python3 -c "import sys, chip_smoke as c; sys.exit(c.captures_only())"
    """
    import torch

    from explicit_hybrid_mpc_tpu_torch import kernels

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    kernels.build()
    log(f"[build] kernels in {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_captures_") as tmp:
        out = captures_phase(dev, tmp)
    log(json.dumps(out))
    return 0


# -- the lanes: phases 16, 20-25 and 28 beside phases 14-19 ------------------

#: From phase 14 on, three more processes run beside the script's own,
#: each its phases in order: main() keeps 14, 15, 17, 18 and 19, which
#: build on one another's results (17 on 14's unpruned builds, 19 on 15's
#: rebuild references); lane "B" runs the phases that start from a
#: flagship tree (a build of its own, as each `*_only()` runs one); lanes
#: "C" and "D" the phases that need only the kernels (D: phase 28's
#: captures, each building its own trees).  Phases 1-13 (the kernels'
#: timings, the main paths' counts) run before the lanes start and
#: phases 26 (the serving sweeps' latencies) and 27 (the gate over 25's
#: and 26's rows) after every lane has ended, alone on the card both.
LANES = {"B": ("16", "20", "21", "22"), "C": ("23", "24", "25"),
         "D": ("28",)}
#: A lane's wall limit, counted from its start.
LANE_TIMEOUT_S = 1000.0
_LANE = ("import sys, chip_smoke; "
         "sys.exit(chip_smoke.lane_worker(sys.argv[1:]))")


def lane_tree(dev):
    """Lane B's flagship build, standing in for phase 3's: the result,
    its wall, its K1 launches counted from zero, and its leaf table."""
    import torch

    from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
    from explicit_hybrid_mpc_tpu_torch.online import export
    from explicit_hybrid_mpc_tpu_torch.oracle import ipm_leg
    from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
        build_partition)
    from explicit_hybrid_mpc_tpu_torch.problems.registry import make

    problem = make("inverted_pendulum")
    cfg = PartitionConfig(problem="inverted_pendulum", eps_a=1e-2)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    ipm_leg.launches = 0
    sync()
    t0 = time.perf_counter()
    res = build_partition(problem, cfg)
    sync()
    build_s = time.perf_counter() - t0
    n_k1 = ipm_leg.launches
    log(f"[main] build {build_s:.1f} s: regions {res.stats['regions']}, "
        f"K1 {n_k1}")
    return problem, cfg, res, build_s, n_k1, export.export_leaves(res.tree)


def run_lane(name: str, dev, card: str) -> dict:
    """The phases of lane `name` (LANES) in order on `dev`, each in a
    temporary directory of its own; returns each phase's result by its
    number (16's is None)."""
    from explicit_hybrid_mpc_tpu_torch import kernels
    from explicit_hybrid_mpc_tpu_torch.analysis.recompile_guard import (
        RecompileGuard)

    phases = LANES[name]
    out: dict = {}
    if name == "B":
        problem, cfg, res, build_s, n_k1, table = lane_tree(dev)
        # Every kernel library is in this process from here on: 21c's
        # loader guard, armed here, must see none added by 21a's end.
        for lib in kernels.SOURCES:
            kernels.library(lib)
        loader_guard = RecompileGuard(watch=[kernels.loader])
        host = HostVerdict()
        for ph in phases:
            with tempfile.TemporaryDirectory(
                    prefix=f"chip_smoke_{ph}_") as tmp:
                if ph == "16":   # its parts print their own verdicts
                    out[ph] = observability_phase(dev, problem, cfg, res,
                                                  table, tmp, host)
                    continue
                if ph == "20":
                    out[ph] = multi_gpu_phase(dev, problem, cfg, res,
                                              build_s, tmp)
                elif ph == "21":
                    out[ph] = analysis_phase(dev, res, n_k1, card, tmp,
                                             loader_guard)
                else:
                    out[ph] = robustness_phase(dev, res, n_k1, tmp)
            host.end(f"phase {ph}")
        return out
    if name == "D":
        with tempfile.TemporaryDirectory(prefix="chip_smoke_captures_") \
                as tmp:
            out["28"] = captures_phase(dev, tmp)
        return out
    # Lane C: 24a's CPU reference starts before phase 23 and runs beside
    # phases 23 and 24.
    with tempfile.TemporaryDirectory(prefix="chip_smoke_capture_") as cap:
        ref_proc = precision_reference(dev, cap)
        try:
            with tempfile.TemporaryDirectory(
                    prefix="chip_smoke_operator_") as tmp:
                out["23"] = operator_tools_phase(dev, tmp)
            out["24"] = capture_tools_phase(dev, cap, ref_proc)
        finally:
            if ref_proc.poll() is None:
                ref_proc.kill()
                ref_proc.wait()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_bench_") as tmp:
        out["25"] = bench_phase(dev, tmp)
    return out


def lane_worker(argv: list) -> int:
    """A lane's process: `argv` is [lane, result path, card]; the kernels
    (built by the script's phase 1) loaded, run_lane on the card, its
    results written as JSON to the result path."""
    import torch

    from explicit_hybrid_mpc_tpu_torch import kernels

    name, path, card = argv
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    kernels.build()
    out = run_lane(name, torch.device("cuda", 0), card)
    with open(path + ".tmp", "w") as f:
        json.dump(out, f)
    os.replace(path + ".tmp", path)
    return 0


class Lanes:
    """The lanes' processes, started together (`cmds`: lane name -> argv,
    by default lane_worker's), each in a session of its own, its lines
    relayed to this process's standard output as they come, each behind
    "[lane <name>] ".  `check()` fails the script as soon as a lane has
    exited non-zero; `join()` waits for all, fails on any lane's exit
    other than 0 or past its wall limit, and returns each lane's
    results; `stop()` kills every lane's process group that still runs
    (the lane and whatever it started)."""

    def __init__(self, tmp: str, card: str, cmds: dict | None = None,
                 timeout_s: float = LANE_TIMEOUT_S):
        import threading

        self.paths = {n: os.path.join(tmp, f"lane_{n}.json") for n in LANES}
        cmds = cmds or {n: [sys.executable, "-c", _LANE, n, p, card]
                        for n, p in self.paths.items()}
        self.timeout_s = timeout_s
        self.t0 = time.perf_counter()
        self.walls: dict = {}
        env = dict(os.environ)
        env["PYTHONPATH"] = _root() + os.pathsep + env.get("PYTHONPATH", "")
        self.procs = {n: subprocess.Popen(
            argv, cwd=_root(), env=env, stdout=subprocess.PIPE,
            stderr=None, text=True, start_new_session=True)
            for n, argv in cmds.items()}
        self.relays = {n: threading.Thread(target=self._relay, args=(n, p),
                                           daemon=True)
                       for n, p in self.procs.items()}
        for t in self.relays.values():
            t.start()

    def _relay(self, name: str, proc) -> None:
        for line in proc.stdout:
            sys.stdout.write(f"[lane {name}] {line}")
            sys.stdout.flush()
        # The lane's output ends with its process: its wall.
        self.walls[name] = time.perf_counter() - self.t0

    def check(self) -> None:
        bad = {n: p.returncode for n, p in self.procs.items()
               if p.returncode not in (None, 0)}
        if bad:
            for n in bad:   # the failed lanes' last lines first
                self.relays[n].join(timeout=10)
            fail(f"lane(s) exited non-zero: {bad}")

    def join(self) -> dict:
        for n, p in self.procs.items():
            left = self.timeout_s - (time.perf_counter() - self.t0)
            try:
                p.wait(timeout=max(left, 0.1))
            except subprocess.TimeoutExpired:
                self.stop()
                fail(f"lane {n} still ran after {self.timeout_s:.0f} s")
            self.check()
        for t in self.relays.values():
            t.join(timeout=10)
        out = {}
        for n, path in self.paths.items():
            if n in self.procs:
                with open(path) as f:
                    out[n] = json.load(f)
        return out

    def stop(self) -> None:
        import signal

        for p in self.procs.values():
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
            p.wait()
        for t in self.relays.values():
            t.join(timeout=10)


def main() -> int:
    import torch

    t_script = time.perf_counter()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 2
    try:
        from explicit_hybrid_mpc_tpu_torch import kernels
        from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
        from explicit_hybrid_mpc_tpu_torch.online import (evaluator, export,
                                                          locate)
        from explicit_hybrid_mpc_tpu_torch.oracle import ipm, ipm_leg, oracle
        from explicit_hybrid_mpc_tpu_torch.partition import geometry
        from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
            build_partition)
        from explicit_hybrid_mpc_tpu_torch.problems.registry import make
    except ImportError as e:
        print(f"chip_smoke: the repository's torch package is missing "
              f"({e}); run from the repository root", file=sys.stderr)
        return 3
    # One contention monitor across the whole script: each phase's
    # timing lines are followed by the host's verdict over that phase.
    host = HostVerdict()
    # The repository's bench histories as the script found them (27).
    histories = repo_histories()
    base_src = baseline_source()
    k2_src = baseline_source(var="K2_BASELINE")
    k3_src = baseline_source(var="K3_BASELINE")

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi unavailable"

    # -- phase 1: device, versions, kernel build ---------------------------
    log(f"[device] {card}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32}")
    t0 = time.perf_counter()
    # The baselines' nvcc runs start beside the kernels' own.
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(3) as pool:
        bases = {name: pool.submit(baseline_lib, src, kernels.BUILD_DIR,
                                   kernels.NVCC_FLAGS, name)
                 for name, src in (("ipm_leg", base_src), ("locate", k2_src),
                                   ("arena_eval", k3_src)) if src}
        built = kernels.build()
        bases = {name: f.result() for name, f in bases.items()}
    log(f"[build] {len(built)} kernels and {len(bases)} baselines built in "
        f"{time.perf_counter() - t0:.1f} s (nvcc in parallel)")
    for name in built:
        for ln in ptxas_lines(name, kernels.ptxas_report.get(name, "")):
            log(f"[build] {ln}")
    base_k2, base_k3 = bases.get("locate"), bases.get("arena_eval")
    host.end("phase 1 (device, kernel build)")
    rng = np.random.default_rng(SEED)
    problem = make("inverted_pendulum")
    can = problem.canonical
    prob = oracle.to_device(can, dev)
    log(f"[problem] inverted_pendulum: n_theta={can.n_theta} "
        f"n_delta={can.n_delta} nz={can.nz} nc={can.nc}")

    # -- phase 2: K1 (ipm_leg) against its plain version -------------------
    K = 4096
    lb, ub = problem.theta_lb, problem.theta_ub
    thetas = torch.as_tensor(rng.uniform(lb, ub, (K, can.n_theta)),
                             device=dev)
    ds = torch.as_tensor(rng.integers(0, can.n_delta, K), device=dev)
    centers = rng.uniform(lb, ub, (K, can.n_theta))
    offs = rng.uniform(-1, 1, (K, can.n_theta + 1, can.n_theta)) \
        * 0.05 * (ub - lb)
    Ms = torch.as_tensor(geometry.barycentric_matrices(
        centers[:, None, :] + offs), device=dev)
    # (QPs, convergence tolerance, compared outputs).  The Farkas
    # programs carry a 1e-9 ridge on (z, theta): those coordinates are
    # free up to the ridge, so only the violation t* (the last primal
    # coordinate) and the duals -- what the certificate reads -- are
    # determined and compared.
    classes = {
        "point": (oracle.point_qp(prob, thetas, ds), 1e-8,
                  ("z", "s", "lam")),
        "simplex_min": (oracle.simplex_min_qp(prob, Ms, ds), 1e-9,
                        ("z", "s", "lam")),
        "farkas": (oracle.simplex_feas_qp(prob, Ms, ds), 1e-8,
                   ("t", "lam")),
    }
    # f64 (the main path's precision): masks equal, iterates to 1e-6
    # relative on rows converged on both (both stop at KKT residuals
    # <= 1e-8, and degenerate duals -- the Farkas programs' -- are
    # only determined to about that; observed ~1e-8 worst, 1e-12
    # typical).  mixed (20 f32 + 10 f64): the f32 leg
    # sits on the edge of float32 (ill-conditioned KKT systems near
    # convergence), so summation-order noise between two correct
    # implementations moves some rows across the f64 merit gate and
    # the tolerance; flips are counted and held to <= 2% of the rows.
    # The f32 kernel itself is held to its plain version on
    # well-conditioned QPs of the same shapes below.
    k1_err = 0.0
    for cname, (qp, tol, fields) in classes.items():
        nz, nc = qp[0].shape[-1], qp[3].shape[-1]
        for sname, sch in (("f64", dict(n_iter=30)),
                           ("mixed", dict(n_iter=10, n_f32=20))):
            gpu = ipm.qp_solve(*qp, tol=tol, **sch)
            cpu = ipm.qp_solve(*(t.cpu() for t in qp), tol=tol, **sch)
            flips = {m: int((getattr(gpu, m).cpu() != getattr(cpu, m))
                            .sum()) for m in ("converged", "feasible")}
            both = (gpu.converged.cpu() & cpu.converged).numpy()
            errs, abs_err = {}, 0.0
            for f in fields:
                a, b = ((sol.z[:, -1:] if f == "t" else getattr(sol, f))
                        .cpu().numpy()[both] for sol in (gpu, cpu))
                errs[f] = float(np.max(np.abs(a - b) / (1.0 + np.abs(b)))
                                if both.any() else 0.0)
                if f in ("z", "t") and both.any():
                    abs_err = float(np.max(np.abs(a - b)))
            log(f"[K1] {cname} nz={nz} nc={nc} {sname}: converged "
                f"{int(cpu.converged.sum())}/{K}, feasible "
                f"{int(cpu.feasible.sum())}/{K}, mask flips {flips}, max "
                f"rel err on {int(both.sum())} rows converged on both "
                + " ".join(f"{k}={v:.2e}" for k, v in errs.items()))
            if sname == "f64":
                if any(flips.values()):
                    fail(f"K1 {cname}/f64: masks differ {flips}")
                if max(errs.values()) > 1e-6:
                    fail(f"K1 {cname}/f64: iterates differ by "
                         f"{max(errs.values()):.2e} (> 1e-6 relative)")
                k1_err = max(k1_err, abs_err)
            elif max(flips.values()) > 0.02 * K:
                fail(f"K1 {cname}/mixed: {flips} mask flips (> 2%)")
    g = np.random.default_rng(SEED + 1)
    for nz, nc in sorted({(qp[0].shape[-1], qp[3].shape[-1])
                          for qp, _tol, _f in classes.values()}):
        # f64: kernel against plain to 1e-9 relative (observed 1e-13
        # to 2e-12: summation order only).  f32: both are float32
        # approximations of the float64 iterates, and their gap is
        # dominated by the few random QPs float32 resolves poorly, on
        # either side; the kernel's worst error against the float64
        # plain result is held to 4x the plain version's, plus 1e-4.
        a64 = random_qps(g, K, nz, nc, dev)
        truth = ipm_leg.ipm_leg_torch(*a64, n_iter=4)
        err64 = rel_err(ipm_leg.ipm_leg_cuda(*a64, n_iter=4), truth)
        a32 = [t.float() for t in a64]
        err_k = rel_err(ipm_leg.ipm_leg_cuda(*a32, n_iter=4), truth)
        err_p = rel_err(ipm_leg.ipm_leg_torch(*a32, n_iter=4), truth)
        log(f"[K1] bare leg nz={nz} nc={nc}, 4 iterations on random QPs: "
            f"f64 kernel vs plain {err64:.2e} (limit 1e-9); f32 vs the "
            f"f64 iterates: kernel {err_k:.2e}, plain {err_p:.2e}")
        if not err64 <= 1e-9:
            fail(f"K1 bare f64 leg differs from plain by {err64:.2e}")
        if not err_k <= 4 * err_p + 1e-4:
            fail(f"K1 bare f32 leg is worse than plain ({err_k:.2e} vs "
                 f"{err_p:.2e})")

    # K1 at the launch shapes of the flagship build: each class's QPs as
    # qp_solve hands them to the leg (equilibrated, from its cold start),
    # sliced to K.  Where K1_BASELINE names another version of
    # csrc/ipm_leg.cu, that kernel is built too and timed in turns with
    # this one (baseline, kernel, kernel, baseline) on the same inputs.
    legs = {}
    real_cuda = ipm_leg.ipm_leg_cuda
    for cname in ("point", "simplex_min", "farkas"):
        qp, tol, _f = classes[cname]
        ipm_leg.ipm_leg_cuda = record_legs(real_cuda, [], legs, cname)
        try:
            ipm.qp_solve(*qp, tol=tol, n_iter=1)
        finally:
            ipm_leg.ipm_leg_cuda = real_cuda
    base = bases.get("ipm_leg")
    leg_f64 = ipm_leg._lib().ipm_leg_f64
    log(f"[K1] sweep at the build's shapes, f64, device time of back-to-back "
        "launches" + (f", against the baseline {base_src} in turns"
                      if base else "") + f"; bounds at {PEAK_BYTES_S:.3g} B/s "
        f"and {PEAK_F64_S:.3g} FLOP/s")
    k1_entry = None
    for label, cname, n_iter in K1_CLASSES:
        full = legs[cname]
        nz, nc = full[1].shape[1], full[3].shape[1]
        for Kc in K1_SWEEP_K + ((4096,) if cname == "point"
                                and n_iter == 12 else ()):
            args = tuple(t[:Kc].contiguous() for t in full)
            nbytes, flops = ipm_leg_cost(Kc, nz, nc, n_iter, 8)
            bound = 1e3 * max(nbytes / PEAK_BYTES_S, flops / PEAK_F64_S)
            reps = 50 if Kc <= 1024 else 20
            new, new_out = raw_leg(leg_f64, args, n_iter)
            if base:
                old, old_out = raw_leg(base.ipm_leg_f64, args, n_iter)
                b1 = cuda_time(old, reps)
                m1, m2 = cuda_time(new, reps), cuda_time(new, reps)
                b2 = cuda_time(old, reps)
                ms, base_ms = (m1 + m2) / 2, (b1 + b2) / 2
                # Relative gap on the QPs whose iterates stay bounded in
                # both (infeasible ones diverge, each its own way).
                outs = list(zip(new_out, old_out))
                ok = torch.ones(Kc, dtype=torch.bool, device=dev)
                for x, y in outs:
                    ok &= (x.abs().amax(1) < 1e8) & (y.abs().amax(1) < 1e8)
                err = max(float(((x - y).abs() / (1 + y.abs()))[ok].max())
                          for x, y in outs) if ok.any() else 0.0
                vs = (f"; baseline {base_ms:.4f} ms ({b1:.4f}/{b2:.4f}), "
                      f"{base_ms / ms:.2f}x; kernel vs baseline {err:.1e} "
                      f"relative on the {int(ok.sum())} bounded QPs")
            else:
                ms, vs = cuda_time(new, reps), ""
            log(f"[K1]   {label} nz={nz} nc={nc} n_iter={n_iter} K={Kc}: "
                f"kernel {ms:.4f} ms = {1e3 * ms / n_iter:.2f} us/iteration, "
                f"bound {bound:.5f} ms{vs}")
            if label == "point phase 1" and Kc == K1_MAIN_K:
                plain_ms = cuda_time(
                    lambda: ipm_leg.ipm_leg_torch(*args, n_iter=n_iter), 3,
                    warmup=1)
                k1_entry = dict(
                    ms=ms, plain_ms=plain_ms, bound_ms=bound,
                    bound_by="bytes" if nbytes / PEAK_BYTES_S
                    > flops / PEAK_F64_S else "operations")
                log(f"[K1]   (plain version at this cell {plain_ms:.3f} ms)")
    # The cell of earlier measurements: 4,096 raw point QPs from the
    # cold start z=0, s=lam=1, 12 iterations (kept for continuity).
    Q, q, A, b = (t.contiguous() for t in classes["point"][0])
    raw = (Q, q, A, b, torch.zeros_like(q), torch.ones_like(b),
           torch.ones_like(b))
    ms = cuda_time(raw_leg(leg_f64, raw, 12)[0], 20)
    vs = ""
    if base:
        vs = (f", baseline "
              f"{cuda_time(raw_leg(base.ipm_leg_f64, raw, 12)[0], 20):.4f} ms")
    log(f"[K1] raw point QPs K={K} n_iter=12 (the earlier cell): "
        f"kernel {ms:.4f} ms{vs}")
    ora = oracle.Oracle(problem, backend="cuda", two_phase=True,
                        warm_start=True)
    # Dispatch must only enqueue device work (the build pipeline certifies
    # one batch on the host while the next solves): under the sync-debug
    # mode "error" any host-device synchronization inside it raises.
    th_d = rng.uniform(lb, ub, (256, can.n_theta))
    ds_d = rng.integers(0, can.n_delta, 256)
    ora.wait_vertices(ora.dispatch_vertices(th_d))   # warm pinned buffers
    ora.wait_pairs(ora.dispatch_pairs(th_d, ds_d))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        hv = ora.dispatch_vertices(th_d)
        hp = ora.dispatch_pairs(th_d, ds_d)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ora.wait_vertices(hv)
    ora.wait_pairs(hp)
    log("[dispatch] dispatch_vertices and dispatch_pairs enqueue without "
        "synchronizing (sync-debug mode 'error')")
    del ora
    host.end("phase 2 (K1 against its plain version)")

    # -- phase 3: the main path (build, export, stage, evaluate) -----------
    # Warm the locate kernel (module load, first launch) on a throwaway
    # table before the counts are zeroed, so the main path's one online
    # batch is timed warm and counted alone.
    warm_bary = torch.as_tensor(geometry.barycentric_matrices(
        centers[:64, None, :] + offs[:64]), dtype=torch.float32, device=dev)
    locate.locate_cuda(warm_bary, thetas[:1024])
    torch.cuda.synchronize()
    ipm_leg.launches = 0
    locate.launches = 0
    cfg = PartitionConfig(problem="inverted_pendulum", eps_a=1e-2)
    main_legs: list = []
    ipm_leg.ipm_leg_cuda = record_legs(real_cuda, main_legs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        res = build_partition(problem, cfg)
    finally:
        ipm_leg.ipm_leg_cuda = real_cuda
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    table = export.export_leaves(res.tree)
    dev_table = evaluator.stage(table, device=dev)
    ltable = locate.stage(table, device=dev)
    q_thetas = torch.as_tensor(
        rng.uniform(lb, ub, (QUERIES, can.n_theta)), device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    online = locate.evaluate(ltable, dev_table, q_thetas)
    torch.cuda.synchronize()
    online_s = time.perf_counter() - t0
    n_k1, n_k2 = ipm_leg.launches, locate.launches
    st = res.stats
    log(f"[main] build {build_s:.1f} s: regions {st['regions']}, "
        f"uncertified {st['uncertified']}, point solves "
        f"{st['point_solves']}, simplex solves {st['simplex_solves']}, "
        f"steps {st['steps']}, truncated {st['truncated']}, device "
        f"failures {st['device_failures']}, degraded "
        f"{st['device_degraded']}, quarantined {st['quarantined_cells']}")
    log("[main] build critical path (share of step wall): " + ", ".join(
        f"{k} {st[f'cp_{k}_frac']:.3f}" for k in
        ("fill", "plan", "wait", "certify", "other")
        if f"cp_{k}_frac" in st))
    log(f"[main] launches: ipm_leg {n_k1}, locate {n_k2}; online "
        f"{QUERIES} queries over {table.n_leaves} leaves in "
        f"{1e3 * online_s:.2f} ms = "
        f"{1e6 * online_s / QUERIES:.4f} us/query")
    if st["device_failures"] != 0 or st["device_degraded"] is not False \
            or st["quarantined_cells"] != 0:
        fail("the build fell back from the device (failures/degrade/"
             "quarantine must all be 0)")
    log("[legs] K1 launches of the build, recorded from ipm_leg_cuda:")
    leg_histogram(main_legs)
    if len(main_legs) != n_k1:
        fail(f"{len(main_legs)} K1 launches recorded, {n_k1} counted")
    if n_k1 <= 0 or n_k2 <= 0:
        fail(f"a kernel of the main path never launched (ipm_leg {n_k1}, "
             f"locate {n_k2})")
    if st["truncated"]:
        fail("the build was truncated")
    if abs(st["regions"] - REF_REGIONS) > 0.02 * REF_REGIONS:
        fail(f"regions {st['regions']} not within 2% of the reference "
             f"{REF_REGIONS}")
    if st["uncertified"] > REF_UNCERTIFIED_MAX:
        fail(f"uncertified {st['uncertified']} > {REF_UNCERTIFIED_MAX}")
    host.end("phase 3 (flagship build, online batch)")
    # Every kernel library is in this process from here on (built in
    # phase 1, or loaded now): phase 21c's loader guard, armed here,
    # must see none added by the time 21a has run.
    from explicit_hybrid_mpc_tpu_torch.analysis.recompile_guard import (
        RecompileGuard)

    for name in kernels.SOURCES:
        kernels.library(name)
    loader_guard = RecompileGuard(watch=[kernels.loader])

    # -- phase 4: online results against the plain f64 evaluator -----------
    ref = evaluator.evaluate(dev_table, q_thetas)
    # Tie-free queries: strictly inside the reference leaf by 1e-5 in
    # barycentric margin (float32 scores resolve shared faces either way).
    th1 = torch.cat([q_thetas, torch.ones_like(q_thetas[:, :1])], 1)
    margin = torch.einsum("bij,bj->bi", dev_table.bary_M[ref.leaf],
                          th1).amin(1)
    clear = (margin > 1e-5).cpu().numpy()
    leaf_k = online.leaf.long().cpu().numpy()
    leaf_r = ref.leaf.cpu().numpy()
    if not np.array_equal(leaf_k[clear], leaf_r[clear]):
        fail(f"online leaf ids differ on "
             f"{int((leaf_k != leaf_r)[clear].sum())} tie-free queries")
    u_err = float((online.u - ref.u)[torch.as_tensor(clear, device=dev)]
                  .abs().max())
    if not np.isfinite(online.u.cpu().numpy()).all() or u_err > 1e-9:
        fail(f"online u differs from the f64 evaluator by {u_err:.2e}")
    log(f"[online] {int(clear.sum())}/{QUERIES} tie-free queries: "
        f"leaf ids equal, max |du| {u_err:.2e}; inside "
        f"{float(online.inside.float().mean()):.4f}")

    # -- phase 5: K2 (locate) against its plain version --------------------
    L = table.n_leaves
    if L < 10_000:
        fail(f"the table has {L} leaves (< 10,000)")
    lid = rng.integers(0, L, QUERIES)
    w = rng.dirichlet(np.ones(can.n_theta + 1), QUERIES)
    w = 0.9 * w + 0.1 / (can.n_theta + 1)
    verts = np.stack([res.tree.vertices[n] for n in table.node_id])[lid]
    inner = torch.as_tensor(np.einsum("bi,bij->bj", w, verts), device=dev)
    kl, ks = locate.locate_cuda(ltable.bary, inner)
    pl_, ps = locate.locate_torch(ltable.bary, inner)
    if not torch.equal(kl, pl_):
        fail(f"K2 leaf ids differ on {int((kl != pl_).sum())} of "
             f"{QUERIES} interior queries")
    k2_err = float((ks - ps).abs().max())
    if k2_err > 1e-5:
        fail(f"K2 scores differ by {k2_err:.2e} (> 1e-5)")
    # NaN queries (either coordinate, or both): every leaf scores NaN and
    # NaN ranks first, so leaf 0, score NaN, never inside -- on the
    # kernel, on the plain version and through evaluate.
    nanq = inner[:256].clone()
    nan_rows = torch.arange(3, 256, 37, device=dev)
    nanq[nan_rows, nan_rows % 2] = float("nan")
    nanq[nan_rows[::2]] = float("nan")
    fin_rows = torch.ones(256, dtype=torch.bool, device=dev)
    fin_rows[nan_rows] = False
    nk = locate.locate_cuda(ltable.bary, nanq)
    npl = locate.locate_torch(ltable.bary, nanq)
    nev = locate.evaluate(ltable, dev_table, nanq)
    for what, (lf, sc) in (("kernel", nk), ("plain", npl)):
        if not (bool((lf[nan_rows] == 0).all())
                and bool(torch.isnan(sc[nan_rows]).all())
                and not bool(torch.isnan(sc[fin_rows]).any())):
            fail(f"K2 ({what}): a NaN query is not leaf 0 with score NaN")
    if bool(nev.inside[nan_rows].any()):
        fail(f"K2: {int(nev.inside[nan_rows].sum())} NaN queries read inside")
    if not torch.equal(nk[0][fin_rows], kl[:256][fin_rows]):
        fail("K2: the finite rows beside NaN rows changed leaf")
    log(f"[K2] {nan_rows.numel()} NaN queries (one coordinate or both): "
        "leaf 0, score NaN, not inside, on the kernel and the plain "
        "version; the finite rows beside them unchanged")
    B = QUERIES
    pp1 = can.n_theta + 1
    bary = ltable.bary
    th32 = inner.float().contiguous()

    def k2_bound(b):
        nbytes = 4.0 * (b * can.n_theta + L * pp1 * pp1 + 2 * b)
        flops = 2.0 * b * L * pp1 * pp1
        return (1e3 * max(nbytes / PEAK_BYTES_S, flops / PEAK_F32_S),
                "bytes" if nbytes / PEAK_BYTES_S > flops / PEAK_F32_S
                else "operations")

    # K2 through its C interface on fixed buffers, against the parent's
    # kernel in turns when K2_BASELINE names it (then also bitwise: leaf
    # and score on every query, all finite here).
    log(f"[K2] sweep on phase 5's interior queries, L={L}, device time by "
        "graph replay" + (f", against the baseline {k2_src} in turns"
                          if base_k2 else ""))
    k2_ms = None
    for Bs in K2_SWEEP_B:
        th = th32[:Bs]
        new, (nl, ns) = raw_k2(locate._lib(), th, bary, False)
        old = None
        if base_k2:
            old, (ol, os_) = raw_k2(base_k2, th, bary, True)
            new()
            old()
            torch.cuda.synchronize()
            if not (torch.equal(nl, ol) and torch.equal(
                    ns.view(torch.int32), os_.view(torch.int32))):
                fail(f"K2 B={Bs}: leaves or scores differ bitwise from the "
                     f"baseline on {int((nl != ol).sum())} leaves / "
                     f"{int((ns.view(torch.int32) != os_.view(torch.int32)).sum())}"
                     " scores")
        ms, _base_ms, vs = in_turns(new, old, 20)
        bound, by = k2_bound(Bs)
        log(f"[K2]   B={Bs}: kernel {ms:.4f} ms, bound {bound:.4f} ms ({by}, "
            f"{bound / ms:.2f} of it){vs}"
            + ("; leaves and scores bitwise equal to the baseline's"
               if base_k2 else ""))
        if Bs == B:
            k2_ms = ms
    k2_plain_ms = cuda_time(
        lambda: locate.locate_torch(ltable.bary, inner), 3, warmup=1)
    th1_f = torch.cat([inner.float(), torch.ones_like(inner[:, :1]).float()],
                      1)

    def library_locate():
        # One torch.matmul over every leaf row, then amin + argmax (the
        # yardstick only; the port never calls this).
        out = []
        for lo in range(0, th1_f.shape[0], 8192):
            sc = torch.matmul(th1_f[lo:lo + 8192],
                              bary.reshape(L * pp1, pp1).T)
            out.append(sc.reshape(-1, L, pp1).amin(2).argmax(1))
        return out

    k2_lib_ms = cuda_time(library_locate, 3, warmup=1)
    k2_bound_ms, k2_bound_by = k2_bound(B)
    # One counted launch (one wrapper call) is two kernels when the leaves
    # are split across blocks: locate_kernel, then locate_merge.
    k2_splits = locate.plan_splits(B, L, torch.cuda.get_device_properties(
        dev).multi_processor_count)[0]
    log(f"[K2] B={B} L={L} p+1={pp1}: leaf ids equal, max |dscore| "
        f"{k2_err:.2e}; kernel {k2_ms:.4f} ms ({k2_splits} leaf splits: "
        f"locate_kernel + locate_merge{'' if k2_splits > 1 else ' unused'}), "
        f"plain {k2_plain_ms:.3f} ms, library {k2_lib_ms:.3f} ms, bound "
        f"{k2_bound_ms:.4f} ms ({k2_bound_by})")
    host.end("phases 4-5 (online check, K2)")

    # -- phases 6-8: multi-tenant serving through the arena kernel ---------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as tmp:
        k3_entry = serve_phases(dev, res, table, rng, tmp, base_k3, k3_src)
    host.end("phases 6-8 (arena serving, K3)")

    # -- phase 9: where the device time of a build goes --------------------
    # A second flagship build, steps PROFILE_WINDOW of it under
    # torch.profiler (device activity only; profiling the whole build
    # spent four times the build in the profiler's teardown), stopped at
    # the window's end: the
    # device's busy share of that window is the summed time of every
    # CUDA kernel over its wall (one stream, so kernels do not overlap);
    # the profiler's own overhead lengthens the wall, so the share is a
    # lower bound.  K1's device time in the window is held against the
    # summed bound of the launches recorded in the same window.
    import dataclasses

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
        FrontierEngine)

    prof_legs: list = []
    window: dict = {}
    real_step = FrontierEngine.step

    def windowed_step(eng):
        if eng.steps == PROFILE_WINDOW[0]:
            torch.cuda.synchronize()
            window["prof"] = profile(activities=[ProfilerActivity.CUDA])
            window["prof"].__enter__()
            window["legs0"] = len(prof_legs)
            window["t0"] = time.perf_counter()
        real_step(eng)
        if eng.steps == PROFILE_WINDOW[1] and "t0" in window \
                and "wall" not in window:
            torch.cuda.synchronize()
            window["wall"] = time.perf_counter() - window["t0"]
            window["legs1"] = len(prof_legs)
            window["prof"].__exit__(None, None, None)

    ipm_leg.ipm_leg_cuda = record_legs(real_cuda, prof_legs)
    FrontierEngine.step = windowed_step
    torch.cuda.synchronize()
    t_prof = time.perf_counter()
    try:
        build_partition(problem, dataclasses.replace(
            cfg, max_steps=PROFILE_WINDOW[1]))
        torch.cuda.synchronize()
    finally:
        FrontierEngine.step = real_step
        ipm_leg.ipm_leg_cuda = real_cuda
        if "t0" in window and "wall" not in window:
            window["wall"] = time.perf_counter() - window["t0"]
            window["legs1"] = len(prof_legs)
            window["prof"].__exit__(None, None, None)
    prof_wall = window.get("wall")
    rows = ([(e.key, e.self_device_time_total, e.count)
             for e in window["prof"].key_averages()
             if e.device_type == DeviceType.CUDA
             and e.self_device_time_total > 0] if prof_wall else [])
    busy_us = sum(r[1] for r in rows)
    if busy_us > 0:
        log(f"[profile] steps {PROFILE_WINDOW[0] + 1}-{PROFILE_WINDOW[1]} "
            f"of a flagship build under the profiler {prof_wall:.1f} s; "
            f"device busy {busy_us / 1e6:.2f} s = "
            f"{busy_us / 1e6 / prof_wall:.3f} of the wall (idle "
            f"{1 - busy_us / 1e6 / prof_wall:.3f})")
        for key, us, n in sorted(rows, key=lambda r: -r[1])[:6]:
            log(f"[profile]   {us / 1e6:8.3f} s  {n:7d} x  {key[:70]}")
    else:
        log("[profile] the profiler recorded no device time: device busy "
            "share not measured")
    log(f"[profile] (phase took {time.perf_counter() - t_prof:.0f} s)")
    k1_rows = [r for r in rows if "ipm_leg" in r[0]]
    k1_us = sum(r[1] for r in k1_rows)
    log(f"[profile] K1 launches of the build ({len(prof_legs)}):")
    leg_histogram(prof_legs)
    win_legs = prof_legs[window.get("legs0", 0):window.get("legs1", 0)]
    log(f"[profile] K1 launches in the window ({len(win_legs)}):")
    build_bound_ms = leg_histogram(win_legs)
    build_ms = k1_us / 1e3 if k1_rows else None
    if k1_rows:
        log(f"[profile] K1 (ipm_leg) in the window: {k1_us / 1e6:.4f} s of "
            f"device time in {sum(r[2] for r in k1_rows)} launches "
            f"({len(win_legs)} recorded) = {k1_us / busy_us:.3f} of the "
            f"window's device time; {k1_us / 1e3 / build_bound_ms:.0f}x "
            f"the summed bound {build_bound_ms:.4f} ms")
    else:
        log("[profile] K1's device time in the window: not measured (no "
            "profiler row)")
    host.end("phase 9 (profiled build)")

    # -- phase 10 (K1_BASELINE only): builds with the baseline kernel -----
    if base:
        build_ab(base, problem, cfg, prob, dev)
        host.end("phase 10 (builds with the baseline kernel)")

    # -- phases 11-13: the closed loop, the serve entry point, and sharded
    # descent at a realistic size -------------------------------------------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sim_") as tmp:
        sim = closed_loop_phase(dev, problem, cfg, table, tmp)
        host.end("phase 11 (closed loop)")
        serve_entry_phase(dev, problem, cfg, res, table, rng, tmp)
        host.end("phase 12 (main serve, hot swap)")
    large_partition_phase(dev)
    host.end("phase 13 (large partition)")

    # -- phases 14-25 and 28 in four processes (LANES): this one runs 14,
    # 15, 17, 18 and 19; lane B 16 and 20-22 from a flagship build of its
    # own; lane C 23-25; lane D 28 ----------------------------------------
    import signal

    # A SIGTERM to this process unwinds it, so that the lanes are stopped.
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    lane_tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_lanes_")
    lanes = Lanes(lane_tmp.name, card)
    t_lanes = time.perf_counter()
    log("[lanes] started beside phases 14, 15, 17, 18 and 19: " + "; ".join(
        f"lane {n}, phases {', '.join(ph)}" for n, ph in LANES.items()))
    try:
        # -- phase 14: the other problems' published sub-boxes -------------
        unpruned: dict = {}
        with tempfile.TemporaryDirectory(prefix="chip_smoke_other_") as tmp:
            k1_large, k1_general = other_problems_phase(dev, tmp, unpruned,
                                                        base)
        host.end("phase 14 (other problems)")
        lanes.check()

        # -- phase 15: the warm rebuild and the rebuild service ------------
        with tempfile.TemporaryDirectory(prefix="chip_smoke_rebuild_") as tmp:
            reb = rebuild_phase(dev, problem, cfg, res, build_s, tmp)
        host.end("phase 15 (warm rebuild, service)")
        lanes.check()

        # -- phase 17: constraint-row pruning and the SOC oracle stack -----
        with tempfile.TemporaryDirectory(prefix="chip_smoke_prune_") as tmp:
            k1_pruned = pruning_soc_phase(dev, tmp, unpruned, base)
        host.end("phase 17 (pruning, SOC)")
        k1_general["builds"]["pruned"] = (
            k1_pruned["builds"].get("satellite", {}).get("k1"))
        lanes.check()

        # -- phase 18: the build's diagnostics (recorder, replay, health
        # monitor, auto-profile trigger, per-process fleet streams) -------
        with tempfile.TemporaryDirectory(prefix="chip_smoke_diag_") as tmp:
            diagnostics_phase(dev, problem, cfg, res, build_s, tmp)
        host.end("phase 18 (diagnostics)")
        lanes.check()

        # -- phase 19: the SLO engine and demand telemetry (main serve with
        # demand capture, the arena with capture and SLO tracking, the
        # hub's suboptimality re-solves through K1, the demand-ordered
        # rebuild, budget durability and the fleet fold) ------------------
        with tempfile.TemporaryDirectory(prefix="chip_smoke_slo_") as tmp:
            sd = slo_demand_phase(dev, problem, cfg, res, table, tmp,
                                  reb["refs"])
        host.end("phase 19 (SLO engine, demand telemetry)")
        k3_entry.update(sd["arena_eval"])
        t_own = time.perf_counter() - t_lanes

        # The lanes' phases: 16 (the serial baseline, profiler capture,
        # request tracing, the rebuild service's host forensics), 20
        # (multi-GPU), 21 (the recompile guard), 22 (the robustness gate),
        # 23 (the operator's tools), 24 (the capture tools), 25 (the bench
        # tool), 28 (the remaining captures).
        by_lane = lanes.join()
    finally:
        lanes.stop()
        lane_tmp.cleanup()
    lane_out = {ph: v for outs in by_lane.values() for ph, v in outs.items()}
    multi, guard, robust = lane_out["20"], lane_out["21"], lane_out["22"]
    operator, capture, bench = lane_out["23"], lane_out["24"], lane_out["25"]
    captures = lane_out["28"]
    log(f"[lanes] phases 14-25 and 28 took "
        f"{time.perf_counter() - t_lanes:.1f} s: this process's 14, 15, 17, "
        f"18, 19 {t_own:.1f} s, "
        + ", ".join(f"lane {n} {w:.1f} s" for n, w in lanes.walls.items()))
    host.end("phases 14-25 and 28 (four lanes)")
    bench_k2 = bench.pop("bench_k2_launches")
    bench_rows = bench.pop("bench_history_rows")
    captures_k2 = captures.pop("captures_k2_launches")

    # -- phase 26: the serving bench (its arena and legacy sweeps, one
    # process at a time) ----------------------------------------------------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_bench_") as tmp:
        serve = serve_bench_phase(dev, tmp)
    host.end("phase 26 (serving bench)")
    serve_rows = serve.pop("serve_bench_history_rows")

    # -- phase 27: the bench gate over phases 25's and 26's rows ------------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gate_") as tmp:
        gate_phase(tmp, [r for rows in (*bench_rows.values(),
                                        *serve_rows.values()) for r in rows],
                   bench_rows["default"][0], histories)
    host.end("phase 27 (bench gate)")
    k3_entry["max_abs_err"] = max(k3_entry["max_abs_err"],
                                  serve["serve_bench_plain"]["max_abs_err"])
    k3_entry.update(serve)

    kernels_line = {"kernels": [
        {"name": "ipm_leg", "route": "cuda",
         "source": "explicit_hybrid_mpc_tpu_torch/csrc/ipm_leg.cu",
         "replaces": "explicit_hybrid_mpc_tpu/oracle/pallas_ipm.py:217",
         "launches": n_k1, "max_abs_err": k1_err, **k1_entry,
         "library_ms": None, "build_ms": build_ms,
         "build_bound_ms": build_bound_ms,
         "build_window_steps": list(PROFILE_WINDOW),
         "sim_launches": sim["sim_k1"],
         "large": k1_large, "general": k1_general, "pruned": k1_pruned,
         **reb["ipm_leg"], **sd["ipm_leg"], **multi, **guard,
         **robust, **operator, **capture, **bench, **captures},
        {"name": "locate", "route": "cuda",
         "source": "explicit_hybrid_mpc_tpu_torch/csrc/locate.cu",
         "replaces": "explicit_hybrid_mpc_tpu/online/pallas_eval.py:111",
         "launches": n_k2, "max_abs_err": k2_err, "ms": k2_ms,
         "plain_ms": k2_plain_ms, "bound_ms": k2_bound_ms,
         "bound_by": k2_bound_by, "library_ms": k2_lib_ms,
         "splits": k2_splits, "sim_launches": sim["sim_k2"],
         "bench_launches": bench_k2, "captures_launches": captures_k2,
         **reb["locate"]},
        k3_entry,
    ], "host": host.summary()}
    log(f"[done] the script took {time.perf_counter() - t_script:.1f} s")
    log(card)
    log(json.dumps(kernels_line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
