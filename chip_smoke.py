"""End-to-end check of the torch port on one NVIDIA GPU.

    python3 chip_smoke.py                 # the whole check, one GPU

Builds the hand-written CUDA kernels from csrc/, holds each against its
plain torch version on the card, drives the port's main paths -- the
flagship inverted-pendulum partition build at eps_a=1e-2, the online
evaluation of 65,536 thetas through the point-location kernel, and
multi-tenant serving of the flagship table to four tenants from one
device arena (20,000 requests through the scheduler and the arena
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
descent at 1,474,560 synthetic leaves (flat against 8 shards, µs per
query, CUDA kernels a batch, device-resident bytes).  Phase 14 builds
the quadrotor's and the satellite's published sub-boxes through the
build CLI's main() on the card, held to the JAX package's region counts
and through the point-location kernel to the f64 host evaluator, and
holds the IPM leg's large path (nz > 32 or nc > 128, the quadrotor's
QPs) and its general path (the satellite's nz 24 / nc 96) against their
plain version.  Phase 15 drives the warm rebuild and the rebuild
service from phase 3's tree: `main rebuild --from` unchanged and at
eps_a 9e-3 (held to the JAX package's region counts, the kept leaves'
payloads bitwise, the tightened table through the point-location kernel
to the f64 host evaluator), RebuildService over two drift revisions
hot-swapping a ControllerRegistry under 16 submitting threads (no
failure, no dropped request, no torn result), and `main serve-rebuild`
once.  Any failed phase exits non-zero.  The second-to-last line
of standard output is the kernels JSON object (each kernel's launches,
error against its plain version, its time, the plain version's time, a
library yardstick where one exists and the bound the card allows); the
last line is {"ok": true, "device": {...}}.  A launch is one wrapper
call: for locate it is two kernels when the leaves are split across
blocks (its entry's "splits" > 1), the split scan and the merge.
arena_eval's entry is at the serving run's most frequent batch size
("rows"), its error the largest over every size it was held to its
plain version at (the sweep's and that one), and its "profiled_*"
keys come from a second, shorter serving run under torch.profiler
(the timed run's p50/p99 are taken without the profiler).  The
ipm_leg and locate entries' "sim_launches" count the closed loop's
launches (phase 11), from zero; the ipm_leg entry's "large" object is
phase 14's: the large path's time, bound and plain time at the
quadrotor build's most frequent K, its errors against the plain
version, the timed cells, and the quadrotor build's K1 launches and
device time against their summed bound; its "general" object the
general path's timed cells and the satellite build's launches on it.
The "rebuild_*" keys count phase 15's unchanged rebuild (K1: launches,
device time, summed bound) and its tightened rebuild's online batch
(locate), from zero.

It refuses to run (exit code 2, no result) without a CUDA device, and
exits non-zero in a directory that does not hold the repository.

    K1_BASELINE=old_ipm_leg.cu python3 chip_smoke.py

also builds another version of csrc/ipm_leg.cu (the same C interface;
for a redesign of K1, its parent's source from `git show`) and holds
this kernel against it in the same call: phase 2's sweep of the build's
launch shapes timed in turns, and (phase 10) four flagship builds in
turns (baseline, kernel, kernel, baseline) for the build wall, then one
recorded build with each for a cell-by-cell diff of the two trees that
names, for every cell the two builds decide differently, the test that
decided it and how far from its threshold it sat.

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
#: drawn outside the certified box.
TENANTS = 4
CLIENTS = 16
REQUESTS = 20_000
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
#: synthetic depth-11 tree over the unit box in p = 6 (720 Kuhn roots,
#: the satellite's root layout), 1,474,560 leaves; the batch, the shard
#: count, the timed repetitions, the queries held to the tree's exact law
#: and, of those, the ones held to the brute f64 host evaluator.
LARGE_P = 6
LARGE_DEPTH = 11
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
#: QPs a call of the plain version at the large shapes (it materializes
#: K x nc x nz x nz products).
K1_PLAIN_CHUNK = 128
#: K1's general path (8 < nz <= 32, nc <= 128; the kernel's dispatch):
#: the satellite 4c build's point QPs, timed at these K.
K1_REGISTER_MAX_NZ = 8
K1_GENERAL_SHAPE = (24, 96)
K1_GENERAL_K = (64, 1024)

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


def log(*a) -> None:
    print(*a, flush=True)


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


def in_turns(new, old, reps: int) -> tuple[float, float | None, str]:
    """(kernel ms, baseline ms, log text): `new` timed alone, or with a
    baseline `old` in turns (baseline, kernel, kernel, baseline), each
    by graph_time."""
    if old is None:
        return graph_time(new, reps), None, ""
    b1 = graph_time(old, reps)
    m1, m2 = graph_time(new, reps), graph_time(new, reps)
    b2 = graph_time(old, reps)
    ms, base_ms = (m1 + m2) / 2, (b1 + b2) / 2
    return ms, base_ms, (f"; baseline {base_ms:.4f} ms ({b1:.4f}/{b2:.4f}), "
                         f"{base_ms / ms:.2f}x")


def ptxas_lines(name: str, report: str) -> list[str]:
    """One line per kernel function of a ptxas -v report: registers,
    stack frame and spill stores/loads (template arguments read back
    from the mangled name: K1's dtype, NZ, ROWS; K2's and K3's K =
    p+1)."""
    import re

    out, fn, frame = [], None, ""
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            # The name follows its length; the namespace before it
            # holds the file name (ipm_leg_cu_...), not preceded by one.
            fn = m.group(1)
            mm = re.search(r"\d(ipm_leg_\w+?)I([fd])(?:Li(\d+)ELi(\d+)E)?E",
                           fn)
            mk = re.search(r"\d(locate_kernel|locate_merge|arena_eval_kernel)"
                           r"(?:ILi(\d+)EE)?", fn)
            if mm:
                dtype = "double" if mm.group(2) == "d" else "float"
                args = (f", NZ={mm.group(3)}, ROWS={mm.group(4)}"
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


def serve_phases(dev, res, table, rng, tmp: str, base_k3=None,
                 k3_src: str | None = None) -> dict:
    """Phases 6-8: the flagship table served to TENANTS tenants from one
    device arena, the arena kernel against its plain version, and a
    closed-loop serving run with a mid-traffic delta hot swap and a
    bitwise torn-read audit.  `base_k3`: the parent's arena kernel
    (K3_BASELINE), timed in turns and held bitwise.  Returns the
    kernel's entry of the kernels line."""
    import os
    import threading

    import torch

    from explicit_hybrid_mpc_tpu_torch import obs as obs_lib
    from explicit_hybrid_mpc_tpu_torch.lifecycle.delta import (
        write_delta_artifact)
    from explicit_hybrid_mpc_tpu_torch.online import fused
    from explicit_hybrid_mpc_tpu_torch.online.descent import load_descent
    from explicit_hybrid_mpc_tpu_torch.serve import (ArenaScheduler,
                                                     DeviceArena,
                                                     FallbackPolicy,
                                                     registry)

    # -- phase 6: the arena on the card -------------------------------------
    tenants = [f"t{k}" for k in range(TENANTS)]
    tree, roots = res.tree, res.roots
    v1_dir = os.path.join(tmp, "t0_v1")
    d2_dir = os.path.join(tmp, "t0_v2.delta")
    registry.save_artifacts(tree, roots, v1_dir)
    # v2: half of the payload slots doubled -- exact in floating point,
    # so a read that mixes versions shows bit for bit.
    v2 = tree.clone()
    half = v2._n_slots // 2
    v2._pl_inputs[:half] *= 2.0
    v2._pl_costs[:half] *= 2.0
    dstats = write_delta_artifact(v2, roots, d2_dir, v1_dir,
                                  base_version="v1")
    lb, ub = registry.root_box(load_descent(os.path.join(v1_dir,
                                                         "descent.npz")))
    L, p, n_u = table.n_leaves, tree.p, tree.n_u
    pp1 = p + 1
    cols = 128 * -(-L // 128)

    def fresh_arena(obs=None):
        a = DeviceArena(p=p, n_u=n_u, capacity_cols=(TENANTS + 1) * cols,
                        device=dev, obs=obs)
        a.publish_from_artifacts("t0", "v1", v1_dir)
        for n in tenants[1:]:
            a.publish(n, "v1", table, lb, ub)
        return a

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

    def drive(sched_, n, mid=None):
        # Requests 0..n-1 from CLIENTS closed-loop threads through sched_;
        # mid() runs on this thread once half of them are answered.
        # Returns (results, latencies s, submit times, wall s).
        results = [None] * n
        t_sub, lat = np.zeros(n), np.zeros(n)
        errors: list[str] = []
        lock = threading.Lock()
        done = [0]
        halfway = threading.Event()

        def client(c):
            for j in range(c, n, CLIENTS):
                t0 = time.perf_counter()
                try:
                    r = sched_.submit(names[j], th[j]).result(60.0)[0]
                except BaseException as e:  # noqa: BLE001 -- counted, fails
                    with lock:
                        errors.append(f"request {j}: {e!r}")
                    continue
                lat[j] = time.perf_counter() - t0
                t_sub[j] = t0
                results[j] = r
                with lock:
                    done[0] += 1
                    if done[0] == n // 2:
                        halfway.set()

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(CLIENTS)]
        t_run = time.perf_counter()
        for t in threads:
            t.start()
        if mid is not None:
            if not halfway.wait(600.0):
                fail("the serving run did not reach half its requests")
            mid()
        for t in threads:
            t.join()
        sched_.close()
        run_s = time.perf_counter() - t_run
        dropped = sum(r is None for r in results)
        if errors or dropped:
            fail(f"serving run: {len(errors)} errored, {dropped} dropped "
                 f"requests ({errors[:3]})")
        return results, lat, t_sub, run_s

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
        results, lat, t_sub, run_s = drive(sched, REQUESTS, swap)
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
            _res, _lat, _ts, prof_s = drive(sched_p, PROFILED_REQUESTS)
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
        # Held: the synthetic law is u = A theta, cost = sum(theta)
        # (partition/synthetic.leaf_payload), reproduced exactly by the
        # barycentric interpolation; and the brute f64 host evaluator on
        # a few queries (it scores every leaf: about 0.1 s a query here).
        sub = qs[:LARGE_HOLD]
        A = (np.arange(1)[:, None] + 1.0) * (np.arange(p)[None, :] + 1.0)
        u_law, c_law = sub @ A.T, sub.sum(axis=1)
        u_np = np.stack([evaluator.evaluate_np(table, sub[k])
                         for k in range(LARGE_NP_HOLD)])
        for name, o in (("flat", out_f), ("sharded", out_s)):
            u = o.u.cpu().numpy() if torch.is_tensor(o.u) else o.u
            c = o.cost.cpu().numpy() if torch.is_tensor(o.cost) else o.cost
            ins = o.inside.cpu().numpy() if torch.is_tensor(o.inside) \
                else o.inside
            du = float(np.abs(u[:LARGE_HOLD] - u_law).max())
            dc = float(np.abs(c[:LARGE_HOLD] - c_law).max())
            if not ins[:LARGE_HOLD].all() or du > 1e-9 or dc > 1e-9:
                fail(f"large {name}: {int((~ins[:LARGE_HOLD]).sum())} "
                     f"outside, |du| {du:.2e}, |dcost| {dc:.2e} against "
                     "the tree's law")
            dn = float(np.abs(u[:LARGE_NP_HOLD] - u_np).max())
            if dn > 1e-9:
                fail(f"large {name}: |du| {dn:.2e} against the f64 host "
                     "evaluator")
            log(f"[large] {name}: {LARGE_HOLD} queries inside, max |du| "
                f"{du:.2e}, |dcost| {dc:.2e} against the tree's exact law; "
                f"{LARGE_NP_HOLD} of them max |du| {dn:.2e} against the "
                "f64 host evaluator")
        del srv, dt_dev, lt, out_f, out_s
        if on_card:
            torch.cuda.empty_cache()
    log(f"[large] (phase took {time.perf_counter() - t_phase:.1f} s)")


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


def other_problems_phase(dev, tmp: str) -> dict:
    """Phase 14: the quadrotor's and the satellite's published sub-box
    builds through the build CLI's main() on `dev` (OTHER_BUILDS), each
    with its online evaluation, K1 and K2 counted from zero and K1's
    launches recorded; the quadrotor's under torch.profiler for K1's
    device time.  Each build is held to the reference's regions (2%),
    uncertified, not truncated, no device failure, and its table through
    K2 to the f64 host evaluator.  Then K1's large path against its
    plain version at the quadrotor's shapes (f64 to 1e-9 relative, f32
    as phase 2), timed by CUDA events.  Returns the kernels line's
    ipm_leg "large" object and (general_path_cells) its "general" one."""
    from collections import Counter

    from explicit_hybrid_mpc_tpu_torch import main as tmain
    from explicit_hybrid_mpc_tpu_torch.oracle import ipm_leg
    from explicit_hybrid_mpc_tpu_torch.partition.tree import Tree
    from explicit_hybrid_mpc_tpu_torch.problems.registry import make

    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    quad_legs: list = []
    sat_legs: list = []
    quad_ms = None
    for name, args, ref_regions, artifacts in OTHER_BUILDS:
        out = os.path.join(tmp, name)
        argv = [*args, "--evaluate", str(OTHER_EVALUATE), "-o", out]
        if artifacts:
            argv += ["--artifacts-out", out + ".artifacts"]
        if not on_card:
            argv += ["--backend", "cpu"]
        rc, st, ev, wall, legs, n_k1, n_k2, prof = run_main(
            argv, on_card, profiled=artifacts)
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
            if prof is not None:
                rows = [e for e in prof.key_averages()
                        if "ipm_leg" in e.key and e.self_device_time_total]
                quad_ms = (sum(e.self_device_time_total for e in rows) / 1e3
                           if rows else None)
        problem = make(args[args.index("-e") + 1], **tmain._parse_problem_args(
            [v for k, v in zip(args, args[1:]) if k == "--problem-arg"]))
        hold_table(dev, Tree.load(out + ".tree.pkl"), problem, SEED + 14,
                   name)

    # K1's large path at the quadrotor's shapes against its plain
    # version on the same inputs: f64 to 1e-9 relative, f32 within 4x
    # the plain f32 version's error against the f64 iterates plus 1e-4
    # (as phase 2), 4 iterations from the cold start; then timed at the
    # build's iteration count for the shape by CUDA events.
    hist = Counter((nz, nc, it) for _k, nz, nc, it in quad_legs
                   if nz > ipm_leg.GENERAL_MAX_NZ
                   or nc > ipm_leg.GENERAL_MAX_NC)
    k_main = (Counter(k for k, *_ in quad_legs).most_common(1)[0][0]
              if quad_legs else max(K1_LARGE_K))
    iters = {}
    for (nz, nc, it), _n in hist.most_common():
        iters.setdefault((nz, nc), it)
    cells = sorted({*K1_LARGE_SHAPES, *iters})
    ks = sorted({*K1_LARGE_K, k_main})
    g = np.random.default_rng(SEED + 15)
    err64 = err32 = 0.0
    timed = []
    main_cell = None
    for nz, nc in cells:
        n_iter = iters.get((nz, nc), 18)
        for K in ks:
            args = random_qps(g, K, nz, nc, dev)
            truth = plain_leg(args, 4)
            e64 = rel_err(ipm_leg.ipm_leg(*args, n_iter=4), truth)
            a32 = tuple(t.float() for t in args)
            e_k = rel_err(ipm_leg.ipm_leg(*a32, n_iter=4), truth)
            e_p = rel_err(plain_leg(a32, 4), truth)
            if not e64 <= 1e-9:
                fail(f"K1 large path nz={nz} nc={nc} K={K}: f64 differs "
                     f"from plain by {e64:.2e} (> 1e-9 relative)")
            if not e_k <= 4 * e_p + 1e-4:
                fail(f"K1 large path nz={nz} nc={nc} K={K}: f32 worse than "
                     f"plain ({e_k:.2e} vs {e_p:.2e})")
            err64, err32 = max(err64, e64), max(err32, e_k)
            nbytes, flops = ipm_leg_cost(K, nz, nc, n_iter, 8)
            bound = leg_bound_ms(K, nz, nc, n_iter)
            ms = (cuda_time(raw_leg(ipm_leg._lib().ipm_leg_f64, args,
                                    n_iter)[0], 10) if on_card else None)
            cell = {"nz": nz, "nc": nc, "K": K, "n_iter": n_iter, "ms": ms,
                    "bound_ms": bound}
            timed.append(cell)
            log(f"[K1-large] nz={nz} nc={nc} K={K} n_iter={n_iter}: f64 vs "
                f"plain {e64:.2e} (limit 1e-9); f32 vs the f64 iterates: "
                f"kernel {e_k:.2e}, plain {e_p:.2e}; kernel "
                + (f"{ms:.4f} ms = {1e3 * ms / n_iter:.1f} us/iteration, "
                   f"{bound / ms:.4f} of the bound" if ms else "not measured")
                + f"; bound {bound:.5f} ms ("
                + ("bytes" if nbytes / PEAK_BYTES_S > flops / PEAK_F64_S
                   else "operations") + ")")
            if (nz, nc) == K1_LARGE_SHAPES[0] and K == k_main:
                main_cell = (args, n_iter, cell,
                             "bytes" if nbytes / PEAK_BYTES_S
                             > flops / PEAK_F64_S else "operations")
    args, n_iter, cell, by = main_cell
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
    general = general_path_cells(dev, sat_legs)
    log(f"[other] (phase took {time.perf_counter() - t_phase:.1f} s)")
    return {"nz": cell["nz"], "nc": cell["nc"], "K": cell["K"],
            "n_iter": n_iter, "ms": cell["ms"], "plain_ms": plain_ms,
            "bound_ms": cell["bound_ms"], "bound_by": by,
            "max_rel_err_f64": err64, "max_rel_err_f32": err32,
            "launches": len(quad_legs), "large_launches": n_large,
            "build_ms": quad_ms, "build_bound_ms": build_bound,
            "cells": timed}, general


def general_path_cells(dev, sat_legs: list) -> dict:
    """K1's general path (8 < nz <= 32, nc <= 128) at the satellite 4c
    build's point shape (K1_GENERAL_SHAPE): against its plain version on
    random QPs (f64 to 1e-9 relative, 4 iterations from the cold start),
    then ms a launch by CUDA events at K1_GENERAL_K and the build's
    iteration count for the shape, beside the bound; with the general-path
    launches the satellite build made (`sat_legs`, recorded in phase 14).
    Returns the kernels line's ipm_leg "general" object."""
    from collections import Counter

    from explicit_hybrid_mpc_tpu_torch.oracle import ipm_leg

    on_card = dev.type == "cuda"
    nz, nc = K1_GENERAL_SHAPE
    gen_legs = [x for x in sat_legs if K1_REGISTER_MAX_NZ < x[1]
                <= ipm_leg.GENERAL_MAX_NZ and x[2] <= ipm_leg.GENERAL_MAX_NC]
    iters = Counter(it for _k, z, c, it in gen_legs if (z, c) == (nz, nc))
    n_iter = iters.most_common(1)[0][0] if iters else 18
    g = np.random.default_rng(SEED + 16)
    cells, err64 = [], 0.0
    for K in K1_GENERAL_K:
        args = random_qps(g, K, nz, nc, dev)
        e64 = rel_err(ipm_leg.ipm_leg(*args, n_iter=4), plain_leg(args, 4))
        if not e64 <= 1e-9:
            fail(f"K1 general path nz={nz} nc={nc} K={K}: f64 differs from "
                 f"plain by {e64:.2e} (> 1e-9 relative)")
        err64 = max(err64, e64)
        nbytes, flops = ipm_leg_cost(K, nz, nc, n_iter, 8)
        bound = leg_bound_ms(K, nz, nc, n_iter)
        by = ("bytes" if nbytes / PEAK_BYTES_S > flops / PEAK_F64_S
              else "operations")
        ms = (cuda_time(raw_leg(ipm_leg._lib().ipm_leg_f64, args,
                                n_iter)[0], 20) if on_card else None)
        cells.append({"K": K, "ms": ms, "bound_ms": bound, "bound_by": by})
        log(f"[K1-general] nz={nz} nc={nc} K={K} n_iter={n_iter}: f64 vs "
            f"plain {e64:.2e} (limit 1e-9); kernel "
            + (f"{ms:.4f} ms a launch = {1e3 * ms / n_iter:.2f} us/iteration, "
               f"{bound / ms:.4f} of the bound" if ms else "not measured")
            + f"; bound {bound:.5f} ms ({by})")
    plain_ms = (cuda_time(lambda: plain_leg(args, n_iter), 2, warmup=1)
                if on_card else None)
    shapes = Counter((z, c) for _k, z, c, _it in gen_legs)
    log(f"[K1-general] the satellite 4c build: {len(gen_legs)} K1 launches "
        f"on the general path of {len(sat_legs)} (shapes "
        + ", ".join(f"{k} x{n}" for k, n in sorted(shapes.items()))
        + f"); plain version at K={K1_GENERAL_K[-1]}: "
        + (f"{plain_ms:.2f} ms" if plain_ms else "not measured"))
    return {"nz": nz, "nc": nc, "n_iter": n_iter, "cells": cells,
            "plain_ms": plain_ms, "max_rel_err_f64": err64,
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
    k1_a = n_k1
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
    k2_b = n_k2
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
            "locate": {"rebuild_launches": k2_b}}


def main() -> int:
    import torch

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

    # -- phases 6-8: multi-tenant serving through the arena kernel ---------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as tmp:
        k3_entry = serve_phases(dev, res, table, rng, tmp, base_k3, k3_src)

    # -- phase 9: where the device time of a build goes --------------------
    # A second flagship build under torch.profiler (device activity
    # only): the device's busy share is the summed time of every CUDA
    # kernel over the wall (one stream, so kernels do not overlap); the
    # profiler's own overhead lengthens the wall, so the share is a
    # lower bound.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prof_legs: list = []
    ipm_leg.ipm_leg_cuda = record_legs(real_cuda, prof_legs)
    torch.cuda.synchronize()
    t_prof = time.perf_counter()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            build_partition(problem, cfg)
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
    finally:
        ipm_leg.ipm_leg_cuda = real_cuda
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy_us = sum(r[1] for r in rows)
    if busy_us > 0:
        log(f"[profile] build under the profiler {prof_wall:.1f} s; device "
            f"busy {busy_us / 1e6:.2f} s = {busy_us / 1e6 / prof_wall:.3f} "
            f"of the wall (idle {1 - busy_us / 1e6 / prof_wall:.3f})")
        for key, us, n in sorted(rows, key=lambda r: -r[1])[:6]:
            log(f"[profile]   {us / 1e6:8.3f} s  {n:7d} x  {key[:70]}")
        log(f"[profile] (phase took {time.perf_counter() - t_prof:.0f} s)")
    else:
        log("[profile] the profiler recorded no device time: device busy "
            "share not measured")
    # K1's own row: its summed device time in this build against the
    # summed bound of the launches recorded in the same build.
    k1_rows = [r for r in rows if "ipm_leg" in r[0]]
    k1_us = sum(r[1] for r in k1_rows)
    log("[profile] K1 launches of the profiled build:")
    build_bound_ms = leg_histogram(prof_legs)
    build_ms = k1_us / 1e3 if k1_rows else None
    if k1_rows:
        log(f"[profile] K1 (ipm_leg): {k1_us / 1e6:.4f} s of device time in "
            f"{sum(r[2] for r in k1_rows)} launches ({len(prof_legs)} "
            f"recorded) = {k1_us / busy_us:.3f} of the build's device time; "
            f"{k1_us / 1e3 / build_bound_ms:.0f}x the summed bound "
            f"{build_bound_ms:.4f} ms")
    else:
        log("[profile] K1's device time in the build: not measured (no "
            "profiler row)")

    # -- phase 10 (K1_BASELINE only): builds with the baseline kernel -----
    if base:
        build_ab(base, problem, cfg, prob, dev)

    # -- phases 11-13: the closed loop, the serve entry point, and sharded
    # descent at a realistic size -------------------------------------------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sim_") as tmp:
        sim = closed_loop_phase(dev, problem, cfg, table, tmp)
        serve_entry_phase(dev, problem, cfg, res, table, rng, tmp)
    large_partition_phase(dev)

    # -- phase 14: the other problems' published sub-boxes -----------------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_other_") as tmp:
        k1_large, k1_general = other_problems_phase(dev, tmp)

    # -- phase 15: the warm rebuild and the rebuild service ----------------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_rebuild_") as tmp:
        reb = rebuild_phase(dev, problem, cfg, res, build_s, tmp)

    kernels_line = {"kernels": [
        {"name": "ipm_leg", "route": "cuda",
         "source": "explicit_hybrid_mpc_tpu_torch/csrc/ipm_leg.cu",
         "replaces": "explicit_hybrid_mpc_tpu/oracle/pallas_ipm.py:217",
         "launches": n_k1, "max_abs_err": k1_err, **k1_entry,
         "library_ms": None, "build_ms": build_ms,
         "build_bound_ms": build_bound_ms, "sim_launches": sim["sim_k1"],
         "large": k1_large, "general": k1_general, **reb["ipm_leg"]},
        {"name": "locate", "route": "cuda",
         "source": "explicit_hybrid_mpc_tpu_torch/csrc/locate.cu",
         "replaces": "explicit_hybrid_mpc_tpu/online/pallas_eval.py:111",
         "launches": n_k2, "max_abs_err": k2_err, "ms": k2_ms,
         "plain_ms": k2_plain_ms, "bound_ms": k2_bound_ms,
         "bound_by": k2_bound_by, "library_ms": k2_lib_ms,
         "splits": k2_splits, "sim_launches": sim["sim_k2"],
         **reb["locate"]},
        k3_entry,
    ]}
    log(card)
    log(json.dumps(kernels_line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
