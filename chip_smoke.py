"""End-to-end check of the torch port on one NVIDIA GPU.

    python3 chip_smoke.py                 # the whole check, one GPU

Builds the hand-written CUDA kernels from csrc/, holds each against its
plain torch version on the card, drives the port's main path -- the
flagship inverted-pendulum partition build at eps_a=1e-2 and the online
evaluation of 65,536 thetas through the point-location kernel -- with
every kernel launch counted, and checks the results against the plain
references.  Any failed phase exits non-zero.  The second-to-last line
of standard output is the kernels JSON object (each kernel's launches,
error against its plain version, its time, the plain version's time, a
library yardstick where one exists and the bound the card allows); the
last line is {"ok": true, "device": {...}}.

It refuses to run (exit code 2, no result) without a CUDA device, and
exits non-zero in a directory that does not hold the repository.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

#: Published peaks of one H100 SXM used for the bounds (NVIDIA's data
#: sheet): HBM bandwidth, float32 outside the tensor cores, float64
#: outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
PEAK_F64_S = 34e12

#: Reference of the flagship build: the JAX package on the CPU at the
#: same configuration (inverted_pendulum defaults, eps_a=1e-2, every
#: other PartitionConfig field at its default).
REF_REGIONS = 11670
REF_UNCERTIFIED_MAX = 70

#: Online batch (thetas evaluated through the locate kernel) and the
#: seed of every sampled input.
QUERIES = 65536
SEED = 0


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
    built = kernels.build()
    log(f"[build] {len(built)} kernels built in "
        f"{time.perf_counter() - t0:.1f} s (nvcc in parallel)")
    for name in built:
        for ln in kernels.ptxas_report.get(name, "").splitlines():
            if "registers" in ln or "error" in ln.lower():
                log(f"[build] {name}: {ln.strip()}")
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
        W = g.normal(size=(K, nz, nz))
        rq = [W @ W.transpose(0, 2, 1) + np.eye(nz), g.normal(size=(K, nz)),
              g.normal(size=(K, nc, nz)),
              np.abs(g.normal(size=(K, nc))) + 0.5]
        # f64: kernel against plain to 1e-9 relative (observed 1e-13
        # to 2e-12: summation order only).  f32: both are float32
        # approximations of the float64 iterates, and their gap is
        # dominated by the few random QPs float32 resolves poorly, on
        # either side; the kernel's worst error against the float64
        # plain result is held to 4x the plain version's, plus 1e-4.
        a64 = [torch.as_tensor(x, dtype=torch.float64, device=dev)
               for x in rq]
        st = (torch.zeros_like(a64[1]), torch.ones_like(a64[3]),
              torch.ones_like(a64[3]))
        truth = ipm_leg.ipm_leg_torch(*a64, *st, n_iter=4)

        def rel(xs, ys):
            return max(float(((x.double() - y).abs() / (1 + y.abs())).max())
                       for x, y in zip(xs, ys))
        err64 = rel(ipm_leg.ipm_leg_cuda(*a64, *st, n_iter=4), truth)
        a32 = [t.float() for t in a64]
        st32 = tuple(t.float() for t in st)
        err_k = rel(ipm_leg.ipm_leg_cuda(*a32, *st32, n_iter=4), truth)
        err_p = rel(ipm_leg.ipm_leg_torch(*a32, *st32, n_iter=4), truth)
        log(f"[K1] bare leg nz={nz} nc={nc}, 4 iterations on random QPs: "
            f"f64 kernel vs plain {err64:.2e} (limit 1e-9); f32 vs the "
            f"f64 iterates: kernel {err_k:.2e}, plain {err_p:.2e}")
        if not err64 <= 1e-9:
            fail(f"K1 bare f64 leg differs from plain by {err64:.2e}")
        if not err_k <= 4 * err_p + 1e-4:
            fail(f"K1 bare f32 leg is worse than plain ({err_k:.2e} vs "
                 f"{err_p:.2e})")

    # K1 time at the main path's most frequent launch: the point class's
    # two-phase first leg (the data does not change the work: no early
    # exit).
    ora = oracle.Oracle(problem, backend="cuda", two_phase=True,
                        warm_start=True)
    p1 = ora.point_p1
    Q, q, A, b = classes["point"][0]
    z0 = torch.zeros_like(q)
    s0 = torch.ones_like(b)
    l0 = torch.ones_like(b)
    leg_args = (Q.contiguous(), q.contiguous(), A.contiguous(),
                b.contiguous(), z0, s0, l0)
    k1_ms = cuda_time(lambda: ipm_leg.ipm_leg_cuda(*leg_args, n_iter=p1), 20)
    k1_plain_ms = cuda_time(
        lambda: ipm_leg.ipm_leg_torch(*leg_args, n_iter=p1), 3, warmup=1)
    nbytes, flops = ipm_leg_cost(K, can.nz, can.nc, p1, 8)
    k1_bound_ms = 1e3 * max(nbytes / PEAK_BYTES_S, flops / PEAK_F64_S)
    k1_bound_by = "bytes" if nbytes / PEAK_BYTES_S > flops / PEAK_F64_S \
        else "operations"
    log(f"[K1] leg K={K} nz={can.nz} nc={can.nc} f64 n_iter={p1}: kernel "
        f"{k1_ms:.3f} ms, plain {k1_plain_ms:.3f} ms, bound "
        f"{k1_bound_ms:.4f} ms ({k1_bound_by})")
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
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = build_partition(problem, cfg)
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
    k2_ms = cuda_time(lambda: locate.locate_cuda(ltable.bary, inner), 10)
    k2_plain_ms = cuda_time(
        lambda: locate.locate_torch(ltable.bary, inner), 3, warmup=1)
    bary = ltable.bary
    th1_f = torch.cat([inner.float(), torch.ones_like(inner[:, :1]).float()],
                      1)
    pp1 = can.n_theta + 1

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
    B = QUERIES
    k2_bytes = 4.0 * (B * can.n_theta + L * pp1 * pp1 + 2 * B)
    k2_flops = 2.0 * B * L * pp1 * pp1
    k2_bound_ms = 1e3 * max(k2_bytes / PEAK_BYTES_S, k2_flops / PEAK_F32_S)
    k2_bound_by = "bytes" if k2_bytes / PEAK_BYTES_S > \
        k2_flops / PEAK_F32_S else "operations"
    log(f"[K2] B={B} L={L} p+1={pp1}: leaf ids equal, max |dscore| "
        f"{k2_err:.2e}; kernel {k2_ms:.3f} ms, plain {k2_plain_ms:.3f} ms, "
        f"library {k2_lib_ms:.3f} ms, bound {k2_bound_ms:.4f} ms "
        f"({k2_bound_by})")

    # -- phase 6: where the device time of a build goes --------------------
    # A second flagship build under torch.profiler (device activity
    # only): the device's busy share is the summed time of every CUDA
    # kernel over the wall (one stream, so kernels do not overlap); the
    # profiler's own overhead lengthens the wall, so the share is a
    # lower bound.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t_prof = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        build_partition(problem, cfg)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
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

    kernels_line = {"kernels": [
        {"name": "ipm_leg", "route": "cuda",
         "source": "explicit_hybrid_mpc_tpu_torch/csrc/ipm_leg.cu",
         "replaces": "explicit_hybrid_mpc_tpu/oracle/pallas_ipm.py:217",
         "launches": n_k1, "max_abs_err": k1_err, "ms": k1_ms,
         "plain_ms": k1_plain_ms, "bound_ms": k1_bound_ms,
         "bound_by": k1_bound_by, "library_ms": None},
        {"name": "locate", "route": "cuda",
         "source": "explicit_hybrid_mpc_tpu_torch/csrc/locate.cu",
         "replaces": "explicit_hybrid_mpc_tpu/online/pallas_eval.py:111",
         "launches": n_k2, "max_abs_err": k2_err, "ms": k2_ms,
         "plain_ms": k2_plain_ms, "bound_ms": k2_bound_ms,
         "bound_by": k2_bound_by, "library_ms": k2_lib_ms},
    ]}
    log(card)
    log(json.dumps(kernels_line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
