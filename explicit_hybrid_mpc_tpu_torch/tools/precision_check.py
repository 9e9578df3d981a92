"""Mixed-precision validation on the card: does the float32 leg of the
IPM pay its way, and does a mixed build keep the float64 build's tree?

    python -m explicit_hybrid_mpc_tpu_torch.tools.precision_check
    PREC_PROBLEM=double_integrator PREC_EPS=0.5 PREC_POINTS=32 \\
        python -m explicit_hybrid_mpc_tpu_torch.tools.precision_check \\
        --backend cpu --out /tmp/precision.json

The JAX package's scripts/precision_check.py, with its knobs, JSON keys
and exit rule, on the port:

1. ``f32_accept_rate``: of the qp_solve instances of PREC_POINTS sampled
   thetas x every commutation, the fraction whose float32 warm start
   passes the float64 merit gate (``QPSolution.f32_ok``), solved as one
   batch (``acceptance``), beside the KKT statistics of the mixed and
   the pure float64 schedule on the same instances.
2. ``mixed_vs_f64_regions_equal``: region and tree-node parity of a
   precision='mixed' and a precision='f64' build at PREC_EPS.
3. ``mixed_eps_sound``: at PREC_SOUND_SAMPLES sampled thetas, the mixed
   tree's interpolated input is feasible and within eps of the optimum
   of a float64 oracle.

Exit 0 when nothing raised and either the builds agree or the mixed tree
is sound.  Env: PREC_OUT, PREC_PROBLEM (default inverted_pendulum),
PREC_EPS (0.1), PREC_POINTS (256), PREC_TIME_BUDGET (s a build, 1200),
PREC_SOUND_SAMPLES (256), BENCH_PLATFORM.  The JSON goes to ``--out``,
else PREC_OUT, else a fresh temp dir.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from explicit_hybrid_mpc_tpu_torch.tools.capture import (
    SENTINEL, choose_device, log, out_path, retry_transient, warm_oracle)


def _flush(path: str, result: dict) -> None:
    """Each section is written as it lands, so a run cut short keeps
    what it measured."""
    with open(path, "w") as f:
        json.dump(result, f, indent=2)


def grid_solve(oracle, thetas: np.ndarray) -> dict:
    """The raw qp_solve of every (theta, commutation) cell of
    `oracle`'s problem under its (simplex-class) schedule, as one batch
    on its device (the JAX package's vmap(vmap(qp_solve)) grid).
    Returns host arrays shaped (P, nd): f32_ok, converged, rp, rd,
    obj."""
    import torch

    from explicit_hybrid_mpc_tpu_torch.oracle import ipm
    from explicit_hybrid_mpc_tpu_torch.oracle.oracle import point_qp

    prob = oracle.prob
    nd = prob.H.shape[0]
    th = torch.as_tensor(np.asarray(thetas), dtype=torch.float64,
                         device=oracle.device)
    P = th.shape[0]
    ds = torch.arange(nd, device=oracle.device).repeat(P)
    sol = ipm.qp_solve(*point_qp(prob, th.repeat_interleave(nd, dim=0),
                                 ds),
                       n_iter=oracle.n_iter, n_f32=oracle.n_f32)
    return {k: getattr(sol, k).reshape(P, nd).cpu().numpy()
            for k in ("f32_ok", "converged", "rp", "rd", "obj")}


def acceptance(problem, device, n_points: int, seed: int = 7) -> dict:
    """Section 1 on `problem` at `n_points` thetas drawn from `seed`:
    the mixed schedule's float32 acceptance and KKT statistics beside
    the pure float64 schedule's on the same instances (the JSON's keys
    of that section)."""
    from explicit_hybrid_mpc_tpu_torch.oracle.oracle import Oracle

    rng = np.random.default_rng(seed)
    thetas = rng.uniform(problem.theta_lb, problem.theta_ub,
                         size=(n_points, problem.n_theta))
    backend = device.type
    sol = retry_transient(lambda: grid_solve(
        Oracle(problem, backend=backend, precision="mixed"), thetas),
        what="f32-accept grid solve")
    f32_ok, conv = sol["f32_ok"], sol["converged"]
    out: dict = {"sampled_instances": int(f32_ok.size),
                 "f32_accept_rate": round(float(f32_ok.mean()), 4),
                 "f32_accept_rate_converged": round(
                     float(f32_ok[conv].mean()) if conv.any() else 0.0, 4)}

    def kkt(s, c):
        return {"rp_max": float(s["rp"][c].max()) if c.any() else None,
                "rd_max": float(s["rd"][c].max()) if c.any() else None,
                "converged_frac": round(float(c.mean()), 4)}

    out["mixed_kkt"] = kkt(sol, conv)
    log(f"f32 accept rate: {out['f32_accept_rate']} over {f32_ok.size} "
        f"instances (converged frac {out['mixed_kkt']['converged_frac']})")
    sol64 = retry_transient(lambda: grid_solve(
        Oracle(problem, backend=backend, precision="f64"), thetas),
        what="f64 grid solve")
    conv64 = sol64["converged"]
    out["f64_kkt"] = kkt(sol64, conv64)
    both = conv & conv64
    dV = np.abs(sol["obj"] - sol64["obj"])[both]
    out["convergence_agree_frac"] = round(float((conv == conv64).mean()), 4)
    out["max_obj_diff_mixed_vs_f64"] = float(dV.max()) if dV.size else None
    log(f"mixed vs f64: conv agree {out['convergence_agree_frac']}, "
        f"max|dV| {out['max_obj_diff_mixed_vs_f64']}")
    return out


def run(result: dict, path: str, dev) -> None:
    from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
    from explicit_hybrid_mpc_tpu_torch.oracle.oracle import Oracle
    from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
        build_partition)
    from explicit_hybrid_mpc_tpu_torch.problems.registry import make

    problem_name = os.environ.get("PREC_PROBLEM", "inverted_pendulum")
    eps_a = float(os.environ.get("PREC_EPS", "0.1"))
    n_points = int(os.environ.get("PREC_POINTS", "256"))
    budget = float(os.environ.get("PREC_TIME_BUDGET", "1200"))
    on_card = dev.type == "cuda"

    problem = make(problem_name)
    result["problem"] = problem_name
    result["n_delta"] = problem.canonical.n_delta

    # -- 1. f32 warm-start acceptance rate, straight from the IPM ---------
    result.update(acceptance(problem, dev, n_points))
    _flush(path, result)

    # -- 2. end-to-end region parity: mixed vs f64 build -------------------
    counts: dict = {}
    result["builds"] = counts
    mixed_res = None
    for precision in ("mixed", "f64"):
        orc = Oracle(problem, backend=dev.type, precision=precision,
                     points_cap=2048 if on_card else 256)
        warm_oracle(orc, problem)
        cfg = PartitionConfig(problem=problem_name, eps_a=eps_a,
                              backend=dev.type, batch_simplices=256,
                              max_steps=50_000, precision=precision,
                              time_budget_s=budget)
        t0 = time.time()
        res = build_partition(problem, cfg, oracle=orc)
        if precision == "mixed":
            mixed_res = res
        counts[precision] = {
            "regions": res.stats["regions"],
            "tree_nodes": res.stats["tree_nodes"],
            "truncated": res.stats["truncated"],
            "wall_s": round(res.stats["wall_s"], 2),
            "regions_per_s": round(res.stats["regions_per_s"], 2),
            "device_failures": res.stats["device_failures"],
        }
        log(f"  {precision}: {counts[precision]} ({time.time() - t0:.0f}s)")
        _flush(path, result)
    both_complete = not (counts["mixed"]["truncated"]
                         or counts["f64"]["truncated"])
    result["parity_valid"] = both_complete
    result["mixed_vs_f64_regions_equal"] = (
        both_complete
        and counts["mixed"]["regions"] == counts["f64"]["regions"]
        and counts["mixed"]["tree_nodes"] == counts["f64"]["tree_nodes"])
    result["mixed_speedup_vs_f64"] = (
        round(counts["f64"]["wall_s"] / counts["mixed"]["wall_s"], 2)
        if counts["mixed"]["wall_s"] else None)
    _flush(path, result)

    # -- 3. sampled eps-soundness of the MIXED tree ------------------------
    # Region equality can flip on eps-threshold ties, so the guarantee
    # that matters is the mixed build's own certificates, held against
    # float64 ground truth at sampled thetas.
    if mixed_res is not None and not counts["mixed"]["truncated"]:
        from explicit_hybrid_mpc_tpu_torch.partition import geometry

        n_check = int(os.environ.get("PREC_SOUND_SAMPLES", "256"))
        rng2 = np.random.default_rng(23)
        ths = rng2.uniform(problem.theta_lb, problem.theta_ub,
                           size=(n_check, problem.n_theta))
        truth = Oracle(problem, backend=dev.type, precision="f64")
        tsol = retry_transient(lambda: truth.solve_vertices(ths),
                               what="soundness ground truth")
        can = problem.canonical
        max_viol = -np.inf
        max_excess = -np.inf
        checked = skipped = 0
        tree = mixed_res.tree
        for k, th in enumerate(ths):
            n = tree.locate(th, mixed_res.roots)
            ld = tree.leaf_data[n] if n >= 0 else None
            if ld is None or ld.delta_idx < 0 or not np.isfinite(
                    tsol.Vstar[k]):
                skipped += 1  # infeasible region / best-effort leaf
                continue
            if ld.vertex_z is None:
                raise SystemExit(
                    "soundness sampling needs per-leaf primal matrices; "
                    "this tree was built with store_vertex_z=False")
            lam = geometry.barycentric(tree.vertices[n], th)
            zbar = lam @ ld.vertex_z
            d = ld.delta_idx
            viol = float(np.max(can.G[d] @ zbar - can.w[d]
                                - can.S[d] @ th))
            excess = float(can.value(d, th, zbar) - tsol.Vstar[k])
            max_viol = max(max_viol, viol)
            max_excess = max(max_excess, excess)
            checked += 1
        eps_budget = eps_a  # the builds above run with eps_r = 0
        result["mixed_sound_sampled"] = {
            "n_checked": checked, "n_skipped": skipped,
            "max_violation": round(max_viol, 9) if checked else None,
            "max_excess": round(max_excess, 9) if checked else None,
            "eps_budget": eps_budget,
        }
        result["mixed_eps_sound"] = bool(
            checked and max_viol <= 1e-6
            and max_excess <= eps_budget + 1e-6)
        log(f"mixed soundness: {result['mixed_sound_sampled']} -> "
            f"{result['mixed_eps_sound']}")


def verdict(result: dict) -> int:
    """The exit rule: 0 when nothing raised and the builds agree or the
    mixed tree is sound."""
    return 0 if ("error" not in result
                 and (result.get("mixed_vs_f64_regions_equal")
                      or result.get("mixed_eps_sound"))) else 1


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m explicit_hybrid_mpc_tpu_torch.tools.precision_check",
        description=__doc__.splitlines()[0])
    ap.add_argument("--backend", choices=("cuda", "cpu"), default=None,
                    help="'cuda' (the default, else BENCH_PLATFORM; "
                         "refuses to start without a card) or 'cpu'")
    ap.add_argument("--out", default=None,
                    help="the JSON's path (else PREC_OUT, else a temp dir)")
    ap.add_argument("--sentinel", default=SENTINEL,
                    help="the capture-active file held while this runs")
    args = ap.parse_args(argv)
    result: dict = {"captured_at": time.strftime("%Y-%m-%d %H:%M:%S")}
    dev = choose_device(result, args.backend, sentinel=args.sentinel)
    path = out_path(args.out, "PREC_OUT", "precision.json",
                    "precision_check")
    try:
        run(result, path, dev)
    except BaseException as e:
        import traceback

        result["error"] = repr(e)
        traceback.print_exc(file=sys.stderr)
    finally:
        _flush(path, result)
        print(json.dumps(result))
    return verdict(result)


if __name__ == "__main__":
    raise SystemExit(main())
