"""Re-run a flight-recorder repro bundle standalone.

The torch port's counterpart of the JAX package's scripts/replay_solve.py,
with its compare contract and exit codes.  A bundle (obs/recorder.py;
written by either package) carries the exact solver inputs of an
anomaly -- canonical QP matrices, query points / simplices / cell
geometry, warm-start iterates, IPM schedule and precision flags -- so
the replay rebuilds the identical Oracle from the bundle alone (no
problem registry, no checkpoint, no build state) and re-issues the
identical query.  On the card it runs through the IPM kernel
(csrc/ipm_leg.cu); ``--backend cpu`` runs the kernel's plain version.

    python -m explicit_hybrid_mpc_tpu_torch.obs.replay BUNDLE.npz
    python -m explicit_hybrid_mpc_tpu_torch.obs.replay BUNDLE.npz --json r.json
    python -m explicit_hybrid_mpc_tpu_torch.obs.replay BUNDLE.npz --kernel-only
    python -m explicit_hybrid_mpc_tpu_torch.obs.replay BUNDLE.npz --backend cpu

Exit status: 0 when the observed masks are reproduced, 1 when not.

Bundle kinds and their replay/compare contract:

- ``pairs`` / ``vertices``: re-solve the captured (point, commutation)
  cells through the full Oracle pipeline (two-phase cohort + rescue,
  same warm starts); the converged mask -- and, where captured, the
  feasibility mask -- must match bit-for-bit.  V must match bitwise
  too when the replay runs on the capture's backend with the plain
  Oracle class (``same_platform``); otherwise its gap is reported.
- ``simplex`` / ``simplex_feas``: re-run the stage-2 joint solves; the
  Vmin encoding class per row (finite bound / +inf infeasible / -inf
  stalled) and the feasibility witnesses must match.
- ``cell``: re-solve the uncertified leaf's vertices and re-run the
  stage-1 certificate over the SNAPSHOT.  The live build may have
  solved these vertices with sibling warm starts the bundle cannot
  carry, so knife-edge convergence flips are possible: they are
  reported, and gate the exit status only under ``--strict-cell``.
- ``recert``: a warm-rebuild leaf whose stored certificate FAILED
  re-certification (partition/rebuild.py).  Re-solves the cell's
  vertices and re-runs the stored-delta keep-check over the snapshot
  (plus the captured stage-2 bounds): the invalidation verdict must
  reproduce.  Vertex conv flips are advisory like ``cell`` bundles.

``--kernel-only`` (pairs/vertices bundles): bypass the Oracle pipeline
and run the bare fixed-iteration solve (ipm.solve_mask) on the realized
per-cell matrices -- the first bisection step when a pipeline replay
mismatches (is it the kernel or the cohort/rescue plumbing around it?).
``--kernel cuda|torch`` picks the kernel or its plain version for that
probe (default: the replay device's own leg).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from explicit_hybrid_mpc_tpu_torch.obs.recorder import (BundleProblem,
                                                        load_bundle,
                                                        rebuild_canonical)


def _build_oracle(meta: dict, backend: str):
    from explicit_hybrid_mpc_tpu_torch.oracle.oracle import Oracle

    okw = meta["oracle"]
    prob = BundleProblem(meta["_canonical"])
    # The IPM leg follows the replay's device (the kernel on the card,
    # its plain version on the CPU), whatever tier the capture names.
    return Oracle(
        prob, backend=backend,
        n_iter=int(okw["n_iter"]),
        precision=okw["precision"],
        n_f32=okw["n_f32"],
        point_schedule=(tuple(okw["point_schedule"])
                        if okw["point_schedule"] else None),
        rescue_iter=int(okw["rescue_iter"]),
        two_phase=bool(okw["two_phase"]),
        phase1_iters=okw["phase1_iters"],
        warm_start=bool(okw["warm_start"]),
        stage2_order=("phase1_first" if okw["stage2_phase1_first"]
                      else "min_first"))


def _mask_report(name: str, got: np.ndarray, want: np.ndarray) -> dict:
    got = np.asarray(got, dtype=bool)
    want = np.asarray(want, dtype=bool)
    n_bad = int((got != want).sum())
    return {f"{name}_match": n_bad == 0, f"{name}_mismatches": n_bad}


def _vmin_class(v: np.ndarray) -> np.ndarray:
    """Stage-2 encoding class per row: 0 finite bound, +1 infeasible-
    certified (+inf), -1 no-usable-bound (-inf)."""
    v = np.asarray(v)
    return np.where(np.isposinf(v), 1, np.where(np.isneginf(v), -1, 0))


def _snapshot(arrays: dict, can):
    """The certification snapshot a cell/recert bundle carries."""
    from explicit_hybrid_mpc_tpu_torch.partition import certify

    m, nd = arrays["obs_V"].shape
    return certify.SimplexVertexData(
        verts=arrays["cell_verts"], V=arrays["obs_V"],
        conv=arrays["obs_conv"], grad=arrays["obs_grad"],
        u0=np.zeros((m, nd, can.n_u)), z=np.zeros((m, nd, can.nz)),
        Vstar=arrays["obs_Vstar"], dstar=arrays["obs_dstar"])


def replay_bundle(path: str, backend: str = "cuda",
                  kernel_only: bool = False,
                  kernel: str = "auto") -> dict:
    """Replay one bundle on `backend` ('cuda', the default, or 'cpu' /
    'serial'); returns the structured report dict (see the module
    docstring for the per-kind contract).  report["ok"] is the
    exit-status verdict."""
    meta, arrays = load_bundle(path)
    kind = meta.get("kind")
    can = rebuild_canonical(arrays)
    meta["_canonical"] = can
    rep: dict = {"path": path, "kind": kind,
                 "trigger": meta.get("trigger"),
                 "bundle_version": meta.get("bundle_version"),
                 "capture_backend": meta.get("backend"),
                 "replay_backend": backend}

    if kernel_only:
        if kind not in ("pairs", "vertices"):
            raise SystemExit(f"--kernel-only needs a pairs/vertices "
                             f"bundle, got kind={kind!r}")
        return _replay_kernel_only(rep, meta, arrays, can, backend, kernel)
    if kernel != "auto":
        raise SystemExit("--kernel only applies to --kernel-only "
                         "(pipeline replays run the replay device's leg)")

    oracle = _build_oracle(meta, backend)
    rep["capture_oracle_class"] = meta["oracle"].get("oracle_class")
    # Bitwise V is only claimable when the replay runs the capture's
    # backend AND the plain Oracle class (subclassed oracles --
    # PrunedOracle, SOCOracle -- replay through the plain Oracle:
    # decision-identical, not bitwise).
    same_platform = (backend == meta.get("backend", "cpu")
                     and meta["oracle"].get("oracle_class",
                                            "Oracle") == "Oracle")
    rep["same_platform"] = same_platform

    if kind == "pairs":
        warm = None
        if "warm_z" in arrays:
            warm = (arrays["warm_z"], arrays["warm_s"],
                    arrays["warm_lam"], arrays["warm_has"])
        V, conv, feas = oracle.solve_pairs_masks(
            arrays["thetas"], arrays["delta_idx"], warm=warm)
        rep["n_cells"] = int(arrays["delta_idx"].shape[0])
        rep.update(_mask_report("conv", conv, arrays["obs_conv"]))
        ok = rep["conv_match"]
        if "obs_feas" in arrays:
            rep.update(_mask_report("feas", feas, arrays["obs_feas"]))
            ok = ok and rep["feas_match"]
        # Value diff over cells finite on BOTH sides only; an inf/finite
        # disagreement is a conv flip and gets its own count.
        obs_V = arrays["obs_V"]
        both = np.isfinite(V) & np.isfinite(obs_V)
        rep["max_V_diff"] = (float(np.max(np.abs(V - obs_V)[both]))
                             if both.any() else 0.0)
        rep["V_inf_flips"] = int((np.isfinite(V) != np.isfinite(obs_V)).sum())
        rep["V_bitwise"] = bool(np.array_equal(V, obs_V))
        if same_platform:
            ok = ok and rep["V_bitwise"]
        rep["ok"] = bool(ok)
    elif kind == "vertices":
        sol = oracle.solve_vertices(arrays["thetas"])
        rep["n_points"] = int(arrays["thetas"].shape[0])
        rep.update(_mask_report("conv", sol.conv, arrays["obs_conv"]))
        rep.update(_mask_report("feas", sol.feas, arrays["obs_feas"]))
        rep["V_bitwise"] = bool(np.array_equal(sol.V, arrays["obs_V"]))
        rep["ok"] = bool(rep["conv_match"] and rep["feas_match"])
    elif kind == "simplex":
        vmin, feas_sw = oracle.solve_simplex_min(arrays["bary_Ms"],
                                                 arrays["delta_idx"])
        rep["n_rows"] = int(arrays["delta_idx"].shape[0])
        n_bad = int((_vmin_class(vmin)
                     != _vmin_class(arrays["obs_vmin"])).sum())
        rep["class_match"] = n_bad == 0
        rep["class_mismatches"] = n_bad
        rep.update(_mask_report("feas_sw", feas_sw,
                                arrays["obs_feas_sw"]))
        rep["vmin_bitwise"] = bool(np.array_equal(np.asarray(vmin),
                                                  arrays["obs_vmin"]))
        rep["ok"] = bool(rep["class_match"] and rep["feas_sw_match"])
    elif kind == "simplex_feas":
        t, feas_sw, infeas = oracle.simplex_feasibility(
            arrays["bary_Ms"], arrays["delta_idx"])
        rep["n_rows"] = int(arrays["delta_idx"].shape[0])
        rep.update(_mask_report("feas_sw", feas_sw,
                                arrays["obs_feas_sw"]))
        rep.update(_mask_report("infeas", infeas, arrays["obs_infeas"]))
        rep["max_t_diff"] = float(
            np.max(np.abs(t - arrays["obs_t"]))) if t.size else 0.0
        rep["ok"] = bool(rep["feas_sw_match"] and rep["infeas_match"])
    elif kind == "cell":
        from explicit_hybrid_mpc_tpu_torch.partition import certify

        sol = oracle.solve_vertices(arrays["cell_verts"])
        rep["n_vertices"] = int(arrays["cell_verts"].shape[0])
        rep.update(_mask_report("conv", sol.conv, arrays["obs_conv"]))
        # Re-run stage 1 over the SNAPSHOT the live build certified
        # from: the decision must reproduce exactly (pure host numpy
        # over the stored arrays).
        res = certify.certify_suboptimal_stage1(
            _snapshot(arrays, can), meta.get("eps_a", 0.0),
            meta.get("eps_r", 0.0))
        rep["snapshot_stage1_status"] = res.status
        rep["snapshot_stage1_gap"] = (float(res.gap)
                                      if np.isfinite(res.gap) else None)
        rep["captured_gap"] = meta.get("gap")
        # Cold replay vs possibly-warm-started capture: conv flips are
        # knife-edge-possible, so the verdict is advisory by default;
        # --strict-cell upgrades it.
        rep["ok"] = True
        rep["cell_conv_reproduced"] = rep["conv_match"]
    elif kind == "recert":
        from explicit_hybrid_mpc_tpu_torch.partition import certify

        sol = oracle.solve_vertices(arrays["cell_verts"])
        rep["n_vertices"] = int(arrays["cell_verts"].shape[0])
        rep.update(_mask_report("conv", sol.conv, arrays["obs_conv"]))
        sd = _snapshot(arrays, can)
        d = int(meta.get("delta_idx", -1))
        eps_a, eps_r = meta.get("eps_a", 0.0), meta.get("eps_r", 0.0)
        res = certify.recertify_stored_stage1(sd, d, eps_a, eps_r)
        if res.status == "pending":
            vmin = arrays.get("recert_vmin")
            vm = ({int(dp): float(vmin[dp])
                   for dp in np.where(~np.isnan(vmin))[0]}
                  if vmin is not None else {})
            if all(int(dp) in vm for dp in res.pending_deltas):
                res = certify.certify_suboptimal_stage2(
                    sd, res, vm, eps_a, eps_r)
            else:
                rep["note"] = ("bundle carries no stage-2 bounds for "
                               "every pending delta; stage-1 verdict "
                               "reported")
        rep["snapshot_verdict"] = res.status
        rep["captured_gap"] = meta.get("gap")
        # The bundle exists BECAUSE the sweep invalidated this leaf: a
        # replay that certifies it contradicts the capture.
        rep["ok"] = res.status != "certified"
        rep["cell_conv_reproduced"] = rep["conv_match"]
    else:
        raise SystemExit(f"unknown bundle kind {kind!r} in {path}")
    return rep


def _replay_kernel_only(rep: dict, meta: dict, arrays: dict, can,
                        backend: str, kernel: str) -> dict:
    """Bare-kernel probe on the realized per-cell QP matrices
    (ipm.solve_mask on the replay device; `kernel` 'cuda' / 'torch'
    forces the kernel or its plain version)."""
    from explicit_hybrid_mpc_tpu_torch.oracle import ipm

    okw = meta["oracle"]
    if rep["kind"] == "pairs":
        thetas, ds = arrays["thetas"], arrays["delta_idx"]
    else:  # vertices: flatten the anomalous grid to pairs
        P = arrays["thetas"].shape[0]
        thetas = np.repeat(arrays["thetas"], can.n_delta, axis=0)
        ds = np.tile(np.arange(can.n_delta), P)
    K = thetas.shape[0]
    Q = can.H[ds]
    q = can.f[ds] + np.einsum("kij,kj->ki", can.F[ds], thetas)
    A = can.G[ds]
    b = can.w[ds] + np.einsum("kij,kj->ki", can.S[ds], thetas)
    conv, feas, rp = ipm.solve_mask(
        Q, q, A, b, n_iter=int(okw["point_n_iter"]),
        n_f32=int(okw["point_n_f32"]),
        device="cpu" if backend == "serial" else backend, kernel=kernel)
    rep.update(kernel_only=True, n_cells=K, kernel=kernel,
               kernel_converged=int(conv.sum()),
               kernel_feasible=int(feas.sum()),
               kernel_rp_max=float(np.max(rp)) if K else 0.0,
               kernel_rp_nonfinite=int((~np.isfinite(rp)).sum()))
    if "obs_conv" in arrays and rep["kind"] == "pairs":
        rep.update(_mask_report("kernel_vs_obs_conv", conv,
                                arrays["obs_conv"]))
    rep["ok"] = True  # diagnostic mode: informational, never a gate
    return rep


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m explicit_hybrid_mpc_tpu_torch.obs.replay",
        description=__doc__.splitlines()[0])
    ap.add_argument("bundle", help="repro bundle (.npz) path")
    ap.add_argument("--backend", default="cuda",
                    choices=("cuda", "cpu", "serial"),
                    help="replay backend: 'cuda' (default; the IPM "
                         "kernel on the card, raises without one), "
                         "'cpu' (its plain version) or 'serial'")
    ap.add_argument("--kernel-only", action="store_true",
                    help="bypass the Oracle pipeline; probe the bare "
                         "fixed-iteration solve on the realized QPs")
    ap.add_argument("--kernel", default="auto",
                    choices=("auto", "cuda", "torch"),
                    help="with --kernel-only: the IPM kernel ('cuda') or "
                         "its plain version ('torch'); default the "
                         "replay device's own leg")
    ap.add_argument("--strict-cell", action="store_true",
                    help="gate the exit status on cell-bundle vertex "
                         "conv reproduction too (cold replay may flip "
                         "knife-edge cells a warm capture converged)")
    ap.add_argument("--json", dest="json_out", default=None,
                    help="also write the structured report here")
    args = ap.parse_args(argv)

    rep = replay_bundle(args.bundle, backend=args.backend,
                        kernel_only=args.kernel_only, kernel=args.kernel)
    if args.strict_cell and rep.get("kind") in ("cell", "recert"):
        rep["ok"] = bool(rep["ok"] and rep.get("cell_conv_reproduced"))
    for k in sorted(rep):
        print(f"{k}: {rep[k]}")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(rep, f, indent=2, default=str)
    if rep["ok"]:
        print("REPLAY OK: observed mask reproduced")
        return 0
    print("REPLAY MISMATCH: observed mask NOT reproduced")
    return 1


if __name__ == "__main__":
    sys.exit(main())
