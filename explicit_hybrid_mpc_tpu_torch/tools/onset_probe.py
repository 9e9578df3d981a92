"""Certification-onset probes for the cluster-scale families: where the
satellite and quadrotor partitions stop fitting one device.

    python -m explicit_hybrid_mpc_tpu_torch.tools.onset_probe
    ONSET_FAMILIES=satellite_z ONSET_SCALES=0.5 \\
        python -m explicit_hybrid_mpc_tpu_torch.tools.onset_probe \\
        --backend cpu --out /tmp/onset.json

The JAX package's scripts/onset_probe.py, with its families, ladders,
knobs and JSON keys, on the port: each family is built at a ladder of
sub-box scales (box half-widths scaled by s) under precision='mixed',
as the JAX script builds them, on the card unless ``--backend cpu``.
Each rung records regions, uncertified, truncation, the certified
volume fraction (post/analysis.py partition_report) and, for a complete
build (not truncated, 0 uncertified) below scale 1, the full box's
region count projected as R * (1/s)^p (uniform density: a lower bound,
since regions crowd toward constraint boundaries).

Env: ONSET_OUT, ONSET_BUDGET (s a build, 300), ONSET_FAMILIES (comma
list, default satellite,quadrotor), ONSET_SCALES (comma floats,
overriding every family's ladder), the BENCH_* schedule knobs,
BENCH_PLATFORM.  The JSON goes to ``--out``, else ONSET_OUT, else a
fresh temp dir.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from explicit_hybrid_mpc_tpu_torch.tools.capture import (
    SENTINEL, choose_device, log, out_path, schedule_kwargs)

# family -> (problem name, eps_a, eps_r, scale ladder, kwargs builder)
FAMILIES = {
    "satellite": ("satellite", 1.0, 0.1, (0.1, 0.15, 0.25),
                  lambda s: {"axes": 3, "omega_box": 0.12 * s,
                             "h_box": 1.2 * s}),
    "quadrotor": ("quadrotor", 1.0, 0.1, (0.02, 0.05, 0.1),
                  lambda s: {"param": "pv", "pos_box": 4.0 * s,
                             "vel_box": 2.0 * s}),
    # smoke-test family: the 2-state satellite z-slice, seconds a build
    "satellite_z": ("satellite", 1.0, 0.1, (0.25, 1.0),
                    lambda s: {"axes": 1, "omega_box": 0.12 * s,
                               "h_box": 1.2 * s}),
}


def _flush(path: str, result: dict) -> None:
    with open(path, "w") as f:
        json.dump(result, f, indent=2)


def run(result: dict, path: str, dev) -> None:
    from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
    from explicit_hybrid_mpc_tpu_torch.oracle.oracle import Oracle
    from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
        build_partition)
    from explicit_hybrid_mpc_tpu_torch.post import analysis
    from explicit_hybrid_mpc_tpu_torch.problems.registry import make

    budget = float(os.environ.get("ONSET_BUDGET", "300"))
    fam_names = os.environ.get("ONSET_FAMILIES",
                               "satellite,quadrotor").split(",")
    scale_override = os.environ.get("ONSET_SCALES")
    on_card = dev.type == "cuda"

    sched_kw = schedule_kwargs(result)
    result["per_build_budget_s"] = budget
    fams: dict = {}
    result["families"] = fams
    for fam in fam_names:
        name, eps_a, eps_r, scales, kw_of = FAMILIES[fam]
        if scale_override:
            scales = tuple(float(x) for x in scale_override.split(","))
        rows: list = []
        fams[fam] = rows
        for s in scales:
            problem = make(name, **kw_of(s))
            orc = Oracle(problem, backend=dev.type, precision="mixed",
                         points_cap=2048 if on_card else 256, **sched_kw)
            cfg = PartitionConfig(problem=name, eps_a=eps_a, eps_r=eps_r,
                                  backend=dev.type, batch_simplices=256,
                                  max_steps=100_000, precision="mixed",
                                  time_budget_s=budget)
            res = build_partition(problem, cfg, oracle=orc)
            rep = analysis.partition_report(res.tree, res.roots)
            p = problem.n_theta
            complete = (not res.stats["truncated"]
                        and res.stats["uncertified"] == 0)
            row = {
                "scale": s, "n_theta": p,
                "regions": res.stats["regions"],
                "truncated": res.stats["truncated"],
                "uncertified": res.stats["uncertified"],
                "wall_s": round(res.stats["wall_s"], 2),
                "volume_certified_frac": round(
                    rep["volume_certified_frac"], 6),
                "complete": complete,
                "projected_full_box_regions": (
                    float(f"{res.stats['regions'] * (1.0 / s) ** p:.3g}")
                    if complete and s < 1.0 else None),
            }
            rows.append(row)
            log(f"  {fam} scale {s}: {row}")
            _flush(path, result)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m explicit_hybrid_mpc_tpu_torch.tools.onset_probe",
        description=__doc__.splitlines()[0])
    ap.add_argument("--backend", choices=("cuda", "cpu"), default=None,
                    help="'cuda' (the default, else BENCH_PLATFORM; "
                         "refuses to start without a card) or 'cpu'")
    ap.add_argument("--out", default=None,
                    help="the JSON's path (else ONSET_OUT, else a temp "
                         "dir)")
    ap.add_argument("--sentinel", default=SENTINEL,
                    help="the capture-active file held while this runs")
    args = ap.parse_args(argv)
    result: dict = {"captured_at": time.strftime("%Y-%m-%d %H:%M:%S")}
    dev = choose_device(result, args.backend, sentinel=args.sentinel)
    path = out_path(args.out, "ONSET_OUT", "onset_probes.json",
                    "onset_probe")
    try:
        run(result, path, dev)
    except BaseException as e:
        import traceback

        result["error"] = repr(e)
        traceback.print_exc(file=sys.stderr)
    finally:
        _flush(path, result)
        print(json.dumps(result))
    return 0 if "error" not in result else 1


if __name__ == "__main__":
    raise SystemExit(main())
