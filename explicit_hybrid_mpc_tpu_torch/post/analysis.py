"""Partition and runtime statistics (post-processing layer).

The port's copy of the JAX package's post/analysis.py: machine-readable
reports from the port's Tree and from the RunLog JSONL stream
(``PartitionConfig.log_path``); figures live in post/figures.py.
Host-only (numpy), so the same Tree gives the same report in both
packages.
"""

from __future__ import annotations

import collections
import json

import numpy as np

from explicit_hybrid_mpc_tpu_torch.partition import geometry
from explicit_hybrid_mpc_tpu_torch.partition.tree import Tree


def partition_report(tree: Tree, roots: list[int] | None = None) -> dict:
    """Structural statistics of a built partition.

    Volume accounting is exact (children tile their parent): certified +
    infeasible + hole fractions sum to 1 over the root volume.  Holes are
    leaves with no payload below the depth cap -- nonzero only for
    truncated runs.
    """
    leaves = tree.leaves()
    # Materialize each leaf's payload ONCE: every leaf_data[i] access
    # builds a fresh LeafData view, and this report runs against
    # multi-million-region trees.
    lds = {i: tree.leaf_data[i] for i in leaves}
    cert = [i for i in leaves if lds[i] is not None]
    # Semi-explicit boundary leaves (mixed vertex feasibility closed via
    # cfg.semi_explicit_boundary_depth): covered, online-guaranteed via
    # the fixed-delta QP, but NOT eps-certified -- reported separately
    # from both certified volume and depth-cap best-effort volume.
    semi = {i for i in cert
            if getattr(lds[i], "semi_explicit", False)}
    # Depth-cap best-effort leaves carry a law but NO eps-certificate;
    # they must not inflate the certified-volume figure (getattr: trees
    # pickled before the `certified` field restore without it).
    best_effort = [i for i in cert if i not in semi
                   and not getattr(lds[i], "certified", True)]
    vol = {i: geometry.simplex_volume(tree.vertices[i]) for i in leaves}
    roots = roots if roots is not None else tree.roots()
    total = sum(geometry.simplex_volume(tree.vertices[r]) for r in roots)
    v_cert = (sum(vol[i] for i in cert) - sum(vol[i] for i in best_effort)
              - sum(vol[i] for i in semi))
    depths = np.asarray([tree.depth[i] for i in cert], dtype=np.int64)
    per_delta = collections.Counter(int(lds[i].delta_idx) for i in cert)
    gaps = [float(np.ptp(lds[i].vertex_costs)) for i in cert]
    return {
        "n_nodes": len(tree),
        "n_leaves": len(leaves),
        "n_regions": len(cert),
        "n_infeasible_or_hole": len(leaves) - len(cert),
        "volume_total": total,
        "volume_certified_frac": v_cert / total if total else 0.0,
        "n_best_effort": len(best_effort),
        "volume_best_effort_frac": (sum(vol[i] for i in best_effort)
                                    / total if total else 0.0),
        "n_semi_explicit": len(semi),
        "volume_semi_explicit_frac": (sum(vol[i] for i in semi)
                                      / total if total else 0.0),
        "depth_min": int(depths.min()) if depths.size else 0,
        "depth_max": int(depths.max()) if depths.size else 0,
        "depth_mean": float(depths.mean()) if depths.size else 0.0,
        "depth_hist": np.bincount(depths).tolist() if depths.size else [],
        "regions_per_delta": dict(sorted(per_delta.items())),
        "vertex_cost_spread_mean": float(np.mean(gaps)) if gaps else 0.0,
    }


def load_runlog(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def runtime_report(records: list[dict]) -> dict:
    """Throughput statistics from a build's RunLog stream (regions/sec
    is the build's north-star metric)."""
    steps = [r for r in records if "step" in r]
    done = [r for r in records if r.get("done")]
    if not steps:
        return {"n_steps": 0}
    t = np.asarray([r["t"] for r in steps])
    regions = np.asarray([r.get("regions", 0) for r in steps])
    solves = np.asarray([r.get("solves", 0) for r in steps])
    frontier = np.asarray([r.get("frontier", 0) for r in steps])
    dt = np.diff(np.concatenate([[0.0], t]))
    out = {
        "n_steps": len(steps),
        "wall_s": float(t[-1]),
        "regions_final": int(regions[-1]),
        "regions_per_s_overall": float(regions[-1] / max(t[-1], 1e-9)),
        "solves_final": int(solves[-1]),
        "solves_per_s_overall": float(solves[-1] / max(t[-1], 1e-9)),
        "frontier_peak": int(frontier.max()),
        "step_seconds_mean": float(dt.mean()),
        "step_seconds_p90": float(np.quantile(dt, 0.9)),
    }
    if done:
        out["final_stats"] = {k: v for k, v in done[-1].items()
                              if k not in ("t", "done")}
    return out
