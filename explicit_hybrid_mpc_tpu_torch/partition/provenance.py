"""Build provenance stamps for trees, checkpoints, and serving artifacts.

A built tree is only meaningful RELATIVE to the problem and solver
configuration that produced it: deploying a tree against a revised plant
model, or warm-rebuilding from a tree whose eps targets drifted, silently
serves/reuses certificates that no longer mean what the consumer thinks
they mean.  Every writer therefore stamps its artifact with a provenance
dict -- the canonical-problem content hash, the eps targets, the solver
schedule knobs that change solve RESULTS (not just speed), and the
code/schema versions -- and every loader can compare a found stamp
against the problem/config it is about to use:

- ``Tree.provenance`` rides the tree pickle (and therefore every
  checkpoint, which pickles the tree);
- ``online/export.write_leaf_table``/``save_leaf_table`` put the stamp
  into the table's ``meta.json``; ``load_leaf_table`` checks it;
- ``serve/registry.save_artifacts``/``load_artifacts`` stamp/check the
  serving artifact directory (a deploy against the wrong problem is the
  serving-side failure this catches);
- ``partition/rebuild.py`` reads the prior stamp to report exactly WHAT
  changed between revisions (the invalidation telemetry), and rejects
  priors whose geometry cannot transfer at all.

Mismatch policy: loaders WARN by default (``ProvenanceWarning``) and
raise ``ProvenanceMismatch`` under ``strict=True``; artifacts written
before stamping existed ("legacy") load with a one-line unstamped
warning, never an error.  docs/perf.md "Incremental warm rebuild"
documents the format.
"""

from __future__ import annotations

import hashlib
import warnings

import numpy as np

#: Version of the stamp schema itself (bump on incompatible layout
#: changes; readers tolerate unknown EXTRA keys at the same version).
PROVENANCE_VERSION = 1

#: CanonicalMPQP fields folded into the problem hash, in fixed order.
#: This is the COMPLETE canonical problem: two problems hash equal iff
#: every matrix the oracle consumes is bit-equal.
_CANONICAL_FIELDS = ("H", "f", "F", "G", "w", "S", "Y", "pvec", "cconst",
                     "u_map", "u_theta", "u_const", "deltas")

#: Solver config knobs that change solve RESULTS (iterate trajectories,
#: convergence patterns) rather than just wall time.  Pipeline/obs/
#: output knobs are deliberately absent: they are bit-invisible to the
#: produced tree and must not invalidate reuse.
_SOLVER_FIELDS = ("backend", "precision", "ipm_point_schedule",
                  "ipm_rescue_iters", "ipm_two_phase", "ipm_phase1_iters",
                  "ipm_phase1_iters_point", "ipm_phase1_iters_simplex",
                  "warm_start_tree", "ipm_kernel")


class ProvenanceWarning(UserWarning):
    """Loader found a missing or mismatched provenance stamp."""


class ProvenanceMismatch(ValueError):
    """Strict-mode loader rejection: the artifact's stamp does not
    match the expected problem/config."""


def problem_hash(problem) -> str:
    """Content hash of a problem's canonical mp-QP family + box.

    Hashes every canonical matrix (shape, dtype, raw bytes) plus the
    certified parameter box and root splits, so any revision the oracle
    or the geometry could observe changes the hash; solver knobs do NOT
    enter (they live in the stamp's ``solver`` block)."""
    can = getattr(problem, "canonical", problem)
    h = hashlib.sha256()
    for name in _CANONICAL_FIELDS:
        a = np.ascontiguousarray(getattr(can, name))
        h.update(name.encode())
        h.update(repr((a.shape, str(a.dtype))).encode())
        h.update(a.tobytes())
    for name in ("theta_lb", "theta_ub"):
        v = getattr(problem, name, None)
        if v is not None:
            h.update(name.encode())
            h.update(np.ascontiguousarray(v, dtype=np.float64).tobytes())
    rs = getattr(problem, "root_splits", None)
    if rs is not None:
        h.update(repr(rs).encode())
    return h.hexdigest()[:16]


def build_stamp(problem, cfg) -> dict:
    """The provenance stamp for a build of `problem` under `cfg`.

    getattr-safe over cfg so configs unpickled from before a knob
    existed stamp with that knob absent rather than crashing."""
    from explicit_hybrid_mpc_tpu_torch import __version__
    from explicit_hybrid_mpc_tpu_torch.obs.sink import SCHEMA_VERSION

    solver = {k: getattr(cfg, k, None) for k in _SOLVER_FIELDS}
    # Tuples survive JSON round-trips as lists; normalize at write time
    # so a stamp read back from meta.json compares equal to a fresh one.
    if solver.get("ipm_point_schedule") is not None:
        solver["ipm_point_schedule"] = list(solver["ipm_point_schedule"])
    return {
        "provenance_version": PROVENANCE_VERSION,
        "problem": getattr(cfg, "problem", None),
        "problem_args": [list(kv) for kv in
                         getattr(cfg, "problem_args", ()) or ()],
        "problem_hash": problem_hash(problem),
        "eps_a": float(getattr(cfg, "eps_a", 0.0)),
        "eps_r": float(getattr(cfg, "eps_r", 0.0)),
        "algorithm": getattr(cfg, "algorithm", "suboptimal"),
        "solver": solver,
        "code_version": __version__,
        "obs_schema_version": SCHEMA_VERSION,
        "tree_schema": "columnar-v2",
    }


#: Stamp keys whose drift means the CERTIFICATES no longer transfer
#: as-is (the warm-rebuild invalidation axes); compared first and
#: reported by name.
_CERT_KEYS = ("problem_hash", "eps_a", "eps_r", "algorithm")


def diff_stamps(found: dict | None, expected: dict | None) -> list[str]:
    """Human-readable field-level differences between two stamps.

    Empty list = stamps agree on every certificate-relevant key and
    every solver knob BOTH sides recorded.  A missing stamp on either
    side reports as a single 'unstamped' line."""
    if found is None or expected is None:
        which = "artifact" if found is None else "expected reference"
        return [f"{which} carries no provenance stamp (legacy, "
                "pre-stamp writer)"]
    diffs = []
    for k in _CERT_KEYS:
        if found.get(k) != expected.get(k):
            diffs.append(f"{k}: {found.get(k)!r} != {expected.get(k)!r}")
    fs, es = found.get("solver") or {}, expected.get("solver") or {}
    for k in sorted(set(fs) & set(es)):
        if fs[k] != es[k]:
            diffs.append(f"solver.{k}: {fs[k]!r} != {es[k]!r}")
    return diffs


def check_stamp(found: dict | None, expected: dict | None, where: str,
                strict: bool = False) -> list[str]:
    """Compare an artifact's stamp against the expected one; returns
    the differences.  Warn-by-default (``ProvenanceWarning``), raise
    ``ProvenanceMismatch`` under strict -- EXCEPT for a legacy
    unstamped artifact, which warns even under strict only when an
    expectation exists (there is nothing to compare; rejecting every
    pre-stamp file would brick all existing deploys)."""
    if expected is None:
        return []
    diffs = diff_stamps(found, expected)
    if not diffs:
        return diffs
    msg = (f"provenance mismatch in {where}: " + "; ".join(diffs)
           + " -- the artifact was built for a different problem/"
           "config (docs/perf.md, 'Incremental warm rebuild')")
    if strict and found is not None:
        raise ProvenanceMismatch(msg)
    warnings.warn(msg, ProvenanceWarning, stacklevel=3)
    return diffs
