"""Flight recorder: bounded ring of recent obs records + repro bundles.

The torch port's counterpart of the JAX package's obs/recorder.py, with
the same bundle layout: ``BUNDLE_VERSION``, array keys and ``__meta__``
JSON are shared, so a bundle written by either package loads in the
other (tests/test_torch_diagnostics.py crosses them both ways).

A diverged IPM cohort, a device failure, a quarantined batch or an
uncertified leaf in a 12k-region build would otherwise leave nothing
behind but a counter.  The FlightRecorder turns each such anomaly into
a *versioned, compressed repro bundle* on disk: the exact solver inputs
(canonical QP matrices, query points, warm-start iterates, schedule and
precision flags, cell geometry) plus the last few hundred obs records
leading up to the event.  ``python -m
explicit_hybrid_mpc_tpu_torch.obs.replay BUNDLE`` re-runs a bundle
standalone -- no checkpoint, no problem registry, no build state -- and
must reproduce the original converged/diverged mask bit-for-bit, on the
card through the IPM kernel unless told ``--backend cpu``.

Wiring: ``cfg.obs_recorder`` (or ``cfg.recorder_dir``) makes the
frontier engine build one and point ``oracle.recorder`` at it; the obs
sink's ``tap`` feeds the ring.  Capture sites (each trigger dumps at
most ``max_bundles`` bundles per run):

- ``oracle/oracle.py``: point/pair cells that end *feasible but
  unconverged* after the full pipeline (two-phase cohort + rescue) and
  simplex rows that return -inf (no usable bound);
- ``partition/frontier.py``: batches a CPU build re-solved on its
  recovery twin after a device failure (with the observed masks),
  quarantined batches, and depth-capped *uncertified leaves* (cell
  geometry + vertex data via ``partition.certify.cell_snapshot``);
- ``partition/rebuild.py``: warm-rebuild leaves whose stored
  certificate failed re-certification (``recert``);
- ``oracle/ipm.py`` contributes ``solve_mask``, the bare-kernel probe
  of the replay's ``--kernel-only`` path.

Bundle format (``repro_<trigger>_<seq>.npz``, np.savez_compressed):
one ``__meta__`` JSON string (bundle_version, trigger, kind, oracle
schedule/precision, anomaly indices, the obs-record ring) plus flat
numpy arrays -- ``can_*`` canonical matrices, ``thetas``/``delta_idx``
(or ``bary_Ms`` / ``cell_verts``), optional ``warm_*`` donor iterates,
and the observed ``obs_conv``/``obs_feas``/``obs_V`` masks replay
compares against.  The oracle meta names the IPM leg in the JAX
package's tier words, so each package's reader takes the other's
bundles: ``"pallas"`` for the hand-written kernel (here the CUDA
kernel), ``"xla"`` for the plain version.

A capture that raises never breaks the solve or the build it observes;
each one is counted instead (``n_capture_errors`` and the
``recorder.capture_errors`` counter), so a run can show it lost none.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Optional

import numpy as np

from explicit_hybrid_mpc_tpu_torch.obs.sink import json_default

#: Bumped on any incompatible change to the bundle layout or the meta
#: fields the replay depends on (the JAX package's value).
BUNDLE_VERSION = 1

#: Canonical-matrix fields stored in every solver bundle (all of
#: problems.base.CanonicalMPQP: replay rebuilds the exact DeviceProblem
#: from these).
CANONICAL_FIELDS = ("H", "f", "F", "G", "w", "S", "Y", "pvec", "cconst",
                    "u_map", "u_theta", "u_const", "deltas")

#: The port's IPM leg -> the tier word a bundle records (module docs).
_TIER_WORD = {"cuda": "pallas", "torch": "xla"}


def canonical_arrays(can) -> dict:
    """CanonicalMPQP -> the bundle's ``can_*`` array dict."""
    return {f"can_{k}": np.asarray(getattr(can, k))
            for k in CANONICAL_FIELDS}


def oracle_meta(oracle) -> dict:
    """The solver-configuration fields replay needs to reconstruct an
    Oracle with bit-identical semantics (the contract of
    Oracle.cpu_twin)."""
    return {
        # Class name rides for triage: bundles from subclassed oracles
        # (PrunedOracle, SOCOracle) replay through the PLAIN Oracle --
        # decision-identical by those classes' own exactness contracts,
        # but not necessarily bitwise, and the report says why.
        "oracle_class": type(oracle).__name__,
        "n_iter": oracle.n_iter + oracle.n_f32,
        "precision": oracle.precision,
        "n_f32": (oracle.n_f32 if oracle.precision == "mixed" else None),
        "point_schedule": (list(oracle.point_schedule)
                           if oracle.point_schedule else None),
        "rescue_iter": oracle.rescue_iter,
        "two_phase": oracle.two_phase,
        "phase1_iters": oracle.phase1_iters,
        "warm_start": oracle.warm_start,
        "stage2_phase1_first": bool(oracle.stage2_phase1_first),
        # Resolved per-class schedules, so the --kernel-only replay
        # path can drive ipm.solve_mask without re-deriving the split.
        "point_n_f32": oracle.point_n_f32,
        "point_n_iter": oracle.point_n_iter,
        "simplex_n_f32": oracle.n_f32,
        "simplex_n_iter": oracle.n_iter,
        "ipm_kernel": _TIER_WORD.get(getattr(oracle, "ipm_kernel",
                                             "torch"), "xla"),
    }


class FlightRecorder:
    """Ring buffer of recent obs records + bundle writer (see module
    docstring).  Thread-safe: the ring is fed from the sink's tap (any
    emitting thread) and dumps may race between the build loop and a
    serving thread."""

    def __init__(self, out_dir: str, capacity: int = 256,
                 max_bundles: int = 16, ring_in_bundle: int = 64,
                 obs=None):
        """out_dir: bundle directory (created lazily on first dump).
        capacity: obs records kept in the ring.  max_bundles: hard cap
        on the bundles of ONE trigger written per recorder lifetime --
        an anomaly storm must not fill the disk; overflow is counted,
        not written.  Per trigger, unlike the JAX package's single cap
        over all triggers: a build meets its oracle anomalies (diverged
        cells, stalled simplex rows) from its first steps and its
        depth-capped leaves only at its end, so one shared cap filled
        with the former can leave no uncertified leaf a repro (it does
        on the flagship pendulum build).  At most max_bundles x the
        number of triggers (6) bundles a run.
        obs: optional obs.Obs handle; each dump emits a
        ``recorder.bundle`` event and bumps the ``recorder.bundles``
        counter through it, and ``recorder.capture_errors`` starts at
        0 there."""
        self.out_dir = out_dir
        self.max_bundles = max_bundles
        self.ring_in_bundle = ring_in_bundle
        self.obs = obs
        self.ring: collections.deque[dict] = collections.deque(
            maxlen=capacity)
        self.bundles: list[str] = []
        self._per_trigger: dict[str, int] = {}
        self.n_dropped = 0
        self.n_capture_errors = 0
        self._lock = threading.Lock()
        self._seq = 0
        if obs is not None and obs.enabled:
            obs.counter("recorder.capture_errors")

    # -- ring (sink tap) ---------------------------------------------------

    def note(self, rec: dict) -> None:
        """Sink-tap callback: remember one obs record.  Locked: dump()
        snapshots the ring from another thread, and iterating a deque
        while an appender mutates it raises."""
        with self._lock:
            self.ring.append(rec)

    # -- bundles -----------------------------------------------------------

    def dump(self, trigger: str, arrays: dict, meta: dict) -> Optional[str]:
        """Write one repro bundle; returns its path, or None when the
        trigger's max_bundles cap already hit (the overflow is counted
        so the run's stats still say how many anomalies occurred)."""
        with self._lock:
            if self._per_trigger.get(trigger, 0) >= self.max_bundles:
                self.n_dropped += 1
                return None
            self._per_trigger[trigger] = \
                self._per_trigger.get(trigger, 0) + 1
            self._seq += 1
            seq = self._seq
            ring = list(self.ring)[-self.ring_in_bundle:]
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir,
                            f"repro_{trigger}_{seq:03d}.npz")
        full_meta = {"bundle_version": BUNDLE_VERSION,
                     "trigger": trigger,
                     "created_unix": time.time(),
                     **meta,
                     "ring": ring}
        # Meta rides as a 0-d unicode array: np.load needs no pickle.
        np.savez_compressed(
            path,
            __meta__=np.array(json.dumps(full_meta, default=json_default)),
            **{k: np.asarray(v) for k, v in arrays.items()})
        with self._lock:
            self.bundles.append(path)
        o = self.obs
        if o is not None and o.enabled:
            o.counter("recorder.bundles").inc()
            # bundle_kind, not kind: `kind` is the record envelope's
            # own discriminator and must not be shadowed by a field.
            o.event("recorder.bundle", path=path, trigger=trigger,
                    bundle_kind=meta.get("kind"))
        return path

    def capture_error(self, site: str, err: BaseException) -> None:
        """Count one capture that raised at `site` (a full disk, a bad
        directory): the observed solve goes on, and the count says a
        repro was lost."""
        with self._lock:
            self.n_capture_errors += 1
        o = self.obs
        if o is not None and o.enabled:
            o.counter("recorder.capture_errors").inc()
            o.event("recorder.capture_error", site=site,
                    error=repr(err)[:200])


def load_bundle(path: str) -> tuple[dict, dict]:
    """(meta dict, arrays dict) from a bundle written by
    FlightRecorder.dump (either package's); raises on a bundle_version
    this reader does not know."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"][()]))
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    ver = meta.get("bundle_version")
    if ver != BUNDLE_VERSION:
        raise ValueError(f"bundle {path} has version {ver!r}; this "
                         f"reader understands {BUNDLE_VERSION}")
    return meta, arrays


def rebuild_canonical(arrays: dict):
    """Reconstruct the CanonicalMPQP a bundle's ``can_*`` arrays came
    from (the standalone half of replay: no problem registry, no
    constructor args -- the matrices ARE the problem)."""
    from explicit_hybrid_mpc_tpu_torch.problems.base import CanonicalMPQP

    return CanonicalMPQP(**{k: np.asarray(arrays[f"can_{k}"])
                            for k in CANONICAL_FIELDS})


class BundleProblem:
    """Minimal problem shim wrapping a rebuilt CanonicalMPQP -- exactly
    the surface Oracle.__init__ reads (canonical + the optional
    stage2_hint), so replay never needs the original problem class."""

    def __init__(self, canonical, stage2_hint: str | None = None):
        self.canonical = canonical
        if stage2_hint is not None:
            self.stage2_hint = stage2_hint
        self.n_theta = canonical.n_theta
        self.n_u = canonical.n_u
