"""Stream identity + clock anchoring for fleet telemetry.

Every obs stream's ``t`` column is MONOTONIC seconds since its sink's
epoch (``time.perf_counter`` based -- immune to NTP steps, meaningless
across processes).  One process's ``t=3.2`` and another's ``t=3.2``
can be minutes apart in real time, so N per-process streams cannot be
merged on ``t`` alone.  The identity record every schema-v2 sink
stamps (obs/sink.py) therefore carries a **clock anchor**: the wall
clock (``time.time``) and the stream's own ``t``, captured at the same
instant.  ``to_wall(identity, t)`` maps any record's stream time onto
the shared wall axis, which is what ``obs/fleet.py`` sorts merged
fleet views by.

Caveat the reader must keep in mind: wall clocks across HOSTS agree
only as well as NTP does (typically ms, occasionally worse).  Within
one host -- the supervised-restart chain, co-host replicas -- the
anchor is exact to the two back-to-back clock reads.

``run_id`` identifies one logical run ACROSS processes: a fleet
launcher (scripts/supervise_build.py, a pod launcher) exports
``EHM_RUN_ID`` so every child stamps the same id; a standalone process
mints its own.  The id also lands in bench rows (bench.py) so a
BENCH_HISTORY entry is joinable back to its obs streams.
"""

from __future__ import annotations

import os
import socket
import sys
import time
import uuid

#: Env var a fleet launcher exports so all its processes share one
#: run id (scripts/supervise_build.py sets it for the restart chain).
RUN_ID_ENV = "EHM_RUN_ID"

_run_id: str | None = None


def run_id() -> str:
    """This process's run id: ``EHM_RUN_ID`` when a launcher set it,
    else a fresh 12-hex id minted once per process."""
    global _run_id
    if _run_id is None:
        _run_id = os.environ.get(RUN_ID_ENV) or uuid.uuid4().hex[:12]
    return _run_id


def new_run_id() -> str:
    """A fresh id for a launcher to export as ``EHM_RUN_ID``."""
    return uuid.uuid4().hex[:12]


def _safe_process_coords() -> dict:
    """process_index / process_count WITHOUT initializing any backend.

    Reads only state that already exists: the torch.distributed
    process group when torch.distributed is ALREADY imported and
    initialized, else the launcher-provided RANK / WORLD_SIZE env
    vars, else the single-process default (rank 0 of 1).
    """
    dist = sys.modules.get("torch.distributed")
    if dist is not None:
        try:
            if dist.is_available() and dist.is_initialized():
                return {"process_index": int(dist.get_rank()),
                        "process_count": int(dist.get_world_size())}
        except (RuntimeError, ValueError):  # best-effort identity probe
            pass
    try:
        return {"process_index": int(os.environ.get("RANK", 0)),
                "process_count": int(os.environ.get("WORLD_SIZE", 1))}
    except ValueError:
        return {"process_index": 0, "process_count": 1}


def identity() -> dict:
    """The stream-identity fields the v2 sink stamps into its leading
    ``meta``/``stream`` record (docs/observability.md "Fleet
    telemetry").  The emitting sink adds its own ``t``; the
    (``t``, ``wall_time``) pair is the stream's clock anchor."""
    coords = _safe_process_coords()
    return {"run_id": run_id(),
            "host": socket.gethostname(),
            "pid": os.getpid(),
            "wall_time": time.time(),
            **coords}


def wall_offset(identity_rec: dict) -> float | None:
    """Stream-t -> wall-clock offset from an identity record, i.e.
    ``wall = offset + t`` for every record of that stream.  None when
    the record carries no anchor (schema-v1 legacy streams)."""
    w = identity_rec.get("wall_time") if identity_rec else None
    t = identity_rec.get("t") if identity_rec else None
    if isinstance(w, (int, float)) and isinstance(t, (int, float)):
        return float(w) - float(t)
    return None


def to_wall(identity_rec: dict, t: float) -> float | None:
    """Absolute wall time of a record with stream time `t`, or None
    for anchor-less legacy streams."""
    off = wall_offset(identity_rec)
    return None if off is None else off + float(t)
