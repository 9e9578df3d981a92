"""Thread-safe in-memory + JSONL record sink (the obs transport).

Every record is one JSON object carrying the versioned common envelope
-- `t` (seconds since the sink's epoch), `kind` ("span" | "event" |
"metrics" | "meta") and `name` -- plus flat producer fields.  numpy
scalars/arrays are coerced by the encoder's `default=` hook: build
stats carry np.float32/np.int64 fields and the bare json.dumps used to
raise TypeError mid-run (tests/test_obs.py pins the regression).  The
full schema is documented in docs/observability.md.
"""

from __future__ import annotations

import atexit
import json
import os
import sys
import threading
import time
from typing import IO, Callable, Optional

import numpy as np

# Bumped whenever the record envelope or a producer's field layout
# changes incompatibly; the sink stamps it into the stream's leading
# `meta`/`schema` record and readers (scripts/obs_report.py) check it.
# v2 (fleet telemetry): every stream's second record is a
# `meta`/`stream` IDENTITY record -- run_id, host, pid, process
# index/count, and the wall-vs-monotonic clock anchor (obs/clock.py)
# that lets obs/fleet.py merge N per-process streams onto one time
# axis.  v1 streams (no identity record) still load everywhere;
# fleet-level readers treat them as anchor-less legacy shards.
SCHEMA_VERSION = 2


def json_default(o):
    """`json.dumps(default=...)` hook: numpy scalars become Python
    scalars, arrays become lists, and anything else degrades to repr --
    a record must never fail to serialize (observability crashing the
    instrumented run is the worst possible trade)."""
    if isinstance(o, np.generic):
        return o.item()
    if isinstance(o, np.ndarray):
        return o.tolist()
    return repr(o)


class JsonlSink:
    """Append-only record sink: in-memory list + optional JSONL file.

    Thread-safe: the build loop, the serving path, and background
    samplers may emit concurrently.
    Context manager so the file handle closes on exceptions (the old
    RunLog leaked its handle on any raise between open and close --
    satellite fix)."""

    def __init__(self, path: Optional[str] = None, echo: bool = False,
                 base_t: float = 0.0, keep: bool = True,
                 max_records: int = 500_000,
                 schema_meta: bool = False,
                 tap: Optional[Callable[[dict], None]] = None,
                 fsync_every: int = 0):
        """base_t: cumulative elapsed seconds from PREVIOUS runs of
        a resumed run, so the `t` column stays monotonic across an
        append boundary (see utils.logging.RunLog).  keep=False skips
        the in-memory list (multi-hour JSONL streams are millions of
        lines; file-only consumers never read it).  max_records bounds
        the in-memory list -- the FILE stream keeps everything, only
        the memory copy stops growing (n_dropped counts the overflow).
        tap: optional callable invoked with every record dict after it
        is written (the flight recorder's ring-buffer feed,
        obs/recorder.py); may also be assigned later via `sink.tap`.
        fsync_every: durable mode (utils/atomic.py) -- fsync the
        stream file every N records (and at close), bounding how much
        of the tail a power loss can take; 0 (default) keeps the
        flush-only behavior (an OS crash can lose page-cache tail, a
        process crash cannot -- every line is flushed)."""
        self._lock = threading.Lock()
        self._fsync_every = int(fsync_every)
        self._since_fsync = 0
        self._fh: Optional[IO[str]] = open(path, "a") if path else None
        self.path = path
        self._echo = echo
        self._keep = keep
        self._max_records = max_records
        self.tap = tap
        self.records: list[dict] = []
        self.n_dropped = 0
        self.t0 = time.perf_counter() - base_t
        # Crash-path flush: a build that dies on an uncaught exception /
        # SystemExit unwinds the interpreter without passing through
        # close() when the sink is not used as a context manager; the
        # atexit hook closes (and thereby flushes) the handle so the
        # stream's tail survives.  Unregistered again in close() so
        # short-lived sinks do not pile up callbacks for the process
        # lifetime.  (SIGKILL needs no handler: emit() flushes every
        # line, so at most the record being written is lost -- and
        # load_jsonl tolerates that truncated final line.)
        if self._fh is not None:
            atexit.register(self.close)
        if schema_meta:
            self.emit("meta", "schema", version=SCHEMA_VERSION)
            # Stream identity + clock anchor (schema v2, obs/clock.py):
            # the record's own `t` with its wall_time field is the
            # monotonic-vs-wall anchor fleet merging aligns on.
            from explicit_hybrid_mpc_tpu_torch.obs import clock

            self.emit("meta", "stream", **clock.identity())

    def _unregister_atexit(self) -> None:
        try:
            atexit.unregister(self.close)
        # tpulint: justification -- atexit can raise arbitrarily while
        # the interpreter tears down; there is nowhere left to report.
        except Exception:  # tpulint: disable=silent-except -- teardown
            pass

    def emit(self, kind: str, name: str, **fields) -> dict:
        rec = {"t": round(time.perf_counter() - self.t0, 6),
               "kind": kind, "name": name, **fields}
        # Serialized only for the file and the echo: an in-memory stream
        # (a serving process's, a bench's) keeps the dict.
        line = json.dumps(rec, default=json_default) \
            if self._fh or self._echo else None
        with self._lock:
            if self._keep:
                if len(self.records) < self._max_records:
                    self.records.append(rec)
                else:
                    self.n_dropped += 1
            if self._fh:
                self._fh.write(line + "\n")
                self._fh.flush()
                if self._fsync_every:
                    self._since_fsync += 1
                    if self._since_fsync >= self._fsync_every:
                        self._since_fsync = 0
                        from explicit_hybrid_mpc_tpu_torch.utils import atomic

                        atomic.fsync_fileobj(self._fh)
        if self._echo:
            print(line, file=sys.stderr)
        if self.tap is not None:
            self.tap(rec)
        return rec

    def close(self) -> None:
        with self._lock:
            if self._fh:
                if self._fsync_every:
                    from explicit_hybrid_mpc_tpu_torch.utils import atomic

                    try:
                        atomic.fsync_fileobj(self._fh)
                    except OSError:
                        pass  # closing anyway; fsync is best-effort here
                self._fh.close()
                self._fh = None
        self._unregister_atexit()

    def __enter__(self) -> "JsonlSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def load_jsonl(path: str, tolerant_tail: bool = True) -> list[dict]:
    """Parse a JSONL stream back into records (shared by
    scripts/obs_report.py, scripts/obs_watch.py, post-processing, and
    the schema tests).

    tolerant_tail (default): a writer killed mid-record (SIGKILL, OOM)
    leaves one truncated final line; it is silently dropped so the rest
    of the stream stays readable -- the crashed run is exactly when the
    stream matters most.  Corruption anywhere EARLIER still raises: a
    mangled middle means the file itself is damaged, not merely cut
    short.

    Bare-name resolution: a per-process writer (``Obs(per_process=
    True)`` / ``cfg.obs_per_process``) suffixes the configured path with
    ``.pI-PID``, so the bare name a reader was handed may not exist.
    When exactly one suffixed sibling does, it is read transparently;
    several siblings raise, naming the fleet reader
    (obs.fleet.load_fleet), instead of silently picking one shard's
    stream.
    """
    if not os.path.exists(path):
        from explicit_hybrid_mpc_tpu_torch.obs import fleet

        sibs = fleet.sibling_streams(path)
        if len(sibs) == 1:
            path = sibs[0]
        elif sibs:
            raise FileNotFoundError(
                f"{path} does not exist but {len(sibs)} per-process "
                f"streams do ({', '.join(os.path.basename(s) for s in sibs[:4])}"
                f"{', ...' if len(sibs) > 4 else ''}): merge them with "
                "obs.fleet.load_fleet instead of reading one shard")
    recs: list[dict] = []
    bad_at = None
    with open(path) as f:
        for ln in f:
            if not ln.strip():
                continue
            if bad_at is not None:
                raise json.JSONDecodeError(
                    "non-final corrupt record", ln, 0)
            try:
                recs.append(json.loads(ln))
            except json.JSONDecodeError:
                if not tolerant_tail:
                    raise
                bad_at = ln  # tolerated only if nothing follows
    return recs
