"""Structured JSONL metrics (SURVEY.md section 6.5 build obligation).

The reference prints progress/ETA to stdout and pickles statistics
[M-med]; here every frontier step emits one JSON line so runs are
machine-readable (regions/sec is the north-star metric).

RunLog predates the obs subsystem (explicit_hybrid_mpc_tpu_torch/obs/) and is
now a thin compatibility shim over its sink: same ``emit(**fields)``
surface and flat JSONL layout (consumers grep for "step" / "done" /
"device_frac" fields -- scripts/long_build.py, scripts/profile_capture,
post.analysis.runtime_report), while gaining the sink's numpy coercion
(build stats carry np.float32/np.int64 fields that used to crash
json.dumps with a TypeError) and context-manager close-on-exception.
New instrumentation should use obs.Obs directly; this class exists for
the legacy per-step stream (PartitionConfig.log_path)."""

from __future__ import annotations

from typing import Optional

from explicit_hybrid_mpc_tpu_torch.obs.sink import JsonlSink


class RunLog:
    def __init__(self, path: Optional[str] = None, echo: bool = True,
                 base_t: float = 0.0):
        """base_t: cumulative elapsed seconds from PREVIOUS runs of a
        resumed run.  Appending to an existing JSONL with base_t=0 resets
        the `t` column mid-file and any d(regions)/d(t) consumer computes
        garbage at the boundary; resuming callers (scripts/long_build.py)
        pass their recovered cumulative wall so t stays monotonic."""
        # keep=False: long-campaign streams are millions of lines, and
        # RunLog's consumers read the FILE, never an in-memory list.
        self.sink = JsonlSink(path, echo=echo, base_t=base_t, keep=False)

    @property
    def t0(self) -> float:
        return self.sink.t0

    def emit(self, **fields) -> None:
        self.sink.emit("event", "runlog", **fields)

    def close(self) -> None:
        self.sink.close()

    def __enter__(self) -> "RunLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
