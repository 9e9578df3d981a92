"""Profiler capture on torch.profiler + Chrome-trace summarization.

The torch port's counterpart of the JAX package's obs/profiling.py,
on ``torch.profiler`` in place of ``jax.profiler``.  Two consumers share
this module:

- the frontier engine's manual capture (``cfg.profile_path``, CLI
  ``--profile``): ``start_trace`` / ``stop_trace`` around the first
  ``profile_steps`` frontier steps, written as a Chrome trace
  (``export_chrome_trace``) that ``summarize_trace`` reads;
- ``AutoProfiler``: bounded capture.  With ``cfg.auto_profile`` (CLI
  ``--auto-profile``) the frontier engine arms one; a trigger (the
  engine's ``trigger_auto_profile``, or the first CRITICAL in-build
  health verdict once obs/health.py is ported) opens a capture bounded
  to ``profile_steps`` frontier steps (and a hard wall ceiling), then
  writes a summarized ``auto_profile_NNN.json`` bundle.  At most
  ``max_captures`` (default 1) per run: a capture is expensive and the
  first one carries the evidence.  Raw traces go to a scratch dir; the
  evidence is the summary JSON.

A capture records CPU activity, plus the card's kernels and copies
(CUDA activity) when the build's device is a CUDA device.  In the
summary, kernel names (``ipm_leg_fixed``, ...) stand where the JAX
package's summary names XLA ops.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import time
from typing import Optional

#: Chrome-trace event categories that torch.profiler gives work on the
#: card (kernels, copies, memsets): the summary's device ops.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def start_trace(device):
    """Open and start a torch.profiler capture: CPU activity, plus CUDA
    activity when `device` (a torch.device or its string) is a CUDA
    device.  Returns the running profiler for ``stop_trace``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def stop_trace(prof, trace_dir: str, name: str = "profile") -> str:
    """Stop `prof` and write its Chrome trace to
    ``<trace_dir>/<name>.trace.json``; returns the path."""
    prof.stop()
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"{name}.trace.json")
    prof.export_chrome_trace(path)
    return path


def summarize_trace(trace_dir: str, top_n: int = 25) -> dict:
    """Top ops by summed duration from the Chrome-trace JSON(.gz) files
    under `trace_dir` (any depth), with the JAX package's keys
    (trace_files, events, tracks, top_ops_ms), plus ``device_ops_ms``:
    the same ranking over the card's events alone (DEVICE_CATEGORIES;
    empty for a CPU capture)."""
    paths = (glob.glob(os.path.join(trace_dir, "**", "*.trace.json.gz"),
                       recursive=True)
             + glob.glob(os.path.join(trace_dir, "**", "*.trace.json"),
                         recursive=True))
    if not paths:
        return {"error": f"no trace files under {trace_dir}"}
    by_name: dict[str, float] = {}
    by_device: dict[str, float] = {}
    pid_names: dict = {}
    total_events = 0
    for path in paths:
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as f:
            data = json.load(f)
        for ev in data.get("traceEvents", []):
            if ev.get("ph") == "M" and ev.get("name") == "process_name":
                pid_names[ev.get("pid")] = ev["args"].get("name", "")
            if ev.get("ph") != "X" or "dur" not in ev:
                continue
            total_events += 1
            name = ev.get("name", "?")[:120]
            by_name[name] = by_name.get(name, 0.0) + ev["dur"]
            if ev.get("cat") in DEVICE_CATEGORIES:
                by_device[name] = by_device.get(name, 0.0) + ev["dur"]

    def top(d: dict) -> list:
        return [{"name": n, "total_ms": round(v / 1e3, 3)}
                for n, v in sorted(d.items(), key=lambda kv: -kv[1])[:top_n]]

    return {
        "trace_files": len(paths),
        "events": total_events,
        "tracks": sorted(set(pid_names.values())),
        "top_ops_ms": top(by_name),
        "device_ops_ms": top(by_device),
    }


class AutoProfiler:
    """Bounded torch.profiler capture (module docs).

    Driven by the frontier engine: ``trigger(reason)`` opens a capture
    (no-op while one is open or after ``max_captures``);
    ``on_step(obs)`` advances/closes it (called at the end of every
    frontier step); ``finish(obs)`` closes a capture the run ended
    inside.  All profiler interaction is guarded -- a profiler that
    cannot start (another capture active, an unwritable dir) records
    the error in the bundle instead of taking the build down: capture is
    diagnostics, never load-bearing.  `device`: the build's device (CUDA
    activity is recorded on a CUDA device)."""

    def __init__(self, out_dir: str, steps: int = 5,
                 max_captures: int = 1, max_wall_s: float = 120.0,
                 trace_dir: Optional[str] = None, device="cpu"):
        self.out_dir = out_dir
        self.steps = max(1, int(steps))
        self.max_captures = max(1, int(max_captures))
        self.max_wall_s = float(max_wall_s)
        self.trace_dir = trace_dir or os.path.join(
            out_dir, "auto_profile_trace")
        self.device = device
        self.n_captures = 0
        self.bundles: list[str] = []
        self._active = False
        self._prof = None
        self._steps_left = 0
        self._t_start = 0.0
        self._reason: Optional[dict] = None

    @property
    def active(self) -> bool:
        return self._active

    def trigger(self, reason: str, detail: Optional[dict] = None,
                obs=None, step: Optional[int] = None) -> bool:
        """Open a capture for `reason`; returns True when one started."""
        if self._active or self.n_captures >= self.max_captures:
            return False
        try:
            os.makedirs(self.trace_dir, exist_ok=True)
            self._prof = start_trace(self.device)
        except Exception as e:  # diagnostics must never kill the build
            # (full disk, unwritable dir, profiler already active, ...)
            self.n_captures += 1  # burn the budget: retrying won't help
            self._write_bundle({"reason": reason, "detail": detail,
                                "step": step,
                                "error": f"start_trace failed: {e!r}"},
                               obs)
            return False
        self.n_captures += 1
        self._active = True
        self._steps_left = self.steps
        self._t_start = time.perf_counter()
        self._reason = {"reason": reason, "detail": detail, "step": step}
        if obs is not None:
            obs.event("profile.capture_start", reason=reason, step=step,
                      trace_dir=self.trace_dir, steps=self.steps)
        return True

    def on_step(self, obs=None) -> Optional[str]:
        """Advance an open capture one frontier step; closes it (and
        returns the bundle path) once the step budget or the wall
        ceiling is spent."""
        if not self._active:
            return None
        self._steps_left -= 1
        if self._steps_left > 0 \
                and time.perf_counter() - self._t_start < self.max_wall_s:
            return None
        return self._stop(obs)

    def finish(self, obs=None) -> Optional[str]:
        """Close a capture the run ended inside (frontier drained or
        halted mid-window)."""
        if not self._active:
            return None
        return self._stop(obs)

    def _stop(self, obs) -> Optional[str]:
        self._active = False
        prof, self._prof = self._prof, None
        try:
            stop_trace(prof, self.trace_dir,
                       name=f"auto_profile_{self.n_captures:03d}")
        except Exception as e:
            return self._write_bundle(
                {**(self._reason or {}),
                 "error": f"stop_trace failed: {e!r}"}, obs)
        meta = dict(self._reason or {})
        meta["captured_steps"] = self.steps - max(0, self._steps_left)
        meta["capture_wall_s"] = round(
            time.perf_counter() - self._t_start, 3)
        meta["trace_dir"] = self.trace_dir
        try:
            meta["trace_summary"] = summarize_trace(self.trace_dir)
        except Exception as e:  # corrupt trace file etc.
            meta["error"] = f"summarize failed: {e!r}"
        return self._write_bundle(meta, obs)

    def _write_bundle(self, meta: dict, obs) -> Optional[str]:
        """Best-effort bundle write: a full disk at capture-close time
        must not take the build down with it (the event record still
        carries the error so the failure is visible in the stream)."""
        path = None
        try:
            os.makedirs(self.out_dir, exist_ok=True)
            n = len(self.bundles) + 1
            path = os.path.join(self.out_dir,
                                f"auto_profile_{n:03d}.json")
            with open(path, "w") as f:
                json.dump(meta, f, indent=2)
            self.bundles.append(path)
        except Exception as e:
            meta = {**meta, "error": f"bundle write failed: {e!r}"}
            path = None
        if obs is not None:
            obs.event("profile.capture", path=path,
                      reason=meta.get("reason"),
                      error=meta.get("error"))
            obs.counter("build.auto_profiles").inc()
        return path
