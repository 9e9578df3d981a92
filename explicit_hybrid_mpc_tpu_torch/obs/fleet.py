"""Fleet telemetry: merge N per-process obs streams into one view.

The torch port's counterpart of the JAX package's obs/fleet.py: the same
functions, keys and rules, over streams that either package wrote
(tests/test_torch_fleet.py folds the port's per-process streams with
both packages and compares the results).

- **Per-process stream naming** (``per_process_path``): two processes
  writing one artifacts dir (supervised restarts, several builds on one
  card, co-host serve replicas) must never interleave one file -- a
  crashed writer's torn line mid-file makes ``load_jsonl`` reject the
  whole stream.  Each process suffixes the configured path with
  ``.pI-PID``; readers resolve the old bare name transparently
  (``sibling_streams`` / sink.load_jsonl) and fleet readers glob the
  family.
- **Identity-aware loading** (``load_stream`` / ``load_fleet``): the
  schema-v2 ``meta``/``stream`` record (obs/sink.py + obs/clock.py)
  names each stream's run_id / host / pid / process index and carries
  the wall-vs-monotonic clock anchor.  v1 streams load as anchor-less
  legacy shards (``identity=None``) -- tolerated, but flagged by
  ``strict_issues`` so a strict reader can refuse to fold
  unidentifiable streams together silently.
- **Time-aligned merge** (``merge_events``): every record gains its
  shard label and an absolute ``t_abs`` (anchor offset + stream t),
  and the merged view sorts on it -- cross-process event ordering
  that per-stream monotonic ``t`` cannot give.
- **Exact rollup** (``fleet_rollup``): counters SUM bit-exactly
  across shards' final snapshots (integers), fixed-bound histograms
  merge bucket-wise (same bounds by construction, obs/metrics.py), and
  gauges stay per-shard (summing a last-write-wins gauge is
  meaningless; ``build.regions`` reports the max, documented).
- **Straggler / imbalance attribution** (``straggler_report``) and the
  fleet health rules ``max_shard_straggle_frac`` / ``fleet_stall``
  (``FleetMonitor``).
"""

from __future__ import annotations

import dataclasses
import glob as glob_mod
import os
import re
from typing import Iterable, Optional

from explicit_hybrid_mpc_tpu_torch.obs import clock
from explicit_hybrid_mpc_tpu_torch.obs.health import (
    HealthMonitor, _SEVERITY, rules_from_pairs)
from explicit_hybrid_mpc_tpu_torch.obs.sink import load_jsonl

#: Per-process suffix: .p<process_index>-<pid> inserted before the
#: final extension.  The pid keeps a supervised RESTART CHAIN apart
#: (same process_index, new process per attempt).
_SUFFIX_RE = re.compile(r"\.p(\d+)-(\d+)$")


def per_process_path(path: str, process_index: Optional[int] = None,
                     pid: Optional[int] = None) -> str:
    """``X.obs.jsonl`` -> ``X.obs.p0-12345.jsonl`` (suffix before the
    extension; appended outright when the path has none)."""
    if process_index is None:
        process_index = clock._safe_process_coords()["process_index"]
    if pid is None:
        pid = os.getpid()
    base, ext = os.path.splitext(path)
    return f"{base}.p{process_index}-{pid}{ext}"


def sibling_streams(path: str) -> list[str]:
    """Existing per-process variants of a BARE stream name, sorted."""
    base, ext = os.path.splitext(path)
    return sorted(glob_mod.glob(f"{base}.p*-*{ext}"))


def resolve_streams(pattern: str) -> list[str]:
    """Stream paths for a fleet argument: a glob pattern, a directory
    (every ``*.jsonl`` inside), or a bare stream name (itself plus its
    per-process siblings)."""
    if os.path.isdir(pattern):
        return sorted(glob_mod.glob(os.path.join(pattern, "*.jsonl")))
    hits = sorted(glob_mod.glob(pattern))
    if hits:
        return hits
    out = ([pattern] if os.path.exists(pattern) else []) \
        + sibling_streams(pattern)
    return sorted(set(out))


@dataclasses.dataclass
class StreamInfo:
    """One loaded stream: records + the identity that names its shard."""

    path: str
    records: list
    identity: Optional[dict]  # the meta/stream record; None on v1
    schema_version: Optional[int]
    shard: str  # display label: "p<idx>:<pid>" or a filename-derived tag

    @property
    def wall_offset(self) -> Optional[float]:
        return clock.wall_offset(self.identity) if self.identity else None


def _shard_label(path: str, identity: Optional[dict]) -> str:
    if identity is not None and "pid" in identity:
        return f"p{identity.get('process_index', 0)}:{identity['pid']}"
    m = _SUFFIX_RE.search(os.path.splitext(path)[0])
    if m:
        return f"p{m.group(1)}:{m.group(2)}"
    return os.path.basename(path)


def load_stream(path: str) -> StreamInfo:
    recs = load_jsonl(path)
    ver = None
    ident = None
    for r in recs[:4]:  # identity is by contract in the leading records
        if r.get("kind") != "meta":
            continue
        if r.get("name") == "schema":
            ver = r.get("version")
        elif r.get("name") == "stream":
            ident = r
    return StreamInfo(path=path, records=recs, identity=ident,
                      schema_version=ver,
                      shard=_shard_label(path, ident))


def load_fleet(pattern_or_paths) -> list[StreamInfo]:
    """Load every stream a fleet argument names; raises on zero.

    Shard labels are made UNIQUE across the fleet: (process_index,
    pid) collides across hosts (containerized replicas commonly all
    run as pid 1), and a duplicate label would silently overwrite the
    other shard's row in every shard-keyed aggregate (rollup,
    straggler report, FleetMonitor).  Colliding labels gain the
    stream's host (then its filename) as a disambiguator."""
    if isinstance(pattern_or_paths, str):
        paths = resolve_streams(pattern_or_paths)
    else:
        paths = list(pattern_or_paths)
    if not paths:
        raise FileNotFoundError(
            f"no obs streams match {pattern_or_paths!r}")
    streams = [load_stream(p) for p in paths]
    seen: dict[str, int] = {}
    for s in streams:
        seen[s.shard] = seen.get(s.shard, 0) + 1
    for s in streams:
        if seen[s.shard] > 1:
            host = (s.identity or {}).get("host")
            s.shard = (f"{s.shard}@{host}" if host
                       else f"{s.shard}@{os.path.basename(s.path)}")
    # A same-host same-pid collision (restart chains cannot produce
    # one; hand-built fixtures can) falls back to the path.
    seen2: dict[str, int] = {}
    for s in streams:
        seen2[s.shard] = seen2.get(s.shard, 0) + 1
    for s in streams:
        if seen2[s.shard] > 1:
            s.shard = f"{s.shard}:{os.path.basename(s.path)}"
    return streams


def strict_issues(streams: list[StreamInfo]) -> list[str]:
    """Schema/identity problems a strict fleet reader refuses to
    fold together silently: mixed schema versions in one directory, or
    a stream with no identity meta record (nothing says whose counters
    those are)."""
    issues: list[str] = []
    vers = sorted({s.schema_version for s in streams},
                  key=lambda v: (v is None, v))
    if len(vers) > 1:
        issues.append(
            f"mixed stream schema versions {vers}: these files were "
            "written by different obs versions -- aggregate totals "
            "may compare renamed fields")
    for s in streams:
        if s.identity is None:
            issues.append(
                f"{os.path.basename(s.path)}: no stream-identity meta "
                "record (schema v1 / foreign writer) -- its counters "
                "cannot be attributed to a run/process")
    return issues


# -- time-aligned merge ----------------------------------------------------

def merge_events(streams: list[StreamInfo],
                 kinds: Optional[Iterable[str]] = None) -> list[dict]:
    """One time-aligned record list: every record gains ``shard`` and
    ``t_abs`` (wall seconds via the stream's clock anchor; anchor-less
    v1 streams fall back to their raw ``t``, which keeps their
    INTERNAL order but floats them to the epoch -- ``strict_issues``
    is how a reader learns that happened).  Stable sort, so same-time
    records keep per-stream order."""
    want = set(kinds) if kinds is not None else None
    out: list[dict] = []
    for s in streams:
        off = s.wall_offset or 0.0
        for r in s.records:
            if want is not None and r.get("kind") not in want:
                continue
            rr = dict(r)
            rr["shard"] = s.shard
            rr["t_abs"] = off + float(r.get("t", 0.0))
            out.append(rr)
    out.sort(key=lambda r: r["t_abs"])
    return out


# -- rollup ----------------------------------------------------------------

def _last_snapshot(records: list[dict]) -> Optional[dict]:
    for r in reversed(records):
        if r.get("kind") == "metrics":
            return r
    return None


def merge_histograms(rows: list[dict]) -> dict:
    """Bucket-wise merge of Histogram.snapshot() dicts (identical
    fixed bounds by construction -- obs/metrics.py)."""
    base = rows[0]
    counts = list(base["counts"])
    total, hsum = base["count"], base["sum"]
    hmin = base["min"] if base["min"] is not None else None
    hmax = base["max"] if base["max"] is not None else None
    for h in rows[1:]:
        if list(h["bounds"]) != list(base["bounds"]):
            raise ValueError("histogram bounds differ across shards "
                             "(non-default bounds?): cannot merge")
        for i, c in enumerate(h["counts"]):
            counts[i] += c
        total += h["count"]
        hsum += h["sum"]
        if h["min"] is not None:
            hmin = h["min"] if hmin is None else min(hmin, h["min"])
        if h["max"] is not None:
            hmax = h["max"] if hmax is None else max(hmax, h["max"])
    return {"bounds": list(base["bounds"]), "counts": counts,
            "count": total, "sum": hsum, "min": hmin, "max": hmax}


def _shard_build(records: list[dict]) -> dict:
    """Per-shard build trajectory summary from its build.step events."""
    steps = [r for r in records if r.get("kind") == "event"
             and r.get("name") == "build.step"]
    out: dict = {"steps": len(steps)}
    if steps:
        first, last = steps[0], steps[-1]
        out["regions"] = last.get("regions")
        out["t_first"] = first.get("t")
        out["t_last"] = last.get("t")
        span = (last.get("t", 0.0) or 0.0) - (first.get("t", 0.0) or 0.0)
        d_regions = ((last.get("regions") or 0)
                     - (first.get("regions") or 0))
        out["regions_per_s"] = (d_regions / span) if span > 0 else None
    return out


def fleet_rollup(streams: list[StreamInfo]) -> dict:
    """Aggregate view over each stream's FINAL metrics snapshot.

    Counters SUM (exactly: integer adds); histograms merge
    bucket-wise; gauges are last-write-wins state and stay per-shard
    -- except ``build.regions``, reported as the max across shards
    (every shard of an SPMD build sees the same replicated frontier,
    and in a restart chain the newest session's figure is the total).
    Per-shard rows carry each stream's own snapshot so nothing is
    hidden by the fold."""
    counters: dict[str, int | float] = {}
    hists: dict[str, list[dict]] = {}
    per_shard: dict[str, dict] = {}
    run_ids = set()
    for s in streams:
        snap = _last_snapshot(s.records) or {}
        gauges = dict(snap.get("gauges", {}) or {})
        row = {"path": s.path,
               "schema_version": s.schema_version,
               "identity": ({k: s.identity.get(k) for k in
                             ("run_id", "host", "pid", "process_index",
                              "process_count")}
                            if s.identity else None),
               "counters": dict(snap.get("counters", {}) or {}),
               "gauges": gauges,
               # Per-shard critical-path decomposition (sharded
               # frontier: every shard has its OWN fill/plan/wait/
               # certify profile -- a straggler's certify-bound shard
               # is invisible in any cross-shard fold, so the
               # fractions stay per-shard by design;
               # docs/observability.md "Fleet telemetry").
               "cp": {seg: gauges.get(f"build.cp_{seg}_frac")
                      for seg in ("fill", "plan", "wait", "certify",
                                  "other")
                      if gauges.get(f"build.cp_{seg}_frac")
                      is not None},
               "build": _shard_build(s.records),
               "wall_offset": s.wall_offset}
        per_shard[s.shard] = row
        if s.identity and s.identity.get("run_id"):
            run_ids.add(s.identity["run_id"])
        for k, v in row["counters"].items():
            counters[k] = counters.get(k, 0) + v
        for k, h in (snap.get("histograms", {}) or {}).items():
            hists.setdefault(k, []).append(h)
    regions = [row["gauges"].get("build.regions")
               for row in per_shard.values()
               if row["gauges"].get("build.regions") is not None]
    merged_h = {}
    hist_notes = []
    for k, rows in hists.items():
        try:
            merged_h[k] = merge_histograms(rows)
        except ValueError as e:
            hist_notes.append(f"{k}: {e}")
    out = {"n_streams": len(streams),
           "run_ids": sorted(run_ids),
           "counters": counters,
           "histograms": merged_h,
           "regions": max(regions) if regions else None,
           # Sharded-frontier builds certify DISJOINT subtrees: their
           # total is the per-shard SUM, not the lockstep/restart max
           # above.  Both are reported; the consumer picks by build
           # mode (a sharded build sums, a supervised restart chain
           # maxes).
           "regions_sum": sum(regions) if regions else None,
           "per_shard": per_shard}
    if hist_notes:
        out["histogram_notes"] = hist_notes
    return out


def slo_rollup(streams: list[StreamInfo]) -> dict:
    """Fleet-wide error-budget fold over the shards' FINAL snapshots.

    ``obs/slo.py`` publishes each spec's unit tallies as lifetime
    COUNTERS (``slo.<spec>.good_units`` / ``.bad_units``) precisely so
    this fold can reuse the exact counter-sum contract of
    ``fleet_rollup``: fleet compliance is recomputed from the summed
    unit totals, never averaged from per-shard compliance gauges
    (shards with unequal traffic would skew a gauge average).  Gauges
    stay per-shard except the burn multipliers, where the fleet-worst
    (max) is reported -- a single shard burning its budget is a fleet
    problem.  Goal is taken from the gauges and must agree across
    shards; a mismatch is reported, not folded."""
    good: dict[str, float] = {}
    bad: dict[str, float] = {}
    goals: dict[str, set] = {}
    burn_fast: dict[str, float] = {}
    burn_slow: dict[str, float] = {}
    budget_min: dict[str, float] = {}
    per_shard: dict[str, dict] = {}
    for s in streams:
        snap = _last_snapshot(s.records) or {}
        counters = snap.get("counters", {}) or {}
        gauges = snap.get("gauges", {}) or {}
        row: dict[str, dict] = {}
        for k, v in counters.items():
            if not k.startswith("slo.") or not k.endswith("_units"):
                continue
            spec, field = k[4:].rsplit(".", 1)
            if field == "good_units":
                good[spec] = good.get(spec, 0) + v
            elif field == "bad_units":
                bad[spec] = bad.get(spec, 0) + v
            else:
                continue
            row.setdefault(spec, {})[field] = v
        for k, v in gauges.items():
            if not k.startswith("slo."):
                continue
            spec, field = k[4:].rsplit(".", 1)
            if field == "goal":
                goals.setdefault(spec, set()).add(v)
            elif field == "burn_fast":
                burn_fast[spec] = max(burn_fast.get(spec, 0.0), v)
            elif field == "burn_slow":
                burn_slow[spec] = max(burn_slow.get(spec, 0.0), v)
            elif field == "budget_remaining_frac":
                budget_min[spec] = min(budget_min.get(spec, v), v)
            row.setdefault(spec, {})[field] = v
        if row:
            per_shard[s.shard] = row
    specs: dict[str, dict] = {}
    notes: list[str] = []
    for spec in sorted(set(good) | set(bad)):
        g, b = good.get(spec, 0), bad.get(spec, 0)
        total = g + b
        gset = goals.get(spec, set())
        if len(gset) > 1:
            notes.append(f"{spec}: goal differs across shards "
                         f"{sorted(gset)}: budget fold skipped")
            continue
        goal = next(iter(gset)) if gset else None
        entry = {"good": g, "bad": b,
                 "compliance": (g / total) if total else 1.0,
                 "goal": goal,
                 "burn_fast_max": burn_fast.get(spec),
                 "burn_slow_max": burn_slow.get(spec),
                 "budget_remaining_frac_min": budget_min.get(spec)}
        if goal is not None and 0 < goal < 1:
            allowed = (1.0 - goal) * total
            entry["budget_remaining_frac"] = (
                1.0 - b / allowed if allowed > 0 else 1.0)
        specs[spec] = entry
    out = {"n_streams": len(streams), "specs": specs,
           "per_shard": per_shard}
    if notes:
        out["notes"] = notes
    return out


# -- straggler / imbalance attribution -------------------------------------

def straggler_report(streams: list[StreamInfo]) -> dict:
    """Cross-shard progress attribution over the build.step events.

    ``straggle_frac`` = 1 - slowest/fastest per-shard regions/s among
    CONCURRENT shards (streams whose wall-time spans overlap; a
    supervised restart chain is sequential sessions of one process and
    straggle is meaningless there -- reported as concurrent=False).
    ``lag_s`` = how far behind the fleet's newest record each shard's
    last record is, on the aligned wall axis -- the "who went quiet"
    figure a live watcher alarms on."""
    rows: dict[str, dict] = {}
    spans: dict[str, tuple[float, float]] = {}
    for s in streams:
        b = _shard_build(s.records)
        off = s.wall_offset or 0.0
        if b.get("t_first") is not None:
            spans[s.shard] = (off + b["t_first"], off + b["t_last"])
        rows[s.shard] = {**b,
                         "t_last_abs": (off + b["t_last"]
                                        if b.get("t_last") is not None
                                        else None)}
    # Concurrency is PAIRWISE, not a global intersection: one
    # sequential restart-chain session among N healthy concurrent
    # shards must not disable attribution for the whole fleet -- only
    # shards whose activity window overlaps some other shard's enter
    # the rate comparison (the chain's live session does; its dead
    # predecessor does not).
    overlapping = {
        k for k, (a0, a1) in spans.items()
        if any(k2 != k and a0 < b1 and b0 < a1
               for k2, (b0, b1) in spans.items())}
    for k, r in rows.items():
        if k in spans:
            r["concurrent"] = k in overlapping
    concurrent = len(overlapping) >= 2
    out: dict = {"shards": rows, "concurrent": concurrent,
                 "straggle_frac": None, "slowest": None, "fastest": None}
    last_abs = [r["t_last_abs"] for r in rows.values()
                if r["t_last_abs"] is not None]
    if last_abs:
        newest = max(last_abs)
        for r in rows.values():
            if r["t_last_abs"] is not None:
                r["lag_s"] = round(newest - r["t_last_abs"], 3)
    if concurrent:
        rates = {k: rows[k]["regions_per_s"] for k in overlapping
                 if rows[k].get("regions_per_s")}
        if len(rates) >= 2:
            slowest = min(rates, key=rates.get)
            fastest = max(rates, key=rates.get)
            out["slowest"], out["fastest"] = slowest, fastest
            out["straggle_frac"] = round(
                1.0 - rates[slowest] / rates[fastest], 4)
    return out


# -- fleet health ----------------------------------------------------------

class FleetMonitor:
    """Per-stream HealthMonitors plus the cross-stream fleet rules.

    Rules come from the SAME validated set as the single-stream
    monitor (obs.health.DEFAULT_RULES; unknown names raise), with two
    consumed only here: ``max_shard_straggle_frac`` (concurrent
    shards' regions/s spread -> ``health.shard_straggle``, warn) and
    ``fleet_stall`` (EVERY shard idle for this many wall seconds ->
    ``health.fleet_stall``, critical; per-shard stalls keep firing the
    per-stream ``stall_s`` rule with the shard named).  The driver
    (a stream tailer) feeds records per shard, polls
    ``check_stall``/``check_fleet_stall`` with observed idleness, and
    calls ``finalize`` for the post-hoc straggle verdict."""

    def __init__(self, rules: Optional[dict] = None, sink=None):
        self.rules = rules_from_pairs(rules or {})
        self._sink = sink
        self._mons: dict[str, HealthMonitor] = {}
        self.events: list[dict] = []
        self._fired: set[str] = set()
        # per-shard rolling (t, regions) for the live straggle check
        self._progress: dict[str, list[tuple[float, float]]] = {}

    def _mon(self, shard: str) -> HealthMonitor:
        m = self._mons.get(shard)
        if m is None:
            m = self._mons[shard] = HealthMonitor(self.rules,
                                                  sink=self._sink)
        return m

    def feed(self, shard: str, rec: dict) -> list[dict]:
        evs = self._mon(shard).feed(rec)
        out = [{**e, "shard": shard} for e in evs]
        self.events.extend(out)
        if rec.get("kind") == "event" and rec.get("name") == "build.step":
            t, regions = rec.get("t"), rec.get("regions")
            if isinstance(t, (int, float)) \
                    and isinstance(regions, (int, float)):
                hist = self._progress.setdefault(shard, [])
                hist.append((float(t), float(regions)))
                del hist[:-max(2, int(self.rules["window_steps"]))]
        return out

    def check_stall(self, shard: str, idle_s: float) -> list[dict]:
        evs = self._mon(shard).check_stall(idle_s)
        out = [{**e, "shard": shard} for e in evs]
        self.events.extend(out)
        return out

    def check_fleet_stall(self, min_idle_s: float) -> list[dict]:
        """`min_idle_s`: the LEAST-idle shard's idleness -- the whole
        fleet has been silent at least this long."""
        lim = self.rules["fleet_stall"]
        if lim <= 0 or min_idle_s < lim or "fleet_stall" in self._fired:
            return []
        self._fired.add("fleet_stall")
        ev = {"name": "health.fleet_stall", "severity": "critical",
              "value": round(min_idle_s, 1), "threshold": lim,
              "msg": (f"every shard silent for {min_idle_s:.0f}s "
                      f"(> {lim:.0f}s): the fleet is frozen or dead, "
                      "not merely imbalanced")}
        self.events.append(ev)
        if self._sink is not None:
            self._sink.emit("event", ev["name"],
                            **{k: v for k, v in ev.items()
                               if k != "name"})
        return [ev]

    def _check_straggle(self, rep: dict) -> list[dict]:
        lim = self.rules["max_shard_straggle_frac"]
        frac = rep.get("straggle_frac")
        if lim <= 0 or frac is None or frac <= lim \
                or "shard_straggle" in self._fired:
            return []
        self._fired.add("shard_straggle")
        ev = {"name": "health.shard_straggle", "severity": "warn",
              "value": frac, "threshold": lim,
              "msg": (f"shard {rep['slowest']} builds at "
                      f"{100 * (1 - frac):.0f}% of shard "
                      f"{rep['fastest']}'s rate (straggle "
                      f"{frac:.2f} > {lim:g}): faster shards idle on "
                      "its stragglers every step"),
              "shard": rep.get("slowest")}
        self.events.append(ev)
        if self._sink is not None:
            self._sink.emit("event", ev["name"],
                            **{k: v for k, v in ev.items()
                               if k != "name"})
        return [ev]

    def check_straggle_live(self) -> list[dict]:
        """Straggle over the rolling per-shard windows (follow mode)."""
        rows = {}
        for shard, hist in self._progress.items():
            if len(hist) >= 2:
                (t0, r0), (t1, r1) = hist[0], hist[-1]
                if t1 > t0:
                    rows[shard] = {"regions_per_s": (r1 - r0) / (t1 - t0)}
        if len(rows) < 2:
            return []
        rates = {k: v["regions_per_s"] for k, v in rows.items()
                 if v["regions_per_s"] > 0}
        if len(rates) < 2:
            return []
        slowest = min(rates, key=rates.get)
        fastest = max(rates, key=rates.get)
        return self._check_straggle(
            {"straggle_frac": round(1.0 - rates[slowest] / rates[fastest],
                                    4),
             "slowest": slowest, "fastest": fastest})

    def finalize(self, streams: list[StreamInfo]) -> list[dict]:
        """Post-hoc fleet verdict over fully-loaded streams (`--once`)."""
        return self._check_straggle(straggler_report(streams))

    @property
    def worst(self) -> str:
        w = "ok"
        for m in self._mons.values():
            if _SEVERITY[m.worst] > _SEVERITY[w]:
                w = m.worst
        for e in self.events:
            if _SEVERITY.get(e.get("severity"), 0) > _SEVERITY[w]:
                w = e["severity"]
        return w

    @property
    def exit_code(self) -> int:
        return _SEVERITY[self.worst]

    def summary(self) -> dict:
        return {"worst": self.worst, "exit_code": self.exit_code,
                "n_shards": len(self._mons),
                "n_events": len(self.events),
                "events": list(self.events)}
