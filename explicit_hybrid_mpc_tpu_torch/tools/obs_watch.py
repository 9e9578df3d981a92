"""Tail a live obs JSONL stream and watch build health (obs/health.py).

    python -m explicit_hybrid_mpc_tpu_torch.tools.obs_watch RUN.obs.jsonl
    python -m explicit_hybrid_mpc_tpu_torch.tools.obs_watch RUN.obs.jsonl \
        --once
    python -m explicit_hybrid_mpc_tpu_torch.tools.obs_watch RUN.obs.jsonl \
        --rule stall_s=120 --rule max_rescue_frac=0.1 --max-wall 3600
    python -m explicit_hybrid_mpc_tpu_torch.tools.obs_watch \
        'build/run.obs.*.jsonl' --fleet

The streaming counterpart of tools/obs_report.py (the JAX package's
scripts/obs_watch.py, with its functions, flags, output and exit
codes): where the report renders a FINISHED stream, this watchdog
follows a LIVE one -- a card build's ``--obs jsonl`` stream while it
runs -- feeds every record through the rolling rules of the port's
HealthMonitor (regions/sec stall, divergence storm, rescue-rate
threshold, warm-start acceptance collapse, shard imbalance, host
contention, and -- when request tracing is on -- the volume-gated
``max_queue_frac`` queue-dominated rule over the
``serve.ctl.*.queue_frac`` gauges, e.g. ``--rule max_queue_frac=0.5``;
obs/reqtrace.py), prints structured ``health.*`` events as JSON lines
on stdout, and exits with the monitor's verdict so its caller can act on
a sick build instead of burning the rest of its card time.
``health.*`` events already IN the stream are adopted verbatim --
including ``health.subopt`` from a serving DemandHub (obs/demand.py:
sampled suboptimality p99 over the eps budget) and the lifecycle
daemon's staleness events -- and the ``max_subopt`` metrics rule
re-derives the same verdict from the ``serve.ctl.*.subopt_p99`` gauges
when only snapshots are present:

    exit 0  healthy (stream ended / --max-wall reached, no findings)
    exit 1  warn-level findings
    exit 2  critical findings (including health.stall: the stream
            stopped growing for --stall-s seconds -- a frozen build)

``--once`` evaluates the records already in the file and exits (no
stall detection: a finished stream is not frozen, it is finished).

``--fleet``: the stream argument is a glob / directory / bare
per-process stream name naming N streams; every stream feeds its own
per-shard rule set (events gain a ``shard`` field) and the cross-shard
rules fire on top -- ``health.shard_straggle`` when concurrent shards'
build rates spread past ``max_shard_straggle_frac``, and
``health.fleet_stall`` (critical) when EVERY stream goes silent for
``fleet_stall`` seconds (one silent shard still fires the per-stream
``stall_s`` rule with the shard named).  New per-process streams
appearing mid-watch are picked up on the next poll.
Rule schema + defaults: obs.health.DEFAULT_RULES (``--list-rules``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from explicit_hybrid_mpc_tpu_torch.obs import fleet as fleet_lib
from explicit_hybrid_mpc_tpu_torch.obs.health import (DEFAULT_RULES,
                                                      RULE_DOCS,
                                                      HealthMonitor,
                                                      rules_from_pairs)
from explicit_hybrid_mpc_tpu_torch.obs.sink import load_jsonl


def _emit(ev: dict, out) -> None:
    print(json.dumps(ev), file=out, flush=True)
    sev = ev.get("severity", "?")
    print(f"[{sev.upper()}] {ev.get('name')}: {ev.get('msg')}",
          file=sys.stderr, flush=True)


def watch(path: str, rules: dict | None = None, interval: float = 1.0,
          max_wall: float | None = None, once: bool = False,
          out=None) -> tuple[int, HealthMonitor]:
    """Drive a HealthMonitor over `path`; returns (exit_code, monitor).

    Follow mode reads incrementally (tolerating a partial trailing
    line: the writer may be mid-record) and tracks wall-clock idleness
    for the stall rule; it returns when the stream emits a terminal
    ``build.done`` event, on stall, or at --max-wall."""
    if out is None:
        out = sys.stdout  # bound at call time: test capture sees it
    mon = HealthMonitor(rules)
    if once:
        for rec in load_jsonl(path):
            for ev in mon.feed(rec):
                _emit(ev, out)
        return mon.exit_code, mon

    t_start = time.time()
    last_data = time.time()
    done = False
    buf = ""
    fh = open(path)
    try:
        while True:
            chunk = fh.read()
            if chunk:
                last_data = time.time()
                buf += chunk
                lines = buf.split("\n")
                buf = lines.pop()  # partial tail stays buffered
                for ln in lines:
                    if not ln.strip():
                        continue
                    try:
                        rec = json.loads(ln)
                    except json.JSONDecodeError:
                        continue  # torn mid-file line; skip
                    for ev in mon.feed(rec):
                        _emit(ev, out)
                    if rec.get("kind") == "event" \
                            and rec.get("name") == "build.done":
                        done = True
            if done:
                break
            for ev in mon.check_stall(time.time() - last_data):
                _emit(ev, out)
            if mon.worst == "critical" and any(
                    e["name"] == "health.stall" for e in mon.events):
                break  # a frozen stream will not unfreeze; stop burning
            if max_wall is not None \
                    and time.time() - t_start >= max_wall:
                break
            time.sleep(interval)
    finally:
        fh.close()
    return mon.exit_code, mon


def watch_fleet(pattern: str, rules: dict | None = None,
                interval: float = 1.0, max_wall: float | None = None,
                once: bool = False, out=None):
    """Drive a FleetMonitor over every stream `pattern` names; returns
    (exit_code, monitor).  See module docstring (--fleet)."""
    if out is None:
        out = sys.stdout
    mon = fleet_lib.FleetMonitor(rules)
    if once:
        streams = fleet_lib.load_fleet(pattern)
        for s in streams:
            for rec in s.records:
                for ev in mon.feed(s.shard, rec):
                    _emit(ev, out)
        for ev in mon.finalize(streams):
            _emit(ev, out)
        return mon.exit_code, mon

    t_start = time.time()
    state: dict[str, dict] = {}  # path -> {fh, buf, shard, done, last}
    try:
        while True:
            now = time.time()
            for path in fleet_lib.resolve_streams(pattern):
                if path not in state:
                    state[path] = {
                        "fh": open(path), "buf": "", "done": False,
                        "last": now,
                        "shard": fleet_lib._shard_label(path, None)}
            if not state:
                if max_wall is not None and now - t_start >= max_wall:
                    break
                time.sleep(interval)
                continue
            for st in state.values():
                chunk = st["fh"].read()
                if not chunk:
                    continue
                st["last"] = now
                st["buf"] += chunk
                lines = st["buf"].split("\n")
                st["buf"] = lines.pop()
                for ln in lines:
                    if not ln.strip():
                        continue
                    try:
                        rec = json.loads(ln)
                    except json.JSONDecodeError:
                        continue
                    for ev in mon.feed(st["shard"], rec):
                        _emit(ev, out)
                    if rec.get("kind") == "event" \
                            and rec.get("name") == "build.done":
                        st["done"] = True
            if state and all(st["done"] for st in state.values()):
                break
            for st in state.values():
                if not st["done"]:
                    for ev in mon.check_stall(st["shard"],
                                              now - st["last"]):
                        _emit(ev, out)
            idles = [now - st["last"] for st in state.values()
                     if not st["done"]]
            if idles:
                for ev in mon.check_fleet_stall(min(idles)):
                    _emit(ev, out)
            for ev in mon.check_straggle_live():
                _emit(ev, out)
            if any(e["name"] == "health.fleet_stall"
                   for e in mon.events):
                break  # a frozen fleet will not unfreeze; stop burning
            if max_wall is not None and now - t_start >= max_wall:
                break
            time.sleep(interval)
    finally:
        for st in state.values():
            st["fh"].close()
    return mon.exit_code, mon


def _parse_rules(pairs: list[str]) -> dict:
    rules: dict[str, float] = {}
    for kv in pairs:
        if "=" not in kv:
            raise SystemExit(f"--rule needs NAME=VALUE, got {kv!r}")
        k, v = kv.split("=", 1)
        try:
            rules_from_pairs([(k, float(v))])  # the one validator
        except ValueError as e:
            raise SystemExit(f"--rule: {e}")
        rules[k] = float(v)
    return rules


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m explicit_hybrid_mpc_tpu_torch.tools.obs_watch",
        description=__doc__.splitlines()[0])
    ap.add_argument("stream", nargs="?", default=None,
                    help="obs JSONL stream path")
    ap.add_argument("--rule", action="append", default=[],
                    metavar="NAME=VALUE",
                    help="override a health rule (repeatable; see "
                         "obs.health.DEFAULT_RULES)")
    ap.add_argument("--stall-s", type=float, default=None,
                    help="shorthand for --rule stall_s=X")
    ap.add_argument("--interval", type=float, default=1.0,
                    help="poll interval in follow mode (s)")
    ap.add_argument("--max-wall", type=float, default=None,
                    help="stop following after this many seconds")
    ap.add_argument("--once", action="store_true",
                    help="evaluate the existing records and exit "
                         "(no stall detection)")
    ap.add_argument("--fleet", action="store_true",
                    help="the stream argument names N per-process "
                         "streams (glob / directory / bare name): "
                         "per-shard rules plus the cross-shard "
                         "straggler and fleet-stall rules")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the health-rule catalog (name, default, "
                         "severity, one-line doc) and exit")
    ap.add_argument("--json", dest="json_out", default=None,
                    help="write the monitor summary here on exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for name in sorted(DEFAULT_RULES):
            sev, doc = RULE_DOCS.get(name, ("?", ""))
            print(f"{name:28s} {DEFAULT_RULES[name]:<10g} "
                  f"[{sev}] {doc}")
        return 0
    if args.stream is None:
        ap.error("stream argument is required (or use --list-rules)")

    rules = _parse_rules(args.rule)
    if args.stall_s is not None:
        rules["stall_s"] = args.stall_s
    if args.fleet:
        rc, mon = watch_fleet(args.stream, rules=rules,
                              interval=args.interval,
                              max_wall=args.max_wall, once=args.once)
    else:
        rc, mon = watch(args.stream, rules=rules, interval=args.interval,
                        max_wall=args.max_wall, once=args.once)
    summ = mon.summary()
    counts = (f"{summ['n_shards']} shards"
              if "n_shards" in summ else f"{summ['n_records']} records")
    print(f"obs_watch: {counts}, "
          f"{summ['n_events']} health events, verdict {summ['worst']}",
          file=sys.stderr)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(summ, f, indent=2)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
