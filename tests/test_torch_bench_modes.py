"""Torch port: tools/bench.py's rebuild, drift-walk and multichip modes,
held to the JAX package's bench.py on the CPU.

The six runs (three modes, two packages) start together in one module
fixture, as subprocesses at tests/test_bench.py's smoke sizes; the drift
walk keeps its own default problem (the pendulum's small tier-1 box,
bench.py:1049), whose ledger the walk exercises, over 3 revisions.  Each
mode's rows must agree on the keys and on the figures that do not depend
on timing, and each history row must be what both packages'
``summarize`` make of it."""

import json
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_bench import (PORT, PROBE_KEYS, SMOKE, finish,  # noqa: E402
                              start, summaries)

MODES = {"rebuild": ("--rebuild", SMOKE),
         "drift": ("--drift-walk", {"BENCH_PLATFORM": "cpu",
                                    "BENCH_DRIFT_K": "3"}),
         "multichip": ("--multichip", SMOKE)}


@pytest.fixture(scope="module")
def rows(tmp_path_factory):
    """{mode: {"port": (rc, row, stderr, history), "jax": ...}}."""
    tmp = tmp_path_factory.mktemp("bench_modes")
    started = {}
    for mode, (flag, env) in MODES.items():
        started[mode, "jax"] = start([sys.executable, "bench.py", flag], tmp,
                                     f"jax_{mode}", env)
        started[mode, "port"] = start(
            PORT + [flag, "--sentinel", str(tmp / f"{mode}.sentinel")], tmp,
            f"port_{mode}", env)
    out: dict = {mode: {} for mode in MODES}
    for (mode, tag), s in started.items():
        out[mode][tag] = finish(s)
    return out


@pytest.mark.parametrize("mode", sorted(MODES))
def test_both_benches_produce_the_modes_row(rows, mode):
    for tag in ("port", "jax"):
        rc, row, err, _h = rows[mode][tag]
        assert rc == 0, (tag, row.get("error"), err[-2000:])
        assert row["platform"] == "cpu"
    port, jax = rows[mode]["port"][1], rows[mode]["jax"][1]
    # "error": the multichip overhead bound's, where a row breaks it.
    assert set(jax) - PROBE_KEYS - {"error"} <= set(port)
    if mode != "multichip":
        assert "error" not in port and "error" not in jax


def test_the_rebuild_figures_agree(rows):
    port, jax = rows["rebuild"]["port"][1], rows["rebuild"]["jax"][1]
    for key in ("rebuild_prior_regions", "rebuild_cold_regions",
                "rebuild_invalidated", "recert_solves",
                "subdivision_solves", "rebuild_reuse_frac", "regions",
                "uncertified", "truncated"):
        assert port[key] == jax[key], key
    assert 0 < port["rebuild_reuse_frac"] <= 1
    assert port["rebuild_speedup"] > 0


def test_the_drift_walks_agree(rows):
    port, jax = rows["drift"]["port"][1], rows["drift"]["jax"][1]
    for key in ("drift_generations", "delta_publishes", "full_publishes",
                "drift_prior_regions", "drift_prior_excl_events",
                "reuse_fracs", "excl_events_trajectory", "regions",
                "ledger_bounded"):
        assert port[key] == jax[key], key
    assert port["drift_generations"] == 3
    assert 0 < port["staleness_p50_s"] <= port["staleness_p99_s"]


def test_the_multichip_parity_verdicts_agree(rows):
    """Both packages hold their sharded builds to the single process's
    tree and point solves (a broken parity is the row's error), and the
    builds themselves agree across the packages."""
    port, jax = rows["multichip"]["port"][1], rows["multichip"]["jax"][1]
    for row in (port, jax):
        assert row["multichip_scaling_frac"] is not None
        assert "diverged" not in row.get("error", "")
        assert "point_solves" not in row.get("error", "")
    assert port["regions"] == jax["regions"] == 392
    assert port["n_processes"] == jax["n_processes"] == 2
    for name in ("ref", "sync", "async"):
        st = []
        for row in (port, jax):
            with open(os.path.join(row["workdir"], f"{name}.stats.json")) \
                    as f:
                st.append(json.load(f))
        for key in ("regions", "point_solves", "uncertified"):
            assert st[0][key] == st[1][key], (name, key)
    # The port's processes share the host's CPU: no overhead bound.
    assert port["n_devices"] == 1
    assert port["multichip_overhead_ok"] is None and "error" not in port
    assert "share the host's CPU" in port["host_note"]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_each_mode_appends_its_history_row(rows, mode):
    for tag in ("port", "jax"):
        _rc, row, _err, hist = rows[mode][tag]
        assert len(hist) == 1, tag
        assert summaries(row, hist[0]["source"], hist[0]["mtime"]) \
            == hist[0], tag
