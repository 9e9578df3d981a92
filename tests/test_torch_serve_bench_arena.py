"""Torch port: tools/serve_bench.py's mixed-tenant arena sweep and its
skewed-traffic capture, held to the JAX package's scripts/serve_bench.py
on the CPU.

The JAX package has no tier-1 test of either mode, so both tools run
through the same assertions: each mode once (module fixtures, the two
tools side by side as subprocesses, results and histories in the test's
directory), at tests/test_serve.py's serve_bench sizes with 1 s
windows.  The arena sweep with four tenants: the delta's figures
equal, no torn and no dropped request, a fused launch for several
requests, the rows' keys and configuration equal (the configuration's
``backend`` aside: the JAX arena's "xla", the port's "torch" on the
CPU).  The skewed capture at
the JAX default depth 9, where the script's blobs are sized: the
demand sketch's top decile at least 0.7 in both, the snapshot loaded
strictly, the five off/on pairs of both overhead figures taken.  No
test asserts an overhead figure or compares a latency across
packages."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_serve_bench import (hold_the_jax_tests_assertions,  # noqa: E402
                                    summaries, sweeps)

from explicit_hybrid_mpc_tpu_torch.tools import serve_bench  # noqa: E402

TENANTS = 4


@pytest.fixture(scope="module")
def arena(tmp_path_factory):
    # 1 s windows: the delta publish at 0.5 s leaves the top window half
    # a second of v2 traffic on a loaded CPU.
    return sweeps(tmp_path_factory.mktemp("serve_bench_arena"),
                  {"SERVE_BENCH_TENANTS": str(TENANTS),
                   "SERVE_BENCH_MAX_BATCH": "8", "SERVE_BENCH_SECS": "1.0"})


@pytest.fixture(scope="module")
def skew(tmp_path_factory):
    # 1 s windows: the top decile is that of the OBSERVED leaves (ceil of
    # a tenth), and the blobs' rarer leaves need the traffic to be seen.
    return sweeps(tmp_path_factory.mktemp("serve_bench_skew"),
                  {"SERVE_BENCH_SKEW": "3.0", "SERVE_BENCH_DEPTH": "9",
                   "SERVE_BENCH_SECS": "1.0"})


@pytest.mark.parametrize("tag", ["port", "jax"])
def test_the_arena_sweep_swaps_without_a_drop_or_a_torn_read(arena, tag):
    _rc, result, hist, _mtime = arena[tag]
    assert result["swap_dropped"] == 0 and result["errors"] == []
    assert result["swap_torn"] == 0
    assert result["swap_drained"] is True
    assert result["versions_seen"] == ["v1", "v2"]
    assert result["tenants"] == result["arena_controllers"] == TENANTS
    # The mixed-tenant batch fuses: fewer launches than requests.
    assert 0 < result["batch_launches_per_req"] < 1
    assert result["arena_swap_us"] is not None
    assert result["demand_snapshot_strict"] is True
    assert all(r["p99_us"] is not None for r in result["rates"])
    assert len(hist) == 1 and hist[0]["serve_p99_us"] == \
        result["serve_p99_us"]


def test_the_delta_is_the_same_in_both(arena):
    jax, port = arena["jax"][1], arena["port"][1]
    for key in ("delta_n_fresh", "delta_n_kept", "arena_controllers",
                "tenants"):
        assert port[key] == jax[key], key
    assert port["delta_n_fresh"] == port["delta_n_kept"] == 2 ** 5


def test_every_jax_key_is_in_the_ports_arena_row(arena):
    jax, port = arena["jax"][1], arena["port"][1]
    assert set(jax) <= set(port), set(jax) - set(port)
    assert jax["config"]["backend"] == "xla"
    assert port["config"]["backend"] == "torch"
    assert {k: v for k, v in port["config"].items() if k != "backend"} \
        == {k: v for k, v in jax["config"].items() if k != "backend"}
    for pr, jr in zip(port["rates"], jax["rates"]):
        assert set(pr) == set(jr)


@pytest.mark.parametrize("fixture", ["arena", "skew"])
def test_each_history_row_is_what_both_summarize_make(request, fixture):
    runs = request.getfixturevalue(fixture)
    for tag in ("port", "jax"):
        _rc, result, hist, mtime = runs[tag]
        assert hist == [summaries(result, f"{tag}.json", mtime)], tag


@pytest.mark.parametrize("tag", ["port", "jax"])
def test_the_skewed_capture_measures_the_hot_set(skew, tag):
    _rc, result, hist, _mtime = skew[tag]
    hold_the_jax_tests_assertions(result, hist)
    assert result["config"]["skew"] == result["skew"] == 3.0
    assert result["demand_top_decile_frac"] >= 0.7
    assert result["demand_snapshot_strict"] is True
    # The reference oracle is the active version's own law: no
    # suboptimality beyond float identity.
    assert result["subopt_samples"] > 0
    assert result["subopt_p99"] <= result["subopt_eps"]
    for key in ("demand_ab_windows", "trace_ab_windows"):
        assert len(result[key]["off"]) == len(result[key]["on"]) == 5, key
    for key in ("demand_overhead_frac", "trace_overhead_frac",
                "serve_p99_off_us", "serve_p99_on_us",
                "serve_p99_trace_off_us", "serve_p99_trace_on_us"):
        assert result[key] is not None, key


def test_every_jax_key_is_in_the_ports_skewed_row(skew):
    jax, port = skew["jax"][1], skew["port"][1]
    assert set(jax) <= set(port), set(jax) - set(port)
    assert port["config"] == jax["config"]
    assert port["demand_exceed_dims"] == jax["demand_exceed_dims"]


@pytest.mark.parametrize("fixture", ["arena", "skew"])
def test_the_ports_exit_is_its_bars(request, fixture):
    rc, result, _hist, _mtime = request.getfixturevalue(fixture)["port"]
    assert rc == (1 if serve_bench.bars(result) else 0)
