"""Torch port: tools/bench_gate.py against the JAX package's
scripts/bench_gate.py on the same rows, and the port's own rules.

The JAX gate's cases (tests/test_diagnostics.py: the synthetic
regression, the directions, contended and foreign-platform rows, the
candidate never in its own base, valueless captures, the roll and the
CLI) run through both gates, each on a history of its own package built
from the same bench results: the rows, flags, info lines and exit codes
are equal.  Then the port's rules: rows of another card name or power
limit are not comparable, a null ``contended`` is, the default candidate
is the history's newest row, and neither the JAX package's history nor
its BENCH_*.json is ever read or rolled."""

import importlib.util
import json
import os
import shutil
import tempfile

import pytest

from explicit_hybrid_mpc_tpu_torch.tools import bench_gate, bench_history

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "jax_bench_gate", os.path.join(REPO, "scripts", "bench_gate.py"))
jax_gate = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jax_gate)

CARD = {"device_name": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W"}
STAMP = {bench_history.PACKAGE_KEY: bench_history.PACKAGE}


def _bench(value, platform="cpu", **kw):
    return {"value": value, "platform": platform, "unit": "regions/s", **kw}


def _histories(tmp_path, benches) -> tuple:
    """The JAX and the port history of `benches` ((result, source)
    pairs, mtimes 0, 1, ...): (jax rows, port rows)."""
    out = []
    tmp = tempfile.mkdtemp(dir=tmp_path)
    for gate in (jax_gate, bench_gate):
        path = os.path.join(tmp, f"{gate.__name__}.jsonl")
        for i, (bench, source) in enumerate(benches):
            gate.append_history(bench, source, path=path, mtime=float(i))
        out.append(gate.load_history(path))
    return tuple(out)


def _gate_both(tmp_path, benches, cand, source="BENCH_new.json",
               mtime=None) -> tuple:
    """Both gates' (flags, info) for `cand` against `benches`, which must
    agree; the port's."""
    jax_rows, port_rows = _histories(tmp_path, benches)
    assert port_rows == jax_rows
    jax = jax_gate.gate(jax_gate.summarize(cand, source, mtime), jax_rows)
    port = bench_gate.gate(bench_history.summarize(cand, source, mtime),
                           port_rows)
    assert port == jax
    return port


# -- the JAX gate's cases, through both gates ---------------------------------

@pytest.mark.parametrize("value,flagged", [(85.0, True), (95.0, False),
                                           (140.0, False)])
def test_flags_a_synthetic_regression(tmp_path, value, flagged):
    hist = [(_bench(v), f"BENCH_r{i:02d}.json")
            for i, v in enumerate([98.0, 101.0, 100.0])]
    flags, info = _gate_both(tmp_path, hist, _bench(value))
    assert any("value" in f and "REGRESSION" in f for f in flags) == flagged
    if value == 95.0:
        assert flags == [] and any(ln.startswith("ok value") for ln in info)


def test_iteration_economy_and_latency_directions(tmp_path):
    hist = [(_bench(100.0, wasted_iter_frac=0.27, warmstart_accept_rate=0.5,
                    online_us_per_query=1.0), f"BENCH_r{i:02d}.json")
            for i in range(3)]
    flags, _ = _gate_both(tmp_path, hist, _bench(
        100.0, wasted_iter_frac=0.10, warmstart_accept_rate=0.1,
        online_us_per_query=2.0))
    assert {f.split()[1].rstrip(":") for f in flags} == {
        "wasted_iter_frac", "warmstart_accept_rate", "online_us_per_query"}


def test_skips_contended_and_foreign_platform(tmp_path):
    hist = [(_bench(500.0, platform="tpu"), "BENCH_tpu.json"),
            (_bench(100.0, host={"contended": True}), "BENCH_bad.json")]
    flags, info = _gate_both(tmp_path, hist, _bench(10.0))
    assert flags == [] and any("no comparable history" in s for s in info)
    flags, info = _gate_both(tmp_path, hist,
                             _bench(10.0, host={"contended": True}))
    assert flags == [] and any("CONTENDED" in s for s in info)


def test_the_candidate_is_never_in_its_own_base(tmp_path):
    hist = [(_bench(100.0), f"BENCH_r{i:02d}.json") for i in range(3)]
    hist.append((_bench(80.0), "BENCH_new.json"))
    flags, _ = _gate_both(tmp_path, hist, _bench(80.0), mtime=99.5)
    assert any(f.startswith("REGRESSION value") for f in flags)


def test_valueless_captures_make_no_row(tmp_path):
    for gate in (jax_gate, bench_gate):
        path = str(tmp_path / f"{gate.__name__}.jsonl")
        assert gate.append_history({"rc": 1, "parsed": None, "tail": "boom"},
                                   "BENCH_broken.json", path=path) is None
        assert gate.append_history({"value": None, "platform": "cpu"},
                                   "BENCH_void.json", path=path) is None
        assert gate.append_history(
            {"value": None, "error": "RuntimeError('x')"},
            "BENCH_err.json", path=path) is not None
        assert len(gate.load_history(path)) == 1


def test_the_roll_and_the_cli(tmp_path, capsys):
    """The JAX CLI case: two results rolled (idempotently), then a
    candidate 20% down exits 1 and one within tolerance 0; the port rolls
    results that carry its stamp, which the JAX roll ignores."""
    out = {}
    for gate in (jax_gate, bench_gate):
        repo = tmp_path / gate.__name__
        repo.mkdir()
        for i, v in enumerate([100.0, 102.0]):
            with open(repo / f"BENCH_r{i:02d}.json", "w") as f:
                json.dump(_bench(v, **STAMP), f)
            os.utime(repo / f"BENCH_r{i:02d}.json", (i + 1, i + 1))
        hist = str(repo / "history.jsonl")
        added = gate.roll_history(str(repo), hist)
        again = gate.roll_history(str(repo), hist)
        if gate is bench_gate:
            assert added[1] == again[1] == []  # nothing skipped
            added, again = added[0], again[0]
        assert [r["source"] for r in added] == ["BENCH_r00.json",
                                               "BENCH_r01.json"]
        assert again == []
        cand = repo / "BENCH_new.json"
        rcs = []
        for v in (80.0, 99.0):
            with open(cand, "w") as f:
                json.dump(_bench(v, **STAMP), f)
            rcs.append(gate.main([str(cand), "--history", hist]))
        out[gate] = (rcs, gate.load_history(hist),
                     capsys.readouterr().out.replace(hist, "H"))
    assert out[bench_gate][0] == out[jax_gate][0] == [1, 0]
    assert out[bench_gate][1] == out[jax_gate][1]
    assert out[bench_gate][2] == out[jax_gate][2]
    assert "GATE FAILED: 1 regression(s)" in out[bench_gate][2]


def test_the_gate_table_is_the_jax_scripts():
    assert bench_history.GATED_METRICS == jax_gate.GATED_METRICS
    assert bench_gate._parse_tols(["value=0.05"]) \
        == jax_gate._parse_tols(["value=0.05"])
    for bad in (["value"], ["nope=0.1"]):
        with pytest.raises(SystemExit):
            bench_gate._parse_tols(bad)


# -- the port's own rules -----------------------------------------------------

@pytest.mark.parametrize("other,comparable", [
    ({}, True),
    ({"power_limit": "350.00 W"}, False),
    ({"device_name": "NVIDIA H100 PCIe"}, False),
    ({"device_name": None, "power_limit": None}, False)])
def test_only_rows_of_the_same_card_and_power_limit_compare(
        tmp_path, other, comparable):
    path = str(tmp_path / "h.jsonl")
    for i in range(3):
        bench_history.append_history(_bench(100.0, platform="gpu", **CARD),
                                     f"BENCH_r{i:02d}.json", path=path,
                                     mtime=float(i))
    cand = bench_history.summarize(
        _bench(80.0, platform="gpu", **{**CARD, **other}), "BENCH_new.json")
    flags, info = bench_gate.gate(cand, bench_history.load_history(path))
    if comparable:
        assert any(f.startswith("REGRESSION value") for f in flags)
    else:
        assert flags == [] and any("no comparable history rows" in ln
                                   for ln in info)


def test_the_window_takes_only_the_same_power_limit(tmp_path):
    """Rows at another power limit stay out of the mean: 80 against the
    700 W rows' 100 is flagged although the 350 W rows average 80."""
    path = str(tmp_path / "h.jsonl")
    for i, (v, w) in enumerate([(100.0, "700.00 W"), (80.0, "350.00 W"),
                                (100.0, "700.00 W"), (80.0, "350.00 W")]):
        bench_history.append_history(
            _bench(v, platform="gpu", **{**CARD, "power_limit": w}),
            f"BENCH_r{i:02d}.json", path=path, mtime=float(i))
    cand = bench_history.summarize(_bench(80.0, platform="gpu", **CARD),
                                   "BENCH_new.json")
    flags, _ = bench_gate.gate(cand, bench_history.load_history(path))
    assert flags == ["REGRESSION value: 80 vs trailing-2 mean 100 (20.0% "
                     "lower, tol 10%)"]


def test_a_row_whose_contention_was_not_measured_is_comparable(tmp_path):
    path = str(tmp_path / "h.jsonl")
    for i in range(2):
        row = bench_history.append_history(
            _bench(100.0, host={"contended": None}), f"BENCH_r{i:02d}.json",
            path=path, mtime=float(i))
        assert row["contended"] is None
    cand = bench_history.summarize(_bench(80.0, host={"contended": None}),
                                   "BENCH_new.json")
    flags, _ = bench_gate.gate(cand, bench_history.load_history(path))
    assert any(f.startswith("REGRESSION value") for f in flags)


@pytest.mark.parametrize("newest,rc", [(80.0, 1), (99.0, 0)])
def test_the_default_candidate_is_the_newest_row(tmp_path, capsys, newest,
                                                 rc):
    path = str(tmp_path / "h.jsonl")
    for i, v in enumerate([100.0, 102.0, newest]):
        bench_history.append_history(_bench(v), f"bench_{i}", path=path,
                                     mtime=float(i))
    assert bench_gate.main(["--history", path]) == rc
    out = capsys.readouterr().out
    assert out.startswith("bench gate: bench_2 vs h.jsonl (2 rows, window "
                          "5)")
    assert ("GATE FAILED" in out) == (rc == 1)


def test_an_empty_or_absent_history_gates_nothing(tmp_path, capsys,
                                                  monkeypatch):
    assert bench_gate.main(["--history", str(tmp_path / "none.jsonl")]) == 0
    assert "nothing to gate" in capsys.readouterr().err
    monkeypatch.setenv("BENCH_HISTORY", "")
    assert bench_gate.main([]) == 0
    assert "the history is off" in capsys.readouterr().err


def _sha(path):
    import hashlib

    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.mark.parametrize("how", ["flag", "env"])
def test_the_jax_history_is_refused(tmp_path, monkeypatch, how):
    jax_hist = os.path.join(REPO, "BENCH_HISTORY.jsonl")
    before = _sha(jax_hist)
    argv = ["--history", jax_hist] if how == "flag" else []
    if how == "env":
        monkeypatch.setenv("BENCH_HISTORY", jax_hist)
    with pytest.raises(SystemExit, match="JAX package's bench history"):
        bench_gate.main(argv + ["--update", str(tmp_path)])
    assert _sha(jax_hist) == before


def test_a_jax_capture_is_never_rolled_nor_gated(tmp_path, capsys):
    """--update over copies of the root's BENCH_r05.json (a capture
    wrapper around a JAX bench.py result) and BENCH_serve_r04.json (a
    JAX serve_bench result) skips both and names them; neither is taken
    as a candidate either."""
    for name in ("BENCH_r05.json", "BENCH_serve_r04.json"):
        shutil.copy(os.path.join(REPO, name), tmp_path / name)
    with open(tmp_path / "BENCH_port.json", "w") as f:
        json.dump(_bench(100.0, **STAMP), f)
    hist = str(tmp_path / "h.jsonl")
    assert bench_gate.main(["--update", str(tmp_path), "--history",
                            hist]) == 0
    err = capsys.readouterr().err
    assert "1 new row(s) rolled" in err
    assert "skipped 2 file(s) that are not the port's results: " \
        "BENCH_r05.json, BENCH_serve_r04.json" in err \
        or "skipped 2 file(s) that are not the port's results: " \
        "BENCH_serve_r04.json, BENCH_r05.json" in err
    assert [r["source"] for r in bench_history.load_history(hist)] \
        == ["BENCH_port.json"]
    with pytest.raises(SystemExit, match="not a result of the port"):
        bench_gate.main([str(tmp_path / "BENCH_r05.json"), "--history",
                         hist])


@pytest.mark.parametrize("argv,words", [
    (["--update"], "--update needs the directory"),
    (["--update", REPO], "is the repository root")])
def test_update_needs_a_directory_other_than_the_root(tmp_path, argv, words):
    hist = str(tmp_path / "h.jsonl")
    with pytest.raises(SystemExit, match=words):
        bench_gate.main(argv + ["--history", hist])
    assert not os.path.exists(hist)
