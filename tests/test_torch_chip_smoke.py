"""Torch port: the parts of chip_smoke.py that run without a GPU.

The script itself needs a CUDA device; here it must refuse to run, and
its helpers for K1's launch record, bounds and the ptxas report are
checked on synthetic inputs."""

import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def test_refuses_to_run_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and '"kernels"' not in r.stdout


def test_record_legs_notes_each_launch_and_passes_it_through():
    launches, store = [], {}
    calls = []

    def real(*a):
        calls.append(a)
        return "out"
    leg = chip_smoke.record_legs(real, launches, store, "point")
    Q, q, A, b = (torch.zeros(3, 5, 5), torch.zeros(3, 5),
                  torch.zeros(3, 35, 5), torch.zeros(3, 35))
    st = (torch.zeros(3, 5), torch.ones(3, 35), torch.ones(3, 35))
    assert leg(Q, q, A, b, *st, 12) == "out"
    assert launches == [(3, 5, 35, 12)]
    assert store["point"][0] is Q and len(calls) == 1 and calls[0][-1] == 12


def test_leg_histogram_sums_the_bounds_of_the_launches():
    launches = [(8, 5, 35, 12), (1024, 5, 35, 12), (256, 8, 39, 18),
                (2048, 8, 38, 30)]
    total = chip_smoke.leg_histogram(launches)
    assert total == pytest.approx(
        sum(chip_smoke.leg_bound_ms(*x) for x in launches))
    # The bound grows with the work: K and iterations.
    assert chip_smoke.leg_bound_ms(16, 5, 35, 12) \
        > chip_smoke.leg_bound_ms(8, 5, 35, 12)
    assert chip_smoke.leg_bound_ms(8, 5, 35, 18) \
        > chip_smoke.leg_bound_ms(8, 5, 35, 12)


def test_baseline_source_reads_k1_baseline(tmp_path):
    assert chip_smoke.baseline_source({}) is None
    assert chip_smoke.baseline_source({"K1_BASELINE": "  "}) is None
    src = tmp_path / "ipm_leg.cu"
    src.write_text("// another version\n")
    assert chip_smoke.baseline_source({"K1_BASELINE": str(src)}) \
        == str(src)
    with pytest.raises(SystemExit):
        chip_smoke.baseline_source({"K1_BASELINE": str(tmp_path / "no.cu")})


def test_bound_uses_the_cards_float64_peak():
    """The f64 bound divides by the card's highest f64 rate (its FP64
    tensor cores), never by a lower one."""
    assert chip_smoke.PEAK_F64_S == 67e12
    nbytes, flops = chip_smoke.ipm_leg_cost(1 << 20, 5, 35, 12, 8)
    assert chip_smoke.leg_bound_ms(1 << 20, 5, 35, 12) == pytest.approx(
        1e3 * max(nbytes / 3.35e12, flops / 67e12))


def _di_build(eps_a, recorder=None):
    from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
    from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
        build_partition)
    from explicit_hybrid_mpc_tpu_torch.problems.registry import make

    kw = {"N": 3, "theta_box": 1.5}
    cfg = PartitionConfig(problem="double_integrator", backend="cpu",
                          problem_args=tuple(sorted(kw.items())),
                          eps_a=eps_a, batch_simplices=64, max_depth=20)
    prob = make("double_integrator", **kw)
    if recorder is None:
        return prob, build_partition(prob, cfg)
    with recorder:
        return prob, build_partition(prob, cfg)


def test_tree_diff_names_the_deciding_test():
    """Two builds that differ only in eps_a: the recorders see every
    cell, the diff finds the cells one split and the other closed, and
    each explanation gives both gaps against eps_a; the same build twice
    gives no differing cell, and the wrappers are restored."""
    import numpy as np

    from explicit_hybrid_mpc_tpu_torch.oracle import ipm, oracle
    from explicit_hybrid_mpc_tpu_torch.partition import certify, geometry

    real = (certify.certify_stage1_batch, ipm.qp_solve)
    recs = (chip_smoke.DecisionRecorder(certify, ipm),
            chip_smoke.DecisionRecorder(certify, ipm))
    prob, loose = _di_build(0.5, recs[0])
    _, tight = _di_build(0.3, recs[1])
    assert (certify.certify_stage1_batch, ipm.qp_solve) == real
    a, b = (chip_smoke.tree_outcomes(r.tree) for r in (loose, tight))
    assert len(a) == len(loose.tree) and len(recs[0].cells) == len(a)
    assert sum(v[0] == "leaf" for v in a.values()) \
        == loose.stats["regions"]
    assert chip_smoke.differing_cells(
        a, chip_smoke.tree_outcomes(_di_build(0.5)[1].tree)) == ([], 0)
    diff, _ = chip_smoke.differing_cells(a, b)
    assert diff and all(a[k][0] == "leaf" and b[k][0] == "split"
                        for k in diff)
    dp = oracle.to_device(prob.canonical, torch.device("cpu"))

    def point_key(v, d):
        _Q, q, _A, bb = oracle.point_qp(
            dp, torch.as_tensor(v[None]), torch.as_tensor([d]))
        return chip_smoke.DecisionRecorder.qp_key(q, bb)[0]

    def simplex_key(vs, d):
        M = torch.as_tensor(geometry.barycentric_matrix(vs)[None])
        _Q, q, _A, bb = oracle.simplex_min_qp(dp, M, torch.as_tensor([d]))
        return chip_smoke.DecisionRecorder.qp_key(q, bb)[0]
    # The cell's vertex QPs were solved (and recorded) by the build,
    # under the keys explain_cell looks up.
    verts = np.frombuffer(diff[0], dtype=np.float64).reshape(3, 2).copy()
    assert all(point_key(v, 0) in recs[0].qps for v in verts)
    lines = chip_smoke.explain_cell(diff[0], 2, (a[diff[0]], b[diff[0]]),
                                    recs, 0.5, point_key, simplex_key)
    assert "baseline ('leaf'" in lines[0] and "kernel ('split',)" in lines[0]
    assert lines[1].startswith("  baseline: stage 1 ") \
        and "eps_a x" in lines[1] and lines[2].startswith("  kernel: ")


def test_explain_cell_shows_a_tie_in_a_vertex_argmin():
    """A vertex whose two best commutations tie in one build and not in
    the other: both values, both builds, and the tie's margin."""
    import types

    import numpy as np

    verts = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
    V = np.array([[1.0, 3.0], [1.5, 3.0], [2.0, 2.0]])
    Vk = V.copy()
    Vk[2, 1] = np.nextafter(2.0, 0.0)
    cell = dict(s1="pending", conv=np.ones((3, 2), dtype=bool))
    recs = tuple(types.SimpleNamespace(qps={}, cells={verts.tobytes(): {
        **cell, "s2": s2, "gap2": g, "dstar": np.array(ds), "V": v,
        "Vmin": {}}}) for s2, g, ds, v in (
            ("certified", 0.25, [0, 0, 0], V),
            ("split", 0.75, [0, 0, 1], Vk)))
    lines = chip_smoke.explain_cell(verts.tobytes(), 2, (("leaf", 0, True),
                                                        ("split",)),
                                    recs, 0.5, None, None)
    assert "certified, gap 0.25 = eps_a x 0.5" in lines[1]
    assert "split, gap 0.75 = eps_a x 1.5" in lines[2]
    assert len(lines) == 4 and lines[3].startswith(
        "  vertex 2: best commutation 0 / 1; V[0], V[1] = 2.0, 2.0 / 2.0, "
        "1.9999999999999998; (V[0] - V[1]) / |V[1]| = 0 / 1.11e-16")


def test_ptxas_lines_name_the_template_arguments():
    report = "\n".join([
        "ptxas info    : Compiling entry function '_ZN40_GLOBAL__N__x_"
        "10_ipm_leg_cu_d315ipm_leg_fixedIdLi8ELi2EEEvPKT_S3_S3_S3_S3_S3_S3_"
        "PS1_S4_S4_ii' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN...",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 240 registers, used 0 barriers, 1088 bytes smem",
        "ptxas info    : Compiling entry function '_ZN40_GLOBAL__N__x_"
        "10_ipm_leg_cu_d315ipm_leg_generalIfEEvPKT_S3_iiiii' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN...",
        "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 104 registers, used 0 barriers"])
    lines = chip_smoke.ptxas_lines("ipm_leg", report)
    assert lines == [
        "ipm_leg: ipm_leg_fixed<double, NZ=8, ROWS=2>: 240 registers; "
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ipm_leg: ipm_leg_general<float>: 104 registers; "
        "8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads"]


def test_baseline_source_reads_each_kernels_variable(tmp_path):
    src = tmp_path / "locate.cu"
    src.write_text("// the parent\n")
    env = {"K2_BASELINE": str(src), "K3_BASELINE": ""}
    assert chip_smoke.baseline_source(env, "K2_BASELINE") == str(src)
    assert chip_smoke.baseline_source(env, "K3_BASELINE") is None
    assert chip_smoke.baseline_source(env) is None
    with pytest.raises(SystemExit):
        chip_smoke.baseline_source({"K3_BASELINE": str(tmp_path / "x.cu")},
                                   "K3_BASELINE")
    # Each parent is typed with its own C interface.
    sigs = chip_smoke._ctypes_sigs()
    assert len(sigs["locate"]["locate_f32"]) == 8
    assert len(sigs["arena_eval"]["arena_eval_f32"]) == 11


def test_ptxas_lines_name_the_point_location_kernels():
    def entry(name):
        return [f"ptxas info    : Compiling entry function '{name}' for "
                "'sm_90a'",
                "    0 bytes stack frame, 0 bytes spill stores, 0 bytes "
                "spill loads",
                "ptxas info    : Used 56 registers, used 1 barriers, "
                "12288 bytes smem"]
    report = "\n".join(
        entry("_ZN40_GLOBAL__N__a1b2c3d4_9_locate_cu_5e6f7a8b13locate_"
              "kernelILi3EEEvPKfS2_iiiiPiPfS3_S4_")
        + entry("_ZN40_GLOBAL__N__a1b2c3d4_9_locate_cu_5e6f7a8b12locate_"
                "mergeEPKiPKfiiPiPf")
        + entry("_ZN40_GLOBAL__N__a1b2c3d4_13_arena_eval_cu_5e6f7a8b17arena"
                "_eval_kernelILi8EEEvPKfPKNS_4TileEPKiS2_S2_S2_iiiiPiPfS6_"
                "S6_"))
    assert [ln.split(":")[1].strip() for ln in
            chip_smoke.ptxas_lines("k", report)] == [
        "locate_kernel<K=3>", "locate_merge", "arena_eval_kernel<K=8>"]


# -- phases 11-13 (the closed loop, the serve entry point, the large
# partition), rehearsed on the CPU at a tiny size -------------------------


def test_host_eval_is_evaluate_np_over_a_batch():
    import numpy as np

    from explicit_hybrid_mpc_tpu_torch.online import evaluator, export
    from explicit_hybrid_mpc_tpu_torch.partition.synthetic import (
        build_synthetic_tree)

    tree, _roots = build_synthetic_tree(p=2, depth=5, n_u=2)
    table = export.export_leaves(tree)
    th = np.random.default_rng(0).uniform(-0.2, 1.2, (300, 2))
    u, cost, inside = chip_smoke.host_eval(table, th, chunk=64)
    for k in range(0, 300, 17):
        np.testing.assert_allclose(u[k], evaluator.evaluate_np(table, th[k]),
                                   rtol=0, atol=1e-12)
        s = chip_smoke.host_scores(table, th[k])
        assert inside[k] == (s.max() >= -1e-9)
    inb = ((th >= 0) & (th <= 1)).all(axis=1)
    assert np.array_equal(inside, inb)
    np.testing.assert_allclose(cost[inb], th[inb].sum(axis=1), atol=1e-12)
    assert chip_smoke.device_profile(lambda: None,
                                     torch.device("cpu")) == (None, None)


def test_new_phases_rehearse_on_the_cpu(tmp_path, monkeypatch, capsys):
    """Phases 11-13 end to end on the CPU at a tiny size (the kernels'
    plain versions): they hold their results to the f64 references and
    print their lines; only the launch counts need the card."""
    import numpy as np

    from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
    from explicit_hybrid_mpc_tpu_torch.online import export
    from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
        build_partition)
    from explicit_hybrid_mpc_tpu_torch.problems.registry import make

    for k, v in dict(SIM_T=12, SIM_DI_T=5, SERVE_SELFTEST=300,
                     SERVE_HOLD=256, SWAP_CLIENTS=3, SWAP_REQUESTS=20,
                     LARGE_DEPTH=2, LARGE_B=256, LARGE_HOLD=128,
                     LARGE_NP_HOLD=4, LARGE_REPS=1, MAX_BATCH=64).items():
        monkeypatch.setattr(chip_smoke, k, v)
    dev = torch.device("cpu")
    problem = make("inverted_pendulum", N=2)
    cfg = PartitionConfig(problem="inverted_pendulum",
                          problem_args=(("N", 2),), eps_a=0.5,
                          backend="cpu", batch_simplices=64, max_depth=14)
    res = build_partition(problem, cfg)
    table = export.export_leaves(res.tree)
    sim = chip_smoke.closed_loop_phase(dev, problem, cfg, table,
                                       str(tmp_path))
    chip_smoke.serve_entry_phase(dev, problem, cfg, res, table,
                                 np.random.default_rng(0), str(tmp_path))
    chip_smoke.large_partition_phase(dev)
    out = capsys.readouterr().out
    assert sim["sim_k1"] == sim["sim_k2"] == 0   # plain versions here
    assert sim["explicit_us"] > 0 and sim["implicit_us"] > 0
    for tag in ("[sim] explicit held at", "[sim] implicit held at",
                "sim.json has the JAX package's keys",
                "[serve-cli] serve --selftest 300", "[serve] ShardedDescent",
                "[sim] one explicit step", "[sim] one implicit step",
                "0 answers not bitwise", "[large] flat: 128 queries inside",
                "[large] sharded: 128 queries inside"):
        assert tag in out, tag
    assert "FAIL" not in out


def test_other_problems_phase_rehearses_on_the_cpu(tmp_path, monkeypatch,
                                                    capsys):
    """Phase 14 on the CPU: the build CLI's argv with --backend cpu at
    reduced configurations (their port CPU counts as the references),
    each table held to the f64 host evaluator, and K1's large-path sweep
    against the plain version at a small large-path shape.  The kernels
    line's "large" object carries every key; its times need the card."""
    builds = (
        ("quadrotor", ("-e", "quadrotor", "-r", "0.1", "-a", "1",
                       "--problem-arg", 'param="p"', "--problem-arg", "N=2",
                       "--problem-arg", "pos_box=0.4"), 16, True),
        ("satellite", ("-e", "satellite", "-r", "0.1", "-a", "1",
                       "--problem-arg", "axes=1", "--problem-arg", "N=2"),
         33, False))
    for k, v in dict(OTHER_BUILDS=builds, OTHER_EVALUATE=512, OTHER_HOLD=256,
                     K1_LARGE_SHAPES=((33, 129),), K1_LARGE_K=(2,),
                     K1_GENERAL_SHAPE=(12, 40), K1_GENERAL_K=(2, 3)).items():
        monkeypatch.setattr(chip_smoke, k, v)
    large, general = chip_smoke.other_problems_phase(torch.device("cpu"),
                                                     str(tmp_path))
    out = capsys.readouterr().out
    assert "FAIL" not in out
    for tag in ("[other] main -e quadrotor", "regions 16 (reference 16)",
                "regions 33 (reference 33)",
                "[other] satellite: K2 (p=2, 33 leaves)",
                "[K1-large] nz=33 nc=129 K=2",
                "[K1-general] nz=12 nc=40 K=3 n_iter=18",
                "[K1-general] the satellite 4c build: 0 K1 launches"):
        assert tag in out, tag
    assert set(general) == {"nz", "nc", "n_iter", "cells", "plain_ms",
                            "max_rel_err_f64", "launches"}
    assert [c["K"] for c in general["cells"]] == [2, 3]
    assert general["cells"][0]["ms"] is None and general["launches"] == 0
    assert general["cells"][1]["bound_ms"] == pytest.approx(
        chip_smoke.leg_bound_ms(3, 12, 40, 18))
    assert os.path.exists(str(tmp_path / "quadrotor.artifacts"))
    assert set(large) == {"nz", "nc", "K", "n_iter", "ms", "plain_ms",
                          "bound_ms", "bound_by", "max_rel_err_f64",
                          "max_rel_err_f32", "launches", "large_launches",
                          "build_ms", "build_bound_ms", "cells"}
    # On the CPU nothing launches and no time is measured.
    assert large["launches"] == 0 and large["ms"] is None
    assert large["build_ms"] is None and large["plain_ms"] is None
    assert large["max_rel_err_f64"] <= 1e-9
    assert large["bound_ms"] == pytest.approx(
        chip_smoke.leg_bound_ms(2, 33, 129, 18))


def test_a_wrong_reference_fails_the_phase(tmp_path, monkeypatch):
    builds = (("satellite", ("-e", "satellite", "-r", "0.1", "-a", "1",
                             "--problem-arg", "axes=1", "--problem-arg",
                             "N=2"), 100, False),)
    for k, v in dict(OTHER_BUILDS=builds, OTHER_EVALUATE=64,
                     OTHER_HOLD=64).items():
        monkeypatch.setattr(chip_smoke, k, v)
    with pytest.raises(SystemExit):
        chip_smoke.other_problems_phase(torch.device("cpu"), str(tmp_path))


def test_plain_leg_in_chunks_is_the_whole_batch(monkeypatch):
    import numpy as np

    from explicit_hybrid_mpc_tpu_torch.oracle import ipm_leg

    args = chip_smoke.random_qps(np.random.default_rng(0), 5, 6, 20,
                                 torch.device("cpu"))
    monkeypatch.setattr(chip_smoke, "K1_PLAIN_CHUNK", 2)
    whole = ipm_leg.ipm_leg_torch(*args, n_iter=3)
    for a, b in zip(chip_smoke.plain_leg(args, 3), whole):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


def test_rebuild_phase_rehearses_on_the_cpu(tmp_path, monkeypatch, capsys):
    """Phase 15 on the CPU from a small pendulum prior (eps_a 0.5, the
    tightened rebuild at 0.4; the port's CPU counts are the references):
    `main rebuild` unchanged and tightened, the tightened table held to
    the f64 host evaluator, the rebuild service over two drift revisions
    under 3 submitting threads with the torn-result audit, and `main
    serve-rebuild`."""
    import dataclasses

    from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
    from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
        build_partition)
    from explicit_hybrid_mpc_tpu_torch.partition.rebuild import warm_rebuild
    from explicit_hybrid_mpc_tpu_torch.problems.registry import make

    problem = make("inverted_pendulum", N=2)
    cfg = PartitionConfig(problem="inverted_pendulum",
                          problem_args=(("N", 2),), eps_a=0.5,
                          backend="cpu", batch_simplices=64, max_depth=14)
    res = build_partition(problem, cfg)
    same = warm_rebuild(problem, cfg, res.tree).stats["regions"]
    tight = warm_rebuild(problem, dataclasses.replace(cfg, eps_a=0.4),
                         res.tree).stats["regions"]
    for k, v in dict(REBUILD_REF_REGIONS=same, REBUILD_TIGHT_EPS=0.4,
                     REBUILD_TIGHT_REF_REGIONS=tight, QUERIES=512,
                     OTHER_HOLD=256, SERVICE_CLIENTS=3,
                     MAX_BATCH=64).items():
        monkeypatch.setattr(chip_smoke, k, v)
    out = chip_smoke.rebuild_phase(torch.device("cpu"), problem, cfg, res,
                                   1.0, str(tmp_path))
    log = capsys.readouterr().out
    assert "FAIL" not in log
    for tag in (f"regions {same} (reference {same})",
                f"regions {tight} (reference's warm rebuild {tight}",
                "payloads (delta, inputs, costs, flags) bitwise",
                "[other] rebuild eps 0.4: K2",
                "[service] RebuildService on cpu: 2 generations, 0 failures",
                "0 dropped; 0 results not bitwise",
                "[serve-rebuild] main serve-rebuild", "exit 0"):
        assert tag in log, tag
    # On the CPU nothing launches and no device time is measured.
    assert out == {"ipm_leg": {"rebuild_launches": 0, "rebuild_ms": None,
                               "rebuild_bound_ms": 0.0},
                   "locate": {"rebuild_launches": 0}}


def test_a_wrong_rebuild_reference_fails_the_phase(tmp_path, monkeypatch):
    from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
    from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
        build_partition)
    from explicit_hybrid_mpc_tpu_torch.problems.registry import make

    problem = make("double_integrator", N=3, theta_box=1.5)
    cfg = PartitionConfig(problem="double_integrator",
                          problem_args=(("N", 3), ("theta_box", 1.5)),
                          eps_a=0.5, backend="cpu", batch_simplices=64)
    res = build_partition(problem, cfg)
    monkeypatch.setattr(chip_smoke, "REBUILD_REF_REGIONS",
                        2 * res.stats["regions"])
    with pytest.raises(SystemExit):
        chip_smoke.rebuild_phase(torch.device("cpu"), problem, cfg, res,
                                 1.0, str(tmp_path))
