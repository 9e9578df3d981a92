"""Torch port: the parts of chip_smoke.py that run without a GPU.

The script itself needs a CUDA device; here it must refuse to run, and
its helpers for K1's launch record, bounds and the ptxas report are
checked on synthetic inputs."""

import os
import subprocess
import sys
import time

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


def test_ptxas_lines_name_the_general_path_bucket():
    report = "\n".join([
        "ptxas info    : Compiling entry function '_ZN43_GLOBAL__N__x_"
        "10_ipm_leg_cu_dfdcc5d311ipm_leg_midIdLi24EEEvPKT_S3_S3_S3_S3_S3_"
        "S3_PS1_S4_S4_iii' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN...",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers, used 0 barriers"])
    assert chip_smoke.ptxas_lines("ipm_leg", report) == [
        "ipm_leg: ipm_leg_mid<double, NZB=24>: 168 registers; "
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"]


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
                     K1_GENERAL_CELLS=(("point", (12, 40), (2, 3), 18),),
                     K1_GENERAL_MAIN=((12, 40), 3)).items():
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
                "[K1-general] the satellite 4c build: 0 K1 launches",
                "[K1-general] the satellite 4c build satellite (phase 14): "
                "K1 0 launches"):
        assert tag in out, tag
    assert set(general) == {"nz", "nc", "K", "n_iter", "ms", "plain_ms",
                            "bound_ms", "bound_by", "max_rel_err_f64",
                            "max_rel_err_f32", "cells", "base_ratio",
                            "large_ratio", "large_faster", "launches",
                            "builds"}
    assert [c["K"] for c in general["cells"]] == [2, 3]
    assert general["cells"][0]["ms"] is None and general["launches"] == 0
    assert general["K"] == 3 and general["ms"] is None
    assert general["cells"][1]["bound_ms"] == pytest.approx(
        chip_smoke.leg_bound_ms(3, 12, 40, 18))
    # The satellite build's K1 record (nothing launches on the CPU).
    unpruned = general["builds"]["unpruned"]
    assert unpruned["launches"] == 0 and unpruned["k1_ms"] is None
    assert unpruned["by_cell"] == {} and unpruned["wall_s"] > 0
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


def _plain_leg_as_kernel(monkeypatch):
    """The plain leg in the kernel's place on the CPU: every leg goes
    through ipm_leg.ipm_leg_cuda, which runs the plain version and counts
    one launch, so the phases' launch records and counts both see it."""
    from explicit_hybrid_mpc_tpu_torch.oracle import ipm_leg

    real = ipm_leg.ipm_leg_torch

    def leg(Q, q, A, b, z, s, lam, n_iter):
        if q.shape[0] == 0 or n_iter <= 0:
            return z, s, lam
        ipm_leg.launches += 1
        return real(Q, q, A, b, z, s, lam, n_iter)

    def dispatch(Q, q, A, b, z, s, lam, n_iter):
        if n_iter <= 0:
            return z, s, lam
        return ipm_leg.ipm_leg_cuda(Q, q, A, b, z, s, lam, n_iter)
    monkeypatch.setattr(ipm_leg, "ipm_leg_cuda", leg)
    monkeypatch.setattr(ipm_leg, "ipm_leg", dispatch)


def test_rebuild_phase_rehearses_on_the_cpu(tmp_path, monkeypatch, capsys):
    """Phase 15 on the CPU from a small pendulum prior (eps_a 0.5, the
    tightened rebuild at 0.4; the port's CPU counts are the references):
    `main rebuild` unchanged and tightened, the tightened table held to
    the f64 host evaluator, the rebuild service over two drift revisions
    under 3 submitting threads with the torn-result audit, and `main
    serve-rebuild`.  The plain leg counts as K1, so the phase's K1
    references are each its own rebuild's count (15b's, not 15c's)."""
    import dataclasses

    from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
    from explicit_hybrid_mpc_tpu_torch.oracle import ipm_leg
    from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
        build_partition)
    from explicit_hybrid_mpc_tpu_torch.partition.rebuild import warm_rebuild
    from explicit_hybrid_mpc_tpu_torch.problems.registry import make

    problem = make("inverted_pendulum", N=2)
    cfg = PartitionConfig(problem="inverted_pendulum",
                          problem_args=(("N", 2),), eps_a=0.5,
                          backend="cpu", batch_simplices=64, max_depth=14)
    res = build_partition(problem, cfg)
    _plain_leg_as_kernel(monkeypatch)
    counts = []
    for eps in (0.5, 0.4):
        ipm_leg.launches = 0
        counts.append((warm_rebuild(problem, dataclasses.replace(
            cfg, eps_a=eps), res.tree).stats["regions"], ipm_leg.launches))
    (same, k1_same), (tight, k1_tight) = counts
    assert 0 < k1_same < k1_tight
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
    # The plain leg counted as K1; no device time is measured on the CPU.
    assert out["refs"] == {
        "unchanged": {"regions": same, "k1_launches": k1_same,
                      "k1_ms": None},
        "tight": {"regions": tight, "k1_launches": k1_tight}}
    assert f"launches counted from zero: ipm_leg {k1_tight}," in log
    assert out["ipm_leg"]["rebuild_launches"] == k1_same
    assert out["ipm_leg"]["rebuild_ms"] is None
    assert out["ipm_leg"]["rebuild_bound_ms"] > 0
    assert out["locate"] == {"rebuild_launches": 0}


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


def test_observability_phase_rehearses_on_the_cpu(tmp_path, monkeypatch,
                                                  capsys):
    """Phase 16 on the CPU from a small pendulum build (the port's CPU
    counts as the reference): the serial baseline held to the cpu
    oracle, `main --profile` and the auto-profile bundle, the traced
    arena and RequestScheduler runs (phase sums, exemplars, bitwise the
    untraced runs) and the rebuild service's host forensics, each with
    the host's verdict."""
    from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
    from explicit_hybrid_mpc_tpu_torch.online import export
    from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
        build_partition)
    from explicit_hybrid_mpc_tpu_torch.problems.registry import make

    problem = make("inverted_pendulum", N=2)
    cfg = PartitionConfig(problem="inverted_pendulum",
                          problem_args=(("N", 2),), eps_a=0.5,
                          backend="cpu", batch_simplices=64, max_depth=14)
    res = build_partition(problem, cfg)
    table = export.export_leaves(res.tree)
    for k, v in dict(REF_REGIONS=res.stats["regions"], SERIAL_POINTS=6,
                     REQUESTS=300, CLIENTS=4, SWAP_CLIENTS=3,
                     SWAP_REQUESTS=20, SERVICE_CLIENTS=3, MAX_BATCH=64,
                     HOST_INTERVAL_S=0.05).items():
        monkeypatch.setattr(chip_smoke, k, v)
    host = chip_smoke.HostVerdict()
    chip_smoke.observability_phase(torch.device("cpu"), problem, cfg, res,
                                   table, str(tmp_path), host)
    summary = host.summary()
    out = capsys.readouterr().out
    assert "FAIL" not in out
    for tag in ("[serial] SerialBnB(Oracle(backend='serial')).measure on 6",
                "(ipm_leg launches 0)", "d* equal on",
                "[profile] main -e inverted_pendulum", "exit 0",
                "[profile] auto_profile engine: trigger_auto_profile -> 3",
                "error None", "[trace] arena: 300 tickets",
                "[trace] RequestScheduler: 60 tickets",
                "traced results bitwise the untraced runs'",
                "[trace] arena phases (us): queue p50",
                "[trace] arena batch cycle", "[trace] queue_frac: arena t0",
                "[forensics] RebuildService, one u_max generation",
                "serve.host.stall_us: count", "[host] phase 16a",
                "[host] phase 16d", "[observe] (phase took"):
        assert tag in out, tag
    assert {"cpu_count", "loadavg_end", "procfs_counts_cpu"} <= set(summary)


def test_host_verdict_reads_each_phase_s_own_samples(monkeypatch, capsys):
    monkeypatch.setattr(chip_smoke, "HOST_INTERVAL_S", 60.0)
    host = chip_smoke.HostVerdict()
    host.blind = False
    host.mon._samples.extend([0.01, 0.02])
    assert "mean 0.015, max 0.020, contended False (2 samples)" \
        in host.end("one")
    host.mon._samples.extend([0.3])
    assert "mean 0.300, max 0.300, contended True (1 samples)" \
        in host.end("two")
    assert "no sample" in host.end("three")
    out = capsys.readouterr().out
    assert "[host] one: competing_cpu_frac_mean 0.015" in out
    assert "[host] three: no sample" in out
    assert host.summary()["procfs_counts_cpu"] is True


def test_host_verdict_on_a_procfs_that_counts_no_cpu_time(monkeypatch):
    """A sandbox whose /proc/stat cpu line is all zeros cannot show
    other processes' load: the verdict says not measured."""
    from explicit_hybrid_mpc_tpu_torch.obs import host as host_mod

    monkeypatch.setattr(chip_smoke, "HOST_INTERVAL_S", 60.0)
    monkeypatch.setattr(host_mod.ContentionMonitor, "_jiffies",
                        lambda self: (0, 0))
    host = chip_smoke.HostVerdict()
    host.mon._samples.extend([0.0, 0.0])
    assert host.blind and host.end("one").startswith("not measured")
    assert host.summary()["procfs_counts_cpu"] is False


def _jax_masks(name, **kw):
    """PRUNE_MASKS' entry from the JAX package's PrunedOracle (CPU)."""
    import explicit_hybrid_mpc_tpu  # noqa: F401  (enables x64)
    from explicit_hybrid_mpc_tpu.oracle.prune import PrunedOracle
    from explicit_hybrid_mpc_tpu.problems.registry import make as jmake

    po = PrunedOracle(jmake(name, **kw), backend="cpu")
    red = po._red_dev
    return (chip_smoke.mask_digest(po.row_keep, po.var_keep),
            int(po.row_keep.sum()), int(po.var_keep.sum()),
            (int(red.H.shape[1]), int(red.G.shape[1])))


def test_prune_masks_are_the_jax_packages():
    """Phase 17's mask constants are the JAX package's PrunedOracle
    masks on the published sub-boxes (OTHER_BUILDS' problem args)."""
    assert chip_smoke.PRUNE_MASKS["quadrotor"] == _jax_masks(
        "quadrotor", param="pv", pos_box=0.4, vel_box=0.2)
    assert chip_smoke.PRUNE_MASKS["satellite"] == _jax_masks(
        "satellite", axes=3, omega_box=0.03, h_box=0.3)


def test_pruning_soc_phase_rehearses_on_the_cpu(tmp_path, monkeypatch,
                                                capsys):
    """Phase 17 on the CPU at reduced configurations: phase 14's small
    builds with --prune-rows (the JAX package's masks for them as
    PRUNE_MASKS, the port's unpruned CPU counts as the references), K1
    against its plain version at their reduced shapes, the SOC solves
    and a one-step SOC partition of a small satellite_soc box (the port's
    CPU count as the reference).  The "pruned" object carries every key;
    its times need the card."""
    builds = (
        ("quadrotor", ("-e", "quadrotor", "-r", "0.1", "-a", "1",
                       "--problem-arg", 'param="p"', "--problem-arg", "N=2",
                       "--problem-arg", "pos_box=0.4"), 16, True),
        ("satellite", ("-e", "satellite", "-r", "0.1", "-a", "1",
                       "--problem-arg", "axes=1", "--problem-arg", "N=2"),
         33, False))
    masks = {"quadrotor": _jax_masks("quadrotor", param="p", N=2,
                                     pos_box=0.4),
             "satellite": _jax_masks("satellite", axes=1, N=2)}
    unpruned = {"quadrotor": {"stats": {"regions": 16}, "wall": 1.0,
                              "n_k1": 0, "legs": [], "k1_ms": None}}
    for k, v in dict(OTHER_BUILDS=builds, OTHER_HOLD=256, PRUNE_MASKS=masks,
                     K1_PRUNED_K=(2,),
                     SOC_ARGS=(("N", 2), ("h_box", 0.15),
                               ("omega_box", 0.015)),
                     SOC_CFG=(("eps_a", 4.0), ("eps_r", 0.5),
                              ("batch_simplices", 64), ("max_depth", 16),
                              ("semi_explicit_boundary_depth", 8),
                              ("max_steps", 1)),
                     SOC_REF_REGIONS=64, SOC_THETAS=4,
                     SOC_SAMPLES=4).items():
        monkeypatch.setattr(chip_smoke, k, v)
    # One thread, as the other CPU parity files: the plain SOC solves
    # would otherwise take every core from the tests beside it.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = chip_smoke.pruning_soc_phase(torch.device("cpu"),
                                           str(tmp_path), unpruned)
    finally:
        torch.set_num_threads(threads)
    log = capsys.readouterr().out
    assert "FAIL" not in log
    for tag in ("regions 16 (reference 16)", "regions 33 (reference 33)",
                "[prune] quadrotor: point (reduced)",
                "[prune] satellite unpruned (phase 14, same run)",
                "[other] satellite --prune-rows: K2",
                "[K1-pruned] quadrotor point (reduced)",
                "[soc] satellite_soc", "regions 64 (reference 64)",
                "[soc] soundness: 4 thetas in certified leaves"):
        assert tag in log, tag
    assert set(out) == {"nz", "nc", "K", "n_iter", "ms", "plain_ms",
                        "bound_ms", "bound_by", "max_rel_err_f64",
                        "max_rel_err_f32", "cells", "builds", "soc"}
    # On the CPU nothing launches and no time is measured.
    assert out["ms"] is None and out["plain_ms"] is None
    assert out["max_rel_err_f64"] <= 1e-9
    assert (out["nz"], out["nc"]) == masks["quadrotor"][3]
    assert out["builds"]["quadrotor"]["launches"] == 0
    assert out["soc"]["partition"]["regions"] == 64


def test_k1_large_only_rehearses_on_the_cpu(monkeypatch, capsys):
    """The K1-only entry on the CPU at small shapes: every large-path
    and general-path cell through the plain version (f64 to 1e-9, f32
    as phase 2), no time measured, and the stamped copy of csrc/
    ipm_leg.cu written with a stamp at each section boundary."""
    monkeypatch.delenv("K1_BASELINE", raising=False)
    for k, v in dict(K1_LARGE_SHAPES=((33, 129),), K1_LARGE_K=(2,),
                     K1_PRUNED_SHAPES=((34, 20),), K1_PRUNED_K=(3,),
                     K1_LARGE_EXTRA=((5, 140),), K1_LARGE_EXTRA_K=(2,),
                     K1_GENERAL_CELLS=(("point", (12, 40), (2,), 12),
                                       ("pruned point", (10, 14), (3,), 30))
                     ).items():
        monkeypatch.setattr(chip_smoke, k, v)
    assert chip_smoke.k1_large_only(torch.device("cpu")) == 0
    out = capsys.readouterr().out
    assert "FAIL" not in out
    for tag in ("[K1-large] nz=33 nc=129 K=2 n_iter=18 (large path)",
                "[K1-pruned] quadrotor nz=34 nc=20 K=3 n_iter=30 (large "
                "path)", "[K1-large] nz=5 nc=140 K=2 n_iter=18 (large path)",
                "[K1-general] nz=12 nc=40 K=2 n_iter=12 (general path)",
                "[K1-general] nz=10 nc=14 K=3 n_iter=30 (general path)",
                "[K1-split] new: stamped copy", "(8 stamps)"):
        assert tag in out, tag


def test_k1_general_only_rehearses_on_the_cpu(monkeypatch, capsys):
    """The general path's K1-only entry on the CPU at small shapes: each
    cell of K1_GENERAL_CELLS through the plain version (f64 to 1e-9, f32
    as phase 2) at its own iteration count, no time measured and no
    ratio (the baselines need the card), and the stamped copy of the
    general kernel written with a stamp at each section boundary."""
    import json

    monkeypatch.delenv("K1_BASELINE", raising=False)
    cells = (("point", (12, 40), (2, 3), 12),
             ("pruned point", (24, 14), (2,), 30),
             ("edge", (9, 33), (1,), 18))
    monkeypatch.setattr(chip_smoke, "K1_GENERAL_CELLS", cells)
    monkeypatch.setattr(chip_smoke, "K1_GENERAL_MAIN", ((24, 14), 2))
    assert chip_smoke.k1_general_only(torch.device("cpu")) == 0
    out = capsys.readouterr().out
    assert "FAIL" not in out
    for tag in ("[K1-general] nz=12 nc=40 K=2 n_iter=12 (general path)",
                "[K1-general] nz=12 nc=40 K=3 n_iter=12 (general path)",
                "[K1-general] nz=24 nc=14 K=2 n_iter=30 (general path)",
                "[K1-general] nz=9 nc=33 K=1 n_iter=18 (general path)",
                "[K1-split] general: stamped copy", "(8 stamps)"):
        assert tag in out, tag
    line = next(ln for ln in out.splitlines() if ln.startswith('{"general"'))
    general = json.loads(line)["general"]
    assert [(c["label"], c["K"]) for c in general["cells"]] == [
        ("point", 2), ("point", 3), ("pruned point", 2), ("edge", 1)]
    assert (general["nz"], general["nc"], general["K"]) == (24, 14, 2)
    assert all(c["ms"] is None and "base_ratio" not in c
               for c in general["cells"])
    assert general["base_ratio"] is None and general["large_faster"] == []
    assert general["max_rel_err_f64"] <= 1e-9


def test_general_path_cells_take_the_builds_iteration_counts(monkeypatch):
    """A cell's n_iter is the satellite build's most frequent count for
    its shape where phase 14 recorded one, the cell's own otherwise."""
    monkeypatch.setattr(chip_smoke, "K1_GENERAL_CELLS",
                        (("a", (12, 40), (1,), 12), ("b", (10, 14), (1,), 30)))
    legs = [(8, 12, 40, 5), (16, 12, 40, 5), (8, 12, 40, 7), (8, 60, 360, 9)]
    out = chip_smoke.general_path_cells(torch.device("cpu"), legs)
    assert [c["n_iter"] for c in out["cells"]] == [5, 30]
    assert out["launches"] == 3


def test_in_turns_time_every_baseline_around_the_kernel_twice():
    """in_turns_each: the baselines in order, the kernel twice, the
    baselines in reverse order (each timer call recorded), each
    baseline's two readings kept; in_turns is its one-baseline case."""
    calls = []
    ms_of = {"new": 1.0, "a": 2.0, "b": 4.0}

    def timer(fn, reps):
        calls.append(fn)
        return ms_of[fn] + len(calls) / 100

    ms, runs = chip_smoke.in_turns_each("new", {"a": "a", "b": "b"}, 5,
                                        timer)
    assert calls == ["a", "b", "new", "new", "b", "a"]
    assert ms == pytest.approx(1.035)
    assert runs == {"a": (2.01, 2.06), "b": (4.02, 4.05)}
    calls.clear()
    ms, base_ms, text = chip_smoke.in_turns("new", "a", 5, timer)
    assert calls == ["a", "new", "new", "a"]
    assert base_ms == pytest.approx(2.025) and ms == pytest.approx(1.025)
    assert "1.98x" in text
    calls.clear()
    assert chip_smoke.in_turns("new", None, 5, timer)[1:] == (None, "")


def test_large_path_cells_hold_each_cell_to_the_plain_version():
    import numpy as np

    cells, inputs, e64, e32 = chip_smoke.large_path_cells(
        torch.device("cpu"), [(33, 129, 5), (40, 10, 7)], (1, 2))
    assert [(c["nz"], c["nc"], c["K"]) for c in cells] == [
        (33, 129, 1), (33, 129, 2), (40, 10, 1), (40, 10, 2)]
    assert all(c["path"] == "large" and c["ms"] is None for c in cells)
    assert e64 <= 1e-9 and e32 == max(c["max_rel_err_f32"] for c in cells)
    assert cells[3]["bound_ms"] == pytest.approx(
        chip_smoke.leg_bound_ms(2, 40, 10, 7))
    assert inputs[(40, 10, 2)][2].shape == (2, 10, 40)
    # A general-path shape is refused: the function holds the large path.
    with pytest.raises(SystemExit):
        chip_smoke.large_path_cells(torch.device("cpu"), [(12, 40, 5)],
                                    (1,))
    assert np.isfinite(e64)


def test_general_stamped_source_puts_each_stamp_at_its_anchor():
    """The stamped copy for the general path's split: every anchor of
    K1_GENERAL_SPLIT_ANCHORS found in ipm_leg_mid, the stamps in order
    inside it, and no stamp in the large path."""
    from explicit_hybrid_mpc_tpu_torch import kernels

    with open(os.path.join(kernels.CSRC, "ipm_leg.cu")) as f:
        src = f.read()
    out = chip_smoke.stamped_source(src, chip_smoke.K1_GENERAL_SPLIT_ANCHORS,
                                    chip_smoke.K1_GENERAL_SPLIT_KERNEL)
    body = out[out.index(chip_smoke.K1_GENERAL_SPLIT_KERNEL):]
    order = [body.index(f"EHM_STAMP({n});") for n in range(6)]
    assert order == sorted(order)
    assert body.index("EHM_STAMP(it ? 7 : 6);") < order[0]
    assert body.rindex("EHM_STAMP(7);") > order[-1]
    large = out[out.index("ipm_leg_large(const T* __restrict__ Qg"):
                out.index(chip_smoke.K1_GENERAL_SPLIT_KERNEL)]
    assert "EHM_STAMP(" not in large
    assert len(chip_smoke.K1_GENERAL_SPLIT_SECTIONS) == 8


def test_stamped_source_puts_each_stamp_at_its_anchor():
    """The stamped copy of csrc/ipm_leg.cu: the stamp buffer and its
    readers, the clock at the large kernel's start, and one stamp before
    or after each anchored line of ipm_leg_large, in order; the other
    kernels untouched."""
    from explicit_hybrid_mpc_tpu_torch import kernels

    with open(os.path.join(kernels.CSRC, "ipm_leg.cu")) as f:
        src = f.read()
    out = chip_smoke.stamped_source(src, chip_smoke.K1_SPLIT_ANCHORS["new"])
    body = out[out.index("ipm_leg_large(const T* __restrict__ Qg"):]
    order = [body.index(f"EHM_STAMP({n});") for n in (0, 1, 2, 3, 4)]
    assert order == sorted(order)
    assert body.index("EHM_STAMP(it ? 5 : 6);") < order[0]
    assert body.index("long long ehm_last = clock64();") < body.index(
        "EHM_STAMP(it ? 5 : 6);")
    assert body.rindex("EHM_STAMP(5);") > order[-1]
    assert 'extern "C" int ehm_split_read' in out
    assert "__device__ unsigned long long ehm_split[8];" in out
    head = out[:out.index("ipm_leg_large(const T* __restrict__ Qg")]
    assert "EHM_STAMP(" not in head.split("#define EHM_STAMP(n)")[1]
    with pytest.raises(ValueError):
        chip_smoke.stamped_source(src, (("no such line", "x;", ""),))


@pytest.fixture(scope="module")
def small_pendulum():
    """A pendulum build with uncertified (depth-capped) leaves, the
    stand-in for phase 3's flagship result in the phase-18 rehearsals."""
    from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
    from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
        build_partition)
    from explicit_hybrid_mpc_tpu_torch.problems.registry import make

    problem = make("inverted_pendulum", N=2)
    cfg = PartitionConfig(problem="inverted_pendulum",
                          problem_args=(("N", 2),), eps_a=0.5,
                          backend="cpu", batch_simplices=8, max_depth=8)
    res = build_partition(problem, cfg)
    # Depth-capped leaves to bundle, and more steps than the health
    # monitor's default throughput window (50).
    assert res.stats["uncertified"] > 0 and res.stats["steps"] > 50
    return problem, cfg, res


def test_diagnostics_phase_a_b_c_rehearse_on_the_cpu(
        small_pendulum, tmp_path, monkeypatch, capsys):
    """Phase 18a (the forced divergence, at the tier-1 DI fixture), 18b
    (the recorded build with the health monitor) and 18c (the
    auto-profile trigger on injected stalls) on the CPU."""
    problem, cfg, res = small_pendulum
    monkeypatch.setattr(chip_smoke, "DIAG_PROBLEMS", (
        ("double_integrator", "double_integrator",
         {"N": 3, "theta_box": 1.5}, "register"),))
    dev = torch.device("cpu")
    forced = chip_smoke.forced_divergence(dev, str(tmp_path))
    build = chip_smoke.recorded_build(dev, problem, cfg, res, 1.0,
                                      str(tmp_path))
    auto = chip_smoke.auto_profile_trigger(dev, str(tmp_path))
    log = capsys.readouterr().out
    assert "FAIL" not in log
    for tag in ("replay conv 0 / feas 0 mismatches, V bitwise True",
                "tree equal to phase 3's cell for cell",
                "capture errors 0", "health.throughput_low (warn",
                "snapshot never certifies", "1 profile.capture"):
        assert tag in log, tag
    assert forced["double_integrator"]["captured"] > 0
    assert 0 < build["bundles"] <= 16
    assert auto["captures"] == 1


def test_diagnostics_phase_d_e_f_rehearse_on_the_cpu(
        small_pendulum, tmp_path, monkeypatch, capsys):
    """Phase 18d (the warm rebuild with the recorder; here at a tighter
    eps than the prior's, so leaves are invalidated), 18e (two builds
    in two processes, one obs path) and 18f (the serving stream through
    the monitor) on the CPU."""
    import dataclasses

    from explicit_hybrid_mpc_tpu_torch.partition.rebuild import warm_rebuild

    problem, cfg, res = small_pendulum
    tight = dataclasses.replace(cfg, eps_a=0.4)
    ref = warm_rebuild(problem, tight, res.tree).stats
    assert ref["rebuild_leaves_invalidated"] > 0
    monkeypatch.setattr(chip_smoke, "REBUILD_REF_REGIONS", ref["regions"])
    monkeypatch.setattr(chip_smoke, "DIAG_SERVE_REQUESTS", 512)
    dev = torch.device("cpu")
    reb = chip_smoke.recorded_rebuild(dev, tight, res, str(tmp_path))
    fl = chip_smoke.fleet_streams(dev, str(tmp_path))
    chip_smoke.serving_health(dev, res, str(tmp_path))
    log = capsys.readouterr().out
    assert "FAIL" not in log
    assert reb["recert"] > 0 and fl["streams"] == 2
    for tag in ("every invalidation verdict reproduced",
                "strict issues []", "[diag] 18e straggler_report",
                "['health.serve_p99_us']", "p99): [], exit code 0"):
        assert tag in log, tag


# -- phase 19: the SLO engine and demand telemetry ---------------------------


def _counting_plain_leg(monkeypatch):
    """The plain leg counted as a K1 launch (the CPU stands in for the
    card: the phase counts the hub's re-solves through ipm_leg.launches)."""
    from explicit_hybrid_mpc_tpu_torch.oracle import ipm_leg

    real = ipm_leg.ipm_leg_torch

    def counted(*a, **kw):
        ipm_leg.launches += 1
        return real(*a, **kw)
    monkeypatch.setattr(ipm_leg, "ipm_leg_torch", counted)


def _phase19_setup(small_pendulum, monkeypatch):
    """Phase 19 at a small size: phase 15's references from the port's
    CPU rebuilds of the small pendulum (the prior's eps 0.5, tightened to
    0.4); the suboptimality bar at 2.0, above the gaps of the rows this
    depth-capped build serves from its uncertified leaves (about 1.4)."""
    import dataclasses

    from explicit_hybrid_mpc_tpu_torch.online import export
    from explicit_hybrid_mpc_tpu_torch.oracle import ipm_leg
    from explicit_hybrid_mpc_tpu_torch.partition.rebuild import warm_rebuild

    problem, cfg, res = small_pendulum
    with monkeypatch.context() as m:
        _counting_plain_leg(m)
        ipm_leg.launches = 0
        tight = warm_rebuild(problem, dataclasses.replace(cfg, eps_a=0.4),
                             res.tree).stats
        k1_tight = ipm_leg.launches
    for k, v in dict(SD_SELFTEST=256, SD_REQUESTS=400, CLIENTS=4,
                     MAX_BATCH=64, SD_SUBOPT_FRAC=0.25,
                     SD_SUBOPT_EPS=2.0, REBUILD_TIGHT_EPS=0.4).items():
        monkeypatch.setattr(chip_smoke, k, v)
    refs = {"unchanged": {"regions": res.stats["regions"],
                          "k1_launches": 0, "k1_ms": None},
            "tight": {"regions": tight["regions"], "k1_launches": k1_tight}}
    return problem, cfg, res, export.export_leaves(res.tree), refs


def test_slo_demand_phase_rehearses_on_the_cpu(small_pendulum, tmp_path,
                                               monkeypatch, capsys):
    """Phase 19 (19a-19e) on the CPU from the small pendulum build, the
    hub's re-solves through the plain leg counted as K1 launches."""
    problem, cfg, res, table, refs = _phase19_setup(small_pendulum,
                                                    monkeypatch)
    _counting_plain_leg(monkeypatch)
    out = chip_smoke.slo_demand_phase(torch.device("cpu"), problem, cfg,
                                      res, table, str(tmp_path), refs)
    log = capsys.readouterr().out
    assert "FAIL" not in log
    for tag in ("[demand] 19a: answers with --demand on bitwise those with "
                "it off on 256 of 256", "rows", "19b run 3 capture off",
                "p99 ratio", "torn reads 0", "for 4 of 4 tenants",
                "demand.error events 0", "max relative difference",
                "health.subopt events at eps 2: 0",
                "a HealthMonitor(max_subopt=",
                "lifecycle.demand_priority events 2 ([(1, ",
                "the hinted tree node for node the unhinted one: True",
                "evaluate() bitwise True", "bitwise True; fleet.slo_rollup",
                "the exact sum of their unit counters True",
                "1 fast health.slo_burn (['critical'])",
                "one-interval spike: 0", "[demand] phase 19 took"):
        assert tag in log, tag
    assert out["ipm_leg"]["subopt_launches"] > 0
    assert out["arena_eval"]["capture_launches"] == 0   # plain on the CPU


@pytest.mark.parametrize("fault", ["demand_error", "no_k1"])
def test_slo_demand_phase_fails_on_a_hidden_device_fault(
        fault, small_pendulum, tmp_path, monkeypatch):
    """19c fails when the hub's maintenance thread swallowed an error
    (a demand.error event) and when its re-solves launched no K1."""
    from explicit_hybrid_mpc_tpu_torch.obs import demand

    problem, _cfg, res, table, _refs = _phase19_setup(small_pendulum,
                                                      monkeypatch)
    arena = chip_smoke.demand_arena(torch.device("cpu"), res, table,
                                    str(tmp_path))
    if fault == "demand_error":
        _counting_plain_leg(monkeypatch)
        real = demand.DemandHub._drain_subopt
        calls = [0]

        def drain(self):
            calls[0] += 1
            if calls[0] == 1:
                self._obs.event("demand.error",
                                msg="RuntimeError('injected')")
            return real(self)
        monkeypatch.setattr(demand.DemandHub, "_drain_subopt", drain)
    with pytest.raises(SystemExit):
        chip_smoke.online_subopt(torch.device("cpu"), problem, res, table,
                                 arena["tenant_arenas"])


def test_serve_phases_rehearse_on_the_cpu(small_pendulum, tmp_path,
                                          monkeypatch, capsys):
    """Phases 6-8 on the CPU from the small pendulum's table: the arena
    kernel's wrapper and its raw launch stand in as counted plain calls,
    the device timers and the profiler as stubs; the serving run's swap,
    fallback reconciliation and torn-read audit run as on the card."""
    from explicit_hybrid_mpc_tpu_torch.online import export, fused

    _problem, _cfg, res = small_pendulum
    plain = fused.arena_eval_torch

    def counted(bary, U, V, q, ext, plan=None, scratch=None):
        fused.launches += 1
        return plain(bary, U, V, q, ext)

    def raw_k3(lib, arena, buf, B, chunks, parent):
        q, e, _tiles = fused.split_queries(buf, B, arena.p + 1)
        return (lambda: None), plain(arena.bary, arena.U, arena.V, q, e)

    class Props:
        multi_processor_count = 132

    class NoProfile:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            return []

    for mod, k, v in ((fused, "arena_eval", counted),
                      (fused, "arena_eval_cuda", counted),
                      (fused, "_lib", lambda: None),
                      (chip_smoke, "raw_k3", raw_k3),
                      (chip_smoke, "graph_time", lambda fn, reps: 0.01),
                      (chip_smoke, "cuda_time",
                       lambda fn, reps, warmup=2: 0.01),
                      (chip_smoke, "K3_SWEEP_B", (1, 16, 64)),
                      (chip_smoke, "REQUESTS", 400),
                      (chip_smoke, "PROFILED_REQUESTS", 100),
                      (chip_smoke, "CLIENTS", 4),
                      (torch.cuda, "synchronize", lambda *a: None),
                      (torch.cuda, "get_device_properties",
                       lambda d: Props),
                      (torch.profiler, "profile", lambda **kw: NoProfile())):
        monkeypatch.setattr(mod, k, v)
    import numpy as np

    entry = chip_smoke.serve_phases(
        torch.device("cpu"), res, export.export_leaves(res.tree),
        np.random.default_rng(0), str(tmp_path))
    log = capsys.readouterr().out
    assert "FAIL" not in log
    for tag in ("[arena] 4 tenants x", "[K3] B=64", "[serve] 400 requests "
                "from 4 closed-loop clients", "torn reads 0 of",
                "(reconciled with account_kernel)", "[batches]",
                "K3's device time while serving: not measured"):
        assert tag in log, tag
    assert entry["name"] == "arena_eval" and entry["launches"] > 0


# -- phase 20: multi-GPU --------------------------------------------------------


def _di_fixture():
    """The tier-1 DI fixture (phase 20c's) and its CPU build, standing in
    for phase 3's flagship in the phase-20 rehearsals."""
    from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
    from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
        build_partition)
    from explicit_hybrid_mpc_tpu_torch.problems.registry import make

    problem = make("double_integrator", N=3, theta_box=1.5)
    cfg = PartitionConfig(problem="double_integrator",
                          problem_args=(("N", 3), ("theta_box", 1.5)),
                          eps_a=0.5, backend="cpu", batch_simplices=32,
                          max_depth=20)
    return problem, cfg, build_partition(problem, cfg)


def test_multi_gpu_phase_rehearses_on_the_cpu(tmp_path, monkeypatch, capsys):
    """Phase 20 on the CPU: 20a's mesh shapes on CPU entries (the plain
    leg counted as K1: one launch a block; the DI's one commutation
    padded on the delta axis), 20b's launcher builds and 20c's lockstep
    ranks on the DI fixture (the fixture standing in for the flagship
    too)."""
    problem, cfg, res = _di_fixture()
    monkeypatch.setattr(chip_smoke, "MESH_THETAS", 16)
    monkeypatch.setattr(chip_smoke, "MESH_REPS", 1)
    _plain_leg_as_kernel(monkeypatch)
    out = chip_smoke.multi_gpu_phase(torch.device("cpu"), problem, cfg, res,
                                     1.0, str(tmp_path))
    log = capsys.readouterr().out
    assert "FAIL" not in log
    for tag in ("[mesh] 20a (2, 2) on cpu repeated", "d*, conv, feas equal",
                "equal to the dense Oracle's", "20b di: main --shard-frontier",
                "20b flagship: main --shard-frontier",
                "solved by both shards 0",
                "canonical comparison with the single-process tree: "
                "identical", "[lockstep] 20c 2 ranks (gloo) on cpu",
                "owners [True, False], checkpoints written [True, False], "
                "tree written True", "[multi] phase 20 took",
                "[mesh] 20a batch split", "bitwise [True]",
                "single process without speculation (--no-speculate)",
                "against the single process without speculation: point "
                "solves sharded 79 (summed), single process 79 "
                "(difference +0)"):
        assert tag in log, tag
    assert out["mesh_launches"] == {"1x1": 1, "2x1": 2, "1x2": 2, "2x2": 4}
    assert out["sharded_identical"] and out["sharded_differing_cells"] == 0


def test_a_sharded_build_that_solves_a_cell_twice_fails_20b(
        tmp_path, monkeypatch):
    """20b's zero-duplicate check: a shard set whose recorded cells
    overlap fails the phase."""
    problem, cfg, res = _di_fixture()
    real = chip_smoke.sharded_run

    def doubled(*a, **kw):
        r = real(*a, **kw)
        r["both"] = 1
        return r
    monkeypatch.setattr(chip_smoke, "sharded_run", doubled)
    with pytest.raises(SystemExit):
        chip_smoke.sharded_build_phase(torch.device("cpu"), problem, cfg,
                                       res, 1.0, str(tmp_path))


def _probe_inputs():
    """A small pendulum's dense-grid oracle (no cohort, no warm starts,
    as under a mesh) and 8 seeded points: batch_split_probe's inputs."""
    import numpy as np

    from explicit_hybrid_mpc_tpu_torch.oracle import oracle
    from explicit_hybrid_mpc_tpu_torch.problems.registry import make

    problem = make("inverted_pendulum", N=2)
    ora = oracle.Oracle(problem, backend="cpu", two_phase=False,
                        warm_start=False)
    th = np.random.default_rng(0).uniform(problem.theta_lb,
                                          problem.theta_ub,
                                          (8, problem.n_theta))
    return ora, torch.as_tensor(th), 8 * problem.canonical.n_delta


@pytest.mark.parametrize("where", ["none", "setup", "leg"])
def test_batch_split_probe_names_the_op_that_follows_the_batch(
        where, monkeypatch):
    """20a's batch split on the CPU: the plain grid is batch independent
    op for op; an op made to round by its batch's size is named as the
    first whose inputs agree and output does not (the point QPs' matvec
    here), and a leg made so fails the relaunch on its first half."""
    from explicit_hybrid_mpc_tpu_torch.oracle import ipm_leg, oracle

    ora, th, K = _probe_inputs()
    if where == "setup":
        real = oracle._bmv
        monkeypatch.setattr(oracle, "_bmv", lambda M, v: real(M, v) * (
            1.0 + 2.0 ** -40 * (M.shape[0] == K)))
    if where == "leg":
        real_leg = ipm_leg.ipm_leg

        def leg(*a, n_iter):
            z, s, lam = real_leg(*a, n_iter=n_iter)
            return z * (1.0 + 2.0 ** -40 * (z.shape[0] == K)), s, lam
        monkeypatch.setattr(ipm_leg, "ipm_leg", leg)
    pr = chip_smoke.batch_split_probe(ora, th)
    assert pr["misaligned"] is None and pr["n_ops"] > 0
    assert pr["k1_legs"] == 1
    assert pr["k1_bitwise"] == [where != "leg"]
    if where == "none":
        assert pr["ops_differing"] == 0 and pr["first_op"] is None
        assert pr["first_read"] is None
        assert set(pr["converged_diff"].values()) == {0.0}
    else:
        assert pr["first_op"][1] == "aten.mul.Tensor"
        assert pr["first_read"][0] == pr["first_op"][0] + 1
        assert pr["ops_differing"] > 0


def test_solve_accounting_splits_the_difference_of_two_counts(
        monkeypatch, capsys):
    """20b's cell-by-cell accounting: the difference of the summed counts
    is the cells only one build solved plus the difference of the
    repeats; a single build whose recorded cells are not its point
    solves fails the phase."""
    import numpy as np

    single = np.array([1, 2, 3, 3, 4, 9], dtype=np.uint64)
    sharded = {"cell_arrays": [np.array([1, 2, 2, 5], dtype=np.uint64),
                               np.array([3, 4, 6, 6, 6], dtype=np.uint64)]}
    acc = chip_smoke.solve_accounting("t", {"point_solves": 6}, single,
                                      sharded)
    assert acc == {"single": 6, "sharded": 9, "only_single": 1,
                   "only_sharded": 2, "single_repeats": 1,
                   "sharded_repeats": 3}
    assert (acc["sharded"] - acc["single"]
            == acc["only_sharded"] - acc["only_single"]
            + acc["sharded_repeats"] - acc["single_repeats"])
    assert "difference +3" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        chip_smoke.solve_accounting("t", {"point_solves": 7}, single,
                                    sharded)


# -- phase 21: the analysis package -----------------------------------------------


def test_analysis_phase_rehearses_on_the_cpu(tmp_path, monkeypatch, capsys):
    """Phase 21 on the CPU, the plain leg counted as K1: 21a with the small
    pendulum standing in for the flagship (cold under warn: the guard
    fires after its warmup, as the JAX package's does; warmed under
    raise: 0 violations; both phase 3's tree and K1 launches), 21b's
    forced dispatch on the DI fixture (one event, monitor warn, the
    unguarded tree; raise out of step(); `main` in its own process
    exits non-zero), 21c's loader watch (no library loads on the
    CPU)."""
    from explicit_hybrid_mpc_tpu_torch import kernels
    from explicit_hybrid_mpc_tpu_torch.analysis.recompile_guard import (
        RecompileGuard)
    from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
    from explicit_hybrid_mpc_tpu_torch.oracle import ipm_leg
    from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
        build_partition)
    from explicit_hybrid_mpc_tpu_torch.problems.registry import make

    _plain_leg_as_kernel(monkeypatch)
    monkeypatch.setattr(chip_smoke, "GUARD_FLAGSHIP", [
        "-e", "inverted_pendulum", "--problem-arg", "N=2", "-a", "0.5",
        "--batch", "16", "--max-depth", "14", "--no-speculate"])
    ipm_leg.launches = 0
    res = build_partition(make("inverted_pendulum", N=2), PartitionConfig(
        problem="inverted_pendulum", problem_args=(("N", 2),), eps_a=0.5,
        backend="cpu", batch_simplices=16, max_depth=14, speculate=False))
    n_k1 = ipm_leg.launches
    loader_guard = RecompileGuard(watch=[kernels.loader])
    out = chip_smoke.analysis_phase(torch.device("cpu"), res, n_k1,
                                    "a card, 700 W", str(tmp_path),
                                    loader_guard)
    log = capsys.readouterr().out
    assert "FAIL" not in log
    for tag in ("--recompile-guard warn (cold oracle): exit 0",
                "step 15 pairs[16]", "--recompile-guard raise (oracle "
                "warmed at", "0 violations (0 health.recompile events)",
                f"K1 launches {n_k1} (phase 3, with speculation: {n_k1}); "
                "tree equal to phase 3's cell for cell",
                f"K1 launches {n_k1} (unguarded: {n_k1}); tree equal to "
                "phase 3's cell for cell", "1 health.recompile event(s)",
                "health monitor worst warn; tree equal to the unguarded",
                "RecompileError out of step()", "with the forced dispatch, "
                "in its own process: exit 1", "growth 0, libraries loaded []",
                "the guard armed after phase 3 sees 0", "a card, 700 W"):
        assert tag in log, tag
    assert out["guarded_launches"] == out["guard_unguarded_launches"] \
        == n_k1
    assert out["guard_violations_cold"] >= 1
    assert out["forced_k1_launches"] >= 1 and out["loader_growth"] == 0


def test_a_guarded_flagship_that_mints_a_shape_fails_21a(tmp_path,
                                                          monkeypatch,
                                                          capsys):
    """21a fails (and names the shape) when the warmed build still mints
    one after the arm: here the warmup skips the pair buckets."""
    from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
    from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
        build_partition)
    from explicit_hybrid_mpc_tpu_torch.problems.registry import make

    monkeypatch.setattr(chip_smoke, "GUARD_FLAGSHIP", [
        "-e", "inverted_pendulum", "--problem-arg", "N=2", "-a", "0.5",
        "--batch", "16", "--max-depth", "14", "--no-speculate"])
    real = chip_smoke.warm_buckets

    def partial_warm(oracle, problem):
        oracle.max_pairs_per_call, cap = 4, oracle.max_pairs_per_call
        try:
            return real(oracle, problem)
        finally:
            oracle.max_pairs_per_call = cap
    monkeypatch.setattr(chip_smoke, "warm_buckets", partial_warm)
    res = build_partition(make("inverted_pendulum", N=2), PartitionConfig(
        problem="inverted_pendulum", problem_args=(("N", 2),), eps_a=0.5,
        backend="cpu", batch_simplices=16, max_depth=14))
    monkeypatch.setattr(chip_smoke, "GUARD_MODES", ("raise",))
    with pytest.raises(SystemExit):
        chip_smoke.guarded_flagship(torch.device("cpu"), res, 0, "card",
                                    str(tmp_path))
    log = capsys.readouterr().out
    assert "chip_smoke: FAIL: 21a (raise): the guarded flagship build " \
        "raised RecompileError" in log and "pairs[" in log, log


def test_robustness_phase_rehearses_on_the_cpu(tmp_path, monkeypatch,
                                               capsys):
    """Phase 22 on the CPU, the DI fixture only, the plain leg counted as
    K1: 22a the chaos suite's five schedules with the CPU's verdicts (the
    JAX package's), each child through counted_cli; 22b the fixture
    standing in for the flagship under the supervisor (checkpoints every
    2 steps, killed at the 2nd write, resumed from .prev): the fixture's
    tree cell for cell; 22c the drift smoke in this process."""
    from explicit_hybrid_mpc_tpu_torch.tools import chaos_suite

    problem, cfg, res = _di_fixture()
    _plain_leg_as_kernel(monkeypatch)
    monkeypatch.setattr(chip_smoke, "CHAOS_EPS", 0.5)
    monkeypatch.setattr(chip_smoke, "DRIFT_EPS", 0.5)
    monkeypatch.setattr(chip_smoke, "ROBUST_FLAGSHIP", [
        "-e", "double_integrator", "--problem-arg", "N=3", "--problem-arg",
        "theta_box=1.5", "-a", "0.5", "--batch", "32", "--max-depth", "20"])
    monkeypatch.setattr(chip_smoke, "ROBUST_CKPT_EVERY", 2)
    out = chip_smoke.robustness_phase(torch.device("cpu"), res, 0,
                                      str(tmp_path))
    log = capsys.readouterr().out
    assert "FAIL" not in log
    for tag in ("[chaos] 22a tools/chaos_suite on cpu (eps 0.5",
                "reference build exit 0", "kill_mid_checkpoint: ok",
                "sharded_device_failure: ok", "[chaos] 22a took",
                "crash at checkpoint write 2", "exit 43 in",
                "resumed from 22b.ckpt.pkl.prev", "tree equal to phase 3's "
                "cell for cell", "[drift] 22c tools/drift_smoke on cpu",
                "0 dropped, 0 torn", "[robust] phase 22 took"):
        assert tag in log, tag
    for name in chaos_suite.SCHEDULES:
        assert out[f"chaos_{name}"]["verdict"] == "ok", name
    # The reference and each finished build left their K1 count (0: the
    # children run the plain leg, which launches no kernel).
    assert out["chaos_device_failure"]["k1_launches"] == [0]
    assert out["resumed_identical"] and out["resumed_differing_cells"] == 0
    assert out["resumed_regions"] == res.stats["regions"]
    assert out["drift_launches"] > 0
    assert out["drift_staleness_p99_s"] is not None


def test_a_failed_chaos_schedule_fails_22a(tmp_path, monkeypatch, capsys):
    from explicit_hybrid_mpc_tpu_torch.tools import chaos_suite

    def failed(wd, *a, **kw):
        return {"reference": {"rc": 0}, "schedules": {
            n: {"ok": n != "solve_timeout", "wall_s": 1.0}
            for n in chaos_suite.SCHEDULES},
            "failures": ["solve_timeout: the process exited 9.1 s after "
                         "the fault"]}
    monkeypatch.setattr(chaos_suite, "run_suite", failed)
    with pytest.raises(SystemExit):
        chip_smoke.chaos_phase(torch.device("cpu"), str(tmp_path))
    log = capsys.readouterr().out
    assert "solve_timeout: FAILED" in log
    assert "chip_smoke: FAIL: 22a: solve_timeout: the process exited" in log


def test_operator_tools_phase_rehearses_on_the_cpu(tmp_path, monkeypatch,
                                                   capsys):
    """Phase 23 on the CPU at eps 0.5: 23a the fleet smoke's restart
    chain and sharded build, every child through counted_cli (the
    crashed process too); 23b the watcher following a live build to 0
    and a stopped one to 2 with health.stall; 23c the report over both
    streams and the fleet folds; 23d preflight with --quick."""
    monkeypatch.setattr(chip_smoke, "FLEET_EPS", 0.5)
    monkeypatch.setattr(chip_smoke, "PREFLIGHT_ARGV",
                        ["--only", "lint,drift_smoke", "--quick"])
    out = chip_smoke.operator_tools_phase(torch.device("cpu"),
                                          str(tmp_path))
    log = capsys.readouterr().out
    assert "FAIL" not in log
    for tag in ("[operator] 23a tools/fleet_smoke chain on cpu (eps 0.5",
                "[operator] 23a tools/fleet_smoke sharded on cpu",
                "obs_report --fleet --strict exit 0",
                "23b obs_watch following a live build on cpu: exit 0",
                "over the build stopped after its first build.step: exit 2",
                "'health.stall'", "23c obs_report 23b live: exit 0",
                "bench None", "23c obs_report --fleet --strict over 23a's "
                "sharded streams: exit 0, 2 streams",
                "23d tools/preflight --only lint,drift_smoke --quick on cpu:"
                " exit 0, ok True", "[operator] phase 23 took"):
        assert tag in log, tag
    # Three processes a mode, the crashed one of the chain included; the
    # children run the plain leg, which launches no kernel.
    assert out["fleet_chain_k1_launches"] == {"straight": [0],
                                              "fleet": [0, 0]}
    assert out["fleet_sharded_k1_launches"] == {"straight": [0],
                                                "sharded": [0, 0]}
    assert set(out["watch_k1_launches"]) == {"23b_live", "23b_stopped"}
    assert out["report_live_regions"] == out["report_reference_regions"] \
        == 122
    assert set(out["preflight_walls_s"]) == {"lint", "drift_smoke"}


def test_capture_tools_phase_rehearses_on_the_cpu(tmp_path, monkeypatch,
                                                  capsys):
    """Phase 24 on the CPU at the tools' smoke knobs: 24b tune_schedule,
    24c onset_probe (satellite_z at 0.5) and 24d long_build on the DI
    fixture (the first process SIGKILLed after its 2nd progress row, the
    second resumed to drain), then 24a precision_check against its
    reference run (both on the CPU here), every child through
    counted_tool, whose K1 records count the plain leg by path and dtype;
    24a's acceptance step at the real 5b and 4c sub-boxes (2 thetas) with
    the plain leg counted as K1, at the large and the general path in
    both dtypes."""
    _plain_leg_as_kernel(monkeypatch)
    monkeypatch.setattr(chip_smoke, "PREC_ENV", {
        "PREC_PROBLEM": "double_integrator", "PREC_EPS": "0.5",
        "PREC_POINTS": "32", "PREC_SOUND_SAMPLES": "64"})
    monkeypatch.setattr(chip_smoke, "PREC_JAX_BUILDS",
                        {"mixed": (1566, 3130), "f64": (1566, 3130)})
    monkeypatch.setattr(chip_smoke, "PREC_SUBBOX_POINTS", 2)
    monkeypatch.setattr(chip_smoke, "TUNE_ENV", {
        "TUNE_POINTS": "16", "TUNE_EPS": "0.5",
        "TUNE_PROBLEM": "double_integrator"})
    monkeypatch.setattr(chip_smoke, "ONSET_ENV", {
        "ONSET_FAMILIES": "satellite_z", "ONSET_SCALES": "0.5"})
    monkeypatch.setattr(chip_smoke, "ONSET_JAX_REGIONS",
                        {"satellite_z": ((12, 12),)})
    monkeypatch.setattr(chip_smoke, "LONG_ENV", {
        "LONG_PROBLEM": "double_integrator",
        "LONG_PROBLEM_ARGS": '{"N": 3, "theta_box": 1.5}',
        "LONG_EPS": "0.2", "LONG_CKPT_EVERY": "4", "LONG_BATCH": "64"})
    monkeypatch.setattr(chip_smoke, "LONG_REF", (392, 0))
    cpu = torch.device("cpu")
    out = chip_smoke.capture_tools_phase(
        cpu, str(tmp_path), chip_smoke.precision_reference(cpu,
                                                           str(tmp_path)))
    log = capsys.readouterr().out
    assert "FAIL" not in log
    for tag in ("[capture] 24b tune_schedule (double_integrator, 16 points)"
                " on cpu", "fastest_parity_ok True",
                "[capture] 24c satellite_z scale 0.5: 12 regions (JAX 12)",
                "the first process SIGKILLed after 2 progress rows (steps "
                "[4, 8])", "resumed from step 8 to drained",
                "progress steps [4, 8, 12, 16]",
                "24a precision_check (double_integrator, 32 instances) on "
                "device (cpu)", "on cpu (cpu)", "regions_equal True, "
                "eps_sound True", "24a acceptance step at 5b (quadrotor",
                "24a acceptance step at 4c (satellite",
                "[capture] phase 24 took"):
        assert tag in log, tag
    for key in ("tune_k1", "onset_k1", "prec_k1"):
        assert {"plain:register:float32", "plain:register:float64"} \
            <= set(out[key]), key
    first, second = out["long_k1"]
    assert first["plain:register:float32"]["launches"] > 0
    assert second["plain:register:float64"]["launches"] > 0
    for tag, path in (("5b", "large"), ("4c", "general")):
        k1 = out[f"prec_{tag}"]["k1"]
        for dtype in ("float32", "float64"):
            assert k1[f"cuda:{path}:{dtype}"]["launches"] > 0, (tag, dtype)
        assert out[f"prec_{tag}"]["accept"] \
            == out[f"prec_{tag}"]["accept_cpu"]
    assert out["prec_verdict"] == [True, True, 0]
    assert out["long_regions"] == 392 and out["long_resumed_from_step"] == 8
    assert len(out["tune_rows"]) == 7 and out["onset_cut"] == []


def test_a_differing_precision_verdict_fails_24a(tmp_path, monkeypatch,
                                                 capsys):
    """24a fails where the device's verdict is not the CPU's: here the
    reference run's JSON says its builds differ."""
    from explicit_hybrid_mpc_tpu_torch.tools import precision_check

    monkeypatch.setattr(chip_smoke, "PREC_ENV", {
        "PREC_PROBLEM": "double_integrator", "PREC_EPS": "0.5",
        "PREC_POINTS": "8", "PREC_SOUND_SAMPLES": "8"})
    monkeypatch.setattr(chip_smoke, "PREC_SUBBOXES", ())
    real = chip_smoke._read_json

    def read(path):
        res = real(path)
        if res is not None and path.endswith("24a_cpu.json"):
            res["mixed_vs_f64_regions_equal"] = False
        return res
    monkeypatch.setattr(chip_smoke, "_read_json", read)
    ref = chip_smoke.precision_reference(torch.device("cpu"), str(tmp_path))
    with pytest.raises(SystemExit):
        chip_smoke.precision_phase(torch.device("cpu"), str(tmp_path), ref)
    assert "chip_smoke: FAIL: 24a: the verdict on cpu (True, True, 0) is " \
        "not the CPU's (False, True, 0)" in capsys.readouterr().out
    assert precision_check.verdict({"mixed_eps_sound": True}) == 0


def test_counted_tool_writes_its_count_on_sigusr1(tmp_path):
    """A counted_tool child (long_build on the DI fixture) answers
    SIGUSR1 with a partial record (launches only) and writes its final
    record when it returns."""
    import json
    import signal
    import time

    env = {"LONG_PROBLEM": "double_integrator",
           "LONG_PROBLEM_ARGS": '{"N": 3, "theta_box": 1.5}',
           "LONG_EPS": "0.5", "LONG_CKPT_EVERY": "2", "LONG_BATCH": "32"}
    out = tmp_path / "lb.json"
    proc = chip_smoke._tool_child(
        torch.device("cpu"), "long_build",
        ["--out", str(out), "--sentinel", str(tmp_path / "s")], env,
        str(tmp_path), "lb")
    while not (chip_smoke._read_json(str(out)) or {}).get("progress") \
            and proc.poll() is None:
        time.sleep(0.02)
    proc.send_signal(signal.SIGUSR1)
    assert proc.wait(300) == 0
    recs = chip_smoke._tool_k1(str(tmp_path), proc.pid)
    assert [r["partial"] for r in recs] == [True, False]
    assert all(v["ms"] is None for v in recs[0]["k1_by"].values())
    assert recs[1]["rc"] == 0 and recs[1]["tool"] == "long_build"
    assert recs[1]["k1_by"]["plain:register:float64"]["launches"] \
        >= recs[0]["k1_by"]["plain:register:float64"]["launches"] > 0
    assert recs[1]["k1"] == 0 and recs[1]["k1_ms"] is None
    assert json.loads(json.dumps(recs[1]))["builds"] == []


def test_a_counted_cli_child_writes_its_record_on_sigterm(tmp_path):
    """counted_cli writes the same record as counted_tool: a `main` child
    on the DI fixture, terminated after its first checkpoint, ends with
    exit 143 and one record (rc 143, its argv, K1 by route, path and
    dtype); a child that returns writes one with rc 0."""
    import signal
    import time

    log = tmp_path / "k1.jsonl"
    env = dict(os.environ, K1_LOG=str(log))
    env["PYTHONPATH"] = chip_smoke._root()
    runs = {}
    for name, stop in (("stopped", True), ("done", False)):
        prefix = str(tmp_path / name)
        argv = ["-e", "double_integrator", "--problem-arg", "N=3",
                "--problem-arg", "theta_box=1.5", "-a", "0.2", "--batch",
                "8", "--backend", "cpu", "--checkpoint-every", "2", "-o",
                prefix]
        proc = subprocess.Popen([sys.executable, "-c",
                                 chip_smoke._CHAOS_MAIN] + argv,
                                cwd=chip_smoke._root(), env=env,
                                stdout=subprocess.DEVNULL,
                                stderr=subprocess.DEVNULL)
        if stop:
            while not os.path.exists(prefix + ".ckpt.pkl") \
                    and proc.poll() is None:
                time.sleep(0.02)
            proc.send_signal(signal.SIGTERM)
        runs[name] = (proc.wait(300), proc.pid)
    assert runs["stopped"][0] == 143 and runs["done"][0] == 0
    for name, (rc, pid) in runs.items():
        (rec,) = chip_smoke.k1_records(str(log), pid=pid)
        assert rec["rc"] == rc and not rec["partial"]
        assert chip_smoke._output_of(rec["argv"]) == str(tmp_path / name)
        assert rec["k1"] == 0 and rec["k1_ms"] is None
        assert rec["k1_by"]["plain:register:float64"]["launches"] > 0


@pytest.fixture(scope="module")
def f32_joint_legs():
    """The plain float32 leg on 64 of the flagship's elastic joint QPs
    (their inputs as qp_solve hands them to the leg on the CPU) after
    F32_SHORT_ITERS and F32_ITERS iterations, as 24a's f32_leg_verdict
    takes them: here the plain leg on the CPU is both the plain version
    and the CPU witness, beside the witness on inputs one ulp moved and a
    stand-in kernel (the plain leg on inputs moved by another seed)."""
    import numpy as np

    from explicit_hybrid_mpc_tpu_torch.problems.registry import make

    args = chip_smoke.f32_leg_inputs(
        make("inverted_pendulum"), "joint",
        np.random.default_rng(chip_smoke.SEED + 24), torch.device("cpu"),
        64)
    legs = {}
    for n in (chip_smoke.F32_SHORT_ITERS, chip_smoke.F32_ITERS):
        plain = chip_smoke.plain_leg(args, n)
        legs[n] = {"plain": plain, "plain_cpu": plain,
                   "plain_ulp": chip_smoke.plain_leg(
                       chip_smoke.ulp_moved(args, chip_smoke.F32_ULP_SEED),
                       n),
                   "kernel": chip_smoke.plain_leg(
                       chip_smoke.ulp_moved(args, 7), n)}
    legs[chip_smoke.F32_ITERS]["f64"] = chip_smoke.plain_leg(
        tuple(t.double() for t in args), chip_smoke.F32_ITERS)
    return legs


def _nan_rows(leg, rows):
    out = tuple(t.clone() for t in leg)
    out[2][rows] = float("nan")
    return out


def _scaled_row(leg, row, by):
    out = tuple(t.clone() for t in leg)
    out[2][row] *= by
    return out


@pytest.mark.parametrize("fault,message", [
    (None, None),
    ("unfinished", "iteration the kernel leaves 1 rows unfinished"),
    ("one row off", "iteration the kernel is "),
    ("rows swapped", "rows lie more than 0.001 from the plain version"),
    ("finite rows lost", "iterations finite rows"),
    ("far from float64", "from the float64 iterates, the plain version 0"),
])
def test_f32_leg_verdict_holds_the_kernel_to_the_witnesses(
        f32_joint_legs, capsys, fault, message):
    """24a's hold on K1's float32 leg: a kernel whose rows move as the
    plain leg's own do under one ulp passes; a row left unfinished or 1%
    off after one iteration, rows swapped or finite rows lost after
    F32_ITERS, or rows apart from float64 iterates that the plain leg
    meets, fail it, each named."""
    short = dict(f32_joint_legs[chip_smoke.F32_SHORT_ITERS])
    long = dict(f32_joint_legs[chip_smoke.F32_ITERS])
    if fault == "unfinished":
        short["kernel"] = _nan_rows(short["kernel"], [3])
    elif fault == "one row off":
        short["kernel"] = _scaled_row(short["kernel"], 5, 1.01)
    elif fault == "rows swapped":
        long["kernel"] = tuple(t.roll(1, 0) for t in long["kernel"])
    elif fault == "finite rows lost":
        long["kernel"] = _nan_rows(long["kernel"], list(range(20)))
    elif fault == "far from float64":
        long["f64"] = long["plain"]
    if fault is None:
        v = chip_smoke.f32_leg_verdict("joint", short, long)
        assert v["short"]["lost"] == 0
        assert v["short"]["max_gap"]["kernel"] <= v["short_limit"]
        assert 0 < v["long"]["apart"]["plain_ulp"]
        assert v["long"]["apart"]["kernel"] <= v["apart_limit"]
        assert v["long"]["apart"]["plain_cpu"] == 0
        assert v["long"]["to_f64"]["kernel"] <= v["f64_limit"]
        return
    with pytest.raises(SystemExit):
        chip_smoke.f32_leg_verdict("joint", short, long)
    out = capsys.readouterr().out
    assert "chip_smoke: FAIL: 24a K1 float32 leg joint: after" in out
    assert message in out, out


#: Phase 25's modes at small sizes on the DI problem (its drift walk on
#: the pendulum's small box, 3 revisions; its multichip mode at eps 0.5).
_BENCH_SMALL = {"BENCH_PROBLEM": "double_integrator", "BENCH_EPS": "1.0",
                "BENCH_BATCH": "32", "BENCH_POINTS_CAP": "16",
                "BENCH_BNB_POINTS": "4", "BENCH_LARGE_DEPTH": "6",
                "BENCH_LARGE_P": "3", "BENCH_SHARDS": "4"}


def test_bench_phase_rehearses_on_the_cpu(tmp_path, monkeypatch, capsys):
    """Phase 25 on the CPU: tools/bench's default mode alone, then its
    rebuild, drift-walk and multichip modes together, each a
    bench_worker child counted by `counted` (the plain leg by path and
    dtype, K2's count), each row held and its history row appended to its
    own file, BENCH_HISTORY.jsonl untouched."""
    monkeypatch.setattr(chip_smoke, "BENCH_MODES", (
        ("default", [], _BENCH_SMALL),
        ("rebuild", ["--rebuild"], _BENCH_SMALL),
        ("drift_walk", ["--drift-walk"], {"BENCH_DRIFT_K": "3"}),
        ("multichip", ["--multichip"], {"BENCH_MULTICHIP_EPS": "0.5"})))
    monkeypatch.setattr(chip_smoke, "BENCH_REF", (452, 0))
    monkeypatch.setattr(chip_smoke, "BENCH_LARGE_LEAVES", 6 * 2 ** 6)
    monkeypatch.setattr(chip_smoke, "BENCH_DRIFT_MIN", 3)
    out = chip_smoke.bench_phase(torch.device("cpu"), str(tmp_path))
    log = capsys.readouterr().out
    assert "FAIL" not in log
    for tag in ('[bench] 25 default: exit 0 in', '"online_path": "descent"',
                '"large_l_leaves": 384', '"large_l_law": {"flat": '
                '{"outside": 0', "[bench] 25 rebuild: exit 0",
                "[bench] 25 drift_walk: exit 0", '"drift_generations": 3',
                "[bench] 25 multichip: exit 0", "K1 launches of its builds "
                "[0, 0, 0, 0, 0]", "[bench] phase 25 took",
                "BENCH_HISTORY.jsonl unchanged"):
        assert tag in log, tag
    assert out["bench_default"]["regions"] == 452
    assert out["bench_k2_launches"] == 0
    assert set(out["bench_k1_launches"]) == {"default", "rebuild",
                                             "drift_walk", "multichip"}
    assert "K1 of the bench process plain:register:float64" in log


def _bench_row(**kw):
    row = {"regions": chip_smoke.BENCH_REF[0], "uncertified": 0,
           "truncated": False, "online_path": "locate",
           "large_l_leaves": chip_smoke.BENCH_LARGE_LEAVES,
           "vs_baseline": 12.5, "vs_baseline_bnb": 30.0,
           "ipm_kernel_tile_us": 0.4, "online_us_per_query": 0.014,
           "large_l_flat_us_per_query": 0.14,
           "large_l_sharded_us_per_query": 2.1,
           "large_l_law": {k: {"outside": 0, "du_law": 1e-14,
                               "dcost_law": 5e-15, "du_host": 5e-15}
                           for k in ("flat", "sharded")}}
    row.update(kw)
    return row


def _law(name, **kw):
    law = _bench_row()["large_l_law"]
    law[name] = dict(law[name], **kw)
    return law


@pytest.mark.parametrize("mode,row,k2,words", [
    ("default", _bench_row(), 1, None),
    ("default", _bench_row(error="KernelError('x')"), 1, "error"),
    ("default", _bench_row(regions=chip_smoke.REF_REGIONS), 1,
     f"regions {chip_smoke.REF_REGIONS}"),
    ("default", _bench_row(truncated=True), 1, "truncated True"),
    ("default", _bench_row(), 0, "0 K2 launches"),
    ("default", _bench_row(online_path="descent"), 1, "online_path"),
    ("default", _bench_row(large_l_leaves=384), 1, "large_l_leaves 384"),
    ("default", _bench_row(vs_baseline=float("nan")), 1, "vs_baseline nan"),
    ("default", _bench_row(ipm_kernel_tile_us=None), 1,
     "ipm_kernel_tile_us None"),
    ("default", _bench_row(online_us_per_query=None), 1,
     "online_us_per_query None"),
    ("default", _bench_row(large_l_flat_us_per_query=None), 1,
     "large_l_flat_us_per_query None"),
    ("default", _bench_row(large_l_sharded_us_per_query=None), 1,
     "large_l_sharded_us_per_query None"),
    ("default", _bench_row(large_l_law=None), 1,
     "not held to the tree's law"),
    ("default", _bench_row(large_l_law=_law("sharded", outside=3)), 1,
     "large sharded: 3 outside"),
    ("default", _bench_row(large_l_law=_law("flat", du_law=1e-3)), 1,
     "large flat: 0 outside, |du| 1.00e-03"),
    ("default", _bench_row(large_l_law=_law("flat", du_host=float("nan"))),
     1, "large flat: |du| nan against the f64 host evaluator"),
    ("rebuild", {"rebuild_reuse_frac": 0.0, "rebuild_speedup": 2.0}, 0,
     "rebuild_reuse_frac 0.0"),
    ("rebuild", {"rebuild_reuse_frac": 0.9, "rebuild_speedup": 2.0}, 0,
     None),
    ("drift_walk", {"drift_generations": 4, "staleness_p50_s": 0.2,
                    "staleness_p99_s": 0.3}, 0, "generations 4"),
    ("drift_walk", {"drift_generations": 5, "staleness_p50_s": 0.2,
                    "staleness_p99_s": 0.3}, 0, None),
    ("multichip", {"multichip_scaling_frac": None,
                   "error": "RuntimeError('multichip sync tree diverged')"},
     0, "diverged"),
    ("multichip", {"multichip_scaling_frac": 0.4}, 0, None),
])
def test_bench_holds_each_rows_bar_on_the_card(mode, row, k2, words):
    """What phase 25 holds a row to on the card: no error; the default
    mode's regions, online path through K2, large-L leaves and their
    outputs held to the tree's law, baselines, K1's tile time and the
    timed online and large-L figures; the rebuild's reuse, the walk's
    generations and staleness, the multichip mode's parity."""
    bad = chip_smoke._bench_holds(mode, row, True, k2)
    if words is None:
        assert bad == []
    else:
        assert any(words in b for b in bad), bad


#: tools/serve_bench at tests/test_serve.py's sizes, shorter windows.
_SB_SMALL = {"SERVE_BENCH_SECS": "0.3", "SERVE_BENCH_DEPTH": "5",
             "SERVE_BENCH_RATES": "800,6000"}


def test_serve_bench_phase_rehearses_on_the_cpu(tmp_path, monkeypatch,
                                                capsys):
    """Phase 26 on the CPU: the legacy and the arena sweep, each a
    serve_bench_worker child counted by `counted` (K3's count, 0 on the
    CPU) under a SweepRecorder: each result held, its history row
    appended to its own file, the arena's served in-box rows re-evaluated
    by K3's plain version, BENCH_HISTORY.jsonl untouched."""
    monkeypatch.setattr(chip_smoke, "SERVE_BENCH_RUNS", (
        ("legacy", dict(_SB_SMALL, SERVE_BENCH_MAX_BATCH="32")),
        ("arena", dict(_SB_SMALL, SERVE_BENCH_TENANTS="4"))))
    out = chip_smoke.serve_bench_phase(torch.device("cpu"), str(tmp_path))
    log = capsys.readouterr().out
    assert "FAIL" not in log
    for tag in ("[serve-bench] 26 legacy: exit 0 in",
                '"versions_seen": ["v1", "v2"]', "[serve-bench] 26 legacy "
                'rate {"offered_qps": 6000.0', "[serve-bench] 26 arena: "
                "exit 0 in", '"config": {"p": 2, "depth": 5, "n_u": 2, '
                '"tenants": 4', "[serve-bench] 26 arena: K3 0 launches "
                "over the sweep's windows", "[serve-bench] phase 26 took",
                "BENCH_HISTORY.jsonl unchanged"):
        assert tag in log, tag
    assert set(out["serve_bench_wall_s"]) == {"legacy", "arena"}
    assert out["serve_bench_launches"] == out["serve_bench_k3_process"] == 0
    assert out["serve_bench_k3"] is None
    plain = out["serve_bench_plain"]
    # The plain version against itself: every in-box row, both of t0's
    # extents and the other tenants'.
    assert plain["rows"] >= 100 and plain["extents"] == 5
    assert plain["max_abs_err"] == 0.0
    assert plain["tie_free_cols_differ"] == plain["cols_differ"] == 0


def test_serve_bench_phase_runs_every_child_and_fails_once(tmp_path,
                                                           monkeypatch,
                                                           capsys):
    """A child that fails does not stop phase 26: the arena child runs
    first, every child after it still runs and is held, and the phase
    fails once, naming each child's failures."""
    started = []

    class _Failed:
        def wait(self, timeout=None):
            return 1

    def child(dev, mode, env_extra, tmp):
        started.append(mode)
        with open(os.path.join(tmp, f"26_{mode}.log"), "w") as f:
            f.write(f"{mode} stopped\n")
        return _Failed()

    monkeypatch.setattr(chip_smoke, "_serve_bench_child", child)
    with pytest.raises(SystemExit):
        chip_smoke.serve_bench_phase(torch.device("cpu"), str(tmp_path))
    assert started == [m for m, _e in chip_smoke.SERVE_BENCH_RUNS] \
        == ["arena", "legacy"]
    log = capsys.readouterr()
    text = log.out + log.err
    for mode in started:
        assert f"26 serve_bench {mode}: no result" in text, mode
        assert f"{mode} stopped" in text, mode
    assert text.count("FAIL:") == 1, text


def _sb_rates(lpr=0.125):
    return [{"offered_qps": q, "p99_us": 800.0 + q / 100,
             "launches_per_req": lpr, "phase_sum_err_frac": 0.0}
            for q in (1000.0, 4000.0, 16000.0)]


def _sb_row(**kw):
    row = {"platform": "gpu", "device_name": "NVIDIA H100 80GB HBM3",
           "power_limit": "700.00 W", "swap_dropped": 0, "swap_torn": 0,
           "swap_drained": True, "versions_seen": ["v1", "v2"],
           "tenants": 4, "batch_launches_per_req": 0.125,
           "serve_batch_fill": 1.0, "batches": 5250, "config": {"skew": 0.0},
           "rates": _sb_rates(), "slo_overhead_frac": 0.0001,
           "trace_exemplar_p99_bound": True}
    row.update(kw)
    return row


def _sb_rec(**kw):
    rec = {"k3": 5300,
           "windows": [{"rate": r, "k3": n, "requests": 8 * n}
                       for r, n in ((1000.0, 250), (4000.0, 1000),
                                    (16000.0, 4000))],
           "k3_plain": {"rows": 16384, "extents": 5, "clamped_differ": 0,
                        "tie_free": 16300, "tie_free_cols_differ": 0,
                        "cols_differ": 0, "tol": 1e-5,
                        "max_rel": {"val": 1e-7, "u": 2e-7, "cost": 0.0,
                                    "tie": 0.0},
                        "max_abs_err": 4e-7}}
    rec.update(kw)
    return rec


def _plain(**kw):
    held = dict(_sb_rec()["k3_plain"])
    held.update(kw)
    return held


@pytest.mark.parametrize("mode,row,rec,words", [
    ("arena", _sb_row(), _sb_rec(), None),
    ("legacy", _sb_row(tenants=None, batch_launches_per_req=None), None,
     None),
    ("arena", _sb_row(error="KernelError('x')"), _sb_rec(), "error"),
    ("arena", None, None, "no result"),
    ("arena", _sb_row(device_name=None), _sb_rec(), "device_name None"),
    ("legacy", _sb_row(platform="cpu"), None, "platform cpu"),
    ("arena", _sb_row(versions_seen=["v1"]), _sb_rec(), "versions_seen"),
    ("arena", _sb_row(rates=[dict(r, p99_us=None) for r in _sb_rates()]),
     _sb_rec(), "rates' p99_us"),
    ("arena", _sb_row(swap_torn=2), _sb_rec(), "torn 2"),
    ("arena", _sb_row(batch_launches_per_req=1.0,
                      rates=_sb_rates(1.0)), _sb_rec(),
     "batch_launches_per_req 1.0 (bar < 1)"),
    ("arena", _sb_row(batches=5251), _sb_rec(),
     "K3 launched 5250 times over the sweep's windows for 5251 batches"),
    ("arena", _sb_row(), _sb_rec(windows=[
        {"rate": 1000.0, "k3": 250, "requests": 2000},
        {"rate": 4000.0, "k3": 1000, "requests": 8000},
        {"rate": 16000.0, "k3": 4000, "requests": 16000}]),
     "K3 launches per request by window"),
    ("arena", _sb_row(), _sb_rec(windows=[]), "K3 launched 0 times"),
    ("arena", _sb_row(), None, "no record"),
    ("arena", _sb_row(), _sb_rec(k3_plain=None), "not held to its plain"),
    ("arena", _sb_row(), _sb_rec(k3_plain=_plain(
        max_rel={"val": 1e-7, "u": 3e-5, "cost": 0.0, "tie": 0.0})),
     "relative gaps"),
    ("arena", _sb_row(), _sb_rec(k3_plain=_plain(tie_free_cols_differ=1)),
     "columns differ on 1 tie-free rows"),
    ("arena", _sb_row(), _sb_rec(k3_plain=_plain(rows=1000)),
     "1000 rows (at least 1024)"),
    ("arena", _sb_row(), _sb_rec(k3_plain=_plain(extents=4)),
     "over 4 extents (5)"),
    ("arena", _sb_row(slo_overhead_frac=0.02), _sb_rec(),
     "slo_overhead_frac 0.02"),
])
def test_serve_bench_holds_each_bar_on_the_card(mode, row, rec, words):
    """What phase 26 holds a child's result and record to on the card: no
    error, the JAX script's bars, the card named, both versions, finite
    p99s; in the arena child K3's launches equal to the batches window by
    window, and at least 1,024 served rows over every extent equal to
    K3's plain version within its tolerance."""
    bad = chip_smoke.serve_bench_holds(mode, row, rec, True)
    if words is None:
        assert bad == []
    else:
        assert any(words in b for b in bad), bad


#: Phase 28's captures at the CPU's sizes: north_star on the double
#: integrator (its depth capped at 12: 8,192 regions, every one at the
#: cap), bench_configs' mass_spring row cut by a 3 s budget, the ladder
#: and the crossover on the double integrator at eps 0.5 and 0.2.
_CAPTURES_SMALL = (
    ("north_star", {"NS_PROBLEM": "double_integrator", "NS_MAX_DEPTH": "12",
                    "NS_PARITY_EPS": "0.5", "NS_POINTS_CAP": "64"}),
    ("bench_configs", {"CFG_ONLY": "mass_spring", "CFG_TIME_BUDGET": "3"}),
    ("eps_ladder", {"LADDER_PROBLEM": "double_integrator",
                    "LADDER_EPS": "0.5,0.2"}),
    ("online_crossover", {"CROSS_EPS": "0.5,0.2", "CROSS_BATCH": "512"}))


def test_captures_phase_rehearses_on_the_cpu(tmp_path, monkeypatch, capsys):
    """Phase 28 on the CPU: the four captures, each a capture_worker child
    counted by `counted` (the plain leg by path and dtype), each JSON held
    (capture_holds), the ladder's rungs and the crossover's rows also
    held by the phase's own check of the descent against the f64
    evaluator on tie-free queries."""
    monkeypatch.setattr(chip_smoke, "CAPTURE_RUNS", _CAPTURES_SMALL)
    monkeypatch.setattr(chip_smoke, "BENCH_REF", (8192, 8192))
    monkeypatch.setattr(chip_smoke, "CFG_REF", None)
    out = chip_smoke.captures_phase(torch.device("cpu"), str(tmp_path))
    log = capsys.readouterr().out
    assert "FAIL" not in log
    for tag in ("[captures] 28 north_star: exit 0 in", '"parity_ok": true',
                "[captures] 28 bench_configs: exit 0 in",
                '"label": "2. mass-spring mp-QP (4s, N=10)"',
                "[captures] 28 eps_ladder: exit 0 in",
                '"descent_leaf_differ": 0',
                "[captures] 28 online_crossover: exit 0 in",
                '{"k2": 0, "leaves": 1566', "[captures] phase 28 took"):
        assert tag in log, tag
    assert set(out["captures_wall_s"]) == set(out["captures_k1_launches"]) \
        == {"north_star", "bench_configs", "eps_ladder", "online_crossover"}
    # Off the card K1's own count stays 0; the records count the plain leg.
    assert set(out["captures_k1_launches"].values()) == {0}
    assert out["captures_k2_launches"] == 0
    assert "plain:register:float64" in log
    assert "plain:general:float64" in log  # mass_spring's QPs


def _cap_rec(held=(), k1=3):
    return {"k1": k1, "k1_ms": 1.0, "k2": 0, "builds": [], "held": list(held),
            "k1_by": {"cuda:register:float64": {"launches": k1, "ms": 1.0}}}


_CARD = {"platform": "gpu", "device_name": "NVIDIA H100 80GB HBM3",
         "power_limit": "700.00 W"}


def _held(**kw):
    return {"leaves": 100, "queries": 64, "tie_free": 60,
            "descent_leaf_differ": 0, "descent_du": 0.0,
            "locate_leaf_differ": 0, "locate_rel_u": 0.0,
            "locate_rel_V": 0.0, **kw}


def _ns(**kw):
    fl = {"regions": chip_smoke.BENCH_REF[0], "uncertified": 0,
          "truncated": False, "vs_serial_estimate": 3.5}
    return {**_CARD, "flagship": {**fl, **kw}, "parity": {"parity_ok": True}}


def _cfg(r1=None, cut=0.4):
    return {**_CARD, "rows": [
        {"label": "1. double integrator", "regions": chip_smoke.CFG_REF[1],
         "truncated": False, "uncertified": 0, **(r1 or {})},
        {"label": "2. mass-spring", "truncated": True,
         "volume_certified_frac": cut}]}


def _lad(regions=(13000, 23000, 37000), complete=True):
    return {**_CARD, "rows": [{"eps_a": e, "regions": r, "complete": complete,
                               "descent_us_per_query": 2.0}
                              for e, r in zip((1e-2, 5e-3, 3e-3), regions)]}


def _cross(n=2):
    return {**_CARD, "rows": [{"eps_a": e, "jax_us": 1.0, "descent_us": 2.0,
                               "locate_us": 0.1}
                              for e in (0.5, 0.2)[:n]]}


#: K2's launches a crossover row: 20 timed calls and the warm one.
_K2 = 21


@pytest.mark.parametrize("name,res,rec,words", [
    ("north_star", _ns(), _cap_rec(), None),
    ("north_star", _ns(regions=11670), _cap_rec(), "flagship regions 11670"),
    ("north_star", {**_ns(), "parity": {"parity_ok": False}}, _cap_rec(),
     "parity"),
    ("north_star", _ns(), _cap_rec(k1=0), "no K1 launch"),
    ("north_star", {**_ns(), "power_limit": None}, _cap_rec(),
     "power_limit None"),
    ("bench_configs", _cfg(), _cap_rec(), None),
    ("bench_configs", _cfg(r1={"regions": 40000}), _cap_rec(),
     "row 1. regions 40000"),
    ("bench_configs", _cfg(cut=None), _cap_rec(), "no truncated row"),
    ("eps_ladder", _lad(), _cap_rec([_held()] * 3), None),
    ("eps_ladder", _lad(regions=(13000, 13000, 37000)),
     _cap_rec([_held()] * 3), "rising strictly"),
    ("eps_ladder", _lad(complete=False), _cap_rec([_held()] * 3),
     "rungs complete"),
    ("eps_ladder", _lad(), _cap_rec([_held(descent_leaf_differ=2)] * 3),
     "descent against the f64 evaluator"),
    ("online_crossover", _cross(), _cap_rec([_held(k2=_K2)] * 2), None),
    ("online_crossover", _cross(), _cap_rec([_held(k2=22)] * 2),
     "K2 launched 22 times"),
    ("online_crossover", _cross(),
     _cap_rec([_held(k2=_K2, locate_rel_V=1e-3)] * 2),
     "K2 against the f64 evaluator"),
    ("online_crossover", _cross(1), _cap_rec([_held(k2=_K2)] * 2),
     "2 rows held of 1"),
    ("online_crossover", {"error": "KernelError('x')"}, _cap_rec(),
     "error KernelError"),
])
def test_capture_holds_each_bar_on_the_card(name, res, rec, words):
    bad = chip_smoke.capture_holds(name, res, rec, on_card=True)
    if words is None:
        assert bad == []
    else:
        assert any(words in b for b in bad), bad


def _gate_rows():
    """History rows as phases 25 and 26 leave them on the card."""
    from explicit_hybrid_mpc_tpu_torch.tools import bench_history

    card = {"platform": "gpu", "device_name": "NVIDIA H100 80GB HBM3",
            "power_limit": "700.00 W", "host": {"contended": None}}
    results = [
        ({"value": 1000.0, "online_us_per_query": 0.015, **card},
         "25_default.json"),
        ({"rebuild_reuse_frac": 0.9, "rebuild_speedup": 3.0, **card},
         "25_rebuild.json"),
        ({"serve_p99_us": 9500.0, "fallback_frac": 0.05, **card},
         "26_legacy.json"),
        ({"serve_p99_us": 8600.0, "tenants": 4, **card}, "26_arena.json")]
    return [bench_history.summarize(r, src, float(i))
            for i, (r, src) in enumerate(results)]


def test_gate_phase_rehearses_on_the_cpu(tmp_path, capsys):
    """Phase 27 over rows like phases 25's and 26's: the default row's
    copy gates clean, its 0.8x copy is flagged and exits 1, its copy at
    another power limit passes vacuously, preflight --only bench_gate on
    an empty history exits 0, and the repository's histories are as the
    script found them."""
    rows = _gate_rows()
    out = chip_smoke.gate_phase(str(tmp_path), rows, rows[0],
                                chip_smoke.repo_histories())
    log = capsys.readouterr().out
    assert "chip_smoke: FAIL" not in log and "[gate] 27 over 4 rows" in log
    assert "the 0.8x copy's CLI: GATE FAILED: 1 regression(s), exit 1" \
        in log
    assert out["gate_clean"][0] == [] and out["gate_low_rc"] == 1
    assert out["gate_low"] == ["REGRESSION value: 800 vs trailing-1 mean "
                               "1000 (20.0% lower, tol 10%)"]
    assert out["gate_preflight_rc"] == 0
    assert any("no comparable history rows" in ln
               for ln in out["gate_other_power"][1])


def test_a_repository_history_that_moved_fails_27(tmp_path, capsys):
    rows = _gate_rows()
    digest, exists = chip_smoke.repo_histories()
    with pytest.raises(SystemExit):
        chip_smoke.gate_phase(str(tmp_path), rows, rows[0],
                              (digest, not exists))
    assert "appeared at the repository root" in capsys.readouterr().out


def test_each_lane_runs_its_phases_in_order(tmp_path, monkeypatch):
    """run_lane: lane B from a flagship tree of its own through 16, 20,
    21 and 22 (21 with a loader guard armed after every library is
    loaded), lane C through 23, 24 (its CPU reference started before 23
    and stopped after 24) and 25, lane D through 28; each phase's result
    by its number."""
    from explicit_hybrid_mpc_tpu_torch import kernels

    calls = []
    tree = ("problem", "cfg", "res", 12.5, 694, "table")
    monkeypatch.setattr(chip_smoke, "lane_tree", lambda dev: tree)
    monkeypatch.setattr(kernels, "library",
                        lambda name: calls.append(("library", name)))

    class Host:
        def end(self, name):
            calls.append(("end", name))
    monkeypatch.setattr(chip_smoke, "HostVerdict", Host)

    def phase(num, ret):
        def run(*a):
            calls.append((num, a))
            return ret
        return run
    monkeypatch.setattr(chip_smoke, "observability_phase", phase("16", None))
    monkeypatch.setattr(chip_smoke, "multi_gpu_phase", phase("20", {"m": 1}))
    monkeypatch.setattr(chip_smoke, "analysis_phase", phase("21", {"g": 2}))
    monkeypatch.setattr(chip_smoke, "robustness_phase", phase("22", {"r": 3}))
    dev = torch.device("cpu")
    out = chip_smoke.run_lane("B", dev, "card")
    assert out == {"16": None, "20": {"m": 1}, "21": {"g": 2},
                   "22": {"r": 3}}
    nums = [c[0] for c in calls if c[0] not in ("library", "end")]
    assert tuple(nums) == chip_smoke.LANES["B"]
    assert {c[1] for c in calls if c[0] == "library"} == set(kernels.SOURCES)
    args = {c[0]: c[1] for c in calls}
    assert args["16"][:5] == (dev, "problem", "cfg", "res", "table")
    assert args["20"][:5] == (dev, "problem", "cfg", "res", 12.5)
    assert args["21"][:3] == (dev, "res", 694) and args["21"][3] == "card"
    assert args["22"][:3] == (dev, "res", 694)
    assert [c[1] for c in calls if c[0] == "end"] == [
        "phase 20", "phase 21", "phase 22"]

    calls.clear()
    ref = subprocess.Popen([sys.executable, "-c",
                            "import time; time.sleep(60)"])
    monkeypatch.setattr(chip_smoke, "precision_reference",
                        lambda dev, tmp: calls.append(("ref", tmp)) or ref)
    monkeypatch.setattr(chip_smoke, "operator_tools_phase",
                        phase("23", {"o": 4}))
    monkeypatch.setattr(chip_smoke, "capture_tools_phase",
                        phase("24", {"c": 5}))
    monkeypatch.setattr(chip_smoke, "bench_phase",
                        phase("25", {"bench_k2_launches": 6}))
    out = chip_smoke.run_lane("C", dev, "card")
    assert out == {"23": {"o": 4}, "24": {"c": 5},
                   "25": {"bench_k2_launches": 6}}
    assert [c[0] for c in calls] == ["ref", *chip_smoke.LANES["C"]]
    assert calls[2][1][1] == calls[0][1] and calls[2][1][2] is ref
    assert ref.poll() is not None, "24a's reference still runs"

    calls.clear()
    monkeypatch.setattr(chip_smoke, "captures_phase",
                        phase("28", {"captures_k2_launches": 7}))
    out = chip_smoke.run_lane("D", dev, "card")
    assert out == {"28": {"captures_k2_launches": 7}}
    assert [c[0] for c in calls] == list(chip_smoke.LANES["D"]) == ["28"]
    assert calls[0][1][0] == dev and os.path.basename(
        calls[0][1][1]).startswith("chip_smoke_captures_")


def _lane_cmd(code: str) -> list:
    return [sys.executable, "-c", code]


def test_lanes_relay_their_lines_and_return_their_results(tmp_path, capsys):
    """Each lane's lines come through behind its tag, join() returns the
    JSON each lane wrote, and every lane's wall is taken."""
    paths = {n: tmp_path / f"lane_{n}.json" for n in chip_smoke.LANES}
    cmds = {n: _lane_cmd(
        f"import json; print('phase of {n}', flush=True); "
        f"json.dump({{'2{i}': {{'k': {i}}}}}, open({str(p)!r}, 'w'))")
        for i, (n, p) in enumerate(paths.items())}
    lanes = chip_smoke.Lanes(str(tmp_path), "card", cmds=cmds)
    try:
        out = lanes.join()
    finally:
        lanes.stop()
    assert out == {n: {f"2{i}": {"k": i}} for i, n in enumerate(paths)}
    log = capsys.readouterr().out
    for n in paths:
        assert f"[lane {n}] phase of {n}\n" in log
    assert set(lanes.walls) == set(paths)
    assert all(w > 0 for w in lanes.walls.values())


def test_a_failed_lane_fails_the_script_and_stops_the_others(tmp_path,
                                                             capsys):
    """A lane that exits non-zero fails the script at the next check;
    stop() then kills the lane still running and the child it started."""
    child = tmp_path / "child.pid"
    cmds = {"B": _lane_cmd("import sys; print('chip_smoke: FAIL: 20b', "
                           "flush=True); sys.exit(1)"),
            "C": _lane_cmd(
                "import subprocess, sys, time; p = subprocess.Popen("
                "[sys.executable, '-c', 'import time; time.sleep(120)']); "
                f"open({str(child)!r}, 'w').write(str(p.pid)); "
                "time.sleep(120)")}
    lanes = chip_smoke.Lanes(str(tmp_path), "card", cmds=cmds)
    try:
        lanes.procs["B"].wait(timeout=60)
        deadline = time.time() + 60
        while not child.exists() and time.time() < deadline:
            time.sleep(0.05)
        with pytest.raises(SystemExit):
            lanes.check()
    finally:
        lanes.stop()
    log = capsys.readouterr().out
    assert "[lane B] chip_smoke: FAIL: 20b" in log
    assert "chip_smoke: FAIL: lane(s) exited non-zero: {'B': 1}" in log
    assert lanes.procs["C"].returncode is not None
    pid = int(child.read_text())
    deadline = time.time() + 10
    while _alive(pid) and time.time() < deadline:
        time.sleep(0.05)
    if _alive(pid):
        os.kill(pid, 9)
        pytest.fail("the lane's child outlived stop()")


def _alive(pid: int) -> bool:
    """Whether `pid` runs (a zombie, dead but not yet reaped, does not)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except (OSError, IndexError):
        return False


def test_a_lane_past_its_wall_limit_fails_the_script(tmp_path, capsys):
    cmds = {"B": _lane_cmd("import time; time.sleep(120)")}
    lanes = chip_smoke.Lanes(str(tmp_path), "card", cmds=cmds, timeout_s=1)
    try:
        with pytest.raises(SystemExit):
            lanes.join()
    finally:
        lanes.stop()
    assert lanes.procs["B"].returncode is not None
    assert "lane B still ran after 1 s" in capsys.readouterr().out
