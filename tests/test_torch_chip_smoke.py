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


def test_cold_warm_split_rehearses_on_the_cpu(tmp_path, monkeypatch,
                                             capsys):
    """20b's explanation of a differing sharded tree: both builds without
    warm starts, canonically identical here (a small pendulum: four
    commutations); then with one leaf's commutation changed in the
    sharded tree's outcomes, that leaf listed with both commutations' V
    at its vertices."""
    from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
    from explicit_hybrid_mpc_tpu_torch.problems.registry import make

    problem = make("inverted_pendulum", N=2)
    cfg = PartitionConfig(problem="inverted_pendulum",
                          problem_args=(("N", 2),), eps_a=0.5,
                          backend="cpu", batch_simplices=64, max_depth=14)
    assert chip_smoke.cold_warm_split(torch.device("cpu"), problem, cfg,
                                      str(tmp_path / "a"))
    log = capsys.readouterr().out
    assert "warm-start knife edge" in log
    assert "flagship without warm starts: point solves sharded" in log
    real, calls = chip_smoke.tree_outcomes, []

    def swapped(tree):
        out = real(tree)
        calls.append(1)
        if len(calls) == 2:
            key = next(k for k, v in out.items() if v[0] == "leaf")
            out[key] = ("leaf", (out[key][1] + 1) % 4, out[key][2])
        return out
    monkeypatch.setattr(chip_smoke, "tree_outcomes", swapped)
    chip_smoke.cold_warm_split(torch.device("cpu"), problem, cfg,
                               str(tmp_path / "b"))
    log = capsys.readouterr().out
    assert "1 leaves with another commutation" in log
    assert "single process, " in log and " sharded; V[" in log
    assert "relative gap" in log


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
        "--batch", "16", "--max-depth", "14"])
    ipm_leg.launches = 0
    res = build_partition(make("inverted_pendulum", N=2), PartitionConfig(
        problem="inverted_pendulum", problem_args=(("N", 2),), eps_a=0.5,
        backend="cpu", batch_simplices=16, max_depth=14))
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
                f"K1 launches {n_k1} (phase 3: {n_k1}); tree equal to "
                "phase 3's cell for cell", "1 health.recompile event(s)",
                "health monitor worst warn; tree equal to the unguarded",
                "RecompileError out of step()", "with the forced dispatch, "
                "in its own process: exit 1", "growth 0, libraries loaded []",
                "the guard armed after phase 3 sees 0", "a card, 700 W"):
        assert tag in log, tag
    assert out["guarded_launches"] == n_k1
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
        "--batch", "16", "--max-depth", "14"])
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
