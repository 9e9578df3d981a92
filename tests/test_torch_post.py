"""Torch port: post-processing (explicit_hybrid_mpc_tpu_torch/post/).

The first part mirrors the JAX package's tests/test_post.py case for
case on the port's own CPU build: partition statistics invariants, the
exact volume tiling of a pure-QP problem, the RunLog report, and the
figures.  The second part holds the port to the JAX package on the same
build (the JAX package's tree as the port's Tree, the columnar state is
the same): equal partition and runtime reports, and 2-D partition maps
drawn with the same polygons and colours.  Host-only code: the bar is
equality."""

import numpy as np
import pytest
import torch

import explicit_hybrid_mpc_tpu  # noqa: F401  (enables x64)
from explicit_hybrid_mpc_tpu.config import PartitionConfig as JaxConfig
from explicit_hybrid_mpc_tpu.partition.frontier import (
    build_partition as jax_build)
from explicit_hybrid_mpc_tpu.post import analysis as janalysis
from explicit_hybrid_mpc_tpu.problems.registry import make as jax_make
from explicit_hybrid_mpc_tpu_torch.config import PartitionConfig
from explicit_hybrid_mpc_tpu_torch.partition.frontier import build_partition
from explicit_hybrid_mpc_tpu_torch.partition.tree import Tree
from explicit_hybrid_mpc_tpu_torch.post import (load_runlog, partition_report,
                                                runtime_report)
from explicit_hybrid_mpc_tpu_torch.problems.registry import make

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The JAX tests' pendulum build (N=3, eps_a 0.5, 400 steps), by the
    port on the CPU, with its RunLog stream."""
    log = str(tmp_path_factory.mktemp("post") / "run.jsonl")
    prob = make("inverted_pendulum", N=3)
    cfg = PartitionConfig(problem="inverted_pendulum", eps_a=0.5,
                          backend="cpu", batch_simplices=64,
                          max_steps=400, log_path=log)
    return prob, build_partition(prob, cfg), log


def test_partition_report_invariants(built):
    _prob, res, _log = built
    rep = partition_report(res.tree, res.roots)
    assert rep["n_regions"] == res.stats["regions"]
    assert rep["n_nodes"] == len(res.tree)
    assert 0.5 < rep["volume_certified_frac"] <= 1.0 + 1e-9
    assert rep["depth_max"] == res.stats["max_depth"]
    assert sum(rep["depth_hist"]) == rep["n_regions"]
    assert len(rep["regions_per_delta"]) >= 2


def test_volume_exactly_tiles_for_pure_qp():
    prob = make("double_integrator", N=3, theta_box=1.5)
    cfg = PartitionConfig(eps_a=0.3, backend="cpu", batch_simplices=64)
    res = build_partition(prob, cfg)
    rep = partition_report(res.tree, res.roots)
    np.testing.assert_allclose(rep["volume_certified_frac"], 1.0,
                               rtol=1e-9)


def test_runtime_report(built):
    _prob, res, log = built
    rep = runtime_report(load_runlog(log))
    assert rep["n_steps"] == res.stats["steps"]
    assert rep["regions_final"] == res.stats["regions"]
    assert rep["regions_per_s_overall"] > 0
    assert rep["final_stats"]["regions"] == res.stats["regions"]
    assert runtime_report([]) == {"n_steps": 0}


def test_figures_render(built, tmp_path):
    import matplotlib.pyplot as plt

    from explicit_hybrid_mpc_tpu_torch.online import export
    from explicit_hybrid_mpc_tpu_torch.post import figures
    from explicit_hybrid_mpc_tpu_torch.sim import simulator

    prob, res, log = built
    figures.plot_partition_2d(res.tree, save=str(tmp_path / "part.png"))
    assert (tmp_path / "part.png").stat().st_size > 0
    figures.plot_runtime(load_runlog(log), save=str(tmp_path / "rt.png"))
    assert (tmp_path / "rt.png").stat().st_size > 0
    table = export.export_leaves(res.tree)
    sim = simulator.simulate(
        prob, simulator.ExplicitController(table, device="cpu"),
        np.array([0.3, 0.5]), T=10)
    figures.plot_closed_loop({"explicit": sim},
                             save=str(tmp_path / "cl.png"))
    assert (tmp_path / "cl.png").stat().st_size > 0
    # The CLI's sim.json shape (label -> {"states", "inputs"}) too.
    traj = {"trajectories": {"explicit": {
        "states": sim.states.tolist(), "inputs": sim.inputs.tolist()}}}
    figures.plot_closed_loop(traj, save=str(tmp_path / "cl2.png"))
    assert (tmp_path / "cl2.png").stat().st_size > 0
    tree_3d = Tree(p=3, n_u=1)
    tree_3d.add_root(np.vstack([np.zeros(3), np.eye(3)]))
    with pytest.raises(ValueError, match="2-D only"):
        figures.plot_partition_2d(tree_3d)
    plt.close("all")


# -- parity with the JAX package ---------------------------------------------


@pytest.fixture(scope="module")
def jax_built(tmp_path_factory):
    """The same pendulum build by the JAX package, with its RunLog, and
    its tree as the port's Tree."""
    log = str(tmp_path_factory.mktemp("jpost") / "run.jsonl")
    res = jax_build(jax_make("inverted_pendulum", N=3), JaxConfig(
        problem="inverted_pendulum", eps_a=0.5, backend="cpu",
        batch_simplices=64, max_steps=400, log_path=log))
    t = Tree.__new__(Tree)
    t.__setstate__(res.tree.__getstate__())
    return res, t, log


def test_partition_report_is_the_jax_packages(jax_built):
    jres, tree, _log = jax_built
    assert partition_report(tree, jres.roots) \
        == janalysis.partition_report(jres.tree, jres.roots)
    assert partition_report(tree) == janalysis.partition_report(jres.tree)


def test_runtime_report_is_the_jax_packages(jax_built, built):
    for log in (jax_built[2], built[2]):
        assert load_runlog(log) == janalysis.load_runlog(log)
        recs = load_runlog(log)
        assert runtime_report(recs) == janalysis.runtime_report(recs)


def _polygons(fig):
    ax = fig.axes[0]
    return ([(p.get_xy().tobytes(), p.get_facecolor(), p.get_hatch())
             for p in ax.patches], ax.get_xlim(), ax.get_ylim(),
            ax.get_title())


@pytest.mark.parametrize("color_by", ["delta", "depth"])
def test_plot_partition_2d_draws_the_jax_polygons(jax_built, color_by):
    import matplotlib.pyplot as plt

    from explicit_hybrid_mpc_tpu.post import figures as jfigures
    from explicit_hybrid_mpc_tpu_torch.post import figures

    jres, tree, _log = jax_built
    got = _polygons(figures.plot_partition_2d(tree, color_by=color_by))
    exp = _polygons(jfigures.plot_partition_2d(jres.tree,
                                               color_by=color_by))
    assert len(got[0]) == len(tree.leaves()) > 100
    assert got == exp
    plt.close("all")


def test_post_package_imports_without_matplotlib():
    """post/__init__ never imports matplotlib (the card's machine has
    none): checked in a fresh interpreter that cannot find it."""
    import json
    import os
    import subprocess
    import sys

    probe = ("import sys; sys.modules['matplotlib'] = None\n"
             "import explicit_hybrid_mpc_tpu_torch.post as p\n"
             "import explicit_hybrid_mpc_tpu_torch.post.analysis\n"
             "try:\n"
             "    import explicit_hybrid_mpc_tpu_torch.post.figures\n"
             "    ok = False\n"
             "except ImportError:\n"
             "    ok = True\n"
             "import json; print(json.dumps([p.partition_report.__name__,"
             " ok]))")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", probe], cwd=repo,
                         env={**os.environ, "PYTHONPATH": repo},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) \
        == ["partition_report", True]
