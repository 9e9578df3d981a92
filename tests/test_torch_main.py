"""Torch port: the build CLI against the JAX package's.

For each argv, the port's ``config_from_args`` must give a
PartitionConfig equal, field by field, to the one the JAX package's
``main`` builds from the same flags (captured where it hands the config
to ``make_oracle``; the JAX package is not edited).  A build stopped
after a checkpoint and resumed with ``--resume`` must give the straight
build's tree, and every flag whose module is not ported yet must exit
with "not yet ported"."""

import dataclasses
import os

import pytest
import torch

import explicit_hybrid_mpc_tpu  # noqa: F401  (enables x64)
from explicit_hybrid_mpc_tpu import main as jmain
from explicit_hybrid_mpc_tpu.partition import frontier as jfrontier
from explicit_hybrid_mpc_tpu_torch import main as tmain
from explicit_hybrid_mpc_tpu_torch.partition.tree import Tree

torch.set_num_threads(1)

_DI = ["-e", "double_integrator", "--problem-arg", "N=3", "--problem-arg",
       "theta_box=1.5"]

#: Build flags as a user gives them (each list also gets --backend cpu
#: and an output prefix, the one backend both packages name alike).
ARGVS = {
    "defaults": ["-e", "inverted_pendulum"],
    "eps_r_alone": ["-e", "quadrotor", "-r", "0.1"],
    "quadrotor_pv": ["-e", "quadrotor", "-r", "0.1", "-a", "1",
                     "--problem-arg", 'param="pv"', "--problem-arg",
                     "pos_box=0.4", "--problem-arg", "vel_box=0.2"],
    "no_two_phase": [*_DI, "--no-two-phase", "--no-warm-start"],
    "phase1_point": [*_DI, "--phase1-iters-point", "8"],
    "phase1_split": [*_DI, "--phase1-iters", "4",
                     "--phase1-iters-simplex", "6"],
    "feasible": [*_DI, "--algorithm", "feasible", "--boundary-depth", "5",
                 "--max-depth", "12"],
    "pipeline": [*_DI, "-a", "0.5", "--pipeline-depth", "0",
                 "--no-speculate", "--dedup-window", "64",
                 "--async-certify"],
    "budget": [*_DI, "-a", "0.5", "--max-steps", "7",
               "--checkpoint-every", "2", "--batch", "32", "--precision",
               "mixed"],
    "recovery": [*_DI, "--obs", "jsonl", "--solve-timeout", "30",
                 "--fault-plan", "plan.json"],
    "obs_path": [*_DI, "--obs", "full", "--obs-path", "x.obs.jsonl"],
    "rebuild_from": [*_DI, "--rebuild-from", "prior.tree.pkl",
                     "--strict-provenance"],
    "from_alias": [*_DI, "-a", "9e-3", "--from", "prior.ckpt.pkl"],
}


class _Captured(Exception):
    def __init__(self, cfg):
        super().__init__("captured")
        self.cfg = cfg


def _jax_config(argv, monkeypatch):
    def capture(problem, cfg, *a, **kw):
        raise _Captured(cfg)
    monkeypatch.setattr(jfrontier, "make_oracle", capture)
    with pytest.raises(_Captured) as e:
        jmain.main(argv)
    return e.value.cfg


@pytest.mark.parametrize("key", sorted(ARGVS))
def test_config_from_args_is_the_jax_cli_config(key, tmp_path,
                                                monkeypatch):
    argv = [*ARGVS[key], "--backend", "cpu", "-o", str(tmp_path / "p")]
    ref = _jax_config(argv, monkeypatch)
    got = tmain.config_from_args(tmain.build_parser().parse_args(argv))
    names = [f.name for f in dataclasses.fields(got)]
    assert names == [f.name for f in dataclasses.fields(ref)]
    for name in names:
        assert getattr(got, name) == getattr(ref, name), name


def test_eps_rule_follows_the_jax_cli(tmp_path):
    parse = tmain.build_parser().parse_args
    base = ["-e", "quadrotor", "-o", str(tmp_path / "p")]
    for extra, eps_a, eps_r in (([], 1e-2, 0.0), (["-r", "0.1"], 0.0, 0.1),
                                (["-r", "0.1", "-a", "1"], 1.0, 0.1),
                                (["-a", "0.5"], 0.5, 0.0)):
        cfg = tmain.config_from_args(parse([*base, "--backend", "cpu",
                                            *extra]))
        assert (cfg.eps_a, cfg.eps_r) == (eps_a, eps_r), extra
    # The backend still defaults to the card.
    assert parse(base).backend == "cuda"


def test_list_prints_the_jax_cli_problems(capsys):
    assert jmain.main(["-e", "x", "--list"]) == 0
    ref = capsys.readouterr().out
    assert tmain.main(["-e", "x", "--list"]) == 0
    got = capsys.readouterr().out
    assert got == ref and "quadrotor" in got.split()


def _signature(prefix):
    tree = Tree.load(prefix + ".tree.pkl")
    leaves = tree.converged_leaves()
    return (tuple(tree.vertices[n].tobytes() for n in range(len(tree))),
            tuple(tree.leaf_data[n].delta_idx for n in leaves),
            tuple(bool(tree.leaf_data[n].certified) for n in leaves))


def test_resumed_build_is_the_straight_build(tmp_path):
    """The tier-1 DI build checkpointed every 2 steps and stopped after
    3, then resumed from its checkpoint (step 2) through --resume, gives
    the straight build's tree node for node."""
    common = [*_DI, "-a", "0.5", "--batch", "64", "--max-depth", "20",
              "--backend", "cpu"]
    straight, part, rest = (str(tmp_path / n) for n in ("a", "b", "c"))
    assert tmain.main([*common, "-o", straight]) == 0
    assert tmain.main([*common, "-o", part, "--checkpoint-every", "2",
                       "--max-steps", "3"]) == 0
    ckpt = part + ".ckpt.pkl"
    assert os.path.exists(ckpt)
    assert _signature(part) != _signature(straight)  # it was cut short
    # The solver flags come from the snapshot: a differing -a is ignored.
    assert tmain.main(["-e", "double_integrator", "-a", "0.25", "--backend",
                       "cpu", "-o", rest, "--resume", ckpt]) == 0
    assert _signature(rest) == _signature(straight)


@pytest.mark.parametrize("flag", sorted(tmain._UNPORTED_FLAGS))
def test_unported_flags_exit(flag):
    with pytest.raises(SystemExit, match="not yet ported") as e:
        tmain.main(["-e", "double_integrator", flag, "1"])
    assert tmain._UNPORTED_FLAGS[flag] in str(e.value)
