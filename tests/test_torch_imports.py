"""Torch port: importing every module of the package loads neither JAX
nor the JAX package.

Checked in a fresh interpreter (this test process has both loaded):
every module under ``explicit_hybrid_mpc_tpu_torch`` is imported, the
serving, lifecycle, analysis and tools subpackages included, and then ``sys.modules``
must hold no ``jax`` / ``jax.*``, no ``explicit_hybrid_mpc_tpu`` /
``explicit_hybrid_mpc_tpu.*``, no ``bench`` (the JAX package's
bench.py) and no module loaded from scripts/ (bench_gate and the other
JAX scripts)."""

import json
import os
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, os, pkgutil, sys
import explicit_hybrid_mpc_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")
         if not m.name.endswith(".__main__")]
for n in names:
    importlib.import_module(n)
scripts = os.path.join(os.getcwd(), "scripts") + os.sep
bad = sorted(m for m, mod in list(sys.modules.items())
             if m in ("jax", "jaxlib", "explicit_hybrid_mpc_tpu", "bench")
             or m.startswith(("jax.", "jaxlib.", "explicit_hybrid_mpc_tpu."))
             or (getattr(mod, "__file__", None) or "").startswith(scripts))
print(json.dumps({"modules": names, "bad": bad}))
"""


@pytest.fixture(scope="module")
def probe():
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH",)}
    env["PYTHONPATH"] = _REPO
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_no_module_of_the_port_loads_jax(probe):
    assert probe["bad"] == []


@pytest.mark.parametrize("sub", ["serve.arena", "serve.scheduler",
                                 "serve.fallback", "serve.registry",
                                 "lifecycle.delta", "online.fused",
                                 "online.descent", "online.locate",
                                 "kernels", "oracle.ipm_leg",
                                 "serve.cli", "online.sharded",
                                 "parallel.mesh", "partition.synthetic",
                                 "sim.simulator", "main",
                                 "problems.mass_spring",
                                 "problems.satellite",
                                 "problems.satellite_soc",
                                 "problems.quadrotor",
                                 "partition.rebuild", "lifecycle.revision",
                                 "lifecycle.service", "lifecycle.cli",
                                 "oracle.bnb", "obs.host", "obs.reqtrace",
                                 "obs.profiling", "oracle.prune",
                                 "oracle.socp", "oracle.soc_point",
                                 "oracle.soc_oracle", "obs.health",
                                 "obs.recorder", "obs.fleet",
                                 "obs.replay", "obs.slo", "obs.demand",
                                 "post.analysis", "post.figures",
                                 "partition.shard", "parallel.distributed",
                                 "parallel.launch", "analysis",
                                 "analysis.engine", "analysis.cli",
                                 "analysis.recompile_guard",
                                 "analysis.rules",
                                 "analysis.rules.host_sync",
                                 "analysis.rules.recompile",
                                 "analysis.rules.dtype",
                                 "analysis.rules.obs_hot",
                                 "analysis.rules.silent_except",
                                 "tools", "tools.supervise_build",
                                 "tools.chaos_suite", "tools.drift_smoke",
                                 "tools.obs_report", "tools.obs_watch",
                                 "tools.fleet_smoke", "tools.preflight",
                                 "tools.capture", "tools.precision_check",
                                 "tools.tune_schedule", "tools.onset_probe",
                                 "tools.long_build", "tools.bench",
                                 "tools.bench_history",
                                 "tools.serve_bench", "tools.bench_gate",
                                 "tools.north_star", "tools.bench_configs",
                                 "tools.eps_ladder",
                                 "tools.online_crossover"])
def test_the_walk_reaches_every_subpackage(probe, sub):
    assert f"explicit_hybrid_mpc_tpu_torch.{sub}" in probe["modules"]
