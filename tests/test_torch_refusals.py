"""Torch port: every refusal of a surface that is not ported yet names
its ROADMAP item and the JAX package's module it waits for, and that
module is a file of the JAX package.

A refusal names the module, not only the item number, so that a later
renumbering of ROADMAP.md cannot strand it.  The check reads paths
only: it imports nothing of the JAX package."""

import os
import re

import pytest

from explicit_hybrid_mpc_tpu_torch import config
from explicit_hybrid_mpc_tpu_torch import main as tmain
from explicit_hybrid_mpc_tpu_torch.lifecycle import service
from explicit_hybrid_mpc_tpu_torch.serve import scheduler

_JAX_PKG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "explicit_hybrid_mpc_tpu")


def _raised(fn) -> str:
    with pytest.raises((NotImplementedError, SystemExit)) as e:
        fn()
    return str(e.value)


def _oracle_serial():
    from explicit_hybrid_mpc_tpu_torch.oracle.oracle import Oracle
    from explicit_hybrid_mpc_tpu_torch.problems.registry import make

    Oracle(make("double_integrator", N=3), backend="serial")


def _oracle_mesh():
    from explicit_hybrid_mpc_tpu_torch.oracle.oracle import Oracle
    from explicit_hybrid_mpc_tpu_torch.problems.registry import make

    Oracle(make("double_integrator", N=3), backend="cpu", mesh=object())


def _obs_per_process(tmp):
    from explicit_hybrid_mpc_tpu_torch.obs import Obs

    Obs("jsonl", path=os.path.join(tmp, "x.obs.jsonl"), per_process=True)


#: (site, a callable giving the refusal's text; it takes a scratch dir).
SITES = (
    [(f"PartitionConfig.{f}", lambda tmp, item=item: item)
     for f, _on, item in config._UNPORTED]
    + [(f"ServeConfig.{f}", lambda tmp, item=item: item)
       for f, item in config._SERVE_UNPORTED]
    + [(f"LifecycleConfig.{f}", lambda tmp, item=item: item)
       for f, item in service._LIFECYCLE_UNPORTED]
    + [(f"main {flag}", lambda tmp, flag=flag: _raised(
        lambda: tmain.main(["-e", "double_integrator", flag, "1"])))
       for flag in tmain._UNPORTED_FLAGS]
    + [(f"scheduler hook {h}", lambda tmp, h=h: scheduler._HOOK_ITEMS[h])
       for h in scheduler._HOOK_ITEMS]
    + [("Oracle serial", lambda tmp: _raised(_oracle_serial)),
       ("Oracle mesh", lambda tmp: _raised(_oracle_mesh)),
       ("Obs per_process", lambda tmp: _raised(
           lambda: _obs_per_process(tmp))),
       ("serve-rebuild --backend serial", lambda tmp: _raised(
           lambda: tmain.main(["serve-rebuild", "-e", "double_integrator",
                               "--backend", "serial", "--artifacts-root",
                               tmp])))])


@pytest.mark.parametrize("site,text", SITES, ids=[s for s, _ in SITES])
def test_a_refusal_names_its_item_and_an_existing_jax_module(site, text,
                                                             tmp_path):
    msg = text(str(tmp_path))
    assert re.search(r"\bA\d+\b", msg), msg
    modules = re.findall(r"[\w/]+\.py\b", msg)
    assert modules, msg
    for m in modules:
        assert os.path.isfile(os.path.join(_JAX_PKG, m)), (site, m)
