"""Torch port: tools/onset_probe.py against the JAX package's
scripts/onset_probe.py on the CPU.

Both run at the knobs of tests/test_capture_scripts.py's smoke (the
satellite_z family at scale 0.5, a 60 s budget): the JAX script in its
own process with BENCH_PLATFORM=cpu, the port's tool in this one with
``--backend cpu``.  The rung has the same regions (12), uncertified,
completeness and projection, and its certified volume within 1e-9.  The
families' ladders and problem arguments are the JAX script's."""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from explicit_hybrid_mpc_tpu_torch.tools import onset_probe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KNOBS = {"ONSET_FAMILIES": "satellite_z", "ONSET_SCALES": "0.5",
         "ONSET_BUDGET": "60"}


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    jax_out = str(tmp_path_factory.mktemp("jax_onset") / "onset.json")
    env = dict(os.environ, BENCH_PLATFORM="cpu", ONSET_OUT=jax_out, **KNOBS)
    proc = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "scripts", "onset_probe.py")],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        wd = tmp_path_factory.mktemp("port_onset")
        out = str(wd / "onset.json")
        mp = pytest.MonkeyPatch()
        for k, v in KNOBS.items():
            mp.setenv(k, v)
        try:
            rc = onset_probe.main(["--backend", "cpu", "--out", out,
                                   "--sentinel", str(wd / "sentinel")])
        finally:
            mp.undo()
        _, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
    assert proc.returncode == 0, err.decode()[-2000:]
    assert rc == 0
    with open(jax_out) as f:
        jax = json.load(f)
    with open(out) as f:
        port = json.load(f)
    return jax, port


def test_the_rung_is_the_jax_scripts(both):
    jax, port = both
    assert set(port) == set(jax)
    assert port["per_build_budget_s"] == jax["per_build_budget_s"] == 60.0
    (jr,), (pr,) = jax["families"]["satellite_z"], \
        port["families"]["satellite_z"]
    assert set(pr) == set(jr)
    for k in ("scale", "n_theta", "regions", "truncated", "uncertified",
              "complete", "projected_full_box_regions"):
        assert pr[k] == jr[k], k
    assert pr["regions"] == 12 and pr["complete"] is True
    assert pr["projected_full_box_regions"] == 48.0
    assert abs(pr["volume_certified_frac"]
               - jr["volume_certified_frac"]) <= 1e-9
    assert pr["wall_s"] > 0


def test_the_families_are_the_jax_scripts():
    spec = importlib.util.spec_from_file_location(
        "jax_onset_probe", os.path.join(REPO, "scripts", "onset_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert set(mod.FAMILIES) == set(onset_probe.FAMILIES)
    for fam, (name, ea, er, scales, kw_of) in mod.FAMILIES.items():
        pname, pea, per, pscales, pkw_of = onset_probe.FAMILIES[fam]
        assert (pname, pea, per, pscales) == (name, ea, er, scales), fam
        for s in scales:
            assert pkw_of(s) == kw_of(s), (fam, s)


def test_refuses_without_a_card(monkeypatch, tmp_path):
    monkeypatch.delenv("BENCH_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no card"):
        onset_probe.main(["--out", str(tmp_path / "o.json")])
    assert not (tmp_path / "o.json").exists()


def _equilibrated_elastic_qps(scale: float):
    """The elastic joint simplex-min QPs of the quadrotor onset box at
    `scale` over its 24 Kuhn roots x 16 commutations, equilibrated as
    qp_solve equilibrates them, with qp_solve's cold start."""
    from explicit_hybrid_mpc_tpu_torch.oracle.oracle import (Oracle,
                                                             simplex_min_qp)
    from explicit_hybrid_mpc_tpu_torch.partition import geometry
    from explicit_hybrid_mpc_tpu_torch.problems.registry import make

    kw = onset_probe.FAMILIES["quadrotor"][4](scale)
    prob = make("quadrotor", **kw)
    roots = geometry.kuhn_triangulation(prob.theta_lb, prob.theta_ub)
    nd = prob.canonical.n_delta
    Ms = torch.as_tensor(np.repeat(np.stack(
        [geometry.barycentric_matrix(V) for V in roots]), nd, axis=0))
    ds = torch.as_tensor(np.tile(np.arange(nd), len(roots)))
    Q, q, A, b = (x.numpy() for x in simplex_min_qp(
        Oracle(prob, backend="cpu").prob, Ms, ds))
    dQ = np.diagonal(Q, axis1=1, axis2=2)
    dcol = np.sqrt(np.maximum(dQ, dQ.max(-1, keepdims=True) * 1e-14
                              + 1e-12))
    Q = Q / dcol[:, :, None] / dcol[:, None, :]
    q, A = q / dcol, A / dcol[:, None, :]
    rown = np.abs(A).max(-1)
    rown = np.where(rown > 1e-10, rown, 1.0)
    A, b = A / rown[:, :, None], b / rown
    nz = q.shape[1]
    z0 = -np.linalg.solve(Q + 1e-10 * np.eye(nz), q[..., None])[..., 0]
    r0 = np.einsum("kij,kj->ki", A, z0) - b
    s0 = np.maximum(-r0, 0) + np.maximum(
        1.0, 1.1 * np.maximum(r0, 0).max(-1))[:, None]
    return [x.astype(np.float32) for x in (Q, q, A, b, z0, s0,
                                           np.ones_like(b))]


def test_the_quadrotors_f32_leg_loses_rows_in_both_packages():
    """Why 24c holds the quadrotor's mixed rungs to a span: after the
    mixed schedule's 20 float32 iterations, a fifth of the onset box's
    elastic joint QPs end non-finite in the port's plain leg AND in the
    JAX package's XLA leg, most of them the same rows but not all, so
    each implementation's mixed tree loses different certificates
    (ROADMAP.md section C)."""
    import jax
    import jax.numpy as jnp

    from explicit_hybrid_mpc_tpu.oracle import ipm as jax_ipm
    from explicit_hybrid_mpc_tpu_torch.oracle import ipm_leg

    args = _equilibrated_elastic_qps(0.02)
    port = ipm_leg.ipm_leg_torch(*(torch.as_tensor(a) for a in args),
                                 n_iter=20)
    lost_port = ~np.isfinite(port[0].numpy()).all(-1)
    xla = jax.jit(jax.vmap(lambda Q, q, A, b, z, s, lam: jax.lax.fori_loop(
        0, 20, jax_ipm._make_body(Q, q, A, b), (z, s, lam))))(
            *(jnp.asarray(a) for a in args))
    lost_jax = ~np.isfinite(np.asarray(xla[0])).all(-1)
    print(f"rows {lost_port.size}: non-finite after 20 float32 iterations "
          f"port {int(lost_port.sum())}, JAX XLA {int(lost_jax.sum())}, "
          f"both {int((lost_port & lost_jax).sum())}")
    n = lost_port.size
    assert 0.1 * n < lost_port.sum() < 0.3 * n
    assert 0.1 * n < lost_jax.sum() < 0.3 * n
    assert (lost_port & lost_jax).sum() > 0.8 * lost_jax.sum()
    assert (lost_port != lost_jax).any()
