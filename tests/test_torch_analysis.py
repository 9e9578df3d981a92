"""Torch port: the analysis package (``explicit_hybrid_mpc_tpu_torch/
analysis/``) against the JAX package's ``analysis/``.

- Shared fixtures (engine mechanics, pragmas, parse error,
  silent-except, the bucket literal, builtin dtype casts) go through
  both engines: findings equal as (rule, line, col, code); baselines
  written from them equal, and both reject a version mismatch.
- Each framework rule's fixture of tests/test_tpulint.py goes through
  the JAX engine and its torch translation (same line layout) through
  the port's: findings at the same (rule, line) pairs.
- Index parity: for each of the 13 JAX modules the JAX index marks,
  every marked function name that also names a function in the port's
  counterpart module is marked by the port's index.
- The port lints clean against its own baseline; the CLI gates a seeded
  violation and refuses a restricted baseline rewrite; nothing touches
  the JAX package's TPULINT_BASELINE.json; the four pragmas carried
  over from the JAX code are each live.
"""

import ast
import hashlib
import json
import os
import re
import subprocess
import sys
import textwrap

import pytest

from explicit_hybrid_mpc_tpu.analysis import engine as jengine
from explicit_hybrid_mpc_tpu.analysis.rules import (
    rules_by_name as jax_rules_by_name)
from explicit_hybrid_mpc_tpu_torch.analysis import cli, engine
from explicit_hybrid_mpc_tpu_torch.analysis.rules import (all_rules,
                                                          rules_by_name)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "explicit_hybrid_mpc_tpu_torch")
JAX = os.path.join(REPO, "explicit_hybrid_mpc_tpu")
JAX_BASELINE = os.path.join(REPO, "TPULINT_BASELINE.json")


def lint(src: str, eng=engine) -> list:
    return eng.lint_source(textwrap.dedent(src), "fixture.py",
                           rel="fixture.py")


def cells(findings) -> list:
    return [(f.rule, f.line, f.col, f.code) for f in findings]


def lines(findings) -> list:
    return sorted((f.rule, f.line) for f in findings)


# -- shared fixtures: identical findings in both engines ---------------------

SHARED = {
    "silent_except_positive": """
        def risky(solve, x):
            try:
                return solve(x)
            except Exception:
                pass
    """,
    "silent_except_typed": """
        def risky(solve, x, log):
            try:
                return solve(x)
            except RuntimeError as e:
                log(e)
                return None
    """,
    "silent_except_line_pragma": """
        def risky(dump, x):
            try:
                dump(x)
            except Exception:  # tpulint: disable=silent-except -- diag
                pass
    """,
    "file_level_pragma": """
        # tpulint: disable=silent-except
        def a(x):
            try:
                x()
            except Exception:
                pass

        def b(x):
            try:
                x()
            except BaseException:
                pass
    """,
    "disable_all": """
        def a(x):
            try:
                x()
            except:  # tpulint: disable=all -- teardown
                pass
            pad = 100  # tpulint: disable=all
    """,
    "parse_error": "def broken(:\n",
    "bucket_literal": """
        def plan():
            pad = 100            # non-pow-2 bucket
            good_pad = 128       # pow-2: fine
            self.chunk = 24
            return pad + good_pad
    """,
    "bucket_keyword": """
        def run(solve):
            return solve(points_cap=1000), solve(points_cap=1024)
    """,
    "builtin_dtype_casts": """
        import numpy as np

        def f(x):
            a = x.astype(float)            # width-ambiguous
            b = np.zeros(3, dtype=int)     # width-ambiguous
            c = np.zeros(3, dtype=bool)    # bool: exempt
            d = x.astype(np.float64)       # named: fine
            return a, b, c, d
    """,
    "x32_module_tag": """
        # tpulint: x32-module
        import numpy as np

        def kernel(x):
            y = np.zeros(3, dtype='float64')
            return x * np.float64(2.0) + y
    """,
    "x32_untagged": """
        import numpy as np

        def kernel(x):
            return x * np.float64(2.0)
    """,
}


#: Shared fixtures whose findings are all suppressed or absent.
CLEAN = {"silent_except_typed", "silent_except_line_pragma",
         "file_level_pragma", "x32_untagged", "disable_all"}


@pytest.mark.parametrize("name", sorted(SHARED))
def test_shared_fixture_gives_identical_findings(name):
    src = SHARED[name]
    port, ref = lint(src), lint(src, jengine)
    assert cells(port) == cells(ref)
    assert bool(port) == (name not in CLEAN), name


def test_baseline_round_trip_and_payload_equal(tmp_path):
    src = SHARED["silent_except_positive"] + SHARED["bucket_literal"]
    port, ref = lint(src), lint(src, jengine)
    assert port
    payload = engine.baseline_payload(port)
    assert payload == jengine.baseline_payload(ref)
    bp = tmp_path / "baseline.json"
    bp.write_text(json.dumps(payload))
    baseline = engine.load_baseline(str(bp))
    assert baseline == jengine.load_baseline(str(bp))
    new, old = engine.split_baselined(port, baseline)
    assert not new and len(old) == len(port)
    # A second occurrence of a key is new (multiset semantics)...
    new, old = engine.split_baselined(port + port, baseline)
    assert len(new) == len(port) and len(old) == len(port)
    # ...and matching survives a line shift (content-keyed).
    new, _ = engine.split_baselined(lint("\n\n\n" + textwrap.dedent(src)),
                                    baseline)
    assert not new


def test_baseline_version_mismatch_raises_in_both(tmp_path):
    bp = tmp_path / "baseline.json"
    bp.write_text(json.dumps({"version": 999, "findings": []}))
    for eng in (engine, jengine):
        with pytest.raises(ValueError, match="version"):
            eng.load_baseline(str(bp))


def test_rule_ids_are_the_jax_packages():
    names = [r.name for r in all_rules()]
    assert len(set(names)) == len(names) == 5
    assert set(rules_by_name()) == set(jax_rules_by_name())


# -- framework fixtures: the JAX fixture and its torch translation -----------

#: name -> (JAX fixture of tests/test_tpulint.py, torch translation with
#: the same line layout).
FRAMEWORK = {
    "host_sync_positive": ("""
        import jax, numpy as np

        @jax.jit
        def kernel(x):
            s = float(x.sum())          # host cast
            a = np.asarray(x)           # np transfer
            v = x.item()                # blocking read
            if jnp.any(x > 0):          # traced branch
                s = s + 1
            return s + a.sum() + v
    """, """
        import torch, numpy as np

        @torch.compile
        def kernel(x):
            s = float(x.sum())          # host cast
            a = np.asarray(x)           # np transfer
            v = x.item()                # blocking read
            if torch.any(x > 0):        # branch on a tensor
                s = s + 1
            return s + a.sum() + v
    """),
    "kernel_body": ("""
        import jax
        from jax.experimental import pallas as pl

        def _kernel(x_ref, o_ref):
            v = float(x_ref[0])     # host cast inside the kernel
            o_ref[:] = x_ref[:] + v

        def launch(x):
            return pl.pallas_call(
                _kernel, out_shape=x)(x)
    """, """
        import torch
        import torch.nn.functional as F

        def _kernel(x_ref, o_ref):  # tpulint: device-region
            v = float(x_ref[0])     # host cast inside the kernel
            o_ref[:] = x_ref[:] + v

        def launch(x):
            return _kernel(
                x, torch.empty_like(x))
    """),
    "kernel_host_helper": ("""
        from jax.experimental import pallas as pl

        def _kernel(x_ref, o_ref):
            o_ref[:] = x_ref[:]

        def host_stage(x):
            scale = float(x.sum())
            return pl.pallas_call(_kernel, out_shape=x)(x), scale
    """, """
        import torch

        def _kernel(x_ref, o_ref):  # tpulint: device-region
            o_ref[:] = x_ref[:]

        def host_stage(x):
            scale = float(x.sum())
            return _kernel(x, torch.empty_like(x)), scale
    """),
    "host_code_free": ("""
        import numpy as np

        def host(x):
            if np.any(x > 0):
                return float(x.sum()) + np.asarray(x).item()
            return 0.0
    """, """
        import torch

        def host(x):
            if torch.any(x > 0):
                return float(x.sum()) + x.cpu().numpy().item()
            return 0.0
    """),
    "static_python_in_region": ("""
        import jax

        @jax.jit
        def kernel(x, n=3):
            if n > 0:
                x = x * n
            return x
    """, """
        import torch

        @torch.compile
        def kernel(x, n=3):
            if n > 0:
                x = x * n
            return x
    """),
    "fused_arena_kernel_shape": ("""
        import jax.numpy as jnp
        from jax.experimental import pallas as pl

        def _fused(th_ref, lb_ref, ub_ref, ext_ref, bary_ref, u_ref,
                   v_ref, val_ref, idx_ref, u_out_ref, cost_ref,
                   clamp_ref, best_val, best_idx, best_u, best_cost):
            lt = pl.program_id(1)
            thc = jnp.clip(th_ref[:], lb_ref[:], ub_ref[:])
            scale = float(thc.max())        # seeded host cast
            best_val[:] = best_val[:] * jnp.float32(scale)
            val_ref[:] = best_val[:]

        def launch(th, lb, ub, ext, bary, u, v, grid, shapes, scratch):
            return pl.pallas_call(
                _fused, grid=grid, out_shape=shapes,
                scratch_shapes=scratch)(th, lb, ub, ext, bary, u, v)
    """, """
        import torch

        # tpulint: device-region
        def _fused(th_ref, lb_ref, ub_ref, ext_ref, bary_ref, u_ref,
                   v_ref, val_ref, idx_ref, u_out_ref, cost_ref,
                   clamp_ref, best_val, best_idx, best_u, best_cost):
            lt = ext_ref.shape[1]
            thc = torch.clip(th_ref[:], lb_ref[:], ub_ref[:])
            scale = float(thc.max())        # seeded host cast
            best_val[:] = best_val[:] * scale
            val_ref[:] = best_val[:]

        def launch(th, lb, ub, ext, bary, u, v, grid, shapes, scratch):
            return _fused(
                th, lb, ub, ext, bary, u, v, grid, shapes, scratch,
                None, None, None, None, None, None)
    """),
    "host_sync_pragma_line": ("""
        import jax

        @jax.jit
        def kernel(x):
            return float(x)  # tpulint: disable=host-sync-in-jit -- probe
    """, """
        import torch

        @torch.compile
        def kernel(x):
            return float(x)  # tpulint: disable=host-sync-in-jit -- probe
    """),
    "transitive_helper": ("""
        import jax

        def helper(x):
            return float(x)

        solve = jax.jit(lambda x: helper(x))
    """, """
        import torch

        def helper(x):
            return float(x)

        solve = torch.compile(lambda x: helper(x))
    """),
    "partial_and_body_wrapper": ("""
        import functools, jax

        @functools.partial(jax.jit, static_argnums=0)
        def kernel(n, x):
            return float(x)

        def body(i, c):
            return c + float(i)

        def run(x):
            return jax.lax.fori_loop(0, 3, body, x)
    """, """
        import functools, torch

        @functools.partial(torch.compile, dynamic=False)
        def kernel(n, x):
            return float(x)

        def body(i, c):
            return c + float(i)

        def run(x):
            return torch.cond(x.sum() > 0, body, body, (0, x))
    """),
    "compile_in_function_ctor_exempt": ("""
        import jax

        def per_call(x):
            fn = jax.jit(lambda y: y * 2)   # fresh compile per call
            return fn(x)

        class Oracle:
            def __init__(self):
                self._fn = jax.jit(lambda y: y * 2)  # once per object
    """, """
        import torch

        def per_call(x):
            fn = torch.compile(lambda y: y * 2)  # fresh compile per call
            return fn(x)

        class Oracle:
            def __init__(self):
                self._fn = torch.compile(lambda y: y * 2)  # once per object
    """),
    "cached_builder_exempt": ("""
        import functools, jax

        @functools.lru_cache(maxsize=8)
        def solver(n):
            return jax.jit(lambda y: y * n)
    """, """
        import functools, torch

        @functools.lru_cache(maxsize=8)
        def solver(n):
            return torch.compile(lambda y: y * n)
    """),
    "loop_closure": ("""
        import jax

        def sweep(xs):
            out = []
            for scale in xs:
                fn = jax.jit(lambda y: y * scale)  # retrace per scale
                out.append(fn(scale))
            return out
    """, """
        import torch

        def sweep(xs):
            out = []
            for scale in xs:
                fn = torch.compile(lambda y: y * scale)  # per scale
                out.append(fn(scale))
            return out
    """),
    "obs_in_region": ("""
        import jax
        import jax.numpy as jnp

        @jax.jit
        def kernel(x, obs):
            obs.event("bad", v=1)          # emission in trace
            y = jnp.log(x)                 # array math: fine
            return y.at[0].set(0.0)        # .set is jnp, not a gauge
    """, """
        import torch
        import torch.nn.functional as F

        @torch.compile
        def kernel(x, obs):
            obs.event("bad", v=1)          # emission in the region
            y = torch.log(x)               # tensor math: fine
            return y.index_fill(0, 0, 0.0)
    """),
    "obs_on_host": ("""
        def step(self):
            self.obs.event("build.step", n=1)
            self.log.emit(step=1)
    """, """
        def step(self):
            self.obs.event("build.step", n=1)
            self.log.emit(step=1)
    """),
}


@pytest.mark.parametrize("name", sorted(FRAMEWORK))
def test_framework_fixture_fires_at_the_same_lines(name):
    jax_src, torch_src = FRAMEWORK[name]
    assert len(textwrap.dedent(jax_src).splitlines()) \
        == len(textwrap.dedent(torch_src).splitlines())
    ref = lines(lint(jax_src, jengine))
    assert lines(lint(torch_src)) == ref
    # The JAX fixture's own expectations (tests/test_tpulint.py) hold.
    want = {"host_sync_positive": 4, "kernel_body": 1,
            "fused_arena_kernel_shape": 1, "transitive_helper": 1,
            "partial_and_body_wrapper": 2,
            "compile_in_function_ctor_exempt": 1, "loop_closure": 2,
            "obs_in_region": 1}.get(name, 0)
    assert len(ref) == want, ref


# -- torch vocabulary the JAX rules have no word for -------------------------

def test_torch_host_syncs_in_a_device_region():
    found = lint("""
        import numpy as np
        import torch

        def helper(x):
            return x.tolist()                     # 6: via the closure

        def kernel(x, m, n_iter: int, ev):  # tpulint: device-region
            a = x.cpu()                           # 9
            b = x.to("cpu")                       # 10
            c = x.to(device=torch.device("cpu"))  # 11
            torch.cuda.synchronize()              # 12
            ev.synchronize()                      # 13
            d = torch.nonzero(m)                  # 14
            e = x.masked_select(m)                # 15
            f = x[x > 0]                          # 16
            keep = torch.isfinite(x) & (x < 1)
            g = x[keep]                           # 18
            h = torch.where(m)                    # 19
            while x.max() > 1:                    # 20
                x = x / 2
            k = int(n_iter) + int(x.shape[0]) + len(x)
            i = x.to(torch.float32)
            j = torch.where(m, x, 0.0)
            return helper(x), a, b, c, d, e, f, g, h, i, j, k
    """)
    assert lines(found) == [("host-sync-in-jit", n) for n in
                            (6, 9, 10, 11, 12, 13, 14, 15, 16, 18, 19, 20)]


def test_the_same_calls_in_host_code_are_free():
    found = lint("""
        import torch

        def host(x, m):
            torch.cuda.synchronize()
            return x.cpu().numpy(), x[x > 0], torch.nonzero(m), x.item()
    """)
    assert "host-sync-in-jit" not in {f.rule for f in found}


def test_device_region_pragma_and_capture_block_seed_the_index():
    ctx = engine.ModuleContext("f.py", textwrap.dedent("""
        import re
        import torch

        # tpulint: device-region
        @staticmethod
        def above(x):
            return x

        def sig(x,
                y):  # tpulint: device-region
            return x

        def captured(g, x):
            with torch.cuda.graph(g):
                y = x.item()
            return re.compile("x")

        def graphed(x):
            return x

        def scripted(x):
            return x

        def plain(x):
            return x.item()

        f = torch.cuda.make_graphed_callables(graphed, (1,))
        s = torch.jit.script(scripted)
        t = re.compile(plain)
    """))
    assert ctx.region_functions() == {"above", "sig", "graphed",
                                      "scripted"}
    found = engine.lint_source(ctx.source, "f.py")
    assert [(f.rule, f.line) for f in found
            if f.rule == "host-sync-in-jit"] == [("host-sync-in-jit", 16)]


def test_torch_recompile_and_dtype_vocabulary():
    found = lint("""
        import torch

        def replay(fn, x):
            g = torch.cuda.CUDAGraph()             # 5: per call
            with torch.cuda.graph(g):              # 6: per call
                y = fn(x)
            return torch.jit.script(fn), y         # 8: per call

        class Runner:
            def __init__(self, fn):
                self.g = torch.cuda.CUDAGraph()    # constructor: fine
                self.fn = torch.compile(fn)

        def casts(x):
            a = x.to(float)                        # 16
            b = x.type(int)                        # 17
            c = torch.zeros(3, dtype=float)        # 18
            d = x.to(torch.float64)                # named: fine
            return a, b, c, d
    """)
    assert lines(found) == sorted(
        [("recompile-hazard", n) for n in (5, 6, 8)]
        + [("dtype-discipline", n) for n in (16, 17, 18)])
    tagged = lint("""
        # tpulint: x32-module
        import torch

        def kernel(x):
            y = x.double()
            return y.to(torch.float64) + torch.ones(1, dtype=torch.double)
    """)
    assert lines(tagged) == [("dtype-discipline", 6)] \
        + [("dtype-discipline", 7)] * 2


# -- index parity over the 13 JAX modules ------------------------------------

#: JAX module (under the package) -> its counterparts in the port.
COUNTERPARTS = {
    "online/descent.py": ("online/descent.py",),
    "online/evaluator.py": ("online/evaluator.py",),
    "online/pallas_eval.py": ("online/locate.py", "online/fused.py"),
    "online/sharded.py": ("online/sharded.py",),
    "oracle/ipm.py": ("oracle/ipm.py",),
    "oracle/oracle.py": ("oracle/oracle.py",),
    "oracle/pallas_ipm.py": ("oracle/ipm_leg.py",),
    "oracle/prune.py": ("oracle/prune.py",),
    "oracle/soc_oracle.py": ("oracle/soc_oracle.py",),
    "oracle/soc_point.py": ("oracle/soc_point.py",),
    "oracle/socp.py": ("oracle/socp.py",),
    "parallel/mesh.py": ("parallel/mesh.py",),
    "serve/arena.py": ("serve/arena.py", "online/fused.py"),
}

#: Differently named counterparts (analysis/__init__.py's mapping): JAX
#: module -> port functions its marked functions became.
RENAMED = {
    "online/pallas_eval.py": {"locate_cuda", "locate_torch", "arena_eval",
                              "arena_eval_cuda", "arena_eval_torch"},
    "oracle/oracle.py": {"_solve_pairs", "point_qp", "_solve_simplex_min",
                         "simplex_min_qp", "_simplex_feas",
                         "simplex_feas_qp", "_solve_points",
                         "_solve_pairs_ws", "_solve_pairs_p2",
                         "_solve_fixed", "_solve_rescue", "_simplex_min",
                         "_simplex_min_p2"},
    "oracle/pallas_ipm.py": {"ipm_leg_torch", "chol_factor", "fwd_sub",
                             "bwd_sub", "ipm_leg", "ipm_leg_cuda"},
    "oracle/prune.py": {"_solve_pairs_red", "_simplex_min_red",
                        "_point_feas_red"},
    "oracle/soc_point.py": {"soc_pairs", "_solve"},
    "oracle/soc_oracle.py": {"_soc_pairs", "_solve_points", "_solve_fixed"},
    "oracle/socp.py": {"socp_solve"},
    "parallel/mesh.py": {"fn", "_gather"},
    "serve/arena.py": {"arena_eval"},
}


def _marked(path: str, eng) -> tuple[set, set]:
    """(marked function names, every def name) of one module."""
    with open(path, encoding="utf-8") as fh:
        ctx = eng.ModuleContext(path, fh.read())
    marked = ctx.region_functions() if eng is engine else {
        n.name for n in ctx.jit_funcs if hasattr(n, "name")}
    defs = {n.name for n in ast.walk(ctx.tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    return marked, defs


def test_the_jax_index_marks_exactly_the_13_modules():
    found = set()
    for dirpath, _dirs, files in os.walk(JAX):
        for f in files:
            if f.endswith(".py"):
                p = os.path.join(dirpath, f)
                with open(p, encoding="utf-8") as fh:
                    if jengine.ModuleContext(p, fh.read()).jit_funcs:
                        found.add(os.path.relpath(p, JAX))
    assert found == set(COUNTERPARTS)


@pytest.mark.parametrize("jax_mod", sorted(COUNTERPARTS))
def test_index_parity(jax_mod):
    jmarked, _ = _marked(os.path.join(JAX, jax_mod), jengine)
    pmarked, pdefs = set(), set()
    for mod in COUNTERPARTS[jax_mod]:
        m, d = _marked(os.path.join(PORT, mod), engine)
        pmarked |= m
        pdefs |= d
    shared = jmarked & pdefs
    assert shared <= pmarked, sorted(shared - pmarked)
    renamed = RENAMED.get(jax_mod, set())
    assert renamed <= pmarked, sorted(renamed - pmarked)


# -- the package gate, the CLI, and the JAX package's baseline ---------------

def _sha(path: str) -> str:
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def _cli(*args, cwd=REPO):
    return subprocess.run(
        [sys.executable, "-m", "explicit_hybrid_mpc_tpu_torch.analysis",
         *args], capture_output=True, text=True, cwd=cwd, timeout=300)


def test_port_lints_clean_against_its_own_baseline():
    findings = engine.lint_paths([PORT], root=REPO)
    baseline = engine.load_baseline(cli.DEFAULT_BASELINE)
    new, old = engine.split_baselined(findings, baseline)
    assert not new, "new tpulint findings:\n" + "\n".join(
        f.render() for f in new)
    # Every baselined entry is still found (no stale debt).
    assert sum(baseline.values()) == len(old)


def test_cli_gates_a_seeded_item_and_passes_the_package(tmp_path):
    before = _sha(JAX_BASELINE)
    bad = tmp_path / "seeded.py"
    bad.write_text(textwrap.dedent("""
        def kernel(x):  # tpulint: device-region
            return x.item()
    """))
    r = _cli(str(bad))
    assert r.returncode == 1, r.stdout + r.stderr
    assert "host-sync-in-jit" in r.stdout
    r = _cli()
    assert r.returncode == 0, r.stdout + r.stderr
    assert _sha(JAX_BASELINE) == before


def test_cli_refuses_a_restricted_rewrite_of_the_package_baseline(
        tmp_path):
    before = (_sha(cli.DEFAULT_BASELINE), _sha(JAX_BASELINE))
    seed = tmp_path / "s.py"
    seed.write_text("x = 1\n")
    for args in ((str(seed), "--update-baseline"),
                 ("--rules", "silent-except", "--update-baseline")):
        r = _cli(*args)
        assert r.returncode == 2 and "refusing" in r.stderr, r.stderr
    assert (_sha(cli.DEFAULT_BASELINE), _sha(JAX_BASELINE)) == before
    # A scoped update against an explicit baseline file round-trips.
    bad = tmp_path / "seeded.py"
    bad.write_text("def f(x):\n    try:\n        x()\n"
                   "    except Exception:\n        pass\n")
    bp = tmp_path / "b.json"
    r = _cli(str(bad), "--baseline", str(bp), "--update-baseline")
    assert r.returncode == 0, r.stdout + r.stderr
    r = _cli(str(bad), "--baseline", str(bp))
    assert r.returncode == 0 and "baselined" in r.stdout, r.stdout
    assert _sha(JAX_BASELINE) == before[1]
    assert _cli("--rules", "no-such-rule").returncode == 2


def test_nothing_of_the_port_names_the_jax_baseline():
    assert os.path.abspath(cli.DEFAULT_BASELINE) != JAX_BASELINE
    for dirpath, _dirs, files in os.walk(PORT):
        for f in files:
            if f.endswith((".py", ".json")):
                with open(os.path.join(dirpath, f), encoding="utf-8") as fh:
                    assert "TPULINT_BASELINE" not in fh.read(), f
    with open(JAX_BASELINE) as fh:
        assert json.load(fh)["findings"] == []


def test_analysis_imports_no_torch_at_module_scope():
    root = os.path.join(PORT, "analysis")
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            if not f.endswith(".py"):
                continue
            with open(os.path.join(dirpath, f), encoding="utf-8") as fh:
                tree = ast.parse(fh.read())
            for node in tree.body:
                names = ([a.name for a in node.names]
                         if isinstance(node, ast.Import) else
                         [node.module or ""]
                         if isinstance(node, ast.ImportFrom) else [])
                for n in names:
                    assert n.split(".")[0] not in (
                        "torch", "numpy", "jax",
                        "explicit_hybrid_mpc_tpu"), (f, n)


# -- the four pragmas carried over from the JAX code are live ----------------

CARRIED = [
    ("faults/policy.py", "recompile-hazard", "device_failure_cap: int = 3"),
    ("config.py", "recompile-hazard", "device_failure_cap: int = 3"),
    ("obs/sink.py", "silent-except", "except Exception:"),
    ("partition/pipeline.py", "silent-except", "except Exception:"),
]


@pytest.mark.parametrize("mod,rule,code", CARRIED,
                         ids=[c[0] for c in CARRIED])
def test_a_carried_pragma_suppresses_a_real_finding(mod, rule, code):
    path = os.path.join(PORT, mod)
    with open(path, encoding="utf-8") as fh:
        src = fh.read()
    pragma = re.compile(rf"\s*# tpulint: disable={rule}\b.*$")
    tagged = [i for i, ln in enumerate(src.splitlines(), 1)
              if pragma.search(ln)]
    assert len(tagged) == 1, tagged
    line = tagged[0]
    assert src.splitlines()[line - 1].strip().startswith(code)
    stripped = "\n".join(pragma.sub("", ln) for ln in src.splitlines())
    hits = [f for f in engine.lint_source(stripped, path, rel=mod)
            if f.rule == rule]
    assert [(f.line, f.code) for f in hits] == [(line, code)]
    assert not [f for f in engine.lint_source(src, path, rel=mod)
                if f.rule == rule]
