"""recompile-hazard: patterns that multiply compilations, captures and
compiled shapes.

Three sub-checks, each a pattern that turns "build once, launch
thousands of times" into "build per call":

1. **compile-in-function**: ``torch.compile(...)``,
   ``torch.jit.script(...)`` / ``trace(...)`` or a CUDA-graph capture
   (``torch.cuda.CUDAGraph()``, ``with torch.cuda.graph(...)``) inside
   a plain function body builds a FRESH compiled callable or graph per
   call -- every invocation recompiles or re-captures.  Constructors
   (``__init__`` and friends) are exempt: building a program family
   once per object is the standard pattern; ``functools.cache`` /
   ``lru_cache``-decorated enclosing functions are exempt too (the
   closure IS the cache).
2. **loop-varying closure**: a compiled (or vmapped) lambda closing
   over a local that an enclosing loop rebinds -- each rebinding is a
   new constant guarded into the compiled program, so its cache grows
   with the loop instead of hitting.
3. **non-pow-2 bucket literal**: padding/bucket sizes feeding the
   batched solver paths (``qp_solve`` / ``solve_pairs_full`` and the
   dispatch plumbing around them) must be powers of two -- the port
   keeps the JAX package's invariant bounding the compiled-shape set
   (``Oracle.compiled_shapes``, ``Oracle.max_points_per_call``,
   ``sharded._bucket``): the same ledger, and the shape set a future
   CUDA graph per bucket is captured for.  An int literal
   bucket/pad/cap that is not a power of two silently mints a new
   shape per distinct batch size.  Unchanged from the JAX rule.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator

from explicit_hybrid_mpc_tpu_torch.analysis.engine import (
    Finding, ModuleContext, Rule, _attr_chain, _call_name, _chain_ends)

_CTOR_NAMES = {"__init__", "__new__", "__post_init__", "__init_subclass__"}
_CACHE_DECOS = {"cache", "lru_cache", "cached_property"}
_BUCKET_NAME = re.compile(r"(bucket|pad|batch|chunk|cap)s?$", re.IGNORECASE)
#: Calls that build a compiled callable or a CUDA graph.
_BUILDERS = (("torch", "compile"), ("jit", "script"), ("jit", "trace"),
             ("cuda", "CUDAGraph"), ("cuda", "graph"),
             ("make_graphed_callables",))
#: Wrappers whose lambda argument is compiled or vectorized.
_LAMBDA_WRAPPERS = (("torch", "compile"), ("jit", "script"),
                    ("jit", "trace"), ("vmap",))


def _pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


class RecompileHazard(Rule):
    name = "recompile-hazard"
    severity = "warn"
    doc = ("torch.compile / jit.script / CUDA-graph capture inside a "
           "per-call function (fresh build per call), loop-varying "
           "closures baked into compiled lambdas, non-pow-2 bucket "
           "literals feeding the batched solver paths")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call):
                chain = _attr_chain(node.func)
                if _chain_ends(chain, _BUILDERS):
                    yield from self._check_build_site(ctx, node, chain)
                if _chain_ends(chain, _LAMBDA_WRAPPERS) and node.args \
                        and isinstance(node.args[0], ast.Lambda):
                    yield from self._check_closure(ctx, node.args[0])
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                yield from self._check_bucket_assign(ctx, node)
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.keyword) and node.arg \
                    and _BUCKET_NAME.search(node.arg):
                v = node.value
                if isinstance(v, ast.Constant) and isinstance(v.value, int) \
                        and not isinstance(v.value, bool) \
                        and v.value > 2 and not _pow2(v.value):
                    yield self.finding(
                        ctx, v,
                        f"non-power-of-two literal {v.value} for "
                        f"'{node.arg}': padding buckets must be powers "
                        "of two to bound the compiled-shape set")

    # -- 1. compile / capture built inside a per-call function -------------

    def _check_build_site(self, ctx: ModuleContext, node: ast.Call,
                          chain: list[str]) -> Iterator[Finding]:
        fn = ctx.enclosing_function(node)
        if fn is None or isinstance(fn, ast.Lambda):
            return
        if fn.name in _CTOR_NAMES:
            return
        for dec in fn.decorator_list:
            target = dec.func if isinstance(dec, ast.Call) else dec
            if _call_name(target) in _CACHE_DECOS:
                return
        yield self.finding(
            ctx, node,
            f"{'.'.join(chain)}(...) inside `{fn.name}` builds a fresh "
            "compiled callable or CUDA graph per call -- every "
            "invocation recompiles or re-captures; hoist to "
            "module/constructor scope or functools.cache the builder")

    # -- 2. loop-varying closures ------------------------------------------

    def _check_closure(self, ctx: ModuleContext, lam: ast.Lambda
                       ) -> Iterator[Finding]:
        params = {a.arg for a in (lam.args.args + lam.args.kwonlyargs
                                  + lam.args.posonlyargs)}
        if lam.args.vararg:
            params.add(lam.args.vararg.arg)
        free = {n.id for n in ast.walk(lam.body)
                if isinstance(n, ast.Name)
                and isinstance(n.ctx, ast.Load)} - params
        fn = ctx.enclosing_function(lam)
        if fn is None or not free:
            return
        for node in ast.walk(fn):
            targets: list[ast.AST] = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, ast.AugAssign):
                targets = [node.target]
            elif isinstance(node, ast.For):
                targets = [node.target]
            for t in targets:
                for nm in ast.walk(t):
                    if isinstance(nm, ast.Name) and nm.id in free \
                            and self._in_loop(ctx, node, stop=fn):
                        yield self.finding(
                            ctx, lam,
                            f"compiled lambda closes over `{nm.id}`, "
                            "which an enclosing loop rebinds: each value "
                            "is a new guarded constant, so the compile "
                            "cache grows with the loop; pass it as an "
                            "argument instead")
                        return

    @staticmethod
    def _in_loop(ctx: ModuleContext, node: ast.AST, stop: ast.AST) -> bool:
        cur = ctx.parents.get(node)
        while cur is not None and cur is not stop:
            if isinstance(cur, (ast.For, ast.While)):
                return True
            cur = ctx.parents.get(cur)
        return isinstance(node, ast.For)

    # -- 3. non-pow-2 bucket literals --------------------------------------

    def _check_bucket_assign(self, ctx: ModuleContext, node: ast.AST
                             ) -> Iterator[Finding]:
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        else:  # AnnAssign
            targets = [node.target]  # type: ignore[attr-defined]
            value = node.value  # type: ignore[attr-defined]
        if not (isinstance(value, ast.Constant)
                and isinstance(value.value, int)
                and not isinstance(value.value, bool)
                and value.value > 2 and not _pow2(value.value)):
            return
        for t in targets:
            chain = _attr_chain(t)
            if chain and _BUCKET_NAME.search(chain[-1]):
                yield self.finding(
                    ctx, node,
                    f"non-power-of-two literal {value.value} assigned to "
                    f"'{chain[-1]}': padding buckets must be powers of "
                    "two to bound the compiled-shape set")
                return
