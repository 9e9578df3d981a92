"""silent-except: broad exception handlers that swallow silently.

Around a kernel launch, a bare ``except: pass`` eats the whole failure
taxonomy at once -- a CUDA error (illegal address, OOM), a
kernels.KernelError, programming errors, KeyboardInterrupt under
``BaseException`` -- and the build "succeeds" with a hole where a batch
of solves should be: exactly the fallback that hides the device, which
the port forbids.  The sanctioned patterns are narrow typed handlers
that LOG and re-route (frontier._oracle_call's recovery) or diagnostics
guards explicitly annotated as must-never-break-the-build; the latter
carry a tpulint pragma with the justification inline, which doubles as
reviewer documentation.  The rule is the JAX package's, unchanged.
"""

from __future__ import annotations

import ast
from typing import Iterator

from explicit_hybrid_mpc_tpu_torch.analysis.engine import (
    Finding, ModuleContext, Rule, _call_name)

_BROAD = {"Exception", "BaseException"}


def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:  # bare except
        return True
    if isinstance(t, (ast.Name, ast.Attribute)):
        return _call_name(t) in _BROAD
    if isinstance(t, ast.Tuple):
        return any(_call_name(e) in _BROAD for e in t.elts)
    return False


def _is_trivial(body: list[ast.stmt]) -> bool:
    """pass / ... / continue only: nothing logged, nothing re-raised."""
    for stmt in body:
        if isinstance(stmt, (ast.Pass, ast.Continue)):
            continue
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value,
                                                     ast.Constant):
            continue  # docstring or `...`
        return False
    return True


class SilentExcept(Rule):
    name = "silent-except"
    severity = "warn"
    doc = ("broad except handler (bare / Exception / BaseException) "
           "whose body swallows silently: device failures vanish into "
           "a hole in the build")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ExceptHandler) and _is_broad(node) \
                    and _is_trivial(node.body):
                yield self.finding(
                    ctx, node,
                    "broad exception handler silently swallows -- device "
                    "failures (and Ctrl-C under BaseException) vanish; "
                    "narrow the type, log the error, or pragma it with a "
                    "justification if it guards diagnostics that must "
                    "never break the build")
