"""dtype-discipline: width-ambiguous and f64-leaking dtypes, in torch
idiom.

Two sub-checks:

1. **builtin-dtype cast** (everywhere): ``dtype=float`` / ``int``,
   ``x.to(float)``, ``x.type(float)`` and numpy's ``x.astype(float)``
   resolve through Python's builtins, whose width depends on the
   library and its default dtype (``torch.get_default_dtype()``; numpy
   takes the platform's) -- the same line means f64 on one path and
   f32 on another.  Name the width: ``torch.float64``,
   ``np.float64``, or the source tensor's ``.dtype``.  (``bool`` is
   exempt: one width, idiomatic.)
2. **f64 in x32 modules** (files tagged ``# tpulint: x32-module``):
   ``torch.float64`` / ``torch.double`` / ``.double()`` /
   ``np.float64`` / ``dtype='float64'`` in a module declared to hold
   f32 kernel code.  One f64 constant folded into an otherwise-f32
   expression chain upcasts it into float64, which runs the H100's
   CUDA cores at half their f32 rate and doubles every byte moved --
   exactly the leak the mixed-precision schedule exists to avoid.  The
   port's modules are f64-first by policy (the IPM needs it), so no
   file is tagged today; the tag is the opt-in for future x32 kernel
   modules (and the fixture tests exercise it).
"""

from __future__ import annotations

import ast
from typing import Iterator

from explicit_hybrid_mpc_tpu_torch.analysis.engine import (
    Finding, ModuleContext, Rule, _attr_chain)

# float/int only: their tensor width depends on the library and its
# default dtype.  `bool` is deliberately NOT here -- it has exactly one
# width, so dtype=bool is idiomatic, not a hazard.
_BUILTIN_DTYPES = {"float", "int"}
_F64_NAMES = {"float64", "double"}
#: Methods whose first argument is a target dtype.
_CAST_METHODS = {"astype", "to", "type"}


class DtypeDiscipline(Rule):
    name = "dtype-discipline"
    severity = "warn"
    doc = ("builtin-dtype casts (dtype=float, .to(float), .type(int), "
           "astype(float)) whose width depends on the default dtype; "
           "f64 (torch.float64, .double()) in x32-tagged kernel modules")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call):
                yield from self._check_call(ctx, node)
            if ctx.x32_module and isinstance(node, ast.Attribute) \
                    and node.attr in _F64_NAMES:
                chain = _attr_chain(node)
                yield self.finding(
                    ctx, node,
                    f"{'.'.join(chain) or node.attr} in an x32-tagged "
                    "kernel module: one f64 constant upcasts the "
                    "expression chain into float64 (half the card's f32 "
                    "rate, twice the bytes)")

    def _check_call(self, ctx: ModuleContext, node: ast.Call
                    ) -> Iterator[Finding]:
        fn = node.func
        if isinstance(fn, ast.Attribute) and fn.attr in _CAST_METHODS \
                and node.args:
            a = node.args[0]
            if isinstance(a, ast.Name) and a.id in _BUILTIN_DTYPES:
                yield self.finding(
                    ctx, node,
                    f".{fn.attr}({a.id}) resolves through the Python "
                    "builtin: width depends on the default dtype; name "
                    "it (torch.float64 / np.float64 / other.dtype)")
        for kw in node.keywords:
            if kw.arg == "dtype":
                v = kw.value
                if isinstance(v, ast.Name) and v.id in _BUILTIN_DTYPES:
                    yield self.finding(
                        ctx, v,
                        f"dtype={v.id} resolves through the Python "
                        "builtin: width depends on the default dtype; "
                        "name it explicitly")
                elif ctx.x32_module and isinstance(v, ast.Constant) \
                        and isinstance(v.value, str) \
                        and v.value in _F64_NAMES:
                    yield self.finding(
                        ctx, v,
                        f"dtype='{v.value}' in an x32-tagged kernel "
                        "module leaks float64 into the kernel")
