"""host-sync-in-jit: host round trips inside a device region.

In eager torch every CUDA launch only enqueues; the host runs ahead of
the card until something needs a device value.  Inside a device region
(engine docstring: the functions whose JAX counterparts are traced,
and torch's own compiled or captured bodies) each of these stops the
host until the card has drained its queue, then copies:

- ``.item()`` / ``.tolist()`` / ``.cpu()`` / ``.numpy()`` /
  ``.to("cpu")`` on a tensor;
- ``torch.cuda.synchronize()`` and ``Event`` / ``Stream``
  ``.synchronize()``;
- ``float()`` / ``int()`` / ``bool()`` of a value (shape metadata --
  ``len(x)``, ``x.shape[i]``, ``x.numel()`` -- and a parameter annotated
  as a Python scalar (``n_iter: int``) live on the host and are
  exempt);
- ``np.asarray`` / ``np.array`` of a tensor;
- a branch on ``torch.*`` or on a tensor reduction
  (``if torch.any(m):``, ``while r.max() > tol:``);
- the data-dependent-shape ops, whose output size the host must read
  before it can allocate: ``nonzero`` / ``argwhere`` /
  ``masked_select`` / ``unique`` / one-argument ``torch.where``, and
  boolean-mask indexing where the mask is visibly boolean in the AST (a
  comparison, ``~``/``&``/``|`` of one, an ``isfinite``-style call, or
  a local bound to one in the same function).

Where the JAX program could not wait on the device at all (a tracer
has no value), each of these is a place the port does: one stray sync
in the wave loop serializes the pipeline the frontier's async
dispatch/prefetch exists to keep full, and it is the sync a CUDA graph
over the region (ROADMAP B2 / B3) would have to remove first.  The
rule keeps the JAX package's id so pragmas and baselines read the same
in both packages.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional

from explicit_hybrid_mpc_tpu_torch.analysis.engine import (
    Finding, ModuleContext, Rule, _attr_chain)

#: builtins that read a device value back to the host.
_HOST_CASTS = {"float", "int", "bool"}
#: numpy entry points that force a transfer when fed a CUDA tensor.
_NP_SYNC = {"asarray", "array", "copy", "ascontiguousarray"}
_NP_ROOTS = {"np", "numpy", "onp"}
#: methods that block on / read back device values.
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "synchronize"}
#: data-dependent-shape ops (the output size is a device value).
_SHAPE_OPS = {"nonzero", "argwhere", "masked_select", "unique",
              "unique_consecutive"}
#: roots whose calls compute on tensors: a branch on one reads a value.
_ARRAY_ROOTS = {"torch"}
#: tensor reductions a branch test would read back.
_REDUCTIONS = {"any", "all", "sum", "max", "min", "amax", "amin", "mean",
               "norm", "count_nonzero", "equal", "allclose"}
#: host metadata of a tensor: casting it reads nothing from the card.
_META_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda"}
_META_CALLS = {"len", "numel", "dim", "size", "element_size", "stride",
               "nelement", "data_ptr", "get_device"}
#: calls returning a boolean tensor.
_BOOL_CALLS = {"isfinite", "isnan", "isinf", "isneginf", "isposinf",
               "logical_and", "logical_or", "logical_not", "logical_xor",
               "eq", "ne", "gt", "ge", "lt", "le", "isin", "signbit"}


def _is_metadata(node: ast.AST) -> bool:
    """An expression that only reads host-side metadata or constants."""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.Subscript):
        return _is_metadata(node.value)
    if isinstance(node, ast.Attribute):
        return node.attr in _META_ATTRS
    if isinstance(node, ast.Call):
        chain = _attr_chain(node.func)
        return bool(chain) and chain[-1] in _META_CALLS
    if isinstance(node, ast.BinOp):
        return _is_metadata(node.left) and _is_metadata(node.right)
    return False


def _is_bool_expr(node: ast.AST) -> bool:
    """An expression visibly yielding a boolean tensor (or array)."""
    if isinstance(node, ast.Compare):
        return True
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Invert):
        return _is_bool_expr(node.operand)
    if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
        return _is_bool_expr(node.left) or _is_bool_expr(node.right)
    if isinstance(node, ast.Call):
        chain = _attr_chain(node.func)
        return bool(chain) and chain[-1] in _BOOL_CALLS
    return False


class HostSyncInJit(Rule):
    name = "host-sync-in-jit"
    severity = "error"
    doc = ("host read-back/synchronization inside a device region "
           "(.item()/.cpu()/.numpy()/.tolist()/synchronize()/float()/"
           "np.asarray()/nonzero/boolean masks/branch on a tensor)")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call) and ctx.in_region(node):
                yield from self._check_call(ctx, node)
            elif isinstance(node, (ast.If, ast.While)) \
                    and ctx.in_region(node):
                yield from self._check_branch(ctx, node)
            elif isinstance(node, ast.Subscript) \
                    and isinstance(node.ctx, ast.Load) \
                    and ctx.in_region(node) \
                    and self._bool_mask(ctx, node):
                yield self.finding(
                    ctx, node,
                    "boolean-mask indexing in a device region: the "
                    "result's size is a device value, so the host waits "
                    "for the mask; keep the full shape (torch.where) or "
                    "move the compaction after the wave")

    def _check_call(self, ctx: ModuleContext, node: ast.Call
                    ) -> Iterator[Finding]:
        fn = node.func
        if isinstance(fn, ast.Name) and fn.id in _HOST_CASTS and node.args:
            if not (_is_metadata(node.args[0])
                    or self._scalar_param(ctx, node, node.args[0])):
                yield self.finding(
                    ctx, node,
                    f"{fn.id}() in a device region reads its argument "
                    "back to the host (a sync per call); keep it a "
                    "tensor or hoist the cast out of the region")
            return
        if not isinstance(fn, ast.Attribute):
            return
        chain = _attr_chain(fn)
        if fn.attr in _SYNC_METHODS:
            yield self.finding(
                ctx, node,
                f".{fn.attr}() in a device region blocks on the card; "
                "return the tensor and read it after the wave")
        elif fn.attr == "to" and self._to_host(node):
            yield self.finding(
                ctx, node,
                ".to('cpu') in a device region blocks on the card; "
                "return the tensor and read it after the wave")
        elif fn.attr in _NP_SYNC and chain and chain[0] in _NP_ROOTS:
            yield self.finding(
                ctx, node,
                f"{'.'.join(chain)}() in a device region forces a "
                "device->host copy; stay in torch or move the "
                "conversion out of the region")
        elif fn.attr in _SHAPE_OPS or (
                fn.attr == "where" and chain[:1] == ["torch"]
                and len(node.args) + len(node.keywords) == 1):
            yield self.finding(
                ctx, node,
                f"{'.'.join(chain) or fn.attr}() in a device region has "
                "a data-dependent output size: the host waits for the "
                "card to size the result; keep a fixed shape")

    @staticmethod
    def _scalar_param(ctx: ModuleContext, node: ast.AST, arg: ast.AST
                      ) -> bool:
        """`arg` names a parameter of the enclosing function annotated
        as a Python scalar (``n_iter: int``): a host value."""
        fn = ctx.enclosing_function(node)
        if not isinstance(arg, ast.Name) or fn is None:
            return False
        a = fn.args
        for p in a.posonlyargs + a.args + a.kwonlyargs:
            if p.arg == arg.id:
                return isinstance(p.annotation, ast.Name) \
                    and p.annotation.id in _HOST_CASTS
        return False

    @staticmethod
    def _to_host(node: ast.Call) -> bool:
        args = list(node.args) + [kw.value for kw in node.keywords
                                  if kw.arg == "device"]
        for a in args:
            if isinstance(a, ast.Constant) and a.value == "cpu":
                return True
            if isinstance(a, ast.Call) and _attr_chain(a.func)[-1:] \
                    == ["device"] and a.args \
                    and isinstance(a.args[0], ast.Constant) \
                    and a.args[0].value == "cpu":
                return True
        return False

    def _bool_mask(self, ctx: ModuleContext, node: ast.Subscript) -> bool:
        idx = node.slice
        if _is_bool_expr(idx):
            return True
        if isinstance(idx, ast.Name):
            bound = self._local_value(ctx, node, idx.id)
            return bound is not None and _is_bool_expr(bound)
        return False

    @staticmethod
    def _local_value(ctx: ModuleContext, node: ast.AST, name: str
                     ) -> Optional[ast.AST]:
        """The value `name` is last bound to by a plain assignment in
        the function enclosing `node`, above `node` (None when unknown
        or bound more than one way)."""
        fn = ctx.enclosing_function(node)
        if fn is None:
            return None
        values = [a.value for a in ast.walk(fn)
                  if isinstance(a, ast.Assign) and a.lineno < node.lineno
                  and any(isinstance(t, ast.Name) and t.id == name
                          for t in a.targets)]
        return values[-1] if len(values) == 1 else None

    def _check_branch(self, ctx: ModuleContext, node: ast.AST
                      ) -> Iterator[Finding]:
        test = node.test  # type: ignore[attr-defined]
        kw = "if" if isinstance(node, ast.If) else "while"
        for sub in ast.walk(test):
            if isinstance(sub, ast.Call) \
                    and isinstance(sub.func, ast.Attribute):
                chain = _attr_chain(sub.func)
                if (chain and chain[0] in _ARRAY_ROOTS) \
                        or sub.func.attr in _REDUCTIONS:
                    what = ".".join(chain) or sub.func.attr
                    yield self.finding(
                        ctx, node,
                        f"`{kw}` on a tensor value ({what}(...)) in a "
                        "device region: the host waits for the card at "
                        "every test; use torch.where / a fixed iteration "
                        "count, or read a host-side mask after the wave")
                    return
