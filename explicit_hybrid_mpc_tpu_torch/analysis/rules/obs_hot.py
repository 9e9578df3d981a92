"""obs-in-hot-loop: observability emission inside a device region.

The obs subsystem's contract is host-side: sinks take plain dicts,
metric objects mutate Python state under a lock.  Called from inside a
device region they take the lock and format records between launches
(the host falls behind the card it should be feeding), tempt a
``.item()`` of the value they report (a sync), and -- inside a compiled
or graph-captured body -- run once at capture time and then never
again, so the counter undercounts by exactly the replay count.
Emission belongs in host code around the wave (frontier.step's
post-consume block).  The JAX rule's receivers and methods, with
``torch`` among the array roots.
"""

from __future__ import annotations

import ast
from typing import Iterator

from explicit_hybrid_mpc_tpu_torch.analysis.engine import (
    Finding, ModuleContext, Rule, _attr_chain)

#: method names that are unambiguously obs emission.
_EMIT_METHODS = {"emit", "event", "observe", "span", "flush_metrics", "inc"}
#: object-chain segments that mark the receiver as an obs handle.
_OBS_SEGMENTS = {"obs", "metrics", "sink", "recorder", "tracer"}
#: roots whose methods share names with the above but are array math
#: (torch.log, math.log, ...): never obs receivers.
_ARRAY_ROOTS = {"np", "numpy", "torch", "math", "scipy"}


class ObsInHotLoop(Rule):
    name = "obs-in-hot-loop"
    severity = "error"
    doc = ("sink/metric emission inside a device region -- host work "
           "between launches, or once at capture time in a compiled or "
           "graph-captured body; emit from host code after the wave")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and ctx.in_region(node)):
                continue
            chain = _attr_chain(node.func)
            if chain and chain[0] in _ARRAY_ROOTS:
                continue
            receiver = chain[:-1] if chain else []
            if node.func.attr in _EMIT_METHODS \
                    or any(seg in _OBS_SEGMENTS for seg in receiver):
                yield self.finding(
                    ctx, node,
                    f"{'.'.join(chain) or node.func.attr}(...) inside a "
                    "device region: host work between launches (or once "
                    "at capture time in a compiled body); emit from host "
                    "code after the wave")
