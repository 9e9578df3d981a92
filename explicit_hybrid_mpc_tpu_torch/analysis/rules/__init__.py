"""The tpulint rule pack for the torch port.

Each module holds one rule class; ``all_rules()`` is the registry the
engine and the CLI share.  The rule ids are the JAX package's
(``host-sync-in-jit``, ``recompile-hazard``, ``dtype-discipline``,
``obs-in-hot-loop``, ``silent-except``), so a pragma or a baseline row
reads the same in both packages.  Adding a rule = adding a module here
and listing it below -- the CLI's ``--list-rules`` / ``--rules`` and
the package-clean test pick it up automatically.
"""

from __future__ import annotations

from explicit_hybrid_mpc_tpu_torch.analysis.engine import Rule
from explicit_hybrid_mpc_tpu_torch.analysis.rules.dtype import (
    DtypeDiscipline)
from explicit_hybrid_mpc_tpu_torch.analysis.rules.host_sync import (
    HostSyncInJit)
from explicit_hybrid_mpc_tpu_torch.analysis.rules.obs_hot import ObsInHotLoop
from explicit_hybrid_mpc_tpu_torch.analysis.rules.recompile import (
    RecompileHazard)
from explicit_hybrid_mpc_tpu_torch.analysis.rules.silent_except import (
    SilentExcept)

_RULE_CLASSES = (HostSyncInJit, RecompileHazard, DtypeDiscipline,
                 ObsInHotLoop, SilentExcept)


def all_rules() -> list[Rule]:
    return [cls() for cls in _RULE_CLASSES]


def rules_by_name() -> dict[str, Rule]:
    return {r.name: r for r in all_rules()}
