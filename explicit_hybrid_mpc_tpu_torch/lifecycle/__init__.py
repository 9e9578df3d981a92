"""Continuous rebuild lifecycle: plant-drift watch -> SLA-scheduled
warm rebuild -> delta-compressed publish -> hot swap.

- ``revision.py``: the revision stream -- a ``RevisionSource``
  protocol with a simulated plant-drift driver (``DriftSource``, built
  on ``sim/simulator.py`` + ``problems/registry.py``) and a JSONL file
  source (``FileRevisionSource``) for tests and external watchers;
- ``service.py``: the supervised daemon (``RebuildService``) that
  schedules warm rebuilds (partition/rebuild.py) under a wall-clock
  SLA with priority + coalescing, publishes each generation, and
  hot-swaps it into a ``serve.ControllerRegistry`` while traffic
  flows;
- ``delta.py``: delta-compressed serving artifacts -- only the
  invalidated/new leaf rows plus a base-version provenance pointer,
  applied server-side so replicas sync in O(changed), not O(tree);
- ``cli.py``: the ``main serve-rebuild`` surface.
"""

from explicit_hybrid_mpc_tpu_torch.lifecycle.delta import (  # noqa: F401
    DeltaMismatch, apply_delta, delta_size_bytes, load_delta_plan,
    write_delta_artifact)
from explicit_hybrid_mpc_tpu_torch.lifecycle.revision import (  # noqa: F401
    DriftSource, FileRevisionSource, Revision, RevisionSource,
    plant_divergence)
from explicit_hybrid_mpc_tpu_torch.lifecycle.service import (  # noqa: F401
    LifecycleConfig, RebuildService)
