"""Online serving runtime: the single-controller request path and the
device-resident multi-tenant arena.

- ``serve/registry.py`` -- ``ControllerRegistry``: named controllers
  map to versioned ShardedDescent servers built from exported artifact
  directories (``load_artifacts``; ``save_artifacts`` writes one,
  ``root_box`` recovers the certified box), hot-swapped by a two-epoch
  handoff;
- ``serve/scheduler.py`` -- ``RequestScheduler`` (one controller of a
  registry, micro-batched under a deadline) and ``ArenaScheduler``
  (every tenant of a ``DeviceArena`` in one fused launch per batch);
- ``serve/arena.py`` -- ``DeviceArena``: many controllers' leaf tables
  in shared device buffers, full or delta publishes;
- ``serve/fallback.py`` -- ``FallbackPolicy``: degraded-mode handling
  (clamp to the certified box, optional budgeted oracle re-solve) with
  per-cause counters;
- ``serve/cli.py`` -- ``python -m explicit_hybrid_mpc_tpu_torch.main
  serve``, on the CUDA devices by default.

The counterpart of the JAX package's serve/.
"""

from __future__ import annotations

from explicit_hybrid_mpc_tpu_torch.serve.arena import (  # noqa: F401
    ArenaEvalResult, ArenaExtent, ArenaFull, DeviceArena)
from explicit_hybrid_mpc_tpu_torch.serve.fallback import FallbackPolicy  # noqa: F401
from explicit_hybrid_mpc_tpu_torch.serve.registry import (  # noqa: F401
    ControllerRegistry, ControllerVersion, root_box, save_artifacts)
from explicit_hybrid_mpc_tpu_torch.serve.scheduler import (  # noqa: F401
    ArenaScheduler, RequestScheduler, ServeResult, Ticket)
