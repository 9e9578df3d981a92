"""Online serving runtime: the device-resident multi-tenant arena.

- ``serve/arena.py`` -- ``DeviceArena``: many controllers' leaf tables
  in shared device buffers, one fused kernel launch per mixed-tenant
  micro-batch, two-epoch hot swap (full or delta publishes);
- ``serve/scheduler.py`` -- ``ArenaScheduler``: a deadline-aware
  queue that micro-batches every tenant's requests into one launch;
- ``serve/fallback.py`` -- ``FallbackPolicy``: degraded-mode handling
  (clamp to the certified box) with per-cause counters;
- ``serve/registry.py`` -- ``save_artifacts`` / ``root_box``: the
  artifact directories the arena publishes from.

The counterpart of the JAX package's serve/ for the arena path; the
per-controller registry, RequestScheduler and CLI wait for a later
port slice (ROADMAP A12).
"""

from __future__ import annotations

from explicit_hybrid_mpc_tpu_torch.serve.arena import (  # noqa: F401
    ArenaEvalResult, ArenaExtent, ArenaFull, DeviceArena)
from explicit_hybrid_mpc_tpu_torch.serve.fallback import FallbackPolicy  # noqa: F401
from explicit_hybrid_mpc_tpu_torch.serve.registry import (  # noqa: F401
    root_box, save_artifacts)
from explicit_hybrid_mpc_tpu_torch.serve.scheduler import (  # noqa: F401
    ArenaScheduler, ServeResult, Ticket)
