"""Device placement across local GPUs.

Only the serving placement is ported (``mesh.serving_placement``, the
round-robin shard-to-device map of the sharded descent server).  The
solve mesh (``MeshSolver``, ``sharded_grid_solver``) and the
multi-process frontier (``distributed``) wait for ROADMAP A4.
"""

from explicit_hybrid_mpc_tpu_torch.parallel.mesh import (  # noqa: F401
    serving_placement)
