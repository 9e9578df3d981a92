"""Device placement and multi-process scale-out: the solve mesh
(``mesh.make_mesh``, ``MeshSolver``), the serving shards' placement
(``mesh.serving_placement``), the process group and the staging of a
lockstep build (``distributed``), and the local launcher of a sharded
build (``launch``)."""

from explicit_hybrid_mpc_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, MeshSolver, make_mesh, serving_placement, sharded_grid_solver)
from explicit_hybrid_mpc_tpu_torch.parallel.distributed import (  # noqa: F401
    global_mesh, init_distributed, is_frontier_owner)
