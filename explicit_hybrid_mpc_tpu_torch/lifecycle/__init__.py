"""Serving-artifact lifecycle: delta-compressed publishes.

Ported so far: ``delta.py`` (write a generation as a delta against its
published base, plan or apply it).  The revision sources and the
rebuild daemon (the JAX package's ``revision.py`` / ``service.py``)
wait for later port slices (ROADMAP A10/A13).
"""

from explicit_hybrid_mpc_tpu_torch.lifecycle.delta import (  # noqa: F401
    DeltaMismatch, apply_delta, delta_size_bytes, load_delta_plan,
    write_delta_artifact)
