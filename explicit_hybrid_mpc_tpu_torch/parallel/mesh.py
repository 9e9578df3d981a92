"""Device placement for the online serving shards.

The counterpart of the JAX package's parallel/mesh.py, reduced to the
one function the serving path needs.  The solve mesh (the batched
oracle sharded over devices) is ROADMAP A4 and is not here.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def local_devices() -> list[torch.device]:
    """Every CUDA device of this process, in index order (empty without
    one)."""
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def serving_placement(n_shards: int,
                      devices: Optional[Sequence[torch.device]] = None
                      ) -> list[torch.device]:
    """Round-robin device per serving shard (online/sharded.py).

    The sharded online path runs INDEPENDENT per-shard descents -- each
    shard's tables live wholly on one device and queries are batched
    per shard -- so placement is plain round-robin: n_shards may exceed
    the device count, and a one-device host puts every shard on its one
    device without a code path change.  ``devices=None`` means every
    CUDA device and raises without one; pass ``[torch.device("cpu")]``
    to place the shards on the CPU."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    devices = list(devices) if devices is not None else local_devices()
    if not devices:
        raise RuntimeError(
            "serving placement: no CUDA device (torch.cuda.device_count() "
            "is 0); pass devices=[torch.device('cpu')] to serve on the CPU")
    return [devices[s % len(devices)] for s in range(n_shards)]
