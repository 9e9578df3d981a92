"""Multi-process scale-out on torch.distributed (the counterpart of the
JAX package's parallel/distributed.py).

Two multi-process builds exist:

- the LOCKSTEP build: every process runs the SAME host frontier in
  deterministic lockstep, and the vertex-grid solves are split over a
  global (batch, delta) mesh (parallel/mesh.py ``global_mesh``).  Each
  process solves only the row blocks its own devices own; the results
  go back to every process by a host-side ``all_gather`` over the gloo
  backend, because the frontier consumes them as numpy on the host on
  every process.  Only side effects (outputs, checkpoints) belong to
  rank 0 (``is_frontier_owner``).
- the SHARDED frontier (partition/shard.py): each process owns its own
  share of the roots and exchanges cells through files; it needs only
  the process coordinates below.

gloo carries the results, not the solves: each block solves on its
own device (K1 on a card), and several ranks may share one card, which
NCCL cannot do.  Single-process runs skip initialization entirely, so
the same code serves one process and N.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch

#: Seconds a collective waits for its peers before it raises: a dead
#: peer fails the build instead of hanging it.
DEFAULT_TIMEOUT_S = 600.0


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() else None


def initialized() -> bool:
    """True when this process belongs to an initialized process group."""
    dist = _dist()
    return dist is not None and dist.is_initialized()


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> int:
    """Join the gloo process group when running multi-process; no-op
    otherwise.  Returns this process's rank (0 for a single process).

    Arguments default to the launcher's environment (parallel/launch.py
    sets them): ``MASTER_ADDR`` / ``MASTER_PORT`` (the rendezvous,
    ``tcp://MASTER_ADDR:MASTER_PORT``), ``WORLD_SIZE`` and ``RANK``.
    A world of one (or no ``WORLD_SIZE``) initializes nothing, and a
    second call returns the rank of the group already joined."""
    if initialized():
        return _dist().get_rank()
    env = os.environ
    if world_size is None and env.get("WORLD_SIZE"):
        world_size = int(env["WORLD_SIZE"])
    if rank is None and env.get("RANK"):
        rank = int(env["RANK"])
    if world_size is None or world_size <= 1:
        return 0
    if rank is None:
        raise ValueError(f"init_distributed: a world of {world_size} "
                         "needs this process's RANK")
    if init_method is None:
        addr, port = env.get("MASTER_ADDR"), env.get("MASTER_PORT")
        if not addr or not port:
            raise ValueError("init_distributed: a world of "
                             f"{world_size} needs MASTER_ADDR and "
                             "MASTER_PORT (or init_method)")
        init_method = f"tcp://{addr}:{port}"
    _dist().init_process_group(
        "gloo", init_method=init_method, world_size=world_size,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    return rank


def shutdown() -> None:
    """Leave the process group (no-op when none was joined)."""
    if initialized():
        _dist().destroy_process_group()


def process_index() -> int:
    """This process's rank: the initialized group's, else ``RANK``,
    else 0.  Touches no device."""
    if initialized():
        return int(_dist().get_rank())
    return int(os.environ.get("RANK") or 0)


def process_count() -> int:
    """The world size: the initialized group's, else ``WORLD_SIZE``,
    else 1.  Touches no device."""
    if initialized():
        return int(_dist().get_world_size())
    return int(os.environ.get("WORLD_SIZE") or 1)


def process_coords() -> dict:
    """This process's coordinates for stream identity (fleet
    telemetry): rank, world size and its local CUDA devices.  Counting
    CUDA devices initializes CUDA, so call it from entry points past
    ``init_distributed``; the obs sink's identity record uses the
    device-free probe in obs/clock.py instead."""
    n = torch.cuda.device_count()
    return {"process_index": process_index(),
            "process_count": process_count(),
            "n_local_devices": int(n),
            "local_device_ids": list(range(n))}


def is_frontier_owner() -> bool:
    """True on the process that owns checkpoint/output writing: the
    one whose ``process_index`` is 0.  The frontier STATE of a lockstep
    build runs on every process; only side effects are the owner's."""
    return process_index() == 0


def all_gather_object(obj) -> list:
    """[obj of rank 0, obj of rank 1, ...] on every rank; [obj] for a
    single process."""
    if not initialized():
        return [obj]
    out = [None] * _dist().get_world_size()
    _dist().all_gather_object(out, obj)
    return out


def local_contiguous_block(idx_map: dict, shape) -> "tuple | None":
    """(lo, hi) when this process's blocks form one contiguous,
    gap-free, equal-sized block of dim-0 rows (the JAX package's
    condition for assembling them as one slice of the host-global
    array; ``stage_batch`` here stages each entry's rows alike).
    None otherwise:

    - any block slicing a NON-leading dimension;
    - permuted/interleaved device orders whose local rows are not one
      run (e.g. a mesh built from an interleaved global device list);
    - unequal per-device row counts.

    ``idx_map`` maps each local mesh entry to its index tuple of
    slices (``addressable_indices_map``).  Replicated blocks (the
    entries of one batch row along the delta axis share one dim-0
    slice) count once."""
    blocks = []
    for idx in idx_map.values():
        if len(idx) < 1:
            return None
        for k, sl in enumerate(idx[1:], start=1):
            if (sl.start not in (None, 0)
                    or sl.stop not in (None, shape[k])
                    or sl.step not in (None, 1)):
                return None  # slices a trailing dim: not dim-0 only
        s0 = idx[0]
        if s0.step not in (None, 1):
            return None
        blocks.append((s0.start or 0,
                       shape[0] if s0.stop is None else s0.stop))
    if not blocks:
        return None
    # Deduplicate REPLICATED blocks first: every entry of one batch row
    # holds the SAME dim-0 slice -- duplicates are replication, not
    # overlap.
    blocks = sorted(set(blocks))
    sizes = {b - a for a, b in blocks}
    if len(sizes) != 1:
        return None
    expect = blocks[0][0]
    for a, b in blocks:
        if a != expect:
            return None  # gap or overlap: not one contiguous run
        expect = b
    return blocks[0][0], expect


def addressable_indices_map(mesh, shape, axis: str = "batch") -> dict:
    """{(i, j): index tuple} for this process's entries of `mesh`: the
    rows of a host-global array of `shape` split evenly along dim 0
    over the mesh's `axis` ('batch' or 'delta'), replicated along the
    other."""
    n = mesh.shape[axis]
    if shape[0] % n:
        raise ValueError(f"{shape[0]} rows do not split evenly over the "
                         f"{n} entries of the mesh's {axis} axis")
    rows = shape[0] // n
    rest = tuple(slice(None) for _ in shape[1:])
    out = {}
    for ij in mesh.local_entries():
        k = ij[0] if axis == "batch" else ij[1]
        out[ij] = (slice(k * rows, (k + 1) * rows),) + rest
    return out


def stage_batch(mesh, x: np.ndarray, dtype=torch.float64) -> dict:
    """Stage a host-global batch array for a mesh solve: {(i, j): batch
    block i of `x` on the device of entry (i, j)}, for this process's
    entries only.

    Every process of a lockstep build holds the SAME host-global `x`
    (the frontier is replicated deterministic host state) and stages
    only the blocks its own entries own, each from its own rows."""
    idx_map = addressable_indices_map(mesh, x.shape, "batch")
    return {ij: torch.as_tensor(np.ascontiguousarray(x[idx]),
                                dtype=dtype).to(mesh.devices[ij],
                                                non_blocking=True)
            for ij, idx in idx_map.items()}


def stage_replicated(mesh, x) -> dict:
    """Stage host-global constants split along the mesh's delta axis
    (the problem's commutation slices, the delta mask): {(i, j): delta
    block j of `x` on the device of entry (i, j)}, for this process's
    entries; every batch row holds the same blocks."""
    x = x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))
    idx_map = addressable_indices_map(mesh, tuple(x.shape), "delta")
    return {ij: x[idx].to(mesh.devices[ij], non_blocking=True)
            for ij, idx in idx_map.items()}


def global_mesh(shape=None, local_devices=None):
    """(batch, delta) mesh over EVERY process's devices, rank-major:
    rank 0's devices first.  ``local_devices`` are this process's (the
    default: each of its CUDA devices; the same count on every rank);
    ``shape=None`` puts them all on the batch axis.  Each process solves
    the contiguous row blocks of its own entries."""
    from explicit_hybrid_mpc_tpu_torch.parallel.mesh import (
        local_devices as cuda_devices, make_mesh)

    mine = list(local_devices) if local_devices is not None \
        else cuda_devices()
    if not mine:
        raise RuntimeError(
            "global_mesh: this process has no CUDA device; pass "
            "local_devices=[torch.device('cpu')] for a CPU mesh")
    per_rank = all_gather_object([str(d) for d in mine])
    devices, ranks = [], []
    for r, devs in enumerate(per_rank):
        own = r == process_index()
        for k, d in enumerate(devs):
            devices.append(mine[k] if own else torch.device(d))
            ranks.append(r)
    return make_mesh(shape, devices=devices, ranks=ranks)
