"""Device placement: the solve mesh of the batched oracle and the
serving shards' placement (the counterpart of the JAX package's
parallel/mesh.py).

The solve mesh splits the frontier's vertex-grid solve over a
(batch, delta) grid of devices:

- axis ``batch`` splits the parameter points (the frontier's unsolved
  simplex vertices): each entry solves its row block;
- axis ``delta`` splits the commutation enumeration: each entry solves
  its slice of the commutations, and the cross-commutation reduction
  V*(theta) = min_delta V_delta(theta) runs once the blocks are
  gathered.

Every block runs the oracle's own grid program (``_solve_points_grid``)
on its entry's device, so each block on a card launches the IPM leg
kernel (K1).  All blocks are launched before any is waited on, so
blocks on distinct cards overlap.  A mesh may span processes
(distributed.global_mesh): each process then solves its own entries,
and the blocks come back to every process by a host-side gather.

ContentionMonitor is re-exported here, as in the JAX package: it
samples the host the devices share (obs/host.py).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from explicit_hybrid_mpc_tpu_torch.obs.host import (  # noqa: F401
    ContentionMonitor)
from explicit_hybrid_mpc_tpu_torch.oracle.oracle import (
    DeviceProblem, _solve_points_grid, reduce_deltas)
from explicit_hybrid_mpc_tpu_torch.parallel import distributed


def local_devices() -> list[torch.device]:
    """Every CUDA device of this process, in index order (empty without
    one)."""
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


class Mesh:
    """A (batch, delta) grid of devices and the rank of the process
    that owns each entry (its device is that process's)."""

    def __init__(self, devices: np.ndarray, ranks: np.ndarray):
        self.devices = devices
        self.ranks = ranks
        self.shape = {"batch": devices.shape[0], "delta": devices.shape[1]}

    def local_entries(self) -> list[tuple[int, int]]:
        """This process's entries, batch-major."""
        me = distributed.process_index()
        return [ij for ij in np.ndindex(self.devices.shape)
                if self.ranks[ij] == me]

    @property
    def multiprocess(self) -> bool:
        """True when some entry belongs to another process."""
        me = distributed.process_index()
        return any(int(r) != me for r in self.ranks.flat)

    def __repr__(self) -> str:
        return (f"Mesh(batch={self.shape['batch']}, "
                f"delta={self.shape['delta']}, devices="
                f"{[str(d) for d in self.devices.flat]}, ranks="
                f"{self.ranks.flatten().tolist()})")


def make_mesh(shape: Optional[Sequence[int]] = None,
              devices: Optional[Sequence[torch.device]] = None,
              ranks: Optional[Sequence[int]] = None) -> Mesh:
    """Build a (batch, delta) mesh from `devices`, in order.

    ``devices=None`` takes this process's distinct CUDA devices and
    raises where the shape needs more than exist (or where there is
    none): the default never repeats a card.  An explicit list may name
    one device more than once -- a CPU mesh (``[torch.device("cpu")] *
    8``), or one card holding a mesh wider than 1 (its blocks then run
    one after another).  ``shape=None`` puts every device on the batch
    axis.  ``ranks`` names the process owning each device (default:
    this process, for every entry; distributed.global_mesh passes
    them)."""
    if devices is None:
        devices = local_devices()
        if not devices:
            raise RuntimeError(
                "make_mesh: no CUDA device (torch.cuda.device_count() is "
                "0); pass devices=[torch.device('cpu')] * n for a CPU "
                "mesh")
    devices = list(devices)
    if shape is None:
        shape = (len(devices), 1)
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    if len(shape) != 2 or n < 1:
        raise ValueError(f"mesh shape {shape}: expected (batch, delta)")
    if n > len(devices):
        raise ValueError(f"mesh shape {shape} needs {n} devices, "
                         f"have {len(devices)}")
    if ranks is None:
        ranks = [distributed.process_index()] * len(devices)
    dev = np.empty(n, dtype=object)
    dev[:] = devices[:n]
    return Mesh(dev.reshape(shape),
                np.asarray(list(ranks)[:n], dtype=np.int64).reshape(shape))


def cli_mesh(n_devices: int, backend: str) -> Mesh:
    """The CLI's ``--mesh D``: a (D, 1) mesh.  Under backend 'cpu' (or
    'serial', which the oracle then refuses) D entries of the CPU
    device; on the card D distinct cards, raising, with the count, where
    fewer exist."""
    if backend in ("cpu", "serial"):
        return make_mesh((n_devices, 1), [torch.device("cpu")] * n_devices)
    return make_mesh((n_devices, 1))


def serving_placement(n_shards: int,
                      devices: Optional[Sequence[torch.device]] = None
                      ) -> list[torch.device]:
    """Round-robin device per serving shard (online/sharded.py).

    Unlike the solve mesh, the sharded online path runs INDEPENDENT
    per-shard descents -- each shard's tables live wholly on one device
    and queries are batched per shard -- so placement is plain
    round-robin: n_shards may exceed the device count, and a one-device
    host puts every shard on its one device without a code path change.
    ``devices=None`` means every CUDA device and raises without one;
    pass ``[torch.device("cpu")]`` to place the shards on the CPU."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    devices = list(devices) if devices is not None else local_devices()
    if not devices:
        raise RuntimeError(
            "serving placement: no CUDA device (torch.cuda.device_count() "
            "is 0); pass devices=[torch.device('cpu')] to serve on the CPU")
    return [devices[s % len(devices)] for s in range(n_shards)]


def _replicate_pad_deltas(prob: DeviceProblem, n_delta_shards: int
                          ) -> tuple[DeviceProblem, int]:
    """Pad the commutation axis to a multiple of the delta mesh axis.

    Padding replicates slice 0; the caller masks the padded slices out
    of the reduction (their conv and feas flags are cleared)."""
    nd = prob.H.shape[0]
    nd_pad = -(-nd // n_delta_shards) * n_delta_shards
    if nd_pad == nd:
        return prob, nd
    reps = [torch.cat([a, a[:1].expand((nd_pad - nd,) + a.shape[1:])])
            for a in prob]
    return DeviceProblem(*reps), nd


def sharded_grid_solver(mesh: Mesh, n_iter: int, n_f32: int = 0):
    """Build the (points x deltas) block solver for `mesh`.

    Returns ``fn(probs, thetas, delta_mask) -> {(i, j): (V, conv, feas,
    grad, u0, z)}`` over this process's entries (i, j), each argument a
    dict of the same entries on their devices:

    - ``probs[(i, j)]``: the problem's commutation block j (the axis
      padded to a multiple of the delta mesh axis, see
      `_replicate_pad_deltas`);
    - ``thetas[(i, j)]``: batch block i of the points;
    - ``delta_mask[(i, j)]``: block j of the real (non-padding)
      commutations.

    Every block is launched before the function returns; nothing is
    read back."""

    # tpulint: device-region
    def fn(probs: dict, thetas: dict, delta_mask: dict) -> dict:
        out = {}
        for ij in mesh.local_entries():
            V, conv, feas, grad, u0, z = _solve_points_grid(
                probs[ij], thetas[ij], n_iter, n_f32)[:6]
            m = delta_mask[ij][None, :]
            out[ij] = (V, conv & m, feas & m, grad, u0, z)
        return out

    return fn


class MeshSolver:
    """Host-facing wrapper: pads and stages the points, solves the
    blocks over `mesh`, gathers them and reduces over the commutations.

    Drop-in for the dense grid program of Oracle.dispatch_vertices: the
    same 8-tuple (V, conv, feas, grad, u0, z, Vstar, dstar), on the
    device of this process's first entry."""

    def __init__(self, prob: DeviceProblem, mesh: Mesh, n_iter: int = 30,
                 n_f32: int = 0):
        self.mesh = mesh
        self.n_batch = mesh.shape["batch"]
        self.n_delta = mesh.shape["delta"]
        # Gather the full result only when the mesh spans processes (a
        # sharded-frontier build runs a process-local mesh inside a
        # multi-process job).
        self.multiprocess = mesh.multiprocess
        self.local = mesh.local_entries()
        if not self.local:
            raise ValueError(f"{mesh!r} has no entry of this process "
                             f"(rank {distributed.process_index()})")
        self.device = mesh.devices[self.local[0]]
        prob = DeviceProblem(*(torch.as_tensor(a) for a in prob))
        prob, self.nd = _replicate_pad_deltas(prob, self.n_delta)
        nd_pad = prob.H.shape[0]
        # The constant problem arrays are staged in their delta-split
        # layout once, not on every call.
        staged = [distributed.stage_replicated(mesh, a) for a in prob]
        self.probs = {ij: DeviceProblem(*(s[ij] for s in staged))
                      for ij in self.local}
        self.delta_mask = distributed.stage_replicated(
            mesh, torch.arange(nd_pad) < self.nd)
        self._grid = sharded_grid_solver(mesh, n_iter, n_f32)

    def pad_batch(self, P_: int) -> int:
        """Batch size: the next power of two >= P_, rounded up to a
        multiple of the batch mesh axis (the blocks are equal)."""
        pow2 = max(1, 1 << max(0, (P_ - 1).bit_length()))
        return -(-max(pow2, self.n_batch) // self.n_batch) * self.n_batch

    # tpulint: device-region
    def _gather(self, blocks: dict) -> dict:
        """Every entry's blocks on this process's first device; across
        processes through the host (gloo)."""
        if not self.multiprocess:
            return {ij: tuple(t.to(self.device) for t in b)
                    for ij, b in blocks.items()}
        host = {ij: tuple(t.cpu().numpy() for t in b)
                for ij, b in blocks.items()}
        out = {}
        for part in distributed.all_gather_object(host):
            out.update(part)
        return {ij: tuple(torch.as_tensor(a).to(self.device) for a in b)
                for ij, b in out.items()}

    def __call__(self, thetas: np.ndarray):
        thetas = np.asarray(thetas, dtype=np.float64)
        Pn = thetas.shape[0]
        Ppad = self.pad_batch(Pn)
        xpad = np.concatenate([thetas,
                               np.zeros((Ppad - Pn, thetas.shape[1]))])
        staged = distributed.stage_batch(self.mesh, xpad)
        blocks = self._gather(self._grid(self.probs, staged,
                                         self.delta_mask))
        V, conv, feas, grad, u0, z = (
            torch.cat([torch.cat([blocks[(i, j)][k]
                                  for j in range(self.n_delta)], dim=1)
                       for i in range(self.n_batch)], dim=0)
            for k in range(6))
        Vstar, dstar = reduce_deltas(V, conv)
        # Unpad points and (for per-delta outputs) padded commutations.
        nd = self.nd
        return (V[:Pn, :nd], conv[:Pn, :nd], feas[:Pn, :nd],
                grad[:Pn, :nd], u0[:Pn, :nd], z[:Pn, :nd], Vstar[:Pn],
                dstar[:Pn])
