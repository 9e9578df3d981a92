"""Device-resident multi-tenant leaf arena.

The arena packs MANY controllers' leaf tables into ONE set of shared
float32 device buffers, so a single launch of the fused kernel
(online/fused.py, csrc/arena_eval.cu) serves a mixed-tenant
micro-batch -- the counterpart of the JAX package's serve/arena.py:

- ``bary`` (p+1, p+1, C): column c holds one leaf's transposed
  barycentric matrix;
- ``U`` (p+1, C, n_u) / ``V`` (p+1, C): the vertex input/cost payloads;
- a per-controller DIRECTORY of column extents [start, start+n_cols):
  each request row carries its controller's extent into the kernel,
  which walks only those columns -- per-row routing replaces
  per-controller dispatch.

This is the ``pack_columns`` layout without the TPU's padding (vertex
rows and contraction width padded to 8, control lanes to 128): the CUDA
kernel is instantiated per p+1 and never reads outside a row's extent,
so pad rows, sentinel columns and the 128-lane ``U`` would be dead
bytes (at p=2, n_u=1 a column is 60 bytes instead of the JAX arena's
4,480).  Column spans are still allocated in 128-column granules, so
capacity accounting matches the JAX arena's.

Residency limits: one arena holds tables of a single parameter
dimension ``p`` and control width ``n_u``; capacity is fixed at
construction (``capacity_cols``) and exhaustion raises ``ArenaFull``
rather than silently evicting a tenant.

Hot swap is a two-epoch handoff: publishing a new version writes its
columns, then flips the directory entry; the old extent retires only
when its last leased batch drains.  Torch tensors are mutable (the JAX
arena's safety came from immutable arrays), so the buffers are written
IN PLACE, and three rules keep every read whole:

1. a publish writes only FREE columns -- never part of an active or
   retiring extent -- and flips the directory after the writes are
   enqueued, both under the arena lock;
2. every buffer write and every launch runs on ONE stream (the
   arena's, fixed at construction), so a launch that leased the new
   extent is ordered after the writes that filled it, whichever thread
   enqueued them;
3. ``evaluate`` releases its lease only after the device->host copy of
   its results, which the stream orders after the kernel: a span that
   retires and is freed has no pending reader.

``publish_delta`` consumes lifecycle/delta.py artifacts in O(changed)
host->device traffic: kept columns are gathered on the device from the
resident base extent, only fresh rows are uploaded (the f64 -> f32 pack
is elementwise, so the result is bitwise a full re-pack).

``device``: 'cuda' (default; the kernel serves every launch and raises
when it cannot) or 'cpu' (the kernel's plain version).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Optional

import numpy as np
import torch

from explicit_hybrid_mpc_tpu_torch import device as device_lib
from explicit_hybrid_mpc_tpu_torch import obs as obs_lib
from explicit_hybrid_mpc_tpu_torch.online import export as export_mod
from explicit_hybrid_mpc_tpu_torch.online import fused
from explicit_hybrid_mpc_tpu_torch.online.export import LeafTable

#: Column-allocation granule (the JAX arena's leaf-tile width).
_TL = 128
_BIG = fused._BIG

#: Default kernel tolerance: f32 containment scores.
DEFAULT_TOL = 1e-4


class ArenaFull(RuntimeError):
    """No free column span fits the table: grow ``capacity_cols`` or
    evict a tenant explicitly (the arena never evicts on its own)."""


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class ArenaExtent:
    """One controller version's column span + serving metadata."""

    __slots__ = ("name", "version", "epoch", "start", "n_cols",
                 "n_leaves", "n_u", "lb", "ub", "state", "_refs",
                 "_retired_evt")

    def __init__(self, name, version, epoch, start, n_cols, n_leaves,
                 n_u, lb, ub):
        self.name = name
        self.version = version
        self.epoch = epoch
        self.start = start
        self.n_cols = n_cols
        self.n_leaves = n_leaves
        self.n_u = n_u
        self.lb = np.asarray(lb, dtype=np.float64)
        self.ub = np.asarray(ub, dtype=np.float64)
        self.state = "active"
        self._refs = 0
        self._retired_evt = threading.Event()

    @property
    def end(self) -> int:
        return self.start + self.n_cols

    def __repr__(self):
        return (f"ArenaExtent({self.name}:{self.version} "
                f"cols [{self.start}, {self.end}) "
                f"L={self.n_leaves} {self.state})")


class ArenaEvalResult:
    """One fused launch's outputs, host-side (f32 kernel values).

    ``u`` is (B, n_u of the arena) -- slice ``[:, :n_u]`` per
    controller.  ``leaf`` is the controller-LOCAL leaf row (global
    column minus the row's extent start); ``served`` is the fused
    clamp+eval verdict (the clamped point landed in a leaf), ``clamped``
    whether the in-kernel clip moved the query."""

    __slots__ = ("u", "cost", "leaf", "col", "served", "clamped",
                 "versions", "n_us")

    def __init__(self, u, cost, leaf, col, served, clamped, versions,
                 n_us):
        self.u = u
        self.cost = cost
        self.leaf = leaf
        self.col = col
        self.served = served
        self.clamped = clamped
        self.versions = versions
        self.n_us = n_us


class DeviceArena:
    """Shared leaf-table buffers + controller directory (module
    docstring).  Thread-safe: directory mutations, buffer writes and
    lease counts sit behind one lock."""

    def __init__(self, p: int, n_u: int, capacity_cols: int = 4096,
                 device=None, tol: float = DEFAULT_TOL,
                 obs: "obs_lib.Obs | None" = None):
        if capacity_cols % _TL != 0 or capacity_cols <= 0:
            raise ValueError(
                f"capacity_cols={capacity_cols} must be a positive "
                f"multiple of the column granule {_TL}")
        if n_u < 1:
            raise ValueError(f"n_u={n_u} must be >= 1")
        self.device = device_lib.resolve(device)
        if self.device.type == "cuda" and not 2 <= p + 1 <= fused.MAX_K:
            raise ValueError(f"p={p}: the arena kernel takes p+1 in "
                             f"2..{fused.MAX_K}")
        self.p = int(p)
        self.n_u = int(n_u)
        self.capacity_cols = int(capacity_cols)
        self.tol = float(tol)
        self._obs = obs if obs is not None else obs_lib.NOOP
        self._lock = threading.RLock()
        self._active: dict[str, ArenaExtent] = {}
        self._retiring: list[ArenaExtent] = []
        self._free: list[tuple[int, int]] = [(0, self.capacity_cols)]
        self._epoch = 0
        pp1 = self.p + 1
        f32 = dict(dtype=torch.float32, device=self.device)
        self.bary = torch.zeros((pp1, pp1, capacity_cols), **f32)
        self.U = torch.zeros((pp1, capacity_cols, self.n_u), **f32)
        self.V = torch.zeros((pp1, capacity_cols), **f32)
        self._stream = (torch.cuda.current_stream(self.device)
                        if self.device.type == "cuda" else None)
        self._n_sm = device_lib.sm_count(self.device)
        self._scratch = fused.Scratch(self.device)
        self._ms = None
        if self._obs.enabled:
            m = self._obs.metrics
            self._ms = {
                "controllers": m.gauge("serve.arena.controllers"),
                "bytes": m.gauge("serve.arena.resident_bytes"),
                "free": m.gauge("serve.arena.free_cols"),
                "swap_us": m.histogram("serve.arena.swap_us"),
                "publishes": m.counter("serve.arena.publishes"),
                "deltas": m.counter("serve.arena.delta_publishes"),
                "launches": m.counter("serve.arena.launches"),
            }

    def _on_stream(self):
        """The arena's one stream (module docstring, rule 2)."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    # -- directory / allocation -------------------------------------------

    def _col_bytes(self) -> int:
        pp1 = self.p + 1
        return 4 * (pp1 * pp1 + pp1 * self.n_u + pp1)

    def _alloc(self, n_cols: int) -> int:
        """First-fit span from the free list (caller holds the lock)."""
        for i, (start, span) in enumerate(self._free):
            if span >= n_cols:
                if span == n_cols:
                    del self._free[i]
                else:
                    self._free[i] = (start + n_cols, span - n_cols)
                return start
        occupied = sum(e.n_cols for e in self._active.values())
        occupied += sum(e.n_cols for e in self._retiring)
        raise ArenaFull(
            f"no free span of {n_cols} columns "
            f"(capacity {self.capacity_cols}, occupied {occupied}, "
            f"largest free {max((s for _, s in self._free), default=0)}"
            "): grow capacity_cols or retire a tenant")

    def _release(self, start: int, n_cols: int) -> None:
        """Return a span to the free list, merging neighbors."""
        self._free.append((start, n_cols))
        self._free.sort()
        merged = []
        for s, n in self._free:
            if merged and merged[-1][0] + merged[-1][1] == s:
                merged[-1] = (merged[-1][0], merged[-1][1] + n)
            else:
                merged.append((s, n))
        self._free = merged

    def _retire(self, ext: ArenaExtent) -> None:
        """Caller holds the lock; refs have drained."""
        ext.state = "retired"
        self._release(ext.start, ext.n_cols)
        if ext in self._retiring:
            self._retiring.remove(ext)
        ext._retired_evt.set()
        self._gauges()

    def _gauges(self) -> None:
        if not self._ms:
            return
        with_cols = list(self._active.values()) + self._retiring
        self._ms["controllers"].set(len(self._active))
        self._ms["bytes"].set(
            sum(e.n_cols for e in with_cols) * self._col_bytes())
        self._ms["free"].set(sum(s for _, s in self._free))

    # -- publish ----------------------------------------------------------

    def _pack(self, table: LeafTable, n_cols: int):
        """pack_columns at the arena's widths: no vertex, contraction or
        lane padding (module docstring)."""
        pp1 = self.p + 1
        return fused.pack_columns(table, n_cols, pp1, pp1, self.n_u)

    def _put(self, a: np.ndarray) -> torch.Tensor:
        """One host->device copy, enqueued on the arena's stream."""
        with self._on_stream():
            return device_lib.to_device(a, self.device)

    def _install(self, name, version, n_cols, n_leaves, n_u, lb, ub, t0,
                 write, delta=False) -> ArenaExtent:
        """Allocate a free span, `write(start)` its columns, flip the
        directory (module docstring, rule 1)."""
        with self._lock:
            old = self._active.get(name)
            if old is not None and old.version == version:
                raise ValueError(
                    f"{name}: version {version!r} is already resident")
            start = self._alloc(n_cols)
            try:
                with self._on_stream():
                    write(start)
            except BaseException:
                self._release(start, n_cols)
                raise
            self._epoch += 1
            ext = ArenaExtent(name, version, self._epoch, start, n_cols,
                              n_leaves, n_u, lb, ub)
            self._active[name] = ext
            if old is not None:
                old.state = "retiring"
                if old._refs == 0:
                    self._retire(old)
                else:
                    self._retiring.append(old)
            self._gauges()
        swap_us = (time.perf_counter() - t0) * 1e6
        if self._ms:
            self._ms["swap_us"].observe(swap_us)
            self._ms["deltas" if delta else "publishes"].inc()
        self._obs.event("serve.arena.swap", controller=name,
                        version=version, start=start, n_cols=n_cols,
                        n_leaves=n_leaves, delta=bool(delta),
                        swap_us=swap_us)
        return ext

    def publish(self, name: str, version: str, table: LeafTable,
                lb: np.ndarray, ub: np.ndarray) -> ArenaExtent:
        """Pack a full leaf table into free columns and flip the
        directory entry (two-epoch: any previous version retires when
        its leases drain).  `lb`/`ub`: the certified parameter box the
        kernel clamps to (serve.registry.root_box recovers it from a
        descent artifact)."""
        t0 = time.perf_counter()
        L, pp1, _ = table.bary_M.shape
        if pp1 - 1 != self.p:
            raise ValueError(
                f"{name}: table has p={pp1 - 1}, arena holds p={self.p} "
                "(one arena serves one parameter dimension)")
        n_cols = _TL * _cdiv(L, _TL)
        blk = [self._put(a) for a in self._pack(table, n_cols)]

        def write(start):
            sl = slice(start, start + n_cols)
            self.bary[:, :, sl] = blk[0]
            self.U[:, sl, :] = blk[1]
            self.V[:, sl] = blk[2]

        return self._install(name, version, n_cols, L,
                             int(table.U.shape[2]), lb, ub, t0, write)

    def publish_from_artifacts(self, name: str, version: str,
                               dir_path: str) -> ArenaExtent:
        """Publish from a save_artifacts directory (leaf table + descent
        npz; the box comes from the descent root simplices)."""
        from explicit_hybrid_mpc_tpu_torch.online.descent import load_descent
        from explicit_hybrid_mpc_tpu_torch.serve.registry import root_box

        table = export_mod.load_leaf_table(dir_path, mmap=True)
        lb, ub = root_box(load_descent(os.path.join(dir_path,
                                                    "descent.npz")))
        return self.publish(name, version, table, lb, ub)

    def publish_delta(self, name: str, version: str, delta_dir: str,
                      base_dir: str) -> ArenaExtent:
        """O(changed) hot swap from a lifecycle/delta.py artifact.

        Kept columns are gathered ON DEVICE from the resident base
        extent (their f32 columns are bitwise the base pack); only
        fresh rows cross the host->device boundary.  Requires the base
        version to still be the active extent (DeltaMismatch otherwise)
        and transiently needs room for BOTH extents (two-epoch
        handoff)."""
        from explicit_hybrid_mpc_tpu_torch.lifecycle import delta as delta_mod

        t0 = time.perf_counter()
        plan = delta_mod.load_delta_plan(delta_dir, base_dir)
        src_idx = plan["src_idx"]
        L = plan["n_leaves"]
        n_cols = _TL * _cdiv(L, _TL)
        kept_pos = np.flatnonzero(src_idx >= 0)
        fresh_pos = np.flatnonzero(src_idx < 0)
        fresh_blk = None
        if fresh_pos.size:
            ft = LeafTable(
                bary_M=plan["fresh"]["bary_M"], U=plan["fresh"]["U"],
                V=plan["fresh"]["V"],
                delta=np.zeros(fresh_pos.size, dtype=np.int64),
                node_id=plan["fresh"]["node_id"])
            fresh_blk = [self._put(a)
                         for a in self._pack(ft, fresh_pos.size)]
        with self._lock:
            base = self._active.get(name)
            if base is None:
                raise delta_mod.DeltaMismatch(
                    f"{name}: no resident base extent to delta against")
            if plan["base_version"] is not None and \
                    base.version != plan["base_version"]:
                raise delta_mod.DeltaMismatch(
                    f"{name}: resident version {base.version!r} is not "
                    f"the delta's base {plan['base_version']!r}")
            if base.n_leaves != plan["base_n_leaves"]:
                raise delta_mod.DeltaMismatch(
                    f"{name}: resident extent has {base.n_leaves} "
                    f"leaves, delta base has {plan['base_n_leaves']}")
            src = self._put(base.start + src_idx[kept_pos])
            kept = self._put(kept_pos)
            fresh = self._put(fresh_pos)

            def write(start):
                # The base extent is active and the lock is held: its
                # columns cannot retire while they are gathered.
                dst = start + kept
                self.bary[:, :, dst] = self.bary[:, :, src]
                self.U[:, dst, :] = self.U[:, src, :]
                self.V[:, dst] = self.V[:, src]
                if fresh_blk is not None:
                    dst = start + fresh
                    self.bary[:, :, dst] = fresh_blk[0]
                    self.U[:, dst, :] = fresh_blk[1]
                    self.V[:, dst] = fresh_blk[2]
                pad = slice(start + L, start + n_cols)  # as pack_columns
                self.bary[:, :, pad] = 0.0
                self.bary[:, self.p, pad] = -_BIG
                self.U[:, pad, :] = 0.0
                self.V[:, pad] = 0.0

            n_u = int(plan["meta"].get("n_u", self.n_u))
            return self._install(name, version, n_cols, L, n_u, base.lb,
                                 base.ub, t0, write, delta=True)

    # -- leases / lifecycle ------------------------------------------------

    @contextlib.contextmanager
    def lease(self, names):
        """Pin the ACTIVE extents of `names` for one batch (two-epoch:
        a retiring extent frees its columns only after the last lease
        drains).  Yields {name: ArenaExtent}."""
        names = sorted(set(names))
        with self._lock:
            exts = {}
            for n in names:
                ext = self._active.get(n)
                if ext is None:
                    raise KeyError(
                        f"controller {n!r} is not resident in the arena")
                exts[n] = ext
            for ext in exts.values():
                ext._refs += 1
        try:
            yield exts
        finally:
            with self._lock:
                for ext in exts.values():
                    ext._refs -= 1
                    if ext.state == "retiring" and ext._refs == 0:
                        self._retire(ext)

    def retire(self, name: str) -> None:
        """Drop a tenant (columns free once current leases drain)."""
        with self._lock:
            ext = self._active.pop(name, None)
            if ext is None:
                return
            ext.state = "retiring"
            if ext._refs == 0:
                self._retire(ext)
            else:
                self._retiring.append(ext)
            self._gauges()

    def wait_retired(self, ext: ArenaExtent, timeout: float = 30.0
                     ) -> bool:
        return ext._retired_evt.wait(timeout)

    def extent(self, name: str) -> ArenaExtent:
        with self._lock:
            ext = self._active.get(name)
        if ext is None:
            raise KeyError(f"controller {name!r} is not resident")
        return ext

    def stats(self) -> dict:
        with self._lock:
            with_cols = list(self._active.values()) + self._retiring
            return {
                "controllers": len(self._active),
                "versions": {n: e.version
                             for n, e in self._active.items()},
                "resident_cols": sum(e.n_cols for e in with_cols),
                "resident_bytes": (sum(e.n_cols for e in with_cols)
                                   * self._col_bytes()),
                "capacity_cols": self.capacity_cols,
                "free_cols": sum(s for _, s in self._free),
                "retiring": len(self._retiring),
            }

    # -- evaluation --------------------------------------------------------

    def pack_queries(self, exts: dict, names, thetas: np.ndarray,
                     clamp: bool = True
                     ) -> tuple[np.ndarray, np.ndarray, int]:
        """Host side of one launch: ONE int32 buffer holding the float32
        query planes [th1; lb1; ub1] (3, B, p+1), the (B, 2) absolute
        column extents and the kernel's launch plan (its tiles;
        ``fused.split_queries`` views it), each row's extent start, and
        the plan's chunk count.  `exts` maps every row's name to its
        (leased) extent."""
        B, p = thetas.shape
        uniq, inv = np.unique(np.asarray(names, dtype=str),
                              return_inverse=True)
        ex = [exts[n] for n in uniq]
        starts = np.array([e.start for e in ex], dtype=np.int64)[inv]
        ends = starts + np.array([e.n_leaves for e in ex],
                                 dtype=np.int64)[inv]
        chunks, tiles = fused.plan_batch(np.stack([starts, ends], 1),
                                         self._n_sm)
        nq = 3 * B * (p + 1)
        buf = np.empty(nq + 2 * B + tiles.size, dtype=np.int32)
        q = buf[:nq].view(np.float32).reshape(3, B, p + 1)
        q[0, :, :p] = thetas.astype(np.float32)
        if clamp:
            q[1, :, :p] = np.stack([e.lb for e in ex]).astype(np.float32)[inv]
            q[2, :, :p] = np.stack([e.ub for e in ex]).astype(np.float32)[inv]
        else:
            q[1, :, :p] = -_BIG
            q[2, :, :p] = _BIG
        q[:, :, p] = 1.0
        ext = buf[nq:nq + 2 * B].reshape(B, 2)
        ext[:, 0] = starts
        ext[:, 1] = ends
        buf[nq + 2 * B:] = tiles.ravel()
        return buf, starts, chunks

    def evaluate(self, names, thetas: np.ndarray,
                 clamp: bool = True, tol: Optional[float] = None
                 ) -> ArenaEvalResult:
        """One fused launch over a mixed-tenant micro-batch.

        `names`: one controller name per row (a single str broadcasts).
        Rows are routed by their controller's extent.  One host->device
        put carries the query planes and extents, one device->host copy
        brings the results back.  ``clamp=False`` (FallbackPolicy mode
        'off') widens the per-row box to +-_BIG so the in-kernel clip is
        the identity.
        """
        thetas = np.asarray(thetas, dtype=np.float64)
        B, p = thetas.shape
        if p != self.p:
            raise ValueError(
                f"thetas have p={p}, arena holds p={self.p}")
        if isinstance(names, str):
            names = [names] * B
        if len(names) != B:
            raise ValueError(
                f"{len(names)} controller names for {B} rows")
        with self.lease(names) as exts:
            buf, starts, chunks = self.pack_queries(exts, names, thetas,
                                                    clamp)
            with self._on_stream():
                q, ext, tiles = fused.split_queries(self._put(buf), B, p + 1)
                with self._lock:
                    # Every launch shares the scratch (ordered by the one
                    # stream); the lock guards its growth.
                    rec = fused.arena_eval(self.bary, self.U, self.V, q, ext,
                                           fused.Plan(chunks, tiles, B),
                                           self._scratch)
                host = rec.cpu()       # waits for the kernel (rule 3)
            versions = {n: e.version for n, e in exts.items()}
            n_us = {n: e.n_u for n, e in exts.items()}
        val, col, u, cost, clamped = (a.numpy() for a in fused.unpack(host))
        tol = self.tol if tol is None else tol
        if self._ms:
            self._ms["launches"].inc()
        return ArenaEvalResult(u=u, cost=cost,
                               leaf=col.astype(np.int64) - starts, col=col,
                               served=val >= -tol, clamped=clamped,
                               versions=versions, n_us=n_us)
