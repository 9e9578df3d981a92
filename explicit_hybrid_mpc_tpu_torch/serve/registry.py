"""Versioned controller registry with atomic hot swap, and the serving
artifacts on disk.

A deployed service cannot restart to pick up a freshly built tree: the
registry maps controller NAMES to versioned serving artifacts and lets
a new version swap in while traffic flows.  The swap protocol is a
**two-epoch handoff**:

1. ``publish`` installs the new version as the active epoch under the
   registry lock -- one pointer write, so a concurrent ``lease`` sees
   either the complete old version or the complete new one, never a
   torn mix.
2. The previous version moves to ``retiring``: it accepts no NEW
   leases, but every batch already leased against it drains to
   completion.  When its last lease is released the version is
   ``retired`` (its device tables go back to the caching allocator)
   and a ``serve.retired`` event records the drain.

Every swap is recorded as a ``serve.swap`` obs event (old/new version,
monotonic epoch).

Device ordering: a server's tables are staged by the loading thread
and read by a scheduler's worker thread.  ``ShardedDescent``
synchronizes its devices once its tables are staged, before
``publish`` can make it leasable; every copy and launch of the serving
path runs on the device's one default stream, so a retired version's
memory is reused in stream order.

Artifacts are the flat files the online stage deploys from (the
online/export.py leaf table + the online/descent.py ``descent.npz``;
the pickled Tree is never needed), the same directory layout the JAX
package's serve/registry.py writes and reads: ``load_artifacts``
builds a ShardedDescent server straight from a directory,
``save_artifacts`` writes one from a built tree, and ``root_box``
recovers the certified box from the descent arrays.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Optional

import numpy as np
import torch

from explicit_hybrid_mpc_tpu_torch import obs as obs_lib
from explicit_hybrid_mpc_tpu_torch.faults import injector as faults_inj

#: Default drain-wait budget (seconds) before ``wait_retired`` gives
#: up and emits ``health.lease_leak``: a retiring version still leased
#: after this long almost certainly belongs to a dead thread (the
#: lease release runs in the context manager's finally, so only a
#: thread killed MID-LEASE can leak one).
DEFAULT_RETIRE_WAIT_S = 30.0


class ControllerVersion:
    """One published (name, version): the built server + lease state.

    Lease accounting is owned by the registry (all mutations happen
    under the registry lock); readers treat instances as opaque handles
    carrying ``.server`` and ``.version``."""

    __slots__ = ("name", "version", "server", "state", "_refs",
                 "_retired_evt", "epoch")

    def __init__(self, name: str, version: str, server, epoch: int):
        self.name = name
        self.version = version
        self.server = server
        self.state = "active"          # active | retiring | retired
        self._refs = 0
        self._retired_evt = threading.Event()
        self.epoch = epoch

    @property
    def in_flight(self) -> int:
        return self._refs

    def __repr__(self) -> str:  # debugging / event payloads
        return (f"ControllerVersion({self.name}:{self.version} "
                f"{self.state}, refs={self._refs})")


class ControllerRegistry:
    """Name -> versioned controller map with atomic hot swap.

    Thread-safe: ``lease`` is the read path (scheduler worker threads),
    ``publish`` the write path (a deploy thread).  Both touch only the
    registry lock for pointer-swap-sized critical sections -- the
    device evaluation itself runs outside the lock."""

    def __init__(self, obs: "obs_lib.Obs | None" = None):
        self._lock = threading.Lock()
        self._active: dict[str, ControllerVersion] = {}
        self._retiring: dict[str, list[ControllerVersion]] = {}
        self._epoch = 0
        self._obs = obs if obs is not None else obs_lib.NOOP
        self._ms = None
        if self._obs.enabled:
            m = self._obs.metrics
            self._ms = {"swaps": m.counter("serve.swaps"),
                        "live": m.gauge("serve.versions_live")}

    # -- write path --------------------------------------------------------

    def publish(self, name: str, version: str, server
                ) -> ControllerVersion:
        """Install `server` as the active version of `name` (atomic);
        the previous version (if any) retires after its in-flight
        leases drain.  Returns the new version handle.

        A scripted publish fault (faults/plan.py ``registry.publish``
        site) fires BEFORE any mutation: an injected swap crash leaves
        the registry serving the old version intact.

        The parameter width is an INVARIANT of the controller name:
        publishing a version whose descent table has a different p
        raises (queued submissions are width-validated against the
        active version at submit time; a different-width tree is a
        different controller -- deploy it under a new name)."""
        faults_inj.fire("registry.publish", label=name)
        retire_now = None
        with self._lock:
            old = self._active.get(name)
            p_old = self._param_dim_of(old)
            p_new = self._param_dim_of(server)
            if p_old is not None and p_new is not None \
                    and p_old != p_new:
                raise ValueError(
                    f"version {version!r} has parameter dim {p_new} "
                    f"but controller {name!r} serves dim {p_old}: "
                    "deploy a different-width tree under a new "
                    "controller name")
            self._epoch += 1
            new = ControllerVersion(name, version, server, self._epoch)
            self._active[name] = new
            if old is not None:
                old.state = "retiring"
                if old._refs == 0:
                    retire_now = old
                else:
                    self._retiring.setdefault(name, []).append(old)
            n_live = self._n_live_locked()
        # Events outside the lock: the sink takes its own lock and a
        # slow obs file must never serialize the serving swap path.
        self._obs.event("serve.swap", controller=name,
                        to_version=version,
                        from_version=old.version if old else None,
                        epoch=new.epoch,
                        draining=0 if retire_now or old is None
                        else old._refs)
        if self._ms:
            self._ms["swaps"].inc()
            self._ms["live"].set(n_live)
        if retire_now is not None:
            self._retire(retire_now)
        return new

    def _retire(self, ver: ControllerVersion) -> None:
        ver.state = "retired"
        ver._retired_evt.set()
        self._obs.event("serve.retired", controller=ver.name,
                        version=ver.version, epoch=ver.epoch)

    def _n_live_locked(self) -> int:
        return (len(self._active)
                + sum(len(v) for v in self._retiring.values()))

    # -- read path ---------------------------------------------------------

    @contextlib.contextmanager
    def lease(self, name: str):
        """Context manager yielding the ACTIVE version; the version
        cannot retire while leased (two-epoch handoff), so one leased
        batch always evaluates entirely against one tree."""
        with self._lock:
            ver = self._active.get(name)
            if ver is None:
                raise KeyError(f"no controller {name!r} published "
                               f"(known: {sorted(self._active)})")
            ver._refs += 1
        try:
            yield ver
        finally:
            retire = None
            n_live = 0
            with self._lock:
                ver._refs -= 1
                if ver.state == "retiring" and ver._refs == 0:
                    retire = ver
                    lst = self._retiring.get(name)
                    if lst is not None and ver in lst:
                        lst.remove(ver)
                    n_live = self._n_live_locked()
            if retire is not None:
                self._retire(retire)
                if self._ms:
                    self._ms["live"].set(n_live)

    def active_version(self, name: str) -> Optional[str]:
        with self._lock:
            ver = self._active.get(name)
            return ver.version if ver else None

    @staticmethod
    def _param_dim_of(obj) -> Optional[int]:
        """Parameter width of a server (or a ControllerVersion's
        server): root_bary is (R, p+1, p+1).  None when absent."""
        server = getattr(obj, "server", obj)
        rb = getattr(server, "root_bary", None)
        return None if rb is None else int(rb.shape[-1]) - 1

    def param_dim(self, name: str) -> Optional[int]:
        """Parameter width of the controller's descent tables (a
        publish-enforced invariant of the name); None when the
        controller is unpublished or its server carries no root_bary.
        The scheduler validates submissions against this."""
        with self._lock:
            ver = self._active.get(name)
        return None if ver is None else self._param_dim_of(ver)

    def controllers(self) -> list[str]:
        with self._lock:
            return sorted(self._active)

    def wait_retired(self, ver: ControllerVersion,
                     timeout: Optional[float] = None) -> bool:
        """Block until `ver` has fully drained; True when retired within
        `timeout` (default DEFAULT_RETIRE_WAIT_S).  On expiry a
        ``health.lease_leak`` event names the version and its
        outstanding lease count, and False is returned so the caller
        can decide (alert, or keep waiting with a longer timeout)."""
        if timeout is None:
            timeout = DEFAULT_RETIRE_WAIT_S
        if ver._retired_evt.wait(timeout):
            return True
        self._obs.event(
            "health.lease_leak", severity="warn",
            controller=ver.name, version=ver.version,
            value=ver.in_flight, threshold=timeout,
            msg=f"version {ver.name}:{ver.version} still holds "
                f"{ver.in_flight} lease(s) {timeout:g}s after "
                "retirement began: a scheduler thread likely died "
                "mid-batch; the version stays pinned until its leases "
                "release")
        return False

    # -- artifact loading --------------------------------------------------

    def load_artifacts(self, name: str, version: str, dir_path: str,
                       n_shards: Optional[int] = None,
                       router=None, max_bucket: Optional[int] = None,
                       granularity: int = 8,
                       expect_provenance: Optional[dict] = None,
                       strict: bool = False,
                       devices=None) -> ControllerVersion:
        """Build a ShardedDescent server from an exported artifact
        directory (save_artifacts layout: leaf-table ``<field>.npy``
        files + ``descent.npz``) and publish it.  Loading happens
        OUTSIDE the registry lock -- a large memmap'd table must not
        stall live lease traffic -- so two racing loads of the same
        name resolve by publish order.  `devices`: where the shards
        live (None = every CUDA device, raising without one;
        ``[torch.device("cpu")]`` on request).

        ``expect_provenance``/``strict``: deploy-time stamp check
        (partition/provenance.py) -- a serving deploy against a tree
        built for a different problem/eps warns by default and raises
        under strict, BEFORE the version reaches traffic."""
        from explicit_hybrid_mpc_tpu_torch.online import descent as descent_mod
        from explicit_hybrid_mpc_tpu_torch.online import export as export_mod
        from explicit_hybrid_mpc_tpu_torch.online import sharded as sharded_mod

        table = export_mod.load_leaf_table(
            dir_path, expect_provenance=expect_provenance, strict=strict)
        dt = descent_mod.load_descent(
            os.path.join(dir_path, "descent.npz"))
        server = sharded_mod.shard_descent(
            dt, table, n_shards=n_shards, devices=devices, router=router,
            granularity=granularity, max_bucket=max_bucket,
            obs=self._obs)
        return self.publish(name, version, server)


def save_artifacts(tree, roots, dir_path: str,
                   provenance: Optional[dict] = None,
                   checksum: bool = True) -> None:
    """Export a built tree as one serving artifact directory: the
    memmap-streamed leaf table (online/export.write_leaf_table) plus
    the descent arrays as ``descent.npz``.  RSS stays O(chunk);
    ``checksum=False`` skips the per-field sha256 re-read pass.  The
    build-provenance stamp (default: the tree's own) rides the table's
    meta.json.

    Write order is crash-safe: the table fields AND descent.npz land
    first, the meta.json commit marker LAST (export.commit_leaf_table)
    -- a crash anywhere mid-export leaves an uncommitted directory,
    never a 'valid' table next to a missing or stale descent file."""
    from explicit_hybrid_mpc_tpu_torch.online import descent as descent_mod
    from explicit_hybrid_mpc_tpu_torch.online import export as export_mod

    if provenance is None:
        provenance = getattr(tree, "provenance", None)
    table = export_mod.write_leaf_table(tree, dir_path,
                                        provenance=provenance,
                                        commit=False)
    dt = descent_mod.export_descent(tree, roots, table, stage=False)
    descent_mod.save_descent(dt, os.path.join(dir_path, "descent.npz"))
    export_mod.commit_leaf_table(dir_path, table.n_leaves, tree.p,
                                 tree.n_u, provenance,
                                 checksum=checksum)


def root_box(dt) -> tuple[np.ndarray, np.ndarray]:
    """(lb, ub) bounding box of the root simplices of anything carrying
    a ``root_bary`` field (a DescentTable, host or staged, or a
    ShardedDescent).

    The serving artifacts deliberately omit the problem object, but the
    fallback clamp needs the certified box.  Each root's barycentric
    matrix M satisfies inv(M) = [[V^T], [1]] (lam = M @ [theta; 1]), so
    the root vertices are recoverable from the table alone."""
    M = dt.root_bary
    if isinstance(M, torch.Tensor):
        M = M.cpu().numpy()
    inv = np.linalg.inv(np.asarray(M, dtype=np.float64))  # (R, p+1, p+1)
    verts = inv[:, :-1, :]  # (R, p, p+1): column k = vertex k
    return verts.min(axis=(0, 2)), verts.max(axis=(0, 2))
