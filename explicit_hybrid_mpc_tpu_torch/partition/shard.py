"""Sharded frontier: per-process shard contexts, cross-process vertex
dedup, and shard-tree merging (the counterpart of the JAX package's
partition/shard.py; numpy and files only).

The lockstep multi-process build (parallel/distributed.py) replays the
IDENTICAL host frontier on every process: N processes pay N copies of
the plan/certify/commit wall and the only parallelism is inside the
mesh-sharded vertex solves.  This module shards the FRONTIER itself:
each process owns a subset of the root simplices (round-robin over the
canonical Kuhn-triangulation order) and runs the ordinary pipelined
engine over its own subtrees, with its oracle on its own device -- no
per-step collectives, no replicated host work.

Cross-process vertex dedup: bisection midpoints on the face shared by
two shards' root regions are needed by both.  A deterministic OWNERSHIP
HASH over the vertex cache key assigns every (vertex, delta) cell to
exactly one shard (all commutations of a vertex are co-owned, so the
owner can serve a full-enumeration need through the same dense-grid
program the single-process build uses -- the (vertex, delta) cell
remains the dedup/transfer unit: requests and publications carry
per-delta masks).  A shard needing a remotely-owned cell posts an
asynchronous REQUEST into the shared exchange directory and keeps
pipelining; the owner answers requests between its own steps, solving
on-behalf cells it never needed itself, and PUBLISHES result rows that
any shard can consume.  Two shards can therefore never solve the same
(vertex, delta) program: summed ``oracle.point_solves`` across shards
equals the single-process build's count exactly.

The exchange is plain files under one shared directory (request
journals + atomically-renamed result batches + done markers) and --
critically -- it is ASYNCHRONOUS: no step of any shard ever blocks on
a collective; a shard blocks only when its own batch's certificates
need a remote cell that has not landed yet, and even then it keeps
serving its peers while it waits (deadlock-free by construction).
Filesystem requirements: a local FS / tmpfs or a POSIX-COHERENT shared
mount where one client's appends/renames become visible to others
without a close (an object-store fuse mount that uploads only on close
does NOT qualify -- its visibility latency turns every cross-shard cell
into a shard_timeout_s stall followed by a loud local fallback, sound
but slow and duplicate-counting).

Shard coordinates come from an initialized torch.distributed group,
else from the launcher's RANK / WORLD_SIZE (parallel/launch.py), unless
the config names them.  The ownership hash is the JAX package's
(blake2b over the same key bytes), so both packages assign every cell
to the same shard.

Tree contract: the merged tree is node-for-node identical to the
single-process build -- vertices bitwise (bisection arithmetic is
exact), same leaf sets, same certification statuses and commutation
choices -- compared canonically (by vertex-matrix bytes; the merged
insertion ORDER is per-shard-subtree, not breadth-first interleaved).
Leaf payload floats may differ in the last bits (a remote cell is
solved inside the owner's batch, and exchange rows carry no warm-start
duals), which the eps margin absorbs.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
import warnings
import zipfile

import numpy as np

from explicit_hybrid_mpc_tpu_torch.partition.tree import NO_CHILD, Tree
from explicit_hybrid_mpc_tpu_torch.utils import atomic


def shard_owner(key: bytes, n_shards: int) -> int:
    """Deterministic owner shard of a vertex cache key.

    Stable across processes, runs, and platforms (blake2b over the
    exact key bytes -- no PYTHONHASHSEED dependence), and independent
    of which shard asks: every (vertex, delta) cell is assigned to
    exactly one shard for ANY process count, because all delta cells
    of a vertex share the vertex's owner.  Per-vertex (not per-cell)
    granularity is deliberate: a full-enumeration need then stays one
    dense-grid program on one owner instead of splintering into
    per-delta pair programs across shards -- the same program family
    the single-process build dispatches (the bit-parity route-match
    argument in partition/pipeline.py is family-exact)."""
    if n_shards <= 1:
        return 0
    h = hashlib.blake2b(key, digest_size=8).digest()
    return int.from_bytes(h, "little") % n_shards


def owned_root_indices(n_roots: int, shard: int, n_shards: int) -> list:
    """Root indices owned by `shard`: round-robin over the canonical
    root order (deterministic; every root owned by exactly one
    shard)."""
    return [r for r in range(n_roots) if r % n_shards == shard]


# -- cross-host exchange ----------------------------------------------------


class ShardExchange:
    """Asynchronous file-based cell exchange under one shared directory.

    Layout (all writers atomic-rename or append-only, so readers never
    see a torn record as anything but a retriable tail):

    - ``req.p<i>.jsonl``   -- shard i's request journal (append-only
      JSON lines ``{"k": hex-key, "t": [exact theta], "d": [deltas]}``;
      JSON floats round-trip exactly in python, so the owner solves at
      the requester's EXACT coordinates, not the rounded cache key).
    - ``pub.p<i>.<seq>.npz`` -- result batches published by shard i
      (tmp + rename; per-row delta masks, merged idempotently by every
      consumer).
    - ``done.p<i>.json``   -- shard i's frontier-drained marker,
      written AFTER its tree file (the TREE's commit marker; the
      stats file intentionally lands LATER, after the all-shards
      drain barrier, so on-behalf solves served while draining are in
      it -- consumers wait for stats.p<i>.json itself, as finalize's
      second barrier does).
    - ``tree.p<i>.pkl`` / ``stats.p<i>.json`` -- shard results the
      merge consumes.
    """

    def __init__(self, directory: str, shard: int, n_shards: int):
        self.dir = directory
        self.shard = int(shard)
        self.n_shards = int(n_shards)
        os.makedirs(directory, exist_ok=True)
        # key -> {"mask","V","conv","grad","u0","z","lam","s"} merged
        # over every publication seen (and everything this shard
        # published itself).
        self.rows: dict[bytes, dict] = {}
        self._req_path = os.path.join(directory, f"req.p{shard}.jsonl")
        self._req_f = None
        self._req_off: dict[str, int] = {}
        self._pub_seq = 0
        self._seen_pubs: set[str] = set()
        # Per-peer next expected publication sequence + torn-read
        # retries (see _new_pub_paths/poll).
        self._peer_seq: dict[int, int] = {}
        self._retry_pubs: list[str] = []
        # key -> delta mask already requested (request once per cell).
        self._req_mask: dict[bytes, np.ndarray] = {}
        # key -> delta mask already published (publish once per cell).
        self._pub_mask: dict[bytes, np.ndarray] = {}
        # Crash/resume recovery: reload THIS shard's own prior
        # publications (each file is an atomic whole) so a restarted
        # owner (a) continues the sequence instead of overwriting
        # files peers already consumed -- their dedup is by basename
        # and their sequence cursors are already past it, so the
        # overwrite would silently orphan every later answer -- and
        # (b) serves re-read requests from the recovered store instead
        # of re-solving cells it already published (the zero-duplicate
        # bar).  Peer publications re-ingest from zero via poll();
        # merging is idempotent.
        self._recover_own_publications()

    def _recover_own_publications(self) -> None:
        seq = 0
        while True:
            path = os.path.join(self.dir,
                                f"pub.p{self.shard}.{seq:06d}.npz")
            if not os.path.exists(path):
                break
            try:
                with np.load(path) as zf:
                    keys = zf["keys"]
                    lam = zf["lam"] if "lam" in zf.files else None
                    s = zf["s"] if "s" in zf.files else None
                    for i in range(keys.shape[0]):
                        key = keys[i].tobytes()
                        self.merge_row(
                            key, zf["mask"][i], zf["V"][i],
                            zf["conv"][i], zf["grad"][i], zf["u0"][i],
                            zf["z"][i],
                            lam[i] if lam is not None else None,
                            s[i] if s is not None else None)
                        self._pub_mask[key] = \
                            self.rows[key]["mask"].copy()
            except (OSError, ValueError, KeyError,
                    zipfile.BadZipFile):
                pass  # a torn own file: sequence past it regardless
            self._seen_pubs.add(os.path.basename(path))
            seq += 1
        self._pub_seq = seq

    # -- paths -------------------------------------------------------------

    def tree_path(self, shard: int | None = None) -> str:
        s = self.shard if shard is None else shard
        return os.path.join(self.dir, f"tree.p{s}.pkl")

    def stats_path(self, shard: int | None = None) -> str:
        s = self.shard if shard is None else shard
        return os.path.join(self.dir, f"stats.p{s}.json")

    def done_path(self, shard: int | None = None) -> str:
        s = self.shard if shard is None else shard
        return os.path.join(self.dir, f"done.p{s}.json")

    def hb_path(self, shard: int | None = None) -> str:
        s = self.shard if shard is None else shard
        return os.path.join(self.dir, f"hb.p{s}")

    #: Seconds between heartbeat-file touches (liveness for the drain
    #: barrier -- an interior-crunching shard may generate no exchange
    #: traffic for hours).
    HB_EVERY_S = 5.0

    def heartbeat(self) -> None:
        """Touch this shard's liveness marker, throttled."""
        now = time.monotonic()
        if now - getattr(self, "_hb_last", 0.0) < self.HB_EVERY_S:
            return
        self._hb_last = now
        try:
            with open(self.hb_path(), "a") as f:
                f.write(".")  # append: size growth is visible even on
                # mounts that cache utime-only changes
        except OSError:
            pass  # liveness is best-effort; the deadline still bounds

    def peer_heartbeats(self) -> tuple:
        """Fingerprint of every peer's liveness marker (sizes +
        mtimes); any change means some peer is alive and making
        progress."""
        out = []
        for s in range(self.n_shards):
            if s == self.shard:
                continue
            try:
                st = os.stat(self.hb_path(s))
                out.append((s, st.st_size, st.st_mtime))
            except OSError:
                out.append((s, -1, -1.0))
        return tuple(out)

    # -- requests ----------------------------------------------------------

    def request(self, key: bytes, theta: np.ndarray,
                need: np.ndarray) -> int:
        """Post an asynchronous request for the deltas of `key` in mask
        `need` not yet requested; returns how many new cells were
        posted.  Append + flush (no fsync: same-host readers see the
        page cache; durability is not required -- a crashed requester
        re-requests on resume)."""
        prev = self._req_mask.get(key)
        new = need if prev is None else (need & ~prev)
        if not new.any():
            return 0
        if self._req_f is None:
            self._req_f = open(self._req_path, "a")
        rec = {"k": key.hex(), "t": np.asarray(theta).tolist(),
               "d": np.nonzero(new)[0].tolist()}
        self._req_f.write(json.dumps(rec) + "\n")
        self._req_f.flush()
        self._req_mask[key] = new if prev is None else (prev | new)
        return int(new.sum())

    def read_requests(self, nd: int) -> list[tuple[bytes, np.ndarray,
                                                   np.ndarray]]:
        """New request records from every PEER journal since the last
        read, merged per key: [(key, theta, delta mask)].  A torn tail
        line (a peer mid-write) is left unconsumed for the next poll."""
        merged: dict[bytes, tuple[np.ndarray, np.ndarray]] = {}
        for s in range(self.n_shards):
            if s == self.shard:
                continue
            path = os.path.join(self.dir, f"req.p{s}.jsonl")
            try:
                size = os.path.getsize(path)
            except OSError:
                continue
            off = self._req_off.get(path, 0)
            if size <= off:
                continue
            with open(path, "rb") as f:
                f.seek(off)
                buf = f.read(size - off)
            end = buf.rfind(b"\n")
            if end < 0:
                continue  # only a torn tail so far
            self._req_off[path] = off + end + 1
            for ln in buf[:end].split(b"\n"):
                if not ln.strip():
                    continue
                try:
                    rec = json.loads(ln)
                except json.JSONDecodeError:
                    continue  # torn mid-journal line: skip, peers retry
                key = bytes.fromhex(rec["k"])
                theta = np.asarray(rec["t"], dtype=np.float64)
                mask = np.zeros(nd, dtype=bool)
                mask[np.asarray(rec["d"], dtype=np.int64)] = True
                if key in merged:
                    merged[key] = (merged[key][0], merged[key][1] | mask)
                else:
                    merged[key] = (theta, mask)
        return [(k, t, m) for k, (t, m) in merged.items()]

    # -- publications ------------------------------------------------------

    def merge_row(self, key: bytes, mask: np.ndarray, V, conv, grad,
                  u0, z, lam=None, s=None) -> None:
        """Merge per-delta cells (valid where `mask`) into the in-memory
        store row for `key` (idempotent; later merges overwrite the
        same cells with the same values)."""
        row = self.rows.get(key)
        if row is None:
            nd = mask.shape[0]
            row = self.rows[key] = {
                "mask": np.zeros(nd, dtype=bool),
                "V": np.full(nd, np.inf),
                "conv": np.zeros(nd, dtype=bool),
                "grad": np.zeros((nd,) + np.shape(grad)[1:]),
                "u0": np.zeros((nd,) + np.shape(u0)[1:]),
                "z": np.zeros((nd,) + np.shape(z)[1:]),
                "lam": (np.zeros((nd,) + np.shape(lam)[1:])
                        if lam is not None else None),
                "s": (np.zeros((nd,) + np.shape(s)[1:])
                      if s is not None else None),
            }
        ds = np.nonzero(mask)[0]
        row["mask"][ds] = True
        row["V"][ds] = np.asarray(V)[ds]
        row["conv"][ds] = np.asarray(conv)[ds]
        row["grad"][ds] = np.asarray(grad)[ds]
        row["u0"][ds] = np.asarray(u0)[ds]
        row["z"][ds] = np.asarray(z)[ds]
        if lam is not None and row["lam"] is not None:
            row["lam"][ds] = np.asarray(lam)[ds]
            row["s"][ds] = np.asarray(s)[ds]

    def publish(self, items: list[tuple[bytes, np.ndarray]]) -> int:
        """Publish store rows for `items` = [(key, requested mask)]:
        each row ships its full currently-available mask (consumers
        merge idempotently), but a cell already published is never
        re-shipped -- `_pub_mask` keeps publications append-only in
        coverage.  Returns rows actually written."""
        out_keys, out_rows = [], []
        for key, req in items:
            row = self.rows.get(key)
            if row is None:
                continue
            prev = self._pub_mask.get(key)
            fresh = (req & row["mask"]) if prev is None else \
                (req & row["mask"] & ~prev)
            if not fresh.any():
                continue
            self._pub_mask[key] = row["mask"].copy()
            out_keys.append(np.frombuffer(key, dtype=np.uint8))
            out_rows.append(row)
        if not out_keys:
            return 0
        arrs = {
            "keys": np.stack(out_keys),
            "mask": np.stack([r["mask"] for r in out_rows]),
            "V": np.stack([r["V"] for r in out_rows]),
            "conv": np.stack([r["conv"] for r in out_rows]),
            "grad": np.stack([r["grad"] for r in out_rows]),
            "u0": np.stack([r["u0"] for r in out_rows]),
            "z": np.stack([r["z"] for r in out_rows]),
        }
        if out_rows[0]["lam"] is not None:
            arrs["lam"] = np.stack([r["lam"] for r in out_rows])
            arrs["s"] = np.stack([r["s"] for r in out_rows])
        path = os.path.join(
            self.dir, f"pub.p{self.shard}.{self._pub_seq:06d}.npz")
        self._pub_seq += 1
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **arrs)
            f.flush()
        os.replace(tmp, path)  # readers only ever see whole files
        self._seen_pubs.add(os.path.basename(path))
        return len(out_rows)

    def _new_pub_paths(self) -> list[str]:
        """Unconsumed publication files, probed by each peer's next
        expected sequence number -- O(n_shards + new files) per call
        instead of an O(all files) directory glob, which matters
        because poll() runs every POLL_S inside a blocked collect()
        (and on the NFS/GCS-fuse mounts the exchange targets, a
        directory listing is a server round-trip)."""
        out: list[str] = []
        for s in range(self.n_shards):
            if s == self.shard:
                continue
            seq = self._peer_seq.get(s, 0)
            while True:
                path = os.path.join(self.dir,
                                    f"pub.p{s}.{seq:06d}.npz")
                if not os.path.exists(path):
                    break
                out.append(path)
                seq += 1
            self._peer_seq[s] = seq
        return out

    def poll(self) -> int:
        """Load publications from peers not yet consumed; returns rows
        merged into the store."""
        n = 0
        retry = []
        for path in self._new_pub_paths() + self._retry_pubs:
            base = os.path.basename(path)
            if base in self._seen_pubs:
                continue
            try:
                with np.load(path) as zf:
                    keys = zf["keys"]
                    lam = zf["lam"] if "lam" in zf.files else None
                    s = zf["s"] if "s" in zf.files else None
                    for i in range(keys.shape[0]):
                        self.merge_row(
                            keys[i].tobytes(), zf["mask"][i], zf["V"][i],
                            zf["conv"][i], zf["grad"][i], zf["u0"][i],
                            zf["z"][i],
                            lam[i] if lam is not None else None,
                            s[i] if s is not None else None)
                        n += 1
            except (OSError, ValueError, KeyError,
                    zipfile.BadZipFile):
                # A reader racing the writer's rename never sees a torn
                # file on POSIX, but a remote/fuse mount may: retry on
                # the next poll (the sequence probe has already moved
                # past it, so it rides the explicit retry list).
                retry.append(path)
                continue
            self._seen_pubs.add(base)
        self._retry_pubs = retry
        return n

    def close(self) -> None:
        if self._req_f is not None:
            self._req_f.close()
            self._req_f = None


# -- engine-facing context --------------------------------------------------


class ShardContext:
    """Bridges one FrontierEngine to the exchange: root ownership,
    remote-cell routing during planning, blocking collection at
    certify time, and the on-behalf request server.

    Built by the engine when ``cfg.shard_frontier`` resolves to an
    active multi-shard run; ``from_config`` returns None otherwise, so
    the single-process path carries a literal None-check and nothing
    else."""

    #: Poll interval while blocked on a remote cell (seconds).
    POLL_S = 0.001

    def __init__(self, eng, shard: int, n_shards: int, directory: str,
                 timeout_s: float = 300.0):
        self.eng = eng
        self.shard = int(shard)
        self.n_shards = int(n_shards)
        self.timeout_s = float(timeout_s)
        self._claim_dir(directory)
        self.ex = ShardExchange(directory, shard, n_shards)
        self.remote_cells = 0     # cells consumed from peers
        self.served_cells = 0     # on-behalf cells solved for peers
        self.fallback_cells = 0   # remote cells solved locally (timeout)

    def _claim_dir(self, directory: str) -> None:
        """Bind the exchange directory to THIS build's identity.

        Exchange state survives crashes on purpose (publication
        recovery, request journals), so a REUSED directory from a
        DIFFERENT problem/eps/shard-count would serve rows solved for
        another program -- keyed only by rounded theta coordinates,
        they would merge silently and corrupt certificates.  The first
        shard writes a manifest (problem content hash + eps + shard
        count); every shard verifies it and refuses a mismatch with a
        clear message.  A same-build restart matches and proceeds."""
        from explicit_hybrid_mpc_tpu_torch.obs import clock as obs_clock
        from explicit_hybrid_mpc_tpu_torch.partition import provenance as prov

        eng = self.eng
        ident = {"problem_hash": prov.problem_hash(eng.problem),
                 "eps_a": float(getattr(eng.cfg, "eps_a", 0.0)),
                 "eps_r": float(getattr(eng.cfg, "eps_r", 0.0)),
                 "n_shards": self.n_shards}
        manifest = dict(ident, run_id=obs_clock.run_id())
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, "manifest.json")
        if os.path.exists(path):
            try:
                with open(path) as f:
                    prior = json.load(f)
            except (OSError, json.JSONDecodeError):
                prior = None  # torn: a concurrent first write; retry
            if prior is not None:
                if {k: prior.get(k) for k in ident} != ident:
                    raise ValueError(
                        f"shard_dir {directory} belongs to a "
                        f"different build ({prior} != {manifest}); "
                        "use a fresh --shard-dir per build")
                if prior.get("run_id") != manifest["run_id"]:
                    # Same build identity, different run id.  NEVER
                    # delete anything: shards of one launch share an
                    # id only when a launcher exports EHM_RUN_ID, so a
                    # mismatch may simply be a platform-spawned peer of
                    # THIS run -- deleting 'stale' files here would
                    # destroy a live peer's journals (open handles
                    # write to unlinked inodes; sequence cursors point
                    # past deleted files).  The state is same-problem
                    # and deterministic, so reusing it is SOUND; it
                    # can only pre-solve cells, which shows up as a
                    # lower summed solve count.  Warn so the exact
                    # count-parity bar is knowingly waived on reused
                    # dirs (the gates always use fresh ones).
                    warnings.warn(
                        f"shard_dir {directory} carries exchange "
                        f"state from run {prior.get('run_id')!r} "
                        f"(this run: {manifest['run_id']!r}); reusing "
                        "it as a same-build cache -- summed solve "
                        "counts may undershoot the single-process "
                        "build's; use a fresh --shard-dir for parity "
                        "measurements", RuntimeWarning, stacklevel=2)
                return
        atomic.atomic_write_json(path, manifest)

    @classmethod
    def from_config(cls, eng, cfg) -> "ShardContext | None":
        if not getattr(cfg, "shard_frontier", False):
            return None
        shard = getattr(cfg, "shard_index", None)
        count = getattr(cfg, "shard_count", None)
        if shard is None or count is None:
            from explicit_hybrid_mpc_tpu_torch.parallel import distributed

            if shard is None:
                shard = distributed.process_index()
            if count is None:
                count = distributed.process_count()
        if count <= 1:
            return None  # single shard: behavior-identical plain build
        directory = getattr(cfg, "shard_dir", None)
        if not directory:
            raise ValueError(
                "cfg.shard_frontier needs cfg.shard_dir (a directory "
                "shared by every shard -- the CLI derives "
                "<output>.shard)")
        return cls(eng, shard, count, directory,
                   timeout_s=getattr(cfg, "shard_timeout_s", 300.0))

    # -- ownership ---------------------------------------------------------

    def owned_roots(self, roots: list[int]) -> list[int]:
        return [roots[i] for i in owned_root_indices(
            len(roots), self.shard, self.n_shards)]

    def is_remote(self, key: bytes) -> bool:
        return shard_owner(key, self.n_shards) != self.shard

    # -- consuming remote results ------------------------------------------

    def take(self, key: bytes, need: np.ndarray) -> bool:
        """Merge store coverage of `key` cells in `need` into the
        engine cache (through the engine's ONE row-writing path);
        returns True when anything was merged."""
        row = self.ex.rows.get(key)
        if row is None:
            return False
        avail = need & row["mask"]
        if not avail.any():
            return False
        ds = np.nonzero(avail)[0]
        self._merge_cells(key, ds, row)
        self.remote_cells += len(ds)
        return True

    def _merge_cells(self, key: bytes, ds: np.ndarray, row: dict) -> None:
        """Write store cells into the engine cache via
        eng._merge_plan_results (the shared merge keeps Vstar/dstar
        reduction and row-widening semantics identical to a local
        solve)."""
        plan = {"grid_arr": None, "grid_keys": [],
                "pair_slices": [(key, ds, 0)], "pair_donors": [None],
                "n_skips": 0, "n_new": 0}
        # Exchange rows are DONOR-STERILE on purpose (no duals ever
        # cross the exchange): publication ARRIVAL timing is
        # nondeterministic, and a remote row that could become a
        # warm-start donor would make _pick_donor's choice -- and
        # therefore the pipeline's serve-time route match -- depend on
        # cross-host timing, turning the exact summed-point_solves
        # parity into a race.  Cells near a shard boundary simply
        # start cold; the merit gate makes that a pure iteration-count
        # effect.
        pair_out = (row["V"][ds], row["conv"][ds], row["grad"][ds],
                    row["u0"][ds], row["z"][ds], None, None)
        self.eng._merge_plan_results(plan, None, pair_out)

    def request(self, key: bytes, theta: np.ndarray,
                need: np.ndarray) -> None:
        self.ex.request(key, theta, need)

    # -- eviction stash -----------------------------------------------------

    def _boundary_roots(self):
        """Vertex matrices of the root simplices OTHER shards own
        (lazy: the engine's tree exists by the first eviction)."""
        if not hasattr(self, "_nonowned_roots"):
            eng = self.eng
            own = set(owned_root_indices(len(eng.roots), self.shard,
                                         self.n_shards))
            self._nonowned_roots = [
                np.array(eng.tree.vertices[r])
                for i, r in enumerate(eng.roots) if i not in own]
        return self._nonowned_roots

    def note_evict(self, key: bytes, vertex: np.ndarray,
                   row: tuple) -> None:
        """Called by the engine right before evicting a cache row: an
        OWNED vertex on the shard boundary (contained in a root
        simplex another shard owns) is stashed into the exchange store
        first, so a peer's request arriving AFTER the owner's own
        nodes closed is served from the stash instead of re-solved --
        the eviction race would otherwise double-solve the cell and
        break the exact summed-point_solves bar (timing-dependent).
        Interior vertices are skipped: no peer subtree can ever touch
        them, so the stash stays O(shard boundary), not O(subtree)."""
        from explicit_hybrid_mpc_tpu_torch.partition import geometry

        if shard_owner(key, self.n_shards) != self.shard:
            return
        srow = self.ex.rows.get(key)
        have = srow["mask"] if srow is not None else None
        mask = row[7]
        if have is not None and not (mask & ~have).any():
            return
        if not any(geometry.contains(V, vertex, 1e-9)
                   for V in self._boundary_roots()):
            return
        self.ex.merge_row(key, mask, row[0], row[1], row[2], row[3],
                          row[4])

    def collect(self, remote: list[tuple[bytes, np.ndarray,
                                         np.ndarray]]) -> None:
        """Block until every remote cell in `remote` = [(key, theta,
        delta index array)] is in the engine cache, serving peer
        requests the whole time (deadlock freedom: two shards blocked
        on each other both keep answering).  After cfg.shard_timeout_s
        the stragglers are solved LOCALLY -- liveness wins over the
        zero-duplicate guarantee, loudly (obs event + counter; the
        acceptance configs never hit it)."""
        eng = self.eng
        nd = eng.oracle.can.n_delta
        pending = {k: (t, ds) for k, t, ds in remote}
        t0 = time.monotonic()

        def _missing(k: bytes, ds: np.ndarray) -> np.ndarray:
            need = np.zeros(nd, dtype=bool)
            need[ds] = True
            crow = eng.cache.get_key(k)
            if crow is not None:
                need &= ~crow[7]
            return need

        sleep_s = self.POLL_S
        while pending:
            self.ex.heartbeat()
            self.ex.poll()
            progressed = False
            for k in list(pending):
                _t, ds = pending[k]
                need = _missing(k, ds)
                if need.any():
                    if self.take(k, need):
                        progressed = True
                    need = _missing(k, ds)
                if not need.any():
                    del pending[k]
            if not pending:
                break
            self.serve_requests()
            if time.monotonic() - t0 > self.timeout_s:
                self._fallback(pending)
                break
            time.sleep(sleep_s)
            # Adaptive backoff: stay snappy while results stream in,
            # ramp toward 100 ms while nothing arrives -- a blocked
            # shard at a fixed 1 ms makes ~1000x n_shards stat-class
            # filesystem operations per second against the shared
            # mount, for no latency benefit.
            sleep_s = self.POLL_S if progressed \
                else min(sleep_s * 1.5, 0.1)

    def _fallback(self, pending: dict) -> None:
        """Timeout path: solve the still-missing remote cells locally
        (duplicate work, sound results) so a dead peer cannot hang the
        build."""
        eng = self.eng
        slices, donors, T, D = [], [], [], []
        off = 0
        for k, (theta, ds) in pending.items():
            crow = eng.cache.get_key(k)
            rem = np.asarray([d for d in ds
                              if crow is None or not crow[7][d]],
                             dtype=np.int64)
            if rem.size == 0:
                continue
            slices.append((k, rem, off))
            donors.append(None)
            T.extend([theta] * rem.size)
            D.extend(rem.tolist())
            off += rem.size
        if not D:
            return
        out = eng._oracle_call("solve_pairs_full", np.stack(T),
                               np.asarray(D, dtype=np.int64), None)
        plan = {"grid_arr": None, "grid_keys": [],
                "pair_slices": slices, "pair_donors": donors,
                "n_skips": 0, "n_new": 0}
        eng._merge_plan_results(plan, None, out)
        self.fallback_cells += off
        eng.log.emit(shard_fallback=True, cells=off,
                     timeout_s=self.timeout_s)
        eng.obs.event("shard.request_timeout", cells=off,
                      timeout_s=self.timeout_s)
        if eng.obs.enabled:
            eng.obs.metrics.counter("shard.fallback_cells").inc(off)

    # -- serving peers ------------------------------------------------------

    def tick(self) -> None:
        """Per-step exchange maintenance: ingest publications, answer
        requests, assert liveness.  Bounded work; called at every step
        start and inside every blocking wait."""
        self.ex.heartbeat()
        self.ex.poll()
        self.serve_requests()

    def serve_requests(self) -> None:
        """Answer peer requests for cells this shard owns: serve
        already-solved cells from the engine cache / store, solve the
        rest on-behalf (dense grid family for full-enumeration cold
        needs, sparse pairs otherwise -- the same routing the
        requester's own single-process build would use), publish."""
        eng = self.eng
        nd = eng.oracle.can.n_delta
        reqs = self.ex.read_requests(nd)
        if not reqs:
            return
        todo_grid: list[tuple[bytes, np.ndarray]] = []
        todo_pairs: list[tuple[bytes, np.ndarray, np.ndarray]] = []
        publish: list[tuple[bytes, np.ndarray]] = []
        for key, theta, mask in reqs:
            if shard_owner(key, self.n_shards) != self.shard:
                continue  # misrouted/stale: not mine to answer
            publish.append((key, mask))
            srow = self.ex.rows.get(key)
            have = srow["mask"].copy() if srow is not None \
                else np.zeros(nd, dtype=bool)
            crow = eng.cache.get_key(key)
            if crow is not None:
                # Mirror locally-solved cells into the store so they
                # can be published (and never re-solved).  Duals stay
                # behind -- see _merge_cells (donor-sterile exchange).
                own = crow[7] & ~have
                if own.any():
                    self.ex.merge_row(key, own, crow[0], crow[1],
                                      crow[2], crow[3], crow[4])
                    have |= own
            new = mask & ~have
            if new.any():
                # A requested cell already IN FLIGHT on this shard's
                # device (a tentative lookahead dispatched it for our
                # own future claim) resolves from the window instead
                # of re-solving: the program's wait-time counting
                # fires once either way, and re-dispatching the cell
                # would be exactly the cross-shard duplicate the
                # ownership hash exists to prevent.
                win = eng._pipe.resolve_vertex(key, nd)
                if win is not None:
                    hit = new & win["mask"]
                    if hit.any():
                        self.ex.merge_row(key, hit, win["V"],
                                          win["conv"], win["grad"],
                                          win["u0"], win["z"])
                        have |= hit
                        new = mask & ~have
            if not new.any():
                continue
            if new.all() and not have.any():
                todo_grid.append((key, theta))
            else:
                # was_new: this solve mints the vertex's first row
                # anywhere on this shard -- the owner counts it toward
                # unique_vertex_solves so the summed figure matches the
                # single-process build's.
                todo_pairs.append((key, theta, np.nonzero(new)[0],
                                   not have.any()))
        n_solved = 0
        if todo_grid:
            arr = np.stack([t for _, t in todo_grid])
            sol = eng._oracle_call("solve_vertices", arr)
            full = np.ones(nd, dtype=bool)
            for i, (key, _t) in enumerate(todo_grid):
                # No duals into the store (donor-sterile exchange --
                # see _merge_cells).
                self.ex.merge_row(
                    key, full, sol.V[i], sol.conv[i], sol.grad[i],
                    sol.u0[i], sol.z[i])
            n_solved += len(todo_grid) * nd
            eng.n_unique_solves += len(todo_grid)
        if todo_pairs:
            T = np.repeat(np.stack([t for _, t, _, _ in todo_pairs]),
                          [ds.size for _, _, ds, _ in todo_pairs],
                          axis=0)
            D = np.concatenate([ds for _, _, ds, _ in todo_pairs])
            V, conv, grad, u0, z, _lam, _s = eng._oracle_call(
                "solve_pairs_full", T, D.astype(np.int64), None)
            off = 0
            for key, _t, ds, was_new in todo_pairs:
                sl = slice(off, off + ds.size)
                m = np.zeros(nd, dtype=bool)
                m[ds] = True
                self.ex.merge_row(
                    key, m, _scatter(V[sl], ds, nd, np.inf),
                    _scatter(conv[sl], ds, nd, False),
                    _scatter(grad[sl], ds, nd, 0.0),
                    _scatter(u0[sl], ds, nd, 0.0),
                    _scatter(z[sl], ds, nd, 0.0))
                off += ds.size
                if was_new:
                    eng.n_unique_solves += 1
            n_solved += off
        if n_solved:
            self.served_cells += n_solved
            if eng.obs.enabled:
                eng.obs.metrics.counter("shard.served_cells").inc(
                    n_solved)
        self.ex.publish(publish)

    # -- finalize / merge ---------------------------------------------------

    def stats_extras(self) -> dict:
        return {"shard": self.shard, "n_shards": self.n_shards,
                "shard_remote_cells": self.remote_cells,
                "shard_served_cells": self.served_cells,
                "shard_fallback_cells": self.fallback_cells}

    def finalize(self, eng, wall: float):
        """End-of-build shard protocol: write this shard's tree/stats,
        post the done marker, keep serving requests until EVERY shard
        is done, then merge the shard trees into the global result
        (every process merges identically, so callers see the same
        PartitionResult on all shards -- the lockstep build's
        contract).  Raises after cfg.shard_timeout_s (scaled by shard
        count) if a peer never finishes."""
        from explicit_hybrid_mpc_tpu_torch.partition.frontier import (
            PartitionResult)

        eng.tree.save(self.ex.tree_path())
        atomic.atomic_write_json(self.ex.done_path(),
                                 {"shard": self.shard, "wall_s": wall})
        state = {"deadline": time.monotonic() + self.timeout_s,
                 "hb": self.ex.peer_heartbeats()}

        def _await(path_of, what: str) -> None:
            # The timeout bounds SILENCE, not total wall: a straggler
            # shard legitimately runs long past its peers on an
            # imbalanced root split, and killing a multi-hour build
            # because one shard finished early would be worse than
            # the crash it guards against.  Any peer heartbeat
            # advance pushes the deadline out; only a peer silent for
            # a full shard_timeout_s is declared dead.
            sleep_s = ShardContext.POLL_S
            while True:
                missing = [s for s in range(self.n_shards)
                           if not os.path.exists(path_of(s))]
                if not missing:
                    return
                self.tick()
                hb = self.ex.peer_heartbeats()
                if hb != state["hb"]:
                    state["hb"] = hb
                    state["deadline"] = time.monotonic() + self.timeout_s
                if time.monotonic() > state["deadline"]:
                    raise RuntimeError(
                        f"sharded build: shard(s) {missing} never "
                        f"posted a {what} under {self.ex.dir} and no "
                        f"peer heartbeat advanced for "
                        f"{self.timeout_s:.0f}s (crashed peer?)")
                time.sleep(sleep_s)
                sleep_s = min(sleep_s * 1.5, 0.1)  # back off while idle

        # Drain: keep answering peer requests until EVERY shard's
        # frontier is done.  Only then are this shard's counters final
        # (on-behalf solves served while draining must land in the
        # stats file -- the summed-point_solves parity bar), so the
        # stats write happens AFTER the drain barrier.
        _await(self.ex.done_path, "done marker")
        my_stats = eng.stats_dict(wall)
        my_stats.update(self.stats_extras())
        atomic.atomic_write_json(self.ex.stats_path(), my_stats,
                                 default=_json_default)
        _await(self.ex.stats_path, "stats file")
        trees = [Tree.load(self.ex.tree_path(s))
                 for s in range(self.n_shards)]
        stats_list = []
        for s in range(self.n_shards):
            with open(self.ex.stats_path(s)) as f:
                stats_list.append(json.load(f))
        merged = merge_shard_trees(
            trees, lambda r: r % self.n_shards)
        stats = merge_shard_stats(stats_list, merged, wall)
        self.ex.close()
        return PartitionResult(merged, merged.roots(), stats)


def _json_default(o):
    """Numpy scalars in a stats dict -> plain JSON numbers."""
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, (np.bool_,)):
        return bool(o)
    raise TypeError(f"not JSON-serializable: {type(o)}")


def _scatter(vals: np.ndarray, ds: np.ndarray, nd: int, fill):
    """(K, ...) per-cell values -> (nd, ...) row with `fill`
    elsewhere."""
    vals = np.asarray(vals)
    out = np.full((nd,) + vals.shape[1:], fill, dtype=vals.dtype)
    out[ds] = vals
    return out


# -- merging ----------------------------------------------------------------


def merge_shard_trees(trees: list[Tree], owner_of) -> Tree:
    """Merge per-shard trees (each holding ALL roots but expanding only
    its owned ones) into one global tree.

    Node order: roots first (ids 0..R-1, identical in every shard tree
    by construction), then each shard's non-root block in shard order
    -- deterministic, so every process merges bit-identically.  The
    merged order differs from the single-process build's breadth-first
    interleaving; compare with ``compare_trees_canonical``."""
    base = trees[0]
    R = len(base.roots())
    for s, t in enumerate(trees[1:], start=1):
        if len(t.roots()) != R or not np.array_equal(
                t.vertices[:R], base.vertices[:R]):
            raise ValueError(f"shard {s} tree roots diverge from "
                             "shard 0's -- not the same build")
    out = Tree(p=base.p, n_u=base.n_u,
               split_hyperplanes=all(t._split_normals_live
                                     for t in trees))
    counts = [len(t) - R for t in trees]
    offs, off = [], 0
    for c in counts:
        offs.append(off)
        off += c
    total = R + off
    out._grow(total)
    out._n = total

    def remap(ids: np.ndarray, s: int) -> np.ndarray:
        ids = np.asarray(ids, dtype=np.int64)
        return np.where(ids == NO_CHILD, NO_CHILD,
                        np.where(ids < R, ids, ids + offs[s]))

    # Root rows come from each root's OWNER (the only shard that
    # expanded it); payloads are set through set_leaf below.
    for r in range(R):
        s = owner_of(r)
        t = trees[s]
        out._vertices[r] = t._vertices[r]
        out._parent[r] = -1
        out._depth[r] = 0
        out._children[r] = remap(t._children[r], s)
        out._split_edge[r] = t._split_edge[r]
        if out._split_normals_live:
            out._normal[r] = t._normal[r]
            out._offset[r] = t._offset[r]
    for s, t in enumerate(trees):
        n_s = len(t)
        if n_s <= R:
            continue
        sl = slice(R + offs[s], R + offs[s] + (n_s - R))
        out._vertices[sl] = t._vertices[R:n_s]
        out._parent[sl] = remap(t._parent[R:n_s], s)
        out._children[sl] = np.stack(
            [remap(t._children[R:n_s, 0], s),
             remap(t._children[R:n_s, 1], s)], axis=1)
        out._depth[sl] = t._depth[R:n_s]
        out._split_edge[sl] = t._split_edge[R:n_s]
        if out._split_normals_live:
            out._normal[sl] = t._normal[R:n_s]
            out._offset[sl] = t._offset[R:n_s]
    out._max_depth = max(int(t.max_depth()) for t in trees)
    # Leaf payloads through the one mutation path (keeps slot/flag/
    # region bookkeeping consistent).
    for s, t in enumerate(trees):
        flags = t._leaf_flags[:len(t)]
        for j in np.nonzero(flags & 1)[0]:
            if j < R and owner_of(int(j)) != s:
                continue  # a root leaf belongs to its owner's tree
            nid = int(j) if j < R else int(j) + offs[s]
            out.set_leaf(nid, t.leaf_data[int(j)])
    # Stage-2 certificate ledger for the warm rebuild: remap node ids,
    # concatenate in shard order (each event lives inside its shard's
    # owned subtree, so there are no duplicates).
    ev = []
    for s, t in enumerate(trees):
        for n, d, v in t.excl_events:
            nid = n if n < R else n + offs[s]
            ev.append((int(nid), int(d), float(v)))
    out.excl_events = ev
    out.provenance = base.provenance
    return out


def merge_shard_stats(stats_list: list[dict], merged: Tree,
                      wall: float) -> dict:
    """Global stats for a sharded build: additive counters sum,
    structural figures come from the merged tree, and the per-shard
    rows ride along for the bench/scaling report."""
    SUM = ("steps", "oracle_solves", "point_solves", "simplex_solves",
           "rescue_solves", "inherited_skips", "uncertified",
           "semi_explicit", "frontier_left", "unique_vertex_solves",
           "masked_point_skips", "prefetched_steps", "pipelined_steps",
           "dedup_saved", "spec_hits", "spec_waste", "device_failures",
           "quarantined_cells", "shard_remote_cells",
           "shard_served_cells", "shard_fallback_cells")
    stats: dict = {k: sum(int(st.get(k) or 0) for st in stats_list)
                   for k in SUM}
    # High-water marks are per-cache figures, not additive work: the
    # global reading that keeps the key's single-cache meaning is the
    # worst shard's peak.
    stats["cache_peak_vertices"] = max(
        (int(st.get("cache_peak_vertices") or 0)
         for st in stats_list), default=0)
    stats["regions"] = merged.n_regions()
    stats["tree_nodes"] = len(merged)
    stats["max_depth"] = merged.max_depth()
    stats["truncated"] = any(st.get("truncated") for st in stats_list)
    stats["device_degraded"] = any(st.get("device_degraded")
                                   for st in stats_list)
    stats["wall_s"] = wall
    stats["regions_per_s"] = merged.n_regions() / max(wall, 1e-9)
    stats["sharded"] = True
    stats["n_shards"] = len(stats_list)
    stats["per_shard"] = [
        {k: st.get(k) for k in
         ("shard", "regions", "steps", "wall_s", "regions_per_s",
          "point_solves", "simplex_solves", "shard_remote_cells",
          "shard_served_cells", "shard_fallback_cells",
          "quarantined_cells", "device_degraded",
          "cp_fill_frac", "cp_plan_frac", "cp_wait_frac",
          "cp_certify_frac", "cp_other_frac", "cp_overlap_s")}
        for st in stats_list]
    return stats


# -- canonical comparison ---------------------------------------------------


def compare_trees_canonical(a: Tree, b: Tree,
                            payloads: bool = False) -> list[str]:
    """Node-for-node divergence list ([] = identical) under the
    canonical node identity: a node IS its exact vertex-matrix bytes
    (bisection arithmetic is exact, so equal geometry implies equal
    bytes).  Insertion-order independent -- the sharded merge orders
    nodes per-subtree while the single-process build interleaves
    breadth-first.  Compares: node sets (vertices bitwise), split
    structure, leaf sets, certification statuses and commutation
    choices, region counts, depths; leaf payload floats only under
    ``payloads=True`` (the sharded parity bar excludes them -- a
    remote cell is solved in the owner's batch and starts cold)."""
    diffs: list[str] = []
    if len(a) != len(b):
        return [f"node count {len(a)} != {len(b)}"]

    def index(t: Tree) -> dict[bytes, int]:
        out: dict[bytes, int] = {}
        for i in range(len(t)):
            k = t.vertices[i].tobytes()
            if k in out:
                raise ValueError("duplicate vertex matrix in tree -- "
                                 "canonical comparison undefined")
            out[k] = i
        return out

    ia, ib = index(a), index(b)
    only_a = set(ia) - set(ib)
    if only_a:
        return [f"{len(only_a)} node(s) have no geometric counterpart"]
    fa, fb = a._leaf_flags, b._leaf_flags
    for k, na in ia.items():
        nb = ib[k]
        leaf_a, leaf_b = a.is_leaf(na), b.is_leaf(nb)
        if leaf_a != leaf_b:
            diffs.append(f"node depth {int(a.depth[na])}: "
                         f"leaf({leaf_a}) vs leaf({leaf_b})")
            continue
        if int(fa[na]) != int(fb[nb]):
            diffs.append(f"leaf flags {int(fa[na])} != {int(fb[nb])} "
                         f"at depth {int(a.depth[na])}")
            continue
        da, db = a.leaf_data[na], b.leaf_data[nb]
        if da is None:
            continue
        if da.delta_idx != db.delta_idx:
            diffs.append(f"leaf commutation {da.delta_idx} != "
                         f"{db.delta_idx} at depth {int(a.depth[na])}")
        elif payloads and not (
                np.array_equal(da.vertex_inputs, db.vertex_inputs)
                and np.array_equal(da.vertex_costs, db.vertex_costs)):
            diffs.append("leaf payload floats differ at depth "
                         f"{int(a.depth[na])}")
        if len(diffs) >= 10:
            diffs.append("... (further diffs suppressed)")
            return diffs
    if a.n_regions() != b.n_regions():
        diffs.append(f"regions {a.n_regions()} != {b.n_regions()}")
    if a.max_depth() != b.max_depth():
        diffs.append(f"max depth {a.max_depth()} != {b.max_depth()}")
    return diffs
