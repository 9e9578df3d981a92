"""Sharded descent serving: split the leaf/descent tables across devices.

The flat descent path (online/descent.py) keeps ONE table of all nodes
and all leaves, and every level of its loop gathers from arrays far
larger than any cache.  This module shards them:

- The tree is CUT a few levels below the roots; each cut node's subtree
  (its descent arrays AND its slice of the leaf table, both compacted to
  shard-local ids) becomes part of one of ``n_shards`` shards, balanced
  by leaf count (greedy largest-first).  Shards are placed round-robin
  over devices (parallel.mesh.serving_placement).
- A query is first ROUTED to its cut node: the root pick (an analytic
  geometry.kuhn_root_locator when the root layout allows, else the
  brute min-barycentric scan of descent.locate_descent, identical
  formula and first-max tie-break as the flat locate), then
  ``cut_depth`` hyperplane sign tests over a routing table holding only
  the above-cut nodes.
- Queries are then BATCHED PER SHARD (padded to power-of-two buckets)
  and each shard's descent + interpolation is enqueued on its device
  through the shared descend_from / evaluate_rows; every shard is
  enqueued before any result is read, and the results come back in ONE
  device-to-host copy per device, then scatter into query order.

The counterpart of the JAX package's online/sharded.py.  The descent is
plain torch here, as it is plain XLA (no Pallas kernel) there: one
batch costs about ``max_depth`` x (ops a level) small launches per
shard.  On a CUDA device each program -- the routing descent, a shard's
descent + interpolation -- is captured once per padding bucket as a CUDA
graph (``_Graphed``) and replayed afterwards, as the JAX package
compiles one program per shard and bucket: one graph launch instead of
a few hundred kernel launches from the host, the same kernels (so the
same bits).  A bucket's first call runs eagerly and then captures;
``warm(max_batch)`` makes every such first call before serving.  A
call takes a set of graphs no other call is using (their input and
output buffers are the call's until it has read its results), so
concurrent callers -- a scheduler's worker and a demand hub's oracle --
neither wait for each other nor share buffers; a server holds as many
sets as it ever had concurrent calls.  Same value contract as descent.evaluate_descent:
interpolated u/cost equal (leaf ids may differ on shared facets, as
everywhere else in the online stack); ``leaf`` is the GLOBAL leaf-table
row.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from explicit_hybrid_mpc_tpu_torch import config as config_mod
from explicit_hybrid_mpc_tpu_torch import device as device_lib
from explicit_hybrid_mpc_tpu_torch import obs as obs_lib
from explicit_hybrid_mpc_tpu_torch.online import descent as descent_mod
from explicit_hybrid_mpc_tpu_torch.online.descent import DescentTable
from explicit_hybrid_mpc_tpu_torch.online.evaluator import (DeviceLeafTable,
                                                            EvalResult)
from explicit_hybrid_mpc_tpu_torch.online.export import LeafTable
from explicit_hybrid_mpc_tpu_torch.parallel.mesh import (local_devices,
                                                         serving_placement)
from explicit_hybrid_mpc_tpu_torch.partition.tree import NO_CHILD

_MIN_BUCKET = 8

# Largest padding bucket a single evaluate/locate call may mint.  A
# query batch beyond this is SPLIT into max-bucket chunks; the split is
# observable: a health.oversized_batch event (warn severity) plus the
# serve.oversized_batches counter.  The value lives in config.py so
# ServeConfig's deploy-time validation compares against the same number.
_DEFAULT_MAX_BUCKET = config_mod.DEFAULT_MAX_BUCKET

# Batch-size histogram bounds: power-of-two edges matching the padding
# buckets.
_BATCH_BOUNDS = tuple(float(1 << k) for k in range(21))


def _bucket(n: int) -> int:
    """Power-of-two padding >= n: bounds the per-shard batch shapes to
    log2(max batch) sizes."""
    return max(_MIN_BUCKET, 1 << max(0, (n - 1).bit_length()))


def _graphable(t: torch.Tensor) -> bool:
    """Whether a program on `t`'s device runs as a CUDA graph."""
    return t.device.type == "cuda"


class _Graphed:
    """One program (`fn(*inputs)` -> tensor) at one padding bucket as a
    CUDA graph: static input tensors, the graph, its output tensor
    (overwritten by every replay, so read before the next)."""

    __slots__ = ("inputs", "graph", "out")

    def __init__(self, fn, inputs: list):
        import torch

        self.inputs = [t.clone() for t in inputs]
        self.graph = torch.cuda.CUDAGraph()
        # Captured on a side stream, as torch.cuda.graph does, but
        # without its device synchronize, full garbage collection and
        # cache release: a capture in a serving process must not stall
        # every thread for a collection of the whole heap.
        # thread_local: another thread's CUDA calls during the capture
        # (a scheduler's or a hub's) are not this capture's business.
        cur = torch.cuda.current_stream(self.inputs[0].device)
        side = torch.cuda.Stream(self.inputs[0].device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self.graph.capture_begin(capture_error_mode="thread_local")
            try:
                self.out = fn(*self.inputs)
            finally:
                self.graph.capture_end()
        cur.wait_stream(side)

    def __call__(self, inputs: list):
        for dst, src in zip(self.inputs, inputs):
            dst.copy_(src)
        self.graph.replay()
        return self.out


def _find_cut(children: np.ndarray, root_node: np.ndarray,
              target: int) -> tuple[np.ndarray, int]:
    """Descend level-by-level from the roots until the frontier holds at
    least `target` nodes (leaves stay put); returns (cut node ids,
    cut_depth).  The frontier after k steps is exactly the set of nodes
    a k-step routing descent can land on."""
    cur = root_node.astype(np.int64)
    k = 0
    while cur.size < target:
        ch = children[cur]
        leaf = ch[:, 0] == NO_CHILD
        if leaf.all():
            break
        cur = np.concatenate([cur[leaf], ch[~leaf].reshape(-1)])
        k += 1
    return cur, k


def _subtree_owners(children: np.ndarray, cut: np.ndarray) -> np.ndarray:
    """(Nn,) index into `cut` of the owning cut node (-1 above the cut),
    by breadth-first owner propagation."""
    owner = np.full(children.shape[0], -1, dtype=np.int64)
    owner[cut] = np.arange(cut.size)
    frontier = cut
    while frontier.size:
        ch = children[frontier]
        live = ch[:, 0] != NO_CHILD
        kids = ch[live].reshape(-1)
        owner[kids] = np.repeat(owner[frontier[live]], 2)
        frontier = kids
    return owner


def _balance(counts: np.ndarray, n_shards: int) -> np.ndarray:
    """Greedy largest-first bin packing: (n_cut,) shard per cut node."""
    shard = np.zeros(counts.size, dtype=np.int64)
    load = np.zeros(n_shards, dtype=np.int64)
    for c in np.argsort(counts, kind="stable")[::-1]:
        s = int(np.argmin(load))
        shard[c] = s
        load[s] += counts[c]
    return shard


def _put(a, dev: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """A host array as a tensor of its own on `dev` (table staging)."""
    return torch.as_tensor(np.array(a, copy=True), dtype=dtype).to(dev)


def _serve_shard(dt: DescentTable, leaves: DeviceLeafTable,
                 thetas: torch.Tensor, node0: torch.Tensor,
                 tol: float) -> torch.Tensor:  # tpulint: device-region
    """Descend + interpolate one shard's batch, packed as one (pad,
    n_u + 3) float64 tensor [u | cost | inside | row] so the host reads
    every shard of a device in one copy (rows are < 2^53, exact)."""
    row, _node = descent_mod.descend_from(dt, thetas, node0)
    res = descent_mod.evaluate_rows(leaves, thetas, row, tol)
    f64 = torch.float64
    return torch.cat([res.u, res.cost[:, None], res.inside[:, None].to(f64),
                      row[:, None].to(f64)], dim=1)


# tpulint: device-region
def _locate_shard(dt: DescentTable, thetas: torch.Tensor,
                  node0: torch.Tensor) -> torch.Tensor:
    row, node = descent_mod.descend_from(dt, thetas, node0)
    return torch.stack([row.to(torch.int64), node.to(torch.int64)], dim=1)


def _read(pending: list[tuple]) -> list[np.ndarray]:
    """Each pending shard's first `n` output rows as host arrays, with
    ONE device-to-host copy per device (the shards of a device are
    concatenated there first)."""
    by_dev: dict[torch.device, list[int]] = {}
    for k, (_idx, sh, _out) in enumerate(pending):
        by_dev.setdefault(sh["device"], []).append(k)
    host: list[Optional[np.ndarray]] = [None] * len(pending)
    for ks in by_dev.values():
        sizes = [pending[k][0].size for k in ks]
        cat = torch.cat([pending[k][2][:n] for k, n in zip(ks, sizes)])
        arr = cat.cpu().numpy()
        lo = 0
        for k, n in zip(ks, sizes):
            host[k] = arr[lo:lo + n]
            lo += n
    return host  # type: ignore[return-value]


class ShardedDescent:
    """Descent/leaf tables sharded across devices, queries batched per
    shard.  Build with `shard_descent` (from a host DescentTable +
    LeafTable -- a fresh export or load_descent/load_leaf_table
    artifacts; the pickled Tree is never needed)."""

    def __init__(self, dt: DescentTable, table: LeafTable,
                 n_shards: Optional[int] = None,
                 devices: Optional[Sequence[torch.device]] = None,
                 granularity: int = 8, router=None,
                 obs: "obs_lib.Obs | None" = None,
                 max_bucket: Optional[int] = None):
        devices = [device_lib.resolve(d) for d in devices] \
            if devices is not None else local_devices()
        if not devices:
            raise RuntimeError(
                "ShardedDescent: no CUDA device (torch.cuda.device_count() "
                "is 0); pass devices=[torch.device('cpu')] to serve on the "
                "CPU")
        self.max_bucket = int(max_bucket if max_bucket is not None
                              else _DEFAULT_MAX_BUCKET)
        if self.max_bucket < _MIN_BUCKET \
                or not config_mod.is_pow2(self.max_bucket):
            raise ValueError(f"max_bucket must be a power of two >= "
                             f"{_MIN_BUCKET}, got {self.max_bucket}")
        # Extra fields merged into every serve.eval heartbeat event: the
        # request scheduler (serve/scheduler.py) writes its queue_depth /
        # batch_fill_frac here -- and, with request tracing on
        # (obs/reqtrace.py), the rolling queue_frac -- so stream
        # consumers can alarm on serving stalls and queue-dominated
        # tails.
        self.heartbeat: dict = {}
        # Serving observability: per-shard latency histograms, batch
        # sizes, routing counters, imbalance gauge.  NOOP by default --
        # the hot path pays one truthiness test per batch when disabled.
        self._obs = obs if obs is not None else obs_lib.NOOP
        # Optional analytic root locator (geometry.kuhn_root_locator):
        # callable(thetas (B, p)) -> (B,) GLOBAL root index.  The caller
        # owns the claim that it matches this tree's root layout.
        self._router = router
        # Sets of CUDA graphs by (program, shard, bucket, ...) that no
        # call is using, and the lock of that list (module docstring).
        self._graph_sets: list[dict] = []
        self._sets_lock = threading.Lock()
        if n_shards is None:
            n_shards = len(devices)
        children = np.asarray(dt.children)
        normal = np.asarray(dt.normal, dtype=np.float64)
        offset = np.asarray(dt.offset, dtype=np.float64)
        leaf_row = np.asarray(dt.leaf_row)
        root_node = np.asarray(dt.root_node, dtype=np.int64)
        self.root_bary = np.asarray(dt.root_bary, dtype=np.float64)
        self.max_depth = int(dt.max_depth)
        self.n_shards = n_shards
        # Cut a few levels down: ~granularity cut nodes per shard gives
        # the greedy packer enough pieces to balance leaf counts.
        cut, self.cut_depth = _find_cut(children, root_node,
                                        granularity * n_shards)
        owner = _subtree_owners(children, cut)
        node_ids = np.asarray(table.node_id, dtype=np.int64)
        counts = np.bincount(owner[node_ids], minlength=cut.size)
        cut_shard = _balance(counts, n_shards)

        # Routing table: the above-cut nodes plus the cut itself, with
        # children remapped to routing-local ids (NO_CHILD at the cut, so
        # the routing descent parks there).
        above = np.flatnonzero(owner == -1)
        rnodes = np.concatenate([above, cut])
        rmap = np.full(children.shape[0], -1, dtype=np.int64)
        rmap[rnodes] = np.arange(rnodes.size)
        rch = children[rnodes].astype(np.int64)
        rch[rch != NO_CHILD] = rmap[rch[rch != NO_CHILD]]
        rch[np.isin(rnodes, cut)] = NO_CHILD
        self._r_shard = np.full(rnodes.size, -1, dtype=np.int64)
        self._r_shard[rmap[cut]] = cut_shard
        self._r_start = np.full(rnodes.size, -1, dtype=np.int64)
        self._r_root = rmap[root_node]
        # The routing table IS a DescentTable over the above-cut nodes
        # (leaf_row unused, max_depth = cut_depth): routing runs through
        # the SAME locate_descent / descend_from as the shards, so the
        # root-pick tie-break and descent sign convention cannot drift
        # between routing and shard-local descent.
        r_dev = devices[0]
        self._r_dev = r_dev
        self._rt = DescentTable(
            root_bary=_put(self.root_bary, r_dev, torch.float64),
            root_node=_put(self._r_root, r_dev, torch.int32),
            children=_put(rch, r_dev, torch.int32),
            normal=_put(normal[rnodes], r_dev, torch.float64),
            offset=_put(offset[rnodes], r_dev, torch.float64),
            leaf_row=_put(np.full(rnodes.size, -1), r_dev, torch.int32),
            max_depth=self.cut_depth)

        # Per-shard compacted tables, each staged on its own device.
        placement = serving_placement(n_shards, devices)
        self.devices = placement
        node_shard = np.where(owner >= 0, cut_shard[owner], -1)
        row_shard = node_shard[node_ids]
        f64 = torch.float64
        self._shards: list[Optional[dict]] = []
        for s in range(n_shards):
            nodes_s = np.flatnonzero(node_shard == s)
            rows_s = np.flatnonzero(row_shard == s)
            if nodes_s.size == 0:
                self._shards.append(None)
                continue
            new_id = np.full(children.shape[0], -1, dtype=np.int64)
            new_id[nodes_s] = np.arange(nodes_s.size)
            ch_s = children[nodes_s].astype(np.int64)
            ch_s[ch_s != NO_CHILD] = new_id[ch_s[ch_s != NO_CHILD]]
            rowmap = np.full(table.n_leaves, -1, dtype=np.int64)
            rowmap[rows_s] = np.arange(rows_s.size)
            lr_s = leaf_row[nodes_s].astype(np.int64)
            lr_s = np.where(lr_s >= 0, rowmap[lr_s], -1)
            cut_s = cut[cut_shard == s]
            self._r_start[rmap[cut_s]] = new_id[cut_s]
            dev = placement[s]
            dt_s = DescentTable(
                # Root fields are routing-only; per-shard descent starts
                # at explicit nodes.
                root_bary=torch.zeros((1,) + self.root_bary.shape[1:],
                                      dtype=f64, device=dev),
                root_node=torch.zeros(1, dtype=torch.int32, device=dev),
                children=_put(ch_s, dev, torch.int32),
                normal=_put(normal[nodes_s], dev, f64),
                offset=_put(offset[nodes_s], dev, f64),
                leaf_row=_put(lr_s, dev, torch.int32),
                max_depth=self.max_depth)
            if rows_s.size:
                dev_table = DeviceLeafTable(
                    bary_M=_put(table.bary_M[rows_s], dev, f64),
                    U=_put(table.U[rows_s], dev, f64),
                    V=_put(table.V[rows_s], dev, f64))
            else:
                # A shard can cover only payload-free subtrees (fully
                # infeasible region): keep one zero row so the
                # evaluate_rows gather at safe=max(row, 0)=0 stays in
                # bounds (row itself is -1 there, flagged outside).
                m, n_u = table.bary_M.shape[1], table.U.shape[2]
                dev_table = DeviceLeafTable(
                    bary_M=torch.zeros((1, m, m), dtype=f64, device=dev),
                    U=torch.zeros((1, m, n_u), dtype=f64, device=dev),
                    V=torch.zeros((1, m), dtype=f64, device=dev))
            self._shards.append({
                "sid": s, "dt": dt_s, "leaves": dev_table, "device": dev,
                "rows_global": rows_s, "nodes_global": nodes_s})
        # Every table copy has landed before this server can be published
        # (a registry lease may evaluate from another thread at once).
        for d in {*placement, r_dev}:
            if d.type == "cuda":
                torch.cuda.synchronize(d)
        # Metric objects are resolved ONCE here; None when disabled, so
        # the hot path pays one truthiness test.
        self._ms = None
        if self._obs.enabled:
            sizes = self.shard_sizes()
            mean = sum(sizes) / max(1, len(sizes))
            m = self._obs.metrics
            m.gauge("serve.shards").set(self.n_shards)
            m.gauge("serve.leaves").set(float(sum(sizes)))
            m.gauge("serve.cut_depth").set(self.cut_depth)
            # Greedy-packing quality: max/mean leaf load (1.0 = perfect).
            m.gauge("serve.shard_imbalance").set(
                max(sizes) / mean if mean else 0.0)
            self._obs.event("serve.sharded", shards=self.n_shards,
                            cut_depth=self.cut_depth, sizes=sizes)
            self._ms = {
                "shard_hist": {
                    sh["sid"]: m.histogram(
                        f"serve.shard{sh['sid']:02d}.query_s")
                    for sh in self._shards if sh is not None},
                "batch": m.histogram("serve.shard_batch",
                                     bounds=_BATCH_BOUNDS),
                "route_s": m.histogram("serve.route_s"),
                "route_q": m.counter("serve.route_analytic_queries"
                                     if self._router is not None
                                     else "serve.route_brute_queries"),
                "queries": m.counter("serve.queries"),
                "query_s": m.histogram("serve.query_s"),
                "locate_q": m.counter("serve.locate_queries"),
                "oversized": m.counter("serve.oversized_batches"),
            }

    # -- host routing ------------------------------------------------------

    def _route(self, thetas: np.ndarray, graphs: dict) -> np.ndarray:
        """(B,) routing-local cut node per query: root pick (analytic
        router when given, else the routing table's locate_descent) +
        cut_depth hyperplane sign tests, through the shared descent
        functions on the first device.  Queries are padded to a
        power-of-two bucket."""
        B = thetas.shape[0]
        ms = self._ms
        t0 = time.perf_counter() if ms else 0.0
        pad = _bucket(B)
        if pad != B:
            thetas = np.concatenate(
                [thetas, np.zeros((pad - B, thetas.shape[1]))])
        q = device_lib.to_device(thetas, self._r_dev, torch.float64)
        if self._router is not None:
            ridx = np.asarray(self._router(thetas), dtype=np.int64)
            node = self._r_root[ridx]
            if self.cut_depth:
                _row, nd = descent_mod.descend_from(
                    self._rt, q,
                    device_lib.to_device(node, self._r_dev, torch.int64))
                node = nd.cpu().numpy()
        else:
            node = self._run(graphs, ("route", pad), self._route_program,
                             [q]).cpu().numpy()
        if ms:
            ms["route_q"].inc(B)
            ms["route_s"].observe(time.perf_counter() - t0)
        return node[:B].astype(np.int64)

    def _route_program(self, q: torch.Tensor) -> torch.Tensor:
        return descent_mod.locate_descent(self._rt, q)[1]

    # -- serving -----------------------------------------------------------

    @contextlib.contextmanager
    def _graph_set(self):
        """A set of graphs no other call is using, for one call."""
        with self._sets_lock:
            graphs = self._graph_sets.pop() if self._graph_sets else {}
        try:
            yield graphs
        finally:
            with self._sets_lock:
                self._graph_sets.append(graphs)

    @staticmethod
    def _run(graphs: dict, key: tuple, fn, inputs: list):
        """`fn(*inputs)` on their device: on a CUDA device through the
        graph of `key` in `graphs` (captured after an eager first call,
        which this call returns), elsewhere eagerly."""
        if not _graphable(inputs[0]):
            return fn(*inputs)
        g = graphs.get(key)
        if g is None:
            out = fn(*inputs)
            graphs[key] = _Graphed(fn, inputs)
            return out
        return g(inputs)

    def _dispatch(self, thetas: np.ndarray, program, key: tuple,
                  graphs: dict) -> list[tuple]:
        """Route, then batch per shard (power-of-two padding, staged on
        the shard's device) and enqueue `program(shard, queries, start)`
        on each (the graph of (`key`, shard, bucket) on a CUDA device);
        returns [(query idx, shard, output tensor), ...].  No result is
        read here: every shard is enqueued first."""
        rnode = self._route(thetas, graphs)
        shard = self._r_shard[rnode]
        ms = self._ms
        pending = []
        for s in range(self.n_shards):
            idx = np.flatnonzero(shard == s)
            if idx.size == 0:
                continue
            if ms:
                ms["batch"].observe(idx.size)
            pad = _bucket(idx.size)
            qs = np.zeros((pad, thetas.shape[1]))
            qs[:idx.size] = thetas[idx]
            n0 = np.zeros(pad, dtype=np.int64)
            n0[:idx.size] = self._r_start[rnode[idx]]
            pending.append((idx, self._shards[s],
                            self._enqueue(graphs, program, key, s, qs, n0)))
        return pending

    def _enqueue(self, graphs: dict, program, key: tuple, s: int,
                 qs: np.ndarray, n0: np.ndarray) -> torch.Tensor:
        """`program(shard s, queries, start nodes)` on the shard's device
        (the graph of (`key`, s, bucket) on a CUDA device)."""
        sh = self._shards[s]
        dev = sh["device"]
        return self._run(
            graphs, key + (s, qs.shape[0]),
            lambda q, n, sh=sh: program(sh, q, n),
            [device_lib.to_device(qs, dev, torch.float64),
             device_lib.to_device(n0, dev, torch.int64)])

    @staticmethod
    def _serve_program(tol: float):
        return lambda sh, qs, n0: _serve_shard(sh["dt"], sh["leaves"], qs,
                                               n0, tol)

    def warm(self, max_batch: int, tol: float = 1e-9) -> int:
        """Run every program of `evaluate` at every padding bucket of a
        batch of up to `max_batch` rows: the routing descent at each
        bucket and EACH shard's descent + interpolation at each bucket,
        whatever split of a batch across the shards would mint it, in
        the graph set the next call takes.  On a CUDA device that makes
        each first call and its capture here, before serving.  Returns
        the number of programs run."""
        p = self.root_bary.shape[-1] - 1
        top = _bucket(min(max(1, int(max_batch)), self.max_bucket))
        pads = [b for b in (1 << k for k in range(top.bit_length()))
                if _MIN_BUCKET <= b <= top]
        program = self._serve_program(tol)
        n = 0
        with self._graph_set() as graphs:
            for pad in pads:
                if self._router is None:
                    q = device_lib.to_device(np.zeros((pad, p)),
                                             self._r_dev, torch.float64)
                    self._run(graphs, ("route", pad), self._route_program,
                              [q])
                    n += 1
                for s, sh in enumerate(self._shards):
                    starts = self._r_start[self._r_shard == s]
                    if sh is None or starts.size == 0:
                        continue
                    self._enqueue(graphs, program, ("serve", tol), s,
                                  np.zeros((pad, p)),
                                  np.full(pad, starts[0], dtype=np.int64))
                    n += 1
        for d in {str(sh["device"]) for sh in self._shards if sh}:
            if torch.device(d).type == "cuda":
                torch.cuda.synchronize(d)
        return n

    @staticmethod
    def _global_rows(sh: dict, local: np.ndarray) -> np.ndarray:
        """Shard-local leaf rows -> global table rows (-1 preserved;
        payload-free shards have no rows to map)."""
        glob = (sh["rows_global"][np.maximum(local, 0)]
                if sh["rows_global"].size
                else np.full(local.size, -1))
        return np.where(local >= 0, glob, -1)

    def _note_oversized(self, B: int, n_chunks: int) -> None:
        """A batch beyond the largest padding bucket: record the split
        as a health.* event (warn severity)."""
        if self._ms:
            self._ms["oversized"].inc()
        self._obs.event(
            "health.oversized_batch", severity="warn", value=B,
            threshold=self.max_bucket,
            msg=(f"query batch of {B} exceeds the largest padding "
                 f"bucket {self.max_bucket}; split into {n_chunks} "
                 "max-bucket chunks"))

    def evaluate(self, thetas: np.ndarray, tol: float = 1e-9
                 ) -> EvalResult:
        """Batched PWA evaluation, same contract as
        descent.evaluate_descent; `leaf` is the global leaf-table row.
        Accepts/returns host numpy (the serving boundary).  Batches
        beyond `max_bucket` are split into max-bucket chunks (see
        _note_oversized) -- results are identical (every field is
        computed row-independently)."""
        thetas = np.asarray(thetas, dtype=np.float64)
        B = thetas.shape[0]
        if B > self.max_bucket:
            step = self.max_bucket
            self._note_oversized(B, -(-B // step))
            parts = [self._evaluate_bounded(thetas[lo:lo + step], tol)
                     for lo in range(0, B, step)]
            return EvalResult(
                u=np.concatenate([p.u for p in parts]),
                cost=np.concatenate([p.cost for p in parts]),
                leaf=np.concatenate([p.leaf for p in parts]),
                inside=np.concatenate([p.inside for p in parts]))
        return self._evaluate_bounded(thetas, tol)

    def _evaluate_bounded(self, thetas: np.ndarray, tol: float
                          ) -> EvalResult:
        B = thetas.shape[0]
        ms = self._ms
        t0 = time.perf_counter() if ms else 0.0
        with self._graph_set() as graphs:
            pending = self._dispatch(thetas, self._serve_program(tol),
                                     ("serve", tol), graphs)
            outs = _read(pending)
        n_u = (int(pending[0][2].shape[1]) - 3 if pending
               else self._shards_n_u())
        u = np.zeros((B, n_u))
        cost = np.zeros(B)
        leaf = np.full(B, -1, dtype=np.int64)
        inside = np.zeros(B, dtype=bool)
        for (idx, sh, _out), out in zip(pending, outs):
            # Per-shard histogram: this shard's host-side scatter per
            # query (the device work of every shard overlaps, and all
            # of a device's shards come back in one copy).
            seg0 = time.perf_counter() if ms else 0.0
            u[idx] = out[:, :n_u]
            cost[idx] = out[:, n_u]
            inside[idx] = out[:, n_u + 1] != 0.0
            leaf[idx] = self._global_rows(
                sh, out[:, n_u + 2].astype(np.int64))
            if ms:
                ms["shard_hist"][sh["sid"]].observe(
                    (time.perf_counter() - seg0) / idx.size, n=idx.size)
        if ms:
            ms["queries"].inc(B)
            wall = time.perf_counter() - t0
            ms["query_s"].observe(wall / max(B, 1), n=B)
            # One streaming event per evaluate() batch (never per
            # query): a serving heartbeat between metrics snapshots.
            self._obs.event("serve.eval", batch=B,
                            wall_s=round(wall, 6),
                            us_per_query=round(wall / max(B, 1) * 1e6,
                                               3),
                            **self.heartbeat)
        return EvalResult(u=u, cost=cost, leaf=leaf, inside=inside)

    def _shards_n_u(self) -> int:
        for sh in self._shards:
            if sh is not None:
                return int(sh["leaves"].U.shape[2])
        return 1

    def locate(self, thetas: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(global leaf-table row, global tree node id) per query; -1
        row where the descent lands on a payload-free leaf.  Oversized
        batches split like evaluate()."""
        thetas = np.asarray(thetas, dtype=np.float64)
        B = thetas.shape[0]
        if B > self.max_bucket:
            step = self.max_bucket
            self._note_oversized(B, -(-B // step))
            parts = [self._locate_bounded(thetas[lo:lo + step])
                     for lo in range(0, B, step)]
            return (np.concatenate([r for r, _n in parts]),
                    np.concatenate([n for _r, n in parts]))
        return self._locate_bounded(thetas)

    def _locate_bounded(self, thetas: np.ndarray
                        ) -> tuple[np.ndarray, np.ndarray]:
        B = thetas.shape[0]
        if self._ms:
            self._ms["locate_q"].inc(B)
        with self._graph_set() as graphs:
            pending = self._dispatch(
                thetas, lambda sh, qs, n0: _locate_shard(sh["dt"], qs, n0),
                ("locate",), graphs)
            outs = _read(pending)
        rows = np.full(B, -1, dtype=np.int64)
        nodes = np.full(B, -1, dtype=np.int64)
        for (idx, sh, _out), out in zip(pending, outs):
            rows[idx] = self._global_rows(sh, out[:, 0])
            nodes[idx] = sh["nodes_global"][out[:, 1]]
        return rows, nodes

    def shard_sizes(self) -> list[int]:
        """Leaf count per shard (0 for empty shards) -- balance metric."""
        return [0 if s is None else int(s["rows_global"].size)
                for s in self._shards]

    @property
    def n_leaves(self) -> int:
        """Total leaf-table rows across shards -- the global leaf-row
        space ``EvalResult.leaf`` indexes."""
        return sum(self.shard_sizes())

    def device_bytes(self) -> dict:
        """Bytes of the tensors this server holds on its devices:
        {"leaves": leaf tables, "descent": shard descent arrays +
        routing table}."""
        def nbytes(ts):
            return sum(t.numel() * t.element_size() for t in ts)

        leaves = descent = 0
        for sh in self._shards:
            if sh is None:
                continue
            leaves += nbytes(sh["leaves"])
            descent += nbytes(getattr(sh["dt"], k)
                              for k in descent_mod._FIELDS)
        descent += nbytes(getattr(self._rt, k) for k in descent_mod._FIELDS)
        return {"leaves": leaves, "descent": descent}


def shard_descent(dt: DescentTable, table: LeafTable,
                  n_shards: Optional[int] = None,
                  devices: Optional[Sequence[torch.device]] = None,
                  granularity: int = 8, router=None,
                  obs: "obs_lib.Obs | None" = None,
                  max_bucket: Optional[int] = None) -> ShardedDescent:
    """Build the sharded server from host-side descent + leaf tables.

    `dt` should be a host export (descent.export_descent(..., stage=
    False)) or descent.load_descent output; `table` an export_leaves /
    load_leaf_table result (memmap-backed tables stream shard slices
    straight from disk).  `devices`: None = every CUDA device (raises
    without one); ``[torch.device("cpu")]`` serves on the CPU.
    `router` (optional): analytic global-root locator, e.g.
    geometry.kuhn_root_locator(problem.theta_lb, problem.theta_ub,
    problem.root_splits) for engine-built trees -- replaces the
    O(R)-per-query brute root scan."""
    return ShardedDescent(dt, table, n_shards=n_shards, devices=devices,
                          granularity=granularity, router=router, obs=obs,
                          max_bucket=max_bucket)
