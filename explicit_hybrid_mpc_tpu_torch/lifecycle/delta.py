"""Delta-compressed serving artifacts: ship O(changed), not O(tree).

The counterpart of the JAX package's lifecycle/delta.py (host numpy;
the files it writes and reads are the same).  A warm rebuild keeps
most prior leaves BIT-IDENTICAL (partition/rebuild.py: kept payloads are never rewritten, kept node ids never
move), so successive generations' serving artifacts share most of
their bytes -- yet ``save_artifacts`` ships the full table every
time, and a replica fleet syncing N copies of an O(tree) artifact per
revision pays the tree size on every swap.  The delta format carries
only what changed, with the base pinned by provenance:

Leaf table (the byte-dominant part): the new table's rows are keyed by
``node_id`` (stable across a rebuild -- invalidated leaves become
internal nodes and their replacement leaves get NEW ids, so a kept row
has the same id and the same bytes).  The delta stores

- ``src_idx.npy``: (L_new,) int64 -- for each new row, the base-table
  row it is copied from verbatim, or -1 for a fresh row;
- ``fresh_<field>.npy``: the fresh rows only, in new-row order.

Descent arrays (online/descent.py): keyed by tree node index (node
ids only ever APPEND across a rebuild).  The delta stores the changed
prefix rows (invalidated leaves that gained children) + the appended
tail; ``leaf_row`` is not shipped at all -- it is a permutation of the
new leaf order and is recomputed exactly at apply time, and the root
arrays come from the base (root geometry transfer is a warm-rebuild
precondition).

``delta_meta.json`` is the delta's COMMIT MARKER (written atomically
LAST, utils/atomic.py): it pins the base (provenance stamp +
n_leaves + the base's own file checksums) and records content sha256s
of every RECONSTRUCTED array, so ``apply_delta`` can prove the applied
artifact is bitwise what the publisher exported -- a wrong base, a
torn delta, or bit rot all fail loudly (``DeltaMismatch`` /
``CorruptArtifact``) instead of serving a franken-table.  Applying
writes a directory byte-compatible with ``save_artifacts``'s layout
(fields + descent.npz first, meta.json commit marker last), so any
full-artifact loader (serve/arena.py ``publish_from_artifacts``)
consumes it unchanged.  ``load_delta_plan`` is the device-resident
consumer's view: the arena's ``publish_delta`` gathers kept columns in
place and uploads only the fresh rows.

When no valid base exists (first generation, provenance drift, legacy
base) the caller falls back to a FULL artifact.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Optional

import numpy as np

DELTA_KIND = "ehm-delta-v1"
DELTA_META = "delta_meta.json"

#: Leaf-table fields, publisher order (online/export.py layout).
_LEAF_FIELDS = ("bary_M", "U", "V", "delta", "node_id")
#: Descent arrays delta-compressed on the node axis (the rest of the
#: npz -- root_bary/root_node -- transfers from the base, and leaf_row
#: is recomputed).
_DESC_FIELDS = ("children", "normal", "offset")


class DeltaMismatch(ValueError):
    """The delta does not apply to this base (wrong generation /
    provenance drift / shape disagreement): sync the full artifact."""


def _sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _read_meta(dir_path: str, name: str) -> Optional[dict]:
    from explicit_hybrid_mpc_tpu_torch.utils import atomic

    p = os.path.join(dir_path, name)
    try:
        with open(p) as f:
            return json.load(f)
    except OSError:
        return None
    except json.JSONDecodeError as e:
        raise atomic.CorruptArtifact(
            f"{p}: unreadable ({e}) -- the commit marker is torn; "
            "re-publish or fall back to the full artifact") from e


def delta_size_bytes(dir_path: str) -> int:
    """Total on-disk bytes of an artifact/delta directory (the
    replica-sync cost the delta format exists to shrink)."""
    total = 0
    for name in os.listdir(dir_path):
        p = os.path.join(dir_path, name)
        if os.path.isfile(p):
            total += os.path.getsize(p)
    return total


def write_delta_artifact(tree, roots, delta_dir: str, base_dir: str,
                         base_version: Optional[str] = None,
                         provenance: Optional[dict] = None) -> dict:
    """Export `tree` as a DELTA against the published artifact at
    `base_dir`.  Returns stats (n_kept/n_fresh/delta row counts +
    byte accounting).  Raises DeltaMismatch when the base cannot host
    a delta (row-key drift, shape change, missing/legacy meta) -- the
    caller then publishes a full artifact instead."""
    from explicit_hybrid_mpc_tpu_torch.online import descent as descent_mod
    from explicit_hybrid_mpc_tpu_torch.online import export as export_mod
    from explicit_hybrid_mpc_tpu_torch.utils import atomic

    if provenance is None:
        provenance = getattr(tree, "provenance", None)
    base_meta = _read_meta(base_dir, "meta.json")
    if base_meta is None or "n_leaves" not in base_meta:
        raise DeltaMismatch(
            f"{base_dir}: no committed meta.json -- a legacy or "
            "uncommitted base cannot anchor a delta")
    base_table = export_mod.load_leaf_table(base_dir, mmap=True)
    base_desc = np.load(os.path.join(base_dir, "descent.npz"))
    try:
        table = export_mod.export_leaves(tree)
        dt = descent_mod.export_descent(tree, roots, table, stage=False)
        n_base = int(base_table.n_leaves)
        if (table.bary_M.shape[1:] != base_table.bary_M.shape[1:]
                or table.U.shape[1:] != base_table.U.shape[1:]):
            raise DeltaMismatch(
                "leaf-row shapes differ from the base (p or n_u "
                "changed): nothing transfers, publish full")
        root_bary = np.asarray(dt.root_bary)
        if not np.array_equal(root_bary, base_desc["root_bary"]) or \
                not np.array_equal(np.asarray(dt.root_node),
                                   base_desc["root_node"]):
            raise DeltaMismatch(
                "root triangulation differs from the base: the box "
                "changed -- a cold-build event, publish full")

        # -- leaf rows: match by node_id, keep only byte-equal rows ----
        base_ids = np.asarray(base_table.node_id, dtype=np.int64)
        new_ids = np.asarray(table.node_id, dtype=np.int64)
        # Exported ids are converged_leaf_ids(): ascending by contract
        # (searchsorted below depends on it; a hand-assembled base that
        # violates it cannot anchor a delta).
        if base_ids.size > 1 and np.any(np.diff(base_ids) <= 0):
            raise DeltaMismatch(
                f"{base_dir}: base node_id rows are not ascending -- "
                "not an export-layout artifact, publish full")
        pos = np.searchsorted(base_ids, new_ids)
        pos_c = np.clip(pos, 0, n_base - 1)
        found = base_ids[pos_c] == new_ids
        same = found.copy()
        for k in ("bary_M", "U", "V", "delta"):
            a = np.asarray(getattr(table, k))
            b = np.asarray(getattr(base_table, k))[pos_c]
            eq = a == b
            if eq.ndim > 1:
                eq = eq.reshape(eq.shape[0], -1).all(axis=1)
            same &= eq
        src_idx = np.where(same, pos_c, -1).astype(np.int64)
        fresh = src_idx < 0

        # -- descent rows: changed prefix + appended tail --------------
        children = np.asarray(dt.children)
        normal = np.asarray(dt.normal)
        offset = np.asarray(dt.offset)
        nb_nodes = int(base_desc["children"].shape[0])
        if children.shape[0] < nb_nodes:
            raise DeltaMismatch(
                "new tree has fewer nodes than the base: not a "
                "descendant generation, publish full")
        changed = np.zeros(nb_nodes, dtype=bool)
        changed |= (children[:nb_nodes]
                    != base_desc["children"]).any(axis=1)
        changed |= (normal[:nb_nodes]
                    != base_desc["normal"]).any(axis=1)
        changed |= offset[:nb_nodes] != base_desc["offset"]
        changed_idx = np.nonzero(changed)[0].astype(np.int64)

        os.makedirs(delta_dir, exist_ok=True)
        # A re-published delta dir must not keep a stale marker over
        # half-rewritten fields (export.invalidate_meta discipline).
        try:
            os.unlink(os.path.join(delta_dir, DELTA_META))
        except FileNotFoundError:
            pass
        np.save(os.path.join(delta_dir, "src_idx.npy"), src_idx)
        for k in _LEAF_FIELDS:
            np.save(os.path.join(delta_dir, f"fresh_{k}.npy"),
                    np.asarray(getattr(table, k))[fresh])
        np.save(os.path.join(delta_dir, "desc_changed_idx.npy"),
                changed_idx)
        np.save(os.path.join(delta_dir, "desc_changed_children.npy"),
                children[changed_idx])
        np.save(os.path.join(delta_dir, "desc_changed_normal.npy"),
                normal[changed_idx])
        np.save(os.path.join(delta_dir, "desc_changed_offset.npy"),
                offset[changed_idx])
        np.save(os.path.join(delta_dir, "desc_tail_children.npy"),
                children[nb_nodes:])
        np.save(os.path.join(delta_dir, "desc_tail_normal.npy"),
                normal[nb_nodes:])
        np.save(os.path.join(delta_dir, "desc_tail_offset.npy"),
                offset[nb_nodes:])

        meta = {
            "kind": DELTA_KIND,
            "base_version": base_version,
            "base_n_leaves": n_base,
            "base_n_nodes": nb_nodes,
            "base_provenance": base_meta.get("provenance"),
            "base_checksums": base_meta.get("checksums"),
            "n_leaves": int(table.n_leaves),
            "p": int(table.bary_M.shape[1] - 1),
            "n_u": int(table.U.shape[2]),
            "max_depth": int(dt.max_depth),
            "provenance": provenance,
            # Content hashes of the FULL reconstructed arrays: apply
            # proves bitwise identity with what the publisher held.
            "array_sha": {
                **{k: _sha(np.asarray(getattr(table, k)))
                   for k in _LEAF_FIELDS},
                "children": _sha(children), "normal": _sha(normal),
                "offset": _sha(offset),
            },
            "n_fresh": int(fresh.sum()),
            "n_kept": int((~fresh).sum()),
            "n_desc_changed": int(changed_idx.size),
        }
        atomic.atomic_write_json(os.path.join(delta_dir, DELTA_META),
                                 meta)
        return {"n_fresh": meta["n_fresh"], "n_kept": meta["n_kept"],
                "n_desc_changed": meta["n_desc_changed"],
                "delta_bytes": delta_size_bytes(delta_dir)}
    finally:
        base_desc.close()


def _validate_delta_base(delta_dir: str, base_dir: str) -> dict:
    """Shared front-half validation for delta consumers: the delta is
    committed, its kind is known, and the base at `base_dir` is the
    generation it was built against (row count + provenance stamp).
    Returns the delta meta."""
    from explicit_hybrid_mpc_tpu_torch.utils import atomic

    meta = _read_meta(delta_dir, DELTA_META)
    if meta is None:
        raise atomic.CorruptArtifact(
            f"{delta_dir}: no {DELTA_META} -- the delta was never "
            "committed (torn publish); re-sync")
    if meta.get("kind") != DELTA_KIND:
        raise DeltaMismatch(
            f"{delta_dir}: unknown delta kind {meta.get('kind')!r}")
    base_meta = _read_meta(base_dir, "meta.json")
    if base_meta is None:
        raise DeltaMismatch(
            f"{base_dir}: base carries no committed meta.json; delta "
            "cannot be validated against it")
    if int(base_meta.get("n_leaves", -1)) != int(meta["base_n_leaves"]):
        raise DeltaMismatch(
            f"base at {base_dir} has {base_meta.get('n_leaves')} "
            f"leaves but the delta was built against "
            f"{meta['base_n_leaves']}: wrong base generation")
    from explicit_hybrid_mpc_tpu_torch.partition import provenance as prov

    if prov.diff_stamps(base_meta.get("provenance"),
                        meta.get("base_provenance")):
        raise DeltaMismatch(
            f"base at {base_dir} carries a different provenance stamp "
            "than the delta's recorded base: wrong base generation "
            "(sync the full artifact)")
    return meta


def load_delta_plan(delta_dir: str, base_dir: str) -> dict:
    """Load the LEAF-ROW plan of a committed delta for device-resident
    consumers (serve/arena.py): which new rows are verbatim copies of
    base rows (gatherable in place on device) and the fresh rows' f64
    payloads (the only host->device upload a hot swap needs).

    Runs the same base validation as ``apply_delta`` (commit marker,
    kind, base generation by row count + provenance) but loads ONLY the
    O(changed) delta files -- neither the base table nor the descent
    arrays are touched, because the arena's fused kernel locates by
    brute leaf-tile streaming, not tree descent.  The bitwise proof
    (content sha256 of the full reconstructed arrays) needs the base
    rows and therefore lives on the ``apply_delta`` disk path; the
    arena's equivalent guarantee is structural -- kept columns are
    device-gathered from the already-resident base extent, and the
    f64->f32 column pack is elementwise, so delta-apply into the arena
    is bitwise a full re-pack of the reconstructed table (tests pin
    this).

    Returns ``{"meta", "n_leaves", "base_n_leaves", "base_version",
    "src_idx", "fresh": {field: rows}}`` with fresh rows aligned to
    ``np.flatnonzero(src_idx < 0)``.
    """
    from explicit_hybrid_mpc_tpu_torch.utils import atomic

    meta = _validate_delta_base(delta_dir, base_dir)
    p = os.path.join(delta_dir, "src_idx.npy")
    try:
        src_idx = np.load(p)
    except (OSError, ValueError, EOFError) as e:
        raise atomic.CorruptArtifact(
            f"{p}: unreadable delta field ({e}); re-sync") from e
    L = int(meta["n_leaves"])
    if src_idx.shape[0] != L:
        raise atomic.CorruptArtifact(
            f"{delta_dir}: src_idx holds {src_idx.shape[0]} rows but "
            f"the marker committed {L}: torn delta")
    n_fresh = int((src_idx < 0).sum())
    fresh = {}
    for k in ("bary_M", "U", "V", "node_id"):
        fp = os.path.join(delta_dir, f"fresh_{k}.npy")
        try:
            rows = np.load(fp)
        except (OSError, ValueError, EOFError) as e:
            raise atomic.CorruptArtifact(
                f"{fp}: unreadable delta field ({e}); re-sync") from e
        if rows.shape[0] != n_fresh:
            raise atomic.CorruptArtifact(
                f"{fp}: {rows.shape[0]} fresh rows but src_idx marks "
                f"{n_fresh}: torn delta")
        fresh[k] = rows
    return {"meta": meta, "n_leaves": L,
            "base_n_leaves": int(meta["base_n_leaves"]),
            "base_version": meta.get("base_version"),
            "src_idx": np.asarray(src_idx, dtype=np.int64),
            "fresh": fresh}


def apply_delta(delta_dir: str, base_dir: str, out_dir: str,
                verify_base_checksums: bool = False) -> dict:
    """Reconstruct the FULL serving artifact at `out_dir` from a delta
    + its base.  Returns the delta meta.  The result is bitwise the
    publisher's table (content sha256s enforced; DeltaMismatch on a
    wrong base, CorruptArtifact on a torn delta or hash miss) and
    loads like any full artifact.  ``verify_base_checksums`` additionally re-hashes the
    base's field files against ITS meta (a full read -- deploy-time
    paranoia)."""
    from explicit_hybrid_mpc_tpu_torch.online import descent as descent_mod
    from explicit_hybrid_mpc_tpu_torch.online import export as export_mod
    from explicit_hybrid_mpc_tpu_torch.online.descent import DescentTable
    from explicit_hybrid_mpc_tpu_torch.utils import atomic

    meta = _validate_delta_base(delta_dir, base_dir)
    base_table = export_mod.load_leaf_table(
        base_dir, mmap=True, verify_checksum=verify_base_checksums)

    def _load(name: str) -> np.ndarray:
        p = os.path.join(delta_dir, name + ".npy")
        try:
            return np.load(p)
        except (OSError, ValueError, EOFError) as e:
            raise atomic.CorruptArtifact(
                f"{p}: unreadable delta field ({e}); re-sync") from e

    src_idx = _load("src_idx")
    L = int(meta["n_leaves"])
    if src_idx.shape[0] != L:
        raise atomic.CorruptArtifact(
            f"{delta_dir}: src_idx holds {src_idx.shape[0]} rows but "
            f"the marker committed {L}: torn delta")
    fresh = src_idx < 0
    kept = ~fresh
    fields = {}
    for k in _LEAF_FIELDS:
        fresh_rows = _load(f"fresh_{k}")
        base_arr = np.asarray(getattr(base_table, k))
        out = np.empty((L,) + base_arr.shape[1:], dtype=base_arr.dtype)
        out[kept] = base_arr[src_idx[kept]]
        out[fresh] = fresh_rows
        want = meta["array_sha"][k]
        if _sha(out) != want:
            raise atomic.CorruptArtifact(
                f"{delta_dir}: reconstructed {k} hashes "
                f"{_sha(out)[:12]}.. but the delta committed "
                f"{want[:12]}..: base or delta corrupted; sync the "
                "full artifact")
        fields[k] = out

    # -- descent reconstruction -------------------------------------------
    base_desc = np.load(os.path.join(base_dir, "descent.npz"))
    try:
        nb = int(meta["base_n_nodes"])
        if int(base_desc["children"].shape[0]) != nb:
            raise DeltaMismatch(
                f"base descent at {base_dir} has "
                f"{base_desc['children'].shape[0]} nodes, delta "
                f"expected {nb}: wrong base generation")
        idx = _load("desc_changed_idx")
        desc = {}
        for k in _DESC_FIELDS:
            arr = np.concatenate(
                [np.asarray(base_desc[k]), _load(f"desc_tail_{k}")],
                axis=0)
            arr[idx] = _load(f"desc_changed_{k}")
            want = meta["array_sha"][k]
            if _sha(arr) != want:
                raise atomic.CorruptArtifact(
                    f"{delta_dir}: reconstructed descent {k} does not "
                    "hash to the delta's commitment: base or delta "
                    "corrupted; sync the full artifact")
            desc[k] = arr
        # leaf_row is a pure function of the new leaf order
        # (online/descent.export_descent): recompute, never ship.
        leaf_row = np.full(desc["children"].shape[0], -1,
                           dtype=np.int32)
        leaf_row[fields["node_id"]] = np.arange(L, dtype=np.int32)
        dt = DescentTable(
            root_bary=np.asarray(base_desc["root_bary"]),
            root_node=np.asarray(base_desc["root_node"]),
            children=desc["children"], normal=desc["normal"],
            offset=desc["offset"], leaf_row=leaf_row,
            max_depth=int(meta["max_depth"]))
    finally:
        base_desc.close()

    # -- write the full artifact (save_artifacts layout + commit order) ----
    os.makedirs(out_dir, exist_ok=True)
    export_mod.invalidate_meta(out_dir)
    for k in _LEAF_FIELDS:
        np.save(os.path.join(out_dir, f"{k}.npy"), fields[k])
    descent_mod.save_descent(dt, os.path.join(out_dir, "descent.npz"))
    export_mod.commit_leaf_table(out_dir, L, int(meta["p"]),
                                 int(meta["n_u"]), meta.get("provenance"))
    return meta
