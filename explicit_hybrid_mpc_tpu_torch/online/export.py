"""Export a built Tree's converged leaves to flat device arrays.

The reference deploys its controller by descending the pickled tree in
Python (SURVEY.md section 4.2); the TPU-native online stage instead consumes
a flat table of leaves -- per leaf the barycentric matrix (lambda =
bary_M @ [theta;1]) and the vertex input matrix -- so point location +
affine evaluation is one fixed-shape device program (BASELINE.json
north-star: "a Pallas point-in-simplex + affine-eval kernel").

Two export shapes share one chunked core (`_fill_chunks`):

- `export_leaves(tree)` materializes the table in RAM (small/medium
  partitions, tests, the benchmark's flagship tree);
- `write_leaf_table(tree, dir)` streams the SAME chunks into
  memory-mapped ``.npy`` files, so exporting a multi-million-leaf tree
  next to its live 45 GB in-RAM form costs O(chunk) additional RSS, not
  a second O(L) copy (the 9.8M-leaf satellite export peaked at 94.8 GB
  host RSS with the in-RAM path -- commit 0ff2285).  `load_leaf_table`
  maps the files back (optionally copy-free) so the online stage never
  needs the pickled tree at all.

Chunk boundaries do not change a single bit of the output: every field
is computed row-independently (batched inverses per chunk, columnar
fancy indexing), which tests/test_online.py pins against the in-RAM
export.
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple

import numpy as np

from explicit_hybrid_mpc_tpu_torch.partition import geometry
from explicit_hybrid_mpc_tpu_torch.partition.tree import Tree

# Streaming chunk: 2^18 leaves x (bary_M + U + V) is ~20-80 MB transient
# for the benchmark problems -- large enough that the per-chunk batched
# inverse amortizes, small enough that export RSS stays flat.
DEFAULT_CHUNK = 1 << 18

_LEAF_FIELDS = ("bary_M", "U", "V", "delta", "node_id")


class LeafTable(NamedTuple):
    """Flat leaf arrays (numpy; jnp.asarray to stage on device).

    bary_M:   (L, p+1, p+1) -- lambda(theta) = bary_M @ [theta; 1]
    U:        (L, p+1, n_u) -- vertex first-move inputs
    V:        (L, p+1)      -- vertex costs (for cost readout)
    delta:    (L,)          -- commutation index per leaf
    node_id:  (L,)          -- tree node of each row (for cross-checks)

    Arrays may be np.memmap views of an on-disk table (load_leaf_table);
    the contract is identical either way.
    """

    bary_M: np.ndarray
    U: np.ndarray
    V: np.ndarray
    delta: np.ndarray
    node_id: np.ndarray

    @property
    def n_leaves(self) -> int:
        return self.bary_M.shape[0]


def _fill_chunks(tree: Tree, ids: np.ndarray, out: LeafTable,
                 chunk: int) -> None:
    """Stream leaf payloads + barycentric inverses into preallocated
    (possibly memory-mapped) arrays, `chunk` leaves at a time.  The only
    live transients are one chunk's payload slices and its batched
    inverse -- O(chunk), independent of L."""
    for lo in range(0, ids.size, chunk):
        sl = slice(lo, lo + chunk)
        ids_c = ids[sl]
        delta, U, V = tree.leaf_payloads(ids_c)
        out.bary_M[sl] = geometry.barycentric_matrices(
            tree.vertices[ids_c])
        out.U[sl] = U
        out.V[sl] = V
        out.delta[sl] = delta.astype(np.int32)
        out.node_id[sl] = ids_c.astype(np.int32)


def _leaf_ids(tree: Tree) -> np.ndarray:
    ids = tree.converged_leaf_ids()
    if ids.size == 0:
        raise ValueError("tree has no converged leaves")
    return ids


def _field_shapes(tree: Tree, L: int) -> dict[str, tuple]:
    m = tree.p + 1
    return {"bary_M": (L, m, m), "U": (L, m, tree.n_u), "V": (L, m),
            "delta": (L,), "node_id": (L,)}


def _field_dtype(name: str):
    return np.int32 if name in ("delta", "node_id") else np.float64


def _write_meta(dir_path: str, n_leaves: int, p: int, n_u: int,
                provenance: dict | None,
                checksums: dict | None = None) -> None:
    """The table's ``meta.json``, including the build-provenance stamp
    (partition/provenance.py) when one is known.  A stamp-less write is
    legal (synthetic trees, tests) -- loaders then treat the table as
    legacy/unstamped.

    Written ATOMICALLY and LAST (utils/atomic.py): meta.json is the
    artifact directory's commit marker -- the field ``.npy`` files
    stream in place (a memmap cannot), so a crash mid-export leaves
    either the previous complete meta (describing the previous arrays'
    shapes, which the loader's structural check then flags) or no new
    meta at all, never a torn one.  ``checksums`` (field -> sha256
    hex) rides along so load_leaf_table(verify_checksum=True) can
    detect at-rest corruption of the arrays themselves."""
    meta = {"n_leaves": int(n_leaves), "p": int(p), "n_u": int(n_u)}
    if provenance is not None:
        meta["provenance"] = provenance
    if checksums:
        meta["checksums"] = checksums
    from explicit_hybrid_mpc_tpu_torch.utils import atomic

    atomic.atomic_write_json(os.path.join(dir_path, "meta.json"), meta)


def _read_meta(dir_path: str) -> dict | None:
    try:
        with open(os.path.join(dir_path, "meta.json")) as f:
            return json.load(f)
    except OSError:
        return None  # legacy layout without meta.json
    except json.JSONDecodeError as e:
        from explicit_hybrid_mpc_tpu_torch.utils import atomic

        raise atomic.CorruptArtifact(
            f"{dir_path}/meta.json: unreadable ({e}) -- the artifact "
            "commit marker is torn; re-export the table or restore a "
            "previous generation") from e


def _field_checksums(dir_path: str) -> dict:
    """sha256 per field file, read back post-flush (sequential, page
    cache warm from the write; O(chunk) memory)."""
    from explicit_hybrid_mpc_tpu_torch.utils import atomic

    return {k: atomic.file_sha256(os.path.join(dir_path, f"{k}.npy"))
            for k in _LEAF_FIELDS}


def load_table_provenance(dir_path: str) -> dict | None:
    """The provenance stamp of an exported table directory, or None for
    legacy/stamp-less tables (missing meta.json included -- the arrays
    alone are still a loadable table).  A PRESENT-but-torn meta.json
    raises CorruptArtifact (_read_meta): treating a corrupt commit
    marker as merely 'legacy' would wave a damaged artifact through
    the provenance guard."""
    meta = _read_meta(dir_path)
    return None if meta is None else meta.get("provenance")


def export_leaves(tree: Tree, chunk: int = DEFAULT_CHUNK) -> LeafTable:
    """In-RAM export, chunk-streamed into one preallocated table.  (The
    per-leaf python loop this replaced built 3L small arrays in lists
    and OOM'd the 9.8M-leaf satellite full-box export next to the live
    tree; the later one-shot vectorized form still materialized the
    full [V^T; 1] stack -- the chunked core bounds every transient.)"""
    ids = _leaf_ids(tree)
    shapes = _field_shapes(tree, ids.size)
    out = LeafTable(**{k: np.empty(shapes[k], dtype=_field_dtype(k))
                       for k in _LEAF_FIELDS})
    _fill_chunks(tree, ids, out, chunk)
    return out


def commit_leaf_table(dir_path: str, n_leaves: int, p: int, n_u: int,
                      provenance: dict | None = None,
                      checksum: bool = True) -> None:
    """Write the artifact directory's COMMIT MARKER (meta.json,
    atomic, with optional per-field sha256s) and fire the
    artifact.written injection site.  Split out of write_leaf_table so
    a multi-file artifact (save_artifacts: leaf table + descent.npz)
    can land EVERY file before the marker commits -- a crash between
    the table and the descent write must leave a directory the loader
    rejects as uncommitted, never a 'valid' table pointing at a
    missing or stale descent."""
    _write_meta(dir_path, n_leaves, p, n_u, provenance,
                checksums=_field_checksums(dir_path) if checksum
                else None)
    # At-rest-corruption injection site (faults/plan.py): `corrupt`
    # kinds mangle the largest field so the loader's rejection path is
    # exercised end to end.
    from explicit_hybrid_mpc_tpu_torch.faults import injector as faults_inj

    faults_inj.fire("artifact.written", label=dir_path,
                    path=os.path.join(dir_path, "bary_M.npy"))


def invalidate_meta(dir_path: str) -> None:
    """Remove the commit marker before re-exporting INTO an existing
    artifact directory: the field files are rewritten in place (a
    memmap cannot write elsewhere), and a crash mid-rewrite must not
    leave the OLD meta.json 'committing' a half-new table.  (The
    resulting marker-less directory loads as legacy -- the documented
    weak spot for pre-meta layouts -- but never as a falsely-committed
    one.)"""
    try:
        os.unlink(os.path.join(dir_path, "meta.json"))
    except FileNotFoundError:
        pass


def write_leaf_table(tree: Tree, dir_path: str,
                     chunk: int = DEFAULT_CHUNK,
                     provenance: dict | None = None,
                     checksum: bool = True,
                     commit: bool = True) -> LeafTable:
    """Stream the leaf table into memory-mapped ``<dir>/<field>.npy``
    files; peak additional RSS is O(chunk), so a built tree can be
    exported next to itself without doubling host memory.  Returns the
    memmap-backed table (flushed; reopen with load_leaf_table for a
    clean read-only mapping).  ``provenance`` defaults to the tree's
    own build stamp and lands in ``meta.json``.  ``checksum=False``
    skips the per-field sha256 pass (a full re-read; turn it off for
    cluster-scale exports where the structural check suffices).
    ``commit=False`` defers the meta.json commit marker -- callers
    adding MORE files to the artifact (registry.save_artifacts)
    commit once everything is on disk (commit_leaf_table)."""
    ids = _leaf_ids(tree)
    os.makedirs(dir_path, exist_ok=True)
    invalidate_meta(dir_path)
    shapes = _field_shapes(tree, ids.size)
    out = LeafTable(**{
        k: np.lib.format.open_memmap(
            os.path.join(dir_path, f"{k}.npy"), mode="w+",
            dtype=_field_dtype(k), shape=shapes[k])
        for k in _LEAF_FIELDS})
    _fill_chunks(tree, ids, out, chunk)
    for a in out:
        a.flush()
    if provenance is None:
        provenance = getattr(tree, "provenance", None)
    if commit:
        commit_leaf_table(dir_path, ids.size, tree.p, tree.n_u,
                          provenance, checksum=checksum)
    return out


def save_leaf_table(table: LeafTable, dir_path: str,
                    provenance: dict | None = None,
                    checksum: bool = True) -> None:
    """Persist an already-materialized table (same layout as
    write_leaf_table; prefer that for large trees -- it never holds the
    full table in RAM)."""
    os.makedirs(dir_path, exist_ok=True)
    for k in _LEAF_FIELDS:
        np.save(os.path.join(dir_path, f"{k}.npy"), getattr(table, k))
    _write_meta(dir_path, table.n_leaves, table.bary_M.shape[1] - 1,
                table.U.shape[2], provenance,
                checksums=_field_checksums(dir_path) if checksum
                else None)


def load_leaf_table(dir_path: str, mmap: bool = True,
                    expect_provenance: dict | None = None,
                    strict: bool = False,
                    verify_checksum: bool = False) -> LeafTable:
    """Load an exported table; ``mmap=True`` maps the files read-only
    (pages fault in on demand -- the online stage working set, not L,
    bounds RSS), ``mmap=False`` reads full copies.

    Integrity (docs/robustness.md): an unreadable field file or a
    row-count mismatch against ``meta.json`` (the commit marker a torn
    export leaves stale or absent) raises ``CorruptArtifact`` with a
    clear message instead of shipping truncated tables into serving;
    ``verify_checksum=True`` additionally re-hashes every field
    against the recorded sha256s (a full read -- deploy-time
    paranoia, not the request path).  Legacy meta-less layouts load
    as before.

    ``expect_provenance``: the build stamp the caller believes this
    table carries (partition/provenance.build_stamp).  A mismatch warns
    by default and raises ``ProvenanceMismatch`` under ``strict`` --
    the guard against deploying/reusing a table against a revised
    problem.  Legacy stamp-less tables warn and load."""
    from explicit_hybrid_mpc_tpu_torch.utils import atomic

    meta = _read_meta(dir_path)
    if expect_provenance is not None:
        from explicit_hybrid_mpc_tpu_torch.partition import provenance as prov

        prov.check_stamp((meta or {}).get("provenance"),
                         expect_provenance, where=dir_path,
                         strict=strict)
    if verify_checksum:
        sums = (meta or {}).get("checksums")
        if not sums:
            raise atomic.CorruptArtifact(
                f"{dir_path}: verify_checksum requested but meta.json "
                "records no checksums (legacy export or "
                "checksum=False write)")
        for k, want in sums.items():
            got = atomic.file_sha256(os.path.join(dir_path, f"{k}.npy"))
            if got != want:
                raise atomic.CorruptArtifact(
                    f"{dir_path}/{k}.npy: sha256 mismatch (recorded "
                    f"{want[:12]}.., found {got[:12]}..) -- the field "
                    "file was corrupted after export; re-export or "
                    "restore")
    mode = "r" if mmap else None
    arrs = []
    for k in _LEAF_FIELDS:
        p = os.path.join(dir_path, f"{k}.npy")
        try:
            arrs.append(np.load(p, mmap_mode=mode))
        except (OSError, ValueError, EOFError) as e:
            raise atomic.CorruptArtifact(
                f"{p}: unreadable leaf-table field ({e}) -- the "
                "artifact is truncated or torn; re-export the table "
                "or restore a previous generation") from e
    table = LeafTable(*arrs)
    if meta is not None and "n_leaves" in meta:
        for k, a in zip(_LEAF_FIELDS, table):
            if a.shape[0] != meta["n_leaves"]:
                raise atomic.CorruptArtifact(
                    f"{dir_path}/{k}.npy holds {a.shape[0]} rows but "
                    f"meta.json committed {meta['n_leaves']}: the "
                    "export was torn mid-write; re-export or restore")
    return table


def semi_explicit_mask(tree: Tree, table: LeafTable) -> np.ndarray:
    """(L,) bool: which table rows are semi-explicit boundary leaves.

    Those rows' interpolated laws are fallbacks only; the deployed
    controller must route them through the online fixed-delta QP
    (sim.SemiExplicitController(semi_mask=...)).  Kept out of LeafTable
    itself so pure eps-certified partitions pay nothing.  Reads the
    flags column directly (a per-leaf python loop here would undo the
    vectorized export at cluster scale -- main.py calls this right
    after export_leaves)."""
    return tree.semi_explicit_flags(table.node_id)
