"""Crash-safe file writes: tmp + fsync + rename, checksummed pickles,
durable appends.

Before this module, every writer in the repo wrote its artifact in
place: ``save_checkpoint`` pickled straight into the live checkpoint
path, ``meta.json`` was a bare ``json.dump``, and the bench history
appended without fsync.  A crash (OOM kill, SIGKILL, power loss) at the
wrong instant left a TORN file at the path every loader trusts -- the
exact failure the fault-injection framework (explicit_hybrid_mpc_tpu_torch/
faults/) scripts, and the one a multi-hour checkpointed campaign can
least afford.  All durable writes now go through the three primitives
here (docs/robustness.md "Crash-safe writes"):

- ``atomic_write_bytes`` / ``atomic_write_json``: write to a tmp file
  in the SAME directory, flush + fsync, then ``os.replace`` onto the
  final path (atomic on POSIX) and fsync the directory.  Readers see
  either the complete old file or the complete new one, never a torn
  mix.
- ``atomic_pickle`` / ``read_checked_pickle``: pickles additionally
  carry a HEAD-ANCHORED content checksum -- ``MAGIC ||
  sha256(payload) || payload`` -- so at-rest corruption (truncation
  by a failing disk, a torn legacy write, an injected fault) is
  DETECTED at load instead of surfacing as an unpickling crash or,
  worse, silently wrong arrays.  The digest leads the payload on
  purpose: a TRAILING checksum cannot catch truncation that lands
  inside the trailer itself (the intact pickle payload would load as
  "legacy"), and truncation only ever removes the tail.  Files
  without the header (artifacts older than the format) load with
  ``checked=False``; every loader in the repo reads through
  ``read_checked_pickle``, so nothing depends on bare ``pickle.load``
  compatibility with the NEW format.
- ``append_line_fsync``: line append + flush + fsync, the durable form
  of the JSONL append (BENCH_HISTORY.jsonl rows survive the process
  dying on the next line).

``CorruptArtifact`` is the ONE error loaders raise for a rejected
file; callers that keep generations (checkpoint ``.prev`` rotation,
the serve registry's retiring versions) catch it and fall back.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import pickle
import tempfile
from typing import Any, Optional

#: Header layout: MAGIC (9 bytes) + sha256 digest (32 bytes) +
#: payload.  Bump the trailing digit on incompatible change.
CHECKSUM_MAGIC = b"EHMCKSUM1"
_HEADER_LEN = len(CHECKSUM_MAGIC) + 32


class CorruptArtifact(RuntimeError):
    """A persisted file failed its integrity check (truncated, torn,
    or bit-flipped).  The message names the file and the failed check;
    callers with a previous generation fall back to it."""


def fsync_fileobj(fh) -> None:
    """flush + fsync an open file object (shared by the atomic writers
    and JsonlSink's durable mode)."""
    fh.flush()
    os.fsync(fh.fileno())


def _fsync_dir(dir_path: str) -> None:
    """fsync the directory so the rename itself is durable.  Best
    effort: some filesystems (and all of Windows) refuse O_RDONLY
    directory fds -- the data fsync already happened, so degrading to
    a plain rename loses only the metadata flush."""
    try:
        fd = os.open(dir_path or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


@contextlib.contextmanager
def atomic_file(path: str):
    """Context manager yielding a binary file handle whose contents
    REPLACE `path` atomically on clean exit (same-directory tmp,
    fsync, ``os.replace``, directory fsync).  On any failure the tmp
    file is removed and `path` is untouched -- a crash at ANY point
    leaves either the previous complete file or the new complete one,
    never a prefix.  Streaming writers (np.savez, pickle.dump) write
    straight into the handle, so atomicity costs no extra RAM."""
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + ".tmp.")
    try:
        with os.fdopen(fd, "wb") as f:
            yield f
            fsync_fileobj(f)
        os.replace(tmp, path)
    except BaseException:
        # The tmp file is garbage on any failure (including an injected
        # crash that unwinds as an exception) -- never leave it to be
        # mistaken for an artifact.
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    _fsync_dir(d)


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Write `data` to `path` atomically (see atomic_file)."""
    with atomic_file(path) as f:
        f.write(data)


def atomic_write_text(path: str, text: str) -> None:
    atomic_write_bytes(path, text.encode("utf-8"))


def atomic_write_json(path: str, obj: Any, **dump_kw) -> None:
    atomic_write_bytes(path, json.dumps(obj, **dump_kw).encode("utf-8"))


def checksummed(payload: bytes) -> bytes:
    """`payload` behind the content-checksum header."""
    return CHECKSUM_MAGIC + hashlib.sha256(payload).digest() + payload


class _HashingWriter:
    """File-object proxy feeding every written byte to sha256 -- lets
    pickle.dump STREAM into the checksummed file instead of
    materializing the full payload bytes first (a multi-hundred-MB
    checkpoint must not cost 2x its size in transient RAM)."""

    __slots__ = ("_fh", "h")

    def __init__(self, fh):
        self._fh = fh
        self.h = hashlib.sha256()

    def write(self, b) -> int:
        self.h.update(b)
        return self._fh.write(b)


class _HashingReader:
    """File-object proxy hashing every byte handed to pickle.load, so
    verification streams too (read + readline are all the unpickler
    needs).  drain() hashes whatever pickle left unconsumed, making
    the digest cover the whole payload regardless of buffering."""

    __slots__ = ("_fh", "h")

    def __init__(self, fh):
        self._fh = fh
        self.h = hashlib.sha256()

    def read(self, n: int = -1) -> bytes:
        b = self._fh.read(n)
        self.h.update(b)
        return b

    def readline(self) -> bytes:
        b = self._fh.readline()
        self.h.update(b)
        return b

    def drain(self, chunk: int = 1 << 20) -> None:
        while True:
            b = self._fh.read(chunk)
            if not b:
                return
            self.h.update(b)


def atomic_pickle(path: str, obj: Any,
                  payload: Optional[bytes] = None) -> None:
    """Atomically write ``pickle(obj)`` behind the checksum header,
    STREAMING: the header is written with a placeholder digest,
    pickle.dump streams through a hashing proxy, and the real digest
    is seeked back in before the fsync+rename -- no full-payload byte
    string ever exists in RAM.  `payload` short-circuits the dump for
    callers that already hold pickled bytes."""
    with atomic_file(path) as f:
        f.write(CHECKSUM_MAGIC)
        f.write(b"\0" * 32)
        hw = _HashingWriter(f)
        if payload is not None:
            hw.write(payload)
        else:
            pickle.dump(obj, hw, protocol=pickle.HIGHEST_PROTOCOL)
        f.flush()
        f.seek(len(CHECKSUM_MAGIC))
        f.write(hw.h.digest())


def verify_checksum(data: bytes, where: str = "<bytes>") -> tuple[bytes, bool]:
    """(payload, checked) for a possibly-checksummed byte string.

    checked=True: the header was present and its sha256 matched the
    payload (mismatch -- including ANY truncation, since the digest
    precedes the payload -- raises CorruptArtifact).  checked=False:
    no header -- a legacy file from before the checksum format; the
    caller decides whether that is acceptable (loaders warn-and-load,
    mirroring the provenance-stamp policy)."""
    if data[:len(CHECKSUM_MAGIC)] == CHECKSUM_MAGIC:
        digest = data[len(CHECKSUM_MAGIC):_HEADER_LEN]
        payload = data[_HEADER_LEN:]
        if hashlib.sha256(payload).digest() != digest:
            raise CorruptArtifact(
                f"{where}: content checksum mismatch -- the file is "
                "corrupt (truncated or bit-flipped after write)")
        return payload, True
    return data, False


def read_checked_pickle(path: str) -> tuple[Any, bool]:
    """(object, checked) from a checksummed (or legacy) pickle file,
    STREAMING (the raw bytes are never materialized next to the
    unpickled object).

    Raises CorruptArtifact with a clear message on a checksum mismatch
    OR an unpicklable payload (a truncated legacy file); raises
    FileNotFoundError when the path does not exist (callers with
    generation fallback distinguish the two)."""
    with open(path, "rb") as f:
        head = f.read(len(CHECKSUM_MAGIC))
        if head == CHECKSUM_MAGIC:
            digest = f.read(32)
            hr = _HashingReader(f)
            err: Optional[Exception] = None
            obj = None
            try:
                obj = pickle.load(hr)
            except Exception as e:  # verified below: a corrupt payload
                err = e             # usually fails the digest too
            hr.drain()
            if hr.h.digest() != digest:
                raise CorruptArtifact(
                    f"{path}: content checksum mismatch -- the file "
                    "is corrupt (truncated or bit-flipped after "
                    "write)")
            if err is not None:
                raise CorruptArtifact(
                    f"{path}: checksum passes but the pickle payload "
                    f"is unreadable ({err!r}) -- written by an "
                    "incompatible version?") from err
            return obj, True
        f.seek(0)
        try:
            return pickle.load(f), False
        except Exception as e:
            raise CorruptArtifact(
                f"{path}: unreadable pickle payload ({e!r}) -- the "
                "file is truncated or corrupt; restore a previous "
                "generation or rebuild") from e


def file_sha256(path: str, chunk: int = 1 << 20) -> str:
    """Streaming sha256 hex digest of a file (artifact-table field
    checksums in meta.json; O(chunk) memory)."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                return h.hexdigest()
            h.update(b)


def append_line_fsync(path: str, line: str) -> None:
    """Append one line durably (open 'a', write, flush, fsync).  The
    JSONL-append counterpart of atomic_write_bytes: a crash after
    return can no longer lose the row, and a crash MID-write tears at
    most the final line, which every JSONL reader here already
    tolerates (sink.load_jsonl / bench_gate.load_history)."""
    with open(path, "a") as f:
        f.write(line if line.endswith("\n") else line + "\n")
        fsync_fileobj(f)
