"""S3-shaped object bucket: the cold tier's storage primitive.

Four verbs — ``put_object`` / ``get_object`` / ``list_objects`` /
``delete_object`` — shaped like an S3 client so a real object-store
backend slots in without touching ``ColdChunkStore``.  Objects are
immutable blobs under flat string keys; there is no rename, no append,
no partial read.

``get_object`` takes a REQUIRED keyword-only ``timeout_s``: every fetch
is a network hop in a real deployment, and each call-site derives that
timeout from the query's remaining budget (never a bare constant, and
never ``None``).  A fetch that cannot finish inside the budget raises
:class:`BucketTimeout` — the loud refusal path, never a wedge.

``LocalFSBucket`` is the bundled implementation: one file per object
under a root directory, atomic puts via tmp + rename.  It also hosts the
fault hooks the cold-path tests drive:

* ``stall_s`` — every get sleeps ``min(stall_s, timeout_s)`` and then
  raises :class:`BucketTimeout` if the stall reaches the budget,
  emulating a hung object store that honors client-side timeouts.
* ``corrupt_object`` — flips or truncates the backing file's bytes; the
  bucket serves whatever bytes are on disk, and the CRC-on-fetch layer
  above must catch it.

Host code only: nothing here touches the device.
"""

from __future__ import annotations

import os
import threading
import time
import uuid


class BucketTimeout(OSError):
    """An object fetch could not finish inside its deadline-derived
    timeout (stalled backend, exhausted query budget).  Callers treat
    this as a refusal — fail the query loudly — never as data."""


class ObjectMissing(KeyError):
    """The requested key does not exist in the bucket."""


class ObjectBucket:
    """The S3-shaped interface.  All keys are ``/``-separated ASCII
    strings; all values are immutable byte blobs."""

    def put_object(self, key: str, data: bytes) -> None:
        """Store ``data`` under ``key`` (overwrite allowed; must be
        atomic — a reader never observes a torn write)."""
        raise NotImplementedError

    def get_object(self, key: str, *, timeout_s: float) -> bytes:
        """Fetch the full object.  ``timeout_s`` is mandatory and must
        come from the caller's remaining budget; raises
        :class:`BucketTimeout` when the fetch cannot finish in time and
        :class:`ObjectMissing` when the key does not exist."""
        raise NotImplementedError

    def list_objects(self, prefix: str) -> list:
        """All ``(key, size_bytes)`` pairs whose key starts with
        ``prefix``, sorted by key.  Metadata-only — no object bodies are
        read."""
        raise NotImplementedError

    def delete_object(self, key: str) -> bool:
        """Delete ``key``; True when it existed."""
        raise NotImplementedError


def _check_key(key: str) -> str:
    if not key or key.startswith("/") or ".." in key.split("/"):
        raise ValueError(f"invalid object key: {key!r}")
    return key


class LocalFSBucket(ObjectBucket):
    """One file per object under ``root``; the bundled cold backend and
    the fault-test double (a real S3 client implements the same four
    verbs against a remote endpoint)."""

    def __init__(self, root: str) -> None:
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        # fault hook: every get stalls this long (bounded by the caller's
        # timeout) before serving — emulates a hung backend
        self.stall_s = 0.0
        self._write_lock = threading.Lock()

    def _path(self, key: str) -> str:
        return os.path.join(self.root, *(_check_key(key).split("/")))

    def put_object(self, key: str, data: bytes) -> None:
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp-{uuid.uuid4().hex[:8]}"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)  # atomic: readers see old bytes or new

    def get_object(self, key: str, *, timeout_s: float) -> bytes:
        if timeout_s is None or timeout_s <= 0:
            raise BucketTimeout(
                f"no budget left to fetch {key} (timeout_s={timeout_s})")
        if self.stall_s > 0:
            # honor the client timeout the way a real SDK does: wait at
            # most timeout_s, then give up — the caller's thread is
            # delayed but never wedged past its budget
            time.sleep(min(self.stall_s, timeout_s))
            if self.stall_s >= timeout_s:
                raise BucketTimeout(
                    f"fetch of {key} exceeded its {timeout_s:.3f}s budget "
                    f"(backend stalled)")
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            raise ObjectMissing(key) from None

    def list_objects(self, prefix: str) -> list:
        _check_key(prefix)
        # walk only the deepest directory the prefix pins down
        parts = prefix.split("/")
        base = os.path.join(self.root, *parts[:-1]) if len(parts) > 1 \
            else self.root
        out = []
        if not os.path.isdir(base):
            return out
        for dirpath, _dirs, files in os.walk(base):
            for name in files:
                if name.startswith(".") or ".tmp-" in name:
                    continue
                path = os.path.join(dirpath, name)
                key = os.path.relpath(path, self.root).replace(os.sep, "/")
                if key.startswith(prefix):
                    try:
                        out.append((key, os.path.getsize(path)))
                    except OSError:
                        continue  # deleted mid-walk
        out.sort()
        return out

    def delete_object(self, key: str) -> bool:
        try:
            os.remove(self._path(key))
            return True
        except FileNotFoundError:
            return False

    # -- fault hooks (tests) ------------------------------------------------

    def corrupt_object(self, key: str, mode: str = "flip") -> None:
        """Damage the stored bytes in place: ``flip`` xors one payload
        byte, ``truncate`` drops the tail half.  The bucket itself stays
        oblivious — detection belongs to CRC-on-fetch above."""
        path = self._path(key)
        with self._write_lock:
            with open(path, "rb") as f:
                data = bytearray(f.read())
            if mode == "truncate":
                data = data[:max(1, len(data) // 2)]
            else:
                data[len(data) // 2] ^= 0xFF
            with open(path, "wb") as f:
                f.write(bytes(data))

    def object_keys(self, prefix: str = "") -> list:
        """Keys under ``prefix`` (every chunk object when empty)."""
        return [k for k, _sz in self.list_objects(prefix or "chunks/")]
